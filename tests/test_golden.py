"""Golden-image tests: one per BASELINE.json config (scaled for CI).

Renders each config with the pure-jnp reference implementation and compares
against the committed goldens at the BASELINE tolerance (RMSE <= 1e-3 on
[0,1] scale). Regenerate with ``python tools/make_goldens.py`` after an
*intentional* image change.
"""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

from make_goldens import GOLDEN_DIR, golden_specs  # noqa: E402

from csgrenderer.io import image  # noqa: E402

SPECS = golden_specs()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_golden(name):
    golden_path = GOLDEN_DIR / f"{name}.png"
    assert golden_path.exists(), f"missing golden {golden_path}; run tools/make_goldens.py"
    golden = image.read_png(golden_path)
    fresh = SPECS[name]()
    err = image.rmse(fresh, golden)
    assert err <= 1e-3, f"{name}: RMSE {err:.6f} > 1e-3"
