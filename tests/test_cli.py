"""CLI smoke tests (python -m csgrenderer)."""

import numpy as np
import pytest

from csgrenderer.__main__ import main
from csgrenderer.io import image


def test_render_milestone01(tmp_path, capsys):
    out = tmp_path / "m1.png"
    main([
        "render", "--scene", "milestone01", "--width", "64", "--height", "48",
        "--out", str(out),
    ])
    img = image.read_png(out)
    assert img.shape == (48, 64, 3)
    assert "wrote" in capsys.readouterr().out


def test_render_diffuse_jnp(tmp_path):
    out = tmp_path / "d.png"
    main([
        "render", "--scene", "diffuse", "--width", "48", "--height", "32",
        "--spp", "1", "--bounces", "2", "--backend", "jnp", "--out", str(out),
    ])
    img = image.read_png(out)
    assert img.shape == (32, 48, 3)
    assert img.mean() > 10  # not black


def test_gif_milestone01(tmp_path):
    out = tmp_path / "m1.gif"
    main([
        "gif", "--scene", "milestone01", "--width", "32", "--height", "24",
        "--frames", "3", "--out", str(out),
    ])
    assert out.read_bytes().startswith(b"GIF89a")


def test_render_denoise_flag(tmp_path):
    """--denoise produces a valid PNG that differs from the raw render
    (round 5: the denoiser is a CLI citizen, VERDICT item 2)."""
    raw, dn = tmp_path / "raw.png", tmp_path / "dn.png"
    common = [
        "render", "--scene", "diffuse", "--width", "48", "--height", "32",
        "--spp", "2", "--bounces", "3", "--backend", "jnp",
    ]
    main(common + ["--out", str(raw)])
    main(common + ["--denoise", "--out", str(dn)])
    a = image.read_png(raw).astype(np.float32)
    b = image.read_png(dn).astype(np.float32)
    assert b.shape == a.shape
    assert b.mean() > 10  # not black
    assert np.abs(a - b).mean() > 0.1  # the filter actually ran
    # denoising smooths: per-pixel variation around a local mean shrinks
    assert b.std() <= a.std() + 1.0


def test_unknown_scene_errors(tmp_path):
    with pytest.raises(SystemExit):
        main(["render", "--scene", "nope", "--out", str(tmp_path / "x.png")])
