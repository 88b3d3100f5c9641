"""Driver-entry-point regression tests.

``dryrun_multichip`` must never initialize the default backend (a machine
may have an accelerator plugin the dry run must not touch): it
self-provisions a virtual CPU mesh. These tests run it exactly as a
driver does, in a FRESH subprocess with the
ambient environment (JAX_PLATFORMS etc. untouched), so a regression cannot
hide behind conftest's in-process CPU forcing.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_in_subprocess(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    # strip conftest's own virtual-device flag: the entry point must set it
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=560,
    )


def test_dryrun_multichip_driver_conditions():
    proc = _run_in_subprocess(
        "import __graft_entry__; __graft_entry__.dryrun_multichip(8)"
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip ok" in proc.stdout


def test_package_import_initializes_no_backend():
    """Importing the package must not create any jax backend client —
    otherwise the CPU client gets pinned to 1 device before the dryrun can
    configure the virtual mesh (the round-1 failure mode)."""
    proc = _run_in_subprocess(
        "import csgrenderer.parallel, csgrenderer.models,"
        " csgrenderer.kernels, csgrenderer.io, csgrenderer.app;"
        " import jax._src.xla_bridge as xb;"
        " ks = list(xb._backends.keys()); assert not ks, ks; print('clean')"
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "clean" in proc.stdout
