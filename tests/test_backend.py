"""The one backend decision, the compile-cache placement, and chip_smoke.py
refusing to run without a GPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

from csgrenderer.backend import choose_backend
from csgrenderer.models import config3_csg_scene, two_spheres_scene
from csgrenderer.render import icosphere
from csgrenderer.scene import Material
from csgrenderer.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _scene(kind):
    if kind == "sphere":
        return two_spheres_scene()
    if kind == "tape":
        return config3_csg_scene().compile(k=2)
    return icosphere((0, 0, -3), 1.0, Material.lambertian((0.5, 0.5, 0.5)), 0)


@pytest.mark.parametrize(
    "platform,kind,requested,interpret,expected",
    [
        ("cpu", "sphere", "auto", False, "jnp"),
        ("cpu", "sphere", "auto", True, "triton"),
        ("cpu", "tape", "triton", True, "triton"),
        ("cpu", "mesh", "auto", True, "jnp"),
        ("gpu", "sphere", "auto", False, "triton"),
        ("gpu", "tape", "auto", False, "triton"),
        ("gpu", "mesh", "auto", False, "jnp"),
        ("gpu", "sphere", "jnp", False, "jnp"),
    ],
)
def test_choose_backend(platform, kind, requested, interpret, expected):
    got = choose_backend(
        _scene(kind), requested, interpret=interpret, platform=platform
    )
    assert got == expected


@pytest.mark.parametrize(
    "platform,kind,requested,interpret,error,match",
    [
        ("metal", "sphere", "auto", False, RuntimeError, "platform 'metal'"),
        ("cpu", "sphere", "pallas", True, ValueError, "route was removed"),
        ("gpu", "mesh", "triton", False, ValueError, "no Triton kernel"),
        ("cpu", "tape", "triton", False, ValueError, "interpret=True"),
    ],
)
def test_choose_backend_rejects(platform, kind, requested, interpret, error,
                                match):
    with pytest.raises(error, match=match):
        choose_backend(
            _scene(kind), requested, interpret=interpret, platform=platform
        )


def test_choose_backend_reads_the_device_platform():
    # the test process runs on the CPU backend
    assert choose_backend(two_spheres_scene()) == "jnp"


def test_compile_cache_dir_from_environment(monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_VAR, "/somewhere/cache")
    assert compile_cache.compile_cache_dir() == "/somewhere/cache"
    before = jax.config.jax_compilation_cache_dir
    # JAX reads the variable itself: the helper configures nothing else
    assert compile_cache.enable_compile_cache() == "/somewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_dir_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    expected = str(ROOT / ".jax_cache")
    assert compile_cache.compile_cache_dir() == expected
    assert compile_cache.compile_cache_dir({}) == expected
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == expected
        assert jax.config.jax_compilation_cache_dir == expected
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_without_gpu():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_needs_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
