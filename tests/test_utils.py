"""Tests for utils (config/profiling/logging) and the GIF writer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csgrenderer.io import video
from csgrenderer.utils import (
    MeshConfig,
    RenderConfig,
    disable_debug_mode,
    enable_debug_mode,
    get_logger,
)
from csgrenderer.utils.profiling import Timing, time_fn


def test_render_config_validation():
    cfg = RenderConfig(width=640, height=480, spp=4)
    assert cfg.aspect_ratio == 640 / 480
    assert cfg.rays_per_frame == 640 * 480 * 4 * 8
    with pytest.raises(ValueError):
        RenderConfig(width=0)
    with pytest.raises(ValueError):
        RenderConfig(spp=0)
    with pytest.raises(ValueError):
        RenderConfig(sky="nope")


def test_mesh_config():
    assert MeshConfig(tile_axis=4, sample_axis=2).num_devices == 8


def test_debug_mode_toggles_nan_check():
    enable_debug_mode()
    try:
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: x / 0.0)(jnp.float32(0.0)).block_until_ready()
    finally:
        disable_debug_mode()
    # and off again: no raise
    jax.jit(lambda x: x / 0.0)(jnp.float32(0.0)).block_until_ready()


def test_time_fn_reports_compile_and_run():
    f = jax.jit(lambda x: (x * 2.0).sum())
    t = time_fn(f, jnp.ones((128, 128)), calls=2)
    assert isinstance(t, Timing)
    assert t.compile_sec > 0 and t.run_sec >= 0 and t.calls == 2


def test_logger_prefix(capsys):
    log = get_logger("stats")
    log.warning("hello %d", 7)
    err = capsys.readouterr().err
    assert "[csgr]" in err and "hello 7" in err


def test_gif_roundtrip_header(tmp_path):
    frames = [
        np.full((8, 16, 3), 30 * i, np.uint8) for i in range(3)
    ]
    p = tmp_path / "anim.gif"
    video.write_gif(p, frames, fps=10)
    data = p.read_bytes()
    assert data.startswith(b"GIF89a")
    assert data.endswith(b"\x3b")
    # dimensions in the logical screen descriptor
    import struct

    w, h = struct.unpack("<HH", data[6:10])
    assert (w, h) == (16, 8)
    assert data.count(b"\x21\xf9") == 3  # one graphic-control per frame


def test_gif_decodes_with_pillow(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    frames = [(rng.random((24, 40, 3)) * 255).astype(np.uint8) for _ in range(4)]
    p = tmp_path / "noise.gif"
    video.write_gif(p, frames, fps=10)
    im = PIL.open(p)
    n = 0
    try:
        while True:
            im.seek(n)
            decoded = np.asarray(im.convert("RGB"))
            assert decoded.shape == (24, 40, 3)
            # palette quantization error bounded by the web-safe step
            assert np.abs(decoded.astype(int) - frames[n].astype(int)).max() <= 26
            n += 1
    except EOFError:
        pass
    assert n == 4


def test_gif_rejects_empty_and_mismatched(tmp_path):
    with pytest.raises(ValueError):
        video.write_gif(tmp_path / "x.gif", [])
    with pytest.raises(ValueError):
        video.write_gif(
            tmp_path / "y.gif",
            [np.zeros((4, 4, 3), np.uint8), np.zeros((5, 4, 3), np.uint8)],
        )


def test_checked_wrapper_passes_clean_fn():
    from csgrenderer.utils.config import checked

    f = checked(lambda x: jnp.sqrt(x) + 1.0)
    np.testing.assert_allclose(np.asarray(f(jnp.float32(4.0))), 3.0)


def test_checked_wrapper_catches_nan():
    from jax.experimental import checkify

    from csgrenderer.utils.config import checked

    f = checked(lambda x: jnp.sqrt(x))  # sqrt(-1) -> NaN
    with pytest.raises((checkify.JaxRuntimeError, ValueError)):
        f(jnp.float32(-1.0))


def test_checked_render_step_is_clean():
    # the reference-implementation render path must be NaN/div-free under
    # full float checks (the 'validation layer' smoke test)
    from csgrenderer.camera import Camera
    from csgrenderer.models import two_spheres_scene
    from csgrenderer.render import render_image
    from csgrenderer.utils.config import checked

    scene = two_spheres_scene()
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90,
                         aspect_ratio=2.0)
    f = checked(
        lambda s: render_image(s.nearest_hit, cam, 32, 16, spp=1,
                               max_bounces=3, seed=0)[0]
    )
    img = f(scene)
    assert not np.isnan(np.asarray(img)).any()
