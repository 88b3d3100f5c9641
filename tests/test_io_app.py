"""IO (png/ppm/rmse/checkpoint) and app-loop tests."""

import numpy as np
import jax.numpy as jnp

from csgrenderer.app import App, FrameStats, StatsClock
from csgrenderer.io import Accumulator, checkpoint, image


def test_png_roundtrip(tmp_path):
    img = (np.random.default_rng(0).random((20, 31, 3)) * 255).astype(np.uint8)
    p = tmp_path / "x.png"
    image.write_png(p, img)
    back = image.read_png(p)
    np.testing.assert_array_equal(img, back)


def test_ppm_write(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    p = tmp_path / "x.ppm"
    image.write_ppm(p, img)
    data = p.read_bytes()
    assert data.startswith(b"P6\n5 4\n255\n")
    assert len(data) == len(b"P6\n5 4\n255\n") + 4 * 5 * 3


def test_rmse():
    a = np.zeros((4, 4, 3), np.float32)
    b = np.full((4, 4, 3), 0.1, np.float32)
    np.testing.assert_allclose(image.rmse(a, b), 0.1, atol=1e-7)
    assert image.rmse(a, a) == 0.0
    u8 = np.full((4, 4, 3), 255, np.uint8)
    ones = np.ones((4, 4, 3), np.float32)
    assert image.rmse(u8, ones) == 0.0


def test_accumulator_checkpoint_roundtrip(tmp_path):
    acc = Accumulator.zeros(8, 8)
    acc = acc.add(jnp.ones((8, 8, 3)), samples=4, rays=jnp.int32(1000))
    p = tmp_path / "ckpt.npz"
    checkpoint.save(p, acc, frame=jnp.int32(17))
    acc2, meta = checkpoint.load(p)
    np.testing.assert_allclose(np.asarray(acc2.image()), 0.25, atol=1e-7)
    assert int(acc2.sample_count) == 4
    assert int(meta["frame"]) == 17


def test_frame_stats_math_is_fixed():
    # the reference prints mean truncated to 0 and variance-as-stddev
    # (app.c:171-181); ours must be correct float math.
    s = FrameStats()
    for dt in (0.010, 0.012, 0.014):
        s.push(dt, rays=1_000_000)
    np.testing.assert_allclose(s.mean, 0.012, atol=1e-9)
    np.testing.assert_allclose(s.stddev, np.std([0.010, 0.012, 0.014]), atol=1e-9)
    assert s.fps > 0
    np.testing.assert_allclose(s.mrays_per_sec, 3.0 / 0.036, atol=1e-6)
    line = s.report_line(1.0)
    assert "[csgr][Stats]" in line and "fps" in line and "Mrays/s" in line


def test_stats_clock_reports_once_per_window():
    lines = []
    clock = StatsClock(report_every_sec=1.0, emit=lines.append)
    t = [0.0]
    for i in range(25):
        t[0] += 0.1
        clock.frame(0.1, rays=10, now=t[0])
    assert len(lines) == 2  # ~2.5s -> 2 reports


class _FakeRenderer:
    def __init__(self):
        self.times = []
        self.last_frame_rays = 42

    def draw_frame(self, t_sim):
        self.times.append(t_sim)
        return np.zeros((2, 2, 3), np.uint8)


def test_app_fixed_timestep_updates():
    updates = []
    frames = []
    r = _FakeRenderer()

    def init_cb(app, w, h, caption, target_dt):
        assert (w, h, caption) == (64, 32, "t")
        app.swap_scene(r)
        return True

    clock = {"t": 0.0}

    def fake_time():
        clock["t"] += 0.05  # 50ms per poll
        return clock["t"]

    app = App(
        target_updates_per_sec=10.0,  # 100ms updates
        width=64, height=32, caption="t",
        init_cb=init_cb,
        update_cb=lambda a, dt: updates.append(dt),
        frame_sink=lambda i, img: frames.append(i),
        stats=StatsClock(emit=None),
    )
    ok = app.run(max_frames=10, time_fn=fake_time)
    assert ok
    assert len(frames) == 10
    # every update tick is exactly the fixed timestep
    assert all(abs(dt - 0.1) < 1e-9 for dt in updates)
    assert len(updates) > 0
    assert len(r.times) == 10


def test_app_aborts_without_renderer():
    deinit = []
    app = App(init_cb=lambda *a: True, deinit_cb=lambda a: deinit.append(1),
              stats=StatsClock(emit=None))
    assert app.run(max_frames=1) is False
    assert deinit == [1]


def test_app_init_failure_aborts():
    app = App(init_cb=lambda *a: False, stats=StatsClock(emit=None))
    assert app.run(max_frames=1) is False


def test_accumulator_ray_counter_survives_int32_overflow(tmp_path):
    """rays_traced is a host-side Python int: per-call int32 kernel counters
    are fine, but the running total passes 2^31 within a minute of 4K
    progressive rendering (ADVICE r1)."""
    acc = Accumulator.zeros(2, 2)
    per_call = 2_000_000_000  # near int32 max, as an int32 device scalar
    acc = acc.add(jnp.zeros((2, 2, 3)), samples=1, rays=jnp.int32(per_call))
    acc = acc.add(jnp.zeros((2, 2, 3)), samples=1, rays=jnp.int32(per_call))
    assert acc.rays_traced == 2 * per_call  # would wrap negative in int32
    p = tmp_path / "acc.npz"
    checkpoint.save(p, acc, note=1)
    acc2, _ = checkpoint.load(p)
    assert acc2.rays_traced == 2 * per_call


def test_debug_view_1_entry_point():
    """ep_debug_view_1 parity (ubershader1.frag:132-137): color=(st.x,st.y,0),
    selectable as a constructor arg instead of a shader edit."""
    from csgrenderer.app.renderers import WololoRenderer
    from csgrenderer.utils.config import RenderConfig

    r = WololoRenderer(
        RenderConfig(width=64, height=32, spp=1, sky="wololo"),
        entry_point="debug_view_1",
    )
    img = np.asarray(r.draw_frame(0.0)).astype(np.float64) / 255
    # st.x grows left->right; st.y = 1 - y/H grows bottom->top; blue = 0
    assert img[:, :, 2].max() == 0
    assert img[16, 60, 0] > img[16, 3, 0]  # st.x gradient
    assert img[2, 32, 1] > img[30, 32, 1]  # y-flip: top row has st.y ~ 1
    center = img[16, 32]
    np.testing.assert_allclose(center[0], (32 + 0.5) / 64, atol=0.01)
    np.testing.assert_allclose(center[1], 1 - (16 + 0.5) / 32, atol=0.01)


def test_orbax_checkpoint_roundtrip(tmp_path):
    acc = Accumulator.zeros(4, 4)
    acc = acc.add(jnp.full((4, 4, 3), 2.5), samples=3, rays=jnp.int32(777))
    p = tmp_path / "orbax_ckpt"
    checkpoint.save_orbax(p, acc, frame=7)
    acc2, meta = checkpoint.load_orbax(p)
    np.testing.assert_allclose(
        np.asarray(acc2.radiance_sum), np.asarray(acc.radiance_sum)
    )
    assert int(acc2.sample_count) == 3
    assert acc2.rays_traced == 777
    assert int(meta["frame"]) == 7
