"""End-to-end App-loop integration with real renderers (CPU backend)."""

import numpy as np

from csgrenderer.app import App, PathTraceRenderer, StatsClock, WololoRenderer
from csgrenderer.camera import Camera
from csgrenderer.models import two_spheres_scene
from csgrenderer.utils.config import RenderConfig


def run_app(renderer, frames=2, ups=30.0):
    captured = []
    app = App(
        target_updates_per_sec=ups,
        width=renderer.config.width,
        height=renderer.config.height,
        caption="it",
        init_cb=lambda app, w, h, cap, dt: (app.swap_scene(renderer), True)[1],
        frame_sink=lambda i, img: captured.append(np.asarray(img)),
        stats=StatsClock(emit=None),
    )
    assert app.run(max_frames=frames)
    return captured


def test_wololo_renderer_through_app_loop():
    r = WololoRenderer(RenderConfig(width=64, height=48, spp=1, sky="wololo"))
    frames = run_app(r, frames=3)
    assert len(frames) == 3
    for f in frames:
        assert f.shape == (48, 64, 3) and f.dtype == np.uint8
    # animation: the sphere moves between frames (wall-clock time advances)
    assert any(np.abs(frames[0].astype(int) - frames[-1].astype(int)).max() > 0
               for _ in [0])


def test_path_trace_renderer_through_app_loop():
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90,
                         aspect_ratio=2.0)
    r = PathTraceRenderer(
        two_spheres_scene(), cam,
        RenderConfig(width=64, height=32, spp=1, max_bounces=3, seed=1),
        backend="jnp",
    )
    frames = run_app(r, frames=2)
    assert len(frames) == 2
    assert r.last_frame_rays > 0
    np.testing.assert_array_equal(frames[0], frames[1])  # static scene+seed


def test_progressive_renderer_accumulates_through_app():
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90,
                         aspect_ratio=2.0)
    r = PathTraceRenderer(
        two_spheres_scene(), cam,
        RenderConfig(width=48, height=24, spp=2, max_bounces=3, seed=1),
        backend="jnp", progressive=True,
    )
    frames = run_app(r, frames=3)
    assert int(r.accumulator.sample_count) == 6
    # successive frames change (more samples) but converge: later diffs shrink
    d01 = np.abs(frames[0].astype(int) - frames[1].astype(int)).mean()
    d12 = np.abs(frames[1].astype(int) - frames[2].astype(int)).mean()
    assert d01 > 0
    assert d12 <= d01 + 1e-9


def test_path_trace_renderer_pallas_backend_interpret():
    # regression: the kernel frame path must NOT be wrapped in an outer jit
    # (scene packing needs concrete arrays); exercised via interpret mode
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90,
                         aspect_ratio=2.0)
    r = PathTraceRenderer(
        two_spheres_scene(), cam,
        RenderConfig(width=64, height=32, spp=1, max_bounces=2, seed=1),
        backend="triton", interpret=True, progressive=True,
    )
    f1 = np.asarray(r.draw_frame(0.0))
    f2 = np.asarray(r.draw_frame(0.0))
    assert f1.shape == (32, 64, 3)
    assert int(r.accumulator.sample_count) == 2
    assert r.last_frame_rays > 0


def test_mesh_renderer_through_app_loop():
    """MeshScene drives PathTraceRenderer + App + progressive accumulation
    like any other scene type (VERDICT r2 item 1)."""
    from csgrenderer.render import icosphere
    from csgrenderer.scene.graph import Material

    mesh = icosphere((0, 0, -4), 1.0, Material.lambertian((0.6, 0.3, 0.3)), 1)
    cam = Camera.look_at((0, 0, 0), (0, 0, -4), vfov_degrees=45,
                         aspect_ratio=2.0)
    r = PathTraceRenderer(
        mesh, cam,
        RenderConfig(width=64, height=32, spp=1, max_bounces=3, seed=1),
        backend="jnp",
    )
    frames = run_app(r, frames=2)
    assert len(frames) == 2 and r.last_frame_rays > 0
    np.testing.assert_array_equal(frames[0], frames[1])

    # meshes have no kernel: interpret=True still takes the XLA path,
    # here with progressive accumulation
    rp = PathTraceRenderer(
        mesh, cam,
        RenderConfig(width=64, height=32, spp=1, max_bounces=3, seed=1),
        interpret=True, progressive=True,
    )
    assert rp.backend == "jnp"
    f1 = np.asarray(rp.draw_frame(0.0))
    _ = rp.draw_frame(0.0)
    assert f1.shape == (32, 64, 3)
    assert int(rp.accumulator.sample_count) == 2
    assert rp.last_frame_rays > 0


def test_render_to_noise_exactness_and_stop():
    """render_to_noise (round 4): the merged two-stream accumulator must
    equal a single uniform render over the same sample range (disjoint
    sample_offsets compose exactly under the counter-based RNG), the
    loop must stop once the measured noise reaches the target, and the
    renderer's progressive state must advance past the consumed range."""
    from csgrenderer.render import integrator

    scene = two_spheres_scene()
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0,
                         aspect_ratio=2.0)
    cfg = RenderConfig(width=32, height=16, spp=4, max_bounces=3, seed=9)
    r = PathTraceRenderer(scene, cam, cfg, backend="jnp", progressive=True)
    acc, noise, used = r.render_to_noise(target=5e-2, max_spp=64)
    assert used % (2 * cfg.spp) == 0 and 0 < used <= 64
    assert noise <= 5e-2  # a diffuse 2-sphere scene converges fast
    assert int(acc.sample_count) == used
    assert r._sample_offset == used
    assert int(r.accumulator.sample_count) == used

    # exactness: one uniform render over offsets [0, used)
    ref, rrays = integrator.render_image(
        scene.nearest_hit, cam, 32, 16, spp=used, max_bounces=3, seed=9,
    )
    np.testing.assert_allclose(
        np.asarray(acc.image()), np.asarray(ref), atol=2e-6
    )
    assert int(acc.rays_traced) == int(rrays)

    # an unreachable target runs to max_spp and reports honestly
    r2 = PathTraceRenderer(scene, cam, cfg, backend="jnp")
    acc2, noise2, used2 = r2.render_to_noise(target=1e-9, max_spp=16)
    assert used2 == 16 and noise2 > 1e-9
