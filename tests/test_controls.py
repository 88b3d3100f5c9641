"""Interactive input path (app/controls.py): orbit rig math, event
handling, and the full browser->App->renderer wiring — the reference's
glfwPollEvents/window-close analog (app.c:204, 136)."""

import math

import numpy as np

from csgrenderer.app.controls import OrbitController, attach
from csgrenderer.app.loop import App
from csgrenderer.app.preview import PreviewServer
from csgrenderer.app.renderers import PathTraceRenderer
from csgrenderer.camera import Camera
from csgrenderer.render.integrator import SphereScene
from csgrenderer.utils.config import RenderConfig


def _tiny_scene():
    import jax.numpy as jnp

    return SphereScene(
        centers=jnp.array([(0.0, 0.0, -3.0), (0.0, -100.5, -3.0)],
                          jnp.float32),
        radii=jnp.array([0.5, 100.0], jnp.float32),
        mat_kind=jnp.zeros((2,), jnp.int32),
        albedo=jnp.array([(0.7, 0.3, 0.3), (0.5, 0.5, 0.5)], jnp.float32),
        mat_param=jnp.zeros((2,), jnp.float32),
    )


def test_from_camera_reproduces_pose():
    lookfrom, lookat = (13.0, 2.0, 3.0), (0.0, 0.0, 0.0)
    rig = OrbitController.from_camera(
        lookfrom, lookat, vfov_degrees=20.0, aspect_ratio=2.0,
        aperture=0.1, focus_dist=10.0,
    )
    ref = Camera.look_at(lookfrom, lookat, vfov_degrees=20.0,
                         aspect_ratio=2.0, aperture=0.1, focus_dist=10.0)
    got = rig.camera()
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_orbit_events_move_the_eye():
    rig = OrbitController(target=(0, 0, 0), distance=5.0, yaw=0.0, pitch=0.0)
    o0 = np.asarray(rig.camera().origin)
    assert rig.handle({"type": "orbit", "dyaw": str(math.pi / 2)}) is None
    o1 = np.asarray(rig.camera().origin)
    assert np.linalg.norm(o1 - o0) > 1.0
    np.testing.assert_allclose(np.linalg.norm(o1), 5.0, atol=1e-5)
    # pitch clamps off the pole, distance clamps at min
    rig.handle({"type": "orbit", "dpitch": "99"})
    assert rig.pitch < math.pi / 2
    rig.handle({"type": "orbit", "dzoom": "-999"})
    assert rig.distance == rig.min_distance
    # key steps and the close analogs
    assert rig.handle({"type": "key", "code": "ArrowLeft"}) is None
    assert rig.handle({"type": "key", "code": "Escape"}) == "close"
    assert rig.handle({"type": "close"}) == "close"
    assert rig.handle({"type": "key", "code": "x"}) is None  # unbound: noop


def test_attach_drives_renderer_and_stops_on_close():
    """End-to-end: events pushed at the server move the renderer's camera
    inside App.run (no recompile — the camera is a traced argument) and a
    close event stops the loop before max_frames."""
    cfg = RenderConfig(width=16, height=8, spp=1, max_bounces=2, seed=1)
    cam = Camera.look_at((0, 0, 1), (0, 0, -3), vfov_degrees=60.0,
                         aspect_ratio=2.0)
    r = PathTraceRenderer(_tiny_scene(), cam, cfg, backend="jnp")
    srv = PreviewServer(port=0)  # never started: queue-only use
    rig = OrbitController.from_camera((0, 0, 1), (0, 0, -3),
                                      vfov_degrees=60.0, aspect_ratio=2.0)
    # huge update rate: the fixed-timestep accumulator fires update_cb on
    # every loop iteration even though these tiny frames render in <1 ms
    app = App(target_updates_per_sec=100000.0, width=16, height=8)
    app.swap_scene(r)
    attach(app, r, srv, rig)

    img0 = np.asarray(r.draw_frame(0.0))
    compiles = r._frame._cache_size()
    srv.push_event({"type": "orbit", "dyaw": "1.2"})
    frames = []
    app.frame_sink = lambda i, img: frames.append(np.asarray(img))
    assert app.run(max_frames=3)
    assert r._frame._cache_size() == compiles  # moved camera, no recompile
    assert any(not np.array_equal(f, img0) for f in frames)

    srv.push_event({"type": "close"})
    count = []
    app.frame_sink = lambda i, img: count.append(i)
    assert app.run(max_frames=1000)
    assert len(count) < 1000  # stopped by the event, not the frame cap
