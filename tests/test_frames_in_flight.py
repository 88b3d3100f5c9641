"""Frames-in-flight pipelining: dispatch of frame N+1 precedes consumption
of frame N (the overlap the reference built sync objects for and then
defeated with a per-frame vkQueueWaitIdle — renderer.c:51, 2212)."""

import jax.numpy as jnp
import numpy as np

from csgrenderer.app.loop import App
from csgrenderer.app.renderers import PathTraceRenderer
from csgrenderer.camera import Camera
from csgrenderer.models import two_spheres_scene
from csgrenderer.utils.config import RenderConfig


class RecordingRenderer:
    """Logs dispatch/consume interleaving via a lazily-read array wrapper."""

    def __init__(self, log):
        self.log = log
        self.last_frame_rays = 1

    def draw_frame_async(self, t):
        idx = len([e for e in self.log if e[0] == "dispatch"])
        self.log.append(("dispatch", idx))
        outer = self

        class Lazy:
            def __array__(self, dtype=None, copy=None):
                outer.log.append(("consume", idx))
                return np.zeros((2, 2, 3), np.uint8)

        return Lazy(), 1

    def draw_frame(self, t):
        self.log.append(("dispatch-sync", None))
        return np.zeros((2, 2, 3), np.uint8)


def test_dispatch_precedes_consume_with_two_in_flight():
    log = []
    app = App(frame_sink=lambda i, img: None)
    app.swap_scene(RecordingRenderer(log))
    assert app.run(max_frames=4, frames_in_flight=2)
    order = [e for e in log if e[0] in ("dispatch", "consume")]
    # dispatch 0, dispatch 1, consume 0, dispatch 2, consume 1, ...
    assert order[0] == ("dispatch", 0)
    assert order[1] == ("dispatch", 1)
    assert order[2] == ("consume", 0)
    assert order[3] == ("dispatch", 2)
    assert order[4] == ("consume", 1)
    # every frame is consumed exactly once, in order
    consumed = [i for (k, i) in order if k == "consume"]
    assert consumed == [0, 1, 2, 3]


def test_pipelined_output_matches_serial():
    scene = two_spheres_scene()
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0,
                         aspect_ratio=1.0)
    cfg = RenderConfig(width=32, height=32, spp=2, max_bounces=4, seed=7)

    def collect(in_flight):
        frames = {}
        app = App(frame_sink=lambda i, img: frames.__setitem__(i, np.asarray(img)))
        app.swap_scene(PathTraceRenderer(scene, cam, cfg))
        fixed = iter(np.arange(0.0, 100.0, 0.125))  # deterministic clock
        assert app.run(max_frames=3, frames_in_flight=in_flight,
                       time_fn=lambda: float(next(fixed)))
        return frames

    serial = collect(1)
    piped = collect(2)
    assert sorted(serial) == sorted(piped) == [0, 1, 2]
    for i in serial:
        np.testing.assert_array_equal(serial[i], piped[i])
