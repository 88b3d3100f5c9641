"""Adaptive spp for the realtime loop (app/adaptive.py, round 5) — the
render-to-quality certificate extended from the offline path
(render_to_noise) to the live one (VERDICT item 5)."""

import numpy as np

from csgrenderer.app import AdaptiveSppRenderer, next_pow2_spp
from csgrenderer.camera import Camera
from csgrenderer.models import two_spheres_scene
from csgrenderer.utils.config import RenderConfig


def test_ladder_logic():
    # too noisy -> up one rung (never more, damping)
    assert next_pow2_spp(4, noise=0.10, target=0.02) == 8
    assert next_pow2_spp(4, noise=1.00, target=0.02) == 8
    # clean enough -> down one rung
    assert next_pow2_spp(8, noise=0.005, target=0.02) == 4
    # within the +-20% hysteresis band -> hold
    assert next_pow2_spp(8, noise=0.021, target=0.02) == 8
    assert next_pow2_spp(8, noise=0.017, target=0.02) == 8
    # clamps
    assert next_pow2_spp(1, noise=0.001, target=0.02) == 1
    assert next_pow2_spp(64, noise=9.0, target=0.02, max_spp=64) == 64
    # degenerate measurements hold
    assert next_pow2_spp(4, noise=float("nan"), target=0.02) == 4
    assert next_pow2_spp(4, noise=0.0, target=0.02) == 4


def test_adaptive_renderer_adapts_and_stays_disjoint():
    scene = two_spheres_scene()
    cam = Camera.look_at(
        (0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=1.5
    )
    cfg = RenderConfig(width=48, height=32, spp=2, max_bounces=3, seed=0)
    # very tight target: 2 spp at this size is far noisier, so the
    # controller must climb the ladder after each probe pair
    r = AdaptiveSppRenderer(
        scene, cam, cfg, target=1e-4, probe_stride=2, backend="jnp",
    )
    spps, offsets = [], []
    for i in range(6):
        img = np.asarray(r.draw_frame(0.0))
        assert img.shape == (32, 48, 3)
        spps.append(r.spp)
        offsets.append(r._offset)
    # climbed at least twice (2 -> 4 -> 8)
    assert spps[-1] >= 8, spps
    # the shared sample offset strictly advances (disjoint streams across
    # rung switches: every frame consumes a fresh counter range)
    assert all(b > a for a, b in zip(offsets, offsets[1:])), offsets
    assert np.isfinite(r.noise)


def test_adaptive_renderer_holds_at_target():
    scene = two_spheres_scene()
    cam = Camera.look_at(
        (0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=1.5
    )
    cfg = RenderConfig(width=48, height=32, spp=4, max_bounces=3, seed=0)
    # loose target: measured noise is already below it -> descend to min
    r = AdaptiveSppRenderer(
        scene, cam, cfg, target=0.5, probe_stride=2, backend="jnp",
    )
    for _ in range(6):
        r.draw_frame(0.0)
    assert r.spp == 1
