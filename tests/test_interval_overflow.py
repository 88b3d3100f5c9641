"""Interval-capacity truncation is detected, not silent (round-1 verdict 5).

Deep CSG along one ray can produce more disjoint spans than the K interval
slots of the jnp reference; the combine keeps the K nearest. These tests
assert the dropped-span counters fire on a crafted overflow scene and stay
ZERO on the benchmark CSG configs, and that the kernel's event-flip
evaluation has no such capacity.
"""

import functools

import jax.numpy as jnp
import numpy as np

from csgrenderer.camera import Camera
from csgrenderer.kernels.tape_kernel import render_image_tape_pallas
from csgrenderer.models import animated_csg_scene, config3_csg_scene
from csgrenderer.render import interval
from csgrenderer.render.tape_eval import tape_dropped_spans
from csgrenderer.scene import Material, NodeArgument, SceneGraph


def _three_pearls(k):
    """Union of three disjoint spheres along +z: 3 spans > k=2 slots."""
    g = SceneGraph()
    s1 = g.add_sphere_node(0.4, Material.lambertian((0.8, 0.2, 0.2)))
    s2 = g.add_sphere_node(0.4, Material.lambertian((0.2, 0.8, 0.2)))
    s3 = g.add_sphere_node(0.4, Material.lambertian((0.2, 0.2, 0.8)))
    u = g.add_union_of_node(
        NodeArgument(s1, offset=(0, 0, 2.0)), NodeArgument(s2, offset=(0, 0, 4.0))
    )
    g.add_union_of_node(NodeArgument(u), NodeArgument(s3, offset=(0, 0, 6.0)))
    return g.compile(k=k)


def test_combine_reports_dropped():
    # two 2-span lists unioning to 4 disjoint spans in k=2 slots
    a = interval.single_to_list(jnp.float32([1.0]), jnp.float32([2.0]), 2)
    b = interval.single_to_list(jnp.float32([3.0]), jnp.float32([4.0]), 2)
    ab = interval.combine(a, b, op="union", k=2)  # 2 spans: fits
    c = interval.single_to_list(jnp.float32([5.0]), jnp.float32([6.0]), 2)
    d = interval.single_to_list(jnp.float32([7.0]), jnp.float32([8.0]), 2)
    cd = interval.combine(c, d, op="union", k=2)
    t_in, t_out, dropped = interval.combine(
        ab, cd, op="union", k=2, with_dropped=True
    )
    assert int(dropped[0]) == 2  # 4 spans - 2 slots
    np.testing.assert_allclose(np.asarray(t_in[0]), [1.0, 3.0], atol=1e-6)


def test_tape_overflow_fires_on_deep_ray():
    tape = _three_pearls(k=2)
    o = jnp.float32([[0, 0, -5]])
    d = jnp.float32([[0, 0, 1]])
    dropped = tape_dropped_spans(tape, o, d)
    assert int(dropped[0]) == 1  # 3 spans, 2 slots
    # an off-axis ray sees at most one sphere: exact
    o2 = jnp.float32([[10, 0, -5]])
    dropped2 = tape_dropped_spans(tape, o2, d)
    assert int(dropped2[0]) == 0


def _assert_no_overflow_anywhere(tape, cam, w, h, n_bounce_batches=2):
    """Zero dropped spans on primary rays AND random bounce rays from the
    hit points (the geometric claim; the kernel counter itself is covered
    by the pearls tests via the jnp-identical counting)."""
    from csgrenderer.camera.pinhole import pixel_st_grid
    from csgrenderer.render.tape_eval import tape_nearest_hit

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    stx = (xs + 0.5) / w
    sty = 1.0 - (ys + 0.5) / h
    o = np.broadcast_to(np.asarray(cam.origin), (h, w, 3)).reshape(-1, 3)
    d = (
        np.asarray(cam.lower_left)
        + stx[..., None] * np.asarray(cam.horizontal)
        + sty[..., None] * np.asarray(cam.vertical)
        - np.asarray(cam.origin)
    ).reshape(-1, 3)
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    rng = np.random.default_rng(0)
    for _ in range(n_bounce_batches + 1):
        assert int(jnp.sum(tape_dropped_spans(tape, o, d))) == 0
        hit = tape_nearest_hit(tape, o, d)
        keep = np.asarray(hit.hit)
        if not keep.any():
            break
        t_safe = jnp.where(hit.hit, hit.t, 1.0)
        p = np.asarray(o + t_safe[:, None] * d)[keep]
        n = np.asarray(hit.normal)[keep]
        scatter = n + rng.normal(size=n.shape).astype(np.float32) * 0.7
        o = jnp.asarray(p, jnp.float32)
        d = jnp.asarray(scatter, jnp.float32)


def test_benchmark_configs_do_not_overflow():
    """The BASELINE CSG configs must be exact at their shipped K."""
    t3 = config3_csg_scene().compile(k=2)
    cam3 = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0,
                          aspect_ratio=1.0)
    _assert_no_overflow_anywhere(t3, cam3, 64, 64)

    g5, animate5 = animated_csg_scene(n_levels=8)
    t5 = animate5(g5.compile(k=4), 1.0)
    cam5 = Camera.look_at((0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0,
                          aspect_ratio=1.0)
    _assert_no_overflow_anywhere(t5, cam5, 64, 64)


def test_event_path_is_exact_beyond_capacity():
    """The kernel's event-flip evaluation has NO interval capacity: the
    pearls scene that overflows k=2's interval lists must render
    IDENTICALLY to an uncropped k=4 compile, while the k=2 list reference
    truncates (drops the far pearl)."""
    cam = Camera.look_at(
        (0, 0, -6), (0, 0, 1), vfov_degrees=30.0, aspect_ratio=1.0
    )
    kwargs = dict(spp=2, max_bounces=3, seed=3, interpret=True)
    img_k2, _ = render_image_tape_pallas(
        _three_pearls(k=2), cam, 24, 24, **kwargs
    )
    img_k4, _ = render_image_tape_pallas(
        _three_pearls(k=4), cam, 24, 24, **kwargs
    )
    np.testing.assert_array_equal(np.asarray(img_k2), np.asarray(img_k4))

    # the list reference at k=2 counts the truncated spans along the axis
    # (it keeps the K NEAREST spans, so the nearest-hit image itself often
    # survives truncation; the counter is what detects the lost tail)
    o = jnp.asarray([[0.0, 0.0, -6.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    assert int(tape_dropped_spans(_three_pearls(k=2), o, d)[0]) > 0
    assert int(tape_dropped_spans(_three_pearls(k=4), o, d)[0]) == 0
