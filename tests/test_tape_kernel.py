"""CSG tape Triton kernel vs the jnp tape evaluator (interpret mode)."""

import functools

import numpy as np
import pytest

from csgrenderer.camera import Camera
from csgrenderer.kernels.tape_kernel import render_image_tape_pallas
from csgrenderer.models import animated_csg_scene, config3_csg_scene
from csgrenderer.render import render_image, tape_hit_adapter
from csgrenderer.scene import Material, NodeArgument, SceneGraph


def compare(tape, cam, w, h, spp, bounces, seed, sky="rtiow", tol=1e-4):
    hit = functools.partial(tape_hit_adapter, tape)
    ref, rrays = render_image(
        hit, cam, w, h, spp=spp, max_bounces=bounces, seed=seed, sky=sky
    )
    img, krays = render_image_tape_pallas(
        tape, cam, w, h, spp=spp, max_bounces=bounces, seed=seed, sky=sky,
        interpret=True,
    )
    ref, img = np.asarray(ref), np.asarray(img)
    assert not np.isnan(img).any()
    rmse = float(np.sqrt(np.mean((ref - img) ** 2)))
    assert rmse <= tol, f"rmse {rmse}"
    assert int(krays) == int(rrays)
    return img


def test_config3_matches_reference():
    tape = config3_csg_scene().compile(k=2)
    cam = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35, aspect_ratio=1.0)
    compare(tape, cam, 32, 32, spp=1, bounces=3, seed=3)


def test_deep_csg_matches_reference():
    g, animate = animated_csg_scene(4)
    tape = animate(g.compile(k=2), 1.0)
    cam = Camera.look_at((0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40, aspect_ratio=1.0)
    compare(tape, cam, 24, 24, spp=1, bounces=3, seed=5)


def test_rotated_leaves_and_materials():
    import numpy as onp

    from csgrenderer.math import quaternion as quat

    q = tuple(onp.asarray(quat.from_axis_angle(onp.array([0.0, 1.0, 0.0]), 0.6)))
    g = SceneGraph()
    b = g.add_box_node((0.7, 0.7, 0.7), Material.metal((0.9, 0.8, 0.6), 0.05))
    c = g.add_cylinder_node(0.5, 1.2, Material.dielectric(1.5))
    hs = g.add_infinite_planar_partition_node(
        (0.0, 1.0, 0.0), Material.lambertian((0.4, 0.5, 0.6))
    )
    u = g.add_union_of_node(NodeArgument(b, orientation=q), NodeArgument(c))
    g.add_union_of_node(NodeArgument(u), NodeArgument(hs, offset=(0, -1.2, 0)))
    tape = g.compile(k=2)
    cam = Camera.look_at((3, 2, 4), (0, 0, 0), vfov_degrees=40, aspect_ratio=1.0)
    compare(tape, cam, 24, 24, spp=1, bounces=3, seed=7)


def test_entering_flag_on_difference_surface():
    # glass shell: big sphere minus inner sphere; a ray entering the carved
    # region must see correct front-face on the inner (subtracted) surface
    g = SceneGraph()
    outer = g.add_sphere_node(1.0, Material.dielectric(1.5))
    inner = g.add_sphere_node(0.6, Material.dielectric(1.5))
    g.add_difference_of_node(NodeArgument(outer), NodeArgument(inner))
    tape = g.compile(k=2)
    cam = Camera.look_at((0, 0, 3), (0, 0, 0), vfov_degrees=45, aspect_ratio=1.0)
    compare(tape, cam, 24, 24, spp=1, bounces=5, seed=9)


def test_black_sky_mode():
    g = SceneGraph()
    g.add_sphere_node(1.0, Material.emissive((2.0, 1.0, 0.5)))
    tape = g.compile(k=2)
    cam = Camera.look_at((0, 0, 4), (0, 0, 0), vfov_degrees=45, aspect_ratio=1.0)
    img = compare(tape, cam, 32, 32, spp=1, bounces=2, seed=1, sky="black")
    assert img[0, 0].max() == 0.0  # corner: no sky, no sphere
    assert img[16, 16].max() > 1.0  # center: emissive


def test_normal_map_attribution_matches_reference():
    """Direct owner/normal comparison: normal-map materials make bounce-1
    radiance = the attribution normal itself, so any owner or normal
    divergence between kernel and jnp is visible immediately (lambertian
    scenes hide it behind RNG until bounce 2)."""
    g = SceneGraph(max_node_count=16)
    s = g.add_sphere_node(1.0, Material.normal_map())
    b = g.add_box_node((0.8, 0.8, 0.8), Material.normal_map())
    c = g.add_cylinder_node(0.55, 1.6, Material.normal_map())
    u = g.add_union_of_node(
        NodeArgument(s, offset=(-0.3, 0, 0)), NodeArgument(b, offset=(0.5, 0, 0))
    )
    g.add_difference_of_node(NodeArgument(u), NodeArgument(c))
    tape = g.compile(k=2)
    cam = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35, aspect_ratio=1.0)
    compare(tape, cam, 48, 48, spp=1, bounces=1, seed=3)


def _two_leaf_tape(op):
    g = SceneGraph()
    a = g.add_sphere_node(1.0, Material.lambertian((0.8, 0.3, 0.3)))
    b = g.add_box_node((0.6, 0.6, 0.6), Material.metal((0.7, 0.7, 0.7), 0.1))
    args = (NodeArgument(a), NodeArgument(b, offset=(0.7, 0.3, 0.0)))
    {
        "union": g.add_union_of_node,
        "intersect": g.add_intersection_of_node,
        "diff": g.add_difference_of_node,
    }[op](*args)
    return g.compile(k=4)


@pytest.mark.parametrize("op", ["union", "intersect", "diff"])
def test_event_flip_matches_interval_reference(op):
    """Event-flip evaluation (the kernel's) == the interval-list reference
    (render/tape_eval.py) on each CSG op: same nearest t, same hit set,
    same solid-level entering flag, for rays from all around the solid."""
    import jax.numpy as jnp

    from csgrenderer.kernels.tape_kernel import (
        LEAF_ROW, T_FAR, event_flip, pack_leaves,
    )
    from csgrenderer.render.tape_eval import tape_nearest_hit

    tape = _two_leaf_tape(op)
    rng = np.random.default_rng(3)
    n = 512
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = (rng.normal(size=(n, 3)) * 0.3 - o / 3.0).astype(np.float32)
    tab = pack_leaves(tape)

    t, entering = event_flip(
        tape.ops, tape.leaf_types, lambda l, j: tab[l * LEAF_ROW + j],
        tuple(jnp.asarray(o[:, k]) for k in range(3)),
        tuple(jnp.asarray(d[:, k]) for k in range(3)),
    )
    t, entering = np.asarray(t), np.asarray(entering)
    ref = tape_nearest_hit(tape, jnp.asarray(o), jnp.asarray(d), eps=1e-3)
    hit = t < T_FAR
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    assert hit.mean() > 0.2  # the rays really exercise the solid
    np.testing.assert_allclose(t[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    np.testing.assert_array_equal(
        entering[hit] > 0, np.asarray(ref.entering)[hit]
    )
