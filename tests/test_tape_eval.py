"""CSG tape evaluator tests: geometry, normals, materials, transforms."""

import jax.numpy as jnp
import numpy as np

from csgrenderer.math import quaternion as quat
from csgrenderer.scene import Material, NodeArgument, SceneGraph
from csgrenderer.render.tape_eval import eval_tape_intervals, tape_nearest_hit


def ray(o, d):
    return jnp.array([o], jnp.float32), jnp.array([d], jnp.float32)


def test_single_sphere_hit():
    g = SceneGraph()
    g.add_sphere_node(1.0)
    tape = g.compile()
    o, d = ray([0, 0, -5], [0, 0, 1])
    h = tape_nearest_hit(tape, o, d)
    assert bool(h.hit[0]) and bool(h.entering[0])
    np.testing.assert_allclose(h.t[0], 4.0, atol=1e-4)
    np.testing.assert_allclose(h.normal[0], [0, 0, -1], atol=1e-4)


def test_union_two_spheres_nearest():
    g = SceneGraph()
    s1 = g.add_sphere_node(1.0)
    s2 = g.add_sphere_node(1.0)
    g.add_union_of_node(
        NodeArgument(s1, offset=(0, 0, -3)), NodeArgument(s2, offset=(0, 0, 3))
    )
    tape = g.compile()
    o, d = ray([0, 0, -10], [0, 0, 1])
    h = tape_nearest_hit(tape, o, d)
    np.testing.assert_allclose(h.t[0], 6.0, atol=1e-4)  # front of s1 at z=-4


def test_intersection_lens():
    # two unit spheres offset +-0.5 on z: intersection spans z in [-0.5, 0.5]
    g = SceneGraph()
    s1 = g.add_sphere_node(1.0)
    s2 = g.add_sphere_node(1.0)
    g.add_intersection_of_node(
        NodeArgument(s1, offset=(0, 0, -0.5)), NodeArgument(s2, offset=(0, 0, 0.5))
    )
    tape = g.compile()
    o, d = ray([0, 0, -10], [0, 0, 1])
    h = tape_nearest_hit(tape, o, d)
    np.testing.assert_allclose(h.t[0], 9.5, atol=1e-4)  # enter lens at z=-0.5


def test_difference_carves_hole():
    # big sphere minus small sphere at front face: axial ray enters deeper
    g = SceneGraph()
    big = g.add_sphere_node(1.0)
    small = g.add_sphere_node(0.5)
    g.add_difference_of_node(
        NodeArgument(big), NodeArgument(small, offset=(0, 0, -1.0))
    )
    tape = g.compile()
    o, d = ray([0, 0, -10], [0, 0, 1])
    h = tape_nearest_hit(tape, o, d)
    # small sphere spans z in [-1.5, -0.5]; big spans [-1, 1]; result starts
    # at z=-0.5 (the small sphere's back surface)
    np.testing.assert_allclose(h.t[0], 9.5, atol=1e-4)
    assert bool(h.entering[0])
    # the owning surface is the SMALL sphere; its outward (from small) normal
    # at z=-0.5 is +z... face-forwarding happens in the adapter, here we get
    # the raw leaf normal:
    np.testing.assert_allclose(h.normal[0], [0, 0, 1], atol=1e-3)


def test_difference_material_attribution():
    g = SceneGraph()
    big = g.add_sphere_node(1.0, Material.lambertian((0.9, 0.1, 0.1)))
    small = g.add_sphere_node(0.5, Material.lambertian((0.1, 0.9, 0.1)))
    g.add_difference_of_node(
        NodeArgument(big), NodeArgument(small, offset=(0, 0, -1.0))
    )
    tape = g.compile()
    o, d = ray([0, 0, -10], [0, 0, 1])
    h = tape_nearest_hit(tape, o, d)
    np.testing.assert_allclose(h.albedo[0], [0.1, 0.9, 0.1], atol=1e-5)  # small's


def test_rotated_box_hit():
    # box rotated 45deg about y: the axial ray now hits an edge-on face at
    # distance 10 - sqrt(2)*1 (corner toward the ray)
    q45 = tuple(np.asarray(quat.from_axis_angle(np.array([0.0, 1.0, 0.0]), np.pi / 4)))
    g = SceneGraph()
    b = g.add_box_node((1.0, 1.0, 1.0))
    pad = g.add_sphere_node(0.001)
    g.add_union_of_node(
        NodeArgument(b, orientation=q45), NodeArgument(pad, offset=(50, 0, 0))
    )
    tape = g.compile()
    o, d = ray([0, 0, -10], [0, 0, 1])
    h = tape_nearest_hit(tape, o, d)
    np.testing.assert_allclose(h.t[0], 10.0 - np.sqrt(2.0), atol=1e-3)


def test_config3_geometry():
    # (sphere u box) \ cylinder — BASELINE config 3
    g = SceneGraph()
    s = g.add_sphere_node(1.0)
    b = g.add_box_node((0.8, 0.8, 0.8))
    c = g.add_cylinder_node(0.5, 1.5)
    u = g.add_union_of_node(NodeArgument(s), NodeArgument(b, offset=(0.5, 0, 0)))
    g.add_difference_of_node(NodeArgument(u), NodeArgument(c))
    tape = g.compile()

    # axial ray at y=0: cylinder carves [4.5, 5.5] out of union [4, 6]
    o, d = ray([0, 0, -5], [0, 0, 1])
    t_in, t_out = eval_tape_intervals(tape, o, d)
    np.testing.assert_allclose(t_in[0, 0], 4.0, atol=1e-4)
    np.testing.assert_allclose(t_out[0, 0], 4.5, atol=1e-4)
    np.testing.assert_allclose(t_in[0, 1], 5.5, atol=1e-4)
    np.testing.assert_allclose(t_out[0, 1], 6.0, atol=1e-4)

    # at y=0.9 the sphere chord is inside the carved cylinder: no hit
    o, d = ray([0, 0.9, -5], [0, 0, 1])
    h = tape_nearest_hit(tape, o, d)
    assert not bool(h.hit[0])


def test_ray_origin_inside_solid_reports_exit():
    g = SceneGraph()
    g.add_sphere_node(2.0)
    tape = g.compile()
    o, d = ray([0, 0, 0], [0, 0, 1])
    h = tape_nearest_hit(tape, o, d)
    assert bool(h.hit[0]) and not bool(h.entering[0])
    np.testing.assert_allclose(h.t[0], 2.0, atol=1e-4)


def test_halfspace_ground():
    # ground = halfspace with +y normal, lowered 1 unit via edge offset
    g = SceneGraph()
    hs = g.add_infinite_planar_partition_node((0.0, 1.0, 0.0))
    s = g.add_sphere_node(0.5)
    g.add_union_of_node(
        NodeArgument(hs, offset=(0, -1.0, 0)), NodeArgument(s, offset=(0, 0, -3))
    )
    tape = g.compile()
    o, d = ray([0, 0, 0], [0, -1, 0.0])
    h = tape_nearest_hit(tape, o, d)
    np.testing.assert_allclose(h.t[0], 1.0, atol=1e-4)
    np.testing.assert_allclose(h.normal[0], [0, 1, 0], atol=1e-4)


def test_batched_2d_ray_grid():
    g = SceneGraph()
    g.add_sphere_node(1.0)
    tape = g.compile()
    o = jnp.zeros((4, 8, 3)).at[..., 2].set(-5.0)
    d = jnp.zeros((4, 8, 3)).at[..., 2].set(1.0)
    h = tape_nearest_hit(tape, o, d)
    assert h.t.shape == (4, 8)
    np.testing.assert_allclose(h.t, 4.0, atol=1e-4)


def test_box_face_plane_does_not_steal_attribution():
    """A hit point on another leaf that lies in a box's EXTENDED face plane
    must not win the surface-attribution argmin (ADVICE r1: scores are
    distances to the finite surface, |SDF|, not to infinite face planes)."""
    g = SceneGraph()
    # box FIRST so an erroneous score tie would resolve to the box
    box = g.add_box_node(
        (1.0, 1.0, 1.0), material=Material.lambertian((1.0, 0.0, 0.0))
    )
    sph = g.add_sphere_node(1.0, material=Material.metal((0.0, 1.0, 0.0)))
    # box far away on +x; its y=+1 face plane extends through the sphere's
    # north pole (0, 1, 0)
    g.add_union_of_node(
        NodeArgument(box, offset=(5.0, 0.0, 0.0)), NodeArgument(sph)
    )
    tape = g.compile()
    o, d = ray([0, 3, 0], [0, -1, 0])  # hits the sphere at (0, 1, 0)
    h = tape_nearest_hit(tape, o, d)
    assert bool(h.hit[0])
    np.testing.assert_allclose(h.t[0], 2.0, atol=1e-4)
    np.testing.assert_allclose(h.normal[0], [0, 1, 0], atol=1e-4)
    assert int(h.mat_kind[0]) == 2  # the sphere's metal, not the box's
    np.testing.assert_allclose(h.albedo[0], [0, 1, 0], atol=1e-6)


def test_cylinder_cap_plane_does_not_steal_attribution():
    """Same for a cylinder's cap plane extended beyond its radius."""
    g = SceneGraph()
    cyl = g.add_cylinder_node(
        0.5, 1.0, material=Material.lambertian((1.0, 0.0, 0.0))
    )
    sph = g.add_sphere_node(1.0, material=Material.metal((0.0, 1.0, 0.0)))
    # cylinder far on +x: its y=+1 cap plane passes through (0, 1, 0)
    g.add_union_of_node(
        NodeArgument(cyl, offset=(5.0, 0.0, 0.0)), NodeArgument(sph)
    )
    tape = g.compile()
    o, d = ray([0, 3, 0], [0, -1, 0])
    h = tape_nearest_hit(tape, o, d)
    assert bool(h.hit[0])
    assert int(h.mat_kind[0]) == 2
    np.testing.assert_allclose(h.normal[0], [0, 1, 0], atol=1e-4)
