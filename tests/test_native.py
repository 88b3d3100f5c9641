"""Native C++ scene core: parity with the Python SceneGraph, tape-for-tape."""

import shutil

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    shutil.which("make") is None or shutil.which("g++") is None,
    reason="no C++ toolchain",
)

from csgrenderer.math import quaternion as quat  # noqa: E402
from csgrenderer.scene import Material, NodeArgument, SceneGraph  # noqa: E402
from csgrenderer.scene.native import NativeSceneGraph  # noqa: E402


def build_both(builder):
    py = SceneGraph(max_node_count=64)
    nat = NativeSceneGraph(max_node_count=64)
    root_py = builder(py)
    root_nat = builder(nat)
    assert root_py == root_nat
    return py.compile(root_py), nat.compile(root_nat)


def assert_tapes_equal(a, b, atol=1e-6):
    assert a.ops == b.ops
    assert a.leaf_types == b.leaf_types
    assert a.leaf_chains == b.leaf_chains
    assert a.stack_depth == b.stack_depth
    for attr in (
        "leaf_params", "leaf_rot", "leaf_pos", "mat_kind",
        "albedo", "mat_param", "edge_quat", "edge_off",
    ):
        np.testing.assert_allclose(
            np.asarray(getattr(a, attr)),
            np.asarray(getattr(b, attr)),
            atol=atol,
            err_msg=attr,
        )


def test_simple_union_parity():
    def build(g):
        s1 = g.add_sphere_node(1.0, Material.lambertian((0.8, 0.2, 0.2)))
        s2 = g.add_sphere_node(0.5, Material.metal((0.9, 0.9, 0.9), 0.1))
        return g.add_union_of_node(
            NodeArgument(s1, offset=(-1, 0, 0)), NodeArgument(s2, offset=(1, 0, 0))
        )

    assert_tapes_equal(*build_both(build))


def test_all_primitives_and_ops_parity():
    q = tuple(np.asarray(quat.from_axis_angle(np.array([0.0, 1.0, 0.0]), 0.7)))

    def build(g):
        s = g.add_sphere_node(1.0)
        b = g.add_box_node((0.5, 0.6, 0.7), Material.dielectric(1.5))
        c = g.add_cylinder_node(0.4, 1.2)
        h = g.add_infinite_planar_partition_node((0.0, 2.0, 0.0))
        u = g.add_union_of_node(NodeArgument(s, orientation=q), NodeArgument(b))
        i = g.add_intersection_of_node(
            NodeArgument(u, offset=(0, 1, 0)), NodeArgument(c)
        )
        return g.add_difference_of_node(
            NodeArgument(i, orientation=q, offset=(1, 2, 3)), NodeArgument(h)
        )

    assert_tapes_equal(*build_both(build))


def test_root_bitset_parity():
    g = NativeSceneGraph(max_node_count=8)
    s1 = g.add_sphere_node(1.0)
    s2 = g.add_sphere_node(1.0)
    blob = g.add_union_of_node(NodeArgument(s1), NodeArgument(s2))
    assert not g.is_root(s1)
    assert not g.is_root(s2)
    assert g.is_root(blob)
    assert g.node_count == 3


def test_pool_exhaustion_parity():
    g = NativeSceneGraph(max_node_count=1)
    g.add_sphere_node(1.0)
    with pytest.raises(RuntimeError, match="exhausted"):
        g.add_sphere_node(1.0)


def test_bad_child_rejected():
    g = NativeSceneGraph(max_node_count=8)
    s = g.add_sphere_node(1.0)
    with pytest.raises(ValueError):
        g.add_union_of_node(NodeArgument(s), NodeArgument(99))


def test_native_tape_renders_identically():
    import jax.numpy as jnp

    from csgrenderer.render.tape_eval import tape_nearest_hit

    def build(g):
        s = g.add_sphere_node(1.0, Material.lambertian((0.7, 0.3, 0.3)))
        b = g.add_box_node((0.8, 0.8, 0.8), Material.lambertian((0.3, 0.7, 0.3)))
        c = g.add_cylinder_node(0.55, 1.6)
        u = g.add_union_of_node(
            NodeArgument(s, offset=(-0.3, 0, 0)), NodeArgument(b, offset=(0.5, 0, 0))
        )
        return g.add_difference_of_node(NodeArgument(u), NodeArgument(c))

    tape_py, tape_nat = build_both(build)
    o = jnp.array([[0.0, 0.2, -5.0], [1.0, 0.4, -5.0]])
    d = jnp.array([[0.0, 0.0, 1.0], [0.0, 0.05, 1.0]])
    h1 = tape_nearest_hit(tape_py, o, d)
    h2 = tape_nearest_hit(tape_nat, o, d)
    np.testing.assert_allclose(np.asarray(h1.t), np.asarray(h2.t), atol=1e-5)
    np.testing.assert_allclose(np.asarray(h1.normal), np.asarray(h2.normal), atol=1e-5)
