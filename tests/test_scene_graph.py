"""Scene-graph API tests, including the reference demo's root-bitset contract."""

import numpy as np
import pytest

from csgrenderer.math import quaternion as quat
from csgrenderer.scene import Material, NodeArgument, SceneGraph
from csgrenderer.scene.tape import OP_DIFF, OP_PUSH, OP_UNION


def test_reference_demo_root_semantics():
    # Mirrors src/wololo_demo/main.c:40-50: two spheres + union; the union
    # marks its children non-root (renderer.c:2252-2253).
    g = SceneGraph(max_node_count=8, name="Test1Render")
    s1 = g.add_sphere_node(1.0)
    s2 = g.add_sphere_node(1.0)
    blob = g.add_union_of_node(NodeArgument(s1), NodeArgument(s2))
    assert not g.is_root(s1)
    assert not g.is_root(s2)
    assert g.is_root(blob)
    assert g.roots() == [blob]


def test_node_pool_exhaustion_raises():
    # renderer.c:2234's assert becomes a real error.
    g = SceneGraph(max_node_count=2)
    g.add_sphere_node(1.0)
    g.add_sphere_node(1.0)
    with pytest.raises(RuntimeError, match="exhausted"):
        g.add_sphere_node(1.0)


def test_bad_child_id_rejected():
    g = SceneGraph(max_node_count=8)
    s = g.add_sphere_node(1.0)
    with pytest.raises(ValueError):
        g.add_union_of_node(NodeArgument(s), NodeArgument(99))


def test_compile_postfix_order():
    g = SceneGraph(max_node_count=16)
    s = g.add_sphere_node(1.0)
    b = g.add_box_node((1, 1, 1))
    c = g.add_cylinder_node(0.5, 1.0)
    u = g.add_union_of_node(NodeArgument(s), NodeArgument(b))
    g.add_difference_of_node(NodeArgument(u), NodeArgument(c))
    tape = g.compile()
    opcodes = [op for op, _ in tape.ops]
    assert opcodes == [OP_PUSH, OP_PUSH, OP_UNION, OP_PUSH, OP_DIFF]
    assert tape.stack_depth == 2
    assert tape.n_leaves == 3


def test_compile_requires_unique_root():
    g = SceneGraph(max_node_count=8)
    g.add_sphere_node(1.0)
    g.add_sphere_node(2.0)
    with pytest.raises(ValueError, match="roots"):
        g.compile()


def test_edge_transforms_bake_to_leaf_world_positions():
    g = SceneGraph(max_node_count=8)
    s1 = g.add_sphere_node(1.0)
    s2 = g.add_sphere_node(1.0)
    g.add_union_of_node(
        NodeArgument(s1, offset=(-2.0, 0.0, 0.0)),
        NodeArgument(s2, offset=(3.0, 1.0, 0.0)),
    )
    tape = g.compile()
    np.testing.assert_allclose(tape.leaf_pos[0], [-2.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(tape.leaf_pos[1], [3.0, 1.0, 0.0], atol=1e-6)


def test_nested_transform_composition():
    # rotate parent edge 90deg about z, then offset child edge by (1,0,0):
    # leaf origin = R_z(90) * (1,0,0) + (5,0,0) = (5,1,0)
    q90 = tuple(np.asarray(quat.from_axis_angle(np.array([0.0, 0.0, 1.0]), np.pi / 2)))
    g = SceneGraph(max_node_count=8)
    inner = g.add_sphere_node(0.5)
    pad = g.add_sphere_node(0.25)
    mid = g.add_union_of_node(
        NodeArgument(inner, offset=(1.0, 0.0, 0.0)), NodeArgument(pad)
    )
    other = g.add_sphere_node(0.1)
    g.add_union_of_node(
        NodeArgument(mid, orientation=q90, offset=(5.0, 0.0, 0.0)),
        NodeArgument(other),
    )
    tape = g.compile()
    np.testing.assert_allclose(tape.leaf_pos[0], [5.0, 1.0, 0.0], atol=1e-5)


def test_materials_roundtrip():
    g = SceneGraph(max_node_count=8)
    s = g.add_sphere_node(1.0, Material.metal((0.9, 0.8, 0.7), fuzz=0.1))
    b = g.add_box_node((1, 1, 1), Material.dielectric(1.5))
    g.add_union_of_node(NodeArgument(s), NodeArgument(b))
    tape = g.compile()
    assert int(tape.mat_kind[0]) == 2
    np.testing.assert_allclose(tape.albedo[0], [0.9, 0.8, 0.7], atol=1e-6)
    np.testing.assert_allclose(tape.mat_param[0], 0.1, atol=1e-6)
    assert int(tape.mat_kind[1]) == 3
    np.testing.assert_allclose(tape.mat_param[1], 1.5, atol=1e-6)


def test_rebake_is_jit_safe():
    import jax
    import jax.numpy as jnp

    g = SceneGraph(max_node_count=8)
    s1 = g.add_sphere_node(1.0)
    s2 = g.add_sphere_node(1.0)
    g.add_union_of_node(NodeArgument(s1, offset=(1.0, 0.0, 0.0)), NodeArgument(s2))
    tape = g.compile()

    @jax.jit
    def animate(tape, dx):
        new_off = tape.edge_off.at[0, 0].set(dx)
        return tape.with_edges(tape.edge_quat, new_off).leaf_pos

    pos = animate(tape, jnp.float32(7.0))
    np.testing.assert_allclose(pos[0], [7.0, 0.0, 0.0], atol=1e-6)
