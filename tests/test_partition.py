"""Disjoint-cluster tape decomposition (scene/partition.py + tape kernel
``partition=``): clustering decisions, and value parity of the clustered
event evaluation against the global jnp reference."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csgrenderer.camera import Camera
from csgrenderer.kernels import render_image_tape_pallas
from csgrenderer.models import config3_csg_scene, many_objects_scene
from csgrenderer.render import render_image
from csgrenderer.render.integrator import tape_hit_adapter
from csgrenderer.scene.graph import Material, NodeArgument as NA, SceneGraph
from csgrenderer.scene.partition import partition_tape


def test_single_object_scene_is_not_partitioned():
    # config3 is one boolean solid: nothing to decompose
    assert partition_tape(config3_csg_scene().compile(k=2)) is None
    # a union of two OVERLAPPING spheres collapses to one cluster
    g = SceneGraph(max_node_count=8)
    a = g.add_sphere_node(1.0, Material.lambertian((0.5, 0.5, 0.5)))
    b = g.add_sphere_node(1.0, Material.lambertian((0.5, 0.5, 0.5)))
    g.add_union_of_node(NA(a), NA(b, offset=(1.0, 0, 0)))
    assert partition_tape(g.compile(k=2)) is None


def test_disjoint_union_clusters():
    g = SceneGraph(max_node_count=16)
    a = g.add_sphere_node(0.5, Material.lambertian((0.5, 0.5, 0.5)))
    b = g.add_sphere_node(0.5, Material.lambertian((0.5, 0.5, 0.5)))
    c = g.add_box_node((0.4, 0.4, 0.4), Material.lambertian((0.5, 0.5, 0.5)))
    u = g.add_union_of_node(NA(a, offset=(-3, 0.5, 0)), NA(b, offset=(3, 0.5, 0)))
    g.add_union_of_node(NA(u), NA(c, offset=(0, 0.4, 5)))
    cl = partition_tape(g.compile(k=2))
    assert cl is not None and len(cl) == 3
    assert sorted(len(c_[1]) for c_ in cl) == [1, 1, 1]
    # every leaf appears exactly once across clusters
    all_leaves = sorted(sum((list(c_[1]) for c_ in cl), []))
    assert all_leaves == [0, 1, 2]


def test_objects_resting_on_ground_stay_separate():
    """The tangency tolerance: solids touching (not penetrating) the
    ground half-space cluster separately from it; a sunk solid merges."""
    g = SceneGraph(max_node_count=16)
    gr = g.add_infinite_planar_partition_node(
        (0, 1, 0), Material.lambertian((0.5, 0.5, 0.5))
    )
    resting = g.add_sphere_node(0.5, Material.lambertian((0.6, 0.3, 0.3)))
    sunk = g.add_sphere_node(0.5, Material.lambertian((0.3, 0.6, 0.3)))
    u = g.add_union_of_node(
        NA(resting, offset=(-3, 0.5, 0)),  # tangent to y=0
        NA(sunk, offset=(3, 0.2, 0)),  # dips 0.3 below
    )
    g.add_union_of_node(NA(u), NA(gr))
    cl = partition_tape(g.compile(k=2))
    assert cl is not None and len(cl) == 2
    sizes = sorted(len(c_[1]) for c_ in cl)
    assert sizes == [1, 2]  # resting alone; sunk merged with the ground


def test_dielectric_contact_merges():
    """Face-contact is only safe for opaque solids (the contact set is
    interior to the union, unreachable by rays). A DIELECTRIC resting on
    the ground lets refracted rays reach the coplanar contact face from
    inside — the operand must merge with the ground cluster. Regression:
    test_rotated_leaves_and_materials (glass cylinder cap coplanar with
    the plane) diverged 0.13 rmse from the global evaluation under the
    old always-separate tangency rule."""
    def build(mat):
        g = SceneGraph(max_node_count=16)
        gr = g.add_infinite_planar_partition_node(
            (0, 1, 0), Material.lambertian((0.5, 0.5, 0.5))
        )
        c = g.add_cylinder_node(0.5, 0.6, mat)  # cap at y=0 exactly
        far = g.add_sphere_node(0.5, Material.lambertian((0.6, 0.3, 0.3)))
        u = g.add_union_of_node(
            NA(c, offset=(0, 0.6, 0)), NA(far, offset=(4, 0.5, 0))
        )
        g.add_union_of_node(NA(u), NA(gr))
        return g.compile(k=2)

    # glass cylinder: merges with the ground -> {cyl+ground, sphere}
    cl = partition_tape(build(Material.dielectric(1.5)))
    assert cl is not None and sorted(len(c_[1]) for c_ in cl) == [1, 2]
    # opaque cylinder: contact set is unreachable -> three clusters
    cl = partition_tape(build(Material.lambertian((0.3, 0.3, 0.6))))
    assert cl is not None and sorted(len(c_[1]) for c_ in cl) == [1, 1, 1]


def test_many_objects_scene_fully_decomposes():
    tape = many_objects_scene(9).compile(k=4)
    cl = partition_tape(tape)
    assert cl is not None and len(cl) == 10  # 9 objects + ground
    all_leaves = sorted(sum((list(c_[1]) for c_ in cl), []))
    assert all_leaves == list(range(tape.n_leaves))


CAM = Camera.look_at((0, 7.0, 9.0), (0, 0.4, 0), vfov_degrees=45.0,
                     aspect_ratio=2.0)


def test_partitioned_kernel_matches_jnp_reference():
    """The clustered event evaluation against the GLOBAL jnp oracle on a
    9-object scene — exactness of the decomposition, not just
    self-consistency."""
    tape = many_objects_scene(9).compile(k=4)
    assert partition_tape(tape) is not None
    # 48x24 keeps interpret-mode wall time ~5x down vs 64x32 (this was
    # the slowest test in the suite at 544 s) without weakening the
    # oracle: exactness is per-ray, and the fuzz tests cover ray space
    ref, rrays = render_image(
        partial(tape_hit_adapter, tape), CAM, 48, 24, spp=2, max_bounces=3,
        seed=5,
    )
    img, krays = render_image_tape_pallas(
        tape, CAM, 48, 24, spp=2, max_bounces=3, seed=5, interpret=True,
        partition=True,
    )
    ref, img = np.asarray(ref), np.asarray(img)
    bad = (np.abs(img - ref).max(axis=-1) > 0.05).mean()
    assert bad <= 0.01, f"{bad:.3%} divergent"
    assert abs(int(krays) - int(rrays)) <= max(4, int(rrays) * 2e-3)


def test_partition_off_equivalence_small():
    """partition=False (global) and partition=True (clustered) agree on a
    tiny disjoint scene — tie-breaking aside, the same surfaces."""
    g = SceneGraph(max_node_count=16)
    a = g.add_sphere_node(0.6, Material.lambertian((0.7, 0.3, 0.3)))
    b = g.add_box_node((0.5, 0.5, 0.5), Material.metal((0.8, 0.8, 0.8), 0.1))
    s2 = g.add_sphere_node(0.5, Material.dielectric(1.5))
    o1 = g.add_difference_of_node(
        NA(a, offset=(-2, 0.6, -3)), NA(b, offset=(-1.6, 1.0, -2.7))
    )
    g.add_union_of_node(NA(o1), NA(s2, offset=(2, 0.5, -3)))
    tape = g.compile(k=4)
    assert partition_tape(tape) is not None
    cam = Camera.look_at((0, 1.5, 2.0), (0, 0.5, -3), vfov_degrees=50.0,
                         aspect_ratio=2.0)
    on, r_on = render_image_tape_pallas(
        tape, cam, 64, 32, spp=2, max_bounces=4, seed=3, interpret=True,
        partition=True,
    )
    off, r_off = render_image_tape_pallas(
        tape, cam, 64, 32, spp=2, max_bounces=4, seed=3, interpret=True,
        partition=False,
    )
    np.testing.assert_allclose(np.asarray(on), np.asarray(off), atol=1e-5)
    assert int(r_on) == int(r_off)


def test_partition_true_requires_decomposable_tape():
    with pytest.raises(ValueError, match="partition"):
        render_image_tape_pallas(
            config3_csg_scene().compile(k=2),
            Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0,
                           aspect_ratio=1.0),
            16, 16, spp=1, interpret=True, partition=True,
        )


def test_animated_tape_reclusters_per_frame():
    """VERDICT r3 #5: animated tapes get the cluster speedup. The renderer
    re-clusters per frame on a host-side CPU twin; an unchanged cluster
    tuple is a jit cache hit, a boundary crossing recompiles exactly once,
    and both regimes match the global jnp oracle."""
    from csgrenderer.app.renderers import PathTraceRenderer
    from csgrenderer.kernels.tape_kernel import _render_tape_packed
    from csgrenderer.utils.config import RenderConfig

    g = SceneGraph(max_node_count=8)
    a = g.add_sphere_node(0.5, Material.lambertian((0.7, 0.3, 0.3)))
    b = g.add_sphere_node(0.5, Material.metal((0.8, 0.8, 0.8), 0.2))
    g.add_union_of_node(NA(a, offset=(-2, 0, 0)), NA(b, offset=(2, 0, 0)))
    tape = g.compile(k=2)

    def animate(t, time_sec):
        # slides A from x=-2 (disjoint) to x=+1.5 (overlapping B) over t=0..1
        off = t.edge_off.at[0, 0].set(-2.0 + 3.5 * time_sec)
        return t.with_edges(t.edge_quat, off)

    cam = Camera.look_at((0, 1.0, 5.0), (0, 0, 0), vfov_degrees=50.0,
                         aspect_ratio=2.0)
    cfg = RenderConfig(width=32, height=16, spp=2, max_bounces=3, seed=7)
    r = PathTraceRenderer(tape, cam, cfg, animate=animate,
                          backend="triton", interpret=True)

    # clustering regimes on the CPU twin
    c0, c1, c2 = r._recluster(0.0), r._recluster(0.1), r._recluster(1.0)
    assert len(c0) == 2 and c0 == c1  # moved but same clustering -> equal
    assert c2 == ()  # overlapping: nothing splits -> global evaluation

    img0 = np.asarray(r.draw_frame(0.0))
    size_after_first = _render_tape_packed._cache_size()
    np.asarray(r.draw_frame(0.1))  # same tuple: no recompile
    assert _render_tape_packed._cache_size() == size_after_first
    img_crossed = np.asarray(r.draw_frame(1.0))  # boundary crossing
    assert _render_tape_packed._cache_size() == size_after_first + 1
    np.asarray(r.draw_frame(0.9))  # stays global: cache hit again
    assert _render_tape_packed._cache_size() == size_after_first + 1

    # both regimes match the jnp oracle (animate applied the same way)
    for t_sec, got in ((0.0, img0), (1.0, img_crossed)):
        anim = animate(tape, jnp.float32(t_sec))
        ref, _ = render_image(
            partial(tape_hit_adapter, anim), cam, 32, 16, spp=2,
            max_bounces=3, seed=7,
        )
        from csgrenderer.render import tonemap
        ref8 = np.asarray(tonemap.to_uint8(tonemap.tonemap(ref, gamma=2.0)))
        bad = (np.abs(got.astype(int) - ref8.astype(int)).max(axis=-1)
               > 12).mean()
        assert bad <= 0.02, f"t={t_sec}: {bad:.3%} divergent"
