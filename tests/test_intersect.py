"""Unit tests for ray-primitive intersection (both forms)."""

import jax.numpy as jnp
import numpy as np

from csgrenderer.render import intersect
from csgrenderer.render.intersect import T_FAR


def test_hit_sphere_ref_head_on():
    # Reference semantics (frag:84-95): unnormalized d allowed, near root.
    o = jnp.array([0.0, 0.0, 0.0])
    d = jnp.array([0.0, 0.0, -2.0])  # unnormalized
    t = intersect.hit_sphere_ref(jnp.array([0.0, 0.0, -11.0]), 0.5, o, d)
    # hit at z=-10.5 -> t = 10.5 / 2
    np.testing.assert_allclose(t, 5.25, atol=1e-5)


def test_hit_sphere_ref_miss_returns_minus_one():
    o = jnp.zeros(3)
    d = jnp.array([0.0, 1.0, 0.0])
    t = intersect.hit_sphere_ref(jnp.array([0.0, 0.0, -11.0]), 0.5, o, d)
    np.testing.assert_allclose(t, -1.0)


def test_spheres_nearest_hit_picks_nearest():
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    centers = jnp.array([[0.0, 0.0, -10.0], [0.0, 0.0, -5.0], [3.0, 0.0, -5.0]])
    radii = jnp.array([1.0, 1.0, 1.0])
    t, idx, hit = intersect.spheres_nearest_hit(o, d, centers, radii, t_min=1e-3)
    assert bool(hit[0])
    assert int(idx[0]) == 1
    np.testing.assert_allclose(t[0], 4.0, atol=1e-5)


def test_spheres_nearest_hit_inside_sphere_uses_far_root():
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    centers = jnp.array([[0.0, 0.0, 0.0]])
    radii = jnp.array([2.0])
    t, idx, hit = intersect.spheres_nearest_hit(o, d, centers, radii, t_min=1e-3)
    assert bool(hit[0])
    np.testing.assert_allclose(t[0], 2.0, atol=1e-5)


def test_spheres_nearest_hit_t_min_skips_self():
    # origin exactly on a sphere surface: near root ~0 must be skipped
    o = jnp.array([[0.0, 0.0, 1.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    centers = jnp.array([[0.0, 0.0, 0.0]])
    radii = jnp.array([1.0])
    t, idx, hit = intersect.spheres_nearest_hit(o, d, centers, radii, t_min=1e-3)
    assert bool(hit[0])
    np.testing.assert_allclose(t[0], 2.0, atol=1e-4)


def test_sphere_interval_through_center():
    o = jnp.array([0.0, 0.0, -5.0])
    d = jnp.array([0.0, 0.0, 1.0])
    enter, exit_ = intersect.sphere_interval(o, d, jnp.float32(1.0))
    np.testing.assert_allclose([enter, exit_], [4.0, 6.0], atol=1e-5)


def test_sphere_interval_miss():
    o = jnp.array([0.0, 5.0, -5.0])
    d = jnp.array([0.0, 0.0, 1.0])
    enter, exit_ = intersect.sphere_interval(o, d, jnp.float32(1.0))
    assert float(enter) > float(exit_)


def test_halfspace_interval_entering():
    # solid is p.n <= 0; normal +y, ray falling from above
    o = jnp.array([0.0, 2.0, 0.0])
    d = jnp.array([0.0, -1.0, 0.0])
    enter, exit_ = intersect.halfspace_interval(o, d, jnp.array([0.0, 1.0, 0.0]))
    np.testing.assert_allclose(enter, 2.0, atol=1e-6)
    assert float(exit_) >= float(T_FAR)


def test_halfspace_interval_exiting():
    o = jnp.array([0.0, -2.0, 0.0])
    d = jnp.array([0.0, 1.0, 0.0])
    enter, exit_ = intersect.halfspace_interval(o, d, jnp.array([0.0, 1.0, 0.0]))
    assert float(enter) <= -float(T_FAR) * 0.9
    np.testing.assert_allclose(exit_, 2.0, atol=1e-6)


def test_halfspace_parallel_inside_and_outside():
    d = jnp.array([1.0, 0.0, 0.0])
    n = jnp.array([0.0, 1.0, 0.0])
    e_in, x_in = intersect.halfspace_interval(jnp.array([0.0, -1.0, 0.0]), d, n)
    assert float(e_in) < float(x_in)  # fully inside
    e_out, x_out = intersect.halfspace_interval(jnp.array([0.0, 1.0, 0.0]), d, n)
    assert float(e_out) > float(x_out)  # empty


def test_box_interval_axis_ray():
    o = jnp.array([0.0, 0.0, -5.0])
    d = jnp.array([0.0, 0.0, 1.0])
    enter, exit_ = intersect.box_interval(o, d, jnp.array([1.0, 2.0, 3.0]))
    np.testing.assert_allclose([enter, exit_], [2.0, 8.0], atol=1e-5)


def test_box_interval_parallel_outside_misses():
    o = jnp.array([0.0, 5.0, -5.0])
    d = jnp.array([0.0, 0.0, 1.0])
    enter, exit_ = intersect.box_interval(o, d, jnp.array([1.0, 1.0, 1.0]))
    assert float(enter) > float(exit_)


def test_box_interval_parallel_inside():
    o = jnp.array([0.0, 0.5, -5.0])
    d = jnp.array([0.0, 0.0, 1.0])
    enter, exit_ = intersect.box_interval(o, d, jnp.array([1.0, 1.0, 1.0]))
    np.testing.assert_allclose([enter, exit_], [4.0, 6.0], atol=1e-5)


def test_cylinder_interval_side_hit():
    o = jnp.array([0.0, 0.0, -5.0])
    d = jnp.array([0.0, 0.0, 1.0])
    enter, exit_ = intersect.cylinder_interval(
        o, d, jnp.float32(0.5), jnp.float32(1.5)
    )
    np.testing.assert_allclose([enter, exit_], [4.5, 5.5], atol=1e-5)


def test_cylinder_interval_cap_clips():
    # ray along the axis: caps bound the interval
    o = jnp.array([0.0, -5.0, 0.0])
    d = jnp.array([0.0, 1.0, 0.0])
    enter, exit_ = intersect.cylinder_interval(
        o, d, jnp.float32(0.5), jnp.float32(1.5)
    )
    np.testing.assert_allclose([enter, exit_], [3.5, 6.5], atol=1e-5)


def test_cylinder_interval_parallel_outside():
    o = jnp.array([2.0, -5.0, 0.0])
    d = jnp.array([0.0, 1.0, 0.0])
    enter, exit_ = intersect.cylinder_interval(
        o, d, jnp.float32(0.5), jnp.float32(1.5)
    )
    assert float(enter) > float(exit_)


def test_normals():
    n = intersect.sphere_normal(jnp.array([0.0, 2.0, 0.0]), jnp.float32(2.0))
    np.testing.assert_allclose(n, [0.0, 1.0, 0.0], atol=1e-6)
    n = intersect.box_normal(jnp.array([0.3, -0.999, 0.2]), jnp.array([1.0, 1.0, 1.0]))
    np.testing.assert_allclose(n, [0.0, -1.0, 0.0], atol=1e-6)
    n = intersect.cylinder_normal(
        jnp.array([0.5, 0.3, 0.0]), jnp.float32(0.5), jnp.float32(1.5)
    )
    np.testing.assert_allclose(n, [1.0, 0.0, 0.0], atol=1e-6)
    n = intersect.cylinder_normal(
        jnp.array([0.1, 1.5, 0.0]), jnp.float32(0.5), jnp.float32(1.5)
    )
    np.testing.assert_allclose(n, [0.0, 1.0, 0.0], atol=1e-6)
