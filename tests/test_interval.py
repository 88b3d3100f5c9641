"""Unit tests for the CSG interval-list algebra."""

import jax.numpy as jnp
import numpy as np

from csgrenderer.render import interval
from csgrenderer.render.intersect import T_FAR

K = 4


def mk(intervals, k=K):
    """Build a [1, k] interval list from a python list of (a, b)."""
    t_in = [a for a, _ in intervals] + [float(T_FAR)] * (k - len(intervals))
    t_out = [b for _, b in intervals] + [float(T_FAR)] * (k - len(intervals))
    return (
        jnp.array([t_in], jnp.float32),
        jnp.array([t_out], jnp.float32),
    )


def extract(lst):
    t_in, t_out = lst
    out = []
    for a, b in zip(np.asarray(t_in)[0], np.asarray(t_out)[0]):
        if a < float(T_FAR) * 0.5:
            out.append((float(a), float(b)))
    return out


def assert_intervals(got, expected, atol=1e-4):
    assert len(got) == len(expected), (got, expected)
    for (ga, gb), (ea, eb) in zip(got, expected):
        np.testing.assert_allclose([ga, gb], [ea, eb], atol=atol)


def test_union_disjoint():
    r = interval.union(mk([(1, 2)]), mk([(3, 4)]))
    assert_intervals(extract(r), [(1, 2), (3, 4)])


def test_union_overlapping_coalesces():
    r = interval.union(mk([(1, 3)]), mk([(2, 5)]))
    assert_intervals(extract(r), [(1, 5)])


def test_union_touching_coalesces():
    r = interval.union(mk([(1, 2)]), mk([(2, 3)]))
    assert_intervals(extract(r), [(1, 3)])


def test_intersection_basic():
    r = interval.intersect(mk([(1, 4)]), mk([(2, 6)]))
    assert_intervals(extract(r), [(2, 4)])


def test_intersection_empty():
    r = interval.intersect(mk([(1, 2)]), mk([(3, 4)]))
    assert_intervals(extract(r), [])


def test_difference_splits():
    # (1,6) minus (2,3) -> (1,2) u (3,6)
    r = interval.difference(mk([(1, 6)]), mk([(2, 3)]))
    assert_intervals(extract(r), [(1, 2), (3, 6)])


def test_difference_total():
    r = interval.difference(mk([(2, 3)]), mk([(1, 6)]))
    assert_intervals(extract(r), [])


def test_difference_of_empty_b():
    r = interval.difference(mk([(2, 3)]), mk([]))
    assert_intervals(extract(r), [(2, 3)])


def test_multi_interval_union_sorted():
    r = interval.union(mk([(5, 6), (T_FAR, T_FAR)][:1]), mk([(1, 2)]))
    assert_intervals(extract(r), [(1, 2), (5, 6)])


def test_combine_two_multi_lists():
    a = mk([(0.5, 1.5), (4, 5)])
    b = mk([(1, 4.5)])
    assert_intervals(extract(interval.union(a, b)), [(0.5, 5)])
    assert_intervals(extract(interval.intersect(a, b)), [(1, 1.5), (4, 4.5)])
    assert_intervals(extract(interval.difference(a, b)), [(0.5, 1), (4.5, 5)])


def test_truncation_keeps_nearest():
    # 3 result intervals with K=2 keeps the two nearest
    a = mk([(1, 2), (3, 4)], k=2)
    b = mk([(5, 6), (T_FAR, T_FAR)][:1], k=2)
    r = interval.union(a, b, k=2)
    assert_intervals(extract(r), [(1, 2), (3, 4)])


def test_first_surface_entering():
    t, entering, hit = interval.first_surface(*mk([(2, 5)]))
    assert bool(hit[0]) and bool(entering[0])
    np.testing.assert_allclose(t[0], 2.0)


def test_first_surface_exiting_when_origin_inside():
    # interval clipped to start at 0 (origin inside): first *surface* is the exit
    t, entering, hit = interval.first_surface(*mk([(0.0, 5)]))
    assert bool(hit[0]) and not bool(entering[0])
    np.testing.assert_allclose(t[0], 5.0)


def test_first_surface_miss():
    t, entering, hit = interval.first_surface(*mk([]))
    assert not bool(hit[0])


def test_inside_at_origin():
    assert bool(interval.inside_at_origin(*mk([(0.0, 5)]))[0])
    assert not bool(interval.inside_at_origin(*mk([(2, 5)]))[0])


def test_batched_shapes():
    a_in = jnp.broadcast_to(jnp.array([1.0, T_FAR, T_FAR, T_FAR]), (7, 3, K))
    a_out = jnp.broadcast_to(jnp.array([2.0, T_FAR, T_FAR, T_FAR]), (7, 3, K))
    b_in = jnp.broadcast_to(jnp.array([1.5, T_FAR, T_FAR, T_FAR]), (7, 3, K))
    b_out = jnp.broadcast_to(jnp.array([4.0, T_FAR, T_FAR, T_FAR]), (7, 3, K))
    t_in, t_out = interval.union((a_in, a_out), (b_in, b_out))
    assert t_in.shape == (7, 3, K)
    np.testing.assert_allclose(t_in[..., 0], 1.0)
    np.testing.assert_allclose(t_out[..., 0], 4.0)
