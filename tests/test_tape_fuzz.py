"""Randomized CSG-tree fuzzing: tape evaluator vs a point-membership oracle.

Builds random trees (random primitive leaves with random rigid transforms,
random boolean ops), evaluates the compiled tape's interval lists along
random rays, and cross-checks against direct solid membership evaluated at
sample points: p in combine(...) must equal the boolean formula applied to
per-primitive membership. This exercises the full chain: transform
composition (quaternion edges), primitive interval math, and the event
combiner — independent of the hand-written expected values in
test_tape_eval.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from csgrenderer.math import quaternion as quat
from csgrenderer.render.tape_eval import eval_tape_intervals
from csgrenderer.scene import NodeArgument, NodeType, SceneGraph

K = 8


def random_tree(rng, n_leaves=4):
    """Build a random graph; returns (graph, membership_fn)."""
    g = SceneGraph(max_node_count=64)

    def leaf():
        kind = rng.integers(0, 4)
        if kind == 0:
            r = float(rng.uniform(0.3, 1.5))
            node = g.add_sphere_node(r)
            member = lambda p, r=r: float(np.dot(p, p)) <= r * r
        elif kind == 1:
            n = rng.normal(size=3)
            n = n / np.linalg.norm(n)
            node = g.add_infinite_planar_partition_node(tuple(n))
            member = lambda p, n=n: float(np.dot(p, n)) <= 0.0
        elif kind == 2:
            he = rng.uniform(0.3, 1.2, size=3)
            node = g.add_box_node(tuple(he))
            member = lambda p, he=he: bool(np.all(np.abs(p) <= he))
        else:
            r = float(rng.uniform(0.3, 1.0))
            h = float(rng.uniform(0.3, 1.5))
            node = g.add_cylinder_node(r, h)
            member = (
                lambda p, r=r, h=h:
                p[0] ** 2 + p[2] ** 2 <= r * r and abs(p[1]) <= h
            )
        return node, member

    def rand_edge(node):
        axis = rng.normal(size=3)
        q = np.asarray(quat.from_axis_angle(
            jnp.asarray(axis, jnp.float32), float(rng.uniform(0, 2 * np.pi))
        ))
        off = rng.uniform(-1.5, 1.5, size=3)
        return NodeArgument(node, orientation=tuple(q), offset=tuple(off)), q, off

    def edge_member(member, q, off):
        # p_parent = R(q) p_child + off  =>  p_child = R(q)^-1 (p_parent - off)
        qi = np.array([q[0], -q[1], -q[2], -q[3]])

        def m(p, member=member, qi=qi, off=off):
            local = np.asarray(
                quat.rotate(jnp.asarray(qi, jnp.float32),
                            jnp.asarray(p - off, jnp.float32))
            )
            return member(local)

        return m

    nodes = [leaf() for _ in range(n_leaves)]
    while len(nodes) > 1:
        (na, ma), (nb, mb) = nodes.pop(), nodes.pop()
        arg_a, qa, offa = rand_edge(na)
        arg_b, qb, offb = rand_edge(nb)
        ma2 = edge_member(ma, qa, offa)
        mb2 = edge_member(mb, qb, offb)
        op = rng.integers(0, 3)
        if op == 0:
            node = g.add_union_of_node(arg_a, arg_b)
            m = lambda p, A=ma2, B=mb2: A(p) or B(p)
        elif op == 1:
            node = g.add_intersection_of_node(arg_a, arg_b)
            m = lambda p, A=ma2, B=mb2: A(p) and B(p)
        else:
            node = g.add_difference_of_node(arg_a, arg_b)
            m = lambda p, A=ma2, B=mb2: A(p) and not B(p)
        nodes.append((node, m))
    return g, nodes[0][1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_tree_membership(seed):
    rng = np.random.default_rng(seed)
    g, member = random_tree(rng, n_leaves=3)
    tape = g.compile(k=K)

    n_rays = 16
    o = rng.uniform(-4, 4, size=(n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    t_in, t_out = eval_tape_intervals(tape, jnp.asarray(o), jnp.asarray(d))
    t_in = np.asarray(t_in)
    t_out = np.asarray(t_out)

    for i in range(n_rays):
        for t in rng.uniform(0.05, 8.0, size=12):
            p = o[i] + t * d[i]
            want = member(p.astype(np.float64))
            got = any(
                a <= t < b
                for a, b in zip(t_in[i], t_out[i])
                if a < 1e8
            )
            # skip points within float tolerance of a boundary (f32 tape vs
            # f64 oracle legitimately disagree exactly on surfaces)
            dist = min(
                (abs(t - a) for a, b in zip(t_in[i], t_out[i]) if a < 1e8),
                default=1.0,
            )
            dist = min(
                dist,
                min((abs(t - b) for a, b in zip(t_in[i], t_out[i]) if a < 1e8),
                    default=1.0),
            )
            if dist < 1e-3:
                continue
            assert got == want, (
                f"seed={seed} ray={i} t={t} p={p} got={got} want={want}\n"
                f"intervals={[(a, b) for a, b in zip(t_in[i], t_out[i]) if a < 1e8]}"
            )
