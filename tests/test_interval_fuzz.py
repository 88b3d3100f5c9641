"""Randomized interval-algebra verification against a set-membership oracle.

The vectorized event-sort combiner (render/interval.py) is the foundation of
all CSG correctness; this fuzzes it against brute-force point-membership:
for random interval lists A, B and many probe points t, membership in
combine(A, B, op) must equal op(t in A, t in B).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from csgrenderer.render import interval
from csgrenderer.render.intersect import T_FAR

# K chosen so no test case can exceed the cap (union of 4+4 <= 8;
# nested test uses max_n=2 so (A u B) \ C <= 6) - truncation is tested
# separately in test_interval.py
K = 8


def random_list(rng, max_n=4, domain=(0.0, 100.0)):
    """Sorted disjoint intervals inside the domain."""
    n = rng.integers(0, max_n + 1)
    points = np.sort(rng.uniform(*domain, size=2 * n))
    return [(points[2 * i], points[2 * i + 1]) for i in range(n)]


def to_arrays(lst):
    t_in = [a for a, _ in lst] + [float(T_FAR)] * (K - len(lst))
    t_out = [b for _, b in lst] + [float(T_FAR)] * (K - len(lst))
    return jnp.array([t_in], jnp.float32), jnp.array([t_out], jnp.float32)


def member(lst, t):
    return any(a <= t < b for a, b in lst)


@pytest.mark.parametrize("op,pyop", [
    ("union", lambda a, b: a or b),
    ("intersect", lambda a, b: a and b),
    ("diff", lambda a, b: a and not b),
])
def test_combine_matches_membership_oracle(op, pyop):
    rng = np.random.default_rng(hash(op) % 2**32)
    for trial in range(60):
        A = random_list(rng)
        B = random_list(rng)
        r_in, r_out = interval.combine(to_arrays(A), to_arrays(B), op=op, k=K)
        r_in = np.asarray(r_in)[0]
        r_out = np.asarray(r_out)[0]

        # probe at random points + near every endpoint (where bugs live)
        probes = list(rng.uniform(0.0, 100.0, size=40))
        for a, b in A + B:
            probes += [a - 1e-3, a + 1e-3, b - 1e-3, b + 1e-3]
        for t in probes:
            if t < 0:
                continue
            want = pyop(member(A, t), member(B, t))
            got = any(
                i <= t < o for i, o in zip(r_in, r_out) if i < float(T_FAR) / 2
            )
            assert got == want, (
                f"op={op} t={t} A={A} B={B} -> {list(zip(r_in, r_out))}"
            )


def test_combine_result_sorted_and_disjoint():
    rng = np.random.default_rng(7)
    for _ in range(40):
        A, B = random_list(rng), random_list(rng)
        r_in, r_out = interval.union(to_arrays(A), to_arrays(B), k=K)
        r_in = np.asarray(r_in)[0]
        r_out = np.asarray(r_out)[0]
        real = [(i, o) for i, o in zip(r_in, r_out) if i < float(T_FAR) / 2]
        for (i1, o1), (i2, o2) in zip(real, real[1:]):
            assert i1 <= o1 <= i2 <= o2  # ordered and non-overlapping


def test_nested_combines_match_oracle():
    # (A u B) \ C across random triples — the config-3 shape
    rng = np.random.default_rng(11)
    for _ in range(30):
        A, B, C = (random_list(rng, max_n=2) for _ in range(3))
        u = interval.union(to_arrays(A), to_arrays(B), k=K)
        r_in, r_out = interval.difference(u, to_arrays(C), k=K)
        r_in = np.asarray(r_in)[0]
        r_out = np.asarray(r_out)[0]
        for t in rng.uniform(0.0, 100.0, size=50):
            want = (member(A, t) or member(B, t)) and not member(C, t)
            got = any(
                i <= t < o for i, o in zip(r_in, r_out) if i < float(T_FAR) / 2
            )
            assert got == want
