"""Branch-free interval-list algebra for CSG boolean combination.

This is the batched replacement for recursive CSG traversal: a ray's
intersection with any CSG solid is a set of disjoint [t_enter, t_exit)
intervals. Every convex primitive contributes at most one interval
(render/intersect.py); boolean nodes combine interval lists.

Representation — fixed shapes only (XLA-friendly, SURVEY §7 hard part #1):
an *interval list* is a pair of arrays ``(t_in, t_out)`` of shape [..., K],
sorted ascending, disjoint, clipped to the domain [0, T_FAR]. Empty slots
hold (T_FAR, T_FAR). K is a static compile-time cap; combining lists that
would exceed K intervals drops the farthest ones (documented truncation).

Combination is event-based and fully vectorized:
1. merge + sort the 4K endpoints of both lists (plus a leading 0 event so a
   solid containing the ray origin yields an interval starting at 0);
2. evaluate "inside A" / "inside B" at each inter-event midpoint by counting
   (#enters <= m) > (#exits <= m) — O(K) comparisons per event, VPU-only;
3. apply the boolean op to the flags, mark events where the result flips,
   and compact flagged starts/ends into K output slots with a one-hot
   masked reduction (no scatter — works identically inside Pallas).

No data-dependent shapes, no sorting of structs, no recursion.
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp
import numpy as np
from jax import Array

from .intersect import T_FAR

# Real surfaces live well below this; boundaries at/above are "at infinity".
_SURFACE_CUTOFF = np.float32(5e8)


def empty_list(batch_shape: tuple, k: int) -> tuple[Array, Array]:
    t = jnp.full(batch_shape + (k,), T_FAR, jnp.float32)
    return t, t


def single_to_list(enter: Array, exit_: Array, k: int) -> tuple[Array, Array]:
    """One primitive interval (full-line t's) -> clipped K-slot list."""
    enter_c = jnp.clip(enter, 0.0, T_FAR)
    exit_c = jnp.clip(exit_, 0.0, T_FAR)
    valid = enter_c < exit_c
    t_in0 = jnp.where(valid, enter_c, T_FAR)
    t_out0 = jnp.where(valid, exit_c, T_FAR)
    pad = jnp.full(enter.shape + (k - 1,), T_FAR, jnp.float32)
    t_in = jnp.concatenate([t_in0[..., None], pad], axis=-1)
    t_out = jnp.concatenate([t_out0[..., None], pad], axis=-1)
    return t_in, t_out


def _inside_at(t_in: Array, t_out: Array, m: Array) -> Array:
    """inside(m) for each query point m [..., M] vs list [..., K] -> [..., M].

    Counting form: a point is inside iff more enters than exits lie at or
    before it. Works for touching/degenerate intervals without epsilons.
    """
    enters = jnp.sum(t_in[..., None, :] <= m[..., :, None], axis=-1)
    exits = jnp.sum(t_out[..., None, :] <= m[..., :, None], axis=-1)
    return enters > exits


def _compact(flags: Array, events: Array, k: int) -> Array:
    """Gather events where ``flags`` is set into the first K slots, in order.

    flags/events: [..., E]. Returns [..., K] filled with T_FAR past the end.
    One-hot masked reduction instead of scatter: slot j of the output is
    sum over events of (event, where its running rank == j).
    """
    rank = jnp.cumsum(flags.astype(jnp.int32), axis=-1) - 1  # [..., E]
    slots = jnp.arange(k, dtype=jnp.int32)
    onehot = flags[..., :, None] & (rank[..., :, None] == slots)  # [..., E, K]
    vals = jnp.sum(jnp.where(onehot, events[..., :, None], 0.0), axis=-2)
    filled = jnp.any(onehot, axis=-2)
    return jnp.where(filled, vals, T_FAR)


def combine(
    a: tuple[Array, Array],
    b: tuple[Array, Array],
    op: str,
    k: int | None = None,
    with_dropped: bool = False,
):
    """Boolean-combine two interval lists. op in {"union","intersect","diff"}.

    ``with_dropped=True`` also returns the per-ray count of result intervals
    that did NOT fit the K slots (silent-truncation detector: deep CSG along
    a single ray can produce more than K disjoint spans, and the compaction
    keeps only the K nearest — see the round-1 verdict's "correctness
    cliff"). Zero means the result is exact.
    """
    a_in, a_out = a
    b_in, b_out = b
    if k is None:
        k = a_in.shape[-1]

    zero = jnp.zeros(a_in.shape[:-1] + (1,), a_in.dtype)
    events = jnp.concatenate([zero, a_in, a_out, b_in, b_out], axis=-1)
    events = jnp.sort(events, axis=-1)  # [..., 4K+1]

    # Segment sample points: midpoint of [e_j, e_{j+1}); past-the-end point
    # for the last segment (everything is clipped to T_FAR, so it's outside).
    nxt = jnp.concatenate(
        [events[..., 1:], events[..., -1:] + 1.0], axis=-1
    )
    mids = 0.5 * (events + nxt)

    in_a = _inside_at(a_in, a_out, mids)
    in_b = _inside_at(b_in, b_out, mids)
    if op == "union":
        inside = in_a | in_b
    elif op == "intersect":
        inside = in_a & in_b
    elif op == "diff":
        inside = in_a & ~in_b
    else:
        raise ValueError(f"unknown op {op!r}")

    prev = jnp.concatenate(
        [jnp.zeros_like(inside[..., :1]), inside[..., :-1]], axis=-1
    )
    starts = inside & ~prev
    ends = ~inside & prev

    t_in = _compact(starts, events, k)
    t_out = _compact(ends, events, k)
    # Every start inside the domain has a matching end (lists are clipped),
    # so slot-wise pairing is exact.
    if with_dropped:
        # intervals whose start is a REAL surface (below the cutoff) count
        # toward capacity; starts at/after T_FAR are the empty-slot padding
        real = starts & (events < _SURFACE_CUTOFF)
        n_spans = jnp.sum(real.astype(jnp.int32), axis=-1)
        dropped = jnp.maximum(n_spans - k, 0)
        return t_in, t_out, dropped
    return t_in, t_out


union = partial(combine, op="union")
intersect = partial(combine, op="intersect")
difference = partial(combine, op="diff")


def first_surface(
    t_in: Array, t_out: Array, eps: float = 1e-3
) -> tuple[Array, Array, Array]:
    """Nearest real surface crossing with t > eps.

    Returns (t_hit [...], entering [...] bool, hit [...] bool). Boundaries at
    t <= eps (e.g. clipped-to-0 starts when the ray origin is inside the
    solid) and boundaries at infinity are not surfaces.
    """
    def best(ts):
        ok = (ts > eps) & (ts < _SURFACE_CUTOFF)
        return jnp.min(jnp.where(ok, ts, T_FAR), axis=-1)

    t_enter = best(t_in)
    t_exit = best(t_out)
    t_hit = jnp.minimum(t_enter, t_exit)
    entering = t_enter <= t_exit
    return t_hit, entering, t_hit < _SURFACE_CUTOFF


def inside_at_origin(t_in: Array, t_out: Array, eps: float = 1e-3) -> Array:
    """Whether the ray origin (t ~ 0) is inside the solid."""
    return _inside_at(t_in, t_out, jnp.full(t_in.shape[:-1] + (1,), eps))[..., 0]
