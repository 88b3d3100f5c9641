"""Ray-primitive intersection, in two forms.

1. **Nearest-hit over a sphere soup** (`spheres_nearest_hit`): the plain
   reference for RTIOW-style scenes, batched as [N, S] elementwise math
   over rays x spheres followed by a min/argmin reduce. This replaces the
   reference's one-fragment-one-sphere loop (``ubershader1.frag:84-95``).

2. **Interval form** (`*_interval`): each convex primitive maps a ray to a
   single (t_enter, t_exit) slab of "inside" parameter values along the full
   line; these feed the CSG interval combiner (render/interval.py). Empty is
   encoded as t_enter > t_exit. All functions operate in the primitive's
   LOCAL frame — the tape evaluator transforms rays world->local first.

`hit_sphere_ref` reproduces the reference shader's exact arithmetic
(full-b quadratic, returns -1 on miss, near root unconditionally) for the
bit-comparable milestone-01 path (``ubershader1.frag:84-95``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import Array

INF = np.float32(np.inf)
T_FAR = np.float32(1e9)  # finite stand-in for +inf inside interval algebra
T_NEG = np.float32(-1e9)


# ---------------------------------------------------------------------------
# Reference-compatible single-sphere test (milestone-01 semantics)
# ---------------------------------------------------------------------------

def hit_sphere_ref(center: Array, radius, o: Array, d: Array) -> Array:
    """Exact reference semantics (frag:84-95): near root or -1.0.

    Note the reference does NOT normalize d (frag:74-82) and does not clip
    t > 0 here — callers test ``t > 0`` themselves (frag:106).
    """
    oc = o - center
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(oc * d, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - jnp.float32(radius) * jnp.float32(radius)
    disc = b * b - 4.0 * a * c
    t = (-b - jnp.sqrt(jnp.maximum(disc, 0.0))) / (2.0 * a)
    return jnp.where(disc < 0.0, jnp.float32(-1.0), t)


# ---------------------------------------------------------------------------
# Sphere-soup nearest hit (the RTIOW hot path)
# ---------------------------------------------------------------------------

EXPANDED_FORM_RATIO = 0.5


def expanded_form(centers, radii, xp=jnp):
    """Per sphere: True where the quadratic is formed from the sphere's own
    coordinates (o.o - 2 c.o + (|c|^2 - r^2)) rather than from o - c.

    In f32 the constant term |o - c|^2 - r^2 cancels badly for a sphere
    whose radius is comparable to its distance from the world origin (the
    RTIOW ground: r = 1000 at 1000), and the expanded form, with |c|^2 - r^2
    formed once, keeps it. For a small sphere far from the origin it is
    the other way round. Each sphere takes the form that suits it; the
    kernels make the same choice, so reference and kernels round alike.
    ``xp``: numpy for host-side packing, jax.numpy inside traced code."""
    c2 = xp.sum(centers * centers, axis=-1)
    return xp.abs(radii) > EXPANDED_FORM_RATIO * xp.sqrt(c2)


def spheres_nearest_hit(
    o: Array,
    d: Array,
    centers: Array,
    radii: Array,
    t_min: float,
    t_max: float = float(T_FAR),
):
    """Nearest hit of rays [N,3] against spheres [S,3]/[S].

    Returns (t [N], idx [N] int32, hit [N] bool). Everything is [N, S]
    elementwise math that XLA fuses into the final min/argmin reduction;
    ``expanded_form`` picks each sphere's quadratic.
    """
    a = jnp.sum(d * d, axis=-1, keepdims=True)  # [N, 1]
    r2 = (radii * radii)[None, :]
    oc = o[:, None, :] - centers[None, :, :]  # [N, S, 3]
    half_b_diff = jnp.sum(oc * d[:, None, :], axis=-1)
    c_term_diff = jnp.sum(oc * oc, axis=-1) - r2
    c_dot_d = jnp.sum(centers[None, :, :] * d[:, None, :], axis=-1)
    c_dot_o = jnp.sum(centers[None, :, :] * o[:, None, :], axis=-1)
    ccr2 = jnp.sum(centers * centers, axis=-1) - radii * radii  # [S]
    half_b_exp = jnp.sum(o * d, axis=-1, keepdims=True) - c_dot_d
    c_term_exp = jnp.sum(o * o, axis=-1, keepdims=True) - 2.0 * c_dot_o + ccr2
    expanded = expanded_form(centers, radii)[None, :]
    half_b = jnp.where(expanded, half_b_exp, half_b_diff)
    c_term = jnp.where(expanded, c_term_exp, c_term_diff)

    disc = half_b * half_b - a * c_term
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    t0 = (-half_b - sqrt_disc) * inv_a
    t1 = (-half_b + sqrt_disc) * inv_a
    t = jnp.where(t0 > t_min, t0, t1)
    valid = (disc > 0.0) & (t > t_min) & (t < t_max)
    t = jnp.where(valid, t, T_FAR)

    idx = jnp.argmin(t, axis=-1).astype(jnp.int32)  # [N]
    t_near = jnp.min(t, axis=-1)  # [N]
    return t_near, idx, t_near < T_FAR


# ---------------------------------------------------------------------------
# Interval (slab) form, local frame — feeds CSG boolean combination
# ---------------------------------------------------------------------------

def sphere_interval(o: Array, d: Array, radius: Array):
    """(enter, exit) of |p| <= r along o + t d; enter > exit when missed."""
    a = jnp.sum(d * d, axis=-1)
    half_b = jnp.sum(o * d, axis=-1)
    c = jnp.sum(o * o, axis=-1) - radius * radius
    disc = half_b * half_b - a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    enter = jnp.where(ok, (-half_b - sq) * inv_a, T_FAR)
    exit_ = jnp.where(ok, (-half_b + sq) * inv_a, T_NEG)
    return enter, exit_


def halfspace_interval(o: Array, d: Array, normal: Array):
    """Solid = {p : p . n <= 0} (outward-facing normal, plane through origin).

    Matches the reference's ``infinite planar partition`` node
    (``renderer.h:29``, ``renderer.c:2239-2244``).
    """
    dn = jnp.sum(d * normal, axis=-1)
    on = jnp.sum(o * normal, axis=-1)
    t0 = -on / dn  # +-inf when dn == 0 and on != 0; nan when both 0
    entering = dn < 0.0
    parallel = dn == 0.0
    inside_all = parallel & (on <= 0.0)
    enter = jnp.where(entering, t0, T_NEG)
    exit_ = jnp.where(entering, T_FAR, t0)
    enter = jnp.where(parallel, jnp.where(inside_all, T_NEG, T_FAR), enter)
    exit_ = jnp.where(parallel, jnp.where(inside_all, T_FAR, T_NEG), exit_)
    return enter, exit_


def box_interval(o: Array, d: Array, half_extents: Array):
    """Axis-aligned box |p_i| <= he_i via the slab method, branch-free.

    Degenerate axes (d_i == 0) resolve to (−BIG, +BIG) when the origin is
    inside that slab and an empty interval otherwise, avoiding inf*0 NaNs.
    """
    safe_d = jnp.where(d == 0.0, jnp.float32(1.0), d)
    inv_d = 1.0 / safe_d
    ta = (-half_extents - o) * inv_d
    tb = (half_extents - o) * inv_d
    t_lo = jnp.minimum(ta, tb)
    t_hi = jnp.maximum(ta, tb)
    inside_slab = jnp.abs(o) <= half_extents
    t_lo = jnp.where(d == 0.0, jnp.where(inside_slab, T_NEG, T_FAR), t_lo)
    t_hi = jnp.where(d == 0.0, jnp.where(inside_slab, T_FAR, T_NEG), t_hi)
    enter = jnp.max(t_lo, axis=-1)
    exit_ = jnp.min(t_hi, axis=-1)
    return enter, exit_


def cylinder_interval(o: Array, d: Array, radius: Array, half_height: Array):
    """Capped cylinder around local +y: x^2+z^2 <= r^2, |y| <= h."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    a = dx * dx + dz * dz
    half_b = ox * dx + oz * dz
    c = ox * ox + oz * oz - radius * radius
    disc = half_b * half_b - a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    degenerate = a == 0.0  # ray parallel to axis
    inv_a = 1.0 / jnp.where(degenerate, jnp.float32(1.0), a)
    side_enter = jnp.where(ok, (-half_b - sq) * inv_a, T_FAR)
    side_exit = jnp.where(ok, (-half_b + sq) * inv_a, T_NEG)
    inside_tube = c <= 0.0
    side_enter = jnp.where(
        degenerate, jnp.where(inside_tube, T_NEG, T_FAR), side_enter
    )
    side_exit = jnp.where(
        degenerate, jnp.where(inside_tube, T_FAR, T_NEG), side_exit
    )
    # y slab
    safe_dy = jnp.where(dy == 0.0, jnp.float32(1.0), dy)
    ty_a = (-half_height - oy) / safe_dy
    ty_b = (half_height - oy) / safe_dy
    cap_lo = jnp.minimum(ty_a, ty_b)
    cap_hi = jnp.maximum(ty_a, ty_b)
    inside_y = jnp.abs(oy) <= half_height
    cap_lo = jnp.where(dy == 0.0, jnp.where(inside_y, T_NEG, T_FAR), cap_lo)
    cap_hi = jnp.where(dy == 0.0, jnp.where(inside_y, T_FAR, T_NEG), cap_hi)
    enter = jnp.maximum(side_enter, cap_lo)
    exit_ = jnp.minimum(side_exit, cap_hi)
    return enter, exit_


# ---------------------------------------------------------------------------
# Local-frame outward normals (evaluated at hit point p, local coords)
# ---------------------------------------------------------------------------

def sphere_normal(p: Array, radius: Array) -> Array:
    return p / jnp.maximum(radius, jnp.float32(1e-12))[..., None]


def halfspace_normal(p: Array, normal: Array) -> Array:
    return jnp.broadcast_to(normal, p.shape)


def box_normal(p: Array, half_extents: Array) -> Array:
    """Outward normal = axis where |p|/he is largest, signed by p."""
    q = jnp.abs(p) / jnp.maximum(half_extents, jnp.float32(1e-12))
    axis = jnp.argmax(q, axis=-1)
    n = jax_one_hot3(axis) * jnp.sign(p)
    return n


def cylinder_normal(p: Array, radius: Array, half_height: Array) -> Array:
    """Side normal (x,0,z)/r vs cap normal (0,±1,0), by which face is nearer."""
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    side_gap = jnp.abs(jnp.sqrt(px * px + pz * pz) - radius)
    cap_gap = jnp.abs(jnp.abs(py) - half_height)
    side_n = jnp.stack(
        [px, jnp.zeros_like(py), pz], axis=-1
    ) / jnp.maximum(radius, jnp.float32(1e-12))[..., None]
    cap_n = jnp.stack(
        [jnp.zeros_like(px), jnp.sign(py), jnp.zeros_like(pz)], axis=-1
    )
    return jnp.where((side_gap < cap_gap)[..., None], side_n, cap_n)


def jax_one_hot3(axis: Array) -> Array:
    """[...,] int -> [...,3] one-hot, without jax.nn import overhead."""
    eye = jnp.eye(3, dtype=jnp.float32)
    return eye[axis]
