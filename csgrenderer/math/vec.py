"""Vector math over trailing-dimension-3 jnp arrays.

The batched equivalent of the reference's C math library
(``src/wololo/wmath.decl.h:20-28``, ``wmath.impl.h:11-60``): instead of a
scalar ``Wo_Vec3`` struct, every op broadcasts over arbitrary leading batch
dimensions of ``[..., 3]`` arrays so the whole pixel grid is one vectorized
call.

Note: the reference's ``wo_vec3_normalized`` divides by length **squared**
(``wmath.impl.h:48-55``, a latent bug never observed by the demo). We
implement the correct normalization; ``normalized_ref_bugcompat`` preserves
the quirk for anyone chasing bit-compatibility of host-side math.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array


def vec3(x, y, z, dtype=jnp.float32) -> Array:
    """Build a [..., 3] vector by stacking components along the last axis."""
    x, y, z = jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)
    return jnp.stack(jnp.broadcast_arrays(x, y, z), axis=-1)


def dot(v: Array, w: Array) -> Array:
    """Dot product over the trailing axis; returns [...]."""
    return jnp.sum(v * w, axis=-1)


def lengthsqr(v: Array) -> Array:
    return dot(v, v)


def length(v: Array) -> Array:
    return jnp.sqrt(lengthsqr(v))


def normalized(v: Array, eps: float = 0.0) -> Array:
    """v / |v| (the *correct* math; see module docstring)."""
    return v * jax.lax.rsqrt(jnp.maximum(lengthsqr(v), eps))[..., None]


def normalized_ref_bugcompat(v: Array) -> Array:
    """Reference quirk: scales by 1/length^2 (``wmath.impl.h:48-55``)."""
    return v / lengthsqr(v)[..., None]


def cross(v: Array, w: Array) -> Array:
    return jnp.cross(v, w)


def reflect(v: Array, n: Array) -> Array:
    """Mirror v about plane with unit normal n: v - 2 (v.n) n."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: Array, n: Array, etai_over_etat: Array) -> Array:
    """Snell refraction of unit vector uv about unit normal n (RTIOW form)."""
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = (
        -jnp.sqrt(jnp.abs(1.0 - lengthsqr(r_out_perp)))[..., None] * n
    )
    return r_out_perp + r_out_parallel


def lerp(a: Array, b: Array, t: Array) -> Array:
    """(1-t)*a + t*b; t is a per-element scalar, broadcast over components."""
    t = jnp.asarray(t)[..., None]
    return (1.0 - t) * a + t * b
