"""Quaternion algebra over [..., 4] jnp arrays, layout ``(w, x, y, z)``.

The reference declares ``Wo_Quaternion`` with only an identity constructor and
a ``// todo`` for everything else (``src/wololo/wmath.decl.h:35-43``,
``wmath.impl.h:67-70``), even though every CSG edge carries an orientation
(``src/wololo/renderer/renderer.h:22-27``). Here the rotation math is real so
those orientations actually transform rays: the tape compiler composes edge
quaternions down the tree and bakes a world->local rotation per leaf.

All ops broadcast over leading batch dims and are jit/vmap-safe.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from . import vec


def identity(dtype=jnp.float32) -> Array:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def from_axis_angle(axis: Array, angle) -> Array:
    """Unit quaternion rotating by ``angle`` (radians) about ``axis``."""
    axis = vec.normalized(jnp.asarray(axis, jnp.float32))
    angle = jnp.asarray(angle, jnp.float32)
    half = 0.5 * angle
    w = jnp.cos(half)
    xyz = jnp.sin(half)[..., None] * axis
    return jnp.concatenate(
        [jnp.broadcast_to(w[..., None], xyz.shape[:-1] + (1,)), xyz], axis=-1
    )


def multiply(q: Array, r: Array) -> Array:
    """Hamilton product q*r (apply r's rotation, then q's)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rw, rx, ry, rz = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return jnp.stack(
        [
            qw * rw - qx * rx - qy * ry - qz * rz,
            qw * rx + qx * rw + qy * rz - qz * ry,
            qw * ry - qx * rz + qy * rw + qz * rx,
            qw * rz + qx * ry - qy * rx + qz * rw,
        ],
        axis=-1,
    )


def conjugate(q: Array) -> Array:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def normalize(q: Array) -> Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def rotate(q: Array, v: Array) -> Array:
    """Rotate vector(s) v by unit quaternion(s) q.

    Uses the expanded form ``v + 2*cross(u, cross(u, v) + w*v)`` (u = q.xyz),
    which is cheaper than the sandwich product and fuses well on the VPU.
    """
    w = q[..., 0:1]
    u = q[..., 1:4]
    t = 2.0 * jnp.cross(u, v)
    return v + w * t + jnp.cross(u, t)


def rotate_inverse(q: Array, v: Array) -> Array:
    """Rotate v by the inverse of unit quaternion q (world -> local)."""
    return rotate(conjugate(q), v)


def to_rotation_matrix(q: Array) -> Array:
    """Unit quaternion -> [..., 3, 3] rotation matrix.

    Rotating a whole batch of rays with the matrix form is one [N,3]x[3,3]
    product instead of per-ray cross products.
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))
