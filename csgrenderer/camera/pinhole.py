"""Cameras: reference-compatible fixed pinhole + RTIOW thin-lens.

``WololoCamera`` reproduces the reference ubershader's ray generation exactly
(``src/wololo/renderer/ubershader1.frag:19-82``):

- st coords: ``st.x = fragcoord.x / W``, ``st.y = 1 - fragcoord.y / H`` where
  ``gl_FragCoord`` is the pixel *center* (px + 0.5) counted from the top-left
  — i.e. the y-flip is part of the contract (frag:26-29).
- viewport: height 1.0 (not RTIOW's 2.0), width ``aspect``, focal length 1.0,
  eye at the origin (frag:50-60).
- ray direction is **left unnormalized** (``rt_fragment_ray`` builds the
  struct directly, bypassing the normalizing ``rt_ray`` ctor, frag:74-82);
  the reference's sphere test and normal math consume it unnormalized, so we
  keep it that way for bit-comparable images.

``Camera`` is the full RTIOW-style camera (lookfrom/lookat/vfov/aperture)
used by the path-traced benchmark configs.

Both are plain pytrees of arrays: jit/vmap/shard_map-safe, and ray generation
is one fused broadcast over the pixel grid — the batched replacement for
one-fragment-shader-invocation-per-pixel.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import Array

from ..math import vec


def pixel_st_grid(width: int, height: int, dtype=jnp.float32):
    """Reference st coords per pixel center, shape [height, width] each.

    Row 0 of the returned arrays is the TOP image row (image memory order,
    matching ``gl_FragCoord``); since st.y = 1 - (y+0.5)/H, row 0 carries
    st.y ≈ 1 — exactly the y-flip of frag:26-29.
    """
    xs = (jnp.arange(width, dtype=dtype) + 0.5) / width
    ys = 1.0 - (jnp.arange(height, dtype=dtype) + 0.5) / height
    st_x = jnp.broadcast_to(xs[None, :], (height, width))
    st_y = jnp.broadcast_to(ys[:, None], (height, width))
    return st_x, st_y


class WololoCamera(NamedTuple):
    """The reference's hard-coded shader camera (frag:50-60)."""

    focal_length: Array  # scalar
    origin: Array  # [3]

    @staticmethod
    def create(focal_length: float = 1.0) -> "WololoCamera":
        return WololoCamera(
            focal_length=jnp.float32(focal_length),
            origin=jnp.zeros((3,), jnp.float32),
        )

    def rays(self, st_x: Array, st_y: Array, aspect_ratio) -> tuple[Array, Array]:
        """(origins, directions) for st coords; directions UNNORMALIZED."""
        aspect = jnp.asarray(aspect_ratio, jnp.float32)
        horizontal = vec.vec3(aspect, 0.0, 0.0)
        vertical = vec.vec3(0.0, 1.0, 0.0)
        lower_left = (
            self.origin
            - horizontal / 2.0
            - vertical / 2.0
            - vec.vec3(0.0, 0.0, self.focal_length)
        )
        d = (
            lower_left
            + st_x[..., None] * horizontal
            + st_y[..., None] * vertical
            - self.origin
        )
        o = jnp.broadcast_to(self.origin, d.shape)
        return o, d


class Camera(NamedTuple):
    """RTIOW thin-lens camera as a pytree; build with ``Camera.look_at``."""

    origin: Array  # [3]
    lower_left: Array  # [3]
    horizontal: Array  # [3] full viewport width vector
    vertical: Array  # [3] full viewport height vector
    u: Array  # [3] camera basis (right)
    v: Array  # [3] camera basis (up)
    lens_radius: Array  # scalar

    @staticmethod
    def look_at(
        lookfrom,
        lookat,
        vup=(0.0, 1.0, 0.0),
        vfov_degrees: float = 40.0,
        aspect_ratio: float = 16.0 / 9.0,
        aperture: float = 0.0,
        focus_dist: float | None = None,
    ) -> "Camera":
        lookfrom = jnp.asarray(lookfrom, jnp.float32)
        lookat = jnp.asarray(lookat, jnp.float32)
        vup = jnp.asarray(vup, jnp.float32)
        if focus_dist is None:
            focus_dist = vec.length(lookfrom - lookat)
        focus_dist = jnp.asarray(focus_dist, jnp.float32)

        theta = jnp.deg2rad(jnp.float32(vfov_degrees))
        h = jnp.tan(theta / 2.0)
        viewport_height = 2.0 * h
        viewport_width = aspect_ratio * viewport_height

        w = vec.normalized(lookfrom - lookat)
        u = vec.normalized(jnp.cross(vup, w))
        v = jnp.cross(w, u)

        horizontal = focus_dist * viewport_width * u
        vertical = focus_dist * viewport_height * v
        lower_left = lookfrom - horizontal / 2.0 - vertical / 2.0 - focus_dist * w
        return Camera(
            origin=lookfrom,
            lower_left=lower_left,
            horizontal=horizontal,
            vertical=vertical,
            u=u,
            v=v,
            lens_radius=jnp.float32(aperture) / 2.0,
        )

    def rays(
        self,
        st_x: Array,
        st_y: Array,
        lens_uv: Array | None = None,
    ) -> tuple[Array, Array]:
        """(origins, directions) — directions unnormalized (RTIOW convention).

        ``lens_uv``: optional [..., 2] samples on the unit disk for defocus
        blur; omit for a pure pinhole.
        """
        if lens_uv is None:
            offset = jnp.zeros(st_x.shape + (3,), st_x.dtype)
        else:
            rd = self.lens_radius * lens_uv
            offset = rd[..., 0:1] * self.u + rd[..., 1:2] * self.v
        o = self.origin + offset
        d = (
            self.lower_left
            + st_x[..., None] * self.horizontal
            + st_y[..., None] * self.vertical
            - self.origin
            - offset
        )
        return o, d
