"""Primary-visibility AOVs (arbitrary output variables): the G-buffer.

Beyond-reference capability: the reference writes only beauty color to the
swapchain (``ubershader1.frag:160-163`` — one vec4 out). A production
renderer also needs per-pixel *auxiliary* channels — depth, shading normal,
albedo — for denoising, compositing, and debugging. Because every scene
backend already exposes one ``hit_fn(o, d) -> SurfaceHit`` surface
(render/integrator.py), the AOV pass is a single batched primary-ray cast
reusing it verbatim: no per-backend code, runs on any JAX platform, jits
into one fused program.

Design notes:
- Rays go through pixel CENTERS with no lens sampling — the G-buffer is
  deterministic (no RNG), so the denoiser's guides are noise-free. This is
  the standard choice even for depth-of-field renders: a sharp guide beats
  a noisy one, and the aperture blur survives in the beauty channel.
- Everything is one ``hit_fn`` call over the [H, W] grid, batched exactly
  like a 1-bounce frame; no scalar loops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import Array

from ..math import vec


class AOVs(NamedTuple):
    """Per-pixel auxiliary channels, all [H, W(, C)] float32 / bool."""

    depth: Array   # [H, W]  euclidean distance to the first hit (t * |d|,
    #                camera directions are unnormalized); +inf on miss
    normal: Array  # [H, W, 3] face-forwarded unit shading normal; 0 on miss
    albedo: Array  # [H, W, 3] material base color; sky color on miss
    hit: Array     # [H, W]  bool — primary ray hit any surface


def render_aovs(
    hit_fn,
    camera,
    width: int,
    height: int,
    sky: str = "rtiow",
    row_chunk: int | None = None,
) -> AOVs:
    """Cast one centered primary ray per pixel and record the G-buffer.

    ``hit_fn`` is any of the integrator's scene adapters
    (``SphereScene.nearest_hit``, ``tape_hit_adapter``,
    ``MeshScene.nearest_hit``); ``camera`` is a ``Camera`` (lens ignored —
    see module docstring). Matches the integrator's st-coordinate
    convention (render/integrator.py render_tile) so AOV pixels align with
    beauty pixels exactly. ``sky`` must match the beauty render's sky mode
    or miss-pixel albedo guides mismatch the rendered sky.

    ``row_chunk``: when set, rows are processed ``row_chunk`` at a time
    through a sequential ``lax.map`` — bounds the live [rays x primitives]
    candidate planes for brute adapters at large scene sizes (pair with
    ``MeshScene.nearest_hit(face_chunk=...)`` for 100k+-face G-buffers).
    """
    from jax import lax

    from .integrator import sky_color

    ys = jnp.arange(height, dtype=jnp.float32)[:, None]  # [H,1]
    xs = jnp.arange(width, dtype=jnp.float32)[None, :]   # [1,W]
    st_x = (xs + 0.5) / width
    st_y = 1.0 - (ys + 0.5) / height
    st_x, st_y = jnp.broadcast_to(st_x, (height, width)), jnp.broadcast_to(
        st_y, (height, width)
    )

    def block(st):
        bx, by = st
        o, d = camera.rays(bx, by)
        h = hit_fn(o, d)
        depth = jnp.where(h.hit, h.t * vec.length(d), jnp.inf)
        normal = jnp.where(h.hit[..., None], h.normal, 0.0)
        albedo = jnp.where(h.hit[..., None], h.albedo, sky_color(d, sky))
        return (
            depth.astype(jnp.float32),
            normal.astype(jnp.float32),
            albedo.astype(jnp.float32),
            h.hit,
        )

    if row_chunk is None or row_chunk >= height:
        depth, normal, albedo, hit = block((st_x, st_y))
    else:
        rc = int(row_chunk)
        while height % rc:  # largest divisor <= the request
            rc -= 1
        nb = height // rc
        bx = st_x.reshape(nb, rc, width)
        by = st_y.reshape(nb, rc, width)
        depth, normal, albedo, hit = lax.map(block, (bx, by))
        depth = depth.reshape(height, width)
        normal = normal.reshape(height, width, 3)
        albedo = albedo.reshape(height, width, 3)
        hit = hit.reshape(height, width)
    return AOVs(depth=depth, normal=normal, albedo=albedo, hit=hit)
