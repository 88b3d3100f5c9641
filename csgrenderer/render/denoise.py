"""Edge-aware a-trous wavelet denoiser for path-traced frames.

Beyond-reference capability (the reference displays raw per-frame shader
output, ``renderer.c:2199-2209``): Monte-Carlo renders at low spp carry
high-frequency noise that a G-buffer-guided filter removes at a tiny
fraction of the cost of more samples. This is the classic a-trous wavelet
transform (Dammertz et al., HPG 2010) with SVGF-style edge-stopping
functions (Schied et al., HPG 2017): N passes of one 5x5 B3-spline stencil
whose taps dilate by 2^i per pass, each tap weighted by how similar its
normal / depth / luminance are to the center pixel. Guides come from
render/aov.py's deterministic primary-hit G-buffer.

Shape of the work: every pass is 25 static-offset slices of an
edge-padded [H, W] plane fused with elementwise weight math, with static
shapes, no gather and no data-dependent control flow; XLA fuses each
pass into a handful of kernels and the whole filter jits on any backend.
Albedo demodulation (filter irradiance = color/albedo, re-modulate after)
keeps texture detail out of the filter so it survives smoothing.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from .aov import AOVs

# B3-spline 1D mass [1,4,6,4,1]/16; the 5x5 kernel is its outer product.
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_LUM = (0.2126, 0.7152, 0.0722)


def _luminance(c: Array) -> Array:
    return c[..., 0] * _LUM[0] + c[..., 1] * _LUM[1] + c[..., 2] * _LUM[2]


def atrous_denoise(
    color: Array,
    aovs: AOVs,
    iterations: int = 4,
    sigma_color: float = 2.0,
    sigma_normal: float = 32.0,
    sigma_depth: float = 0.15,
    color_sigma_decay: float = 2.0,
    demodulate: bool = True,
) -> Array:
    """Denoise a linear-radiance image [H, W, 3] guided by its AOVs.

    - ``sigma_color``: luminance tolerance (larger = smoother); decays by
      ``color_sigma_decay`` each pass so later (wider) passes respect
      detail the earlier passes established.
    - ``sigma_normal``: exponent on ``max(0, n.n')`` — higher = harder
      normal edges.
    - ``sigma_depth``: RELATIVE depth tolerance (|dz| / mean depth).
    - ``demodulate``: filter color/albedo instead of color, re-modulate
      after (preserves texture under aggressive smoothing).

    Returns the denoised linear image, same shape/dtype discipline as the
    input. Pure function of its arguments; jit/vmap/shard-map safe.
    """
    if iterations < 1:
        return color
    color = color.astype(jnp.float32)
    albedo = jnp.maximum(aovs.albedo.astype(jnp.float32), 1e-4)
    if demodulate:
        work = color / albedo
    else:
        work = color

    normal = aovs.normal.astype(jnp.float32)
    # Misses carry depth=+inf; map to 0 so sky pixels blend freely among
    # themselves (dz = 0) while the hit-match gate below keeps them from
    # blending with geometry.
    depth = jnp.where(jnp.isfinite(aovs.depth), aovs.depth, 0.0).astype(
        jnp.float32
    )
    hit = aovs.hit.astype(jnp.float32)

    h, w = depth.shape
    sig_c = float(sigma_color)

    for it in range(iterations):
        step = 1 << it
        pad = 2 * step
        # Edge-replicate pad once per pass; taps are then static slices.
        wp = jnp.pad(work, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        np_ = jnp.pad(normal, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        zp = jnp.pad(depth, ((pad, pad), (pad, pad)), mode="edge")
        hp = jnp.pad(hit, ((pad, pad), (pad, pad)), mode="edge")

        lum_c = _luminance(work)
        acc = jnp.zeros_like(work)
        wsum = jnp.zeros(depth.shape, jnp.float32)
        inv_sig_c2 = 1.0 / (sig_c * sig_c + 1e-12)
        inv_sig_z2 = 1.0 / (sigma_depth * sigma_depth + 1e-12)

        for iy, ky in enumerate(_B3):
            for ix, kx in enumerate(_B3):
                dy = (iy - 2) * step
                dx = (ix - 2) * step
                oy, ox = pad + dy, pad + dx
                c_t = wp[oy : oy + h, ox : ox + w, :]
                n_t = np_[oy : oy + h, ox : ox + w, :]
                z_t = zp[oy : oy + h, ox : ox + w]
                h_t = hp[oy : oy + h, ox : ox + w]

                w_n = jnp.maximum(jnp.sum(normal * n_t, axis=-1), 0.0) ** (
                    sigma_normal
                )
                # sky pixels (normal = 0) zero w_n; let the hit gate decide
                w_n = jnp.where(hit * h_t > 0.0, w_n, 1.0)
                dz = jnp.abs(depth - z_t) / (
                    0.5 * (depth + z_t) + 1e-3
                )
                w_z = jnp.exp(-dz * dz * inv_sig_z2)
                dl = lum_c - _luminance(c_t)
                w_c = jnp.exp(-dl * dl * inv_sig_c2)
                w_h = jnp.where(hit == h_t, 1.0, 0.0)
                wt = (ky * kx) * w_n * w_z * w_c * w_h
                acc = acc + wt[..., None] * c_t
                wsum = wsum + wt

        work = acc / jnp.maximum(wsum, 1e-8)[..., None]
        sig_c /= color_sigma_decay

    if demodulate:
        work = work * albedo
    return work


def denoise_frame(
    color: Array,
    hit_fn,
    camera,
    sky: str = "rtiow",
    row_chunk: int | None = None,
    **kwargs,
) -> Array:
    """One-call convenience: render the AOVs for ``camera`` at the image's
    resolution and a-trous-denoise ``color`` with them.

    ``sky`` MUST match the sky mode the beauty frame was rendered with:
    the albedo guide on miss pixels is the sky color, and a mismatched one
    puts a false albedo edge under every sky pixel (demodulation still
    round-trips, but the luminance guide compares against the wrong
    albedo). PathTraceRenderer plumbs its RenderConfig.sky here.
    """
    from .aov import render_aovs

    h, w = color.shape[0], color.shape[1]
    aovs = render_aovs(hit_fn, camera, w, h, sky=sky, row_chunk=row_chunk)
    return atrous_denoise(color, aovs, **kwargs)
