"""Path-tracing integrator: the batched replacement for the fragment ubershader.

The reference runs a 50-line fragment shader once per pixel
(``ubershader1.frag:147-163``); here the whole pixel grid is one batched jnp
program: ray generation broadcasts over [H*W] rays, the bounce "recursion" is
an iterative ``lax.fori_loop`` carrying (origin, direction, throughput,
radiance, active) per ray (SURVEY §7: recursion -> iteration), and samples
accumulate across an outer loop.

Two scene backends share one integrator:
- ``SphereScene`` — struct-of-arrays sphere soup (RTIOW scenes); nearest-hit
  via the batched quadratic (render/intersect.py).
- ``CompiledTape`` — CSG scenes via the interval tape evaluator.

This module is the *reference implementation* (pure jnp, CPU-runnable, used
by tests and goldens); kernels/ holds the Pallas-Triton fast path
validated against it.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from ..camera.pinhole import WololoCamera, pixel_st_grid
from ..math import vec
from ..scene.tape import CompiledTape
from . import intersect, materials, tape_eval
from .sampling import sample_in_unit_disk, uniform4

# np (not jnp) so importing this module never initializes a jax backend
# (the driver's dryrun must pick its platform before any backend exists)
WHITE = np.array([1.0, 1.0, 1.0], np.float32)
SKY_BLUE = np.array([0.5, 0.7, 1.0], np.float32)


def sky_color(d: Array, mode: str = "rtiow") -> Array:
    """Background gradient.

    - ``"wololo"``: the reference's t = unit_d.y (ubershader1.frag:115-123) —
      note NOT the RTIOW 0.5*(y+1) remap; this is a deliberate reference
      quirk kept for bit-comparable milestone images.
    - ``"rtiow"``: t = 0.5 * (unit_d.y + 1) (the book's gradient).
    - ``"black"``: no sky (emissive-lit scenes).
    """
    unit = vec.normalized(d, eps=1e-20)
    y = unit[..., 1]
    if mode == "wololo":
        t = y
    elif mode == "rtiow":
        t = 0.5 * (y + 1.0)
    elif mode == "black":
        return jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    else:
        raise ValueError(f"unknown sky mode {mode!r}")
    return vec.lerp(WHITE, SKY_BLUE, t)


class SurfaceHit(NamedTuple):
    t: Array  # [...]
    hit: Array  # [...] bool
    normal: Array  # [..., 3] unit, opposing the incoming ray
    front_face: Array  # [...] bool (ray entered the solid from outside)
    mat_kind: Array  # [...] int32
    albedo: Array  # [..., 3]
    mat_param: Array  # [...]


class SphereScene(NamedTuple):
    """Struct-of-arrays sphere soup with per-sphere materials."""

    centers: Array  # [S, 3]
    radii: Array  # [S]
    mat_kind: Array  # [S] int32
    albedo: Array  # [S, 3]
    mat_param: Array  # [S]

    @property
    def num_spheres(self) -> int:
        return self.centers.shape[0]

    def nearest_hit(self, o: Array, d: Array, eps: float = 1e-3) -> SurfaceHit:
        flat_o = o.reshape(-1, 3)
        flat_d = d.reshape(-1, 3)
        t, idx, hit = intersect.spheres_nearest_hit(
            flat_o, flat_d, self.centers, self.radii, t_min=eps
        )
        t_safe = jnp.where(hit, t, 1.0)
        p = flat_o + t_safe[:, None] * flat_d
        outward = (p - self.centers[idx]) / self.radii[idx][:, None]
        front_face = vec.dot(flat_d, outward) < 0.0
        n = jnp.where(front_face[:, None], outward, -outward)
        batch = o.shape[:-1]
        return SurfaceHit(
            t=t.reshape(batch),
            hit=hit.reshape(batch),
            normal=n.reshape(batch + (3,)),
            front_face=front_face.reshape(batch),
            mat_kind=self.mat_kind[idx].reshape(batch),
            albedo=self.albedo[idx].reshape(batch + (3,)),
            mat_param=self.mat_param[idx].reshape(batch),
        )


def tape_hit_adapter(tape: CompiledTape, o: Array, d: Array, eps: float = 1e-3) -> SurfaceHit:
    h = tape_eval.tape_nearest_hit(tape, o, d, eps=eps)
    # Face-forward the leaf normal against the ray; ``entering`` is the
    # solid-level front-face flag (correct even on subtracted surfaces).
    flip = vec.dot(d, h.normal) > 0.0
    n = jnp.where(flip[..., None], -h.normal, h.normal)
    return SurfaceHit(
        t=h.t,
        hit=h.hit,
        normal=n,
        front_face=h.entering,
        mat_kind=h.mat_kind,
        albedo=h.albedo,
        mat_param=h.mat_param,
    )


HitFn = Callable[[Array, Array], SurfaceHit]


def trace_paths(
    hit_fn: HitFn,
    o: Array,  # [..., 3]
    d: Array,  # [..., 3]
    pixel_id: Array,  # [...] uint32 — stable global pixel index
    sample_id: Array,  # [] or [...] uint32
    seed: int,
    max_bounces: int,
    sky: str = "rtiow",
    eps: float = 1e-3,
    lights=None,
) -> tuple[Array, Array]:
    """Iterative bounce loop. Returns (radiance [..., 3], rays_traced []).

    ``lights``: an optional render.lights.SphereLights — enables
    MIS-weighted next-event estimation: every lambertian hit additionally
    samples one emissive sphere directly (shadow ray per bounce, ~2x
    intersection cost), and lamp emission found by the lambertian BSDF
    sample carries the balance-heuristic partner weight (render/lights.py)
    so the two strategies sum to exactly one estimator. Identical
    expectation to plain PT, far lower variance on emissive-lit
    (black-sky) scenes.
    """
    batch = o.shape[:-1]
    # Loop-carry zeros are derived from the RNG counters (pixel_id and
    # sample_id cover the tile and sample mesh axes) instead of jnp.zeros:
    # under shard_map the carry then starts with the varying-axis type the
    # body produces, so the vma checker accepts the loop (the former
    # check_vma=False escape hatch). o/d get the same +0 lift — a pinhole
    # camera origin alone is device-invariant. Values are identical.
    zero1 = jnp.broadcast_to(
        (pixel_id * jnp.uint32(0) + sample_id * jnp.uint32(0)).astype(
            jnp.float32
        ),
        batch,
    )
    zero3 = zero1[..., None] + jnp.zeros((3,), jnp.float32)
    rays_dtype = jnp.int64 if jax.config.x64_enabled else jnp.int32
    state = dict(
        o=o + zero3,
        d=d + zero3,
        throughput=zero3 + 1.0,
        radiance=zero3,
        active=zero1 > -1.0,
        # cosine-pdf of the scatter that produced the CURRENT ray;
        # 0 = previous vertex was not lambertian (MIS partner weight)
        prev_pdf_b=zero1,
        rays=jnp.sum(zero1).astype(rays_dtype),
    )

    def bounce(b, s):
        h = hit_fn(s["o"], s["d"])
        u = uniform4(
            pixel_id,
            sample_id,
            jnp.uint32(b),
            jnp.uint32(seed & 0xFFFFFFFF),
        )
        sc = materials.scatter(
            h.mat_kind, h.albedo, h.mat_param, s["d"], h.normal, h.front_face, u
        )
        active = s["active"]
        missed = active & ~h.hit
        hit_active = active & h.hit

        radiance = s["radiance"]
        radiance = radiance + jnp.where(
            missed[..., None], s["throughput"] * sky_color(s["d"], sky), 0.0
        )
        t_safe = jnp.where(h.hit, h.t, 1.0)
        p_hit = s["o"] + t_safe[..., None] * s["d"]
        if lights is None:
            emit_scale = jnp.ones_like(t_safe)
        else:
            # MIS partner weight on BSDF-found lamp emission (kind 4 only;
            # the normal-map debug "emission" is not a light)
            from .lights import bsdf_mis_scale_any

            w_b = bsdf_mis_scale_any(lights, s["o"], p_hit, s["prev_pdf_b"])
            emit_scale = jnp.where(
                (h.mat_kind == 4) & (s["prev_pdf_b"] > 0.0), w_b, 1.0
            )
        radiance = radiance + jnp.where(
            hit_active[..., None],
            s["throughput"] * sc.emitted * emit_scale[..., None],
            0.0,
        )

        is_lam = h.mat_kind == 1
        # glossy = fuzzy metal: its lobe has a real pdf to pair with
        # (scatter_pdf_metal); mirror metal (fuzz ~ 0) is a delta — NEE
        # cannot sample it, BSDF-found emission stays unweighted
        is_glossy = (h.mat_kind == 2) & (h.mat_param > 1e-4)
        if lights is not None:
            from .lights import nee_contribution_any, scatter_pdf_metal

            ul = uniform4(
                pixel_id,
                sample_id,
                jnp.uint32(b) | jnp.uint32(0x80000000),  # decouple from scatter
                jnp.uint32(seed & 0xFFFFFFFF),
            )

            def pdf_b_fn(d_l, cos, s=s, h=h):
                pdf_lam = jnp.maximum(cos, 0.0) * jnp.float32(1.0 / np.pi)
                pdf_met = scatter_pdf_metal(s["d"], h.normal, h.mat_param, d_l)
                # below-horizon light directions carry zero BRDF (the
                # procedural metal absorbs them) — gate the contribution
                pdf_met = jnp.where(cos > 0.0, pdf_met, 0.0)
                return jnp.where(
                    is_lam, pdf_lam, jnp.where(is_glossy, pdf_met, 0.0)
                )

            direct = nee_contribution_any(
                hit_fn, p_hit, h.normal, h.albedo, lights, ul,
                pdf_b_fn=pdf_b_fn,
            )
            nee_mask = hit_active & (is_lam | is_glossy)
            radiance = radiance + jnp.where(
                nee_mask[..., None], s["throughput"] * direct, 0.0
            )

        throughput = jnp.where(
            hit_active[..., None], s["throughput"] * sc.attenuation, s["throughput"]
        )
        still_active = hit_active & ~sc.terminate

        new_o = jnp.where(
            hit_active[..., None], s["o"] + t_safe[..., None] * s["d"], s["o"]
        )
        new_d = jnp.where(hit_active[..., None], sc.direction, s["d"])
        if lights is None:
            prev_pdf_b = s["prev_pdf_b"]
        else:
            from .lights import scatter_pdf_lambertian, scatter_pdf_metal

            pdf_b = scatter_pdf_lambertian(h.normal, sc.direction)
            pdf_m = scatter_pdf_metal(
                s["d"], h.normal, h.mat_param, sc.direction
            )
            prev_pdf_b = jnp.where(
                still_active & is_lam, pdf_b,
                jnp.where(still_active & is_glossy, pdf_m, 0.0),
            )
        return dict(
            o=new_o,
            d=new_d,
            throughput=throughput,
            radiance=radiance,
            active=still_active,
            prev_pdf_b=prev_pdf_b,
            rays=s["rays"] + jnp.sum(active.astype(s["rays"].dtype)),
        )

    state = jax.lax.fori_loop(0, max_bounces, bounce, state)
    # Paths still active after the bounce cap contribute nothing (RTIOW
    # convention: "no more light is gathered").
    return state["radiance"], state["rays"]


def render_tile(
    hit_fn: HitFn,
    camera,
    full_width: int,
    full_height: int,
    tile_x0,
    tile_y0,
    tile_width: int,
    tile_height: int,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    jitter: bool = True,
    lens: bool = False,
    sample_offset=0,
    lights=None,
) -> tuple[Array, Array]:
    """Render a sub-rectangle of a ``full_width x full_height`` image.

    The sharding primitive: pixel ids, camera st coords and RNG counters are
    all functions of *global* pixel coordinates, so any tiling of the image
    across devices (or any ``sample_offset`` split of spp across devices)
    composes to exactly the single-device image. ``tile_x0/tile_y0`` may be
    traced values (shard_map axis offsets).

    Returns (radiance_sum [th, tw, 3] — NOT divided by spp — and rays traced).
    """
    tile_x0 = jnp.asarray(tile_x0, jnp.uint32)
    tile_y0 = jnp.asarray(tile_y0, jnp.uint32)
    ys = tile_y0 + jnp.arange(tile_height, dtype=jnp.uint32)[:, None]  # [th,1]
    xs = tile_x0 + jnp.arange(tile_width, dtype=jnp.uint32)[None, :]  # [1,tw]
    pixel_id = ys * jnp.uint32(full_width) + xs  # [th, tw] global ids
    sample_offset = jnp.asarray(sample_offset, jnp.uint32)

    def one_sample(si, acc):
        s = jnp.uint32(si) + sample_offset
        u = uniform4(pixel_id, s, jnp.uint32(0xA5A5A5A5), jnp.uint32(seed))
        if jitter:
            jx, jy = u[..., 0], u[..., 1]
        else:
            jx = jnp.full(pixel_id.shape, 0.5, jnp.float32)
            jy = jx
        st_x = (xs.astype(jnp.float32) + jx) / full_width
        st_y = 1.0 - (ys.astype(jnp.float32) + jy) / full_height
        if lens:
            lens_uv = sample_in_unit_disk(u[..., 2], u[..., 3])
            o, d = camera.rays(st_x, st_y, lens_uv=lens_uv)
        else:
            o, d = camera.rays(st_x, st_y)
        radiance, rays = trace_paths(
            hit_fn,
            o,
            d,
            pixel_id,
            s,
            seed,
            max_bounces,
            sky=sky,
            lights=lights,
        )
        return acc[0] + radiance, acc[1] + rays

    # value-dependent zeros (see trace_paths): the accumulator starts with
    # the varying-axis type of the per-sample contributions under shard_map
    # (pixel_id covers the tile axis, sample_offset the sample axis)
    pz = (pixel_id * jnp.uint32(0) + sample_offset * jnp.uint32(0)).astype(
        jnp.float32
    )
    acc0 = (
        pz[..., None] + jnp.zeros((1, 1, 3), jnp.float32),
        jnp.sum(pz).astype(jnp.int64 if jax.config.x64_enabled else jnp.int32),
    )
    return jax.lax.fori_loop(0, spp, one_sample, acc0)


def render_image(
    hit_fn: HitFn,
    camera,
    width: int,
    height: int,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    jitter: bool = True,
    lens: bool = False,
    sample_offset=0,
    lights=None,
) -> tuple[Array, Array]:
    """Render a linear-radiance image [H, W, 3]; also returns rays traced.

    Samples run as a ``lax.fori_loop`` over spp (one compiled body), each
    sample jittering the pixel position with the counter-based RNG so results
    are identical under any pixel sharding. ``sample_offset`` advances the
    per-sample RNG counters for progressive rendering across frames.
    """
    image_sum, rays = render_tile(
        hit_fn,
        camera,
        width,
        height,
        0,
        0,
        width,
        height,
        spp=spp,
        max_bounces=max_bounces,
        seed=seed,
        sky=sky,
        jitter=jitter,
        lens=lens,
        sample_offset=sample_offset,
        lights=lights,
    )
    return image_sum / spp, rays


# ---------------------------------------------------------------------------
# Config 1: the milestone-01 frame, bit-faithful to the reference shader
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(1, 2))
def render_wololo_frame(time_since_start_sec, width: int, height: int) -> Array:
    """Exact re-expression of ``ep_rt1_1`` (ubershader1.frag:97-163).

    One animated sphere (y = 2 sin(2*pi/4 * t), z = -11), normal-map shading
    0.5*(n+1) on hit, white->sky-blue gradient on the *unnormalized-ray*'s
    normalized y otherwise. Directions stay unnormalized through the sphere
    test exactly like ``rt_fragment_ray`` (frag:74-82).
    """
    t_sec = jnp.asarray(time_since_start_sec, jnp.float32)
    st_x, st_y = pixel_st_grid(width, height)
    cam = WololoCamera.create()
    o, d = cam.rays(st_x, st_y, aspect_ratio=width / height)

    # frag:99-104 — animated sphere center (3.1415, not pi, per the source)
    amplitude = jnp.float32(2.0)
    omega = jnp.float32(2.0 * 3.1415 / 4.0)
    center = jnp.stack(
        [
            jnp.float32(0.0),
            amplitude * jnp.sin(omega * t_sec),
            jnp.float32(-1.0 - 10.0),
        ]
    )
    radius = 0.5

    t = intersect.hit_sphere_ref(center, radius, o, d)
    hit = t > 0.0

    # frag:107-111: normal = normalize(d * t - center)  (NOTE: the reference
    # omits the ray origin — correct only because origin == 0; kept verbatim.)
    n = vec.normalized(d * t[..., None] - center, eps=1e-20)
    hit_color = 0.5 * (n + 1.0)
    return jnp.where(hit[..., None], hit_color, sky_color(d, "wololo"))


@partial(jax.jit, static_argnums=(0, 1))
def render_debug_view_1(width: int, height: int) -> Array:
    """``ep_debug_view_1`` (ubershader1.frag:132-137): the st-coordinate
    visualizer — color = (st.x, st.y, 0). The reference can only reach it by
    editing main() and recompiling the shader (frag:160-163); here it is a
    first-class entry point."""
    st_x, st_y = pixel_st_grid(width, height)
    zero = jnp.zeros_like(st_x)
    return jnp.stack([st_x, st_y, zero], axis=-1)
