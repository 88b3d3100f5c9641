"""Fused Pallas-Triton path-tracing kernel for sphere scenes.

The hot path of ``bench.py``, ``PathTraceRenderer`` and the realtime loop:
the reference's fragment ubershader (``ubershader1.frag:97-163``) grown to
the full RTIOW material set, with the whole sample x bounce nest fused into
one kernel so that ray state never leaves registers.

Why not the plain XLA path: it intersects a whole wave of rays against all
spheres as [N, S] arrays (render/intersect.py), two ~4 GB f32 arrays per
bounce at 1080p with ~500 spheres, and it keeps tracing terminated rays
until the last bounce. Here each lane walks its own ray:

- nearest hit = a brute-force pass over the "global" spheres (all of them
  for small scenes; the ground and hero spheres for RTIOW) plus, where the
  scene is griddable, a per-lane xz-grid DDA over per-cell sphere lists
  (kernels/worklist.py), one cell per wavefront iteration;
- the winner is carried as a sphere id; its shading attributes are read
  from the sphere table with per-lane indexed loads once per segment;
- the wavefront loop, RNG, materials and NEE are common.py's.

Rays are counted as traced path segments (sum over lanes), as the jnp
reference counts them. Counters are int32 per lane.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..camera.pinhole import Camera
from ..render.integrator import SphereScene
from ..render.intersect import expanded_form
from .common import (
    BIG,
    LIGHT_ROW,
    bsdf_mis_scale_planes,
    camera_ray_planes,
    device_cache,
    dot3,
    finish_image,
    launch,
    nee_sample_planes,
    pack_camera,
    pack_meta,
    pad_pow2,
    program_pixels,
    wavefront,
)
from .worklist import GridStatic, grid_setup, grid_step, pack_grid

# sphere table row (f32): center(3), |c|^2 - r^2, 2c(3), signed 1/r (a
# negative radius flips the normal: the RTIOW hollow-bubble trick), kind,
# param, albedo(3), expanded-form flag (intersect.expanded_form), r^2, pad
SPH_ROW = 16

_SCENE_PREP_CACHE: dict = {}


def pack_scene(scene: SphereScene) -> np.ndarray:
    """The kernel's flat sphere table [S * SPH_ROW] (host-side numpy)."""
    c = np.asarray(scene.centers, np.float32)
    r = np.asarray(scene.radii, np.float32)
    tab = np.zeros((c.shape[0], SPH_ROW), np.float32)
    tab[:, 0:3] = c
    tab[:, 3] = np.sum(c * c, axis=1) - r * r
    tab[:, 4:7] = 2.0 * c
    tab[:, 7] = 1.0 / np.where(np.abs(r) > 1e-12, r, 1e-12)
    tab[:, 8] = np.asarray(scene.mat_kind, np.float32)
    tab[:, 9] = np.asarray(scene.mat_param, np.float32)
    tab[:, 10:13] = np.asarray(scene.albedo, np.float32)
    tab[:, 13] = expanded_form(c, r, np)
    tab[:, 14] = r * r
    return tab.reshape(-1)


def _make_kernel(*, width, height, spp, max_bounces, lens, sky, n_pix,
                 n_brute, grid_static: GridStatic | None, n_lights):
    inv_w = np.float32(1.0 / width)
    inv_h = np.float32(1.0 / height)

    def kernel(cam_ref, meta_ref, sph_ref, *rest):
        rest = list(rest)
        grid_ref = rest.pop(0) if grid_static is not None else None
        light_ref = rest.pop(0) if n_lights else None
        out_r, out_g, out_b, rays_ref = rest
        seed = meta_ref[0]
        cam = [cam_ref[i] for i in range(19)]
        pix_u, px, py, valid = program_pixels(n_pix, meta_ref[2], width)

        def sph(i, j):
            return sph_ref[i * SPH_ROW + j]

        def brute(o, d):
            """Nearest hit over the first ``n_brute`` spheres: one scalar
            quadratic per sphere, in the form the jnp reference picks for
            it (intersect.expanded_form)."""
            ox, oy, oz = o
            dx, dy, dz = d
            a = dot3(dx, dy, dz, dx, dy, dz)
            inv_a = 1.0 / a
            eps_a = jnp.float32(1e-3) * a
            od = dot3(ox, oy, oz, dx, dy, dz)
            oo = dot3(ox, oy, oz, ox, oy, oz)

            def body(i, carry):
                t_best, id_best = carry
                cx, cy, cz = sph(i, 0), sph(i, 1), sph(i, 2)
                ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
                expanded = sph(i, 13) > 0.5
                half_b = jnp.where(
                    expanded, od - (cx * dx + cy * dy + cz * dz),
                    ocx * dx + ocy * dy + ocz * dz,
                )
                cterm = jnp.where(
                    expanded,
                    oo - (sph(i, 4) * ox + sph(i, 5) * oy + sph(i, 6) * oz)
                    + sph(i, 3),
                    ocx * ocx + ocy * ocy + ocz * ocz - sph(i, 14),
                )
                disc = half_b * half_b - a * cterm
                sq = jnp.sqrt(disc)  # NaN on a miss: comparisons reject it
                ta0 = -half_b - sq
                ta1 = -half_b + sq
                ta = jnp.where(ta0 > eps_a, ta0, ta1)
                tc = jnp.where(ta > eps_a, ta * inv_a, BIG)
                better = tc < t_best
                return (
                    jnp.where(better, tc, t_best),
                    jnp.where(better, i.astype(jnp.float32), id_best),
                )

            return jax.lax.fori_loop(
                0, n_brute, body, (jnp.full_like(a, BIG), jnp.zeros_like(a))
            )

        zero = jnp.zeros(pix_u.shape, jnp.float32)
        zero_i = jnp.zeros(pix_u.shape, jnp.int32)
        if grid_static is None:
            walk0 = ()

            def seg_init(o, d, t_max):
                t, ident = brute(o, d)
                return t, ident, (), ()

            step = None
        else:
            walk0 = (zero_i, zero_i, zero_i, zero, zero, zero, zero, zero)

            def seg_init(o, d, t_max):
                t, ident = brute(o, d)
                walk = grid_setup(grid_static, o, d, jnp.minimum(t, t_max))
                return t, ident, (), walk

            def step(walk, t, ident, o, d):
                return grid_step(
                    grid_static, lambda i: grid_ref[i], walk, t, ident, o, d
                )

        def hit_surface(ident, attrs, o, d, t_safe):
            sid = ident.astype(jnp.int32)
            cx, cy, cz = sph(sid, 0), sph(sid, 1), sph(sid, 2)
            inv_r = sph(sid, 7)
            ox, oy, oz = o
            dx, dy, dz = d
            onx = (ox + t_safe * dx - cx) * inv_r
            ony = (oy + t_safe * dy - cy) * inv_r
            onz = (oz + t_safe * dz - cz) * inv_r
            front = dot3(dx, dy, dz, onx, ony, onz) < 0.0
            sgn = jnp.where(front, 1.0, -1.0)
            return dict(
                n=(onx * sgn, ony * sgn, onz * sgn), front=front,
                kind=sph(sid, 8), param=sph(sid, 9),
                alb=(sph(sid, 10), sph(sid, 11), sph(sid, 12)),
                c=(cx, cy, cz), inv_r=inv_r,
            )

        def camera_rays(s_plane):
            return camera_ray_planes(
                cam, px, py, pix_u, s_plane, seed, inv_w, inv_h, lens
            )

        nee_sample = nee_mis = None
        if n_lights:
            def light(li, j):
                return light_ref[li * LIGHT_ROW + j]

            def nee_sample(p, n, alb, d_in, kind, param, pu, s, b):
                return nee_sample_planes(
                    light, n_lights, p, n, alb, d_in, kind, param, pu, s, b,
                    seed,
                )

            def nee_mis(surf, o, p_hit, pdf_b):
                return bsdf_mis_scale_planes(
                    n_lights, surf["c"], surf["inv_r"], o, pdf_b
                )

        state = wavefront(
            spp=spp, max_bounces=max_bounces, seed=seed, sky=sky,
            sample_offset_u=meta_ref[1].astype(jnp.uint32), pix_u=pix_u,
            valid=valid, camera_rays=camera_rays, seg_init=seg_init,
            hit_surface=hit_surface, walk0=walk0, grid_step=step,
            nee_sample=nee_sample, nee_mis=nee_mis,
        )
        out_r[...] = state["rad"][0]
        out_g[...] = state["rad"][1]
        out_b[...] = state["rad"][2]
        rays_ref[...] = state["rays"]

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "rows", "spp", "max_bounces", "lens", "sky",
        "n_brute", "grid_static", "n_lights", "interpret",
    ),
)
def _render_packed(sph_tab, grid_tab, lights_tab, camera, seed,
                   sample_offset, row_offset, *, width, height, rows, spp,
                   max_bounces, lens, sky, n_brute, grid_static, n_lights,
                   interpret):
    n_pix = width * rows  # this slab's pixel count (rows == height unsharded)
    kernel = _make_kernel(
        width=width, height=height, spp=spp, max_bounces=max_bounces,
        lens=lens, sky=sky, n_pix=n_pix, n_brute=n_brute,
        grid_static=grid_static, n_lights=n_lights,
    )
    inputs = [
        pack_camera(camera), pack_meta(seed, sample_offset, row_offset, width),
        sph_tab,
    ]
    if grid_static is not None:
        inputs.append(grid_tab)
    if n_lights:
        inputs.append(lights_tab)
    r, g, b, rays = launch(kernel, n_pix, inputs, interpret, "sphere_wavefront")
    return finish_image(r, g, b, rays, n_pix, rows, width, spp)


def _prepare(scene: SphereScene, nee: bool):
    """Host packing: (sphere table, grid table, lights, n_brute, static)."""
    grid_static = None
    grid_tab = None
    n_brute = scene.num_spheres
    packed_grid = pack_grid(scene)
    if packed_grid is not None:
        pack, scene = packed_grid  # scene reordered: globals first
        grid_static = pack.static
        grid_tab = pad_pow2(pack.table)
        n_brute = pack.n_globals
    lights_tab = None
    n_lights = 0
    if nee:
        # resolved AFTER the grid reordering: the last column is the lamp's
        # sphere id in the kernel's id space, so a shadow ray excludes the
        # lamp's own surface hit exactly (render/lights.py owns extraction)
        from ..render.lights import extract_lights

        lights, ids = extract_lights(scene, return_ids=True)
        n_lights = lights.num_lights
        tab = np.zeros((n_lights, LIGHT_ROW), np.float32)
        tab[:, 0:3] = lights.centers
        tab[:, 3] = lights.radii
        tab[:, 4:7] = lights.emit
        tab[:, 7] = ids.astype(np.float32)
        lights_tab = pad_pow2(tab)
    return (pad_pow2(pack_scene(scene)), grid_tab, lights_tab, n_brute,
            grid_static, n_lights)


def render_image_pallas(
    scene: SphereScene,
    camera: Camera,
    width: int,
    height: int,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    jitter: bool = True,
    lens: bool = False,
    sample_offset=0,
    interpret: bool = False,
    rows: int | None = None,
    row_offset=0,
    nee: bool = False,
):
    """Drop-in for ``integrator.render_image`` on a SphereScene.

    ``interpret=True`` runs the kernel in the Pallas interpreter (the CPU
    tests validate it against the jnp reference that way).
    ``rows``/``row_offset`` render a full-width horizontal slab of the
    ``width x height`` image (the sharding primitive; RNG and camera stay
    functions of global pixel coordinates, like integrator.render_tile).

    The scene takes the grid worklists whenever pack_grid can bin it and
    is brute-forced otherwise. ``nee=True`` adds next-event estimation
    toward the scene's emissive spheres (render/lights.py).
    """
    if not jitter:
        raise NotImplementedError("the sphere kernel always jitters")
    if nee and not (np.asarray(scene.mat_kind) == 4).any():
        raise ValueError("nee=True but the scene has no emissive spheres")
    sph_tab, grid_tab, lights_tab, n_brute, grid_static, n_lights = (
        device_cache(
            _SCENE_PREP_CACHE, (id(scene.centers), nee), scene.centers,
            lambda: _prepare(scene, nee),
        )
    )
    return _render_packed(
        sph_tab, grid_tab, lights_tab, camera,
        jnp.asarray(seed, jnp.int32), jnp.asarray(sample_offset, jnp.int32),
        jnp.asarray(row_offset, jnp.int32),
        width=width, height=height, rows=height if rows is None else rows,
        spp=spp, max_bounces=max_bounces, lens=lens, sky=sky,
        n_brute=n_brute, grid_static=grid_static, n_lights=n_lights,
        interpret=interpret,
    )
