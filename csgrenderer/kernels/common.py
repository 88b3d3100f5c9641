"""Shared scaffold of the Pallas-Triton path-tracing kernels.

One kernel program owns ``BLOCK`` consecutive pixels of the image, one ray
per lane, the shape of the original per-pixel fragment shader (SURVEY §0).
Every piece of per-ray state is a 1-D ``[BLOCK]`` f32/int32 array that
Triton keeps in registers; scene tables stay in global memory as flat f32
arrays and are read with scalar loads (the same value for every lane) or
per-lane indexed loads, which L1/L2 serve. All geometry is f32 on the CUDA
cores: no ``pl.dot``, so no TF32.

This module holds what the sphere and CSG tape kernels share:

- PCG4D RNG on global (pixel, sample, bounce) counters, bit-identical to
  render/sampling.py, so images are sharding-invariant;
- RTIOW material scatter (render/materials.py) and the sky gradients;
- thin-lens/pinhole camera rays;
- next-event estimation toward emissive spheres with balance-heuristic MIS
  (render/lights.py);
- ``wavefront``: the per-lane loop that regenerates a camera sample the
  moment a lane's path ends, runs one traversal step per lane per
  iteration and weaves NEE shadow rays in as extra segments;
- ``launch``: the ``pallas_call`` on the Triton route.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# 128 rays per program at 4 warps: one ray per thread, about 16k programs
# at 1080p for the 132 SMs
BLOCK = 128
NUM_WARPS = 4

BIG = np.float32(1e30)
BIG_CUT = np.float32(5e29)

CAM_SIZE = 32  # 19 camera scalars, padded to a power of two
META_SIZE = 8  # seed, sample offset, global pixel offset of the slab

# light table row (f32): center(3), radius, emitted radiance(3), the
# lamp's id in the kernel's hit-id space (-2: no id, distance rule only)
LIGHT_ROW = 8


def pad_pow2(flat) -> jax.Array:
    """1-D f32 table padded with zeros to a power-of-two length: Triton
    blocks must have power-of-two sizes."""
    flat = jnp.asarray(flat, jnp.float32).reshape(-1)
    n = max(1, int(flat.shape[0]))
    size = 1 << (n - 1).bit_length()
    return jnp.pad(flat, (0, size - flat.shape[0]))


def device_cache(cache: dict, key, keyhold, build):
    """Memoize device-resident packed tables keyed on host-array identity.

    Host packing (numpy) and its upload happen once per static scene
    instead of once per frame. ``keyhold`` pins the keyed array against id
    reuse, so animated scenes, which make fresh arrays each frame, miss.
    Inside a jit/shard_map trace the cache is bypassed both ways: a cached
    tracer would leak out of its trace.
    """
    from jax._src.core import trace_state_clean

    if not trace_state_clean():
        return build()
    ent = cache.get(key)
    if ent is not None and ent[0] is keyhold:
        return ent[1]
    val = build()
    if len(cache) > 32:
        cache.clear()
    cache[key] = (keyhold, val)
    return val


def pack_camera(camera) -> jax.Array:
    """The camera's 19 kernel scalars, padded to ``CAM_SIZE`` (jit-safe)."""
    vals = jnp.concatenate([
        camera.origin, camera.lower_left, camera.horizontal, camera.vertical,
        camera.u, camera.v, jnp.reshape(camera.lens_radius, (1,)),
    ]).astype(jnp.float32)
    return jnp.pad(vals, (0, CAM_SIZE - vals.shape[0]))


def pack_meta(seed, sample_offset, row_offset, width) -> jax.Array:
    i32 = jnp.int32
    vals = jnp.stack([
        jnp.asarray(seed, i32), jnp.asarray(sample_offset, i32),
        jnp.asarray(row_offset, i32) * width,
    ])
    return jnp.pad(vals, (0, META_SIZE - 3))


def pcg4d_planes(a, b, c, d):
    """PCG4D hash on uint32 planes -> four f32 uniforms in [0,1)."""
    mul = jnp.uint32(1664525)
    inc = jnp.uint32(1013904223)
    v = [x * mul + inc for x in (a, b, c, d)]
    v[0] = v[0] + v[1] * v[3]
    v[1] = v[1] + v[2] * v[0]
    v[2] = v[2] + v[0] * v[1]
    v[3] = v[3] + v[1] * v[2]
    v = [x ^ (x >> jnp.uint32(16)) for x in v]
    v[0] = v[0] + v[1] * v[3]
    v[1] = v[1] + v[2] * v[0]
    v[2] = v[2] + v[0] * v[1]
    v[3] = v[3] + v[1] * v[2]
    scale = jnp.float32(1.0 / 16777216.0)
    # after >> 8 the value fits 24 bits: the int32 route is exact
    return tuple(
        (x >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) * scale
        for x in v
    )


def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def scatter_planes(kind, param, alb, d, n, front, u0, u1, u2):
    """RTIOW material dispatch on planes (see render/materials.py).

    kind/param/alb are per-ray attribute planes; d the incoming direction;
    n the unit shading normal (already opposing d); front the solid-level
    front-face mask. Returns (new_d, atten, emitted, terminate, unit_d).
    """
    dx, dy, dz = d
    nx, ny, nz = n
    ar, ag, ab = alb

    inv_len = jax.lax.rsqrt(
        jnp.maximum(dot3(dx, dy, dz, dx, dy, dz), jnp.float32(1e-20))
    )
    udx, udy, udz = dx * inv_len, dy * inv_len, dz * inv_len

    z = 1.0 - 2.0 * u0
    r_ = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = jnp.float32(2.0 * np.pi) * u1
    rux = r_ * jnp.cos(phi)
    ruy = r_ * jnp.sin(phi)
    ruz = z

    lamx, lamy, lamz = nx + rux, ny + ruy, nz + ruz
    lam_deg = dot3(lamx, lamy, lamz, lamx, lamy, lamz) < jnp.float32(1e-12)
    lamx = jnp.where(lam_deg, nx, lamx)
    lamy = jnp.where(lam_deg, ny, lamy)
    lamz = jnp.where(lam_deg, nz, lamz)

    ud_dot_n = dot3(udx, udy, udz, nx, ny, nz)
    rfx = udx - 2.0 * ud_dot_n * nx
    rfy = udy - 2.0 * ud_dot_n * ny
    rfz = udz - 2.0 * ud_dot_n * nz
    mex = rfx + param * rux
    mey = rfy + param * ruy
    mez = rfz + param * ruz
    metal_absorbed = dot3(mex, mey, mez, nx, ny, nz) <= 0.0

    ior = jnp.maximum(param, jnp.float32(1e-6))
    eta = jnp.where(front, 1.0 / ior, ior)
    cos_t = jnp.minimum(-ud_dot_n, 1.0)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    cannot = eta * sin_t > 1.0
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    rp = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    use_refl = cannot | (u2 < rp)
    ppx = eta * (udx + cos_t * nx)
    ppy = eta * (udy + cos_t * ny)
    ppz = eta * (udz + cos_t * nz)
    pl2 = dot3(ppx, ppy, ppz, ppx, ppy, ppz)
    par = -jnp.sqrt(jnp.abs(1.0 - pl2))
    refx = ppx + par * nx
    refy = ppy + par * ny
    refz = ppz + par * nz
    dlx = jnp.where(use_refl, rfx, refx)
    dly = jnp.where(use_refl, rfy, refy)
    dlz = jnp.where(use_refl, rfz, refz)

    is_lam = kind == 1.0
    is_metal = kind == 2.0
    is_diel = kind == 3.0
    is_em = kind == 4.0
    is_nm = kind == 0.0

    ndx = jnp.where(is_lam, lamx, jnp.where(is_metal, mex, dlx))
    ndy = jnp.where(is_lam, lamy, jnp.where(is_metal, mey, dly))
    ndz = jnp.where(is_lam, lamz, jnp.where(is_metal, mez, dlz))
    atr = jnp.where(is_diel, 1.0, ar)
    atg = jnp.where(is_diel, 1.0, ag)
    atb = jnp.where(is_diel, 1.0, ab)
    emr = jnp.where(is_nm, 0.5 * (nx + 1.0), jnp.where(is_em, ar, 0.0))
    emg = jnp.where(is_nm, 0.5 * (ny + 1.0), jnp.where(is_em, ag, 0.0))
    emb = jnp.where(is_nm, 0.5 * (nz + 1.0), jnp.where(is_em, ab, 0.0))
    term = is_nm | is_em | (is_metal & metal_absorbed)
    return (
        (ndx, ndy, ndz),
        (atr, atg, atb),
        (emr, emg, emb),
        term,
        (udx, udy, udz),
    )


def sky_planes(ud, mode: str):
    """Background radiance planes from unit direction planes."""
    udx, udy, udz = ud
    if mode == "black":
        zero = jnp.zeros_like(udy)
        return zero, zero, zero
    if mode == "rtiow":
        t = 0.5 * (udy + 1.0)
    elif mode == "wololo":
        t = udy
    else:
        raise ValueError(f"bad sky mode {mode}")
    return (
        (1.0 - t) + t * 0.5,
        (1.0 - t) + t * 0.7,
        (1.0 - t) + t * 1.0,
    )


def camera_ray_planes(cam, px, py, pix_u, s_plane, seed, inv_w, inv_h, lens):
    """Primary-ray planes for per-lane sample ids (integrator.render_tile's
    raygen). ``cam`` is the unpacked 19-scalar camera tuple."""
    (cox, coy, coz, llx, lly, llz, hx, hy, hz, vx, vy, vz,
     ux, uy, uz, vvx, vvy, vvz, lens_radius) = cam
    u0, u1, u2, u3 = pcg4d_planes(
        pix_u, s_plane,
        jnp.broadcast_to(jnp.uint32(0xA5A5A5A5), pix_u.shape),
        jnp.broadcast_to(seed.astype(jnp.uint32), pix_u.shape),
    )
    st_x = (px + u0) * inv_w
    st_y = 1.0 - (py + u1) * inv_h
    if lens:
        lr = jnp.sqrt(u2)
        lphi = jnp.float32(2.0 * np.pi) * u3
        rd0 = lens_radius * lr * jnp.cos(lphi)
        rd1 = lens_radius * lr * jnp.sin(lphi)
        offx = rd0 * ux + rd1 * vvx
        offy = rd0 * uy + rd1 * vvy
        offz = rd0 * uz + rd1 * vvz
    else:
        offx = offy = offz = jnp.zeros_like(st_x)
    o = (cox + offx, coy + offy, coz + offz)
    d = (
        llx + st_x * hx + st_y * vx - cox - offx,
        lly + st_x * hy + st_y * vy - coy - offy,
        llz + st_x * hz + st_y * vz - coz - offz,
    )
    return o, d


def shade_and_advance(
    mask, t, hit, n, front, kind, param, alb,
    o, d, thr, rad, pix_u, cur_s, b_plane, seed, sky, emit_scale,
):
    """The shading tail of a path segment: RNG -> material scatter ->
    sky/emission accumulation -> path advance, applied under ``mask``.

    ``n`` is the unit shading normal opposing d, ``front`` the solid-level
    front-face flag. ``emit_scale`` multiplies the emission term only (the
    MIS partner weight of BSDF-found lamp emission). Returns
    (o, d, thr, rad, term).
    """
    ox, oy, oz = o
    dx, dy, dz = d
    tr, tg, tb = thr
    rr, rg, rb = rad

    u0, u1, u2, _u3 = pcg4d_planes(
        pix_u, cur_s, b_plane,
        jnp.broadcast_to(seed.astype(jnp.uint32), cur_s.shape),
    )
    (ndx, ndy, ndz), (atr, atg, atb), (emr, emg, emb), term, ud = (
        scatter_planes(kind, param, alb, (dx, dy, dz), n, front, u0, u1, u2)
    )
    emr = emr * emit_scale
    emg = emg * emit_scale
    emb = emb * emit_scale
    skr, skg, skb = sky_planes(ud, sky)

    t_safe = jnp.where(hit, t, 1.0)
    hx_ = ox + t_safe * dx
    hy_ = oy + t_safe * dy
    hz_ = oz + t_safe * dz

    missed = mask & ~hit
    hit_m = mask & hit
    rr = rr + jnp.where(missed, tr * skr, 0.0)
    rg = rg + jnp.where(missed, tg * skg, 0.0)
    rb = rb + jnp.where(missed, tb * skb, 0.0)
    rr = rr + jnp.where(hit_m, tr * emr, 0.0)
    rg = rg + jnp.where(hit_m, tg * emg, 0.0)
    rb = rb + jnp.where(hit_m, tb * emb, 0.0)
    tr = jnp.where(hit_m, tr * atr, tr)
    tg = jnp.where(hit_m, tg * atg, tg)
    tb = jnp.where(hit_m, tb * atb, tb)
    ox = jnp.where(hit_m, hx_, ox)
    oy = jnp.where(hit_m, hy_, oy)
    oz = jnp.where(hit_m, hz_, oz)
    dx = jnp.where(hit_m, ndx, dx)
    dy = jnp.where(hit_m, ndy, dy)
    dz = jnp.where(hit_m, ndz, dz)
    return (ox, oy, oz), (dx, dy, dz), (tr, tg, tb), (rr, rg, rb), term


def scatter_pdf_lam_planes(n, d_new):
    """Plane twin of render/lights.scatter_pdf_lambertian: cos/pi of the
    normalized scatter direction (the carried MIS BSDF pdf)."""
    nx, ny, nz = n
    dx, dy, dz = d_new
    inv_len = jax.lax.rsqrt(
        jnp.maximum(dot3(dx, dy, dz, dx, dy, dz), jnp.float32(1e-20))
    )
    return (
        jnp.maximum(dot3(nx, ny, nz, dx, dy, dz) * inv_len, 0.0)
        * np.float32(1.0 / np.pi)
    )


def scatter_pdf_metal_planes(d_in, n, fuzz, d_new):
    """Plane twin of render/lights.scatter_pdf_metal: solid-angle pdf of
    the RTIOW fuzzy-metal lobe (endpoint uniform on the radius-fuzz
    sphere about the unit mirror direction); 0 for mirror metal
    (fuzz ~ 0) and outside the lobe's cone."""
    dix, diy, diz = d_in
    nx, ny, nz = n
    dx, dy, dz = d_new
    inv_len = jax.lax.rsqrt(
        jnp.maximum(dot3(dix, diy, diz, dix, diy, diz), jnp.float32(1e-20))
    )
    ux, uy, uz = dix * inv_len, diy * inv_len, diz * inv_len
    udn = dot3(ux, uy, uz, nx, ny, nz)
    rx = ux - 2.0 * udn * nx
    ry = uy - 2.0 * udn * ny
    rz = uz - 2.0 * udn * nz
    winv = jax.lax.rsqrt(
        jnp.maximum(dot3(dx, dy, dz, dx, dy, dz), jnp.float32(1e-20))
    )
    c = dot3(dx, dy, dz, rx, ry, rz) * winv
    f_ok = fuzz > jnp.float32(1e-4)
    f = jnp.maximum(fuzz, jnp.float32(1e-4))
    g2 = c * c - 1.0 + f * f
    g = jnp.sqrt(jnp.maximum(g2, jnp.float32(1e-20)))
    tp = c + g
    tm = c - g
    num = jnp.where(tp > 0.0, tp * tp, 0.0) + jnp.where(
        tm > 0.0, tm * tm, 0.0
    )
    pdf = num / (jnp.float32(4.0 * np.pi) * f * g)
    return jnp.where(f_ok & (g2 > 0.0), pdf, 0.0)


def _mis_from_lamp(n_lights, c, r2, o, pdf_b):
    """w_B = q / (q + 1), q = pdf_b * L * ip, with ip the cone inv-pdf of
    lamp (c, r2) seen from ``o`` (BIG when ``o`` is inside the lamp)."""
    cx, cy, cz = c
    ox, oy, oz = o
    tox, toy, toz = cx - ox, cy - oy, cz - oz
    dist2 = dot3(tox, toy, toz, tox, toy, toz)
    outside = dist2 > r2 * np.float32(1.0 + 1e-6)
    cos_max = jnp.sqrt(
        jnp.maximum(0.0, 1.0 - r2 / jnp.maximum(dist2, jnp.float32(1e-20)))
    )
    ip = jnp.where(
        outside, jnp.float32(2.0 * np.pi) * (1.0 - cos_max),
        jnp.float32(1e30),
    )
    q = pdf_b * np.float32(n_lights) * ip
    return q / (q + 1.0)


def bsdf_mis_scale_planes(n_lights, c, inv_r, o, pdf_b):
    """Plane twin of render/lights.bsdf_mis_scale, with the hit lamp's
    geometry taken from the hit sphere's own attributes (center, signed
    inverse radius)."""
    r2 = 1.0 / jnp.maximum(inv_r * inv_r, jnp.float32(1e-20))
    return _mis_from_lamp(n_lights, c, r2, o, pdf_b)


def bsdf_mis_scale_table_planes(light, n_lights, p_hit, o, pdf_b):
    """Plane twin of render/lights.bsdf_mis_scale for hits that carry no
    lamp geometry (the CSG tape): the lamp containing ``p_hit`` is the
    argmin of |dist(p_hit, c_l) - r_l| over the light table, the same
    search the jnp reference runs. ``light(i, j)`` reads table entry j of
    lamp i."""
    hx, hy, hz = p_hit
    best_score = None
    for i in range(n_lights):
        s = [light(i, j) for j in range(4)]
        dx_, dy_, dz_ = hx - s[0], hy - s[1], hz - s[2]
        score = jnp.abs(jnp.sqrt(dot3(dx_, dy_, dz_, dx_, dy_, dz_)) - s[3])
        if best_score is None:
            best_score = score
            cx, cy, cz, r_ = (jnp.zeros_like(hx) + v for v in s)
        else:
            better = score < best_score  # strict: first min wins (argmin)
            best_score = jnp.where(better, score, best_score)
            cx = jnp.where(better, s[0], cx)
            cy = jnp.where(better, s[1], cy)
            cz = jnp.where(better, s[2], cz)
            r_ = jnp.where(better, s[3], r_)
    return _mis_from_lamp(n_lights, (cx, cy, cz), r_ * r_, o, pdf_b)


def nee_sample_planes(light, n_lights, p, n, alb, d_in, kind, param,
                      pix_u, cur_s, b_plane, seed):
    """NEE toward one uniformly picked sphere lamp, occlusion left to the
    caller: the kernel twin of render/lights.nee_contribution (same RNG
    counters, same math). ``light(li, j)`` reads column j of each lane's
    lamp row ``li`` (a per-lane indexed load).

    Returns (ld(3), tl, w(3), lamp_id, ok): the contribution is ``w`` if
    nothing lies strictly before ``tl`` along the unit direction ``ld``
    except the lamp itself (``lamp_id``). ``w`` is zero where ``ok`` is
    False (back-facing cone, point inside the lamp, degenerate). The BSDF
    pdf paired by MIS is the cosine lobe at lambertian vertices and the
    metal lobe at glossy ones.
    """
    px, py, pz = p
    nx, ny, nz = n
    ar, ag, ab = alb
    eps = np.float32(1e-3)
    two_pi = jnp.float32(2.0 * np.pi)

    u0, u1, u2, _ = pcg4d_planes(
        pix_u, cur_s,
        b_plane | jnp.uint32(0x80000000),  # decouple from scatter RNG
        jnp.broadcast_to(seed.astype(jnp.uint32), cur_s.shape),
    )
    li = jnp.minimum(
        (u0 * np.float32(n_lights)).astype(jnp.int32), n_lights - 1
    )
    cx, cy, cz, r_, er, eg, eb, lamp_id = (light(li, j) for j in range(8))

    # cone sampling toward the sphere (render/lights.sample_sphere_cone)
    tox, toy, toz = cx - px, cy - py, cz - pz
    dist2 = dot3(tox, toy, toz, tox, toy, toz)
    r2 = r_ * r_
    outside = dist2 > r2 * np.float32(1.0 + 1e-6)
    cos_max = jnp.sqrt(
        jnp.maximum(0.0, 1.0 - r2 / jnp.maximum(dist2, jnp.float32(1e-20)))
    )
    z = 1.0 + u2 * (cos_max - 1.0)
    phi = two_pi * u1
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    inv_len = jax.lax.rsqrt(jnp.maximum(dist2, jnp.float32(1e-20)))
    wx, wy, wz = tox * inv_len, toy * inv_len, toz * inv_len
    sign = jnp.where(wz >= 0.0, 1.0, -1.0)
    a_ = -1.0 / (sign + wz)
    b_ = wx * wy * a_
    t0x, t0y, t0z = 1.0 + sign * wx * wx * a_, sign * b_, -sign * wx
    t1x, t1y, t1z = b_, sign + wy * wy * a_, -wy
    cp, sp = jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t
    ldx = cp * t0x + sp * t1x + z * wx
    ldy = cp * t0y + sp * t1y + z * wy
    ldz = cp * t0z + sp * t1z + z * wz
    inv_pdf = jnp.where(outside, two_pi * (1.0 - cos_max), 0.0)

    # analytic hit distance on the sampled lamp (render/lights.sphere_ray_t)
    half_b = -(tox * ldx + toy * ldy + toz * ldz)  # oc = p - c = -to_c
    cc = dist2 - r2
    sq = jnp.sqrt(half_b * half_b - cc)  # NaN on miss -> rejected
    tl0 = -half_b - sq
    tl1 = -half_b + sq
    tl = jnp.where(tl0 > eps, tl0, tl1)
    tl = jnp.where(tl > eps, tl, BIG)

    cos = dot3(nx, ny, nz, ldx, ldy, ldz)
    pdf_lam = jnp.maximum(cos, 0.0) * np.float32(1.0 / np.pi)
    glossy = (kind == 2.0) & (param > jnp.float32(1e-4))
    pdf_met = scatter_pdf_metal_planes(d_in, n, param, (ldx, ldy, ldz))
    pdf_met = jnp.where(cos > 0.0, pdf_met, 0.0)
    pdf_b = jnp.where(kind == 1.0, pdf_lam, jnp.where(glossy, pdf_met, 0.0))
    ok = (pdf_b > 0.0) & (inv_pdf > 0.0) & (tl < BIG_CUT)
    # balance-heuristic MIS vs the vertex's BSDF strategy folds to
    # q / (1 + q), q = pdf_b * L * ip (render/lights.nee_contribution)
    q = pdf_b * np.float32(n_lights) * inv_pdf
    scale = jnp.where(ok, q / (1.0 + q), 0.0)
    return (
        (ldx, ldy, ldz), tl,
        (ar * er * scale, ag * eg * scale, ab * eb * scale), lamp_id, ok,
    )


def wavefront(
    *,
    spp,
    max_bounces,
    seed,
    sky,
    sample_offset_u,
    pix_u,
    valid,
    camera_rays,
    seg_init,
    hit_surface,
    attrs0=(),
    walk0=(),
    grid_step=None,
    nee_sample=None,
    nee_mis=None,
):
    """The per-lane wavefront loop shared by the sphere and tape kernels.

    One ``while_loop`` runs as long as any lane of the block has a live
    path or owes samples. Each iteration every lane

    1. regenerates a camera sample if its path ended and it still owes
       some (per-lane sample and bounce counters);
    2. starts a new segment where needed: ``seg_init(o, d, t_max) ->
       (t, ident, attrs, walk)`` is the nearest hit over everything that
       is evaluated in one go (brute-forced spheres, a CSG tape), with the
       winner's id plane ``ident``, carried planes ``attrs`` and the
       traversal state ``walk`` (``walk[0]`` = march flag, or ``()``),
       shaped like the templates ``attrs0`` and ``walk0``;
    3. takes one traversal step if the scene has one: ``grid_step(walk,
       t, ident, o, d) -> (walk, t, ident)``;
    4. shades, scatters and advances the lanes whose segment is complete:
       ``hit_surface(ident, attrs, o, d, t_safe) -> dict(n, front, kind,
       param, alb)`` plus whatever ``nee_mis`` reads.

    With ``nee_sample`` (see nee_sample_planes, minus its table argument)
    a lambertian or glossy vertex turns its lane's next segment into a
    shadow ray toward the sampled lamp, bounded by the lamp distance; the
    contribution counts if nothing but the lamp itself (``ident ==
    lamp_id``) lies strictly before it, and the lane then resumes its
    stashed scattered path. Lamp emission reached by such a scatter
    carries the MIS partner weight ``nee_mis(surf, o, p_hit, pdf_b)``.

    Radiance accumulates per lane over all its samples; ``rays`` counts
    path segments (shadow segments excluded), as the jnp reference does.
    Returns the final state dict.
    """
    shape = pix_u.shape
    zero = jnp.zeros(shape, jnp.float32)
    zero_i = jnp.zeros(shape, jnp.int32)
    state0 = dict(
        o=(zero, zero, zero),
        d=(zero, zero, zero),
        thr=(zero, zero, zero),
        rad=(zero, zero, zero),
        active=zero_i,
        b_ctr=zero_i,
        cur_s=jnp.zeros(shape, jnp.uint32),
        done=jnp.where(valid, 0, spp).astype(jnp.int32),
        rays=zero_i,
        seg=zero_i,  # 1: the lane starts a new segment this iteration
        t_best=zero + BIG,
        ident=zero,
        attrs=attrs0,
        walk=walk0,
    )
    if nee_sample is not None:
        # 0 = path segment; 1 = shadow segment, the path resumes after it;
        # 2 = shadow segment, the sample is complete after it
        state0["shadow"] = zero_i
        state0["pend_d"] = (zero, zero, zero)  # stashed scattered direction
        state0["w"] = (zero, zero, zero)  # pending NEE contribution
        state0["t_lamp"] = zero
        state0["lamp_id"] = zero
        state0["prevpdf"] = zero  # pdf of the scatter that made the ray

    def wave_cond(st):
        has_work = (st["active"] > 0) | (st["done"] < spp)
        return jnp.max(has_work.astype(jnp.int32)) > 0

    def sel(mask, new, old):
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(mask, a, b), new, old
        )

    def wave_step(st):
        # 1. regenerate dead lanes that still owe samples
        regen = (st["active"] == 0) & (st["done"] < spp)
        s_new = st["done"].astype(jnp.uint32) + sample_offset_u
        go, gd = camera_rays(s_new)
        o = sel(regen, go, st["o"])
        d = sel(regen, gd, st["d"])
        thr = sel(regen, (zero + 1.0,) * 3, st["thr"])
        cur_s = jnp.where(regen, s_new, st["cur_s"])
        b_ctr = jnp.where(regen, 0, st["b_ctr"])
        done = st["done"] + regen.astype(jnp.int32)
        active = jnp.where(regen, 1, st["active"])
        seg = jnp.where(regen, 1, st["seg"])
        rad = st["rad"]

        # 2. new segments: nearest hit over what is evaluated in one go
        if nee_sample is not None:
            shadow_st = st["shadow"]
            t_max = jnp.where(shadow_st > 0, st["t_lamp"], BIG)
        else:
            t_max = zero + BIG
        t_n, id_n, attrs_n, walk_n = seg_init(o, d, t_max)
        fresh = (seg > 0) & (active > 0)
        t_best = jnp.where(fresh, t_n, st["t_best"])
        ident = jnp.where(fresh, id_n, st["ident"])
        attrs = sel(fresh, attrs_n, st["attrs"])
        walk = sel(fresh, walk_n, st["walk"])

        # 3. one traversal step (lanes not marching step the pad cell)
        if grid_step is not None:
            walk, t_best, ident = grid_step(walk, t_best, ident, o, d)
            finish = (active > 0) & (walk[0] == 0)
        else:
            finish = active > 0

        # 4. shade the lanes whose segment is complete
        if nee_sample is not None:
            path_fin = finish & (shadow_st == 0)
            shad_fin = finish & (shadow_st > 0)
        else:
            path_fin = finish
        hit = t_best < BIG_CUT
        t_safe = jnp.where(hit, t_best, 1.0)
        surf = hit_surface(ident, attrs, o, d, t_safe)
        n, kind, param, alb = surf["n"], surf["kind"], surf["param"], surf["alb"]
        ox, oy, oz = o
        dx, dy, dz = d
        d_in = d

        if nee_sample is not None:
            p_hit = (ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz)
            prevpdf = jnp.where(regen, 0.0, st["prevpdf"])
            w_b = nee_mis(surf, o, p_hit, prevpdf)
            emit_scale = jnp.where(
                (kind == 4.0) & (prevpdf > 0.0) & (b_ctr > 0), w_b, 1.0
            )
            ld, tl, w3, lamp, nee_ok = nee_sample(
                p_hit, n, alb, d_in, kind, param, pix_u, cur_s,
                b_ctr.astype(jnp.uint32),
            )
            glossy = (kind == 2.0) & (param > jnp.float32(1e-4))
            nee_mask = path_fin & hit & ((kind == 1.0) | glossy)
            nee_go = nee_mask & nee_ok
        else:
            emit_scale = zero + 1.0

        thr_v = thr  # throughput at the vertex, before its attenuation
        o, d, thr, rad, term = shade_and_advance(
            path_fin, t_best, hit, n, surf["front"], kind, param, alb,
            o, d, thr, rad, pix_u, cur_s, b_ctr.astype(jnp.uint32), seed,
            sky, emit_scale,
        )
        rays = st["rays"] + path_fin.astype(jnp.int32)
        b_ctr = b_ctr + path_fin.astype(jnp.int32)
        cont = path_fin & hit & ~term & (b_ctr < max_bounces)
        active = jnp.where(path_fin, cont.astype(jnp.int32), active)
        seg = cont.astype(jnp.int32)  # continuing lanes start a new segment

        out = dict(
            o=o, rad=rad, thr=thr, active=active, b_ctr=b_ctr, cur_s=cur_s,
            done=done, rays=rays, t_best=t_best, ident=ident, attrs=attrs,
            walk=walk,
        )
        if nee_sample is not None:
            # pdf of this scatter, for the NEXT segment's MIS weight
            # (computed while d is still the scattered direction)
            kind_lam = kind == 1.0
            prevpdf = jnp.where(
                path_fin,
                jnp.where(
                    cont & kind_lam, scatter_pdf_lam_planes(n, d),
                    jnp.where(
                        cont & glossy,
                        scatter_pdf_metal_planes(d_in, n, param, d), 0.0,
                    ),
                ),
                prevpdf,
            )
            # start shadow segments: stash the scattered direction and
            # aim the lane at the lamp; the vertex's throughput rides in w
            w_pend = tuple(t_ * w_ for t_, w_ in zip(thr_v, w3))
            pend_d = sel(nee_go, d, st["pend_d"])
            d = sel(nee_go, ld, d)
            w_st = sel(nee_go, w_pend, st["w"])
            t_lamp = jnp.where(nee_go, tl, st["t_lamp"])
            lamp_st = jnp.where(nee_go, lamp, st["lamp_id"])
            shadow = jnp.where(nee_go, jnp.where(cont, 1, 2), shadow_st)
            active = jnp.where(nee_go, 1, active)
            seg = jnp.where(nee_go, 1, seg)

            # finish shadow segments: visible iff nothing but the sampled
            # lamp lies strictly before it; then resume the stashed path
            occluded = (
                (t_best < t_lamp * np.float32(1.0 - 1e-4))
                & (ident != lamp_st)
            )
            vis = shad_fin & ~occluded
            rad = tuple(
                r_ + jnp.where(vis, w_, 0.0) for r_, w_ in zip(rad, w_st)
            )
            d = sel(shad_fin, pend_d, d)
            resume = shad_fin & (shadow_st == 1)
            active = jnp.where(shad_fin, resume.astype(jnp.int32), active)
            seg = jnp.where(resume, 1, seg)
            shadow = jnp.where(shad_fin, 0, shadow)
            out.update(
                rad=rad, active=active, shadow=shadow, pend_d=pend_d, w=w_st,
                t_lamp=t_lamp, lamp_id=lamp_st, prevpdf=prevpdf,
            )
        out["d"] = d
        out["seg"] = seg
        return out

    return jax.lax.while_loop(wave_cond, wave_step, state0)


def launch(kernel, n_pix, inputs, interpret, name):
    """Run ``kernel`` over ceil(n_pix / BLOCK) programs on the Triton route.

    Every input is one whole-array block (scalars and tables are read by
    index); the outputs are the per-lane radiance planes and ray counts.
    Returns (r, g, b, rays), each [n_blocks * BLOCK].
    """
    n_blocks = pl.cdiv(n_pix, BLOCK)
    plane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((n_blocks * BLOCK,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n_blocks * BLOCK,), jnp.int32)
    return pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[
            pl.BlockSpec(x.shape, lambda i, nd=x.ndim: (0,) * nd)
            for x in inputs
        ],
        out_specs=(plane, plane, plane, plane),
        out_shape=(f32, f32, f32, i32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=name,
    )(*inputs)


def program_pixels(n_pix, pixel_offset, width):
    """This program's lanes: (global pixel id as uint32, px, py, valid).

    RNG counters and camera coordinates use GLOBAL pixel ids, so any row
    sharding of the image reproduces the single-device render exactly."""
    local = pl.program_id(0) * BLOCK + jax.lax.broadcasted_iota(
        jnp.int32, (BLOCK,), 0
    )
    pix = local + pixel_offset
    px = (pix % width).astype(jnp.float32)
    py = (pix // width).astype(jnp.float32)
    return pix.astype(jnp.uint32), px, py, local < n_pix


def finish_image(r, g, b, rays, n_pix, rows, width, spp):
    """Kernel planes -> (radiance [rows, width, 3], total rays)."""
    flat = jnp.stack([r, g, b], axis=-1)[:n_pix]
    return flat.reshape(rows, width, 3) / spp, jnp.sum(rays)
