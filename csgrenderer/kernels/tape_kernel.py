"""Pallas-Triton kernel for CSG tapes: the project's subject on the card.

Evaluates a CompiledTape (scene/tape.py) per lane inside the fused
path-tracing loop of common.py, by EVENT-FLIP evaluation: the nearest CSG
surface is the smallest leaf-boundary t where the root's boolean
membership flips, and membership just below/above a boundary t is exact
comparison algebra on the raw leaf intervals,

    below_i = (enter_i <  t) & (exit_i >= t)
    above_i = (enter_i <= t) & (exit_i >  t),

folded through the postfix tape as one max/min per combine. The fold is
static, so Triton unrolls it into straight-line code: O(L^2) operations
per ray, no interval capacity (nothing is ever truncated, whatever
``tape.k`` says) and no epsilon probing. The ``entering`` flag (did
membership go false -> true?) is the solid-level front face dielectrics
need, correct on subtracted surfaces where a dot-product test is not.

``clusters`` (scene/partition.py): when the root unions spatially
disjoint groups of solids, each group's flips are evaluated against its
own sub-tape and leaves only and the results min-combine, O(sum L_c^2)
instead of O(L^2), exact under disjoint bounds.

Surface attribution: every leaf scores |distance to its surface| at the
hit point and a running argmin keeps the owner's normal and material,
as render/tape_eval.py does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..camera.pinhole import Camera
from ..scene.graph import NodeType
from ..scene.tape import OP_INTERSECT, OP_PUSH, OP_UNION, CompiledTape
from .common import (
    BIG,
    LIGHT_ROW,
    bsdf_mis_scale_table_planes,
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

T_FAR = np.float32(1e9)
_CUT = np.float32(5e8)
EPS = np.float32(1e-3)

_PARTITION_CACHE: dict = {}

# leaf table row (f32): 0-3 world->local quaternion (wxyz), 4-6 leaf
# origin, 7-10 params, 11 kind, 12 mat_param, 13-15 albedo
LEAF_ROW = 16


def _rotate(qw, qx, qy, qz, vx, vy, vz):
    """Rotate plane-vector v by quaternion q (v + 2 cross-form)."""
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    return (
        vx + qw * tx + (qy * tz - qz * ty),
        vy + qw * ty + (qz * tx - qx * tz),
        vz + qw * tz + (qx * ty - qy * tx),
    )


def leaf_interval(ltype, c, o, d):
    """(enter, exit) planes of one leaf along o + t d; empty as enter > exit.

    ``c`` = the leaf's 16 table scalars. Semantics identical to the
    interval functions of render/intersect.py.
    """
    qw, qx, qy, qz = c[0], c[1], c[2], c[3]
    lox, loy, loz = _rotate(qw, qx, qy, qz, o[0] - c[4], o[1] - c[5],
                            o[2] - c[6])
    ldx, ldy, ldz = _rotate(qw, qx, qy, qz, d[0], d[1], d[2])
    p0, p1, p2 = c[7], c[8], c[9]
    far = jnp.full_like(lox, T_FAR)
    neg = -far

    if ltype == NodeType.SPHERE:
        a = dot3(ldx, ldy, ldz, ldx, ldy, ldz)
        hb = dot3(lox, loy, loz, ldx, ldy, ldz)
        cc = dot3(lox, loy, loz, lox, loy, loz) - p0 * p0
        disc = hb * hb - a * cc
        ok = disc >= 0.0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        inv_a = 1.0 / a
        return (
            jnp.where(ok, (-hb - sq) * inv_a, far),
            jnp.where(ok, (-hb + sq) * inv_a, neg),
        )
    if ltype == NodeType.INFINITE_PLANAR_PARTITION:
        dn = dot3(ldx, ldy, ldz, p0, p1, p2)
        on = dot3(lox, loy, loz, p0, p1, p2)
        t0 = -on / dn
        entering = dn < 0.0
        parallel = dn == 0.0
        inside = parallel & (on <= 0.0)
        enter = jnp.where(entering, t0, neg)
        exit_ = jnp.where(entering, far, t0)
        enter = jnp.where(parallel, jnp.where(inside, neg, far), enter)
        exit_ = jnp.where(parallel, jnp.where(inside, far, neg), exit_)
        return enter, exit_
    if ltype == NodeType.BOX:
        enter, exit_ = None, None
        for lo_, ld_, he in ((lox, ldx, p0), (loy, ldy, p1), (loz, ldz, p2)):
            safe = jnp.where(ld_ == 0.0, jnp.float32(1.0), ld_)
            inv = 1.0 / safe
            ta = (-he - lo_) * inv
            tb = (he - lo_) * inv
            t_lo = jnp.minimum(ta, tb)
            t_hi = jnp.maximum(ta, tb)
            in_slab = jnp.abs(lo_) <= he
            t_lo = jnp.where(ld_ == 0.0, jnp.where(in_slab, neg, far), t_lo)
            t_hi = jnp.where(ld_ == 0.0, jnp.where(in_slab, far, neg), t_hi)
            enter = t_lo if enter is None else jnp.maximum(enter, t_lo)
            exit_ = t_hi if exit_ is None else jnp.minimum(exit_, t_hi)
        return enter, exit_
    if ltype == NodeType.CYLINDER:
        a = ldx * ldx + ldz * ldz
        hb = lox * ldx + loz * ldz
        cc = lox * lox + loz * loz - p0 * p0
        disc = hb * hb - a * cc
        ok = disc >= 0.0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        degen = a == 0.0
        inv_a = 1.0 / jnp.where(degen, jnp.float32(1.0), a)
        s_enter = jnp.where(ok, (-hb - sq) * inv_a, far)
        s_exit = jnp.where(ok, (-hb + sq) * inv_a, neg)
        in_tube = cc <= 0.0
        s_enter = jnp.where(degen, jnp.where(in_tube, neg, far), s_enter)
        s_exit = jnp.where(degen, jnp.where(in_tube, far, neg), s_exit)
        safe = jnp.where(ldy == 0.0, jnp.float32(1.0), ldy)
        ta = (-p1 - loy) / safe
        tb = (p1 - loy) / safe
        c_lo = jnp.minimum(ta, tb)
        c_hi = jnp.maximum(ta, tb)
        in_y = jnp.abs(loy) <= p1
        c_lo = jnp.where(ldy == 0.0, jnp.where(in_y, neg, far), c_lo)
        c_hi = jnp.where(ldy == 0.0, jnp.where(in_y, far, neg), c_hi)
        return jnp.maximum(s_enter, c_lo), jnp.minimum(s_exit, c_hi)
    raise ValueError(f"bad leaf type {ltype}")


def event_flip(ops, leaf_types, leaf, o, d, clusters=None):
    """Nearest CSG boundary along o + t d (t > EPS) by event flips.

    ``leaf(l, j)`` reads scalar j of leaf l. Returns (t, entering) planes:
    t = T_FAR on a miss, entering as int32 0/1. ``clusters``: a tuple of
    (sub_ops, leaf ids) groups whose flips are evaluated separately.
    """
    def intervals(leaves):
        out = {}
        for l in leaves:
            out[l] = leaf_interval(
                leaf_types[l], [leaf(l, j) for j in range(LEAF_ROW)], o, d
            )
        return out

    def events_for(sub_ops, sub_leaves, t, entering):
        # the group's leaf intervals are made here, so that only one
        # group's intervals are live at a time (register pressure)
        iv = intervals(sub_leaves)

        def tree(mem):
            # memberships as int32 0/1: union = max, intersect = min,
            # difference = min(a, 1 - b); a flip is below + above == 1
            stack = []
            for opcode, operand in sub_ops:
                if opcode == OP_PUSH:
                    stack.append(mem[operand])
                    continue
                right = stack.pop()
                left = stack.pop()
                if opcode == OP_UNION:
                    stack.append(jnp.maximum(left, right))
                elif opcode == OP_INTERSECT:
                    stack.append(jnp.minimum(left, right))
                else:  # OP_DIFF
                    stack.append(jnp.minimum(left, 1 - right))
            return stack[0]

        for l in sub_leaves:
            for tj in iv[l]:
                below = {
                    i: ((e < tj) & (x >= tj)).astype(jnp.int32)
                    for i, (e, x) in iv.items()
                }
                above = {
                    i: ((e <= tj) & (x > tj)).astype(jnp.int32)
                    for i, (e, x) in iv.items()
                }
                ma = tree(above)
                flip = (tree(below) + ma == 1) & (tj > EPS) & (tj < _CUT)
                cand = jnp.where(flip, tj, T_FAR)
                better = cand < t
                t = jnp.where(better, cand, t)
                entering = jnp.where(better, ma, entering)
        return t, entering

    t = jnp.full_like(o[0], T_FAR)
    entering = jnp.zeros(t.shape, jnp.int32)
    if clusters is None:
        clusters = ((ops, tuple(range(len(leaf_types)))),)
    for c_ops, c_leaves in clusters:
        t, entering = events_for(c_ops, c_leaves, t, entering)
    return t, entering


def attribute(leaf_types, leaf, p):
    """Owner leaf of hit point ``p``: (world normal(3), kind, param,
    albedo(3)) of the leaf whose surface is nearest to p (first on ties)."""
    hpx, hpy, hpz = p
    best = None
    for l, lt in enumerate(leaf_types):
        c = [leaf(l, j) for j in range(LEAF_ROW)]
        qw, qx, qy, qz = c[0], c[1], c[2], c[3]
        lx, ly, lz = _rotate(qw, qx, qy, qz, hpx - c[4], hpy - c[5],
                             hpz - c[6])
        p0, p1, p2 = c[7], c[8], c[9]
        if lt == NodeType.SPHERE:
            rad = jnp.sqrt(dot3(lx, ly, lz, lx, ly, lz))
            score = jnp.abs(rad - p0)
            inv = 1.0 / jnp.maximum(rad, jnp.float32(1e-12))
            nlx, nly, nlz = lx * inv, ly * inv, lz * inv
        elif lt == NodeType.INFINITE_PLANAR_PARTITION:
            score = jnp.abs(dot3(lx, ly, lz, p0, p1, p2))
            nlx = jnp.zeros_like(lx) + p0
            nly = jnp.zeros_like(ly) + p1
            nlz = jnp.zeros_like(lz) + p2
        elif lt == NodeType.BOX:
            gx = p0 - jnp.abs(lx)
            gy = p1 - jnp.abs(ly)
            gz = p2 - jnp.abs(lz)
            # exact |SDF| to the finite surface (matches tape_eval)
            mx = jnp.maximum(-gx, 0.0)
            my = jnp.maximum(-gy, 0.0)
            mz = jnp.maximum(-gz, 0.0)
            outside = jnp.sqrt(mx * mx + my * my + mz * mz)
            inside = jnp.minimum(jnp.maximum(-gx, jnp.maximum(-gy, -gz)), 0.0)
            score = outside - inside
            # outward normal: the axis with the smallest gap
            is_x = (jnp.abs(gx) <= jnp.abs(gy)) & (jnp.abs(gx) <= jnp.abs(gz))
            is_y = ~is_x & (jnp.abs(gy) <= jnp.abs(gz))
            nlx = jnp.where(is_x, jnp.where(lx >= 0.0, 1.0, -1.0), 0.0)
            nly = jnp.where(is_y, jnp.where(ly >= 0.0, 1.0, -1.0), 0.0)
            nlz = jnp.where(is_x | is_y, 0.0, jnp.where(lz >= 0.0, 1.0, -1.0))
        elif lt == NodeType.CYLINDER:
            srad = jnp.sqrt(lx * lx + lz * lz)
            side = jnp.abs(srad - p0)
            cap = jnp.abs(jnp.abs(ly) - p1)
            # exact |SDF| in (radial, axial) coords (matches tape_eval)
            sqr = srad - p0
            sqy = jnp.abs(ly) - p1
            mr = jnp.maximum(sqr, 0.0)
            mh = jnp.maximum(sqy, 0.0)
            outside = jnp.sqrt(mr * mr + mh * mh)
            inside = jnp.minimum(jnp.maximum(sqr, sqy), 0.0)
            score = outside - inside
            inv = 1.0 / jnp.maximum(srad, jnp.float32(1e-12))
            use_side = side < cap
            nlx = jnp.where(use_side, lx * inv, 0.0)
            nly = jnp.where(use_side, 0.0, jnp.where(ly >= 0.0, 1.0, -1.0))
            nlz = jnp.where(use_side, lz * inv, 0.0)
        else:
            raise ValueError(f"bad leaf type {lt}")
        # local -> world normal: rotate by conj(q)
        nwx, nwy, nwz = _rotate(qw, -qx, -qy, -qz, nlx, nly, nlz)
        cand = (score, nwx, nwy, nwz, c[11], c[12], c[13], c[14], c[15])
        if best is None:
            best = [jnp.zeros_like(score) + v for v in cand]
        else:
            better = cand[0] < best[0]
            best = [jnp.where(better, new, old) for new, old in zip(cand, best)]
    (_, nwx, nwy, nwz, kind, param, ar, ag, ab) = best
    return (nwx, nwy, nwz), kind, param, (ar, ag, ab)


def pack_leaves(tape: CompiledTape) -> jax.Array:
    """The kernel's flat leaf table [L * LEAF_ROW] (jit-safe: animated
    tapes pack their per-frame leaf transforms on the device)."""
    tab = jnp.concatenate([
        tape.leaf_rot, tape.leaf_pos, tape.leaf_params,
        tape.mat_kind.astype(jnp.float32)[:, None], tape.mat_param[:, None],
        tape.albedo,
    ], axis=1).astype(jnp.float32)
    return pad_pow2(tab)


def pack_tape_lights(tape: CompiledTape, lamps) -> jax.Array:
    """Light table of the emissive sphere leaves ``lamps`` (jit-safe).
    Lamp id -2: a tape has no per-surface ids, so shadow rays use the
    distance rule only."""
    idx = np.asarray(lamps, np.int32)
    n = idx.shape[0]
    tab = jnp.concatenate([
        tape.leaf_pos[idx], tape.leaf_params[idx, 0:1], tape.albedo[idx],
        jnp.full((n, 1), -2.0, jnp.float32),
    ], axis=1)
    return pad_pow2(tab)


def _make_kernel(*, ops, leaf_types, width, height, spp, max_bounces, lens,
                 sky, n_pix, nee_lamps, clusters):
    inv_w = np.float32(1.0 / width)
    inv_h = np.float32(1.0 / height)
    n_lights = len(nee_lamps)

    def kernel(cam_ref, meta_ref, leaf_ref, *rest):
        rest = list(rest)
        light_ref = rest.pop(0) if n_lights else None
        out_r, out_g, out_b, rays_ref = rest
        seed = meta_ref[0]
        cam = [cam_ref[i] for i in range(19)]
        pix_u, px, py, valid = program_pixels(n_pix, meta_ref[2], width)

        def leaf(l, j):
            return leaf_ref[l * LEAF_ROW + j]

        def seg_init(o, d, t_max):
            t, entering = event_flip(ops, leaf_types, leaf, o, d, clusters)
            t = jnp.where(t < _CUT, t, BIG)
            return t, jnp.full_like(t, -1.0), (entering,), ()

        def hit_surface(ident, attrs, o, d, t_safe):
            p = tuple(oc + t_safe * dc for oc, dc in zip(o, d))
            (nx, ny, nz), kind, param, alb = attribute(leaf_types, leaf, p)
            # face-forward the leaf normal against the ray
            sgn = jnp.where(dot3(d[0], d[1], d[2], nx, ny, nz) > 0.0, -1.0,
                            1.0)
            return dict(
                n=(nx * sgn, ny * sgn, nz * sgn), front=attrs[0] > 0,
                kind=kind, param=param, alb=alb,
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
                return bsdf_mis_scale_table_planes(
                    light, n_lights, p_hit, o, pdf_b
                )

        zero_i = jnp.zeros(pix_u.shape, jnp.int32)
        state = wavefront(
            spp=spp, max_bounces=max_bounces, seed=seed, sky=sky,
            sample_offset_u=meta_ref[1].astype(jnp.uint32), pix_u=pix_u,
            valid=valid, camera_rays=camera_rays, seg_init=seg_init,
            hit_surface=hit_surface, attrs0=(zero_i,),
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
        "nee_lamps", "clusters", "interpret",
    ),
)
def _render_tape_packed(tape, camera, seed, sample_offset, row_offset, *,
                        width, height, rows, spp, max_bounces, lens, sky,
                        nee_lamps, clusters, interpret):
    n_pix = width * rows  # this slab's pixel count (rows == height unsharded)
    kernel = _make_kernel(
        ops=tape.ops, leaf_types=tape.leaf_types, width=width, height=height,
        spp=spp, max_bounces=max_bounces, lens=lens, sky=sky, n_pix=n_pix,
        nee_lamps=nee_lamps, clusters=clusters,
    )
    inputs = [
        pack_camera(camera), pack_meta(seed, sample_offset, row_offset, width),
        pack_leaves(tape),
    ]
    if nee_lamps:
        inputs.append(pack_tape_lights(tape, nee_lamps))
    r, g, b, rays = launch(kernel, n_pix, inputs, interpret, "tape_wavefront")
    return finish_image(r, g, b, rays, n_pix, rows, width, spp)


def render_image_tape_pallas(
    tape: CompiledTape,
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
    partition: bool | str | tuple = "auto",
):
    """Drop-in for ``integrator.render_image`` on a CompiledTape scene.

    ``rows``/``row_offset`` render a full-width horizontal slab (see
    megakernel.render_image_pallas).

    ``nee=True`` enables MIS next-event estimation toward the tape's
    emissive SPHERE leaves (render/lights.extract_tape_lights); the lamp
    table is packed from the tape's own leaf arrays on every call, so
    animated lamps stay correct.

    ``partition``: "auto" decomposes a root that unions spatially disjoint
    solid groups into per-cluster event evaluation (scene/partition.py);
    False forces the global evaluation; True requires clusters. A TUPLE
    is a precomputed cluster tuple (``partition_tape``'s return value) used
    as-is: the animated path (app/renderers.py) re-clusters per frame on a
    host-side CPU twin of the tape and passes the result here. An empty
    tuple means reclustering found nothing to split.
    """
    if not jitter:
        raise NotImplementedError("the tape kernel always jitters")
    nee_lamps = ()
    if nee:
        from ..render.lights import extract_tape_lights

        lights, lamp_ids = extract_tape_lights(tape, return_ids=True)
        if lights is None:
            raise ValueError(
                "nee=True but the tape has no emissive sphere leaves"
            )
        nee_lamps = tuple(int(i) for i in lamp_ids)
    clusters = None
    if isinstance(partition, tuple):
        clusters = partition if partition else None
    elif partition in (True, "auto"):
        from ..scene.partition import partition_tape

        clusters = device_cache(
            _PARTITION_CACHE,
            (id(tape.leaf_pos), id(tape.leaf_params), tape.ops),
            tape.leaf_pos,
            lambda: partition_tape(tape),
        )
        if partition is True and clusters is None:
            raise ValueError(
                "partition=True but the tape has no disjoint union "
                "operands to cluster"
            )
    return _render_tape_packed(
        tape, camera, jnp.asarray(seed, jnp.int32),
        jnp.asarray(sample_offset, jnp.int32),
        jnp.asarray(row_offset, jnp.int32),
        width=width, height=height, rows=height if rows is None else rows,
        spp=spp, max_bounces=max_bounces, lens=lens, sky=sky,
        nee_lamps=nee_lamps, clusters=clusters, interpret=interpret,
    )
