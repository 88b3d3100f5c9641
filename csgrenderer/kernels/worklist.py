"""Per-cell sphere worklists for the sphere kernel: grid packer + DDA step.

Brute force tests every sphere for every ray segment. RTIOW-style scenes
are a field of small spheres in a thin slab over a ground sphere, so the
candidate set per ray shrinks to a handful once the slab is binned:

- Host packer (``pack_grid``): small spheres confined to a thin y-slab are
  binned into a Cx x Cz grid over xz (circle-rectangle overlap, so every
  cell lists EVERY sphere whose surface can appear inside it). Oversized /
  outlier spheres stay "global" and keep the brute-force path (ground +
  hero spheres in the RTIOW scene). Cells that overflow the m slots spill
  their widest spheres to globals: correct, just slower.
- Kernel fragments (``grid_setup`` / ``grid_step``): per-lane 2D DDA over
  the grid. Each step reads the lane's own cell from the f32 table with
  per-lane indexed loads and tests its m slots. A lane stops when its best
  hit precedes the next cell (cells are visited in increasing ray-t, so
  this is exact), when it leaves the grid/slab, or when it passes the
  globals' best hit.

The sphere kernel fuses ONE grid step per lane into each iteration of its
wavefront loop: segments need ~1.3 steps on average but the slowest lane
of a block needs many more, and a nested walk would run every lane to the
slowest one's pace.

Correctness of the early exit: a sphere's every surface point lies in some
cell of the grid (the grid bbox is inflated by each sphere's radius), and
that cell lists the sphere; the DDA visits cells in increasing t, so any
hit with t before the current cell's entry was already found earlier.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..render.intersect import expanded_form
from .common import BIG

PAD_R2 = np.float32(-1e30)  # pad slots: the discriminant goes negative
SLOT = 8  # table stride per slot: cx, cy, cz, r^2, sphere id, 3 pad


class GridStatic(NamedTuple):
    """Hashable static grid config baked into the kernel at trace time."""

    cx: int  # cells along x
    cz: int  # cells along z
    m: int  # worklist slots per cell
    x0: float
    z0: float
    cell: float  # cell edge length (square cells)
    y_lo: float
    y_hi: float

    @property
    def pad_cell(self) -> int:
        """Index of the all-miss cell that non-marching lanes read."""
        return self.cx * self.cz


class GridPack(NamedTuple):
    static: GridStatic
    table: np.ndarray  # [(cells + 1) * m * SLOT] f32
    n_globals: int  # globals occupy reordered indices [0, n_globals)


def _overlap_lists(cgrid, rgrid, x0, z0, cell, ncx, ncz):
    """Per-cell candidate lists via circle-rectangle overlap (numpy)."""
    lists: list[list[int]] = [[] for _ in range(ncx * ncz)]
    for i in range(cgrid.shape[0]):
        cx_, cz_, r = cgrid[i, 0], cgrid[i, 2], rgrid[i]
        ix0 = max(0, int(np.floor((cx_ - r - x0) / cell)))
        ix1 = min(ncx - 1, int(np.floor((cx_ + r - x0) / cell)))
        iz0 = max(0, int(np.floor((cz_ - r - z0) / cell)))
        iz1 = min(ncz - 1, int(np.floor((cz_ + r - z0) / cell)))
        for ix in range(ix0, ix1 + 1):
            # nearest point of the cell's x-range to the center
            nx = np.clip(cx_, x0 + ix * cell, x0 + (ix + 1) * cell)
            for iz in range(iz0, iz1 + 1):
                nz = np.clip(cz_, z0 + iz * cell, z0 + (iz + 1) * cell)
                if (nx - cx_) ** 2 + (nz - cz_) ** 2 <= r * r + 1e-12:
                    lists[ix * ncz + iz].append(i)
    return lists


_PACK_CACHE: dict = {}


def pack_grid(
    scene,
    m: int = 8,
    max_cells: int = 32 * 32,
    min_grid_spheres: int = 48,
    radius_factor: float = 4.0,
):
    """Build a GridPack for a SphereScene, or None if a grid won't help.

    Returns (pack, reordered_scene). Small spheres (radius <= radius_factor
    x median radius) that fit a thin y-slab go into the grid; everything
    else stays global. The reordered scene puts globals first so the brute
    pass's sphere indices are already scene-table indices.

    Everything returned is numpy (host-side packing). Results are memoized
    on the scene's array identities: a progressive renderer calls this
    every frame with the same immutable scene.
    """
    from ..render.integrator import SphereScene

    key = (id(scene.centers), id(scene.radii), m, max_cells)
    cached = _PACK_CACHE.get(key)
    if cached is not None and cached[0] is scene.centers:
        return cached[1]

    def _memo(result):
        if len(_PACK_CACHE) > 32:
            _PACK_CACHE.clear()
        _PACK_CACHE[key] = (scene.centers, result)
        return result

    c = np.asarray(scene.centers, np.float64)
    r_signed = np.asarray(scene.radii, np.float64)
    r = np.abs(r_signed)  # negative radius = flipped normal, same geometry
    s = c.shape[0]
    if s < min_grid_spheres:
        return _memo(None)

    med = float(np.median(r))
    # grid slots use the o - c form of the quadratic: spheres that the
    # reference expands instead stay global (intersect.expanded_form)
    small = (r <= radius_factor * med) & ~expanded_form(c, r, np)
    if int(small.sum()) < min_grid_spheres:
        return _memo(None)

    # the slab must be thin relative to the xz extent, else a 2D grid is the
    # wrong spatial structure for this scene
    y_lo = float(np.min(c[small, 1] - r[small]))
    y_hi = float(np.max(c[small, 1] + r[small]))
    ex_x = float(np.max(c[small, 0] + r[small]) - np.min(c[small, 0] - r[small]))
    ex_z = float(np.max(c[small, 2] + r[small]) - np.min(c[small, 2] - r[small]))
    if (y_hi - y_lo) > 0.5 * max(ex_x, ex_z):
        return _memo(None)

    x0 = float(np.min(c[small, 0] - r[small]))
    x1 = float(np.max(c[small, 0] + r[small]))
    z0 = float(np.min(c[small, 2] - r[small]))
    z1 = float(np.max(c[small, 2] + r[small]))

    idx_small = np.where(small)[0]
    cgrid = c[idx_small]
    rgrid = r[idx_small]

    # choose the LARGEST cell (fewest DDA steps) whose worst cell still
    # fits m slots; spill overfull cells' widest spheres to globals if even
    # the densest grid can't fit
    best = None
    best_candidate = None
    target = max(ex_x, ex_z)
    for n_side in (6, 7, 8, 9, 10, 11, 12, 14, 16, 20, 24, 28, 32):
        cell = target / n_side + 1e-9
        ncx = max(1, int(np.ceil((x1 - x0) / cell)))
        ncz = max(1, int(np.ceil((z1 - z0) / cell)))
        if ncx * ncz > max_cells:
            break
        lists = _overlap_lists(cgrid, rgrid, x0, z0, cell, ncx, ncz)
        worst = max((len(l) for l in lists), default=0)
        if worst <= m:
            best = (cell, ncx, ncz, lists, [])
            break
        best_candidate = (cell, ncx, ncz, lists)
    if best is None:
        if best_candidate is None:
            return _memo(None)
        cell, ncx, ncz, lists = best_candidate
        spilled: set[int] = set()
        changed = True
        while changed:
            changed = False
            for l in lists:
                live = [i for i in l if i not in spilled]
                if len(live) > m:
                    live_sorted = sorted(live, key=lambda i: -rgrid[i])
                    for i in live_sorted[: len(live) - m]:
                        spilled.add(i)
                    changed = True
        lists = [[i for i in l if i not in spilled] for l in lists]
        best = (cell, ncx, ncz, lists, sorted(spilled))
        if len(spilled) > 0.25 * len(idx_small):
            return _memo(None)

    cell, ncx, ncz, lists, spilled_local = best
    spilled_set = set(spilled_local)
    grid_local = [i for i in range(len(idx_small)) if i not in spilled_set]
    grid_orig = idx_small[grid_local]
    global_orig = np.setdiff1d(np.arange(s), grid_orig)

    order = np.concatenate([global_orig, grid_orig])
    inv = np.empty(s, np.int64)
    inv[order] = np.arange(s)

    table = np.zeros((ncx * ncz + 1, m, SLOT), np.float32)
    table[:, :, 3] = PAD_R2  # empty slots and the pad cell always miss
    for cell_i, l in enumerate(lists):
        live = [i for i in l if i not in spilled_set]
        assert len(live) <= m
        for slot, i in enumerate(live):
            table[cell_i, slot, 0:3] = cgrid[i]
            table[cell_i, slot, 3] = rgrid[i] * rgrid[i]
            table[cell_i, slot, 4] = inv[idx_small[i]]  # reordered id

    reordered = SphereScene(
        centers=np.asarray(scene.centers)[order],
        radii=np.asarray(scene.radii)[order],
        mat_kind=np.asarray(scene.mat_kind)[order],
        albedo=np.asarray(scene.albedo)[order],
        mat_param=np.asarray(scene.mat_param)[order],
    )
    static = GridStatic(
        cx=ncx, cz=ncz, m=m, x0=x0, z0=z0, cell=float(cell),
        y_lo=y_lo, y_hi=y_hi,
    )
    pack = GridPack(
        static=static, table=table.reshape(-1), n_globals=len(global_orig),
    )
    return _memo((pack, reordered))


# ---------------------------------------------------------------------------
# kernel-side fragments (trace-time builders over per-lane planes)
# ---------------------------------------------------------------------------


def grid_setup(gs: GridStatic, o, d, t_bound):
    """DDA init for fresh segments.

    Returns the walk tuple (march, ix, iz, tmaxx, tmaxz, tdx, tdz, t_out);
    tdx/tdz are the per-axis t increments (cell / |d|), carried so that
    grid_step needs no divides. ``t_bound`` (the globals' best hit, or a
    shadow ray's lamp distance) bounds the walk: cells beyond it cannot
    hold a nearer hit.
    """
    ox, oy, oz = o
    dx, dy, dz = d
    eps_y = np.float32(1e-12)
    inv_cell = np.float32(1.0 / gs.cell)

    # one reciprocal per axis, shared by the slab ranges and the DDA init
    inv_dx = 1.0 / dx  # +-inf on zero: masked via flat_* below
    inv_dy = 1.0 / dy
    inv_dz = 1.0 / dz

    def axis_range(o_c, d_c, inv, lo, hi):
        t0 = (np.float32(lo) - o_c) * inv
        t1 = (np.float32(hi) - o_c) * inv
        lo_t = jnp.minimum(t0, t1)
        hi_t = jnp.maximum(t0, t1)
        # |d| ~ 0: inside -> (-BIG, BIG), outside -> empty
        flat = jnp.abs(d_c) < eps_y
        inside = (o_c >= np.float32(lo)) & (o_c <= np.float32(hi))
        lo_t = jnp.where(flat, jnp.where(inside, -BIG, BIG), lo_t)
        hi_t = jnp.where(flat, jnp.where(inside, BIG, -BIG), hi_t)
        return lo_t, hi_t

    x1 = gs.x0 + gs.cx * gs.cell
    z1 = gs.z0 + gs.cz * gs.cell
    tx_lo, tx_hi = axis_range(ox, dx, inv_dx, gs.x0, x1)
    ty_lo, ty_hi = axis_range(oy, dy, inv_dy, gs.y_lo, gs.y_hi)
    tz_lo, tz_hi = axis_range(oz, dz, inv_dz, gs.z0, z1)
    t_in = jnp.maximum(
        jnp.maximum(tx_lo, ty_lo), jnp.maximum(tz_lo, np.float32(1e-3))
    )
    t_out = jnp.minimum(jnp.minimum(tx_hi, ty_hi), tz_hi)
    t_out = jnp.minimum(t_out, t_bound)

    march = (t_in <= t_out).astype(jnp.int32)

    px = ox + t_in * dx
    pz = oz + t_in * dz
    ix0 = jnp.clip(
        jnp.floor((px - np.float32(gs.x0)) * inv_cell).astype(jnp.int32),
        0, gs.cx - 1,
    )
    iz0 = jnp.clip(
        jnp.floor((pz - np.float32(gs.z0)) * inv_cell).astype(jnp.int32),
        0, gs.cz - 1,
    )
    flat_x = jnp.abs(dx) < eps_y
    flat_z = jnp.abs(dz) < eps_y
    next_bx = np.float32(gs.x0) + (
        ix0 + jnp.where(dx > 0, 1, 0)
    ).astype(jnp.float32) * np.float32(gs.cell)
    next_bz = np.float32(gs.z0) + (
        iz0 + jnp.where(dz > 0, 1, 0)
    ).astype(jnp.float32) * np.float32(gs.cell)
    tmaxx0 = jnp.where(flat_x, BIG, (next_bx - ox) * inv_dx)
    tmaxz0 = jnp.where(flat_z, BIG, (next_bz - oz) * inv_dz)
    tdx = jnp.where(flat_x, BIG, jnp.abs(np.float32(gs.cell) * inv_dx))
    tdz = jnp.where(flat_z, BIG, jnp.abs(np.float32(gs.cell) * inv_dz))
    return march, ix0, iz0, tmaxx0, tmaxz0, tdx, tdz, t_out


def grid_step(gs: GridStatic, load, walk, t_best, id_best, o, d):
    """ONE DDA step for every lane: read the cell's m slots, test, advance.

    ``load(index_plane)`` reads the flat grid table at per-lane indices.
    Lanes with march == 0 read the pad cell (a guaranteed miss) and keep
    their state. Returns (walk, t_best, id_best).
    """
    march, ix, iz, tmaxx, tmaxz, tdx, tdz, t_out = walk
    ox, oy, oz = o
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    eps_a = jnp.float32(1e-3) * a

    act = march > 0
    base = jnp.where(act, ix * gs.cz + iz, gs.pad_cell) * (gs.m * SLOT)
    t_c = jnp.full_like(a, BIG)
    id_c = jnp.zeros_like(a)
    for slot in range(gs.m):
        b = base + slot * SLOT
        cx, cy, cz, r2, sid = (load(b + f) for f in range(5))
        ocx = ox - cx
        ocy = oy - cy
        ocz = oz - cz
        half_b = ocx * dx + ocy * dy + ocz * dz
        cterm = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = half_b * half_b - a * cterm
        sq = jnp.sqrt(disc)  # NaN on miss: comparisons reject it
        ta0 = -half_b - sq
        ta1 = -half_b + sq
        ta = jnp.where(ta0 > eps_a, ta0, ta1)
        tc = jnp.where(ta > eps_a, ta * inv_a, BIG)
        better = tc < t_c
        t_c = jnp.where(better, tc, t_c)
        id_c = jnp.where(better, sid, id_c)

    improve = act & (t_c < t_best)
    t_best = jnp.where(improve, t_c, t_best)
    id_best = jnp.where(improve, id_c, id_best)

    # advance (tdx/tdz precomputed by grid_setup: no per-step divides)
    step_x = jnp.where(dx > 0, 1, jnp.where(dx < 0, -1, 0))
    step_z = jnp.where(dz > 0, 1, jnp.where(dz < 0, -1, 0))
    t_next = jnp.minimum(tmaxx, tmaxz)
    go_x = tmaxx <= tmaxz
    ix2 = ix + jnp.where(go_x, step_x, 0)
    iz2 = iz + jnp.where(go_x, 0, step_z)
    tmaxx2 = jnp.where(go_x, tmaxx + tdx, tmaxx)
    tmaxz2 = jnp.where(go_x, tmaxz, tmaxz + tdz)
    in_grid = (ix2 >= 0) & (ix2 < gs.cx) & (iz2 >= 0) & (iz2 < gs.cz)
    still = act & in_grid & (t_next <= t_out) & (t_next < t_best)
    walk = (
        still.astype(jnp.int32),
        jnp.where(act, ix2, ix),
        jnp.where(act, iz2, iz),
        jnp.where(act, tmaxx2, tmaxx),
        jnp.where(act, tmaxz2, tmaxz),
        tdx, tdz, t_out,
    )
    return walk, t_best, id_best


def emit_grid_walk(gs: GridStatic, table, o, d, t_best0, id_best0):
    """Whole-walk wrapper (setup + while over grid_step) in plain jnp: the
    DDA's semantics in isolation, for the tests. The kernel fuses one
    grid_step per wavefront iteration instead (module docstring)."""
    table = jnp.asarray(table)
    walk = grid_setup(gs, o, d, t_best0)

    def cond(st):
        return jnp.max(st[0][0]) > 0

    def body(st):
        return grid_step(gs, lambda i: table[i], *st, o, d)

    walk, t_best, id_best = jax.lax.while_loop(
        cond, body, (walk, t_best0, id_best0)
    )
    return t_best, id_best
