"""Grid-worklist correctness: packer membership, DDA fuzz vs brute oracle,
and end-to-end sphere-kernel parity on a griddable scene."""

import jax.numpy as jnp
import numpy as np
import pytest

from csgrenderer.camera import Camera
from csgrenderer.kernels import render_image_pallas
from csgrenderer.kernels.worklist import SLOT, emit_grid_walk, pack_grid
from csgrenderer.models import rtiow_final_scene
from csgrenderer.render import intersect
from csgrenderer.render.integrator import render_image


@pytest.fixture(scope="module")
def packed():
    pack, scene = pack_grid(rtiow_final_scene())
    return pack, scene


def test_packer_membership(packed):
    """Every surface point of every grid sphere must be listed by the cell
    that contains it — the correctness precondition of the DDA early-exit."""
    pack, scene = packed
    gs = pack.static
    tab = np.asarray(pack.table).reshape(-1, gs.m, SLOT)
    ids = tab[: gs.cx * gs.cz, :, 4].T  # [m, cells]
    c = np.asarray(scene.centers)
    r = np.asarray(scene.radii)
    rng = np.random.default_rng(0)
    for gi in range(pack.n_globals, c.shape[0]):
        for _ in range(8):
            v = rng.normal(size=3)
            v /= np.linalg.norm(v)
            p = c[gi] + r[gi] * v
            ix = int(np.floor((p[0] - gs.x0) / gs.cell))
            iz = int(np.floor((p[2] - gs.z0) / gs.cell))
            assert 0 <= ix < gs.cx and 0 <= iz < gs.cz, (gi, p)
            assert gi in ids[:, ix * gs.cz + iz], (gi, ix, iz)


def test_packer_occupancy_fits_slots(packed):
    pack, _ = packed
    gs = pack.static
    tab = np.asarray(pack.table).reshape(-1, gs.m, SLOT)
    r2 = tab[:, :, 3]
    assert r2.shape[0] == gs.pad_cell + 1
    assert (r2[gs.pad_cell] < 0).all()  # the pad cell always misses
    assert (r2 > 0).sum(1).max() <= gs.m


def _planes(v):
    return jnp.asarray(np.asarray(v, np.float32))


def _walk(pack, o, d):
    t, i = emit_grid_walk(
        pack.static, pack.table,
        (_planes(o[:, 0]), _planes(o[:, 1]), _planes(o[:, 2])),
        (_planes(d[:, 0]), _planes(d[:, 1]), _planes(d[:, 2])),
        jnp.full((o.shape[0],), np.float32(1e30)),
        jnp.zeros((o.shape[0],), jnp.float32),
    )
    return np.asarray(t), np.asarray(i)


RAY_FAMILIES = ["random", "horizontal-in-slab", "axis", "inside", "steep"]


@pytest.mark.parametrize("family", RAY_FAMILIES)
def test_grid_walk_matches_brute_oracle(packed, family):
    """(hit, t, id) from the DDA == brute-force nearest over grid spheres,
    for 1024 rays per adversarial family (ties in t excepted)."""
    pack, scene = packed
    cg = np.asarray(scene.centers)[pack.n_globals :]
    rg = np.asarray(scene.radii)[pack.n_globals :]
    rng = np.random.default_rng(RAY_FAMILIES.index(family) + 1)
    N = 1024
    o = np.empty((N, 3), np.float32)
    d = np.empty((N, 3), np.float32)
    if family == "random":
        o[:, 0] = rng.uniform(-14, 14, N)
        o[:, 2] = rng.uniform(-14, 14, N)
        o[:, 1] = rng.uniform(-1, 4, N)
        d[:] = rng.normal(size=(N, 3))
    elif family == "horizontal-in-slab":
        o[:, 0] = rng.uniform(-12, 12, N)
        o[:, 2] = rng.uniform(-12, 12, N)
        o[:, 1] = rng.uniform(0.05, 0.35, N)
        d[:] = rng.normal(size=(N, 3))
        d[:, 1] = rng.uniform(-1e-3, 1e-3, N)
    elif family == "axis":
        o[:, 0] = rng.uniform(-12, 12, N)
        o[:, 2] = rng.uniform(-12, 12, N)
        o[:, 1] = rng.uniform(0.0, 0.5, N)
        d[:] = 0.0
        d[np.arange(N), rng.integers(0, 3, N)] = rng.choice([-1.0, 1.0], N)
    elif family == "inside":
        k = rng.integers(0, cg.shape[0], N)
        o[:] = cg[k] + rng.normal(size=(N, 3)) * 0.05
        d[:] = rng.normal(size=(N, 3))
    else:  # steep
        o[:, 0] = rng.uniform(-12, 12, N)
        o[:, 2] = rng.uniform(-12, 12, N)
        o[:, 1] = 5.0
        d[:] = rng.normal(size=(N, 3)) * 0.05
        d[:, 1] = -1.0

    t_or, idx_or, hit_or = intersect.spheres_nearest_hit(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(cg), jnp.asarray(rg),
        t_min=1e-3,
    )
    t_or = np.where(np.asarray(hit_or), np.asarray(t_or), 1e30)
    id_or = np.where(np.asarray(hit_or), np.asarray(idx_or) + pack.n_globals, -1)

    t_g, id_g = _walk(pack, o, d)
    hit_g = t_g < 1e29
    hit_or = t_or < 1e29

    def tangent_flip(i):
        """True if the disagreement at lane i is a near-tangent hit that the
        two quadratic forms (oc form in the walk, expanded form in the
        oracle) may round differently: the claimed/lost sphere's exact
        impact parameter is within a hair of its radius. Silhouette-sliver
        effects, invisible under MC noise."""
        for sid in (id_g[i], id_or[i]):
            sid = int(sid)
            if not (pack.n_globals <= sid < pack.n_globals + cg.shape[0] + 1):
                continue
            cc = cg[sid - pack.n_globals]
            rr = rg[sid - pack.n_globals]
            oc = o[i].astype(np.float64) - cc
            dd = d[i].astype(np.float64)
            a_ = dd @ dd
            imp2 = oc @ oc - (oc @ dd) ** 2 / a_
            if abs(imp2 - rr * rr) < 2e-2 * rr * rr:
                return True
        return False

    disagree = np.where(
        (hit_g != hit_or)
        | (hit_g & hit_or & (np.where(hit_g, id_g, -1) != id_or)
           & (np.abs(t_g - t_or) > 2e-3 * np.maximum(t_or, 1.0)))
    )[0]
    hard = [i for i in disagree if not tangent_flip(i)]
    assert not hard, (family, hard[:5], [(t_or[i], t_g[i]) for i in hard[:3]])
    # away from disagreements, t agrees to the conditioning of the quadratic
    both = hit_g & hit_or
    ok = np.ones_like(both)
    ok[disagree] = False
    rel = np.abs(t_g - t_or)[both & ok] / np.maximum(t_or[both & ok], 1e-6)
    assert rel.max() < 5e-2 if (both & ok).any() else True


def test_rtiow_grid_kernel_matches_reference_end_to_end():
    scene = rtiow_final_scene()
    cam = Camera.look_at(
        (13, 2, 3), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=2.0,
        aperture=0.1, focus_dist=10.0,
    )
    w, h, spp, bounces = 64, 32, 2, 4
    ref, rrays = render_image(
        scene.nearest_hit, cam, w, h, spp=spp, max_bounces=bounces, seed=0,
        lens=True,
    )
    img, krays = render_image_pallas(
        scene, cam, w, h, spp=spp, max_bounces=bounces, seed=0, lens=True,
        interpret=True,
    )
    rmse = float(np.sqrt(np.mean((np.asarray(ref) - np.asarray(img)) ** 2)))
    assert rmse <= 2e-2, rmse  # same tolerance as the brute kernel tests
    assert abs(int(krays) - int(rrays)) < 0.01 * int(rrays)


def test_small_scene_falls_back_to_brute():
    from csgrenderer.models import two_spheres_scene

    assert pack_grid(two_spheres_scene()) is None


def test_grid_path_inside_shard_map():
    """The grid path (slab rows) must compose under shard_map exactly like
    the brute kernel: slab-sharded render == unsharded render within MC
    tie tolerance."""
    import jax

    from csgrenderer.parallel import make_mesh as make_device_mesh
    from csgrenderer.parallel import render_scene_sharded

    scene = rtiow_final_scene()
    assert pack_grid(scene) is not None
    cam = Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20.0,
                         aspect_ratio=2.0, aperture=0.1, focus_dist=10.0)
    mesh = make_device_mesh(4, 2, devices=jax.devices()[:8])
    img, rays = render_scene_sharded(
        scene, cam, 64, 32, mesh, spp=4, max_bounces=4, seed=0, lens=True,
        backend="triton", interpret=True,
    )
    ref, rrays = render_image_pallas(
        scene, cam, 64, 32, spp=4, max_bounces=4, seed=0, lens=True,
        interpret=True,
    )
    img, ref = np.asarray(img), np.asarray(ref)
    bad = float((np.abs(img - ref).max(axis=-1) > 0.05).mean())
    assert bad <= 0.01, f"{bad:.3%} divergent"
    assert abs(int(rays) - int(rrays)) <= max(8, 0.01 * int(rrays))
