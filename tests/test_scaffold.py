"""The Triton scaffold (kernels/common.py) piece by piece against the jnp
reference, run as Pallas kernels in interpret mode; the wrappers' slabs;
and both kernel families lowered for CUDA (Triton IR) on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from csgrenderer.camera import Camera
from csgrenderer.kernels import common
from csgrenderer.render import integrator, materials
from csgrenderer.render.sampling import sample_in_unit_disk, uniform4

N = 2 * common.BLOCK


def run_planes(fn, inputs, n_out, dtypes=None):
    """Run ``fn`` on [N] planes block by block as a Triton-route Pallas
    kernel in the interpreter; returns its ``n_out`` output planes."""
    dtypes = dtypes or (jnp.float32,) * n_out
    spec = pl.BlockSpec((common.BLOCK,), lambda i: (i,))

    def kernel(*refs):
        outs = fn(*(r[...] for r in refs[: len(inputs)]))
        for r, v in zip(refs[len(inputs):], outs):
            r[...] = v.astype(r.dtype)

    return pl.pallas_call(
        kernel,
        grid=(N // common.BLOCK,),
        in_specs=[spec] * len(inputs),
        out_specs=[spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((N,), dt) for dt in dtypes],
        backend="triton",
        interpret=True,
    )(*inputs)


def _counters(seed=0):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint64)
                        .astype(np.uint32)) for _ in range(4)]


def test_pcg4d_planes_bit_identical_to_sampling():
    a, b, c, d = _counters()
    got = run_planes(lambda *x: common.pcg4d_planes(*x), [a, b, c, d], 4)
    ref = np.asarray(uniform4(a, b, c, d))
    for k in range(4):
        np.testing.assert_array_equal(np.asarray(got[k]), ref[:, k])


@pytest.mark.parametrize("lens", [False, True])
def test_camera_rays_match_render_tile(lens):
    width, height, seed = 37, 11, 7
    cam = Camera.look_at((1.0, 2.0, 3.0), (0.0, 0.5, 0.0), vfov_degrees=40.0,
                         aspect_ratio=width / height, aperture=0.3,
                         focus_dist=4.0)
    pix = jnp.arange(N, dtype=jnp.uint32) % (width * height)
    s = jnp.full((N,), 5, jnp.uint32)
    scal = [np.float32(v) for v in np.asarray(common.pack_camera(cam))[:19]]

    def fn(pix_, s_):
        px = (pix_ % width).astype(jnp.float32)
        py = (pix_ // width).astype(jnp.float32)
        (ox, oy, oz), (dx, dy, dz) = common.camera_ray_planes(
            scal, px, py, pix_, s_, np.int32(seed), np.float32(1 / width),
            np.float32(1 / height), lens,
        )
        return ox, oy, oz, dx, dy, dz

    got = np.stack([np.asarray(v) for v in run_planes(fn, [pix, s], 6)], -1)
    u = uniform4(pix, s, jnp.uint32(0xA5A5A5A5), jnp.uint32(seed))
    st_x = ((pix % width).astype(jnp.float32) + u[:, 0]) / width
    st_y = 1.0 - ((pix // width).astype(jnp.float32) + u[:, 1]) / height
    lens_uv = sample_in_unit_disk(u[:, 2], u[:, 3]) if lens else None
    o, d = cam.rays(st_x, st_y, lens_uv=lens_uv)
    ref = np.concatenate([np.asarray(o), np.asarray(d)], -1)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_scatter_planes_match_materials(kind):
    rng = np.random.default_rng(kind)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where((d * n).sum(1, keepdims=True) > 0, -n, n)  # opposing d
    alb = rng.random((N, 3)).astype(np.float32)
    param = np.float32(1.5 if kind == 3 else 0.3)
    front = rng.random(N) < 0.5
    u = rng.random((N, 3)).astype(np.float32)

    def fn(*x):
        dd, nn, aa, uu = x[0:3], x[3:6], x[6:9], x[9:12]
        fr = x[12] > 0.5
        kind_pl = jnp.zeros_like(x[0]) + np.float32(kind)
        (nd, at, em, term, _) = common.scatter_planes(
            kind_pl, param, aa, dd, nn, fr, *uu
        )
        return (*nd, *at, *em, term)

    planes = [jnp.asarray(a[:, k]) for a in (d, n, alb, u) for k in range(3)]
    planes.append(jnp.asarray(front.astype(np.float32)))
    got = run_planes(fn, planes, 10, dtypes=(jnp.float32,) * 9 + (jnp.int32,))
    got = [np.asarray(v) for v in got]
    u4 = jnp.concatenate([jnp.asarray(u), jnp.zeros((N, 1))], axis=1)
    ref = materials.scatter(
        jnp.full((N,), kind, jnp.int32), jnp.asarray(alb),
        jnp.full((N,), param), jnp.asarray(d), jnp.asarray(n),
        jnp.asarray(front), u4,
    )
    np.testing.assert_allclose(
        np.stack(got[0:3], -1), np.asarray(ref.direction), rtol=1e-4,
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.stack(got[3:6], -1), np.asarray(ref.attenuation), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.stack(got[6:9], -1), np.asarray(ref.emitted), rtol=1e-6
    )
    np.testing.assert_array_equal(got[9] > 0, np.asarray(ref.terminate))


@pytest.mark.parametrize("mode", ["rtiow", "wololo", "black"])
def test_sky_planes_match_sky_color(mode):
    rng = np.random.default_rng(1)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    ud = d / np.linalg.norm(d, axis=1, keepdims=True)
    got = run_planes(
        lambda x, y, z: common.sky_planes((x, y, z), mode),
        [jnp.asarray(ud[:, k]) for k in range(3)], 3,
    )
    ref = np.asarray(integrator.sky_color(jnp.asarray(d), mode))
    np.testing.assert_allclose(
        np.stack([np.asarray(v) for v in got], -1), ref, rtol=1e-5,
        atol=1e-6,
    )


@pytest.mark.parametrize("width,n_pix", [(7, 3), (33, 200), (128, 256)])
def test_program_pixels_cover_partial_blocks(width, n_pix):
    """Lanes past the slab's last pixel are invalid; every valid lane gets
    its own global pixel (offset included) and its (px, py)."""
    offset = 5 * width

    def kernel(out_pix, out_px, out_py, out_valid):
        pix, px, py, valid = common.program_pixels(n_pix, offset, width)
        out_pix[...] = pix.astype(jnp.int32)
        out_px[...] = px
        out_py[...] = py
        out_valid[...] = valid.astype(jnp.int32)

    n_blocks = pl.cdiv(n_pix, common.BLOCK)
    spec = pl.BlockSpec((common.BLOCK,), lambda i: (i,))
    shape = (n_blocks * common.BLOCK,)
    pix, px, py, valid = (np.asarray(v) for v in pl.pallas_call(
        kernel, grid=(n_blocks,), out_specs=[spec] * 4,
        out_shape=[jax.ShapeDtypeStruct(shape, dt) for dt in
                   (jnp.int32, jnp.float32, jnp.float32, jnp.int32)],
        backend="triton", interpret=True,
    )())
    lane = np.arange(shape[0])
    np.testing.assert_array_equal(valid, (lane < n_pix).astype(np.int32))
    np.testing.assert_array_equal(pix, lane + offset)
    np.testing.assert_array_equal(px, (lane + offset) % width)
    np.testing.assert_array_equal(py, (lane + offset) // width)


@pytest.mark.parametrize("family", ["sphere", "tape"])
def test_row_slabs_compose_to_the_full_image(family):
    """rows/row_offset slabs (the sharding primitive) reproduce the full
    render exactly: RNG and camera use global pixel ids."""
    from csgrenderer.kernels import (
        render_image_pallas,
        render_image_tape_pallas,
    )
    from csgrenderer.models import config3_csg_scene, two_spheres_scene

    if family == "sphere":
        scene, fn = two_spheres_scene(), render_image_pallas
        cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90,
                             aspect_ratio=2.0)
    else:
        scene, fn = config3_csg_scene().compile(k=2), render_image_tape_pallas
        cam = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35,
                             aspect_ratio=2.0)
    kw = dict(spp=2, max_bounces=3, seed=4, interpret=True)
    full, rays = fn(scene, cam, 40, 20, **kw)
    top, r_top = fn(scene, cam, 40, 20, rows=8, row_offset=0, **kw)
    bot, r_bot = fn(scene, cam, 40, 20, rows=12, row_offset=8, **kw)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(top), np.asarray(bot)]), np.asarray(full)
    )
    assert int(r_top) + int(r_bot) == int(rays)


def _lower_cuda(fn, *args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))


@pytest.mark.parametrize("case", ["brute", "grid", "grid_nee"])
def test_sphere_kernel_lowers_for_cuda(case):
    """The sphere kernel lowers to Triton IR for the GPU at a real width
    (what the card's compiler then takes); no card needed to lower."""
    from csgrenderer.kernels import megakernel as mk
    from csgrenderer.models import (
        night_scene,
        rtiow_final_scene,
        two_spheres_scene,
    )

    scene = {"brute": two_spheres_scene, "grid": rtiow_final_scene,
             "grid_nee": night_scene}[case]()
    sph, grid, lights, n_brute, gs, n_lights = mk._prepare(
        scene, case == "grid_nee"
    )
    assert (gs is not None) == (case != "brute")
    cam = Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20,
                         aspect_ratio=16 / 9, aperture=0.1, focus_dist=10.0)
    fn = functools.partial(
        mk._render_packed, sph, grid, lights, width=1920, height=1080,
        rows=1080, spp=64, max_bounces=8, lens=True, sky="rtiow",
        n_brute=n_brute, grid_static=gs, n_lights=n_lights, interpret=False,
    )
    text = _lower_cuda(lambda c: fn(c, 0, 0, 0), cam).as_text()
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.parametrize("case", ["deep", "nee", "clusters"])
def test_tape_kernel_lowers_for_cuda(case):
    from csgrenderer.kernels import tape_kernel as tk
    from csgrenderer.models import (
        animated_csg_scene,
        csg_night_scene,
        many_objects_scene,
    )
    from csgrenderer.scene.partition import partition_tape

    clusters = None
    lamps = ()
    if case == "deep":
        tape = animated_csg_scene(8)[0].compile(k=8)
    elif case == "nee":
        from csgrenderer.render.lights import extract_tape_lights

        tape = csg_night_scene().compile(k=4)
        lamps = tuple(int(i) for i in extract_tape_lights(
            tape, return_ids=True)[1])
    else:
        tape = many_objects_scene(9).compile(k=4)
        clusters = partition_tape(tape)
        assert clusters is not None
    cam = Camera.look_at((0, 3, 8), (0, 0, 0), vfov_degrees=40,
                         aspect_ratio=16 / 9)
    fn = functools.partial(
        tk._render_tape_packed, width=1920, height=1080, rows=1080, spp=16,
        max_bounces=8, lens=False, sky="rtiow", nee_lamps=lamps,
        clusters=clusters, interpret=False,
    )
    text = _lower_cuda(lambda t, c: fn(t, c, 0, 0, 0), tape, cam).as_text()
    assert "__gpu$xla.gpu.triton" in text
