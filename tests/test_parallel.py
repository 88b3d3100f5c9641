"""Multi-device tests on the forced 8-device CPU mesh.

The key invariant: ANY mesh shape produces the single-device image exactly
(counter-based RNG + global-coordinate tiles). This is the test SURVEY §7
hard part #4 calls for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csgrenderer.camera import Camera
from csgrenderer.models import two_spheres_scene
from csgrenderer.parallel import make_mesh, render_image_sharded
from csgrenderer.render import render_image


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    scene = two_spheres_scene()
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=2.0)
    ref, ref_rays = render_image(
        scene.nearest_hit, cam, 64, 32, spp=8, max_bounces=4, seed=9
    )
    return scene, cam, np.asarray(ref), int(ref_rays)


@pytest.mark.parametrize("tile,sample", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)])
def test_sharded_matches_single_device(setup, tile, sample):
    scene, cam, ref, ref_rays = setup
    devices = jax.devices()[: tile * sample]
    mesh = make_mesh(tile, sample, devices=devices)
    img, rays = render_image_sharded(
        scene.nearest_hit, cam, 64, 32, mesh, spp=8, max_bounces=4, seed=9
    )
    np.testing.assert_allclose(np.asarray(img), ref, atol=1e-5)
    assert int(rays) == ref_rays


def test_sharded_output_sharding(setup):
    scene, cam, _, _ = setup
    mesh = make_mesh(8, 1)
    img, _ = render_image_sharded(
        scene.nearest_hit, cam, 64, 32, mesh, spp=2, max_bounces=2, seed=9
    )
    assert img.shape == (32, 64, 3)
    # rows sharded over the tile axis
    assert len(img.sharding.device_set) == 8


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(3, 3)  # 9 != 8
    mesh = make_mesh(4, 2)
    assert mesh.shape == {"tile": 4, "sample": 2}
    scene = two_spheres_scene()
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=2.0)
    with pytest.raises(ValueError, match="divisible"):
        render_image_sharded(scene.nearest_hit, cam, 64, 30, mesh, spp=4)
    with pytest.raises(ValueError, match="divisible"):
        render_image_sharded(scene.nearest_hit, cam, 64, 32, mesh, spp=3)


def test_pallas_sharded_matches_jnp_sharded(setup):
    # the kernel path: Triton kernels inside shard_map (interpret mode on
    # the CPU mesh); must reproduce the single-device jnp image
    from csgrenderer.parallel import render_scene_sharded

    scene, cam, ref, ref_rays = setup
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    img, rays = render_scene_sharded(
        scene, cam, 64, 32, mesh, spp=8, max_bounces=4, seed=9,
        backend="triton", interpret=True,
    )
    img = np.asarray(img)
    assert img.shape == (32, 64, 3)
    # kernel-vs-jnp differences are the usual float-grouping silhouette
    # flips; nearly every pixel must agree
    bad = (np.abs(img - ref).max(axis=-1) > 0.05).mean()
    assert bad <= 0.01, f"{bad:.3%} divergent"
    assert abs(int(rays) - ref_rays) <= max(ref_rays * 2e-3, 8)


def test_pallas_sharded_tape_scene(setup):
    from csgrenderer.models import config3_csg_scene
    from csgrenderer.parallel import render_scene_sharded
    from csgrenderer.render import render_image, tape_hit_adapter
    from functools import partial

    tape = config3_csg_scene().compile(k=2)
    cam = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35,
                         aspect_ratio=1.0)
    ref, ref_rays = render_image(
        partial(tape_hit_adapter, tape), cam, 32, 32, spp=2, max_bounces=3,
        seed=3,
    )
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    img, rays = render_scene_sharded(
        tape, cam, 32, 32, mesh, spp=2, max_bounces=3, seed=3,
        backend="triton", interpret=True,
    )
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-4)
    assert int(rays) == int(ref_rays)


def test_pallas_sharded_mesh_scene(setup):
    """MeshScene through render_scene_sharded (VERDICT r2 item 1: meshes
    are framework citizens — same multi-card machinery as spheres/tapes).
    Meshes have no kernel, so every backend request that is not an error
    takes the plain XLA path."""
    from csgrenderer.parallel import render_scene_sharded
    from csgrenderer.render import icosphere, quad, render_image
    from csgrenderer.scene.graph import Material

    mesh_scene = icosphere((0, 0, -4), 1.0,
                           Material.lambertian((0.6, 0.3, 0.3)), 1)
    cam = Camera.look_at((0, 0, 0), (0, 0, -4), vfov_degrees=45,
                         aspect_ratio=2.0)
    ref, ref_rays = render_image(
        mesh_scene.nearest_hit, cam, 64, 32, spp=2, max_bounces=3, seed=5
    )
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    img, rays = render_scene_sharded(
        mesh_scene, cam, 64, 32, mesh, spp=2, max_bounces=3, seed=5,
        interpret=True,
    )
    assert img.shape == (32, 64, 3)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-5)
    assert int(rays) == int(ref_rays)

    with pytest.raises(ValueError, match="no Triton kernel"):
        render_scene_sharded(
            mesh_scene, cam, 64, 32, mesh, spp=2, backend="triton",
            interpret=True,
        )


def test_pallas_vma_checker_still_unsupported():
    """Canary for the ONE remaining check_vma=False escape hatch
    (render_scene_sharded): jax 0.9's vma checker cannot type a pallas_call
    whose kernel mixes varying inputs with invariant constants. When this
    test FAILS (the micro-example below passes), remove the escape hatch in
    parallel/shard.py and delete this test."""
    from jax.experimental import pallas as pl
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("tile", "sample"))

    def kern(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0

    def shard_fn():
        i = jax.lax.axis_index("tile").astype(jnp.float32)
        x = jnp.ones((8, 128), jnp.float32) + i
        out = pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct(
                (8, 128), jnp.float32, vma=frozenset({"tile", "sample"})
            ),
            interpret=True,
        )(x)
        return out[None]

    fn = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(), out_specs=P("tile"), check_vma=True
    )
    with pytest.raises(Exception, match="varying manual axes|vma"):
        fn().block_until_ready()


def test_render_to_noise_sharded_matches_single_device(setup):
    """The two-stream noise certificate is sharding-invariant (round 5,
    VERDICT item 5): the sharded accumulation reproduces the single-device
    render_to_noise bit stream, so its measured noise and spp count are
    EXACTLY the single-device ones."""
    from csgrenderer.app.renderers import PathTraceRenderer
    from csgrenderer.parallel import render_to_noise_sharded
    from csgrenderer.utils.config import RenderConfig

    scene, cam, _, _ = setup
    cfg = RenderConfig(width=64, height=32, spp=4, max_bounces=4, seed=9)
    single = PathTraceRenderer(scene, cam, cfg, backend="jnp")
    acc_s, noise_s, used_s = single.render_to_noise(
        target=5e-3, max_spp=64
    )

    mesh = make_mesh(4, 2)
    acc_m, noise_m, used_m = render_to_noise_sharded(
        scene, cam, 64, 32, mesh, target=5e-3, max_spp=64, spp_chunk=4,
        max_bounces=4, seed=9, backend="jnp",
    )
    assert used_m == used_s
    assert noise_m == pytest.approx(noise_s, rel=1e-5)
    assert int(acc_m.rays_traced) == int(acc_s.rays_traced)
    np.testing.assert_allclose(
        np.asarray(acc_m.image()), np.asarray(acc_s.image()), atol=1e-5
    )
