"""Hollow dielectrics via the RTIOW negative-radius trick: a sphere with
r < 0 has the same geometry but an inward outward-normal, turning a glass
shell + inner negative sphere into a thin bubble."""

import jax.numpy as jnp
import numpy as np

from csgrenderer.camera import Camera
from csgrenderer.kernels import render_image_pallas
from csgrenderer.render.integrator import SphereScene, render_image


def _scene(inner_radius):
    centers = jnp.asarray(
        [
            [0.0, -100.5, -1.0],  # ground
            [0.0, 0.0, -1.0],  # glass shell
            [0.0, 0.0, -1.0],  # inner boundary (negative r -> hollow)
            [1.05, 0.0, -1.0],  # diffuse reference ball
        ],
        jnp.float32,
    )
    radii = jnp.asarray([100.0, 0.5, inner_radius, 0.5], jnp.float32)
    kinds = jnp.asarray([1, 3, 3, 1], jnp.int32)
    albedo = jnp.asarray(
        [[0.8, 0.8, 0.0], [1, 1, 1], [1, 1, 1], [0.1, 0.2, 0.5]], jnp.float32
    )
    params = jnp.asarray([0.0, 1.5, 1.5, 0.0], jnp.float32)
    return SphereScene(centers, radii, kinds, albedo, params)


CAM = Camera.look_at((0, 0, 0.6), (0, 0, -1), vfov_degrees=60.0,
                     aspect_ratio=1.0)


def test_negative_radius_flips_normals_consistently():
    scene = _scene(-0.45)
    o = jnp.asarray([[0.0, 0.0, 0.6]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    h = scene.nearest_hit(o, d)
    # first hit: the outer shell, outward-facing
    np.testing.assert_allclose(float(h.t[0]), 1.1, atol=1e-3)
    assert bool(h.front_face[0])


def test_hollow_bubble_differs_from_solid_glass():
    img_solid, _ = render_image(
        _scene(0.45).nearest_hit, CAM, 48, 48, spp=8, max_bounces=8, seed=1
    )
    img_hollow, _ = render_image(
        _scene(-0.45).nearest_hit, CAM, 48, 48, spp=8, max_bounces=8, seed=1
    )
    diff = float(np.mean(np.abs(np.asarray(img_solid) - np.asarray(img_hollow))))
    assert diff > 1e-3  # physically different refraction


def test_megakernel_matches_reference_with_negative_radius():
    scene = _scene(-0.45)
    ref, rrays = render_image(
        scene.nearest_hit, CAM, 64, 32, spp=2, max_bounces=6, seed=3
    )
    img, krays = render_image_pallas(
        scene, CAM, 64, 32, spp=2, max_bounces=6, seed=3, interpret=True
    )
    rmse = float(np.sqrt(np.mean((np.asarray(ref) - np.asarray(img)) ** 2)))
    assert rmse <= 2e-2, rmse
    assert abs(int(krays) - int(rrays)) <= 0.01 * int(rrays)


def test_grid_worklist_path_with_negative_radius():
    """A hollow bubble inside a big lattice exercises the worklist path."""
    rng = np.random.default_rng(5)
    n = 80
    centers = np.zeros((n + 3, 3), np.float32)
    radii = np.zeros(n + 3, np.float32)
    kinds = np.ones(n + 3, np.int32)
    albedo = np.full((n + 3, 3), 0.5, np.float32)
    params = np.zeros(n + 3, np.float32)
    gx, gz = np.meshgrid(np.arange(9), np.arange(9))
    pts = np.stack([gx.ravel(), gz.ravel()], -1)[:n]
    centers[:n, 0] = pts[:, 0] - 4.0
    centers[:n, 2] = pts[:, 1] - 4.0
    centers[:n, 1] = 0.2
    radii[:n] = 0.2
    # ground + hollow bubble (outer glass, inner negative) in the lattice
    centers[n] = [0, -1000, 0]
    radii[n] = 1000.0
    albedo[n] = [0.5, 0.5, 0.5]
    centers[n + 1] = [0.45, 0.2, 0.45]
    radii[n + 1] = 0.2
    kinds[n + 1] = 3
    params[n + 1] = 1.5
    centers[n + 2] = [0.45, 0.2, 0.45]
    radii[n + 2] = -0.18
    kinds[n + 2] = 3
    params[n + 2] = 1.5
    scene = SphereScene(*map(jnp.asarray, (centers, radii, kinds, albedo, params)))

    from csgrenderer.kernels.worklist import pack_grid

    assert pack_grid(scene) is not None  # the grid path really engages
    cam = Camera.look_at((3, 2, 3), (0.45, 0.2, 0.45), vfov_degrees=35.0,
                         aspect_ratio=2.0)
    ref, _ = render_image(
        scene.nearest_hit, cam, 64, 32, spp=2, max_bounces=6, seed=4
    )
    img, _ = render_image_pallas(
        scene, cam, 64, 32, spp=2, max_bounces=6, seed=4, interpret=True,
    )
    rmse = float(np.sqrt(np.mean((np.asarray(ref) - np.asarray(img)) ** 2)))
    assert rmse <= 2e-2, rmse
