"""Integrator tests: bounce loop, sky, energy conservation, determinism."""

import jax
import jax.numpy as jnp
import numpy as np

from csgrenderer.camera import Camera
from csgrenderer.models import rtiow_final_scene, two_spheres_scene
from csgrenderer.render import render_image, sky_color
from csgrenderer.render.integrator import SphereScene, render_wololo_frame


def test_sky_modes():
    d = jnp.array([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(sky_color(d, "wololo")[0], [0.5, 0.7, 1.0], atol=1e-6)
    np.testing.assert_allclose(sky_color(d, "rtiow")[0], [0.5, 0.7, 1.0], atol=1e-6)
    d = jnp.array([[0.0, -1.0, 0.0]])
    # wololo: t=-1 -> 2*white - sky_blue (the reference's unclamped lerp)
    np.testing.assert_allclose(sky_color(d, "wololo")[0], [1.5, 1.3, 1.0], atol=1e-6)
    # rtiow: t=0 -> white
    np.testing.assert_allclose(sky_color(d, "rtiow")[0], [1.0, 1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(sky_color(d, "black")[0], [0.0, 0.0, 0.0])


def test_wololo_frame_matches_shader_semantics():
    img = np.asarray(render_wololo_frame(0.0, 64, 48))
    assert img.shape == (48, 64, 3)
    # at t=0 the sphere sits at (0, 0, -11), r=0.5 -> center pixel hits it and
    # sees a normal pointing roughly back at the camera (+z toward viewer):
    c = img[24, 32]
    assert c[2] > 0.95  # blue channel ~ 0.5*(nz+1) with nz ~ -1... no: -z
    # direction.z is negative; normal faces camera -> n ~ (0,0,-1)?? The
    # reference normal = normalize(d*t - center): at center ray d=(~0,~0,-1),
    # d*t - center = (0,0,-10.5) - (0,0,-11) = (0,0,0.5) -> n=(0,0,1), so
    # blue = 0.5*(1+1) = 1. Checked above.
    # top rows are sky near sky-blue:
    assert img[0, 32, 2] >= img[0, 32, 0]


def test_wololo_frame_animates():
    a = np.asarray(render_wololo_frame(0.0, 64, 48))
    b = np.asarray(render_wololo_frame(1.0, 64, 48))
    assert np.abs(a - b).max() > 0.1


def test_render_image_deterministic():
    scene = two_spheres_scene()
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=2.0)
    f = jax.jit(
        lambda: render_image(scene.nearest_hit, cam, 64, 32, spp=2, max_bounces=4, seed=5)
    )
    img1, rays1 = f()
    img2, rays2 = f()
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
    assert int(rays1) == int(rays2) > 0


def test_render_image_no_nans_and_bounded_energy():
    scene = rtiow_final_scene()
    cam = Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20,
                         aspect_ratio=2.0, aperture=0.1, focus_dist=10.0)
    img, rays = render_image(scene.nearest_hit, cam, 64, 32, spp=2,
                             max_bounces=8, seed=7, lens=True)
    img = np.asarray(img)
    assert not np.isnan(img).any()
    assert img.min() >= 0.0
    # sky-lit scene: radiance can slightly exceed 1 via the gradient but not blow up
    assert img.max() < 4.0


def test_more_bounces_brighter_or_equal():
    # with a closed diffuse scene more bounces can only add energy
    scene = two_spheres_scene()
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=2.0)
    img2, _ = render_image(scene.nearest_hit, cam, 32, 16, spp=4, max_bounces=2, seed=1)
    img8, _ = render_image(scene.nearest_hit, cam, 32, 16, spp=4, max_bounces=8, seed=1)
    assert float(jnp.mean(img8) - jnp.mean(img2)) >= -1e-5


def test_single_emissive_sphere_black_sky():
    scene = SphereScene(
        centers=jnp.array([[0.0, 0.0, -3.0]]),
        radii=jnp.array([1.0]),
        mat_kind=jnp.array([4], jnp.int32),
        albedo=jnp.array([[2.0, 1.0, 0.5]]),
        mat_param=jnp.array([0.0]),
    )
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=60, aspect_ratio=1.0)
    img, _ = render_image(scene.nearest_hit, cam, 33, 33, spp=1,
                          max_bounces=3, seed=0, sky="black", jitter=False)
    img = np.asarray(img)
    np.testing.assert_allclose(img[16, 16], [2.0, 1.0, 0.5], atol=1e-5)
    np.testing.assert_allclose(img[0, 0], [0.0, 0.0, 0.0], atol=1e-6)


def test_rays_traced_accounting():
    # miss-everything camera: exactly W*H*spp primary rays
    scene = two_spheres_scene()
    cam = Camera.look_at((0, 50, 0), (0, 100, 0), vfov_degrees=30, aspect_ratio=1.0)
    _, rays = render_image(scene.nearest_hit, cam, 16, 16, spp=3, max_bounces=8, seed=0)
    assert int(rays) == 16 * 16 * 3
