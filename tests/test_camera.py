"""Camera tests: reference st semantics and RTIOW thin-lens geometry."""

import jax.numpy as jnp
import numpy as np

from csgrenderer.camera import Camera, WololoCamera, pixel_st_grid
from csgrenderer.math import vec


def test_pixel_st_grid_yflip_and_centers():
    st_x, st_y = pixel_st_grid(4, 2)
    # pixel centers: x = (i + 0.5) / W
    np.testing.assert_allclose(st_x[0], [0.125, 0.375, 0.625, 0.875])
    # y-flip (frag:26-29): row 0 (top) has the HIGHER st_y
    np.testing.assert_allclose(st_y[:, 0], [0.75, 0.25])


def test_wololo_camera_center_ray_points_down_z():
    cam = WololoCamera.create()
    o, d = cam.rays(jnp.array([[0.5]]), jnp.array([[0.5]]), aspect_ratio=2.0)
    np.testing.assert_allclose(o[0, 0], [0, 0, 0], atol=1e-7)
    # center of screen: direction = (0, 0, -focal); left UNNORMALIZED
    np.testing.assert_allclose(d[0, 0], [0, 0, -1.0], atol=1e-6)


def test_wololo_camera_viewport_is_height_one():
    # the reference uses viewport height 1.0, not RTIOW's 2.0 (frag:50-60)
    cam = WololoCamera.create()
    _, d_top = cam.rays(jnp.array([[0.5]]), jnp.array([[1.0]]), aspect_ratio=1.0)
    _, d_bot = cam.rays(jnp.array([[0.5]]), jnp.array([[0.0]]), aspect_ratio=1.0)
    np.testing.assert_allclose(d_top[0, 0, 1] - d_bot[0, 0, 1], 1.0, atol=1e-6)


def test_look_at_points_at_target():
    cam = Camera.look_at((1, 2, 3), (4, 5, 6), vfov_degrees=60, aspect_ratio=1.0)
    _, d = cam.rays(jnp.array([[0.5]]), jnp.array([[0.5]]))
    to_target = vec.normalized(jnp.array([3.0, 3.0, 3.0]))
    np.testing.assert_allclose(
        np.asarray(vec.normalized(d[0, 0])), np.asarray(to_target), atol=1e-5
    )


def test_look_at_vfov_spans_viewport():
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=1.0)
    _, d_top = cam.rays(jnp.array([[0.5]]), jnp.array([[1.0]]))
    _, d_bot = cam.rays(jnp.array([[0.5]]), jnp.array([[0.0]]))
    # 90-degree fov: top and bottom rays are 90 degrees apart
    cos = float(
        vec.dot(vec.normalized(d_top[0, 0]), vec.normalized(d_bot[0, 0]))
    )
    np.testing.assert_allclose(cos, 0.0, atol=1e-5)


def test_lens_offset_preserves_focal_plane_point():
    # defocus: rays from different lens samples must intersect at the focal
    # plane (that is what "in focus" means)
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=60,
                         aspect_ratio=1.0, aperture=0.5, focus_dist=5.0)
    st = (jnp.array([[0.3]]), jnp.array([[0.7]]))
    o1, d1 = cam.rays(*st, lens_uv=jnp.array([[[0.4, -0.2]]]))
    o2, d2 = cam.rays(*st, lens_uv=jnp.array([[[-0.3, 0.5]]]))
    # point at t where z = -5 (focal plane) for each ray
    t1 = (-5.0 - o1[0, 0, 2]) / d1[0, 0, 2]
    t2 = (-5.0 - o2[0, 0, 2]) / d2[0, 0, 2]
    p1 = o1[0, 0] + t1 * d1[0, 0]
    p2 = o2[0, 0] + t2 * d2[0, 0]
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-5)


def test_zero_aperture_ignores_lens_sample():
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=60,
                         aspect_ratio=1.0, aperture=0.0)
    st = (jnp.array([[0.2]]), jnp.array([[0.8]]))
    o1, d1 = cam.rays(*st, lens_uv=jnp.array([[[0.9, 0.9]]]))
    o2, d2 = cam.rays(*st)
    np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), atol=1e-7)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-7)
