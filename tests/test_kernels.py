"""Triton sphere-kernel validation against the pure-jnp reference (the
Pallas interpreter on the CPU).

Exact bit-parity is not expected: the kernel's per-lane quadratic groups
its terms differently from the jnp path's batched form in the last ulps,
which flips rare silhouette hits whose paths then diverge through the RNG.
Tolerances here bound that effect; chip_smoke.py compares the compiled
kernel with the same bound on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csgrenderer.camera import Camera
from csgrenderer.kernels import render_image_pallas
from csgrenderer.models import rtiow_final_scene, two_spheres_scene
from csgrenderer.render import render_image


def compare(scene, cam, w, h, spp, bounces, seed, lens=False, tol=2e-2):
    ref, ref_rays = render_image(
        scene.nearest_hit, cam, w, h, spp=spp, max_bounces=bounces,
        seed=seed, lens=lens,
    )
    img, rays = render_image_pallas(
        scene, cam, w, h, spp=spp, max_bounces=bounces, seed=seed,
        lens=lens, interpret=True,
    )
    ref, img = np.asarray(ref), np.asarray(img)
    assert not np.isnan(img).any()
    rmse = float(np.sqrt(np.mean((ref - img) ** 2)))
    assert rmse <= tol, f"rmse {rmse}"
    # at most a handful of pixels may diverge (silhouette-tie path splits)
    frac_bad = float((np.abs(ref - img).max(axis=-1) > 0.05).mean())
    assert frac_bad <= 0.01, f"{frac_bad:.3%} divergent pixels"
    assert abs(int(rays) - int(ref_rays)) <= max(int(ref_rays) * 2e-3, 8)
    return img


def test_two_spheres_matches_reference():
    scene = two_spheres_scene()
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=2.0)
    compare(scene, cam, 64, 32, spp=4, bounces=4, seed=5)


def test_rtiow_scene_matches_reference_with_lens():
    scene = rtiow_final_scene(grid=4)  # small sphere count for CI speed
    cam = Camera.look_at(
        (13, 2, 3), (0, 0, 0), vfov_degrees=20, aspect_ratio=2.0,
        aperture=0.1, focus_dist=10.0,
    )
    compare(scene, cam, 64, 32, spp=4, bounces=6, seed=7, lens=True)


def test_non_tile_aligned_resolution():
    # 50x30 = 1500 pixels: not a multiple of the 128-ray block
    scene = two_spheres_scene()
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=50 / 30)
    img = compare(scene, cam, 50, 30, spp=2, bounces=3, seed=1)
    assert img.shape == (30, 50, 3)


def test_sample_offset_changes_noise():
    scene = two_spheres_scene()
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=2.0)
    a, _ = render_image_pallas(
        scene, cam, 64, 32, spp=1, max_bounces=3, seed=5, interpret=True
    )
    b, _ = render_image_pallas(
        scene, cam, 64, 32, spp=1, max_bounces=3, seed=5,
        sample_offset=1, interpret=True,
    )
    assert np.abs(np.asarray(a) - np.asarray(b)).max() > 1e-4


def test_deterministic():
    scene = two_spheres_scene()
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=2.0)
    a, ra = render_image_pallas(
        scene, cam, 64, 32, spp=2, max_bounces=3, seed=5, interpret=True
    )
    b, rb = render_image_pallas(
        scene, cam, 64, 32, spp=2, max_bounces=3, seed=5, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(ra) == int(rb)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["sphere", "tape"])
def test_compiled_kernels_match_reference_on_the_card(gpu, family):
    """The kernels as the GPU compiler builds them (no interpreter), against
    the jnp reference on the same card, at the bound of ``compare``."""
    import functools

    from csgrenderer.kernels import render_image_tape_pallas
    from csgrenderer.models import config3_csg_scene
    from csgrenderer.render import tape_hit_adapter

    with jax.default_device(gpu):
        if family == "sphere":
            scene = rtiow_final_scene()
            cam = Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20,
                                 aspect_ratio=2.0, aperture=0.1,
                                 focus_dist=10.0)
            img, rays = render_image_pallas(scene, cam, 128, 64, spp=16,
                                            seed=3, lens=True)
            ref, ref_rays = render_image(scene.nearest_hit, cam, 128, 64,
                                         spp=16, seed=3, lens=True)
        else:
            tape = config3_csg_scene().compile(k=2)
            cam = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35,
                                 aspect_ratio=2.0)
            img, rays = render_image_tape_pallas(tape, cam, 128, 64, spp=16,
                                                 seed=3)
            ref, ref_rays = render_image(
                functools.partial(tape_hit_adapter, tape), cam, 128, 64,
                spp=16, seed=3)
    img, ref = np.asarray(img), np.asarray(ref)
    assert float(np.sqrt(np.mean((ref - img) ** 2))) <= 2e-2
    assert float((np.abs(ref - img).max(axis=-1) > 0.05).mean()) <= 0.01
    assert abs(int(rays) - int(ref_rays)) <= max(int(ref_rays) * 2e-3, 8)
