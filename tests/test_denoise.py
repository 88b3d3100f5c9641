"""AOV pass (render/aov.py) + a-trous denoiser (render/denoise.py).

Beyond-reference components (the reference outputs beauty color only,
ubershader1.frag:160-163). Coverage: G-buffer correctness/alignment on a
real scene, measured noise reduction against a high-spp reference render,
edge preservation across normal/depth discontinuities, hit-gate behavior
at silhouettes, and jit purity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csgrenderer.camera import Camera
from csgrenderer.models import two_spheres_scene
from csgrenderer.render import (
    AOVs,
    atrous_denoise,
    denoise_frame,
    render_aovs,
    render_image,
)

W, H = 96, 54


@pytest.fixture(scope="module")
def diffuse_setup():
    scene = two_spheres_scene()
    camera = Camera.look_at(
        (0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=W / H
    )
    return scene, camera


def test_aovs_shapes_and_alignment(diffuse_setup):
    scene, camera = diffuse_setup
    aovs = render_aovs(scene.nearest_hit, camera, W, H)
    assert aovs.depth.shape == (H, W)
    assert aovs.normal.shape == (H, W, 3)
    assert aovs.albedo.shape == (H, W, 3)
    assert aovs.hit.shape == (H, W)

    # center pixel: the small sphere at (0,0,-1) — a hit, unit normal
    # facing roughly +z (toward the camera), finite positive depth
    cy, cx = H // 2, W // 2
    assert bool(aovs.hit[cy, cx])
    assert float(aovs.depth[cy, cx]) == pytest.approx(0.5, abs=0.05)
    n = np.asarray(aovs.normal[cy, cx])
    assert np.linalg.norm(n) == pytest.approx(1.0, abs=1e-4)
    assert n[2] > 0.9

    # top-left pixel: sky — miss, inf depth, zero normal, sky albedo
    assert not bool(aovs.hit[0, 0])
    assert not np.isfinite(float(aovs.depth[0, 0]))
    assert np.allclose(np.asarray(aovs.normal[0, 0]), 0.0)
    alb = np.asarray(aovs.albedo[0, 0])
    assert alb[2] >= alb[0]  # sky gradient is blue-heavy at the top


def test_denoise_reduces_noise_vs_reference(diffuse_setup):
    scene, camera = diffuse_setup
    noisy, _ = render_image(
        scene.nearest_hit, camera, W, H, spp=2, max_bounces=4, seed=0
    )
    ref, _ = render_image(
        scene.nearest_hit, camera, W, H, spp=256, max_bounces=4, seed=1
    )
    aovs = render_aovs(scene.nearest_hit, camera, W, H)
    den = atrous_denoise(noisy, aovs)

    rmse_noisy = float(jnp.sqrt(jnp.mean((noisy - ref) ** 2)))
    rmse_den = float(jnp.sqrt(jnp.mean((den - ref) ** 2)))
    # the filter must cut at least 40% of the 2-spp error
    assert rmse_den < 0.6 * rmse_noisy
    assert np.all(np.isfinite(np.asarray(den)))


def test_denoise_frame_convenience_matches_manual(diffuse_setup):
    scene, camera = diffuse_setup
    noisy, _ = render_image(
        scene.nearest_hit, camera, W, H, spp=2, max_bounces=3, seed=0
    )
    a = denoise_frame(noisy, scene.nearest_hit, camera, iterations=2)
    aovs = render_aovs(scene.nearest_hit, camera, W, H)
    b = atrous_denoise(noisy, aovs, iterations=2)
    assert np.allclose(np.asarray(a), np.asarray(b))


def _synthetic_edge(h=32, w=32, noise=0.15, seed=0):
    """Two flat regions split at w//2 by a joint normal+depth edge."""
    rng = np.random.default_rng(seed)
    left = np.zeros((h, w), bool)
    left[:, : w // 2] = True
    color = np.where(left[..., None], 0.2, 0.8).astype(np.float32)
    noisy = color + rng.normal(0.0, noise, color.shape).astype(np.float32)
    normal = np.where(
        left[..., None], np.array([0, 0, 1.0]), np.array([1.0, 0, 0])
    ).astype(np.float32)
    depth = np.where(left, 1.0, 2.0).astype(np.float32)
    aovs = AOVs(
        depth=jnp.asarray(depth),
        normal=jnp.asarray(normal),
        albedo=jnp.ones((h, w, 3), jnp.float32),
        hit=jnp.ones((h, w), bool),
    )
    return jnp.asarray(noisy), jnp.asarray(color), aovs, left


def test_denoise_smooths_flat_regions_without_edge_bleed():
    noisy, clean, aovs, left = _synthetic_edge()
    den = np.asarray(atrous_denoise(noisy, aovs, iterations=3))
    # intra-region noise drops by >3x
    err_in = np.abs(np.asarray(noisy) - np.asarray(clean))
    err_out = np.abs(den - np.asarray(clean))
    assert err_out.mean() < err_in.mean() / 3.0
    # the step across the edge survives: region means stay apart
    assert den[:, : den.shape[1] // 2].mean() == pytest.approx(0.2, abs=0.05)
    assert den[:, den.shape[1] // 2 :].mean() == pytest.approx(0.8, abs=0.05)
    # the single pixel columns flanking the edge keep >80% of the step
    step = den[:, den.shape[1] // 2].mean() - den[:, den.shape[1] // 2 - 1].mean()
    assert step > 0.8 * 0.6


def test_denoise_hit_gate_blocks_sky_bleed():
    noisy, clean, aovs, left = _synthetic_edge(noise=0.0)
    # right half becomes sky: hit=False, depth=inf per the AOV contract
    hit = np.asarray(aovs.hit).copy()
    hit[:, hit.shape[1] // 2 :] = False
    depth = np.asarray(aovs.depth).copy()
    depth[:, hit.shape[1] // 2 :] = np.inf
    aovs = aovs._replace(
        hit=jnp.asarray(hit), depth=jnp.asarray(depth)
    )
    den = np.asarray(atrous_denoise(noisy, aovs, iterations=3))
    # noiseless input + hard hit gate: both regions are exactly preserved
    assert np.allclose(den, np.asarray(clean), atol=1e-5)


def test_denoise_is_jit_pure():
    noisy, _, aovs, _ = _synthetic_edge()
    eager = atrous_denoise(noisy, aovs, iterations=2)
    jitted = jax.jit(lambda c, a: atrous_denoise(c, a, iterations=2))(
        noisy, aovs
    )
    assert np.allclose(np.asarray(eager), np.asarray(jitted), atol=1e-6)


# -- round 5: the denoiser as a framework citizen (VERDICT item 2) ----------


def test_aov_row_chunking_matches_unchunked(diffuse_setup):
    scene, camera = diffuse_setup
    full = render_aovs(scene.nearest_hit, camera, W, H)
    # 7 doesn't divide H=54 -> falls back to the largest divisor <= 7 (6)
    chunked = render_aovs(scene.nearest_hit, camera, W, H, row_chunk=7)
    assert np.array_equal(np.asarray(full.hit), np.asarray(chunked.hit))
    for a, b in zip(full[:3], chunked[:3]):
        # lax.map re-fuses the block body: last-ulp XLA:CPU differences
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-3)


def test_mesh_face_chunking_matches_unchunked():
    from csgrenderer.render.trimesh import icosphere
    from csgrenderer.scene.graph import Material

    mesh = icosphere((0, 0, -2), 0.8, Material.lambertian((0.6, 0.3, 0.2)),
                     subdivisions=2)  # 320 faces
    camera = Camera.look_at(
        (0, 0, 0), (0, 0, -1), vfov_degrees=60.0, aspect_ratio=1.0
    )
    full = render_aovs(mesh.nearest_hit, camera, 32, 32)
    chunked = render_aovs(
        lambda o, d: mesh.nearest_hit(o, d, face_chunk=48),  # pads 320->336
        camera, 32, 32, row_chunk=8,
    )
    assert np.array_equal(np.asarray(full.hit), np.asarray(chunked.hit))
    for a, b in zip(full[:3], chunked[:3]):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-3)


def test_renderer_denoise_wiring_improves_rmse(diffuse_setup):
    """PathTraceRenderer(denoise=True) beats the raw frame against a
    converged reference — the full production wiring, not the bare filter."""
    from csgrenderer.app.renderers import PathTraceRenderer
    from csgrenderer.utils.config import RenderConfig

    scene, camera = diffuse_setup
    base = dict(width=W, height=H, spp=2, max_bounces=4, seed=0)
    raw_r = PathTraceRenderer(
        scene, camera, RenderConfig(**base), backend="jnp"
    )
    den_r = PathTraceRenderer(
        scene, camera, RenderConfig(**base, denoise=True), backend="jnp"
    )
    ref, _ = render_image(
        scene.nearest_hit, camera, W, H, spp=256, max_bounces=4, seed=1
    )
    ref8 = np.asarray(raw_r._tonemap(ref), np.float32)
    raw = np.asarray(raw_r.draw_frame(0.0), np.float32)
    den = np.asarray(den_r.draw_frame(0.0), np.float32)
    rmse_raw = np.sqrt(np.mean((raw - ref8) ** 2))
    rmse_den = np.sqrt(np.mean((den - ref8) ** 2))
    assert rmse_den < 0.6 * rmse_raw
    # async path produces the identical denoised frame
    img_async, _ = den_r.draw_frame_async(0.0)
    assert np.array_equal(np.asarray(img_async), den)


def test_renderer_denoise_animated_tape():
    """Animated CompiledTape scenes denoise against the FRAME-TIME
    geometry (the AOV step re-applies `animate` inside jit)."""
    from csgrenderer.app.renderers import PathTraceRenderer
    from csgrenderer.models import animated_csg_scene
    from csgrenderer.utils.config import RenderConfig

    graph, animate = animated_csg_scene(3)
    cam = Camera.look_at(
        (0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0, aspect_ratio=1.5
    )
    cfg = RenderConfig(width=48, height=32, spp=2, max_bounces=3,
                      denoise=True, denoise_iterations=2)
    r = PathTraceRenderer(graph.compile(), cam, cfg, animate=animate,
                          backend="jnp")
    f0 = np.asarray(r.draw_frame(0.0))
    f1 = np.asarray(r.draw_frame(1.0))
    assert f0.shape == (32, 48, 3)
    assert not np.array_equal(f0, f1)  # geometry (and its AOVs) moved
    assert np.isfinite(f0.astype(np.float64)).all()
