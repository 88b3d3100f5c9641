"""Regenerate golden images for tests/goldens/ (CPU backend, deterministic).

Scaled-down versions of the five BASELINE.json configs — small enough for CI,
same code paths as the full-resolution demos. Goldens are produced by OUR
reference (pure-jnp) implementation on the CPU: the GLSL original isn't
runnable here (SURVEY §7 hard part #5), so these renders define the
expected images. ``golden_specs`` renders through the normal path of
whatever backend is active: chip_smoke.py compares the card's kernels
with the goldens through it.

Run: python tools/make_goldens.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from csgrenderer.app.renderers import PathTraceRenderer, WololoRenderer  # noqa: E402
from csgrenderer.camera import Camera  # noqa: E402
from csgrenderer.io import image  # noqa: E402
from csgrenderer.models import (  # noqa: E402
    animated_csg_scene,
    config3_csg_scene,
    rtiow_final_scene,
    two_spheres_scene,
)
from csgrenderer.utils.config import RenderConfig  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent.parent / "tests" / "goldens"


def golden_specs():
    """name -> () -> uint8 image. Shared by generator and tests."""

    def config1():
        r = WololoRenderer(RenderConfig(width=320, height=240, spp=1, sky="wololo"))
        return np.asarray(r.draw_frame(0.25))

    def config2():
        cam = Camera.look_at(
            (0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=200 / 112
        )
        r = PathTraceRenderer(
            two_spheres_scene(),
            cam,
            RenderConfig(width=200, height=112, spp=8, max_bounces=8, seed=2),
        )
        return np.asarray(r.draw_frame(0.0))

    def config3():
        cam = Camera.look_at(
            (3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0, aspect_ratio=1.0
        )
        r = PathTraceRenderer(
            config3_csg_scene().compile(),
            cam,
            RenderConfig(width=128, height=128, spp=8, max_bounces=6, seed=3),
        )
        return np.asarray(r.draw_frame(0.0))

    def config4():
        cam = Camera.look_at(
            (13, 2, 3), (0, 0, 0), vfov_degrees=20.0,
            aspect_ratio=160 / 90, aperture=0.1, focus_dist=10.0,
        )
        r = PathTraceRenderer(
            rtiow_final_scene(),
            cam,
            RenderConfig(width=160, height=90, spp=4, max_bounces=8, seed=4, lens=True),
        )
        return np.asarray(r.draw_frame(0.0))

    def config5():
        graph, animate = animated_csg_scene(n_levels=8)
        cam = Camera.look_at(
            (0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0, aspect_ratio=1.0
        )
        r = PathTraceRenderer(
            graph.compile(),
            cam,
            RenderConfig(width=128, height=128, spp=2, max_bounces=5, seed=5),
            animate=animate,
        )
        return np.asarray(r.draw_frame(1.0))

    def config7():
        # mesh NEE (round 3b): emissive-face TriLights + MIS on the jnp
        # reference — the image-level regression net for the mesh-lamp
        # estimator (kernel parity is asserted separately in test_nee.py)
        from csgrenderer.models import mesh_night_scene

        cam = Camera.look_at(
            (0, 1.8, 2.4), (0, 0.7, -2.6), vfov_degrees=45.0,
            aspect_ratio=160 / 90,
        )
        r = PathTraceRenderer(
            mesh_night_scene(),
            cam,
            RenderConfig(width=160, height=90, spp=8, max_bounces=5,
                         seed=7, sky="black", nee=True),
        )
        return np.asarray(r.draw_frame(0.0))

    return {
        "config1_milestone01": config1,
        "config2_two_spheres": config2,
        "config3_csg_boolean": config3,
        "config4_rtiow_final": config4,
        "config5_animated_csg": config5,
        "config7_meshnight": config7,
    }


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    GOLDEN_DIR.mkdir(parents=True, exist_ok=True)
    for name, fn in golden_specs().items():
        img = fn()
        path = GOLDEN_DIR / f"{name}.png"
        image.write_png(path, img)
        print(f"wrote {path}  {img.shape}  mean={img.mean():.1f}")


if __name__ == "__main__":
    main()
