"""Demo 8 — next-event estimation on an emissive-lit night scene.

The reference declares `Wo_Material` and never uses it (renderer.h:16);
this framework's material set includes emissive spheres, and for black-sky
scenes lit by small lamps, plain path tracing only finds light by chance.
NEE (render/lights.py) samples the lamps directly at every diffuse hit —
same expectation, a fraction of the noise.

Run: python demos/demo8_night.py --out /tmp/night.png
     python demos/demo8_night.py --no-nee   (compare the noise)
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from csgrenderer.camera import Camera
from csgrenderer.io import image as image_io
from csgrenderer.models import night_scene
from csgrenderer.render import tonemap


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--bounces", type=int, default=6)
    ap.add_argument("--out", default="/tmp/csgr_demo8_night.png")
    ap.add_argument("--nee", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="next-event estimation (--no-nee = plain PT)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "triton", "jnp"])
    args = ap.parse_args(argv)

    scene = night_scene()
    cam = Camera.look_at(
        (6.5, 2.2, 6.5), (0.0, 0.6, 0.0),
        vfov_degrees=32.0, aspect_ratio=args.width / args.height,
    )

    from csgrenderer.backend import choose_backend
    from csgrenderer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    backend = choose_backend(scene, args.backend)
    t0 = time.perf_counter()
    if backend == "triton":
        from csgrenderer.kernels import render_image_pallas

        img, rays = render_image_pallas(
            scene, cam, args.width, args.height, spp=args.spp,
            max_bounces=args.bounces, seed=5, sky="black", nee=args.nee,
        )
    else:
        from csgrenderer.render import render_image
        from csgrenderer.render.lights import extract_lights

        img, rays = render_image(
            scene.nearest_hit, cam, args.width, args.height, spp=args.spp,
            max_bounces=args.bounces, seed=5, sky="black",
            lights=extract_lights(scene) if args.nee else None,
        )
    r = int(rays)
    dt = time.perf_counter() - t0
    out = tonemap.to_uint8(tonemap.tonemap(img, gamma=2.0))
    image_io.write_png(args.out, np.asarray(out))
    print(
        f"[csgr] demo8: {scene.num_spheres} spheres, "
        f"{args.width}x{args.height} spp={args.spp} "
        f"nee={'on' if args.nee else 'off'} via {backend}: "
        f"{r/dt/1e6:.1f} Mrays/s (incl. compile) -> {args.out}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
