"""Demo 9 — next-event estimation on a night scene built from CSG SOLIDS.

demo8 lights a sphere soup; this one lights booleans: a bitten sphere
(sphere ∖ box), a glass lens (sphere ∩ sphere), a metal ring (cylinder ∖
cylinder) under two emissive sphere LEAVES riding the compiled tape. The
shadow rays reuse the event-flip tape evaluator (kernels/tape_kernel.py
``nee=True``); without NEE the black-sky scene is a noise field at 64 spp.

Run: python demos/demo9_csg_night.py --out /tmp/csg_night.png
     python demos/demo9_csg_night.py --no-nee   (compare the noise)
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
from csgrenderer.models import csg_night_scene
from csgrenderer.render import tonemap


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--bounces", type=int, default=6)
    ap.add_argument("--out", default="/tmp/csgr_demo9_csg_night.png")
    ap.add_argument("--nee", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="next-event estimation (--no-nee = plain PT)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "triton", "jnp"])
    args = ap.parse_args(argv)

    tape = csg_night_scene().compile(k=4)
    cam = Camera.look_at(
        (4.5, 2.6, 4.8), (0.0, 0.8, 0.3),
        vfov_degrees=38.0, aspect_ratio=args.width / args.height,
    )

    from csgrenderer.backend import choose_backend
    from csgrenderer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    backend = choose_backend(tape, args.backend)
    t0 = time.perf_counter()
    if backend == "triton":
        from csgrenderer.kernels import render_image_tape_pallas

        img, rays = render_image_tape_pallas(
            tape, cam, args.width, args.height, spp=args.spp,
            max_bounces=args.bounces, seed=9, sky="black", nee=args.nee,
        )
    else:
        from functools import partial

        from csgrenderer.render import render_image
        from csgrenderer.render.integrator import tape_hit_adapter
        from csgrenderer.render.lights import extract_tape_lights

        img, rays = render_image(
            partial(tape_hit_adapter, tape), cam, args.width, args.height,
            spp=args.spp, max_bounces=args.bounces, seed=9, sky="black",
            lights=extract_tape_lights(tape) if args.nee else None,
        )
    r = int(rays)
    dt = time.perf_counter() - t0
    out = tonemap.to_uint8(tonemap.tonemap(img, gamma=2.0))
    image_io.write_png(args.out, np.asarray(out))
    print(
        f"[csgr] demo9: {tape.n_leaves}-leaf CSG tape, "
        f"{args.width}x{args.height} spp={args.spp} "
        f"nee={'on' if args.nee else 'off'} via {backend}: "
        f"{r/dt/1e6:.1f} Mrays/s (incl. compile) -> {args.out}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
