"""Unified CLI: ``python -m csgrenderer <command> ...``.

The reference has no CLI at all (SURVEY §5: config is compile-time macros);
here every benchmark config is reachable from one entry point.

Commands:
  render     render a built-in scene to PNG (choose scene/backend/size)
  gif        render an animated scene to an animated GIF
  bench      run the benchmark (same as bench.py)
  info       print devices, backends, scene inventory
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _add_common(ap):
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--bounces", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto", choices=["auto", "jnp", "triton"])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--denoise", action="store_true",
                    help="a-trous/SVGF denoise guided by the AOV G-buffer "
                    "(render/denoise.py) — low-spp renders converge visually "
                    "at a fraction of the sample cost")
    ap.add_argument("--denoise-iters", type=int, default=4,
                    help="a-trous passes (filter radius 2^iters pixels)")


SCENES = ("milestone01", "diffuse", "csg", "rtiow", "deepcsg", "csgnight",
          "manyobjects", "meshnight")


def _build(scene_name: str, aspect: float):
    from csgrenderer.camera import Camera
    from csgrenderer.models import (
        animated_csg_scene,
        config3_csg_scene,
        csg_night_scene,
        rtiow_final_scene,
        two_spheres_scene,
    )

    if scene_name == "diffuse":
        return (
            two_spheres_scene(),
            Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0,
                           aspect_ratio=aspect),
            dict(),
        )
    if scene_name == "csg":
        return (
            config3_csg_scene().compile(),
            Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0,
                           aspect_ratio=aspect),
            dict(),
        )
    if scene_name == "rtiow":
        return (
            rtiow_final_scene(),
            Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20.0,
                           aspect_ratio=aspect, aperture=0.1, focus_dist=10.0),
            dict(lens=True),
        )
    if scene_name == "csgnight":
        return (
            csg_night_scene().compile(k=4),
            Camera.look_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3),
                           vfov_degrees=38.0, aspect_ratio=aspect),
            dict(sky="black", nee=True),
        )
    if scene_name == "deepcsg":
        graph, animate = animated_csg_scene(8)
        return (
            animate(graph.compile(), 1.0),
            Camera.look_at((0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0,
                           aspect_ratio=aspect),
            dict(),
        )
    if scene_name == "meshnight":
        from csgrenderer.models import mesh_night_scene

        return (
            mesh_night_scene(),
            Camera.look_at((0, 1.8, 2.4), (0, 0.7, -2.6),
                           vfov_degrees=45.0, aspect_ratio=aspect),
            dict(sky="black", nee=True),
        )
    if scene_name == "manyobjects":
        from csgrenderer.models import many_objects_scene

        return (
            many_objects_scene().compile(),
            Camera.look_at((9.0, 7.5, 12.0), (0.0, 0.3, 0.0),
                           vfov_degrees=42.0, aspect_ratio=aspect),
            dict(),
        )
    raise SystemExit(f"unknown scene {scene_name!r} (choose from {SCENES})")


def cmd_render(args):
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from csgrenderer.app import PathTraceRenderer, WololoRenderer
    from csgrenderer.io import image
    from csgrenderer.utils.config import RenderConfig

    if args.scene == "milestone01":
        r = WololoRenderer(
            RenderConfig(width=args.width, height=args.height, spp=1, sky="wololo")
        )
        img = np.asarray(r.draw_frame(args.time))
    else:
        scene, camera, extra = _build(args.scene, args.width / args.height)
        cfg = RenderConfig(
            width=args.width, height=args.height, spp=args.spp,
            max_bounces=args.bounces, seed=args.seed,
            denoise=args.denoise, denoise_iterations=args.denoise_iters,
            **extra,
        )
        r = PathTraceRenderer(scene, camera, cfg, backend=args.backend)
        if getattr(args, "target_noise", None) is not None:
            acc, noise, used = r.render_to_noise(
                target=args.target_noise, max_spp=args.max_spp,
                time_sec=args.time,
            )
            print(f"[csgr] render-to-noise: {used} spp, measured noise "
                  f"{noise:.2e} (target {args.target_noise:.1e})")
            img = np.asarray(
                r._tonemap(r.denoise_image(acc.image(), args.time))
            )
        else:
            img = np.asarray(r.draw_frame(args.time))
    image.write_png(args.out, img)
    print(f"[csgr] wrote {args.out} ({args.width}x{args.height})")


def cmd_gif(args):
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from csgrenderer.app import PathTraceRenderer, WololoRenderer
    from csgrenderer.io import write_gif
    from csgrenderer.models import animated_csg_scene
    from csgrenderer.camera import Camera
    from csgrenderer.utils.config import RenderConfig

    frames = []
    if args.scene == "milestone01":
        r = WololoRenderer(
            RenderConfig(width=args.width, height=args.height, spp=1, sky="wololo")
        )
        for i in range(args.frames):
            frames.append(np.asarray(r.draw_frame(i / args.fps)))
    elif args.scene == "deepcsg":
        graph, animate = animated_csg_scene(8)
        cfg = RenderConfig(
            width=args.width, height=args.height, spp=args.spp,
            max_bounces=args.bounces, seed=args.seed,
            denoise=args.denoise, denoise_iterations=args.denoise_iters,
        )
        r = PathTraceRenderer(
            graph.compile(), Camera.look_at(
                (0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0,
                aspect_ratio=args.width / args.height,
            ), cfg, animate=animate, backend=args.backend,
        )
        for i in range(args.frames):
            frames.append(np.asarray(r.draw_frame(i / args.fps)))
    else:
        raise SystemExit("gif supports scenes: milestone01, deepcsg")
    write_gif(args.out, frames, fps=args.fps)
    print(f"[csgr] wrote {args.out} ({len(frames)} frames)")


def cmd_info(args):
    import jax

    import csgrenderer

    print(f"csgrenderer {csgrenderer.__version__}")
    print(f"devices: {jax.devices()}")
    print(f"scenes: {', '.join(SCENES)}")
    try:
        from csgrenderer.scene.native import ensure_built

        print(f"native scene core: {ensure_built()}")
    except Exception as e:  # pragma: no cover
        print(f"native scene core: unavailable ({e})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="csgrenderer", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("--scene", default="rtiow", choices=SCENES)
    r.add_argument("--time", type=float, default=0.0)
    r.add_argument("--target-noise", type=float, default=None,
                   help="render to MEASURED noise instead of one --spp "
                   "frame: accumulate spp chunks until the two-stream "
                   "estimate reaches this (e.g. 1e-3)")
    r.add_argument("--max-spp", type=int, default=1 << 14)
    _add_common(r)
    r.set_defaults(fn=cmd_render)

    g = sub.add_parser("gif", help="render an animation to GIF")
    g.add_argument("--scene", default="deepcsg")
    g.add_argument("--frames", type=int, default=12)
    g.add_argument("--fps", type=float, default=8.0)
    _add_common(g)
    g.set_defaults(fn=cmd_gif)

    b = sub.add_parser("bench", help="run the benchmark")
    b.add_argument("--quick", action="store_true")
    b.set_defaults(fn=None)

    i = sub.add_parser("info", help="devices and inventory")
    i.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    if args.cmd == "bench":
        import subprocess

        # bench.py runs in its own process and this parent never touches
        # JAX: a JAX process reserves most of the card's memory when it
        # first uses it, so a parent holding the card would starve the
        # benchmark. Resolved relative to the package so `python -m
        # csgrenderer bench` works from any CWD.
        bench_path = Path(__file__).resolve().parent.parent / "bench.py"
        cmd = [sys.executable, str(bench_path)] + (
            ["--quick"] if args.quick else []
        )
        raise SystemExit(subprocess.call(cmd))
    from csgrenderer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
