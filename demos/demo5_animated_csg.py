"""Config 5: animated depth-8 CSG with orbiting camera, progressive 4K.

Per frame the edge transforms re-bake *inside jit* (no recompiles) and the
camera orbits; progressive accumulation state is checkpointable with
``--checkpoint`` and resumes with ``--resume``.

  python demos/demo5_animated_csg.py --width 3840 --height 2160 --frames 8
  python demos/demo5_animated_csg.py --width 512 --height 512 --frames 4 --cpu
"""

import math

from _common import demo_argparser, maybe_force_cpu, png_sink


def main():
    ap = demo_argparser(
        "animated deep CSG, progressive", width=3840, height=2160,
        spp=2, bounces=5, frames=4,
    )
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--orbit", action="store_true",
                    help="orbit the camera per frame (disables accumulation)")
    ap.add_argument("--target-noise", type=float, default=None,
                    help="render to MEASURED noise instead of --frames: "
                    "accumulate spp chunks until the two-stream estimate "
                    "reaches this (e.g. 1e-3, the fidelity budget)")
    ap.add_argument("--max-spp", type=int, default=1 << 14,
                    help="noise-targeted rendering stops here regardless")
    args = ap.parse_args()
    maybe_force_cpu(args)

    import numpy as np

    from csgrenderer.app import PathTraceRenderer
    from csgrenderer.camera import Camera
    from csgrenderer.io import checkpoint
    from csgrenderer.models import animated_csg_scene
    from csgrenderer.utils.config import RenderConfig

    graph, animate = animated_csg_scene(n_levels=8)
    tape = graph.compile()

    def camera_at(angle: float) -> Camera:
        r = 7.0
        return Camera.look_at(
            (r * math.sin(angle), 2.0, r * math.cos(angle)),
            (0.5, 0, 0),
            vfov_degrees=40.0,
            aspect_ratio=args.width / args.height,
        )

    cfg = RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        max_bounces=args.bounces, seed=args.seed,
    )

    if args.orbit:
        # animated flythrough: new camera per frame -> recompile per camera is
        # avoided by keeping the camera a traced pytree argument; the
        # PathTraceRenderer closes over it, so here we rebuild renderers only
        # for demonstration simplicity at small frame counts.
        sink = png_sink(args.out, "deepcsg")
        for i in range(args.frames):
            renderer = PathTraceRenderer(
                tape, camera_at(0.15 * i), cfg, animate=animate
            )
            sink(i, renderer.draw_frame(i / 24.0))
        return

    renderer = PathTraceRenderer(
        tape, camera_at(0.6), cfg, animate=animate, progressive=True
    )
    if args.resume:
        renderer.accumulator, meta = checkpoint.load(args.resume)
        renderer._sample_offset = int(renderer.accumulator.sample_count)
        print(f"[csgr] resumed at {int(renderer.accumulator.sample_count)} spp")

    sink = png_sink(args.out, "deepcsg")
    t_frozen = 1.0  # progressive accumulation needs a frozen scene time
    if args.target_noise is not None:
        acc, noise, used = renderer.render_to_noise(
            target=args.target_noise, max_spp=args.max_spp,
            time_sec=t_frozen,
        )
        print(f"[csgr] render-to-noise: {used} spp, measured noise "
              f"{noise:.2e} (target {args.target_noise:.1e})")
        sink(0, np.asarray(renderer._tonemap(acc.image())))
    else:
        for i in range(args.frames):
            img = renderer.draw_frame(t_frozen)
            sink(i, np.asarray(img))
    print(
        f"[csgr] accumulated {int(renderer.accumulator.sample_count)} spp, "
        f"{int(renderer.accumulator.rays_traced)} rays"
    )
    if args.checkpoint:
        checkpoint.save(args.checkpoint, renderer.accumulator)
        print(f"[csgr] checkpoint -> {args.checkpoint}")


if __name__ == "__main__":
    main()
