"""Config 2: two spheres + ground, Lambertian 8-bounce path trace.

  python demos/demo2_diffuse_spheres.py --width 800 --height 450 --spp 16
"""

from _common import demo_argparser, maybe_force_cpu, run_demo


def main():
    args = demo_argparser(
        "diffuse two-sphere path trace", width=800, height=450, spp=16, bounces=8
    ).parse_args()
    maybe_force_cpu(args)

    from csgrenderer.app import PathTraceRenderer
    from csgrenderer.camera import Camera
    from csgrenderer.models import two_spheres_scene
    from csgrenderer.utils.config import RenderConfig

    camera = Camera.look_at(
        (0, 0, 0), (0, 0, -1),
        vfov_degrees=90.0, aspect_ratio=args.width / args.height,
    )
    renderer = PathTraceRenderer(
        two_spheres_scene(),
        camera,
        RenderConfig(
            width=args.width, height=args.height, spp=args.spp,
            max_bounces=args.bounces, seed=args.seed,
        ),
    )
    run_demo(renderer, args, "diffuse")


if __name__ == "__main__":
    main()
