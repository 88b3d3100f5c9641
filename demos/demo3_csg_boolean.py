"""Config 3: (sphere ∪ box) ∖ cylinder via the flattened CSG tape.

  python demos/demo3_csg_boolean.py --width 512 --height 512 --spp 16
"""

from _common import demo_argparser, maybe_force_cpu, run_demo


def main():
    ap = demo_argparser(
        "CSG boolean scene", width=512, height=512, spp=16, bounces=6
    )
    ap.add_argument(
        "--native", action="store_true",
        help="build the scene through the C++ scene core",
    )
    args = ap.parse_args()
    maybe_force_cpu(args)

    from csgrenderer.app import PathTraceRenderer
    from csgrenderer.camera import Camera
    from csgrenderer.utils.config import RenderConfig

    if args.native:
        from csgrenderer.scene.native import NativeSceneGraph
        from csgrenderer.scene import Material, NodeArgument

        g = NativeSceneGraph(max_node_count=16)
        s = g.add_sphere_node(1.0, Material.lambertian((0.75, 0.25, 0.25)))
        b = g.add_box_node((0.8, 0.8, 0.8), Material.lambertian((0.25, 0.75, 0.25)))
        c = g.add_cylinder_node(0.55, 1.6, Material.lambertian((0.25, 0.25, 0.75)))
        u = g.add_union_of_node(
            NodeArgument(s, offset=(-0.3, 0.0, 0.0)),
            NodeArgument(b, offset=(0.5, 0.0, 0.0)),
        )
        root = g.add_difference_of_node(NodeArgument(u), NodeArgument(c))
        tape = g.compile(root)
    else:
        from csgrenderer.models import config3_csg_scene

        tape = config3_csg_scene().compile()

    camera = Camera.look_at(
        (3, 2.5, 4), (0.1, 0, 0),
        vfov_degrees=35.0, aspect_ratio=args.width / args.height,
    )
    renderer = PathTraceRenderer(
        tape,
        camera,
        RenderConfig(
            width=args.width, height=args.height, spp=args.spp,
            max_bounces=args.bounces, seed=args.seed,
        ),
    )
    run_demo(renderer, args, "csg")


if __name__ == "__main__":
    main()
