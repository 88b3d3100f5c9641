"""Config 1: milestone-01 — animated normal-shaded sphere on a sky gradient.

The JAX re-expression of the reference demo (``src/wololo_demo/main.c`` +
``ubershader1.frag``): same scene-graph build, same hard-coded shader scene,
1280x720 "Test 1" semantics, headless frames to PNG.

  python demos/demo1_sphere_normals.py --frames 3 --width 640 --height 480
"""

from _common import demo_argparser, maybe_force_cpu, run_demo


def main():
    args = demo_argparser(
        "milestone-01 sphere normals", width=640, height=480, spp=1, frames=1
    ).parse_args()
    maybe_force_cpu(args)

    from csgrenderer.app import WololoRenderer
    from csgrenderer.models import milestone01_scene_graph
    from csgrenderer.utils.config import RenderConfig

    # The scene-graph side of the reference demo (main.c:40-50): build the
    # union and print the root flags the demo prints.
    graph = milestone01_scene_graph()
    print(
        "Sphere1 is root: %d\nSphere2 is root: %d\nBlob is root: %d"
        % (graph.is_root(0), graph.is_root(1), graph.is_root(2))
    )

    renderer = WololoRenderer(
        RenderConfig(width=args.width, height=args.height, spp=1, sky="wololo")
    )
    run_demo(renderer, args, "milestone01")


if __name__ == "__main__":
    main()
