"""Config 4: the RTIOW final scene at 1080p — the headline benchmark content.

Uses the Triton sphere kernel on the GPU (``--backend jnp`` forces the plain
XLA path; backend.choose_backend decides for "auto").

  python demos/demo4_rtiow_final.py --width 1920 --height 1080 --spp 64
"""

from _common import demo_argparser, maybe_force_cpu, png_sink


def main():
    ap = demo_argparser(
        "RTIOW final scene", width=1920, height=1080, spp=64, bounces=8
    )
    ap.add_argument("--backend", default="auto", choices=["auto", "jnp", "triton"])
    args = ap.parse_args()
    maybe_force_cpu(args)

    import time

    import jax
    import jax.numpy as jnp

    from csgrenderer.camera import Camera
    from csgrenderer.models import rtiow_final_scene
    from csgrenderer.render import render_image, tonemap
    from csgrenderer.app.stats import FrameStats

    from csgrenderer.backend import choose_backend
    from csgrenderer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    scene = rtiow_final_scene()
    backend = choose_backend(scene, args.backend)
    camera = Camera.look_at(
        (13, 2, 3), (0, 0, 0), vfov_degrees=20.0,
        aspect_ratio=args.width / args.height, aperture=0.1, focus_dist=10.0,
    )

    if backend == "triton":
        from csgrenderer.kernels import render_image_pallas

        def render(sample_offset):
            return render_image_pallas(
                scene, camera, args.width, args.height, spp=args.spp,
                max_bounces=args.bounces, seed=args.seed, lens=True,
                sample_offset=sample_offset,
            )

    else:

        def render(sample_offset):
            return render_image(
                scene.nearest_hit, camera, args.width, args.height,
                spp=args.spp, max_bounces=args.bounces, seed=args.seed,
                lens=True, sample_offset=sample_offset,
            )

    if backend == "jnp":
        render = jax.jit(render)  # the kernel wrapper jits internally
    sink = png_sink(args.out, "rtiow")
    stats = FrameStats()
    for i in range(args.frames):
        t0 = time.perf_counter()
        radiance, rays = render(jnp.uint32(i * args.spp))
        jax.block_until_ready((radiance, rays))
        dt = time.perf_counter() - t0
        stats.push(dt, rays=int(rays))
        img = tonemap.to_uint8(tonemap.tonemap(radiance))
        sink(i, img)
    print(stats.report_line(stats.dt_sum))


if __name__ == "__main__":
    main()
