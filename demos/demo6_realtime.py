"""Demo 6 — the reference's headline UX, live on the accelerator.

The reference's whole point is a window redrawing an animated sphere at
interactive rates with a per-second stats line (app.c:74-214, 182-187;
1280x720, 60 UPS, "Test 1"). This demo runs exactly that scenario through
the App loop on the accelerator — frame sink is a host ring buffer standing
in for the swapchain (plus an optional GIF tail for eyeballs) — with TWO
frames in flight, i.e. the pipelining the reference constructed sync
objects for and then disabled with a per-frame vkQueueWaitIdle
(renderer.c:51, 2212).

``--scene`` grows it beyond the reference (round 3): "wololo" is the
reference's exact scenario (1 sphere, normal shading); "rtiow" runs the
full RTIOW final scene PATH-TRACED live (the Triton sphere kernel, fresh
noise every frame via advancing sample offsets); "night" adds NEE+MIS
on the emissive night scene. Realtime *path tracing*, not a raster demo.

Run: python demos/demo6_realtime.py --seconds 5
     python demos/demo6_realtime.py --scene rtiow --spp 2
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from csgrenderer.app.loop import App
from csgrenderer.app.renderers import WololoRenderer
from csgrenderer.utils.config import RenderConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--frames-in-flight", type=int, default=2)
    ap.add_argument("--gif", default=None, help="write the last second as GIF")
    ap.add_argument("--readback", default="fence", choices=["fence", "full"],
                    help="'fence': present on-device, 1-element sync every "
                    "--fence-stride frames (no per-frame host copy); "
                    "'full': host copy every frame")
    ap.add_argument("--fence-stride", type=int, default=2)
    ap.add_argument("--min-fps", type=float, default=0.0,
                    help="exit nonzero if sustained fps falls below this")
    ap.add_argument("--scene", default="wololo",
                    choices=["wololo", "rtiow", "night"],
                    help="wololo: reference scenario; rtiow/night: live "
                    "path tracing (fresh noise per frame)")
    ap.add_argument("--spp", type=int, default=2,
                    help="samples/pixel/frame for the path-traced scenes")
    ap.add_argument("--bounces", type=int, default=8)
    ap.add_argument("--denoise", action="store_true",
                    help="a-trous/SVGF denoise each low-spp frame against "
                    "the deterministic AOV G-buffer — the classic realtime "
                    "path-tracing configuration (2 spp + denoise)")
    ap.add_argument("--denoise-iters", type=int, default=3,
                    help="a-trous passes per frame (3 keeps it realtime)")
    ap.add_argument("--target-noise", type=float, default=None,
                    help="adapt spp per frame toward this MEASURED noise "
                    "level (two-stream estimate, app/adaptive.py) instead "
                    "of a fixed --spp")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="live MJPEG preview: watch the run in a browser "
                    "at http://127.0.0.1:PORT/ (app/preview.py — the "
                    "headless analog of the reference's GLFW window)")
    args = ap.parse_args(argv)

    ring = collections.deque(maxlen=32)  # the "swapchain": last 32 frames

    preview = None
    if args.serve is not None:
        from csgrenderer.app.preview import PreviewServer

        preview = PreviewServer(port=args.serve)
        preview.start()
        print(f"[csgr] demo6: live preview at {preview.url}")

    def sink(idx, img):
        ring.append((idx, img))
        if preview is not None:
            preview.publish(np.asarray(img))

    if args.scene == "wololo":
        renderer = WololoRenderer(
            RenderConfig(width=args.width, height=args.height, spp=1,
                         sky="wololo")
        )
    else:
        from csgrenderer.app.renderers import PathTraceRenderer
        from csgrenderer.camera import Camera
        from csgrenderer.models import night_scene, rtiow_final_scene

        aspect = args.width / args.height
        dn = dict(denoise=args.denoise, denoise_iterations=args.denoise_iters)
        if args.scene == "rtiow":
            scene = rtiow_final_scene()
            cam = Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20.0,
                                 aspect_ratio=aspect, aperture=0.1,
                                 focus_dist=10.0)
            cfg = RenderConfig(width=args.width, height=args.height,
                               spp=args.spp, max_bounces=args.bounces,
                               seed=6, lens=True, **dn)
        else:  # night: NEE + MIS, live
            scene = night_scene()
            cam = Camera.look_at((6.5, 2.2, 6.5), (0.0, 0.6, 0.0),
                                 vfov_degrees=32.0, aspect_ratio=aspect)
            cfg = RenderConfig(width=args.width, height=args.height,
                               spp=args.spp, max_bounces=args.bounces,
                               seed=6, sky="black", nee=True, **dn)
        renderer = PathTraceRenderer(scene, cam, cfg, advance_samples=True)
        if args.target_noise is not None:
            from csgrenderer.app.adaptive import AdaptiveSppRenderer

            renderer = AdaptiveSppRenderer(
                scene, cam, cfg, target=args.target_noise,
                probe_stride=16,
            )
    app = App(
        target_updates_per_sec=60.0,
        width=args.width,
        height=args.height,
        caption="Test 1",
        frame_sink=sink,
    )
    app.swap_scene(renderer)

    # browser-driven camera (round 4): drag to orbit, wheel to dolly,
    # Escape to quit — the reference's event poll + window close
    # (app.c:204, 136), delivered over the preview page's /input endpoint
    if preview is not None and args.scene != "wololo":
        from csgrenderer.app.controls import OrbitController, attach

        rig = OrbitController.from_camera(
            cam.origin.tolist() if hasattr(cam, "origin") else (13, 2, 3),
            (0, 0, 0) if args.scene == "rtiow" else (0.0, 0.6, 0.0),
            vfov_degrees=20.0 if args.scene == "rtiow" else 32.0,
            aspect_ratio=aspect,
            aperture=0.1 if args.scene == "rtiow" else 0.0,
            focus_dist=10.0 if args.scene == "rtiow" else None,
        )
        attach(app, renderer, preview, rig)
        print("[csgr] demo6: interactive — drag to orbit, wheel to zoom, "
              "Esc to quit")
    elif preview is not None:
        # wololo's camera is the shader's fixed one; still honor close/Esc
        def _close_watch(app_, dt):
            for ev in preview.poll_events():
                if ev.get("type") == "close" or (
                    ev.get("type") == "key"
                    and ev.get("code") in ("Escape", "q")
                ):
                    app_.stop()

        app.update_cb = _close_watch

    # warm up the jit so the compile doesn't pollute the fps measurement
    np.asarray(renderer.draw_frame(0.0))

    t0 = time.monotonic()
    ok = app.run(max_seconds=args.seconds,
                 frames_in_flight=args.frames_in_flight,
                 readback=args.readback, fence_stride=args.fence_stride)
    wall = time.monotonic() - t0
    frames = ring[-1][0] + 1 if ring else 0
    fps = frames / wall if wall > 0 else 0.0
    print(
        f"[csgr] demo6: {frames} frames in {wall:.2f}s = {fps:.1f} fps "
        f"sustained at {args.width}x{args.height} scene={args.scene} "
        f"({args.frames_in_flight} frames in flight)"
    )

    if preview is not None:
        preview.stop()

    if args.gif and ring:
        from csgrenderer.io.video import write_gif

        # frames may still be device arrays under fence readback: the GIF
        # tail is the one place that pays the full transfer, at the end
        frames_np = [np.asarray(img) for _, img in list(ring)[-16:]]
        write_gif(args.gif, frames_np, fps=10)
        print(f"[csgr] demo6: wrote {args.gif}")

    if not ok:
        return 1
    if args.min_fps and fps < args.min_fps:
        print(f"[csgr] demo6: FAIL sustained {fps:.1f} < {args.min_fps} fps")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
