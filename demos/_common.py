"""Shared demo plumbing: argument parsing, frame sinks, run loop."""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from csgrenderer.app import App, StatsClock
from csgrenderer.io import image


def demo_argparser(description: str, **defaults) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--width", type=int, default=defaults.get("width", 1280))
    ap.add_argument("--height", type=int, default=defaults.get("height", 720))
    ap.add_argument("--spp", type=int, default=defaults.get("spp", 16))
    ap.add_argument("--bounces", type=int, default=defaults.get("bounces", 8))
    ap.add_argument("--frames", type=int, default=defaults.get("frames", 1))
    ap.add_argument("--seed", type=int, default=defaults.get("seed", 0))
    ap.add_argument("--out", type=str, default=defaults.get("out", "out"))
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    return ap


def maybe_force_cpu(args) -> None:
    """Apply --cpu, then point JAX's compile cache at its fixed place."""
    from csgrenderer.utils.compile_cache import enable_compile_cache

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()


def png_sink(out_dir: str, prefix: str):
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def sink(frame_idx: int, img) -> None:
        path = out / f"{prefix}_{frame_idx:04d}.png"
        image.write_png(path, np.asarray(img))
        print(f"[csgr] wrote {path}")

    return sink


def run_demo(renderer, args, prefix: str, ups: float = 60.0) -> None:
    """Drive a renderer through the App loop for --frames frames."""
    app = App(
        target_updates_per_sec=ups,
        width=args.width,
        height=args.height,
        caption=prefix,
        init_cb=lambda app, w, h, cap, dt: (app.swap_scene(renderer), True)[1],
        frame_sink=png_sink(args.out, prefix),
        stats=StatsClock(),
    )
    ok = app.run(max_frames=args.frames)
    if not ok:
        raise SystemExit(1)
