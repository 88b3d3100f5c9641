"""Benchmark harness: Mrays/s on the RTIOW final scene (BASELINE.json).

Prints ONE JSON line with the median-frame throughput, the p50 frame time
at 16 spp, and the device it ran on (platform, device kind, device count
and, on a GPU, the card's name and power limit from nvidia-smi).

Rays are counted as traced path segments (sum of active rays over every
bounce of every sample), SURVEY §5's accounting. ``value`` is the MEDIAN
frame over ``--frames`` identical frames (fresh sample offsets each); the
mean is reported as ``value_mean`` beside the raw frame times. Every timed
frame ends in ``block_until_ready``.

A measurement needs the card: without a GPU the script exits with an
error unless ``--cpu`` asks for a CPU sanity run, whose numbers are CPU
numbers and say nothing about the card.

Usage:
  python bench.py                    # 1080p, 64 spp, 8 bounces (BASELINE)
  python bench.py --cpu --quick      # small CPU sanity run
  python bench.py --backend jnp      # force the plain XLA path
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp


def build_renderer(width, height, spp, max_bounces, backend):
    """Jitted ``sample_offset -> (radiance, rays)`` for the RTIOW final
    scene through ``backend`` ("triton" or "jnp")."""
    from csgrenderer.camera import Camera
    from csgrenderer.models import rtiow_final_scene
    from csgrenderer.render.integrator import render_image

    scene = rtiow_final_scene()
    camera = Camera.look_at(
        (13.0, 2.0, 3.0),
        (0.0, 0.0, 0.0),
        vfov_degrees=20.0,
        aspect_ratio=width / height,
        aperture=0.1,
        focus_dist=10.0,
    )

    if backend == "triton":
        from csgrenderer.kernels import render_image_pallas

        def run(sample_offset):
            return render_image_pallas(
                scene, camera, width, height, spp=spp,
                max_bounces=max_bounces, seed=0, lens=True,
                sample_offset=sample_offset,
            )

        return run  # the kernel wrapper jits internally

    def run(sample_offset):
        return render_image(
            scene.nearest_hit, camera, width, height, spp=spp,
            max_bounces=max_bounces, seed=0, lens=True,
            sample_offset=sample_offset,
        )

    return jax.jit(run)


def gpu_info() -> str | None:
    """``name, power.limit`` of the card as nvidia-smi reports it, read by
    a child process that stays off JAX; None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def time_frames(fn, n_frames, first_offset=1):
    """Wall time of ``n_frames`` frames, each ending in block_until_ready.
    Returns (times, total rays)."""
    times = []
    total_rays = 0
    for i in range(n_frames):
        t0 = time.perf_counter()
        img, rays = fn(jnp.uint32(first_offset + i))
        jax.block_until_ready((img, rays))
        times.append(time.perf_counter() - t0)
        total_rays += int(rays)
    return times, total_rays


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "jnp", "triton"])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument(
        "--p50", default=True, action=argparse.BooleanOptionalAction,
        help="measure the p50 frame time at 16 spp (a second compile)",
    )
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a sanity run, not a measurement)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from csgrenderer.backend import choose_backend
    from csgrenderer.models import rtiow_final_scene
    from csgrenderer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu" and not args.cpu:
        print(f"bench.py: no GPU (JAX platform {platform!r}); pass --cpu "
              "for a CPU sanity run", file=sys.stderr)
        return 2
    backend = choose_backend(rtiow_final_scene(grid=0), args.backend)

    if args.quick:
        width, height, spp, bounces = 320, 180, 4, 8
    else:
        width, height, spp, bounces = 1920, 1080, 64, 8

    fn = build_renderer(width, height, spp, bounces, backend)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(jnp.uint32(0)))  # compile + warm up
    setup_s = time.perf_counter() - t0
    times, rays = time_frames(fn, args.frames)
    # rays per frame are the same for every frame (same shape, fresh
    # sample offsets), so per-frame Mrays/s = (rays / frames) / t_i
    rays_per_frame = rays / len(times)
    mrays = rays_per_frame / statistics.median(times) / 1e6
    mrays_mean = rays / sum(times) / 1e6

    p50_ms = None
    if args.p50:
        fn16 = build_renderer(width, height, 16 if not args.quick else 2,
                              bounces, backend)
        jax.block_until_ready(fn16(jnp.uint32(0)))
        t16, _ = time_frames(fn16, max(args.frames, 3))
        p50_ms = statistics.median(t16) * 1e3

    result = {
        "metric": "Mrays/s",
        "value": mrays,
        "unit": "Mrays/s",
        "config": f"RTIOW-final {width}x{height} spp={spp} bounces={bounces}",
        "p50_frame_ms_16spp": p50_ms,
        "backend": backend,
        "platform": platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "gpu": gpu_info() if platform == "gpu" else None,
        "frames": args.frames,
        "rays": rays,
        "value_mean": mrays_mean,
        "frame_times_s": times,
        "setup_s": setup_s,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
