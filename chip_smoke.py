"""On-card smoke test: the system's main paths at full size on one GPU.

    python chip_smoke.py          # phases 1-7 on one card
    python chip_smoke.py --four   # only the sharded path on four cards

Each phase drives the normal entry points (PathTraceRenderer, bench.py's
renderer, render_scene_sharded, the App loop) with every kernel compiled
for the card, and checks what comes out against the repository's own
references, run on the same card:

- kernel vs the plain XLA reference with the same seed: RMSE <= 2e-2,
  <= 1% of pixels off by more than 0.05, ray count within 0.2%. One-ulp
  differences flip silhouette ties and those paths then diverge through
  the RNG, so bit equality is not expected (tests/test_kernels.py);
- converged fidelity (two-stream protocol): two kernel renders with
  independent seeds raise spp until their noise, rmse(A, B) / sqrt(2) on
  gamma-2 tonemapped f32, is <= 3e-4; then the same-seed kernel vs
  reference RMSE must be <= 1e-3;
- goldens (rendered on the CPU) with the same divergence bound, RMSE
  printed.

It prints the card's name and power limit (nvidia-smi, read by a child
process that stays off JAX), ``memory_analysis()`` of each phase's main
compiled step, ``peak_bytes_in_use``, every comparison beside its
tolerance, and the kernel-vs-XLA timings (median of 3 warm frames, each
ending in ``block_until_ready``). The last line is one JSON object:
``{"ok": true, "device": {...}}``; any failed phase exits non-zero without
it. Without a GPU, or away from the repository, it refuses to run. All
phases run in this one process: a JAX process reserves most of the
card's memory when it first uses it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent

RMSE_TOL = 2e-2  # kernel vs reference, same seed (divergence bound)
BAD_FRAC_TOL = 0.01  # share of pixels off by more than BAD_PIX
BAD_PIX = 0.05
RAYS_TOL = 2e-3  # relative ray-count difference
NOISE_TARGET = 3e-4  # converged-fidelity noise certificate
FIDELITY_TOL = 1e-3  # same-seed RMSE at that noise, gamma-2 floats

# (width, height, spp) of each cell; fidelity cells render at a reduced
# resolution (RMSE is per pixel) and raise spp in chunks
SIZES = dict(
    rtiow=(1920, 1080, 64),
    night=(960, 540, 64),
    csg_4k=(3840, 2160, 4),
    many_objects=(960, 540, 4),
    meshnight=(960, 540, 16),
    realtime=(1280, 720, 2),
    tape_timing=(1920, 1080, 16),
    fidelity_rtiow=(128, 72, 4096),
    fidelity_csg=(96, 96, 4096),
)
FIDELITY_MAX_SPP = 1 << 18
REF_CHUNK = 128  # samples per batched reference call
REALTIME_SECONDS = 4.0


def log(msg):
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip()


class Smoke:
    def __init__(self):
        import jax

        self.jax = jax
        self.failed = []

    def phase(self, name, fn, *args):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn(*args)
        except Exception:  # a failed phase fails the run, after the others
            traceback.print_exc()
            self.failed.append(name)
            log(f"== {name}: FAILED")
        stats = self.jax.devices()[0].memory_stats() or {}
        log(f"== {name}: {time.perf_counter() - t0:.1f} s, "
            f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def memory(name, compiled):
    m = compiled.memory_analysis()
    log(f"[memory] {name}: arguments {m.argument_size_in_bytes} B, outputs "
        f"{m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B, code "
        f"{m.generated_code_size_in_bytes} B")


def compiled_call(name, fn, *args):
    """jit + compile ``fn`` once, print its memory analysis, run it."""
    import jax

    compiled = jax.jit(fn).lower(*args).compile()
    memory(name, compiled)
    out = compiled(*args)
    jax.block_until_ready(out)
    return out


def compare(name, img, ref, rays=None, ref_rays=None):
    import numpy as np

    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    if img.shape != ref.shape or not np.isfinite(img).all():
        raise AssertionError(f"{name}: shape {img.shape} vs {ref.shape}, "
                             f"finite {np.isfinite(img).all()}")
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    bad = float((np.abs(img - ref).max(axis=-1) > BAD_PIX).mean())
    msg = (f"[compare] {name}: rmse {rmse:.3e} (tol {RMSE_TOL}), pixels off "
           f">{BAD_PIX}: {bad:.4%} (tol {BAD_FRAC_TOL:.0%})")
    ok = rmse <= RMSE_TOL and bad <= BAD_FRAC_TOL
    if rays is not None:
        rel = abs(int(rays) - int(ref_rays)) / max(int(ref_rays), 1)
        msg += f", rays {int(rays)} vs {int(ref_rays)}: {rel:.2e} (tol {RAYS_TOL})"
        ok = ok and rel <= RAYS_TOL
    log(msg)
    if not ok:
        raise AssertionError(msg)


def tonemapped(radiance):
    import numpy as np

    from csgrenderer.render import tonemap

    return np.asarray(tonemap.tonemap(radiance, gamma=2.0), np.float64)


def accumulate(fn, seed, spp, chunk):
    """Mean radiance of ``spp`` samples from ``fn(seed, chunk, offset)``
    calls over disjoint sample offsets (exact: counter-based RNG)."""
    acc = None
    for off in range(0, spp, chunk):
        img = fn(seed, chunk, off)
        acc = img if acc is None else acc + img
    return acc / (spp // chunk)


def fidelity(name, kernel_fn, ref_fn, k_chunk, ref_chunk, max_spp):
    """The converged two-stream protocol (module docstring)."""
    import numpy as np

    spp = k_chunk
    while True:
        a = tonemapped(accumulate(kernel_fn, 1, spp, k_chunk))
        b = tonemapped(accumulate(kernel_fn, 2, spp, k_chunk))
        noise = float(np.sqrt(np.mean((a - b) ** 2))) / np.sqrt(2.0)
        log(f"[fidelity] {name}: {spp} spp, noise {noise:.3e} "
            f"(target {NOISE_TARGET})")
        if noise <= NOISE_TARGET or spp >= max_spp:
            break
        spp *= 2
    if noise > NOISE_TARGET:
        raise AssertionError(f"{name}: noise {noise:.3e} at {spp} spp")
    ref = tonemapped(accumulate(ref_fn, 1, spp, ref_chunk))
    err = float(np.sqrt(np.mean((a - ref) ** 2)))
    log(f"[fidelity] {name}: kernel vs reference at {spp} spp, same seed: "
        f"rmse {err:.3e} (tol {FIDELITY_TOL})")
    if err > FIDELITY_TOL:
        raise AssertionError(f"{name}: fidelity rmse {err:.3e}")


def timed(fn, frames=3):
    """Median of ``frames`` warm frames (after one warm-up), each ending in
    block_until_ready. Returns (median s, all times, rays per frame)."""
    import jax

    jax.block_until_ready(fn(0))
    times, rays = [], 0
    for i in range(frames):
        t0 = time.perf_counter()
        out = fn(i + 1)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
        rays = int(out[1])
    return statistics.median(times), times, rays


# -- scenes and cameras --------------------------------------------------


def rtiow(width, height):
    from csgrenderer.camera import Camera
    from csgrenderer.models import rtiow_final_scene

    return rtiow_final_scene(), Camera.look_at(
        (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov_degrees=20.0,
        aspect_ratio=width / height, aperture=0.1, focus_dist=10.0,
    )


def deep_csg(width, height, time_sec=1.0):
    """config5's depth-8 animated tape, posed at ``time_sec``."""
    import jax.numpy as jnp

    from csgrenderer.camera import Camera
    from csgrenderer.models import animated_csg_scene

    graph, animate = animated_csg_scene(8)
    tape = animate(graph.compile(k=8), jnp.float32(time_sec))
    cam = Camera.look_at((0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0,
                         aspect_ratio=width / height)
    return graph, animate, tape, cam


def hit_fn(scene):
    from functools import partial

    from csgrenderer.render.integrator import tape_hit_adapter
    from csgrenderer.scene.tape import CompiledTape

    if isinstance(scene, CompiledTape):
        return partial(tape_hit_adapter, scene)
    return scene.nearest_hit


# -- phases ----------------------------------------------------------------


def phase_rtiow():
    """RTIOW final, 1920x1080 / 64 spp / 8 bounces, through
    PathTraceRenderer and bench.py's renderer, against the reference."""
    import jax.numpy as jnp

    import bench
    from csgrenderer.app import PathTraceRenderer
    from csgrenderer.utils.config import RenderConfig

    w, h, spp = SIZES["rtiow"]
    cell = f"rtiow {w}x{h}x{spp}"
    scene, cam = rtiow(w, h)
    ref_fn = bench.build_renderer(w, h, spp, 8, "jnp")
    ref, ref_rays = compiled_call(f"xla {cell}", ref_fn, jnp.uint32(0))
    k_fn = bench.build_renderer(w, h, spp, 8, "triton")
    img, rays = compiled_call(f"kernel {cell}", k_fn, jnp.uint32(0))
    compare(f"bench.py renderer {cell}", img, ref, rays, ref_rays)

    r = PathTraceRenderer(
        scene, cam,
        RenderConfig(width=w, height=h, spp=spp, max_bounces=8, seed=0,
                     lens=True),
        progressive=True,
    )
    assert r.backend == "triton", r.backend
    r.draw_frame(0.0)
    compare(f"PathTraceRenderer {cell}", r.accumulator.image(), ref,
            r.last_frame_rays, ref_rays)

    from csgrenderer.kernels import render_image_pallas
    from csgrenderer.render import render_image

    sw, sh, chunk = SIZES["fidelity_rtiow"]
    s_scene, s_cam = rtiow(sw, sh)
    fidelity(
        f"rtiow {sw}x{sh}",
        lambda seed, n, off: render_image_pallas(
            s_scene, s_cam, sw, sh, spp=n, max_bounces=8, seed=seed,
            lens=True, sample_offset=off)[0],
        batched_ref(lambda seed, off: render_image(
            s_scene.nearest_hit, s_cam, sw, sh, spp=1, max_bounces=8,
            seed=seed, lens=True, sample_offset=off)[0]),
        k_chunk=chunk, ref_chunk=REF_CHUNK, max_spp=FIDELITY_MAX_SPP,
    )


def batched_ref(one):
    """(seed, n, offset) -> mean radiance of samples offset .. offset+n-1
    of the reference, ``one(seed, sample_offset)`` being a 1-spp render:
    the n samples run side by side (vmap), not one after another, so a
    small image keeps the card busy."""
    import jax
    import jax.numpy as jnp

    def fn(seed, n, off):
        offs = off + jnp.arange(n, dtype=jnp.int32)
        return jnp.mean(jax.vmap(lambda o: one(seed, o))(offs), axis=0)

    return jax.jit(fn, static_argnums=(0, 1))


def phase_night():
    """The night NEE scene at 960x540 / 64 spp against the reference."""
    from csgrenderer.app import PathTraceRenderer
    from csgrenderer.camera import Camera
    from csgrenderer.models import night_scene
    from csgrenderer.render import render_image
    from csgrenderer.render.lights import extract_lights
    from csgrenderer.utils.config import RenderConfig

    w, h, spp = SIZES["night"]
    cell = f"night {w}x{h}x{spp} nee"
    scene = night_scene()
    cam = Camera.look_at((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), vfov_degrees=32.0,
                         aspect_ratio=w / h)
    lights = extract_lights(scene)
    ref, ref_rays = compiled_call(
        f"xla {cell}",
        lambda: render_image(scene.nearest_hit, cam, w, h, spp=spp,
                             max_bounces=6, seed=5, sky="black",
                             lights=lights),
    )
    r = PathTraceRenderer(
        scene, cam,
        RenderConfig(width=w, height=h, spp=spp, max_bounces=6, seed=5,
                     sky="black", nee=True),
        progressive=True,
    )
    assert r.backend == "triton", r.backend
    r.draw_frame(0.0)
    compare(f"PathTraceRenderer {cell}", r.accumulator.image(),
            ref, r.last_frame_rays, ref_rays)


def phase_csg():
    """Depth-8 animated CSG, progressive at 3840x2160 in 4-spp frames
    (config5), and the many-objects tape with clusters at 960x540."""
    import jax
    import numpy as np

    from csgrenderer.app import PathTraceRenderer
    from csgrenderer.camera import Camera
    from csgrenderer.kernels import render_image_tape_pallas
    from csgrenderer.models import many_objects_scene
    from csgrenderer.render import render_image
    from csgrenderer.scene.partition import partition_tape
    from csgrenderer.utils.config import RenderConfig

    w, h, spp = SIZES["csg_4k"]
    cell = f"deep csg {w}x{h}x{spp}"
    graph, animate, tape1, cam = deep_csg(w, h, 1.0)
    r = PathTraceRenderer(
        graph.compile(k=8), cam,
        RenderConfig(width=w, height=h, spp=spp, max_bounces=5, seed=5),
        animate=animate, progressive=True,
    )
    assert r.backend == "triton", r.backend
    first = None
    for i, t_sec in enumerate((1.0, 1.0, 1.0, 1.0)):
        t0 = time.perf_counter()
        r.draw_frame(t_sec)
        if first is None:
            first = r.accumulator.image()
        log(f"[csg] {cell} progressive frame {i}: {time.perf_counter() - t0:.3f} "
            f"s, {r.last_frame_rays} rays")
    assert int(r.accumulator.sample_count) == 4 * spp
    assert np.isfinite(np.asarray(r.accumulator.image())).all()
    compiled = jax.jit(lambda: render_image_tape_pallas(
        tape1, cam, w, h, spp=spp, max_bounces=5, seed=5)).lower().compile()
    memory(f"kernel {cell}", compiled)
    ref, ref_rays = compiled_call(
        f"xla {cell}",
        lambda: render_image(hit_fn(tape1), cam, w, h, spp=spp,
                             max_bounces=5, seed=5),
    )
    # the first accumulated frame is exactly one 4-spp render at t = 1
    compare(f"PathTraceRenderer {cell} (frame 0)", first, ref)

    mw, mh, mspp = SIZES["many_objects"]
    mcell = f"many-objects {mw}x{mh}x{mspp}"
    tape = many_objects_scene().compile(k=8)
    clusters = partition_tape(tape)
    assert clusters is not None
    mcam = Camera.look_at((9.0, 7.5, 12.0), (0.0, 0.3, 0.0),
                          vfov_degrees=42.0, aspect_ratio=mw / mh)
    log(f"[csg] many-objects: {tape.n_leaves} leaves, {len(clusters)} "
        "clusters")
    t0 = time.perf_counter()
    img, rays = compiled_call(
        f"kernel {mcell} clusters",
        lambda: render_image_tape_pallas(tape, mcam, mw, mh, spp=mspp,
                                         max_bounces=4, seed=3),
    )
    log(f"[csg] {mcell} kernel compile + run "
        f"{time.perf_counter() - t0:.1f} s")
    ref, ref_rays = compiled_call(
        f"xla {mcell}",
        lambda: render_image(hit_fn(tape), mcam, mw, mh, spp=mspp,
                             max_bounces=4, seed=3),
    )
    compare(f"{mcell} clusters", img, ref, rays, ref_rays)

    dw, dh, chunk = SIZES["fidelity_csg"]
    _, _, dtape, dcam = deep_csg(dw, dh, 1.0)
    fidelity(
        f"deep csg {dw}x{dh}",
        lambda seed, n, off: render_image_tape_pallas(
            dtape, dcam, dw, dh, spp=n, max_bounces=5, seed=seed,
            sample_offset=off)[0],
        batched_ref(lambda seed, off: render_image(
            hit_fn(dtape), dcam, dw, dh, spp=1, max_bounces=5, seed=seed,
            sample_offset=off)[0]),
        k_chunk=chunk, ref_chunk=REF_CHUNK, max_spp=FIDELITY_MAX_SPP,
    )


def phase_meshnight():
    """meshnight (emissive-quad NEE on triangle meshes) at 960x540 through
    the plain XLA path."""
    import numpy as np

    from csgrenderer.app import PathTraceRenderer
    from csgrenderer.camera import Camera
    from csgrenderer.models import mesh_night_scene
    from csgrenderer.utils.config import RenderConfig

    w, h, spp = SIZES["meshnight"]
    mesh = mesh_night_scene()
    cam = Camera.look_at((0, 1.8, 2.4), (0, 0.7, -2.6), vfov_degrees=45.0,
                         aspect_ratio=w / h)
    r = PathTraceRenderer(
        mesh, cam,
        RenderConfig(width=w, height=h, spp=spp, max_bounces=5, seed=7,
                     sky="black", nee=True),
        progressive=True,
    )
    assert r.backend == "jnp", r.backend
    t0 = time.perf_counter()
    r.draw_frame(0.0)
    img = np.asarray(r.accumulator.image())
    log(f"[mesh] meshnight {w}x{h}x{spp} ({mesh.num_faces} faces): "
        f"{time.perf_counter() - t0:.1f} s incl. compile, "
        f"{r.last_frame_rays} rays, mean radiance {img.mean():.4f}")
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    assert img.mean() > 0 and r.last_frame_rays > 0


def phase_goldens():
    """The golden configs through the normal path, against the goldens."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tools"))
    from make_goldens import GOLDEN_DIR, golden_specs

    from csgrenderer.io import image

    for name, fn in sorted(golden_specs().items()):
        fresh = fn()
        golden = image.read_png(GOLDEN_DIR / f"{name}.png")
        log(f"[golden] {name}: rmse {image.rmse(fresh, golden):.3e}")
        compare(f"golden {name}", np.asarray(fresh) / 255.0,
                np.asarray(golden) / 255.0)


def phase_realtime():
    """The App loop at 1280x720 / 2 spp, rtiow, 2 frames in flight, for a
    few seconds, without and with denoise."""
    import numpy as np

    from csgrenderer.app import App, PathTraceRenderer
    from csgrenderer.utils.config import RenderConfig

    w, h, spp = SIZES["realtime"]
    scene, cam = rtiow(w, h)
    for denoise in (False, True):
        cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=8, seed=6,
                           lens=True, denoise=denoise, denoise_iterations=3)
        r = PathTraceRenderer(scene, cam, cfg, advance_samples=True)
        frames = []
        app = App(target_updates_per_sec=60.0, width=w, height=h,
                  caption="smoke", frame_sink=lambda i, img: frames.append(i))
        app.swap_scene(r)
        warm = np.asarray(r.draw_frame(0.0))
        assert warm.shape == (h, w, 3)
        t0 = time.monotonic()
        assert app.run(max_seconds=REALTIME_SECONDS, frames_in_flight=2,
                       readback="fence", fence_stride=2)
        wall = time.monotonic() - t0
        last = np.asarray(r.draw_frame(1.0))
        assert np.isfinite(last).all() and last.mean() > 0
        log(f"[realtime] rtiow {w}x{h}x{spp} denoise={denoise}: {len(frames)} "
            f"frames in {wall:.2f} s = {len(frames) / wall:.1f} fps "
            "(2 frames in flight)")
        assert len(frames) > 0


def phase_timings():
    """Each kernel family end to end against what XLA makes of the plain
    path: median of 3 warm frames."""
    import jax
    import jax.numpy as jnp

    import bench
    from csgrenderer.kernels import render_image_tape_pallas
    from csgrenderer.render import render_image

    rows = []
    w, h, spp = SIZES["rtiow"]
    for backend in ("triton", "jnp"):
        fn = bench.build_renderer(w, h, spp, 8, backend)
        med, times, rays = timed(lambda i: fn(jnp.uint32(100 + i)))
        rows.append((f"rtiow {w}x{h}x{spp} 8b", backend, med, times, rays))
    w, h, spp = SIZES["tape_timing"]
    _, _, tape, cam = deep_csg(w, h, 1.0)
    tape_fns = {
        "triton": lambda off: render_image_tape_pallas(
            tape, cam, w, h, spp=spp, max_bounces=8, seed=0,
            sample_offset=off),
        "jnp": lambda off: render_image(
            hit_fn(tape), cam, w, h, spp=spp, max_bounces=8, seed=0,
            sample_offset=off),
    }
    for backend, fn in tape_fns.items():
        jfn = jax.jit(fn)
        med, times, rays = timed(lambda i: jfn(jnp.uint32(spp * i)))
        rows.append((f"deep csg {w}x{h}x{spp} 8b", backend, med, times, rays))
    for cell, backend, med, times, rays in rows:
        log(f"[timing] {cell} {backend}: median {med * 1e3:.2f} ms "
            f"(frames {[round(t * 1e3, 2) for t in times]} ms), {rays} rays, "
            f"{rays / med / 1e6:.1f} Mrays/s")


def four_cards():
    """render_scene_sharded on 4 cards, tile x sample meshes 4x1 and 2x2,
    against the single-card image of the same call."""
    import jax
    import numpy as np

    from csgrenderer.kernels import (
        render_image_pallas,
        render_image_tape_pallas,
    )
    from csgrenderer.parallel import make_mesh, render_scene_sharded

    devices = jax.devices()
    if len(devices) != 4:
        raise AssertionError(f"--four needs 4 cards, found {len(devices)}")
    w, h, spp = SIZES["rtiow"]
    scene, cam = rtiow(w, h)
    _, _, tape, tcam = deep_csg(w, h, 1.0)
    cases = [
        (f"rtiow {w}x{h}x{spp}", scene, cam,
         dict(spp=spp, max_bounces=8, lens=True), render_image_pallas),
        (f"deep csg {w}x{h}x{SIZES['tape_timing'][2]}", tape, tcam,
         dict(spp=SIZES["tape_timing"][2], max_bounces=8),
         render_image_tape_pallas),
    ]
    for name, sc, c, kw, single_fn in cases:
        with jax.default_device(devices[0]):
            single_call = jax.jit(lambda sc=sc, c=c, kw=kw, f=single_fn: f(
                sc, c, w, h, seed=0, **kw))
            s_med, _, _ = timed(lambda i: single_call())
            single, s_rays = single_call()
            single = np.asarray(single)
        log(f"[four] {name} single card: median {s_med * 1e3:.2f} ms")
        for tile, sample in ((4, 1), (2, 2)):
            mesh = make_mesh(tile, sample, devices=devices)
            run = jax.jit(lambda sc=sc, c=c, kw=kw, mesh=mesh:
                          render_scene_sharded(sc, c, w, h, mesh, seed=0,
                                               **kw))
            med, _, _ = timed(lambda i: run())
            img, rays = run()
            img = np.asarray(img)
            same = bool(np.array_equal(img, single))
            diff = float(np.abs(img - single).max())
            log(f"[four] {name} mesh {tile}x{sample}: bit-identical {same}, "
                f"max |diff| {diff:.3e}, median {med * 1e3:.2f} ms "
                f"({s_med / med:.2f}x the single card), rays {int(rays)} vs "
                f"{int(s_rays)}")
            compare(f"four {name} {tile}x{sample} vs single card", img,
                    single, rays, s_rays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    if not (ROOT / "csgrenderer").is_dir():
        print(f"chip_smoke.py: the repository is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from csgrenderer.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    log(f"devices: {devices}")
    smoke = Smoke()
    if args.four:
        smoke.phase("four cards: render_scene_sharded", four_cards)
    else:
        smoke.phase("1 rtiow", phase_rtiow)
        smoke.phase("2 night nee", phase_night)
        smoke.phase("3 csg: deep 4K progressive, many-objects", phase_csg)
        smoke.phase("4 meshnight (xla)", phase_meshnight)
        smoke.phase("5 goldens", phase_goldens)
        smoke.phase("6 realtime App loop", phase_realtime)
        smoke.phase("7 kernel vs xla timings", phase_timings)
    log(gpu_line())
    if smoke.failed:
        print(f"chip_smoke.py: failed phases: {smoke.failed}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
