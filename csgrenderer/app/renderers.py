"""Renderer objects: the ``Wo_Renderer`` equivalents driven by the App loop.

A renderer owns a scene + camera + RenderConfig and exposes
``draw_frame(time_sec) -> image`` (uint8 [H,W,3]) — the analog of
``wo_renderer_draw_frame`` (renderer.h:20) — plus ``last_frame_rays`` for the
stats clock. The jitted frame function is compiled once per (scene topology,
config); per-frame state (time, accumulation) flows through arguments, the
functional replacement for the reference's uniform-buffer update
(renderer.c:2132-2155).

- ``WololoRenderer``       — milestone-01 animated frame (config 1)
- ``PathTraceRenderer``    — any SphereScene, CompiledTape, or MeshScene,
                             optional per-frame animation fn, optional
                             progressive accumulation across frames
                             (config 2/3/4/5 + the mesh milestone)
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..camera.pinhole import Camera
from ..io.checkpoint import Accumulator
from ..render import integrator, tonemap
from ..render.integrator import SphereScene
from ..render.trimesh import MeshScene
from ..scene.tape import CompiledTape
from ..utils.config import RenderConfig


class WololoRenderer:
    """Draws the reference's hard-coded animated-sphere frame (config 1).

    ``entry_point``: "rt1_1" (the ray tracer, frag:147-152, default) or
    "debug_view_1" (the st-coordinate visualizer, frag:132-137) — the
    reference switches these by editing main() and recompiling the shader;
    here it is a constructor argument.
    """

    def __init__(self, config: RenderConfig, entry_point: str = "rt1_1"):
        self.config = config
        self.last_frame_rays = config.width * config.height  # 1 primary/px
        if entry_point == "rt1_1":
            render = lambda t: integrator.render_wololo_frame(  # noqa: E731
                t, config.width, config.height
            )
        elif entry_point == "debug_view_1":
            render = lambda t: integrator.render_debug_view_1(  # noqa: E731
                config.width, config.height
            )
        else:
            raise ValueError(f"unknown entry point {entry_point!r}")
        self._frame = jax.jit(
            lambda t: tonemap.to_uint8(
                tonemap.tonemap(
                    render(t),
                    gamma=1.0,  # the reference writes linear color (SURVEY §2)
                )
            )
        )

    def draw_frame(self, time_sec: float):
        return self._frame(jnp.float32(time_sec))

    def draw_frame_async(self, time_sec: float):
        """(image future, rays) — the jitted frame is already async."""
        return self._frame(jnp.float32(time_sec)), self.last_frame_rays


class PathTraceRenderer:
    """Path-traces a scene each frame; optionally accumulates progressively.

    ``animate``: optional ``(scene, time_sec) -> scene`` applied inside jit
    per frame (e.g. CompiledTape.with_edges for config 5).
    ``progressive``: accumulate samples across frames instead of restarting
    (each frame adds ``config.spp`` samples); ``reset_accumulation()`` clears.
    ``advance_samples``: advance the RNG sample offset by ``spp`` each
    frame WITHOUT host-side accumulation — every frame is an independent
    fresh-noise render (the realtime path-tracing mode, demo6 --scene
    rtiow/night: async-safe, unlike ``progressive``).
    """

    def __init__(
        self,
        scene,
        camera: Camera,
        config: RenderConfig,
        animate: Optional[Callable] = None,
        progressive: bool = False,
        sample_offset: int = 0,
        backend: str = "auto",
        interpret: bool = False,
        advance_samples: bool = False,
    ):
        """``backend``: "auto", "jnp" or "triton", resolved by
        backend.choose_backend (Triton kernels for spheres and tapes on the
        GPU, plain XLA otherwise). ``interpret`` runs the kernels in the
        Pallas interpreter (how the CPU tests reach them)."""
        from ..backend import choose_backend

        self.scene = scene
        self.camera = camera
        self.config = config
        self.progressive = progressive
        self.advance_samples = advance_samples
        if progressive and advance_samples:
            raise ValueError("progressive already advances sample offsets")
        self.accumulator = Accumulator.zeros(config.height, config.width)
        self.last_frame_rays = 0
        self._sample_offset = sample_offset
        self._animate = animate

        cfg = config
        if cfg.debug:
            from ..utils.config import enable_debug_mode

            enable_debug_mode()
        backend = choose_backend(scene, backend, interpret=interpret)
        self.backend = backend

        # NEE covers emissive SphereScene lamps, emissive sphere LEAVES of
        # a CompiledTape, and emissive FACES of a MeshScene (the reference
        # has none of this, SURVEY §2). For the jitted jnp path the lights
        # are extracted HOST-SIDE here (inside jit the scene arrays are
        # tracers): lamp positions snapshot the constructor's scene, so
        # ``animate`` (which could move lamps) is rejected rather than
        # silently diverging from the kernel path, which packs its lamp
        # table from the scene on every call.
        nee_lights = None
        if cfg.nee:
            if not isinstance(
                scene, (SphereScene, CompiledTape, MeshScene)
            ):
                raise ValueError(
                    "RenderConfig.nee is for emissive SphereScenes, "
                    f"CompiledTapes, or MeshScenes; got "
                    f"{type(scene).__name__}"
                )
            if backend != "triton":
                if animate is not None:
                    raise NotImplementedError(
                        "nee + animate on the jnp backend would sample "
                        "the constructor-time lamp positions"
                    )
                from ..render.lights import extract_scene_lights

                nee_lights = extract_scene_lights(scene)
                if nee_lights is None:
                    raise ValueError(
                        "RenderConfig.nee but the scene has no emissive "
                        "lamps"
                    )

        # Animated CSG tapes re-cluster per frame (scene/partition.py): the
        # cluster tuple is static program structure, so it is computed on a
        # HOST-SIDE CPU TWIN of the tape (never touching the accelerator
        # queue — a device readback here would serialize frames-in-flight)
        # and passed into the kernel; an unchanged tuple is a jit cache hit,
        # a crossing of a cluster boundary recompiles once.
        self._reclusters = (
            backend == "triton"
            and isinstance(scene, CompiledTape)
            and animate is not None
        )
        if self._reclusters:
            self._cpu_twin = jax.device_put(scene, jax.devices("cpu")[0])

        # camera is a frame ARGUMENT (a pytree of arrays, traced on the
        # jnp path): ``set_camera`` moves the view per frame with no
        # recompile — the interactive orbit path (app/controls.py), the
        # analog of the reference's per-frame event poll feeding its
        # uniform buffer (app.c:204, renderer.c:2132-2155)
        def frame(scene, camera, t, sample_base, partition=None):
            if animate is not None:
                scene = animate(scene, t)
            if backend == "triton":
                return _render_kernel(
                    scene, camera, cfg, sample_base, interpret,
                    animated=animate is not None, partition=partition,
                )
            hit_fn = _hit_fn_for(scene, eps=1e-3)
            radiance, rays = integrator.render_image(
                hit_fn,
                camera,
                cfg.width,
                cfg.height,
                spp=cfg.spp,
                max_bounces=cfg.max_bounces,
                seed=cfg.seed,
                sky=cfg.sky,
                jitter=cfg.jitter,
                lens=cfg.lens,
                sample_offset=sample_base,
                lights=nee_lights,
            )
            return radiance, rays

        # The kernel wrappers jit internally and pack scene tables with host
        # numpy, so they must see concrete arrays: no outer jit there.
        self._frame = frame if backend == "triton" else jax.jit(frame)
        self._tonemap = jax.jit(
            lambda lin: tonemap.to_uint8(tonemap.tonemap(lin, gamma=cfg.gamma))
        )

        # Denoise step: a jitted post-pass over
        # the LINEAR radiance — deterministic AOV G-buffer (render/aov.py,
        # one centered primary cast reusing the scene's jnp hit adapter)
        # guiding the a-trous/SVGF filter (render/denoise.py). The scene is
        # a traced pytree argument, so animated scenes denoise against the
        # frame-time geometry and the camera stays recompile-free. Large
        # meshes bound memory with face/row chunking.
        self._denoise_fn = None
        if cfg.denoise:
            from ..render.aov import render_aovs
            from ..render.denoise import atrous_denoise

            face_chunk = None
            row_chunk = None
            if isinstance(scene, MeshScene) and scene.num_faces > 8192:
                face_chunk = 2048
                row_chunk = max(
                    1, (1 << 26) // max(1, cfg.width * face_chunk)
                )

            def denoise_step(lin, scene, camera, t):
                if animate is not None:
                    scene = animate(scene, t)
                hit_fn = _hit_fn_for(scene, eps=1e-3, face_chunk=face_chunk)
                aovs = render_aovs(
                    hit_fn, camera, cfg.width, cfg.height, sky=cfg.sky,
                    row_chunk=row_chunk,
                )
                return atrous_denoise(
                    lin, aovs, iterations=cfg.denoise_iterations
                )

            self._denoise_fn = jax.jit(denoise_step)

    def reset_accumulation(self) -> None:
        self.accumulator = Accumulator.zeros(self.config.height, self.config.width)
        self._sample_offset = 0

    def set_camera(self, camera: Camera) -> None:
        """Swap the view for subsequent frames — no recompile (the camera
        is a traced frame argument). Progressive accumulations of the OLD
        view are the caller's to reset."""
        self.camera = camera

    def _recluster(self, time_sec: float):
        """Clusters of the ANIMATED tape at ``time_sec``, computed entirely
        on the CPU twin (host-side; the accelerator queue is untouched).
        Returns partition_tape's tuple, or () when nothing splits —
        the tape kernel treats () as the global evaluation."""
        from ..scene.partition import partition_tape

        with jax.default_device(jax.devices("cpu")[0]):
            anim = self._animate(self._cpu_twin, jnp.float32(time_sec))
            clusters = partition_tape(anim)
        return clusters if clusters is not None else ()

    def draw_frame(self, time_sec: float):
        args = (
            (self._recluster(time_sec),) if self._reclusters else ()
        )
        radiance, rays = self._frame(
            self.scene, self.camera, jnp.float32(time_sec),
            jnp.int32(self._sample_offset), *args,
        )
        self.last_frame_rays = int(rays)
        if self.progressive:
            self.accumulator = self.accumulator.add(
                radiance * self.config.spp, self.config.spp, rays
            )
            self._sample_offset += self.config.spp
            return self._tonemap(
                self.denoise_image(self.accumulator.image(), time_sec)
            )
        if self.advance_samples:
            self._sample_offset += self.config.spp
        return self._tonemap(self.denoise_image(radiance, time_sec))

    def draw_frame_async(self, time_sec: float):
        """Dispatch a frame WITHOUT any host synchronization.

        Returns (uint8 image, ray-count scalar) as device-array futures —
        the caller consumes them later (App's frames-in-flight pipelining:
        frame N+1's kernels are enqueued before frame N's readback is
        consumed, the honest version of the reference's 2-frames-in-flight
        machinery that vkQueueWaitIdle defeated, renderer.c:51, 2212).
        Progressive accumulation keeps host state per frame, so it stays on
        the synchronous path.
        """
        if self.progressive:
            raise ValueError("progressive accumulation is synchronous")
        args = (
            (self._recluster(time_sec),) if self._reclusters else ()
        )
        radiance, rays = self._frame(
            self.scene, self.camera, jnp.float32(time_sec),
            jnp.int32(self._sample_offset), *args,
        )
        if self.advance_samples:
            self._sample_offset += self.config.spp
        return self._tonemap(self.denoise_image(radiance, time_sec)), rays

    def denoise_image(self, linear, time_sec: float = 0.0):
        """Apply the configured a-trous denoise to a LINEAR radiance image
        (no-op unless RenderConfig.denoise). Pure device work — safe on the
        async path; AOVs are evaluated against the scene at ``time_sec``."""
        if self._denoise_fn is None:
            return linear
        return self._denoise_fn(
            linear, self.scene, self.camera, jnp.float32(time_sec)
        )

    def render_to_noise(self, target: float = 1e-3,
                        max_spp: int = 1 << 16, time_sec: float = 0.0):
        """Render until the MEASURED Monte-Carlo noise reaches ``target``
        — "render to quality, not to spp".

        Accumulates cfg.spp-sized chunks (each a bounded device call) into
        TWO independent half-streams via disjoint ``sample_offset``s (exact
        under the counter-based RNG), and estimates the noise of the
        COMBINED image as rmse(tonemap(A), tonemap(B)) / 2 on gamma-2
        floats: A and B are independent n/2-sample means, so their rms
        difference is sqrt(2) x the n/2-mean noise = 2 x the n-mean
        noise. This is the certificate chip_smoke.py's fidelity phase uses
        (there the /sqrt(2) form certifies the per-image noise; here /2
        certifies the merged image). The estimate is evaluated at power-of-two chunk-pair
        counts so its cost amortizes.

        Returns ``(accumulator, noise, spp_used)``; the renderer's own
        progressive state advances past the consumed sample range, so
        subsequent draw_frame calls compose exactly.
        """
        import numpy as _np

        from ..render import tonemap as _tm

        cfg = self.config
        acc_a = Accumulator.zeros(cfg.height, cfg.width)
        acc_b = Accumulator.zeros(cfg.height, cfg.width)
        args = (
            (self._recluster(time_sec),) if self._reclusters else ()
        )
        noise = float("inf")
        pairs = 0
        next_check = 1
        while 2 * pairs * cfg.spp < max_spp:
            for which in range(2):
                radiance, rays = self._frame(
                    self.scene, self.camera, jnp.float32(time_sec),
                    jnp.int32(self._sample_offset), *args,
                )
                acc = acc_a if which == 0 else acc_b
                acc = acc.add(radiance * cfg.spp, cfg.spp, rays)
                if which == 0:
                    acc_a = acc
                else:
                    acc_b = acc
                self._sample_offset += cfg.spp
            pairs += 1
            if pairs >= next_check:
                next_check *= 2
                a = _np.asarray(_tm.tonemap(acc_a.image(), gamma=2.0),
                                _np.float64)
                b = _np.asarray(_tm.tonemap(acc_b.image(), gamma=2.0),
                                _np.float64)
                noise = float(_np.sqrt(_np.mean((a - b) ** 2))) / 2.0
                if noise <= target:
                    break
        merged = Accumulator(
            radiance_sum=acc_a.radiance_sum + acc_b.radiance_sum,
            sample_count=acc_a.sample_count + acc_b.sample_count,
            rays_traced=acc_a.rays_traced + acc_b.rays_traced,
        )
        if self.progressive:
            self.accumulator = Accumulator(
                radiance_sum=self.accumulator.radiance_sum
                + merged.radiance_sum,
                sample_count=self.accumulator.sample_count
                + merged.sample_count,
                rays_traced=self.accumulator.rays_traced
                + merged.rays_traced,
            )
        return merged, noise, 2 * pairs * cfg.spp


def _hit_fn_for(scene, eps: float = 1e-3, face_chunk: int | None = None):
    if isinstance(scene, SphereScene):
        return partial(SphereScene.nearest_hit, scene, eps=eps)
    if isinstance(scene, CompiledTape):
        return partial(integrator.tape_hit_adapter, scene, eps=eps)
    if isinstance(scene, MeshScene):
        return partial(
            MeshScene.nearest_hit, scene, eps=eps, face_chunk=face_chunk
        )
    raise TypeError(f"unsupported scene type {type(scene)}")


def _render_kernel(scene, camera, cfg: RenderConfig, sample_base,
                   interpret=False, animated=False, partition=None):
    if isinstance(scene, SphereScene):
        from ..kernels import render_image_pallas

        return render_image_pallas(
            scene, camera, cfg.width, cfg.height, spp=cfg.spp,
            max_bounces=cfg.max_bounces, seed=cfg.seed, sky=cfg.sky,
            lens=cfg.lens, sample_offset=sample_base, interpret=interpret,
            nee=cfg.nee,
        )
    from ..kernels import render_image_tape_pallas

    return render_image_tape_pallas(
        scene, camera, cfg.width, cfg.height, spp=cfg.spp,
        max_bounces=cfg.max_bounces, seed=cfg.seed, sky=cfg.sky,
        lens=cfg.lens, sample_offset=sample_base, interpret=interpret,
        nee=cfg.nee,
        # disjoint-cluster decomposition is static program structure.
        # Animated tapes get a precomputed cluster tuple from the
        # renderer's host-side CPU twin (PathTraceRenderer._recluster);
        # an animated call WITHOUT one (direct use) keeps the global
        # evaluation rather than re-clustering on device arrays, which
        # would read back from the accelerator mid-pipeline.
        partition=(
            partition if partition is not None
            else (False if animated else "auto")
        ),
    )
