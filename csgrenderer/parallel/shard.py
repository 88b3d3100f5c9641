"""Multi-card rendering via shard_map over the ("tile", "sample") mesh.

Decomposition (SURVEY §5 "long-context" slot):

- the image's ROW dimension is sharded over the "tile" axis — no halo, rays
  are independent, so the only collective the image needs is the output
  layout itself;
- SAMPLES-per-pixel are sharded over the "sample" axis — each device renders
  ``spp / sample_ways`` samples with a disjoint ``sample_offset``, and a
  single ``psum`` over "sample" accumulates radiance and ray counts;
- RNG is counter-based per global (pixel, sample) (render/sampling.py), so
  the result is bit-identical to the single-device render for ANY mesh
  shape — the property SURVEY §7 hard part #4 demands, and what the
  multi-device CPU tests assert.

The scene (small arrays) is replicated on every device; there is no
parameter sharding to do — the analog of "model state" is kilobytes, the
work is all compute.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..render import integrator
from ..scene.tape import CompiledTape
from .mesh import SAMPLE_AXIS, TILE_AXIS


def render_image_sharded(
    hit_fn,
    camera,
    width: int,
    height: int,
    mesh: Mesh,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    jitter: bool = True,
    lens: bool = False,
    sample_offset: int = 0,
    lights=None,
):
    """Sharded equivalent of ``integrator.render_image``.

    Returns (radiance [H, W, 3] — sharded over rows on the tile axis,
    replicated over sample — and total rays traced). Requires ``height``
    divisible by the tile ways and ``spp`` by the sample ways. ``lights``:
    host-extracted lamps for next-event estimation (render/lights.py).
    """
    tile_ways = mesh.shape[TILE_AXIS]
    sample_ways = mesh.shape[SAMPLE_AXIS]
    if height % tile_ways:
        raise ValueError(f"height {height} not divisible by tile axis {tile_ways}")
    if spp % sample_ways:
        raise ValueError(f"spp {spp} not divisible by sample axis {sample_ways}")
    rows_local = height // tile_ways
    spp_local = spp // sample_ways

    def shard_fn():
        tile_idx = lax.axis_index(TILE_AXIS)
        sample_idx = lax.axis_index(SAMPLE_AXIS)
        y0 = tile_idx.astype(jnp.uint32) * jnp.uint32(rows_local)
        s0 = (
            jnp.uint32(sample_offset)
            + sample_idx.astype(jnp.uint32) * jnp.uint32(spp_local)
        )
        radiance_sum, rays = integrator.render_tile(
            hit_fn,
            camera,
            width,
            height,
            0,
            y0,
            width,
            rows_local,
            spp=spp_local,
            max_bounces=max_bounces,
            seed=seed,
            sky=sky,
            jitter=jitter,
            lens=lens,
            sample_offset=s0,
            lights=lights,
        )
        radiance_sum = lax.psum(radiance_sum, SAMPLE_AXIS)
        rays = lax.psum(rays, (TILE_AXIS, SAMPLE_AXIS))
        return radiance_sum / spp, rays

    # vma checker ON (round-3): the integrator seeds its loop carries from
    # value-dependent zeros derived from pixel/sample counters, so the
    # carries enter with the varying-axis type the body produces.
    # Row slabs concatenate along dim 0 via the out_spec itself (no host
    # reshape — a host op on the global array would require full
    # addressability, which a multi-HOST job doesn't have).
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(),
        out_specs=(P(TILE_AXIS, None, None), P()),
    )
    return fn()


def render_scene_sharded(
    scene,
    camera,
    width: int,
    height: int,
    mesh: Mesh,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    lens: bool = False,
    sample_offset: int = 0,
    backend: str = "auto",
    interpret: bool = False,
    nee: bool = False,
):
    """Scene-level sharded render: each device renders its row slab x
    sample shard, and one psum over the sample axis accumulates.

    The path per scene type is backend.choose_backend's: the Triton sphere
    or tape kernel inside shard_map, or the plain XLA integrator
    (render_image_sharded). RNG and camera use global pixel coordinates
    on both paths, so any mesh shape reproduces the single-device image
    (tested on the CPU mesh, kernels in interpret mode).

    ``nee``: next-event estimation toward the scene's lamps (emissive
    spheres of a SphereScene/CompiledTape, emissive faces of a MeshScene);
    sharding-invariant like everything else (its RNG is keyed by global
    pixel/sample counters).
    """
    from ..backend import choose_backend
    from ..render.integrator import SphereScene

    backend = choose_backend(scene, backend, interpret=interpret)
    if backend == "jnp":
        from ..render.lights import extract_scene_lights

        lights = None
        if nee:
            lights = extract_scene_lights(scene)
            if lights is None:
                raise ValueError("nee=True but the scene has no lamps")
        if isinstance(scene, CompiledTape):
            from functools import partial

            from ..render.integrator import tape_hit_adapter

            hit_fn = partial(tape_hit_adapter, scene)
        else:
            hit_fn = scene.nearest_hit
        return render_image_sharded(
            hit_fn, camera, width, height, mesh, spp=spp,
            max_bounces=max_bounces, seed=seed, sky=sky, lens=lens,
            sample_offset=sample_offset, lights=lights,
        )

    tile_ways = mesh.shape[TILE_AXIS]
    sample_ways = mesh.shape[SAMPLE_AXIS]
    if height % tile_ways:
        raise ValueError(f"height {height} not divisible by tile axis {tile_ways}")
    if spp % sample_ways:
        raise ValueError(f"spp {spp} not divisible by sample axis {sample_ways}")
    rows_local = height // tile_ways
    spp_local = spp // sample_ways

    def shard_fn():
        tile_idx = lax.axis_index(TILE_AXIS)
        sample_idx = lax.axis_index(SAMPLE_AXIS)
        kwargs = dict(
            spp=spp_local, max_bounces=max_bounces, seed=seed, sky=sky,
            lens=lens, sample_offset=sample_offset + sample_idx * spp_local,
            rows=rows_local, row_offset=tile_idx * rows_local,
            interpret=interpret, nee=nee,
        )
        if isinstance(scene, SphereScene):
            from ..kernels import render_image_pallas

            radiance, rays = render_image_pallas(
                scene, camera, width, height, **kwargs
            )
        else:
            from ..kernels import render_image_tape_pallas

            radiance, rays = render_image_tape_pallas(
                scene, camera, width, height, **kwargs
            )
        radiance_sum = lax.psum(radiance * spp_local, SAMPLE_AXIS)
        rays = lax.psum(rays, (TILE_AXIS, SAMPLE_AXIS))
        return radiance_sum / spp, rays

    # check_vma=False is required by JAX itself (as of jax 0.9): a
    # pallas_call under the vma checker rejects a kernel that mixes varying
    # inputs with invariant constants. The jnp path runs with the checker
    # ON; tests/test_parallel.py::test_pallas_vma_checker_still_unsupported
    # fails when a future JAX lifts this, and then this escape hatch goes.
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(),
        out_specs=(P(TILE_AXIS, None, None), P()),
        check_vma=False,
    )
    return fn()


def render_to_noise_sharded(
    scene,
    camera,
    width: int,
    height: int,
    mesh: Mesh,
    target: float = 1e-3,
    max_spp: int = 1 << 16,
    spp_chunk: int = 16,
    sample_offset: int = 0,
    **render_kwargs,
):
    """Multi-chip render-to-quality: the two-stream noise certificate of
    ``PathTraceRenderer.render_to_noise`` (app/renderers.py) over the
    production sharded path.

    Accumulates ``spp_chunk``-sized ``render_scene_sharded`` calls into two
    independent half-streams via disjoint ``sample_offset`` ranges. The
    counter-based RNG makes every sharded chunk bit-identical to its
    single-device counterpart (tests/test_parallel.py), so the certificate
    — rmse(tonemap(A), tonemap(B)) / 2 on gamma-2 floats, the noise of the
    merged image — is EXACTLY the single-device one: sharding scales
    time-to-certified-quality linearly without touching the math.

    Returns ``(accumulator, noise, spp_used)`` like the renderer method;
    ``render_kwargs`` forward to render_scene_sharded (backend, nee, sky,
    lens, seed, max_bounces, interpret).
    """
    import numpy as _np

    from ..io.checkpoint import Accumulator
    from ..render import tonemap as _tm

    acc_a = Accumulator.zeros(height, width)
    acc_b = Accumulator.zeros(height, width)
    offset = int(sample_offset)
    noise = float("inf")
    pairs = 0
    next_check = 1
    while 2 * pairs * spp_chunk < max_spp:
        for which in range(2):
            radiance, rays = render_scene_sharded(
                scene, camera, width, height, mesh, spp=spp_chunk,
                sample_offset=offset, **render_kwargs,
            )
            acc = (acc_a if which == 0 else acc_b).add(
                radiance * spp_chunk, spp_chunk, rays
            )
            if which == 0:
                acc_a = acc
            else:
                acc_b = acc
            offset += spp_chunk
        pairs += 1
        if pairs >= next_check:
            next_check *= 2
            a = _np.asarray(_tm.tonemap(acc_a.image(), gamma=2.0), _np.float64)
            b = _np.asarray(_tm.tonemap(acc_b.image(), gamma=2.0), _np.float64)
            noise = float(_np.sqrt(_np.mean((a - b) ** 2))) / 2.0
            if noise <= target:
                break
    merged = Accumulator(
        radiance_sum=acc_a.radiance_sum + acc_b.radiance_sum,
        sample_count=acc_a.sample_count + acc_b.sample_count,
        rays_traced=acc_a.rays_traced + acc_b.rays_traced,
    )
    return merged, noise, 2 * pairs * spp_chunk
