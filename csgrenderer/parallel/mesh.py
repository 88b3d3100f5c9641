"""Device-mesh construction for multi-chip rendering.

The reference is single-GPU by construction — it literally takes
``vk_physical_devices[0]`` (renderer.c:519-520). Here (SURVEY §2a/§5) a 2D
logical mesh with named axes ``("tile", "sample")`` shards image rows across
"tile" and samples per pixel across "sample", with one ``psum`` over the
sample axis accumulating across cards.

Ray tracing needs no halo exchange (rays are independent), so the mesh
shape follows the algorithm alone: more "sample" ways cuts time-to-quality
for a fixed image; more "tile" ways scales resolution. The cards of one
host reach each other all to all, so no axis order is favoured.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> None:
    """Join a multi-host rendering job: ``jax.distributed.initialize``
    with this framework's conventions (SURVEY §5's multi-host slot).

    After this, ``jax.devices()`` returns the GLOBAL device list and
    ``make_mesh`` lays processes out along the *tile* axis (see below), so
    the same ``render_scene_sharded`` call runs unchanged: image rows
    shard across hosts, samples stay inside a host, and the one psum per
    frame crosses hosts only along "tile" when tile_ways spans processes.
    Idempotent (a second call is a no-op). One process driving all cards
    of one host does not need this.

    Arguments mirror ``jax.distributed.initialize``. Where no cluster
    environment describes the job, pass all three explicitly (e.g.
    ``coordinator_address="localhost:<port>"``).
    Works on CPU processes too (the two-process smoke test,
    tests/test_multihost.py, drives exactly this path).
    """
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def make_mesh(
    tile_ways: int | None = None,
    sample_ways: int = 1,
    devices=None,
) -> Mesh:
    """Build a ("tile", "sample") mesh over ``devices`` (default: all).

    With no arguments, all devices go to the tile axis. In a multi-host
    job (after ``initialize_multihost``), devices are ordered by
    (process, local id), so the LAST mesh axis ("sample") stays inside a
    host whenever sample_ways divides the per-process device count — the
    per-frame radiance psum then stays inside a host, and only the row-slab
    layout (no collective) spans hosts.
    """
    devices = jax.devices() if devices is None else devices
    devices = sorted(
        devices, key=lambda d: (getattr(d, "process_index", 0), d.id)
    )
    n = len(devices)
    if tile_ways is None:
        if n % sample_ways:
            raise ValueError(f"{n} devices not divisible by sample_ways={sample_ways}")
        tile_ways = n // sample_ways
    if tile_ways * sample_ways != n:
        raise ValueError(
            f"mesh {tile_ways}x{sample_ways} != {n} available devices"
        )
    arr = np.asarray(devices).reshape(tile_ways, sample_ways)
    return Mesh(arr, (TILE_AXIS, SAMPLE_AXIS))


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1, devices=jax.devices()[:1])
