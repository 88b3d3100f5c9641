"""Profiling & tracing — the framework's answer to the reference's frame-time
printf stats (``app.c:126-194``) plus real tracing the reference never had.

- ``trace(dir)``: context manager around ``jax.profiler`` producing
  Perfetto/TensorBoard traces of the jitted render (device timelines, HLO
  op costs, HBM usage).
- ``time_fn``: wall-clock timing helper with compile/run split and Mrays
  accounting, used by bench.py and perf scripts.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/csgr-trace"):
    """Capture a device trace viewable in Perfetto/TensorBoard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclass
class Timing:
    compile_sec: float
    run_sec: float  # per-call mean over the timed calls
    calls: int
    rays: int = 0

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / self.run_sec / 1e6 if self.run_sec > 0 else 0.0


def _fence(out, rays_index):
    """Force completion with a host readback of the ray count (or of one
    element), after which every output of the call is done. Returns the
    ray count if requested."""
    leaves = jax.tree_util.tree_leaves(out)
    if rays_index is not None:
        return int(leaves[rays_index])
    # no designated scalar: read back one element of the first leaf
    # (scalar slice keeps the host transfer tiny)
    first = leaves[0]
    float(first[(0,) * first.ndim]) if first.ndim else float(first)
    return 0


def time_fn(fn, *args, calls: int = 3, rays_index: int | None = None) -> Timing:
    """Measure ``fn(*args)``: first call (compile+run) vs steady-state mean.

    ``rays_index``: index of a ray-count scalar in fn's output pytree leaves,
    used for the Mrays metric (and as the in-window completion fence).
    """
    t0 = time.perf_counter()
    out = fn(*args)
    _fence(out, rays_index)
    compile_sec = time.perf_counter() - t0

    rays = 0
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn(*args)
        r = _fence(out, rays_index)
        times.append(time.perf_counter() - t0)
        rays += r
    return Timing(
        compile_sec=compile_sec,
        run_sec=sum(times) / len(times),
        calls=calls,
        rays=rays // calls if calls else 0,
    )
