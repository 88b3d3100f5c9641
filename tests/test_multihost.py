"""Multi-host smoke test — SURVEY §5's "optional multi-host" slot.

No multi-host hardware is needed: like the virtual-device multichip dry
run, the multi-host path is proven on CPU: TWO OS processes, each contributing 2 virtual CPU devices,
joined by ``initialize_multihost`` (jax.distributed + Gloo collectives),
rendering one sharded frame over the 4-device global mesh. The parent
asserts both ranks agree and that every row slab is BIT-IDENTICAL to the
single-process reference — the same invariant the single-host mesh tests
hold (tests/test_parallel.py), extended across a process boundary.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

_CHILD = pathlib.Path(__file__).resolve().parent / "_multihost_child.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_render_matches_single_process():
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(_CHILD), str(rank), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True,
        )
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"child failed:\n{out}\n{err}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RAYS ")]
        assert lines, f"no result line:\n{out}\n{err}"
        outs.append(lines[0])

    # both ranks read the same replicated ray count
    rays0 = int(outs[0].split()[1])
    rays1 = int(outs[1].split()[1])
    assert rays0 == rays1

    # single-process reference (the parent runs on the 8-virtual-device
    # CPU backend from conftest; plain unsharded render)
    import hashlib

    from csgrenderer.camera import Camera
    from csgrenderer.models import two_spheres_scene
    from csgrenderer.render import integrator

    scene = two_spheres_scene()
    cam = Camera.look_at(
        (0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=2.0
    )
    radiance, rays = integrator.render_image(
        scene.nearest_hit, cam, 32, 16, spp=2, max_bounces=4, seed=3
    )
    assert rays0 == int(rays)

    ref = np.asarray(radiance, np.float32)
    want = {}
    for row0 in range(0, 16, 4):  # 4 devices x 4-row slabs
        blob = np.ascontiguousarray(ref[row0 : row0 + 4])
        want[row0] = hashlib.sha256(blob.tobytes()).hexdigest()

    got = {}
    for line in outs:
        for part in line.split("SHARDS ", 1)[1].split():
            row0, sha = part.split(":")
            got[int(row0)] = sha
    assert got == want  # every slab bit-identical across the DCN boundary
