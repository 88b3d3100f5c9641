"""Child process for tests/test_multihost.py — one rank of a two-process
CPU rendering job (the DCN multi-host smoke test, SURVEY §5 dist-comm).

Usage: python _multihost_child.py <process_id> <port>
Env:   XLA_FLAGS must include --xla_force_host_platform_device_count=2
       (set by the parent test) so the 2 processes form a 4-device world.

Prints one machine-readable line: RAYS <n> SHARDS <idx>:<sha> ...
"""

import hashlib
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> int:
    pid, port = int(sys.argv[1]), sys.argv[2]

    from csgrenderer.parallel import initialize_multihost, make_mesh

    initialize_multihost(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()

    import numpy as np

    from csgrenderer.camera import Camera
    from csgrenderer.models import two_spheres_scene
    from csgrenderer.parallel import render_scene_sharded

    scene = two_spheres_scene()
    cam = Camera.look_at(
        (0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=2.0
    )
    mesh = make_mesh(4, 1)  # rows over all 4 devices, DCN between hosts
    radiance, rays = render_scene_sharded(
        scene, cam, 32, 16, mesh, spp=2, max_bounces=4, seed=3,
        backend="jnp",
    )
    # rays is replicated (out_specs P()) -> readable on every process;
    # radiance is row-sharded -> hash this process's addressable slabs.
    parts = []
    for s in radiance.addressable_shards:
        row0 = s.index[0].start or 0
        data = np.ascontiguousarray(np.asarray(s.data, np.float32))
        parts.append(f"{row0}:{hashlib.sha256(data.tobytes()).hexdigest()}")
    print(f"RAYS {int(rays)} SHARDS {' '.join(sorted(parts))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
