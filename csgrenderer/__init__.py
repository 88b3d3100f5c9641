"""csgrenderer — a CSG path-tracing framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the reference
``tsnl/CsgRenderer`` ("Wololo") Vulkan/GLSL renderer: a host-side CSG
scene-graph API compiled to a flattened instruction tape, a batched
ray-tracing render loop (Pallas-Triton kernels on the hot path), RTIOW-style
materials with an iterative bounce loop, multi-card rendering via
``jax.sharding`` meshes, and an app/frame-loop layer with stats, image IO and
progressive accumulation.

Layer map (bottom-up), mirroring SURVEY.md §7:

- ``math``     vec3/quaternion over jnp arrays      (≈ src/wololo/wmath.*)
- ``camera``   pinhole + thin-lens cameras          (≈ ubershader1.frag:19-82)
- ``scene``    CSG graph API + tape compiler        (≈ renderer.h:22-33)
- ``render``   intersections, CSG interval eval, materials, integrator
                                                    (≈ ubershader1.frag:84-124)
- ``kernels``  Pallas-Triton kernels for spheres and CSG tapes (the fast path)
- ``parallel`` device mesh + shard_map rendering
- ``app``      frame loop, fixed-timestep callbacks, stats  (≈ src/wololo/app.c)
- ``io``       PNG/PPM, golden compare, checkpoints
- ``models``   built-in scene families (milestone-01, RTIOW final, deep CSG)
"""

__version__ = "0.1.0"

from . import math  # noqa: F401
