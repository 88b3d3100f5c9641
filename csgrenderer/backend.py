"""The one place that decides which path renders a scene on this platform.

Two paths exist:

- ``"triton"``: the Pallas kernels on the Triton route (kernels/), for
  sphere soups and CSG tapes;
- ``"jnp"``: the plain JAX integrator (render/), compiled by XLA, for every
  scene type; it is also the reference the kernels are tested against.

On the GPU, scenes with a kernel take it and meshes take XLA. On the CPU
every scene takes XLA; a kernel runs there only in the Pallas interpreter,
which a caller asks for with ``interpret=True`` (the tests do). Any other
platform is an error, as is a request for the removed "pallas" route.
"""

from __future__ import annotations

import jax

BACKENDS = ("auto", "jnp", "triton")


def has_kernel(scene) -> bool:
    """True for the scene types that have a Triton kernel."""
    from .render.integrator import SphereScene
    from .scene.tape import CompiledTape

    return isinstance(scene, (SphereScene, CompiledTape))


def choose_backend(scene, requested: str = "auto", *, interpret: bool = False,
                   platform: str | None = None) -> str:
    """Return ``"triton"`` or ``"jnp"`` for rendering ``scene``.

    ``requested``: "auto", "jnp" or "triton". ``platform`` defaults to that
    of the first JAX device.
    """
    if requested not in BACKENDS:
        raise ValueError(
            f"backend {requested!r} is not one of {BACKENDS} (the 'pallas' "
            "route was removed; kernels run through Triton)"
        )
    if platform is None:
        platform = jax.devices()[0].platform
    if platform not in ("cpu", "gpu"):
        raise RuntimeError(f"no rendering path for platform {platform!r}")
    if requested == "jnp":
        return "jnp"
    kernel = has_kernel(scene)
    if requested == "triton":
        if not kernel:
            raise ValueError(
                f"no Triton kernel for {type(scene).__name__}; it renders "
                "on the plain XLA path (backend='jnp')"
            )
        if platform == "cpu" and not interpret:
            raise ValueError(
                "a Triton kernel runs on the CPU only in the Pallas "
                "interpreter (interpret=True)"
            )
        return "triton"
    if kernel and (platform == "gpu" or interpret):
        return "triton"
    return "jnp"
