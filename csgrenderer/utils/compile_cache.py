"""JAX's persistent compilation cache, in one fixed place.

Entry points (bench.py, chip_smoke.py, ``python -m csgrenderer``, the
demos) call ``enable_compile_cache()`` before their first compilation;
importing the package does not, so importing still initializes no backend.
The path is part of the cache's key, so it never depends on a temporary
directory, the process id or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ=None) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    environ = os.environ if environ is None else environ
    path = environ.get(ENV_VAR)
    if path:
        return path
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at ``compile_cache_dir()``.

    When the environment variable is set JAX reads it itself, and nothing
    else is configured. Returns the directory in use.
    """
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
