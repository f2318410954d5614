"""Where compiled XLA executables persist between processes."""

from __future__ import annotations

import os

# The checkout holding this package: <checkout>/deepmimo_tpu/utils/.
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache`` (git-ignored): the directory is part of the
    cache's key, so it must not move between runs. Call before the first
    compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
