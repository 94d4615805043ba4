"""Where the persistent XLA compilation cache lives.

``JAX_COMPILATION_CACHE_DIR``, when set, is used as given (JAX reads it
itself). Otherwise the cache goes to ``<checkout>/.jax_cache``: a fixed
path, because the directory is part of the cache's key, and one inside the
checkout, so that the program writes nothing outside it.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The compilation-cache directory this process uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def configure() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    cache every compiled program, however small. Returns the directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    return path
