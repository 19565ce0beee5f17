"""One place that decides where JAX's persistent compilation cache lives.

The directory is part of the cache key, so it must not move between runs:
``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself and this
module sets nothing); otherwise the cache goes to ``<checkout>/.jax_cache``,
a fixed path that ``.gitignore`` lists.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """The directory the cache uses: the environment's, else the default."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent cache and return its directory.

    Programs that compile faster than ``min_compile_secs`` are not stored."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return path
