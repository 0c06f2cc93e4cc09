"""Where the entry points keep JAX's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, wins (JAX reads it itself).
Otherwise the cache lives at ``.jax_cache/`` in the checkout: a fixed
path, because the path is part of what a later process must find again.
"""

from __future__ import annotations

import os

#: ``<checkout>/.jax_cache`` (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """The cache directory: ``JAX_COMPILATION_CACHE_DIR`` or DEFAULT_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return it. Call before the first compilation."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
