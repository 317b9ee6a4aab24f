"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is.  Otherwise the
cache is ``.jax_cache/`` at the root of the checkout: a fixed path, since
the path is part of what a cached entry is found by.
"""

from __future__ import annotations

import os
from typing import Mapping

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(ROOT, ".jax_cache"))


def enable(environ: Mapping[str, str] = os.environ) -> str:
    """Point JAX's persistent compilation cache at ``cache_dir``."""
    path = cache_dir(environ)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
