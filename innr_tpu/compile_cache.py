"""Persistent XLA compile cache, one rule for every entry script.

``chip_smoke.py``, ``bench.py`` and the examples call :func:`enable` once
before their first compile. If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
already reads it and nothing is set here; otherwise the cache lives at the
fixed path ``<repo>/.jax_cache`` (listed in ``.gitignore``), so repeated
runs from one checkout reuse compiled programs.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def enable() -> str:
    """Turn the cache on; returns the directory in use."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
