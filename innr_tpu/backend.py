"""Kernel-selection introspection: which execution path will actually run.

Port of reference ``src/backend.rs``: dispatch is derived from shape,
platform, and the force-reference knob, and is invisible to callers; these
functions report the decision (:func:`innr_tpu.route.route`) so perf work
and bug reports don't re-derive it. Display strings are stable (they appear
in logs and bug reports — renaming is a breaking change, reference
``src/backend.rs:114-120``).
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

from innr_tpu import config
from innr_tpu.route import route

__all__ = ["Backend", "dense_backend", "batch_backend", "slot_backend"]


class Backend(enum.Enum):
    """An execution path the dispatchers can select."""

    # Hand-written Pallas kernel compiled through Triton (GPU only).
    TRITON = "triton"
    # Plain XLA code: matmuls, fused elementwise work and reductions.
    XLA = "xla"
    # Forced reference path (the portable-layer analog).
    REFERENCE = "reference"

    def __str__(self) -> str:
        return self.value


def dense_backend(length: int) -> Backend:
    """Path the single-pair dense f32 ops take for ``length``-dim vectors:
    always one XLA reduction (no length threshold — the reference's
    MIN_DIM_SIMD pays for ISA dispatch; XLA pays at compile time)."""
    if config.reference_forced():
        return Backend.REFERENCE
    return Backend.XLA


def batch_backend(num_rows: int, k: int = 10, n_queries: int = 1,
                  dtype=jnp.float32, dimension: int = 128) -> Backend:
    """Path the dense batch kNN scans take for a ``num_rows``-vector corpus
    on the default backend (the route of :func:`innr_tpu.route.route`)."""
    if config.reference_forced():
        return Backend.REFERENCE
    r = route("dense", jax.default_backend(), num_rows, k, dtype, n_queries,
              dimension)
    return Backend.TRITON if r == "triton" else Backend.XLA


def slot_backend(length: int) -> Backend:
    """Path the slot-Hamming ops take for ``length``-slot sketches."""
    if config.reference_forced():
        return Backend.REFERENCE
    return Backend.XLA
