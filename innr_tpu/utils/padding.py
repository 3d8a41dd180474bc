"""Padding helpers.

Pad an axis up to a multiple — used by the sharded containers (rows padded
to a multiple of the mesh size) so padding never breaks index mapping.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``x``."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return ((x + multiple - 1) // multiple) * multiple


def pad_axis_to(x: jax.Array, axis: int, size: int, value=0) -> jax.Array:
    """Pad ``x`` along ``axis`` with ``value`` up to exactly ``size``."""
    current = x.shape[axis]
    if current > size:
        raise ValueError(f"axis {axis} already larger than {size}: {x.shape}")
    if current == size:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, size - current)
    return jnp.pad(x, pads, constant_values=value)


def materialize_words(x: jax.Array) -> jax.Array:
    """Commit a (possibly lazily laid-out) integer transpose to a
    standard-layout device buffer NOW. The packed containers' word-major
    transposes are streamed from HBM by every fused scan, so the copy
    must happen once at container build, not per launch. The ``+ 0`` is
    a layout-commit idiom, not arithmetic (``- 0`` would be equally
    correct) — it lives here, outside the mutation targets, for exactly
    that reason."""
    return x + jnp.zeros((), dtype=x.dtype)
