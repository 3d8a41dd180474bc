"""Global configuration for innr_tpu kernel selection.

The reference crate has three config mechanisms (cargo features, runtime CPU
detection, build-time target-cpu flags; see reference ``src/lib.rs:20-33``).
Here it is a single process-wide knob that keeps every scan on the plain
XLA route (our "portable" layer) instead of a hand-written kernel; which
route a scan takes otherwise is decided in :mod:`innr_tpu.route`.

Env var ``INNR_TPU_FORCE_REFERENCE=1`` forces the reference path at import
time; ``force_reference(True/False)`` toggles it at runtime.
"""

from __future__ import annotations

import os

# When True every dispatching op routes to the jnp reference implementation.
_FORCE_REFERENCE: bool = os.environ.get("INNR_TPU_FORCE_REFERENCE", "0") == "1"

# Threshold for treating an L2 norm as "effectively zero"
# (reference src/lib.rs:175).
NORM_EPSILON: float = 1e-9

# Relative slack applied to the tile-pruning dead-tile comparisons
# (innr_tpu/prune.py). The survivor planner's bounds and the scan's
# scores are both f32 but use different expansions (triangle bounds vs the
# norms^2 - 2 q.r decomposition), so each carries up to ~d * eps_f32 * scale
# of rounding error (d=128: ~1.5e-5 relative). A tile is only declared dead
# when its optimistic bound fails the threshold by MORE than this slack
# times a magnitude scale, so f32 rounding can never prune a true neighbor
# — keeping prune=True exact, not just "exact up to rounding". 1e-4 covers
# the d<=4096 error bound with >6x margin; the perf cost is nil (dead tiles
# are typically far below threshold). It assumes f32 arithmetic on both
# sides: the planner's bound matmuls run at Precision.HIGHEST, since TF32
# (~1e-3 relative) would exceed it.
PRUNE_BOUND_EPS: float = 1e-4
# Squared-space version of NORM_EPSILON (reference src/lib.rs:181).
NORM_EPSILON_SQ: float = NORM_EPSILON * NORM_EPSILON

# Precision for f32 score matmuls. "highest" is full f32 arithmetic; on a
# GPU that runs outside the tensor cores. "default" lets XLA use TF32
# (~1e-3 relative error) on the tensor cores. Exact f32 scores are the
# library's contract (ties and near-ties resolve as the reference does), so
# "highest" is the default; bf16 and u8 corpora do not use this knob (see
# innr_tpu/scan.py).
_MATMUL_PRECISION: str = os.environ.get("INNR_TPU_MATMUL_PRECISION", "highest")


def set_matmul_precision(precision: str) -> None:
    """Set score-matmul precision: "highest" (default) or "default"."""
    global _MATMUL_PRECISION
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown matmul precision {precision!r}")
    _MATMUL_PRECISION = precision


def matmul_precision():
    """The jax.lax.Precision for score matmuls."""
    import jax

    return (
        jax.lax.Precision.HIGHEST
        if _MATMUL_PRECISION == "highest"
        else jax.lax.Precision.DEFAULT
    )


def force_reference(enabled: bool = True) -> None:
    """Force (or unforce) the pure-jnp reference path for every op."""
    global _FORCE_REFERENCE
    _FORCE_REFERENCE = bool(enabled)


def reference_forced() -> bool:
    """True when the jnp reference path is forced."""
    return _FORCE_REFERENCE
