"""Which implementation each scan family runs: one function, one place.

Every op family (dense kNN, packed binary/ternary, slot sketches, sparse
join, MaxSim, nearest-centroid assignment) has a plain XLA implementation
that is the CPU route, the reference every kernel is tested against, and
the GPU route wherever no kernel has beaten it on the card. :func:`route`
is the only place that decision is made; library code never selects a
Pallas interpreter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from innr_tpu import config

__all__ = ["FAMILIES", "TRITON_MAX_K", "TRITON_MAX_Q", "TRITON_MIN_ROWS",
           "route", "current_route"]

FAMILIES = ("dense", "binary", "ternary", "slot", "sparse", "maxsim",
            "assign")

# Dense scans the Triton kernel takes on the GPU (see PERF.md for the
# measurements these bounds come from): at most this many results per
# query (k=100 measured a tie on f32 and a loss on u8)...
TRITON_MAX_K = 64
# ...at most this many queries per launch (the largest batch measured)...
TRITON_MAX_Q = 32
# ...and corpora at least this tall (smaller scans cost little either way).
TRITON_MIN_ROWS = 1 << 16


def route(family: str, platform: str, n: int, k: int, dtype, n_q: int,
          d: int | None = None) -> str:
    """``"xla"`` or ``"triton"`` for one call of ``family``.

    ``platform`` is the JAX platform the call runs on (``"cpu"``,
    ``"gpu"``); ``n`` corpus rows, ``k`` results per query, ``dtype`` the
    corpus dtype, ``n_q`` queries, ``d`` the feature width where the
    family has one. Off the GPU the route is always ``"xla"``.
    """
    if family not in FAMILIES:
        raise ValueError(f"route: unknown family {family!r}")
    if (
        family == "dense"
        and platform == "gpu"
        and n >= TRITON_MIN_ROWS
        and 0 < k <= TRITON_MAX_K
        and 0 < n_q <= TRITON_MAX_Q
        and jnp.dtype(dtype) in (jnp.float32, jnp.bfloat16, jnp.uint8)
        and d is not None
        and _triton_shape_ok(n, d, dtype)
    ):
        return "triton"
    return "xla"


def _triton_shape_ok(n: int, d: int, dtype) -> bool:
    from innr_tpu.kernels.triton_knn import d_chunk, offsets_fit

    return d_chunk(int(d)) > 0 and offsets_fit(n, d, dtype)


def current_route(family: str, n: int, k: int, dtype, n_q: int,
                  d: int | None = None) -> str:
    """:func:`route` on the default backend; ``"xla"`` when the reference
    path is forced (``config.force_reference``)."""
    if config.reference_forced():
        return "xla"
    return route(family, jax.default_backend(), n, k, dtype, n_q, d)
