"""Dense kNN scan core: scores, total-order keys and top-k.

Every dense kNN entry point (``batch.py``, ``pipeline.py``, ``ivf.py``,
``segmented.py``, the distributed indexes in ``parallel/``) funnels into
:func:`knn_keys`, which returns raw int32 total-order keys (larger = better
for every mode; see :mod:`innr_tpu.utils.order`) plus row indices, and
:func:`decode_keys`, which turns merged keys back into scores.

The XLA route reads the corpus in its stored dtype; nothing here makes a
widened copy of it:

- f32 corpora: one f32 matmul at ``config.matmul_precision()``;
- bf16 corpora: bf16 x bf16 with f32 accumulation (queries rounded to
  bf16, the documented half-precision mode);
- u8 corpora: codes are exact in bf16, and the query is split into three
  bf16 parts whose sum is the f32 query exactly, so one bf16 matmul of the
  stacked parts gives exact products, accumulated in f32.

L2 on corpora of :data:`DIRECT_L2_MAX_ROWS` rows or more uses the norms
decomposition ``||r||^2 - 2 q.r`` (one matmul; ``||q||^2`` is a per-query
shift added back by :func:`decode_keys`). Smaller corpora use the direct
difference form, which is exact for self-matches.

Modes: ``dot``, ``l2``, ``cosine`` and the masked forms ``dotm``, ``l2m``,
``cosinem``. ``aux`` rows: squared norms (l2), inverse norms (cosine;
queries arrive unit-normalised), then for masked modes a 0/1 predicate as
the last row. Rows whose predicate is 0 get the smallest key and never
beat a passing row.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from innr_tpu import config
from innr_tpu.config import NORM_EPSILON
from innr_tpu.route import current_route
from innr_tpu.utils.order import top_k_keys, total_order_key_f32

__all__ = [
    "DIRECT_L2_MAX_ROWS",
    "dense_route",
    "dots",
    "round_bf16",
    "split_bf16",
    "score_keys",
    "knn_keys",
    "decode_keys",
    "knn",
    "planned_knn_keys",
    "planned_knn",
    "inv_norms",
    "sq_norms",
    "unit_queries",
    "invert_total_key",
]

DIRECT_L2_MAX_ROWS = 2048

_INT_MIN = jnp.iinfo(jnp.int32).min
_DN = (((1,), (1,)), ((), ()))


def invert_total_key(keys: jax.Array) -> jax.Array:
    """Inverse of ``total_order_key_f32`` (the map is an involution)."""
    mask = jnp.where(keys < 0, jnp.int32(0x7FFFFFFF), jnp.int32(0))
    return jax.lax.bitcast_convert_type(keys ^ mask, jnp.float32)


def unit_queries(qs: jax.Array) -> jax.Array:
    """Normalise query rows; zero/tiny-norm queries become zero rows, so
    every cosine they produce is exactly 0.0 (the reference's zero-norm
    guard) with no host sync."""
    qn = jnp.sqrt(jnp.sum(qs * qs, axis=1, keepdims=True))
    ok = qn > NORM_EPSILON
    return jnp.where(ok, qs / jnp.where(ok, qn, 1.0), 0.0)


@jax.jit
def sq_norms(rows: jax.Array) -> jax.Array:
    """Per-row squared L2 norms in f32, the L2 scan's aux row. Jitted so
    the widened rows and their squares are never materialised: one read
    of the corpus in its stored dtype."""
    r = rows.astype(jnp.float32)
    return jnp.sum(r * r, axis=1)


@jax.jit
def inv_norms(rows: jax.Array) -> jax.Array:
    """Per-row guarded inverse norms (zero/tiny-norm rows -> 0.0), the
    cosine scan's aux row. Precompute once per corpus."""
    norms = jnp.sqrt(sq_norms(rows))
    ok = norms > NORM_EPSILON
    return jnp.where(ok, 1.0 / jnp.where(ok, norms, 1.0), 0.0)


def dots(qs: jax.Array, rows: jax.Array) -> jax.Array:
    """(Q, N) f32 dot products of (Q, D) f32 queries with an (N, D) f32,
    bf16 or u8 corpus, read in its stored dtype (see the module doc)."""
    qs = qs.astype(jnp.float32)
    # HIGHEST on the bf16 dots keeps the products exact and the sums in
    # f32: without it XLA on the GPU may rewrite a one-query dot into a
    # reduction that rounds each product to bf16.
    if rows.dtype == jnp.bfloat16:
        return jax.lax.dot_general(
            qs.astype(jnp.bfloat16), rows, _DN,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    if rows.dtype == jnp.uint8:
        parts = split_bf16(qs)
        n_q = qs.shape[0]
        out = jax.lax.dot_general(
            jnp.concatenate(parts), rows.astype(jnp.bfloat16), _DN,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        # Smallest part first, as a sum of exact products would be.
        return (out[2 * n_q:] + out[n_q:2 * n_q]) + out[:n_q]
    return jax.lax.dot_general(
        qs, rows.astype(jnp.float32), _DN,
        preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )


def round_bf16(x: jax.Array) -> jax.Array:
    """``x`` rounded to bf16 precision, kept in f32. An explicit
    ``reduce_precision``: XLA on the GPU may drop an f32 -> bf16 -> f32
    round trip of an intermediate (excess precision is allowed there), and
    the callers here need the rounding itself."""
    return jax.lax.reduce_precision(x.astype(jnp.float32), exponent_bits=8,
                                    mantissa_bits=7)


def split_bf16(x: jax.Array):
    """Three bf16 arrays whose f32 sum is ``x`` (8 + 8 + 8 mantissa bits).
    Non-finite entries keep their IEEE behaviour through the first part
    alone (inf - inf would put NaN into the others)."""
    x = x.astype(jnp.float32)
    hi = round_bf16(x)
    r = jnp.where(jnp.isfinite(x), x - hi, 0.0)
    mid = round_bf16(r)
    lo = round_bf16(r - mid)
    return (hi.astype(jnp.bfloat16), mid.astype(jnp.bfloat16),
            lo.astype(jnp.bfloat16))


def _direct_l2(n_rows: int, route: str = "xla") -> bool:
    """Whether L2 keys of an ``n_rows``-row scan on ``route`` come from
    the direct difference form (the Triton kernel always decomposes)."""
    return route != "triton" and n_rows < DIRECT_L2_MAX_ROWS


def score_keys(qs: jax.Array, rows: jax.Array, aux, mode: str) -> jax.Array:
    """(Q, N) int32 selection keys, larger = better for every mode."""
    if mode in ("l2", "l2m"):
        if _direct_l2(rows.shape[0]):  # score_keys is the XLA route
            diff = rows[None, :, :].astype(jnp.float32) - qs[:, None, :]
            scores = jnp.sum(diff * diff, axis=2)
        else:
            norms2 = aux if aux.ndim == 1 else aux[0]
            scores = norms2[None, :] - 2.0 * dots(qs, rows)
        keys = ~total_order_key_f32(scores)
    else:
        scores = dots(qs, rows)
        if mode in ("cosine", "cosinem"):
            inv = aux if aux.ndim == 1 else aux[0]
            scores = scores * inv[None, :]
        keys = total_order_key_f32(scores)
    if mode in ("dotm", "l2m", "cosinem"):
        pred = aux if aux.ndim == 1 else aux[-1]
        keys = jnp.where(pred[None, :] > 0.0, keys, _INT_MIN)
    return keys


@functools.partial(jax.jit, static_argnames=("k", "mode"))
def _xla_knn_keys(qs, rows, aux, k: int, mode: str):
    return top_k_keys(score_keys(qs, rows, aux, mode), k)


def dense_route(qs, rows, k: int) -> str:
    """The route of one dense scan (see :mod:`innr_tpu.route`)."""
    return current_route("dense", int(rows.shape[0]), int(k), rows.dtype,
                         int(qs.shape[0]), int(rows.shape[1]))


def knn_keys(qs: jax.Array, rows: jax.Array, aux, k: int, mode: str,
             route: str | None = None):
    """Top-``k`` raw keys and local row indices, ``((Q, k), (Q, k))``,
    best first; ties resolve to the lower row index. ``route`` defaults to
    :func:`dense_route`; callers that trace this inside their own ``jit``
    pass it as a static argument so a route change retraces."""
    if route is None:
        route = dense_route(qs, rows, k)
    if route == "triton":
        from innr_tpu.kernels import triton_knn

        return triton_knn.knn_keys(qs, rows, aux, k, mode)
    return _xla_knn_keys(qs, rows, aux, k, mode)


def planned_knn_keys(qs, rows, aux, cents, radii, counts, k: int, mode: str,
                     tile_n: int, route: str, interpret: bool = False):
    """:func:`knn_keys` that reads only the tiles a survivor plan keeps.

    ``cents``/``radii``/``counts`` summarise tiles of ``tile_n`` rows
    (:func:`innr_tpu.prune.build_tile_summary`; unit rows for cosine).
    On the Triton route, :func:`innr_tpu.prune.plan_survivors` picks the
    tiles that can hold a winner and the kernel scans only those, one
    tile per program. The plan's bounds are sound, so the result is the
    full scan's. Other routes run the full scan. ``interpret`` runs the
    kernel in Pallas interpret mode (tests only).
    """
    if route != "triton":
        return knn_keys(qs, rows, aux, k, mode, route=route)
    from innr_tpu.kernels import triton_knn
    from innr_tpu.prune import plan_survivors

    # Cosine plans as dot against the unit-row summary (queries arrive
    # unit-normalised); masked modes plan as their base mode (the
    # summary's counts cover valid rows only).
    plan_mode = "l2" if mode in ("l2", "l2m") else "dot"
    # A bf16 corpus is scored against bf16(q): plan against the same
    # rounded query so the bounds cover the scores the kernel computes.
    qs_plan = round_bf16(qs) if rows.dtype == jnp.bfloat16 else qs
    order, n_surv = plan_survivors(qs_plan, cents, radii, counts, k,
                                   plan_mode)
    return triton_knn.knn_keys(qs, rows, aux, k, mode, order=order,
                               n_surv=n_surv, block_n=tile_n,
                               interpret=interpret)


def planned_knn(qs, rows, aux, summary, k: int, mode: str,
                route: str | None = None, interpret: bool = False):
    """``(scores, indices)`` of :func:`planned_knn_keys` over a
    :class:`innr_tpu.prune.TileSummary`, in one jitted dispatch."""
    if summary.tile_n * summary.n_tiles < rows.shape[0]:
        raise ValueError("TileSummary does not cover the corpus")
    if route is None:
        route = dense_route(qs, rows, k)
        from innr_tpu.kernels.triton_knn import SUB_N

        if summary.tile_n % SUB_N:
            route = "xla"
    return _planned_knn_jit(qs, rows, aux, summary.centroids, summary.radii,
                            summary.counts, k, mode, summary.tile_n, route,
                            interpret)


@functools.partial(jax.jit, static_argnames=("k", "mode", "tile_n", "route",
                                              "interpret"))
def _planned_knn_jit(qs, rows, aux, cents, radii, counts, k: int, mode: str,
                     tile_n: int, route: str, interpret: bool):
    keys, idx = planned_knn_keys(qs, rows, aux, cents, radii, counts, k,
                                 mode, tile_n, route, interpret)
    return decode_keys(keys, mode, qs, rows.shape[0], route), idx


def decode_keys(keys: jax.Array, mode: str, qs: jax.Array, n_rows: int,
                route: str = "xla") -> jax.Array:
    """Raw keys -> scores. L2 keys of an ``n_rows``-row corpus scanned on
    ``route`` in the decomposed form get the per-query ``||q||^2`` back
    and are clamped at zero (the direct form is non-negative by
    construction)."""
    if mode in ("l2", "l2m"):
        vals = invert_total_key(~keys)
        if not _direct_l2(n_rows, route):
            qq = jnp.sum(qs * qs, axis=1, keepdims=True)
            vals = jnp.maximum(vals + qq, 0.0)
        return vals
    return invert_total_key(keys)


def knn(qs: jax.Array, rows: jax.Array, aux, k: int, mode: str,
        route: str | None = None):
    """``(scores (Q, k), indices (Q, k))`` best first: descending
    similarity for dot/cosine, ascending distance for L2. One jitted
    dispatch."""
    if route is None:
        route = dense_route(qs, rows, k)
    return _knn_jit(qs, rows, aux, k, mode, route)


@functools.partial(jax.jit, static_argnames=("k", "mode", "route"))
def _knn_jit(qs, rows, aux, k: int, mode: str, route: str):
    keys, idx = knn_keys(qs, rows, aux, k, mode, route=route)
    return decode_keys(keys, mode, qs, rows.shape[0], route), idx
