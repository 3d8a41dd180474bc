"""Batch vector ops and the kNN family — the matmul path.

Redesign of reference ``src/batch.rs``. The reference stores the
corpus dimension-major ("PDX"/vertical layout) so a scalar CPU loop over one
dimension touches contiguous memory and auto-vectorizes
(``src/batch.rs:256-265``). On an accelerator the unit of work is a tile,
not a lane: matmuls consume row-major (N, D) tiles directly and XLA performs
the layout/tiling, so a columnar layout would only add a transpose. We therefore
keep the :class:`VerticalBatch` *API* (constructors, accessors, the
dimension-major ``data()`` serialization format) but store rows natively.

Scan semantics carried over exactly (see each function's docstring):

- ``batch_knn`` / ``batch_knn_reordered``: exact L2^2, ascending.
- ``batch_knn_dot`` / ``batch_knn_cosine``: similarity, descending.
- ``batch_knn_filtered``: predicate pushdown; indices refer to the original
  batch.
- ``batch_knn_adaptive``: *approximate* warmup-extrapolation pruning
  (reference ``src/batch.rs:439-558``), redesigned as two passes.
- All orderings use IEEE total order (``f32::total_cmp`` parity) via
  :mod:`innr_tpu.utils.order`, so NaN scores can never poison selection.

The ``*_into`` buffer-reuse variants exist in the reference to avoid
re-allocating result vectors per scan (``src/batch.rs:250``). Under jit XLA
owns buffer reuse (donation + fusion), so here they are thin aliases kept
for migration parity.

Every kNN scan runs through :mod:`innr_tpu.scan` (scores, total-order keys
and top-k in one jitted computation on the route that :mod:`innr_tpu.route`
picks).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu import config, scan
from innr_tpu.config import NORM_EPSILON
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.order import top_k_total, total_order_key_f32

__all__ = [
    "VerticalBatch",
    "BatchKnnResult",
    "batch_l2_squared",
    "batch_l2_squared_into",
    "batch_dot",
    "batch_dot_into",
    "batch_norms",
    "batch_norms_into",
    "batch_cosine",
    "batch_cosine_into",
    "batch_l2_squared_pruning",
    "batch_dimension_variance",
    "batch_knn",
    "batch_knn_dot",
    "batch_knn_cosine",
    "batch_knn_filtered",
    "batch_knn_reordered",
    "batch_knn_adaptive",
]


class VerticalBatch:
    """Corpus container for batch scans (reference ``src/batch.rs:88``).

    Stores rows natively as a ``(num_vectors, dimension)`` f32 array (the
    matmul layout); the reference's dimension-major accessors are preserved on
    top of it. The backing array is exposed (``rows``, ``data()``) so
    callers own serialization, matching the reference's raw-data accessors
    (``src/batch.rs:212-214``).
    """

    __slots__ = ("rows", "_norms2", "_inv_norms", "_tile_summary",
                 "_tile_summary_norm", "_prune_tile_n")

    def __init__(self, rows: jax.Array, dtype=jnp.float32):
        """``dtype=jnp.bfloat16`` stores the corpus half-precision: the
        bandwidth-bound scans read half the bytes (bf16 x bf16 products
        with f32 accumulation) at ~1e-2 relative
        score precision — an option with no reference analog."""
        if dtype not in (jnp.float32, jnp.bfloat16):
            raise ContractError("VerticalBatch: dtype must be float32 or bfloat16")
        rows = jnp.asarray(rows, dtype=dtype)
        if rows.ndim != 2:
            raise ContractError(
                f"VerticalBatch: rows must be 2-D (N, D), got {rows.shape}"
            )
        self.rows = rows
        # Lazy per-row norm caches (rows are immutable jax arrays): the
        # reference's batch_norms precompute — computing them inside each
        # L2/cosine scan would cost a second full corpus read per call.
        self._norms2 = None
        self._inv_norms = None
        self._tile_summary = None
        self._tile_summary_norm = None
        self._prune_tile_n = None

    def norms2(self) -> jax.Array:
        """Per-row squared L2 norms, computed once and cached."""
        if self._norms2 is None:
            self._norms2 = scan.sq_norms(self.rows)
        return self._norms2

    def inv_norms(self) -> jax.Array:
        """Per-row guarded inverse norms (zero-norm -> 0.0), cached."""
        if self._inv_norms is None:
            self._inv_norms = scan.inv_norms(self.rows)
        return self._inv_norms

    def set_prune_tile_n(self, tile_n) -> "VerticalBatch":
        """Override the pruning tile height for this corpus (layout knob).

        The default (``prune.default_tile_n``) assumes
        clusters span several tiles; corpora whose natural cluster size
        is SMALLER than a tile cannot prune at all (tile radii approach
        the inter-center distance). Setting
        a smaller tile height trades grid steps for coherence: pass your
        cluster size (rounded up to a multiple of 128 rows) to re-enable
        pruning on fine-grained corpora. Exactness never depends on this
        — any tile height returns bit-identical results. ``None``
        restores the default. Clears the cached summaries; returns self.
        """
        from innr_tpu.prune import default_tile_n
        from innr_tpu.utils.padding import round_up

        if tile_n is not None:
            tile_n = int(tile_n)
            if tile_n <= 0:
                raise ContractError(
                    "set_prune_tile_n: tile_n must be positive or None"
                )
            cap = default_tile_n(self.num_vectors, self.dimension,
                                 self.rows.dtype)
            tile_n = min(round_up(tile_n, 128), cap)
        self._prune_tile_n = tile_n
        self._tile_summary = None
        self._tile_summary_norm = None
        return self

    def _tile_n(self) -> int:
        from innr_tpu.prune import default_tile_n

        if self._prune_tile_n is not None:
            return self._prune_tile_n
        return default_tile_n(self.num_vectors, self.dimension,
                              self.rows.dtype)

    def tile_summary(self, normalized: bool = False):
        """Per-tile (centroid, radius) bounds for tile-skip pruning
        (:mod:`innr_tpu.prune`), built lazily in one corpus pass and
        cached. Powers ``batch_knn*(..., prune=True)``,
        :func:`batch_knn_adaptive` and :func:`batch_l2_squared_pruning`
        on large corpora. ``normalized=True``: the unit-row summary the
        cosine pruned scan plans against (cached separately). Tile
        height: :meth:`set_prune_tile_n` override, else ``pruned_tile_n``."""
        from innr_tpu.prune import build_tile_summary

        if normalized:
            if self._tile_summary_norm is None:
                self._tile_summary_norm = build_tile_summary(
                    self.rows, self._tile_n(), normalized=True
                )
            return self._tile_summary_norm
        if self._tile_summary is None:
            self._tile_summary = build_tile_summary(self.rows, self._tile_n())
        return self._tile_summary

    def cluster_reorder(self, n_clusters: int = 256, n_iters: int = 5,
                        seed: int = 0, sample: int = 65536):
        """IVF-style layout pass for ``prune=True``: returns ``(reordered
        VerticalBatch, perm)`` where ``perm`` is the (N,) int32 device
        permutation (``new.rows[i] == self.rows[perm[i]]`` — map a kNN
        index ``j`` on the new batch back as ``perm[j]``).

        Everything runs on device (:func:`innr_tpu.prune.cluster_reorder`:
        sampled k-means++ fit, full-corpus assign, stable argsort, row
        gather — no host round-trip of any N-sized array), and the new
        batch's pruning tile height is set automatically from the
        measured cluster-size distribution (:func:`innr_tpu.prune.suggest_tile_n`),
        so fine-grained corpora prune without the manual
        :meth:`set_prune_tile_n` knob. Correctness never depends on the
        layout — pruned scans are exact under any order — only the
        achievable HBM elision does."""
        from innr_tpu.prune import cluster_reorder, suggest_tile_n

        reordered, perm, sizes = cluster_reorder(
            self.rows, n_clusters=n_clusters, n_iters=n_iters, seed=seed,
            sample=sample,
        )
        out = VerticalBatch(reordered, dtype=self.rows.dtype)
        out.set_prune_tile_n(
            suggest_tile_n(sizes, self.num_vectors, self.dimension,
                           self.rows.dtype)
        )
        return out, perm

    # -- constructors (reference src/batch.rs:103/138/167) ------------------

    @classmethod
    def from_rows(cls, vectors) -> "VerticalBatch":
        """Build from a sequence of equal-length vectors (row-major)."""
        if isinstance(vectors, (jnp.ndarray, np.ndarray)):
            # The ctor validates 2-D; a 1-D/3-D ndarray is a contract
            # violation, never a "sequence of scalar vectors".
            return cls(jnp.asarray(vectors, dtype=jnp.float32))
        vectors = list(vectors)
        if not vectors:
            return cls(jnp.zeros((0, 0), dtype=jnp.float32))
        dim = len(vectors[0])
        for v in vectors:
            if len(v) != dim:
                raise ContractError("VerticalBatch: inconsistent vector dimension")
        return cls(jnp.asarray(np.asarray(vectors, dtype=np.float32)))

    @classmethod
    def from_slices(cls, vectors) -> "VerticalBatch":
        """Alias of :meth:`from_rows` (reference ``src/batch.rs:138``)."""
        return cls.from_rows(vectors)

    @classmethod
    def from_flat(cls, data, num_vectors: int, dimension: int) -> "VerticalBatch":
        """Build from flat row-major data (reference ``src/batch.rs:167``)."""
        flat = np.asarray(data, dtype=np.float32).reshape(-1)
        if flat.size != num_vectors * dimension:
            raise ContractError(
                f"VerticalBatch.from_flat: {flat.size} values != "
                f"{num_vectors} x {dimension}"
            )
        return cls(jnp.asarray(flat.reshape(num_vectors, dimension)))

    # -- accessors -----------------------------------------------------------

    @property
    def num_vectors(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.rows.shape[1])

    def get(self, dim: int, vec_idx: int) -> float:
        """Value at (dimension, vector_index) — reference argument order."""
        return float(self.rows[vec_idx, dim])

    def dimension_slice(self, dim: int) -> jax.Array:
        """One dimension across all vectors (reference ``src/batch.rs:193``)."""
        return self.rows[:, dim]

    def data(self) -> np.ndarray:
        """Flat data in the reference's dimension-major serialization format
        (``data[d * num_vectors + i]``, reference ``src/batch.rs:212``)."""
        return np.asarray(self.rows).T.reshape(-1)

    def extract_vector(self, vec_idx: int) -> jax.Array:
        return self.rows[vec_idx]

    def __repr__(self) -> str:  # pragma: no cover
        return f"VerticalBatch(num_vectors={self.num_vectors}, dimension={self.dimension})"


@dataclass
class BatchKnnResult:
    """kNN result (reference ``src/batch.rs:369``). Score meaning matches the
    producing function: L2^2 for ``batch_knn``/``adaptive``/``reordered``/
    ``filtered`` (lower = closer), similarity for ``dot``/``cosine``
    (higher = more similar)."""

    indices: np.ndarray
    scores: np.ndarray


# ---------------------------------------------------------------------------
# jit'd score functions
# ---------------------------------------------------------------------------

@jax.jit
def _l2sq_scores(q: jax.Array, rows: jax.Array) -> jax.Array:
    d = rows.astype(jnp.float32) - q[None, :]
    return jnp.sum(d * d, axis=1)


@jax.jit
def _l2sq_scores_decomposed(q: jax.Array, rows: jax.Array,
                            norms2: jax.Array) -> jax.Array:
    """L2^2 via the decomposition ``norms2 - 2 q.r + ||q||^2`` — the form
    the large-corpus kNN scans use (:mod:`innr_tpu.scan`)."""
    qq = jnp.sum(q.astype(jnp.float32) * q)
    return norms2 - 2.0 * scan.dots(q[None, :], rows)[0] + qq


@jax.jit
def _dot_scores(q: jax.Array, rows: jax.Array) -> jax.Array:
    return scan.dots(q[None, :], rows)[0]


@jax.jit
def _norms(rows: jax.Array) -> jax.Array:
    r = rows.astype(jnp.float32)
    return jnp.sqrt(jnp.sum(r * r, axis=1))


@jax.jit
def _cosine_scores(q: jax.Array, rows: jax.Array, norms: jax.Array) -> jax.Array:
    dots = scan.dots(q[None, :], rows)[0]
    qn = jnp.sqrt(jnp.sum(q * q))
    denom = qn * norms
    ok = (qn > NORM_EPSILON) & (norms > NORM_EPSILON)
    return jnp.where(ok, dots / jnp.where(ok, denom, 1.0), 0.0)


@partial(jax.jit, static_argnames=("k", "warmup_dims"))
def _knn_adaptive(qs: jax.Array, rows: jax.Array, k: int, warmup_dims: int):
    """Two-phase adaptive kNN for a (Q, D) query batch
    (see :func:`batch_knn_adaptive`)."""
    dim = rows.shape[1]
    scale = jnp.float32(dim) / jnp.float32(warmup_dims)

    # Phase 1: warmup over the first warmup_dims dimensions (one pass).
    dw = rows[None, :, :warmup_dims] - qs[:, None, :warmup_dims]
    partial_d = jnp.sum(dw * dw, axis=2)  # (Q, N)
    kth_vals, _ = top_k_total(partial_d, k, largest=False)
    threshold = kth_vals[:, -1:] * scale  # (Q, 1)
    # Inverted gate so NaN warmup partials stay alive, matching the
    # reference's "estimated > threshold * 1.5 -> prune" (false for NaN,
    # src/batch.rs:474-488).
    alive = ~(partial_d * scale > threshold * 1.5)

    # Phase 2: exact distances; the static-threshold prune
    # (full <= threshold) is exactly the reference's per-dimension
    # monotone-accumulation prune before re-tightening.
    d = rows[None, :, :] - qs[:, None, :]
    full = jnp.sum(d * d, axis=2)  # (Q, N)
    alive = alive & ~(full > threshold)

    keys = total_order_key_f32(full)
    keys = jnp.where(alive, keys, jnp.iinfo(jnp.int32).max)
    _, idx = jax.lax.top_k(~keys, k)
    return jnp.take_along_axis(full, idx, axis=1), idx, alive


# ---------------------------------------------------------------------------
# public batch scans
# ---------------------------------------------------------------------------

def _check_query(query, batch: VerticalBatch, op: str, allow_multi: bool = False) -> jax.Array:
    q = jnp.asarray(query, dtype=jnp.float32)
    ok_rank = q.ndim == 1 or (allow_multi and q.ndim == 2)
    if not ok_rank or q.shape[-1] != batch.dimension:
        raise ContractError(
            f"innr_tpu::{op}: query shape {q.shape} incompatible with batch "
            f"dimension {batch.dimension}"
        )
    return q


def batch_l2_squared(query, batch: VerticalBatch) -> jax.Array:
    """Squared L2 from query to every vector (reference ``src/batch.rs:236``)."""
    q = _check_query(query, batch, "batch_l2_squared")
    return _l2sq_scores(q, batch.rows)


def batch_l2_squared_into(query, batch: VerticalBatch) -> jax.Array:
    """Alias of :func:`batch_l2_squared`; buffer reuse is XLA's job here."""
    return batch_l2_squared(query, batch)


def batch_dot(query, batch: VerticalBatch) -> jax.Array:
    """Dot products (one matvec; reference ``src/batch.rs:270``)."""
    q = _check_query(query, batch, "batch_dot")
    return _dot_scores(q, batch.rows)


def batch_dot_into(query, batch: VerticalBatch) -> jax.Array:
    """Alias of :func:`batch_dot` (reference ``src/batch.rs:284``)."""
    return batch_dot(query, batch)


def batch_norms(batch: VerticalBatch) -> jax.Array:
    """Per-vector L2 norms (reference ``src/batch.rs:652``)."""
    return _norms(batch.rows)


def batch_norms_into(batch: VerticalBatch) -> jax.Array:
    """Alias of :func:`batch_norms`."""
    return batch_norms(batch)


def batch_cosine(query, batch: VerticalBatch, norms=None) -> jax.Array:
    """Cosine similarities with precomputed norms
    (reference ``src/batch.rs:679``). Zero query norm -> all zeros; zero
    vector norm -> 0.0 for that vector."""
    q = _check_query(query, batch, "batch_cosine")
    if norms is None:
        norms = _norms(batch.rows)
    norms = jnp.asarray(norms, dtype=jnp.float32)
    if norms.shape[0] != batch.num_vectors:
        raise ContractError(
            f"innr_tpu::batch_cosine: norms length {norms.shape[0]} != "
            f"num_vectors {batch.num_vectors}"
        )
    return _cosine_scores(q, batch.rows, norms)


def batch_cosine_into(query, batch: VerticalBatch, norms=None) -> jax.Array:
    """Alias of :func:`batch_cosine`."""
    return batch_cosine(query, batch, norms)


def batch_l2_squared_pruning(
    query, batch: VerticalBatch, threshold: float
) -> tuple[np.ndarray, np.ndarray]:
    """Indices and distances of vectors with L2^2 <= threshold
    (reference ``src/batch.rs:320``).

    The reference prunes per-dimension as soon as the monotone partial sum
    exceeds ``threshold``; its survivor set is therefore exactly
    ``{i : full_dist[i] <= threshold}``. Here that is one full pass scored
    with the ``norms^2 - 2 q.r + ||q||^2`` decomposition, then a filter
    (a row whose exact distance ties the threshold to the last ulp may
    differ from the reference's sequential partial sums). Returns
    ``(indices, distances)``.
    """
    q = _check_query(query, batch, "batch_l2_squared_pruning")
    dists = np.asarray(_l2sq_scores_decomposed(q, batch.rows, batch.norms2()))
    keep = ~(dists > np.float32(threshold))  # NaN distances are kept out
    keep &= ~np.isnan(dists)
    idx = np.nonzero(keep)[0]
    return idx, dists[idx]


def batch_dimension_variance(batch: VerticalBatch) -> jax.Array:
    """Per-dimension population variance (reference ``src/batch.rs:561``)."""
    if batch.num_vectors <= 1 or batch.dimension == 0:
        return jnp.zeros((batch.dimension,), dtype=jnp.float32)
    mean = jnp.mean(batch.rows, axis=0)
    return jnp.mean((batch.rows - mean[None, :]) ** 2, axis=0)


# ---------------------------------------------------------------------------
# kNN family
# ---------------------------------------------------------------------------

# Corpus size from which batch_knn_adaptive returns the exact scan.
ADAPTIVE_EXACT_MIN_ROWS = 2048

def _empty_result(q=None) -> BatchKnnResult:
    """Empty result; shaped (Q, 0) for a 2-D query batch so per-query
    indexing works on the k=0 / empty-corpus edge."""
    shape = (0,) if q is None or getattr(q, "ndim", 1) == 1 else (int(q.shape[0]), 0)
    return BatchKnnResult(
        indices=np.zeros(shape, dtype=np.int64),
        scores=np.zeros(shape, dtype=np.float32),
    )


def _result(vals, idx) -> BatchKnnResult:
    # One device_get fetches both arrays in a single transfer.
    vals, idx = jax.device_get((vals, idx))
    return BatchKnnResult(
        indices=np.asarray(idx, dtype=np.int64),
        scores=np.asarray(vals, dtype=np.float32),
    )


def _scan(q, batch: VerticalBatch, k: int, mode: str, aux,
          prune: bool = False) -> BatchKnnResult:
    """One dense scan of ``batch`` for a (D,) or (Q, D) query.
    ``prune``: read only the tiles the survivor plan keeps, where the
    route can skip tiles (:func:`innr_tpu.scan.planned_knn`)."""
    multi = q.ndim == 2
    qs = q if multi else q[None, :]
    if mode in ("cosine", "cosinem"):
        qs = scan.unit_queries(qs)
    route = scan.dense_route(qs, batch.rows, k)
    if prune and route == "triton":
        summary = batch.tile_summary(normalized=mode == "cosine")
        vals, idx = scan.planned_knn(qs, batch.rows, aux, summary, k, mode)
    else:
        vals, idx = scan.knn(qs, batch.rows, aux, k, mode, route=route)
    if not multi:
        vals, idx = vals[0], idx[0]
    return _result(vals, idx)


def batch_knn(query, batch: VerticalBatch, k: int, prune: bool = False) -> BatchKnnResult:
    """Exact k nearest neighbors by squared L2 (reference ``src/batch.rs:385``).

    Scores ascending. Selection is total-order top-k, equivalent to feeding
    every candidate through :class:`innr_tpu.ops.topk.TopK`.

    Extensions: ``query`` may be a (Q, D) batch — all Q queries share one
    corpus scan and the result arrays are (Q, k). ``prune=True`` runs the
    tile-skipping scan where the route supports it (:mod:`innr_tpu.prune`
    plans the tiles; the Triton scan reads only those): identical exact
    results, and tiles whose centroid/radius bound proves them loser-only
    are never read. Other routes run the full scan.
    """
    q = _check_query(query, batch, "batch_knn", allow_multi=True)
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)
    k = min(int(k), batch.num_vectors)
    return _scan(q, batch, k, "l2", batch.norms2(), prune)


def batch_knn_dot(query, batch: VerticalBatch, k: int, prune: bool = False) -> BatchKnnResult:
    """Top-k by dot product — MIPS (reference ``src/batch.rs:731``).

    Scores descending. NaN scores sort first, matching the reference's
    descending ``total_cmp`` sort.

    Extensions: ``query`` may be a (Q, D) batch — all Q queries share one
    corpus scan (one matmul) and the result arrays are (Q, k).
    ``prune=True``: tile-skipping scan with the same exact result (see
    :func:`batch_knn`).
    """
    q = _check_query(query, batch, "batch_knn_dot", allow_multi=True)
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)
    k = min(int(k), batch.num_vectors)
    return _scan(q, batch, k, "dot", None, prune)


def batch_knn_cosine(query, batch: VerticalBatch, k: int, prune: bool = False) -> BatchKnnResult:
    """Top-k by cosine similarity (reference ``src/batch.rs:766``).

    Precomputes corpus inverse norms once; queries are normalised on the
    device, so a zero-norm query scores everything 0.0 with no host sync.
    Scores descending.

    Extensions: ``query`` may be a (Q, D) batch — all Q queries share one
    corpus scan and the result arrays are (Q, k). ``prune=True``:
    tile-skipping scan over unit-row bounds, same exact result (see
    :func:`batch_knn`).
    """
    q = _check_query(query, batch, "batch_knn_cosine", allow_multi=True)
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)
    k = min(int(k), batch.num_vectors)
    return _scan(q, batch, k, "cosine", batch.inv_norms(), prune)


def batch_knn_filtered(query, batch: VerticalBatch, k: int, predicate) -> BatchKnnResult:
    """kNN with predicate pushdown (reference ``src/batch.rs:809``).

    ``predicate`` is either a callable ``index -> bool`` (evaluated on host,
    as the reference does) or a precomputed boolean mask array of length
    ``num_vectors`` — the device-native form, since the scan consumes a
    mask. Indices refer to the original batch. Returns at most
    ``min(k, num_passing)`` results.

    Extension: ``query`` may be a (Q, D) batch (result arrays (Q, k)); the
    predicate is applied inside the scan, before selection.
    """
    q = _check_query(query, batch, "batch_knn_filtered", allow_multi=True)
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)

    if callable(predicate):
        mask = np.fromiter(
            (bool(predicate(i)) for i in range(batch.num_vectors)),
            dtype=bool,
            count=batch.num_vectors,
        )
    else:
        mask = np.asarray(predicate, dtype=bool)
        if mask.shape != (batch.num_vectors,):
            raise ContractError(
                f"innr_tpu::batch_knn_filtered: mask shape {mask.shape} != "
                f"({batch.num_vectors},)"
            )
    num_passing = int(mask.sum())
    if num_passing == 0:
        return _empty_result(q)
    # k <= num_passing guarantees every selected row passes (non-passing
    # rows sort strictly after ANY passing row, NaN included).
    k = min(int(k), num_passing)
    aux = jnp.stack([batch.norms2(), jnp.asarray(mask, jnp.float32)])
    return _scan(q, batch, k, "l2m", aux)


def _variance_order(batch: VerticalBatch) -> jax.Array:
    """Dimension permutation for the reordered scan: highest population
    variance first (total-order keys flip under ``~``, so argsort-ascending
    of the flipped keys is variance-descending; ties break low-dim-first
    via the stable sort)."""
    variances = batch_dimension_variance(batch)
    return jnp.argsort(~total_order_key_f32(variances), stable=True)


def batch_knn_reordered(query, batch: VerticalBatch, k: int) -> BatchKnnResult:
    """Exact kNN, processing dimensions in decreasing variance order
    (reference ``src/batch.rs:610``).

    Produces the same neighbors as :func:`batch_knn`. On CPU the reordering
    tightens pruning bounds; under XLA the reduction order is the compiler's
    choice, so the permutation is applied for semantic parity (identical
    results up to float association) and the scan itself is one fused pass.

    Extension: ``query`` may be a (Q, D) batch.
    """
    q = _check_query(query, batch, "batch_knn_reordered", allow_multi=True)
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)
    k = min(int(k), batch.num_vectors)
    order = _variance_order(batch)
    permuted = VerticalBatch(batch.rows[:, order], dtype=batch.rows.dtype)
    return _scan(q[..., order], permuted, k, "l2", permuted.norms2())


def batch_knn_adaptive(
    query, batch: VerticalBatch, k: int, warmup_dims: int,
    force_adaptive: bool = False,
) -> BatchKnnResult:
    """Adaptive kNN with warmup-extrapolated pruning — **approximate**
    (reference ``src/batch.rs:439``).

    Phase 1 scores the first ``warmup_dims`` dimensions (one narrow
    pass), linearly extrapolates a pruning threshold from the k-th best
    partial distance (x ``dim/warmup``, x1.5 margin), and drops candidates
    whose extrapolated distance exceeds it. Phase 2 computes exact distances
    for survivors and applies the monotone-accumulation prune
    (``full > threshold``), which here collapses to one masked comparison
    because a candidate's partial L2^2 is monotone in the dimension count.

    The data-dependent per-dimension early exit of the CPU version does not
    map to XLA; this keeps the documented *approximation contract* (true
    neighbors pruned in warmup stay pruned) while every survivor's score is
    exact. May return fewer than ``k`` results when pruning is aggressive,
    like the reference. The reference's periodic threshold re-tightening
    only removes additional candidates; we skip it, so this version is
    never less accurate.

    Extension: ``query`` may be a (Q, D) batch. Result arrays
    are rectangular (Q, k); when a query has fewer than k survivors its
    tail entries carry index ``-1`` and score NaN (per-query trimming
    would be ragged).

    **Size boundary**: corpora with ``num_vectors >=
    ADAPTIVE_EXACT_MIN_ROWS`` run the exact tile-skipping scan of
    :func:`batch_knn` instead. The two-phase form reads the corpus twice;
    the exact scan reads it at most once, and — within the documented approximation contract,
    which only permits losing true neighbors — its result is simply the
    exact top-k. On that path ``warmup_dims`` is validated but otherwise
    unused and results always fill all k slots (no -1/NaN padding). Pass
    ``force_adaptive=True`` (or ``config.force_reference(True)``) to run
    the warmup-extrapolation path regardless of corpus size.
    """
    q = _check_query(query, batch, "batch_knn_adaptive", allow_multi=True)
    if warmup_dims <= 0:
        raise ContractError("innr_tpu::batch_knn_adaptive: warmup_dims must be > 0")
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)
    k = min(int(k), batch.num_vectors)
    warmup_dims = min(int(warmup_dims), batch.dimension)
    multi = q.ndim == 2
    qs = q if multi else q[None, :]
    if (not force_adaptive and not config.reference_forced()
            and batch.num_vectors >= ADAPTIVE_EXACT_MIN_ROWS):
        return batch_knn(q, batch, k, prune=True)
    vals, idx, alive = _knn_adaptive(qs, batch.rows, k, warmup_dims)
    vals, idx = np.asarray(vals), np.asarray(idx)
    keep = np.take_along_axis(np.asarray(alive), idx, axis=1)
    if not multi:
        return _result(vals[0][keep[0]], idx[0][keep[0]])
    return BatchKnnResult(
        indices=np.where(keep, idx, -1).astype(np.int64),
        scores=np.where(keep, vals, np.nan).astype(np.float32),
    )
