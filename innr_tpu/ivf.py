"""IVF-layout exact kNN index: tile-ALIGNED cluster segments + pruned scan.

:func:`innr_tpu.prune.cluster_reorder` groups rows by nearest centroid, but
a plain reorder leaves cluster boundaries unaligned with pruning tiles —
most tiles straddle two clusters, their radii approach the inter-center
distance, and the elision caps far below the layout's potential.
:class:`IVFIndex` finishes the
job: every cluster segment is padded to a multiple of the pruning tile
height, so **no tile ever straddles a cluster** and each tile's
centroid/radius summary describes exactly one cluster's geometry — the
full IVF elision with none of the approximation:

- **Exact results.** Pruning uses the same sound centroid/radius bounds as
  ``batch_knn(..., prune=True)`` (:mod:`innr_tpu.prune`): a tile is
  skipped only when NO row in it can enter the top-k. There is no
  ``nprobe`` recall knob; results are bit-identical to a full scan of the
  original corpus. (Classical IVF — e.g. the reference's ecosystem
  counterparts — probes a fixed number of lists and loses recall;
  bound-based skipping is the exact formulation.)
- **Padding rows can never win.** They are excluded from the tile
  summary (``build_tile_summary(..., row_valid=...)`` — so threshold
  accumulation counts only real rows) and pinned to the worst selection
  key inside the scan (the "dotm"/"l2m"/"cosinem" masked modes,
  the same predicate pushdown as ``batch_knn_filtered``; reference
  ``src/batch.rs:842-845`` pins filtered rows to f32::MAX).
- **All-device build.** Fit (sampled k-means++), assignment, and the
  padded scatter run on device; only the per-cluster size vector (a few
  KB) crosses to the host to fix the padded shape.

Memory overhead: ``sum(round_up(size, tile) - size)`` rows of zero
padding, ~``n_clusters * tile_n / 2`` expected — pick ``tile_n`` (or let
the constructor match it to the measured cluster-size distribution) so
this stays a few percent.

Reference anchor: the pruned-scan mechanism parallels the reference's
self-limiting early-exit contract (``src/batch.rs:422-437``); the layout
pass is the answer to "where pruning helps" — it MAKES corpora
prunable instead of documenting which ones happen to be.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu import scan
from innr_tpu.batch import BatchKnnResult
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.padding import round_up

__all__ = ["IVFIndex"]

_MODES = {"dot": "dotm", "l2": "l2m", "cosine": "cosinem"}


def _pick_tile(sizes: np.ndarray, n: int, d: int, dtype) -> int:
    """Tile height for an ALIGNED layout: boundaries never straddle, so
    (unlike :func:`innr_tpu.prune.suggest_tile_n`'s half-cluster rule for
    plain reorders) tile ~= typical cluster is ideal — one tile covers one
    cluster with minimal padding. Median size rounded to a multiple of
    128 rows, floored at 256 and capped at
    :func:`innr_tpu.prune.default_tile_n`."""
    from innr_tpu.prune import default_tile_n

    cap = default_tile_n(max(n, 1), d, dtype)
    nz = sizes[sizes > 0]
    if nz.size == 0:
        return max(256, min(cap, 4096))
    med = float(np.median(nz))
    tile = max(128, int(round(med / 128.0)) * 128)
    return int(max(256, min(tile, cap)))


class IVFIndex:
    """Exact kNN over a cluster-padded corpus layout (see module doc).

    ``metric``: ``"dot"`` (MIPS, scores descending), ``"l2"`` (squared
    distances ascending), or ``"cosine"`` (similarities descending;
    zero-norm rows/queries score exactly 0.0, the reference guard).
    ``dtype=jnp.bfloat16`` stores the padded corpus half-precision (half
    the bytes per surviving tile, ~1e-2 relative score precision).
    """

    __slots__ = ("metric", "rows", "orig_idx", "tile_n", "n_true",
                 "_valid", "_aux", "_summary", "cluster_sizes")

    def __init__(self, rows, n_clusters: int = 256, metric: str = "dot",
                 tile_n: int | None = None, dtype=jnp.float32,
                 n_iters: int = 5, seed: int = 0, sample: int = 65536):
        if metric not in _MODES:
            raise ContractError(
                f"IVFIndex: metric must be one of {sorted(_MODES)}, "
                f"got {metric!r}"
            )
        if dtype not in (jnp.float32, jnp.bfloat16):
            raise ContractError("IVFIndex: dtype must be float32 or bfloat16")
        rows = jnp.asarray(rows)
        if rows.ndim != 2 or rows.shape[0] == 0:
            raise ContractError(
                f"IVFIndex: rows must be a non-empty (N, D) array, "
                f"got {rows.shape}"
            )
        from innr_tpu.prune import _kmeans_assign, _kmeans_params

        self.metric = metric
        n, d = int(rows.shape[0]), int(rows.shape[1])
        self.n_true = n

        r, kc, m = _kmeans_params(rows, n_clusters, sample)
        assign = _kmeans_assign(r, jax.random.PRNGKey(seed), n_iters, kc, m)
        # ONE stable pair sort supplies the permutation, the sorted
        # keys, and (via kc+1 binary searches) the cluster sizes, with no
        # N-element scatter-add.
        sorted_assign, perm, sizes_dev = _sort_assign(assign, kc)
        sizes = np.asarray(sizes_dev)  # host: kc ints (fixes the shape)
        self.cluster_sizes = sizes
        tile = int(tile_n) if tile_n is not None else _pick_tile(
            sizes, n, d, dtype
        )
        if tile <= 0:
            raise ContractError("IVFIndex: tile_n must be positive")
        self.tile_n = tile

        padded_sizes = -(-sizes // tile) * tile  # per-cluster, 0 stays 0
        n_pad = int(round_up(max(int(padded_sizes.sum()), tile), tile))
        offsets = jnp.asarray(
            np.concatenate([[0], np.cumsum(padded_sizes)[:-1]]), jnp.int32
        )
        starts = jnp.asarray(
            np.concatenate([[0], np.cumsum(sizes)[:-1]]), jnp.int32
        )
        self.rows, self.orig_idx = _scatter_layout(
            rows.astype(dtype), sorted_assign, perm, offsets, starts,
            n_pad=n_pad,
        )
        self._valid = self.orig_idx >= 0

        from innr_tpu.prune import build_tile_summary

        validf = self._valid.astype(jnp.float32)
        if metric == "dot":
            self._aux = validf[None, :]
        elif metric == "l2":
            self._aux = jnp.stack([scan.sq_norms(self.rows), validf])
        else:  # cosine
            self._aux = jnp.stack([scan.inv_norms(self.rows), validf])
        self._summary = build_tile_summary(
            self.rows, tile, normalized=(metric == "cosine"),
            row_valid=self._valid,
        )

    # -- introspection -------------------------------------------------------

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return int(self.rows.shape[1])

    @property
    def padding_fraction(self) -> float:
        """Fraction of stored rows that are alignment padding."""
        return 1.0 - self.n_true / int(self.rows.shape[0])

    def memory_bytes(self) -> int:
        itemsize = 2 if self.rows.dtype == jnp.bfloat16 else 4
        return (
            int(self.rows.size) * itemsize
            + int(self.orig_idx.size) * 4
            + int(self._aux.size) * 4
            + self._summary.memory_bytes()
        )

    def plan_stats(self, queries, k: int) -> tuple[int, int]:
        """Observability: ``(surviving_tiles, total_tiles)`` the pruned
        scan would read for this query batch — the elision the layout
        actually achieves (host sync; use for diagnostics, not serving)."""
        from innr_tpu.prune import plan_survivors

        qs = self._queries(queries)
        if self.metric == "cosine":
            qs = scan.unit_queries(qs)
        if self.rows.dtype == jnp.bfloat16:
            qs = scan.round_bf16(qs)
        s = self._summary
        _, n_surv = plan_survivors(
            qs, s.centroids, s.radii, s.counts,
            min(int(k), self.n_true),
            "l2" if self.metric == "l2" else "dot",
        )
        return int(n_surv), s.n_tiles

    # -- search ---------------------------------------------------------------

    def _queries(self, queries) -> jax.Array:
        qs = jnp.asarray(queries, jnp.float32)
        if qs.ndim == 1:
            qs = qs[None, :]
        if qs.ndim != 2 or qs.shape[1] != self.dimension:
            raise ContractError(
                f"IVFIndex: queries shape {qs.shape} != (Q, {self.dimension})"
            )
        return qs

    def search_batch(self, queries, k: int) -> BatchKnnResult:
        """Exact top-k for a (Q, D) batch — one plan+scan dispatch; on the
        Triton route only tiles that can hold a winner are read (other
        routes scan every tile, with padding masked). Indices refer to
        the ORIGINAL row order passed to the ctor."""
        qs = self._queries(queries)
        n_q = int(qs.shape[0])
        if k <= 0 or n_q == 0:
            return BatchKnnResult(
                indices=np.zeros((n_q, 0), np.int64),
                scores=np.zeros((n_q, 0), np.float32),
            )
        k = min(int(k), self.n_true)
        mode = _MODES[self.metric]
        if self.metric == "cosine":
            qs = scan.unit_queries(qs)
        vals, idx = scan.planned_knn(qs, self.rows, self._aux, self._summary,
                                     k, mode)
        # One device_get fetches both arrays in a single transfer.
        vals, orig = jax.device_get((vals, jnp.take(self.orig_idx, idx)))
        return BatchKnnResult(
            indices=np.asarray(orig, dtype=np.int64),
            scores=np.asarray(vals, dtype=np.float32),
        )

    def search(self, query, k: int) -> BatchKnnResult:
        """Single-query :meth:`search_batch` (1-D in, 1-D out)."""
        res = self.search_batch(jnp.asarray(query)[None, :], k)
        return BatchKnnResult(indices=res.indices[0], scores=res.scores[0])


@functools.partial(jax.jit, static_argnames=("kc",))
def _sort_assign(assign, kc: int):
    """(sorted_assign, perm, sizes) from ONE stable pair sort; sizes via
    kc+1 binary searches on the sorted keys instead of an N-element
    scatter-add (same analysis as ``innr_tpu.prune._apply_order``)."""
    n = assign.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    sorted_assign, perm = jax.lax.sort(
        (assign.astype(jnp.int32), iota), num_keys=1, is_stable=True
    )
    bounds = jnp.searchsorted(
        sorted_assign, jnp.arange(kc + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    return sorted_assign, perm, jnp.diff(bounds)


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _scatter_layout(rows, sorted_assign, perm, offsets, starts, n_pad: int):
    """Scatter rows into the padded aligned layout (device-side).

    ``sorted_assign``/``perm`` come from the build's single pair sort
    (rank within a cluster = sorted position minus the cluster's start).
    Module-level jit with ``n_pad`` static: repeat builds at the same
    shapes hit the compile cache (a per-call closure would retrace the
    2x-corpus scatter on every build)."""
    n = sorted_assign.shape[0]
    rank_sorted = jnp.arange(n, dtype=jnp.int32) - jnp.take(
        starts.astype(jnp.int32), sorted_assign
    )
    dest = jnp.take(offsets, sorted_assign) + rank_sorted
    out = jnp.zeros((n_pad, rows.shape[1]), rows.dtype)
    out = out.at[dest].set(jnp.take(rows, perm, axis=0))
    orig = jnp.full((n_pad,), -1, jnp.int32).at[dest].set(perm)
    return out, orig
