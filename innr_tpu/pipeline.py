"""Two-stage retrieval pipelines: quantized coarse scan -> exact rerank.

The reference demonstrates coarse-then-rerank as example code
(``examples/binary_demo.rs:139+``, ``examples/ternary_demo.rs:290+``,
``examples/matryoshka_search.rs:14-18``); in a serving framework it is the
primary entry point, so innr_tpu makes it a first-class, jit-friendly
object. A :class:`TwoStageIndex` owns the f32 corpus plus one encoded
coarse representation and answers queries with:

1. **coarse**: scan of the compressed corpus (1-32x fewer bytes read)
   for ``k * rerank_factor`` candidates;
2. **fine**: exact f32 scoring of the shortlist (one small batched matmul)
   and final total-order top-k.

Coarse stages: ``"binary"`` (1 bit/dim), ``"ternary"`` (2 bits/dim),
``"u8"`` (8 bits/dim, asymmetric), ``"matryoshka"`` (f32 prefix dims).
Fine metric: ``"dot"`` (MIPS; use normalized vectors for cosine ranking).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu import scan
from innr_tpu.batch import BatchKnnResult
from innr_tpu.ops import binary as _binary
from innr_tpu.ops import scalar as _scalar
from innr_tpu.ops import ternary as _ternary
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.order import top_k_keys, top_k_total

__all__ = ["TwoStageIndex", "CoarseConfig"]


from functools import partial as _partial


def _rerank_core(rows, queries, cand, k):
    """Exact rerank of per-query shortlists: gather + batched matvec +
    total-order top-k. Traced inline by the fused one-launch searches and
    by :func:`_rerank_jit`."""
    from innr_tpu import config as _cfg

    shortlists = rows[cand]  # (Q, n_cand, D)
    fine = jnp.einsum(
        "qcd,qd->qc", shortlists, queries,
        preferred_element_type=jnp.float32,
        precision=_cfg.matmul_precision(),
    )
    vals, pos = top_k_total(fine, k, largest=True)
    return vals, jnp.take_along_axis(cand, pos, axis=1)


@_partial(jax.jit, static_argnames=("k",))
def _rerank_jit(rows, queries, cand, k):
    """Exact rerank of per-query shortlists in ONE launch: gather + batched
    matvec + total-order top-k (the fine stage fused into a single
    dispatch; per-dispatch latency dominates small reranks)."""
    return _rerank_core(rows, queries, cand, k)


# -- one-dispatch two-stage searches ----------------------------------------
#
# Coarse scan + exact rerank traced into ONE jitted computation, so a
# search_batch costs a single dispatch. ``route`` is the dense scan's route
# (:mod:`innr_tpu.route`) for the u8 and matryoshka coarse scans, resolved
# OUTSIDE the trace and passed static so a route change retraces.


@_partial(jax.jit, static_argnames=("k", "n_cand", "route"))
def _search_matryoshka_jit(queries, coarse, rows, k, n_cand, route):
    qp = queries[:, : coarse.shape[1]]
    _, cand = scan.knn_keys(qp, coarse, None, n_cand, "dot", route=route)
    return _rerank_core(rows, queries, cand, k)


@_partial(jax.jit, static_argnames=("k", "n_cand"))
def _search_binary_jit(queries, threshold, words, rows, k, n_cand):
    q_words = _binary.encode_binary_batch(queries, threshold)
    counts = jnp.sum(
        jax.lax.population_count(
            words[None, :, :] ^ q_words[:, None, :]
        ).astype(jnp.int32),
        axis=2,
    )
    _, cand = top_k_keys(-counts, n_cand)
    return _rerank_core(rows, queries, cand, k)


@_partial(jax.jit, static_argnames=("k", "n_cand"))
def _search_ternary_jit(queries, threshold, pos, neg, rows, k, n_cand):
    qp, qn = _ternary.encode_ternary_batch(queries, threshold)
    same = (qp[:, None, :] & pos[None, :, :]) | (qn[:, None, :] & neg[None, :, :])
    diff = (qp[:, None, :] & neg[None, :, :]) | (qn[:, None, :] & pos[None, :, :])
    dots = jnp.sum(
        jax.lax.population_count(same).astype(jnp.int32)
        - jax.lax.population_count(diff).astype(jnp.int32),
        axis=2,
    )
    _, cand = top_k_keys(dots, n_cand)
    return _rerank_core(rows, queries, cand, k)


@_partial(jax.jit, static_argnames=("k", "n_cand", "route"))
def _search_u8_jit(queries, codes, rows, k, n_cand, route):
    # Selection only needs the raw mixed dots: the affine correction
    # (alpha/255)*mixed + offset*sum(q) is per-query monotone (alpha > 0)
    # and cannot reorder candidates.
    _, cand = scan.knn_keys(queries, codes, None, n_cand, "dot", route=route)
    return _rerank_core(rows, queries, cand, k)


@dataclass(frozen=True)
class CoarseConfig:
    """Coarse-stage configuration.

    ``kind``: "binary" | "ternary" | "u8" | "matryoshka".
    ``threshold``: encode threshold for binary/ternary.
    ``prefix_dims``: prefix length for matryoshka.
    ``quantile``: u8 fit quantile (1.0 = plain min/max fit).
    """

    kind: str = "binary"
    threshold: float = 0.0
    prefix_dims: int = 128
    quantile: float = 1.0


class TwoStageIndex:
    """Coarse-quantized scan + exact f32 rerank over an (N, D) corpus."""

    def __init__(self, rows, coarse: CoarseConfig | str = "binary", rerank_factor: int = 4):
        if isinstance(coarse, str):
            coarse = CoarseConfig(kind=coarse)
        self.config = coarse
        self.rerank_factor = int(rerank_factor)
        if self.rerank_factor < 1:
            raise ContractError("TwoStageIndex: rerank_factor must be >= 1")
        rows = jnp.asarray(rows, dtype=jnp.float32)
        if rows.ndim != 2:
            raise ContractError("TwoStageIndex: rows must be 2-D (N, D)")
        self.rows = rows

        kind = coarse.kind
        if kind == "binary":
            self._coarse = _binary.PackedBinaryBatch.encode(rows, coarse.threshold)
        elif kind == "ternary":
            self._coarse = _ternary.PackedTernaryBatch.encode(rows, coarse.threshold)
        elif kind == "u8":
            self.params = (
                _scalar.QuantizationParams.fit(np.asarray(rows))
                if coarse.quantile >= 1.0
                else _scalar.QuantizationParams.fit_quantile(
                    np.asarray(rows), coarse.quantile
                )
            )
            self._coarse = _scalar.QuantizedU8Batch.quantize(rows, self.params)
        elif kind == "matryoshka":
            p = min(coarse.prefix_dims, int(rows.shape[1]))
            # The slice is already a materialized device array under JAX
            # (no views), so no copy idiom is needed.
            self._coarse = rows[:, :p]
        else:
            raise ContractError(f"TwoStageIndex: unknown coarse kind {kind!r}")

    @property
    def num_vectors(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.rows.shape[1])

    def memory_bytes(self) -> dict:
        """Per-representation memory accounting (the container
        ``memory_bytes`` discipline of the reference)."""
        fine = int(self.rows.size) * 4
        kind = self.config.kind
        if kind == "matryoshka":
            coarse = int(self._coarse.size) * 4
        else:
            coarse = self._coarse.memory_bytes()
        return {"fine_f32": fine, f"coarse_{kind}": coarse}

    # -- search ---------------------------------------------------------------

    def search(self, query, k: int) -> BatchKnnResult:
        """Top-k by exact dot product, shortlisted by the coarse stage.

        Returns a :class:`BatchKnnResult` (scores descending). Recall
        depends on the coarse representation and ``rerank_factor``; exact
        within the shortlist.
        """
        query = jnp.asarray(query, dtype=jnp.float32)
        if query.ndim != 1 or query.shape[0] != self.dimension:
            raise ContractError(
                f"TwoStageIndex.search: query shape {query.shape} != "
                f"dimension {self.dimension}"
            )
        if self.num_vectors == 0 or k == 0:
            return BatchKnnResult(
                indices=np.zeros((0,), np.int64),
                scores=np.zeros((0,), np.float32),
            )
        k = min(int(k), self.num_vectors)
        n_cand = min(k * self.rerank_factor, self.num_vectors)
        vals, idx = jax.device_get(self._search_fused(query[None, :], k, n_cand))
        return BatchKnnResult(
            indices=np.asarray(idx[0], dtype=np.int64),
            scores=np.asarray(vals[0], dtype=np.float32),
        )

    def _search_fused(self, queries: jax.Array, k: int, n_cand: int):
        """Coarse scan + exact rerank in ONE jitted dispatch; the coarse
        scan's route resolves OUTSIDE the trace."""
        kind = self.config.kind
        if kind in ("matryoshka", "u8"):
            coarse = self._coarse if kind == "matryoshka" else self._coarse.codes
            route = scan.dense_route(queries, coarse, n_cand)
            fn = _search_matryoshka_jit if kind == "matryoshka" else _search_u8_jit
            return fn(queries, coarse, self.rows, k, n_cand, route)
        c = self._coarse
        if kind == "binary":
            return _search_binary_jit(
                queries, jnp.float32(self.config.threshold), c.words,
                self.rows, k, n_cand,
            )
        # ternary (the ctor rejects every other kind)
        return _search_ternary_jit(
            queries, jnp.float32(self.config.threshold), c.pos, c.neg,
            self.rows, k, n_cand,
        )

    def search_batch(self, queries, k: int) -> BatchKnnResult:
        """Batched search: (Q, D) queries -> (Q, k) results.

        EVERY coarse kind (binary/ternary/u8/matryoshka) runs ONE
        multi-query scan for the shortlist — all queries share the
        compressed-corpus read — then all shortlists rerank in one
        batched gather+matmul, all in one dispatch.
        """
        queries = jnp.asarray(queries, dtype=jnp.float32)
        if queries.ndim != 2 or queries.shape[1] != self.dimension:
            raise ContractError(
                f"TwoStageIndex.search_batch: queries shape {queries.shape} "
                f"!= (Q, {self.dimension})"
            )
        n_q = int(queries.shape[0])
        if self.num_vectors == 0 or k == 0 or n_q == 0:
            return BatchKnnResult(
                indices=np.zeros((n_q, 0), np.int64),
                scores=np.zeros((n_q, 0), np.float32),
            )
        k = min(int(k), self.num_vectors)
        n_cand = min(k * self.rerank_factor, self.num_vectors)
        # One device_get fetches both arrays in a single transfer.
        vals, idx = jax.device_get(self._search_fused(queries, k, n_cand))
        return BatchKnnResult(
            indices=np.asarray(idx, dtype=np.int64),
            scores=np.asarray(vals, dtype=np.float32),
        )

    def recall_vs_exact(self, queries, k: int) -> float:
        """Measured recall@k against exact search — the runtime recall
        measurement the reference examples perform."""
        from innr_tpu.batch import VerticalBatch, batch_knn_dot

        vb = VerticalBatch(self.rows)
        queries = np.asarray(queries, dtype=np.float32)
        total = 0.0
        for q in queries:
            exact = set(batch_knn_dot(q, vb, k).indices.tolist())
            got = set(self.search(q, k).indices.tolist())
            total += len(exact & got) / max(len(exact), 1)
        return total / max(len(queries), 1)
