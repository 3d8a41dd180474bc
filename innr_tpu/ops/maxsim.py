"""ColBERT MaxSim late interaction.

Redesign of reference ``src/maxsim.rs``. The reference runs an
O(|Q| x |D|) doubly nested dot loop with per-ISA kernels
(``src/arch/x86_64.rs:119-143``); the survey's own optimization note
("block into matrix-vector form") *is* the design here: the whole stack
collapses to one matmul ``Q @ D^T`` followed by a row-max and a sum —
two reductions fused onto the matmul output.

Contracts (reference ``src/maxsim.rs:96-110``): empty query or doc -> 0.0;
all tokens must share one dimension (raises); NOT commutative — the first
argument is always the query.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu.config import NORM_EPSILON
from innr_tpu.utils.asserts import ContractError

__all__ = [
    "maxsim",
    "maxsim_cosine",
    "batch_maxsim",
    "maxsim_knn",
    "maxsim_knn_batch",
]


def _tokens_2d(tokens, name: str) -> jax.Array:
    """Coerce a token list / 2-D array into (T, D) f32, checking ragged
    inputs (the reference's shared-dimension assert)."""
    if isinstance(tokens, (jnp.ndarray, np.ndarray)):
        if tokens.ndim != 2:
            raise ContractError(
                f"innr_tpu::maxsim: {name} tokens must be a (T, D) array "
                f"or a list of equal-length vectors, got ndim={tokens.ndim}"
            )
        return jnp.asarray(tokens, dtype=jnp.float32)
    toks = list(tokens)
    if not toks:
        return jnp.zeros((0, 0), dtype=jnp.float32)
    dim = len(toks[0])
    for t in toks:
        if len(t) != dim:
            raise ContractError(f"dimension mismatch ({name})")
    return jnp.asarray(np.asarray(toks, dtype=np.float32))


@jax.jit
def _maxsim_dot(q: jax.Array, d: jax.Array) -> jax.Array:
    from innr_tpu import config
    scores = jnp.matmul(
        q, d.T,
        preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )
    return jnp.sum(jnp.max(scores, axis=1))


@jax.jit
def _maxsim_cosine(q: jax.Array, d: jax.Array) -> jax.Array:
    def unit(rows):
        n = jnp.sqrt(jnp.sum(rows * rows, axis=1, keepdims=True))
        ok = n > NORM_EPSILON
        # Zero/NaN-norm rows become zero rows -> every pair cosine is 0.0,
        # matching the reference's per-pair zero-norm guard.
        return jnp.where(ok, rows / jnp.where(ok, n, 1.0), 0.0)

    from innr_tpu import config
    scores = jnp.matmul(
        unit(q), unit(d).T,
        preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )
    return jnp.sum(jnp.max(scores, axis=1))


def maxsim(query_tokens, doc_tokens) -> jax.Array:
    """``MaxSim(Q, D) = sum_i max_j (q_i . d_j)``
    (reference ``src/maxsim.rs:96``).

    Inputs: (Tq, D) and (Td, D) arrays, or lists of equal-length vectors.
    One matmul + row-max + sum. Returns 0.0 if either side is empty.
    """
    q = _tokens_2d(query_tokens, "query")
    d = _tokens_2d(doc_tokens, "doc")
    if q.shape[0] == 0 or d.shape[0] == 0:
        return jnp.float32(0.0)
    if q.shape[1] != d.shape[1]:
        raise ContractError(
            f"innr_tpu::maxsim: dimension mismatch ({q.shape[1]} vs {d.shape[1]})"
        )
    return _maxsim_dot(q, d)


def maxsim_cosine(query_tokens, doc_tokens) -> jax.Array:
    """MaxSim with cosine similarity per token pair
    (reference ``src/maxsim.rs:168``): rows are unit-normalized (zero-norm
    rows pinned to zero), then the same matmul + row-max + sum."""
    q = _tokens_2d(query_tokens, "query")
    d = _tokens_2d(doc_tokens, "doc")
    if q.shape[0] == 0 or d.shape[0] == 0:
        return jnp.float32(0.0)
    if q.shape[1] != d.shape[1]:
        raise ContractError(
            f"innr_tpu::maxsim_cosine: dimension mismatch "
            f"({q.shape[1]} vs {d.shape[1]})"
        )
    return _maxsim_cosine(q, d)


@jax.jit
def batch_maxsim(queries: jax.Array, docs: jax.Array, doc_mask=None, query_mask=None) -> jax.Array:
    """MaxSim of a batch of queries against a batch of docs — the serving
    shape the reference cannot express.

    ``queries``: (Q, Tq, D); ``docs``: (N, Td, D). Returns (Q, N) scores in
    one einsum: ``scores[q, n] = sum_i max_j queries[q, i] . docs[n, j]``.

    Ragged token counts pad to rectangles; pass boolean masks to exclude
    the padding exactly: ``doc_mask`` (N, Td) pins masked doc tokens to
    -inf before the row-max (safe for signed scores), ``query_mask``
    (Q, Tq) drops masked query tokens from the sum.
    """
    queries = jnp.asarray(queries, dtype=jnp.float32)
    docs = jnp.asarray(docs, dtype=jnp.float32)
    from innr_tpu import config
    pair = jnp.einsum(
        "qtd,nsd->qnts", queries, docs,
        preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )
    if doc_mask is not None:
        doc_mask = jnp.asarray(doc_mask, dtype=bool)
        pair = jnp.where(doc_mask[None, :, None, :], pair, -jnp.inf)
    best = jnp.max(pair, axis=3)  # (Q, N, Tq)
    if doc_mask is not None:
        # A fully-masked doc leaves -inf bests; clamp those to 0.0 (the
        # empty-doc -> 0.0 contract). Genuine
        # NaN/+inf scores still propagate.
        best = jnp.where(best == -jnp.inf, 0.0, best)
    if query_mask is not None:
        query_mask = jnp.asarray(query_mask, dtype=bool)
        best = jnp.where(query_mask[:, None, :], best, 0.0)
    return jnp.sum(best, axis=2)


def maxsim_knn(query_tokens, doc_corpus, k: int, doc_mask=None):
    """Top-k documents by MaxSim over an (N, Td, D) multi-vector corpus —
    ColBERT-style late-interaction *retrieval*, not just pairwise scoring.

    Scores the corpus with the batched einsum of :func:`batch_maxsim`
    (XLA fuses the max and the sum into the contraction's consumer).
    ``doc_mask`` (N, Td) excludes padded doc tokens exactly. Returns
    ``(scores descending, indices)`` numpy arrays.
    """
    q = _tokens_2d(query_tokens, "query")
    docs = jnp.asarray(doc_corpus, dtype=jnp.float32)
    if docs.ndim != 3 or docs.shape[2] != q.shape[1]:
        raise ContractError(
            f"innr_tpu::maxsim_knn: corpus shape {docs.shape} incompatible "
            f"with query dim {q.shape[1]}"
        )
    n = int(docs.shape[0])
    if n == 0 or k == 0 or q.shape[0] == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
    k = min(int(k), n)
    from innr_tpu.utils.order import top_k_total

    scores = batch_maxsim(q[None], docs, doc_mask=doc_mask)[0]
    vals, idx = top_k_total(scores, k, largest=True)
    return np.asarray(vals), np.asarray(idx, dtype=np.int64)


def maxsim_knn_batch(query_batch, doc_corpus, k: int, doc_mask=None):
    """Top-k documents by MaxSim for a (B, Tq, D) query batch — all B
    queries share one einsum over the (N, Td, D) corpus (the multi-query
    serving shape).

    Ragged queries zero-pad to the Tq rectangle exactly: a zero query
    token's best interaction is 0, contributing nothing to the sum.
    Returns ``(scores (B, k) descending, indices (B, k))`` numpy arrays.
    """
    qs = jnp.asarray(query_batch, dtype=jnp.float32)
    docs = jnp.asarray(doc_corpus, dtype=jnp.float32)
    if qs.ndim != 3 or docs.ndim != 3 or docs.shape[2] != qs.shape[2]:
        raise ContractError(
            f"innr_tpu::maxsim_knn_batch: query batch {qs.shape} incompatible "
            f"with corpus {docs.shape}"
        )
    b, n = int(qs.shape[0]), int(docs.shape[0])
    if n == 0 or k == 0 or qs.shape[1] == 0 or b == 0:
        return np.zeros((b, 0), np.float32), np.zeros((b, 0), np.int64)
    k = min(int(k), n)
    from innr_tpu.utils.order import top_k_total

    scores = batch_maxsim(qs, docs, doc_mask=doc_mask)
    vals, idx = top_k_total(scores, k, largest=True)
    return np.asarray(vals), np.asarray(idx, dtype=np.int64)
