"""Sparse vector ops (positional API): sorted-index dot and sparse MaxSim.

Redesign of reference ``src/sparse.rs``. The reference's merge-join is a
two-pointer scalar loop — unvectorizable on an accelerator. The batched form
is a *binary-search join*: for each index of ``a``, ``searchsorted`` into ``b``
(O(|a| log |b|) fully parallel elementwise work), gather, and mask-accumulate.
Semantically identical for sorted inputs (duplicate indices match the first
occurrence; the reference pairs duplicates one-to-one — documented below).

Zero-padding is the batching story: padded entries carry the sentinel
index ``0xFFFFFFFF`` and value 0.0, contributing nothing, so token batches
of ragged sparse vectors become rectangular arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu.utils.asserts import ContractError

__all__ = [
    "sparse_dot",
    "sparse_maxsim",
    "SENTINEL_INDEX",
    "pad_sparse",
    "pad_sparse_docs",
    "SparseCorpus",
    "sparse_knn",
    "sparse_knn_batch",
    "sparse_maxsim_batch",
    "sparse_maxsim_knn",
]

# Index value used for padded (inactive) entries.
SENTINEL_INDEX = np.uint32(0xFFFFFFFF)


def _check_pair(indices, values, name: str):
    indices = jnp.asarray(indices, dtype=jnp.uint32)
    values = jnp.asarray(values, dtype=jnp.float32)
    if indices.shape[-1] != values.shape[-1]:
        raise ContractError(
            f"sparse_dot: {name} indices/values length mismatch "
            f"({indices.shape[-1]} vs {values.shape[-1]})"
        )
    return indices, values


def _sparse_dot_arrays(a_idx, a_val, b_idx, b_val) -> jax.Array:
    """Binary-search join; assumes both index arrays sorted ascending.
    Padded sentinel entries have value 0 and never contribute."""
    if a_idx.shape[-1] == 0 or b_idx.shape[-1] == 0:
        return jnp.float32(0.0)
    pos = jnp.searchsorted(b_idx, a_idx)
    pos_c = jnp.clip(pos, 0, b_idx.shape[-1] - 1)
    matched = b_idx[pos_c] == a_idx
    return jnp.sum(jnp.where(matched, a_val * b_val[pos_c], 0.0))


def sparse_dot(a_indices, a_values, b_indices, b_values) -> jax.Array:
    """Sparse dot over sorted (indices, values) pairs
    (reference ``src/sparse.rs:50``).

    Indices must be sorted ascending. With duplicate indices the join
    matches the first occurrence in ``b`` (the reference's two-pointer walk
    pairs duplicates positionally; well-formed sparse vectors have unique
    indices, where both agree exactly).
    """
    a_idx, a_val = _check_pair(a_indices, a_values, "a")
    b_idx, b_val = _check_pair(b_indices, b_values, "b")
    return _sparse_dot_arrays(a_idx, a_val, b_idx, b_val)


def pad_sparse(tokens, width: int | None = None) -> tuple[jax.Array, jax.Array]:
    """Pad a list of (indices, values) sparse vectors to a rectangular
    ``(T, width)`` pair of arrays using the sentinel index and 0.0 values —
    the batching layout for :func:`sparse_maxsim`."""
    tokens = [
        (np.asarray(i, dtype=np.uint32), np.asarray(v, dtype=np.float32))
        for i, v in tokens
    ]
    if width is None:
        width = max((i.size for i, _ in tokens), default=0)
    width = max(int(width), 1)
    n = len(tokens)
    idx = np.full((n, width), SENTINEL_INDEX, dtype=np.uint32)
    val = np.zeros((n, width), dtype=np.float32)
    for t, (ti, tv) in enumerate(tokens):
        if ti.size > width:
            raise ContractError(
                f"pad_sparse: token {t} has {ti.size} entries > width {width}"
            )
        idx[t, : ti.size] = ti
        val[t, : ti.size] = tv
    return jnp.asarray(idx), jnp.asarray(val)


def _as_padded_pair(obj):
    """Return ``(idx, val)`` if ``obj`` is a genuinely pre-padded
    ``((N, L) idx, (N, L) val)`` tuple, else ``None``.

    Disambiguation matters: a tuple of exactly two ``(indices, values)``
    document pairs must NOT be misread as a padded pair (each element is
    itself a pair, not a 2-D array) — it falls through to the doc-list
    path instead of silently producing garbage.
    """
    if not (isinstance(obj, tuple) and len(obj) == 2):
        return None
    a, b = obj
    if isinstance(a, (tuple, list)) or isinstance(b, (tuple, list)):
        return None  # elements are themselves pairs -> a 2-doc list
    idx = jnp.asarray(a)
    val = jnp.asarray(b)
    if idx.ndim != 2:
        return None
    if idx.shape != val.shape:
        raise ContractError(
            f"sparse corpus/queries: padded arrays must be matching 2-D, "
            f"got {idx.shape} / {val.shape}"
        )
    return jnp.asarray(idx, dtype=jnp.uint32), jnp.asarray(val, dtype=jnp.float32)


class SparseCorpus:
    """N sparse documents padded rectangular: (N, L) sorted uint32 indices
    (sentinel-padded) + (N, L) f32 values.

    Corpus-scale retrieval over sparse vectors (SPLADE/BM25-style learned
    sparse embeddings). The reference ships only the pairwise primitives
    (``src/sparse.rs``); this is their batch form: ragged docs become
    rectangular sentinel-padded arrays (``pad_sparse``), and a scan is a
    vectorized binary-search join of the query into every document row —
    O(N L log Lq) fully parallel elementwise work, no vocabulary-sized dense
    scatter, so 32-bit hashed index spaces work unchanged.
    """

    def __init__(self, docs, width: int | None = None):
        """``docs``: list of ``(indices, values)`` pairs (sorted ascending,
        unique indices) or a pre-padded ``((N, L) idx, (N, L) val)`` tuple."""
        pair = _as_padded_pair(docs)
        if pair is not None:
            idx, val = pair
        else:
            idx, val = pad_sparse(docs, width)
        self.indices = idx
        self.values = val

    @property
    def num_docs(self) -> int:
        return int(self.indices.shape[0])

    @property
    def width(self) -> int:
        return int(self.indices.shape[1])

    def memory_bytes(self) -> int:
        return int(self.indices.size) * 8  # u32 index + f32 value per entry

    def knn(self, query, k: int):
        """Top-k largest sparse dots of one ``(indices, values)`` query."""
        return sparse_knn(query, self, k)

    def knn_batch(self, queries, k: int):
        """Multi-query: padded ``((Q, W) idx, (Q, W) val)`` pair or list of
        ``(indices, values)`` pairs."""
        return sparse_knn_batch(queries, self, k)


def _join_scores(q_idx, q_val, idx_any, val_any) -> jax.Array:
    """Join one sorted (Lq,) query into index/value arrays of ANY leading
    shape; dot over the last axis.

    The scan-scale form of the binary-search join: every corpus entry
    searches into the TINY sorted query (log2 Lq broadcasted compare
    steps over the whole corpus at once) instead of vmapping a per-row
    search of the query into each document — the latter lowers to ~1M
    tiny gathers. Duplicate indices match the first
    occurrence in the QUERY (identical for well-formed unique-index
    inputs); sentinel-padded entries carry value 0 and never contribute.
    """
    lq = q_idx.shape[-1]
    if lq == 0 or idx_any.shape[-1] == 0:
        return jnp.zeros(idx_any.shape[:-1], jnp.float32)
    pos = jnp.clip(jnp.searchsorted(q_idx, idx_any), 0, lq - 1)
    matched = q_idx[pos] == idx_any
    return jnp.sum(jnp.where(matched, val_any * q_val[pos], 0.0), axis=-1)


def _corpus_scores(q_idx, q_val, c_idx, c_val) -> jax.Array:
    """(Lq,) query joined into every (N, L) doc row -> (N,) dots."""
    return _join_scores(q_idx, q_val, c_idx, c_val)


def _query_pair(query, name: str):
    if not (isinstance(query, tuple) and len(query) == 2):
        raise ContractError(f"{name}: query must be an (indices, values) pair")
    return _check_pair(query[0], query[1], "query")


def sparse_knn(query, corpus: SparseCorpus, k: int):
    """Top-k documents by sparse dot product (descending, IEEE total
    order). ``query``: an ``(indices, values)`` pair, indices sorted
    ascending. Returns ``(scores, indices)`` jnp arrays.
    """
    q_idx, q_val = _query_pair(query, "sparse_knn")
    n = corpus.num_docs
    if n == 0 or k <= 0:
        return jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.int32)
    k = min(int(k), n)
    return _sparse_top_k(q_idx[None], q_val[None], corpus.indices,
                         corpus.values, k, squeeze=True)


def sparse_knn_batch(queries, corpus: SparseCorpus, k: int):
    """Multi-query sparse retrieval: (Q, W) padded query pair (or a list
    of ``(indices, values)`` pairs) -> ``(scores (Q, k), indices (Q, k))``."""
    pair = _as_padded_pair(queries)
    if pair is not None:
        q_idx, q_val = pair
    else:
        q_idx, q_val = pad_sparse(queries)
    n = corpus.num_docs
    n_q = int(q_idx.shape[0])
    if n == 0 or k <= 0:
        return jnp.zeros((n_q, 0), jnp.float32), jnp.zeros((n_q, 0), jnp.int32)
    k = min(int(k), n)
    if n_q == 0:
        return jnp.zeros((0, k), jnp.float32), jnp.zeros((0, k), jnp.int32)
    return _sparse_top_k(q_idx, q_val, corpus.indices, corpus.values, k)


@functools.partial(jax.jit, static_argnames=("k", "squeeze"))
def _sparse_top_k(q_idx, q_val, c_idx, c_val, k: int, squeeze: bool = False):
    """(Q, Lq) sorted padded queries joined into every (N, L) doc row,
    then top-k per query, in one jitted program. A static loop over the
    queries: vmap over searchsorted's sorted side de-vectorizes the join
    (see _corpus_maxsim_scores)."""
    from innr_tpu.utils.order import top_k_total

    scores = jnp.stack([_corpus_scores(q_idx[qi], q_val[qi], c_idx, c_val)
                        for qi in range(q_idx.shape[0])])  # (Q, N)
    if squeeze:
        scores = scores[0]
    return top_k_total(scores, k, largest=True)


def sparse_maxsim(query_tokens, doc_tokens) -> jax.Array:
    """SPLADE-style late interaction over sparse token vectors
    (reference ``src/sparse.rs:119``).

    ``sum_i max_j sparse_dot(q_i, d_j)``. Inputs are lists of
    ``(indices, values)`` pairs (reference-shaped) or pre-padded
    ``(T, W)`` array pairs from :func:`pad_sparse`. Empty query or doc
    -> 0.0. The max starts from -inf, so all-negative overlaps keep the
    least-negative value, as in the reference.
    """
    if isinstance(query_tokens, tuple) and len(query_tokens) == 2:
        q_idx, q_val = query_tokens
    else:
        if len(query_tokens) == 0:
            return jnp.float32(0.0)
        q_idx, q_val = pad_sparse(query_tokens)
    if isinstance(doc_tokens, tuple) and len(doc_tokens) == 2:
        d_idx, d_val = doc_tokens
    else:
        if len(doc_tokens) == 0:
            return jnp.float32(0.0)
        d_idx, d_val = pad_sparse(doc_tokens)
    q_idx, q_val = jnp.asarray(q_idx), jnp.asarray(q_val)
    d_idx, d_val = jnp.asarray(d_idx), jnp.asarray(d_val)
    if q_idx.shape[0] == 0 or d_idx.shape[0] == 0:
        return jnp.float32(0.0)

    # Static loop over query tokens with the scan-scale join (a nested
    # vmap de-vectorizes searchsorted; see _corpus_maxsim_scores).
    total = jnp.float32(0.0)
    for i in range(q_idx.shape[0]):
        pair = _join_scores(q_idx[i], q_val[i], d_idx, d_val)  # (Td,)
        total = total + jnp.max(pair)
    return total


def pad_sparse_docs(docs, width: int | None = None, tokens: int | None = None):
    """Pad a list of sparse multi-vector documents (each a list of
    ``(indices, values)`` token pairs) to rectangular arrays:
    ``((N, T, W) idx, (N, T, W) val, (N, T) token_mask)``. Padded entries
    use the sentinel index / 0.0; padded TOKENS are marked False in the
    mask (a zero-valued pad token still dots to 0.0, which must not win a
    max over genuinely negative scores)."""
    n = len(docs)
    padded = [
        pad_sparse(d, width) if len(d) else
        (jnp.full((0, 1), SENTINEL_INDEX, jnp.uint32), jnp.zeros((0, 1), jnp.float32))
        for d in docs
    ]
    t_max = max((int(p[0].shape[0]) for p in padded), default=0)
    w_max = max((int(p[0].shape[1]) for p in padded), default=1)
    if tokens is not None:
        if t_max > tokens:
            raise ContractError(
                f"pad_sparse_docs: a doc has {t_max} tokens > tokens={tokens}"
            )
        t_max = tokens
    t_max = max(t_max, 1)
    if width is not None:
        w_max = max(int(width), w_max)
    idx = np.full((n, t_max, w_max), SENTINEL_INDEX, np.uint32)
    val = np.zeros((n, t_max, w_max), np.float32)
    mask = np.zeros((n, t_max), bool)
    for di, (pi, pv) in enumerate(padded):
        t, w = pi.shape
        idx[di, :t, :w] = np.asarray(pi)
        val[di, :t, :w] = np.asarray(pv)
        mask[di, :t] = True
    return jnp.asarray(idx), jnp.asarray(val), jnp.asarray(mask)


def _corpus_maxsim_scores(q_idx2, q_val2, d_idx, d_val, d_tok_mask) -> jax.Array:
    """MaxSim of one padded (Tq, Wq) query against a padded CORPUS
    ``(N, Td, W)`` of documents -> (N,) scores: ``sum_i max_j
    sparse_dot(q_i, d_j)`` per doc, padded doc tokens excluded from the
    max, fully-masked (empty) docs scoring 0.0.

    The only iterated axis is the small static query-token one — each
    query token scan-joins the ENTIRE corpus token block in one
    vectorized pass. The iteration is a PYTHON loop, deliberately:
    ``jax.vmap`` over the *sorted* side of ``searchsorted`` de-vectorizes
    the search; XLA fuses the unrolled loop's independent passes."""
    neg_inf = jnp.float32(-jnp.inf)
    total = None
    for i in range(q_idx2.shape[0]):
        pair = _join_scores(q_idx2[i], q_val2[i], d_idx, d_val)  # (N, Td)
        pair = jnp.where(d_tok_mask, pair, neg_inf)
        best = jnp.max(pair, axis=1)  # (N,)
        # Only a fully-masked doc produces -inf (token dots are finite).
        best = jnp.where(jnp.isneginf(best), 0.0, best)
        total = best if total is None else total + best
    if total is None:
        return jnp.zeros((d_idx.shape[0],), jnp.float32)
    return total


def _parse_query_tokens(query_tokens):
    """Parse a sparse multi-vector query into a padded ``(Tq, W)`` pair.

    Accepts a list of ``(indices, values)`` token pairs, a pre-padded
    ``(Tq, W)`` array pair, or a single 1-D ``(indices, values)`` pair
    (lifted to one token). An empty query parses to ``(0, 1)`` arrays —
    callers get the empty-query contract (every doc scores 0.0) by
    passing them through, not by special-casing.
    """
    if isinstance(query_tokens, tuple) and len(query_tokens) == 2 and not (
        isinstance(query_tokens[0], (tuple, list))
    ):
        q_idx = jnp.asarray(query_tokens[0], dtype=jnp.uint32)
        q_val = jnp.asarray(query_tokens[1], dtype=jnp.float32)
        if q_idx.shape != q_val.shape or q_idx.ndim not in (1, 2):
            raise ContractError(
                f"sparse maxsim: query indices/values must be matching 1-D "
                f"or 2-D arrays, got {q_idx.shape} / {q_val.shape}"
            )
        if q_idx.ndim == 1:
            q_idx, q_val = q_idx[None, :], q_val[None, :]
        return q_idx, q_val
    return pad_sparse(query_tokens)


def sparse_maxsim_batch(query_tokens, docs) -> jax.Array:
    """SPLADE-style late interaction of one sparse multi-vector query
    against a CORPUS of sparse multi-vector documents -> (N,) scores.

    The corpus batch form of :func:`sparse_maxsim` (the reference is
    pairwise, ``src/sparse.rs:119``): documents pad rectangular
    (``pad_sparse_docs``) and every document shares one vectorized scan.
    ``query_tokens``: list of ``(indices, values)`` pairs or a padded
    ``(Tq, W)`` pair. ``docs``: list of documents or a pre-padded
    ``(idx, val, token_mask)`` triple. Empty query or empty corpus ->
    zeros; an empty document scores 0.0 (reference contract).
    """
    q_idx, q_val = _parse_query_tokens(query_tokens)
    if isinstance(docs, tuple) and len(docs) == 3:
        d_idx, d_val, d_mask = (
            jnp.asarray(docs[0], dtype=jnp.uint32),
            jnp.asarray(docs[1], dtype=jnp.float32),
            jnp.asarray(docs[2], dtype=bool),
        )
    else:
        d_idx, d_val, d_mask = pad_sparse_docs(docs)
    if int(d_idx.shape[0]) == 0 or q_idx.shape[0] == 0:
        return jnp.zeros((int(d_idx.shape[0]),), jnp.float32)
    return _corpus_maxsim_scores(q_idx, q_val, d_idx, d_val, d_mask)


def sparse_maxsim_knn(query_tokens, docs, k: int):
    """Top-k documents by sparse MaxSim (descending, IEEE total order).

    Returns ``(scores, indices)``. See :func:`sparse_maxsim_batch` for
    input forms.
    """
    scores = sparse_maxsim_batch(query_tokens, docs)
    n = int(scores.shape[0])
    if n == 0 or k <= 0:
        return jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.int32)
    from innr_tpu.utils.order import top_k_total

    return top_k_total(scores, min(int(k), n), largest=True)
