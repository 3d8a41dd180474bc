"""Ternary (1.58-bit) quantization: {-1, 0, +1} packed vectors.

Redesign of reference ``src/ternary.rs``. The reference interleaves two
bits per value inside u64 words (00=0, 01=+1, 10=-1) and extracts sign
planes with ODD/EVEN masks on every op (``src/ternary.rs:225-256``). Here
we store the two *bitplanes directly* — ``pos`` and ``neg`` uint32 word
arrays — which is the layout the extraction produces, so every op starts
where the reference's inner loop ends (survey-sanctioned layout change;
semantics identical). Compression is identical: 2 bits/value.

Inner product: ``popcount(same-sign) - popcount(diff-sign)``
(reference ``src/ternary.rs:198``). Hamming counts opposite-sign positions
(``:308``). ``asymmetric_dot`` scores an f32 query against the ternary doc
(``:293``); its batch form is two matmul-friendly masked reductions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.order import top_k_keys

__all__ = [
    "PackedTernary",
    "PackedTernaryBatch",
    "encode_ternary",
    "encode_ternary_batch",
    "ternary_dot",
    "ternary_hamming",
    "asymmetric_dot",
    "sparsity",
    "batch_ternary_dot",
    "batch_asymmetric_dot",
    "ternary_knn",
]

_WORD_BITS = 32


def _num_words(dimension: int) -> int:
    return -(-dimension // _WORD_BITS)


def _mask_padding(words: jax.Array, dimension: int) -> jax.Array:
    # rem != 0 implies dimension >= 1 implies >= 1 word (constructors
    # validate plane lengths), so no emptiness guard is needed.
    rem = dimension % _WORD_BITS
    if rem != 0:
        mask = np.uint32((1 << rem) - 1)
        words = words.at[..., -1].set(words[..., -1] & mask)
    return words


class PackedTernary:
    """Packed ternary vector as two uint32 bitplanes
    (reference ``src/ternary.rs:57``, layout redesigned for batched scans).

    ``pos`` bit set -> value +1; ``neg`` bit set -> value -1; neither -> 0.
    A bit must never be set in both planes (the reference's reserved ``11``
    pattern); constructors enforce this.
    """

    __slots__ = ("pos", "neg", "_dimension")

    def __init__(self, pos, neg, dimension: int):
        pos = jnp.asarray(pos, dtype=jnp.uint32)
        neg = jnp.asarray(neg, dtype=jnp.uint32)
        w = _num_words(dimension)
        if pos.shape != (w,) or neg.shape != (w,):
            raise ContractError(
                f"PackedTernary: plane lengths {pos.shape}/{neg.shape} don't "
                f"match dimension {dimension} (expected {w} words)"
            )
        pos = _mask_padding(pos, dimension)
        neg = _mask_padding(neg, dimension)
        if bool(jnp.any((pos & neg) != 0)):
            raise ContractError(
                "PackedTernary: a position is set in both planes "
                "(the reserved '11' pattern)"
            )
        self.pos = pos
        self.neg = neg
        self._dimension = int(dimension)

    @property
    def dimension(self) -> int:
        return self._dimension

    @classmethod
    def zeros(cls, dimension: int) -> "PackedTernary":
        w = _num_words(dimension)
        z = jnp.zeros((w,), dtype=jnp.uint32)
        return cls(z, z, dimension)

    @classmethod
    def from_interleaved_u64(cls, data, dimension: int) -> "PackedTernary":
        """Build from the reference's 2-bit-interleaved u64 words
        (bits ``2i..2i+2`` encode value i: 01=+1, 10=-1)."""
        words = np.asarray(data, dtype=np.uint64)
        vals = np.zeros(dimension, dtype=np.int8)
        for i in range(dimension):
            pair = (int(words[i // 32]) >> ((i % 32) * 2)) & 0b11
            vals[i] = 1 if pair == 0b01 else (-1 if pair == 0b10 else 0)
        return encode_ternary_values(vals)

    def data(self) -> tuple[jax.Array, jax.Array]:
        """Raw (pos, neg) bitplanes — the native serialization."""
        return self.pos, self.neg

    def to_interleaved_u64(self) -> np.ndarray:
        """Serialize to the reference's interleaved u64 layout
        (``src/ternary.rs:91``)."""
        pos = np.asarray(self.pos, dtype=np.uint64)
        neg = np.asarray(self.neg, dtype=np.uint64)
        out = np.zeros((-(-self._dimension // 32),), dtype=np.uint64)
        for i in range(self._dimension):
            w, b = i // _WORD_BITS, i % _WORD_BITS
            pair = 0
            if (int(pos[w]) >> b) & 1:
                pair = 0b01
            elif (int(neg[w]) >> b) & 1:
                pair = 0b10
            out[i // 32] |= np.uint64(pair) << np.uint64((i % 32) * 2)
        return out

    def set(self, idx: int, val: int) -> "PackedTernary":
        """Functional set (returns a new PackedTernary). Out-of-range
        indices are ignored, matching the reference. (Range written as
        one chained test: relaxing idx == dimension is unobservable —
        the constructor's padding mask scrubs the bit.)"""
        if not 0 <= idx < self._dimension:
            return self
        w, b = idx // _WORD_BITS, idx % _WORD_BITS
        bit = jnp.uint32(1 << b)
        clear = jnp.uint32(~(1 << b) & 0xFFFFFFFF)
        pos = self.pos.at[w].set(
            (self.pos[w] & clear) | (bit if val > 0 else jnp.uint32(0))
        )
        neg = self.neg.at[w].set(
            (self.neg[w] & clear) | (bit if val < 0 else jnp.uint32(0))
        )
        return PackedTernary(pos, neg, self._dimension)

    def get(self, idx: int) -> int:
        if idx >= self._dimension or idx < 0:
            return 0
        w, b = idx // _WORD_BITS, idx % _WORD_BITS
        if (int(self.pos[w]) >> b) & 1:
            return 1
        if (int(self.neg[w]) >> b) & 1:
            return -1
        return 0

    def nnz(self) -> int:
        nz = self.pos | self.neg
        return int(jnp.sum(jax.lax.population_count(nz).astype(jnp.int32)))

    def memory_bytes(self) -> int:
        """Backing storage: two uint32 planes (2 bits/value, same as the
        reference's interleaved u64s)."""
        return int(self.pos.shape[0] + self.neg.shape[0]) * 4

    def to_values(self) -> jax.Array:
        """Unpack to a (dimension,) int8 array of {-1, 0, +1}."""
        return (_unpack_plane(self.pos, self._dimension).astype(jnp.int8)
                - _unpack_plane(self.neg, self._dimension).astype(jnp.int8))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PackedTernary)
            and self._dimension == other._dimension
            and bool(jnp.all(self.pos == other.pos))
            and bool(jnp.all(self.neg == other.neg))
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"PackedTernary(dimension={self._dimension})"


def _pack_bits(bits: jax.Array) -> jax.Array:
    d = bits.shape[-1]
    w = _num_words(d)
    pad = w * _WORD_BITS - d
    if pad:
        bits = jnp.concatenate(
            [bits, jnp.zeros(bits.shape[:-1] + (pad,), dtype=bits.dtype)], axis=-1
        )
    grouped = bits.reshape(bits.shape[:-1] + (w, _WORD_BITS)).astype(jnp.uint32)
    shifts = jnp.arange(_WORD_BITS, dtype=jnp.uint32)
    return jnp.sum(grouped << shifts, axis=-1, dtype=jnp.uint32)


def _unpack_plane(words: jax.Array, dimension: int) -> jax.Array:
    """(.., W) uint32 words -> (.., dimension) {0,1} int32."""
    shifts = jnp.arange(_WORD_BITS, dtype=jnp.uint32)
    bits = (words[..., :, None] >> shifts) & jnp.uint32(1)
    flat = bits.reshape(bits.shape[:-2] + (-1,))
    return flat[..., :dimension].astype(jnp.int32)


def encode_ternary(values, threshold: float) -> PackedTernary:
    """Encode f32 values: ``> threshold`` -> +1, ``< -threshold`` -> -1,
    else 0 (reference ``src/ternary.rs:170``)."""
    values = jnp.asarray(values, dtype=jnp.float32)
    pos = _pack_bits(values > jnp.float32(threshold))
    neg = _pack_bits(values < -jnp.float32(threshold))
    return PackedTernary(pos, neg, int(values.shape[-1]))


def encode_ternary_values(values) -> PackedTernary:
    """Encode an int {-1, 0, +1} array directly."""
    values = jnp.asarray(values, dtype=jnp.int32)
    pos = _pack_bits(values > 0)
    neg = _pack_bits(values < 0)
    return PackedTernary(pos, neg, int(values.shape[-1]))


def encode_ternary_batch(rows, threshold: float) -> tuple[jax.Array, jax.Array]:
    """Encode an (N, D) corpus -> ((N, W) pos, (N, W) neg) uint32 planes —
    the batch encoder."""
    rows = jnp.asarray(rows, dtype=jnp.float32)
    return (
        _pack_bits(rows > jnp.float32(threshold)),
        _pack_bits(rows < -jnp.float32(threshold)),
    )


def _check_dims(a: PackedTernary, b: PackedTernary, op: str) -> None:
    if a.dimension != b.dimension:
        raise ContractError(
            f"innr_tpu::{op}: dimension mismatch ({a.dimension} vs {b.dimension})"
        )


def ternary_dot(a: PackedTernary, b: PackedTernary) -> jax.Array:
    """``popcount(same-sign) - popcount(diff-sign)``
    (reference ``src/ternary.rs:198``). Returns int32."""
    _check_dims(a, b, "ternary_dot")
    same = (a.pos & b.pos) | (a.neg & b.neg)
    diff = (a.pos & b.neg) | (a.neg & b.pos)
    return jnp.sum(
        jax.lax.population_count(same).astype(jnp.int32)
        - jax.lax.population_count(diff).astype(jnp.int32),
        dtype=jnp.int32,
    )


def ternary_hamming(a: PackedTernary, b: PackedTernary) -> jax.Array:
    """Count of positions where both are non-zero and signs differ
    (reference ``src/ternary.rs:308``)."""
    _check_dims(a, b, "ternary_hamming")
    diff = (a.pos & b.neg) | (a.neg & b.pos)
    return jnp.sum(
        jax.lax.population_count(diff).astype(jnp.int32), dtype=jnp.int32
    ).astype(jnp.uint32)


def asymmetric_dot(query, ternary: PackedTernary) -> jax.Array:
    """f32 query x ternary doc: full-precision rerank score
    (reference ``src/ternary.rs:293``).

    ``sum(q[i] * t[i]) = sum(q over +1 positions) - sum(q over -1)``:
    two masked reductions, no unpacked multiply.
    """
    query = jnp.asarray(query, dtype=jnp.float32)
    if query.shape[-1] != ternary.dimension:
        raise ContractError(
            f"innr_tpu::asymmetric_dot: dimension mismatch "
            f"({query.shape[-1]} vs {ternary.dimension})"
        )
    pos_mask = _unpack_plane(ternary.pos, ternary.dimension)
    neg_mask = _unpack_plane(ternary.neg, ternary.dimension)
    return jnp.sum(query * (pos_mask - neg_mask).astype(jnp.float32))


def sparsity(v: PackedTernary) -> float:
    """Fraction of zeros (reference ``src/ternary.rs:334``);
    zero-dimension -> 0.0."""
    if v.dimension == 0:
        return 0.0
    return 1.0 - v.nnz() / v.dimension


def batch_ternary_dot(query: PackedTernary, pos_corpus, neg_corpus) -> jax.Array:
    """Ternary dots of one query against an encoded corpus
    ((N, W) pos/neg planes) -> (N,) int32. One fused AND/OR + popcount
    pass."""
    pos_c = jnp.asarray(pos_corpus, dtype=jnp.uint32)
    neg_c = jnp.asarray(neg_corpus, dtype=jnp.uint32)
    qp, qn = query.pos[None, :], query.neg[None, :]
    same = (qp & pos_c) | (qn & neg_c)
    diff = (qp & neg_c) | (qn & pos_c)
    counts = jax.lax.population_count(same).astype(jnp.int32) - jax.lax.population_count(
        diff
    ).astype(jnp.int32)
    return jnp.sum(counts, axis=1, dtype=jnp.int32)


class PackedTernaryBatch:
    """An encoded ternary corpus: (N, W) pos/neg planes."""

    __slots__ = ("pos", "neg", "_dimension")

    def __init__(self, pos, neg, dimension: int):
        pos = jnp.asarray(pos, dtype=jnp.uint32)
        neg = jnp.asarray(neg, dtype=jnp.uint32)
        if pos.ndim != 2 or pos.shape != neg.shape or pos.shape[1] != _num_words(dimension):
            raise ContractError(
                f"PackedTernaryBatch: plane shapes {pos.shape}/{neg.shape} "
                f"don't match dimension {dimension}"
            )
        self.pos = _mask_padding(pos, dimension)
        self.neg = _mask_padding(neg, dimension)
        self._dimension = int(dimension)

    @classmethod
    def encode(cls, rows, threshold: float) -> "PackedTernaryBatch":
        rows = jnp.asarray(rows, dtype=jnp.float32)
        pos, neg = encode_ternary_batch(rows, threshold)
        return cls(pos, neg, int(rows.shape[1]))

    @property
    def num_vectors(self) -> int:
        return int(self.pos.shape[0])

    @property
    def dimension(self) -> int:
        return self._dimension

    def memory_bytes(self) -> int:
        return int(self.pos.size + self.neg.size) * 4


def ternary_knn(query: PackedTernary, corpus: PackedTernaryBatch, k: int):
    """Top-k largest ternary dots over an encoded corpus — the symmetric
    coarse stage of the ternary pipeline (reference examples/ternary_demo.rs).

    Returns ``(dots descending, indices)`` numpy arrays.
    """
    if query.dimension != corpus.dimension:
        raise ContractError(
            f"innr_tpu::ternary_knn: dimension mismatch "
            f"({query.dimension} vs {corpus.dimension})"
        )
    n = corpus.num_vectors
    if n == 0 or k == 0:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int64)
    k = min(int(k), n)
    dots, idx = _ternary_top_k(query.pos[None, :], query.neg[None, :],
                               corpus.pos, corpus.neg, k)
    return np.asarray(dots[0]), np.asarray(idx[0], dtype=np.int64)


def ternary_knn_batch(queries, corpus: PackedTernaryBatch, k: int):
    """Multi-query ternary kNN: one scan for a query batch.

    ``queries``: list of :class:`PackedTernary` or a
    :class:`PackedTernaryBatch`. Returns ``(dots (Q, k), indices (Q, k))``.
    """
    if isinstance(queries, PackedTernaryBatch):
        qp, qn = queries.pos, queries.neg
    elif isinstance(queries, tuple) and len(queries) == 2:
        # Raw ((Q, W) pos, (Q, W) neg) planes, e.g. from
        # :func:`encode_ternary_batch` — no container round-trip needed.
        qp = jnp.asarray(queries[0], dtype=jnp.uint32)
        qn = jnp.asarray(queries[1], dtype=jnp.uint32)
    else:
        qp = jnp.stack([q.pos for q in queries])
        qn = jnp.stack([q.neg for q in queries])
    if qp.ndim != 2 or qp.shape[1] != corpus.pos.shape[1]:
        raise ContractError(
            f"innr_tpu::ternary_knn_batch: query planes {qp.shape} don't "
            f"match corpus word count {corpus.pos.shape[1]}"
        )
    n = corpus.num_vectors
    if n == 0 or k == 0:
        n_q = int(qp.shape[0])
        return np.zeros((n_q, 0), np.int32), np.zeros((n_q, 0), np.int64)
    k = min(int(k), n)
    dots, idx = _ternary_top_k(qp, qn, corpus.pos, corpus.neg, k)
    return np.asarray(dots), np.asarray(idx, dtype=np.int64)


@functools.partial(jax.jit, static_argnames=("k",))
def _ternary_top_k(qp, qn, pos, neg, k: int):
    """(Q, W) query planes x (N, W) corpus planes -> the k largest
    ternary dots per query and their rows, in one jitted program (one
    fused AND/OR + popcount reduction over the corpus)."""
    same = (qp[:, None, :] & pos[None, :, :]) | (qn[:, None, :] & neg[None, :, :])
    diff = (qp[:, None, :] & neg[None, :, :]) | (qn[:, None, :] & pos[None, :, :])
    dots = jnp.sum(
        jax.lax.population_count(same).astype(jnp.int32)
        - jax.lax.population_count(diff).astype(jnp.int32),
        axis=2,
    )
    return top_k_keys(dots, k)


def batch_asymmetric_dot(query, pos_corpus, neg_corpus, dimension: int) -> jax.Array:
    """f32 query x encoded ternary corpus -> (N,) f32 rerank scores.

    Unpacks the corpus planes to a {-1,0,+1} matrix on-chip and scores with
    one matvec — HBM traffic stays at 2 bits/value.
    """
    query = jnp.asarray(query, dtype=jnp.float32)
    pos_m = _unpack_plane(jnp.asarray(pos_corpus, dtype=jnp.uint32), dimension)
    neg_m = _unpack_plane(jnp.asarray(neg_corpus, dtype=jnp.uint32), dimension)
    signs = (pos_m - neg_m).astype(jnp.float32)
    from innr_tpu import config
    return jnp.matmul(
        signs, query,
        preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )
