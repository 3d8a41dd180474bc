"""Binary (1-bit) quantization: encode, Hamming, dot, Jaccard.

Redesign of reference ``src/binary.rs``. Semantics are identical; the
packed *layout* is uint32 words (bit ``i % 32`` of word ``i // 32``) instead
of the reference's u64 words, because JAX's default integers are 32-bit.
Compression is the same 32x vs f32; ``data_u64()`` round-trips the
reference's serialization format.

Ops are XOR/AND/OR + native popcount (``lax.population_count``), the analog
of the reference's ``count_ones`` loops (``src/binary.rs:154-210``) and the
SIMD byte path in ``quant::hamming_distance``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.order import top_k_keys

__all__ = [
    "PackedBinary",
    "PackedBinaryBatch",
    "encode_binary",
    "encode_binary_batch",
    "binary_hamming",
    "binary_dot",
    "binary_jaccard",
    "batch_binary_hamming",
    "binary_knn",
]

_WORD_BITS = 32


def _num_words(dimension: int) -> int:
    return -(-dimension // _WORD_BITS)


def _mask_padding(words: jax.Array, dimension: int) -> jax.Array:
    """Zero padding bits past ``dimension``: distance ops popcount whole
    words (reference ``src/binary.rs:59-66``)."""
    # rem != 0 implies dimension >= 1 implies >= 1 word: every caller
    # passes a (words, dimension) pair whose word count the constructors
    # validate, so no emptiness guard is needed.
    rem = dimension % _WORD_BITS
    if rem != 0:
        mask = np.uint32((1 << rem) - 1)
        words = words.at[..., -1].set(words[..., -1] & mask)
    return words


class PackedBinary:
    """Packed binary vector: uint32 words, 32 values per word
    (reference ``src/binary.rs:37``)."""

    __slots__ = ("words", "_dimension")

    def __init__(self, words, dimension: int):
        words = jnp.asarray(words, dtype=jnp.uint32)
        if words.shape != (_num_words(dimension),):
            raise ContractError(
                f"PackedBinary: data length {words.shape} doesn't match "
                f"dimension {dimension} (expected {_num_words(dimension)} words)"
            )
        self.words = _mask_padding(words, dimension)
        self._dimension = int(dimension)

    # Reference constructor name.
    new = __init__

    @property
    def dimension(self) -> int:
        return self._dimension

    @classmethod
    def zeros(cls, dimension: int) -> "PackedBinary":
        return cls(jnp.zeros((_num_words(dimension),), dtype=jnp.uint32), dimension)

    def data(self) -> jax.Array:
        """Raw packed uint32 words (device layout)."""
        return self.words

    def data_u64(self) -> np.ndarray:
        """Words re-packed as u64 little-endian — the reference's
        serialization layout (``src/binary.rs:71``)."""
        w = np.asarray(self.words, dtype=np.uint32)
        padded = np.zeros((round(-(-w.size // 2)) * 2,), dtype=np.uint32)
        padded[: w.size] = w
        return padded.view(np.uint64)

    @classmethod
    def from_u64(cls, data, dimension: int) -> "PackedBinary":
        """Build from the reference's u64-word layout."""
        w = np.asarray(data, dtype=np.uint64).view(np.uint32)
        return cls(w[: _num_words(dimension)], dimension)

    def set(self, idx: int, val: bool) -> "PackedBinary":
        """Functional set: returns a new PackedBinary (JAX arrays are
        immutable). Out-of-range indices are ignored, as in the reference."""
        # Chained range test: any relaxation toward idx == dimension is
        # unobservable anyway (the constructor's padding mask scrubs the
        # bit for ragged dims; the scatter drops OOB words for full
        # ones), so the bound is written as one range, not two compares.
        if not 0 <= idx < self._dimension:
            return self
        word, bit = idx // _WORD_BITS, idx % _WORD_BITS
        w = self.words
        if val:
            w = w.at[word].set(w[word] | jnp.uint32(1 << bit))
        else:
            w = w.at[word].set(w[word] & jnp.uint32(~(1 << bit) & 0xFFFFFFFF))
        return PackedBinary(w, self._dimension)

    def get(self, idx: int) -> bool:
        if idx >= self._dimension or idx < 0:
            return False
        word, bit = idx // _WORD_BITS, idx % _WORD_BITS
        return bool((int(self.words[word]) >> bit) & 1)

    def count_ones(self) -> int:
        return int(jnp.sum(jax.lax.population_count(self.words).astype(jnp.int32)))

    def memory_bytes(self) -> int:
        """Backing storage size (4 bytes per uint32 word)."""
        return int(self.words.shape[0]) * 4

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PackedBinary)
            and self._dimension == other._dimension
            and bool(jnp.all(self.words == other.words))
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"PackedBinary(dimension={self._dimension})"


def _pack_bits(bits: jax.Array) -> jax.Array:
    """Pack a (..., D) boolean array into (..., ceil(D/32)) uint32 words."""
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


def encode_binary(values, threshold: float = 0.0) -> PackedBinary:
    """Encode f32 values: strictly ``> threshold`` -> 1
    (reference ``src/binary.rs:133``)."""
    values = jnp.asarray(values, dtype=jnp.float32)
    bits = values > jnp.float32(threshold)
    return PackedBinary(_pack_bits(bits), int(values.shape[-1]))


def encode_binary_batch(rows, threshold: float = 0.0) -> jax.Array:
    """Encode an (N, D) corpus into (N, ceil(D/32)) uint32 words — the
    Batch encoder (one fused pass, jit-able)."""
    rows = jnp.asarray(rows, dtype=jnp.float32)
    return _pack_bits(rows > jnp.float32(threshold))


def _check_dims(a: PackedBinary, b: PackedBinary, op: str) -> None:
    if a.dimension != b.dimension:
        raise ContractError(
            f"innr_tpu::{op}: dimension mismatch ({a.dimension} vs {b.dimension})"
        )


def binary_hamming(a: PackedBinary, b: PackedBinary) -> jax.Array:
    """Differing-bit count: XOR + popcount (reference ``src/binary.rs:154``)."""
    _check_dims(a, b, "binary_hamming")
    return jnp.sum(
        jax.lax.population_count(a.words ^ b.words).astype(jnp.int32),
        dtype=jnp.int32,
    ).astype(jnp.uint32)


def binary_dot(a: PackedBinary, b: PackedBinary) -> jax.Array:
    """Intersection count: AND + popcount (reference ``src/binary.rs:178``)."""
    _check_dims(a, b, "binary_dot")
    return jnp.sum(
        jax.lax.population_count(a.words & b.words).astype(jnp.int32),
        dtype=jnp.int32,
    ).astype(jnp.uint32)


def binary_jaccard(a: PackedBinary, b: PackedBinary) -> jax.Array:
    """|A n B| / |A u B|; empty union -> 1.0
    (reference ``src/binary.rs:199``)."""
    _check_dims(a, b, "binary_jaccard")
    inter = jnp.sum(
        jax.lax.population_count(a.words & b.words).astype(jnp.int32),
        dtype=jnp.int32,
    )
    union = jnp.sum(
        jax.lax.population_count(a.words | b.words).astype(jnp.int32),
        dtype=jnp.int32,
    )
    return jnp.where(
        union == 0, 1.0, inter.astype(jnp.float32) / union.astype(jnp.float32)
    )


class PackedBinaryBatch:
    """A packed binary corpus: (N, W) uint32 words, padding bits of the
    last word masked."""

    __slots__ = ("words", "_dimension")

    def __init__(self, words, dimension: int):
        words = jnp.asarray(words, dtype=jnp.uint32)
        if words.ndim != 2 or words.shape[1] != _num_words(dimension):
            raise ContractError(
                f"PackedBinaryBatch: words shape {words.shape} doesn't match "
                f"dimension {dimension}"
            )
        self.words = _mask_padding(words, dimension)
        self._dimension = int(dimension)

    @classmethod
    def encode(cls, rows, threshold: float = 0.0) -> "PackedBinaryBatch":
        rows = jnp.asarray(rows, dtype=jnp.float32)
        return cls(_pack_bits(rows > jnp.float32(threshold)), int(rows.shape[1]))

    @property
    def num_vectors(self) -> int:
        return int(self.words.shape[0])

    @property
    def dimension(self) -> int:
        return self._dimension

    def memory_bytes(self) -> int:
        return int(self.words.size) * 4


def binary_knn(query: PackedBinary, corpus: PackedBinaryBatch, k: int):
    """Top-k nearest by bit-Hamming over a packed corpus — the coarse stage
    of the binary retrieval pipeline (reference examples/binary_demo.rs).

    Returns ``(counts ascending, indices)`` numpy arrays: one XOR +
    popcount reduction over the 1 bit/dim codes, then ``top_k``.
    """
    if query.dimension != corpus.dimension:
        raise ContractError(
            f"innr_tpu::binary_knn: dimension mismatch "
            f"({query.dimension} vs {corpus.dimension})"
        )
    n = corpus.num_vectors
    if n == 0 or k == 0:
        return np.zeros((0,), np.uint32), np.zeros((0,), np.int64)
    k = min(int(k), n)
    counts, idx = _hamming_top_k(query.words[None, :], corpus.words, k)
    return np.asarray(counts[0]), np.asarray(idx[0], dtype=np.int64)


@functools.partial(jax.jit, static_argnames=("k",))
def _hamming_top_k(q_words, words, k: int):
    """(Q, W) query words x (N, W) corpus words -> the k smallest Hamming
    counts per query and their rows. One jitted program, so XLA fuses the
    XOR, popcount and row sum into one reduction over the corpus."""
    counts = jnp.sum(
        jax.lax.population_count(words[None, :, :] ^ q_words[:, None, :]
                                 ).astype(jnp.int32),
        axis=2,
    )
    neg, idx = top_k_keys(-counts, k)
    return (-neg).astype(jnp.uint32), idx


def binary_knn_batch(queries, corpus: PackedBinaryBatch, k: int):
    """Multi-query binary kNN for a (Q, W) packed query batch (the
    serving form; all queries share one corpus read).

    ``queries``: (Q, W) uint32 words, a list of :class:`PackedBinary`, or a
    :class:`PackedBinaryBatch`. Returns ``(counts (Q, k), indices (Q, k))``.
    """
    if isinstance(queries, PackedBinaryBatch):
        q_words = queries.words
    elif isinstance(queries, (list, tuple)):
        q_words = jnp.stack([q.words for q in queries])
    else:
        q_words = jnp.asarray(queries, dtype=jnp.uint32)
    if q_words.ndim != 2 or q_words.shape[1] != corpus.words.shape[1]:
        raise ContractError(
            f"innr_tpu::binary_knn_batch: query words {q_words.shape} don't "
            f"match corpus word count {corpus.words.shape[1]}"
        )
    n = corpus.num_vectors
    if n == 0 or k == 0:
        n_q = int(q_words.shape[0])
        return np.zeros((n_q, 0), np.uint32), np.zeros((n_q, 0), np.int64)
    k = min(int(k), n)
    counts, idx = _hamming_top_k(q_words, corpus.words, k)
    return np.asarray(counts), np.asarray(idx, dtype=np.int64)


def batch_binary_hamming(query, corpus) -> jax.Array:
    """Hamming of one packed query against a packed corpus.

    ``query``: (W,) uint32 words or :class:`PackedBinary`; ``corpus``:
    (N, W) uint32. Returns (N,) uint32: one fused XOR + popcount + row
    sum.
    """
    if isinstance(query, PackedBinary):
        query = query.words
    query = jnp.asarray(query, dtype=jnp.uint32)
    corpus = jnp.asarray(corpus, dtype=jnp.uint32)
    if corpus.shape[-1] != query.shape[-1]:
        raise ContractError(
            f"innr_tpu::batch_binary_hamming: word-count mismatch "
            f"({corpus.shape[-1]} vs {query.shape[-1]})"
        )
    pc = jax.lax.population_count(corpus ^ query[None, :]).astype(jnp.int32)
    return jnp.sum(pc, axis=1).astype(jnp.uint32)
