"""Integer-slot Hamming distance and MinHash Jaccard estimation.

Redesign of reference ``src/slot.rs``. Slot comparisons are lane-wise
integer compare + count — exactly what vector lanes do natively, so
the "kernel" is a fused compare-reduce. The u64 width needs care: jnp runs
without 64-bit types by default, so u64 slots are compared as (hi, lo)
uint32 pairs — two slots are equal iff both halves are equal. Results are
exact integers (differential tests use equality, not tolerance, matching
``fuzz/fuzz_targets/slot_diff.rs``).

Contracts: the width-specific functions raise on length mismatch; the
generic :func:`slot_hamming` and :func:`slot_compare_counts` compare over
the minimum length (reference ``src/slot.rs:266``, ``:299``).
``minhash_jaccard`` of two empty sketches is 1.0; ``jaccard_distance`` is
0.0.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.order import top_k_keys

__all__ = [
    "SketchCorpus",
    "SlotCounts",
    "slot_hamming",
    "slot_hamming_u16",
    "slot_hamming_u32",
    "slot_hamming_u64",
    "slot_compare_counts",
    "minhash_jaccard",
    "jaccard_distance",
    "batch_slot_hamming_u32",
    "slot_knn_u16",
    "slot_knn_u16_batch",
    "slot_knn_u32",
    "slot_knn_u32_batch",
    "minhash_knn",
    "minhash_knn_batch",
]


@dataclass(frozen=True)
class SlotCounts:
    """(eq, lt, gt) triple from :func:`slot_compare_counts`
    (reference ``src/slot.rs:314``). ``eq + lt + gt`` equals the number of
    compared positions. Consumed by SetSketch / UltraLogLog estimators."""

    eq: int = 0
    lt: int = 0
    gt: int = 0


def _check_len(a, b, op: str) -> None:
    if a.shape[-1] != b.shape[-1]:
        raise ContractError(
            f"innr_tpu::{op}: slice length mismatch "
            f"({a.shape[-1]} vs {b.shape[-1]})"
        )


def _u64_to_u32_pairs(x) -> np.ndarray:
    """View uint64 slots as little-endian (n, 2) uint32 halves."""
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return arr.view(np.uint32).reshape(arr.size, 2)


def slot_hamming_u32(a, b) -> jax.Array:
    """Differing-slot count over u32 slots (reference ``src/slot.rs:95``)."""
    a = jnp.asarray(a, dtype=jnp.uint32)
    b = jnp.asarray(b, dtype=jnp.uint32)
    _check_len(a, b, "slot_hamming_u32")
    return jnp.sum((a != b).astype(jnp.int32), dtype=jnp.int32).astype(jnp.uint32)


def slot_hamming_u16(a, b) -> jax.Array:
    """Differing-slot count over u16 slots — the b=16 b-bit MinHash width
    (reference ``src/slot.rs:158``)."""
    a = jnp.asarray(a, dtype=jnp.uint16)
    b = jnp.asarray(b, dtype=jnp.uint16)
    _check_len(a, b, "slot_hamming_u16")
    return jnp.sum((a != b).astype(jnp.int32), dtype=jnp.int32).astype(jnp.uint32)


def slot_hamming_u64(a, b) -> jax.Array:
    """Differing-slot count over u64 slots (reference ``src/slot.rs:209``).

    Accepts numpy uint64 input; compared on-device as uint32 (hi, lo)
    halves, since JAX's default integers are 32-bit.
    """
    a32 = _u64_to_u32_pairs(a)
    b32 = _u64_to_u32_pairs(b)
    if a32.shape[0] != b32.shape[0]:
        raise ContractError(
            f"innr_tpu::slot_hamming_u64: slice length mismatch "
            f"({a32.shape[0]} vs {b32.shape[0]})"
        )
    a32 = jnp.asarray(a32)
    b32 = jnp.asarray(b32)
    diff = jnp.any(a32 != b32, axis=1)
    return jnp.sum(diff.astype(jnp.int32), dtype=jnp.int32).astype(jnp.uint32)


def slot_hamming(a, b) -> int:
    """Generic differing-slot count over the *minimum* length, any integer
    width (reference ``src/slot.rs:266``). No length panic."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = min(a.size, b.size)
    if n == 0:
        return 0
    # Host-side numpy comparison: exact for every integer width including
    # u64 (which cannot round-trip through jnp with x64 off), and NaN
    # slots count as differing exactly like Rust's PartialEq.
    return int(np.sum(a[:n] != b[:n]))


def slot_compare_counts(a, b) -> SlotCounts:
    """Per-position (eq, lt, gt) counts over the minimum length
    (reference ``src/slot.rs:299``)."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = min(a.size, b.size)
    if n == 0:
        return SlotCounts()
    if a.dtype == np.uint64 or b.dtype == np.uint64:
        ah = jnp.asarray(_u64_to_u32_pairs(a[:n]))
        bh = jnp.asarray(_u64_to_u32_pairs(b[:n]))
        hi_eq = ah[:, 1] == bh[:, 1]
        eq = hi_eq & (ah[:, 0] == bh[:, 0])
        lt = (ah[:, 1] < bh[:, 1]) | (hi_eq & (ah[:, 0] < bh[:, 0]))
    else:
        aj = jnp.asarray(a[:n])
        bj = jnp.asarray(b[:n])
        eq = aj == bj
        lt = aj < bj
    eq_count = int(jnp.sum(eq.astype(jnp.int32)))
    lt_count = int(jnp.sum(lt.astype(jnp.int32)))
    return SlotCounts(eq=eq_count, lt=lt_count, gt=n - eq_count - lt_count)


def minhash_jaccard(a, b) -> jax.Array:
    """MinHash Jaccard similarity: fraction of matching u32 slots
    (reference ``src/slot.rs:348``). Two empty sketches -> 1.0."""
    a = jnp.asarray(a, dtype=jnp.uint32)
    b = jnp.asarray(b, dtype=jnp.uint32)
    _check_len(a, b, "minhash_jaccard")
    n = a.shape[-1]
    if n == 0:
        return jnp.float32(1.0)
    matches = jnp.sum((a == b).astype(jnp.int32), dtype=jnp.int32)
    return matches.astype(jnp.float32) / jnp.float32(n)


def jaccard_distance(a, b) -> jax.Array:
    """MinHash Jaccard distance: fraction of differing u32 slots
    (reference ``src/slot.rs:392``). Two empty sketches -> 0.0."""
    a = jnp.asarray(a, dtype=jnp.uint32)
    b = jnp.asarray(b, dtype=jnp.uint32)
    _check_len(a, b, "jaccard_distance")
    n = a.shape[-1]
    if n == 0:
        return jnp.float32(0.0)
    diff = jnp.sum((a != b).astype(jnp.int32), dtype=jnp.int32)
    return diff.astype(jnp.float32) / jnp.float32(n)


class SketchCorpus:
    """An (N, S) sketch corpus held on the device.

    The container form of a MinHash / slot-sketch collection (analog of
    ``PackedBinaryBatch`` for word planes): the slot scans compare and
    count over its rows in one fused XLA reduction, one corpus read per
    scan. Raw-data accessor preserved (``sketches``) per the reference's
    serialization contract (``src/slot.rs`` containers expose their
    slots).

    Slots are uint32 by default; uint16 sketches (the b-bit MinHash b=16
    width of reference ``src/slot.rs:158``) store at half the device
    bytes — pass a uint16 array or ``dtype=jnp.uint16``.
    """

    def __init__(self, sketches, dtype=None):
        # Inspect dtype WITHOUT materializing (np.asarray on a device
        # array is a full D2H copy); lists fall back to np.asarray.
        in_dtype = getattr(sketches, "dtype", None)
        if in_dtype is None:
            sketches = np.asarray(sketches)
            in_dtype = sketches.dtype
        if dtype is None:
            dtype = jnp.uint16 if in_dtype == jnp.uint16 else jnp.uint32
        if dtype not in (jnp.uint16, jnp.uint32):
            raise ContractError("SketchCorpus: dtype must be uint16 or uint32")
        _check_no_narrowing(in_dtype, dtype, "SketchCorpus")
        sketches = jnp.asarray(sketches, dtype=dtype)
        if sketches.ndim != 2:
            raise ContractError("SketchCorpus: sketches must be 2-D (N, S)")
        self.sketches = sketches

    @property
    def num_sketches(self) -> int:
        return int(self.sketches.shape[0])

    @property
    def num_slots(self) -> int:
        return int(self.sketches.shape[1])

    @property
    def dtype(self):
        return self.sketches.dtype

    def memory_bytes(self) -> int:
        return int(self.sketches.size) * self.sketches.dtype.itemsize


_WIDER_UNSIGNED = {
    jnp.dtype(jnp.uint16): (np.uint32, np.uint64),
    jnp.dtype(jnp.uint32): (np.uint64,),
}


def _check_no_narrowing(in_dtype, target, op: str) -> None:
    """Reject silently-wrapping casts: a u32/u64 sketch fed to a u16
    entry point (or u64 to u32) would truncate every slot mod 2^b and
    return wrong neighbors with no diagnostic."""
    if in_dtype is None:
        return
    if np.dtype(in_dtype) in [
        np.dtype(d) for d in _WIDER_UNSIGNED.get(jnp.dtype(target), ())
    ]:
        raise ContractError(
            f"innr_tpu::{op}: {np.dtype(in_dtype).name} slots passed to a "
            f"{jnp.dtype(target).name} entry point would be truncated — "
            f"convert explicitly if intentional"
        )


def _slot_corpus(corpus, dtype):
    """Normalize corpus input: (SketchCorpus | (N, S) array) -> (N, S)
    sketches, checking the slot width."""
    if isinstance(corpus, SketchCorpus):
        if corpus.dtype != jnp.dtype(dtype):
            raise ContractError(
                f"slot kNN: corpus slot dtype {corpus.dtype} does not match "
                f"the {jnp.dtype(dtype)} entry point"
            )
        return corpus.sketches
    _check_no_narrowing(getattr(corpus, "dtype", None), dtype, "slot kNN")
    return jnp.asarray(corpus, dtype=dtype)


def _sketch_knn(query, corpus, k: int, dtype, op: str):
    _check_no_narrowing(getattr(query, "dtype", None), dtype, op)
    query = jnp.asarray(query, dtype=dtype)
    if query.ndim != 1:
        raise ContractError(
            f"{op}: query must be 1-D (S,); use {op}_batch for (Q, S) batches"
        )
    sketches = _slot_corpus(corpus, dtype)
    _check_len(query, sketches, op)
    n = int(sketches.shape[0])
    if n == 0 or k <= 0:
        return jnp.zeros((0,), jnp.uint32), jnp.zeros((0,), jnp.int32)
    k = min(int(k), n)
    counts, idx = _mismatch_top_k(query[None, :], sketches, k)
    return counts[0], idx[0]


def _sketch_knn_batch(queries, corpus, k: int, dtype, op: str):
    _check_no_narrowing(getattr(queries, "dtype", None), dtype, op)
    queries = jnp.asarray(queries, dtype=dtype)
    if queries.ndim != 2:
        raise ContractError(f"{op}: queries must be 2-D (Q, S)")
    sketches = _slot_corpus(corpus, dtype)
    _check_len(queries, sketches, op)
    n = int(sketches.shape[0])
    n_q = int(queries.shape[0])
    if n == 0 or k <= 0:
        return jnp.zeros((n_q, 0), jnp.uint32), jnp.zeros((n_q, 0), jnp.int32)
    k = min(int(k), n)
    return _mismatch_top_k(queries, sketches, k)


@functools.partial(jax.jit, static_argnames=("k",))
def _mismatch_top_k(queries, sketches, k: int):
    """(Q, S) queries x (N, S) sketches -> the k smallest differing-slot
    counts per query and their rows, in one jitted program (one fused
    compare + count reduction over the corpus)."""
    counts = jnp.sum(
        (sketches[None, :, :] != queries[:, None, :]).astype(jnp.int32), axis=2
    )  # (Q, N)
    neg, idx = top_k_keys(-counts, k)
    return (-neg).astype(jnp.uint32), idx


def slot_knn_u32(query, corpus, k: int):
    """Top-k most similar u32 sketches: smallest differing-slot counts.

    Sketch retrieval (the reference provides only the pairwise
    primitive; a MinHash corpus scan is its natural batch form). ``query``:
    (S,) uint32; ``corpus``: (N, S) uint32 or a :class:`SketchCorpus`. Returns
    ``(counts ascending, indices)`` as jnp arrays.
    """
    return _sketch_knn(query, corpus, k, jnp.uint32, "slot_knn_u32")


def slot_knn_u32_batch(queries, corpus, k: int):
    """Multi-query slot-sketch kNN: one fused launch for a (Q, S) sketch
    batch (all queries share one corpus read).

    ``corpus``: (N, S) uint32 or :class:`SketchCorpus`. Returns
    ``(counts (Q, k) ascending, indices (Q, k))``.
    """
    return _sketch_knn_batch(queries, corpus, k, jnp.uint32, "slot_knn_u32_batch")


def slot_knn_u16(query, corpus, k: int):
    """Top-k most similar u16 sketches (the b=16 b-bit MinHash width,
    reference ``src/slot.rs:158``): half the HBM bytes and twice the
    lanes of the u32 scan. ``corpus``: (N, S) uint16 or a uint16
    :class:`SketchCorpus`."""
    return _sketch_knn(query, corpus, k, jnp.uint16, "slot_knn_u16")


def slot_knn_u16_batch(queries, corpus, k: int):
    """Multi-query u16 sketch kNN (see :func:`slot_knn_u16`)."""
    return _sketch_knn_batch(queries, corpus, k, jnp.uint16, "slot_knn_u16_batch")


def _minhash_dtype(query, corpus):
    """The CORPUS is the authoritative slot width (a u16 query against a
    raw u32 corpus must not narrow the corpus)."""
    if isinstance(corpus, SketchCorpus):
        return corpus.dtype
    corpus_dt = getattr(corpus, "dtype", None)
    if corpus_dt is not None and np.dtype(corpus_dt) == np.uint16:
        return jnp.dtype(jnp.uint16)
    if corpus_dt is None and np.asarray(query).dtype == np.uint16:
        return jnp.dtype(jnp.uint16)
    return jnp.dtype(jnp.uint32)


def minhash_knn(query, corpus, k: int):
    """Top-k sketches by MinHash Jaccard similarity (descending).

    Returns ``(similarities, indices)``; similarity = matching-slot
    fraction, the :func:`minhash_jaccard` estimator applied corpus-wide.
    Works over u32 or u16 sketch corpora (dtype follows the container).
    """
    counts, idx = _sketch_knn(
        query, corpus, k, _minhash_dtype(query, corpus), "minhash_knn"
    )
    s = jnp.asarray(query).shape[-1]
    sims = 1.0 - counts.astype(jnp.float32) / jnp.float32(max(s, 1))
    return sims, idx


def minhash_knn_batch(queries, corpus, k: int):
    """Multi-query MinHash retrieval: (Q, S) sketches -> top-k Jaccard
    similarities (descending) per query, one corpus read for the batch."""
    counts, idx = _sketch_knn_batch(
        queries, corpus, k, _minhash_dtype(queries, corpus), "minhash_knn_batch"
    )
    s = jnp.asarray(queries).shape[-1]
    sims = 1.0 - counts.astype(jnp.float32) / jnp.float32(max(s, 1))
    return sims, idx


def batch_slot_hamming_u32(query, corpus) -> jax.Array:
    """Differing-slot counts of one u32 sketch against a sketch corpus.

    ``query``: (S,) uint32, ``corpus``: (N, S) uint32 -> (N,) uint32. The
    batch form: one fused compare-reduce over the corpus read.
    """
    query = jnp.asarray(query, dtype=jnp.uint32)
    corpus = jnp.asarray(corpus, dtype=jnp.uint32)
    _check_len(query, corpus, "batch_slot_hamming_u32")
    diff = (corpus != query[None, :]).astype(jnp.int32)
    return jnp.sum(diff, axis=1).astype(jnp.uint32)
