"""Host-side corpus ingest (the data-loader layer).

Encoding a large corpus for device upload is host work: the f32 source
usually lives on disk/CPU, and shipping it to the device just to pack bits
wastes PCIe bandwidth 32x. These functions encode on the host — via
the native C runtime (``native/innr_host.c``) when available, NumPy
otherwise — and return the same containers the jit encoders produce, so
ingest and on-device encoding are interchangeable (differential-tested).
"""

from __future__ import annotations

import numpy as np

from innr_tpu import _native
from innr_tpu.ops.binary import PackedBinaryBatch
from innr_tpu.ops.scalar import QuantizationParams, QuantizedU8Batch
from innr_tpu.ops.ternary import PackedTernaryBatch

__all__ = [
    "encode_binary_host",
    "encode_ternary_host",
    "minhash_sketch_host",
    "quantize_u8_host",
]


def _pack_rows_numpy(bits: np.ndarray) -> np.ndarray:
    """(R, D) bool -> (R, ceil(D/32)) uint32, bit i%32 of word i//32."""
    r, d = bits.shape
    w = (d + 31) // 32
    packed = np.packbits(bits, axis=1, bitorder="little")
    full = np.zeros((r, w * 4), dtype=np.uint8)
    full[:, : packed.shape[1]] = packed
    return full.view(np.uint32)


def encode_binary_host(rows, threshold: float = 0.0) -> PackedBinaryBatch:
    """Encode an (R, D) f32 corpus to packed binary on the host CPU."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    words = _native.pack_binary_rows(rows, float(threshold))
    if words is None:
        words = _pack_rows_numpy(rows > np.float32(threshold))
    return PackedBinaryBatch(words, int(rows.shape[1]))


def encode_ternary_host(rows, threshold: float) -> PackedTernaryBatch:
    """Encode an (R, D) f32 corpus to ternary bitplanes on the host CPU."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    t = np.float32(threshold)
    planes = _native.pack_ternary_rows(rows, float(threshold))
    if planes is not None:
        pos, neg = planes
    else:
        pos = _pack_rows_numpy(rows > t)
        neg = _pack_rows_numpy(rows < -t)
    return PackedTernaryBatch(pos, neg, int(rows.shape[1]))


def quantize_u8_host(rows, params: QuantizationParams) -> QuantizedU8Batch:
    """Quantize an (R, D) f32 corpus to u8 codes on the host CPU."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    codes = _native.quantize_u8_rows(rows, params.alpha, params.offset)
    if codes is None:
        inv = 255.0 / params.alpha
        normalized = (rows - np.float32(params.offset)) * np.float32(inv)
        # Half-away-from-zero (matches the C encoder and ops/scalar.py),
        # not np.round's half-to-even.
        codes = np.clip(np.floor(normalized + 0.5), 0, 255).astype(np.uint8)
    return QuantizedU8Batch(codes)


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """NumPy mirror of the C runtime's splitmix64 (bit-identical)."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def minhash_sketch_host(docs, n_slots: int) -> np.ndarray:
    """MinHash-sketch a collection of item sets on the host CPU.

    ``docs``: list of 1-D uint64 item arrays (shingle hashes; empty docs
    allowed -> all-0xFFFFFFFF sketch rows). Returns ``(n_docs, n_slots)``
    uint32 sketches ready for :class:`innr_tpu.SketchCorpus` /
    :class:`innr_tpu.parallel.ShardedSlotCorpus`. Native C fast path
    (pthread-parallel over docs, bit-identical at any thread count) with
    a NumPy fallback computing the identical splitmix64-seeded hashes.
    """
    arrs = [np.ascontiguousarray(d, dtype=np.uint64).ravel() for d in docs]
    offsets = np.zeros(len(arrs) + 1, np.int64)
    np.cumsum([a.size for a in arrs], out=offsets[1:])
    items = (
        np.concatenate(arrs) if arrs else np.zeros(0, np.uint64)
    )
    out = _native.minhash_rows(items, offsets, int(n_slots))
    if out is not None:
        return out
    n_docs = len(arrs)
    out = np.full((n_docs, int(n_slots)), 0xFFFFFFFF, np.uint32)
    seeds = np.uint64(0x9E3779B97F4A7C15) * (
        np.arange(1, int(n_slots) + 1, dtype=np.uint64)
    )
    with np.errstate(over="ignore"):
        for d, a in enumerate(arrs):
            if a.size == 0:
                continue
            h = _splitmix64_np(a[:, None] + seeds[None, :])  # (m, S)
            out[d] = (h >> np.uint64(32)).min(axis=0).astype(np.uint32)
    return out
