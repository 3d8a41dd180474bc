"""Fixed-capacity top-K tracker with reference-exact semantics.

Port of the *semantics* of reference ``src/topk.rs``: K smallest
``(id, distance)`` pairs, buffer sorted descending (worst at index 0, O(1)
threshold), ``total_cmp`` ordering so NaN sorts greatest and can never
poison the acceptance gate (reference ``src/topk.rs:96-121`` and the NaN
regression test at ``:191-208``).

This is the *host-side streaming* form — the inner-loop tracker the
reference feeds one candidate at a time. Two tiers:

- ``insert``: single candidate, pure Python (the reference's API shape);
- ``insert_batch``: a candidate stream, dispatched to the native C runtime
  (``native/innr_host.c`` via ctypes) when available — the memmove-based
  insertion loop of the reference compiled for the host — with a NumPy
  fallback of identical semantics.

On the device the batch kNN paths never touch this class: they select with the
integer total-order ``lax.top_k`` (:func:`innr_tpu.utils.order.top_k_total`),
which is differential-tested to produce identical results to draining the
candidate stream through this tracker.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["TopK"]


def _total_key(d: float) -> int:
    """int key whose ``<`` equals ``f32::total_cmp`` on f32 values."""
    (bits,) = struct.unpack("<i", struct.pack("<f", np.float32(d)))
    return bits ^ 0x7FFFFFFF if bits < 0 else bits


def _total_keys(a: np.ndarray) -> np.ndarray:
    bits = a.astype(np.float32).view(np.int32)
    return np.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


class TopK:
    """Fixed-capacity tracker of the K smallest distances seen so far."""

    __slots__ = ("k", "_d", "_i", "_count")

    def __init__(self, k: int):
        if k <= 0:
            raise ValueError("innr_tpu.TopK: k must be >= 1")
        self.k = int(k)
        # Sorted descending by total order: index 0 is the current worst.
        self._d = np.zeros(self.k, dtype=np.float32)
        self._i = np.zeros(self.k, dtype=np.uint32)
        self._count = 0

    def threshold(self) -> float:
        """Current worst distance, or +inf until the set is full."""
        if self._count < self.k:
            return float("inf")
        return float(self._d[0])

    def insert(self, id_: int, distance: float) -> None:
        """Insert if ``distance`` improves the set (total-order compare)."""
        d = np.float32(distance)
        key = _total_key(d)
        c = self._count
        if c >= self.k:
            if key >= _total_key(self._d[0]):
                return  # reject — single compare, no mutation
            # Evict the worst (index 0) by shifting left.
            self._d[: self.k - 1] = self._d[1:]
            self._i[: self.k - 1] = self._i[1:]
            c = self.k - 1
        pos = self._find_insert_pos(key, c)
        self._d[pos + 1 : c + 1] = self._d[pos:c]
        self._i[pos + 1 : c + 1] = self._i[pos:c]
        self._d[pos] = d
        self._i[pos] = np.uint32(id_)
        self._count = c + 1

    def insert_batch(self, ids, distances) -> None:
        """Stream many candidates through the tracker (native fast path)."""
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        dists = np.ascontiguousarray(distances, dtype=np.float32)
        if ids.shape != dists.shape:
            raise ValueError("TopK.insert_batch: ids/distances length mismatch")
        from innr_tpu import _native

        new_count = _native.topk_insert_batch(
            dists, ids, self.k, self._d, self._i, self._count
        )
        if new_count is not None:
            self._count = new_count
            return
        for i, d in zip(ids, dists):  # pure-Python fallback
            self.insert(int(i), float(d))

    def __len__(self) -> int:
        return self._count

    def is_empty(self) -> bool:
        return self._count == 0

    def into_sorted(self) -> list[tuple[int, float]]:
        """Results ascending by distance (closest first); consumes the set."""
        c = self._count
        out = [
            (int(self._i[j]), float(self._d[j])) for j in range(c - 1, -1, -1)
        ]
        self._count = 0
        return out

    def _find_insert_pos(self, key: int, length: int) -> int:
        """Leftmost index in the descending buffer where
        ``key(buffer[i]) <= key`` — equal elements push toward higher
        indices (reference ``src/topk.rs:173-188``)."""
        lo, hi = 0, length
        while lo < hi:
            mid = (lo + hi) // 2
            if _total_key(self._d[mid]) > key:
                lo = mid + 1
            else:
                hi = mid
        return lo
