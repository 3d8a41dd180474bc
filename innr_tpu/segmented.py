"""Mutable serving index over immutable segments (the LSM pattern).

Every container in the family is an immutable device array — the right
trade for device scan throughput, and exactly what the reference ships
(``VerticalBatch`` has no insert/remove). Real serving additionally needs
ingestion and deletion; :class:`SegmentedCorpus` provides both WITHOUT
giving up immutable scan segments:

- ``add(rows)`` appends a new immutable :class:`~innr_tpu.batch.
  VerticalBatch` segment (no rebuild of existing ones);
- ``delete(ids)`` sets host-side tombstones (the segment arrays are
  untouched; deleted rows are excluded exactly at query time);
- ``knn_dot/knn/knn_cosine`` run one multi-query scan per segment —
  over-fetching by the segment's tombstone count so deletions can never
  displace genuine winners — and merge the per-segment candidates ON
  DEVICE on int32 total-order keys with global-id tie-breaking (one
  ``lexsort`` over the stacked candidates, one host fetch per query
  batch), the same discipline as the distributed merge;
- ``compact()`` folds all segments into one when tombstones accumulate,
  and runs AUTOMATICALLY (size-tiered policy) when the tombstone
  fraction exceeds ``max_dead_frac`` or the segment count exceeds
  ``max_segments`` — a delete-heavy serving workload can never degrade
  into many launch-bound segment scans or unbounded over-fetch.

Row ids are permanent (monotonic): ``add`` returns the id range, results
report ids, and ``compact`` preserves them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu.batch import VerticalBatch
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.order import total_order_key_f32

__all__ = ["SegmentedCorpus"]

_INT_MIN32 = np.int32(-(2**31))


class _Segment:
    def __init__(self, vb: VerticalBatch, ids: np.ndarray):
        self.vb = vb
        self.ids = ids  # (n,) int64 permanent global ids
        self.alive = np.ones(len(ids), bool)
        self._ids_dev = None
        self._alive_dev = None

    @property
    def n_dead(self) -> int:
        return int((~self.alive).sum())

    def ids_dev(self) -> jax.Array:
        """Permanent ids as a device array (int32 — ``add`` guards the
        2^31 id ceiling), cached; gathers stay on device at query time."""
        if self._ids_dev is None:
            self._ids_dev = jnp.asarray(self.ids.astype(np.int32))
        return self._ids_dev

    def alive_dev(self) -> jax.Array:
        """Tombstone mask as a device array, invalidated on delete."""
        if self._alive_dev is None:
            self._alive_dev = jnp.asarray(self.alive)
        return self._alive_dev


from functools import partial


@partial(jax.jit, static_argnames=("k",))
def _merge_candidates(keys, vals, gids, k: int):
    """Device-side k-way merge: one multi-operand sort ascending by
    (~key, gid) — i.e. best key first, lowest permanent id breaking ties —
    carrying the decoded scores along. Replaces the per-batch host
    lexsort round trip.

    ``num_keys=2`` is exact, not load-bearing precision: permanent ids
    are globally unique among surfaceable candidates (dead rows share
    the sentinel gid but can never surface while >= k alive candidates
    exist), so a third sort key could never be consulted."""
    _, _, top_vals, top_gids = jax.lax.sort(
        (~keys, gids, vals, gids), dimension=-1, num_keys=2
    )
    return top_vals[:, :k], top_gids[:, :k]


def _overfetch_k(need: int, n_seg: int) -> int:
    """Per-segment fetch size: ``need`` (= k + tombstones, so k alive
    survivors are guaranteed) rounded up to a power of two so the jitted
    scan's static k takes O(log n) distinct values across a delete-heavy
    serving session instead of recompiling per tombstone count; capped
    at the segment size."""
    k_seg = min(1 << max(need - 1, 1).bit_length(), n_seg)
    return max(k_seg, min(need, n_seg))


class SegmentedCorpus:
    """A mutable f32 corpus: immutable scan segments + tombstones."""

    def __init__(self, dimension: int, *, auto_compact: bool = True,
                 max_dead_frac: float = 0.25, max_segments: int = 16):
        """``auto_compact``: run :meth:`compact` automatically when the
        tombstone fraction exceeds ``max_dead_frac`` or the segment count
        exceeds ``max_segments`` (the size-tiered policy; manual
        :meth:`compact` always available)."""
        if int(dimension) <= 0:
            raise ContractError("SegmentedCorpus: dimension must be positive")
        self._dim = int(dimension)
        self._segments: list[_Segment] = []
        self._next_id = 0
        self.auto_compact = bool(auto_compact)
        self.max_dead_frac = float(max_dead_frac)
        self.max_segments = int(max_segments)

    # ------------------------------------------------------------- mutate --
    def add(self, rows) -> tuple[int, int]:
        """Append rows as a new immutable segment. Returns the permanent
        ``(first_id, last_id + 1)`` range assigned to them."""
        rows = np.asarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self._dim:
            raise ContractError(
                f"SegmentedCorpus.add: rows must be (N, {self._dim}), got "
                f"{rows.shape}"
            )
        n = rows.shape[0]
        if n == 0:
            return self._next_id, self._next_id
        if self._next_id + n >= 2**31:
            raise ContractError(
                "SegmentedCorpus.add: permanent id space exhausted (2^31)"
            )
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._segments.append(_Segment(VerticalBatch.from_rows(rows), ids))
        self._next_id += n
        self._maybe_compact()
        return int(ids[0]), int(ids[-1]) + 1

    def delete(self, ids) -> int:
        """Tombstone rows by permanent id. Unknown/already-deleted ids are
        ignored. Returns the number of rows newly deleted.

        Each segment's id array is sorted ascending (monotonic assignment;
        compaction preserves order), so lookup is a vectorized
        ``searchsorted`` per segment — no per-row side table."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, dtype=np.int64)))
        deleted = 0
        for seg in self._segments:
            if len(seg.ids) == 0:
                continue
            pos = np.clip(np.searchsorted(seg.ids, ids), 0, len(seg.ids) - 1)
            hit = seg.ids[pos] == ids
            tgt = pos[hit]
            newly = int(seg.alive[tgt].sum())
            if newly:
                seg.alive[tgt] = False
                seg._alive_dev = None
            deleted += newly
        if deleted:
            self._maybe_compact()
        return deleted

    def _maybe_compact(self) -> None:
        """Size-tiered auto-compaction: keep segment scans few and large."""
        if not self.auto_compact or not self._segments:
            return
        total = sum(len(s.ids) for s in self._segments)
        dead = self.num_deleted
        if (
            len(self._segments) > self.max_segments
            or (total > 0 and dead / total > self.max_dead_frac)
        ):
            self.compact()

    def compact(self) -> None:
        """Fold all alive rows into one segment (ids preserved). Call when
        tombstones or segment count accumulate; scans over many small
        segments pay one scan launch each."""
        if not self._segments:
            return
        rows = np.concatenate(
            [np.asarray(s.vb.rows)[s.alive] for s in self._segments]
        )
        ids = np.concatenate([s.ids[s.alive] for s in self._segments])
        self._segments = (
            [_Segment(VerticalBatch.from_rows(rows), ids)] if len(ids) else []
        )

    # ------------------------------------------------------------ inspect --
    @property
    def dimension(self) -> int:
        return self._dim

    @property
    def num_vectors(self) -> int:
        """Alive rows."""
        return sum(int(s.alive.sum()) for s in self._segments)

    @property
    def num_deleted(self) -> int:
        return sum(s.n_dead for s in self._segments)

    @property
    def num_segments(self) -> int:
        return len(self._segments)

    def memory_bytes(self) -> int:
        return sum(s.vb.memory_bytes() for s in self._segments)

    # ------------------------------------------------------------- search --
    def _run(self, queries, k: int, mode: str, op: str):
        """One scan per segment, all candidate handling on device:
        per-segment raw total-order keys (shared body
        :func:`innr_tpu.parallel._scan.local_scan_keys`) -> device gather
        of permanent ids + tombstone masks -> one lexsort merge (best key
        first, then lowest global id) -> ONE host fetch per query batch.

        Dead rows are pinned in KEY space (INT32_MIN): score-space pins
        (+-inf) would outrank alive NaN rows under total order. Pins can
        never surface while >= k alive candidates exist, which the
        k <= num_vectors clamp guarantees.
        """
        from innr_tpu import scan
        from innr_tpu.parallel._scan import decode_keys, local_scan_keys

        qs = np.asarray(queries, dtype=np.float32)
        single = qs.ndim == 1
        if single:
            qs = qs[None, :]
        if qs.ndim != 2 or qs.shape[1] != self._dim:
            raise ContractError(
                f"innr_tpu::{op}: queries must be (Q, {self._dim}), got "
                f"{np.asarray(queries).shape}"
            )
        n_alive = self.num_vectors
        n_q = qs.shape[0]
        k = min(int(k), n_alive)
        if k <= 0:
            empty = (
                np.zeros((n_q, 0), np.float32),
                np.zeros((n_q, 0), np.int64),
            )
            return (empty[0][0], empty[1][0]) if single else empty
        qs_dev = jnp.asarray(qs)
        if mode == "cosine":
            qs_dev = scan.unit_queries(qs_dev)
        per_keys, per_vals, per_gids = [], [], []
        for seg in self._segments:
            n_seg = len(seg.ids)
            # (an empty segment has alive.sum() == 0 too, so this one
            # check covers the zero-row case)
            if int(seg.alive.sum()) == 0:
                continue
            k_seg = _overfetch_k(k + seg.n_dead, n_seg)
            aux = None
            if mode == "l2":
                aux = seg.vb.norms2()
            elif mode == "cosine":
                aux = seg.vb.inv_norms()
            route = scan.dense_route(qs_dev, seg.vb.rows, k_seg)
            keys, lidx = local_scan_keys(
                qs_dev, seg.vb.rows, aux, n_seg, k_seg, mode, 0, route=route
            )
            vals = decode_keys(keys, mode, qs_dev, n_seg, route)
            # Unify key space across segments (decomposed L2 keys lack the
            # per-query ||q||^2 shift): re-key from the decoded
            # scores, flipped so larger = better for every mode.
            ukeys = total_order_key_f32(vals)
            if mode == "l2":
                ukeys = ~ukeys
            alive = seg.alive_dev()[lidx]
            gid = seg.ids_dev()[lidx]
            ukeys = jnp.where(alive, ukeys, jnp.int32(_INT_MIN32))
            gid = jnp.where(alive, gid, jnp.int32(2**31 - 1))
            per_keys.append(ukeys)
            per_vals.append(vals)
            per_gids.append(gid)
        out_scores, out_ids = _merge_candidates(
            jnp.concatenate(per_keys, axis=1),
            jnp.concatenate(per_vals, axis=1),
            jnp.concatenate(per_gids, axis=1),
            k,
        )
        # One device_get fetches the pair in a single transfer.
        out_scores, out_ids = jax.device_get((out_scores, out_ids))
        out_scores = np.asarray(out_scores)
        out_ids = np.asarray(out_ids, dtype=np.int64)
        if single:
            return out_scores[0], out_ids[0]
        return out_scores, out_ids

    def knn_dot(self, queries, k: int):
        """Top-k MIPS over all alive rows: (scores descending, permanent
        ids). Accepts (D,) or (Q, D)."""
        return self._run(queries, k, "dot", "segmented_knn_dot")

    def knn(self, queries, k: int):
        """Top-k exact L2^2 (ascending) over all alive rows."""
        return self._run(queries, k, "l2", "segmented_knn")

    def knn_cosine(self, queries, k: int):
        """Top-k cosine (descending) over all alive rows."""
        return self._run(queries, k, "cosine", "segmented_knn_cosine")
