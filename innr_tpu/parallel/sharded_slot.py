"""Distributed search over a sharded slot-sketch (MinHash) corpus.

Extends the distributed kNN merge to integer-slot sketches: the corpus
shards **slot-major** — ``(S, N)`` uint32 with the sketch axis sharded.
The north-star MinHash config (10M x 128 u32 slots) is 5.12 GB; sharding
it across a mesh divides both the per-device footprint and the scan time.

Local scan: one XLA compare-reduce over the slot axis, then ``top_k``.
Selection keys are the exact negated differing-slot counts, so per-shard
results merge exactly (integer keys — the distributed result is
bit-identical to a single-device scan).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from innr_tpu.parallel.sharded import AXIS, default_mesh
from innr_tpu.parallel.sharded_packed import _plan_packed
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.padding import pad_axis_to, round_up

__all__ = ["ShardedSlotCorpus"]

_INT_MIN = jnp.iinfo(jnp.int32).min


def _local_slot_topk(q_slots, slots_t_shard, n_total, k):
    """Per-shard body: (Q, S) queries x (S, shard) slot-major tile ->
    per-query local top-k keys (-count: larger = better) + global indices."""
    shard_cols = slots_t_shard.shape[1]
    base = jax.lax.axis_index(AXIS) * shard_cols
    counts = jnp.sum(
        (slots_t_shard[None, :, :] != q_slots[:, :, None]).astype(jnp.int32),
        axis=1,
    )  # (Q, shard)
    keys = -counts
    gidx_row = base + jnp.arange(shard_cols, dtype=jnp.int32)
    keys = jnp.where(gidx_row[None, :] < n_total, keys, _INT_MIN)
    top_keys, tidx = jax.lax.top_k(keys, k)
    return top_keys, gidx_row[tidx]


@partial(jax.jit, static_argnames=("k", "k_local", "n_total", "mesh"))
def _sharded_slot_knn(
    q_slots, slots_sharded, k: int, k_local: int, n_total: int, mesh: Mesh,
):
    single = q_slots.ndim == 1
    if single:
        q_slots = q_slots[None, :]
    local = jax.shard_map(
        partial(_local_slot_topk, n_total=n_total, k=k_local),
        mesh=mesh,
        in_specs=(P(), P(None, AXIS)),
        out_specs=(P(None, AXIS), P(None, AXIS)),
    )
    keys, gidx = local(q_slots, slots_sharded)
    merged_keys, pos = jax.lax.top_k(keys, k)
    counts = (-merged_keys).astype(jnp.uint32)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    if single:
        return counts[0], idx[0]
    return counts, idx


class ShardedSlotCorpus:
    """A sketch corpus sharded sketch-wise (slot-major) across a mesh.

    The multi-chip analog of :class:`innr_tpu.ops.slot.SketchCorpus`.
    Slots are uint32 by default; uint16 input (b=16 b-bit MinHash) halves
    per-device HBM.
    """

    def __init__(self, sketches, mesh: Mesh | None = None, dtype=None):
        import numpy as np
        from innr_tpu.ops.slot import _check_no_narrowing

        in_dtype = getattr(sketches, "dtype", None)
        if in_dtype is None:
            sketches = np.asarray(sketches)
            in_dtype = sketches.dtype
        if dtype is None:
            dtype = jnp.uint16 if in_dtype == jnp.uint16 else jnp.uint32
        if dtype not in (jnp.uint16, jnp.uint32):
            raise ContractError(
                "ShardedSlotCorpus: dtype must be uint16 or uint32"
            )
        _check_no_narrowing(in_dtype, dtype, "ShardedSlotCorpus")
        sketches = jnp.asarray(sketches, dtype=dtype)
        if sketches.ndim != 2:
            raise ContractError("ShardedSlotCorpus: sketches must be 2-D (N, S)")
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = self.mesh.devices.size
        self.n_true = int(sketches.shape[0])
        self._num_slots = int(sketches.shape[1])
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        sketches = pad_axis_to(sketches, 0, self.n_pad)
        # Slot-major (S, N), sketch axis sharded.
        self.slots_t = jax.device_put(
            sketches.T, NamedSharding(self.mesh, P(None, AXIS))
        )

    @classmethod
    def from_sketch_source(cls, get_sketches, num_sketches: int,
                           num_slots: int, mesh: Mesh | None = None,
                           dtype=None) -> "ShardedSlotCorpus":
        """Stream a sketch corpus in per-shard pieces (no host
        materialization): ``get_sketches(start, stop)`` returns sketches
        ``[start, stop)`` as ``(stop - start, S)`` uint32 (or uint16 with
        ``dtype=jnp.uint16``)."""
        from innr_tpu.parallel._stream import streamed_array

        self = cls.__new__(cls)
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = int(self.mesh.devices.size)
        self.n_true = int(num_sketches)
        self._num_slots = int(num_slots)
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        import numpy as np

        np_dtype = np.uint16 if dtype == jnp.uint16 else np.uint32
        self.slots_t = streamed_array(
            get_sketches, self.n_true, self.n_pad, self._num_slots,
            np_dtype, NamedSharding(self.mesh, P(None, AXIS)),
            column_major=True, name="ShardedSlotCorpus.from_sketch_source",
        )
        return self

    @property
    def num_sketches(self) -> int:
        return self.n_true

    @property
    def num_slots(self) -> int:
        return self._num_slots

    def memory_bytes(self) -> int:
        return int(self.slots_t.size) * self.slots_t.dtype.itemsize

    def _check_q(self, q, op: str):
        from innr_tpu.ops.slot import _check_no_narrowing

        _check_no_narrowing(
            getattr(q, "dtype", None), self.slots_t.dtype, f"ShardedSlotCorpus.{op}"
        )
        q = jnp.asarray(q, dtype=self.slots_t.dtype)
        if q.shape[-1] != self._num_slots:
            raise ContractError(
                f"ShardedSlotCorpus.{op}: query slots {q.shape[-1]} != "
                f"corpus slots {self._num_slots}"
            )
        return q

    def _run(self, q, k: int):
        if k <= 0 or self.n_true == 0:
            if q.ndim == 2:
                n_q = int(q.shape[0])
                return (
                    jnp.zeros((n_q, 0), jnp.uint32),
                    jnp.zeros((n_q, 0), jnp.int32),
                )
            return jnp.zeros((0,), jnp.uint32), jnp.zeros((0,), jnp.int32)
        k = min(int(k), self.n_true)
        k_local = _plan_packed(self.n_pad, int(self.mesh.devices.size), k)
        return _sharded_slot_knn(
            q, self.slots_t, k, k_local, self.n_true, self.mesh
        )

    def knn(self, query, k: int):
        """Distributed top-k smallest differing-slot counts for one (S,)
        sketch: returns ``(counts ascending, global indices)``."""
        q = self._check_q(query, "knn")
        if q.ndim != 1:
            raise ContractError(
                "ShardedSlotCorpus.knn: query must be 1-D (S,); use "
                "knn_batch for (Q, S) batches"
            )
        return self._run(q, k)

    def knn_batch(self, queries, k: int):
        """Multi-query distributed slot kNN: (Q, S) sketches ->
        ``(counts (Q, k), indices (Q, k))``; one local launch per shard
        for the whole batch."""
        q = self._check_q(queries, "knn_batch")
        if q.ndim != 2:
            raise ContractError(
                "ShardedSlotCorpus.knn_batch: queries must be 2-D (Q, S)"
            )
        return self._run(q, k)

    def minhash_knn(self, query, k: int):
        """Distributed MinHash retrieval: top-k Jaccard similarities
        (matching-slot fraction, descending) + global indices."""
        counts, idx = self.knn(query, k)
        sims = 1.0 - counts.astype(jnp.float32) / jnp.float32(
            max(self._num_slots, 1)
        )
        return sims, idx
