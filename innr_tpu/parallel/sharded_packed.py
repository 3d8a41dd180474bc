"""Distributed search over sharded packed (binary / ternary) corpora.

Extends the distributed kNN merge to bit-packed corpora: packed word
planes shard **word-major** — ``(W, N)`` uint32 with the row axis sharded.
32x (binary) / 16x (ternary) less device memory and interconnect traffic
than the f32 path for the same corpus.

Local scan: one XLA XOR/AND + popcount reduction over the word axis, then
``top_k``. Selection keys are the small integer counts themselves, so
per-shard results merge exactly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from innr_tpu.ops.binary import PackedBinary, _mask_padding, _num_words, _pack_bits
from innr_tpu.parallel.sharded import AXIS, default_mesh
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.padding import pad_axis_to, round_up

__all__ = ["ShardedPackedBinary", "ShardedPackedTernary"]

_INT_MIN = jnp.iinfo(jnp.int32).min


def _plan_packed(n_pad: int, n_devices: int, k: int) -> int:
    """Local candidates per shard: padding is masked before the local
    top-k, so ``k`` clamped to the shard width suffices."""
    return min(k, n_pad // n_devices)


def _local_binary_topk(q_words, words_t_shard, n_total, k):
    """Per-shard body: (Q, W) queries x (W, shard) word-major tile ->
    per-query local top-k keys (-count: larger = better) + global indices."""
    shard_cols = words_t_shard.shape[1]
    base = jax.lax.axis_index(AXIS) * shard_cols
    counts = jnp.sum(
        jax.lax.population_count(
            words_t_shard[None, :, :] ^ q_words[:, :, None]
        ).astype(jnp.int32),
        axis=1,
    )  # (Q, shard)
    keys = -counts
    gidx_row = base + jnp.arange(shard_cols, dtype=jnp.int32)
    keys = jnp.where(gidx_row[None, :] < n_total, keys, _INT_MIN)
    top_keys, tidx = jax.lax.top_k(keys, k)
    return top_keys, gidx_row[tidx]


@partial(jax.jit, static_argnames=("k", "k_local", "n_total", "mesh"))
def _sharded_binary_knn(
    q_words, words_sharded, k: int, k_local: int, n_total: int, mesh: Mesh,
):
    single = q_words.ndim == 1
    if single:
        q_words = q_words[None, :]
    local = jax.shard_map(
        partial(_local_binary_topk, n_total=n_total, k=k_local),
        mesh=mesh,
        in_specs=(P(), P(None, AXIS)),
        out_specs=(P(None, AXIS), P(None, AXIS)),
    )
    keys, gidx = local(q_words, words_sharded)
    merged_keys, pos = jax.lax.top_k(keys, k)
    counts = (-merged_keys).astype(jnp.uint32)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    if single:
        return counts[0], idx[0]
    return counts, idx


class ShardedPackedBinary:
    """A packed binary corpus sharded row-wise (word-major) across a mesh."""

    def __init__(self, words, dimension: int, mesh: Mesh | None = None):
        words = jnp.asarray(words, dtype=jnp.uint32)
        if words.ndim != 2 or words.shape[1] != _num_words(dimension):
            raise ContractError(
                f"ShardedPackedBinary: words shape {words.shape} doesn't "
                f"match dimension {dimension}"
            )
        words = _mask_padding(words, dimension)
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = self.mesh.devices.size
        self.n_true = int(words.shape[0])
        self._dimension = int(dimension)
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        words = pad_axis_to(words, 0, self.n_pad)
        # Word-major (W, N), row axis sharded.
        self.words_t = jax.device_put(
            words.T, NamedSharding(self.mesh, P(None, AXIS))
        )

    @classmethod
    def encode(cls, rows, threshold: float = 0.0, mesh: Mesh | None = None):
        rows = jnp.asarray(rows, dtype=jnp.float32)
        return cls(
            _pack_bits(rows > jnp.float32(threshold)), int(rows.shape[1]), mesh
        )

    @classmethod
    def from_word_source(cls, get_words, num_vectors: int, dimension: int,
                         mesh: Mesh | None = None) -> "ShardedPackedBinary":
        """Stream a packed corpus in per-shard pieces without host
        materialization: ``get_words(start, stop)`` returns packed rows
        ``[start, stop)`` as ``(stop - start, W)`` uint32 (e.g. a memmap
        over an ``encode_binary_host`` file). Padding bits of the last
        word are masked here; no full-corpus host array is ever built.
        """
        from innr_tpu.parallel._stream import streamed_array

        self = cls.__new__(cls)
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = int(self.mesh.devices.size)
        self.n_true = int(num_vectors)
        self._dimension = int(dimension)
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        w = _num_words(dimension)
        rem = dimension % 32
        last_mask = np.uint32((1 << rem) - 1) if rem else np.uint32(0xFFFFFFFF)

        def fetch(start, stop):
            block = np.array(get_words(start, stop), dtype=np.uint32)
            if block.ndim == 2 and block.shape[1] == w:
                block[:, -1] &= last_mask
            return block

        self.words_t = streamed_array(
            fetch, self.n_true, self.n_pad, w, np.uint32,
            NamedSharding(self.mesh, P(None, AXIS)), column_major=True,
            name="ShardedPackedBinary.from_word_source",
        )
        return self

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return self._dimension

    def memory_bytes(self) -> int:
        return int(self.words_t.size) * 4

    def knn(self, query: PackedBinary, k: int):
        """Distributed top-k smallest Hamming: returns
        ``(counts ascending, global indices)``."""
        if query.dimension != self._dimension:
            raise ContractError(
                f"ShardedPackedBinary.knn: dimension mismatch "
                f"({query.dimension} vs {self._dimension})"
            )
        if k <= 0 or self.n_true == 0:
            return jnp.zeros((0,), jnp.uint32), jnp.zeros((0,), jnp.int32)
        k = min(int(k), self.n_true)
        k_local = _plan_packed(self.n_pad, int(self.mesh.devices.size), k)
        return _sharded_binary_knn(
            query.words, self.words_t, k, k_local, self.n_true, self.mesh,
        )

    def knn_batch(self, q_words, k: int):
        """Multi-query distributed Hamming top-k: (Q, W) packed queries ->
        ``(counts (Q, k), indices (Q, k))``; one local launch per shard for
        the whole batch."""
        q_words = jnp.asarray(q_words, dtype=jnp.uint32)
        if q_words.ndim != 2 or q_words.shape[1] != _num_words(self._dimension):
            raise ContractError(
                f"ShardedPackedBinary.knn_batch: query words {q_words.shape} "
                f"don't match dimension {self._dimension}"
            )
        n_q = int(q_words.shape[0])
        if k <= 0 or self.n_true == 0:
            return jnp.zeros((n_q, 0), jnp.uint32), jnp.zeros((n_q, 0), jnp.int32)
        k = min(int(k), self.n_true)
        k_local = _plan_packed(self.n_pad, int(self.mesh.devices.size), k)
        return _sharded_binary_knn(
            q_words, self.words_t, k, k_local, self.n_true, self.mesh
        )


def _local_ternary_topk(qp, qn, pos_shard, neg_shard, n_total, k):
    shard_cols = pos_shard.shape[1]
    base = jax.lax.axis_index(AXIS) * shard_cols
    same = (pos_shard[None] & qp[:, :, None]) | (neg_shard[None] & qn[:, :, None])
    diff = (pos_shard[None] & qn[:, :, None]) | (neg_shard[None] & qp[:, :, None])
    dots = jnp.sum(
        jax.lax.population_count(same).astype(jnp.int32)
        - jax.lax.population_count(diff).astype(jnp.int32),
        axis=1,
    )  # (Q, shard)
    gidx_row = base + jnp.arange(shard_cols, dtype=jnp.int32)
    keys = jnp.where(gidx_row[None, :] < n_total, dots, _INT_MIN)
    top_keys, tidx = jax.lax.top_k(keys, k)
    return top_keys, gidx_row[tidx]


@partial(jax.jit, static_argnames=("k", "k_local", "n_total", "mesh"))
def _sharded_ternary_knn(
    qp, qn, pos_sharded, neg_sharded, k: int, k_local: int, n_total: int,
    mesh: Mesh,
):
    single = qp.ndim == 1
    if single:
        qp, qn = qp[None, :], qn[None, :]
    local = jax.shard_map(
        partial(_local_ternary_topk, n_total=n_total, k=k_local),
        mesh=mesh,
        in_specs=(P(), P(), P(None, AXIS), P(None, AXIS)),
        out_specs=(P(None, AXIS), P(None, AXIS)),
    )
    keys, gidx = local(qp, qn, pos_sharded, neg_sharded)
    merged_keys, pos = jax.lax.top_k(keys, k)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    if single:
        return merged_keys[0], idx[0]
    return merged_keys, idx


class ShardedPackedTernary:
    """An encoded ternary corpus sharded row-wise (word-major planes)."""

    def __init__(self, pos, neg, dimension: int, mesh: Mesh | None = None):
        pos = jnp.asarray(pos, dtype=jnp.uint32)
        neg = jnp.asarray(neg, dtype=jnp.uint32)
        if (
            pos.ndim != 2
            or pos.shape != neg.shape
            or pos.shape[1] != _num_words(dimension)
        ):
            raise ContractError(
                f"ShardedPackedTernary: plane shapes {pos.shape}/{neg.shape} "
                f"don't match dimension {dimension}"
            )
        pos = _mask_padding(pos, dimension)
        neg = _mask_padding(neg, dimension)
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = self.mesh.devices.size
        self.n_true = int(pos.shape[0])
        self._dimension = int(dimension)
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        sharding = NamedSharding(self.mesh, P(None, AXIS))
        self.pos_t = jax.device_put(pad_axis_to(pos, 0, self.n_pad).T, sharding)
        self.neg_t = jax.device_put(pad_axis_to(neg, 0, self.n_pad).T, sharding)

    @classmethod
    def encode(cls, rows, threshold: float, mesh: Mesh | None = None):
        from innr_tpu.ops.ternary import encode_ternary_batch

        rows = jnp.asarray(rows, dtype=jnp.float32)
        pos, neg = encode_ternary_batch(rows, threshold)
        return cls(pos, neg, int(rows.shape[1]), mesh)

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return self._dimension

    def memory_bytes(self) -> int:
        return int(self.pos_t.size + self.neg_t.size) * 4

    def knn(self, query, k: int):
        """Distributed top-k largest ternary dots for one
        :class:`innr_tpu.ops.ternary.PackedTernary` query: returns
        ``(dots descending, global indices)``."""
        if query.dimension != self._dimension:
            raise ContractError(
                f"ShardedPackedTernary.knn: dimension mismatch "
                f"({query.dimension} vs {self._dimension})"
            )
        if k <= 0 or self.n_true == 0:
            return jnp.zeros((0,), jnp.int32), jnp.zeros((0,), jnp.int32)
        k = min(int(k), self.n_true)
        k_local = _plan_packed(self.n_pad, int(self.mesh.devices.size), k)
        return _sharded_ternary_knn(
            query.pos, query.neg, self.pos_t, self.neg_t, k, k_local,
            self.n_true, self.mesh,
        )

    def knn_batch(self, queries, k: int):
        """Multi-query distributed ternary top-k. ``queries``: a
        ``((Q, W) pos, (Q, W) neg)`` plane tuple (e.g. from
        ``encode_ternary_batch``). Returns ``(dots (Q, k), indices)``."""
        qp = jnp.asarray(queries[0], dtype=jnp.uint32)
        qn = jnp.asarray(queries[1], dtype=jnp.uint32)
        if qp.ndim != 2 or qp.shape != qn.shape or qp.shape[1] != _num_words(
            self._dimension
        ):
            raise ContractError(
                f"ShardedPackedTernary.knn_batch: query planes {qp.shape}/"
                f"{qn.shape} don't match dimension {self._dimension}"
            )
        n_q = int(qp.shape[0])
        if k <= 0 or self.n_true == 0:
            return jnp.zeros((n_q, 0), jnp.int32), jnp.zeros((n_q, 0), jnp.int32)
        k = min(int(k), self.n_true)
        k_local = _plan_packed(self.n_pad, int(self.mesh.devices.size), k)
        return _sharded_ternary_knn(
            qp, qn, self.pos_t, self.neg_t, k, k_local, self.n_true,
            self.mesh,
        )
