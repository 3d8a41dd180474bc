"""Distributed retrieval over a sharded sparse (SPLADE-style) corpus.

Extends the distributed kNN merge to sparse documents: the padded
``(N, L)`` index/value arrays shard row-wise; each device joins the
(replicated, tiny) sparse query into its document rows with the
vectorized binary-search join and selects a local top-k by f32
total-order key; the per-shard (key, global index) pairs merge exactly
as in the dense family. The reference has no corpus-scale sparse search
(``src/sparse.rs`` is pairwise only) — this is the batch form
distributed.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from innr_tpu.ops.sparse import SparseCorpus, _corpus_scores, pad_sparse
from innr_tpu.parallel.sharded import AXIS, default_mesh
from innr_tpu.scan import invert_total_key
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.order import total_order_key_f32
from innr_tpu.utils.padding import pad_axis_to, round_up

__all__ = ["ShardedSparseCorpus", "ShardedSparseMaxSimCorpus"]

_INT_MIN = jnp.iinfo(jnp.int32).min


def _local_sparse_topk(q_idx, q_val, c_idx_shard, c_val_shard, n_total, k):
    shard_rows = c_idx_shard.shape[0]
    base = jax.lax.axis_index(AXIS) * shard_rows
    # Static loop over queries: vmap over searchsorted's sorted side
    # de-vectorizes the join (see ops/sparse._corpus_maxsim_scores).
    scores = jnp.stack(
        [
            _corpus_scores(q_idx[qi], q_val[qi], c_idx_shard, c_val_shard)
            for qi in range(q_idx.shape[0])
        ]
    )  # (Q, shard)
    keys = total_order_key_f32(scores)
    gidx_row = base + jnp.arange(shard_rows, dtype=jnp.int32)
    keys = jnp.where(gidx_row[None, :] < n_total, keys, _INT_MIN)
    top_keys, tidx = jax.lax.top_k(keys, k)
    return top_keys, gidx_row[tidx]


@partial(jax.jit, static_argnames=("k", "k_local", "n_total", "mesh"))
def _sharded_sparse_knn(
    q_idx, q_val, c_idx_sharded, c_val_sharded, k: int, k_local: int,
    n_total: int, mesh: Mesh,
):
    single = q_idx.ndim == 1
    if single:
        q_idx, q_val = q_idx[None, :], q_val[None, :]
    local = jax.shard_map(
        partial(_local_sparse_topk, n_total=n_total, k=k_local),
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS, None), P(AXIS, None)),
        out_specs=(P(None, AXIS), P(None, AXIS)),
    )
    keys, gidx = local(q_idx, q_val, c_idx_sharded, c_val_sharded)
    merged_keys, pos = jax.lax.top_k(keys, k)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    vals = invert_total_key(merged_keys)
    if single:
        return vals[0], idx[0]
    return vals, idx


def _local_sparse_maxsim_topk(q_idx, q_val, d_idx_shard, d_val_shard,
                              d_mask_shard, n_total, k):
    from innr_tpu.ops.sparse import _corpus_maxsim_scores

    shard_rows = d_idx_shard.shape[0]
    base = jax.lax.axis_index(AXIS) * shard_rows
    scores = _corpus_maxsim_scores(
        q_idx, q_val, d_idx_shard, d_val_shard, d_mask_shard
    )  # (shard,)
    keys = total_order_key_f32(scores)[None, :]
    gidx_row = base + jnp.arange(shard_rows, dtype=jnp.int32)
    keys = jnp.where(gidx_row[None, :] < n_total, keys, _INT_MIN)
    top_keys, tidx = jax.lax.top_k(keys, k)
    return top_keys, gidx_row[tidx]


@partial(jax.jit, static_argnames=("k", "k_local", "n_total", "mesh"))
def _sharded_sparse_maxsim(
    q_idx, q_val, d_idx_sharded, d_val_sharded, d_mask_sharded,
    k: int, k_local: int, n_total: int, mesh: Mesh,
):
    local = jax.shard_map(
        partial(_local_sparse_maxsim_topk, n_total=n_total, k=k_local),
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS, None, None), P(AXIS, None, None), P(AXIS, None)),
        out_specs=(P(None, AXIS), P(None, AXIS)),
    )
    keys, gidx = local(q_idx, q_val, d_idx_sharded, d_val_sharded, d_mask_sharded)
    merged_keys, pos = jax.lax.top_k(keys, k)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    return invert_total_key(merged_keys)[0], idx[0]


class ShardedSparseMaxSimCorpus:
    """A padded sparse multi-vector document corpus sharded row-wise:
    distributed SPLADE late interaction (per-shard maxsim scan + exact
    f32 total-order merge)."""

    def __init__(self, docs, mesh: Mesh | None = None):
        """``docs``: list of documents (each a list of ``(indices,
        values)`` token pairs) or a pre-padded ``(idx, val, token_mask)``
        triple from :func:`innr_tpu.ops.sparse.pad_sparse_docs`."""
        from innr_tpu.ops.sparse import SENTINEL_INDEX, pad_sparse_docs

        if isinstance(docs, tuple) and len(docs) == 3:
            idx = jnp.asarray(docs[0], dtype=jnp.uint32)
            val = jnp.asarray(docs[1], dtype=jnp.float32)
            mask = jnp.asarray(docs[2], dtype=bool)
        else:
            idx, val, mask = pad_sparse_docs(docs)
        if idx.ndim != 3 or idx.shape != val.shape or mask.shape != idx.shape[:2]:
            raise ContractError(
                f"ShardedSparseMaxSimCorpus: bad padded shapes "
                f"{idx.shape} / {val.shape} / {mask.shape}"
            )
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = self.mesh.devices.size
        self.n_true = int(idx.shape[0])
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        sharding3 = NamedSharding(self.mesh, P(AXIS, None, None))
        sharding2 = NamedSharding(self.mesh, P(AXIS, None))
        self.indices = jax.device_put(
            pad_axis_to(idx, 0, self.n_pad, value=SENTINEL_INDEX), sharding3
        )
        self.values = jax.device_put(pad_axis_to(val, 0, self.n_pad), sharding3)
        self.token_mask = jax.device_put(
            pad_axis_to(mask, 0, self.n_pad), sharding2
        )

    @property
    def num_docs(self) -> int:
        return self.n_true

    def memory_bytes(self) -> int:
        return int(self.indices.size) * 8 + int(self.token_mask.size)

    def knn(self, query_tokens, k: int):
        """Distributed top-k documents by sparse MaxSim for one sparse
        multi-vector query (list of token pairs or padded (Tq, W) pair):
        returns ``(scores descending, global indices)``."""
        from innr_tpu.ops.sparse import _parse_query_tokens

        # Empty queries pass through as (0, W) pairs: every doc scores 0.0
        # and the top-k is k zero-score results, matching the single-chip
        # sparse_maxsim_knn contract for every input form.
        q_idx, q_val = _parse_query_tokens(query_tokens)
        if k <= 0 or self.n_true == 0:
            return jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.int32)
        k = min(int(k), self.n_true)
        k_local = min(k, self.n_pad // int(self.mesh.devices.size))
        return _sharded_sparse_maxsim(
            q_idx, q_val, self.indices, self.values, self.token_mask,
            k, k_local, self.n_true, self.mesh,
        )


class ShardedSparseCorpus:
    """A padded sparse document corpus sharded row-wise across a mesh."""

    def __init__(self, docs, mesh: Mesh | None = None, width: int | None = None):
        """``docs``: list of ``(indices, values)`` pairs, a pre-padded
        ``((N, L) idx, (N, L) val)`` tuple, or a :class:`SparseCorpus`."""
        if isinstance(docs, SparseCorpus):
            idx, val = docs.indices, docs.values
        else:
            sc = SparseCorpus(docs, width)  # handles pairs/lists/padded
            idx, val = sc.indices, sc.values
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = self.mesh.devices.size
        self.n_true = int(idx.shape[0])
        self._width = int(idx.shape[1])
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        sharding = NamedSharding(self.mesh, P(AXIS, None))
        # Padded doc rows are all-sentinel (value 0): they score 0.0 and
        # are additionally masked out of the merge by the n_total guard.
        from innr_tpu.ops.sparse import SENTINEL_INDEX

        idx = pad_axis_to(idx, 0, self.n_pad, value=SENTINEL_INDEX)
        val = pad_axis_to(val, 0, self.n_pad)
        self.indices = jax.device_put(idx, sharding)
        self.values = jax.device_put(val, sharding)

    @property
    def num_docs(self) -> int:
        return self.n_true

    @property
    def width(self) -> int:
        return self._width

    def memory_bytes(self) -> int:
        return int(self.indices.size) * 8

    def _check_q(self, queries):
        from innr_tpu.ops.sparse import _as_padded_pair

        pair = _as_padded_pair(queries)
        if pair is not None:
            return pair
        if isinstance(queries, tuple) and len(queries) == 2 and not isinstance(
            queries[0], (tuple, list)
        ):
            # single 1-D (indices, values) query
            q_idx = jnp.asarray(queries[0], dtype=jnp.uint32)
            q_val = jnp.asarray(queries[1], dtype=jnp.float32)
            if q_idx.shape != q_val.shape:
                raise ContractError(
                    f"ShardedSparseCorpus: query indices/values mismatch "
                    f"({q_idx.shape} vs {q_val.shape})"
                )
            return q_idx, q_val
        return pad_sparse(queries)

    def _run(self, q_idx, q_val, k: int):
        if k <= 0 or self.n_true == 0:
            if q_idx.ndim == 2:
                n_q = int(q_idx.shape[0])
                return (
                    jnp.zeros((n_q, 0), jnp.float32),
                    jnp.zeros((n_q, 0), jnp.int32),
                )
            return jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.int32)
        k = min(int(k), self.n_true)
        if q_idx.ndim == 2 and int(q_idx.shape[0]) == 0:
            # Empty query batch: (0, k) shapes (the per-query loop in the
            # shard body cannot stack zero results).
            return jnp.zeros((0, k), jnp.float32), jnp.zeros((0, k), jnp.int32)
        k_local = min(k, self.n_pad // int(self.mesh.devices.size))
        return _sharded_sparse_knn(
            q_idx, q_val, self.indices, self.values, k, k_local,
            self.n_true, self.mesh,
        )

    def knn(self, query, k: int):
        """Distributed top-k sparse dots for one ``(indices, values)``
        query: returns ``(scores descending, global indices)``."""
        q_idx, q_val = self._check_q(query)
        if q_idx.ndim != 1:
            raise ContractError(
                "ShardedSparseCorpus.knn: query must be a 1-D pair; use "
                "knn_batch for batches"
            )
        return self._run(q_idx, q_val, k)

    def knn_batch(self, queries, k: int):
        """Multi-query distributed sparse retrieval: padded (Q, W) pair or
        list of pairs -> ``(scores (Q, k), indices (Q, k))``."""
        q_idx, q_val = self._check_q(queries)
        if q_idx.ndim != 2:
            raise ContractError(
                "ShardedSparseCorpus.knn_batch: queries must be 2-D"
            )
        return self._run(q_idx, q_val, k)
