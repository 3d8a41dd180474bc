"""Distributed MaxSim (late-interaction) retrieval over a sharded
multi-vector corpus.

Docs shard row-wise as (N, Td, D); each device scores its local docs with
the batched MaxSim einsum (:func:`innr_tpu.ops.maxsim.batch_maxsim`),
selects its local top-k with total-order keys, and the (score, global
index) candidates merge across devices — ColBERT-style retrieval at mesh
scale (reference analog: ``src/maxsim.rs`` is single-pair only).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from innr_tpu.parallel.sharded import AXIS, default_mesh
from innr_tpu.scan import invert_total_key
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.order import total_order_key_f32
from innr_tpu.utils.padding import pad_axis_to, round_up

__all__ = ["ShardedMaxSimCorpus"]

_INT_MIN = jnp.iinfo(jnp.int32).min


def _local_maxsim_topk(q_tokens, docs_shard, mask_shard, n_total, k):
    """Per-shard body. ``q_tokens``: (B, Tq, D) query batch — all queries
    share the shard's doc-token read."""
    shard_rows = docs_shard.shape[0]
    base = jax.lax.axis_index(AXIS) * shard_rows
    from innr_tpu.ops.maxsim import batch_maxsim

    scores = batch_maxsim(q_tokens, docs_shard, doc_mask=mask_shard)
    keys = total_order_key_f32(scores)  # (B, shard)
    gidx_row = base + jnp.arange(shard_rows, dtype=jnp.int32)
    keys = jnp.where(gidx_row[None, :] < n_total, keys, _INT_MIN)
    top_keys, tidx = jax.lax.top_k(keys, k)
    return top_keys, gidx_row[tidx]


@partial(jax.jit, static_argnames=("k", "k_local", "n_total", "mesh"))
def _sharded_maxsim_knn(
    q_tokens, docs_sharded, mask_sharded, k: int, k_local: int, n_total: int,
    mesh: Mesh,
):
    single = q_tokens.ndim == 2
    if single:
        q_tokens = q_tokens[None]
    local = jax.shard_map(
        partial(_local_maxsim_topk, n_total=n_total, k=k_local),
        mesh=mesh,
        in_specs=(P(), P(AXIS, None, None), P(AXIS, None)),
        out_specs=(P(None, AXIS), P(None, AXIS)),
    )
    keys, gidx = local(q_tokens, docs_sharded, mask_sharded)
    merged_keys, pos = jax.lax.top_k(keys, k)
    vals = invert_total_key(merged_keys)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    if single:
        return vals[0], idx[0]
    return vals, idx


class ShardedMaxSimCorpus:
    """An (N, Td, D) multi-vector corpus sharded row-wise across a mesh.

    ``doc_mask`` (N, Td) marks real tokens in ragged documents; padded
    docs/tokens are excluded exactly (empty doc -> score 0.0).
    """

    def __init__(self, docs, doc_mask=None, mesh: Mesh | None = None):
        docs = jnp.asarray(docs, dtype=jnp.float32)
        if docs.ndim != 3:
            raise ContractError(
                "ShardedMaxSimCorpus: docs must be 3-D (N, Td, D)"
            )
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = self.mesh.devices.size
        self.n_true = int(docs.shape[0])
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        if doc_mask is None:
            doc_mask = jnp.ones(docs.shape[:2], dtype=bool)
        else:
            doc_mask = jnp.asarray(doc_mask, dtype=bool)
            if doc_mask.shape != docs.shape[:2]:
                raise ContractError(
                    f"ShardedMaxSimCorpus: doc_mask shape {doc_mask.shape} "
                    f"!= {docs.shape[:2]}"
                )
        docs = pad_axis_to(docs, 0, self.n_pad)
        doc_mask = pad_axis_to(doc_mask, 0, self.n_pad)
        self.docs = jax.device_put(
            docs, NamedSharding(self.mesh, P(AXIS, None, None))
        )
        self.doc_mask = jax.device_put(
            doc_mask, NamedSharding(self.mesh, P(AXIS, None))
        )

    @property
    def num_docs(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return int(self.docs.shape[2])

    def memory_bytes(self) -> int:
        return int(self.docs.size) * 4 + int(self.doc_mask.size)

    def knn(self, query_tokens, k: int):
        """Distributed top-k docs by MaxSim. ``query_tokens``: one (Tq, D)
        token matrix or a (B, Tq, D) batch (all queries share each shard's
        doc-token read). Returns ``(scores descending, global indices)``."""
        q = jnp.asarray(query_tokens, dtype=jnp.float32)
        if q.ndim not in (2, 3) or q.shape[-1] != self.dimension:
            raise ContractError(
                f"ShardedMaxSimCorpus.knn: query shape {q.shape} incompatible "
                f"with dimension {self.dimension}"
            )
        if k <= 0 or self.n_true == 0 or q.shape[-2] == 0:
            if q.ndim == 3:
                b = int(q.shape[0])
                return (
                    jnp.zeros((b, 0), jnp.float32),
                    jnp.zeros((b, 0), jnp.int32),
                )
            return jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.int32)
        k = min(int(k), self.n_true)
        shard_rows = self.n_pad // int(self.mesh.devices.size)
        k_local = min(k, shard_rows)
        return _sharded_maxsim_knn(
            q, self.docs, self.doc_mask, k, k_local, self.n_true, self.mesh,
        )
