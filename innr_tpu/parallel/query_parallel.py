"""Query-parallel kNN: shard the QUERY batch across the mesh, replicate
the corpus.

The complement of :class:`~innr_tpu.parallel.sharded.ShardedCorpus`
(which shards corpus rows): when the corpus fits in one device's HBM but
the query stream is large, the right mesh decomposition is data-parallel
over queries — each device runs the multi-query scan on its query
slice against its local corpus replica, and results concatenate with NO
collective at all (each query's top-k is complete locally). Throughput
scales linearly with mesh size; there is no merge step to pay.

Rule of thumb (serving guide): corpus >> per-device HBM -> ShardedCorpus;
corpus small + high QPS -> query_parallel; both large -> 2-D mesh (shard
corpus, then query-parallel within each replica group) — compose these
two primitives.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from innr_tpu import scan
from innr_tpu.parallel._scan import (
    decode_keys,
    local_scan_keys,
    local_scan_keys_filtered,
)
import numpy as np
from innr_tpu.parallel.sharded import AXIS, default_mesh
from innr_tpu.route import current_route
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.padding import pad_axis_to, round_up

__all__ = ["QueryParallelIndex"]


def _local_scan(qs, rows, norms2, inv_norms, k, mode, route):
    """Per-device body: this device's (Qs, D) query slice against the full
    replicated corpus. Shared scan body
    (:func:`innr_tpu.parallel._scan.local_scan_keys`) with base 0 and no
    padded rows; keys decode locally since there is no merge step."""
    aux = {"dot": None, "l2": norms2, "cosine": inv_norms}[mode]
    keys, idx = local_scan_keys(
        qs, rows, aux, rows.shape[0], k, mode, 0, route=route
    )
    return decode_keys(keys, mode, qs, rows.shape[0], route), idx


def _local_scan_filtered(qs, rows, norms2, mask, k, route):
    keys, idx = local_scan_keys_filtered(
        qs, rows, norms2, mask, rows.shape[0], k, 0, route=route
    )
    return decode_keys(keys, "l2m", qs, rows.shape[0], route), idx


@partial(jax.jit, static_argnames=("k", "mesh", "route"))
def _qp_knn_filtered(qs_sharded, rows, norms2, mask, k, mesh, route):
    body = partial(_local_scan_filtered, k=k, route=route)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(AXIS, None), P(), P(), P()),
        out_specs=(P(AXIS, None), P(AXIS, None)),
        check_vma=False,  # a Triton kernel in the body carries no vma info
    )(qs_sharded, rows, norms2, mask)


@partial(jax.jit, static_argnames=("k", "mode", "mesh", "route"))
def _qp_knn(qs_sharded, rows, norms2, inv_norms, k, mode, mesh, route):
    body = partial(_local_scan, k=k, mode=mode, route=route)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(AXIS, None), P(), P(), P()),
        out_specs=(P(AXIS, None), P(AXIS, None)),
        check_vma=False,  # a Triton kernel in the body carries no vma info
    )(qs_sharded, rows, norms2, inv_norms)


class QueryParallelIndex:
    """A replicated (N, D) corpus serving query batches sharded across the
    mesh. ``knn_dot`` / ``knn_l2`` / ``knn_cosine`` accept (Q, D) batches;
    each device scans its Q/num_devices slice with the dense scan of
    :mod:`innr_tpu.scan`. Results equal the single-device scan (same
    route, same corpus)."""

    def __init__(self, rows, mesh: Mesh | None = None, dtype=jnp.float32):
        if dtype not in (jnp.float32, jnp.bfloat16):
            raise ContractError(
                "QueryParallelIndex: dtype must be float32 or bfloat16"
            )
        rows = jnp.asarray(rows, dtype=dtype)
        if rows.ndim != 2:
            raise ContractError("QueryParallelIndex: rows must be 2-D (N, D)")
        self.mesh = mesh if mesh is not None else default_mesh()
        replicated = NamedSharding(self.mesh, P())
        self.rows = jax.device_put(rows, replicated)
        self._norms2 = None
        self._inv_norms = None

    def _aux_norms2(self):
        """Lazy replicated per-row squared norms (the family's _aux
        pattern): dot-only workloads never pay the reduction or the
        replicated HBM."""
        if self._norms2 is None:
            self._norms2 = jax.device_put(
                scan.sq_norms(self.rows), NamedSharding(self.mesh, P()))
        return self._norms2

    def _aux_inv_norms(self):
        if self._inv_norms is None:
            self._inv_norms = jax.device_put(
                scan.inv_norms(self.rows),
                NamedSharding(self.mesh, P()),
            )
        return self._inv_norms

    @property
    def num_vectors(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.rows.shape[1])

    def memory_bytes(self) -> int:
        # Per-device replica footprint (rows + any materialized norm cache).
        itemsize = 2 if self.rows.dtype == jnp.bfloat16 else 4
        total = int(self.rows.size) * itemsize
        for aux in (self._norms2, self._inv_norms):
            if aux is not None:
                total += int(aux.size) * 4
        return total

    def _run(self, queries, k: int, mode: str, op: str):
        qs = jnp.asarray(queries, dtype=jnp.float32)
        if qs.ndim != 2 or qs.shape[1] != self.dimension:
            raise ContractError(
                f"innr_tpu::{op}: queries must be (Q, {self.dimension}), "
                f"got {qs.shape}"
            )
        n = self.num_vectors
        n_q = int(qs.shape[0])
        if k <= 0 or n == 0:
            return (
                jnp.zeros((n_q, 0), jnp.float32),
                jnp.zeros((n_q, 0), jnp.int32),
            )
        k = min(int(k), n)
        n_devices = int(self.mesh.devices.size)
        q_pad = round_up(max(n_q, n_devices), n_devices)
        qs_p = pad_axis_to(qs, 0, q_pad)
        if mode == "cosine":
            qs_p = scan.unit_queries(qs_p)
        qs_sharded = jax.device_put(
            qs_p, NamedSharding(self.mesh, P(AXIS, None))
        )
        route = current_route("dense", n, k, self.rows.dtype,
                              q_pad // n_devices, self.dimension)
        # Only the mode's aux stream is materialized; the other leg gets a
        # tiny dummy (the static mode branch never traces a use of it).
        dummy = jnp.zeros((1,), jnp.float32)
        norms2 = self._aux_norms2() if mode == "l2" else dummy
        inv = self._aux_inv_norms() if mode == "cosine" else dummy
        vals, idx = _qp_knn(
            qs_sharded, self.rows, norms2, inv, k, mode, self.mesh, route,
        )
        return vals[:n_q], idx[:n_q]

    def knn_dot(self, queries, k: int):
        """Data-parallel MIPS: (Q, D) -> (scores (Q, k) descending,
        indices); queries shard over the mesh, corpus replicated."""
        return self._run(queries, k, "dot", "query_parallel_knn_dot")

    def knn_l2(self, queries, k: int):
        """Data-parallel L2^2 kNN: distances ascending."""
        return self._run(queries, k, "l2", "query_parallel_knn_l2")

    def knn_cosine(self, queries, k: int):
        """Data-parallel cosine kNN: zero-norm semantics match the
        single-chip fused path."""
        return self._run(queries, k, "cosine", "query_parallel_knn_cosine")

    def knn_filtered(self, queries, k: int, predicate):
        """Data-parallel predicate-pushdown L2^2 kNN: the (N,) mask
        replicates with the corpus; queries shard. ``predicate``: boolean
        mask over row indices, or a host callable ``index -> bool``.
        Returns at most ``min(k, num_passing)`` results per query."""
        qs = jnp.asarray(queries, dtype=jnp.float32)
        if qs.ndim != 2 or qs.shape[1] != self.dimension:
            raise ContractError(
                f"innr_tpu::query_parallel_knn_filtered: queries must be "
                f"(Q, {self.dimension}), got {qs.shape}"
            )
        n = self.num_vectors
        n_q = int(qs.shape[0])
        from innr_tpu.parallel._scan import resolve_predicate_mask

        mask, num_passing = resolve_predicate_mask(
            predicate, n, "query_parallel_knn_filtered"
        )
        if k <= 0 or n == 0 or num_passing == 0:
            return (
                jnp.zeros((n_q, 0), jnp.float32),
                jnp.zeros((n_q, 0), jnp.int32),
            )
        k = min(int(k), num_passing)
        n_devices = int(self.mesh.devices.size)
        q_pad = round_up(max(n_q, n_devices), n_devices)
        qs_sharded = jax.device_put(
            pad_axis_to(qs, 0, q_pad),
            NamedSharding(self.mesh, P(AXIS, None)),
        )
        mask_rep = jax.device_put(
            mask.astype(np.float32), NamedSharding(self.mesh, P())
        )
        route = current_route("dense", n, k, self.rows.dtype,
                              q_pad // n_devices, self.dimension)
        vals, idx = _qp_knn_filtered(
            qs_sharded, self.rows, self._aux_norms2(), mask_rep, k,
            self.mesh, route,
        )
        return vals[:n_q], idx[:n_q]
