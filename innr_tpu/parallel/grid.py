"""2-D mesh composition: corpus sharding x query data-parallelism.

When both the corpus and the query stream outgrow one device, the mesh
factorizes: axis ``"shards"`` partitions corpus rows (as
:class:`~innr_tpu.parallel.sharded.ShardedCorpus`), axis ``"queries"``
partitions the query batch (as
:class:`~innr_tpu.parallel.query_parallel.QueryParallelIndex`). Each
device holds one (query-slice x corpus-shard) block, runs the dense
scan on it, and the per-shard top-k candidates merge ONLY
along the ``"shards"`` axis — the ``"queries"`` axis never communicates.
Interconnect traffic per query stays k pairs per corpus shard, independent of the
query-parallel degree.

This is the standard 2-D decomposition (data-parallel x model/tensor-
parallel) of the scaling playbook applied to retrieval: pick the
``shards`` degree from per-device HBM (corpus bytes), then spend the
remaining mesh on query throughput.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from innr_tpu import scan
from innr_tpu.parallel._scan import (
    decode_keys,
    local_scan_keys,
    local_scan_keys_filtered,
)
from innr_tpu.route import current_route
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.padding import pad_axis_to, round_up

__all__ = ["GridIndex", "grid_mesh"]

CORPUS_AXIS = "shards"
QUERY_AXIS = "queries"


def grid_mesh(corpus_shards: int, query_shards: int, devices=None) -> Mesh:
    """A (queries, shards) 2-D mesh over ``corpus_shards * query_shards``
    devices. Corpus shards ride the minor axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    need = corpus_shards * query_shards
    if devices.size < need:
        raise ContractError(
            f"grid_mesh: need {need} devices, have {devices.size}"
        )
    grid = devices.reshape(-1)[:need].reshape(query_shards, corpus_shards)
    return Mesh(grid, (QUERY_AXIS, CORPUS_AXIS))


def _local_grid_topk(qs_block, rows_shard, aux_shard, n_total, k, mode, route):
    """Per-device body: this device's query slice x corpus shard. Shared
    body: :func:`innr_tpu.parallel._scan.local_scan_keys`."""
    base = jax.lax.axis_index(CORPUS_AXIS) * rows_shard.shape[0]
    return local_scan_keys(
        qs_block, rows_shard, aux_shard, n_total, k, mode, base, route=route
    )


@partial(
    jax.jit,
    static_argnames=("k", "k_local", "mode", "n_total", "mesh", "route",
                     "shard_rows"),
)
def _grid_knn(
    qs_sharded, rows_sharded, aux_sharded, k: int, k_local: int, mode: str,
    n_total: int, mesh: Mesh, route: str, shard_rows: int,
):
    if mode == "cosine":
        qs_sharded = scan.unit_queries(qs_sharded)
    has_aux = mode != "dot"
    body = partial(
        _local_grid_topk, n_total=n_total, k=k_local, mode=mode, route=route,
    )
    if not has_aux:
        body = partial(lambda q_, r_, f_: f_(q_, r_, None), f_=body)
    local = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(QUERY_AXIS, None), P(CORPUS_AXIS, None))
        + ((P(CORPUS_AXIS),) if has_aux else ()),
        out_specs=(P(QUERY_AXIS, CORPUS_AXIS), P(QUERY_AXIS, CORPUS_AXIS)),
        check_vma=False,  # a Triton kernel in the body carries no vma info
    )
    args = (qs_sharded, rows_sharded) + ((aux_sharded,) if has_aux else ())
    keys, gidx = local(*args)  # (Q_pad, corpus_shards * k_local)
    merged_keys, pos = jax.lax.top_k(keys, k)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    vals = decode_keys(merged_keys, mode, qs_sharded, shard_rows, route)
    return vals, idx


def _local_grid_filtered(qs_block, rows_shard, norms_shard, mask_shard,
                         n_total, k, route):
    base = jax.lax.axis_index(CORPUS_AXIS) * rows_shard.shape[0]
    return local_scan_keys_filtered(
        qs_block, rows_shard, norms_shard, mask_shard, n_total, k, base,
        route=route,
    )


@partial(
    jax.jit,
    static_argnames=("k", "k_local", "n_total", "mesh", "route", "shard_rows"),
)
def _grid_knn_filtered(
    qs_sharded, rows_sharded, norms_sharded, mask_sharded, k: int,
    k_local: int, n_total: int, mesh: Mesh, route: str, shard_rows: int,
):
    local = jax.shard_map(
        partial(
            _local_grid_filtered, n_total=n_total, k=k_local, route=route,
        ),
        mesh=mesh,
        in_specs=(P(QUERY_AXIS, None), P(CORPUS_AXIS, None),
                  P(CORPUS_AXIS), P(CORPUS_AXIS)),
        out_specs=(P(QUERY_AXIS, CORPUS_AXIS), P(QUERY_AXIS, CORPUS_AXIS)),
        check_vma=False,  # a Triton kernel in the body carries no vma info
    )
    keys, gidx = local(qs_sharded, rows_sharded, norms_sharded, mask_sharded)
    merged_keys, pos = jax.lax.top_k(keys, k)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    vals = decode_keys(merged_keys, "l2m", qs_sharded, shard_rows, route)
    return vals, idx


class GridIndex:
    """An (N, D) corpus on a 2-D (queries x shards) mesh: corpus rows
    shard along ``"shards"``, query batches shard along ``"queries"``,
    top-k merges only across corpus shards."""

    def __init__(self, rows, mesh: Mesh, dtype=jnp.float32):
        if set(mesh.axis_names) != {QUERY_AXIS, CORPUS_AXIS}:
            raise ContractError(
                f"GridIndex: mesh must have axes ({QUERY_AXIS!r}, "
                f"{CORPUS_AXIS!r}) — build one with grid_mesh()"
            )
        if dtype not in (jnp.float32, jnp.bfloat16):
            raise ContractError("GridIndex: dtype must be float32 or bfloat16")
        rows = jnp.asarray(rows, dtype=dtype)
        if rows.ndim != 2:
            raise ContractError("GridIndex: rows must be 2-D (N, D)")
        self.mesh = mesh
        self.n_shards = int(mesh.shape[CORPUS_AXIS])
        self.n_qgroups = int(mesh.shape[QUERY_AXIS])
        self.n_true = int(rows.shape[0])
        self.n_pad = round_up(max(self.n_true, self.n_shards), self.n_shards)
        rows = pad_axis_to(rows, 0, self.n_pad)
        # Sharded over corpus shards, replicated over query groups.
        self.rows = jax.device_put(
            rows, NamedSharding(self.mesh, P(CORPUS_AXIS, None))
        )
        self._norms2 = None
        self._inv_norms = None

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return int(self.rows.shape[1])

    def memory_bytes(self) -> int:
        itemsize = 2 if self.rows.dtype == jnp.bfloat16 else 4
        return int(self.rows.size) * itemsize

    def _aux(self, mode: str):
        if mode == "l2":
            if self._norms2 is None:
                self._norms2 = scan.sq_norms(self.rows)
            return self._norms2
        if mode == "cosine":
            if self._inv_norms is None:
                self._inv_norms = scan.inv_norms(self.rows)
            return self._inv_norms
        return None

    def _plan(self, k: int, q_pad: int):
        """``(shard_rows, k_local, route)``: each block over-fetches by the
        pad-row count (padding is masked after the local top-k)."""
        pad = self.n_pad - self.n_true
        shard_rows = self.n_pad // self.n_shards
        k_local = min(k + pad, shard_rows)
        route = current_route("dense", shard_rows, k_local, self.rows.dtype,
                              q_pad // self.n_qgroups, self.dimension)
        return shard_rows, k_local, route

    def _run(self, queries, k: int, mode: str, op: str):
        qs = jnp.asarray(queries, dtype=jnp.float32)
        if qs.ndim != 2 or qs.shape[1] != self.dimension:
            raise ContractError(
                f"innr_tpu::{op}: queries must be (Q, {self.dimension}), "
                f"got {qs.shape}"
            )
        n_q = int(qs.shape[0])
        if k <= 0 or self.n_true == 0:
            return (
                jnp.zeros((n_q, 0), jnp.float32),
                jnp.zeros((n_q, 0), jnp.int32),
            )
        k = min(int(k), self.n_true)
        q_pad = round_up(max(n_q, self.n_qgroups), self.n_qgroups)
        qs_p = pad_axis_to(qs, 0, q_pad)
        qs_sharded = jax.device_put(
            qs_p, NamedSharding(self.mesh, P(QUERY_AXIS, None))
        )
        shard_rows, k_local, route = self._plan(k, q_pad)
        vals, idx = _grid_knn(
            qs_sharded, self.rows, self._aux(mode), k, k_local, mode,
            self.n_true, self.mesh, route, shard_rows,
        )
        return vals[:n_q], idx[:n_q]

    def knn_dot(self, queries, k: int):
        """2-D-parallel MIPS over the grid: (Q, D) -> (scores (Q, k)
        descending, global indices)."""
        return self._run(queries, k, "dot", "grid_knn_dot")

    def knn_l2(self, queries, k: int):
        """2-D-parallel L2^2 kNN (ascending)."""
        return self._run(queries, k, "l2", "grid_knn_l2")

    def knn_cosine(self, queries, k: int):
        """2-D-parallel cosine kNN; zero-norm semantics as single-chip."""
        return self._run(queries, k, "cosine", "grid_knn_cosine")

    def knn_filtered(self, queries, k: int, predicate):
        """2-D-parallel predicate-pushdown L2^2 kNN: the (N,) global mask
        shards along the corpus axis (replicated over query groups) and
        pushes into each block's streaming scan. ``predicate``: boolean
        mask over global row indices, or a host callable ``index -> bool``.
        Returns at most ``min(k, num_passing)`` results per query."""
        qs = jnp.asarray(queries, dtype=jnp.float32)
        if qs.ndim != 2 or qs.shape[1] != self.dimension:
            raise ContractError(
                f"innr_tpu::grid_knn_filtered: queries must be "
                f"(Q, {self.dimension}), got {qs.shape}"
            )
        n = self.n_true
        n_q = int(qs.shape[0])
        from innr_tpu.parallel._scan import resolve_predicate_mask

        mask, num_passing = resolve_predicate_mask(
            predicate, n, "grid_knn_filtered"
        )
        if k <= 0 or n == 0 or num_passing == 0:
            return (
                jnp.zeros((n_q, 0), jnp.float32),
                jnp.zeros((n_q, 0), jnp.int32),
            )
        k = min(int(k), num_passing)
        mask_f = np.zeros(self.n_pad, np.float32)
        mask_f[:n] = mask
        mask_sharded = jax.device_put(
            mask_f, NamedSharding(self.mesh, P(CORPUS_AXIS))
        )
        q_pad = round_up(max(n_q, self.n_qgroups), self.n_qgroups)
        qs_sharded = jax.device_put(
            pad_axis_to(qs, 0, q_pad),
            NamedSharding(self.mesh, P(QUERY_AXIS, None)),
        )
        shard_rows, k_local, route = self._plan(k, q_pad)
        vals, idx = _grid_knn_filtered(
            qs_sharded, self.rows, self._aux("l2"), mask_sharded, k,
            k_local, self.n_true, self.mesh, route, shard_rows,
        )
        return vals[:n_q], idx[:n_q]
