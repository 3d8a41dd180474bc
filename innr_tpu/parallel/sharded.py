"""Sharded corpus container and distributed kNN merge.

Corpus rows are sharded along the vector axis over a 1-D device mesh
(axis ``"shards"``). A kNN query runs as:

1. per-shard local scan under ``shard_map`` — the same dense scan the
   single-device path runs (:func:`innr_tpu.scan.knn_keys`, on the route
   :mod:`innr_tpu.route` picks for the shard);
2. all-gather of the per-shard (raw int32 total-order key, global index)
   top-k pairs — k values per device, a few hundred bytes;
3. final top-k merge over the ``num_devices * k`` candidates and key
   decode back to f32 scores.

The per-shard selection uses the same integer total-order keys as the
single-chip path, so the distributed result is bit-identical to a
single-chip scan of the concatenated corpus.

Padding: the row axis is padded to a multiple of the mesh size; padded
rows are masked to the INT32_MIN sentinel key after the local top-k, and
each shard fetches ``k + pad_count`` local candidates so padded rows can
never displace genuine winners.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from innr_tpu.route import current_route
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.padding import pad_axis_to, round_up

__all__ = [
    "ShardedCorpus",
    "default_mesh",
    "sharded_knn_dot",
    "sharded_knn_l2",
    "sharded_knn_cosine",
    "sharded_knn_filtered",
]

_INT_MIN = jnp.iinfo(jnp.int32).min

AXIS = "shards"


def default_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name ``"shards"``."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (AXIS,))


from innr_tpu import scan
from innr_tpu.parallel._scan import (
    decode_keys,
    local_scan_keys,
    local_scan_keys_filtered,
)


def _local_topk(qs, rows_shard, aux_shard, n_total, k, mode, route):
    """Per-shard body under shard_map: (Q, shard) local scores -> per-query
    local top-k raw total-order keys (larger = better, every mode) with
    global indices; padded rows masked out. ``aux_shard``: per-row squared
    norms (l2) / guarded inverse norms (cosine), precomputed once per
    corpus and sharded alongside the rows. Shared body:
    :func:`innr_tpu.parallel._scan.local_scan_keys`."""
    base = jax.lax.axis_index(AXIS) * rows_shard.shape[0]
    return local_scan_keys(
        qs, rows_shard, aux_shard, n_total, k, mode, base, route=route
    )


def _local_topk_pruned(qs, rows_shard, aux_shard, cent, rad, cnt, n_total,
                       k, mode, tile_n, route):
    """Per-shard tile-skip body: plan survivors over THIS shard's tile
    summaries and scan only those tiles (:func:`innr_tpu.scan.
    planned_knn_keys`); same key contract as :func:`_local_topk`. The
    summaries count padded rows, and ``k`` includes the pad count, so at
    least the requested number of real rows beat the plan's threshold."""
    base = jax.lax.axis_index(AXIS) * rows_shard.shape[0]
    keys, lidx = scan.planned_knn_keys(qs, rows_shard, aux_shard, cent, rad,
                                       cnt, k, mode, tile_n, route)
    gidx = base + lidx
    return jnp.where(gidx < n_total, keys, _INT_MIN), gidx


@partial(
    jax.jit,
    static_argnames=("k", "k_local", "mode", "n_total", "mesh", "tile_n",
                     "route", "shard_rows"),
)
def _sharded_knn_pruned(
    qs, rows_sharded, aux_sharded, cent, rad, cnt, k: int, k_local: int,
    mode: str, n_total: int, mesh: Mesh, tile_n: int, route: str,
    shard_rows: int,
):
    single = qs.ndim == 1
    if single:
        qs = qs[None, :]
    if mode == "cosine":
        qs = scan.unit_queries(qs)
    has_aux = mode != "dot"
    body = partial(
        _local_topk_pruned, n_total=n_total, k=k_local, mode=mode,
        tile_n=tile_n, route=route,
    )
    if not has_aux:
        body = partial(
            lambda q_, r_, c_, ra_, cn_, f_: f_(q_, r_, None, c_, ra_, cn_),
            f_=body,
        )
    local = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(AXIS, None))
        + ((P(AXIS),) if has_aux else ())
        + (P(AXIS, None), P(AXIS), P(AXIS)),
        out_specs=(P(None, AXIS), P(None, AXIS)),
        check_vma=False,  # a Triton kernel in the body carries no vma info
    )
    args = (qs, rows_sharded) + ((aux_sharded,) if has_aux else ()) + (
        cent, rad, cnt,
    )
    keys, gidx = local(*args)
    merged_keys, pos = jax.lax.top_k(keys, k)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    vals = decode_keys(merged_keys, mode, qs, shard_rows, route)
    if single:
        return vals[0], idx[0]
    return vals, idx


@partial(
    jax.jit,
    static_argnames=("k", "k_local", "mode", "n_total", "mesh", "route",
                     "shard_rows"),
)
def _sharded_knn(
    qs, rows_sharded, aux_sharded, k: int, k_local: int, mode: str,
    n_total: int, mesh: Mesh, route: str, shard_rows: int,
):
    single = qs.ndim == 1
    if single:
        qs = qs[None, :]
    if mode == "cosine":
        qs = scan.unit_queries(qs)
    has_aux = mode != "dot"
    body = partial(
        _local_topk, n_total=n_total, k=k_local, mode=mode, route=route,
    )
    if not has_aux:
        body = partial(lambda q_, r_, f_: f_(q_, r_, None), f_=body)
    local = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(AXIS, None)) + ((P(AXIS),) if has_aux else ()),
        out_specs=(P(None, AXIS), P(None, AXIS)),
        check_vma=False,  # a Triton kernel in the body carries no vma info
    )
    args = (qs, rows_sharded) + ((aux_sharded,) if has_aux else ())
    keys, gidx = local(*args)  # (Q, num_devices * k_local) each
    # Final merge over the gathered candidates (tiny).
    merged_keys, pos = jax.lax.top_k(keys, k)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    vals = decode_keys(merged_keys, mode, qs, shard_rows, route)
    if single:
        return vals[0], idx[0]
    return vals, idx


def _local_topk_filtered(qs, rows_shard, norms_shard, mask_shard, n_total, k,
                         route):
    """Per-shard body for predicate-pushdown L2 kNN: non-passing rows can
    never win (reference src/batch.rs:842-845). ``mask_shard``: (shard,)
    f32 0/1 predicate over this shard's rows (padded rows are 0). Shared
    body: :func:`innr_tpu.parallel._scan.local_scan_keys_filtered`."""
    base = jax.lax.axis_index(AXIS) * rows_shard.shape[0]
    return local_scan_keys_filtered(
        qs, rows_shard, norms_shard, mask_shard, n_total, k, base,
        route=route,
    )


@partial(
    jax.jit,
    static_argnames=("k", "k_local", "n_total", "mesh", "route", "shard_rows"),
)
def _sharded_knn_filtered(
    qs, rows_sharded, norms_sharded, mask_sharded, k: int, k_local: int,
    n_total: int, mesh: Mesh, route: str, shard_rows: int,
):
    single = qs.ndim == 1
    if single:
        qs = qs[None, :]
    local = jax.shard_map(
        partial(
            _local_topk_filtered, n_total=n_total, k=k_local, route=route,
        ),
        mesh=mesh,
        in_specs=(P(), P(AXIS, None), P(AXIS), P(AXIS)),
        out_specs=(P(None, AXIS), P(None, AXIS)),
        check_vma=False,  # a Triton kernel in the body carries no vma info
    )
    keys, gidx = local(qs, rows_sharded, norms_sharded, mask_sharded)
    merged_keys, pos = jax.lax.top_k(keys, k)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    vals = decode_keys(merged_keys, "l2m", qs, shard_rows, route)
    if single:
        return vals[0], idx[0]
    return vals, idx


class ShardedCorpus:
    """An (N, D) corpus sharded row-wise across a device mesh.

    The multi-chip analog of :class:`innr_tpu.batch.VerticalBatch`: rows
    live distributed in per-device memory; queries broadcast; results
    merge across devices. ``num_vectors``/``dimension`` report the true (unpadded)
    corpus shape.
    """

    def __init__(self, rows, mesh: Mesh | None = None, dtype=jnp.float32):
        """``dtype=jnp.bfloat16`` stores the sharded corpus half-precision
        (2 bytes/dim in per-device HBM; see VerticalBatch)."""
        if dtype not in (jnp.float32, jnp.bfloat16):
            raise ContractError("ShardedCorpus: dtype must be float32 or bfloat16")
        rows = jnp.asarray(rows, dtype=dtype)
        if rows.ndim != 2:
            raise ContractError("ShardedCorpus: rows must be 2-D (N, D)")
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = self.mesh.devices.size
        self.n_true = int(rows.shape[0])
        n_pad = round_up(max(self.n_true, n_devices), n_devices)
        self.n_pad = n_pad
        rows = pad_axis_to(rows, 0, n_pad)
        sharding = NamedSharding(self.mesh, P(AXIS, None))
        self.rows = jax.device_put(rows, sharding)
        self._norms2 = None
        self._inv_norms = None
        self._summaries = {}
        self._prune_tile_n = None

    def set_prune_tile_n(self, tile_n) -> "ShardedCorpus":
        """Override the per-shard pruning tile height (see
        ``VerticalBatch.set_prune_tile_n``): corpora whose natural
        cluster size is smaller than the default tile cannot prune; a
        matching tile height restores the planner's elision. Exactness
        never depends on it. ``None`` resets; clears cached summaries."""
        from innr_tpu.prune import default_tile_n

        if tile_n is not None:
            tile_n = int(tile_n)
            if tile_n <= 0:
                raise ContractError(
                    "set_prune_tile_n: tile_n must be positive or None"
                )
            cap = default_tile_n(self.shard_rows, self.dimension,
                                 self.rows.dtype)
            tile_n = min(round_up(tile_n, 128), cap)
        self._prune_tile_n = tile_n
        self._summaries = {}
        return self

    def tile_summary(self, normalized: bool = False):
        """Per-shard tile summaries for the tile-skip planner
        (:mod:`innr_tpu.prune`): each device summarizes its OWN rows under
        shard_map (no gather),
        and the arrays stay sharded alongside the corpus. Returns
        ``(centroids, radii, counts, tile_n)`` with the leading tile axis
        sharded over the mesh."""
        key = bool(normalized)
        if key not in self._summaries:
            from innr_tpu.prune import _summarize, default_tile_n

            tile_n = self._prune_tile_n or default_tile_n(
                self.shard_rows, self.dimension, self.rows.dtype
            )
            body = partial(_summarize, tile_n=tile_n, normalized=normalized)
            cent, rad, cnt = jax.jit(
                jax.shard_map(
                    body,
                    mesh=self.mesh,
                    in_specs=P(AXIS, None),
                    out_specs=(P(AXIS, None), P(AXIS), P(AXIS)),
                    check_vma=False,
                )
            )(self.rows)
            self._summaries[key] = (cent, rad, cnt, tile_n)
        return self._summaries[key]

    def _aux(self, mode: str):
        """Cached per-row norm streams, computed once, sharded with the
        rows (each device reduces its own shard — no gather)."""
        if mode == "l2":
            if self._norms2 is None:
                self._norms2 = scan.sq_norms(self.rows)
            return self._norms2
        if mode == "cosine":
            if self._inv_norms is None:
                self._inv_norms = scan.inv_norms(self.rows)
            return self._inv_norms
        return None

    @classmethod
    def from_row_source(cls, get_rows, num_vectors: int, dimension: int,
                        mesh: Mesh | None = None) -> "ShardedCorpus":
        """Build a sharded corpus WITHOUT materializing it on the host.

        ``get_rows(start, stop)`` returns rows ``[start, stop)`` as a
        ``(stop - start, dimension)`` f32 array — e.g. a ``np.memmap``
        slice over a raw corpus file, or a decoder. Each device's shard is
        fetched independently (disk -> that device's HBM), so a 10M-row
        corpus streams in per-shard pieces. Padding rows (zeros) are
        appended to the final shard and can never win a scan.
        """
        self = cls.__new__(cls)
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = int(self.mesh.devices.size)
        self.n_true = int(num_vectors)
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        sharding = NamedSharding(self.mesh, P(AXIS, None))

        n_true, n_pad = self.n_true, self.n_pad

        def fetch(index):
            sl = index[0]
            start = sl.start or 0
            stop = sl.stop if sl.stop is not None else n_pad
            real_stop = min(stop, n_true)
            # A shard may start at or past n_true (pure padding): its
            # real span is empty, and get_rows is never called for it.
            n_real = max(real_stop - start, 0)
            if n_real > 0:
                block = np.asarray(
                    get_rows(start, real_stop), dtype=np.float32
                )
            else:
                block = np.zeros((0, dimension), np.float32)
            if block.shape != (n_real, dimension):
                raise ContractError(
                    f"from_row_source: get_rows({start}, {real_stop}) "
                    f"returned shape {block.shape}"
                )
            pad = (stop - start) - block.shape[0]
            if pad:
                block = np.concatenate(
                    [block, np.zeros((pad, dimension), np.float32)]
                )
            return block

        self.rows = jax.make_array_from_callback(
            (n_pad, int(dimension)), sharding, fetch
        )
        self._norms2 = None
        self._inv_norms = None
        self._summaries = {}
        self._prune_tile_n = None
        return self

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return int(self.rows.shape[1])

    @property
    def shard_rows(self) -> int:
        return self.n_pad // int(self.mesh.devices.size)

    def memory_bytes(self) -> int:
        return int(self.rows.size) * 4

    def knn_dot(self, query, k: int, prune: bool = False):
        """Distributed MIPS top-k: returns (scores, global indices),
        scores descending (total order). ``prune=True``: on the Triton
        route each shard scans only the tiles its own summaries cannot
        rule out — exact results; other routes run the full scan."""
        return sharded_knn_dot(query, self, k, prune=prune)

    def knn_l2(self, query, k: int, prune: bool = False):
        """Distributed L2^2 top-k: returns (distances, global indices),
        ascending. ``prune=True``: per-shard tile-skip scan."""
        return sharded_knn_l2(query, self, k, prune=prune)

    def knn_cosine(self, query, k: int, prune: bool = False):
        """Distributed cosine top-k: returns (similarities, global
        indices), descending. Zero-norm rows/queries score 0.0.
        ``prune=True``: per-shard tile-skip scan over unit-row bounds."""
        return sharded_knn_cosine(query, self, k, prune=prune)

    def knn_filtered(self, query, k: int, predicate):
        """Distributed L2^2 kNN with predicate pushdown: returns
        (distances ascending, global indices) among passing rows only.
        ``predicate``: an (N,) boolean mask over global row indices, or a
        callable ``index -> bool`` (evaluated on host, as the reference
        does — src/batch.rs:809)."""
        return sharded_knn_filtered(query, self, k, predicate)


def _check(query, corpus: ShardedCorpus, k: int, op: str):
    q = jnp.asarray(query, dtype=jnp.float32)
    if q.ndim not in (1, 2) or q.shape[-1] != corpus.dimension:
        raise ContractError(
            f"innr_tpu::{op}: query shape {q.shape} != dimension "
            f"{corpus.dimension}"
        )
    if k <= 0 or corpus.num_vectors == 0:
        return q, 0
    return q, min(int(k), corpus.num_vectors)


def _empty(q):
    if q.ndim == 2:
        n_q = int(q.shape[0])
        return (jnp.zeros((n_q, 0), jnp.float32), jnp.zeros((n_q, 0), jnp.int32))
    return jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.int32)


def _plan_local_k(corpus: ShardedCorpus, k: int) -> int:
    """Local candidates per shard: ``k`` plus the pad-row count (padding
    is masked after the local top-k, so the over-fetch guarantees k real
    candidates survive), clamped to the shard height."""
    pad = corpus.n_pad - corpus.n_true
    return min(k + pad, corpus.shard_rows)


def _route(q, corpus: ShardedCorpus, k_local: int) -> str:
    n_q = int(q.shape[0]) if q.ndim == 2 else 1
    return current_route("dense", corpus.shard_rows, k_local,
                         corpus.rows.dtype, n_q, corpus.dimension)


def _run(query, corpus: ShardedCorpus, k: int, mode: str, op: str,
         prune: bool = False):
    q, k = _check(query, corpus, k, op)
    if k == 0:
        return _empty(q)
    k_local = _plan_local_k(corpus, k)
    route = _route(q, corpus, k_local)
    if prune and route == "triton":
        from innr_tpu.kernels.triton_knn import SUB_N

        cent, rad, cnt, tile_n = corpus.tile_summary(
            normalized=(mode == "cosine")
        )
        if tile_n % SUB_N == 0:
            return _sharded_knn_pruned(
                q, corpus.rows, corpus._aux(mode), cent, rad, cnt, k,
                k_local, mode, corpus.n_true, corpus.mesh, tile_n, route,
                corpus.shard_rows,
            )
    return _sharded_knn(
        q, corpus.rows, corpus._aux(mode), k, k_local, mode, corpus.n_true,
        corpus.mesh, route, corpus.shard_rows,
    )


def sharded_knn_dot(query, corpus: ShardedCorpus, k: int, prune: bool = False):
    """Distributed batch_knn_dot over a :class:`ShardedCorpus`.

    ``query`` may be (D,) or a (Q, D) batch — all queries share the
    per-shard scan and one collective merge.
    """
    return _run(query, corpus, k, "dot", "sharded_knn_dot", prune=prune)


def sharded_knn_l2(query, corpus: ShardedCorpus, k: int, prune: bool = False):
    """Distributed batch_knn (L2^2) over a :class:`ShardedCorpus`.
    Accepts (D,) or (Q, D) queries."""
    return _run(query, corpus, k, "l2", "sharded_knn_l2", prune=prune)


def sharded_knn_cosine(query, corpus: ShardedCorpus, k: int, prune: bool = False):
    """Distributed batch_knn_cosine over a :class:`ShardedCorpus`.
    Accepts (D,) or (Q, D) queries; zero-norm semantics match the
    single-chip fused path (queries pre-normalize on device)."""
    return _run(query, corpus, k, "cosine", "sharded_knn_cosine", prune=prune)


def sharded_knn_filtered(query, corpus: ShardedCorpus, k: int, predicate):
    """Distributed batch_knn_filtered over a :class:`ShardedCorpus`:
    exact L2^2 kNN restricted to predicate-passing rows, with the mask
    pushed down into each shard's streaming scan.

    ``predicate``: (N,) boolean mask over *global* row indices (the
    device-native form — it shards alongside the rows), or a host callable
    ``index -> bool``. Returns at most ``min(k, num_passing)`` results per
    query; every returned index passes the predicate.
    """
    q, k = _check(query, corpus, k, "sharded_knn_filtered")
    if k == 0:
        return _empty(q)
    n = corpus.num_vectors
    from innr_tpu.parallel._scan import resolve_predicate_mask

    mask, num_passing = resolve_predicate_mask(
        predicate, n, "sharded_knn_filtered"
    )
    if num_passing == 0:
        return _empty(q)
    k = min(k, num_passing)
    mask_f = np.zeros(corpus.n_pad, np.float32)
    mask_f[:n] = mask
    mask_sharded = jax.device_put(
        mask_f, NamedSharding(corpus.mesh, P(AXIS))
    )
    k_local = _plan_local_k(corpus, k)
    return _sharded_knn_filtered(
        q, corpus.rows, corpus._aux("l2"), mask_sharded, k, k_local,
        corpus.n_true, corpus.mesh, _route(q, corpus, k_local),
        corpus.shard_rows,
    )
