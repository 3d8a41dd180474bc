"""Two-level (ICI x DCN) sharded corpus with a hierarchical top-k merge.

:class:`innr_tpu.parallel.sharded.ShardedCorpus` merges with ONE
collective hop: every device all-gathers ``num_devices * k_local``
candidates. Within a single ICI-connected slice that is the right call —
the payload is a few KB on a fast fabric. Across
DCN-connected slices (multi-pod), shipping every device's candidates to
every other device wastes the thin inter-slice links.

:class:`HierarchicalCorpus` shards rows over a 2-D mesh
``(dcn: n_slices, ici: devices_per_slice)`` and merges in two stages
(SURVEY.md §5.8):

1. **within-slice over ICI**: all-gather the per-device (key, index)
   top-k pairs along the ``ici`` axis only, reduce to the slice's top-k —
   DCN carries nothing;
2. **across slices over DCN**: all-gather ONE top-k list per slice along
   the ``dcn`` axis (payload ``n_slices * k`` instead of
   ``n_slices * ici * k_local``), final top-k.

Raw int32 total-order keys flow through both hops undecoded, and every
selection breaks ties toward the lower global index, so the result is
bit-identical to the flat single-hop merge and to a single-chip scan of
the concatenated corpus (asserted in tests/test_sharded.py).

On hardware with real DCN topology, lay the mesh out so the ``dcn`` axis
maps to the slice boundary (``jax.experimental.mesh_utils.
create_hybrid_device_mesh``); on a CPU test mesh any (n_slices, per_slice)
factorization exercises the same program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from innr_tpu import scan
from innr_tpu.parallel._scan import decode_keys, local_scan_keys
from innr_tpu.route import current_route
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.padding import pad_axis_to, round_up

__all__ = ["HierarchicalCorpus", "hierarchical_mesh"]

_INT_MIN = jnp.iinfo(jnp.int32).min

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def hierarchical_mesh(n_slices: int, per_slice: int | None = None,
                      devices=None) -> Mesh:
    """A (dcn: n_slices, ici: per_slice) mesh over the given devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if per_slice is None:
        if devices.size % n_slices:
            raise ContractError(
                f"hierarchical_mesh: {devices.size} devices not divisible "
                f"into {n_slices} slices"
            )
        per_slice = devices.size // n_slices
    return Mesh(
        devices.reshape(n_slices, per_slice), (DCN_AXIS, ICI_AXIS)
    )


def _topk_keys(keys, gidx, k):
    """Top-k by (key desc, global index asc) — the shared tie discipline,
    via one two-key sort (ascending ~key, then ascending index), exactly
    the dense scan's tie order. No int64 composite: default jax
    would silently demote it."""
    skeys, sgidx = jax.lax.sort((~keys, gidx), dimension=-1, num_keys=2)
    return ~skeys[:, :k], sgidx[:, :k]


def _local_body(qs, rows_shard, aux_shard, n_total, k_local, k, mode,
                route):
    """Per-device body under shard_map on the (dcn, ici) mesh."""
    slice_id = jax.lax.axis_index(DCN_AXIS)
    dev_id = jax.lax.axis_index(ICI_AXIS)
    base = (slice_id * jax.lax.axis_size(ICI_AXIS) + dev_id) * rows_shard.shape[0]
    keys, gidx = local_scan_keys(
        qs, rows_shard, aux_shard, n_total, k_local, mode, base, route=route
    )
    # Stage 1 — within-slice merge over ICI only (nothing crosses DCN).
    keys_s = jax.lax.all_gather(keys, ICI_AXIS, axis=1, tiled=True)
    gidx_s = jax.lax.all_gather(gidx, ICI_AXIS, axis=1, tiled=True)
    keys1, gidx1 = _topk_keys(keys_s, gidx_s, k)
    # Stage 2 — across slices over DCN: k candidates per slice. Payload
    # contract (SURVEY.md §5.8): each slice ships exactly k pairs, so the
    # gathered width is n_slices * k — NEVER n_slices * ici * k_local.
    # Static-shape asserts make a regression fail at trace time.
    assert keys1.shape[-1] == k, (keys1.shape, k)
    keys_d = jax.lax.all_gather(keys1, DCN_AXIS, axis=1, tiled=True)
    gidx_d = jax.lax.all_gather(gidx1, DCN_AXIS, axis=1, tiled=True)
    assert keys_d.shape[-1] == jax.lax.axis_size(DCN_AXIS) * k, keys_d.shape
    return _topk_keys(keys_d, gidx_d, k)


@partial(
    jax.jit,
    static_argnames=("k", "k_local", "mode", "n_total", "mesh", "route",
                     "shard_rows"),
)
def _hier_knn(qs, rows_sharded, aux_sharded, k, k_local, mode, n_total,
              mesh: Mesh, route, shard_rows):
    single = qs.ndim == 1
    if single:
        qs = qs[None, :]
    if mode == "cosine":
        qs = scan.unit_queries(qs)
    has_aux = mode != "dot"
    body = partial(
        _local_body, n_total=n_total, k_local=k_local, k=k, mode=mode,
        route=route,
    )
    if not has_aux:
        body = partial(lambda q_, r_, f_: f_(q_, r_, None), f_=body)
    local = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P((DCN_AXIS, ICI_AXIS), None))
        + ((P((DCN_AXIS, ICI_AXIS)),) if has_aux else ()),
        out_specs=(P(), P()),  # replicated final result
        check_vma=False,
    )
    args = (qs, rows_sharded) + ((aux_sharded,) if has_aux else ())
    keys, gidx = local(*args)
    vals = decode_keys(keys, mode, qs, shard_rows, route)
    if single:
        return vals[0], gidx[0]
    return vals, gidx


class HierarchicalCorpus:
    """An (N, D) corpus sharded over a 2-level (dcn x ici) mesh with the
    two-stage top-k merge. API mirrors :class:`ShardedCorpus`."""

    def __init__(self, rows, mesh: Mesh | None = None, n_slices: int = 2,
                 dtype=jnp.float32):
        if dtype not in (jnp.float32, jnp.bfloat16):
            raise ContractError(
                "HierarchicalCorpus: dtype must be float32 or bfloat16"
            )
        rows = jnp.asarray(rows, dtype=dtype)
        if rows.ndim != 2:
            raise ContractError("HierarchicalCorpus: rows must be 2-D (N, D)")
        self.mesh = mesh if mesh is not None else hierarchical_mesh(n_slices)
        if tuple(self.mesh.axis_names) != (DCN_AXIS, ICI_AXIS):
            raise ContractError(
                "HierarchicalCorpus: mesh axes must be ('dcn', 'ici')"
            )
        n_devices = int(self.mesh.devices.size)
        self.n_true = int(rows.shape[0])
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        rows = pad_axis_to(rows, 0, self.n_pad)
        sharding = NamedSharding(self.mesh, P((DCN_AXIS, ICI_AXIS), None))
        self.rows = jax.device_put(rows, sharding)
        self._norms2 = None
        self._inv_norms = None

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
        return int(self.rows.size) * self.rows.dtype.itemsize

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

    def _run(self, query, k: int, mode: str, op: str):
        q = jnp.asarray(query, dtype=jnp.float32)
        if q.ndim not in (1, 2) or q.shape[-1] != self.dimension:
            raise ContractError(
                f"innr_tpu::{op}: query shape {q.shape} != dimension "
                f"{self.dimension}"
            )
        if k <= 0 or self.num_vectors == 0:
            if q.ndim == 2:
                n_q = int(q.shape[0])
                return (
                    jnp.zeros((n_q, 0), jnp.float32),
                    jnp.zeros((n_q, 0), jnp.int32),
                )
            return jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.int32)
        k = min(int(k), self.num_vectors)
        # Padding is masked after the local top-k: over-fetch by its count.
        pad = self.n_pad - self.n_true
        k_local = min(k + pad, self.shard_rows)
        n_q = int(q.shape[0]) if q.ndim == 2 else 1
        route = current_route("dense", self.shard_rows, k_local,
                              self.rows.dtype, n_q, self.dimension)
        return _hier_knn(
            q, self.rows, self._aux(mode), k, k_local, mode, self.n_true,
            self.mesh, route, self.shard_rows,
        )

    def knn_dot(self, query, k: int):
        """Two-level distributed MIPS top-k (scores descending, global
        indices) — bit-identical to the flat merge."""
        return self._run(query, k, "dot", "hierarchical_knn_dot")

    def knn_l2(self, query, k: int):
        """Two-level distributed L2^2 top-k (ascending)."""
        return self._run(query, k, "l2", "hierarchical_knn_l2")

    def knn_cosine(self, query, k: int):
        """Two-level distributed cosine top-k (descending)."""
        return self._run(query, k, "cosine", "hierarchical_knn_cosine")
