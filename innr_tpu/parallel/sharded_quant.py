"""Distributed asymmetric u8 search over a sharded quantized corpus.

Codes shard row-wise as uint8 (1 byte/dim in per-device memory — the 4x
bandwidth lever of reference ``src/scalar.rs`` carried to the mesh). Each
device runs the dense u8 scan of :mod:`innr_tpu.scan` (codes are read as
bytes, never widened in memory), selection
merges on raw *mixed* dot keys, and the affine correction
``(alpha/255) * mixed + offset * sum(q)`` applies once after the merge —
a per-query monotone map (alpha > 0), so it cannot change selection.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from innr_tpu.ops.scalar import QuantizationParams, QuantizedU8Batch
from innr_tpu.parallel._scan import local_scan_keys
from innr_tpu.parallel.sharded import AXIS, default_mesh
from innr_tpu.route import current_route
from innr_tpu.scan import invert_total_key
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.padding import pad_axis_to, round_up

__all__ = ["ShardedQuantizedU8"]

_INT_MIN = jnp.iinfo(jnp.int32).min


def _local_u8_topk(qs, codes_shard, n_total, k, route):
    base = jax.lax.axis_index(AXIS) * codes_shard.shape[0]
    return local_scan_keys(qs, codes_shard, None, n_total, k, "dot", base,
                           route=route)


@partial(jax.jit, static_argnames=("k", "k_local", "n_total", "mesh", "route"))
def _sharded_u8_knn(
    qs, codes_sharded, alpha, offset, k: int, k_local: int, n_total: int,
    mesh: Mesh, route: str,
):
    single = qs.ndim == 1
    if single:
        qs = qs[None, :]
    local = jax.shard_map(
        partial(_local_u8_topk, n_total=n_total, k=k_local, route=route),
        mesh=mesh,
        in_specs=(P(), P(AXIS, None)),
        out_specs=(P(None, AXIS), P(None, AXIS)),
        check_vma=False,  # a Triton kernel in the body carries no vma info
    )
    keys, gidx = local(qs, codes_sharded)
    merged_keys, pos = jax.lax.top_k(keys, k)
    mixed = invert_total_key(merged_keys)
    idx = jnp.take_along_axis(gidx, pos, axis=1)
    vals = (alpha / 255.0) * mixed + offset * jnp.sum(qs, axis=1, keepdims=True)
    if single:
        return vals[0], idx[0]
    return vals, idx


class ShardedQuantizedU8:
    """A u8-quantized corpus sharded row-wise across a device mesh."""

    def __init__(self, codes, params: QuantizationParams, mesh: Mesh | None = None):
        codes = jnp.asarray(codes, dtype=jnp.uint8)
        if codes.ndim != 2:
            raise ContractError("ShardedQuantizedU8: codes must be 2-D (N, D)")
        self.params = params
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = self.mesh.devices.size
        self.n_true = int(codes.shape[0])
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        codes = pad_axis_to(codes, 0, self.n_pad)
        self.codes = jax.device_put(
            codes, NamedSharding(self.mesh, P(AXIS, None))
        )

    @classmethod
    def quantize(cls, rows, params: QuantizationParams | None = None,
                 mesh: Mesh | None = None):
        """Quantize an (N, D) f32 corpus and shard it. Fits params from the
        corpus when not given."""
        import numpy as np

        if params is None:
            params = QuantizationParams.fit(np.asarray(rows))
        batch = QuantizedU8Batch.quantize(rows, params)
        return cls(batch.codes, params, mesh)

    @classmethod
    def from_code_source(cls, get_codes, params: QuantizationParams,
                         num_vectors: int, dimension: int,
                         mesh: Mesh | None = None) -> "ShardedQuantizedU8":
        """Stream a pre-quantized corpus in per-shard pieces (no host
        materialization): ``get_codes(start, stop)`` returns code rows
        ``[start, stop)`` as ``(stop - start, D)`` uint8 — e.g. a memmap
        over a ``quantize_u8_host`` file."""
        from innr_tpu.parallel._stream import streamed_array
        import numpy as np

        self = cls.__new__(cls)
        self.params = params
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = int(self.mesh.devices.size)
        self.n_true = int(num_vectors)
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        self.codes = streamed_array(
            get_codes, self.n_true, self.n_pad, int(dimension), np.uint8,
            NamedSharding(self.mesh, P(AXIS, None)), column_major=False,
            name="ShardedQuantizedU8.from_code_source",
        )
        return self

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return int(self.codes.shape[1])

    def memory_bytes(self) -> int:
        return int(self.codes.size)

    def knn(self, query, k: int):
        """Distributed asymmetric top-k: (D,) or (Q, D) f32 queries ->
        ``(scores descending, global indices)``; scores carry the full
        affine correction."""
        q = jnp.asarray(query, dtype=jnp.float32)
        if q.ndim not in (1, 2) or q.shape[-1] != self.dimension:
            raise ContractError(
                f"ShardedQuantizedU8.knn: query shape {q.shape} != dimension "
                f"{self.dimension}"
            )
        if k <= 0 or self.n_true == 0:
            if q.ndim == 2:
                n_q = int(q.shape[0])
                return (
                    jnp.zeros((n_q, 0), jnp.float32),
                    jnp.zeros((n_q, 0), jnp.int32),
                )
            return jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.int32)
        k = min(int(k), self.n_true)
        # Padding is masked after the local top-k: over-fetch by its count.
        pad = self.n_pad - self.n_true
        shard_rows = self.n_pad // int(self.mesh.devices.size)
        k_local = min(k + pad, shard_rows)
        n_q = int(q.shape[0]) if q.ndim == 2 else 1
        route = current_route("dense", shard_rows, k_local, jnp.uint8, n_q,
                              self.dimension)
        return _sharded_u8_knn(
            q, self.codes,
            jnp.float32(self.params.alpha), jnp.float32(self.params.offset),
            k, k_local, self.n_true, self.mesh, route,
        )
