"""Distributed two-stage retrieval: sharded coarse scan -> per-shard exact
rerank -> global merge.

The mesh-scale form of :class:`innr_tpu.pipeline.TwoStageIndex`. Both the
f32 rows and the coarse representation shard row-wise with identical
padding, so each device runs the complete two-stage pipeline over its local
rows inside ONE ``shard_map`` body — coarse candidates never leave the
device; only the final (exact score, global index) top-k pairs cross
devices.

Recall contract: each shard shortlists ``k * rerank_factor`` *local*
candidates (the single-chip index shortlists that many globally), so the
distributed index reranks at least as many candidates as the single-chip
one — recall is monotonically >= the single-chip TwoStageIndex for the
same configuration. Scores of returned results are exact dots, as in the
single-chip index.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from innr_tpu.ops.binary import _pack_bits
from innr_tpu.ops.scalar import QuantizationParams, QuantizedU8Batch
from innr_tpu.ops.ternary import encode_ternary_batch
from innr_tpu import scan
from innr_tpu.parallel.sharded import AXIS, default_mesh
from innr_tpu.pipeline import CoarseConfig
from innr_tpu.route import current_route
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.order import total_order_key_f32
from innr_tpu.utils.padding import pad_axis_to, round_up

__all__ = ["ShardedTwoStageIndex"]

_INT_MIN = jnp.iinfo(jnp.int32).min


def _coarse_local_candidates(qs_enc, coarse_local, kind, n_cand, route):
    """Local coarse shortlist: (Q, n_cand) LOCAL row indices. ``route``
    is the dense scan's route for the u8/matryoshka kinds."""
    if kind == "binary":
        (q_words,) = qs_enc
        (words_t,) = coarse_local
        counts = jnp.sum(
            jax.lax.population_count(
                words_t[None, :, :] ^ q_words[:, :, None]
            ).astype(jnp.int32),
            axis=1,
        )
        _, lidx = jax.lax.top_k(-counts, n_cand)
        return lidx
    if kind == "ternary":
        qp, qn = qs_enc
        pos_t, neg_t = coarse_local
        same = (pos_t[None] & qp[:, :, None]) | (neg_t[None] & qn[:, :, None])
        diff = (pos_t[None] & qn[:, :, None]) | (neg_t[None] & qp[:, :, None])
        dots = jnp.sum(
            jax.lax.population_count(same).astype(jnp.int32)
            - jax.lax.population_count(diff).astype(jnp.int32),
            axis=1,
        )
        _, lidx = jax.lax.top_k(dots, n_cand)
        return lidx
    # u8 / matryoshka: f32-keyed MIPS over the compressed representation.
    (qs,) = qs_enc
    (rep,) = coarse_local
    _, lidx = scan.knn_keys(qs, rep, None, n_cand, "dot", route=route)
    return lidx


def _local_two_stage(qs, rows_shard, *coarse_and_enc, n_total, n_cand, k, kind, route):
    """Per-shard body: coarse shortlist -> exact rerank -> local top-k
    (raw f32 total-order keys + global indices)."""
    n_coarse = {"binary": 1, "ternary": 2, "u8": 1, "matryoshka": 0}[kind]
    coarse_local = coarse_and_enc[:n_coarse]
    qs_enc = coarse_and_enc[n_coarse:]
    if kind == "matryoshka":
        coarse_local = (rows_shard[:, : qs_enc[0].shape[1]],)

    shard_rows = rows_shard.shape[0]
    base = jax.lax.axis_index(AXIS) * shard_rows
    lidx_c = _coarse_local_candidates(qs_enc, coarse_local, kind, n_cand, route)

    from innr_tpu import config

    shortlist = rows_shard[lidx_c]  # (Q, n_cand, D)
    fine = jnp.einsum(
        "qcd,qd->qc", shortlist, qs,
        preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )
    keys = total_order_key_f32(fine)
    gidx_c = base + lidx_c
    keys = jnp.where(gidx_c < n_total, keys, _INT_MIN)
    top_keys, pos = jax.lax.top_k(keys, k)
    return top_keys, jnp.take_along_axis(gidx_c, pos, axis=1)


@partial(
    jax.jit,
    static_argnames=(
        "n_total", "n_cand", "k", "k_local", "kind", "mesh", "n_coarse",
        "route",
    ),
)
def _sharded_two_stage(
    qs, rows_sharded, coarse_arrays, qs_enc, n_total, n_cand, k, k_local,
    kind, mesh, n_coarse, route,
):
    local = jax.shard_map(
        partial(
            _local_two_stage, n_total=n_total, n_cand=n_cand, k=k_local,
            kind=kind, route=route,
        ),
        mesh=mesh,
        in_specs=(
            P(),
            P(AXIS, None),
            *(
                [P(None, AXIS)] * n_coarse
                if kind in ("binary", "ternary")
                else [P(AXIS, None)] * n_coarse
            ),
            *([P()] * len(qs_enc)),
        ),
        out_specs=(P(None, AXIS), P(None, AXIS)),
        check_vma=False,  # a Triton kernel in the body carries no vma info
    )
    keys, gidx = local(qs, rows_sharded, *coarse_arrays, *qs_enc)
    merged_keys, pos = jax.lax.top_k(keys, k)
    return (scan.invert_total_key(merged_keys),
            jnp.take_along_axis(gidx, pos, axis=1))


class ShardedTwoStageIndex:
    """Coarse-quantized scan + exact rerank over a row-sharded corpus."""

    def __init__(self, rows, coarse: CoarseConfig | str = "binary",
                 rerank_factor: int = 4, mesh: Mesh | None = None):
        if isinstance(coarse, str):
            coarse = CoarseConfig(kind=coarse)
        self.config = coarse
        self.rerank_factor = int(rerank_factor)
        if self.rerank_factor < 1:
            raise ContractError("ShardedTwoStageIndex: rerank_factor must be >= 1")
        rows = jnp.asarray(rows, dtype=jnp.float32)
        if rows.ndim != 2:
            raise ContractError("ShardedTwoStageIndex: rows must be 2-D (N, D)")
        self.mesh = mesh if mesh is not None else default_mesh()
        n_devices = self.mesh.devices.size
        self.n_true = int(rows.shape[0])
        self.n_pad = round_up(max(self.n_true, n_devices), n_devices)
        rows_p = pad_axis_to(rows, 0, self.n_pad)
        row_sharding = NamedSharding(self.mesh, P(AXIS, None))
        col_sharding = NamedSharding(self.mesh, P(None, AXIS))
        self.rows = jax.device_put(rows_p, row_sharding)

        kind = coarse.kind
        if kind == "binary":
            words = _pack_bits(rows_p > jnp.float32(coarse.threshold))
            self._coarse = (jax.device_put(words.T, col_sharding),)
        elif kind == "ternary":
            pos, neg = encode_ternary_batch(rows_p, coarse.threshold)
            self._coarse = (
                jax.device_put(pos.T, col_sharding),
                jax.device_put(neg.T, col_sharding),
            )
        elif kind == "u8":
            self.params = (
                QuantizationParams.fit(np.asarray(rows))
                if coarse.quantile >= 1.0
                else QuantizationParams.fit_quantile(
                    np.asarray(rows), coarse.quantile
                )
            )
            codes = QuantizedU8Batch.quantize(rows_p, self.params).codes
            self._coarse = (jax.device_put(codes, row_sharding),)
        elif kind == "matryoshka":
            self._coarse = ()  # prefix slices off self.rows in-shard
        else:
            raise ContractError(
                f"ShardedTwoStageIndex: unknown coarse kind {kind!r}"
            )

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return int(self.rows.shape[1])

    def memory_bytes(self) -> dict:
        fine = int(self.rows.size) * 4
        kind = self.config.kind
        if kind == "matryoshka":
            coarse = 0
        elif kind == "u8":
            coarse = int(self._coarse[0].size)
        else:
            coarse = sum(int(a.size) * 4 for a in self._coarse)
        return {"fine_f32": fine, f"coarse_{kind}": coarse}

    def _encode_queries(self, qs: jax.Array):
        kind = self.config.kind
        if kind == "binary":
            return (_pack_bits(qs > jnp.float32(self.config.threshold)),)
        if kind == "ternary":
            return encode_ternary_batch(qs, self.config.threshold)
        if kind == "u8":
            return (qs,)  # asymmetric: f32 query against u8 codes
        p = min(self.config.prefix_dims, self.dimension)
        return (qs[:, :p],)

    def search(self, query, k: int):
        """Single-query distributed two-stage search ->
        ``(scores descending, global indices)``."""
        vals, idx = self.search_batch(jnp.asarray(query)[None, :], k)
        return vals[0], idx[0]

    def search_batch(self, queries, k: int):
        """(Q, D) queries -> exact-scored (Q, k) results, one shard_map."""
        qs = jnp.asarray(queries, dtype=jnp.float32)
        if qs.ndim != 2 or qs.shape[1] != self.dimension:
            raise ContractError(
                f"ShardedTwoStageIndex.search_batch: queries shape "
                f"{qs.shape} != (Q, {self.dimension})"
            )
        n_q = int(qs.shape[0])
        if self.n_true == 0 or k == 0 or n_q == 0:
            return (
                jnp.zeros((n_q, 0), jnp.float32),
                jnp.zeros((n_q, 0), jnp.int32),
            )
        k = min(int(k), self.n_true)
        shard_rows = self.n_pad // int(self.mesh.devices.size)
        # Per-shard shortlist; at least k so the merge can always fill k
        # results (n_devices * k_local >= k because k <= n_true <= n_pad).
        n_cand = min(max(k * self.rerank_factor, k), shard_rows)
        k_local = min(k, n_cand)
        qs_enc = self._encode_queries(qs)
        kind = self.config.kind
        route = "xla"
        if kind in ("u8", "matryoshka"):
            rep_dtype = jnp.uint8 if kind == "u8" else jnp.float32
            width = qs_enc[0].shape[1]
            route = current_route("dense", shard_rows, n_cand, rep_dtype, n_q,
                                  width)
        return _sharded_two_stage(
            qs, self.rows, self._coarse, qs_enc, self.n_true, n_cand, k,
            k_local, kind, self.mesh, len(self._coarse), route,
        )
