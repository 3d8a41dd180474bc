"""Distributed kNN over a device mesh — the multi-device scaling path the
single-core reference cannot express (survey §2.4 mandate).

Covers the full sharded family: f32 dot/L2/cosine, packed binary, packed
ternary, asymmetric u8, MaxSim late interaction, and the two-stage
coarse->rerank pipeline. Runs on whatever devices are present; to simulate
a pod on CPU:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_search.py
"""

import numpy as np
import jax

import innr_tpu as it
from innr_tpu.parallel import (
    ShardedCorpus,
    ShardedMaxSimCorpus,
    ShardedPackedBinary,
    ShardedPackedTernary,
    ShardedQuantizedU8,
    ShardedTwoStageIndex,
    default_mesh,
)


def main():
    rng = np.random.default_rng(23)
    n, d, k = 100_000, 128, 10
    rows = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal(d).astype(np.float32)

    mesh = default_mesh()
    print(f"mesh: {mesh.devices.size} device(s) on {jax.default_backend()}")

    # f32: distributed MIPS must equal single-host brute force exactly.
    corpus = ShardedCorpus(rows, mesh=mesh)
    vals, idx = corpus.knn_dot(q, k)
    idx = np.asarray(idx)
    brute = np.argsort(-(rows.astype(np.float64) @ q), kind="stable")[:k]
    assert list(idx) == list(brute), "distributed merge must equal brute force"
    print(f"dot    top-{k}: {idx.tolist()}")

    # cosine (multi-query: 4 queries share one mesh-wide scan).
    qs = rows[:4] + 0.01 * rng.standard_normal((4, d)).astype(np.float32)
    cvals, cidx = corpus.knn_cosine(qs, 3)
    cidx = np.asarray(cidx)
    assert list(cidx[:, 0]) == [0, 1, 2, 3], "each query finds its source row"
    print(f"cosine top-3 (4 queries): {cidx.tolist()}")

    # packed binary: 32x less device memory and interconnect traffic for the same corpus.
    packed = ShardedPackedBinary.encode(rows, 0.0, mesh=mesh)
    counts, pidx = packed.knn(it.encode_binary(rows[7], 0.0), 3)
    assert int(np.asarray(pidx)[0]) == 7
    print(f"binary  self-hit at Hamming {int(np.asarray(counts)[0])}, "
          f"memory {packed.memory_bytes() / 2**20:.1f} MB (f32: "
          f"{corpus.memory_bytes() / 2**20:.1f} MB)")

    # packed ternary (16x compression).
    tern = ShardedPackedTernary.encode(rows, 0.5, mesh=mesh)
    tvals, tidx = tern.knn(it.encode_ternary(rows[9], 0.5), 3)
    assert int(np.asarray(tidx)[0]) == 9
    print(f"ternary self-hit with dot {int(np.asarray(tvals)[0])}")

    # asymmetric u8 (4x compression, f32 queries, exact affine scores).
    uq = ShardedQuantizedU8.quantize(rows, mesh=mesh)
    uvals, uidx = uq.knn(q, 3)
    assert set(np.asarray(uidx).tolist()) & set(brute[:3].tolist())
    print(f"u8      top-3: {np.asarray(uidx).tolist()}")

    # MaxSim late-interaction retrieval over a multi-vector corpus.
    docs = rng.standard_normal((5_000, 8, 64)).astype(np.float32)
    sm = ShardedMaxSimCorpus(docs, mesh=mesh)
    mvals, midx = sm.knn(docs[42], 3)
    assert int(np.asarray(midx)[0]) == 42
    print(f"maxsim  self-hit score {float(np.asarray(mvals)[0]):.2f}")

    # two-stage: binary coarse scan -> exact rerank, all sharded.
    ts = ShardedTwoStageIndex(rows, "binary", rerank_factor=4, mesh=mesh)
    svals, sidx = ts.search_batch(rows[:4], 3)
    assert list(np.asarray(sidx)[:, 0]) == [0, 1, 2, 3]
    print(f"2stage  top-3 (4 queries): {np.asarray(sidx).tolist()}")

    # query-parallel serving: corpus replicated, QUERY batch sharded —
    # no merge collective, bit-identical to the single-chip scan.
    from innr_tpu.parallel import QueryParallelIndex

    qp = QueryParallelIndex(rows, mesh=mesh)
    qvals, qidx = qp.knn_dot(rows[:6] + 0.001, 3)
    assert list(np.asarray(qidx)[:, 0]) == list(range(6))
    print(f"query-parallel top-1 (6 queries): {np.asarray(qidx)[:, 0].tolist()}")

    # 2-D composition: corpus shards x query groups on one mesh.
    if len(jax.devices()) >= 4:
        from innr_tpu.parallel import GridIndex, grid_mesh

        gi = GridIndex(rows, grid_mesh(len(jax.devices()) // 2, 2))
        gvals, gidx = gi.knn_dot(rows[:4], 3)
        assert list(np.asarray(gidx)[:, 0]) == [0, 1, 2, 3]
        print(f"2-D grid top-1 (4 queries): {np.asarray(gidx)[:, 0].tolist()}")

    print("OK: full sharded family matches single-host semantics")


if __name__ == "__main__":
    main()
