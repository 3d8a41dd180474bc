"""Production-serving showcase: every throughput lever in one flow.

Demonstrates the rules from docs/GUIDE.md "Serving patterns":
batched queries (one corpus pass per batch), bf16 half-precision corpora,
predicate pushdown, late-interaction retrieval with a query batch, and a
two-stage pipeline — each asserting correctness against brute force.
"""

import time

import numpy as np

import jax
import jax.numpy as jnp

import innr_tpu as it


def main():
    rng = np.random.default_rng(11)
    n, d = 200_000, 128
    rows = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((64, d)).astype(np.float32)
    brute = rows.astype(np.float64) @ qs.T  # (n, 64)

    # 1. Batched MIPS: 64 queries, one scan, one corpus read.
    vb = it.VerticalBatch.from_rows(rows)
    t0 = time.perf_counter()
    res = it.batch_knn_dot(qs, vb, 10)
    dt = time.perf_counter() - t0
    for i in range(64):
        want = np.argsort(-brute[:, i], kind="stable")[:10]
        np.testing.assert_array_equal(res.indices[i], want)
    print(f"f32 batched MIPS: 64 queries x {n} rows in {dt:.2f}s "
          f"(top-10 == brute force on all 64)")

    # 2. Same corpus in bf16: half the HBM bytes per scan.
    vb16 = it.VerticalBatch(rows, dtype=jnp.bfloat16)
    res16 = it.batch_knn_dot(qs, vb16, 10)
    overlap = np.mean(
        [len(set(res16.indices[i]) & set(res.indices[i])) / 10 for i in range(64)]
    )
    mem32 = vb.rows.size * 4 / 2**20
    mem16 = vb16.rows.size * 2 / 2**20
    print(f"bf16 corpus: {mem16:.0f} MB vs {mem32:.0f} MB f32; "
          f"top-10 overlap {overlap:.3f}")
    assert overlap > 0.9

    # 3. Predicate pushdown: restrict to an allowed subset in-kernel
    #    (batch_knn_filtered is the L2 variant, reference src/batch.rs:809).
    mask = rng.random(n) > 0.8
    fres = it.batch_knn_filtered(qs, vb, 5, mask)
    assert mask[fres.indices].all()
    allowed = np.where(mask)[0]
    for i in range(64):
        l2 = np.sum((rows[allowed].astype(np.float64) - qs[i]) ** 2, axis=1)
        want = allowed[np.argsort(l2, kind="stable")[:5]]
        np.testing.assert_array_equal(fres.indices[i], want)
    print(f"filtered L2 kNN: predicate keeps {mask.sum()} rows; "
          f"top-5 == masked brute force on all 64 queries")

    # 4. Late interaction: a batch of token-matrix queries, one corpus pass.
    docs = rng.standard_normal((20_000, 12, 64)).astype(np.float32)
    q_toks = rng.standard_normal((8, 6, 64)).astype(np.float32)
    vals, idx = it.maxsim_knn_batch(q_toks, docs, 3)
    for b in range(8):
        top = float(it.maxsim(q_toks[b], docs[int(idx[b, 0])]))
        np.testing.assert_allclose(vals[b, 0], top, rtol=1e-4)
    print(f"MaxSim retrieval: 8 token-matrix queries x 20K docs, "
          f"best scores verified pairwise")

    # 5. Two-stage serving: 32x-compressed coarse scan + exact rerank.
    #    Clustered embeddings (the realistic regime — uniform gaussians are
    #    the degenerate worst case for 1-bit sketches; see PERF.md).
    centers = rng.standard_normal((512, d)).astype(np.float32)
    crows = (
        centers[rng.integers(0, 512, n)]
        + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    )
    cqs = crows[:64] + 0.05 * rng.standard_normal((64, d)).astype(np.float32)
    cbrute = crows.astype(np.float64) @ cqs.T
    idx2 = it.TwoStageIndex(crows, "binary", rerank_factor=64)
    sres = idx2.search_batch(cqs, 10)
    recall = np.mean(
        [
            len(set(sres.indices[i])
                & set(np.argsort(-cbrute[:, i], kind="stable")[:10])) / 10
            for i in range(64)
        ]
    )
    print(f"two-stage (binary coarse, rf=64): recall@10 = {recall:.2f} "
          f"with {idx2.memory_bytes()['coarse_binary'] / 2**20:.1f} MB coarse")
    assert recall >= 0.9

    # 6. live mutation: LSM segments with exact tombstone exclusion.
    seg = it.SegmentedCorpus(d)
    seg.add(rows[: n // 2])
    seg.add(rows[n // 2 :])          # second segment, no rebuild
    victim_scores, victim_ids = seg.knn_dot(qs[:4], 3)
    seg.delete(victim_ids[:, 0])     # delete each query's current top-1
    new_scores, new_ids = seg.knn_dot(qs[:4], 3)
    assert not set(np.ravel(new_ids)) & set(victim_ids[:, 0].tolist())
    for r in range(4):
        assert list(new_ids[r, :2]) == list(victim_ids[r, 1:3]), r
    seg.compact()
    comp_scores, comp_ids = seg.knn_dot(qs[:4], 3)
    assert np.array_equal(np.asarray(new_ids), np.asarray(comp_ids))
    print(f"segmented serving: deleted 4 top hits, runners-up promoted "
          f"exactly; compaction invariant over {seg.num_vectors} rows")

    # 7. Launch-floor economics + MicroBatcher: per-query cost collapses
    #    with batch size (the corpus read and the ~tens-of-ms dispatch
    #    floor are shared), and the micro-batcher recovers batched QPS for
    #    callers that only ever submit ONE query at a time (e.g. one
    #    request-handler thread per client).
    from concurrent.futures import ThreadPoolExecutor

    def _qps(batch):
        reps = 3
        qsb = qs[:batch]
        np.asarray(it.batch_knn_dot(qsb, vb, 10).indices)  # warm compile
        t0 = time.perf_counter()
        for _ in range(reps):
            np.asarray(it.batch_knn_dot(qsb, vb, 10).indices)
        return batch * reps / (time.perf_counter() - t0)

    rates = {b: _qps(b) for b in (1, 8, 32)}
    print(
        "QPS vs batch size (one launch per batch): "
        + ", ".join(f"b={b}: {r:,.0f}" for b, r in rates.items())
    )

    with it.MicroBatcher(
        lambda q_, k_: it.batch_knn_dot(q_, vb, k_), k=10,
        max_batch=32, max_wait_ms=3.0,
    ) as mb:
        mb.search(qs[0])  # warm each bucket's compile out of the timing
        with ThreadPoolExecutor(32) as pool:
            list(pool.map(mb.search, [qs[i % 64] for i in range(32)]))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(32) as pool:
            got = list(pool.map(mb.search, [qs[i % 64] for i in range(96)]))
        dt = time.perf_counter() - t0
        launches = mb.stats.launches
    for i, (v, ix) in enumerate(got):
        want = np.argsort(-brute[:, i % 64], kind="stable")[:10]
        np.testing.assert_array_equal(ix, want)
    print(
        f"MicroBatcher: 96 single-query callers -> {launches} launches, "
        f"{96 / dt:,.0f} QPS (vs {rates[1]:,.0f} QPS unbatched serial); "
        f"all 96 results == brute force"
    )

    print("OK")


if __name__ == "__main__":
    main()
