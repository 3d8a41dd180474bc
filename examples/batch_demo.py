"""Batch kNN demo: 10K x 128d corpus, 100 queries, top-2 verified against
brute force (reference examples/batch_demo.rs:159-227), plus a fused-kernel
vs naive-loop timing comparison (the PDX-vs-naive analog).

Run: python examples/batch_demo.py
"""

import time

import numpy as np

import innr_tpu as it


def main():
    rng = np.random.default_rng(42)
    n, d, n_queries, k = 10_000, 128, 100, 2
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((n_queries, d)).astype(np.float32)

    vb = it.VerticalBatch.from_rows(corpus)

    # Correctness: top-k vs numpy brute force for every query.
    mismatches = 0
    for q in queries:
        res = it.batch_knn_dot(q, vb, k)
        dots = corpus.astype(np.float64) @ q.astype(np.float64)
        brute = np.argsort(-dots, kind="stable")[:k]
        if list(res.indices) != list(brute):
            mismatches += 1
    assert mismatches == 0, f"{mismatches}/{n_queries} queries disagreed"
    print(f"OK: top-{k} matches brute force on all {n_queries} queries")

    # Timing: one batched scan vs a per-pair dot loop ("naive").
    it.batch_knn_dot(queries[0], vb, k)  # warmup/compile
    t0 = time.perf_counter()
    for q in queries:
        it.batch_knn_dot(q, vb, k)
    batch_dt = time.perf_counter() - t0

    t0 = time.perf_counter()
    q = queries[0]
    scores = [float(it.dot(q, corpus[i])) for i in range(200)]  # sample of 200
    naive_dt = (time.perf_counter() - t0) * (n / 200) * n_queries
    del scores

    print(f"batched scan: {batch_dt:.3f}s for {n_queries} queries "
          f"({n_queries * n / batch_dt / 1e6:.1f}M evals/s)")
    print(f"naive per-pair loop (extrapolated): {naive_dt:.1f}s "
          f"({batch_dt / naive_dt:.4f}x of naive time)")


if __name__ == "__main__":
    main()
