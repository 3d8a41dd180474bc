"""Tile-skip pruned scan: exact kNN that reads only competitive tiles.

The reference's pruning scans (``src/batch.rs:320-365`` threshold early
exit, ``:439-558`` adaptive warmup extrapolation) trade exactness for
skipped work per *row*. This redesign skips work per *corpus tile* and
keeps exactness: per-tile centroid/radius bounds prove whole tiles
loser-only, and on the GPU the Triton scan never reads them (other routes
scan every tile and return the same result). This demo shows the full
serving flow:

1. ``cluster_order`` — the IVF-style layout pass that makes tiles
   coherent (pruning needs locality, like any pruning index);
2. ``batch_knn_dot(..., prune=True)`` — exact, bit-identical to the full
   scan, asserted against brute force;
3. ``batch_knn_adaptive`` riding the same scan (the reference's
   "approximate" API, now exact on large corpora);
4. ``batch_l2_squared_pruning`` — the threshold scan with tile skip;
5. the survivor statistics that show how much of the corpus the plan
   avoids reading.
"""

import time

import numpy as np

import jax.numpy as jnp

import innr_tpu as it
from innr_tpu import prune


def main():
    rng = np.random.default_rng(5)
    n, d, n_centers = 200_000, 128, 12

    # Clustered embeddings arriving in RANDOM order (the realistic case).
    centers = 5.0 * rng.standard_normal((n_centers, d)).astype(np.float32)
    assign = rng.integers(0, n_centers, n)
    rows = centers[assign] + 0.05 * rng.standard_normal((n, d)).astype(
        np.float32
    )

    # 1. Layout pass: order rows by nearest centroid so corpus tiles are
    #    coherent. One device-side mini-k-means + one permutation.
    t0 = time.perf_counter()
    perm = prune.cluster_order(rows, n_clusters=n_centers, n_iters=4)
    rows_ordered = rows[perm]
    t_layout = time.perf_counter() - t0

    vb = it.VerticalBatch.from_rows(rows_ordered)
    # Queries target 2 of the 12 clusters — the serving regime where
    # pruning pays (a batch touching every cluster must read every
    # cluster's tiles; that is correct, not a failure).
    qs = (
        centers[rng.integers(0, 2, 16)]
        + 0.02 * rng.standard_normal((16, d)).astype(np.float32)
    )

    # Survivor statistics: how much of the corpus the plan provably skips.
    s = vb.tile_summary()
    order, n_surv = prune.plan_survivors(
        jnp.asarray(qs), s.centroids, s.radii, s.counts, 10, "dot", fast=True
    )
    frac = int(n_surv) / s.n_tiles
    print(
        f"layout pass: {t_layout:.2f}s; survivor tiles "
        f"{int(n_surv)}/{s.n_tiles} ({frac:.0%} of the corpus read, exact results)"
    )
    assert frac < 0.9, "clustered+ordered corpus must prune"

    # 2. Exact top-10, pruned vs full — bit-identical, checked vs brute.
    full = it.batch_knn_dot(qs, vb, 10)
    pruned = it.batch_knn_dot(qs, vb, 10, prune=True)
    np.testing.assert_array_equal(full.indices, pruned.indices)
    np.testing.assert_array_equal(full.scores, pruned.scores)
    brute = qs.astype(np.float64) @ rows_ordered.astype(np.float64).T
    for i in range(16):
        want = np.argsort(-brute[i].astype(np.float32), kind="stable")[:10]
        # Clustered corpora produce near-equal scores where the scan's
        # f32 accumulation and a float64 oracle can disagree by 1 ulp on
        # ORDER; the candidate set and scores must still agree.
        assert set(pruned.indices[i].tolist()) == set(want.tolist()), i
        np.testing.assert_allclose(
            np.sort(pruned.scores[i]), np.sort(brute[i][want].astype(np.float32)),
            rtol=1e-5,
        )
    print("pruned top-10 == full scan; candidate sets == brute force (16/16)")

    # 3. The reference's adaptive API (an L2 scan) rides the same
    #    tile-skip machinery and is exact on large corpora.
    adaptive = it.batch_knn_adaptive(qs, vb, 10, warmup_dims=16)
    exact_l2 = it.batch_knn(qs, vb, 10)
    np.testing.assert_array_equal(adaptive.indices, exact_l2.indices)
    print("batch_knn_adaptive == exact L2 top-10 (tile-skip path)")

    # 4. Threshold scan with tile skip: survivors == brute-force set.
    q0 = qs[0]
    l2 = np.sum((rows_ordered.astype(np.float64) - q0) ** 2, axis=1)
    thr = float(np.quantile(l2, 0.001))
    idx, dists = it.batch_l2_squared_pruning(q0, vb, thr)
    want = set(np.nonzero(l2 <= thr - 1e-3)[0].tolist())
    assert want <= set(idx.tolist())
    assert set(idx.tolist()) <= set(np.nonzero(l2 <= thr + 1e-3)[0].tolist())
    print(
        f"threshold scan: {len(idx)} rows under q0.001 threshold, "
        f"set matches brute force"
    )

    # 5. Random-order corpora degrade gracefully (nothing prunes, still
    #    exact, never slower than the full scan by more than a bound pass).
    vb_rand = it.VerticalBatch.from_rows(rows)
    s_rand = vb_rand.tile_summary()
    _, n_surv_rand = prune.plan_survivors(
        jnp.asarray(qs), s_rand.centroids, s_rand.radii, s_rand.counts,
        10, "dot", fast=True,
    )
    res_rand = it.batch_knn_dot(qs, vb_rand, 10, prune=True)
    # Same winners as the ordered corpus, mapped through the permutation
    # (tie ORDER may differ between layouts; the winner set cannot).
    for i in range(16):
        assert set(perm[pruned.indices[i]].tolist()) == set(
            res_rand.indices[i].tolist()
        ), i
    print(
        f"unordered corpus: {int(n_surv_rand)}/{s_rand.n_tiles} tiles "
        f"survive (graceful degradation, still exact)"
    )
    print("OK")


if __name__ == "__main__":
    main()
