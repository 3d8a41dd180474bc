"""Tile-skip pruning: summaries, survivor planning, and the pruned scan.

The pruned scan must be EXACT (bit-identical indices to the full scan —
the centroid/radius bounds are sound), prune aggressively on tile-coherent
corpora, and never prune tiles containing NaN rows. The pruned scan is the
Triton kernel with a survivor tile list; here it runs in Pallas interpret
mode, which these tests ask for explicitly.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import innr_tpu as it
from innr_tpu import prune, scan
from innr_tpu.kernels import triton_knn


def _l2_aux(rows):
    r = jnp.asarray(rows).astype(jnp.float32)
    return jnp.sum(r * r, axis=1)


def _pruned(qs, rows, summary, k, mode, aux=None):
    """Tile-skipping Triton scan (interpret mode) over ``summary``."""
    return scan.planned_knn(jnp.asarray(qs), jnp.asarray(rows), aux, summary,
                            k, mode, route="triton", interpret=True)


def _full(qs, rows, k, mode, aux=None, block_n=256):
    """Full Triton scan (interpret mode), decoded like the pruned one."""
    qs = jnp.asarray(qs)
    keys, idx = triton_knn.knn_keys(qs, jnp.asarray(rows), aux, k, mode,
                                    block_n=block_n, interpret=True)
    n_rows = max(int(rows.shape[0]), scan.DIRECT_L2_MAX_ROWS)
    return scan.decode_keys(keys, mode, qs, n_rows), idx


def _clustered(rng, n=4096, d=32, n_centers=16, noise=0.05, sort=True):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 3
    assign = rng.integers(0, n_centers, n)
    if sort:
        assign = np.sort(assign)
    rows = centers[assign] + noise * rng.standard_normal((n, d)).astype(
        np.float32
    )
    return rows.astype(np.float32)


class TestTileSummary:
    def test_bounds_cover_rows(self, rng):
        rows = rng.standard_normal((1000, 16)).astype(np.float32)
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        assert s.n_tiles == 4
        assert int(np.sum(np.asarray(s.counts))) == 1000
        cent = np.asarray(s.centroids)
        rad = np.asarray(s.radii)
        for t in range(s.n_tiles):
            blk = rows[t * 256 : (t + 1) * 256]
            d = np.linalg.norm(blk - cent[t], axis=1)
            assert d.max() <= rad[t] + 1e-3

    def test_ragged_tail_counts(self, rng):
        rows = rng.standard_normal((700, 8)).astype(np.float32)
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        assert np.asarray(s.counts).tolist() == [256, 256, 188]
        # padded zero rows must not inflate the tail radius
        blk = rows[512:]
        cent = np.asarray(s.centroids)[2]
        assert np.allclose(cent, blk.mean(axis=0), atol=1e-4)


class TestPlanSurvivors:
    def test_prunes_clustered_corpus(self, rng):
        rows = _clustered(rng, n=4096, d=32)
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        qs = jnp.asarray(rows[:4] + 0.01)
        order, n_surv = prune.plan_survivors(
            qs, s.centroids, s.radii, s.counts, 5, "dot"
        )
        assert 0 < int(n_surv) < s.n_tiles
        # dead slots repeat the last survivor
        o = np.asarray(order)
        ns = int(n_surv)
        assert np.all(o[ns:] == o[ns - 1])
        # survivors ascend (stable tie-break preservation)
        assert np.all(np.diff(o[:ns]) > 0)

    def test_random_order_corpus_keeps_everything(self, rng):
        # Incoherent tiles: bounds cannot prove anything; nothing prunes,
        # the scan degrades to the full read (never worse than that).
        rows = _clustered(rng, n=2048, d=16, sort=False)
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        qs = jnp.asarray(rng.standard_normal((2, 16)).astype(np.float32))
        _, n_surv = prune.plan_survivors(
            qs, s.centroids, s.radii, s.counts, 3, "dot"
        )
        assert int(n_surv) >= s.n_tiles - 2

    def test_nan_tile_stays_alive(self, rng):
        rows = _clustered(rng, n=2048, d=16)
        rows[1500] = np.nan
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        qs = jnp.asarray(rng.standard_normal((1, 16)).astype(np.float32))
        order, n_surv = prune.plan_survivors(
            qs, s.centroids, s.radii, s.counts, 3, "dot"
        )
        assert 1500 // 256 in np.asarray(order)[: int(n_surv)].tolist()


class TestPrunedScanExactness:
    @pytest.mark.parametrize("mode", ["dot", "l2"])
    def test_matches_full_scan_bit_for_bit(self, rng, mode):
        rows = _clustered(rng, n=3000, d=32)
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        qs = jnp.asarray(rng.standard_normal((5, 32)).astype(np.float32))
        aux = _l2_aux(rows) if mode == "l2" else None
        pv, pi = _pruned(qs, rows, s, 7, mode, aux)
        fv, fi = _full(qs, rows, 7, mode, aux)
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))
        np.testing.assert_array_equal(np.asarray(pv), np.asarray(fv))

    def test_duplicate_scores_keep_stable_tiebreak(self, rng):
        # Quantized rows force exact ties across tile boundaries; the
        # survivor list is ascending so lowest-index-first must hold.
        rows = rng.integers(-2, 3, (2048, 16)).astype(np.float32)
        rows = rows[np.argsort(rows[:, 0], kind="stable")]  # some coherence
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        q = rng.integers(-2, 3, 16).astype(np.float32)
        qs = jnp.asarray(q[None, :])
        pv, pi = _pruned(qs, rows, s, 9, "dot")
        fv, fi = _full(qs, rows, 9, "dot")
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))

    def test_nan_rows_still_win(self, rng):
        # NaN scores sort greatest under total order; the NaN row's tile
        # must not be pruned and the NaN must surface exactly as in the
        # full scan.
        rows = _clustered(rng, n=2048, d=16)
        rows[700] = np.nan
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        qs = jnp.asarray(rng.standard_normal((1, 16)).astype(np.float32))
        pv, pi = _pruned(qs, rows, s, 3, "dot")
        assert int(np.asarray(pi)[0, 0]) == 700
        assert np.isnan(np.asarray(pv)[0, 0])


class TestPublicPruneAPI:
    def test_batch_knn_dot_prune_equals_plain(self, rng):
        rows = _clustered(rng, n=8192, d=256, n_centers=32)
        vb = it.VerticalBatch.from_rows(rows)
        qs = rng.standard_normal((3, 256)).astype(np.float32)
        plain = it.batch_knn_dot(qs, vb, 5)
        pruned = it.batch_knn_dot(qs, vb, 5, prune=True)
        np.testing.assert_array_equal(plain.indices, pruned.indices)
        np.testing.assert_array_equal(plain.scores, pruned.scores)

    def test_batch_knn_l2_prune_equals_plain_single_query(self, rng):
        rows = _clustered(rng, n=8192, d=256, n_centers=32)
        vb = it.VerticalBatch.from_rows(rows)
        q = rng.standard_normal(256).astype(np.float32)
        plain = it.batch_knn(q, vb, 4)
        pruned = it.batch_knn(q, vb, 4, prune=True)
        np.testing.assert_array_equal(plain.indices, pruned.indices)

    def test_adaptive_large_corpus_exact(self, rng):
        rows = _clustered(rng, n=8192, d=256, n_centers=32)
        vb = it.VerticalBatch.from_rows(rows)
        q = rng.standard_normal(256).astype(np.float32)
        exact = it.batch_knn(q, vb, 5)
        adaptive = it.batch_knn_adaptive(q, vb, 5, 32)
        np.testing.assert_array_equal(exact.indices, adaptive.indices)

    def test_l2_pruning_threshold_large_corpus(self, rng):
        rows = _clustered(rng, n=8192, d=256, n_centers=32)
        vb = it.VerticalBatch.from_rows(rows)
        q = (rows[100] + 0.01).astype(np.float32)
        l2 = np.sum((rows.astype(np.float64) - q) ** 2, axis=1)
        thr = float(np.quantile(l2, 0.01))
        idx, dists = it.batch_l2_squared_pruning(q, vb, thr)
        want = set(np.nonzero(l2 <= thr - 1e-3)[0].tolist())
        got = set(idx.tolist())
        assert want <= got
        assert got <= set(np.nonzero(l2 <= thr + 1e-3)[0].tolist())

    def test_cluster_order_improves_pruning(self, rng):
        rows = _clustered(rng, n=4096, d=32, sort=False)
        perm = prune.cluster_order(rows, n_clusters=16, n_iters=4)
        assert sorted(perm.tolist()) == list(range(4096))
        ordered = rows[perm]
        s_rand = prune.build_tile_summary(jnp.asarray(rows), 256)
        s_ord = prune.build_tile_summary(jnp.asarray(ordered), 256)
        qs = jnp.asarray(rng.standard_normal((2, 32)).astype(np.float32) * 3)
        _, ns_rand = prune.plan_survivors(
            qs, s_rand.centroids, s_rand.radii, s_rand.counts, 3, "l2"
        )
        _, ns_ord = prune.plan_survivors(
            qs, s_ord.centroids, s_ord.radii, s_ord.counts, 3, "l2"
        )
        assert int(ns_ord) < int(ns_rand)

    def test_cluster_order_recovers_many_separated_clusters(self, rng):
        """k-means++ seeding must recover well-separated modes even when
        there are MANY of them relative to the sample: the old random-row
        init regularly dropped whole clusters, whose rows then polluted
        distant tiles (measured 1.4% vs 31% DMAs elided — envelope
        bench, round 4). Pin: ordering an arrival-order corpus achieves
        at least 80% of the native (construction-order) pruning power."""
        n, d, nc, tile_n = 50_000, 64, 40, 512
        centers = 4.0 * rng.standard_normal((nc, d)).astype(np.float32)
        assign = rng.integers(0, nc, n)
        rows = (
            centers[assign] + 0.05 * rng.standard_normal((n, d))
        ).astype(np.float32)
        qs = jnp.asarray(
            (centers[rng.integers(0, nc, 16)]
             + 0.05 * rng.standard_normal((16, d))).astype(np.float32)
        )
        n_tiles = -(-n // tile_n)

        def power(r):
            s = prune.build_tile_summary(jnp.asarray(r), tile_n)
            _, ns = prune.plan_survivors(
                qs, s.centroids, s.radii, s.counts, 10, "dot"
            )
            return 1.0 - int(ns) / n_tiles

        perm = prune.cluster_order(rows, n_clusters=nc, n_iters=5)
        p_km = power(rows[perm])
        p_native = power(rows[np.argsort(assign, kind="stable")])
        assert p_native > 0.3, p_native  # sanity: config actually prunes
        assert p_km >= 0.8 * p_native, (p_km, p_native)


class TestCosinePrunedScan:
    """Cosine pruning: unit-row summaries make cosine a dot plan; results
    must be bit-identical to the full cosine scan, including zero-norm
    rows (score exactly 0.0)."""

    def test_matches_full_cosine_bit_for_bit(self, rng):
        rows = _clustered(rng, n=3000, d=32)
        rows[100] = 0.0  # zero-norm row: cosine contract 0.0
        s = prune.build_tile_summary(jnp.asarray(rows), 256, normalized=True)
        qs = scan.unit_queries(
            jnp.asarray(rng.standard_normal((4, 32)).astype(np.float32)))
        inv = scan.inv_norms(jnp.asarray(rows))
        pv, pi = _pruned(qs, rows, s, 7, "cosine", inv)
        fv, fi = _full(qs, rows, 7, "cosine", inv)
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))
        np.testing.assert_array_equal(np.asarray(pv), np.asarray(fv))

    def test_public_api_prune_equals_plain(self, rng):
        rows = _clustered(rng, n=8192, d=256, n_centers=32)
        vb = it.VerticalBatch.from_rows(rows)
        qs = rng.standard_normal((3, 256)).astype(np.float32)
        plain = it.batch_knn_cosine(qs, vb, 5)
        pruned = it.batch_knn_cosine(qs, vb, 5, prune=True)
        np.testing.assert_array_equal(plain.indices, pruned.indices)
        np.testing.assert_array_equal(plain.scores, pruned.scores)

    def test_normalized_summary_prunes_direction_clusters(self, rng):
        # Directional clusters with WILDLY different magnitudes: the raw
        # summary cannot prune cosine (magnitude noise), the unit one can.
        dirs = rng.standard_normal((8, 32)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        assign = np.sort(rng.integers(0, 8, 2048))
        scale = rng.uniform(0.1, 100.0, 2048).astype(np.float32)
        rows = (dirs[assign] * scale[:, None]).astype(np.float32)
        rows += 0.001 * rng.standard_normal((2048, 32)).astype(np.float32)
        s = prune.build_tile_summary(jnp.asarray(rows), 256, normalized=True)
        q = jnp.asarray(dirs[:1])
        order, n_surv = prune.plan_survivors(
            q, s.centroids, s.radii, s.counts, 3, "dot", fast=True
        )
        assert int(n_surv) < s.n_tiles


class TestRoundingSlack:
    """config.PRUNE_BOUND_EPS: a tile whose optimistic bound fails t0 by
    less than the f32 rounding slack must stay alive (advisor r3 medium:
    planner bounds and kernel scores are different f32 expansions, so a
    zero-slack comparison could prune a row sitting within rounding error
    of the threshold — silently breaking the exactness contract)."""

    def _three_tile_corpus(self, d, a_vec, b_vec, c_vec, tile_n=256):
        rows = np.concatenate(
            [
                np.tile(a_vec, (tile_n, 1)),
                np.tile(b_vec, (tile_n, 1)),
                np.tile(c_vec, (tile_n, 1)),
            ]
        ).astype(np.float32)
        return prune.build_tile_summary(jnp.asarray(rows), tile_n)

    def test_dot_within_slack_stays_alive(self):
        d = 16
        q = np.zeros(d, np.float32)
        q[0] = 1.0
        a = np.zeros(d, np.float32); a[0] = 1.0          # score 1.0 (t0)
        b = np.zeros(d, np.float32); b[0] = 1.0 - 1e-5   # within slack
        c = np.zeros(d, np.float32); c[0] = -1.0         # far below
        s = self._three_tile_corpus(d, a, b, c)
        assert np.all(np.asarray(s.radii) < 1e-6)  # near-exact bounds
        _, n_surv = prune.plan_survivors(
            jnp.asarray(q[None, :]), s.centroids, s.radii, s.counts,
            5, "dot",
        )
        # b alive (inside slack), c dead (far outside slack).
        assert int(n_surv) == 2

    def test_l2_within_slack_stays_alive(self):
        d = 16
        q = np.zeros(d, np.float32)
        q[0] = 1.0
        a = q.copy()                                      # distance 0 (t0)
        b = np.zeros(d, np.float32); b[0] = 1.0 - 0.01    # d2=1e-4 < slack
        c = np.zeros(d, np.float32); c[0] = 50.0          # far
        s = self._three_tile_corpus(d, a, b, c)
        _, n_surv = prune.plan_survivors(
            jnp.asarray(q[None, :]), s.centroids, s.radii, s.counts,
            5, "l2",
        )
        assert int(n_surv) == 2

    def test_threshold_within_slack_stays_alive(self):
        d = 16
        q = np.zeros(d, np.float32)
        q[0] = 1.0
        a = q.copy()
        b = np.zeros(d, np.float32); b[0] = 1.0 - 0.032   # d2 ~1.02e-3
        c = np.zeros(d, np.float32); c[0] = 50.0
        s = self._three_tile_corpus(d, a, b, c)
        # threshold 1e-3: b's lower bound exceeds it by ~2.4e-5, inside
        # the 1e-4*(qq+cc+2|qd|) ~ 4e-4 slack -> alive; c dead.
        _, n_surv, alive = prune.plan_threshold_survivors(
            jnp.asarray(q[None, :]), s.centroids, s.radii, 1e-3
        )
        assert int(n_surv) == 2
        assert np.asarray(alive).tolist() == [True, True, False]

    def test_slack_does_not_break_exactness_or_power(self, rng):
        # End-to-end: pruned scan still bit-identical AND still prunes.
        rows = _clustered(rng, n=8192, d=64, n_centers=16)
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        qs = jnp.asarray(rows[:4] + 0.01)
        order, n_surv = prune.plan_survivors(
            qs, s.centroids, s.radii, s.counts, 5, "dot"
        )
        assert 0 < int(n_surv) < s.n_tiles


class TestBf16PlanRounding:
    """bf16 corpora: the scans score bf16(q) . r (the same cast the full
    scan makes, innr_tpu/scan.py), a 2^-9 relative perturbation
    of the query that the f32 PRUNE_BOUND_EPS slack cannot absorb. The
    planner must bound the scores the kernel ACTUALLY computes — i.e.
    plan against the bf16-rounded query — or a true top-k row sitting in
    an otherwise-losing tile is silently pruned (regression: round 4)."""

    def _adversarial(self):
        # Group A: q just BELOW the bf16 midpoint 1.00390625 -> rounds to
        # 1.0 (delta -0.0039). Group B: q just ABOVE -> rounds to
        # 1.0078125 (delta +0.0039).
        d_half = 128
        qa, qb = np.float32(1.0039), np.float32(1.00391)
        q = np.concatenate(
            [np.full(d_half, qa, np.float32), np.full(d_half, qb, np.float32)]
        )
        # Tile 1: rows u live on group A. f32 plan score 128*1.0039 =
        # 128.499; kernel bf16 score 128.0.
        u = np.concatenate(
            [np.ones(d_half, np.float32), np.zeros(d_half, np.float32)]
        )
        # Tile 2: rows v live on group B at 255/256 (bf16-exact). f32 plan
        # score 128*1.00391*0.99609375 = 128.001 -> pruned against t0 =
        # 128.499 (slack ~0.02). Kernel bf16 score 128*1.0078125*
        # 0.99609375 = 128.496 -> the TRUE top-1 of the fused scan.
        v = np.concatenate(
            [np.zeros(d_half, np.float32),
             np.full(d_half, 0.99609375, np.float32)]
        )
        rows = np.stack([u] * 8 + [v] * 8)
        return q[None, :], rows

    def test_dot_pruned_matches_full_scan_bf16(self):
        q, rows = self._adversarial()
        rows_bf = jnp.asarray(rows, jnp.bfloat16)
        qs = jnp.asarray(q)
        s = prune.build_tile_summary(rows_bf, 8)
        pv, pi = _pruned(qs, rows_bf, s, 1, "dot")
        fv, fi = _full(qs, rows_bf, 1, "dot", block_n=8)
        assert np.asarray(pi).tolist() == np.asarray(fi).tolist()
        np.testing.assert_array_equal(np.asarray(pv), np.asarray(fv))
        # and the winner really is the group-B row the f32 plan would drop
        assert int(np.asarray(fi)[0, 0]) >= 8

    def test_bf16_still_prunes(self, rng):
        # The rounded-query plan must not cost pruning power on ordinary
        # clustered corpora (bounds barely move: ~2^-9 relative).
        rows = _clustered(rng, n=4096, d=64, n_centers=16)
        rows_bf = jnp.asarray(rows, jnp.bfloat16)
        s = prune.build_tile_summary(rows_bf, 256)
        qs = jnp.asarray(rows[:2] + 0.01)
        pv, pi = _pruned(qs, rows_bf, s, 5, "dot")
        fv, fi = _full(qs, rows_bf, 5, "dot")
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))
        qs_plan = qs.astype(jnp.bfloat16).astype(jnp.float32)
        _, n_surv = prune.plan_survivors(
            qs_plan, s.centroids, s.radii, s.counts, 5, "dot"
        )
        assert 0 < int(n_surv) < s.n_tiles


class TestPruneTileKnob:
    """set_prune_tile_n: the layout knob for fine-grained-cluster corpora
    (clusters smaller than the default tile cannot prune; a matching tile
    height restores the win). Exactness must never depend on the tile
    height."""

    def test_knob_restores_power_and_stays_exact(self, rng):
        import innr_tpu as it

        nc, per, d = 256, 256, 32
        centers = 5.0 * rng.standard_normal((nc, d)).astype(np.float32)
        assign = np.sort(rng.integers(0, nc, nc * per))
        rows = (
            centers[assign] + 0.05 * rng.standard_normal((nc * per, d))
        ).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        q = (centers[17] + 0.02 * rng.standard_normal(d)).astype(np.float32)

        def power(s):
            n_tiles = -(-rows.shape[0] // s.tile_n)
            _, ns = prune.plan_survivors(
                jnp.asarray(q)[None, :], s.centroids, s.radii, s.counts,
                10, "dot",
            )
            return 1.0 - int(ns) / n_tiles

        full = it.batch_knn_dot(q, vb, 10)
        r_default = it.batch_knn_dot(q, vb, 10, prune=True)
        p_default = power(vb.tile_summary())
        assert vb.set_prune_tile_n(128) is vb       # chainable
        assert vb.tile_summary().tile_n == 128
        p_knob = power(vb.tile_summary())
        r_knob = it.batch_knn_dot(q, vb, 10, prune=True)
        # Sub-tile clusters: default prunes ~nothing, aligned tile wins.
        assert p_default < 0.05 and p_knob > 0.5, (p_default, p_knob)
        for r in (r_default, r_knob):
            np.testing.assert_array_equal(
                np.asarray(r.indices), np.asarray(full.indices))
            np.testing.assert_array_equal(
                np.asarray(r.scores), np.asarray(full.scores))

    def test_knob_validation_reset_and_cap(self, rng):
        import innr_tpu as it

        rows = rng.standard_normal((4096, 16)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        default_tile = prune.default_tile_n(4096, 16, vb.rows.dtype)
        with pytest.raises(it.ContractError):
            vb.set_prune_tile_n(0)
        vb.set_prune_tile_n(300)                    # rounds up to 128 rows
        assert vb.tile_summary().tile_n == 384
        vb.set_prune_tile_n(10**9)                  # capped at the default
        assert vb.tile_summary().tile_n == default_tile
        vb.set_prune_tile_n(None)                   # reset to default
        assert vb.tile_summary().tile_n == default_tile


class TestNearestCentroid:
    """Differential tests for the nearest-centroid pass
    (prune.nearest_centroid) against a float64 NumPy oracle — the final
    full-corpus pass of `_kmeans_assign`."""

    @staticmethod
    def _oracle(x, c):
        d2 = np.sum(c.astype(np.float64) ** 2, axis=1)[None, :] - 2.0 * (
            x.astype(np.float64) @ c.T.astype(np.float64)
        )
        return np.argmin(d2, axis=1).astype(np.int32)

    @pytest.mark.parametrize(
        "n,d,kc",
        [(1000, 16, 7), (513, 32, 256), (300, 8, 1), (129, 7, 2100),
         (257, 160, 2304)],
    )
    def test_matches_oracle_on_separated_clusters(self, rng, n, d, kc):
        from innr_tpu.prune import nearest_centroid

        c = rng.standard_normal((kc, d)).astype(np.float32) * 3
        a = rng.integers(0, kc, n)
        x = (c[a] + 0.01 * rng.standard_normal((n, d))).astype(np.float32)
        got = np.asarray(nearest_centroid(jnp.asarray(x), jnp.asarray(c)))
        np.testing.assert_array_equal(got, self._oracle(x, c))

    def test_all_negative_scores_padding_cannot_win(self):
        # Every real centroid scores NEGATIVE (dot < 0, big norms): the
        # argmin must pick among real centroids only.
        from innr_tpu.prune import nearest_centroid

        c = np.full((3, 4), 10.0, np.float32)
        c[1] = 20.0
        x = np.full((5, 4), -1.0, np.float32)
        got = np.asarray(nearest_centroid(jnp.asarray(x), jnp.asarray(c)))
        np.testing.assert_array_equal(got, self._oracle(x, c))

    def test_exact_ties_pick_lowest_index(self, rng):
        # Duplicated centroid rows produce bit-identical scores; both
        # jnp.argmin and np.argmin resolve to the FIRST index.
        from innr_tpu.prune import nearest_centroid

        base = rng.standard_normal((5, 16)).astype(np.float32)
        c = np.concatenate([base, base[::-1], base])  # every row 3x
        x = (base[rng.integers(0, 5, 64)]
             + 0.01 * rng.standard_normal((64, 16))).astype(np.float32)
        got = np.asarray(nearest_centroid(jnp.asarray(x), jnp.asarray(c)))
        np.testing.assert_array_equal(got, self._oracle(x, c))
        assert got.max() < 5  # always the first copy

    def test_nan_rows_assign_zero(self, rng):
        from innr_tpu.prune import nearest_centroid

        c = rng.standard_normal((4, 8)).astype(np.float32)
        x = rng.standard_normal((6, 8)).astype(np.float32)
        x[2] = np.nan
        got = np.asarray(nearest_centroid(jnp.asarray(x), jnp.asarray(c)))
        assert got[2] == 0
        keep = np.array([0, 1, 3, 4, 5])
        np.testing.assert_array_equal(got[keep], self._oracle(x, c)[keep])

    def test_bf16_rows_match_bf16_oracle(self, rng):
        from innr_tpu.prune import nearest_centroid

        c = (rng.standard_normal((9, 32)) * 3).astype(np.float32)
        a = rng.integers(0, 9, 200)
        x = (c[a] + 0.02 * rng.standard_normal((200, 32))).astype(np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        got = np.asarray(nearest_centroid(xb, jnp.asarray(c)))
        want = self._oracle(np.asarray(xb.astype(jnp.float32)), c)
        np.testing.assert_array_equal(got, want)


class TestClusterReorder:
    """All-device IVF layout pass (cluster_reorder) + auto tile
    suggestion."""

    def test_matches_host_permutation_path(self, rng):
        rows = _clustered(rng, n=4096, d=32, sort=False)
        reordered, perm, sizes = prune.cluster_reorder(
            rows, n_clusters=16, n_iters=4
        )
        perm = np.asarray(perm)
        assert sorted(perm.tolist()) == list(range(4096))
        np.testing.assert_array_equal(np.asarray(reordered), rows[perm])
        assert int(np.sum(np.asarray(sizes))) == 4096
        # Same seed => bit-identical layout to the host-permutation path.
        host_perm = prune.cluster_order(rows, n_clusters=16, n_iters=4)
        np.testing.assert_array_equal(perm, np.asarray(host_perm))

    def test_suggest_tile_n(self):
        # Half the 25th-percentile cluster size, rounded down to 128 rows,
        # floored at 256 rows, capped at the default tile height.
        assert prune.suggest_tile_n(np.full(100, 600), 60_000, 128) == 256
        assert prune.suggest_tile_n(np.full(100, 1200), 120_000, 128) == 512
        assert prune.suggest_tile_n(np.full(100, 200), 60_000, 128) == 256
        # ~8000-row clusters -> half = 4000 -> 3968, above the cap here.
        cap = prune.default_tile_n(800_000, 128)
        assert prune.suggest_tile_n(np.full(100, 8000), 800_000, 128) == cap
        assert prune.suggest_tile_n(np.full(10, 40), 400, 8) == 256
        cap = prune.default_tile_n(1_000_000, 128, jnp.float32)
        # No non-empty clusters -> the default.
        assert (
            prune.suggest_tile_n(np.zeros(5, np.int64), 1_000_000, 128) == cap
        )
        # Huge clusters -> capped at the default.
        assert (
            prune.suggest_tile_n(np.full(3, 10**9), 1_000_000, 128) == cap
        )

    def test_default_tile_n_is_kernel_block(self):
        # One surviving tile is one Triton program: the default tile is
        # the kernel's block height, a multiple of its sub-tile.
        for n in (1, 5000, 60_000, 1_000_000, 20_000_000):
            t = prune.default_tile_n(n, 128)
            assert t == triton_knn.block_rows(n)
            assert t % triton_knn.SUB_N == 0 and 1024 <= t <= 4096

    def test_batch_cluster_reorder_end_to_end(self, rng):
        """VerticalBatch.cluster_reorder: pruned kNN on the reordered batch
        maps back through perm to the direct answer, and the auto tile
        height re-enables pruning on sub-tile clusters without the manual
        knob."""
        n, d, nc = 120_000, 128, 20
        centers = 6.0 * rng.standard_normal((nc, d)).astype(np.float32)
        assign = rng.integers(0, nc, n)
        rows = (
            centers[assign]
            + 0.05 * rng.standard_normal((n, d)).astype(np.float32)
        ).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        nb, perm = vb.cluster_reorder(n_clusters=nc, n_iters=4)
        perm = np.asarray(perm)
        # Auto tile height follows the measured cluster granularity,
        # capped at the default.
        assert nb.tile_summary().tile_n <= prune.default_tile_n(
            n, d, nb.rows.dtype)
        qs = (centers[:4] + 0.01).astype(np.float32)
        full = it.batch_knn(qs, vb, 5)
        pruned = it.batch_knn(qs, nb, 5, prune=True)
        np.testing.assert_array_equal(
            perm[np.asarray(pruned.indices)], np.asarray(full.indices)
        )
        np.testing.assert_allclose(
            np.asarray(pruned.scores), np.asarray(full.scores), rtol=1e-5
        )
        # And the layout actually prunes. Cluster boundaries are NOT
        # tile-aligned in a plain reorder, so straddling tiles cap the
        # elision well below the ideal (~4/64 clusters relevant); demand
        # a real but modest win here — full boundary alignment is
        # IVFIndex's job (tests/test_ivf.py asserts the strong bound).
        s = nb.tile_summary()
        _, ns = prune.plan_survivors(
            jnp.asarray(qs), s.centroids, s.radii, s.counts, 5, "l2"
        )
        assert int(ns) < int(0.75 * s.n_tiles), (int(ns), s.n_tiles)

    def test_bf16_batch_reorder_keeps_dtype(self, rng):
        rows = _clustered(rng, n=4096, d=32, sort=False)
        vb = it.VerticalBatch(rows, dtype=jnp.bfloat16)
        nb, perm = vb.cluster_reorder(n_clusters=8, n_iters=2)
        assert nb.rows.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(nb.rows.astype(jnp.float32)),
            np.asarray(vb.rows.astype(jnp.float32))[np.asarray(perm)],
        )


class TestPruneRouter:
    """prune=True takes the planned scan only on the Triton route; the XLA
    route runs the full scan. Both must equal the plain scan, and the
    planned kernel must really receive a plan that skips tiles."""

    def _mk(self, rng, n):
        rows = _clustered(rng, n=n, d=32, n_centers=16, sort=True)
        vb = it.VerticalBatch.from_rows(rows).set_prune_tile_n(256)
        qs = (rows[:3] + 0.01).astype(np.float32)
        return rows, vb, qs

    def test_full_route_exact(self, rng):
        rows, vb, qs = self._mk(rng, 4104)
        want = it.batch_knn(qs, vb, 5)
        got = it.batch_knn(qs, vb, 5, prune=True)  # XLA route on the CPU
        np.testing.assert_array_equal(
            np.asarray(got.indices), np.asarray(want.indices)
        )
        np.testing.assert_array_equal(
            np.asarray(got.scores), np.asarray(want.scores)
        )

    def test_route_taken_at_runtime(self, rng, monkeypatch):
        """Spy on the kernel: the planned Triton scan must be handed a
        survivor count below the tile count on a clustered corpus, and
        must still return the plain scan's answer."""
        rows, vb, qs = self._mk(rng, 4232)
        want = it.batch_knn(qs, vb, 5)
        seen = []
        real = triton_knn.knn_keys

        def spy(*a, **kw):
            seen.append((kw.get("n_surv"), kw.get("order")))
            return real(*a, **kw)

        monkeypatch.setattr(triton_knn, "knn_keys", spy)
        s = vb.tile_summary()
        got_v, got_i = _pruned(qs, rows, s, 5, "l2", vb.norms2())
        assert len(seen) == 1
        n_surv, order = seen[0]
        assert order is not None
        np.testing.assert_array_equal(np.asarray(got_i),
                                      np.asarray(want.indices))
        ns = int(prune.plan_survivors(
            jnp.asarray(qs), s.centroids, s.radii, s.counts, 5, "l2")[1])
        assert 0 < ns < s.n_tiles
