"""IVFIndex: tile-aligned cluster-padded layout + masked pruned scan.

The exactness oracle is the plain scan (``batch_knn*`` on the ORIGINAL
corpus). On the Triton route per-row scores are the same f32 expressions
in both layouts, so the result SETS must agree wherever scores are
distinct (the layouts differ only in tie-break row order); those tests run
the kernel in interpret mode (``force_triton``). Elision assertions use well-separated
clustered corpora where the bound math guarantees pruning.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import innr_tpu as it
from innr_tpu import prune
from innr_tpu.ivf import IVFIndex
from innr_tpu.utils.asserts import ContractError


def _clustered(rng, n=20_000, d=32, nc=16, spread=8.0, sigma=0.05):
    centers = spread * rng.standard_normal((nc, d)).astype(np.float32)
    assign = rng.integers(0, nc, n)
    rows = (
        centers[assign] + sigma * rng.standard_normal((n, d))
    ).astype(np.float32)
    return rows, centers


def _sets_equal(got_idx, want_idx):
    got = np.asarray(got_idx)
    want = np.asarray(want_idx)
    return all(
        set(got[q].tolist()) == set(want[q].tolist())
        for q in range(got.shape[0])
    )


class TestMaskedSummary:
    """build_tile_summary(row_valid=...): stats over valid rows only."""

    def test_counts_centroids_radii_masked(self, rng):
        rows = rng.standard_normal((512, 8)).astype(np.float32)
        valid = rng.random(512) < 0.7
        s = prune.build_tile_summary(jnp.asarray(rows), 128,
                                     row_valid=jnp.asarray(valid))
        for t in range(4):
            sel = valid[t * 128:(t + 1) * 128]
            sub = rows[t * 128:(t + 1) * 128][sel]
            assert int(s.counts[t]) == int(sel.sum())
            if sel.sum():
                cent = sub.mean(axis=0)
                np.testing.assert_allclose(
                    np.asarray(s.centroids[t]), cent, rtol=1e-5, atol=1e-5
                )
                rad = np.sqrt(((sub - cent) ** 2).sum(axis=1).max())
                np.testing.assert_allclose(
                    float(s.radii[t]), rad, rtol=1e-4, atol=1e-5
                )

    def test_all_invalid_tile_is_zero_and_pruned(self, rng):
        rows = rng.standard_normal((256, 8)).astype(np.float32)
        valid = np.ones(256, bool)
        valid[128:] = False  # second tile pure padding
        s = prune.build_tile_summary(jnp.asarray(rows), 128,
                                     row_valid=jnp.asarray(valid))
        assert int(s.counts[1]) == 0
        assert float(s.radii[1]) == 0.0
        qs = jnp.asarray(rng.standard_normal((2, 8)).astype(np.float32))
        order, n_surv = prune.plan_survivors(
            qs, s.centroids, s.radii, s.counts, 5, "dot"
        )
        surv = set(np.asarray(order)[: int(n_surv)].tolist())
        assert 1 not in surv  # zero-valid tile never scanned

    def test_zero_count_tile_does_not_dilute_threshold(self, rng):
        # A zero-count tile with a (spuriously good) centroid-0 bound must
        # sort LAST, not steal a cumsum slot: with k=1 and one far tile,
        # the far tile must still be prunable.
        cent = jnp.asarray([[10.0, 0.0], [0.0, 0.0], [-10.0, 0.0]])
        rad = jnp.asarray([0.1, 0.0, 0.1])
        cnt = jnp.asarray([128, 0, 128], jnp.int32)
        qs = jnp.asarray([[1.0, 0.0]])
        order, n_surv = prune.plan_survivors(qs, cent, rad, cnt, 1, "dot")
        surv = set(np.asarray(order)[: int(n_surv)].tolist())
        assert surv == {0}


class TestIVFExactness:
    @pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
    def test_matches_plain_scan(self, rng, metric, force_triton):
        rows, centers = _clustered(rng)
        qs = (centers[:4] + 0.01).astype(np.float32)
        idx = IVFIndex(rows, n_clusters=16, metric=metric, n_iters=4)
        force_triton()
        got = idx.search_batch(qs, 5)
        vb = it.VerticalBatch.from_rows(rows)
        if metric == "dot":
            want = it.batch_knn_dot(qs, vb, 5)
        elif metric == "l2":
            want = it.batch_knn(qs, vb, 5)
        else:
            want = it.batch_knn_cosine(qs, vb, 5)
        assert _sets_equal(got.indices, want.indices)
        np.testing.assert_allclose(
            np.sort(got.scores, axis=1), np.sort(want.scores, axis=1),
            rtol=1e-5, atol=1e-6,
        )

    def test_padding_rows_never_selected(self, rng):
        rows, centers = _clustered(rng, n=5_000, nc=8)
        idx = IVFIndex(rows, n_clusters=8, metric="dot", n_iters=3)
        assert idx.padding_fraction > 0.0  # layout actually padded
        qs = rng.standard_normal((8, 32)).astype(np.float32)
        got = idx.search_batch(qs, 50)
        assert np.all(got.indices >= 0)
        assert np.all(got.indices < idx.num_vectors)

    def test_k_clamped_and_edges(self, rng):
        rows, _ = _clustered(rng, n=3_000, nc=4)
        idx = IVFIndex(rows, n_clusters=4, metric="dot", n_iters=2)
        q = rng.standard_normal(32).astype(np.float32)
        res = idx.search(q, 7)
        assert res.indices.shape == (7,)
        assert idx.search_batch(q[None], 0).indices.shape == (1, 0)
        # k > N clamps to N and never returns padding.
        big = idx.search(q, idx.num_vectors + 500)
        assert big.indices.shape == (idx.num_vectors,)
        assert len(set(big.indices.tolist())) == idx.num_vectors
        assert np.all(big.indices >= 0)

    def test_single_query_matches_batch_row(self, rng):
        rows, centers = _clustered(rng, n=4_000, nc=8)
        idx = IVFIndex(rows, n_clusters=8, metric="l2", n_iters=3)
        q = (centers[0] + 0.01).astype(np.float32)
        single = idx.search(q, 5)
        batch = idx.search_batch(q[None], 5)
        np.testing.assert_array_equal(single.indices, batch.indices[0])
        np.testing.assert_array_equal(single.scores, batch.scores[0])

    def test_nan_row_is_findable_neighborhood_safe(self, rng):
        # A NaN corpus row poisons its tile's radius -> the planner keeps
        # the tile alive; results must match the plain scan exactly,
        # including the IEEE-total-order contract that NaN sorts FIRST
        # descending (so the NaN row leads both result sets) — i.e. the
        # masked/pruned path must not accidentally drop or demote it.
        rows, centers = _clustered(rng, n=2_048, nc=4)
        rows[100] = np.nan
        idx = IVFIndex(rows, n_clusters=4, metric="dot", n_iters=2)
        qs = (centers[:2] + 0.01).astype(np.float32)
        got = idx.search_batch(qs, 5)
        vb = it.VerticalBatch.from_rows(rows)
        want = it.batch_knn_dot(qs, vb, 5)
        assert _sets_equal(got.indices, want.indices)
        assert np.all(got.indices[:, 0] == 100)
        assert np.all(np.isnan(got.scores[:, 0]))

    def test_bf16_storage(self, rng):
        rows, centers = _clustered(rng, n=4_000, nc=8)
        idx = IVFIndex(rows, n_clusters=8, metric="dot",
                       dtype=jnp.bfloat16, n_iters=3)
        assert idx.rows.dtype == jnp.bfloat16
        qs = (centers[:4] + 0.01).astype(np.float32)
        got = idx.search_batch(qs, 10)
        # bf16 oracle: the bf16 VerticalBatch scan of the same corpus.
        vb = it.VerticalBatch(rows, dtype=jnp.bfloat16)
        want = it.batch_knn_dot(qs, vb, 10)
        assert _sets_equal(got.indices, want.indices)

    def test_full_route_still_masked(self, rng):
        """The XLA route scans every tile (no survivor list): the masked
        mode must still exclude padding."""
        rows = rng.standard_normal((4_100, 32)).astype(np.float32)  # no structure
        idx = IVFIndex(rows, n_clusters=8, metric="dot", n_iters=2,
                       tile_n=512)
        qs = rng.standard_normal((3, 32)).astype(np.float32)
        got = idx.search_batch(qs, 20)
        vb = it.VerticalBatch.from_rows(rows)
        want = it.batch_knn_dot(qs, vb, 20)
        assert _sets_equal(got.indices, want.indices)


class TestIVFElision:
    def test_aligned_layout_elides_hard(self, rng):
        """Well-separated clusters + aligned tiles: survivors must be a
        small fraction — the bound the plain reorder cannot reach
        (straddling tiles; see prune.suggest_tile_n)."""
        rows, centers = _clustered(rng, n=60_000, d=32, nc=64,
                                   spread=6.0, sigma=0.05)
        idx = IVFIndex(rows, n_clusters=64, metric="dot", n_iters=4)
        qs = (centers[:4] + 0.01).astype(np.float32)
        surv, tot = idx.plan_stats(qs, 5)
        assert surv <= max(8, int(0.3 * tot)), (surv, tot)
        # And the search is still exact.
        got = idx.search_batch(qs, 5)
        want = it.batch_knn_dot(qs, it.VerticalBatch.from_rows(rows), 5)
        assert _sets_equal(got.indices, want.indices)

    def test_padding_overhead_bounded(self, rng):
        rows, _ = _clustered(rng, n=50_000, nc=32)
        idx = IVFIndex(rows, n_clusters=32, metric="dot", n_iters=3)
        # <= one tile of padding per cluster, plus the final round-up.
        n_pad_rows = int(idx.rows.shape[0]) - idx.num_vectors
        assert n_pad_rows < 33 * idx.tile_n

    def test_memory_bytes_accounts_everything(self, rng):
        rows, _ = _clustered(rng, n=3_000, nc=4)
        idx = IVFIndex(rows, n_clusters=4, metric="l2", n_iters=2)
        n_pad = int(idx.rows.shape[0])
        expect = n_pad * 32 * 4 + n_pad * 4 + int(idx._aux.size) * 4
        assert idx.memory_bytes() >= expect


class TestIVFContracts:
    def test_bad_metric(self, rng):
        with pytest.raises(ContractError):
            IVFIndex(rng.standard_normal((100, 8)).astype(np.float32),
                     metric="cosine_sim")

    def test_empty_rows(self):
        with pytest.raises(ContractError):
            IVFIndex(np.zeros((0, 8), np.float32))

    def test_bad_query_shape(self, rng):
        idx = IVFIndex(rng.standard_normal((300, 8)).astype(np.float32),
                       n_clusters=2, n_iters=1)
        with pytest.raises(ContractError):
            idx.search_batch(np.zeros((2, 9), np.float32), 3)

    def test_bad_tile_n(self, rng):
        with pytest.raises(ContractError):
            IVFIndex(rng.standard_normal((300, 8)).astype(np.float32),
                     n_clusters=2, tile_n=-5)

    def test_bad_dtype(self, rng):
        with pytest.raises(ContractError):
            IVFIndex(rng.standard_normal((300, 8)).astype(np.float32),
                     dtype=jnp.float16)


class TestIVFSurvivorKillers:
    """Round-5 phase-2 sweep survivors, killed at the value level."""

    def test_tile_n_zero_is_a_contract_error(self, rng):
        # ivf.py guard `tile <= 0` [cmp LtE -> Lt survivor]: tile_n=0
        # must raise ContractError, not ZeroDivisionError three lines
        # later in the padding arithmetic.
        with pytest.raises(ContractError):
            IVFIndex(rng.standard_normal((300, 8)).astype(np.float32),
                     n_clusters=2, tile_n=0)

    def test_original_row_zero_is_findable(self, rng):
        # ivf.py `orig_idx >= 0` validity [cmp GtE -> Gt survivor]: perm
        # value 0 (the row that was FIRST in the original order) must
        # stay valid — the mutant marks it padding and it can never win.
        rows, _ = _clustered(rng, n=2_000, d=16, nc=4)
        ivf = IVFIndex(rows, n_clusters=4, metric="l2", tile_n=256)
        got = ivf.search(rows[0], 1)  # self-distance 0 must win under l2
        assert got.indices[0] == 0

    def test_padding_fraction_exact(self, rng):
        # ivf.py `1.0 - n_true / stored` [binop Sub -> Add survivor]:
        # pin the exact value and its range.
        rows = rng.standard_normal((300, 8)).astype(np.float32)
        ivf = IVFIndex(rows, n_clusters=1, tile_n=256)
        stored = int(ivf.rows.shape[0])
        assert stored == 512  # 300 rows in 1 cluster -> 2 tiles of 256
        assert ivf.padding_fraction == pytest.approx(1.0 - 300 / 512)
        assert 0.0 <= ivf.padding_fraction < 1.0

    @pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
    def test_plan_stats_rederivation_oracle(self, rng, metric):
        # ivf.py plan_stats metric/dtype arms [cmp Eq survivors at the
        # cosine-normalize and bf16-roundtrip branches]: re-derive
        # (n_surv, n_tiles) from the documented transform and the same
        # planner; any arm flip diverges. Queries are deliberately
        # UN-normalized (scale 7) so the cosine unit-normalize arm is
        # load-bearing, and bf16 uses values that round visibly.
        from innr_tpu.prune import plan_survivors
        from innr_tpu.scan import unit_queries as _unit_queries

        rows, centers = _clustered(rng, n=4_000, d=16, nc=8)
        ivf = IVFIndex(rows, n_clusters=8, metric=metric, tile_n=256)
        qs = 7.0 * (
            centers[:5] + 0.01 * rng.standard_normal((5, 16))
        ).astype(np.float32)
        got = ivf.plan_stats(qs, 3)

        ref_q = jnp.asarray(qs)
        if metric == "cosine":
            ref_q = _unit_queries(ref_q)
        s = ivf._summary
        _, ns = plan_survivors(
            ref_q, s.centroids, s.radii, s.counts, 3,
            "l2" if metric == "l2" else "dot",
        )
        assert got == (int(ns), s.n_tiles)
        assert 0 < got[0] <= got[1]

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_plan_stats_bf16_rounds_queries(self, rng, dtype, monkeypatch):
        # The bf16 arm must roundtrip queries through bf16 (matching
        # what the scan kernel sees) and the f32 arm must NOT. Geometry
        # rarely flips a tile on sub-1e-2 rounding, so spy on the
        # planner and pin the qs it actually receives for BOTH dtypes —
        # the Eq->NotEq mutant swaps the arms and fails both.
        from innr_tpu import prune as prune_mod

        rows, _ = _clustered(rng, n=4_000, d=16, nc=8)
        ivf = IVFIndex(rows, n_clusters=8, metric="dot", tile_n=256,
                       dtype=dtype)
        # 1 + 1e-3 perturbations round AWAY in bf16 (eps ~ 7.8e-3)
        qs = (1.0 + 1e-3 * rng.standard_normal((5, 16))).astype(np.float32)
        seen = {}
        real = prune_mod.plan_survivors

        def spy(q, *a, **kw):
            seen["q"] = np.asarray(q)
            return real(q, *a, **kw)

        monkeypatch.setattr(prune_mod, "plan_survivors", spy)
        ivf.plan_stats(qs, 3)
        if dtype == jnp.bfloat16:
            want = np.asarray(
                jnp.asarray(qs).astype(jnp.bfloat16).astype(jnp.float32)
            )
            assert not np.array_equal(seen["q"], qs)  # rounding happened
        else:
            want = qs
        np.testing.assert_array_equal(seen["q"], want)

    @pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
    def test_summary_normalized_arm(self, rng, metric):
        # ivf.py `normalized=(metric == "cosine")` [cmp Eq survivor]:
        # re-derive the tile summary with the documented arm and require
        # equality, plus require the two arms actually DIFFER on this
        # corpus (so the comparison is load-bearing and the NotEq mutant
        # cannot satisfy both).
        rows, _ = _clustered(rng, n=2_000, d=16, nc=4)
        ivf = IVFIndex(rows, n_clusters=4, metric=metric, tile_n=256)
        want = prune.build_tile_summary(
            ivf.rows, ivf.tile_n, normalized=(metric == "cosine"),
            row_valid=ivf._valid,
        )
        other = prune.build_tile_summary(
            ivf.rows, ivf.tile_n, normalized=(metric != "cosine"),
            row_valid=ivf._valid,
        )
        np.testing.assert_array_equal(
            np.asarray(ivf._summary.radii), np.asarray(want.radii)
        )
        assert not np.array_equal(
            np.asarray(want.radii), np.asarray(other.radii)
        )

    def test_plan_stats_uses_l2_planner_for_l2(self, rng):
        # ivf.py plan_stats `"l2" if metric == "l2" else "dot"` [cmp Eq
        # survivor]: on isotropic clusters the two planners often agree,
        # so build a corpus where they CANNOT — a far cluster at 50x the
        # norm is unbeatable under dot (its optimistic bound dominates)
        # but trivially prunable under l2 for a query sitting inside
        # another cluster.
        from innr_tpu.prune import plan_survivors

        # Asymmetric tile counts (the planners can otherwise keep the
        # same NUMBER of tiles from different clusters): ~8 near tiles
        # vs ~24 far tiles, so the surviving COUNT separates the arms.
        d = 16
        near = 0.05 * rng.standard_normal((2_000, d)).astype(np.float32)
        far = (50.0 + 0.05 * rng.standard_normal((6_000, d))).astype(
            np.float32
        )
        rows = np.concatenate([near, far])
        ivf = IVFIndex(rows, n_clusters=2, metric="l2", tile_n=256)
        qs = near[:3] + np.float32(0.01)
        got = ivf.plan_stats(qs, 3)
        s = ivf._summary
        _, ns_l2 = plan_survivors(
            jnp.asarray(qs), s.centroids, s.radii, s.counts, 3, "l2"
        )
        _, ns_dot = plan_survivors(
            jnp.asarray(qs), s.centroids, s.radii, s.counts, 3, "dot"
        )
        assert got == (int(ns_l2), s.n_tiles)
        assert int(ns_l2) != int(ns_dot)  # the arm is load-bearing here
