"""Packed kNN scans (binary Hamming, ternary, u8 asymmetric) vs
brute-force oracles."""

import numpy as np
import pytest

import innr_tpu as it
from innr_tpu import config, scan
from innr_tpu.ops.binary import binary_knn_batch
from innr_tpu.ops.ternary import ternary_knn_batch

import jax.numpy as jnp

# A corpus taller than the XLA route's direct-L2 threshold (the old
# kernel-dispatch size, kept so the "large" cases stay large).
LARGE = scan.DIRECT_L2_MAX_ROWS


class TestBinaryKnn:
    @pytest.mark.parametrize("n,d,k", [(500, 128, 5), (1200, 256, 10), (777, 96, 3)])
    def test_fused_matches_bruteforce(self, rng, n, d, k):
        rows = rng.standard_normal((n, d)).astype(np.float32)
        corpus = it.PackedBinaryBatch.encode(rows, 0.0)
        q = it.encode_binary(rows[7] + 0.1, 0.0)
        counts, idx = it.binary_knn(q, corpus, k)
        ref_counts = np.sum(
            (rows > 0) != np.asarray([q.get(i) for i in range(d)])[None, :], axis=1
        )
        want = np.argsort(ref_counts, kind="stable")[:k]
        np.testing.assert_array_equal(np.asarray(idx), want)
        np.testing.assert_array_equal(np.asarray(counts), ref_counts[want])

    def test_public_api_small_and_large_agree(self, rng):
        rows = rng.standard_normal((LARGE + 64, 64)).astype(np.float32)
        corpus = it.PackedBinaryBatch.encode(rows, 0.0)
        q = it.encode_binary(rows[3], 0.0)
        counts, idx = it.binary_knn(q, corpus, 5)
        assert idx[0] == 3 and counts[0] == 0
        # jnp path on a truncated corpus must pick the same top-1
        small = it.PackedBinaryBatch.encode(rows[:100], 0.0)
        counts2, idx2 = it.binary_knn(q, small, 5)
        assert idx2[0] == 3

    def test_edge_cases(self, rng):
        corpus = it.PackedBinaryBatch.encode(rng.standard_normal((10, 32)).astype(np.float32), 0.0)
        q = it.PackedBinary.zeros(32)
        counts, idx = it.binary_knn(q, corpus, 0)
        assert len(idx) == 0
        counts, idx = it.binary_knn(q, corpus, 100)
        assert len(idx) == 10
        with pytest.raises(it.ContractError):
            it.binary_knn(it.PackedBinary.zeros(33), corpus, 3)


class TestTernaryKnn:
    @pytest.mark.parametrize("n,d,k", [(600, 128, 5), (900, 192, 7)])
    def test_fused_matches_bruteforce(self, rng, n, d, k):
        rows = rng.standard_normal((n, d)).astype(np.float32)
        corpus = it.PackedTernaryBatch.encode(rows, 0.5)
        q = it.encode_ternary(rows[11], 0.5)
        dots, idx = it.ternary_knn(q, corpus, k)
        tern = np.where(rows > 0.5, 1, np.where(rows < -0.5, -1, 0))
        qv = tern[11]
        ref_dots = tern @ qv
        want = np.argsort(-ref_dots, kind="stable")[:k]
        np.testing.assert_array_equal(np.asarray(idx), want)
        np.testing.assert_array_equal(np.asarray(dots), ref_dots[want])

    def test_public_api(self, rng):
        rows = rng.standard_normal((300, 64)).astype(np.float32)
        corpus = it.PackedTernaryBatch.encode(rows, 0.5)
        q = it.encode_ternary(rows[42], 0.5)
        dots, idx = it.ternary_knn(q, corpus, 3)
        assert idx[0] == 42
        assert dots[0] == it.encode_ternary(rows[42], 0.5).nnz()


class TestU8Knn:
    @pytest.mark.parametrize("n,d,k", [(600, 64, 5), (1100, 128, 8)])
    def test_fused_u8_matches_oracle(self, rng, n, d, k):
        codes = rng.integers(0, 256, (n, d), dtype=np.uint8)
        qs = rng.standard_normal((3, d)).astype(np.float32)
        mixed, idx = scan.knn(jnp.asarray(qs), jnp.asarray(codes), None, k, "dot")
        for j in range(3):
            ref = codes.astype(np.float64) @ qs[j].astype(np.float64)
            want = np.argsort(-ref, kind="stable")[:k]
            np.testing.assert_array_equal(np.asarray(idx)[j], want)
            np.testing.assert_allclose(np.asarray(mixed)[j], ref[want], rtol=1e-4, atol=1e-2)

    def test_batch_knn_u8_dispatch_agrees(self, rng):
        rows = rng.standard_normal((LARGE + 32, 48)).astype(np.float32)
        params = it.QuantizationParams.fit(rows)
        batch = it.QuantizedU8Batch.quantize(rows, params)
        q = rng.standard_normal(48).astype(np.float32)
        fused = it.batch_knn_u8(q, batch, params, 5)
        config.force_reference(True)
        try:
            refr = it.batch_knn_u8(q, batch, params, 5)
        finally:
            config.force_reference(False)
        assert [i for i, _ in fused] == [i for i, _ in refr]
        for (_, a), (_, b) in zip(fused, refr):
            assert a == pytest.approx(b, rel=1e-4, abs=1e-3)

    def test_u8_rejects_f32(self, rng):
        # QuantizedU8Batch holds uint8 codes whatever it is given.
        params = it.QuantizationParams.fit(rng.standard_normal((16, 8)).astype(np.float32))
        batch = it.QuantizedU8Batch.quantize(
            rng.standard_normal((16, 8)).astype(np.float32), params
        )
        assert batch.codes.dtype == jnp.uint8


class TestBinaryKnnBatch:
    def test_fused_multi_query_matches_single(self, rng):
        rows = rng.standard_normal((3000, 128)).astype(np.float32)
        corpus = it.PackedBinaryBatch.encode(rows, 0.0)
        qs = [it.encode_binary(rows[i] + 0.1, 0.0) for i in (3, 77, 500)]
        counts, idx = binary_knn_batch(qs, corpus, 5)
        for j, q in enumerate(qs):
            c1, i1 = it.binary_knn(q, corpus, 5)
            np.testing.assert_array_equal(np.asarray(idx)[j], np.asarray(i1))
            np.testing.assert_array_equal(np.asarray(counts)[j], np.asarray(c1))

    def test_public_batch_api(self, rng):
        rows = rng.standard_normal((400, 64)).astype(np.float32)
        corpus = it.PackedBinaryBatch.encode(rows, 0.0)
        queries = [it.encode_binary(rows[i], 0.0) for i in (1, 9)]
        counts, idx = binary_knn_batch(queries, corpus, 3)
        assert idx.shape == (2, 3)
        assert idx[0, 0] == 1 and idx[1, 0] == 9
        assert counts[0, 0] == 0

    def test_word_count_mismatch(self, rng):
        rows = rng.standard_normal((100, 64)).astype(np.float32)
        corpus = it.PackedBinaryBatch.encode(rows, 0.0)
        with pytest.raises(it.ContractError):
            binary_knn_batch(np.zeros((2, 5), np.uint32), corpus, 3)


class TestPipelineBatch:
    def test_search_batch_matches_search(self, rng):
        rows = rng.standard_normal((800, 64)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        from innr_tpu.pipeline import TwoStageIndex

        index = TwoStageIndex(rows, "binary", rerank_factor=8)
        queries = rows[[5, 100, 321]]
        batch = index.search_batch(queries, 4)
        assert batch.indices.shape == (3, 4)
        for j in range(3):
            single = index.search(queries[j], 4)
            np.testing.assert_array_equal(batch.indices[j], single.indices)

    def test_search_batch_other_kinds(self, rng):
        rows = rng.standard_normal((300, 32)).astype(np.float32)
        from innr_tpu.pipeline import CoarseConfig, TwoStageIndex

        for kind in ("u8", "matryoshka"):
            index = TwoStageIndex(
                rows, CoarseConfig(kind=kind, prefix_dims=16), rerank_factor=8
            )
            res = index.search_batch(rows[[2, 7]], 3)
            assert res.indices[0, 0] == 2 and res.indices[1, 0] == 7


class TestLargeKFallback:
    def test_k_over_128_uses_xla_path(self, rng):
        n = LARGE + 64
        rows = rng.standard_normal((n, 16)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        q = rng.standard_normal(16).astype(np.float32)
        res = it.batch_knn_dot(q, vb, 200)  # > kernel buffer width
        assert len(res.indices) == 200
        dots = rows.astype(np.float64) @ q.astype(np.float64)
        np.testing.assert_array_equal(
            res.indices, np.argsort(-dots, kind="stable")[:200]
        )

    def test_binary_knn_large_k(self, rng):
        n = LARGE + 8
        rows = rng.standard_normal((n, 64)).astype(np.float32)
        corpus = it.PackedBinaryBatch.encode(rows, 0.0)
        q = it.encode_binary(rows[0], 0.0)
        counts, idx = it.binary_knn(q, corpus, 300)
        assert len(idx) == 300 and idx[0] == 0

    def test_ternary_knn_large_k(self, rng):
        n = LARGE + 8
        rows = rng.standard_normal((n, 64)).astype(np.float32)
        corpus = it.PackedTernaryBatch.encode(rows, 0.5)
        q = it.encode_ternary(rows[3], 0.5)
        dots, idx = it.ternary_knn(q, corpus, 200)
        assert len(idx) == 200 and idx[0] == 3

    def test_batch_knn_u8_large_k(self, rng):
        n = LARGE + 8
        rows = rng.standard_normal((n, 32)).astype(np.float32)
        params = it.QuantizationParams.fit(rows)
        batch = it.QuantizedU8Batch.quantize(rows, params)
        res = it.batch_knn_u8(rows[5], batch, params, 200)
        assert len(res) == 200 and res[0][0] == 5


class TestTernaryKnnBatch:
    def test_fused_multi_query_matches_single(self, rng):
        rows = rng.standard_normal((2500, 96)).astype(np.float32)
        corpus = it.PackedTernaryBatch.encode(rows, 0.5)
        qs = [it.encode_ternary(rows[i], 0.5) for i in (3, 77, 500)]
        dots, idx = ternary_knn_batch(qs, corpus, 5)
        for j, q in enumerate(qs):
            d1, i1 = it.ternary_knn(q, corpus, 5)
            np.testing.assert_array_equal(np.asarray(idx)[j], np.asarray(i1))
            np.testing.assert_array_equal(np.asarray(dots)[j], np.asarray(d1))

    def test_public_batch_api_small(self, rng):
        rows = rng.standard_normal((300, 64)).astype(np.float32)
        corpus = it.PackedTernaryBatch.encode(rows, 0.5)
        queries = [it.encode_ternary(rows[i], 0.5) for i in (4, 42)]
        dots, idx = ternary_knn_batch(queries, corpus, 3)
        assert idx.shape == (2, 3)
        assert idx[0, 0] == 4 and idx[1, 0] == 42

    def test_plane_mismatch_raises(self, rng):
        rows = rng.standard_normal((100, 64)).astype(np.float32)
        corpus = it.PackedTernaryBatch.encode(rows, 0.5)
        bad = it.PackedTernaryBatch.encode(rng.standard_normal((2, 96)).astype(np.float32), 0.5)
        with pytest.raises(it.ContractError):
            ternary_knn_batch(bad, corpus, 3)
