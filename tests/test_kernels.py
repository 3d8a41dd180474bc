"""Dense scan routes vs float64 oracles.

Every dense kNN scan runs either on the XLA route (:mod:`innr_tpu.scan`)
or through the Triton kernel (:mod:`innr_tpu.kernels.triton_knn`). Here
the kernel runs in Pallas interpret mode, which these tests ask for
explicitly; the library never does.
"""

import numpy as np
import pytest

import innr_tpu as it
from innr_tpu import scan
from innr_tpu.kernels import triton_knn

import jax.numpy as jnp

ROUTES = ["xla", "triton"]


def _knn(qs, rows, aux, k, mode, route, block_n=256):
    """(scores, indices) of one dense scan on ``route``."""
    qs = jnp.asarray(qs, jnp.float32)
    rows = jnp.asarray(rows)
    if route == "xla":
        return scan.knn(qs, rows, aux, k, mode, route="xla")
    keys, idx = triton_knn.knn_keys(qs, rows, aux, k, mode,
                                    block_n=block_n, interpret=True)
    # Triton L2 keys are always in the decomposed form.
    n_rows = max(int(rows.shape[0]), scan.DIRECT_L2_MAX_ROWS)
    return scan.decode_keys(keys, mode, qs, n_rows), idx


def fused_knn_dot(q, rows, k, route):
    vals, idx = _knn(jnp.asarray(q)[None, :], rows, None, k, "dot", route)
    return vals[0], idx[0]


def fused_knn_l2(q, rows, k, route):
    rows = jnp.asarray(rows)
    r = rows.astype(jnp.float32)
    vals, idx = _knn(jnp.asarray(q)[None, :], rows, jnp.sum(r * r, axis=1),
                     k, "l2", route)
    return vals[0], idx[0]


def fused_knn_l2_batch(qs, rows, k, route):
    r = jnp.asarray(rows, jnp.float32)
    return _knn(qs, rows, jnp.sum(r * r, axis=1), k, "l2", route)


def fused_knn_cosine(q, rows, k, route):
    rows = jnp.asarray(rows)
    qs = scan.unit_queries(jnp.asarray(q, jnp.float32)[None, :])
    vals, idx = _knn(qs, rows, scan.inv_norms(rows), k, "cosine", route)
    return vals[0], idx[0]


class TestFusedKnn:
    @pytest.mark.parametrize("n,d,k", [(600, 32, 5), (1024, 128, 10), (777, 48, 3)])
    def test_dot_matches_oracle(self, rng, n, d, k):
        for route in ROUTES:
            rows = rng.standard_normal((n, d)).astype(np.float32)
            q = rng.standard_normal(d).astype(np.float32)
            vals, idx = fused_knn_dot(q, rows, k, route)
            dots = rows.astype(np.float64) @ q.astype(np.float64)
            want = np.argsort(-dots, kind="stable")[:k]
            np.testing.assert_array_equal(np.asarray(idx), want)
            np.testing.assert_allclose(np.asarray(vals), dots[want], rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("n,d,k", [(600, 32, 5), (1030, 64, 7)])
    def test_l2_matches_oracle(self, rng, n, d, k):
        for route in ROUTES:
            rows = rng.standard_normal((n, d)).astype(np.float32)
            q = rng.standard_normal(d).astype(np.float32)
            vals, idx = fused_knn_l2(q, rows, k, route)
            l2 = np.sum((rows.astype(np.float64) - q) ** 2, axis=1)
            want = np.argsort(l2, kind="stable")[:k]
            np.testing.assert_array_equal(np.asarray(idx), want)
            np.testing.assert_allclose(np.asarray(vals), l2[want], rtol=1e-3, atol=1e-3)

    def test_matches_batch_knn_dispatch(self, rng):
        # batch_knn_dot with and without the forced reference path must
        # agree (on the CPU both take the XLA route).
        from innr_tpu import config

        rows = rng.standard_normal((2148, 32)).astype(np.float32)
        q = rng.standard_normal(32).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn_dot(q, vb, 4)
        config.force_reference(True)
        try:
            ref_res = it.batch_knn_dot(q, vb, 4)
        finally:
            config.force_reference(False)
        np.testing.assert_array_equal(res.indices, ref_res.indices)
        np.testing.assert_allclose(res.scores, ref_res.scores, rtol=1e-5, atol=1e-5)

    def test_k_larger_than_tile_merges(self, rng):
        for route in ROUTES:
            rows = rng.standard_normal((900, 16)).astype(np.float32)
            q = rng.standard_normal(16).astype(np.float32)
            vals, idx = fused_knn_dot(q, rows, 64, route)
            dots = rows.astype(np.float64) @ q.astype(np.float64)
            np.testing.assert_array_equal(
                np.asarray(idx), np.argsort(-dots, kind="stable")[:64]
            )

    def test_k_beyond_old_cap_single_pass(self, rng):
        """Large k on the XLA route: one top-k, no cap."""
        k = 600
        rows = rng.standard_normal((2000, 16)).astype(np.float32)
        q = rng.standard_normal(16).astype(np.float32)
        vals, idx = fused_knn_dot(q, rows, k, "xla")
        dots = (rows.astype(np.float64) @ q.astype(np.float64)).astype(np.float32)
        want = np.argsort(-dots, kind="stable")[:k]
        np.testing.assert_array_equal(np.asarray(idx), want)

    def test_k_beyond_pass_cap_multi_pass(self, rng):
        """Quantized scores force many exact ties; selection must equal a
        stable one-shot sort bit-for-bit (k=300 on XLA; the kernel's
        largest k on Triton)."""
        for route in ROUTES:
            k = 300 if route == "xla" else triton_knn.K_MAX
            rows = (rng.integers(-3, 4, (1500, 16))).astype(np.float32)
            q = rng.integers(-3, 4, 16).astype(np.float32)
            vals, idx = fused_knn_dot(q, rows, k, route)
            dots = (rows.astype(np.float64) @ q.astype(np.float64)).astype(np.float32)
            want = np.argsort(-dots, kind="stable")[:k]
            np.testing.assert_array_equal(np.asarray(idx), want)
            np.testing.assert_array_equal(np.asarray(vals), dots[want])

    def test_multi_pass_l2_batch(self, rng):
        for route in ROUTES:
            k = 200 if route == "xla" else 100
            rows = rng.standard_normal((1024, 32)).astype(np.float32)
            qs = rng.standard_normal((3, 32)).astype(np.float32)
            vals, idx = fused_knn_l2_batch(qs, rows, k, route)
            d = rows[None, :, :].astype(np.float64) - qs[:, None, :].astype(np.float64)
            dist = np.sum(d * d, axis=2)
            for i in range(3):
                want = np.argsort(dist[i], kind="stable")[:k]
                np.testing.assert_array_equal(np.asarray(idx)[i], want)

    @pytest.mark.parametrize("k", [129, 256, 500])
    def test_large_k_multilane(self, rng, k):
        """k past the kernel's cap runs on the XLA route: the ranking must
        match brute force exactly."""
        rows = rng.standard_normal((1024, 32)).astype(np.float32)
        q = rng.standard_normal(32).astype(np.float32)
        vals, idx = fused_knn_dot(q, rows, k, "xla")
        dots = (rows.astype(np.float64) @ q.astype(np.float64)).astype(np.float32)
        want = np.argsort(-dots, kind="stable")[:k]
        np.testing.assert_array_equal(np.asarray(idx), want)
        np.testing.assert_allclose(np.asarray(vals), dots[want], rtol=1e-5, atol=1e-4)

    def test_duplicate_scores_stable(self, rng):
        for route in ROUTES:
            rows = np.repeat(rng.standard_normal((5, 16)).astype(np.float32), 40, axis=0)
            q = rng.standard_normal(16).astype(np.float32)
            vals, idx = fused_knn_dot(q, rows, 3, route)
            dots = rows.astype(np.float64) @ q.astype(np.float64)
            want = np.argsort(-dots, kind="stable")[:3]
            np.testing.assert_array_equal(np.asarray(idx), want)


class TestHammingKernels:
    def test_batch_hamming_words(self, rng):
        corpus = rng.integers(0, 2**32, (300, 8), dtype=np.uint32)
        q = corpus[11]
        got = np.asarray(it.batch_binary_hamming(jnp.asarray(q), jnp.asarray(corpus)))
        want = np.zeros(300, np.uint32)
        for i, row in enumerate(corpus):
            want[i] = sum(bin(int(a) ^ int(b)).count("1") for a, b in zip(row, q))
        np.testing.assert_array_equal(got, want)

    def test_batch_ternary_dot_words(self, rng):
        rows = rng.standard_normal((200, 96)).astype(np.float32)
        pos, neg = it.encode_ternary_batch(rows, 0.5)
        tq = it.encode_ternary(rows[7], 0.5)
        got = np.asarray(
            it.batch_ternary_dot(tq, jnp.asarray(pos), jnp.asarray(neg))
        )
        tern = np.where(rows > 0.5, 1, np.where(rows < -0.5, -1, 0))
        want = tern @ tern[7]
        np.testing.assert_array_equal(got, want)


class TestFusedBatch:
    def test_multi_query_matches_single(self, rng):
        for route in ROUTES:
            rows = rng.standard_normal((700, 32)).astype(np.float32)
            qs = rng.standard_normal((5, 32)).astype(np.float32)
            vals, idx = _knn(qs, rows, None, 4, "dot", route)
            for j in range(5):
                v1, i1 = fused_knn_dot(qs[j], rows, 4, route)
                np.testing.assert_array_equal(np.asarray(idx)[j], np.asarray(i1))
                np.testing.assert_allclose(np.asarray(vals)[j], np.asarray(v1), rtol=1e-6)

    def test_multi_query_l2(self, rng):
        for route in ROUTES:
            rows = rng.standard_normal((600, 16)).astype(np.float32)
            qs = rng.standard_normal((3, 16)).astype(np.float32)
            vals, idx = fused_knn_l2_batch(qs, rows, 3, route)
            for j in range(3):
                l2 = np.sum((rows.astype(np.float64) - qs[j]) ** 2, axis=1)
                want = np.argsort(l2, kind="stable")[:3]
                np.testing.assert_array_equal(np.asarray(idx)[j], want)

    def test_public_api_multi_query(self, rng):
        rows = rng.standard_normal((300, 24)).astype(np.float32)
        qs = rng.standard_normal((4, 24)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn_dot(qs, vb, 3)
        assert res.indices.shape == (4, 3)
        for j in range(4):
            single = it.batch_knn_dot(qs[j], vb, 3)
            np.testing.assert_array_equal(res.indices[j], single.indices)

    def test_public_api_multi_query_l2(self, rng):
        rows = rng.standard_normal((300, 24)).astype(np.float32)
        qs = rng.standard_normal((4, 24)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn(qs, vb, 3)
        assert res.indices.shape == (4, 3)
        for j in range(4):
            single = it.batch_knn(qs[j], vb, 3)
            np.testing.assert_array_equal(res.indices[j], single.indices)


class TestFusedCosine:
    def test_fused_cosine_matches_oracle(self, rng):
        for route in ROUTES:
            rows = rng.standard_normal((900, 48)).astype(np.float32)
            rows[17] = 0.0  # zero-norm row must score exactly 0.0
            q = rng.standard_normal(48).astype(np.float32)
            vals, idx = fused_knn_cosine(q, rows, 6, route)
            norms = np.linalg.norm(rows.astype(np.float64), axis=1)
            qn = np.linalg.norm(q.astype(np.float64))
            ref = np.where(norms > 1e-9, rows.astype(np.float64) @ q / (qn * np.maximum(norms, 1e-30)), 0.0)
            want = np.argsort(-ref, kind="stable")[:6]
            np.testing.assert_array_equal(np.asarray(idx), want)
            np.testing.assert_allclose(np.asarray(vals), ref[want], rtol=1e-4, atol=1e-5)

    def test_dispatch_matches_jnp_path(self, rng):
        from innr_tpu import config

        rows = rng.standard_normal((2064, 24)).astype(np.float32)
        q = rng.standard_normal(24).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        res = it.batch_knn_cosine(q, vb, 5)
        config.force_reference(True)
        try:
            ref = it.batch_knn_cosine(q, vb, 5)
        finally:
            config.force_reference(False)
        np.testing.assert_array_equal(res.indices, ref.indices)
        np.testing.assert_allclose(res.scores, ref.scores, rtol=1e-4, atol=1e-5)

    def test_zero_query_norm_falls_back(self, rng):
        for route in ROUTES:
            rows = rng.standard_normal((700, 16)).astype(np.float32)
            vals, _ = fused_knn_cosine(np.zeros(16, np.float32), rows, 3, route)
            np.testing.assert_array_equal(np.asarray(vals), np.zeros(3, np.float32))


class TestRaggedBlockBoundaries:
    """The Triton kernel runs a ragged final corpus block (no row padding —
    a pad is a full corpus copy) and masks the tail rows. Sweep n across
    block boundaries and d across chunk boundaries to pin the masking."""

    @pytest.mark.parametrize("n", [8191, 8192, 8193, 8200])
    def test_dot_across_tile_boundary(self, rng, n):
        rows = rng.standard_normal((n, 16)).astype(np.float32)
        qs = rng.standard_normal((3, 16)).astype(np.float32)
        vals, idx = _knn(qs, rows, None, 5, "dot", "triton", block_n=4096)
        dots = rows.astype(np.float64) @ qs.T.astype(np.float64)
        for i in range(3):
            want = np.argsort(-dots[:, i], kind="stable")[:5]
            np.testing.assert_array_equal(np.asarray(idx)[i], want)

    @pytest.mark.parametrize("d", [1, 3, 127, 129, 255, 640])
    def test_l2_odd_dims(self, rng, d):
        # Widths with no power-of-two chunk take the XLA route.
        rows = rng.standard_normal((600, d)).astype(np.float32)
        q = rng.standard_normal(d).astype(np.float32)
        route = "triton" if triton_knn.d_chunk(d) else "xla"
        vals, idx = fused_knn_l2(q, rows, 4, route)
        dist = np.sum((rows.astype(np.float64) - q) ** 2, axis=1)
        want = np.argsort(dist, kind="stable")[:4]
        np.testing.assert_array_equal(np.asarray(idx), want)

    def test_last_block_rows_can_win(self, rng):
        for route in ROUTES:
            # Plant the best row in the ragged tail: it must not be masked.
            n = 1025  # one row beyond a block boundary
            rows = rng.standard_normal((n, 32)).astype(np.float32)
            q = rng.standard_normal(32).astype(np.float32)
            rows[-1] = q * 10  # overwhelming dot winner, in the ragged block
            vals, idx = fused_knn_dot(q, rows, 3, route)
            assert int(np.asarray(idx)[0]) == n - 1

    def test_packed_ragged_tail(self, rng):
        n = 16400
        words = rng.integers(0, 2**32, (n, 4), dtype=np.uint32)
        corpus = it.PackedBinaryBatch(jnp.asarray(words), 128)
        q = it.PackedBinary(jnp.asarray(rng.integers(0, 2**32, 4, dtype=np.uint32)), 128)
        counts, idx = it.binary_knn(q, corpus, 7)
        xor = np.ascontiguousarray(words ^ np.asarray(q.words)[None, :])
        brute = np.unpackbits(xor.view(np.uint8), axis=1).sum(axis=1)
        want = np.argsort(brute, kind="stable")[:7]
        np.testing.assert_array_equal(np.asarray(idx), want)


class TestFusedSparseKnn:
    """The searchsorted sparse join (ops/sparse.py), scores and top-k in
    one jitted dispatch, vs a host oracle."""

    @staticmethod
    def _corpus(rng, n, l, vocab=4096):
        ci = np.sort(rng.integers(0, vocab, (n, l)).astype(np.uint32), axis=1)
        cv = rng.standard_normal((n, l)).astype(np.float32)
        return ci, cv

    @staticmethod
    def _oracle(qi, qv, ci, cv, k):
        """float64 host join; first query occurrence wins on duplicates."""
        first = {}
        for i, v in zip(qi.tolist(), qv.tolist()):
            first.setdefault(i, v)
        scores = np.array([
            sum(float(v) * first[i] for i, v in zip(row_i.tolist(), row_v.tolist())
                if i in first)
            for row_i, row_v in zip(ci, cv)
        ])
        return scores, np.argsort(-scores, kind="stable")[:k]

    @pytest.mark.parametrize("n,l,lq", [(700, 16, 24), (1100, 8, 1), (513, 24, 7)])
    def test_matches_xla_join(self, rng, n, l, lq):
        from innr_tpu.ops.sparse import SparseCorpus, sparse_knn

        ci, cv = self._corpus(rng, n, l)
        corpus = SparseCorpus((jnp.asarray(ci), jnp.asarray(cv)))
        qi = np.sort(rng.choice(4096, lq, replace=False)).astype(np.uint32)
        qv = rng.standard_normal(lq).astype(np.float32)
        vals, idx = sparse_knn((qi, qv), corpus, 9)
        scores, want = self._oracle(qi, qv, ci, cv, 9)
        np.testing.assert_allclose(np.asarray(vals), scores[np.asarray(idx)],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.sort(scores[np.asarray(idx)])[::-1],
                                   scores[want], rtol=1e-5, atol=1e-5)

    def test_sentinel_padding_and_nan(self, rng):
        from innr_tpu.ops.sparse import SENTINEL_INDEX, SparseCorpus, sparse_knn

        ci, cv = self._corpus(rng, 640, 12)
        ci[3, 8:] = SENTINEL_INDEX
        cv[3, 8:] = 0.0
        cv[5, 2] = np.nan          # unmatched NaN must contribute 0
        ci[7, 4] = 77
        cv[7, 4] = np.nan          # matched NaN must poison doc 7's score
        corpus = SparseCorpus((jnp.asarray(ci), jnp.asarray(cv)))
        qi = np.unique(
            np.concatenate([[77], rng.choice(4096, 15, replace=False)])
        ).astype(np.uint32)
        qi = qi[qi != ci[5, 2]]    # ensure the doc-5 NaN entry stays unmatched
        qv = rng.standard_normal(qi.size).astype(np.float32)
        vals, idx = sparse_knn((qi, qv), corpus, 8)
        # the matched-NaN doc sorts FIRST under IEEE total order descending
        assert int(np.asarray(idx)[0]) == 7
        assert np.isnan(np.asarray(vals)[0])
        assert not np.isnan(np.asarray(vals)[1:]).any()

    def test_duplicate_query_indices_first_occurrence_wins(self, rng):
        from innr_tpu.ops.sparse import SparseCorpus, sparse_knn

        ci, cv = self._corpus(rng, 520, 8, vocab=64)
        corpus = SparseCorpus((jnp.asarray(ci), jnp.asarray(cv)))
        qi = np.array([3, 9, 9, 40], dtype=np.uint32)  # sorted, dup 9
        qv = np.array([1.0, 5.0, -5.0, 2.0], dtype=np.float32)
        vals, idx = sparse_knn((qi, qv), corpus, 6)
        scores, _ = self._oracle(qi, qv, ci, cv, 6)
        np.testing.assert_allclose(np.asarray(vals), scores[np.asarray(idx)],
                                   rtol=1e-5, atol=1e-5)

    def test_ragged_tail_doc_can_win(self, rng):
        from innr_tpu.ops.sparse import SparseCorpus, sparse_knn

        n = 601
        ci, cv = self._corpus(rng, n, 8, vocab=128)
        ci[-1, 0] = 5
        cv[-1, 0] = 100.0  # overwhelming winner in the last row
        corpus = SparseCorpus((jnp.asarray(ci), jnp.asarray(cv)))
        qi = np.array([5], dtype=np.uint32)
        qv = np.array([1.0], dtype=np.float32)
        _, idx = sparse_knn((qi, qv), corpus, 3)
        assert int(np.asarray(idx)[0]) == n - 1

    def test_sparse_knn_forced_reference_agrees(self, rng):
        """force_reference keeps the same XLA join: identical results."""
        from innr_tpu import config
        from innr_tpu.ops.sparse import SparseCorpus, sparse_knn

        ci, cv = self._corpus(rng, 300, 8, vocab=256)
        corpus = SparseCorpus((jnp.asarray(ci), jnp.asarray(cv)))
        qi = np.sort(rng.choice(256, 5, replace=False)).astype(np.uint32)
        qv = rng.standard_normal(5).astype(np.float32)
        v1, i1 = sparse_knn((qi, qv), corpus, 4)
        config.force_reference(True)
        try:
            v2, i2 = sparse_knn((qi, qv), corpus, 4)
        finally:
            config.force_reference(False)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
