"""MaxSim late interaction (reference tests/maxsim_tests.rs)."""

import numpy as np
import pytest

import innr_tpu as it
from innr_tpu.ops.reference import maxsim_cosine_portable, maxsim_portable


class TestMaxsim:
    def test_docstring_case(self):
        q = [[1.0, 0.0], [0.0, 1.0]]
        d = [[0.9, 0.1], [0.1, 0.9], [0.5, 0.5]]
        assert float(it.maxsim(q, d)) == pytest.approx(1.8, abs=0.01)

    def test_empty_is_zero(self):
        assert float(it.maxsim([], [[1.0, 2.0]])) == 0.0
        assert float(it.maxsim([[1.0, 2.0]], [])) == 0.0

    def test_ragged_raises(self):
        with pytest.raises(it.ContractError):
            it.maxsim([[1.0, 2.0], [1.0]], [[1.0, 2.0]])

    def test_dim_mismatch_raises(self):
        with pytest.raises(it.ContractError):
            it.maxsim([[1.0, 2.0]], [[1.0, 2.0, 3.0]])

    def test_not_commutative(self, rng):
        q = rng.standard_normal((2, 16)).astype(np.float32)
        d = rng.standard_normal((5, 16)).astype(np.float32)
        assert float(it.maxsim(q, d)) != pytest.approx(float(it.maxsim(d, q)), abs=1e-6)

    def test_additivity_over_query_tokens(self, rng):
        # maxsim([q1; q2], D) == maxsim([q1], D) + maxsim([q2], D)
        # (reference tests/maxsim_tests.rs:56-136).
        q = rng.standard_normal((2, 16)).astype(np.float32)
        d = rng.standard_normal((5, 16)).astype(np.float32)
        whole = float(it.maxsim(q, d))
        parts = float(it.maxsim(q[:1], d)) + float(it.maxsim(q[1:], d))
        assert whole == pytest.approx(parts, abs=1e-4)

    def test_single_query_is_max_dot(self, rng):
        q = rng.standard_normal((1, 32)).astype(np.float32)
        d = rng.standard_normal((7, 32)).astype(np.float32)
        want = max(float(it.dot(q[0], d[j])) for j in range(7))
        assert float(it.maxsim(q, d)) == pytest.approx(want, abs=1e-4)

    @pytest.mark.parametrize("shape", [(1, 1, 4), (3, 5, 16), (8, 2, 128), (2, 9, 65)])
    def test_differential(self, rng, shape):
        tq, td, dim = shape
        q = rng.standard_normal((tq, dim)).astype(np.float32)
        d = rng.standard_normal((td, dim)).astype(np.float32)
        got = float(it.maxsim(q, d))
        want = maxsim_portable(q, d)
        assert got == pytest.approx(want, rel=1e-4, abs=1e-4)


class TestMaxsimCosine:
    def test_differential(self, rng):
        q = rng.standard_normal((3, 24)).astype(np.float32)
        d = rng.standard_normal((5, 24)).astype(np.float32)
        got = float(it.maxsim_cosine(q, d))
        want = maxsim_cosine_portable(q, d)
        assert got == pytest.approx(want, abs=1e-4)

    def test_zero_norm_token_scores_zero(self, rng):
        q = np.zeros((1, 8), np.float32)
        d = rng.standard_normal((3, 8)).astype(np.float32)
        assert float(it.maxsim_cosine(q, d)) == 0.0

    def test_bounded_by_query_count(self, rng):
        q = rng.standard_normal((4, 16)).astype(np.float32)
        d = rng.standard_normal((9, 16)).astype(np.float32)
        assert float(it.maxsim_cosine(q, d)) <= 4.0 + 1e-5


class TestBatchMaxsim:
    def test_matches_pairwise(self, rng):
        queries = rng.standard_normal((3, 4, 16)).astype(np.float32)
        docs = rng.standard_normal((5, 6, 16)).astype(np.float32)
        got = np.asarray(it.batch_maxsim(queries, docs))
        assert got.shape == (3, 5)
        for qi in range(3):
            for ni in range(5):
                want = float(it.maxsim(queries[qi], docs[ni]))
                assert got[qi, ni] == pytest.approx(want, abs=1e-4)


class TestBatchMaxsimMasks:
    def test_doc_mask_excludes_padding(self, rng):
        q = rng.standard_normal((1, 3, 8)).astype(np.float32)
        # Two docs: doc 1 is doc 0 plus a huge padded token that must be
        # ignored under the mask.
        d0 = rng.standard_normal((4, 8)).astype(np.float32)
        d1 = d0.copy(); d1[3] = 100.0
        docs = np.stack([d0, d1])
        mask = np.ones((2, 4), bool); mask[1, 3] = False
        scores = np.asarray(it.batch_maxsim(q, docs, doc_mask=mask))
        # Masked doc1 == doc0 truncated to its first 3 tokens.
        want = float(it.maxsim(q[0], d0[:3]))
        assert scores[0, 1] == pytest.approx(want, rel=1e-5)
        unmasked = np.asarray(it.batch_maxsim(q, docs))
        assert unmasked[0, 1] > unmasked[0, 0]

    def test_query_mask_drops_tokens(self, rng):
        q = rng.standard_normal((1, 4, 8)).astype(np.float32)
        docs = rng.standard_normal((2, 5, 8)).astype(np.float32)
        qmask = np.array([[True, True, False, False]])
        got = np.asarray(it.batch_maxsim(q, docs, query_mask=qmask))
        want = np.asarray(it.batch_maxsim(q[:, :2], docs))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _np_maxsim(q, docs, doc_mask=None):
    """float64 host oracle: sum over query tokens of the best doc-token
    dot; masked doc tokens excluded, an all-masked doc scores 0.0."""
    pair = np.einsum("td,nsd->nts", q.astype(np.float64),
                     docs.astype(np.float64))
    if doc_mask is not None:
        pair = np.where(doc_mask[:, None, :], pair, -np.inf)
    best = pair.max(axis=2)
    best = np.where(best == -np.inf, 0.0, best)
    return best.sum(axis=1)


class TestMaxsimKnn:
    def test_fused_matches_einsum(self, rng):
        q = rng.standard_normal((8, 32)).astype(np.float32)
        docs = rng.standard_normal((300, 12, 32)).astype(np.float32)
        got = _np_maxsim(q, docs)
        want = np.asarray(it.batch_maxsim(q[None], docs))[0]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_public_api_retrieval(self, rng):
        q = rng.standard_normal((4, 16)).astype(np.float32)
        docs = rng.standard_normal((200, 6, 16)).astype(np.float32)
        docs[17, :4] = q[[0, 1, 2, 3]]  # plant the query tokens in doc 17
        vals, idx = it.maxsim_knn(q, docs, 3)
        assert idx[0] == 17
        assert np.all(np.diff(vals) <= 0)

    def test_doc_mask_exact(self, rng):
        q = rng.standard_normal((3, 16)).astype(np.float32)
        docs = rng.standard_normal((150, 8, 16)).astype(np.float32)
        mask = rng.random((150, 8)) < 0.7
        mask[:, 0] = True  # at least one valid token each
        got = _np_maxsim(q, docs, doc_mask=mask)
        want = np.asarray(it.batch_maxsim(q[None], docs, doc_mask=mask))[0]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_all_masked_doc_scores_zero(self, rng):
        q = rng.standard_normal((2, 16)).astype(np.float32)
        docs = rng.standard_normal((100, 4, 16)).astype(np.float32)
        mask = np.ones((100, 4), bool)
        mask[5] = False  # doc 5 has no valid tokens
        got = np.asarray(it.batch_maxsim(q[None], docs, doc_mask=mask))[0]
        assert got[5] == 0.0
        np.testing.assert_allclose(got, _np_maxsim(q, docs, mask),
                                   rtol=1e-4, atol=1e-4)

    def test_edges(self, rng):
        docs = rng.standard_normal((10, 4, 8)).astype(np.float32)
        vals, idx = it.maxsim_knn(np.zeros((0, 8), np.float32), docs, 3)
        assert len(idx) == 0
        vals, idx = it.maxsim_knn(np.ones((2, 8), np.float32), docs, 0)
        assert len(idx) == 0
        with pytest.raises(it.ContractError):
            it.maxsim_knn(np.ones((2, 9), np.float32), docs, 3)


class TestMaxSimKnnBatch:
    """Round-2 multi-query MaxSim retrieval: one corpus pass for a
    (B, Tq, D) query batch, parity with single-query maxsim_knn."""

    def test_batch_matches_single(self, rng):
        from innr_tpu.ops.maxsim import maxsim_knn, maxsim_knn_batch

        docs = rng.standard_normal((150, 10, 16)).astype(np.float32)
        qs = rng.standard_normal((5, 6, 16)).astype(np.float32)
        vals, idx = maxsim_knn_batch(qs, docs, 4)
        assert vals.shape == (5, 4)
        for b in range(5):
            v1, i1 = maxsim_knn(qs[b], docs, 4)
            np.testing.assert_array_equal(idx[b], i1)
            np.testing.assert_allclose(vals[b], v1, rtol=1e-5, atol=1e-5)

    def test_batch_fused_matches_einsum(self, rng, monkeypatch, force_triton):
        from innr_tpu import config
        from innr_tpu.ops.maxsim import maxsim_knn_batch

        docs = rng.standard_normal((200, 8, 16)).astype(np.float32)
        mask = rng.random((200, 8)) > 0.25
        mask[:, 0] = True
        qs = rng.standard_normal((3, 5, 16)).astype(np.float32)
        want_v, want_i = maxsim_knn_batch(qs, docs, 6, doc_mask=mask)
        force_triton()
        got_v, got_i = maxsim_knn_batch(qs, docs, 6, doc_mask=mask)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=1e-5)

    def test_zero_padded_ragged_queries_exact(self, rng):
        from innr_tpu.ops.maxsim import maxsim, maxsim_knn_batch

        docs = rng.standard_normal((120, 6, 8)).astype(np.float32)
        q_short = rng.standard_normal((3, 8)).astype(np.float32)
        q_padded = np.zeros((1, 7, 8), np.float32)
        q_padded[0, :3] = q_short
        vals, idx = maxsim_knn_batch(q_padded, docs, 3)
        want = float(maxsim(q_short, docs[int(idx[0, 0])]))
        np.testing.assert_allclose(vals[0, 0], want, rtol=1e-5)


class TestBf16MaxSim:
    def test_fused_maxsim_bf16_docs(self, rng, monkeypatch):
        import jax.numpy as jnp

        docs = rng.standard_normal((200, 6, 16)).astype(np.float32)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        v32, i32 = it.maxsim_knn(q, docs, 5)
        v16, i16 = it.maxsim_knn(q, jnp.asarray(docs, dtype=jnp.bfloat16), 5)
        np.testing.assert_allclose(
            np.asarray(v16), np.asarray(v32), rtol=3e-2, atol=3e-2
        )
