"""Distributed kNN over an 8-virtual-device CPU mesh: the sharded scan must
match the single-chip result exactly (indices) and closely (scores)."""

import jax
import numpy as np
import pytest

import innr_tpu as it
from innr_tpu.parallel import ShardedCorpus, default_mesh


@pytest.fixture(scope="module")
def devices_ok():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")


class TestShardedKnn:
    def test_mesh_has_8_devices(self, devices_ok):
        assert default_mesh().devices.size == 8

    def test_dot_matches_single_chip(self, rng, devices_ok):
        rows = rng.standard_normal((1000, 64)).astype(np.float32)
        q = rng.standard_normal(64).astype(np.float32)
        sc = ShardedCorpus(rows)
        vals, idx = sc.knn_dot(q, 7)
        vb = it.VerticalBatch.from_rows(rows)
        want = it.batch_knn_dot(q, vb, 7)
        np.testing.assert_array_equal(np.asarray(idx), want.indices)
        np.testing.assert_allclose(np.asarray(vals), want.scores, rtol=1e-5)

    def test_dot_large_k_stays_fused(self, rng, devices_ok):
        """Large k + pad: each shard over-fetches by the pad count (clamped
        to the shard height) and the merged result must still match the
        single-device path exactly."""
        from innr_tpu.parallel.sharded import _plan_local_k

        rows = rng.standard_normal((17000, 24)).astype(np.float32)
        sc = ShardedCorpus(rows)
        pad = sc.n_pad - sc.n_true
        assert _plan_local_k(sc, 600) == min(600 + pad, sc.shard_rows)
        q = rng.standard_normal(24).astype(np.float32)
        vals, idx = sc.knn_dot(q, 600)
        dots = rows.astype(np.float64) @ q.astype(np.float64)
        want = np.argsort(-dots.astype(np.float32), kind="stable")[:600]
        np.testing.assert_array_equal(np.asarray(idx), want)

    def test_l2_matches_single_chip(self, rng, devices_ok):
        rows = rng.standard_normal((1000, 64)).astype(np.float32)
        q = rng.standard_normal(64).astype(np.float32)
        sc = ShardedCorpus(rows)
        vals, idx = sc.knn_l2(q, 5)
        vb = it.VerticalBatch.from_rows(rows)
        want = it.batch_knn(q, vb, 5)
        np.testing.assert_array_equal(np.asarray(idx), want.indices)
        np.testing.assert_allclose(np.asarray(vals), want.scores, rtol=1e-4, atol=1e-4)

    def test_padding_rows_never_win(self, rng, devices_ok):
        # 1001 rows over 8 devices forces padding; padded rows must not
        # appear even when k is large.
        rows = rng.standard_normal((1001, 16)).astype(np.float32)
        q = rng.standard_normal(16).astype(np.float32)
        sc = ShardedCorpus(rows)
        vals, idx = sc.knn_dot(q, 50)
        assert np.all(np.asarray(idx) < 1001)

    def test_self_query_wins(self, rng, devices_ok):
        rows = rng.standard_normal((512, 32)).astype(np.float32)
        sc = ShardedCorpus(rows)
        _, idx = sc.knn_l2(rows[99], 1)
        assert int(np.asarray(idx)[0]) == 99

    def test_shape_contracts(self, rng, devices_ok):
        sc = ShardedCorpus(rng.standard_normal((64, 8)).astype(np.float32))
        assert sc.num_vectors == 64 and sc.dimension == 8
        with pytest.raises(it.ContractError):
            sc.knn_dot(np.zeros(9, np.float32), 3)

    def test_k_clamped(self, rng, devices_ok):
        rows = rng.standard_normal((32, 8)).astype(np.float32)
        sc = ShardedCorpus(rows)
        vals, idx = sc.knn_dot(rows[0], 4)
        assert np.asarray(idx).shape == (4,)


class TestShardedMultiQuery:
    def test_multi_query_matches_single(self, rng, devices_ok):
        rows = rng.standard_normal((512, 32)).astype(np.float32)
        sc = ShardedCorpus(rows)
        qs = rng.standard_normal((4, 32)).astype(np.float32)
        vals, idx = sc.knn_dot(qs, 5)
        assert np.asarray(idx).shape == (4, 5)
        for j in range(4):
            v1, i1 = sc.knn_dot(qs[j], 5)
            np.testing.assert_array_equal(np.asarray(idx)[j], np.asarray(i1))

    def test_multi_query_l2(self, rng, devices_ok):
        rows = rng.standard_normal((256, 16)).astype(np.float32)
        sc = ShardedCorpus(rows)
        vals, idx = sc.knn_l2(rows[[3, 9]], 2)
        assert int(np.asarray(idx)[0, 0]) == 3
        assert int(np.asarray(idx)[1, 0]) == 9


class TestShardedFamilyRound2:
    """Round-2 coverage: the full op family distributed (VERDICT r1 item 4),
    fused local scans, and multi-query forms."""

    def test_cosine_matches_single_chip(self, rng, devices_ok):
        rows = rng.standard_normal((500, 48)).astype(np.float32)
        rows[11] = 0.0  # zero-norm row scores 0.0
        qs = rng.standard_normal((5, 48)).astype(np.float32)
        sc = ShardedCorpus(rows)
        vals, idx = sc.knn_cosine(qs, 6)
        vb = it.VerticalBatch.from_rows(rows)
        want = it.batch_knn_cosine(qs, vb, 6)
        np.testing.assert_array_equal(np.asarray(idx), want.indices)
        np.testing.assert_allclose(np.asarray(vals), want.scores, rtol=1e-4, atol=1e-5)

    def test_fused_local_scan_matches_jnp_path(self, rng, devices_ok, monkeypatch, force_triton):
        # Force the fused per-shard kernel (interpret mode on CPU) and
        # check bit-identical indices vs the jnp shard path.
        from innr_tpu import config

        rows = rng.standard_normal((800, 32)).astype(np.float32)
        qs = rng.standard_normal((3, 32)).astype(np.float32)
        sc = ShardedCorpus(rows)
        vals_j, idx_j = sc.knn_dot(qs, 5)
        force_triton()
        vals_f, idx_f = sc.knn_dot(qs, 5)
        np.testing.assert_array_equal(np.asarray(idx_f), np.asarray(idx_j))
        np.testing.assert_allclose(np.asarray(vals_f), np.asarray(vals_j), rtol=1e-5)
        # L2 and cosine through the fused shard path as well.
        vl, il = sc.knn_l2(qs[0], 4)
        vb = it.VerticalBatch.from_rows(rows)
        want = it.batch_knn(qs[0], vb, 4)
        np.testing.assert_array_equal(np.asarray(il), want.indices)
        np.testing.assert_allclose(np.asarray(vl), want.scores, rtol=1e-4, atol=1e-4)
        vc, ic = sc.knn_cosine(qs[0], 4)
        wantc = it.batch_knn_cosine(qs[0], vb, 4)
        np.testing.assert_array_equal(np.asarray(ic), wantc.indices)
        np.testing.assert_allclose(np.asarray(vc), wantc.scores, rtol=1e-4, atol=1e-5)

    def test_sharded_ternary_matches_single_chip(self, rng, devices_ok):
        from innr_tpu.ops import ternary as t
        from innr_tpu.parallel import ShardedPackedTernary

        rows = rng.standard_normal((300, 96)).astype(np.float32)
        st = ShardedPackedTernary.encode(rows, 0.3)
        corpus = t.PackedTernaryBatch.encode(rows, 0.3)
        q = t.encode_ternary(rows[17], 0.3)
        vals, idx = st.knn(q, 5)
        want_v, want_i = t.ternary_knn(q, corpus, 5)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_i))
        np.testing.assert_array_equal(np.asarray(vals), np.asarray(want_v))
        # multi-query
        planes = t.encode_ternary_batch(rows[:4], 0.3)
        mv, mi = st.knn_batch(planes, 5)
        wv, wi = t.ternary_knn_batch(planes, corpus, 5)
        np.testing.assert_array_equal(np.asarray(mi), np.asarray(wi))

    def test_sharded_binary_batch_matches_single_chip(self, rng, devices_ok):
        from innr_tpu.ops import binary as b
        from innr_tpu.parallel import ShardedPackedBinary

        rows = rng.standard_normal((300, 64)).astype(np.float32)
        sb = ShardedPackedBinary.encode(rows, 0.0)
        corpus = b.PackedBinaryBatch.encode(rows, 0.0)
        q_words = b.encode_binary_batch(rows[:4], 0.0)
        mv, mi = sb.knn_batch(q_words, 6)
        wv, wi = b.binary_knn_batch(q_words, corpus, 6)
        np.testing.assert_array_equal(np.asarray(mi), np.asarray(wi))
        np.testing.assert_array_equal(np.asarray(mv), np.asarray(wv))

    def test_sharded_u8_matches_single_chip(self, rng, devices_ok):
        from innr_tpu.ops import scalar as sc_ops
        from innr_tpu.parallel import ShardedQuantizedU8

        rows = rng.standard_normal((400, 32)).astype(np.float32)
        params = sc_ops.QuantizationParams.fit(rows)
        squant = ShardedQuantizedU8.quantize(rows, params)
        corpus = sc_ops.QuantizedU8Batch.quantize(rows, params)
        qs = rng.standard_normal((3, 32)).astype(np.float32)
        vals, idx = squant.knn(qs, 6)
        want_v, want_i = sc_ops.batch_knn_u8_multi(qs, corpus, params, 6)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_i))
        np.testing.assert_allclose(
            np.asarray(vals), np.asarray(want_v), rtol=1e-5, atol=1e-5
        )

    def test_sharded_maxsim_matches_single_chip(self, rng, devices_ok):
        from innr_tpu.ops.maxsim import maxsim_knn
        from innr_tpu.parallel import ShardedMaxSimCorpus

        docs = rng.standard_normal((120, 12, 16)).astype(np.float32)
        mask = rng.random((120, 12)) > 0.2
        mask[:, 0] = True
        q = rng.standard_normal((5, 16)).astype(np.float32)
        sm = ShardedMaxSimCorpus(docs, mask)
        vals, idx = sm.knn(q, 7)
        want_v, want_i = maxsim_knn(q, docs, 7, doc_mask=mask)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_i))
        np.testing.assert_allclose(np.asarray(vals), want_v, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("kind", ["binary", "ternary", "u8", "matryoshka"])
    def test_sharded_two_stage_recalls_planted(self, rng, devices_ok, kind):
        from innr_tpu.parallel import ShardedTwoStageIndex

        rows = rng.standard_normal((400, 64)).astype(np.float32)
        idx = ShardedTwoStageIndex(rows, kind, rerank_factor=4)
        qs = rows[:5] + 0.01 * rng.standard_normal((5, 64)).astype(np.float32)
        vals, got = idx.search_batch(qs, 3)
        assert np.asarray(got).shape == (5, 3)
        for i in range(5):
            assert int(np.asarray(got)[i, 0]) == i  # planted neighbor found
        # single-query form agrees with the batch
        v1, i1 = idx.search(qs[0], 3)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(got)[0])

    def test_sharded_two_stage_scores_exact(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedTwoStageIndex

        rows = rng.standard_normal((200, 32)).astype(np.float32)
        idx = ShardedTwoStageIndex(rows, "binary", rerank_factor=4)
        q = rng.standard_normal(32).astype(np.float32)
        vals, got = idx.search(q, 4)
        exact = rows[np.asarray(got)].astype(np.float64) @ q.astype(np.float64)
        np.testing.assert_allclose(np.asarray(vals), exact, rtol=1e-5)

    def test_from_row_source_memmap(self, rng, devices_ok, tmp_path):
        # Stream a corpus from disk per-shard (np.memmap source): results
        # identical to the materialized constructor.
        rows = rng.standard_normal((333, 24)).astype(np.float32)
        path = tmp_path / "corpus.f32"
        rows.tofile(path)
        mm = np.memmap(path, dtype=np.float32, mode="r", shape=(333, 24))
        fetches = []

        def get_rows(start, stop):
            fetches.append((start, stop))
            return mm[start:stop]

        sc = ShardedCorpus.from_row_source(get_rows, 333, 24)
        assert len(fetches) >= 2, "shards must fetch independently"
        q = rng.standard_normal(24).astype(np.float32)
        vals, idx = sc.knn_dot(q, 5)
        want_v, want_i = ShardedCorpus(rows).knn_dot(q, 5)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_i))
        np.testing.assert_array_equal(np.asarray(vals), np.asarray(want_v))

    def test_sharded_maxsim_batch_queries(self, rng, devices_ok):
        from innr_tpu.ops.maxsim import maxsim_knn_batch
        from innr_tpu.parallel import ShardedMaxSimCorpus

        docs = rng.standard_normal((96, 6, 16)).astype(np.float32)
        qs = rng.standard_normal((4, 5, 16)).astype(np.float32)
        sm = ShardedMaxSimCorpus(docs)
        vals, idx = sm.knn(qs, 3)
        want_v, want_i = maxsim_knn_batch(qs, docs, 3)
        np.testing.assert_array_equal(np.asarray(idx), want_i)
        np.testing.assert_allclose(np.asarray(vals), want_v, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("kind", ["binary", "ternary", "u8", "matryoshka"])
    def test_sharded_two_stage_fused_coarse(self, rng, devices_ok, monkeypatch, kind, force_triton):
        from innr_tpu import config
        from innr_tpu.parallel import ShardedTwoStageIndex

        rows = rng.standard_normal((400, 64)).astype(np.float32)
        qs = rows[:3] + 0.01 * rng.standard_normal((3, 64)).astype(np.float32)
        idx = ShardedTwoStageIndex(rows, kind, rerank_factor=4)
        want_v, want_i = idx.search_batch(qs, 3)
        force_triton()
        idx_f = ShardedTwoStageIndex(rows, kind, rerank_factor=4)
        got_v, got_i = idx_f.search_batch(qs, 3)
        # Both paths rerank exactly; the coarse shortlists may order ties
        # differently, but the planted neighbor must win either way.
        np.testing.assert_array_equal(np.asarray(got_i)[:, 0], [0, 1, 2])
        np.testing.assert_allclose(
            np.asarray(got_v)[:, 0], np.asarray(want_v)[:, 0], rtol=1e-5
        )


class TestShardedEdgeCases:
    """k=0 / empty / k>N / mismatch edges across the sharded family."""

    def test_edges_f32(self, rng, devices_ok):
        rows = rng.standard_normal((10, 8)).astype(np.float32)
        sc = ShardedCorpus(rows)
        for fn in (sc.knn_dot, sc.knn_l2, sc.knn_cosine):
            vals, idx = fn(rows[0], 0)
            assert np.asarray(vals).shape == (0,)
            vals, idx = fn(rows[:2], 0)
            assert np.asarray(vals).shape == (2, 0)
            vals, idx = fn(rows[0], 99)  # k > N clamps
            assert np.asarray(vals).shape == (10,)
        with pytest.raises(it.ContractError):
            sc.knn_dot(np.zeros(5, np.float32), 3)

    def test_edges_packed_and_u8(self, rng, devices_ok):
        from innr_tpu.parallel import (
            ShardedPackedBinary, ShardedPackedTernary, ShardedQuantizedU8,
        )

        rows = rng.standard_normal((6, 64)).astype(np.float32)
        sb = ShardedPackedBinary.encode(rows, 0.0)
        c, i = sb.knn(it.encode_binary(rows[0], 0.0), 0)
        assert np.asarray(c).shape == (0,)
        tern = ShardedPackedTernary.encode(rows, 0.2)
        d, i = tern.knn(it.encode_ternary(rows[0], 0.2), 99)
        assert np.asarray(d).shape == (6,)
        uq = ShardedQuantizedU8.quantize(rows)
        v, i = uq.knn(rows[:3], 0)
        assert np.asarray(v).shape == (3, 0)
        with pytest.raises(it.ContractError):
            uq.knn(np.zeros(5, np.float32), 2)

    def test_edges_maxsim_twostage(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedMaxSimCorpus, ShardedTwoStageIndex

        docs = rng.standard_normal((9, 3, 8)).astype(np.float32)
        sm = ShardedMaxSimCorpus(docs)
        v, i = sm.knn(docs[0], 0)
        assert np.asarray(v).shape == (0,)
        v, i = sm.knn(docs[:2], 0)
        assert np.asarray(v).shape == (2, 0)
        rows = rng.standard_normal((12, 16)).astype(np.float32)
        ts = ShardedTwoStageIndex(rows, "binary")
        v, i = ts.search_batch(rows[:2], 0)
        assert np.asarray(v).shape == (2, 0)
        v, i = ts.search(rows[0], 99)
        assert np.asarray(v).shape == (12,)

    def test_bf16_sharded_corpus(self, rng, devices_ok):
        import jax.numpy as jnp

        rows = rng.standard_normal((400, 32)).astype(np.float32)
        sc16 = ShardedCorpus(rows, dtype=jnp.bfloat16)
        sc32 = ShardedCorpus(rows)
        for fn16, fn32 in ((sc16.knn_dot, sc32.knn_dot), (sc16.knn_l2, sc32.knn_l2)):
            v16, i16 = fn16(rows[5], 5)
            v32, i32 = fn32(rows[5], 5)
            assert int(np.asarray(i16)[0]) == 5
            np.testing.assert_allclose(
                np.asarray(v16), np.asarray(v32), rtol=3e-2, atol=3e-2
            )


class TestShardedSlot:
    """ShardedSlotCorpus vs single-chip slot scan: exact integer parity."""

    def test_sharded_slot_matches_single_chip(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedSlotCorpus

        sketches = rng.integers(0, 16, (1000, 32)).astype(np.uint32)
        q = sketches[123]
        sc = ShardedSlotCorpus(sketches)
        counts, idx = sc.knn(q, 7)
        want_counts, want_idx = it.slot_knn_u32(q, sketches, 7)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_idx))
        np.testing.assert_array_equal(np.asarray(counts), np.asarray(want_counts))
        assert int(np.asarray(idx)[0]) == 123

    def test_sharded_slot_batch_and_minhash(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedSlotCorpus

        sketches = rng.integers(0, 8, (500, 64)).astype(np.uint32)
        sc = ShardedSlotCorpus(sketches)
        qs = sketches[[5, 250, 499]]
        counts, idx = sc.knn_batch(qs, 4)
        assert np.asarray(counts).shape == (3, 4)
        np.testing.assert_array_equal(np.asarray(idx)[:, 0], [5, 250, 499])
        for qi, q in enumerate(qs):
            wc, wi = it.slot_knn_u32(q, sketches, 4)
            np.testing.assert_array_equal(np.asarray(idx)[qi], np.asarray(wi))
            np.testing.assert_array_equal(np.asarray(counts)[qi], np.asarray(wc))
        sims, midx = sc.minhash_knn(qs[0], 3)
        assert float(np.asarray(sims)[0]) == 1.0
        assert int(np.asarray(midx)[0]) == 5

    def test_sharded_slot_fused_local_scan(self, rng, devices_ok):
        """The per-shard compare-reduce must match the single-device scan
        exactly, for several queries (integer keys merge exactly)."""
        from innr_tpu.parallel import ShardedSlotCorpus

        sketches = rng.integers(0, 4, (800, 32)).astype(np.uint32)
        sc = ShardedSlotCorpus(sketches)
        for qi in (0, 77, 799):
            counts, idx = sc.knn(sketches[qi], 5)
            want_counts, want_idx = it.slot_knn_u32(sketches[qi], sketches, 5)
            np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_idx))
            np.testing.assert_array_equal(np.asarray(counts),
                                          np.asarray(want_counts))

    def test_sharded_slot_edges(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedSlotCorpus

        sketches = rng.integers(0, 4, (10, 16)).astype(np.uint32)
        sc = ShardedSlotCorpus(sketches)
        counts, idx = sc.knn(sketches[0], 0)
        assert len(np.asarray(idx)) == 0
        counts, idx = sc.knn(sketches[0], 100)  # k clamps to N
        assert len(np.asarray(idx)) == 10
        counts, idx = sc.knn_batch(sketches[:2], 0)
        assert np.asarray(counts).shape == (2, 0)
        with pytest.raises(it.ContractError):
            sc.knn(rng.integers(0, 4, 17).astype(np.uint32), 3)
        with pytest.raises(it.ContractError):
            sc.knn_batch(sketches[0], 3)
        assert sc.num_sketches == 10 and sc.num_slots == 16
        assert sc.memory_bytes() >= 10 * 16 * 4


class TestShardedFiltered:
    """Distributed predicate-pushdown kNN vs the single-chip filtered scan."""

    def test_matches_single_chip(self, rng, devices_ok):
        from innr_tpu.parallel import sharded_knn_filtered

        rows = rng.standard_normal((900, 48)).astype(np.float32)
        mask = rng.random(900) < 0.3
        q = rng.standard_normal(48).astype(np.float32)
        sc = ShardedCorpus(rows)
        vals, idx = sc.knn_filtered(q, 7, mask)
        vb = it.VerticalBatch.from_rows(rows)
        want = it.batch_knn_filtered(q, vb, 7, mask)
        np.testing.assert_array_equal(np.asarray(idx), want.indices)
        np.testing.assert_allclose(np.asarray(vals), want.scores, rtol=1e-5, atol=1e-5)
        assert all(mask[i] for i in np.asarray(idx))

    def test_multi_query_and_callable(self, rng, devices_ok):
        rows = rng.standard_normal((600, 32)).astype(np.float32)
        qs = rng.standard_normal((3, 32)).astype(np.float32)
        sc = ShardedCorpus(rows)
        vals, idx = sc.knn_filtered(qs, 5, lambda i: i % 3 == 0)
        assert np.asarray(idx).shape == (3, 5)
        assert np.all(np.asarray(idx) % 3 == 0)
        vb = it.VerticalBatch.from_rows(rows)
        mask = np.arange(600) % 3 == 0
        for qi in range(3):
            want = it.batch_knn_filtered(qs[qi], vb, 5, mask)
            np.testing.assert_array_equal(np.asarray(idx)[qi], want.indices)

    def test_fused_local_scan(self, rng, devices_ok, monkeypatch, force_triton):
        from innr_tpu import config
        from innr_tpu.kernels import triton_knn as kknn

        force_triton()
        rows = rng.standard_normal((640, 16)).astype(np.float32)
        mask = rng.random(640) < 0.5
        q = rng.standard_normal(16).astype(np.float32)
        sc = ShardedCorpus(rows)
        calls = []
        real = kknn.knn_keys

        def spy(*a, **kw):
            calls.append(a[4] if len(a) > 4 else kw.get("mode"))
            return real(*a, **kw)

        monkeypatch.setattr(kknn, "knn_keys", spy)
        vals, idx = sc.knn_filtered(q, 5, mask)
        assert "l2m" in calls
        vb = it.VerticalBatch.from_rows(rows)
        want = it.batch_knn_filtered(q, vb, 5, mask)
        np.testing.assert_array_equal(np.asarray(idx), want.indices)
        np.testing.assert_allclose(np.asarray(vals), want.scores, rtol=1e-5, atol=1e-5)

    def test_edges(self, rng, devices_ok):
        rows = rng.standard_normal((100, 16)).astype(np.float32)
        sc = ShardedCorpus(rows)
        q = rows[4]
        # nothing passes -> empty
        vals, idx = sc.knn_filtered(q, 5, np.zeros(100, bool))
        assert len(np.asarray(idx)) == 0
        # fewer passing than k -> clamped to passing count, all passing
        mask = np.zeros(100, bool)
        mask[[4, 40, 77]] = True
        vals, idx = sc.knn_filtered(q, 10, mask)
        assert sorted(np.asarray(idx).tolist()) == [4, 40, 77]
        assert int(np.asarray(idx)[0]) == 4
        assert float(np.asarray(vals)[0]) == 0.0
        with pytest.raises(it.ContractError):
            sc.knn_filtered(q, 5, np.zeros(99, bool))


class TestQueryParallel:
    """Query-sharded data-parallel serving: replicated corpus, queries
    split across the mesh — results must equal the single-chip scan."""

    @pytest.mark.parametrize("mode", ["dot", "l2", "cosine"])
    def test_matches_single_chip(self, rng, devices_ok, mode):
        from innr_tpu.parallel import QueryParallelIndex

        rows = rng.standard_normal((300, 32)).astype(np.float32)
        qs = rng.standard_normal((19, 32)).astype(np.float32)  # ragged vs 8 devices
        qp = QueryParallelIndex(rows)
        vb = it.VerticalBatch.from_rows(rows)
        if mode == "dot":
            vals, idx = qp.knn_dot(qs, 5)
            want = it.batch_knn_dot(qs, vb, 5)
        elif mode == "l2":
            vals, idx = qp.knn_l2(qs, 5)
            want = it.batch_knn(qs, vb, 5)
        else:
            vals, idx = qp.knn_cosine(qs, 5)
            want = it.batch_knn_cosine(qs, vb, 5)
        np.testing.assert_array_equal(np.asarray(idx), want.indices)
        np.testing.assert_allclose(np.asarray(vals), want.scores, rtol=1e-5, atol=1e-6)

    def test_fused_local_scan(self, rng, devices_ok, monkeypatch, force_triton):
        from innr_tpu import config
        from innr_tpu.kernels import triton_knn as kknn
        from innr_tpu.parallel import QueryParallelIndex

        force_triton()
        rows = rng.standard_normal((256, 16)).astype(np.float32)
        qs = rng.standard_normal((16, 16)).astype(np.float32)
        calls = []
        real = kknn.knn_keys

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(kknn, "knn_keys", spy)
        qp = QueryParallelIndex(rows)
        vals, idx = qp.knn_dot(qs, 3)
        assert calls, "fused arm not exercised"
        want = it.batch_knn_dot(qs, it.VerticalBatch.from_rows(rows), 3)
        np.testing.assert_array_equal(np.asarray(idx), want.indices)

    def test_edges_and_bf16(self, rng, devices_ok):
        import jax.numpy as jnp
        from innr_tpu.parallel import QueryParallelIndex

        rows = rng.standard_normal((50, 16)).astype(np.float32)
        qp = QueryParallelIndex(rows)
        vals, idx = qp.knn_dot(rows[:3], 0)
        assert np.asarray(vals).shape == (3, 0)
        vals, idx = qp.knn_dot(rows[:2], 500)  # k clamps to N
        assert np.asarray(idx).shape == (2, 50)
        with pytest.raises(it.ContractError):
            qp.knn_dot(rows[0], 3)  # 1-D rejected
        with pytest.raises(it.ContractError):
            QueryParallelIndex(rows, dtype=jnp.int32)
        qp16 = QueryParallelIndex(rows, dtype=jnp.bfloat16)
        v16, i16 = qp16.knn_dot(rows[:4], 3)
        np.testing.assert_array_equal(np.asarray(i16)[:, 0], [0, 1, 2, 3])
        assert qp16.memory_bytes() < qp.memory_bytes()


class TestShardedSparse:
    """Distributed sparse retrieval vs the single-chip SparseCorpus scan."""

    def _docs(self, rng, n, vocab=2000, max_nnz=16):
        docs = []
        for _ in range(n):
            nnz = int(rng.integers(1, max_nnz))
            idx = np.sort(rng.choice(vocab, nnz, replace=False)).astype(np.uint32)
            docs.append((idx, rng.standard_normal(nnz).astype(np.float32)))
        return docs

    def test_matches_single_chip(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedSparseCorpus

        docs = self._docs(rng, 333)
        sc = ShardedSparseCorpus(docs)
        single = it.SparseCorpus(docs)
        q = docs[42]
        vals, idx = sc.knn(q, 6)
        want_vals, want_idx = it.sparse_knn(q, single, 6)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_idx))
        np.testing.assert_allclose(
            np.asarray(vals), np.asarray(want_vals), rtol=1e-6
        )

    def test_batch_and_edges(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedSparseCorpus

        docs = self._docs(rng, 100)
        sc = ShardedSparseCorpus(docs)
        single = it.SparseCorpus(docs)
        qs = [docs[0], docs[50], docs[99]]
        vals, idx = sc.knn_batch(qs, 5)
        assert np.asarray(vals).shape == (3, 5)
        for qi, q in enumerate(qs):
            wv, wi = it.sparse_knn(q, single, 5)
            np.testing.assert_array_equal(np.asarray(idx)[qi], np.asarray(wi))
        v0, i0 = sc.knn(docs[0], 0)
        assert len(np.asarray(i0)) == 0
        v, i = sc.knn(docs[0], 1000)  # clamps to N
        assert len(np.asarray(i)) == 100
        with pytest.raises(it.ContractError):
            sc.knn(qs, 3)  # batch into single-query API
        assert sc.num_docs == 100 and sc.memory_bytes() > 0


class TestGridIndex:
    """2-D mesh (queries x shards) composition vs the single-chip scan."""

    @pytest.mark.parametrize("qg,cs", [(2, 4), (4, 2), (1, 8), (8, 1)])
    def test_dot_matches_single_chip(self, rng, devices_ok, qg, cs):
        from innr_tpu.parallel import GridIndex, grid_mesh

        rows = rng.standard_normal((500, 32)).astype(np.float32)
        qs = rng.standard_normal((13, 32)).astype(np.float32)
        gi = GridIndex(rows, grid_mesh(cs, qg))
        vals, idx = gi.knn_dot(qs, 6)
        want = it.batch_knn_dot(qs, it.VerticalBatch.from_rows(rows), 6)
        np.testing.assert_array_equal(np.asarray(idx), want.indices)
        np.testing.assert_allclose(np.asarray(vals), want.scores, rtol=1e-5)

    @pytest.mark.parametrize("mode", ["l2", "cosine"])
    def test_l2_cosine_match(self, rng, devices_ok, mode):
        from innr_tpu.parallel import GridIndex, grid_mesh

        rows = rng.standard_normal((400, 24)).astype(np.float32)
        qs = rng.standard_normal((7, 24)).astype(np.float32)
        gi = GridIndex(rows, grid_mesh(2, 4))
        vb = it.VerticalBatch.from_rows(rows)
        if mode == "l2":
            vals, idx = gi.knn_l2(qs, 5)
            want = it.batch_knn(qs, vb, 5)
            np.testing.assert_allclose(
                np.asarray(vals), want.scores, rtol=1e-4, atol=1e-4
            )
        else:
            vals, idx = gi.knn_cosine(qs, 5)
            want = it.batch_knn_cosine(qs, vb, 5)
            np.testing.assert_allclose(
                np.asarray(vals), want.scores, rtol=1e-5, atol=1e-6
            )
        np.testing.assert_array_equal(np.asarray(idx), want.indices)

    def test_fused_local_scan_on_grid(self, rng, devices_ok, monkeypatch, force_triton):
        from innr_tpu import config
        from innr_tpu.kernels import triton_knn as kknn
        from innr_tpu.parallel import GridIndex, grid_mesh

        force_triton()
        rows = rng.standard_normal((512, 16)).astype(np.float32)
        qs = rng.standard_normal((8, 16)).astype(np.float32)
        calls = []
        real = kknn.knn_keys

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(kknn, "knn_keys", spy)
        gi = GridIndex(rows, grid_mesh(4, 2))
        vals, idx = gi.knn_dot(qs, 3)
        assert calls, "fused arm not exercised on the grid"
        want = it.batch_knn_dot(qs, it.VerticalBatch.from_rows(rows), 3)
        np.testing.assert_array_equal(np.asarray(idx), want.indices)

    def test_contracts_and_edges(self, rng, devices_ok):
        import jax
        from jax.sharding import Mesh
        from innr_tpu.parallel import GridIndex, grid_mesh

        rows = rng.standard_normal((40, 16)).astype(np.float32)
        with pytest.raises(it.ContractError):
            grid_mesh(5, 5)  # 25 > 8 devices
        with pytest.raises(it.ContractError):
            GridIndex(rows, Mesh(np.asarray(jax.devices()), ("x",)))
        gi = GridIndex(rows, grid_mesh(2, 2))
        vals, idx = gi.knn_dot(rows[:3], 0)
        assert np.asarray(vals).shape == (3, 0)
        vals, idx = gi.knn_dot(rows[:2], 999)
        assert np.asarray(idx).shape == (2, 40)
        with pytest.raises(it.ContractError):
            gi.knn_dot(rows[0], 3)


class TestStreamedIngestion:
    """from_*_source streaming constructors: per-shard fetch (no host
    materialization), results identical to the materialized containers."""

    def test_binary_from_word_source(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedPackedBinary

        rows = rng.standard_normal((200, 70)).astype(np.float32)  # 70 % 32 != 0
        full = ShardedPackedBinary.encode(rows, 0.0)
        words = np.asarray(it.encode_binary_batch(rows, 0.0))
        calls = []

        def src(start, stop):
            calls.append((start, stop))
            return words[start:stop] | np.uint32(0)  # copy

        streamed = ShardedPackedBinary.from_word_source(src, 200, 70)
        assert len(calls) >= 1
        q = it.encode_binary(rows[9], 0.0)
        c1, i1 = full.knn(q, 5)
        c2, i2 = streamed.knn(q, 5)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))

    def test_binary_source_padding_bits_masked(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedPackedBinary

        rows = rng.standard_normal((64, 40)).astype(np.float32)
        words = np.asarray(it.encode_binary_batch(rows, 0.0))
        dirty = words | np.uint32(0xFFFFFF00 << 0)  # garbage beyond bit 40?
        # set high padding bits of the last word only
        dirty = words.copy()
        dirty[:, -1] |= np.uint32(0xFFFFFF00)  # bits 40..63 of word 1 are padding
        streamed = ShardedPackedBinary.from_word_source(
            lambda a, b: dirty[a:b], 64, 40
        )
        q = it.encode_binary(rows[3], 0.0)
        counts, idx = streamed.knn(q, 1)
        assert int(np.asarray(idx)[0]) == 3 and int(np.asarray(counts)[0]) == 0

    def test_slot_from_sketch_source(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedSlotCorpus

        sketches = rng.integers(0, 32, (150, 24)).astype(np.uint32)
        full = ShardedSlotCorpus(sketches)
        streamed = ShardedSlotCorpus.from_sketch_source(
            lambda a, b: sketches[a:b], 150, 24
        )
        c1, i1 = full.knn(sketches[42], 4)
        c2, i2 = streamed.knn(sketches[42], 4)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))

    def test_u8_from_code_source_memmap(self, rng, devices_ok, tmp_path):
        from innr_tpu.parallel import ShardedQuantizedU8

        rows = rng.standard_normal((180, 48)).astype(np.float32)
        params = it.QuantizationParams.fit(rows)
        batch = it.QuantizedU8Batch.quantize(rows, params)
        codes = np.asarray(batch.codes)
        path = tmp_path / "codes.bin"
        codes.tofile(path)
        mm = np.memmap(path, dtype=np.uint8, mode="r", shape=codes.shape)
        streamed = ShardedQuantizedU8.from_code_source(
            lambda a, b: mm[a:b], params, 180, 48
        )
        full = ShardedQuantizedU8(codes, params)
        v1, i1 = full.knn(rows[:3], 5)
        v2, i2 = streamed.knn(rows[:3], 5)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-6)

    def test_bad_source_shape_raises(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedSlotCorpus

        with pytest.raises(it.ContractError):
            ShardedSlotCorpus.from_sketch_source(
                lambda a, b: np.zeros((b - a, 99), np.uint32), 64, 24
            ).knn(np.zeros(24, np.uint32), 1)


class TestGridBf16:
    def test_bf16_grid(self, rng, devices_ok):
        import jax.numpy as jnp
        from innr_tpu.parallel import GridIndex, grid_mesh

        rows = rng.standard_normal((300, 32)).astype(np.float32)
        gi16 = GridIndex(rows, grid_mesh(2, 4), dtype=jnp.bfloat16)
        gi32 = GridIndex(rows, grid_mesh(2, 4))
        v16, i16 = gi16.knn_dot(rows[:5], 4)
        v32, i32 = gi32.knn_dot(rows[:5], 4)
        np.testing.assert_array_equal(np.asarray(i16)[:, 0], np.arange(5))
        np.testing.assert_allclose(
            np.asarray(v16), np.asarray(v32), rtol=3e-2, atol=3e-2
        )
        assert gi16.memory_bytes() < gi32.memory_bytes()


class TestReviewRegressions:
    def test_streamed_wholly_padded_shard(self, rng, devices_ok):
        """n_true small enough that a whole shard is padding: the stream
        callback must fetch zero rows there, not a negative count."""
        from innr_tpu.parallel import ShardedSlotCorpus

        sk = rng.integers(0, 8, (9, 16)).astype(np.uint32)  # 9 rows, 8 devices
        sc = ShardedSlotCorpus.from_sketch_source(lambda a, b: sk[a:b], 9, 16)
        counts, idx = sc.knn(sk[8], 3)
        assert int(np.asarray(idx)[0]) == 8
        # one-row corpus: every shard but one is fully padded
        sc1 = ShardedSlotCorpus.from_sketch_source(lambda a, b: sk[a:b], 1, 16)
        counts, idx = sc1.knn(sk[0], 1)
        assert int(np.asarray(idx)[0]) == 0

    def test_sparse_two_doc_tuple_not_padded_pair(self, rng):
        """A tuple of exactly two (indices, values) docs must build a 2-doc
        corpus, not be misread as a pre-padded array pair."""
        d1 = (np.array([1, 5, 9], np.uint32), np.array([1.0, 2.0, 3.0], np.float32))
        d2 = (np.array([2, 5, 7], np.uint32), np.array([4.0, 5.0, 6.0], np.float32))
        from_tuple = it.SparseCorpus((d1, d2))
        from_list = it.SparseCorpus([d1, d2])
        s1, i1 = it.sparse_knn(d1, from_tuple, 2)
        s2, i2 = it.sparse_knn(d1, from_list, 2)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2))
        # and batch queries as a 2-pair tuple
        sb, ib = it.sparse_knn_batch((d1, d2), from_list, 2)
        assert np.asarray(ib).shape == (2, 2)

    def test_slot_knn_rejects_2d_single_query(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedSlotCorpus

        sk = rng.integers(0, 8, (20, 16)).astype(np.uint32)
        with pytest.raises(it.ContractError):
            it.slot_knn_u32(sk[:3], it.SketchCorpus(sk), 2)
        with pytest.raises(it.ContractError):
            ShardedSlotCorpus(sk).knn(sk[:3], 2)


class TestFilteredEverywhere:
    """knn_filtered parity across all three index decompositions."""

    def test_grid_and_query_parallel_filtered(self, rng, devices_ok):
        from innr_tpu.parallel import GridIndex, QueryParallelIndex, grid_mesh

        rows = rng.standard_normal((700, 32)).astype(np.float32)
        mask = rng.random(700) < 0.4
        qs = rng.standard_normal((5, 32)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        want = it.batch_knn_filtered(qs, vb, 6, mask)

        gi = GridIndex(rows, grid_mesh(4, 2))
        gv, gidx = gi.knn_filtered(qs, 6, mask)
        np.testing.assert_array_equal(np.asarray(gidx), want.indices)
        np.testing.assert_allclose(np.asarray(gv), want.scores, rtol=1e-4, atol=1e-4)

        qp = QueryParallelIndex(rows)
        qv, qidx = qp.knn_filtered(qs, 6, mask)
        np.testing.assert_array_equal(np.asarray(qidx), want.indices)
        np.testing.assert_allclose(np.asarray(qv), want.scores, rtol=1e-4, atol=1e-4)

    def test_filtered_edges_grid_qp(self, rng, devices_ok):
        from innr_tpu.parallel import GridIndex, QueryParallelIndex, grid_mesh

        rows = rng.standard_normal((64, 16)).astype(np.float32)
        qs = rows[:2]
        for index in (GridIndex(rows, grid_mesh(2, 4)), QueryParallelIndex(rows)):
            v, i = index.knn_filtered(qs, 5, np.zeros(64, bool))
            assert np.asarray(v).shape == (2, 0)
            m = np.zeros(64, bool)
            m[[1, 30]] = True
            v, i = index.knn_filtered(qs, 10, m)  # clamps to passing count
            assert np.asarray(i).shape == (2, 2)
            assert set(np.asarray(i).ravel().tolist()) <= {1, 30}
            v, i = index.knn_filtered(qs, 3, lambda j: j % 2 == 0)
            assert np.all(np.asarray(i) % 2 == 0)
            with pytest.raises(it.ContractError):
                index.knn_filtered(qs, 3, np.zeros(63, bool))


class TestShardedSparseMaxSim:
    def test_matches_single_chip(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedSparseMaxSimCorpus

        def doc(nt):
            out = []
            for _ in range(nt):
                nnz = int(rng.integers(1, 8))
                idx = np.sort(rng.choice(400, nnz, replace=False)).astype(np.uint32)
                out.append((idx, rng.standard_normal(nnz).astype(np.float32)))
            return out

        docs = [doc(int(rng.integers(1, 5))) for _ in range(40)]
        sc = ShardedSparseMaxSimCorpus(docs)
        q = docs[21]
        vals, idx = sc.knn(q, 6)
        want_vals, want_idx = it.sparse_maxsim_knn(q, docs, 6)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_idx))
        np.testing.assert_allclose(
            np.asarray(vals), np.asarray(want_vals), rtol=1e-5, atol=1e-6
        )
        assert int(np.asarray(idx)[0]) == 21
        # edges
        v, i = sc.knn(q, 0)
        assert len(np.asarray(i)) == 0
        # empty query: every doc scores 0.0 -> k zero-score results,
        # matching the single-chip sparse_maxsim_knn contract
        v, i = sc.knn([], 3)
        wv, wi = it.sparse_maxsim_knn([], docs, 3)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(wi))
        np.testing.assert_array_equal(np.asarray(v), np.asarray(wv))
        assert sc.num_docs == 40 and sc.memory_bytes() > 0


class TestShardedSlotU16:
    def test_u16_sharded_matches_single_chip(self, rng, devices_ok):
        from innr_tpu.parallel import ShardedSlotCorpus

        sk = rng.integers(0, 1 << 16, (600, 24)).astype(np.uint16)
        sc = ShardedSlotCorpus(sk)
        assert sc.memory_bytes() == sc.slots_t.size * 2
        counts, idx = sc.knn(sk[123], 5)
        wc, wi = it.slot_knn_u16(sk[123], sk, 5)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(wi))
        np.testing.assert_array_equal(np.asarray(counts), np.asarray(wc))
        cb, ib = sc.knn_batch(sk[:3], 4)
        np.testing.assert_array_equal(np.asarray(ib)[:, 0], [0, 1, 2])


class TestStreamedU16Sketches:
    def test_u16_stream_roundtrip(self, rng, devices_ok):
        import jax.numpy as jnp
        from innr_tpu.parallel import ShardedSlotCorpus

        sk = rng.integers(0, 1 << 16, (100, 16)).astype(np.uint16)
        sc = ShardedSlotCorpus.from_sketch_source(
            lambda a, b: sk[a:b], 100, 16, dtype=jnp.uint16
        )
        assert sc.slots_t.dtype == jnp.uint16
        counts, idx = sc.knn(sk[42], 3)
        assert int(np.asarray(idx)[0]) == 42


class TestHierarchicalMerge:
    """Two-level (dcn x ici) mesh: the hierarchical merge must be
    bit-identical to the flat single-hop merge (VERDICT r2 item 9)."""

    @pytest.mark.parametrize("mode", ["dot", "l2", "cosine"])
    def test_matches_flat_merge(self, rng, devices_ok, mode):
        from innr_tpu.parallel import HierarchicalCorpus, hierarchical_mesh

        rows = rng.standard_normal((1100, 48)).astype(np.float32)
        hc = HierarchicalCorpus(rows, mesh=hierarchical_mesh(4, 2))
        sc = ShardedCorpus(rows)
        q = rng.standard_normal(48).astype(np.float32)
        hv, hi = getattr(hc, f"knn_{mode}" if mode != "dot" else "knn_dot")(q, 9)
        sv, si = getattr(sc, f"knn_{mode}" if mode != "dot" else "knn_dot")(q, 9)
        np.testing.assert_array_equal(np.asarray(hi), np.asarray(si))
        np.testing.assert_allclose(np.asarray(hv), np.asarray(sv), rtol=1e-6)

    def test_2x4_factorization_and_batch(self, rng, devices_ok):
        from innr_tpu.parallel import HierarchicalCorpus, hierarchical_mesh

        rows = rng.standard_normal((640, 32)).astype(np.float32)
        hc = HierarchicalCorpus(rows, mesh=hierarchical_mesh(2, 4))
        qs = rng.standard_normal((3, 32)).astype(np.float32)
        vals, idx = hc.knn_dot(qs, 5)
        dots = qs.astype(np.float64) @ rows.astype(np.float64).T
        for i in range(3):
            want = np.argsort(
                -dots[i].astype(np.float32), kind="stable"
            )[:5]
            np.testing.assert_array_equal(np.asarray(idx)[i], want)

    def test_ties_resolve_to_lower_index_across_slices(self, rng, devices_ok):
        from innr_tpu.parallel import HierarchicalCorpus, hierarchical_mesh

        # Duplicate the same winning row into every slice's territory:
        # the merge must keep the LOWEST global indices.
        rows = rng.standard_normal((800, 16)).astype(np.float32)
        q = rng.standard_normal(16).astype(np.float32)
        win = (q / np.linalg.norm(q) * 10).astype(np.float32)
        for pos in (5, 205, 405, 605):  # one per slice at (4, 2) x 100 rows
            rows[pos] = win
        hc = HierarchicalCorpus(rows, mesh=hierarchical_mesh(4, 2))
        _, idx = hc.knn_dot(q, 3)
        assert list(np.asarray(idx)) == [5, 205, 405]

    def test_mesh_axis_name_contract(self, rng, devices_ok):
        from innr_tpu.parallel import HierarchicalCorpus
        from innr_tpu.parallel.sharded import default_mesh

        with pytest.raises(it.ContractError):
            HierarchicalCorpus(
                rng.standard_normal((10, 8)).astype(np.float32),
                mesh=default_mesh(),
            )

    def test_nan_rows_cross_slice(self, rng, devices_ok):
        # NaN scores crossing BOTH merge hops: sort greatest (first for
        # descending dot), never poison the rest — same as single chip.
        from innr_tpu.parallel import HierarchicalCorpus, hierarchical_mesh

        rows = rng.standard_normal((800, 16)).astype(np.float32)
        rows[250] = np.nan  # slice 1 territory at (4, 2) x 100 rows
        rows[650] = np.nan  # slice 3
        q = rng.standard_normal(16).astype(np.float32)
        hc = HierarchicalCorpus(rows, mesh=hierarchical_mesh(4, 2))
        vals, idx = hc.knn_dot(q, 5)
        idx = np.asarray(idx)
        assert list(idx[:2]) == [250, 650]
        dots = rows.astype(np.float64) @ q.astype(np.float64)
        finite_best = np.argsort(
            -np.where(np.isnan(dots), -np.inf, dots), kind="stable"
        )[:3]
        np.testing.assert_array_equal(idx[2:], finite_best)
        assert np.all(np.isnan(np.asarray(vals)[:2]))
        assert np.all(np.isfinite(np.asarray(vals)[2:]))

    def test_pod_16dev_4x4_dryrun(self, force_triton):
        # Pod-shaped (4 slices x 4 devices) factorization with planted
        # cross-slice ties + NaN rows and the trace-time DCN payload
        # assertion — runs in the dryrun's own 16-device CPU child
        # (VERDICT r3 item 8).
        import subprocess
        import sys
        from pathlib import Path

        repo = Path(__file__).resolve().parent.parent
        r = subprocess.run(
            [
                sys.executable,
                "-c",
                "import __graft_entry__ as g; g.dryrun_multichip(16); "
                "print('POD OK')",
            ],
            cwd=repo,
            capture_output=True,
            text=True,
            timeout=600,
        )
        assert r.returncode == 0 and "POD OK" in r.stdout, (
            r.stdout[-1000:], r.stderr[-2000:],
        )


class TestShardedPruned:
    """Distributed tile-skip pruning: per-shard summaries + pruned local
    scans must match the unpruned distributed result exactly."""

    def _clustered(self, rng, n=4096, d=32):
        centers = 5.0 * rng.standard_normal((16, d)).astype(np.float32)
        assign = np.sort(rng.integers(0, 16, n))
        return (
            centers[assign]
            + 0.05 * rng.standard_normal((n, d)).astype(np.float32)
        ).astype(np.float32)

    @pytest.fixture
    def small_gate(self, force_triton):
        # Route the small 8-device CPU shards to the Triton kernel (in
        # interpret mode) so the pruned branch actually engages (and
        # verify it does).
        force_triton()

    @pytest.mark.parametrize("mode", ["dot", "l2", "cosine"])
    def test_pruned_matches_flat(self, rng, devices_ok, small_gate,
                                 monkeypatch, mode):
        import innr_tpu.parallel.sharded as sh

        planned = []
        real = sh._sharded_knn_pruned

        def spy(*a, **kw):
            planned.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(sh, "_sharded_knn_pruned", spy)
        rows = self._clustered(rng)
        sc = ShardedCorpus(rows)
        q = rng.standard_normal(32).astype(np.float32)
        fn = {"dot": sc.knn_dot, "l2": sc.knn_l2, "cosine": sc.knn_cosine}[mode]
        pv, pi = fn(q, 6, prune=True)
        assert planned, "pruned distributed path must engage"
        fv, fi = fn(q, 6)
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))
        np.testing.assert_allclose(np.asarray(pv), np.asarray(fv), rtol=1e-6)

    def test_pruned_batch_queries(self, rng, devices_ok, small_gate):
        rows = self._clustered(rng)
        sc = ShardedCorpus(rows)
        qs = rng.standard_normal((3, 32)).astype(np.float32)
        pv, pi = sc.knn_dot(qs, 5, prune=True)
        dots = qs.astype(np.float64) @ rows.astype(np.float64).T
        for i in range(3):
            want = np.argsort(-dots[i].astype(np.float32), kind="stable")[:5]
            np.testing.assert_array_equal(np.asarray(pi)[i], want)

    def test_bf16_plans_with_rounded_query(self, devices_ok, force_triton):
        # bf16 shards: the pruned scan scores bf16(q) . r, so the per-shard
        # planner must bound the ROUNDED query's scores — planning with the
        # f32 query prunes the tile holding the true winner (regression:
        # round 4; single-chip construction in tests/test_prune.py
        # TestBf16PlanRounding).
        import jax.numpy as jnp

        import innr_tpu.parallel.sharded as sh

        d_half = 128
        qa, qb = np.float32(1.0039), np.float32(1.00391)
        q = np.concatenate(
            [np.full(d_half, qa, np.float32), np.full(d_half, qb, np.float32)]
        )[None, :]
        u = np.concatenate(
            [np.ones(d_half, np.float32), np.zeros(d_half, np.float32)]
        )
        v = np.concatenate(
            [np.zeros(d_half, np.float32),
             np.full(d_half, 0.99609375, np.float32)]
        )
        zero = np.zeros(2 * d_half, np.float32)
        # shard 0: one tile of u-rows + one tile of v-rows (the adversarial
        # pair); shard 1: two tiles of zero filler. tile_n = 8.
        rows = np.stack([u] * 8 + [v] * 8 + [zero] * 16)
        mesh = sh.default_mesh(np.asarray(jax.devices())[:2])
        cent = jnp.asarray(np.stack([u, v, zero, zero]))
        rad = jnp.zeros(4, jnp.float32)
        cnt = jnp.full(4, 8, jnp.int32)
        force_triton()
        pv, pi = sh._sharded_knn_pruned(
            jnp.asarray(q), jnp.asarray(rows, jnp.bfloat16), None,
            cent, rad, cnt, 1, 1, "dot", 32, mesh, 8, "triton", 16,
        )
        fv, fi = sh._sharded_knn(
            jnp.asarray(q), jnp.asarray(rows, jnp.bfloat16), None,
            1, 1, "dot", 32, mesh, "triton", 16,
        )
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))
        np.testing.assert_array_equal(np.asarray(pv), np.asarray(fv))
        assert 8 <= int(np.asarray(pi)[0, 0]) < 16  # a v-row wins in bf16

    def test_summary_is_sharded_and_cached(self, rng, devices_ok, force_triton):
        rows = self._clustered(rng)
        sc = ShardedCorpus(rows)
        cent, rad, cnt, tile_n = sc.tile_summary()
        assert cent.shape[0] == int(np.asarray(cnt).shape[0])
        assert int(np.asarray(cnt).sum()) == sc.n_pad
        assert sc.tile_summary() is sc.tile_summary()


class TestShardedPruneTileKnob:
    """ShardedCorpus.set_prune_tile_n mirrors the VerticalBatch knob:
    per-shard summaries rebuild at the requested (lane-rounded, capped)
    tile height and results stay exact."""

    def test_knob_rebuilds_summaries_and_stays_exact(self, rng, devices_ok,
                                                     force_triton):
        force_triton()
        centers = 5.0 * rng.standard_normal((16, 16)).astype(np.float32)
        assign = np.sort(rng.integers(0, 16, 8192))
        rows = (
            centers[assign]
            + 0.05 * rng.standard_normal((8192, 16)).astype(np.float32)
        ).astype(np.float32)
        sc = ShardedCorpus(rows)
        default_tile = sc.tile_summary()[3]
        assert sc.set_prune_tile_n(130) is sc         # chainable
        assert sc.tile_summary()[3] == 256            # rounded to 128 rows
        q = rng.standard_normal(16).astype(np.float32)
        pv, pi = sc.knn_dot(q, 6, prune=True)
        dots = rows.astype(np.float64) @ q.astype(np.float64)
        want = np.argsort(-dots.astype(np.float32), kind="stable")[:6]
        np.testing.assert_array_equal(np.asarray(pi), want)
        sc.set_prune_tile_n(None)                     # reset
        assert sc.tile_summary()[3] == default_tile
        with pytest.raises(it.ContractError):
            sc.set_prune_tile_n(-1)
