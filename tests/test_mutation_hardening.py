"""Killers for mutation-sweep survivors (MUTATION_REPORT.md triage).

Each test targets a specific surviving mutant from the generated AST
sweep (scripts/mutation_sweep.py) — a behavior the suite could not
previously observe. Survivors judged *equivalent* (pure perf knobs with
no observable semantics: maxsim tile floor, pruned-knn aux-rank guard
for an unused rank) are documented in MUTATION_REPORT triage instead.
"""

import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp

import innr_tpu as it

from innr_tpu import scan
from innr_tpu.kernels import triton_knn


def _force_kernel_route(monkeypatch):
    """Route every dense scan the Triton kernel can take to the kernel,
    run in Pallas interpret mode (the CPU stand-in for the card)."""
    import functools

    from innr_tpu import route as route_mod

    real = triton_knn.knn_keys
    if getattr(real, "interpreted", False):
        return

    def route(family, platform, n, k, dtype, n_q, d=None):
        ok = (family == "dense" and 0 < k <= triton_knn.K_MAX
              and d is not None and triton_knn.d_chunk(int(d)) > 0)
        return "triton" if ok else "xla"

    @functools.wraps(real)
    def interpreted(*args, **kwargs):
        return real(*args, **{**kwargs, "interpret": True})

    interpreted.interpreted = True
    monkeypatch.setattr(route_mod, "route", route)
    monkeypatch.setattr(triton_knn, "knn_keys", interpreted)


def _pad16(x):
    """Zero features up to a multiple of 16 (no score or norm changes)."""
    x = jnp.asarray(x)
    pad = -x.shape[-1] % 16
    if pad == 0:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])


class _kknn:
    """The fused dense entry points these killers were written against,
    run on the Triton kernel in interpret mode (the GPU route); k past the
    kernel's cap takes the XLA route, as the router does."""

    @staticmethod
    def _scan(qs, rows, aux, k, mode):
        qs = jnp.asarray(qs, jnp.float32)
        rows = jnp.asarray(rows)
        if k > triton_knn.K_MAX:
            return scan.knn(qs, rows, aux, k, mode, route="xla")
        keys, idx = triton_knn.knn_keys(_pad16(qs), _pad16(rows), aux, k,
                                        mode, interpret=True)
        return scan.decode_keys(keys, mode, qs, rows.shape[0], "triton"), idx

    @staticmethod
    def _norms2(rows):
        r = jnp.asarray(rows).astype(jnp.float32)
        return jnp.sum(r * r, axis=1)

    @classmethod
    def fused_knn_dot_batch(cls, qs, rows, k):
        return cls._scan(qs, rows, None, k, "dot")

    @classmethod
    def fused_knn_dot(cls, q, rows, k):
        v, i = cls._scan(jnp.asarray(q)[None], rows, None, k, "dot")
        return v[0], i[0]

    @classmethod
    def fused_knn_l2_batch(cls, qs, rows, k, norms2=None):
        n2 = cls._norms2(rows) if norms2 is None else norms2
        return cls._scan(qs, rows, n2, k, "l2")

    @classmethod
    def fused_knn_l2(cls, q, rows, k, norms2=None):
        v, i = cls.fused_knn_l2_batch(jnp.asarray(q)[None], rows, k, norms2)
        return v[0], i[0]

    @classmethod
    def fused_knn_l2_masked_batch(cls, qs, rows, mask, k, norms2=None):
        n2 = cls._norms2(rows) if norms2 is None else norms2
        aux = jnp.stack([n2, jnp.asarray(mask, jnp.float32)])
        return cls._scan(qs, rows, aux, k, "l2m")

    @classmethod
    def fused_knn_cosine_batch(cls, qs, rows, k, inv=None):
        inv = scan.inv_norms(jnp.asarray(rows)) if inv is None else inv
        qs = scan.unit_queries(jnp.asarray(qs, jnp.float32))
        return cls._scan(qs, rows, inv, k, "cosine")

    inv_norms = staticmethod(scan.inv_norms)
    _unit_queries = staticmethod(scan.unit_queries)
    _invert_total_key = staticmethod(scan.invert_total_key)


class _kpruned:
    """Tile-skip scans: scan.planned_knn on the Triton route (interpret
    mode); k past the kernel's cap takes the XLA full scan."""

    @staticmethod
    def _run(qs, rows, aux, summary, k, mode):
        from innr_tpu.prune import TileSummary

        qs = jnp.asarray(qs, jnp.float32)
        rows = jnp.asarray(rows)
        if k > triton_knn.K_MAX:
            return scan.knn(qs, rows, aux, k, mode, route="xla")
        s = TileSummary(summary.tile_n, _pad16(summary.centroids),
                        summary.radii, summary.counts, summary.n_rows)
        return scan.planned_knn(_pad16(qs), _pad16(rows), aux, s, k, mode,
                                route="triton", interpret=True)

    @classmethod
    def fused_knn_dot_pruned_batch(cls, qs, rows, summary, k):
        return cls._run(qs, rows, None, summary, k, "dot")

    @classmethod
    def fused_knn_l2_pruned_batch(cls, qs, rows, summary, k, norms2=None):
        n2 = _kknn._norms2(rows) if norms2 is None else norms2
        return cls._run(qs, rows, n2, summary, k, "l2")

    @classmethod
    def fused_knn_cosine_pruned_batch(cls, qs, rows, summary_norm, k,
                                      inv=None):
        inv = scan.inv_norms(jnp.asarray(rows)) if inv is None else inv
        qs = scan.unit_queries(jnp.asarray(qs, jnp.float32))
        return cls._run(qs, rows, inv, summary_norm, k, "cosine")


class _kham:
    """Packed popcount scoring, now the XLA reductions of ops/."""

    @staticmethod
    def batch_hamming_words(q, corpus):
        return it.batch_binary_hamming(q, corpus)

    @staticmethod
    def batch_ternary_dot_words(qp, qn, pos, neg):
        import types

        q = types.SimpleNamespace(pos=jnp.asarray(qp, jnp.uint32),
                                  neg=jnp.asarray(qn, jnp.uint32))
        return it.batch_ternary_dot(q, pos, neg)


class _kmax:
    """MaxSim scoring, now the einsum of ops/maxsim.py."""

    @staticmethod
    def fused_maxsim_scores(q, docs, doc_mask=None):
        return it.batch_maxsim(jnp.asarray(q)[None], docs,
                               doc_mask=doc_mask)[0]

    @staticmethod
    def fused_maxsim_scores_batch(qs, docs, doc_mask=None):
        return it.batch_maxsim(qs, docs, doc_mask=doc_mask)



class TestScalarAffineScoreValues:
    """Kills scalar.py `(alpha/255)*mixed + offset*sum(q)` sign flips:
    the multi-query affine correction is a per-query constant, so index
    checks alone cannot see it — values must match the per-pair oracle."""

    def test_multi_scores_match_pairwise_oracle(self, rng):
        from innr_tpu.ops.scalar import batch_knn_u8_multi

        rows = rng.standard_normal((80, 24)).astype(np.float32) + 1.0
        qs = rng.standard_normal((3, 24)).astype(np.float32)
        params = it.QuantizationParams.fit(rows)
        corpus = it.QuantizedU8Batch.quantize(rows, params)
        vals, idx = batch_knn_u8_multi(qs, corpus, params, 5)
        for i in range(3):
            for j in range(5):
                row = int(np.asarray(idx)[i, j])
                want = float(
                    it.asymmetric_dot_u8(
                        qs[i], it.quantize_u8(rows[row], params), params
                    )
                )
                assert float(np.asarray(vals)[i, j]) == pytest.approx(
                    want, rel=1e-5
                )


class TestMinhashSimilarityValues:
    """Kills slot.py `1 - counts/s` arithmetic mutants: the similarity
    transform is monotone either way, so only VALUE checks see it."""

    def test_minhash_knn_values(self, rng):
        sk = rng.integers(0, 50, (30, 16)).astype(np.uint32)
        sims, idx = it.minhash_knn(sk[3], sk, 4)
        for r, s_val in zip(np.asarray(idx), np.asarray(sims)):
            matches = int(np.sum(sk[3] == sk[int(r)]))
            assert float(s_val) == pytest.approx(matches / 16)

    def test_minhash_knn_batch_values(self, rng):
        sk = rng.integers(0, 50, (30, 16)).astype(np.uint32)
        sims, idx = it.minhash_knn_batch(sk[:2], sk, 3)
        for i in range(2):
            for r, s_val in zip(np.asarray(idx)[i], np.asarray(sims)[i]):
                matches = int(np.sum(sk[i] == sk[int(r)]))
                assert float(s_val) == pytest.approx(matches / 16)


class TestSparseMaxsimPaddedPair:
    """Kills sparse.py tuple-arity mutants: the padded-pair fast path in
    sparse MaxSim was never driven with an actual 2-tuple."""

    def test_padded_pair_doc_tokens(self):
        q = [
            (np.array([1, 3], np.uint32), np.array([1.0, 2.0], np.float32)),
        ]
        d_idx = np.array([[1, 9], [3, 0xFFFFFFFF]], np.uint32)
        d_val = np.array([[4.0, 1.0], [5.0, 0.0]], np.float32)
        got = float(it.sparse_maxsim(q, (d_idx, d_val)))
        # token q0 vs doc tokens: dot(d0) = 1*4 = 4, dot(d1) = 2*5 = 10
        assert got == pytest.approx(10.0)


class TestVarianceEmptyGuard:
    """Kills batch.py empty-guard mutants: 0 vectors must yield zeros,
    never NaN from an empty mean."""

    def test_empty_corpus_variance_zeros(self):
        vb = it.VerticalBatch.from_rows(np.zeros((0, 5), np.float32))
        v = np.asarray(it.batch_dimension_variance(vb))
        assert v.shape == (5,)
        assert not np.any(np.isnan(v))
        np.testing.assert_array_equal(v, np.zeros(5, np.float32))

    def test_single_vector_variance_zeros(self, rng):
        vb = it.VerticalBatch.from_rows(
            rng.standard_normal((1, 4)).astype(np.float32)
        )
        np.testing.assert_array_equal(
            np.asarray(it.batch_dimension_variance(vb)), np.zeros(4)
        )


class TestForceReferenceU8Multi:
    """Kills scalar.py dispatch-gate boolop mutants: force_reference must
    keep the multi-query u8 path off the fused kernel."""

    def test_forced_reference_never_calls_fused(self, rng, monkeypatch):
        from innr_tpu import config
        from innr_tpu.ops.scalar import batch_knn_u8_multi

        _force_kernel_route(monkeypatch)
        calls = []
        monkeypatch.setattr(
            triton_knn, "knn_keys",
            lambda *a, **kw: calls.append(1) or (_ for _ in ()).throw(
                AssertionError("kernel used under force_reference")
            ),
        )
        rows = rng.standard_normal((64, 16)).astype(np.float32)
        qs = rng.standard_normal((2, 16)).astype(np.float32)
        params = it.QuantizationParams.fit(rows)
        corpus = it.QuantizedU8Batch.quantize(rows, params)
        config.force_reference(True)
        try:
            vals, idx = batch_knn_u8_multi(qs, corpus, params, 3)
        finally:
            config.force_reference(False)
        assert not calls
        assert np.asarray(idx).shape == (2, 3)


class TestMaxsimBatchEmptyGuards:
    """Kills maxsim.py empty-guard boolop mutants."""

    def test_empty_docs(self, rng):
        qs = rng.standard_normal((2, 3, 8)).astype(np.float32)
        docs = np.zeros((0, 4, 8), np.float32)
        vals, idx = it.maxsim_knn_batch(qs, docs, 3)
        assert vals.shape == (2, 0) and idx.shape == (2, 0)

    def test_k_zero(self, rng):
        qs = rng.standard_normal((2, 3, 8)).astype(np.float32)
        docs = rng.standard_normal((5, 4, 8)).astype(np.float32)
        vals, idx = it.maxsim_knn_batch(qs, docs, 0)
        assert vals.shape == (2, 0) and idx.shape == (2, 0)


class TestSlotHammingU64HighBits:
    """Kills slot.py u64-dispatch mutants: u64 slots differing only in
    their HIGH 32 bits must count as differing (the generic jnp path
    would silently truncate them without the pair conversion)."""

    def test_high_bit_difference_counts(self):
        a = np.array([1 << 40, 5, 7], np.uint64)
        b = np.array([1 << 41, 5, 7], np.uint64)
        assert int(it.slot_hamming(a, b)) == 1
        c = np.array([(1 << 40) | 3, 5], np.uint64)
        d = np.array([(1 << 41) | 3, 5], np.uint64)
        assert int(it.slot_hamming(c, d)) == 1


class TestClusterOrderGroupsClusters:
    """Kills prune.py k-means distance mutants: perfectly separable
    clusters must come out contiguous in the ordering."""

    def test_separable_clusters_contiguous(self, rng):
        from innr_tpu.prune import cluster_order

        centers = np.eye(4, 8, dtype=np.float32) * 100
        assign = rng.integers(0, 4, 200)
        rows = centers[assign] + 0.01 * rng.standard_normal((200, 8)).astype(
            np.float32
        )
        # over-provision centroids so every true cluster is captured
        perm = cluster_order(rows, n_clusters=8, n_iters=6)
        ordered_assign = assign[perm]
        # True clusters must not interleave: a handful of runs at most
        # (random init may merge/split clusters, but a mutated distance
        # scatters assignments into ~O(n) runs).
        changes = int(np.sum(ordered_assign[1:] != ordered_assign[:-1]))
        assert changes <= 10, changes


class TestSweepRound2Killers:
    """Killers for the second sampled sweep's real survivors."""

    def test_ternary_plane_length_contract_each_side(self):
        # `or` -> `and` in the plane-shape check must not slip through
        pos = np.zeros(2, np.uint32)
        bad = np.zeros(3, np.uint32)
        with pytest.raises(it.ContractError):
            it.PackedTernary(bad, np.zeros(2, np.uint32), 40)
        with pytest.raises(it.ContractError):
            it.PackedTernary(pos, bad, 40)

    def test_quantized_u8_dimension_check_polarity(self):
        codes = np.arange(8, dtype=np.uint8)
        q = it.QuantizedU8(codes, dimension=8)  # matching: must pass
        assert q.dimension == 8
        with pytest.raises(it.ContractError):
            it.QuantizedU8(codes, dimension=9)

    def test_generic_slot_hamming_counts_differing_not_equal(self):
        a = np.array([1, 2, 3, 4], np.uint32)
        b = np.array([1, 9, 3, 8], np.uint32)
        assert int(it.slot_hamming(a, b)) == 2
        c = np.array([5, 6], np.uint16)
        d = np.array([5, 7], np.uint16)
        assert int(it.slot_hamming(c, d)) == 1

    def test_pruned_order_front_loads_survivors(self, rng):
        """argsort(~alive) invert-drop: survivors must occupy the FRONT
        of the plan so the dynamic pipeline's first n_surv steps scan
        exactly the live tiles — verified end-to-end under STRONG pruning
        (queries inside one cluster of a separable corpus)."""
        from innr_tpu import prune
        kknn = _kknn
        kpruned = _kpruned

        centers = np.eye(8, 16, dtype=np.float32) * 50
        assign = np.sort(rng.integers(0, 8, 4096))
        rows = (centers[assign] + 0.01 * rng.standard_normal((4096, 16))).astype(
            np.float32
        )
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        qs = jnp.asarray(
            centers[:1] + 0.01 * rng.standard_normal((2, 16)).astype(np.float32)
        )
        order, n_surv = prune.plan_survivors(
            qs, s.centroids, s.radii, s.counts, 5, "dot"
        )
        assert int(n_surv) <= 12  # pruning engaged (some tiles dead)
        o = np.asarray(order)[: int(n_surv)]
        # every survivor slot must be a tile whose bound can win
        pv, pi = kpruned.fused_knn_dot_pruned_batch(qs, jnp.asarray(rows), s, 5)
        fv, fi = kknn.fused_knn_dot_batch(qs, jnp.asarray(rows), 5)
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))
        # and the winners' tiles must all appear among the survivors
        for t in (np.asarray(fi) // 256).ravel():
            assert int(t) in set(o.tolist())

    def test_slot_knn_batch_k_zero(self, rng):
        sk = rng.integers(0, 50, (20, 8)).astype(np.uint32)
        counts, idx = it.slot_knn_u32_batch(sk[:2], sk, 0)
        assert np.asarray(idx).shape == (2, 0)

    def test_ternary_knn_batch_fallback_values(self, rng):
        """The jnp fallback arm of ternary_knn_batch (small corpora) must
        produce the same dots as the pairwise oracle."""
        rows = rng.standard_normal((30, 40)).astype(np.float32)
        enc = [it.encode_ternary(r, 0.4) for r in rows]
        corpus = it.PackedTernaryBatch.encode(rows, 0.4)
        q_enc = it.encode_ternary(rows[3], 0.4)
        qp = np.asarray(q_enc.pos)[None, :]
        qn = np.asarray(q_enc.neg)[None, :]
        from innr_tpu.ops.ternary import ternary_knn_batch

        dots, idx = ternary_knn_batch((qp, qn), corpus, 4)
        for j in range(4):
            want = int(it.ternary_dot(q_enc, enc[int(np.asarray(idx)[0, j])]))
            assert int(np.asarray(dots)[0, j]) == want

    def test_sparse_join_empty_query(self):
        corpus = it.SparseCorpus(
            [(np.array([1, 2], np.uint32), np.array([1.0, 2.0], np.float32))]
        )
        vals, idx = it.sparse_knn(
            (np.zeros(0, np.uint32), np.zeros(0, np.float32)), corpus, 1
        )
        assert float(np.asarray(vals)[0]) == 0.0


class TestSweepRound3Killers:
    """Killers for the third sampled sweep's real survivors."""

    def test_ternary_set_out_of_range_ignored_each_side(self, rng):
        t = it.encode_ternary(rng.standard_normal(10).astype(np.float32), 0.3)
        same = t.set(10, 1)   # idx == dimension: ignored
        assert np.array_equal(np.asarray(same.pos), np.asarray(t.pos))
        same2 = t.set(-1, 1)  # negative: ignored
        assert np.array_equal(np.asarray(same2.pos), np.asarray(t.pos))
        changed = t.set(3, 1)  # in range: takes effect
        assert changed.get(3) == 1

    def test_u8_multi_fused_arm_scores(self, rng, monkeypatch):
        """The FUSED arm's affine correction values (the jnp-arm test
        cannot see it)."""
        from innr_tpu import config
        from innr_tpu.ops.scalar import batch_knn_u8_multi

        _force_kernel_route(monkeypatch)
        rows = rng.standard_normal((64, 16)).astype(np.float32) + 1.0
        qs = rng.standard_normal((2, 16)).astype(np.float32)
        params = it.QuantizationParams.fit(rows)
        corpus = it.QuantizedU8Batch.quantize(rows, params)
        vals, idx = batch_knn_u8_multi(qs, corpus, params, 4)
        for i in range(2):
            for j in range(4):
                row = int(np.asarray(idx)[i, j])
                want = float(
                    it.asymmetric_dot_u8(
                        qs[i], it.quantize_u8(rows[row], params), params
                    )
                )
                assert float(np.asarray(vals)[i, j]) == pytest.approx(
                    want, rel=1e-4, abs=1e-4
                )


class TestSweepRound4Killers:
    """Killers for the fourth sampled sweep's real survivors."""

    def test_segmented_compaction_boundary(self, rng):
        sc = it.SegmentedCorpus(4, max_segments=3)
        for _ in range(3):
            sc.add(rng.standard_normal((5, 4)).astype(np.float32))
        assert sc.num_segments == 3  # AT the limit: no compaction
        sc.add(rng.standard_normal((5, 4)).astype(np.float32))
        assert sc.num_segments == 1  # one past: compacted

    def test_segmented_force_reference_never_fused(self, rng, monkeypatch):
        from innr_tpu import config

        _force_kernel_route(monkeypatch)
        monkeypatch.setattr(
            triton_knn, "knn_keys",
            lambda *a, **kw: (_ for _ in ()).throw(
                AssertionError("kernel under force_reference")
            ),
        )
        sc = it.SegmentedCorpus(16)
        sc.add(rng.standard_normal((64, 16)).astype(np.float32))
        config.force_reference(True)
        try:
            scores, ids = sc.knn_dot(rng.standard_normal(16).astype(np.float32), 3)
        finally:
            config.force_reference(False)
        assert len(ids) == 3

    def test_binary_empty_words_masking_guard(self):
        # dimension 0 -> zero words: the padding-bit mask must not index
        # into an empty final word
        p = it.PackedBinary(np.zeros(0, np.uint32), 0)
        assert p.dimension == 0

    def test_ternary_interleaved_u64_dim_33(self, rng):
        # word-count arithmetic: ceil(33/32)=2 differs from ceil(33/33)=1,
        # so a +1 mutant of the u64 width constant breaks this roundtrip
        t = it.encode_ternary(rng.standard_normal(33).astype(np.float32), 0.3)
        back = it.PackedTernary.from_interleaved_u64(t.to_interleaved_u64(), 33)
        for i in range(33):
            assert back.get(i) == t.get(i), i

    def test_maxsim_empty_each_side(self, rng):
        doc = [rng.standard_normal(8).astype(np.float32)]
        assert float(it.maxsim([], doc)) == 0.0
        assert float(it.maxsim(doc, [])) == 0.0

    def test_threshold_survivor_bounds_sound_property(self, rng):
        """Any mutant of the lower-bound formula must violate soundness:
        every tile containing a row within the threshold must be alive."""
        from innr_tpu import prune

        for trial in range(5):
            rows = rng.standard_normal((1024, 12)).astype(np.float32) * (
                1.0 + 3.0 * rng.random()
            )
            s = prune.build_tile_summary(jnp.asarray(rows), 128)
            q = rng.standard_normal(12).astype(np.float32)
            l2 = np.sum((rows.astype(np.float64) - q) ** 2, axis=1)
            thr = float(np.quantile(l2, 0.05))
            _, _, alive = prune.plan_threshold_survivors(
                jnp.asarray(q[None, :]), s.centroids, s.radii,
                jnp.float32(thr),
            )
            alive = np.asarray(alive)
            for t in range(s.n_tiles):
                tile_rows = l2[t * 128 : (t + 1) * 128]
                if np.any(tile_rows <= thr - 1e-3):
                    assert alive[t], (trial, t)


class TestSweepRound5Killers:
    """Killers for the fifth sampled sweep's real survivors."""

    def test_segmented_dead_frac_boundary(self, rng):
        sc = it.SegmentedCorpus(4)  # max_dead_frac 0.25
        sc.add(rng.standard_normal((100, 4)).astype(np.float32))
        sc.delete(np.arange(20))  # 20% dead: below the trigger
        assert sc.num_deleted == 20
        sc.delete(np.arange(20, 30))  # 30%: compaction fires
        assert sc.num_deleted == 0 and sc.num_vectors == 70

    def test_maxsim_knn_batch_contracts_each_clause(self, rng):
        docs = rng.standard_normal((4, 3, 8)).astype(np.float32)
        with pytest.raises(it.ContractError):
            it.maxsim_knn_batch(rng.standard_normal((2, 8)).astype(np.float32), docs, 2)
        with pytest.raises(it.ContractError):
            it.maxsim_knn_batch(
                rng.standard_normal((2, 3, 9)).astype(np.float32), docs, 2
            )

    def test_sparse_knn_batch_accepts_2d_padded_queries(self):
        corpus = it.SparseCorpus(
            [(np.array([1, 2], np.uint32), np.array([1.0, 2.0], np.float32)),
             (np.array([3], np.uint32), np.array([5.0], np.float32))]
        )
        q_idx = np.array([[1, 0xFFFFFFFF], [3, 0xFFFFFFFF]], np.uint32)
        q_val = np.array([[2.0, 0.0], [1.0, 0.0]], np.float32)
        vals, idx = it.sparse_knn_batch((q_idx, q_val), corpus, 1)
        assert int(np.asarray(idx)[0, 0]) == 0
        assert int(np.asarray(idx)[1, 0]) == 1

    def test_threshold_bounds_sound_with_offset_clusters(self, rng):
        """Large-mean data makes the centroid-norm term dominate, so any
        arithmetic mutant of the ||q-c|| expansion flips liveness."""
        from innr_tpu import prune

        # two far-apart clusters with large means: tiles 0-1 near +20,
        # tiles 2-3 near -20; query near +20, small threshold -> the far
        # tiles are provably dead, and the centroid-norm term dominates
        # so arithmetic mutants of the expansion flip liveness.
        rows = np.concatenate([
            rng.standard_normal((256, 8)) + 20.0,
            rng.standard_normal((256, 8)) - 20.0,
        ]).astype(np.float32)
        s = prune.build_tile_summary(jnp.asarray(rows), 128)
        q = (rng.standard_normal(8) + 20.0).astype(np.float32)
        l2 = np.sum((rows.astype(np.float64) - q) ** 2, axis=1)
        thr = float(np.quantile(l2, 0.1))
        _, _, alive = prune.plan_threshold_survivors(
            jnp.asarray(q[None, :]), s.centroids, s.radii, jnp.float32(thr)
        )
        alive = np.asarray(alive)
        for t in range(s.n_tiles):
            if np.any(l2[t * 128 : (t + 1) * 128] <= thr - 1e-3):
                assert alive[t], t
        # and at least one tile must be provably dead on this data
        assert not alive.all()

    def test_quake_magic_constant_pinned(self):
        from innr_tpu.ops import fast_math

        assert fast_math._MAGIC == 0x5F375A86  # reference src/fast_math.rs:55

    def test_binary_knn_force_reference(self, rng, monkeypatch):
        from innr_tpu import config

        _force_kernel_route(monkeypatch)
        monkeypatch.setattr(
            triton_knn, "knn_keys",
            lambda *a, **kw: (_ for _ in ()).throw(
                AssertionError("kernel under force_reference")
            ),
        )
        rows = rng.standard_normal((64, 32)).astype(np.float32)
        corpus = it.PackedBinaryBatch.encode(rows, 0.0)
        config.force_reference(True)
        try:
            counts, idx = it.binary_knn(it.encode_binary(rows[2], 0.0), corpus, 3)
        finally:
            config.force_reference(False)
        assert int(np.asarray(idx)[0]) == 2

    def test_dense_f64_native_x64_arm(self, rng):
        import jax

        from innr_tpu.ops import dense_f64

        a = rng.standard_normal(64)
        b = rng.standard_normal(64)
        jax.config.update("jax_enable_x64", True)
        try:
            got = float(dense_f64.l2_distance_squared_f64(a, b, impl="native"))
        finally:
            jax.config.update("jax_enable_x64", False)
        want = float(np.sum((a - b) ** 2))
        assert got == pytest.approx(want, rel=1e-12)

    def test_host_total_keys_order_negatives(self):
        from innr_tpu.ops.topk import _total_keys

        vals = np.array([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0], np.float32)
        keys = _total_keys(vals)
        assert list(np.argsort(keys, kind="stable")) == list(range(6))


class TestSeed0SweepSurvivors:
    """Killers for the seed-0 sweep survivors (sixth triage)."""

    def test_segmented_rejects_3d_queries(self, rng):
        # segmented.py query-shape contract: `ndim != 2 OR dim mismatch`.
        # A 3-D batch whose axis 1 happens to equal the corpus dim must
        # still be rejected (an `and` mutant would let it through).
        d = 8
        sc = it.SegmentedCorpus(d)
        sc.add(rng.standard_normal((20, d)).astype(np.float32))
        bad = rng.standard_normal((2, d, 3)).astype(np.float32)
        with pytest.raises(it.ContractError):
            sc.knn_dot(bad, 3)

    def test_packed_ternary_eq_observes_contents(self):
        # ternary.py __eq__ and-chain: an `or` mutant would short-circuit
        # on isinstance and call everything equal.
        a = it.encode_ternary([1.0, -1.0, 0.0, 1.0], 0.5)
        b = it.encode_ternary([1.0, -1.0, 0.0, -1.0], 0.5)
        c = it.encode_ternary([1.0, -1.0, 0.0], 0.5)
        assert a != b  # same dim, different planes
        assert a != c  # different dim
        assert a != "not-a-ternary"
        assert a == it.encode_ternary([1.0, -1.0, 0.0, 1.0], 0.5)

    def test_encode_ternary_boundary_values_are_zero(self):
        # encode bands are STRICT (> t / < -t, reference src/ternary.rs:170):
        # values exactly at +-threshold must encode to 0.
        t = 0.5
        enc = it.encode_ternary([t, -t, 0.25, -0.25, 0.75, -0.75], t)
        assert [enc.get(i) for i in range(6)] == [0, 0, 0, 0, 1, -1]
        # batch encoder shares the planes contract
        pos, neg = it.encode_ternary_batch(
            np.array([[t, -t, 0.75, -0.75]], dtype=np.float32), t
        )
        got = it.PackedTernaryBatch(pos, neg, 4)
        single = it.encode_ternary([t, -t, 0.75, -0.75], t)
        assert np.asarray(got.pos[0]).tolist() == np.asarray(single.pos).tolist()
        assert np.asarray(got.neg[0]).tolist() == np.asarray(single.neg).tolist()

    def test_ternary_knn_batch_1d_planes_raise_contract_error(self, rng):
        # ternary.py plane-shape contract: 1-D planes must raise
        # ContractError via the ndim clause (an `and` mutant evaluates
        # shape[1] on a 1-D array and dies with IndexError instead).
        rows = rng.standard_normal((10, 64)).astype(np.float32)
        corpus = it.PackedTernaryBatch.encode(rows, 0.3)
        qp = np.asarray(corpus.pos[0])  # (W,) 1-D
        qn = np.asarray(corpus.neg[0])
        with pytest.raises(it.ContractError):
            from innr_tpu.ops.ternary import ternary_knn_batch
            ternary_knn_batch((qp, qn), corpus, 2)

    def test_threshold_plan_keeps_exact_boundary_tile(self):
        # prune.py `lower^2 > threshold`: a tile whose distance lower
        # bound hits the threshold EXACTLY may still hold a passing row
        # (row filter is inclusive) — `>=` would prune it. Exact f32
        # arithmetic: q=0, centroid=5, radius=1 -> lower=4, lower^2=16.
        from innr_tpu import prune

        qs = jnp.zeros((1, 1), dtype=jnp.float32)
        cent = jnp.asarray([[5.0]], dtype=jnp.float32)
        rad = jnp.asarray([1.0], dtype=jnp.float32)
        _, n_surv, alive = prune.plan_threshold_survivors(qs, cent, rad, 16.0)
        assert bool(np.asarray(alive)[0]) and int(n_surv) == 1
        # beyond the threshold by more than the PRUNE_BOUND_EPS rounding
        # slack (1e-4 * (qq + cc + 2|qd|) = 2.5e-3 here) the tile must die
        _, n_surv2, alive2 = prune.plan_threshold_survivors(
            qs, cent, rad, 15.99
        )
        assert not bool(np.asarray(alive2)[0]) and int(n_surv2) == 0

    def test_pruned_scan_masked_tail_steps_add_nothing(self, rng):
        # pruned_knn.py `pl.when(i < n_surv)`: steps at/after n_surv
        # revisit the LAST SURVIVOR's block; an `<=` mutant would scan it
        # twice and duplicate its rows in the running best. Exactness +
        # uniqueness over a plan that actually prunes kills it.
        from innr_tpu import prune
        kknn = _kknn
        kpruned = _kpruned

        d = 16
        rows = rng.standard_normal((512, d)).astype(np.float32)
        rows[:256] += 60.0  # tile 0: far cluster -> pruned for near queries
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        qs = jnp.asarray(rows[256:259] + 0.01)
        order, n_surv = prune.plan_survivors(
            qs, s.centroids, s.radii, s.counts, 5, "l2"
        )
        assert int(n_surv) == 1  # the far tile is dead -> a masked step runs
        pv, pi = kpruned.fused_knn_l2_pruned_batch(qs, jnp.asarray(rows), s, 5)
        fv, fi = kknn.fused_knn_l2_batch(qs, jnp.asarray(rows), 5)
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))
        np.testing.assert_array_equal(np.asarray(pv), np.asarray(fv))
        for row in np.asarray(pi):
            assert len(set(row.tolist())) == len(row)

    def test_maxsim_rejects_non_2d_ndarray_tokens(self):
        # maxsim.py token coercion: ndarray inputs must be (T, D);
        # 1-D / 3-D arrays raise ContractError, not a downstream shape
        # error from inside the jitted score matmul.
        docs = [[1.0, 0.0, 0.0, 0.0]]
        with pytest.raises(it.ContractError):
            it.maxsim(np.ones(4, dtype=np.float32), docs)
        with pytest.raises(it.ContractError):
            it.maxsim(np.ones((2, 2, 4), dtype=np.float32), docs)
        with pytest.raises(it.ContractError):
            it.maxsim(docs, np.ones(4, dtype=np.float32))

    def test_adaptive_empty_and_k_zero_early_return(self, rng):
        # batch.py `num_vectors == 0 OR k == 0` early return: each clause
        # alone must produce the empty result (an `and` mutant falls
        # through into the warmup scan).
        vb_empty = it.VerticalBatch.from_rows(np.zeros((0, 8), np.float32))
        q = rng.standard_normal(8).astype(np.float32)
        r = it.batch_knn_adaptive(q, vb_empty, 3, warmup_dims=4)
        assert r.indices.shape == (0,) and r.scores.shape == (0,)
        vb = it.VerticalBatch.from_rows(
            rng.standard_normal((10, 8)).astype(np.float32)
        )
        r2 = it.batch_knn_adaptive(q, vb, 0, warmup_dims=4)
        assert r2.indices.shape == (0,)

    def test_fused_masked_multiquery_matches_oracle(self, rng):
        # knn.py l2m predicate pushdown, MULTI-query: the mask row of the
        # aux block must gate every query's keys (mask polarity `> 0.0`
        # and the aux-row slice are only observable when masked rows
        # would otherwise win).
        kknn = _kknn

        n, d, k = 300, 12, 6
        rows = rng.standard_normal((n, d)).astype(np.float32)
        qs = rows[:3] + 0.001  # nearest rows are the queries themselves...
        mask = np.ones(n, dtype=bool)
        mask[:3] = False  # ...and they are masked out
        vals, idx = kknn.fused_knn_l2_masked_batch(
            jnp.asarray(qs), jnp.asarray(rows), jnp.asarray(mask), k
        )
        d2 = ((qs[:, None, :] - rows[None, :, :]) ** 2).sum(-1)
        d2[:, ~mask] = np.inf
        want = np.argsort(d2, axis=1, kind="stable")[:, :k]
        np.testing.assert_array_equal(np.asarray(idx), want)
        assert not np.isin(np.asarray(idx), [0, 1, 2]).any()


class TestSeed0TriageB:
    """Killers for the second seed-0 sample (seventh triage)."""

    def test_u8_single_query_fused_affine_values(self, rng, monkeypatch):
        # scalar.py single-query fused arm: the `offset * sum(q)` affine
        # term is a per-query constant — indices can't see a sign/op
        # flip, values vs the per-pair oracle can.
        from innr_tpu import config

        _force_kernel_route(monkeypatch)
        rows = rng.standard_normal((40, 16)).astype(np.float32) + 1.0
        q = rng.standard_normal(16).astype(np.float32)
        params = it.QuantizationParams.fit(rows)
        corpus = it.QuantizedU8Batch.quantize(rows, params)
        res = it.batch_knn_u8(q, corpus, params, 5)
        for row, score in res:
            want = float(
                it.asymmetric_dot_u8(q, it.quantize_u8(rows[row], params), params)
            )
            assert score == pytest.approx(want, rel=1e-5)

    def test_u8_single_query_gate_clauses(self, rng, monkeypatch):
        # scalar.py route: under force_reference the kernel must NOT run
        # even where the route would take it.
        from innr_tpu import config

        _force_kernel_route(monkeypatch)
        rows = rng.standard_normal((32, 16)).astype(np.float32)
        q = rng.standard_normal(16).astype(np.float32)
        params = it.QuantizationParams.fit(rows)
        corpus = it.QuantizedU8Batch.quantize(rows, params)

        def boom(*a, **k):
            raise AssertionError("u8 kernel under force_reference")

        monkeypatch.setattr(triton_knn, "knn_keys", boom)
        config.force_reference(True)
        try:
            res = it.batch_knn_u8(q, corpus, params, 3)
        finally:
            config.force_reference(False)
        assert len(res) == 3
        with pytest.raises(AssertionError, match="u8 kernel"):
            it.batch_knn_u8(q, corpus, params, 3)  # route taken otherwise

    def test_slot_fused_gate_boundary_inclusive(self, rng, monkeypatch):
        # The slot family has no kernel: its route is XLA at every size,
        # on every platform, and the sketches stay in one layout.
        from innr_tpu import route
        from innr_tpu.ops.slot import SketchCorpus

        for n in (15, 16, 10**8):
            assert route.route("slot", "gpu", n, 2, jnp.uint32, 1, 8) == "xla"
        sc = SketchCorpus(rng.integers(0, 2**32, (16, 8), dtype=np.uint32))
        assert sc.memory_bytes() == 16 * 8 * 4

    def test_segmented_fused_gate_boundary_inclusive(self, rng, monkeypatch):
        # segmented.py resolves each segment's route ONCE and hands the
        # same route to the scan and to the key decode.
        from innr_tpu.parallel import _scan

        _force_kernel_route(monkeypatch)
        seen = []
        real = _scan.local_scan_keys

        def spy(qs, rows, aux, n_total, k, mode, base, route=None):
            seen.append(route)
            return real(qs, rows, aux, n_total, k, mode, base, route=route)

        monkeypatch.setattr(_scan, "local_scan_keys", spy)
        d = 16
        sc = it.SegmentedCorpus(d)
        rows = rng.standard_normal((64, d)).astype(np.float32)
        sc.add(rows)
        qs = rng.standard_normal((2, d)).astype(np.float32)
        scores, ids = sc.knn(qs, 3)
        assert seen == ["triton"]
        want = np.argsort(((qs[:, None] - rows[None]) ** 2).sum(-1),
                          axis=1, kind="stable")[:, :3]
        np.testing.assert_array_equal(np.asarray(ids), want)

    def test_slot_knn_batch_k_nonpositive(self, rng, monkeypatch):
        # slot.py `n == 0 or k <= 0`: k == 0 AND k < 0 must both return
        # (Q, 0) without scoring anything.
        from innr_tpu.ops.slot import SketchCorpus, slot_knn_u32_batch

        _force_kernel_route(monkeypatch)

        def boom(*a, **kw):
            raise AssertionError("a kernel invoked with k <= 0")

        monkeypatch.setattr(triton_knn, "knn_keys", boom)
        corpus = SketchCorpus(rng.integers(0, 2**32, (10, 8), dtype=np.uint32))
        qs = rng.integers(0, 2**32, (3, 8), dtype=np.uint32)
        for k in (0, -2):
            counts, idx = slot_knn_u32_batch(qs, corpus, k)
            assert counts.shape == (3, 0) and idx.shape == (3, 0)

    def test_maxsim_batch_accepts_nested_list_docs(self, rng):
        # maxsim_kernel.py dtype coercion `!= bfloat16`: non-array doc
        # input must be coerced to f32 (an `==` mutant leaves a Python
        # list to crash on .shape).
        fused_maxsim_scores_batch = _kmax.fused_maxsim_scores_batch

        q = rng.standard_normal((2, 3, 8)).astype(np.float32)
        docs = rng.standard_normal((4, 5, 8)).astype(np.float32)
        got_list = fused_maxsim_scores_batch(q, docs.tolist())
        got_arr = fused_maxsim_scores_batch(q, docs)
        np.testing.assert_array_equal(np.asarray(got_list), np.asarray(got_arr))

    def test_maxsim_cosine_epsilon_norm_token_is_zero(self):
        # maxsim.py zero-norm guard `n > NORM_EPSILON` is STRICT: a token
        # whose norm is exactly epsilon (1e-9f survives sqrt(x*x)
        # round-trip) must contribute 0, not be normalized by 1e-9.
        x = np.float32(1e-9)
        assert np.float32(np.sqrt(np.float32(x * x))) == np.float32(1e-9)
        q = np.array([[x, 0.0, 0.0, 0.0]], dtype=np.float32)
        d = np.array([[1.0, 0.0, 0.0, 0.0]], dtype=np.float32)
        assert float(it.maxsim_cosine(q, d)) == 0.0

    def test_cosine_epsilon_sq_boundary_is_zero(self):
        # dense.py `aa > NORM_EPSILON_SQ` is STRICT: a vector whose
        # squared norm lands EXACTLY on the epsilon (constructed in f32
        # ulp space) is still "zero-norm" -> cosine 0.0.
        from innr_tpu.config import NORM_EPSILON_SQ

        x = np.float32(7.071061e-10)
        y = np.float32(7.071075e-10)
        aa = np.float32(np.float32(x * x) + np.float32(y * y))
        assert aa == np.float32(NORM_EPSILON_SQ)  # construction holds
        a = np.array([x, y], dtype=np.float32)
        b = np.array([1.0, 0.0], dtype=np.float32)
        assert float(it.cosine(a, b)) == 0.0
        assert float(it.cosine(b, a)) == 0.0

    def test_cluster_order_groups_separated_clusters(self, rng):
        # prune.py k-means distance `rr - 2*q@c + cc`: with wildly
        # separated clusters every centroid must land inside one true
        # cluster, so the permutation's label sequence has at most
        # n_clusters runs, each label-pure. A sign-flipped distance
        # scrambles the assignment.
        from innr_tpu import prune

        # All-positive centers: a sign-flipped distance maps every row to
        # the most-negative centroid (no negated twin exists to hide in),
        # collapsing distinct clusters onto one centroid -> impure runs.
        d, per = 8, 64
        centers = np.array([0.0, 500.0, 1000.0, 1500.0], dtype=np.float32)
        rows = np.concatenate([
            c + rng.standard_normal((per, d)).astype(np.float32)
            for c in centers
        ])
        labels = np.repeat(np.arange(4), per)
        # Shuffle: a degenerate everything-to-one-centroid assignment
        # yields an identity permutation, which on pre-ordered input
        # would trivially look "grouped".
        shuf = rng.permutation(4 * per)
        rows, labels = rows[shuf], labels[shuf]
        perm = np.asarray(prune.cluster_order(rows, n_clusters=32, n_iters=4))
        assert sorted(perm.tolist()) == list(range(4 * per))
        runs = labels[perm]
        change = np.flatnonzero(np.diff(runs)) + 1
        segments = np.split(runs, change)
        assert len(segments) <= 32
        for seg in segments:
            assert len(set(seg.tolist())) == 1

    def test_pruned_large_k_stays_exact(self, rng):
        # k > tile_n over 2 tiles: whatever plan path `_fast_plan_ok`
        # selects (both are sound — the eligible-count mask degrades the
        # fast threshold to "prune nothing" when no tile holds >= k
        # rows), the result must be bit-identical to the full scan.
        from innr_tpu import prune
        kknn = _kknn
        kpruned = _kpruned

        d = 8
        rows = rng.standard_normal((512, d)).astype(np.float32)
        rows[:256] += 100.0  # two far-apart tiles
        s = prune.build_tile_summary(jnp.asarray(rows), 256)
        qs = jnp.asarray(rows[256:259] + 0.01)
        k = 300  # > tile_n: needs rows from BOTH tiles
        pv, pi = kpruned.fused_knn_l2_pruned_batch(qs, jnp.asarray(rows), s, k)
        fv, fi = kknn.fused_knn_l2_batch(qs, jnp.asarray(rows), k)
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))
        np.testing.assert_array_equal(np.asarray(pv), np.asarray(fv))


class TestSeed0TriageC:
    """Killers for the third seed-0 sample (eighth triage)."""

    @staticmethod
    def _clustered(rng, n_tiles=8, tile_n=64, d=8, spread=200.0):
        centers = rng.standard_normal((n_tiles, d)).astype(np.float32) * spread
        rows = np.repeat(centers, tile_n, axis=0)
        rows += rng.standard_normal(rows.shape).astype(np.float32)
        return rows

    @staticmethod
    def _oracle_bounds(qs, cent, rad, mode):
        """The documented per-tile bound math (prune.py module docstring),
        replayed in f64: (guaranteed, optimistic), each (Q, n_tiles)."""
        qs, cent, rad = (np.asarray(a, np.float64) for a in (qs, cent, rad))
        qd = qs @ cent.T
        if mode == "dot":
            qn = np.sqrt(np.sum(qs * qs, axis=1, keepdims=True))
            return qd - qn * rad[None, :], qd + qn * rad[None, :]
        qq = np.sum(qs * qs, axis=1, keepdims=True)
        cc = np.sum(cent * cent, axis=1)[None, :]
        qc = np.sqrt(np.maximum(qq + cc - 2.0 * qd, 0.0))
        guaranteed = (qc + rad[None, :]) ** 2
        optimistic = np.maximum(qc - rad[None, :], 0.0) ** 2
        return guaranteed, optimistic

    @pytest.mark.parametrize("mode", ["dot", "l2"])
    @pytest.mark.parametrize("fast", [True, False])
    # k == tile_n makes the fast path's >= eligibility boundary live:
    # every full tile holds EXACTLY k rows, so a strict `>` mutant finds
    # no eligible tile and degrades to prune-nothing — caught by the
    # oracle's alive-set equality.
    @pytest.mark.parametrize("k", [10, 64])
    def test_plan_survivors_matches_bound_oracle(self, rng, mode, fast, k):
        # prune.py bound math (qq + cc - 2qd, qc +/- rad, dead_q
        # direction, fast-path eligibility): the ALIVE SET must equal the
        # documented formulas replayed independently in numpy f64.
        # Mutants that distort bounds either prune a tile the oracle
        # keeps or keep one it prunes; wide cluster separation makes the
        # comparison margin >> f32 noise.
        from innr_tpu import prune

        tile_n = 64
        rows = self._clustered(rng, tile_n=tile_n)
        s = prune.build_tile_summary(jnp.asarray(rows), tile_n)
        qs = rows[rng.choice(len(rows), 5, replace=False)] + 0.01
        order, n_surv = prune.plan_survivors(
            jnp.asarray(qs), s.centroids, s.radii, s.counts, k, mode,
            fast=fast,
        )
        cent = np.asarray(s.centroids)
        rad = np.asarray(s.radii)
        cnt = np.asarray(s.counts)
        guaranteed, optimistic = self._oracle_bounds(qs, cent, rad, mode)
        if fast:
            # t0 = best guaranteed bound among tiles holding >= k rows.
            elig = cnt >= k
            if mode == "dot":
                t0 = np.max(np.where(elig[None, :], guaranteed, -np.inf),
                            axis=1, keepdims=True)
            else:
                t0 = np.min(np.where(elig[None, :], guaranteed, np.inf),
                            axis=1, keepdims=True)
        else:
            sign = -1.0 if mode == "dot" else 1.0
            order_g = np.argsort(sign * guaranteed, axis=1)
            cum = np.cumsum(np.take_along_axis(
                np.broadcast_to(cnt[None, :], guaranteed.shape), order_g,
                axis=1), axis=1)
            pos = np.minimum(np.sum(cum < k, axis=1), cnt.size - 1)
            t0 = np.take_along_axis(
                np.take_along_axis(guaranteed, order_g, axis=1),
                pos[:, None], axis=1)
        dead_q = optimistic < t0 if mode == "dot" else optimistic > t0
        want_alive = ~np.all(dead_q, axis=0)
        # Construction sanity: clear margins and real pruning pressure.
        margin = np.min(np.abs(optimistic - t0) / np.maximum(np.abs(t0), 1.0))
        assert margin > 1e-3, "degenerate construction: boundary tie"
        assert 0 < want_alive.sum() < cnt.size
        got_alive = np.zeros(cnt.size, bool)
        got_alive[np.asarray(order)[: int(n_surv)]] = True
        np.testing.assert_array_equal(got_alive, want_alive)
        # Survivor prefix is the alive set in ascending tile order.
        np.testing.assert_array_equal(
            np.asarray(order)[: int(n_surv)], np.flatnonzero(want_alive)
        )

    def test_plan_threshold_survivors_matches_bound_oracle(self, rng):
        # Same oracle discipline for the fixed-threshold planner
        # (prune.py:216 qq+cc-2qd and the strict `>` dead test).
        from innr_tpu import prune

        tile_n = 64
        rows = self._clustered(rng, tile_n=tile_n)
        s = prune.build_tile_summary(jnp.asarray(rows), tile_n)
        qs = rows[rng.choice(len(rows), 4, replace=False)] + 0.01
        _, optimistic = self._oracle_bounds(qs, np.asarray(s.centroids),
                                            np.asarray(s.radii), "l2")
        lo = np.min(optimistic, axis=0)  # best-query bound per tile
        vals = np.sort(lo)
        threshold = float((vals[2] + vals[3]) / 2)  # mid-gap: 3 tiles pass
        assert (vals[3] - vals[2]) / max(vals[3], 1.0) > 1e-3
        order, n_surv, alive = prune.plan_threshold_survivors(
            jnp.asarray(qs), s.centroids, s.radii, jnp.float32(threshold)
        )
        want_alive = lo <= threshold
        np.testing.assert_array_equal(np.asarray(alive), want_alive)
        np.testing.assert_array_equal(
            np.asarray(order)[: int(n_surv)], np.flatnonzero(want_alive)
        )

    def test_segmented_overfetch_covers_tombstones(self, rng):
        # segmented.py `need = k + seg.n_dead`: the scan is tombstone-
        # oblivious (dead rows are pinned AFTER the fetch), so an
        # under-fetching mutant loses genuine winners when the deleted
        # rows dominate the segment's top ranks.
        d, n, k = 8, 64, 10
        rows = np.zeros((n, d), np.float32)
        rows[:, 0] = np.arange(n, 0, -1, dtype=np.float32)  # descending
        sc = it.SegmentedCorpus(d, auto_compact=False)
        lo, hi = sc.add(rows)
        sc.delete(range(lo, lo + 40))  # tombstone the top 40 scorers
        q = np.zeros(d, np.float32)
        q[0] = 1.0
        scores, ids = sc.knn_dot(q, k)
        np.testing.assert_array_equal(ids, np.arange(40, 50))
        np.testing.assert_allclose(scores, np.arange(24, 14, -1), rtol=0)

    def test_segmented_autocompact_dead_frac_strict(self, rng):
        # segmented.py auto-compaction `dead/total > max_dead_frac` is
        # STRICT: at exactly the threshold fraction nothing compacts; one
        # more delete crosses it and compaction fires.
        d = 4
        sc = it.SegmentedCorpus(d, max_dead_frac=0.25)
        sc.add(rng.standard_normal((16, d)).astype(np.float32))
        sc.delete(range(4))  # 4/16 == 0.25 exactly
        assert sc.num_deleted == 4  # no compaction at the boundary
        sc.delete([4])  # 5/16 > 0.25
        assert sc.num_deleted == 0  # compaction fired and dropped them
        assert sc.num_vectors == 11

    def test_segmented_autocompact_segment_count_strict(self, rng):
        # ... and `len(segments) > max_segments` is strict too.
        d = 4
        sc = it.SegmentedCorpus(d, max_segments=3)
        for _ in range(3):
            sc.add(rng.standard_normal((4, d)).astype(np.float32))
        assert sc.num_segments == 3
        sc.add(rng.standard_normal((4, d)).astype(np.float32))
        assert sc.num_segments == 1  # 4 > 3 folded everything

    def test_ternary_interleaved_u64_exact_length(self, rng):
        # ternary.py `-(-dimension // 32)`: the serialized word count is
        # ceil(d/32) EXACTLY (reference src/ternary.rs:91 layout parity —
        # 32 two-bit pairs per u64 word).
        for d in (1, 31, 32, 33, 64, 100):
            v = rng.integers(-1, 2, d).astype(np.float32)
            packed = it.encode_ternary(v, 0.5)
            words = packed.to_interleaved_u64()
            assert words.shape == ((d + 31) // 32,)
            rt = it.PackedTernary.from_interleaved_u64(words, d)
            np.testing.assert_array_equal(
                np.asarray(rt.pos), np.asarray(packed.pos)
            )
            np.testing.assert_array_equal(
                np.asarray(rt.neg), np.asarray(packed.neg)
            )

    def test_maxsim_knn_dispatch_boundaries(self, rng, monkeypatch):
        # MaxSim has one route (the einsum) at every corpus size: no
        # size boundary exists, results match the float64 oracle on
        # both sides of the old one, and force_reference changes nothing.
        from innr_tpu import config, route

        qs = rng.standard_normal((3, 8)).astype(np.float32)

        def docs(n):
            return rng.standard_normal((n, 4, 8)).astype(np.float32)

        def oracle(q, d):
            pair = np.einsum("td,nsd->nts", q.astype(np.float64),
                             d.astype(np.float64))
            return pair.max(axis=2).sum(axis=1)

        for n in (63, 64, 127, 128):
            assert route.route("maxsim", "gpu", n, 3, jnp.float32, 1, 8) == "xla"
            d = docs(n)
            got_v, got_i = it.maxsim_knn(qs, d, 3)
            config.force_reference(True)
            try:
                ref_v, ref_i = it.maxsim_knn(qs, d, 3)
            finally:
                config.force_reference(False)
            np.testing.assert_array_equal(got_i, ref_i)
            for b, q in enumerate(qs if qs.ndim == 3 else qs[None]):
                want = np.argsort(-oracle(q, d), kind="stable")[:3]
                got = got_i[b] if qs.ndim == 3 else got_i
                np.testing.assert_array_equal(got, want)

    def test_minhash_dtype_corpus_is_authoritative(self, rng):
        # slot.py `_minhash_dtype` `== np.uint16`: a u16 QUERY against a
        # raw u32 corpus must NOT narrow the corpus; u16 corpora resolve
        # u16; dtype-less corpora fall back to the query's width.
        from innr_tpu.ops.slot import SketchCorpus, _minhash_dtype

        q16 = rng.integers(0, 2**16, 8).astype(np.uint16)
        q32 = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
        c32 = rng.integers(0, 2**32, (4, 8), dtype=np.uint64).astype(np.uint32)
        c16 = c32.astype(np.uint16)
        assert _minhash_dtype(q16, c32) == jnp.dtype(jnp.uint32)
        assert _minhash_dtype(q32, c16) == jnp.dtype(jnp.uint16)
        assert _minhash_dtype(q16, c32.tolist()) == jnp.dtype(jnp.uint16)
        assert _minhash_dtype(q32, c32.tolist()) == jnp.dtype(jnp.uint32)
        assert _minhash_dtype(q16, SketchCorpus(c32)) == jnp.dtype(jnp.uint32)
        assert _minhash_dtype(q32, SketchCorpus(c16)) == jnp.dtype(jnp.uint16)


class TestSeed2Survivors:
    """Killers for the seed-2 sample (first unseen-seed triage)."""

    def test_sparse_maxsim_tuple_inputs_match_list_inputs(self):
        # sparse.py tuple-arity detection `len(query_tokens) == 2`: a
        # prepadded (idx, val) pair must score identically to the
        # equivalent token-pair list (a miscounting mutant routes tuples
        # through pad_sparse and crashes or mis-scores).
        q_tokens = [([1, 4], [1.0, 2.0]), ([2], [3.0])]
        d_tokens = [([1], [5.0]), ([4, 2], [0.5, 1.0])]
        want = float(it.sparse_maxsim(q_tokens, d_tokens))
        # token 0: max(1*5, 2*0.5) = 5; token 1: max(0, 3*1) = 3
        assert want == pytest.approx(8.0)
        q_pair = it.pad_sparse(q_tokens)
        d_pair = it.pad_sparse(d_tokens)
        assert float(it.sparse_maxsim(q_pair, d_pair)) == pytest.approx(want)
        assert float(it.sparse_maxsim(q_pair, d_tokens)) == pytest.approx(want)
        assert float(it.sparse_maxsim(q_tokens, d_pair)) == pytest.approx(want)

    def test_binary_knn_batch_values_and_guards(self, rng):
        # binary.py binary_knn_batch: the (Q, W) validation must ACCEPT
        # valid 2-D queries (an `ndim == 2` mutant rejects everything),
        # `n == 0 or k == 0` must return (Q, 0) for EITHER arm, and a
        # word-count mismatch must raise.
        from innr_tpu.ops.binary import binary_knn_batch

        rows = rng.standard_normal((20, 64)).astype(np.float32)
        corpus = it.PackedBinaryBatch.encode(rows)
        queries = it.encode_binary_batch(rows[:3])
        counts, idx = binary_knn_batch(queries, corpus, 2)
        assert counts.shape == (3, 2) and idx.shape == (3, 2)
        assert (idx[:, 0] == np.arange(3)).all()  # self-hit first
        assert (counts[:, 0] == 0).all()
        counts0, idx0 = binary_knn_batch(queries, corpus, 0)
        assert counts0.shape == (3, 0) and idx0.shape == (3, 0)
        empty = it.PackedBinaryBatch.encode(np.zeros((0, 64), np.float32))
        counts_e, idx_e = binary_knn_batch(queries, empty, 2)
        assert counts_e.shape == (3, 0) and idx_e.shape == (3, 0)
        with pytest.raises(it.ContractError):
            binary_knn_batch(np.zeros((3, 1), np.uint32), corpus, 2)

    def test_binary_knn_k_zero_never_reaches_kernel(self, rng, monkeypatch):
        # binary.py `n == 0 or k == 0` guards (single + batch): k == 0
        # must return empty without scoring anything.
        from innr_tpu.ops.binary import binary_knn, binary_knn_batch

        _force_kernel_route(monkeypatch)

        def boom(*a, **kw):
            raise AssertionError("a kernel invoked with k == 0")

        monkeypatch.setattr(triton_knn, "knn_keys", boom)
        rows = rng.standard_normal((32, 64)).astype(np.float32)
        corpus = it.PackedBinaryBatch.encode(rows)
        queries = it.encode_binary_batch(rows[:2])
        counts, idx = binary_knn_batch(queries, corpus, 0)
        assert counts.shape == (2, 0) and idx.shape == (2, 0)
        c1, i1 = binary_knn(it.encode_binary(rows[0]), corpus, 0)
        assert c1.shape == (0,) and i1.shape == (0,)

    def test_topk_negative_distance_total_order(self):
        # topk.py `_total_key` `bits ^ 0x7FFFFFFF` for negatives: an
        # AND mutant maps negative distances onto positive-key space,
        # inverting their order. Mixed-sign inserts through the full
        # insert/evict/threshold path must sort by f32::total_cmp.
        t = it.TopK(3)
        for i, d in enumerate([-0.5, 0.25, -2.0, -1.0, -0.0, 1.5]):
            t.insert(i, d)
        out = t.into_sorted()
        assert [i for i, _ in out] == [2, 3, 0]
        assert [d for _, d in out] == [-2.0, -1.0, -0.5]
        t2 = it.TopK(2)
        for i, d in enumerate([-0.5, -2.0]):
            t2.insert(i, d)
        assert t2.threshold() == -0.5

    def test_slot_compare_counts_u64_hi_lo_composition(self):
        # slot.py u64 (hi, lo) pair comparison: eq = hi_eq AND lo_eq,
        # lt = hi_lt OR (hi_eq AND lo_lt). Slots are chosen so every
        # and/or mutant flips at least one count: high words differ with
        # the LOW words ordered the other way, and vice versa.
        two32 = 1 << 32
        a = np.array([2 * two32 + 1, 1 * two32 + 1, 1 * two32 + 5,
                      1 * two32 + 7], dtype=np.uint64)
        b = np.array([1 * two32 + 5, 1 * two32 + 5, 1 * two32 + 5,
                      2 * two32 + 3], dtype=np.uint64)
        c = it.slot_compare_counts(a, b)
        #        a0 > b0 (hi), a1 < b1 (lo), a2 == b2, a3 < b3 (hi)
        assert (c.eq, c.lt, c.gt) == (1, 2, 1)

    def test_packed_binary_set_out_of_range_is_identity(self, rng):
        # binary.py `idx >= dimension or idx < 0`: setting idx == d must
        # NOT touch a padding bit (a `>` mutant flips one, corrupting
        # every popcount-based distance).
        d = 5
        pb = it.encode_binary(np.array([1, -1, 1, -1, 1], np.float32))
        for bad in (d, d + 3, -1):
            same = pb.set(bad, True)
            np.testing.assert_array_equal(
                np.asarray(same.words), np.asarray(pb.words)
            )
        hit = pb.set(1, True)
        assert int(it.binary_hamming(hit, pb)) == 1

    def test_sparse_dense_dot_oob_masked_exactly(self):
        # sparse_ext.py OOB handling: in-bounds entries contribute
        # val * dense[idx], OOB entries contribute exactly 0.0 (the
        # rewritten where-gather keeps the site mutation-observable via
        # the in_bounds comparison alone).
        from innr_tpu.ops.sparse_ext import sparse_dense_dot

        dense = np.array([1.0, 10.0, 100.0], np.float32)
        got = float(sparse_dense_dot(
            ([0, 2, 3, 7], [1.0, 2.0, 5.0, 9.0]), dense
        ))
        assert got == pytest.approx(1.0 + 200.0)

    def test_pruned_cosine_plans_in_dot_space(self, rng, monkeypatch):
        # pruned_knn.py cosine -> dot plan-mode fold: the docstring
        # contract is that cosine pruning plans as DOT against the
        # unit-row summary (|q_hat| = 1). Pin the interface so a mode
        # pass-through can't silently switch the planner's bound family.
        from innr_tpu import prune
        kpruned = _kpruned

        seen = []
        real = prune.plan_survivors

        def spy(qs, cent, rad, cnt, k, mode, fast=False):
            seen.append(mode)
            return real(qs, cent, rad, cnt, k, mode, fast=fast)

        monkeypatch.setattr(kpruned, "plan_survivors", spy, raising=False)
        monkeypatch.setattr(prune, "plan_survivors", spy)
        rows = rng.standard_normal((512, 8)).astype(np.float32)
        s = prune.build_tile_summary(jnp.asarray(rows), 256, normalized=True)
        qs = jnp.asarray(rows[:2])
        kpruned.fused_knn_cosine_pruned_batch(
            qs, jnp.asarray(rows), s, 3,
            inv=1.0 / jnp.linalg.norm(jnp.asarray(rows), axis=1),
        )
        assert seen == ["dot"]


class TestFusedGateContracts:
    """ONE table for every MIN_ROWS-gated fused dispatch in the packed
    families (binary/ternary, single + batch + scoring forms): the gate
    must be boundary-INCLUSIVE (n == MIN fuses, n == MIN-1 does not),
    force_reference must win over any corpus size, and the k-cap clause
    (where present) must route k > cap to the fallback — each arm
    observable only through which path runs, so each is pinned with a
    call-recording spy. Kills the recurring and/or/>= gate-mutant class
    wholesale instead of per-sampled-site."""

    MIN = 16

    def _spy(self, monkeypatch, mod, attr):
        calls = []
        real = getattr(mod, attr)

        def wrap(*a, **kw):
            calls.append(attr)
            return real(*a, **kw)

        monkeypatch.setattr(mod, attr, wrap)
        return calls

    def _cases(self, rng):
        def bin_args(n):
            rows = rng.standard_normal((n, 64)).astype(np.float32)
            return it.PackedBinaryBatch.encode(rows), rows

        def tern_args(n):
            rows = rng.standard_normal((n, 64)).astype(np.float32)
            return it.PackedTernaryBatch.encode(rows, 0.3), rows

        return [
            ("binary_knn", "binary",
             lambda n, k: it.binary_knn(
                 it.encode_binary(bin_args(n)[1][0]), bin_args(n)[0], k)),
            ("binary_knn_batch", "binary",
             lambda n, k: it.ops.binary.binary_knn_batch(
                 it.encode_binary_batch(bin_args(n)[1][:2]),
                 bin_args(n)[0], k)),
            ("batch_binary_hamming", "binary",
             lambda n, k: it.batch_binary_hamming(
                 it.encode_binary(bin_args(n)[1][0]).words,
                 bin_args(n)[0].words)),
            ("ternary_knn", "ternary",
             lambda n, k: it.ternary_knn(
                 it.encode_ternary(tern_args(n)[1][0], 0.3),
                 tern_args(n)[0], k)),
            ("ternary_knn_batch", "ternary",
             lambda n, k: it.ops.ternary.ternary_knn_batch(
                 [it.encode_ternary(r, 0.3) for r in tern_args(n)[1][:2]],
                 tern_args(n)[0], k)),
            ("batch_ternary_dot", "ternary",
             lambda n, k: it.batch_ternary_dot(
                 it.encode_ternary(tern_args(n)[1][0], 0.3),
                 tern_args(n)[0].pos, tern_args(n)[0].neg)),
        ]

    def test_boundary_inclusive_and_forced(self, rng, monkeypatch):
        # The packed families have no kernel: at every size the route is
        # XLA, even with the kernel route forced or the reference forced.
        from innr_tpu import config, route

        _force_kernel_route(monkeypatch)
        calls = self._spy(monkeypatch, triton_knn, "knn_keys")
        for name, family, call in self._cases(rng):
            for n in (self.MIN - 1, self.MIN, 10**8):
                assert route.route(family, "gpu", n, 3, jnp.uint32, 1,
                                   64) == "xla", name
            call(self.MIN, 3)
            config.force_reference(True)
            try:
                call(self.MIN, 3)
            finally:
                config.force_reference(False)
            assert not calls, f"{name}: no kernel may run"

    def test_k_cap_routes_to_fallback(self, rng, monkeypatch):
        # The dense kernel's k cap is inclusive: k == TRITON_MAX_K takes
        # the kernel, one past it the XLA route (whose top_k has no cap).
        from innr_tpu import route

        cap = route.TRITON_MAX_K
        n = route.TRITON_MIN_ROWS
        for dt in (jnp.float32, jnp.bfloat16, jnp.uint8):
            assert route.route("dense", "gpu", n, cap, dt, 4, 128) == "triton"
            assert route.route("dense", "gpu", n, cap + 1, dt, 4, 128) == "xla"
        for name, family, call in self._cases(rng):
            got = call(self.MIN, 5)
            assert len(np.atleast_1d(got[1] if isinstance(got, tuple) else got)) > 0

    def test_k_zero_never_reaches_ternary_kernel(self, rng, monkeypatch):
        # ternary twin of the binary k==0 killer.
        from innr_tpu.ops.ternary import ternary_knn_batch

        _force_kernel_route(monkeypatch)

        def boom(*a, **kw):
            raise AssertionError("a kernel invoked with k == 0")

        monkeypatch.setattr(triton_knn, "knn_keys", boom)
        rows = rng.standard_normal((32, 64)).astype(np.float32)
        corpus = it.PackedTernaryBatch.encode(rows, 0.3)
        q = it.encode_ternary(rows[0], 0.3)
        d0, i0 = it.ternary_knn(q, corpus, 0)
        assert d0.shape == (0,) and i0.shape == (0,)
        db, ib = ternary_knn_batch([q, q], corpus, 0)
        assert db.shape == (2, 0) and ib.shape == (2, 0)

    def test_maxsim_forced_reference_stays_unfused(self, rng, monkeypatch):
        from innr_tpu import config

        _force_kernel_route(monkeypatch)

        def boom(*a, **kw):
            raise AssertionError("a kernel under force_reference")

        monkeypatch.setattr(triton_knn, "knn_keys", boom)
        q = rng.standard_normal((3, 8)).astype(np.float32)
        docs = rng.standard_normal((64, 4, 8)).astype(np.float32)
        config.force_reference(True)
        try:
            vals, idx = it.maxsim_knn(q, docs, 3)
        finally:
            config.force_reference(False)
        assert idx.shape == (3,)


class TestSeed2SurvivorsB:
    """Killers for the fourth seed-2 sample (tenth triage)."""

    def test_topk_insert_batch_shape_contract(self, rng):
        # topk.py `ids.shape != dists.shape`: mismatch raises, and a
        # VALID batch insert must not (an Eq mutant inverts both).
        t = it.TopK(3)
        t.insert_batch(np.arange(6, dtype=np.uint32),
                       np.array([5.0, 1.0, 3.0, 2.0, 4.0, 0.5], np.float32))
        assert [i for i, _ in t.into_sorted()] == [5, 1, 3]
        with pytest.raises(ValueError):
            t.insert_batch(np.arange(3, dtype=np.uint32),
                           np.zeros(4, np.float32))

    def test_sparse_dense_dot_empty_arms(self):
        # sparse_ext.py `idx empty or dense empty`: each arm must return
        # 0.0 on its own (the and-mutant crashes on the empty-dense
        # gather; the empty-idx arm keeps the f32 scalar contract).
        from innr_tpu.ops.sparse_ext import sparse_dense_dot

        assert float(sparse_dense_dot(
            ([], []), np.array([1.0, 2.0], np.float32))) == 0.0
        assert float(sparse_dense_dot(
            ([0, 1], [1.0, 2.0]), np.zeros((0,), np.float32))) == 0.0
        assert float(sparse_dense_dot(([], []), np.zeros(0, np.float32))) == 0.0

    def test_packed_binary_batch_ctor_validation_arms(self, rng):
        # binary.py PackedBinaryBatch ctor `ndim != 2 or wrong words`:
        # each invalid arm must raise ContractError on its own.
        words = np.zeros((4, 2), np.uint32)
        it.PackedBinaryBatch(words, 64)  # valid: 2 words = 64 bits
        with pytest.raises(it.ContractError):
            it.PackedBinaryBatch(np.zeros((8,), np.uint32), 64)  # 1-D
        with pytest.raises(it.ContractError):
            it.PackedBinaryBatch(np.zeros((4, 3), np.uint32), 64)  # words
        with pytest.raises(it.ContractError):
            it.PackedBinaryBatch(np.zeros((2, 2, 2), np.uint32), 64)  # 3-D

    def test_packed_binary_eq_all_clauses(self, rng):
        # binary.py __eq__ `isinstance AND dims AND words`: every clause
        # must be necessary (an or-mutant equates everything).
        a = it.encode_binary(np.array([1, -1, 1, -1], np.float32))
        same = it.encode_binary(np.array([1, -1, 1, -1], np.float32))
        other_words = it.encode_binary(np.array([1, 1, 1, -1], np.float32))
        other_dim = it.encode_binary(np.array([1, -1, 1], np.float32))
        assert a == same
        assert a != other_words
        assert a != other_dim
        assert a != "not packed"
        assert a != 7

    def test_parse_query_tokens_arities(self):
        # sparse.py _parse_query_tokens `len(...) == 2` + ndim routing:
        # a bare 1-D pair lifts to ONE token, a 2-D pair passes through,
        # a list of pairs pads, empties parse to (0, 1).
        from innr_tpu.ops.sparse import _parse_query_tokens

        # bare 1-D pair must be ARRAYS: a tuple of lists is (by the
        # documented ambiguity contract) parsed as a list of token pairs.
        qi, qv = _parse_query_tokens(
            (np.array([1, 5], np.uint32), np.array([0.5, 2.0], np.float32))
        )
        assert qi.shape == (1, 2) and qv.shape == (1, 2)
        np.testing.assert_array_equal(np.asarray(qi), [[1, 5]])
        idx2 = np.array([[1, 5], [2, 7]], np.uint32)
        val2 = np.array([[0.5, 2.0], [1.0, 3.0]], np.float32)
        pi, pv = _parse_query_tokens((idx2, val2))
        assert pi.shape == (2, 2) and pv.shape == (2, 2)
        np.testing.assert_array_equal(np.asarray(pi), idx2)
        li, lv = _parse_query_tokens([([1], [0.5]), ([2, 3], [1.0, 2.0])])
        assert li.shape == (2, 2) and lv.shape == (2, 2)
        ei, ev = _parse_query_tokens([])
        assert ei.shape == (0, 1) and ev.shape == (0, 1)


class TestSeed5Survivors:
    """Killers for the unseen seed-5 sample (eleventh triage)."""

    def test_maxsim_knn_batch_dispatch_boundary(self, rng, monkeypatch):
        # MaxSim has one route (the einsum) at every corpus size: no
        # size boundary exists, results match the float64 oracle on
        # both sides of the old one, and force_reference changes nothing.
        from innr_tpu import config, route

        qs = rng.standard_normal((2, 3, 8)).astype(np.float32)

        def docs(n):
            return rng.standard_normal((n, 4, 8)).astype(np.float32)

        def oracle(q, d):
            pair = np.einsum("td,nsd->nts", q.astype(np.float64),
                             d.astype(np.float64))
            return pair.max(axis=2).sum(axis=1)

        for n in (63, 64, 127, 128):
            assert route.route("maxsim", "gpu", n, 3, jnp.float32, 1, 8) == "xla"
            d = docs(n)
            got_v, got_i = it.maxsim_knn_batch(qs, d, 3)
            config.force_reference(True)
            try:
                ref_v, ref_i = it.maxsim_knn_batch(qs, d, 3)
            finally:
                config.force_reference(False)
            np.testing.assert_array_equal(got_i, ref_i)
            for b, q in enumerate(qs if qs.ndim == 3 else qs[None]):
                want = np.argsort(-oracle(q, d), kind="stable")[:3]
                got = got_i[b] if qs.ndim == 3 else got_i
                np.testing.assert_array_equal(got, want)

    def test_total_key_involution_bitexact(self, rng):
        # scan.py `invert_total_key` constants: the decode
        # must invert the encode BIT-EXACTLY for every f32 class —
        # negatives are where the (keys >> 31) >>> 1 mask is live.
        _invert_total_key = scan.invert_total_key
        from innr_tpu.utils.order import total_order_key_f32

        special = np.array(
            [0.0, -0.0, 1.5, -1.5, 1e-38, -1e-38, np.inf, -np.inf, np.nan],
            np.float32,
        )
        soup = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(
            np.uint32
        ).view(np.float32)
        for vals in (special, soup):
            keys = total_order_key_f32(jnp.asarray(vals))
            back = np.asarray(_invert_total_key(keys))
            np.testing.assert_array_equal(
                back.view(np.int32), vals.view(np.int32)
            )

    def test_ternary_set_range_semantics(self, rng):
        # ternary.py PackedTernary.set: OOB identity (both ends) and
        # in-range set round-trips through the sign planes.
        v = np.array([1, -1, 0, 1, -1], np.float32)
        pt = it.encode_ternary(v, 0.5)
        for bad in (5, 9, -1):
            same = pt.set(bad, 1)
            np.testing.assert_array_equal(
                np.asarray(same.pos), np.asarray(pt.pos)
            )
            np.testing.assert_array_equal(
                np.asarray(same.neg), np.asarray(pt.neg)
            )
        flipped = pt.set(2, -1)
        want = v.copy()
        want[2] = -1
        got = np.asarray(it.encode_ternary(want, 0.5).neg)
        np.testing.assert_array_equal(np.asarray(flipped.neg), got)

    def test_adaptive_warmup_cutoff_is_strict(self):
        # batch.py `partial * scale > threshold * 1.5`: a candidate whose
        # extrapolated distance lands EXACTLY on the 1.5x cutoff stays
        # ALIVE (the reference prunes only on strictly-greater,
        # src/batch.rs:474-488). Constructed in exact f32 dyadics:
        # partials 2/3/10, scale 2, threshold 4, cutoff 6; the true
        # nearest row X sits exactly at 3 * 2 == 6.
        rows = np.array(
            [
                [1, 1, 0, 0, 5, 0, 0, 0],   # warmup kth: partial 2, full 27
                [1, 1, 1, 0, 0, 0, 0, 0],   # X: partial 3 -> cutoff-exact
                [3, 1, 0, 0, 0, 0, 0, 0],   # pruned: partial 10
            ],
            np.float32,
        )
        vb = it.VerticalBatch.from_rows(rows)
        q = np.zeros(8, np.float32)
        res = it.batch_knn_adaptive(q, vb, 1, warmup_dims=4)
        assert res.indices.tolist() == [1]
        assert res.scores.tolist() == [3.0]


class TestSeed5SurvivorsB:
    """Killers for the second seed-5 sample (twelfth triage)."""

    def test_fast_plan_eligibility_excludes_small_tiles(self, rng):
        # prune.py `eligible & ~isnan`: the fast threshold may only come
        # from tiles holding >= k rows. A ragged tile (20 rows) closest
        # to every query would set a TIGHTER t0 if it leaked into the
        # max (the | mutant) — pruning tiles the oracle keeps.
        from innr_tpu import prune

        tile_n, k, d = 64, 64, 8
        centers = rng.standard_normal((9, d)).astype(np.float32) * 200.0
        full = np.repeat(centers[:8], tile_n, axis=0)
        ragged = np.repeat(centers[8:], 20, axis=0)
        rows = np.concatenate([full, ragged])
        rows += rng.standard_normal(rows.shape).astype(np.float32)
        s = prune.build_tile_summary(jnp.asarray(rows), tile_n)
        assert int(np.asarray(s.counts)[-1]) == 20  # construction holds
        qs = centers[8:] + 0.01  # all queries sit on the RAGGED cluster
        order, n_surv = prune.plan_survivors(
            jnp.asarray(qs), s.centroids, s.radii, s.counts, k, "l2",
            fast=True,
        )
        cent = np.asarray(s.centroids, np.float64)
        rad = np.asarray(s.radii, np.float64)
        cnt = np.asarray(s.counts)
        qd = qs.astype(np.float64) @ cent.T
        qq = np.sum(qs.astype(np.float64) ** 2, axis=1, keepdims=True)
        cc = np.sum(cent * cent, axis=1)[None, :]
        qc = np.sqrt(np.maximum(qq + cc - 2.0 * qd, 0.0))
        guaranteed = (qc + rad[None, :]) ** 2
        optimistic = np.maximum(qc - rad[None, :], 0.0) ** 2
        t0 = np.min(np.where((cnt >= k)[None, :], guaranteed, np.inf),
                    axis=1, keepdims=True)
        want_alive = ~np.all(optimistic > t0, axis=0)
        got_alive = np.zeros(cnt.size, bool)
        got_alive[np.asarray(order)[: int(n_surv)]] = True
        assert want_alive[-1]  # the ragged tile itself must survive
        np.testing.assert_array_equal(got_alive, want_alive)

    def test_inv_norms_epsilon_boundary_strict(self):
        # scan.py inv_norms: a row whose norm is EXACTLY
        # NORM_EPSILON is zero-norm by contract -> inverse 0.0 (the
        # single `ok` guard is strict; it also feeds the divisor, so a
        # relaxed mutant divides by 1e-9 and returns 1e9).
        from innr_tpu.config import NORM_EPSILON
        inv_norms = scan.inv_norms

        x = np.float32(NORM_EPSILON)
        assert np.float32(np.sqrt(np.float32(x * x))) == x  # roundtrip
        rows = np.zeros((3, 4), np.float32)
        rows[0, 0] = x          # exactly epsilon -> 0.0
        rows[1, 0] = 2.0        # ordinary row    -> 0.5
        inv = np.asarray(inv_norms(jnp.asarray(rows)))
        assert inv[0] == 0.0
        assert inv[1] == pytest.approx(0.5)
        assert inv[2] == 0.0    # true zero row

    def test_df64_splitter_carries_low_bits(self, rng):
        # dense_f64.py `_SPLITTER = 4097.0` (2^12 + 1): a broken Dekker
        # split degenerates two_prod's error term and the df64 dot
        # collapses to f32 accuracy (~1e-7) — far outside the 1e-11
        # bound random 53-bit mantissas demand.
        a = rng.uniform(1.0, 2.0, 256)
        b = rng.uniform(1.0, 2.0, 256)
        got = float(it.dot_f64(a, b))
        want = float(np.dot(a, b))
        assert abs(got - want) / abs(want) < 1e-11


class TestFoundationExhaustive:
    """Killers for the exhaustive foundational-module sweep (106/106
    sites run; 13 survivors triaged here or documented equivalent)."""

    def test_as_f32_coerces_integer_and_bf16_inputs(self):
        # dense.py `_as_f32` dtype test: integer / bf16 inputs must
        # compute and return in f32 (an inverted mutant leaves int32
        # arithmetic and an int32 result).
        d = it.dot(np.array([1, 2, 3]), np.array([4, 5, 6]))
        assert d.dtype == jnp.float32
        assert float(d) == 32.0
        a16 = jnp.asarray([1.0, 2.0], dtype=jnp.bfloat16)
        n = it.norm(a16)
        assert n.dtype == jnp.float32

    def test_normalize_with_norm_epsilon_boundary(self):
        # dense.py `n > NORM_EPSILON` strict: a vector whose norm is
        # EXACTLY epsilon is returned UNSCALED (not blown up by 1/1e-9).
        from innr_tpu.config import NORM_EPSILON

        x = np.float32(NORM_EPSILON)
        v = np.array([x, 0.0], np.float32)
        scaled, n = it.normalize_with_norm(v)
        assert float(n) == float(x)
        np.testing.assert_array_equal(np.asarray(scaled), v)

    def test_fast_cosine_epsilon_sq_boundaries_each_side(self):
        # fast_math.py `(aa > EPS_SQ) & (bb > EPS_SQ)`: each clause must
        # be strict on ITS OWN side (squared-norm landing exactly on the
        # epsilon -> 0.0).
        from innr_tpu.config import NORM_EPSILON_SQ

        x = np.float32(7.071061e-10)
        y = np.float32(7.071075e-10)
        aa = np.float32(np.float32(x * x) + np.float32(y * y))
        assert aa == np.float32(NORM_EPSILON_SQ)
        tiny = np.array([x, y], np.float32)
        unit = np.array([1.0, 0.0], np.float32)
        assert float(it.fast_cosine(tiny, unit)) == 0.0
        assert float(it.fast_cosine(unit, tiny)) == 0.0

    def test_fast_rsqrt_precise_is_exactly_two_iterations(self, rng):
        # fast_math.py `nr_iterations=2` call-site constant: the API
        # contract is reference PARITY (two NR steps, src/fast_math.rs:65)
        # — not "as precise as possible". The 1/2/3-iteration error bands
        # are cleanly separated (measured max rel: 1.8e-3 / 4.7e-6 /
        # 1.4e-7), so the mean error over a fixed sample pins the count.
        xs = rng.uniform(1e-6, 1e6, 20000).astype(np.float32)
        y = np.asarray(it.fast_rsqrt_precise(jnp.asarray(xs)), np.float64)
        true = 1.0 / np.sqrt(xs.astype(np.float64))
        mean_rel = float(np.mean(np.abs(y - true) / true))
        assert 5e-7 < mean_rel < 5e-6, mean_rel

    def test_sparse_top_k_size_equal_passthrough(self):
        # sparse_ext.py `val.size <= k` INCLUSIVE: at size == k the
        # vector is returned UNCHANGED (reference passthrough), not
        # re-sorted by dimension.
        from innr_tpu.ops.sparse_ext import sparse_top_k

        idx = np.array([9, 2, 5], np.uint32)  # deliberately dim-unsorted
        val = np.array([1.0, -3.0, 2.0], np.float32)
        gi, gv = sparse_top_k((idx, val), 3)
        np.testing.assert_array_equal(gi, idx)
        np.testing.assert_array_equal(gv, val)
        si, sv = sparse_top_k((idx, val), 2)  # selection path re-sorts
        np.testing.assert_array_equal(si, [2, 5])
        np.testing.assert_array_equal(sv, [-3.0, 2.0])

    def test_sparse_max_weight_both_arms(self):
        # sparse_ext.py `shape == 0` guard: the empty arm returns 0.0 and
        # the non-empty arm returns the real max (an inverted mutant
        # zeroes every non-empty result).
        from innr_tpu.ops.sparse_ext import sparse_max_weight

        assert float(sparse_max_weight(([1, 4], [5.0, 2.0]))) == 5.0
        assert float(sparse_max_weight(([], []))) == 0.0
        assert float(sparse_max_weight(([1], [-3.0]))) == 0.0  # folded

    def test_topk_scalar_key_positive_zero_boundary(self):
        # topk.py `_total_key` `bits < 0` STRICT: +0.0 (bits == 0) must
        # not take the sign-flip branch — total_cmp: -0.0 < +0.0 < 1.0.
        t = it.TopK(2)
        t.insert(1, 0.0)
        t.insert(2, 1.0)
        t.insert(3, -0.0)
        out = t.into_sorted()
        assert [i for i, _ in out] == [3, 1]  # -0.0 then +0.0

    def test_topk_full_reject_on_equal_is_inclusive(self):
        # topk.py `key >= worst -> reject`: an EQUAL candidate must be
        # rejected (first-come keeps its slot), not evict the incumbent.
        t = it.TopK(1)
        t.insert(7, 5.0)
        t.insert(8, 5.0)
        assert t.into_sorted() == [(7, 5.0)]

    def test_argsort_total_descending(self):
        # utils/order.py `~keys` for descending: dropping the invert
        # returns ascending order.
        from innr_tpu.utils.order import argsort_total

        x = jnp.asarray(np.array([1.0, 3.0, 2.0, -1.0], np.float32))
        np.testing.assert_array_equal(
            np.asarray(argsort_total(x, descending=True)), [1, 2, 0, 3]
        )
        np.testing.assert_array_equal(
            np.asarray(argsort_total(x)), [3, 0, 2, 1]
        )


class TestMaxsimKernelExhaustive:
    """Killers for the exhaustive maxsim_kernel/slot_knn sweep."""

    def test_single_query_accepts_nested_list_docs(self, rng):
        # maxsim_kernel.py:93 dtype coercion in the SINGLE-query scorer
        # (the batch twin is already pinned).
        fused_maxsim_scores = _kmax.fused_maxsim_scores

        q = rng.standard_normal((3, 8)).astype(np.float32)
        docs = rng.standard_normal((4, 5, 8)).astype(np.float32)
        got_list = fused_maxsim_scores(q, docs.tolist())
        got_arr = fused_maxsim_scores(q, docs)
        np.testing.assert_array_equal(np.asarray(got_list), np.asarray(got_arr))

    @staticmethod
    def _maxsim_oracle(qs, docs):
        # sum_i max_j q_i . d_j in f32, (B, N)
        scores = np.einsum("btd,nsd->bnts", qs, docs).astype(np.float32)
        return scores.max(axis=3).sum(axis=2)

    def test_ragged_doc_tokens_all_negative_scores(self, rng):
        # maxsim_kernel.py use_mask `td_pad != td`: sublane padding adds
        # zero doc-token rows whose dot is 0 — with ALL real scores
        # negative, an unmasked pad token would wrongly win every max.
        # td = 3 (pads to 8); construction forces every dot negative.
        fused_maxsim_scores = _kmax.fused_maxsim_scores
        fused_maxsim_scores_batch = _kmax.fused_maxsim_scores_batch

        qs = np.abs(rng.standard_normal((2, 3, 8))).astype(np.float32)
        docs = -np.abs(rng.standard_normal((4, 3, 8))).astype(np.float32)
        want = self._maxsim_oracle(qs, docs)
        assert (want < 0).all()  # construction: padding would flip to >= 0
        got = np.asarray(fused_maxsim_scores_batch(qs, docs))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        got1 = np.asarray(fused_maxsim_scores(qs[0], docs))
        np.testing.assert_allclose(got1, want[0], rtol=1e-6)

    def test_slot_knn_u32_values_above_int32(self, rng):
        # slot_knn.py unconditional i32 widen: u32 slots ABOVE 2^31 wrap
        # negative, but (tile != qv) is wrap-invariant — equality counts
        # must stay exact for high-bit slot values.
        sk = rng.integers(2**31, 2**32, (20, 8), dtype=np.uint64).astype(np.uint32)
        sk[3] = sk[0]  # plant an exact duplicate
        sims, idx = it.minhash_knn(sk[0], sk, 3)
        assert set(np.asarray(idx)[:2].tolist()) == {0, 3}
        assert float(np.asarray(sims)[0]) == 1.0
        assert float(np.asarray(sims)[1]) == 1.0


class TestPackedExhaustive:
    """Killer for the exhaustive packed_knn sweep: the multi-query
    kernels accumulate popcounts over 8-word sublane chunks, so the
    cross-chunk `counts + chunk` only executes at d > 256 — which no
    prior test reached. d = 512 (16 words, two chunks) pins it against
    brute force for both families."""

    def test_multichunk_binary_and_ternary_batch(self, rng, monkeypatch):
        from innr_tpu import config
        from innr_tpu.ops.binary import binary_knn_batch
        from innr_tpu.ops.ternary import ternary_knn_batch

        _force_kernel_route(monkeypatch)
        d, n, k = 512, 64, 5
        rows = rng.standard_normal((n, d)).astype(np.float32)
        bcorp = it.PackedBinaryBatch.encode(rows)
        bq = it.encode_binary_batch(rows[:2])
        counts, idx = binary_knn_batch(bq, bcorp, k)
        words = np.asarray(bcorp.words)
        qwords = np.asarray(bq.words) if hasattr(bq, "words") else np.asarray(bq)
        for qi in range(2):
            ham = np.array([
                bin(int.from_bytes(np.bitwise_xor(words[r], qwords[qi]).tobytes(), "little")).count("1")
                for r in range(n)
            ])
            order = np.argsort(ham, kind="stable")[:k]
            np.testing.assert_array_equal(np.asarray(idx)[qi], order)
            np.testing.assert_array_equal(np.asarray(counts)[qi], ham[order])

        tcorp = it.PackedTernaryBatch.encode(rows, 0.3)
        tq = [it.encode_ternary(rows[0], 0.3), it.encode_ternary(rows[1], 0.3)]
        dots, tidx = ternary_knn_batch(tq, tcorp, k)
        pos, neg = np.asarray(tcorp.pos), np.asarray(tcorp.neg)
        for qi in range(2):
            qp, qn = np.asarray(tq[qi].pos), np.asarray(tq[qi].neg)
            same = (qp & pos) | (qn & neg)
            diff = (qp & neg) | (qn & pos)
            tdot = np.array([
                bin(int.from_bytes(same[r].tobytes(), "little")).count("1")
                - bin(int.from_bytes(diff[r].tobytes(), "little")).count("1")
                for r in range(n)
            ])
            order = np.argsort(-tdot, kind="stable")[:k]
            np.testing.assert_array_equal(np.asarray(tidx)[qi], order)
            np.testing.assert_array_equal(np.asarray(dots)[qi], tdot[order])


class TestPruneExhaustive:
    """Killers for the exhaustive prune.py sweep (58/58 sites, 84.5%
    before this triage)."""

    def test_normalized_summary_matches_oracle(self, rng):
        # prune.py _summarize(normalized=True): unit-row centroids and
        # radii must match a numpy oracle — a distorted norm merely
        # inflates radii (conservative, exact results), so only a direct
        # summary comparison observes it. Includes a row whose norm is
        # EXACTLY epsilon (strict guard -> zero row).
        from innr_tpu import prune
        from innr_tpu.config import NORM_EPSILON

        rows = rng.standard_normal((96, 8)).astype(np.float32) * 3.0
        rows[5] = 0.0
        rows[6, :] = 0.0
        rows[6, 0] = np.float32(NORM_EPSILON)  # exactly epsilon
        s = prune.build_tile_summary(jnp.asarray(rows), 32, normalized=True)
        norms = np.linalg.norm(rows.astype(np.float64), axis=1)
        unit = np.where(
            (norms > NORM_EPSILON)[:, None],
            rows / np.where(norms > 0, norms, 1.0)[:, None], 0.0
        )
        for t in range(3):
            tile = unit[32 * t: 32 * (t + 1)]
            cent = tile.mean(axis=0)
            rad = np.sqrt(((tile - cent) ** 2).sum(axis=1).max())
            np.testing.assert_allclose(
                np.asarray(s.centroids)[t], cent, atol=1e-6
            )
            np.testing.assert_allclose(
                float(np.asarray(s.radii)[t]), rad, atol=1e-5
            )

    @pytest.mark.parametrize("mode", ["dot", "l2"])
    @pytest.mark.parametrize("fast", [True, False])
    def test_plan_survivors_oracle_random_draws(self, rng, mode, fast):
        # Moderately-separated random draws (diverse margins, unlike the
        # wide-margin clustered case): the alive set must equal the
        # numpy-f64 oracle on every unambiguous draw. Systematic bound
        # distortions (2*qd -> 2+qd, qc+rad -> qc-rad, ...) disagree on
        # some draw by far more than the ambiguity tolerance.
        from innr_tpu import prune

        helper = TestSeed0TriageC
        tile_n, k, used = 32, 8, 0
        for draw in range(20):
            centers = rng.standard_normal((6, 8)).astype(np.float32) * 3.0
            rows = np.repeat(centers, tile_n, axis=0)
            rows += rng.standard_normal(rows.shape).astype(np.float32)
            s = prune.build_tile_summary(jnp.asarray(rows), tile_n)
            qs = rows[rng.choice(len(rows), 4, replace=False)] * 1.01
            cent = np.asarray(s.centroids)
            rad = np.asarray(s.radii)
            cnt = np.asarray(s.counts)
            guaranteed, optimistic = helper._oracle_bounds(qs, cent, rad, mode)
            if fast:
                elig = cnt >= k
                if mode == "dot":
                    t0 = np.max(np.where(elig[None, :], guaranteed, -np.inf),
                                axis=1, keepdims=True)
                else:
                    t0 = np.min(np.where(elig[None, :], guaranteed, np.inf),
                                axis=1, keepdims=True)
            else:
                sign = -1.0 if mode == "dot" else 1.0
                order_g = np.argsort(sign * guaranteed, axis=1)
                cum = np.cumsum(np.take_along_axis(
                    np.broadcast_to(cnt[None, :], guaranteed.shape), order_g,
                    axis=1), axis=1)
                pos = np.minimum(np.sum(cum < k, axis=1), cnt.size - 1)
                t0 = np.take_along_axis(
                    np.take_along_axis(guaranteed, order_g, axis=1),
                    pos[:, None], axis=1)
            margin = np.min(np.abs(optimistic - t0)
                            / np.maximum(np.abs(t0), 1.0))
            if margin < 1e-3:
                continue  # ambiguous draw: f32-vs-f64 could flip it
            dead_q = optimistic < t0 if mode == "dot" else optimistic > t0
            want_alive = ~np.all(dead_q, axis=0)
            order, n_surv = prune.plan_survivors(
                jnp.asarray(qs), s.centroids, s.radii, s.counts, k, mode,
                fast=fast,
            )
            got_alive = np.zeros(cnt.size, bool)
            got_alive[np.asarray(order)[: int(n_surv)]] = True
            np.testing.assert_array_equal(got_alive, want_alive, err_msg=f"draw {draw}")
            used += 1
        assert used >= 10, f"only {used} unambiguous draws"

    def test_dead_test_is_strict_on_exact_tie_l2(self):
        # prune.py `optimistic > t0` STRICT: radius-0 tiles equidistant
        # from the query sit EXACTLY on t0; a >= mutant prunes both tied
        # tiles and the scan returns rows from a far tile instead.
        from innr_tpu import prune
        kknn = _kknn
        kpruned = _kpruned

        d, tile_n = 8, 16
        a = np.zeros(d, np.float32); a[0] = 5.0
        b = np.zeros(d, np.float32); b[0] = -5.0
        c = np.zeros(d, np.float32); c[0] = 100.0
        rows = np.concatenate([
            np.tile(a, (tile_n, 1)), np.tile(b, (tile_n, 1)),
            np.tile(c, (tile_n, 1)),
        ])
        s = prune.build_tile_summary(jnp.asarray(rows), tile_n)
        np.testing.assert_array_equal(np.asarray(s.radii), np.zeros(3))
        qs = jnp.zeros((1, d), jnp.float32)
        order, n_surv = prune.plan_survivors(
            qs, s.centroids, s.radii, s.counts, tile_n, "l2", fast=True
        )
        assert int(n_surv) == 2  # BOTH tied tiles alive, far tile dead
        np.testing.assert_array_equal(np.asarray(order)[:2], [0, 1])
        pv, pi = kpruned.fused_knn_l2_pruned_batch(
            qs, jnp.asarray(rows), s, tile_n
        )
        fv, fi = kknn.fused_knn_l2_batch(qs, jnp.asarray(rows), tile_n)
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))

    def test_dead_test_is_strict_on_exact_tie_dot(self):
        # Mirror for MIPS: `optimistic < t0` strict at qd == t0.
        from innr_tpu import prune

        d, tile_n = 8, 16
        a = np.zeros(d, np.float32); a[0], a[1] = 3.0, 4.0
        b = np.zeros(d, np.float32); b[0], b[1] = 3.0, -4.0
        c = np.zeros(d, np.float32); c[0] = -100.0
        rows = np.concatenate([
            np.tile(a, (tile_n, 1)), np.tile(b, (tile_n, 1)),
            np.tile(c, (tile_n, 1)),
        ])
        s = prune.build_tile_summary(jnp.asarray(rows), tile_n)
        q = np.zeros((1, d), np.float32); q[0, 0] = 1.0
        order, n_surv = prune.plan_survivors(
            jnp.asarray(q), s.centroids, s.radii, s.counts, tile_n, "dot",
            fast=True,
        )
        assert int(n_surv) == 2
        np.testing.assert_array_equal(np.asarray(order)[:2], [0, 1])

    def test_cluster_order_still_groups_after_rr_drop(self, rng):
        # Regression guard for dropping the per-row ||r||^2 constant from
        # the assignment score: grouping quality is unchanged.
        from innr_tpu.prune import cluster_order

        centers = np.eye(3, 8, dtype=np.float32) * 50
        assign = rng.integers(0, 3, 120)
        rows = centers[assign] + 0.01 * rng.standard_normal((120, 8)).astype(
            np.float32)
        perm = np.asarray(cluster_order(rows, n_clusters=6, n_iters=5))
        assert sorted(perm.tolist()) == list(range(120))
        runs = assign[perm]
        assert int(np.sum(runs[1:] != runs[:-1])) <= 6


class TestSeed7Survivors:
    """Killers for the seed-7 sample (seventeenth triage)."""

    def test_packed_binary_get_multiword(self, rng):
        # binary.py get() word arithmetic: a 3-word vector pins the
        # idx // 32 decomposition (an idx * 32 mutant clamps into the
        # wrong word).
        d = 96
        bits = rng.integers(0, 2, d).astype(bool)
        pb = it.encode_binary(np.where(bits, 1.0, -1.0).astype(np.float32))
        for i in range(d):
            assert pb.get(i) == bool(bits[i]), i
        assert pb.get(d) is False and pb.get(-1) is False

    def test_batch_cosine_knn_epsilon_boundaries(self, rng):
        # batch.py multi-query cosine guards: an exact-epsilon-norm
        # corpus row scores 0.0 against a normal query, and an exact-
        # epsilon-norm QUERY scores 0.0 against everything.
        from innr_tpu.config import NORM_EPSILON

        eps = np.float32(NORM_EPSILON)
        rows = rng.standard_normal((6, 4)).astype(np.float32)
        rows[2] = 0.0
        rows[2, 0] = eps
        vb = it.VerticalBatch.from_rows(rows)
        qs = np.zeros((2, 4), np.float32)
        qs[0] = rng.standard_normal(4).astype(np.float32)
        qs[1, 0] = eps
        res = it.batch_knn_cosine(qs, vb, 6)
        scores = np.asarray(res.scores)
        idx = np.asarray(res.indices)
        row2_score = scores[0][np.flatnonzero(idx[0] == 2)[0]]
        assert row2_score == 0.0
        np.testing.assert_array_equal(scores[1], np.zeros(6, np.float32))

    def test_unit_queries_epsilon_boundary(self):
        # scan.py unit_queries: exact-epsilon-norm query row
        # becomes the zero row (strict guard), like inv_norms.
        from innr_tpu.config import NORM_EPSILON
        _unit_queries = scan.unit_queries

        eps = np.float32(NORM_EPSILON)
        qs = np.zeros((2, 4), np.float32)
        qs[0, 0] = 2.0
        qs[1, 0] = eps
        u = np.asarray(_unit_queries(jnp.asarray(qs)))
        np.testing.assert_array_equal(u[0], [1.0, 0, 0, 0])
        np.testing.assert_array_equal(u[1], np.zeros(4, np.float32))

    def test_single_query_op_rejects_2d(self, rng):
        # batch.py _check_query `allow_multi AND ndim == 2`: a 2-D query
        # into a single-query op must raise, not wander into XLA shapes.
        vb = it.VerticalBatch.from_rows(
            rng.standard_normal((4, 3)).astype(np.float32)
        )
        with pytest.raises(it.ContractError):
            it.batch_dot(rng.standard_normal((2, 3)).astype(np.float32), vb)

    def test_pruned_dot_result_shapes(self, rng, monkeypatch):
        # batch.py prune-branch `q.ndim == 1` squeeze: 1-D query ->
        # (k,) arrays; 2-D -> (Q, k).
        from innr_tpu import config

        _force_kernel_route(monkeypatch)
        rows = rng.standard_normal((512, 8)).astype(np.float32)
        vb = it.VerticalBatch.from_rows(rows)
        r1 = it.batch_knn_dot(rows[0], vb, 3, prune=True)
        assert np.asarray(r1.indices).shape == (3,)
        plain = it.batch_knn_dot(rows[0], vb, 3)
        np.testing.assert_array_equal(
            np.asarray(r1.indices), np.asarray(plain.indices)
        )
        r2 = it.batch_knn_dot(rows[:2], vb, 3, prune=True)
        assert np.asarray(r2.indices).shape == (2, 3)

    def test_cosine_f64_epsilon_boundary_strict(self):
        # dense_f64.py `na > f64::EPSILON` strict: a vector whose df64
        # norm is EXACTLY the epsilon is zero-norm -> 0.0 (verified:
        # norm_f64([eps]) round-trips to eps exactly).
        from innr_tpu.ops.dense_f64 import _F64_EPSILON, cosine_f64, norm_f64

        assert float(norm_f64([_F64_EPSILON])) == _F64_EPSILON
        assert float(cosine_f64([_F64_EPSILON], [1.0])) == 0.0
        assert float(cosine_f64([1.0], [_F64_EPSILON])) == 0.0

    def test_l1_f64_native_arm_under_x64(self):
        # dense_f64.py native-l1 arm runs ONLY under jax_enable_x64 —
        # exercised in a subprocess so the |a - b| core is mutation-
        # observable (a + b would triple the value).
        import subprocess
        import sys

        code = (
            "import jax; jax.config.update('jax_enable_x64', True);"
            "jax.config.update('jax_platforms','cpu');"
            "from innr_tpu.ops.dense_f64 import l1_distance_f64;"
            "v = l1_distance_f64([1.0, 2.0], [4.0, 1.0], impl='native');"
            "assert abs(float(v) - 4.0) < 1e-12, v;"
            "print('OK')"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=300,
        )
        assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-500:]


class TestKnnGateAndDispatchContracts:
    """Kills batch.py kNN entry-point gate and ndim-dispatch mutants.

    The `num_vectors == 0 or k == 0` gates (batch_knn/_dot/_cosine/
    _filtered) must early-return BEFORE the fused branch: with the gate
    And-mutated, k=0 on a fused-eligible corpus reaches the kernel and
    crashes. The prune/fused branches' q.ndim dispatch must route 1-D
    queries through the (Q, D) kernel with a leading axis and squeeze the
    result, and 2-D queries straight through — pinned by exact parity
    with the reference (non-fused) path at both ndims.
    """

    def _vb(self, rng, n=64, d=16):
        from innr_tpu.batch import VerticalBatch
        return VerticalBatch.from_rows(
            rng.standard_normal((n, d)).astype(np.float32)
        )

    def test_k0_on_fused_eligible_corpus_is_empty(self, rng, monkeypatch):
        from innr_tpu import batch as B
        from innr_tpu import config

        _force_kernel_route(monkeypatch)
        vb = self._vb(rng)
        q1 = rng.standard_normal(16).astype(np.float32)
        q2 = rng.standard_normal((3, 16)).astype(np.float32)
        for fn in (B.batch_knn, B.batch_knn_dot, B.batch_knn_cosine):
            r = fn(q1, vb, 0)
            assert r.indices.shape == (0,) and r.scores.shape == (0,)
            r = fn(q2, vb, 0)
            assert r.indices.shape == (3, 0) and r.scores.shape == (3, 0)
        r = B.batch_knn_filtered(q1, vb, 0, lambda i: True)
        assert r.indices.shape == (0,)
        r = B.batch_knn_filtered(q2, vb, 0, lambda i: True)
        assert r.indices.shape == (3, 0)
        # reordered shares the gate; Or->And reaches the kernel with k=0
        r = B.batch_knn_reordered(q1, vb, 0)
        assert r.indices.shape == (0,)
        empty = B.VerticalBatch.from_flat([], 0, 16)
        r = B.batch_knn_reordered(q2, empty, 3)
        assert r.indices.shape == (3, 0)

    def test_single_row_variance_is_exact_zero_even_nonfinite(self):
        # Population variance of ONE sample is 0 by definition; the <=1
        # guard (not <1) is what keeps inf rows from producing inf-inf=NaN.
        from innr_tpu.batch import VerticalBatch, batch_dimension_variance
        vb = VerticalBatch.from_rows(
            np.array([[np.inf, -np.inf, 1.0, np.nan]], dtype=np.float32)
        )
        v = np.asarray(batch_dimension_variance(vb))
        np.testing.assert_array_equal(v, np.zeros(4, dtype=np.float32))

    def test_fused_gate_boundary_inclusive(self, rng, monkeypatch):
        from innr_tpu import batch as B
        from innr_tpu import route

        # The route's size gate is boundary-inclusive...
        m = route.TRITON_MIN_ROWS
        assert route.route("dense", "gpu", m, 2, jnp.float32, 1, 8 * 16) == "triton"
        assert route.route("dense", "gpu", m - 1, 2, jnp.float32, 1, 128) == "xla"
        # ...and batch_knn follows the route it reports.
        _force_kernel_route(monkeypatch)
        calls = []
        real = triton_knn.knn_keys
        monkeypatch.setattr(
            triton_knn, "knn_keys",
            lambda *a, **kw: calls.append("kernel") or real(*a, **kw),
        )
        q = rng.standard_normal(16).astype(np.float32)
        B.batch_knn(q, self._vb(rng, n=15, d=16), 2)
        assert calls == ["kernel"]
        calls.clear()
        q8 = rng.standard_normal(8).astype(np.float32)
        B.batch_knn(q8, self._vb(rng, n=16, d=8), 2)
        assert calls == []          # width 8 has no kernel chunk: XLA

    def test_prune_and_fused_ndim_dispatch_parity(self, rng, monkeypatch):
        from innr_tpu import batch as B
        from innr_tpu import config

        _force_kernel_route(monkeypatch)
        vb = self._vb(rng)
        q1 = rng.standard_normal(16).astype(np.float32)
        q2 = rng.standard_normal((3, 16)).astype(np.float32)
        for fn in (B.batch_knn, B.batch_knn_dot, B.batch_knn_cosine):
            for prune in (False, True):
                r1 = fn(q1, vb, 4, prune=prune)
                assert r1.indices.shape == (4,), (fn.__name__, prune)
                r2 = fn(q2, vb, 4, prune=prune)
                assert r2.indices.shape == (3, 4), (fn.__name__, prune)
            # exact parity between pruned and full fused scans
            np.testing.assert_array_equal(
                fn(q1, vb, 4, prune=True).indices,
                fn(q1, vb, 4, prune=False).indices,
            )
            np.testing.assert_array_equal(
                fn(q2, vb, 4, prune=True).indices,
                fn(q2, vb, 4, prune=False).indices,
            )


class TestAdaptivePruneSemantics:
    """Kills the _knn_adaptive scale/threshold/mask mutants by pinning the
    DOCUMENTED approximate semantics on hand-built corpora: threshold =
    kth_warmup * (dim / warmup_dims); phase-1 prunes partial > kth * 1.5;
    phase-2 intersects with full <= threshold. Each case plants a row the
    correct formulas prune (result: empty) that the mutated formulas keep.
    """

    Q = np.zeros(4, dtype=np.float32)
    ROW_FAR = [1.0, 0.0, 10.0, 0.0]   # warmup partial 1.0 (the kth), full 101

    def _run(self, other_row):
        from innr_tpu.batch import VerticalBatch, batch_knn_adaptive
        vb = VerticalBatch.from_rows(
            np.array([self.ROW_FAR, other_row], dtype=np.float32)
        )
        return batch_knn_adaptive(self.Q, vb, 1, warmup_dims=2)

    def test_threshold_scale_is_dim_over_warmup(self):
        # full = 2.25 > threshold = 1.0 * (4/2) = 2.0 -> phase-2 pruned.
        # scale mutants (dim*warmup, kth+scale) keep it.
        r = self._run([1.0, 0.5, 1.0, 0.0])
        assert r.indices.shape == (0,)

    def test_phase1_margin_is_multiplicative_1p5(self):
        # partial 1.64 > kth*1.5 = 1.5 -> phase-1 pruned (full 1.89 would
        # pass phase 2); the additive-margin mutant (threshold + 1.5,
        # i.e. partial*scale > 3.5) keeps it.
        r = self._run([1.0, 0.8, 0.5, 0.0])
        assert r.indices.shape == (0,)

    def test_phase2_intersects_phase1(self):
        # partial 1.94: phase-1 pruned; full 1.94 <= threshold 2.0 passes
        # phase 2 -> the union (|) mutant resurrects it.
        r = self._run([1.3, 0.5, 0.0, 0.0])
        assert r.indices.shape == (0,)

    def test_phase1_scale_is_multiplicative_on_partial(self):
        # kth partial = 2.0 (not 1.0), so the additive mutant
        # `partial + scale > threshold*1.5` (keep iff partial <= 4)
        # diverges from the correct `partial*scale` gate (prune iff
        # partial > 1.5*kth = 3): partial 3.46 is correctly ph1-pruned,
        # full 3.95 <= threshold 4 would pass ph2, so the mutant
        # resurrects it.
        from innr_tpu.batch import VerticalBatch, batch_knn_adaptive
        vb = VerticalBatch.from_rows(np.array(
            [[1.0, 1.0, 10.0, 0.0],   # partial 2.0 (the kth), full 102
             [1.5, 1.1, 0.7, 0.0]],   # partial 3.46, full 3.95
            dtype=np.float32))
        r = batch_knn_adaptive(self.Q, vb, 1, warmup_dims=2)
        assert r.indices.shape == (0,)

    def test_default_dispatch_honors_adaptive_on_small_corpus(self):
        # On a small corpus the adaptive path must run even with
        # force_adaptive=False (the and->or gate mutant reroutes to the
        # exact fused scan, which returns the row adaptive prunes).
        r = self._run([1.0, 0.5, 1.0, 0.0])
        assert r.indices.shape == (0,)


class TestL2PruningThresholdBoundary:
    """Kills batch_l2_squared_pruning's Gt->GtE boundary mutant: distance
    exactly == threshold is KEPT (reference prunes strictly-greater
    accumulations, src/batch.rs:320)."""

    def test_exact_threshold_distance_is_kept(self):
        from innr_tpu.batch import VerticalBatch, batch_l2_squared_pruning
        vb = VerticalBatch.from_rows(
            np.array([[1.0, 1.0], [3.0, 3.0]], dtype=np.float32)
        )
        idx, d = batch_l2_squared_pruning(
            np.zeros(2, dtype=np.float32), vb, 2.0
        )
        assert list(idx) == [0] and float(d[0]) == 2.0


class TestCosineEpsilonBoundary:
    """Kills batch_cosine's Gt->GtE epsilon-gate mutants: a norm EXACTLY
    == NORM_EPSILON is still 'effectively zero' (strict >), so cosine is
    0.0. f32 sqrt((1e-9)^2) == 1e-9 exactly, making the boundary
    constructible."""

    def test_query_norm_exactly_epsilon(self, rng):
        from innr_tpu.batch import VerticalBatch, batch_cosine
        from innr_tpu.config import NORM_EPSILON
        vb = VerticalBatch.from_rows(
            rng.standard_normal((4, 2)).astype(np.float32)
        )
        q = np.array([NORM_EPSILON, 0.0], dtype=np.float32)
        np.testing.assert_array_equal(
            np.asarray(batch_cosine(q, vb)), np.zeros(4, dtype=np.float32)
        )

    def test_row_norm_exactly_epsilon(self, rng):
        from innr_tpu.batch import VerticalBatch, batch_cosine
        from innr_tpu.config import NORM_EPSILON
        rows = rng.standard_normal((4, 2)).astype(np.float32)
        rows[2] = [NORM_EPSILON, 0.0]
        vb = VerticalBatch.from_rows(rows)
        q = np.ones(2, dtype=np.float32)
        out = np.asarray(batch_cosine(q, vb))
        assert out[2] == 0.0 and np.all(out[[0, 1, 3]] != 0.0)


class TestVarianceOrderDescending:
    """Kills the reordered-scan key-flip (Invert-drop) mutant: the scan
    permutation must put HIGH-variance dimensions first (reference
    src/batch.rs:610 'high-variance dims first')."""

    def test_variance_order_is_descending(self):
        from innr_tpu.batch import VerticalBatch, _variance_order
        rows = np.zeros((8, 3), dtype=np.float32)
        rows[:, 0] = np.linspace(0, 1, 8)      # small variance
        rows[:, 1] = np.linspace(0, 100, 8)    # large variance
        rows[:, 2] = np.linspace(0, 10, 8)     # medium variance
        order = list(np.asarray(_variance_order(VerticalBatch.from_rows(rows))))
        assert order == [1, 2, 0]


class TestFromRowsNdarrayValidation:
    """Kills the from_rows isinstance/ndim gate mutant: a non-2-D ndarray
    is a contract violation (ContractError), never treated as a sequence
    of scalars."""

    def test_1d_ndarray_raises_contract_error(self):
        from innr_tpu.batch import VerticalBatch
        from innr_tpu.utils.asserts import ContractError
        with pytest.raises(ContractError):
            VerticalBatch.from_rows(np.zeros(5, dtype=np.float32))

    def test_3d_ndarray_raises_contract_error(self):
        from innr_tpu.batch import VerticalBatch
        from innr_tpu.utils.asserts import ContractError
        with pytest.raises(ContractError):
            VerticalBatch.from_rows(np.zeros((2, 3, 4), dtype=np.float32))


class TestSegmentedPolicyContracts:
    """Kills segmented.py exhaustive-sweep survivors: the id-space
    exhaustion boundary (>= 2**31, all four mutants on that line), the
    strictly-greater compaction trigger, and the power-of-two over-fetch
    policy (extracted as _overfetch_k so the rounding is pinnable)."""

    def test_id_space_exhaustion_boundary(self, rng):
        from innr_tpu.segmented import SegmentedCorpus
        from innr_tpu.utils.asserts import ContractError

        rows = rng.standard_normal((2, 4)).astype(np.float32)
        sc = SegmentedCorpus(4)
        sc._next_id = 2**31 - 3  # the last add that still fits
        lo, hi = sc.add(rows)
        assert (lo, hi) == (2**31 - 3, 2**31 - 1)
        sc2 = SegmentedCorpus(4)
        sc2._next_id = 2**31 - 2  # next_id + n == 2**31: exhausted
        with pytest.raises(ContractError, match="exhausted"):
            sc2.add(rows)

    def test_compaction_trigger_is_strictly_greater(self, rng):
        from innr_tpu.segmented import SegmentedCorpus

        sc = SegmentedCorpus(4, max_segments=4)
        for _ in range(4):
            sc.add(rng.standard_normal((1, 4)).astype(np.float32))
        assert sc.num_segments == 4  # == max_segments: no compaction
        sc.add(rng.standard_normal((1, 4)).astype(np.float32))
        assert sc.num_segments == 1  # > max_segments: folded

    def test_overfetch_k_policy(self):
        from innr_tpu.segmented import _overfetch_k

        assert _overfetch_k(5, 100) == 8    # pow2 ceil
        assert _overfetch_k(8, 100) == 8    # exact pow2 stays (not 16)
        assert _overfetch_k(9, 100) == 16
        assert _overfetch_k(1, 100) == 2    # floor of the rounding
        assert _overfetch_k(50, 20) == 20   # capped at segment size


class TestTwoStagePolicyContracts:
    """Kills pipeline.py exhaustive-sweep survivors: documented config
    defaults, the rerank_factor >= 1 boundary, the u8 quantile dispatch,
    the matryoshka fused-gate boundary (single + batch), query-shape
    validation arms, and the recall_vs_exact averaging formula (pinned
    at a deterministically half-recalled corpus so /, &, and the query
    average all have non-fixed-point values)."""

    ROWS = np.array([
        [2.0, 2.0, 2.0, 2.0],      # A: dot 8, bits 1111
        [-0.5, -0.5, -0.5, 8.0],   # B: dot 6.5, bits 0001 (coarse-missed)
        [1.0, 1.0, 1.0, 1.0],      # C: dot 4, bits 1111
        [-1.0, -1.0, -1.0, -1.0],  # D: dot -4, bits 0000
    ], dtype=np.float32)
    Q = np.ones(4, dtype=np.float32)

    def test_coarse_config_documented_defaults(self):
        from innr_tpu.pipeline import CoarseConfig
        c = CoarseConfig()
        assert (c.kind, c.threshold, c.prefix_dims, c.quantile) == (
            "binary", 0.0, 128, 1.0
        )

    def test_rerank_factor_one_is_legal_zero_is_not(self):
        from innr_tpu.pipeline import TwoStageIndex
        from innr_tpu.utils.asserts import ContractError
        ix = TwoStageIndex(self.ROWS, "binary", rerank_factor=1)
        assert ix.rerank_factor == 1
        with pytest.raises(ContractError):
            TwoStageIndex(self.ROWS, "binary", rerank_factor=0)

    def test_u8_quantile_dispatch(self, monkeypatch):
        from innr_tpu.ops import scalar as _scalar
        from innr_tpu.pipeline import CoarseConfig, TwoStageIndex
        calls = []
        real_fit = _scalar.QuantizationParams.fit.__func__
        real_fq = _scalar.QuantizationParams.fit_quantile.__func__
        monkeypatch.setattr(
            _scalar.QuantizationParams, "fit",
            classmethod(lambda cls, *a, **kw: calls.append("fit")
                        or real_fit(cls, *a, **kw)),
        )
        monkeypatch.setattr(
            _scalar.QuantizationParams, "fit_quantile",
            classmethod(lambda cls, *a, **kw: calls.append("fq")
                        or real_fq(cls, *a, **kw)),
        )
        TwoStageIndex(self.ROWS, CoarseConfig(kind="u8", quantile=1.0))
        assert calls == ["fit"]  # 1.0 is the documented min/max fit
        calls.clear()
        TwoStageIndex(self.ROWS, CoarseConfig(kind="u8", quantile=0.99))
        assert calls == ["fq"]

    def test_matryoshka_fused_gate_boundary(self, rng, monkeypatch):
        from innr_tpu import config, route
        from innr_tpu.pipeline import CoarseConfig, TwoStageIndex

        # The route's size boundary is inclusive.
        m = route.TRITON_MIN_ROWS
        assert route.route("dense", "gpu", m, 8, jnp.float32, 2, 16) == "triton"
        assert route.route("dense", "gpu", m - 1, 8, jnp.float32, 2, 16) == "xla"
        _force_kernel_route(monkeypatch)
        calls = []
        real = triton_knn.knn_keys
        monkeypatch.setattr(triton_knn, "knn_keys",
                            lambda *a, **k: calls.append("b") or real(*a, **k))
        cfg = CoarseConfig(kind="matryoshka", prefix_dims=16)
        q = rng.standard_normal(32).astype(np.float32)
        q2 = np.stack([q, q])
        big = TwoStageIndex(rng.standard_normal((40, 32)).astype(np.float32), cfg)
        r1 = big.search(q, 2)
        rb = big.search_batch(q2, 2)
        # search() routes through the batch scan (Q=1): one kernel each.
        assert calls == ["b", "b"]
        np.testing.assert_array_equal(rb.indices[0], r1.indices)

        calls.clear()
        config.force_reference(True)
        try:
            big.search(q, 2)
            big.search_batch(q2, 2)
        finally:
            config.force_reference(False)
        assert calls == []            # force_reference wins

    def test_query_shape_validation_arms(self):
        from innr_tpu.pipeline import TwoStageIndex
        from innr_tpu.utils.asserts import ContractError
        ix = TwoStageIndex(self.ROWS, "binary")
        # 2-D query whose FIRST axis happens to equal the dimension: the
        # Or->And mutant would accept it and fail DEEPER (in the encode)
        # — the contract must come from search itself.
        with pytest.raises(ContractError, match="TwoStageIndex.search"):
            ix.search(np.ones((4, 3), np.float32), 2)
        # 1-D query to search_batch: the And mutant IndexErrors on
        # shape[1] instead of raising the contract.
        with pytest.raises(ContractError, match="search_batch"):
            ix.search_batch(self.Q, 2)

    def test_k0_and_empty_never_reach_the_coarse_stage(self, monkeypatch):
        from innr_tpu.pipeline import TwoStageIndex
        ix = TwoStageIndex(self.ROWS, "binary")
        ix0 = TwoStageIndex(np.zeros((0, 4), np.float32), "binary")

        def boom(*a, **kw):  # pragma: no cover - mutant-only path
            raise AssertionError("coarse stage must not run for k=0/empty")

        monkeypatch.setattr(TwoStageIndex, "_search_fused", boom)
        assert ix.search(self.Q, 0).indices.shape == (0,)
        assert ix.search_batch(np.stack([self.Q] * 2), 0).indices.shape == (2, 0)
        assert ix0.search(self.Q, 3).indices.shape == (0,)
        assert ix0.search_batch(np.stack([self.Q]), 3).indices.shape == (1, 0)
        assert ix.search_batch(np.zeros((0, 4), np.float32), 5).indices.shape == (0, 0)

    def test_recall_vs_exact_is_mean_intersection_fraction(self):
        from innr_tpu.pipeline import TwoStageIndex
        ix = TwoStageIndex(self.ROWS, "binary", rerank_factor=1)
        r = ix.search(self.Q, 2)
        assert list(np.asarray(r.indices)) == [0, 2]  # coarse misses B
        assert ix.recall_vs_exact(np.stack([self.Q] * 2), 2) == 0.5


class TestMicroBatcherPolicyContracts:
    """Kills serving.py exhaustive-sweep survivors: ctor boundaries, the
    ms->s window conversion, stats accounting (mean and histogram), the
    full-window immediate flush, the partial-window coalesce deadline,
    the callable-arity sniff (required-positional params only), and
    close() draining in-flight work."""

    @staticmethod
    def _rows(d=8, n=32):
        rng = np.random.default_rng(3)
        rows = rng.standard_normal((n, d)).astype(np.float32)
        return rows / np.linalg.norm(rows, axis=1, keepdims=True)

    @staticmethod
    def _backend(rows, k=3):
        def scan(qs):
            scores = qs @ rows.T
            idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
            return np.take_along_axis(scores, idx, axis=1), idx
        return scan

    def test_ctor_boundaries_and_window_conversion(self):
        from innr_tpu.serving import MicroBatcher
        from innr_tpu.utils.asserts import ContractError
        rows = self._rows()
        with MicroBatcher(self._backend(rows), k=1, max_batch=1,
                          max_wait_ms=2.0) as mb:
            assert mb.max_wait_s == 0.002  # ms -> s, positive
        for bad in ({"k": 0}, {"max_batch": 0}):
            with pytest.raises(ContractError):
                MicroBatcher(self._backend(rows), k=bad.get("k", 3),
                             max_batch=bad.get("max_batch", 32))

    def test_stats_mean_and_histogram(self):
        from innr_tpu.serving import MicroBatcher
        rows = self._rows()
        with MicroBatcher(self._backend(rows), k=3, max_batch=1) as mb:
            for i in range(3):
                mb.search(rows[i])
            assert mb.stats.requests == 3
            assert mb.stats.launches == 3      # max_batch=1: no coalescing
            assert mb.stats.mean_batch == 1.0  # requests / launches
            assert mb.stats.batch_histogram == {1: 3}

    def test_full_window_flushes_without_waiting(self):
        from innr_tpu.serving import MicroBatcher
        rows = self._rows()
        # The window deadline is far (8s); 4 requests == max_batch must
        # flush IMMEDIATELY (>= trigger). The Gt mutant waits out the
        # deadline instead.
        t0 = time.monotonic()
        with MicroBatcher(self._backend(rows), k=3, max_batch=4,
                          max_wait_ms=8000.0) as mb:
            threads = [threading.Thread(target=mb.search, args=(rows[i],))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=6.0)
            assert all(not t.is_alive() for t in threads)
        assert time.monotonic() - t0 < 6.0

    def test_partial_window_coalesces_until_deadline(self):
        from innr_tpu.serving import MicroBatcher
        rows = self._rows()
        # 4 staggered requests inside one 700ms window must ride ONE
        # launch; the deadline-sign mutant (oldest - max_wait) flushes
        # each arrival immediately.
        with MicroBatcher(self._backend(rows), k=3, max_batch=32,
                          max_wait_ms=700.0) as mb:
            threads = []
            for i in range(4):
                t = threading.Thread(target=mb.search, args=(rows[i],))
                t.start()
                threads.append(t)
                time.sleep(0.03)
            for t in threads:
                t.join(timeout=6.0)
            assert all(not t.is_alive() for t in threads)
            assert mb.stats.launches == 1
            assert mb.stats.mean_batch == 4.0

    def test_callable_arity_counts_required_positionals_only(self):
        from innr_tpu.serving import MicroBatcher
        rows = self._rows()
        calls = []

        def backend_with_default(qs, k=7):
            calls.append(k)
            scores = qs @ rows.T
            idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
            return np.take_along_axis(scores, idx, axis=1), idx

        # one REQUIRED positional -> f(queries)-style: the backend's own
        # default k (7) decides the width, not the batcher's k=3.
        with MicroBatcher(backend_with_default, k=3) as mb:
            vals, idx = mb.search(rows[0])
        assert calls == [7]
        assert idx.shape == (7,)

    def test_close_waits_for_inflight_work(self):
        from innr_tpu.serving import MicroBatcher
        rows = self._rows()
        base = self._backend(rows)

        def slow(qs):
            time.sleep(1.0)
            return base(qs)

        mb = MicroBatcher(slow, k=3, max_batch=1)
        done = []
        t = threading.Thread(
            target=lambda: done.append(mb.search(rows[0], timeout=10.0)))
        t.start()
        time.sleep(0.25)  # let it enqueue and enter the slow scan
        mb.close()        # must join the collector (finite POSITIVE timeout)
        t.join(timeout=0.2)
        assert not t.is_alive() and len(done) == 1


class TestLocalScanPaddingContracts:
    """Kills parallel/_scan.py exhaustive-sweep survivors: the strict
    `gidx < n_total` padding masks in all four scan arms (fused/jnp x
    plain/filtered) — pinned with padding rows equal to the query, i.e.
    rows that WIN unless masked — and the select-form inverse key
    transform (involution over the hostile value set)."""

    K = 3
    N_PAD = 2  # rows 6,7 are padding; callers over-fetch k + pad_count
    # (sharded.py:19-22), so the scan is asked for K + N_PAD candidates

    def _setup(self):
        rng = np.random.default_rng(11)
        qs = rng.standard_normal((2, 4)).astype(np.float32)
        rows = rng.standard_normal((8, 4)).astype(np.float32) * 3.0
        rows[6] = qs[0]  # padding rows: distance 0 to a query -> they
        rows[7] = qs[1]  # WIN the scan unless the mask pins them dead
        n_total = 6
        d = np.sum((rows[None, :6] - qs[:, None]) ** 2, axis=2)
        want = np.argsort(d, axis=1, kind="stable")[:, :self.K]
        return qs, rows, n_total, want

    def _check(self, keys, gidx, n_total, want):
        keys = np.asarray(keys)
        gidx = np.asarray(gidx)
        int_min = np.iinfo(np.int32).min
        live = keys != int_min
        assert np.all(gidx[live] < n_total), "padding row surfaced live"
        for qi in range(gidx.shape[0]):
            # over-fetched live candidates, best key first: the top K
            # must be exactly the brute-force winners over REAL rows
            order = np.argsort(-keys[qi][live[qi]], kind="stable")
            top = gidx[qi][live[qi]][order][: self.K]
            assert sorted(top) == sorted(want[qi]), qi

    @pytest.mark.parametrize("use_fused", [False, True])
    def test_plain_l2_masks_padding(self, use_fused, monkeypatch):
        # use_fused: the Triton route (interpret mode; features zero-padded
        # to its 16-wide chunks, which changes no distance).
        import jax.numpy as jnp
        from innr_tpu.parallel._scan import local_scan_keys
        qs, rows, n_total, want = self._setup()
        route = "xla"
        if use_fused:
            _force_kernel_route(monkeypatch)
            qs, rows, route = np.asarray(_pad16(qs)), np.asarray(_pad16(rows)), "triton"
        aux = jnp.sum(jnp.asarray(rows) ** 2, axis=1)
        keys, gidx = local_scan_keys(
            jnp.asarray(qs), jnp.asarray(rows), aux, n_total,
            self.K + self.N_PAD, "l2", 0, route=route,
        )
        self._check(keys, gidx, n_total, want)

    @pytest.mark.parametrize("use_fused", [False, True])
    def test_filtered_l2_masks_padding(self, use_fused, monkeypatch):
        # use_fused: the Triton route (interpret mode; features zero-padded
        # to its 16-wide chunks, which changes no distance).
        import jax.numpy as jnp
        from innr_tpu.parallel._scan import local_scan_keys_filtered
        qs, rows, n_total, want = self._setup()
        route = "xla"
        if use_fused:
            _force_kernel_route(monkeypatch)
            qs, rows, route = np.asarray(_pad16(qs)), np.asarray(_pad16(rows)), "triton"
        aux = jnp.sum(jnp.asarray(rows) ** 2, axis=1)
        mask = jnp.ones((8,), jnp.float32)
        keys, gidx = local_scan_keys_filtered(
            jnp.asarray(qs), jnp.asarray(rows), aux, mask, n_total,
            self.K + self.N_PAD, 0, route=route,
        )
        self._check(keys, gidx, n_total, want)

    def test_invert_total_key_is_exact_inverse(self):
        _invert_total_key = scan.invert_total_key
        from innr_tpu.utils.order import total_order_key_f32
        vals = np.array(
            [0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, np.nan, -np.nan,
             np.float32(1e-45), -np.float32(1e-45)], dtype=np.float32)
        back = np.asarray(_invert_total_key(total_order_key_f32(vals)))
        np.testing.assert_array_equal(
            back.view(np.int32), vals.view(np.int32))  # bit-exact, NaN incl.


class TestShardedDispatchContracts:
    """Kills parallel/sharded.py exhaustive-sweep survivors: the
    _plan_local_k policy (pad over-fetch, fused-gate boundary,
    force_reference arm, shard clamp), the prune-flag gate, the pruned
    planner's mode/normalized/n_q/fast wiring (spied at trace time on
    uniquely-shaped corpora so the jit cache cannot absorb the call),
    the strict pruned padding mask, and from_row_source never issuing
    empty-range fetches."""

    @staticmethod
    def _clustered(rng, n, d, offset=0.0):
        centers = 5.0 * rng.standard_normal((16, d)).astype(np.float32)
        assign = np.sort(rng.integers(0, 16, n))
        rows = centers[assign] + 0.05 * rng.standard_normal((n, d))
        return (rows + offset).astype(np.float32)

    def test_plan_local_k_policy(self, rng, monkeypatch):
        from innr_tpu import config
        from innr_tpu.parallel.sharded import ShardedCorpus, _plan_local_k, _route

        _force_kernel_route(monkeypatch)
        sc = ShardedCorpus(rng.standard_normal((63, 16)).astype(np.float32))
        assert (sc.n_pad, sc.shard_rows) == (64, 8)
        # over-fetch by the pad count (63 -> 64 pads 1 row)
        assert _plan_local_k(sc, 2) == 3
        # clamp at the shard height
        assert _plan_local_k(sc, 100) == 8
        q = jnp.zeros((16,), jnp.float32)
        assert _route(q, sc, 3) == "triton"
        # force_reference beats an eligible shard
        config.force_reference(True)
        try:
            assert _route(q, sc, 3) == "xla"
        finally:
            config.force_reference(False)
        # negative k is gated out BEFORE any planning (k <= 0, not ==0)
        v, i = sc.knn_l2(np.zeros(16, np.float32), -5)
        assert v.shape == (0,) and i.shape == (0,)

    def test_prune_false_never_plans(self, rng, monkeypatch):
        import innr_tpu.parallel.sharded as sh

        _force_kernel_route(monkeypatch)
        planned = []
        real = sh._sharded_knn_pruned
        monkeypatch.setattr(
            sh, "_sharded_knn_pruned",
            lambda *a, **kw: planned.append(1) or real(*a, **kw))
        sc = sh.ShardedCorpus(self._clustered(rng, 2048, 32))
        q = rng.standard_normal(32).astype(np.float32)
        sc.knn_dot(q, 4, prune=False)
        assert planned == []          # prune=False: no summaries, no plan
        sc.knn_dot(q, 4, prune=True)
        assert planned == [1]

    def test_pruned_plan_wiring(self, rng, monkeypatch):
        """plan mode (l2 stays l2, cosine plans as dot) and tile summary
        normalization reach the per-shard planner."""
        from innr_tpu import prune as prune_mod
        import innr_tpu.parallel.sharded as sh

        _force_kernel_route(monkeypatch)
        modes, norms = [], []
        real_plan = prune_mod.plan_survivors
        monkeypatch.setattr(
            prune_mod, "plan_survivors",
            lambda qs, c, r, n, k, mode, fast=False: modes.append(mode)
            or real_plan(qs, c, r, n, k, mode, fast=fast))
        real_ts = sh.ShardedCorpus.tile_summary
        monkeypatch.setattr(
            sh.ShardedCorpus, "tile_summary",
            lambda self, normalized=False: norms.append(normalized)
            or real_ts(self, normalized=normalized))

        sc = sh.ShardedCorpus(self._clustered(rng, 2048, 48))
        sc.knn_l2(rng.standard_normal(48).astype(np.float32), 3, prune=True)
        assert modes == ["l2"] and norms == [False]

        modes.clear(); norms.clear()
        sc2 = sh.ShardedCorpus(self._clustered(rng, 2048, 64))
        sc2.knn_cosine(
            rng.standard_normal((3, 64)).astype(np.float32), 3, prune=True)
        assert modes == ["dot"]       # cosine bounds plan in dot space
        assert norms == [True]        # over NORMALIZED summaries

    def test_single_pass_boundary_takes_pruned_path(self, rng, monkeypatch):
        """k_local == the kernel's k cap is prune-ELIGIBLE (<=); one past
        it takes the XLA full scan, with the same exact result."""
        import innr_tpu.parallel.sharded as sh

        _force_kernel_route(monkeypatch)
        sc = sh.ShardedCorpus(self._clustered(rng, 4096, 48))
        assert sc.n_pad == sc.n_true  # no pads: k_local == k exactly
        k = triton_knn.K_MAX
        planned = []
        real = sh._sharded_knn_pruned
        monkeypatch.setattr(
            sh, "_sharded_knn_pruned",
            lambda *a, **kw: planned.append(1) or real(*a, **kw))
        q = rng.standard_normal(48).astype(np.float32)
        v1, i1 = sc.knn_l2(q, k, prune=True)
        assert planned == [1], "k_local == K_MAX must stay eligible"
        v2, i2 = sc.knn_l2(q, k + 1, prune=True)
        assert planned == [1], "k_local > K_MAX must take the full scan"
        np.testing.assert_array_equal(np.asarray(i2)[:k], np.asarray(i1))

    def test_pruned_padding_mask_is_strict(self, rng, monkeypatch):
        """Pad rows are ZEROS; with a tiny query they out-score every
        (far-offset) real row, so admitting gidx == n_total would put a
        phantom index in the results."""
        from innr_tpu import config
        import innr_tpu.parallel.sharded as sh

        _force_kernel_route(monkeypatch)
        rows = self._clustered(rng, 3997, 16, offset=20.0)  # pads to 4000
        sc = sh.ShardedCorpus(rows)
        assert sc.n_pad - sc.n_true == 3
        q = (0.01 * rng.standard_normal(16)).astype(np.float32)
        vals, idx = sc.knn_l2(q, 5, prune=True)
        idx = np.asarray(idx)
        assert np.all(idx < sc.n_true), "zero pad row surfaced"
        d = np.sum((rows - q) ** 2, axis=1)
        np.testing.assert_array_equal(
            idx, np.argsort(d, kind="stable")[:5])

    def test_from_row_source_never_fetches_empty_ranges(self, rng):
        from innr_tpu.parallel.sharded import ShardedCorpus

        rows = rng.standard_normal((4, 8)).astype(np.float32)
        calls = []

        def get_rows(start, stop):
            calls.append((start, stop))
            return rows[start:stop]

        # 4 true rows over 8 devices: shards 4..7 are pure padding, and
        # shard 4 starts EXACTLY at n_true — the > boundary.
        sc = ShardedCorpus.from_row_source(get_rows, 4, 8)
        assert all(stop > start for start, stop in calls), calls
        q = rng.standard_normal(8).astype(np.float32)
        v, i = sc.knn_l2(q, 2)
        d = np.sum((rows - q) ** 2, axis=1)
        np.testing.assert_array_equal(
            np.asarray(i), np.argsort(d, kind="stable")[:2])


class TestHierarchicalDispatchContracts:
    """Kills parallel/hierarchical.py exhaustive-sweep survivors: the
    auto per_slice factorization, the shard_rows property, the l2 aux
    (norms^2) actually feeding the fused arm, query validation arms, the
    k<=0 / 2-D empty shapes, and the k_local/use_fused planning wired
    into _hier_knn (spied with passthrough)."""

    @staticmethod
    def _corpus(rng, n, d):
        return rng.standard_normal((n, d)).astype(np.float32)

    def test_mesh_auto_per_slice(self):
        from innr_tpu.parallel.hierarchical import hierarchical_mesh
        from innr_tpu.utils.asserts import ContractError
        m = hierarchical_mesh(2)  # 8 virtual devices -> (2, 4)
        assert m.devices.shape == (2, 4)
        with pytest.raises(ContractError):
            hierarchical_mesh(3)  # 8 % 3 != 0

    def test_shard_rows_property(self, rng):
        from innr_tpu.parallel.hierarchical import HierarchicalCorpus
        hc = HierarchicalCorpus(self._corpus(rng, 63, 8), n_slices=2)
        assert hc.n_pad == 64 and hc.shard_rows == 8  # n_pad / 8 devices

    def test_query_validation_arms(self, rng):
        from innr_tpu.parallel.hierarchical import HierarchicalCorpus
        from innr_tpu.utils.asserts import ContractError
        hc = HierarchicalCorpus(self._corpus(rng, 64, 4), n_slices=2)
        with pytest.raises(ContractError):    # 2-D, wrong last dim
            hc.knn_dot(np.ones((4, 3), np.float32), 2)
        with pytest.raises(ContractError):    # 1-D, wrong dim
            hc.knn_dot(np.ones(5, np.float32), 2)
        with pytest.raises(ContractError):    # 3-D never legal
            hc.knn_dot(np.ones((2, 2, 4), np.float32), 2)

    def test_k0_negative_and_empty_shapes(self, rng):
        from innr_tpu.parallel.hierarchical import HierarchicalCorpus
        hc = HierarchicalCorpus(self._corpus(rng, 64, 4), n_slices=2)
        q1 = np.ones(4, np.float32)
        q2 = np.ones((3, 4), np.float32)
        for k in (0, -5):
            v, i = hc.knn_dot(q1, k)
            assert v.shape == (0,) and i.shape == (0,)
            v, i = hc.knn_dot(q2, k)      # 2-D keeps its query axis
            assert v.shape == (3, 0) and i.shape == (3, 0)

    def test_planning_wired_into_hier_knn(self, rng, monkeypatch):
        from innr_tpu import config
        import innr_tpu.parallel.hierarchical as hier

        _force_kernel_route(monkeypatch)
        seen = []
        real = hier._hier_knn
        monkeypatch.setattr(
            hier, "_hier_knn",
            lambda q, rows, aux, k, k_local, mode, n_total, mesh, route,
            shard_rows: seen.append((k, k_local, route, shard_rows))
            or real(q, rows, aux, k, k_local, mode, n_total, mesh, route,
                    shard_rows))
        hc = hier.HierarchicalCorpus(self._corpus(rng, 63, 16), n_slices=2)
        q = rng.standard_normal(16).astype(np.float32)
        hc.knn_dot(q, 2)
        # pad = 64 - 63 = 1 -> k_local = k + 1; shard_rows = 8
        assert seen == [(2, 3, "triton", 8)]
        seen.clear()
        config.force_reference(True)
        try:
            hc.knn_dot(q, 2)
        finally:
            config.force_reference(False)
        assert seen == [(2, 3, "xla", 8)]    # reference wins the route

    def test_fused_l2_uses_real_norms(self, rng, monkeypatch):
        """The l2 aux is sum(r*r); feeding the fused kernel anything else
        must break parity with brute force."""
        from innr_tpu import config
        import innr_tpu.parallel.hierarchical as hier

        _force_kernel_route(monkeypatch)
        rows = self._corpus(rng, 128, 16)
        hc = hier.HierarchicalCorpus(rows, n_slices=2)
        q = rng.standard_normal(16).astype(np.float32)
        v, i = hc.knn_l2(q, 5)
        d = np.sum((rows - q) ** 2, axis=1)
        np.testing.assert_array_equal(
            np.asarray(i), np.argsort(d, kind="stable")[:5])


class TestKnnExhaustiveSweep:
    """Killers for the kernels/knn.py exhaustive-sweep survivors (round 4).

    The masked-l2 batch entry (fused_knn_l2_masked_batch) returned
    distances were never value-checked: ``qq = sum(qs * qs)`` and the
    ``vals + qq`` re-add are per-query constants, invisible to index-only
    assertions. Pin the VALUES against the elementwise numpy oracle.
    """

    def test_masked_l2_values_match_oracle(self, rng):
        kknn = _kknn

        n, d, k = 300, 12, 6
        rows = rng.standard_normal((n, d)).astype(np.float32)
        qs = rng.standard_normal((3, d)).astype(np.float32)
        mask = np.ones(n, dtype=bool)
        mask[::7] = False
        vals, idx = kknn.fused_knn_l2_masked_batch(
            jnp.asarray(qs), jnp.asarray(rows), jnp.asarray(mask), k
        )
        d2 = ((qs[:, None, :] - rows[None, :, :]) ** 2).sum(-1)
        d2[:, ~mask] = np.inf
        want_idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
        np.testing.assert_array_equal(np.asarray(idx), want_idx)
        np.testing.assert_allclose(
            np.asarray(vals),
            np.take_along_axis(d2, want_idx, axis=1),
            rtol=1e-5, atol=1e-5,
        )


class TestBinaryExhaustiveSweep:
    """Killers for the ops/binary.py exhaustive-sweep survivors (round 4)."""

    def test_get_boundary_indices_return_false(self):
        """get(dimension) and get(-1) must be False even when the clamped
        / wrapped word read would hit a set bit (JAX indexing clamps OOB
        and wraps negatives — the guard is the only protection)."""
        from innr_tpu.ops.binary import encode_binary

        v = np.zeros(32, np.float32)
        v[0] = 1.0
        v[31] = 1.0
        p = encode_binary(v, 0.0)
        assert p.get(0) is True and p.get(31) is True
        assert p.get(32) is False           # == dimension (clamp would say True)
        assert p.get(-1) is False           # negative (wrap would say True)
        assert p.get(1_000_000) is False

    def test_data_u64_length_is_word_pairs(self):
        """data_u64 packs ceil(words / 2) u64s — no over-padding."""
        from innr_tpu.ops.binary import PackedBinary

        for nw, want in ((1, 1), (2, 1), (3, 2), (5, 3)):
            pb = PackedBinary(np.arange(1, nw + 1, dtype=np.uint32), nw * 32)
            u64 = pb.data_u64()
            assert u64.shape == (want,), (nw, u64.shape)
            # Low word of the first u64 is word 0 (little-endian).
            assert int(u64[0] & 0xFFFFFFFF) == 1

    def test_batch_encoders_use_strict_threshold(self):
        """Values EQUAL to the threshold encode to 0 in both batch
        encoders (reference: strictly > threshold, src/binary.rs:133)."""
        from innr_tpu.ops.binary import PackedBinaryBatch, encode_binary_batch

        rows = np.array([[0.5, 0.0, -0.5]], np.float32)
        words = encode_binary_batch(rows, 0.0)
        assert int(words[0, 0]) == 1        # only the strictly-greater bit
        pb = PackedBinaryBatch.encode(rows, 0.0)
        assert int(pb.words[0, 0]) == 1


class TestTernaryExhaustiveSweep:
    """Killers for the ops/ternary.py exhaustive-sweep survivors (round 4)."""

    def test_get_boundary_indices_return_zero(self):
        """get(dimension) and get(-1) must be 0 even when the clamped /
        wrapped word read would hit a set bit (same JAX indexing hazard
        as PackedBinary.get — the guard is the only protection)."""
        from innr_tpu.ops.ternary import encode_ternary

        v = np.zeros(32, np.float32)
        v[0] = 1.0      # pos bit 0 of the (only) word
        v[31] = 1.0     # pos bit 31 of the last word
        t = encode_ternary(v, 0.5)
        assert t.get(0) == 1 and t.get(31) == 1
        assert t.get(32) == 0        # == dimension (clamp would say 1)
        assert t.get(-1) == 0        # negative (wrap would say 1)
        assert t.get(10_000) == 0

    def test_batch_ctor_rejects_each_violation_alone(self):
        """PackedTernaryBatch's validation is a disjunction: any single
        violation must raise, not only all-at-once."""
        import innr_tpu as it
        from innr_tpu.ops.ternary import PackedTernaryBatch

        ok = np.zeros((3, 1), np.uint32)
        PackedTernaryBatch(ok, ok, 32)  # sane baseline
        with pytest.raises(it.ContractError):      # wrong rank only
            PackedTernaryBatch(np.zeros((1,), np.uint32),
                               np.zeros((1,), np.uint32), 32)
        with pytest.raises(it.ContractError):      # plane mismatch only
            PackedTernaryBatch(ok, np.zeros((4, 1), np.uint32), 32)
        with pytest.raises(it.ContractError):      # word count only
            PackedTernaryBatch(ok, ok, 64)


class TestScalarExhaustiveSweep:
    """Killers for the ops/scalar.py exhaustive-sweep survivors (round 4)."""

    def test_fit_quantile_matches_reference_formula(self):
        """fit_quantile's VALUES were untested: pin them against an
        independent NumPy rendering of the reference's index formula
        (src/scalar.rs:120-136), including the finite filter and the
        two-sided tail split."""
        from innr_tpu.ops.scalar import QuantizationParams

        rng = np.random.default_rng(11)
        v = rng.standard_normal(1000).astype(np.float32) * 10
        v[3] = np.inf
        v[77] = -np.inf
        v[500] = np.nan
        for q in (0.5, 0.9, 0.98):
            got = QuantizationParams.fit_quantile(v, q)
            finite = np.sort(v[np.isfinite(v)])
            tail = (1.0 - q) / 2.0
            lo = int(np.floor(tail * finite.size))
            hi = min(int(np.ceil((1.0 - tail) * finite.size)), finite.size - 1)
            want_alpha = float(finite[hi]) - float(finite[lo])
            assert got.offset == float(finite[lo]), q
            assert abs(got.alpha - want_alpha) < 1e-6 * abs(want_alpha), q

    def test_fit_quantile_one_routes_to_fit(self):
        """quantile == 1.0 must use fit() over ALL values — the reference
        shortcut (src/scalar.rs:117-119): non-finite values PROPAGATE
        (the percentile path would filter them)."""
        from innr_tpu.ops.scalar import QuantizationParams

        v = np.array([0.0, 1.0, 2.0, np.inf], np.float32)
        got = QuantizationParams.fit_quantile(v, 1.0)
        assert np.isinf(got.alpha)          # fit propagates the inf range
        clipped = QuantizationParams.fit_quantile(v, 0.999999)
        assert np.isfinite(clipped.alpha)   # percentile path filters it

    def test_k0_and_gate_boundaries_never_touch_the_kernel(self, monkeypatch):
        """k == 0 returns empty WITHOUT dispatching; where the route takes
        the kernel it MUST dispatch to it unless force_reference wins —
        pinned with a sentinel kernel."""
        from innr_tpu import config
        from innr_tpu.ops.scalar import (
            QuantizationParams, QuantizedU8Batch, batch_knn_u8,
            batch_knn_u8_multi,
        )

        rng = np.random.default_rng(5)
        codes = QuantizedU8Batch(rng.integers(0, 255, (8, 16), dtype=np.uint8))
        params = QuantizationParams(alpha=2.0, offset=-1.0)
        q1 = rng.standard_normal(16).astype(np.float32)
        qs = rng.standard_normal((2, 16)).astype(np.float32)

        _force_kernel_route(monkeypatch)

        def boom(*a, **kw):
            raise AssertionError("u8 kernel dispatched")

        monkeypatch.setattr(triton_knn, "knn_keys", boom)
        # k == 0: empty result, sentinel must NOT fire.
        assert batch_knn_u8(q1, codes, params, 0) == []
        v, i = batch_knn_u8_multi(qs, codes, params, 0)
        assert v.shape == (2, 0) and i.shape == (2, 0)
        # the route takes the kernel: it MUST fire.
        with pytest.raises(AssertionError, match="u8 kernel"):
            batch_knn_u8(q1, codes, params, 3)
        with pytest.raises(AssertionError, match="u8 kernel"):
            batch_knn_u8_multi(qs, codes, params, 3)
        # force_reference wins over the route: sentinel must NOT fire.
        config.force_reference(True)
        try:
            out = batch_knn_u8(q1, codes, params, 3)
            assert len(out) == 3
        finally:
            config.force_reference(False)

    def test_multi_rejects_each_query_shape_violation_alone(self):
        """batch_knn_u8_multi's validation is a disjunction: a 1-D query
        (right length) and a wrong-width 2-D batch must EACH raise."""
        import innr_tpu as it
        from innr_tpu.ops.scalar import (
            QuantizationParams, QuantizedU8Batch, batch_knn_u8_multi,
        )

        rng = np.random.default_rng(6)
        codes = QuantizedU8Batch(rng.integers(0, 255, (8, 16), dtype=np.uint8))
        params = QuantizationParams(alpha=1.0, offset=0.0)
        with pytest.raises(it.ContractError):      # rank violation only
            batch_knn_u8_multi(np.ones(16, np.float32), codes, params, 2)
        with pytest.raises(it.ContractError):      # width violation only
            batch_knn_u8_multi(np.ones((2, 17), np.float32), codes, params, 2)


class TestSlotExhaustiveSweep:
    """Killers for the ops/slot.py exhaustive-sweep survivors (round 4)."""

    def test_slot_compare_counts_dtype_routing(self):
        """The u64 branch is the only protection against JAX's
        x64-disabled downcast (uint64 -> uint32 drops the hi word).
        Pin the dtype disjunction with MIXED inputs in both orders and
        hi-word-only differences — each would silently compare lo words
        on the wrong path."""
        from innr_tpu.ops.slot import SlotCounts, slot_compare_counts

        hi1lo0 = np.array([1 << 32], np.uint64)        # (hi=1, lo=0)
        zero32 = np.array([0], np.uint32)
        # a u64, b u32: hi word differs -> gt (a > b), never eq.
        assert slot_compare_counts(hi1lo0, zero32) == SlotCounts(0, 0, 1)
        # a u32, b u64: symmetric -> lt.
        assert slot_compare_counts(zero32, hi1lo0) == SlotCounts(0, 1, 0)
        # both u64, equal hi, lo decides: lt via the hi_eq & lo< arm.
        a = np.array([(1 << 32) + 5], np.uint64)
        b = np.array([(1 << 32) + 7], np.uint64)
        assert slot_compare_counts(a, b) == SlotCounts(0, 1, 0)
        assert slot_compare_counts(b, a) == SlotCounts(0, 0, 1)
        assert slot_compare_counts(a, a) == SlotCounts(1, 0, 0)
        # both u32 sanity (the else arm).
        assert slot_compare_counts(
            np.array([3, 9, 9], np.uint32), np.array([9, 9, 3], np.uint32)
        ) == SlotCounts(1, 1, 1)

    def test_sketch_knn_k0_and_cap_gate(self, monkeypatch):
        """k == 0 returns empty without scoring; any k > 0 scores on the
        XLA compare-reduce (the slot family has no kernel, so no k cap)."""
        from innr_tpu.ops.slot import SketchCorpus, slot_knn_u32

        rng = np.random.default_rng(9)
        raw = rng.integers(0, 50, (8, 16)).astype(np.uint32)
        sketches = SketchCorpus(raw)
        q = raw[3].copy()
        _force_kernel_route(monkeypatch)

        def boom(*a, **kw):
            raise AssertionError("a kernel dispatched")

        monkeypatch.setattr(triton_knn, "knn_keys", boom)
        counts, idx = slot_knn_u32(q, sketches, 0)
        assert counts.shape == (0,) and idx.shape == (0,)
        for k in (4, 5, 8):
            counts, idx = slot_knn_u32(q, sketches, k)
            assert int(np.asarray(idx)[0]) == 3 and int(np.asarray(counts)[0]) == 0
            assert len(np.asarray(idx)) == k


class TestSparseExhaustiveSweep:
    """Killers for the ops/sparse.py exhaustive-sweep survivors (round 4).

    Each test names the mutant it kills (verified by re-applying the exact
    AST mutation and watching the test fail).
    """

    def test_sparse_dot_one_sided_empty(self):
        # sparse.py:54 [boolop Or -> And]: an empty *b* alone must return
        # 0.0 — the mutant proceeds into searchsorted/gather on a zero-width
        # array.
        from innr_tpu.ops.sparse import sparse_dot

        a_i = np.array([1, 2], np.uint32)
        a_v = np.array([1.0, 2.0], np.float32)
        e_i = np.array([], np.uint32)
        e_v = np.array([], np.float32)
        assert float(sparse_dot(a_i, a_v, e_i, e_v)) == 0.0
        assert float(sparse_dot(e_i, e_v, a_i, a_v)) == 0.0

    def test_padded_pair_rejects_list_on_either_side(self):
        # sparse.py:112 [boolop Or -> And]: a python list on EITHER side of
        # a two-tuple marks it as a doc list, not a padded pair. With
        # (2-row ndarray, list) docs the doc-list path unpacks the ndarray's
        # ROWS as doc0's (indices, values) — pin that dispatch so the mutant
        # (which accepts the tuple as a padded pair) changes the values.
        from innr_tpu.ops.sparse import SparseCorpus

        c = SparseCorpus(
            (np.array([[0, 1], [2, 3]], np.uint32), [[1.0, 2.0], [3.0, 4.0]])
        )
        assert np.asarray(c.indices).tolist() == [[0, 1], [1, 2]]
        assert np.asarray(c.values).tolist() == [[2.0, 3.0], [3.0, 4.0]]

    def test_tuple_of_three_doc_pairs_is_a_doc_list(self):
        # sparse.py:109 [boolop And -> Or]: a TUPLE of three (idx, val) doc
        # pairs has len != 2, so it must take the doc-list path; the mutant
        # enters the padded-pair probe and crashes unpacking `a, b = obj`.
        from innr_tpu.ops.sparse import SparseCorpus

        doc = (np.array([0], np.uint32), np.array([1.0], np.float32))
        c = SparseCorpus((doc, doc, doc))
        assert c.num_docs == 3

    def test_knn_k0_and_empty_corpus_never_dispatch(self, monkeypatch):
        # sparse.py:210/:229 [cmp LtE -> Lt] and [boolop Or -> And]: k == 0
        # and n == 0 must return empty WITHOUT scoring the corpus (the
        # early return is a dispatch shortcut, observable via a scorer spy).
        from innr_tpu.ops import sparse as sp

        corpus = sp.SparseCorpus(
            [(np.array([0, 2], np.uint32), np.array([1.0, 2.0], np.float32))]
        )
        empty = sp.SparseCorpus([])
        q = (np.array([0], np.uint32), np.array([1.0], np.float32))

        def boom(*a, **kw):
            raise AssertionError("sparse scorer dispatched")

        monkeypatch.setattr(sp, "_corpus_scores", boom)
        s, i = sp.sparse_knn(q, corpus, 0)
        assert s.shape == (0,) and i.shape == (0,)
        s, i = sp.sparse_knn(q, empty, 3)
        assert s.shape == (0,) and i.shape == (0,)
        s, i = sp.sparse_knn_batch([q], corpus, 0)
        assert s.shape == (1, 0) and i.shape == (1, 0)
        s, i = sp.sparse_knn_batch([q], empty, 3)
        assert s.shape == (1, 0) and i.shape == (1, 0)

    def test_maxsim_empty_doc_array_returns_zero(self):
        # sparse.py:271 [boolop Or -> And]: a pre-padded EMPTY doc array
        # (0, W) with a non-empty query must return 0.0 — the mutant runs
        # jnp.max over a zero-length axis and crashes.
        from innr_tpu.ops.sparse import pad_sparse, sparse_maxsim

        q = pad_sparse([(np.array([1, 2], np.uint32),
                         np.array([1.0, 2.0], np.float32))])
        d_empty = (jnp.zeros((0, 2), jnp.uint32), jnp.zeros((0, 2), jnp.float32))
        assert float(sparse_maxsim(q, d_empty)) == 0.0

    def test_maxsim_batch_empty_never_dispatches(self, monkeypatch):
        # sparse.py:390 [boolop Or -> And]: empty corpus OR empty query
        # alone must return zeros without calling the corpus scorer.
        from innr_tpu.ops import sparse as sp

        def boom(*a, **kw):
            raise AssertionError("corpus maxsim scorer dispatched")

        monkeypatch.setattr(sp, "_corpus_maxsim_scores", boom)
        q = [(np.array([0], np.uint32), np.array([1.0], np.float32))]
        doc = [[(np.array([0], np.uint32), np.array([1.0], np.float32))]]
        d_tri = sp.pad_sparse_docs(doc)
        out = sp.sparse_maxsim_batch(q, (jnp.zeros((0, 1, 1), jnp.uint32),
                                         jnp.zeros((0, 1, 1), jnp.float32),
                                         jnp.zeros((0, 1), bool)))
        assert out.shape == (0,)
        out = sp.sparse_maxsim_batch([], d_tri)
        assert out.shape == (1,) and float(out[0]) == 0.0

    def test_maxsim_knn_k0_and_empty_skip_topk(self, monkeypatch):
        # sparse.py:403 [cmp LtE -> Lt] and [boolop Or -> And]: k == 0 or an
        # empty corpus must return empty without running the top-k.
        from innr_tpu.ops import sparse as sp
        from innr_tpu.utils import order as order_mod

        def boom(*a, **kw):
            raise AssertionError("top_k_total dispatched")

        monkeypatch.setattr(order_mod, "top_k_total", boom)
        q = [(np.array([0], np.uint32), np.array([1.0], np.float32))]
        doc = [[(np.array([0], np.uint32), np.array([1.0], np.float32))]]
        s, i = sp.sparse_maxsim_knn(q, doc, 0)
        assert s.shape == (0,) and i.shape == (0,)
        s, i = sp.sparse_maxsim_knn(
            q,
            (jnp.zeros((0, 1, 1), jnp.uint32),
             jnp.zeros((0, 1, 1), jnp.float32),
             jnp.zeros((0, 1), bool)),
            3,
        )
        assert s.shape == (0,) and i.shape == (0,)

    def test_pad_sparse_docs_tokens_boundary(self):
        # sparse.py:299 [cmp Gt -> GtE]: a doc with EXACTLY `tokens` tokens
        # must be accepted; tokens-1 must raise.
        from innr_tpu.ops.sparse import pad_sparse_docs
        from innr_tpu.utils.asserts import ContractError

        doc = [(np.array([0], np.uint32), np.array([1.0], np.float32)),
               (np.array([1], np.uint32), np.array([2.0], np.float32))]
        idx, val, mask = pad_sparse_docs([doc], tokens=2)
        assert idx.shape[:2] == (1, 2) and int(mask.sum()) == 2
        with pytest.raises(ContractError):
            pad_sparse_docs([doc], tokens=1)


class TestDenseF64ExhaustiveSweep:
    """Killers for the ops/dense_f64.py exhaustive-sweep survivors."""

    def test_quick_two_sum_canonicalizes(self):
        # dense_f64.py:60 [binop Add -> Sub]: _quick_two_sum must return the
        # CANONICAL (fl(s+e), residual) pair. For (1.0, 2^-24): round-to-even
        # gives h == 1.0 exactly, l == 2^-24. The mutant returns
        # (1 - 2^-24, 2^-23) — value-preserving but non-canonical, which is
        # exactly the invariant the df64 error bound rests on.
        from innr_tpu.ops.dense_f64 import _quick_two_sum

        h, l = _quick_two_sum(jnp.float32(1.0), jnp.float32(2.0 ** -24))
        assert float(h) == 1.0
        assert float(l) == 2.0 ** -24

    def test_split_is_dekker_12bit(self):
        # dense_f64.py:65 [binop Mult -> Add]: Dekker splitting must cut the
        # mantissa at 12 bits RELATIVE to the value. 8191.75 needs 13 bits,
        # so hi must round to 8192.0 with lo == -0.25; the additive mutant
        # returns (8191.75, 0.0) — a hi that no longer fits 12 bits, which
        # breaks exact two_prod on FMA-less backends.
        from innr_tpu.ops.dense_f64 import _split

        hi, lo = _split(jnp.float32(8191.75))
        assert float(hi) == 8192.0
        assert float(lo) == -0.25

    def test_l1_identical_vectors_positive_zero(self):
        # dense_f64.py:170 [cmp Lt -> LtE]: |0.0| must keep the POSITIVE
        # zero (neg = dh < 0 is False at +0.0). The mutant negates the zero
        # and a single-element distance (no padding in the tree reduction)
        # surfaces it as -0.0.
        import math

        from innr_tpu.ops.dense_f64 import l1_distance_f64

        r = l1_distance_f64([2.5], [2.5])
        assert r == 0.0 and math.copysign(1.0, r) == 1.0

    def test_native_dot_exact(self):
        # dense_f64.py:191 [binop Mult -> Add]: the impl="native" path is
        # sum(a * b), only reachable with x64 on — toggle it for the test.
        import jax

        from innr_tpu.ops.dense_f64 import dot_f64

        try:
            jax.config.update("jax_enable_x64", True)
            assert dot_f64([2.0, 3.0], [5.0, 7.0], impl="native") == 31.0
        finally:
            jax.config.update("jax_enable_x64", False)

    def test_normalize_norm_exactly_eps_unchanged(self):
        # dense_f64.py:208 [cmp Gt -> GtE]: the contract is "norms AT or
        # below f64::EPSILON leave the vector unchanged" — the boundary
        # itself must NOT normalize. [eps] has norm exactly eps (eps^2 and
        # its sqrt are exact in df64).
        from innr_tpu.ops.dense_f64 import _F64_EPSILON, normalize_f64

        v, n = normalize_f64([_F64_EPSILON])
        assert n == _F64_EPSILON
        assert v[0] == _F64_EPSILON  # unchanged, not 1.0


class TestMaxsimOpsSweepSurvivors:
    """Killers for the ops/maxsim.py exhaustive-sweep survivors."""

    def test_maxsim_cosine_empty_doc_side(self):
        # maxsim.py:106 [boolop Or -> And]: an empty DOC side alone must
        # return 0.0 — the mutant proceeds and crashes on a row-max over a
        # zero-length axis.
        from innr_tpu.ops.maxsim import maxsim_cosine

        q = np.ones((2, 4), np.float32)
        assert float(maxsim_cosine(q, np.zeros((0, 4), np.float32))) == 0.0
        assert float(maxsim_cosine(np.zeros((0, 4), np.float32), q)) == 0.0

    def test_knn_batch_degenerate_never_dispatches(self, monkeypatch):
        # maxsim.py:203 [boolop Or -> And]: each degenerate input alone
        # (empty corpus, k == 0, token-less query batch, empty batch) must
        # return (b, 0) empties without scoring.
        from innr_tpu.ops import maxsim as mx

        def boom(*a, **kw):
            raise AssertionError("batch_maxsim dispatched")

        monkeypatch.setattr(mx, "batch_maxsim", boom)
        docs = np.ones((3, 2, 4), np.float32)
        qs = np.ones((1, 2, 4), np.float32)
        for args in (
            (qs, np.zeros((0, 2, 4), np.float32), 2),   # n == 0
            (qs, docs, 0),                               # k == 0
            (np.ones((1, 0, 4), np.float32), docs, 2),   # Tq == 0
            (np.ones((0, 2, 4), np.float32), docs, 2),   # b == 0
        ):
            s, i = mx.maxsim_knn_batch(*args)
            assert s.shape[1] == 0 and i.shape[1] == 0


class TestGridPolicyContracts:
    """Killers for the parallel/grid.py exhaustive-sweep survivors: the
    local-k / use_fused policy, dispatch shortcuts, the l2 aux values and
    the filtered-entry validation."""

    @staticmethod
    def _mesh(corpus_shards=2, query_shards=1):
        from innr_tpu.parallel.grid import grid_mesh

        return grid_mesh(corpus_shards, query_shards)

    def test_aux_norms2_values(self):
        # grid.py:180 [binop Mult -> Add]: the l2 aux must be the per-row
        # SQUARED norm (sum r*r), not sum (r+r) — only the fused kernel
        # consumes it, so pin the helper's values directly.
        from innr_tpu.parallel.grid import GridIndex

        rows = np.array([[3.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0],
                         [0.5, -2.0, 4.0, 1.5]], np.float32)
        g = GridIndex(rows, self._mesh())
        got = np.asarray(g._aux("l2"))[: rows.shape[0]]
        np.testing.assert_allclose(got, (rows * rows).sum(axis=1), rtol=1e-6)

    def test_dispatch_shortcuts_never_launch(self, monkeypatch):
        # grid.py:200 [cmp LtE -> Lt] and [boolop Or -> And]: k == 0 and an
        # empty index alone must each return empty WITHOUT launching.
        from innr_tpu.parallel import grid as gmod

        def boom(*a, **kw):
            raise AssertionError("_grid_knn dispatched")

        monkeypatch.setattr(gmod, "_grid_knn", boom)
        mesh = self._mesh()
        g = gmod.GridIndex(np.ones((4, 4), np.float32), mesh)
        vals, idx = g.knn_dot(np.ones((2, 4), np.float32), 0)
        assert vals.shape == (2, 0) and idx.shape == (2, 0)
        empty = gmod.GridIndex(np.zeros((0, 4), np.float32), mesh)
        vals, idx = empty.knn_dot(np.ones((2, 4), np.float32), 3)
        assert vals.shape == (2, 0) and idx.shape == (2, 0)

    def test_local_k_policy_recorded(self, monkeypatch):
        # grid.py: pin the exact (k_local, route, shard_rows) handed to the
        # launcher for a geometry where the min() does NOT bind (pad
        # matters) and one where it DOES (shard_rows matters), plus the
        # force_reference arm.
        from innr_tpu import config
        from innr_tpu.parallel import grid as gmod

        rec = {}

        def recorder(qs, rows, aux, k, k_local, mode, n_total, mesh, route,
                     shard_rows):
            rec.update(k_local=k_local, route=route, shard_rows=shard_rows)
            n_q = qs.shape[0]
            kk = max(k, 1)
            return jnp.zeros((n_q, kk), jnp.float32), jnp.zeros(
                (n_q, kk), jnp.int32
            )

        monkeypatch.setattr(gmod, "_grid_knn", recorder)
        _force_kernel_route(monkeypatch)
        mesh = self._mesh()
        # n_true=9 on 2 shards -> n_pad=10, pad=1, shard_rows=5.
        g = gmod.GridIndex(np.ones((9, 16), np.float32), mesh)
        q = np.ones((2, 16), np.float32)
        g.knn_dot(q, 2)
        assert rec == {"k_local": 3, "route": "triton", "shard_rows": 5}
        g.knn_dot(q, 7)
        assert rec["k_local"] == 5  # binding: min(8, 5)
        monkeypatch.setattr(config, "reference_forced", lambda: True)
        g.knn_dot(q, 2)
        assert rec == {"k_local": 3, "route": "xla", "shard_rows": 5}

    def test_filtered_policy_and_validation(self, monkeypatch):
        # grid.py filtered twin of the test above.
        from innr_tpu import config
        from innr_tpu.parallel import grid as gmod
        from innr_tpu.utils.asserts import ContractError

        mesh = self._mesh()
        g = gmod.GridIndex(np.ones((9, 16), np.float32), mesh)
        q = np.ones((2, 16), np.float32)
        ok = np.ones(9, bool)
        with pytest.raises(ContractError, match="grid_knn_filtered"):
            g.knn_filtered(np.ones((2, 5), np.float32), 2, ok)

        rec = {}

        def recorder(qs, rows, aux, mask, k, k_local, n_total, mesh_, route,
                     shard_rows):
            rec.update(k_local=k_local, route=route)
            n_q = qs.shape[0]
            kk = max(k, 1)
            return jnp.zeros((n_q, kk), jnp.float32), jnp.zeros(
                (n_q, kk), jnp.int32
            )

        def boom(*a, **kw):
            raise AssertionError("_grid_knn_filtered dispatched")

        monkeypatch.setattr(gmod, "_grid_knn_filtered", boom)
        vals, idx = g.knn_filtered(q, 0, ok)
        assert vals.shape == (2, 0)
        vals, idx = g.knn_filtered(q, 3, np.zeros(9, bool))  # none passing
        assert vals.shape == (2, 0)
        empty = gmod.GridIndex(np.zeros((0, 16), np.float32), mesh)
        vals, idx = empty.knn_filtered(q, 3, np.zeros(0, bool))
        assert vals.shape == (2, 0)

        monkeypatch.setattr(gmod, "_grid_knn_filtered", recorder)
        _force_kernel_route(monkeypatch)
        g.knn_filtered(q, 2, ok)
        assert rec == {"k_local": 3, "route": "triton"}
        g.knn_filtered(q, 7, ok)
        assert rec["k_local"] == 5
        monkeypatch.setattr(config, "reference_forced", lambda: True)
        g.knn_filtered(q, 2, ok)
        assert rec == {"k_local": 3, "route": "xla"}


class TestQueryParallelPolicyContracts:
    """Killers for the parallel/query_parallel.py sweep survivors: aux
    values and routing, use_fused policy, dispatch shortcuts, filtered
    validation."""

    def test_aux_norms2_values(self):
        # query_parallel.py:110 [binop Mult -> Add]: per-row squared norms.
        from innr_tpu.parallel.query_parallel import QueryParallelIndex

        rows = np.array([[3.0, 0.0], [1.0, 1.0], [0.5, -2.0]], np.float32)
        q = QueryParallelIndex(rows)
        got = np.asarray(q._aux_norms2())
        np.testing.assert_allclose(got, (rows * rows).sum(axis=1), rtol=1e-6)

    def test_dispatch_shortcuts_never_launch(self, monkeypatch):
        # query_parallel.py:151 [cmp LtE / boolop Or].
        from innr_tpu.parallel import query_parallel as qp

        def boom(*a, **kw):
            raise AssertionError("_qp_knn dispatched")

        monkeypatch.setattr(qp, "_qp_knn", boom)
        idx = qp.QueryParallelIndex(np.ones((4, 4), np.float32))
        vals, ids = idx.knn_dot(np.ones((2, 4), np.float32), 0)
        assert vals.shape == (2, 0) and ids.shape == (2, 0)
        empty = qp.QueryParallelIndex(np.zeros((0, 4), np.float32))
        vals, ids = empty.knn_dot(np.ones((2, 4), np.float32), 3)
        assert vals.shape == (2, 0) and ids.shape == (2, 0)

    def test_use_fused_policy_and_aux_routing(self, monkeypatch):
        # query_parallel.py: the route handed to the launcher, the
        # force_reference arm, and the mode-conditional aux routing (dot
        # gets the 1-element dummy, l2 the (N,) norms).
        from innr_tpu import config
        from innr_tpu.parallel import query_parallel as qp

        rec = {}

        def recorder(qs, rows, norms2, inv, k, mode, mesh, route):
            rec["norms2_shape"] = tuple(norms2.shape)
            rec["route"] = route
            n_q = qs.shape[0]
            return (jnp.zeros((n_q, k), jnp.float32),
                    jnp.zeros((n_q, k), jnp.int32))

        monkeypatch.setattr(qp, "_qp_knn", recorder)
        _force_kernel_route(monkeypatch)
        idx = qp.QueryParallelIndex(np.ones((4, 16), np.float32))
        q = np.ones((2, 16), np.float32)
        idx.knn_dot(q, 2)
        assert rec["route"] == "triton"
        assert rec["norms2_shape"] == (1,)  # dot rides the dummy
        idx.knn_l2(q, 2)
        assert rec["norms2_shape"] == (4,)  # l2 gets real norms
        monkeypatch.setattr(config, "reference_forced", lambda: True)
        idx.knn_dot(q, 2)
        assert rec["route"] == "xla"

    def test_filtered_validation_and_policy(self, monkeypatch):
        from innr_tpu import config
        from innr_tpu.parallel import query_parallel as qp
        from innr_tpu.utils.asserts import ContractError

        idx = qp.QueryParallelIndex(np.ones((4, 16), np.float32))
        q = np.ones((2, 16), np.float32)
        ok = np.ones(4, bool)
        with pytest.raises(ContractError, match="query_parallel_knn_filtered"):
            idx.knn_filtered(np.ones((2, 5), np.float32), 2, ok)

        def boom(*a, **kw):
            raise AssertionError("_qp_knn_filtered dispatched")

        monkeypatch.setattr(qp, "_qp_knn_filtered", boom)
        vals, ids = idx.knn_filtered(q, 0, ok)
        assert vals.shape == (2, 0)
        vals, ids = idx.knn_filtered(q, 3, np.zeros(4, bool))
        assert vals.shape == (2, 0)
        empty = qp.QueryParallelIndex(np.zeros((0, 16), np.float32))
        vals, ids = empty.knn_filtered(q, 3, np.zeros(0, bool))
        assert vals.shape == (2, 0)

        rec = {}

        def recorder(qs, rows, norms2, mask, k, mesh, route):
            rec["route"] = route
            n_q = qs.shape[0]
            return (jnp.zeros((n_q, k), jnp.float32),
                    jnp.zeros((n_q, k), jnp.int32))

        monkeypatch.setattr(qp, "_qp_knn_filtered", recorder)
        _force_kernel_route(monkeypatch)
        idx.knn_filtered(q, 2, ok)
        assert rec["route"] == "triton"
        monkeypatch.setattr(config, "reference_forced", lambda: True)
        idx.knn_filtered(q, 2, ok)
        assert rec["route"] == "xla"


class TestStreamedArrayContracts:
    """Killers for the parallel/_stream.py sweep survivors."""

    @staticmethod
    def _sharding():
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
        return NamedSharding(mesh, P("x", None))

    def test_wholly_padded_shard_never_fetches(self):
        # _stream.py:42 [cmp Gt -> GtE]: a wholly-padded shard must fetch
        # ZERO rows — get_rows is never called with an empty range.
        from innr_tpu.parallel._stream import streamed_array

        calls = []
        src = np.arange(8, dtype=np.float32).reshape(4, 2)

        def get_rows(start, stop):
            calls.append((start, stop))
            assert stop > start, "empty-range fetch"
            return src[start:stop]

        arr = streamed_array(
            get_rows, n_true=4, n_pad=8, width=2, np_dtype=np.float32,
            sharding=self._sharding(), column_major=False, name="t",
        )
        out = np.asarray(arr)
        np.testing.assert_array_equal(out[:4], src)
        np.testing.assert_array_equal(out[4:], 0.0)
        assert calls == [(0, 4)]

    def test_shape_contract_message_counts_rows(self):
        # _stream.py:49 [binop Sub -> Add]: the shape-mismatch message must
        # report the true expected row count (real_stop - start), which
        # only differs from the mutant on a shard with start > 0.
        from innr_tpu.parallel._stream import streamed_array

        src = np.arange(16, dtype=np.float32).reshape(8, 2)

        def get_rows(start, stop):
            if start >= 4:
                return src[start : stop - 1]  # wrong: one row short
            return src[start:stop]

        with pytest.raises(Exception, match=r"want \(4, 2\)"):
            np.asarray(streamed_array(
                get_rows, n_true=8, n_pad=8, width=2, np_dtype=np.float32,
                sharding=self._sharding(), column_major=False, name="t",
            ))


class TestShardedPackedContracts:
    """Killers for the parallel/sharded_packed.py exhaustive-sweep
    survivors: the _plan_packed policy table, the fused/jnp padding masks
    and global-index bases (designed corpora where padding rows WOULD win
    and the true winners sit on a nonzero shard), per-violation ctor and
    query validation, dispatch shortcuts, and the encode/source edges."""

    DIM = 64  # 2 uint32 words

    @classmethod
    def _binary_words(cls):
        # 797 rows on the 8-device mesh -> n_pad 800, shard_cols 100,
        # 3 padding rows. Generic rows: exactly 2 bits, all below 59.
        # Row 450: ONE bit (the unique zero-query winner). Rows 700/701/
        # 702: {60,61,62} plus 0/1/2 extras (unique distances 0/1/2 from
        # the row-700 query; every generic row sits at distance 5).
        n = 797
        words = np.zeros((n, 2), np.uint64)
        bits = np.zeros((n, cls.DIM), bool)
        for i in range(n):
            b1 = (i * 7) % 59
            b2 = (b1 + 1 + (i % 57)) % 59
            bits[i, b1] = True
            bits[i, b2] = True
        bits[450] = False
        bits[450, 5] = True
        for r, extras in ((700, ()), (701, (1,)), (702, (1, 2))):
            bits[r] = False
            bits[r, [60, 61, 62]] = True
            for e in extras:
                bits[r, e] = True
        words = np.zeros((n, 2), np.uint32)
        for w in range(2):
            for b in range(32):
                words[:, w] |= bits[:, 32 * w + b].astype(np.uint32) << b
        return words

    def _planes(self):
        # Ternary twin: every TRUE row carries -1 at dim 0 (so a +1@dim0
        # query scores -1 everywhere real and 0 on zero-plane padding
        # rows); rows 700/701/702 add +1s at {60,61,62} / {60,61} / {60}.
        n = 797
        pos = np.zeros((n, 2), np.uint32)
        neg = np.zeros((n, 2), np.uint32)
        neg[:, 0] |= np.uint32(1)  # -1 at dim 0
        for i in range(n):
            pos[i, 0] |= np.uint32(1) << ((i * 7) % 30 + 1)
        for r, dims in ((700, (60, 61, 62)), (701, (60, 61)), (702, (60,))):
            pos[r] = 0
            for d in dims:
                pos[r, d // 32] |= np.uint32(1) << (d % 32)
        return pos, neg

    def test_plan_packed_policy_table(self, monkeypatch):
        # sharded_packed.py _plan_packed: padding is masked BEFORE the
        # local top-k, so k_local = min(k, shard_cols) with no over-fetch.
        from innr_tpu.parallel.sharded_packed import _plan_packed

        assert _plan_packed(40, 4, 5) == 5      # shard_cols 10, not binding
        assert _plan_packed(40, 4, 10) == 10    # boundary
        assert _plan_packed(40, 4, 15) == 10    # binding clamp
        assert _plan_packed(32, 4, 4) == 4
        assert _plan_packed(8, 8, 3) == 1       # one row per shard

    def _run_binary(self, monkeypatch, fused: bool):
        from innr_tpu import config
        from innr_tpu.ops.binary import PackedBinary
        from innr_tpu.parallel.sharded_packed import ShardedPackedBinary

        words = self._binary_words()
        sb = ShardedPackedBinary(words, self.DIM)
        if fused:
            _force_kernel_route(monkeypatch)
        # Zero query: row 450 (one bit) is the unique winner; the three
        # zero padding rows would all beat it if the gidx < n_total mask
        # slipped to <= (counts 0 vs 1).
        zq = PackedBinary(np.zeros(2, np.uint32), self.DIM)
        counts, idx = sb.knn(zq, 1)
        assert int(idx[0]) == 450 and int(counts[0]) == 1
        # Row-700 query: distances 0/1/2 at 700/701/702 — all on shard 7,
        # so the fused global index base (base + lidx) is load-bearing.
        q = PackedBinary(words[700].copy(), self.DIM)
        counts, idx = sb.knn(q, 3)
        assert np.asarray(idx).tolist() == [700, 701, 702]
        assert np.asarray(counts).tolist() == [0, 1, 2]
        # Batch form follows the same mask/base plumbing.
        counts, idx = sb.knn_batch(
            np.stack([np.zeros(2, np.uint32), words[700]]), 2
        )
        assert np.asarray(idx)[0, 0] == 450
        assert np.asarray(idx)[1].tolist() == [700, 701]

    def test_binary_padding_mask_and_base_jnp(self, monkeypatch):
        # sharded_packed.py:71 [cmp Lt] (jnp padding mask).
        self._run_binary(monkeypatch, fused=False)

    def test_binary_padding_mask_and_base_fused(self, monkeypatch):
        # sharded_packed.py:60 [binop Add] and :61 [cmp Lt] (fused arm).
        self._run_binary(monkeypatch, fused=True)

    def _run_ternary(self, monkeypatch, fused: bool):
        from innr_tpu import config
        from innr_tpu.parallel.sharded_packed import ShardedPackedTernary

        pos, neg = self._planes()
        st = ShardedPackedTernary(pos, neg, self.DIM)
        if fused:
            _force_kernel_route(monkeypatch)
        # +1@dim0 query: every real row scores -1, zero-plane padding rows
        # score 0 — the mask is the only thing keeping them out.
        qp = np.zeros(2, np.uint32); qp[0] = 1
        qn = np.zeros(2, np.uint32)
        dots, idx = st.knn_batch((qp[None], qn[None]), 1)
        assert int(dots[0, 0]) == -1 and int(idx[0, 0]) < 797
        # +1@{60,61,62} query: unique dots 3/2/1 at 700/701/702 (shard 7).
        qp2 = np.zeros(2, np.uint32)
        for d in (60, 61, 62):
            qp2[1] |= np.uint32(1) << (d - 32)
        dots, idx = st.knn_batch((qp2[None], qn[None]), 3)
        assert np.asarray(idx)[0].tolist() == [700, 701, 702]
        assert np.asarray(dots)[0].tolist() == [3, 2, 1]

    def test_ternary_padding_mask_and_base_jnp(self, monkeypatch):
        # sharded_packed.py:235 [cmp Lt] (jnp padding mask).
        self._run_ternary(monkeypatch, fused=False)

    def test_ternary_padding_mask_and_base_fused(self, monkeypatch):
        # sharded_packed.py:224 [binop Add] and :225 [cmp Lt] (fused arm).
        self._run_ternary(monkeypatch, fused=True)

    def test_ctor_and_query_validation_per_violation(self):
        # sharded_packed.py:107 / :200 / :272 / :336 [boolop Or]: each
        # disjunct violated ALONE must raise ContractError.
        from innr_tpu.parallel.sharded_packed import (
            ShardedPackedBinary, ShardedPackedTernary,
        )
        from innr_tpu.utils.asserts import ContractError

        ok = np.zeros((4, 2), np.uint32)
        with pytest.raises(ContractError):
            ShardedPackedBinary(np.zeros(8, np.uint32), self.DIM)  # 1-D
        with pytest.raises(ContractError):
            ShardedPackedBinary(np.zeros((4, 3), np.uint32), self.DIM)
        with pytest.raises(ContractError):
            ShardedPackedTernary(np.zeros(8, np.uint32), ok, self.DIM)
        with pytest.raises(ContractError):
            ShardedPackedTernary(ok, np.zeros((5, 2), np.uint32), self.DIM)
        with pytest.raises(ContractError):
            ShardedPackedTernary(
                np.zeros((4, 3), np.uint32), np.zeros((4, 3), np.uint32),
                self.DIM,
            )
        sb = ShardedPackedBinary(ok, self.DIM)
        with pytest.raises(ContractError):
            sb.knn_batch(np.zeros(2, np.uint32), 1)  # 1-D queries
        with pytest.raises(ContractError):
            sb.knn_batch(np.zeros((2, 3), np.uint32), 1)  # wrong width
        st = ShardedPackedTernary(ok, ok, self.DIM)
        with pytest.raises(ContractError):
            st.knn_batch((np.zeros(2, np.uint32), np.zeros(2, np.uint32)), 1)
        with pytest.raises(ContractError):
            st.knn_batch(
                (np.zeros((2, 2), np.uint32), np.zeros((3, 2), np.uint32)), 1
            )
        with pytest.raises(ContractError):
            st.knn_batch(
                (np.zeros((2, 3), np.uint32), np.zeros((2, 3), np.uint32)), 1
            )

    def test_dispatch_shortcuts_never_launch(self, monkeypatch):
        # sharded_packed.py:184 / :206 / :319 / :344 [cmp LtE + boolop Or]:
        # k == 0 and empty corpus alone must return empty WITHOUT
        # launching the sharded kernel.
        from innr_tpu.ops.binary import PackedBinary
        from innr_tpu.ops.ternary import PackedTernary
        from innr_tpu.parallel import sharded_packed as sp

        def boom(*a, **kw):
            raise AssertionError("sharded packed kernel dispatched")

        monkeypatch.setattr(sp, "_sharded_binary_knn", boom)
        monkeypatch.setattr(sp, "_sharded_ternary_knn", boom)
        words = np.ones((4, 2), np.uint32)
        sb = sp.ShardedPackedBinary(words, self.DIM)
        empty_b = sp.ShardedPackedBinary(np.zeros((0, 2), np.uint32), self.DIM)
        q = PackedBinary(np.zeros(2, np.uint32), self.DIM)
        assert sb.knn(q, 0)[0].shape == (0,)
        assert empty_b.knn(q, 3)[0].shape == (0,)
        assert sb.knn_batch(np.zeros((2, 2), np.uint32), 0)[0].shape == (2, 0)
        assert empty_b.knn_batch(np.zeros((2, 2), np.uint32), 3)[0].shape == (2, 0)
        st = sp.ShardedPackedTernary(words, words, self.DIM)
        empty_t = sp.ShardedPackedTernary(
            np.zeros((0, 2), np.uint32), np.zeros((0, 2), np.uint32), self.DIM
        )
        tq = PackedTernary(np.zeros(2, np.uint32), np.zeros(2, np.uint32), self.DIM)
        assert st.knn(tq, 0)[0].shape == (0,)
        assert empty_t.knn(tq, 3)[0].shape == (0,)
        pair = (np.zeros((2, 2), np.uint32), np.zeros((2, 2), np.uint32))
        assert st.knn_batch(pair, 0)[0].shape == (2, 0)
        assert empty_t.knn_batch(pair, 3)[0].shape == (2, 0)

    def test_encode_threshold_strictly_greater(self):
        # sharded_packed.py:128 [cmp Gt -> GtE]: values EQUAL to the
        # threshold encode as 0 (reference src/binary.rs:133 contract).
        from innr_tpu.ops.binary import PackedBinary
        from innr_tpu.parallel.sharded_packed import ShardedPackedBinary

        rows = np.full((4, self.DIM), 0.5, np.float32)
        rows[2, :] = 1.0  # the only row above threshold
        sb = ShardedPackedBinary.encode(rows, threshold=0.5)
        ones_q = PackedBinary(
            np.full(2, 0xFFFFFFFF, np.uint32), self.DIM
        )
        counts, idx = sb.knn(ones_q, 1)
        assert int(idx[0]) == 2 and int(counts[0]) == 0

    def test_from_word_source_dim_multiple_of_32(self):
        # sharded_packed.py:150 [const 0xFFFFFFFF]: rem == 0 keeps every
        # bit of the last word (the mutant corrupts or overflows the
        # mask). dimension=32 -> one word, all 32 bits live.
        from innr_tpu.ops.binary import PackedBinary
        from innr_tpu.parallel.sharded_packed import ShardedPackedBinary

        words = np.zeros((5, 1), np.uint32)
        words[3, 0] = 0x80000001  # high AND low bit set
        sb = ShardedPackedBinary.from_word_source(
            lambda a, b: words[a:b], num_vectors=5, dimension=32
        )
        q = PackedBinary(np.array([0x80000001], np.uint32), 32)
        counts, idx = sb.knn(q, 1)
        assert int(idx[0]) == 3 and int(counts[0]) == 0

    def test_from_word_source_malformed_block_is_contract_error(self):
        # sharded_packed.py:154 [boolop And -> Or]: a 1-D block from the
        # source must surface the stream's shape ContractError, not an
        # IndexError from masking a column that isn't there.
        from innr_tpu.parallel.sharded_packed import ShardedPackedBinary

        with pytest.raises(Exception, match="from_word_source"):
            np.asarray(
                ShardedPackedBinary.from_word_source(
                    lambda a, b: np.zeros(2, np.uint32),  # 1-D, malformed
                    num_vectors=16, dimension=self.DIM,
                ).words_t
            )


class TestShardedPipelineContracts:
    """Killers for the parallel/sharded_pipeline.py exhaustive-sweep
    survivors: the ternary coarse-scan bit algebra, the rerank padding
    mask, the n_cand/use_fused policy, validation arms, encode-threshold
    strictness and the u8 quantile dispatch."""

    def test_ternary_coarse_scan_matches_oracle(self):
        # sharded_pipeline.py:69/:70 [BitOr/BitAnd x4] and :72 [binop Sub]:
        # the jnp ternary coarse dots (popcount(same) - popcount(diff))
        # pinned against an independent numpy oracle on random disjoint
        # planes — any bit-algebra flip reorders the shortlist.
        from innr_tpu.parallel.sharded_pipeline import _coarse_local_candidates

        rng = np.random.default_rng(5)
        n, w = 50, 2
        pos = rng.integers(0, 2**32, (n, w)).astype(np.uint32)
        neg = rng.integers(0, 2**32, (n, w)).astype(np.uint32) & ~pos
        qp = rng.integers(0, 2**32, (1, w)).astype(np.uint32)
        qn = rng.integers(0, 2**32, (1, w)).astype(np.uint32) & ~qp

        def pc(a):
            return sum(int(x).bit_count() for x in a)

        dots = np.array([
            pc((pos[i] & qp[0]) | (neg[i] & qn[0]))
            - pc((pos[i] & qn[0]) | (neg[i] & qp[0]))
            for i in range(n)
        ])
        lidx = _coarse_local_candidates(
            (jnp.asarray(qp), jnp.asarray(qn)),
            (jnp.asarray(pos.T), jnp.asarray(neg.T)),
            "ternary", 10, route="xla",
        )
        got = dots[np.asarray(lidx)[0]]
        want = np.sort(dots)[::-1][:10]
        np.testing.assert_array_equal(got, want)

    def test_rerank_padding_mask(self):
        # sharded_pipeline.py:121 [cmp Lt -> LtE]: an all-padding shard's
        # coarse top-1 IS a padding row (zero words match an all-negative
        # query perfectly); with every true fine dot negative, the mask is
        # the only thing keeping its 0.0 out of the merge.
        from innr_tpu.parallel.sharded_pipeline import ShardedTwoStageIndex

        d = 64
        rows = np.outer(np.arange(1, 22, dtype=np.float32) / 10.0, np.ones(d, np.float32))
        idx = ShardedTwoStageIndex(rows, "binary", rerank_factor=1)
        q = -np.ones(d, np.float32)
        vals, ids = idx.search(q, 1)
        assert float(vals[0]) < 0.0
        assert int(ids[0]) < 21

    def test_policy_recorded_and_shortcuts(self, monkeypatch):
        # sharded_pipeline.py: the n_cand/k_local/route policy handed to
        # the launcher (binary coarse scans are XLA-only; u8 and
        # matryoshka follow the dense route), under force_reference, plus
        # the degenerate shortcuts (never launch).
        from innr_tpu import config
        from innr_tpu.parallel import sharded_pipeline as spl

        rec = {}

        def recorder(qs, rows, coarse, qs_enc, n_total, n_cand, k, k_local,
                     kind, mesh, n_coarse, route):
            rec.update(n_cand=n_cand, k_local=k_local, route=route)
            n_q = qs.shape[0]
            return (jnp.zeros((n_q, k), jnp.float32),
                    jnp.zeros((n_q, k), jnp.int32))

        def boom(*a, **kw):
            raise AssertionError("two-stage launcher dispatched")

        rows = np.ones((64, 16), np.float32)  # 8 shards x 8 rows
        q = np.ones((2, 16), np.float32)
        monkeypatch.setattr(spl, "_sharded_two_stage", boom)
        idx = spl.ShardedTwoStageIndex(rows, "binary", rerank_factor=3)
        assert idx.search_batch(q, 0)[0].shape == (2, 0)
        empty = spl.ShardedTwoStageIndex(np.zeros((0, 16), np.float32), "binary")
        assert empty.search_batch(q, 5)[0].shape == (2, 0)
        assert idx.search_batch(np.ones((0, 16), np.float32), 5)[0].shape == (0, 0)

        monkeypatch.setattr(spl, "_sharded_two_stage", recorder)
        _force_kernel_route(monkeypatch)
        idx.search_batch(q, 2)  # n_cand = min(max(2*3, 2), 8) = 6
        assert rec == {"n_cand": 6, "k_local": 2, "route": "xla"}
        idx.search_batch(q, 3)  # n_cand = min(9, 8) = 8
        assert rec["n_cand"] == 8
        u8 = spl.ShardedTwoStageIndex(rows, "u8", rerank_factor=3)
        u8.search_batch(q, 2)
        assert rec == {"n_cand": 6, "k_local": 2, "route": "triton"}
        monkeypatch.setattr(config, "reference_forced", lambda: True)
        u8.search_batch(q, 2)
        assert rec["route"] == "xla"

    def test_validation_arms(self):
        # sharded_pipeline.py:170 [cmp Lt -> LtE] (rerank_factor == 1 is
        # legal) and :250 [boolop Or] (each query violation alone raises
        # ContractError).
        from innr_tpu.parallel.sharded_pipeline import ShardedTwoStageIndex
        from innr_tpu.utils.asserts import ContractError

        rows = np.ones((8, 8), np.float32)
        idx = ShardedTwoStageIndex(rows, "binary", rerank_factor=1)  # legal
        with pytest.raises(ContractError):
            ShardedTwoStageIndex(rows, "binary", rerank_factor=0)
        with pytest.raises(ContractError):
            idx.search_batch(np.ones(8, np.float32), 2)       # 1-D
        with pytest.raises(ContractError):
            idx.search_batch(np.ones((2, 9), np.float32), 2)  # wrong width

    def test_encode_thresholds_strictly_greater(self):
        # sharded_pipeline.py:186 and :233 [cmp Gt -> GtE]: corpus and
        # query binary encodes treat values EQUAL to the threshold as 0.
        from innr_tpu.parallel.sharded_pipeline import (
            CoarseConfig, ShardedTwoStageIndex,
        )

        d = 64
        rows = np.full((2, d), 0.5, np.float32)
        rows[1] = 1.0
        idx = ShardedTwoStageIndex(
            rows, CoarseConfig(kind="binary", threshold=0.5)
        )
        words_t = np.asarray(idx._coarse[0])  # (W, n_pad)
        assert (words_t[:, 0] == 0).all()          # == threshold -> 0
        assert (words_t[:, 1] == 0xFFFFFFFF).all()  # > threshold -> 1
        (qw,) = idx._encode_queries(jnp.full((1, d), 0.5))
        assert (np.asarray(qw) == 0).all()

    def test_matryoshka_query_prefix_width(self):
        # sharded_pipeline.py:236 [cmp Eq -> NotEq]: the u8 arm's
        # fallthrough is the matryoshka prefix slice — the mutant hands
        # matryoshka queries FULL width (coarse stage silently becomes
        # exact). Pin the encoded width.
        from innr_tpu.parallel.sharded_pipeline import (
            CoarseConfig, ShardedTwoStageIndex,
        )

        rows = np.ones((8, 8), np.float32)
        idx = ShardedTwoStageIndex(
            rows, CoarseConfig(kind="matryoshka", prefix_dims=4)
        )
        (enc,) = idx._encode_queries(jnp.ones((3, 8)))
        assert enc.shape == (3, 4)

    def test_u8_quantile_dispatch(self, monkeypatch):
        # sharded_pipeline.py:197 [cmp GtE -> Gt]: quantile == 1.0 must
        # take the plain min/max fit, anything below it the quantile fit.
        from innr_tpu.ops.scalar import QuantizationParams
        from innr_tpu.parallel.sharded_pipeline import (
            CoarseConfig, ShardedTwoStageIndex,
        )

        calls = []
        real_fit = QuantizationParams.fit.__func__
        real_fq = QuantizationParams.fit_quantile.__func__

        def spy_fit(cls, rows):
            calls.append("fit")
            return real_fit(cls, rows)

        def spy_fq(cls, rows, quantile):
            calls.append("fit_quantile")
            return real_fq(cls, rows, quantile)

        monkeypatch.setattr(
            QuantizationParams, "fit", classmethod(spy_fit)
        )
        monkeypatch.setattr(
            QuantizationParams, "fit_quantile", classmethod(spy_fq)
        )
        rows = np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8)
        ShardedTwoStageIndex(rows, CoarseConfig(kind="u8", quantile=1.0))
        assert calls == ["fit"]
        calls.clear()
        ShardedTwoStageIndex(rows, CoarseConfig(kind="u8", quantile=0.9))
        assert calls[0] == "fit_quantile"


class TestShardedSparseContracts:
    """Killers for the parallel/sharded_sparse.py exhaustive-sweep
    survivors: padding masks where all-sentinel padding rows would win,
    input-form dispatch, validation arms and the degenerate shortcuts."""

    @staticmethod
    def _neg_docs(n=21):
        # Every doc holds index 0 with a positive value, so a query of
        # (idx 0, val -1) scores strictly negative on every REAL row while
        # all-sentinel padding rows score exactly 0.0.
        return [
            (np.array([0], np.uint32), np.array([float(i + 1)], np.float32))
            for i in range(n)
        ]

    def test_knn_padding_mask(self):
        # sharded_sparse.py:45 [cmp Lt -> LtE]: the gidx < n_total guard is
        # the only thing keeping the 0.0-scoring padding rows out.
        from innr_tpu.parallel.sharded_sparse import ShardedSparseCorpus

        sc = ShardedSparseCorpus(self._neg_docs())
        q = (np.array([0], np.uint32), np.array([-1.0], np.float32))
        vals, idx = sc.knn(q, 1)
        assert float(vals[0]) < 0.0 and int(idx[0]) < 21

    def test_maxsim_padding_mask(self):
        # sharded_sparse.py:84 [cmp Lt -> LtE]: fully-masked padding DOCS
        # score 0.0 by the empty-doc contract; with every real maxsim
        # negative they would win without the mask.
        from innr_tpu.parallel.sharded_sparse import ShardedSparseMaxSimCorpus

        docs = [[(np.array([0], np.uint32),
                  np.array([float(i + 1)], np.float32))] for i in range(21)]
        sm = ShardedSparseMaxSimCorpus(docs)
        q = [(np.array([0], np.uint32), np.array([-1.0], np.float32))]
        vals, idx = sm.knn(q, 1)
        assert float(vals[0]) < 0.0 and int(idx[0]) < 21

    def test_maxsim_doc_input_forms(self):
        # sharded_sparse.py:117 [boolop And / cmp Eq / const 3]: a LIST of
        # three documents is a doc list (the Or-mutant unpacks it as a
        # padded triple), and a genuine pre-padded TRIPLE is accepted as
        # arrays (the NotEq/const mutants shove it through
        # pad_sparse_docs).
        from innr_tpu.ops.sparse import pad_sparse_docs
        from innr_tpu.parallel.sharded_sparse import ShardedSparseMaxSimCorpus

        doc = [(np.array([0], np.uint32), np.array([1.0], np.float32))]
        three = ShardedSparseMaxSimCorpus([doc, doc, doc])
        assert three.num_docs == 3
        triple = pad_sparse_docs([doc, doc])
        pre = ShardedSparseMaxSimCorpus(triple)
        assert pre.num_docs == 2
        q = doc
        vals, idx = pre.knn(q, 2)
        np.testing.assert_allclose(np.asarray(vals), [1.0, 1.0])

    def test_maxsim_triple_validation_per_violation(self):
        # sharded_sparse.py:123 [boolop Or]: each violated disjunct alone
        # must raise ContractError.
        from innr_tpu.parallel.sharded_sparse import ShardedSparseMaxSimCorpus
        from innr_tpu.utils.asserts import ContractError

        idx3 = np.zeros((2, 2, 2), np.uint32)
        val3 = np.zeros((2, 2, 2), np.float32)
        mask2 = np.zeros((2, 2), bool)
        with pytest.raises(ContractError):
            ShardedSparseMaxSimCorpus((np.zeros((2, 2), np.uint32), val3, mask2))
        with pytest.raises(ContractError):
            ShardedSparseMaxSimCorpus((idx3, np.zeros((2, 2, 3), np.float32), mask2))
        with pytest.raises(ContractError):
            ShardedSparseMaxSimCorpus((idx3, val3, np.zeros((2, 3), bool)))

    def test_shortcuts_never_launch_and_shapes(self, monkeypatch):
        # sharded_sparse.py:159 / :227 [cmp LtE + boolop Or]: k == 0 and
        # empty corpus alone must return empty WITHOUT launching;
        # :228 [const 2]: the batch form of the empty return keeps its
        # (n_q, 0) shape.
        from innr_tpu.parallel import sharded_sparse as ss

        def boom(*a, **kw):
            raise AssertionError("sharded sparse kernel dispatched")

        monkeypatch.setattr(ss, "_sharded_sparse_knn", boom)
        monkeypatch.setattr(ss, "_sharded_sparse_maxsim", boom)
        sc = ss.ShardedSparseCorpus(self._neg_docs(4))
        empty = ss.ShardedSparseCorpus([])
        q = (np.array([0], np.uint32), np.array([1.0], np.float32))
        assert sc.knn(q, 0)[0].shape == (0,)
        assert empty.knn(q, 3)[0].shape == (0,)
        s, i = sc.knn_batch([q, q], 0)
        assert s.shape == (2, 0) and i.shape == (2, 0)
        assert empty.knn_batch([q, q], 3)[0].shape == (2, 0)
        doc = [q]
        sm = ss.ShardedSparseMaxSimCorpus([doc])
        sm_empty = ss.ShardedSparseMaxSimCorpus(
            (np.full((0, 1, 1), 0xFFFFFFFF, np.uint32),
             np.zeros((0, 1, 1), np.float32), np.zeros((0, 1), bool))
        )
        assert sm.knn(doc, 0)[0].shape == (0,)
        assert sm_empty.knn(doc, 3)[0].shape == (0,)

    def test_empty_1d_query_still_scans(self):
        # sharded_sparse.py:236 [cmp Eq -> NotEq]: an EMPTY 1-D query is
        # not an empty batch — it scans (every doc scores 0.0) and returns
        # (k,) results; the mutant returns the (0, k) batch shape.
        from innr_tpu.parallel.sharded_sparse import ShardedSparseCorpus

        sc = ShardedSparseCorpus(self._neg_docs(6))
        q = (np.array([], np.uint32), np.array([], np.float32))
        vals, idx = sc.knn(q, 2)
        assert vals.shape == (2,) and idx.shape == (2,)
        np.testing.assert_allclose(np.asarray(vals), [0.0, 0.0])
        assert all(0 <= int(i) < 6 for i in np.asarray(idx))
        # :236 [const 2 -> 3]: an EMPTY 2-D batch must short-circuit to
        # (0, k) — the per-query stack in the shard body cannot handle
        # zero queries, so the mutant crashes here instead.
        vals, idx = sc.knn_batch([], 2)
        assert vals.shape == (0, 2) and idx.shape == (0, 2)

    def test_two_pair_batch_is_a_batch(self):
        # sharded_sparse.py:212 [boolop And -> Or]: a LIST of exactly two
        # (indices, values) pairs must parse as TWO queries, not as one
        # 2-D pair of (pair0, pair1).
        from innr_tpu.parallel.sharded_sparse import ShardedSparseCorpus

        sc = ShardedSparseCorpus(self._neg_docs(6))
        q0 = (np.array([0], np.uint32), np.array([1.0], np.float32))
        q1 = (np.array([0], np.uint32), np.array([2.0], np.float32))
        vals, idx = sc.knn_batch([q0, q1], 1)
        np.testing.assert_allclose(np.asarray(vals), [[6.0], [12.0]])
        np.testing.assert_array_equal(np.asarray(idx), [[5], [5]])


class TestShardedMaxSimContracts:
    """Killers for the parallel/sharded_maxsim.py exhaustive-sweep
    survivors: padding mask, mask-shape validation, query validation,
    degenerate shortcuts, and the k_local/use_fused policy."""

    def test_padding_mask(self):
        # sharded_maxsim.py:44 [cmp Lt -> LtE]: padded doc rows are
        # fully-masked (score exactly 0.0 by the empty-doc contract);
        # with every real maxsim negative they would win without the
        # gidx < n_total guard.
        from innr_tpu.parallel.sharded_maxsim import ShardedMaxSimCorpus

        docs = np.ones((21, 2, 4), np.float32)
        sm = ShardedMaxSimCorpus(docs)
        q = -np.ones((2, 4), np.float32)
        vals, idx = sm.knn(q, 1)
        assert float(vals[0]) < 0.0 and int(idx[0]) < 21

    def test_explicit_doc_mask_accepted(self):
        # sharded_maxsim.py:99 [const 2 -> 3]: a VALID (N, Td) doc_mask
        # must be accepted (the mutant compares it against the full 3-D
        # shape and rejects every valid mask), and masked tokens must be
        # excluded from the max.
        from innr_tpu.parallel.sharded_maxsim import ShardedMaxSimCorpus
        from innr_tpu.utils.asserts import ContractError

        docs = np.zeros((9, 2, 4), np.float32)
        docs[3, 0] = 1.0   # real token, positive
        docs[3, 1] = 9.0   # masked token — must NOT contribute
        mask = np.zeros((9, 2), bool)
        mask[:, 0] = True
        sm = ShardedMaxSimCorpus(docs, doc_mask=mask)
        q = np.ones((1, 4), np.float32)
        vals, idx = sm.knn(q, 1)
        assert int(idx[0]) == 3
        np.testing.assert_allclose(float(vals[0]), 4.0)  # not 36.0
        # The message must report the EXPECTED (N, Td) shape — the const
        # mutant renders docs.shape[:3] there instead.
        with pytest.raises(ContractError, match=r"!= \(9, 2\)"):
            ShardedMaxSimCorpus(docs, doc_mask=np.zeros((9, 3), bool))

    def test_query_validation_per_violation(self):
        # sharded_maxsim.py:126 [boolop Or -> And]: each violation alone
        # must raise ContractError.
        from innr_tpu.parallel.sharded_maxsim import ShardedMaxSimCorpus
        from innr_tpu.utils.asserts import ContractError

        sm = ShardedMaxSimCorpus(np.ones((4, 2, 4), np.float32))
        with pytest.raises(ContractError):
            sm.knn(np.ones(4, np.float32), 1)            # 1-D, width OK
        with pytest.raises(ContractError):
            sm.knn(np.ones((2, 5), np.float32), 1)       # wrong width

    def test_shortcuts_never_launch(self, monkeypatch):
        # sharded_maxsim.py:131 [cmp LtE + boolop Or]: k == 0, empty
        # corpus, and a token-less query must each return empty without
        # launching, in both single and batch forms.
        from innr_tpu.parallel import sharded_maxsim as sms

        def boom(*a, **kw):
            raise AssertionError("sharded maxsim kernel dispatched")

        monkeypatch.setattr(sms, "_sharded_maxsim_knn", boom)
        sm = sms.ShardedMaxSimCorpus(np.ones((4, 2, 4), np.float32))
        empty = sms.ShardedMaxSimCorpus(np.ones((0, 2, 4), np.float32))
        q2 = np.ones((2, 4), np.float32)
        q3 = np.ones((3, 2, 4), np.float32)
        assert sm.knn(q2, 0)[0].shape == (0,)
        assert empty.knn(q2, 5)[0].shape == (0,)
        assert sm.knn(np.ones((0, 4), np.float32), 5)[0].shape == (0,)
        assert sm.knn(q3, 0)[0].shape == (3, 0)
        assert empty.knn(q3, 5)[0].shape == (3, 0)

    def test_policy_recorded(self, monkeypatch):
        # sharded_maxsim.py: the k_local handed to the launcher (the shard
        # clamp); MaxSim has a single route, whatever the corpus size.
        from innr_tpu import config
        from innr_tpu.parallel import sharded_maxsim as sms

        rec = {}

        def recorder(q, docs, mask, k, k_local, n_total, mesh):
            rec.update(k_local=k_local)
            return (jnp.zeros((k,), jnp.float32), jnp.zeros((k,), jnp.int32))

        monkeypatch.setattr(sms, "_sharded_maxsim_knn", recorder)
        q = np.ones((1, 4), np.float32)

        def mk(n):
            return sms.ShardedMaxSimCorpus(np.ones((n, 1, 4), np.float32))

        mk(800).knn(q, 3)
        assert rec == {"k_local": 3}
        mk(16).knn(q, 5)    # shard_rows 2: k clamps
        assert rec == {"k_local": 2}
        monkeypatch.setattr(config, "reference_forced", lambda: True)
        mk(800).knn(q, 3)
        assert rec == {"k_local": 3}


class TestShardedQuantContracts:
    """Killers for the parallel/sharded_quant.py exhaustive-sweep
    survivors: fused/jnp padding masks + global-index base, the
    k_local/use_fused policy, and the degenerate shortcuts."""

    @staticmethod
    def _corpus():
        # 797 rows, 8 shards x 100: code-sums 10.. for generic rows and
        # 1/2/3 at rows 700/701/702 (unique mixed dots -1/-2/-3 against
        # the all-minus-ones query); padding rows are all-zero codes
        # (mixed dot 0 — they WIN unless masked).
        from innr_tpu.ops.scalar import QuantizationParams

        n, d = 797, 16
        codes = np.zeros((n, d), np.uint8)
        for i in range(n):
            codes[i, i % d] = 10 + (i % 50)
        for r, s in ((700, 1), (701, 2), (702, 3)):
            codes[r] = 0
            codes[r, 0] = s
        params = QuantizationParams(alpha=255.0, offset=0.0)
        return codes, params

    def _run(self, monkeypatch, fused: bool):
        from innr_tpu import config
        from innr_tpu.parallel.sharded_quant import ShardedQuantizedU8

        codes, params = self._corpus()
        sq = ShardedQuantizedU8(codes, params)
        if fused:
            _force_kernel_route(monkeypatch)
        q = -np.ones(16, np.float32)
        vals, idx = sq.knn(q, 3)
        assert np.asarray(idx).tolist() == [700, 701, 702]
        np.testing.assert_allclose(np.asarray(vals), [-1.0, -2.0, -3.0])
        vals, idx = sq.knn(np.stack([q, q]), 1)
        assert np.asarray(idx)[0, 0] == 700 and float(vals[0, 0]) == -1.0

    def test_padding_mask_and_base_jnp(self, monkeypatch):
        # sharded_quant.py:49 [cmp Lt] (jnp padding mask).
        self._run(monkeypatch, fused=False)

    def test_padding_mask_and_base_fused(self, monkeypatch):
        # sharded_quant.py:37 [binop Add] and :38 [cmp Lt] (fused arm).
        self._run(monkeypatch, fused=True)

    def test_shortcuts_never_launch(self, monkeypatch):
        # sharded_quant.py:153 [cmp LtE + boolop Or].
        from innr_tpu.ops.scalar import QuantizationParams
        from innr_tpu.parallel import sharded_quant as sqm

        def boom(*a, **kw):
            raise AssertionError("sharded u8 kernel dispatched")

        monkeypatch.setattr(sqm, "_sharded_u8_knn", boom)
        params = QuantizationParams(alpha=1.0, offset=0.0)
        sq = sqm.ShardedQuantizedU8(np.ones((4, 8), np.uint8), params)
        empty = sqm.ShardedQuantizedU8(np.ones((0, 8), np.uint8), params)
        q = np.ones(8, np.float32)
        assert sq.knn(q, 0)[0].shape == (0,)
        assert empty.knn(q, 3)[0].shape == (0,)
        assert sq.knn(np.ones((2, 8), np.float32), 0)[0].shape == (2, 0)
        assert empty.knn(np.ones((2, 8), np.float32), 3)[0].shape == (2, 0)

    def test_policy_recorded(self, monkeypatch):
        # sharded_quant.py: k_local = min(k + pad, shard_rows) and the
        # route handed to the launcher.
        from innr_tpu import config
        from innr_tpu.ops.scalar import QuantizationParams
        from innr_tpu.parallel import sharded_quant as sqm

        rec = {}

        def recorder(q, codes, alpha, offset, k, k_local, n_total, mesh,
                     route):
            rec.update(k_local=k_local, route=route)
            return (jnp.zeros((k,), jnp.float32), jnp.zeros((k,), jnp.int32))

        monkeypatch.setattr(sqm, "_sharded_u8_knn", recorder)
        _force_kernel_route(monkeypatch)
        params = QuantizationParams(alpha=1.0, offset=0.0)
        # 69 rows on 8 devices -> n_pad 72, shard_rows 9, pad 3.
        sq = sqm.ShardedQuantizedU8(np.ones((69, 16), np.uint8), params)
        q = np.ones(16, np.float32)
        sq.knn(q, 2)   # non-binding: k_local = min(2 + 3, 9) = 5
        assert rec == {"k_local": 5, "route": "triton"}
        sq.knn(q, 8)   # binding: min(11, 9) = 9
        assert rec["k_local"] == 9
        monkeypatch.setattr(config, "reference_forced", lambda: True)
        sq.knn(q, 2)
        assert rec == {"k_local": 5, "route": "xla"}


class TestShardedSlotContracts:
    """Killers for the parallel/sharded_slot.py exhaustive-sweep
    survivors: padding masks, the n_q plumbing into the packed plan,
    shortcut spies and the MinHash similarity formula."""

    @staticmethod
    def _sketches():
        # 797 sketches, 8 shards x 100. Every sketch differs from the
        # all-zero query in >= 2 slots except row 450 (exactly 1), so the
        # all-zero PADDING sketches (count 0) would win without the mask.
        n, s = 797, 8
        sk = np.zeros((n, s), np.uint32)
        for i in range(n):
            sk[i, i % s] = 1 + (i % 9)
            sk[i, (i + 3) % s] = 2 + (i % 7)
        sk[450] = 0
        sk[450, 5] = 7
        return sk

    def _run_mask(self, monkeypatch, fused: bool):
        from innr_tpu import config
        from innr_tpu.parallel.sharded_slot import ShardedSlotCorpus

        sc = ShardedSlotCorpus(self._sketches())
        if fused:
            _force_kernel_route(monkeypatch)
        counts, idx = sc.knn(np.zeros(8, np.uint32), 1)
        assert int(idx[0]) == 450 and int(counts[0]) == 1
        counts, idx = sc.knn_batch(np.zeros((2, 8), np.uint32), 1)
        assert np.asarray(idx)[:, 0].tolist() == [450, 450]

    def test_padding_mask_jnp(self, monkeypatch):
        # sharded_slot.py:54 [cmp Lt] (jnp padding mask).
        self._run_mask(monkeypatch, fused=False)

    def test_padding_mask_fused(self, monkeypatch):
        # sharded_slot.py:46 [cmp Lt] (fused arm).
        self._run_mask(monkeypatch, fused=True)

    def test_shortcuts_never_launch(self, monkeypatch):
        # sharded_slot.py:174 [cmp LtE + boolop Or].
        from innr_tpu.parallel import sharded_slot as ssl

        def boom(*a, **kw):
            raise AssertionError("sharded slot kernel dispatched")

        monkeypatch.setattr(ssl, "_sharded_slot_knn", boom)
        sc = ssl.ShardedSlotCorpus(np.ones((4, 8), np.uint32))
        empty = ssl.ShardedSlotCorpus(np.ones((0, 8), np.uint32))
        q = np.ones(8, np.uint32)
        assert sc.knn(q, 0)[0].shape == (0,)
        assert empty.knn(q, 3)[0].shape == (0,)
        assert sc.knn_batch(np.ones((2, 8), np.uint32), 0)[0].shape == (2, 0)
        assert empty.knn_batch(np.ones((2, 8), np.uint32), 3)[0].shape == (2, 0)

    def test_nq_reaches_the_plan(self, monkeypatch):
        # sharded_slot.py: single sketches and (Q, S) batches get the same
        # plan — k clamped to the shard width, no over-fetch (padding is
        # masked before the local top-k).
        from innr_tpu.parallel import sharded_slot as ssl

        rec = {}

        def recorder(q, slots, k, k_local, n_total, mesh):
            rec["k_local"] = k_local
            shape = (k,) if q.ndim == 1 else (q.shape[0], k)
            return (jnp.zeros(shape, jnp.uint32), jnp.zeros(shape, jnp.int32))

        monkeypatch.setattr(ssl, "_sharded_slot_knn", recorder)
        # 69 sketches -> n_pad 72, shard 9, pad 3.
        sc = ssl.ShardedSlotCorpus(np.ones((69, 8), np.uint32))
        sc.knn(np.ones(8, np.uint32), 2)
        assert rec["k_local"] == 2
        sc.knn_batch(np.ones((3, 8), np.uint32), 2)
        assert rec["k_local"] == 2
        sc.knn(np.ones(8, np.uint32), 20)
        assert rec["k_local"] == 9

    def test_minhash_similarity_formula(self):
        # sharded_slot.py:217 [binop Div / binop Sub]: sims must be
        # exactly 1 - count / num_slots.
        from innr_tpu.parallel.sharded_slot import ShardedSlotCorpus

        sk = np.zeros((3, 8), np.uint32)
        sk[0] = 9                 # equal to the query -> sim 1.0
        sk[1, :4] = 9             # 4 of 8 differ -> sim 0.5
        sk[2, :] = 5              # all differ -> sim 0.0
        sc = ShardedSlotCorpus(sk)
        sims, idx = sc.minhash_knn(np.full(8, 9, np.uint32), 3)
        np.testing.assert_allclose(np.asarray(sims), [1.0, 0.5, 0.0])
        assert np.asarray(idx).tolist() == [0, 1, 2]


class TestReferenceOracleContracts:
    """Killers for the ops/reference.py exhaustive-sweep survivors. The
    oracle IS the contract — each pin nails the portable semantics at the
    exact input where a mutant diverges, cross-checked against the
    production op where meaningful."""

    def test_cosine_guard_band(self):
        # reference.py:18 [binop Mult -> Add]: NORM_EPSILON_SQ must be
        # eps^2 = 1e-18, not 2e-9 — vectors of norm 1e-6 sit between and
        # must cosine to 1.0, matching production.
        import innr_tpu as it
        from innr_tpu.ops.reference import cosine_portable

        a = np.array([1e-6], np.float32)
        assert cosine_portable(a, a) == 1.0
        np.testing.assert_allclose(float(it.cosine(a, a)), 1.0)

    def test_cosine_one_sided_zero_norm(self):
        # reference.py:46 [boolop And -> Or]: a zero-norm side alone must
        # yield 0.0 (the mutant divides 0/0 into NaN).
        from innr_tpu.ops.reference import cosine_portable

        z = np.zeros(3, np.float32)
        b = np.array([1.0, 2.0, 3.0], np.float32)
        assert cosine_portable(z, b) == 0.0
        assert cosine_portable(b, z) == 0.0

    def test_normalize_guard_boundary_exact(self):
        # reference.py:80 [cmp Gt -> GtE]: norms AT the epsilon leave the
        # vector unchanged. This 3-element f32 vector's f64 norm rounds to
        # EXACTLY 1e-9 (constructed by walking the sqrt rounding window).
        from innr_tpu.ops.reference import norm_portable, normalize_portable

        v = np.array(
            [9.000000189551827e-10, 4.3588985199072283e-10,
             5.302996133578833e-14],
            np.float32,
        )
        assert norm_portable(v) == 1e-9
        out, n = normalize_portable(v)
        assert n == 1e-9
        np.testing.assert_array_equal(out, v)

    def test_maxsim_one_sided_empty(self):
        # reference.py:154 and :163 [boolop Or -> And]: an empty DOC side
        # alone must return 0.0 in both portable maxsims (the mutants
        # reduce over an empty axis / sum -inf).
        from innr_tpu.ops.reference import (
            maxsim_cosine_portable, maxsim_portable,
        )

        q = np.ones((2, 4), np.float32)
        e = np.zeros((0, 4), np.float32)
        assert maxsim_portable(q, e) == 0.0
        assert maxsim_portable(e, q) == 0.0
        assert maxsim_cosine_portable(q, e) == 0.0
        assert maxsim_cosine_portable(e, q) == 0.0


class TestNativeHostContracts:
    """Killers for the _native.py phase-2 sweep survivors: the native
    host runtime must be PRESENT when buildable (a broken ABI check or
    word-count bug silently downgrades every loader to the Python path),
    and its encoders must match the jnp encoders bit-for-bit."""

    def test_native_available_when_buildable(self):
        # _native.py:58/:72 [const 3 -> 4]: a fresh build reports ABI 3;
        # mutating the check makes every load look stale (rebuild, still
        # "stale", give up) and silently drops the whole native runtime.
        # Environment failures must SKIP, not fail (ADVICE r4): _load()
        # legitimately returns None when the compiler/sandbox refuses, and
        # a pre-existing stale-ABI .so can stay dlopen-cached in-process —
        # remove it first so the assertion exercises a fresh build.
        import shutil

        from innr_tpu import _native

        if not (shutil.which("cc") and _native._SRC.exists()):
            pytest.skip("no C toolchain in this environment")
        if _native._LIB_PATH.exists():
            _native._LIB_PATH.unlink()
        if not _native._try_build():
            pytest.skip("C toolchain present but build failed (sandbox?)")
        assert _native.available()

    def test_pack_ternary_word_count_and_values(self):
        # _native.py:178/:194 [const 32 -> 33, const 31 -> 32]: the
        # uint32 word count must be exactly ceil(d/32). d=33 is the
        # boundary a 33-divisor mutant collapses to one word; d=64 is the
        # exact multiple an extra-word mutant widens. Values must equal
        # the jnp bitplane encoders bit-for-bit.
        from innr_tpu import _native
        from innr_tpu.ops.ternary import encode_ternary, encode_ternary_batch

        if not _native.available():
            pytest.skip("native host runtime unavailable")
        rng = np.random.default_rng(7)
        for d in (33, 64):
            rows = rng.standard_normal((5, d)).astype(np.float32)
            got = _native.pack_ternary_rows(rows, 0.25)
            assert got is not None
            pos, neg = got
            w = -(-d // 32)
            assert pos.shape == (5, w) and neg.shape == (5, w)
            jp, jn = encode_ternary_batch(rows, 0.25)
            np.testing.assert_array_equal(pos, np.asarray(jp))
            np.testing.assert_array_equal(neg, np.asarray(jn))
            sp, sn = _native.pack_ternary(rows[0], 0.25)
            ref = encode_ternary(rows[0], 0.25)
            np.testing.assert_array_equal(sp, np.asarray(ref.pos))
            np.testing.assert_array_equal(sn, np.asarray(ref.neg))

    def test_pack_binary_word_count_and_values(self):
        # Same word-count contract for the binary row packer
        # (_native.py:163) at the d=33 boundary and d=64 multiple.
        from innr_tpu import _native
        from innr_tpu.ops.binary import encode_binary_batch

        if not _native.available():
            pytest.skip("native host runtime unavailable")
        rng = np.random.default_rng(11)
        for d in (33, 64):
            rows = rng.standard_normal((5, d)).astype(np.float32)
            words = _native.pack_binary_rows(rows, 0.0)
            assert words is not None
            assert words.shape == (5, -(-d // 32))
            np.testing.assert_array_equal(
                words, np.asarray(encode_binary_batch(rows, 0.0))
            )


class TestTernaryWordsKernelOracle:
    """Kills the hamming.py:64 BitOr/BitAnd survivors: _ternary_kernel's
    same/diff plane composition. The mapped suites only reach the kernel
    through the MIN_ROWS-gated dispatch (small test corpora take the jnp
    path), so the composition was unobservable — drive the kernel
    directly against the integer dot oracle."""

    def test_ternary_words_kernel_matches_dot_oracle(self):
        batch_ternary_dot_words = _kham.batch_ternary_dot_words
        from innr_tpu.ops.ternary import (
            encode_ternary_batch, encode_ternary_values,
        )

        rng = np.random.default_rng(3)
        # d=130: 5 words with a ragged tail; values in {-1, 0, +1} so the
        # ternary dot equals the integer dot exactly.
        vals = rng.integers(-1, 2, size=(97, 130)).astype(np.int32)
        q = rng.integers(-1, 2, size=130).astype(np.int32)
        cpos, cneg = encode_ternary_batch(vals.astype(np.float32), 0.5)
        pq = encode_ternary_values(q)
        out = np.asarray(
            batch_ternary_dot_words(pq.pos, pq.neg, cpos, cneg)
        )
        np.testing.assert_array_equal(out, (vals * q[None, :]).sum(axis=1))


class TestHammingWordsKernelOracle:
    """Kills the hamming.py:33 BitXor survivor: `rows ^ q` inside
    _hamming_kernel. The mapped suites only reach the kernel above the
    MIN_ROWS dispatch gate (small corpora take the jnp path), so the
    XOR itself was unobservable — drive batch_hamming_words directly
    against the popcount oracle."""

    def test_hamming_words_kernel_matches_popcount_oracle(self):
        batch_hamming_words = _kham.batch_hamming_words

        rng = np.random.default_rng(7)
        corpus = rng.integers(0, 2**32, size=(137, 5), dtype=np.uint32)
        q = rng.integers(0, 2**32, size=5, dtype=np.uint32)
        got = np.asarray(batch_hamming_words(jnp.asarray(q),
                                             jnp.asarray(corpus)))
        want = np.array([
            int(sum(int(a ^ b).bit_count() for a, b in zip(row, q)))
            for row in corpus
        ], dtype=np.uint32)
        np.testing.assert_array_equal(got, want)
        # An AND/OR mutant also changes the SELF distance (x^x = 0 but
        # x&x = x): pin the zero diagonal explicitly.
        self_d = np.asarray(
            batch_hamming_words(jnp.asarray(corpus[0]),
                                jnp.asarray(corpus[:1]))
        )
        assert self_d[0] == 0

    def test_hamming_words_multi_tile_grid(self):
        # hamming.py grid `n_pad // tile_n` [FloorDiv survivor]: at
        # n=16384, w=2 the tile is 8192 -> a 2-step grid; the Mult
        # mutant explodes it to 134M idempotent steps (timeout = killed
        # in the sweep). Values also pin the multi-tile index map.
        batch_hamming_words = _kham.batch_hamming_words

        rng = np.random.default_rng(11)
        corpus = rng.integers(0, 2**32, size=(16_384, 2), dtype=np.uint32)
        q = rng.integers(0, 2**32, size=2, dtype=np.uint32)
        got = np.asarray(batch_hamming_words(jnp.asarray(q),
                                             jnp.asarray(corpus)))
        x = corpus ^ q[None, :]
        want = (
            np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)
        ).astype(np.uint32)
        np.testing.assert_array_equal(got, want)

    def test_ternary_words_multi_tile_grid(self):
        # Same for the ternary kernel's grid at hamming.py:85.
        batch_ternary_dot_words = _kham.batch_ternary_dot_words
        from innr_tpu.ops.ternary import (
            encode_ternary_batch, encode_ternary_values,
        )

        rng = np.random.default_rng(12)
        vals = rng.integers(-1, 2, size=(16_384, 33)).astype(np.int32)
        q = rng.integers(-1, 2, size=33).astype(np.int32)
        cpos, cneg = encode_ternary_batch(vals.astype(np.float32), 0.5)
        pq = encode_ternary_values(q)
        got = np.asarray(
            batch_ternary_dot_words(pq.pos, pq.neg, cpos, cneg)
        )
        np.testing.assert_array_equal(got, (vals * q[None, :]).sum(axis=1))
