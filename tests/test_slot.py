"""Slot Hamming / MinHash (reference src/slot.rs). Integer ops: EXACT
equality, never tolerance (reference fuzz/slot_diff.rs)."""

import jax.numpy as jnp
import numpy as np
import pytest

import innr_tpu as it
from innr_tpu.ops.reference import (
    slot_compare_counts_portable,
    slot_hamming_portable,
)


class TestSlotHamming:
    def test_docstring_case(self):
        assert int(it.slot_hamming_u32([1, 2, 3, 4], [1, 0, 3, 9])) == 2

    @pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 32, 64, 257])
    def test_u32_differential(self, rng, n):
        a = rng.integers(0, 4, n).astype(np.uint32)
        b = rng.integers(0, 4, n).astype(np.uint32)
        assert int(it.slot_hamming_u32(a, b)) == slot_hamming_portable(a, b)

    @pytest.mark.parametrize("n", [1, 4, 8, 16, 100, 257])
    def test_u16_differential(self, rng, n):
        a = rng.integers(0, 1 << 16, n).astype(np.uint16)
        b = rng.integers(0, 1 << 16, n).astype(np.uint16)
        assert int(it.slot_hamming_u16(a, b)) == slot_hamming_portable(a, b)

    @pytest.mark.parametrize("n", [1, 4, 8, 100, 257])
    def test_u64_differential(self, rng, n):
        a = rng.integers(0, 2**63, n, dtype=np.uint64)
        b = a.copy()
        flip = rng.random(n) < 0.4
        b[flip] ^= np.uint64(1) << rng.integers(0, 64, n, dtype=np.uint64)[flip]
        assert int(it.slot_hamming_u64(a, b)) == slot_hamming_portable(a, b)

    def test_u64_differs_only_in_high_half(self):
        a = np.array([0x0000000100000000], np.uint64)
        b = np.array([0x0000000200000000], np.uint64)
        assert int(it.slot_hamming_u64(a, b)) == 1

    def test_length_mismatch_raises(self):
        with pytest.raises(it.ContractError):
            it.slot_hamming_u32(np.zeros(3, np.uint32), np.zeros(4, np.uint32))

    def test_generic_min_length_no_raise(self):
        # Generic slot_hamming compares over min length, no panic
        # (reference src/slot.rs:266).
        assert it.slot_hamming([1, 2, 3], [1, 9]) == 1

    def test_empty(self):
        z = np.zeros(0, np.uint32)
        assert int(it.slot_hamming_u32(z, z)) == 0


class TestSlotCompareCounts:
    def test_docstring_case(self):
        a = np.array([3, 1, 4, 1, 5], np.uint16)
        b = np.array([3, 1, 2, 9, 5], np.uint16)
        c = it.slot_compare_counts(a, b)
        assert (c.eq, c.lt, c.gt) == (3, 1, 1)

    @pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64])
    def test_differential(self, rng, dtype):
        hi = min(int(np.iinfo(dtype).max), 2**63 - 1)
        a = rng.integers(0, hi, 100, dtype=np.int64).astype(dtype)
        b = rng.integers(0, hi, 100, dtype=np.int64).astype(dtype)
        if dtype == np.uint64:
            # Exercise the high-half comparison path explicitly.
            a = (a << np.uint64(1)) | np.uint64(1)
            b = b << np.uint64(1)
        c = it.slot_compare_counts(a, b)
        assert (c.eq, c.lt, c.gt) == slot_compare_counts_portable(a, b)
        assert c.eq + c.lt + c.gt == 100

    def test_min_length(self):
        c = it.slot_compare_counts([1, 2, 3], [1])
        assert c.eq + c.lt + c.gt == 1

    def test_u64_high_half_ordering(self):
        a = np.array([0x0000000200000001], np.uint64)
        b = np.array([0x0000000100000002], np.uint64)
        c = it.slot_compare_counts(a, b)
        assert (c.eq, c.lt, c.gt) == (0, 0, 1)


class TestMinHash:
    def test_jaccard_docstring(self):
        a = np.array([1, 2, 3, 4], np.uint32)
        b = np.array([1, 2, 3, 9], np.uint32)
        assert float(it.minhash_jaccard(a, b)) == 0.75
        assert float(it.jaccard_distance(a, b)) == 0.25

    def test_empty_contracts(self):
        z = np.zeros(0, np.uint32)
        assert float(it.minhash_jaccard(z, z)) == 1.0
        assert float(it.jaccard_distance(z, z)) == 0.0

    def test_complementary(self, rng):
        a = rng.integers(0, 8, 128).astype(np.uint32)
        b = rng.integers(0, 8, 128).astype(np.uint32)
        assert float(it.minhash_jaccard(a, b)) + float(
            it.jaccard_distance(a, b)
        ) == pytest.approx(1.0, abs=1e-6)

    def test_minhash_estimates_jaccard(self, rng):
        # Build two sets with known Jaccard ~ 1/3 and MinHash-sketch them.
        universe = np.arange(3000)
        s1 = set(universe[:2000].tolist())
        s2 = set(universe[1000:3000].tolist())
        true_j = len(s1 & s2) / len(s1 | s2)
        k = 256
        seeds = rng.integers(1, 2**31, k).astype(np.uint64)

        def sketch(s):
            items = np.fromiter(s, dtype=np.uint64)

            def h(seed):
                z = (items + seed) * np.uint64(0x9E3779B97F4A7C15)
                z ^= z >> np.uint64(31)
                return np.min(z & np.uint64(0x7FFFFFFF))

            with np.errstate(over="ignore"):
                return np.array([h(seed) for seed in seeds], dtype=np.uint32)

        est = float(it.minhash_jaccard(sketch(s1), sketch(s2)))
        assert est == pytest.approx(true_j, abs=0.1)


class TestBatch:
    def test_batch_slot_hamming(self, rng):
        corpus = rng.integers(0, 4, (50, 64)).astype(np.uint32)
        q = corpus[7]
        got = np.asarray(it.batch_slot_hamming_u32(q, corpus))
        want = np.sum(corpus != q[None, :], axis=1)
        np.testing.assert_array_equal(got, want)


class TestSlotKnn:
    def test_slot_knn_matches_bruteforce(self, rng):
        corpus = rng.integers(0, 8, (200, 64)).astype(np.uint32)
        q = corpus[33]
        counts, idx = it.slot_knn_u32(q, corpus, 5)
        ref = np.sum(corpus != q[None, :], axis=1)
        want = np.argsort(ref, kind="stable")[:5]
        np.testing.assert_array_equal(np.asarray(idx), want)
        np.testing.assert_array_equal(np.asarray(counts), ref[want])
        assert int(np.asarray(idx)[0]) == 33 and int(np.asarray(counts)[0]) == 0

    def test_minhash_knn_similarity(self, rng):
        corpus = rng.integers(0, 8, (100, 32)).astype(np.uint32)
        q = corpus[7]
        sims, idx = it.minhash_knn(q, corpus, 3)
        assert int(np.asarray(idx)[0]) == 7
        assert float(np.asarray(sims)[0]) == 1.0
        assert np.all(np.diff(np.asarray(sims)) <= 0)

    def test_slot_knn_edges(self, rng):
        corpus = rng.integers(0, 8, (5, 16)).astype(np.uint32)
        counts, idx = it.slot_knn_u32(corpus[0], corpus, 0)
        assert len(np.asarray(idx)) == 0
        counts, idx = it.slot_knn_u32(corpus[0], corpus, 50)
        assert len(np.asarray(idx)) == 5

class TestSketchCorpusFused:
    """SketchCorpus slot-kNN (the XLA compare-reduce) vs a host oracle.

    Integer counts get exact equality (fuzz/fuzz_targets/slot_diff.rs
    discipline); index order must match a stable argsort (ties break by
    lower index).
    """

    @pytest.mark.parametrize("n,s,k", [(2500, 128, 5), (3000, 64, 10), (2177, 96, 3)])
    def test_fused_single_query_matches_bruteforce(self, rng, n, s, k):
        corpus = rng.integers(0, 6, (n, s)).astype(np.uint32)
        q = corpus[17]
        counts, idx = it.slot_knn_u32(q, it.SketchCorpus(corpus), k)
        ref = np.sum(corpus != q[None, :], axis=1)
        want = np.argsort(ref, kind="stable")[:k]
        np.testing.assert_array_equal(np.asarray(idx), want)
        np.testing.assert_array_equal(np.asarray(counts), ref[want])

    @pytest.mark.parametrize("n_q,k", [(4, 5), (9, 129)])
    def test_fused_multi_query_matches_bruteforce(self, rng, n_q, k):
        n, s = 2600, 64
        corpus = rng.integers(0, 5, (n, s)).astype(np.uint32)
        qs = corpus[:n_q].copy()
        qs[1, :7] += 1  # one near-duplicate
        counts, idx = it.slot_knn_u32_batch(qs, it.SketchCorpus(corpus), k)
        for qi in range(n_q):
            ref = np.sum(corpus != qs[qi][None, :], axis=1)
            want = np.argsort(ref, kind="stable")[:k]
            np.testing.assert_array_equal(np.asarray(idx)[qi], want)
            np.testing.assert_array_equal(np.asarray(counts)[qi], ref[want])

    def test_fused_ragged_tail_winner(self, rng):
        """Winner planted in the last row must be found."""
        n, s = 2048 + 37, 128
        corpus = rng.integers(0, 1000, (n, s)).astype(np.uint32)
        q = rng.integers(0, 1000, s).astype(np.uint32)
        corpus[n - 1] = q  # in the ragged final block
        counts, idx = it.slot_knn_u32(q, it.SketchCorpus(corpus), 3)
        assert int(np.asarray(idx)[0]) == n - 1
        assert int(np.asarray(counts)[0]) == 0

    def test_container_dispatches_fused_and_matches_jnp(self, rng):
        n, s = 2200, 64
        corpus = rng.integers(0, 4, (n, s)).astype(np.uint32)
        qs = corpus[[3, 1000, 2100]]
        container = it.SketchCorpus(corpus)
        counts_f, idx_f = it.slot_knn_u32_batch(qs, container, 4)
        counts_j, idx_j = it.slot_knn_u32_batch(qs, corpus, 4)  # raw array: jnp path
        np.testing.assert_array_equal(np.asarray(counts_f), np.asarray(counts_j))
        np.testing.assert_array_equal(np.asarray(idx_f), np.asarray(idx_j))

    def test_container_single_query_and_minhash_batch(self, rng):
        n, s = 2100, 32
        corpus = rng.integers(0, 7, (n, s)).astype(np.uint32)
        container = it.SketchCorpus(corpus)
        assert container.num_sketches == n and container.num_slots == s
        assert container.memory_bytes() == n * s * 4  # u32 slots, no copy
        counts, idx = it.slot_knn_u32(corpus[42], container, 2)
        assert int(np.asarray(idx)[0]) == 42 and int(np.asarray(counts)[0]) == 0
        sims, midx = it.minhash_knn_batch(corpus[:3], container, 2)
        assert np.asarray(sims).shape == (3, 2)
        np.testing.assert_array_equal(np.asarray(midx)[:, 0], [0, 1, 2])
        np.testing.assert_allclose(np.asarray(sims)[:, 0], 1.0)

    def test_forced_reference_skips_fused(self, rng, monkeypatch):
        from innr_tpu import config
        from innr_tpu.kernels import triton_knn

        corpus = rng.integers(0, 4, (2100, 32)).astype(np.uint32)
        container = it.SketchCorpus(corpus)

        def boom(*a, **kw):
            raise AssertionError("no kernel may run under force_reference")

        monkeypatch.setattr(triton_knn, "knn_keys", boom)
        try:
            config.force_reference(True)
            counts, idx = it.slot_knn_u32(corpus[9], container, 3)
        finally:
            config.force_reference(False)
        assert int(np.asarray(idx)[0]) == 9

    def test_batch_edges(self, rng):
        corpus = rng.integers(0, 4, (10, 16)).astype(np.uint32)
        counts, idx = it.slot_knn_u32_batch(corpus[:2], corpus, 0)
        assert np.asarray(counts).shape == (2, 0)
        with pytest.raises(it.ContractError):
            it.slot_knn_u32_batch(corpus[0], corpus, 3)  # 1-D queries
        with pytest.raises(it.ContractError):
            it.slot_knn_u32_batch(
                rng.integers(0, 4, (2, 17)).astype(np.uint32), corpus, 3
            )


class TestU16SketchCorpus:
    """u16 (b=16 b-bit MinHash) sketch retrieval: exact parity with the
    u32 oracle semantics at half the bytes."""

    def test_u16_knn_matches_bruteforce(self, rng):
        corpus = rng.integers(0, 1 << 16, (2400, 64)).astype(np.uint16)
        container = it.SketchCorpus(corpus)
        assert container.dtype == jnp.uint16
        assert container.memory_bytes() == 2400 * 64 * 2
        q = corpus[77]
        counts, idx = it.slot_knn_u16(q, container, 5)
        ref = np.sum(corpus != q[None, :], axis=1)
        want = np.argsort(ref, kind="stable")[:5]
        np.testing.assert_array_equal(np.asarray(idx), want)
        np.testing.assert_array_equal(np.asarray(counts), ref[want])
        assert int(np.asarray(idx)[0]) == 77

    def test_u16_batch_and_fused_dispatch(self, rng):
        corpus = rng.integers(0, 1 << 16, (2200, 32)).astype(np.uint16)
        container = it.SketchCorpus(corpus)
        qs = corpus[[3, 1000, 2100]]
        counts_f, idx_f = it.slot_knn_u16_batch(qs, container, 4)
        assert container.sketches.dtype == jnp.uint16
        counts_j, idx_j = it.slot_knn_u16_batch(qs, corpus, 4)  # raw: jnp
        np.testing.assert_array_equal(np.asarray(counts_f), np.asarray(counts_j))
        np.testing.assert_array_equal(np.asarray(idx_f), np.asarray(idx_j))

    def test_minhash_follows_container_dtype(self, rng):
        corpus16 = rng.integers(0, 1 << 16, (2100, 16)).astype(np.uint16)
        c = it.SketchCorpus(corpus16)
        sims, idx = it.minhash_knn_batch(corpus16[:2], c, 2)
        np.testing.assert_array_equal(np.asarray(idx)[:, 0], [0, 1])
        np.testing.assert_allclose(np.asarray(sims)[:, 0], 1.0)

    def test_dtype_mismatch_raises(self, rng):
        corpus16 = it.SketchCorpus(
            rng.integers(0, 1 << 16, (50, 16)).astype(np.uint16)
        )
        with pytest.raises(it.ContractError):
            it.slot_knn_u32(np.zeros(16, np.uint32), corpus16, 3)
        corpus32 = it.SketchCorpus(
            rng.integers(0, 100, (50, 16)).astype(np.uint32)
        )
        with pytest.raises(it.ContractError):
            it.slot_knn_u16(np.zeros(16, np.uint16), corpus32, 3)


class TestNarrowingGuards:
    """Review regressions: wider unsigned sketches must never silently
    wrap through a narrower entry point."""

    def test_u32_array_to_u16_entry_raises(self, rng):
        sk32 = np.array([[0x10000, 2]], np.uint32)  # 65536 wraps to 0 in u16
        with pytest.raises(it.ContractError):
            it.slot_knn_u16(np.zeros(2, np.uint16), sk32, 1)
        with pytest.raises(it.ContractError):
            it.slot_knn_u16_batch(np.zeros((1, 2), np.uint16), sk32, 1)
        with pytest.raises(it.ContractError):
            it.SketchCorpus(sk32, dtype=jnp.uint16)
        from innr_tpu.parallel import ShardedSlotCorpus

        with pytest.raises(it.ContractError):
            ShardedSlotCorpus(sk32, dtype=jnp.uint16)

    def test_u32_query_to_u16_corpus_raises(self, rng):
        sk16 = rng.integers(0, 1 << 16, (50, 8)).astype(np.uint16)
        with pytest.raises(it.ContractError):
            it.slot_knn_u16(np.zeros(8, np.uint32), it.SketchCorpus(sk16), 1)
        from innr_tpu.parallel import ShardedSlotCorpus

        sc = ShardedSlotCorpus(sk16)
        with pytest.raises(it.ContractError):
            sc.knn(np.zeros(8, np.uint32), 1)

    def test_minhash_follows_raw_corpus_dtype(self, rng):
        """A u16 query against a raw u32 corpus must use the u32 width
        (the corpus is authoritative) and raise on the narrowing query."""
        sk32 = rng.integers(0, 2**31, (60, 8)).astype(np.uint32)
        q16 = sk32[3].astype(np.uint16)  # narrower query is fine to widen
        sims, idx = it.minhash_knn(q16, sk32, 2)
        assert np.asarray(idx).shape == (2,)
        # widening u16 -> u32 entry is allowed
        sims2, idx2 = it.slot_knn_u32(q16, sk32, 2)
        assert np.asarray(idx2).shape == (2,)
