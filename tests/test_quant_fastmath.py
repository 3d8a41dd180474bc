"""u8 integer primitives (reference src/quant.rs) and fast math
(reference src/fast_math.rs)."""

import numpy as np
import pytest

import innr_tpu as it
from innr_tpu.ops.reference import dot_u8_portable, hamming_portable


class TestDotU8:
    def test_docstring_case(self):
        assert int(it.dot_u8([1, 2, 3], [4, 5, 6])) == 32

    @pytest.mark.parametrize("n", [1, 15, 16, 31, 32, 33, 63, 64, 65, 768])
    def test_differential(self, rng, n):
        a = rng.integers(0, 256, n).astype(np.uint8)
        b = rng.integers(0, 256, n).astype(np.uint8)
        assert int(it.dot_u8(a, b)) == dot_u8_portable(a, b)

    def test_overflow_safe_to_large_dim(self):
        n = 65000
        a = np.full(n, 255, np.uint8)
        b = np.full(n, 255, np.uint8)
        assert int(it.dot_u8(a, b)) == 255 * 255 * n

    def test_mismatch_raises(self):
        with pytest.raises(it.ContractError):
            it.dot_u8(np.zeros(3, np.uint8), np.zeros(4, np.uint8))

    def test_batch(self, rng):
        corpus = rng.integers(0, 256, (20, 48)).astype(np.uint8)
        q = corpus[3]
        got = np.asarray(it.batch_dot_u8(q, corpus))
        want = corpus.astype(np.uint64) @ q.astype(np.uint64)
        np.testing.assert_array_equal(got, want.astype(np.uint32))


class TestHammingU8:
    def test_docstring_case(self):
        assert int(it.hamming_distance([0b11110000], [0b10101010])) == 4

    @pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 65, 257])
    def test_differential(self, rng, n):
        a = rng.integers(0, 256, n).astype(np.uint8)
        b = rng.integers(0, 256, n).astype(np.uint8)
        assert int(it.hamming_distance(a, b)) == hamming_portable(a, b)

    def test_identical_is_zero(self, rng):
        a = rng.integers(0, 256, 100).astype(np.uint8)
        assert int(it.hamming_distance(a, a)) == 0

    def test_batch(self, rng):
        corpus = rng.integers(0, 256, (30, 32)).astype(np.uint8)
        q = corpus[0]
        got = np.asarray(it.batch_hamming(q, corpus))
        want = np.array([hamming_portable(q, row) for row in corpus])
        np.testing.assert_array_equal(got, want.astype(np.uint32))


class TestFastRsqrt:
    def test_quarter(self):
        assert float(it.fast_rsqrt(4.0)) == pytest.approx(0.5, abs=1e-3)

    def test_accuracy_half_percent(self, rng):
        # One NR iteration: ~0.5% relative error contract
        # (reference src/fast_math.rs:48).
        x = np.abs(rng.standard_normal(1000)).astype(np.float32) * 100 + 1e-3
        got = np.asarray(it.fast_rsqrt(x))
        want = 1.0 / np.sqrt(x.astype(np.float64))
        rel = np.abs(got - want) / want
        assert float(np.max(rel)) < 5e-3

    def test_precise_tighter(self, rng):
        x = np.abs(rng.standard_normal(1000)).astype(np.float32) * 100 + 1e-3
        got = np.asarray(it.fast_rsqrt_precise(x))
        want = 1.0 / np.sqrt(x.astype(np.float64))
        rel = np.abs(got - want) / want
        assert float(np.max(rel)) < 1e-5

    def test_nonpositive_is_zero(self):
        assert float(it.fast_rsqrt(0.0)) == 0.0
        assert float(it.fast_rsqrt(-1.0)) == 0.0
        assert float(it.fast_rsqrt_precise(-2.0)) == 0.0


class TestFastCosine:
    def test_matches_exact_cosine(self, rng):
        a = rng.standard_normal(768).astype(np.float32)
        b = rng.standard_normal(768).astype(np.float32)
        assert float(it.fast_cosine(a, b)) == pytest.approx(
            float(it.cosine(a, b)), abs=1e-5
        )

    def test_mismatch_raises_regardless_of_size(self):
        # Reference src/fast_math.rs:497-503: length-mismatch panic even for
        # tiny inputs (regression: silent truncation).
        with pytest.raises(it.ContractError):
            it.fast_cosine([1.0], [1.0, 2.0])

    def test_small_norm_is_zero(self):
        # Regression: small-norm collapse (reference src/fast_math.rs:533-557).
        tiny = np.full(8, 1e-20, np.float32)
        a = np.ones(8, np.float32)
        assert float(it.fast_cosine(a, tiny)) == 0.0

    def test_dispatch_alias(self, rng):
        a = rng.standard_normal(64).astype(np.float32)
        b = rng.standard_normal(64).astype(np.float32)
        assert float(it.fast_cosine_dispatch(a, b)) == float(it.fast_cosine(a, b))


class TestInt8MXUDecomposition:
    """batch_dot_u8_s8 (zero-point-shifted s8xs8 matmul) must equal the
    int32-widen path EXACTLY for all u8 inputs (survey §2.4 experiment)."""

    def test_exact_equality_random(self, rng):
        from innr_tpu.ops.quant import batch_dot_u8, batch_dot_u8_s8

        corpus = rng.integers(0, 256, (97, 133), dtype=np.uint8)
        q = rng.integers(0, 256, 133, dtype=np.uint8)
        np.testing.assert_array_equal(
            np.asarray(batch_dot_u8_s8(q, corpus)),
            np.asarray(batch_dot_u8(q, corpus)),
        )

    def test_exact_equality_extremes(self):
        from innr_tpu.ops.quant import batch_dot_u8, batch_dot_u8_s8

        corpus = np.array(
            [[0, 255, 128], [255, 255, 255], [0, 0, 0], [127, 129, 1]],
            dtype=np.uint8,
        )
        for q in ([0, 0, 0], [255, 255, 255], [128, 1, 254]):
            q = np.asarray(q, dtype=np.uint8)
            np.testing.assert_array_equal(
                np.asarray(batch_dot_u8_s8(q, corpus)),
                np.asarray(batch_dot_u8(q, corpus)),
            )
