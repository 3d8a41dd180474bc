"""Dense f32 ops: exact values, contracts, and differential tests vs the
NumPy reference oracles (the portable-layer analog of reference
tests/simd_correctness.rs)."""

import numpy as np
import pytest

import innr_tpu as it
from innr_tpu.ops import reference as ref
from conftest import BOUNDARY_DIMS, cond_tol


def _vec(rng, n, scale=1.0):
    return (rng.standard_normal(n) * scale).astype(np.float32)


class TestExactValues:
    def test_dot_basic(self):
        assert float(it.dot([1.0, 2.0, 3.0], [4.0, 5.0, 6.0])) == pytest.approx(32.0)

    def test_norm(self):
        assert float(it.norm([3.0, 4.0])) == pytest.approx(5.0)

    def test_cosine_orthogonal(self):
        assert float(it.cosine([1.0, 0.0], [0.0, 1.0])) == pytest.approx(0.0, abs=1e-6)

    def test_cosine_parallel(self):
        assert float(it.cosine([1.0, 0.0], [2.0, 0.0])) == pytest.approx(1.0, rel=1e-6)

    def test_l2(self):
        assert float(it.l2_distance([0.0, 0.0], [3.0, 4.0])) == pytest.approx(5.0)

    def test_l2_squared(self):
        assert float(it.l2_distance_squared([0.0, 0.0], [3.0, 4.0])) == pytest.approx(25.0)

    def test_l1(self):
        assert float(it.l1_distance([1.0, 2.0], [4.0, 0.0])) == pytest.approx(5.0)

    def test_angular_orthogonal(self):
        assert float(it.angular_distance([1.0, 0.0], [0.0, 1.0])) == pytest.approx(0.5, abs=1e-6)

    def test_normalize(self):
        out = np.asarray(it.normalize([3.0, 4.0]))
        np.testing.assert_allclose(out, [0.6, 0.8], rtol=1e-6)

    def test_normalize_with_norm(self):
        out, n = it.normalize_with_norm([3.0, 4.0])
        assert float(n) == pytest.approx(5.0)
        assert float(it.norm(out)) == pytest.approx(1.0, rel=1e-6)


class TestContracts:
    """Crate-wide contracts, reference src/lib.rs:34-46."""

    def test_length_mismatch_raises(self):
        for fn in (it.dot, it.cosine, it.l1_distance, it.l2_distance,
                   it.l2_distance_squared):
            with pytest.raises(it.ContractError):
                fn([1.0, 2.0], [1.0, 2.0, 3.0])

    def test_empty_inputs_zero(self):
        z = np.zeros((0,), np.float32)
        assert float(it.dot(z, z)) == 0.0
        assert float(it.norm(z)) == 0.0
        assert float(it.cosine(z, z)) == 0.0
        assert float(it.l1_distance(z, z)) == 0.0

    def test_zero_norm_cosine_is_zero(self):
        a = np.array([1.0, 2.0], np.float32)
        zero = np.zeros(2, np.float32)
        assert float(it.cosine(a, zero)) == 0.0
        assert float(it.cosine(zero, zero)) == 0.0

    def test_tiny_norm_cosine_is_zero(self):
        tiny = np.full(4, 1e-12, np.float32)
        a = np.ones(4, np.float32)
        assert float(it.cosine(a, tiny)) == 0.0

    def test_nan_propagates_through_dot_and_distances(self):
        a = np.array([1.0, np.nan], np.float32)
        b = np.array([1.0, 1.0], np.float32)
        assert np.isnan(float(it.dot(a, b)))
        assert np.isnan(float(it.l2_distance(a, b)))
        assert np.isnan(float(it.l1_distance(a, b)))

    def test_cosine_absorbs_nan(self):
        a = np.array([1.0, np.nan], np.float32)
        b = np.array([1.0, 1.0], np.float32)
        assert float(it.cosine(a, b)) == 0.0

    def test_normalize_zero_vector_unchanged(self):
        zero = np.zeros(3, np.float32)
        out, n = it.normalize_with_norm(zero)
        np.testing.assert_array_equal(np.asarray(out), zero)
        assert float(n) == 0.0


class TestDifferential:
    """Device ops vs NumPy oracles at condition-aware tolerances over
    boundary-crossing dimensions."""

    @pytest.mark.parametrize("dim", BOUNDARY_DIMS)
    def test_dot(self, rng, dim):
        a, b = _vec(rng, dim), _vec(rng, dim)
        got = float(it.dot(a, b))
        want = ref.dot_portable(a, b)
        assert abs(got - want) <= cond_tol(a, b)

    @pytest.mark.parametrize("dim", BOUNDARY_DIMS)
    def test_cosine(self, rng, dim):
        a, b = _vec(rng, dim), _vec(rng, dim)
        got = float(it.cosine(a, b))
        want = ref.cosine_portable(a, b)
        assert got == pytest.approx(want, abs=1e-5)

    @pytest.mark.parametrize("dim", BOUNDARY_DIMS)
    def test_l2_squared(self, rng, dim):
        a, b = _vec(rng, dim), _vec(rng, dim)
        got = float(it.l2_distance_squared(a, b))
        want = ref.l2_distance_squared_portable(a, b)
        assert abs(got - want) <= cond_tol(a - b, a - b)

    @pytest.mark.parametrize("dim", BOUNDARY_DIMS)
    def test_l1(self, rng, dim):
        a, b = _vec(rng, dim), _vec(rng, dim)
        got = float(it.l1_distance(a, b))
        want = ref.l1_distance_portable(a, b)
        assert abs(got - want) <= cond_tol(a - b, np.ones_like(a))

    def test_mixed_magnitudes(self, rng):
        a = np.concatenate([
            _vec(rng, 64, 1e6), _vec(rng, 64, 1e-6), _vec(rng, 64)
        ]).astype(np.float32)
        b = np.concatenate([
            _vec(rng, 64, 1e-6), _vec(rng, 64, 1e6), _vec(rng, 64)
        ]).astype(np.float32)
        got = float(it.dot(a, b))
        want = ref.dot_portable(a, b)
        assert abs(got - want) <= cond_tol(a, b)


class TestMatryoshka:
    def test_prefix_equals_sliced(self, rng):
        a, b = _vec(rng, 16), _vec(rng, 16)
        got = float(it.matryoshka_dot(a, b, 5))
        want = float(it.dot(a[:5], b[:5]))
        assert got == pytest.approx(want, rel=1e-6)

    def test_full_prefix_equals_full(self, rng):
        a, b = _vec(rng, 16), _vec(rng, 16)
        assert float(it.matryoshka_dot(a, b, 16)) == pytest.approx(
            float(it.dot(a, b)), rel=1e-6
        )

    def test_prefix_clamped(self, rng):
        a, b = _vec(rng, 8), _vec(rng, 8)
        assert float(it.matryoshka_dot(a, b, 100)) == pytest.approx(
            float(it.dot(a, b)), rel=1e-6
        )

    def test_matryoshka_cosine(self, rng):
        a = np.array([1.0, 0.0, 0.0, 1.0], np.float32)
        b = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
        assert float(it.matryoshka_cosine(a, b, 2)) == pytest.approx(0.0, abs=1e-6)


class TestMetricLaws:
    """Metric-law property tests (reference src/dense.rs:1064-1318)."""

    def test_dot_commutative(self, rng):
        a, b = _vec(rng, 128), _vec(rng, 128)
        assert float(it.dot(a, b)) == float(it.dot(b, a))

    def test_l2_triangle_inequality(self, rng):
        a, b, c = _vec(rng, 64), _vec(rng, 64), _vec(rng, 64)
        ab = float(it.l2_distance(a, b))
        bc = float(it.l2_distance(b, c))
        ac = float(it.l2_distance(a, c))
        assert ac <= ab + bc + 1e-4

    def test_l2sq_identity_for_normalized(self, rng):
        # ||a-b||^2 = 2(1 - cos) for unit vectors
        # (reference tests/numerical_edge_cases.rs:182).
        a = np.asarray(it.normalize(_vec(rng, 256)))
        b = np.asarray(it.normalize(_vec(rng, 256)))
        lhs = float(it.l2_distance_squared(a, b))
        rhs = 2.0 * (1.0 - float(it.cosine(a, b)))
        assert lhs == pytest.approx(rhs, abs=1e-5)

    def test_cosine_range(self, rng):
        for _ in range(20):
            a, b = _vec(rng, 97), _vec(rng, 97)
            c = float(it.cosine(a, b))
            assert -1.0 - 1e-5 <= c <= 1.0 + 1e-5
