"""Numerical edge cases (reference tests/numerical_edge_cases.rs):
denormals, mixed magnitudes, near-zero norms, boundary dims."""

import numpy as np
import pytest

import innr_tpu as it
from innr_tpu.ops import reference as ref
from conftest import cond_tol


class TestDenormals:
    def test_dot_with_subnormals(self):
        sub = np.float32(1e-40)  # subnormal f32
        a = np.full(16, sub, np.float32)
        b = np.full(16, 2.0, np.float32)
        got = float(it.dot(a, b))
        # The device/XLA may flush subnormals to zero; both 0 and the exact value
        # satisfy the contract (result within one subnormal magnitude).
        assert abs(got) <= 16 * 1e-40 * 2.0 * 1.01 + 1e-38

    def test_cosine_subnormal_norms_guarded(self):
        a = np.full(8, np.float32(1e-30), np.float32)
        b = np.full(8, np.float32(1e-30), np.float32)
        # norms ~ 2.8e-30 > 1e-9 is false in squared space (1e-60 < 1e-18)
        assert float(it.cosine(a, b)) == 0.0


class TestMixedMagnitude:
    def test_dot_large_small(self, rng):
        a = np.array([1e20, 1e-20] * 32, np.float32)
        b = np.array([1e-20, 1e20] * 32, np.float32)
        got = float(it.dot(a, b))
        want = ref.dot_portable(a, b)
        assert abs(got - want) <= cond_tol(a, b)

    def test_l2_catastrophic_cancellation(self):
        a = np.full(64, 1e8, np.float32)
        b = np.full(64, 1e8 + 1000.0, np.float32)
        # diff form: (a-b) exactly representable here
        got = float(it.l2_distance_squared(a, b))
        want = ref.l2_distance_squared_portable(a, b)
        assert got == pytest.approx(want, rel=1e-3)

    def test_overflowing_dot_goes_inf(self):
        a = np.full(8, 1e30, np.float32)
        assert np.isinf(float(it.dot(a, a)))


class TestNearZeroNorms:
    @pytest.mark.parametrize("scale", [0.0, 1e-12, 1e-10])
    def test_cosine_guard_engages(self, scale):
        a = np.full(8, np.float32(scale), np.float32)
        b = np.ones(8, np.float32)
        assert float(it.cosine(a, b)) == 0.0

    def test_cosine_guard_releases_above_epsilon(self):
        a = np.full(8, np.float32(1e-3), np.float32)
        b = np.ones(8, np.float32)
        assert float(it.cosine(a, b)) == pytest.approx(1.0, abs=1e-5)

    def test_fast_cosine_same_guard(self):
        a = np.full(8, np.float32(1e-12), np.float32)
        b = np.ones(8, np.float32)
        assert float(it.fast_cosine(a, b)) == 0.0


class TestBoundaryDims:
    """Every historic dispatch-boundary dimension, single sweep
    (reference tests/property_tests.rs:292-360)."""

    @pytest.mark.parametrize("dim", list(range(1, 34)) + [63, 64, 65, 127, 128, 129])
    def test_all_ops_consistent(self, rng, dim):
        a = rng.standard_normal(dim).astype(np.float32)
        b = rng.standard_normal(dim).astype(np.float32)
        assert abs(float(it.dot(a, b)) - ref.dot_portable(a, b)) <= cond_tol(a, b)
        assert float(it.cosine(a, b)) == pytest.approx(
            ref.cosine_portable(a, b), abs=2e-5
        )
        d = a - b
        assert abs(
            float(it.l2_distance_squared(a, b))
            - ref.l2_distance_squared_portable(a, b)
        ) <= cond_tol(d, d)


class TestIdentities:
    def test_l2sq_equals_2_1_minus_cos_for_unit(self, rng):
        # (reference tests/numerical_edge_cases.rs:182)
        for dim in (8, 64, 256, 768):
            a = np.asarray(it.normalize(rng.standard_normal(dim).astype(np.float32)))
            b = np.asarray(it.normalize(rng.standard_normal(dim).astype(np.float32)))
            lhs = float(it.l2_distance_squared(a, b))
            rhs = 2.0 * (1.0 - float(it.cosine(a, b)))
            assert lhs == pytest.approx(rhs, abs=2e-5)

    def test_angular_triangle_inequality(self, rng):
        a, b, c = (rng.standard_normal(32).astype(np.float32) for _ in range(3))
        ab = float(it.angular_distance(a, b))
        bc = float(it.angular_distance(b, c))
        ac = float(it.angular_distance(a, c))
        assert ac <= ab + bc + 1e-5
