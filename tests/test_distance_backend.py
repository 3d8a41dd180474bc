"""Distance protocol (reference src/distance.rs) and backend introspection
(reference src/backend.rs)."""

import numpy as np
import pytest

import innr_tpu as it
from innr_tpu import backend, config
from innr_tpu.distance import (
    DistCosine,
    DistDot,
    DistHamming,
    DistL1,
    DistL2,
    DistSlotU32,
)


def _nearest(metric, query, corpus):
    dists = [float(metric.eval(query, row)) for row in corpus]
    return int(np.argmin(dists))


class TestDistance:
    def test_cosine_distance_zero_for_parallel(self):
        d = DistCosine()
        assert float(d.eval([1.0, 0.0], [2.0, 0.0])) == pytest.approx(0.0, abs=1e-6)

    def test_nearest_with_each_metric(self, rng):
        corpus = np.array(
            [[1.0, 0.0], [0.0, 1.0], [0.9, 0.9]], np.float32
        )
        assert _nearest(DistCosine(), np.array([1.0, 0.1], np.float32), corpus) == 0
        assert _nearest(DistL2(), np.array([0.9, 0.9], np.float32), corpus) == 2

    def test_dot_negated(self, rng):
        d = DistDot()
        a = rng.standard_normal(16).astype(np.float32)
        b = rng.standard_normal(16).astype(np.float32)
        assert float(d.eval(a, b)) == pytest.approx(-float(it.dot(a, b)), rel=1e-6)

    def test_l1(self):
        assert float(DistL1().eval([1.0, 2.0], [4.0, 0.0])) == pytest.approx(5.0)

    def test_hamming_over_bytes(self):
        a = np.array([0b1111], np.uint8)
        b = np.array([0b0000], np.uint8)
        assert float(DistHamming().eval(a, b)) == 4.0

    def test_slot_u32_normalized(self):
        a = np.array([1, 2, 3, 4], np.uint32)
        b = np.array([1, 2, 3, 9], np.uint32)
        assert float(DistSlotU32().eval(a, b)) == pytest.approx(0.25)

    def test_eval_batch_matches_eval(self, rng):
        rows = rng.standard_normal((20, 16)).astype(np.float32)
        q = rng.standard_normal(16).astype(np.float32)
        for metric in [DistCosine(), DistDot(), DistL2(), DistL1()]:
            batch = np.asarray(metric.eval_batch(q, rows))
            single = np.array([float(metric.eval(q, r)) for r in rows])
            np.testing.assert_allclose(batch, single, rtol=1e-4, atol=1e-5)

    def test_eval_batch_slot(self, rng):
        rows = rng.integers(0, 4, (10, 32)).astype(np.uint32)
        q = rows[3]
        batch = np.asarray(DistSlotU32().eval_batch(q, rows))
        single = np.array([float(DistSlotU32().eval(q, r)) for r in rows])
        np.testing.assert_allclose(batch, single, rtol=1e-6)


class TestBackend:
    def test_display_strings_stable(self):
        # These strings appear in logs/bug reports; renaming is breaking
        # (reference src/backend.rs:114-120).
        assert str(backend.Backend.TRITON) == "triton"
        assert str(backend.Backend.XLA) == "xla"
        assert str(backend.Backend.REFERENCE) == "reference"
        assert len(backend.Backend) == 3

    def test_batch_backend_thresholds(self, monkeypatch):
        import jax

        assert backend.batch_backend(10) == backend.Backend.XLA
        assert backend.batch_backend(10 ** 7) == backend.Backend.XLA  # CPU
        # On a GPU the report follows the route function.
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert backend.batch_backend(10 ** 7, 10, 32) == backend.Backend.TRITON
        assert backend.batch_backend(10) == backend.Backend.XLA
        assert backend.batch_backend(10 ** 7, 640, 32) == backend.Backend.XLA

    def test_force_reference(self):
        config.force_reference(True)
        try:
            assert backend.dense_backend(768) == backend.Backend.REFERENCE
            assert backend.batch_backend(10**6) == backend.Backend.REFERENCE
            assert backend.slot_backend(128) == backend.Backend.REFERENCE
        finally:
            config.force_reference(False)
        assert backend.dense_backend(768) == backend.Backend.XLA
        assert backend.slot_backend(128) == backend.Backend.XLA

    def test_matmul_precision_knob(self):
        config.set_matmul_precision("default")
        try:
            import jax

            assert config.matmul_precision() == jax.lax.Precision.DEFAULT
        finally:
            config.set_matmul_precision("highest")
        with pytest.raises(ValueError):
            config.set_matmul_precision("bogus")
