"""Dispatch-arm coverage gate.

The reference's CI coverage job exists to prove "every dispatch arm
executes" (``.github/workflows/ci.yml:174``). innr_tpu's dispatch arms are
the Triton kernel vs the XLA route vs forced-reference per op family
(:mod:`innr_tpu.route`); this module drives each family through all of its
arms and *instruments the kernel entry point* so the gate fails if a
dispatch change silently stops exercising a path — no coverage.py needed.
The Triton arm runs in Pallas interpret mode (the ``force_triton``
fixture).
"""

import numpy as np
import pytest

import innr_tpu as it
from innr_tpu import config


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _record_calls(monkeypatch, module, name, log):
    real = getattr(module, name)

    def wrapper(*a, **kw):
        log.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapper)


class TestDispatchArms:
    def test_backend_reporting_tracks_force_reference(self):
        import jax.numpy as jnp

        from innr_tpu import backend

        # On the CPU every scan takes the XLA route.
        assert backend.batch_backend(10 ** 6) is backend.Backend.XLA
        assert backend.batch_backend(10) is backend.Backend.XLA
        assert backend.dense_backend(128) is backend.Backend.XLA
        try:
            config.force_reference(True)
            assert backend.batch_backend(10 ** 6) is backend.Backend.REFERENCE
            assert backend.dense_backend(128) is backend.Backend.REFERENCE
            assert backend.slot_backend(64) is backend.Backend.REFERENCE
        finally:
            config.force_reference(False)
        assert backend.batch_backend(
            10 ** 6, 10, 32, jnp.bfloat16, 128) is backend.Backend.XLA

    @pytest.mark.parametrize(
        "family,fused_names",
        [("dense", ["knn_keys"]), ("binary", []), ("ternary", []),
         ("u8", ["knn_keys"])],
    )
    def test_all_three_arms_execute(self, rng, monkeypatch, force_triton,
                                    family, fused_names):
        """For each op family: the XLA arm, the Triton arm (where the
        family has a kernel; ``fused_names`` are its entry points) and the
        forced-reference arm all run and produce identical indices; the
        kernel arm is *observed* (instrumented), not assumed."""
        from innr_tpu.kernels import triton_knn

        rows = rng.standard_normal((64, 32)).astype(np.float32)
        q = rows[3] + 0.01 * rng.standard_normal(32).astype(np.float32)
        calls: list = []

        def run():
            if family == "dense":
                vb = it.VerticalBatch.from_rows(rows)
                out = [
                    it.batch_knn_dot(np.stack([q, q]), vb, 3).indices,
                    it.batch_knn(q, vb, 3).indices,
                    it.batch_knn_cosine(np.stack([q, q]), vb, 3).indices,
                ]
                return np.concatenate([np.ravel(o) for o in out])
            if family == "binary":
                corpus = it.PackedBinaryBatch.encode(rows, 0.0)
                qb = it.encode_binary(q, 0.0)
                _, idx = it.binary_knn(qb, corpus, 3)
                return np.asarray(idx)
            if family == "ternary":
                corpus = it.PackedTernaryBatch.encode(rows, 0.2)
                qt = it.encode_ternary(q, 0.2)
                _, idx = it.ternary_knn(qt, corpus, 3)
                return np.asarray(idx)
            params = it.QuantizationParams.fit(rows)
            corpus = it.QuantizedU8Batch.quantize(rows, params)
            res = it.batch_knn_u8(q, corpus, params, 3)
            return np.asarray([i for i, _ in res])

        # Arm 1: the XLA route (the CPU's only route).
        _record_calls(monkeypatch, triton_knn, "knn_keys", calls)
        idx_xla = run()
        assert calls == [], f"kernel ran on the CPU route: {calls}"

        # Arm 2: the Triton kernel (interpret mode).
        force_triton()
        _record_calls(monkeypatch, triton_knn, "knn_keys", calls)
        idx_kernel = run()
        if fused_names:
            assert calls, "kernel arm did not execute"
        else:
            assert calls == [], f"{family} has no kernel: {calls}"
        np.testing.assert_array_equal(idx_kernel, idx_xla)

        # Arm 3: forced reference beats the route.
        calls.clear()
        try:
            config.force_reference(True)
            idx_ref = run()
        finally:
            config.force_reference(False)
        assert calls == [], f"kernel ran while reference forced: {calls}"
        np.testing.assert_array_equal(idx_ref, idx_xla)

    def test_maxsim_both_arms(self, rng, monkeypatch, force_triton):
        """MaxSim has one route (the einsum); forcing the dense kernel
        route must not change it."""
        from innr_tpu.kernels import triton_knn
        from innr_tpu.ops.maxsim import maxsim_knn

        docs = rng.standard_normal((80, 6, 16)).astype(np.float32)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        calls: list = []
        _, idx_xla = maxsim_knn(q, docs, 5)
        force_triton()
        _record_calls(monkeypatch, triton_knn, "knn_keys", calls)
        _, idx_forced = maxsim_knn(q, docs, 5)
        assert calls == []
        np.testing.assert_array_equal(idx_forced, idx_xla)

    def test_slot_all_three_arms(self, rng, monkeypatch, force_triton):
        """Slot-sketch family: the XLA compare-reduce under the default
        route, the forced kernel route (no slot kernel exists) and the
        forced-reference arm all agree exactly (integer counts)."""
        from innr_tpu.kernels import triton_knn

        sketches = rng.integers(0, 8, (64, 32)).astype(np.uint32)
        corpus = it.SketchCorpus(sketches)
        q = sketches[11]
        calls: list = []

        def run():
            _, i1 = it.slot_knn_u32(q, corpus, 3)
            _, i2 = it.slot_knn_u32_batch(sketches[:2], corpus, 3)
            return np.concatenate([np.ravel(np.asarray(i1)), np.ravel(np.asarray(i2))])

        idx_xla = run()
        force_triton()
        _record_calls(monkeypatch, triton_knn, "knn_keys", calls)
        idx_forced = run()
        assert calls == []
        np.testing.assert_array_equal(idx_forced, idx_xla)

        try:
            config.force_reference(True)
            idx_ref = run()
        finally:
            config.force_reference(False)
        np.testing.assert_array_equal(idx_ref, idx_xla)
