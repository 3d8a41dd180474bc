"""Pinned regressions: every real bug rounds 1-3 found, as a permanent
named case (VERDICT r2 item 5 — the analog of the reference's committed
``tests/*.proptest-regressions`` files, which re-run past proptest
failures forever on every machine).

Each test is a hypothesis property whose ``@example`` pins the EXACT
input that originally failed (so the historical case re-runs
deterministically on every machine, alongside generated inputs), or — for
bugs with no natural property — a named deterministic case. The original
bug is described in each docstring.
"""

import numpy as np
import pytest
from hypothesis import example, given, settings, strategies as st

import jax.numpy as jnp

import innr_tpu as it


class TestTombstoneNaNLeakPin:
    """Round-2 review bug: SegmentedCorpus pinned deleted candidates in
    SCORE space (+-inf), which outranked alive NaN-scored rows under IEEE
    total order — a deleted row's placeholder could displace a genuine
    NaN winner. Fixed by pinning in KEY space (INT32_MIN)."""

    @given(
        nan_row=st.integers(0, 2),
        delete_row=st.integers(0, 2),
    )
    @example(nan_row=2, delete_row=0)  # the original failing configuration
    @settings(max_examples=20, deadline=None)
    def test_dead_pin_never_outranks_alive_nan(self, nan_row, delete_row):
        rows = np.eye(3, 4, dtype=np.float32)
        rows[nan_row, 0] = np.nan
        sc = it.SegmentedCorpus(4)
        sc.add(rows)
        sc.delete([delete_row])
        _, ids = sc.knn(np.zeros(4, np.float32), 2)  # L2 ascending
        got = set(np.asarray(ids).tolist())
        assert delete_row not in got
        assert got == {0, 1, 2} - {delete_row}


class TestU16NarrowingPin:
    """Round-2 review bug: passing u32 sketches through the u16 slot-kNN
    API silently truncated every slot to its low 16 bits, corrupting
    similarity estimates. Fixed by a ContractError on any narrowing
    conversion."""

    @given(big=st.integers(1 << 16, (1 << 32) - 1))
    @example(big=0x0001_0000)  # the smallest truncating value
    @settings(max_examples=20, deadline=None)
    def test_u32_sketches_rejected_by_u16_api(self, big):
        sk = np.full((4, 8), big, dtype=np.uint32)
        with pytest.raises(it.ContractError):
            it.slot_knn_u16(sk[0], sk, 2)


class TestRaggedTailWinnerPin:
    """Bug class: the unpadded (ragged) final block of the Triton scan
    must still surface winners — out-of-range rows are masked to INT_MIN,
    but real rows in the tail block are live. The pin plants the global
    winner just past a block boundary (kernel in interpret mode)."""

    @given(extra=st.integers(1, 9))
    @example(extra=1)  # n = tile boundary + 1, the original case
    @settings(max_examples=5, deadline=None)
    def test_tail_winner_found(self, extra):
        from innr_tpu.kernels import triton_knn

        rng = np.random.default_rng(0)
        n = 1024 + extra
        rows = rng.standard_normal((n, 32)).astype(np.float32)
        q = rng.standard_normal(32).astype(np.float32)
        rows[-1] = q * 10
        _, idx = triton_knn.knn_keys(jnp.asarray(q)[None, :], jnp.asarray(rows),
                                     None, 3, "dot", block_n=512,
                                     interpret=True)
        assert int(np.asarray(idx)[0, 0]) == n - 1


class TestStaleAbiRebuildPin:
    """Round-2 bug: environments holding a previously built native .so
    from an older revision silently lost the entire native runtime (the
    loader saw an ABI mismatch and gave up forever). The loader now
    deletes and rebuilds a stale library in place."""

    def test_stale_library_is_rebuilt(self, tmp_path, monkeypatch):
        import innr_tpu._native as nat

        stale = tmp_path / "libinnr_host.so"
        stale.write_bytes(b"\x7fELF not a real library")
        # _try_build reads the module-global _LIB_PATH, so the rebuild
        # lands on our corrupt file; clear the process-level cache so
        # _load actually exercises the path.
        monkeypatch.setattr(nat, "_LIB_PATH", stale)
        monkeypatch.setattr(nat, "_lib", None)
        built = {"n": 0}
        real_build = nat._try_build

        def counting_build():
            built["n"] += 1
            return real_build()

        monkeypatch.setattr(nat, "_try_build", counting_build)
        lib = nat._load()
        # The loader must ATTEMPT a rebuild over the corrupt file rather
        # than giving up forever; with a working toolchain the rebuilt
        # library must then load with the current ABI.
        assert built["n"] >= 1
        if lib is not None:
            assert lib.innr_native_abi_version() == 3


class TestSparseTupleAmbiguityPin:
    """Round-2 review bug: a tuple of exactly two (indices, values)
    document pairs was misread as a pre-padded ((N, L), (N, L)) corpus,
    silently producing garbage joins. The pin is the exact ambiguous
    input; it must parse as a 2-document list."""

    def test_two_doc_tuple_is_a_doc_list(self):
        d0 = (np.array([1, 5], np.uint32), np.array([1.0, 2.0], np.float32))
        d1 = (np.array([2], np.uint32), np.array([3.0], np.float32))
        corpus = it.SparseCorpus((d0, d1))  # tuple of two PAIRS
        assert corpus.num_docs == 2
        vals, idx = corpus.knn((d1[0], d1[1]), 1)
        assert int(np.asarray(idx)[0]) == 1
        assert float(np.asarray(vals)[0]) == pytest.approx(9.0)

    def test_padded_pair_still_parses_as_padded(self):
        idx = np.array([[1, 5], [2, 0xFFFFFFFF]], np.uint32)
        val = np.array([[1.0, 2.0], [3.0, 0.0]], np.float32)
        corpus = it.SparseCorpus((idx, val))
        assert corpus.num_docs == 2 and corpus.width == 2


class TestBenchBf16Gate:
    """bench.py must FAIL (structured error line + rc 1) when bf16
    headline fidelity drops below the overlap floor — the north-star
    number can never silently ride a degraded half-precision mode. The
    real main() runs with every measuring stage stubbed; only the gate
    logic is live."""

    def _run_main(self, monkeypatch, capsys, parity):
        import sys as _sys

        import bench

        monkeypatch.setattr(bench, "_device", lambda: {"platform": "gpu"})
        monkeypatch.setattr(bench, "_card", lambda: "stub card")
        monkeypatch.setattr(bench, "bench_knn_dot", lambda **kw: 1e9)
        monkeypatch.setattr(bench, "bench_u8", lambda **kw: 1e9)
        monkeypatch.setattr(bench, "bench_bf16_parity", lambda **kw: parity)
        monkeypatch.setattr(_sys, "argv", ["bench.py", "--n", "1000"])
        try:
            bench.main()
            code = 0
        except SystemExit as e:
            code = e.code
        out = capsys.readouterr().out
        return code, out

    def test_degraded_overlap_trips_gate(self, monkeypatch, capsys):
        import json as _json

        code, out = self._run_main(monkeypatch, capsys, parity=0.83)
        assert code == 1
        line = _json.loads(out.strip().splitlines()[-1])
        assert line["value"] is None
        assert "overlap" in line["error"]
        assert line["stage"] == "bf16_parity"

    def test_healthy_overlap_passes_gate(self, monkeypatch, capsys):
        import json as _json

        code, out = self._run_main(monkeypatch, capsys, parity=0.99)
        assert code == 0
        line = _json.loads(out.strip().splitlines()[-1])
        assert line["value"] == 1_000_000_000
        sub = line["submetrics"]
        assert sub["bf16_vs_f32_top10_overlap"] == 0.99
        assert sub["u8_1M_768d_evals_per_s"] == 1e9
