"""Multi-host smoke test: two local CPU processes, four virtual devices
each, one global 8-device mesh (survey §5.8 — DCN across slices is the
same code path; only the transport differs, and XLA owns the transport).

Each worker holds HALF the corpus (no process materializes the full
array), assembles a global ShardedCorpus via
``corpus_from_process_local_rows``, and runs the distributed kNN; process
0 checks parity against a NumPy brute force of the full corpus.
"""

import socket
import subprocess

import numpy as np
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np

    pid, port = int(sys.argv[1]), sys.argv[2]
    import jax
    jax.config.update("jax_platforms", "cpu")

    # distributed.initialize must precede ANY backend touch, so it comes
    # before importing innr_tpu (multihost.initialize wraps the same call
    # for production use; the env vars route through it below).
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = str(pid)
    from innr_tpu.parallel.multihost import (
        corpus_from_process_local_rows, initialize, is_multiprocess,
    )

    initialize()
    assert is_multiprocess()
    assert jax.process_count() == 2
    assert jax.device_count() == 8, jax.device_count()

    rng = np.random.default_rng(0)
    full = rng.standard_normal((64, 16)).astype(np.float32)
    local = full[pid * 32 : (pid + 1) * 32]  # half the corpus per process
    corpus = corpus_from_process_local_rows(local, n_total=64)
    assert corpus.num_vectors == 64

    q = full[5]
    vals, idx = corpus.knn_dot(q, 3)
    got = list(np.asarray(idx))
    vals_l2, idx_l2 = corpus.knn_l2(q, 3)
    got_l2 = list(np.asarray(idx_l2))

    if pid == 0:
        dots = full.astype(np.float64) @ q.astype(np.float64)
        expect = list(np.argsort(-dots, kind="stable")[:3])
        assert got == expect, (got, expect)
        assert got_l2[0] == 5, got_l2
        print("MULTIHOST OK")
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_knn(tmp_path):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), str(port)],
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env={
                **__import__("os").environ,
                "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            },
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process smoke test timed out")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "MULTIHOST OK" in outs[0], outs[0][-3000:]


class TestSingleProcessArms:
    """The in-process arms of multihost.py (no cluster needed): env
    parsing, already-initialized short-circuit, contract errors, and the
    final-process padding path — named coverage for every branch the
    2-process smoke can't see from the parent (VERDICT r3 item 7)."""

    def test_initialize_noop_without_config(self, monkeypatch):
        import jax

        from innr_tpu.parallel import multihost

        for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                    "JAX_PROCESS_ID"):
            monkeypatch.delenv(var, raising=False)
        assert jax._src.distributed.global_state.client is None
        multihost.initialize()  # single-host: must be a silent no-op
        assert jax._src.distributed.global_state.client is None
        assert not multihost.is_multiprocess()

    def test_initialize_noop_when_already_up(self, monkeypatch):
        import jax

        from innr_tpu.parallel import multihost

        monkeypatch.setattr(
            jax._src.distributed.global_state, "client", object()
        )
        # Would raise if it tried to re-initialize with no coordinator.
        multihost.initialize()

    def test_local_rows_must_be_2d(self):
        from innr_tpu.parallel import multihost

        import innr_tpu as it2

        with pytest.raises(it2.ContractError):
            multihost.corpus_from_process_local_rows(
                np.zeros(8, np.float32)
            )

    def test_single_process_defaults_and_padding(self, rng):
        # process_count()==1: n_total defaults to local rows; 13 rows on
        # an 8-device mesh forces the final-process padding arm; padded
        # rows must never win.
        from innr_tpu.parallel import multihost

        rows = rng.standard_normal((13, 16)).astype(np.float32)
        corpus = multihost.corpus_from_process_local_rows(rows)
        assert corpus.num_vectors == 13
        q = rows[11]
        vals, idx = corpus.knn_dot(q, 13)
        assert sorted(np.asarray(idx).tolist()) == list(range(13))


class TestMultihostSweepSurvivors:
    """Killers for the multihost.py exhaustive-sweep survivors (round 4):
    initialize()'s arg/env precedence and the final-process padding
    policy, both pinned with recorders (no cluster needed)."""

    def test_initialize_explicit_args_win(self, monkeypatch):
        # multihost.py:63 [boolop Or -> And]: an explicit coordinator
        # address must reach jax.distributed.initialize even with no env
        # var set (the mutant demotes it to None). Env vars for the other
        # two are set to DIFFERENT values: explicit arguments win
        # (:66/:68 And -> Or would read the env instead).
        import jax

        from innr_tpu.parallel import multihost

        rec = {}

        def recorder(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None):
            rec.update(addr=coordinator_address, num=num_processes,
                       pid=process_id)

        monkeypatch.setattr(jax.distributed, "initialize", recorder)
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        monkeypatch.setenv("JAX_NUM_PROCESSES", "7")
        monkeypatch.setenv("JAX_PROCESS_ID", "9")
        multihost.initialize("host:1234", num_processes=2, process_id=0)
        assert rec == {"addr": "host:1234", "num": 2, "pid": 0}

    def test_initialize_env_coordinator_used(self, monkeypatch):
        # multihost.py:63 the other direction: env-only coordinator must
        # be picked up when the argument is absent.
        import jax

        from innr_tpu.parallel import multihost

        rec = {}

        def recorder(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None):
            rec.update(addr=coordinator_address)

        monkeypatch.setattr(jax.distributed, "initialize", recorder)
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "env-host:9")
        monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
        monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
        multihost.initialize(num_processes=2, process_id=0)
        assert rec == {"addr": "env-host:9"}

    def test_initialize_coordinator_only_initializes(self, monkeypatch):
        # multihost.py:70 [boolop And -> Or]: coordinator given but
        # num_processes absent must STILL initialize (pods
        # auto-discover the rest); the mutant early-returns.
        import jax

        from innr_tpu.parallel import multihost

        called = []
        monkeypatch.setattr(
            jax.distributed, "initialize",
            lambda **kw: called.append(kw),
        )
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
        monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
        multihost.initialize("host:1234")
        assert len(called) == 1
        assert called[0]["coordinator_address"] == "host:1234"

    def test_final_process_padding_policy(self, monkeypatch):
        # multihost.py:113 [boolop And -> Or] (and the rest of the
        # padding-arm sites): ONLY the final process pads its block, and
        # pads it by exactly n_pad - owned rows. Fake a 2-process world
        # and record what reaches make_array_from_process_local_data.
        import jax

        from innr_tpu.parallel import multihost

        rec = {}

        def recorder(sharding, local, global_shape):
            rec["local_shape"] = tuple(local.shape)
            rec["global_shape"] = tuple(global_shape)
            return object()

        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(
            jax, "make_array_from_process_local_data", recorder
        )
        local = np.ones((5, 2), np.float32)

        # Non-final process: NO padding, ever (the mutant pads here).
        monkeypatch.setattr(jax, "process_index", lambda: 0)
        corpus = multihost.corpus_from_process_local_rows(local)
        assert rec["local_shape"] == (5, 2)
        assert rec["global_shape"] == (16, 2)  # round_up(10, 8 devices)
        assert corpus.n_true == 10 and corpus.n_pad == 16

        # Final process: pads by exactly n_pad - owned = 6 rows.
        monkeypatch.setattr(jax, "process_index", lambda: 1)
        multihost.corpus_from_process_local_rows(local)
        assert rec["local_shape"] == (11, 2)
        assert rec["global_shape"] == (16, 2)
