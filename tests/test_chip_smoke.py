"""chip_smoke.py: it refuses to run without a GPU or outside its checkout,
and every phase runs end to end on the CPU at a tiny scale (the rehearsal
of a chip call), with the Triton kernel in interpret mode."""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    out = _run(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_exits_nonzero_outside_its_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture
def smoke(force_triton):
    force_triton()
    mod = _load()
    return mod, mod.Smoke(0, "cpu rehearsal", 1e11)


def test_phase_dense(smoke):
    mod, s = smoke
    mod.phase_dense(s, scale=10_000)


def test_phase_timings(smoke):
    mod, s = smoke
    mod.phase_timings(s, scale=20_000)


def test_phase_served(smoke):
    mod, s = smoke
    mod.phase_served(s, scale=5_000)


def test_phase_prune(smoke):
    mod, s = smoke
    mod.phase_prune(s, scale=2_000)


def test_phase_families(smoke):
    mod, s = smoke
    mod.phase_families(s, scale=10_000)


def test_phase_four(smoke):
    mod, s = smoke
    mod.phase_four(s, scale=20_000, check_memory=False)


def test_check_same_rejects_different_scores():
    mod = _load()
    import numpy as np

    with pytest.raises(AssertionError):
        mod.check_same("x", np.array([[1, 2]]), np.array([[3.0, 2.0]]),
                       np.array([[1, 2]]), np.array([[3.0, 1.0]]))


def test_check_vs_oracle_rejects_a_wrong_neighbour():
    mod = _load()
    import numpy as np

    truth = np.array([[5.0, 4.0, 3.0, 2.0]])
    tol = np.full_like(truth, 1e-6)
    mod.check_vs_oracle("ok", np.array([[0, 1]]), np.array([[5.0, 4.0]]),
                        truth, tol, True)
    with pytest.raises(AssertionError):
        mod.check_vs_oracle("bad", np.array([[0, 2]]), np.array([[5.0, 3.0]]),
                            truth, tol, True)
