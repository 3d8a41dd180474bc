"""Test configuration: CPU backend with 8 virtual devices.

The analog of the reference's CI strategy for hardware it doesn't have
(AVX-512 under Intel SDE emulation, NEON under QEMU —
``.github/workflows/ci.yml:94-115``): every scan runs on the XLA route,
tests that exercise the Triton kernel run it in Pallas interpret mode
(the ``force_triton`` fixture), and the multi-device mesh tests run on 8
virtual CPU devices via ``xla_force_host_platform_device_count``, so the
full suite executes on any machine. Tests that need the card carry the
``gpu`` marker and skip without one (``python chip_smoke.py`` is the
on-card check).
"""

import os

# Must be set before the CPU backend initializes. Something may have
# imported jax already, so set the env AND update jax.config explicitly
# (config wins over a stale env read). chip_smoke.py runs the card-only
# tests inside its own GPU process and sets INNR_TPU_TEST_ON_DEVICE=1 to
# keep its platform.
if os.environ.get("INNR_TPU_TEST_ON_DEVICE") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if os.environ.get("INNR_TPU_TEST_ON_DEVICE") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


# Dims chosen to cross every historic dispatch boundary of the reference
# (1..33 small, SIMD thresholds at 8/16/32/64, large 128..1536 with
# non-multiples; reference tests/simd_correctness.rs:91,114).
BOUNDARY_DIMS = [1, 2, 3, 7, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 768, 1535]


def cond_tol(a, b, scale=32.0):
    """Condition-aware absolute tolerance for a dot-like reduction:
    eps * sum(|a_i * b_i|) (the reference's tolerance discipline,
    src/dense.rs:1285-1290, fuzz/dot_diff.rs:30-36)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = min(a.size, b.size)
    cond = float(np.sum(np.abs(a[:n] * b[:n])))
    eps = np.finfo(np.float32).eps
    return scale * eps * max(cond, 1e-30)


@pytest.fixture
def force_triton(monkeypatch):
    """Returns ``enable()``: from that call on, every dense scan the Triton
    kernel can take goes to the kernel, run in Pallas interpret mode — the
    library's wiring end to end, on the CPU. (Library code never selects
    interpret mode; this fixture does.)"""
    import functools

    from innr_tpu import route as route_mod
    from innr_tpu.kernels import triton_knn

    def route(family, platform, n, k, dtype, n_q, d=None):
        ok = (family == "dense" and 0 < k <= triton_knn.K_MAX
              and d is not None and triton_knn.d_chunk(int(d)) > 0)
        return "triton" if ok else "xla"

    real = triton_knn.knn_keys

    @functools.wraps(real)
    def interpreted(*args, **kwargs):
        return real(*args, **{**kwargs, "interpret": True})

    def enable():
        monkeypatch.setattr(route_mod, "route", route)
        monkeypatch.setattr(triton_knn, "knn_keys", interpreted)

    yield enable
