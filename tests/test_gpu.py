"""Card-only checks of the Triton kernel, compiled for the GPU (no
interpret mode): agreement with the XLA route in every mode and dtype,
planted ties resolving to the lower index, NaN sorting greatest, and the
tile-skip scan equal to the full scan.

Each test skips without an NVIDIA GPU; ``python chip_smoke.py`` runs them
on the card (phase 2).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from innr_tpu import prune, scan
from innr_tpu.kernels import triton_knn

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run by chip_smoke.py on the card")


def _rows(dtype, n, d, seed=0):
    key = jax.random.PRNGKey(seed)
    if dtype == jnp.uint8:
        return jax.random.randint(key, (n, d), 0, 256, jnp.int32).astype(dtype)
    return jax.random.normal(key, (n, d), jnp.float32).astype(dtype)


@pytest.mark.parametrize("n_q", [1, 4, 32])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.uint8])
@pytest.mark.parametrize("mode", ["dot", "l2", "cosine", "l2m"])
def test_kernel_matches_xla_route(gpu, mode, dtype, n_q):
    n, d, k = 300_000, 128, 10
    rows = _rows(dtype, n, d)
    qs = jax.random.normal(jax.random.PRNGKey(1), (n_q, d), jnp.float32)
    r32 = rows.astype(jnp.float32)
    aux = None
    if mode.startswith("l2"):
        aux = jnp.sum(r32 * r32, axis=1)
    if mode == "cosine":
        aux = scan.inv_norms(rows)
        qs = scan.unit_queries(qs)
    if mode == "l2m":
        mask = jax.random.bernoulli(jax.random.PRNGKey(2), 0.5, (n,))
        aux = jnp.stack([aux, mask.astype(jnp.float32)])
    tv, ti = scan.knn(qs, rows, aux, k, mode, route="triton")
    xv, xi = scan.knn(qs, rows, aux, k, mode, route="xla")
    tv, xv = np.asarray(tv), np.asarray(xv)
    scale = float(np.max(np.abs(xv)))
    np.testing.assert_allclose(tv, xv, rtol=0, atol=1e-5 * scale)
    diff = np.asarray(ti) != np.asarray(xi)
    # Index differences only where the two scores tie within tolerance.
    assert np.all(np.abs(tv - xv)[diff] <= 1e-5 * scale)


@pytest.mark.parametrize("n_q", [1, 4, 32])
def test_bf16_xla_route_products_are_exact(gpu, n_q):
    """XLA on the GPU must not round bf16 products to bf16 (a one-query
    dot once did without Precision.HIGHEST)."""
    rows = _rows(jnp.bfloat16, 200_000, 128)
    qs = jax.random.normal(jax.random.PRNGKey(10), (n_q, 128), jnp.float32)
    got = np.asarray(scan.dots(qs, rows), np.float64)
    q64 = np.asarray(scan.round_bf16(qs), np.float64)
    r64 = np.asarray(rows.astype(jnp.float32), np.float64)
    err = np.abs(got - q64 @ r64.T) / (np.abs(q64) @ np.abs(r64).T)
    assert err.max() < 1e-6


def test_planted_ties_resolve_to_lower_index(gpu):
    base = jax.random.normal(jax.random.PRNGKey(3), (1000, 128), jnp.float32)
    rows = jnp.tile(base, (300, 1))               # every row 300 times
    qs = jax.random.normal(jax.random.PRNGKey(4), (8, 128), jnp.float32)
    _, ti = scan.knn(qs, rows, None, 10, "dot", route="triton")
    _, xi = scan.knn(qs, rows, None, 10, "dot", route="xla")
    ti, xi = np.asarray(ti), np.asarray(xi)
    best = np.argmax(np.asarray(qs) @ np.asarray(base).T, axis=1)
    np.testing.assert_array_equal(ti, xi)
    np.testing.assert_array_equal(ti[:, 0], best)
    np.testing.assert_array_equal(ti[:, 1], best + 1000)


def test_nan_sorts_greatest(gpu):
    rows = _rows(jnp.float32, 200_000, 128)
    rows = rows.at[123_457].set(jnp.nan)
    qs = jax.random.normal(jax.random.PRNGKey(5), (3, 128), jnp.float32)
    tv, ti = scan.knn(qs, rows, None, 5, "dot", route="triton")
    assert np.all(np.asarray(ti)[:, 0] == 123_457)
    assert np.all(np.isnan(np.asarray(tv)[:, 0]))
    lv, li = scan.knn(qs, rows, jnp.sum(rows * rows, axis=1), 5, "l2",
                      route="triton")
    assert 123_457 not in np.asarray(li)


def test_planned_scan_equals_full_scan(gpu):
    # One cluster per 4096-row tile, so the plan must skip tiles.
    n, d, c = 512 * 4096, 128, 512
    centers = 3.0 * jax.random.normal(jax.random.PRNGKey(6), (c, d))
    assign = jnp.repeat(jnp.arange(c), n // c)
    rows = centers[assign] + 0.1 * jax.random.normal(jax.random.PRNGKey(8), (n, d))
    qs = centers[:16] + 0.1 * jax.random.normal(jax.random.PRNGKey(9), (16, d))
    tile = triton_knn.block_rows(n)
    s = prune.build_tile_summary(rows, tile)
    pv, pi = scan.planned_knn(qs, rows, None, s, 10, "dot", route="triton")
    fv, fi = scan.knn(qs, rows, None, 10, "dot", route="triton")
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))
    np.testing.assert_array_equal(np.asarray(pv), np.asarray(fv))
    _, n_surv = prune.plan_survivors(qs, s.centroids, s.radii, s.counts, 10, "dot")
    assert int(n_surv) < s.n_tiles
