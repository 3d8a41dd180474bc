"""The routing function, the XLA route's building blocks, and the Triton
kernel's wrapper (padding, blocks, lowering) — all CPU-checkable.

The kernel runs in Pallas interpret mode here, which these tests ask for
explicitly; its lowering to Triton IR for CUDA is checked without a card.
"""

import itertools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from innr_tpu import config, route, scan
from innr_tpu.kernels import triton_knn
from innr_tpu.utils.order import top_k_keys

BIG = route.TRITON_MIN_ROWS


class TestRouteFunction:
    @pytest.mark.parametrize(
        "platform,n,k,dtype,n_q",
        list(itertools.product(
            ["cpu", "gpu"],
            [BIG - 1, BIG, 20_000_000],
            [1, route.TRITON_MAX_K, route.TRITON_MAX_K + 1],
            [jnp.float32, jnp.bfloat16, jnp.uint8],
            [1, route.TRITON_MAX_Q],
        )),
    )
    def test_dense_grid(self, platform, n, k, dtype, n_q):
        got = route.route("dense", platform, n, k, dtype, n_q, 128)
        # A u8 corpus of 2**31 or more codes (20M x 128) stays on XLA.
        fits = dtype != jnp.uint8 or n * 128 < 2**31
        want = ("triton" if platform == "gpu" and n >= BIG
                and k <= route.TRITON_MAX_K and fits else "xla")
        assert got == want

    @pytest.mark.parametrize("family", [f for f in route.FAMILIES if f != "dense"])
    @pytest.mark.parametrize("platform", ["cpu", "gpu"])
    def test_other_families_are_xla(self, family, platform):
        assert route.route(family, platform, 10**8, 10, jnp.float32, 16,
                           128) == "xla"

    @pytest.mark.parametrize("n_q,d,dtype,want", [
        (route.TRITON_MAX_Q, 128, jnp.float32, "triton"),
        (route.TRITON_MAX_Q + 1, 128, jnp.float32, "xla"),
        (4, 100, jnp.float32, "xla"),     # no 16-wide chunk divides 100
        (4, 96, jnp.float32, "triton"),   # 96 = 3 x 32
        (4, 768, jnp.uint8, "triton"),
        (4, 128, jnp.int8, "xla"),
        (4, None, jnp.float32, "xla"),
        (0, 128, jnp.float32, "xla"),
    ])
    def test_queries_width_dtype(self, n_q, d, dtype, want):
        assert route.route("dense", "gpu", BIG, 10, dtype, n_q, d) == want

    @pytest.mark.parametrize("n,d,dtype,want", [
        (2**31 // 768, 768, jnp.uint8, "triton"),      # just under 2**31 codes
        (2**31 // 768 + 1, 768, jnp.uint8, "xla"),     # 32-bit offsets wrap
        (2**32 // 768 + 1, 768, jnp.uint8, "triton"),  # past 4 GiB: 64-bit
        (20_000_000, 128, jnp.bfloat16, "triton"),     # 5.12 GB: 64-bit
        (16_000_000, 128, jnp.float32, "triton"),      # 2.05e9 elements
    ])
    def test_offset_width_limit(self, n, d, dtype, want):
        assert route.route("dense", "gpu", n, 10, dtype, 32, d) == want
        assert triton_knn.offsets_fit(n, d, dtype) == (want == "triton")

    def test_unknown_family_raises(self):
        with pytest.raises(ValueError):
            route.route("bogus", "gpu", 10, 1, jnp.float32, 1, 16)

    def test_current_route_is_xla_on_cpu_and_under_reference(self, monkeypatch):
        assert route.current_route("dense", 10**8, 10, jnp.float32, 4, 128) == "xla"
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert route.current_route("dense", 10**8, 10, jnp.float32, 4, 128) == "triton"
        config.force_reference(True)
        try:
            assert route.current_route("dense", 10**8, 10, jnp.float32, 4,
                                       128) == "xla"
        finally:
            config.force_reference(False)


class TestKernelGeometry:
    @pytest.mark.parametrize("d,want", [(128, 128), (768, 128), (96, 32),
                                        (48, 16), (16, 16), (100, 0), (8, 0),
                                        (1536, 128), (1, 0)])
    def test_d_chunk(self, d, want):
        assert triton_knn.d_chunk(d) == want

    @pytest.mark.parametrize("n,want", [(1, 1024), (1_000_000, 2048),
                                        (2_000_000, 4096),
                                        (20_000_000, 4096)])
    def test_block_rows(self, n, want):
        b = triton_knn.block_rows(n)
        assert b == want and b % triton_knn.SUB_N == 0


class TestTopKKeys:
    @pytest.mark.parametrize("shape,k,chunk", [
        ((3, 1000), 7, 64), ((2, 1001), 5, 100), ((2, 5000), 64, 128),
        ((4, 640), 10, 64), ((2, 129), 1, 32), ((5, 4097), 100, 1024),
    ])
    def test_chunked_equals_plain_with_ties(self, rng, shape, k, chunk):
        x = jnp.asarray(rng.integers(-4, 4, shape).astype(np.int32))
        a = top_k_keys(x, k, chunk)
        b = jax.lax.top_k(x, k)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))

    @pytest.mark.parametrize("shape,calls", [((5000,), 1), ((1, 5000), 1),
                                             ((2, 5000), 2)])
    def test_single_row_takes_one_top_k(self, monkeypatch, shape, calls):
        seen = []
        real = jax.lax.top_k

        def spy(x, k):
            seen.append(x.shape)
            return real(x, k)

        monkeypatch.setattr(jax.lax, "top_k", spy)
        x = jnp.arange(np.prod(shape), dtype=jnp.int32).reshape(shape)
        _, idx = top_k_keys(x, 3, 128)
        assert len(seen) == calls
        np.testing.assert_array_equal(np.asarray(idx).reshape(-1, 3)[0],
                                      [shape[-1] - 1, shape[-1] - 2,
                                       shape[-1] - 3])

    def test_int_min_padding_never_wins(self):
        x = jnp.full((2, 300), jnp.iinfo(jnp.int32).min, jnp.int32)
        vals, idx = top_k_keys(x, 5, 64)
        assert np.asarray(idx).max() < 300
        np.testing.assert_array_equal(np.asarray(idx)[0], np.arange(5))


class TestSplitBf16:
    def test_three_parts_sum_to_the_query(self, rng):
        x = (rng.standard_normal(10_000)
             * 10.0 ** rng.integers(-3, 4, 10_000)).astype(np.float32)
        hi, mid, lo = scan.split_bf16(jnp.asarray(x))
        total = (np.asarray(hi, np.float64) + np.asarray(mid, np.float64)
                 + np.asarray(lo, np.float64))
        np.testing.assert_array_equal(total.astype(np.float32), x)

    def test_non_finite_entries_stay_in_the_first_part(self):
        x = jnp.asarray([np.inf, -np.inf, np.nan, 1.0], jnp.float32)
        hi, mid, lo = scan.split_bf16(x)
        assert np.isinf(float(hi[0])) and np.isnan(float(hi[2]))
        assert np.all(np.isfinite(np.asarray(mid, np.float32)))
        assert np.all(np.isfinite(np.asarray(lo, np.float32)))

    def test_u8_dots_are_exact(self, rng):
        codes = rng.integers(0, 256, (300, 64)).astype(np.uint8)
        qs = rng.standard_normal((3, 64)).astype(np.float32)
        got = np.asarray(scan.dots(jnp.asarray(qs), jnp.asarray(codes)))
        want = qs.astype(np.float64) @ codes.T.astype(np.float64)
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-4)


class TestBf16Dots:
    """bf16 corpora score bf16(q) x bf16 rows with exact products and f32
    sums, for every query count (one query included)."""

    @pytest.mark.parametrize("n_q", [1, 3, 32])
    def test_matches_f64_of_the_rounded_operands(self, rng, n_q):
        rows = jnp.asarray(rng.standard_normal((500, 128)).astype(np.float32)
                           ).astype(jnp.bfloat16)
        qs = jnp.asarray(rng.standard_normal((n_q, 128)).astype(np.float32))
        got = np.asarray(scan.dots(qs, rows), np.float64)
        q64 = np.asarray(scan.round_bf16(qs), np.float64)
        r64 = np.asarray(rows.astype(jnp.float32), np.float64)
        cond = np.abs(q64) @ np.abs(r64).T
        err = np.abs(got - q64 @ r64.T) / cond
        assert err.max() < 1e-6


def _oracle_topk(qs, rows, k):
    s = qs.astype(np.float64) @ rows.astype(np.float64).T
    return np.argsort(-s.astype(np.float32), axis=1, kind="stable")[:, :k]


class TestKernelWrapper:
    """Padding of the query batch, the ragged last block and corpora
    smaller than one block (kernel in interpret mode)."""

    @pytest.mark.parametrize("n_q", [1, 2, 3, 5, 15, 16, 17, 20, 31, 32])
    def test_query_counts(self, rng, n_q):
        rows = rng.standard_normal((700, 32)).astype(np.float32)
        qs = rng.standard_normal((n_q, 32)).astype(np.float32)
        _, idx = triton_knn.knn_keys(jnp.asarray(qs), jnp.asarray(rows), None,
                                     6, "dot", block_n=256, interpret=True)
        assert np.asarray(idx).shape == (n_q, 6)
        np.testing.assert_array_equal(np.asarray(idx), _oracle_topk(qs, rows, 6))

    @pytest.mark.parametrize("n", [1, 10, 63, 64, 65, 255, 256, 257, 511])
    def test_ragged_and_small_corpora(self, rng, n):
        rows = rng.standard_normal((n, 16)).astype(np.float32)
        qs = rng.standard_normal((3, 16)).astype(np.float32)
        k = min(5, n)
        _, idx = triton_knn.knn_keys(jnp.asarray(qs), jnp.asarray(rows), None,
                                     k, "dot", block_n=256, interpret=True)
        np.testing.assert_array_equal(np.asarray(idx), _oracle_topk(qs, rows, k))
        assert np.asarray(idx).max() < n

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.uint8])
    @pytest.mark.parametrize("mode", ["dot", "l2", "cosine", "dotm", "l2m",
                                      "cosinem"])
    def test_modes_and_dtypes_match_xla_route(self, rng, dtype, mode):
        n, d, k = 600, 48, 7
        if dtype == jnp.uint8:
            rows = jnp.asarray(rng.integers(0, 256, (n, d)).astype(np.uint8))
        else:
            rows = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32)).astype(dtype)
        qs = jnp.asarray(rng.standard_normal((4, d)).astype(np.float32))
        r32 = rows.astype(jnp.float32)
        mask = jnp.asarray(rng.random(n) > 0.4, jnp.float32)
        aux = None
        if mode.startswith("l2"):
            aux = jnp.sum(r32 * r32, axis=1)
        elif mode.startswith("cosine"):
            aux = scan.inv_norms(rows)
            qs = scan.unit_queries(qs)
        if mode.endswith("m"):
            aux = mask if aux is None else jnp.stack([aux, mask])
        tk, ti = triton_knn.knn_keys(qs, rows, aux, k, mode, block_n=256,
                                     interpret=True)
        # The XLA route's keys, L2 in the decomposed form the kernel uses.
        keys = scan.score_keys(qs, rows, aux, mode) if not mode.startswith("l2") \
            else None
        if keys is None:
            s = (aux if aux.ndim == 1 else aux[0])[None, :] - 2.0 * scan.dots(qs, rows)
            from innr_tpu.utils.order import total_order_key_f32

            keys = ~total_order_key_f32(s)
            if mode == "l2m":
                keys = jnp.where(mask[None, :] > 0, keys, jnp.iinfo(jnp.int32).min)
        xk, xi = jax.lax.top_k(keys, k)
        # Same rows; scores equal up to f32 summation order.
        np.testing.assert_array_equal(np.asarray(ti), np.asarray(xi))
        flip = mode.startswith("l2")
        tv = scan.invert_total_key(~tk if flip else tk)
        xv = scan.invert_total_key(~xk if flip else xk)
        scale = float(np.max(np.abs(np.asarray(xv)))) + 1e-30
        np.testing.assert_allclose(np.asarray(tv), np.asarray(xv), rtol=0,
                                   atol=1e-5 * scale)

    def test_rejects_unsupported_width_and_k(self):
        with pytest.raises(ValueError):
            triton_knn.knn_keys(jnp.zeros((1, 100)), jnp.zeros((64, 100)),
                                None, 3, "dot", interpret=True)
        with pytest.raises(ValueError):
            triton_knn.knn_keys(jnp.zeros((1, 16)), jnp.zeros((64, 16)),
                                None, triton_knn.K_MAX + 1, "dot",
                                interpret=True)


class TestLowersForCuda:
    """The kernel lowers to Triton IR for CUDA without a card (compiling
    it to PTX happens only on the card)."""

    @pytest.mark.parametrize("n_q,dtype,d,planned", [
        (32, jnp.float32, 128, False), (1, jnp.float32, 128, False),
        (32, jnp.bfloat16, 128, False), (4, jnp.bfloat16, 128, True),
        (32, jnp.uint8, 768, False), (16, jnp.float32, 48, True),
    ])
    def test_lowers(self, monkeypatch, n_q, dtype, d, planned):
        # Run the MLIR verifier on each Triton module, as the GPU plugin
        # does when it parses one (a failure here fails on the card).
        from jax._src.pallas.triton import lowering

        real = lowering.lower_jaxpr_to_triton_module
        modules = []

        def verified(*a, **kw):
            out = real(*a, **kw)
            modules.append(out)
            assert getattr(out, "module", out).operation.verify()
            return out

        monkeypatch.setattr(lowering, "lower_jaxpr_to_triton_module", verified)
        q = jax.ShapeDtypeStruct((n_q, d), jnp.float32)
        rows = jax.ShapeDtypeStruct((100_000, d), dtype)
        if planned:
            order = jax.ShapeDtypeStruct((25,), jnp.int32)
            fn = lambda q, r, o: triton_knn.knn_keys(  # noqa: E731
                q, r, None, 10, "dot", order=o, n_surv=jnp.int32(3),
                block_n=4096)
            args = (q, rows, order)
        else:
            fn = lambda q, r: triton_knn.knn_keys(q, r, None, 10, "dot")  # noqa: E731
            args = (q, rows)
        text = jax.jit(fn).trace(*args).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "triton" in text
        assert len(modules) == 1


class TestCompileCache:
    def test_env_wins(self, monkeypatch, tmp_path):
        from innr_tpu import compile_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        assert compile_cache.enable() == str(tmp_path)
        assert calls == []

    def test_default_is_the_repo_dot_cache(self, monkeypatch):
        from innr_tpu import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        path = compile_cache.enable()
        assert path.endswith(os.sep + ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
        root = os.path.dirname(path)
        assert os.path.isdir(os.path.join(root, "innr_tpu"))
