"""Fast math demo: rsqrt accuracy ladder and the fused approximate cosine
(reference examples/fast_math_demo.rs).

Run: python examples/fast_math_demo.py
"""

import numpy as np

import innr_tpu as it


def main():
    xs = np.array([0.25, 1.0, 2.0, 4.0, 100.0, 1e6], np.float32)
    exact = 1.0 / np.sqrt(xs.astype(np.float64))
    fast = np.asarray(it.fast_rsqrt(xs))
    precise = np.asarray(it.fast_rsqrt_precise(xs))

    print(f"{'x':>10} {'exact':>12} {'fast(1 NR)':>12} {'rel err':>9} "
          f"{'precise(2 NR)':>14} {'rel err':>9}")
    for x, e, f, p in zip(xs, exact, fast, precise):
        print(f"{x:>10.2f} {e:>12.6g} {f:>12.6g} {abs(f - e) / e:>9.1e} "
              f"{p:>14.6g} {abs(p - e) / e:>9.1e}")

    assert np.max(np.abs(fast - exact) / exact) < 5e-3, "~0.5% contract (1 NR)"
    assert np.max(np.abs(precise - exact) / exact) < 1e-5, "2-NR contract"

    # Fused approximate cosine vs exact (on an accelerator they nearly coincide:
    # rsqrt is a native vector op).
    rng = np.random.default_rng(2)
    a = rng.standard_normal(768).astype(np.float32)
    b = rng.standard_normal(768).astype(np.float32)
    fc, c = float(it.fast_cosine(a, b)), float(it.cosine(a, b))
    print(f"\nfast_cosine = {fc:.7f}, cosine = {c:.7f}, diff = {abs(fc - c):.2e}")
    assert abs(fc - c) < 1e-5

    # HNSW cost model from the reference example: distance evals per query
    # ~ ef * log(n); rsqrt shaving matters at ~1e5+ evals/query on CPU.
    # On an accelerator the evals batch into one fused scan instead.
    print("OK")


if __name__ == "__main__":
    main()
