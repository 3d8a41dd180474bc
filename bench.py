#!/usr/bin/env python
"""Headline benchmark: batch_knn_dot distance evals/s on one GPU.

Times the public dense scan (``VerticalBatch`` + ``batch_knn_dot``, Q=32,
k=10) over a 5.12 GB corpus in device memory and prints ONE JSON line:

    {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
     "device": {...}, "submetrics": {...}}

The headline corpus is 20M x 128 bf16 (2 bytes/dim); ``submetrics`` holds
the 10M x 128 f32 and 1M x 768 u8 configurations and the top-10 overlap of
the bf16 scan with the f32 scan of the same corpus; an overlap under 0.98
fails the run (one JSON error line, exit 1). ``--full`` adds the
other families at their BASELINE.json sizes. Every time is a median of 5
runs after a warm-up, each ending in ``block_until_ready``; the card's
name and power limit are printed beside the result.

Baseline: the reference's published dot throughput at d=128 is 7.92 ns/eval
(Apple Silicon NEON, cache-resident, single core; BASELINE.md), i.e.
~126.3M distance evals/s. ``vs_baseline`` is our evals/s divided by that.

    python bench.py [--n ROWS] [--full]

The benchmark needs a GPU; it exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

BASELINE_EVALS_PER_S = 1.0 / 7.92e-9
# The bf16 headline counts only if its top-10 overlap with the f32 scan
# of the same corpus reaches this floor.
BF16_OVERLAP_FLOOR = 0.98


def _median_time(fn, reps=5):
    import jax

    jax.block_until_ready(fn())  # warm-up / compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def bench_knn_dot(n: int, dtype, d: int = 128, q: int = 32, k: int = 10):
    """Distance evals/s of ``batch_knn_dot`` over an (n, d) corpus."""
    import jax
    import jax.numpy as jnp

    import innr_tpu as it

    rows = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    qs = jax.random.normal(jax.random.PRNGKey(1), (q, d), jnp.float32)
    vb = it.VerticalBatch(rows, dtype=dtype)
    del rows
    return q * n / _median_time(lambda: it.batch_knn_dot(qs, vb, k).indices)


def bench_bf16_parity(n: int, d: int = 128, q: int = 32, k: int = 10):
    """Mean top-k overlap of the bf16 scan with the f32 scan of the same
    corpus (the gate on the bf16 headline)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import innr_tpu as it

    rows = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    qs = jax.random.normal(jax.random.PRNGKey(1), (q, d), jnp.float32)
    r32 = it.batch_knn_dot(qs, it.VerticalBatch(rows), k)
    r16 = it.batch_knn_dot(qs, it.VerticalBatch(rows, dtype=jnp.bfloat16), k)
    return float(np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(r16.indices, r32.indices)]))


def bench_u8(n: int = 1_000_000, d: int = 768, q: int = 32, k: int = 10):
    """Distance evals/s of the u8 asymmetric multi-query scan."""
    import jax
    import jax.numpy as jnp

    import innr_tpu as it
    from innr_tpu.ops.scalar import batch_knn_u8_multi

    codes = jax.random.randint(jax.random.PRNGKey(3), (n, d), 0, 256,
                               jnp.int32).astype(jnp.uint8)
    qv = jax.random.normal(jax.random.PRNGKey(4), (q, d), jnp.float32)
    params = it.QuantizationParams(alpha=2.0, offset=-1.0)
    batch = it.QuantizedU8Batch(codes)
    return q * n / _median_time(
        lambda: batch_knn_u8_multi(qv, batch, params, k)[1])


def _device() -> dict:
    """The device as JAX reports it; exits 2 without a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        raise SystemExit(2)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def bench_full(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    import innr_tpu as it
    from innr_tpu.ops.binary import binary_knn_batch

    key = jax.random.PRNGKey(2)
    qt = jax.random.normal(key, (32, 128), jnp.float32)
    docs = jax.random.normal(key, (256, 128, 128), jnp.float32)
    t = _median_time(lambda: it.maxsim_knn(qt, docs, 10)[1])
    out["maxsim_256docs_128tok_docs_per_s"] = 256 / t
    words = jax.random.bits(key, (30_000_000, 24), jnp.uint32)
    corpus = it.PackedBinaryBatch(words, 768)
    del words
    qw = jax.random.bits(key, (16, 24), jnp.uint32)
    t = _median_time(lambda: binary_knn_batch(qw, corpus, 10)[1])
    out["binary_30M_768bit_q16_evals_per_s"] = 16 * 30_000_000 / t
    del corpus
    sk = jax.random.randint(key, (10_000_000, 128), 0, 64, jnp.int32).astype(jnp.uint32)
    sc = it.SketchCorpus(sk)
    t = _median_time(lambda: it.slot_knn_u32_batch(sk[:16], sc, 10)[1])
    out["slot_10M_128_q16_evals_per_s"] = 16 * 10_000_000 / t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000_000,
                    help="rows of the bf16 headline corpus")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)

    from innr_tpu import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp

    device = _device()
    metric = "batch_knn_dot_evals_per_s_d128"
    sub = {"bf16_vs_f32_top10_overlap": bench_bf16_parity(n=args.n)}
    if sub["bf16_vs_f32_top10_overlap"] < BF16_OVERLAP_FLOOR:
        print(json.dumps({
            "metric": metric, "value": None, "device": device,
            "stage": "bf16_parity",
            "error": (f"bf16 top-10 overlap {sub['bf16_vs_f32_top10_overlap']}"
                      f" below {BF16_OVERLAP_FLOOR}"),
        }))
        raise SystemExit(1)
    evals = bench_knn_dot(n=args.n, dtype=jnp.bfloat16)
    sub["f32_10M_128d_evals_per_s"] = bench_knn_dot(n=10_000_000,
                                                    dtype=jnp.float32)
    sub["u8_1M_768d_evals_per_s"] = bench_u8()
    if args.full:
        bench_full(sub)
    card = _card()
    print(f"card: {card}", file=sys.stderr)
    print(json.dumps({
        "metric": metric,
        "value": evals,
        "unit": "distance evals/s/card",
        "vs_baseline": evals / BASELINE_EVALS_PER_S,
        "device": device,
        "card": card,
        "submetrics": sub,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
