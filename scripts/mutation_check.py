#!/usr/bin/env python
"""Mini mutation-testing pass over contract-bearing kernels.

The reference runs weekly ``cargo-mutants`` scoped to its contract-bearing
modules to measure whether the differential/property oracles would catch
injected bugs (``mutants.yml:30-35``). No mutation framework is baked into
this image, so this script is the self-contained analog: it applies a
curated set of single-line mutations to the same class of code (dense
reductions, total-order keys, the TopK tracker, the Triton kNN kernel's
selection logic), runs the targeted test subset per mutant in a fresh
subprocess, and requires EVERY mutant to be killed (tests fail).

Usage: python scripts/mutation_check.py          # run all mutants
       python scripts/mutation_check.py --list   # show the mutant table
Exit code 0 iff all mutants were killed.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


@dataclass(frozen=True)
class Mutant:
    name: str
    path: str
    old: str
    new: str
    tests: tuple[str, ...]


MUTANTS = [
    Mutant(
        "dot-becomes-sum",
        "innr_tpu/ops/dense.py",
        "    return jnp.sum(a * b)\n",
        "    return jnp.sum(a + b)\n",
        ("tests/test_dense.py",),
    ),
    Mutant(
        "cosine-denominator-product-flip",
        "innr_tpu/ops/dense.py",
        "    denom = jnp.sqrt(aa * bb)\n",
        "    denom = jnp.sqrt(aa + bb)\n",
        ("tests/test_dense.py",),
    ),
    Mutant(
        "l2sq-loses-square",
        "innr_tpu/ops/dense.py",
        "    return jnp.sum(d * d)\n",
        "    return jnp.sum(jnp.abs(d))\n",
        ("tests/test_dense.py",),
    ),
    Mutant(
        "matryoshka-ignores-prefix",
        "innr_tpu/ops/dense.py",
        "    return jnp.sum(a[..., :end] * b[..., :end])\n",
        "    return jnp.sum(a * b)\n",
        ("tests/test_dense.py",),
    ),
    Mutant(
        "total-order-key-drops-sign-fixup",
        "innr_tpu/utils/order.py",
        "    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)\n",
        "    return jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)\n",
        ("tests/test_batch.py", "tests/test_topk.py"),
    ),
    Mutant(
        "topk-threshold-off-by-one",
        "innr_tpu/ops/topk.py",
        "        pos = self._find_insert_pos(key, c)\n",
        "        pos = self._find_insert_pos(key, c) and 0\n",
        ("tests/test_topk.py",),
    ),
    Mutant(
        "triton-knn-tie-break-flip",
        "innr_tpu/kernels/triton_knn.py",
        "            put = (m > wk) & (bk == wk) & (bi == wi)\n",
        "            put = (m >= wk) & (bk == wk) & (bi == wi)\n",
        ("tests/test_kernels.py",),
    ),
    Mutant(
        "triton-knn-l2-loses-key-flip",
        "innr_tpu/kernels/triton_knn.py",
        "        if mode in (\"l2\", \"l2m\"):\n            keys = ~keys\n",
        "        if mode in ():\n            keys = ~keys\n",
        ("tests/test_kernels.py",),
    ),
    Mutant(
        "adaptive-prune-margin-dropped",
        "innr_tpu/batch.py",
        "    alive = ~(partial_d * scale > threshold * 1.5)\n",
        "    alive = ~(partial_d * scale > threshold * 0.0)\n",
        ("tests/test_batch.py",),
    ),
    Mutant(
        "binary-hamming-becomes-and",
        "innr_tpu/ops/binary.py",
        "        jax.lax.population_count(a.words ^ b.words).astype(jnp.int32),\n",
        "        jax.lax.population_count(a.words & b.words).astype(jnp.int32),\n",
        ("tests/test_binary.py",),
    ),
    Mutant(
        "ternary-dot-drops-diff-term",
        "innr_tpu/ops/ternary.py",
        "        jax.lax.population_count(same).astype(jnp.int32)\n"
        "        - jax.lax.population_count(diff).astype(jnp.int32),\n"
        "        dtype=jnp.int32,\n",
        "        jax.lax.population_count(same).astype(jnp.int32)\n"
        "        + jax.lax.population_count(diff).astype(jnp.int32),\n"
        "        dtype=jnp.int32,\n",
        ("tests/test_ternary.py",),
    ),
    Mutant(
        "u8-affine-correction-dropped",
        "innr_tpu/ops/scalar.py",
        "    scores = (alpha / 255.0) * mixed + offset * jnp.sum(q)\n",
        "    scores = (alpha / 255.0) * mixed\n",
        ("tests/test_scalar.py",),
    ),
    Mutant(
        "slot-knn-compare-flips-to-equal",
        "innr_tpu/ops/slot.py",
        "        (sketches[None, :, :] != queries[:, None, :]).astype(jnp.int32), axis=2\n",
        "        (sketches[None, :, :] == queries[:, None, :]).astype(jnp.int32), axis=2\n",
        ("tests/test_slot.py",),
    ),
    Mutant(
        "filtered-mask-polarity-flip",
        "innr_tpu/scan.py",
        "        keys = jnp.where(pred[None, :] > 0.0, keys, _INT_MIN)\n",
        "        keys = jnp.where(pred[None, :] <= 0.0, keys, _INT_MIN)\n",
        ("tests/test_batch.py",),
    ),
    Mutant(
        "sparse-join-match-polarity-flip",
        "innr_tpu/ops/sparse.py",
        "    matched = q_idx[pos] == idx_any\n",
        "    matched = q_idx[pos] != idx_any\n",
        ("tests/test_sparse.py",),
    ),
    Mutant(
        "sparse-join-match-guard-dropped",
        "innr_tpu/ops/sparse.py",
        "    return jnp.sum(jnp.where(matched, val_any * q_val[pos], 0.0), axis=-1)\n",
        "    return jnp.sum(val_any * q_val[pos], axis=-1)\n",
        ("tests/test_sparse.py",),
    ),
    Mutant(
        "minhash-encoder-max-instead-of-min",
        "innr_tpu/loader.py",
        "            out[d] = (h >> np.uint64(32)).min(axis=0).astype(np.uint32)\n",
        "            out[d] = (h >> np.uint64(32)).max(axis=0).astype(np.uint32)\n",
        ("tests/test_native_loader.py",),
    ),
]


def run_mutant(m: Mutant) -> str:
    src = REPO / m.path
    original = src.read_text()
    count = original.count(m.old)
    if count != 1:
        return f"STALE (pattern x{count})"
    src.write_text(original.replace(m.old, m.new))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-x", "-q", "-p", "no:cacheprovider",
             *m.tests],
            cwd=REPO,
            capture_output=True,
            text=True,
            timeout=900,
        )
        return "KILLED" if proc.returncode != 0 else "SURVIVED"
    finally:
        src.write_text(original)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()
    if args.list:
        for m in MUTANTS:
            print(f"{m.name}: {m.path} [{', '.join(m.tests)}]")
        return 0
    failures = 0
    for m in MUTANTS:
        verdict = run_mutant(m)
        print(f"{verdict:10s} {m.name} ({m.path})")
        if verdict != "KILLED":
            failures += 1
    print(f"\n{len(MUTANTS) - failures}/{len(MUTANTS)} mutants killed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
