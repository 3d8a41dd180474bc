"""End-to-end check of innr_tpu on one NVIDIA GPU (or four, with --four).

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the sharded path only

Phases on one card (data made on the device from --seed):

0. device: refuse to run without a GPU; print the card, JAX and the cache;
1. dense main path: VerticalBatch at 10M x 128 f32, Q=32, k=10 — dot, L2,
   cosine, filtered vs the float64 oracle (ops/reference.py) on a 1M-row
   slice, Triton route vs XLA route at full size; bf16 at 20M x 128 vs the
   f32 scan of the same corpus; batch_knn_u8 at 1M x 768 vs the oracle;
2. the card-only tests (tests/test_gpu.py), then timings: each dense shape
   on the Triton kernel and on the XLA route, and the XLA route of every
   family whose kernel was removed;
3. served path: TwoStageIndex (binary, ternary, u8, matryoshka) over
   1M x 768 f32 behind a MicroBatcher with 64 concurrent callers;
4. prune and IVF on a clustered 10M x 128 corpus;
5. other families (slot, sparse, MaxSim, binary/ternary kNN) vs oracles;
6. peak device memory.

Every comparison prints its tolerance and worst error; any failure raises,
so the exit code is non-zero and no result line is printed. The last line
of a successful run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
EPS = 1.1920929e-07  # float32 machine epsilon
# Published peak device-memory bandwidth by JAX device_kind (NVIDIA data
# sheet, SXM part). A device missing here is an error, not a default.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def card_line() -> str:
    """The card's name and power limit, read by a child that never
    imports JAX (a second JAX process would reserve device memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def say(*parts) -> None:
    print(*parts, flush=True)


def timed(fn, reps: int = 5):
    """(median seconds of ``reps`` runs after one warm-up, first-call
    seconds including compilation). Every run ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), first


class Smoke:
    """Shared state of one run: the seed's key stream, the card's name and
    power limit (printed beside every time), and the data-sheet peak the
    read shares divide by."""

    def __init__(self, seed: int, card: str, peak: float):
        import jax

        self.card = card
        self.peak = peak
        self._k = jax.random.PRNGKey(seed)
        self._n = 0

    def key(self):
        import jax

        self._n += 1
        return jax.random.fold_in(self._k, self._n)

    def timing(self, name: str, fn, bytes_read: int | None = None, reps=5):
        t, first = timed(fn, reps)
        share = ""
        if bytes_read:
            share = (f" read_share={bytes_read / t / self.peak:.3f}"
                     f" ({bytes_read / t / 1e9:.1f} GB/s of the"
                     f" {self.peak / 1e12:.2f} TB/s data-sheet peak)")
        say(f"[timing] {name}: median {t * 1e3:.3f} ms over {reps} runs"
            f" (first call incl. compile {first:.2f} s){share}"
            f" | card: {self.card}")
        return t


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def check_vs_oracle(name, got_idx, got_scores, truth, tol, descending):
    """``truth``: (Q, N) float64 oracle scores; ``tol``: (Q, N) per-row
    absolute tolerance (condition-aware). A returned index may differ from
    the oracle's only where the two rows' true scores tie within
    tolerance; every returned score must match its row's true score within
    tolerance."""
    import numpy as np

    got_idx = np.asarray(got_idx)
    got_scores = np.asarray(got_scores, np.float64)
    q, k = got_idx.shape
    order = np.argsort(-truth if descending else truth, axis=1,
                       kind="stable")[:, :k]
    worst_rel, worst_tie, mismatches = 0.0, 0.0, 0
    for i in range(q):
        t_got = truth[i, got_idx[i]]
        t_want = truth[i, order[i]]
        tol_pair = tol[i, got_idx[i]] + tol[i, order[i]]
        gap = np.abs(t_got - t_want)
        mismatches += int(np.sum(got_idx[i] != order[i]))
        if np.any(gap > tol_pair):
            raise AssertionError(
                f"{name}: query {i} ranks {got_idx[i].tolist()} vs oracle "
                f"{order[i].tolist()}; true-score gaps {gap.tolist()} exceed "
                f"tolerance {tol_pair.tolist()}")
        err = np.abs(got_scores[i] - t_got)
        if np.any(err > tol[i, got_idx[i]]):
            raise AssertionError(
                f"{name}: query {i} score errors {err.tolist()} exceed "
                f"tolerance {tol[i, got_idx[i]].tolist()}")
        worst_rel = max(worst_rel, float(np.max(err / np.maximum(np.abs(t_got), 1e-30))))
        worst_tie = max(worst_tie, float(np.max(gap / np.maximum(tol_pair, 1e-30))))
    say(f"[oracle] {name}: {q} queries x k={k}: worst relative score error "
        f"{worst_rel:.3e}; tolerance 32*eps*condition per row; "
        f"{mismatches} index positions differ from the oracle, all within "
        f"tolerance ties (worst gap/tolerance {worst_tie:.3f})")


def check_same(name, a_idx, a_sc, b_idx, b_sc, rtol=1e-5):
    """Two routes' results: scores equal within ``rtol`` of the scale, and
    indices equal except where the two rows' scores tie within it."""
    import numpy as np

    a_idx, b_idx = np.asarray(a_idx), np.asarray(b_idx)
    a_sc = np.asarray(a_sc, np.float64)
    b_sc = np.asarray(b_sc, np.float64)
    scale = max(float(np.max(np.abs(a_sc))), 1e-30)
    atol = rtol * scale
    err = np.abs(a_sc - b_sc)
    if not np.all(err <= atol):
        raise AssertionError(f"{name}: score difference {err.max():.3e} > "
                             f"{atol:.3e}")
    diff = a_idx != b_idx
    say(f"[compare] {name}: max score difference {err.max():.3e} "
        f"(tolerance {atol:.3e} = {rtol:g} x max |score|); "
        f"{int(diff.sum())} of {diff.size} index positions differ, "
        f"all at tied scores")


# ---------------------------------------------------------------------------
# phase 1: dense main path
# ---------------------------------------------------------------------------

def phase_dense(s: Smoke, scale: int = 1):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import innr_tpu as it
    from innr_tpu import config
    from innr_tpu.ops import reference as ref

    say("== phase 1: dense main path (VerticalBatch, 10M x 128 f32, Q=32, k=10)")
    n, d, q, k = 10_000_000 // scale, 128, 32, 10
    rows = jax.random.normal(s.key(), (n, d), jnp.float32)
    qs = jax.random.normal(s.key(), (q, d), jnp.float32)
    mask = np.asarray(jax.random.bernoulli(s.key(), 0.5, (n,)))
    vb = it.VerticalBatch(rows)
    say(f"route at this size: {it.backend.batch_backend(n, k, q, jnp.float32, d)}")

    def run_all(batch, m):
        return {
            "dot": it.batch_knn_dot(qs, batch, k),
            "l2": it.batch_knn(qs, batch, k),
            "cosine": it.batch_knn_cosine(qs, batch, k),
            "filtered": it.batch_knn_filtered(qs, batch, k, m),
        }

    full = run_all(vb, mask)
    config.force_reference(True)
    try:
        full_xla = run_all(vb, mask)
    finally:
        config.force_reference(False)
    for m in full:
        check_same(f"10M f32 {m}: Triton route vs XLA route", full[m].indices,
                   full[m].scores, full_xla[m].indices, full_xla[m].scores)

    # float64 oracle on a 1M-row slice (8 of the 32 queries).
    n1, q8 = 1_000_000 // scale, 8
    vb1 = it.VerticalBatch(rows[:n1])
    got = run_all(vb1, mask[:n1])
    r64 = np.asarray(rows[:n1]).astype(np.float64)
    q64 = np.asarray(qs[:q8]).astype(np.float64)
    absdot = np.abs(q64) @ np.abs(r64).T                 # (q8, n1)
    rr = np.sum(r64 * r64, axis=1)
    qq = np.sum(q64 * q64, axis=1)
    dots = np.stack([ref.batch_dot_portable(qv, r64) for qv in q64])
    check_vs_oracle("1M slice dot", got["dot"].indices[:q8],
                    got["dot"].scores[:q8], dots, 32 * EPS * absdot, True)
    l2 = np.stack([ref.batch_l2_squared_portable(qv, r64) for qv in q64])
    tol_l2 = 32 * EPS * (rr[None, :] + 2 * absdot + qq[:, None])
    check_vs_oracle("1M slice l2", got["l2"].indices[:q8],
                    got["l2"].scores[:q8], l2, tol_l2, False)
    cos = np.stack([ref.batch_cosine_portable(qv, r64) for qv in q64])
    norms = np.sqrt(qq)[:, None] * np.sqrt(rr)[None, :]
    check_vs_oracle("1M slice cosine", got["cosine"].indices[:q8],
                    got["cosine"].scores[:q8], cos,
                    32 * EPS * absdot / np.maximum(norms, 1e-30) + 1e-7, True)
    l2m = np.where(mask[None, :n1], l2, np.inf)
    check_vs_oracle("1M slice filtered l2", got["filtered"].indices[:q8],
                    got["filtered"].scores[:q8], l2m, tol_l2, False)
    if not mask[:n1][got["filtered"].indices].all():
        raise AssertionError("filtered scan returned a masked row")
    del vb, vb1, rows, r64, full, full_xla, got

    say("== phase 1b: bf16 corpus at 20M x 128 vs the f32 scan of the same corpus")
    n2 = 20_000_000 // scale
    rows32 = jax.random.normal(s.key(), (n2, d), jnp.float32)
    r32 = it.batch_knn_dot(qs, it.VerticalBatch(rows32), k)
    vb16 = it.VerticalBatch(rows32, dtype=jnp.bfloat16)
    del rows32
    r16 = it.batch_knn_dot(qs, vb16, k)
    overlap = np.mean([len(set(a) & set(b)) / k
                       for a, b in zip(r16.indices, r32.indices)])
    say(f"[compare] bf16 vs f32 top-{k} overlap: {overlap:.4f} (gate >= 0.98)")
    if overlap < 0.98:
        raise AssertionError("bf16 overlap below 0.98")
    del vb16

    say("== phase 1c: batch_knn_u8 at 1M x 768 vs the float64 oracle")
    n3, d3 = 1_000_000 // scale, 768
    codes = jax.random.randint(s.key(), (n3, d3), 0, 256, jnp.int32).astype(jnp.uint8)
    params = it.QuantizationParams(alpha=2.0, offset=-1.0)
    batch = it.QuantizedU8Batch(codes)
    qu = np.asarray(jax.random.normal(s.key(), (4, d3), jnp.float32))
    codes_h = np.asarray(codes)
    for i, qv in enumerate(qu):
        res = it.batch_knn_u8(qv, batch, params, k)
        got_i = np.array([r[0] for r in res])[None]
        got_s = np.array([r[1] for r in res])[None]
        mixed = np.concatenate([
            codes_h[j:j + 100_000].astype(np.float64) @ qv.astype(np.float64)
            for j in range(0, n3, 100_000)])
        cond = np.concatenate([
            codes_h[j:j + 100_000].astype(np.float64) @ np.abs(qv).astype(np.float64)
            for j in range(0, n3, 100_000)])
        truth = params.alpha / 255.0 * mixed + params.offset * float(np.sum(qv.astype(np.float64)))
        tol = 32 * EPS * (params.alpha / 255.0 * cond + abs(params.offset) * np.sum(np.abs(qv)))
        check_vs_oracle(f"u8 1M x 768 query {i}", got_i, got_s, truth[None],
                        tol[None], True)


# ---------------------------------------------------------------------------
# phase 2: timings, Triton kernel vs XLA route
# ---------------------------------------------------------------------------

def phase_gpu_tests() -> None:
    """The card-only tests (``-m gpu``), in this process: a second JAX
    process could not get the card's memory."""
    import pytest

    say("== phase 2a: card-only tests (pytest -m gpu tests/test_gpu.py)")
    os.environ["INNR_TPU_TEST_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", str(HERE / "tests" / "test_gpu.py")])
    if rc != 0:
        raise AssertionError(f"card-only tests failed (pytest exit {rc})")


def phase_timings(s: Smoke, scale: int = 1):
    import jax
    import jax.numpy as jnp

    from innr_tpu import scan

    say("== phase 2: dense scans, Triton kernel vs XLA route (k=10 unless noted)")
    shapes = [("f32 10M x 128", 10_000_000 // scale, 128, jnp.float32, (32, 1)),
              ("bf16 20M x 128", 20_000_000 // scale, 128, jnp.bfloat16, (32, 1)),
              ("u8 1M x 768", 1_000_000 // scale, 768, jnp.uint8, (32,))]
    for name, n, d, dt, qsizes in shapes:
        if dt == jnp.uint8:
            rows = jax.random.randint(s.key(), (n, d), 0, 256, jnp.int32).astype(dt)
        else:
            rows = jax.random.normal(s.key(), (n, d), jnp.float32).astype(dt)
        nbytes = rows.size * rows.dtype.itemsize
        for q in qsizes:
            qs = jax.random.normal(s.key(), (q, d), jnp.float32)
            ks = (10, 64, 100) if (q == 32 and dt == jnp.bfloat16) else (10,)
            for k in ks:
                for route in ("triton", "xla"):
                    if route == "triton" and k > 128:
                        continue
                    s.timing(f"dense {name} Q={q} k={k} route={route}",
                             lambda: scan.knn(qs, rows, None, k, "dot", route=route),
                             nbytes)
            if q == 32 and dt == jnp.bfloat16:
                s.timing(f"dense {name} Q=32 k=640 route=xla",
                         lambda: scan.knn(qs, rows, None, 640, "dot", route="xla"),
                         nbytes)
        del rows


# ---------------------------------------------------------------------------
# phases 2 and 5 for the families without a kernel
# ---------------------------------------------------------------------------

def phase_families(s: Smoke, scale: int = 1):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import innr_tpu as it
    from innr_tpu.ops.binary import binary_knn_batch
    from innr_tpu.ops.ternary import ternary_knn_batch

    say("== phases 2 and 5: families on the XLA route (timings at the "
        "bench sizes, oracle on a slice)")
    k = 10

    def popcount_rows(x):
        bits = np.unpackbits(np.ascontiguousarray(x).view(np.uint8), axis=1)
        return bits.sum(axis=1, dtype=np.int64)

    # binary: 30M x 768 bits
    n, w = 30_000_000 // scale, 24
    words = jax.random.bits(s.key(), (n, w), jnp.uint32)
    corpus = it.PackedBinaryBatch(words, 768)
    del words
    nbytes = n * w * 4
    q1 = it.PackedBinary(jax.random.bits(s.key(), (w,), jnp.uint32), 768)
    q16 = jax.random.bits(s.key(), (16, w), jnp.uint32)
    s.timing("binary 30M x 768 bits Q=1", lambda: it.binary_knn(q1, corpus, k)[1], nbytes)
    s.timing("binary 30M x 768 bits Q=16", lambda: binary_knn_batch(q16, corpus, k)[1], nbytes)
    m = min(200_000, n)
    sl = it.PackedBinaryBatch(corpus.words[:m], 768)
    counts, idx = binary_knn_batch(q16, sl, k)
    host = np.asarray(sl.words)
    for i, qw in enumerate(np.asarray(q16)):
        truth = popcount_rows(host ^ qw[None, :])
        want = np.sort(truth, kind="stable")[:k]
        if not (np.array_equal(truth[np.asarray(idx)[i]], want)
                and np.array_equal(np.asarray(counts)[i], want)):
            raise AssertionError(f"binary query {i} disagrees with the oracle")
    say(f"[oracle] binary kNN on a {m}-row slice, 16 queries: counts exact (tolerance 0)")
    del corpus, sl

    # ternary: 15M x 768
    n = 15_000_000 // scale
    m = min(200_000, n)
    pos = jax.random.bits(s.key(), (n, w), jnp.uint32)
    neg = jax.random.bits(s.key(), (n, w), jnp.uint32) & ~pos
    corpus = it.PackedTernaryBatch(pos, neg, 768)
    del pos, neg
    nbytes = 2 * n * w * 4
    qp = jax.random.bits(s.key(), (16, w), jnp.uint32)
    qn = jax.random.bits(s.key(), (16, w), jnp.uint32) & ~qp
    t1 = it.PackedTernary(qp[0], qn[0], 768)
    s.timing("ternary 15M x 768 Q=1", lambda: it.ternary_knn(t1, corpus, k)[1], nbytes)
    s.timing("ternary 15M x 768 Q=16",
             lambda: ternary_knn_batch((qp, qn), corpus, k)[1], nbytes)
    sl = it.PackedTernaryBatch(corpus.pos[:m], corpus.neg[:m], 768)
    dots, idx = ternary_knn_batch((qp, qn), sl, k)
    hp, hn = np.asarray(sl.pos), np.asarray(sl.neg)
    for i, (a, b) in enumerate(zip(np.asarray(qp), np.asarray(qn))):
        truth = (popcount_rows((hp & a) | (hn & b))
                 - popcount_rows((hp & b) | (hn & a)))
        want = np.sort(truth)[::-1][:k]
        if not (np.array_equal(truth[np.asarray(idx)[i]], want)
                and np.array_equal(np.asarray(dots)[i], want)):
            raise AssertionError(f"ternary query {i} disagrees with the oracle")
    say(f"[oracle] ternary kNN on a {m}-row slice, 16 queries: dots exact (tolerance 0)")
    del corpus, sl

    # slot: 10M x 128 u32 sketches, Q=16
    n, sl_w = 10_000_000 // scale, 128
    m = min(200_000, n)
    sk = jax.random.randint(s.key(), (n, sl_w), 0, 64, jnp.int32).astype(jnp.uint32)
    corpus = it.SketchCorpus(sk)
    qsk = sk[:16] ^ (jax.random.bits(s.key(), (16, sl_w), jnp.uint32) & 1)
    s.timing("slot 10M x 128 Q=16", lambda: it.slot_knn_u32_batch(qsk, corpus, k)[1],
             n * sl_w * 4)
    counts, idx = it.slot_knn_u32_batch(qsk, it.SketchCorpus(sk[:m]), k)
    host = np.asarray(sk[:m])
    for i, qv in enumerate(np.asarray(qsk)):
        truth = np.sum(host != qv[None, :], axis=1)
        want = np.sort(truth, kind="stable")[:k]
        if not np.array_equal(np.asarray(counts)[i], want):
            raise AssertionError(f"slot query {i} disagrees with the oracle")
    say(f"[oracle] slot kNN on a {m}-row slice, 16 queries: counts exact (tolerance 0)")
    del corpus, sk

    # sparse: 1M docs x 32 nnz
    n, nnz, vocab = 1_000_000 // scale, 32, 30_000
    m = min(200_000, n)
    idx_c = jnp.sort(jax.random.randint(s.key(), (n, nnz), 0, vocab, jnp.int32), axis=1)
    val_c = jax.random.normal(s.key(), (n, nnz), jnp.float32)
    sp = it.SparseCorpus((idx_c.astype(jnp.uint32), val_c))
    qi = np.sort(np.asarray(jax.random.choice(s.key(), vocab, (24,), replace=False)))
    qv = np.asarray(jax.random.normal(s.key(), (24,), jnp.float32))
    query = (qi.astype(np.uint32), qv)
    s.timing("sparse 1M docs x 32 nnz Q=1", lambda: it.sparse_knn(query, sp, k)[1],
             n * nnz * 8)
    vals, got = it.sparse_knn(query, sp, k)
    hi, hv = np.asarray(idx_c[:m]), np.asarray(val_c[:m]).astype(np.float64)
    pos = np.clip(np.searchsorted(qi, hi), 0, qi.size - 1)
    qmap = np.where(qi[pos] == hi, qv.astype(np.float64)[pos], 0.0)
    truth_m = np.sum(qmap * hv, axis=1)
    vals_m, got_m = it.sparse_knn(query, it.SparseCorpus(
        (idx_c[:m].astype(jnp.uint32), val_c[:m])), k)
    tol = 32 * EPS * np.sum(np.abs(qmap * hv), axis=1)
    check_vs_oracle(f"sparse kNN on a {m}-doc slice", np.asarray(got_m)[None],
                    np.asarray(vals_m)[None], truth_m[None], tol[None] + 1e-7, True)
    del sp

    # MaxSim: 32-token query x 256 docs x 128 tokens x 128 d
    from innr_tpu.ops import reference as ref

    qt = jax.random.normal(s.key(), (32, 128), jnp.float32)
    n_docs = max(256 // scale, 16)
    docs = jax.random.normal(s.key(), (n_docs, 128, 128), jnp.float32)
    s.timing("maxsim 256 docs x 128 tokens x 128 d, 32-token query",
             lambda: it.maxsim_knn(qt, docs, k)[1], docs.size * 4)
    vals, got = it.maxsim_knn(qt, docs, k)
    qh, dh = np.asarray(qt), np.asarray(docs)
    truth = np.array([ref.maxsim_portable(qh, dh[j]) for j in range(n_docs)])
    tol = np.array([32 * EPS * np.sum(np.max(np.abs(qh) @ np.abs(dh[j]).T, axis=1))
                    for j in range(n_docs)])
    check_vs_oracle(f"maxsim kNN ({n_docs} docs)", np.asarray(got)[None],
                    np.asarray(vals)[None], truth[None], tol[None], True)


# ---------------------------------------------------------------------------
# phase 3: served two-stage path behind a MicroBatcher
# ---------------------------------------------------------------------------

def phase_served(s: Smoke, scale: int = 1):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import innr_tpu as it

    say("== phase 3: TwoStageIndex over 1M x 768 f32 behind a MicroBatcher "
        "(64 concurrent callers, k=10, rerank factor 64: 640 coarse "
        "candidates per query)")
    n, d, n_c, k = 1_000_000 // scale, 768, max(1000 // scale, 4), 10
    centers = jax.random.normal(s.key(), (n_c, d), jnp.float32)
    assign = jax.random.randint(s.key(), (n,), 0, n_c)
    rows = centers[assign] + 0.5 * jax.random.normal(s.key(), (n, d), jnp.float32)
    rows = rows / jnp.linalg.norm(rows, axis=1, keepdims=True)
    qa = jax.random.randint(s.key(), (64,), 0, n_c)
    queries = centers[qa] + 0.5 * jax.random.normal(s.key(), (64, d), jnp.float32)
    queries = np.asarray(queries / jnp.linalg.norm(queries, axis=1, keepdims=True))
    exact = it.batch_knn_dot(queries, it.VerticalBatch(rows), k)
    for kind in ("binary", "ternary", "u8", "matryoshka"):
        cfg = it.CoarseConfig(kind=kind, threshold=0.02 if kind == "ternary" else 0.0)
        index = it.TwoStageIndex(rows, cfg, rerank_factor=64)
        want = index.search_batch(queries, k)
        out = [None] * 64
        with it.MicroBatcher(index, k=k, max_batch=32) as mb:
            start = threading.Barrier(64)

            def caller(i):
                start.wait()
                out[i] = mb.search(queries[i], timeout=600)

            threads = [threading.Thread(target=caller, args=(i,)) for i in range(64)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
        got_i = np.stack([o[1] for o in out])
        got_s = np.stack([o[0] for o in out])
        check_same(f"served {kind}: MicroBatcher vs search_batch", got_i,
                   got_s, want.indices, want.scores)
        recall = np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(got_i, exact.indices)])
        say(f"[served] {kind}: recall@{k} vs exact search {recall:.4f}; "
            f"64 callers answered in {wall * 1e3:.1f} ms wall (first batches "
            f"include compilation); {mb.stats.launches} launches, mean batch "
            f"{mb.stats.mean_batch:.1f}")
        del index


# ---------------------------------------------------------------------------
# phase 4: prune and IVF
# ---------------------------------------------------------------------------

def phase_prune(s: Smoke, scale: int = 1):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import innr_tpu as it
    from innr_tpu import prune

    say("== phase 4: prune=True and IVFIndex on a clustered 10M x 128 corpus")
    n, d, n_c, k = 10_000_000 // scale, 128, max(1024 // scale, 8), 10
    centers = 3.0 * jax.random.normal(s.key(), (n_c, d), jnp.float32)
    assign = jnp.sort(jax.random.randint(s.key(), (n,), 0, n_c))
    rows = centers[assign] + 0.1 * jax.random.normal(s.key(), (n, d), jnp.float32)
    qa = jax.random.randint(s.key(), (32,), 0, n_c)
    qs = centers[qa] + 0.1 * jax.random.normal(s.key(), (32, d), jnp.float32)
    vb = it.VerticalBatch(rows)
    full = it.batch_knn_dot(qs, vb, k)
    pruned = it.batch_knn_dot(qs, vb, k, prune=True)
    if not (np.array_equal(full.indices, pruned.indices)
            and np.array_equal(full.scores, pruned.scores)):
        raise AssertionError("prune=True differs from the full scan")
    summ = vb.tile_summary()
    _, n_surv = prune.plan_survivors(qs, summ.centroids, summ.radii, summ.counts, k, "dot")
    skipped = 1.0 - int(n_surv) / summ.n_tiles
    say(f"[compare] prune=True == full scan (indices and scores bit-identical); "
        f"tiles skipped {skipped:.4f} of {summ.n_tiles} tiles of {summ.tile_n} rows")
    s.timing("dense f32 10M x 128 clustered Q=32 prune=False", lambda: it.batch_knn_dot(qs, vb, k).indices)
    s.timing("dense f32 10M x 128 clustered Q=32 prune=True", lambda: it.batch_knn_dot(qs, vb, k, prune=True).indices)
    for metric, fn in (("dot", it.batch_knn_dot), ("l2", it.batch_knn)):
        ivf = it.IVFIndex(rows, n_clusters=max(256 // scale, 4), metric=metric)
        got = ivf.search_batch(qs, k)
        want = fn(qs, vb, k)
        check_same(f"IVFIndex {metric} vs full scan", got.indices, got.scores,
                   want.indices, want.scores)
        surv, total = ivf.plan_stats(qs, k)
        say(f"[ivf] {metric}: tiles skipped {1 - surv / total:.4f} "
            f"({surv}/{total} survive), padding {ivf.padding_fraction:.4f}")
        del ivf


# ---------------------------------------------------------------------------
# --four: the sharded path on a 1-D mesh of four cards
# ---------------------------------------------------------------------------

def phase_four(s: Smoke, scale: int = 1, check_memory: bool = True):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import innr_tpu as it
    from innr_tpu.parallel import (
        ShardedCorpus, ShardedQuantizedU8, ShardedTwoStageIndex, default_mesh,
    )

    devs = jax.devices()[:4]
    if len(devs) != 4:
        raise SystemExit(f"--four needs 4 devices, found {len(devs)}")
    mesh = default_mesh(devs)
    card0 = devs[0]

    def shards_report(name, arr):
        sizes = sorted((sh.device.id, sh.data.shape[0]) for sh in arr.addressable_shards)
        rows_each = {sz for _, sz in sizes}
        say(f"[shards] {name}: rows per device {sizes}")
        if len(sizes) != 4 or len(rows_each) != 1 or sizes[0][1] * 4 != arr.shape[0]:
            raise AssertionError(f"{name}: corpus is not split in quarters")

    def mem_report():
        if not check_memory:
            return None
        used = [dv.memory_stats()["bytes_in_use"] / 1e9 for dv in devs]
        say(f"[memory] bytes in use per card (GB): {[round(u, 2) for u in used]}")
        return used

    say("== four cards: ShardedCorpus 40M x 128 f32 (5.12 GB per card)")
    n, d, q, k = 40_000_000 // scale, 128, 32, 10
    with jax.default_device(card0):
        rows = jax.random.normal(s.key(), (n, d), jnp.float32)
        qs = jax.random.normal(s.key(), (q, d), jnp.float32)
        mask = np.asarray(jax.random.bernoulli(s.key(), 0.5, (n,)))
    sc = ShardedCorpus(rows, mesh)
    shards_report("ShardedCorpus rows", sc.rows)
    vb = it.VerticalBatch(rows)  # the single-card route, on card 0
    used = mem_report()
    quarter = n * d * 4 / 4 / 1e9
    if used is not None and min(used[1:]) < 0.9 * quarter:
        raise AssertionError("cards 1-3 do not hold their quarter of the corpus")
    pairs = {
        "dot": (sc.knn_dot(qs, k), it.batch_knn_dot(qs, vb, k)),
        "l2": (sc.knn_l2(qs, k), it.batch_knn(qs, vb, k)),
        "cosine": (sc.knn_cosine(qs, k), it.batch_knn_cosine(qs, vb, k)),
        "filtered": (sc.knn_filtered(qs, k, mask),
                     it.batch_knn_filtered(qs, vb, k, mask)),
    }
    for m, ((sv, si), single) in pairs.items():
        check_same(f"4-card ShardedCorpus {m} vs one card", si, sv,
                   single.indices, single.scores)
    t4 = s.timing("4-card ShardedCorpus dot 40M x 128 Q=32", lambda: sc.knn_dot(qs, k)[1])
    t1 = s.timing("1-card VerticalBatch dot 40M x 128 Q=32", lambda: it.batch_knn_dot(qs, vb, k).indices)
    say(f"[four] speedup of 4 cards over 1: {t1 / t4:.2f}x")
    del sc, vb, rows

    say("== four cards: ShardedQuantizedU8 and ShardedTwoStageIndex at 4M x 768")
    n, d = 4_000_000 // scale, 768
    with jax.default_device(card0):
        codes = jax.random.randint(s.key(), (n, d), 0, 256, jnp.int32).astype(jnp.uint8)
        qu = jax.random.normal(s.key(), (q, d), jnp.float32)
    params = it.QuantizationParams(alpha=2.0, offset=-1.0)
    squ = ShardedQuantizedU8(codes, params, mesh)
    shards_report("ShardedQuantizedU8 codes", squ.codes)
    sv, si = squ.knn(qu, k)
    from innr_tpu.ops.scalar import batch_knn_u8_multi

    ov, oi = batch_knn_u8_multi(qu, it.QuantizedU8Batch(codes), params, k)
    check_same("4-card ShardedQuantizedU8 vs one card", si, sv, oi, ov)
    del squ, codes
    with jax.default_device(card0):
        rows = jax.random.normal(s.key(), (n, d), jnp.float32)
        rows = rows / jnp.linalg.norm(rows, axis=1, keepdims=True)
    for kind in ("u8", "binary"):
        st = ShardedTwoStageIndex(rows, kind, mesh=mesh)
        shards_report(f"ShardedTwoStageIndex[{kind}] rows", st.rows)
        sv, si = st.search_batch(qu, k)
        single = it.TwoStageIndex(rows, kind).search_batch(qu, k)
        # The sharded index reranks k*rf candidates PER shard (a superset
        # of the single card's shortlist): compare against exact search.
        exact = it.batch_knn_dot(qu, it.VerticalBatch(rows), k)
        r4 = np.mean([len(set(a) & set(b)) / k for a, b in zip(np.asarray(si), exact.indices)])
        r1 = np.mean([len(set(a) & set(b)) / k for a, b in zip(single.indices, exact.indices)])
        say(f"[compare] 4-card ShardedTwoStageIndex[{kind}] recall@{k} {r4:.4f} "
            f">= one-card TwoStageIndex {r1:.4f}")
        if r4 + 1e-9 < r1:
            raise AssertionError("sharded two-stage recall below the single card's")
        del st
    mem_report()


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(HERE))
    import innr_tpu  # noqa: F401  (the checkout's own package)

    if Path(innr_tpu.__file__).resolve().parent != HERE / "innr_tpu":
        raise SystemExit(f"innr_tpu imported from {innr_tpu.__file__}, "
                         f"not from this checkout ({HERE})")
    from innr_tpu import compile_cache

    cache = compile_cache.enable()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {dev.platform!r}")
    s = Smoke(args.seed, card_line(), PEAK_BYTES_PER_S[dev.device_kind])
    say("== phase 0: device")
    say(f"device_kind: {dev.device_kind}; devices: {len(jax.devices())}")
    say(f"card (nvidia-smi name, power.limit): {s.card}")
    say(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache: {cache}")
    t0 = time.perf_counter()
    if args.four:
        phase_four(s)
    else:
        phase_dense(s)
        phase_gpu_tests()
        phase_timings(s)
        phase_served(s)
        phase_prune(s)
        phase_families(s)
    peak = max(dv.memory_stats()["peak_bytes_in_use"] for dv in jax.devices())
    say("== phase 6: memory")
    say(f"peak_bytes_in_use: {peak} ({peak / 1e9:.2f} GB); total "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"card: {s.card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
