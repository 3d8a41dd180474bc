"""Pure-NumPy reference implementations — the build's "portable layer".

The reference crate pairs every SIMD kernel with a portable scalar fallback
that doubles as the differential-test oracle (reference
``tests/simd_correctness.rs:1-8``). These NumPy functions play both roles
here: they define the exact semantics every jnp/Pallas kernel must match, and
they follow the portable contracts — comparison over the *minimum* length, no
exception on mismatch (reference ``src/lib.rs:34-46``).

Everything here is deliberately scalar-simple NumPy: no JAX, no cleverness.
"""

from __future__ import annotations

import numpy as np

NORM_EPSILON = 1e-9
NORM_EPSILON_SQ = NORM_EPSILON * NORM_EPSILON


# ---------------------------------------------------------------------------
# Dense f32 (reference src/dense.rs portable fns)
# ---------------------------------------------------------------------------

def dot_portable(a, b) -> float:
    """Dot product over the shorter length (reference src/dense.rs:103)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    n = min(a.size, b.size)
    return float(np.sum(a[:n].astype(np.float64) * b[:n].astype(np.float64)))


def norm_portable(v) -> float:
    return float(np.sqrt(dot_portable(v, v)))


def cosine_portable(a, b) -> float:
    """Fused cosine with the zero-norm guard (reference src/dense.rs:288)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    n = min(a.size, b.size)
    a, b = a[:n].astype(np.float64), b[:n].astype(np.float64)
    ab = float(np.sum(a * b))
    aa = float(np.sum(a * a))
    bb = float(np.sum(b * b))
    if aa > NORM_EPSILON_SQ and bb > NORM_EPSILON_SQ:
        return ab / np.sqrt(aa * bb)
    return 0.0


def l2_distance_squared_portable(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    n = min(a.size, b.size)
    d = a[:n].astype(np.float64) - b[:n].astype(np.float64)
    return float(np.sum(d * d))


def l2_distance_portable(a, b) -> float:
    return float(np.sqrt(l2_distance_squared_portable(a, b)))


def l1_distance_portable(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    n = min(a.size, b.size)
    return float(
        np.sum(np.abs(a[:n].astype(np.float64) - b[:n].astype(np.float64)))
    )


def angular_distance_portable(a, b) -> float:
    sim = min(1.0, max(-1.0, cosine_portable(a, b)))
    return float(np.arccos(sim) / np.pi)


def normalize_portable(v):
    v = np.asarray(v, dtype=np.float32).copy()
    n = norm_portable(v)
    if n > NORM_EPSILON:
        v = v / np.float32(n)
    return v, float(n)


# ---------------------------------------------------------------------------
# Dense f64 (reference src/dense_f64.rs)
# ---------------------------------------------------------------------------

def dot_f64_portable(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = min(a.size, b.size)
    return float(np.sum(a[:n] * b[:n]))


def l2_distance_squared_f64_portable(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = min(a.size, b.size)
    d = a[:n] - b[:n]
    return float(np.sum(d * d))


def l1_distance_f64_portable(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = min(a.size, b.size)
    return float(np.sum(np.abs(a[:n] - b[:n])))


# ---------------------------------------------------------------------------
# Integer kernels (reference src/quant.rs, src/slot.rs) — EXACT oracles
# ---------------------------------------------------------------------------

def dot_u8_portable(a, b) -> int:
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    n = min(a.size, b.size)
    return int(np.sum(a[:n].astype(np.uint64) * b[:n].astype(np.uint64)))


def hamming_portable(a, b) -> int:
    """Bit Hamming over byte-packed vectors (reference src/quant.rs:202)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    n = min(a.size, b.size)
    return int(np.sum(np.unpackbits(a[:n] ^ b[:n])))


def slot_hamming_portable(a, b) -> int:
    """Differing-slot count over min length (reference src/slot.rs:266)."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = min(a.size, b.size)
    return int(np.sum(a[:n] != b[:n]))


def slot_compare_counts_portable(a, b):
    """(eq, lt, gt) triple (reference src/slot.rs:299)."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = min(a.size, b.size)
    a, b = a[:n], b[:n]
    return int(np.sum(a == b)), int(np.sum(a < b)), int(np.sum(a > b))


# ---------------------------------------------------------------------------
# MaxSim (reference src/maxsim.rs:142 maxsim_portable)
# ---------------------------------------------------------------------------

def maxsim_portable(query_tokens, doc_tokens) -> float:
    q = np.asarray(query_tokens, dtype=np.float32)
    d = np.asarray(doc_tokens, dtype=np.float32)
    if q.size == 0 or d.size == 0:
        return 0.0
    scores = q.astype(np.float64) @ d.astype(np.float64).T
    return float(np.sum(np.max(scores, axis=1)))


def maxsim_cosine_portable(query_tokens, doc_tokens) -> float:
    q = np.asarray(query_tokens, dtype=np.float32)
    d = np.asarray(doc_tokens, dtype=np.float32)
    if q.size == 0 or d.size == 0:
        return 0.0
    total = 0.0
    for qi in q:
        best = -np.inf
        for dj in d:
            best = max(best, cosine_portable(qi, dj))
        total += best
    return float(total)


# ---------------------------------------------------------------------------
# Sparse (reference src/sparse.rs:71 sparse_dot_portable)
# ---------------------------------------------------------------------------

def sparse_dot_portable(a_indices, a_values, b_indices, b_values) -> float:
    ai = np.asarray(a_indices, dtype=np.uint32)
    av = np.asarray(a_values, dtype=np.float32)
    bi = np.asarray(b_indices, dtype=np.uint32)
    bv = np.asarray(b_values, dtype=np.float32)
    i = j = 0
    result = 0.0
    while i < ai.size and j < bi.size:
        if ai[i] < bi[j]:
            i += 1
        elif ai[i] > bi[j]:
            j += 1
        else:
            result += float(av[i]) * float(bv[j])
            i += 1
            j += 1
    return result


# ---------------------------------------------------------------------------
# Batch (reference src/batch.rs, row-at-a-time oracle)
# ---------------------------------------------------------------------------

def batch_l2_squared_portable(query, rows) -> np.ndarray:
    q = np.asarray(query, dtype=np.float64)
    r = np.asarray(rows, dtype=np.float64)
    d = r - q[None, :]
    return np.sum(d * d, axis=1)


def batch_dot_portable(query, rows) -> np.ndarray:
    q = np.asarray(query, dtype=np.float64)
    r = np.asarray(rows, dtype=np.float64)
    return r @ q


def batch_cosine_portable(query, rows) -> np.ndarray:
    q = np.asarray(query, dtype=np.float64)
    r = np.asarray(rows, dtype=np.float64)
    qn = np.sqrt(np.sum(q * q))
    rn = np.sqrt(np.sum(r * r, axis=1))
    out = np.zeros(r.shape[0])
    if qn < NORM_EPSILON:
        return out
    ok = rn > NORM_EPSILON
    out[ok] = (r[ok] @ q) / (qn * rn[ok])
    return out
