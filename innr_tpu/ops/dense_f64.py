"""f64 vector primitives via double-float ("df64") arithmetic.

Redesign of reference ``src/dense_f64.rs``. Accelerators run f64 at a
fraction of the f32 rate (or emulate it), and jnp only carries 64-bit types
when ``jax_enable_x64`` is on. The answer here is **double-f32
arithmetic**: each f64 value is carried as an (hi, lo) pair of f32s with
error-free transformations (Dekker two-prod with 2^12+1 splitting, Knuth
two-sum) giving ~2^-48 relative accuracy — comfortably inside the 1e-9
relative bound the reference's differential fuzz target enforces for f64
reductions (``fuzz/fuzz_targets/l2_l1_diff.rs``). Every op is a fully
vectorized pass plus a log2(n)-step halving reduction tree, not a
scalar loop.

``impl`` selects the path per call:

- ``"auto"`` (default): native f64 when ``jax_enable_x64`` is on, else df64;
- ``"native"``: jnp float64 (requires x64; exact);
- ``"df64"``: the double-f32 path (works everywhere; |x| must be within
  f32 range, ~3.4e38 — values beyond it overflow the hi component).

Contracts (reference ``src/dense_f64.rs``): comparison over the *minimum*
length, no length panic; empty inputs return 0.0; the zero-norm guard uses
``f64::EPSILON`` (2.22e-16) in norm space. Results are returned as Python
floats (f64 scalars).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "dot_f64",
    "norm_f64",
    "normalize_f64",
    "cosine_f64",
    "l2_distance_squared_f64",
    "l2_distance_f64",
    "l1_distance_f64",
]

_F64_EPSILON = float(np.finfo(np.float64).eps)
_SPLITTER = np.float32(4097.0)  # 2^12 + 1 (Dekker splitting for f32)


# ---------------------------------------------------------------------------
# df64 arithmetic core (error-free transformations, all f32 elementwise ops)
# ---------------------------------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(s, e):
    r = s + e
    return r, e - (r - s)


def _split(a):
    t = _SPLITTER * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def _df64_add(xh, xl, yh, yl):
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    return _quick_two_sum(s, e)


def _df64_mul(xh, xl, yh, yl):
    p, e = _two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return _quick_two_sum(p, e)


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n — the tree-reduction width. ANY width
    >= n is correct (zero padding is absorbed by df64 adds); the exact
    power of two is the no-waste choice, so this is a perf-only knob
    (excluded from mutation like the tile pickers; an under-sized mutant
    crashes the concatenate shapes outright)."""
    size = 1
    while size < n:
        size *= 2
    return size


def _tree_sum(h: jax.Array, l: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Reduce (n,) df64 pairs to a scalar pair via log2(n) halving steps —
    each step one vectorized df64 add over half the array."""
    n = h.shape[0]
    if n == 0:
        return jnp.float32(0.0), jnp.float32(0.0)
    size = _pow2_ceil(n)
    pad = size - n
    if pad:
        h = jnp.concatenate([h, jnp.zeros((pad,), dtype=jnp.float32)])
        l = jnp.concatenate([l, jnp.zeros((pad,), dtype=jnp.float32)])
    while size > 1:
        half = size // 2
        h, l = _df64_add(h[:half], l[:half], h[half:], l[half:])
        size = half
    return h[0], l[0]


def _split_input(x) -> tuple[jax.Array, jax.Array]:
    """Split host f64 values into (hi, lo) f32 pairs."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def _use_native(impl: str) -> bool:
    if impl == "native":
        if not jax.config.jax_enable_x64:
            raise ValueError(
                "dense_f64 impl='native' requires jax_enable_x64; "
                "use impl='df64' or enable x64"
            )
        return True
    if impl == "df64":
        return False
    if impl == "auto":
        return bool(jax.config.jax_enable_x64)
    raise ValueError(f"unknown dense_f64 impl {impl!r}")


def _min_len(a, b):
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    n = min(a.size, b.size)
    return a[:n], b[:n]


# ---------------------------------------------------------------------------
# jit'd df64 reductions
# ---------------------------------------------------------------------------

@jax.jit
def _dot_df64(ah, al, bh, bl):
    ph, pl = _df64_mul(ah, al, bh, bl)
    return _tree_sum(ph, pl)


@jax.jit
def _l2sq_df64(ah, al, bh, bl):
    dh, dl = _df64_add(ah, al, -bh, -bl)
    ph, pl = _df64_mul(dh, dl, dh, dl)
    return _tree_sum(ph, pl)


@jax.jit
def _l1_df64(ah, al, bh, bl):
    dh, dl = _df64_add(ah, al, -bh, -bl)
    neg = dh < 0.0
    dh = jnp.where(neg, -dh, dh)
    dl = jnp.where(neg, -dl, dl)
    return _tree_sum(dh, dl)


def _combine(h, l) -> float:
    return float(np.float64(float(h)) + np.float64(float(l)))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def dot_f64(a, b, impl: str = "auto") -> float:
    """f64 dot product (reference ``src/dense_f64.rs:31``). Min-length
    semantics; empty -> 0.0."""
    a, b = _min_len(a, b)
    if a.size == 0:
        return 0.0
    if _use_native(impl):
        return float(jnp.sum(jnp.asarray(a) * jnp.asarray(b)))
    ah, al = _split_input(a)
    bh, bl = _split_input(b)
    return _combine(*_dot_df64(ah, al, bh, bl))


def norm_f64(v, impl: str = "auto") -> float:
    """f64 L2 norm (reference ``src/dense_f64.rs:95``)."""
    return float(np.sqrt(dot_f64(v, v, impl=impl)))


def normalize_f64(v, impl: str = "auto") -> tuple[np.ndarray, float]:
    """Unit-normalized copy and the original norm
    (reference ``src/dense_f64.rs:103``; functional, not in-place).
    Norms at or below ``f64::EPSILON`` leave the vector unchanged."""
    v = np.asarray(v, dtype=np.float64).copy()
    n = norm_f64(v, impl=impl)
    if n > _F64_EPSILON:
        v = v / n
    return v, n


def cosine_f64(a, b, impl: str = "auto") -> float:
    """f64 cosine with the ``f64::EPSILON`` zero-norm guard
    (reference ``src/dense_f64.rs:132``)."""
    na = norm_f64(a, impl=impl)
    nb = norm_f64(b, impl=impl)
    if not (na > _F64_EPSILON and nb > _F64_EPSILON):
        return 0.0
    return dot_f64(a, b, impl=impl) / (na * nb)


def l2_distance_squared_f64(a, b, impl: str = "auto") -> float:
    """f64 squared Euclidean distance (reference ``src/dense_f64.rs:148``)."""
    a, b = _min_len(a, b)
    if a.size == 0:
        return 0.0
    if _use_native(impl):
        d = jnp.asarray(a) - jnp.asarray(b)
        return float(jnp.sum(d * d))
    ah, al = _split_input(a)
    bh, bl = _split_input(b)
    return _combine(*_l2sq_df64(ah, al, bh, bl))


def l2_distance_f64(a, b, impl: str = "auto") -> float:
    """f64 Euclidean distance (reference ``src/dense_f64.rs:218``)."""
    return float(np.sqrt(l2_distance_squared_f64(a, b, impl=impl)))


def l1_distance_f64(a, b, impl: str = "auto") -> float:
    """f64 Manhattan distance (reference ``src/dense_f64.rs:228``)."""
    a, b = _min_len(a, b)
    if a.size == 0:
        return 0.0
    if _use_native(impl):
        return float(jnp.sum(jnp.abs(jnp.asarray(a) - jnp.asarray(b))))
    ah, al = _split_input(a)
    bh, bl = _split_input(b)
    return _combine(*_l1_df64(ah, al, bh, bl))
