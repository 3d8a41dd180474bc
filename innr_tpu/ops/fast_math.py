"""Fast approximate math: rsqrt and fused approximate cosine.

Take on reference ``src/fast_math.rs``. The reference exists
because x86/ARM ``sqrt``+``div`` cost 40-60 cycles and hardware ``rsqrt``
estimates + Newton-Raphson cost ~10-15. On an accelerator ``rsqrt`` is a
native instruction, so the exact and fast paths nearly coincide; we keep the API for
parity and implement the classic Quake-III bit-hack faithfully (magic
``0x5f375a86``, reference ``src/fast_math.rs:48-76``) so its documented
accuracy contract (~0.5% relative error, one NR iteration) still holds and
remains differential-testable.

``fast_cosine`` keeps the reference's fused one-pass structure and zero-norm
guard (reference ``src/fast_math.rs:97-127``) but uses the hardware ``rsqrt``
— the analog of the SSE ``_mm_rsqrt_ps``+NR kernels
(``src/fast_math.rs:147-331``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from innr_tpu.config import NORM_EPSILON_SQ
from innr_tpu.utils.asserts import check_same_length

__all__ = [
    "fast_rsqrt",
    "fast_rsqrt_precise",
    "fast_cosine",
    "fast_cosine_dispatch",
]

# Quake III magic constant; kept a Python int so importing the module
# cannot initialize a JAX backend (multi-host needs import-before-init).
_MAGIC = 0x5F375A86


def _rsqrt_bithack(x: jax.Array, nr_iterations: int) -> jax.Array:
    x = jnp.asarray(x, dtype=jnp.float32)
    i = jax.lax.bitcast_convert_type(x, jnp.int32)
    y = jax.lax.bitcast_convert_type(
        jnp.int32(_MAGIC) - jax.lax.shift_right_arithmetic(i, 1), jnp.float32
    )
    for _ in range(nr_iterations):
        y = y * (1.5 - 0.5 * x * y * y)
    # Zero or negative inputs return 0.0 (reference src/fast_math.rs:50-52).
    return jnp.where(x > 0.0, y, 0.0)


def fast_rsqrt(x) -> jax.Array:
    """Quake-III inverse square root, one NR iteration (~0.5% rel error).

    Reference ``src/fast_math.rs:48``. Elementwise over arrays.
    """
    return _rsqrt_bithack(jnp.asarray(x), nr_iterations=1)


def fast_rsqrt_precise(x) -> jax.Array:
    """Bit-hack rsqrt with two NR iterations (~full f32 precision).

    Reference ``src/fast_math.rs:65``.
    """
    return _rsqrt_bithack(jnp.asarray(x), nr_iterations=2)


def fast_cosine(a, b) -> jax.Array:
    """Fused approximate cosine via hardware rsqrt
    (reference ``src/fast_math.rs:97``).

    One pass computes ``dot(a,b)``, ``||a||^2``, ``||b||^2``; the result is
    ``ab * rsqrt(aa) * rsqrt(bb)`` guarded by the squared-norm epsilon. The
    native ``rsqrt`` replaces the SSE/NEON estimate+NR chain.
    Raises on length mismatch regardless of size
    (reference ``src/fast_math.rs:497-503``).
    """
    a = jnp.asarray(a, dtype=jnp.float32)
    b = jnp.asarray(b, dtype=jnp.float32)
    check_same_length(a, b, "fast_cosine")
    ab = jnp.sum(a * b)
    aa = jnp.sum(a * a)
    bb = jnp.sum(b * b)
    ok = (aa > NORM_EPSILON_SQ) & (bb > NORM_EPSILON_SQ)
    safe_aa = jnp.where(ok, aa, 1.0)
    safe_bb = jnp.where(ok, bb, 1.0)
    return jnp.where(ok, ab * jax.lax.rsqrt(safe_aa) * jax.lax.rsqrt(safe_bb), 0.0)


def fast_cosine_dispatch(a, b) -> jax.Array:
    """Alias of :func:`fast_cosine` for API parity
    (reference ``src/fast_math.rs:494``).

    The reference exposes the dispatcher separately because its SIMD paths
    have per-ISA thresholds; here there is exactly one path.
    """
    return fast_cosine(a, b)
