"""Dense f32 vector primitives: dot, cosine, norms, L1/L2, matryoshka.

Redesign of reference ``src/dense.rs``. The reference dispatches
each call to AVX-512/AVX2/NEON intrinsics by length; on an accelerator a
single pair is a degenerate tile and XLA fuses the whole reduction into one elementwise pass, so the
"kernel" here is the jnp expression itself. The real acceleration surface is
the batch layer (``innr_tpu.batch``) where these ops become matmuls.

Contracts (reference ``src/lib.rs:34-46``):

- length mismatch raises :class:`~innr_tpu.utils.asserts.ContractError`
  (the panic analog) at trace time;
- zero norms: similarity ops return ``0.0`` when either norm is below
  ``1e-9`` (squared-space compare against ``NORM_EPSILON_SQ``);
- NaN propagates through ``dot`` and the distances; ``cosine`` returns
  ``0.0`` for NaN inputs (the zero-norm guard absorbs them);
- empty inputs: reductions return ``0.0``.

All functions are functional (JAX-style): ``normalize`` returns a new array
instead of mutating, with the original norm available from
:func:`normalize_with_norm` (reference ``src/dense.rs:177``).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from innr_tpu.config import NORM_EPSILON, NORM_EPSILON_SQ
from innr_tpu.utils.asserts import check_same_length

__all__ = [
    "dot",
    "norm",
    "normalize",
    "normalize_with_norm",
    "cosine",
    "angular_distance",
    "l2_distance",
    "l2_distance_squared",
    "l1_distance",
    "matryoshka_dot",
    "matryoshka_cosine",
]


def _as_f32(x) -> jax.Array:
    x = jnp.asarray(x)
    if x.dtype != jnp.float32:
        x = x.astype(jnp.float32)
    return x


def dot(a, b) -> jax.Array:
    """Dot product ``sum(a[i] * b[i])`` (reference ``src/dense.rs:56``).

    Returns a 0-d f32 array; ``0.0`` for empty inputs; NaN propagates.
    """
    a, b = _as_f32(a), _as_f32(b)
    check_same_length(a, b, "dot")
    return jnp.sum(a * b)


def norm(v) -> jax.Array:
    """L2 norm ``sqrt(dot(v, v))`` (reference ``src/dense.rs:139``)."""
    v = _as_f32(v)
    return jnp.sqrt(jnp.sum(v * v))


def normalize(v) -> jax.Array:
    """Return ``v`` scaled to unit length (reference ``src/dense.rs:160``).

    Vectors with norm below ``1e-9`` are returned unchanged (no division by
    zero). Functional: returns a new array, never mutates.
    """
    normalized, _ = normalize_with_norm(v)
    return normalized


def normalize_with_norm(v) -> tuple[jax.Array, jax.Array]:
    """Normalize and also return the original L2 norm
    (reference ``src/dense.rs:177``)."""
    v = _as_f32(v)
    n = jnp.sqrt(jnp.sum(v * v))
    scaled = jnp.where(n > NORM_EPSILON, v / n, v)
    return scaled, n


def cosine(a, b) -> jax.Array:
    """Fused single-pass cosine similarity (reference ``src/dense.rs:243``).

    Computes ``dot(a,b)``, ``||a||^2`` and ``||b||^2`` in one fused pass
    (XLA fuses the three reductions over one read of each input, the analog
    of the reference's 12-accumulator fused kernel,
    ``src/arch/x86_64.rs:681``). Returns ``0.0`` when either squared norm is
    at or below ``NORM_EPSILON_SQ`` — NaN norms fail the ``>`` test and are
    absorbed to ``0.0``, matching the reference contract.
    """
    a, b = _as_f32(a), _as_f32(b)
    check_same_length(a, b, "cosine")
    ab = jnp.sum(a * b)
    aa = jnp.sum(a * a)
    bb = jnp.sum(b * b)
    ok = (aa > NORM_EPSILON_SQ) & (bb > NORM_EPSILON_SQ)
    denom = jnp.sqrt(aa * bb)
    return jnp.where(ok, ab / jnp.where(ok, denom, 1.0), 0.0)


def angular_distance(a, b) -> jax.Array:
    """Normalized angle ``acos(clamp(cosine)) / pi`` in ``[0, 1]``
    (reference ``src/dense.rs:376``)."""
    sim = jnp.clip(cosine(a, b), -1.0, 1.0)
    return jnp.arccos(sim) / math.pi


def l2_distance_squared(a, b) -> jax.Array:
    """Squared Euclidean distance (reference ``src/dense.rs:596``)."""
    a, b = _as_f32(a), _as_f32(b)
    check_same_length(a, b, "l2_distance_squared")
    d = a - b
    return jnp.sum(d * d)


def l2_distance(a, b) -> jax.Array:
    """Euclidean distance (reference ``src/dense.rs:468``)."""
    return jnp.sqrt(l2_distance_squared(a, b))


def l1_distance(a, b) -> jax.Array:
    """Manhattan distance (reference ``src/dense.rs:499``)."""
    a, b = _as_f32(a), _as_f32(b)
    check_same_length(a, b, "l1_distance")
    return jnp.sum(jnp.abs(a - b))


def matryoshka_dot(a, b, prefix_len: int) -> jax.Array:
    """Dot product over the first ``prefix_len`` dims
    (reference ``src/dense.rs:427``).

    ``prefix_len`` must be a static Python int (it selects a static slice,
    keeping the op jit-compilable). Clamped to the shorter input length.
    """
    a, b = _as_f32(a), _as_f32(b)
    end = min(int(prefix_len), a.shape[-1], b.shape[-1])
    return jnp.sum(a[..., :end] * b[..., :end])


def matryoshka_cosine(a, b, prefix_len: int) -> jax.Array:
    """Cosine over the first ``prefix_len`` dims
    (reference ``src/dense.rs:450``)."""
    a, b = _as_f32(a), _as_f32(b)
    end = min(int(prefix_len), a.shape[-1], b.shape[-1])
    return cosine(a[..., :end], b[..., :end])
