"""Integer primitives: u8 dot product and byte-packed bit Hamming.

Redesign of reference ``src/quant.rs``. The reference widens u8 lanes
through SIMD multiply-accumulate chains (``dot_u8_avx512``,
``src/arch/x86_64.rs:1102``) and popcounts XORed bytes through VPOPCNTDQ /
VPSHUFB lookup tables (``:1160-1271``). Here the widening multiply is an
int32 elementwise op (or an int8 matmul in the batch layer) and popcount is the
native ``lax.population_count`` — no lookup tables needed.

Contracts: dispatching functions raise on length mismatch; empty inputs
return 0 (reference ``src/quant.rs:55``, ``:159``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from innr_tpu.utils.asserts import check_same_length

__all__ = [
    "dot_u8",
    "hamming_distance",
    "batch_hamming",
    "batch_dot_u8",
    "batch_dot_u8_s8",
]


def dot_u8(a, b) -> jax.Array:
    """u8 dot product with u32 accumulator (reference ``src/quant.rs:55``).

    Overflow-safe to dimension ~65k (255*255*65536 < 2^32), same bound as
    the reference.
    """
    a = jnp.asarray(a, dtype=jnp.uint8)
    b = jnp.asarray(b, dtype=jnp.uint8)
    check_same_length(a, b, "dot_u8")
    return jnp.sum(
        a.astype(jnp.int32) * b.astype(jnp.int32), dtype=jnp.int32
    ).astype(jnp.uint32)


def hamming_distance(a, b) -> jax.Array:
    """Bit Hamming over byte-packed vectors (reference ``src/quant.rs:159``).

    Each byte stores 8 bits; counts differing bit positions via XOR +
    native popcount (the AVX-512 VPOPCNTDQ analog).
    """
    a = jnp.asarray(a, dtype=jnp.uint8)
    b = jnp.asarray(b, dtype=jnp.uint8)
    check_same_length(a, b, "hamming_distance")
    return jnp.sum(
        jax.lax.population_count(a ^ b).astype(jnp.int32), dtype=jnp.int32
    ).astype(jnp.uint32)


def batch_hamming(query, corpus) -> jax.Array:
    """Bit Hamming of one byte-packed query against a packed corpus.

    ``query``: (W,) uint8; ``corpus``: (N, W) uint8. Returns (N,) uint32.
    batch form of the reference's per-pair scan (XOR, popcount and the
    row sum fuse into one reduction under jit).
    """
    query = jnp.asarray(query, dtype=jnp.uint8)
    corpus = jnp.asarray(corpus, dtype=jnp.uint8)
    check_same_length(query, corpus, "batch_hamming")
    pc = jax.lax.population_count(corpus ^ query[None, :]).astype(jnp.int32)
    return jnp.sum(pc, axis=1).astype(jnp.uint32)


def batch_dot_u8(query, corpus) -> jax.Array:
    """u8 dot of one query against an (N, D) u8 corpus -> (N,) uint32.

    Widens on the device after the 1-byte/element read (the 4x-bandwidth win
    the reference gets from keeping codes in u8).
    """
    query = jnp.asarray(query, dtype=jnp.uint8)
    corpus = jnp.asarray(corpus, dtype=jnp.uint8)
    check_same_length(query, corpus, "batch_dot_u8")
    return jnp.matmul(
        corpus.astype(jnp.int32),
        query.astype(jnp.int32),
        preferred_element_type=jnp.int32,
    ).astype(jnp.uint32)


def batch_dot_u8_s8(query, corpus) -> jax.Array:
    """u8 dot via the zero-point-shifted s8xs8 matmul decomposition — exact.

    Tensor cores multiply int8 natively; u8 values don't fit int8, so shift
    both sides by the zero point 128 (``s = u - 128`` is a bijection
    u8 <-> s8) and correct:

        dot(a, b) = dot(as, bs) + 128*sum(as) + 128*sum(bs) + 128^2 * D

    All terms are exact int32 (|dot(as,bs)| <= 128^2 * D). The survey §2.4
    "int8 matmul for u8 paths" experiment (reference dot_u8_avx512,
    src/arch/x86_64.rs:1102); `scripts/bench_int8.py` A/Bs this against
    the int32-widen path on hardware — results in PERF.md.
    """
    query = jnp.asarray(query, dtype=jnp.uint8)
    corpus = jnp.asarray(corpus, dtype=jnp.uint8)
    check_same_length(query, corpus, "batch_dot_u8_s8")
    d = corpus.shape[-1]
    qs = (query ^ jnp.uint8(0x80)).view(jnp.int8)
    cs = (corpus ^ jnp.uint8(0x80)).view(jnp.int8)
    main = jax.lax.dot_general(
        cs, qs,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    row_sums = jnp.sum(cs.astype(jnp.int32), axis=1)
    q_sum = jnp.sum(qs.astype(jnp.int32))
    out = main + 128 * row_sums + 128 * q_sum + 128 * 128 * d
    return out.astype(jnp.uint32)
