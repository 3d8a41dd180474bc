"""Scalar (uint8) quantization with asymmetric f32-query scoring.

Redesign of reference ``src/scalar.rs``. The quantization scheme and
the asymmetric decomposition are carried over exactly
(``src/scalar.rs:8-29``):

    u8    = clamp(round((f32 - offset) / alpha * 255), 0, 255)
    dot(q, dequant(d)) = (alpha/255) * sum(q[i] * d[i]) + offset * sum(q[i])

``sum(q)`` is query-only and precomputed once (:class:`QueryContext`). The
batch path keeps codes as u8 in HBM (the 4x bandwidth win) and widens
on-chip into one matmul — the analog of the VPMOVZXBD widen + FMA loop
(``src/arch/x86_64.rs:928``).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu import scan
from innr_tpu.utils.asserts import ContractError

__all__ = [
    "QuantizationParams",
    "QuantizedU8",
    "QuantizedU8Batch",
    "quantize_u8",
    "QueryContext",
    "query_context",
    "asymmetric_dot_u8",
    "asymmetric_dot_u8_precomputed",
    "mixed_dot_u8_f32",
    "batch_knn_u8",
    "batch_knn_u8_multi",
]


@dataclass(frozen=True)
class QuantizationParams:
    """Affine quantization parameters shared by a collection
    (reference ``src/scalar.rs:44``)."""

    alpha: float
    offset: float

    @classmethod
    def from_range(cls, min_val: float, max_val: float) -> "QuantizationParams":
        """From an explicit range; degenerate ranges get alpha=1
        (reference ``src/scalar.rs:54``)."""
        alpha = float(max_val) - float(min_val)
        return cls(alpha=alpha if alpha > 0.0 else 1.0, offset=float(min_val))

    @classmethod
    def fit(cls, values) -> "QuantizationParams":
        """Min/max over a flat value slice (reference ``src/scalar.rs:68``)."""
        v = np.asarray(values, dtype=np.float32).reshape(-1)
        if v.size == 0:
            return cls(alpha=1.0, offset=0.0)
        return cls.from_range(float(np.min(v)), float(np.max(v)))

    @classmethod
    def fit_quantile(cls, values, quantile: float) -> "QuantizationParams":
        """Quantile-clipped range over *finite* values
        (reference ``src/scalar.rs:104``): ``quantile=0.99`` uses the 0.5th
        and 99.5th percentiles, clamping outliers to 0/255."""
        if not (0.0 < quantile <= 1.0):
            raise ContractError("quantile must be in (0.0, 1.0]")
        v = np.asarray(values, dtype=np.float32).reshape(-1)
        if v.size == 0:
            return cls(alpha=1.0, offset=0.0)
        if quantile >= 1.0:
            return cls.fit(v)
        finite = np.sort(v[np.isfinite(v)])
        if finite.size == 0:
            return cls(alpha=1.0, offset=0.0)
        tail = (1.0 - quantile) / 2.0
        lo_idx = int(np.floor(tail * finite.size))
        hi_idx = min(int(np.ceil((1.0 - tail) * finite.size)), finite.size - 1)
        return cls.from_range(float(finite[lo_idx]), float(finite[hi_idx]))

    @classmethod
    def fit_vectors(cls, vectors) -> "QuantizationParams":
        """Global range over a corpus of vectors
        (reference ``src/scalar.rs:143``)."""
        mins, maxs = [], []
        for v in vectors:
            v = np.asarray(v, dtype=np.float32)
            if v.size:
                mins.append(float(np.min(v)))
                maxs.append(float(np.max(v)))
        if not mins:
            return cls(alpha=1.0, offset=0.0)
        return cls.from_range(min(mins), max(maxs))


class QuantizedU8:
    """A single scalar-quantized vector (reference ``src/scalar.rs:171``)."""

    __slots__ = ("codes",)

    def __init__(self, data, dimension: int | None = None):
        codes = jnp.asarray(data, dtype=jnp.uint8)
        if codes.ndim != 1:
            raise ContractError("QuantizedU8: data must be 1-D")
        if dimension is not None and codes.shape[0] != dimension:
            raise ContractError(
                f"QuantizedU8: data length {codes.shape[0]} doesn't match "
                f"dimension {dimension}"
            )
        self.codes = codes

    def data(self) -> jax.Array:
        return self.codes

    @property
    def dimension(self) -> int:
        return int(self.codes.shape[0])

    def memory_bytes(self) -> int:
        return int(self.codes.shape[0])


class QuantizedU8Batch:
    """An (N, D) corpus of u8 codes — the device container for
    :func:`batch_knn_u8` (codes stay u8 in HBM; one array, not N objects)."""

    __slots__ = ("codes",)

    def __init__(self, codes):
        codes = jnp.asarray(codes, dtype=jnp.uint8)
        if codes.ndim != 2:
            raise ContractError("QuantizedU8Batch: codes must be 2-D (N, D)")
        self.codes = codes

    @classmethod
    def quantize(cls, rows, params: QuantizationParams) -> "QuantizedU8Batch":
        rows = jnp.asarray(rows, dtype=jnp.float32)
        return cls(_quantize(rows, params.alpha, params.offset))

    @property
    def num_vectors(self) -> int:
        return int(self.codes.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.codes.shape[1])

    def memory_bytes(self) -> int:
        return int(self.codes.size)


def _quantize(values: jax.Array, alpha: float, offset: float) -> jax.Array:
    inv_alpha = 255.0 / alpha
    normalized = (values - jnp.float32(offset)) * jnp.float32(inv_alpha)
    # Half-away-from-zero rounding (reference f32::round and the native C
    # encoder), NOT jnp.round's half-to-even: floor(x + 0.5) agrees with
    # round-half-away on the clamped [0, 255] range (negatives clamp to 0
    # either way), so all three encoders produce identical codes.
    return jnp.clip(jnp.floor(normalized + 0.5), 0.0, 255.0).astype(jnp.uint8)


def quantize_u8(values, params: QuantizationParams) -> QuantizedU8:
    """Quantize one f32 vector (reference ``src/scalar.rs:212``):
    round + clamp to 0..255."""
    values = jnp.asarray(values, dtype=jnp.float32)
    return QuantizedU8(_quantize(values, params.alpha, params.offset))


@dataclass(frozen=True)
class QueryContext:
    """Precomputed ``sum(q[i])`` (reference ``src/scalar.rs:229``)."""

    query_sum: float


def query_context(query) -> QueryContext:
    """Precompute the query sum once per query
    (reference ``src/scalar.rs:236``)."""
    q = jnp.asarray(query, dtype=jnp.float32)
    return QueryContext(query_sum=float(jnp.sum(q)))


def mixed_dot_u8_f32(a, b) -> jax.Array:
    """Raw mixed-precision inner loop ``sum(a_f32[i] * b_u8[i])``
    (reference ``src/scalar.rs:314``)."""
    a = jnp.asarray(a, dtype=jnp.float32)
    b = jnp.asarray(b, dtype=jnp.uint8)
    if a.shape[-1] != b.shape[-1]:
        raise ContractError(
            f"mixed_dot_u8_f32: slice length mismatch "
            f"({a.shape[-1]} vs {b.shape[-1]})"
        )
    return jnp.sum(a * b.astype(jnp.float32))


def asymmetric_dot_u8(query, quantized: QuantizedU8, params: QuantizationParams) -> jax.Array:
    """f32 query x quantized doc without dequantizing
    (reference ``src/scalar.rs:261``)."""
    q = jnp.asarray(query, dtype=jnp.float32)
    if q.shape[-1] != quantized.dimension:
        raise ContractError(
            f"asymmetric_dot_u8: dimension mismatch "
            f"({q.shape[-1]} vs {quantized.dimension})"
        )
    mixed = jnp.sum(q * quantized.codes.astype(jnp.float32))
    return jnp.float32(params.alpha / 255.0) * mixed + jnp.float32(
        params.offset
    ) * jnp.sum(q)


def asymmetric_dot_u8_precomputed(
    query, quantized: QuantizedU8, params: QuantizationParams, ctx: QueryContext
) -> jax.Array:
    """Asymmetric dot with the query sum amortized across the corpus
    (reference ``src/scalar.rs:284``)."""
    q = jnp.asarray(query, dtype=jnp.float32)
    if q.shape[-1] != quantized.dimension:
        raise ContractError(
            f"asymmetric_dot_u8_precomputed: dimension mismatch "
            f"({q.shape[-1]} vs {quantized.dimension})"
        )
    mixed = jnp.sum(q * quantized.codes.astype(jnp.float32))
    return jnp.float32(params.alpha / 255.0) * mixed + jnp.float32(
        params.offset * ctx.query_sum
    )


def batch_knn_u8(
    query, corpus, params: QuantizationParams, k: int
) -> list[tuple[int, float]]:
    """Quantized first-pass kNN (reference ``src/scalar.rs:370``).

    ``corpus`` is a :class:`QuantizedU8Batch` (device-native) or a sequence of
    :class:`QuantizedU8` (reference-shaped; stacked once). Scores every
    vector with the asymmetric decomposition — one matvec over the u8
    codes (:func:`innr_tpu.scan.dots`) plus the precomputed affine
    correction — and returns the top-k
    ``(index, score)`` pairs, highest similarity first.
    """
    if isinstance(corpus, QuantizedU8Batch):
        codes = corpus.codes
    else:
        corpus = list(corpus)
        if not corpus:
            return []
        codes = jnp.stack([c.codes for c in corpus])
    if codes.shape[0] == 0 or k == 0:
        return []
    q = jnp.asarray(query, dtype=jnp.float32)
    if q.shape[-1] != codes.shape[1]:
        raise ContractError(
            f"batch_knn_u8: dimension mismatch ({q.shape[-1]} vs {codes.shape[1]})"
        )
    k = min(int(k), int(codes.shape[0]))
    vals, idx = _u8_knn(q[None, :], codes, params, k)
    vals, idx = jax.device_get((vals[0], idx[0]))
    return [(int(i), float(v)) for i, v in zip(np.asarray(idx), np.asarray(vals))]




def _u8_knn(qs, codes, params, k: int):
    """Top-k of the affine-corrected scores of (Q, D) f32 queries against
    u8 ``codes``. Selection runs on the raw mixed dots: the correction
    ``(alpha/255) * mixed + offset * sum(q)`` is a per-query monotone map
    (alpha > 0 by construction), applied after selection."""
    mixed, idx = scan.knn(qs, codes, None, k, "dot")
    return _affine(mixed, qs, jnp.float32(params.alpha),
                   jnp.float32(params.offset)), idx


@jax.jit
def _affine(mixed, qs, alpha, offset):
    return (alpha / 255.0) * mixed + offset * jnp.sum(qs, axis=1, keepdims=True)


def batch_knn_u8_multi(queries, corpus: QuantizedU8Batch, params: QuantizationParams, k: int):
    """Multi-query quantized kNN: (Q, D) f32 queries against a u8 corpus in
    one scan (all queries share the 1-byte/dim corpus read).

    The serving form of :func:`batch_knn_u8`. Returns
    ``(scores (Q, k) descending, indices (Q, k))`` jax arrays; scores carry
    the full affine correction.
    """
    qs = jnp.asarray(queries, dtype=jnp.float32)
    if qs.ndim != 2 or qs.shape[1] != corpus.dimension:
        raise ContractError(
            f"batch_knn_u8_multi: queries shape {qs.shape} != "
            f"(Q, {corpus.dimension})"
        )
    n = corpus.num_vectors
    if n == 0 or k == 0:
        n_q = int(qs.shape[0])
        return (jnp.zeros((n_q, 0), jnp.float32), jnp.zeros((n_q, 0), jnp.int32))
    k = min(int(k), n)
    return _u8_knn(qs, corpus.codes, params, k)
