"""Sparse primitives for learned sparse retrieval (tuple-based API).

Redesign of reference ``src/sparse_ext.rs`` (the reference's optional
``sparse`` cargo feature). A sparse vector here is an ``(indices, values)``
array pair — the structure-of-arrays form of the reference's
``&[(u32, f32)]`` tuple slices, which is the layout device gathers
consume.

``sparse_dense_dot`` keeps the reference's safety contract exactly: entries
whose dimension is out of bounds for the dense vector are *skipped*, and the
bounds decision uses the true maximum over all entries, never a sortedness
assumption (regression at reference ``src/sparse_ext.rs:190-202``). Here
every gather is clamped and masked, so the unsafe fast path and the checked
slow path collapse into one kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu.utils.asserts import ContractError

__all__ = [
    "sparse_dot",
    "sparse_dense_dot",
    "sparse_l2_norm",
    "sparse_normalize",
    "sparse_top_k",
    "sparse_max_weight",
]


def _split(sv, name: str):
    """Accept (indices, values) pairs or [(dim, w), ...] tuple lists."""
    if isinstance(sv, tuple) and len(sv) == 2:
        idx = jnp.asarray(sv[0], dtype=jnp.uint32)
        val = jnp.asarray(sv[1], dtype=jnp.float32)
    else:
        entries = list(sv)
        idx = jnp.asarray([int(d) for d, _ in entries], dtype=jnp.uint32)
        val = jnp.asarray([float(w) for _, w in entries], dtype=jnp.float32)
    if idx.shape[-1] != val.shape[-1]:
        raise ContractError(
            f"sparse_ext::{name}: indices/values length mismatch "
            f"({idx.shape[-1]} vs {val.shape[-1]})"
        )
    return idx, val


def sparse_dot(a, b) -> jax.Array:
    """Sparse x sparse dot, both sorted by dimension
    (reference ``src/sparse_ext.rs:16``)."""
    from innr_tpu.ops.sparse import _sparse_dot_arrays

    a_idx, a_val = _split(a, "sparse_dot")
    b_idx, b_val = _split(b, "sparse_dot")
    return _sparse_dot_arrays(a_idx, a_val, b_idx, b_val)


def sparse_dense_dot(sparse, dense) -> jax.Array:
    """Sparse x dense dot with masked out-of-bounds entries
    (reference ``src/sparse_ext.rs:65``).

    Unsorted input is safe and correct: the gather is clamped and entries
    with ``dim >= len(dense)`` contribute nothing.
    """
    idx, val = _split(sparse, "sparse_dense_dot")
    dense = jnp.asarray(dense, dtype=jnp.float32)
    if idx.shape[-1] == 0 or dense.shape[-1] == 0:
        return jnp.float32(0.0)
    in_bounds = idx < dense.shape[-1]
    # OOB entries gather index 0 and are masked to 0.0 below (index 0 is
    # always valid here: the empty-dense case returned early).
    gathered = dense[jnp.where(in_bounds, idx.astype(jnp.int32), 0)]
    return jnp.sum(jnp.where(in_bounds, val * gathered, 0.0))


def sparse_l2_norm(v) -> jax.Array:
    """L2 norm of the weights (reference ``src/sparse_ext.rs:151``)."""
    _, val = _split(v, "sparse_l2_norm")
    return jnp.sqrt(jnp.sum(val * val))


def sparse_normalize(v) -> tuple[jax.Array, jax.Array]:
    """Unit-normalized copy (functional; reference mutates in place,
    ``src/sparse_ext.rs:156``). Zero-norm vectors are returned unchanged."""
    idx, val = _split(v, "sparse_normalize")
    n = jnp.sqrt(jnp.sum(val * val))
    val = jnp.where(n > 0.0, val / jnp.where(n > 0.0, n, 1.0), val)
    return idx, val


def sparse_top_k(v, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Keep the top-k entries by |weight|, re-sorted by dimension
    (reference ``src/sparse_ext.rs:167``)."""
    idx, val = _split(v, "sparse_top_k")
    idx = np.asarray(idx)
    val = np.asarray(val)
    if val.size <= k:
        return idx, val
    # Stable descending-by-|w| selection, then re-sort by dimension.
    order = np.argsort(-np.abs(val), kind="stable")[:k]
    sel_idx, sel_val = idx[order], val[order]
    dim_order = np.argsort(sel_idx, kind="stable")
    return sel_idx[dim_order], sel_val[dim_order]


def sparse_max_weight(v) -> jax.Array:
    """Max weight folded from 0.0 (reference ``src/sparse_ext.rs:183``):
    an all-negative vector reports 0.0, by contract."""
    _, val = _split(v, "sparse_max_weight")
    if val.shape[-1] == 0:
        return jnp.float32(0.0)
    return jnp.maximum(jnp.max(val), 0.0)
