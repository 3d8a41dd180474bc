"""Pluggable distance metrics (smaller = closer).

Port of reference ``src/distance.rs``: a minimal metric protocol plus
stateless metric objects mirroring the ``anndists`` / ``hnsw_rs`` trait
shape, so innr_tpu's metrics can back a generic index. Each metric's
``eval(a, b)`` returns a float32 distance; ``eval_batch(q, rows)`` is the
vectorized form over an (N, D) corpus (absent in the reference — its
indexes call ``eval`` per pair; on an accelerator per-pair calls are the
anti-pattern).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from innr_tpu.ops import dense, quant, slot

__all__ = [
    "Distance",
    "DistCosine",
    "DistDot",
    "DistL2",
    "DistL1",
    "DistHamming",
    "DistSlotU32",
]


class Distance:
    """Metric protocol (reference ``src/distance.rs:66``): ``eval`` returns
    a distance, smaller meaning more similar."""

    def eval(self, a, b) -> jax.Array:  # pragma: no cover - interface
        raise NotImplementedError

    def eval_batch(self, query, rows) -> jax.Array:
        """Distances from one query to each row of an (N, D) corpus.
        Default: vmap of ``eval``; subclasses override with matmul forms."""
        return jax.vmap(lambda r: self.eval(query, r))(jnp.asarray(rows))


class DistCosine(Distance):
    """Cosine distance ``1 - cosine``; range [0, 2]
    (reference ``src/distance.rs:73``)."""

    def eval(self, a, b) -> jax.Array:
        return 1.0 - dense.cosine(a, b)

    def eval_batch(self, query, rows) -> jax.Array:
        from innr_tpu.batch import VerticalBatch, batch_cosine

        return 1.0 - batch_cosine(query, VerticalBatch(jnp.asarray(rows)))


class DistDot(Distance):
    """Negated dot product so larger inner products sort first
    (reference ``src/distance.rs:85``)."""

    def eval(self, a, b) -> jax.Array:
        return -dense.dot(a, b)

    def eval_batch(self, query, rows) -> jax.Array:
        from innr_tpu.batch import VerticalBatch, batch_dot

        return -batch_dot(query, VerticalBatch(jnp.asarray(rows)))


class DistL2(Distance):
    """Euclidean distance (reference ``src/distance.rs:96``)."""

    def eval(self, a, b) -> jax.Array:
        return dense.l2_distance(a, b)

    def eval_batch(self, query, rows) -> jax.Array:
        from innr_tpu.batch import VerticalBatch, batch_l2_squared

        return jnp.sqrt(batch_l2_squared(query, VerticalBatch(jnp.asarray(rows))))


class DistL1(Distance):
    """Manhattan distance (reference ``src/distance.rs:107``)."""

    def eval(self, a, b) -> jax.Array:
        return dense.l1_distance(a, b)

    def eval_batch(self, query, rows) -> jax.Array:
        rows = jnp.asarray(rows, dtype=jnp.float32)
        q = jnp.asarray(query, dtype=jnp.float32)
        return jnp.sum(jnp.abs(rows - q[None, :]), axis=1)


class DistHamming(Distance):
    """Bit-Hamming over byte-packed binary vectors
    (reference ``src/distance.rs:119``)."""

    def eval(self, a, b) -> jax.Array:
        return quant.hamming_distance(a, b).astype(jnp.float32)

    def eval_batch(self, query, rows) -> jax.Array:
        return quant.batch_hamming(query, rows).astype(jnp.float32)


class DistSlotU32(Distance):
    """Normalized integer-slot Hamming (fraction of differing slots) —
    the natural MinHash metric (reference ``src/distance.rs:136``)."""

    def eval(self, a, b) -> jax.Array:
        return slot.jaccard_distance(a, b)

    def eval_batch(self, query, rows) -> jax.Array:
        rows = jnp.asarray(rows, dtype=jnp.uint32)
        counts = slot.batch_slot_hamming_u32(query, rows)
        return counts.astype(jnp.float32) / jnp.float32(rows.shape[1])
