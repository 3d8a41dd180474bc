"""Shared per-device scan body + key decoding for the distribution layer.

Every distributed index (row-sharded, query-parallel, 2-D grid) runs the
same local step — :func:`innr_tpu.scan.knn_keys` producing raw int32
total-order keys, offset to global row indices — and the same decode after
the merge (:func:`innr_tpu.scan.decode_keys`).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from innr_tpu import scan
from innr_tpu.utils.asserts import ContractError

_INT_MIN = jnp.iinfo(jnp.int32).min


def local_scan_keys(qs, rows, aux, n_total, k, mode, base, route=None):
    """One device's local top-k: (Q, D) queries x (rows_local, D) corpus
    block -> ``(keys (Q, k), global_idx (Q, k))``, keys being raw int32
    total-order values (larger = better for every mode; L2 flipped).

    ``aux``: per-row squared norms ("l2"), guarded inverse norms
    ("cosine"), stacked norms and predicate ("l2m"), or None ("dot").
    ``base``: this block's global row offset. Rows at or beyond
    ``n_total`` (padding) get the smallest key; callers over-fetch ``k``
    by the padding count so padding never displaces a real row.
    """
    keys, lidx = scan.knn_keys(qs, rows, aux, k, mode, route=route)
    gidx = base + lidx
    return jnp.where(gidx < n_total, keys, _INT_MIN), gidx


def resolve_predicate_mask(predicate, n: int, op: str):
    """Shared predicate resolution for every ``knn_filtered`` entry point:
    a host callable ``index -> bool`` or an (N,) boolean mask ->
    ``(bool mask, num_passing)``. Raises ``ContractError`` on shape
    mismatch (the single place this contract lives)."""
    if callable(predicate):
        mask = np.fromiter(
            (bool(predicate(i)) for i in range(n)), dtype=bool, count=n
        )
    else:
        mask = np.asarray(predicate, dtype=bool)
        if mask.shape != (n,):
            raise ContractError(
                f"innr_tpu::{op}: mask shape {mask.shape} != ({n},)"
            )
    return mask, int(mask.sum())


def local_scan_keys_filtered(qs, rows, norms2, mask, n_total, k, base,
                             route=None):
    """Predicate-pushdown variant of :func:`local_scan_keys` (L2 only):
    ``mask`` is this block's (rows_local,) f32 0/1 predicate — non-passing
    rows can never win (reference src/batch.rs:842-845)."""
    return local_scan_keys(qs, rows, jnp.stack([norms2, mask]), n_total, k,
                           "l2m", base, route=route)


def decode_keys(keys, mode, qs, n_rows, route="xla"):
    """Raw merged keys -> f32 scores for scans over ``n_rows``-row blocks
    on ``route`` (see :func:`innr_tpu.scan.decode_keys`)."""
    return scan.decode_keys(keys, mode, qs, n_rows, route)
