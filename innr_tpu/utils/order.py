"""IEEE-754 total ordering for f32 scores on the device.

The reference crate orders every kNN result list with ``f32::total_cmp``
(reference ``src/batch.rs:745-747``, ``src/topk.rs:173-188``): NaN sorts
greater than every number, so a NaN score can never poison a top-k gate.
Floating-point ``<`` on the device has no such guarantee, so we reproduce total
ordering exactly with the classic bit trick: reinterpret the float as int32
and XOR negative values with 0x7FFFFFFF. Sorting the resulting int32 keys
ascending is identical to ``total_cmp`` ascending, including the positions of
NaN, ±inf and -0.0 — and integer top-k is as fast as float top-k.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def total_order_key_f32(x: jax.Array) -> jax.Array:
    """Map f32 values to int32 keys whose ``<`` equals ``f32::total_cmp``.

    ``key = bits ^ (sign ? 0x7FFFFFFF : 0)`` where ``bits`` is the int32
    bit pattern. Monotone over the IEEE total order: -NaN < -inf < ... <
    -0.0 < +0.0 < ... < +inf < +NaN.
    """
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)
    # Select form rather than (bits >> 31) >>> 1: the shift constant is
    # clamp-degenerate (32 == 31 under XLA shift clamping) so it can't
    # be observed under mutation; the comparison and constant here can.
    mask = jnp.where(bits < 0, jnp.int32(0x7FFFFFFF), jnp.int32(0))
    return bits ^ mask


def argsort_total(x: jax.Array, descending: bool = False) -> jax.Array:
    """Stable argsort of f32 values under IEEE total ordering."""
    keys = total_order_key_f32(x)
    if descending:
        keys = ~keys
    return jnp.argsort(keys, stable=True)


def top_k_total(
    x: jax.Array, k: int, largest: bool = True
) -> tuple[jax.Array, jax.Array]:
    """Top-k of f32 values under total ordering along the last axis.

    Returns ``(values, indices)`` with values sorted best-first (descending
    when ``largest``, ascending otherwise). Ties resolve to the lower index,
    matching the reference's stable sorts. NaN sorts greatest: it appears
    first in a descending sort and last in an ascending one, exactly as
    ``total_cmp`` orders it.
    """
    keys = total_order_key_f32(x)
    if not largest:
        keys = ~keys
    _, idx = jax.lax.top_k(keys, k)
    vals = jnp.take_along_axis(
        x if x.ndim > 1 else x[None, :],
        idx if idx.ndim > 1 else idx[None, :],
        axis=-1,
    )
    if x.ndim == 1:
        vals = vals[0]
    return vals, idx


# Row length above which top_k_keys selects chunk by chunk (see there).
TOPK_CHUNK = 1 << 16


def top_k_keys(keys: jax.Array, k: int, chunk: int | None = None):
    """Top-k of int32 keys along the last axis: ``(keys, indices)``, best
    first, ties to the lower index.

    With more than one row, rows longer than ``2 * chunk`` are split
    into chunks of ``chunk`` entries: ``top_k`` per chunk, then ``top_k``
    over the ``C * k`` survivors. Both steps prefer the lower position on
    ties, and chunks keep corpus order, so the result equals one ``top_k``
    over the row. ``chunk=0`` always takes the single ``top_k``, and so
    does a single row, where the one ``top_k`` measured faster on the GPU
    (PERF.md).
    """
    chunk = TOPK_CHUNK if chunk is None else int(chunk)
    n = keys.shape[-1]
    lead = keys.shape[:-1]
    if chunk <= 0 or n <= 2 * chunk or k > chunk or math.prod(lead) <= 1:
        return jax.lax.top_k(keys, k)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        # Padding sits after every real entry, so it loses every tie.
        widths = [(0, 0)] * len(lead) + [(0, pad)]
        keys = jnp.pad(keys, widths, constant_values=jnp.iinfo(jnp.int32).min)
    vals, idx = jax.lax.top_k(keys.reshape(lead + (n_chunks, chunk)), k)
    idx = idx + (jnp.arange(n_chunks, dtype=idx.dtype) * chunk)[:, None]
    vals, pos = jax.lax.top_k(vals.reshape(lead + (n_chunks * k,)), k)
    return vals, jnp.take_along_axis(idx.reshape(lead + (n_chunks * k,)),
                                     pos, axis=-1)
