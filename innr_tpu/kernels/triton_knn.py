"""Fused score + top-k corpus scan for the GPU, in Pallas through Triton.

The plain XLA route writes the ``(Q, N)`` score matrix to device memory and
reads it back for ``top_k``. This kernel keeps the scores on chip instead:

- each program owns one range of ``block_n`` corpus rows and walks it in
  sub-tiles of ``sub_n`` rows; each sub-tile is scored for all queries with
  ``pl.dot`` (f32 accumulation) over chunks of the feature axis;
- scores become int32 total-order keys (larger = better; L2 keys flipped),
  so NaN ordering and ties follow :mod:`innr_tpu.utils.order`;
- a per-program ``(Qp, k_pad)`` best buffer (unsorted) takes a candidate
  only when it beats that query's current worst entry; a sub-tile with no
  such candidate costs one row max and one compare;
- the program writes its buffer as one ``(Qp, k_pad)`` block; XLA's
  ``top_k`` merges the ``n_blocks * k_pad`` candidates per query.

Nothing carries between programs, so programs run in any order.

Modes: ``dot``, ``l2`` (aux row 0: per-row squared norms; keys omit the
``||q||^2`` shift), ``cosine`` (aux row 0: inverse row norms; queries
arrive unit-normalised), and the masked forms ``dotm``/``l2m``/``cosinem``
(the last aux row is a 0/1 predicate). Corpus dtypes: f32 (IEEE f32 dot),
bf16 (bf16 x bf16, f32 accumulation) and u8 (query split into three bf16
parts that sum to it exactly; codes are exact in bf16).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

_INT_MIN = jnp.iinfo(jnp.int32).min
_INT_MAX = jnp.iinfo(jnp.int32).max

# pl.dot needs every operand dimension >= 16: smaller query batches are
# scored with elementwise products and row sums instead.
Q_DOT = 16
# Largest k the per-program buffer serves; larger k takes the XLA route.
K_MAX = 128
# Rows per sub-tile and the widest feature chunk one dot consumes.
SUB_N = 64
_D_CHUNK_MAX = 128
# 4 warps per program beat 8 at every dense shape measured (PERF.md).
NUM_WARPS = 4


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def d_chunk(d: int) -> int:
    """Widest power-of-two chunk (16..128) that divides ``d``, or 0 when
    none does (such widths take the XLA route)."""
    c = _D_CHUNK_MAX
    while c >= 16:
        if d % c == 0:
            return c
        c //= 2
    return 0


def offsets_fit(n: int, d: int, dtype) -> bool:
    """Whether the Triton lowering addresses an (n, d) corpus correctly.
    It indexes arrays of at most 4 GiB with signed 32-bit element offsets,
    which wrap past 2**31 elements: only a u8 corpus of 2-4 GiB hits that
    (wider dtypes reach 4 GiB first and get 64-bit offsets)."""
    elems = int(n) * int(d)
    return elems < 2**31 or elems * jnp.dtype(dtype).itemsize > 2**32


def block_rows(n: int) -> int:
    """Rows per program: 4096, halved (down to 1024) while that leaves
    fewer than two programs per streaming multiprocessor (132 on an
    H100). Larger blocks amortise the per-program top-k; at 1M x 768 u8,
    2048-row blocks beat 512-row ones."""
    b = 4096
    while b > 1024 and -(-n // b) < 264:
        b //= 2
    return b


def _keys(scores):
    bits = jax.lax.bitcast_convert_type(scores, jnp.int32)
    return bits ^ jnp.where(bits < 0, jnp.int32(0x7FFFFFFF), jnp.int32(0))


def _kernel(q_ref, rows_ref, *rest, n, k, mode, block_n, sub_n, dc, n_aux,
            planned):
    rest = list(rest)
    aux_ref = rest.pop(0) if n_aux else None
    if planned:
        order_ref, nsurv_ref = rest.pop(0), rest.pop(0)
    keys_out, idx_out = rest
    n_parts, qp, d = q_ref.shape
    k_pad = keys_out.shape[-1]
    i = pl.program_id(0)
    n_tiles = block_n // sub_n
    if planned:
        # Tile-skip scan: program i scans survivor tile order[i]; programs
        # past the survivor count scan nothing and emit an empty buffer.
        base = order_ref[i] * block_n
        # An int32 product, not a select: the loop bounds must share one
        # integer type in the Triton module.
        n_tiles = (i < nsurv_ref[0]).astype(jnp.int32) * n_tiles
    else:
        base = i * block_n
    col = jax.lax.broadcasted_iota(jnp.int32, (qp, sub_n), 1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (qp, k_pad), 1)

    qrow = jax.lax.broadcasted_iota(jnp.int32, (qp, sub_n), 0)

    def score_tile(start):
        row = start + jnp.arange(sub_n, dtype=jnp.int32)
        valid = row < n
        acc = jnp.zeros((qp, sub_n), jnp.float32)
        for c in range(d // dc):
            r = plt.load(
                rows_ref.at[pl.ds(start, sub_n), pl.ds(c * dc, dc)],
                mask=valid[:, None], other=0,
            )
            if r.dtype == jnp.uint8:
                r = r.astype(jnp.float32).astype(jnp.bfloat16)
            if qp < Q_DOT:
                # Products of bf16 (or u8-in-bf16) values are exact in
                # f32, so this equals the dot path's arithmetic up to
                # summation order.
                r32 = r.astype(jnp.float32)
                for j in range(qp):
                    s = None
                    for p in range(n_parts):
                        q = q_ref[p, j, pl.ds(c * dc, dc)].astype(jnp.float32)
                        t = jnp.sum(r32 * q[None, :], axis=1)
                        s = t if s is None else s + t
                    acc = jnp.where(qrow == j, acc + s[None, :], acc)
                continue
            for p in reversed(range(n_parts)):  # smallest part first
                q = q_ref[p, :, pl.ds(c * dc, dc)]
                prec = (jax.lax.Precision.HIGHEST
                        if q.dtype == jnp.float32 else None)
                acc += pl.dot(q, r, trans_b=True, precision=prec)
        if mode in ("l2", "l2m"):
            norms = plt.load(aux_ref.at[0, pl.ds(start, sub_n)],
                             mask=valid, other=0.0)
            acc = norms[None, :] - 2.0 * acc
        elif mode in ("cosine", "cosinem"):
            inv = plt.load(aux_ref.at[0, pl.ds(start, sub_n)],
                           mask=valid, other=0.0)
            acc = acc * inv[None, :]
        keys = _keys(acc)
        if mode in ("l2", "l2m"):
            keys = ~keys
        if mode in ("dotm", "l2m", "cosinem"):
            pred = plt.load(aux_ref.at[n_aux - 1, pl.ds(start, sub_n)],
                            mask=valid, other=0.0)
            keys = jnp.where(pred[None, :] > 0.0, keys, _INT_MIN)
        return jnp.where(valid[None, :], keys, _INT_MIN)

    def tile_body(t, carry):
        best_k, best_i = carry
        start = base + t * sub_n
        keys = score_tile(start)

        def worst(bk, bi):
            wk = jnp.min(bk, axis=1, keepdims=True)
            # Among entries tied at the worst key, the highest index is
            # the worst under (key desc, index asc).
            wi = jnp.max(jnp.where(bk == wk, bi, -1), axis=1, keepdims=True)
            return wk, wi

        def cond(c):
            keys, bk, bi = c
            wk, _ = worst(bk, bi)
            better = jnp.max(keys, axis=1, keepdims=True) > wk
            return jnp.max(better.astype(jnp.int32)) > 0

        def body(c):
            keys, bk, bi = c
            wk, wi = worst(bk, bi)
            m = jnp.max(keys, axis=1, keepdims=True)
            pos = jnp.min(jnp.where(keys == m, col, sub_n), axis=1,
                          keepdims=True)
            # Later rows tie-break after earlier ones, so a candidate
            # enters only on a strictly greater key.
            put = (m > wk) & (bk == wk) & (bi == wi)
            bk = jnp.where(put, m, bk)
            bi = jnp.where(put, start + pos, bi)
            keys = jnp.where(col == pos, _INT_MIN, keys)
            return keys, bk, bi

        _, best_k, best_i = jax.lax.while_loop(cond, body,
                                               (keys, best_k, best_i))
        return best_k, best_i

    # Empty slots carry distinct indices, so exactly one slot is the
    # worst at any time.
    init = (jnp.full((qp, k_pad), _INT_MIN, jnp.int32), _INT_MAX - lane)
    best_k, best_i = jax.lax.fori_loop(0, n_tiles, tile_body, init)
    keys_out[...] = best_k
    idx_out[...] = best_i


@functools.partial(
    jax.jit,
    static_argnames=("k", "mode", "block_n", "interpret"),
)
def knn_keys(qs, rows, aux, k: int, mode: str, *, order=None, n_surv=None,
             block_n: int | None = None, interpret: bool = False):
    """``(keys (Q, k), idx (Q, k))``: int32 total-order keys (larger =
    better in every mode) and row indices of the top ``k`` rows.

    ``rows``: (N, D) f32, bf16 or u8 with ``d_chunk(D) > 0``; ``qs``:
    (Q, D) f32; ``aux``: (n_aux, N) f32 or None (see the module doc);
    ``k <= K_MAX``. ``order``/``n_surv``: an optional survivor plan from
    :func:`innr_tpu.prune.plan_survivors` over tiles of ``block_n`` rows
    (survivors first, ascending); only those tiles are read."""
    n_q, d = qs.shape
    n = rows.shape[0]
    dc = d_chunk(d)
    if dc == 0 or k > K_MAX or not offsets_fit(n, d, rows.dtype):
        raise ValueError(f"triton knn: unsupported n={n}, d={d} or k={k}")
    qp = _next_pow2(n_q)
    k_pad = max(16, _next_pow2(k))
    if block_n is None:
        block_n = block_rows(n)
    sub_n = min(SUB_N, block_n)
    qs = jnp.pad(qs.astype(jnp.float32), ((0, qp - n_q), (0, 0)))
    if rows.dtype == jnp.float32:
        q_parts = qs[None]
    elif rows.dtype == jnp.bfloat16:
        q_parts = qs.astype(jnp.bfloat16)[None]
    else:
        from innr_tpu.scan import split_bf16

        q_parts = jnp.stack(split_bf16(qs))
    inputs = [q_parts, rows]
    n_aux = 0
    if mode != "dot":
        aux = jnp.asarray(aux, jnp.float32)
        aux = aux if aux.ndim == 2 else aux[None, :]
        n_aux = int(aux.shape[0])
        inputs.append(aux)
    n_blocks = -(-n // block_n)
    planned = order is not None
    if planned:
        inputs += [order.astype(jnp.int32),
                   jnp.reshape(n_surv, (1,)).astype(jnp.int32)]
    kernel = functools.partial(
        _kernel, n=n, k=k, mode=mode, block_n=block_n, sub_n=sub_n, dc=dc,
        n_aux=n_aux, planned=planned,
    )
    out_block = pl.BlockSpec((None, qp, k_pad), lambda i: (i, 0, 0))
    keys, idx = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[pl.no_block_spec] * len(inputs),
        out_specs=(out_block, out_block),
        out_shape=(
            jax.ShapeDtypeStruct((n_blocks, qp, k_pad), jnp.int32),
            jax.ShapeDtypeStruct((n_blocks, qp, k_pad), jnp.int32),
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=2),
        interpret=interpret,
        name=f"knn_{mode}",
    )(*inputs)
    # Order each program's buffer by (key desc, index asc); then the
    # merge's lower-position tie-break is the lower row index.
    neg, idx = jax.lax.sort((~keys[:, :n_q], idx[:, :n_q]), dimension=2,
                            num_keys=2)
    keys = jnp.transpose(~neg, (1, 0, 2)).reshape(n_q, -1)
    idx = jnp.transpose(idx, (1, 0, 2)).reshape(n_q, -1)
    top, pos = jax.lax.top_k(keys, k)
    # Slots no row filled carry out-of-range indices; they surface only
    # when fewer than k rows are eligible, and are clamped like a gather.
    return top, jnp.minimum(jnp.take_along_axis(idx, pos, axis=1), n - 1)
