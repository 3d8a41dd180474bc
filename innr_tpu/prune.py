"""Tile summaries and survivor planning for HBM-skipping scans.

The reference prunes per *row* with data-dependent early exit
(``src/batch.rs:320-365`` threshold pruning, ``:439-558`` adaptive warmup
extrapolation) — a pattern that maps poorly to a batched device scan.
This redesign prunes per *corpus tile*: at container build time each
corpus tile of ``tile_n`` rows is summarized by its centroid ``c`` and
covering radius ``r = max_i ||row_i - c||``; at query time Cauchy-Schwarz
gives exact per-tile score bounds

- dot:  for every row in the tile,  ``q.c - |q| r  <=  q.row  <=  q.c + |q| r``
- L2^2: ``(max(0, ||q-c|| - r))^2  <=  ||q-row||^2  <=  (||q-c|| + r)^2``

Sorting the per-tile *guaranteed* bounds (every row beats them) and
accumulating tile row counts until ``k`` rows are covered yields a
threshold ``t0`` such that at least k rows score at least ``t0``; every
tile whose *optimistic* bound cannot reach ``t0`` is provably loser-only
and its read is skipped entirely (:func:`innr_tpu.scan.planned_knn_keys`:
the Triton scan runs one program per surviving tile). Unlike the
reference's adaptive scan, the result is EXACT — the
bounds are sound, and every dead-tile comparison carries a conservative
``config.PRUNE_BOUND_EPS`` rounding slack (the planner's bounds and the
scan's scores are different f32 expansions), so neither the mathematical
bound nor f32 rounding can ever prune a true neighbor.

Pruning power depends on tile coherence: a corpus in random order has
every tile centered on the global mean and nothing prunes (the scan then
degrades gracefully to the ordinary full read, never below it minus the
tiny bound pass). :func:`cluster_order` provides a device-side k-means
ordering pass for corpora that arrive unordered — the IVF-style layout
step any pruning index needs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from innr_tpu.utils.padding import round_up

__all__ = [
    "TileSummary",
    "build_tile_summary",
    "default_tile_n",
    "cluster_order",
    "cluster_reorder",
    "suggest_tile_n",
]


class TileSummary:
    """Per-tile (centroid, radius, row-count) summary of an (N, D) corpus.

    ``tile_n`` must equal the scan's tile height — the summary is built
    for a specific tiling (see :func:`default_tile_n`).
    """

    __slots__ = ("tile_n", "centroids", "radii", "counts", "n_rows")

    def __init__(self, tile_n, centroids, radii, counts, n_rows):
        self.tile_n = int(tile_n)
        self.centroids = centroids  # (n_tiles, D) f32
        self.radii = radii          # (n_tiles,) f32
        self.counts = counts        # (n_tiles,) int32 rows per tile
        self.n_rows = int(n_rows)

    @property
    def n_tiles(self) -> int:
        return int(self.centroids.shape[0])

    def memory_bytes(self) -> int:
        return (
            int(self.centroids.size) * 4
            + int(self.radii.size) * 4
            + int(self.counts.size) * 4
        )


def default_tile_n(n: int, d: int, dtype=jnp.float32) -> int:
    """Default tile height for an ``n``-row corpus: the Triton scan's own
    block height (:func:`innr_tpu.kernels.triton_knn.block_rows`, 1024 to
    4096 rows), so one surviving tile is one kernel program. ``d`` and
    ``dtype`` are accepted for callers that size by bytes."""
    from innr_tpu.kernels.triton_knn import block_rows

    return block_rows(max(int(n), 1))


@partial(jax.jit, static_argnames=("tile_n", "normalized"))
def _summarize(rows: jax.Array, tile_n: int, normalized: bool = False,
               row_valid=None):
    n, d = rows.shape
    n_tiles = -(-n // tile_n)
    pad = n_tiles * tile_n - n
    rows32 = rows.astype(jnp.float32)
    if normalized:
        # Unit-row summary (cosine pruning): cos(q, r) = q_hat . r_hat,
        # so bounds over the normalized corpus are the dot bounds with
        # |q| = 1. Zero/tiny-norm rows become zero rows (their cosine is
        # exactly 0.0 by contract — consistent with q_hat . 0).
        from innr_tpu.config import NORM_EPSILON

        norms = jnp.sqrt(jnp.sum(rows32 * rows32, axis=1, keepdims=True))
        ok = norms > NORM_EPSILON
        rows32 = jnp.where(ok, rows32 / jnp.where(ok, norms, 1.0), 0.0)
    rp = jnp.pad(rows32, ((0, pad), (0, 0)))
    valid = (
        jnp.arange(n_tiles * tile_n, dtype=jnp.int32).reshape(n_tiles, tile_n)
        < n
    )
    if row_valid is not None:
        # Masked summary (IVF tile-aligned padding, innr_tpu/ivf.py):
        # centroid/radius/count cover VALID rows only. The plan's
        # threshold guarantee becomes "at least k VALID rows beat t0",
        # and masked rows — pinned to the worst key by the scans'
        # "l2m"/"dotm"/"cosinem" modes — cannot weaken the bound or
        # poison a radius with their (arbitrary) padding values.
        valid = valid & jnp.pad(
            jnp.asarray(row_valid, jnp.bool_), (0, pad)
        ).reshape(n_tiles, tile_n)
    r3 = rp.reshape(n_tiles, tile_n, d)
    cnt = jnp.sum(valid, axis=1).astype(jnp.int32)
    cent = jnp.sum(jnp.where(valid[..., None], r3, 0.0), axis=1) / jnp.maximum(
        cnt, 1
    ).astype(jnp.float32)[:, None]
    diff = r3 - cent[:, None, :]
    d2 = jnp.sum(diff * diff, axis=2)
    d2 = jnp.where(valid, d2, 0.0)
    radii = jnp.sqrt(jnp.max(d2, axis=1))
    return cent, radii, cnt


def build_tile_summary(rows: jax.Array, tile_n: int,
                       normalized: bool = False,
                       row_valid=None) -> TileSummary:
    """One pass over the corpus -> :class:`TileSummary` (device arrays).

    The ragged final tile is summarized over its real rows only. NaN/inf
    rows poison their tile's radius to NaN, which the survivor planner
    treats as "never prunable" — a tile containing non-finite rows is
    always scanned (the conservative direction).

    ``normalized=True`` summarizes the UNIT rows (cosine pruning: plan
    survivors with mode "dot" against pre-normalized queries).

    ``row_valid``: optional (N,) boolean — summarize only rows where it is
    True (tile-aligned padded layouts: the scan must mask the same rows
    via the "l2m"/"dotm"/"cosinem" scan modes). Tiles with zero valid
    rows get centroid 0 / radius 0 / count 0; :func:`plan_survivors`
    prunes them unconditionally."""
    cent, radii, cnt = _summarize(rows, tile_n, normalized, row_valid)
    return TileSummary(tile_n, cent, radii, cnt, int(rows.shape[0]))


def _pad_tail(order, n_surv, n_tiles: int):
    """Fill the dead slots of ``order`` (positions >= ``n_surv``) by
    repeating the LAST survivor's tile index. ANY valid tile id is sound
    in the tail — the Triton scan's programs past ``n_surv`` read nothing
    (:mod:`innr_tpu.kernels.triton_knn`). The survivor PREFIX, which is
    correctness, is pinned against the bound oracle in
    ``tests/test_mutation_hardening.py``.
    """
    last = order[jnp.maximum(n_surv - 1, 0)]
    idxs = jnp.arange(n_tiles, dtype=jnp.int32)
    return jnp.where(idxs < n_surv, order, last)


@partial(jax.jit, static_argnames=("mode", "k", "fast"))
def plan_survivors(qs, summary_cent, summary_rad, summary_cnt, k: int,
                   mode: str, fast: bool = False):
    """Survivor tile plan for a (Q, D) query batch.

    Returns ``(order (n_tiles,) int32, n_surv () int32)``: ``order`` lists
    surviving tile indices ascending first (preserving the scan's
    lowest-index tie-break), then repeats the LAST survivor for dead
    slots.

    Soundness: per query, tiles are ranked by their guaranteed bound
    (every row in a tile beats it) and row counts accumulated until >= k
    rows are covered; ``t0`` = the guaranteed bound at that point, so the
    true k-th best score >= t0. A tile is dead only if its optimistic
    bound is strictly worse than t0 for EVERY query — all comparisons are
    written so NaN bounds keep tiles alive.
    """
    from innr_tpu.config import PRUNE_BOUND_EPS

    n_tiles = summary_cent.shape[0]
    # Full f32: the rounding slack PRUNE_BOUND_EPS assumes f32 bounds; a
    # TF32 product (~1e-3 relative) could prune a true neighbor.
    qd = jnp.matmul(
        qs, summary_cent.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (Q, n_tiles)
    qn = jnp.sqrt(jnp.sum(qs * qs, axis=1, keepdims=True))  # (Q, 1)
    cc = jnp.sum(summary_cent * summary_cent, axis=1)[None, :]
    if mode == "dot":
        guaranteed = qd - qn * summary_rad[None, :]
        optimistic = qd + qn * summary_rad[None, :]
        gkeys = guaranteed
        # Rounding slack: planner bounds and scan scores are different
        # f32 expansions; |q.row| <= |q| (||c|| + r), so eps * that scale
        # dominates both sides' rounding error (config.PRUNE_BOUND_EPS).
        slack = PRUNE_BOUND_EPS * qn * (jnp.sqrt(cc) + summary_rad[None, :])
    else:  # l2: distances, smaller = better
        qq = jnp.sum(qs * qs, axis=1, keepdims=True)
        qc = jnp.sqrt(jnp.maximum(qq + cc - 2.0 * qd, 0.0))  # ||q - c||
        guaranteed = (qc + summary_rad[None, :]) ** 2
        lower = jnp.maximum(qc - summary_rad[None, :], 0.0)
        optimistic = lower * lower
        gkeys = -guaranteed  # rank by smallest guaranteed distance first
        # Cancellation-aware scale: the scan's norms^2 - 2 q.r + ||q||^2
        # form loses bits against the qq + cc + 2|qd| magnitudes.
        slack = PRUNE_BOUND_EPS * (qq + cc + 2.0 * jnp.abs(qd))
    # Zero-valid-row tiles (masked summaries: pure-padding tiles in a
    # tile-aligned IVF layout) can never hold a winner: their bounds must
    # not dilute t0 (sort them last) and the tile itself is always dead.
    empty = (summary_cnt <= 0)[None, :]
    gkeys = jnp.where(empty, -jnp.inf, gkeys)
    if fast:
        # k fits inside a single tile (the caller statically verified a
        # tile with >= k rows exists): t0 = the best guaranteed bound
        # among eligible tiles — one masked max, no per-query argsort
        # (the argsort dominated plan cost at serving batch sizes).
        eligible = (summary_cnt >= k)[None, :]
        masked = jnp.where(
            eligible & ~jnp.isnan(gkeys), gkeys, -jnp.inf
        )
        t0g = jnp.max(masked, axis=1, keepdims=True)  # best gkey
        t0 = t0g if mode == "dot" else -t0g
    else:
        # Rank tiles by guaranteed bound (best first); NaN bounds sort
        # last (they can't *guarantee* anything) but keep their tiles
        # alive below.
        order_g = jnp.argsort(
            jnp.where(jnp.isnan(gkeys), jnp.inf, -gkeys), axis=1
        )  # ascending -gkeys == gkeys descending: best guarantee first
        cnt_sorted = summary_cnt[order_g]  # (Q, n_tiles)
        cum = jnp.cumsum(cnt_sorted, axis=1)
        # First position where cumulative rows >= k.
        pos = jnp.sum((cum < k).astype(jnp.int32), axis=1)  # (Q,)
        pos = jnp.minimum(pos, n_tiles - 1)
        t0 = jnp.take_along_axis(
            jnp.take_along_axis(guaranteed, order_g, axis=1), pos[:, None],
            axis=1,
        )  # (Q, 1)
    # Tile dead for a query iff optimistic bound fails t0 by more than the
    # f32 rounding slack; NaN comparisons are False -> tile stays alive.
    if mode == "dot":
        dead_q = optimistic + slack < t0
    else:
        dead_q = optimistic > t0 + slack
    alive = ~jnp.all(dead_q, axis=0)  # (n_tiles,)
    alive = alive & ~empty[0]  # no valid rows -> nothing to scan
    n_surv = jnp.sum(alive.astype(jnp.int32))
    # Survivors first in ascending tile order (stable: False < True).
    order = jnp.argsort(~alive, stable=True).astype(jnp.int32)
    return _pad_tail(order, n_surv, n_tiles), n_surv


@jax.jit
def plan_threshold_survivors(qs, summary_cent, summary_rad, threshold):
    """Survivor plan for a fixed L2^2 threshold scan
    (``batch_l2_squared_pruning``): a tile is dead iff its distance lower
    bound ``(max(0, ||q-c|| - r))^2`` exceeds ``threshold`` for every
    query — no row in it can pass. NaN bounds keep tiles alive. Returns
    ``(order, n_surv, alive)`` with the same repeat-the-last-survivor
    tail as :func:`plan_survivors`."""
    from innr_tpu.config import PRUNE_BOUND_EPS

    n_tiles = summary_cent.shape[0]
    qd = jnp.matmul(qs, summary_cent.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    qq = jnp.sum(qs * qs, axis=1, keepdims=True)
    cc = jnp.sum(summary_cent * summary_cent, axis=1)[None, :]
    qc = jnp.sqrt(jnp.maximum(qq + cc - 2.0 * qd, 0.0))
    lower = jnp.maximum(qc - summary_rad[None, :], 0.0)
    # Same cancellation-aware rounding slack as plan_survivors' l2 mode.
    slack = PRUNE_BOUND_EPS * (qq + cc + 2.0 * jnp.abs(qd))
    dead_q = lower * lower > threshold + slack  # NaN -> False -> alive
    alive = ~jnp.all(dead_q, axis=0)
    n_surv = jnp.sum(alive.astype(jnp.int32))
    order = jnp.argsort(~alive, stable=True).astype(jnp.int32)
    return _pad_tail(order, n_surv, n_tiles), n_surv, alive


def _kmeans_params(rows, n_clusters: int, sample: int):
    rows = jnp.asarray(rows)
    n = int(rows.shape[0])
    n_clusters = int(min(n_clusters, max(n, 1)))
    m = int(min(n, max(sample, n_clusters)))
    return rows, n_clusters, m


@partial(jax.jit, static_argnames=("iters", "kc", "m"))
def _kmeans_assign(r, key, iters: int, kc: int, m: int):
    """Sampled k-means++ fit + one full-corpus nearest-centroid pass ->
    (N,) int32 cluster assignment, entirely on device (shared by
    :func:`cluster_order` and :func:`cluster_reorder`).

    The fit's matmuls name no precision (TF32 on the GPU): the clustering
    only shapes the layout, and no result depends on it — pruned scans are
    exact under any layout."""
    k_sample, k_first, k_pp = jax.random.split(key, 3)
    r32 = r.astype(jnp.float32)
    # Sample WITH replacement: choice(replace=False) materializes a
    # random permutation of ALL N rows (a full N-key sort) to draw 65K of
    # them; duplicate draws are harmless to a k-means fit and randint is
    # O(m).
    s = r32[jax.random.randint(k_sample, (m,), 0, r.shape[0])]

    # k-means++ seeding runs on a SUB-sample of the Lloyd sample: the
    # seeding scan is kc-1 SEQUENTIAL steps whose per-step cost is a
    # d2 pass over its candidate pool. Seed
    # quality needs each true mode represented in the pool (thousands of
    # rows suffice), not the pool itself to be huge; Lloyd then refines
    # on the full sample. s is already a uniform draw, so a prefix of it
    # is one too.
    m_seed = min(m, 8192)
    ss = s[:m_seed]
    ssn = jnp.sum(ss * ss, axis=1)  # (m_seed,)

    def d2_to(c):
        # Exact-enough L2^2 of every seed-pool row to one center; the
        # max(., 0) keeps the categorical weights nonnegative.
        return jnp.maximum(
            ssn - 2.0 * jnp.matmul(ss, c, preferred_element_type=jnp.float32)
            + jnp.sum(c * c),
            0.0,
        )

    first = ss[jax.random.randint(k_first, (), 0, m_seed)]
    cent0 = jnp.zeros((kc, s.shape[1]), jnp.float32).at[0].set(first)

    def pp_step(carry, j):
        cents, mind2 = carry
        # Sample the next seed proportional to squared distance from
        # the chosen set (k-means++); all-zero mind2 (kc > distinct
        # rows) degrades to uniform via the categorical's clamp.
        logits = jnp.log(jnp.maximum(mind2, 1e-30))
        nxt = jax.random.categorical(jax.random.fold_in(k_pp, j), logits)
        c = ss[nxt]
        cents = jax.lax.dynamic_update_index_in_dim(cents, c, j, 0)
        return (cents, jnp.minimum(mind2, d2_to(c))), None

    (cent, _), _ = jax.lax.scan(
        pp_step, (cent0, d2_to(first)), jnp.arange(1, kc)
    )

    def nearest(cent, x):
        # Lloyd-step scoring over the SAMPLE (m rows — small). The
        # ||x||^2 term of the L2^2 expansion is a per-row constant — it
        # cannot change an argmin over centroids — so it is dropped
        # (one less (N,) broadcast per pass).
        d2 = (
            jnp.sum(cent * cent, axis=1)[None, :]
            - 2.0 * jnp.matmul(x, cent.T, preferred_element_type=jnp.float32)
        )
        return jnp.argmin(d2, axis=1)

    def step(cent, _):
        assign = nearest(cent, s)
        one_hot = jax.nn.one_hot(assign, kc, dtype=jnp.float32)
        sums = jnp.matmul(one_hot.T, s, preferred_element_type=jnp.float32)
        cnts = jnp.sum(one_hot, axis=0)[:, None]
        new_cent = jnp.where(cnts > 0, sums / jnp.maximum(cnts, 1.0), cent)
        return new_cent, None

    cent, _ = jax.lax.scan(step, cent, None, length=iters)
    # Ties and near-ties may resolve differently from the Lloyd-step
    # scoring — assignment affects only layout quality, never correctness
    # (module doc).
    return nearest_centroid(r, cent)


def nearest_centroid(rows: jax.Array, cent: jax.Array) -> jax.Array:
    """``(N,) int32`` index of each row's nearest centroid (squared L2,
    ties to the lowest index): one matmul in the corpus's stored dtype
    (:func:`innr_tpu.scan.dots`) and an argmin, which XLA fuses. The
    ``||row||^2`` term is the same for every centroid and is dropped."""
    from innr_tpu.scan import dots

    cent32 = cent.astype(jnp.float32)
    d2 = (jnp.sum(cent32 * cent32, axis=1)[:, None]
          - 2.0 * dots(cent32, rows))  # (kc, N)
    return jnp.argmin(d2, axis=0).astype(jnp.int32)



def cluster_order(rows, n_clusters: int = 256, n_iters: int = 5, seed: int = 0,
                  sample: int = 65536):
    """Device-side mini k-means ordering pass: returns a HOST permutation
    that groups rows by nearest centroid — the layout step that makes tile
    pruning effective on corpora that arrive in random order (IVF-style).

    Centers are seeded with **k-means++ on a row sample** (``sample``
    rows, capped at N): random-row init routinely drops whole true
    clusters — their rows then scatter across distant centroids, tiles
    straddle clusters, radii blow up, and the planner prunes almost
    nothing. k-means++ makes every
    well-separated mode get a seed with high probability. Lloyd then
    runs ``n_iters`` steps on the sample; the full corpus is scored
    ONCE for the final assignment. O(sample * n_clusters * D) fit +
    O(N * n_clusters * D) assign.

    Returns a host int64 permutation for callers who manage their own
    layout; prefer :func:`cluster_reorder` (all-device, no host
    round-trip of N-sized arrays, auto tile suggestion) for corpora that
    live on device. The permutation never affects correctness — pruned
    scans are exact under any layout — only the achievable pruning power.
    """
    rows, n_clusters, m = _kmeans_params(rows, n_clusters, sample)
    assign = _kmeans_assign(rows, jax.random.PRNGKey(seed), n_iters,
                            n_clusters, m)
    return np.argsort(np.asarray(assign), kind="stable")


@partial(jax.jit, static_argnames=("iters", "kc", "m"))
def _reorder_fused(r, key, iters: int, kc: int, m: int):
    """fit + assign + argsort + gather + bincount in ONE dispatch."""
    assign = _kmeans_assign(r, key, iters, kc, m)
    return _apply_order(r, assign, kc)


@partial(jax.jit, static_argnames=("kc",))
def _apply_order(rows, assign, kc: int):
    # ONE stable pair sort yields the permutation AND the sorted keys
    # (argsort runs the identical sort and throws the keys away); the
    # cluster sizes then come from kc+1 binary searches on the sorted
    # keys instead of an N-element scatter-add (jnp.bincount).
    n = assign.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    sorted_assign, perm = jax.lax.sort(
        (assign.astype(jnp.int32), iota), num_keys=1, is_stable=True
    )
    reordered = jnp.take(rows, perm, axis=0)
    bounds = jnp.searchsorted(
        sorted_assign, jnp.arange(kc + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    sizes = jnp.diff(bounds)
    return reordered, perm, sizes


def cluster_reorder(rows, n_clusters: int = 256, n_iters: int = 5,
                    seed: int = 0, sample: int = 65536):
    """All-device IVF layout pass: fit (sampled k-means++), assign,
    stable argsort, and the row gather happen on device with no host
    round-trip of any N-sized array.

    Returns ``(reordered_rows, perm (N,) int32 device, cluster_sizes
    (n_clusters,) int32 device)`` — ``reordered_rows[i] ==
    rows[perm[i]]``, so a kNN index ``j`` on the reordered corpus maps
    back as ``perm[j]``. Needs ~2x the corpus bytes of HBM during the
    gather (an out-of-place permutation). Feed ``cluster_sizes`` to
    :func:`suggest_tile_n` (or use ``VerticalBatch.cluster_reorder``,
    which wires both) so the pruning tile height matches the measured
    cluster granularity.
    """
    rows, n_clusters, m = _kmeans_params(rows, n_clusters, sample)
    return _reorder_fused(rows, jax.random.PRNGKey(seed), n_iters,
                          n_clusters, m)


def suggest_tile_n(cluster_sizes, n: int, d: int, dtype=None) -> int:
    """Pruning tile height matched to measured cluster granularity.

    A tile larger than the typical cluster straddles clusters, its
    radius approaches the inter-center distance, and nothing prunes.
    Cluster boundaries are not tile-aligned in a plain reorder, so even
    tile == cluster size leaves most tiles straddling two clusters; this
    picks HALF the 25th percentile of non-empty cluster sizes, rounded
    DOWN to a multiple of 128 rows, floored at 256 rows and capped at
    :func:`default_tile_n`. For clusters smaller than the floor the fix
    is :class:`innr_tpu.ivf.IVFIndex`, whose cluster-aligned tiles never
    straddle."""
    sizes = np.asarray(cluster_sizes)
    sizes = sizes[sizes > 0]
    cap = default_tile_n(n, d, dtype)
    if sizes.size == 0:
        return cap
    p25 = float(np.percentile(sizes, 25))
    tile = int(p25 / 2) // 128 * 128
    return int(max(256, min(tile, cap)))
