"""Micro-batching serving layer: coalesce single-query requests into one
fused launch.

Why this exists: every launch pays a fixed floor (dispatch, and the host
round trip for the result), so a caller issuing one query at a time gets
floor-bound latency and ~1/batch of the achievable QPS — the corpus read
is shared by every query in a batch, so per-query cost collapses with
batch size. The
reference never needed this (a CPU library call has no launch floor), but
the survey's serving north star (SURVEY.md §6 "MaxSim QPS") does.

:class:`MicroBatcher` wraps any batched search backend. Concurrent callers
block in :meth:`search` (or get a ``Future`` from :meth:`submit`); a
collector thread accumulates requests until ``max_batch`` are waiting or
the oldest has waited ``max_wait_ms``, then hands the window to a flush
worker: ONE fused launch for the whole window, every caller woken with its
own row of the result. Batches are padded up to a small set of bucket
sizes (powers of two, plus quarter-steps above ``max_batch/2`` so
near-full windows don't pad all the way up) so XLA compiles each shape
once, not once per window occupancy.

``pipeline_depth`` flush workers (default 2) keep one launch in flight
while the next window collects and the previous result fetches: the
launch floor is mostly round-trip LATENCY, not device occupancy, so
overlapping two in-flight windows raises coalesced QPS.

Single-caller note: with no concurrency there is nothing to coalesce —
each request pays up to ``max_wait_ms`` extra latency (keep it small, a
few ms, well under the launch floor it amortizes). The batcher exists for
the many-clients serving shape; for offline scans call the batched API
directly.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from innr_tpu.utils.asserts import ContractError

__all__ = ["MicroBatcher", "BatcherStats"]


@dataclass
class BatcherStats:
    """Observability counters (the reference's memory_bytes/backend
    introspection discipline applied to the serving layer)."""

    requests: int = 0
    launches: int = 0
    batch_histogram: dict = field(default_factory=dict)

    @property
    def mean_batch(self) -> float:
        return self.requests / self.launches if self.launches else 0.0


class _Request:
    __slots__ = ("query", "future")

    def __init__(self, query):
        self.query = query
        self.future = Future()


def _bucket(n: int, max_batch: int) -> int:
    """Smallest padded size >= n from the bucket ladder, capped at
    max_batch (one XLA compilation per bucket instead of one per window
    occupancy). The ladder is powers of two up to ``max_batch/2``, then
    quarter-steps of ``max_batch`` — a 17-query window on max_batch=32
    pads to 24, not 32 (the pure power-of-two ladder wasted up to ~2x
    compute exactly where windows are largest)."""
    b = 1
    while b < n and b < max_batch // 2:
        b *= 2
    if b >= n:
        return min(b, max_batch)
    step = max(max_batch // 4, 1)
    while b < n:
        b += step
    return min(b, max_batch)


class MicroBatcher:
    """Coalesces concurrent single-query searches into fused batch launches.

    ``backend``: either an object with ``search_batch(queries, k)``
    returning a ``BatchKnnResult`` (:class:`innr_tpu.pipeline.TwoStageIndex`),
    an object with ``knn_dot(queries, k)`` returning ``(values, indices)``
    (:class:`innr_tpu.parallel.QueryParallelIndex` /
    :class:`~innr_tpu.parallel.ShardedCorpus`), or a callable
    ``f(queries (Q, D)) -> (values (Q, k), indices (Q, k))``.

    ``k``: neighbors per query (fixed per batcher — one compiled program).
    ``max_batch``: flush when this many requests are waiting (also the
    largest pad bucket).
    ``max_wait_ms``: flush when the OLDEST waiting request is this old.

    Use as a context manager or call :meth:`close`; ``search`` is safe
    from any number of threads.
    """

    def __init__(self, backend, k: int, max_batch: int = 32,
                 max_wait_ms: float = 2.0, pipeline_depth: int = 2):
        if k < 1:
            raise ContractError("MicroBatcher: k must be >= 1")
        if max_batch < 1:
            raise ContractError("MicroBatcher: max_batch must be >= 1")
        if pipeline_depth < 1:
            raise ContractError("MicroBatcher: pipeline_depth must be >= 1")
        self.k = int(k)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._scan = self._make_scan(backend)
        self.stats = BatcherStats()
        self._lock = threading.Condition()
        self._queue: list[_Request] = []
        self._oldest_t = 0.0
        self._closed = False
        # Flush workers: while one window's launch+fetch round trip is in
        # flight, the collector keeps collecting and the next window can
        # launch — the floor is RTT latency, not device occupancy, so
        # depth 2 nearly doubles coalesced QPS (module doc).
        self._depth = int(pipeline_depth)
        self._pool = ThreadPoolExecutor(
            max_workers=self._depth,
            thread_name_prefix="innr-microbatcher-flush",
        )
        self._inflight = 0
        self._collector = threading.Thread(
            target=self._collect_loop, name="innr-microbatcher", daemon=True
        )
        self._collector.start()

    @staticmethod
    def _make_scan(backend):
        if callable(backend) and not hasattr(backend, "search_batch") \
                and not hasattr(backend, "knn_dot"):
            import inspect

            try:
                n_params = sum(
                    1
                    for p in inspect.signature(backend).parameters.values()
                    if p.kind
                    in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                    and p.default is p.empty
                )
            except (TypeError, ValueError):  # builtins without signatures
                n_params = 1
            if n_params >= 2:
                return backend  # f(queries, k)
            return lambda qs, k, _b=backend: _b(qs)  # f(queries)
        if hasattr(backend, "search_batch"):
            return lambda qs, k, _b=backend: _b.search_batch(qs, k)
        if hasattr(backend, "knn_dot"):
            return lambda qs, k, _b=backend: _b.knn_dot(qs, k)
        raise ContractError(
            "MicroBatcher: backend must expose search_batch(queries, k), "
            "knn_dot(queries, k), or be callable(queries)"
        )

    # -- caller side --------------------------------------------------------

    def submit(self, query) -> Future:
        """Non-blocking single-query search: returns a
        :class:`concurrent.futures.Future` resolving to ``(values (k,),
        indices (k,))`` NumPy arrays — the async interface a real server
        loop needs (resolve with ``future.result()``, add callbacks with
        ``future.add_done_callback``, or bridge to asyncio via
        ``asyncio.wrap_future``). Coalesces with concurrent callers."""
        q = np.asarray(query, dtype=np.float32)
        if q.ndim != 1:
            raise ContractError(
                f"MicroBatcher.search: query must be 1-D, got {q.shape}"
            )
        req = _Request(q)
        with self._lock:
            if self._closed:
                raise ContractError("MicroBatcher: closed")
            if not self._queue:
                self._oldest_t = time.monotonic()
            self._queue.append(req)
            self._lock.notify_all()
        return req.future

    def search(self, query, timeout: float | None = 30.0):
        """Blocking single-query search; returns ``(values (k,), indices
        (k,))`` NumPy arrays. Coalesces with concurrent callers."""
        return self.submit(query).result(timeout)

    # -- collector side -----------------------------------------------------

    def _collect_loop(self):
        while True:
            with self._lock:
                while not self._closed:
                    if len(self._queue) >= self.max_batch:
                        break
                    if self._queue:
                        wait = self._oldest_t + self.max_wait_s - time.monotonic()
                        # <= vs < is indistinguishable here: at wait == 0
                        # exactly, the next iteration recomputes a strictly
                        # smaller wait and breaks anyway.
                        if wait <= 0:
                            # Every flush worker busy: keep collecting (a
                            # bigger window amortizes better than a queued
                            # launch); workers notify on completion.
                            if self._inflight < self._depth:
                                break
                        self._lock.wait(timeout=self.max_wait_s)
                    else:
                        self._lock.wait()
                if self._closed and not self._queue:
                    return
                window = self._queue[: self.max_batch]
                del self._queue[: self.max_batch]
                if self._queue:
                    self._oldest_t = time.monotonic()
                self._inflight += 1
            self._pool.submit(self._flush, window)

    def _flush(self, window):
        try:
            n = len(window)
            bucket = _bucket(n, self.max_batch)
            qs = np.stack(
                [r.query for r in window]
                + [window[0].query] * (bucket - n)  # pad rows are discarded
            )
            res = self._run(qs)
            vals, idx = self._normalize(res)
            for i, r in enumerate(window):
                r.future.set_result((vals[i], idx[i]))
            with self._lock:
                self.stats.requests += n
                self.stats.launches += 1
                self.stats.batch_histogram[bucket] = (
                    self.stats.batch_histogram.get(bucket, 0) + 1
                )
        except Exception as e:  # noqa: BLE001 — delivered to each caller
            for r in window:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            with self._lock:
                self._inflight -= 1
                self._lock.notify_all()

    def _run(self, qs):
        return self._scan(qs, self.k)

    @staticmethod
    def _normalize(res):
        if hasattr(res, "indices"):  # BatchKnnResult
            return res.scores, res.indices
        vals, idx = res
        if not (isinstance(vals, np.ndarray) and isinstance(idx, np.ndarray)):
            # Device arrays: ONE device_get for the pair — per-request
            # np.asarray row fetches would cost a host round trip EACH,
            # 2 x batch of them here.
            import jax

            vals, idx = jax.device_get((vals, idx))
        return np.asarray(vals), np.asarray(idx)

    # -- lifecycle ----------------------------------------------------------

    def close(self):
        """Drain pending requests, stop the collector and flush workers."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._collector.join(timeout=60.0)
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
