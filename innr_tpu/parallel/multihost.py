"""Multi-host initialization and corpus construction.

The single-controller JAX runtime spans hosts once ``jax.distributed`` is
initialized: every process sees the global device list, `Mesh` axes can
span hosts, and XLA routes collectives over the links within a host and
the network between hosts (survey §5.8 — the framework supplies shardings, not a
transport layer).

Deployment recipe for an N-host corpus:

1. every process calls :func:`initialize`, passing coordinator/process
   counts explicitly or via the standard env vars;
2. each host loads ONLY its local rows (1/N of the corpus — no host ever
   materializes the full array) and calls
   :func:`corpus_from_process_local_rows`, which assembles a globally
   sharded :class:`~innr_tpu.parallel.ShardedCorpus` from the per-process
   pieces;
3. queries run exactly as on one host — the distributed kNN merge is
   topology-blind (per-shard top-k is local; only (key, index) pairs cross
   devices).

Smoke-tested by ``tests/test_multihost.py``: two local CPU processes, four
virtual devices each, global 8-device mesh, distributed kNN parity with a
single-process scan.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from innr_tpu.parallel.sharded import AXIS, ShardedCorpus, default_mesh
from innr_tpu.utils.asserts import ContractError
from innr_tpu.utils.padding import round_up

__all__ = [
    "initialize",
    "is_multiprocess",
    "corpus_from_process_local_rows",
]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Initialize the multi-process JAX runtime (idempotent).

    Pass the arguments explicitly or via the standard env vars
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``). A no-op when already initialized or when no
    multi-process configuration is present (single-host use).
    """
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return  # single-host; nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def is_multiprocess() -> bool:
    """True when the runtime spans more than one process."""
    return jax.process_count() > 1


def corpus_from_process_local_rows(
    local_rows, n_total: int | None = None, mesh=None
) -> ShardedCorpus:
    """Assemble a globally sharded :class:`ShardedCorpus` from per-process
    row blocks, without any host materializing the full corpus.

    ``local_rows``: this process's contiguous block of the global corpus,
    in process order (process 0 holds rows ``[0, n0)``, process 1
    ``[n0, n0+n1)``, ...). Every process must pass the same ``n_total``
    (defaults to ``process_count * local_rows.shape[0]``, which requires
    equal blocks). The global row axis pads to the mesh size exactly like
    the single-host constructor; padded rows can never win a scan.
    """
    local_rows = np.asarray(local_rows, dtype=np.float32)
    if local_rows.ndim != 2:
        raise ContractError(
            "corpus_from_process_local_rows: local_rows must be 2-D"
        )
    mesh = mesh if mesh is not None else default_mesh()
    n_devices = int(mesh.devices.size)
    if n_total is None:
        n_total = jax.process_count() * int(local_rows.shape[0])
    n_pad = round_up(max(int(n_total), n_devices), n_devices)

    sharding = NamedSharding(mesh, P(AXIS, None))
    global_shape = (n_pad, int(local_rows.shape[1]))
    # Pad the final process's block so the concatenation covers n_pad.
    owned = jax.process_count() * int(local_rows.shape[0])
    if jax.process_index() == jax.process_count() - 1 and owned < n_pad:
        extra = n_pad - owned
        local_rows = np.concatenate(
            [local_rows, np.zeros((extra, local_rows.shape[1]), np.float32)]
        )
    rows = jax.make_array_from_process_local_data(
        sharding, local_rows, global_shape
    )

    corpus = ShardedCorpus.__new__(ShardedCorpus)
    corpus.mesh = mesh
    corpus.n_true = int(n_total)
    corpus.n_pad = n_pad
    corpus.rows = rows
    corpus._norms2 = None
    corpus._inv_norms = None
    corpus._summaries = {}
    corpus._prune_tile_n = None
    return corpus
