"""Distribution layer: sharded corpora and distributed top-k merge.

The reference is single-core (survey §2.4: no threads, no distributed
communication of any kind); scaling past one device is an addition mandated
by the north star. The design: shard the corpus rows across a device mesh
with ``NamedSharding``, run the local scan per shard under
``shard_map``, all-gather the tiny per-shard (score, global-index) top-k
pairs, and merge — XLA supplies the collectives, there is no hand-written
transport layer.

Every op family is covered: f32 dot/L2/cosine (:class:`ShardedCorpus`),
1-bit Hamming (:class:`ShardedPackedBinary`), ternary
(:class:`ShardedPackedTernary`), asymmetric u8
(:class:`ShardedQuantizedU8`), slot-sketch / MinHash
(:class:`ShardedSlotCorpus`), MaxSim late interaction
(:class:`ShardedMaxSimCorpus`), and the two-stage coarse->rerank pipeline
(:class:`ShardedTwoStageIndex`).
"""

from innr_tpu.parallel.sharded import (  # noqa: F401
    ShardedCorpus,
    default_mesh,
    sharded_knn_cosine,
    sharded_knn_dot,
    sharded_knn_filtered,
    sharded_knn_l2,
)
from innr_tpu.parallel.sharded_packed import (  # noqa: F401
    ShardedPackedBinary,
    ShardedPackedTernary,
)
from innr_tpu.parallel.sharded_quant import ShardedQuantizedU8  # noqa: F401
from innr_tpu.parallel.sharded_slot import ShardedSlotCorpus  # noqa: F401
from innr_tpu.parallel.query_parallel import QueryParallelIndex  # noqa: F401
from innr_tpu.parallel.sharded_sparse import (  # noqa: F401
    ShardedSparseCorpus,
    ShardedSparseMaxSimCorpus,
)
from innr_tpu.parallel.grid import GridIndex, grid_mesh  # noqa: F401
from innr_tpu.parallel.hierarchical import (  # noqa: F401
    HierarchicalCorpus,
    hierarchical_mesh,
)
from innr_tpu.parallel.sharded_maxsim import ShardedMaxSimCorpus  # noqa: F401
from innr_tpu.parallel.sharded_pipeline import ShardedTwoStageIndex  # noqa: F401

__all__ = [
    "GridIndex",
    "QueryParallelIndex",
    "ShardedCorpus",
    "ShardedPackedBinary",
    "ShardedPackedTernary",
    "ShardedQuantizedU8",
    "ShardedSlotCorpus",
    "ShardedSparseCorpus",
    "ShardedSparseMaxSimCorpus",
    "ShardedMaxSimCorpus",
    "ShardedTwoStageIndex",
    "default_mesh",
    "grid_mesh",
    "sharded_knn_dot",
    "sharded_knn_l2",
    "sharded_knn_cosine",
    "sharded_knn_filtered",
]
