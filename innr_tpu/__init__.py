"""innr_tpu — vector-similarity kernel library for accelerators (JAX/XLA/Pallas).

A from-scratch JAX rebuild of the capabilities of ``arclabs561/innr``
(reference ``src/lib.rs``): dense f32/f64 similarity reductions, a columnar
batch-kNN engine, binary (1-bit) / ternary (1.58-bit) / scalar (uint8)
quantization with asymmetric scoring, ColBERT MaxSim late interaction,
sparse dot products, integer-slot Hamming / MinHash estimators, a top-K
tracker, and a pluggable distance protocol — redesigned for an accelerator
(an NVIDIA GPU; see README.md):

- batch scores run as matmuls, not per-pair dispatch;
- each scan family has one route (:mod:`innr_tpu.route`): plain XLA, or a
  hand-written Pallas kernel compiled through Triton where one beat XLA
  on the card (the dense score + top-k scan) — the analog of the
  reference's hand-written SIMD layer;
- corpora larger than one device shard across a device mesh with a
  distributed top-k merge (:mod:`innr_tpu.parallel`);
- f64 reductions can use double-f32 arithmetic (f64 runs at a fraction of
  the f32 rate on accelerators).

Contracts (reference ``src/lib.rs:34-46``): dispatching functions raise
:class:`~innr_tpu.utils.asserts.ContractError` on length mismatch (the
panic analog); similarity ops return 0.0 for effectively-zero norms
(< 1e-9); NaN propagates through dot/distances but cosine absorbs it;
empty reductions return 0.0 (``minhash_jaccard`` of empties returns 1.0).
"""

from innr_tpu import backend, batch, config, distance, io, loader, parallel, pipeline, prune, serving
from innr_tpu.distance import (
    Distance,
    DistCosine,
    DistDot,
    DistHamming,
    DistL1,
    DistL2,
    DistSlotU32,
)
from innr_tpu.pipeline import CoarseConfig, TwoStageIndex
from innr_tpu.serving import MicroBatcher
from innr_tpu.segmented import SegmentedCorpus
from innr_tpu.ivf import IVFIndex
from innr_tpu.prune import (
    TileSummary,
    build_tile_summary,
    cluster_order,
    cluster_reorder,
    suggest_tile_n,
)
from innr_tpu.batch import (
    BatchKnnResult,
    VerticalBatch,
    batch_cosine,
    batch_cosine_into,
    batch_dimension_variance,
    batch_dot,
    batch_dot_into,
    batch_knn,
    batch_knn_adaptive,
    batch_knn_cosine,
    batch_knn_dot,
    batch_knn_filtered,
    batch_knn_reordered,
    batch_l2_squared,
    batch_l2_squared_into,
    batch_l2_squared_pruning,
    batch_norms,
    batch_norms_into,
)
from innr_tpu.ops.binary import (
    PackedBinary,
    PackedBinaryBatch,
    batch_binary_hamming,
    binary_dot,
    binary_hamming,
    binary_jaccard,
    binary_knn,
    encode_binary,
    encode_binary_batch,
)
from innr_tpu.ops.dense import (
    angular_distance,
    cosine,
    dot,
    l1_distance,
    l2_distance,
    l2_distance_squared,
    matryoshka_cosine,
    matryoshka_dot,
    norm,
    normalize,
    normalize_with_norm,
)
from innr_tpu.ops.dense_f64 import (
    cosine_f64,
    dot_f64,
    l1_distance_f64,
    l2_distance_f64,
    l2_distance_squared_f64,
    norm_f64,
    normalize_f64,
)
from innr_tpu.ops.fast_math import (
    fast_cosine,
    fast_cosine_dispatch,
    fast_rsqrt,
    fast_rsqrt_precise,
)
from innr_tpu.ops.maxsim import (
    batch_maxsim,
    maxsim,
    maxsim_cosine,
    maxsim_knn,
    maxsim_knn_batch,
)
from innr_tpu.ops.quant import batch_dot_u8, batch_hamming, dot_u8, hamming_distance
from innr_tpu.ops.scalar import (
    QuantizationParams,
    QuantizedU8,
    QuantizedU8Batch,
    QueryContext,
    asymmetric_dot_u8,
    asymmetric_dot_u8_precomputed,
    batch_knn_u8,
    mixed_dot_u8_f32,
    quantize_u8,
    query_context,
)
from innr_tpu.ops.slot import (
    SketchCorpus,
    SlotCounts,
    batch_slot_hamming_u32,
    jaccard_distance,
    minhash_jaccard,
    minhash_knn,
    minhash_knn_batch,
    slot_compare_counts,
    slot_hamming,
    slot_hamming_u16,
    slot_hamming_u32,
    slot_hamming_u64,
    slot_knn_u16,
    slot_knn_u16_batch,
    slot_knn_u32,
    slot_knn_u32_batch,
)
from innr_tpu.ops.sparse import (
    SparseCorpus,
    pad_sparse,
    pad_sparse_docs,
    sparse_dot,
    sparse_knn,
    sparse_knn_batch,
    sparse_maxsim,
    sparse_maxsim_batch,
    sparse_maxsim_knn,
)
from innr_tpu.ops.ternary import (
    PackedTernary,
    PackedTernaryBatch,
    asymmetric_dot,
    batch_asymmetric_dot,
    batch_ternary_dot,
    encode_ternary,
    encode_ternary_batch,
    sparsity,
    ternary_dot,
    ternary_hamming,
    ternary_knn,
)
from innr_tpu.ops.topk import TopK
from innr_tpu.utils.asserts import ContractError

__version__ = "0.1.0"
