"""API-surface parity: every public symbol the reference crate re-exports
(or documents as a module API) has a counterpart reachable from innr_tpu.

This is the switch-over checklist for a user of the reference
(reference ``src/lib.rs:120-161`` re-exports plus per-module public items).
"""

import innr_tpu as it


# reference src/lib.rs crate-root re-exports -> innr_tpu top-level names
CRATE_ROOT_EXPORTS = [
    # dense
    "angular_distance", "cosine", "dot", "l1_distance", "l2_distance",
    "l2_distance_squared", "matryoshka_cosine", "matryoshka_dot", "norm",
    "normalize", "normalize_with_norm",
    # binary
    "binary_dot", "binary_hamming", "binary_jaccard", "encode_binary",
    "PackedBinary",
    # fast math
    "fast_cosine", "fast_cosine_dispatch", "fast_rsqrt", "fast_rsqrt_precise",
    # sparse
    "sparse_dot", "sparse_maxsim",
    # maxsim
    "maxsim", "maxsim_cosine",
    # quant
    "dot_u8", "hamming_distance",
    # slot
    "jaccard_distance", "minhash_jaccard", "slot_compare_counts",
    "slot_hamming", "slot_hamming_u16", "slot_hamming_u32",
    "slot_hamming_u64", "SlotCounts",
    # topk
    "TopK",
]

MODULE_APIS = {
    # reference pub mod ternary
    "ternary": ["PackedTernary", "encode_ternary", "ternary_dot",
                "asymmetric_dot", "ternary_hamming", "sparsity"],
    # reference pub mod scalar
    "scalar": ["QuantizationParams", "QuantizedU8", "quantize_u8",
               "QueryContext", "query_context", "asymmetric_dot_u8",
               "asymmetric_dot_u8_precomputed", "mixed_dot_u8_f32",
               "batch_knn_u8"],
    # reference pub mod batch
    "batch": ["VerticalBatch", "BatchKnnResult", "batch_l2_squared",
              "batch_l2_squared_into", "batch_dot", "batch_dot_into",
              "batch_l2_squared_pruning", "batch_knn", "batch_knn_adaptive",
              "batch_dimension_variance", "batch_knn_reordered",
              "batch_norms", "batch_norms_into", "batch_cosine",
              "batch_cosine_into", "batch_knn_dot", "batch_knn_cosine",
              "batch_knn_filtered"],
    # reference pub mod dense_f64
    "dense_f64": ["dot_f64", "norm_f64", "normalize_f64", "cosine_f64",
                  "l2_distance_squared_f64", "l2_distance_f64",
                  "l1_distance_f64"],
}

DISTANCE_METRICS = [
    "Distance", "DistCosine", "DistDot", "DistL2", "DistL1",
    "DistHamming", "DistSlotU32",
]

SPARSE_EXT = [
    "sparse_dot", "sparse_dense_dot", "sparse_l2_norm", "sparse_normalize",
    "sparse_top_k", "sparse_max_weight",
]


def test_crate_root_exports_present():
    missing = [n for n in CRATE_ROOT_EXPORTS if not hasattr(it, n)]
    assert not missing, f"missing top-level exports: {missing}"


def test_module_apis_present():
    missing = []
    for name in MODULE_APIS["ternary"] + MODULE_APIS["scalar"]:
        if not hasattr(it, name):
            missing.append(name)
    for name in MODULE_APIS["batch"]:
        if not hasattr(it, name) and not hasattr(it.batch, name):
            missing.append(f"batch.{name}")
    for name in MODULE_APIS["dense_f64"]:
        if not hasattr(it, name):
            missing.append(name)
    assert not missing, f"missing module APIs: {missing}"


def test_distance_metrics_present():
    from innr_tpu import distance

    missing = [n for n in DISTANCE_METRICS if not hasattr(distance, n)]
    assert not missing, f"missing distance metrics: {missing}"


def test_sparse_ext_present():
    from innr_tpu.ops import sparse_ext

    missing = [n for n in SPARSE_EXT if not hasattr(sparse_ext, n)]
    assert not missing, f"missing sparse_ext APIs: {missing}"


def test_backend_introspection_present():
    from innr_tpu import backend

    assert hasattr(backend, "Backend")
    assert hasattr(backend, "dense_backend")
    assert hasattr(backend, "slot_backend")


def test_portable_oracles_present():
    """The reference's *_portable fallbacks -> the NumPy oracle layer."""
    from innr_tpu.ops import reference as ref

    for name in ["dot_portable", "cosine_portable", "l1_distance_portable",
                 "l2_distance_squared_portable", "dot_u8_portable",
                 "hamming_portable", "slot_hamming_portable",
                 "sparse_dot_portable", "maxsim_portable"]:
        assert hasattr(ref, name), name


def test_native_additions_present():
    """The survey §2.4-mandated additions and serving layer."""
    from innr_tpu.parallel import ShardedCorpus, ShardedPackedBinary  # noqa
    from innr_tpu.pipeline import TwoStageIndex  # noqa
    from innr_tpu.io import save_npz, load_npz  # noqa
    from innr_tpu.loader import encode_binary_host  # noqa

    assert hasattr(it, "maxsim_knn")
    assert hasattr(it, "minhash_knn")
    assert hasattr(it, "binary_knn")
    assert hasattr(it, "ternary_knn")


class TestReferenceApiParity:
    """Every public symbol of the reference crate (pub fn/struct/enum/trait
    across src/*.rs, v0.6.3) must be reachable in innr_tpu — at the package
    root or in its documented module home. Renames are explicit below with
    their rationale; anything else missing fails the gate."""

    # Reference symbol -> (module, name) when not at the package root.
    RELOCATED = {
        # Portable fallbacks live in the oracle module (ops/reference.py).
        "cosine_portable": ("innr_tpu.ops.reference", "cosine_portable"),
        "dot_portable": ("innr_tpu.ops.reference", "dot_portable"),
        "dot_u8_portable": ("innr_tpu.ops.reference", "dot_u8_portable"),
        "hamming_portable": ("innr_tpu.ops.reference", "hamming_portable"),
        "l1_distance_portable": ("innr_tpu.ops.reference", "l1_distance_portable"),
        "l2_distance_squared_portable": (
            "innr_tpu.ops.reference", "l2_distance_squared_portable",
        ),
        "sparse_dot_portable": ("innr_tpu.ops.reference", "sparse_dot_portable"),
        # One portable covers all slot widths (no per-ISA paths here).
        "slot_hamming_u32_portable": (
            "innr_tpu.ops.reference", "slot_hamming_portable",
        ),
        # Backend introspection module (reference src/backend.rs).
        "Backend": ("innr_tpu.backend", "Backend"),
        "dense_backend": ("innr_tpu.backend", "dense_backend"),
        "slot_backend": ("innr_tpu.backend", "slot_backend"),
        # Tuple sparse API (reference feature "sparse" -> src/sparse_ext.rs).
        "sparse_dense_dot": ("innr_tpu.ops.sparse_ext", "sparse_dense_dot"),
        "sparse_l2_norm": ("innr_tpu.ops.sparse_ext", "sparse_l2_norm"),
        "sparse_max_weight": ("innr_tpu.ops.sparse_ext", "sparse_max_weight"),
        "sparse_normalize": ("innr_tpu.ops.sparse_ext", "sparse_normalize"),
        "sparse_top_k": ("innr_tpu.ops.sparse_ext", "sparse_top_k"),
    }

    REFERENCE_PUBLIC = [
        "Backend", "BatchKnnResult", "DistCosine", "DistDot", "DistHamming",
        "DistL1", "DistL2", "DistSlotU32", "Distance", "PackedBinary",
        "PackedTernary", "QuantizationParams", "QuantizedU8", "QueryContext",
        "SlotCounts", "TopK", "VerticalBatch", "angular_distance",
        "asymmetric_dot", "asymmetric_dot_u8", "asymmetric_dot_u8_precomputed",
        "batch_cosine", "batch_cosine_into", "batch_dimension_variance",
        "batch_dot", "batch_dot_into", "batch_knn", "batch_knn_adaptive",
        "batch_knn_cosine", "batch_knn_dot", "batch_knn_filtered",
        "batch_knn_reordered", "batch_knn_u8", "batch_l2_squared",
        "batch_l2_squared_into", "batch_l2_squared_pruning", "batch_norms",
        "batch_norms_into", "binary_dot", "binary_hamming", "binary_jaccard",
        "cosine", "cosine_f64", "cosine_portable", "dense_backend", "dot",
        "dot_f64", "dot_portable", "dot_u8", "dot_u8_portable",
        "encode_binary", "encode_ternary", "fast_cosine",
        "fast_cosine_dispatch", "fast_rsqrt", "fast_rsqrt_precise",
        "hamming_distance", "hamming_portable", "jaccard_distance",
        "l1_distance", "l1_distance_f64", "l1_distance_portable",
        "l2_distance", "l2_distance_f64", "l2_distance_squared",
        "l2_distance_squared_f64", "l2_distance_squared_portable",
        "matryoshka_cosine", "matryoshka_dot", "maxsim", "maxsim_cosine",
        "minhash_jaccard", "mixed_dot_u8_f32", "norm", "norm_f64",
        "normalize", "normalize_f64", "normalize_with_norm", "quantize_u8",
        "query_context", "slot_backend", "slot_compare_counts",
        "slot_hamming", "slot_hamming_u16", "slot_hamming_u32",
        "slot_hamming_u32_portable", "slot_hamming_u64", "sparse_dense_dot",
        "sparse_dot", "sparse_dot_portable", "sparse_l2_norm",
        "sparse_max_weight", "sparse_maxsim", "sparse_normalize",
        "sparse_top_k", "sparsity", "ternary_dot", "ternary_hamming",
    ]

    def test_every_reference_symbol_reachable(self):
        import importlib

        import innr_tpu

        missing = []
        for name in self.REFERENCE_PUBLIC:
            if name in self.RELOCATED:
                mod, attr = self.RELOCATED[name]
                if not hasattr(importlib.import_module(mod), attr):
                    missing.append(f"{name} (expected {mod}.{attr})")
            elif not hasattr(innr_tpu, name):
                missing.append(name)
        assert not missing, f"reference symbols unreachable: {missing}"
