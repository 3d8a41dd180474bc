"""Learned-sparse (SPLADE-style) retrieval: sparse corpus -> top-k scan ->
parity with dense scoring, plus the sharded form.

The reference's sparse API is pairwise (src/sparse.rs: merge-join dot,
sparse_maxsim); this example exercises its corpus-scale batch form:
documents as sorted (indices, values) pairs over a hashed 30K-term space,
queries retrieved via `sparse_knn` / `sparse_knn_batch`, verified against
an exact dense-scatter oracle, then distributed with ShardedSparseCorpus.

Run: python examples/sparse_retrieval.py
"""

import numpy as np

import innr_tpu as it


VOCAB = 30_000


def make_doc(rng, nnz):
    idx = np.sort(rng.choice(VOCAB, nnz, replace=False)).astype(np.uint32)
    # SPLADE-like positive term weights with a heavy tail.
    val = rng.gamma(1.5, 0.8, nnz).astype(np.float32)
    return idx, val


def densify(pair):
    d = np.zeros(VOCAB, np.float64)
    d[pair[0].astype(np.int64)] = pair[1].astype(np.float64)
    return d


def main():
    rng = np.random.default_rng(17)
    n_docs = 4_000

    docs = [make_doc(rng, int(rng.integers(8, 48))) for _ in range(n_docs)]
    # Queries: term-overlapping views of planted docs (a few shared terms,
    # reweighted) — the lexical-retrieval regime sparse models live in.
    planted = [100, 2_000, 3_999]
    queries = []
    for p in planted:
        pi, pv = docs[p]
        take = rng.choice(pi.size, min(8, pi.size), replace=False)
        order = np.argsort(pi[take])
        queries.append((pi[take][order], (pv[take] * 2.0)[order]))

    corpus = it.SparseCorpus(docs)
    nnz_total = sum(d[0].size for d in docs)
    print(f"{n_docs} docs, {nnz_total} nonzeros -> padded (N, {corpus.width}) "
          f"({corpus.memory_bytes() / 1e6:.1f} MB vs "
          f"{n_docs * VOCAB * 4 / 1e9:.1f} GB dense)")

    # Single-query retrieval == exact dense-scatter oracle.
    for qi, q in enumerate(queries):
        scores, idx = it.sparse_knn(q, corpus, 10)
        dq = densify(q)
        ref = np.array([densify(d) @ dq for d in docs], np.float32)
        want = np.argsort(-ref, kind="stable")[:10]
        assert list(np.asarray(idx)) == list(want), qi
        np.testing.assert_allclose(np.asarray(scores), ref[want], rtol=1e-5)
        assert int(np.asarray(idx)[0]) == planted[qi], (
            "planted doc must rank first (it shares every query term)"
        )
    print("single-query parity with the dense oracle: exact, "
          "planted docs rank first")

    # Multi-query: one call for the batch.
    sb, ib = it.sparse_knn_batch(queries, corpus, 10)
    for qi in range(len(queries)):
        s1, i1 = it.sparse_knn(queries[qi], corpus, 10)
        assert list(np.asarray(ib)[qi]) == list(np.asarray(i1))
    print(f"batch retrieval consistent across {len(queries)} queries")

    # Distributed: same results over a sharded corpus.
    from innr_tpu.parallel import ShardedSparseCorpus

    sharded = ShardedSparseCorpus(docs)
    for qi, q in enumerate(queries):
        sv, si = sharded.knn(q, 10)
        s1, i1 = it.sparse_knn(q, corpus, 10)
        assert list(np.asarray(si)) == list(np.asarray(i1)), qi
        np.testing.assert_allclose(np.asarray(sv), np.asarray(s1), rtol=1e-6)
    print(f"sharded retrieval identical over {sharded.mesh.devices.size} device(s)")
    print("sparse_retrieval: all assertions passed")


if __name__ == "__main__":
    main()
