"""Rank fidelity of binary quantization: Spearman correlation between
binary-Hamming ranking and exact f32 cosine ranking
(reference examples/binary_vs_rabitq.rs — the qualitative comparison;
the RaBitQ crate itself has no JAX port, so this measures our encoder
against the exact ranking the way that example does).

Run: python examples/binary_vs_rabitq.py
"""

import numpy as np

import innr_tpu as it


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a))
    rb = np.argsort(np.argsort(b))
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    return float((ra @ rb) / np.sqrt((ra @ ra) * (rb @ rb)))


def main():
    rng = np.random.default_rng(17)
    n, d = 2_000, 512
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = rng.standard_normal(d).astype(np.float32)
    q /= np.linalg.norm(q)

    exact = corpus.astype(np.float64) @ q.astype(np.float64)

    packed = it.encode_binary_batch(corpus, 0.0)
    qp = it.encode_binary(q, 0.0)
    hamm = np.asarray(it.batch_binary_hamming(qp, packed)).astype(np.float64)

    rho = spearman(exact, -hamm)  # low Hamming = high similarity
    print(f"Spearman rho (binary Hamming vs exact cosine), d={d}: {rho:.3f}")
    # Pure-random corpora are the worst case for sign bits: the cosine
    # spread (~1/sqrt(d)) is comparable to the bit-estimator noise, so
    # rho ~ 0.6 at d=512 is expected; real (clustered) embeddings score
    # far higher (see binary_demo.py / two_stage_pipeline.py).
    assert rho > 0.45, "binary ranking must correlate at d=512"

    rhos = [rho]
    for d_small in (256, 128, 64):
        pk = it.encode_binary_batch(corpus[:, :d_small], 0.0)
        qk = it.encode_binary(q[:d_small], 0.0)
        hk = np.asarray(it.batch_binary_hamming(qk, pk)).astype(np.float64)
        # Exact ranking restricted to the same prefix, so the comparison
        # isolates quantization error from truncation error.
        exact_small = corpus[:, :d_small].astype(np.float64) @ q[:d_small].astype(np.float64)
        r = spearman(exact_small, -hk)
        rhos.append(r)
        print(f"  d={d_small}: rho = {r:.3f}")
    # With prefix-matched exact rankings, rho is roughly flat in d: both
    # the cosine spread and the sign-bit noise scale as 1/sqrt(d) on
    # isotropic data. It rises with d only when later dims add signal.
    assert all(r > 0.45 for r in rhos), rhos
    print("OK: rank fidelity stable across dimensions on isotropic data")


if __name__ == "__main__":
    main()
