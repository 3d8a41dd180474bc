"""Hand-written kernels — innr_tpu's native layer.

The reference's native layer is ~3,000 lines of hand-written AVX-512 / NEON
intrinsics (``src/arch/``). Here a kernel exists only where it beat the
plain XLA route on the card at the shapes users run (``PERF.md``):

- :mod:`innr_tpu.kernels.triton_knn` — fused score + top-k dense corpus
  scan in Pallas through Triton, with an optional survivor tile list for
  the tile-skipping scan.

:func:`innr_tpu.route.route` decides when it runs. Every kernel has the
XLA route as its reference; tests run kernels in Pallas interpret mode,
passing ``interpret=True`` themselves.
"""
