"""Hand-written Hopper kernels and their plain PyTorch versions.

  gram           the gram-plane precompute: per-step CountSketch tables
                 of the extended rows (+ G = R R^T, S0 = W0 R^T)
  majority_vote  pairwise replica agreement for the 2f+1 vote (batched
                 and single)
  fused_step     the fused plane's one pass per step: W' = W - cw @ rows,
                 W' @ rows^T and the step's sketch table
  sketch         CountSketch of flat vectors (batched and single): the
                 unfused plane's per-step pre-sketch
  coded_encode   linear encode (batched and single): the per-problem
                 plane's aggregation
  flash_attention  GQA attention forward with causal / window masks:
                 every prefill layer of the served models

CUDA sources are in ``csrc/``, built by ``_build`` at first use;
``ops`` dispatches by device; ``ref`` holds the plain oracles.
"""
