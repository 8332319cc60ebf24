"""Hand-written Hopper kernels and their plain PyTorch versions.

  gram           the gram-plane precompute: per-step CountSketch tables
                 of the extended rows (+ G = R R^T, S0 = W0 R^T)
  majority_vote  batched pairwise replica agreement for the 2f+1 vote

CUDA sources are in ``csrc/``, built by ``_build`` at first use;
``ops`` dispatches by device; ``ref`` holds the plain oracles.
"""
