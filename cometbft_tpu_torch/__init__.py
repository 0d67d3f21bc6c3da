"""PyTorch/CUDA port of the cometbft_tpu verify plane (first slice: ed25519 VerifyCommit through the comb-cached kernels)."""
