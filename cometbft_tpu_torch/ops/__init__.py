"""Device operations of the commit path: field, scalar and group
arithmetic (plain PyTorch), and the wrappers of the four CUDA kernels
(sha2: K1, K2; comb: K3, K4)."""
