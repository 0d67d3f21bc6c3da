"""Host crypto for the PyTorch/CUDA port: the bigint oracle, address
hashing, ed25519 keys, and the batch-verifier factory."""
