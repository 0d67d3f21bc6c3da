"""Seeded SHA-512 rows for K2 (csrc/sha2.cu), shared by
tests/test_torch_sha512_host.py, tests/test_torch_cuda.py and
scripts/torch_k8_k15_ab.py: messages of every length up to nb blocks'
worth (the block-edge lengths first), SHA-512-padded by the port's host
padder, random bytes in each row's blocks past its own, and every 7th
row from the fourth at active = 0 (the state must stay the initial
one)."""

from __future__ import annotations

import numpy as np

from cometbft_tpu_torch.ops import sha2

EDGE_LENGTHS = (0, 1, 111, 112, 113, 127, 128, 239, 240, 256)


def stale_rows(rng: np.random.Generator, n: int, nb: int):
    """(msgs, blocks (n, nb, 128) uint8, active (n,) int32)."""
    top = nb * 128 - 17  # the longest message whose padding fits nb blocks
    lens = [m for m in EDGE_LENGTHS + (top,) if m <= top][:n]
    lens += rng.integers(0, top + 1, size=n - len(lens)).tolist()
    msgs = [rng.bytes(int(m)) for m in lens]
    blocks, active = sha2.pad_messages_sha512(msgs, max_len=top)
    blocks, active = blocks.copy(), active.copy()
    for i, a in enumerate(active.tolist()):
        blocks[i, a:] = rng.integers(0, 256, size=(nb - a, 128), dtype=np.uint8)
    active[3::7] = 0
    return msgs, blocks, active


def digests(msgs, active) -> list[bytes]:
    """hashlib's digest of each row, the initial state's bytes at active = 0."""
    import hashlib

    init = b"".join(h.to_bytes(8, "big") for h in sha2.H512)
    return [hashlib.sha512(m).digest() if a else init for m, a in zip(msgs, np.asarray(active).tolist())]
