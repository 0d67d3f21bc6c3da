"""Seeded SHA-512 rows for K2 (csrc/sha2.cu), SHA-256 rows for K7
(csrc/merkle.cu), Keccak-256 rows for K10 (csrc/keccak.cu) and payload
rows for K1 (csrc/sha2.cu), shared by tests/test_torch_sha512_host.py,
tests/test_torch_sha256_host.py, tests/test_torch_keccak_host.py,
tests/test_torch_k1_host.py, tests/test_torch_cuda.py, chip_smoke.py
and scripts/torch_k8_k15_ab.py: messages of every length up to nb
blocks' worth (the block-edge lengths first), padded by the port's host
padders, random bytes in each row's blocks past its own, and every 7th
row from the fourth at active = 0 (the state must stay the initial
one)."""

from __future__ import annotations

import numpy as np

from cometbft_tpu_torch.ops import keccak, sha2

EDGE_LENGTHS = (0, 1, 111, 112, 113, 127, 128, 239, 240, 256)
EDGE_LENGTHS_256 = (0, 1, 55, 56, 57, 63, 64, 119, 120, 128, 183, 184)
EDGE_LENGTHS_KECCAK = (0, 1, 135, 136, 137, 271, 272, 300)


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


def stale_rows_sha256(rng: np.random.Generator, n: int, nb: int):
    """(msgs, blocks (n, nb, 64) uint8, active (n,) int32): the SHA-256
    rows of stale_rows."""
    top = nb * 64 - 9  # the longest message whose padding fits nb blocks
    lens = [m for m in EDGE_LENGTHS_256 + (top,) if m <= top][:n]
    lens += rng.integers(0, top + 1, size=n - len(lens)).tolist()
    msgs = [rng.bytes(int(m)) for m in lens]
    blocks, active = sha2.pad_messages_sha256(msgs, max_len=top)
    blocks, active = blocks.copy(), active.copy()
    for i, a in enumerate(active.tolist()):
        blocks[i, a:] = rng.integers(0, 256, size=(nb - a, 64), dtype=np.uint8)
    active[3::7] = 0
    return msgs, blocks, active


def digests_sha256(msgs, active) -> list[bytes]:
    """hashlib's SHA-256 of each row, the initial state's bytes at active = 0."""
    import hashlib

    init = b"".join(h.to_bytes(4, "big") for h in sha2.H256)
    return [hashlib.sha256(m).digest() if a else init for m, a in zip(msgs, np.asarray(active).tolist())]


def payload_rows(rng: np.random.Generator, V: int, width: int):
    """(payload (V, width) uint8, pubs (V, 32) uint8) for K1: every mlen
    edge (0, 1, 47, 48, 63, 64, 111, 112, maxm), rows whose mlen exceeds
    maxm (up to 2^24 - 1), then random mlens; every 5th row from the
    third not live (live is the byte 1 alone); random bytes everywhere
    else."""
    maxm = width - 68
    edges = [m for m in (0, 1, 47, 48, 63, 64, 111, 112) if m <= maxm]
    edges += [maxm, maxm + 1, maxm + 17, 1000, (1 << 24) - 1]
    mlen = np.array((edges + rng.integers(0, maxm + 1, size=max(0, V - len(edges))).tolist())[:V], np.int64)
    payload = rng.integers(0, 256, size=(V, width), dtype=np.uint8)
    payload[:, 64], payload[:, 65], payload[:, 66] = mlen & 0xFF, (mlen >> 8) & 0xFF, mlen >> 16
    payload[:, 67] = 1
    payload[2::5, 67] = rng.choice(np.array([0, 2, 255], np.uint8), size=len(payload[2::5]))
    return payload, rng.integers(0, 256, size=(V, 32), dtype=np.uint8)


def stale_rows_keccak(rng: np.random.Generator, n: int, nb: int):
    """(msgs, blocks (n, nb, 136) uint8, active (n,) int32): the Keccak-256
    rows of stale_rows (0x01 ... 0x80 padding, 136-byte blocks)."""
    top = nb * keccak.RATE - 1  # the longest message whose padding fits nb blocks
    lens = [m for m in EDGE_LENGTHS_KECCAK + (top,) if m <= top][:n]
    lens += rng.integers(0, top + 1, size=n - len(lens)).tolist()
    msgs = [rng.bytes(int(m)) for m in lens]
    blocks, active = keccak.pad_messages_keccak(msgs, max_len=top)
    blocks, active = blocks.copy(), active.copy()
    for i, a in enumerate(active.tolist()):
        blocks[i, a:] = rng.integers(0, 256, size=(nb - a, keccak.RATE), dtype=np.uint8)
    active[3::7] = 0
    return msgs, blocks, active


def digests_keccak(msgs, active) -> list[bytes]:
    """The port's host Keccak-256 of each row, 32 zero bytes (the state
    before any block) at active = 0."""
    from cometbft_tpu_torch.crypto.keccak import keccak256

    return [keccak256(m) if a else bytes(32) for m, a in zip(msgs, np.asarray(active).tolist())]
