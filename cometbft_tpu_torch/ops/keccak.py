"""Batched Keccak-256 (the original Ethereum padding 0x01 ... 0x80, NOT
SHA3-256's 0x06) — K10, the port of cometbft_tpu/ops/keccak.py.

Kernel (CUDA C++ in csrc/keccak.cu, its row body on a pair of threads in
csrc/keccak_group.cuh):

  K10 ``keccak256_blocks``  replaces cometbft_tpu/ops/keccak.py:144

Multi-block messages use the blocks + active contract of
ops/sha2.sha256_blocks: (N, nb, 136) padded blocks and a per-row count
of live blocks; a row's state stops changing after its own last block.
The wrapper launches K10 for a CUDA tensor and runs the plain PyTorch
version for a CPU tensor; ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from ..crypto.keccak import _RC, _ROT

RATE = 136  # 1088-bit rate for a 256-bit output: 17 lanes a block

LAUNCHES = {"keccak256_blocks": 0}
# K10's launch shape (csrc/keccak.cu K10_THREADS, csrc/keccak_group.cuh)
THREADS_PER_ROW = 2
ROWS_PER_BLOCK = 32

# round constants as int64 bit patterns
_RC_I64 = [rc - (1 << 64) if rc >= 1 << 63 else rc for rc in _RC]


def pad_messages_keccak(msgs: list[bytes], max_len: int | None = None, out: np.ndarray | None = None):
    """Host: messages -> (buf (n, nb, 136) uint8, active (n,) int32) for
    keccak256_blocks, byte for byte as cometbft_tpu/ops/keccak.py:209
    pads them: 0x01 after the message and 0x80 on the last byte of its
    last block (0x81 when the padding is one byte); nb is the longest
    row's block count, at least max_len's.  Rows of one length are
    written in one block write.  ``out``, when given, is a zeroed buffer
    of n * nb * 136 bytes that the blocks are written into."""
    n = len(msgs)
    lens = np.fromiter((len(m) for m in msgs), np.int64, n)
    longest = int(lens.max(initial=0))
    if max_len is not None:
        longest = max(longest, max_len)
    nblocks = longest // RATE + 1
    buf = np.zeros((n, nblocks * RATE), dtype=np.uint8) if out is None else out.reshape(n, nblocks * RATE)
    for ln in np.unique(lens).tolist():
        if ln:
            rows = np.flatnonzero(lens == ln)
            buf[rows, :ln] = np.frombuffer(b"".join(msgs[i] for i in rows.tolist()), np.uint8).reshape(-1, ln)
    active = lens // RATE + 1
    ar = np.arange(n)
    buf[ar, lens] ^= 0x01
    buf[ar, active * RATE - 1] ^= 0x80
    return buf.reshape(n, nblocks, RATE), active.astype(np.int32)


def _check_args(blocks: torch.Tensor, active: torch.Tensor) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 3 or blocks.shape[2] != RATE:
        raise _build.LaunchRefused(f"blocks must be (N, nb, {RATE}) uint8")
    if active.shape != blocks.shape[:1] or active.device != blocks.device:
        raise _build.LaunchRefused("active must be (N,) on the blocks' device")


def _lanes(blocks: torch.Tensor) -> torch.Tensor:
    """(N, nb, 136) uint8 -> (N, nb, 17) little-endian lanes as int64."""
    b = blocks.to(torch.int64).reshape(blocks.shape[0], blocks.shape[1], 17, 8)
    lanes = torch.zeros(b.shape[:-1], dtype=torch.int64, device=blocks.device)
    for k in range(7, -1, -1):
        lanes = (lanes << 8) | b[..., k]
    return lanes


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    n %= 64
    if n == 0:
        return x
    return (x << n) | ((x >> (64 - n)) & ((1 << n) - 1))


def keccak_f_plain(a: list) -> list:
    """Keccak-f[1600] on 25 int64 tensors (lane x + 5 y at index x + 5 y)."""
    for rnd in range(24):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x][y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & b[(i % 5 + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] = a[0] ^ _RC_I64[rnd]
    return a


def keccak256_state_plain(blocks: torch.Tensor, active: torch.Tensor) -> list:
    """The first 4 state lanes after each row's live blocks, (N,) int64
    each."""
    N, nb, _ = blocks.shape
    lanes = _lanes(blocks)
    st = [torch.zeros((N,), dtype=torch.int64, device=blocks.device) for _ in range(25)]
    for blk in range(nb):
        nxt = keccak_f_plain([st[i] ^ lanes[:, blk, i] if i < 17 else st[i] for i in range(25)])
        live = active > blk
        st = [torch.where(live, n_, s_) for n_, s_ in zip(nxt, st)]
    return st[:4]


def lanes_to_bytes(lanes: list) -> torch.Tensor:
    """4 int64 lanes -> (N, 32) uint8, little-endian per lane."""
    out = torch.stack(lanes, dim=1)
    by = torch.stack([(out >> (8 * k)) & 0xFF for k in range(8)], dim=-1)
    return by.reshape(out.shape[0], 32).to(torch.uint8)


def keccak256_blocks_plain(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Plain version of K10 on 64-bit lanes held in int64 tensors
    (logical right shifts are emulated by masking)."""
    return lanes_to_bytes(keccak256_state_plain(blocks, active))


def keccak256_blocks(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(N, nb, 136) uint8 Keccak-padded blocks, (N,) int32 active block
    counts -> (N, 32) uint8 digests: K10 on a CUDA tensor, the plain
    version on a CPU tensor."""
    _check_args(blocks, active)
    if blocks.device.type == "cpu":
        return keccak256_blocks_plain(blocks, active)
    if blocks.device.type != "cuda":
        raise _build.LaunchRefused(f"unsupported device {blocks.device}")
    blocks = blocks.contiguous()
    if blocks.data_ptr() % 8:
        blocks = blocks.clone()
    digest = torch.empty((blocks.shape[0], 32), dtype=torch.uint8, device=blocks.device)
    launch_k10(blocks, active.to(torch.int32).contiguous(), digest)
    return digest


def launch_k10(blocks, active, digest) -> None:
    """K10 into a preallocated (N, 32) digest on the current stream.  Rows
    of no blocks (nb = 0) hash nothing: their digests are zeros, as at
    active = 0, and K10, which reads every row's first block, is not
    launched."""
    if blocks.shape[1] == 0:
        digest.zero_()
        return
    if blocks.data_ptr() % 8 or digest.data_ptr() % 8:
        raise _build.LaunchRefused("K10 reads and writes the words of 8-byte lanes: blocks and digest must be 8-byte aligned")
    with torch.cuda.device(blocks.device):
        code = _build.lib("keccak").k10_keccak256_blocks(
            blocks.data_ptr(), active.data_ptr(), digest.data_ptr(),
            blocks.shape[0], blocks.shape[1],
            torch.cuda.current_stream(blocks.device).cuda_stream,
        )
    _build.check(code, "k10_keccak256_blocks")
    LAUNCHES["keccak256_blocks"] += 1


def keccak256_device(msgs: list[bytes], device="cuda") -> list[bytes]:
    """Host messages -> their Keccak-256 digests through one K10 launch
    on ``device`` (the plain version for "cpu"): the port of the
    standalone bridge cometbft_tpu/ops/keccak.py:193."""
    dev = resolve_device(device)
    blocks, active = pad_messages_keccak(msgs)
    out = keccak256_blocks(torch.from_numpy(blocks).to(dev), torch.from_numpy(active).to(dev))
    return [bytes(row) for row in out.cpu().numpy()]
