"""The hash half of the comb verify path: payload decode with device-side
R || A || M block assembly (K1) and batched SHA-512 (K2); and batched
SHA-256 (K7), the leaf hash of the Merkle trees (ops/merkle.py).

Kernels (CUDA C++ in csrc/sha2.cu and csrc/merkle.cu):

  K1 ``parse_verify_payload``  replaces cometbft_tpu/ops/sha2.py:355
     (with ram_blocks_from_parts, :311)
  K2 ``sha512_blocks``         replaces cometbft_tpu/ops/sha2.py:189
  K7 ``sha256_blocks``         replaces cometbft_tpu/ops/sha2.py:81

Each wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor; ``LAUNCHES`` counts kernel launches.

Payload rows (the tight per-call transfer, see
models/comb_verifier._fill_payload): R(32) | s(32) | mlen(3B LE) |
live(1B) | msg(maxm).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

LAUNCHES = {"parse_verify_payload": 0, "sha512_blocks": 0, "sha256_blocks": 0}

# SHA-512 and SHA-256 round constants and initial states, derived from
# their public definition (fractional parts of cube / square roots of the
# first primes), as cometbft_tpu/ops/sha2.py:59-69 derives them.


def _primes(n: int) -> list[int]:
    out, c = [], 2
    while len(out) < n:
        if all(c % q for q in out):
            out.append(c)
        c += 1
    return out


def _iroot(x: int, k: int) -> int:
    r = int(round(x ** (1.0 / k)))
    while r**k > x:
        r -= 1
    while (r + 1) ** k <= x:
        r += 1
    return r


_M64 = (1 << 64) - 1
K512 = [_iroot(p << 192, 3) & _M64 for p in _primes(80)]
H512 = [_iroot(p << 128, 2) & _M64 for p in _primes(8)]
K256 = [_iroot(p << 96, 3) & 0xFFFFFFFF for p in _primes(64)]
H256 = [_iroot(p << 64, 2) & 0xFFFFFFFF for p in _primes(8)]


def nblocks_for(maxm: int) -> int:
    """Static SHA-512 block count of a payload of message width maxm."""
    return (64 + maxm + 17 + 127) // 128


def _check_payload(payload: torch.Tensor, pubs: torch.Tensor) -> None:
    if payload.dtype != torch.uint8 or payload.dim() != 2 or payload.shape[1] < 68:
        raise ValueError("payload must be (V, 68 + maxm) uint8")
    if pubs.dtype != torch.uint8 or pubs.shape != (payload.shape[0], 32):
        raise ValueError("pubs must be (V, 32) uint8")
    if pubs.device != payload.device:
        raise ValueError("payload and pubs must be on the same device")


def pad_messages_sha512(msgs: list[bytes], max_len: int | None = None):
    """Host: messages -> (buf (n, nb, 128) uint8, active (n,) int32) for
    sha512_blocks (a copy of cometbft_tpu/ops/sha2.py:387): each row
    padded in its own final block (0x80, zeros, the 128-bit big-endian
    bit length), nb = the longest row's block count.  Rows of one length
    are written in one block write."""
    n = len(msgs)
    lens = np.fromiter((len(m) for m in msgs), np.int64, n)
    longest = int(lens.max(initial=0))
    if max_len is not None:
        longest = max(longest, max_len)
    nblocks = max(1, (longest + 17 + 127) // 128)
    buf = np.zeros((n, nblocks * 128), dtype=np.uint8)
    for ln in np.unique(lens).tolist():
        rows = np.flatnonzero(lens == ln)
        if ln:
            buf[rows, :ln] = np.frombuffer(
                b"".join(msgs[i] for i in rows.tolist()), np.uint8
            ).reshape(-1, ln)
    active = (lens + 17 + 127) // 128
    ar = np.arange(n)
    buf[ar, lens] = 0x80
    bits = lens * 8  # < 2^64: the top 8 bytes of the 16-byte length are 0
    for k in range(8):
        buf[ar, active * 128 - 1 - k] = (bits >> (8 * k)) & 0xFF
    return buf.reshape(n, nblocks, 128), active.astype(np.int32)


# ------------------------------------------------------------------ K1


def parse_verify_payload_plain(payload: torch.Tensor, pubs: torch.Tensor):
    """Plain version of K1: (blocks (V, nb, 128) uint8, active (V,) int32)."""
    V, width = payload.shape
    maxm = width - 68
    nb = nblocks_for(maxm)
    W = nb * 128
    dev = payload.device
    mlen = (
        payload[:, 64].to(torch.int32)
        | (payload[:, 65].to(torch.int32) << 8)
        | (payload[:, 66].to(torch.int32) << 16)
    )
    total = (mlen + 64)[:, None]
    buf = torch.zeros((V, W), dtype=torch.int32, device=dev)
    buf[:, :32] = payload[:, :32].to(torch.int32)
    buf[:, 32:64] = pubs.to(torch.int32)
    buf[:, 64 : 64 + maxm] = payload[:, 68:].to(torch.int32)
    pos = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    buf = torch.where(pos < total, buf, 0)
    buf = buf | torch.where(pos == total, 0x80, 0)
    nbr = (total + 17 + 127) // 128
    shift = (nbr * 128 - 1 - pos) * 8
    bitlen = total * 8
    lb = torch.where(
        (shift >= 0) & (shift < 32), (bitlen >> shift.clamp(0, 31)) & 0xFF, 0
    )
    blocks = (buf | lb).to(torch.uint8).reshape(V, nb, 128)
    live = payload[:, 67] == 1
    active = torch.where(live, nbr[:, 0], 0).to(torch.int32)
    return blocks, active


def parse_verify_payload(payload: torch.Tensor, pubs: torch.Tensor):
    """Decode the tight payload and assemble its SHA-512 blocks.

    payload (V, 68 + maxm) uint8, pubs (V, 32) uint8 ->
    (r (V, 32), s (V, 32), blocks (V, nb, 128) uint8, active (V,) int32,
    live (V,) bool); r and s are views of the payload, active is 0 for
    rows that are not live."""
    _check_payload(payload, pubs)
    r, s = payload[:, :32], payload[:, 32:64]
    live = payload[:, 67] == 1
    if payload.device.type == "cpu":
        blocks, active = parse_verify_payload_plain(payload, pubs)
        return r, s, blocks, active, live
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    payload, pubs = payload.contiguous(), pubs.contiguous()
    V, width = payload.shape
    nb = nblocks_for(width - 68)
    blocks = torch.empty((V, nb, 128), dtype=torch.uint8, device=payload.device)
    active = torch.empty((V,), dtype=torch.int32, device=payload.device)
    launch_k1(payload, pubs, blocks, active)
    return r, s, blocks, active, live


def launch_k1(payload, pubs, blocks, active) -> None:
    """K1 into preallocated outputs on the current stream."""
    V, width = payload.shape
    code = _build.lib("sha2").k1_parse_verify_payload(
        payload.data_ptr(), pubs.data_ptr(), blocks.data_ptr(), active.data_ptr(),
        V, width, blocks.shape[1], torch.cuda.current_stream(payload.device).cuda_stream,
    )
    _build.check(code, "k1_parse_verify_payload")
    LAUNCHES["parse_verify_payload"] += 1


# ------------------------------------------------------------------ K2


def sha512_blocks_plain(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 on uint64 words held in int64 tensors (logical
    shifts are emulated by masking after the arithmetic shift)."""
    V, nb, _ = blocks.shape
    dev = blocks.device
    b = blocks.to(torch.int64).reshape(V, nb, 16, 8)
    w_all = torch.zeros((V, nb, 16), dtype=torch.int64, device=dev)
    for k in range(8):
        w_all = (w_all << 8) | b[..., k]

    def shr(x, n):
        return (x >> n) & ((1 << (64 - n)) - 1)

    def rotr(x, n):
        return shr(x, n) | (x << (64 - n))

    kt = [k - (1 << 64) if k >= 1 << 63 else k for k in K512]
    st = [
        torch.full((V,), h - (1 << 64) if h >= 1 << 63 else h, dtype=torch.int64, device=dev)
        for h in H512
    ]
    for blk in range(nb):
        w = [w_all[:, blk, i] for i in range(16)]
        a, bb, c, d, e, f, g, h = st
        for t in range(80):
            if t >= 16:
                w15, w2 = w[(t + 1) % 16], w[(t + 14) % 16]
                s0 = rotr(w15, 1) ^ rotr(w15, 8) ^ shr(w15, 7)
                s1 = rotr(w2, 19) ^ rotr(w2, 61) ^ shr(w2, 6)
                w[t % 16] = w[t % 16] + s0 + w[(t + 9) % 16] + s1
            S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41)
            ch = (e & f) ^ (~e & g)
            t1 = h + S1 + ch + kt[t] + w[t % 16]
            S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39)
            mj = (a & bb) ^ (a & c) ^ (bb & c)
            h, g, f, e, d, c, bb, a = g, f, e, d + t1, c, bb, a, t1 + S0 + mj
        live = active > blk
        st = [torch.where(live, s + n, s) for s, n in zip(st, (a, bb, c, d, e, f, g, h))]
    out = torch.stack(st, dim=1)  # (V, 8) words, big-endian bytes out
    by = torch.stack([(out >> (56 - 8 * k)) & 0xFF for k in range(8)], dim=-1)
    return by.reshape(V, 64).to(torch.uint8)


def sha512_blocks(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(V, nb, 128) uint8 padded blocks, (V,) int32 active block counts ->
    (V, 64) uint8 digests."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 3 or blocks.shape[2] != 128:
        raise ValueError("blocks must be (V, nb, 128) uint8")
    if active.shape != blocks.shape[:1] or active.device != blocks.device:
        raise ValueError("active must be (V,) on the blocks' device")
    if blocks.device.type == "cpu":
        return sha512_blocks_plain(blocks, active)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    blocks = blocks.contiguous()
    active = active.to(torch.int32).contiguous()
    digest = torch.empty((blocks.shape[0], 64), dtype=torch.uint8, device=blocks.device)
    launch_k2(blocks, active, digest)
    return digest


def launch_k2(blocks, active, digest) -> None:
    """K2 into a preallocated digest on the current stream."""
    code = _build.lib("sha2").k2_sha512_blocks(
        blocks.data_ptr(), active.data_ptr(), digest.data_ptr(),
        blocks.shape[0], blocks.shape[1],
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    _build.check(code, "k2_sha512_blocks")
    LAUNCHES["sha512_blocks"] += 1


# ------------------------------------------------------------------ K7


def pad_messages_sha256(msgs: list[bytes], max_len: int | None = None, prefix: bytes = b"",
                        out: np.ndarray | None = None):
    """Host: messages -> (buf (n, nb, 64) uint8, active (n,) int32) for
    sha256_blocks (a copy of cometbft_tpu/ops/sha2.py:413, byte for byte):
    each row is ``prefix + msg`` padded in its own final block (0x80,
    zeros, the 64-bit big-endian bit length), nb = the longest row's block
    count (at least ``max_len``'s).  Rows of one length are written in one
    block write.  ``out``, when given, is a zeroed uint8 buffer of
    n * nb * 64 bytes (e.g. a view of a page-locked tensor) that the
    blocks are written into; the returned ``buf`` is then a view of it."""
    n = len(msgs)
    p = len(prefix)
    lens = np.fromiter((len(m) for m in msgs), np.int64, n)
    longest = int(lens.max(initial=0)) + p
    if max_len is not None:
        longest = max(longest, max_len)
    nblocks = max(1, (longest + 9 + 63) // 64)
    if out is None:
        buf = np.zeros((n, nblocks * 64), dtype=np.uint8)
    else:
        buf = out.reshape(n, nblocks * 64)
    if p:
        buf[:, :p] = np.frombuffer(prefix, np.uint8)
    for ln in np.unique(lens).tolist():
        if ln:
            rows = np.flatnonzero(lens == ln)
            buf[rows, p : p + ln] = np.frombuffer(
                b"".join(msgs[i] for i in rows.tolist()), np.uint8
            ).reshape(-1, ln)
    lens = lens + p
    active = (lens + 9 + 63) // 64
    ar = np.arange(n)
    buf[ar, lens] = 0x80
    bits = lens * 8
    for k in range(8):
        buf[ar, active * 64 - 1 - k] = (bits >> (8 * k)) & 0xFF
    return buf.reshape(n, nblocks, 64), active.astype(np.int32)


def sha256_blocks_plain(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 on uint32 words held in int64 tensors, masked
    to 32 bits after every addition."""
    V, nb, _ = blocks.shape
    dev = blocks.device
    M = 0xFFFFFFFF
    b = blocks.to(torch.int64).reshape(V, nb, 16, 4)
    w_all = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & M

    st = [torch.full((V,), h, dtype=torch.int64, device=dev) for h in H256]
    for blk in range(nb):
        w = [w_all[:, blk, i] for i in range(16)]
        for t in range(16, 64):
            s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M)
        a, bb, c, d, e, f, g, h = st
        for t in range(64):
            S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
            ch = (e & f) ^ (~e & M & g)
            t1 = (h + S1 + ch + K256[t] + w[t]) & M
            S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
            mj = (a & bb) ^ (a & c) ^ (bb & c)
            h, g, f, e, d, c, bb, a = g, f, e, (d + t1) & M, c, bb, a, (t1 + S0 + mj) & M
        live = active > blk
        st = [torch.where(live, (s + n) & M, s) for s, n in zip(st, (a, bb, c, d, e, f, g, h))]
    out = torch.stack(st, dim=1)  # (V, 8) words, big-endian bytes out
    by = torch.stack([(out >> (24 - 8 * k)) & 0xFF for k in range(4)], dim=-1)
    return by.reshape(V, 32).to(torch.uint8)


def _check_sha256_args(blocks: torch.Tensor, active: torch.Tensor) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 3 or blocks.shape[2] != 64:
        raise ValueError("blocks must be (N, nb, 64) uint8")
    if active.shape != blocks.shape[:1] or active.device != blocks.device:
        raise ValueError("active must be (N,) on the blocks' device")


def sha256_blocks(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(N, nb, 64) uint8 SHA-256-padded blocks, (N,) int32 active block
    counts -> (N, 32) uint8 digests; a row stops after its own last
    block."""
    _check_sha256_args(blocks, active)
    if blocks.device.type == "cpu":
        return sha256_blocks_plain(blocks, active)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    digest = torch.empty((blocks.shape[0], 32), dtype=torch.uint8, device=blocks.device)
    blocks = blocks.contiguous()
    if blocks.data_ptr() % 4:
        blocks = blocks.clone()
    launch_k7(blocks, active.to(torch.int32).contiguous(), digest)
    return digest


def launch_k7(blocks, active, digest) -> None:
    """K7 into a preallocated (N, 32) digest (which may be a row range of
    a larger contiguous tensor) on the current stream."""
    if blocks.data_ptr() % 4 or digest.data_ptr() % 4:
        raise ValueError("K7 loads and stores 4-byte words: blocks and digest must be 4-byte aligned")
    code = _build.lib("merkle").k7_sha256_blocks(
        blocks.data_ptr(), active.data_ptr(), digest.data_ptr(),
        blocks.shape[0], blocks.shape[1],
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    _build.check(code, "k7_sha256_blocks")
    LAUNCHES["sha256_blocks"] += 1
