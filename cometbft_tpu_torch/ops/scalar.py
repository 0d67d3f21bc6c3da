"""Scalars mod L in plain PyTorch: the plain versions behind
csrc/sc25519.cuh.

L = 2^252 + 27742317777372353535851937790883648493.  The challenge
k = SHA-512(R || A || M) is reduced mod L by Barrett (HAC 14.42) in base
b = 2^16 with k = 16 limbs, in int64 tensors shaped (n, V) (limb axis
first): q = floor(floor(x / b^15) * MU / b^17), MU = floor(b^32 / L),
r = (x - q L) mod b^17, then at most two subtractions of L.  Column sums
of 16-bit limb products stay below 17 * 2^32 < 2^37.  (The CUDA header
runs the same algorithm in base 2^32; both give the unique k mod L.)
"""

from __future__ import annotations

import torch

L = (1 << 252) + 27742317777372353535851937790883648493
_BITS = 16
_MASK = (1 << _BITS) - 1
_MU = (1 << 512) // L  # 260 bits: 17 limbs


def _limbs(x: int, n: int) -> list[int]:
    return [(x >> (_BITS * i)) & _MASK for i in range(n)]


_L17 = _limbs(L, 17)
_MU17 = _limbs(_MU, 17)


def _normalize(c: list[torch.Tensor]) -> list[torch.Tensor]:
    """Sequential carry of non-negative column sums -> 16-bit limbs
    (the carry out of the top limb is dropped: arithmetic mod b^n)."""
    out = []
    k = torch.zeros_like(c[0])
    for t in c:
        t = t + k
        out.append(t & _MASK)
        k = t >> _BITS
    return out


def _mul_const(a: list[torch.Tensor], b: list[int], n_out: int) -> list[torch.Tensor]:
    """(a * b) mod b^n_out, normalized; a limbs are tensors, b constants."""
    cols = [torch.zeros_like(a[0]) for _ in range(n_out)]
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            if i + j < n_out and bj:
                cols[i + j] = cols[i + j] + ai * bj
    return _normalize(cols)


def _sub_mod(a: list[torch.Tensor], b: list) -> tuple[list[torch.Tensor], torch.Tensor]:
    """a - b mod b^n and the final borrow (1 where a < b)."""
    out = []
    borrow = torch.zeros_like(a[0])
    for ai, bi in zip(a, b):
        d = ai - bi - borrow
        borrow = (d < 0).to(torch.int64)
        out.append(d + borrow * (1 << _BITS))
    return out, borrow


def bytes_to_limbs16(b: torch.Tensor) -> list[torch.Tensor]:
    """(V, 2n) uint8 LE -> n tensors (V,) of 16-bit limbs."""
    b = b.to(torch.int64)
    return [b[:, 2 * i] | (b[:, 2 * i + 1] << 8) for i in range(b.shape[1] // 2)]


def limbs16_to_bytes(limbs: list[torch.Tensor]) -> torch.Tensor:
    """16-bit limbs -> (V, 2n) uint8 LE."""
    out = []
    for t in limbs:
        out += [t & 0xFF, t >> 8]
    return torch.stack(out, dim=1).to(torch.uint8)


def reduce_mod_l(digest: torch.Tensor) -> torch.Tensor:
    """(V, 64) uint8 LE 512-bit values -> (V, 32) uint8 LE x mod L."""
    x = bytes_to_limbs16(digest)  # 32 limbs
    q2 = _mul_const(x[15:], _MU17, 34)
    q3 = q2[17:]
    r2 = _mul_const(q3, _L17, 17)
    r, _ = _sub_mod(x[:17], r2)
    for _ in range(2):
        d, borrow = _sub_mod(r, _L17)
        keep = borrow == 1
        r = [torch.where(keep, ri, di) for ri, di in zip(r, d)]
    return limbs16_to_bytes(r[:16])


def s_lt_l(s: torch.Tensor) -> torch.Tensor:
    """(V, 32) uint8 LE -> (V,) bool: s < L (ZIP-215 requires it)."""
    _, borrow = _sub_mod(bytes_to_limbs16(s), _L17[:16])
    return borrow == 1


def nibbles(b: torch.Tensor) -> torch.Tensor:
    """(V, 32) uint8 LE -> (64, V) int64 4-bit digits, LSB first."""
    b = b.to(torch.int64)
    return torch.stack([b & 15, b >> 4], dim=-1).reshape(b.shape[0], 64).T


def bytes_to_windows(b: torch.Tensor) -> torch.Tensor:
    """(V, 32) uint8 LE -> (64, V) int64 4-bit windows, most significant
    first (cometbft_tpu/ops/scalar.py:168 bytes_to_windows, and :159
    limbs_to_windows on the same value: the port's reduce_mod_l returns
    bytes, so one function serves both)."""
    return nibbles(b).flip(0)


def signed_digits_radix16(k: torch.Tensor) -> torch.Tensor:
    """(V, 32) uint8 LE scalar < 2^253 -> (64, V) digits in [-8, 7] with
    value == sum d_i 16^i (d = nibble + carry; d >= 8 borrows 16 from
    the next digit; the top carry is 0 for k < 2^253)."""
    nib = nibbles(k)
    out = []
    carry = torch.zeros_like(nib[0])
    for i in range(64):
        d = nib[i] + carry
        carry = (d >= 8).to(torch.int64)
        out.append(d - 16 * carry)
    return torch.stack(out)


def digits_radix4096(s: torch.Tensor) -> torch.Tensor:
    """(V, 32) uint8 LE -> (22, V) int64 12-bit digits, LSB first."""
    nib = nibbles(s)
    nib = torch.cat([nib, torch.zeros_like(nib[:2])])  # 66 nibbles
    nib = nib.reshape(22, 3, -1)
    return nib[:, 0] | (nib[:, 1] << 4) | (nib[:, 2] << 8)
