"""GF(2^255 - 19) arithmetic in plain PyTorch: the plain versions behind
the CUDA field code in csrc/fe25519.cuh.

Same radix as the CUDA header: 2^25.5, ten signed limbs (widths 26, 25,
26, 25, ...; limb i holds bits [OFFSET[i], OFFSET[i+1]) of the value) in
int64 tensors shaped (10, *batch) — the limb axis leads so that a limb is
a cheap view.  The TPU package's 22 x 12-bit int32 limbs existed because
the TPU has no 64-bit multiply; here a product of two limbs is one int64
multiply.

Limb bounds (the contract csrc/fe25519.cuh states and argues):
  TIGHT  |limb| < 1.01 * 2^w: output of mul / square / carry / from_words.
  LOOSE  |limb| < 1.1 * 2^27: what mul accepts — the sum or difference
         of two TIGHT elements.  Column sums stay below 10 * 38 *
         (1.1 * 2^27)^2 < 2^62.9.
The carry here runs two PARALLEL rounds (every limb at once, the top
carry folded into limb 0 times 19) rather than the CUDA header's
sequential pass: after round one |limb| < 2^w + 2^42.2, after round two
|limb| < 2^w + 2^17.2, which is TIGHT.  The two carries give different
limb representatives of the same field element; everything that leaves a
function (canonical words, booleans) is identical.
"""

from __future__ import annotations

import torch

NLIMBS = 10
P = (1 << 255) - 19
WIDTHS = [26 if i % 2 == 0 else 25 for i in range(NLIMBS)]
OFFSETS = [25 * i + (i + 1) // 2 for i in range(NLIMBS + 1)]  # ceil(25.5 i)

# mul: column (i + j) mod 10 of f_i * g_j, times 2 when both limbs are
# odd (the radix's half bit) and times 19 past 2^255.
_COL = [[(i + j) % NLIMBS for j in range(NLIMBS)] for i in range(NLIMBS)]
_COEF = [
    [(2 if (i & 1 and j & 1) else 1) * (19 if i + j >= NLIMBS else 1) for j in range(NLIMBS)]
    for i in range(NLIMBS)
]

_CACHE: dict = {}


def _const(name: str, device, ndim: int) -> torch.Tensor:
    """Small per-device constant tensors, shaped to broadcast over
    ``ndim`` batch axes."""
    key = (name, str(device), ndim)
    t = _CACHE.get(key)
    if t is None:
        if name == "col":
            t = torch.tensor(_COL, dtype=torch.int64).reshape(-1)
        elif name == "coef":
            t = torch.tensor(_COEF, dtype=torch.int64).reshape((NLIMBS, NLIMBS) + (1,) * ndim)
        elif name == "width":
            t = torch.tensor(WIDTHS, dtype=torch.int64).reshape((NLIMBS,) + (1,) * ndim)
        elif name == "pow2":
            t = torch.tensor([1 << w for w in WIDTHS], dtype=torch.int64).reshape(
                (NLIMBS,) + (1,) * ndim
            )
        elif name == "fold":
            t = torch.tensor([19] + [1] * (NLIMBS - 1), dtype=torch.int64).reshape(
                (NLIMBS,) + (1,) * ndim
            )
        else:
            t = torch.tensor(to_limbs_int(_NAMED[name]), dtype=torch.int64).reshape(
                (NLIMBS,) + (1,) * ndim
            )
        t = t.to(device)
        _CACHE[key] = t
    return t


def to_limbs_int(x: int) -> list[int]:
    """Canonical limbs of an integer in [0, 2^255)."""
    return [(x >> OFFSETS[i]) & ((1 << WIDTHS[i]) - 1) for i in range(NLIMBS)]


def zero(batch, device) -> torch.Tensor:
    return torch.zeros((NLIMBS,) + tuple(batch), dtype=torch.int64, device=device)


def one(batch, device) -> torch.Tensor:
    t = zero(batch, device)
    t[0] = 1
    return t


def carry(c: torch.Tensor) -> torch.Tensor:
    """Two parallel carry rounds: any |limb| < 2^63 - 2^42 -> TIGHT."""
    nd = c.dim() - 1
    w = _const("width", c.device, nd)
    pow2 = _const("pow2", c.device, nd)
    fold = _const("fold", c.device, nd)
    for _ in range(2):
        q = c >> w  # arithmetic shift: floor division
        c = c - q * pow2 + torch.roll(q, 1, dims=0) * fold
    return c


def mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """f * g for LOOSE f, g (shapes broadcast); TIGHT result."""
    f, g = torch.broadcast_tensors(f, g)
    nd = f.dim() - 1
    prod = f[:, None] * g[None, :] * _const("coef", f.device, nd)
    cols = torch.zeros_like(f)
    cols.index_add_(0, _const("col", f.device, 0), prod.reshape((NLIMBS * NLIMBS,) + f.shape[1:]))
    return carry(cols)


def square(f):
    return mul(f, f)


def sqn(f, n: int):
    for _ in range(n):
        f = square(f)
    return f


def from_words(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) words of a 256-bit LE value (any int dtype holding u32
    bit patterns) -> (10, ...) limbs; bit 255 is ignored and values >= p
    stay correct mod p."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    out = []
    for i in range(NLIMBS):
        off = OFFSETS[i]
        wi, sh = off >> 5, off & 31
        x = w[..., wi] >> sh
        if wi + 1 < 8 and sh + WIDTHS[i] > 32:
            x = x | (w[..., wi + 1] << (32 - sh))
        out.append(x & ((1 << WIDTHS[i]) - 1))
    return torch.stack(out)


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 LE -> (10, ...) limbs (bit 255 ignored)."""
    return from_words(bytes_to_words(b))


def bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """(..., 4n) uint8 LE -> (..., n) int64 holding u32 words."""
    b = b.to(torch.int64)
    b = b.reshape(b.shape[:-1] + (b.shape[-1] // 4, 4))
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def freeze(f: torch.Tensor) -> torch.Tensor:
    """Canonical limbs in [0, 2^w), value in [0, p) (the ref10
    fe_tobytes reduction, as in csrc/fe25519.cuh fe_freeze)."""
    h = carry(f)
    h = [h[i] for i in range(NLIMBS)]
    q = (19 * h[9] + (1 << 24)) >> 25
    for i in range(NLIMBS):
        q = (h[i] + q) >> WIDTHS[i]
    h[0] = h[0] + 19 * q
    for i in range(NLIMBS - 1):
        c = h[i] >> WIDTHS[i]
        h[i + 1] = h[i + 1] + c
        h[i] = h[i] - c * (1 << WIDTHS[i])
    h[9] = h[9] & ((1 << 25) - 1)
    return torch.stack(h)


def to_words(f: torch.Tensor) -> torch.Tensor:
    """(10, ...) -> (..., 8) int64 canonical u32 words."""
    t = freeze(f)
    words = [torch.zeros_like(t[0]) for _ in range(8)]
    for i in range(NLIMBS):
        off = OFFSETS[i]
        wi, sh = off >> 5, off & 31
        x = t[i] << sh
        words[wi] = words[wi] | (x & 0xFFFFFFFF)
        if wi + 1 < 8:
            words[wi + 1] = words[wi + 1] | (x >> 32)
    return torch.stack(words, dim=-1)


def is_zero(f):
    return (freeze(f) == 0).all(dim=0)


def is_negative(f):
    return (freeze(f)[0] & 1) == 1


def eq(f, g):
    return is_zero(f - g)


def select(cond, a, b):
    """cond ? a : b, cond broadcast over the limb axis."""
    return torch.where(cond.unsqueeze(0), a, b)


def _pow22501(x):
    z2 = square(x)
    z9 = mul(sqn(z2, 2), x)
    z11 = mul(z9, z2)
    t0 = mul(square(z11), z9)  # 2^5 - 1
    t0 = mul(sqn(t0, 5), t0)  # 2^10 - 1
    t1 = mul(sqn(t0, 10), t0)  # 2^20 - 1
    t1 = mul(sqn(t1, 20), t1)  # 2^40 - 1
    t0 = mul(sqn(t1, 10), t0)  # 2^50 - 1
    t1 = mul(sqn(t0, 50), t0)  # 2^100 - 1
    t1 = mul(sqn(t1, 100), t1)  # 2^200 - 1
    return mul(sqn(t1, 50), t0), z11  # 2^250 - 1


def invert(x):
    """x^(p - 2)."""
    t250, z11 = _pow22501(x)
    return mul(sqn(t250, 5), z11)


def pow_p58(x):
    """x^((p - 5) / 8)."""
    t250, _ = _pow22501(x)
    return mul(sqn(t250, 2), x)


_D = (-121665 * pow(121666, P - 2, P)) % P
_NAMED = {
    "d": _D,
    "d2": 2 * _D % P,
    "sqrtm1": pow(2, (P - 1) // 4, P),
}


def named(name: str, like: torch.Tensor) -> torch.Tensor:
    """The constant d, d2 or sqrtm1, broadcastable against ``like``."""
    return _const(name, like.device, like.dim() - 1)
