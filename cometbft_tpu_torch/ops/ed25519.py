"""Edwards25519 group law in plain PyTorch: the plain versions behind
csrc/ge25519.cuh.

Points are tuples (X, Y, Z, T) of field tensors shaped (10, *batch)
(extended coordinates, a = -1, x = X/Z, y = Y/Z, T = XY/Z); affine Niels
entries are tuples (y+x, y-x, 2dxy).  The formulas, and where they carry
to keep the multiply's input contract, are the CUDA header's.
"""

from __future__ import annotations

import torch

from . import field as F


def identity(batch, device):
    z = F.zero(batch, device)
    o = F.one(batch, device)
    return (z, o, o.clone(), z.clone())


def neg(p):
    x, y, z, t = p
    return (-x, y, z, -t)


def add(p, q):
    """Unified addition (add-2008-hwcd-3)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = F.mul(y1 - x1, y2 - x2)
    b = F.mul(y1 + x1, y2 + x2)
    c = F.mul(F.mul(t1, F.named("d2", t1)), t2)
    d = F.mul(z1 + z1, z2)
    e, f, g, h = b - a, d - c, d + c, b + a
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def add_niels(p, n):
    """p + n for an affine Niels entry n = (y+x, y-x, 2dxy)."""
    x1, y1, z1, t1 = p
    ypx, ymx, t2d = n
    a = F.mul(y1 - x1, ymx)
    b = F.mul(y1 + x1, ypx)
    c = F.mul(t1, t2d)
    d = F.carry(z1 + z1)
    e, f, g, h = b - a, d - c, d + c, b + a
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def double(p):
    """dbl-2008-hwcd with a = -1 (E = 2XY, G = Y^2 - X^2,
    F = 2Z^2 - G, H = X^2 + Y^2)."""
    x, y, z, _ = p
    xx, yy, zz = F.square(x), F.square(y), F.square(z)
    h = xx + yy
    g = yy - xx
    e = F.carry(F.square(x + y) - h)
    f = F.carry(zz + zz - g)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def select(cond, p, q):
    return tuple(F.select(cond, a, b) for a, b in zip(p, q))


def is_identity(p):
    """x == 0 and y == z."""
    x, y, z, _ = p
    return F.is_zero(x) & F.eq(y, z)


def decompress(enc: torch.Tensor):
    """(..., 32) uint8 -> (point with batch shape ..., ok (...) bool).

    ZIP-215: y is the low 255 bits taken mod p (non-canonical y
    accepted), x = 0 with sign 1 accepted; ok is False when no square
    root exists (the point is then arbitrary but well formed)."""
    sign = (enc[..., 31].to(torch.int64) >> 7) == 1
    y = F.from_bytes(enc)
    one = F.one(y.shape[1:], y.device)
    yy = F.square(y)
    u = yy - one
    v = F.mul(yy, F.named("d", yy)) + one
    v3 = F.mul(F.square(v), v)
    v7 = F.mul(F.square(v3), v)
    x = F.mul(F.mul(u, v3), F.pow_p58(F.mul(u, v7)))
    vxx = F.mul(v, F.square(x))
    ok_direct = F.eq(vxx, u)
    ok_flipped = F.eq(vxx, -u)
    x = F.select(ok_flipped, F.mul(x, F.named("sqrtm1", x)), x)
    x = F.select(F.is_negative(x) != sign, -x, x)
    return (x, y, one, F.mul(x, y)), ok_direct | ok_flipped


def niels_from_words(w: torch.Tensor, negate=None):
    """(..., 3, 8) canonical words -> Niels tuple of (10, ...) limbs;
    where ``negate`` is set, the entry of the negated point."""
    ypx = F.from_words(w[..., 0, :])
    ymx = F.from_words(w[..., 1, :])
    t2d = F.from_words(w[..., 2, :])
    if negate is None:
        return ypx, ymx, t2d
    return (
        F.select(negate, ymx, ypx),
        F.select(negate, ypx, ymx),
        F.select(negate, -t2d, t2d),
    )

