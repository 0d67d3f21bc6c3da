"""Pure-Python Edwards25519 reference implementation (host bigint oracle).

Used for (a) differential testing of the CUDA kernels and their plain
PyTorch versions, (b) host-side precomputation of the fixed-base comb
table, and (c) host signing in tests.  Implements RFC 8032 arithmetic
with ZIP-215 decompression semantics to match the reference's
verification rules (crypto/ed25519/ed25519.go:36-42: ZIP-215 /
cofactored verification).

A copy of cometbft_tpu/crypto/_ref25519.py: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import hashlib

P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# Base point: y = 4/5, x even.
BY = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> int | None:
    """RFC 8032 x-recovery; returns None when no square root exists.

    ZIP-215 note: callers pass y already reduced mod p (non-canonical
    encodings accepted); x == 0 with sign == 1 is accepted and yields x = 0
    (matching ed25519-zebra/curve25519-dalek decompression, which the
    reference inherits via curve25519-voi).
    """
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # x = u/v ^ ((p+3)/8) = u v^3 (u v^7)^((p-5)/8)
    x = (u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P)) % P
    vxx = (v * x * x) % P
    if vxx == u:
        pass
    elif vxx == (-u) % P:
        x = (x * SQRT_M1) % P
    else:
        return None
    if x & 1 != sign:
        x = (-x) % P
    return x


BX = _recover_x(BY, 0)
assert BX is not None

# Extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z.
IDENT = (0, 1, 1, 0)
BASE = (BX, BY, 1, (BX * BY) % P)


def pt_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def pt_double(p):
    return pt_add(p, p)


def pt_neg(p):
    x, y, z, t = p
    return ((-x) % P, y, z, (-t) % P)


def pt_mul(k: int, p):
    q = IDENT
    while k > 0:
        if k & 1:
            q = pt_add(q, p)
        p = pt_double(p)
        k >>= 1
    return q


def pt_is_identity(p) -> bool:
    x, y, z, _ = p
    return x % P == 0 and (y - z) % P == 0


def compress(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decompress(b: bytes):
    """ZIP-215 decompression: non-canonical y accepted; None if off-curve."""
    if len(b) != 32:
        return None
    enc = int.from_bytes(b, "little")
    sign = enc >> 255
    y = (enc & ((1 << 255) - 1)) % P
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, (x * y) % P)


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def secret_expand(seed: bytes):
    h = sha512(seed[:32])
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Cofactored ZIP-215 verification: [8][s]B == [8]R + [8][k]A."""
    if len(sig) != 64:
        return False
    A = decompress(pub)
    R = decompress(sig[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = int.from_bytes(sha512(sig[:32] + pub + msg), "little") % L
    # [8]([s]B - [k]A - R) == identity
    q = pt_add(pt_mul(s, BASE), pt_neg(pt_add(pt_mul(k, A), R)))
    for _ in range(3):
        q = pt_double(q)
    return pt_is_identity(q)
