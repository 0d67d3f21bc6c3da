"""secp256k1 keys with RFC 6979 deterministic ECDSA
(reference: crypto/secp256k1/ — Cosmos-style: compressed 33-byte
pubkeys, Bitcoin-style RIPEMD160(SHA256(pubkey)) addresses, 64-byte
r||s signatures with low-s normalization).

A copy of cometbft_tpu/crypto/secp256k1.py: the port imports nothing of
the JAX package.  It is the verdict oracle of the secp kernels (K11,
K12) and the signer of the test and smoke corpora.  One difference of
speed, none of result: scalar multiplication runs in Jacobian
coordinates with one inversion at the end (the reference inverts at
every affine addition), so signing and verifying cost a few ms each in
pure Python instead of ~100 ms.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

KEY_TYPE = "secp256k1"
PUBKEY_SIZE = 33
PRIVKEY_SIZE = 32
SIGNATURE_SIZE = 64

# curve parameters (SEC2)
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _add(p1, p2):
    """Affine point addition (None = infinity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _jdouble(p):
    """Jacobian doubling (a = 0); None = infinity."""
    if p is None:
        return None
    X, Y, Z = p
    if Y == 0:
        return None
    A = X * X % P
    Bb = Y * Y % P
    C = Bb * Bb % P
    D = 2 * ((X + Bb) ** 2 - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    return X3, (E * (D - X3) - 8 * C) % P, 2 * Y * Z % P


def _jadd_affine(p, q):
    """Jacobian p + affine q (complete: doubling and opposite cases)."""
    if p is None:
        return (q[0], q[1], 1)
    X1, Y1, Z1 = p
    z2 = Z1 * Z1 % P
    U2 = q[0] * z2 % P
    S2 = q[1] * z2 * Z1 % P
    H = (U2 - X1) % P
    R = (S2 - Y1) % P
    if H == 0:
        return _jdouble(p) if R == 0 else None
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    return X3, (R * (V - X3) - Y1 * HHH) % P, Z1 * H % P


def _mul(k: int, p):
    """k * p for an affine p (None = infinity): double-and-add in
    Jacobian coordinates, one inversion at the end."""
    if p is None or k % N == 0:
        return None
    acc = None
    for bit in bin(k)[2:]:
        acc = _jdouble(acc)
        if bit == "1":
            acc = _jadd_affine(acc, p)
    if acc is None:
        return None
    zi = _inv(acc[2], P)
    zi2 = zi * zi % P
    return acc[0] * zi2 % P, acc[1] * zi2 * zi % P


G = (GX, GY)


def _compress(pt) -> bytes:
    x, y = pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def _decompress(data: bytes):
    if len(data) != PUBKEY_SIZE or data[0] not in (2, 3):
        raise ValueError("invalid compressed secp256k1 point")
    x = int.from_bytes(data[1:], "big")
    if x >= P:
        raise ValueError("x out of range")
    y2 = (pow(x, 3, P) + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("point not on curve")
    if (y & 1) != (data[0] & 1):
        y = P - y
    return x, y


def _rfc6979_k(priv: int, msg_hash: bytes) -> int:
    """RFC 6979 deterministic nonce with HMAC-SHA256."""
    h1 = msg_hash
    x = priv.to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


@dataclass(frozen=True)
class PubKey:
    data: bytes  # 33-byte compressed

    def __post_init__(self):
        _decompress(self.data)  # validate eagerly

    @property
    def type(self) -> str:
        return KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def address(self) -> bytes:
        """RIPEMD160(SHA256(pubkey)) (secp256k1.go:148)."""
        sha = hashlib.sha256(self.data).digest()
        h = hashlib.new("ripemd160")
        h.update(sha)
        return h.digest()

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not (1 <= r < N and 1 <= s < N):
            return False
        if s > N // 2:
            return False  # reject high-s (malleability, Cosmos rule)
        e = int.from_bytes(hashlib.sha256(msg).digest(), "big") % N
        try:
            pub = _decompress(self.data)
        except ValueError:
            return False
        w = _inv(s, N)
        u1 = e * w % N
        u2 = r * w % N
        pt = _add(_mul(u1, G), _mul(u2, pub))
        if pt is None:
            return False
        return pt[0] % N == r


@dataclass(frozen=True)
class PrivKey:
    data: bytes  # 32-byte scalar

    def __post_init__(self):
        if len(self.data) != PRIVKEY_SIZE:
            raise ValueError("secp256k1 privkey must be 32 bytes")
        d = int.from_bytes(self.data, "big")
        if not (1 <= d < N):
            raise ValueError("secp256k1 privkey out of range")

    @property
    def type(self) -> str:
        return KEY_TYPE

    @classmethod
    def generate(cls) -> "PrivKey":
        import os

        while True:
            cand = os.urandom(32)
            d = int.from_bytes(cand, "big")
            if 1 <= d < N:
                return cls(cand)

    @classmethod
    def from_seed(cls, seed: bytes) -> "PrivKey":
        """Deterministic keys for tests (genPrivKeySecp256k1: sha256 of
        the seed, clamped into [1, N))."""
        d = int.from_bytes(hashlib.sha256(seed).digest(), "big") % (N - 1) + 1
        return cls(d.to_bytes(32, "big"))

    def pub_key(self) -> PubKey:
        d = int.from_bytes(self.data, "big")
        return PubKey(_compress(_mul(d, G)))

    def sign(self, msg: bytes) -> bytes:
        """64-byte r||s over SHA256(msg), low-s normalized
        (secp256k1.go Sign)."""
        d = int.from_bytes(self.data, "big")
        h = hashlib.sha256(msg).digest()
        e = int.from_bytes(h, "big") % N
        while True:
            k = _rfc6979_k(d, h)
            pt = _mul(k, G)
            r = pt[0] % N
            if r == 0:
                h = hashlib.sha256(h).digest()
                continue
            s = _inv(k, N) * (e + r * d) % N
            if s == 0:
                h = hashlib.sha256(h).digest()
                continue
            if s > N // 2:
                s = N - s
            return r.to_bytes(32, "big") + s.to_bytes(32, "big")
