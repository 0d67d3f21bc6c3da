"""Host Ed25519 key API (reference: crypto/ed25519/ed25519.go).

Signing and single verification use the `cryptography` package where it
is installed, with a ZIP-215 recheck on rejection, so verification
semantics are uniformly ZIP-215/cofactored — the same rules as the CUDA
comb kernel and the reference validator (ed25519.go:36-42).
OpenSSL-accepted signatures satisfy the cofactorless equation, which
implies the cofactored one, so the fast path never accepts anything
ZIP-215 would reject.

Without `cryptography`, signing and derivation fall back to the
pure-Python reference implementation (_ref25519) with a fixed-base comb:
identical RFC 8032 outputs, a few ms per operation.

A copy of cometbft_tpu/crypto/ed25519.py: the port imports nothing of
the JAX package.  Batch verification lives behind the BatchVerifier seam
(cometbft_tpu_torch.crypto.batch).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

try:
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.exceptions import InvalidSignature

    _HAVE_OPENSSL = True
except ImportError:  # pure-Python fallback below
    _HAVE_OPENSSL = False

from . import hash as tmhash
from . import _ref25519 as ref


_BASE_COMB: list | None = None


def _base_comb() -> list:
    """Fixed-base radix-16 comb for the pure-Python fallback: entry
    [i][j] = j * 16^i * B.  One-time ~1k point adds; cuts a base-point
    scalar mul from ~380 group ops (double-and-add) to <= 64 adds, which
    is what keeps fallback signing fast enough for the in-process
    consensus tests' liveness windows."""
    global _BASE_COMB
    if _BASE_COMB is None:
        tab = []
        p = ref.BASE
        for _ in range(64):
            row = [ref.IDENT]
            for _j in range(15):
                row.append(ref.pt_add(row[-1], p))
            tab.append(row)
            p = ref.pt_add(row[8], row[8])  # 16*p = 2 * (8*p)
        _BASE_COMB = tab
    return _BASE_COMB


def _mul_base(k: int):
    tab = _base_comb()
    q = ref.IDENT
    i = 0
    while k:
        d = k & 15
        if d:
            q = ref.pt_add(q, tab[i][d])
        k >>= 4
        i += 1
    return q


@functools.lru_cache(maxsize=4096)
def _ref_expand(seed: bytes):
    return ref.secret_expand(seed)


@functools.lru_cache(maxsize=4096)
def _ref_public_key(seed: bytes) -> bytes:
    a, _ = _ref_expand(seed)
    return ref.compress(_mul_base(a))


def _ref_sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 signing with the fixed-base comb."""
    a, prefix = _ref_expand(seed)
    A = _ref_public_key(seed)
    r = int.from_bytes(ref.sha512(prefix + msg), "little") % ref.L
    R = ref.compress(_mul_base(r))
    k = int.from_bytes(ref.sha512(R + A + msg), "little") % ref.L
    s = (r + k * a) % ref.L
    return R + s.to_bytes(32, "little")


def _ref_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 verification, comb-accelerated for the fixed-base term;
    semantics identical to ref.verify."""
    if len(sig) != 64:
        return False
    A = ref.decompress(pub)
    R = ref.decompress(sig[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= ref.L:
        return False
    k = int.from_bytes(ref.sha512(sig[:32] + pub + msg), "little") % ref.L
    q = ref.pt_add(_mul_base(s), ref.pt_neg(ref.pt_add(ref.pt_mul(k, A), R)))
    for _ in range(3):
        q = ref.pt_double(q)
    return ref.pt_is_identity(q)

KEY_TYPE = "ed25519"
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 64  # seed || pubkey, matching common ed25519 key files
SIGNATURE_SIZE = 64


def verify_signature(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 single verification."""
    if len(sig) != SIGNATURE_SIZE or len(pub) != PUBKEY_SIZE:
        return False
    if not _HAVE_OPENSSL:
        return _ref_verify(pub, msg, sig)
    try:
        Ed25519PublicKey.from_public_bytes(pub).verify(sig, msg)
        return True
    except (InvalidSignature, ValueError):
        # OpenSSL is stricter than ZIP-215 (canonical encodings, cofactorless
        # equation); recheck the slow, permissive way before rejecting.
        return ref.verify(pub, msg, sig)


@dataclass(frozen=True)
class PubKey:
    data: bytes

    def __post_init__(self):
        if len(self.data) != PUBKEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUBKEY_SIZE} bytes")

    @property
    def type(self) -> str:
        return KEY_TYPE

    def address(self) -> bytes:
        return tmhash.sum_truncated(self.data)

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return verify_signature(self.data, msg, sig)

    def bytes(self) -> bytes:
        return self.data


@dataclass(frozen=True)
class PrivKey:
    data: bytes  # 64 bytes: seed || pubkey

    def __post_init__(self):
        if len(self.data) not in (32, PRIVKEY_SIZE):
            raise ValueError("ed25519 privkey must be 32 or 64 bytes")

    @property
    def type(self) -> str:
        return KEY_TYPE

    @property
    def seed(self) -> bytes:
        return self.data[:32]

    @classmethod
    def from_seed(cls, seed: bytes) -> "PrivKey":
        if not _HAVE_OPENSSL:
            return cls(seed + _ref_public_key(seed))
        sk = Ed25519PrivateKey.from_private_bytes(seed)
        pub = sk.public_key().public_bytes_raw()
        return cls(seed + pub)

    def pub_key(self) -> PubKey:
        if len(self.data) == PRIVKEY_SIZE:
            return PubKey(self.data[32:])
        if not _HAVE_OPENSSL:
            return PubKey(_ref_public_key(self.seed))
        sk = Ed25519PrivateKey.from_private_bytes(self.seed)
        return PubKey(sk.public_key().public_bytes_raw())

    def sign(self, msg: bytes) -> bytes:
        if not _HAVE_OPENSSL:
            return _ref_sign(self.seed, msg)
        sk = Ed25519PrivateKey.from_private_bytes(self.seed)
        return sk.sign(msg)

    def bytes(self) -> bytes:
        return self.data
