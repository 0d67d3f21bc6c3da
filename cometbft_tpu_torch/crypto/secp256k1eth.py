"""Ethereum-compatible secp256k1 recovery keys
(reference: crypto/secp256k1eth/secp256k1eth.go — gated behind the
``secp256k1eth`` build tag, binds go-ethereum's cgo libsecp256k1).

A copy of cometbft_tpu/crypto/secp256k1eth.py: the port imports nothing
of the JAX package.  Wire shapes follow the reference exactly: 65-byte
uncompressed pubkeys (0x04 || x || y, secp256k1eth.go:148), 65-byte
R || S || V signatures over Keccak256(msg) in lower-S form with a
recovery id V in {0, 1} (Sign, :131), and Ethereum addresses
Keccak256(pubkey[1:])[12:] (Address, :150).  Curve math is shared with
the Cosmos-style secp256k1 module.  It is the verdict oracle of the
Ethereum and ecrecover rows of the secp kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import secp256k1 as _c
from .keccak import keccak256

KEY_TYPE = "secp256k1eth"
PUBKEY_SIZE = 65
PRIVKEY_SIZE = 32
SIGNATURE_SIZE = 65  # R || S || V
ENABLED = True

# The ecrecover wire shape: real Ethereum txs carry no pubkey at all —
# the verifier recovers Q from the signature and compares the derived
# address against the 20-byte sender.  RECOVER_KEY_TYPE is that third
# wire shape's key type (verifysvc MODE_SECP routing; checktx byte 3).
RECOVER_KEY_TYPE = "ecrecover"
ADDRESS_SIZE = 20


def _uncompress_bytes(pt) -> bytes:
    x, y = pt
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _parse_uncompressed(data: bytes):
    if len(data) != PUBKEY_SIZE or data[0] != 4:
        raise ValueError("secp256k1eth: pubkey must be 65-byte uncompressed")
    x = int.from_bytes(data[1:33], "big")
    y = int.from_bytes(data[33:], "big")
    if x >= _c.P or y >= _c.P or (y * y - (x * x * x + _c.B)) % _c.P != 0:
        raise ValueError("secp256k1eth: point not on curve")
    return x, y


def recover_pubkey(msg_hash: bytes, sig: bytes) -> bytes:
    """Recover the 65-byte uncompressed pubkey from an R||S||V signature,
    Ethereum-style (go-ethereum Ecrecover)."""
    if len(sig) != SIGNATURE_SIZE:
        raise ValueError("secp256k1eth: bad signature length")
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    v = sig[64]
    if v not in (0, 1) or not (1 <= r < _c.N and 1 <= s < _c.N):
        raise ValueError("secp256k1eth: bad signature values")
    # x-coordinate of R is r (eth rejects r >= N overflow cases)
    x = r
    y2 = (pow(x, 3, _c.P) + _c.B) % _c.P
    y = pow(y2, (_c.P + 1) // 4, _c.P)
    if y * y % _c.P != y2:
        raise ValueError("secp256k1eth: invalid signature point")
    if (y & 1) != v:
        y = _c.P - y
    e = int.from_bytes(msg_hash, "big") % _c.N
    rinv = _c._inv(r, _c.N)
    # Q = r^-1 (s*R - e*G)
    pt = _c._add(
        _c._mul(s * rinv % _c.N, (x, y)),
        _c._mul((-e * rinv) % _c.N, _c.G),
    )
    if pt is None:
        raise ValueError("secp256k1eth: recovered infinity")
    return _uncompress_bytes(pt)


def verify_address_signature(addr: bytes, msg: bytes, sig: bytes) -> bool:
    """The true ecrecover verdict: recover the signer from R||S||V over
    Keccak256(msg) and compare Keccak256(pubkey[1:])[12:] against the
    20-byte sender address.  Same gauntlet as PubKey.verify_signature
    (high-S rejected up front, every recover failure judges False) —
    this is the host oracle the device ecrecover lane is bit-identical
    to (ops/secp256k1.verify_batch with recover rows)."""
    if len(addr) != ADDRESS_SIZE or len(sig) != SIGNATURE_SIZE:
        return False
    s = int.from_bytes(sig[32:64], "big")
    if s > _c.N // 2:
        return False
    try:
        recovered = recover_pubkey(keccak256(msg), sig)
    except ValueError:
        return False
    return keccak256(recovered[1:])[12:] == addr


@dataclass(frozen=True)
class PubKey:
    data: bytes  # 65-byte uncompressed

    def __post_init__(self):
        _parse_uncompressed(self.data)

    @property
    def type(self) -> str:
        return KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def address(self) -> bytes:
        """Ethereum address: Keccak256(pubkey[1:])[12:]
        (secp256k1eth.go:150-156)."""
        return keccak256(self.data[1:])[12:]

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """R||S||V over Keccak256(msg); rejects high-S
        (secp256k1eth.go:179)."""
        if len(sig) != SIGNATURE_SIZE:
            return False
        s = int.from_bytes(sig[32:64], "big")
        if s > _c.N // 2:
            return False
        try:
            recovered = recover_pubkey(keccak256(msg), sig)
        except ValueError:
            return False
        return recovered == self.data


@dataclass(frozen=True)
class RecoverPubKey:
    """The ecrecover 'pubkey': just the 20-byte sender address — what an
    Ethereum tx actually carries.  Quacks like the other key types so
    the verify plane's host fallbacks treat it uniformly."""

    data: bytes  # 20-byte address

    def __post_init__(self):
        if len(self.data) != ADDRESS_SIZE:
            raise ValueError("ecrecover key must be a 20-byte address")

    @property
    def type(self) -> str:
        return RECOVER_KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def address(self) -> bytes:
        return self.data

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return verify_address_signature(self.data, msg, sig)


@dataclass(frozen=True)
class PrivKey:
    data: bytes

    def __post_init__(self):
        if len(self.data) != PRIVKEY_SIZE:
            raise ValueError("secp256k1eth privkey must be 32 bytes")
        d = int.from_bytes(self.data, "big")
        if not (1 <= d < _c.N):
            raise ValueError("secp256k1eth privkey out of range")

    @property
    def type(self) -> str:
        return KEY_TYPE

    @classmethod
    def generate(cls) -> "PrivKey":
        import os

        while True:
            cand = os.urandom(32)
            if 1 <= int.from_bytes(cand, "big") < _c.N:
                return cls(cand)

    @classmethod
    def from_seed(cls, seed: bytes) -> "PrivKey":
        d = int.from_bytes(keccak256(seed), "big") % (_c.N - 1) + 1
        return cls(d.to_bytes(32, "big"))

    def pub_key(self) -> PubKey:
        d = int.from_bytes(self.data, "big")
        return PubKey(_uncompress_bytes(_c._mul(d, _c.G)))

    def sign(self, msg: bytes) -> bytes:
        """R || S || V over Keccak256(msg), deterministic RFC 6979 nonce,
        lower-S, V adjusted for the S negation (secp256k1eth.go:131)."""
        d = int.from_bytes(self.data, "big")
        h = keccak256(msg)
        e = int.from_bytes(h, "big") % _c.N
        nonce_h = h
        while True:
            k = _c._rfc6979_k(d, nonce_h)
            pt = _c._mul(k, _c.G)
            r = pt[0] % _c.N
            if r == 0 or pt[0] >= _c.N:
                nonce_h = keccak256(nonce_h)
                continue
            s = _c._inv(k, _c.N) * (e + r * d) % _c.N
            if s == 0:
                nonce_h = keccak256(nonce_h)
                continue
            v = pt[1] & 1
            if s > _c.N // 2:
                s = _c.N - s
                v ^= 1
            return (
                r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])
            )


class RecoverPrivKey(PrivKey):
    """Signs exactly like PrivKey (same R||S||V wire) but identifies as
    the ecrecover key type: pub_key() is the 20-byte address, so signed
    envelopes carry no pubkey — the production Ethereum tx shape."""

    @property
    def type(self) -> str:
        return RECOVER_KEY_TYPE

    def pub_key(self) -> RecoverPubKey:
        return RecoverPubKey(super().pub_key().address())
