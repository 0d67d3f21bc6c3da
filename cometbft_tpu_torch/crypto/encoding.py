"""proto <-> host pubkey conversion (reference: crypto/encoding/codec.go;
a copy of cometbft_tpu/crypto/encoding.py over the port's key classes).

The PublicKey proto is a oneof over the four key types the reference
supports (proto/cometbft/crypto/v1/keys.proto); bls12381 and
secp256k1eth are optional there (build-tagged), always importable here.
"""

from __future__ import annotations

from ..wire import types as pb
from . import ed25519, secp256k1, secp256k1eth

BLS_KEY_TYPE = "bls12_381"  # bls12381 imports lazily (slow module init)


class UnsupportedKeyType(ValueError):
    pass


def pubkey_to_proto(pub) -> pb.PublicKey:
    kt = pub.type
    if kt == ed25519.KEY_TYPE:
        return pb.PublicKey(ed25519=pub.bytes())
    if kt == secp256k1.KEY_TYPE:
        return pb.PublicKey(secp256k1=pub.bytes())
    if kt == BLS_KEY_TYPE:
        return pb.PublicKey(bls12381=pub.data)
    if kt == secp256k1eth.KEY_TYPE:
        return pb.PublicKey(secp256k1eth=pub.bytes())
    raise UnsupportedKeyType(f"key type {kt!r} not supported")


def pubkey_from_proto(msg: pb.PublicKey):
    if msg.ed25519:
        return ed25519.PubKey(msg.ed25519)
    if msg.secp256k1:
        return secp256k1.PubKey(msg.secp256k1)
    if msg.bls12381:
        from . import bls12381

        return bls12381.PubKey(msg.bls12381)
    if msg.secp256k1eth:
        return secp256k1eth.PubKey(msg.secp256k1eth)
    raise UnsupportedKeyType("unsupported or empty PublicKey proto")


def pubkey_from_type_and_bytes(key_type: str, data: bytes):
    if key_type == ed25519.KEY_TYPE:
        return ed25519.PubKey(data)
    if key_type == secp256k1.KEY_TYPE:
        return secp256k1.PubKey(data)
    if key_type == BLS_KEY_TYPE:
        from . import bls12381

        return bls12381.PubKey(data)
    if key_type == secp256k1eth.KEY_TYPE:
        return secp256k1eth.PubKey(data)
    raise UnsupportedKeyType(f"key type {key_type!r} not supported")
