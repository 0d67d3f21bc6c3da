"""The signed-tx envelope of CheckTx — a copy of the codec half of
cometbft_tpu/verifysvc/checktx.py:61-128 (the verify service that
consumes it is a later slice of the port).  It makes and reads the
traffic of the secp lane:

    v1 (legacy): ``MAGIC(8) | pubkey(32) | signature(64) | payload``
                 — always ed25519;
    v2:          ``MAGIC_V2(8) | key_type(1) | pubkey | signature | payload``
                 with the key-type byte fixing the widths:

                     0x00  ed25519        pub 32   sig 64
                     0x01  secp256k1      pub 33   sig 64  (r||s, SHA-256)
                     0x02  secp256k1eth   pub 65   sig 65  (R||S||V, Keccak)
                     0x03  ecrecover      pub 20   sig 65  (R||S||V, Keccak;
                           the "pubkey" is the sender's address)

The signature is over ``SIGN_DOMAIN + payload`` in both versions.
"""

from __future__ import annotations

MAGIC = b"\xd0sigtx1\x00"  # v1: implicit ed25519
MAGIC_V2 = b"\xd0sigtx2\x00"  # v2: explicit key-type byte
SIGN_DOMAIN = b"cometbft-tpu/sigtx/v1|"
_HEADER_LEN = len(MAGIC) + 32 + 64

KEY_TYPE_BYTES: dict[str, int] = {
    "ed25519": 0,
    "secp256k1": 1,
    "secp256k1eth": 2,
    "ecrecover": 3,
}
_KT_SHAPES: dict[int, tuple[str, int, int]] = {
    0: ("ed25519", 32, 64),
    1: ("secp256k1", 33, 64),
    2: ("secp256k1eth", 65, 65),
    3: ("ecrecover", 20, 65),
}


def make_signed_tx(priv_key, payload: bytes) -> bytes:
    """Wrap payload in the signed envelope: ed25519 keys emit v1, secp
    keys v2 with their key-type byte."""
    sig = priv_key.sign(SIGN_DOMAIN + payload)
    kt = getattr(priv_key, "type", "ed25519")
    if kt == "ed25519":
        return MAGIC + priv_key.pub_key().data + sig + payload
    return MAGIC_V2 + bytes([KEY_TYPE_BYTES[kt]]) + priv_key.pub_key().data + sig + payload


def parse_signed_tx(tx: bytes) -> tuple[str, bytes, bytes, bytes] | None:
    """(key_type, pubkey, signature, payload) when tx carries a
    well-formed envelope, else None (an unsigned tx, not an error)."""
    if tx.startswith(MAGIC):
        if len(tx) < _HEADER_LEN:
            return None
        off = len(MAGIC)
        return "ed25519", tx[off : off + 32], tx[off + 32 : off + 96], tx[_HEADER_LEN:]
    if tx.startswith(MAGIC_V2):
        off = len(MAGIC_V2)
        if len(tx) < off + 1:
            return None
        shape = _KT_SHAPES.get(tx[off])
        if shape is None:
            return None  # unknown key type: not our envelope
        kt, npub, nsig = shape
        off += 1
        if len(tx) < off + npub + nsig:
            return None
        return kt, tx[off : off + npub], tx[off + npub : off + npub + nsig], tx[off + npub + nsig :]
    return None
