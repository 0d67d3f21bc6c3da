"""Mempool CheckTx signature gate: the signed-tx envelope codec and its
check through the verify service (the port of
cometbft_tpu/verifysvc/checktx.py).  The envelope is the traffic of the
secp lane:

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

verify_tx_signature submits each tx's one (pubkey, msg, sig) to the
service's MEMPOOL class in its key type's mode (ed25519 -> MODE_PLAIN,
the secp types -> MODE_SECP); the class's flush deadline merges the
checks of concurrent senders into one launch.  A refused submit, and a
check that outlasts collect_timeout_s() (after its stall report), are
checked on the host through the mode's host verifier.
"""

from __future__ import annotations

import time

from .service import (
    Klass,
    VerifyService,
    VerifyServiceBackpressure,
    _host_verify_items,
    collect_timeout_s,
    default_tenant,
    global_service,
    mode_for_key_type,
    report_collect_stall,
)

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


def _host_verify(mode, pub: bytes, msg: bytes, sig: bytes) -> bool:
    """The host verdict of one row through the mode's host verifier (a
    malformed row judges False, never raises)."""
    _, per = _host_verify_items([(pub, msg, sig)], mode)
    return bool(per and per[0])


def verify_tx_signature(
    tx: bytes,
    service: VerifyService | None = None,
    tenant: str | None = None,
    *,
    device="cuda",
) -> bool | None:
    """Check a tx's envelope signature through the verify service
    (``service``, default the global one of ``device``) as a MEMPOOL
    request under ``tenant`` (None: this process's default tenant).

    None for an unsigned tx (no envelope), else the verdict.  On
    backpressure, and past collect_timeout_s() (after the stall report),
    the check runs on the host; an error of the batch that the service
    did not verify again is raised."""
    parsed = parse_signed_tx(tx)
    if parsed is None:
        return None
    key_type, pub, sig, payload = parsed
    msg = SIGN_DOMAIN + payload
    mode = mode_for_key_type(key_type)  # every key type the parser emits has one
    svc = service if service is not None else global_service(device)
    t0 = time.monotonic()
    try:
        _, per = svc.submit([(pub, msg, sig)], Klass.MEMPOOL, mode, tenant=tenant).collect(collect_timeout_s())
    except VerifyServiceBackpressure:
        return _host_verify(mode, pub, msg, sig)
    except TimeoutError:
        # the service took the check but did not settle it in time: leave
        # forensics and take the host path (its late answer is dropped)
        report_collect_stall(Klass.MEMPOOL, tenant if tenant is not None else default_tenant(), 1,
                             time.monotonic() - t0, service=svc)
        return _host_verify(mode, pub, msg, sig)
    return bool(per and per[0])
