"""Seeded K4 (cached ed25519 verify) batches for the port's tests and
chip_smoke.py: lanes of every verdict class placed at the edges of K4's
groups, warps and blocks.  Imports only the port.

A lane is a validator's key (an index into a small key pool whose last
key is off the curve, so its table is invalid), a payload row R | s |
mlen | live | message and a 64-byte digest.  K4 reads the digest as
given (K2 computes it upstream), so besides honest signatures a lane
can carry a chosen challenge k: with R = r B and s = r + k a mod L,
[s]B = R + [k]A holds for the digest k + m L.  That is how the corpus
gets lanes whose k has long runs of zero digits (one thread's whole
share of positions adds the identity) and lanes with s = 0 (every B
entry is the stored identity).

Kinds (``VALID`` verify, the rest fail):
  good      an honest signature of a random message
  zero_lo   k's signed radix-16 digits 0-31 all zero
  zero_hi   k's digits 28-63 all zero
  s_zero    s = 0 (r = -k a), k below 16^57 (digits 57-63 zero)
  bad_r     an undecodable R
  s_ge_l    s + L in place of s
  bad_a     the off-curve key's lane (its table is the identity's)
  flip      one digest byte flipped (a message the signer never signed)
Each kind also comes non-live (byte 67 = 0): such rows never set a bit
and never clear the all-ok byte.
"""

from __future__ import annotations

import hashlib

import numpy as np

from cometbft_tpu_torch.crypto import _ref25519 as ref
from cometbft_tpu_torch.crypto import ed25519 as host

VALID = ("good", "zero_lo", "zero_hi", "s_zero")
INVALID = ("bad_r", "s_ge_l", "bad_a", "flip")
MSG_BYTES = 8  # payload width 68 + 8: rows not 16-byte aligned
POOL_KEYS = 6  # valid keys; the pool's last key is off the curve
VARIANTS = 16  # distinct lanes of each kind; a large batch repeats them


def off_curve() -> bytes:
    """The least y whose encoding does not decode (ZIP-215)."""
    return next(y.to_bytes(32, "little") for y in range(2, 1000) if ref.decompress(y.to_bytes(32, "little")) is None)


def _signed_digits_to_int(d) -> int:
    return sum(int(x) << (4 * i) for i, x in enumerate(d))


def _chosen_k(rng, zero: range | None, top: int) -> int:
    """A k in [0, L) whose signed radix-16 digits are zero on ``zero`` and
    on every position from ``top`` up."""
    while True:
        d = rng.integers(-8, 8, size=64)
        d[top:] = 0
        if zero is not None:
            d[zero.start : zero.stop] = 0
        k = _signed_digits_to_int(d)
        if 0 <= k < ref.L:
            return k


class Pool:
    """POOL_KEYS keys from ``seed`` plus the off-curve key; ``pubs``
    (POOL_KEYS + 1, 32) uint8."""

    def __init__(self, seed: int):
        rng = np.random.default_rng(seed)
        self.seeds = [rng.bytes(32) for _ in range(POOL_KEYS)]
        self.keys = [host.PrivKey.from_seed(s) for s in self.seeds]
        self.secret = [ref.secret_expand(s)[0] for s in self.seeds]
        pubs = [k.pub_key().data for k in self.keys] + [off_curve()]
        self.pub_bytes = pubs
        self.pubs = np.stack([np.frombuffer(p, np.uint8) for p in pubs])
        self.bad_key = POOL_KEYS


def _lane(pool: Pool, kind: str, rng) -> tuple[int, bytes, bytes, bytes]:
    """(key index, R, s, digest) of one lane of ``kind``."""
    key = int(rng.integers(0, POOL_KEYS))
    pub = pool.pub_bytes[key]
    if kind in ("good", "bad_r", "s_ge_l", "bad_a", "flip"):
        msg = rng.bytes(int(rng.integers(0, 40)))
        sig = pool.keys[key].sign(msg)
        r_enc, s = sig[:32], int.from_bytes(sig[32:], "little")
        digest = hashlib.sha512(r_enc + pub + msg).digest()
    else:
        a = pool.secret[key]
        if kind == "zero_lo":
            k = _chosen_k(rng, range(0, 32), 64)
        elif kind == "zero_hi":
            k = _chosen_k(rng, range(28, 64), 64)
        else:  # s_zero
            k = _chosen_k(rng, None, 57)
        r = (-k * a) % ref.L if kind == "s_zero" else int.from_bytes(rng.bytes(64), "little") % ref.L
        r_enc = ref.compress(ref.pt_mul(r, ref.BASE))
        s = (r + k * a) % ref.L
        m = int.from_bytes(rng.bytes(32), "little")
        digest = (k + m * ref.L).to_bytes(64, "little")
    if kind == "bad_r":
        r_enc = off_curve()
    elif kind == "s_ge_l":
        s += ref.L
    elif kind == "bad_a":
        key = pool.bad_key
    elif kind == "flip":
        i = int(rng.integers(0, 64))
        digest = digest[:i] + bytes([digest[i] ^ 0x10]) + digest[i + 1 :]
    return key, r_enc, s.to_bytes(32, "little"), digest


def edge_kinds(V: int, mode: str = "mixed") -> list[tuple[str, bool]]:
    """(kind, live) of each lane of a V-lane batch.

    mixed: failing kinds in turn at every warp's first and last lane (8
    lanes a warp at four threads a lane), at every block's last lane
    (32 lanes a block) and at the batch's last lane; the valid kinds in
    turn elsewhere, every fifth lane non-live (a valid and a failing
    kind in turn), so non-live rows sit beside valid ones.
    valid: every lane valid and live (the all-ok byte is 1).
    valid_dead: valid live lanes with every third lane a failing kind
    that is not live (the all-ok byte is still 1)."""
    out = []
    nv = ni = 0
    for v in range(V):
        if mode == "valid":
            out.append((VALID[v % len(VALID)], True))
        elif mode == "valid_dead":
            out.append((INVALID[v % len(INVALID)], False) if v % 3 == 1 else (VALID[v % len(VALID)], True))
        elif v % 8 in (0, 7) or v % 32 == 31 or v == V - 1:
            out.append((INVALID[ni % len(INVALID)], True))
            ni += 1
        elif v % 5 == 2:
            out.append(((VALID + INVALID)[v % 8], False))
        else:
            out.append((VALID[nv % len(VALID)], True))
            nv += 1
    return out


def batch(pool: Pool, V: int, seed: int, mode: str = "mixed"):
    """A V-lane batch: dict of ``key`` (V,) int64 pool indices,
    ``payload`` (V, 68 + MSG_BYTES) uint8, ``digest`` (V, 64) uint8,
    ``kinds`` [(kind, live)] and ``expect`` (V,) bool = the lane's
    verdict (before the live mask).  VARIANTS distinct lanes a kind are
    made and repeated, so a large V costs no more host arithmetic than a
    small one."""
    rng = np.random.default_rng(seed)
    kinds = edge_kinds(V, mode)
    made: dict[str, list] = {}
    key = np.zeros(V, np.int64)
    payload = rng.integers(0, 256, size=(V, 68 + MSG_BYTES), dtype=np.uint8)
    digest = np.zeros((V, 64), np.uint8)
    for v, (kind, live) in enumerate(kinds):
        lanes = made.setdefault(kind, [])
        if len(lanes) < VARIANTS:
            lanes.append(_lane(pool, kind, rng))
            lane = lanes[-1]
        else:
            lane = lanes[v % VARIANTS]
        k, r_enc, s, dg = lane
        key[v] = k
        payload[v, :32] = np.frombuffer(r_enc, np.uint8)
        payload[v, 32:64] = np.frombuffer(s, np.uint8)
        payload[v, 64:67] = [MSG_BYTES, 0, 0]
        payload[v, 67] = 1 if live else 0
        digest[v] = np.frombuffer(dg, np.uint8)
    expect = np.array([k in VALID for k, _ in kinds], dtype=bool)
    return {"key": key, "payload": payload, "digest": digest, "kinds": kinds, "expect": expect}


def packed_expect(b) -> np.ndarray:
    """The bytes K4 writes for a batch: packbits(expect & live), then the
    all-ok byte."""
    live = b["payload"][:, 67] == 1
    ok = b["expect"]
    return np.concatenate([np.packbits(ok & live), [np.uint8(bool(np.all(ok | ~live)))]]).astype(np.uint8)
