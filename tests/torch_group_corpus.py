"""Seeded edge corpora of K5 (uncached ed25519 verify) and K3 (comb table
build) for the port's tests and chip_smoke.py: lanes and keys of every
class placed at the edges of the kernels' groups, warps and blocks.
Imports only the port.

K5 lane: A | R | s (32 bytes each) and a 64-byte digest.  K5 reads the
digest as given (K2 computes it upstream), so besides honest signatures
a lane can carry a chosen challenge k: with R = r B and s = r + k a mod
L, [s]B = R + [k]A holds for the digest k + m L.

K5 kinds (``LANE_VALID`` verify, the rest fail):
  good      an honest signature (digest = SHA-512(R || A || M))
  zero_lo   k's signed radix-16 digits 0-31 all zero
  zero_hi   k's digits 28-63 all zero
  s_zero    s = 0 (r = -k a), k below 16^57
  small     small-order A (order 8) and R (order 2), s = 0
  nc_ident  A the identity as y = p + 1 (non-canonical), R the identity, s = 0
  nc_small  A as y = p (non-canonical, order 4), R of order 8, s = 0
  sign1     A and R the identity as x = 0 with sign 1, s = 0
  bad_r     an undecodable R
  bad_a     an undecodable A (off the curve)
  s_ge_l    s + L in place of s
  flip      one digest byte flipped (a message the signer never signed)
  small_s   small-order A and R, s = 1

K3 key kinds (``KEY_VALID`` decode under ZIP-215, the rest do not):
  honest, ident (y = 1), nc_ident (y = p + 1), nc_small (y = p, order 4),
  order2 (y = p - 1), order8, sign1 (x = 0 with sign 1); off_curve (two
  different encodings).
"""

from __future__ import annotations

import hashlib

import numpy as np

from cometbft_tpu_torch.crypto import _ref25519 as ref
from cometbft_tpu_torch.crypto import ed25519 as host

P, L = ref.P, ref.L
IDENT = (1).to_bytes(32, "little")
NC_IDENT = (P + 1).to_bytes(32, "little")
NC_ORDER4 = P.to_bytes(32, "little")
ORDER2 = (P - 1).to_bytes(32, "little")
ORDER4 = bytes(32)
ORDER8 = bytes.fromhex("26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")
SIGN1 = ((1 << 255) | 1).to_bytes(32, "little")

LANE_VALID = ("good", "zero_lo", "zero_hi", "s_zero", "small", "nc_ident", "nc_small", "sign1")
LANE_INVALID = ("bad_r", "bad_a", "s_ge_l", "flip", "small_s")
KEY_VALID = ("honest", "ident", "nc_ident", "nc_small", "order2", "order8", "sign1")
KEY_INVALID = ("off_curve",)
VARIANTS = 8  # distinct lanes of each kind; a large batch repeats them
N_KEYS = 6  # signing keys of the pool


def off_curve(i: int = 0) -> bytes:
    """The i-th least y whose encoding does not decode (ZIP-215)."""
    ys = (y for y in range(2, 1000) if ref.decompress(y.to_bytes(32, "little")) is None)
    for _ in range(i):
        next(ys)
    return next(ys).to_bytes(32, "little")


def _chosen_k(rng, zero: range | None, top: int) -> int:
    """A k in [0, L) whose signed radix-16 digits are zero on ``zero`` and
    on every position from ``top`` up."""
    while True:
        d = rng.integers(-8, 8, size=64)
        d[top:] = 0
        if zero is not None:
            d[zero.start : zero.stop] = 0
        k = sum(int(x) << (4 * i) for i, x in enumerate(d))
        if 0 <= k < L:
            return k


class Pool:
    """N_KEYS signing keys from ``seed``."""

    def __init__(self, seed: int):
        rng = np.random.default_rng(seed)
        seeds = [rng.bytes(32) for _ in range(N_KEYS)]
        self.keys = [host.PrivKey.from_seed(s) for s in seeds]
        self.secret = [ref.secret_expand(s)[0] for s in seeds]
        self.pubs = [k.pub_key().data for k in self.keys]


def _lane(pool: Pool, kind: str, rng) -> tuple[bytes, bytes, bytes, bytes]:
    """(A, R, s, digest) of one K5 lane of ``kind``."""
    key = int(rng.integers(0, N_KEYS))
    pub = pool.pubs[key]
    rand_digest = rng.bytes(64)
    if kind in ("good", "bad_r", "bad_a", "s_ge_l", "flip"):
        msg = rng.bytes(int(rng.integers(0, 60)))
        sig = pool.keys[key].sign(msg)
        r_enc, s = sig[:32], int.from_bytes(sig[32:], "little")
        digest = hashlib.sha512(r_enc + pub + msg).digest()
    elif kind in ("zero_lo", "zero_hi", "s_zero"):
        a = pool.secret[key]
        if kind == "zero_lo":
            k = _chosen_k(rng, range(0, 32), 64)
        elif kind == "zero_hi":
            k = _chosen_k(rng, range(28, 64), 64)
        else:
            k = _chosen_k(rng, None, 57)
        r = (-k * a) % L if kind == "s_zero" else int.from_bytes(rng.bytes(64), "little") % L
        r_enc = ref.compress(ref.pt_mul(r, ref.BASE))
        s = (r + k * a) % L
        digest = (k + int.from_bytes(rng.bytes(32), "little") * L).to_bytes(64, "little")
    else:
        pub, r_enc, s = {
            "small": (ORDER8, ORDER2, 0), "nc_ident": (NC_IDENT, IDENT, 0), "nc_small": (NC_ORDER4, ORDER8, 0),
            "sign1": (SIGN1, SIGN1, 0), "small_s": (ORDER8, ORDER4, 1),
        }[kind]
        digest = rand_digest
    if kind == "bad_r":
        r_enc = off_curve(int(rng.integers(0, 3)))
    elif kind == "bad_a":
        pub = off_curve(int(rng.integers(0, 3)))
    elif kind == "s_ge_l":
        s += L
    elif kind == "flip":
        i = int(rng.integers(0, 64))
        digest = digest[:i] + bytes([digest[i] ^ 0x10]) + digest[i + 1 :]
    return pub, r_enc, s.to_bytes(32, "little"), digest


def lane_kinds(n: int, lanes_per_warp: int, lanes_per_block: int, mode: str = "mixed") -> list[str]:
    """The kind of each lane of an n-lane batch.

    mixed: failing kinds in turn at every warp's first and last lane, at
    every block's last lane and at the batch's last lane; the valid kinds
    in turn elsewhere.  valid: every lane valid."""
    out = []
    nv = ni = 0
    for v in range(n):
        edge = v % lanes_per_warp in (0, lanes_per_warp - 1) or v % lanes_per_block == lanes_per_block - 1
        if mode == "mixed" and (edge or v == n - 1):
            out.append(LANE_INVALID[ni % len(LANE_INVALID)])
            ni += 1
        else:
            out.append(LANE_VALID[nv % len(LANE_VALID)])
            nv += 1
    return out


def lanes(pool: Pool, n: int, seed: int, lanes_per_warp: int, lanes_per_block: int, mode: str = "mixed"):
    """An n-lane K5 batch: dict of ``a``, ``r``, ``s`` (n, 32) uint8,
    ``digest`` (n, 64) uint8, ``kinds`` and ``expect`` (n,) bool.
    VARIANTS distinct lanes a kind are made and repeated."""
    rng = np.random.default_rng(seed)
    kinds = lane_kinds(n, lanes_per_warp, lanes_per_block, mode)
    made: dict[str, list] = {}
    rows = []
    for v, kind in enumerate(kinds):
        have = made.setdefault(kind, [])
        if len(have) < VARIANTS:
            have.append(_lane(pool, kind, rng))
            rows.append(have[-1])
        else:
            rows.append(have[v % VARIANTS])
    cols = [np.stack([np.frombuffer(r[c], np.uint8) for r in rows]) for c in range(4)]
    return {"a": cols[0], "r": cols[1], "s": cols[2], "digest": cols[3], "kinds": kinds,
            "expect": np.array([k in LANE_VALID for k in kinds], dtype=bool)}


def host_verdict(a: bytes, r: bytes, s: bytes, digest: bytes) -> bool:
    """[8]([s]B - [k]A - R) == identity, k = digest mod L, A and R
    decoded under ZIP-215, s < L: the port's host arithmetic."""
    A, R = ref.decompress(a), ref.decompress(r)
    s_int = int.from_bytes(s, "little")
    if A is None or R is None or s_int >= L:
        return False
    k = int.from_bytes(digest, "little") % L
    q = ref.pt_add(ref.pt_mul(s_int, ref.BASE), ref.pt_neg(ref.pt_add(ref.pt_mul(k, A), R)))
    for _ in range(3):
        q = ref.pt_add(q, q)
    return q[0] % P == 0 and (q[1] - q[2]) % P == 0


def _key(pool: Pool, kind: str, rng) -> bytes:
    if kind == "honest":
        return pool.pubs[int(rng.integers(0, N_KEYS))]
    if kind == "off_curve":
        return off_curve(int(rng.integers(0, 2)))
    return {"ident": IDENT, "nc_ident": NC_IDENT, "nc_small": NC_ORDER4, "order2": ORDER2, "order8": ORDER8,
            "sign1": SIGN1}[kind]


def key_kinds(V: int, keys_per_warp: int, keys_per_block: int) -> list[str]:
    """Invalid keys at every warp's first and last key, every block's last
    and the batch's last; honest keys and the valid special keys in turn
    elsewhere (every third an honest key)."""
    out = []
    ns = 0
    special = KEY_VALID[1:]
    for v in range(V):
        edge = v % keys_per_warp in (0, keys_per_warp - 1) or v % keys_per_block == keys_per_block - 1
        if edge or v == V - 1:
            out.append("off_curve")
        elif v % 3 == 1:
            out.append("honest")
        else:
            out.append(special[ns % len(special)])
            ns += 1
    return out


def keys(pool: Pool, V: int, seed: int, keys_per_warp: int, keys_per_block: int):
    """A V-key K3 batch: dict of ``pubs`` (V, 32) uint8, ``kinds`` and
    ``expect`` (V,) bool (the keys' validity)."""
    rng = np.random.default_rng(seed)
    kinds = key_kinds(V, keys_per_warp, keys_per_block)
    pubs = np.stack([np.frombuffer(_key(pool, k, rng), np.uint8) for k in kinds])
    return {"pubs": pubs, "kinds": kinds, "expect": np.array([k in KEY_VALID for k in kinds], dtype=bool)}
