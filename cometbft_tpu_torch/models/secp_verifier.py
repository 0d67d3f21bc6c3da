"""Batched secp256k1 / ECDSA verifiers — the port of
cometbft_tpu/models/secp_verifier.py (the lane that CheckTx signature
checks of three wire shapes take):

* Cosmos: 33-byte compressed pubkey, 64-byte r || s over SHA-256
  (crypto/secp256k1);
* Ethereum: 65-byte uncompressed pubkey, 65-byte R || S || V over
  Keccak-256 (crypto/secp256k1eth);
* ecrecover: a 20-byte sender address and no pubkey; the verifier
  recovers the signer and compares its address
  (crypto/secp256k1eth.verify_address_signature).

Rows are told apart by their pubkey length.  Verdict procedure, the same
on every path:

1. host half: the pubkey decodes (cached per key, ``_decode_pub``) and
   the signature has its key's length; the message hash is computed ON
   THE CARD inside K12 when the batch has at least
   ``COMETBFT_TPU_SECP_HASH_DEVICE_MIN`` rows (64) and every message fits
   ``COMETBFT_TPU_SECP_HASH_MAX_LEN`` bytes (119); otherwise SHA-256 rows
   hash on the host (hashlib) and Keccak-256 rows on the card through
   K10, whose digests become e on the card;
2. data half, on the card: K12 (hash and verify) or K11 (verify), GLV
   walk by default, the Shamir witness under ``COMETBFT_TPU_SECP_GLV=0``,
   the ecrecover instantiation when the batch has an ecrecover row.

Where the JAX class hashes a batch on the host it runs its Keccak in
pure Python; the port runs those digests through K10 instead (the
same digests: ROADMAP C).  The JAX class sends batches under
``COMETBFT_TPU_SECP_DEVICE_MIN`` rows (8) to the host; the port, as for
ed25519, sends every batch to the card (ROADMAP C).  ``CpuSecpBatchVerifier`` is the host oracle of the
tests: the crypto modules' own gauntlet, row by row.
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np
import torch

from .. import envknobs
from .._device import resolve_device
from ..crypto import secp256k1 as host_secp
from ..crypto import secp256k1eth as host_eth
from ..ops import keccak as kops
from ..ops import secp256k1 as dev_secp
from ..ops import sha2
from ..utils import tracing

COSMOS_PUB = host_secp.PUBKEY_SIZE  # 33: compressed
COSMOS_SIG = host_secp.SIGNATURE_SIZE  # 64: r || s
ETH_PUB = host_eth.PUBKEY_SIZE  # 65: 0x04 || x || y
ETH_SIG = host_eth.SIGNATURE_SIZE  # 65: R || S || V
ECR_PUB = host_eth.ADDRESS_SIZE  # 20: sender address (no pubkey on the wire)
ECR_SIG = host_eth.SIGNATURE_SIZE  # 65: R || S || V

_MISS = object()


def hash_device_min() -> int:
    """COMETBFT_TPU_SECP_HASH_DEVICE_MIN (default 64; 0 disables)."""
    return envknobs.get_int("COMETBFT_TPU_SECP_HASH_DEVICE_MIN", 64)


def hash_max_len() -> int:
    """COMETBFT_TPU_SECP_HASH_MAX_LEN (default 119)."""
    return envknobs.get_int("COMETBFT_TPU_SECP_HASH_MAX_LEN", 119)


def glv_enabled() -> bool:
    """COMETBFT_TPU_SECP_GLV (default on)."""
    return envknobs.get_bool("COMETBFT_TPU_SECP_GLV", True)


class _FactCache:
    """Bounded FIFO cache of per-input FACTS (a copy of
    cometbft_tpu/models/bls_verifier.py:69): deterministic values, so
    caching can never split verdicts.  Thread-safe."""

    def __init__(self, max_size: int):
        self._d: dict = {}
        self._max = max_size
        self._mtx = threading.Lock()

    def get(self, key, default=None):
        with self._mtx:
            return self._d.get(key, default)

    def put(self, key, value) -> None:
        if self._max <= 0:
            return
        with self._mtx:
            if key not in self._d and len(self._d) >= self._max:
                self._d.pop(next(iter(self._d)))
            self._d[key] = value

    def clear(self) -> None:
        with self._mtx:
            self._d.clear()

    def __len__(self) -> int:
        with self._mtx:
            return len(self._d)


# pubkey bytes -> (x, y, the 64 bytes of x and y as little-endian words)
# | None (malformed).  Sized by COMETBFT_TPU_SECP_PUBKEY_CACHE at first
# use; CheckTx ingest repeats senders.
_PK_CACHE: _FactCache | None = None
_PK_CACHE_MTX = threading.Lock()
CACHE_STATS = {"hit": 0, "miss": 0}  # decode lookups since import


def _pk_cache() -> _FactCache:
    global _PK_CACHE
    if _PK_CACHE is None:
        with _PK_CACHE_MTX:
            if _PK_CACHE is None:
                _PK_CACHE = _FactCache(max(0, envknobs.get_int("COMETBFT_TPU_SECP_PUBKEY_CACHE", 65536)))
    return _PK_CACHE


def reset_caches() -> None:
    """Drop every cached decode (and re-read the size on next use)."""
    global _PK_CACHE
    _PK_CACHE = None


def _decode_pub(pub: bytes):
    """Pubkey bytes -> (x, y, words) with the affine coordinates as ints
    and as 64 little-endian bytes, or None for a malformed or
    wrong-length encoding.  Cache-backed."""
    cache = _pk_cache()
    hit = cache.get(pub, _MISS)
    if hit is not _MISS:
        CACHE_STATS["hit"] += 1
        return hit
    CACHE_STATS["miss"] += 1
    fact = None
    try:
        if len(pub) == COSMOS_PUB:
            x, y = host_secp._decompress(pub)
        elif len(pub) == ETH_PUB:
            x, y = host_eth._parse_uncompressed(pub)
        else:
            x = None
        if x is not None:
            fact = (x, y, x.to_bytes(32, "little") + y.to_bytes(32, "little"))
    except ValueError:
        fact = None
    cache.put(pub, fact)
    return fact


def _host_verify_one(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """The host verdict oracle: the crypto modules' own key construction
    and verify, selected by pubkey length; malformed anything is False."""
    try:
        if len(pub) == COSMOS_PUB:
            return host_secp.PubKey(pub).verify_signature(msg, sig)
        if len(pub) == ETH_PUB:
            return host_eth.PubKey(pub).verify_signature(msg, sig)
        if len(pub) == ECR_PUB:
            return host_eth.verify_address_signature(pub, msg, sig)
    except ValueError:
        return False
    return False


def _bucket(n: int) -> int:
    """Power-of-two row count, at least 8 (cometbft_tpu/models/
    secp_verifier.py:165)."""
    b = 8
    while b < n:
        b *= 2
    return b


def _check_item(pub: bytes, msg: bytes, sig: bytes) -> None:
    if len(pub) not in (ECR_PUB, COSMOS_PUB, ETH_PUB) or len(sig) not in (COSMOS_SIG, ETH_SIG):
        raise ValueError("malformed secp256k1 pubkey or signature")


def stage_batch(items, device: torch.device, hash_dev: bool, hmax: int, phases: dict | None = None) -> dict:
    """Host assembly of a batch and ONE host-to-device copy.

    Rows are padded to ``_bucket(len(items))``; padding and rejected rows
    (bad encoding, a signature of the wrong length) stay zero with
    q_valid = 0, which the kernels judge False.  Every array is written
    into one flat buffer — page-locked when ``device`` is a card — at
    16-byte aligned offsets, and the returned dict holds views of its
    device copy: qx, qy, r, s as (B, 8) int32 words; q_valid, is_eth,
    is_rec (B,) uint8; v (B,) int32; addr (B, 20) uint8.  With device
    hashing, sha_blocks / sha_active and kec_blocks / kec_active (every
    row padded both ways, as the JAX program takes them); with host
    hashing, e (the SHA-256 rows' digests; zero on Keccak rows) and,
    when there are Keccak rows, kec_blocks / kec_active holding only
    those rows' messages (active 0 elsewhere) for K10."""
    phases = {} if phases is None else phases
    n = len(items)
    b = _bucket(n)
    t0 = time.perf_counter()
    valid = np.zeros((b,), np.uint8)
    is_eth = np.zeros((b,), np.uint8)
    is_rec = np.zeros((b,), np.uint8)
    v = np.zeros((b,), np.int32)
    addr = np.zeros((b, ECR_PUB), np.uint8)
    q = np.zeros((b, 64), np.uint8)
    rs = np.zeros((b, 64), np.uint8)
    e = np.zeros((b, 32), np.uint8)
    msgs: list[bytes] = [b""] * b
    kec_msgs: list[bytes] = [b""] * b
    decode_s = hash_s = 0.0
    rows, qraw, sraw = [], [], []
    for i, (pub, msg, sig) in enumerate(items):
        lp = len(pub)
        eth, rec = lp == ETH_PUB, lp == ECR_PUB
        if rec:
            if len(sig) != ECR_SIG:
                continue
            addr[i] = np.frombuffer(pub, np.uint8)
            qraw.append(bytes(64))
        else:
            td = time.perf_counter()
            fact = _decode_pub(pub)
            decode_s += time.perf_counter() - td
            if fact is None or len(sig) != (ETH_SIG if eth else COSMOS_SIG):
                continue
            valid[i] = 1
            qraw.append(fact[2])
        is_eth[i] = eth
        is_rec[i] = rec
        if eth or rec:
            v[i] = sig[64]
        if hash_dev:
            msgs[i] = msg
        elif eth or rec:
            kec_msgs[i] = msg
        else:
            th = time.perf_counter()
            e[i] = np.frombuffer(hashlib.sha256(msg).digest(), np.uint8)
            hash_s += time.perf_counter() - th
        sraw.append(sig[:64])
        rows.append(i)
    if rows:
        q[rows] = np.frombuffer(b"".join(qraw), np.uint8).reshape(-1, 64)
        rs[rows] = np.frombuffer(b"".join(sraw), np.uint8).reshape(-1, 64)
    segs = {
        "qx": q[:, :32], "qy": q[:, 32:],  # already little-endian words
        "r": dev_secp.be_bytes_to_words_np(rs[:, :32]), "s": dev_secp.be_bytes_to_words_np(rs[:, 32:]),
        "q_valid": valid, "is_eth": is_eth, "is_rec": is_rec, "v": v, "addr": addr,
    }
    if hash_dev:
        tp = time.perf_counter()
        segs["sha_blocks"], segs["sha_active"] = sha2.pad_messages_sha256(msgs, max_len=hmax)
        segs["kec_blocks"], segs["kec_active"] = kops.pad_messages_keccak(msgs, max_len=hmax)
        hash_s += time.perf_counter() - tp
    else:
        segs["e"] = dev_secp.be_bytes_to_words_np(e)
        kec_rows = (is_eth | is_rec) != 0
        if kec_rows.any():
            tp = time.perf_counter()
            segs["kec_blocks"], kec_active = kops.pad_messages_keccak(kec_msgs)
            kec_active[~kec_rows] = 0
            segs["kec_active"] = kec_active
            hash_s += time.perf_counter() - tp
    offs, total = {}, 0
    for k, a in segs.items():
        offs[k] = total
        total += (a.nbytes + 15) // 16 * 16
    host = torch.empty((total,), dtype=torch.uint8, pin_memory=device.type == "cuda")
    hb = host.numpy()
    for k, a in segs.items():
        hb[offs[k] : offs[k] + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    flat = host.to(device, non_blocking=True) if device.type == "cuda" else host
    out = {}
    for k, a in segs.items():
        view = flat[offs[k] : offs[k] + a.nbytes]
        if k in ("qx", "qy", "r", "s", "e"):
            out[k] = view.view(torch.int32).view(b, 8)
        elif k in ("v", "sha_active", "kec_active"):
            out[k] = view.view(torch.int32)
        else:
            out[k] = view.view(a.shape)
    phases["decode_ms"] = decode_s * 1e3
    phases["hash_ms"] = hash_s * 1e3
    phases["assembly_ms"] = (time.perf_counter() - t0 - decode_s - hash_s) * 1e3
    return out


def staged_e(st: dict) -> torch.Tensor:
    """e of a host-hashed stage_batch: the host's SHA-256 digests, with
    the Keccak rows' digests from K10 read big-endian in their place."""
    if "kec_blocks" not in st:
        return st["e"]
    dig = kops.keccak256_blocks(st["kec_blocks"], st["kec_active"])
    e_kec = dig.flip(1).contiguous().view(torch.int32)
    return torch.where(((st["is_eth"] | st["is_rec"]) != 0)[:, None], e_kec, st["e"])


def _dispatch(st: dict, dev: torch.device, hash_dev: bool, glv: bool, recover: bool) -> torch.Tensor:
    gtab = dev_secp.g_table(dev)
    rows = (st["qx"], st["qy"], st["q_valid"])
    tail = (st["is_eth"], st["v"], st["is_rec"], st["addr"], gtab)
    if hash_dev:
        return dev_secp.hash_verify_batch(
            st["sha_blocks"], st["sha_active"], st["kec_blocks"], st["kec_active"],
            *rows, st["r"], st["s"], *tail, glv=glv, recover=recover)
    return dev_secp.verify_batch(*rows, staged_e(st), st["r"], st["s"], *tail, glv=glv, recover=recover)


def _route(items) -> tuple[bool, int, bool, bool]:
    """(hash on the card, max length, GLV, recover) for a batch: the
    JAX package's knobs, ``recover`` derived from the batch (:1080)."""
    n = len(items)
    hmin, hmax = hash_device_min(), hash_max_len()
    hash_dev = hmin > 0 and n >= hmin and all(len(m) <= hmax for (_, m, _) in items)
    recover = any(len(p) == ECR_PUB for (p, _, _) in items)
    return hash_dev, hmax, glv_enabled(), recover


class CpuSecpBatchVerifier:
    """The host oracle: the crypto modules' verify, row by row."""

    def __init__(self) -> None:
        self._items: list[tuple[bytes, bytes, bytes]] = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        _check_item(pub_key, msg, sig)
        self._items.append((pub_key, msg, sig))

    def verify(self) -> tuple[bool, list[bool]]:
        res = [_host_verify_one(p, m, s) for (p, m, s) in self._items]
        return all(res) and bool(res), res


class SecpBatchVerifier:
    """ECDSA verification on ``device`` through K12 (hash on the card) or
    K11 (hash on the host) — the port of
    cometbft_tpu/models/secp_verifier.py:318 TpuSecpBatchVerifier.  A call
    makes one host-to-device copy of a page-locked buffer and one
    device-to-host copy of the verdicts.  ``last_timings`` holds the last
    call's phases in ms (decode, hash, assembly, h2d_dispatch,
    device_wait, submit, kernel) and its route (rows, hash_device, glv,
    recover)."""

    def __init__(self, device="cuda") -> None:
        self._dev = resolve_device(device)
        self._items: list[tuple[bytes, bytes, bytes]] = []
        self.last_timings: dict[str, float] = {}

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        _check_item(pub_key, msg, sig)
        self._items.append((pub_key, msg, sig))

    def submit(self):
        """Stage the batch, copy it to the card and enqueue the kernel and
        the copy of the verdicts back, WITHOUT waiting.  Returns a ticket
        for collect()."""
        n = len(self._items)
        if n == 0:
            return ("sync", (False, []))
        hash_dev, hmax, glv, recover = _route(self._items)
        timings = {"rows": float(n), "hash_device": float(hash_dev), "glv": float(glv),
                   "recover": float(recover)}
        st = stage_batch(self._items, self._dev, hash_dev, hmax, timings)
        t1 = time.perf_counter()
        with tracing.span(
            "verify.secp_batch",
            {"sigs": n, "where": "device", "hash": "device" if hash_dev else "host"}
            if tracing.enabled() else None,
        ):
            ok = _dispatch(st, self._dev, hash_dev, glv, recover)[:n]
            if self._dev.type == "cuda":
                host = torch.empty((n,), dtype=torch.bool, pin_memory=True)
                host.copy_(ok, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(ok.device))
            else:
                host, done = ok, None
        timings["h2d_dispatch_ms"] = (time.perf_counter() - t1) * 1e3
        return ("dev", (done, host, timings))

    def collect(self, ticket) -> tuple[bool, list[bool]]:
        """Wait for a submit() ticket: (all_ok, per-signature) in add() order."""
        kind, payload = ticket
        if kind == "sync":
            return payload
        done, host, timings = payload
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        timings["device_wait_ms"] = (time.perf_counter() - t0) * 1e3
        self.last_timings.update(timings)
        res = host.tolist()
        return all(res), res

    def verify(self) -> tuple[bool, list[bool]]:
        self.last_timings = {}
        t0 = time.perf_counter()
        ticket = self.submit()
        t1 = time.perf_counter()
        result = self.collect(ticket)
        t2 = time.perf_counter()
        if ticket[0] == "dev":
            self.last_timings["submit_ms"] = (t1 - t0) * 1e3
            self.last_timings["kernel_ms"] = (t2 - t1) * 1e3
        return result
