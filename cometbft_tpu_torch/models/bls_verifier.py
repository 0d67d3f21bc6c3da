"""Batched BLS12-381 aggregate-commit verifiers — the port of
cometbft_tpu/models/bls_verifier.py (the lane of the bls12_381 key type).

The cost model: an ed25519 commit costs N independent verifies; a BLS
aggregate commit costs ONE pairing-product check plus a data-parallel
pubkey sum.  The batch-verifier seam still receives per-validator
(pub, msg, sig) rows, so the verifier groups rows into **units** keyed by
exact (msg, sig) bytes:

* an aggregate commit arrives as N rows sharing one message and one
  aggregate signature -> one unit, one signature decode, one pubkey sum
  (K14 on the card), one pairing check;
* individually signed rows are N singleton units -> the whole batch is
  still ONE pairing-product check (N + 1 Miller loops, one final
  exponentiation in the native core) with exact per-row blame on
  failure.

Verdict procedure (the JAX package's ``_verify_items``, the same on
every path):

1. well-formedness: pubkeys decompress, are finite, on the curve and in
   the r-subgroup (cached across calls — per-key facts); unit signatures
   decompress, are finite, on the curve and in the r-subgroup.
2. if every row is well-formed: ONE pairing-product check
   ``prod e(agg_pk_u, H(m_u)) * e(-g1, sum sigs) == 1`` decides the
   batch; pass -> every row True.  On failure (or when any row is
   malformed) each unit is re-checked alone and every row of a failing
   unit reads False.

A passing batch check certifies the batch, not each element (within a
unit, blame is unit-granular).  FastAggregateVerify over same-message
rows is SOUND ONLY for proof-of-possession-checked keys
(crypto/bls12381.pop_verify at key registration).

Split of labour: ``CpuBlsBatchVerifier`` is pure host (the tests' host
oracle); ``BlsAggregateVerifier`` validates new pubkeys on the card
(K13, or K15 fused with the sum on an aggregate commit's cold path) and
sums units on the card (K14) when the batch clears the JAX package's
thresholds, read from its environment variables with its defaults:
``COMETBFT_TPU_BLS_VALIDATE_DEVICE_MIN`` (8 new keys),
``COMETBFT_TPU_BLS_AGG_DEVICE_MIN`` (256 keys in a unit) and
``COMETBFT_TPU_BLS_PUBKEY_CACHE`` (65,536 facts).  Pairings stay on the
host, in the native core (crypto/bls12381).  Spans (utils/tracing.py,
the JAX names and sites): ``verify.bls_validate`` around a validation on
the card (``fused`` on the cold aggregate path), ``verify.bls_aggregate``
around a sum on the card, ``verify.bls_pairing`` around the batch's
pairing-product check.  The metrics hub is not ported.
"""

from __future__ import annotations

import threading
import time

from .. import envknobs
from .._device import resolve_device
from ..crypto import bls12381 as host_bls
from ..ops import bls381 as dev_bls
from ..utils import tracing

PUBKEY_SIZE = host_bls.PUBKEY_SIZE  # 48: compressed G1
SIG_SIZE = host_bls.SIG_SIZE  # 96: compressed G2

_NEG_G1 = (host_bls.G1_GEN[0], (-host_bls.G1_GEN[1]) % host_bls.P)

# cache-miss sentinel: None is a legitimate cached value ("invalid key")
_MISS = object()


def validate_device_min() -> int:
    """COMETBFT_TPU_BLS_VALIDATE_DEVICE_MIN (default 8): new keys from
    which validation runs on the card."""
    return max(1, envknobs.get_int("COMETBFT_TPU_BLS_VALIDATE_DEVICE_MIN", 8))


def agg_device_min() -> int:
    """COMETBFT_TPU_BLS_AGG_DEVICE_MIN (default 256): unit size from
    which the pubkey sum runs on the card."""
    return max(1, envknobs.get_int("COMETBFT_TPU_BLS_AGG_DEVICE_MIN", 256))


class _FactCache:
    """Bounded FIFO cache of per-input FACTS (deterministic values), shared
    by the host and card paths — caching can never split their verdicts
    (cometbft_tpu/models/bls_verifier.py:69).  Thread-safe."""

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


# pubkey bytes -> affine (x, y) (finite, on the curve, in the subgroup) |
# None (invalid); sized by COMETBFT_TPU_BLS_PUBKEY_CACHE at first use
_PK_CACHE: _FactCache | None = None
_PK_CACHE_MTX = threading.Lock()

# msg -> hash_to_g2 affine point (light and commit checks re-hash the
# same sign-bytes)
_H2_CACHE = _FactCache(1024)


def _pk_cache() -> _FactCache:
    global _PK_CACHE
    if _PK_CACHE is None:
        with _PK_CACHE_MTX:
            if _PK_CACHE is None:
                _PK_CACHE = _FactCache(max(0, envknobs.get_int("COMETBFT_TPU_BLS_PUBKEY_CACHE", 65536)))
    return _PK_CACHE


def reset_caches() -> None:
    """Tests and cold measurements: drop every cached fact (and re-read
    the cache-size knob on next use)."""
    global _PK_CACHE
    with _PK_CACHE_MTX:
        _PK_CACHE = None
    _H2_CACHE.clear()


def _hash_g2(msg: bytes):
    h = _H2_CACHE.get(msg)
    if h is None:
        h = host_bls.hash_to_g2(msg)
        _H2_CACHE.put(msg, h)
    return h


def _decode_pub(pub: bytes):
    """Compressed G1 pubkey -> affine pair, or None for malformed /
    infinite encodings.  Decompression guarantees on-curve; the subgroup
    check is the batched half (card or host)."""
    try:
        return host_bls._g1_decompress(pub)
    except ValueError:
        return None


def _decode_sig(sig: bytes):
    """Compressed G2 signature -> affine pair, or None for malformed /
    infinite / off-curve / out-of-subgroup encodings."""
    try:
        s = host_bls._g2_decompress(sig)
    except ValueError:
        return None
    if s is None or not host_bls._on_curve(host_bls._FP2, s) or not host_bls._in_subgroup(host_bls._FP2, s):
        return None
    return s


class _Clock:
    """Accumulates the phases of one verify into ``timings`` (ms)."""

    def __init__(self, timings: dict | None):
        self.timings = timings
        self.t = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        if self.timings is not None:
            self.timings[phase] = self.timings.get(phase, 0.0) + (now - self.t) * 1e3
        self.t = now


def _validated_pubkeys(pubs, device, clock: _Clock):
    """-> list of affine | None (None = invalid), cache-backed.  The
    uncached keys' subgroup checks run on the card (K13) when ``device``
    is set and they number COMETBFT_TPU_BLS_VALIDATE_DEVICE_MIN or more,
    else on the host."""
    cache = _pk_cache()
    out: list = [_MISS] * len(pubs)
    fresh: dict[bytes, list[int]] = {}
    for i, pub in enumerate(pubs):
        hit = cache.get(pub, _MISS)
        if hit is not _MISS:
            out[i] = hit
        else:
            fresh.setdefault(pub, []).append(i)
    if not fresh:
        return out
    order = list(fresh.keys())
    decoded = [_decode_pub(pub) for pub in order]
    clock.lap("decode_ms")
    candidates = sum(1 for aff in decoded if aff is not None)
    if device is not None and candidates >= validate_device_min():
        with tracing.span(
            "verify.bls_validate",
            {"keys": len(decoded), "where": "device"} if tracing.enabled() else None,
        ):
            ok = dev_bls.validate_pubkeys_device(decoded, device=device)
        checked = [aff if o else None for aff, o in zip(decoded, ok)]
    else:
        checked = [
            aff if aff is not None and host_bls._in_subgroup(host_bls._FP, aff) else None
            for aff in decoded
        ]
    for pub, aff in zip(order, checked):
        cache.put(pub, aff)
        for i in fresh[pub]:
            out[i] = aff
    return out


def _aggregate_unit(affs, device):
    """Sum a unit's (validated) affine pubkeys -> affine pair or None
    (identity): K14 from COMETBFT_TPU_BLS_AGG_DEVICE_MIN keys when
    ``device`` is set, the host Jacobian sum below.  Affine coordinates
    are unique, so the two cannot diverge."""
    if len(affs) == 1:
        # a singleton unit: the sum IS the point (no inversion per row)
        return affs[0]
    if device is not None and len(affs) >= agg_device_min():
        with tracing.span(
            "verify.bls_aggregate",
            {"keys": len(affs), "where": "device"} if tracing.enabled() else None,
        ):
            return dev_bls.aggregate_pubkeys_device(affs, device=device)
    acc = (host_bls._FP.one, host_bls._FP.one, host_bls._FP.zero)
    for aff in affs:
        acc = host_bls._jac_add(host_bls._FP, acc, host_bls._from_affine(host_bls._FP, aff))
    return host_bls._to_affine(host_bls._FP, acc)


def _verify_items(items, device=None, timings: dict | None = None) -> tuple[bool, list[bool]]:
    """The ONE verdict procedure (module docstring) of both verifier
    classes; ``device`` (None = host) only moves the G1 arithmetic.
    ``timings``, when given, collects decode_ms, validate_ms (with the
    fact-cache lookups), aggregate_ms, sig_decode_ms (with the sum of
    the units' signatures), hash_to_g2_ms and pairing_ms."""
    n = len(items)
    if n == 0:
        return (False, [])
    clock = _Clock(timings)

    # units: rows grouped by exact (msg, sig) bytes, in first-seen order
    units: dict[tuple[bytes, bytes], list[int]] = {}
    for i, (_, msg, sig) in enumerate(items):
        units.setdefault((msg, sig), []).append(i)

    pubs = [pub for pub, _, _ in items]
    agg_memo: dict[tuple[bytes, bytes], object] = {}
    cache = _pk_cache()
    fresh = sum(1 for p in set(pubs) if cache.get(p, _MISS) is _MISS)
    if device is not None and len(units) == 1 and fresh >= validate_device_min():
        # the aggregate-commit cold path: validation and the pubkey sum
        # fused on the card (K15 + K14's finishing stage); the sum covers
        # exactly the valid rows, so when every row is well-formed it IS
        # the unit's aggregate
        decoded = [_decode_pub(p) for p in pubs]
        clock.lap("decode_ms")
        with tracing.span(
            "verify.bls_validate",
            {"keys": n, "where": "device", "fused": True} if tracing.enabled() else None,
        ):
            ok, agg = dev_bls.validate_aggregate_device(decoded, device=device)
        clock.lap("validate_ms")
        pub_affs = [aff if o else None for aff, o in zip(decoded, ok)]
        for p, aff in zip(pubs, pub_affs):
            cache.put(p, aff)
        if all(ok):
            (key,) = units
            agg_memo[key] = agg
    else:
        pub_affs = _validated_pubkeys(pubs, device, clock)
        clock.lap("validate_ms")  # cache hits count as validation

    sig_pts = {key: _decode_sig(key[1]) for key in units}
    clock.lap("sig_decode_ms")

    wellformed: dict[tuple[bytes, bytes], bool] = {
        key: sig_pts[key] is not None and all(pub_affs[i] is not None for i in rows)
        for key, rows in units.items()
    }

    def unit_pairs(key):
        # memoised: the blame path reuses the hot path's (possibly
        # card-computed) sums, never recomputes them
        if key not in agg_memo:
            agg_memo[key] = _aggregate_unit([pub_affs[i] for i in units[key]], device)
            clock.lap("aggregate_ms")
        h = _hash_g2(key[0])
        clock.lap("hash_to_g2_ms")
        return (agg_memo[key], h)

    def pairing(pairs) -> bool:
        ok_ = host_bls._pairings_product_is_one(pairs)
        clock.lap("pairing_ms")
        return ok_

    verdict: dict[tuple[bytes, bytes], bool] = {}
    batch_ok = None
    if all(wellformed.values()):
        # the hot path: ONE pairing-product check for the whole batch
        pairs = [unit_pairs(key) for key in units]
        acc = (host_bls._FP2.one, host_bls._FP2.one, host_bls._FP2.zero)
        for key in units:
            acc = host_bls._jac_add(host_bls._FP2, acc, host_bls._from_affine(host_bls._FP2, sig_pts[key]))
        pairs.append((_NEG_G1, host_bls._to_affine(host_bls._FP2, acc)))
        clock.lap("sig_decode_ms")
        with tracing.span("verify.bls_pairing", {"units": len(units)} if tracing.enabled() else None):
            batch_ok = pairing(pairs)
        if batch_ok:
            return (True, [True] * n)

    # blame: each well-formed unit re-checked alone; every row of a
    # malformed or failing unit reads False
    for key in units:
        if not wellformed[key]:
            verdict[key] = False
        elif batch_ok is not None and len(units) == 1:
            # a single well-formed unit's own check IS the batch product
            # that just failed — no second pairing
            verdict[key] = batch_ok
        else:
            verdict[key] = pairing([unit_pairs(key), (_NEG_G1, sig_pts[key])])
    res = [False] * n
    for key, rows in units.items():
        for i in rows:
            res[i] = verdict[key]
    return (all(res) and bool(res), res)


def _check_item(pub: bytes, msg: bytes, sig: bytes) -> None:
    if len(pub) != PUBKEY_SIZE or len(sig) != SIG_SIZE:
        raise ValueError("malformed bls12-381 pubkey or signature")


class CpuBlsBatchVerifier:
    """Pure-host BLS verification: the same verdict procedure with every
    G1 operation on the host (the tests' oracle)."""

    def __init__(self) -> None:
        self._items: list[tuple[bytes, bytes, bytes]] = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        _check_item(pub_key, msg, sig)
        self._items.append((pub_key, msg, sig))

    def verify(self) -> tuple[bool, list[bool]]:
        return _verify_items(self._items)


class BlsAggregateVerifier:
    """Card-assisted BLS verification on ``device`` ("cuda" by default;
    "cpu" runs the kernels' plain versions): pubkey validation (K13, or
    K15 fused with the sum) and unit sums (K14) on the card, pairings on
    the host.  submit() runs the whole verdict procedure (its card work
    is synchronous: the host needs the sums for the pairing); collect()
    returns it.  ``last_timings`` holds the last verify's phases (ms):
    decode, validate, aggregate, sig_decode, hash_to_g2, pairing."""

    def __init__(self, device="cuda") -> None:
        self._device = resolve_device(device)
        self._items: list[tuple[bytes, bytes, bytes]] = []
        self.last_timings: dict[str, float] = {}

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        _check_item(pub_key, msg, sig)
        self._items.append((pub_key, msg, sig))

    def submit(self):
        timings: dict[str, float] = {}
        res = _verify_items(self._items, self._device, timings)
        return ("sync", res, timings)

    def collect(self, ticket) -> tuple[bool, list[bool]]:
        self.last_timings = dict(ticket[2])
        return ticket[1]

    def verify(self) -> tuple[bool, list[bool]]:
        return self.collect(self.submit())
