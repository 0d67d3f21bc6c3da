"""Batch-verifier factory — the plugin seam (reference:
crypto/batch/batch.go:10-27 CreateBatchVerifier / SupportsBatchVerifier).

Routing follows the JAX package's (cometbft_tpu/verifysvc/client.py:37
resolve_mode, without the verify service): an ed25519 set with known
pubkeys binds to its comb tables on the card when it has at least
``comb_min()`` validators — synchronously below ``comb_async_min()``,
through a background build at or above it, verifying uncached until the
tables land.  Smaller sets and calls without pubkeys take the uncached
verifier.  Both thresholds read the JAX package's environment variables
with its defaults, so the two packages route alike.
"""

from __future__ import annotations

import os

from .._device import resolve_device
from ..models.comb_verifier import CombBatchVerifier, global_cache
from ..models.verifier import Ed25519BatchVerifier
from . import ed25519


def _env_int(name: str, default: int) -> int:
    """cometbft_tpu/utils/envknobs.get_int: an unset, empty or malformed
    value gives the default."""
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def comb_min() -> int:
    """Smallest validator set that binds to comb tables
    (COMETBFT_TPU_COMB_MIN, default 512)."""
    return _env_int("COMETBFT_TPU_COMB_MIN", 512)


def comb_async_min() -> int:
    """Set size at or above which missing tables build in the background
    while verification runs uncached (COMETBFT_TPU_COMB_ASYNC_MIN,
    default 2048)."""
    return _env_int("COMETBFT_TPU_COMB_ASYNC_MIN", 2048)


def supports_batch_verifier(key_type: str) -> bool:
    """ed25519 batches on the card; the other key types' lanes
    (bls12_381, secp256k1) are later slices of the port."""
    return key_type == ed25519.KEY_TYPE


def create_batch_verifier(
    key_type: str,
    pubkeys: list[bytes] | None = None,
    *,
    device="cuda",
    comb_cache=None,
):
    """(crypto/batch/batch.go:10)  A batch verifier on ``device`` for the
    validator set ``pubkeys`` (in set order): a CombBatchVerifier bound
    to the set's tables in ``comb_cache`` (default: the process-wide
    cache) where the routing above allows, else an Ed25519BatchVerifier."""
    if not supports_batch_verifier(key_type):
        raise ValueError(f"no batch verifier for key type {key_type!r}")
    dev = resolve_device(device)
    if pubkeys is None or len(pubkeys) < comb_min():
        return Ed25519BatchVerifier(device=dev)
    cache = global_cache() if comb_cache is None else comb_cache
    if len(pubkeys) >= comb_async_min():
        entry = cache.ensure_async(pubkeys, device=dev)
        if entry is None:
            return Ed25519BatchVerifier(device=dev)  # tables still building
        return CombBatchVerifier(entry)
    return CombBatchVerifier(cache.ensure(pubkeys, device=dev))
