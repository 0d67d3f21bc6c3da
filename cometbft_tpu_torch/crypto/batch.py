"""Batch-verifier factory — the plugin seam (reference:
crypto/batch/batch.go:10-27 CreateBatchVerifier / SupportsBatchVerifier).

Routing follows the JAX package's (cometbft_tpu/verifysvc/client.py:37
resolve_mode, without the verify service): an ed25519 set with known
pubkeys binds to its comb tables on the card when it has at least
``comb_min()`` validators — synchronously below ``comb_async_min()``,
through a background build at or above it, verifying uncached until the
tables land.  Smaller sets and calls without pubkeys take the uncached
verifier.  Both thresholds read the JAX package's environment variables
with its defaults, so the two packages route alike.  The secp key types
(``secp256k1``, ``secp256k1eth`` and ``ecrecover``, the CheckTx wire
shapes of verifysvc/checktx.py) all take the batched ECDSA verifier,
models/secp_verifier.SecpBatchVerifier, as the JAX package's
MODE_SECP lane does (cometbft_tpu/verifysvc/service.mode_for_key_type).
The BLS key type (``bls12_381``) takes the aggregate verifier,
models/bls_verifier.BlsAggregateVerifier, as the JAX package's MODE_BLS
lane does.
"""

from __future__ import annotations

from .. import envknobs
from .._device import resolve_device
from ..models.bls_verifier import BlsAggregateVerifier
from ..models.comb_verifier import CombBatchVerifier, global_cache
from ..models.secp_verifier import SecpBatchVerifier
from ..models.verifier import Ed25519BatchVerifier
from . import bls12381, ed25519, secp256k1, secp256k1eth

SECP_KEY_TYPES = (secp256k1.KEY_TYPE, secp256k1eth.KEY_TYPE, secp256k1eth.RECOVER_KEY_TYPE)


def comb_min() -> int:
    """Smallest validator set that binds to comb tables
    (COMETBFT_TPU_COMB_MIN, default 512)."""
    return envknobs.get_int("COMETBFT_TPU_COMB_MIN", 512)


def comb_async_min() -> int:
    """Set size at or above which missing tables build in the background
    while verification runs uncached (COMETBFT_TPU_COMB_ASYNC_MIN,
    default 2048)."""
    return envknobs.get_int("COMETBFT_TPU_COMB_ASYNC_MIN", 2048)


def supports_batch_verifier(key_type: str) -> bool:
    """ed25519, the three secp key types and bls12_381 batch on the card."""
    return key_type in (ed25519.KEY_TYPE, bls12381.KEY_TYPE) or key_type in SECP_KEY_TYPES


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
    cache) where the routing above allows, else an Ed25519BatchVerifier;
    a SecpBatchVerifier for the secp key types; a BlsAggregateVerifier
    for bls12_381."""
    if not supports_batch_verifier(key_type):
        raise ValueError(f"no batch verifier for key type {key_type!r}")
    dev = resolve_device(device)
    if key_type in SECP_KEY_TYPES:
        return SecpBatchVerifier(device=dev)  # rows carry their own keys
    if key_type == bls12381.KEY_TYPE:
        return BlsAggregateVerifier(device=dev)  # per-key facts are cached per process
    if pubkeys is None or len(pubkeys) < comb_min():
        return Ed25519BatchVerifier(device=dev)
    cache = global_cache() if comb_cache is None else comb_cache
    if len(pubkeys) >= comb_async_min():
        entry = cache.ensure_async(pubkeys, device=dev)
        if entry is None:
            return Ed25519BatchVerifier(device=dev)  # tables still building
        return CombBatchVerifier(entry)
    return CombBatchVerifier(cache.ensure(pubkeys, device=dev))
