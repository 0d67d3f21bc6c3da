"""Batch-verifier factory — the plugin seam (reference:
crypto/batch/batch.go:10-27 CreateBatchVerifier / SupportsBatchVerifier).

In this slice an ed25519 validator set with known pubkeys binds to its
comb tables on the card at any size (models/comb_verifier).  A call
without pubkeys needs the uncached (Straus) kernel, which is not ported
yet, and raises NotImplementedError; verify_commit always passes the
set's pubkeys.
"""

from __future__ import annotations

from .._device import resolve_device
from ..models.comb_verifier import STRAUS_GAP, CombBatchVerifier, global_cache
from . import ed25519


def supports_batch_verifier(key_type: str) -> bool:
    """ed25519 batches through the comb kernels; the other key types'
    lanes (bls12_381, secp256k1) are later slices of the port."""
    return key_type == ed25519.KEY_TYPE


def create_batch_verifier(
    key_type: str,
    pubkeys: list[bytes] | None = None,
    *,
    device="cuda",
    comb_cache=None,
) -> CombBatchVerifier:
    """(crypto/batch/batch.go:10)  A comb-cached verifier bound to the
    validator set ``pubkeys`` (in set order) on ``device``; the set's
    tables are built on first sight and stay resident in ``comb_cache``
    (default: the process-wide cache)."""
    if not supports_batch_verifier(key_type):
        raise ValueError(f"no batch verifier for key type {key_type!r}")
    dev = resolve_device(device)
    if pubkeys is None:
        raise NotImplementedError(STRAUS_GAP.format(why="no validator-set pubkeys"))
    cache = global_cache() if comb_cache is None else comb_cache
    return CombBatchVerifier(cache.ensure(pubkeys, device=dev))
