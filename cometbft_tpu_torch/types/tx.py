"""Transactions: hashing and Merkle inclusion proofs (reference:
types/tx.go; a copy of cometbft_tpu/types/tx.py).

``txs_hash`` takes crypto/merkle.hash_from_byte_slices's ``device``: by
default hashlib below 512 txs and K7 + K8 on the card at or above it.
``tx_proof`` stays on the host, as in the JAX package."""

from __future__ import annotations

from ..crypto import hash as tmhash
from ..crypto import merkle


def tx_hash(tx: bytes) -> bytes:
    """SHA-256 of the raw tx bytes (tx.go:29)."""
    return tmhash.sum(tx)


def txs_hash(txs: list[bytes], device=None) -> bytes:
    """Merkle root over per-tx hashes (tx.go:51 — leaves are TxIDs)."""
    return merkle.hash_from_byte_slices([tx_hash(tx) for tx in txs], device=device)


def tx_proof(txs: list[bytes], index: int):
    """(root, Proof) for txs[index] (tx.go:76), on the host."""
    hl = [tx_hash(tx) for tx in txs]
    root, proofs = merkle.proofs_from_byte_slices(hl)
    return root, proofs[index]
