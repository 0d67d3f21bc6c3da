"""Batched Merkle proof serving: the data plane of the PROOF class, ported
from cometbft_tpu/models/proof_server.py.

Light-client fan-out is many tiny read-only queries — "prove leaf i of
tree T" — and the device answer is one pass per tree, however many
queries coalesced against it: K7 hashes the leaves, one K8 launch each
level, and one K9 launch gathers every audit path
(crypto/merkle.device_proofs_from_byte_slices).

  - a query is an item triple ``(tree_digest, index_be8, b"")``, the
    shape every batch verifier of the JAX package's verify service takes;
  - trees are registered once in a bounded digest -> leaves LRU and
    referenced by digest; a query against an unknown or evicted digest
    gets a None row (a typed miss), never a wrong proof;
  - rows are crypto/merkle.Proof objects (or None), byte for byte what
    the host oracle proofs_from_byte_slices gives.

CpuProofProver is the host plane; ProofProver (the JAX package's
TpuProofProver) answers a tree on the card once at least
``proof_device_min()`` queries hit it.  The routing knobs read the JAX
package's environment variables with its defaults
(cometbft_tpu/utils/envknobs.py:338-351).  The verify-service front door
(``prove``), its metrics and its tracing spans are not ported.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from collections import OrderedDict

from .. import envknobs
from .._device import resolve_device
from ..crypto import merkle as cmerkle

_INDEX_WIDTH = 8  # query index wire width (big-endian, unsigned)


def proof_device_min() -> int:
    """Fewest coalesced queries against one tree that go to the card
    (COMETBFT_TPU_PROOF_DEVICE_MIN, default 64); fewer are answered on
    the host."""
    return envknobs.get_int("COMETBFT_TPU_PROOF_DEVICE_MIN", 64)


def proof_tree_cache() -> int:
    """Entries of the digest -> leaves tree cache
    (COMETBFT_TPU_PROOF_TREE_CACHE, default 256)."""
    return envknobs.get_int("COMETBFT_TPU_PROOF_TREE_CACHE", 256)


# ------------------------------------------------------------ tree cache


def tree_digest(leaves) -> bytes:
    """SHA-256 over the length-prefixed leaves — the name of a tree by its
    preimage, not its Merkle root, so two leaf lists that share a root
    still cache apart."""
    h = hashlib.sha256()
    h.update(struct.pack("<I", len(leaves)))
    for leaf in leaves:
        h.update(struct.pack("<I", len(leaf)))
        h.update(leaf)
    return h.digest()


class _TreeCache:
    """Bounded LRU of digest -> leaves (proof_tree_cache())."""

    def __init__(self) -> None:
        self._mtx = threading.Lock()
        self._trees: OrderedDict[bytes, tuple[bytes, ...]] = OrderedDict()

    def put(self, leaves) -> bytes:
        d = tree_digest(leaves)
        with self._mtx:
            self._trees[d] = tuple(leaves)
            self._trees.move_to_end(d)
            cap = max(1, proof_tree_cache())
            while len(self._trees) > cap:
                self._trees.popitem(last=False)
        return d

    def get(self, digest: bytes):
        with self._mtx:
            t = self._trees.get(digest)
            if t is not None:
                self._trees.move_to_end(digest)
        return t


_CACHE = _TreeCache()


def register_tree(leaves) -> bytes:
    """Pin a tree (a list of raw leaves) into the cache; returns the digest
    that proof queries name it by."""
    return _CACHE.put(leaves)


def tree_leaves(digest: bytes):
    """The cached leaves for a digest, or None (evicted or unknown)."""
    return _CACHE.get(digest)


# --------------------------------------------------------- query items


def encode_query(digest: bytes, index: int):
    """(tree digest, leaf index) -> the item triple."""
    if len(digest) != 32:
        raise ValueError("tree digest must be 32 bytes")
    if index < 0 or index >= 1 << 63:
        raise ValueError("proof index out of range")
    return (digest, int(index).to_bytes(_INDEX_WIDTH, "big"), b"")


def decode_query(item) -> tuple[bytes, int]:
    """Item triple -> (digest, index); a malformed shape raises ValueError."""
    digest, idx_b, tail = item
    if len(digest) != 32 or len(idx_b) != _INDEX_WIDTH or tail != b"":
        raise ValueError("malformed proof query item")
    return digest, int.from_bytes(idx_b, "big")


def _prove_items(items, device):
    """Group query items by tree digest, answer each tree in one pass,
    scatter the rows back into add() order.  ``device`` False answers on
    the host; otherwise a tree with at least proof_device_min() queries
    is answered by the kernels on ``device``.

    Every row is a crypto/merkle.Proof or None (unknown digest, index out
    of range, malformed item).  Returns (all rows answered, rows)."""
    rows: list = [None] * len(items)
    by_digest: dict[bytes, list[tuple[int, int]]] = {}
    for pos, item in enumerate(items):
        try:
            digest, idx = decode_query(item)
        except (ValueError, TypeError):
            continue  # malformed row -> None
        by_digest.setdefault(digest, []).append((pos, idx))
    for digest, queries in by_digest.items():
        leaves = tree_leaves(digest)
        if leaves is None:
            continue  # typed miss: None rows for every query of this tree
        total = len(leaves)
        good = [(pos, idx) for pos, idx in queries if 0 <= idx < total]
        if not good:
            continue
        idxs = [idx for _, idx in good]
        if device is not False and len(idxs) >= max(1, proof_device_min()):
            _, proofs = cmerkle.device_proofs_from_byte_slices(list(leaves), idxs, device=device)
        else:
            _, all_proofs = cmerkle.proofs_from_byte_slices(list(leaves))
            proofs = [all_proofs[i] for i in idxs]
        for (pos, _), proof in zip(good, proofs):
            rows[pos] = proof
    ok = bool(rows) and all(r is not None for r in rows)
    return ok, rows


class CpuProofProver:
    """Host proof plane: proofs_from_byte_slices per referenced tree — the
    oracle of the device plane."""

    def __init__(self) -> None:
        self._items: list = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        decode_query((pub_key, msg, sig))  # shape-check as the other verifiers do
        self._items.append((pub_key, msg, sig))

    def verify(self):
        return _prove_items(self._items, device=False)


class ProofProver:
    """Device proof plane (the JAX package's TpuProofProver): each tree
    with at least proof_device_min() queries is answered by K7, one K8
    per level and one K9 on ``device``; trees with fewer on the host."""

    def __init__(self, device="cuda") -> None:
        self._dev = resolve_device(device)
        self._items: list = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        decode_query((pub_key, msg, sig))
        self._items.append((pub_key, msg, sig))

    def verify(self):
        if not self._items:
            return False, []
        return _prove_items(self._items, device=self._dev)
