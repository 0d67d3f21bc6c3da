"""Batched Merkle proof serving: the data plane of the PROOF class, ported
from cometbft_tpu/models/proof_server.py.

Light-client fan-out is many tiny read-only queries — "prove leaf i of
tree T" — and the device answer is one pass per tree, however many
queries coalesced against it: K7 hashes the leaves, one K8 launch the
levels above them, and one K9 launch gathers every audit path
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
``proof_device_min()`` queries hit it; it is the verify service's
MODE_PROOF verifier.  :func:`prove` is the callers' front door: it
registers the tree, submits the queries under PROOF and returns the
root and the proofs in the caller's order.  The routing knobs read the
JAX package's environment variables with its defaults
(cometbft_tpu/utils/envknobs.py:338-351).  Spans (utils/tracing.py, the
JAX names): ``verify.proof.device_dispatch`` / ``verify.proof.host_route``
a tree, ``verify.proof.prove`` a front-door call and
``verify.proof.host_fallback`` its host path.  Metrics (utils/metrics.py,
the JAX names and sites): ``verify_proof_tree_cache_total`` a lookup by
digest, ``verify_proof_queries_total`` the queries answered a route.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from collections import OrderedDict

from .. import envknobs
from .._device import resolve_device
from ..crypto import merkle as cmerkle
from ..utils import tracing
from ..utils.metrics import hub as _metrics_hub

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
        _metrics_hub().verify_proof_tree_cache.inc(result="hit" if t is not None else "miss")
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
    m = _metrics_hub()
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
            with tracing.span(
                "verify.proof.device_dispatch",
                {"queries": len(idxs), "total": total} if tracing.enabled() else None,
            ):
                _, proofs = cmerkle.device_proofs_from_byte_slices(list(leaves), idxs, device=device)
            m.verify_proof_queries.inc(len(idxs), route="device")
        else:
            with tracing.span(
                "verify.proof.host_route", {"queries": len(idxs)} if tracing.enabled() else None
            ):
                _, all_proofs = cmerkle.proofs_from_byte_slices(list(leaves))
                proofs = [all_proofs[i] for i in idxs]
            m.verify_proof_queries.inc(len(idxs), route="host")
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
    for the tree and one K9 on ``device``; trees with fewer on the host.
    submit() answers the batch and returns a ("sync", result) ticket for
    collect(), the verify service's seam (MODE_PROOF): queries that
    coalesced in the PROOF class share one pass per tree."""

    def __init__(self, device="cuda") -> None:
        self._dev = resolve_device(device)
        self._items: list = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        decode_query((pub_key, msg, sig))
        self._items.append((pub_key, msg, sig))

    def submit(self):
        if not self._items:
            return ("sync", (False, []))
        return ("sync", _prove_items(self._items, device=self._dev))

    def collect(self, ticket):
        return ticket[1]

    def verify(self):
        return self.collect(self.submit())


# ------------------------------------------------------------ front door


def prove(leaves, indices, *, tenant: str | None = None, svc=None, device="cuda"):
    """Inclusion proofs for ``indices`` of the tree over ``leaves``
    through the PROOF class of the verify service (``svc``, default the
    global service of ``device``): the queries merge with every other
    caller's into one pass a tree, and come back in this caller's index
    order (cometbft_tpu/models/proof_server.py:237).

    Returns (root, [Proof, ...]).  A refusal (backpressure) or a collect
    past the service's deadline answers on the host, inline: the same
    bytes, since the host oracle defines them.  An index out of range,
    or an empty tree, raises ValueError."""
    from ..verifysvc import service as S

    leaves = list(leaves)
    total = len(leaves)
    if total < 1:
        raise ValueError("cannot prove against an empty tree")
    indices = [int(i) for i in indices]
    for i in indices:
        if i < 0 or i >= total:
            raise ValueError(f"proof index {i} out of range for total {total}")
    digest = register_tree(leaves)
    items = [encode_query(digest, i) for i in indices]
    if svc is None:
        svc = S.global_service(device)
    rows = None
    with tracing.span(
        "verify.proof.prove",
        {"queries": len(indices), "total": total} if tracing.enabled() else None,
    ):
        try:
            ticket = svc.submit(items, S.Klass.PROOF, S.MODE_PROOF, tenant=tenant)
            _, rows = ticket.collect(S.collect_timeout_s())
        except (S.VerifyServiceBackpressure, TimeoutError):
            with tracing.span("verify.proof.host_fallback"):
                _, rows = _prove_items(items, device=False)
    return _assemble(leaves, indices, rows)


def _assemble(leaves, indices, rows):
    """(root, proofs) from a collect's rows; a None row means the tree
    was evicted between register and dispatch, and then every proof is
    made again on the host from the leaves held here (the same bytes)."""
    if rows is None or len(rows) != len(indices) or any(r is None for r in rows):
        root, all_proofs = cmerkle.proofs_from_byte_slices(leaves)
        return root, [all_proofs[i] for i in indices]
    root = rows[0].compute_root_hash() if rows else cmerkle.empty_hash()
    return root, list(rows)
