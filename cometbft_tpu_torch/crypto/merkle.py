"""RFC-6962 Merkle tree: hashing, inclusion proofs, proof operators — the
port's own copy of cometbft_tpu/crypto/merkle.py (reference:
crypto/merkle/tree.go, proof.go, proof_op.go, proof_key_path.go).

The host half (hashlib) is as in the JAX package.  The device routes run
on the card through ops/merkle.py: K7 hashes the leaves, one K8 launch
hashes each level, and K9 gathers proof nodes.

``device`` on the routes that may take either (hash_from_byte_slices):

  - ``False``: the host route (hashlib), whatever the size;
  - ``None`` (the default): the host route below ``DEVICE_THRESHOLD``
    leaves, the kernel route on ``"cuda"`` at or above it — which raises
    ``NoCudaDevice`` where there is no card;
  - ``"cuda"`` / ``"cpu"`` (or a torch.device; ``True`` means ``"cuda"``):
    the kernel route on that device; ``"cpu"`` runs the kernels' plain
    PyTorch versions.

A build or launch failure of K7-K9 raises: no route falls back to
another on its own.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..ops import merkle as M

_LEAF_PREFIX = b"\x00"
_INNER_PREFIX = b"\x01"

# Below this leaf count the host route takes the tree (a handful of
# hashlib calls beat a dispatch); at or above it the kernels do
# (cometbft_tpu/crypto/merkle.py:25).
DEVICE_THRESHOLD = 512


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def empty_hash() -> bytes:
    """Root of the empty tree: SHA-256 of the empty string (hash.go:14)."""
    return _sha256(b"")


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(_LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(_INNER_PREFIX + left + right)


def get_split_point(length: int) -> int:
    """Largest power of two strictly less than length (tree.go:101)."""
    if length < 1:
        raise ValueError("trying to split tree with length < 1")
    return 1 << (length - 1).bit_length() - 1 if length > 1 else 0


def _root_from_leaf_hashes_host(hashes: list[bytes]) -> bytes:
    nodes = hashes
    while len(nodes) > 1:
        nxt = [inner_hash(nodes[i], nodes[i + 1]) for i in range(0, len(nodes) - 1, 2)]
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return nodes[0]


def kernel_device(n: int, device) -> torch.device | None:
    """The device of the kernel route for a tree of n leaves, or None for
    the host route (the ``device`` convention of the module docstring)."""
    if device is False:
        return None
    if device is None:
        if n < DEVICE_THRESHOLD:
            return None
        device = "cuda"
    if device is True:
        device = "cuda"
    return resolve_device(device)


def hash_from_byte_slices(items: list[bytes], device=None) -> bytes:
    """RFC-6962 root of a list of raw leaves (tree.go:11-27)."""
    n = len(items)
    if n == 0:
        return empty_hash()
    dev = kernel_device(n, device)
    if dev is None:
        return _root_from_leaf_hashes_host([leaf_hash(i) for i in items])
    blocks, active, _ = M.stage_leaves(items, dev)
    return bytes(M.root_from_leaves(blocks, active).cpu().numpy())


@dataclass
class Proof:
    """Inclusion proof for item `index` of `total` (proof.go Proof)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes] = field(default_factory=list)

    def compute_root_hash(self) -> bytes | None:
        return _compute_hash_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)

    def verify(self, root_hash: bytes, leaf: bytes) -> None:
        if self.total < 0:
            raise ValueError("proof total must be positive")
        if self.index < 0:
            raise ValueError("proof index cannot be negative")
        if leaf_hash(leaf) != self.leaf_hash:
            raise ValueError("invalid leaf hash")
        computed = self.compute_root_hash()
        if computed != root_hash:
            raise ValueError(
                f"invalid root hash: wanted {root_hash.hex()} got "
                f"{computed.hex() if computed else None}"
            )


def _compute_hash_from_aunts(index: int, total: int, leaf: bytes, aunts: list[bytes]) -> bytes | None:
    """Recursive root recomputation (proof.go computeHashFromAunts)."""
    if index >= total or index < 0 or total <= 0:
        return None
    if total == 1:
        if aunts:
            return None
        return leaf
    if not aunts:
        return None
    split = get_split_point(total)
    if index < split:
        left = _compute_hash_from_aunts(index, split, leaf, aunts[:-1])
        if left is None:
            return None
        return inner_hash(left, aunts[-1])
    right = _compute_hash_from_aunts(index - split, total - split, leaf, aunts[:-1])
    if right is None:
        return None
    return inner_hash(aunts[-1], right)


class _Node:
    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent = None
        self.left = None
        self.right = None

    def flatten_aunts(self) -> list[bytes]:
        out = []
        node = self
        while node is not None:
            parent = node.parent
            if parent is not None:
                sibling = parent.right if parent.left is node else parent.left
                if sibling is not None:
                    out.append(sibling.hash)
            node = parent
        return out


def _trails_from_leaf_hashes(hashes: list[bytes]):
    if not hashes:
        return [], None
    if len(hashes) == 1:
        node = _Node(hashes[0])
        return [node], node
    split = get_split_point(len(hashes))
    lefts, left_root = _trails_from_leaf_hashes(hashes[:split])
    rights, right_root = _trails_from_leaf_hashes(hashes[split:])
    root = _Node(inner_hash(left_root.hash, right_root.hash))
    root.left, root.right = left_root, right_root
    left_root.parent = right_root.parent = root
    return lefts + rights, root


def proofs_from_byte_slices(items: list[bytes]) -> tuple[bytes, list[Proof]]:
    """Root + one inclusion proof per item, on the host
    (proof.go ProofsFromByteSlices): the oracle of the device routes."""
    hashes = [leaf_hash(i) for i in items]
    trails, root = _trails_from_leaf_hashes(hashes)
    root_hash = root.hash if root else empty_hash()
    proofs = [
        Proof(total=len(items), index=i, leaf_hash=t.hash, aunts=t.flatten_aunts())
        for i, t in enumerate(trails)
    ]
    return root_hash, proofs


# ------------------------------------------------- batched device proofs
#
# Under the level-by-level view the aunt of a query at level l is its
# pair sibling (position ^ 1), unless that falls off the level (the
# query's ancestor is the promoted odd node): then the level gives no
# aunt, exactly as _Node.flatten_aunts emits none.


def _plan_array(total: int, indices) -> np.ndarray:
    """(K,) indices -> (K, D) int64 sibling positions, -1 for no aunt."""
    if total < 1:
        raise ValueError("proof plan needs a non-empty tree")
    idx = np.asarray([int(i) for i in indices], dtype=np.int64)
    bad = (idx < 0) | (idx >= total)
    if bad.any():
        raise ValueError(f"proof index {int(idx[bad][0])} out of range for total {total}")
    sizes = M.level_sizes(total)
    sib = np.empty((idx.shape[0], len(sizes)), dtype=np.int64)
    for lvl, sz in enumerate(sizes):
        s = (idx >> lvl) ^ 1
        sib[:, lvl] = np.where(s < sz, s, -1)
    return sib


def proof_plan(total: int, indices: list[int]) -> tuple[int, list[list[int]]]:
    """Per-level sibling positions for each queried index: (depth, sib),
    sib[k][l] the position within level l of query k's aunt, or -1 when
    that level's odd trailing node was promoted through.  Aunt order is
    leaf-to-root, the order Proof.aunts stores."""
    sib = _plan_array(total, indices)
    return sib.shape[1], sib.tolist()


def multiproof_plan(total: int, indices: list[int]) -> tuple[int, list[list[int]], list[int], int]:
    """Dedup plan for a multiproof: (depth, sib, coords, naive_slots) —
    coords the sorted, deduplicated flat coordinates (level 0 first) of
    every queried leaf hash and every aunt; naive_slots what K separate
    proofs would gather (the dedup factor's numerator)."""
    sib = _plan_array(total, indices)
    coords = M.proof_coords(total, [int(i) for i in indices], sib)
    live = coords[coords >= 0]
    return sib.shape[1], sib.tolist(), np.unique(live).tolist(), int(live.size)


def _proofs_from_rows(total: int, indices, sib: np.ndarray, rows: np.ndarray) -> list[Proof]:
    """Proofs from gathered rows (K, D + 1, 32) uint8: the leaf hash, then
    each level's aunt (kept where sib >= 0).  The rows become 32-byte
    bytes objects in one numpy call (a void view keeps trailing zeros)."""
    cells = np.ascontiguousarray(rows).view("V32").reshape(rows.shape[:2]).tolist()
    live = sib >= 0
    full = live.all(axis=1).tolist()
    live = live.tolist()
    return [
        Proof(
            total=total, index=int(idx), leaf_hash=row[0],
            aunts=row[1:] if all_live else [a for a, keep in zip(row[1:], keep_l) if keep],
        )
        for idx, row, all_live, keep_l in zip(indices, cells, full, live)
    ]


def device_proofs_from_byte_slices(items: list[bytes], indices: list[int], device="cuda"):
    """Inclusion proofs for the queried indices through the kernels on
    ``device``: K7, one K8 per level, then ONE K9 launch gathering every
    leaf hash and audit node (ops/merkle ``nodes_from_leaves``).  Returns
    (root, [Proof, ...]), byte for byte what proofs_from_byte_slices
    gives."""
    dev = resolve_device(device)
    total = len(items)
    indices = [int(i) for i in indices]
    sib = _plan_array(total, indices)
    coords = M.proof_coords(total, indices, sib)
    blocks, active, c = M.stage_leaves(items, dev, extra=coords)
    root, rows = M.nodes_from_leaves(blocks, active, c)
    return bytes(root.cpu().numpy()), _proofs_from_rows(total, indices, sib, rows.cpu().numpy())


def device_multiproof(items: list[bytes], indices: list[int], device="cuda"):
    """Many indices against one tree with every shared node gathered once
    (ops/merkle ``nodes_from_leaves``): K7, one K8 per level, one K9
    over the deduplicated coordinates; the per-query Proofs are put back
    together on the host.  Returns (root, proofs, dedup factor = naive
    gather slots / unique nodes)."""
    dev = resolve_device(device)
    total = len(items)
    indices = [int(i) for i in indices]
    sib = _plan_array(total, indices)
    coords = M.proof_coords(total, indices, sib)
    live = coords >= 0
    uniq, inverse = np.unique(coords[live], return_inverse=True)
    blocks, active, c = M.stage_leaves(items, dev, extra=uniq.astype(np.int32))
    root, nodes = M.nodes_from_leaves(blocks, active, c)
    root = bytes(root.cpu().numpy())
    node_np = nodes.cpu().numpy()
    # spread the unique nodes back over each query's (leaf, aunts) slots
    rows = np.zeros(coords.shape + (32,), dtype=np.uint8)
    rows[live] = node_np[inverse.reshape(-1)]
    proofs = _proofs_from_rows(total, indices, sib, rows)
    dedup = float(live.sum()) / float(uniq.size) if uniq.size else 1.0
    return root, proofs, dedup


# ------------------------------------------------------- proof operators


class ProofOp:
    """A single step in a multi-store proof chain (proof_op.go)."""

    op_type: str = ""

    def run(self, values: list[bytes]) -> list[bytes]:
        raise NotImplementedError

    def get_key(self) -> bytes:
        raise NotImplementedError


class ValueOp(ProofOp):
    """Leaf op: proves key=value inclusion under a root (proof_value.go)."""

    op_type = "simple:v"

    def __init__(self, key: bytes, proof: Proof):
        self.key = key
        self.proof = proof

    def get_key(self) -> bytes:
        return self.key

    def run(self, values: list[bytes]) -> list[bytes]:
        if len(values) != 1:
            raise ValueError("value op expects one value")
        vhash = _sha256(values[0])
        if leaf_hash(self.key + vhash) != self.proof.leaf_hash:
            raise ValueError("leaf hash mismatch")
        root = self.proof.compute_root_hash()
        if root is None:
            raise ValueError("could not compute root")
        return [root]


class ProofOperators:
    """A chain of ProofOps verified innermost-first (proof_op.go:47)."""

    def __init__(self, ops: list[ProofOp]):
        self.ops = ops

    def verify_value(self, root: bytes, keypath: str, value: bytes) -> None:
        self.verify(root, keypath, [value])

    def verify(self, root: bytes, keypath: str, args: list[bytes]) -> None:
        keys = _parse_key_path(keypath)
        for op in self.ops:
            key = op.get_key()
            if key:
                if not keys:
                    raise ValueError(f"key path exhausted before op key {key!r}")
                if keys[-1] != key:
                    raise ValueError(f"key mismatch: {keys[-1]!r} != {key!r}")
                keys = keys[:-1]
            args = op.run(args)
        if args[0] != root:
            raise ValueError("calculated root does not match provided root")
        if keys:
            raise ValueError("keypath not fully consumed")


def key_path_to_string(keys: list[bytes]) -> str:
    """URL-ish key path encoding (proof_key_path.go KeyPath)."""
    out = []
    for k in keys:
        try:
            s = k.decode("utf-8")
            if s.isprintable() and "/" not in s:
                out.append(s)
                continue
        except UnicodeDecodeError:
            pass
        out.append("x:" + k.hex())
    return "/" + "/".join(out)


def _parse_key_path(path: str) -> list[bytes]:
    if not path.startswith("/"):
        raise ValueError("key path must start with /")
    keys = []
    for part in path.split("/")[1:]:
        if not part:
            continue
        if part.startswith("x:"):
            keys.append(bytes.fromhex(part[2:]))
        else:
            keys.append(part.encode("utf-8"))
    return keys
