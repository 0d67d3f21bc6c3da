"""RFC-6962 Merkle trees on the card: leaf hashing (K7), one launch of K8
per tree level, and node gathers (K9) for inclusion proofs and
multiproofs — the port of cometbft_tpu/ops/merkle.py.

Kernels (CUDA C++ in csrc/merkle.cu):

  K7 ``sha256_blocks`` (ops/sha2.py)  replaces cometbft_tpu/ops/sha2.py:81
  K8 ``merkle_level``                 replaces cometbft_tpu/ops/merkle.py:47
     (with _inner_blocks, :38)
  K9 ``merkle_gather``                replaces cometbft_tpu/ops/merkle.py:117

The reference's split at the largest power of two below n
(crypto/merkle/tree.go:101) is a level-by-level reduction in which an odd
trailing node is promoted unchanged.  Every level lives in ONE flat
(nodes, 32) uint8 tensor, level 0 (the leaf hashes) first, at the
offsets of crypto/merkle.multiproof_plan: K7 writes level 0, K8 level
l + 1 from level l in place, and the root is the last row.  Proofs and
multiproofs gather from that tensor by flat coordinate (-1 where a level
gives no aunt), so they need no separate level storage; the JAX package
gathered level by level with an f32 one-hot MXU matmul, a TPU workaround.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor; ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from . import sha2

LAUNCHES = {"merkle_level": 0, "merkle_gather": 0}

LEAF_PREFIX = b"\x00"

# SHA-256 padding after the 65-byte inner message 0x01 || L || R:
# 0x80, zeros, the bit length 520 as 8 big-endian bytes.
_INNER_TAIL = np.zeros(63, dtype=np.uint8)
_INNER_TAIL[0] = 0x80
_INNER_TAIL[-8:] = np.frombuffer((65 * 8).to_bytes(8, "big"), dtype=np.uint8)


def level_sizes(total: int) -> list[int]:
    """Sizes of the levels below the root: [n, ceil(n/2), ..., 2]
    (cometbft_tpu/crypto/merkle.py:213 _level_sizes)."""
    sizes = []
    n = total
    while n > 1:
        sizes.append(n)
        n = (n + 1) // 2
    return sizes


def level_offsets(total: int) -> list[int]:
    """Row offset of every level in the flat node tensor, the root's
    last: len(level_sizes(total)) + 1 entries."""
    offsets = [0]
    for sz in level_sizes(total):
        offsets.append(offsets[-1] + sz)
    return offsets


def pad_leaves(leaves: list[bytes], out: np.ndarray | None = None):
    """Host: raw leaves -> (blocks (n, nb, 64) uint8, active (n,) int32)
    with the 0x00 leaf prefix (cometbft_tpu/ops/merkle.py:79)."""
    return sha2.pad_messages_sha256(leaves, prefix=LEAF_PREFIX, out=out)


def stage_leaves(leaves: list[bytes], device: torch.device, extra: np.ndarray | None = None):
    """Pad the leaves straight into one host buffer — page-locked when
    ``device`` is a card — laid out as blocks | active | extra (an int32
    array riding along, e.g. gather coordinates), and make ONE copy of it
    to ``device``.  Returns (blocks, active, extra) as views of the
    device copy (extra is None when none was given)."""
    n = len(leaves)
    longest = max((len(x) for x in leaves), default=0) + len(LEAF_PREFIX)
    nb = max(1, (longest + 9 + 63) // 64)
    nbytes = [n * nb * 64, n * 4, 0 if extra is None else extra.size * 4]
    offs = np.cumsum([0] + nbytes).tolist()
    host = torch.zeros((offs[-1],), dtype=torch.uint8, pin_memory=device.type == "cuda")
    hb = host.numpy()
    _, active = pad_leaves(leaves, out=hb[offs[0] : offs[1]])
    hb[offs[1] : offs[2]] = active.view(np.uint8)
    if extra is not None:
        hb[offs[2] : offs[3]] = np.ascontiguousarray(extra, dtype=np.int32).view(np.uint8).reshape(-1)
    flat = host.to(device, non_blocking=True) if device.type == "cuda" else host
    blocks = flat[offs[0] : offs[1]].view(n, nb, 64)
    act = flat[offs[1] : offs[2]].view(torch.int32)
    ext = None if extra is None else flat[offs[2] : offs[3]].view(torch.int32).view(extra.shape)
    return blocks, act, ext


# ------------------------------------------------------------------ K8


def _check_level(flat: torch.Tensor, in_off: int, n: int, out_off: int) -> None:
    if flat.dtype != torch.uint8 or flat.dim() != 2 or flat.shape[1] != 32:
        raise ValueError("flat must be (nodes, 32) uint8")
    m = (n + 1) // 2
    if n < 1 or in_off < 0 or out_off < 0 or in_off + n > flat.shape[0] or out_off + m > flat.shape[0]:
        raise ValueError(f"level ({in_off}, {n}) -> {out_off} outside {flat.shape[0]} nodes")
    if out_off < in_off + n and in_off < out_off + m:
        raise ValueError("a level's output overlaps its input")


def merkle_level_plain(flat: torch.Tensor, in_off: int, n: int, out_off: int) -> None:
    """Plain version of K8, in place: level of n nodes at in_off -> its
    parent level at out_off (the odd trailing node promoted)."""
    pairs = n // 2
    if pairs:
        left = flat[in_off : in_off + 2 * pairs : 2]
        right = flat[in_off + 1 : in_off + 2 * pairs : 2]
        head = torch.ones((pairs, 1), dtype=torch.uint8, device=flat.device)
        tail = torch.from_numpy(_INNER_TAIL).to(flat.device).expand(pairs, 63)
        blocks = torch.cat([head, left, right, tail], dim=1).reshape(pairs, 2, 64)
        active = torch.full((pairs,), 2, dtype=torch.int32, device=flat.device)
        flat[out_off : out_off + pairs] = sha2.sha256_blocks_plain(blocks, active)
    if n % 2:
        flat[out_off + pairs] = flat[in_off + n - 1]


def merkle_level(flat: torch.Tensor, in_off: int, n: int, out_off: int) -> None:
    """Hash one tree level in place in the flat node tensor: K8 on a CUDA
    tensor, the plain version on a CPU tensor."""
    _check_level(flat, in_off, n, out_off)
    if flat.device.type == "cpu":
        return merkle_level_plain(flat, in_off, n, out_off)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    if not flat.is_contiguous() or flat.data_ptr() % 4:
        raise ValueError("flat must be contiguous and 4-byte aligned: K8 writes it in place")
    code = _build.lib("merkle").k8_merkle_level(
        flat.data_ptr(), in_off, n, out_off, torch.cuda.current_stream(flat.device).cuda_stream
    )
    _build.check(code, "k8_merkle_level")
    LAUNCHES["merkle_level"] += 1


def all_levels(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Host-padded leaves -> the flat (nodes, 32) tensor of every level:
    K7 writes the leaf hashes into level 0, then one K8 per level."""
    sha2._check_sha256_args(blocks, active)
    n = blocks.shape[0]
    if n < 1:
        raise ValueError("a tree needs at least one leaf")
    offsets = level_offsets(n)
    flat = torch.empty((offsets[-1] + 1, 32), dtype=torch.uint8, device=blocks.device)
    if blocks.device.type == "cuda":
        sha2.launch_k7(blocks.contiguous(), active.to(torch.int32).contiguous(), flat)
    else:
        flat[:n] = sha2.sha256_blocks(blocks, active)
    for lvl, sz in enumerate(level_sizes(n)):
        merkle_level(flat, offsets[lvl], sz, offsets[lvl + 1])
    return flat


def root_from_leaves(blocks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Host-padded leaves -> (32,) uint8 RFC-6962 root (manifest kernel
    ``merkle_root_from_leaves``, cometbft_tpu/ops/merkle.py:85)."""
    return all_levels(blocks, active)[-1]


# ------------------------------------------------------------------ K9


def merkle_gather_plain(flat: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: (K,) coordinates -> (K, 32) rows, zero rows
    where the coordinate is -1 (or outside the tensor)."""
    ok = (coord >= 0) & (coord < flat.shape[0])
    rows = flat[torch.where(ok, coord, 0).to(torch.int64)]
    return torch.where(ok[:, None], rows, torch.zeros_like(rows))


def merkle_gather(flat: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """out[k] = flat[coord[k]], 32 zero bytes where coord[k] == -1: K9 on
    CUDA tensors, the plain version on CPU tensors.  Any shape of int32
    coordinates; the result has that shape plus (32,)."""
    if flat.dtype != torch.uint8 or flat.dim() != 2 or flat.shape[1] != 32:
        raise ValueError("flat must be (nodes, 32) uint8")
    if coord.dtype != torch.int32 or coord.device != flat.device:
        raise ValueError("coord must be int32 on flat's device")
    shape = tuple(coord.shape) + (32,)
    coord = coord.reshape(-1)
    if flat.device.type == "cpu":
        return merkle_gather_plain(flat, coord).reshape(shape)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    flat, coord = flat.contiguous(), coord.contiguous()
    if flat.data_ptr() % 16:
        flat = flat.clone()
    out = torch.empty((coord.shape[0], 32), dtype=torch.uint8, device=flat.device)
    launch_k9(flat, coord, out)
    return out.reshape(shape)


def launch_k9(flat, coord, out) -> None:
    """K9 into a preallocated (K, 32) output on the current stream."""
    if flat.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("K9 moves 16-byte vectors: flat and out must be 16-byte aligned")
    code = _build.lib("merkle").k9_merkle_gather(
        flat.data_ptr(), coord.data_ptr(), out.data_ptr(), coord.shape[0], flat.shape[0],
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    _build.check(code, "k9_merkle_gather")
    LAUNCHES["merkle_gather"] += 1


# ------------------------------------------------------------- proofs


def proof_coords(total: int, indices, sib_pos) -> np.ndarray:
    """Host: (K,) leaf indices and (K, D) per-level sibling positions (-1 =
    no aunt; crypto/merkle.proof_plan) -> (K, D + 1) int32 flat
    coordinates: the leaf first, then each level's aunt or -1."""
    idx = np.asarray(indices, dtype=np.int64).reshape(-1, 1)
    sib = np.asarray(sib_pos, dtype=np.int64).reshape(idx.shape[0], -1)
    offs = np.asarray(level_offsets(total)[: sib.shape[1]], dtype=np.int64)
    aunts = np.where(sib >= 0, sib + offs[None, :], -1)
    return np.concatenate([idx, aunts], axis=1).astype(np.int32)


def nodes_from_leaves(blocks: torch.Tensor, active: torch.Tensor, coords: torch.Tensor):
    """Host-padded leaves and flat coordinates (any shape, int32, on the
    leaves' device; -1 = no node) -> (root (32,), nodes (coords.shape +
    (32,)) uint8): the tree's levels, then ONE K9 launch.  Manifest
    kernels ``merkle_proofs_from_leaves`` (cometbft_tpu/ops/merkle.py:133;
    coordinates from proof_coords) and ``merkle_multiproof_from_leaves``
    (:157; the deduplicated coordinates of a multiproof plan)."""
    flat = all_levels(blocks, active)
    return flat[-1], merkle_gather(flat, coords)
