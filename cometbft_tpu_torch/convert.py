"""State carried across from the JAX package, and back to canonical bytes.

Chain state (validator sets, signed headers) comes across from plain
values — bytes, ints and tuples read off the JAX objects by the caller —
so that both packages are fed the same chain without the port importing
the JAX package.  Light blocks and evidence come across as the proto
bytes the JAX package's ``to_proto().encode()`` writes, decoded by the
port's own codec.  Merkle leaves need nothing: both take lists of bytes.

The secp lane (slice 4): the JAX package keeps 256-bit values as (B, 22)
int32 12-bit limbs and its G window table as (16, 66) Jacobian
Montgomery limbs (R = 2^264); the port keeps (B, 8) int32 words and a
(2, 8, 2, 8) affine table of G and phi(G) (ops/secp256k1.py).

The BLS lane (slice 5): the JAX package keeps a field element as (B, 32)
int32 12-bit limbs of its Montgomery form with R = 2^384; the port keeps
(B, 12) int32 words of the same number (ops/bls381.py), so the two carry
across by a bit repack (``bls_words_from_jax_limbs`` and its inverse).

The JAX package keeps comb tables as (64, 9, 3, 22, V) int32 frozen
12-bit limbs (entry 0 is the identity), the B table as (22, 66, 4096)
float32 limbs for its MXU one-hot select, and the Straus B window as
(16, 3, 22) int32 limbs.  The port keeps all three as canonical
little-endian u32 words (ops/comb.py, ops/ed25519.py).  Parity between
the two is checked on the canonical 32-byte encodings these helpers
produce.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .crypto import bls12381, ed25519, secp256k1, secp256k1eth
from .models.comb_verifier import _CacheEntry
from .ops import bls381 as bls
from .ops import comb
from .ops import secp256k1 as secp
from .types import block as B
from .types import evidence as Ev
from .types.light_block import LightBlock, SignedHeader
from .types.validators import Validator, ValidatorSet
from .wire import types as pb
from .wire.canonical import Timestamp
from .wire.types import Consensus

_JAX_LIMBS, _JAX_BITS = 22, 12


def _jax_limbs_to_bytes(limbs: np.ndarray) -> np.ndarray:
    """(..., 22) frozen 12-bit limbs -> (..., 32) uint8 LE encodings."""
    limbs = np.asarray(limbs).astype(np.int64)
    bits = (limbs[..., None] >> np.arange(_JAX_BITS)) & 1  # (..., 22, 12)
    bits = bits.reshape(limbs.shape[:-1] + (_JAX_LIMBS * _JAX_BITS,))[..., :256]
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")


def _bytes_to_words(b: np.ndarray) -> np.ndarray:
    """(..., 32) uint8 LE -> (..., 8) uint32 words."""
    return np.ascontiguousarray(b).view("<u4").astype(np.uint32)


def jax_a_tables_to_canonical(tables: np.ndarray) -> np.ndarray:
    """JAX (64, 9, 3, 22, V) int32 -> (V, 64, 8, 3, 32) uint8: entries
    1..8 of every position as canonical encodings (entry 0, the identity,
    is implicit in the port)."""
    t = np.asarray(tables)[:, 1:]  # (64, 8, 3, 22, V)
    t = np.moveaxis(t, -1, 0)  # (V, 64, 8, 3, 22)
    return _jax_limbs_to_bytes(t)


def a_tables_to_canonical(tables) -> np.ndarray:
    """Port (V, 64, 8, 3, 8) int32 words -> (V, 64, 8, 3, 32) uint8."""
    t = tables.cpu().numpy() if isinstance(tables, torch.Tensor) else np.asarray(tables)
    return np.ascontiguousarray(t).view(np.uint8)


def jax_b_tables_to_canonical(b_tables: np.ndarray) -> np.ndarray:
    """JAX (22, 66, 4096) float32 -> (22, 4096, 3, 32) uint8."""
    b = np.asarray(b_tables).astype(np.int64)  # exact: limbs < 2^12
    b = b.reshape(b.shape[0], 3, _JAX_LIMBS, b.shape[-1])  # (22, 3, 22, 4096)
    return _jax_limbs_to_bytes(np.moveaxis(b, -1, 1))  # (22, 4096, 3, 32)


def b_tables_to_canonical(b_tab) -> np.ndarray:
    """Port (22, 4096, 3, 8) int32 words -> (22, 4096, 3, 32) uint8."""
    t = b_tab.cpu().numpy() if isinstance(b_tab, torch.Tensor) else np.asarray(b_tab)
    return np.ascontiguousarray(t).view(np.uint8)


def b_tables_from_jax(b_tables: np.ndarray, device="cuda") -> torch.Tensor:
    """JAX (22, 66, 4096) float32 B table -> the port's (22, 4096, 3, 8)
    int32 words on ``device``."""
    dev = resolve_device(device)
    words = _bytes_to_words(jax_b_tables_to_canonical(b_tables))
    return torch.from_numpy(words.view(np.int32).copy()).to(dev)


def b_window_from_jax(b_window: np.ndarray, device="cuda") -> torch.Tensor:
    """JAX (16, 3, 22) int32 B-window table (ops/ed25519._B_WINDOW: entry
    j is j * B in Niels limbs) -> the port's (16, 3, 8) int32 words on
    ``device`` (ops/ed25519.b_window)."""
    dev = resolve_device(device)
    words = _bytes_to_words(_jax_limbs_to_bytes(b_window))
    return torch.from_numpy(words.view(np.int32).copy()).to(dev)


def tables_from_jax(tables, valid, pubs, device="cuda", b_tables=None, mesh=None) -> _CacheEntry:
    """The JAX cache entry's arrays — tables (64, 9, 3, 22, V) int32,
    valid (V,) bool, pubs (V, 32) uint8 — as the port's cache entry on
    ``device``, ready for models.comb_verifier.CombBatchVerifier.
    ``b_tables`` is the port's B table (built on the host when None).

    With a ``mesh`` (parallel.Mesh) the entry is this rank's lane slice,
    on the mesh's device: the lanes are first padded to a multiple of
    8 * size with copies of lane 0, as the port's cache pads them (the
    JAX cache pads a mesh entry to the mesh size only, also with the
    first key).  Row indices are the first lane of each key."""
    dev = resolve_device(device) if mesh is None else mesh.device
    words = _bytes_to_words(jax_a_tables_to_canonical(tables))  # (V, 64, 8, 3, 8)
    valid = np.asarray(valid, dtype=bool)
    pubs = np.ascontiguousarray(np.asarray(pubs, dtype=np.uint8))
    index: dict[bytes, int] = {}
    for i in range(pubs.shape[0]):
        index.setdefault(pubs[i].tobytes(), i)
    if mesh is not None:
        lanes = np.arange(-(-pubs.shape[0] // (8 * mesh.size)) * 8 * mesh.size)
        lanes = np.where(lanes < pubs.shape[0], lanes, 0)
        per = lanes.shape[0] // mesh.size
        mine = lanes[mesh.rank * per : (mesh.rank + 1) * per]
        words, valid, pubs = words[mine], valid[mine], pubs[mine]
    return _CacheEntry(
        torch.from_numpy(np.ascontiguousarray(words).view(np.int32).copy()).to(dev),
        torch.from_numpy(valid.copy()).to(dev),
        torch.from_numpy(pubs.copy()).to(dev),
        comb.b_tables(dev) if b_tables is None else b_tables,
        index,
        mesh,
    )


def _jax_limbs_to_ints(limbs: np.ndarray) -> list[int]:
    """(B, L) 12-bit limbs (least significant first) -> ints."""
    out = []
    for row in np.asarray(limbs).astype(np.int64):
        val = 0
        for limb in row[::-1].tolist():
            val = (val << _JAX_BITS) + int(limb)
        out.append(val)
    return out


def words_from_jax_limbs(limbs: np.ndarray) -> np.ndarray:
    """JAX (B, 22) int32 plain 12-bit limbs (cometbft_tpu/ops/secp256k1.py
    ints_to_limbs_np; values < 2^256) -> the port's (B, 8) int32 words."""
    return secp.ints_to_words_np(_jax_limbs_to_ints(limbs))


def bls_words_from_jax_limbs(limbs: np.ndarray) -> np.ndarray:
    """JAX (..., 32) int32 12-bit limbs (cometbft_tpu/ops/bls381.py; the
    Montgomery form, R = 2^384) -> the port's (..., 12) int32 words of
    the same number."""
    a = np.asarray(limbs).astype(np.int64)
    w = np.zeros(a.shape[:-1] + (bls.NWORDS,), dtype=np.int64)
    for k in range(32):
        bit = 12 * k
        w[..., bit // 32] |= (a[..., k] << (bit % 32)) & 0xFFFFFFFF
        if bit % 32 > 20:  # the limb straddles two words
            w[..., bit // 32 + 1] |= a[..., k] >> (32 - bit % 32)
    return w.astype(np.uint32).view(np.int32)


def jax_limbs_from_bls_words(words) -> np.ndarray:
    """The inverse of bls_words_from_jax_limbs: (..., 12) int32 words ->
    (..., 32) int32 12-bit limbs."""
    w = np.asarray(words.cpu() if isinstance(words, torch.Tensor) else words).astype(np.int64) & 0xFFFFFFFF
    out = np.zeros(w.shape[:-1] + (32,), dtype=np.int64)
    for k in range(32):
        bit = 12 * k
        v = w[..., bit // 32] >> (bit % 32)
        if bit % 32 > 20:
            v = v | (w[..., bit // 32 + 1] << (32 - bit % 32))
        out[..., k] = v & 0xFFF
    return out.astype(np.int32)


def g_table_from_jax(g_table: np.ndarray, device="cuda") -> torch.Tensor:
    """JAX (16, 66) int32 G window table (entry j = j G as Jacobian
    Montgomery limbs, R = 2^264) -> the port's (2, 8, 2, 8) int32 table of
    [G, phi(G)][j = 1..8][x, y] affine words on ``device``."""
    dev = resolve_device(device)
    p = secp.P
    rinv = pow(1 << (_JAX_LIMBS * _JAX_BITS), p - 2, p)
    g = np.asarray(g_table)
    out = np.zeros((2, 8, 2, 8), dtype=np.uint32)
    for j in range(1, 9):
        X, Y, Z = (v * rinv % p for v in _jax_limbs_to_ints(g[j].reshape(3, _JAX_LIMBS)))
        zi = pow(Z, p - 2, p)
        x, y = X * zi * zi % p, Y * zi * zi * zi % p
        for t, xv in enumerate((x, secp.BETA * x % p)):
            out[t, j - 1, 0] = secp.ints_to_words_np([xv])[0].view(np.uint32)
            out[t, j - 1, 1] = secp.ints_to_words_np([y])[0].view(np.uint32)
    return torch.from_numpy(out.view(np.int32).copy()).to(dev)


# ------------------------------------------------------------ chain state


_PUBKEYS = {
    ed25519.KEY_TYPE: ed25519.PubKey,
    secp256k1.KEY_TYPE: secp256k1.PubKey,
    secp256k1eth.KEY_TYPE: secp256k1eth.PubKey,
    bls12381.KEY_TYPE: bls12381.PubKey,
}


def validator_set(entries, key_type: str = ed25519.KEY_TYPE) -> ValidatorSet:
    """[(pubkey bytes, voting power), ...] of one key type -> the port's
    ValidatorSet (sorted as the reference sorts it)."""
    return ValidatorSet([Validator(_PUBKEYS[key_type](bytes(pk)), int(p)) for pk, p in entries])


def block_id(fields) -> B.BlockID:
    """(hash, part-set total, part-set hash) -> BlockID."""
    h, total, psh = fields
    return B.BlockID(hash=bytes(h), part_set_header=B.PartSetHeader(int(total), bytes(psh)))


def header(fields: dict) -> B.Header:
    """A header's fields as plain values -> Header.  ``version`` is
    (block, app), ``time`` (seconds, nanos), ``last_block_id`` as for
    block_id(); the other fields are str, int or bytes, under the names
    of Header.FIELDS."""
    f = dict(fields)
    blk, app = f.pop("version")
    sec, ns = f.pop("time")
    return B.Header(
        version=Consensus(block=int(blk), app=int(app)),
        time=Timestamp(seconds=int(sec), nanos=int(ns)),
        last_block_id=block_id(f.pop("last_block_id")),
        **f,
    )


def commit(height: int, round_: int, bid, sigs) -> B.Commit:
    """A commit from plain values: ``bid`` as for block_id(), ``sigs`` a
    list of (flag, validator address, (seconds, nanos), signature)."""
    return B.Commit(
        height=int(height), round=int(round_), block_id=block_id(bid),
        signatures=[
            B.CommitSig(int(flag), bytes(addr), Timestamp(seconds=int(t[0]), nanos=int(t[1])), bytes(sig))
            for flag, addr, t, sig in sigs
        ],
    )


def signed_header(header_fields: dict, commit_fields) -> SignedHeader:
    """header() and commit() of the given values -> SignedHeader;
    ``commit_fields`` is (height, round, bid, sigs)."""
    return SignedHeader(header(header_fields), commit(*commit_fields))


def light_block(raw: bytes) -> LightBlock:
    """A LightBlockProto's bytes (the JAX LightBlock's
    ``to_proto().encode()``) -> the port's LightBlock."""
    return LightBlock.from_proto(pb.LightBlockProto.decode(raw))


def evidence(raw: bytes) -> Ev.Evidence:
    """An EvidenceProto's bytes (the JAX ``evidence_to_proto(ev).encode()``,
    the form a block's evidence list carries) -> the port's evidence."""
    return Ev.evidence_from_proto(pb.EvidenceProto.decode(raw))
