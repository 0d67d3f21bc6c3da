"""State carried across from the JAX package, and back to canonical bytes.

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
from .models.comb_verifier import _CacheEntry
from .ops import comb

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


def tables_from_jax(tables, valid, pubs, device="cuda", b_tables=None) -> _CacheEntry:
    """The JAX cache entry's arrays — tables (64, 9, 3, 22, V) int32,
    valid (V,) bool, pubs (V, 32) uint8 — as the port's cache entry on
    ``device``, ready for models.comb_verifier.CombBatchVerifier.
    ``b_tables`` is the port's B table (built on the host when None)."""
    dev = resolve_device(device)
    words = _bytes_to_words(jax_a_tables_to_canonical(tables))  # (V, 64, 8, 3, 8)
    pubs = np.ascontiguousarray(np.asarray(pubs, dtype=np.uint8))
    index = {pubs[i].tobytes(): i for i in range(pubs.shape[0])}
    return _CacheEntry(
        torch.from_numpy(words.view(np.int32).copy()).to(dev),
        torch.from_numpy(np.asarray(valid, dtype=bool).copy()).to(dev),
        torch.from_numpy(pubs.copy()).to(dev),
        comb.b_tables(dev) if b_tables is None else b_tables,
        index,
    )
