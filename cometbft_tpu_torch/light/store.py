"""Trusted light-block store (reference: light/store/db/db.go; a copy of
cometbft_tpu/light/store.py).

Heights are stored big-endian so the db's ordered iterators give
first/latest directly; the store only ever holds VERIFIED blocks, as
LightBlockProto bytes, and every read decodes a whole block.
"""

from __future__ import annotations

import struct
import threading

from ..types.light_block import LightBlock
from ..wire import types as pb

_PREFIX = b"lb:"


def _key(height: int) -> bytes:
    return _PREFIX + struct.pack(">q", height)


def _decode(raw: bytes) -> LightBlock:
    return LightBlock.from_proto(pb.LightBlockProto.decode(raw))


class LightStore:
    def __init__(self, db):
        self.db = db
        self._mtx = threading.Lock()

    def save_light_block(self, lb: LightBlock) -> None:
        with self._mtx:
            self.db.set(_key(lb.height), lb.to_proto().encode())

    def light_block(self, height: int) -> LightBlock | None:
        raw = self.db.get(_key(height))
        if raw is None:
            return None
        return _decode(raw)

    def latest_light_block(self) -> LightBlock | None:
        for _, raw in self.db.reverse_iterator(_PREFIX, _PREFIX + b"\xff"):
            return _decode(raw)
        return None

    def first_light_block(self) -> LightBlock | None:
        for _, raw in self.db.iterator(_PREFIX, _PREFIX + b"\xff"):
            return _decode(raw)
        return None

    def latest_height(self) -> int:
        lb = self.latest_light_block()
        return lb.height if lb else 0

    def light_block_before(self, height: int) -> LightBlock | None:
        """Closest verified block strictly below height (db.go)."""
        with self._mtx:
            for _, raw in self.db.reverse_iterator(_PREFIX, _key(height)):
                return _decode(raw)
        return None

    def prune(self, keep: int) -> int:
        """Keep only the newest `keep` blocks (db.go Prune)."""
        if keep <= 0:
            return 0
        with self._mtx:
            keys = [k for k, _ in self.db.iterator(_PREFIX, _PREFIX + b"\xff")]
            excess = len(keys) - keep
            if excess <= 0:
                return 0
            self.db.write_batch([], keys[:excess])
            return excess

    def delete_after(self, height: int) -> int:
        """Drop verified blocks above height (used on reset/rollback)."""
        with self._mtx:
            keys = [
                k
                for k, _ in self.db.iterator(_key(height + 1), _PREFIX + b"\xff")
            ]
            if keys:
                self.db.write_batch([], keys)
            return len(keys)

    def size(self) -> int:
        return sum(1 for _ in self.db.iterator(_PREFIX, _PREFIX + b"\xff"))
