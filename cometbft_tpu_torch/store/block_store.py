"""BlockStore: persisted blocks as meta + parts + commits, keyed by height
and hash (reference: store/store.go — SaveBlock:587, LoadBlock:222,
LoadBlockCommit:372, LoadSeenCommit:440, PruneBlocks:474; a copy of
cometbft_tpu/store/block_store.py, the same keys and values byte for
byte).

The commit FOR height h is the one block h+1 carries (``C:h``); the top
height has only the seen commit (``SC:h``).  The timed methods observe
the metrics hub's ``store_block_store_access_duration_seconds`` by
method, as the JAX store does.
"""

from __future__ import annotations

import functools
import struct
import threading
import time

from ..types.block import Block, BlockID, Commit, ExtendedCommit
from ..types.part_set import Part, PartSet
from ..utils.metrics import hub as _metrics_hub
from ..wire import types as pb
from .db import DB


def _timed(fn):
    """Store-op latency observer (reference: store metricsgen
    BlockStoreAccessDurationSeconds, labeled by method)."""

    @functools.wraps(fn)
    def wrap(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            _metrics_hub().store_access_seconds.observe(
                time.perf_counter() - t0, method=fn.__name__
            )

    return wrap


_STATE_KEY = b"blockStore"


def _h(prefix: bytes, height: int) -> bytes:
    return prefix + struct.pack(">q", height)


class BlockStore:
    """Thread-safe block store with base/height tracking and pruning."""

    def __init__(self, db: DB):
        self._db = db
        self._mtx = threading.RLock()
        self.base = 0
        self.height = 0
        raw = db.get(_STATE_KEY)
        if raw:
            self.base, self.height = struct.unpack(">qq", raw)

    def _save_state(self) -> list[tuple[bytes, bytes]]:
        return [(_STATE_KEY, struct.pack(">qq", self.base, self.height))]

    def size(self) -> int:
        with self._mtx:
            return self.height - self.base + 1 if self.height else 0

    # ------------------------------------------------------------- save

    @_timed
    def save_block(self, block: Block, part_set: PartSet, seen_commit: Commit) -> None:
        """(store.go:587)."""
        self._save(block, part_set, seen_commit, None)

    @_timed
    def save_block_with_extended_commit(
        self, block: Block, part_set: PartSet, seen_extended_commit: ExtendedCommit
    ) -> None:
        """(store.go:619)."""
        self._save(block, part_set, seen_extended_commit.to_commit(), seen_extended_commit)

    def _save(self, block, part_set, seen_commit, ext_commit):
        height = block.header.height
        with self._mtx:
            if self.height > 0 and height != self.height + 1:
                raise ValueError(
                    f"BlockStore can only save contiguous blocks. Wanted {self.height + 1}, got {height}"
                )
            if not part_set.is_complete():
                raise ValueError("BlockStore can only save complete block part sets")
            block_id = BlockID(hash=block.hash(), part_set_header=part_set.header)
            meta = pb.BlockMeta(
                block_id=block_id.to_proto(),
                block_size=part_set.byte_size,
                header=block.header.to_proto(),
                num_txs=len(block.data.txs),
            )
            sets = [
                (_h(b"H:", height), meta.encode()),
                (b"BH:" + block.hash(), struct.pack(">q", height)),
                (_h(b"SC:", height), seen_commit.to_proto().encode()),
            ]
            for i in range(part_set.header.total):
                part = part_set.get_part(i)
                sets.append((_h(b"P:", height) + struct.pack(">I", i), part.to_proto().encode()))
            if block.last_commit is not None:
                sets.append((_h(b"C:", height - 1), block.last_commit.to_proto().encode()))
            if ext_commit is not None:
                sets.append((_h(b"EC:", height), ext_commit.to_proto().encode()))
            if self.base == 0:
                self.base = height
            self.height = height
            sets += self._save_state()
            self._db.write_batch(sets)

    def save_seen_commit(self, height: int, seen_commit: Commit) -> None:
        self._db.set(_h(b"SC:", height), seen_commit.to_proto().encode())

    def delete_latest_block(self) -> None:
        """Drop the newest block (store.go DeleteLatestBlock; rollback)."""
        with self._mtx:
            height = self.height
            if height == 0:
                raise ValueError("block store is empty")
            meta = self.load_block_meta(height)
            deletes = [_h(b"H:", height), _h(b"SC:", height), _h(b"EC:", height), _h(b"C:", height - 1)]
            if meta is not None and meta.block_id is not None:
                deletes.append(b"BH:" + meta.block_id.hash)
                total = (meta.block_id.part_set_header or pb.PartSetHeader()).total
                for i in range(total):
                    deletes.append(_h(b"P:", height) + struct.pack(">I", i))
            self.height = height - 1
            if self.height < self.base:
                self.base = self.height
            self._db.write_batch(self._save_state(), deletes)

    # ------------------------------------------------------------- load

    def load_block_meta(self, height: int) -> pb.BlockMeta | None:
        raw = self._db.get(_h(b"H:", height))
        return pb.BlockMeta.decode(raw) if raw else None

    @_timed
    def load_block(self, height: int) -> Block | None:
        """Reassemble a block from its parts (store.go:222)."""
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        chunks = []
        total = (meta.block_id.part_set_header or pb.PartSetHeader()).total
        for i in range(total):
            raw = self._db.get(_h(b"P:", height) + struct.pack(">I", i))
            if raw is None:
                return None
            chunks.append(pb.Part.decode(raw).bytes)
        return Block.decode(b"".join(chunks))

    def load_block_by_hash(self, block_hash: bytes) -> Block | None:
        raw = self._db.get(b"BH:" + block_hash)
        if raw is None:
            return None
        return self.load_block(struct.unpack(">q", raw)[0])

    def load_block_part(self, height: int, index: int) -> Part | None:
        raw = self._db.get(_h(b"P:", height) + struct.pack(">I", index))
        return Part.from_proto(pb.Part.decode(raw)) if raw else None

    def load_block_commit(self, height: int) -> Commit | None:
        """The canonical +2/3 commit FOR height (in block height+1's
        LastCommit) (store.go:372)."""
        raw = self._db.get(_h(b"C:", height))
        return Commit.from_proto(pb.Commit.decode(raw)) if raw else None

    def load_seen_commit(self, height: int) -> Commit | None:
        """(store.go:440)."""
        raw = self._db.get(_h(b"SC:", height))
        return Commit.from_proto(pb.Commit.decode(raw)) if raw else None

    def load_block_extended_commit(self, height: int) -> ExtendedCommit | None:
        raw = self._db.get(_h(b"EC:", height))
        return ExtendedCommit.from_proto(pb.ExtendedCommit.decode(raw)) if raw else None

    def load_base_meta(self) -> pb.BlockMeta | None:
        with self._mtx:
            return self.load_block_meta(self.base) if self.base else None

    # ------------------------------------------------------------- prune

    def prune_blocks(self, retain_height: int) -> int:
        """Remove blocks below retain_height (store.go:474)."""
        with self._mtx:
            if retain_height <= self.base:
                return 0
            if retain_height > self.height:
                raise ValueError("cannot prune beyond the latest height")
            pruned = 0
            deletes = []
            for h in range(self.base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                deletes.append(_h(b"H:", h))
                deletes.append(b"BH:" + (meta.block_id.hash if meta.block_id else b""))
                deletes.append(_h(b"SC:", h))
                deletes.append(_h(b"C:", h - 1))
                deletes.append(_h(b"EC:", h))
                total = (meta.block_id.part_set_header or pb.PartSetHeader()).total
                for i in range(total):
                    deletes.append(_h(b"P:", h) + struct.pack(">I", i))
                pruned += 1
            self.base = retain_height
            self._db.write_batch(self._save_state(), deletes)
            return pruned
