"""Storage: the key-value stores (reference: db/) and the block store
(store/store.go), the port of cometbft_tpu/store/."""

from .block_store import BlockStore
from .db import DB, MemDB, PrefixDB, SQLiteDB, new_db

__all__ = ["BlockStore", "DB", "MemDB", "PrefixDB", "SQLiteDB", "new_db"]
