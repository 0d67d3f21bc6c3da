"""Key-value stores (reference: db/): the databases the light client's
trusted store sits on.  The block and state stores come later."""

from .db import DB, MemDB, PrefixDB, SQLiteDB, new_db

__all__ = ["DB", "MemDB", "PrefixDB", "SQLiteDB", "new_db"]
