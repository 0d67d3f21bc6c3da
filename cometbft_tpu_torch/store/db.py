"""KV database abstraction (reference: db/db.go:24 — Get/Set/Delete/
Iterator/ReverseIterator/Batch/Close, plus prefixdb namespacing
db/prefixdb.go); a copy of cometbft_tpu/store/db.py, the light client's
trusted store sits on it.

Backends:
  MemDB    — sorted in-memory dict (reference NewInMem, used by tests and
             statesync temp state).
  SQLiteDB — persistent single-file store (stands in for the reference's
             pebble LSM; swap-in point for the C++ engine).
  PrefixDB — key-namespace view over another DB.
"""

from __future__ import annotations

import bisect
import sqlite3
import threading
from typing import Iterator


class DB:
    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def iterator(self, start: bytes | None = None, end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        """Ascending iteration over [start, end)."""
        raise NotImplementedError

    def reverse_iterator(self, start: bytes | None = None, end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        """Descending iteration over [start, end)."""
        raise NotImplementedError

    def write_batch(self, sets: list[tuple[bytes, bytes]], deletes: list[bytes] = ()) -> None:
        """Atomic batch write (db.go Batch)."""
        raise NotImplementedError

    def close(self) -> None: ...

    def compact(self) -> None: ...


class MemDB(DB):
    def __init__(self):
        self._d: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []
        self._mtx = threading.RLock()

    def get(self, key: bytes) -> bytes | None:
        with self._mtx:
            return self._d.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        if key is None or value is None:
            raise ValueError("nil key or value")
        with self._mtx:
            if key not in self._d:
                bisect.insort(self._keys, key)
            self._d[key] = value

    def delete(self, key: bytes) -> None:
        with self._mtx:
            if key in self._d:
                del self._d[key]
                i = bisect.bisect_left(self._keys, key)
                del self._keys[i]

    def _range(self, start, end):
        lo = bisect.bisect_left(self._keys, start) if start is not None else 0
        hi = bisect.bisect_left(self._keys, end) if end is not None else len(self._keys)
        return lo, hi

    def iterator(self, start=None, end=None):
        with self._mtx:
            lo, hi = self._range(start, end)
            snapshot = [(k, self._d[k]) for k in self._keys[lo:hi]]
        yield from snapshot

    def reverse_iterator(self, start=None, end=None):
        with self._mtx:
            lo, hi = self._range(start, end)
            snapshot = [(k, self._d[k]) for k in reversed(self._keys[lo:hi])]
        yield from snapshot

    def write_batch(self, sets, deletes=()):
        with self._mtx:
            for k, v in sets:
                self.set(k, v)
            for k in deletes:
                self.delete(k)


class SQLiteDB(DB):
    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._mtx = threading.RLock()
        with self._mtx:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
            )
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.commit()

    def get(self, key: bytes) -> bytes | None:
        with self._mtx:
            row = self._conn.execute("SELECT v FROM kv WHERE k=?", (key,)).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        with self._mtx:
            self._conn.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                (key, value),
            )
            self._conn.commit()

    def delete(self, key: bytes) -> None:
        with self._mtx:
            self._conn.execute("DELETE FROM kv WHERE k=?", (key,))
            self._conn.commit()

    def _bounds(self, start, end, desc=False):
        cond, args = [], []
        if start is not None:
            cond.append("k >= ?")
            args.append(start)
        if end is not None:
            cond.append("k < ?")
            args.append(end)
        where = (" WHERE " + " AND ".join(cond)) if cond else ""
        order = " ORDER BY k DESC" if desc else " ORDER BY k ASC"
        return f"SELECT k, v FROM kv{where}{order}", args

    def iterator(self, start=None, end=None):
        q, args = self._bounds(start, end)
        with self._mtx:
            rows = self._conn.execute(q, args).fetchall()
        yield from ((bytes(k), bytes(v)) for k, v in rows)

    def reverse_iterator(self, start=None, end=None):
        q, args = self._bounds(start, end, desc=True)
        with self._mtx:
            rows = self._conn.execute(q, args).fetchall()
        yield from ((bytes(k), bytes(v)) for k, v in rows)

    def write_batch(self, sets, deletes=()):
        with self._mtx:
            self._conn.executemany(
                "INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                list(sets),
            )
            if deletes:
                self._conn.executemany("DELETE FROM kv WHERE k=?", [(k,) for k in deletes])
            self._conn.commit()

    def close(self) -> None:
        with self._mtx:
            self._conn.close()

    def compact(self) -> None:
        with self._mtx:
            self._conn.execute("VACUUM")
            self._conn.commit()


def _prefix_end(prefix: bytes) -> bytes | None:
    """Smallest byte string greater than every key with this prefix."""
    b = bytearray(prefix)
    for i in reversed(range(len(b))):
        if b[i] != 0xFF:
            b[i] += 1
            return bytes(b[: i + 1])
    return None


class PrefixDB(DB):
    """Namespaced view (db/prefixdb.go)."""

    def __init__(self, db: DB, prefix: bytes):
        self._db = db
        self._prefix = prefix

    def _k(self, key: bytes) -> bytes:
        return self._prefix + key

    def get(self, key):
        return self._db.get(self._k(key))

    def set(self, key, value):
        self._db.set(self._k(key), value)

    def delete(self, key):
        self._db.delete(self._k(key))

    def _strip(self, it):
        n = len(self._prefix)
        for k, v in it:
            yield k[n:], v

    def iterator(self, start=None, end=None):
        s = self._k(start) if start is not None else self._prefix
        e = self._k(end) if end is not None else _prefix_end(self._prefix)
        return self._strip(self._db.iterator(s, e))

    def reverse_iterator(self, start=None, end=None):
        s = self._k(start) if start is not None else self._prefix
        e = self._k(end) if end is not None else _prefix_end(self._prefix)
        return self._strip(self._db.reverse_iterator(s, e))

    def write_batch(self, sets, deletes=()):
        self._db.write_batch(
            [(self._k(k), v) for k, v in sets], [self._k(k) for k in deletes]
        )


def new_db(name: str, backend: str = "sqlite", db_dir: str = ".") -> DB:
    """DBProvider (reference config/db.go:30)."""
    if backend in ("mem", "memdb"):
        return MemDB()
    if backend == "sqlite":
        import os

        os.makedirs(db_dir, exist_ok=True)
        return SQLiteDB(os.path.join(db_dir, f"{name}.db"))
    raise ValueError(f"unknown db backend {backend!r}")
