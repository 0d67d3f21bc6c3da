"""Host hashing helpers (reference: crypto/tmhash/hash.go:22-37): the
20-byte truncated SHA-256 that makes validator addresses out of pubkey
bytes (crypto/crypto.go address semantics)."""

from __future__ import annotations

import hashlib

SIZE = 32
TRUNCATED_SIZE = 20


def sum_truncated(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()[:TRUNCATED_SIZE]
