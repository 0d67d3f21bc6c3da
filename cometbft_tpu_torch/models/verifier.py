"""Batch signature verifiers: the BatchVerifier contract of the reference
(crypto/crypto.go:47-55).  add(pubkey, msg, sig) accumulates work,
verify() returns (all_valid, per_signature_validity) — per-signature
blame is what lets commit verification tally honest voting power even
when some signatures are bad (types/validation.go:384-399).

CpuEd25519BatchVerifier is the host oracle: sequential ZIP-215
verification with the same semantics as the comb kernels
(models/comb_verifier.CombBatchVerifier).
"""

from __future__ import annotations

from typing import Protocol

from ..crypto import ed25519 as host_ed25519


class BatchVerifier(Protocol):
    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None: ...

    def verify(self) -> tuple[bool, list[bool]]: ...


class CpuEd25519BatchVerifier:
    """Sequential ZIP-215 verification on the host."""

    def __init__(self) -> None:
        self._items: list[tuple[bytes, bytes, bytes]] = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        if len(pub_key) != 32 or len(sig) != 64:
            raise ValueError("malformed ed25519 pubkey or signature")
        self._items.append((pub_key, msg, sig))

    def verify(self) -> tuple[bool, list[bool]]:
        res = [host_ed25519.verify_signature(p, m, s) for (p, m, s) in self._items]
        return all(res) and bool(res), res
