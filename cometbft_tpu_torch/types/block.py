"""BlockID, PartSetHeader, CommitSig and Commit (reference: types/block.go):
the part of cometbft_tpu/types/block.py that commit verification reads.
Hashing and proto round trips stay in the JAX package for now.
"""

from __future__ import annotations

from ..wire.canonical import (
    PRECOMMIT_TYPE,
    CanonicalBlockID,
    CanonicalPartSetHeader,
    Timestamp,
    make_vote_sign_bytes_batch,
)

# BlockIDFlag enum (types.proto BLOCK_ID_FLAG_*)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3

# Go's zero time.Time marshals to this (year 1, UTC).
ZERO_TIME = Timestamp(seconds=-62135596800, nanos=0)


class PartSetHeader:
    __slots__ = ("total", "hash")

    def __init__(self, total: int = 0, hash: bytes = b""):
        self.total = total
        self.hash = hash

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def __eq__(self, other):
        return (
            isinstance(other, PartSetHeader)
            and self.total == other.total
            and self.hash == other.hash
        )

    def __repr__(self):
        return f"PartSetHeader(total={self.total}, hash={self.hash.hex()[:12]})"


class BlockID:
    __slots__ = ("hash", "part_set_header")

    def __init__(self, hash: bytes = b"", part_set_header: PartSetHeader | None = None):
        self.hash = hash
        self.part_set_header = part_set_header or PartSetHeader()

    def is_nil(self) -> bool:
        """True when this is the zero/nil BlockID (a nil vote)."""
        return len(self.hash) == 0 and self.part_set_header.is_zero()

    def key(self) -> bytes:
        return self.hash + self.part_set_header.total.to_bytes(4, "big") + self.part_set_header.hash

    def to_canonical(self) -> CanonicalBlockID | None:
        """nil BlockIDs canonicalize to an omitted field (canonical.go)."""
        if self.is_nil():
            return None
        return CanonicalBlockID(
            hash=self.hash,
            part_set_header=CanonicalPartSetHeader(
                total=self.part_set_header.total, hash=self.part_set_header.hash
            ),
        )

    def __eq__(self, other):
        return (
            isinstance(other, BlockID)
            and self.hash == other.hash
            and self.part_set_header == other.part_set_header
        )

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"BlockID({self.hash.hex()[:12]}:{self.part_set_header.total})"


class CommitSig:
    __slots__ = ("block_id_flag", "validator_address", "timestamp", "signature")

    def __init__(
        self,
        block_id_flag: int = BLOCK_ID_FLAG_ABSENT,
        validator_address: bytes = b"",
        timestamp: Timestamp | None = None,
        signature: bytes = b"",
    ):
        self.block_id_flag = block_id_flag
        self.validator_address = validator_address
        self.timestamp = timestamp or ZERO_TIME
        self.signature = signature

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls(block_id_flag=BLOCK_ID_FLAG_ABSENT)

    def for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def absent_flag(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def validate_basic(self) -> None:
        if self.block_id_flag not in (
            BLOCK_ID_FLAG_ABSENT,
            BLOCK_ID_FLAG_COMMIT,
            BLOCK_ID_FLAG_NIL,
        ):
            raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address:
                raise ValueError("validator address is present for absent CommitSig")
            if self.signature:
                raise ValueError("signature is present for absent CommitSig")
        else:
            if len(self.validator_address) != 20:
                raise ValueError("expected ValidatorAddress size to be 20 bytes")
            if not self.signature:
                raise ValueError("signature is missing")
            if len(self.signature) > 256:
                raise ValueError("signature is too big")

    def __eq__(self, other):
        return (
            isinstance(other, CommitSig)
            and self.block_id_flag == other.block_id_flag
            and self.validator_address == other.validator_address
            and self.timestamp == other.timestamp
            and self.signature == other.signature
        )


class Commit:
    __slots__ = ("height", "round", "block_id", "signatures")

    def __init__(
        self,
        height: int = 0,
        round: int = 0,
        block_id: BlockID | None = None,
        signatures: list[CommitSig] | None = None,
    ):
        self.height = height
        self.round = round
        self.block_id = block_id or BlockID()
        self.signatures = signatures or []

    def size(self) -> int:
        return len(self.signatures)

    def vote_sign_bytes_fn(self, chain_id: str):
        """idx -> sign bytes, with the per-flag canonical prefixes encoded
        once — the batch-assembly fast path for a whole commit."""
        for_block = make_vote_sign_bytes_batch(
            chain_id, PRECOMMIT_TYPE, self.height, self.round,
            self.block_id.to_canonical(),
        )
        for_nil = make_vote_sign_bytes_batch(
            chain_id, PRECOMMIT_TYPE, self.height, self.round, None,
        )

        def fn(val_idx: int) -> bytes:
            cs = self.signatures[val_idx]
            maker = for_block if cs.for_block() else for_nil
            return maker(cs.timestamp)

        return fn
