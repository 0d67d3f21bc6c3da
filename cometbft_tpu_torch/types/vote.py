"""Vote domain type (reference: types/vote.go): sign-bytes
canonicalization and the commit signature a vote becomes, as
cometbft_tpu/types/vote.py has them."""

from __future__ import annotations

from ..wire.canonical import Timestamp, vote_sign_bytes
from .block import (
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    ZERO_TIME,
    BlockID,
    CommitSig,
)


class Vote:
    __slots__ = (
        "type", "height", "round", "block_id", "timestamp",
        "validator_address", "validator_index", "signature",
    )

    def __init__(
        self,
        type: int = 0,
        height: int = 0,
        round: int = 0,
        block_id: BlockID | None = None,
        timestamp: Timestamp | None = None,
        validator_address: bytes = b"",
        validator_index: int = 0,
        signature: bytes = b"",
    ):
        self.type = type
        self.height = height
        self.round = round
        self.block_id = block_id or BlockID()
        self.timestamp = timestamp or ZERO_TIME
        self.validator_address = validator_address
        self.validator_index = validator_index
        self.signature = signature

    def is_nil(self) -> bool:
        return self.block_id.is_nil()

    def sign_bytes(self, chain_id: str) -> bytes:
        """Canonical bytes to sign (vote.go VoteSignBytes)."""
        return vote_sign_bytes(
            chain_id,
            self.type,
            self.height,
            self.round,
            self.block_id.to_canonical(),
            self.timestamp,
        )

    def to_commit_sig(self) -> CommitSig:
        flag = BLOCK_ID_FLAG_NIL if self.is_nil() else BLOCK_ID_FLAG_COMMIT
        return CommitSig(
            block_id_flag=flag,
            validator_address=self.validator_address,
            timestamp=self.timestamp,
            signature=self.signature,
        )
