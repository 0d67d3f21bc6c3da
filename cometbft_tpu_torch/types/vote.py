"""Vote domain type (reference: types/vote.go): sign-bytes
canonicalization, single verification (vote.go:247 Verify), the basic
checks, the commit signature a vote becomes and the proto round trip,
as cometbft_tpu/types/vote.py has them."""

from __future__ import annotations

from ..wire import types as pb
from ..wire.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE, Timestamp, vote_sign_bytes
from .block import (
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    ZERO_TIME,
    BlockID,
    CommitSig,
)


class VoteError(Exception):
    pass


def is_vote_type_valid(t: int) -> bool:
    return t in (PREVOTE_TYPE, PRECOMMIT_TYPE)


class Vote:
    __slots__ = (
        "type", "height", "round", "block_id", "timestamp",
        "validator_address", "validator_index", "signature",
        "extension", "extension_signature",
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
        extension: bytes = b"",
        extension_signature: bytes = b"",
    ):
        self.type = type
        self.height = height
        self.round = round
        self.block_id = block_id or BlockID()
        self.timestamp = timestamp or ZERO_TIME
        self.validator_address = validator_address
        self.validator_index = validator_index
        self.signature = signature
        self.extension = extension
        self.extension_signature = extension_signature

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

    def verify(self, chain_id: str, pub_key) -> None:
        """Verify the vote signature on the host (vote.go:247)."""
        if pub_key.address() != self.validator_address:
            raise VoteError("invalid validator address")
        if not pub_key.verify_signature(self.sign_bytes(chain_id), self.signature):
            raise VoteError("invalid signature")

    def validate_basic(self) -> None:
        if not is_vote_type_valid(self.type):
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        self.block_id.validate_basic()
        if not self.block_id.is_nil() and not self.block_id.is_complete():
            raise ValueError(f"blockID must be either empty or complete, got {self.block_id}")
        if len(self.validator_address) != 20:
            raise ValueError("expected ValidatorAddress size to be 20 bytes")
        if self.validator_index < 0:
            raise ValueError("negative ValidatorIndex")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 256:
            raise ValueError("signature is too big")
        if self.type != PRECOMMIT_TYPE or self.is_nil():
            if self.extension:
                raise ValueError("unexpected vote extension")
            if self.extension_signature:
                raise ValueError("unexpected extension signature")

    def to_commit_sig(self) -> CommitSig:
        flag = BLOCK_ID_FLAG_NIL if self.is_nil() else BLOCK_ID_FLAG_COMMIT
        return CommitSig(
            block_id_flag=flag,
            validator_address=self.validator_address,
            timestamp=self.timestamp,
            signature=self.signature,
        )

    def to_proto(self) -> pb.Vote:
        return pb.Vote(
            type=self.type,
            height=self.height,
            round=self.round,
            block_id=self.block_id.to_proto(),
            timestamp=self.timestamp,
            validator_address=self.validator_address,
            validator_index=self.validator_index,
            signature=self.signature,
            extension=self.extension,
            extension_signature=self.extension_signature,
        )

    @classmethod
    def from_proto(cls, m: pb.Vote) -> "Vote":
        return cls(
            type=m.type,
            height=m.height,
            round=m.round,
            block_id=BlockID.from_proto(m.block_id or pb.BlockID()),
            timestamp=m.timestamp or ZERO_TIME,
            validator_address=m.validator_address,
            validator_index=m.validator_index,
            signature=m.signature,
            extension=m.extension,
            extension_signature=m.extension_signature,
        )

    def __eq__(self, other):
        return isinstance(other, Vote) and self.to_proto().encode() == other.to_proto().encode()

    def __repr__(self):
        kind = {PREVOTE_TYPE: "prevote", PRECOMMIT_TYPE: "precommit"}.get(
            self.type, f"type{self.type}"
        )
        tgt = "nil" if self.is_nil() else self.block_id.hash.hex()[:12]
        return f"Vote({kind} h={self.height} r={self.round} -> {tgt} by {self.validator_address.hex()[:12]})"
