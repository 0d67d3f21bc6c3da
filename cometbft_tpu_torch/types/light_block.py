"""SignedHeader and LightBlock (reference: types/light_block.go; a copy
of cometbft_tpu/types/light_block.py without the proto round trip)."""

from __future__ import annotations

from .block import Commit, Header
from .validators import ValidatorSet


class SignedHeader:
    __slots__ = ("header", "commit")

    def __init__(self, header: Header, commit: Commit):
        self.header = header
        self.commit = commit

    def validate_basic(self, chain_id: str) -> None:
        if self.header is None:
            raise ValueError("missing header")
        if self.commit is None:
            raise ValueError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header belongs to another chain {self.header.chain_id!r}, not {chain_id!r}"
            )
        if self.commit.height != self.header.height:
            raise ValueError("header and commit height mismatch")
        if self.commit.block_id.hash != self.header.hash():
            raise ValueError("commit signs block failing to match header")


class LightBlock:
    __slots__ = ("signed_header", "validator_set")

    def __init__(self, signed_header: SignedHeader, validator_set: ValidatorSet):
        self.signed_header = signed_header
        self.validator_set = validator_set

    @property
    def height(self) -> int:
        return self.signed_header.header.height

    @property
    def time(self):
        return self.signed_header.header.time

    @property
    def hash(self) -> bytes:
        return self.signed_header.header.hash()

    def validate_basic(self, chain_id: str, device="cuda") -> None:
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        if self.signed_header.header.validators_hash != self.validator_set.hash(device):
            raise ValueError("validator set does not match header validators hash")
