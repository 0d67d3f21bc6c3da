"""Domain types of the commit path: blocks, votes, validator sets and
commit verification."""

from .block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID,
    Commit,
    CommitSig,
    PartSetHeader,
)
from .validators import Validator, ValidatorSet
from .vote import Vote

__all__ = [
    "BLOCK_ID_FLAG_ABSENT",
    "BLOCK_ID_FLAG_COMMIT",
    "BLOCK_ID_FLAG_NIL",
    "BlockID",
    "Commit",
    "CommitSig",
    "PartSetHeader",
    "Validator",
    "ValidatorSet",
    "Vote",
]
