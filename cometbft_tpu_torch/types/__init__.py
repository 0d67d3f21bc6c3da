"""Domain types of the commit and light-client paths: blocks, headers,
votes, validator sets, light blocks and commit verification."""

from .block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
)
from .light_block import LightBlock, SignedHeader
from .validators import Validator, ValidatorSet
from .vote import Vote

__all__ = [
    "BLOCK_ID_FLAG_ABSENT",
    "BLOCK_ID_FLAG_COMMIT",
    "BLOCK_ID_FLAG_NIL",
    "BlockID",
    "Commit",
    "CommitSig",
    "Header",
    "LightBlock",
    "PartSetHeader",
    "SignedHeader",
    "Validator",
    "ValidatorSet",
    "Vote",
]
