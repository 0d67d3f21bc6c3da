"""Domain types: blocks and their parts, headers, votes, validator sets,
light blocks, consensus params, genesis, transactions and commit
verification."""

from .block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    Block,
    BlockID,
    Commit,
    CommitSig,
    Data,
    ExtendedCommit,
    ExtendedCommitSig,
    Header,
    PartSetHeader,
)
from .genesis import GenesisDoc, GenesisValidator
from .light_block import LightBlock, SignedHeader
from .params import ConsensusParams, default_consensus_params
from .part_set import Part, PartSet
from .tx import tx_hash, tx_proof, txs_hash
from .validators import Validator, ValidatorSet
from .vote import Vote

__all__ = [
    "BLOCK_ID_FLAG_ABSENT",
    "BLOCK_ID_FLAG_COMMIT",
    "BLOCK_ID_FLAG_NIL",
    "Block",
    "BlockID",
    "Commit",
    "CommitSig",
    "ConsensusParams",
    "Data",
    "ExtendedCommit",
    "ExtendedCommitSig",
    "GenesisDoc",
    "GenesisValidator",
    "Header",
    "LightBlock",
    "Part",
    "PartSet",
    "PartSetHeader",
    "SignedHeader",
    "Validator",
    "ValidatorSet",
    "Vote",
    "default_consensus_params",
    "tx_hash",
    "tx_proof",
    "txs_hash",
]
