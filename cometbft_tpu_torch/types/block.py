"""BlockID, PartSetHeader, CommitSig, Commit and Header (reference:
types/block.go): the part of cometbft_tpu/types/block.py that commit and
light-client verification read, with the header and commit hashes.
Proto decoding stays in the JAX package for now.

Hashing rules follow the reference: Header.Hash is the Merkle root over
the 14 proto-encoded fields, primitives wrapped in gogoproto wrappers
(block.go:446, types/encoding_helper.go:11); Commit.Hash the root over
the proto-encoded CommitSigs (block.go:988).  Both are host hashes.
"""

from __future__ import annotations

from ..crypto import merkle
from ..crypto.hash import SIZE as HASH_SIZE
from ..wire import types as pb
from ..wire.canonical import (
    PRECOMMIT_TYPE,
    CanonicalBlockID,
    CanonicalPartSetHeader,
    Timestamp,
    make_vote_sign_bytes_batch,
)

BLOCK_PROTOCOL_VERSION = 11  # version/version.go BlockProtocol

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

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("negative Total")
        _validate_hash(self.hash)

    def to_proto(self) -> pb.PartSetHeader:
        return pb.PartSetHeader(total=self.total, hash=self.hash)

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

    def validate_basic(self) -> None:
        _validate_hash(self.hash)
        self.part_set_header.validate_basic()

    def key(self) -> bytes:
        return self.hash + self.part_set_header.total.to_bytes(4, "big") + self.part_set_header.hash

    def to_proto(self) -> pb.BlockID:
        return pb.BlockID(hash=self.hash, part_set_header=self.part_set_header.to_proto())

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

    def to_proto(self) -> pb.CommitSig:
        return pb.CommitSig(
            block_id_flag=self.block_id_flag,
            validator_address=self.validator_address,
            timestamp=self.timestamp,
            signature=self.signature,
        )

    def __eq__(self, other):
        return (
            isinstance(other, CommitSig)
            and self.block_id_flag == other.block_id_flag
            and self.validator_address == other.validator_address
            and self.timestamp == other.timestamp
            and self.signature == other.signature
        )


class Commit:
    __slots__ = ("height", "round", "block_id", "signatures", "_hash")

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
        self._hash: bytes | None = None

    def size(self) -> int:
        return len(self.signatures)

    def hash(self) -> bytes:
        """Merkle root over the proto-encoded CommitSigs (block.go:988),
        on the host and memoised."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [cs.to_proto().encode() for cs in self.signatures], device=False
            )
        return self._hash

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            for cs in self.signatures:
                cs.validate_basic()

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


def _validate_hash(h: bytes) -> None:
    if len(h) > 0 and len(h) != HASH_SIZE:
        raise ValueError(f"expected size to be {HASH_SIZE} bytes, got {len(h)}")


def _cdc_encode_bytes(b: bytes) -> bytes:
    """gogotypes.BytesValue wrapper, nil for empty (encoding_helper.go:11)."""
    return pb.BytesValue(value=b).encode() if b else b""


def _cdc_encode_string(s: str) -> bytes:
    return pb.StringValue(value=s).encode() if s else b""


def _cdc_encode_int64(v: int) -> bytes:
    return pb.Int64Value(value=v).encode() if v else b""


class Header:
    """Block header (block.go Header): what the light client checks."""

    FIELDS = (
        "version", "chain_id", "height", "time", "last_block_id",
        "last_commit_hash", "data_hash", "validators_hash",
        "next_validators_hash", "consensus_hash", "app_hash",
        "last_results_hash", "evidence_hash", "proposer_address",
    )
    __slots__ = FIELDS

    def __init__(
        self,
        version: pb.Consensus | None = None,
        chain_id: str = "",
        height: int = 0,
        time: Timestamp | None = None,
        last_block_id: BlockID | None = None,
        last_commit_hash: bytes = b"",
        data_hash: bytes = b"",
        validators_hash: bytes = b"",
        next_validators_hash: bytes = b"",
        consensus_hash: bytes = b"",
        app_hash: bytes = b"",
        last_results_hash: bytes = b"",
        evidence_hash: bytes = b"",
        proposer_address: bytes = b"",
    ):
        self.version = version or pb.Consensus(block=BLOCK_PROTOCOL_VERSION)
        self.chain_id = chain_id
        self.height = height
        self.time = time or ZERO_TIME
        self.last_block_id = last_block_id or BlockID()
        self.last_commit_hash = last_commit_hash
        self.data_hash = data_hash
        self.validators_hash = validators_hash
        self.next_validators_hash = next_validators_hash
        self.consensus_hash = consensus_hash
        self.app_hash = app_hash
        self.last_results_hash = last_results_hash
        self.evidence_hash = evidence_hash
        self.proposer_address = proposer_address

    def hash(self) -> bytes | None:
        """Merkle root of the proto-encoded fields (block.go:446), on the
        host; None while validators_hash is empty (block.go:448)."""
        if not self.validators_hash:
            return None
        return merkle.hash_from_byte_slices(
            [
                self.version.encode(),
                _cdc_encode_string(self.chain_id),
                _cdc_encode_int64(self.height),
                self.time.encode(),
                self.last_block_id.to_proto().encode(),
                _cdc_encode_bytes(self.last_commit_hash),
                _cdc_encode_bytes(self.data_hash),
                _cdc_encode_bytes(self.validators_hash),
                _cdc_encode_bytes(self.next_validators_hash),
                _cdc_encode_bytes(self.consensus_hash),
                _cdc_encode_bytes(self.app_hash),
                _cdc_encode_bytes(self.last_results_hash),
                _cdc_encode_bytes(self.evidence_hash),
                _cdc_encode_bytes(self.proposer_address),
            ],
            device=False,
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if len(self.chain_id) > 50:
            raise ValueError("chain_id too long")
        self.last_block_id.validate_basic()
        for name in (
            "last_commit_hash", "data_hash", "validators_hash",
            "next_validators_hash", "consensus_hash", "last_results_hash",
            "evidence_hash",
        ):
            _validate_hash(getattr(self, name))
        if len(self.proposer_address) > 0 and len(self.proposer_address) != 20:
            raise ValueError("invalid proposer address size")
