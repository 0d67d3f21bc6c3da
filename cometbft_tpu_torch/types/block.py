"""Block, Data, Header, Commit, ExtendedCommit, BlockID (reference:
types/block.go; a copy of cometbft_tpu/types/block.py), with the hashes
and the proto round trip (to_proto / from_proto) of each.

Hashing rules follow the reference: Header.Hash is the Merkle root over
the 14 proto-encoded fields, primitives wrapped in gogoproto wrappers
(block.go:446, types/encoding_helper.go:11); Commit.Hash the root over
the proto-encoded CommitSigs (block.go:988); both on the host.
Data.Hash is the root over the per-tx SHA-256 hashes (tx.go:51): K7 + K8
on ``device`` for 512 txs or more, as ValidatorSet.hash routes a set.
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

    @classmethod
    def from_proto(cls, m: pb.PartSetHeader) -> "PartSetHeader":
        return cls(total=m.total, hash=m.hash)

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

    def is_complete(self) -> bool:
        return (
            len(self.hash) == HASH_SIZE
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == HASH_SIZE
        )

    def validate_basic(self) -> None:
        _validate_hash(self.hash)
        self.part_set_header.validate_basic()

    def key(self) -> bytes:
        return self.hash + self.part_set_header.total.to_bytes(4, "big") + self.part_set_header.hash

    def to_proto(self) -> pb.BlockID:
        return pb.BlockID(hash=self.hash, part_set_header=self.part_set_header.to_proto())

    @classmethod
    def from_proto(cls, m: pb.BlockID) -> "BlockID":
        psh = m.part_set_header or pb.PartSetHeader()
        return cls(hash=m.hash, part_set_header=PartSetHeader.from_proto(psh))

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

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this sig voted for (block.go CommitSig.BlockID)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        return BlockID()

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

    @classmethod
    def from_proto(cls, m: pb.CommitSig) -> "CommitSig":
        return cls(
            block_id_flag=m.block_id_flag,
            validator_address=m.validator_address,
            timestamp=m.timestamp or ZERO_TIME,
            signature=m.signature,
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

    def get_vote(self, val_idx: int):
        """The precommit Vote of a commit sig (block.go:898)."""
        from .vote import Vote

        cs = self.signatures[val_idx]
        return Vote(
            type=PRECOMMIT_TYPE,
            height=self.height,
            round=self.round,
            block_id=cs.block_id(self.block_id),
            timestamp=cs.timestamp,
            validator_address=cs.validator_address,
            validator_index=val_idx,
            signature=cs.signature,
        )

    def median_time(self, validators) -> Timestamp:
        """Voting-power-weighted median of the commit timestamps — BFT time
        (block.go:968 MedianTime, types/time/time.go:57 WeightedMedian)."""
        weighted = []
        total = 0
        for cs in self.signatures:
            if cs.absent_flag():
                continue
            _, val = validators.get_by_address(cs.validator_address)
            if val is not None:
                total += val.voting_power
                weighted.append((cs.timestamp.unix_ns(), val.voting_power))
        weighted.sort()
        median = total // 2
        for ns, power in weighted:
            if median <= power:
                return Timestamp.from_unix_ns(ns)
            median -= power
        return ZERO_TIME

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

    def to_proto(self) -> pb.Commit:
        return pb.Commit(
            height=self.height,
            round=self.round,
            block_id=self.block_id.to_proto(),
            signatures=[cs.to_proto() for cs in self.signatures],
        )

    @classmethod
    def from_proto(cls, m: pb.Commit) -> "Commit":
        return cls(
            height=m.height,
            round=m.round,
            block_id=BlockID.from_proto(m.block_id or pb.BlockID()),
            signatures=[CommitSig.from_proto(s) for s in m.signatures],
        )

    def __eq__(self, other):
        return (
            isinstance(other, Commit)
            and self.height == other.height
            and self.round == other.round
            and self.block_id == other.block_id
            and self.signatures == other.signatures
        )


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

    def to_proto(self) -> pb.Header:
        return pb.Header(
            version=self.version,
            chain_id=self.chain_id,
            height=self.height,
            time=self.time,
            last_block_id=self.last_block_id.to_proto(),
            last_commit_hash=self.last_commit_hash,
            data_hash=self.data_hash,
            validators_hash=self.validators_hash,
            next_validators_hash=self.next_validators_hash,
            consensus_hash=self.consensus_hash,
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            evidence_hash=self.evidence_hash,
            proposer_address=self.proposer_address,
        )

    @classmethod
    def from_proto(cls, m: pb.Header) -> "Header":
        return cls(
            version=m.version or pb.Consensus(),
            chain_id=m.chain_id,
            height=m.height,
            time=m.time or ZERO_TIME,
            last_block_id=BlockID.from_proto(m.last_block_id or pb.BlockID()),
            last_commit_hash=m.last_commit_hash,
            data_hash=m.data_hash,
            validators_hash=m.validators_hash,
            next_validators_hash=m.next_validators_hash,
            consensus_hash=m.consensus_hash,
            app_hash=m.app_hash,
            last_results_hash=m.last_results_hash,
            evidence_hash=m.evidence_hash,
            proposer_address=m.proposer_address,
        )

    def __eq__(self, other):
        return isinstance(other, Header) and all(
            getattr(self, f) == getattr(other, f) for f in self.FIELDS
        )


class ExtendedCommitSig:
    __slots__ = ("commit_sig", "extension", "extension_signature")

    def __init__(
        self,
        commit_sig: CommitSig | None = None,
        extension: bytes = b"",
        extension_signature: bytes = b"",
    ):
        self.commit_sig = commit_sig or CommitSig.absent()
        self.extension = extension
        self.extension_signature = extension_signature

    def to_proto(self) -> pb.ExtendedCommitSig:
        cs = self.commit_sig
        return pb.ExtendedCommitSig(
            block_id_flag=cs.block_id_flag,
            validator_address=cs.validator_address,
            timestamp=cs.timestamp,
            signature=cs.signature,
            extension=self.extension,
            extension_signature=self.extension_signature,
        )

    @classmethod
    def from_proto(cls, m: pb.ExtendedCommitSig) -> "ExtendedCommitSig":
        return cls(
            commit_sig=CommitSig(
                block_id_flag=m.block_id_flag,
                validator_address=m.validator_address,
                timestamp=m.timestamp or ZERO_TIME,
                signature=m.signature,
            ),
            extension=m.extension,
            extension_signature=m.extension_signature,
        )

    def __eq__(self, other):
        return (
            isinstance(other, ExtendedCommitSig)
            and self.commit_sig == other.commit_sig
            and self.extension == other.extension
            and self.extension_signature == other.extension_signature
        )


class ExtendedCommit:
    __slots__ = ("height", "round", "block_id", "extended_signatures")

    def __init__(
        self,
        height: int = 0,
        round: int = 0,
        block_id: BlockID | None = None,
        extended_signatures: list[ExtendedCommitSig] | None = None,
    ):
        self.height = height
        self.round = round
        self.block_id = block_id or BlockID()
        self.extended_signatures = extended_signatures or []

    def to_commit(self) -> Commit:
        return Commit(
            height=self.height,
            round=self.round,
            block_id=self.block_id,
            signatures=[ecs.commit_sig for ecs in self.extended_signatures],
        )

    def ensure_extensions(self, ext_enabled: bool) -> None:
        """Check extension-signature presence is consistent with the flag
        (block.go:1173 EnsureExtensions / :791 EnsureExtension)."""
        for ecs in self.extended_signatures:
            flag = ecs.commit_sig.block_id_flag
            if ext_enabled:
                if flag == BLOCK_ID_FLAG_COMMIT and not ecs.extension_signature:
                    raise ValueError(
                        "vote extension signature missing for validator "
                        + ecs.commit_sig.validator_address.hex()
                    )
                if flag != BLOCK_ID_FLAG_COMMIT and (
                    ecs.extension or ecs.extension_signature
                ):
                    raise ValueError("non-commit vote has extension data")
            elif ecs.extension or ecs.extension_signature:
                raise ValueError(
                    "vote extension present but extensions are disabled"
                )

    def to_proto(self) -> pb.ExtendedCommit:
        return pb.ExtendedCommit(
            height=self.height,
            round=self.round,
            block_id=self.block_id.to_proto(),
            extended_signatures=[s.to_proto() for s in self.extended_signatures],
        )

    @classmethod
    def from_proto(cls, m: pb.ExtendedCommit) -> "ExtendedCommit":
        return cls(
            height=m.height,
            round=m.round,
            block_id=BlockID.from_proto(m.block_id or pb.BlockID()),
            extended_signatures=[
                ExtendedCommitSig.from_proto(s) for s in m.extended_signatures
            ],
        )


class Data:
    __slots__ = ("txs", "_hash")

    def __init__(self, txs: list[bytes] | None = None):
        self.txs = txs or []
        self._hash: bytes | None = None

    def hash(self, device="cuda") -> bytes:
        """Root over the per-tx hashes, memoised: K7 + K8 on ``device`` for
        crypto/merkle.DEVICE_THRESHOLD txs or more, hashlib below."""
        from .tx import txs_hash

        if self._hash is None:
            route = device if len(self.txs) >= merkle.DEVICE_THRESHOLD else False
            self._hash = txs_hash(self.txs, device=route)
        return self._hash

    def to_proto(self) -> pb.Data:
        return pb.Data(txs=list(self.txs))

    @classmethod
    def from_proto(cls, m: pb.Data) -> "Data":
        return cls(txs=list(m.txs))


class Block:
    __slots__ = ("header", "data", "evidence", "last_commit")

    def __init__(
        self,
        header: Header | None = None,
        data: Data | None = None,
        evidence: list | None = None,
        last_commit: Commit | None = None,
    ):
        self.header = header or Header()
        self.data = data or Data()
        self.evidence = evidence or []
        self.last_commit = last_commit

    def hash(self) -> bytes | None:
        return self.header.hash()

    def fill_header(self, device="cuda") -> None:
        """Populate derived header hashes (block.go fillHeader)."""
        if not self.header.last_commit_hash and self.last_commit is not None:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash(device)
        if not self.header.evidence_hash:
            self.header.evidence_hash = self.evidence_hash()

    def evidence_hash(self) -> bytes:
        from .evidence import evidence_list_hash

        return evidence_list_hash(self.evidence)

    def validate_basic(self, device="cuda") -> None:
        self.header.validate_basic()
        if self.last_commit is not None:
            self.last_commit.validate_basic()
            if self.header.last_commit_hash != self.last_commit.hash():
                raise ValueError("wrong LastCommitHash")
        elif self.header.height > 1:
            raise ValueError("nil LastCommit at height > 1")
        if self.header.data_hash != self.data.hash(device):
            raise ValueError("wrong DataHash")
        if self.header.evidence_hash != self.evidence_hash():
            raise ValueError("wrong EvidenceHash")

    def to_proto(self) -> pb.BlockProto:
        from .evidence import evidence_to_proto

        return pb.BlockProto(
            header=self.header.to_proto(),
            data=self.data.to_proto(),
            evidence=pb.EvidenceListProto(
                evidence=[evidence_to_proto(e) for e in self.evidence]
            ),
            last_commit=self.last_commit.to_proto() if self.last_commit else None,
        )

    @classmethod
    def from_proto(cls, m: pb.BlockProto) -> "Block":
        from .evidence import evidence_from_proto

        ev = []
        if m.evidence is not None:
            ev = [evidence_from_proto(e) for e in m.evidence.evidence]
        return cls(
            header=Header.from_proto(m.header or pb.Header()),
            data=Data.from_proto(m.data or pb.Data()),
            evidence=ev,
            last_commit=Commit.from_proto(m.last_commit) if m.last_commit else None,
        )

    def encode(self) -> bytes:
        return self.to_proto().encode()

    @classmethod
    def decode(cls, buf: bytes) -> "Block":
        return cls.from_proto(pb.BlockProto.decode(buf))

    def make_part_set(self, part_size: int = 65536):
        from .part_set import PartSet

        return PartSet.from_data(self.encode(), part_size)
