"""Evidence of Byzantine behavior (reference: types/evidence.go; a copy of
cometbft_tpu/types/evidence.py without the ABCI records):
DuplicateVoteEvidence (two conflicting votes from one validator) and
LightClientAttackEvidence (a conflicting light block), their proto round
trip, hashes and the evidence list's Merkle root."""

from __future__ import annotations

from ..crypto import hash as tmhash
from ..crypto import merkle
from ..wire import types as pb
from ..wire.canonical import Timestamp
from ..wire.proto import encode_varint
from .block import ZERO_TIME
from .vote import Vote


class Evidence:
    def bytes(self) -> bytes:
        raise NotImplementedError

    def hash(self) -> bytes:
        raise NotImplementedError

    def height(self) -> int:
        raise NotImplementedError

    def time(self) -> Timestamp:
        raise NotImplementedError

    def validate_basic(self) -> None:
        raise NotImplementedError


class DuplicateVoteEvidence(Evidence):
    """Two conflicting votes, same validator/height/round/type
    (evidence.go:35)."""

    def __init__(
        self,
        vote_a: Vote,
        vote_b: Vote,
        total_voting_power: int = 0,
        validator_power: int = 0,
        timestamp: Timestamp | None = None,
    ):
        self.vote_a = vote_a
        self.vote_b = vote_b
        self.total_voting_power = total_voting_power
        self.validator_power = validator_power
        self.timestamp = timestamp or ZERO_TIME

    @classmethod
    def from_votes(cls, vote1: Vote, vote2: Vote, block_time: Timestamp, val_set):
        """Orders votes by BlockID key (evidence.go NewDuplicateVoteEvidence)."""
        if vote1 is None or vote2 is None or val_set is None:
            raise ValueError("missing vote or validator set")
        _, val = val_set.get_by_address(vote1.validator_address)
        if val is None:
            raise ValueError("validator not in validator set")
        if vote1.block_id.key() < vote2.block_id.key():
            a, b = vote1, vote2
        else:
            a, b = vote2, vote1
        return cls(
            vote_a=a,
            vote_b=b,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp=block_time,
        )

    def to_proto(self) -> pb.DuplicateVoteEvidenceProto:
        return pb.DuplicateVoteEvidenceProto(
            vote_a=self.vote_a.to_proto(),
            vote_b=self.vote_b.to_proto(),
            total_voting_power=self.total_voting_power,
            validator_power=self.validator_power,
            timestamp=self.timestamp,
        )

    @classmethod
    def from_proto(cls, m: pb.DuplicateVoteEvidenceProto) -> "DuplicateVoteEvidence":
        if m.vote_a is None or m.vote_b is None:
            raise ValueError("DuplicateVoteEvidence proto missing vote")
        return cls(
            vote_a=Vote.from_proto(m.vote_a),
            vote_b=Vote.from_proto(m.vote_b),
            total_voting_power=m.total_voting_power,
            validator_power=m.validator_power,
            timestamp=m.timestamp or ZERO_TIME,
        )

    def bytes(self) -> bytes:
        return self.to_proto().encode()

    def hash(self) -> bytes:
        return tmhash.sum(self.bytes())

    def height(self) -> int:
        return self.vote_a.height

    def time(self) -> Timestamp:
        return self.timestamp

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("missing vote")
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise ValueError("duplicate votes in invalid order")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()

    def __eq__(self, other):
        return (
            isinstance(other, DuplicateVoteEvidence) and self.bytes() == other.bytes()
        )

    def __repr__(self):
        return f"DuplicateVoteEvidence({self.vote_a!r}, {self.vote_b!r})"


class LightClientAttackEvidence(Evidence):
    """A conflicting light block trace (evidence.go:169)."""

    def __init__(
        self,
        conflicting_block,  # a LightBlock (signed_header + validator_set)
        common_height: int,
        byzantine_validators: list | None = None,
        total_voting_power: int = 0,
        timestamp: Timestamp | None = None,
    ):
        self.conflicting_block = conflicting_block
        self.common_height = common_height
        self.byzantine_validators = byzantine_validators or []
        self.total_voting_power = total_voting_power
        self.timestamp = timestamp or ZERO_TIME

    def bytes(self) -> bytes:
        return self.to_proto().encode()

    def hash(self) -> bytes:
        """31 bytes of the header hash, then the common height's zigzag
        varint (evidence.go:329)."""
        buf = encode_varint(_zigzag64(self.common_height))
        hdr_hash = self.conflicting_block.signed_header.header.hash()
        bz = bytearray(tmhash.SIZE + len(buf))
        bz[: tmhash.SIZE - 1] = hdr_hash[: tmhash.SIZE - 1]
        bz[tmhash.SIZE :] = buf
        return tmhash.sum(bytes(bz))

    def height(self) -> int:
        return self.common_height

    def time(self) -> Timestamp:
        return self.timestamp

    def validate_basic(self) -> None:
        if self.conflicting_block is None:
            raise ValueError("conflicting block is nil")
        if self.common_height <= 0:
            raise ValueError("common height must be positive")

    def conflicting_header_is_invalid(self, trusted_header) -> bool:
        """Lunatic test: a correctly-derived conflicting header agrees with
        the trusted one on every state-derived field (evidence.go:242)."""
        ch = self.conflicting_block.signed_header.header
        return (
            trusted_header.validators_hash != ch.validators_hash
            or trusted_header.next_validators_hash != ch.next_validators_hash
            or trusted_header.consensus_hash != ch.consensus_hash
            or trusted_header.app_hash != ch.app_hash
            or trusted_header.last_results_hash != ch.last_results_hash
        )

    def get_byzantine_validators(self, common_vals, trusted_signed_header) -> list:
        """Who to report to the app (evidence.go:260): lunatic — common-set
        validators who signed the conflicting header; equivocation — those
        who signed both; amnesia — nobody (not attributable here).  Sorted
        by (-power, address)."""
        ch = self.conflicting_block.signed_header
        out = []
        if self.conflicting_header_is_invalid(trusted_signed_header.header):
            for cs in ch.commit.signatures:
                if not cs.for_block():
                    continue
                _, val = common_vals.get_by_address(cs.validator_address)
                if val is not None:
                    out.append(val)
        elif trusted_signed_header.commit.round == ch.commit.round:
            for i, sig_a in enumerate(ch.commit.signatures):
                if not sig_a.for_block():
                    continue
                if i >= len(trusted_signed_header.commit.signatures):
                    continue
                if not trusted_signed_header.commit.signatures[i].for_block():
                    continue
                _, val = self.conflicting_block.validator_set.get_by_address(
                    sig_a.validator_address
                )
                if val is not None:
                    out.append(val)
        out.sort(key=lambda v: (-v.voting_power, v.address))
        return out

    def to_proto(self) -> pb.LightClientAttackEvidenceProto:
        sh = self.conflicting_block.signed_header
        return pb.LightClientAttackEvidenceProto(
            conflicting_block=pb.LightBlockProto(
                signed_header=pb.SignedHeader(
                    header=sh.header.to_proto(), commit=sh.commit.to_proto()
                ),
                validator_set=self.conflicting_block.validator_set.to_proto(),
            ),
            common_height=self.common_height,
            byzantine_validators=[v.to_proto() for v in self.byzantine_validators],
            total_voting_power=self.total_voting_power,
            timestamp=self.timestamp,
        )

    @classmethod
    def from_proto(cls, m: pb.LightClientAttackEvidenceProto):
        from .light_block import LightBlock
        from .validators import Validator

        return cls(
            conflicting_block=LightBlock.from_proto(m.conflicting_block),
            common_height=m.common_height,
            byzantine_validators=[Validator.from_proto(v) for v in m.byzantine_validators],
            total_voting_power=m.total_voting_power,
            timestamp=m.timestamp or ZERO_TIME,
        )

    def __eq__(self, other):
        return (
            isinstance(other, LightClientAttackEvidence)
            and self.bytes() == other.bytes()
        )


def _zigzag64(n: int) -> int:
    """Go binary.PutVarint uses zigzag; evidence hash includes it."""
    return (n << 1) ^ (n >> 63) if n >= 0 else ((-n) << 1) - 1


def evidence_to_proto(ev: Evidence) -> pb.EvidenceProto:
    if isinstance(ev, DuplicateVoteEvidence):
        return pb.EvidenceProto(duplicate_vote_evidence=ev.to_proto())
    if isinstance(ev, LightClientAttackEvidence):
        return pb.EvidenceProto(light_client_attack_evidence=ev.to_proto())
    raise TypeError(f"unknown evidence type {type(ev)}")


def evidence_from_proto(m: pb.EvidenceProto) -> Evidence:
    if m.duplicate_vote_evidence is not None:
        return DuplicateVoteEvidence.from_proto(m.duplicate_vote_evidence)
    if m.light_client_attack_evidence is not None:
        return LightClientAttackEvidence.from_proto(m.light_client_attack_evidence)
    raise ValueError("empty Evidence oneof")


def evidence_list_hash(evidence: list[Evidence]) -> bytes:
    """Merkle over evidence Bytes() (evidence.go:458)."""
    return merkle.hash_from_byte_slices([ev.bytes() for ev in evidence])
