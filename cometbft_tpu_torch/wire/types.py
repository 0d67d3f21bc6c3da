"""Domain proto messages: headers, commits, validator sets, light
blocks, evidence, blocks and their parts, the stores' block metas and
the consensus params (a copy of cometbft_tpu/wire/types_pb.py; reference:
proto/cometbft/{types,crypto,version,evidence,params}/v1, gogoproto
wrappers).  Encoding and decoding rules are those of wire/proto.py;
emit_default marks gogoproto.nullable=false embedded messages (always
written)."""

from __future__ import annotations

from .canonical import Timestamp
from .proto import Field, Message

# ------------------------------------------------ gogoproto wrappers


class Duration(Message):
    """google.protobuf.Duration."""

    FIELDS = [
        Field(1, "seconds", "varint"),
        Field(2, "nanos", "varint"),
    ]

    @classmethod
    def from_ns(cls, ns: int) -> "Duration":
        return cls(seconds=ns // 1_000_000_000, nanos=ns % 1_000_000_000)

    def ns(self) -> int:
        return self.seconds * 1_000_000_000 + self.nanos


class Int64Value(Message):
    """google.protobuf.Int64Value wrapper."""

    FIELDS = [Field(1, "value", "varint")]


class StringValue(Message):
    FIELDS = [Field(1, "value", "string")]


class BytesValue(Message):
    FIELDS = [Field(1, "value", "bytes")]


# ------------------------------------------------------- version/v1


class Consensus(Message):
    """cometbft.version.v1.Consensus (block protocol + app version)."""

    FIELDS = [
        Field(1, "block", "varint"),
        Field(2, "app", "varint"),
    ]


# ------------------------------------------------------- crypto/v1


class PublicKey(Message):
    """cometbft.crypto.v1.PublicKey: a oneof over key types; at most one
    of the fields is non-empty."""

    FIELDS = [
        Field(1, "ed25519", "bytes"),
        Field(2, "secp256k1", "bytes"),
        Field(3, "bls12381", "bytes"),
        Field(4, "secp256k1eth", "bytes"),
    ]


class Proof(Message):
    FIELDS = [
        Field(1, "total", "varint"),
        Field(2, "index", "varint"),
        Field(3, "leaf_hash", "bytes"),
        Field(4, "aunts", "bytes", repeated=True),
    ]


class ValueOpProto(Message):
    FIELDS = [
        Field(1, "key", "bytes"),
        Field(2, "proof", "message", Proof),
    ]


class ProofOpProto(Message):
    FIELDS = [
        Field(1, "type", "string"),
        Field(2, "key", "bytes"),
        Field(3, "data", "bytes"),
    ]


class ProofOps(Message):
    FIELDS = [Field(1, "ops", "message", ProofOpProto, repeated=True)]


# -------------------------------------------------------- types/v1


class PartSetHeader(Message):
    FIELDS = [
        Field(1, "total", "varint"),
        Field(2, "hash", "bytes"),
    ]


class Part(Message):
    FIELDS = [
        Field(1, "index", "varint"),
        Field(2, "bytes", "bytes"),
        Field(3, "proof", "message", Proof, emit_default=True),
    ]


class BlockID(Message):
    FIELDS = [
        Field(1, "hash", "bytes"),
        Field(2, "part_set_header", "message", PartSetHeader, emit_default=True),
    ]


class CommitSig(Message):
    FIELDS = [
        Field(1, "block_id_flag", "varint"),
        Field(2, "validator_address", "bytes"),
        Field(3, "timestamp", "message", Timestamp, emit_default=True),
        Field(4, "signature", "bytes"),
    ]


class SimpleValidator(Message):
    """Hashed into Header.validators_hash (validator.proto SimpleValidator);
    a zero voting_power is omitted (proto3 default)."""

    FIELDS = [
        Field(1, "pub_key", "message", PublicKey),
        Field(2, "voting_power", "varint"),
    ]


class Header(Message):
    FIELDS = [
        Field(1, "version", "message", Consensus, emit_default=True),
        Field(2, "chain_id", "string"),
        Field(3, "height", "varint"),
        Field(4, "time", "message", Timestamp, emit_default=True),
        Field(5, "last_block_id", "message", BlockID, emit_default=True),
        Field(6, "last_commit_hash", "bytes"),
        Field(7, "data_hash", "bytes"),
        Field(8, "validators_hash", "bytes"),
        Field(9, "next_validators_hash", "bytes"),
        Field(10, "consensus_hash", "bytes"),
        Field(11, "app_hash", "bytes"),
        Field(12, "last_results_hash", "bytes"),
        Field(13, "evidence_hash", "bytes"),
        Field(14, "proposer_address", "bytes"),
    ]


class Data(Message):
    FIELDS = [Field(1, "txs", "bytes", repeated=True)]


class Vote(Message):
    FIELDS = [
        Field(1, "type", "varint"),
        Field(2, "height", "varint"),
        Field(3, "round", "varint"),
        Field(4, "block_id", "message", BlockID, emit_default=True),
        Field(5, "timestamp", "message", Timestamp, emit_default=True),
        Field(6, "validator_address", "bytes"),
        Field(7, "validator_index", "varint"),
        Field(8, "signature", "bytes"),
        Field(9, "extension", "bytes"),
        Field(10, "extension_signature", "bytes"),
    ]


class Commit(Message):
    FIELDS = [
        Field(1, "height", "varint"),
        Field(2, "round", "varint"),
        Field(3, "block_id", "message", BlockID, emit_default=True),
        Field(4, "signatures", "message", CommitSig, repeated=True),
    ]


class ExtendedCommitSig(Message):
    FIELDS = [
        Field(1, "block_id_flag", "varint"),
        Field(2, "validator_address", "bytes"),
        Field(3, "timestamp", "message", Timestamp, emit_default=True),
        Field(4, "signature", "bytes"),
        Field(5, "extension", "bytes"),
        Field(6, "extension_signature", "bytes"),
    ]


class ExtendedCommit(Message):
    FIELDS = [
        Field(1, "height", "varint"),
        Field(2, "round", "varint"),
        Field(3, "block_id", "message", BlockID, emit_default=True),
        Field(4, "extended_signatures", "message", ExtendedCommitSig, repeated=True),
    ]


# ------------------------------------------------------- validator/v1


class Validator(Message):
    FIELDS = [
        Field(1, "address", "bytes"),
        Field(2, "pub_key", "message", PublicKey),
        Field(3, "voting_power", "varint"),
        Field(4, "proposer_priority", "varint"),
        Field(5, "pub_key_bytes", "bytes"),
        Field(6, "pub_key_type", "string"),
    ]


class ValidatorSet(Message):
    FIELDS = [
        Field(1, "validators", "message", Validator, repeated=True),
        Field(2, "proposer", "message", Validator),
        Field(3, "total_voting_power", "varint"),
    ]


# ------------------------------------------------------- composite


class SignedHeader(Message):
    FIELDS = [
        Field(1, "header", "message", Header),
        Field(2, "commit", "message", Commit),
    ]


class LightBlockProto(Message):
    FIELDS = [
        Field(1, "signed_header", "message", SignedHeader),
        Field(2, "validator_set", "message", ValidatorSet),
    ]


class BlockMeta(Message):
    FIELDS = [
        Field(1, "block_id", "message", BlockID, emit_default=True),
        Field(2, "block_size", "varint"),
        Field(3, "header", "message", Header, emit_default=True),
        Field(4, "num_txs", "varint"),
    ]


class TxProof(Message):
    FIELDS = [
        Field(1, "root_hash", "bytes"),
        Field(2, "data", "bytes"),
        Field(3, "proof", "message", Proof),
    ]


# ------------------------------------------------------- evidence/v1


class DuplicateVoteEvidenceProto(Message):
    FIELDS = [
        Field(1, "vote_a", "message", Vote),
        Field(2, "vote_b", "message", Vote),
        Field(3, "total_voting_power", "varint"),
        Field(4, "validator_power", "varint"),
        Field(5, "timestamp", "message", Timestamp, emit_default=True),
    ]


class LightClientAttackEvidenceProto(Message):
    FIELDS = [
        Field(1, "conflicting_block", "message", LightBlockProto),
        Field(2, "common_height", "varint"),
        Field(3, "byzantine_validators", "message", Validator, repeated=True),
        Field(4, "total_voting_power", "varint"),
        Field(5, "timestamp", "message", Timestamp, emit_default=True),
    ]


class EvidenceProto(Message):
    """oneof sum — exactly one field set."""

    FIELDS = [
        Field(1, "duplicate_vote_evidence", "message", DuplicateVoteEvidenceProto),
        Field(2, "light_client_attack_evidence", "message", LightClientAttackEvidenceProto),
    ]


class EvidenceListProto(Message):
    FIELDS = [Field(1, "evidence", "message", EvidenceProto, repeated=True)]


class BlockProto(Message):
    FIELDS = [
        Field(1, "header", "message", Header, emit_default=True),
        Field(2, "data", "message", Data, emit_default=True),
        Field(3, "evidence", "message", EvidenceListProto, emit_default=True),
        Field(4, "last_commit", "message", Commit),
    ]


# ------------------------------------------------------- params/v1


class BlockParams(Message):
    FIELDS = [
        Field(1, "max_bytes", "varint"),
        Field(2, "max_gas", "varint"),
    ]


class EvidenceParams(Message):
    FIELDS = [
        Field(1, "max_age_num_blocks", "varint"),
        Field(2, "max_age_duration", "message", Duration, emit_default=True),
        Field(3, "max_bytes", "varint"),
    ]


class ValidatorParams(Message):
    FIELDS = [Field(1, "pub_key_types", "string", repeated=True)]


class VersionParams(Message):
    FIELDS = [Field(1, "app", "varint")]


class ABCIParams(Message):
    FIELDS = [Field(1, "vote_extensions_enable_height", "varint")]


class SynchronyParams(Message):
    FIELDS = [
        Field(1, "precision", "message", Duration),
        Field(2, "message_delay", "message", Duration),
    ]


class FeatureParams(Message):
    FIELDS = [
        Field(1, "vote_extensions_enable_height", "message", Int64Value),
        Field(2, "pbts_enable_height", "message", Int64Value),
    ]


class ConsensusParamsProto(Message):
    FIELDS = [
        Field(1, "block", "message", BlockParams),
        Field(2, "evidence", "message", EvidenceParams),
        Field(3, "validator", "message", ValidatorParams),
        Field(4, "version", "message", VersionParams),
        Field(5, "abci", "message", ABCIParams),
        Field(6, "synchrony", "message", SynchronyParams),
        Field(7, "feature", "message", FeatureParams),
    ]


class HashedParams(Message):
    """Subset hashed into Header.consensus_hash (params.proto HashedParams)."""

    FIELDS = [
        Field(1, "block_max_bytes", "varint"),
        Field(2, "block_max_gas", "varint"),
    ]
