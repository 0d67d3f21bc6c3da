"""Proto messages that the header and validator-set hashes merkleize (a
copy of the encode half of cometbft_tpu/wire/types_pb.py for these
messages; reference: proto/cometbft/{types,crypto,version}/v1,
gogoproto wrappers).  Encoding rules are those of wire/proto.py."""

from __future__ import annotations

from .canonical import Timestamp
from .proto import Field, Message

# ------------------------------------------------ gogoproto wrappers


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
    """cometbft.crypto.v1.PublicKey: a oneof over key types, of which the
    port carries the ed25519 arm."""

    FIELDS = [Field(1, "ed25519", "bytes")]


# -------------------------------------------------------- types/v1


class PartSetHeader(Message):
    FIELDS = [
        Field(1, "total", "varint"),
        Field(2, "hash", "bytes"),
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
