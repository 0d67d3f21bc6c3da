"""Canonical vote sign-bytes (reference: proto/cometbft/types/v1/
canonical.proto; types/vote.go VoteSignBytes).  The part of
cometbft_tpu/wire/canonical.py that Vote.sign_bytes and
Commit.vote_sign_bytes_fn read.

These byte strings are what validators sign and what the comb kernels
hash — consensus-critical and deterministic: sfixed64 height/round,
ascending field order, non-nullable timestamps always emitted, and the
whole message varint-length-delimited (protoio MarshalDelimited).
"""

from __future__ import annotations

from .proto import Field, Message, encode_delimited, encode_varint

# SignedMsgType enum (types.proto SIGNED_MSG_TYPE_*)
PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2


class Timestamp(Message):
    """google.protobuf.Timestamp: UTC wall time as (seconds, nanos)."""

    FIELDS = [
        Field(1, "seconds", "varint"),
        Field(2, "nanos", "varint"),
    ]

    @classmethod
    def from_unix_ns(cls, ns: int) -> "Timestamp":
        return cls(seconds=ns // 1_000_000_000, nanos=ns % 1_000_000_000)

    def unix_ns(self) -> int:
        return self.seconds * 1_000_000_000 + self.nanos

    def __hash__(self):
        return hash((self.seconds, self.nanos))


class CanonicalPartSetHeader(Message):
    FIELDS = [
        Field(1, "total", "varint"),
        Field(2, "hash", "bytes"),
    ]


class CanonicalBlockID(Message):
    FIELDS = [
        Field(1, "hash", "bytes"),
        Field(2, "part_set_header", "message", CanonicalPartSetHeader, emit_default=True),
    ]


class CanonicalVote(Message):
    FIELDS = [
        Field(1, "type", "varint"),
        Field(2, "height", "sfixed64"),
        Field(3, "round", "sfixed64"),
        Field(4, "block_id", "message", CanonicalBlockID),  # nil when voting nil
        Field(5, "timestamp", "message", Timestamp, emit_default=True),
        Field(6, "chain_id", "string"),
    ]


def vote_sign_bytes(
    chain_id: str,
    msg_type: int,
    height: int,
    round_: int,
    block_id: CanonicalBlockID | None,
    timestamp: Timestamp,
) -> bytes:
    """The exact bytes a validator signs for a vote (types/vote.go:VoteSignBytes)."""
    cv = CanonicalVote(
        type=msg_type,
        height=height,
        round=round_,
        block_id=block_id,
        timestamp=timestamp,
        chain_id=chain_id,
    )
    return encode_delimited(cv)


class _CanonicalVotePrefix(Message):
    """Fields 1-4 of CanonicalVote — everything before the timestamp."""

    FIELDS = [f for f in CanonicalVote.FIELDS if f.num < 5]


class _CanonicalVoteSuffix(Message):
    FIELDS = [f for f in CanonicalVote.FIELDS if f.num > 5]


_TS_TAG = bytes([5 << 3 | 2])  # field 5, length-delimited


def make_vote_sign_bytes_batch(
    chain_id: str,
    msg_type: int,
    height: int,
    round_: int,
    block_id: CanonicalBlockID | None,
):
    """Returns sign_bytes(timestamp) closing over the once-encoded prefix
    (fields 1-4) and suffix (chain_id): only the timestamp re-encodes per
    signature.  Byte-identical to vote_sign_bytes."""
    prefix = _CanonicalVotePrefix(
        type=msg_type, height=height, round=round_, block_id=block_id
    ).encode()
    suffix = _CanonicalVoteSuffix(chain_id=chain_id).encode()

    def sign_bytes(timestamp: Timestamp) -> bytes:
        ts_payload = timestamp.encode()
        body = prefix + _TS_TAG + encode_varint(len(ts_payload)) + ts_payload + suffix
        return encode_varint(len(body)) + body

    return sign_bytes
