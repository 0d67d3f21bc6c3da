"""State persistence protos (a copy of cometbft_tpu/wire/state_pb.py;
reference: proto/cometbft/state/v1/types.proto)."""

from __future__ import annotations

from .abci import FinalizeBlockResponse
from .canonical import Timestamp
from .proto import Field, Message
from .types import BlockID, Consensus, ConsensusParamsProto, Duration, ValidatorSet


class Version(Message):
    FIELDS = [
        Field(1, "consensus", "message", Consensus, emit_default=True),
        Field(2, "software", "string"),
    ]


class StateProto(Message):
    FIELDS = [
        Field(1, "version", "message", Version, emit_default=True),
        Field(2, "chain_id", "string"),
        Field(3, "last_block_height", "varint"),
        Field(4, "last_block_id", "message", BlockID, emit_default=True),
        Field(5, "last_block_time", "message", Timestamp, emit_default=True),
        Field(6, "next_validators", "message", ValidatorSet),
        Field(7, "validators", "message", ValidatorSet),
        Field(8, "last_validators", "message", ValidatorSet),
        Field(9, "last_height_validators_changed", "varint"),
        Field(10, "consensus_params", "message", ConsensusParamsProto, emit_default=True),
        Field(11, "last_height_consensus_params_changed", "varint"),
        Field(12, "last_results_hash", "bytes"),
        Field(13, "app_hash", "bytes"),
        Field(14, "initial_height", "varint"),
        Field(15, "next_block_delay", "message", Duration, emit_default=True),
    ]


class ValidatorsInfo(Message):
    FIELDS = [
        Field(1, "validator_set", "message", ValidatorSet),
        Field(2, "last_height_changed", "varint"),
    ]


class ConsensusParamsInfo(Message):
    FIELDS = [
        Field(1, "consensus_params", "message", ConsensusParamsProto, emit_default=True),
        Field(2, "last_height_changed", "varint"),
    ]


class ABCIResponsesInfo(Message):
    FIELDS = [
        Field(2, "height", "varint"),
        Field(3, "finalize_block", "message", FinalizeBlockResponse),
    ]
