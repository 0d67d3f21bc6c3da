"""The ABCI messages that a FinalizeBlock response holds, which the state
store keeps a height (a copy of those of cometbft_tpu/wire/abci_pb.py;
reference: proto/cometbft/abci/v1/types.proto).  The rest of the ABCI
request and response set comes with the ABCI port."""

from __future__ import annotations

from .proto import Field, Message
from .types import ConsensusParamsProto, Duration


class EventAttribute(Message):
    FIELDS = [
        Field(1, "key", "string"),
        Field(2, "value", "string"),
        Field(3, "index", "bool"),
    ]


class Event(Message):
    FIELDS = [
        Field(1, "type", "string"),
        Field(2, "attributes", "message", EventAttribute, repeated=True),
    ]


class ExecTxResult(Message):
    FIELDS = [
        Field(1, "code", "varint"),
        Field(2, "data", "bytes"),
        Field(3, "log", "string"),
        Field(4, "info", "string"),
        Field(5, "gas_wanted", "varint"),
        Field(6, "gas_used", "varint"),
        Field(7, "events", "message", Event, repeated=True),
        Field(8, "codespace", "string"),
    ]


class ValidatorUpdate(Message):
    FIELDS = [
        Field(2, "power", "varint"),
        Field(3, "pub_key_bytes", "bytes"),
        Field(4, "pub_key_type", "string"),
    ]


class FinalizeBlockResponse(Message):
    FIELDS = [
        Field(1, "events", "message", Event, repeated=True),
        Field(2, "tx_results", "message", ExecTxResult, repeated=True),
        Field(3, "validator_updates", "message", ValidatorUpdate, repeated=True),
        Field(4, "consensus_param_updates", "message", ConsensusParamsProto),
        Field(5, "app_hash", "bytes"),
        Field(6, "next_block_delay", "message", Duration, emit_default=True),
    ]
