"""Minimal deterministic protobuf encoder: the subset canonical vote
sign-bytes need (a copy of the encode half of cometbft_tpu/wire/proto.py).

Semantics (reference wire behavior: gogoproto-generated Marshal, framing
in libs/protoio/writer.go):

  - varint / sfixed64 scalars, length-delimited bytes / string /
    embedded messages
  - zero scalars and nil submessages are omitted; fields marked
    emit_default (gogoproto.nullable=false embedded messages) are always
    written; output is in ascending field order — byte-deterministic,
    which sign-bytes require
  - varint-length-delimited framing (MarshalDelimited)
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple


def encode_varint(n: int) -> bytes:
    if n < 0:
        n &= (1 << 64) - 1  # two's-complement, 10 bytes, like protobuf int64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_BYTES = 2

_WIRETYPE = {
    "varint": _WIRE_VARINT,
    "sfixed64": _WIRE_FIXED64,
    "bytes": _WIRE_BYTES,
    "string": _WIRE_BYTES,
    "message": _WIRE_BYTES,
}


class Field(NamedTuple):
    num: int
    name: str
    kind: str  # key of _WIRETYPE
    msg: Any = None  # Message subclass when kind == "message"
    emit_default: bool = False  # gogoproto.nullable=false embedded msg


_DEFAULTS = {"varint": 0, "sfixed64": 0, "bytes": b"", "string": "", "message": None}


def _is_default(f: Field, v) -> bool:
    if f.kind == "message":
        return v is None
    if f.kind in ("bytes", "string"):
        return len(v) == 0
    return v == 0


class Message:
    """Base class; subclasses set FIELDS: list[Field]."""

    FIELDS: list[Field] = []

    def __init__(self, **kwargs):
        spec = {f.name for f in self.FIELDS}
        for f in self.FIELDS:
            setattr(self, f.name, _DEFAULTS[f.kind])
        for k, v in kwargs.items():
            if k not in spec:
                raise TypeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, v)

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, f.name) == getattr(other, f.name) for f in self.FIELDS
        )

    def __repr__(self):
        kv = ", ".join(
            f"{f.name}={getattr(self, f.name)!r}"
            for f in self.FIELDS
            if not _is_default(f, getattr(self, f.name))
        )
        return f"{type(self).__name__}({kv})"

    def encode(self) -> bytes:
        out = bytearray()
        for f in sorted(self.FIELDS, key=lambda f: f.num):
            v = getattr(self, f.name)
            if not f.emit_default and _is_default(f, v):
                continue
            if f.emit_default and v is None and f.kind == "message":
                v = f.msg()
            out += encode_varint(f.num << 3 | _WIRETYPE[f.kind])
            out += _encode_one(f, v)
        return bytes(out)


def _encode_one(f: Field, v) -> bytes:
    if f.kind == "message":
        payload = v.encode()
        return encode_varint(len(payload)) + payload
    if f.kind == "string":
        payload = v.encode("utf-8")
        return encode_varint(len(payload)) + payload
    if f.kind == "bytes":
        return encode_varint(len(v)) + bytes(v)
    if f.kind == "sfixed64":
        return struct.pack("<q", int(v))
    return encode_varint(int(v))


def encode_delimited(msg: Message) -> bytes:
    """Varint-length-prefixed encoding (libs/protoio/writer.go:103)."""
    payload = msg.encode()
    return encode_varint(len(payload)) + payload
