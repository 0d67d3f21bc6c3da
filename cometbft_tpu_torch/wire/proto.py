"""Minimal deterministic protobuf wire codec (a copy of
cometbft_tpu/wire/proto.py, with the same encoder and the same decoded
values; the decoder reads a message's fields within one buffer by
offsets, with no copy of an embedded message's bytes).

Semantics (reference wire behavior: gogoproto-generated Marshal in the
reference's api/, framing in libs/protoio/{writer,reader}.go):

  - varint / zigzag / fixed64 / sfixed64 / fixed32 scalars
  - length-delimited bytes / string / embedded messages
  - repeated fields (unpacked for messages/bytes, packed for scalars)
  - zero scalars and nil submessages are omitted; fields marked
    emit_default (gogoproto.nullable=false embedded messages) are always
    written; output is in ascending field order — byte-deterministic,
    which sign-bytes and hashing require
  - a varint field reads back as a signed 64-bit value (a negative int64
    is ten bytes of two's complement on the wire)
  - varint-length-delimited framing (MarshalDelimited) for streams
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

# ---------------------------------------------------------------- varint


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


def _varint(buf: bytes, pos: int, end: int) -> tuple[int, int]:
    """decode_varint over buf[:end]."""
    result = 0
    shift = 0
    while True:
        if pos >= end:
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if result >= 1 << 64:
                raise ValueError("varint overflows 64 bits")
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def decode_varint(buf: bytes, pos: int = 0) -> tuple[int, int]:
    return _varint(buf, pos, len(buf))


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n >= 0 else ((-n) << 1) - 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _to_signed64(n: int) -> int:
    return n - (1 << 64) if n >= 1 << 63 else n


# ------------------------------------------------------------- field spec

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_BYTES = 2
_WIRE_FIXED32 = 5

_WIRETYPE = {
    "varint": _WIRE_VARINT,
    "bool": _WIRE_VARINT,
    "zigzag": _WIRE_VARINT,
    "fixed64": _WIRE_FIXED64,
    "sfixed64": _WIRE_FIXED64,
    "double": _WIRE_FIXED64,
    "fixed32": _WIRE_FIXED32,
    "bytes": _WIRE_BYTES,
    "string": _WIRE_BYTES,
    "message": _WIRE_BYTES,
}

_DELIMITED = ("bytes", "string", "message")
# the decoder's kind codes: the length-delimited kinds from _C_BYTES up
_C_VARINT, _C_OTHER, _C_BYTES, _C_STRING, _C_MESSAGE = range(5)
_CODE = {k: _C_OTHER for k in _WIRETYPE}
_CODE.update(varint=_C_VARINT, bytes=_C_BYTES, string=_C_STRING, message=_C_MESSAGE)


class Field(NamedTuple):
    num: int
    name: str
    kind: str  # key of _WIRETYPE
    msg: Any = None  # Message subclass when kind == "message"
    repeated: bool = False
    packed: bool = False  # packed repeated scalars
    emit_default: bool = False  # gogoproto.nullable=false embedded msg


_SCALAR_DEFAULTS = {
    "varint": 0,
    "zigzag": 0,
    "fixed64": 0,
    "sfixed64": 0,
    "fixed32": 0,
    "double": 0.0,
    "bool": False,
    "bytes": b"",
    "string": "",
    "message": None,
}


def _default_for(f: Field):
    return [] if f.repeated else _SCALAR_DEFAULTS[f.kind]


def _encode_scalar(kind: str, v) -> bytes:
    if kind == "varint":
        return encode_varint(int(v))
    if kind == "bool":
        return encode_varint(1 if v else 0)
    if kind == "zigzag":
        return encode_varint(_zigzag(int(v)))
    if kind == "fixed64":
        return struct.pack("<Q", int(v) & ((1 << 64) - 1))
    if kind == "sfixed64":
        return struct.pack("<q", int(v))
    if kind == "double":
        return struct.pack("<d", float(v))
    if kind == "fixed32":
        return struct.pack("<I", int(v) & 0xFFFFFFFF)
    raise ValueError(f"not a scalar kind: {kind}")


def _is_default(f: Field, v) -> bool:
    if f.repeated:
        return not v
    if f.kind == "message":
        return v is None
    if f.kind in ("bytes", "string"):
        return len(v) == 0
    if f.kind == "bool":
        return not v
    return v == 0


class Message:
    """Base class; subclasses set FIELDS: list[Field]."""

    FIELDS: list[Field] = []

    def __init__(self, **kwargs):
        spec = {f.name for f in self.FIELDS}
        for f in self.FIELDS:
            setattr(self, f.name, _default_for(f))
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

    # ------------------------------------------------------------ encode

    def encode(self) -> bytes:
        out = bytearray()
        for f in sorted(self.FIELDS, key=lambda f: f.num):
            v = getattr(self, f.name)
            if not f.emit_default and _is_default(f, v):
                continue
            key = encode_varint(f.num << 3 | _WIRETYPE[f.kind])
            if f.repeated:
                if f.packed and f.kind not in _DELIMITED:
                    payload = b"".join(_encode_scalar(f.kind, x) for x in v)
                    out += encode_varint(f.num << 3 | _WIRE_BYTES)
                    out += encode_varint(len(payload)) + payload
                else:
                    for x in v:
                        out += key + _encode_one(f, x)
            else:
                if f.emit_default and v is None and f.kind == "message":
                    v = f.msg()
                out += key + _encode_one(f, v)
        return bytes(out)

    # ------------------------------------------------------------ decode

    @classmethod
    def _spec(cls):
        """(field by number as (field, name, kind code, message class,
        repeated), the scalar defaults, the repeated fields' names) of
        this class, made once."""
        spec = cls.__dict__.get("_SPEC")
        if spec is None:
            spec = ({f.num: (f, f.name, _CODE[f.kind], f.msg, f.repeated) for f in cls.FIELDS},
                    {f.name: _default_for(f) for f in cls.FIELDS if not f.repeated},
                    tuple(f.name for f in cls.FIELDS if f.repeated))
            cls._SPEC = spec
        return spec

    @classmethod
    def decode(cls, buf: bytes):
        buf = bytes(buf)
        return cls._decode_range(buf, 0, len(buf))

    @classmethod
    def _decode_range(cls, buf: bytes, pos: int, end: int):
        """The message in buf[pos:end]: the JAX decoder's values and
        errors, a one-byte varint read inline."""
        by_num, scalars, lists = cls._spec()
        msg = cls.__new__(cls)
        d = msg.__dict__
        d.update(scalars)
        for name in lists:
            d[name] = []
        while pos < end:
            key = buf[pos]
            if key < 0x80:
                pos += 1
            else:
                key, pos = _varint(buf, pos, end)
            spec = by_num.get(key >> 3)
            if spec is None:
                pos = _skip(buf, pos, key & 7, end)
                continue
            f, name, code, sub, repeated = spec
            wt = key & 7
            if code >= _C_BYTES:  # length-delimited: bytes, string, message
                if wt != _WIRE_BYTES:
                    raise ValueError(f"field {name}: bad wire type {wt}")
                if pos >= end:
                    raise ValueError("truncated varint")
                ln = buf[pos]
                if ln < 0x80:
                    pos += 1
                else:
                    ln, pos = _varint(buf, pos, end)
                stop = pos + ln
                if stop > end:
                    raise ValueError("truncated length-delimited field")
                if code == _C_MESSAGE:
                    v = sub._decode_range(buf, pos, stop)
                elif code == _C_STRING:
                    v = buf[pos:stop].decode("utf-8")
                else:
                    v = buf[pos:stop]
                pos = stop
            elif wt == _WIRE_BYTES:
                if not repeated:
                    raise ValueError(
                        f"field {name}: length-delimited data for scalar field"
                    )
                # packed repeated scalars
                ln, pos = _varint(buf, pos, end)
                stop = pos + ln
                if stop > end:
                    raise ValueError("truncated packed field")
                vals = d[name]
                while pos < stop:
                    v, pos = _decode_scalar(f, buf, pos, end)
                    vals.append(v)
                if pos != stop:
                    raise ValueError("packed field overran its length")
                continue
            elif code == _C_VARINT:
                if pos >= end:
                    raise ValueError("truncated varint")
                v = buf[pos]
                if v < 0x80:
                    pos += 1
                else:
                    v, pos = _varint(buf, pos, end)
                    if v >= 1 << 63:
                        v -= 1 << 64
            else:
                v, pos = _decode_scalar(f, buf, pos, end)
            if repeated:
                d[name].append(v)
            else:
                d[name] = v
        return msg


def _encode_one(f: Field, v) -> bytes:
    if f.kind == "message":
        payload = v.encode()
        return encode_varint(len(payload)) + payload
    if f.kind == "string":
        payload = v.encode("utf-8")
        return encode_varint(len(payload)) + payload
    if f.kind == "bytes":
        return encode_varint(len(v)) + bytes(v)
    return _encode_scalar(f.kind, v)


def _decode_scalar(f: Field, buf: bytes, pos: int, end: int):
    if f.kind in ("varint", "bool", "zigzag"):
        v, pos = _varint(buf, pos, end)
        if f.kind == "bool":
            return bool(v), pos
        if f.kind == "zigzag":
            return _unzigzag(v), pos
        return _to_signed64(v), pos
    width = 4 if f.kind == "fixed32" else 8
    if pos + width > end:
        raise ValueError("truncated fixed-width field")
    if f.kind == "fixed64":
        return struct.unpack_from("<Q", buf, pos)[0], pos + 8
    if f.kind == "sfixed64":
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if f.kind == "double":
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if f.kind == "fixed32":
        return struct.unpack_from("<I", buf, pos)[0], pos + 4
    raise ValueError(f"bad scalar kind {f.kind}")


def _skip(buf: bytes, pos: int, wt: int, end: int) -> int:
    if wt == _WIRE_VARINT:
        _, pos = _varint(buf, pos, end)
        return pos
    elif wt == _WIRE_FIXED64:
        pos += 8
    elif wt == _WIRE_FIXED32:
        pos += 4
    elif wt == _WIRE_BYTES:
        ln, pos = _varint(buf, pos, end)
        pos += ln
    else:
        raise ValueError(f"unsupported wire type {wt}")
    if pos > end:
        raise ValueError("truncated field")
    return pos


# ----------------------------------------------------------- stream framing


def encode_delimited(msg: Message) -> bytes:
    """Varint-length-prefixed encoding (libs/protoio/writer.go:103)."""
    payload = msg.encode()
    return encode_varint(len(payload)) + payload


def decode_delimited(cls, buf: bytes, pos: int = 0):
    """Returns (message, new_pos) (libs/protoio/reader.go:107)."""
    ln, pos = decode_varint(buf, pos)
    if pos + ln > len(buf):
        raise ValueError("truncated delimited message")
    return cls.decode(buf[pos : pos + ln]), pos + ln
