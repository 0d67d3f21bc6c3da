"""The port's protobuf decoder (cometbft_tpu_torch/wire/proto.py) and the
messages of the light block and the evidence (wire/types.py) against the
JAX package's codec: every message decoded from the JAX encoder's bytes
re-encodes byte for byte and holds the values the JAX decoder reads —
negative int64 varints (ten bytes), empty repeated fields, emit_default
fields read back as their defaults, unknown fields skipped, packed
scalars; malformed bytes raise the JAX decoder's error.  A light block
built by the port's own types from the keys of the JAX SyntheticChain
(tests/test_light.py) encodes to the JAX block's bytes."""

import numpy as np
import pytest

from cometbft_tpu.wire import proto as jproto
from cometbft_tpu.wire import types_pb as jpb
from cometbft_tpu.wire.canonical import Timestamp as JTimestamp

from cometbft_tpu_torch.crypto import ed25519 as ped
from cometbft_tpu_torch.crypto import encoding as penc
from cometbft_tpu_torch.crypto import hash as ptmhash
from cometbft_tpu_torch import types as T
from cometbft_tpu_torch.types.light_block import LightBlock, SignedHeader
from cometbft_tpu_torch.wire import proto as pproto
from cometbft_tpu_torch.wire import types as ppb
from cometbft_tpu_torch.wire.canonical import Timestamp as PTimestamp

from test_light import CHAIN_ID as SYN_CHAIN_ID
from test_light import GENESIS_NS as SYN_GENESIS_NS
from test_light import NS as SYN_NS
from test_light import SyntheticChain, _vals_at

MESSAGES = ["PartSetHeader", "BlockID", "Consensus", "PublicKey", "CommitSig", "Header", "Vote", "Commit",
            "Validator", "ValidatorSet", "SignedHeader", "LightBlockProto", "DuplicateVoteEvidenceProto",
            "LightClientAttackEvidenceProto", "EvidenceProto", "EvidenceListProto"]
INT64 = [0, 1, -1, 127, 128, (1 << 63) - 1, -(1 << 63), -62135596800, 1 << 40]


def _value(rng, f, mod, depth):
    """A seeded value for field f (its message class from ``mod``)."""
    if f.repeated and f.kind == "message":
        return [_message(rng, f.msg, mod, depth + 1) for _ in range(int(rng.integers(0, 3)))]
    if f.repeated:
        return [_value(rng, f._replace(repeated=False), mod, depth) for _ in range(int(rng.integers(0, 3)))]
    if f.kind == "message":
        if depth > 3 or rng.random() < 0.2:
            return None
        return _message(rng, f.msg, mod, depth + 1)
    if f.kind == "bytes":
        return rng.bytes(int(rng.choice([0, 1, 20, 32, 64, 130])))
    if f.kind == "string":
        return rng.choice(["", "chain-α", "ed25519", "x" * 60])
    if f.kind == "sfixed64":
        return int(rng.choice(INT64))
    return int(rng.choice(INT64)) if rng.random() < 0.7 else int(rng.integers(0, 1 << 20))


def _message(rng, cls, mod, depth=0):
    return cls(**{f.name: _value(rng, f, mod, depth) for f in cls.FIELDS})


def _dump(m):
    """The field values of a decoded message, recursively, as plain data."""
    if m is None or isinstance(m, (int, bytes, str, bool, float)):
        return m
    if isinstance(m, list):
        return [_dump(x) for x in m]
    return (type(m).__name__, tuple((f.name, _dump(getattr(m, f.name))) for f in m.FIELDS))


@pytest.mark.parametrize("name", MESSAGES)
def test_every_message_decodes_the_jax_bytes(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    jcls, pcls = getattr(jpb, name), getattr(ppb, name)
    assert [(f.num, f.name, f.kind, f.repeated, f.packed, f.emit_default) for f in pcls.FIELDS] == [
        (f.num, f.name, f.kind, f.repeated, f.packed, f.emit_default) for f in jcls.FIELDS]
    for _ in range(12):
        raw = _message(rng, jcls, jpb).encode()
        got, want = pcls.decode(raw), jcls.decode(raw)
        assert got.encode() == raw
        assert _dump(got) == _dump(want)
    # the empty message: every emit_default field is written and reads back as its default
    raw = jcls().encode()
    assert pcls().encode() == raw and _dump(pcls.decode(raw)) == _dump(jcls.decode(raw))


def test_negative_int64_empty_repeated_and_emit_defaults():
    v = jpb.Validator(address=b"a" * 20, voting_power=-5, proposer_priority=-(1 << 63), pub_key_type="ed25519")
    raw = v.encode()
    assert len(jproto.encode_varint(-5)) == 10
    got = ppb.Validator.decode(raw)
    assert (got.voting_power, got.proposer_priority) == (-5, -(1 << 63)) and got.encode() == raw
    ts = JTimestamp(seconds=-62135596800, nanos=0)
    assert PTimestamp.decode(ts.encode()).seconds == -62135596800
    c = jpb.Commit(height=3, round=0, block_id=None, signatures=[])
    got = ppb.Commit.decode(c.encode())
    assert got.signatures == [] and got.block_id == ppb.BlockID(part_set_header=ppb.PartSetHeader())
    assert got.encode() == c.encode()
    vs = ppb.ValidatorSet.decode(jpb.ValidatorSet(validators=[], total_voting_power=0).encode())
    assert vs.validators == [] and vs.proposer is None


class _JPacked(jproto.Message):
    FIELDS = [jproto.Field(1, "xs", "varint", repeated=True, packed=True),
              jproto.Field(2, "zs", "zigzag", repeated=True, packed=True),
              jproto.Field(3, "fs", "fixed32", repeated=True),
              jproto.Field(4, "ok", "bool"), jproto.Field(5, "d", "double"), jproto.Field(6, "q", "fixed64")]


class _PPacked(pproto.Message):
    FIELDS = [pproto.Field(1, "xs", "varint", repeated=True, packed=True),
              pproto.Field(2, "zs", "zigzag", repeated=True, packed=True),
              pproto.Field(3, "fs", "fixed32", repeated=True),
              pproto.Field(4, "ok", "bool"), pproto.Field(5, "d", "double"), pproto.Field(6, "q", "fixed64")]


def test_packed_and_fixed_scalars():
    m = _JPacked(xs=[0, 1, 300, -1, (1 << 63) - 1], zs=[-3, 0, 7, -(1 << 62)], fs=[1, 0xFFFFFFFF],
                 ok=True, d=-2.5, q=(1 << 64) - 1)
    raw = m.encode()
    got = _PPacked.decode(raw)
    assert _dump(got)[1] == _dump(_JPacked.decode(raw))[1] and got.encode() == raw


def _unknown_fields():
    """Fields the message does not know, of every wire type."""
    return (jproto.encode_varint(99 << 3 | 0) + jproto.encode_varint(-7)
            + jproto.encode_varint(98 << 3 | 1) + b"\1" * 8
            + jproto.encode_varint(97 << 3 | 2) + jproto.encode_varint(3) + b"abc"
            + jproto.encode_varint(96 << 3 | 5) + b"\2" * 4)


MALFORMED = {
    "truncated-varint": lambda raw: raw[:1] + b"\x80",
    "truncated-bytes": lambda raw: raw[:-3],
    "bad-wire-type": lambda raw: jproto.encode_varint(1 << 3 | 0) + b"\x01",  # address as a varint
    "scalar-as-bytes": lambda raw: jproto.encode_varint(3 << 3 | 2) + b"\x01\x05",
    "group-wire-type": lambda raw: jproto.encode_varint(50 << 3 | 3),
    "varint-too-long": lambda raw: jproto.encode_varint(3 << 3) + b"\xff" * 10 + b"\x01",
    "truncated-unknown": lambda raw: jproto.encode_varint(90 << 3 | 1) + b"\0\0",
    "unknown-fields": lambda raw: raw + _unknown_fields(),
    "truncated-nested": lambda raw: jproto.encode_varint(2 << 3 | 2) + jproto.encode_varint(10) + b"\x0a\x05",
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_bytes_raise_as_the_jax_decoder(case):
    good = jpb.Validator(address=b"v" * 20, pub_key=jpb.PublicKey(ed25519=b"k" * 32), voting_power=10).encode()
    raw = MALFORMED[case](good)

    def run(cls):
        try:
            return "ok", _dump(cls.decode(raw))
        except Exception as e:  # the outcome under comparison
            return type(e).__name__, str(e)

    assert run(ppb.Validator) == run(jpb.Validator)


def test_decode_delimited_matches_jax():
    msgs = [jpb.PartSetHeader(total=i, hash=bytes([i]) * 32) for i in range(4)]
    buf = b"".join(jproto.encode_delimited(m) for m in msgs)
    pos_j = pos_p = 0
    for _ in msgs:
        mj, pos_j = jproto.decode_delimited(jpb.PartSetHeader, buf, pos_j)
        mp, pos_p = pproto.decode_delimited(ppb.PartSetHeader, buf, pos_p)
        assert pos_p == pos_j and mp.encode() == mj.encode()
    with pytest.raises(ValueError, match="truncated delimited message"):
        pproto.decode_delimited(ppb.PartSetHeader, buf[:-1], pos_p - len(jproto.encode_delimited(msgs[-1])))


def test_pubkeys_round_trip_through_the_proto():
    from cometbft_tpu_torch.crypto import secp256k1, secp256k1eth

    rng = np.random.default_rng(5)
    keys = [ped.PrivKey.from_seed(rng.bytes(32)).pub_key(),
            secp256k1.PrivKey(rng.bytes(31) + b"\1").pub_key(),
            secp256k1eth.PrivKey(rng.bytes(31) + b"\2").pub_key()]
    for pk in keys:
        m = penc.pubkey_to_proto(pk)
        assert ppb.PublicKey.decode(m.encode()) == m
        assert penc.pubkey_from_proto(m).bytes() == pk.bytes()
        assert penc.pubkey_from_type_and_bytes(pk.type, pk.bytes()).address() == pk.address()
    with pytest.raises(penc.UnsupportedKeyType):
        penc.pubkey_from_proto(ppb.PublicKey())
    with pytest.raises(penc.UnsupportedKeyType):
        penc.pubkey_from_type_and_bytes("sr25519", b"\0" * 32)


# ------------------------------------------- the JAX SyntheticChain's bytes

_SYN_KEYS = [ped.PrivKey.from_seed(bytes([200 + i]) * 32) for i in range(24)]


def _port_synthetic(n, rotate_every):
    """tests/test_light.py SyntheticChain rebuilt with the port's types and
    host signer from the same key seeds."""
    import hashlib

    def vals_at(h):
        w = (h - 1) // rotate_every % (len(_SYN_KEYS) - 4)
        return T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in _SYN_KEYS[w: w + 4]]), _SYN_KEYS[w: w + 4]

    blocks, last = {}, T.BlockID()
    for h in range(1, n + 1):
        (vals, keys), (next_vals, _) = vals_at(h), vals_at(h + 1)
        header = T.Header(
            chain_id=SYN_CHAIN_ID, height=h, time=PTimestamp.from_unix_ns(SYN_GENESIS_NS + h * 2 * SYN_NS),
            last_block_id=last, last_commit_hash=ptmhash.sum(b"lc%d" % h), data_hash=ptmhash.sum(b""),
            validators_hash=vals.hash(device=False), next_validators_hash=next_vals.hash(device=False),
            consensus_hash=ptmhash.sum(b"params"), app_hash=hashlib.sha256(b"app%d" % h).digest()[:8],
            last_results_hash=ptmhash.sum(b""), evidence_hash=ptmhash.sum(b""),
            proposer_address=vals.validators[0].address,
        )
        bid = T.BlockID(hash=header.hash(), part_set_header=T.PartSetHeader(1, ptmhash.sum(b"ps%d" % h)))
        ts = PTimestamp.from_unix_ns(SYN_GENESIS_NS + h * 2 * SYN_NS + SYN_NS)
        sigs = []
        for i, val in enumerate(vals.validators):
            key = next(k for k in keys if k.pub_key().address() == val.address)
            vote = T.Vote(type=2, height=h, round=0, block_id=bid, timestamp=ts,
                          validator_address=val.address, validator_index=i)
            vote.signature = key.sign(vote.sign_bytes(SYN_CHAIN_ID))
            sigs.append(vote.to_commit_sig())
        blocks[h] = LightBlock(SignedHeader(header, T.Commit(height=h, round=0, block_id=bid, signatures=sigs)), vals)
        last = bid
    return blocks


def test_light_blocks_encode_to_the_synthetic_chains_bytes():
    jchain = SyntheticChain(12, rotate_every=3)
    pblocks = _port_synthetic(12, rotate_every=3)
    for h in range(1, 13):
        raw = jchain.blocks[h].to_proto().encode()
        assert pblocks[h].to_proto().encode() == raw, h
        back = LightBlock.from_proto(ppb.LightBlockProto.decode(raw))
        assert back.to_proto().encode() == raw
        back.validate_basic(SYN_CHAIN_ID, device="cpu")
        assert back.hash == jchain.blocks[h].hash
        assert back.validator_set.hash(device=False) == jchain.blocks[h].validator_set.hash()
        assert {v.address for v in back.validator_set.validators} == {k.pub_key().address() for k in _vals_at(h, 3)}
