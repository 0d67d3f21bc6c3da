"""The port's block types (cometbft_tpu_torch/types/params.py, tx.py,
block.py's Data, Block, ExtendedCommit and Commit.median_time,
part_set.py, genesis.py) against the JAX package's on the same seeded
values: params hashes and protos, tx hashes and proofs, Data and Block
protos and hashes, part sets split, checked and assembled, extended
commits, BFT time and genesis JSON, byte for byte.  The port hashes with
device="cpu" (the kernels' plain versions) where a route reaches K7 + K8."""

import json

import numpy as np
import pytest
import torch

from cometbft_tpu.types import block as JB
from cometbft_tpu.types import genesis as JG
from cometbft_tpu.types import params as JP
from cometbft_tpu.types import part_set as JPS
from cometbft_tpu.types import tx as JT
from cometbft_tpu.types.validators import Validator as JValidator
from cometbft_tpu.types.validators import ValidatorSet as JValidatorSet
from cometbft_tpu.wire import types_pb as jpb

from cometbft_tpu_torch import types as T
from cometbft_tpu_torch.crypto import ed25519 as ped
from cometbft_tpu_torch.types import block as PB
from cometbft_tpu_torch.types import genesis as PG
from cometbft_tpu_torch.types import params as PP
from cometbft_tpu_torch.types import part_set as PPS
from cometbft_tpu_torch.types import tx as PT
from cometbft_tpu_torch.wire import types as ppb
from cometbft_tpu_torch.wire.canonical import Timestamp as PTimestamp

import torch_rpc_node as RN

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _limit():
    with RN.time_limit(60):
        yield


def _txs(seed, n, width=40):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(w)) for w in rng.integers(1, width, size=n)]


# ------------------------------------------------------------------ params


def _params_pair(seed):
    rng = np.random.default_rng(seed)
    vals = dict(
        max_bytes=int(rng.integers(1, 1 << 22)), max_gas=int(rng.integers(-1, 1 << 30)),
        blocks=int(rng.integers(1, 10**6)), dur=int(rng.integers(1, 10**15)), ev_bytes=int(rng.integers(0, 1 << 20)),
        app=int(rng.integers(0, 9)), prec=int(rng.integers(0, 10**10)), delay=int(rng.integers(0, 10**11)),
        veh=int(rng.integers(0, 50)), pbts=int(rng.integers(0, 50)),
    )
    out = []
    for M in (JP, PP):
        p = M.ConsensusParams(
            block=M.BlockParams(vals["max_bytes"], vals["max_gas"]),
            evidence=M.EvidenceParams(vals["blocks"], vals["dur"], vals["ev_bytes"]),
            validator=M.ValidatorParams(["ed25519", "secp256k1"]),
            version=M.VersionParams(vals["app"]),
            synchrony=M.SynchronyParams(vals["prec"], vals["delay"]),
            feature=M.FeatureParams(vals["veh"], vals["pbts"]),
        )
        out.append(p)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_params_hash_proto_and_update_match_jax(seed):
    jp, pp = _params_pair(seed)
    assert pp.hash() == jp.hash()
    raw = jp.to_proto().encode()
    assert pp.to_proto().encode() == raw
    back = PP.ConsensusParams.from_proto(ppb.ConsensusParamsProto.decode(raw))
    assert back.to_proto().encode() == raw
    jd, pd = JP.default_consensus_params(), PP.default_consensus_params()
    assert pd.hash() == jd.hash() and pd.to_proto().encode() == jd.to_proto().encode()
    upd = jp.to_proto().encode()
    assert (pd.update(ppb.ConsensusParamsProto.decode(upd)).to_proto().encode()
            == jd.update(jpb.ConsensusParamsProto.decode(upd)).to_proto().encode())
    for p in (jp, pp):
        p.validate_basic()
    bad_j, bad_p = JP.default_consensus_params(), PP.default_consensus_params()
    bad_j.block.max_bytes = bad_p.block.max_bytes = 0
    with pytest.raises(ValueError) as ej:
        bad_j.validate_basic()
    with pytest.raises(ValueError) as ep:
        bad_p.validate_basic()
    assert str(ep.value) == str(ej.value)


# ---------------------------------------------------------------------- tx


@pytest.mark.parametrize("n", [1, 2, 7, 33])
def test_tx_hash_txs_hash_and_proofs_match_jax(n):
    txs = _txs(n, n)
    assert [PT.tx_hash(t) for t in txs] == [JT.tx_hash(t) for t in txs]
    want = JT.txs_hash(txs)
    assert PT.txs_hash(txs) == want  # hashlib below 512
    assert PT.txs_hash(txs, device="cpu") == want  # the kernels' plain versions
    for i in {0, n // 2, n - 1}:
        jr, jproof = JT.tx_proof(txs, i)
        pr, pproof = PT.tx_proof(txs, i)
        assert pr == jr == want
        assert (pproof.total, pproof.index, pproof.leaf_hash, pproof.aunts) == (
            jproof.total, jproof.index, jproof.leaf_hash, jproof.aunts)
        pproof.verify(pr, PT.tx_hash(txs[i]))


def test_txs_hash_at_the_device_threshold_routes_to_the_kernels():
    txs = _txs(9, 600, width=8)
    want = JT.txs_hash(txs)
    assert PT.txs_hash(txs, device="cpu") == want
    data = PB.Data(txs)
    assert data.hash(device="cpu") == want
    assert PB.Data(txs).hash(device=False) == want


# ---------------------------------------------------------- Data and Block


def _block_pair(seed, n_txs=5, with_commit=True):
    """A port Block and the JAX Block decoded from its bytes."""
    rng = np.random.default_rng(seed)
    keys = [ped.PrivKey.from_seed(rng.bytes(32)) for _ in range(4)]
    vals = T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in keys])
    bid = T.BlockID(hash=rng.bytes(32), part_set_header=T.PartSetHeader(2, rng.bytes(32)))
    sigs = [T.CommitSig(T.BLOCK_ID_FLAG_COMMIT, v.address, PTimestamp(seconds=1_700_000_000 + i, nanos=i * 7),
                        rng.bytes(64)) for i, v in enumerate(vals.validators)]
    sigs[2] = T.CommitSig.absent()
    commit = T.Commit(height=4, round=1, block_id=bid, signatures=sigs) if with_commit else None
    hdr = T.Header(chain_id="types-chain", height=5, time=PTimestamp(seconds=1_700_000_100, nanos=5),
                   last_block_id=bid, validators_hash=vals.hash(device=False),
                   next_validators_hash=vals.hash(device=False), consensus_hash=rng.bytes(32),
                   app_hash=rng.bytes(32), proposer_address=vals.validators[0].address)
    block = T.Block(header=hdr, data=T.Data(_txs(seed, n_txs)), evidence=[], last_commit=commit)
    block.fill_header(device="cpu")
    jblock = JB.Block.decode(block.encode())
    return block, jblock, vals


@pytest.mark.parametrize("seed", [0, 1])
def test_data_and_block_proto_and_hashes_match_jax(seed):
    block, jblock, _ = _block_pair(seed)
    jfresh = JB.Block(header=JB.Header.from_proto(jpb.Header.decode(block.header.to_proto().encode())),
                      data=JB.Data(list(block.data.txs)), evidence=[], last_commit=jblock.last_commit)
    jfresh.header.data_hash = jfresh.header.last_commit_hash = jfresh.header.evidence_hash = b""
    jfresh.fill_header()
    assert jfresh.header.to_proto().encode() == block.header.to_proto().encode()
    assert block.encode() == jblock.encode()
    assert block.hash() == jblock.hash()
    assert block.data.hash(device="cpu") == jblock.data.hash()
    assert block.data.to_proto().encode() == jblock.data.to_proto().encode()
    back = PB.Block.decode(jblock.encode())
    assert back.encode() == block.encode() and back.hash() == block.hash()
    back.validate_basic(device="cpu")
    jblock.validate_basic()


def test_block_validate_basic_refusals_match_jax():
    cases = {
        "wrong DataHash": lambda b: b.data.txs.append(b"extra"),
        "wrong LastCommitHash": lambda b: setattr(b.header, "last_commit_hash", b"\x01" * 32),
        "wrong EvidenceHash": lambda b: setattr(b.header, "evidence_hash", b"\x02" * 32),
        "nil LastCommit": lambda b: setattr(b, "last_commit", None),
    }
    for what, mutate in cases.items():
        raw = _block_pair(7)[0].encode()
        block, jblock = PB.Block.decode(raw), JB.Block.decode(raw)  # no memoised hashes
        mutate(block)
        mutate(jblock)
        with pytest.raises(ValueError) as ej:
            jblock.validate_basic()
        with pytest.raises(ValueError) as ep:
            block.validate_basic(device="cpu")
        assert str(ep.value) == str(ej.value), what


def test_extended_commit_round_trip_and_checks_match_jax():
    block, jblock, vals = _block_pair(3)
    c = block.last_commit
    ext = T.ExtendedCommit(c.height, c.round, c.block_id, [
        T.ExtendedCommitSig(cs, b"ext%d" % i if cs.for_block() else b"", b"s%d" % i if cs.for_block() else b"")
        for i, cs in enumerate(c.signatures)])
    raw = ext.to_proto().encode()
    jext = JB.ExtendedCommit.from_proto(jpb.ExtendedCommit.decode(raw))
    assert jext.to_proto().encode() == raw
    back = PB.ExtendedCommit.from_proto(ppb.ExtendedCommit.decode(raw))
    assert back.to_proto().encode() == raw
    assert back.to_commit().to_proto().encode() == jext.to_commit().to_proto().encode()
    assert back.to_commit().hash() == jext.to_commit().hash()
    back.ensure_extensions(True)
    jext.ensure_extensions(True)
    for ext_enabled in (False,):
        with pytest.raises(ValueError) as ej:
            jext.ensure_extensions(ext_enabled)
        with pytest.raises(ValueError) as ep:
            back.ensure_extensions(ext_enabled)
        assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_median_time_and_get_vote_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    keys = [ped.PrivKey.from_seed(rng.bytes(32)) for _ in range(9)]
    powers = rng.integers(1, 50, size=9).tolist()
    pvals = T.ValidatorSet([T.Validator(k.pub_key(), p) for k, p in zip(keys, powers)])
    jvals = JValidatorSet([JValidator(JB_pub(k), p) for k, p in zip(keys, powers)])
    bid = T.BlockID(hash=rng.bytes(32), part_set_header=T.PartSetHeader(1, rng.bytes(32)))
    sigs = []
    for i, v in enumerate(pvals.validators):
        flag = [T.BLOCK_ID_FLAG_COMMIT, T.BLOCK_ID_FLAG_NIL, T.BLOCK_ID_FLAG_ABSENT][int(rng.integers(0, 3))]
        if flag == T.BLOCK_ID_FLAG_ABSENT:
            sigs.append(T.CommitSig.absent())
        else:
            ts = PTimestamp.from_unix_ns(1_700_000_000 * 10**9 + int(rng.integers(0, 10**9)))
            sigs.append(T.CommitSig(flag, v.address, ts, rng.bytes(64)))
    commit = T.Commit(height=3, round=2, block_id=bid, signatures=sigs)
    jcommit = JB.Commit.from_proto(jpb.Commit.decode(commit.to_proto().encode()))
    assert commit.median_time(pvals).unix_ns() == jcommit.median_time(jvals).unix_ns()
    for i in range(len(sigs)):
        assert commit.get_vote(i).to_proto().encode() == jcommit.get_vote(i).to_proto().encode()
        assert commit.get_vote(i).sign_bytes("c") == jcommit.vote_sign_bytes("c", i)


def JB_pub(k):
    from cometbft_tpu.crypto import ed25519 as jed

    return jed.PubKey(k.pub_key().bytes())


# --------------------------------------------------------------- part sets


@pytest.mark.parametrize("size,part", [(1, 64), (64, 64), (65, 64), (1000, 64), (70_000, 65536)])
def test_part_set_split_proofs_and_assembly_match_jax(size, part):
    data = np.random.default_rng(size).bytes(size)
    jps = JPS.PartSet.from_data(data, part)
    pps = PPS.PartSet.from_data(data, part)
    assert (pps.header.total, pps.header.hash) == (jps.header.total, jps.header.hash)
    assert pps.byte_size == jps.byte_size == size
    for i in range(pps.header.total):
        assert pps.get_part(i).to_proto().encode() == jps.get_part(i).to_proto().encode()
    # a receiver fills the set from the parts' proto bytes, out of order
    recv = PPS.PartSet(PB.PartSetHeader(pps.header.total, pps.header.hash))
    for i in reversed(range(pps.header.total)):
        raw = jps.get_part(i).to_proto().encode()
        assert recv.add_part(PPS.Part.from_proto(ppb.Part.decode(raw))) is True
        assert recv.add_part(PPS.Part.from_proto(ppb.Part.decode(raw))) is False
    assert recv.is_complete() and recv.assemble() == data == jps.assemble()
    assert recv.bit_array() == [True] * pps.header.total


def test_part_set_refuses_a_tampered_part_as_jax():
    data = np.random.default_rng(5).bytes(300)
    jps = JPS.PartSet.from_data(data, 64)
    raw = jps.get_part(2).to_proto().encode()
    jpart = JPS.Part.from_proto(jpb.Part.decode(raw))
    ppart = PPS.Part.from_proto(ppb.Part.decode(raw))
    jpart.bytes = ppart.bytes = b"\xff" + ppart.bytes[1:]
    jrecv = JPS.PartSet(JB.PartSetHeader(jps.header.total, jps.header.hash))
    precv = PPS.PartSet(PB.PartSetHeader(jps.header.total, jps.header.hash))
    with pytest.raises(ValueError) as ej:
        jrecv.add_part(jpart)
    with pytest.raises(ValueError) as ep:
        precv.add_part(ppart)
    assert str(ep.value) == str(ej.value)
    assert precv.count == 0 and not precv.is_complete()
    with pytest.raises(ValueError):
        precv.assemble()
    with pytest.raises(ValueError, match="out of bounds"):
        precv.add_part(PPS.Part(99, b"", ppart.proof))


def test_block_make_part_set_matches_jax():
    block, jblock, _ = _block_pair(11, n_txs=40)
    pps, jps = block.make_part_set(256), jblock.make_part_set(256)
    assert (pps.header.total, pps.header.hash) == (jps.header.total, jps.header.hash)
    assert PB.Block.decode(pps.assemble()).hash() == block.hash()


# ----------------------------------------------------------------- genesis


def _genesis_json(seed):
    rng = np.random.default_rng(seed)
    keys = [ped.PrivKey.from_seed(rng.bytes(32)) for _ in range(5)]
    doc = PG.GenesisDoc(
        chain_id="genesis-%d" % seed, genesis_time=PTimestamp.from_unix_ns(1_760_000_000 * 10**9 + seed),
        initial_height=1 + seed,
        validators=[PG.GenesisValidator("ed25519", k.pub_key().bytes(), int(p), name=f"v{i}")
                    for i, (k, p) in enumerate(zip(keys, rng.integers(1, 100, size=5)))],
        app_hash=rng.bytes(32),
    )
    doc.consensus_params.evidence.max_age_num_blocks = 77 + seed
    return doc


@pytest.mark.parametrize("seed", [0, 1])
def test_genesis_json_round_trip_and_validator_set_match_jax(seed, tmp_path):
    doc = _genesis_json(seed)
    text = doc.to_json()
    jdoc = JG.GenesisDoc.from_json(text)
    assert jdoc.to_json() == text
    back = PG.GenesisDoc.from_json(jdoc.to_json())
    assert back.to_json() == text and back.sha256() == jdoc.sha256()
    assert back.validator_hash(device="cpu") == jdoc.validator_hash()
    assert [v.address for v in back.validators] == [v.address for v in jdoc.validators]
    assert back.consensus_params.hash() == jdoc.consensus_params.hash()
    path = tmp_path / "genesis.json"
    back.save_as(str(path))
    assert PG.GenesisDoc.load(str(path)).to_json() == text


@pytest.mark.parametrize("mutate", [
    lambda d: d.pop("chain_id"),
    lambda d: d.update(chain_id="x" * 51),
    lambda d: d.update(app_hash="zz"),
    lambda d: d["validators"][0].update(power="-1"),
    lambda d: d.update(initial_height="-3"),
])
def test_genesis_refusals_match_jax(mutate):
    d = json.loads(_genesis_json(3).to_json())
    mutate(d)
    text = json.dumps(d)
    with pytest.raises(ValueError) as ej:
        JG.GenesisDoc.from_json(text)
    with pytest.raises(ValueError) as ep:
        PG.GenesisDoc.from_json(text)
    assert str(ep.value) == str(ej.value)
