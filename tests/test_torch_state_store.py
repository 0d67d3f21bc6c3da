"""The port's State and state store (cometbft_tpu_torch/state/state.py,
store.py) against the JAX package's: State protos, make_genesis_state
from one genesis JSON, make_block's headers and hashes (the JAX class's
second definition, the one Python keeps), and the store's sparse
validator sets, consensus params, FinalizeBlock responses, bootstrap and
pruning over MemDB and SQLiteDB, both databases equal byte for byte.
The chain is tests/torch_rpc_node.py's NodeChain, its set moving after
height 2; the port hashes on device="cpu" (the kernels' plain versions)."""

import numpy as np
import pytest
import torch

from cometbft_tpu.state import state as JS
from cometbft_tpu.state import store as JSS
from cometbft_tpu.store import db as JDB
from cometbft_tpu.types import block as JB
from cometbft_tpu.types import genesis as JG
from cometbft_tpu.wire import abci_pb as jabci
from cometbft_tpu.wire import state_pb as jstate_pb
from cometbft_tpu.wire import types_pb as jpb

from cometbft_tpu_torch import types as T
from cometbft_tpu_torch.state import State, StateStore, make_genesis_state
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.store import db as PDB
from cometbft_tpu_torch.wire import state as pstate_pb
from cometbft_tpu_torch.wire.canonical import Timestamp

import torch_rpc_node as RN

torch.set_num_threads(1)

HEIGHTS = 6


@pytest.fixture(autouse=True)
def _limit():
    with RN.time_limit(60):
        yield


@pytest.fixture(scope="module")
def chain():
    keys = RN.make_keys(31, 12)
    ch = RN.NodeChain("state-store-chain", keys, 8, BlockStore(PDB.MemDB()), StateStore(PDB.MemDB()),
                      txs_per_block=3, shift_after=2, shift=3, seed=31, device="cpu")
    for _ in range(HEIGHTS):
        ch.advance()
    return ch


def _jax_state(state: State) -> JS.State:
    return JS.State.from_proto(jstate_pb.StateProto.decode(state.bytes()))


def test_state_protos_match_jax(chain):
    for st in chain.states:
        raw = st.bytes()
        jst = _jax_state(st)
        assert jst.bytes() == raw
        back = State.from_proto(pstate_pb.StateProto.decode(jst.bytes()))
        assert back.bytes() == raw
        assert back.copy().bytes() == raw
    assert chain.states[0].is_empty() is False and State(chain_id="x").is_empty()


def test_make_genesis_state_from_one_genesis_json_matches_jax(chain):
    text = chain.genesis.to_json()
    jst = JS.make_genesis_state(JG.GenesisDoc.from_json(text))
    pst = make_genesis_state(T.GenesisDoc.from_json(text))
    assert pst.bytes() == jst.bytes() == chain.states[0].bytes()
    assert pst.last_block_time.unix_ns() == RN.GENESIS_NS and pst.last_validators is None


def _jax_commit(commit):
    return None if commit is None else JB.Commit.from_proto(jpb.Commit.decode(commit.to_proto().encode()))


@pytest.mark.parametrize("h", range(1, HEIGHTS + 1))
def test_make_block_headers_and_hashes_match_jax(chain, h):
    """Height 1 takes the genesis time, later heights the last commit's
    weighted median (the JAX class's second make_block)."""
    st, txs = chain.states[h - 1], chain.blocks[h].data.txs
    last = chain.commits.get(h - 1)
    proposer = st.validators.get_proposer().address
    pb_ = st.make_block(h, txs, last, [], proposer, device="cpu")
    jb_ = _jax_state(st).make_block(h, txs, _jax_commit(last), [], proposer)
    assert pb_.header.to_proto().encode() == jb_.header.to_proto().encode()
    assert pb_.hash() == jb_.hash() == chain.blocks[h].hash()
    assert pb_.encode() == jb_.encode()
    if h == 1:
        assert pb_.header.time.unix_ns() == RN.GENESIS_NS
    else:
        assert pb_.header.time == last.median_time(chain.states[h - 2].validators)


def test_make_block_with_a_proposer_time_and_pbts_matches_jax(chain):
    when = Timestamp.from_unix_ns(RN.GENESIS_NS + 123_456_789)
    for pbts in (0, 1):
        st = chain.states[0].copy()
        st.consensus_params.feature.pbts_enable_height = pbts
        jst = _jax_state(st)
        jst.consensus_params.feature.pbts_enable_height = pbts
        for h, last in ((1, None), (2, chain.commits[1])):
            pb_ = st.make_block(h, [b"tx"], last, [], b"\1" * 20, block_time=when, device="cpu")
            jb_ = jst.make_block(h, [b"tx"], _jax_commit(last), [], b"\1" * 20, block_time=when)
            assert pb_.header.to_proto().encode() == jb_.header.to_proto().encode()
        # at the initial height the proposer's time counts only under PBTS
        got = st.make_block(1, [], None, [], b"\1" * 20, block_time=when, device="cpu").header.time.unix_ns()
        assert got == (when.unix_ns() if pbts else RN.GENESIS_NS)


def _dbs(kind, tmp_path, tag=""):
    if kind == "mem":
        return JDB.MemDB(), PDB.MemDB()
    return JDB.SQLiteDB(str(tmp_path / f"jax{tag}.db")), PDB.SQLiteDB(str(tmp_path / f"port{tag}.db"))


def _replay(chain, kind, tmp_path):
    jdb, pdb = _dbs(kind, tmp_path)
    js, ps = JSS.StateStore(jdb), StateStore(pdb)
    js.save(_jax_state(chain.states[0]))
    ps.save(chain.states[0])
    for h in range(1, HEIGHTS + 1):
        fb = chain.responses[h]
        js.save_finalize_block_response(h, jabci.FinalizeBlockResponse.decode(fb.encode()))
        ps.save_finalize_block_response(h, fb)
        js.save(_jax_state(chain.states[h]))
        ps.save(chain.states[h])
    return jdb, pdb, js, ps


def _contents(db):
    return list(db.iterator(None, None))


@pytest.mark.parametrize("kind", ["mem", "sqlite"])
def test_saved_states_are_byte_for_byte_the_jax_stores(chain, kind, tmp_path):
    jdb, pdb, js, ps = _replay(chain, kind, tmp_path)
    assert _contents(pdb) == _contents(jdb)
    assert _contents(pdb) == _contents(chain.state_store._db)
    assert ps.load().bytes() == js.load().bytes() == chain.state.bytes()
    # the full set is stored only where it changed: at genesis and at 4
    # (the updates of height 2 take effect two heights later)
    full = [h for h in range(1, HEIGHTS + 3)
            if pstate_pb.ValidatorsInfo.decode(pdb.get(b"validatorsKey:" + h.to_bytes(8, "big"))).validator_set]
    assert full == [1, 4]


@pytest.mark.parametrize("kind", ["mem", "sqlite"])
def test_sparse_validators_params_and_responses_match_jax(chain, kind, tmp_path):
    _, _, js, ps = _replay(chain, kind, tmp_path)
    for h in range(0, HEIGHTS + 3):
        pv, jv = ps.load_validators(h), js.load_validators(h)
        assert (pv is None) == (jv is None), h
        if pv is not None:
            assert pv.to_proto().encode() == jv.to_proto().encode(), h
            assert pv.hash(device=False) == jv.hash()
        pp, jp = ps.load_consensus_params(h), js.load_consensus_params(h)
        assert (pp is None) == (jp is None), h
        if pp is not None:
            assert pp.to_proto().encode() == jp.to_proto().encode()
        pr, jr = ps.load_finalize_block_response(h), js.load_finalize_block_response(h)
        assert (None if pr is None else pr.encode()) == (None if jr is None else jr.encode()), h
    # the stored set at each height is the one its block was made with
    for h in range(1, HEIGHTS + 1):
        assert ps.load_validators(h).hash(device=False) == chain.blocks[h].header.validators_hash
        assert ps.load_validators(h + 1).hash(device=False) == chain.blocks[h].header.next_validators_hash
    assert ps.load_validators(4).hash(device=False) != ps.load_validators(3).hash(device=False)


@pytest.mark.parametrize("kind", ["mem", "sqlite"])
def test_prune_states_and_responses_match_jax(chain, kind, tmp_path):
    jdb, pdb, js, ps = _replay(chain, kind, tmp_path)
    assert ps.prune_finalize_block_responses(3) == js.prune_finalize_block_responses(3) == 2
    assert _contents(pdb) == _contents(jdb)
    assert ps.prune_states(4, HEIGHTS) == js.prune_states(4, HEIGHTS)
    assert _contents(pdb) == _contents(jdb)
    assert ps.prune_states(HEIGHTS + 5, 2) == js.prune_states(HEIGHTS + 5, 2)
    assert _contents(pdb) == _contents(jdb)
    assert ps.load_validators(2) is None and ps.load_validators(5) is not None


@pytest.mark.parametrize("kind", ["mem", "sqlite"])
def test_bootstrap_matches_jax(chain, kind, tmp_path):
    jdb, pdb = _dbs(kind, tmp_path, "-boot")
    js, ps = JSS.StateStore(jdb), StateStore(pdb)
    js.bootstrap(_jax_state(chain.states[4]))
    ps.bootstrap(chain.states[4])
    assert _contents(pdb) == _contents(jdb)
    for h in (4, 5, 6):
        assert ps.load_validators(h).to_proto().encode() == js.load_validators(h).to_proto().encode()
    with pytest.raises(ValueError) as ep:
        ps._save_validators_info(3, 4, None)
    with pytest.raises(ValueError) as ej:
        js._save_validators_info(3, 4, None)
    assert str(ep.value) == str(ej.value)


def test_an_empty_store_loads_nothing():
    ps = StateStore(PDB.MemDB())
    assert ps.load() is None and ps.load_validators(1) is None
    assert ps.load_consensus_params(1) is None and ps.load_finalize_block_response(1) is None
    assert np.array_equal([ps.prune_states(3, 5)], [0])
