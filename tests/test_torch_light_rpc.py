"""The port's light-client RPC front (cometbft_tpu_torch/light/rpc.py,
rpc/serializers.py, rpc/client.py) against the JAX package's, over one
loopback JSON-RPC node (tests/torch_rpc_node.py) that serves a port
chain of 250 validators (three pages of /validators a light block):
the JSON decoders and serializers, HTTPProvider, VerifyingClient with
its refusals, abci_query on the JAX kvstore's proofs, and LightProxy.
Each case runs the port and the JAX package against the same node and
must read the same blocks, JSON, verdicts and error messages.  The port
runs on device="cpu" (the kernels' plain versions)."""

import base64
import json

import numpy as np
import pytest
import torch

from cometbft_tpu import light as jlight
from cometbft_tpu.abci.kvstore import KVStoreApplication
from cometbft_tpu.light import rpc as JR
from cometbft_tpu.rpc import client as JC
from cometbft_tpu.rpc import serializers as JS
from cometbft_tpu.store.db import MemDB as JMemDB
from cometbft_tpu.types import block as JB
from cometbft_tpu.types.validators import ValidatorSet as JValidatorSet
from cometbft_tpu.wire import abci_pb as jabci
from cometbft_tpu.wire import types_pb as jpb

from cometbft_tpu_torch import light as plight
from cometbft_tpu_torch import types as T
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.evidence import EvidencePool
from cometbft_tpu_torch.light import rpc as PR
from cometbft_tpu_torch.rpc import HTTPClient, RPCClientError
from cometbft_tpu_torch.rpc import serializers as PS
from cometbft_tpu_torch.state import StateStore
from cometbft_tpu_torch.store import BlockStore, MemDB
from cometbft_tpu_torch.wire.canonical import Timestamp

import torch_rpc_node as RN

torch.set_num_threads(1)

CHAIN_ID = "light-rpc-chain"
V = 250  # three pages of 100
HEIGHTS = 5
PERIOD_NS = 10**18
NOW_NS = RN.GENESIS_NS + 3600 * RN.NS
KV_HEIGHTS = 4  # the kvstore runs blocks 1..4; header 5 carries its app hash after block 4


@pytest.fixture(autouse=True)
def _cpu_backend(cpu_crypto_backend):
    """The JAX side verifies on its host path (conftest.cpu_crypto_backend)."""


@pytest.fixture(autouse=True)
def _limit_and_stop():
    with RN.time_limit(60):
        yield
    from cometbft_tpu_torch.verifysvc import reset_global_service

    reset_global_service()


class KV:
    """The JAX kvstore with merkle state, run block by block beside the
    chain; answers abci_query as the JAX route shapes it."""

    def __init__(self, merkle_state=True):
        self.app = KVStoreApplication(merkle_state=merkle_state)

    def app_hash(self, h: int) -> bytes:
        if h > KV_HEIGHTS:
            return T.tx_hash(b"after the kvstore")
        txs = [b"key%d=value%d-%d" % (i, i, h) for i in range(3)] + [b"h%d=%d" % (h, h)]
        resp = self.app.finalize_block(jabci.FinalizeBlockRequest(height=h, txs=txs))
        self.app.commit(jabci.CommitRequest())
        return resp.app_hash

    def query(self, path, data, height, prove):
        resp = self.app.query(jabci.QueryRequest(path=path, data=data, height=height, prove=prove))
        ops = None
        if resp.proof_ops is not None and resp.proof_ops.ops:
            ops = {"ops": [{"type": op.type, "key": JS.b64(op.key), "data": JS.b64(op.data)}
                           for op in resp.proof_ops.ops]}
        return {"response": {"code": resp.code, "log": resp.log, "key": JS.b64(resp.key),
                             "value": JS.b64(resp.value), "proof_ops": ops, "height": str(resp.height)}}


@pytest.fixture(scope="module")
def world():
    """The chain, its stores and the kvstore beside it; the node is made per test."""
    kv = KV()
    keys = RN.make_keys(51, V + 20)
    bs, ss = BlockStore(MemDB()), StateStore(MemDB())
    chain = RN.NodeChain(CHAIN_ID, keys, V, bs, ss, txs_per_block=6, shift_after=2, shift=20, seed=51,
                         device="cpu", app_hash_fn=kv.app_hash)
    for _ in range(HEIGHTS):
        chain.advance()
    return chain, kv


@pytest.fixture
def node(world):
    chain, kv = world
    n = RN.RPCNode(chain.block_store, chain.state_store, device="cpu", abci_query=kv.query)
    n.start()
    try:
        yield n
    finally:
        n.stop()


def jax_block(chain, h):
    return JB.Block.decode(chain.blocks[h].encode())


def jax_set(vals):
    return JValidatorSet.from_proto(jpb.ValidatorSet.decode(vals.to_proto().encode()))


# ---------------------------------------------------------- JSON shapes


def test_serializers_print_the_jax_json(world):
    chain, _ = world
    for h in range(1, HEIGHTS + 1):
        pb_, jb_ = chain.blocks[h], jax_block(chain, h)
        assert json.dumps(PS.block_json(pb_)) == json.dumps(JS.block_json(jb_))
        assert json.dumps(PS.header_json(pb_.header)) == json.dumps(JS.header_json(jb_.header))
        assert json.dumps(PS.block_id_json(pb_.header.last_block_id)) == json.dumps(
            JS.block_id_json(jb_.header.last_block_id))
        jc = JB.Commit.from_proto(jpb.Commit.decode(chain.commits[h].to_proto().encode()))
        assert json.dumps(PS.commit_json(chain.commits[h])) == json.dumps(JS.commit_json(jc))
        vals = chain.states[h - 1].validators
        assert [PS.validator_json(v) for v in vals.validators] == [
            JS.validator_json(v) for v in jax_set(vals).validators]
    # absent signatures (null, the zero time), nanoseconds, results and events
    cs = T.CommitSig.absent()
    jcs = JB.CommitSig.absent()
    assert PS.commit_sig_json(cs) == JS.commit_sig_json(jcs)
    assert PS.commit_sig_json(cs)["timestamp"] == "0001-01-01T00:00:00Z"
    for ns in (0, 1, 999_999_999, 1_760_000_000 * 10**9 + 5):
        assert PS.ts_json(Timestamp.from_unix_ns(ns)) == JS.ts_json(JB.Timestamp.from_unix_ns(ns))
    assert PS.ts_json(None) == JS.ts_json(None)
    from cometbft_tpu_torch.wire import abci as pabci

    res = pabci.ExecTxResult(code=3, data=b"d", log="l", gas_wanted=5, gas_used=4, codespace="c", events=[
        pabci.Event(type="app", attributes=[pabci.EventAttribute(key="k", value="v", index=True)])])
    jres = jabci.ExecTxResult.decode(res.encode())
    assert PS.tx_result_json(res) == JS.tx_result_json(jres)
    assert PS.events_json(res.events) == JS.events_json(jres.events)


def test_decoders_on_the_jax_json_give_the_jax_hashes(world):
    chain, _ = world
    for h in range(1, HEIGHTS + 1):
        jb_ = jax_block(chain, h)
        hdr = PR.header_from_json(json.loads(json.dumps(JS.header_json(jb_.header))))
        assert hdr.hash() == jb_.hash() and hdr.to_proto().encode() == jb_.header.to_proto().encode()
        jc = JB.Commit.from_proto(jpb.Commit.decode(chain.commits[h].to_proto().encode()))
        commit = PR.commit_from_json(JS.commit_json(jc))
        assert commit.hash() == jc.hash() and commit.to_proto().encode() == jc.to_proto().encode()
        bid = PR.block_id_from_json(JS.block_id_json(jc.block_id))
        assert bid.to_proto().encode() == jc.block_id.to_proto().encode()
        jvals = jax_set(chain.states[h - 1].validators)
        vals = PR.validator_set_from_json([JS.validator_json(v) for v in jvals.validators])
        assert vals.hash(device="cpu") == jvals.hash() == jb_.header.validators_hash
        assert [(v.address, v.voting_power, v.proposer_priority) for v in vals.validators] == [
            (v.address, v.voting_power, v.proposer_priority) for v in jvals.validators]


@pytest.mark.parametrize("text", [
    "0001-01-01T00:00:00Z", "1-01-01T00:00:00Z", "2025-10-09T08:53:20Z", "2025-10-09T08:53:20.000000001Z",
    "2025-10-09T08:53:20.5Z", "1970-01-01T00:00:00.123456789Z",
])
def test_rfc3339_timestamps_parse_as_the_jax_decoder_and_round_trip(text):
    got, want = PR._ts_from_rfc3339(text), JR._ts_from_rfc3339(text)
    assert (got.seconds, got.nanos) == (want.seconds, want.nanos)
    if not text.startswith(("0001", "1-")):
        assert PR._ts_from_rfc3339(PS.ts_json(got)).unix_ns() == got.unix_ns()


# ------------------------------------------------------------- provider


def _providers(addr):
    return (PR.HTTPProvider(CHAIN_ID, HTTPClient(addr, timeout=5), device="cpu"),
            JR.HTTPProvider(CHAIN_ID, JC.HTTPClient(addr, timeout=5)))


def test_http_provider_pages_and_gives_the_jax_light_blocks(world, node):
    chain, _ = world
    pp, jp = _providers(node.addr)
    for h in (1, 3, HEIGHTS, 0):
        before = node.calls.get("validators", 0)
        got, want = pp.light_block(h), jp.light_block(h)
        assert node.calls["validators"] - before == 6  # 3 pages each
        assert got.to_proto().encode() == want.to_proto().encode()
        assert got.height == (h or HEIGHTS) and got.hash == chain.blocks[h or HEIGHTS].hash()
        assert len(got.validator_set.validators) == V
    # the top is served with its seen commit, the rest with the commit the next block carries
    assert node.commit(HEIGHTS)["canonical"] is False and node.commit(HEIGHTS - 1)["canonical"] is True
    assert pp.light_block(HEIGHTS).signed_header.commit.to_proto().encode() == \
        chain.commits[HEIGHTS].to_proto().encode()
    # what the block store's provider serves, but for the proposer (no JSON field carries it)
    store = plight.BlockStoreProvider(CHAIN_ID, chain.block_store, chain.state_store, device="cpu")
    for h in range(1, HEIGHTS):
        a, b = pp.light_block(h), store.light_block(h)
        assert a.signed_header.to_proto().encode() == b.signed_header.to_proto().encode()
        assert [v.to_proto().encode() for v in a.validator_set.validators] == [
            v.to_proto().encode() for v in b.validator_set.validators]
    assert pp.consensus_params(2).to_proto().encode() == jp.consensus_params(2).to_proto().encode()
    for prov, errs in ((pp, plight), (jp, jlight)):
        with pytest.raises(errs.ErrHeightTooHigh):
            prov.light_block(HEIGHTS + 1)


def test_http_provider_refusals_match_jax(world, node):
    chain, _ = world
    pp, jp = _providers(node.addr)
    # a set that does not hash to the header's: a page short
    node.answers["validators"] = lambda **p: {**node.validators(**p), "total": "200"} if int(p["page"]) < 2 \
        else {**node.validators(**p), "validators": [], "total": "200"}
    errs = []
    for prov, mod in ((pp, plight), (jp, jlight)):
        with pytest.raises(mod.ErrBadLightBlock) as e:
            prov.light_block(2)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    node.answers.clear()
    # a route error other than the height's
    node.answers["commit"] = lambda **p: (_ for _ in ()).throw(RN.RPCError(-32603, "no commit for height 2"))
    for prov, mod in ((pp, plight), (jp, jlight)):
        with pytest.raises(mod.ErrLightBlockNotFound):
            prov.light_block(2)


def test_report_evidence_reaches_the_node_pool(world):
    chain, _ = world
    pool = EvidencePool(MemDB(), chain.state_store, chain.block_store, device="cpu")
    n = RN.RPCNode(chain.block_store, chain.state_store, device="cpu", evidence_pool=pool)
    n.start()
    try:
        pp, jp = _providers(n.addr)
        ev = chain.duplicate_vote(2, tag=b"report")
        pp.report_evidence(ev)
        assert pool.is_pending(ev) and n.calls["broadcast_evidence"] == 1
        # the JAX provider hands its JSON encoder the evidence object: the report never leaves
        from cometbft_tpu.types.evidence import evidence_from_proto
        from cometbft_tpu_torch.types.evidence import evidence_to_proto

        jp.report_evidence(evidence_from_proto(jpb.EvidenceProto.decode(evidence_to_proto(ev).encode())))
        assert n.calls["broadcast_evidence"] == 1 and pool.size() == 1
    finally:
        n.stop()


# ------------------------------------------------------ verifying client


def _clients(addr, chain):
    opts = (PERIOD_NS, 1, chain.blocks[1].hash())
    pp, jp = _providers(addr)
    pw, jw = _providers(addr)
    plc = plight.Client(CHAIN_ID, plight.TrustOptions(*opts), pp, [pw], plight.LightStore(MemDB()),
                        now_fn=lambda: NOW_NS, device="cpu")
    jlc = jlight.Client(CHAIN_ID, jlight.TrustOptions(*opts), jp, [jw], jlight.LightStore(JMemDB()),
                        now_fn=lambda: NOW_NS)
    return (PR.VerifyingClient(HTTPClient(addr, timeout=5), plc, next_header_timeout=2),
            JR.VerifyingClient(JC.HTTPClient(addr, timeout=5), jlc, next_header_timeout=2))


def _same_refusal(pvc, jvc, call):
    with pytest.raises(Exception) as ep:
        call(pvc)
    with pytest.raises(Exception) as ej:
        call(jvc)
    assert (type(ep.value).__name__, str(ep.value)) == (type(ej.value).__name__, str(ej.value))
    return str(ep.value)


def test_verifying_client_accepts_an_honest_node_as_jax(world, node):
    chain, _ = world
    pvc, jvc = _clients(node.addr, chain)
    for h in (2, HEIGHTS, 0):
        assert pvc.block(h) == jvc.block(h)
        assert pvc.commit(h) == jvc.commit(h)
    assert pvc.validators(3) == jvc.validators(3)
    assert int(pvc.validators(3)["count"]) == V
    tx = chain.blocks[3].data.txs[4]
    got = pvc.tx(T.tx_hash(tx).hex())
    assert got == jvc.tx(T.tx_hash(tx).hex()) and base64.b64decode(got["tx"]) == tx
    got = pvc.data_proof(3, 4)
    assert got == jvc.data_proof(3, 4)
    assert base64.b64decode(got["proofs"][0]["leaf_hash"]) == merkle.leaf_hash(T.tx_hash(tx))
    assert pvc.status() == jvc.status()


def test_verifying_client_refuses_a_forged_block_a_wrong_index_and_garbage(world, node):
    chain, _ = world
    pvc, jvc = _clients(node.addr, chain)
    forged = T.Block.decode(chain.blocks[3].encode())
    forged.data = T.Data(forged.data.txs + [b"forged"])
    forged.header.data_hash = b""
    forged.fill_header(device="cpu")
    node.forged[3] = forged
    msg = _same_refusal(pvc, jvc, lambda vc: vc.block(3))
    assert msg.startswith("block 3: header hash")
    tx = chain.blocks[3].data.txs[1]
    _same_refusal(pvc, jvc, lambda vc: vc.tx(T.tx_hash(tx).hex()))  # the forged block's txs
    node.forged.clear()
    node.answers["tx"] = lambda **p: {**node.tx(**p), "index": 2}
    assert _same_refusal(pvc, jvc, lambda vc: vc.tx(T.tx_hash(tx).hex())) == "tx not at claimed index"
    node.answers.clear()
    honest = node.merkle_proof(height=3, indices="2")
    garbage = {
        "bad hex": {**honest, "root_hash": "zz"},
        "two rows": {**honest, "proofs": honest["proofs"] * 2},
        "another index": {**honest, "proofs": [{**honest["proofs"][0], "index": "3"}]},
        "another root": {**honest, "root_hash": "AB" * 32},
        "a bad aunt": {**honest, "proofs": [{**honest["proofs"][0],
                                              "aunts": [PS.b64(b"\0" * 32)] + honest["proofs"][0]["aunts"][1:]}]},
        "not base64": {**honest, "proofs": [{**honest["proofs"][0], "leaf_hash": "!!"}]},
        "no proofs": {k: v for k, v in honest.items() if k != "proofs"},
    }
    msgs = {}
    for what, answer in garbage.items():
        node.answers["merkle_proof"] = lambda answer=answer, **p: answer
        msgs[what] = _same_refusal(pvc, jvc, lambda vc: vc.data_proof(3, 2))
        assert msgs[what].startswith("data_proof"), what
    assert "malformed response" in msgs["bad hex"] and msgs["two rows"] == "data_proof: expected 1 proof, got 2"


def test_abci_query_accepts_a_verified_proof_and_fails_closed(world, node):
    chain, kv = world
    pvc, jvc = _clients(node.addr, chain)
    got = pvc.abci_query("", b"key1")
    assert got == jvc.abci_query("", b"key1")
    assert base64.b64decode(got["response"]["value"]) == b"value1-%d" % KV_HEIGHTS
    assert int(got["response"]["height"]) == KV_HEIGHTS
    # the proven root is header 5's app hash
    assert chain.blocks[KV_HEIGHTS + 1].header.app_hash == kv.app._state_root()
    cases = {
        "absent key": lambda vc: vc.abci_query("", b"nope"),
    }
    for what, call in cases.items():
        assert "empty value" in _same_refusal(pvc, jvc, call), what
    honest = kv.query("", b"key2", 0, True)
    bad = {
        "no proof": {"response": {**honest["response"], "proof_ops": None}},
        "tampered value": {"response": {**honest["response"], "value": PS.b64(b"value2-9")}},
        "app error": {"response": {**honest["response"], "code": 7, "log": "boom"}},
        "no height": {"response": {**honest["response"], "height": "0"}},
        "unknown op": {"response": {**honest["response"], "proof_ops": {"ops": [
            {**honest["response"]["proof_ops"]["ops"][0], "type": "ics23:iavl"}]}}},
        "garbage op": {"response": {**honest["response"], "proof_ops": {"ops": [
            {**honest["response"]["proof_ops"]["ops"][0], "data": "%%"}]}}},
        "no next header": {"response": {**honest["response"], "height": str(HEIGHTS)}},
    }
    msgs = {}
    for what, answer in bad.items():
        node.answers["abci_query"] = lambda answer=answer, **p: answer
        msgs[what] = _same_refusal(pvc, jvc, lambda vc: vc.abci_query("", b"key2"))
    assert "fail closed" in msgs["no proof"] and "proof invalid" in msgs["tampered value"]
    assert msgs["app error"] == "abci_query failed: code=7 log='boom'"
    assert "header 6 unavailable" in msgs["no next header"]


def test_abci_query_on_a_kvstore_without_proofs_fails_closed(world, node):
    chain, _ = world
    plain = KV(merkle_state=False)
    for h in range(1, KV_HEIGHTS + 1):
        plain.app_hash(h)
    node.abci_query_fn = plain.query
    pvc, jvc = _clients(node.addr, chain)
    assert "fail closed" in _same_refusal(pvc, jvc, lambda vc: vc.abci_query("", b"key1"))


# ----------------------------------------------------------------- proxy


def test_light_proxy_serves_the_verified_json(world, node):
    chain, _ = world
    pvc, _ = _clients(node.addr, chain)
    proxy = PR.LightProxy(pvc)
    proxy.start("127.0.0.1:0")
    try:
        c = HTTPClient(proxy.listen_addr, timeout=5)
        assert c.call("block", height=2) == pvc.block(2)
        assert c.call("validators", height=2) == pvc.validators(2)
        tx = chain.blocks[2].data.txs[0]
        assert c.call("tx", hash=T.tx_hash(tx).hex()) == pvc.tx(T.tx_hash(tx).hex())
        assert c.call("data_proof", height=2, index=1) == pvc.data_proof(2, 1)
        assert c.call("abci_query", path="", data=b"key0") == pvc.abci_query("", b"key0")
        assert c.call("status") == pvc.status()
        with pytest.raises(RPCClientError, match="method not found"):
            c.call("dial_peers")
        forged = T.Block.decode(chain.blocks[2].encode())
        forged.header.app_hash = b"\1" * 32
        node.forged[2] = forged
        with pytest.raises(RPCClientError, match="header hash"):
            c.call("block", height=2)
    finally:
        proxy.stop()


def test_http_client_errors_and_timeouts():
    assert HTTPClient("tcp://127.0.0.1:1").base == "http://127.0.0.1:1"
    with pytest.raises(OSError):
        HTTPClient("127.0.0.1:1", timeout=2).status()
    np.testing.assert_equal(JC.HTTPClient("x:1", timeout=3).timeout, HTTPClient("x:1", timeout=3).timeout)
