"""The port's evidence pool and verify() (cometbft_tpu_torch/evidence/
pool.py, verify.py) against the JAX package's over equal stores: one
seeded chain (tests/torch_rpc_node.py's NodeChain) saved into a port
block and state store and, from the same bytes, into the JAX ones.  Each
scenario runs a JAX pool and a port pool: the pools' databases must hold
the same keys and values, pending lists and verdicts must match, and a
refusal must carry the same reason.  The port checks on device="cpu"
(the kernels' plain versions); the JAX side verifies on its host path."""

import threading

import pytest
import torch

from cometbft_tpu.evidence import pool as JPool
from cometbft_tpu.state import state as JS
from cometbft_tpu.state import store as JSS
from cometbft_tpu.store import block_store as JBS
from cometbft_tpu.store import db as JDB
from cometbft_tpu.types import block as JB
from cometbft_tpu.types.evidence import evidence_from_proto as j_evidence_from_proto
from cometbft_tpu.wire import abci_pb as jabci
from cometbft_tpu.wire import state_pb as jstate_pb
from cometbft_tpu.wire import types_pb as jpb

from cometbft_tpu_torch.evidence import (
    ErrInvalidEvidence,
    EvidenceError,
    EvidencePool,
    evidence_from_proto_bytes,
)
from cometbft_tpu_torch.state import StateStore
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.store import db as PDB
from cometbft_tpu_torch.types.evidence import evidence_to_proto

import torch_rpc_node as RN

torch.set_num_threads(1)

HEIGHTS = 6


@pytest.fixture(autouse=True)
def _cpu_backend(cpu_crypto_backend):
    """The JAX side verifies on its host path (conftest.cpu_crypto_backend)."""


@pytest.fixture(autouse=True)
def _limit_and_stop():
    with RN.time_limit(60):
        yield
    from cometbft_tpu_torch.verifysvc import reset_global_service

    reset_global_service()


class Node:
    """A port chain and the JAX stores that hold the same bytes."""

    def __init__(self):
        keys = RN.make_keys(41, 10)
        self.chain = RN.NodeChain("evidence-chain", keys, 8, BlockStore(PDB.MemDB()), StateStore(PDB.MemDB()),
                                  txs_per_block=2, seed=41, device="cpu")
        self.jbs, self.jss = JBS.BlockStore(JDB.MemDB()), JSS.StateStore(JDB.MemDB())
        self.jss.save(jstate(self.chain.states[0]))
        for _ in range(HEIGHTS):
            self.advance()

    def advance(self, evidence=()):
        block = self.chain.advance(evidence=evidence)
        h = block.header.height
        jblk = JB.Block.decode(block.encode())
        self.jbs.save_block(jblk, jblk.make_part_set(),
                            JB.Commit.from_proto(jpb.Commit.decode(self.chain.commits[h].to_proto().encode())))
        self.jss.save_finalize_block_response(h, jabci.FinalizeBlockResponse.decode(self.chain.responses[h].encode()))
        self.jss.save(jstate(self.chain.state))
        return block

    def pools(self):
        pp = EvidencePool(PDB.MemDB(), self.chain.state_store, self.chain.block_store, device="cpu")
        jp = JPool.EvidencePool(JDB.MemDB(), self.jss, self.jbs)
        return jp, pp


def jstate(st):
    return JS.State.from_proto(jstate_pb.StateProto.decode(st.bytes()))


def jev(ev):
    return j_evidence_from_proto(jpb.EvidenceProto.decode(evidence_to_proto(ev).encode()))


def contents(db):
    return list(db.iterator(None, None))


def same_pools(jp, pp):
    assert contents(pp.db) == contents(jp.db)
    assert pp.size() == jp.size()
    for budget in (-1, 0, 10**6):
        got, got_size = pp.pending_evidence(budget)
        want, want_size = jp.pending_evidence(budget)
        assert [e.bytes() for e in got] == [e.bytes() for e in want] and got_size == want_size


@pytest.fixture
def node():
    return Node()


def test_stores_are_equal_and_the_pool_starts_from_the_stored_state(node):
    assert contents(node.chain.block_store._db) == contents(node.jbs._db)
    assert contents(node.chain.state_store._db) == contents(node.jss._db)
    jp, pp = node.pools()
    assert pp.state.bytes() == jp.state.bytes() == node.chain.state.bytes()
    with pytest.raises(EvidenceError, match="without state"):
        EvidencePool(PDB.MemDB(), StateStore(PDB.MemDB()), node.chain.block_store, device="cpu")


def test_check_add_pending_update_and_commit_match_jax(node):
    jp, pp = node.pools()
    dve = node.chain.duplicate_vote(3, index=1)
    lca = node.chain.lunatic(2, 4)
    for pool, evs in ((jp, [jev(dve), jev(lca)]), (pp, [dve, lca])):
        pool.check_evidence(evs)
    same_pools(jp, pp)
    assert pp.is_pending(dve) and pp.is_pending(lca) and pp.size() == 2
    # added again: already pending, nothing changes
    pp.add_evidence(dve)
    jp.add_evidence(jev(dve))
    same_pools(jp, pp)
    seq = pp.add_seq()
    # a duplicate in one block's list is refused
    for pool, ev in ((jp, jev(dve)), (pp, dve)):
        with pytest.raises(Exception) as e:
            pool.check_evidence([ev, ev])
        assert "duplicate evidence in block" in str(e.value)
    # the next block carries both; the update moves them to committed
    block = node.advance(evidence=[dve, lca])
    pp.update(node.chain.state, block.evidence)
    jp.update(jstate(node.chain.state), [jev(dve), jev(lca)])
    same_pools(jp, pp)
    assert pp.is_committed(dve) and not pp.is_pending(dve) and pp.size() == 0
    for pool, ev in ((jp, jev(lca)), (pp, lca)):
        with pytest.raises(Exception) as e:
            pool.check_evidence([ev])
        assert "already committed" in str(e.value)
    # committed evidence gossiped again is dropped quietly
    pp.add_evidence(dve)
    assert pp.size() == 0 and pp.add_seq() == seq
    for pool, st in ((jp, jstate(node.chain.state)), (pp, node.chain.state)):
        with pytest.raises(Exception) as e:
            pool.update(st, [])
        assert f"<= {HEIGHTS + 1}" in str(e.value)


def test_consensus_buffer_and_pruning_match_jax(node):
    jp, pp = node.pools()
    # conflicting votes reported by consensus, at the last height and an older one
    for h in (HEIGHTS, 4):
        dve = node.chain.duplicate_vote(h, index=2, tag=b"buf%d" % h)
        pp.report_conflicting_votes(dve.vote_a, dve.vote_b)
        j = jev(dve)
        jp.report_conflicting_votes(j.vote_a, j.vote_b)
    node.advance()
    pp.update(node.chain.state, [])
    jp.update(jstate(node.chain.state), [])
    same_pools(jp, pp)
    assert pp.size() == 2
    # that update set the next pruning height past the evidence's age
    assert (pp.pruning_height, pp.pruning_time_ns) == (jp.pruning_height, jp.pruning_time_ns) != (0, 0)
    # fresh pools with evidence pending; the next height's params age it out: the update prunes
    jp, pp = node.pools()
    dve = node.chain.duplicate_vote(3, tag=b"prune")
    pp.add_evidence(dve)
    jp.add_evidence(jev(dve))
    node.advance()
    st = node.chain.state.copy()
    st.consensus_params.evidence.max_age_num_blocks = 1
    st.consensus_params.evidence.max_age_duration_ns = 1
    pp.update(st, [])
    jp.update(jstate(st), [])
    same_pools(jp, pp)
    assert pp.size() == 0 and (pp.pruning_height, pp.pruning_time_ns) == (jp.pruning_height, jp.pruning_time_ns)
    assert not pp.is_pending(dve)


def _reason(pool, ev):
    with pytest.raises(Exception) as e:
        pool.add_evidence(ev)
    assert type(e.value).__name__ == "ErrInvalidEvidence"
    return type(e.value.reason).__name__, str(e.value.reason)


def test_verify_refusals_match_jax(node):
    jp, pp = node.pools()
    cases = {}
    # a missing header: evidence above the store
    cases["missing header"] = node.chain.duplicate_vote(3, tag=b"missing")
    cases["missing header"].vote_a.height = cases["missing header"].vote_b.height = 40
    # a time that is not the block's
    dve = node.chain.duplicate_vote(3, tag=b"time")
    dve.timestamp = node.chain.blocks[2].header.time
    cases["time mismatch"] = dve
    # a tampered signature and a wrong power
    bad_sig = node.chain.duplicate_vote(3, tag=b"sig")
    bad_sig.vote_b.signature = bytes(64)
    cases["bad signature"] = bad_sig
    bad_power = node.chain.duplicate_vote(3, tag=b"power")
    bad_power.validator_power += 1
    cases["wrong power"] = bad_power
    # a forward lunatic: the top has only its seen commit, so there is no
    # signed header to fall back to (as in the JAX package and the reference)
    cases["forward lunatic"] = node.chain.lunatic(3, HEIGHTS + 5)
    lca = node.chain.lunatic(2, 4)
    lca.byzantine_validators = lca.byzantine_validators[1:]
    cases["byzantine list"] = lca
    seen = {}
    for what, ev in cases.items():
        got, want = _reason(pp, ev), _reason(jp, jev(ev))
        assert got == want, what
        seen[what] = got[1]
    assert seen["missing header"] == "no header at evidence height 40"
    assert "differs from block time" in seen["time mismatch"]
    assert seen["forward lunatic"] == f"no header/commit at height {HEIGHTS}"
    assert seen["bad signature"] == "invalid signature on vote B"
    assert seen["byzantine list"] == "byzantine validator list does not match the evidence"
    same_pools(jp, pp)
    assert pp.size() == 0


class TopCommitReadable:
    """A block store whose top height's commit reads as its seen commit:
    the forward lunatic's fallback to the latest header then has one."""

    def __init__(self, store):
        self.store = store
        self.height = store.height

    def load_block_meta(self, h):
        return self.store.load_block_meta(h)

    def load_block_commit(self, h):
        return self.store.load_block_commit(h) or (self.store.load_seen_commit(h) if h == self.height else None)


def test_forward_lunatic_time_checks_match_jax(node):
    pp = EvidencePool(PDB.MemDB(), node.chain.state_store, TopCommitReadable(node.chain.block_store), device="cpu")
    jp = JPool.EvidencePool(JDB.MemDB(), node.jss, TopCommitReadable(node.jbs))
    latest_ns = node.chain.blocks[HEIGHTS].header.time.unix_ns()
    late = node.chain.lunatic(3, HEIGHTS + 5, time_ns=latest_ns + RN.NS)
    got, want = _reason(pp, late), _reason(jp, jev(late))
    assert got == want and "is before conflicting block time" in got[1]
    # a forward lunatic no later than our latest block breaks monotonic time: it is evidence
    in_order = node.chain.lunatic(3, HEIGHTS + 5, time_ns=latest_ns)
    pp.add_evidence(in_order)
    jp.add_evidence(jev(in_order))
    same_pools(jp, pp)
    assert pp.is_pending(in_order) and pp.size() == 1


def test_expiry_matches_jax(node):
    jp, pp = node.pools()
    dve = node.chain.duplicate_vote(2, tag=b"old")
    for pool in (jp, pp):
        pool.state.consensus_params.evidence.max_age_num_blocks = 1
        pool.state.consensus_params.evidence.max_age_duration_ns = 1
    got, want = _reason(pp, dve), _reason(jp, jev(dve))
    assert got == want and "is too old" in got[1]


def test_evidence_bytes_and_the_wait_for_new_evidence(node):
    jp, pp = node.pools()
    dve = node.chain.duplicate_vote(3, tag=b"wait")
    raw = evidence_to_proto(dve).encode()
    assert evidence_from_proto_bytes(raw).bytes() == jev(dve).bytes() == dve.bytes()
    seq = pp.add_seq()
    woke = []
    t = threading.Thread(target=lambda: woke.append(pp.wait_new_evidence(seq, timeout=20)))
    t.start()
    pp.add_evidence(dve)
    t.join(timeout=20)
    assert not t.is_alive() and woke == [seq + 1]
    assert pp.wait_new_evidence(seq + 1, timeout=0.01) == seq + 1
    assert isinstance(ErrInvalidEvidence(dve, "x"), EvidenceError)
