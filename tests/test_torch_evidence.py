"""The port's evidence (cometbft_tpu_torch/types/evidence.py) and its
verification (cometbft_tpu_torch/evidence/verify.py) against the JAX
package's: the attack evidence a detector builds on a seeded fork,
carried across as bytes, byte-equal and hash-equal; the same passes and
refusals (class and message) of verify_light_client_attack,
verify_duplicate_vote and is_evidence_expired on the same inputs; the
class under which the checks reach the verifier factory.  The port runs
with device="cpu"; the JAX side verifies on its host path."""

import copy
import itertools
from types import SimpleNamespace

import pytest
import torch

from cometbft_tpu.crypto import hash as jtmhash
from cometbft_tpu.evidence import verify as jverify
from cometbft_tpu.light import detector as jdet
from cometbft_tpu.types import evidence as jev
from cometbft_tpu.types.block import BlockID as JBlockID
from cometbft_tpu.types.block import PartSetHeader as JPartSetHeader
from cometbft_tpu.types.validators import Validator as JValidator
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu.wire.canonical import Timestamp as JTimestamp

from cometbft_tpu_torch import convert
from cometbft_tpu_torch.evidence import verify as pverify
from cometbft_tpu_torch.light import detector as pdet
from cometbft_tpu_torch.types import evidence as pev

import torch_light_chain as LC

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_backend(cpu_crypto_backend):
    """The JAX side verifies on its host path (conftest.cpu_crypto_backend)."""


@pytest.fixture(autouse=True)
def _stop_services():
    yield
    from cometbft_tpu_torch.verifysvc import reset_global_service

    reset_global_service()


# a lunatic fork: the sets at 1 and 34 share half their keys, and the fork starts at 20
HONEST = LC.Chain(40, rotate_every=15)
FORKED = LC.Chain(40, rotate_every=15, fork_from=20)
COMMON, CONFLICT = 1, 34


def _attack(side):
    """The evidence a detector builds against the primary: the forked
    block at 34 over the common block at 1, trusted honest block 34."""
    get = (lambda c, h: c.jax(h)) if side == "jax" else (lambda c, h: c.port(h))
    det = jdet if side == "jax" else pdet
    return det._new_attack_evidence(get(FORKED, CONFLICT), get(HONEST, CONFLICT), get(HONEST, COMMON))


def test_attack_evidence_is_the_jax_evidence():
    j, p = _attack("jax"), _attack("port")
    raw = j.to_proto().encode()
    assert p.to_proto().encode() == raw and p.hash() == j.hash() and p.bytes() == j.bytes()
    assert p.common_height == COMMON and p.total_voting_power == 40
    assert [v.address for v in p.byzantine_validators] == [v.address for v in j.byzantine_validators]
    assert len(p.byzantine_validators) == 2  # the common set's members that signed the fork
    wrapped = jev.evidence_to_proto(j).encode()
    assert pev.evidence_to_proto(p).encode() == wrapped
    back = convert.evidence(wrapped)
    assert back.to_proto().encode() == raw and back.hash() == j.hash() and back == p
    assert LC.outcome(p.validate_basic) == LC.outcome(j.validate_basic) == ("ok", None)


def _lca_case(case, side):
    """(evidence, common_sh, trusted_sh, common_vals) of one case."""
    get = (lambda c, h: c.jax(h)) if side == "jax" else (lambda c, h: c.port(h))
    ev = copy.deepcopy(_attack(side))
    common, trusted = get(HONEST, COMMON), get(HONEST, CONFLICT)
    cvals = common.validator_set
    if case == "power+1":
        ev.total_voting_power += 1
    elif case == "byzantine-dropped":
        ev.byzantine_validators = ev.byzantine_validators[:-1]
    elif case == "byzantine-power":
        ev.byzantine_validators[0] = ev.byzantine_validators[0].copy()
        ev.byzantine_validators[0].voting_power += 1
    elif case == "wrong-common-set":
        cvals = get(HONEST, 40).validator_set  # keys 2-5: too little of it signed
    elif case == "forged-signature":
        for cs in ev.conflicting_block.signed_header.commit.signatures[:2]:
            cs.signature = bytes(64)
    elif case == "conflict-is-the-trusted-block":
        ev.conflicting_block = copy.deepcopy(trusted)
    elif case == "common-at-conflict-height":
        common = get(HONEST, CONFLICT)
        cvals = common.validator_set
    elif case == "equivocation-at-common-height":
        ev = (jdet if side == "jax" else pdet)._new_attack_evidence(
            get(FORKED, 25), get(HONEST, 25), get(HONEST, 25))
        common = trusted = get(HONEST, 25)
        cvals = common.validator_set
    return ev, common.signed_header, trusted.signed_header, cvals


LCA_CASES = ["ok", "power+1", "byzantine-dropped", "byzantine-power", "wrong-common-set", "forged-signature",
             "conflict-is-the-trusted-block", "common-at-conflict-height", "equivocation-at-common-height"]


@pytest.mark.parametrize("case", LCA_CASES)
def test_verify_light_client_attack_matches_jax(case):
    j = _lca_case(case, "jax")
    p = _lca_case(case, "port")
    want = LC.outcome(lambda: jverify.verify_light_client_attack(*j, LC.CHAIN_ID))
    got = LC.outcome(lambda: pverify.verify_light_client_attack(*p, LC.CHAIN_ID, device="cpu"))
    assert got == want
    assert (got == ("ok", None)) == (case == "ok")


def _votes(i=3, h=10, r=0):
    """Two precommits of KEYS[i] at one height and round, for two blocks."""
    out = []
    for tag in (b"A", b"B"):
        bid = JBlockID(hash=jtmhash.sum(tag), part_set_header=JPartSetHeader(1, jtmhash.sum(tag + b"p")))
        v = JVote(type=2, height=h, round=r, block_id=bid, timestamp=JTimestamp(seconds=1_700_000_000, nanos=5),
                  validator_address=LC.KEYS[i].pub_key().address(), validator_index=i)
        v.signature = LC.KEYS[i].sign(v.sign_bytes(LC.CHAIN_ID))
        out.append(v)
    return out


def _dve_case(case):
    vals = HONEST.jax(1).validator_set  # keys 0-3, power 10 each
    a, b = _votes(i=2)
    ev = jev.DuplicateVoteEvidence.from_votes(a, b, JTimestamp(seconds=1_700_000_100), vals)
    if case == "not-a-validator":
        a, b = _votes(i=9)
        ev.vote_a, ev.vote_b = (a, b) if a.block_id.key() < b.block_id.key() else (b, a)
    if case == "validator-power":
        ev.validator_power = 11
    elif case == "total-power":
        ev.total_voting_power = 41
    elif case == "same-block":
        ev.vote_b = copy.deepcopy(ev.vote_a)
    elif case == "other-round":
        ev.vote_b.round = 1
    elif case == "bad-signature-a":
        ev.vote_a.signature = bytes(64)
    elif case == "bad-signature-b":
        ev.vote_b.signature = ev.vote_a.signature
    elif case == "other-validator":
        ev.vote_b.validator_address = LC.KEYS[1].pub_key().address()
    return ev, vals


DVE_CASES = ["ok", "validator-power", "total-power", "same-block", "other-round", "bad-signature-a",
             "bad-signature-b", "other-validator", "not-a-validator"]


@pytest.mark.parametrize("case", DVE_CASES)
def test_verify_duplicate_vote_matches_jax(case):
    ev, vals = _dve_case(case)
    raw = ev.to_proto().encode()
    pe = convert.evidence(jev.evidence_to_proto(ev).encode())
    assert pe.to_proto().encode() == raw and pe.hash() == ev.hash()
    pvals = convert.light_block(HONEST.jax(1).to_proto().encode()).validator_set
    want = LC.outcome(lambda: jverify.verify_duplicate_vote(ev, LC.CHAIN_ID, vals))
    got = LC.outcome(lambda: pverify.verify_duplicate_vote(pe, LC.CHAIN_ID, pvals))
    assert got == want
    assert (got == ("ok", None)) == (case == "ok")
    assert LC.outcome(pe.validate_basic) == LC.outcome(ev.validate_basic)


def test_duplicate_vote_evidence_from_votes_matches_jax():
    a, b = _votes(i=1)
    vals = HONEST.jax(1).validator_set
    pvals = convert.light_block(HONEST.jax(1).to_proto().encode()).validator_set
    t = JTimestamp(seconds=1_700_000_200)
    pa, pb_ = (convert.evidence(jev.evidence_to_proto(jev.DuplicateVoteEvidence(v, v)).encode()).vote_a
               for v in (a, b))
    from cometbft_tpu_torch.wire.canonical import Timestamp as PTimestamp

    for x, y, px, py in ((a, b, pa, pb_), (b, a, pb_, pa)):
        j = jev.DuplicateVoteEvidence.from_votes(x, y, t, vals)
        p = pev.DuplicateVoteEvidence.from_votes(px, py, PTimestamp(seconds=t.seconds), pvals)
        assert p.to_proto().encode() == j.to_proto().encode()
    lst = [_attack("jax"), jev.DuplicateVoteEvidence.from_votes(a, b, t, vals)]
    plst = [convert.evidence(jev.evidence_to_proto(e).encode()) for e in lst]
    assert pev.evidence_list_hash(plst) == jev.evidence_list_hash(lst)
    assert pev.evidence_list_hash([]) == jev.evidence_list_hash([])


@pytest.mark.parametrize("chain_h,chain_ns,ev_h,ev_ns", list(itertools.product(
    (100, 200), (10**12, 3 * 10**12), (40, 99, 100), (10**11, 10**12))))
def test_is_evidence_expired_matches_jax(chain_h, chain_ns, ev_h, ev_ns):
    params = SimpleNamespace(max_age_num_blocks=100, max_age_duration_ns=2 * 10**12)
    assert pverify.is_evidence_expired(chain_h, chain_ns, ev_h, ev_ns, params) == \
        jverify.is_evidence_expired(chain_h, chain_ns, ev_h, ev_ns, params)


def test_the_evidence_checks_submit_under_consensus(monkeypatch):
    """Both commit checks of verify_light_client_attack reach the factory
    under Klass.CONSENSUS in both packages, with every signature counted."""
    from cometbft_tpu.crypto import batch as jbatch

    from cometbft_tpu_torch.crypto import batch as pbatch

    seen = {"jax": [], "port": []}
    for mod, key in ((jbatch, "jax"), (pbatch, "port")):
        real = mod.create_batch_verifier

        def spy(*a, _real=real, _key=key, **kw):
            seen[_key].append(kw.get("klass"))
            return _real(*a, **kw)

        monkeypatch.setattr(mod, "create_batch_verifier", spy)
    counted = []
    from cometbft_tpu_torch.types import validation as pval

    real_assemble = pval._assemble_commit_batch

    def spy_assemble(*a, **kw):
        counted.append(a[7])
        return real_assemble(*a, **kw)

    monkeypatch.setattr(pval, "_assemble_commit_batch", spy_assemble)
    jverify.verify_light_client_attack(*_lca_case("ok", "jax"), LC.CHAIN_ID)
    pverify.verify_light_client_attack(*_lca_case("ok", "port"), LC.CHAIN_ID, device="cpu")
    assert len(seen["port"]) == len(seen["jax"]) == 2
    assert {k.label for k in seen["port"]} == {k.label for k in seen["jax"]} == {"consensus"}
    assert counted == [True, True]
