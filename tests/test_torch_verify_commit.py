"""The port's first slice as a whole: verify_commit / verify_commit_light
through the comb-cached verifier (device="cpu": the kernels' plain
versions) against the JAX package's types/validation on the same
8-validator set and commits (the seeds and helpers of
tests/test_types.py).  The two must agree on pass or fail, on the
exception type and on the message, which carries the blamed index."""

import pytest
import torch

import cometbft_tpu.types as JT
from cometbft_tpu.crypto import ed25519 as jhost
from cometbft_tpu.types import validation as jvalidation
from cometbft_tpu.wire.canonical import PRECOMMIT_TYPE as J_PRECOMMIT
from cometbft_tpu.wire.canonical import Timestamp as JTimestamp

import cometbft_tpu_torch.types as PT
from cometbft_tpu_torch.crypto import ed25519 as phost
from cometbft_tpu_torch.models import comb_verifier as cv
from cometbft_tpu_torch.types import validation as pvalidation
from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE as P_PRECOMMIT
from cometbft_tpu_torch.wire.canonical import Timestamp as PTimestamp

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

CHAIN = "test-chain"
N = 8


@pytest.fixture(autouse=True)
def _cpu_backend(cpu_crypto_backend):
    """The JAX side verifies on its host path (conftest.cpu_crypto_backend)."""


def _build(T, host, precommit, Timestamp, power, bad=(), absent=(), nil=(), height=5):
    """tests/test_types.py's _keys/_valset/_signed_commit, for either package."""
    keys = [host.PrivKey.from_seed(bytes([i + 1]) * 32) for i in range(N)]
    if isinstance(power, int):
        power = [power] * N
    vals = T.ValidatorSet([T.Validator(k.pub_key(), p) for k, p in zip(keys, power)])
    bid = T.BlockID(hash=b"B" * 32, part_set_header=T.PartSetHeader(total=2, hash=b"P" * 32))
    ts = Timestamp(seconds=1700000000)
    by_addr = {k.pub_key().address(): k for k in keys}
    sigs = []
    for i, v in enumerate(vals.validators):
        if i in absent:
            sigs.append(T.CommitSig.absent())
            continue
        vote = T.Vote(
            type=precommit, height=height, round=0,
            block_id=T.BlockID() if i in nil else bid,
            timestamp=ts, validator_address=v.address, validator_index=i,
        )
        sig = by_addr[v.address].sign(vote.sign_bytes(CHAIN))
        if i in bad:
            sig = sig[:-1] + bytes([sig[-1] ^ 1])
        vote.signature = sig
        sigs.append(vote.to_commit_sig())
    return vals, bid, T.Commit(height=height, round=0, block_id=bid, signatures=sigs)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under comparison
        return type(e).__name__, str(e)
    return None


CASES = {
    "all_good": dict(),
    "one_bad_signature": dict(bad=(3,)),
    "two_bad_first_blamed": dict(bad=(6, 2)),
    "absent_signatures": dict(absent=(1, 6)),
    "insufficient_power": dict(absent=(0, 2, 4)),
    "nil_votes_not_counted": dict(nil=(0, 1, 2)),
    "bad_and_absent": dict(bad=(5,), absent=(0,)),
    "unequal_power": dict(power=[50, 5, 5, 5, 5, 5, 5, 5], absent=(0,)),
}


@pytest.fixture(scope="module")
def comb_cache():
    return cv.ValsetCombCache()


@pytest.mark.parametrize("light", [False, True], ids=["verify_commit", "verify_commit_light"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_commit_matches_jax(case, light, comb_cache):
    kw = dict(CASES[case])
    power = kw.pop("power", 10)
    jvals, jbid, jcommit = _build(JT, jhost, J_PRECOMMIT, JTimestamp, power, **kw)
    pvals, pbid, pcommit = _build(PT, phost, P_PRECOMMIT, PTimestamp, power, **kw)
    assert pvals.pub_keys_bytes() == [v.pub_key.bytes() for v in jvals.validators]
    assert [cs.signature for cs in pcommit.signatures] == [cs.signature for cs in jcommit.signatures]
    jfn = jvalidation.verify_commit_light if light else jvalidation.verify_commit
    pfn = pvalidation.verify_commit_light if light else pvalidation.verify_commit
    expect = _outcome(lambda: jfn(CHAIN, jvals, jbid, 5, jcommit))
    got = _outcome(lambda: pfn(CHAIN, pvals, pbid, 5, pcommit, device="cpu", comb_cache=comb_cache))
    assert got == expect
    if case == "one_bad_signature":
        assert got[0] == "CommitVerificationError" and "(#3)" in got[1]


@pytest.mark.parametrize("light", [False, True], ids=["verify_commit", "verify_commit_light"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_commit_comb_route_matches_jax(case, light, comb_cache, monkeypatch):
    """The same cases with the comb threshold lowered to the 8-validator
    set, so the port binds the set to its comb tables (K3 -> K1/K2/K4)
    where the default routing takes the uncached verifier (K2 -> K5)."""
    monkeypatch.setenv("COMETBFT_TPU_COMB_MIN", "1")
    test_verify_commit_matches_jax(case, light, comb_cache)
    assert len(comb_cache._entries) == 1


def test_basic_checks_match_jax(comb_cache):
    jvals, jbid, jcommit = _build(JT, jhost, J_PRECOMMIT, JTimestamp, 10)
    pvals, pbid, pcommit = _build(PT, phost, P_PRECOMMIT, PTimestamp, 10)
    for height, jb, pb in ((6, jbid, pbid), (5, JT.BlockID(), PT.BlockID())):
        expect = _outcome(lambda: jvalidation.verify_commit(CHAIN, jvals, jb, height, jcommit))
        got = _outcome(lambda: pvalidation.verify_commit(CHAIN, pvals, pb, height, pcommit, device="cpu", comb_cache=comb_cache))
        assert got[0] == expect[0] and got[1].split(":")[0] == expect[1].split(":")[0]


def test_batch_path_builds_the_set_once(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_COMB_MIN", "4")
    cache = cv.ValsetCombCache()
    pvals, pbid, pcommit = _build(PT, phost, P_PRECOMMIT, PTimestamp, 10)
    for _ in range(2):
        pvalidation.verify_commit(CHAIN, pvals, pbid, 5, pcommit, device="cpu", comb_cache=cache)
    assert len(cache._entries) == 1


def test_submit_collect_seam():
    cache = cv.ValsetCombCache()
    pvals, pbid, pcommit = _build(PT, phost, P_PRECOMMIT, PTimestamp, 10, bad=(4,))
    pending = pvalidation.submit_verify_commit_light(
        CHAIN, pvals, pbid, 5, pcommit, count_all_signatures=True, device="cpu", comb_cache=cache
    )
    with pytest.raises(pvalidation.CommitVerificationError, match=r"#4"):
        pending.collect()


def test_create_batch_verifier_without_pubkeys_names_the_straus_slice():
    """Without pubkeys the factory returns the uncached (Straus) verifier,
    whose per-signature verdicts equal the JAX package's factory verifier
    and the host oracle; a key type without a port lane is refused,
    secp256k1 takes the ECDSA lane (port slice 4) and bls12_381 the
    aggregate verifier (port slice 5)."""
    from cometbft_tpu.crypto import batch as jbatch
    from cometbft_tpu.crypto import _ref25519 as jref

    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.models.verifier import Ed25519BatchVerifier

    keys = [phost.PrivKey.from_seed(bytes([i + 31]) * 32) for i in range(5)]
    items = [(k.pub_key().data, b"light-%d" % i, k.sign(b"light-%d" % i)) for i, k in enumerate(keys)]
    items[1] = (items[1][0], items[1][1] + b"!", items[1][2])
    items[3] = (items[3][0], items[3][1], items[3][2][:32] + bytes(32))
    bv = batch.create_batch_verifier("ed25519", device="cpu")
    assert isinstance(bv, Ed25519BatchVerifier)
    jbv = jbatch.create_batch_verifier("ed25519")
    for it in items:
        bv.add(*it)
        jbv.add(*it)
    ok, per = bv.verify()
    assert (ok, per) == jbv.verify()
    assert per == [jref.verify(*it) for it in items] == [True, False, True, False, True]
    with pytest.raises(ValueError):
        batch.create_batch_verifier("sr25519", pubkeys=[b"x" * 32], device="cpu")
    from cometbft_tpu_torch.models.bls_verifier import BlsAggregateVerifier
    from cometbft_tpu_torch.models.secp_verifier import SecpBatchVerifier

    assert isinstance(batch.create_batch_verifier("bls12_381", pubkeys=[b"x" * 48], device="cpu"),
                      BlsAggregateVerifier)

    assert isinstance(batch.create_batch_verifier("secp256k1", pubkeys=[b"x" * 33], device="cpu"),
                      SecpBatchVerifier)
