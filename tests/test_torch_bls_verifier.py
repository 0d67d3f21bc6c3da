"""The port's BLS lane as a whole: BlsAggregateVerifier(device="cpu") and
CpuBlsBatchVerifier row for row against the JAX package's
CpuBlsBatchVerifier and _verify_items(use_device=False) over a corpus of
aggregate commits, singleton units, a poisoned unit, a forged signature
and every bad-key class — once with the JAX thresholds (host routes at
this size) and once with the thresholds at 2, so the card routes' plain
versions (K13; K15 + K14's finishing stage; K14) decide; the host copy's
signatures against the JAX package's; the pairing core against the
pure-Python pairing; routing through crypto/batch and verify_commit over
a 4-validator BLS set against the JAX package (pass, blame and message).
Tolerance: exact (verdicts are booleans, encodings bytes)."""

import pytest
import torch

import cometbft_tpu.types as JT
from cometbft_tpu.crypto import bls12381 as JH
from cometbft_tpu.models import bls_verifier as JM
from cometbft_tpu.types import validation as jvalidation
from cometbft_tpu.wire.canonical import PRECOMMIT_TYPE as J_PRECOMMIT
from cometbft_tpu.wire.canonical import Timestamp as JTimestamp

import cometbft_tpu_torch.types as PT
from cometbft_tpu_torch.crypto import batch
from cometbft_tpu_torch.crypto import bls12381 as H
from cometbft_tpu_torch.models import bls_verifier as M
from cometbft_tpu_torch.ops import bls381 as B
from cometbft_tpu_torch.types import validation as pvalidation
from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE as P_PRECOMMIT
from cometbft_tpu_torch.wire.canonical import Timestamp as PTimestamp

torch.set_num_threads(1)

P = H.P


@pytest.fixture(autouse=True)
def _fresh_caches():
    M.reset_caches()
    JM.reset_caches()
    yield
    M.reset_caches()
    JM.reset_caches()


def _wrong_subgroup_enc():
    x = 1
    while True:
        y = H._fp_sqrt((x * x * x + 4) % P)
        if y is not None and not H._in_subgroup(H._FP, (x, y)):
            return H._g1_compress((x, y))
        x += 1


def _off_curve_enc():
    x = 5
    while H._fp_sqrt((x ** 3 + 4) % P) is not None:
        x += 1
    return bytes([0x80 | (x >> 376)]) + x.to_bytes(48, "big")[1:]


BAD_KEYS = {
    "wrong subgroup": _wrong_subgroup_enc(),
    "x >= p": bytes([0x9F]) + b"\xff" * 47,
    "infinity": bytes([0xC0]) + b"\x00" * 47,
    "off-curve x": _off_curve_enc(),
    "no compression flag": b"\x00" * 48,
}


@pytest.fixture(scope="module")
def corpus():
    """Batches of (pub, msg, sig) rows, signed by the port's host copy."""
    keys = [H.PrivKey(sk) for sk in (3, 5, 7, 11, 13, 17)]
    pubs = [k.pub_key().data for k in keys]
    msg = b"agg-commit"
    sigs = [k.sign(msg) for k in keys]
    agg = H.aggregate_signatures(sigs)
    agg3 = H.aggregate_signatures(sigs[:3])
    solo = [(pubs[3], b"solo", keys[3].sign(b"solo")), (pubs[4], b"solo2", keys[4].sign(b"solo2"))]
    forged = (pubs[5], b"solo3", keys[4].sign(b"solo3"))  # wrong signer
    batches = {
        "aggregate commit": [(p, msg, agg) for p in pubs],
        "aggregate commit, one row's key swapped": [(p, msg, agg) for p in pubs[:5]] + [(pubs[0], msg, agg)],
        "aggregate commit, a bad key": [(p, msg, agg) for p in pubs[:5]] + [(BAD_KEYS["wrong subgroup"], msg, agg)],
        "mixed": [(p, msg, agg3) for p in pubs[:3]] + solo + [forged]
                 + [(bad, b"bad-%d" % i, sigs[0]) for i, bad in enumerate(BAD_KEYS.values())],
        "poisoned unit": [(pubs[0], msg, agg3), (b"\x00" * 48, msg, agg3), (pubs[2], msg, agg3)] + solo,
        "singletons": [(pubs[i], b"m%d" % i, keys[i].sign(b"m%d" % i)) for i in range(4)],
        "forged aggregate": [(p, msg, sigs[0]) for p in pubs],
        "bad signature encoding": [(pubs[0], msg, b"\x00" * 96), (pubs[1], msg, agg)],
    }
    return keys, batches


def test_host_copy_signs_like_the_jax_package(corpus):
    keys, batches = corpus
    for p, msg, sig in batches["singletons"]:
        assert JH.PubKey(p).verify_signature(msg, sig)
    k = keys[0]
    assert k.pub_key().data == JH.PrivKey(3).pub_key().data
    assert k.sign(b"x") == JH.PrivKey(3).sign(b"x")
    assert H.aggregate_signatures([keys[1].sign(b"x"), k.sign(b"x")]) == JH.aggregate_signatures(
        [JH.PrivKey(5).sign(b"x"), JH.PrivKey(3).sign(b"x")])
    assert H.pop_verify(k.pub_key(), H.pop_prove(k)) and H.pop_prove(k) == JH.pop_prove(JH.PrivKey(3))
    assert H.fast_aggregate_verify([x.pub_key() for x in keys], b"agg-commit",
                                   batches["aggregate commit"][0][2])
    for label, enc in BAD_KEYS.items():
        with pytest.raises(ValueError):
            H.PubKey(enc)  # the construction-time KeyValidate, as the reference's
        with pytest.raises(ValueError):
            JH.PubKey(enc)


def test_pairing_core_matches_pure_python_pairing(corpus):
    """The native core (hostsrc/bls381.cc, built at first use) against the
    pure-Python oracle on 2-pair products, passing and failing."""
    keys, _ = corpus
    pk, msg = keys[0].pub_key(), b"pair"
    s = H._g2_decompress(keys[0].sign(msg))
    neg = (H.G1_GEN[0], (-H.G1_GEN[1]) % P)
    good = [(pk._aff, H.hash_to_g2(msg)), (neg, s)]
    bad = [(keys[1].pub_key()._aff, H.hash_to_g2(msg)), (neg, s)]
    assert H._pairings_product_is_one(good) is H._pairings_product_is_one_python(good) is True
    assert H._pairings_product_is_one(bad) is H._pairings_product_is_one_python(bad) is False
    assert H._pairings_product_is_one([(None, s)]) is True


@pytest.mark.parametrize("route", ["jax thresholds", "card routes"])
def test_verifier_matches_jax_row_for_row(corpus, route, monkeypatch):
    """Every batch: BlsAggregateVerifier(device="cpu") == the port's
    CpuBlsBatchVerifier == the JAX package's CpuBlsBatchVerifier ==
    JAX _verify_items(use_device=False), row for row, each from cold
    caches; with the thresholds at 2, the plain K13, K15 and K14 decide
    the well-formedness and the sums."""
    _, batches = corpus
    if route == "card routes":
        monkeypatch.setenv("COMETBFT_TPU_BLS_VALIDATE_DEVICE_MIN", "2")
        monkeypatch.setenv("COMETBFT_TPU_BLS_AGG_DEVICE_MIN", "2")
    want = {
        "aggregate commit": (True, [True] * 6),
        "aggregate commit, one row's key swapped": (False, [False] * 6),
        "aggregate commit, a bad key": (False, [False] * 6),
        "mixed": (False, [True] * 5 + [False] * 6),
        "poisoned unit": (False, [False] * 3 + [True] * 2),
        "singletons": (True, [True] * 4),
        "forged aggregate": (False, [False] * 6),
        "bad signature encoding": (False, [False, False]),
    }
    # the card routes' plain versions run the 254-step ladder (seconds on
    # the CPU): there, the batches that reach each route once — K15 with
    # every key valid and with a bad key, K13 with K14 on a 3-row unit
    names = list(batches) if route == "jax thresholds" else [
        "aggregate commit", "aggregate commit, a bad key", "mixed"]
    before = dict(B.LAUNCHES)
    for name in names:
        items = batches[name]
        results = []
        for make in (lambda: M.BlsAggregateVerifier(device="cpu"), M.CpuBlsBatchVerifier,
                     JM.CpuBlsBatchVerifier):
            M.reset_caches()
            JM.reset_caches()
            bv = make()
            for it in items:
                bv.add(*it)
            results.append(bv.verify())
        JM.reset_caches()
        results.append(JM._verify_items(items, use_device=False))
        assert results[0] == results[1] == results[2] == results[3] == want[name], name
    assert B.LAUNCHES == before  # CPU tensors: plain versions, never a launch


def test_timings_and_size_errors(corpus):
    _, batches = corpus
    bv = M.BlsAggregateVerifier(device="cpu")
    assert bv.verify() == (False, [])
    for it in batches["singletons"]:
        bv.add(*it)
    assert bv.verify() == (True, [True] * 4)
    assert {"decode_ms", "validate_ms", "sig_decode_ms", "hash_to_g2_ms", "pairing_ms"} <= set(bv.last_timings)
    for v in (M.BlsAggregateVerifier(device="cpu"), M.CpuBlsBatchVerifier()):
        with pytest.raises(ValueError):
            v.add(b"\x01" * 32, b"m", b"\x02" * 96)  # ed25519-sized pubkey
        with pytest.raises(ValueError):
            v.add(b"\x01" * 48, b"m", b"\x02" * 64)  # ed25519-sized signature


def test_pubkey_facts_are_cached(corpus, monkeypatch):
    """The second verify of a set never re-validates its keys."""
    _, batches = corpus
    calls = {"n": 0}
    real = H._in_subgroup

    def counting(F, aff):
        if F is H._FP:
            calls["n"] += 1
        return real(F, aff)

    monkeypatch.setattr(H, "_in_subgroup", counting)
    for _ in range(2):
        bv = M.BlsAggregateVerifier(device="cpu")
        for it in batches["aggregate commit"]:
            bv.add(*it)
        assert bv.verify()[0] is True
    assert calls["n"] == 6


# ------------------------------------------------------------ routing


def _bls_commit(T, host, precommit, Timestamp, forge=None):
    """tests/test_bls_service.py's _bls_commit for either package: a
    4-validator BLS set, identical sign bytes (one timestamp), the
    aggregate signature on every CommitSig, or row ``forge`` signed by
    another key over other bytes."""
    keys = [host.PrivKey(23 + 2 * i) for i in range(4)]
    vals = T.ValidatorSet([T.Validator(host.PubKey(k.pub_key().data), 10) for k in keys])
    bid = T.BlockID(hash=b"\x31" * 32, part_set_header=T.PartSetHeader(total=1, hash=b"\x13" * 32))
    ts = Timestamp(seconds=1_700_001_000)
    by_addr = {k.pub_key().address(): k for k in keys}
    sigs = []
    for i, v in enumerate(vals.validators):
        vote = T.Vote(type=precommit, height=9, round=0, block_id=bid, timestamp=ts,
                      validator_address=v.address, validator_index=i)
        sigs.append((v.address, by_addr[v.address].sign(vote.sign_bytes("bls-chain"))))
    if forge is None:
        agg = host.aggregate_signatures([s for _, s in sigs])
        sigs = [(a, agg) for a, _ in sigs]
    else:
        sigs[forge] = (sigs[forge][0], host.PrivKey(99).sign(b"forged"))
    commit = T.Commit(height=9, round=0, block_id=bid, signatures=[
        T.CommitSig(block_id_flag=2, validator_address=a, timestamp=ts, signature=s) for a, s in sigs])
    return vals, bid, commit


def test_bls_routes_to_the_aggregate_verifier():
    assert batch.supports_batch_verifier("bls12_381")
    assert isinstance(batch.create_batch_verifier("bls12_381", device="cpu"), M.BlsAggregateVerifier)
    assert isinstance(batch.create_batch_verifier("bls12_381", pubkeys=[b"x" * 48], device="cpu"),
                      M.BlsAggregateVerifier)


def test_verify_commit_over_a_bls_set_matches_jax(cpu_crypto_backend):
    """An aggregate commit passes in both packages; a forged row raises
    CommitVerificationError with the same message (blame on #1)."""
    pv, pb, pc = _bls_commit(PT, H, P_PRECOMMIT, PTimestamp)
    jv, jb, jc = _bls_commit(JT, JH, J_PRECOMMIT, JTimestamp)
    assert pv.hash(device="cpu") == jv.hash()
    assert pvalidation.should_batch_verify(pv, pc)
    pvalidation.verify_commit("bls-chain", pv, pb, 9, pc, device="cpu")
    jvalidation.verify_commit("bls-chain", jv, jb, 9, jc)
    pv, pb, pc = _bls_commit(PT, H, P_PRECOMMIT, PTimestamp, forge=1)
    jv, jb, jc = _bls_commit(JT, JH, J_PRECOMMIT, JTimestamp, forge=1)
    with pytest.raises(pvalidation.CommitVerificationError, match="#1") as pe:
        pvalidation.verify_commit("bls-chain", pv, pb, 9, pc, device="cpu")
    with pytest.raises(jvalidation.CommitVerificationError, match="#1") as je:
        jvalidation.verify_commit("bls-chain", jv, jb, 9, jc)
    assert str(pe.value) == str(je.value)
