"""Routing of ed25519 batches in the port (cometbft_tpu_torch/crypto/
batch.create_batch_verifier), as the JAX package's resolve_mode routes
them (cometbft_tpu/verifysvc/client.py:37): no pubkeys or a set below
COMETBFT_TPU_COMB_MIN -> the uncached verifier; a set at or above
COMETBFT_TPU_COMB_ASYNC_MIN -> a background table build, uncached until
it lands; anything between -> a synchronous comb build.  Thresholds are
lowered through the environment so 8-validator sets exercise each
route; verdicts are held against the JAX package's host oracle."""

import pytest
import torch

from cometbft_tpu.crypto import _ref25519 as jref
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu_torch.crypto import batch
from cometbft_tpu_torch.crypto import ed25519 as host
from cometbft_tpu_torch.models import comb_verifier as cv
from cometbft_tpu_torch.models.verifier import Ed25519BatchVerifier

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

KEYS = [host.PrivKey.from_seed(bytes([i + 150]) * 32) for i in range(8)]
PUBS = [k.pub_key().data for k in KEYS]


def _verify(bv, bad=(2,)):
    items = []
    for i, k in enumerate(KEYS):
        m = b"route-%d" % i
        items.append((PUBS[i], m + (b"!" if i in bad else b""), k.sign(m)))
    for it in items:
        bv.add(*it)
    ok, per = bv.verify()
    assert per == [jref.verify(*it) for it in items] and not ok
    return per


def test_thresholds_read_the_jax_packages_variables(monkeypatch):
    monkeypatch.delenv("COMETBFT_TPU_COMB_MIN", raising=False)
    monkeypatch.delenv("COMETBFT_TPU_COMB_ASYNC_MIN", raising=False)
    assert (batch.comb_min(), batch.comb_async_min()) == (512, 2048)
    assert (batch.comb_min(), batch.comb_async_min()) == (jbatch.comb_min(), jbatch.comb_async_min())
    monkeypatch.setenv("COMETBFT_TPU_COMB_MIN", "7")
    monkeypatch.setenv("COMETBFT_TPU_COMB_ASYNC_MIN", "not-a-number")
    assert (batch.comb_min(), batch.comb_async_min()) == (7, 2048)
    assert (batch.comb_min(), batch.comb_async_min()) == (jbatch.comb_min(), jbatch.comb_async_min())


def test_no_pubkeys_and_small_sets_go_uncached(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_COMB_MIN", "9")
    cache = cv.ValsetCombCache()
    for pubkeys in (None, PUBS):
        bv = batch.create_batch_verifier("ed25519", pubkeys, device="cpu", comb_cache=cache)
        assert isinstance(bv, Ed25519BatchVerifier)
        _verify(bv)
    assert not cache._entries


def test_mid_sized_sets_build_synchronously(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_COMB_MIN", "8")
    monkeypatch.setenv("COMETBFT_TPU_COMB_ASYNC_MIN", "9")
    cache = cv.ValsetCombCache()
    bv = batch.create_batch_verifier("ed25519", PUBS, device="cpu", comb_cache=cache)
    assert isinstance(bv, cv.CombBatchVerifier) and len(cache._entries) == 1
    _verify(bv)


def test_large_sets_verify_uncached_until_the_background_build_lands(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_COMB_MIN", "2")
    monkeypatch.setenv("COMETBFT_TPU_COMB_ASYNC_MIN", "8")
    cache = cv.ValsetCombCache()
    builds = []
    real = cache._build
    monkeypatch.setattr(cache, "_build", lambda *a: builds.append(len(a[0])) or real(*a))
    first = batch.create_batch_verifier("ed25519", PUBS, device="cpu", comb_cache=cache)
    again = batch.create_batch_verifier("ed25519", PUBS, device="cpu", comb_cache=cache)
    assert isinstance(first, Ed25519BatchVerifier)
    expect = _verify(first)
    cache.join_async()
    later = batch.create_batch_verifier("ed25519", PUBS, device="cpu", comb_cache=cache)
    assert isinstance(later, cv.CombBatchVerifier)
    assert builds == [8]  # one background build, however many callers asked
    assert _verify(later) == expect
    assert isinstance(again, (Ed25519BatchVerifier, cv.CombBatchVerifier))
    assert not cache._async


def test_verify_commit_across_the_async_window(monkeypatch):
    """verify_commit on a set at the async threshold answers the same
    before the tables land (uncached) and after (comb)."""
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE, Timestamp

    monkeypatch.setenv("COMETBFT_TPU_COMB_MIN", "2")
    monkeypatch.setenv("COMETBFT_TPU_COMB_ASYNC_MIN", "8")
    vals = T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in KEYS])
    by_addr = {k.pub_key().address(): k for k in KEYS}
    bid = T.BlockID(hash=b"R" * 32, part_set_header=T.PartSetHeader(total=1, hash=b"Q" * 32))
    sigs = []
    for i, v in enumerate(vals.validators):
        vote = T.Vote(type=PRECOMMIT_TYPE, height=3, round=0, block_id=bid,
                      timestamp=Timestamp(seconds=1700000000 + i), validator_address=v.address,
                      validator_index=i)
        vote.signature = by_addr[v.address].sign(vote.sign_bytes("c"))
        sigs.append(vote.to_commit_sig())
    commit = T.Commit(height=3, round=0, block_id=bid, signatures=sigs)
    bad = list(sigs)
    bad[5] = T.CommitSig(sigs[5].block_id_flag, sigs[5].validator_address, sigs[5].timestamp,
                         sigs[5].signature[:-1] + bytes([sigs[5].signature[-1] ^ 1]))
    faulted = T.Commit(height=3, round=0, block_id=bid, signatures=bad)
    cache = cv.ValsetCombCache()
    for _ in range(2):  # before and after the background build
        validation.verify_commit("c", vals, bid, 3, commit, device="cpu", comb_cache=cache)
        with pytest.raises(validation.CommitVerificationError, match=r"\(#5\)"):
            validation.verify_commit("c", vals, bid, 3, faulted, device="cpu", comb_cache=cache)
        cache.join_async()
        assert len(cache._entries) == 1


@pytest.mark.parametrize("kt", ["secp256k1", "secp256k1eth", "ecrecover"])
def test_secp_key_types_route_to_the_ecdsa_lane(kt, monkeypatch):
    """The three CheckTx secp wire shapes take SecpBatchVerifier; a
    2-row batch (under the JAX class's COMETBFT_TPU_SECP_DEVICE_MIN)
    still takes the card's route, here its plain version."""
    from cometbft_tpu_torch.crypto import secp256k1 as sh
    from cometbft_tpu_torch.crypto import secp256k1eth as eh
    from cometbft_tpu_torch.models.secp_verifier import SecpBatchVerifier

    assert batch.supports_batch_verifier(kt)
    bv = batch.create_batch_verifier(kt, device="cpu")
    assert isinstance(bv, SecpBatchVerifier)
    sk = {"secp256k1": sh.PrivKey, "secp256k1eth": eh.PrivKey, "ecrecover": eh.RecoverPrivKey}[kt].from_seed(kt.encode())
    bv.add(sk.pub_key().data, b"m", sk.sign(b"m"))
    bv.add(sk.pub_key().data, b"m!", sk.sign(b"m"))
    assert bv.verify() == (False, [True, False])
    assert bv.last_timings["rows"] == 2.0


def test_bls_is_not_yet_a_batch_key_type():
    """Port slice 5 made bls12_381 a batch key type: it gets the
    aggregate verifier; a key type the port does not know is refused."""
    from cometbft_tpu_torch.models.bls_verifier import BlsAggregateVerifier

    assert batch.supports_batch_verifier("bls12_381")
    assert isinstance(batch.create_batch_verifier("bls12_381", device="cpu"), BlsAggregateVerifier)
    assert not batch.supports_batch_verifier("sr25519")
    with pytest.raises(ValueError):
        batch.create_batch_verifier("sr25519", device="cpu")
