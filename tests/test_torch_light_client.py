"""The port's light client (cometbft_tpu_torch/light/client.py, detector.py)
and the validator-set arithmetic it relies on, against the JAX package's
on the same seeded chains (tests/torch_light_chain.py).  Each scenario
runs a JAX Client and a port Client over their own providers and stores;
both must ask the providers for the same heights in the same order,
store the same heights, and end with the same outcome (the exception's
class and message).  The port runs with device="cpu" (the kernels' plain
versions); the JAX side verifies on its host path."""

import copy
import struct

import numpy as np
import pytest
import torch

from cometbft_tpu import light as jlight
from cometbft_tpu.store.db import MemDB as JMemDB
from cometbft_tpu.types.block import Header as JHeader
from cometbft_tpu.types.light_block import LightBlock as JLightBlock
from cometbft_tpu.types.light_block import SignedHeader as JSignedHeader
from cometbft_tpu.types.validators import Validator as JValidator
from cometbft_tpu.types.validators import ValidatorSet as JValidatorSet

from cometbft_tpu_torch import convert
from cometbft_tpu_torch import light as plight
from cometbft_tpu_torch.store.db import MemDB as PMemDB
from cometbft_tpu_torch.types.validators import Validator as PValidator
from cometbft_tpu_torch.types.validators import ValidatorSet as PValidatorSet

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


# ------------------------------------------------------------ validator sets


def _sets(seed, n):
    rng = np.random.default_rng(seed)
    powers = rng.integers(1, 1000, size=n).tolist()
    jv = JValidatorSet([JValidator(LC.KEYS[i].pub_key(), p) for i, p in enumerate(powers)])
    pv = convert.validator_set([(LC.KEYS[i].pub_key().bytes(), p) for i, p in enumerate(powers)])
    return rng, jv, pv


def _same_set(jv, pv):
    assert [(v.address, v.voting_power, v.proposer_priority) for v in pv.validators] == [
        (v.address, v.voting_power, v.proposer_priority) for v in jv.validators]
    assert pv.total_voting_power() == jv.total_voting_power()
    jp, pp = jv.get_proposer(), pv.get_proposer()
    assert (jp is None) == (pp is None) and (jp is None or jp.address == pp.address)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_proposer_rotation_matches_jax(seed):
    """N steps of increment_proposer_priority (times 1..4, with negative
    priorities, rescales and the average shift) give each validator's
    priority and the proposer of the JAX package."""
    rng, jv, pv = _sets(seed, 7 + seed)
    _same_set(jv, pv)
    for _ in range(40):
        times = int(rng.integers(1, 5))
        jv.increment_proposer_priority(times)
        pv.increment_proposer_priority(times)
        _same_set(jv, pv)
    # large priorities: the rescale's truncation toward zero and the floor of the shift
    for v, w in zip(jv.validators, pv.validators):
        p = int(rng.integers(-(1 << 62), 1 << 62))
        v.proposer_priority = w.proposer_priority = p
    jv.increment_proposer_priority(3)
    pv.increment_proposer_priority(3)
    _same_set(jv, pv)
    for bad in (0, -1):
        assert LC.outcome(lambda: pv.increment_proposer_priority(bad)) == LC.outcome(
            lambda: jv.increment_proposer_priority(bad))


def _change(seed, jv, step):
    """A seeded change set over KEYS: updates of members, removals,
    additions of outsiders."""
    rng = np.random.default_rng(seed * 100 + step)
    members = {v.address for v in jv.validators}
    out = []
    for i in rng.permutation(len(LC.KEYS))[: int(rng.integers(1, 6))]:
        pk = LC.KEYS[int(i)].pub_key()
        if pk.address() in members:
            power = int(rng.choice([0, int(rng.integers(1, 2000))]))
        else:
            power = int(rng.integers(1, 2000))
        out.append((pk, power))
    if len(members) - sum(1 for pk, p in out if p == 0 and pk.address() in members) < 1:
        out = [(pk, p or 5) for pk, p in out]
    return out


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_update_with_change_set_matches_jax(seed):
    """Seeded change sets (updates, removals, additions) between rounds of
    the rotation: the same members, powers, priorities and proposer; the
    hash memo is dropped with the membership, and copy() keeps it."""
    rng, jv, pv = _sets(seed, 6)
    for step in range(12):
        ch = _change(seed, jv, step)
        jv.update_with_change_set([JValidator(pk, p) for pk, p in ch])
        pv.update_with_change_set([PValidator(convert._PUBKEYS["ed25519"](pk.bytes()), p) for pk, p in ch])
        _same_set(jv, pv)
        assert pv.hash(device=False) == jv.hash()
        cp = pv.copy()
        assert cp._hash == pv._hash and cp.validators == pv.validators and cp is not pv
        times = int(rng.integers(1, 4))
        jv.increment_proposer_priority(times)
        pv.increment_proposer_priority(times)
        _same_set(jv, pv)


REFUSALS = {
    "duplicate": lambda ks: [(ks[0], 5), (ks[0], 6)],
    "negative": lambda ks: [(ks[1], -1)],
    "remove-unknown": lambda ks: [(ks[20], 0)],
    "empty-result": lambda ks: [(ks[i], 0) for i in range(3)],
    "over-max": lambda ks: [(ks[5], (1 << 63) // 8)],
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_update_with_change_set_refusals_match_jax(case):
    jv = JValidatorSet([JValidator(LC.KEYS[i].pub_key(), 10) for i in range(3)])
    pv = convert.validator_set([(LC.KEYS[i].pub_key().bytes(), 10) for i in range(3)])
    ch = REFUSALS[case]([k.pub_key() for k in LC.KEYS])
    got = LC.outcome(lambda: pv.update_with_change_set(
        [PValidator(convert._PUBKEYS["ed25519"](pk.bytes()), p) for pk, p in ch]))
    want = LC.outcome(lambda: jv.update_with_change_set([JValidator(pk, p) for pk, p in ch]))
    assert got == want and got[0] != "ok"
    _same_set(jv, pv)


def test_validator_set_helpers_match_jax():
    _, jv, pv = _sets(7, 9)
    for i in (-1, 0, 4, 8, 9):
        ja, jval = jv.get_by_index(i)
        pa, pval = pv.get_by_index(i)
        assert pa == ja and (pval is None) == (jval is None)
    for v in jv.validators:
        assert pv.validator_blocks_the_chain(v.address) == jv.validator_blocks_the_chain(v.address)
    big = JValidatorSet([JValidator(LC.KEYS[0].pub_key(), 50), JValidator(LC.KEYS[1].pub_key(), 10)])
    pbig = convert.validator_set([(LC.KEYS[0].pub_key().bytes(), 50), (LC.KEYS[1].pub_key().bytes(), 10)])
    assert pbig.validator_blocks_the_chain(LC.KEYS[0].pub_key().address()) is True
    assert big.validator_blocks_the_chain(LC.KEYS[0].pub_key().address()) is True
    assert pbig.validator_blocks_the_chain(b"\0" * 20) is False
    jv.increment_proposer_priority(3)
    raw = jv.to_proto().encode()
    back = PValidatorSet.from_proto(convert.pb.ValidatorSet.decode(raw))
    assert back.to_proto().encode() == raw
    _same_set(jv, back)


# ------------------------------------------------------------ the client


def _heights(store):
    return [struct.unpack(">q", k[3:])[0] for k, _ in store.db.iterator(b"lb:", b"lb:\xff")]


class Pair:
    """A JAX and a port client over the same chain, each with its own
    providers (primary first, then witnesses) and store."""

    def __init__(self, chain, mode=jlight.SKIPPING, witnesses=0, height=1, trust_hash=None,
                 primary_blocks=None, witness_chains=None, stores=None, fail_witnesses=()):
        self.chain = chain
        self.prov, self.clients, self.errors = {}, {}, {}
        for side, L, DB in (("jax", jlight, JMemDB), ("port", plight, PMemDB)):
            blocks = {h: (b(side) if callable(b) else b) for h, b in (primary_blocks or {}).items()}
            primary = LC.Provider(chain, side, blocks=blocks)
            wits = [LC.Provider(wc, side) for wc in (witness_chains or [chain] * witnesses)]
            wits += [LC.Provider(chain, side, fail=True) for _ in fail_witnesses]
            self.prov[side] = [primary] + wits
            store = (stores or {}).get(side) or L.LightStore(DB())
            opts = L.TrustOptions(period_ns=LC.PERIOD_NS, height=height,
                                  hash=trust_hash if trust_hash is not None else chain.jax(height).hash)
            kw = {"device": "cpu"} if side == "port" else {}
            try:
                self.clients[side] = L.Client(LC.CHAIN_ID, opts, primary, wits, store,
                                              mode=mode, now_fn=lambda: LC.NOW_NS, **kw)
                self.errors[side] = None
            except Exception as e:  # the outcome under comparison
                self.clients[side] = None
                self.errors[side] = (type(e).__name__, str(e))
        assert self.errors["jax"] == self.errors["port"]

    def run(self, call):
        got = {}
        for side in ("jax", "port"):
            got[side] = LC.outcome(lambda: call(self.clients[side]))
        assert got["port"] == got["jax"]
        assert [p.asked for p in self.prov["port"]] == [p.asked for p in self.prov["jax"]]
        assert _heights(self.clients["port"].store) == _heights(self.clients["jax"].store)
        return got["port"]


def test_skipping_sync_across_240_heights_with_rotation():
    """Bisection over 240 heights whose set rotates one key in four every
    12 heights: the same pivots (provider heights), the same stored
    trace, one witness consulted; the stored blocks decode to the JAX
    blocks' bytes."""
    chain = LC.Chain(240, rotate_every=12)
    p = Pair(chain, witnesses=1)
    assert p.run(lambda c: c.verify_light_block_at_height(240)) == ("ok", 240)
    stored = _heights(p.clients["port"].store)
    assert len(stored) >= 3 and stored[0] == 1 and stored[-1] == 240
    assert p.prov["port"][1].asked == [240]
    for h in stored:
        lb = p.clients["port"].store.light_block(h)
        assert lb.to_proto().encode() == chain.jax(h).to_proto().encode()
    # asked again: served from the store, no provider round trip
    assert p.run(lambda c: c.verify_light_block_at_height(240)) == ("ok", 240)
    assert p.run(lambda c: c.trusted_light_block(stored[1])) == ("ok", stored[1])
    assert p.run(lambda c: c.last_trusted_height()) == ("ok", 240)


def test_sequential_sync():
    chain = LC.Chain(24, rotate_every=5)
    p = Pair(chain, mode=jlight.SEQUENTIAL, witnesses=1)
    assert p.run(lambda c: c.verify_light_block_at_height(24)) == ("ok", 24)
    assert _heights(p.clients["port"].store) == list(range(1, 25))


def test_update_follows_the_head():
    chain = LC.Chain(40, rotate_every=8)
    p = Pair(chain, witnesses=1)
    assert p.run(lambda c: c.update()) == ("ok", 40)
    assert p.run(lambda c: c.update()) == ("ok", None)


def test_backwards_walk_below_the_first_trusted_block():
    chain = LC.Chain(30, rotate_every=6)
    p = Pair(chain, height=20)
    assert p.run(lambda c: c.verify_light_block_at_height(14)) == ("ok", 14)
    assert _heights(p.clients["port"].store) == [14, 20]
    # a broken link below the root is refused alike
    forked = LC.Chain(30, rotate_every=6, fork_from=1)
    q = Pair(chain, height=20, primary_blocks={12: lambda side: forked.jax(12) if side == "jax" else forked.port(12)})
    got = q.run(lambda c: c.verify_light_block_at_height(11))
    assert got[0] == "ErrInvalidHeader"


def _forged_unsigned(chain, h, side):
    """Block h with its app_hash replaced and its commit left as it was."""
    jb = chain.jax(h)
    hdr = copy.deepcopy(jb.signed_header.header)
    hdr.app_hash = b"\xee" * 8
    jf = JLightBlock(JSignedHeader(hdr, jb.signed_header.commit), jb.validator_set)
    return jf if side == "jax" else convert.light_block(jf.to_proto().encode())


def _tampered_commit(chain, h, side):
    """Block h with two of its four signatures zeroed: 2/3 is out of reach."""
    jb = copy.deepcopy(chain.jax(h))
    for cs in jb.signed_header.commit.signatures[:2]:
        cs.signature = bytes(64)
    return jb if side == "jax" else convert.light_block(jb.to_proto().encode())


@pytest.mark.parametrize("mode", [jlight.SKIPPING, jlight.SEQUENTIAL])
def test_forged_header_is_refused(mode):
    chain = LC.Chain(40, rotate_every=10)
    p = Pair(chain, mode=mode, primary_blocks={36: lambda side: _forged_unsigned(chain, 36, side)})
    got = p.run(lambda c: c.verify_light_block_at_height(36))
    assert got[0] != "ok"


@pytest.mark.parametrize("target", [3, 30], ids=["adjacent-hop", "bisection"])
def test_tampered_commit_is_refused(target):
    chain = LC.Chain(40, rotate_every=10)
    p = Pair(chain, witnesses=1, primary_blocks={target: lambda side: _tampered_commit(chain, target, side)})
    got = p.run(lambda c: c.verify_light_block_at_height(target))
    assert got[0] != "ok"
    assert _heights(p.clients["port"].store) == [1]


def test_trust_hash_mismatch_is_refused():
    chain = LC.Chain(10)
    p = Pair(chain, trust_hash=b"\x42" * 32)
    assert p.errors["port"][0] == "LightClientError" and "expected header hash" in p.errors["port"][1]


def test_a_new_root_purges_the_store():
    """A store verified on one lineage, re-rooted on another at the same
    height: both packages purge it, then verify from the new root."""
    honest = LC.Chain(30, rotate_every=10)
    forked = LC.Chain(30, rotate_every=10, fork_from=1, fork_tag=b"other")
    first = Pair(honest, witnesses=1)
    first.run(lambda c: c.verify_light_block_at_height(25))
    assert len(_heights(first.clients["port"].store)) > 1
    stores = {side: first.clients[side].store for side in ("jax", "port")}
    second = Pair(forked, witnesses=1, stores=stores)
    assert _heights(stores["port"]) == _heights(stores["jax"]) == [1]
    assert second.run(lambda c: c.verify_light_block_at_height(30)) == ("ok", 30)
    assert stores["port"].light_block(1).hash == forked.jax(1).hash


# ------------------------------------------------------------ the detector


def test_a_forked_primary_is_detected_with_the_same_evidence():
    """A primary forked from height 20 against an honest witness: both
    packages raise ErrLightClientAttackDetected with the same evidence
    (bytes and hash) reported to both sides."""
    honest = LC.Chain(60, rotate_every=15)
    forked = LC.Chain(60, rotate_every=15, fork_from=20)
    p = Pair(forked, witness_chains=[honest])
    got = p.run(lambda c: c.verify_light_block_at_height(60))
    assert got == ("ErrLightClientAttackDetected", "light client attack detected and evidence submitted")
    for k in (0, 1):  # the primary's report and the witness's
        jev = [pr.reported_evidence for pr in p.prov["jax"]][k]
        pev = [pr.reported_evidence for pr in p.prov["port"]][k]
        assert len(jev) == len(pev) == 1
        assert pev[0].to_proto().encode() == jev[0].to_proto().encode()
        assert pev[0].hash() == jev[0].hash()
    ev = p.prov["port"][1].reported_evidence[0]
    # the bifurcation: the primary's first forked block of the trace, over a common block below the fork
    cb = ev.conflicting_block
    assert ev.common_height < 20 <= cb.height and cb.hash == forked.jax(cb.height).hash != honest.jax(cb.height).hash
    assert len(p.clients["port"].witnesses) == len(p.clients["jax"].witnesses) == 1


def test_an_agreeing_and_a_failing_witness():
    """An agreeing witness passes; a witness that errors is removed; with
    only failing witnesses the cross-check fails alike."""
    chain = LC.Chain(30, rotate_every=10)
    p = Pair(chain, witnesses=1, fail_witnesses=[True])
    assert p.run(lambda c: c.verify_light_block_at_height(30)) == ("ok", 30)
    assert len(p.clients["port"].witnesses) == len(p.clients["jax"].witnesses) == 1
    q = Pair(chain, witnesses=0, fail_witnesses=[True])
    got = q.run(lambda c: c.verify_light_block_at_height(30))
    assert got[0] == "ErrFailedHeaderCrossReferencing"
    assert q.clients["port"].witnesses == [] and q.clients["jax"].witnesses == []


def test_a_witness_that_cannot_substantiate_its_header_is_dropped():
    """A witness serving another lineage from its root: its header cannot
    be verified from the trusted root, so it is dropped (in both) and the
    honest witness confirms."""
    chain = LC.Chain(30, rotate_every=10)
    liar = LC.Chain(30, rotate_every=10, fork_from=1, fork_tag=b"liar")
    p = Pair(chain, witness_chains=[liar, chain])
    assert p.run(lambda c: c.verify_light_block_at_height(30)) == ("ok", 30)
    assert len(p.clients["port"].witnesses) == len(p.clients["jax"].witnesses) == 1


def test_the_client_submits_under_background(monkeypatch):
    """Every commit check of a sync (the root's, each hop's, the
    detector's) reaches create_batch_verifier under Klass.BACKGROUND in
    both packages."""
    from cometbft_tpu.crypto import batch as jbatch

    from cometbft_tpu_torch.crypto import batch as pbatch

    seen = {"jax": [], "port": []}
    for mod, key in ((jbatch, "jax"), (pbatch, "port")):
        real = mod.create_batch_verifier

        def spy(*a, _real=real, _key=key, **kw):
            seen[_key].append(kw.get("klass"))
            return _real(*a, **kw)

        monkeypatch.setattr(mod, "create_batch_verifier", spy)
    honest = LC.Chain(40, rotate_every=10)
    forked = LC.Chain(40, rotate_every=10, fork_from=25)
    p = Pair(forked, witness_chains=[honest])
    p.run(lambda c: c.verify_light_block_at_height(40))
    assert len(seen["port"]) == len(seen["jax"]) >= 5
    assert {k.label for k in seen["port"]} == {k.label for k in seen["jax"]} == {"background"}


def test_the_light_exports_match_jax():
    assert set(plight.__all__) >= set(jlight.__all__)
    assert jlight.client.SKIP_NUMERATOR == plight.client.SKIP_NUMERATOR == 9
    assert jlight.client.SKIP_DENOMINATOR == plight.client.SKIP_DENOMINATOR == 16


def test_block_store_provider_serves_and_refuses_alike():
    """BlockStoreProvider over duck-typed stores: a served block, a height
    past the head, a missing one, and a block whose set does not match
    its header (ErrBadLightBlock)."""
    chain = LC.Chain(6)

    class Meta:
        def __init__(self, header):
            self.header = header

    def stores(side, bad=False):
        blocks = {h: (chain.jax(h) if side == "jax" else chain.port(h)) for h in range(1, 6)}

        class BS:
            height = 5

            def load_block_meta(self, h):
                return Meta(blocks[h].signed_header.header.to_proto()) if h in blocks and h != 3 else None

            def load_block_commit(self, h):
                return blocks[h].signed_header.commit if h in blocks else None

        class SS:
            def load_validators(self, h):
                if bad and h == 4:
                    return blocks[1].validator_set if side == "jax" else chain.port(5).validator_set
                return blocks[h].validator_set if h in blocks else None

        return BS(), SS()

    for bad in (False, True):
        jp = jlight.BlockStoreProvider(LC.CHAIN_ID, *stores("jax", bad))
        pp = plight.BlockStoreProvider(LC.CHAIN_ID, *stores("port", bad), device="cpu")
        for h in (0, 2, 3, 4, 6):
            got, want = LC.outcome(lambda: pp.light_block(h)), LC.outcome(lambda: jp.light_block(h))
            assert got[0] == want[0] and (got[0] != "ok" or got == want)
    pp.report_evidence("ev")
    assert pp.reported_evidence == ["ev"]
