"""The port's light client (cometbft_tpu_torch/light/verifier.py) and the
hashes it checks — Validator.bytes, ValidatorSet.hash, Header.hash,
Commit.hash — against the JAX package's on one seeded chain, built by
the JAX package and carried across by cometbft_tpu_torch/convert.py.
Hashes are compared byte for byte; verdicts on pass or fail, the
exception class and its message.  The port runs with device="cpu" (the
kernels' plain versions); the JAX side verifies on its host path."""

import copy
from fractions import Fraction

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import hash as jtmhash
from cometbft_tpu import light as jlight
from cometbft_tpu.types.block import BlockID, Commit, Header, PartSetHeader
from cometbft_tpu.types.light_block import LightBlock, SignedHeader
from cometbft_tpu.types.validators import Validator, ValidatorSet
from cometbft_tpu.types.vote import Vote
from cometbft_tpu.wire.canonical import Timestamp

from cometbft_tpu_torch import convert
from cometbft_tpu_torch import light as plight
from cometbft_tpu_torch.crypto import merkle as cm

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

CHAIN_ID = "torch-light-chain"
NS = 1_000_000_000
GENESIS_NS = 1_700_000_000 * NS
PERIOD_NS = 24 * 3600 * NS
NOW_NS = GENESIS_NS + 100 * NS
_RNG = np.random.default_rng(31)
KEYS = [jed.PrivKey.from_seed(_RNG.bytes(32)) for _ in range(9)]
POWERS = [30, 20, 10, 10, 5, 5, 3, 2, 1]


def _keys_at(h):
    """Four validators per height; one member rotates every 3 heights, so
    sets 9 heights apart share too little power to be trusted."""
    w = (h - 1) // 3 % (len(KEYS) - 4)
    return list(range(w, w + 4))


def _vals(idx):
    return ValidatorSet([Validator(KEYS[i].pub_key(), POWERS[i]) for i in idx])


def _block(h, last_block_id, signers=None, tag=b""):
    vals, next_vals = _vals(_keys_at(h)), _vals(_keys_at(h + 1))
    header = Header(
        chain_id=CHAIN_ID, height=h,
        time=Timestamp.from_unix_ns(GENESIS_NS + h * 2 * NS + 7),
        last_block_id=last_block_id,
        last_commit_hash=jtmhash.sum(b"lc%d" % h), data_hash=jtmhash.sum(b""),
        validators_hash=vals.hash(), next_validators_hash=next_vals.hash(),
        consensus_hash=jtmhash.sum(b"params"), app_hash=jtmhash.sum(tag + b"app%d" % h)[:8],
        last_results_hash=jtmhash.sum(b""), evidence_hash=jtmhash.sum(b""),
        proposer_address=vals.validators[0].address,
    )
    bid = BlockID(hash=header.hash(), part_set_header=PartSetHeader(1, jtmhash.sum(b"ps%d" % h)))
    by_addr = {KEYS[i].pub_key().address(): KEYS[i] for i in (signers or range(len(KEYS)))}
    sigs = []
    for i, val in enumerate(vals.validators):
        vote = Vote(
            type=2, height=h, round=0, block_id=bid,
            timestamp=Timestamp.from_unix_ns(GENESIS_NS + h * 2 * NS + NS + i),
            validator_address=val.address, validator_index=i,
        )
        key = by_addr.get(val.address, KEYS[-1])  # a forger signs with a key outside the set
        vote.signature = key.sign(vote.sign_bytes(CHAIN_ID))
        sigs.append(vote.to_commit_sig())
    return LightBlock(SignedHeader(header, Commit(height=h, round=0, block_id=bid, signatures=sigs)), vals)


def _chain(n):
    blocks, last = {}, BlockID()
    for h in range(1, n + 1):
        blocks[h] = _block(h, last)
        last = blocks[h].signed_header.commit.block_id
    return blocks


CHAIN = _chain(12)


def _bid(b):
    return (b.hash, b.part_set_header.total, b.part_set_header.hash)


def _header_fields(h):
    return dict(
        version=(h.version.block, h.version.app), chain_id=h.chain_id, height=h.height,
        time=(h.time.seconds, h.time.nanos), last_block_id=_bid(h.last_block_id),
        **{k: getattr(h, k) for k in Header.FIELDS[5:]},
    )


def _port(lb):
    """A JAX LightBlock -> (port SignedHeader, port ValidatorSet)."""
    sh = lb.signed_header
    c = sh.commit
    sigs = [(cs.block_id_flag, cs.validator_address, (cs.timestamp.seconds, cs.timestamp.nanos),
             cs.signature) for cs in c.signatures]
    psh = convert.signed_header(_header_fields(sh.header), (c.height, c.round, _bid(c.block_id), sigs))
    pvals = convert.validator_set([(v.pub_key.bytes(), v.voting_power) for v in lb.validator_set.validators])
    return psh, pvals


@pytest.fixture(autouse=True)
def _cpu_backend(cpu_crypto_backend):
    """The JAX side verifies on its host path (conftest.cpu_crypto_backend)."""


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under comparison
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("h", [1, 2, 5, 12])
def test_hashes_match_jax(h):
    lb = CHAIN[h]
    psh, pvals = _port(lb)
    jvals = lb.validator_set
    assert [v.bytes() for v in pvals.validators] == [v.bytes() for v in jvals.validators]
    assert pvals.hash() == jvals.hash() == lb.signed_header.header.validators_hash
    assert psh.header.hash() == lb.signed_header.header.hash() == psh.commit.block_id.hash
    assert psh.commit.hash() == lb.signed_header.commit.hash()
    psh.validate_basic(CHAIN_ID)


def test_zero_power_and_empty_header_hash_match_jax():
    pk = KEYS[0].pub_key()
    assert convert.validator_set([(pk.bytes(), 0)]).validators[0].bytes() == Validator(pk, 0).bytes()
    assert convert.header(_header_fields(Header(chain_id=CHAIN_ID))).hash() is None
    assert Header(chain_id=CHAIN_ID).hash() is None


def test_validator_set_hash_kernel_route_matches_jax():
    """A set at the device threshold: the port's kernel route (K7 + K8
    plain versions here) against the JAX package's device route and the
    host oracle."""
    rng = np.random.default_rng(32)
    entries = [(jed.PrivKey.from_seed(rng.bytes(32)).pub_key().bytes(), int(p))
               for p in rng.integers(1, 1000, size=cm.DEVICE_THRESHOLD)]
    jvals = ValidatorSet([Validator(jed.PubKey(pk), p) for pk, p in entries])
    pvals = convert.validator_set(entries)
    want = jvals.hash()
    assert pvals.hash(device="cpu") == want
    assert cm.hash_from_byte_slices([v.bytes() for v in pvals.validators], device=False) == want


def _run_both(jfn, pfn, jargs, pargs, **kw):
    expect = _outcome(lambda: jfn(*jargs, **kw))
    got = _outcome(lambda: pfn(*pargs, **kw, device="cpu"))
    assert got == expect
    return got


def test_verify_adjacent_non_adjacent_and_verify_pass():
    j1, j2, j6 = CHAIN[1], CHAIN[2], CHAIN[6]
    (p1, pv1), (p2, pv2), (p6, pv6) = _port(j1), _port(j2), _port(j6)
    assert _run_both(jlight.verify_adjacent, plight.verify_adjacent,
                     (j1.signed_header, j2.signed_header, j2.validator_set, PERIOD_NS, NOW_NS),
                     (p1, p2, pv2, PERIOD_NS, NOW_NS)) is None
    assert _run_both(jlight.verify_non_adjacent, plight.verify_non_adjacent,
                     (j1.signed_header, j1.validator_set, j6.signed_header, j6.validator_set,
                      PERIOD_NS, NOW_NS),
                     (p1, pv1, p6, pv6, PERIOD_NS, NOW_NS)) is None
    for jb, pb in ((j2, (p2, pv2)), (j6, (p6, pv6))):
        assert _run_both(jlight.verify, plight.verify,
                         (j1.signed_header, j1.validator_set, jb.signed_header, jb.validator_set,
                          PERIOD_NS, NOW_NS),
                         (p1, pv1, pb[0], pb[1], PERIOD_NS, NOW_NS)) is None


def _tampered(lb, **header_changes):
    lb = copy.deepcopy(lb)
    for k, v in header_changes.items():
        setattr(lb.signed_header.header, k, v)
    return lb


def _flip(b):
    return bytes([b[0] ^ 1]) + b[1:]


CASES = {
    # the header names another validator set than the one supplied
    "tampered_validators_hash": lambda: (CHAIN[1], _tampered(CHAIN[2], validators_hash=_flip(
        CHAIN[2].signed_header.header.validators_hash)), "adjacent", PERIOD_NS, NOW_NS),
    # an untampered header and commit, but another validator set supplied
    "supplied_set_is_not_the_headers": lambda: (CHAIN[1], LightBlock(CHAIN[2].signed_header,
                                                                     CHAIN[12].validator_set),
                                                "adjacent", PERIOD_NS, NOW_NS),
    "expired_trusted_header": lambda: (CHAIN[1], CHAIN[2], "adjacent", 1 * NS, NOW_NS),
    "adjacent_call_on_non_adjacent_height": lambda: (CHAIN[1], CHAIN[3], "adjacent", PERIOD_NS, NOW_NS),
    "non_adjacent_call_on_adjacent_height": lambda: (CHAIN[1], CHAIN[2], "non_adjacent", PERIOD_NS, NOW_NS),
    "wrong_chain_id": lambda: (CHAIN[1], _tampered(CHAIN[2], chain_id="other-chain"), "adjacent",
                               PERIOD_NS, NOW_NS),
    # signed by keys outside the set: the commit fails
    "forged_header": lambda: (CHAIN[4], _block(5, CHAIN[4].signed_header.commit.block_id,
                                               signers=[5], tag=b"forged"), "adjacent", PERIOD_NS, NOW_NS),
    "forged_header_non_adjacent": lambda: (CHAIN[1], _block(3, CHAIN[2].signed_header.commit.block_id,
                                                            signers=[0, 5], tag=b"forged"),
                                           "non_adjacent", PERIOD_NS, NOW_NS),
    "too_little_trusted_power": lambda: (CHAIN[1], CHAIN[12], "non_adjacent", PERIOD_NS, NOW_NS),
    "header_from_the_future": lambda: (CHAIN[1], CHAIN[2], "adjacent", PERIOD_NS,
                                       GENESIS_NS - 20 * NS),
    "header_not_newer": lambda: (CHAIN[5], CHAIN[3], "non_adjacent", PERIOD_NS, NOW_NS),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_refusals_match_jax(case):
    jt, ju, kind, period, now = CASES[case]()
    (pt, pvt), (pu, pvu) = _port(jt), _port(ju)
    if kind == "adjacent":
        got = _run_both(jlight.verify_adjacent, plight.verify_adjacent,
                        (jt.signed_header, ju.signed_header, ju.validator_set, period, now),
                        (pt, pu, pvu, period, now))
    else:
        got = _run_both(jlight.verify_non_adjacent, plight.verify_non_adjacent,
                        (jt.signed_header, jt.validator_set, ju.signed_header, ju.validator_set,
                         period, now),
                        (pt, pvt, pu, pvu, period, now))
    assert got is not None, f"{case} verified"


def test_verify_backwards_matches_jax():
    for older, newer in ((1, 2), (4, 5), (2, 4), (3, 2)):
        jo, jn = CHAIN[older].signed_header.header, CHAIN[newer].signed_header.header
        po, pn = _port(CHAIN[older])[0].header, _port(CHAIN[newer])[0].header
        assert _outcome(lambda: plight.verify_backwards(po, pn)) == _outcome(
            lambda: jlight.verify_backwards(jo, jn))
    po, pn = _port(CHAIN[1])[0].header, _port(CHAIN[2])[0].header
    pn.chain_id = "other-chain"
    with pytest.raises(plight.ErrInvalidHeader, match="another chain"):
        plight.verify_backwards(po, pn)


@pytest.mark.parametrize("lvl", [Fraction(1, 3), Fraction(1, 4), Fraction(2, 3), Fraction(4, 3), Fraction(1)])
def test_trust_level_validation_matches_jax(lvl):
    assert _outcome(lambda: plight.validate_trust_level(lvl)) == _outcome(
        lambda: jlight.validate_trust_level(lvl))


def test_light_block_validate_basic():
    from cometbft_tpu_torch.types import LightBlock as PLightBlock

    psh, pvals = _port(CHAIN[3])
    lb = PLightBlock(psh, pvals)
    lb.validate_basic(CHAIN_ID, device="cpu")
    assert lb.hash == CHAIN[3].hash and lb.height == 3
    _, other = _port(CHAIN[12])
    with pytest.raises(ValueError, match="does not match"):
        PLightBlock(psh, other).validate_basic(CHAIN_ID, device="cpu")


def test_get_by_address_matches_jax():
    lb = CHAIN[7]
    _, pvals = _port(lb)
    for v in lb.validator_set.validators + [Validator(KEYS[8].pub_key(), 1)]:
        i, jv = lb.validator_set.get_by_address(v.address)
        pi, pv = pvals.get_by_address(v.address)
        assert pi == i and (pv is None) == (jv is None)
        assert pv is None or pv.address == jv.address
    assert pvals.has_address(lb.validator_set.validators[2].address)
