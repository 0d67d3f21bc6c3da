"""A light chain built with the port's own types and host signer (no JAX),
shared by chip_smoke.py's phase 27 and the ``cuda`` tests.

The set at height h is a window of ``window`` keys over a list of keys
made from a seed, moving by ``shift`` keys every ``every`` heights; every
validator has the same power.  Headers (and the hashes that link them)
are made when the chain is made, each window's set hash on the host;
commits are signed on first use, so only the heights a run asks for are
signed.  ``fork_from`` gives every height from there another app_hash,
signed by the same keys: a lunatic primary's chain.  A served block
carries a fresh ValidatorSet, so its hash is computed by whoever checks
it (the kernels, for sets of 512 validators and more).

``expected_trace`` replays the light client's bisection on the host from
the sets' overlaps (Fractions), and ``attack_fields`` computes what the
evidence against a lunatic primary must hold."""

from __future__ import annotations

import hashlib
from fractions import Fraction

import numpy as np

from cometbft_tpu_torch import types as T
from cometbft_tpu_torch.crypto import ed25519 as host
from cometbft_tpu_torch.crypto import hash as tmhash
from cometbft_tpu_torch.light import provider as P
from cometbft_tpu_torch.types.light_block import LightBlock, SignedHeader
from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE, Timestamp

NS = 1_000_000_000
GENESIS_NS = 1_760_000_000 * NS
BLOCK_NS = 6 * NS  # between heights


def make_keys(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(n)]


class Chain:
    def __init__(self, chain_id: str, keys: list, n: int, window: int, shift: int, every: int, power: int = 10,
                 fork_from: int | None = None, fork_tag: bytes = b"fork", base: "Chain | None" = None):
        """``base``: a chain of the same keys and shape whose sets, set
        hashes and signed commits below ``fork_from`` this one shares."""
        self.chain_id, self.keys, self.n = chain_id, keys, n
        self.window, self.shift, self.every, self.power = window, shift, every, power
        need = self.start(n + 1) + window
        if need > len(keys):
            raise ValueError(f"{need} keys needed, {len(keys)} given")
        self._validators: dict[int, list] = {} if base is None else base._validators  # window start -> Validators
        self._set_hash: dict[int, bytes] = {} if base is None else base._set_hash
        self.headers: dict[int, T.Header] = {}
        self.bids: dict[int, T.BlockID] = {}
        self._commits: dict[int, T.Commit] = {}
        self._base = base if base is not None and fork_from is not None else None
        self._fork_from = fork_from
        last = T.BlockID()
        for h in range(1, n + 1):
            app = hashlib.sha256(b"app%d" % h).digest()
            if fork_from is not None and h >= fork_from:
                app = hashlib.sha256(fork_tag + b"%d" % h).digest()
            vals = self.validators(h)
            hdr = T.Header(
                chain_id=chain_id, height=h, time=self.time(h), last_block_id=last,
                last_commit_hash=tmhash.sum(b"lc%d" % h), data_hash=tmhash.sum(b"data%d" % h),
                validators_hash=self.set_hash(h), next_validators_hash=self.set_hash(h + 1),
                consensus_hash=tmhash.sum(b"params"), app_hash=app, last_results_hash=tmhash.sum(b"res%d" % h),
                evidence_hash=tmhash.sum(b""), proposer_address=vals[0].address,
            )
            self.headers[h] = hdr
            last = self.bids[h] = T.BlockID(hash=hdr.hash(),
                                            part_set_header=T.PartSetHeader(1, tmhash.sum(b"ps%d" % h)))

    def start(self, h: int) -> int:
        return (h - 1) // self.every * self.shift

    def time(self, h: int) -> Timestamp:
        return Timestamp.from_unix_ns(GENESIS_NS + h * BLOCK_NS)

    def validators(self, h: int) -> list:
        s = self.start(h)
        if s not in self._validators:
            vs = T.ValidatorSet([T.Validator(k.pub_key(), self.power) for k in self.keys[s: s + self.window]])
            self._validators[s] = vs.validators
        return self._validators[s]

    def vals(self, h: int) -> T.ValidatorSet:
        """A fresh ValidatorSet of height h (no hash memo)."""
        return T.ValidatorSet(self.validators(h))

    def set_hash(self, h: int) -> bytes:
        s = self.start(h)
        if s not in self._set_hash:
            self._set_hash[s] = self.vals(h).hash(device=False)
        return self._set_hash[s]

    def addresses(self, h: int) -> set:
        return {v.address for v in self.validators(h)}

    def commit(self, h: int) -> T.Commit:
        """Height h's commit, every member signing (host ed25519)."""
        if self._base is not None and h < self._fork_from:
            return self._base.commit(h)
        if h not in self._commits:
            s, bid = self.start(h), self.bids[h]
            by_addr = {k.pub_key().address(): k for k in self.keys[s: s + self.window]}
            sigs = []
            for i, v in enumerate(self.validators(h)):
                vote = T.Vote(type=PRECOMMIT_TYPE, height=h, round=0, block_id=bid,
                              timestamp=Timestamp.from_unix_ns(GENESIS_NS + h * BLOCK_NS + NS + i),
                              validator_address=v.address, validator_index=i)
                vote.signature = by_addr[v.address].sign(vote.sign_bytes(self.chain_id))
                sigs.append(vote.to_commit_sig())
            self._commits[h] = T.Commit(height=h, round=0, block_id=bid, signatures=sigs)
        return self._commits[h]

    def light_block(self, h: int) -> LightBlock:
        return LightBlock(SignedHeader(self.headers[h], self.commit(h)), self.vals(h))


class Provider:
    """Serves a Chain's light blocks (fresh sets, signed on first use);
    logs the heights asked for and keeps the evidence reported."""

    def __init__(self, chain: Chain):
        self.chain = chain
        self.asked: list[int] = []
        self.reported_evidence: list = []

    def chain_id(self) -> str:
        return self.chain.chain_id

    def light_block(self, height: int) -> LightBlock:
        self.asked.append(height)
        if height == 0:
            height = self.chain.n
        if height > self.chain.n:
            raise P.ErrHeightTooHigh(str(height))
        if height < 1:
            raise P.ErrLightBlockNotFound(str(height))
        return self.chain.light_block(height)

    def report_evidence(self, ev) -> None:
        self.reported_evidence.append(ev)


def can_trust(chain: Chain, trusted: int, target: int, level: Fraction = Fraction(1, 3)) -> bool:
    """Does the trusted height's set vouch for the target (every member of
    the target's set signed it)?  Adjacent heights always link."""
    if target == trusted + 1:
        return True
    overlap = len(chain.addresses(trusted) & chain.addresses(target))
    return Fraction(overlap, chain.window) > level


def expected_trace(chain: Chain, trusted: int, target: int) -> list[int]:
    """The heights the client's bisection (pivot at 9/16) verifies."""
    cache, depth, verified, trace = [target], 0, trusted, [trusted]
    while True:
        if not can_trust(chain, verified, cache[depth]):
            if depth == len(cache) - 1:
                cache.append(verified + (cache[depth] - verified) * 9 // 16)
            depth += 1
            continue
        if depth == 0:
            return trace + [target]
        verified = cache[depth]
        cache = cache[:depth]
        depth = 0
        trace.append(verified)


def attack_fields(chain: Chain, common: int, conflict: int) -> tuple[int, list, int]:
    """(common height, byzantine validators, total power) the evidence
    against a lunatic primary holds: the common set's members that signed
    the forged block, by (-power, address)."""
    signers = chain.addresses(conflict)
    byz = sorted((v for v in chain.validators(common) if v.address in signers),
                 key=lambda v: (-v.voting_power, v.address))
    return common, byz, chain.power * chain.window
