"""Light client: trusted-header tracking with sequential or skipping
(bisection) verification (reference: light/client.go:133; a copy of
cometbft_tpu/light/client.py).

The client holds one primary provider and a set of witnesses.  Every
newly verified block is cross-checked against the witnesses by the
divergence detector (detector.py); a witness that serves a conflicting
header yields LightClientAttackEvidence reported to both sides.

Every hop goes through light/verifier.verify: the new set's hash on the
card (K7 + K8 for sets of 512 and more) and the commit checks through
the verify service under Klass.BACKGROUND, so the client's checks never
delay consensus work.  ``device`` (default ``"cuda"``; ``"cpu"`` runs
the kernels' plain versions) and ``comb_cache`` reach every verify,
LightBlock.validate_basic and verify_commit_light call.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from fractions import Fraction

from ..types.light_block import LightBlock
from . import detector as detector_mod
from .provider import (
    ErrHeightTooHigh,
    ErrLightBlockNotFound,
    Provider,
    ProviderError,
)
from .store import LightStore
from .verifier import (
    DEFAULT_MAX_CLOCK_DRIFT_NS,
    DEFAULT_TRUST_LEVEL,
    ErrNewValSetCantBeTrusted,
    LightClientError,
    validate_trust_level,
    verify,
    verify_backwards,
)

SEQUENTIAL = "sequential"
SKIPPING = "skipping"

# pivot fraction for bisection (client.go:28-32)
SKIP_NUMERATOR, SKIP_DENOMINATOR = 9, 16
DEFAULT_PRUNING_SIZE = 1000


@dataclass
class TrustOptions:
    """Social-consensus root of trust (client.go TrustOptions)."""

    period_ns: int
    height: int
    hash: bytes


class ErrNoWitnesses(LightClientError):
    pass


class ErrLightClientAttack(LightClientError):
    pass


class Client:
    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: list[Provider],
        store: LightStore,
        mode: str = SKIPPING,
        trust_level: Fraction = DEFAULT_TRUST_LEVEL,
        max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
        pruning_size: int = DEFAULT_PRUNING_SIZE,
        now_fn=None,
        *,
        device="cuda",
        comb_cache=None,
    ):
        validate_trust_level(trust_level)
        self.chain_id = chain_id
        self.trusting_period_ns = trust_options.period_ns
        self.trust_level = trust_level
        self.max_clock_drift_ns = max_clock_drift_ns
        self.mode = mode
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = store
        self.pruning_size = pruning_size
        self.device = device
        self.comb_cache = comb_cache
        self.logger = logging.getLogger("cometbft_tpu_torch.light")
        self._mtx = threading.Lock()
        if now_fn is None:
            import time

            now_fn = time.time_ns
        self.now_ns = now_fn
        self._initialize(trust_options)

    # ------------------------------------------------------------ trust init

    def _initialize(self, opts: TrustOptions) -> None:
        """client.go:357 initializeWithTrustOptions: fetch the trusted
        block, check the hash matches the social-consensus root, verify
        self-consistency."""
        existing = self.store.light_block(opts.height)
        if existing is not None:
            if existing.hash == opts.hash:
                return
            # the store disagrees with the new social-consensus root: every
            # block in it descends from a now-untrusted lineage — purge it
            # all before re-rooting (client.go checkTrustedHeaderUsingOptions)
            self.logger.error(
                f"stored header at trust height {opts.height} conflicts with "
                "the new trust options; purging the light store"
            )
            self.store.delete_after(0)
        lb = self.primary.light_block(opts.height)
        if lb.hash != opts.hash:
            raise LightClientError(
                f"expected header hash {opts.hash.hex()} at height "
                f"{opts.height}, got {lb.hash.hex()}"
            )
        lb.validate_basic(self.chain_id, self.device)
        # 2/3 of its own claimed set must have signed it
        from ..types.validation import verify_commit_light
        from ..verifysvc.service import Klass

        verify_commit_light(
            self.chain_id,
            lb.validator_set,
            lb.signed_header.commit.block_id,
            lb.height,
            lb.signed_header.commit,
            klass=Klass.BACKGROUND,
            device=self.device,
            comb_cache=self.comb_cache,
        )
        self.store.save_light_block(lb)

    # --------------------------------------------------------------- queries

    def trusted_light_block(self, height: int) -> LightBlock | None:
        return self.store.light_block(height)

    def last_trusted_height(self) -> int:
        return self.store.latest_height()

    # ------------------------------------------------------------- verifying

    def update(self, now_ns: int | None = None) -> LightBlock | None:
        """Fetch + verify the primary's latest block if newer than our
        latest trusted one (client.go:431)."""
        now_ns = self.now_ns() if now_ns is None else now_ns
        latest_trusted = self.store.latest_light_block()
        if latest_trusted is None:
            raise LightClientError("no trusted state — initialize first")
        latest = self.primary.light_block(0)
        if latest.height <= latest_trusted.height:
            return None
        self._verify_light_block(latest, now_ns)
        return latest

    def verify_light_block_at_height(
        self, height: int, now_ns: int | None = None
    ) -> LightBlock:
        """client.go:469 — returns the verified block, fetching it from
        the primary if we don't already trust it."""
        if height <= 0:
            raise LightClientError("height must be positive")
        now_ns = self.now_ns() if now_ns is None else now_ns
        lb = self.store.light_block(height)
        if lb is not None:
            return lb
        lb = self.primary.light_block(height)
        self._verify_light_block(lb, now_ns)
        return lb

    def _verify_light_block(self, new_lb: LightBlock, now_ns: int) -> None:
        """client.go:553 — pick the verification path by position."""
        new_lb.validate_basic(self.chain_id, self.device)
        closest_under = self.store.light_block_before(new_lb.height + 1)
        if closest_under is not None and closest_under.height == new_lb.height:
            return  # already trusted
        if closest_under is None:
            # target is below our first trusted block: walk backwards
            first = self.store.first_light_block()
            if first is None:
                raise LightClientError("no trusted state")
            self._backwards(first, new_lb)
            self.store.save_light_block(new_lb)
            return

        if self.mode == SEQUENTIAL:
            trace = self._verify_sequential(closest_under, new_lb, now_ns)
        else:
            trace = self._verify_skipping(self.primary, closest_under, new_lb, now_ns)

        # cross-examine the witnesses over the verification trace
        if self.witnesses:
            detector_mod.detect_divergence(self, trace, now_ns)
        else:
            self.logger.error(
                "no witnesses configured: a lying primary cannot be detected"
            )

        for lb in trace[1:]:
            self.store.save_light_block(lb)
        if self.pruning_size > 0:
            self.store.prune(self.pruning_size)

    def _verify(self, trusted: LightBlock, lb: LightBlock, now_ns: int) -> None:
        verify(
            trusted.signed_header,
            trusted.validator_set,
            lb.signed_header,
            lb.validator_set,
            self.trusting_period_ns,
            now_ns,
            self.max_clock_drift_ns,
            self.trust_level,
            device=self.device,
            comb_cache=self.comb_cache,
        )

    def _verify_sequential(
        self, trusted: LightBlock, new_lb: LightBlock, now_ns: int
    ) -> list[LightBlock]:
        """client.go:608 — verify every height in ascending order."""
        trace = [trusted]
        verified = trusted
        for h in range(trusted.height + 1, new_lb.height + 1):
            lb = new_lb if h == new_lb.height else self.primary.light_block(h)
            self._verify(verified, lb, now_ns)
            verified = lb
            trace.append(lb)
        return trace

    def _verify_skipping(
        self, source: Provider, trusted: LightBlock, new_lb: LightBlock, now_ns: int
    ) -> list[LightBlock]:
        """client.go:701 verifySkipping — bisection over the trust gap."""
        block_cache = [new_lb]
        depth = 0
        verified = trusted
        trace = [trusted]
        while True:
            try:
                self._verify(verified, block_cache[depth], now_ns)
            except ErrNewValSetCantBeTrusted:
                # not enough trust to jump: bisect at 9/16 of the gap
                if depth == len(block_cache) - 1:
                    pivot = (
                        verified.height
                        + (block_cache[depth].height - verified.height)
                        * SKIP_NUMERATOR
                        // SKIP_DENOMINATOR
                    )
                    try:
                        interim = source.light_block(pivot)
                    except (ErrLightBlockNotFound, ErrHeightTooHigh) as e:
                        raise ErrNewValSetCantBeTrusted(str(e)) from e
                    except ProviderError as e:
                        raise LightClientError(
                            f"verification failed fetching pivot {pivot}: {e}"
                        ) from e
                    block_cache.append(interim)
                depth += 1
                continue
            # verified this hop
            if depth == 0:
                trace.append(new_lb)
                return trace
            verified = block_cache[depth]
            block_cache = block_cache[:depth]
            depth = 0
            trace.append(verified)

    def _backwards(self, trusted: LightBlock, new_lb: LightBlock) -> None:
        """client.go:923 — hash-linked walk below the first trusted block."""
        verified_header = trusted.signed_header.header
        while verified_header.height > new_lb.height:
            h = verified_header.height - 1
            interim = (
                new_lb
                if h == new_lb.height
                else self.primary.light_block(h)
            )
            verify_backwards(interim.signed_header.header, verified_header)
            verified_header = interim.signed_header.header

    # -------------------------------------------------------------- witnesses

    def remove_witnesses(self, indexes: list[int]) -> None:
        """client.go:1009 — drop forked/unresponsive witnesses."""
        if len(indexes) >= len(self.witnesses) and self.witnesses:
            self.logger.error("removing every witness — detection disabled")
        for i in sorted(set(indexes), reverse=True):
            if 0 <= i < len(self.witnesses):
                self.witnesses.pop(i)
