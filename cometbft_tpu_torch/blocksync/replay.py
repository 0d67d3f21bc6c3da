"""Streamed commit replay: the blocksync catch-up path (the port of
cometbft_tpu/blocksync/replay.py).

A catching-up node verifies one historical commit a replayed block
(internal/blocksync/reactor.go:547, VerifyCommitLight).  On the card the
stream pipelines: CombBatchVerifier.submit returns before its payload is
filled, so while the staging thread fills, copies and launches block i
the caller assembles block i + 1, and verdicts are drained a few blocks
behind submission.  With the set's comb tables resident a block costs
one payload copy and K1 -> K2 -> K4.

Both entry points are thin schedulers over the verify service's
BLOCKSYNC class, so a replay can never diverge from the consensus
verifier's semantics and never cuts ahead of consensus work:

  * :class:`CommitStreamVerifier` streams raw (pubkey, msg, sig) commits
    of one cached set, as the JAX class does;
  * :func:`verify_ahead` is the reactor's verify-ahead
    (cometbft_tpu/blocksync/reactor.py:370-430, ``_top_up_verify_pipeline``
    and ``_process_block``'s collect) over (BlockID, height, Commit)
    triples: types/validation.submit_verify_commit_light under
    Klass.BLOCKSYNC, ``depth`` heights in flight, each in a
    ``blocksync.verify_ahead_submit`` span.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

from ..utils import tracing


class CommitStreamVerifier:
    """Pipelines comb-cached commit verification over a block stream.

    entry: a models/comb_verifier cache entry of the validator set that
    signed the stream's commits (blocksync knows the set in advance: it
    fetched the headers first).  depth: how many commits may be in
    flight before the oldest is drained (2 = a double buffer; at least
    1).  service: the verify service (default: the global one of the
    entry's device)."""

    def __init__(self, entry, depth: int = 2, service=None):
        self._entry = entry
        self._depth = max(1, int(depth))
        self._svc = service
        self._inflight: deque = deque()

    def run(self, commits: Iterable[list[tuple[bytes, bytes, bytes]]]) -> Iterator[tuple[bool, list[bool]]]:
        """Stream commits (each a list of (pubkey, msg, sig)) through the
        pipeline, yielding (all_ok, per_signature) in block order.  A
        commit with a key outside the set demotes only itself (to the
        uncached verifier), in its place in the order."""
        from ..verifysvc.client import ServiceBatchVerifier
        from ..verifysvc.service import Klass, global_service

        svc = self._svc if self._svc is not None else global_service(self._entry.device)
        for items in commits:
            bv = ServiceBatchVerifier(Klass.BLOCKSYNC, mode=("comb", self._entry), service=svc)
            for pub, msg, sig in items:
                bv.add(pub, msg, sig)
            self._inflight.append((bv, bv.submit()))
            while len(self._inflight) > self._depth:
                done, ticket = self._inflight.popleft()
                yield done.collect(ticket)
        while self._inflight:
            done, ticket = self._inflight.popleft()
            yield done.collect(ticket)


def _route(pending) -> str:
    """The mode a pending check took ("comb", "plain"), or "cache" when
    the signature cache answered it."""
    bv = pending._bv
    return "cache" if bv is None else bv.mode[0]


def verify_ahead(chain_id: str, vals, blocks: Iterable, depth: int = 2, *, device="cuda",
                 comb_cache=None) -> Iterator[tuple[int, str, Exception | None]]:
    """The reactor's verify-ahead over ``blocks``, (BlockID, height,
    Commit) triples of the validator set ``vals``: up to ``depth``
    heights are submitted (submit_verify_commit_light under
    Klass.BLOCKSYNC) before the oldest is collected.  Yields (height,
    route, error) in height order: route is the service mode the check
    took ("comb", "plain"), "cache", or "serial" where the commit takes
    no batch path (verify_commit_light runs then, at collect time);
    error is None for a verified commit, else what verify_commit_light
    would have raised (a submit-time error included: the reactor leaves
    those to its serial path)."""
    from ..types import validation
    from ..verifysvc.service import Klass

    depth = max(1, int(depth))
    kw = dict(device=device, comb_cache=comb_cache)
    inflight: deque = deque()

    def drain():
        height, block_id, commit, pending, err = inflight.popleft()
        if err is not None:
            return height, "serial", err
        try:
            if pending is None:
                validation.verify_commit_light(chain_id, vals, block_id, height, commit,
                                               klass=Klass.BLOCKSYNC, **kw)
                return height, "serial", None
            pending.collect()
            return height, _route(pending), None
        except Exception as e:  # noqa: BLE001 — the verdict of this height, in order
            return height, "serial" if pending is None else _route(pending), e

    for block_id, height, commit in blocks:
        pending = err = None
        try:
            with tracing.span(
                "blocksync.verify_ahead_submit", {"height": height} if tracing.enabled() else None
            ):
                pending = validation.submit_verify_commit_light(
                    chain_id, vals, block_id, height, commit, klass=Klass.BLOCKSYNC, **kw)
        except Exception as e:  # noqa: BLE001 — bad peer data: reported at its height
            err = e
        inflight.append((height, block_id, commit, pending, err))
        while len(inflight) > depth:
            yield drain()
    while inflight:
        yield drain()
