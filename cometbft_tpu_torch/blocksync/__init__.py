"""Blocksync's verification: the commit stream of a catching-up node,
pipelined through the verify service's BLOCKSYNC class (the port of
cometbft_tpu/blocksync/replay.py and of the reactor's verify-ahead; the
reactor, its pool and its peers are not ported)."""

from .replay import CommitStreamVerifier, verify_ahead

__all__ = ["CommitStreamVerifier", "verify_ahead"]
