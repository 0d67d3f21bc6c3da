"""The light chain of the parity tests: tests/torch_light_corpus.py's chain
(the port's types and host signer, commits signed on first use), with
each block also carried to the JAX package as the proto bytes the port's
``to_proto().encode()`` writes.  (That the two packages build the same
bytes from the same keys is tests/test_torch_proto_decode.py's check.)

The set at height h is a window of ``window`` of the 24 keys, moving by
one key every ``rotate_every`` heights, every validator of power 10:
sets far apart share less than 1/3 of their power, so bisection pivots.
``fork_from`` gives every height from there another app_hash, signed by
the same keys (a lunatic primary's chain)."""

from __future__ import annotations

import numpy as np

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.light import provider as jprov
from cometbft_tpu.types.light_block import LightBlock as JLightBlock
from cometbft_tpu.wire import types_pb as jpb

from cometbft_tpu_torch.crypto import ed25519 as ped
from cometbft_tpu_torch.light import provider as pprov

import torch_light_corpus as LCo

CHAIN_ID = "torch-light-client-chain"
NS = LCo.NS
GENESIS_NS = LCo.GENESIS_NS
PERIOD_NS = 24 * 3600 * NS
NOW_NS = GENESIS_NS + 5000 * LCo.BLOCK_NS
_RNG = np.random.default_rng(20261018)
_SEEDS = [_RNG.bytes(32) for _ in range(24)]
KEYS = [jed.PrivKey.from_seed(s) for s in _SEEDS]  # the JAX package's keys
_PORT_KEYS = [ped.PrivKey.from_seed(s) for s in _SEEDS]


class Chain(LCo.Chain):
    def __init__(self, n: int, rotate_every: int = 10**9, window: int = 4, fork_from: int | None = None,
                 fork_tag: bytes = b"fork"):
        super().__init__(CHAIN_ID, _PORT_KEYS, n, window, 1, rotate_every, fork_from=fork_from,
                         fork_tag=fork_tag)
        self._jax: dict[int, JLightBlock] = {}
        self._port: dict[int, object] = {}

    def port(self, h: int):
        """The port's LightBlock at h (one object a height)."""
        if h not in self._port:
            self._port[h] = self.light_block(h)
        return self._port[h]

    def jax(self, h: int) -> JLightBlock:
        """The JAX LightBlock at h, decoded from the port block's bytes."""
        if h not in self._jax:
            raw = self.port(h).to_proto().encode()
            self._jax[h] = JLightBlock.from_proto(jpb.LightBlockProto.decode(raw))
        return self._jax[h]


class Provider:
    """A provider over a Chain for one package (``side`` "jax" or
    "port"), with that package's errors; logs every height asked for.
    ``blocks`` overrides heights (a forged or tampered block) and
    ``fail`` makes every request raise ErrBadLightBlock."""

    def __init__(self, chain: Chain, side: str, blocks=None, fail: bool = False):
        self.chain, self.side = chain, side
        self.errors = jprov if side == "jax" else pprov
        self.blocks = dict(blocks or {})
        self.fail = fail
        self.asked: list[int] = []
        self.reported_evidence: list = []

    def chain_id(self) -> str:
        return CHAIN_ID

    def light_block(self, height: int):
        self.asked.append(height)
        if self.fail:
            raise self.errors.ErrBadLightBlock(f"broken provider at {height}")
        if height == 0:
            height = self.chain.n
        if height > self.chain.n:
            raise self.errors.ErrHeightTooHigh(str(height))
        if height < 1:
            raise self.errors.ErrLightBlockNotFound(str(height))
        if height in self.blocks:
            return self.blocks[height]
        return self.chain.jax(height) if self.side == "jax" else self.chain.port(height)

    def report_evidence(self, ev) -> None:
        self.reported_evidence.append(ev)


def outcome(fn):
    """(class name, message) of what fn() raised, or ("ok", the height of
    what it returned) — the outcome compared across packages."""
    try:
        out = fn()
    except Exception as e:  # the outcome under comparison
        return type(e).__name__, str(e)
    return "ok", getattr(out, "height", out)
