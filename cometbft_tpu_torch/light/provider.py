"""Light-block providers (reference: light/provider/; a copy of
cometbft_tpu/light/provider.py).

A provider serves LightBlocks for a chain and accepts evidence reports.
BlockStoreProvider serves them from a node's block and state stores
(store/block_store.py, state/store.py; duck-typed: ``height``,
``load_block_meta``, ``load_block_commit``; ``load_validators``,
``load_consensus_params``); light/rpc.HTTPProvider serves them from a
full node's JSON-RPC behind the same three methods.
"""

from __future__ import annotations

from typing import Protocol

from ..types.light_block import LightBlock, SignedHeader


class ProviderError(Exception):
    pass


class ErrLightBlockNotFound(ProviderError):
    """Benign: the provider simply doesn't have the requested height."""


class ErrHeightTooHigh(ProviderError):
    """Benign: the provider hasn't reached the requested height yet."""


class ErrBadLightBlock(ProviderError):
    """Malevolent or broken provider: drop it."""


class Provider(Protocol):
    def chain_id(self) -> str: ...

    def light_block(self, height: int) -> LightBlock:
        """Height 0 means the latest (provider.go LightBlock)."""
        ...

    def report_evidence(self, ev) -> None: ...


class BlockStoreProvider:
    """Serves light blocks straight from a node's stores.  ``device`` is
    where a served block's validator-set hash is checked (the kernels on
    the card for large sets)."""

    def __init__(self, chain_id: str, block_store, state_store, *, device="cuda"):
        self._chain_id = chain_id
        self.block_store = block_store
        self.state_store = state_store
        self.device = device
        self.reported_evidence: list = []

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock:
        from ..types.block import Header

        if height == 0:
            height = self.block_store.height
        if height > self.block_store.height:
            raise ErrHeightTooHigh(f"height {height} > {self.block_store.height}")
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        vals = self.state_store.load_validators(height)
        if meta is None or commit is None or vals is None:
            raise ErrLightBlockNotFound(f"no light block at height {height}")
        lb = LightBlock(
            SignedHeader(Header.from_proto(meta.header), commit), vals
        )
        try:
            lb.validate_basic(self._chain_id, self.device)
        except Exception as e:  # noqa: BLE001
            raise ErrBadLightBlock(str(e)) from e
        return lb

    def consensus_params(self, height: int):
        """Params effective at a height (statesync's state provider
        cross-checks the result against the verified header hash)."""
        return self.state_store.load_consensus_params(height)

    def report_evidence(self, ev) -> None:
        self.reported_evidence.append(ev)
