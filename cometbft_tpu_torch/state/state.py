"""State: the deterministic result of applying blocks up to a height
(reference: state/state.go; a copy of cometbft_tpu/state/state.py).

Holds the validator-set trio (last/current/next — next is the set for
height+1, delayed one block), consensus params, and the app hash; it is
everything the executor needs to validate and apply the next block.

The JAX class defines ``make_block`` twice and Python keeps the second;
the port has that one alone: the genesis time at the initial height (the
proposer's time under PBTS), then the proposer's time or the last
commit's weighted median.  ``device`` reaches the validator-set and data
hashes (K7 + K8 for 512 validators or txs and more).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

from ..types.block import Block, BlockID, Commit, Data, Header, ZERO_TIME
from ..types.genesis import GenesisDoc
from ..types.params import ConsensusParams
from ..types.validators import ValidatorSet
from ..wire import state as state_pb
from ..wire import types as pb
from ..wire.canonical import Timestamp

BLOCK_PROTOCOL_VERSION = 11
SOFTWARE_VERSION = "cometbft-tpu/0.1.0"

# Default delay between commit and the next height's proposal
# (state.NextBlockDelay; replaces config timeout_commit).
DEFAULT_NEXT_BLOCK_DELAY_NS = 1_000_000_000


@dataclass
class State:
    chain_id: str
    initial_height: int = 1
    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time: Timestamp = ZERO_TIME
    next_validators: ValidatorSet | None = None
    validators: ValidatorSet | None = None
    last_validators: ValidatorSet | None = None
    last_height_validators_changed: int = 0
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0
    last_results_hash: bytes = b""
    app_hash: bytes = b""
    next_block_delay_ns: int = DEFAULT_NEXT_BLOCK_DELAY_NS
    app_version: int = 0

    def copy(self) -> "State":
        new = State(
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=self.last_block_height,
            last_block_id=self.last_block_id,
            last_block_time=self.last_block_time,
            next_validators=self.next_validators.copy() if self.next_validators else None,
            validators=self.validators.copy() if self.validators else None,
            last_validators=self.last_validators.copy() if self.last_validators else None,
            last_height_validators_changed=self.last_height_validators_changed,
            consensus_params=copy.deepcopy(self.consensus_params),
            last_height_consensus_params_changed=self.last_height_consensus_params_changed,
            last_results_hash=self.last_results_hash,
            app_hash=self.app_hash,
            next_block_delay_ns=self.next_block_delay_ns,
            app_version=self.app_version,
        )
        return new

    def is_empty(self) -> bool:
        return self.validators is None

    # ------------------------------------------------------------- proto

    def to_proto(self) -> state_pb.StateProto:
        return state_pb.StateProto(
            version=state_pb.Version(
                consensus=pb.Consensus(block=BLOCK_PROTOCOL_VERSION, app=self.app_version),
                software=SOFTWARE_VERSION,
            ),
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=self.last_block_height,
            last_block_id=self.last_block_id.to_proto(),
            last_block_time=self.last_block_time,
            next_validators=self.next_validators.to_proto() if self.next_validators else None,
            validators=self.validators.to_proto() if self.validators else None,
            last_validators=self.last_validators.to_proto() if self.last_validators else None,
            last_height_validators_changed=self.last_height_validators_changed,
            consensus_params=self.consensus_params.to_proto(),
            last_height_consensus_params_changed=self.last_height_consensus_params_changed,
            last_results_hash=self.last_results_hash,
            app_hash=self.app_hash,
            next_block_delay=pb.Duration.from_ns(self.next_block_delay_ns),
        )

    @classmethod
    def from_proto(cls, m: state_pb.StateProto) -> "State":
        ver = m.version or state_pb.Version()
        app_version = ver.consensus.app if ver.consensus else 0
        delay = m.next_block_delay or pb.Duration()
        return cls(
            chain_id=m.chain_id,
            initial_height=m.initial_height,
            last_block_height=m.last_block_height,
            last_block_id=BlockID.from_proto(m.last_block_id or pb.BlockID()),
            last_block_time=m.last_block_time or ZERO_TIME,
            next_validators=ValidatorSet.from_proto(m.next_validators) if m.next_validators else None,
            validators=ValidatorSet.from_proto(m.validators) if m.validators else None,
            last_validators=ValidatorSet.from_proto(m.last_validators)
            if m.last_validators and m.last_validators.validators
            else None,
            last_height_validators_changed=m.last_height_validators_changed,
            consensus_params=ConsensusParams.from_proto(m.consensus_params or pb.ConsensusParamsProto()),
            last_height_consensus_params_changed=m.last_height_consensus_params_changed,
            last_results_hash=m.last_results_hash,
            app_hash=m.app_hash,
            next_block_delay_ns=delay.ns(),
            app_version=app_version,
        )

    def bytes(self) -> bytes:
        return self.to_proto().encode()

    def make_block(
        self,
        height: int,
        txs: list[bytes],
        last_commit: Commit | None,
        evidence: list,
        proposer_address: bytes,
        block_time: Timestamp | None = None,
        device="cuda",
    ) -> Block:
        """Assemble a proposal block with the header fields this state
        dictates (state.go:262 MakeBlock).

        At the initial height the timestamp is the genesis time (or the
        proposer's time under PBTS, supplied via block_time); afterwards
        block_time is the proposer's time (PBTS) and defaults to the
        commit's weighted median (BFT time, state.go:252-260).
        """
        if height == self.initial_height:
            if block_time is not None and self.consensus_params.feature.pbts_enabled(height):
                ts = block_time
            else:
                ts = self.last_block_time  # genesis time
        elif block_time is not None:
            ts = block_time
        else:
            ts = last_commit.median_time(self.last_validators)
        header = Header(
            version=pb.Consensus(block=BLOCK_PROTOCOL_VERSION, app=self.app_version),
            chain_id=self.chain_id,
            height=height,
            time=ts,
            last_block_id=self.last_block_id,
            validators_hash=self.validators.hash(device),
            next_validators_hash=self.next_validators.hash(device),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            proposer_address=proposer_address,
        )
        block = Block(
            header=header,
            data=Data(txs=list(txs)),
            evidence=list(evidence),
            last_commit=last_commit,
        )
        block.fill_header(device)
        return block


def make_genesis_state(genesis: GenesisDoc) -> State:
    """Bootstrap State from a genesis doc (state.go MakeGenesisState)."""
    genesis.validate_and_complete()
    val_set = genesis.validator_set()
    return State(
        chain_id=genesis.chain_id,
        initial_height=genesis.initial_height,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time=genesis.genesis_time,
        next_validators=val_set.copy(),
        validators=val_set.copy(),
        last_validators=None,
        last_height_validators_changed=genesis.initial_height,
        consensus_params=genesis.consensus_params,
        last_height_consensus_params_changed=genesis.initial_height,
        app_hash=genesis.app_hash,
        app_version=genesis.consensus_params.version.app,
    )
