"""State store: State record, historical validator sets (stored sparsely),
consensus params, FinalizeBlockResponses (reference: state/store.go —
NewStore:275, Save:377, LoadValidators:923 sparse storage keyed by
lastHeightChanged; a copy of cometbft_tpu/state/store.py, the same keys
and values byte for byte)."""

from __future__ import annotations

import struct
import threading

from ..store.block_store import _timed
from ..store.db import DB
from ..types.params import ConsensusParams
from ..types.validators import ValidatorSet
from ..wire import state as state_pb
from ..wire import types as pb
from ..wire.abci import FinalizeBlockResponse
from .state import State

_STATE_KEY = b"stateKey"
_VALIDATORS_PREFIX = b"validatorsKey:"
_PARAMS_PREFIX = b"consensusParamsKey:"
_ABCI_RESPONSES_PREFIX = b"abciResponsesKey:"


def _hkey(prefix: bytes, height: int) -> bytes:
    return prefix + struct.pack(">q", height)


class StateStore:
    def __init__(self, db: DB):
        self._db = db
        self._mtx = threading.RLock()

    # -------------------------------------------------------------- state

    def load(self) -> State | None:
        raw = self._db.get(_STATE_KEY)
        if not raw:
            return None
        return State.from_proto(state_pb.StateProto.decode(raw))

    @_timed
    def save(self, state: State) -> None:
        """Persist state + validator/params info for its next height
        (store.go:377)."""
        with self._mtx:
            next_height = state.last_block_height + 1
            if next_height == 1:
                next_height = state.initial_height
                # genesis bootstrap: store both current and next validators
                self._save_validators_info(
                    next_height, next_height, state.validators
                )
            self._save_validators_info(
                next_height + 1, state.last_height_validators_changed, state.next_validators
            )
            self._save_params_info(
                next_height, state.last_height_consensus_params_changed, state.consensus_params
            )
            self._db.set(_STATE_KEY, state.bytes())

    def bootstrap(self, state: State) -> None:
        """Store a state snapshot directly (statesync; store.go Bootstrap)."""
        with self._mtx:
            height = state.last_block_height + 1
            if height == 1:
                height = state.initial_height
            if height > 1 and state.last_validators is not None:
                self._save_validators_info(height - 1, height - 1, state.last_validators)
            self._save_validators_info(height, height, state.validators)
            self._save_validators_info(
                height + 1, height + 1, state.next_validators
            )
            self._save_params_info(
                height, state.last_height_consensus_params_changed, state.consensus_params
            )
            self._db.set(_STATE_KEY, state.bytes())

    # --------------------------------------------------------- validators

    def _save_validators_info(
        self, height: int, last_height_changed: int, val_set: ValidatorSet | None
    ) -> None:
        """Sparse storage: the full set is stored only at the height it last
        changed; other heights store a back-pointer (store.go:923-1035)."""
        if last_height_changed > height:
            raise ValueError("lastHeightChanged cannot be greater than height")
        info = state_pb.ValidatorsInfo(last_height_changed=last_height_changed)
        if height == last_height_changed and val_set is not None:
            info.validator_set = val_set.to_proto()
        self._db.set(_hkey(_VALIDATORS_PREFIX, height), info.encode())

    @_timed
    def load_validators(self, height: int) -> ValidatorSet | None:
        raw = self._db.get(_hkey(_VALIDATORS_PREFIX, height))
        if raw is None:
            return None
        info = state_pb.ValidatorsInfo.decode(raw)
        if info.validator_set is None:
            raw2 = self._db.get(_hkey(_VALIDATORS_PREFIX, info.last_height_changed))
            if raw2 is None:
                return None
            info2 = state_pb.ValidatorsInfo.decode(raw2)
            if info2.validator_set is None:
                return None
            vs = ValidatorSet.from_proto(info2.validator_set)
            # advance proposer rotation to the queried height
            delta = height - info.last_height_changed
            if delta > 0:
                vs.increment_proposer_priority(delta)
            return vs
        return ValidatorSet.from_proto(info.validator_set)

    # ------------------------------------------------------------- params

    def _save_params_info(
        self, height: int, last_height_changed: int, params: ConsensusParams
    ) -> None:
        info = state_pb.ConsensusParamsInfo(last_height_changed=last_height_changed)
        if height == last_height_changed:
            info.consensus_params = params.to_proto()
        else:
            info.consensus_params = pb.ConsensusParamsProto()
        self._db.set(_hkey(_PARAMS_PREFIX, height), info.encode())

    def load_consensus_params(self, height: int) -> ConsensusParams | None:
        raw = self._db.get(_hkey(_PARAMS_PREFIX, height))
        if raw is None:
            return None
        info = state_pb.ConsensusParamsInfo.decode(raw)
        empty = pb.ConsensusParamsProto()
        if info.consensus_params is None or info.consensus_params == empty:
            raw2 = self._db.get(_hkey(_PARAMS_PREFIX, info.last_height_changed))
            if raw2 is None:
                return None
            info2 = state_pb.ConsensusParamsInfo.decode(raw2)
            if info2.consensus_params is None:
                return None
            return ConsensusParams.from_proto(info2.consensus_params)
        return ConsensusParams.from_proto(info.consensus_params)

    # ---------------------------------------------------- abci responses

    def save_finalize_block_response(
        self, height: int, resp: FinalizeBlockResponse
    ) -> None:
        info = state_pb.ABCIResponsesInfo(height=height, finalize_block=resp)
        self._db.set(_hkey(_ABCI_RESPONSES_PREFIX, height), info.encode())

    @_timed
    def load_finalize_block_response(self, height: int) -> FinalizeBlockResponse | None:
        raw = self._db.get(_hkey(_ABCI_RESPONSES_PREFIX, height))
        if raw is None:
            return None
        return state_pb.ABCIResponsesInfo.decode(raw).finalize_block

    # ------------------------------------------------------------- prune

    def prune_finalize_block_responses(self, retain_height: int) -> int:
        """Delete only the FinalizeBlock responses below retain_height —
        the block-results retain height is tracked separately from the
        block retain height (state/pruner.go block-results pruning)."""
        deletes = []
        start = _hkey(_ABCI_RESPONSES_PREFIX, 0)
        end = _hkey(_ABCI_RESPONSES_PREFIX, retain_height)
        for key, _ in self._db.iterator(start, end):
            deletes.append(key)
        if deletes:
            self._db.write_batch([], deletes)
        return len(deletes)

    def prune_states(self, retain_height: int, current_height: int) -> int:
        """Delete state artifacts below retain_height (state/pruner.go)."""
        pruned = 0
        deletes = []
        for h in range(1, retain_height):
            if h >= current_height:
                break
            for prefix in (_VALIDATORS_PREFIX, _PARAMS_PREFIX, _ABCI_RESPONSES_PREFIX):
                key = _hkey(prefix, h)
                if self._db.has(key):
                    deletes.append(key)
                    pruned += 1
        if deletes:
            self._db.write_batch([], deletes)
        return pruned
