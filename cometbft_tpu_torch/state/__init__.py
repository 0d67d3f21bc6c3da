"""State: the State record and its store (reference: state/ — store.go:275;
the port of cometbft_tpu/state/state.py and store.py).  Block execution
comes with the node's host modules."""

from .state import State, make_genesis_state
from .store import StateStore

__all__ = ["State", "StateStore", "make_genesis_state"]
