"""Evidence pool: verified byzantine-behavior proofs awaiting inclusion
(a copy of cometbft_tpu/evidence/pool.py, the same keys and values).

Reference: internal/evidence/pool.go.  Same lifecycle — consensus reports
conflicting votes into a buffer; Update() at each committed height turns
them into DuplicateVoteEvidence stamped with that block's time, moves
included evidence to the committed set, and prunes by age — but the
storage is a straight prefix layout over the db abstraction (pending
records sort by (height, hash) so PendingEvidence pops oldest-first)
instead of the reference's clist + orderedcode layering.

``device`` (default ``"cuda"``) and ``comb_cache`` reach every check the
pool runs: a light-client attack's commit checks go through the verify
service under CONSENSUS on that device.  Without a card the default
raises ``NoCudaDevice`` when the pool is made.
"""

from __future__ import annotations

import logging
import struct
import threading

from .._device import resolve_device
from ..types.evidence import (
    DuplicateVoteEvidence,
    Evidence,
    LightClientAttackEvidence,
    evidence_from_proto,
    evidence_to_proto,
)
from ..wire import types as pb
from . import verify as verify_mod

_PENDING = b"evP:"
_COMMITTED = b"evC:"


class EvidenceError(Exception):
    pass


class ErrInvalidEvidence(EvidenceError):
    def __init__(self, ev, reason):
        super().__init__(f"invalid evidence {ev!r}: {reason}")
        self.evidence = ev
        self.reason = reason


def _key(prefix: bytes, ev: Evidence) -> bytes:
    return prefix + struct.pack(">q", ev.height()) + ev.hash()


class EvidencePool:
    """sm.EvidencePool contract: pending_evidence / check_evidence /
    update / report_conflicting_votes (+ add_evidence from the reactor)."""

    def __init__(self, db, state_store, block_store, *, device="cuda", comb_cache=None):
        resolve_device(device)
        self.db = db
        self.state_store = state_store
        self.block_store = block_store
        self.device = device
        self.comb_cache = comb_cache
        self.logger = logging.getLogger("cometbft_tpu_torch.evidence")
        self._mtx = threading.Lock()
        state = state_store.load()
        if state is None:
            raise EvidenceError("cannot start evidence pool without state")
        self.state = state
        self._consensus_buffer: list[tuple] = []  # (vote_a, vote_b)
        self._size = sum(1 for _ in self.db.iterator(_PENDING, _PENDING + b"\xff"))
        self.pruning_height = 0
        self.pruning_time_ns = 0
        # wakes the gossip reactor when new evidence lands
        self._added = threading.Condition(self._mtx)
        self._add_seq = 0

    # ------------------------------------------------------------- queries

    def size(self) -> int:
        with self._mtx:
            return self._size

    def pending_evidence(self, max_bytes: int) -> tuple[list[Evidence], int]:
        """Oldest-first pending evidence under the byte budget
        (pool.go:142); returns (list, proto size)."""
        out, total = [], 0
        for _, raw in self.db.iterator(_PENDING, _PENDING + b"\xff"):
            ev = evidence_from_proto_bytes(raw)
            sz = len(raw)
            if max_bytes >= 0 and total + sz > max_bytes:
                break
            out.append(ev)
            total += sz
        return out, total

    def is_pending(self, ev: Evidence) -> bool:
        return self.db.has(_key(_PENDING, ev))

    def is_committed(self, ev: Evidence) -> bool:
        return self.db.has(_key(_COMMITTED, ev))

    # ----------------------------------------------------------- admission

    def add_evidence(self, ev: Evidence) -> None:
        """Gossip/RPC entry: verify against state, persist (pool.go:190)."""
        if self.is_pending(ev):
            return
        if self.is_committed(ev):
            return  # stale gossip from a peer that's behind — not a fault
        try:
            ev.validate_basic()
            verify_mod.verify(self, ev)
        except Exception as e:  # noqa: BLE001
            raise ErrInvalidEvidence(ev, e) from e
        self._add_pending(ev)
        self.logger.info(f"verified new evidence of byzantine behavior: {ev!r}")

    def report_conflicting_votes(self, vote_a, vote_b) -> None:
        """Consensus entry (pool.go:235): buffered until the height
        finishes so the evidence carries the committed block's time."""
        with self._mtx:
            self._consensus_buffer.append((vote_a, vote_b))

    # back-compat shim for callers that pass pre-built evidence
    def add_evidence_from_consensus(self, ev: DuplicateVoteEvidence) -> None:
        self.report_conflicting_votes(ev.vote_a, ev.vote_b)

    def check_evidence(self, ev_list: list[Evidence]) -> None:
        """Verify a proposed block's evidence list (pool.go:248)."""
        seen = set()
        for ev in ev_list:
            # light attacks are always re-verified: a different conflicting
            # block can share a hash prefix (pool.go:248 comment)
            if isinstance(ev, LightClientAttackEvidence) or not self.is_pending(ev):
                if self.is_committed(ev):
                    raise ErrInvalidEvidence(ev, "evidence was already committed")
                ev.validate_basic()
                try:
                    verify_mod.verify(self, ev)
                except Exception as e:  # noqa: BLE001
                    raise ErrInvalidEvidence(ev, e) from e
                if not self.is_pending(ev):
                    self._add_pending(ev)  # have it ready for ABCI
            h = ev.hash()
            if h in seen:
                raise ErrInvalidEvidence(ev, "duplicate evidence in block")
            seen.add(h)

    # -------------------------------------------------------------- update

    def update(self, state, ev_list: list[Evidence]) -> None:
        """Called by the executor after every applied block (pool.go:161)."""
        if state.last_block_height <= self.state.last_block_height:
            raise EvidenceError(
                f"update to height {state.last_block_height} <= "
                f"{self.state.last_block_height}"
            )
        self._process_consensus_buffer(state)
        with self._mtx:
            self.state = state
        self._mark_committed(ev_list)
        if (
            self.size() > 0
            and state.last_block_height > self.pruning_height
            and state.last_block_time.unix_ns() > self.pruning_time_ns
        ):
            self.pruning_height, self.pruning_time_ns = self._prune_expired()

    def _process_consensus_buffer(self, state) -> None:
        with self._mtx:
            buffered, self._consensus_buffer = self._consensus_buffer, []
        for vote_a, vote_b in buffered:
            try:
                if vote_a.height == state.last_block_height:
                    ev = DuplicateVoteEvidence.from_votes(
                        vote_a, vote_b, state.last_block_time, state.last_validators
                    )
                elif vote_a.height < state.last_block_height:
                    val_set = self.state_store.load_validators(vote_a.height)
                    meta = self.block_store.load_block_meta(vote_a.height)
                    if val_set is None or meta is None:
                        self.logger.error(
                            f"no stored context for conflicting votes at "
                            f"height {vote_a.height}"
                        )
                        continue
                    ev = DuplicateVoteEvidence.from_votes(
                        vote_a, vote_b, meta.header.time, val_set
                    )
                else:
                    self.logger.error(
                        f"conflicting votes from future height {vote_a.height}"
                    )
                    continue
                if self.is_pending(ev) or self.is_committed(ev):
                    continue
                self._add_pending(ev)
                self.logger.info(
                    f"duplicate vote evidence created from consensus: {ev!r}"
                )
            except Exception as e:  # noqa: BLE001
                self.logger.error(f"failed to form duplicate vote evidence: {e}")

    def _mark_committed(self, ev_list: list[Evidence]) -> None:
        if not ev_list:
            return
        height = self.state.last_block_height
        sets, deletes = [], []
        with self._mtx:
            for ev in ev_list:
                sets.append((_key(_COMMITTED, ev), struct.pack(">q", height)))
                pk = _key(_PENDING, ev)
                if self.db.has(pk):
                    deletes.append(pk)
                    self._size -= 1
            self.db.write_batch(sets, deletes)

    def _prune_expired(self) -> tuple[int, int]:
        """Drop expired pending evidence; returns (height, time) at which
        the next earliest evidence expires (pool.go:458)."""
        params = self.state.consensus_params.evidence
        deletes = []
        next_h, next_t = self.state.last_block_height, self.state.last_block_time.unix_ns()
        with self._mtx:
            for k, raw in self.db.iterator(_PENDING, _PENDING + b"\xff"):
                ev = evidence_from_proto_bytes(raw)
                if verify_mod.is_evidence_expired(
                    self.state.last_block_height,
                    self.state.last_block_time.unix_ns(),
                    ev.height(),
                    ev.time().unix_ns(),
                    params,
                ):
                    deletes.append(k)
                else:
                    # first non-expired entry: everything later is newer
                    next_h = ev.height() + params.max_age_num_blocks + 1
                    next_t = ev.time().unix_ns() + params.max_age_duration_ns
                    break
            if deletes:
                self.db.write_batch([], deletes)
                self._size -= len(deletes)
        return next_h, next_t

    # ------------------------------------------------------------ plumbing

    def _add_pending(self, ev: Evidence) -> None:
        with self._mtx:
            self.db.set(_key(_PENDING, ev), evidence_to_proto(ev).encode())
            self._size += 1
            self._add_seq += 1
            self._added.notify_all()

    def wait_new_evidence(self, last_seq: int, timeout: float) -> int:
        with self._added:
            if self._add_seq == last_seq:
                self._added.wait(timeout)
            return self._add_seq

    def add_seq(self) -> int:
        with self._mtx:
            return self._add_seq


def evidence_from_proto_bytes(raw: bytes) -> Evidence:
    return evidence_from_proto(pb.EvidenceProto.decode(raw))
