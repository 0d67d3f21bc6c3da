"""Flight recorder: a bounded ring of recent events tagged with wall
and monotonic time (the port of cometbft_tpu/utils/flightrec.py, whole).

Always on: recording is one lock, one dict and one bounded append.  The
port's writers are the verify service (``verifysvc_backpressure``,
``verifysvc_failover``, ``verifysvc_collect_stall``) and the health
sentinel (``health``); the height / round / step fields stay for the
consensus writers the port does not have yet.  ``dump()`` is what a
forensics artifact (utils/debugdump.stall_report) carries.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class FlightRecorder:
    """Bounded rings of consensus events.  Thread-safe; eviction counts
    are kept so a dump says how much history scrolled away.

    High-rate per-signature events (vote arrivals: ~2·V per height, so
    ~20k/height at the 10k-validator target scale) go to their OWN ring —
    otherwise one height of votes would evict every step/timeout/
    proposal/watchdog entry and the black-box would be blind to exactly
    the state-machine transitions it exists to capture."""

    HIGH_RATE_KINDS = frozenset({"vote"})

    def __init__(self, capacity: int = 1024, vote_capacity: int | None = None):
        self._ring: deque[dict] = deque(maxlen=max(1, capacity))
        self._votes: deque[dict] = deque(
            maxlen=max(1, capacity if vote_capacity is None else vote_capacity)
        )
        self._mtx = threading.Lock()
        self._seq = 0
        self._evicted = 0
        self._votes_evicted = 0

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def record(
        self,
        kind: str,
        height: int = 0,
        round: int = -1,
        step: int = -1,
        **detail,
    ) -> None:
        e = {
            "kind": kind,
            "height": height,
            "round": round,
            "step": step,
            "wall_ns": time.time_ns(),
            "mono_ns": time.perf_counter_ns(),
        }
        if detail:
            e["detail"] = detail
        with self._mtx:
            self._seq += 1
            e["seq"] = self._seq
            if kind in self.HIGH_RATE_KINDS:
                if len(self._votes) == self._votes.maxlen:
                    self._votes_evicted += 1
                self._votes.append(e)
            else:
                if len(self._ring) == self._ring.maxlen:
                    self._evicted += 1
                self._ring.append(e)

    def dump(self) -> dict:
        """Snapshot, oldest first (both rings merged in arrival order):
        {"entries": [...], "count", "evicted", "votes_evicted",
        "capacity", "vote_capacity"} — JSON-serializable as-is (the RPC
        handler returns it verbatim)."""
        with self._mtx:
            entries = sorted(
                list(self._ring) + list(self._votes), key=lambda e: e["seq"]
            )
            return {
                "entries": entries,
                "count": len(entries),
                "evicted": self._evicted,
                "votes_evicted": self._votes_evicted,
                "capacity": self._ring.maxlen,
                "vote_capacity": self._votes.maxlen,
            }

    def clear(self) -> None:
        with self._mtx:
            self._ring.clear()
            self._votes.clear()
            self._evicted = 0
            self._votes_evicted = 0


def _capacity_from_env() -> int:
    from .. import envknobs

    return max(1, envknobs.get_int(envknobs.FLIGHTREC))


_REC = FlightRecorder(_capacity_from_env())


def recorder() -> FlightRecorder:
    """The process-global recorder.  Multi-node test processes share it
    (like the metrics hub); entries carry height/round so interleaved
    nodes remain distinguishable, and the multi-process e2e harness
    gives each node its own."""
    return _REC
