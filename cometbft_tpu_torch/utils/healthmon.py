"""Health sentinel: a hang-proof probe of the card, a heartbeat
registry, and automatic stall forensics (the port of
cometbft_tpu/utils/healthmon.py:66-732).

* **Hang-proof card probe** (:func:`probe_devices`): a throwaway
  subprocess (its own session, killpg on a hang, polled, never
  communicate()d) that imports torch, starts CUDA on the service's card,
  makes one small allocation, synchronizes and prints the card's name,
  under a hard deadline.  It never builds or loads a kernel library, so
  a probe can never start nvcc; where there is no card it reports not
  ok.  The sentinel also runs whatever probe it is given on a worker
  thread of its own, judged from outside by a deadline.
* **Tri-state health**: ``ok -> degraded -> wedged`` on consecutive probe
  failures (``COMETBFT_TPU_HEALTH_WEDGE_AFTER``) and stale heartbeats; a
  good probe snaps back to ``ok``.
* **Heartbeats**: the verify service's loops call :func:`beat` each
  iteration and :func:`retire` on a clean exit; with the sentinel off
  (the default) a beat is one module-bool check.
* **Stall forensics**: one rate-limited artifact an incident
  (utils/debugdump.stall_report: every thread's stack, the verify
  services' ``stats()`` with their in-flight ages, the flight recorder,
  the newest trace events), plus a flight-recorder event and the hub's
  ``health_*`` series on every transition.

The JAX module's names, states, knobs, defaults, loop deadlines and
metric observations are kept; the RPC routes that serve
:func:`snapshot` belong to the node, which the port does not have yet,
so :func:`maybe_start` is called where the port's clients start: the
first global verify service of a card.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

from .. import envknobs

STATE_OK = "ok"
STATE_DEGRADED = "degraded"
STATE_WEDGED = "wedged"
_STATE_CODE = {STATE_OK: 0, STATE_DEGRADED: 1, STATE_WEDGED: 2}

# Per-loop heartbeat deadlines (seconds).  A loop is stale when its last
# beat is older than its deadline; None = informational only (the loop
# legitimately blocks indefinitely — socket accept, event-driven work —
# so age is reported in /tpu_health but never audited).  Deadlines leave
# generous headroom over each loop's worst legitimate iteration:
# cs-receive processes one input under the consensus lock (a commit
# verification), verifysvc-collect blocks on a device result, and
# verifysvc-host may run a cold-bucket XLA compile.
DEFAULT_LOOPS: dict[str, float | None] = {
    "cs-receive": 15.0,
    "cs-watchdog": 35.0,
    "verifysvc-sched": 10.0,
    "verifysvc-collect": 60.0,
    "verifysvc-host": 300.0,
    # informational: the failover watchdog legitimately blocks for a
    # whole probation probe (subprocess, its own hard deadline)
    "verifysvc-failover": None,
    "blocksync-events": 15.0,
    "blocksync-pool": 60.0,
    "blockpool": 15.0,
    "metrics-pump": 15.0,
    "metrics-sample": 30.0,
    "mempool-recheck": None,
    "switch-accept": None,
}


# ----------------------------------------------------------------- probe


@dataclass
class ProbeResult:
    """Outcome of one accelerator probe attempt."""

    ok: bool
    detail: str
    latency_s: float
    timed_out: bool = False

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "detail": self.detail,
            "latency_s": round(self.latency_s, 3),
            "timed_out": self.timed_out,
        }


def probe_devices(timeout_s: float, device_index: int | None = None) -> ProbeResult:
    """Probe the card in a throwaway subprocess under a hard deadline.

    The child imports torch, starts CUDA on card ``device_index`` (None:
    the current one), allocates a small tensor, synchronizes and prints
    the card's name; it exits 3 when there is no card, so a machine
    without one probes not ok.  A wedged driver can block CUDA's start or
    a synchronize forever without raising, which cannot be killed from
    inside this process.  Popen + a poll deadline rather than
    ``subprocess.run(timeout=...)``: run() reaps a killed child with an
    unbounded communicate(), and a child stuck in uninterruptible device
    I/O would hang the reap.  The child runs in its own session so the
    kill (SIGKILL to the whole group) takes its helpers too; nothing
    here blocks on the child's pipes after a kill.  The injected
    ``wedge_device`` fault (utils/fail) is honoured before anything
    runs: the probe reports the hang at once.
    """
    import signal

    from . import fail

    if fail.armed("wedge_device") is not None:
        # injected wedge (utils/fail): report the hang a wedged card
        # would produce, at once and deterministically, so the sentinel
        # and the failover probation loop see the same wedged world
        return ProbeResult(
            False,
            "injected fault: wedge_device (probe reported as hung)",
            float(timeout_s),
            timed_out=True,
        )

    code = (
        "import sys, torch\n"
        "if not torch.cuda.is_available():\n"
        "    print('no CUDA device is available'); sys.exit(3)\n"
        f"dev = torch.device('cuda', {device_index!r}) if {device_index!r} is not None "
        "else torch.device('cuda', torch.cuda.current_device())\n"
        "x = torch.ones(1024, device=dev)\n"
        "torch.cuda.synchronize(dev)\n"
        "assert float(x.sum().item()) == 1024.0\n"
        "print(torch.cuda.get_device_name(dev))\n"
    )
    t0 = time.monotonic()
    with open(os.devnull, "wb") as devnull:
        proc = subprocess.Popen(
            [sys.executable, "-c", code],
            stdout=subprocess.PIPE,
            stderr=devnull,
            text=True,
            start_new_session=True,
        )
        deadline = t0 + timeout_s
        step = min(0.5, max(timeout_s / 10.0, 0.01))
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(step)
        if proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (OSError, ProcessLookupError):
                proc.kill()
            return ProbeResult(
                False,
                f"CUDA start and synchronize hung >{timeout_s:g}s (wedged card)",
                time.monotonic() - t0,
                timed_out=True,
            )
        out = proc.stdout.read() if proc.stdout else ""
        latency = time.monotonic() - t0
        if proc.returncode != 0:
            last = out.strip().splitlines()[-1] if out.strip() else ""
            return ProbeResult(
                False, f"probe exited {proc.returncode}" + (f": {last}" if last else ""), latency
            )
    detail = out.strip().splitlines()[-1] if out.strip() else "?"
    return ProbeResult(True, detail, latency)


# -------------------------------------------------------------- monitor


class HealthMonitor:
    """The sentinel: periodic hang-proof probes + heartbeat audits.

    Construction reads the ``COMETBFT_TPU_HEALTH_*`` knobs once;
    explicit constructor arguments override them (tests).  ``probe_fn``
    takes a timeout in seconds and returns a :class:`ProbeResult`; the
    default is :func:`probe_devices`.  Whatever it is, it runs on a
    dedicated worker thread and the sentinel judges it from outside with
    ``deadline + grace`` — a probe that blocks forever is recorded as a
    hang (one failure per period) without the sentinel ever blocking.
    """

    def __init__(
        self,
        probe_fn=None,
        probe_period_s: float | None = None,
        probe_timeout_s: float | None = None,
        probe_grace_s: float = 2.0,
        wedge_after: int | None = None,
        artifact_min_interval_s: float | None = None,
        artifact_dir: str | None = None,
        loops: dict[str, float | None] | None = None,
    ):
        self._probe_fn = probe_fn if probe_fn is not None else probe_devices
        self.probe_period_s = (
            probe_period_s if probe_period_s is not None
            else max(1, envknobs.get_int(envknobs.HEALTH_PERIOD_MS)) / 1e3
        )
        self.probe_timeout_s = (
            probe_timeout_s if probe_timeout_s is not None
            else max(1, envknobs.get_int(envknobs.HEALTH_PROBE_TIMEOUT_MS)) / 1e3
        )
        self.probe_grace_s = max(0.0, probe_grace_s)
        self.wedge_after = max(
            1, wedge_after if wedge_after is not None
            else envknobs.get_int(envknobs.HEALTH_WEDGE_AFTER)
        )
        self.artifact_min_interval_s = (
            artifact_min_interval_s if artifact_min_interval_s is not None
            else max(
                0, envknobs.get_int(envknobs.HEALTH_ARTIFACT_MIN_INTERVAL_MS)
            ) / 1e3
        )
        self.artifact_dir = (
            artifact_dir if artifact_dir is not None
            else (envknobs.get_str(envknobs.HEALTH_DIR) or None)
        )
        self.logger = logging.getLogger("cometbft_tpu_torch.healthmon")

        self._mtx = threading.Lock()
        # heartbeat registry: name -> last beat (monotonic); deadlines
        # separate so beat() stays a single dict store
        self._beats: dict[str, float] = {}
        self._deadlines: dict[str, float | None] = dict(
            DEFAULT_LOOPS if loops is None else loops
        )
        self._stale: set[str] = set()

        # probe bookkeeping (all guarded by _mtx)
        self._state = STATE_OK
        self._consec_failures = 0
        self._last_result: ProbeResult | None = None
        self._last_result_at: float | None = None
        self._probe_attempts = 0
        self._transitions = 0
        self._last_artifact: str | None = None
        self._last_artifact_at: float | None = None
        self._incident_active = False

        # in-flight probe attempt: (generation, started_at monotonic);
        # None when no attempt outstanding.  judged=True once the
        # sentinel counted it as a hang — a late completion of a judged
        # attempt is discarded.
        self._attempt: dict | None = None
        self._attempt_gen = 0

        self._stop_ev = threading.Event()
        self._thread: threading.Thread | None = None
        self._next_probe = 0.0  # fire immediately on start

    # ---------------------------------------------------------- lifecycle

    @property
    def state(self) -> str:
        """Current tri-state health (atomic str read, no lock: the
        verify service's failover watchdog polls this every tick)."""
        return self._state

    @property
    def last_probe_at(self) -> float | None:
        """Monotonic time of the last ingested probe result (atomic
        read).  The failover watchdog compares this against its own
        last restore so a sentinel verdict that predates the restore —
        the sentinel probes far less often than probation — can't
        immediately re-trip a just-restored service."""
        return self._last_result_at

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_ev.clear()
        self._thread = threading.Thread(
            target=self._sentinel_loop, name="healthmon-sentinel", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop_ev.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # --------------------------------------------------------- heartbeats

    def register_loop(self, name: str, deadline_s: float | None) -> None:
        with self._mtx:
            self._deadlines[name] = deadline_s

    def beat(self, name: str) -> None:
        # one dict store, no lock: under the GIL a float store is atomic
        # and the sentinel reading a torn-by-a-tick value is harmless —
        # this is the hot path every loop iteration pays
        self._beats[name] = time.monotonic()

    def retire(self, name: str) -> None:
        """A loop is exiting cleanly: stop auditing it.  A blocksync
        pool that handed off to consensus must not read as stalled.
        The whole removal holds _mtx so it serializes with the
        sentinel's audit — an unlocked remove could lose to a
        concurrent audit's set() and resurrect the gauge series,
        frozen forever."""
        from .metrics import hub as _mhub

        with self._mtx:
            self._beats.pop(name, None)
            self._stale.discard(name)
            # drop the exported series too: a frozen age for a dead loop
            # reads on a dashboard as a live loop that stopped aging
            _mhub().health_beat_age.remove(loop=name)

    # ------------------------------------------------------------- probing

    def _kick_probe_locked(self, now: float) -> None:
        """Start a probe attempt on a fresh worker thread — unless the
        previous worker is still stuck inside the probe, in which case
        the stuck attempt keeps being judged instead (at most ONE probe
        thread exists however wedged the tunnel is)."""
        if self._attempt is not None:
            return
        self._attempt_gen += 1
        gen = self._attempt_gen
        self._attempt = {"gen": gen, "started": now, "judged": False}

        def run():
            try:
                res = self._probe_fn(self.probe_timeout_s)
            except BaseException as e:  # noqa: BLE001 — a probe bug is a failed probe
                res = ProbeResult(
                    False, f"probe raised {type(e).__name__}: {e}", 0.0
                )
            with self._mtx:
                att = self._attempt
                if att is None or att["gen"] != gen:
                    return  # superseded
                if att["judged"]:
                    # already counted as a hang; a (late) answer just
                    # clears the slot so the next period can probe again
                    self._attempt = None
                    return
                self._attempt = None
                self._ingest_probe_locked(res)

        threading.Thread(target=run, name="healthmon-probe", daemon=True).start()

    def _ingest_probe_locked(self, res: ProbeResult) -> None:
        from .metrics import hub as _mhub

        self._probe_attempts += 1
        self._last_result = res
        self._last_result_at = time.monotonic()
        m = _mhub()
        # synthetic hang results carry the cumulative blocked duration in
        # latency_s (useful in /tpu_health); the histogram promises "a
        # hang is clamped at the probe deadline", so clamp here
        m.health_probe_seconds.observe(min(res.latency_s, self.probe_timeout_s))
        m.health_probe_total.inc(
            result="ok" if res.ok else ("hang" if res.timed_out else "fail")
        )
        if res.ok:
            self._consec_failures = 0
        else:
            self._consec_failures += 1
        m.health_probe_consec_failures.set(self._consec_failures)

    def _judge_attempt_locked(self, now: float) -> None:
        """A probe attempt past deadline+grace is a hang — count it
        without waiting for the worker (which may be stuck forever)."""
        att = self._attempt
        if att is None or att["judged"]:
            return
        if now - att["started"] > self.probe_timeout_s + self.probe_grace_s:
            att["judged"] = True
            self._ingest_probe_locked(
                ProbeResult(
                    False,
                    "probe thread still blocked past "
                    f"{self.probe_timeout_s:g}s deadline",
                    now - att["started"],
                    timed_out=True,
                )
            )

    # -------------------------------------------------------------- audit

    def _audit_beats_locked(self, now: float) -> None:
        """Recompute the stale set and export per-loop beat ages."""
        from .metrics import hub as _mhub

        m = _mhub()
        for name, last in list(self._beats.items()):
            age = now - last
            m.health_beat_age.set(age, loop=name)
            deadline = self._deadlines.get(name)
            if deadline is None:
                continue
            if age > deadline:
                self._stale.add(name)
            else:
                self._stale.discard(name)

    def _device_state_locked(self) -> str:
        if self._consec_failures >= self.wedge_after:
            return STATE_WEDGED
        if self._consec_failures > 0:
            return STATE_DEGRADED
        return STATE_OK

    def tick(self, now: float | None = None) -> None:
        """One sentinel cycle: kick/judge the probe, audit beats, run the
        state machine, capture forensics.  The sentinel thread calls this
        periodically; tests call it directly for determinism.  Never
        blocks: every interaction with possibly-wedged machinery is
        judged from outside with deadlines."""
        now = time.monotonic() if now is None else now
        capture_reason: str | None = None
        with self._mtx:
            if now >= self._next_probe:
                self._next_probe = now + self.probe_period_s
                att = self._attempt
                if att is not None and att["judged"]:
                    # the worker is STILL stuck inside an already-judged
                    # probe: no new probe can start (one worker max), but
                    # every elapsed period is another failure — a tunnel
                    # wedged hard enough to trap the thread forever must
                    # still walk degraded -> wedged
                    self._ingest_probe_locked(
                        ProbeResult(
                            False,
                            "probe thread still blocked "
                            f"({now - att['started']:.1f}s since attempt "
                            "start)",
                            now - att["started"],
                            timed_out=True,
                        )
                    )
                else:
                    self._kick_probe_locked(now)
            self._judge_attempt_locked(now)
            self._audit_beats_locked(now)
            new_state = self._device_state_locked()
            if new_state == STATE_OK and self._stale:
                new_state = STATE_DEGRADED
            transitioned = new_state != self._state
            prev = self._state
            if transitioned:
                self._state = new_state
                self._transitions += 1
            # one artifact per incident: the first transition out of ok
            # (or a stale loop appearing while otherwise ok) opens an
            # incident, recovery to ok closes it
            if new_state == STATE_OK:
                self._incident_active = False
            elif not self._incident_active:
                self._incident_active = True
                rate_limited = (
                    self._last_artifact_at is not None
                    and now - self._last_artifact_at
                    < self.artifact_min_interval_s
                )
                if not rate_limited:
                    self._last_artifact_at = now
                    capture_reason = self._incident_reason_locked()
            if transitioned:
                self._record_transition_locked(prev, new_state)
        if capture_reason is not None:
            path = self._capture_forensics(capture_reason)
            with self._mtx:
                self._last_artifact = path

    def _incident_reason_locked(self) -> str:
        parts = []
        if self._consec_failures:
            detail = self._last_result.detail if self._last_result else "?"
            parts.append(
                f"{self._consec_failures} consecutive probe failure(s): "
                f"{detail}"
            )
        if self._stale:  # audit ran under this same lock hold
            parts.append(
                f"stale heartbeat(s): {', '.join(sorted(self._stale))}"
            )
        return "; ".join(parts) or "unknown"

    def _record_transition_locked(self, prev: str, new: str) -> None:
        from .flightrec import recorder as _flightrec
        from .metrics import hub as _mhub

        m = _mhub()
        m.health_state.set(_STATE_CODE[new])
        m.health_transitions.inc(state=new)
        detail = self._last_result.detail if self._last_result else ""
        _flightrec().record(
            "health",
            state=new,
            prev=prev,
            consec_failures=self._consec_failures,
            stale_loops=sorted(self._stale),
            probe=detail,
        )
        log = self.logger.warning if new != STATE_OK else self.logger.info
        log(
            f"health state {prev} -> {new} "
            f"(probe failures={self._consec_failures}, "
            f"stale={sorted(self._stale) or '[]'} {detail})"
        )

    # ----------------------------------------------------------- forensics

    def _capture_forensics(self, reason: str) -> str | None:
        """One diagnosis artifact: snapshot + verifysvc stats (bounded
        lock wait) + flight recorder + trace ring + all-thread stacks.
        Runs OUTSIDE self._mtx (beat() never contends) and must never
        raise — it runs while the node is already in trouble."""
        import json as _json

        from . import debugdump, tracing
        from .metrics import hub as _mhub

        try:
            sections: list[tuple[str, str]] = [
                (
                    "health snapshot",
                    _json.dumps(self.snapshot(), indent=1, default=str),
                )
            ]
            try:
                # peek the module global, never global_service(): the
                # accessor CONSTRUCTS a service on demand, and a
                # diagnostic path must not install fresh global state
                # (nor report a fabricated empty scheduler as real)
                from ..verifysvc import service as _vsvc

                svcs = dict(_vsvc._GLOBAL)
                stats = (
                    {dev: svc.stats(lock_timeout=0.5) for dev, svc in svcs.items()}
                    if svcs
                    else "not running (no verify service in this process)"
                )
                sections.append(
                    ("verify service", _json.dumps(stats, indent=1, default=str))
                )
            except Exception as e:  # noqa: BLE001 — partial forensics beat none
                sections.append(("verify service", f"unavailable: {e!r}"))
            if tracing.enabled():
                events = tracing.chrome_trace_events()[-256:]
                sections.append(
                    ("trace ring (newest 256)", _json.dumps(events, default=str))
                )
            path = debugdump.stall_report(
                reason, sections, directory=self.artifact_dir
            )
            _mhub().health_forensics.inc()
            self.logger.warning(f"stall forensics written to {path}")
            return path
        except Exception as e:  # noqa: BLE001 — forensics must never hurt the node
            self.logger.warning(f"stall forensics capture failed: {e!r}")
            return None

    # ------------------------------------------------------------ sentinel

    def _sentinel_loop(self) -> None:
        # tick fast enough to honor small test periods, slow enough to
        # be invisible in production (<=4 wakeups/s worst case)
        step = max(0.05, min(1.0, self.probe_period_s / 4.0))
        while not self._stop_ev.wait(step):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the sentinel outlives one bad cycle
                self.logger.warning(f"sentinel tick failed: {e!r}")

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> dict:
        """The /tpu_health payload (JSON-serializable)."""
        now = time.monotonic()
        beats = dict(self._beats)  # racy-read safe: atomic dict copy
        with self._mtx:
            last = self._last_result
            attempt = self._attempt
            out = {
                "enabled": True,
                "state": self._state,
                "ready": self._state != STATE_WEDGED,
                "consecutive_probe_failures": self._consec_failures,
                "wedge_after": self.wedge_after,
                "probe_period_s": self.probe_period_s,
                "probe_timeout_s": self.probe_timeout_s,
                "probe_attempts": self._probe_attempts,
                "last_probe": (
                    {
                        **last.to_dict(),
                        "age_s": (
                            round(now - self._last_result_at, 3)
                            if self._last_result_at is not None
                            else None
                        ),
                    }
                    if last is not None
                    else None
                ),
                "probe_in_flight_s": (
                    round(now - attempt["started"], 3) if attempt else None
                ),
                "stale_loops": sorted(self._stale),
                "transitions": self._transitions,
                "last_artifact": self._last_artifact,
            }
            deadlines = dict(self._deadlines)
        out["loops"] = {
            name: {
                "age_s": round(now - t, 3),
                "deadline_s": deadlines.get(name),
                "stale": name in out["stale_loops"],
            }
            for name, t in sorted(beats.items())
        }
        return out

    def wedge_report(self) -> dict:
        """Compact structured view for embedding in artifacts/bench
        lines: state + last probe + stale loops."""
        with self._mtx:
            return {
                "state": self._state,
                "consecutive_probe_failures": self._consec_failures,
                "last_probe": (
                    self._last_result.to_dict() if self._last_result else None
                ),
                "stale_loops": sorted(self._stale),
                "last_artifact": self._last_artifact,
            }


# ------------------------------------------------------- module plumbing

_ENABLED = False
_MON: HealthMonitor | None = None
_MON_MTX = threading.Lock()


def beat(name: str) -> None:
    """Heartbeat from a long-lived loop.  Off by default: one module-bool
    check, no allocation, no lock — safe on every hot loop."""
    if not _ENABLED:
        return
    mon = _MON
    if mon is not None:
        mon.beat(name)


def retire(name: str) -> None:
    """A loop is exiting cleanly; stop auditing its heartbeat."""
    if not _ENABLED:
        return
    mon = _MON
    if mon is not None:
        mon.retire(name)


def monitor() -> HealthMonitor | None:
    return _MON


def install(mon: HealthMonitor) -> HealthMonitor:
    """Make ``mon`` the process monitor and enable beats (tests and
    :func:`maybe_start`).  Does not start the sentinel thread."""
    global _MON, _ENABLED
    with _MON_MTX:
        _MON = mon
        _ENABLED = True
    return mon


def uninstall() -> None:
    """Stop and drop the process monitor; beats go back to no-ops."""
    global _MON, _ENABLED
    with _MON_MTX:
        mon, _MON = _MON, None
        _ENABLED = False
    if mon is not None:
        mon.stop()


def maybe_start() -> HealthMonitor | None:
    """Knob-gated production entry (the JAX node's start; in the port the
    first global verify service of a card, verifysvc/service.py
    ``global_service``): installs and starts the sentinel when
    ``COMETBFT_TPU_HEALTH=1``; returns None (and keeps the zero-overhead
    no-op path) otherwise."""
    if not envknobs.get_bool(envknobs.HEALTH):
        return None
    with _MON_MTX:
        if _MON is not None:
            return _MON
    mon = install(HealthMonitor())
    mon.start()
    return mon


def snapshot() -> dict:
    """The /tpu_health payload; a disabled monitor still answers (the
    RPC responding at all is the liveness half of the contract)."""
    mon = _MON
    if mon is None:
        return {
            "enabled": False,
            "state": "unknown",
            "ready": True,
            "loops": {},
            "stale_loops": [],
            "last_probe": None,
            "last_artifact": None,
        }
    return mon.snapshot()
