"""The port's health sentinel (cometbft_tpu_torch/utils/healthmon.py)
against the JAX package's (cometbft_tpu/utils/healthmon.py): the
node-free cases of tests/test_healthmon.py run on both packages (each
with its own flight recorder and metrics hub), a scripted sentinel whose
snapshots, events and metric moves must be the same in both, the port's
real card probe (no card here: not ok; the injected wedge honoured
before any subprocess), and the verify service's in-flight ages and
bounded stats lock.

Probes are stubbed (an Event-blocked stub stands in for a wedged card),
periods are tens of milliseconds and the sentinel is driven through
tick() except in the one test of the real thread."""

import os
import threading
import time

import pytest
import torch

from cometbft_tpu.utils import fail as jfail
from cometbft_tpu.utils import healthmon as jhm
from cometbft_tpu.utils.flightrec import recorder as jrec
from cometbft_tpu.utils.metrics import hub as jhub

from cometbft_tpu_torch.utils import fail as pfail
from cometbft_tpu_torch.utils import healthmon as phm
from cometbft_tpu_torch.utils.flightrec import recorder as prec
from cometbft_tpu_torch.utils.metrics import hub as phub
from cometbft_tpu_torch.verifysvc import service as PS

WAIT = 10.0
# each package's sentinel module, flight recorder and metrics hub
PKGS = {"port": (phm, prec, phub), "jax": (jhm, jrec, jhub)}


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    return request.param


@pytest.fixture
def mon(pkg):
    """Construct-and-install monitors of ``pkg``; uninstalled afterwards so
    beats go back to the no-op for every other test."""
    hm = PKGS[pkg][0]
    made = []

    def make(**kw):
        kw.setdefault("probe_period_s", 0.05)
        kw.setdefault("probe_timeout_s", 0.05)
        kw.setdefault("probe_grace_s", 0.05)
        kw.setdefault("artifact_min_interval_s", 0.0)
        m = hm.HealthMonitor(**kw)
        made.append(m)
        hm.install(m)
        return m

    yield make
    hm.uninstall()
    for m in made:
        m.stop()


def _ok(pkg):
    hm = PKGS[pkg][0]
    return lambda _t: hm.ProbeResult(True, "cpu", 0.001)


def _fail(pkg):
    hm = PKGS[pkg][0]
    return lambda _t: hm.ProbeResult(False, "probe exited 1", 0.002)


class _BlockingProbe:
    """A probe wedged like a hung card: blocks until released."""

    def __init__(self, hm):
        self.hm = hm
        self.release = threading.Event()
        self.calls = 0

    def __call__(self, timeout_s):
        self.calls += 1
        self.release.wait(WAIT)
        return self.hm.ProbeResult(True, "late", 0.0)


def _until(m, cond, tick=True):
    deadline = time.monotonic() + WAIT
    while not cond(m.snapshot()):
        assert time.monotonic() < deadline
        time.sleep(0.005)
        if tick:
            m.tick()


# ------------------------------------------------------- state machine


def test_ok_probe_keeps_state_ok(pkg, mon, tmp_path):
    m = mon(probe_fn=_ok(pkg), artifact_dir=str(tmp_path))
    m.tick()
    _until(m, lambda s: s["probe_attempts"] > 0)
    snap = m.snapshot()
    assert snap["state"] == "ok" and snap["ready"] is True
    assert snap["last_probe"]["ok"] is True and snap["consecutive_probe_failures"] == 0
    assert list(tmp_path.iterdir()) == []


def test_failing_probe_walks_degraded_then_wedged(pkg, mon, tmp_path):
    m = mon(probe_fn=_fail(pkg), wedge_after=2, artifact_dir=str(tmp_path))
    now = time.monotonic()
    m.tick(now)
    _until(m, lambda s: s["consecutive_probe_failures"] >= 1, tick=False)
    m.tick(now + 0.01)
    assert m.snapshot()["state"] == "degraded"
    m.tick(now + 0.06)
    _until(m, lambda s: s["consecutive_probe_failures"] >= 2, tick=False)
    m.tick(now + 0.07)
    snap = m.snapshot()
    assert snap["state"] == "wedged" and snap["ready"] is False


def test_blocking_probe_never_blocks_the_sentinel_and_wedges(pkg, mon, tmp_path):
    probe = _BlockingProbe(PKGS[pkg][0])
    m = mon(probe_fn=probe, wedge_after=2, artifact_dir=str(tmp_path))
    t0 = time.monotonic()
    m.tick(t0)
    assert time.monotonic() - t0 < 0.5
    m.tick(t0 + 0.11)
    snap = m.snapshot()
    assert snap["consecutive_probe_failures"] == 1 and snap["state"] == "degraded"
    assert snap["last_probe"]["timed_out"] is True
    m.tick(t0 + 0.17)
    snap = m.snapshot()
    assert snap["consecutive_probe_failures"] == 2 and snap["state"] == "wedged"
    assert probe.calls == 1
    probe.release.set()


def test_probe_recovery_snaps_back_to_ok(pkg, mon, tmp_path):
    hm = PKGS[pkg][0]
    results = [hm.ProbeResult(False, "probe exited 1", 0.0)]
    m = mon(probe_fn=lambda _t: results[-1], wedge_after=1, artifact_dir=str(tmp_path))
    _until(m, lambda s: s["state"] == "wedged")
    results.append(hm.ProbeResult(True, "card", 0.01))
    _until(m, lambda s: s["state"] == "ok")
    snap = m.snapshot()
    assert snap["consecutive_probe_failures"] == 0 and snap["ready"] is True


# ----------------------------------------------------------- heartbeats


def test_stale_heartbeat_blames_the_exact_loop(pkg, mon, tmp_path):
    hm = PKGS[pkg][0]
    m = mon(probe_fn=_ok(pkg), artifact_dir=str(tmp_path), loops={"my-loop": 0.05, "other-loop": 30.0})
    hm.beat("my-loop")
    hm.beat("other-loop")
    m.tick()
    assert m.snapshot()["stale_loops"] == []
    time.sleep(0.08)
    m.tick()
    snap = m.snapshot()
    assert snap["state"] == "degraded" and snap["stale_loops"] == ["my-loop"]
    assert snap["loops"]["my-loop"]["stale"] is True and snap["loops"]["other-loop"]["stale"] is False
    (art,) = list(tmp_path.iterdir())
    reason = next(ln for ln in art.read_text().splitlines() if ln.startswith("reason:"))
    assert "stale heartbeat(s): my-loop" in reason and "other-loop" not in reason
    hm.beat("my-loop")
    m.tick()
    assert m.snapshot()["state"] == "ok"


def test_a_retired_loop_is_not_audited(pkg, mon, tmp_path):
    hm = PKGS[pkg][0]
    m = mon(probe_fn=_ok(pkg), artifact_dir=str(tmp_path), loops={"done-loop": 0.02})
    hm.beat("done-loop")
    hm.retire("done-loop")
    time.sleep(0.05)
    m.tick()
    snap = m.snapshot()
    assert snap["state"] == "ok" and "done-loop" not in snap["loops"]


def test_an_informational_loop_is_reported_but_never_stale(pkg, mon, tmp_path):
    hm = PKGS[pkg][0]
    m = mon(probe_fn=_ok(pkg), artifact_dir=str(tmp_path), loops={"verifysvc-failover": None})
    hm.beat("verifysvc-failover")
    time.sleep(0.05)
    m.tick()
    snap = m.snapshot()
    assert snap["state"] == "ok" and snap["loops"]["verifysvc-failover"]["deadline_s"] is None


def test_the_service_loops_keep_the_jax_deadlines():
    assert phm.DEFAULT_LOOPS == jhm.DEFAULT_LOOPS
    for name in ("verifysvc-sched", "verifysvc-collect", "verifysvc-host", "verifysvc-failover"):
        assert name in phm.DEFAULT_LOOPS


# ------------------------------------------------------------ forensics


def test_exactly_one_artifact_per_incident(pkg, mon, tmp_path):
    hm = PKGS[pkg][0]
    m = mon(probe_fn=_ok(pkg), artifact_dir=str(tmp_path), loops={"loopy": 0.03})
    hm.beat("loopy")
    time.sleep(0.05)
    for _ in range(5):
        m.tick()
        time.sleep(0.005)
    assert len(list(tmp_path.iterdir())) == 1
    hm.beat("loopy")
    m.tick()
    assert m.snapshot()["state"] == "ok"
    time.sleep(0.05)
    m.tick()
    assert m.snapshot()["state"] == "degraded" and len(list(tmp_path.iterdir())) == 2


def test_the_artifact_interval_rate_limits_flapping(pkg, mon, tmp_path):
    hm = PKGS[pkg][0]
    m = mon(probe_fn=_ok(pkg), artifact_dir=str(tmp_path), artifact_min_interval_s=3600.0, loops={"flappy": 0.03})
    hm.beat("flappy")
    time.sleep(0.05)
    m.tick()
    assert len(list(tmp_path.iterdir())) == 1
    hm.beat("flappy")
    m.tick()
    time.sleep(0.05)
    m.tick()
    assert m.snapshot()["state"] == "degraded" and len(list(tmp_path.iterdir())) == 1


def test_artifact_contents_and_snapshot_pointer(pkg, mon, tmp_path):
    m = mon(probe_fn=_fail(pkg), wedge_after=1, artifact_dir=str(tmp_path))
    m.tick(time.monotonic())
    _until(m, lambda s: s["last_artifact"] is not None)
    path = m.snapshot()["last_artifact"]
    assert os.path.dirname(path) == str(tmp_path)
    text = open(path).read()
    for section in ("=== stall forensics ===", "consecutive probe failure(s)", "=== health snapshot ===",
                    "=== verify service ===", "=== consensus flight recorder ===", "=== threads ==="):
        assert section in text, section


def test_the_port_artifact_carries_each_global_services_stats(tmp_path):
    """The port keeps one global service a device: the sentinel's artifact
    holds the stats of each, by device."""
    PS.reset_global_service()
    PS.global_service("cpu")
    m = phm.install(phm.HealthMonitor(probe_fn=_fail("port"), wedge_after=1, probe_period_s=0.05,
                                      probe_timeout_s=0.05, artifact_min_interval_s=0.0,
                                      artifact_dir=str(tmp_path)))
    try:
        m.tick(time.monotonic())
        _until(m, lambda s: s["last_artifact"] is not None)
        text = open(m.snapshot()["last_artifact"]).read()
        assert '"cpu": {' in text and '"failover": {' in text
    finally:
        phm.uninstall()
        PS.reset_global_service()


# --------------------------------------- transitions: flightrec + metrics


def test_a_transition_records_one_event_and_moves_the_gauges(pkg, mon, tmp_path):
    hm, rec, hub = PKGS[pkg]
    before = [e for e in rec().dump()["entries"] if e["kind"] == "health"]
    m = mon(probe_fn=_fail(pkg), wedge_after=1, artifact_dir=str(tmp_path))
    m.tick(time.monotonic())
    _until(m, lambda s: s["state"] == "wedged")
    events = [e for e in rec().dump()["entries"] if e["kind"] == "health"]
    assert len(events) == len(before) + 1
    assert events[-1]["detail"]["state"] == "wedged" and events[-1]["detail"]["prev"] == "ok"
    assert hub().health_state.value() == 2.0 and hub().health_probe_consec_failures.value() >= 1.0
    m._probe_fn = _ok(pkg)
    _until(m, lambda s: s["state"] == "ok")
    assert hub().health_state.value() == 0.0


def _scripted(pkg, tmp_path):
    """A sentinel driven by tick() at fixed clocks through failing, hung
    and good probes and a stale loop -> its snapshots without clocks, its
    new health events and its metric moves."""
    hm, rec, hub = PKGS[pkg]
    seq0 = (rec().dump()["entries"] or [{"seq": 0}])[-1]["seq"]
    series = [("health_probe_total", {"result": r}) for r in ("ok", "fail", "hang")] + [
        ("health_transitions", {"state": s}) for s in ("ok", "degraded", "wedged")] + [
        ("health_forensics", {})]
    before = [getattr(hub(), n).value(**lb) for n, lb in series]
    results = iter([hm.ProbeResult(False, "probe exited 3: no CUDA device is available", 0.5),
                    hm.ProbeResult(False, "exited 1", 0.5), hm.ProbeResult(True, "NVIDIA H100 80GB HBM3", 0.4),
                    hm.ProbeResult(True, "NVIDIA H100 80GB HBM3", 0.4)])
    done = threading.Event()

    def probe(_t):
        try:
            return next(results)
        finally:
            done.set()

    m = hm.HealthMonitor(probe_fn=probe, probe_period_s=1.0, probe_timeout_s=1.0, probe_grace_s=0.5,
                         wedge_after=2, artifact_min_interval_s=0.0, artifact_dir=str(tmp_path),
                         loops={"verifysvc-sched": 5.0})
    hm.install(m)
    snaps = []
    try:
        t0 = time.monotonic()
        for k in range(4):
            done.clear()
            m.tick(t0 + k * 1.1)
            assert done.wait(WAIT)
            _until(m, lambda s, k=k: s["probe_attempts"] == k + 1, tick=False)
            m.tick(t0 + k * 1.1 + 0.01)
            s = m.snapshot()
            snaps.append({key: s[key] for key in ("state", "ready", "consecutive_probe_failures", "probe_attempts",
                                                  "stale_loops", "transitions", "wedge_after")}
                         | {"probe": {k2: s["last_probe"][k2] for k2 in ("ok", "detail", "timed_out")},
                            "artifact": s["last_artifact"] is not None})
    finally:
        hm.uninstall()
    events = [{k: v for k, v in e["detail"].items()} for e in rec().dump()["entries"]
              if e["seq"] > seq0 and e["kind"] == "health"]
    return snaps, events, [getattr(hub(), n).value(**lb) - b for (n, lb), b in zip(series, before)]


def test_a_scripted_sentinel_is_the_jax_sentinel(tmp_path):
    got = {p: _scripted(p, tmp_path / p) for p in PKGS if not (tmp_path / p).mkdir()}
    assert got["port"] == got["jax"]
    snaps, events, deltas = got["port"]
    assert [s["state"] for s in snaps] == ["degraded", "wedged", "ok", "ok"]
    assert [e["state"] for e in events] == ["degraded", "wedged", "ok"]
    assert deltas == [2.0, 2.0, 0.0, 1.0, 1.0, 1.0, 1.0]


# ------------------------------------------------- end-to-end (real thread)


def test_the_sentinel_thread_wedges_end_to_end(pkg, mon, tmp_path):
    hm, rec, hub = PKGS[pkg]
    probe = _BlockingProbe(hm)
    m = mon(probe_fn=probe, probe_period_s=0.04, probe_timeout_s=0.04, probe_grace_s=0.02, wedge_after=2,
            artifact_dir=str(tmp_path))
    m.start()
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < WAIT:
            b0 = time.monotonic()
            hm.beat("verifysvc-sched")
            assert time.monotonic() - b0 < 0.1
            if hm.snapshot()["state"] == "wedged":
                break
            time.sleep(0.01)
        snap = hm.snapshot()
        assert snap["state"] == "wedged" and snap["ready"] is False
        assert snap["consecutive_probe_failures"] >= 2 and snap["last_probe"]["timed_out"] is True
        assert "verifysvc-sched" in snap["loops"]
        arts = list(tmp_path.iterdir())
        assert len(arts) == 1 and snap["last_artifact"] == str(arts[0])
        assert any(e["kind"] == "health" and e["detail"]["state"] == "wedged" for e in rec().dump()["entries"])
        assert hub().health_state.value() == 2.0
    finally:
        probe.release.set()
        m.stop()


def test_a_disabled_monitor_is_a_no_op(pkg, monkeypatch):
    hm = PKGS[pkg][0]
    assert hm.monitor() is None
    hm.beat("anything")
    hm.retire("anything")
    snap = hm.snapshot()
    assert snap["enabled"] is False and snap["ready"] is True and snap["loops"] == {}
    monkeypatch.delenv("COMETBFT_TPU_HEALTH", raising=False)
    assert hm.maybe_start() is None and hm.monitor() is None


def test_maybe_start_installs_and_starts_when_the_knob_is_on(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_HEALTH", "1")
    monkeypatch.setenv("COMETBFT_TPU_HEALTH_PERIOD_MS", "3600000")
    try:
        m = phm.maybe_start()
        assert m is not None and phm.monitor() is m and phm.maybe_start() is m
        assert m.probe_period_s == 3600.0 and m.wedge_after == 2 and m.probe_timeout_s == 20.0
    finally:
        phm.uninstall()


@pytest.mark.parametrize("knob", ["1", "0"])
def test_the_first_global_service_of_a_card_starts_the_sentinel(monkeypatch, knob):
    """The port has no node, so the first global verify service of a card
    makes the JAX node's maybe_start() call: COMETBFT_TPU_HEALTH=1 starts
    the sentinel whose wedged verdict trips that service.  A CPU service
    starts none (its probe would judge a card it does not use).  No card
    here: the card's service is a stand-in on a pinned cuda:0."""

    class StandIn:
        def __init__(self, device):
            self.device = device

        def stop(self):
            pass

    monkeypatch.setenv("COMETBFT_TPU_HEALTH", knob)
    started = []
    monkeypatch.setattr(phm.HealthMonitor, "start", lambda self: started.append(self))
    monkeypatch.setattr(PS, "VerifyService", StandIn)
    monkeypatch.setattr(PS, "_pinned", lambda d: torch.device("cpu" if d == "cpu" else "cuda:0"))
    PS.reset_global_service()
    try:
        PS.global_service("cpu")
        assert phm.monitor() is None and not started
        card = PS.global_service("cuda")
        assert card.device == torch.device("cuda", 0) and PS.global_service("cuda") is card
        if knob == "1":
            assert started == [phm.monitor()] and started[0] is not None
        else:
            assert phm.monitor() is None and not started
    finally:
        PS.reset_global_service()
        phm.uninstall()


# ------------------------------------------------------------- the probe


def test_the_real_probe_reports_no_card_as_not_ok():
    """No card here: the child starts torch, finds no CUDA device and
    exits 3; the probe is not ok, and not a hang."""
    res = phm.probe_devices(120.0)
    assert res.ok is False and res.timed_out is False
    assert res.detail == "probe exited 3: no CUDA device is available"
    assert 0.0 < res.latency_s < 120.0


def test_the_probe_honours_the_injected_wedge_before_any_subprocess(monkeypatch):
    import subprocess

    monkeypatch.setattr(subprocess, "Popen", lambda *a, **k: pytest.fail("a subprocess was started"))
    pfail.arm("wedge_device")
    try:
        t0 = time.monotonic()
        res = phm.probe_devices(30.0)
        jfail.arm("wedge_device")
        jres = jhm.probe_devices(30.0)
    finally:
        pfail.clear_all()
        jfail.clear_all()
    assert time.monotonic() - t0 < 1.0
    assert (res.ok, res.detail, res.latency_s, res.timed_out) == (jres.ok, jres.detail, jres.latency_s,
                                                                 jres.timed_out)
    assert res.timed_out and "wedge_device" in res.detail


def test_a_probe_past_its_deadline_is_killed_as_a_hang(monkeypatch, tmp_path):
    """A child that never finishes is killed with its process group at the
    deadline: a hang, judged in about the deadline."""
    import sys

    hang = tmp_path / "hang.py"
    hang.write_text("import time\ntime.sleep(60)\n")
    real_popen = __import__("subprocess").Popen
    monkeypatch.setattr("subprocess.Popen",
                        lambda args, **kw: real_popen([sys.executable, str(hang)], **kw))
    t0 = time.monotonic()
    res = phm.probe_devices(0.5)
    assert res.ok is False and res.timed_out is True and "hung" in res.detail
    assert time.monotonic() - t0 < 5.0


# --------------------------------------------- verify service in-flight ages


def test_verifysvc_stats_report_in_flight_batch_ages():
    gate = threading.Event()

    class SlowBV:
        def __init__(self):
            self.items = []

        def add(self, pub, msg, sig):
            self.items.append((pub, msg, sig))

        def submit(self):
            return ("dev", None)

        def collect(self, ticket):
            gate.wait(WAIT)
            return True, [True] * len(self.items)

    s = PS.VerifyService(batch_max=64, queue_max=1024, device="cpu")
    s._make_verifier = lambda mode: SlowBV()
    try:
        ticket = s.submit([(b"p" * 32, b"m", b"s" * 64)], PS.Klass.MEMPOOL)
        deadline = time.monotonic() + WAIT
        inflight = []
        while not inflight or inflight[0]["where"] == "host":  # the host worker hands it to the collector
            assert time.monotonic() < deadline
            inflight = s.stats()["in_flight"]
            time.sleep(0.005)
        assert inflight[0]["class"] == "mempool" and inflight[0]["sigs"] == 1
        assert inflight[0]["age_s"] >= 0.0 and inflight[0]["device_age_s"] is not None
        gate.set()
        assert ticket.collect(WAIT) == (True, [True])
        while s.stats()["in_flight"]:
            assert time.monotonic() < deadline
            time.sleep(0.005)
    finally:
        gate.set()
        s.stop()


def test_verifysvc_stats_bounded_lock_wait():
    """stats(lock_timeout=) answers with the lock-free tallies while the
    scheduler's lock is held: diagnosing a wedge never blocks on it."""
    s = PS.VerifyService(device="cpu")
    held, release = threading.Event(), threading.Event()

    def holder():
        with s._cond:
            held.set()
            release.wait(WAIT)

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert held.wait(WAIT)
        st = s.stats(lock_timeout=0.05)
        assert st["queued"] == {"lock_busy": True}
        assert "in_flight" in st and "dispatched_batches" in st and "failover" in st
    finally:
        release.set()
        t.join(timeout=WAIT)
        s.stop()
