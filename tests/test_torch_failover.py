"""The verify service's failover (cometbft_tpu_torch/verifysvc/service.py)
against the JAX package's (cometbft_tpu/verifysvc/service.py): the
fault scripts of tests/test_failover.py run through the port's
VerifyService(device="cpu") and the JAX VerifyService(failover=True),
both given the same fake card verifier through their _make_verifier
seam and the same probe_fn.  Held equal: the verdicts and each
request's blame order, stats()["failover"], the metric deltas and the
flight-recorder events (kinds, fields and the values that do not
depend on the clock).  Then what the port adds: errors that are not the
card's fail their tickets, a real CombBatchVerifier on the CPU under
fail_dispatch and under a wedge, and the comb route's staging places
given back under a mesh of two spawned gloo ranks.

Every wait is bounded, so a stranded ticket fails a test instead of
hanging it."""

import threading
import time

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from cometbft_tpu.utils import fail as jfail
from cometbft_tpu.utils import healthmon as jhm
from cometbft_tpu.utils.flightrec import recorder as jrec
from cometbft_tpu.utils.metrics import hub as jhub
from cometbft_tpu.verifysvc import client as JCl
from cometbft_tpu.verifysvc import service as JS

from cometbft_tpu_torch import _build
from cometbft_tpu_torch._device import NoCudaDevice
from cometbft_tpu_torch.crypto import ed25519 as host
from cometbft_tpu_torch.models import comb_verifier as cv
from cometbft_tpu_torch.ops import comb, sha2
from cometbft_tpu_torch.utils import fail as pfail
from cometbft_tpu_torch.utils import healthmon as phm
from cometbft_tpu_torch.utils.flightrec import recorder as prec
from cometbft_tpu_torch.utils.metrics import hub as phub
from cometbft_tpu_torch.verifysvc import client as PCl
from cometbft_tpu_torch.verifysvc import service as PS

torch.set_num_threads(1)

WAIT = 15.0
# each package's service module, fault registry, health sentinel, flight
# recorder, metrics hub and client module
PKGS = {
    "port": (PS, pfail, phm, prec, phub, PCl),
    "jax": (JS, jfail, jhm, jrec, jhub, JCl),
}
# the series a fault script moves: (metric attribute, labels)
SERIES = [
    ("verify_svc_backend_mode", {}),
    ("verify_svc_failover", {"direction": "to_cpu"}),
    ("verify_svc_failover", {"direction": "to_tpu"}),
    ("verify_svc_host_reverify", {"cause": "wedge"}),
    ("verify_svc_host_reverify", {"cause": "dispatch_error"}),
    ("verify_svc_host_reverify", {"cause": "submit_error"}),
    ("verify_svc_host_reverify", {"cause": "collect_error"}),
    ("verify_svc_collect_timeout", {"class": "consensus"}),
    ("health_forensics", {}),
]


def _sigs(n, tag=b"t", tamper=()):
    out = []
    for i in range(n):
        sk = host.PrivKey.from_seed(bytes([11 + i]) * 32)
        msg = b"%s-%d" % (tag, i)
        sig = sk.sign(msg)
        if i in tamper:
            msg += b"!"
        out.append((sk.pub_key().data, msg, sig))
    return out


def _host_verdicts(items):
    return JS._host_verify_items(items)


class Probe:
    """A probe_fn of either package: ok while ``ok`` is set."""

    def __init__(self, pkg):
        self.hm = PKGS[pkg][2]
        self.ok = threading.Event()

    def __call__(self, _timeout_s):
        return self.hm.ProbeResult(self.ok.is_set(), "stub", 0.0)


class FakeDeviceBV:
    """A card verifier: a non-sync ticket, so the collector's wait (where
    the wedge and slow faults bite) runs; its collect() computes the host
    verdicts."""

    _entry = object()  # not offloaded to the host worker
    _fallback = None

    def __init__(self):
        self._items = []

    def add(self, pub, msg, sig):
        self._items.append((pub, msg, sig))

    def submit(self):
        return ("dev", list(self._items))

    def collect(self, ticket):
        return _host_verdicts(ticket[1])


def _fake_device(s, pkg):
    """The fake card serves the card's mode only: while tripped, the
    package's own routing (its _HostBatchVerifier) stays in charge."""
    S = PKGS[pkg][0]
    real = S.VerifyService._make_verifier.__get__(s)
    s._make_verifier = lambda mode: FakeDeviceBV() if s.backend_mode == S.MODE_TPU else real(mode)


def _metric_values(pkg):
    hub = PKGS[pkg][4]()
    return [getattr(hub, name).value(**labels) for name, labels in SERIES]


def _deltas(pkg, before):
    return [a - b for a, b in zip(_metric_values(pkg), before)]


def _last_seq(pkg):
    entries = PKGS[pkg][3]().dump()["entries"]
    return entries[-1]["seq"] if entries else 0


def _events(pkg, seq0, kinds=("verifysvc_failover", "verifysvc_collect_stall", "verifysvc_backpressure")):
    """The recorder's new events of ``kinds``: (kind, sorted detail keys,
    the detail values that do not depend on the clock)."""
    out = []
    for e in PKGS[pkg][3]().dump()["entries"]:
        if e["seq"] <= seq0 or e["kind"] not in kinds:
            continue
        d = e.get("detail", {})
        stable = {k: v for k, v in d.items() if k in ("direction", "stranded_sigs", "klass", "tenant", "sigs", "scope")}
        out.append((e["kind"], sorted(d), stable))
    return out


def _failover_stats(s):
    fo = dict(s.stats()["failover"])
    fo["last_artifact"] = fo["last_artifact"] is not None
    reason = fo["last_trip_reason"]
    fo["last_trip_reason"] = (None if reason is None else "deadline" if "deadline" in reason
                              else "sentinel" if "sentinel" in reason else reason)
    return fo


def _wait(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    for f in (pfail, jfail):
        f.clear_all()
    yield
    for f in (pfail, jfail):
        f.clear_all()


@pytest.fixture
def svc(tmp_path):
    """make(pkg, **kw): a service of either package with a stub probe
    that fails and its artifacts under tmp_path; all stopped after."""
    made = []

    def make(pkg, **kw):
        S = PKGS[pkg][0]
        kw.setdefault("artifact_dir", str(tmp_path / pkg))
        (tmp_path / pkg).mkdir(exist_ok=True)
        kw.setdefault("probe_fn", lambda _t: PKGS[pkg][2].ProbeResult(False, "probe off", 0.0))
        kw.setdefault("failover", True)
        if pkg == "port":
            kw["device"] = "cpu"
        s = S.VerifyService(**kw)
        made.append(s)
        return s

    yield make
    for f in (pfail, jfail):
        f.clear_all()  # un-wedge parked workers before joining them
    for s in made:
        s.stop()
    PS.reset_global_service()
    for hm in (phm, jhm):
        hm.uninstall()


# ------------------------------------------------------------- the trip


def _trip_script(pkg, make, tmp_path):
    """tests/test_failover.py's acceptance scenario: under consensus,
    mempool and background load a wedge mid-batch trips the service,
    every stranded ticket resolves with the host's verdicts, one artifact
    and one to_cpu event; while tripped traffic flows on the host; the
    probe heals and probation restores."""
    S, fail = PKGS[pkg][0], PKGS[pkg][1]
    probe = Probe(pkg)
    s = make(pkg, deadlines_ms={k: 0 for k in S.Klass}, batch_deadline_s=0.3, failover_tick_s=0.05,
             probation_ok=2, probe_period_s=0.05, probe_fn=probe)
    _fake_device(s, pkg)
    seq0, before = _last_seq(pkg), _metric_values(pkg)
    loads = {
        "cs": (_sigs(5, b"cs", tamper=(3,)), S.Klass.CONSENSUS),
        "mp1": (_sigs(3, b"mp1", tamper=(0,)), S.Klass.MEMPOOL),
        "mp2": (_sigs(2, b"mp2"), S.Klass.MEMPOOL),
        "bg": (_sigs(4, b"bg", tamper=(1, 2)), S.Klass.BACKGROUND),
    }
    fail.arm("wedge_device")
    tickets = {name: s.submit(items, klass) for name, (items, klass) in loads.items()}
    out = {"stranded": {name: tickets[name].collect(WAIT) for name in loads}}
    _wait(lambda: s.stats()["failover"]["last_artifact"] is not None, "no artifact")
    out["tripped"] = (s.backend_mode, _failover_stats(s))
    arts = sorted((tmp_path / pkg).iterdir())
    body = arts[0].read_text() if arts else ""
    out["artifacts"] = (len(arts), "failover to cpu_fallback" in body, "verify service (at trip)" in body)
    post = _sigs(3, b"post", tamper=(2,))
    out["post"] = s.submit(post, S.Klass.CONSENSUS).collect(WAIT)
    fail.clear("wedge_device")
    probe.ok.set()
    _wait(lambda: s.backend_mode == S.MODE_TPU, "no restore")
    again = _sigs(2, b"again")
    out["again"] = s.submit(again, S.Klass.CONSENSUS).collect(WAIT)
    out["restored"] = _failover_stats(s)
    out["metrics"] = _deltas(pkg, before)
    out["events"] = _events(pkg, seq0)
    # the gauge back where this test found it
    PKGS[pkg][4]().verify_svc_backend_mode.set(before[0])
    return out, loads, post, again


def test_wedge_trips_reverifies_in_add_order_and_restores_as_the_jax_service(svc, tmp_path):
    got = {pkg: _trip_script(pkg, svc, tmp_path) for pkg in PKGS}
    port, loads, post, again = got["port"]
    jax_ = got["jax"][0]
    for name, (items, _) in loads.items():
        assert port["stranded"][name] == _host_verdicts(items), name
    assert port["post"] == _host_verdicts(post) and port["again"] == _host_verdicts(again)
    assert port["tripped"][0] == "cpu_fallback"
    assert port["tripped"][1]["trips"] == 1 and port["tripped"][1]["last_trip_reason"] == "deadline"
    assert port["artifacts"] == (1, True, True)
    assert port["restored"]["restores"] == 1 and port["restored"]["backend_mode"] == "tpu"
    to_cpu = [e for e in port["events"] if e[2].get("direction") == "to_cpu"]
    assert len(to_cpu) == 1 and to_cpu[0][2]["stranded_sigs"] == 14
    # the same world, seen through both packages
    assert port == jax_


def test_health_sentinel_wedged_trips_the_service_as_the_jax_service(svc):
    """The second trigger: no batch stuck, but the sentinel says wedged;
    the next batch routes to the host."""
    got = {}
    for pkg in PKGS:
        S, hm = PKGS[pkg][0], PKGS[pkg][2]
        mon = hm.HealthMonitor(probe_fn=lambda _t, hm=hm: hm.ProbeResult(False, "down", 0.0), wedge_after=1,
                               probe_period_s=60.0)
        mon._state = hm.STATE_WEDGED
        hm.install(mon)
        try:
            s = svc(pkg, deadlines_ms={k: 0 for k in S.Klass}, failover_tick_s=0.05)
            s._ensure_started()
            _wait(lambda: s.backend_mode == S.MODE_CPU_FALLBACK, "no trip")
            items = _sigs(2, b"hw", tamper=(1,))
            got[pkg] = (_failover_stats(s)["last_trip_reason"], s.submit(items, S.Klass.CONSENSUS).collect(WAIT))
        finally:
            hm.uninstall()
    assert got["port"] == got["jax"] == ("sentinel", _host_verdicts(_sigs(2, b"hw", tamper=(1,))))


def test_ticket_resolution_is_first_wins():
    for S in (PS, JS):
        t = S.Ticket() if S is PS else S.Ticket(1)
        assert t._resolve((True, [True])) is True
        assert t._resolve((False, [False])) is False  # the late loser is dropped
        assert t._fail(RuntimeError("late")) is False
        assert t.done() and t.collect(0.1) == (True, [True])


def test_the_sweep_resolves_a_batch_that_raced_the_trip(svc):
    """A batch bound to the card while the trip happens misses the
    stranded snapshot: the sweep verifies it on the host once it is
    overdue, and drops its record."""
    got = {}
    for pkg in PKGS:
        S = PKGS[pkg][0]
        s = svc(pkg, deadlines_ms={k: 0 for k in S.Klass}, batch_deadline_s=0.2, failover_tick_s=0.05)
        s._ensure_started()
        before = _metric_values(pkg)
        assert s.trip_to_cpu("test: simulated wedge") is True
        assert s.trip_to_cpu("again") is False
        items = _sigs(3, b"race", tamper=(1,))
        req = S._Request(items, S.Klass.CONSENSUS, S.MODE_PLAIN)
        batch = [req]
        s._track_inflight(batch, "device")
        res = req.ticket.collect(WAIT)
        _wait(lambda: id(batch) not in s._inflight, "the sweep left the record")
        got[pkg] = (res, _failover_stats(s), _deltas(pkg, before))
        PKGS[pkg][4]().verify_svc_backend_mode.set(before[0])
    assert got["port"] == got["jax"]
    assert got["port"][0] == _host_verdicts(_sigs(3, b"race", tamper=(1,)))


def test_a_stale_card_payload_on_the_host_worker_is_rebuilt_on_the_host(svc):
    """A batch bound to the card, queued on the host worker when the trip
    lands, is verified on the host path, not submitted to the card."""
    got = {}
    for pkg in PKGS:
        S, fail = PKGS[pkg][0], PKGS[pkg][1]
        s = svc(pkg, deadlines_ms={k: 0 for k in S.Klass})
        s._ensure_started()
        assert s.trip_to_cpu("test: wedge") is True
        fail.arm("wedge_device")
        items = _sigs(3, b"stale", tamper=(0,))
        req = S._Request(items, S.Klass.CONSENSUS, S.MODE_PLAIN)
        bv = FakeDeviceBV()
        for it in items:
            bv.add(*it)
        s._track_inflight([req], "host")
        s._hostq.put((int(S.Klass.CONSENSUS), next(s._hostseq), (bv, [req])))
        items2 = _sigs(2, b"after")
        got[pkg] = (req.ticket.collect(WAIT), s.submit(items2, S.Klass.CONSENSUS).collect(WAIT))
        PKGS[pkg][4]().verify_svc_backend_mode.set(0.0)
    assert got["port"] == got["jax"] == (_host_verdicts(_sigs(3, b"stale", tamper=(0,))),
                                         _host_verdicts(_sigs(2, b"after")))


def test_host_worker_time_is_exempt_from_the_trip_deadline(svc):
    """Host-worker time never counts toward the card's deadline: the
    clock starts when the batch is handed to the collector."""
    for pkg in PKGS:
        S = PKGS[pkg][0]
        s = svc(pkg, batch_deadline_s=0.2)
        batch = [S._Request(_sigs(1, b"cold"), S.Klass.CONSENSUS, S.MODE_PLAIN)]
        s._track_inflight(batch, "host")
        rec = s._inflight[id(batch)]
        rec["since"] -= 300.0  # five minutes of host work
        assert s._trip_reason() is None
        s._relabel_inflight(batch, "device")
        assert s._trip_reason() is None
        rec["device_since"] -= 1.0
        assert "deadline" in s._trip_reason()
        assert s.stats()["in_flight"][0]["device_age_s"] >= 1.0
        s._untrack_inflight(batch)


def test_the_service_restarts_after_stop(svc):
    for pkg in PKGS:
        S = PKGS[pkg][0]
        s = svc(pkg, deadlines_ms={k: 0 for k in S.Klass})
        items = _sigs(2, b"r1")
        assert s.submit(items, S.Klass.CONSENSUS).collect(WAIT) == _host_verdicts(items)
        s.stop()
        assert s._stop_ev.is_set()
        items = _sigs(2, b"r2", tamper=(0,))
        assert s.submit(items, S.Klass.CONSENSUS).collect(WAIT) == _host_verdicts(items)
        assert not s._stop_ev.is_set()


def _cycles(pkg, make, n_cycles=3):
    """Three trip -> probation -> restore cycles under concurrent load of
    three tenants in three classes: no ticket lost, every verdict the
    host's, every tenant served."""
    S, fail = PKGS[pkg][0], PKGS[pkg][1]
    probe = Probe(pkg)
    s = make(pkg, deadlines_ms={k: 0 for k in S.Klass}, batch_deadline_s=0.25, failover_tick_s=0.03,
             probation_ok=1, probe_period_s=0.03, probe_fn=probe)
    _fake_device(s, pkg)
    stop = threading.Event()
    results, errors, mtx = [], [], threading.Lock()

    def loader(tenant, klass, tag):
        i = 0
        while not stop.is_set():
            items = _sigs(3, tag + b"-%d" % (i % 4), tamper=(i % 3,))
            try:
                got = s.submit(items, klass, tenant=tenant).collect(WAIT)
            except Exception as e:  # noqa: BLE001 — a lost or failed ticket fails the test
                errors.append(f"{tenant}: {type(e).__name__}: {e}")
                return
            with mtx:
                results.append((tenant, items, got))
            i += 1
            time.sleep(0.005)

    specs = [("chain-a", S.Klass.CONSENSUS, b"la"), ("chain-b", S.Klass.CONSENSUS, b"lb"),
             ("chain-b", S.Klass.MEMPOOL, b"lm"), ("chain-c", S.Klass.BACKGROUND, b"lc")]
    threads = [threading.Thread(target=loader, args=spec) for spec in specs]
    for t in threads:
        t.start()
    try:
        for cycle in range(n_cycles):
            probe.ok.clear()
            fail.arm("wedge_device")
            _wait(lambda: s.backend_mode == S.MODE_CPU_FALLBACK, f"cycle {cycle}: no trip")
            n0 = len(results)
            time.sleep(0.2)
            assert len(results) > n0, f"cycle {cycle}: no progress while tripped"
            fail.clear("wedge_device")
            probe.ok.set()
            _wait(lambda: s.backend_mode == S.MODE_TPU, f"cycle {cycle}: no restore")
            time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join(WAIT)
    assert not errors, errors
    assert all(got == _host_verdicts(items) for _, items, got in results)
    st = s.stats()
    return ({t for t, _, _ in results}, {k: st["failover"][k] for k in ("trips", "restores", "backend_mode")},
            all(st["tenants"][t]["dispatched_batches"] > 0 for t in ("chain-a", "chain-b", "chain-c")),
            len(results) >= 20)


def test_repeated_failover_cycles_across_tenants_as_the_jax_service(svc):
    got = {pkg: _cycles(pkg, svc) for pkg in PKGS}
    assert got["port"] == got["jax"] == ({"chain-a", "chain-b", "chain-c"},
                                         {"trips": 3, "restores": 3, "backend_mode": "tpu"}, True, True)


# ---------------------------------------------------- the host path's routing


def test_make_verifier_bypasses_comb_in_cpu_mode(svc):
    for pkg in PKGS:
        S = PKGS[pkg][0]
        s = svc(pkg)
        s._backend_mode = S.MODE_CPU_FALLBACK
        for mode in (("comb", object()), S.MODE_PLAIN, S.MODE_SECP, S.MODE_BLS, S.MODE_PROOF):
            assert isinstance(s._make_verifier(mode), S._HostBatchVerifier), (pkg, mode)


def test_resolve_mode_bypasses_the_comb_bind_when_tripped(svc, monkeypatch):
    """A tripped global service makes resolve_mode take MODE_PLAIN with no
    comb bind, in both packages; a running one binds the tables."""
    pubs = [bytes([i % 256, i // 256]) * 16 for i in range(600)]  # >= comb_min
    called = []
    monkeypatch.setattr("cometbft_tpu.models.comb_verifier.global_cache", lambda: called.append("jax"))
    js = svc("jax")
    js._backend_mode = JS.MODE_CPU_FALLBACK
    monkeypatch.setattr(JS, "_GLOBAL", js)
    assert JCl.resolve_mode(pubs) == JS.MODE_PLAIN
    ps = PS.global_service("cpu")
    ps._backend_mode = PS.MODE_CPU_FALLBACK
    cache = cv.ValsetCombCache()
    monkeypatch.setattr(cache, "ensure", lambda *a, **k: called.append("port"))
    monkeypatch.setattr(cache, "ensure_async", lambda *a, **k: called.append("port"))
    assert PCl.resolve_mode(pubs, device="cpu", comb_cache=cache) == (PS.MODE_PLAIN, torch.device("cpu"))
    assert not called
    ps._backend_mode = PS.MODE_TPU
    PCl.resolve_mode(pubs, device="cpu", comb_cache=cache)
    assert called == ["port"]


def test_client_on_a_tripped_service_verifies_on_the_host(svc):
    got = {}
    for pkg in PKGS:
        S, Cl = PKGS[pkg][0], PKGS[pkg][5]
        s = svc(pkg, deadlines_ms={k: 0 for k in S.Klass})
        s._backend_mode = S.MODE_CPU_FALLBACK
        items = _sigs(4, b"cli", tamper=(0, 2))
        bv = Cl.ServiceBatchVerifier(S.Klass.BLOCKSYNC, service=s)
        for it in items:
            bv.add(*it)
        got[pkg] = bv.verify()
    assert got["port"] == got["jax"] == _host_verdicts(_sigs(4, b"cli", tamper=(0, 2)))


# ------------------------------------------------------------ the faults


def test_fail_dispatch_is_verified_again_on_the_host_as_the_jax_service(svc):
    got = {}
    for pkg in PKGS:
        S, fail = PKGS[pkg][0], PKGS[pkg][1]
        s = svc(pkg, deadlines_ms={k: 0 for k in S.Klass})
        seq0, before = _last_seq(pkg), _metric_values(pkg)
        fail.arm("fail_dispatch")
        items = _sigs(4, b"fd", tamper=(1, 3))
        faulted = s.submit(items, S.Klass.MEMPOOL).collect(WAIT)
        fail.clear("fail_dispatch")
        items2 = _sigs(2, b"ok")
        got[pkg] = (faulted, s.backend_mode, s.submit(items2, S.Klass.MEMPOOL).collect(WAIT),
                    _deltas(pkg, before), _events(pkg, seq0), fail.fired().get("fail_dispatch", 0) > 0)
    assert got["port"] == got["jax"]
    faulted, mode, after, deltas, events, fired = got["port"]
    assert faulted == _host_verdicts(_sigs(4, b"fd", tamper=(1, 3))) and mode == "tpu" and fired
    assert after == _host_verdicts(_sigs(2, b"ok"))
    assert deltas[SERIES.index(("verify_svc_host_reverify", {"cause": "dispatch_error"}))] == 1
    assert events == []


def test_slow_collect_delays_but_resolves_as_the_jax_service(svc):
    for pkg in PKGS:
        S, fail = PKGS[pkg][0], PKGS[pkg][1]
        s = svc(pkg, deadlines_ms={k: 0 for k in S.Klass})
        _fake_device(s, pkg)
        fail.arm("slow_collect", 0.3)
        items = _sigs(2, b"slow")
        t0 = time.monotonic()
        assert s.submit(items, S.Klass.CONSENSUS).collect(WAIT) == _host_verdicts(items)
        assert time.monotonic() - t0 >= 0.25
        assert s.stats()["failover"]["trips"] == 0


def test_collect_stall_report_is_rate_limited_as_the_jax_service(tmp_path):
    """report_collect_stall: every call counted and recorded, one
    artifact a window."""
    got = {}
    for pkg in PKGS:
        S = PKGS[pkg][0]
        S._reset_stall_gate()
        seq0, before = _last_seq(pkg), _metric_values(pkg)
        d = tmp_path / pkg
        d.mkdir()
        paths = [S.report_collect_stall(S.Klass.CONSENSUS, "t1", 7, 0.5 + i, artifact_dir=str(d))
                 for i in range(2)]
        arts = list(d.iterdir())
        got[pkg] = (paths[1], len(arts), "collect() deadline expired: class=consensus tenant=t1 sigs=7"
                    in arts[0].read_text(), _deltas(pkg, before), _events(pkg, seq0))
        S._reset_stall_gate()
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (None, 1, True)
    assert got["port"][3][SERIES.index(("verify_svc_collect_timeout", {"class": "consensus"}))] == 2


def test_stats_carry_the_jax_failover_section(svc):
    fos = {pkg: svc(pkg).stats()["failover"] for pkg in PKGS}
    assert fos["port"] == fos["jax"]
    assert fos["port"]["enabled"] is True and fos["port"]["trips"] == 0 and fos["port"]["batch_deadline_ms"] == 30000


# ------------------------------------- errors that are not the card's (port only)
#
# The JAX package has no build step and no card to miss, so it has no
# counterpart to these: a BuildError, a NoCudaDevice, a kernel wrapper's
# LaunchRefused or a KernelError (a launch that failed) is a fault of the
# build, the machine, the caller or the kernel.  Verifying such a batch
# again on the host would hide it behind correct verdicts, so the tickets
# fail with it even with failover on.


def _refused_launch():
    """A real kernel wrapper refusing its arguments: a payload narrower
    than its 68-byte header."""
    sha2.parse_verify_payload(torch.zeros((2, 3), dtype=torch.uint8), torch.zeros((2, 32), dtype=torch.uint8))


def _failed_launch(*_args, **_kwargs):
    """What every ops/ wrapper does right after its launch when
    cudaGetLastError() is non-zero (719: cudaErrorLaunchFailure)."""
    _build.check(719, "k4_verify_cached")


@pytest.mark.parametrize("exc", ["BuildError", "NoCudaDevice", "LaunchRefused", "KernelError"])
@pytest.mark.parametrize("where", ["dispatch", "submit", "collect"])
def test_errors_that_are_not_the_cards_fail_the_tickets(svc, exc, where):
    def boom():
        if exc == "BuildError":
            raise _build.BuildError("nvcc failed for comb.cu")
        if exc == "NoCudaDevice":
            from cometbft_tpu_torch.models.verifier import Ed25519BatchVerifier

            Ed25519BatchVerifier(device="cuda")  # no card here: raises NoCudaDevice
            raise AssertionError("a card is present")
        if exc == "KernelError":
            _failed_launch()
        _refused_launch()

    class Faulty(FakeDeviceBV):
        _entry = None if where == "submit" else object()

        def submit(self):
            if where == "submit":
                boom()
            return super().submit()

        def collect(self, ticket):
            if where == "collect":
                boom()
            return super().collect(ticket)

    def make(mode):
        if where == "dispatch":
            boom()
        return Faulty()

    s = svc("port", deadlines_ms={k: 0 for k in PS.Klass})
    s._make_verifier = make
    before = _metric_values("port")
    want = {"BuildError": _build.BuildError, "NoCudaDevice": NoCudaDevice, "LaunchRefused": _build.LaunchRefused,
            "KernelError": _build.KernelError}[exc]
    with pytest.raises(want):
        s.submit(_sigs(2, b"nd"), PS.Klass.CONSENSUS).collect(WAIT)
    assert _deltas("port", before) == [0.0] * len(SERIES)
    assert s.backend_mode == "tpu"
    s._make_verifier = lambda mode: FakeDeviceBV()
    items = _sigs(2, b"next")
    assert s.submit(items, PS.Klass.CONSENSUS).collect(WAIT) == _host_verdicts(items)


def test_a_launch_refusal_is_a_value_error():
    with pytest.raises(ValueError, match="payload"):
        _refused_launch()


def test_a_host_path_build_error_is_not_verified_again(svc, monkeypatch, tmp_path):
    """The BLS lane's pairings run in the native host core
    (hostsrc/bls381.cc, built by _build.host_lib).  Its failed build
    raises BuildError on the host worker: the tickets fail with it, no
    host re-verify (which would need the same core)."""
    from cometbft_tpu_torch.crypto import bls12381

    keys = [bls12381.PrivKey.from_secret(bytes([7 + i]) * 32) for i in range(2)]
    msg = b"bls-build-error"
    items = [(k.pub_key().data, msg, k.sign(msg)) for k in keys]
    monkeypatch.setattr(_build, "_HOST_LIBS", {})
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", str(tmp_path / "host"))
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    s = svc("port", deadlines_ms={k: 0 for k in PS.Klass})
    before = _metric_values("port")
    with pytest.raises(_build.BuildError):
        s.submit(items, PS.Klass.CONSENSUS, PS.MODE_BLS).collect(WAIT)
    assert _deltas("port", before) == [0.0] * len(SERIES)


# ------------------------------------------------ the real comb verifier


@pytest.fixture(scope="module")
def comb_set():
    """64 validators' keys, their tables on the CPU and a signed batch
    with two planted faults."""
    rng = np.random.default_rng(2031)
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(64)]
    pubs = [k.pub_key().data for k in keys]
    entry = cv.ValsetCombCache().ensure(pubs, device="cpu")
    items = []
    for i, k in enumerate(keys):
        m = b"failover-%d-" % i + rng.bytes(int(rng.integers(100, 140)))
        sig = k.sign(m)
        items.append((pubs[i], m + (b"!" if i in (5, 40) else b""), sig))
    return entry, items


def test_fail_dispatch_on_the_comb_path_gives_the_host_oracles_verdicts(svc, comb_set):
    """A real CombBatchVerifier (K1 -> K2 -> K4's plain versions): with
    fail_dispatch armed the batch is verified on the host, with the JAX
    host oracle's verdicts and the unfaulted run's."""
    entry, items = comb_set
    s = svc("port", deadlines_ms={k: 0 for k in PS.Klass})
    mode = ("comb", entry)
    before = (sha2.LAUNCHES["parse_verify_payload"], comb.LAUNCHES["verify_cached"])
    clean = s.submit(items, PS.Klass.CONSENSUS, mode).collect(WAIT)
    pfail.arm("fail_dispatch")
    try:
        faulted = s.submit(items, PS.Klass.CONSENSUS, mode).collect(WAIT)
    finally:
        pfail.clear("fail_dispatch")
    want = JS._host_verify_items(items)
    assert clean == faulted == want and want[1].count(False) == 2
    assert s.stats()["failover"]["trips"] == 0


def test_a_failed_launch_in_a_comb_stage_fails_the_tickets(svc, comb_set, monkeypatch):
    """K4's launch failing inside the stage of a real comb batch, on the
    staging thread: with failover on the tickets fail with the
    KernelError, nothing is verified again on the host, the service keeps
    its mode, and the next batch runs the comb path."""
    entry, items = comb_set
    s = svc("port", deadlines_ms={k: 0 for k in PS.Klass})
    mode = ("comb", entry)
    before = _metric_values("port")
    with monkeypatch.context() as mp:
        mp.setattr(comb, "verify_cached", _failed_launch)
        with pytest.raises(_build.KernelError, match="k4_verify_cached"):
            s.submit(items, PS.Klass.CONSENSUS, mode).collect(WAIT)
    assert _deltas("port", before) == [0.0] * len(SERIES)
    assert s.submit(items, PS.Klass.CONSENSUS, mode).collect(WAIT) == JS._host_verify_items(items)
    assert s.backend_mode == "tpu" and s.stats()["failover"]["trips"] == 0


def test_wedged_comb_batches_are_reverified_and_their_slabs_come_back(svc, comb_set):
    """Two comb batches in flight when the card wedges: the first parked in
    the collector's wait, the second queued behind it.  The service trips
    and verifies both on the host in add() order; once the wedge clears
    the parked collects finish, their late results dropped, and both
    slabs go back to the pool.  Then the probe restores and the comb path
    serves again."""
    entry, items = comb_set
    probe = Probe("port")
    s = svc("port", deadlines_ms={k: 0 for k in PS.Klass}, batch_deadline_s=0.3, failover_tick_s=0.05,
            probation_ok=1, probe_period_s=0.05, probe_fn=probe)
    width = 68 + cv._bucket_mlen(max(len(m) for _, m, _ in items))
    entry._slabs.pop(width, None)
    pfail.arm("wedge_device")
    tickets = [s.submit(items, PS.Klass.CONSENSUS, ("comb", entry)) for _ in range(2)]
    res = [t.collect(WAIT) for t in tickets]
    assert res == [JS._host_verify_items(items)] * 2
    assert s.backend_mode == "cpu_fallback" and s.stats()["failover"]["trips"] == 1
    pfail.clear("wedge_device")
    _wait(lambda: len(entry._slabs.get(width, [])) == 2, "a stranded batch's slab never came back")
    probe.ok.set()
    _wait(lambda: s.backend_mode == "tpu", "no restore")
    assert s.submit(items, PS.Klass.CONSENSUS, ("comb", entry)).collect(WAIT) == res[0]
    phub().verify_svc_backend_mode.set(0.0)


def test_a_settled_comb_batch_skipped_by_the_collector_gives_its_slab_back(svc, comb_set):
    """A batch the trip verified on the host while it sat in the collect
    queue is skipped by the fresh collector (its wait could park it in the
    same wedge); its ticket is waited out on a thread of its own, so the
    slab still goes back to the pool."""
    entry, items = comb_set
    s = svc("port")
    width = 68 + cv._bucket_mlen(max(len(m) for _, m, _ in items))
    entry._slabs.pop(width, None)
    bv = cv.CombBatchVerifier(entry)
    for it in items:
        bv.add(*it)
    ticket = bv.submit()
    req = PS._Request(items, PS.Klass.CONSENSUS, ("comb", entry))
    req.ticket._resolve(JS._host_verify_items(items))
    batch = [req]
    s._track_inflight(batch, "device")
    s._settle(bv, ticket, batch, 0.0)
    assert not s._inflight
    _wait(lambda: len(entry._slabs.get(width, [])) == 1, "the skipped batch's slab never came back")


# --------------------------------------------- staging places under a mesh


@pytest.fixture(scope="module")
def token_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("failover_tokens")
    return R.spawn(2, out, ("failover_tokens",), R.make_case(2032), comb.build_b_tables(), timeout=300)


def test_failover_paths_give_their_staging_places_back_under_a_mesh(token_ranks):
    """Two spawned gloo ranks: no rank verifies a comb batch sharded over
    the mesh on the host alone.  A fail_dispatch, a batch while tripped
    and a batch failed with a BuildError each fail their tickets and give
    back the place their request took at submit, so every later comb
    batch still runs its collectives (a place kept would hang the staging
    thread, and the spawn's join limit would fail).  A trip on one rank
    sends both uncached through resolve_mode's agreement, and both back to
    the comb route after the restore (a rank that skipped the agreement
    would leave the other's collectives to wait out the group timeout)."""
    case = R.make_case(2032)
    runs = [r["failover_tokens"] for r in token_ranks]
    assert runs[0] == runs[1]
    good = JS._host_verify_items(R.comb_items(case))
    bad = JS._host_verify_items(R.comb_items(case, R.TAMPER))
    out = runs[0]
    assert bad[1] == [i != R.TAMPER for i in range(R.N_SIGS)]
    for key in ("before", "after_restore"):
        assert out[key] == bad, key
    for key in ("after_fail_dispatch", "after_build_error"):
        assert out[key] == good, key
    assert out["fail_dispatch"] == "InjectedFault: injected fault: fail_dispatch"
    assert out["tripped"].startswith("MeshFailoverRefused: the service is tripped")
    assert out["build_error"].startswith("BuildError: nvcc failed")
    assert out["failover"] == {"trips": 1, "restores": 1, "backend_mode": "tpu"}
    assert out["asym_routes"] == ["plain", "comb"]
    assert out["asym"] == [bad, bad]
