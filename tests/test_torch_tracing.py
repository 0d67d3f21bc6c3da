"""The port's span tracer (cometbft_tpu_torch/utils/tracing.py) against
the JAX package's (cometbft_tpu/utils/tracing.py): the in-process cases
of tests/test_tracing.py and tests/test_trace_context.py on the port's
copy, the two tracers' exports of one sequence of events, the knobs'
names and defaults, the spans the port opens (an AST walk against the
JAX package's sites on the ported paths), and a traced comb verify
through the service on the CPU.

The tracer is process-wide, so every test restores the disabled default
and clears the ring on exit."""

import ast
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest
import torch

from cometbft_tpu.utils import envknobs as jknobs
from cometbft_tpu.utils import tracing as jtracing

from cometbft_tpu_torch import envknobs
from cometbft_tpu_torch.crypto import ed25519 as host
from cometbft_tpu_torch.models import comb_verifier as cv
from cometbft_tpu_torch.utils import tracing
from cometbft_tpu_torch.verifysvc import service as PS
from cometbft_tpu_torch.verifysvc.client import ServiceBatchVerifier

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_tracer():
    yield
    for t in (tracing, jtracing):
        t.set_enabled(False, ring_capacity=65536)
        t.reset()
    PS.reset_global_service()


# ------------------------------------------------------------------ tracer


def test_export_carries_wall_clock_anchor(tmp_path):
    """One wall_clock_anchor metadata record an export: a (wall_ns,
    perf_ns) pair that places every span on the wall clock."""
    tracing.set_enabled(True)
    tracing.reset()
    with tracing.span("anchored"):
        pass
    events = tracing.chrome_trace_events()
    anchors = [e for e in events if e["name"] == "wall_clock_anchor"]
    assert len(anchors) == 1 and anchors[0]["ph"] == "M"
    args = anchors[0]["args"]
    assert abs(args["wall_time_ns"] - time.time_ns()) < 5e9
    assert abs(args["perf_counter_ns"] - time.perf_counter_ns()) < 5e9
    span_ev = next(e for e in events if e["name"] == "anchored")
    assert abs(args["wall_time_ns"] + (span_ev["ts"] * 1e3 - args["perf_counter_ns"]) - time.time_ns()) < 5e9
    path = str(tmp_path / "anchored.trace.json")
    n = tracing.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    assert n == sum(1 for e in doc["traceEvents"] if e["ph"] != "M")
    assert any(e["name"] == "wall_clock_anchor" for e in doc["traceEvents"])


def test_disabled_path_is_shared_noop():
    """Off (the default): span() is one shared no-op object and nothing
    is recorded."""
    tracing.set_enabled(False)
    tracing.reset()
    s1, s2 = tracing.span("hot.path"), tracing.span("other", {"k": 1})
    assert s1 is s2
    with s1:
        pass
    tracing.instant("marker")
    assert [e for e in tracing.chrome_trace_events() if e["ph"] != "M"] == []


def test_span_nesting_and_chrome_schema(tmp_path):
    tracing.set_enabled(True)
    tracing.reset()
    with tracing.span("outer", {"height": 5}):
        with tracing.span("inner"):
            pass
        tracing.instant("mark", {"kind": "x"})
    path = str(tmp_path / "t.trace.json")
    assert tracing.export_chrome_trace(path) == 3
    with open(path) as f:
        doc = json.load(f)
    evs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] != "M"}
    assert set(evs) == {"outer", "inner", "mark"}
    for e in evs.values():
        assert {"ph", "name", "cat", "pid", "tid", "ts"} <= set(e)
    outer, inner, mark = evs["outer"], evs["inner"], evs["mark"]
    assert outer["ph"] == "X" and "dur" in outer and outer["args"] == {"height": 5}
    assert mark["ph"] == "i" and mark["s"] == "t" and "dur" not in mark
    assert inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert any(m["tid"] == outer["tid"] and m["args"]["name"]
               for m in doc["traceEvents"] if m["ph"] == "M" and m["name"] == "thread_name")


def test_ring_bounds_memory_and_keeps_newest():
    tracing.set_enabled(True, ring_capacity=100)
    tracing.reset()
    for i in range(500):
        tracing.instant(f"e{i}")
    evs = [e for e in tracing.chrome_trace_events() if e["ph"] != "M"]
    assert len(evs) <= 100 and tracing.dropped_count() >= 400
    names = {e["name"] for e in evs}
    assert "e499" in names and "e0" not in names


def test_cross_thread_spans_drain_on_export():
    tracing.set_enabled(True)
    tracing.reset()

    def work():
        with tracing.span("worker.span"):
            pass

    t = threading.Thread(target=work, name="trace-worker")
    t.start()
    t.join()
    with tracing.span("main.span"):
        pass
    evs = {e["name"]: e for e in tracing.chrome_trace_events() if e["ph"] != "M"}
    assert {"worker.span", "main.span"} <= set(evs)
    assert evs["worker.span"]["tid"] != evs["main.span"]["tid"]


# ------------------------------------------------------------ SpanContext


def test_traceparent_roundtrip_and_child():
    ctx = tracing.new_context()
    assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16
    hdr = ctx.to_traceparent()
    assert hdr == f"00-{ctx.trace_id}-{ctx.span_id}-01"
    assert tracing.SpanContext.from_traceparent(hdr) == ctx
    kid = ctx.child()
    assert kid.trace_id == ctx.trace_id and kid.span_id != ctx.span_id
    # the JAX package parses the port's header to the same identity
    j = jtracing.SpanContext.from_traceparent(hdr)
    assert (j.trace_id, j.span_id) == (ctx.trace_id, ctx.span_id)


@pytest.mark.parametrize("bad", [
    "",
    "not-a-traceparent",
    "00-abc-def-01",
    "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "1" * 16,
])
def test_malformed_traceparent_degrades_to_none(bad):
    assert tracing.SpanContext.from_traceparent(bad) is None
    assert jtracing.SpanContext.from_traceparent(bad) is None


def test_context_scope_labels_spans_and_restores():
    tracing.set_enabled(True)
    tracing.reset()
    ctx = tracing.new_context()
    assert tracing.current_context() is None
    with tracing.context_scope(ctx):
        assert tracing.current_context() is ctx
        with tracing.span("inside"):
            pass
        with tracing.context_scope(None):
            assert tracing.current_context() is ctx
    assert tracing.current_context() is None
    with tracing.span("outside"):
        pass
    events = {e["name"]: e for e in tracing.chrome_trace_events()}
    assert events["inside"]["args"] == {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
    assert "trace_id" not in events["outside"].get("args", {})


def test_propagation_requires_tracing_enabled():
    assert not tracing.propagation_enabled()
    with tracing.context_scope(tracing.new_context()):
        assert tracing.current_context() is None
    tracing.set_enabled(True)
    assert tracing.propagation_enabled()


# -------------------------------------------------- against the JAX tracer


def _drive(t):
    """One sequence of events on tracer module ``t``: nesting, an instant,
    a span on a thread of its own, a context scope; -> its export without
    clocks and ids, in time order."""
    t.set_enabled(True, ring_capacity=1000)
    t.reset()
    ctx = t.SpanContext("ab" * 16, "cd" * 8)
    with t.span("a", {"height": 3, "who": b"x"}):
        with t.span("b"):
            t.instant("c", {"n": 1})
    th = threading.Thread(target=lambda: t.span("d").__enter__().__exit__(None, None, None), name="drv")
    th.start()
    th.join()
    with t.context_scope(ctx), t.span("e"):
        pass
    evs = t.chrome_trace_events()
    names = sorted(e["args"]["name"] for e in evs if e["name"] == "thread_name")
    body = [(e["ph"], e["name"], e["cat"], e.get("s"), "dur" in e, e.get("args"))
            for e in evs if e["ph"] != "M"]
    t.set_enabled(False)
    return body, "drv" in names, [e["name"] for e in evs if e["ph"] == "M"][0]


def test_exports_match_the_jax_tracer():
    assert _drive(tracing) == _drive(jtracing)


def test_knobs_read_the_jax_names_and_defaults(tmp_path):
    """COMETBFT_TPU_TRACE / _RING / _CTX with the JAX defaults; a path
    value records and writes the trace at interpreter exit."""
    for name in ("TRACE", "TRACE_RING", "TRACE_CTX"):
        ours, theirs = getattr(envknobs, name), getattr(jknobs, name)
        assert ours == theirs
        assert envknobs._DEFAULTS[ours] == jknobs._REGISTRY[theirs].default
    out = tmp_path / "exit.trace.json"
    env = dict(os.environ, COMETBFT_TPU_TRACE=str(out), COMETBFT_TPU_TRACE_RING="7",
               COMETBFT_TPU_TRACE_CTX="0", PYTHONPATH=str(ROOT))
    code = ("from cometbft_tpu_torch.utils import tracing as t\n"
            "assert t.enabled() and t._ring_cap == 7 and not t.propagation_enabled()\n"
            "with t.span('at.exit'):\n    pass\n")
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
    doc = json.loads(out.read_text())
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] != "M"] == ["at.exit"]


# ------------------------------------------------------- the spans opened


# the JAX modules of the ported paths -> the port's module holding the same sites
SITES = {
    "models/comb_verifier.py": "models/comb_verifier.py",
    "models/verifier.py": "models/verifier.py",
    "models/secp_verifier.py": "models/secp_verifier.py",
    "models/bls_verifier.py": "models/bls_verifier.py",
    "models/proof_server.py": "models/proof_server.py",
    "verifysvc/service.py": "verifysvc/service.py",
    "verifysvc/client.py": "verifysvc/client.py",
    "blocksync/reactor.py:_top_up_verify_pipeline": "blocksync/replay.py",
}
# not opened by the port, by name: verify.host_route marks the JAX host
# route by batch width, which the port does not have (ROADMAP C)
NOT_PORTED = {"verify.host_route"}


def span_names(path: pathlib.Path, func: str | None = None) -> set[str]:
    """String literals passed first to tracing.span / tracing.instant (and
    to a client's _host_fallback, which opens its span by that name) in
    ``path``, or in its function ``func``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    if func is not None:
        tree = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    out = set()
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.args
                and isinstance(n.args[0], ast.Constant) and isinstance(n.args[0].value, str)):
            continue
        f = n.func
        if (f.attr in ("span", "instant") and isinstance(f.value, ast.Name) and f.value.id == "tracing") \
                or f.attr == "_host_fallback":
            out.add(n.args[0].value)
    return out


@pytest.mark.parametrize("jax_site", sorted(SITES))
def test_port_opens_the_jax_spans_at_their_sites(jax_site):
    path, _, func = jax_site.partition(":")
    want = span_names(ROOT / "cometbft_tpu" / path, func or None) - NOT_PORTED
    got = span_names(ROOT / "cometbft_tpu_torch" / SITES[jax_site])
    assert want and got == want


def test_span_scan_covers_the_whole_port():
    """Every span name the port opens anywhere is one the JAX package
    opens on these paths, and every JAX one is opened but the listed."""
    want = set().union(*(span_names(ROOT / "cometbft_tpu" / k.partition(":")[0], k.partition(":")[2] or None)
                         for k in SITES))
    got = set().union(*(span_names(p) for p in (ROOT / "cometbft_tpu_torch").rglob("*.py")))
    assert got == want - NOT_PORTED
    assert NOT_PORTED <= want


def test_scanner_reads_literals_only(tmp_path):
    f = tmp_path / "planted.py"
    f.write_text("from x import tracing\nname = 'v'\n"
                 "with tracing.span('one'):\n    tracing.instant('two', None)\n"
                 "tracing.span(name)\nother.span('three')\nself._host_fallback('four')\n")
    assert span_names(f) == {"one", "two", "four"}


# ------------------------------------------------------- a traced verify


def test_traced_comb_verify_through_the_service(monkeypatch):
    """With tracing on, one comb batch through the service records the
    scheduler's, the staging thread's and the collector's spans, each on
    its own thread, all under the submitter's trace_id."""
    keys = [host.PrivKey.from_seed(bytes([i + 90]) * 32) for i in range(8)]
    pubs = [k.pub_key().data for k in keys]
    entry = cv.ValsetCombCache().ensure(pubs, device="cpu")
    items = [(p, b"traced-%d" % i, k.sign(b"traced-%d" % i)) for i, (p, k) in enumerate(zip(pubs, keys))]
    svc = PS.VerifyService(device="cpu")
    tracing.set_enabled(True)
    tracing.reset()
    try:
        bv = ServiceBatchVerifier(PS.Klass.BLOCKSYNC, ("comb", entry), service=svc)
        for it in items:
            bv.add(*it)
        assert bv.verify() == (True, [True] * 8)
    finally:
        svc.stop()
    evs = tracing.chrome_trace_events()
    names = {e["tid"]: e["args"]["name"] for e in evs if e["name"] == "thread_name"}
    where = {e["name"]: names[e["tid"]] for e in evs if e["ph"] != "M"}
    assert where["verify.sched.dispatch"] == "verifysvc-sched"
    assert where["verify.slab_fill"] == where["verify.h2d_dispatch"] == "comb-stage_0"
    assert where["verify.staging_wait"] == where["verify.device_wait"] == where["verify.blame_unpack"] \
        == where["verify.sched.collect"] == "verifysvc-collect"
    ids = {e["args"]["trace_id"] for e in evs if e["name"].startswith("verify.sched.")}
    assert len(ids) == 1 and ids == {bv._ctx.trace_id}
