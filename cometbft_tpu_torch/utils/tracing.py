"""In-process span tracer of the verify plane (the port of
cometbft_tpu/utils/tracing.py, the same events, knobs and export).

Call sites open monotonic-clock spans (``with tracing.span("x")``) or
drop instant markers (``tracing.instant("y")``); finished events land in
a per-thread buffer (appends take no lock) that drains in chunks into
one process-wide bounded ring, and the ring exports as Chrome
trace-event JSON: open the file in Perfetto (ui.perfetto.dev) or
chrome://tracing to see a VerifyCommit laid out across the caller's
thread, the verify service's threads and the comb path's staging
thread (slab fill, copy and launches, the waits, the blame unpack).

Cost: tracing is off by default, and then a span is one module-bool
check returning a shared no-op context manager: no allocation, no clock
read, so the paths stay instrumented.  On, a span is two
perf_counter_ns reads and a tuple append; the ring bounds the memory
however long the run.

COMETBFT_TPU_TRACE=1 records (drain with export_chrome_trace);
COMETBFT_TPU_TRACE=/path/to/out.trace.json also exports there at
interpreter exit.  COMETBFT_TPU_TRACE_RING sizes the ring (events,
default 65536).

A :class:`SpanContext` (a W3C-traceparent-shaped trace_id / span_id
pair) can be installed as the thread's current context
(:func:`context_scope`); every event recorded under it carries
``trace_id`` / ``span_id`` args, so a request's spans on the service's
threads share the submitter's trace_id.  The context serializes to and
parses from a ``traceparent`` string.  COMETBFT_TPU_TRACE_CTX=0 turns
the args off.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref

from .. import envknobs

_OFF_VALUES = ("", "0", "false", "off", "no")
_ON_VALUES = ("1", "true", "on", "yes")

# events drain from thread-local buffers to the ring in chunks this big;
# small enough that an export misses at most a few dozen in-flight events
_CHUNK = 64
_DEFAULT_RING = 65536

_ENABLED = False
_CTX_ENABLED = True  # COMETBFT_TPU_TRACE_CTX — span-context propagation
_EXPORT_PATH: str | None = None

_ring_mtx = threading.Lock()
_ring: list = []  # bounded manually (deque has no atomic bulk-swap)
_ring_cap = _DEFAULT_RING
_dropped = 0

_bufs_mtx = threading.Lock()
_bufs: list = []  # [(weakref-to-thread, buf list, tid), ...]
_thread_names: dict[int, str] = {}
# registration-time pruning threshold: beyond this many registered
# buffers, dead threads' buffers are flushed and dropped so per-peer
# thread churn can't grow _bufs/_thread_names for the process lifetime
_PRUNE_AT = 256

_tls = threading.local()


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool, ring_capacity: int | None = None) -> None:
    """Runtime switch (tests, the trace script, bench).  Turning tracing
    on never clears previously collected events; call reset() for a
    clean capture window."""
    global _ENABLED, _ring_cap
    if ring_capacity is not None:
        with _ring_mtx:
            _ring_cap = max(1, int(ring_capacity))
            del _ring[: max(0, len(_ring) - _ring_cap)]
    _ENABLED = bool(on)


def reset() -> None:
    """Drop every buffered event (thread-local and ring)."""
    global _dropped
    with _bufs_mtx:
        entries = list(_bufs)
    for _tref, buf, _tid in entries:
        del buf[:]
    with _ring_mtx:
        del _ring[:]
        _dropped = 0


def dropped_count() -> int:
    """Events evicted from the ring since the last reset()."""
    return _dropped


# ----------------------------------------------------------- span context


class SpanContext:
    """Propagable identity of one distributed trace: a 16-byte trace_id
    shared by every span of the trace (across processes) and an 8-byte
    span_id naming this hop.  Shaped after the W3C traceparent header
    (version 00, sampled flag always 01) so the wire form is a plain
    printable string any tracing stack recognizes."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def child(self) -> "SpanContext":
        """Same trace, fresh hop id — what a server installs so its
        spans link to the client's without claiming its span_id."""
        return SpanContext(self.trace_id, os.urandom(8).hex())

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header: str) -> "SpanContext | None":
        """Parse a traceparent string; None on anything malformed — a
        bad context from a peer must degrade to 'unlinked', never raise
        into the request path."""
        parts = header.split("-")
        if len(parts) != 4:
            return None
        _ver, tid, sid, _flags = parts
        if len(tid) != 32 or len(sid) != 16:
            return None
        try:
            int(tid, 16)
            int(sid, 16)
        except ValueError:
            return None
        if tid == "0" * 32 or sid == "0" * 16:
            return None
        return cls(tid, sid)

    def __eq__(self, other):
        return (
            isinstance(other, SpanContext)
            and self.trace_id == other.trace_id
            and self.span_id == other.span_id
        )

    def __repr__(self):
        return f"SpanContext({self.to_traceparent()!r})"


def new_context() -> SpanContext:
    """A fresh root context (random trace_id + span_id)."""
    return SpanContext(os.urandom(16).hex(), os.urandom(8).hex())


def current_context() -> SpanContext | None:
    """The calling thread's installed context, if any."""
    return getattr(_tls, "ctx", None)


class _CtxScope:
    __slots__ = ("_ctx", "_prev", "_installed")

    def __init__(self, ctx):
        self._ctx = ctx
        self._installed = ctx is not None

    def __enter__(self):
        if self._installed:
            self._prev = getattr(_tls, "ctx", None)
            _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> bool:
        if self._installed:
            _tls.ctx = self._prev
        return False


def context_scope(ctx: SpanContext | None):
    """Install ``ctx`` as the thread's current context for the block:
    every span/instant recorded inside carries its trace_id/span_id
    args.  ``None`` leaves the current context untouched (so call sites
    can pass an optional context unconditionally)."""
    return _CtxScope(ctx if propagation_enabled() else None)


def propagation_enabled() -> bool:
    return _ENABLED and _CTX_ENABLED


# ------------------------------------------------------------- recording


_tid_counter = 0


def _buf() -> list:
    b = getattr(_tls, "buf", None)
    if b is None:
        global _tid_counter
        b = _tls.buf = []
        t = threading.current_thread()
        with _bufs_mtx:
            if len(_bufs) >= _PRUNE_AT:
                _prune_dead_locked()
            # synthetic per-thread track id: OS thread idents are recycled
            # after thread exit, which would merge a dead thread's events
            # onto a new thread's track in the export
            _tid_counter += 1
            _tls.tid = _tid_counter
            _bufs.append((weakref.ref(t), b, _tls.tid))
            _thread_names[_tls.tid] = t.name
    return b


def _prune_dead_locked() -> None:
    """Flush and drop buffers (and name entries) of exited threads —
    caller holds _bufs_mtx.  Ring events from pruned threads keep their
    synthetic tid; only the name label for the track is lost."""
    keep = []
    for tref, b, tid in _bufs:
        if tref() is not None:
            keep.append((tref, b, tid))
        else:
            if b:
                _flush(b)
            _thread_names.pop(tid, None)
    _bufs[:] = keep


def _flush(b: list) -> None:
    """Move a buffer's events into the bounded ring.  The copy+delete and
    the ring extend happen under ONE lock: the owner thread's chunk flush
    and an exporter's drain may race on the same buffer, and an unlocked
    copy would insert the same chunk twice."""
    global _dropped
    with _ring_mtx:
        items = b[:]
        del b[: len(items)]
        _ring.extend(items)
        overflow = len(_ring) - _ring_cap
        if overflow > 0:
            del _ring[:overflow]
            _dropped += overflow


def _emit(ph: str, name: str, ts_ns: int, dur_ns: int, labels) -> None:
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        # events recorded under a context scope carry the trace identity
        # as args: the link between the threads that served one request
        merged = dict(labels) if labels else {}
        merged.setdefault("trace_id", ctx.trace_id)
        merged.setdefault("span_id", ctx.span_id)
        labels = merged
    b = _buf()
    b.append((ph, name, ts_ns, dur_ns, _tls.tid, labels))
    if len(b) >= _CHUNK:
        _flush(b)


class _Span:
    """One 'X' (complete) trace event, recorded at __exit__."""

    __slots__ = ("_name", "_labels", "_t0")

    def __init__(self, name: str, labels: dict | None):
        self._name = name
        self._labels = labels

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t0 = self._t0
        _emit("X", self._name, t0, time.perf_counter_ns() - t0, self._labels)
        return False


class _NopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOP = _NopSpan()


def span(name: str, labels: dict | None = None):
    """Context manager timing one pipeline phase.  Disabled: returns a
    shared no-op — the call site pays one bool check and no allocation
    (pass labels as a prebuilt dict, not kwargs, to keep that true)."""
    if not _ENABLED:
        return _NOP
    return _Span(name, labels)


def instant(name: str, labels: dict | None = None) -> None:
    """A zero-duration marker (step transitions, timeout fires)."""
    if not _ENABLED:
        return
    _emit("i", name, time.perf_counter_ns(), 0, labels)


# --------------------------------------------------------------- export


def _drain_all() -> tuple[list, dict]:
    """Flush every thread buffer into the ring, prune buffers AND name
    entries of dead threads, and return (ring snapshot, thread-name
    snapshot).  The name snapshot is taken before the prune, so the
    export in progress still labels just-exited threads' tracks; later
    exports show their remaining ring events on an unnamed track — the
    cosmetic price of keeping _thread_names bounded under thread churn.
    The ring itself is not cleared: repeat exports see a superset."""
    with _bufs_mtx:
        entries = list(_bufs)
        names = dict(_thread_names)
        live = [(tr, b, tid) for tr, b, tid in entries if tr() is not None]
        for tr, _b, tid in entries:
            if tr() is None:
                _thread_names.pop(tid, None)
        _bufs[:] = live
    for _tref, buf, _tid in entries:
        if buf:
            _flush(buf)
    with _ring_mtx:
        return list(_ring), names


def chrome_trace_events() -> list[dict]:
    """The buffered events as Chrome trace-event dicts (plus thread-name
    metadata records), timestamp-sorted."""
    events, names = _drain_all()
    pid = os.getpid()
    # Wall-clock anchor: every event timestamp in this export is pure
    # perf_counter_ns, while flight-recorder entries and log lines carry
    # wall-clock time — one (wall_ns, perf_ns) pair sampled at export
    # time lets a consumer line all three up on one timeline:
    #   wall_ns(event) = wall_time_ns + (event.ts * 1000 - perf_counter_ns)
    wall_anchor_ns = time.time_ns()
    perf_anchor_ns = time.perf_counter_ns()
    out: list[dict] = [
        {
            "ph": "M",
            "name": "wall_clock_anchor",
            "pid": pid,
            "tid": 0,
            "args": {
                "wall_time_ns": wall_anchor_ns,
                "perf_counter_ns": perf_anchor_ns,
            },
        }
    ]
    out += [
        {
            "ph": "M",
            "name": "thread_name",
            "pid": pid,
            "tid": tid,
            "args": {"name": tname},
        }
        for tid, tname in sorted(names.items())
    ]
    for ph, name, ts_ns, dur_ns, tid, labels in sorted(
        events, key=lambda e: e[2]
    ):
        e = {
            "ph": ph,
            "name": name,
            "cat": "cometbft",
            "pid": pid,
            "tid": tid,
            "ts": ts_ns / 1e3,  # trace-event timestamps are microseconds
        }
        if ph == "X":
            e["dur"] = dur_ns / 1e3
        elif ph == "i":
            e["s"] = "t"  # thread-scoped instant
        if labels:
            e["args"] = {k: _jsonable(v) for k, v in labels.items()}
        out.append(e)
    return out


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


def export_chrome_trace(path: str) -> int:
    """Write {"traceEvents": [...]} JSON; returns the number of span /
    instant events written (metadata records excluded)."""
    events = chrome_trace_events()
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return sum(1 for e in events if e["ph"] != "M")


# --------------------------------------------------- env-var resolution

def _atexit_export() -> None:
    try:
        export_chrome_trace(_EXPORT_PATH)
    except Exception:  # noqa: BLE001 — never traceback on interpreter exit
        pass


_v = envknobs.get_str(envknobs.TRACE)
if _v.lower() not in _OFF_VALUES:
    _ENABLED = True
    if _v.lower() not in _ON_VALUES and (os.sep in _v or _v.endswith(".json")):
        # unambiguously a path: auto-export the ring at process exit.
        # Other truthy values ("2", "debug", ...) just enable recording —
        # they must not turn into a stray file named after themselves.
        _EXPORT_PATH = _v
        import atexit

        atexit.register(_atexit_export)
_ring_cap = max(1, envknobs.get_int(envknobs.TRACE_RING))
_CTX_ENABLED = envknobs.get_bool(envknobs.TRACE_CTX)
del _v
