"""Metrics registry and Prometheus text exposition (the port of
cometbft_tpu/utils/metrics.py).

``Counter``, ``Gauge``, ``Histogram``, ``LabelGuard`` and ``Registry``
are the JAX module's, line for line.  :class:`Hub` keeps only the series
whose observers the port has, under the JAX names, HELP texts, label
sets and bucket bounds: the verify plane (comb staging, slab pool,
batch width, table and pubkey caches, phase latencies), the verify
service's scheduler, tenancy, collect timeouts and failover, proof
serving, the health sentinel and the block and state stores' access
latency.  Left out until their modules are ported: the consensus,
mempool, p2p and remote-plane series and ``NodeMetrics``.  The hub is plain Python: it imports neither torch nor
anything of the JAX package.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

from .. import envknobs

_DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
)


class _Metric:
    def __init__(self, name: str, help_: str, registry: "Registry"):
        self.name = name
        self.help = help_
        self._mtx = threading.Lock()
        if registry is not None:
            registry._register(self)

    @staticmethod
    def _label_key(labels: dict | None) -> tuple:
        return tuple(sorted((labels or {}).items()))

    @staticmethod
    def _esc_label(v) -> str:
        """Label-value escaping per the Prometheus text format: backslash,
        double-quote, and line feed must be escaped or the exposition is
        unparseable (backslash FIRST, or the other escapes double up)."""
        return (
            str(v)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )

    @classmethod
    def _fmt_labels(cls, key: tuple) -> str:
        if not key:
            return ""
        inner = ",".join(f'{k}="{cls._esc_label(v)}"' for k, v in key)
        return "{" + inner + "}"


class Counter(_Metric):
    TYPE = "counter"

    def __init__(self, name, help_="", registry=None):
        super().__init__(name, help_, registry)
        self._values: dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        k = self._label_key(labels)
        with self._mtx:
            self._values[k] = self._values.get(k, 0.0) + n

    def value(self, **labels) -> float:
        with self._mtx:
            return self._values.get(self._label_key(labels), 0.0)

    def expose(self) -> list[str]:
        with self._mtx:
            items = sorted(self._values.items())
        return [
            f"{self.name}{self._fmt_labels(k)} {v}"
            for k, v in (items or [((), 0.0)])
        ]


class Gauge(_Metric):
    TYPE = "gauge"

    def __init__(self, name, help_="", registry=None):
        super().__init__(name, help_, registry)
        self._values: dict[tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        with self._mtx:
            self._values[self._label_key(labels)] = float(v)

    def add(self, n: float, **labels) -> None:
        k = self._label_key(labels)
        with self._mtx:
            self._values[k] = self._values.get(k, 0.0) + n

    def value(self, **labels) -> float:
        with self._mtx:
            return self._values.get(self._label_key(labels), 0.0)

    def remove(self, **labels) -> None:
        """Drop one labeled series (e.g. a retired loop's beat-age): a
        gauge for an entity that no longer exists must leave the
        exposition, not freeze at its last value forever."""
        with self._mtx:
            self._values.pop(self._label_key(labels), None)

    def expose(self) -> list[str]:
        with self._mtx:
            items = sorted(self._values.items())
        return [
            f"{self.name}{self._fmt_labels(k)} {v}"
            for k, v in (items or [((), 0.0)])
        ]


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(self, name, help_="", buckets=_DEFAULT_BUCKETS, registry=None):
        super().__init__(name, help_, registry)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, v: float, **labels) -> None:
        k = self._label_key(labels)
        with self._mtx:
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            # per-bucket increments; the cumulative form is produced at
            # expose time.  bisect_left = first bucket bound >= v; values
            # above every bound only count toward +Inf/sum/count.
            idx = bisect_left(self.buckets, v)
            if idx < len(self.buckets):
                counts[idx] += 1
            self._sums[k] = self._sums.get(k, 0.0) + v
            self._totals[k] = self._totals.get(k, 0) + 1

    def expose(self) -> list[str]:
        out = []
        with self._mtx:
            keys = sorted(self._counts) or [()]
            for k in keys:
                counts = self._counts.get(k, [0] * len(self.buckets))
                cum = 0
                for b, c in zip(self.buckets, counts):
                    cum += c
                    lk = k + (("le", str(b)),)
                    out.append(f"{self.name}_bucket{self._fmt_labels(lk)} {cum}")
                lk = k + (("le", "+Inf"),)
                out.append(
                    f"{self.name}_bucket{self._fmt_labels(lk)} "
                    f"{self._totals.get(k, 0)}"
                )
                out.append(
                    f"{self.name}_sum{self._fmt_labels(k)} {self._sums.get(k, 0.0)}"
                )
                out.append(
                    f"{self.name}_count{self._fmt_labels(k)} {self._totals.get(k, 0)}"
                )
        return out


class LabelGuard:
    """Bounded admission of label VALUES for one label dimension.

    Prometheus label values are unbounded series: a metric labeled by a
    caller-supplied id (the verify service's tenant) would let an
    unbounded id stream allocate one series per id and blow up the
    exposition.  The guard admits the first ``max_values`` distinct
    values verbatim and maps everything after onto the single
    ``__overflow__`` bucket, so the series count is capped no matter
    what ids arrive.  Admission is first-come sticky: a value once
    admitted keeps its own series for the life of the process.
    """

    OVERFLOW = "__overflow__"

    def __init__(self, max_values: int = 32):
        self.max_values = max(1, int(max_values))
        self._seen: set[str] = set()
        self._mtx = threading.Lock()
        self._overflowed = 0

    def bound(self, value) -> str:
        v = str(value)
        with self._mtx:
            if v in self._seen:
                return v
            if len(self._seen) < self.max_values:
                self._seen.add(v)
                return v
            self._overflowed += 1
            return self.OVERFLOW

    def overflowed(self) -> int:
        with self._mtx:
            return self._overflowed

    def admitted(self) -> int:
        with self._mtx:
            return len(self._seen)


class Registry:
    def __init__(self, namespace: str = "cometbft"):
        self.namespace = namespace
        self._metrics: list[_Metric] = []
        self._by_name: dict[str, _Metric] = {}
        self._mtx = threading.Lock()

    def _register(self, m: _Metric) -> None:
        """Direct registration (Metric(..., registry=r)): a duplicate name
        is a programming error — two instances exposing the same series
        with conflicting values produce an unscrapable /metrics."""
        with self._mtx:
            if m.name in self._by_name:
                raise ValueError(f"metric {m.name!r} already registered")
            self._by_name[m.name] = m
            self._metrics.append(m)

    def _get_or_make(self, full_name: str, cls, help_: str, **kw) -> _Metric:
        """The factory helpers are get-or-create: re-declaring a metric
        (e.g. two subsystems sharing one registry, or a re-constructed
        metric set on a shared hub) returns the ONE existing instance so
        the exposition never carries the name twice.  A re-declaration
        under a different metric type is a conflict and raises."""
        with self._mtx:
            existing = self._by_name.get(full_name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {full_name!r} already registered as "
                        f"{type(existing).__name__}, not {cls.__name__}"
                    )
                if "buckets" in kw and existing.buckets != tuple(
                    sorted(kw["buckets"])
                ):
                    # silently keeping the first declaration's bounds would
                    # bin the second caller's observations wrongly
                    raise ValueError(
                        f"histogram {full_name!r} re-declared with different "
                        f"buckets: {existing.buckets} vs {kw['buckets']}"
                    )
                return existing
            m = cls(full_name, help_, registry=None, **kw)
            self._by_name[full_name] = m
            self._metrics.append(m)
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(f"{self.namespace}_{name}", Counter, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(f"{self.namespace}_{name}", Gauge, help_)

    def histogram(self, name: str, help_: str = "", buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(
            f"{self.namespace}_{name}", Histogram, help_, buckets=buckets
        )

    def expose_text(self) -> str:
        """Prometheus text format v0.0.4."""
        lines = []
        with self._mtx:
            metrics = list(self._metrics)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.TYPE}")
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


class Hub:
    """The process-global metric set of the port's subsystems (the JAX
    ``Hub``'s series that have an observer here).  Call sites observe
    these directly; ``registry.expose_text()`` is the Prometheus text."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        # ---- stores (store/metrics.go BlockStore access durations)
        self.store_access_seconds = r.histogram(
            "store_block_store_access_duration_seconds",
            "Block/state store op latency (label method)",
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0),
        )
        self.verify_submit_queue_depth = r.gauge(
            "verify_submit_queue_depth",
            "VerifyCommit submissions queued or staging on the comb "
            "staging thread",
        )
        self.verify_slab_requests = r.counter(
            "verify_slab_requests_total",
            "Staging-slab acquisitions (label result=hit|miss; hit = "
            "recycled from the per-entry pool, no allocation)",
        )
        self.verify_batch_width = r.histogram(
            "verify_batch_width_sigs",
            "Signatures per batch-verifier submission",
            buckets=(1, 4, 16, 64, 256, 1024, 4096, 16384),
        )
        self.verify_staging_busy = r.counter(
            "verify_staging_busy_seconds_total",
            "Cumulative busy time of the comb staging thread (ratio to "
            "wall clock = staging-thread occupancy)",
        )
        self.comb_table_cache = r.counter(
            "verify_comb_table_cache_total",
            "Valset comb-table cache lookups (label result=hit|miss|"
            "building; building = async build in flight, batch routed "
            "to the uncached kernel)",
        )
        self.secp_pubkey_cache = r.counter(
            "verify_svc_secp_pubkey_cache_total",
            "Decoded-secp256k1-pubkey cache lookups in the MODE_SECP "
            "lane (label result=hit|miss); CheckTx ingest repeats "
            "senders, so the firehose soak asserts the hit rate from "
            "this counter instead of inferring it",
        )
        self.verify_svc_queue_depth = r.gauge(
            "verify_svc_queue_depth",
            "Signatures (or proof queries) queued per verify-service "
            "priority class (label class=consensus|blocksync|mempool|"
            "background|proof)",
        )
        self.verify_svc_flush = r.counter(
            "verify_svc_flush_total",
            "Verify-service batch flushes (labels class, reason=full|"
            "deadline: full = batch width reached, deadline = class "
            "flush deadline expired first)",
        )
        self.verify_svc_rejected = r.counter(
            "verify_svc_rejected_total",
            "Verify-service submissions rejected with backpressure "
            "(label class); callers fall back to host verification",
        )
        self.verify_svc_queue_wait = r.histogram(
            "verify_svc_queue_wait_seconds",
            "Time a request spent queued in the verify service before "
            "dispatch (label class) — consensus should pin the lowest "
            "buckets regardless of mempool load",
            buckets=(
                0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                0.1, 0.5,
            ),
        )
        self.tenant_labels = LabelGuard(
            envknobs.get_int(envknobs.VERIFYSVC_TENANT_LABEL_MAX)
        )
        self.verify_svc_tenant_queue_depth = r.gauge(
            "verify_svc_tenant_queue_depth",
            "Signatures queued per (tenant, class) in the verify "
            "service (labels tenant, class; tenant set bounded by "
            "COMETBFT_TPU_VERIFYSVC_TENANT_LABEL_MAX, overflow bucket "
            "__overflow__)",
        )
        self.verify_svc_tenant_dispatched = r.counter(
            "verify_svc_tenant_dispatched_total",
            "Verify-service batches dispatched per (tenant, class) "
            "(labels tenant, class)",
        )
        self.verify_svc_tenant_rejected = r.counter(
            "verify_svc_tenant_rejected_total",
            "Verify-service submissions rejected with backpressure per "
            "(tenant, class) (labels tenant, class, scope=tenant|class: "
            "which bound was hit)",
        )
        self.verify_svc_collect_timeout = r.counter(
            "verify_svc_collect_timeout_total",
            "Client-side Ticket.collect() deadlines that expired "
            "(label class); the client host-verified its batch inline "
            "and left stall forensics",
        )
        self.verify_svc_backend_mode = r.gauge(
            "verify_svc_backend_mode",
            "Verify-service backend mode (0=tpu, 1=cpu_fallback); flips "
            "on every failover trip/restore",
        )
        self.verify_svc_failover = r.counter(
            "verify_svc_failover_total",
            "Verify-service failover transitions (label direction="
            "to_cpu|to_tpu)",
        )
        self.verify_svc_host_reverify = r.counter(
            "verify_svc_host_reverify_total",
            "Batches re-verified on the host path by the failover plane "
            "(label cause=wedge|dispatch_error|submit_error|"
            "collect_error)",
        )
        self.verify_proof_queries = r.counter(
            "verify_proof_queries_total",
            "Merkle proof queries answered by the PROOF serving class "
            "(label route=device|host|remote: which data plane produced "
            "the proofs — all routes bit-identical to "
            "crypto/merkle.proofs_from_byte_slices by construction)",
        )
        self.verify_proof_tree_cache = r.counter(
            "verify_proof_tree_cache_total",
            "Proof-server tree-cache lookups by digest (label "
            "result=hit|miss); a miss yields a typed None row for the "
            "query, never a wrong proof",
        )
        self.health_state = r.gauge(
            "health_state",
            "Node health state from the sentinel "
            "(0=ok, 1=degraded, 2=wedged)",
        )
        self.health_probe_seconds = r.histogram(
            "health_probe_seconds",
            "Accelerator probe latency (subprocess jax.devices(); a "
            "hang is clamped at the probe deadline)",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                     120.0, 240.0),
        )
        self.health_probe_total = r.counter(
            "health_probe_total",
            "Sentinel probe attempts (label result=ok|fail|hang)",
        )
        self.health_probe_consec_failures = r.gauge(
            "health_consecutive_probe_failures",
            "Consecutive failed sentinel probes (resets on success)",
        )
        self.health_beat_age = r.gauge(
            "health_beat_age_seconds",
            "Age of each registered loop's last heartbeat (label loop)",
        )
        self.health_transitions = r.counter(
            "health_transitions_total",
            "Health state transitions (label state = the state entered)",
        )
        self.health_forensics = r.counter(
            "health_forensics_artifacts_total",
            "Stall-forensics artifacts written by the sentinel",
        )
        self.verify_phase_seconds = r.histogram(
            "verify_phase_seconds",
            "Per-phase VerifyCommit pipeline latency (label phase="
            "assembly|h2d_dispatch|staging_wait|device_wait; first call "
            "at a new shape carries the XLA compile in h2d_dispatch)",
            buckets=(
                0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5,
            ),
        )


_HUB: Hub | None = None
_HUB_MTX = threading.Lock()


def hub() -> Hub:
    global _HUB
    if _HUB is None:
        with _HUB_MTX:
            if _HUB is None:
                _HUB = Hub()
    return _HUB
