"""The verify service: one priority-scheduled seam in front of the port's
verifiers (the port of cometbft_tpu/verifysvc/service.py).

Every signature check of the port — consensus VerifyCommit, the light
client, CheckTx and proof serving — submits here instead of driving a
verifier of models/ itself.  The service owns:

  * **Priority classes** (consensus > blocksync > mempool > background >
    proof): a strict-priority scheduler dispatches ready consensus
    batches before anything else, so a mempool flood cannot delay a
    commit verification behind it.  ``COMETBFT_TPU_VERIFYSVC_WEIGHTS``
    trades strictness for a weighted interleave of ready classes.
  * **Batch formation**: a class's queue flushes when its pending
    signatures reach ``COMETBFT_TPU_VERIFYSVC_BATCH_MAX`` (reason
    ``full``) or its oldest request has waited the class's deadline
    (``COMETBFT_TPU_VERIFYSVC_DEADLINE_<CLASS>_MS``, reason
    ``deadline``).  Consensus's deadline is 0; mempool's 5 ms is the
    window that merges single-tx CheckTx calls from concurrent senders
    into one launch of the secp kernels.
  * **Admission**: a class holds at most
    ``COMETBFT_TPU_VERIFYSVC_QUEUE_MAX`` queued signatures (PROOF its
    own ``COMETBFT_TPU_PROOF_QUEUE_MAX``), and a (tenant, class) at most
    ``COMETBFT_TPU_VERIFYSVC_TENANT_QUOTA`` outstanding ones (queued and
    in flight, released when the ticket settles).  A submit beyond
    either raises :class:`VerifyServiceBackpressure` (``scope`` names
    the bound), counted in :meth:`VerifyService.stats`; the caller then
    verifies on the host.  That is the only host path of the service.

Requests carry a tenant (``COMETBFT_TPU_VERIFYSVC_TENANT``, default
``default``).  Within a class, ready tenants interleave weighted-fair
(``COMETBFT_TPU_VERIFYSVC_TENANT_WEIGHTS``, round robin from the last
tenant served); batches never mix tenants or modes.  Coalescible modes
(plain ed25519, secp, proof) merge requests of one mode; comb and BLS
requests dispatch alone.  Each ticket's verdicts follow its own add()
order however its batch was merged.

Threads (daemons, started on the first submit; :meth:`stop` ends them
and fails every ticket still waiting): the scheduler forms batches and
binds each to a verifier on the service's device; a host worker takes
the batches whose submit() does real work in class order from a
priority queue; a collector waits for their completion events and
settles the tickets.  Which submits leave the scheduler is the JAX
service's rule (``_submit_is_offloaded``): a comb batch that was not
demoted submits on the scheduler, since its submit() only hands the
batch to the comb path's staging thread (models/comb_verifier.py), and
every other batch (uncached, demoted comb, secp, BLS, proof) goes to the
host worker, where a queued consensus batch overtakes lower classes.
The JAX rule's third arm, a comb batch below its host-route width, has
no counterpart: the port sends every batch to the card (ROADMAP C).  A
dispatch, submit or collect error fails the batch's tickets with that
error; nothing is verified again on the host.

A request takes its place in the comb route's collective order here, in
the submitter's thread (models/comb_verifier.reserve_stage: a token
under a mesh, else None), so its collectives keep the submitter's call
order beside the readiness agreements of verifysvc/client.resolve_mode.
A demoted batch gives its place back at dispatch, and a request that
settles without a stage when it settles.

Spans (utils/tracing.py, the JAX names): ``verify.sched.dispatch`` around
a batch's binding (and a comb batch's submit), ``verify.sched.hostwork``
around a host-worker submit, ``verify.sched.collect`` around the wait
and the settle, and the instant ``verify.sched.reject`` on a refusal;
each under the submitter's span context.  Left out of the port so far
(ROADMAP A): the failover watchdog and its host re-verification, the
remote plane, the metrics and the flight recorder.
"""

from __future__ import annotations

import functools
import itertools
import queue
import threading
import time
from enum import IntEnum

import torch

from .. import envknobs
from .._device import resolve_device
from ..models.comb_verifier import release_stage, reserve_stage
from ..utils import tracing


class Klass(IntEnum):
    """Priority classes, highest first (lower value = dispatched first)."""

    CONSENSUS = 0
    BLOCKSYNC = 1
    MEMPOOL = 2
    BACKGROUND = 3
    # read-only proof serving: lowest, so however wide its backlog grows
    # it never delays a signature class
    PROOF = 4

    @property
    def label(self) -> str:
        return self.name.lower()


_DEADLINE_KNOBS = {
    Klass.CONSENSUS: envknobs.VERIFYSVC_DEADLINE_CONSENSUS_MS,
    Klass.BLOCKSYNC: envknobs.VERIFYSVC_DEADLINE_BLOCKSYNC_MS,
    Klass.MEMPOOL: envknobs.VERIFYSVC_DEADLINE_MEMPOOL_MS,
    Klass.BACKGROUND: envknobs.VERIFYSVC_DEADLINE_BACKGROUND_MS,
    Klass.PROOF: envknobs.PROOF_DEADLINE_MS,
}

# Request modes: how the dispatcher binds a batch to a verifier.
#   ("plain",)      Ed25519BatchVerifier (K2 -> K5); coalescible
#   ("comb", entry) CombBatchVerifier on a cached set's tables (K1 -> K2
#                   -> K4); solo: the payload holds one row a validator
#   ("bls",)        BlsAggregateVerifier (K13-K15, host pairings); solo:
#                   a batch is one aggregate claim
#   ("secp",)       SecpBatchVerifier (K12, or K10 -> K11); coalescible
#   ("proof",)      ProofProver (K7 -> K8 -> K9); items are proof queries
#                   (models/proof_server.encode_query), rows are Proofs
MODE_PLAIN = ("plain",)
MODE_BLS = ("bls",)
MODE_SECP = ("secp",)
MODE_PROOF = ("proof",)

# modes whose requests may merge into one batch (same mode only)
_COALESCIBLE_MODES = frozenset({"plain", "secp", "proof"})

_MODE_KEY_TYPE = {
    "plain": "ed25519",
    "comb": "ed25519",
    "bls": "bls12_381",
    "secp": "secp256k1",
    "proof": "proof",  # a label only: no key type maps to it
}
_KEY_TYPE_MODE = {
    "": MODE_PLAIN,
    "ed25519": MODE_PLAIN,
    "bls12_381": MODE_BLS,
    # the three secp wire shapes share one lane; rows are told apart by
    # their pubkey length
    "secp256k1": MODE_SECP,
    "secp256k1eth": MODE_SECP,
    "ecrecover": MODE_SECP,
}


def mode_key_type(mode) -> str:
    return _MODE_KEY_TYPE.get(mode[0], "ed25519")


def mode_for_key_type(key_type: str):
    """Key type -> dispatch mode, or None for an unknown type."""
    return _KEY_TYPE_MODE.get(key_type)


# host-queue shutdown sentinel: sorts after every real class
_HOST_SENTINEL_PRIO = 1 << 30

DEFAULT_TENANT = "default"
# stats() tallies the first _TENANT_TALLY_MAX tenants apart and the rest
# under one key (the JAX package's default label bound)
_TENANT_TALLY_MAX = 32
_OVERFLOW_TENANT = "__overflow__"


def default_tenant() -> str:
    """The tenant this process submits under
    (COMETBFT_TPU_VERIFYSVC_TENANT); empty or unset is ``default``."""
    t = envknobs.get_str(envknobs.VERIFYSVC_TENANT).strip()
    return t or DEFAULT_TENANT


def collect_timeout_s() -> float | None:
    """A client's Ticket.collect() deadline
    (COMETBFT_TPU_VERIFYSVC_COLLECT_TIMEOUT_MS); None waits forever."""
    ms = envknobs.get_int(envknobs.VERIFYSVC_COLLECT_TIMEOUT_MS)
    return None if ms <= 0 else ms / 1e3


class VerifyServiceBackpressure(Exception):
    """A signature bound was hit; the caller verifies on the host (or
    sheds the request).  ``scope`` says which bound: ``tenant`` (this
    tenant's per-class quota on outstanding signatures; other tenants
    are still admitted) or ``class`` (the class-wide queue bound)."""

    def __init__(
        self,
        klass: Klass,
        queued: int,
        limit: int,
        tenant: str = DEFAULT_TENANT,
        scope: str = "class",
    ):
        super().__init__(
            f"verify service backpressure: {scope} bound, class "
            f"{klass.label} tenant {tenant} has {queued} signatures "
            f"outstanding (limit {limit})"
        )
        self.klass = klass
        self.queued = queued
        self.limit = limit
        self.tenant = tenant
        self.scope = scope


class Ticket:
    """Handle for one submitted request; collect() blocks for
    (all_ok, per_signature) in the request's own add() order, or raises
    whatever the dispatch, submit or collect raised."""

    __slots__ = ("_ev", "_mtx", "_result", "_exc", "timings", "_on_settle")

    def __init__(self):
        self._ev = threading.Event()
        self._mtx = threading.Lock()
        self._result: tuple[bool, list[bool]] | None = None
        self._exc: BaseException | None = None
        self.timings: dict[str, float] = {}
        # fired once, on whichever resolution wins: the service's
        # outstanding-quota release
        self._on_settle = None

    def _settled(self) -> None:
        cb, self._on_settle = self._on_settle, None
        if cb is not None:
            cb()

    def _resolve(self, result, timings=None) -> bool:
        """The first resolution wins; a later one is discarded."""
        with self._mtx:
            if self._ev.is_set():
                return False
            self._result = result
            if timings:
                self.timings = dict(timings)
            self._ev.set()
        self._settled()
        return True

    def _fail(self, exc: BaseException) -> bool:
        with self._mtx:
            if self._ev.is_set():
                return False
            self._exc = exc
            self._ev.set()
        self._settled()
        return True

    def collect(self, timeout: float | None = None) -> tuple[bool, list[bool]]:
        if not self._ev.wait(timeout):
            raise TimeoutError("verify service ticket not resolved in time")
        if self._exc is not None:
            raise self._exc
        return self._result


class _Request:
    __slots__ = ("items", "klass", "mode", "ticket", "enq", "tenant", "dispatched", "ctx", "stage")

    def __init__(self, items, klass: Klass, mode, tenant: str = DEFAULT_TENANT):
        self.items = items
        self.klass = klass
        self.mode = mode
        self.tenant = tenant
        self.ticket = Ticket()
        self.enq = time.monotonic()
        self.dispatched = None  # set when its batch leaves the queue
        # the submitter's span context: the service's threads install it
        # around their spans, so every hop of the request shares its
        # trace_id
        self.ctx = tracing.current_context() if tracing.propagation_enabled() else None
        self.stage = reserve_stage(mode)  # a place in the comb route's collective order, or None


def _batch_ctx(batch: list[_Request]):
    """The span context a batch's spans run under: its first member's
    that has one (a merged batch's members joined one dispatch)."""
    for r in batch:
        if r.ctx is not None:
            return r.ctx
    return None


def _parse_weights(spec: str) -> dict[Klass, int]:
    """``"consensus=8,blocksync=4,mempool=2,background=1"`` -> weights.
    Malformed entries and weights below 1 are dropped; an empty result
    is strict priority."""
    out: dict[Klass, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            k = Klass[name.strip().upper()]
            w = int(val)
        except (KeyError, ValueError):
            continue
        if w >= 1:
            out[k] = w
    return out


def _parse_tenant_weights(spec: str) -> dict[str, int]:
    """``"chain-a=4,chain-b=1"`` -> per-tenant weights (unlisted tenants
    weigh 1); the same forgiving parse as the class weights."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        try:
            w = int(val)
        except ValueError:
            continue
        if name and w >= 1:
            out[name] = w
    return out


def cpu_verifier_for_mode(mode):
    """The mode's host verifier (CpuEd25519BatchVerifier for the ed25519
    modes, CpuBlsBatchVerifier, CpuSecpBatchVerifier, CpuProofProver):
    the one selection point of every host path."""
    if mode[0] == "bls":
        from ..models.bls_verifier import CpuBlsBatchVerifier

        return CpuBlsBatchVerifier()
    if mode[0] == "secp":
        from ..models.secp_verifier import CpuSecpBatchVerifier

        return CpuSecpBatchVerifier()
    if mode[0] == "proof":
        from ..models.proof_server import CpuProofProver

        return CpuProofProver()
    from ..models.verifier import CpuEd25519BatchVerifier

    return CpuEd25519BatchVerifier()


def _host_verify_items(items, mode=MODE_PLAIN) -> tuple[bool, list[bool]]:
    """The host verdict of ``items`` in ``mode``, without add()'s shape
    checks (a malformed row judges False)."""
    cpu = cpu_verifier_for_mode(mode)
    cpu._items = list(items)
    return cpu.verify()


def _pinned(device) -> torch.device:
    """``device`` resolved, with a bare "cuda" pinned to the calling
    thread's current card: the service's threads start on card 0, so the
    caller's meaning of "cuda" is fixed here, in the caller's thread."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class VerifyService:
    """Priority-scheduled batching front of the port's verifiers on
    ``device`` ("cuda" by default; "cpu" runs the kernels' plain
    versions).

    Construction reads the ``COMETBFT_TPU_VERIFYSVC_*`` knobs once;
    explicit arguments override them (tests).  Threads start on the
    first submit and are daemons; :meth:`stop` ends them and fails the
    tickets still waiting.
    """

    def __init__(
        self,
        batch_max: int | None = None,
        queue_max: int | None = None,
        deadlines_ms: dict[Klass, float] | None = None,
        weights: dict[Klass, int] | None = None,
        tenant_quota: int | None = None,
        tenant_weights: dict[str, int] | None = None,
        *,
        device="cuda",
    ):
        self.device = _pinned(device)
        self.batch_max = max(
            1, batch_max if batch_max is not None else envknobs.get_int(envknobs.VERIFYSVC_BATCH_MAX)
        )
        self.queue_max = max(
            1, queue_max if queue_max is not None else envknobs.get_int(envknobs.VERIFYSVC_QUEUE_MAX)
        )
        # PROOF's own queue bound, so a light-client fan-out backlog
        # neither takes nor is taken from the signature classes' room
        pq = envknobs.get_int(envknobs.PROOF_QUEUE_MAX)
        self._proof_queue_max = pq if pq and pq > 0 else self.queue_max
        if deadlines_ms is None:
            deadlines_ms = {k: max(0, envknobs.get_int(knob)) for k, knob in _DEADLINE_KNOBS.items()}
        self._deadline_s = {k: float(deadlines_ms.get(k, 0)) / 1e3 for k in Klass}
        self._weights = (
            dict(weights) if weights is not None
            else _parse_weights(envknobs.get_str(envknobs.VERIFYSVC_WEIGHTS))
        )
        self._credits: dict[Klass, int] = {}
        # (tenant, class) state: queues keyed class first (strict
        # priority), then tenant (the fair interleave).  A tenant's
        # entries go when its queue drains, so the state stays bounded
        # however many tenant ids appear.
        q = tenant_quota if tenant_quota is not None else envknobs.get_int(envknobs.VERIFYSVC_TENANT_QUOTA)
        self.tenant_quota = q if q and q > 0 else self.queue_max
        self._tenant_weights = (
            dict(tenant_weights) if tenant_weights is not None
            else _parse_tenant_weights(envknobs.get_str(envknobs.VERIFYSVC_TENANT_WEIGHTS))
        )
        self._queues: dict[Klass, dict[str, list[_Request]]] = {k: {} for k in Klass}
        self._queued_sigs: dict[Klass, dict[str, int]] = {k: {} for k in Klass}
        self._class_sigs: dict[Klass, int] = {k: 0 for k in Klass}
        # per-(class, tenant) OUTSTANDING signatures (submitted, not yet
        # settled): what the tenant quota admits against, since the
        # scheduler drains its queues into the worker at once.  Released
        # once a request by its ticket's settle hook.  Its own lock,
        # taken inside _cond on submit and alone on release.
        self._outstanding_sigs: dict[Klass, dict[str, int]] = {k: {} for k in Klass}
        self._out_mtx = threading.Lock()
        self._tenant_credits: dict[Klass, dict[str, int]] = {k: {} for k in Klass}
        self._last_tenant: dict[Klass, str | None] = {k: None for k in Klass}
        self._cond = threading.Condition()
        self._collectq: queue.Queue = queue.Queue()
        # class-priority queue of (klass, seq, (bv, batch)) for submit():
        # a queued consensus batch overtakes queued mempool work
        self._hostq: queue.PriorityQueue = queue.PriorityQueue()
        self._hostseq = itertools.count(1)
        # batches handed on but not settled, by id(batch), for stats()
        self._inflight: dict[int, dict] = {}
        self._inflight_mtx = threading.Lock()
        self._running = False
        self._threads: list[threading.Thread] = []
        self._start_once = threading.Lock()
        self._dispatched: dict[str, int] = {k.label: 0 for k in Klass}
        self._dispatched_sigs: dict[str, int] = {k.label: 0 for k in Klass}
        self._rejected: dict[str, int] = {k.label: 0 for k in Klass}
        self._tenant_tallies: dict[str, dict[str, int]] = {}
        self._tally_mtx = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    def _ensure_started(self) -> None:
        if self._running:
            return
        with self._start_once:
            if self._running:
                return
            self._running = True
            self._threads = [
                threading.Thread(target=self._sched_loop, name="verifysvc-sched", daemon=True),
                threading.Thread(target=self._collect_loop, name="verifysvc-collect", daemon=True),
                threading.Thread(target=self._host_loop, name="verifysvc-host", daemon=True),
            ]
            for t in self._threads:
                t.start()

    def _bind_thread(self) -> None:
        """Make the service's card current on the calling thread: every
        launcher guards its own device, and this covers the rest."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def stop(self) -> None:
        """End the threads.  Queued requests, and batches the workers
        had not started, fail with backpressure, so no caller waits
        forever."""
        with self._cond:
            if not self._running:
                return
            self._running = False
            stranded = [r for tenant_queues in self._queues.values() for q in tenant_queues.values() for r in q]
            for k in Klass:
                self._queues[k] = {}
                self._queued_sigs[k] = {}
                self._class_sigs[k] = 0
            self._cond.notify_all()
        self._collectq.put(None)
        self._hostq.put((_HOST_SENTINEL_PRIO, 0, None))
        for r in stranded:
            r.ticket._fail(VerifyServiceBackpressure(r.klass, 0, self.queue_max))
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

        def _fail_batch(batch):
            for r in batch:
                r.ticket._fail(VerifyServiceBackpressure(r.klass, 0, self.queue_max))

        # a batch that reached a queue after its worker left
        while True:
            try:
                item = self._collectq.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _fail_batch(item[2])
        while True:
            try:
                _, _, payload = self._hostq.get_nowait()
            except queue.Empty:
                break
            if payload is not None:
                _fail_batch(payload[1])
        with self._inflight_mtx:
            self._inflight.clear()

    # ------------------------------------------------------------- submit

    def submit(self, items, klass: Klass, mode=MODE_PLAIN, tenant: str | None = None) -> Ticket:
        """Enqueue one request (a list of (pubkey, msg, sig) triples,
        verified as a unit) under ``tenant`` (None: this process's
        default tenant) and return its ticket.  Raises
        :class:`VerifyServiceBackpressure` when the tenant's quota or the
        class's queue bound is hit."""
        items = list(items)
        if tenant is None:
            tenant = default_tenant()
        if not items:
            t = Ticket()
            t._resolve((False, []))  # the verifiers' empty-batch contract
            return t
        self._ensure_started()
        n = len(items)
        with self._cond:
            if not self._running:
                # stop() won the race after _ensure_started
                raise VerifyServiceBackpressure(klass, 0, self.queue_max, tenant=tenant)
            class_q = self._class_sigs[klass]
            ten_q = self._queued_sigs[klass].get(tenant, 0)
            qmax = self._proof_queue_max if klass is Klass.PROOF else self.queue_max
            with self._out_mtx:
                ten_out = self._outstanding_sigs[klass].get(tenant, 0)
                if ten_out + n > self.tenant_quota < self.queue_max:
                    # the tenant's own quota, on outstanding signatures;
                    # with no quota set (quota == queue_max) the class
                    # bound below owns the refusal
                    queued, limit, scope = ten_out, self.tenant_quota, "tenant"
                elif class_q + n > qmax:
                    queued, limit, scope = class_q, qmax, "class"
                else:
                    scope = None
                    self._outstanding_sigs[klass][tenant] = ten_out + n
            if scope is not None:
                self._rejected[klass.label] += 1
            else:
                req = _Request(items, klass, mode, tenant=tenant)
                req.ticket._on_settle = functools.partial(self._release_outstanding, klass, tenant, n,
                                                          req.stage)
                self._queues[klass].setdefault(tenant, []).append(req)
                self._queued_sigs[klass][tenant] = ten_q + n
                self._class_sigs[klass] = class_q + n
                self._cond.notify()
        if scope is not None:
            self._tally_tenant(tenant, "rejected")
            tracing.instant(
                "verify.sched.reject",
                {"class": klass.label, "tenant": tenant, "scope": scope, "queued": queued, "sigs": n}
                if tracing.enabled() else None,
            )
            raise VerifyServiceBackpressure(klass, queued, limit, tenant=tenant, scope=scope)
        return req.ticket

    def _release_outstanding(self, klass: Klass, tenant: str, n: int, stage=None) -> None:
        """Return ``n`` signatures of ``tenant``'s quota, and a staging
        place the request never used (the ticket's settle hook, once a
        request whichever path settles it)."""
        release_stage(stage)
        with self._out_mtx:
            d = self._outstanding_sigs[klass]
            left = d.get(tenant, 0) - n
            if left > 0:
                d[tenant] = left
            else:
                d.pop(tenant, None)

    def _tally_tenant(self, tenant: str, key: str, n: int = 1) -> None:
        with self._tally_mtx:
            t = self._tenant_tallies.get(tenant)
            if t is None:
                if len(self._tenant_tallies) >= _TENANT_TALLY_MAX:
                    tenant = _OVERFLOW_TENANT
                t = self._tenant_tallies.setdefault(
                    tenant, {"dispatched_batches": 0, "dispatched_sigs": 0, "rejected": 0}
                )
            t[key] += n

    def verify(self, items, klass: Klass, mode=MODE_PLAIN, tenant: str | None = None) -> tuple[bool, list[bool]]:
        """submit() + collect() in one call, waiting at most
        collect_timeout_s()."""
        return self.submit(items, klass, mode, tenant=tenant).collect(collect_timeout_s())

    # ---------------------------------------------------------- scheduler

    def _tenant_ready_locked(self, klass: Klass, tenant: str, now: float) -> bool:
        q = self._queues[klass].get(tenant)
        if not q:
            return False
        if self._queued_sigs[klass].get(tenant, 0) >= self.batch_max:
            return True
        return (now - q[0].enq) >= self._deadline_s[klass]

    def _ready_locked(self, klass: Klass, now: float) -> bool:
        """A class is ready when any of its tenants is (width or
        deadline)."""
        return any(self._tenant_ready_locked(klass, t, now) for t in self._queues[klass])

    def _next_deadline_locked(self, now: float) -> float | None:
        """Seconds until the earliest waiting (class, tenant) queue
        flushes, or None when every queue is empty."""
        best = None
        for k in Klass:
            for q in self._queues[k].values():
                if not q:
                    continue
                remain = self._deadline_s[k] - (now - q[0].enq)
                if best is None or remain < best:
                    best = remain
        return best

    def _pick_class_locked(self, now: float) -> Klass | None:
        ready = [k for k in Klass if self._ready_locked(k, now)]
        if not ready:
            return None
        if not self._weights:
            return ready[0]  # strict priority: Klass order
        # weighted interleave: spend credits in priority order, refill
        # when every ready class is out
        for k in ready:
            if self._credits.get(k, 0) > 0:
                self._credits[k] -= 1
                return k
        for k in Klass:
            self._credits[k] = self._weights.get(k, 1)
        self._credits[ready[0]] -= 1
        return ready[0]

    def _pick_tenant_locked(self, klass: Klass, now: float) -> str:
        """Weighted-fair interleave of the class's ready tenants: spend
        per-tenant credits in round-robin order starting after the last
        tenant served; when every ready tenant is out, refill each to
        its weight.  A tenant of weight w gets w dispatches a round."""
        ready = sorted(t for t in self._queues[klass] if self._tenant_ready_locked(klass, t, now))
        if len(ready) == 1:
            self._last_tenant[klass] = ready[0]
            return ready[0]
        last = self._last_tenant[klass]
        if last in ready:
            i = ready.index(last)
            order = ready[i + 1 :] + ready[: i + 1]
        else:
            order = ready
        creds = self._tenant_credits[klass]
        for t in order:
            if creds.get(t, 0) > 0:
                creds[t] -= 1
                self._last_tenant[klass] = t
                return t
        # refill from the ready set, which drops tenants that drained
        self._tenant_credits[klass] = creds = {t: self._tenant_weights.get(t, 1) for t in ready}
        t = order[0]
        creds[t] -= 1
        self._last_tenant[klass] = t
        return t

    def _form_batch_locked(self, klass: Klass, tenant: str) -> tuple[list[_Request], str]:
        """Pop the head batch of a ready (class, tenant) queue.  Requests
        of a coalescible mode merge with following requests of the same
        mode up to the batch width; comb and BLS requests go alone.
        Returns (batch, flush reason)."""
        q = self._queues[klass][tenant]
        # the reason is what made the queue ready, decided before popping
        was_full = self._queued_sigs[klass].get(tenant, 0) >= self.batch_max
        head = q.pop(0)
        batch = [head]
        total = len(head.items)
        kind = head.mode[0]
        if kind in _COALESCIBLE_MODES:
            while q and q[0].mode[0] == kind and total < self.batch_max:
                nxt = q.pop(0)
                batch.append(nxt)
                total += len(nxt.items)
        if q:
            self._queued_sigs[klass][tenant] -= total
        else:
            del self._queues[klass][tenant]
            self._queued_sigs[klass].pop(tenant, None)
        self._class_sigs[klass] -= total
        reason = "full" if (was_full or total >= self.batch_max) else "deadline"
        return batch, reason

    def _track_inflight(self, batch: list[_Request], where: str) -> None:
        with self._inflight_mtx:
            self._inflight[id(batch)] = {
                "class": batch[0].klass.label,
                "tenant": batch[0].tenant,
                "sigs": sum(len(r.items) for r in batch),
                "requests": len(batch),
                "where": where,
                "since": time.monotonic(),
            }

    def _relabel_inflight(self, batch: list[_Request], where: str) -> None:
        with self._inflight_mtx:
            rec = self._inflight.get(id(batch))
            if rec is not None:
                rec["where"] = where

    def _untrack_inflight(self, batch: list[_Request]) -> None:
        with self._inflight_mtx:
            self._inflight.pop(id(batch), None)

    def _sched_loop(self) -> None:
        self._bind_thread()
        while True:
            with self._cond:
                if not self._running:
                    return
                now = time.monotonic()
                klass = self._pick_class_locked(now)
                if klass is None:
                    remain = self._next_deadline_locked(now)
                    # bounded: submits notify, deadlines cap the sleep,
                    # and an idle tick keeps stop() prompt
                    self._cond.wait(0.5 if remain is None else max(0.0, min(remain, 0.5)))
                    continue
                tenant = self._pick_tenant_locked(klass, now)
                batch, _ = self._form_batch_locked(klass, tenant)
            self._dispatch(klass, batch)

    def _make_verifier(self, mode):
        """Bind a batch to a verifier on the service's device (a comb
        entry carries its own).  The one constructor seam: tests replace
        it to watch dispatch without a kernel."""
        if mode[0] == "comb":
            from ..models.comb_verifier import CombBatchVerifier

            return CombBatchVerifier(mode[1])
        if mode[0] == "bls":
            from ..models.bls_verifier import BlsAggregateVerifier

            return BlsAggregateVerifier(device=self.device)
        if mode[0] == "secp":
            from ..models.secp_verifier import SecpBatchVerifier

            return SecpBatchVerifier(device=self.device)
        if mode[0] == "proof":
            from ..models.proof_server import ProofProver

            return ProofProver(device=self.device)
        from ..models.verifier import Ed25519BatchVerifier

        return Ed25519BatchVerifier(device=self.device)

    @staticmethod
    def _submit_is_offloaded(bv) -> bool:
        """Whether bv.submit() runs on the host worker instead of the
        scheduler thread (cometbft_tpu/verifysvc/service.py:1193).  Only
        a comb batch's submit is cheap: it hands the fill, the copies and
        the launches to the staging thread.  Every other verifier does its
        work inside submit() (the uncached and secp assembly, the BLS
        decompression, the proof trees, a demoted comb batch's uncached
        verify), which on the scheduler would hold up the next consensus
        dispatch.  The JAX rule's arm for a comb batch below
        ``_device_batch_min`` (a host route by width) has no counterpart
        here."""
        if getattr(bv, "_entry", None) is None:  # not a comb verifier
            return True
        return getattr(bv, "_fallback", None) is not None  # a demoted comb batch

    def _dispatch(self, klass: Klass, batch: list[_Request]) -> None:
        """Bind the batch to a verifier; submit a comb batch here and
        hand its ticket to the collector, queue any other for the host
        worker (``_submit_is_offloaded``)."""
        nsigs = sum(len(r.items) for r in batch)
        now = time.monotonic()
        for r in batch:
            r.dispatched = now
        self._dispatched[klass.label] += 1
        self._dispatched_sigs[klass.label] += nsigs
        self._tally_tenant(batch[0].tenant, "dispatched_batches")
        self._tally_tenant(batch[0].tenant, "dispatched_sigs", nsigs)
        labels = (
            {"class": klass.label, "tenant": batch[0].tenant, "sigs": nsigs, "requests": len(batch)}
            if tracing.enabled() else None
        )
        with tracing.context_scope(_batch_ctx(batch)), tracing.span("verify.sched.dispatch", labels):
            t0 = time.perf_counter()
            try:
                bv = self._make_verifier(batch[0].mode)
                bind = getattr(bv, "bind_stage", None)
                if bind is not None:
                    bind(batch[0].stage)  # comb requests go alone
                for r in batch:
                    for pub, msg, sig in r.items:
                        bv.add(pub, msg, sig)
                if self._submit_is_offloaded(bv):
                    # a demoted comb batch stages nothing: its place goes
                    # back now, not when the host worker reaches it
                    release_stage(batch[0].stage)
                    self._track_inflight(batch, "host")
                    self._hostq.put((int(klass), next(self._hostseq), (bv, batch)))
                    return
                ticket = bv.submit()  # the comb staging seam: returns at once
            except BaseException as e:  # noqa: BLE001 — fail the tickets, keep scheduling
                self._fail_batch(batch, e)
                return
            submit_ms = (time.perf_counter() - t0) * 1e3
        self._track_inflight(batch, "device")
        if ticket[0] == "sync":
            self._settle(bv, ticket, batch, submit_ms)
        else:
            self._collectq.put((bv, ticket, batch, submit_ms))

    def _fail_batch(self, batch: list[_Request], exc: BaseException) -> None:
        """A dispatch, submit or collect error: the tickets fail with it
        (the JAX service's branch with failover off)."""
        self._untrack_inflight(batch)
        for r in batch:
            r.ticket._fail(exc)

    def _host_loop(self) -> None:
        """Run submit() of queued batches in class-priority order: a
        queued consensus batch overtakes queued lower-class ones, so it
        waits at most for the one task in progress."""
        self._bind_thread()
        while True:
            if not self._running:
                return
            try:
                _, _, payload = self._hostq.get(timeout=0.5)
            except queue.Empty:
                continue
            if payload is None:
                return
            bv, batch = payload
            labels = (
                {"class": batch[0].klass.label, "requests": len(batch)} if tracing.enabled() else None
            )
            with tracing.context_scope(_batch_ctx(batch)), tracing.span("verify.sched.hostwork", labels):
                t0 = time.perf_counter()
                try:
                    ticket = bv.submit()
                except BaseException as e:  # noqa: BLE001 — fail the tickets, keep serving
                    self._fail_batch(batch, e)
                    continue
                submit_ms = (time.perf_counter() - t0) * 1e3
            if ticket[0] == "sync":
                self._settle(bv, ticket, batch, submit_ms)
            else:
                # the collector owns the wait for the card
                self._relabel_inflight(batch, "device")
                self._collectq.put((bv, ticket, batch, submit_ms))

    # ---------------------------------------------------------- collector

    def _collect_loop(self) -> None:
        self._bind_thread()
        while True:
            if not self._running:
                return
            try:
                item = self._collectq.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:
                return
            self._settle(*item)

    def _settle(self, bv, ticket, batch: list[_Request], submit_ms: float) -> None:
        self._relabel_inflight(batch, "collect")
        labels = {"class": batch[0].klass.label, "requests": len(batch)} if tracing.enabled() else None
        try:
            with tracing.context_scope(_batch_ctx(batch)), tracing.span("verify.sched.collect", labels):
                self._settle_inner(bv, ticket, batch, submit_ms)
        finally:
            self._untrack_inflight(batch)

    def _settle_inner(self, bv, ticket, batch: list[_Request], submit_ms: float) -> None:
        """Resolve a batch's tickets from its verifier's result, each
        request's slice in that request's own add() order."""
        t0 = time.perf_counter()
        try:
            _, res = bv.collect(ticket)
        except BaseException as e:  # noqa: BLE001 — fail the tickets, keep draining
            self._fail_batch(batch, e)
            return
        total = sum(len(r.items) for r in batch)
        if len(res) != total:
            self._fail_batch(batch, RuntimeError(
                f"verifier returned {len(res)} results for {total} submitted signatures"))
            return
        # the verifier's phases, plus submit_ms and kernel_ms as its own
        # verify() reports them (the wait for the card: a device ticket)
        timings = dict(getattr(bv, "last_timings", None) or {})
        timings["submit_ms"] = submit_ms
        if ticket[0] != "sync":
            timings["kernel_ms"] = (time.perf_counter() - t0) * 1e3
        off = 0
        for r in batch:
            part = list(res[off : off + len(r.items)])
            off += len(r.items)
            timings["queue_ms"] = (r.dispatched - r.enq) * 1e3
            # a merged batch's all_ok says nothing of one request: judge
            # the request's own slice, as the verifiers' all(res) does
            r.ticket._resolve((all(part) and bool(part), part), timings)

    # ------------------------------------------------------------- status

    def stats(self) -> dict:
        """A snapshot of the queues, the batches in flight (with their
        ages) and the service's tallies: batches and signatures
        dispatched, submits refused (each a host verification by its
        caller), per tenant as well."""
        now = time.monotonic()
        with self._inflight_mtx:
            in_flight = [
                {
                    "class": rec["class"],
                    "tenant": rec["tenant"],
                    "sigs": rec["sigs"],
                    "requests": rec["requests"],
                    "where": rec["where"],
                    "age_s": round(now - rec["since"], 3),
                }
                for rec in self._inflight.values()
            ]
        with self._cond:
            queued = {
                k.label: {
                    "requests": sum(len(q) for q in self._queues[k].values()),
                    "sigs": self._class_sigs[k],
                    "by_tenant": dict(self._queued_sigs[k]),
                }
                for k in Klass
            }
            dispatched = dict(self._dispatched)
            dispatched_sigs = dict(self._dispatched_sigs)
            rejected = dict(self._rejected)
        with self._tally_mtx:
            tenants = {t: dict(v) for t, v in self._tenant_tallies.items()}
        return {
            "device": str(self.device),
            "in_flight": in_flight,
            "running": self._running,
            "batch_max": self.batch_max,
            "queue_max": self.queue_max,
            "tenant_quota": self.tenant_quota,
            "tenant_weights": dict(self._tenant_weights),
            "deadline_ms": {k.label: self._deadline_s[k] * 1e3 for k in Klass},
            "weights": {k.label: w for k, w in self._weights.items()},
            "queued": queued,
            "dispatched_batches": dispatched,
            "dispatched_sigs": dispatched_sigs,
            "rejected": rejected,
            "tenants": tenants,
        }


_GLOBAL: dict[str, VerifyService] = {}
_GLOBAL_MTX = threading.Lock()


def global_service(device="cuda") -> VerifyService:
    """The process-wide service of ``device`` (one per resolved device,
    a bare "cuda" pinned to the caller's current card) that every
    client on it shares: one scheduler, one priority order."""
    dev = _pinned(device)
    with _GLOBAL_MTX:
        svc = _GLOBAL.get(str(dev))
        if svc is None:
            svc = _GLOBAL[str(dev)] = VerifyService(device=dev)
        return svc


def reset_global_service() -> None:
    """Stop and drop every global service (tests re-reading knobs, and
    every test that started one)."""
    with _GLOBAL_MTX:
        svcs = list(_GLOBAL.values())
        _GLOBAL.clear()
    for svc in svcs:
        svc.stop()
