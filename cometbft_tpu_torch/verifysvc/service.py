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
settles the tickets; with failover on, a watchdog.  Which submits leave
the scheduler is the JAX service's rule (``_submit_is_offloaded``): a
comb batch that was not demoted submits on the scheduler, since its
submit() only hands the batch to the comb path's staging thread
(models/comb_verifier.py), and every other batch (uncached, demoted
comb, secp, BLS, proof, and every batch on the host path) goes to the
host worker, where a queued consensus batch overtakes lower classes.
The JAX rule's third arm, a comb batch below its host-route width, has
no counterpart: the port sends every batch to the card (ROADMAP C).

**Failover** (``COMETBFT_TPU_FAILOVER``, on by default as in the JAX
package): the service runs in one of two backend modes, ``tpu`` (the
card) or ``cpu_fallback`` (the host verifiers, ``_HostBatchVerifier``).
A watchdog thread trips it to ``cpu_fallback`` when a batch has been on
the card (dispatched to it, or awaited) longer than
``COMETBFT_TPU_FAILOVER_BATCH_DEADLINE_MS``, or when the health sentinel
(utils/healthmon) judges the card wedged.  A trip re-verifies every
stranded batch on the host, each request's verdicts in its own add()
order (a ticket settles once: the first resolution wins, so a late
answer from the card is dropped), starts a new generation of collector
and host worker (the old ones may be parked in the wedged wait), routes
every later batch to the host (comb binds bypassed here and in
client.resolve_mode), and writes one forensics artifact
(utils/debugdump.stall_report) under ``artifact_dir``.  While tripped,
a probation probe (utils/healthmon.probe_devices: a subprocess that
starts CUDA on the service's card, under a deadline) runs every
``COMETBFT_TPU_FAILOVER_PROBE_PERIOD_MS``; after
``COMETBFT_TPU_FAILOVER_PROBATION_OK`` good ones in a row the service
restores ``tpu``.  A dispatch, submit or collect *error* does not trip:
the batch is verified again on the host (same verdicts) and the service
keeps serving — except when the error is not the card's (``BuildError``,
``NoCudaDevice``, a kernel wrapper's ``LaunchRefused``, a launch that
failed, ``KernelError``) or the host path itself failed, which fail the
tickets: re-verifying those would hide a broken build or a kernel that
never launched.  With failover off, every error fails its tickets.

There is no failover across the ranks of a mesh: a comb request whose
tables are sharded over one (models/comb_verifier.active_mesh) is never
verified on the host by its rank alone, since the other ranks' stages
would wait in collectives that rank no longer joins.  Its tickets fail
instead (``MeshFailoverRefused`` on a trip or while tripped, the error
itself on an error), and client.resolve_mode keeps every rank's
readiness agreement, a tripped rank voting for the uncached route, so
the ranks' later requests take the same route.

A request takes its place in the comb route's collective order here, in
the submitter's thread (models/comb_verifier.reserve_stage: a token
under a mesh, else None), so its collectives keep the submitter's call
order beside the readiness agreements of verifysvc/client.resolve_mode.
A demoted batch, a batch on the host path and a batch verified again on
the host give their place back at dispatch or at the error; a request
that settles without a stage gives it back when it settles.

Observations, under the JAX names (utils/metrics.hub): the class and
tenant queue depths, queue waits, flushes, refusals and dispatches, the
backend mode, failovers and host re-verifies; the flight recorder's
``verifysvc_backpressure``, ``verifysvc_failover`` and
``verifysvc_collect_stall`` events; the loops' heartbeats.  Spans
(utils/tracing.py, the JAX names): ``verify.sched.dispatch`` around a
batch's binding (and a comb batch's submit), ``verify.sched.hostwork``
around a host-worker submit, ``verify.sched.collect`` around the wait
and the settle, ``verify.failover.reverify`` around a stranded request's
host verify, and the instants ``verify.sched.reject``,
``verify.failover`` and ``verify.collect_stall``; each under the
submitter's span context.  Left out of the port so far (ROADMAP A): the
remote plane.
"""

from __future__ import annotations

import functools
import itertools
import logging
import queue
import threading
import time
from enum import IntEnum

import torch

from .. import envknobs
from .._build import BuildError, KernelError, LaunchRefused
from .._device import NoCudaDevice, resolve_device
from ..models.comb_verifier import release_stage, reserve_stage
from ..utils import fail, healthmon, tracing
from ..utils.flightrec import recorder as _flightrec
from ..utils.metrics import hub as _mhub

MODE_TPU = "tpu"
MODE_CPU_FALLBACK = "cpu_fallback"
_MODE_CODE = {MODE_TPU: 0, MODE_CPU_FALLBACK: 1}

# errors that are not the card's: a batch failing with one fails its
# tickets even with failover on (a host re-verify would hide a broken
# build, a missing card, a kernel its wrapper refused to launch, or one
# whose launch failed: _build.check's error right after the launch)
_NOT_DEVICE_FAULTS = (BuildError, NoCudaDevice, LaunchRefused, KernelError)


class MeshFailoverRefused(RuntimeError):
    """A comb request sharded over a mesh met a trip: its rank alone
    cannot verify it on the host (module docstring, failover)."""


def _on_mesh(mode) -> bool:
    """Whether ``mode`` binds comb tables sharded over a mesh (its stage
    runs collectives with every other rank)."""
    return mode[0] == "comb" and getattr(mode[1], "mesh", None) is not None


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
# under one key, each service on its own (the JAX package's tallies share
# the hub's process-wide LabelGuard; the metrics' tenant labels here do)
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
        """The first resolution wins; a later one is discarded (a host
        re-verify races the wedged wait it replaced, and the late answer
        is dropped, never written over a result already read)."""
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

    def done(self) -> bool:
        return self._ev.is_set()

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


class _HostBatchVerifier:
    """The host path in the verifiers' seam: the mode's host verifier
    (:func:`cpu_verifier_for_mode`) behind a submit() that returns a
    resolved ticket.  ``_entry = None`` sends its submit() to the
    class-priority host worker (``_submit_is_offloaded``), so while the
    service is tripped a mempool batch's host verify still cannot delay
    a queued consensus one."""

    _entry = None
    _fallback = None

    def __init__(self, mode=MODE_PLAIN):
        self._cpu = cpu_verifier_for_mode(mode)

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        self._cpu.add(pub_key, msg, sig)

    def add_items_unchecked(self, items) -> None:
        """Take the items as they are, without add()'s shape checks: the
        error paths verify again batches whose dispatch may have failed
        on exactly those checks, and the host verifiers judge a
        malformed row False instead of raising."""
        self._cpu._items = list(items)

    def submit(self):
        return ("sync", self._cpu.verify())

    def collect(self, ticket) -> tuple[bool, list[bool]]:
        return ticket[1]


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

    Construction reads the ``COMETBFT_TPU_VERIFYSVC_*`` and
    ``COMETBFT_TPU_FAILOVER*`` knobs once; explicit arguments override
    them (tests).  ``probe_fn(timeout_s)`` is the probation probe
    (default: utils/healthmon.probe_devices on the service's card);
    ``artifact_dir`` is where a trip's forensics go (None: the temporary
    directory).  Threads start on the first submit and are daemons;
    :meth:`stop` ends them and fails the tickets still waiting.
    """

    def __init__(
        self,
        batch_max: int | None = None,
        queue_max: int | None = None,
        deadlines_ms: dict[Klass, float] | None = None,
        weights: dict[Klass, int] | None = None,
        tenant_quota: int | None = None,
        tenant_weights: dict[str, int] | None = None,
        failover: bool | None = None,
        batch_deadline_s: float | None = None,
        probation_ok: int | None = None,
        probe_fn=None,
        probe_period_s: float | None = None,
        probe_timeout_s: float | None = None,
        failover_tick_s: float = 0.25,
        artifact_dir: str | None = None,
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
        # a queued consensus batch overtakes queued mempool work.  The
        # sequence is shared by the scheduler, the collector and the
        # error path: equal (prio, seq) pairs would compare the payloads
        self._hostq: queue.PriorityQueue = queue.PriorityQueue()
        self._hostseq = itertools.count(1)
        # batches handed on but not settled, by id(batch): stats() and
        # the watchdog read their ages, a trip re-verifies them
        self._inflight: dict[int, dict] = {}
        self._inflight_mtx = threading.Lock()
        self._running = False
        self._threads: list[threading.Thread] = []
        self._start_once = threading.Lock()
        self.logger = logging.getLogger("cometbft_tpu_torch.verifysvc")
        self._dispatched: dict[str, int] = {k.label: 0 for k in Klass}
        self._dispatched_sigs: dict[str, int] = {k.label: 0 for k in Klass}
        self._rejected: dict[str, int] = {k.label: 0 for k in Klass}
        self._tenant_tallies: dict[str, dict[str, int]] = {}
        self._tally_mtx = threading.Lock()

        # ---- failover (module docstring)
        self.failover_enabled = envknobs.get_bool(envknobs.FAILOVER) if failover is None else failover
        self.batch_deadline_s = (
            batch_deadline_s if batch_deadline_s is not None
            else max(1, envknobs.get_int(envknobs.FAILOVER_BATCH_DEADLINE_MS)) / 1e3
        )
        self.probation_ok = max(
            1, probation_ok if probation_ok is not None else envknobs.get_int(envknobs.FAILOVER_PROBATION_OK)
        )
        self.probe_period_s = (
            probe_period_s if probe_period_s is not None
            else max(1, envknobs.get_int(envknobs.FAILOVER_PROBE_PERIOD_MS)) / 1e3
        )
        self.probe_timeout_s = (
            probe_timeout_s if probe_timeout_s is not None
            else max(1, envknobs.get_int(envknobs.FAILOVER_PROBE_TIMEOUT_MS)) / 1e3
        )
        self._probe_fn = (
            probe_fn if probe_fn is not None
            else functools.partial(healthmon.probe_devices, device_index=self.device.index)
        )
        self.failover_tick_s = max(0.01, failover_tick_s)
        self.artifact_dir = artifact_dir
        # mode state, under _failover_mtx (never held across blocking
        # work); _gen tags the collector and host worker so a trip can
        # start fresh ones while the old ones sit in a wedged wait
        self._failover_mtx = threading.Lock()
        self._backend_mode = MODE_TPU
        self._gen = 0
        self._trips = 0
        self._restores = 0
        self._probation_consec_ok = 0
        self._next_probation_probe = 0.0
        self._last_restore_at: float | None = None
        self._last_trip_reason: str | None = None
        self._last_artifact: str | None = None
        self._stop_ev = threading.Event()

    # ------------------------------------------------------------ lifecycle

    def _ensure_started(self) -> None:
        if self._running:
            return
        with self._start_once:
            if self._running:
                return
            self._running = True
            # a restart after stop(): a stale stop signal would make the
            # watchdog's every wait return at once, firing probes back to
            # back
            self._stop_ev.clear()
            self._threads = [threading.Thread(target=self._sched_loop, name="verifysvc-sched", daemon=True)]
            if self.failover_enabled:
                self._threads.append(
                    threading.Thread(target=self._failover_loop, name="verifysvc-failover", daemon=True))
            for t in self._threads:
                t.start()
            self._threads += self._spawn_workers(self._gen)

    def _spawn_workers(self, gen: int) -> list[threading.Thread]:
        """Start a collector and a host worker tagged with ``gen``.  A trip
        bumps the generation and calls this again: the old workers may be
        parked in a wedged wait for good, and a stale generation exits
        (without retiring the heartbeat the fresh worker owns) as soon as
        it unblocks."""
        ts = [
            threading.Thread(target=self._collect_loop, args=(gen,), name="verifysvc-collect", daemon=True),
            threading.Thread(target=self._host_loop, args=(gen,), name="verifysvc-host", daemon=True),
        ]
        for t in ts:
            t.start()
        return ts

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
        self._stop_ev.set()
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
        m = _mhub()
        tlabel = m.tenant_labels.bound(tenant)
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
                depth, tdepth = class_q + n, ten_q + n
                self._cond.notify()
        if scope is not None:
            self._tally_tenant(tenant, "rejected")
            m.verify_svc_rejected.inc(**{"class": klass.label})
            m.verify_svc_tenant_rejected.inc(**{"tenant": tlabel, "class": klass.label, "scope": scope})
            _flightrec().record("verifysvc_backpressure", klass=klass.label, tenant=tenant, scope=scope,
                                queued=queued, sigs=n, limit=limit)
            tracing.instant(
                "verify.sched.reject",
                {"class": klass.label, "tenant": tenant, "scope": scope, "queued": queued, "sigs": n}
                if tracing.enabled() else None,
            )
            raise VerifyServiceBackpressure(klass, queued, limit, tenant=tenant, scope=scope)
        m.verify_svc_queue_depth.set(depth, **{"class": klass.label})
        m.verify_svc_tenant_queue_depth.set(tdepth, **{"tenant": tlabel, "class": klass.label})
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
        now = time.monotonic()
        with self._inflight_mtx:
            self._inflight[id(batch)] = {
                "class": batch[0].klass.label,
                "tenant": batch[0].tenant,
                "sigs": sum(len(r.items) for r in batch),
                "requests": len(batch),
                "where": where,
                "since": now,
                # when the batch reached the card: the clock of the
                # failover deadline.  A batch on the host worker starts it
                # only when it is handed to the collector (host work is
                # legitimate, however long)
                "device_since": now if where == "device" else None,
                # the requests themselves, for a trip's re-verify (stats()
                # copies the display fields only)
                "batch": batch,
            }

    def _relabel_inflight(self, batch: list[_Request], where: str) -> None:
        with self._inflight_mtx:
            rec = self._inflight.get(id(batch))
            if rec is not None:
                rec["where"] = where
                if where in ("device", "collect") and rec.get("device_since") is None:
                    rec["device_since"] = time.monotonic()

    def _untrack_inflight(self, batch: list[_Request]) -> None:
        with self._inflight_mtx:
            self._inflight.pop(id(batch), None)

    def _sched_loop(self) -> None:
        self._bind_thread()
        m = _mhub()
        while True:
            healthmon.beat("verifysvc-sched")
            with self._cond:
                if not self._running:
                    healthmon.retire("verifysvc-sched")
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
                batch, reason = self._form_batch_locked(klass, tenant)
                depth = self._class_sigs[klass]
                tdepth = self._queued_sigs[klass].get(tenant, 0)
            m.verify_svc_queue_depth.set(depth, **{"class": klass.label})
            m.verify_svc_tenant_queue_depth.set(
                tdepth, **{"tenant": m.tenant_labels.bound(tenant), "class": klass.label})
            self._dispatch(klass, batch, reason)

    def _make_verifier(self, mode):
        """Bind a batch to a verifier on the service's device (a comb
        entry carries its own).  The one constructor seam: tests replace
        it to watch dispatch without a kernel.  In ``cpu_fallback`` every
        batch, comb-bound or not, gets the host path: a comb entry lives
        on the card, and touching it is the hang the trip escaped; a comb
        batch sharded over a mesh raises ``MeshFailoverRefused`` instead,
        and its tickets fail."""
        if self._backend_mode == MODE_CPU_FALLBACK:
            if _on_mesh(mode):
                raise MeshFailoverRefused("the service is tripped to cpu_fallback, and a comb batch sharded over a "
                                          "mesh is not verified on the host by one rank alone")
            return _HostBatchVerifier(mode)
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
        verify, the host path), which on the scheduler would hold up the
        next consensus dispatch.  The JAX rule's arm for a comb batch
        below ``_device_batch_min`` (a host route by width) has no
        counterpart here."""
        if getattr(bv, "_entry", None) is None:  # not a comb verifier
            return True
        return getattr(bv, "_fallback", None) is not None  # a demoted comb batch

    def _dispatch(self, klass: Klass, batch: list[_Request], reason: str) -> None:
        """Bind the batch to a verifier; submit a comb batch here and
        hand its ticket to the collector, queue any other for the host
        worker (``_submit_is_offloaded``)."""
        m = _mhub()
        nsigs = sum(len(r.items) for r in batch)
        tlabel = m.tenant_labels.bound(batch[0].tenant)
        now = time.monotonic()
        for r in batch:
            r.dispatched = now
            m.verify_svc_queue_wait.observe(now - r.enq, **{"class": klass.label})
        m.verify_svc_flush.inc(**{"class": klass.label, "reason": reason})
        m.verify_svc_tenant_dispatched.inc(**{"tenant": tlabel, "class": klass.label})
        self._dispatched[klass.label] += 1
        self._dispatched_sigs[klass.label] += nsigs
        self._tally_tenant(batch[0].tenant, "dispatched_batches")
        self._tally_tenant(batch[0].tenant, "dispatched_sigs", nsigs)
        labels = (
            {"class": klass.label, "tenant": batch[0].tenant, "reason": reason, "sigs": nsigs,
             "requests": len(batch)}
            if tracing.enabled() else None
        )
        bv = None
        with tracing.context_scope(_batch_ctx(batch)), tracing.span("verify.sched.dispatch", labels):
            t0 = time.perf_counter()
            try:
                if fail.armed("fail_dispatch") is not None:
                    raise fail.InjectedFault("injected fault: fail_dispatch")
                bv = self._make_verifier(batch[0].mode)
                bind = getattr(bv, "bind_stage", None)
                if bind is not None:
                    bind(batch[0].stage)  # comb requests go alone
                add_many = getattr(bv, "add_many", None)  # the comb verifier packs a request at once
                for r in batch:
                    if add_many is not None:
                        add_many(r.items)
                    else:
                        for pub, msg, sig in r.items:
                            bv.add(pub, msg, sig)
                if self._submit_is_offloaded(bv):
                    # a batch that stages nothing gives its place back
                    # now, not when the host worker reaches it
                    release_stage(batch[0].stage)
                    self._track_inflight(batch, "host")
                    self._hostq.put((int(klass), next(self._hostseq), (bv, batch)))
                    return
                ticket = bv.submit()  # the comb staging seam: returns at once
            except BaseException as e:  # noqa: BLE001 — settle the tickets, keep scheduling
                self.logger.error(f"dispatch failed (class={klass.label}, sigs={nsigs}): {e!r}")
                self._fail_or_reverify(batch, e, cause="dispatch_error", bv=bv)
                return
            submit_ms = (time.perf_counter() - t0) * 1e3
        self._track_inflight(batch, "device")
        if ticket[0] == "sync":
            self._settle(bv, ticket, batch, submit_ms)
        else:
            self._collectq.put((bv, ticket, batch, submit_ms))

    def _host_loop(self, gen: int = 0) -> None:
        """Run submit() of queued batches in class-priority order: a
        queued consensus batch overtakes queued lower-class ones, so it
        waits at most for the one task in progress.  ``gen`` retires this
        worker once a trip started a fresh one (a stale worker finishes
        at most the item it held — settlement is first-wins — and exits
        without retiring the heartbeat the fresh one owns)."""
        self._bind_thread()
        while True:
            if gen != self._gen:
                return
            if not self._running:
                healthmon.retire("verifysvc-host")
                return
            healthmon.beat("verifysvc-host")
            try:
                _, _, payload = self._hostq.get(timeout=0.5)
            except queue.Empty:
                continue
            if payload is None:
                healthmon.retire("verifysvc-host")
                return
            bv, batch = payload
            if all(r.ticket.done() for r in batch):
                # a trip verified this batch on the host while it sat
                # queued: its verifier for the card could park this
                # worker in the same wedge
                self._untrack_inflight(batch)
                continue
            if self._backend_mode == MODE_CPU_FALLBACK and not isinstance(bv, _HostBatchVerifier):
                # bound to the card before the trip (it raced the flip):
                # rebuilt on the host path (unchecked: a malformed row
                # judges False instead of raising out of this loop)
                hbv = _HostBatchVerifier(batch[0].mode)
                hbv.add_items_unchecked([it for r in batch for it in r.items])
                bv = hbv
            klass = batch[0].klass
            labels = {"class": klass.label, "requests": len(batch)} if tracing.enabled() else None
            with tracing.context_scope(_batch_ctx(batch)), tracing.span("verify.sched.hostwork", labels):
                t0 = time.perf_counter()
                try:
                    ticket = bv.submit()
                except BaseException as e:  # noqa: BLE001 — settle the tickets, keep serving
                    self.logger.error(f"host-route verify failed (class={klass.label}): {e!r}")
                    self._untrack_inflight(batch)
                    self._fail_or_reverify(batch, e, cause="submit_error", bv=bv)
                    continue
                submit_ms = (time.perf_counter() - t0) * 1e3
            if ticket[0] == "sync":
                self._settle(bv, ticket, batch, submit_ms)
            else:
                # the collector owns the wait for the card; the record's
                # deadline clock starts now
                self._relabel_inflight(batch, "device")
                self._collectq.put((bv, ticket, batch, submit_ms))

    # ---------------------------------------------------------- collector

    def _collect_loop(self, gen: int = 0) -> None:
        self._bind_thread()
        while True:
            if gen != self._gen:
                return  # a trip's fresh collector took over
            if not self._running:
                healthmon.retire("verifysvc-collect")
                return
            healthmon.beat("verifysvc-collect")
            try:
                item = self._collectq.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:
                healthmon.retire("verifysvc-collect")
                return
            self._settle(*item)

    def _settle(self, bv, ticket, batch: list[_Request], submit_ms: float) -> None:
        """Resolve a batch's tickets from its verifier's result.  The
        batch stays in the in-flight table until it resolves either way:
        its age there is what the watchdog reads."""
        if all(r.ticket.done() for r in batch):
            # a trip verified it on the host while it sat in the queue;
            # its own wait goes to a thread of its own, so a wedge cannot
            # park this collector and the comb batch's slab still goes
            # back to its pool once the card answers
            self._untrack_inflight(batch)
            if ticket[0] != "sync":
                threading.Thread(target=_drain, args=(bv, ticket), name="verifysvc-drain", daemon=True).start()
            return
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
            if ticket[0] != "sync":
                # the injected faults bite where a real wedge or stall
                # does: the wait for the card.  A resolved ticket (the
                # host path) never waits on the card, so neither do they
                slow = fail.armed("slow_collect")
                if slow is not None:
                    time.sleep(slow)
                fail.wedge_wait("wedge_device")
            _, res = bv.collect(ticket)
        except BaseException as e:  # noqa: BLE001 — settle the tickets, keep draining
            self.logger.error(f"collect failed (class={batch[0].klass.label}): {e!r}")
            self._fail_or_reverify(batch, e, cause="collect_error", bv=bv)
            return
        total = sum(len(r.items) for r in batch)
        if len(res) != total:
            err = RuntimeError(f"verifier returned {len(res)} results for {total} submitted signatures")
            for r in batch:
                r.ticket._fail(err)
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
            if r.dispatched is not None:  # None: a request that reached the host worker without a dispatch
                timings["queue_ms"] = (r.dispatched - r.enq) * 1e3
            # a merged batch's all_ok says nothing of one request: judge
            # the request's own slice, as the verifiers' all(res) does
            r.ticket._resolve((all(part) and bool(part), part), timings)

    # ----------------------------------------------------------- failover

    @property
    def backend_mode(self) -> str:
        """``tpu`` | ``cpu_fallback`` (a plain read; clients check it
        before binding comb tables)."""
        return self._backend_mode

    def _fail_or_reverify(self, batch: list[_Request], exc, cause: str, bv=None) -> None:
        """A dispatch, submit or collect ERROR (not a hang): with failover
        on, the batch is verified again on the host worker — the same
        verdicts, no change of mode — instead of failing its tickets.
        The re-verify is queued on the class-priority host worker, never
        run here: a large lower-class batch must not park the scheduler
        or the collector.  The tickets fail with the error when failover
        is off, when the host path itself failed (requeueing would loop),
        when the error is not the card's (``_NOT_DEVICE_FAULTS``) and when
        the batch is sharded over a mesh (module docstring, failover).
        Either way the batch's staging places go back now."""
        for r in batch:
            release_stage(r.stage)
        if (
            isinstance(exc, VerifyServiceBackpressure)
            or isinstance(exc, _NOT_DEVICE_FAULTS)
            or _on_mesh(batch[0].mode)
            or not self.failover_enabled
            or isinstance(bv, _HostBatchVerifier)
        ):
            for r in batch:
                r.ticket._fail(exc)
            return
        _mhub().verify_svc_host_reverify.inc(cause=cause)
        # unchecked: the dispatch may have failed on add()'s own checks,
        # and a raise here would escape into the loop
        hbv = _HostBatchVerifier(batch[0].mode)
        hbv.add_items_unchecked([it for r in batch for it in r.items])
        # tracked as host work again; on the collect path the outer
        # _settle's finally drops this entry while the requeue waits (a
        # gap in stats() only)
        self._track_inflight(batch, "host")
        self._hostq.put((int(batch[0].klass), next(self._hostseq), (hbv, batch)))

    def _reverify_batches(self, batches: list[list[_Request]]) -> None:
        """Host-verify every request of every batch, each request's
        verdicts in its own add() order, resolving first-wins (a wedged
        wait that completes later is dropped); a request sharded over a
        mesh fails with ``MeshFailoverRefused`` instead."""
        for batch in batches:
            for r in batch:
                release_stage(r.stage)
                if r.ticket.done():
                    continue
                if _on_mesh(r.mode):
                    r.ticket._fail(MeshFailoverRefused(
                        "the service tripped to cpu_fallback with this comb batch on the card; sharded over a mesh, "
                        "it is not verified on the host by one rank alone"))
                    continue
                with tracing.context_scope(r.ctx), tracing.span(
                    "verify.failover.reverify",
                    {"class": r.klass.label, "sigs": len(r.items)} if tracing.enabled() else None,
                ):
                    r.ticket._resolve(_host_verify_items(r.items, r.mode))

    def _failover_loop(self) -> None:
        """The watchdog: a thread of its own — never the scheduler — so a
        wedged scheduler or collector cannot take the trip decision down
        with it, and the probation probe (a subprocess under a deadline)
        has somewhere safe to block."""
        while self._running:
            if self._backend_mode == MODE_TPU:
                healthmon.beat("verifysvc-failover")
                reason = self._trip_reason()
                if reason is not None:
                    self._trip_to_cpu(reason)
                else:
                    self._stop_ev.wait(self.failover_tick_s)
                continue
            # tripped: sweep stranded work every tick, probe toward the
            # restore every probe period
            self._stop_ev.wait(self.failover_tick_s)
            if not self._running:
                return
            healthmon.beat("verifysvc-failover")
            if self._backend_mode != MODE_CPU_FALLBACK:
                continue
            self._sweep_stranded()
            now = time.monotonic()
            if now < self._next_probation_probe:
                continue
            self._next_probation_probe = now + self.probe_period_s
            try:
                res = self._probe_fn(self.probe_timeout_s)
                ok = bool(res.ok)
                detail = res.detail
            except BaseException as e:  # noqa: BLE001 — a probe bug is a failed probe
                ok, detail = False, f"probe raised {type(e).__name__}: {e}"
            with self._failover_mtx:
                self._probation_consec_ok = self._probation_consec_ok + 1 if ok else 0
                consec = self._probation_consec_ok
            self.logger.info(f"failover probation probe: ok={ok} ({detail}) [{consec}/{self.probation_ok}]")
            if consec >= self.probation_ok:
                self._restore_tpu()

    def _sweep_stranded(self) -> None:
        """Close the trip/dispatch race: the scheduler reads the mode in
        _make_verifier BEFORE tracking the batch, so a batch bound to the
        card while the trip happens can miss the stranded snapshot and
        park the fresh collector in the same wedge.  While tripped, any
        batch overdue on the card's deadline is verified on the host
        (first-wins settlement makes repeats harmless)."""
        now = time.monotonic()
        with self._inflight_mtx:
            overdue = [
                rec["batch"] for rec in self._inflight.values()
                if rec.get("device_since") is not None and now - rec["device_since"] > self.batch_deadline_s
            ]
        overdue = [b for b in overdue if not all(r.ticket.done() for r in b)]
        if not overdue:
            return
        _mhub().verify_svc_host_reverify.inc(sum(not _on_mesh(b[0].mode) for b in overdue), cause="wedge")
        self.logger.warning(f"cpu-fallback sweep: {len(overdue)} batch(es) stranded past the device deadline "
                            "after the trip; re-verifying on host")
        # untrack BEFORE the re-verify: the parked worker's own finally
        # may never run, and an ever-aging entry would trip the service
        # again the moment it restores
        for b in overdue:
            self._untrack_inflight(b)
        threading.Thread(target=self._reverify_batches, args=(overdue,), name="verifysvc-reverify",
                         daemon=True).start()

    def _trip_reason(self) -> str | None:
        """Why the service should trip now, or None: a batch on the card
        (dispatched to it or awaited; ``host`` work is exempt) past the
        batch deadline, or the health sentinel judging the card wedged."""
        now = time.monotonic()
        with self._inflight_mtx:
            worst = max(
                (now - rec["device_since"] for rec in self._inflight.values()
                 if rec.get("device_since") is not None),
                default=0.0,
            )
        if worst > self.batch_deadline_s:
            return f"in-flight batch {worst:.1f}s past the {self.batch_deadline_s:g}s device deadline"
        mon = healthmon.monitor()
        if mon is not None and mon.state == healthmon.STATE_WEDGED:
            # a wedged verdict the sentinel formed before our restore
            # (it probes far less often than probation) must not trip a
            # just-restored service again; once it probes again and still
            # says wedged, the trip is real
            probe_at = getattr(mon, "last_probe_at", None)
            if self._last_restore_at is None or probe_at is None or probe_at > self._last_restore_at:
                return "health sentinel reports accelerator wedged"
        return None

    def trip_to_cpu(self, reason: str) -> bool:
        """Trip to the host path now (an operator's or a test's entry).
        False when already tripped."""
        return self._trip_to_cpu(reason)

    def _trip_to_cpu(self, reason: str) -> bool:
        with self._failover_mtx:
            if self._backend_mode == MODE_CPU_FALLBACK:
                return False
            self._backend_mode = MODE_CPU_FALLBACK
            self._trips += 1
            self._probation_consec_ok = 0
            self._last_trip_reason = reason
            self._next_probation_probe = time.monotonic() + self.probe_period_s
            self._gen += 1
            gen = self._gen
        with self._inflight_mtx:
            stranded = [rec["batch"] for rec in self._inflight.values()]
        stranded_sigs = sum(len(r.items) for batch in stranded for r in batch)
        m = _mhub()
        m.verify_svc_backend_mode.set(_MODE_CODE[MODE_CPU_FALLBACK])
        m.verify_svc_failover.inc(direction="to_cpu")
        m.verify_svc_host_reverify.inc(sum(not _on_mesh(b[0].mode) for b in stranded), cause="wedge")
        _flightrec().record("verifysvc_failover", direction="to_cpu", reason=reason,
                            stranded_batches=len(stranded), stranded_sigs=stranded_sigs)
        tracing.instant(
            "verify.failover",
            {"direction": "to_cpu", "stranded": len(stranded)} if tracing.enabled() else None,
        )
        self.logger.error(f"verify service TRIPPED to CPU fallback: {reason} ({len(stranded)} in-flight batches "
                          f"/ {stranded_sigs} sigs re-verifying on host)")
        # the stats before the re-verify settles and untracks the
        # stranded batches, for the forensics artifact
        snapshot = self.stats(lock_timeout=0.5)
        workers = self._spawn_workers(gen)
        self._threads = [t for t in self._threads if t.name not in ("verifysvc-collect", "verifysvc-host")] + workers

        def _recover():
            # untrack first: the stranded batches are past the deadline,
            # and the next sweep must not select them again
            for batch in stranded:
                self._untrack_inflight(batch)
            self._reverify_batches(stranded)
            path = self._capture_failover_forensics(reason, snapshot)
            with self._failover_mtx:
                self._last_artifact = path

        threading.Thread(target=_recover, name="verifysvc-reverify", daemon=True).start()
        return True

    def _restore_tpu(self) -> None:
        with self._failover_mtx:
            if self._backend_mode != MODE_CPU_FALLBACK:
                return
            self._backend_mode = MODE_TPU
            self._restores += 1
            self._probation_consec_ok = 0
            self._last_restore_at = time.monotonic()
        m = _mhub()
        m.verify_svc_backend_mode.set(_MODE_CODE[MODE_TPU])
        m.verify_svc_failover.inc(direction="to_tpu")
        _flightrec().record("verifysvc_failover", direction="to_tpu")
        tracing.instant("verify.failover", {"direction": "to_tpu"} if tracing.enabled() else None)
        self.logger.warning(f"verify service restored to TPU mode ({self.probation_ok} consecutive probation "
                            "probes ok)")

    def _capture_failover_forensics(self, reason: str, snapshot: dict) -> str | None:
        """One artifact a trip (utils/debugdump.stall_report: the stats
        with the stranded batches' ages, the flight recorder, every
        thread's stack).  Never raises: it runs while degraded."""
        import json as _json

        from ..utils import debugdump

        try:
            sections = [("verify service (at trip)", _json.dumps(snapshot, indent=1, default=str))]
            if tracing.enabled():
                events = tracing.chrome_trace_events()[-256:]
                sections.append(("trace ring (newest 256)", _json.dumps(events, default=str)))
            path = debugdump.stall_report(f"verify-service failover to cpu_fallback: {reason}", sections,
                                          directory=self.artifact_dir)
            _mhub().health_forensics.inc()
            self.logger.warning(f"failover forensics written to {path}")
            return path
        except Exception as e:  # noqa: BLE001 — forensics must never hurt the service
            self.logger.warning(f"failover forensics capture failed: {e!r}")
            return None

    # ------------------------------------------------------------- status

    def stats(self, lock_timeout: float | None = None) -> dict:
        """A snapshot of the queues, the batches in flight (with their
        ages, and how long each has been on the card), the service's
        tallies (batches and signatures dispatched, submits refused, per
        tenant as well) and its failover state.  ``lock_timeout`` bounds
        the wait for the scheduler's lock (forensics of a wedge must not
        block on it): past it the queue section reads ``lock_busy``."""
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
                    "device_age_s": (
                        round(now - rec["device_since"], 3) if rec.get("device_since") is not None else None
                    ),
                }
                for rec in self._inflight.values()
            ]
        acquired = self._cond.acquire() if lock_timeout is None else self._cond.acquire(timeout=lock_timeout)
        if acquired:
            try:
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
            finally:
                self._cond.release()
        else:
            queued = {"lock_busy": True}
            dispatched = dict(self._dispatched)
            dispatched_sigs = dict(self._dispatched_sigs)
            rejected = dict(self._rejected)
        with self._tally_mtx:
            tenants = {t: dict(v) for t, v in self._tenant_tallies.items()}
        with self._failover_mtx:
            failover = {
                "enabled": self.failover_enabled,
                "backend_mode": self._backend_mode,
                "trips": self._trips,
                "restores": self._restores,
                "probation_consec_ok": self._probation_consec_ok,
                "probation_ok_needed": self.probation_ok,
                "batch_deadline_ms": self.batch_deadline_s * 1e3,
                "last_trip_reason": self._last_trip_reason,
                "last_artifact": self._last_artifact,
            }
        return {
            "device": str(self.device),
            "in_flight": in_flight,
            "running": self._running,
            "backend_mode": failover["backend_mode"],
            "failover": failover,
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


def _drain(bv, ticket) -> None:
    """Wait out a settled batch's ticket and drop its result: a comb
    verifier gives its slab back to the pool in collect()."""
    try:
        bv.collect(ticket)
    except BaseException:  # noqa: BLE001 — the tickets were settled already; nothing to report to
        pass


# ---- a client's collect deadline expired: the rate limit of the stall
# artifact, so a storm of timed-out callers writes one report a window
_STALL_MTX = threading.Lock()
_LAST_STALL_REPORT = 0.0
_STALL_REPORT_MIN_INTERVAL_S = 60.0


def _reset_stall_gate() -> None:
    """Tests only: re-arm the stall report's rate limit."""
    global _LAST_STALL_REPORT
    with _STALL_MTX:
        _LAST_STALL_REPORT = 0.0


def report_collect_stall(
    klass: Klass,
    tenant: str,
    nsigs: int,
    waited_s: float,
    service: "VerifyService | None" = None,
    artifact_dir: str | None = None,
) -> str | None:
    """A client's Ticket.collect() deadline expired: the service took the
    submit but did not settle the ticket in time.  Count it, record it
    in the flight recorder and (rate-limited) write a stall artifact
    with the service's own view of its queues and in-flight ages; the
    caller then verifies on the host.  The artifact goes to
    ``artifact_dir``, else the service's, else the temporary directory.
    Returns its path, or None when rate-limited or failed."""
    m = _mhub()
    m.verify_svc_collect_timeout.inc(**{"class": klass.label})
    _flightrec().record("verifysvc_collect_stall", klass=klass.label, tenant=tenant, sigs=nsigs,
                        waited_s=round(waited_s, 3))
    tracing.instant(
        "verify.collect_stall",
        {"class": klass.label, "tenant": tenant, "sigs": nsigs} if tracing.enabled() else None,
    )
    global _LAST_STALL_REPORT
    now = time.monotonic()
    with _STALL_MTX:
        if now - _LAST_STALL_REPORT < _STALL_REPORT_MIN_INTERVAL_S:
            return None
        _LAST_STALL_REPORT = now
    import json as _json

    from ..utils import debugdump

    svcs = [service] if service is not None else list(_GLOBAL.values())
    if artifact_dir is None and service is not None:
        artifact_dir = service.artifact_dir
    sections = []
    if svcs:
        # a bounded lock wait: the stats of a stuck scheduler must not
        # park the diagnosis of its stall
        stats = (svcs[0].stats(lock_timeout=0.5) if len(svcs) == 1
                 else {str(s.device): s.stats(lock_timeout=0.5) for s in svcs})
        sections.append(("verify service (at stall)", _json.dumps(stats, indent=1, default=str)))
    log = logging.getLogger("cometbft_tpu_torch.verifysvc")
    try:
        path = debugdump.stall_report(
            f"verify-service collect() deadline expired: class={klass.label} tenant={tenant} sigs={nsigs} "
            f"after {waited_s:.1f}s (caller degrading to inline host verify)",
            sections,
            directory=artifact_dir,
        )
        m.health_forensics.inc()
        log.error(f"collect stall forensics written to {path}")
        return path
    except Exception as e:  # noqa: BLE001 — forensics must never hurt the caller
        log.warning(f"collect stall forensics capture failed: {e!r}")
        return None


_GLOBAL: dict[str, VerifyService] = {}
_GLOBAL_MTX = threading.Lock()


def global_service(device="cuda") -> VerifyService:
    """The process-wide service of ``device`` (one per resolved device,
    a bare "cuda" pinned to the caller's current card) that every
    client on it shares: one scheduler, one priority order.  The first
    one of a card starts the health sentinel when ``COMETBFT_TPU_HEALTH``
    is on (utils/healthmon.maybe_start, the JAX node's call at its
    start; the port has no node): the watchdog trips on its verdict."""
    dev = _pinned(device)
    with _GLOBAL_MTX:
        svc = _GLOBAL.get(str(dev))
        if svc is None:
            svc = _GLOBAL[str(dev)] = VerifyService(device=dev)
            if dev.type == "cuda":
                healthmon.maybe_start()  # its probe starts CUDA: a CPU service has no card to judge
        return svc


def peek_global_service(device="cuda") -> VerifyService | None:
    """The global service of ``device`` if one exists, without making
    one (a mode decision or a diagnosis must not install a scheduler)."""
    return _GLOBAL.get(str(_pinned(device)))


def reset_global_service() -> None:
    """Stop and drop every global service (tests re-reading knobs, and
    every test that started one)."""
    with _GLOBAL_MTX:
        svcs = list(_GLOBAL.values())
        _GLOBAL.clear()
    for svc in svcs:
        svc.stop()
