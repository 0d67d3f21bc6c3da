"""Client side of the verify service (the port of
cometbft_tpu/verifysvc/client.py).

:class:`ServiceBatchVerifier` keeps the BatchVerifier contract
(crypto/crypto.go:47-55): add() accumulates, verify() / submit() /
collect() resolve.  It hands the batch to the service of its device
instead of driving a verifier itself; crypto/batch.create_batch_verifier
returns one for every key type, so verify_commit, the light client and
every other caller of the factory reach the kernels through the
service's threads.

A refused submit (:class:`~.service.VerifyServiceBackpressure`) is
verified inline on the host, in the caller's thread, through the mode's
host verifier (span ``verify.svc_fallback``): the one host path, an
admission decision.  An error of the batch, or a collect that outlasts
``collect_timeout_s()``, reaches the caller as raised.
"""

from __future__ import annotations

from ..utils import tracing

from .service import (
    MODE_BLS,
    MODE_PLAIN,
    MODE_SECP,
    Klass,
    VerifyService,
    VerifyServiceBackpressure,
    _host_verify_items,
    collect_timeout_s,
    default_tenant,
    global_service,
)


def resolve_mode(pubkeys: list[bytes] | None, key_type: str = "ed25519", *, device="cuda", comb_cache=None):
    """Bind a request to its verifier up front, in the caller's thread,
    where the comb tables' ensure() / ensure_async() cost lands (a
    10,000-key build must never run on the shared scheduler).  Returns
    (mode, device): the device is the one the request's verifier runs
    on, under a mesh the rank's.

    BLS sets take MODE_BLS, the secp key types MODE_SECP, and an ed25519
    set with known pubkeys its comb tables when it has at least
    ``comb_min()`` validators: synchronously below ``comb_async_min()``,
    through a background build at or above it, verifying uncached
    (MODE_PLAIN) until the tables land.  Smaller sets and calls without
    pubkeys take MODE_PLAIN.

    Under an active mesh (models/comb_verifier.active_mesh) every rank
    calls with the same arguments and the comb route ends in
    collectives, so the ranks agree first: at the background-build sizes
    one all_reduce(MIN) of "my tables are ready" decides, and every rank
    verifies uncached until all of them hold their slice.  The agreement
    runs on the comb path's staging thread, after every comb stage this
    thread submitted before it, so a rank's collectives keep one order
    however deep its caller pipelines."""
    from .._device import resolve_device
    from ..crypto import batch as crypto_batch

    dev = resolve_device(device)
    if key_type == "bls12_381":
        return MODE_BLS, dev
    if key_type in crypto_batch.SECP_KEY_TYPES:
        return MODE_SECP, dev
    if pubkeys is None or len(pubkeys) < crypto_batch.comb_min():
        return MODE_PLAIN, dev
    from ..models.comb_verifier import global_cache, placement, run_in_stage_order
    from ..parallel.mesh import all_true

    mesh, dev = placement(dev)
    cache = global_cache() if comb_cache is None else comb_cache
    if len(pubkeys) >= crypto_batch.comb_async_min():
        entry = cache.ensure_async(pubkeys, device=dev)
        ready = entry is not None
        if mesh is not None:
            # one route for every rank, agreed on the collective thread
            ready = run_in_stage_order(lambda: all_true(mesh, ready))
        if not ready:
            return MODE_PLAIN, dev  # tables still building
        return ("comb", entry), dev
    return ("comb", cache.ensure(pubkeys, device=dev)), dev


class ServiceBatchVerifier:
    """BatchVerifier bound to a priority class and tenant of the verify
    service ``service`` (default: the global service of "cuda").

    Exposes the same submit() / collect() seam as the verifiers it
    replaced, so pipelined callers
    (types/validation.submit_verify_commit_light) work unchanged.
    ``last_timings`` holds the last collect's phases (ms): the
    verifier's own, plus the service's ``queue_ms`` (waiting in its
    class queue), ``submit_ms`` and, for a batch that waited on the
    card, ``kernel_ms``."""

    def __init__(
        self,
        klass: Klass = Klass.CONSENSUS,
        mode=MODE_PLAIN,
        service: VerifyService | None = None,
        tenant: str | None = None,
    ):
        self._klass = klass
        self._mode = mode
        self._svc = service
        self._tenant = tenant if tenant is not None else default_tenant()
        self._items: list[tuple[bytes, bytes, bytes]] = []
        self.last_timings: dict[str, float] = {}
        # this batch's span context, made at submit() (or the caller's):
        # the service's threads and the host path run under it
        self._ctx = None

    def __len__(self) -> int:
        return len(self._items)

    @property
    def klass(self) -> Klass:
        return self._klass

    @property
    def tenant(self) -> str:
        return self._tenant

    @property
    def mode(self):
        return self._mode

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        """Shape checks by mode, at add() time as the verifiers do."""
        kind = self._mode[0]
        if kind == "bls":
            # 48-byte compressed G1 pubkey, 96-byte compressed G2 sig
            if len(pub_key) != 48 or len(sig) != 96:
                raise ValueError("malformed bls12-381 pubkey or signature")
        elif kind == "secp":
            # 33-byte compressed (cosmos, r || s), 65-byte uncompressed
            # (eth, R || S || V) or 20-byte address (ecrecover) shapes
            if len(pub_key) not in (20, 33, 65) or len(sig) not in (64, 65):
                raise ValueError("malformed secp256k1 pubkey or signature")
        elif kind == "proof":
            from ..models.proof_server import decode_query

            decode_query((pub_key, msg, sig))
        else:
            if len(pub_key) != 32 or len(sig) != 64:
                raise ValueError("malformed ed25519 pubkey or signature")
            if len(msg) >= 1 << 24:
                # the comb payload's mlen field is 3 bytes
                raise ValueError("message too large for batch verification")
        self._items.append((pub_key, msg, sig))

    def _service(self) -> VerifyService:
        if self._svc is None:
            self._svc = global_service()
        return self._svc

    def _host_fallback(self, span_name: str) -> tuple[bool, list[bool]]:
        """Our items on the mode's host verifier, in add() order."""
        with tracing.context_scope(self._ctx), tracing.span(
            span_name,
            {"class": self._klass.label, "sigs": len(self._items)} if tracing.enabled() else None,
        ):
            return _host_verify_items(self._items, self._mode)

    def submit(self):
        """Enqueue with the service; returns an opaque ticket for
        collect().  A refused submit is verified here, on the host."""
        if not self._items:
            return ("sync", (False, []))
        if tracing.propagation_enabled() and self._ctx is None:
            # the root of this batch's trace, unless the caller runs
            # under one already
            self._ctx = tracing.current_context() or tracing.new_context()
        try:
            with tracing.context_scope(self._ctx):
                return ("svc", self._service().submit(list(self._items), self._klass, self._mode,
                                                      tenant=self._tenant))
        except VerifyServiceBackpressure:
            return ("sync", self._host_fallback("verify.svc_fallback"))

    def collect(self, ticket) -> tuple[bool, list[bool]]:
        """(all_ok, per-signature) in add() order.  Waits at most
        collect_timeout_s(); past it the TimeoutError is raised."""
        kind, payload = ticket
        if kind == "sync":
            return payload
        try:
            result = payload.collect(collect_timeout_s())
        except VerifyServiceBackpressure:
            # stop() failed the queued ticket: the same contract as a
            # refused submit
            return self._host_fallback("verify.svc_fallback")
        self.last_timings = dict(payload.timings)
        return result

    def verify(self) -> tuple[bool, list[bool]]:
        return self.collect(self.submit())

