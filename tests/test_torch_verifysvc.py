"""The port's verify service (cometbft_tpu_torch/verifysvc) against the
JAX package's (cometbft_tpu/verifysvc/service.py, client.py,
checktx.py): the scheduler's choices on the same queued state, the same
admission decisions, each request's verdicts through the service (its
own slice, in its own add() order) against the JAX host path, CheckTx on
all four key types, and the error and stop contracts.

CPU only: device="cpu" runs the kernels' plain versions.  The scheduler
and admission cases drive both services' locked methods with no thread
running; sync fake verifiers stand in wherever only the scheduling is
under test."""

import threading
import time

import numpy as np
import pytest
import torch

from cometbft_tpu.models import proof_server as jproof
from cometbft_tpu.verifysvc import checktx as JC
from cometbft_tpu.verifysvc import service as JS

from cometbft_tpu_torch.crypto import batch
from cometbft_tpu_torch.crypto import bls12381 as bls_host
from cometbft_tpu_torch.crypto import ed25519 as ed_host
from cometbft_tpu_torch.crypto import secp256k1 as secp_host
from cometbft_tpu_torch.crypto import secp256k1eth as eth_host
from cometbft_tpu_torch.models import comb_verifier as cv
from cometbft_tpu_torch.models import proof_server as pproof
from cometbft_tpu_torch.verifysvc import checktx as PC
from cometbft_tpu_torch.verifysvc import service as PS
from cometbft_tpu_torch.verifysvc.client import ServiceBatchVerifier, resolve_mode

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

WAIT = 60.0  # every wait is bounded: a hang fails one test
MODES = [("plain",), ("secp",), ("proof",), ("comb", None), ("bls",)]
LABELS = ["consensus", "blocksync", "mempool", "background", "proof"]


@pytest.fixture
def services():
    """Services made by a test, stopped after it (both packages'), and
    the port's global ones."""
    made = []

    def keep(svc):
        made.append(svc)
        return svc

    yield keep
    for svc in made:
        svc.stop()
    PS.reset_global_service()


def _klass(pkg, label):
    return pkg.Klass[label.upper()]


def _idle_pair(keep, **kw):
    """A port service and a JAX one with the same settings, marked
    running with no thread started: submit() queues, and the test calls
    the scheduler's locked methods itself."""
    weights = kw.pop("weights", {})
    deadlines = kw.pop("deadlines", dict.fromkeys(LABELS, 0))
    out = []
    for pkg, extra in ((PS, {"device": "cpu"}), (JS, {"failover": False})):
        svc = keep(pkg.VerifyService(
            weights={_klass(pkg, k): w for k, w in weights.items()},
            deadlines_ms={_klass(pkg, k): d for k, d in deadlines.items()},
            **kw, **extra))
        svc._running = True
        out.append(svc)
    return out


def _submit(svc, pkg, rid, label, tenant, size, mode, enq):
    """One request of ``size`` dummy rows named by ``rid``; its enqueue
    time set to ``enq``.  -> None, or the refusal's (scope, tenant,
    queued, limit)."""
    items = [(b"%d" % rid, b"%d" % j, b"") for j in range(size)]
    try:
        svc.submit(items, _klass(pkg, label), mode, tenant=tenant)
    except pkg.VerifyServiceBackpressure as e:
        return (e.scope, e.tenant, e.queued, e.limit)
    svc._queues[_klass(pkg, label)][tenant][-1].enq = enq
    return None


def _step(svc, now):
    """One scheduler decision at ``now``: (class, tenant, request ids,
    reason), or (None, seconds to the next deadline)."""
    with svc._cond:
        k = svc._pick_class_locked(now)
        if k is None:
            nxt = svc._next_deadline_locked(now)
            return None, None if nxt is None else round(nxt, 9)
        t = svc._pick_tenant_locked(k, now)
        batch, reason = svc._form_batch_locked(k, t)
    return (k.label, t, [int(r.items[0][0]) for r in batch], reason), batch


def _drive(keep, seed, steps, settle_every=0, **kw):
    """The same seeded submits, scheduler steps and settlements on both
    services -> each one's log of events."""
    svcs = _idle_pair(keep, **kw)
    logs = [[] for _ in svcs]
    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    clock = 0.0
    formed = [[] for _ in svcs]
    for rid in range(steps):
        clock += float(rng.integers(0, 4)) * 1e-3
        op = rng.random()
        label = LABELS[int(rng.integers(0, 5))]
        tenant = "abc"[int(rng.integers(0, 3))]
        size = int(rng.integers(1, 6))
        mode = MODES[int(rng.integers(0, len(MODES)))]
        for i, (svc, pkg) in enumerate(zip(svcs, (PS, JS))):
            if op < 0.6:
                logs[i].append(("submit", rid, _submit(svc, pkg, rid, label, tenant, size, mode, t0 + clock)))
            else:
                ev, batch = _step(svc, t0 + clock)
                logs[i].append(("step", ev))
                if ev is not None:
                    formed[i].append(batch)
            if settle_every and rid % settle_every == 0 and formed[i]:
                for r in formed[i].pop(0):  # release the oldest batch's quota
                    r.ticket._resolve((True, [True] * len(r.items)))
    while True:  # drain, far past every deadline
        evs = [_step(svc, t0 + clock + 60.0)[0] for svc in svcs]
        for i, ev in enumerate(evs):
            logs[i].append(("drain", ev))
        if evs[0] is None:
            break
    for i, svc in enumerate(svcs):
        logs[i].append(("rejected", dict(svc._rejected)))
    return logs


SCHED_CONFIGS = {
    "strict": dict(batch_max=8),
    "class_weights": dict(batch_max=8, weights={"consensus": 3, "mempool": 2, "background": 1}),
    "tenant_weights": dict(batch_max=6, tenant_weights={"a": 3, "b": 1}),
    "deadlines": dict(batch_max=12, deadlines={"consensus": 0, "blocksync": 2, "mempool": 5,
                                               "background": 25, "proof": 5}),
    "wide": dict(batch_max=4096, tenant_weights={"c": 2}),
}


@pytest.mark.parametrize("config", sorted(SCHED_CONFIGS))
def test_scheduler_picks_as_the_jax_service(services, config):
    """Strict or weighted class priority, the tenants' weighted round
    robin, same-mode merging up to the width (comb and BLS alone), the
    flush reasons and the next deadline: equal sequences of (class,
    tenant, request ids, reason) on the same seeded queued state."""
    port, jax = _drive(services, seed=len(config), steps=160, **SCHED_CONFIGS[config])
    assert port == jax
    picked = [e[1] for e in port if e[0] in ("step", "drain") and e[1] and e[1][0] is not None]
    assert len({p[0] for p in picked}) >= 4 and any(len(p[2]) > 1 for p in picked)


ADMISSION_CONFIGS = {
    "class_bound": dict(queue_max=12),
    "tenant_quota": dict(queue_max=40, tenant_quota=7),
    "quota_released_on_settle": dict(queue_max=40, tenant_quota=7, settle_every=3),
    "proof_queue": dict(queue_max=9, settle_every=2),
}


@pytest.mark.parametrize("config", sorted(ADMISSION_CONFIGS))
def test_admission_as_the_jax_service(services, config, monkeypatch):
    """The same bounds refuse the same submit, with the same scope,
    tenant, count and limit; a settled ticket returns its signatures to
    the tenant's quota in both."""
    monkeypatch.setenv("COMETBFT_TPU_PROOF_QUEUE_MAX", "15")
    kw = dict(ADMISSION_CONFIGS[config])
    port, jax = _drive(services, seed=7 + len(config), steps=200, batch_max=5,
                       settle_every=kw.pop("settle_every", 0), **kw)
    assert port == jax
    refusals = [e[2] for e in port if e[0] == "submit" and e[2] is not None]
    assert refusals and sum(port[-1][1].values()) == len(refusals)
    if "tenant_quota" in kw:
        assert {r[0] for r in refusals} == {"tenant", "class"} or {r[0] for r in refusals} == {"tenant"}


def test_weight_parsing_matches_the_jax_service():
    for spec in ("consensus=8,blocksync=4,mempool=2,background=1", "consensus=2,junk,=3,mempool=0,x=1",
                 "", "proof=3, mempool = 2"):
        assert {k.label: w for k, w in PS._parse_weights(spec).items()} == {
            k.label: w for k, w in JS._parse_weights(spec).items()}
    for spec in ("chain-a=4,chain-b=1", "a=0,b=x,=2,c=3", ""):
        assert PS._parse_tenant_weights(spec) == JS._parse_tenant_weights(spec)


def test_knobs_read_the_jax_names_and_defaults(monkeypatch):
    for name in ("BATCH_MAX", "QUEUE_MAX", "TENANT_QUOTA", "DEADLINE_MEMPOOL_MS"):
        monkeypatch.delenv("COMETBFT_TPU_VERIFYSVC_" + name, raising=False)
    svcs = [PS.VerifyService(device="cpu"), JS.VerifyService(failover=False)]
    for svc in svcs:
        svc.stop()
    assert [(s.batch_max, s.queue_max, s.tenant_quota, s._proof_queue_max) for s in svcs] == [
        (4096, 16384, 16384, 8192)] * 2
    assert [{k.label: v for k, v in s._deadline_s.items()} for s in svcs][0] == {
        k.label: v for k, v in svcs[1]._deadline_s.items()}
    assert PS.collect_timeout_s() == JS.collect_timeout_s() == 120.0
    monkeypatch.setenv("COMETBFT_TPU_VERIFYSVC_TENANT", "chain-x")
    monkeypatch.setenv("COMETBFT_TPU_VERIFYSVC_TENANT_QUOTA", "9")
    monkeypatch.setenv("COMETBFT_TPU_VERIFYSVC_DEADLINE_MEMPOOL_MS", "17")
    assert PS.default_tenant() == JS.default_tenant() == "chain-x"
    p, j = PS.VerifyService(device="cpu"), JS.VerifyService(failover=False)
    assert (p.tenant_quota, p._deadline_s[PS.Klass.MEMPOOL]) == (j.tenant_quota, j._deadline_s[JS.Klass.MEMPOOL]) == (
        9, 0.017)


# ------------------------------------------------------------- verdicts


def _ed_items(tag, n, bad=()):
    keys = [ed_host.PrivKey.from_seed(bytes([len(tag) + i + 40]) * 32) for i in range(n)]
    out = []
    for i, k in enumerate(keys):
        m = tag + b"-%d" % i
        out.append((k.pub_key().data, m + (b"!" if i in bad else b""), k.sign(m)))
    return out


def _secp_items(tag, bad=()):
    keys = [secp_host.PrivKey.from_seed(tag + b"c"), eth_host.PrivKey.from_seed(tag + b"e"),
            eth_host.RecoverPrivKey.from_seed(tag + b"r")]
    out = []
    for i, k in enumerate(keys):
        m = tag + b"-%d" % i
        out.append((k.pub_key().data, m + (b"!" if i in bad else b""), k.sign(m)))
    return out


def _bls_items():
    keys = [bls_host.PrivKey(sk) for sk in (3, 5, 7)]
    msg = b"agg-commit"
    agg = bls_host.aggregate_signatures([k.sign(msg) for k in keys])
    commit = [(k.pub_key().data, msg, agg) for k in keys]
    solo = [(keys[0].pub_key().data, b"solo", keys[0].sign(b"solo")),
            (keys[1].pub_key().data, b"solo2", keys[0].sign(b"solo2"))]  # wrong signer
    return [commit, solo]


def _proof_requests():
    leaves = [b"leaf-%d" % i for i in range(21)]
    digest = pproof.register_tree(leaves)
    assert jproof.register_tree(leaves) == digest
    q = lambda i: pproof.encode_query(digest, i)  # noqa: E731
    return [[q(0), q(20), q(7)], [q(3), q(3), q(21)], [(b"\x01" * 32, (5).to_bytes(8, "big"), b""), q(11)]]


def _jax_mode(mode):
    return {"plain": JS.MODE_PLAIN, "comb": JS.MODE_PLAIN, "secp": JS.MODE_SECP, "bls": JS.MODE_BLS,
            "proof": JS.MODE_PROOF}[mode[0]]


def _plain(row):
    """A proof row as plain values (Proof objects differ by package)."""
    if isinstance(row, bool) or row is None:
        return row
    return (row.total, row.index, row.leaf_hash, list(row.aunts))


def _submit_together(svc, klass, mode, requests):
    """Each request through its own ServiceBatchVerifier, submitted from
    its own thread at once -> each one's (all_ok, rows), in order."""
    out = [None] * len(requests)
    gate = threading.Barrier(len(requests))

    def run(i):
        bv = ServiceBatchVerifier(klass, mode, service=svc)
        for it in requests[i]:
            bv.add(*it)
        gate.wait(WAIT)
        out[i] = bv.verify()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert all(o is not None for o in out)
    return out


@pytest.mark.parametrize("kind", ["plain", "comb", "secp", "proof", "bls"])
def test_service_verdicts_match_the_jax_host_path(services, kind, monkeypatch):
    """Requests from several threads through ServiceBatchVerifier on
    device="cpu": merged into one batch in the coalescible modes (plain,
    secp, proof), one batch a request for comb and BLS; every request's
    verdicts, in its own order, equal the JAX package's host path
    (_host_verify_items) on that request alone."""
    monkeypatch.setenv("COMETBFT_TPU_PROOF_DEVICE_MIN", "1")  # the K7 -> K8 -> K9 route's plain versions
    klass = PS.Klass.MEMPOOL
    if kind == "plain":
        requests = [_ed_items(b"p%d" % i, 2 + i, bad=(i,)) for i in range(3)]
        mode = PS.MODE_PLAIN
    elif kind == "comb":
        monkeypatch.setenv("COMETBFT_TPU_COMB_MIN", "2")
        items = _ed_items(b"comb", 6, bad=(4,))
        mode, _ = resolve_mode([p for p, _, _ in items], device="cpu", comb_cache=cv.ValsetCombCache())
        assert mode[0] == "comb"
        requests = [items, items[:3], [items[5], items[1]]]
        klass = PS.Klass.CONSENSUS
    elif kind == "secp":
        requests = [_secp_items(b"s1", bad=(1,)), _secp_items(b"s2", bad=(2,))]
        mode = PS.MODE_SECP
    elif kind == "proof":
        requests = _proof_requests()
        mode, klass = PS.MODE_PROOF, PS.Klass.PROOF
    else:
        requests = _bls_items()
        mode = PS.MODE_BLS
    solo = kind in ("comb", "bls")
    # coalescible modes: the class flushes "full" once every request is
    # queued (the width is their total), however late a thread runs;
    # solo modes dispatch at once
    svc = services(PS.VerifyService(
        batch_max=None if solo else sum(map(len, requests)),
        deadlines_ms=dict.fromkeys(PS.Klass, 0 if solo else 60_000), device="cpu"))
    got = _submit_together(svc, klass, mode, requests)
    for req, (ok, rows) in zip(requests, got):
        jok, jrows = JS._host_verify_items(req, _jax_mode(mode))
        assert ok == jok and [_plain(r) for r in rows] == [_plain(r) for r in jrows]
    assert any(not ok for ok, _ in got) and any(any(r for r in rows) for _, rows in got)
    stats = svc.stats()
    assert stats["dispatched_batches"][klass.label] == (len(requests) if solo else 1)
    assert stats["dispatched_sigs"][klass.label] == sum(map(len, requests))
    assert not any(stats["rejected"].values()) and not stats["in_flight"]


class _FakeBV:
    """A sync verifier: a row is valid when its message ends in b"ok"."""

    def __init__(self, log=None):
        self.items = []
        self.log = log

    def add(self, pub, msg, sig):
        self.items.append((pub, msg, sig))

    def submit(self):
        if self.log is not None:
            self.log.append(len(self.items))
        res = [m.endswith(b"ok") for _, m, _ in self.items]
        return ("sync", (all(res), res))

    def collect(self, ticket):
        return ticket[1]


def test_single_row_requests_merge_and_split_back(services):
    """48 one-row MEMPOOL requests from 16 threads merge into a few
    batches (fake verifier), and every ticket gets its own row's
    verdict back."""
    svc = services(PS.VerifyService(device="cpu", deadlines_ms={PS.Klass.MEMPOOL: 100}))
    sizes = []
    svc._make_verifier = lambda mode: _FakeBV(sizes)
    got = {}

    def sender(t):
        for j in range(3):
            msg = b"tx-%d-%d-" % (t, j) + (b"ok" if (t + j) % 3 else b"no")
            _, per = svc.verify([(b"k", msg, b"s")], PS.Klass.MEMPOOL, PS.MODE_SECP)
            got[msg] = per

    threads = [threading.Thread(target=sender, args=(t,)) for t in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert len(got) == 48 and all(per == [m.endswith(b"ok")] for m, per in got.items())
    assert sum(sizes) == 48 and len(sizes) < 48 and max(sizes) > 1
    assert svc.stats()["dispatched_batches"]["mempool"] == len(sizes)


def test_concurrent_submits_keep_the_quota_books(services):
    """32 threads (more than the cores) submit one-row requests of two
    tenants and three classes under a tenant quota, with the interpreter
    switching threads every microsecond: every admitted ticket settles
    with its own row's verdict, every refusal is counted once, and the
    outstanding-signature books return to empty (a lost update of the
    quota's read-modify-write would leave a count behind)."""
    import sys

    svc = services(PS.VerifyService(device="cpu", tenant_quota=3, deadlines_ms=dict.fromkeys(PS.Klass, 1)))
    svc._make_verifier = lambda mode: _FakeBV()
    admitted, refused, wrong = [], [], []
    classes = (PS.Klass.CONSENSUS, PS.Klass.MEMPOOL, PS.Klass.BACKGROUND)

    def run(t):
        for j in range(20):
            msg = b"%d-%d-" % (t, j) + (b"ok" if (t + j) % 2 else b"no")
            try:
                ticket = svc.submit([(b"k", msg, b"s")], classes[j % 3], PS.MODE_SECP, tenant="ab"[t % 2])
            except PS.VerifyServiceBackpressure:
                refused.append(msg)
                continue
            admitted.append(msg)
            if ticket.collect(WAIT)[1] != [msg.endswith(b"ok")]:
                wrong.append(msg)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not wrong
    assert len(admitted) + len(refused) == 32 * 20 and refused
    stats = svc.stats()
    assert sum(stats["dispatched_sigs"].values()) == len(admitted)
    assert sum(stats["rejected"].values()) == len(refused) == sum(t["rejected"] for t in stats["tenants"].values())
    assert all(not d for d in svc._outstanding_sigs.values())


def test_host_queue_respects_class_priority_as_the_jax_service(services):
    """With the host worker busy, later-queued consensus work overtakes
    earlier-queued mempool and background work, in both services."""
    orders = []
    for pkg, extra in ((PS, {"device": "cpu"}), (JS, {"failover": False})):
        s = services(pkg.VerifyService(deadlines_ms={k: 0 for k in pkg.Klass}, **extra))
        gate = threading.Event()
        run_order = []

        class Parked(_FakeBV):
            _entry = None  # the JAX service's mark of a submit it offloads

            def submit(self):
                if not run_order:
                    gate.wait(WAIT)  # the first task parks the worker
                run_order.append(self.items[0][1].split(b"-")[0].decode())
                return ("sync", (True, [True] * len(self.items)))

        s._make_verifier = lambda mode: Parked()
        tickets = [s.submit([(b"k", b"bg1-ok", b"s")], pkg.Klass.BACKGROUND)]
        time.sleep(0.3)
        for tag, label in ((b"mp", "mempool"), (b"bg2", "background"), (b"cs", "consensus")):
            tickets.append(s.submit([(b"k", tag + b"-ok", b"s")], _klass(pkg, label)))
            time.sleep(0.3)
        gate.set()
        for t in tickets:
            assert t.collect(WAIT) == (True, [True])
        orders.append(run_order)
    assert orders[0] == orders[1] == ["bg1", "cs", "mp", "bg2"]


# ----------------------------------------------------------------- CheckTx


CHECKTX_KEYS = {
    "ed25519": lambda: ed_host.PrivKey.from_seed(b"\x05" * 32),
    "secp256k1": lambda: secp_host.PrivKey.from_seed(b"ctx-c"),
    "secp256k1eth": lambda: eth_host.PrivKey.from_seed(b"ctx-e"),
    "ecrecover": lambda: eth_host.RecoverPrivKey.from_seed(b"ctx-r"),
}


def test_checktx_verdicts_match_the_jax_package(services, cpu_crypto_backend):
    """verify_tx_signature on a good and a tampered envelope of every key
    type, the secp ones sent at once from six threads, then the ed25519
    ones from two: one MEMPOOL batch a mode (each service's width is its
    txs, so the class flushes once all are queued), verdicts equal to the
    JAX package's (its host path under the cpu backend); an unsigned tx
    is None in both."""
    txs = []
    for kt, mk in CHECKTX_KEYS.items():
        tx = PC.make_signed_tx(mk(), b"payload of " + kt.encode())
        txs += [tx, tx[:-1] + bytes([tx[-1] ^ 1])]
    got = [None] * len(txs)
    svcs = []
    for idx in (range(2, 8), range(2)):  # one mode at a time: merging keeps to runs of one mode
        gate = threading.Barrier(len(idx))
        svc = services(PS.VerifyService(device="cpu", batch_max=len(idx),
                                        deadlines_ms={PS.Klass.MEMPOOL: 60_000}))
        svcs.append(svc)

        def run(i, gate=gate, svc=svc):
            gate.wait(WAIT)
            got[i] = PC.verify_tx_signature(txs[i], service=svc)

        threads = [threading.Thread(target=run, args=(i,)) for i in idx]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    want = [JC.verify_tx_signature(tx) for tx in txs]
    assert got == want == [True, False] * 4
    assert PC.verify_tx_signature(b"plain tx", service=svc) is JC.verify_tx_signature(b"plain tx") is None
    assert [(s.stats()["dispatched_batches"]["mempool"], s.stats()["dispatched_sigs"]["mempool"])
            for s in svcs] == [(1, 6), (1, 2)]


def test_checktx_host_path_on_backpressure(services, cpu_crypto_backend):
    """A refused CheckTx is checked on the host, with the verdict the JAX
    package gives; the refusal is counted."""
    svc = services(PS.VerifyService(device="cpu", tenant_quota=1, queue_max=8,
                                    deadlines_ms={PS.Klass.MEMPOOL: 60_000}))
    sk = CHECKTX_KEYS["ed25519"]()
    parked = svc.submit([(b"k", b"m", b"s")], PS.Klass.MEMPOOL, tenant="rogue")
    good = PC.make_signed_tx(sk, b"quota")
    bad = good[:-1] + bytes([good[-1] ^ 1])
    for tx in (good, bad):
        assert PC.verify_tx_signature(tx, service=svc, tenant="rogue") is JC.verify_tx_signature(tx)
    assert svc.stats()["rejected"]["mempool"] == 2
    assert svc.stats()["tenants"]["rogue"]["rejected"] == 2
    svc.stop()
    with pytest.raises(PS.VerifyServiceBackpressure):
        parked.collect(WAIT)


# ----------------------------------------------------- errors and stop


class _Boom(RuntimeError):
    pass


def _faulty_bv(where):
    """A fake verifier class whose dispatch, submit or collect fails."""

    class Faulty(_FakeBV):
        _entry = None

        def submit(self):
            if where == "submit":
                raise _Boom("submit failed")
            return ("dev", None) if where == "collect" else super().submit()

        def collect(self, ticket):
            if where == "collect":
                raise _Boom("collect failed")
            return super().collect(ticket)

    def make(mode):
        if where == "dispatch":
            raise _Boom("dispatch failed")
        return Faulty()

    return make


@pytest.mark.parametrize("where", ["dispatch", "submit", "collect"])
def test_errors_are_verified_again_on_the_host_as_the_jax_service(services, where, tmp_path):
    """With failover on (the default of both packages), a dispatch,
    submit or collect error sends the batch to the host path: the same
    verdicts as the JAX service, in each request's add() order, the same
    count of host re-verifies by cause, no trip; the scheduler keeps
    serving."""
    from cometbft_tpu.utils.metrics import hub as jhub

    from cometbft_tpu_torch.utils.metrics import hub as phub

    cause = {"dispatch": "dispatch_error", "submit": "submit_error", "collect": "collect_error"}[where]
    items = _ed_items(b"again", 3, bad=(1,))
    got = {}
    for pkg, hub, extra in ((PS, phub, {"device": "cpu"}), (JS, jhub, {})):
        s = services(pkg.VerifyService(deadlines_ms={k: 30 for k in pkg.Klass}, failover=True,
                                       artifact_dir=str(tmp_path), **extra))
        s._make_verifier = _faulty_bv(where)
        before = hub().verify_svc_host_reverify.value(cause=cause)
        tickets = [s.submit([it], pkg.Klass.CONSENSUS, pkg.MODE_PLAIN) for it in items]
        res = [t.collect(WAIT) for t in tickets]
        got[pkg] = (res, hub().verify_svc_host_reverify.value(cause=cause) - before,
                    s.stats()["failover"]["trips"], s.backend_mode)
        s._make_verifier = lambda mode: _FakeBV()
        assert s.submit([(b"k", b"after-ok", b"s")], pkg.Klass.CONSENSUS).collect(WAIT) == (True, [True])
    assert got[PS] == got[JS]
    res, reverified, trips, mode = got[PS]
    assert res == [(True, [True]), (False, [False]), (True, [True])]
    assert reverified >= 1 and trips == 0 and mode == "tpu"


@pytest.mark.parametrize("where", ["dispatch", "submit", "collect"])
def test_errors_fail_the_tickets_as_the_jax_service(services, where):
    """With failover off, a dispatch, submit or collect error fails every
    ticket of the batch with that error, in both services, and the
    scheduler keeps serving."""
    for pkg, extra in ((PS, {"device": "cpu", "failover": False}), (JS, {"failover": False})):
        s = services(pkg.VerifyService(deadlines_ms={k: 30 for k in pkg.Klass}, **extra))

        s._make_verifier = _faulty_bv(where)
        tickets = [s.submit([(b"k", b"m%d-ok" % i, b"s")], pkg.Klass.MEMPOOL, pkg.MODE_SECP) for i in range(3)]
        for t in tickets:
            with pytest.raises(_Boom, match=f"{where} failed"):
                t.collect(WAIT)
        s._make_verifier = lambda mode: _FakeBV()
        assert s.submit([(b"k", b"after-ok", b"s")], pkg.Klass.CONSENSUS).collect(WAIT) == (True, [True])


def test_stop_fails_stranded_tickets_as_the_jax_service(services):
    for pkg, extra in ((PS, {"device": "cpu"}), (JS, {"failover": False})):
        s = services(pkg.VerifyService(deadlines_ms={k: 60_000 for k in pkg.Klass}, **extra))
        t = s.submit([(b"k", b"strand", b"s")], pkg.Klass.MEMPOOL)
        s.stop()
        with pytest.raises(pkg.VerifyServiceBackpressure):
            t.collect(WAIT)
        with pytest.raises(pkg.VerifyServiceBackpressure):
            t.collect(0)
        assert s.submit([], pkg.Klass.MEMPOOL).collect(0) == (False, [])


def test_collect_timeout_reports_the_stall_and_takes_the_host_path(services, monkeypatch, tmp_path):
    """Past COMETBFT_TPU_VERIFYSVC_COLLECT_TIMEOUT_MS a ServiceBatchVerifier
    and a CheckTx check leave stall forensics (one artifact, rate-limited)
    and verify on the host, with the JAX client's verdicts; the service's
    late answer is dropped."""
    import tempfile

    from cometbft_tpu.verifysvc.client import ServiceBatchVerifier as JClient

    from cometbft_tpu_torch.utils.metrics import hub as phub

    monkeypatch.setenv("COMETBFT_TPU_VERIFYSVC_COLLECT_TIMEOUT_MS", "200")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "jax"))  # the JAX client's artifacts
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    release = threading.Event()

    class Stuck(_FakeBV):
        _entry = object()  # submits on the scheduler: the wait is the collector's

        def submit(self):
            return ("dev", super().submit()[1])

        def collect(self, ticket):
            release.wait(WAIT)
            return ticket[1]

    items = _ed_items(b"stuck", 3, bad=(2,))
    tx = PC.make_signed_tx(CHECKTX_KEYS["ed25519"](), b"t")
    got = {}
    for pkg, client, ctx in ((PS, ServiceBatchVerifier, PC), (JS, JClient, JC)):
        pkg._reset_stall_gate()
        extra = {"device": "cpu", "artifact_dir": str(tmp_path / "port")} if pkg is PS else {}
        svc = services(pkg.VerifyService(failover=False, **extra))
        svc._make_verifier = lambda mode: Stuck()
        before = phub().verify_svc_collect_timeout.value(**{"class": "consensus"})
        bv = client(pkg.Klass.CONSENSUS, pkg.MODE_PLAIN, service=svc)
        for it in items:
            bv.add(*it)
        got[pkg] = (bv.verify(), ctx.verify_tx_signature(tx, service=svc))
        if pkg is PS:
            assert phub().verify_svc_collect_timeout.value(**{"class": "consensus"}) == before + 1
    release.set()
    assert got[PS] == got[JS] == (JS._host_verify_items(items), True)
    arts = list((tmp_path / "port").iterdir())
    assert len(arts) == 1 and "collect() deadline expired: class=consensus" in arts[0].read_text()
    assert len(list((tmp_path / "jax").iterdir())) == 1


def test_client_backpressure_takes_the_host_path(services):
    """A ServiceBatchVerifier refused by the class bound verifies its
    own items on the host, in add() order, with the JAX host verdicts."""
    svc = services(PS.VerifyService(device="cpu", queue_max=2))
    items = _ed_items(b"bp", 3, bad=(1,))
    bv = ServiceBatchVerifier(PS.Klass.CONSENSUS, PS.MODE_PLAIN, service=svc, tenant="t1")
    for it in items:
        bv.add(*it)
    assert bv.verify() == JS._host_verify_items(items) == (False, [True, False, True])
    assert svc.stats()["rejected"]["consensus"] == 1 and svc.stats()["tenants"]["t1"]["rejected"] == 1
    with pytest.raises(ValueError):
        ServiceBatchVerifier(PS.Klass.CONSENSUS, PS.MODE_SECP, service=svc).add(b"x" * 32, b"m", b"s" * 64)
    with pytest.raises(ValueError):
        ServiceBatchVerifier(PS.Klass.PROOF, PS.MODE_PROOF, service=svc).add(b"x" * 31, bytes(8), b"")


def test_global_service_is_one_per_device(services):
    a, b = PS.global_service("cpu"), PS.global_service(torch.device("cpu"))
    assert a is b and a.device == torch.device("cpu")
    PS.reset_global_service()
    assert PS.global_service("cpu") is not a
    bv = batch.create_batch_verifier("ed25519", device="cpu", klass=PS.Klass.BLOCKSYNC, tenant="t9")
    assert (bv.klass, bv.tenant, bv.mode) == (PS.Klass.BLOCKSYNC, "t9", PS.MODE_PLAIN)
