"""The service's clients and the comb path's staging thread, on the CPU
(device="cpu": the kernels' plain versions), against the JAX package:

  * blocksync/replay.CommitStreamVerifier: the port of
    tests/test_blocksync_replay.py::test_commit_stream_pipeline_order_and_blame
    on 8 and 64 validators at depths 1, 2 and 4 — order, blame, absent
    rows, a foreign key's demotion — held against the JAX service's host
    verdicts (tier-1) and the JAX CommitStreamVerifier (slow: its comb
    program compiles for ~66 s cold);
  * blocksync/replay.verify_ahead against the JAX serial
    verify_commit_light, height by height;
  * models/comb_verifier's staging thread: submission order across
    threads, a failed fill, an add() after submit(), a first-use race;
  * the verify service's offload rule against the JAX
    _submit_is_offloaded, and where each submit runs;
  * models/proof_server.prove / _assemble against the JAX prove on its
    host path: plain, refused, timed out, evicted.

Tolerance: none — verdict lists, blame strings, roots and proof bytes
are equal."""

import copy
import threading
import time
import types

import pytest
import torch

import cometbft_tpu.types as JT
from cometbft_tpu.blocksync.replay import CommitStreamVerifier as JCommitStreamVerifier
from cometbft_tpu.crypto import ed25519 as jhost
from cometbft_tpu.crypto import merkle as jcm
from cometbft_tpu.models import comb_verifier as jcv
from cometbft_tpu.models import proof_server as jproof
from cometbft_tpu.types import validation as jvalidation
from cometbft_tpu.verifysvc import service as JS
from cometbft_tpu.wire.canonical import PRECOMMIT_TYPE as J_PRECOMMIT
from cometbft_tpu.wire.canonical import Timestamp as JTimestamp

import cometbft_tpu_torch.types as PT
from cometbft_tpu_torch.blocksync import CommitStreamVerifier, verify_ahead
from cometbft_tpu_torch.crypto import ed25519 as host
from cometbft_tpu_torch.models import comb_verifier as cv
from cometbft_tpu_torch.models import proof_server as pproof
from cometbft_tpu_torch.verifysvc import service as PS
from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE as P_PRECOMMIT
from cometbft_tpu_torch.wire.canonical import Timestamp as PTimestamp

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

WAIT = 60.0  # every wait is bounded: a hang fails one test
SIZES = [8, 64]
DEPTHS = [1, 2, 4]


@pytest.fixture(autouse=True)
def _stop_services():
    """Each test stops the verify services its clients started."""
    yield
    PS.reset_global_service()


def _keys(n):
    """The JAX test's keys (seeds 30..) for its 8 validators, more past them."""
    return [host.PrivKey.from_seed(bytes([i + 30]) * 32) for i in range(n)]


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"v{n}")
def stream_set(request):
    """(keys, pubs, a comb entry on the CPU) for n validators."""
    keys = _keys(request.param)
    pubs = [k.pub_key().data for k in keys]
    return keys, pubs, cv.ValsetCombCache().ensure(pubs, device="cpu")


def _commit(keys, pubs, h, tamper=None):
    """The JAX test's commit at height h: one signature a key, the
    tampered row's message changed after signing."""
    items = []
    for i, sk in enumerate(keys):
        msg = b"replay-%d-%d" % (h, i)
        sig = sk.sign(msg)
        if i == tamper:
            msg += b"!"
        items.append((pubs[i], msg, sig))
    return items


def _alien():
    a = host.PrivKey.from_seed(bytes([99]) * 32)
    return (a.pub_key().data, b"alien", a.sign(b"alien"))


def _stream_commits(keys, pubs):
    """Five blocks (block 2 tampered at row 3), a block of the first five
    rows (the rest absent), and a block with a foreign key."""
    commits = [_commit(keys, pubs, h, tamper=3 if h == 2 else None) for h in range(5)]
    return commits + [commits[0][:5], commits[1][:4] + [_alien()], commits[3]]


@pytest.mark.parametrize("depth", DEPTHS)
def test_commit_stream_pipeline_order_and_blame(stream_set, depth):
    """Every block's (all_ok, per-signature) in block order, equal to the
    JAX service's host verdicts on that block: the tampered row blamed
    alone, the subset commit verified on its own rows, the foreign key's
    block demoted (uncached) in its place while the blocks around it stay
    on the comb route."""
    keys, pubs, entry = stream_set
    commits = _stream_commits(keys, pubs)
    svc = PS.VerifyService(device="cpu")
    launches = []
    real_submit = cv.CombBatchVerifier.submit

    def spy(self):
        launches.append("demoted" if self._fallback is not None else "comb")
        return real_submit(self)

    cv.CombBatchVerifier.submit = spy
    try:
        outs = list(CommitStreamVerifier(entry, depth=depth, service=svc).run(iter(commits)))
    finally:
        cv.CombBatchVerifier.submit = real_submit
        svc.stop()
    assert outs == [JS._host_verify_items(c) for c in commits]
    n = len(keys)
    assert outs[2] == (False, [i != 3 for i in range(n)])
    assert outs[5] == (True, [True] * 5) and outs[6] == (True, [True] * 5)
    assert all(outs[h] == (True, [True] * n) for h in (0, 1, 3, 4, 7))
    assert launches == ["comb"] * 6 + ["demoted", "comb"]
    st = svc.stats()
    assert st["dispatched_batches"]["blocksync"] == len(commits) and not any(st["rejected"].values())


def test_depth_is_clamped_and_the_service_is_the_entrys(stream_set):
    """depth < 1 runs at 1; without a service the stream uses the global
    service of the entry's device under BLOCKSYNC."""
    keys, pubs, entry = stream_set
    csv = CommitStreamVerifier(entry, depth=0)
    assert csv._depth == 1
    commits = [_commit(keys, pubs, h) for h in range(3)]
    assert list(csv.run(commits)) == [(True, [True] * len(keys))] * 3
    assert PS.global_service("cpu").stats()["dispatched_batches"]["blocksync"] == 3


@pytest.mark.slow  # the JAX comb program compiles for ~66 s cold on the CPU
@pytest.mark.usefixtures("tiny_device_batches")
def test_commit_stream_matches_the_jax_stream_verifier():
    keys = _keys(8)
    pubs = [k.pub_key().data for k in keys]
    commits = _stream_commits(keys, pubs)
    entry = cv.ValsetCombCache().ensure(pubs, device="cpu")
    jentry = jcv.ValsetCombCache().ensure(pubs)
    try:
        for depth in DEPTHS:
            got = list(CommitStreamVerifier(entry, depth=depth, service=PS.global_service("cpu")).run(commits))
            want = list(JCommitStreamVerifier(jentry, depth=depth).run(iter(commits)))
            assert got == want
    finally:
        JS.reset_global_service()


# ------------------------------------------------------------- verify_ahead


CHAIN = "replay-chain"


def _chain(T, hst, precommit, Timestamp, n_blocks, n_vals, tamper):
    """n_blocks commits of one n_vals-validator set, either package;
    ``tamper`` maps a block to the row whose signature byte flips."""
    keys = [hst.PrivKey.from_seed(bytes([i + 70]) * 32) for i in range(n_vals)]
    vals = T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in keys])
    by_addr = {k.pub_key().address(): k for k in keys}
    out = []
    for b in range(n_blocks):
        height = 10 + b
        bid = T.BlockID(hash=bytes([b]) * 32, part_set_header=T.PartSetHeader(total=1, hash=bytes([b + 1]) * 32))
        sigs = []
        for i, v in enumerate(vals.validators):
            vote = T.Vote(type=precommit, height=height, round=0, block_id=bid,
                          timestamp=Timestamp(seconds=1_700_000_000 + height, nanos=i),
                          validator_address=v.address, validator_index=i)
            sig = by_addr[v.address].sign(vote.sign_bytes(CHAIN))
            if tamper.get(b) == i:
                sig = sig[:-1] + bytes([sig[-1] ^ 1])
            vote.signature = sig
            sigs.append(vote.to_commit_sig())
        out.append((bid, height, T.Commit(height=height, round=0, block_id=bid, signatures=sigs)))
    return vals, out


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under comparison
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("depth", DEPTHS)
def test_verify_ahead_matches_the_jax_serial_check(depth, monkeypatch, cpu_crypto_backend):
    """The reactor's verify-ahead over 6 heights (two tampered, one with
    a wrong height) gives, height by height and in order, what the JAX
    package's serial verify_commit_light gives (exception type and
    message, the blamed index in it), the comb route for every batch."""
    monkeypatch.setenv("COMETBFT_TPU_COMB_MIN", "4")
    tamper = {1: 5, 4: 0}
    jvals, jchain = _chain(JT, jhost, J_PRECOMMIT, JTimestamp, 6, 8, tamper)
    pvals, pchain = _chain(PT, host, P_PRECOMMIT, PTimestamp, 6, 8, tamper)
    # the block at index 3 claims the wrong height: a submit-time refusal
    pchain[3] = (pchain[3][0], 99, pchain[3][2])
    jchain[3] = (jchain[3][0], 99, jchain[3][2])
    want = [(h, _outcome(lambda: jvalidation.verify_commit_light(CHAIN, jvals, bid, h, c)))
            for bid, h, c in jchain]
    cache = cv.ValsetCombCache()
    got = list(verify_ahead(CHAIN, pvals, pchain, depth, device="cpu", comb_cache=cache))
    assert [(h, None if e is None else (type(e).__name__, str(e))) for h, _, e in got] == want
    assert [r for _, r, _ in got] == ["comb", "comb", "comb", "serial", "comb", "comb"]
    assert want[1][1][0] == "CommitVerificationError" and "(#5)" in want[1][1][1]
    assert PS.global_service("cpu").stats()["dispatched_batches"]["blocksync"] == 5


# ------------------------------------------------------------ staging thread


def _msg_id(items) -> bytes:
    return items[0][1].split(b"-")[1]


def test_staging_runs_tickets_in_submission_order(stream_set):
    """16 batches submitted from 4 threads: the stages run in the order
    the submits returned, and every collect has its own batch's verdicts."""
    keys, pubs, entry = stream_set
    order_lock = threading.Lock()
    submitted, staged, results = [], [], {}
    real_fill = cv._fill_payload

    def logged_fill(slab, items, rows):
        staged.append(_msg_id(items))
        return real_fill(slab, items, rows)

    def sender(t):
        for j in range(4):
            h = 4 * t + j
            bv = cv.CombBatchVerifier(entry)
            for it in _commit(keys, pubs, h, tamper=t):
                bv.add(*it)
            with order_lock:
                ticket = bv.submit()
                submitted.append(b"%d" % h)
            results[h] = bv.collect(ticket)

    cv._fill_payload = logged_fill
    try:
        threads = [threading.Thread(target=sender, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT)
    finally:
        cv._fill_payload = real_fill
    assert not any(th.is_alive() for th in threads)
    assert len(submitted) == 16 and staged == submitted
    n = len(keys)
    assert all(results[h] == (False, [i != h // 4 for i in range(n)]) for h in range(16))


def test_a_failed_fill_reaches_collect_and_retires_its_slab(stream_set):
    """A fault planted in the fill: submit() still returns a ticket, the
    error reaches collect(), and the slab goes back to the entry's pool
    retired (no live row, no layout kept); through the service the
    batch's ticket fails with it (ROADMAP C)."""
    keys, pubs, entry = stream_set
    items = _commit(keys, pubs, 40)
    width = cv._payload_width(items)
    real_fill = cv._fill_payload

    def faulty_fill(slab, items_, rows):
        real_fill(slab, items_, rows)
        raise RuntimeError("fill failed")

    entry._slabs.pop(width, None)
    cv._fill_payload = faulty_fill
    try:
        bv = cv.CombBatchVerifier(entry)
        for it in items:
            bv.add(*it)
        ticket = bv.submit()
        assert ticket[0] == "dev"
        with pytest.raises(RuntimeError, match="fill failed"):
            bv.collect(ticket)
        (slab,) = entry._slabs[width]
        assert slab.layout is None and slab.dirty is None and not slab.buf[:, 67].any()
        svc = PS.VerifyService(device="cpu")
        try:
            t = svc.submit(items, PS.Klass.BLOCKSYNC, ("comb", entry))
            with pytest.raises(RuntimeError, match="fill failed"):
                t.collect(WAIT)
        finally:
            svc.stop()
    finally:
        cv._fill_payload = real_fill
    bv = cv.CombBatchVerifier(entry)  # the retired slab serves the next batch
    for it in items:
        bv.add(*it)
    assert bv.verify() == (True, [True] * len(keys))


def test_submit_returns_before_the_fill_and_a_late_add_leaves_the_ticket(stream_set, monkeypatch):
    """With the staging thread held, submit() returns a ticket while the
    payload is still unfilled; the stage then reads the items as they
    were at submit(), so a late add() (a bad row) changes nothing."""
    keys, pubs, entry = stream_set
    fills = []
    real_fill = cv._fill_payload
    monkeypatch.setattr(cv, "_fill_payload", lambda *a: fills.append(1) or real_fill(*a))
    gate = threading.Event()
    lane = cv._staging_executor()
    held = lane.put(lambda: gate.wait(WAIT))
    bv = cv.CombBatchVerifier(entry)
    items = _commit(keys, pubs, 41)
    for it in items[:-1]:
        bv.add(*it)
    ticket = bv.submit()
    assert ticket[0] == "dev" and not fills
    bv.add(items[-1][0], items[-1][1] + b"late", items[-1][2])
    gate.set()
    held.result(WAIT)
    assert bv.collect(ticket) == (True, [True] * (len(keys) - 1)) and fills == [1]


def test_racing_first_uses_make_one_worker(monkeypatch):
    """Eight threads meet the staging executor for the first time at
    once (its construction held for 50 ms to widen the race): one lane, one
    worker thread runs every job."""
    made = []

    class SlowLane(cv.StagingLane):
        def __init__(self):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.05:  # the other threads run meanwhile
                pass
            made.append(self)
            super().__init__()

    monkeypatch.setattr(cv, "StagingLane", SlowLane)
    monkeypatch.setattr(cv, "_STAGING", None)
    gate = threading.Barrier(8)
    got = [None] * 8

    def first_use(i):
        gate.wait(WAIT)
        lane = cv._staging_executor()
        got[i] = (lane, lane.run(threading.get_ident))

    threads = [threading.Thread(target=first_use, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(WAIT)
    assert len(made) == 1
    assert len({id(lane) for lane, _ in got}) == 1 and len({ident for _, ident in got}) == 1
    assert made[0]._thread.name == "comb-stage_0"


def test_staging_lane_runs_reserved_numbers_in_order():
    """Numbers taken first run first, whichever thread hands the job
    over and when; a released number is skipped; a spent one refused."""
    lane = cv.StagingLane(name="lane-test")
    ran = []
    a, b, c = lane.reserve(), lane.reserve(), lane.reserve()
    fc = lane.put(lambda: ran.append("c"), c)
    fb = lane.put(lambda: ran.append("b"), b)
    time.sleep(0.1)
    assert ran == []  # a is still out
    lane.release(a)
    fb.result(WAIT), fc.result(WAIT)
    assert ran == ["b", "c"]
    assert lane.run(lambda: 7) == 7
    with pytest.raises(ValueError):
        lane.put(lambda: None, a)
    with pytest.raises(ZeroDivisionError):
        lane.run(lambda: 1 // 0)


# ------------------------------------------------------------- offload rule


def test_offload_rule_matches_the_jax_service(stream_set, monkeypatch):
    """Which submits leave the scheduler: the port's rule on its own
    verifiers (made by the service's constructor seam) against the JAX
    _submit_is_offloaded on stand-ins shaped as the JAX verifiers (a comb
    batch above the JAX host-route width)."""
    monkeypatch.setenv("COMETBFT_TPU_DEVICE_BATCH_MIN", "1")
    keys, pubs, entry = stream_set
    svc = PS.VerifyService(device="cpu")
    jentry = types.SimpleNamespace(index={p: i for i, p in enumerate(pubs)})
    items = _commit(keys, pubs, 50)
    cases = {
        "comb": (("comb", entry), items, lambda: jcv.CombBatchVerifier(jentry)),
        "demoted comb": (("comb", entry), items[:3] + [_alien()], lambda: jcv.CombBatchVerifier(jentry)),
        "uncached": (PS.MODE_PLAIN, items, lambda: types.SimpleNamespace()),
        "secp": (PS.MODE_SECP, [], lambda: types.SimpleNamespace()),
        "bls": (PS.MODE_BLS, [], lambda: types.SimpleNamespace()),
        "proof": (PS.MODE_PROOF, [], lambda: jproof.TpuProofProver()),
    }
    got = {}
    for name, (mode, its, jmake) in cases.items():
        bv, jbv = svc._make_verifier(mode), jmake()
        for it in its:
            bv.add(*it)
            if hasattr(jbv, "add"):
                jbv.add(*it)
        got[name] = (PS.VerifyService._submit_is_offloaded(bv),
                     JS.VerifyService._submit_is_offloaded(jbv, max(1, len(its))))
    assert all(p == j for p, j in got.values()), got
    assert {k for k, (p, _) in got.items() if not p} == {"comb"}


def test_comb_submits_on_the_scheduler_the_rest_on_the_host_worker(stream_set):
    """Through a running service: a comb batch's submit() runs on the
    scheduler thread, an uncached and a demoted comb batch's on the host
    worker; every verdict equals the JAX host path."""
    keys, pubs, entry = stream_set
    where = []
    real = {cls: cls.submit for cls in (cv.CombBatchVerifier, cv.Ed25519BatchVerifier)}

    def spy(cls):
        def submit(self):
            where.append((cls.__name__, threading.current_thread().name))
            return real[cls](self)
        return submit

    svc = PS.VerifyService(device="cpu")
    items = _commit(keys, pubs, 51, tamper=1)
    demoted = items[:3] + [_alien()]
    try:
        for cls in real:
            cls.submit = spy(cls)
        got = [svc.verify(its, PS.Klass.BLOCKSYNC, mode)
               for its, mode in ((items, ("comb", entry)), (items, PS.MODE_PLAIN), (demoted, ("comb", entry)))]
    finally:
        for cls, fn in real.items():
            cls.submit = fn
        svc.stop()
    assert got == [JS._host_verify_items(items), JS._host_verify_items(items), JS._host_verify_items(demoted)]
    assert where == [("CombBatchVerifier", "verifysvc-sched"), ("Ed25519BatchVerifier", "verifysvc-host"),
                     ("CombBatchVerifier", "verifysvc-host"), ("Ed25519BatchVerifier", "verifysvc-host")]


def test_a_demoted_batch_gives_its_stage_back_at_dispatch(stream_set, monkeypatch):
    """Under a mesh a comb request takes a place in the staging order at
    submit.  A batch demoted by a foreign key stages nothing, so its place
    goes back when the scheduler sends it to the host worker: a later
    stage (here a bare job on the staging thread) runs while the host
    worker is still busy with an earlier task (a gated uncached batch),
    and the demoted batch's verdicts equal the JAX host path."""
    keys, pubs, entry = stream_set
    meshed = copy.copy(entry)
    meshed.mesh = object()  # a stand-in: only models/comb_verifier.reserve_stage reads it here
    started, gate = threading.Event(), threading.Event()

    class Gated:  # an uncached batch whose submit holds the host worker
        def __init__(self):
            self.n = 0

        def add(self, *item):
            self.n += 1

        def submit(self):
            started.set()
            gate.wait(WAIT)
            return ("sync", (True, [True] * self.n))

        def collect(self, ticket):
            return ticket[1]

    svc = PS.VerifyService(device="cpu")
    real_make = svc._make_verifier
    monkeypatch.setattr(svc, "_make_verifier", lambda mode: Gated() if mode == PS.MODE_PLAIN else real_make(mode))
    items = _commit(keys, pubs, 52)
    demoted = items[:3] + [(_alien()[0], items[3][1], items[3][2])]
    try:
        held = svc.submit(items[:2], PS.Klass.BACKGROUND, PS.MODE_PLAIN)
        assert started.wait(WAIT)
        ticket = svc.submit(demoted, PS.Klass.BLOCKSYNC, ("comb", meshed))
        later = cv._staging_executor().put(lambda: "ran")
        assert later.result(WAIT / 4) == "ran"
        assert not gate.is_set()
    finally:
        gate.set()
    try:
        assert ticket.collect(WAIT) == JS._host_verify_items(demoted)
        assert held.collect(WAIT) == (True, [True, True])
    finally:
        svc.stop()


# -------------------------------------------------------------- proof door


LEAVES = [b"leaf-%d-" % i + bytes([i]) * (i % 7) for i in range(37)]
INDICES = [36, 0, 5, 5, 17, 1, 30]


def _proof_bytes(proofs):
    return [(p.total, p.index, p.leaf_hash, list(p.aunts)) for p in proofs]


def _jax_prove(leaves, indices, **kw):
    jsvc = JS.VerifyService(failover=False, **kw)
    try:
        return jproof.prove(leaves, indices, svc=jsvc)
    finally:
        jsvc.stop()


def test_prove_matches_the_jax_front_door():
    """Under the device threshold both front doors answer on the host
    prover through the PROOF class: the same root and proof bytes, in
    the caller's order (a repeated index included), equal to the
    oracle's; one PROOF dispatch."""
    svc = PS.VerifyService(device="cpu")
    try:
        root, proofs = pproof.prove(LEAVES, INDICES, svc=svc)
        assert svc.stats()["dispatched_batches"]["proof"] == 1
    finally:
        svc.stop()
    jroot, jproofs = _jax_prove(LEAVES, INDICES)
    oroot, oproofs = jcm.proofs_from_byte_slices(LEAVES)
    assert root == jroot == oroot
    assert _proof_bytes(proofs) == _proof_bytes(jproofs) == _proof_bytes([oproofs[i] for i in INDICES])
    with pytest.raises(ValueError):
        pproof.prove(LEAVES, [37], svc=svc)
    with pytest.raises(ValueError):
        pproof.prove([], [0], svc=svc)


def test_prove_on_the_device_route_matches_the_oracle(monkeypatch):
    """With the device threshold at one query the PROOF batch runs the
    K7 -> K8 -> K9 route (plain versions): the same bytes."""
    monkeypatch.setenv("COMETBFT_TPU_PROOF_DEVICE_MIN", "1")
    svc = PS.VerifyService(device="cpu")
    try:
        root, proofs = pproof.prove(LEAVES, INDICES, svc=svc)
    finally:
        svc.stop()
    oroot, oproofs = jcm.proofs_from_byte_slices(LEAVES)
    assert root == oroot and _proof_bytes(proofs) == _proof_bytes([oproofs[i] for i in INDICES])


def test_prove_answers_a_refusal_on_the_host(monkeypatch):
    """A PROOF queue bound below the request: both front doors are
    refused and answer on the host, with the same bytes."""
    monkeypatch.setenv("COMETBFT_TPU_PROOF_QUEUE_MAX", "2")
    svc = PS.VerifyService(device="cpu")
    fell = []
    real = pproof._prove_items

    def spy(items, device):
        fell.append(device)
        return real(items, device)

    monkeypatch.setattr(pproof, "_prove_items", spy)
    try:
        root, proofs = pproof.prove(LEAVES, INDICES, svc=svc)
        assert svc.stats()["rejected"]["proof"] == 1
    finally:
        svc.stop()
    jroot, jproofs = _jax_prove(LEAVES, INDICES)
    assert fell == [False]
    assert root == jroot and _proof_bytes(proofs) == _proof_bytes(jproofs)


def test_prove_answers_a_timeout_on_the_host(monkeypatch):
    """A collect past COMETBFT_TPU_VERIFYSVC_COLLECT_TIMEOUT_MS (a stuck
    prover): both front doors answer on the host."""
    monkeypatch.setenv("COMETBFT_TPU_VERIFYSVC_COLLECT_TIMEOUT_MS", "200")
    release = threading.Event()

    class Stuck:
        _entry = None

        def __init__(self):
            self.items = []

        def add(self, *it):
            self.items.append(it)

        def submit(self):
            release.wait(WAIT)
            return ("sync", (False, [None] * len(self.items)))

        def collect(self, ticket):
            return ticket[1]

    got = []
    for pkg, extra, prove in ((PS, {"device": "cpu"}, pproof.prove), (JS, {"failover": False}, jproof.prove)):
        svc = pkg.VerifyService(**extra)
        svc._make_verifier = lambda mode: Stuck()
        try:
            t0 = time.monotonic()
            got.append(prove(LEAVES, INDICES, svc=svc))
            assert time.monotonic() - t0 < WAIT / 2
        finally:
            release.set()
            svc.stop()
            release.clear()
    (root, proofs), (jroot, jproofs) = got
    assert root == jroot and _proof_bytes(proofs) == _proof_bytes(jproofs)


def test_assemble_reproves_an_evicted_tree(monkeypatch):
    """The tree is evicted between register and dispatch (a cache of one
    tree, another registered at once): the service answers None rows,
    and _assemble proves again from the held leaves, as the JAX one."""
    monkeypatch.setenv("COMETBFT_TPU_PROOF_TREE_CACHE", "1")
    for mod in (pproof, jproof):
        real = mod.register_tree

        def evicting(leaves, real=real):
            digest = real(leaves)
            real([b"another tree"])
            return digest

        monkeypatch.setattr(mod, "register_tree", evicting)
    svc = PS.VerifyService(device="cpu")
    try:
        root, proofs = pproof.prove(LEAVES, INDICES, svc=svc)
    finally:
        svc.stop()
    jroot, jproofs = _jax_prove(LEAVES, INDICES)
    assert root == jroot and _proof_bytes(proofs) == _proof_bytes(jproofs)
    rows = [None] * len(INDICES)
    assert (lambda r, p: (r, _proof_bytes(p)))(*pproof._assemble(LEAVES, INDICES, rows)) == \
        (lambda r, p: (r, _proof_bytes(p)))(*jproof._assemble(LEAVES, INDICES, rows))
