"""Rank bodies and a spawn helper for tests/test_torch_parallel.py: the
sharded verify plane (cometbft_tpu_torch/parallel/) on gloo process
groups of CPU ranks.

Every rank runs the same functions on the same case (SPMD) and returns
plain values; ``spawn`` starts ``world`` ranks with the spawn method,
joins them with a time limit, and returns each rank's results.  This
module imports only the port, numpy and torch, so a spawned rank does
not import the JAX package.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 60  # a collective that waits longer fails the rank
N_SIGS = 16
N_LEAVES = 32
PROOF_LEAVES = 24
PROOF_QUERIES = [0, 23, 7, 11, 3, 16, 22, 1, 5, 9, 13, 2, 19, 8, 21, 4]
CORRUPT = (3, 11)  # rows of the uncached batch with a flipped s byte
TAMPER = 5  # comb row whose message gains a byte
SUBSET = (12, 3, 7)
N_PADDED = 13  # a set that pads to 8 * size lanes
CHURN_OUT = (1, 6, 14)  # keys replaced in the set change


def make_case(seed: int = 2026) -> dict:
    """Seeded inputs as plain bytes and numpy arrays (picklable, and the
    same for the JAX package): 16 signed rows, two trees and their
    queries, a changed set."""
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.crypto import merkle as cm

    rng = np.random.default_rng(seed)
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(N_SIGS + len(CHURN_OUT))]
    pubs = [k.pub_key().data for k in keys]
    msgs = [b"sharded-%d-" % i + rng.bytes(int(rng.integers(0, 90))) for i in range(N_SIGS)]
    sigs = [keys[i].sign(msgs[i]) for i in range(N_SIGS)]
    bad_sigs = list(sigs)
    for i in CORRUPT:
        bad_sigs[i] = sigs[i][:32] + bytes([sigs[i][32] ^ 1]) + sigs[i][33:]
    new_set = list(pubs[:N_SIGS])
    for j, i in enumerate(CHURN_OUT):
        new_set[i] = pubs[N_SIGS + j]
    new_set = new_set[5:] + new_set[:5]  # rows move between ranks too
    depth, sib = cm.proof_plan(PROOF_LEAVES, PROOF_QUERIES)
    return {
        "pubs": pubs[:N_SIGS], "msgs": msgs, "sigs": sigs, "bad_sigs": bad_sigs,
        "new_set": new_set,
        "new_sigs": [keys[pubs.index(pk)].sign(b"new-%d" % i) for i, pk in enumerate(new_set)],
        "leaves": [b"tx-%d-" % i + rng.bytes(int(rng.integers(0, 80))) for i in range(N_LEAVES)],
        "proof_leaves": [b"proof-leaf-%d" % i for i in range(PROOF_LEAVES)],
        "proof_idx": np.asarray(PROOF_QUERIES, dtype=np.int32),
        "proof_sib": np.asarray(sib, dtype=np.int32).reshape(len(PROOF_QUERIES), depth),
    }


def uncached_batch(case: dict):
    """(a, r, s, blocks, active) numpy arrays of the 16 rows with the
    corrupted signatures (ops/sha2.pad_messages_sha512 layout)."""
    from cometbft_tpu_torch.ops import sha2

    a = np.stack([np.frombuffer(p, np.uint8) for p in case["pubs"]])
    sig = np.stack([np.frombuffer(s, np.uint8) for s in case["bad_sigs"]])
    blocks, active = sha2.pad_messages_sha512(
        [s[:32] + p + m for p, m, s in zip(case["pubs"], case["msgs"], case["bad_sigs"])])
    return a, sig[:, :32].copy(), sig[:, 32:].copy(), blocks, active


def comb_items(case: dict, tamper=None) -> list[tuple[bytes, bytes, bytes]]:
    return [(p, m + (b"x" if i == tamper else b""), s)
            for i, (p, m, s) in enumerate(zip(case["pubs"], case["msgs"], case["sigs"]))]


def _verify(entry, items) -> tuple[bool, list[bool]]:
    """A comb batch through the verify service of the entry's device, as
    crypto/batch.create_batch_verifier hands one over: the service's
    host worker runs the sharded verify and its collectives."""
    from cometbft_tpu_torch.verifysvc import Klass, ServiceBatchVerifier, global_service

    bv = ServiceBatchVerifier(Klass.CONSENSUS, ("comb", entry), service=global_service(entry.device))
    for it in items:
        bv.add(*it)
    return bv.verify()


def run_entries(mesh, case: dict) -> dict:
    """Rows 23, 25 and 26 and commit_verification_step on the case."""
    from cometbft_tpu_torch import parallel as P
    from cometbft_tpu_torch.ops import merkle as M

    batch = [torch.from_numpy(x) for x in uncached_batch(case)]
    ok, valid = P.sharded_verify_batch(mesh, *batch)
    refused = None
    if mesh.size > 1:  # rows that do not divide over the ranks
        try:
            P.sharded_verify_batch(mesh, *(t[: mesh.size + 1] for t in batch))
            refused = False
        except ValueError:
            refused = True
    lb, la = (torch.from_numpy(x) for x in M.pad_leaves(case["leaves"]))
    root = P.sharded_merkle_root(mesh, lb, la)
    pb, pa = (torch.from_numpy(x) for x in M.pad_leaves(case["proof_leaves"]))
    proot, leaf_sel, aunts = P.sharded_merkle_proofs(
        mesh, pb, pa, torch.from_numpy(case["proof_idx"]), torch.from_numpy(case["proof_sib"]))
    s_ok, s_valid, s_root = P.commit_verification_step(mesh, *batch, lb, la)
    return {
        "verify_ok": bool(ok), "verify_valid": valid.cpu().numpy(), "refused": refused,
        "root": bytes(root.cpu().numpy()), "proof_root": bytes(proot.cpu().numpy()),
        "leaf_sel": leaf_sel.cpu().numpy(), "aunts": aunts.cpu().numpy(),
        "step": (bool(s_ok), s_valid.cpu().numpy(), bytes(s_root.cpu().numpy())),
    }


def run_merkle(mesh, case: dict) -> dict:
    """Rows 25 and 26 alone (no signature work: the quick parity run)."""
    from cometbft_tpu_torch import parallel as P
    from cometbft_tpu_torch.ops import merkle as M

    lb, la = (torch.from_numpy(x) for x in M.pad_leaves(case["leaves"]))
    pb, pa = (torch.from_numpy(x) for x in M.pad_leaves(case["proof_leaves"]))
    proot, leaf_sel, aunts = P.sharded_merkle_proofs(
        mesh, pb, pa, torch.from_numpy(case["proof_idx"]), torch.from_numpy(case["proof_sib"]))
    return {
        "root": bytes(P.sharded_merkle_root(mesh, lb, la).cpu().numpy()),
        "proof_root": bytes(proot.cpu().numpy()),
        "leaf_sel": leaf_sel.cpu().numpy(), "aunts": aunts.cpu().numpy(),
    }


def run_comb(mesh, case: dict) -> dict:
    """Row 24 through the comb cache bound to the mesh: the cases of
    tests/sharded_comb_check.py, the raw sharded bitmap, a set change,
    and (when the case carries JAX tables) convert.tables_from_jax."""
    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch import parallel as P
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.ops import comb

    cv.set_active_mesh(mesh)
    try:
        cache = cv.ValsetCombCache()
        pubs = case["pubs"]
        entry = cache.ensure(pubs, device=mesh.device)
        out = {"vpad": entry.vpad, "lo": entry.lo, "lanes": int(entry.tables.shape[0]),
               "tables": entry.tables.cpu().numpy(), "valid": entry.valid.cpu().numpy()}
        out["all_valid"] = _verify(entry, comb_items(case))
        out["tampered"] = _verify(entry, comb_items(case, TAMPER))
        items = comb_items(case)
        out["subset"] = _verify(entry, [items[i] for i in SUBSET])
        e13 = cache.ensure(pubs[:N_PADDED], device=mesh.device)
        out["padded"] = (e13.vpad, _verify(e13, items[:N_PADDED]))
        payload = torch.from_numpy(cv.assemble_payload(comb_items(case, TAMPER), np.arange(N_SIGS),
                                                       entry.vpad))
        out["bitmap"] = P.sharded_verify_cached(mesh, entry.tables, entry.valid, entry.pubs, payload,
                                                entry.b_tables).cpu().numpy()
        # a set change: K3 sees exactly the keys this rank's base slice lacks
        built: list[bytes] = []
        real_build = comb.build_a_tables

        def spy(a_enc):
            built.extend(bytes(r) for r in a_enc.cpu().numpy())
            return real_build(a_enc)

        cache.ensure(pubs, device=mesh.device)  # the 16-key entry is the churn base
        comb.build_a_tables = spy
        try:
            churn = cache.ensure(case["new_set"], device=mesh.device)
        finally:
            comb.build_a_tables = real_build
        out["churn_built"] = sorted(set(built))
        out["churn_tables"] = churn.tables.cpu().numpy()
        out["churn_valid"] = churn.valid.cpu().numpy()
        out["churn_verify"] = _verify(churn, list(zip(
            case["new_set"], [b"new-%d" % i for i in range(N_SIGS)], case["new_sigs"])))
        if "jax_tables" in case:
            jt, jv, jp = case["jax_tables"]
            conv = convert.tables_from_jax(jt, jv, jp, b_tables=entry.b_tables, mesh=mesh)
            out["from_jax"] = (torch.equal(conv.tables, entry.tables)
                               and torch.equal(conv.valid, entry.valid)
                               and torch.equal(conv.pubs, entry.pubs) and conv.lo == entry.lo
                               and conv.vpad == entry.vpad and conv.index == entry.index)
        return out
    finally:
        cv.set_active_mesh(None)


def run_deadlock_guard(mesh, case: dict) -> dict:
    """Rank 0's background table build is held back while every other
    rank's tables are ready: all ranks must still take the same route
    (uncached), and the comb route once rank 0's build lands."""
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.models import comb_verifier as cv

    gate = threading.Event()

    class LateCache(cv.ValsetCombCache):
        def _build(self, *args, **kwargs):
            gate.wait(GROUP_TIMEOUT_S)
            return super()._build(*args, **kwargs)

    saved = {k: os.environ.get(k) for k in ("COMETBFT_TPU_COMB_MIN", "COMETBFT_TPU_COMB_ASYNC_MIN")}
    os.environ["COMETBFT_TPU_COMB_MIN"] = "4"
    os.environ["COMETBFT_TPU_COMB_ASYNC_MIN"] = "8"
    cv.set_active_mesh(mesh)
    try:
        pubs = case["pubs"]
        cache = LateCache() if mesh.rank == 0 else cv.ValsetCombCache()
        if mesh.rank != 0:
            gate.set()
            cache.ensure(pubs, device=mesh.device)
        routes, results = [], []
        for _ in range(2):
            v = batch.create_batch_verifier("ed25519", pubs, device=mesh.device, comb_cache=cache)
            for it in comb_items(case, TAMPER):
                v.add(*it)
            routes.append(v.mode[0])
            results.append(v.verify())
            gate.set()
            cache.join_async(GROUP_TIMEOUT_S)
        return {"routes": routes, "results": results}
    finally:
        gate.set()
        cv.set_active_mesh(None)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


PIPE_VALS = 2048  # COMETBFT_TPU_COMB_ASYNC_MIN: the readiness agreement's size
PIPE_BLOCKS = 8
PIPE_CHANGE = 4  # the first height of the changed set
PIPE_CHURN = 16  # keys replaced at the change
PIPE_TAMPER = (6, 77)  # (block, validator row) whose signature has a flipped byte
PIPE_DEPTH = 2
PIPE_SLOW_S = 1.5  # rank 1's host lags this long after each submit
PIPE_CHAIN_ID = "pipelined-replay"
PIPE_FOREIGN = (1, 300)  # (block, row) of the commit stream whose key is outside the set


def pipeline_chain(case: dict) -> list:
    """The replayed chain, the same on every rank: (vals, block_id,
    height, commit) a block, signed by a 2,048-validator set that changes
    PIPE_CHURN keys at block PIPE_CHANGE; block PIPE_TAMPER[0] carries a
    signature with a flipped byte at row PIPE_TAMPER[1]."""
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE, Timestamp

    rng = np.random.default_rng(case["seed"])
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(PIPE_VALS + PIPE_CHURN)]
    by_addr = {k.pub_key().address(): k for k in keys}
    set_a = keys[:PIPE_VALS]
    set_b = list(set_a)
    for j, i in enumerate(rng.choice(PIPE_VALS, PIPE_CHURN, replace=False).tolist()):
        set_b[i] = keys[PIPE_VALS + j]
    sets = [T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in s]) for s in (set_a, set_b)]
    chain = []
    for b in range(PIPE_BLOCKS):
        vals = sets[b >= PIPE_CHANGE]
        height = 100 + b
        bid = T.BlockID(hash=rng.bytes(32), part_set_header=T.PartSetHeader(total=1, hash=rng.bytes(32)))
        sigs = []
        for i, v in enumerate(vals.validators):
            vote = T.Vote(type=PRECOMMIT_TYPE, height=height, round=0, block_id=bid,
                          timestamp=Timestamp(seconds=1_700_000_000 + height, nanos=i),
                          validator_address=v.address, validator_index=i)
            sig = by_addr[v.address].sign(vote.sign_bytes(PIPE_CHAIN_ID))
            if (b, i) == PIPE_TAMPER:
                sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
            vote.signature = sig
            sigs.append(vote.to_commit_sig())
        chain.append((vals, bid, height, T.Commit(height=height, round=0, block_id=bid, signatures=sigs)))
    return chain


def run_pipeline(mesh, case: dict) -> dict:
    """The blocksync verify-ahead at depth PIPE_DEPTH under the mesh:
    types/validation.submit_verify_commit_light a height, BLOCKSYNC, up
    to PIPE_DEPTH heights in flight, over pipeline_chain (the first set's
    tables warm, the second built in the background after the change).
    Rank 1's host lags after each submit, so without one collective
    thread a rank its next readiness agreement and its last stage's
    collectives would reach the group in the other order than rank 0's.
    Then blocksync/replay.CommitStreamVerifier over the first set's
    commits at the same depth, block PIPE_FOREIGN[0] carrying a foreign
    key.  Every collective is logged with the thread that issued it."""
    from collections import deque

    from cometbft_tpu_torch.blocksync import CommitStreamVerifier
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.verifysvc import Klass

    chain = pipeline_chain(case)
    threads: list[str] = []
    real = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}

    def logged(name):
        def call(*a, **kw):
            threads.append(threading.current_thread().name)
            return real[name](*a, **kw)
        return call

    cv.set_active_mesh(mesh)
    cache = cv.ValsetCombCache()
    try:
        cache.ensure(chain[0][0].pub_keys_bytes(), device=mesh.device)
        for name in real:
            setattr(dist, name, logged(name))
        inflight, blocks = deque(), []

        def drain():
            height, pending = inflight.popleft()
            route = "cache" if pending._bv is None else pending._bv.mode[0]
            try:
                pending.collect()
                blocks.append((height, route, None))
            except validation.CommitVerificationError as e:
                blocks.append((height, route, str(e).split(":")[0]))

        for vals, bid, height, commit in chain:
            inflight.append((height, validation.submit_verify_commit_light(
                PIPE_CHAIN_ID, vals, bid, height, commit, klass=Klass.BLOCKSYNC, device=mesh.device,
                comb_cache=cache)))
            if mesh.rank == 1:
                time.sleep(PIPE_SLOW_S)
            while len(inflight) > PIPE_DEPTH:
                drain()
        while inflight:
            drain()
        cache.join_async(GROUP_TIMEOUT_S)
        # then the first set's commits as a raw stream at the same depth,
        # one row's key foreign to the set (signing another message): that
        # block is demoted to the uncached verifier and stages nothing
        n_before = len(threads)
        stream = []
        for vals, _, _, commit in chain[:PIPE_CHANGE]:
            sb = commit.vote_sign_bytes_fn(PIPE_CHAIN_ID)
            stream.append([(v.pub_key.bytes(), sb(i), commit.signatures[i].signature)
                           for i, v in enumerate(vals.validators)])
        alien = host.PrivKey.from_seed(bytes([7]) * 32)
        b, row = PIPE_FOREIGN
        stream[b][row] = (alien.pub_key().data, stream[b][row][1], alien.sign(b"another message"))
        entry = cache.ensure(chain[0][0].pub_keys_bytes(), device=mesh.device)
        verdicts = [(ok, [i for i, v in enumerate(per) if not v])
                    for ok, per in CommitStreamVerifier(entry, depth=PIPE_DEPTH).run(stream)]
        return {"blocks": blocks, "collective_threads": threads, "stream": verdicts,
                "stream_collectives": len(threads) - n_before}
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
        cv.set_active_mesh(None)


def run_failover_tokens(mesh, case: dict) -> dict:
    """Comb requests under the mesh hold a staging place from submit
    (models/comb_verifier.reserve_stage), and no rank verifies one on the
    host alone (verifysvc/service.py, failover).  Each failover path
    fails its tickets and gives its place back, so every later comb batch
    of the rank still runs: a fail_dispatch, a comb batch while the
    service is tripped (MeshFailoverRefused), a batch failed with an error
    that is not the card's (BuildError), each followed by a comb batch
    through the staging thread and its collectives.  Then a trip on rank
    0 alone: resolve_mode's agreement sends both ranks uncached (rank 0's
    batch to its host, rank 1's to its kernels' path), and both back to
    the comb route once rank 0 restores.  Returns the verdicts or errors,
    the routes and the service's failover stats."""
    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.utils import fail
    from cometbft_tpu_torch.verifysvc import Klass, ServiceBatchVerifier, resolve_mode
    from cometbft_tpu_torch.verifysvc import service as S

    cv.set_active_mesh(mesh)
    svc = S.VerifyService(device="cpu", failover=True, probe_fn=lambda _t: None)
    saved = os.environ.get("COMETBFT_TPU_COMB_MIN")
    os.environ["COMETBFT_TPU_COMB_MIN"] = "4"
    try:
        cache = cv.ValsetCombCache()
        entry = cache.ensure(case["pubs"], device=mesh.device)
        mode = ("comb", entry)

        def verify(items, m=mode, service=svc):
            bv = ServiceBatchVerifier(Klass.CONSENSUS, m, service=service)
            for it in items:
                bv.add(*it)
            try:
                return bv.verify()
            except (_build.BuildError, fail.InjectedFault, S.MeshFailoverRefused) as e:
                return f"{type(e).__name__}: {e}"

        good, bad = comb_items(case), comb_items(case, TAMPER)
        out = {"before": verify(bad)}
        fail.arm("fail_dispatch")
        try:
            out["fail_dispatch"] = verify(bad)
        finally:
            fail.clear("fail_dispatch")
        out["after_fail_dispatch"] = verify(good)
        svc.trip_to_cpu("test: tripped under the mesh")
        out["tripped"] = verify(bad)
        svc._restore_tpu()
        out["after_restore"] = verify(bad)
        real = svc._make_verifier

        def broken(m):
            raise _build.BuildError("nvcc failed for comb.cu")

        svc._make_verifier = broken
        out["build_error"] = verify(good)
        svc._make_verifier = real
        out["after_build_error"] = verify(good)
        fo = svc.stats()["failover"]
        out["failover"] = {k: fo[k] for k in ("trips", "restores", "backend_mode")}
        g = S.global_service(mesh.device)
        g._probe_fn = lambda _t: None
        routes, asym = [], []
        for step in ("trip", "restore"):
            if mesh.rank == 0:
                g.trip_to_cpu("test: rank 0 alone") if step == "trip" else g._restore_tpu()
            m, _ = resolve_mode(case["pubs"], device=mesh.device, comb_cache=cache)
            routes.append(m[0])
            asym.append(verify(bad, m, g))
        out["asym_routes"], out["asym"] = routes, asym
        return out
    finally:
        svc.stop()
        cv.set_active_mesh(None)
        if saved is None:
            os.environ.pop("COMETBFT_TPU_COMB_MIN", None)
        else:
            os.environ["COMETBFT_TPU_COMB_MIN"] = saved


TASKS = {"entries": run_entries, "merkle": run_merkle, "comb": run_comb,
         "deadlock_guard": run_deadlock_guard, "pipeline": run_pipeline,
         "failover_tokens": run_failover_tokens}


def init_group(rank: int, world: int, store: str) -> None:
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def run_tasks(mesh, tasks, case: dict) -> dict:
    from cometbft_tpu_torch.verifysvc import reset_global_service

    try:
        return {t: TASKS[t](mesh, case) for t in tasks}
    finally:
        reset_global_service()  # the services' threads end with the tasks


def rank_main(rank: int, world: int, store: str, out_dir: str, tasks, case: dict, b_table) -> None:
    """One spawned rank: a gloo group of ``world`` CPU ranks, the tasks,
    its results pickled to out_dir/rank<r>.pkl (a traceback to .err)."""
    from cometbft_tpu_torch import parallel as P
    from cometbft_tpu_torch.ops import comb

    torch.set_num_threads(1)
    try:
        if b_table is not None:
            comb.adopt_b_tables(b_table)
        init_group(rank, world, store)
        try:
            res = run_tasks(P.make_mesh(device="cpu"), tasks, case)
        finally:
            dist.destroy_process_group()
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn(world: int, out_dir, tasks, case: dict, b_table=None, timeout: float = 240.0) -> list[dict]:
    """Run the tasks on ``world`` spawned ranks; every rank must exit 0
    within ``timeout`` seconds (a hang fails, it does not wait on)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    store = str(out_dir / "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, store, str(out_dir), tuple(tasks), case, b_table))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = {r: (out_dir / f"rank{r}.err").read_text() for r in range(world)
            if (out_dir / f"rank{r}.err").exists()}
    if hung or errs or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks hung past {timeout} s: {hung}; exit codes "
                             f"{[p.exitcode for p in procs]}; errors: {errs}")
    out = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
