"""Validator-set-keyed comb-table cache and the cached batch verifier
(the port of cometbft_tpu/models/comb_verifier.py).

A validator set's pubkeys are expanded ONCE into per-validator comb
tables on the card (ops/comb.build_a_tables, kernel K3) — the analogue
of the reference's per-pubkey expanded-key LRU
(crypto/ed25519/ed25519.go:43,68) scaled to whole validator sets.  Every
VerifyCommit against that set then ships only the per-call data in one
tight payload (R | s | mlen | live | msg per validator row), and
``device_verify`` runs K1 (block assembly) -> K2 (SHA-512) -> K4 (comb
verify with the packed epilogue) on the caller's stream.  A call makes
one host-to-device copy of the payload and one device-to-host copy of
[bitmap | all_ok].

Shapes are keyed by the validator-set size V: rows of validators that
did not sign carry live = 0 and are masked out of the result, preserving
the per-signature blame contract of types/validation.go:384-399.

After a validator-set change the new set's tables are built
incrementally from the previous set's entry (``ValsetCombCache._build``):
K3 runs on the new keys only, and K6 (``assemble_churn``, csrc/churn.cu,
replacing cometbft_tpu/models/comb_verifier.py:391 _assemble_churn)
assembles the reused and fresh rows.  ``ensure_async`` runs that build in
a background thread on its own CUDA stream while callers verify through
the uncached kernel (models/verifier.Ed25519BatchVerifier).

``CombBatchVerifier.submit`` returns at once: the payload fill, its
copy to the card, the launches and the copy of the verdicts back run on
one process-wide staging thread (``_staging_executor``, the JAX
:434-452), so a pipelined caller's next block overlaps this one's host
work and kernels.  One thread issues every stage, so tickets resolve in
submission order.

Under an active mesh (``COMETBFT_TPU_MESH`` / ``set_active_mesh``, the
JAX :114-147) every rank of the process group holds only its slice of
the set's lanes, padded to a multiple of 8 * size, and a verify runs
parallel/verify.sharded_verify_cached: K1 -> K2 -> K4 on each rank's
slice and two collectives.  Every rank calls the cache and the verifier
with the same arguments (SPMD).  Every collective of the comb route —
the stages' and the readiness agreement of verifysvc/client.resolve_mode
— runs on the staging thread, in the order the caller's thread made the
calls: a place is taken in the caller's thread (:func:`reserve_stage`)
and the thread runs the jobs by place, so two threads of one rank can
never reach the ranks' collectives in two orders.  :func:`reserve_stage`,
:func:`release_stage`, ``CombBatchVerifier.bind_stage`` and
:func:`run_in_stage_order` are the whole of that protocol for callers.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from array import array
from collections import OrderedDict
from concurrent.futures import Future
from operator import itemgetter

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from .. import _build, envknobs
from .._device import resolve_device
from ..ops import comb, sha2
from ..parallel import mesh as pmesh
from ..parallel.verify import sharded_verify_cached
from ..utils import tracing
from ..utils.metrics import hub as _mhub
from .verifier import Ed25519BatchVerifier

LAUNCHES = {"assemble_churn": 0}


class _PayloadSlab:
    """One reusable (V, 68 + maxm) host staging buffer for the payload —
    page-locked when the entry lives on the card, so the per-call copy is
    a single asynchronous DMA.

    Allocated once per (entry, width bucket) and recycled through the
    entry's two-slab pool.  A full clear between uses is unnecessary: K1
    zeroes every byte past a row's mlen and K4 masks every row whose live
    flag is 0, so a reuse only needs the PREVIOUS call's live flags
    retired — and when the next call writes the exact same row layout
    (same signer rows, same sign-bytes length), the constant mlen/live
    columns are already correct and are not touched at all."""

    __slots__ = ("tensor", "buf", "dirty", "layout")

    def __init__(self, vpad: int, width: int, pinned: bool):
        self.tensor = torch.zeros((vpad, width), dtype=torch.uint8, pin_memory=pinned)
        self.buf = self.tensor.numpy()  # shares the tensor's memory
        self.dirty = None  # previous use's live rows (array or slice)
        self.layout = None  # (kind, n, mlen) of the previous use

    def retire(self) -> None:
        """Forget every previous/partial fill: all live flags cleared, full
        header rewrite forced on next use (the safe state after an error)."""
        self.buf[:, 67] = 0
        self.dirty = None
        self.layout = None


class _CacheEntry:
    __slots__ = (
        "tables", "valid", "pubs", "b_tables", "index", "vpad", "lo", "mesh",
        "device", "_slabs", "_slab_mtx",
    )

    def __init__(self, tables, valid, pubs, b_tables, index: dict[bytes, int], mesh=None):
        # tables, valid and pubs hold this rank's lanes lo .. lo + per of
        # the vpad lanes (all of them without a mesh)
        self.tables = tables  # (per, 64, 8, 3, 8) int32 canonical Niels words
        self.valid = valid  # (per,) bool
        self.pubs = pubs  # (per, 32) uint8 — A of every R || A || M
        self.b_tables = b_tables  # (22, 4096, 3, 8) int32, shared per device
        self.index = index  # pubkey bytes -> global row
        self.mesh = mesh  # parallel.Mesh when the lanes are sharded
        per = int(tables.shape[0])
        self.vpad = per * (1 if mesh is None else mesh.size)
        self.lo = 0 if mesh is None else per * mesh.rank
        self.device = tables.device
        self._slabs: dict[int, list[_PayloadSlab]] = {}
        self._slab_mtx = threading.Lock()

    def acquire_slab(self, width: int) -> _PayloadSlab:
        with self._slab_mtx:
            pool = self._slabs.get(width)
            if pool:
                slab = pool.pop()
                _mhub().verify_slab_requests.inc(result="hit")
                return slab
        _mhub().verify_slab_requests.inc(result="miss")
        return _PayloadSlab(self.vpad, width, pinned=self.device.type == "cuda")

    def release_slab(self, slab: _PayloadSlab) -> None:
        with self._slab_mtx:
            pool = self._slabs.setdefault(slab.buf.shape[1], [])
            if len(pool) < 2:
                pool.append(slab)


_UNSET = object()
_MESH = _UNSET
_MESH_MTX = threading.Lock()


def active_mesh():
    """The mesh of the sharded comb path (cometbft_tpu/models/
    comb_verifier.py:114).  ``COMETBFT_TPU_MESH`` = N, read once per
    process: N <= 1 is no mesh; N > 1 shards over the first N ranks of
    the initialized process group (parallel.make_mesh on the card),
    which raises when there is no group or it has fewer ranks.
    Consensus builds one cache entry per validator set, and every entry
    must have the same placement."""
    global _MESH
    with _MESH_MTX:
        if _MESH is _UNSET:
            n = envknobs.get_int(envknobs.MESH, envknobs.MESH_DEFAULT)
            _MESH = pmesh.make_mesh(n) if n > 1 else None
        return _MESH


def set_active_mesh(mesh) -> None:
    """Bind (or clear, with None) the comb path's mesh, overriding the
    environment.  Entries are keyed on the mesh, so an entry built under
    one placement is never served under another."""
    global _MESH
    with _MESH_MTX:
        _MESH = mesh


def placement(device="cuda"):
    """(mesh, device) of the comb path for a caller's ``device``: under an
    active mesh, the rank's device, which must be of the kind asked for."""
    dev = resolve_device(device)
    mesh = active_mesh()
    if mesh is None:
        return None, dev
    if dev.type != mesh.device.type or (dev.index is not None and dev != mesh.device):
        raise ValueError(f"the active mesh places this rank on {mesh.device}, not {dev}")
    return mesh, mesh.device


class ValsetCombCache:
    """LRU of card-resident comb tables, keyed by (device, mesh, pubkey
    list).

    A 10k-validator entry is ~0.5 GB of device memory (48 KiB per
    validator), so the LRU is small; consensus only ever needs the
    current set and, briefly, the previous one across a set change.
    Under a mesh of D ranks each rank holds 1/D of it.
    """

    def __init__(self, max_entries: int = 2):
        self._entries: OrderedDict[tuple, _CacheEntry] = OrderedDict()
        self._max = max_entries
        self._mtx = threading.Lock()
        self._building: dict[tuple, threading.Lock] = {}
        self._async: dict[tuple, threading.Thread] = {}
        self._b_tables: dict[str, torch.Tensor] = {}
        self.last_build_ms: float | None = None

    @staticmethod
    def fingerprint(pubkeys: list[bytes]) -> bytes:
        h = hashlib.sha256()
        for pk in pubkeys:
            h.update(pk)
        return h.digest()

    def _key(self, pubkeys: list[bytes], dev: torch.device, mesh) -> tuple:
        where = None if mesh is None else pmesh.mesh_cache_key(mesh)
        return (str(dev), where, self.fingerprint(pubkeys))

    def get(self, key: tuple) -> _CacheEntry | None:
        with self._mtx:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
            return e

    def ensure(self, pubkeys: list[bytes], device="cuda") -> _CacheEntry:
        """The entry for this exact pubkey list on ``device`` (under the
        active mesh, this rank's slice of it), building the tables on
        first sight.  Concurrent first calls for the same set serialize
        on a per-key lock: a build never races a duplicate.  When an
        entry for another set exists with the same placement, its rows
        are reused for the unchanged validators (an incremental churn
        build): only the new keys go through K3."""
        mesh, dev = placement(device)
        return self._ensure(pubkeys, dev, mesh, count=True)

    def _ensure(self, pubkeys: list[bytes], dev: torch.device, mesh, count: bool = False) -> _CacheEntry:
        """``count``: observe the lookup in ``verify_comb_table_cache_total``
        (a background build's own lookup was counted by ensure_async)."""
        key = self._key(pubkeys, dev, mesh)
        e = self.get(key)
        if e is not None:
            if count:
                _mhub().comb_table_cache.inc(result="hit")
            return e
        with self._mtx:
            build_lock = self._building.setdefault(key, threading.Lock())
        with build_lock:
            e = self.get(key)  # the race loser finds the winner's entry
            if e is not None:
                if count:
                    # served by another caller's build: a wait, not a second
                    # miss (misses stay one a build)
                    _mhub().comb_table_cache.inc(result="building")
                return e
            if count:
                _mhub().comb_table_cache.inc(result="miss")
            entry = self._build(pubkeys, dev, self._newest(key), mesh)
            with self._mtx:
                self._entries[key] = entry
                while len(self._entries) > self._max:
                    self._entries.popitem(last=False)
                self._building.pop(key, None)
            return entry

    def ensure_async(self, pubkeys: list[bytes], device="cuda") -> _CacheEntry | None:
        """Non-blocking ensure (cometbft_tpu/models/comb_verifier.py:215):
        the entry if it is ready, else None with one background build per
        set started.  Callers verify through the uncached kernel until
        the tables land, so a validator-set change never stalls behind a
        table build.  The build runs no collective: under a mesh each
        rank builds its own slice, and ranks agree on readiness before
        taking the comb route (crypto/batch.create_batch_verifier)."""
        mesh, dev = placement(device)
        key = self._key(pubkeys, dev, mesh)
        e = self.get(key)
        if e is not None:
            _mhub().comb_table_cache.inc(result="hit")
            return e
        pubkeys = list(pubkeys)

        def build():
            try:
                self._ensure(pubkeys, dev, mesh)
            finally:
                with self._mtx:
                    self._async.pop(key, None)

        with self._mtx:
            if key in self._async:
                _mhub().comb_table_cache.inc(result="building")
                return None  # its build is running
            t = threading.Thread(target=build, name="comb-build", daemon=True)
            self._async[key] = t
        _mhub().comb_table_cache.inc(result="miss")
        t.start()
        return None

    def join_async(self, timeout: float | None = None) -> None:
        """Wait for the background builds running now (a caller about to
        read the new entry, or to exit, waits here)."""
        with self._mtx:
            threads = list(self._async.values())
        for t in threads:
            t.join(timeout)

    def _newest(self, key: tuple) -> _CacheEntry | None:
        """The most recently used entry with ``key``'s placement (device
        and mesh): the churn base."""
        with self._mtx:
            for (d, m, _), e in reversed(self._entries.items()):
                if (d, m) == key[:2]:
                    return e
        return None

    def b_tables(self, dev: torch.device) -> torch.Tensor:
        with self._mtx:
            t = self._b_tables.get(str(dev))
        if t is None:
            t = comb.b_tables(dev)
            with self._mtx:
                t = self._b_tables.setdefault(str(dev), t)
        return t

    def _build(self, pubkeys: list[bytes], dev: torch.device,
               base: _CacheEntry | None = None, mesh=None) -> _CacheEntry:
        """Tables for ``pubkeys`` (cometbft_tpu/models/comb_verifier.py:259).
        Under a mesh of D ranks the lanes are padded to a multiple of
        8 * D with copies of the first key (real work whose rows no
        payload ever marks live; K4 packs 8 lanes a byte on each rank),
        and this rank builds only its own slice of them.

        With a ``base`` entry that shares keys, the rows of those keys
        that the base holds on this rank are reused: the other keys,
        padded to a power-of-two bucket with copies of the first of
        them, go through K3, and K6 assembles the rows.  Without reuse
        it is one K3 build of the slice.

        On the card the build runs on a stream of its own and waits for
        that stream alone, so it neither waits for nor is billed for
        verification work queued on other streams; ``last_build_ms`` is
        the host clock around the build up to that wait."""
        index = {pk: i for i, pk in enumerate(pubkeys)}
        lanes = list(pubkeys)
        if mesh is not None:
            width = 8 * mesh.size
            lanes += [pubkeys[0]] * ((-len(lanes)) % width)
            per = len(lanes) // mesh.size
            lanes = lanes[mesh.rank * per : (mesh.rank + 1) * per]
        pub_arr = np.frombuffer(b"".join(lanes), dtype=np.uint8).reshape(-1, 32)
        reuse: list[tuple[int, int]] = []  # (new row, base row), both of this rank
        fresh: list[int] = []
        if base is not None:
            held = range(base.lo, base.lo + base.tables.shape[0])
            for i, pk in enumerate(lanes):
                j = base.index.get(pk)
                if j is None or j not in held:
                    fresh.append(i)
                else:
                    reuse.append((i, j - base.lo))
        b_tab = self.b_tables(dev)
        consumer = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        t0 = time.perf_counter()
        span = tracing.span("verify.table_build", {
            "backend": "device", "keys": len(lanes), "fresh": len(fresh) if reuse else len(lanes)
        } if tracing.enabled() else None)
        with span, torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            pubs = torch.from_numpy(pub_arr.copy()).to(dev)
            if not reuse:
                tables, valid = comb.build_a_tables(pubs)
            else:
                if fresh:
                    bucket = 1 << (len(fresh) - 1).bit_length()
                    padded = fresh + [fresh[0]] * (bucket - len(fresh))
                    t_new, v_new = comb.build_a_tables(pubs[torch.tensor(padded, device=dev)])
                else:
                    t_new, v_new = base.tables[:0], base.valid[:0]
                tables, valid = assemble_churn(
                    base.tables, base.valid, t_new, v_new,
                    torch.tensor([i for i, _ in reuse], dtype=torch.int64, device=dev),
                    torch.tensor([j for _, j in reuse], dtype=torch.int64, device=dev),
                    torch.tensor(fresh, dtype=torch.int64, device=dev),
                    len(lanes),
                )
            if stream is not None:
                stream.synchronize()  # the span is the completed build
        if stream is not None:
            # the entry's tensors come from the build stream's pool and are
            # read on the caller's stream from now on
            for t in (tables, valid, pubs):
                t.record_stream(consumer)
        self.last_build_ms = (time.perf_counter() - t0) * 1e3
        # the JAX package's phase of a build on the device (the port has
        # no host build)
        _mhub().verify_phase_seconds.observe(self.last_build_ms / 1e3, phase="table_build_device")
        return _CacheEntry(tables, valid, pubs, b_tab, index, mesh)


def assemble_churn_plain(base_tables, base_valid, new_tables, new_valid, new_rows,
                         base_rows, fresh_rows, V):
    """Plain version of K6: the gather/scatter of
    cometbft_tpu/models/comb_verifier.py:391 on the port's validator-major
    layout (rows that neither index names stay zero and invalid)."""
    tables = torch.zeros((V,) + tuple(base_tables.shape[1:]), dtype=base_tables.dtype,
                         device=base_tables.device)
    valid = torch.zeros((V,), dtype=torch.bool, device=base_tables.device)
    tables[new_rows] = base_tables[base_rows]
    valid[new_rows] = base_valid[base_rows]
    nf = fresh_rows.shape[0]
    if nf:
        tables[fresh_rows] = new_tables[:nf]
        valid[fresh_rows] = new_valid[:nf]
    return tables, valid


def assemble_churn(base_tables, base_valid, new_tables, new_valid, new_rows, base_rows,
                   fresh_rows, V):
    """The A tables of a V-validator set from a previous set's rows and a
    freshly built bucket: row new_rows[i] is base row base_rows[i], row
    fresh_rows[f] is bucket row f (the bucket may carry padding rows past
    len(fresh_rows), never read).  Tables (*, 64, 8, 3, 8) int32, valid
    (*,) bool, rows int64 tensors, all on one device; new_rows and
    fresh_rows are disjoint.  Returns (tables (V, ...), valid (V,))."""
    shape = (comb.NPOS_A, comb.NENT_A, 3, 8)
    for name, t in (("base_tables", base_tables), ("new_tables", new_tables)):
        if t.dtype != torch.int32 or tuple(t.shape[1:]) != shape:
            raise _build.LaunchRefused(f"{name} must be (*, 64, 8, 3, 8) int32")
    if new_rows.shape != base_rows.shape:
        raise _build.LaunchRefused("new_rows and base_rows must pair up")
    if fresh_rows.shape[0] > new_tables.shape[0]:
        raise _build.LaunchRefused("more fresh rows than freshly built tables")
    args = (base_tables, base_valid, new_tables, new_valid, new_rows, base_rows, fresh_rows)
    devs = {t.device for t in args}
    if len(devs) != 1:
        raise _build.LaunchRefused(f"arguments on several devices: {devs}")
    dev = base_tables.device
    if dev.type == "cpu":
        return assemble_churn_plain(*args, V)
    if dev.type != "cuda":
        raise _build.LaunchRefused(f"unsupported device {dev}")
    # src[v]: base row (>= 0), fresh row f as -1 - f, or no source
    src = torch.full((V,), -(1 << 31), dtype=torch.int32, device=dev)
    src[new_rows] = base_rows.to(torch.int32)
    src[fresh_rows] = -1 - torch.arange(fresh_rows.shape[0], dtype=torch.int32, device=dev)
    tables = torch.empty((V,) + shape, dtype=torch.int32, device=dev)
    valid = torch.empty((V,), dtype=torch.bool, device=dev)
    launch_k6(base_tables.contiguous(), base_valid.contiguous(), new_tables.contiguous(),
              new_valid.contiguous(), src, tables, valid)
    return tables, valid


def launch_k6(base_tables, base_valid, new_tables, new_valid, src, tables, valid) -> None:
    """K6 into preallocated outputs on the current stream."""
    for t in (base_tables, new_tables, tables):
        if t.data_ptr() % 16:
            raise _build.LaunchRefused("K6 needs 16-byte aligned tables")
    with torch.cuda.device(tables.device):
        code = _build.lib("churn").k6_assemble_churn(
            base_tables.data_ptr(), base_valid.data_ptr(), new_tables.data_ptr(),
            new_valid.data_ptr(), src.data_ptr(), tables.data_ptr(), valid.data_ptr(),
            src.shape[0], torch.cuda.current_stream(tables.device).cuda_stream,
        )
    _build.check(code, "k6_assemble_churn")
    LAUNCHES["assemble_churn"] += 1


_GLOBAL_CACHE = ValsetCombCache()


def global_cache() -> ValsetCombCache:
    return _GLOBAL_CACHE


class StagingLane:
    """One worker thread that runs jobs strictly by number (the JAX
    package's one-worker staging executor, with the order made explicit).

    A number is taken with :meth:`reserve` in the thread whose call order
    the jobs must keep, and the job is handed over later, from any
    thread, with :meth:`put`; a reserved number that will carry no job
    is given back with :meth:`release`.  ``put(fn)`` without a number
    takes the next one, so jobs put by one thread run in the order put
    (FIFO).  The worker is a daemon, started on the first job."""

    def __init__(self, name: str = "comb-stage"):
        self._name = name
        self._cond = threading.Condition()
        self._next_seq = 0  # the number reserve() hands out next
        self._next_run = 0  # the number the worker runs next
        self._jobs: dict[int, tuple] = {}  # number -> (fn, future), (None, None) released
        self._thread: threading.Thread | None = None

    def reserve(self) -> int:
        with self._cond:
            seq = self._next_seq
            self._next_seq += 1
            return seq

    def put(self, fn, seq: int | None = None) -> Future:
        """Queue ``fn`` under ``seq`` (None: the next number); the future
        carries its result or its exception."""
        fut: Future = Future()
        with self._cond:
            if seq is None:
                seq = self._next_seq
                self._next_seq += 1
            if seq < self._next_run or seq >= self._next_seq or seq in self._jobs:
                raise ValueError(f"staging number {seq} is spent or was never reserved")
            self._jobs[seq] = (fn, fut)
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop, name=f"{self._name}_0", daemon=True)
                self._thread.start()
            self._cond.notify_all()
        return fut

    def release(self, seq: int | None) -> None:
        """Give back a reserved number that will carry no job (a demoted,
        refused or failed request); a spent or filled number is left
        alone."""
        if seq is None:
            return
        with self._cond:
            if seq >= self._next_run and seq not in self._jobs:
                self._jobs[seq] = (None, None)
                self._cond.notify_all()

    def run(self, fn):
        """``fn()`` on the worker, after every job numbered before it;
        its result, or its exception raised here."""
        return self.put(fn).result()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._next_run not in self._jobs:
                    self._cond.wait()
                fn, fut = self._jobs.pop(self._next_run)
                self._next_run += 1
            if fn is None or not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — the future carries it to the collector
                fut.set_exception(e)


_STAGING = None
_STAGING_MTX = threading.Lock()


def _staging_executor() -> StagingLane:
    """The process-wide staging thread of submit()
    (cometbft_tpu/models/comb_verifier.py:434): one worker keeps the
    copies and launches of every comb batch, and every collective of the
    comb route, in order, while each submitter returns at once.  Made
    under a lock: a first-use race (a blocksync thread beside the
    consensus thread) must not make two workers, which would break the
    order."""
    global _STAGING
    if _STAGING is None:
        with _STAGING_MTX:
            if _STAGING is None:
                _STAGING = StagingLane()
    return _STAGING


def reserve_stage(mode):
    """A place in the staging order for a request about to be queued in
    ``mode``, taken in the caller's thread: a token when the request's
    stage will issue collectives (a comb mode whose entry is sharded over
    a mesh), else None.  A token is later bound to the request's batch
    (``CombBatchVerifier.bind_stage``) or given back with
    :func:`release_stage`; until then every later stage and agreement of
    the process waits for it."""
    if mode[0] != "comb" or getattr(mode[1], "mesh", None) is None:
        return None
    return _staging_executor().reserve()


def release_stage(token) -> None:
    """Give back a :func:`reserve_stage` token that will carry no stage (a
    refused, failed or demoted request).  None, and a token already
    spent or given back, are left alone."""
    if token is not None:
        _staging_executor().release(token)


def run_in_stage_order(fn):
    """``fn()`` on the staging thread, after every stage submitted or
    reserved before it; its result, or its exception raised here.  A
    collective outside a stage (the readiness agreement of
    verifysvc/client.resolve_mode) keeps the comb route's order so."""
    return _staging_executor().run(fn)


def _fill_payload(
    slab: _PayloadSlab, sigs, msgs, lens: np.ndarray, rows: np.ndarray
) -> np.ndarray:
    """Fill a staging slab with the tight device payload: row layout
    R(32) | s(32) | mlen(3B LE) | live(1B) | msg.

    The batch comes packed as CombBatchVerifier.add() keeps it: ``sigs``
    the n 64-byte signatures end to end, ``msgs`` the n messages end to
    end, ``lens`` their lengths (int64) and ``rows`` each item's
    validator row, in add() order.  A few NumPy bulk copies, no loop
    over the items in Python: NumPy copies with the GIL released, so
    the threads beside the staging thread run on.  Bytes of a row's
    message region past its mlen read 0 (K1 masks them anyway).  Fast
    paths, in order:

      - same layout as the slab's previous use (row set + message
        length): the constant mlen/live columns survive verbatim; only
        R | s | msg are rewritten.
      - contiguous rows 0..n-1 (every validator signed, commit order):
        plain slice writes instead of fancy-index scatters.
      - all-equal message lengths (canonical vote sign-bytes): one
        reshaped block write for the messages.  Mixed lengths take one
        gather of every message's window of the longest length from
        the packed bytes (a strided view, no index matrix), then zero
        each row's tail past its length.
    """
    buf = slab.buf
    n = len(lens)
    sig_arr = np.frombuffer(sigs, dtype=np.uint8).reshape(n, 64)
    l0 = int(lens[0]) if n else 0
    lmax = int(lens.max()) if n else 0
    lmin = int(lens.min()) if n else 0
    same_len = lmin == lmax

    contig = bool(
        n
        and int(rows[0]) == 0
        and int(rows[-1]) == n - 1
        and (rows == np.arange(n, dtype=rows.dtype)).all()
    )
    target = slice(0, n) if contig else rows
    layout = ("contig", n, l0) if (contig and same_len) else None

    if layout is None or slab.layout != layout:
        # retire the previous use's live rows, then write the header
        # columns fresh (stale bytes beyond a live row's mlen are masked
        # by K1, so only the live flags need clearing)
        if slab.dirty is not None:
            buf[slab.dirty, 67] = 0
        if same_len:
            buf[target, 64] = l0 & 0xFF
            buf[target, 65] = (l0 >> 8) & 0xFF
            buf[target, 66] = (l0 >> 16) & 0xFF
        else:
            buf[target, 64] = lens & 0xFF
            buf[target, 65] = (lens >> 8) & 0xFF
            buf[target, 66] = (lens >> 16) & 0xFF
        buf[target, 67] = 1  # live-row flag (mlen == 0 is legal)

    buf[target, :64] = sig_arr
    flat = np.frombuffer(msgs, dtype=np.uint8)
    if same_len:
        if l0:
            buf[target, 68 : 68 + l0] = flat.reshape(n, l0)
    elif lmax:
        offs = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        if int(offs[-1]) + lmax > flat.size:  # the last windows run past the end
            flat = np.concatenate([flat, np.zeros(lmax, dtype=np.uint8)])
        win = sliding_window_view(flat, lmax)[offs]  # (n, lmax): each message and what follows it
        win[:, lmin:][np.arange(lmin, lmax)[None, :] >= lens[:, None]] = 0
        buf[target, 68 : 68 + lmax] = win
    slab.dirty = target if contig else rows
    slab.layout = layout
    return buf


_PUB, _MSG, _SIG = itemgetter(0), itemgetter(1), itemgetter(2)  # of a (pubkey, msg, sig) item


def _pack(items) -> tuple[bytes, bytes, np.ndarray]:
    """(sigs, msgs, lens) of (pubkey, msg, sig) items, as add() packs
    them."""
    return (b"".join(s for _, _, s in items), b"".join(m for _, m, _ in items),
            np.fromiter((len(m) for _, m, _ in items), np.int64, len(items)))


def _bucket_mlen(mlen: int) -> int:
    """Round a max message length up to a small set of widths: one slab
    per (valset, bucket) rather than one per distinct length (vote
    sign-bytes drift by a byte when heights/timestamps cross varint
    boundaries)."""
    if mlen <= 32:
        return 32
    return -(-mlen // 64) * 64


def _payload_width(items: list[tuple[bytes, bytes, bytes]]) -> int:
    return 68 + _bucket_mlen(max((len(m) for _, m, _ in items), default=0))


def assemble_payload(
    items: list[tuple[bytes, bytes, bytes]], rows: np.ndarray, vpad: int
) -> np.ndarray:
    """One-shot payload assembly into a fresh host buffer (tests and
    profiling); the hot path recycles per-entry slabs."""
    slab = _PayloadSlab(vpad, _payload_width(items), pinned=False)
    return _fill_payload(slab, *_pack(items), np.asarray(rows, dtype=np.int64))


def device_verify(tables, valid, pubs, payload, b_tables) -> torch.Tensor:
    """The fused comb verify on a tight payload: K1 -> K2 -> K4 on the
    payload's device (their plain versions on the CPU).

    payload rows: R(32) | s(32) | mlen(3B LE) | live(1B) | msg(maxm).
    Returns ONE uint8 array [packbits(ok & live) | all(ok | ~live)], so
    the caller makes a single device-to-host copy."""
    _, _, blocks, active, _ = sha2.parse_verify_payload(payload, pubs)
    digest = sha2.sha512_blocks(blocks, active)
    return comb.verify_cached(tables, valid, payload, digest, b_tables)


class CombBatchVerifier:
    """BatchVerifier (crypto/crypto.go:47-55) bound to a cached set.

    add() expects pubkeys of the bound validator set, one signature per
    key.  A key outside the set, or a second signature under one key,
    demotes the whole batch to the uncached verifier
    (models/verifier.Ed25519BatchVerifier), which then verifies every
    item in add() order (cometbft_tpu/models/comb_verifier.py:557-582)
    with its own submit.  add() only appends, and packs the signature and
    the message into the batch's byte arrays as it goes (add_many() a
    whole request at once, as the verify service's scheduler calls it):
    the payload fill on the staging thread after submit() is then a few
    bulk copies (``_fill_payload``), with no loop over the items in
    Python."""

    def __init__(self, entry: _CacheEntry):
        self._entry = entry
        self._rows: list[int] = []
        self._row_set: set[int] = set()
        self._items: list[tuple[bytes, bytes, bytes]] = []
        # the packed batch: signatures and messages end to end, the
        # messages' lengths; handed to the stage at submit(), copied
        # before an add() after it writes (the ticket keeps its snapshot)
        self._sigs = bytearray()
        self._msgs = bytearray()
        self._lens = array("q")
        self._handed_over = False
        self._fallback: Ed25519BatchVerifier | None = None
        # the reserve_stage() token of this batch's request (the verify
        # service takes one under a mesh), or None
        self._stage_token = None
        self.last_timings: dict[str, float] = {}  # ms per phase, set by verify()

    def __len__(self) -> int:
        return len(self._items)

    def bind_stage(self, token) -> None:
        """Stage this batch at the place of ``token``, a
        :func:`reserve_stage` token taken in the caller's thread (call
        order under a mesh)."""
        self._stage_token = token

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        if len(pub_key) != 32 or len(sig) != 64:
            raise ValueError("malformed ed25519 pubkey or signature")
        if len(msg) >= 1 << 24:
            # the payload's mlen field is 3 bytes; a silent wrap would
            # verify against a truncated message
            raise ValueError("message too large for batch verification")
        self._items.append((pub_key, msg, sig))
        if self._fallback is not None:
            self._fallback.add(pub_key, msg, sig)
            return
        row = self._entry.index.get(pub_key)
        if row is None or row in self._row_set:
            # the payload holds one row per validator of the set: replay
            # everything added so far into the uncached verifier
            self._demote()
            return
        self._row_set.add(row)
        self._rows.append(row)
        if self._handed_over:
            # the submitted stage reads the arrays it was handed
            self._sigs, self._msgs, self._lens = bytearray(self._sigs), bytearray(self._msgs), array("q", self._lens)
            self._handed_over = False
        self._sigs += sig
        self._msgs += msg
        self._lens.append(len(msg))

    def add_many(self, items) -> None:
        """add() of every ``(pub_key, msg, sig)`` tuple of ``items``, in
        their order, as one bulk pass: the lengths checked first (a
        malformed item adds nothing), the rows looked up in one pass over
        the set's index, a foreign key or a repeated row (against the
        batch's earlier rows too) found before anything is packed, then
        one join each for the signatures and the messages.  A demotion
        replays every item in add() order, as add() does.  A key found in
        the index is a 32-byte key of the set, so only a request with a
        key outside it pays for the keys' length check."""
        items = items if isinstance(items, list) else list(items)
        n = len(items)
        if n == 0:
            return
        if set(map(len, map(_SIG, items))) != {64}:
            raise ValueError("malformed ed25519 pubkey or signature")
        lens = array("q", list(map(len, map(_MSG, items))))
        if max(lens) >= 1 << 24:
            raise ValueError("message too large for batch verification")
        rows = None if self._fallback is not None else list(map(self._entry.index.get, map(_PUB, items)))
        if (rows is None or None in rows) and set(map(len, map(_PUB, items))) != {32}:
            raise ValueError("malformed ed25519 pubkey or signature")
        self._items.extend(items)
        if self._fallback is not None:
            for item in items:
                self._fallback.add(*item)
            return
        if None in rows:
            self._demote()
            return
        seen = len(self._row_set)
        self._row_set.update(rows)
        if len(self._row_set) != seen + n:  # a row twice, in this request or across two
            self._demote()
            return
        self._rows.extend(rows)
        if self._handed_over:
            self._sigs, self._msgs, self._lens = bytearray(self._sigs), bytearray(self._msgs), array("q", self._lens)
            self._handed_over = False
        self._sigs += b"".join(map(_SIG, items))
        self._msgs += b"".join(map(_MSG, items))
        self._lens += lens

    def _demote(self) -> None:
        """Hand the batch to the uncached verifier: every item added so
        far, in add() order."""
        self._fallback = Ed25519BatchVerifier(device=self._entry.device)
        for item in self._items:
            self._fallback.add(*item)

    def submit(self):
        """Hand the batch to the staging thread and return at once: the
        ticket exists before the payload is filled.  The stage fills a
        pooled slab, copies it to the card, launches K1 -> K2 -> K4 (under
        a mesh sharded_verify_cached, whose collectives run there),
        starts the copy of the verdicts back and records the completion
        event.  A demoted batch keeps the uncached verifier's own submit,
        in the caller's thread.  Returns an opaque ticket for collect();
        tickets resolve in submission order."""
        if self._fallback is not None:
            release_stage(self._stage_token)
            return self._fallback.submit()
        n = len(self._rows)
        if n == 0:
            release_stage(self._stage_token)
            return ("sync", (False, []))
        entry = self._entry
        idx = np.asarray(self._rows, dtype=np.int64)
        # the stage reads a snapshot: an add() after submit() copies the
        # arrays before it writes, so the ticket stays as it was
        sigs, msgs, lens = self._sigs, self._msgs, np.frombuffer(self._lens, dtype=np.int64).copy()
        self._handed_over = True
        width = 68 + _bucket_mlen(int(lens.max()))
        m = _mhub()
        m.verify_batch_width.observe(float(n))
        m.verify_submit_queue_depth.add(1)

        def stage():
            timings: dict[str, float] = {}
            slab = None
            try:
                t0 = time.perf_counter()
                with tracing.span("verify.slab_fill"):
                    slab = entry.acquire_slab(width)
                    _fill_payload(slab, sigs, msgs, lens, idx)
                t1 = time.perf_counter()
                with tracing.span("verify.h2d_dispatch"), (
                        torch.cuda.device(entry.device) if entry.device.type == "cuda"
                        else contextlib.nullcontext()):
                    if entry.mesh is not None:
                        # each rank copies its own rows of the slab to its device
                        out = sharded_verify_cached(entry.mesh, entry.tables, entry.valid, entry.pubs,
                                                    slab.tensor, entry.b_tables)
                    else:
                        payload = slab.tensor.to(entry.device, non_blocking=True)
                        out = device_verify(entry.tables, entry.valid, entry.pubs, payload, entry.b_tables)
                    if entry.device.type == "cuda":
                        # a fresh pinned buffer a call (its cost: PERF.md)
                        host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
                        host.copy_(out, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(entry.device))
                    else:
                        host, done = out, None
                t2 = time.perf_counter()
            except BaseException:
                # a failed fill or launch must not leak the pooled slab
                if slab is not None:
                    slab.retire()
                    entry.release_slab(slab)
                raise
            finally:
                m.verify_submit_queue_depth.add(-1)
            timings["assembly_ms"] = (t1 - t0) * 1e3
            timings["h2d_dispatch_ms"] = (t2 - t1) * 1e3
            m.verify_phase_seconds.observe(t1 - t0, phase="assembly")
            m.verify_phase_seconds.observe(t2 - t1, phase="h2d_dispatch")
            m.verify_staging_busy.inc(t2 - t0)
            return done, host, slab, timings

        try:
            fut = _staging_executor().put(stage, self._stage_token)
        except BaseException:
            m.verify_submit_queue_depth.add(-1)  # stage() never ran
            raise
        return ("dev", (fut, idx))

    def collect(self, ticket) -> tuple[bool, list[bool]]:
        """Wait for a submit() ticket and unpack (all_ok, per-signature),
        the bitmap indexed in add() order: first the staging thread's
        pass (``staging_wait_ms``), then the card (``device_wait_ms``);
        the slab goes back to the entry's pool once the copy that reads
        it has completed."""
        if self._fallback is not None:
            result = self._fallback.collect(ticket)
            self.last_timings.update(self._fallback.last_timings)
            return result
        kind, payload = ticket
        if kind == "sync":
            return payload
        fut, idx = payload
        t0 = time.perf_counter()
        with tracing.span("verify.staging_wait"):
            done, host, slab, timings = fut.result()
        t1 = time.perf_counter()
        try:
            with tracing.span("verify.device_wait"):
                if done is not None:
                    done.synchronize()
        except BaseException:
            slab.retire()
            self._entry.release_slab(slab)
            raise
        t2 = time.perf_counter()
        self._entry.release_slab(slab)  # the copy has consumed the slab
        timings["staging_wait_ms"] = (t1 - t0) * 1e3
        timings["device_wait_ms"] = (t2 - t1) * 1e3
        m = _mhub()
        m.verify_phase_seconds.observe(t1 - t0, phase="staging_wait")
        m.verify_phase_seconds.observe(t2 - t1, phase="device_wait")
        self.last_timings.update(timings)
        with tracing.span("verify.blame_unpack"):
            out = host.numpy()
            all_ok = bool(out[-1])
            picked = np.unpackbits(out[:-1], count=self._entry.vpad).astype(bool)[idx]
            return all_ok, picked.tolist()

    def verify(self) -> tuple[bool, list[bool]]:
        self.last_timings = {}
        t0 = time.perf_counter()
        with tracing.span("verify.submit"):
            ticket = self.submit()
        t1 = time.perf_counter()
        result = self.collect(ticket)
        t2 = time.perf_counter()
        if ticket[0] == "sync":
            # no stage ran (an empty batch): host_ms, as the JAX verifier
            # reports a ticket resolved inside submit()
            self.last_timings["host_ms"] = (t1 - t0) * 1e3
        else:
            self.last_timings["submit_ms"] = (t1 - t0) * 1e3
            self.last_timings["kernel_ms"] = (t2 - t1) * 1e3
        return result
