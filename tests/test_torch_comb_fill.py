"""The comb path's payload fill (cometbft_tpu_torch/models/comb_verifier.py
_fill_payload, fed by CombBatchVerifier.add's packed arrays) against the
JAX package's payload assembly (cometbft_tpu/models/comb_verifier.py
assemble_payload): byte for byte on a fresh slab, for contiguous and
scattered rows, equal and mixed message lengths, every payload width
bucket; the bytes K1 reads on a slab reused across layouts; and the slab
a real stage fills, with an add() after submit() leaving the ticket's
snapshot as it was."""

import threading

import numpy as np
import pytest
import torch

from cometbft_tpu.models import comb_verifier as jcv

from cometbft_tpu_torch.crypto import ed25519 as host
from cometbft_tpu_torch.models import comb_verifier as cv

torch.set_num_threads(1)

V = 40
WAIT = 60.0


def _batch(seed, n, lens, scattered):
    """n items of random 32-byte keys, 64-byte signatures and messages of
    the given lengths, and their rows (0..n-1, or n of V shuffled)."""
    rng = np.random.default_rng(seed)
    items = [(rng.bytes(32), rng.bytes(int(lens[i % len(lens)])), rng.bytes(64)) for i in range(n)]
    rows = rng.permutation(V)[:n] if scattered else np.arange(n)
    return items, np.asarray(rows, dtype=np.int64)


# message lengths: equal, two lengths a byte apart (a commit's sign-bytes),
# odd lengths across the width buckets 100, 132, 196 and 260, and 0
LENS = {
    "equal-125": [125],
    "commit-125-126": [125, 126, 126, 125, 126],
    "odd-mixed": [1, 31, 33, 63, 65, 127, 129, 191, 0],
    "empty": [0],
    "short-equal-7": [7],
}


@pytest.mark.parametrize("scattered", [False, True], ids=["contiguous", "scattered"])
@pytest.mark.parametrize("lens", sorted(LENS))
@pytest.mark.parametrize("n", [1, 2, 17, V])
def test_the_fill_equals_the_jax_assembly(lens, scattered, n):
    items, rows = _batch(n * 31 + len(lens), n, LENS[lens], scattered)
    got = cv.assemble_payload(items, rows, V)
    want = jcv.assemble_payload(items, rows, V)
    assert got.shape == want.shape and got.shape[1] in (100, 132, 196, 260)
    assert np.array_equal(got, want)


def _k1_view(buf):
    """What K1 reads of a slab: every live row's header and its message's
    mlen bytes; the rest is masked."""
    out = []
    for r in np.flatnonzero(buf[:, 67] == 1):
        mlen = int(buf[r, 64]) | int(buf[r, 65]) << 8 | int(buf[r, 66]) << 16
        out.append((int(r), bytes(buf[r, : 68 + mlen])))
    return out


def test_a_reused_slab_reads_as_the_jax_slab():
    """One slab a width, filled again and again across layouts (the same
    rows and length, other rows, mixed lengths, a scattered subset): the
    bytes K1 reads equal the JAX slab's after the same sequence."""
    width = 196
    ours, theirs = cv._PayloadSlab(V, width, pinned=False), jcv._PayloadSlab(V, width)
    seqs = [(V, [125], False), (V, [125], False), (V, [125, 126], False), (12, [120, 128], True),
            (V, [125], False), (V, [126], False), (3, [1], True), (V, [125, 126], False)]
    for k, (n, lens, scattered) in enumerate(seqs):
        items, rows = _batch(1000 + k, n, lens, scattered)
        got = cv._fill_payload(ours, *cv._pack(items), rows)
        want = jcv._fill_payload(theirs, items, rows)
        assert _k1_view(got) == _k1_view(want), k
        assert (got[:, 67] == want[:, 67]).all(), k


def test_the_stage_fills_the_jax_payload_and_keeps_its_snapshot(monkeypatch):
    """A real CombBatchVerifier on the CPU: the slab its stage fills is
    the JAX assembly of the batch as it was at submit(); a late add()
    (another validator's row) changes neither the slab nor the verdicts."""
    rng = np.random.default_rng(2033)
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(24)]
    pubs = [k.pub_key().data for k in keys]
    entry = cv.ValsetCombCache().ensure(pubs, device="cpu")
    order = rng.permutation(24)[:20]
    items = []
    for j, i in enumerate(order):
        m = b"fill-%d-" % j + rng.bytes(int(rng.integers(110, 131)))
        items.append((pubs[i], m + (b"!" if j == 4 else b""), keys[i].sign(m)))
    late_i = next(i for i in range(24) if i not in order)
    late = (pubs[late_i], b"late", keys[late_i].sign(b"late"))
    filled = []
    real_fill = cv._fill_payload

    def capture(slab, *packed_and_rows):
        out = real_fill(slab, *packed_and_rows)
        filled.append(out.copy())
        return out

    monkeypatch.setattr(cv, "_fill_payload", capture)
    gate = threading.Event()
    lane = cv._staging_executor()
    lane.put(lambda: gate.wait(WAIT))
    bv = cv.CombBatchVerifier(entry)
    for it in items:
        bv.add(*it)
    ticket = bv.submit()
    bv.add(*late)  # after submit: the ticket keeps its snapshot
    gate.set()
    ok, per = bv.collect(ticket)
    rows = np.asarray([entry.index[p] for p, _, _ in items], dtype=np.int64)
    (slab,) = filled
    assert np.array_equal(slab, jcv.assemble_payload(items, rows, entry.vpad))
    assert (ok, per) == (False, [j != 4 for j in range(20)])
    # the batch with the late item, submitted again, sees all 21
    ok2, per2 = bv.verify()
    assert len(per2) == 21 and per2[-1] is True and per2[4] is False and len(filled) == 2
    assert np.array_equal(filled[1], jcv.assemble_payload(items + [late], np.append(rows, late_i), entry.vpad))


def test_a_demoted_batch_replays_its_items_in_add_order():
    """A key outside the set demotes the batch: the uncached verifier
    gets every item in add() order, the ones packed before it included."""
    rng = np.random.default_rng(2034)
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(9)]
    pubs = [k.pub_key().data for k in keys]
    entry = cv.ValsetCombCache().ensure(pubs[:8], device="cpu")
    items = [(pubs[i], b"demote-%d" % i, keys[i].sign(b"demote-%d" % i)) for i in (3, 1, 8, 5)]
    items[1] = (items[1][0], items[1][1] + b"!", items[1][2])
    bv = cv.CombBatchVerifier(entry)
    for it in items:
        bv.add(*it)
    assert bv._fallback is not None and bv._fallback._items == items
    assert bv.verify() == (False, [True, False, True, True])


def _signed(seed, nkeys, nset):
    """nkeys host keys of which the first nset make the cached set."""
    rng = np.random.default_rng(seed)
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(nkeys)]
    pubs = [k.pub_key().data for k in keys]
    return rng, keys, pubs, cv.ValsetCombCache().ensure(pubs[:nset], device="cpu")


def _item(keys, pubs, i, tag, flip=False):
    m = b"bulk-%d-%s" % (i, tag)
    return (pubs[i], m + (b"!" if flip else b""), keys[i].sign(m))


def _state(bv):
    return (list(bv._items), list(bv._rows), bytes(bv._sigs), bytes(bv._msgs), list(bv._lens),
            None if bv._fallback is None else list(bv._fallback._items))


@pytest.mark.parametrize("split", [[20], [7, 13], [1, 1, 18], [0, 20]], ids=["one", "two", "three", "empty-first"])
def test_add_many_packs_as_the_per_item_adds(split):
    """add_many over a request (or over several) leaves the batch exactly
    as the per-item adds do, and its stage fills the JAX payload."""
    rng, keys, pubs, entry = _signed(2040, 24, 24)
    order = rng.permutation(24)[:20]
    items = [_item(keys, pubs, int(i), b"x" * int(rng.integers(100, 140)), flip=(j == 9))
             for j, i in enumerate(order)]
    one, bulk = cv.CombBatchVerifier(entry), cv.CombBatchVerifier(entry)
    for it in items:
        one.add(*it)
    k = 0
    for n in split:
        bulk.add_many(items[k:k + n])
        k += n
    assert _state(bulk) == _state(one) and bulk._fallback is None
    rows = np.asarray([entry.index[p] for p, _, _ in items], dtype=np.int64)
    got = cv._fill_payload(cv._PayloadSlab(entry.vpad, cv._payload_width(items), pinned=False),
                           bytes(bulk._sigs), bytes(bulk._msgs), np.frombuffer(bulk._lens, dtype=np.int64), rows)
    assert np.array_equal(got, jcv.assemble_payload(items, rows, entry.vpad))
    assert bulk.verify() == one.verify() == (False, [j != 9 for j in range(20)])


@pytest.mark.parametrize("case", ["foreign", "repeat-within", "repeat-across", "foreign-after-demoted"])
def test_add_many_demotes_as_add_does(case):
    """A key outside the set, or a row twice (within one request or
    against an earlier one), demotes the batch before anything of the
    request is packed; the uncached verifier gets every item in add()
    order, as the per-item adds give it."""
    rng, keys, pubs, entry = _signed(2041, 12, 10)
    first = [_item(keys, pubs, i, b"a") for i in (4, 2, 7)]
    if case == "foreign":
        second = [_item(keys, pubs, i, b"b", flip=(i == 1)) for i in (1, 11, 3)]
    elif case == "repeat-within":
        second = [_item(keys, pubs, i, b"b") for i in (1, 5, 1)]
    elif case == "repeat-across":
        second = [_item(keys, pubs, i, b"b", flip=(i == 2)) for i in (0, 2)]
    else:
        second = [_item(keys, pubs, i, b"b") for i in (10, 0)]
    third = [_item(keys, pubs, i, b"c") for i in (6, 8)]
    one, bulk = cv.CombBatchVerifier(entry), cv.CombBatchVerifier(entry)
    for it in first + second + third:
        one.add(*it)
    for req in (first, second, third):
        bulk.add_many(req)
    assert bulk._fallback is not None and one._fallback is not None
    assert bulk._fallback._items == one._fallback._items == bulk._items == first + second + third
    assert bulk.verify() == one.verify()


def test_add_many_after_submit_keeps_the_tickets_snapshot():
    """add_many after submit() copies the packed arrays first: the ticket
    verifies the batch as it was, and the next verify sees every item."""
    rng, keys, pubs, entry = _signed(2042, 16, 16)
    items = [_item(keys, pubs, i, b"s", flip=(i == 3)) for i in range(10)]
    late = [_item(keys, pubs, i, b"late") for i in (12, 14)]
    filled = []
    real_fill = cv._fill_payload

    def capture(slab, *packed_and_rows):
        out = real_fill(slab, *packed_and_rows)
        filled.append(out.copy())
        return out

    gate = threading.Event()
    cv._staging_executor().put(lambda: gate.wait(WAIT))
    bv = cv.CombBatchVerifier(entry)
    try:
        cv._fill_payload = capture
        bv.add_many(items)
        ticket = bv.submit()
        bv.add_many(late)
        gate.set()
        assert bv.collect(ticket) == (False, [i != 3 for i in range(10)])
        assert bv.verify() == (False, [i != 3 for i in range(10)] + [True, True])
    finally:
        cv._fill_payload = real_fill
        gate.set()
    rows = np.arange(10, dtype=np.int64)
    assert np.array_equal(filled[0], jcv.assemble_payload(items, rows, entry.vpad))
    assert np.array_equal(filled[1], jcv.assemble_payload(items + late, np.append(rows, [12, 14]), entry.vpad))


@pytest.mark.parametrize("bad", ["pub", "sig", "mlen"])
def test_add_many_refuses_malformed_items_whole(bad):
    """The length checks of add(), over the whole request before any item
    is added."""
    rng, keys, pubs, entry = _signed(2043, 4, 4)
    items = [_item(keys, pubs, i, b"m") for i in range(4)]
    p, m, s = items[2]
    items[2] = {"pub": (p[:31], m, s), "sig": (p, m, s + b"\0"), "mlen": (p, b"\0" * (1 << 24), s)}[bad]
    bv = cv.CombBatchVerifier(entry)
    with pytest.raises(ValueError):
        bv.add_many(items)
    with pytest.raises(ValueError):
        cv.CombBatchVerifier(entry).add(*items[2])
    assert len(bv) == 0 and bv._fallback is None and not bv._sigs


def test_the_service_packs_a_comb_request_with_one_add_many(monkeypatch):
    """The verify service's dispatch hands a comb request to add_many
    once, and add() not at all; the verdicts are the per-item ones."""
    from cometbft_tpu_torch.verifysvc import service as S
    from cometbft_tpu_torch.verifysvc.service import Klass

    rng, keys, pubs, entry = _signed(2044, 12, 12)
    items = [_item(keys, pubs, i, b"svc", flip=(i == 5)) for i in range(12)]
    calls = {"add": 0, "add_many": 0}
    real_add, real_many = cv.CombBatchVerifier.add, cv.CombBatchVerifier.add_many

    def add(self, *a):
        calls["add"] += 1
        return real_add(self, *a)

    def add_many(self, its):
        calls["add_many"] += 1
        return real_many(self, its)

    monkeypatch.setattr(cv.CombBatchVerifier, "add", add)
    monkeypatch.setattr(cv.CombBatchVerifier, "add_many", add_many)
    svc = S.VerifyService(device="cpu")
    try:
        t = svc.submit(items, Klass.CONSENSUS, mode=("comb", entry))
        ok, per = t.collect(WAIT)
    finally:
        svc.stop()
    assert calls == {"add": 0, "add_many": 1}
    assert (ok, per) == (False, [i != 5 for i in range(12)])
