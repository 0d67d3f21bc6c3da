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
