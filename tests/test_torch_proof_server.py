"""The port's proof server (cometbft_tpu_torch/models/proof_server.py)
against the JAX package's models/proof_server.py: query items, tree
digests, the LRU tree cache and _prove_items' rows — proofs byte for
byte, typed misses (None) for unknown or evicted trees, out-of-range
indices and malformed items.  Both packages read the same routing
environment variables; the port's device route runs on device="cpu"
(the kernels' plain versions), the JAX package's under JAX_PLATFORMS=cpu."""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import merkle as jcm
from cometbft_tpu.models import proof_server as jps
from cometbft_tpu_torch.models import proof_server as pps

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)


def _tree(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(1, 80))) for _ in range(n)]


def _rows(rows):
    return [None if r is None else (r.total, r.index, r.leaf_hash, r.aunts) for r in rows]


def _register(leaves):
    d = pps.register_tree(leaves)
    assert jps.register_tree(leaves) == d == jps.tree_digest(leaves) == pps.tree_digest(leaves)
    return d


def test_query_codec_matches_jax():
    d = pps.tree_digest([b"a", b"b"])
    for i in (0, 1, 255, 1 << 40):
        assert pps.encode_query(d, i) == jps.encode_query(d, i)
        assert pps.decode_query(pps.encode_query(d, i)) == (d, i)
    for bad in ((d[:31], 0), (d, -1), (d, 1 << 63)):
        with pytest.raises(ValueError):
            pps.encode_query(*bad)
    for item in ((d, b"\x00" * 7, b""), (d, b"\x00" * 8, b"x"), (d[:5], b"\x00" * 8, b"")):
        with pytest.raises(ValueError):
            pps.decode_query(item)


@pytest.mark.parametrize("device_min", ["1", "64"], ids=["device_route", "host_route"])
def test_prove_items_match_jax(device_min, monkeypatch):
    """Two trees (9 and 33 leaves), an unknown digest, out-of-range
    indices and malformed items, interleaved: every row equals the JAX
    package's, on its device and its host route."""
    monkeypatch.setenv("COMETBFT_TPU_PROOF_DEVICE_MIN", device_min)
    t1, t2 = _tree(9, 1), _tree(33, 2)
    d1, d2 = _register(t1), _register(t2)
    unknown = pps.tree_digest([b"never registered"])
    items = []
    for k in range(40):
        items.append(pps.encode_query(d2, (7 * k) % 33))
        if k % 4 == 0:
            items.append(pps.encode_query(d1, k % 9))
    items += [pps.encode_query(unknown, 0), pps.encode_query(d1, 9), pps.encode_query(d2, 1000),
              (d1, b"\x00" * 3, b""), (d1,), pps.encode_query(d1, 8)]
    ok, rows = pps._prove_items(items, device="cpu")
    jok, jrows = jps._prove_items(items, device=True)
    hok, hrows = jps._prove_items(items, device=False)
    assert ok is jok is hok is False
    assert _rows(rows) == _rows(jrows) == _rows(hrows)
    assert sum(r is None for r in rows) == 5
    rows[0].verify(jcm.hash_from_byte_slices(t2, device=False), t2[0])


def test_lru_eviction_gives_typed_misses(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_PROOF_TREE_CACHE", "2")
    trees = [_tree(5, 10 + i) for i in range(3)]
    ds = [_register(t) for t in trees]
    assert pps.tree_leaves(ds[0]) is None and jps.tree_leaves(ds[0]) is None
    assert pps.tree_leaves(ds[2]) == tuple(trees[2])
    # a read refreshes: tree 1 survives the next registration, tree 2 does not
    assert pps.tree_leaves(ds[1]) == tuple(trees[1]) and jps.tree_leaves(ds[1]) == tuple(trees[1])
    ds.append(_register(_tree(4, 20)))
    assert pps.tree_leaves(ds[2]) is None and pps.tree_leaves(ds[1]) is not None
    items = [pps.encode_query(d, 0) for d in ds]
    ok, rows = pps._prove_items(items, device="cpu")
    jok, jrows = jps._prove_items(items, device=True)
    assert (ok, _rows(rows)) == (jok, _rows(jrows))
    assert [r is None for r in rows] == [True, False, True, False]


def test_provers_match_jax_provers(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_PROOF_DEVICE_MIN", "1")
    leaves = _tree(17, 3)
    d = _register(leaves)
    cpu, dev, jcpu = pps.CpuProofProver(), pps.ProofProver(device="cpu"), jps.CpuProofProver()
    for i in range(17):
        for p in (cpu, dev, jcpu):
            p.add(*pps.encode_query(d, 16 - i))
    with pytest.raises(ValueError):
        dev.add(d, b"\x00", b"")
    got, want = cpu.verify(), jcpu.verify()
    assert got[0] and dev.verify()[0] and want[0]
    assert _rows(got[1]) == _rows(dev.verify()[1]) == _rows(want[1])
    assert len(dev) == 17 and pps.ProofProver(device="cpu").verify() == (False, [])
