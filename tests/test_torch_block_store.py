"""The port's block store (cometbft_tpu_torch/store/block_store.py)
against the JAX package's: one seeded chain (tests/torch_rpc_node.py's
NodeChain, 6 heights of 7 validators, the set moving after height 2)
saved through both packages' BlockStore over MemDB and over SQLiteDB,
then every key and value of the two databases equal byte for byte, every
load_* equal, pruning, deleting the latest block and the contiguity
refusal equal."""

import numpy as np
import pytest
import torch

from cometbft_tpu.store import block_store as JBS
from cometbft_tpu.store import db as JDB
from cometbft_tpu.types import block as JB
from cometbft_tpu.types import part_set as JPS
from cometbft_tpu.wire import types_pb as jpb

from cometbft_tpu_torch import types as T
from cometbft_tpu_torch.state import StateStore
from cometbft_tpu_torch.store import db as PDB
from cometbft_tpu_torch.store.block_store import BlockStore
from cometbft_tpu_torch.utils import metrics

import torch_rpc_node as RN

torch.set_num_threads(1)

HEIGHTS = 6
EXT_AT = 3  # the height saved with an extended commit


@pytest.fixture(autouse=True)
def _limit():
    with RN.time_limit(60):
        yield


@pytest.fixture(scope="module")
def chain():
    keys = RN.make_keys(21, 10)
    ch = RN.NodeChain("block-store-chain", keys, 7, BlockStore(PDB.MemDB()), StateStore(PDB.MemDB()),
                      txs_per_block=5, shift_after=2, shift=2, seed=21, device="cpu")
    for _ in range(HEIGHTS):
        ch.advance()
    return ch


def _extended(commit: T.Commit) -> T.ExtendedCommit:
    return T.ExtendedCommit(commit.height, commit.round, commit.block_id, [
        T.ExtendedCommitSig(cs, b"ext-%d" % i, b"sig-%d" % i) for i, cs in enumerate(commit.signatures)])


def _jax_artifacts(chain, h):
    blk = JB.Block.decode(chain.blocks[h].encode())
    commit = JB.Commit.from_proto(jpb.Commit.decode(chain.commits[h].to_proto().encode()))
    return blk, blk.make_part_set(), commit


def _save(side, store, chain, h):
    if side == "jax":
        blk, ps, commit = _jax_artifacts(chain, h)
        if h == EXT_AT:
            ext = JB.ExtendedCommit.from_proto(jpb.ExtendedCommit.decode(_extended(chain.commits[h]).to_proto().encode()))
            store.save_block_with_extended_commit(blk, ps, ext)
        else:
            store.save_block(blk, ps, commit)
    elif h == EXT_AT:
        store.save_block_with_extended_commit(chain.blocks[h], chain.part_sets[h], _extended(chain.commits[h]))
    else:
        store.save_block(chain.blocks[h], chain.part_sets[h], chain.commits[h])


def _dbs(kind, tmp_path):
    if kind == "mem":
        return JDB.MemDB(), PDB.MemDB()
    return JDB.SQLiteDB(str(tmp_path / "jax.db")), PDB.SQLiteDB(str(tmp_path / "port.db"))


def _contents(db):
    return list(db.iterator(None, None))


def _stores(chain, kind, tmp_path):
    jdb, pdb = _dbs(kind, tmp_path)
    js, ps = JBS.BlockStore(jdb), BlockStore(pdb)
    for h in range(1, HEIGHTS + 1):
        _save("jax", js, chain, h)
        _save("port", ps, chain, h)
    return jdb, pdb, js, ps


@pytest.mark.parametrize("kind", ["mem", "sqlite"])
def test_saved_chain_is_byte_for_byte_the_jax_stores(chain, kind, tmp_path):
    jdb, pdb, js, ps = _stores(chain, kind, tmp_path)
    got, want = _contents(pdb), _contents(jdb)
    # H, BH, SC and one part a height, C for every height below the top,
    # the extended commit and the store's base and height
    assert len(got) == len(want) == 4 * HEIGHTS + (HEIGHTS - 1) + 1 + 1
    assert got == want
    assert (ps.base, ps.height, ps.size()) == (js.base, js.height, js.size()) == (1, HEIGHTS, HEIGHTS)
    # a store reopened on the database reads its base and height back
    again = BlockStore(pdb)
    assert (again.base, again.height) == (1, HEIGHTS)


@pytest.mark.parametrize("kind", ["mem", "sqlite"])
def test_every_load_matches_jax(chain, kind, tmp_path):
    _, _, js, ps = _stores(chain, kind, tmp_path)

    def enc(x):
        return None if x is None else x.to_proto().encode()

    for h in range(0, HEIGHTS + 2):
        assert enc_meta(ps.load_block_meta(h)) == enc_meta(js.load_block_meta(h)), h
        pb_, jb_ = ps.load_block(h), js.load_block(h)
        assert (pb_ is None) == (jb_ is None), h
        if pb_ is not None:
            assert pb_.encode() == jb_.encode() == chain.blocks[h].encode()
            assert ps.load_block_by_hash(pb_.hash()).encode() == js.load_block_by_hash(jb_.hash()).encode()
        assert enc(ps.load_block_commit(h)) == enc(js.load_block_commit(h)), h
        assert enc(ps.load_seen_commit(h)) == enc(js.load_seen_commit(h)), h
        assert enc(ps.load_block_extended_commit(h)) == enc(js.load_block_extended_commit(h)), h
        for i in range(3):
            assert enc(ps.load_block_part(h, i)) == enc(js.load_block_part(h, i)), (h, i)
    # the commit FOR h is the one block h+1 carries; the top has only its seen commit
    assert ps.load_block_commit(HEIGHTS) is None
    assert ps.load_seen_commit(HEIGHTS).to_proto().encode() == chain.commits[HEIGHTS].to_proto().encode()
    assert ps.load_block_commit(2).to_proto().encode() == chain.blocks[3].last_commit.to_proto().encode()
    assert ps.load_block_extended_commit(EXT_AT) is not None and ps.load_block_extended_commit(2) is None
    assert enc_meta(ps.load_base_meta()) == enc_meta(js.load_base_meta())
    assert ps.load_block_by_hash(b"\0" * 32) is None and js.load_block_by_hash(b"\0" * 32) is None
    # a meta's header, id, size and tx count
    meta = ps.load_block_meta(4)
    assert meta.block_id.hash == chain.blocks[4].hash() and meta.num_txs == 5
    assert meta.block_size == chain.part_sets[4].byte_size
    seen = ps.load_seen_commit(1)
    ps.save_seen_commit(1, chain.commits[2])
    js.save_seen_commit(1, _jax_artifacts(chain, 2)[2])
    assert enc(ps.load_seen_commit(1)) == enc(js.load_seen_commit(1)) != enc(seen)


def enc_meta(m):
    return None if m is None else m.encode()


@pytest.mark.parametrize("kind", ["mem", "sqlite"])
def test_prune_and_delete_latest_match_jax(chain, kind, tmp_path):
    jdb, pdb, js, ps = _stores(chain, kind, tmp_path)
    assert ps.prune_blocks(1) == js.prune_blocks(1) == 0
    assert ps.prune_blocks(3) == js.prune_blocks(3) == 2
    assert _contents(pdb) == _contents(jdb)
    assert (ps.base, ps.height) == (js.base, js.height) == (3, HEIGHTS)
    assert ps.load_block(2) is None and ps.load_block(3) is not None
    for store in (ps, js):
        with pytest.raises(ValueError) as e:
            store.prune_blocks(HEIGHTS + 1)
    assert "beyond the latest height" in str(e.value)
    ps.delete_latest_block()
    js.delete_latest_block()
    assert _contents(pdb) == _contents(jdb)
    assert (ps.base, ps.height) == (js.base, js.height) == (3, HEIGHTS - 1)
    assert ps.load_block(HEIGHTS) is None and ps.load_seen_commit(HEIGHTS) is None
    # the deleted height can be saved again, contiguously
    _save("port", ps, chain, HEIGHTS)
    _save("jax", js, chain, HEIGHTS)
    assert _contents(pdb) == _contents(jdb)


def test_contiguity_and_incomplete_part_set_refusals_match_jax(chain):
    js, ps = JBS.BlockStore(JDB.MemDB()), BlockStore(PDB.MemDB())
    _save("jax", js, chain, 1)
    _save("port", ps, chain, 1)
    jblk, jps, jcommit = _jax_artifacts(chain, 3)
    with pytest.raises(ValueError) as ej:
        js.save_block(jblk, jps, jcommit)
    with pytest.raises(ValueError) as ep:
        ps.save_block(chain.blocks[3], chain.part_sets[3], chain.commits[3])
    assert str(ep.value) == str(ej.value) == "BlockStore can only save contiguous blocks. Wanted 2, got 3"
    partial = T.PartSet(chain.part_sets[2].header)
    jpartial = JPS.PartSet(JB.PartSetHeader(partial.header.total, partial.header.hash))
    with pytest.raises(ValueError) as ej:
        js.save_block(_jax_artifacts(chain, 2)[0], jpartial, jcommit)
    with pytest.raises(ValueError) as ep:
        ps.save_block(chain.blocks[2], partial, chain.commits[2])
    assert str(ep.value) == str(ej.value)
    empty_j, empty_p = JBS.BlockStore(JDB.MemDB()), BlockStore(PDB.MemDB())
    with pytest.raises(ValueError) as ej:
        empty_j.delete_latest_block()
    with pytest.raises(ValueError) as ep:
        empty_p.delete_latest_block()
    assert str(ep.value) == str(ej.value)
    assert empty_p.load_base_meta() is None and empty_p.size() == 0


def test_store_access_is_observed_under_the_jax_series(chain):
    hist = metrics.hub().store_access_seconds
    before = {m: _count(hist, m) for m in ("save_block", "load_block")}
    ps = BlockStore(PDB.MemDB())
    _save("port", ps, chain, 1)
    ps.load_block(1)
    assert _count(hist, "save_block") == before["save_block"] + 1
    assert _count(hist, "load_block") == before["load_block"] + 1
    assert hist.name.endswith("store_block_store_access_duration_seconds")


def _count(hist, method):
    text = "\n".join(hist.expose())
    for line in text.splitlines():
        if "_count" in line and f'method="{method}"' in line:
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def test_a_block_of_4096_txs_round_trips_through_its_parts():
    """The size of chip_smoke.py's phase 28 blocks: 1 MiB of data in 16
    parts, every proof checked on the way back."""
    keys = RN.make_keys(22, 4)
    bs = BlockStore(PDB.MemDB())
    ch = RN.NodeChain("big-block-chain", keys, 4, bs, StateStore(PDB.MemDB()), txs_per_block=4096,
                      tx_bytes=256, seed=22, device="cpu")
    block = ch.advance()
    meta = bs.load_block_meta(1)
    total = meta.block_id.part_set_header.total
    assert total == 17 and meta.num_txs == 4096
    recv = T.PartSet(T.PartSetHeader(total, meta.block_id.part_set_header.hash))
    for i in range(total):
        assert recv.add_part(bs.load_block_part(1, i))
    assert T.Block.decode(recv.assemble()).hash() == block.hash()
    assert np.array_equal(np.frombuffer(b"".join(block.data.txs), np.uint8),
                          np.frombuffer(b"".join(bs.load_block(1).data.txs), np.uint8))
