"""The port's key-value stores (cometbft_tpu_torch/store/db.py) and the
light client's trusted store (cometbft_tpu_torch/light/store.py) against
the JAX package's: the same seeded writes and deletes give the same
iterator and reverse-iterator ranges for every bound, on MemDB, SQLiteDB
(a file under tmp_path) and PrefixDB; a LightStore filled with the same
chain holds the same bytes under the same keys and answers
light_block_before / first / latest / prune / delete_after alike."""

import itertools
import struct

import numpy as np
import pytest

from cometbft_tpu.light.store import LightStore as JLightStore
from cometbft_tpu.store import db as jdb

from cometbft_tpu_torch.light.store import LightStore as PLightStore
from cometbft_tpu_torch.store import db as pdb

import torch_light_chain as LC


def _dbs(kind, tmp_path):
    if kind == "mem":
        return jdb.MemDB(), pdb.MemDB()
    if kind == "sqlite":
        return jdb.SQLiteDB(str(tmp_path / "jax.db")), pdb.SQLiteDB(str(tmp_path / "port.db"))
    return (jdb.PrefixDB(jdb.MemDB(), b"pre\xff"), pdb.PrefixDB(pdb.MemDB(), b"pre\xff"))


def _keys(rng, n):
    alphabet = [b"", b"\x00", b"a", b"ab", b"b", b"\xff", b"\xff\xff", b"lb:", b"lb:\x00"]
    return [rng.choice(alphabet) + rng.bytes(int(rng.integers(0, 3))) for _ in range(n)]


BOUNDS = [None, b"", b"\x00", b"a", b"ab", b"b", b"lb:", b"lb:\xff", b"\xff", b"\xff\xff\xff"]


@pytest.mark.parametrize("kind", ["mem", "sqlite", "prefix"])
def test_iterator_bounds_match_jax(kind, tmp_path):
    rng = np.random.default_rng(77)
    j, p = _dbs(kind, tmp_path)
    keys = _keys(rng, 60)
    for k in keys:
        v = rng.bytes(5)
        j.set(k, v)
        p.set(k, v)
    for k in keys[::7]:
        j.delete(k)
        p.delete(k)
    sets = [(k + b"!", rng.bytes(3)) for k in keys[:5]]
    j.write_batch(sets, keys[1:4])
    p.write_batch(sets, keys[1:4])
    for s, e in itertools.product(BOUNDS, BOUNDS):
        assert list(p.iterator(s, e)) == list(j.iterator(s, e)), (s, e)
        assert list(p.reverse_iterator(s, e)) == list(j.reverse_iterator(s, e)), (s, e)
    for k in keys + [b"missing"]:
        assert p.get(k) == j.get(k) and p.has(k) == j.has(k)
    if kind == "mem":
        assert LC.outcome(lambda: p.set(None, b"x")) == LC.outcome(lambda: j.set(None, b"x")) != ("ok", None)
    j.close()
    p.close()


def test_sqlite_survives_a_reopen(tmp_path):
    path = str(tmp_path / "again.db")
    d = pdb.SQLiteDB(path)
    d.write_batch([(b"k%d" % i, b"v%d" % i) for i in range(5)])
    d.close()
    again = pdb.SQLiteDB(path)
    assert list(again.iterator()) == [(b"k%d" % i, b"v%d" % i) for i in range(5)]
    again.compact()
    again.close()
    assert isinstance(pdb.new_db("x", backend="mem"), pdb.MemDB)
    with pytest.raises(ValueError, match="unknown db backend"):
        pdb.new_db("x", backend="pebble")


CHAIN = LC.Chain(12)


def _stores(kind, tmp_path):
    j, p = _dbs(kind, tmp_path)
    return JLightStore(j), PLightStore(p)


def _heights(store):
    return [struct.unpack(">q", k[3:])[0] for k, _ in store.db.iterator(b"lb:", b"lb:\xff")]


@pytest.mark.parametrize("kind", ["mem", "sqlite"])
def test_light_store_matches_jax(kind, tmp_path):
    js, ps = _stores(kind, tmp_path)
    assert ps.latest_height() == js.latest_height() == 0 and ps.size() == js.size() == 0
    assert ps.first_light_block() is None and ps.latest_light_block() is None
    for h in (5, 1, 9, 3, 12, 7):
        js.save_light_block(CHAIN.jax(h))
        ps.save_light_block(CHAIN.port(h))
    assert list(ps.db.iterator()) == list(js.db.iterator())  # the same keys and bytes
    for h in range(0, 15):
        want, got = js.light_block_before(h), ps.light_block_before(h)
        assert (got is None) == (want is None) and (got is None or got.hash == want.hash), h
        want, got = js.light_block(h), ps.light_block(h)
        assert (got is None) == (want is None) and (got is None or got.to_proto().encode() == want.to_proto().encode())
    assert ps.first_light_block().height == js.first_light_block().height == 1
    assert ps.latest_light_block().height == js.latest_height() == ps.latest_height() == 12
    assert ps.prune(0) == js.prune(0) == 0
    assert ps.prune(4) == js.prune(4) == 2
    assert _heights(ps) == _heights(js) == [5, 7, 9, 12]
    assert ps.prune(10) == js.prune(10) == 0
    assert ps.delete_after(7) == js.delete_after(7) == 2
    assert _heights(ps) == _heights(js) == [5, 7]
    assert ps.delete_after(0) == js.delete_after(0) == 2
    assert ps.size() == js.size() == 0
