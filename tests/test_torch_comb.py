"""Parity of the port's comb half (cometbft_tpu_torch/ops/comb.py: K3
build_a_tables and K4 verify_cached, their plain versions; the fused
models/comb_verifier.device_verify; convert.py) against the JAX package:
its host table builders (numpy, no compile), its host bigint ed25519
verify (cometbft_tpu/crypto/_ref25519.py, plain Python) and, in the slow
tier, its jitted comb program.  Exact equality of canonical table
encodings and verdict bitmaps."""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ref25519 as jref
from cometbft_tpu.ops import comb as jcomb
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519 as host
from cometbft_tpu_torch.models import comb_verifier as cv
from cometbft_tpu_torch.ops import comb

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

V = 8


def _off_curve() -> bytes:
    return next(
        y.to_bytes(32, "little") for y in range(2, 1000)
        if jref.decompress(y.to_bytes(32, "little")) is None
    )


def _non_canonical() -> bytes:
    """An encoding with y >= p that still decodes (ZIP-215 accepts it)."""
    return next(
        (jref.P + d).to_bytes(32, "little") for d in range(19)
        if jref.decompress((jref.P + d).to_bytes(32, "little")) is not None
    )


def _keys(n, base=60):
    return [host.PrivKey.from_seed(bytes([base + i]) * 32) for i in range(n)]


@pytest.fixture(scope="module")
def pubs():
    a = np.stack([np.frombuffer(k.pub_key().data, np.uint8) for k in _keys(V)])
    a[2] = np.frombuffer(_off_curve(), np.uint8)
    a[5] = np.frombuffer(_non_canonical(), np.uint8)
    # x = 0 with the sign bit set: y = 1 decodes to the identity (ZIP-215)
    a[6] = np.frombuffer(((1 << 255) | 1).to_bytes(32, "little"), np.uint8)
    return a


@pytest.fixture(scope="module")
def port_tables(pubs):
    return comb.build_a_tables(torch.from_numpy(pubs))


def test_build_a_tables_matches_jax_host_build(pubs, port_tables):
    tables, valid = port_tables
    jt, jv = jcomb.build_a_tables_host(pubs)
    assert np.array_equal(valid.numpy(), jv)
    assert valid.tolist() == [i != 2 for i in range(V)]
    assert np.array_equal(
        convert.a_tables_to_canonical(tables), convert.jax_a_tables_to_canonical(jt)
    )


def test_build_a_tables_matches_bigint_oracle(pubs, port_tables):
    """The plain K3 against the port's host bigint build, and that host
    build (chip_smoke's oracle on the card) against the JAX package's."""
    tables, valid = port_tables
    th, vh = comb.build_a_tables_host(pubs)
    assert np.array_equal(tables.numpy().view(np.uint32), th)
    assert np.array_equal(valid.numpy(), vh)
    jt, jv = jcomb.build_a_tables_host(pubs)
    assert np.array_equal(vh, jv)
    assert np.array_equal(convert.a_tables_to_canonical(th), convert.jax_a_tables_to_canonical(jt))


def test_tables_from_jax_round_trip(pubs, port_tables):
    tables, valid = port_tables
    jt, jv = jcomb.build_a_tables_host(pubs)
    entry = convert.tables_from_jax(jt, jv, pubs, device="cpu")
    assert torch.equal(entry.tables, tables)
    assert torch.equal(entry.valid, valid)
    assert entry.index[pubs[3].tobytes()] == 3 and entry.vpad == V


def test_b_tables_match_jax():
    jb = jcomb.build_b_tables()
    port = comb.b_tables("cpu")
    assert np.array_equal(convert.b_tables_to_canonical(port), convert.jax_b_tables_to_canonical(jb))
    assert torch.equal(convert.b_tables_from_jax(jb, device="cpu"), port)


def _items(keys, pubs_bytes, bad=()):
    """(pub, msg, sig) rows; `bad` maps index -> kind of planted fault."""
    items = []
    for i, k in enumerate(keys):
        msg = b"comb-%d" % i + bytes(i * 3)  # <= 32 bytes: the maxm = 32 bucket
        sig = k.sign(msg)
        kind = bad.get(i) if bad else None
        if kind == "msg":
            msg = msg[:-1] + bytes([msg[-1] ^ 1])
        elif kind == "s":
            s = int.from_bytes(sig[32:], "little") + jref.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == "r":
            sig = _off_curve() + sig[32:]
        items.append((pubs_bytes[i], msg, sig))
    return items


@pytest.fixture(scope="module")
def signed_set():
    keys = _keys(V, base=90)
    pubs_b = [k.pub_key().data for k in keys]
    cache = cv.ValsetCombCache()
    entry = cache.ensure(pubs_b, device="cpu")
    return keys, pubs_b, entry


@pytest.mark.parametrize("bad", [{}, {1: "msg", 4: "s", 6: "r"}, {0: "msg", 7: "msg"}])
def test_device_verify_matches_host_oracle(signed_set, bad):
    keys, pubs_b, entry = signed_set
    items = _items(keys, pubs_b, bad)
    bv = cv.CombBatchVerifier(entry)
    for it in items:
        bv.add(*it)
    ok, per = bv.verify()
    expect = [jref.verify(p, m, s) for p, m, s in items]
    assert per == expect and ok == all(expect)
    assert set(bv.last_timings) >= {"assembly_ms", "h2d_dispatch_ms", "device_wait_ms", "submit_ms", "kernel_ms"}


def test_device_verify_subset_of_rows_packs_in_packbits_order(signed_set):
    keys, pubs_b, entry = signed_set
    items = _items(keys, pubs_b, {3: "msg"})
    rows = [7, 3, 0, 5]
    payload = cv.assemble_payload([items[i] for i in rows], np.asarray(rows), entry.vpad)
    out = cv.device_verify(entry.tables, entry.valid, entry.pubs, torch.from_numpy(payload), entry.b_tables)
    bits = np.unpackbits(out[:-1].numpy(), count=V).astype(bool)
    assert bits.tolist() == [i in (7, 0, 5) for i in range(V)]
    assert out[-1] == 0
    # the bitmap byte itself: lane 0 is bit 7 of byte 0
    assert out[0] == 0b10000101


def test_slab_reuse_ignores_stale_bytes(signed_set):
    """A recycled slab keeps the previous call's longer messages and live
    flags; the next call must not see them."""
    keys, pubs_b, entry = signed_set
    long_items = [(p, m + bytes(40), keys[i].sign(m + bytes(40))) for i, (p, m, _) in enumerate(_items(keys, pubs_b))]
    for items in (long_items, _items(keys, pubs_b)[:5], _items(keys, pubs_b, {2: "r"})):
        bv = cv.CombBatchVerifier(entry)
        for it in items:
            bv.add(*it)
        ok, per = bv.verify()
        assert per == [jref.verify(*it) for it in items]


def _foreign_item(msg=b"m", bad=False):
    k = _keys(1, base=200)[0]
    return (k.pub_key().data, msg, k.sign(msg + (b"!" if bad else b"")))


def test_foreign_and_duplicate_keys_name_the_straus_slice(signed_set):
    """A key outside the cached set, or a second signature under one key,
    demotes the comb batch to the uncached (Straus) verifier, which
    answers every item in add() order: the verdicts equal the JAX
    package's CombBatchVerifier (which demotes the same way) and the host
    oracle."""
    from cometbft_tpu.models import comb_verifier as jcv

    keys, pubs_b, entry = signed_set
    items = _items(keys, pubs_b, {4: "s", 6: "r"})
    batches = {
        # a second signature under key 0, then more members of the set
        "duplicate": items[:3] + [items[0]] + items[3:7],
        # foreign keys first and later, one signing a message it never saw
        "foreign": [_foreign_item()] + items[:5] + [_foreign_item(b"m2", bad=True)] + items[5:],
    }
    jentry = jcv.ValsetCombCache().ensure(pubs_b)
    for name, batch in batches.items():
        bv, jbv = cv.CombBatchVerifier(entry), jcv.CombBatchVerifier(jentry)
        for it in batch:
            bv.add(*it)
            jbv.add(*it)
        ok, per = bv.verify()
        expect = [jref.verify(p, m, s) for p, m, s in batch]
        assert (ok, per) == jbv.verify(), name
        assert per == expect and ok == all(expect) and not ok, name
        assert set(bv.last_timings) >= {"assembly_ms", "h2d_dispatch_ms", "device_wait_ms"}
    with pytest.raises(ValueError):
        cv.CombBatchVerifier(entry).add(pubs_b[1], b"m", b"short")


@pytest.mark.slow
def test_device_verify_matches_jax_program(pubs):
    """The port's fused device_verify against the JAX package's jitted
    _device_verify at V = 8, maxm = 32 (slow: its cold CPU compile takes
    over a minute)."""
    import jax
    import jax.numpy as jnp

    from cometbft_tpu.models.comb_verifier import _device_verify

    keys = _keys(V, base=120)
    pubs_b = [k.pub_key().data for k in keys]
    a = np.stack([np.frombuffer(p, np.uint8) for p in pubs_b])
    jt, jv = jcomb.build_a_tables_host(a)
    entry = convert.tables_from_jax(jt, jv, a, device="cpu")
    items = _items(keys, pubs_b, {1: "msg", 4: "s", 6: "r"})
    rows = [0, 1, 2, 4, 5, 6, 7]  # row 3 did not sign
    payload = cv.assemble_payload([items[i] for i in rows], np.asarray(rows), V)
    assert payload.shape[1] == 68 + 32
    port = cv.device_verify(entry.tables, entry.valid, entry.pubs, torch.from_numpy(payload), entry.b_tables)
    jout = jax.jit(_device_verify)(jnp.asarray(jt), jnp.asarray(jv), jnp.asarray(a), jnp.asarray(payload))
    assert np.array_equal(port.numpy(), np.asarray(jout))
