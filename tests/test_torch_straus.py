"""Parity of the port's uncached (Straus) ed25519 path — K5's plain
version in cometbft_tpu_torch/ops/ed25519.py, driven through
models/verifier.Ed25519BatchVerifier — against the JAX package: its host
bigint verify (cometbft_tpu/crypto/_ref25519.py), its windows, B-window
table and host SHA-512 padding and, in the slow tier, its jitted
ops/ed25519.verify_batch (a cold CPU compile of ~150 s).  Planted
faults: a flipped message byte, s >= L, undecodable R and A,
non-canonical y, x = 0 with sign 1, small-order A and R; messages of 1-3
SHA-512 blocks.  Every comparison is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cometbft_tpu.crypto import _ref25519 as jref
from cometbft_tpu.ops import ed25519 as JE
from cometbft_tpu.ops import scalar as jscalar
from cometbft_tpu.ops import sha2 as jsha2
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519 as host
from cometbft_tpu_torch.models.verifier import Ed25519BatchVerifier, stage_batch
from cometbft_tpu_torch.ops import ed25519 as E
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import scalar as S
from cometbft_tpu_torch.ops import sha2

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

P, L = jref.P, jref.L
IDENTITY = (1).to_bytes(32, "little")
IDENTITY_SIGN1 = ((1 << 255) | 1).to_bytes(32, "little")  # x = 0 with sign 1
IDENTITY_NONCANON = (P + 1).to_bytes(32, "little")  # y = p + 1 >= p
ORDER2 = (P - 1).to_bytes(32, "little")  # (0, -1)
ORDER4 = bytes(32)  # y = 0
ORDER8 = bytes.fromhex("26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")


def _off_curve() -> bytes:
    return next(
        y.to_bytes(32, "little") for y in range(2, 1000)
        if jref.decompress(y.to_bytes(32, "little")) is None
    )


def _msg(rng, i):
    """R || A || M of 1, 2 or 3 SHA-512 blocks (M <= 47, <= 175, <= 303 B)."""
    return rng.bytes([0, 20, 47, 48, 100, 175, 176, 250, 303][i % 9])


FAULTS = {
    "msg": "a flipped message byte",
    "s_ge_l": "s + L",
    "bad_r": "an undecodable R",
    "bad_a": "an undecodable A",
    "noncanon": "A and R the identity as y = p + 1, s = 0 (valid)",
    "sign1": "A and R the identity as x = 0 with sign 1, s = 0 (valid)",
    "small": "small-order A and R, s = 0 (valid)",
    "small_s": "small-order A and R, s = 1 (invalid)",
}


def _batch(seed, n=16):
    """n rows of signatures over 1-3-block messages, with every fault of
    FAULTS planted once (rows 1..8); the rest are valid."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        k = host.PrivKey.from_seed(rng.bytes(32))
        m = _msg(rng, i)
        pub, sig = k.pub_key().data, k.sign(m)
        kind = list(FAULTS)[i - 1] if 1 <= i <= len(FAULTS) else None
        if kind == "msg":
            m = m[:-1] + bytes([m[-1] ^ 1]) if m else b"\x01"
        elif kind == "s_ge_l":
            sig = sig[:32] + (int.from_bytes(sig[32:], "little") + L).to_bytes(32, "little")
        elif kind == "bad_r":
            sig = _off_curve() + sig[32:]
        elif kind == "bad_a":
            pub = _off_curve()
        elif kind == "noncanon":
            pub, sig = IDENTITY_NONCANON, IDENTITY_NONCANON + bytes(32)
        elif kind == "sign1":
            pub, sig = IDENTITY_SIGN1, IDENTITY_SIGN1 + bytes(32)
        elif kind == "small":
            pub, sig = ORDER8, ORDER4 + bytes(32)
        elif kind == "small_s":
            pub, sig = ORDER2, ORDER8 + (1).to_bytes(32, "little")
        items.append((pub, m, sig))
    return items


def _expect(items):
    return [jref.verify(p, m, s) for p, m, s in items]


@pytest.fixture(scope="module")
def batch():
    items = _batch(31)
    expect = _expect(items)
    # the planted valid corners decode and pass; the faults fail
    assert expect[1:9] == [False, False, False, False, True, True, True, False]
    return items, expect


def test_verify_batch_matches_host_oracle(batch):
    items, expect = batch
    bv = Ed25519BatchVerifier(device="cpu")
    for it in items:
        bv.add(*it)
    ok, per = bv.verify()
    assert per == expect and ok == all(expect)
    assert set(bv.last_timings) == {
        "assembly_ms", "h2d_dispatch_ms", "device_wait_ms", "submit_ms", "kernel_ms"
    }


@pytest.mark.parametrize("n", [1, 5, 17])
def test_bucket_padding_repeats_row_zero(n):
    """Buckets are powers of two with a floor of 16; padding lanes carry
    row 0 and their verdicts are dropped."""
    items = _batch(32, n)
    a, r, s, blocks, active = stage_batch(items, torch.device("cpu"))
    bucket = 16 if n <= 16 else 32
    assert a.shape == (bucket, 32) and blocks.shape[0] == bucket and active.shape == (bucket,)
    for t in (a, r, s, blocks, active):
        assert all(torch.equal(t[i], t[0]) for i in range(n, bucket))
    bv = Ed25519BatchVerifier(device="cpu")
    for it in items:
        bv.add(*it)
    assert bv.verify()[1] == _expect(items)


def test_empty_batch():
    assert Ed25519BatchVerifier(device="cpu").verify() == (False, [])


def test_pad_messages_sha512_matches_jax():
    rng = np.random.default_rng(33)
    msgs = [rng.bytes(n) for n in (0, 1, 111, 112, 113, 239, 240, 300, 111, 0)]
    for max_len in (None, 400):
        buf, active = sha2.pad_messages_sha512(msgs, max_len)
        jbuf, jactive = jsha2.pad_messages_sha512(msgs, max_len)
        assert np.array_equal(buf, jbuf) and np.array_equal(active, jactive)


def test_windows_match_jax():
    """s windows and k = digest mod L windows, most significant first,
    against the JAX package's bytes_to_windows and limbs_to_windows; the
    signed digits K5 uses carry the same value."""
    rng = np.random.default_rng(34)
    s = rng.integers(0, 256, size=(12, 32), dtype=np.uint8)
    s[0], s[1] = 0, 255
    js = np.asarray(jscalar.bytes_to_windows(jnp.asarray(s)))
    assert np.array_equal(S.bytes_to_windows(torch.from_numpy(s)).numpy(), js)
    d = rng.integers(0, 256, size=(12, 64), dtype=np.uint8)
    k = S.reduce_mod_l(torch.from_numpy(d))
    jk = jscalar.reduce_mod_l(jscalar.bytes_to_limbs(jnp.asarray(d), jscalar.NL_X))
    assert np.array_equal(S.bytes_to_windows(k).numpy(), np.asarray(jscalar.limbs_to_windows(jk)))
    digits = S.signed_digits_radix16(k).flip(0)  # most significant first, as K5 walks them
    for lane in range(12):
        val = 0
        for dg in digits[:, lane].tolist():
            val = 16 * val + dg
        assert val == int.from_bytes(k[lane].numpy().tobytes(), "little") < L


def test_b_window_matches_jax():
    port = E.b_window("cpu")
    assert torch.equal(convert.b_window_from_jax(np.asarray(JE._B_WINDOW), device="cpu"), port)
    # entry j is j * B: its y+x / y-x words against the host group law
    acc = jref.IDENT
    for j in range(16):
        x, y, z, _ = acc
        zi = pow(z, P - 2, P)
        x, y = x * zi % P, y * zi % P
        w = port[j].numpy().astype("<u4").tobytes()
        assert int.from_bytes(w[:32], "little") == (y + x) % P
        assert int.from_bytes(w[32:64], "little") == (y - x) % P
        acc = jref.pt_add(acc, jref.BASE)


def test_var_table_and_lookup_against_bigint():
    """build_var_table / lookup_point give d * a for every signed digit."""
    rng = np.random.default_rng(35)
    keys = [host.PrivKey.from_seed(rng.bytes(32)).pub_key().data for _ in range(17)]
    pt, ok = E.decompress(torch.from_numpy(np.frombuffer(b"".join(keys), np.uint8).reshape(-1, 32).copy()))
    assert bool(ok.all())
    table = E.build_var_table(pt)
    digits = torch.tensor([d for d in range(-8, 9)], dtype=torch.int64)  # one per lane
    c = E.lookup_point(table, digits)
    got = E.add_cached(E.identity((17,), "cpu"), c)
    for lane, d in enumerate(digits.tolist()):
        a = jref.decompress(keys[lane])
        want = jref.pt_mul(abs(d), a)
        if d < 0:
            want = jref.pt_neg(want)
        X, Y, Z = (int.from_bytes(F.to_words(t[:, lane : lane + 1]).numpy().astype("<u4").tobytes(), "little")
                   for t in got[:3])
        assert (X * want[2] - want[0] * Z) % P == 0 and (Y * want[2] - want[1] * Z) % P == 0


def _limb_value(t):
    rows = t.T.tolist()
    return [sum(int(l) << F.OFFSETS[i] for i, l in enumerate(r)) for r in rows]


def _at_max(rng, n, bound, signs):
    """(10, n) limbs within 1000 of ``bound(width)`` in magnitude."""
    mag = np.stack([rng.integers(bound(w) - 1000, bound(w) + 1, size=n) for w in F.WIDTHS])
    return torch.from_numpy(mag * signs)


@pytest.mark.parametrize("pattern", ["all_pos", "all_neg", "alternating", "random"])
def test_straus_add_chain_at_limb_maxima(pattern):
    """Adversarial limbs for the Straus chain's additions (the class of
    the JAX package's uncarried lifted-Niels overflow): the accumulator's
    coordinates at the TIGHT maximum |limb| < 1.01 * 2^w, a cached
    entry's Y+X and Y-X at the LOOSE maximum |limb| < 1.1 * 2^27 (the
    sum of two TIGHT elements, as to_cached leaves them) and its Z, 2dT
    at the TIGHT maximum.  add_cached, the doubling and the B-window
    mixed add that follow must equal the bigint evaluation of the same
    formulas, and leave TIGHT limbs."""
    rng = np.random.default_rng(36)
    n = 16
    signs = {
        "all_pos": np.ones((10, 1), np.int64),
        "all_neg": -np.ones((10, 1), np.int64),
        "alternating": np.where(np.arange(10) % 2, -1, 1)[:, None],
        "random": rng.choice([-1, 1], size=(10, n)),
    }[pattern]
    tight = lambda w: int(1.01 * 2**w) - 1  # noqa: E731
    loose = lambda w: int(1.1 * 2**27) - 1  # noqa: E731
    acc = tuple(_at_max(rng, n, tight, signs) for _ in range(4))
    c = (_at_max(rng, n, loose, signs), _at_max(rng, n, loose, -signs),
         _at_max(rng, n, tight, signs), _at_max(rng, n, tight, -signs))
    X, Y, Z, T = (_limb_value(t) for t in acc)
    ypx, ymx, z2, t2d = (_limb_value(t) for t in c)

    out = E.add_cached(acc, c)
    for i in range(n):
        a, b = (Y[i] - X[i]) * ymx[i], (Y[i] + X[i]) * ypx[i]
        cc, d = T[i] * t2d[i], 2 * Z[i] * z2[i]
        e, f, g, h = b - a, d - cc, d + cc, b + a
        want = [e * f % P, g * h % P, f * g % P, e * h % P]
        assert [v[i] % P for v in map(_limb_value, out)] == want
    for t in out:
        assert int(t.abs().max()) < int(1.01 * 2**26)

    dbl = E.double(acc)
    for i in range(n):
        xx, yy, zz = X[i] ** 2, Y[i] ** 2, Z[i] ** 2
        h, g = xx + yy, yy - xx
        e, f = (X[i] + Y[i]) ** 2 - h, 2 * zz - g
        assert [v[i] % P for v in map(_limb_value, dbl)] == [e * f % P, g * h % P, f * g % P, e * h % P]

    # the B-window mixed add on the add's output (TIGHT) with the
    # canonical entry 15 * B (limbs in [0, 2^w))
    w = E.b_window("cpu")[15]
    nb = E.niels_from_words(w[None].expand(n, 3, 8))
    madd = E.add_niels(out, nb)
    X2, Y2, Z2, T2 = (_limb_value(t) for t in out)
    bp, bm, bt = (int.from_bytes(w[k].numpy().astype("<u4").tobytes(), "little") for k in range(3))
    for i in range(n):
        a, b = (Y2[i] - X2[i]) * bm, (Y2[i] + X2[i]) * bp
        cc, d = T2[i] * bt, 2 * Z2[i]
        e, f, g, h = b - a, d - cc, d + cc, b + a
        assert [v[i] % P for v in map(_limb_value, madd)] == [e * f % P, g * h % P, f * g % P, e * h % P]


def test_wrappers_reject_bad_shapes():
    a = torch.zeros((4, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        E.verify_digest(a, a, a, torch.zeros((4, 63), dtype=torch.uint8))
    with pytest.raises(ValueError):
        E.verify_digest(a, a[:3], a, torch.zeros((4, 64), dtype=torch.uint8))
    with pytest.raises(ValueError):
        Ed25519BatchVerifier(device="cpu").add(b"x" * 31, b"m", b"s" * 64)


@pytest.mark.slow
def test_verify_batch_matches_jax():
    """The port's verify_batch against jax.jit(cometbft_tpu.ops.ed25519.
    verify_batch) at one bucket of 16 with 1-3-block messages (slow: the
    JAX program's cold CPU compile takes ~150 s)."""
    import jax

    items = _batch(37)
    a, r, s, blocks, active = stage_batch(items, torch.device("cpu"))
    port = E.verify_batch(a, r, s, blocks, active)
    jout = jax.jit(JE.verify_batch)(*(jnp.asarray(t.numpy()) for t in (a, r, s, blocks, active)))
    assert blocks.shape == (16, 3, 128)
    assert port.tolist() == np.asarray(jout).tolist() == _expect(items)
