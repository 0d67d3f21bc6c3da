"""The port's BLS12-381 G1 plane (K13-K15's plain versions) against the
JAX package and Python integers: the field constants compiled into
csrc/bls381.cuh, the word conversions of convert.py, mul / add / sub
against the jitted JAX field ops (exact), the field ops and the doubling's
add chain at their input maxima (p - 1), g1_double / g1_add with their
edge cases against the jitted JAX g1_add and the host group law (affine),
validate_g1 at N = 8 against the jitted JAX validate_g1 (byte-exact),
aggregate_g1 at odd N against the host Jacobian sum (affine), and the
device routes (validate_g1, validate_aggregate_g1, aggregate_g1) on
device="cpu"."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import bls12381 as JH
from cometbft_tpu.ops import bls381 as J
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import bls12381 as H
from cometbft_tpu_torch.ops import bls381 as B

torch.set_num_threads(1)

P = B.P
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _aff(k: int):
    return H._to_affine(H._FP, H._jac_mul(H._FP, H._from_affine(H._FP, H.G1_GEN), k))


def _wrong_subgroup():
    """An on-curve point outside the r-subgroup (small x; the cofactor is
    ~2^125, so such points essentially never land in the subgroup)."""
    x = 1
    while True:
        y = H._fp_sqrt((x * x * x + 4) % P)
        if y is not None and not H._in_subgroup(H._FP, (x, y)):
            return (x, y)
        x += 1


def _off_curve():
    x = 5
    while H._fp_sqrt((x ** 3 + 4) % P) is not None:
        x += 1
    return (x, 1)


def _words(vals):
    return torch.from_numpy(B.ints_to_words_np([B.to_mont(v) for v in vals]))


def _plain_ints(words):
    return [B.from_mont(v) for v in B.words_to_ints(words)]


def _jac_words(points, zs):
    """Affine points (None = identity) scaled by Z -> Jacobian word
    columns (X, Y, Z)."""
    cols = ([], [], [])
    for a, z in zip(points, zs):
        if a is None:
            X, Y, Z = 1, 1, 0
        else:
            X, Y, Z = a[0] * z * z % P, a[1] * z * z * z % P, z
        for c, v in zip(cols, (X, Y, Z)):
            c.append(v)
    return tuple(_words(c) for c in cols)


def _affine(X, Y, Z):
    return B.jac_to_affine_host(X, Y, Z)


def _host_sum(points):
    acc = (H._FP.one, H._FP.one, H._FP.zero)
    for a in points:
        acc = H._jac_add(H._FP, acc, H._from_affine(H._FP, a))
    return H._to_affine(H._FP, acc)


# ------------------------------------------------------------ constants


def test_header_constants_match_the_derivation():
    """The word literals of csrc/bls381.cuh are the values derived in
    ops/bls381.py, and those are the JAX package's."""
    text = (ROOT / "cometbft_tpu_torch" / "csrc" / "bls381.cuh").read_text()
    for name, val in B.header_constants().items():
        if name == "BLS_PINV":
            got = int(re.search(r"#define BLS_PINV (0x[0-9A-Fa-f]+)u", text).group(1), 16)
        else:
            body = re.search(name + r"\[\d+\] = \{([^}]*)\}", text).group(1)
            words = [int(w.strip().rstrip("u"), 16) for w in body.split(",") if w.strip()]
            got = sum(w << (32 * i) for i, w in enumerate(words))
        assert got == val, name
    assert int(re.search(r"#define BLS_R_TOP (\d+)", text).group(1)) == B.R_ORDER.bit_length() - 1
    assert (B.P, B.R_ORDER, B.R_MONT) == (J.P, J.R_ORDER, J.R_MONT) == (H.P, H.R, J.R_MONT)
    assert B.ints_to_words_np([B.ONE_M, B.B_M]).tolist() == convert.bls_words_from_jax_limbs(
        np.stack([J._ONE_M, J._B_M])).tolist()
    assert B.R_BITS == J._R_BITS.tolist()


def test_word_conversions_round_trip():
    rng = np.random.default_rng(1)
    vals = [0, 1, P - 1, (1 << 384) - 1] + [int.from_bytes(rng.bytes(48), "big") % P for _ in range(16)]
    limbs = np.stack([J._int_to_limbs(v) for v in vals])
    w = convert.bls_words_from_jax_limbs(limbs)
    assert B.words_to_ints(w) == vals
    assert np.array_equal(convert.jax_limbs_from_bls_words(w), limbs)
    assert np.array_equal(w, B.ints_to_words_np(vals))


# ------------------------------------------------------------ field


@pytest.fixture(scope="module")
def jax_field():
    return {name: jax.jit(getattr(J, name)) for name in ("mul", "add", "sub")}


def test_field_ops_match_jax(jax_field):
    """64 random elements and the edges, in Montgomery form: the port's
    plain mul / add / sub equal the jitted JAX ops word for word."""
    rng = np.random.default_rng(7)
    a = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(64)] + [0, 1, P - 1, P - 1]
    b = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(64)] + [P - 1, P - 1, P - 1, 0]
    ja = jnp.asarray(np.stack([J.to_limbs(v) for v in a]))
    jb = jnp.asarray(np.stack([J.to_limbs(v) for v in b]))
    wa, wb = _words(a), _words(b)
    for name in ("mul", "add", "sub"):
        got = getattr(B, name)(wa, wb).numpy()
        want = convert.bls_words_from_jax_limbs(np.asarray(jax_field[name](ja, jb)))
        assert np.array_equal(got, want), name


def test_field_ops_at_input_maxima():
    """p - 1 everywhere: the Montgomery multiply's carries and the add
    chains of the doubling (2D, 3A, 8C) against Python integers."""
    m = P - 1
    wa = _words([m] * 4)
    assert _plain_ints(B.mul(wa, wa)) == [m * m % P] * 4
    assert _plain_ints(B.add(wa, wa)) == [(2 * m) % P] * 4
    assert _plain_ints(B.sub(_words([0] * 4), wa)) == [1] * 4
    # raw Montgomery words at p - 1 (not Montgomery images): a b R^-1
    raw = torch.from_numpy(B.ints_to_words_np([m] * 2))
    assert B.words_to_ints(B.mul(raw, raw)) == [m * m * B.R_INV % P] * 2
    X, Y, Z = (torch.from_numpy(B.ints_to_words_np([m])) for _ in range(3))
    dX, dY, dZ = B.g1_double(X, Y, Z)
    # dbl-2009-l on the raw words, with Python integers
    A, Bv = m * m * B.R_INV % P, m * m * B.R_INV % P
    C = Bv * Bv * B.R_INV % P
    D = 2 * (((m + Bv) % P) ** 2 * B.R_INV - A - C) % P
    E = 3 * A % P
    X3 = (E * E * B.R_INV - 2 * D) % P
    Y3 = (E * ((D - X3) % P) * B.R_INV - 8 * C) % P
    Z3 = 2 * m * m * B.R_INV % P
    assert [B.words_to_ints(t)[0] for t in (dX, dY, dZ)] == [X3, Y3, Z3]


# ------------------------------------------------------------ group


@pytest.fixture(scope="module")
def jax_g1_add():
    return jax.jit(J.g1_add)


def test_g1_add_and_double_match_jax_and_host(jax_g1_add):
    """Random sums, then the four edge cases: infinity on the left, on
    the right, P + P (the doubling) and P + (-P) (infinity), at random
    Z; the port's g1_add, the jitted JAX g1_add and the host group law
    give the same affine points."""
    rng = np.random.default_rng(3)
    ks = [int(rng.integers(2, 1 << 40)) for _ in range(8)]
    p1 = [_aff(k) for k in ks[:4]] + [None, _aff(5), _aff(9), _aff(9)]
    p2 = [_aff(k) for k in ks[4:]] + [_aff(7), None, _aff(9), (_aff(9)[0], P - _aff(9)[1])]
    z1 = [int.from_bytes(rng.bytes(48), "big") % P for _ in p1]
    z2 = [int.from_bytes(rng.bytes(48), "big") % P for _ in p2]
    a, b = _jac_words(p1, z1), _jac_words(p2, z2)
    got = B.g1_add(*a, *b)
    jargs = [jnp.asarray(convert.jax_limbs_from_bls_words(t.numpy())) for t in a + b]
    jout = [torch.from_numpy(convert.bls_words_from_jax_limbs(np.asarray(t))) for t in jax_g1_add(*jargs)]
    for i in range(len(p1)):
        want = H._to_affine(H._FP, H._jac_add(H._FP, H._from_affine(H._FP, p1[i]), H._from_affine(H._FP, p2[i])))
        assert _affine(*(t[i] for t in got)) == want, i
        assert _affine(*(t[i] for t in jout)) == want, i
    assert _affine(*(t[7] for t in got)) is None and _affine(*(t[4] for t in got)) == _aff(7)
    d = B.g1_double(*a)
    for i in range(len(p1)):
        want = H._to_affine(H._FP, H._jac_dbl(H._FP, H._from_affine(H._FP, p1[i])))
        assert _affine(*(t[i] for t in d)) == want, i


def test_mul_order_is_the_subgroup_test():
    """The plain ladder of the JAX package's order (from the identity):
    [r]P is infinity on a subgroup point and not on a wrong-subgroup one."""
    pts = [_aff(11), _wrong_subgroup()]
    X, Y, Z = _jac_words(pts, [3, 5])
    _, _, rZ = B._g1_mul_order(X, Y, Z)
    assert [B.words_to_ints(rZ[i:i + 1])[0] == 0 for i in range(2)] == [True, False]


@pytest.fixture(scope="module")
def jax_validate():
    return jax.jit(J.validate_g1)


def test_validate_g1_matches_jax(jax_validate):
    """N = 8: subgroup keys, a wrong-subgroup key, an off-curve point and
    host-rejected rows (valid = False over a good point, and a None row);
    the port's verdicts equal the jitted JAX validate_g1's byte for byte
    and the host oracle's."""
    good = [_aff(k) for k in (2, 3, 1 << 70, 12345)]
    rows = good + [_wrong_subgroup(), _off_curve(), good[0], None]
    X, Y, valid = J._pack_affine(rows, bucket=8)
    valid[6] = False  # a good point the host decode rejected
    want = np.asarray(jax_validate(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(valid)))
    Xw, Yw = (torch.from_numpy(convert.bls_words_from_jax_limbs(a)) for a in (X, Y))
    got = B.validate_g1(Xw, Yw, torch.from_numpy(valid))
    assert got.tolist() == want.tolist() == [True] * 4 + [False] * 4
    # the port's own packer gives the same words
    Xp, Yp, vp = B.pack_affine(rows)
    assert np.array_equal(Xp, Xw.numpy()) and np.array_equal(Yp[:6], Yw.numpy()[:6])


@pytest.mark.parametrize("n", [1, 3, 33])
def test_aggregate_matches_host_sum(n):
    """aggregate_g1 at odd N (a partial tile, a tile and a row) with
    identity rows, a repeated point (the doubling in the tree) and a
    point beside its negation, against the host Jacobian sum."""
    rng = np.random.default_rng(n)
    pts = [_aff(int(rng.integers(2, 1 << 30))) for _ in range(n)]
    if n >= 3:
        pts[1] = None
        pts[2] = pts[0]
    if n == 33:
        pts[16] = (pts[0][0], P - pts[0][1])  # meets row 0 at the first level
    zs = [int.from_bytes(rng.bytes(48), "big") % P for _ in pts]
    got = B.aggregate_g1(*_jac_words(pts, zs))
    assert _affine(*got) == _host_sum([a for a in pts if a is not None])
    assert B.aggregate_g1(*(t[:0] for t in _jac_words(pts, zs)))[2].eq(0).all()


@pytest.mark.slow
def test_validate_aggregate_matches_jax_program():
    """Against the jitted JAX validate_aggregate_g1 (~60 s cold on the
    CPU): the ok bytes byte for byte, the sum as an affine point."""
    pts = [_aff(k) for k in range(2, 9)]
    rows = pts[:3] + [_wrong_subgroup(), None] + pts[5:]
    X, Y, valid = J._pack_affine(rows, bucket=8)
    jok, jX, jY, jZ = jax.jit(J.validate_aggregate_g1)(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(valid))
    Xw, Yw = (torch.from_numpy(convert.bls_words_from_jax_limbs(a)) for a in (X, Y))
    ok, Xa, Ya, Za = B.validate_aggregate_g1(Xw, Yw, torch.from_numpy(valid))
    assert ok.tolist() == np.asarray(jok).tolist()
    assert _affine(Xa, Ya, Za) == J._jac_to_affine_host(jX, jY, jZ)


# ------------------------------------------------------------ routes


def test_device_routes_on_cpu_match_host():
    """The device routes with device="cpu" (the same packing, the plain
    versions): verdicts and sums equal the host's and the JAX package's
    host helpers'."""
    pts = [_aff(k) for k in (2, 3, 4, 5, 6, 7, 8, 9, 10)]
    rows = list(pts)
    rows[3], rows[5] = None, _wrong_subgroup()
    want_ok = [r is not None and H._in_subgroup(H._FP, r) for r in rows]
    assert B.validate_pubkeys_device(rows, device="cpu") == want_ok
    ok, agg = B.validate_aggregate_device(rows, device="cpu")
    assert ok == want_ok
    assert agg == _host_sum([r for r, o in zip(rows, ok) if o])
    assert B.aggregate_pubkeys_device(pts, device="cpu") == _host_sum(pts)
    assert B.aggregate_pubkeys_device([H._g1_compress(p) for p in pts[:2]] + [None], device="cpu") == _host_sum(pts[:2])
    assert B.aggregate_pubkeys_device([pts[0], (pts[0][0], P - pts[0][1])], device="cpu") is None
    assert B.aggregate_pubkeys_device([], device="cpu") is None
    assert B.validate_pubkeys_device([], device="cpu") == []
    assert B.validate_aggregate_device([], device="cpu") == ([], None)
    assert JH._g1_compress(pts[1]) == H._g1_compress(pts[1])
