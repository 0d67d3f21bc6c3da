"""Parity of the port's plain field and scalar arithmetic
(cometbft_tpu_torch/ops/field.py, ops/scalar.py — the plain versions of
csrc/fe25519.cuh and csrc/sc25519.cuh) against Python integers
(_ref25519) and the JAX package's ops/scalar.py.  Inputs come from a
numpy seed; every comparison is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cometbft_tpu.ops import scalar as jscalar
from cometbft_tpu_torch.crypto import _ref25519 as ref
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import scalar as S

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

P, L = ref.P, ref.L
EDGE = [0, 1, 2, 19, P - 1, P, P + 1, P + 18, (1 << 255) - 1, (1 << 254), 2 * ref.D % P]


def _ints(seed, n, bits):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes((bits + 7) // 8), "little") % (1 << bits) for _ in range(n)]


def _bytes_tensor(vals, nbytes):
    raw = b"".join(v.to_bytes(nbytes, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(raw, np.uint8).reshape(-1, nbytes).copy())


def _tensor_ints(b):
    return [int.from_bytes(row.tobytes(), "little") for row in b.numpy()]


def _field_ints(f):
    """Canonical integers of a (10, n) field batch."""
    w = F.to_words(f).numpy().astype("<u4")
    return [int.from_bytes(row.tobytes(), "little") for row in w]


def test_field_round_trip():
    vals = EDGE + _ints(1, 64, 255)
    f = F.from_bytes(_bytes_tensor(vals, 32))
    assert _field_ints(f) == [v % P for v in vals]


def test_field_bit_255_is_ignored():
    vals = _ints(2, 16, 255)
    hi = _bytes_tensor([v | (1 << 255) for v in vals], 32)
    assert _field_ints(F.from_bytes(hi)) == [v % P for v in vals]


def test_field_mul_square_add_sub():
    a = EDGE + _ints(3, 48, 255)
    b = list(reversed(EDGE)) + _ints(4, 48, 255)
    fa, fb = F.from_bytes(_bytes_tensor(a, 32)), F.from_bytes(_bytes_tensor(b, 32))
    assert _field_ints(F.mul(fa, fb)) == [x * y % P for x, y in zip(a, b)]
    assert _field_ints(F.square(fa)) == [x * x % P for x in a]
    # LOOSE inputs: sums and differences of two TIGHT elements
    s, d = fa + fb, fa - fb
    assert _field_ints(F.mul(s, d)) == [(x + y) * (x - y) % P for x, y in zip(a, b)]
    assert _field_ints(F.mul(-fa, d)) == [-x * (x - y) % P for x, y in zip(a, b)]


def test_field_invert_and_pow_p58():
    a = [v for v in EDGE if v % P] + _ints(5, 12, 255)
    fa = F.from_bytes(_bytes_tensor(a, 32))
    assert _field_ints(F.invert(fa)) == [pow(x, P - 2, P) for x in a]
    assert _field_ints(F.pow_p58(fa)) == [pow(x, (P - 5) // 8, P) for x in a]


def test_field_predicates():
    vals = [0, P, 1, P + 1, P - 1, 2, 3]
    f = F.from_bytes(_bytes_tensor(vals, 32))
    assert F.is_zero(f).tolist() == [v % P == 0 for v in vals]
    assert F.is_negative(f).tolist() == [(v % P) & 1 == 1 for v in vals]
    g = F.from_bytes(_bytes_tensor([v % P for v in vals], 32))
    assert F.eq(f, g).all()


def _digests(seed, n):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    edge = [0, L - 1, L, L + 1, 2 * L, (1 << 512) - 1, (1 << 253), 7 * L + 3]
    for i, v in enumerate(edge):
        d[i] = np.frombuffer(v.to_bytes(64, "little"), np.uint8)
    return d


@pytest.mark.parametrize("seed", [11, 12])
def test_reduce_mod_l_matches_ints_and_jax(seed):
    d = _digests(seed, 40)
    port = S.reduce_mod_l(torch.from_numpy(d))
    assert _tensor_ints(port) == [int.from_bytes(r.tobytes(), "little") % L for r in d]
    jl = jscalar.reduce_mod_l(jscalar.bytes_to_limbs(jnp.asarray(d), jscalar.NL_X))
    jl = np.asarray(jl).astype(np.int64)  # (22, n) 12-bit limbs
    jax_ints = [sum(int(jl[k, i]) << (12 * k) for k in range(22)) for i in range(d.shape[0])]
    assert _tensor_ints(port) == jax_ints


def test_signed_digits_match_jax():
    d = _digests(13, 32)
    k = S.reduce_mod_l(torch.from_numpy(d))
    port = S.signed_digits_radix16(k).numpy()
    jl = jscalar.reduce_mod_l(jscalar.bytes_to_limbs(jnp.asarray(d), jscalar.NL_X))
    jd = np.asarray(jscalar.signed_digits_radix16(jl, 64))
    assert np.array_equal(port, jd)
    assert port.min() >= -8 and port.max() <= 7
    ks = _tensor_ints(k)
    for i in range(d.shape[0]):
        assert sum(int(port[j, i]) * 16**j for j in range(64)) == ks[i]


def test_s_lt_l_and_radix4096_digits_match_jax():
    rng = np.random.default_rng(14)
    s = rng.integers(0, 256, size=(24, 32), dtype=np.uint8)
    edge = [0, L - 1, L, L + 1, (1 << 256) - 1, (1 << 252), L - (1 << 200)]
    for i, v in enumerate(edge):
        s[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    st = torch.from_numpy(s)
    assert S.s_lt_l(st).tolist() == np.asarray(jscalar.s_lt_l(jnp.asarray(s))).tolist()
    assert S.s_lt_l(st).tolist() == [int.from_bytes(r.tobytes(), "little") < L for r in s]
    jd = np.asarray(jscalar.bytes_to_limbs(jnp.asarray(s), 22))
    assert np.array_equal(S.digits_radix4096(st).numpy(), jd)


def _limb_value(t):
    """Integer value of (10, n) limbs, any signs (host bigint)."""
    rows = t.T.tolist()
    return [sum(int(l) << F.OFFSETS[i] for i, l in enumerate(r)) for r in rows]


@pytest.mark.parametrize("sign_pattern", ["all_pos", "all_neg", "alternating"])
def test_mul_at_the_loose_bound(sign_pattern):
    """Adversarial limbs at the LOOSE bound |limb| < 1.1 * 2^27 (two TIGHT
    terms summed): the int64 column sums must not wrap."""
    top = int(1.1 * 2**27) - 1
    rng = np.random.default_rng(21)
    n = 16
    mag = rng.integers(top - 1000, top + 1, size=(10, n))
    sign = {"all_pos": 1, "all_neg": -1, "alternating": np.where(np.arange(10) % 2, -1, 1)[:, None]}[sign_pattern]
    a = torch.from_numpy(mag * sign)
    b = torch.from_numpy(rng.integers(top - 1000, top + 1, size=(10, n)) * sign)
    want = [x * y % P for x, y in zip(_limb_value(a), _limb_value(b))]
    assert _field_ints(F.mul(a, b)) == want
    # and a TIGHT result: fits the LOOSE bound when two are summed again
    r = F.mul(a, b)
    assert int(r.abs().max()) < int(1.01 * 2**26)


def test_group_law_on_worst_case_canonical_entries():
    """Attacker-chosen pubkeys give arbitrary canonical table words; the
    mixed addition must stay exact for any canonical Niels values (the
    JAX package's uncarried lifted-Niels overflow was this class)."""
    from cometbft_tpu_torch.ops import ed25519 as E

    rng = np.random.default_rng(22)
    n = 12
    vals = [[P - 1 - int(rng.integers(0, 3)) for _ in range(7)] for _ in range(n)]
    vals += [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(7)] for _ in range(n)]
    cols = list(zip(*vals))
    X, Y, Z, T, ypx, ymx, t2d = (F.from_bytes(_bytes_tensor(list(c), 32)) for c in cols)
    for negate in (False, True):
        neg = torch.full((2 * n,), negate)
        nn = E.niels_from_words(
            torch.stack([F.to_words(ypx), F.to_words(ymx), F.to_words(t2d)], dim=-2), negate=neg
        )
        got = [_field_ints(c) for c in E.add_niels((X, Y, Z, T), nn)]
        for i, (x, y, z, t, yp, ym, td) in enumerate(vals):
            if negate:
                yp, ym, td = ym, yp, -td
            a, b, c, d = (y - x) * ym, (y + x) * yp, t * td, 2 * z
            e, f, g, h = b - a, d - c, d + c, b + a
            assert [got[k][i] for k in range(4)] == [e * f % P, g * h % P, f * g % P, e * h % P]
