"""The port's secp256k1 lane against the JAX package and Python integers:
the plain field / scalar arithmetic of K11-K12 (mod p, mod n, inverse,
square root, at the limbs' maxima), the GLV split and its constants, the
constants compiled into csrc/secp256k1.cuh, the G table and limb
conversions of convert.py, and SecpBatchVerifier(device="cpu") row for
row against the JAX package's _verify_items over an adversarial corpus,
GLV on and off, hashing fused and on the host."""

import pathlib
import re

import numpy as np
import pytest
import torch

from cometbft_tpu.models import secp_verifier as jax_sv
from cometbft_tpu.ops import secp256k1 as J
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.models import secp_verifier as sv
from cometbft_tpu_torch.ops import secp256k1 as S
from torch_secp_corpus import corpus

torch.set_num_threads(1)

P, N = S.P, S.N
ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX256 = (1 << 256) - 1


def _limbs(vals):
    return S._from_words(torch.from_numpy(S.ints_to_words_np(vals)))


def _ints(limbs):
    return S.words_to_ints(S._to_words(limbs))


def _operands(mod, seed):
    """Edge values (0, 1, m - 1, m - 2, limbs at their maxima below m)
    and random ones, as two aligned lists."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "big") % mod for _ in range(24)]
    edge = [0, 1, 2, mod - 1, mod - 2, mod // 2, (1 << 255) % mod, (MAX256 >> 32) % mod]
    a = edge + rand
    b = [mod - 1] * len(edge) + rand[::-1]
    return a, b


# ------------------------------------------------------------ constants


def test_glv_constants_match_the_jax_package():
    assert (S.BETA, S.LAM, S.G1, S.G2, S.M1, S.M2) == (J._BETA, J._LAM, J._G1, J._G2, J._M1, J._M2)
    assert S.GLV_SIGN_BOUND == J._GLV_SIGN_BOUND and S.GLV_WINDOWS == J.NWINDOWS_GLV


def test_header_constants_match_the_derivation():
    """The word literals of csrc/secp256k1.cuh are the values derived in
    ops/secp256k1.py."""
    text = (ROOT / "cometbft_tpu_torch" / "csrc" / "secp256k1.cuh").read_text()
    for name, val in S.header_constants().items():
        define = re.search(r"#define " + name + r" (0x[0-9A-Fa-f]+|\d+)u?\b", text)
        if define:
            got = int(define.group(1), 0)
        else:
            body = re.search(name + r"\[\d+\] = \{([^}]*)\}", text).group(1)
            words = [int(w.strip().rstrip("u"), 16) for w in body.split(",") if w.strip()]
            got = sum(w << (32 * i) for i, w in enumerate(words))
        assert got == val, name
    assert len(S._NM2_NIBBLES) == 64 and all(0 <= d < 16 for d in S._NM2_NIBBLES)
    assert sum(d << (4 * (63 - i)) for i, d in enumerate(S._NM2_NIBBLES)) == N - 2


def test_g_table_from_jax_and_limb_conversion():
    assert torch.equal(convert.g_table_from_jax(J._G_TABLE_NP, device="cpu"), S.g_table("cpu"))
    vals = [0, 1, N - 1, P - 1, MAX256, 0x1234567890ABCDEF << 100]
    assert np.array_equal(convert.words_from_jax_limbs(J.ints_to_limbs_np(vals)), S.ints_to_words_np(vals))
    assert S.words_to_ints(S.ints_to_words_np(vals)) == vals


# ------------------------------------------------------------ arithmetic


@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg"])
def test_plain_field_ops_match_integers(op):
    a, b = _operands(P, seed=1)
    la, lb = _limbs(a), _limbs(b)
    fn = {"mul": S.fp_mul, "add": S.fp_add, "sub": S.fp_sub}.get(op)
    got = _ints(S.fp_neg(la) if op == "neg" else fn(la, lb))
    want = {
        "mul": [x * y % P for x, y in zip(a, b)],
        "add": [(x + y) % P for x, y in zip(a, b)],
        "sub": [(x - y) % P for x, y in zip(a, b)],
        "neg": [(-x) % P for x in a],
    }[op]
    assert got == want


def test_plain_field_reduction_at_limb_maxima():
    """Every limb at 2^16 - 1 (a value above p) in the product and the
    canonical form: the fold's carries ripple through every limb."""
    x = torch.full((3, 16), 0xFFFF, dtype=torch.int64)
    x[1, 0] = 0xFC2E  # p - 1 + 2^256 - p ... just below 2^256
    x[2, 2:] = 0xFFFF
    vals = _ints(x)
    assert _ints(S._fp_canon(x)) == [v % P for v in vals]
    assert _ints(S.fp_mul(x, x)) == [v * v % P for v in vals]


@pytest.mark.parametrize("op", ["inv", "sqrt"])
def test_plain_field_inverse_and_square_root(op):
    a, _ = _operands(P, seed=2)
    a = a[:12]
    la = _limbs(a)
    if op == "inv":
        assert _ints(S.fp_inv(la)) == [pow(x, P - 2, P) for x in a]
    else:
        assert _ints(S.fp_sqrt_cand(la)) == [pow(x, (P + 1) // 4, P) for x in a]


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub", "inv"])
def test_plain_scalar_ops_match_integers(op):
    a, b = _operands(N, seed=3)
    if op == "mont_mul":  # any a < 2^256 against b < n
        a = a[:-2] + [MAX256, N]
        got = _ints(S.sc_mont_mul(_limbs(a), _limbs(b)))
        assert got == [x * y * pow(1 << 256, -1, N) % N for x, y in zip(a, b)]
    elif op == "add":
        assert _ints(S.sc_add(_limbs(a), _limbs(b))) == [(x + y) % N for x, y in zip(a, b)]
    elif op == "sub":
        assert _ints(S.sc_sub(_limbs(a), _limbs(b))) == [(x - y) % N for x, y in zip(a, b)]
    else:
        a = [x for x in a if x][:10]
        xm = _limbs([x * (1 << 256) % N for x in a])
        assert _ints(S.sc_inv_mont(xm)) == [pow(x, N - 2, N) * (1 << 256) % N for x in a]


def test_glv_split_matches_jax_split_host():
    rng = np.random.default_rng(4)
    ks = [0, 1, 2, N - 1, N - 2, N // 2, S.LAM, N - S.LAM]
    ks += [int.from_bytes(rng.bytes(32), "big") % N for _ in range(40)]
    k1, n1, k2, n2 = S.glv_split(_limbs(ks))
    got1 = [(-v if ng else v) for v, ng in zip(_ints(k1), n1.tolist())]
    got2 = [(-v if ng else v) for v, ng in zip(_ints(k2), n2.tolist())]
    want = [J._split_host(k) for k in ks]
    assert list(zip(got1, got2)) == want == [S.split_host(k) for k in ks]
    for k, a, b in zip(ks, got1, got2):
        assert (a + S.LAM * b) % N == k and abs(a) < 1 << 130 and abs(b) < 1 << 130


@pytest.mark.parametrize("nwin", [S.GLV_WINDOWS, S.SHAMIR_WINDOWS])
def test_signed_recoding_reconstructs_the_scalar(nwin):
    rng = np.random.default_rng(5)
    top = 1 << 130 if nwin == S.GLV_WINDOWS else N
    ks = [0, 1, 8, 15, 16, top - 1] + [int.from_bytes(rng.bytes(32), "big") % top for _ in range(30)]
    d = S.recode_signed4(_limbs(ks), nwin)
    assert int(d.abs().max()) <= 8
    assert [sum(int(x) << (4 * i) for i, x in enumerate(row)) for row in d.tolist()] == ks


# ------------------------------------------------------------ verdicts


@pytest.fixture(scope="module")
def items():
    return [r[:3] for r in corpus(b"cpu")]


@pytest.fixture(scope="module")
def jax_verdicts(items):
    return jax_sv._verify_items(items, use_device=False)


def test_corpus_and_host_oracle_match_the_jax_package(items, jax_verdicts):
    ok, res = jax_verdicts
    assert True in res and False in res
    assert [sv._host_verify_one(*it) for it in items] == res
    cpu = sv.CpuSecpBatchVerifier()
    for it in items:
        cpu.add(*it)
    assert cpu.verify() == (ok, res)
    for pub, _, _ in items:
        want = jax_sv._decode_pub(pub) if len(pub) != sv.ECR_PUB else None
        got = sv._decode_pub(pub)
        assert (got[:2] if got else None) == want


@pytest.mark.parametrize("glv", ["1", "0"], ids=["glv", "shamir"])
@pytest.mark.parametrize("hash_min", ["1", "0"], ids=["fused", "host_hash"])
def test_batch_verifier_matches_jax_row_for_row(items, jax_verdicts, monkeypatch, glv, hash_min):
    """SecpBatchVerifier on the CPU (the plain K12 / K11) against the JAX
    package's verdict procedure over the adversarial corpus."""
    monkeypatch.setenv("COMETBFT_TPU_SECP_GLV", glv)
    monkeypatch.setenv("COMETBFT_TPU_SECP_HASH_DEVICE_MIN", hash_min)
    bv = sv.SecpBatchVerifier(device="cpu")
    for it in items:
        bv.add(*it)
    assert bv.verify() == jax_verdicts
    t = bv.last_timings
    assert t["hash_device"] == float(hash_min == "1") and t["glv"] == float(glv == "1") and t["recover"] == 1.0


def test_malformed_rows_cannot_poison_valid_rows():
    """tests/test_secp_ops.py:115 mirrored: s = 0, a malformed key and
    r = 0 around valid rows (the JAX program's shared batch inverse is a
    per-lane inverse here; the verdicts must be the same)."""
    from cometbft_tpu_torch.crypto import secp256k1 as host

    sk = host.PrivKey.from_seed(b"poison-victim")
    msg = b"victim tx"
    victims = [(sk.pub_key().data, msg, sk.sign(msg))] * 11
    attacker = host.PrivKey.from_seed(b"poison-attacker")
    a_sig = attacker.sign(msg)
    poison = [
        (attacker.pub_key().data, msg, a_sig[:32] + b"\x00" * 32),
        (b"\x05" + attacker.pub_key().data[1:], msg, a_sig),
        (attacker.pub_key().data, msg, b"\x00" * 32 + a_sig[32:]),
    ]
    rows = poison + victims + poison
    bv = sv.SecpBatchVerifier(device="cpu")
    for it in rows:
        bv.add(*it)
    ok, res = bv.verify()
    assert res == [False] * 3 + [True] * 11 + [False] * 3 and not ok
    assert jax_sv._verify_items(rows, use_device=False) == (ok, res)


def test_verdict_independent_of_batch_composition():
    """tests/test_secp_ops.py:145 mirrored."""
    from cometbft_tpu_torch.crypto import secp256k1 as host

    sk = host.PrivKey.from_seed(b"compo")
    msg = b"compo tx"
    good = (sk.pub_key().data, msg, sk.sign(msg))
    bad = (sk.pub_key().data, msg, b"\x00" * 64)
    results = []
    for rows in ([good] * 20, [bad, good] * 10):
        bv = sv.SecpBatchVerifier(device="cpu")
        for it in rows:
            bv.add(*it)
        results.append(bv.verify()[1])
    assert results == [[True] * 20, [False, True] * 10]


def test_bucket_and_item_checks_match_the_jax_package():
    for n in (1, 7, 8, 9, 64, 65, 4096):
        assert sv._bucket(n) == jax_sv._bucket(n)
    for pub, sig in ((bytes(33), bytes(63)), (bytes(32), bytes(64)), (bytes(20), bytes(66))):
        with pytest.raises(ValueError):
            sv._check_item(pub, b"", sig)
        with pytest.raises(ValueError):
            jax_sv._check_item(pub, b"", sig)


@pytest.mark.slow
@pytest.mark.parametrize("hash_min", ["1", "0"], ids=["fused", "host_hash"])
def test_batch_verifier_matches_jitted_jax_programs(items, monkeypatch, hash_min):
    """Against the jitted JAX hash_verify_batch / verify_batch (cold CPU
    compile over a minute each: slow)."""
    monkeypatch.setenv("COMETBFT_TPU_SECP_DEVICE_MIN", "1")
    monkeypatch.setenv("COMETBFT_TPU_SECP_HASH_DEVICE_MIN", hash_min)
    want = jax_sv._verify_items(items, use_device=True)
    bv = sv.SecpBatchVerifier(device="cpu")
    for it in items:
        bv.add(*it)
    assert bv.verify() == want
