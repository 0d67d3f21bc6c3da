"""K11 / K12's block algorithm (csrc/secp256k1.cuh) built for the host:
g++ compiles the header, whose exchange helpers then run the SECP_T lanes
of a group (and the groups of a block) one after another, step for step
as the card does.  It is held against Python integers, the plain
versions of ops/secp256k1.py and the host oracles: the field multiply
and square at word maxima, the square-root chain, the binary GCD, the
block's batch inversions with decided rows and an infinity accumulator
beside valid rows, and whole-row verdicts (the lanes' sub-walks and
their shuffled sum) over the adversarial corpus for GLV and Shamir,
RECOVER on and off, hashing in the kernel and before it.  Skips only
where no host C++ compiler exists.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu.models import secp_verifier as jax_sv
from cometbft_tpu_torch.models import secp_verifier as sv
from cometbft_tpu_torch.ops import secp256k1 as S
from torch_secp_corpus import corpus, infinity_row

torch.set_num_threads(1)

P, N = S.P, S.N
R = 1 << 256
MAX256 = R - 1
CSRC = pathlib.Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"

HARNESS = r"""
#include "secp256k1.cuh"

static const u32 H_P[8] = {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                           0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};

template <bool GLV, bool RECOVER, bool HASH>
static void run(const SecpIn& in) { secp_block_host<GLV, RECOVER, HASH>(in); }

extern "C" {
int h_lanes(void) { return SECP_T; }
int h_rows(void) { return SECP_ROWS; }

// op: 0 mul, 1 sqr, 2 add, 3 sub, 4 neg, 5 canon, 6 the square-root chain
void h_fp(int op, const u32* a, const u32* b, u32* out, int n) {
  for (int i = 0; i < n; i++) {
    const u32* x = a + 8 * i;
    const u32* y = b + 8 * i;
    u32* z = out + 8 * i;
    switch (op) {
      case 0: fp_mul(z, x, y); break;
      case 1: fp_sqr(z, x); break;
      case 2: fp_add(z, x, y); break;
      case 3: fp_sub(z, x, y); break;
      case 4: fp_neg(z, x); break;
      case 5: fp_canon(z, x); break;
      default: fp_sqrt_cand(z, x); break;
    }
  }
}

// op 0: pt_add(a, b); op 1: a += (bx, by) by pt_madd, falling to the
// doubling on equal points as the walk does.  a: Jacobian X, Y, Z (24
// words a point), b: affine x, y (16); out: Jacobian (24).
void h_pt(int op, const u32* a, const u32* b, u32* out, int n) {
  for (int i = 0; i < n; i++) {
    jac p, q, r;
    w_copy(p.X, a + 24 * i);
    w_copy(p.Y, a + 24 * i + 8);
    w_copy(p.Z, a + 24 * i + 16);
    w_copy(q.X, b + 16 * i);
    w_copy(q.Y, b + 16 * i + 8);
    w_set_small(q.Z, 1);
    if (op == 0) {
      pt_add(r, p, q);
    } else {
      r = p;
      if (pt_madd(r, q.X, q.Y)) r = pt_double_rare(r);
    }
    w_copy(out + 24 * i, r.X);
    w_copy(out + 24 * i + 8, r.Y);
    w_copy(out + 24 * i + 16, r.Z);
  }
}

void h_inv_gcd(const u32* a, u32* out, int n, int mod_n) {
  for (int i = 0; i < n; i++) w_inv_gcd(out + 8 * i, a + 8 * i, mod_n ? SECP_N : H_P);
}

// One block's two trees: row i (< n) is decided (decided[i]) or holds the
// field factor f[i] (0: an infinity accumulator) and the scalar s[i].
void h_block_inverse(const u32* f, const u32* s, const uint8_t* decided, u32* finv, u32* sinv,
                     uint8_t* live, int n) {
  SecpShared* sm = new SecpShared();
  SecpRow* rows = new SecpRow[SECP_ROWS]();
  jac* accs = new jac[SECP_ROWS]();
  grp g;
  for (int gid = 0; gid < SECP_ROWS; gid++) {
    SecpRow& st = rows[gid];
    st.live = gid < n && !decided[gid];
    u32 leaf[8], x[8];
    w_copy(leaf, SECP_ONE_N_MONT);
    if (st.live) {
      w_copy(x, s + 8 * gid);
      sc_mont_mul(leaf, x, SECP_R2N);
    }
    w_copy(sm->sc[SECP_ROWS + gid], leaf);
    u32 z[8];
    w_set_small(z, 0);
    if (gid < n) w_copy(z, f + 8 * gid);
    fp_leaf(sm->fp[SECP_ROWS + gid], st.live, z);
  }
  secp_invert<true>(*sm, rows, accs, g);
  for (int i = 0; i < n; i++) {
    w_copy(finv + 8 * i, sm->fpi[SECP_ROWS + i]);
    w_copy(sinv + 8 * i, sm->sci[SECP_ROWS + i]);
    live[i] = rows[i].live;
  }
  delete[] accs;
  delete[] rows;
  delete sm;
}

// K11 (hash = 0: e given) or K12 (hash = 1) over n rows
void h_verify(const u32* qx, const u32* qy, const uint8_t* q_valid, const u32* e, const u32* r,
              const u32* s, const uint8_t* is_eth, const int32_t* v, const uint8_t* is_rec,
              const uint8_t* addr, const u32* gtab, const uint8_t* sha_blocks,
              const int32_t* sha_active, int sha_nb, const uint8_t* kec_blocks,
              const int32_t* kec_active, int kec_nb, uint8_t* out, int n, int glv, int recover,
              int hash) {
  SecpIn in = {qx, qy, e, r, s, gtab, q_valid, is_eth, is_rec, addr, v,
               sha_blocks, sha_active, sha_nb, kec_blocks, kec_active, kec_nb, out, n};
  const int k = (glv ? 4 : 0) + (recover ? 2 : 0) + (hash ? 1 : 0);
  switch (k) {
    case 0: run<false, false, false>(in); break;
    case 1: run<false, false, true>(in); break;
    case 2: run<false, true, false>(in); break;
    case 3: run<false, true, true>(in); break;
    case 4: run<true, false, false>(in); break;
    case 5: run<true, false, true>(in); break;
    case 6: run<true, true, false>(in); break;
    default: run<true, true, true>(in); break;
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/secp256k1.cuh with")
    d = tmp_path_factory.mktemp("secp_groups")
    src, out = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    h.h_fp.argtypes = [I_, P_, P_, P_, I_]
    h.h_pt.argtypes = [I_, P_, P_, P_, I_]
    h.h_inv_gcd.argtypes = [P_, P_, I_, I_]
    h.h_block_inverse.argtypes = [P_] * 6 + [I_]
    h.h_verify.argtypes = [P_] * 13 + [I_, P_, P_, I_, P_] + [I_] * 4
    return h


def _words(vals) -> np.ndarray:
    return np.ascontiguousarray(S.ints_to_words_np(vals).view(np.uint32))


def _ints(w: np.ndarray) -> list[int]:
    return S.words_to_ints(w.view(np.int32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _fp(lib, op: int, a, b=None) -> list[int]:
    wa = _words(a)
    wb = _words(b if b is not None else a)
    out = np.zeros_like(wa)
    lib.h_fp(op, _ptr(wa), _ptr(wb), _ptr(out), len(a))
    return _ints(out)


def _plain(fn, *args) -> list[int]:
    """A plain (ops/secp256k1.py) field function on Python ints."""
    limbs = [S._from_words(torch.from_numpy(S.ints_to_words_np(x))) for x in args]
    return S.words_to_ints(S._to_words(fn(*limbs)))


def _field_operands(seed: int):
    """Word maxima (p - 1, 2^256 - 1 and values whose words are all ones
    or just below p's) beside random values, as two aligned lists."""
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, P - 1, P - 2, MAX256, MAX256 - 1, P, P + 1, (1 << 255) - 1, 1 << 255,
            (MAX256 >> 32) << 32, MAX256 >> 32, 0xFFFFFFFF, (1 << 32) + 977]
    rand = [int.from_bytes(rng.bytes(32), "big") for _ in range(24)]
    a = edge + rand + edge
    b = [MAX256] * len(edge) + rand[::-1] + [P - 1] * len(edge)
    return a, b


def test_harness_runs_the_shipped_group_width(lib):
    assert (lib.h_lanes(), lib.h_rows()) == (4, 32)


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_field_multiply_and_square_at_word_maxima(lib, op):
    """fp_mul / fp_sqr over inputs up to 2^256 - 1 (the fold's worst
    columns) against Python integers, and the plain fp_mul on the
    canonical inputs."""
    a, b = _field_operands(11)
    if op == "mul":
        got, want = _fp(lib, 0, a, b), [x * y % P for x, y in zip(a, b)]
    else:
        got, want = _fp(lib, 1, a), [x * x % P for x in a]
    assert got == want
    canon = [i for i, (x, y) in enumerate(zip(a, b)) if x < P and y < P]
    ca, cb = [a[i] for i in canon], [b[i] for i in canon]
    plain = _plain(S.fp_mul, ca, cb) if op == "mul" else _plain(S.fp_sqr, ca)
    assert [got[i] for i in canon] == plain


@pytest.mark.parametrize("op", ["add", "sub", "neg", "canon"])
def test_field_add_sub_neg_canon(lib, op):
    a, b = _field_operands(12)
    keep = [i for i, (x, y) in enumerate(zip(a, b)) if x < P and y < P]
    ca, cb = [a[i] for i in keep], [b[i] for i in keep]
    if op == "add":
        assert _fp(lib, 2, ca, cb) == [(x + y) % P for x, y in zip(ca, cb)] == _plain(S.fp_add, ca, cb)
    elif op == "sub":
        assert _fp(lib, 3, ca, cb) == [(x - y) % P for x, y in zip(ca, cb)] == _plain(S.fp_sub, ca, cb)
    elif op == "neg":
        assert _fp(lib, 4, ca) == [(-x) % P for x in ca] == _plain(S.fp_neg, ca)
    else:
        assert _fp(lib, 5, a) == [x % P if x >= P else x for x in a]


@pytest.mark.parametrize("kind", ["residues", "any"])
def test_square_root_chain(lib, kind):
    """fp_sqrt_cand's addition chain (the ecrecover lift) against pow and
    the plain version, on squares and on arbitrary values."""
    rng = np.random.default_rng(13 if kind == "any" else 17)
    a = [0, 1, 2, P - 1, 7] + [int.from_bytes(rng.bytes(32), "big") % P for _ in range(5)]
    if kind == "residues":
        a = [x * x % P for x in a]
    got = _fp(lib, 6, a)
    assert got == [pow(x, (P + 1) // 4, P) for x in a] == _plain(S.fp_sqrt_cand, a)
    if kind == "residues":
        assert all(y * y % P == x for x, y in zip(a, got))


@pytest.mark.parametrize("op", ["add", "madd"])
def test_complete_adds_at_equal_and_opposite_points(lib, op):
    """pt_add and the walk's pt_madd (with its fallback to a doubling)
    on distinct, equal and opposite points and an infinity operand, the
    first operand at a random Jacobian scale, against the host's affine
    addition."""
    from cometbft_tpu_torch.crypto import secp256k1 as host

    rng = np.random.default_rng(16)
    pts = [host._mul(int(k), host.G) for k in rng.integers(1, 1 << 62, size=6)]
    pairs = [(pts[0], pts[1]), (pts[2], pts[2]), (pts[3], (pts[3][0], P - pts[3][1])), (None, pts[4]),
             (pts[5], host._add(pts[5], pts[5]))]
    jac, aff = [], []
    for a, b in pairs:
        z = int.from_bytes(rng.bytes(32), "big") % (P - 1) + 1
        jac += [0, 0, 0] if a is None else [a[0] * z * z % P, a[1] * pow(z, 3, P) % P, z]
        aff += list(b)
    wa, wb = _words(jac), _words(aff)
    out = np.zeros_like(wa)
    lib.h_pt(int(op == "madd"), _ptr(wa), _ptr(wb), _ptr(out), len(pairs))
    got = _ints(out)
    for i, (a, b) in enumerate(pairs):
        X, Y, Z = got[3 * i : 3 * i + 3]
        want = host._add(a, b)
        if want is None:
            assert Z == 0, i
        else:
            zi = pow(Z, P - 2, P)
            assert (X * zi * zi % P, Y * pow(zi, 3, P) % P) == want, i


@pytest.mark.parametrize("mod", ["n", "p"])
def test_binary_gcd_inverse(lib, mod):
    m = N if mod == "n" else P
    rng = np.random.default_rng(14)
    a = [1, 2, 3, m - 1, m - 2, m // 2, (1 << 255) % m] + [int.from_bytes(rng.bytes(32), "big") % m for _ in range(16)]
    wa = _words(a)
    out = np.zeros_like(wa)
    lib.h_inv_gcd(_ptr(wa), _ptr(out), len(a), int(mod == "n"))
    assert _ints(out) == [pow(x, m - 2, m) for x in a]
    if mod == "n":  # the plain version's Fermat chain (ops/secp256k1.py sc_inv_mont) agrees
        xm = _plain(lambda t: S.sc_mont_mul(t, S._const(R * R % N, t.device).expand_as(t)), a)
        assert _plain(S.sc_inv_mont, xm) == [pow(x, N - 2, N) * R % N for x in a]


@pytest.mark.parametrize("n_rows", [5, 32])
def test_block_inverse_keeps_rows_apart(lib, n_rows):
    """Montgomery's trick over one block: decided rows and an infinity
    accumulator (Z = 0) enter as 1 and come out false; every other row's
    inverses equal Python's pow, whatever its neighbours hold."""
    rows = lib.h_rows()
    n_rows = min(n_rows, rows)
    rng = np.random.default_rng(15 + n_rows)
    f = [int.from_bytes(rng.bytes(32), "big") % P or 1 for _ in range(n_rows)]
    s = [int.from_bytes(rng.bytes(32), "big") % N or 1 for _ in range(n_rows)]
    decided = np.zeros(n_rows, np.uint8)
    decided[0] = decided[n_rows - 1] = 1  # the block's edges
    f[2] = 0  # an infinity accumulator beside valid rows
    f[1] = P - 1
    s[3] = N - 1
    wf, ws = _words(f), _words(s)
    finv, sinv = np.zeros_like(wf), np.zeros_like(ws)
    live = np.zeros(n_rows, np.uint8)
    lib.h_block_inverse(_ptr(wf), _ptr(ws), _ptr(decided), _ptr(finv), _ptr(sinv), _ptr(live), n_rows)
    fi, si = _ints(finv), _ints(sinv)
    for i in range(n_rows):
        if decided[i] or f[i] == 0:
            assert not live[i] and fi[i] == 1, i
        else:
            assert live[i] and fi[i] == pow(f[i], P - 2, P), i
        if decided[i]:
            assert si[i] == R % N, i  # the Montgomery 1
        else:
            assert si[i] == pow(s[i], N - 2, N) * R % N, i  # s^-1 R, as sc_inv_mont gives


@pytest.fixture(scope="module")
def items():
    return [r[:3] for r in corpus(b"groups")] + [infinity_row(b"groups")]


@pytest.fixture(scope="module")
def expect(items):
    want = [sv._host_verify_one(*it) for it in items]
    assert jax_sv._verify_items(items, use_device=False)[1] == want
    return want


def _verify(lib, st, glv: bool, recover: bool, hash_dev: bool, e=None) -> list[bool]:
    n = st["qx"].shape[0]
    a = {k: np.ascontiguousarray(t.numpy()) for k, t in st.items()}
    gtab = np.ascontiguousarray(S.g_table("cpu").numpy())
    out = np.full(n, 0xAA, np.uint8)
    z8 = np.zeros((max(n, 1), 8), np.int32)
    z1 = np.zeros((max(n, 1),), np.int32)
    eb = np.ascontiguousarray(e.numpy()) if e is not None else z8
    sha_b = a.get("sha_blocks", np.zeros((n, 1, 64), np.uint8))
    kec_b = a.get("kec_blocks", np.zeros((n, 1, 136), np.uint8))
    lib.h_verify(_ptr(a["qx"]), _ptr(a["qy"]), _ptr(a["q_valid"]), _ptr(eb), _ptr(a["r"]), _ptr(a["s"]),
                 _ptr(a["is_eth"]), _ptr(a["v"]), _ptr(a["is_rec"]), _ptr(a["addr"]), _ptr(gtab),
                 _ptr(sha_b), _ptr(a.get("sha_active", z1)), sha_b.shape[1], _ptr(kec_b),
                 _ptr(a.get("kec_active", z1)), kec_b.shape[1], _ptr(out), n, int(glv), int(recover),
                 int(hash_dev))
    assert set(out.tolist()) <= {0, 1}  # every row written, 0xAA overwritten
    return [bool(x) for x in out]


@pytest.mark.parametrize("hash_dev", [True, False], ids=["k12", "k11"])
@pytest.mark.parametrize("recover", [True, False], ids=["recover", "verify"])
@pytest.mark.parametrize("glv", [True, False], ids=["glv", "shamir"])
def test_group_verdicts_match_plain_and_oracles(lib, items, expect, glv, recover, hash_dev):
    """Whole rows through the block algorithm: the corpus (with the
    ecrecover rows when RECOVER) against the host oracles (the port's and
    the JAX package's) row for row, and against the plain K11 / K12."""
    keep = [i for i, it in enumerate(items) if recover or len(it[0]) != sv.ECR_PUB]
    sub = [items[i] for i in keep]
    st = sv.stage_batch(sub, torch.device("cpu"), hash_dev, 119)
    e = None if hash_dev else sv.staged_e(st)
    got = _verify(lib, st, glv, recover, hash_dev, e)
    assert got[: len(sub)] == [expect[i] for i in keep]
    gtab = S.g_table("cpu")
    rows = (st["qx"], st["qy"], st["q_valid"])
    tail = (st["is_eth"], st["v"], st["is_rec"], st["addr"], gtab)
    if glv and recover:  # one plain run a kernel (the plain version is ~4 s a call)
        if hash_dev:
            blocks = (st["sha_blocks"], st["sha_active"], st["kec_blocks"], st["kec_active"])
            want = S.hash_verify_batch_plain(*blocks, *rows, st["r"], st["s"], *tail, glv=glv, recover=recover)
        else:
            want = S.verify_batch_plain(*rows, e, st["r"], st["s"], *tail, glv=glv, recover=recover)
        assert got == want.tolist()


def test_group_verdicts_across_block_edges(lib, items, expect):
    """A batch of 3 blocks and a partial one: the corpus repeated, so
    invalid rows sit at the first and last row of blocks, a block holds a
    single valid row, beside the row at infinity, among failed ones, and
    every row is judged alone."""
    rows = lib.h_rows()
    inf = len(items) - 1
    bad = [i for i, x in enumerate(expect) if not x and i != inf]
    good = [i for i, x in enumerate(expect) if x]
    order = []
    # block 0: bad rows except one valid row in the middle, the infinity row beside it
    order += [bad[k % len(bad)] for k in range(rows)]
    order[rows // 2], order[rows // 2 + 1] = good[0], inf
    # blocks 1-2: the corpus in turn, a bad row at each block's edges
    tail = [k % len(items) for k in range(2 * rows)]
    tail[0] = tail[rows - 1] = tail[rows] = tail[2 * rows - 1] = bad[0]
    order += tail
    # a partial last block
    order += [good[1], bad[1], good[2]]
    batch = [items[i] for i in order]
    st = sv.stage_batch(batch, torch.device("cpu"), True, 119)
    got = _verify(lib, st, True, True, True)
    assert got[: len(batch)] == [expect[i] for i in order]
