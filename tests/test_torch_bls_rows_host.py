"""K13's and K15's row body (csrc/bls381.cuh: bls_validate_row on
g1_double / g1_madd, and the tile tree on g1_add) built for the host:
g++ compiles the header, and the harness runs it row by row and tile by
tile on the block-edge and small-order rows of tests/torch_bls_corpus.py.
Verdict bytes are held against the port's plain K13
(ops/bls381.validate_g1_plain), the corpus's kinds and the JAX package's
host oracle (cometbft_tpu/crypto/bls12381.py); the tile partials against
the plain version's tile tree word for word; g1_double and g1_madd, and
the ladder's end point, against the JAX package's host group law, on the
identity, equal and opposite operands and points of order 3 and 11
(whose ladders meet those cases mid-way).  Copies of the header with a
planted fault in a completeness branch must fail.  Skips only where no
host C++ compiler exists.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import bls12381 as J
from cometbft_tpu_torch.ops import bls381 as B
import torch_bls_corpus as C

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"
SEED = 11

HARNESS = r"""
#include "bls381.cuh"

static void h_pt(g1p& p, const u32* w) {
  for (int i = 0; i < BLS_W; i++) {
    p.X[i] = w[i];
    p.Y[i] = w[BLS_W + i];
    p.Z[i] = w[2 * BLS_W + i];
  }
}

static void h_words(u32* w, const g1p& p) {
  for (int i = 0; i < BLS_W; i++) {
    w[i] = p.X[i];
    w[BLS_W + i] = p.Y[i];
    w[2 * BLS_W + i] = p.Z[i];
  }
}

extern "C" {
void h_validate(const u32* X, const u32* Y, const uint8_t* valid, uint8_t* ok, int n) {
  for (int i = 0; i < n; i++) ok[i] = bls_validate_row(X + BLS_W * i, Y + BLS_W * i, valid[i] != 0);
}

// K15's tile stage: each tile's rows (the identity past n or where a row
// fails), summed in sm_tree's order (point t + s into point t)
void h_tiles(const u32* X, const u32* Y, const uint8_t* valid, uint8_t* ok, u32* partials, int n) {
  const int tiles = (n + 31) / 32;
  for (int b = 0; b < tiles; b++) {
    g1p pts[32];
    for (int t = 0; t < 32; t++) {
      const int i = b * 32 + t;
      g1_set_identity(pts[t]);
      if (i < n) {
        ok[i] = bls_validate_row(X + BLS_W * i, Y + BLS_W * i, valid[i] != 0);
        if (ok[i]) {
          fe_copy(pts[t].X, X + BLS_W * i);
          fe_copy(pts[t].Y, Y + BLS_W * i);
          fe_copy(pts[t].Z, BLS_ONE_M);
        }
      }
    }
    for (int s = 16; s > 0; s >>= 1)
      for (int t = 0; t < s; t++) g1_add(pts[t], pts[t], pts[t + s]);
    h_words(partials + (size_t)b * BLS_PT, pts[0]);
  }
}

// for n (p, (x2, y2)) pairs: g1_double(p), g1_madd(p, (x2, y2))
void h_ops(const u32* ps, const u32* qs, u32* out, int n) {
  for (int i = 0; i < n; i++) {
    g1p p, r;
    h_pt(p, ps + BLS_PT * i);
    const u32* x2 = qs + 2 * BLS_W * i;
    g1_double(r, p);
    h_words(out + 2 * BLS_PT * i, r);
    g1_madd(r, p, x2, x2 + BLS_W);
    h_words(out + 2 * BLS_PT * i + BLS_PT, r);
  }
}

// bls_validate_row's ladder from acc = P: its end point
void h_ladder(const u32* X, const u32* Y, u32* out, int n) {
  for (int i = 0; i < n; i++) {
    const u32* x = X + BLS_W * i;
    const u32* y = Y + BLS_W * i;
    g1p acc;
    fe_copy(acc.X, x);
    fe_copy(acc.Y, y);
    fe_copy(acc.Z, BLS_ONE_M);
    for (int bit = BLS_R_TOP - 1; bit >= 0; bit--) {
      g1_double(acc, acc);
      if ((BLS_R[bit >> 5] >> (bit & 31)) & 1u) g1_madd(acc, acc, x, y);
    }
    h_words(out + BLS_PT * i, acc);
  }
}
}
"""

# name -> (the text of the shipped header, the fault put in its place)
MUTATIONS = {
    # equal points summed as opposite ones
    "equal_points": ("      g1_double(r, p);  // equal points", "      g1_set_identity(r);  // equal points"),
    # opposite points doubled
    "opposite_points": ("      g1_set_identity(r);  // opposite points", "      g1_double(r, p);  // opposite points"),
    # the identity plus an affine point keeps a wrong y
    "infinity_operand": ("    fe_copy(r.Y, y2);\n    fe_copy(r.Z, BLS_ONE_M);", "    fe_copy(r.Y, x2);\n    fe_copy(r.Z, BLS_ONE_M);"),
}


def _build(csrc: pathlib.Path, tmp: pathlib.Path) -> ctypes.CDLL:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/bls381.cuh with")
    src, out = tmp / "harness.cpp", tmp / "libbls_rows.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(csrc), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    h.h_validate.argtypes = [P_] * 4 + [I_]
    h.h_tiles.argtypes = [P_] * 5 + [I_]
    h.h_ops.argtypes = [P_] * 3 + [I_]
    h.h_ladder.argtypes = [P_] * 3 + [I_]
    return h


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("bls_rows"))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _cases():
    """(name, batch) for every block-edge size in the mixed mode, and a
    batch of each other mode."""
    out = [(f"mixed{n}", C.batch(n, SEED + n)) for n in C.EDGE_SIZES]
    out += [("valid40", C.batch(40, SEED, "valid")), ("prefail9", C.batch(9, SEED, "prefail")),
            ("small12", C.batch(12, SEED, "small")), ("mixed70", C.batch(70, SEED + 70))]
    return out


@pytest.fixture(scope="module")
def cases():
    """Every case's packed rows and the plain K13's verdicts (one plain
    call over all rows: its verdicts are row by row)."""
    named = _cases()
    packed = [C.pack(b) for _, b in named]
    X, Y, v = (np.concatenate([p[k] for p in packed]) for k in range(3))
    plain = B.validate_g1_plain(torch.from_numpy(X), torch.from_numpy(Y), torch.from_numpy(v)).numpy()
    out, o = [], 0
    for (name, b), (x, y, vv) in zip(named, packed):
        n = x.shape[0]
        out.append((name, b, (x, y, vv), plain[o : o + n]))
        o += n
    return out


def _verdicts(lib, packed) -> np.ndarray:
    X, Y, v = packed
    ok = np.full(X.shape[0], 0xAA, np.uint8)
    lib.h_validate(_ptr(X), _ptr(Y), _ptr(v.astype(np.uint8)), _ptr(ok), X.shape[0])
    return ok


def _plain_partials(packed, ok: np.ndarray) -> np.ndarray:
    """The plain version's tile partials: the rows that validated, the
    identity for the rest, summed in the tiles' tree."""
    X, Y, _ = packed
    n = X.shape[0]
    x, y = B._w(torch.from_numpy(X)), B._w(torch.from_numpy(Y))
    ident = B._ident(x)
    okt = torch.from_numpy(ok.astype(bool))
    pts = (B._where(okt, x, ident[0]), B._where(okt, y, ident[1]), B._where(okt, ident[0], ident[2]))
    g = -(-n // B.TILE)
    part = B._tree(B._pad_rows(pts, g * B.TILE), B.TILE)
    return torch.cat([B._to_words(c) for c in part], dim=1).numpy().astype(np.uint32)


def test_corpus_matches_jax_host_oracle(cases):
    """Every row's expected verdict is the JAX package's host oracle's, and
    the kinds cover every class."""
    kinds = set()
    for _, b, _, _ in cases:
        for p, k, e in zip(b["points"], b["kinds"], b["expect"]):
            want = p is not None and p[0] < J.P and J._on_curve(J._FP, p) and J._in_subgroup(J._FP, p)
            assert want == e == C.oracle(p), k
            kinds.add(k)
    assert kinds == {"valid", *C.PREFAIL, *C.LADDER_FAIL}


def test_verdicts_and_tiles_match_plain(shipped, cases):
    """Every case: verdict bytes over a poisoned buffer equal the plain
    K13's and the corpus's; every tile partial equals the plain version's
    word for word."""
    for name, b, (X, Y, v), plain in cases:
        got = _verdicts(shipped, (X, Y, v))
        assert got.tolist() == [int(e) for e in b["expect"]], name
        assert np.array_equal(got.astype(bool), plain), name
        n = X.shape[0]
        ok = np.full(n, 0xAA, np.uint8)
        part = np.zeros((-(-n // 32), B.PT_WORDS), np.uint32)
        shipped.h_tiles(_ptr(X), _ptr(Y), _ptr(v.astype(np.uint8)), _ptr(ok), _ptr(part), n)
        assert np.array_equal(ok, got), name
        assert np.array_equal(part, _plain_partials((X, Y, v), ok)), name


def _jac_words(aff, z: int) -> list[int]:
    """Montgomery words of (x z^2, y z^3, z), or of the identity."""
    if aff is None:
        return [B.ONE_M, B.ONE_M, 0]
    x, y = aff
    return [B.to_mont(x * z * z % C.P), B.to_mont(y * z**3 % C.P), B.to_mont(z)]


def _affine(w: np.ndarray):
    X, Y, Z = (B.from_mont(int.from_bytes(w[12 * i : 12 * i + 12].astype("<u4").tobytes(), "little"))
               for i in range(3))
    if Z == 0:
        return None
    zi = pow(Z, C.P - 2, C.P)
    return X * zi * zi % C.P, Y * zi**3 % C.P


def _op_pairs():
    """(p, q) pairs: generic, p at infinity, p == q, p == -q, and points of
    order 3 and 11 against themselves, their doubles and their negations."""
    pts = C.subgroup_points(4, SEED)
    o3, o11 = C.special_rows()["order 3"], C.special_rows()["order 11"]
    neg = lambda a: (a[0], (-a[1]) % C.P)  # noqa: E731
    return [(pts[0], pts[1]), (None, pts[2]), (pts[3], pts[3]), (pts[1], neg(pts[1])), (o3, o3),
            (neg(o3), o3), (o11, o11), (C._mul(o11, 2), o11), (C._mul(o11, 10), o11), (None, o3)]


def _ops(lib) -> tuple[list, np.ndarray]:
    rng = np.random.default_rng(SEED)
    pairs = _op_pairs()
    ps, qs = [], []
    for p, q in pairs:
        ps += _jac_words(p, int(rng.integers(2, 1 << 62)))
        qs += [B.to_mont(q[0]), B.to_mont(q[1])]
    ps, qs = B.ints_to_words_np(ps).astype(np.uint32), B.ints_to_words_np(qs).astype(np.uint32)
    out = np.zeros((len(pairs), 2, B.PT_WORDS), np.uint32)
    lib.h_ops(_ptr(ps), _ptr(qs), _ptr(out), len(pairs))
    return pairs, out


def _ops_agree(pairs, out) -> bool:
    F = J._FP
    for i, (p, q) in enumerate(pairs):
        jp = J._from_affine(F, p) if p is not None else (1, 1, 0)
        if _affine(out[i, 0]) != J._to_affine(F, J._jac_add(F, jp, jp)):
            return False
        if _affine(out[i, 1]) != J._to_affine(F, J._jac_add(F, jp, J._from_affine(F, q))):
            return False
    return True


def test_group_operations_match_host_law(shipped):
    """g1_double and g1_madd against the JAX package's host group law at
    random Z, on the identity, equal and opposite operands and points of
    order 3 and 11."""
    assert _ops_agree(*_ops(shipped))


def test_ladder_end_point_matches_host(shipped):
    """[r]P's accumulator: the identity for a key, and the host's [r]P for
    points of order 3 and 11 and a point outside the subgroup."""
    s = C.special_rows()
    pts = C.subgroup_points(1, SEED) + [s["order 3"], s["order 11"], s["wrong subgroup"]]
    X, Y, _ = B.pack_affine(pts)
    out = np.zeros((len(pts), B.PT_WORDS), np.uint32)
    shipped.h_ladder(_ptr(X), _ptr(Y), _ptr(out), len(pts))
    F = J._FP
    for i, p in enumerate(pts):
        assert _affine(out[i]) == J._to_affine(F, J._jac_mul(F, J._from_affine(F, p), J.R)), i
    assert _affine(out[0]) is None and all(_affine(out[i]) is not None for i in (1, 2, 3))


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_planted_faults_fail(tmp_path, cases, mutation):
    """A copy of the header with one completeness branch broken gives
    another point for some pair above, or another verdict."""
    old, new = MUTATIONS[mutation]
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    path = csrc / "bls381.cuh"
    text = path.read_text()
    assert text.count(old) == 1, mutation
    path.write_text(text.replace(old, new))
    lib = _build(csrc, tmp_path)
    bad = any(not np.array_equal(_verdicts(lib, packed).astype(bool), plain) for _, _, packed, plain in cases)
    assert bad or not _ops_agree(*_ops(lib)), mutation
