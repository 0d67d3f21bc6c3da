"""K14's group add and trees (csrc/bls381_group.cuh: bg_add, a group of four
threads sharing each add of the tree) built for the host: g++ compiles
the header, and the harness runs each group's threads in turn (the
host form of the header's exchange).  bg_add is held word for word
against bls381.cuh's one-thread g1_add, and its affine point against the
JAX package's host group law (cometbft_tpu/crypto/bls12381.py), on the
identity, equal and opposite operands and points of order 3 and 11 at
random Z; the kernels' two stages (tiles of 32 rows, then the finishing
stage's fold into 256 lanes and its tree) are held word for word against
the port's plain K14 (ops/bls381.aggregate_g1_plain), at tile edges and
across the fold.  Copies of the header with a planted fault must fail.
Skips only where no host C++ compiler exists.
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
SEED = 14

HARNESS = r"""
#include <vector>

#include "bls381_group.cuh"

static void h_pt(g1p& p, const u32* w) {
  fe_copy(p.X, w);
  fe_copy(p.Y, w + BLS_W);
  fe_copy(p.Z, w + 2 * BLS_W);
}

static void h_words(u32* w, const g1p& p) {
  fe_copy(w, p.X);
  fe_copy(w + BLS_W, p.Y);
  fe_copy(w + 2 * BLS_W, p.Z);
}

// the tree of bls.cu's kernels: point t + s into point t, groups in turn
static void h_tree(u32* pts, int width, u32* file) {
  for (int s = width / 2; s > 0; s >>= 1)
    for (int t = 0; t < s; t++) bg_add(pts + t * BG_PITCH, pts + t * BG_PITCH, pts + (t + s) * BG_PITCH, file, 0, 0);
}

// K14's finishing stage: lane j of 256 = partial j (the identity past g)
// plus partials j + 256, ... in order, summed in the tree
static void h_finish(const u32* partials, int g, u32* out) {
  u32 file[BG_FILE];
  std::vector<u32> pts(256 * BG_PITCH);
  for (int j = 0; j < 256; j++)
    for (int k = 0; k < BLS_PT; k++)
      pts[j * BG_PITCH + k] = j < g ? partials[BLS_PT * j + k] : (k < 2 * BLS_W ? BLS_ONE_M[k % BLS_W] : 0u);
  for (int f = 256; f < g; f += 256)
    for (int t = 0; t < 256 && t + f < g; t++)
      bg_add(pts.data() + t * BG_PITCH, pts.data() + t * BG_PITCH, partials + BLS_PT * (t + f), file, 0, 0);
  h_tree(pts.data(), 256, file);
  for (int k = 0; k < BLS_PT; k++) out[k] = pts[k];
}

extern "C" {
// row i: g1_add(p_i, q_i), the one-thread form
void h_add_ref(const u32* ps, const u32* qs, u32* out, int n) {
  for (int i = 0; i < n; i++) {
    g1p p, q, r;
    h_pt(p, ps + BLS_PT * i);
    h_pt(q, qs + BLS_PT * i);
    g1_add(r, p, q);
    h_words(out + BLS_PT * i, r);
  }
}

// row i: bg_add(p_i, q_i); a word of the aliased call (r = p, as the
// trees call it) that differs flips the word's low bit
void h_add(const u32* ps, const u32* qs, u32* out, int n) {
  u32 file[BG_FILE];
  for (int i = 0; i < n; i++) {
    u32 r[BLS_PT];
    for (int k = 0; k < BLS_PT; k++) r[k] = 0xAAAAAAAAu;
    bg_add(r, ps + BLS_PT * i, qs + BLS_PT * i, file, 0, 0);
    for (int k = 0; k < BLS_PT; k++) out[BLS_PT * i + k] = r[k];
    u32 a[BLS_PT];
    for (int k = 0; k < BLS_PT; k++) a[k] = ps[BLS_PT * i + k];
    bg_add(a, a, qs + BLS_PT * i, file, 0, 0);
    for (int k = 0; k < BLS_PT; k++)
      if (a[k] != r[k]) out[BLS_PT * i + k] ^= 1u;
  }
}

// K14's two stages: tiles of 32 rows (the identity past n), then the
// finishing stage
void h_k14(const u32* X, const u32* Y, const u32* Z, int n, u32* partials, u32* out) {
  const int g = (n + 31) / 32;
  u32 file[BG_FILE], pts[32 * BG_PITCH];
  for (int b = 0; b < g; b++) {
    for (int t = 0; t < 32; t++) {
      const int i = b * 32 + t;
      for (int k = 0; k < BLS_W; k++) {
        pts[t * BG_PITCH + k] = i < n ? X[BLS_W * i + k] : BLS_ONE_M[k];
        pts[t * BG_PITCH + BLS_W + k] = i < n ? Y[BLS_W * i + k] : BLS_ONE_M[k];
        pts[t * BG_PITCH + 2 * BLS_W + k] = i < n ? Z[BLS_W * i + k] : 0u;
      }
    }
    h_tree(pts, 32, file);
    for (int k = 0; k < BLS_PT; k++) partials[BLS_PT * b + k] = pts[k];
  }
  h_finish(partials, g, out);
}
}
"""

# name -> (the text of the shipped header, the fault put in its place)
MUTATIONS = {
    # phase 2 multiplies by the other operand's Z^2
    "phase_2_operand": ("bg_get(f, (j & 1) ? 0 : 1)", "bg_get(f, (j & 1) ? 1 : 0)"),
    # phase 4's third product (Zp H) lands in V's slot
    "phase_4_slot": ("bg_put(f, j == 0 ? 5 : j == 1 ? 7 : 3, fe_mul(a, b));",
                     "bg_put(f, j == 0 ? 5 : j == 1 ? 7 : 7, fe_mul(a, b));"),
    # opposite points summed as equal ones are: the doubling's thread only
    "opposite_points": ("r[w] = w < 2 * BLS_W ? BLS_ONE_M[w % BLS_W] : 0u;", "r[w] = p[w];"),
    # the identity operand's test reads the other point
    "infinity_operand": ("const u32* s = inf1 ? q : p;", "const u32* s = inf1 ? p : q;"),
    # X3 = (2R)^2 - J - V, one V short
    "x3_one_v": ("fe_sub(bg_get(f, 1), fe_add(J, fe_add(V, V)))", "fe_sub(bg_get(f, 1), fe_add(J, V))"),
    # Z3 = Zp H, not doubled
    "z3_undoubled": ("      o = fe_add(o, o);  // 2 Zp H", "      // 2 Zp H dropped"),
}


def _build(csrc: pathlib.Path, tmp: pathlib.Path) -> ctypes.CDLL:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/bls381_group.cuh with")
    src, out = tmp / "harness.cpp", tmp / "libbls_group.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(csrc), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    h.h_add_ref.argtypes = [P_] * 3 + [I_]
    h.h_add.argtypes = [P_] * 3 + [I_]
    h.h_k14.argtypes = [P_] * 3 + [I_] + [P_] * 2
    return h


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("bls_group"))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


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


def _pairs():
    """(p, q) affine pairs: generic, either or both at infinity, p == q,
    p == -q, and points of order 3 and 11 against themselves, their
    negations and their multiples."""
    pts = C.subgroup_points(6, SEED)
    o3, o11 = C.special_rows()["order 3"], C.special_rows()["order 11"]
    neg = lambda a: (a[0], (-a[1]) % C.P)  # noqa: E731
    return [(pts[0], pts[1]), (None, pts[2]), (pts[3], None), (None, None), (pts[4], pts[4]),
            (pts[5], neg(pts[5])), (o3, o3), (neg(o3), o3), (o3, pts[0]), (o11, o11), (C._mul(o11, 2), o11),
            (C._mul(o11, 10), o11), (o11, neg(o11)), (pts[2], pts[3])]


@pytest.fixture(scope="module")
def pairs():
    """Each pair at two random Z each (so equal points come with other
    coordinates), packed as (n, 36) words."""
    rng = np.random.default_rng(SEED)
    ps, qs, aff = [], [], []
    for p, q in _pairs():
        for _ in range(2):
            ps += _jac_words(p, int(rng.integers(2, 1 << 62)))
            qs += _jac_words(q, int(rng.integers(2, 1 << 62)))
            aff.append((p, q))
    ps, qs = (B.ints_to_words_np(v).astype(np.uint32).reshape(-1, B.PT_WORDS) for v in (ps, qs))
    return ps, qs, aff


def _sums(lib, ps, qs):
    ref, got = (np.zeros_like(ps) for _ in range(2))
    lib.h_add_ref(_ptr(ps), _ptr(qs), _ptr(ref), ps.shape[0])
    lib.h_add(_ptr(ps), _ptr(qs), _ptr(got), ps.shape[0])
    return ref, got


def test_group_add_matches_g1_add_word_for_word(shipped, pairs):
    """bg_add's words equal g1_add's on every pair (r apart from p and r
    aliasing p), and its point equals the host group law's."""
    ps, qs, aff = pairs
    ref, got = _sums(shipped, ps, qs)
    assert np.array_equal(got, ref)
    F = J._FP
    for i, (p, q) in enumerate(aff):
        jp = J._from_affine(F, p) if p is not None else (1, 1, 0)
        jq = J._from_affine(F, q) if q is not None else (1, 1, 0)
        assert _affine(got[i]) == J._to_affine(F, J._jac_add(F, jp, jq)), i


def _rows(n: int, seed: int):
    """n Jacobian rows at random Z: subgroup points, with identity rows, a
    point beside its negation and a repeated point."""
    rng = np.random.default_rng(seed)
    pts = C.subgroup_points(n, seed)
    if n > 40:
        pts[3] = None
        pts[5] = (pts[4][0], (-pts[4][1]) % C.P)
        pts[n - 1] = pts[n - 2]
        pts[33] = None
    cols = [_jac_words(p, int(rng.integers(2, 1 << 62))) for p in pts]
    w = B.ints_to_words_np([v for c in cols for v in c]).astype(np.uint32).reshape(n, 3, B.NWORDS)
    return [np.ascontiguousarray(w[:, k]) for k in range(3)], pts


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 64, 100, 8_192, 8_200, 313 * 32 + 1])
def test_k14_stages_match_plain(shipped, n):
    """The two stages of K14 (8,192 rows: 256 tiles, one a lane; 8,200:
    257, so lane 0 folds a second partial; 10,017: 314) equal the plain
    version's
    triple word for word, and its point the host sum."""
    (X, Y, Z), pts = _rows(n, SEED + n)
    parts = np.zeros((-(-n // 32), B.PT_WORDS), np.uint32)
    out = np.zeros(B.PT_WORDS, np.uint32)
    shipped.h_k14(_ptr(X), _ptr(Y), _ptr(Z), n, _ptr(parts), _ptr(out))
    plain = B.aggregate_g1_plain(*(torch.from_numpy(a.view(np.int32)) for a in (X, Y, Z)))
    assert np.array_equal(out.view(np.int32), torch.cat(plain).numpy())
    F = J._FP
    acc = (1, 1, 0)
    for p in pts:
        if p is not None:
            acc = J._jac_add(F, acc, J._from_affine(F, p))
    assert _affine(out) == J._to_affine(F, acc)


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_planted_faults_fail(tmp_path, pairs, mutation):
    """A copy of the header with one fault gives other words than g1_add's
    on some pair."""
    old, new = MUTATIONS[mutation]
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    path = csrc / "bls381_group.cuh"
    text = path.read_text()
    assert text.count(old) == 1, mutation
    path.write_text(text.replace(old, new))
    lib = _build(csrc, tmp_path)
    ps, qs, _ = pairs
    ref, got = _sums(lib, ps, qs)
    assert not np.array_equal(got, ref), mutation


def test_launch_constants_mirror_bls_cu():
    """ops/bls381.py's TILE, FINISH, GROUP and FINISH_GROUPS (the plain
    version's tree order and chip_smoke.py's launch shapes) are bls.cu's,
    and its group is the header's."""
    import re

    text = (CSRC / "bls.cu").read_text()
    defs = {m.group(1): int(m.group(2)) for m in re.finditer(r"#define (BLS_\w+) (\d+)", text)}
    assert {"TILE": B.TILE, "FINISH": B.FINISH, "GROUP": B.GROUP, "FINISH_GROUPS": B.FINISH_GROUPS} == {
        k: defs[f"BLS_{k}"] for k in ("TILE", "FINISH", "GROUP", "FINISH_GROUPS")}
    group = re.search(r"#define BG_G (\d+)", (CSRC / "bls381_group.cuh").read_text())
    assert B.GROUP == int(group.group(1)) and B.FINISH_GROUPS * B.GROUP <= 1024
