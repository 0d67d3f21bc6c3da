"""The BLS12-381 field routines of csrc/bls381.cuh (fe_mul, fe_sq,
fe_add, fe_sub) built for the host: g++ compiles the shipped header (its
host form: the column sums as 64-bit sums of low and high halves, the
word chains as 64-bit sums), and each routine is held against Python
integers (a b R^-1 mod p for the Montgomery multiply and square) at the
range's edges — 0, 1, p - 1, p - 2, R mod p, 2^k mod p
(tests/torch_bls_corpus.py) — and on seeded random pairs.  fe_sq(a)
must equal fe_mul(a, a) word for word.  Copies of the header with a
planted fault in the multiply (the columns' high-half sums dropped, the
final subtraction skipped, a cross term of the square taken once) must
fail.  The card's form (carry chains) is held to the same values by
tests/test_torch_cuda.py.  Skips only where no host C++ compiler exists.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from cometbft_tpu_torch.ops import bls381 as B
import torch_bls_corpus as C

CSRC = pathlib.Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"
SEED = 13
P, R = B.P, B.R_MONT
R_INV = pow(R, -1, P)

HARNESS = r"""
#include "bls381.cuh"

static void h_put(u32* out, const fe& r) { fe_copy(out, r.w); }

extern "C" {
void h_mul(const u32* A, const u32* Bv, u32* out, int n) {
  for (int i = 0; i < n; i++) h_put(out + BLS_W * i, fe_mul(fe_ld(A + BLS_W * i), fe_ld(Bv + BLS_W * i)));
}
void h_sq(const u32* A, u32* out, int n) {
  for (int i = 0; i < n; i++) h_put(out + BLS_W * i, fe_sq(fe_ld(A + BLS_W * i)));
}
void h_add(const u32* A, const u32* Bv, u32* out, int n) {
  for (int i = 0; i < n; i++) h_put(out + BLS_W * i, fe_add(fe_ld(A + BLS_W * i), fe_ld(Bv + BLS_W * i)));
}
void h_sub(const u32* A, const u32* Bv, u32* out, int n) {
  for (int i = 0; i < n; i++) h_put(out + BLS_W * i, fe_sub(fe_ld(A + BLS_W * i), fe_ld(Bv + BLS_W * i)));
}
// bls_p's immediates next to BLS_P's words
void h_p(u32* out) {
  for (int i = 0; i < BLS_W; i++) {
    out[i] = bls_p(i);
    out[BLS_W + i] = BLS_P[i];
  }
}
}
"""

# name -> (the text of the shipped header, the fault put in its place)
MUTATIONS = {
    # the high halves of every column never reach the column above
    "column_high_half_dropped": ("  return (c.L >> 32) + c.H;", "  return (c.L >> 32);"),
    # a result in [p, 2p) is kept
    "final_subtraction_skipped": (
        "  for (int i = 0; i < BLS_W; i++) d.w[i] = borrow ? s.w[i] : d.w[i];",
        "  for (int i = 0; i < BLS_W; i++) d.w[i] = s.w[i];"),
    # the square's cross term a_0 a_5 counted once, not twice
    "cross_term_once": (
        "    col_double(S);\n",
        "    col_double(S);\n"
        "    if (k == 5) {\n      const u64 x = (u64)a.w[0] * a.w[5];\n      S.L -= (u32)x;\n      S.H -= x >> 32;\n    }\n"),
}


def _build(csrc: pathlib.Path, tmp: pathlib.Path) -> ctypes.CDLL:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/bls381.cuh with")
    src, out = tmp / "harness.cpp", tmp / "libbls_field.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(csrc), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    for name in ("h_mul", "h_add", "h_sub"):
        getattr(h, name).argtypes = [P_] * 3 + [I_]
    h.h_sq.argtypes = [P_] * 2 + [I_]
    h.h_p.argtypes = [P_]
    return h


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("bls_field"))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _words(vals) -> np.ndarray:
    return np.ascontiguousarray(B.ints_to_words_np(list(vals)).astype(np.uint32))


def _ints(w: np.ndarray) -> list[int]:
    return [int.from_bytes(row.astype("<u4").tobytes(), "little") for row in w]


def _call2(lib, name: str, xs, ys) -> list[int]:
    a, b = _words(xs), _words(ys)
    out = np.zeros_like(a)
    getattr(lib, name)(_ptr(a), _ptr(b), _ptr(out), a.shape[0])
    return _ints(out)


def _sq(lib, xs) -> list[int]:
    a = _words(xs)
    out = np.zeros_like(a)
    lib.h_sq(_ptr(a), _ptr(out), a.shape[0])
    return _ints(out)


def _mont(x: int, y: int) -> int:
    return x * y * R_INV % P


def _field_agrees(lib) -> bool:
    xs, ys = C.field_pairs(SEED)
    if _call2(lib, "h_mul", xs, ys) != [_mont(x, y) for x, y in zip(xs, ys)]:
        return False
    vals = C.field_edge_values() + C.field_random_values(400, SEED + 2)
    return _sq(lib, vals) == [_mont(x, x) for x in vals]


def test_mul_matches_python_at_edges_and_random(shipped):
    """fe_mul against a b R^-1 mod p on every pair of the edge values and
    400 seeded random pairs."""
    xs, ys = C.field_pairs(SEED)
    got = _call2(shipped, "h_mul", xs, ys)
    for x, y, g in zip(xs, ys, got):
        assert g == _mont(x, y), (hex(x), hex(y))


def test_sq_matches_python_and_mul(shipped):
    """fe_sq against a^2 R^-1 mod p and against fe_mul(a, a) word for word."""
    vals = C.field_edge_values() + C.field_random_values(400, SEED + 2)
    got = _sq(shipped, vals)
    assert got == [_mont(x, x) for x in vals]
    assert got == _call2(shipped, "h_mul", vals, vals)


def test_p_words_match(shipped):
    """bls_p's immediates are BLS_P's words, and those are p's."""
    out = np.zeros((2, B.NWORDS), np.uint32)
    shipped.h_p(_ptr(out))
    assert _ints(out) == [P, P]


def test_add_sub_match_python(shipped):
    """fe_add and fe_sub against Python integers mod p, canonical."""
    xs, ys = C.field_pairs(SEED)
    assert _call2(shipped, "h_add", xs, ys) == [(x + y) % P for x, y in zip(xs, ys)]
    assert _call2(shipped, "h_sub", xs, ys) == [(x - y) % P for x, y in zip(xs, ys)]


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_planted_faults_fail(tmp_path, mutation):
    """A copy of the header with one fault in the multiply or the square
    gives another product for some value above."""
    old, new = MUTATIONS[mutation]
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    path = csrc / "bls381.cuh"
    text = path.read_text()
    assert text.count(old) == 1, mutation
    path.write_text(text.replace(old, new))
    assert not _field_agrees(_build(csrc, tmp_path)), mutation
