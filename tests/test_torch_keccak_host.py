"""K10's row body (csrc/keccak_group.cuh: keccak_pair_row, a row on a
pair of threads) built for the host: g++ compiles the header (a call
holds both threads of its pair and the exchange reads the partner's
slot where the card shuffles), and the harness runs K10's launch as the
card does: rows in warps of 16 pairs, each warp running as many blocks
as its longest row, the rows past the last one taking part with no row
of their own.  Rows of 0-3 active blocks, at lengths 0, 1, 135, 136,
137, 271, 272 and 300 plus seeded random lengths, with random bytes
past each row's last block, are held against the port's host Keccak
(crypto/keccak.keccak256), the port's plain K10
(ops/keccak.keccak256_blocks_plain) and the JAX package's
keccak256_blocks run on the CPU.  Copies of the header with a planted
fault (a wrong rho offset on one thread of the pair, an exchange read
from the wrong thread, the prefetch reading the current block, the
round constant a round late) must fail.  Skips only where no host C++
compiler exists.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import keccak as jkeccak
from cometbft_tpu_torch.ops import keccak as K
import torch_sha_corpus as SC

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"
NB = 3  # blocks a row: lengths up to 407 bytes

HARNESS = r"""
#include "keccak_group.cuh"

// K10's launch on the host: warps of 16 pairs, each running as many
// blocks as its longest row; digest words stored as k10_kernel stores them.
extern "C" void h_k10(const uint8_t* blocks, const int32_t* active, uint32_t* digest, int n, int nblocks) {
  for (int w0 = 0; w0 < n; w0 += 16) {
    int acts[16], nrun = 0;
    for (int i = 0; i < 16; i++) {
      const int v = w0 + i;
      int act = v < n ? active[v] : 0;
      acts[i] = act < 0 ? 0 : act > nblocks ? nblocks : act;
      nrun = acts[i] > nrun ? acts[i] : nrun;
    }
    for (int i = 0; i < 16; i++) {
      const int v = w0 + i;
      uint32_t dig[KG_GL][4];
      keccak_pair_row(dig, blocks + (size_t)(v < n ? v : n - 1) * nblocks * KECCAK_RATE, acts[i], nrun, 0);
      if (v < n)
        for (int l = 0; l < KG_GL; l++)
          for (int j = 0; j < 4; j++) digest[(size_t)v * 8 + 2 * j + l] = dig[l][j];
    }
  }
}
"""

# name -> (the text of the shipped header, the fault put in its place)
MUTATIONS = {
    "rho_offset_one_thread": ("b[l][1] = KG_ROT(6, 44);", "b[l][1] = KG_ROT(6, 44 + KG_TID(t, l));"),
    "exchange_source": ("DEV int kg_src(int t) { return t ^ 1; }", "DEV int kg_src(int t) { return t; }"),
    "prefetch": ("kg_load(nxt, row + (size_t)(b + 1) * KECCAK_RATE, t);",
                 "kg_load(nxt, row + (size_t)b * KECCAK_RATE, t);"),
    "rc_late": ("(uint32_t)(KECCAK_RC[rnd] >>", "(uint32_t)(KECCAK_RC[(rnd + 1) % 24] >>"),
}


def _build(csrc: pathlib.Path, tmp: pathlib.Path) -> ctypes.CDLL:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/keccak_group.cuh with")
    src, out = tmp / "harness.cpp", tmp / "libkeccak_pair.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(csrc), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    h.h_k10.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    return h


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("keccak_pair"))


@pytest.fixture(scope="module")
def jax_blocks():
    return jax.jit(jkeccak.keccak256_blocks)


def _digests(lib, blocks, active) -> np.ndarray:
    out = np.full((blocks.shape[0], 32), 0xAA, np.uint8)
    lib.h_k10(blocks.ctypes.data_as(ctypes.c_void_p), active.ctypes.data_as(ctypes.c_void_p),
              out.ctypes.data_as(ctypes.c_void_p), blocks.shape[0], blocks.shape[1])
    return out


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 33, 300])
def test_pair_rows_match_host_plain_and_jax(shipped, jax_blocks, n):
    """Every row's digest is the host Keccak's (zeros at active = 0), the
    plain version's and the JAX package's, at row counts on the edges
    of a warp's 16 pairs, whatever the bytes past each row's end."""
    msgs, blocks, active = SC.stale_rows_keccak(np.random.default_rng(60 + n), n, NB)
    got = _digests(shipped, blocks, active)
    assert [bytes(r) for r in got] == SC.digests_keccak(msgs, active)
    plain = K.keccak256_blocks_plain(torch.from_numpy(blocks), torch.from_numpy(active)).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, np.asarray(jax_blocks(jnp.asarray(blocks), jnp.asarray(active))))


def test_active_counts_past_nblocks_and_below_zero(shipped):
    """A row's count is clamped to [0, nblocks], as the one-thread body
    reads it: a count past the blocks hashes every block, a negative one
    none."""
    msgs, blocks, active = SC.stale_rows_keccak(np.random.default_rng(9), 40, NB)
    want = K.keccak256_blocks_plain(torch.from_numpy(blocks), torch.from_numpy(active)).numpy()
    full = _digests(shipped, blocks, np.full_like(active, NB))
    odd = active.copy()
    odd[::3], odd[1::3] = NB + 5, -2
    got = _digests(shipped, blocks, odd)
    assert np.array_equal(got[::3], full[::3]) and not got[1::3].any()
    assert np.array_equal(got[2::3], want[2::3])


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_planted_faults_fail(tmp_path, mutation):
    """A copy of the header with one fault gives another digest for some
    row of 1-3 active blocks."""
    old, new = MUTATIONS[mutation]
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    path = csrc / "keccak_group.cuh"
    text = path.read_text()
    assert text.count(old) == 1, mutation
    path.write_text(text.replace(old, new))
    lib = _build(csrc, tmp_path)
    msgs, blocks, active = SC.stale_rows_keccak(np.random.default_rng(6), 40, NB)
    assert [bytes(r) for r in _digests(lib, blocks, active)] != SC.digests_keccak(msgs, active), mutation
