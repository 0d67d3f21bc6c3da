"""K7's row body (csrc/sha256.cuh: sha256_row, its loads, rounds and
digest store) built for the host: g++ compiles the header (the card's
16-byte loads and stores are byte loops there; the rounds and the byte
order are the same code), and the harness hashes rows of 1-4 active
blocks with random bytes past each row's end, and rows at active = 0.
Digests are held against hashlib, the port's plain K7
(ops/sha2.sha256_blocks_plain) and the JAX package's sha256_blocks.
Copies of the header with a planted fault (the prefetch reading the
current block, the byte order of a load, K[t] a round late) must fail.
Skips only where no host C++ compiler exists.
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

from cometbft_tpu.ops import sha2 as jsha2
from cometbft_tpu_torch.ops import sha2
import torch_sha_corpus as SC

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"

HARNESS = r"""
#include "sha256.cuh"

extern "C" void h_sha256_rows(const uint8_t* blocks, const int32_t* active, uint8_t* digest, int V, int nblocks) {
  for (int v = 0; v < V; v++) sha256_row(digest + 32 * v, blocks + (size_t)v * nblocks * 64, nblocks, active[v]);
}
"""

# name -> (the text of the shipped header, the fault put in its place)
MUTATIONS = {
    "prefetch": ("if (b + 1 < n) sha256_load(next, blocks + (size_t)(b + 1) * 64);",
                 "if (b + 1 < n) sha256_load(next, blocks + (size_t)b * 64);"),
    "load_byte_order": ("w[i] = bswap32(c[i]);", "w[i] = c[i];"),
    "k_late": ("h + SHA256_K[t] + wt, dhk", "h + SHA256_K[(t + 1) & 63] + wt, dhk"),
}


def _build(csrc: pathlib.Path, tmp: pathlib.Path) -> ctypes.CDLL:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/sha256.cuh with")
    src, out = tmp / "harness.cpp", tmp / "libsha256_rows.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(csrc), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    h.h_sha256_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    return h


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("sha256_rows"))


def _digests(lib, blocks, active) -> np.ndarray:
    out = np.full((blocks.shape[0], 32), 0xAA, np.uint8)
    lib.h_sha256_rows(blocks.ctypes.data_as(ctypes.c_void_p), active.ctypes.data_as(ctypes.c_void_p),
                      out.ctypes.data_as(ctypes.c_void_p), blocks.shape[0], blocks.shape[1])
    return out


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_row_body_matches_hashlib_plain_and_jax(shipped, nb):
    """Every row's digest is hashlib's (the initial state at active = 0),
    the plain version's and the JAX package's, whatever the bytes past
    the row's end."""
    msgs, blocks, active = SC.stale_rows_sha256(np.random.default_rng(40 + nb), 40, nb)
    got = _digests(shipped, blocks, active)
    assert [bytes(r) for r in got] == SC.digests_sha256(msgs, active)
    plain = sha2.sha256_blocks_plain(torch.from_numpy(blocks), torch.from_numpy(active)).numpy()
    assert np.array_equal(got, plain)
    jax_d = np.asarray(jax.jit(jsha2.sha256_blocks)(jnp.asarray(blocks), jnp.asarray(active)))
    assert np.array_equal(got, jax_d)


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_planted_faults_fail(tmp_path, mutation):
    """A copy of the header with one fault gives another digest for some
    row of 1-4 active blocks."""
    old, new = MUTATIONS[mutation]
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    path = csrc / "sha256.cuh"
    text = path.read_text()
    assert text.count(old) == 1, mutation
    path.write_text(text.replace(old, new))
    lib = _build(csrc, tmp_path)
    msgs, blocks, active = SC.stale_rows_sha256(np.random.default_rng(6), 40, 4)
    assert [bytes(r) for r in _digests(lib, blocks, active)] != SC.digests_sha256(msgs, active), mutation
