"""K8's one-launch tree algorithm (csrc/merkle_tree.cuh) built for the
host: g++ compiles the header, whose MT_EACH then runs a block's threads
one after another, and k8_host runs a launch block by block (stage 1 of
every block, then stage 2).  With a small block (T = 4 threads, spans of
2T = 8 leaves) the sizes reach every case of the design: one leaf (no
level), one block, a partial last block whose trailing node is promoted,
exactly one chunk of subtree roots, and more than 4 T^2 leaves, where
stage 2's first levels run over the flat tensor in chunks.  Every row of
the tensor is held against the plain version (ops/merkle.py
merkle_tree_plain, over a tensor poisoned past level 0), the root against
the JAX package's root_from_leaf_hashes and root_from_leaves, and copies
of the header with a planted fault must fail.  Skips only where no host
C++ compiler exists.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import merkle as jM
from cometbft_tpu_torch.ops import merkle as M

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"
T_SMALL = 4
SIZES = [1, 2, 3, 2 * T_SMALL - 1, 2 * T_SMALL, 2 * T_SMALL + 1, 4 * T_SMALL**2 + 1, 1000]

HARNESS = r"""
#include "merkle_tree.cuh"

extern "C" {
int h_threads(void) { return MERKLE_TREE_THREADS; }
int h_depth(int n) { return mt_depth(n); }
long long h_offset(int n, int l) { return mt_offset(n, l); }

void h_tree(uint8_t* flat, int n, int T) {
  if (T == 4) {
    k8_host<4>(flat, n);
  } else {
    k8_host<MERKLE_TREE_THREADS>(flat, n);
  }
}
}
"""

# name -> (the text of the shipped header, the fault put in its place)
MUTATIONS = {
    # the odd trailing node hashed with itself instead of promoted
    "trailing_hashed": ("          for (int j = 0; j < 8; j++) st[j] = l[j];\n", "          merkle_inner(st, l, l);\n"),
    # a level wider than the buffer keeps only its first chunk of T pairs
    "one_chunk": ("for (int i = t; i < m; i += T) {", "for (int i = t; i < m && i < T; i += T) {"),
    # stage 2 starts one level too low
    "stage2_level": ("mt_levels<T>(flat, n, l1, mt_depth(n), mt_offset(n, l1), 0, roots, sm);",
                     "mt_levels<T>(flat, n, l1 - 1, mt_depth(n), mt_offset(n, l1 - 1), 0, roots, sm);"),
}


def _build(csrc: pathlib.Path, tmp: pathlib.Path) -> ctypes.CDLL:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/merkle_tree.cuh with")
    src, out = tmp / "harness.cpp", tmp / "libk8.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(csrc), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    h.h_tree.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    h.h_offset.restype = ctypes.c_longlong
    h.h_offset.argtypes = [ctypes.c_int, ctypes.c_int]
    return h


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("k8"))


def _leaves(n):
    rng = np.random.default_rng(1000 + n)
    return [rng.bytes(int(rng.integers(0, 80))) for _ in range(n)]


def _level0(leaves) -> np.ndarray:
    return np.stack([np.frombuffer(hashlib.sha256(b"\x00" + x).digest(), np.uint8) for x in leaves])


def _host_tree(lib, level0: np.ndarray, T: int) -> np.ndarray:
    """The harness's flat tensor for the tree above level0, every row past
    level 0 poisoned first."""
    n = level0.shape[0]
    flat = np.full((M.level_offsets(n)[-1] + 1, 32), 0xAA, np.uint8)
    flat[:n] = level0
    lib.h_tree(flat.ctypes.data_as(ctypes.c_void_p), n, T)
    return flat


def _plain(level0: np.ndarray) -> np.ndarray:
    n = level0.shape[0]
    flat = torch.zeros((M.level_offsets(n)[-1] + 1, 32), dtype=torch.uint8)
    flat[:n] = torch.from_numpy(level0)
    M.merkle_tree_plain(flat, n)
    return flat.numpy()


def test_harness_geometry_matches_the_wrapper(shipped):
    """The header's depth and level offsets are ops/merkle.py's, and the
    shipped block is a power of two (stage 1's spans stay aligned)."""
    T = shipped.h_threads()
    assert T == M.TREE_THREADS and T & (T - 1) == 0
    for n in SIZES + [4 * T * T + 1, 16_384]:
        assert shipped.h_depth(n) == len(M.level_sizes(n))
        assert [shipped.h_offset(n, lvl) for lvl in range(len(M.level_offsets(n)))] == M.level_offsets(n)


@pytest.mark.parametrize("n", SIZES)
def test_tree_matches_plain_and_jax(shipped, n):
    """Every row equal to the plain version's; the root equal to the JAX
    package's root_from_leaf_hashes on the same level 0 and its
    root_from_leaves on the padded leaves."""
    leaves = _leaves(n)
    level0 = _level0(leaves)
    got = _host_tree(shipped, level0, T_SMALL)
    assert np.array_equal(got, _plain(level0))
    assert bytes(got[-1]) == bytes(np.asarray(jM.root_from_leaf_hashes(jnp.asarray(level0))))
    if n in (2 * T_SMALL + 1, 4 * T_SMALL**2 + 1):
        blocks, active = jM.pad_leaves(leaves)
        assert bytes(got[-1]) == bytes(np.asarray(jM.root_from_leaves(jnp.asarray(blocks), jnp.asarray(active))))


@pytest.mark.parametrize("n", [1000, 2 * M.TREE_THREADS + 1])
def test_shipped_block_size_matches_plain(shipped, n):
    """The shipped T on trees of one and of several blocks."""
    level0 = _level0(_leaves(n))
    assert np.array_equal(_host_tree(shipped, level0, shipped.h_threads()), _plain(level0))


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_planted_faults_fail(tmp_path, mutation):
    """A copy of the header with one fault planted disagrees with the plain
    version on at least one of the sizes above."""
    old, new = MUTATIONS[mutation]
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    path = csrc / "merkle_tree.cuh"
    text = path.read_text()
    assert text.count(old) == 1, mutation
    path.write_text(text.replace(old, new))
    lib = _build(csrc, tmp_path)
    level0s = [_level0(_leaves(n)) for n in SIZES]
    assert any(not np.array_equal(_host_tree(lib, lv, T_SMALL), _plain(lv)) for lv in level0s), mutation
