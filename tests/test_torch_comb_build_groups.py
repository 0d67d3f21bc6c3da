"""K3's group build (csrc/comb_build.cuh on csrc/ge25519_group.cuh)
built for the host: g++ compiles the headers, whose exchange helper then
runs the COMB_BUILD_G threads of a key's group one after another (each
thread's products of a phase, its coordinate of every parked entry, its
share of the normalisation, the shares' products meeting as reads of
the other threads' slots), and k3_host runs a whole launch key by key.
The tables and valid bytes are held word for word against the port's
plain K3 (ops/comb.build_a_tables_plain), its host bigint build
(ops/comb.build_a_tables_host), the JAX package's host build
(cometbft_tpu/ops/comb.py:259 build_a_tables_host) and the corpus's own
validity (tests/torch_group_corpus.py: off-curve, non-canonical y,
identity and small-order keys, invalid keys at warp and block edges),
over poisoned buffers.  Copies of the headers with one fault planted
(an operand's routing, the exchange, a thread's share of a phase or of
the normalisation, the shares' combine) must fail.  Skips only where no
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

from cometbft_tpu.ops import comb as jcomb
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.ops import comb
import torch_group_corpus as C

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"
SEED = 11
SIZES = [1, 2, 7, 8, 9, 127, 128, 129]
POISON = 0xAAAAAAAA

HARNESS = r"""
#include "comb_build.cuh"

extern "C" {
int h_threads(void) { return COMB_BUILD_G; }
int h_keys(void) { return COMB_BUILD_KEYS; }

void h_k3(const uint8_t* pubs, uint32_t* tables, uint8_t* valid, int V) { k3_host(pubs, tables, valid, V); }
}
"""

# name -> (header, the text of the shipped header, the fault put in its place)
MUTATIONS = {
    "operand_routing": ("ge25519_group.cuh", "fe_sel4(a, s * G + GRP_TID(g, l), ypx, ymx, zz, p.T);",
                        "fe_sel4(a, s * G + GRP_TID(g, l), ymx, ypx, zz, p.T);"),
    "exchange": ("ge25519_group.cuh", "q[j] = m.v[j % G][j / G];", "q[j] = m.v[(j + 1) % G][j / G];"),
    "thread_share": ("ge25519_group.cuh", "      const int j = s * G + GRP_TID(g, l);\n      fe a, b;",
                     "      const int j = s * G;\n      fe a, b;"),
    "normalisation_share": ("comb_build.cuh", "for (int k = COMB_NENT - G + GRP_TID(g, l); k >= 0; k -= G)",
                            "for (int k = COMB_NENT - G; k >= 0; k -= G)"),
    "prefix_combine": ("comb_build.cuh", "fe_cmov(m, q, u != GRP_TID(g, l));", "fe_cmov(m, q, u == GRP_TID(g, l));"),
}


def _build(csrc: pathlib.Path, tmp: pathlib.Path) -> ctypes.CDLL:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/comb_build.cuh with")
    src, out = tmp / "harness.cpp", tmp / "libk3.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(csrc), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    h.h_k3.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return h


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("k3"))


@pytest.fixture(scope="module")
def pool():
    return C.Pool(SEED)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _keys(pool, V):
    return C.keys(pool, V, SEED + V, 32 // comb.BUILD_THREADS_PER_KEY, comb.BUILD_KEYS_PER_BLOCK)


def _run(lib, pubs: np.ndarray):
    """The harness's (tables, valid) for pubs, both buffers poisoned first."""
    V = pubs.shape[0]
    tables = np.full((V, 64, 8, 3, 8), POISON, np.uint32)
    valid = np.full(V, 0xAA, np.uint8)
    lib.h_k3(_ptr(np.ascontiguousarray(pubs)), _ptr(tables), _ptr(valid), V)
    return tables, valid


def test_harness_builds_the_group_shape(shipped):
    assert (shipped.h_threads(), shipped.h_keys()) == (comb.BUILD_THREADS_PER_KEY, comb.BUILD_KEYS_PER_BLOCK)


@pytest.mark.parametrize("V", SIZES)
def test_group_tables_match_plain_and_host_oracle(shipped, pool, V):
    """Whole launches of 1-129 keys, invalid keys at every warp's first
    and last key and every block's last: every table word and valid
    byte equals the plain version's and the host bigint build's, and
    the validity is the corpus's."""
    b = _keys(pool, V)
    tables, valid = _run(shipped, b["pubs"])
    assert valid.tolist() == b["expect"].astype(np.uint8).tolist()
    tp, vp = comb.build_a_tables_plain(torch.from_numpy(b["pubs"]))
    assert np.array_equal(tables, tp.numpy().view(np.uint32)) and np.array_equal(valid.astype(bool), vp.numpy())
    th, vh = comb.build_a_tables_host(b["pubs"])
    assert np.array_equal(tables, th) and np.array_equal(valid.astype(bool), vh)


def test_group_tables_match_jax_host_build(shipped, pool):
    """33 keys of every kind against the JAX package's host build."""
    b = _keys(pool, 33)
    tables, valid = _run(shipped, b["pubs"])
    jt, jv = jcomb.build_a_tables_host(b["pubs"])
    assert np.array_equal(valid.astype(bool), jv)
    assert np.array_equal(convert.a_tables_to_canonical(tables), convert.jax_a_tables_to_canonical(jt))
    assert {*b["kinds"]} == set(C.KEY_VALID + C.KEY_INVALID)


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_a_planted_fault_fails(pool, tmp_path, name):
    """A copy of the headers with one fault planted: the harness's tables
    no longer equal the host bigint build's."""
    header, old, new = MUTATIONS[name]
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    text = (csrc / header).read_text()
    assert text.count(old) == 1, f"{name}: the shipped text to mutate is not in {header}"
    (csrc / header).write_text(text.replace(old, new))
    lib = _build(csrc, tmp_path)
    b = _keys(pool, 3)
    tables, _ = _run(lib, b["pubs"])
    th, _ = comb.build_a_tables_host(b["pubs"])
    assert not np.array_equal(tables, th)
