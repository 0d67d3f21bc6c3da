"""K1's per-chunk body (csrc/sha2.cuh: k1_thread, its decode, word loads,
padding and store) built for the host: g++ compiles the header (the
card's 4-byte loads and 16-byte store are byte loops there; the chunk's
words and masks are the same code), and the harness runs every (row, 16-byte chunk) of a payload as
the kernel's threads do.  Payloads of widths 100, 132, 196 and 260 (the
callers' 68 + a multiple of 32) and 140 (a message that ends inside a
chunk; the card's word loads take widths that are multiples of 4) carry
every mlen edge (0, 1, 47, 48, 63, 64, 111, 112, maxm), rows whose mlen
exceeds maxm (up to 2^24 - 1), rows that are not live and random bytes
past each message; the blocks and active counts, written over poisoned
buffers with a guard row past the end, are held against the port's plain
K1 (ops/sha2.parse_verify_payload_plain) and the JAX package's
parse_verify_payload.  Copies of the header with a planted fault (0x80 a
byte late, the length bytes in the wrong order, the pubkey at the wrong
offset) must fail.  Widths that are not a multiple of 4 (69-71, 101, 113-115,
197, 241-243, 259) run through the card route's zero pad
(ops/sha2.pad_width4) and must give the original width's blocks.  Skips
only where no host C++ compiler exists.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import sha2 as jsha2
from cometbft_tpu_torch.ops import sha2
import torch_sha_corpus as SC

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"
WIDTHS = [100, 132, 196, 260, 140]
# widths that are not a multiple of 4, which the card route pads
ODD_WIDTHS = [69, 70, 71, 101, 113, 114, 115, 197, 241, 242, 243, 259]

HARNESS = r"""
#include "sha2.cuh"

extern "C" void h_k1(const uint8_t* payload, const uint8_t* pubs, uint8_t* blocks, int32_t* active, int V,
                     int width, int nblocks) {
  for (int v = 0; v < V; v++)
    for (int c = 0; c < nblocks * 8; c++)
      k1_thread(blocks + (size_t)v * nblocks * 128, active + v, payload + (size_t)v * width, pubs + 32 * v,
                width - 68, c);
}
"""

# name -> (the text of the shipped header, the fault put in its place)
MUTATIONS = {
    "late_0x80": ("const int t = total - col;", "const int t = total + 1 - col;"),
    "length_byte_order": ("o[3] |= bswap32((uint32_t)total * 8);", "o[3] |= (uint32_t)total * 8;"),
    "pubkey_offset": ("src = pub + (col - 32);", "src = pub + (48 - col);"),
}


def _build(csrc: pathlib.Path, tmp: pathlib.Path) -> ctypes.CDLL:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/sha2.cuh with")
    src, out = tmp / "harness.cpp", tmp / "libk1.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(csrc), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    h.h_k1.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    return h


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("k1"))


def _payload(seed: int, width: int):
    return SC.payload_rows(np.random.default_rng(seed), 37, width)


def _run(lib, payload, pubs, nb=None):
    """The harness's (blocks (V, nb, 128), active (V,)) over poisoned
    buffers (nb the payload width's unless given); a guard row past the
    last must stay poisoned."""
    V, width = payload.shape
    nb = sha2.nblocks_for(width - 68) if nb is None else nb
    blocks = np.full((V + 1, nb, 128), 0xAA, np.uint8)
    active = np.full(V + 1, -0x55555556, np.int32)
    lib.h_k1(payload.ctypes.data_as(ctypes.c_void_p), pubs.ctypes.data_as(ctypes.c_void_p),
             blocks.ctypes.data_as(ctypes.c_void_p), active.ctypes.data_as(ctypes.c_void_p), V, width, nb)
    assert (blocks[V] == 0xAA).all() and active[V] == -0x55555556, "a write past the last row"
    return blocks[:V], active[:V]


@pytest.mark.parametrize("width", WIDTHS)
def test_chunk_body_matches_plain_and_jax(shipped, width):
    payload, pubs = _payload(width, width)
    blocks, active = _run(shipped, payload, pubs)
    pb, pa = sha2.parse_verify_payload_plain(torch.from_numpy(payload), torch.from_numpy(pubs))
    assert np.array_equal(blocks, pb.numpy()) and np.array_equal(active, pa.numpy())
    _, _, jb, ja, _ = jsha2.parse_verify_payload(jnp.asarray(payload), jnp.asarray(pubs))
    assert np.array_equal(blocks, np.asarray(jb)) and np.array_equal(active, np.asarray(ja))
    assert (active[2::5] == 0).all() and (active[:2] > 0).all()


@pytest.mark.parametrize("width", ODD_WIDTHS)
def test_odd_width_through_the_pad_matches_plain_and_jax(shipped, width):
    """A width that is not a multiple of 4 goes through the card route's
    pad (ops/sha2.pad_width4): the chunk body on the padded payload,
    writing the original width's block count, gives the blocks and
    active counts of the plain version and the JAX package at the
    original width, rows whose mlen exceeds maxm included; so does the
    plain version of the padded payload cut to that block count."""
    payload, pubs = _payload(width, width)
    padded = sha2.pad_width4(torch.from_numpy(payload))
    assert padded.shape == (payload.shape[0], width + (-width % 4)) and not padded[:, width:].any()
    assert torch.equal(padded[:, :width], torch.from_numpy(payload))
    nb = sha2.nblocks_for(width - 68)
    blocks, active = _run(shipped, padded.numpy(), pubs, nb)
    pb, pa = sha2.parse_verify_payload_plain(torch.from_numpy(payload), torch.from_numpy(pubs))
    assert np.array_equal(blocks, pb.numpy()) and np.array_equal(active, pa.numpy())
    _, _, jb, ja, _ = jsha2.parse_verify_payload(jnp.asarray(payload), jnp.asarray(pubs))
    assert np.array_equal(blocks, np.asarray(jb)) and np.array_equal(active, np.asarray(ja))
    qb, qa = sha2.parse_verify_payload_plain(padded, torch.from_numpy(pubs))
    assert torch.equal(qb[:, :nb], pb) and torch.equal(qa, pa)
    assert (active[2::5] == 0).all() and (active[:2] > 0).all()


def test_pad_is_no_copy_at_a_multiple_of_4():
    """At the callers' widths (68 + a multiple of 32) the pad returns the
    payload itself."""
    payload = torch.zeros((3, 196), dtype=torch.uint8)
    assert sha2.pad_width4(payload) is payload


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_planted_faults_fail(tmp_path, mutation):
    """A copy of the header with one fault gives other blocks for some row."""
    old, new = MUTATIONS[mutation]
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    path = csrc / "sha2.cuh"
    text = path.read_text()
    assert text.count(old) == 1, mutation
    path.write_text(text.replace(old, new))
    lib = _build(csrc, tmp_path)
    payload, pubs = _payload(7, 196)
    blocks, _ = _run(lib, payload, pubs)
    pb, _ = sha2.parse_verify_payload_plain(torch.from_numpy(payload), torch.from_numpy(pubs))
    assert not np.array_equal(blocks, pb.numpy()), mutation
