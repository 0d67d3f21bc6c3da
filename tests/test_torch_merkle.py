"""Parity of the port's Merkle trees (cometbft_tpu_torch/ops/merkle.py:
merkle_level_plain — the plain version of K8 —, merkle_gather_plain — of
K9 —, root_from_leaves and nodes_from_leaves with the coordinates of a
proof plan and of a multiproof plan; and
cometbft_tpu_torch/crypto/merkle.py's routes with device="cpu") against
the JAX package's ops/merkle.py and crypto/merkle.py, the host oracle
and the RFC-6962 vector, on leaves made from a numpy seed at sizes with
odd levels.  Exact byte equality."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import merkle as jcm
from cometbft_tpu.ops import merkle as jM
from cometbft_tpu_torch.crypto import merkle as cm
from cometbft_tpu_torch.ops import merkle as M

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

SIZES = [1, 2, 3, 5, 8, 9, 17, 33, 64, 65]
_PROOFS = jax.jit(jM.proofs_from_leaves)
_MULTI = jax.jit(jM.multiproof_from_leaves)

# tests/test_merkle.py's RFC-6962 / Certificate-Transparency vector
_CT_LEAVES = [
    b"", bytes([0x00]), bytes([0x10]), bytes([0x20, 0x21]), bytes([0x30, 0x31]),
    bytes([0x40, 0x41, 0x42, 0x43]), bytes([0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56, 0x57]),
    bytes(range(0x60, 0x70)),
]
_CT_ROOT8 = bytes.fromhex("5dc9da79a70659a9ad559cb701ded9a2ab9d823aad2f4960cfe370eff4604328")


def _leaves(n):
    rng = np.random.default_rng(n)
    return [rng.bytes(int(rng.integers(0, 100))) for _ in range(n)]


def _queries(n):
    """Every index in a seeded order, plus both ends again.  The tests of
    one size share these shapes, so each JAX program compiles once."""
    return np.random.default_rng(n).permutation(n).tolist() + [0, n - 1]


def _padded(leaves):
    blocks, active = M.pad_leaves(leaves)
    jb, ja = jM.pad_leaves(leaves)
    assert np.array_equal(blocks, jb) and np.array_equal(active, ja)
    return blocks, active


@pytest.mark.parametrize("n", SIZES)
def test_levels_match_jax_hash_level(n):
    """Each level of the flat tensor equals jM.hash_level of the level
    below it; the offsets are the JAX plan's level-size prefix sums."""
    blocks, active = _padded(_leaves(n))
    flat = M.all_levels(torch.from_numpy(blocks), torch.from_numpy(active)).numpy()
    offs = M.level_offsets(n)
    assert M.level_sizes(n) == jcm._level_sizes(n) and flat.shape == (offs[-1] + 1, 32)
    level = np.asarray(jM.leaf_hashes_from_padded(jnp.asarray(blocks), jnp.asarray(active)))
    assert np.array_equal(flat[:n], level)
    for lvl, sz in enumerate(M.level_sizes(n)):
        level = np.asarray(jM.hash_level(jnp.asarray(level)))
        assert np.array_equal(flat[offs[lvl + 1] : offs[lvl + 1] + (sz + 1) // 2], level), lvl
    assert flat[-1].tobytes() == jcm.hash_from_byte_slices(_leaves(n), device=False)


@pytest.mark.parametrize("n", SIZES)
def test_root_and_proofs_match_jax(n):
    leaves = _leaves(n)
    blocks, active = _padded(leaves)
    idx = _queries(n)
    depth, sib = jcm.proof_plan(n, idx)
    assert cm.proof_plan(n, idx) == (depth, sib)
    tb, ta = torch.from_numpy(blocks), torch.from_numpy(active)
    root = M.root_from_leaves(tb, ta).numpy()
    coords = M.proof_coords(n, idx, np.asarray(sib).reshape(len(idx), depth))
    r, rows = M.nodes_from_leaves(tb, ta, torch.from_numpy(coords))
    leaf_sel, aunts = rows[:, 0], rows[:, 1:]
    jr, jl, ja = _PROOFS(
        jnp.asarray(blocks), jnp.asarray(active), jnp.asarray(np.asarray(idx, np.int32)),
        jnp.asarray(np.asarray(sib, np.int32).reshape(len(idx), depth)),
    )
    assert np.array_equal(root, np.asarray(jr)) and np.array_equal(r.numpy(), root)
    assert np.array_equal(leaf_sel.numpy(), np.asarray(jl))
    assert np.array_equal(aunts.numpy(), np.asarray(ja))


@pytest.mark.parametrize("n", SIZES)
def test_multiproof_matches_jax(n):
    leaves = _leaves(n)
    blocks, active = _padded(leaves)
    idx = _queries(n)
    plan = cm.multiproof_plan(n, idx)
    assert plan == jcm.multiproof_plan(n, idx)
    coords = torch.tensor(plan[2], dtype=torch.int32)
    root, nodes = M.nodes_from_leaves(torch.from_numpy(blocks), torch.from_numpy(active), coords)
    jr, jn = _MULTI(jnp.asarray(blocks), jnp.asarray(active), jnp.asarray(np.asarray(plan[2], np.int32)))
    assert np.array_equal(root.numpy(), np.asarray(jr)) and np.array_equal(nodes.numpy(), np.asarray(jn))


@pytest.mark.parametrize("n", SIZES)
def test_crypto_routes_match_jax_and_host(n):
    """hash_from_byte_slices, device_proofs_from_byte_slices and
    device_multiproof on device="cpu" against the JAX package's device
    routes and the host oracle, proof objects compared field by field."""
    leaves = _leaves(n)
    idx = _queries(n)
    host_root, host_proofs = jcm.proofs_from_byte_slices(leaves)
    want = [(p.total, p.index, p.leaf_hash, p.aunts) for p in (host_proofs[i] for i in idx)]
    assert cm.hash_from_byte_slices(leaves, device="cpu") == host_root
    assert cm.hash_from_byte_slices(leaves, device=False) == host_root
    r1, p1 = cm.device_proofs_from_byte_slices(leaves, idx, device="cpu")
    jr1, jp1 = jcm.device_proofs_from_byte_slices(leaves, idx)
    r2, p2, d2 = cm.device_multiproof(leaves, idx, device="cpu")
    jr2, jp2, jd2 = jcm.device_multiproof(leaves, idx)
    assert r1 == r2 == jr1 == jr2 == host_root and d2 == jd2
    for got in (p1, p2, jp1, jp2):
        assert [(p.total, p.index, p.leaf_hash, p.aunts) for p in got] == want
    r3, p3 = cm.proofs_from_byte_slices(leaves)
    assert r3 == host_root and [(p.total, p.index, p.leaf_hash, p.aunts) for p in p3] == [
        (p.total, p.index, p.leaf_hash, p.aunts) for p in host_proofs]


@pytest.mark.parametrize("device", [False, "cpu"])
def test_rfc6962_vector(device):
    assert cm.hash_from_byte_slices(_CT_LEAVES, device=device) == _CT_ROOT8
    assert cm.device_proofs_from_byte_slices(_CT_LEAVES, [5], device="cpu")[0] == _CT_ROOT8


def test_host_api_matches_jax():
    assert cm.empty_hash() == jcm.empty_hash() == cm.hash_from_byte_slices([]) == hashlib.sha256(b"").digest()
    assert [cm.get_split_point(n) for n in range(1, 70)] == [jcm.get_split_point(n) for n in range(1, 70)]
    with pytest.raises(ValueError):
        cm.get_split_point(0)
    leaves = _leaves(11)
    root, proofs = cm.proofs_from_byte_slices(leaves)
    for i, p in enumerate(proofs):
        p.verify(root, leaves[i])
        assert p.compute_root_hash() == root
    with pytest.raises(ValueError, match="invalid leaf hash"):
        proofs[3].verify(root, leaves[4])
    bad = cm.Proof(proofs[2].total, proofs[2].index, proofs[2].leaf_hash, proofs[2].aunts[:-1])
    with pytest.raises(ValueError, match="invalid root hash"):
        bad.verify(root, leaves[2])
    with pytest.raises(ValueError, match="out of range"):
        cm.proof_plan(11, [11])


def test_value_op_chain_and_key_paths_match_jax():
    kv = [b"k%d" % i + hashlib.sha256(b"v%d" % i).digest() for i in range(6)]
    root, proofs = cm.proofs_from_byte_slices(kv)
    ops = cm.ProofOperators([cm.ValueOp(b"k2", proofs[2])])
    path = cm.key_path_to_string([b"k2"])
    ops.verify_value(root, path, b"v2")
    with pytest.raises(ValueError, match="leaf hash mismatch"):
        ops.verify_value(root, path, b"v3")
    with pytest.raises(ValueError, match="key mismatch"):
        ops.verify_value(root, cm.key_path_to_string([b"k3"]), b"v2")
    keys = [b"store", b"\xff\x00/", "ünï".encode()]
    assert cm.key_path_to_string(keys) == jcm.key_path_to_string(keys)
    assert cm._parse_key_path(cm.key_path_to_string(keys)) == keys


def test_gather_plain_zero_rows():
    flat = torch.arange(7 * 32, dtype=torch.int64).remainder(251).to(torch.uint8).reshape(7, 32)
    coord = torch.tensor([[6, -1], [0, 3]], dtype=torch.int32)
    got = M.merkle_gather(flat, coord)
    assert got.shape == (2, 2, 32)
    assert torch.equal(got[0, 0], flat[6]) and int(got[0, 1].sum()) == 0
    assert torch.equal(got[1, 1], flat[3])


def test_level_wrapper_refuses_overlap_and_bad_offsets():
    flat = torch.zeros((10, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="overlaps"):
        M.merkle_level(flat, 0, 6, 4)
    with pytest.raises(ValueError, match="outside"):
        M.merkle_level(flat, 5, 6, 0)
