"""Parity of the port's SHA-256 (cometbft_tpu_torch/ops/sha2.py:
pad_messages_sha256, sha256_blocks_plain — the plain version of K7)
against the JAX package's ops/sha2.py and hashlib, on messages made from
a numpy seed: lengths on every padding edge (0, 55, 56, 63, 64, 119, 120,
200), mixed active block counts, and stale bytes past each row's own
last block.  Exact byte equality."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import sha2 as jsha2
from cometbft_tpu_torch.ops import sha2

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

EDGES = [0, 55, 56, 63, 64, 119, 120, 200]
_JIT = jax.jit(jsha2.sha256_blocks)


def _msgs(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in lens]


def test_constants_match_jax():
    assert sha2.K256 == np.asarray(jsha2.K256).tolist()
    assert sha2.H256 == np.asarray(jsha2.H256).tolist()


@pytest.mark.parametrize("max_len", [None, 200, 300])
def test_padding_matches_jax(max_len):
    msgs = _msgs(1, EDGES + [1, 9, 130])
    buf, active = sha2.pad_messages_sha256(msgs, max_len=max_len)
    jbuf, jactive = jsha2.pad_messages_sha256(msgs, max_len=max_len)
    assert buf.shape == jbuf.shape and np.array_equal(buf, jbuf)
    assert np.array_equal(active, jactive) and active.dtype == np.int32


def test_padding_with_prefix_and_into_a_buffer():
    """The leaf prefix and a caller's buffer give the bytes of padding
    prefix + msg on its own."""
    msgs = _msgs(2, EDGES)
    want, want_act = jsha2.pad_messages_sha256([b"\x00" + m for m in msgs])
    out = np.zeros(want.size, np.uint8)
    buf, active = sha2.pad_messages_sha256(msgs, prefix=b"\x00", out=out)
    assert np.array_equal(buf, want) and np.array_equal(active, want_act)
    assert np.shares_memory(buf, out)


@pytest.mark.parametrize("seed", [3, 4])
def test_sha256_blocks_plain_matches_jax_and_hashlib(seed):
    """Mixed active counts (1-4 blocks in a 4-block batch) with random
    bytes in every block past a row's own last one."""
    rng = np.random.default_rng(seed)
    lens = EDGES + rng.integers(0, 240, size=8).tolist()
    msgs = _msgs(seed, lens)
    blocks, active = sha2.pad_messages_sha256(msgs, max_len=4 * 64 - 9)
    blocks = blocks.copy()
    for i, a in enumerate(active.tolist()):
        blocks[i, a:] = rng.integers(0, 256, size=(4 - a, 64), dtype=np.uint8)
    assert sorted(set(active.tolist())) == [1, 2, 3, 4]
    got = sha2.sha256_blocks(torch.from_numpy(blocks), torch.from_numpy(active)).numpy()
    want = np.asarray(_JIT(jnp.asarray(blocks), jnp.asarray(active)))
    assert np.array_equal(got, want)
    assert [bytes(r) for r in got] == [hashlib.sha256(m).digest() for m in msgs]


def test_rows_with_no_active_block_keep_the_initial_state():
    blocks, active = sha2.pad_messages_sha256(_msgs(5, [3, 70, 4]))
    active = active.copy()
    active[1] = 0
    got = sha2.sha256_blocks_plain(torch.from_numpy(blocks), torch.from_numpy(active)).numpy()
    want = np.asarray(_JIT(jnp.asarray(blocks), jnp.asarray(active)))
    assert np.array_equal(got, want)
    h0 = b"".join(h.to_bytes(4, "big") for h in sha2.H256)
    assert bytes(got[1]) == h0


def test_wrapper_refuses_bad_shapes_and_devices():
    with pytest.raises(ValueError, match="blocks must be"):
        sha2.sha256_blocks(torch.zeros((2, 1, 128), dtype=torch.uint8), torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="active must be"):
        sha2.sha256_blocks(torch.zeros((2, 1, 64), dtype=torch.uint8), torch.ones(3, dtype=torch.int32))
    meta = torch.zeros((2, 1, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sha2.sha256_blocks(meta, torch.ones(2, dtype=torch.int32, device="meta"))
