"""Keccak-256 of the port (K10's plain version, the host copy, the
padding) against the JAX package: the published vectors, lengths 0-300
across the 136-byte rate boundary, the jitted JAX keccak256_blocks at one
shape, and pad_messages_keccak byte for byte."""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keccak as jax_host
from cometbft_tpu.ops import keccak as jax_ops
from cometbft_tpu_torch.crypto import keccak as host
from cometbft_tpu_torch.ops import keccak as K

torch.set_num_threads(1)

VECTORS = {
    b"": "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470",
    b"abc": "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45",
    b"The quick brown fox jumps over the lazy dog":
        "4d741b6f1eb29cb2a9b9911c82f56fa8d73b04959d3d9d222895df6c0b28aa15",
}


def _msgs(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(n)) for n in lengths]


@pytest.mark.parametrize("msg", list(VECTORS), ids=["empty", "abc", "fox"])
def test_published_vectors(msg):
    want = bytes.fromhex(VECTORS[msg])
    assert host.keccak256(msg) == want == jax_host.keccak256(msg)
    blocks, active = K.pad_messages_keccak([msg])
    assert bytes(K.keccak256_blocks(torch.from_numpy(blocks), torch.from_numpy(active))[0].numpy()) == want


@pytest.mark.parametrize("lo,hi", [(0, 60), (60, 134), (134, 139), (139, 200), (200, 272), (272, 301)])
def test_plain_k10_and_host_match_jax_host(lo, hi):
    """Every length of [lo, hi) in one batch, including 135, 136 and 137
    (a one-byte 0x81 pad, a full extra block, a two-block message)."""
    msgs = _msgs(range(lo, hi), seed=lo)
    blocks, active = K.pad_messages_keccak(msgs)
    got = K.keccak256_blocks(torch.from_numpy(blocks), torch.from_numpy(active)).numpy()
    want = [jax_host.keccak256(m) for m in msgs]
    assert [bytes(r) for r in got] == want
    assert [host.keccak256(m) for m in msgs] == want


@pytest.mark.parametrize("max_len", [None, 119, 300])
def test_padding_byte_for_byte(max_len):
    msgs = _msgs([0, 1, 2, 40, 97, 119, 134, 135, 136, 137, 271, 272, 5, 5], seed=7)
    b1, a1 = K.pad_messages_keccak(msgs, max_len=max_len)
    b2, a2 = jax_ops.pad_messages_keccak(msgs, max_len=max_len)
    assert b1.dtype == b2.dtype and np.array_equal(b1, b2) and np.array_equal(a1, a2)
    one = K.pad_messages_keccak([bytes(135)])[0]
    assert one[0, 0, 135] == 0x81


def test_plain_k10_matches_jitted_jax_program():
    """The jitted JAX keccak256_blocks (run on the CPU) at one shape: 24
    rows of 3 blocks with per-row active counts and stale bytes past
    each row's last block."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    msgs = _msgs(rng.integers(0, 3 * 136 - 1, size=24), seed=4)
    blocks, active = K.pad_messages_keccak(msgs, max_len=3 * 136 - 1)
    blocks = blocks.copy()
    for i, a in enumerate(active.tolist()):
        blocks[i, a:] = rng.integers(0, 256, size=(3 - a, 136), dtype=np.uint8)
    want = np.asarray(jax.jit(jax_ops.keccak256_blocks)(jnp.asarray(blocks), jnp.asarray(active)))
    got = K.keccak256_blocks(torch.from_numpy(blocks), torch.from_numpy(active)).numpy()
    assert np.array_equal(got, want)


def test_device_bridge_routes_and_refuses():
    from cometbft_tpu_torch._device import NoCudaDevice

    msgs = _msgs([0, 10, 200], seed=9)
    assert K.keccak256_device(msgs, device="cpu") == [jax_host.keccak256(m) for m in msgs]
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDevice):
            K.keccak256_device(msgs)
    meta = torch.zeros((2, 1, 136), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.keccak256_blocks(meta, torch.ones((2,), dtype=torch.int32, device="meta"))
