"""Parity of the port's K1/K2 plain versions
(cometbft_tpu_torch/ops/sha2.py: parse_verify_payload, sha512_blocks)
against the JAX package's ops/sha2.py and hashlib, on payloads made from
a numpy seed: every mlen edge around the block boundary, non-live rows
and stale bytes past each row's message.  Exact byte equality."""

import hashlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cometbft_tpu.ops import sha2 as jsha2
from cometbft_tpu_torch.ops import sha2

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

MLENS = [0, 31, 32, 47, 48, 110, 128]


def _payload(seed, maxm, mlens, nonlive):
    rng = np.random.default_rng(seed)
    V = len(mlens)
    # random bytes everywhere: stale message bytes past mlen must be masked
    payload = rng.integers(0, 256, size=(V, 68 + maxm), dtype=np.uint8)
    mlen = np.asarray(mlens)
    payload[:, 64], payload[:, 65], payload[:, 66] = mlen & 0xFF, (mlen >> 8) & 0xFF, 0
    payload[:, 67] = 1
    payload[list(nonlive), 67] = 0
    pubs = rng.integers(0, 256, size=(V, 32), dtype=np.uint8)
    return payload, pubs


@pytest.mark.parametrize(
    "maxm,mlens,nonlive",
    [
        (128, MLENS + MLENS[::-1], (2, 9)),
        (32, [0, 5, 31, 32, 17, 32], (1,)),
        (192, [0, 47, 48, 175, 176, 192, 110, 1], (0, 5)),
    ],
)
def test_parse_verify_payload_matches_jax(maxm, mlens, nonlive):
    payload, pubs = _payload(len(mlens) + maxm, maxm, mlens, nonlive)
    r, s, blocks, active, live = sha2.parse_verify_payload(
        torch.from_numpy(payload), torch.from_numpy(pubs)
    )
    jr, js, jb, ja, jl = jsha2.parse_verify_payload(jnp.asarray(payload), jnp.asarray(pubs))
    assert np.array_equal(blocks.numpy(), np.asarray(jb))
    assert np.array_equal(active.numpy(), np.asarray(ja))
    assert np.array_equal(live.numpy(), np.asarray(jl))
    assert np.array_equal(r.numpy(), np.asarray(jr))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert blocks.shape[1] == sha2.nblocks_for(maxm)
    assert all(active[i] == 0 for i in nonlive)


@pytest.mark.parametrize("maxm", [32, 128])
def test_sha512_blocks_matches_jax_and_hashlib(maxm):
    mlens = [m for m in MLENS if m <= maxm] * 2
    payload, pubs = _payload(7 * maxm, maxm, mlens, (1,))
    _, _, blocks, active, _ = sha2.parse_verify_payload(
        torch.from_numpy(payload), torch.from_numpy(pubs)
    )
    digest = sha2.sha512_blocks(blocks, active).numpy()
    jd = np.asarray(jsha2.sha512_blocks(jnp.asarray(blocks.numpy()), jnp.asarray(active.numpy())))
    assert np.array_equal(digest, jd)
    for v, m in enumerate(mlens):
        if active[v]:
            ram = payload[v, :32].tobytes() + pubs[v].tobytes() + payload[v, 68 : 68 + m].tobytes()
            assert digest[v].tobytes() == hashlib.sha512(ram).digest()


def test_sha512_frozen_rows_hash_nothing():
    """Rows with active = 0 keep the initial state, as the JAX kernel does."""
    payload, pubs = _payload(3, 32, [4, 4, 4], (0, 2))
    _, _, blocks, active, _ = sha2.parse_verify_payload(
        torch.from_numpy(payload), torch.from_numpy(pubs)
    )
    digest = sha2.sha512_blocks(blocks, active).numpy()
    init = b"".join(h.to_bytes(8, "big") for h in sha2.H512)
    assert digest[0].tobytes() == init and digest[2].tobytes() == init
    assert digest[1].tobytes() != init


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        sha2.parse_verify_payload(torch.zeros((4, 40), dtype=torch.uint8), torch.zeros((4, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        sha2.sha512_blocks(torch.zeros((4, 1, 64), dtype=torch.uint8), torch.zeros(4, dtype=torch.int32))
