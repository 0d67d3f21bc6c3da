"""The CUDA kernels K1-K9 against their plain versions on the card
(marker ``cuda``: these skip where no CUDA device is present; run them
on the card with ``python -m pytest tests/test_torch_cuda.py -m cuda``).
Small shapes; chip_smoke.py holds the kernels at the main path's."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _payload(rng, V, maxm, keys):
    from cometbft_tpu_torch.crypto import _ref25519 as ref

    payload = rng.integers(0, 256, size=(V, 68 + maxm), dtype=np.uint8)
    for v in range(V):
        m = rng.bytes(int(rng.integers(0, maxm + 1)))
        sig = keys[v].sign(m)
        if v % 5 == 1:
            sig = sig[:32] + (int.from_bytes(sig[32:], "little") + ref.L).to_bytes(32, "little")
        if v % 5 == 2:
            m = m + b"!" if len(m) < maxm else m[:-1]
        payload[v, :64] = np.frombuffer(sig, np.uint8)
        payload[v, 64:67] = [len(m) & 0xFF, len(m) >> 8, 0]
        payload[v, 67] = 0 if v % 7 == 3 else 1
        payload[v, 68 : 68 + len(m)] = np.frombuffer(m, np.uint8)
    return payload


@pytest.fixture(scope="module")
def case(dev):
    from cometbft_tpu_torch.crypto import ed25519 as host

    rng = np.random.default_rng(5)
    V = 70  # not a multiple of 32: a ragged last warp
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(V)]
    pubs = np.stack([np.frombuffer(k.pub_key().data, np.uint8) for k in keys])
    return _payload(rng, V, 128, keys), pubs


def test_k1_k2_match_plain(dev, case):
    from cometbft_tpu_torch.ops import sha2

    payload, pubs = (torch.from_numpy(x).to(dev) for x in case)
    _, _, blocks, active, _ = sha2.parse_verify_payload(payload, pubs)
    pb, pa = sha2.parse_verify_payload_plain(payload, pubs)
    assert torch.equal(blocks, pb) and torch.equal(active, pa)
    assert torch.equal(sha2.sha512_blocks(blocks, active), sha2.sha512_blocks_plain(blocks, active))


def test_k3_k4_match_plain(dev, case):
    from cometbft_tpu_torch.ops import comb, sha2

    from cometbft_tpu_torch.crypto import _ref25519 as ref

    payload, pubs = (torch.from_numpy(x).to(dev) for x in case)
    off_curve = next(
        y.to_bytes(32, "little") for y in range(2, 1000)
        if ref.decompress(y.to_bytes(32, "little")) is None
    )
    pubs[4] = torch.frombuffer(bytearray(off_curve), dtype=torch.uint8).to(dev)
    tables, valid = comb.build_a_tables(pubs)
    pt, pv = comb.build_a_tables_plain(pubs)
    assert torch.equal(tables, pt) and torch.equal(valid, pv) and not bool(valid[4])
    _, _, blocks, active, _ = sha2.parse_verify_payload(payload, pubs)
    digest = sha2.sha512_blocks(blocks, active)
    b_tab = comb.b_tables(dev)
    out = comb.verify_cached(tables, valid, payload, digest, b_tab)
    ok = comb.verify_cached_plain(tables, valid, payload, digest, b_tab)
    assert torch.equal(out, comb.pack_verdicts(ok, payload[:, 67] == 1))


def test_k3_on_arbitrary_encodings_matches_plain(dev):
    """Random 32-byte strings as pubkeys (about half decode, y >= p and
    the sign bit included): every table word from K3 equals the plain
    version's, an exact check of the kernel's field arithmetic on
    arbitrary canonical values."""
    from cometbft_tpu_torch.ops import comb

    rng = np.random.default_rng(6)
    pubs = torch.from_numpy(rng.integers(0, 256, size=(96, 32), dtype=np.uint8)).to(dev)
    pubs[:4, :31] = 0xFF
    pubs[:4, 31] |= 0x7F  # y = 2^255 - 1 >= p, sign bit random
    tables, valid = comb.build_a_tables(pubs)
    pt, pv = comb.build_a_tables_plain(pubs)
    assert torch.equal(valid, pv) and 0 < int(valid.sum()) < 96
    assert torch.equal(tables, pt)


def test_k5_matches_plain_and_host_oracle(dev):
    """K5 on 200 lanes (a ragged last block): good signatures, flipped
    messages, s >= L, undecodable R and A, random 32-byte keys and
    small-order points; verdicts equal the plain version and the host
    oracle."""
    from cometbft_tpu_torch.crypto import _ref25519 as ref
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.models.verifier import stage_batch
    from cometbft_tpu_torch.ops import ed25519 as E
    from cometbft_tpu_torch.ops import sha2

    rng = np.random.default_rng(8)
    small = [(1).to_bytes(32, "little"), ((1 << 255) | 1).to_bytes(32, "little"),
             (ref.P - 1).to_bytes(32, "little"), bytes(32)]
    items = []
    for i in range(200):
        k = host.PrivKey.from_seed(rng.bytes(32))
        m = rng.bytes(int(rng.integers(0, 300)))
        pub, sig = k.pub_key().data, k.sign(m)
        kind = i % 8
        if kind == 1:
            m = m + b"!"
        elif kind == 2:
            sig = sig[:32] + (int.from_bytes(sig[32:], "little") + ref.L).to_bytes(32, "little")
        elif kind == 3:
            pub = rng.bytes(32)
        elif kind == 4:
            sig = rng.bytes(32) + sig[32:]
        elif kind == 5:
            pub, sig = small[i % 4], small[(i // 8) % 4] + bytes(32)
        items.append((pub, m, sig))
    a, r, s, blocks, active = stage_batch(items, dev)
    digest = sha2.sha512_blocks(blocks, active)
    got = E.verify_digest(a, r, s, digest)
    want = E.verify_digest_plain(a, r, s, digest)
    assert torch.equal(got, want)
    oracle = [ref.verify(*it) for it in items]
    assert got[: len(items)].tolist() == oracle and 0 < sum(oracle) < len(items)


def test_k6_matches_plain(dev):
    """K6 against its plain version on random table words: reused rows
    in a shuffled order, fresh rows from a padded bucket, and one row
    that neither index names (zero and invalid)."""
    from cometbft_tpu_torch.models import comb_verifier as cv

    g = torch.Generator(device="cpu").manual_seed(9)
    Vb, V, bucket = 40, 37, 8
    base = torch.randint(-(1 << 31), 1 << 31, (Vb, 64, 8, 3, 8), generator=g, dtype=torch.int64)
    fresh = torch.randint(-(1 << 31), 1 << 31, (bucket, 64, 8, 3, 8), generator=g, dtype=torch.int64)
    base, fresh = base.to(torch.int32).to(dev), fresh.to(torch.int32).to(dev)
    base_valid = (torch.arange(Vb, device=dev) % 3) != 0
    fresh_valid = (torch.arange(bucket, device=dev) % 2) == 0
    perm = torch.randperm(V, generator=g).to(dev)
    new_rows, fresh_rows = perm[:30], perm[30:36]  # perm[36] has no source
    base_rows = torch.randperm(Vb, generator=g)[:30].to(dev)
    got = cv.assemble_churn(base, base_valid, fresh, fresh_valid, new_rows, base_rows, fresh_rows, V)
    want = cv.assemble_churn_plain(base, base_valid, fresh, fresh_valid, new_rows, base_rows, fresh_rows, V)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool(got[1][perm[36]]) and int(got[0][perm[36]].abs().sum()) == 0


def _stale_sha256_rows(rng, lens, nb):
    """SHA-256-padded rows of the given message lengths in nb blocks, with
    random (stale) bytes in every block past each row's own last one."""
    from cometbft_tpu_torch.ops import sha2

    msgs = [rng.bytes(n) for n in lens]
    blocks, active = sha2.pad_messages_sha256(msgs, max_len=nb * 64 - 9)
    blocks = blocks.copy()
    for i, a in enumerate(active.tolist()):
        blocks[i, a:] = rng.integers(0, 256, size=(nb - a, 64), dtype=np.uint8)
    return msgs, blocks, active


def test_k7_matches_plain_and_hashlib(dev):
    """K7 on 300 rows of 1-4 active blocks (a ragged last block of
    threads), stale bytes past each row's message."""
    import hashlib

    from cometbft_tpu_torch.ops import sha2

    rng = np.random.default_rng(10)
    lens = [0, 55, 56, 63, 64, 119, 120, 200] + rng.integers(0, 240, size=292).tolist()
    msgs, blocks, active = _stale_sha256_rows(rng, lens, 4)
    b, a = torch.from_numpy(blocks).to(dev), torch.from_numpy(active).to(dev)
    got = sha2.sha256_blocks(b, a)
    assert torch.equal(got, sha2.sha256_blocks_plain(b, a))
    assert [bytes(r) for r in got.cpu().numpy()] == [hashlib.sha256(m).digest() for m in msgs]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 9, 130, 1000])
def test_k8_levels_match_plain_and_host(dev, n):
    """Every level from K8 equals the plain level computed from the same
    input level; the root equals the host route's."""
    from cometbft_tpu_torch.crypto import merkle as cm
    from cometbft_tpu_torch.ops import merkle as M

    rng = np.random.default_rng(11 + n)
    leaves = [rng.bytes(int(rng.integers(0, 100))) for _ in range(n)]
    blocks, active, _ = M.stage_leaves(leaves, dev)
    flat = M.all_levels(blocks, active)
    offs = M.level_offsets(n)
    for lvl, sz in enumerate(M.level_sizes(n)):
        want = flat.clone()
        want[offs[lvl + 1] : offs[lvl + 1] + (sz + 1) // 2] = 0
        M.merkle_level_plain(want, offs[lvl], sz, offs[lvl + 1])
        assert torch.equal(flat, want), f"level {lvl} of {n} leaves"
    assert bytes(flat[-1].cpu().numpy()) == cm.hash_from_byte_slices(leaves, device=False)


def test_k9_matches_plain_with_missing_rows(dev):
    from cometbft_tpu_torch.ops import merkle as M

    rng = np.random.default_rng(12)
    flat = torch.from_numpy(rng.integers(0, 256, size=(777, 32), dtype=np.uint8)).to(dev)
    coord = torch.from_numpy(rng.integers(-1, 777, size=(301, 3), dtype=np.int32)).to(dev)
    coord[0, 0] = -1
    got = M.merkle_gather(flat, coord)
    assert torch.equal(got, M.merkle_gather_plain(flat, coord.reshape(-1)).reshape(301, 3, 32))
    assert int(got[0, 0].sum()) == 0


def test_device_proof_routes_match_host(dev):
    """K7 -> K8 -> K9 through the crypto/merkle routes: every proof equal
    to proofs_from_byte_slices's, at a size with odd levels."""
    from cometbft_tpu_torch.crypto import merkle as cm

    rng = np.random.default_rng(13)
    leaves = [rng.bytes(64) for _ in range(1001)]
    root, proofs = cm.proofs_from_byte_slices(leaves)
    idx = rng.permutation(1001).tolist()
    r1, p1 = cm.device_proofs_from_byte_slices(leaves, idx, device=dev)
    r2, p2, dedup = cm.device_multiproof(leaves, idx, device=dev)
    assert r1 == r2 == root == cm.hash_from_byte_slices(leaves, device=dev)
    assert p1 == p2 == [proofs[i] for i in idx] and dedup > 1
