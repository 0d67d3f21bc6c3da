"""The CUDA kernels K1-K15 against their plain versions on the card, and
the sharded entries (rows 23-26) on a one-rank NCCL group
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


@pytest.fixture(scope="module")
def k4_pool(dev):
    import torch_comb_corpus as C

    from cometbft_tpu_torch.ops import comb

    pool = C.Pool(11)
    tab, val = comb.build_a_tables(torch.from_numpy(pool.pubs).to(dev))
    return pool, tab, val, comb.b_tables(dev)


def _k4_check(dev, k4_pool, b):
    """K4 over a batch of tests/torch_comb_corpus.py into an output
    buffer poisoned with 0xAA: every byte, the all-ok byte too, equals
    pack_verdicts of the plain version and the corpus's verdicts."""
    import torch_comb_corpus as C

    from cometbft_tpu_torch.ops import comb

    pool, tab, val, b_tab = k4_pool
    key = torch.from_numpy(b["key"]).to(dev)
    payload, digest = torch.from_numpy(b["payload"]).to(dev), torch.from_numpy(b["digest"]).to(dev)
    V = payload.shape[0]
    out = torch.full(((V + 7) // 8 + 1,), 0xAA, dtype=torch.uint8, device=dev)
    cnt = torch.empty((2,), dtype=torch.int32, device=dev)
    comb.launch_k4(tab[key], val[key].to(torch.uint8), payload, digest, b_tab, cnt, out)
    want = comb.pack_verdicts(comb.verify_cached_plain(tab[key], val[key], payload, digest, b_tab), payload[:, 67] == 1)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert np.array_equal(out.cpu().numpy(), C.packed_expect(b))
    return out


@pytest.mark.parametrize("V", [1, 8, 9, 33, 70, 257])
def test_k4_block_edges_match_plain(dev, k4_pool, V):
    """Failing lanes of every class at warp and block edges, non-live
    lanes beside valid ones, identity shares and s = 0 lanes."""
    import torch_comb_corpus as C

    _k4_check(dev, k4_pool, C.batch(k4_pool[0], V, 100 + V))


@pytest.mark.parametrize("mode", ["valid", "valid_dead"])
def test_k4_all_ok_byte(dev, k4_pool, mode):
    """All-valid lanes, then valid lanes beside failing non-live ones:
    the all-ok byte is 1 either way."""
    import torch_comb_corpus as C

    out = _k4_check(dev, k4_pool, C.batch(k4_pool[0], 70, 170, mode))
    assert int(out[-1]) == 1


def test_k4_s_zero_lanes(dev, k4_pool):
    """Lanes with s = 0 (every B entry the stored identity) alone."""
    import torch_comb_corpus as C

    b = C.batch(k4_pool[0], 96, 196, "valid")
    keep = [i for i, (k, _) in enumerate(b["kinds"]) if k == "s_zero"]
    sub = {k: v[keep] if isinstance(v, np.ndarray) else [v[i] for i in keep] for k, v in b.items()}
    assert not sub["payload"][:, 32:64].any()
    out = _k4_check(dev, k4_pool, sub)
    assert int(out[-1]) == 1


def test_k4_refuses_misaligned_tables(dev, k4_pool):
    """K4 loads table entries as 16-byte vectors: a table view that
    starts 4 bytes into its storage is refused before any launch."""
    import torch_comb_corpus as C

    from cometbft_tpu_torch.ops import comb

    pool, tab, val, b_tab = k4_pool
    b = C.batch(pool, 8, 208)
    key = torch.from_numpy(b["key"]).to(dev)
    flat = torch.empty(tab[key].numel() + 1, dtype=torch.int32, device=dev)
    skewed = flat[1:].view(tab[key].shape)
    skewed.copy_(tab[key])
    out = torch.empty((2,), dtype=torch.uint8, device=dev)
    cnt = torch.empty((2,), dtype=torch.int32, device=dev)
    before = comb.LAUNCHES["verify_cached"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        comb.launch_k4(skewed, val[key].to(torch.uint8), torch.from_numpy(b["payload"]).to(dev),
                       torch.from_numpy(b["digest"]).to(dev), b_tab, cnt, out)
    assert comb.LAUNCHES["verify_cached"] == before


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


@pytest.fixture(scope="module")
def group_pool(dev):
    import torch_group_corpus as GC

    return GC.Pool(10)


@pytest.mark.parametrize("n", [1, 3, 7, 8, 9, 31, 33, 255, 256, 257, 12_288, 12_289, 16_384])
def test_k5_group_edges_match_plain(dev, group_pool, n):
    """K5's groups on tests/torch_group_corpus.py batches (failing lanes
    of every class at warp and block edges; 4 threads a lane up to
    12,288 lanes, 2 above, up to the uncached path's 16,384) into a buffer
    poisoned with 0xAA: every verdict byte equals the plain version's
    and the corpus's."""
    import torch_group_corpus as GC

    from cometbft_tpu_torch.ops import ed25519 as E

    b = GC.lanes(group_pool, n, 10 + n, 32 // E.threads_per_lane(n), E.LANES_PER_BLOCK)
    a, r, s, d = (torch.from_numpy(b[k]).to(dev) for k in ("a", "r", "s", "digest"))
    out = torch.full((n,), 0xAA, dtype=torch.uint8, device=dev)
    E.launch_k5(a, r, s, d, E.b_window(dev), out)
    want = E.verify_digest_plain(a, r, s, d)
    torch.cuda.synchronize()
    assert torch.equal(out, want.to(torch.uint8))
    assert out.cpu().numpy().tolist() == b["expect"].astype(np.uint8).tolist()


@pytest.mark.parametrize("V", [1, 2, 7, 8, 9, 127, 128, 129, 10_000])
def test_k3_group_edges_match_plain(dev, group_pool, V):
    """K3's groups on tests/torch_group_corpus.py keys (off-curve keys at
    warp and block edges, non-canonical y, identity and small-order
    keys; up to 10,000 keys) into buffers poisoned with 0xAA: every
    table word and valid byte equals the plain version's and the
    corpus's validity, and the first 16 keys' tables equal the host
    bigint build's."""
    import torch_group_corpus as GC

    from cometbft_tpu_torch.ops import comb

    b = GC.keys(group_pool, V, 20 + V, 32 // comb.BUILD_THREADS_PER_KEY, comb.BUILD_KEYS_PER_BLOCK)
    pubs = torch.from_numpy(b["pubs"]).to(dev)
    tables = torch.full((V, 64, 8, 3, 8), -0x55555556, dtype=torch.int32, device=dev)
    valid = torch.full((V,), 0xAA, dtype=torch.uint8, device=dev)
    comb.launch_k3(pubs, tables, valid)
    pt, pv = comb.build_a_tables_plain(pubs)
    torch.cuda.synchronize()
    assert torch.equal(tables, pt) and torch.equal(valid, pv.to(torch.uint8))
    assert valid.cpu().numpy().tolist() == b["expect"].astype(np.uint8).tolist()
    th, _ = comb.build_a_tables_host(b["pubs"][:16])
    assert np.array_equal(tables[:16].cpu().numpy().view(np.uint32), th)


def test_k3_refuses_misaligned_tables(dev):
    """K3 stores table entries as 16-byte vectors: a table view that
    starts 4 bytes into its storage is refused before any launch."""
    from cometbft_tpu_torch.ops import comb

    pubs = torch.zeros((2, 32), dtype=torch.uint8, device=dev)
    flat = torch.empty(2 * 64 * 8 * 3 * 8 + 1, dtype=torch.int32, device=dev)
    skewed = flat[1:].view(2, 64, 8, 3, 8)
    valid = torch.empty((2,), dtype=torch.uint8, device=dev)
    before = comb.LAUNCHES["build_a_tables"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        comb.launch_k3(pubs, skewed, valid)
    assert comb.LAUNCHES["build_a_tables"] == before


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


def test_k8_writes_a_one_node_level(dev):
    """K8 on a level of one node copies it into the parent level (the JAX
    hash_level returns a one-node level unchanged); the output row is
    poisoned first, so a launch that writes nothing fails."""
    from cometbft_tpu_torch.ops import merkle as M

    rng = np.random.default_rng(14)
    flat = torch.from_numpy(rng.integers(0, 256, size=(5, 32), dtype=np.uint8)).to(dev)
    flat[4] = 0xAA
    want = flat.clone()
    M.merkle_level_plain(want, 2, 1, 4)
    launches = M.LAUNCHES["merkle_level"]
    M.merkle_level(flat, 2, 1, 4)
    assert M.LAUNCHES["merkle_level"] == launches + 1
    assert torch.equal(flat, want) and torch.equal(flat[4], flat[2])


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


def test_k10_matches_plain_and_host(dev):
    """K10 on 300 rows of 1-3 active blocks, lengths 0-300 with 135-137,
    stale bytes past each row's last block."""
    from cometbft_tpu_torch.crypto.keccak import keccak256
    from cometbft_tpu_torch.ops import keccak as K

    rng = np.random.default_rng(14)
    lens = [0, 1, 135, 136, 137, 271, 272, 300] + rng.integers(0, 301, size=292).tolist()
    msgs = [rng.bytes(n) for n in lens]
    blocks, active = K.pad_messages_keccak(msgs)
    blocks = blocks.copy()
    for i, a in enumerate(active.tolist()):
        blocks[i, a:] = rng.integers(0, 256, size=(blocks.shape[1] - a, K.RATE), dtype=np.uint8)
    b, a = torch.from_numpy(blocks).to(dev), torch.from_numpy(active).to(dev)
    got = K.keccak256_blocks(b, a)
    assert torch.equal(got, K.keccak256_blocks_plain(b, a))
    assert [bytes(r) for r in got.cpu().numpy()] == [keccak256(m) for m in msgs]


@pytest.fixture(scope="module")
def secp_case():
    from torch_secp_corpus import corpus

    from cometbft_tpu_torch.models import secp_verifier as sv

    rows = corpus(b"cuda")
    items = [r[:3] for r in rows]
    return items, [sv._host_verify_one(*it) for it in items]


@pytest.mark.parametrize("glv", [True, False])
@pytest.mark.parametrize("hash_dev", [True, False])
def test_k11_k12_match_plain_and_host_oracle(dev, secp_case, glv, hash_dev):
    """K11 and K12 in every instantiation against their plain versions
    and the host oracle on the adversarial corpus; the verify-only
    instantiation on the rows without ecrecover."""
    from cometbft_tpu_torch.models import secp_verifier as sv
    from cometbft_tpu_torch.ops import secp256k1 as S

    items, expect = secp_case
    for recover in (True, False):
        keep = [i for i, it in enumerate(items) if recover or len(it[0]) != sv.ECR_PUB]
        sub = [items[i] for i in keep]
        st = sv.stage_batch(sub, dev, hash_dev, 119)
        gtab = S.g_table(dev)
        rows = (st["qx"], st["qy"], st["q_valid"])
        tail = (st["is_eth"], st["v"], st["is_rec"], st["addr"], gtab)
        if hash_dev:
            blocks = (st["sha_blocks"], st["sha_active"], st["kec_blocks"], st["kec_active"])
            got = S.hash_verify_batch(*blocks, *rows, st["r"], st["s"], *tail, glv=glv, recover=recover)
            want = S.hash_verify_batch_plain(*blocks, *rows, st["r"], st["s"], *tail, glv=glv, recover=recover)
        else:
            e = sv.staged_e(st)  # K10 for the Keccak rows
            got = S.verify_batch(*rows, e, st["r"], st["s"], *tail, glv=glv, recover=recover)
            want = S.verify_batch_plain(*rows, e, st["r"], st["s"], *tail, glv=glv, recover=recover)
        assert torch.equal(got, want)
        assert got[: len(sub)].tolist() == [expect[i] for i in keep]


def test_secp_batch_verifier_takes_each_route(dev, secp_case, monkeypatch):
    from cometbft_tpu_torch.models import secp_verifier as sv
    from cometbft_tpu_torch.ops import secp256k1 as S

    items, expect = secp_case
    monkeypatch.setenv("COMETBFT_TPU_SECP_HASH_DEVICE_MIN", "1")
    for glv in ("1", "0"):
        monkeypatch.setenv("COMETBFT_TPU_SECP_GLV", glv)
        before = dict(S.LAUNCHES)
        bv = sv.SecpBatchVerifier(device=dev)
        for it in items:
            bv.add(*it)
        ok, res = bv.verify()
        assert res == expect and not ok
        name = S.variant("secp_hash_verify", glv == "1", True)
        assert S.LAUNCHES[name] == before[name] + 1


@pytest.fixture(scope="module")
def secp_edge_case(secp_case):
    from torch_secp_corpus import infinity_row

    from cometbft_tpu_torch.models import secp_verifier as sv
    from cometbft_tpu_torch.ops import secp256k1 as S

    items, expect = secp_case
    inf = infinity_row(b"cuda")
    assert not sv._host_verify_one(*inf)
    return items + [inf], expect + [False], S.ROWS_PER_BLOCK


def _secp_launch_into(st, e, out, fused, glv, recover):
    """The C entry as the wrappers call it, into a given output."""
    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch.ops import secp256k1 as S

    gtab = S.g_table(out.device)
    n = st["qx"].shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.lib("secp")
    if fused:
        a = [st["sha_blocks"], st["sha_active"], st["kec_blocks"], st["kec_active"], st["qx"], st["qy"],
             st["q_valid"], st["r"], st["s"], st["is_eth"], st["v"], st["is_rec"], st["addr"], gtab, out]
        p = [x.data_ptr() for x in a]
        code = lib.k12_secp_hash_verify(p[0], p[1], st["sha_blocks"].shape[1], p[2], p[3],
                                        st["kec_blocks"].shape[1], *p[4:], n, int(glv), int(recover), stream)
    else:
        a = [st["qx"], st["qy"], st["q_valid"], e, st["r"], st["s"], st["is_eth"], st["v"], st["is_rec"],
             st["addr"], gtab, out]
        code = lib.k11_secp_verify(*[x.data_ptr() for x in a], n, int(glv), int(recover), stream)
    _build.check(code, "secp launch")


def _secp_check_batch(dev, batch, want_host, fused, glv, recover):
    """One batch through K11 / K12 into an output of 0xAA, against the
    plain version on every row and the host oracle on the batch's rows."""
    from cometbft_tpu_torch.models import secp_verifier as sv
    from cometbft_tpu_torch.ops import secp256k1 as S

    st = sv.stage_batch(batch, dev, fused, 119)
    e = None if fused else sv.staged_e(st).contiguous()
    out = torch.full((st["qx"].shape[0],), 0xAA, dtype=torch.uint8, device=dev)
    _secp_launch_into(st, e, out, fused, glv, recover)
    rows = (st["qx"], st["qy"], st["q_valid"])
    tail = (st["is_eth"], st["v"], st["is_rec"], st["addr"], S.g_table(dev))
    if fused:
        hb = (st["sha_blocks"], st["sha_active"], st["kec_blocks"], st["kec_active"])
        want = S.hash_verify_batch_plain(*hb, *rows, st["r"], st["s"], *tail, glv=glv, recover=recover)
    else:
        want = S.verify_batch_plain(*rows, e, st["r"], st["s"], *tail, glv=glv, recover=recover)
    torch.cuda.synchronize()
    assert set(out.tolist()) <= {0, 1}  # every row written
    assert torch.equal(out.bool(), want)
    assert out.bool()[: len(batch)].tolist() == want_host


@pytest.mark.parametrize("n", [1, 3, 31, 33, 255, 4096])
@pytest.mark.parametrize("hash_dev", [True, False], ids=["k12", "k11"])
@pytest.mark.parametrize("recover", [True, False], ids=["recover", "verify"])
@pytest.mark.parametrize("glv", [True, False], ids=["glv", "shamir"])
def test_k11_k12_block_edges_match_plain(dev, secp_edge_case, glv, recover, hash_dev, n):
    """Every instantiation at partial groups and blocks: invalid rows at
    every block's first and last row and between valid rows, a block whose
    one valid row sits beside a row at infinity (chip_smoke.py's
    block-edge batch)."""
    from torch_secp_corpus import block_edge_order

    from cometbft_tpu_torch.models import secp_verifier as sv

    items, expect, rows = secp_edge_case
    keep = [i for i, it in enumerate(items) if recover or len(it[0]) != sv.ECR_PUB]
    good = [i for i in keep if expect[i]]
    bad = [i for i in keep if not expect[i]]
    order = block_edge_order(good, bad, len(items) - 1, n, rows)
    _secp_check_batch(dev, [items[i] for i in order], [expect[i] for i in order], hash_dev, glv, recover)


@pytest.mark.parametrize("kind", ["cosmos", "eth", "ecrecover"])
@pytest.mark.parametrize("hash_dev", [True, False], ids=["k12", "k11"])
@pytest.mark.parametrize("glv", [True, False], ids=["glv", "shamir"])
def test_k11_k12_single_kind_batches(dev, secp_edge_case, kind, glv, hash_dev):
    """Batches of one wire shape (valid and invalid rows of that shape
    only), beside the mixed batches above."""
    from cometbft_tpu_torch.models import secp_verifier as sv

    items, expect, _ = secp_edge_case
    size = {"cosmos": sv.COSMOS_PUB, "eth": sv.ETH_PUB, "ecrecover": sv.ECR_PUB}[kind]
    idx = [i for i, it in enumerate(items) if len(it[0]) == size]
    order = [idx[k % len(idx)] for k in range(200)]
    for recover in (True, False) if kind != "ecrecover" else (True,):
        _secp_check_batch(dev, [items[i] for i in order], [expect[i] for i in order], hash_dev, glv, recover)


def _bls_points(n, seed):
    """n subgroup points a + i b (times G), affine, by one Jacobian add a
    point and one batched inversion."""
    from cometbft_tpu_torch.crypto import bls12381 as H

    F, P = H._FP, H.P
    rng = np.random.default_rng(seed)
    a, b = int(rng.integers(2, 1 << 62)), int(rng.integers(2, 1 << 62))
    step = H._jac_mul(F, H._from_affine(F, H.G1_GEN), b)
    acc, jac = H._jac_mul(F, H._from_affine(F, H.G1_GEN), a), []
    for _ in range(n):
        jac.append(acc)
        acc = H._jac_add(F, acc, step)
    out = []
    for X, Y, Z in jac:
        zi = pow(Z, P - 2, P)
        out.append((X * zi * zi % P, Y * zi * zi * zi % P))
    return out


@pytest.fixture(scope="module")
def bls_case():
    from cometbft_tpu_torch.crypto import bls12381 as H

    P = H.P
    rows = _bls_points(70, 13)
    x = 1
    while True:
        y = H._fp_sqrt((x ** 3 + 4) % P)
        if y is not None and not H._in_subgroup(H._FP, (x, y)):
            break
        x += 1
    rows[3], rows[10], rows[20] = (x, y), None, (5, 6)  # wrong subgroup, host-rejected, off curve
    rows[30] = rows[31]  # a repeated key: the tree's doubling
    return rows


def test_k13_k15_match_plain_and_host(dev, bls_case):
    """K13 and K15 (+ K14's finishing stage) on 70 rows (a ragged tile)
    with every bad class and a non-canonical x: ok bytes equal the plain
    versions' and the host oracle's, the triple the plain version's word
    for word and the host sum as an affine point."""
    from cometbft_tpu_torch.crypto import bls12381 as H
    from cometbft_tpu_torch.ops import bls381 as B

    rows = bls_case
    X, Y, valid = B.pack_affine(rows)
    X[40] = B.ints_to_words_np([B.P + 5])[0]  # x >= p, flagged valid
    want = [r is not None and i != 40 and H._on_curve(H._FP, r) and H._in_subgroup(H._FP, r)
            for i, r in enumerate(rows)]
    Xd, Yd, vd = (torch.from_numpy(a).to(dev) for a in (X, Y, valid))
    ok = B.validate_g1(Xd, Yd, vd)
    assert torch.equal(ok, B.validate_g1_plain(Xd, Yd, vd)) and ok.tolist() == want
    got = B.validate_aggregate_g1(Xd, Yd, vd)
    plain = B.validate_aggregate_g1_plain(Xd, Yd, vd)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))
    acc = (1, 1, 0)
    for r, o in zip(rows, want):
        if o:
            acc = H._jac_add(H._FP, acc, H._from_affine(H._FP, r))
    assert B.jac_to_affine_host(*(t.cpu() for t in got[1:])) == H._to_affine(H._FP, acc)


@pytest.mark.parametrize("n", [1, 33, 8200])
def test_k14_matches_plain_and_host(dev, n):
    """K14 at 1 row, a tile and a row, and 257 tile partials (the
    finishing stage's fold), with identity rows and a point beside its
    negation, at random Z."""
    from cometbft_tpu_torch.crypto import bls12381 as H
    from cometbft_tpu_torch.ops import bls381 as B

    P = B.P
    rng = np.random.default_rng(n)
    pts = _bls_points(n, n)
    if n > 1:
        pts[1] = None
        pts[min(16, n - 1)] = (pts[0][0], P - pts[0][1])
    cols = ([], [], [])
    for a in pts:
        z = int.from_bytes(rng.bytes(48), "big") % P
        X, Y, Z = (1, 1, 0) if a is None else (a[0] * z * z % P, a[1] * z ** 3 % P, z)
        for c, v in zip(cols, (X, Y, Z)):
            c.append(B.to_mont(v))
    Xd, Yd, Zd = (torch.from_numpy(B.ints_to_words_np(c)).to(dev) for c in cols)
    got = B.aggregate_g1(Xd, Yd, Zd)
    assert all(torch.equal(g, p) for g, p in zip(got, B.aggregate_g1_plain(Xd, Yd, Zd)))
    acc = (1, 1, 0)
    for a in pts:
        acc = H._jac_add(H._FP, acc, H._from_affine(H._FP, a))
    assert B.jac_to_affine_host(*(t.cpu() for t in got)) == H._to_affine(H._FP, acc)


def test_bls_verifier_takes_each_route(dev, monkeypatch):
    """An aggregate commit cold (K15 + K14's finishing stage), warm (K14)
    and singleton rows (K13), verdicts equal to the host verifier's."""
    from cometbft_tpu_torch.crypto import bls12381 as H
    from cometbft_tpu_torch.models import bls_verifier as M
    from cometbft_tpu_torch.ops import bls381 as B

    monkeypatch.setenv("COMETBFT_TPU_BLS_AGG_DEVICE_MIN", "2")
    keys = [H.PrivKey(3 + 2 * i) for i in range(9)]
    msg = b"cuda-agg"
    agg = H.aggregate_signatures([k.sign(msg) for k in keys])
    commit = [(k.pub_key().data, msg, agg) for k in keys]
    solo = [(k.pub_key().data, b"m%d" % i, k.sign(b"m%d" % i)) for i, k in enumerate(keys)]
    solo[4] = (solo[4][0], solo[4][1], keys[5].sign(solo[4][1]))
    M.reset_caches()
    for items, want in ((commit, {"validate_aggregate_g1": 1, "aggregate_g1_finish": 1}),
                        (commit, {"aggregate_g1": 1, "aggregate_g1_finish": 1})):
        before = dict(B.LAUNCHES)
        bv = M.BlsAggregateVerifier(device=dev)
        for it in items:
            bv.add(*it)
        assert bv.verify() == (True, [True] * 9)
        assert {k: B.LAUNCHES[k] - before[k] for k in B.LAUNCHES} == dict(dict.fromkeys(B.LAUNCHES, 0), **want)
    M.reset_caches()
    before = dict(B.LAUNCHES)
    bv = M.BlsAggregateVerifier(device=dev)
    for it in solo:
        bv.add(*it)
    cpu = M.CpuBlsBatchVerifier()
    for it in solo:
        cpu.add(*it)
    M.reset_caches()
    assert bv.verify() == cpu.verify() == (False, [i != 4 for i in range(9)])
    assert B.LAUNCHES["validate_g1"] == before["validate_g1"] + 1


# --------------------------------------------- rows 23-26 at world 1 (NCCL)


@pytest.fixture(scope="module")
def nccl_mesh(dev):
    """A one-rank NCCL group in this process and its mesh on the card."""
    import datetime
    import socket

    import torch.distributed as dist

    from cometbft_tpu_torch import parallel as P

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield P.make_mesh(device=dev)
    finally:
        dist.destroy_process_group()


def test_sharded_entries_at_world_1_match_one_device(dev, nccl_mesh):
    """Rows 23, 25, 26 and commit_verification_step on the card: equal to
    the one-device kernels' results and the host oracles."""
    import torch_parallel_ranks as R

    from cometbft_tpu_torch.crypto import merkle as cm
    from cometbft_tpu_torch.ops import ed25519 as E
    from cometbft_tpu_torch.ops import merkle as M
    from cometbft_tpu_torch.parallel import verify as PV

    card = torch.device("cuda", 0)  # rank 0 of one card
    assert (nccl_mesh.backend, nccl_mesh.device, nccl_mesh.comm_device) == ("nccl", card, card)
    case = R.make_case()
    before = dict(PV.LAUNCHES)
    got = R.run_entries(nccl_mesh, case)
    assert PV.LAUNCHES["sharded_verify_batch"] == before["sharded_verify_batch"] + 2
    assert PV.LAUNCHES["sharded_merkle_proofs"] == before["sharded_merkle_proofs"] + 1
    batch = [torch.from_numpy(x).to(dev) for x in R.uncached_batch(case)]
    assert np.array_equal(got["verify_valid"], E.verify_batch(*batch).cpu().numpy())
    assert got["verify_ok"] is False and not got["verify_valid"][list(R.CORRUPT)].any()
    assert got["root"] == cm.hash_from_byte_slices(case["leaves"], device=False)
    pb, pa, _ = M.stage_leaves(case["proof_leaves"], dev)
    coords = torch.from_numpy(M.proof_coords(R.PROOF_LEAVES, case["proof_idx"], case["proof_sib"])).to(dev)
    root, nodes = M.nodes_from_leaves(pb, pa, coords)
    assert got["proof_root"] == bytes(root.cpu().numpy())
    assert np.array_equal(got["leaf_sel"], nodes[:, 0].cpu().numpy())
    assert np.array_equal(got["aunts"], nodes[:, 1:].cpu().numpy())
    ok, valid, sroot = got["step"]
    assert ok == got["verify_ok"] and np.array_equal(valid, got["verify_valid"]) and sroot == got["root"]


def test_sharded_comb_path_at_world_1_matches_one_device(dev, nccl_mesh):
    """Row 24 through the comb cache bound to the NCCL mesh: the verdict
    cases, a set change, and the [bitmap | all_ok] bytes of the
    one-device K1 -> K2 -> K4; then one rank's late build (readiness is
    agreed with an NCCL all_reduce)."""
    import torch_parallel_ranks as R

    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.parallel import verify as PV

    case = R.make_case()
    before = PV.LAUNCHES["sharded_verify_cached"]
    got = R.run_comb(nccl_mesh, case)
    assert PV.LAUNCHES["sharded_verify_cached"] > before
    assert got["all_valid"] == (True, [True] * R.N_SIGS)
    assert got["tampered"] == (False, [i != R.TAMPER for i in range(R.N_SIGS)])
    assert got["subset"] == (True, [True] * len(R.SUBSET))
    assert got["padded"] == (16, (True, [True] * R.N_PADDED))
    assert got["churn_verify"] == (True, [True] * R.N_SIGS)
    entry = cv.ValsetCombCache().ensure(case["pubs"], device=dev)  # no mesh: one device
    assert np.array_equal(got["tables"], entry.tables.cpu().numpy())
    payload = torch.from_numpy(cv.assemble_payload(R.comb_items(case, R.TAMPER), np.arange(R.N_SIGS),
                                                   entry.vpad)).to(dev)
    one = cv.device_verify(entry.tables, entry.valid, entry.pubs, payload, entry.b_tables)
    assert got["bitmap"].tobytes() == one.cpu().numpy().tobytes()
    guard = R.run_deadlock_guard(nccl_mesh, case)
    assert guard["routes"] == ["Ed25519BatchVerifier", "CombBatchVerifier"]
    assert guard["results"][0] == guard["results"][1] == got["tampered"]
