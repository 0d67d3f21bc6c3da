"""The CUDA kernels K1-K15 against their plain versions on the card, the
launches on a second card (two cards; skips on one), and the sharded
entries (rows 23-26) on a one-rank NCCL group
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


@pytest.fixture
def svc_stop():
    """The verify services a test's verifiers started, stopped after it."""
    yield
    from cometbft_tpu_torch.verifysvc import reset_global_service

    reset_global_service()


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


@pytest.mark.parametrize("n,nb", [(1, 2), (31, 2), (33, 2), (10_001, 2), (16_384, 3)])
def test_k2_matches_plain_and_hashlib(dev, n, nb):
    """K2 at a ragged warp, the main path's 10,000 rows and one, and the
    uncached path's 16,384 lanes of 1-3 active blocks, stale bytes past
    each row's end: equal to the plain version and hashlib, rows at
    active = 0 keeping the initial state."""
    import torch_sha_corpus as SC

    from cometbft_tpu_torch.ops import sha2

    msgs, blocks, active = SC.stale_rows(np.random.default_rng(n), n, nb)
    b, a = torch.from_numpy(blocks).to(dev), torch.from_numpy(active).to(dev)
    got = sha2.sha512_blocks(b, a)
    assert torch.equal(got, sha2.sha512_blocks_plain(b, a))
    assert [bytes(r) for r in got.cpu().numpy()] == SC.digests(msgs, active)


def test_k2_aligned_view_and_misaligned_refusal(dev):
    """K2 on a 16-byte-aligned view at a nonzero offset of a larger buffer
    (as the uncached staging hands it over) equals the plain version; a
    view 8 bytes off passes through sha512_blocks (copied to a fresh,
    aligned allocation) and equals the plain version, while launch_k2
    itself refuses it, blocks or digest, with ValueError."""
    import torch_sha_corpus as SC

    from cometbft_tpu_torch.ops import sha2

    _, blocks, active = SC.stale_rows(np.random.default_rng(16), 100, 2)
    flat = torch.zeros((blocks.nbytes + 64,), dtype=torch.uint8, device=dev)
    b = flat[48 : 48 + blocks.nbytes].view(100, 2, 128)
    b.copy_(torch.from_numpy(blocks).to(dev))
    a = torch.from_numpy(active).to(dev)
    assert b.data_ptr() % 16 == 0 and b.data_ptr() != flat.data_ptr()
    assert torch.equal(sha2.sha512_blocks(b, a), sha2.sha512_blocks_plain(b, a))
    off = flat[8 : 8 + blocks.nbytes].view(100, 2, 128)
    off.copy_(torch.from_numpy(blocks).to(dev))
    assert off.data_ptr() % 16 == 8
    assert torch.equal(sha2.sha512_blocks(off, a), sha2.sha512_blocks_plain(off, a))
    digest = torch.empty((100 * 64 + 8,), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        sha2.launch_k2(off, a, digest[: 100 * 64].view(100, 64))
    with pytest.raises(ValueError):
        sha2.launch_k2(b, a, digest[8:].view(100, 64))


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


@pytest.mark.parametrize("n,nb", [(10_000, 1), (16_384, 3), (31, 4)])
def test_k7_rows_match_plain_and_hashlib(dev, n, nb):
    """K7 at the validator-set tree's 10,000 one-block leaves, 16,384 rows
    of 1-3 active blocks and a ragged warp of 1-4, stale bytes past each
    row's end and rows at active = 0 (the initial state), over a poisoned
    digest."""
    import torch_sha_corpus as SC

    from cometbft_tpu_torch.ops import sha2

    msgs, blocks, active = SC.stale_rows_sha256(np.random.default_rng(n + nb), n, nb)
    b, a = torch.from_numpy(blocks).to(dev), torch.from_numpy(active).to(dev)
    got = torch.full((n, 32), 0xAA, dtype=torch.uint8, device=dev)
    sha2.launch_k7(b, a, got)
    assert torch.equal(got, sha2.sha256_blocks_plain(b, a))
    assert [bytes(r) for r in got.cpu().numpy()] == SC.digests_sha256(msgs, active)


def test_k7_aligned_view_and_misaligned_refusal(dev):
    """K7 on a 16-byte-aligned view at a nonzero offset of a larger buffer
    equals the plain version; a view 4 bytes off passes through
    sha256_blocks (copied to a fresh, aligned allocation), while launch_k7
    itself refuses it, blocks or digest, with ValueError."""
    import torch_sha_corpus as SC

    from cometbft_tpu_torch.ops import sha2

    _, blocks, active = SC.stale_rows_sha256(np.random.default_rng(17), 100, 2)
    flat = torch.zeros((blocks.nbytes + 64,), dtype=torch.uint8, device=dev)
    b = flat[48 : 48 + blocks.nbytes].view(100, 2, 64)
    b.copy_(torch.from_numpy(blocks).to(dev))
    a = torch.from_numpy(active).to(dev)
    assert b.data_ptr() % 16 == 0 and b.data_ptr() != flat.data_ptr()
    want = sha2.sha256_blocks_plain(b, a)
    assert torch.equal(sha2.sha256_blocks(b, a), want)
    digest = torch.empty((100 * 32 + 16,), dtype=torch.uint8, device=dev)
    sha2.launch_k7(b, a, digest[16:].view(100, 32))
    assert torch.equal(digest[16:].view(100, 32), want)
    off = flat[4 : 4 + blocks.nbytes].view(100, 2, 64)
    off.copy_(torch.from_numpy(blocks).to(dev))
    assert off.data_ptr() % 16 == 4
    assert torch.equal(sha2.sha256_blocks(off, a), want)
    with pytest.raises(ValueError):
        sha2.launch_k7(off, a, digest[: 100 * 32].view(100, 32))
    with pytest.raises(ValueError):
        sha2.launch_k7(b, a, digest[4 : 4 + 100 * 32].view(100, 32))


@pytest.mark.parametrize("maxm", [32, 64, 128, 192])
@pytest.mark.parametrize("V", [1, 31, 33, 10_001])
def test_k1_matches_plain(dev, V, maxm):
    """K1 at one row, ragged warps and the main path's width plus one, at
    each caller's message width: every mlen edge, rows whose mlen exceeds
    maxm (up to 2^24 - 1) and rows that are not live, over poisoned
    outputs with a guard row past the end that must stay poisoned."""
    import torch_sha_corpus as SC

    from cometbft_tpu_torch.ops import sha2

    payload, pubs = (torch.from_numpy(x).to(dev) for x in SC.payload_rows(np.random.default_rng(V + maxm), V,
                                                                          68 + maxm))
    nb = sha2.nblocks_for(maxm)
    blocks = torch.full((V + 1, nb, 128), 0xAA, dtype=torch.uint8, device=dev)
    active = torch.full((V + 1,), -0x55555556, dtype=torch.int32, device=dev)
    sha2.launch_k1(payload, pubs, blocks, active)
    pb, pa = sha2.parse_verify_payload_plain(payload, pubs)
    assert torch.equal(blocks[:V], pb) and torch.equal(active[:V], pa)
    assert bool((blocks[V] == 0xAA).all()) and int(active[V]) == -0x55555556
    _, _, wb, wa, _ = sha2.parse_verify_payload(payload, pubs)
    assert torch.equal(wb, pb) and torch.equal(wa, pa)


@pytest.mark.parametrize("width", [69, 70, 71, 101, 113, 114, 115, 197, 241, 242, 243, 259])
def test_k1_odd_widths_match_plain(dev, width):
    """parse_verify_payload at widths that are not a multiple of 4 (it pads
    the payload for K1's word loads): the plain version's blocks and
    active counts at the original width, rows whose mlen exceeds maxm
    included."""
    import torch_sha_corpus as SC

    from cometbft_tpu_torch.ops import sha2

    payload, pubs = (torch.from_numpy(x).to(dev) for x in SC.payload_rows(np.random.default_rng(width), 101, width))
    _, _, blocks, active, _ = sha2.parse_verify_payload(payload, pubs)
    pb, pa = sha2.parse_verify_payload_plain(payload, pubs)
    assert blocks.shape == pb.shape and torch.equal(blocks, pb) and torch.equal(active, pa)


def test_k1_misaligned_refusal(dev):
    """launch_k1 refuses blocks that are not 16-byte aligned, payload or
    pubkeys that are not 4-byte aligned and a width that is not a
    multiple of 4 (K1 reads words), each with ValueError; a payload and
    pubkeys at an odd offset pass through parse_verify_payload (copied to
    fresh, aligned allocations) and give the plain version's blocks, and
    so does a width that is not a multiple of 4 (padded with zero
    columns)."""
    import torch_sha_corpus as SC

    from cometbft_tpu_torch.ops import sha2

    V, width = 50, 196
    payload_np, pubs_np = SC.payload_rows(np.random.default_rng(18), V, width)
    pay_buf = torch.zeros((payload_np.size + 3,), dtype=torch.uint8, device=dev)
    payload = pay_buf[3:].view(V, width)
    payload.copy_(torch.from_numpy(payload_np).to(dev))
    pub_buf = torch.zeros((pubs_np.size + 5,), dtype=torch.uint8, device=dev)
    pubs = pub_buf[5:].view(V, 32)
    pubs.copy_(torch.from_numpy(pubs_np).to(dev))
    pb, pa = sha2.parse_verify_payload_plain(payload, pubs)
    _, _, wb, wa, _ = sha2.parse_verify_payload(payload, pubs)
    assert torch.equal(wb, pb) and torch.equal(wa, pa)
    good_pay, good_pubs = payload.clone(), pubs.clone()
    nb = sha2.nblocks_for(width - 68)
    out = torch.empty((V * nb * 128 + 16,), dtype=torch.uint8, device=dev)
    active = torch.empty((V,), dtype=torch.int32, device=dev)
    sha2.launch_k1(good_pay, good_pubs, out[16:].view(V, nb, 128), active)
    assert torch.equal(out[16:].view(V, nb, 128), pb) and torch.equal(active, pa)
    with pytest.raises(ValueError):
        sha2.launch_k1(good_pay, good_pubs, out[8 : 8 + V * nb * 128].view(V, nb, 128), active)
    with pytest.raises(ValueError):
        sha2.launch_k1(payload, good_pubs, out[16:].view(V, nb, 128), active)
    with pytest.raises(ValueError):
        sha2.launch_k1(good_pay, pubs, out[16:].view(V, nb, 128), active)
    odd_np, odd_pubs = SC.payload_rows(np.random.default_rng(19), V, 101)
    odd, odd_pubs = torch.from_numpy(odd_np).to(dev), torch.from_numpy(odd_pubs).to(dev)
    onb = sha2.nblocks_for(101 - 68)
    with pytest.raises(ValueError):
        sha2.launch_k1(odd, odd_pubs, torch.empty((V, onb, 128), dtype=torch.uint8, device=dev), active)
    _, _, ob, oa, _ = sha2.parse_verify_payload(odd, odd_pubs)
    qb, qa = sha2.parse_verify_payload_plain(odd, odd_pubs)
    assert torch.equal(ob, qb) and torch.equal(oa, qa)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 9, 130, 511, 512, 513, 1000])
def test_k8_levels_match_plain_and_host(dev, n):
    """One K8 launch a tree (none for one leaf, which has no level): every
    level equal to the plain version's from the same level 0, over rows
    poisoned first, at sizes of one block (up to 2T = 512 leaves) and of
    several; the root equals the host route's."""
    from cometbft_tpu_torch.crypto import merkle as cm
    from cometbft_tpu_torch.ops import merkle as M

    rng = np.random.default_rng(11 + n)
    leaves = [rng.bytes(int(rng.integers(0, 100))) for _ in range(n)]
    blocks, active, _ = M.stage_leaves(leaves, dev)
    before = M.LAUNCHES["merkle_tree"]
    flat = M.all_levels(blocks, active)
    assert M.LAUNCHES["merkle_tree"] == before + (n > 1)
    want = flat.clone()
    want[n:] = 0
    M.merkle_tree_plain(want, n)
    assert torch.equal(flat, want)
    poisoned = torch.full_like(flat, 0xAA)
    poisoned[:n] = flat[:n]
    M.merkle_tree(poisoned, n)
    assert torch.equal(poisoned, want)
    assert bytes(flat[-1].cpu().numpy()) == cm.hash_from_byte_slices(leaves, device=False)


def test_k8_writes_a_one_node_level(dev):
    """Every tree's top level is one node: K8 writes it over a poisoned
    row, the trailing node promoted at the top (3 leaves) and the last
    block's subtree root folded in (1,025 leaves: three blocks); a second
    launch on the same stream at once (the ticket counter reset by the
    first) gives the same tree.  One leaf launches nothing."""
    from cometbft_tpu_torch.ops import merkle as M

    rng = np.random.default_rng(14)
    for n in (2, 3, 1025):
        rows = M.level_offsets(n)[-1] + 1
        flat = torch.full((rows, 32), 0xAA, dtype=torch.uint8, device=dev)
        flat[:n] = torch.from_numpy(rng.integers(0, 256, size=(n, 32), dtype=np.uint8)).to(dev)
        want = flat.clone()
        M.merkle_tree_plain(want, n)
        launches = M.LAUNCHES["merkle_tree"]
        M.merkle_tree(flat, n)
        first = flat.clone()
        flat[n:] = 0xAA
        M.merkle_tree(flat, n)
        assert M.LAUNCHES["merkle_tree"] == launches + 2
        assert torch.equal(first, want) and torch.equal(flat, want), n
    one = torch.from_numpy(rng.integers(0, 256, size=(1, 32), dtype=np.uint8)).to(dev)
    keep, launches = one.clone(), M.LAUNCHES["merkle_tree"]
    M.merkle_tree(one, 1)
    assert M.LAUNCHES["merkle_tree"] == launches and torch.equal(one, keep)


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


def test_second_card_launches_off_the_current_device(dev, monkeypatch, svc_stop):
    """Every launch and completion event on its tensors' card: a comb
    verify (K1 -> K2 -> K4, the tables by K3, launched by the verify
    service of cuda:1 from its own threads) and a Merkle tree (K7, K8) on
    cuda:1 while the thread's current device is cuda:0, verdicts and
    root equal to the host's.  Needs two cards; skips on one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the launches go to cuda:1 while cuda:0 is current")
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.crypto import merkle as cm
    from cometbft_tpu_torch.models import comb_verifier as cv

    monkeypatch.setenv("COMETBFT_TPU_COMB_MIN", "2")
    monkeypatch.setenv("COMETBFT_TPU_COMB_ASYNC_MIN", "100000")
    d1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(21)
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(40)]
    msgs = [rng.bytes(int(rng.integers(0, 120))) for _ in keys]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    sigs[5] = sigs[6]
    bv = batch.create_batch_verifier("ed25519", [k.pub_key().data for k in keys], device=d1,
                                     comb_cache=cv.ValsetCombCache())
    assert bv.mode[0] == "comb" and bv._service().device == d1  # the service's threads launch on cuda:1
    for k, m, s in zip(keys, msgs, sigs):
        bv.add(k.pub_key().data, m, s)
    ok, res = bv.verify()
    assert not ok and res == [i != 5 for i in range(40)]
    leaves = [rng.bytes(64) for _ in range(1001)]
    assert cm.hash_from_byte_slices(leaves, device=d1) == cm.hash_from_byte_slices(leaves, device=False)
    assert torch.cuda.current_device() == 0


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


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 31, 32, 33, 4_097])
def test_k10_row_edges_match_plain_and_host(dev, n):
    """K10 at row counts on the edges of its warps (16 pairs) and blocks
    (32 rows): rows of 1-3 active blocks with stale bytes past each row's
    last block and every 7th row at active = 0."""
    import torch_sha_corpus as SC

    from cometbft_tpu_torch.ops import keccak as K

    assert 32 // K.THREADS_PER_ROW == 16 and K.ROWS_PER_BLOCK == 32
    msgs, blocks, active = SC.stale_rows_keccak(np.random.default_rng(100 + n), n, 3)
    b, a = torch.from_numpy(blocks).to(dev), torch.from_numpy(active).to(dev)
    got = K.keccak256_blocks(b, a)
    assert torch.equal(got, K.keccak256_blocks_plain(b, a))
    assert [bytes(r) for r in got.cpu().numpy()] == SC.digests_keccak(msgs, active)


def test_k10_rows_of_no_blocks(dev):
    """Rows of no blocks hash nothing: zeros, as the plain version gives,
    with no launch of K10 (which reads every row's first block)."""
    from cometbft_tpu_torch.ops import keccak as K

    b = torch.zeros((5, 0, K.RATE), dtype=torch.uint8, device=dev)
    a = torch.ones((5,), dtype=torch.int32, device=dev)
    before = K.LAUNCHES["keccak256_blocks"]
    got = K.keccak256_blocks(b, a)
    assert K.LAUNCHES["keccak256_blocks"] == before
    assert torch.equal(got, K.keccak256_blocks_plain(b, a)) and not got.any()


def test_k10_at_the_secp_lanes_shape(dev):
    """K10 at the secp lane's shape: 4,096 rows of 2 blocks, 1,371 of them
    at active = 0 (zeros), against the plain version and the host Keccak."""
    from cometbft_tpu_torch.crypto.keccak import keccak256
    from cometbft_tpu_torch.ops import keccak as K

    rng = np.random.default_rng(4096)
    msgs = [rng.bytes(256) for _ in range(4096)]
    blocks, active = K.pad_messages_keccak(msgs)
    active[rng.permutation(4096)[:1371]] = 0
    b, a = torch.from_numpy(blocks).to(dev), torch.from_numpy(active).to(dev)
    got = K.keccak256_blocks(b, a)
    assert torch.equal(got, K.keccak256_blocks_plain(b, a))
    assert [bytes(r) for r in got.cpu().numpy()] == [keccak256(m) if x else bytes(32) for m, x in zip(msgs, active)]


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


def _k15_cases():
    import torch_bls_corpus as C

    return ([("mixed", n) for n in C.EDGE_SIZES] + [("small", 12), ("small", 33), ("prefail", 9),
                                                      ("valid", 40)])


@pytest.mark.parametrize("mode,n", _k15_cases())
def test_k15_block_edges_and_small_order_match_plain_and_k13(dev, mode, n):
    """K15 on block-edge batches of 1-33 rows with every failing class at
    the first and last row of each group of 8 and each tile's last, on
    rows of order 3 and 11 (equal, opposite and infinite operands
    mid-ladder), on batches that all fail before the ladder, and on valid
    rows: ok bytes over a poisoned buffer equal the corpus's, K13's and
    the plain version's, the all-ok byte and the triple the plain
    version's word for word."""
    import torch_bls_corpus as C

    from cometbft_tpu_torch.ops import bls381 as B

    b = C.batch(n, 11 + n, mode)
    Xd, Yd, vd = (torch.from_numpy(a).to(dev) for a in C.pack(b))
    ok = torch.full((n,), 0xAA, dtype=torch.uint8, device=dev)
    all_ok = torch.ones((1,), dtype=torch.uint8, device=dev)
    triple = torch.empty((B.PT_WORDS,), dtype=torch.int32, device=dev)
    before = B.LAUNCHES["validate_aggregate_g1"]
    B.launch_k15(Xd, Yd, vd.to(torch.uint8), ok, all_ok, B._scratch(n, dev), triple)
    torch.cuda.synchronize()
    assert B.LAUNCHES["validate_aggregate_g1"] == before + 1
    assert ok.tolist() == [int(e) for e in b["expect"]]
    assert torch.equal(ok.bool(), B.validate_g1(Xd, Yd, vd))
    plain = B.validate_aggregate_g1_plain(Xd, Yd, vd)
    assert torch.equal(ok.bool(), plain[0]) and int(all_ok) == int(all(b["expect"]))
    got = (triple[:B.NWORDS], triple[B.NWORDS : 2 * B.NWORDS], triple[2 * B.NWORDS :])
    assert all(torch.equal(g, p) for g, p in zip(got, plain[1:]))


@pytest.mark.parametrize("n", [1, 33, 8200, 313 * 32 + 1, 10_000])
def test_k14_matches_plain_and_host(dev, n):
    """K14 at 1 row, a tile and a row, 257 tile partials (the finishing
    stage's fold), 314 (a fold beyond the 10,000 rows' 313) and the main
    path's 10,000 rows, with identity rows and a point beside its
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


BLS_FIELD_PROBE = r"""
#include <cuda_runtime.h>

#include "bls381.cuh"

// row i: fe_mul(a, b), fe_sq(a), fe_add(a, b), fe_sub(a, b)
__global__ void field_kernel(const u32* A, const u32* Bw, u32* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const fe a = fe_ld(A + BLS_W * i), b = fe_ld(Bw + BLS_W * i);
  u32* o = out + 4 * BLS_W * i;
  fe_copy(o, fe_mul(a, b).w);
  fe_copy(o + BLS_W, fe_sq(a).w);
  fe_copy(o + 2 * BLS_W, fe_add(a, b).w);
  fe_copy(o + 3 * BLS_W, fe_sub(a, b).w);
}

extern "C" int field_run(const void* A, const void* Bw, void* out, int n) {
  field_kernel<<<(n + 63) / 64, 64>>>((const u32*)A, (const u32*)Bw, (u32*)out, n);
  return (int)cudaGetLastError();
}
"""


def test_bls_field_device_form_matches_plain_at_edges(dev, tmp_path):
    """bls381.cuh's field routines as nvcc builds them (the card's form:
    fe_mulhi is mul.hi there) on every pair of the range's edge values
    and seeded random pairs: fe_mul and fe_sq equal the plain multiply
    (ops/bls381.mul) and Python integers, fe_add and fe_sub Python's."""
    import ctypes
    import os
    import subprocess

    import torch_bls_corpus as C

    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch.ops import bls381 as B

    src, lib_path = tmp_path / "field.cu", tmp_path / "libfield.so"
    src.write_text(BLS_FIELD_PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(os.fspath(lib_path))
    lib.field_run.argtypes, lib.field_run.restype = [ctypes.c_void_p] * 3 + [ctypes.c_int], ctypes.c_int
    xs, ys = C.field_pairs(29)
    a, b = (torch.from_numpy(B.ints_to_words_np(v)) for v in (xs, ys))
    out = torch.empty((len(xs), 4 * B.NWORDS), dtype=torch.int32, device=dev)
    ad, bd = a.to(dev), b.to(dev)
    assert lib.field_run(ad.data_ptr(), bd.data_ptr(), out.data_ptr(), len(xs)) == 0
    torch.cuda.synchronize()
    got = out.cpu()
    assert torch.equal(got[:, :B.NWORDS], B.mul(a, b))
    assert torch.equal(got[:, B.NWORDS:2 * B.NWORDS], B.mul(a, a))
    P, RI = B.P, pow(B.R_MONT, -1, B.P)
    want = [[x * y * RI % P, x * x * RI % P, (x + y) % P, (x - y) % P] for x, y in zip(xs, ys)]
    assert [B.words_to_ints(got[i].view(4, B.NWORDS)) for i in range(len(xs))] == want


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


def test_sharded_comb_path_at_world_1_matches_one_device(dev, nccl_mesh, svc_stop):
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
    assert guard["routes"] == ["plain", "comb"]
    assert guard["results"][0] == guard["results"][1] == got["tampered"]


# ------------------------------------------------- the verify service (chip_smoke phase 24, small)


def _counts():
    from cometbft_tpu_torch.ops import comb, sha2
    from cometbft_tpu_torch.ops import ed25519 as E
    from cometbft_tpu_torch.ops import keccak as K
    from cometbft_tpu_torch.ops import merkle as M
    from cometbft_tpu_torch.ops import secp256k1 as S

    return {k: v for d in (sha2.LAUNCHES, comb.LAUNCHES, E.LAUNCHES, M.LAUNCHES, K.LAUNCHES, S.LAUNCHES)
            for k, v in d.items()}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def test_service_commit_launches_k1_k2_k4_once(dev, svc_stop, monkeypatch):
    """verify_commit through the verify service on the card: each call K1,
    K2 and K4 once and K5 never, from the service's threads; the planted
    commit blamed on its index; the service's tallies count one consensus
    batch a call and no refusal."""
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.verifysvc import global_service
    from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE, Timestamp

    monkeypatch.setenv("COMETBFT_TPU_COMB_MIN", "2")
    monkeypatch.setenv("COMETBFT_TPU_COMB_ASYNC_MIN", "100000")
    rng = np.random.default_rng(24)
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(70)]
    vals = T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in keys])
    by_addr = {k.pub_key().address(): k for k in keys}
    bid = T.BlockID(hash=rng.bytes(32), part_set_header=T.PartSetHeader(total=1, hash=rng.bytes(32)))
    sigs = []
    for i, v in enumerate(vals.validators):
        vote = T.Vote(type=PRECOMMIT_TYPE, height=9, round=0, block_id=bid, timestamp=Timestamp(seconds=1, nanos=i),
                      validator_address=v.address, validator_index=i)
        vote.signature = by_addr[v.address].sign(vote.sign_bytes("c"))
        sigs.append(vote.to_commit_sig())
    good = T.Commit(height=9, round=0, block_id=bid, signatures=sigs)
    bad = list(sigs)
    bad[33] = T.CommitSig(sigs[33].block_id_flag, sigs[33].validator_address, sigs[33].timestamp,
                          sigs[33].signature[:-1] + bytes([sigs[33].signature[-1] ^ 1]))
    faulted = T.Commit(height=9, round=0, block_id=bid, signatures=bad)
    cache = cv.ValsetCombCache()
    cache.ensure(vals.pub_keys_bytes(), device=dev)
    svc = global_service(dev)
    before, stats0 = _counts(), svc.stats()
    for _ in range(3):
        validation.verify_commit("c", vals, bid, 9, good, device=dev, comb_cache=cache)
    with pytest.raises(validation.CommitVerificationError, match=r"\(#33\)"):
        validation.verify_commit("c", vals, bid, 9, faulted, device=dev, comb_cache=cache)
    assert _delta(before) == {"parse_verify_payload": 4, "sha512_blocks": 4, "verify_cached": 4}
    stats = svc.stats()
    assert stats["dispatched_batches"]["consensus"] - stats0["dispatched_batches"]["consensus"] == 4
    assert not any(stats["rejected"].values()) and stats["device"] == str(svc.device)


def _secp_txs(n):
    from cometbft_tpu_torch.crypto import secp256k1 as hs
    from cometbft_tpu_torch.crypto import secp256k1eth as he
    from cometbft_tpu_torch.verifysvc import checktx

    signers = [hs.PrivKey.from_seed(b"svc-c"), he.PrivKey.from_seed(b"svc-e"), he.RecoverPrivKey.from_seed(b"svc-r")]
    txs = []
    for i in range(n):
        tx = checktx.make_signed_tx(signers[i % 3], b"checktx %d" % i)
        txs.append(tx[:-1] + bytes([tx[-1] ^ 1]) if i % 17 == 5 else tx)
    return txs


def _host_verdict(tx):
    from cometbft_tpu_torch.models import secp_verifier as sv
    from cometbft_tpu_torch.verifysvc import checktx

    _, pub, sig, payload = checktx.parse_signed_tx(tx)
    return sv._host_verify_one(pub, checktx.SIGN_DOMAIN + payload, sig)


def _send(txs, senders, **kw):
    """Each tx through verify_tx_signature, one a call, ``senders``
    threads -> verdicts in tx order."""
    import threading

    from cometbft_tpu_torch.verifysvc import checktx

    got = [None] * len(txs)

    def run(k):
        for i in range(k, len(txs), senders):
            got[i] = checktx.verify_tx_signature(txs[i], **kw)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(senders)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    return got


def test_service_checktx_flood_merges_on_the_card(dev, svc_stop):
    """384 CheckTx envelopes of the three secp shapes, one tx a call from
    16 threads: MEMPOOL batches of several rows, one secp kernel launch a
    batch, every verdict the host oracle's, no refusal."""
    from cometbft_tpu_torch.ops import secp256k1 as S
    from cometbft_tpu_torch.verifysvc import global_service

    txs = _secp_txs(384)
    svc = global_service(dev)
    before, stats0 = _counts(), svc.stats()
    got = _send(txs, 16, service=svc)
    stats = svc.stats()
    batches = stats["dispatched_batches"]["mempool"] - stats0["dispatched_batches"]["mempool"]
    delta = _delta(before)
    assert got == [_host_verdict(tx) for tx in txs] and got.count(False) == len(range(5, 384, 17))
    assert sum(v for k, v in delta.items() if k in S.LAUNCHES) == batches and batches * 4 <= len(txs)
    assert not any(stats["rejected"].values())


def test_service_tenant_quota_on_the_card(dev):
    """Two tenants flood MEMPOOL under a tenant quota of 4: the rogue
    tenant's 12 senders are refused (and checked on the host), the
    victim's 2 never; every verdict the host oracle's."""
    from cometbft_tpu_torch.verifysvc import VerifyService

    txs = _secp_txs(96)
    svc = VerifyService(tenant_quota=4, device=dev)
    try:
        rogue = _send(txs[:72], 12, service=svc, tenant="rogue")
        victim = _send(txs[72:], 2, service=svc, tenant="victim")
        tallies = svc.stats()["tenants"]
    finally:
        svc.stop()
    assert rogue + victim == [_host_verdict(tx) for tx in txs]
    assert tallies["rogue"]["rejected"] > 0 and tallies["victim"]["rejected"] == 0


def test_service_proof_requests_on_the_card(dev, svc_stop):
    """Proof requests of 64 queries from 4 threads under PROOF over a
    1,000-leaf tree: merged dispatches, K7, K8 and K9 once a dispatch,
    every proof equal to proofs_from_byte_slices's."""
    import threading

    from cometbft_tpu_torch.crypto import merkle as cm
    from cometbft_tpu_torch.models import proof_server
    from cometbft_tpu_torch.verifysvc import MODE_PROOF, Klass, ServiceBatchVerifier, global_service

    rng = np.random.default_rng(31)
    leaves = [rng.bytes(64) for _ in range(1000)]
    _, proofs = cm.proofs_from_byte_slices(leaves)
    tree = proof_server.register_tree(leaves)
    svc = global_service(dev)
    reqs = [list(range(j, min(j + 64, 1000))) for j in range(0, 1000, 64)]
    bad = []

    def run(k):
        for r in reqs[k::4]:
            bv = ServiceBatchVerifier(Klass.PROOF, MODE_PROOF, service=svc)
            for i in r:
                bv.add(*proof_server.encode_query(tree, i))
            ok, rows = bv.verify()
            if not ok or rows != [proofs[i] for i in r]:
                bad.append(r[0])

    before, stats0 = _counts(), svc.stats()
    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    n = svc.stats()["dispatched_batches"]["proof"] - stats0["dispatched_batches"]["proof"]
    assert not bad and 1 <= n <= len(reqs)
    assert _delta(before) == {"sha256_blocks": n, "merkle_tree": n, "merkle_gather": n}


def _stream_case(n, seed, blocks=6):
    """n keys and ``blocks`` commits of theirs: block 2 with a flipped
    message byte at row 3, block 4 (when there is one) with only the first
    half of the rows and block 5 with a foreign key appended."""
    from cometbft_tpu_torch.crypto import ed25519 as host

    rng = np.random.default_rng(seed)
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(n + 1)]
    pubs = [k.pub_key().data for k in keys]
    commits = []
    for b in range(blocks):
        items = []
        for i in range(n):
            m = b"block-%d-row-%d-" % (b, i) + rng.bytes(int(rng.integers(60, 70)))
            s = keys[i].sign(m)
            items.append((pubs[i], m + (b"!" if (b, i) == (2, 3) else b""), s))
        commits.append(items)
    if blocks > 4:
        commits[4] = commits[4][: n // 2]
    if blocks > 5:
        commits[5] = commits[5] + [(pubs[n], b"alien", keys[n].sign(b"alien"))]
    return pubs[:n], commits


def test_staging_thread_on_the_card(dev, svc_stop):
    """Comb batches on the card submitted from four threads: every
    submit returns before its fill, the fills, copies and launches run on
    the staging thread (K1, K2, K4 once a batch), every verdict is the
    host oracle's, and the slabs go back to the entry's pool."""
    import threading

    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.models.verifier import CpuEd25519BatchVerifier
    from cometbft_tpu_torch.ops import comb, sha2

    pubs, commits = _stream_case(300, 41, blocks=4)
    entry = cv.ValsetCombCache().ensure(pubs, device=dev)
    where, out = [], {}
    real_fill = cv._fill_payload

    def spy(slab, items, rows):
        where.append(threading.current_thread().name)
        return real_fill(slab, items, rows)

    def run(b):
        bv = cv.CombBatchVerifier(entry)
        for it in commits[b]:
            bv.add(*it)
        ticket = bv.submit()
        out[b] = bv.collect(ticket)

    before = (sha2.LAUNCHES["parse_verify_payload"], comb.LAUNCHES["verify_cached"])
    cv._fill_payload = spy
    try:
        threads = [threading.Thread(target=run, args=(b,)) for b in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        cv._fill_payload = real_fill
    for b in range(4):
        host = CpuEd25519BatchVerifier()
        host._items = list(commits[b])
        assert out[b] == host.verify()
    assert set(where) == {"comb-stage_0"} and len(where) == 4
    assert (sha2.LAUNCHES["parse_verify_payload"] - before[0], comb.LAUNCHES["verify_cached"] - before[1]) == (4, 4)
    assert 1 <= len(entry._slabs[cv._payload_width(commits[0])]) <= 2


def test_staging_thread_launches_on_a_second_card(dev, svc_stop):
    """A comb entry on cuda:1 while cuda:0 is current: the staging
    thread's copy, launches and event go to cuda:1, verdicts equal the
    host's.  Needs two cards; skips on one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the stage runs on cuda:1 while cuda:0 is current")
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.models.verifier import CpuEd25519BatchVerifier

    torch.cuda.set_device(0)
    pubs, commits = _stream_case(70, 43, blocks=3)
    entry = cv.ValsetCombCache().ensure(pubs, device=torch.device("cuda", 1))
    assert entry.device == torch.device("cuda", 1)
    for items in commits:
        bv = cv.CombBatchVerifier(entry)
        for it in items:
            bv.add(*it)
        host = CpuEd25519BatchVerifier()
        host._items = list(items)
        assert bv.verify() == host.verify()
    assert torch.cuda.current_device() == 0


def test_commit_stream_depth_2_equals_depth_1_on_the_card(dev, svc_stop):
    """CommitStreamVerifier over six commits of a 512-validator set (a
    tampered row, a half commit, a foreign key's demotion) at depth 1 and
    2: bit for bit the same verdicts, equal to the host oracle's."""
    from cometbft_tpu_torch.blocksync import CommitStreamVerifier
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.models.verifier import CpuEd25519BatchVerifier

    pubs, commits = _stream_case(512, 47)
    entry = cv.ValsetCombCache().ensure(pubs, device=dev)
    runs = {d: list(CommitStreamVerifier(entry, depth=d).run(commits)) for d in (1, 2)}
    want = []
    for items in commits:
        host = CpuEd25519BatchVerifier()
        host._items = list(items)
        want.append(host.verify())
    assert runs[1] == runs[2] == want
    assert not want[2][0] and want[2][1].count(False) == 1


def test_prove_on_the_card(dev, svc_stop):
    """models/proof_server.prove over a 1,000-leaf tree through the
    global service of the card: 200 queries (K7 -> K8 -> K9), the root
    and every proof equal to proofs_from_byte_slices's."""
    from cometbft_tpu_torch.crypto import merkle as cm
    from cometbft_tpu_torch.models import proof_server

    rng = np.random.default_rng(53)
    leaves = [rng.bytes(64) for _ in range(1000)]
    idx = rng.permutation(1000)[:200].tolist()
    root, proofs = cm.proofs_from_byte_slices(leaves)
    before = _counts()
    got_root, got = proof_server.prove(leaves, idx, device=dev)
    assert got_root == root and got == [proofs[i] for i in idx]
    assert _delta(before) == {"sha256_blocks": 1, "merkle_tree": 1, "merkle_gather": 1}
