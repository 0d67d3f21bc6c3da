"""Chip smoke test of the PyTorch/CUDA port: drives the port's paths —
ed25519 VerifyCommit over a 10,000-validator commit through the
comb-cached kernels, the uncached (Straus) verifier at the same width, a
validator-set change with its background churn build, a light-client
trusting check on 150 validators, the comb verifier's demotion, the
light client's header checks at 10,000 validators (validator-set hash on
the Merkle kernels, then the commit), and batched Merkle proof serving
over a 16,384-leaf tree — on one NVIDIA card, holds each kernel against
its plain PyTorch version, and prints the card's numbers.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero).
Every path is driven with every kernel launch count zeroed just before
it and read just after it.
  1. device and build: the card's name and power limit, the nvcc build of
     every kernel source with its -Xptxas -v register and spill counts;
  2. the comb path: the set's table build (a synchronous ensure, as
     bench.py forces), verify_commit on a good commit and on a commit
     with planted faults (blame on the first planted index).  The commit
     is that of a real Header whose validators_hash and
     next_validators_hash are the set's hash (K7 + K8 on the card);
  3. K1-K4 against their plain versions at the comb path's shapes
     (byte-exact), the planted commit's bitmap against the plain version
     on every row and the host oracle on the planted rows plus 256
     sampled rows;
  4. times of the comb path: the table build, verify_commit p50 with the
     verifier's phase timings (K4 and no K5 launched), each kernel and
     its plain version by CUDA events, peak device memory;
  5. the uncached path: the commit's 10,000 items with the planted faults
     through the Straus verifier (16,384 lanes), K5 against its plain
     version on every lane and the host oracle on the planted rows plus
     256 sampled rows, p50 over 10 calls, K5's time;
  6. a validator-set change: 100 of the 10,000 keys replaced; the first
     verify_commit runs uncached (K5, no K4) and starts the background
     churn build (K3 on a 128-key bucket, then K6); its tables against a
     full K3 build; the next verify_commit runs K4; K6 against its plain
     version and index_copy_, timed;
  7. verify_commit_light_trusting (trust 1/3) on a 150-validator set:
     K2 -> K5 at 256 lanes, p50, K5's time at 256 lanes;
  8. demotion: comb batches with a foreign key and with a duplicate key
     against the host oracle;
  9. the light client at 10,000 validators, tables warm and the set's
     hash memo dropped before each call: ValidatorSet.hash (K7 once, K8
     once per level) against hashlib, verify_adjacent and
     verify_non_adjacent (trust 1/3; then the comb kernels), a header
     with a flipped validators_hash refused; p50s;
 10. proof serving over 16,384 leaves of 64 bytes, every leaf queried:
     ProofProver (K7, K8 per level, one K9) and device_multiproof, every
     proof equal to proofs_from_byte_slices's byte for byte; p50s and
     the multiproof's dedup factor;
 11. K7-K9 against their plain versions (byte-exact) — K7 on rows of 1-3
     active blocks with stale bytes, K8 on every level of both trees, K9
     with -1 coordinates — and their times, K9 beside index_select;
 12. one JSON line with every kernel, then the contract line.

Needs one CUDA card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np
import torch

V_MAIN = 10_000  # validators on the main path
V_K3_PARITY = 1_024  # K3 against its plain version
N_CHURN = 100  # validators replaced in the set change (1%)
V_LIGHT = 150  # the light client's trusted set
N_LEAVES = 16_384  # proof tree: a full block's txs (4 MiB of 256-byte txs)
LEAF_BYTES = 64  # bench.py's proof-serving leaves
NS = 1_000_000_000
TRUSTING_PERIOD_NS = 14 * 24 * 3600 * NS
MAXM = 128  # payload message bucket of the 125- and 126-byte vote sign-bytes
CHAIN_ID = "cometbft-tpu-torch-smoke"
SEED = 20261017
# planted faults: a flipped message byte, s >= L, an undecodable R; absent rows
I_FLIP, I_S_GE_L, I_BAD_R = 4_321, 777, 9_999
ABSENT = [12, 5_000, 8_888]
N_ORACLE_SAMPLE = 256
# Each precommit carries its signer's own clock: one second for the whole
# commit, nanoseconds uniform in [0, 1e9) from SEED.  Nanos below 2^28
# encode as a 4-byte varint and the rest as 5 bytes, so the commit's
# sign-bytes come in two lengths, as in a real commit.
TS_SECONDS = 1_760_000_000
# Timed launches and warm-up launches before them, per kernel: (kernel
# iters, kernel warm-up, plain iters, plain warm-up).  The plain K3 runs
# once, cold, and its tables are held against the main path's.
TIMING = {
    "parse_verify_payload": (50, 2, 5, 1),
    "sha512_blocks": (20, 2, 2, 1),
    "build_a_tables": (5, 2, 1, 0),
    "verify_cached": (10, 2, 1, 1),
    "verify_batch": (10, 2, 1, 0),  # at 16,384 lanes (the plain version once, cold)
    "verify_batch_256": (20, 2, 2, 1),  # at the light client's 256 lanes
    "assemble_churn": (20, 2, 2, 1),
    "sha256_blocks": (50, 2, 5, 1),  # at the proof tree's 16,384 leaves
    "merkle_level": (20, 2, 2, 1),  # one tree: all 14 levels of the proof tree
    "merkle_gather": (50, 2, 5, 1),  # the proofs' 16,384 x 15 coordinates
}

# The card's peaks (NVIDIA H100 SXM data sheet, at a 700 W power limit):
# HBM3 bandwidth, and int32 operations at half the 67 TFLOP/s float32
# rate (64 INT32 lanes per SM per clock against 128 FP32 lanes; a
# multiply-add counts as 2 operations, as an FMA does).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# Operation counts used for the bounds: a 32x32->64 multiply-add is two
# 32-bit multiply-adds (4 operations); a field multiply is 100 of them.
OPS_PER_FIELD_MUL = 100 * 4
OPS_PER_SHA512_BLOCK = 5_000  # 80 rounds + 64 schedule steps of ~2,500 64-bit ops, x2 for 32-bit
FIELD_MULS_PER_TABLE = 270 + 64 * (7 * 9 + 8) + 512 + 265 + 512 * 6  # K3, per validator
FIELD_MULS_PER_VERIFY = 270 + 86 * 7 + 9 + 3 * 8  # K4, per lane
# K5, per lane: two decompressions, the -A table (8 conversions, 1
# doubling, 6 cached adds), 64 steps of 4 doublings + a cached add + a
# mixed add, then -R and 3 doublings
FIELD_MULS_PER_STRAUS = 2 * 270 + (8 + 8 + 6 * 8) + 64 * (4 * 8 + 8 + 7) + 9 + 3 * 8
A_ROW_BYTES = 64 * 8 * 3 * 8 * 4  # one validator's comb table
OPS_PER_SCALAR_REDUCE = (81 + 45) * 4  # K4 Barrett word products, per lane
# SHA-256, per block, counted from csrc/sha256.cuh: 64 rounds of 26 word
# operations, 48 schedule words of 13, 8 state adds
OPS_PER_SHA256_BLOCK = 64 * 26 + 48 * 13 + 8


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean time of fn() on the card by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64).cpu() - b.to(torch.int64).cpu()).abs().max().item())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch import light
    from cometbft_tpu_torch.crypto import _ref25519 as ref
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.crypto import merkle as cmerkle
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.models import proof_server
    from cometbft_tpu_torch.models.verifier import (
        CpuEd25519BatchVerifier, Ed25519BatchVerifier, stage_batch,
    )
    from cometbft_tpu_torch.ops import comb, sha2
    from cometbft_tpu_torch.ops import merkle as Mk
    from cometbft_tpu_torch.ops import ed25519 as E
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE, Timestamp

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    t_start = time.perf_counter()
    counters = (sha2.LAUNCHES, comb.LAUNCHES, E.LAUNCHES, cv.LAUNCHES, Mk.LAUNCHES)
    path_launches = {}  # path -> launches read just after it

    def zero_counts():
        for d in counters:
            for k in d:
                d[k] = 0

    def read_counts(path=None):
        got = {k: v for d in counters for k, v in d.items()}
        if path is not None:
            path_launches[path] = got
        return got

    # ---------------------------------------------------- 1. device, build
    log(f"[1] device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[1] build: {time.perf_counter() - t0:.1f} s (all sources in parallel)")
    for name, rec in sorted(_build.BUILD_LOG.items()):
        how = "cached library, its build's ptxas report" if rec["cached"] else f"{rec['seconds']:.1f} s"
        log(f"[1]   {name}.cu: {how}")
        for line in rec["ptxas"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[1]     {line.strip()}")

    # ------------------------------------------------------- inputs
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    seeds = [rng.bytes(32) for _ in range(V_MAIN)]
    keys = [host.PrivKey.from_seed(s) for s in seeds]
    vals = T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in keys])
    by_addr = {k.pub_key().address(): k for k in keys}
    height = 1_000_000
    vals_hash = vals.hash(device=dev)  # K7 + K8 on the card

    def header_at(h, seconds, next_hash=vals_hash):
        return T.Header(
            chain_id=CHAIN_ID, height=h, time=Timestamp(seconds=seconds, nanos=0),
            last_block_id=T.BlockID(hash=rng.bytes(32), part_set_header=T.PartSetHeader(1, rng.bytes(32))),
            last_commit_hash=rng.bytes(32), data_hash=rng.bytes(32), validators_hash=vals_hash,
            next_validators_hash=next_hash, consensus_hash=rng.bytes(32), app_hash=rng.bytes(32),
            last_results_hash=rng.bytes(32), evidence_hash=rng.bytes(32),
            proposer_address=vals.get_proposer().address,
        )

    # the block's header: its hash is what the commit signs
    hdr = header_at(height, TS_SECONDS - 1)
    bid = T.BlockID(hash=hdr.hash(), part_set_header=T.PartSetHeader(total=3, hash=rng.bytes(32)))
    nanos = rng.integers(0, 1_000_000_000, size=V_MAIN)
    sigs = []
    for i, v in enumerate(vals.validators):
        vote = T.Vote(
            type=PRECOMMIT_TYPE, height=height, round=0, block_id=bid,
            timestamp=Timestamp(seconds=TS_SECONDS, nanos=int(nanos[i])),
            validator_address=v.address, validator_index=i,
        )
        vote.signature = by_addr[v.address].sign(vote.sign_bytes(CHAIN_ID))
        sigs.append(vote.to_commit_sig())
    good = T.Commit(height=height, round=0, block_id=bid, signatures=sigs)
    sb_good = good.vote_sign_bytes_fn(CHAIN_ID)
    lens, counts = np.unique([len(sb_good(i)) for i in range(V_MAIN)], return_counts=True)
    log(f"[inputs] {V_MAIN} keys and signatures in {time.perf_counter() - t0:.1f} s "
        f"(host ed25519, seed {SEED}); sign-bytes lengths "
        + ", ".join(f"{n} rows of {ln} B" for ln, n in zip(lens.tolist(), counts.tolist())))
    require(len(lens) > 1, "one sign-bytes length only: the fill's mixed-length path is not driven")

    # the planted commit: flipped message byte (a timestamp the signer
    # never signed), s >= L, an undecodable R, and a few absent rows
    off_curve = next(
        y.to_bytes(32, "little") for y in range(2, 1000)
        if ref.decompress(y.to_bytes(32, "little")) is None
    )
    planted = [I_FLIP, I_S_GE_L, I_BAD_R]
    fsigs = list(sigs)
    for i in planted:
        cs = sigs[i]
        if i == I_FLIP:  # the low bit of the nanos: a byte the signer never signed
            t2 = Timestamp(seconds=cs.timestamp.seconds, nanos=cs.timestamp.nanos ^ 1)
            fsigs[i] = T.CommitSig(cs.block_id_flag, cs.validator_address, t2, cs.signature)
        elif i == I_S_GE_L:
            s = int.from_bytes(cs.signature[32:], "little") + ref.L
            fsigs[i] = T.CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp,
                                   cs.signature[:32] + s.to_bytes(32, "little"))
        else:
            fsigs[i] = T.CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp,
                                   off_curve + cs.signature[32:])
    absent = list(ABSENT)
    for i in absent:
        fsigs[i] = T.CommitSig.absent()
    faulted = T.Commit(height=height, round=0, block_id=bid, signatures=fsigs)
    first_bad = min(planted)

    # ---------------------------------------------------- 2. comb path
    # A set of 10,000 routes to a background table build and verifies
    # uncached until it lands (phase 6 drives that); here the tables are
    # built synchronously first, as bench.py forces, so both calls take
    # the warm comb path.
    torch.cuda.reset_peak_memory_stats()
    cache = cv.ValsetCombCache()
    zero_counts()
    t0 = time.perf_counter()
    cache.ensure(vals.pub_keys_bytes(), device=dev)
    validation.verify_commit(CHAIN_ID, vals, bid, height, good, device="cuda", comb_cache=cache)
    t_first = time.perf_counter() - t0
    try:
        validation.verify_commit(CHAIN_ID, vals, bid, height, faulted, device="cuda", comb_cache=cache)
    except validation.CommitVerificationError as e:
        blame = str(e)
    else:
        raise AssertionError("the planted commit verified")
    launches = read_counts("comb")
    log(f"[2] comb path: good commit verified ({t_first:.2f} s incl. the table build "
        f"of {cache.last_build_ms:.1f} ms); planted commit raised: {blame[:60]}...")
    log(f"[2] launches on the comb path: {launches}")
    require(blame.startswith(f"wrong signature (#{first_bad}):"), f"blame {blame!r} != #{first_bad}")
    comb_path = ("parse_verify_payload", "sha512_blocks", "build_a_tables", "verify_cached")
    require(all(launches[k] > 0 for k in comb_path), f"a kernel of the path never launched: {launches}")
    require(launches["verify_batch"] == 0 and launches["assemble_churn"] == 0,
            f"the warm comb path launched K5 or K6: {launches}")
    peak = torch.cuda.max_memory_allocated()

    # ---------------------------------------------------- 3. parity
    entry = cache.ensure(vals.pub_keys_bytes(), device=dev)
    sign_bytes_at = faulted.vote_sign_bytes_fn(CHAIN_ID)
    items, rows = [], []
    for i, cs in enumerate(faulted.signatures):
        if cs.absent_flag():
            continue
        items.append((vals.validators[i].pub_key.bytes(), sign_bytes_at(i), cs.signature))
        rows.append(i)
    bv = cv.CombBatchVerifier(entry)
    for p, m, s in items:
        bv.add(p, m, s)
    all_ok, per = bv.verify()
    require(not all_ok, "planted batch reported all ok")
    payload_np = cv.assemble_payload(items, np.asarray(rows), entry.vpad)
    require(payload_np.shape[1] == 68 + MAXM, f"payload width {payload_np.shape[1]}")
    payload = torch.from_numpy(payload_np).to(dev)

    results = {}
    # K1 and K2 on a mixed-mlen payload with non-live rows and stale bytes
    mixed = rng.integers(0, 256, size=(V_MAIN, 68 + MAXM), dtype=np.uint8)
    mlen = rng.integers(0, MAXM + 1, size=V_MAIN)
    mlen[:8] = [0, 31, 32, 47, 48, 110, 128, 64]
    mixed[:, 64], mixed[:, 65], mixed[:, 66] = mlen & 0xFF, mlen >> 8, 0
    mixed[:, 67] = (rng.random(V_MAIN) > 0.05).astype(np.uint8)
    mixed_t = torch.from_numpy(mixed).to(dev)
    _, _, blk_k, act_k, _ = sha2.parse_verify_payload(mixed_t, entry.pubs)
    blk_p, act_p = sha2.parse_verify_payload_plain(mixed_t, entry.pubs)
    torch.cuda.synchronize()
    require(torch.equal(blk_k, blk_p) and torch.equal(act_k, act_p), "K1 != plain")
    results["parse_verify_payload"] = max(max_abs_err(blk_k, blk_p), max_abs_err(act_k, act_p))
    dig_k = sha2.sha512_blocks(blk_k, act_k)
    dig_p = sha2.sha512_blocks_plain(blk_k, act_k)
    torch.cuda.synchronize()
    require(torch.equal(dig_k, dig_p), "K2 != plain")
    results["sha512_blocks"] = max_abs_err(dig_k, dig_p)
    log(f"[3] K1, K2 == plain at V={V_MAIN}, maxm={MAXM} (active blocks "
        f"{int(act_k.sum())}, non-live {int((mixed[:, 67] == 0).sum())})")

    # K3 on 1,024 keys with an off-curve and a non-canonical-y key
    k3_pubs = entry.pubs[:V_K3_PARITY].clone()
    k3_pubs[5] = torch.frombuffer(bytearray(off_curve), dtype=torch.uint8).to(dev)
    noncanon = next(
        (ref.P + d).to_bytes(32, "little") for d in range(19)
        if ref.decompress((ref.P + d).to_bytes(32, "little")) is not None
    )
    k3_pubs[6] = torch.frombuffer(bytearray(noncanon), dtype=torch.uint8).to(dev)
    tab_k, val_k = comb.build_a_tables(k3_pubs)
    tab_p, val_p = comb.build_a_tables_plain(k3_pubs)
    torch.cuda.synchronize()
    require(torch.equal(tab_k, tab_p) and torch.equal(val_k, val_p), "K3 != plain")
    require(not bool(val_k[5]) and bool(val_k[6]), "K3 validity of the planted keys")
    th, vh = comb.build_a_tables_host(k3_pubs[:8].cpu().numpy())
    require(np.array_equal(tab_k[:8].cpu().numpy().view(np.uint32), th), "K3 != host oracle")
    results["build_a_tables"] = max_abs_err(tab_k, tab_p)
    log(f"[3] K3 == plain at V={V_K3_PARITY} (off-curve row invalid, non-canonical-y row "
        "valid); rows 0-7 == host bigint oracle")

    # K4 on the planted commit's payload (all 10,000 rows)
    _, _, blk, act, _ = sha2.parse_verify_payload(payload, entry.pubs)
    digest = sha2.sha512_blocks(blk, act)
    out_k = comb.verify_cached(entry.tables, entry.valid, payload, digest, entry.b_tables)
    ok_p = comb.verify_cached_plain(entry.tables, entry.valid, payload, digest, entry.b_tables)
    out_p = comb.pack_verdicts(ok_p, payload[:, 67] == 1)
    torch.cuda.synchronize()
    require(torch.equal(out_k, out_p), "K4 != plain")
    results["verify_cached"] = max_abs_err(out_k, out_p)
    bitmap = np.unpackbits(out_k[:-1].cpu().numpy(), count=V_MAIN).astype(bool)
    require(bitmap[rows].tolist() == per, "CombBatchVerifier bitmap != kernel bitmap")
    check_rows = sorted(set(planted) | set(rng.choice(rows, N_ORACLE_SAMPLE, replace=False).tolist()))
    oracle = CpuEd25519BatchVerifier()
    for i in check_rows:
        j = rows.index(i)
        oracle.add(*items[j])
    _, oracle_ok = oracle.verify()
    require([bool(bitmap[i]) for i in check_rows] == oracle_ok, "bitmap != host oracle")
    require(all(not bitmap[i] for i in planted) and not any(bitmap[absent]), "planted rows")
    require(int(bitmap.sum()) == V_MAIN - len(planted) - len(absent), "valid-row count")
    log(f"[3] K4 == plain on all {V_MAIN} rows; == host oracle on {len(check_rows)} rows "
        f"(planted {sorted(planted)}, absent {absent})")

    # ---------------------------------------------------- 4. times
    walls, phases = [], []
    zero_counts()
    for _ in range(12):
        t0 = time.perf_counter()
        validation.verify_commit(CHAIN_ID, vals, bid, height, good, device="cuda", comb_cache=cache)
        walls.append((time.perf_counter() - t0) * 1e3)
    timed = read_counts()
    require(timed["verify_cached"] == 12 and timed["verify_batch"] == 0,
            f"the timed calls did not all take the warm comb path: {timed}")
    walls = walls[2:]
    good_items = []
    for i, cs in enumerate(good.signatures):
        good_items.append((vals.validators[i].pub_key.bytes(), sb_good(i), cs.signature))
    for _ in range(12):
        bv = cv.CombBatchVerifier(entry)
        for it in good_items:
            bv.add(*it)
        ok, _ = bv.verify()
        require(ok, "good batch failed")
        phases.append(dict(bv.last_timings))
    phases = phases[2:]
    p50 = float(np.median(walls))
    phase_p50 = {k: float(np.median([p[k] for p in phases])) for k in phases[0]}
    log(f"[4] verify_commit p50 {p50:.2f} ms over {len(walls)} calls "
        f"(min {min(walls):.2f}, max {max(walls):.2f}); CombBatchVerifier phases p50 (ms): "
        + json.dumps({k: round(v, 3) for k, v in phase_p50.items()}))

    good_payload = torch.from_numpy(
        cv.assemble_payload(good_items, np.arange(V_MAIN), entry.vpad)).to(dev)
    nb = sha2.nblocks_for(MAXM)
    blocks = torch.empty((V_MAIN, nb, 128), dtype=torch.uint8, device=dev)
    active = torch.empty((V_MAIN,), dtype=torch.int32, device=dev)
    dig = torch.empty((V_MAIN, 64), dtype=torch.uint8, device=dev)
    out = torch.empty((V_MAIN // 8 + 1,), dtype=torch.uint8, device=dev)
    cnt = torch.empty((2,), dtype=torch.int32, device=dev)
    valid_u8 = entry.valid.to(torch.uint8)
    tabs_scratch = (
        torch.empty((V_MAIN, 64, 8, 3, 8), dtype=torch.int32, device=dev),
        torch.empty((V_MAIN,), dtype=torch.uint8, device=dev),
        torch.empty((V_MAIN, 512, 8), dtype=torch.int32, device=dev),
    )
    lib = _build.lib("comb")

    def k3_launch():
        code = lib.k3_build_a_tables(
            entry.pubs.data_ptr(), tabs_scratch[0].data_ptr(), tabs_scratch[1].data_ptr(),
            tabs_scratch[2].data_ptr(), V_MAIN, torch.cuda.current_stream().cuda_stream)
        _build.check(code, "k3")

    sha2.launch_k1(good_payload, entry.pubs, blocks, active)
    sha2.launch_k2(blocks, active, dig)
    sum_active = int(active.sum())
    launch = {
        "parse_verify_payload": (
            lambda: sha2.launch_k1(good_payload, entry.pubs, blocks, active),
            lambda: sha2.parse_verify_payload_plain(good_payload, entry.pubs),
        ),
        "sha512_blocks": (
            lambda: sha2.launch_k2(blocks, active, dig),
            lambda: sha2.sha512_blocks_plain(blocks, active),
        ),
        "verify_cached": (
            lambda: comb.launch_k4(entry.tables, valid_u8, good_payload, dig, entry.b_tables,
                                   cnt, out),
            lambda: comb.verify_cached_plain(entry.tables, entry.valid, good_payload, dig,
                                             entry.b_tables),
        ),
        "build_a_tables": (k3_launch, None),
    }
    t = {}
    for name, (kern, plain) in launch.items():
        it, wu, pit, pwu = TIMING[name]
        t[name] = (cuda_ms(kern, it, wu), None if plain is None else cuda_ms(plain, pit, pwu))
    # the plain K3 at the main path's V, once, held against the main path's tables
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    tab_p10k, val_p10k = comb.build_a_tables_plain(entry.pubs)
    end.record()
    torch.cuda.synchronize()
    t["build_a_tables"] = (t["build_a_tables"][0], start.elapsed_time(end))
    require(torch.equal(tab_p10k, entry.tables) and torch.equal(val_p10k, entry.valid),
            "main-path tables != plain K3")
    del tab_p10k, val_p10k
    cold_build_ms = cache.last_build_ms
    # a second set in a cache of its own (no churn base): a full, warm K3 build
    second = cv.ValsetCombCache()
    second.ensure(list(reversed(vals.pub_keys_bytes())), device=dev)
    warm_build_ms = second.last_build_ms
    del second
    log(f"[4] table build (V={V_MAIN}, host clock around K3 and a wait on its build stream): "
        f"{cold_build_ms:.1f} ms in the main path (the process's first K3 launch), "
        f"{warm_build_ms:.1f} ms for a second set")
    log(f"[4] peak device memory on the main path: {peak / 2**20:.1f} MiB")

    # ---------------------------------------------------- 5. uncached path
    # the commit's 10,000 items with phase 2's planted faults, through the
    # Straus verifier: 16,384 lanes, padding lanes repeating row 0
    u_items = list(good_items)
    for i in planted:
        u_items[i] = items[rows.index(i)]
    zero_counts()
    ubv = Ed25519BatchVerifier(device=dev)
    for it in u_items:
        ubv.add(*it)
    u_ok, u_per = ubv.verify()
    u_launch = read_counts("uncached")
    log(f"[5] uncached path: {len(u_items)} items, launches {u_launch}")
    require(u_launch["verify_batch"] == 1 and u_launch["sha512_blocks"] == 1
            and u_launch["verify_cached"] == 0, f"uncached path launches {u_launch}")
    ua, ur, us, ublk, uact = stage_batch(u_items, dev)
    lanes = ua.shape[0]
    require(lanes == 16_384, f"bucket {lanes}")
    udig = sha2.sha512_blocks(ublk, uact)
    k5_out = E.verify_digest(ua, ur, us, udig)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    k5_plain = E.verify_digest_plain(ua, ur, us, udig)  # the plain K5, once, cold
    end.record()
    torch.cuda.synchronize()
    plain5_ms = start.elapsed_time(end)
    require(torch.equal(k5_out, k5_plain), "K5 != plain")
    results["verify_batch"] = max_abs_err(k5_out, k5_plain)
    require(k5_out[:V_MAIN].tolist() == u_per, "Ed25519BatchVerifier verdicts != K5")
    check_u = sorted(set(planted) | set(rng.choice(V_MAIN, N_ORACLE_SAMPLE, replace=False).tolist()))
    oracle = CpuEd25519BatchVerifier()
    for i in check_u:
        oracle.add(*u_items[i])
    _, oracle_ok = oracle.verify()
    require([u_per[i] for i in check_u] == oracle_ok, "uncached verdicts != host oracle")
    require(not u_ok and all(not u_per[i] for i in planted)
            and sum(u_per) == V_MAIN - len(planted), "uncached planted rows")
    log(f"[5] K5 == plain on all {lanes} lanes; == host oracle on {len(check_u)} rows "
        f"(planted {sorted(planted)})")
    walls_u, phases_u = [], []
    for _ in range(12):
        bv = Ed25519BatchVerifier(device=dev)
        for it in u_items:
            bv.add(*it)
        t0 = time.perf_counter()
        bv.verify()
        walls_u.append((time.perf_counter() - t0) * 1e3)
        phases_u.append(dict(bv.last_timings))
    walls_u, phases_u = walls_u[2:], phases_u[2:]
    p50_u = float(np.median(walls_u))
    phase_p50_u = {k: float(np.median([p[k] for p in phases_u])) for k in phases_u[0]}
    log(f"[5] uncached verify p50 {p50_u:.2f} ms over {len(walls_u)} calls "
        f"(min {min(walls_u):.2f}, max {max(walls_u):.2f}); phases p50 (ms): "
        + json.dumps({k: round(v, 3) for k, v in phase_p50_u.items()}))
    bwin = E.b_window(dev)
    out5 = torch.empty((lanes,), dtype=torch.uint8, device=dev)
    it, wu, _, _ = TIMING["verify_batch"]
    t["verify_batch"] = (cuda_ms(lambda: E.launch_k5(ua, ur, us, udig, bwin, out5), it, wu), plain5_ms)

    # ---------------------------------------------------- 6. set change
    rng_c = np.random.default_rng(SEED + 1)
    gone = set(rng_c.choice(V_MAIN, N_CHURN, replace=False).tolist())
    new_keys = [host.PrivKey.from_seed(rng_c.bytes(32)) for _ in range(N_CHURN)]
    vals2 = T.ValidatorSet([v for i, v in enumerate(vals.validators) if i not in gone]
                           + [T.Validator(k.pub_key(), 10) for k in new_keys])
    old_sig = {cs.validator_address: cs for cs in good.signatures}
    new_by_addr = {k.pub_key().address(): k for k in new_keys}
    nanos2 = iter(rng_c.integers(0, 1_000_000_000, size=N_CHURN).tolist())
    sigs2 = []
    for i, v in enumerate(vals2.validators):
        cs = old_sig.get(v.address)  # sign-bytes do not depend on the validator's index
        if cs is None:
            vote = T.Vote(
                type=PRECOMMIT_TYPE, height=height, round=0, block_id=bid,
                timestamp=Timestamp(seconds=TS_SECONDS, nanos=next(nanos2)),
                validator_address=v.address, validator_index=i,
            )
            vote.signature = new_by_addr[v.address].sign(vote.sign_bytes(CHAIN_ID))
            cs = vote.to_commit_sig()
        sigs2.append(cs)
    commit2 = T.Commit(height=height, round=0, block_id=bid, signatures=sigs2)
    pubs2 = vals2.pub_keys_bytes()
    n_fresh = sum(pk not in entry.index for pk in pubs2)
    require(n_fresh == N_CHURN, f"{n_fresh} fresh keys")
    zero_counts()
    t0 = time.perf_counter()
    validation.verify_commit(CHAIN_ID, vals2, bid, height, commit2, device="cuda", comb_cache=cache)
    change_first_ms = (time.perf_counter() - t0) * 1e3
    first = read_counts()
    require(first["verify_batch"] == 1 and first["verify_cached"] == 0,
            f"the first call under the new set did not run uncached: {first}")
    cache.join_async()
    c_build = read_counts("set_change")
    churn_ms = cache.last_build_ms
    entry2 = cache.ensure_async(pubs2, device=dev)
    require(entry2 is not None, "the background build left no entry")
    require(c_build["build_a_tables"] == 1 and c_build["assemble_churn"] == 1,
            f"the background build did not run K3 then K6: {c_build}")
    full = cv.ValsetCombCache()
    full_entry = full.ensure(pubs2, device=dev)
    full_ms = full.last_build_ms
    require(torch.equal(entry2.tables, full_entry.tables) and torch.equal(entry2.valid, full_entry.valid),
            "churn-built tables != a full K3 build")
    del full, full_entry
    # the same churn build alone: a cache holding only the old set, then a
    # synchronous ensure of the new set (no verify_commit beside it)
    solo = cv.ValsetCombCache()
    solo.ensure(vals.pub_keys_bytes(), device=dev)
    solo_entry = solo.ensure(pubs2, device=dev)
    churn_solo_ms = solo.last_build_ms
    require(torch.equal(solo_entry.tables, entry2.tables), "solo churn build != background build")
    del solo, solo_entry
    zero_counts()
    validation.verify_commit(CHAIN_ID, vals2, bid, height, commit2, device="cuda", comb_cache=cache)
    c_next = read_counts("set_change_next")
    require(c_next["verify_cached"] == 1 and c_next["verify_batch"] == 0,
            f"the call after the build did not take the comb path: {c_next}")
    bucket = 1 << (N_CHURN - 1).bit_length()
    log(f"[6] set change ({N_CHURN} of {V_MAIN} keys replaced): first verify_commit "
        f"{change_first_ms:.1f} ms uncached, launches {first}; background build "
        f"(K3 on a {bucket}-key bucket, then K6) {churn_ms:.1f} ms beside that call, "
        f"{churn_solo_ms:.1f} ms alone, launches {c_build}; its tables == a full K3 build of "
        f"the new set ({full_ms:.1f} ms); next call launches {c_next}")

    # K6 against its plain version at V = 10,000, on the change's rows
    fresh = [i for i, pk in enumerate(pubs2) if pk not in entry.index]
    reuse = [(i, entry.index[pk]) for i, pk in enumerate(pubs2) if pk in entry.index]
    padded = fresh + [fresh[0]] * (bucket - len(fresh))
    bucket_pubs = entry2.pubs[torch.tensor(padded, device=dev)]
    t_new, v_new = comb.build_a_tables(bucket_pubs)
    it, wu, _, _ = TIMING["build_a_tables"]
    k3_bucket_ms = cuda_ms(lambda: comb.build_a_tables(bucket_pubs), it, wu)
    nr, br, fr = (torch.tensor(x, dtype=torch.int64, device=dev)
                  for x in ([i for i, _ in reuse], [j for _, j in reuse], fresh))
    k6_t, k6_v = cv.assemble_churn(entry.tables, entry.valid, t_new, v_new, nr, br, fr, V_MAIN)
    p6_t, p6_v = cv.assemble_churn_plain(entry.tables, entry.valid, t_new, v_new, nr, br, fr, V_MAIN)
    torch.cuda.synchronize()
    require(torch.equal(k6_t, p6_t) and torch.equal(k6_v, p6_v), "K6 != plain")
    require(torch.equal(k6_t, entry2.tables), "K6 != the background build's tables")
    results["assemble_churn"] = max(max_abs_err(k6_t, p6_t), max_abs_err(k6_v, p6_v))
    del k6_t, k6_v, p6_t, p6_v
    src = torch.full((V_MAIN,), -(1 << 31), dtype=torch.int32, device=dev)
    src[nr] = br.to(torch.int32)
    src[fr] = -1 - torch.arange(len(fresh), dtype=torch.int32, device=dev)
    out6 = torch.empty_like(entry.tables)
    val6 = torch.empty((V_MAIN,), dtype=torch.bool, device=dev)
    it, wu, pit, pwu = TIMING["assemble_churn"]
    t["assemble_churn"] = (
        cuda_ms(lambda: cv.launch_k6(entry.tables, entry.valid, t_new, v_new, src, out6, val6), it, wu),
        cuda_ms(lambda: cv.assemble_churn_plain(entry.tables, entry.valid, t_new, v_new, nr, br, fr,
                                                V_MAIN), pit, pwu),
    )
    # the library yardstick: one index_copy_ of the gathered rows into a
    # zeroed tensor (the gather itself is done once, outside the timing)
    dest = torch.cat([nr, fr])
    gathered = torch.cat([entry.tables[br], t_new[: len(fresh)]])
    zeroed = torch.zeros_like(entry.tables)
    zeroed.index_copy_(0, dest, gathered)
    require(torch.equal(zeroed, entry2.tables), "index_copy_ != the churn tables")
    lib6_ms = cuda_ms(lambda: zeroed.index_copy_(0, dest, gathered), it, wu)
    del out6, gathered, zeroed, t_new
    log(f"[6] K6 == plain at V={V_MAIN} ({len(reuse)} reused rows, {len(fresh)} fresh); "
        f"K3 on the {bucket}-key bucket {k3_bucket_ms:.4f} ms by CUDA events (its wrapper's "
        f"allocations included)")

    # ---------------------------------------------------- 7. light client
    rng_l = np.random.default_rng(SEED + 2)
    lkeys = [host.PrivKey.from_seed(rng_l.bytes(32)) for _ in range(V_LIGHT)]
    lvals = T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in lkeys])
    l_by_addr = {k.pub_key().address(): k for k in lkeys}
    lnanos = rng_l.integers(0, 1_000_000_000, size=V_LIGHT).tolist()
    lsigs = []
    for i, v in enumerate(lvals.validators):
        vote = T.Vote(
            type=PRECOMMIT_TYPE, height=height, round=0, block_id=bid,
            timestamp=Timestamp(seconds=TS_SECONDS, nanos=lnanos[i]),
            validator_address=v.address, validator_index=i,
        )
        vote.signature = l_by_addr[v.address].sign(vote.sign_bytes(CHAIN_ID))
        lsigs.append(vote.to_commit_sig())
    lcommit = T.Commit(height=height, round=0, block_id=bid, signatures=lsigs)
    zero_counts()
    walls_l = []
    for _ in range(12):
        t0 = time.perf_counter()
        # every signature counted: all 150 go through the kernel (256 lanes)
        validation.verify_commit_light_trusting(
            CHAIN_ID, lvals, lcommit, Fraction(1, 3), count_all_signatures=True,
            device="cuda", comb_cache=cache)
        walls_l.append((time.perf_counter() - t0) * 1e3)
    c_light = read_counts("light")
    require(c_light["verify_batch"] == 12 and c_light["verify_cached"] == 0
            and c_light["build_a_tables"] == 0, f"light-client launches {c_light}")
    walls_l = walls_l[2:]
    p50_l = float(np.median(walls_l))
    lsb = lcommit.vote_sign_bytes_fn(CHAIN_ID)
    l_items = [(lvals.validators[i].pub_key.bytes(), lsb(i), cs.signature) for i, cs in enumerate(lsigs)]
    la, lr, ls, lblk, lact = stage_batch(l_items, dev)
    require(la.shape[0] == 256, f"light bucket {la.shape[0]}")
    ldig = sha2.sha512_blocks(lblk, lact)
    l_k5, l_plain = E.verify_digest(la, lr, ls, ldig), E.verify_digest_plain(la, lr, ls, ldig)
    torch.cuda.synchronize()
    require(torch.equal(l_k5, l_plain) and bool(l_k5.all()), "K5 != plain at 256 lanes")
    out5l = torch.empty((256,), dtype=torch.uint8, device=dev)
    it, wu, pit, pwu = TIMING["verify_batch_256"]
    t["verify_batch_256"] = (
        cuda_ms(lambda: E.launch_k5(la, lr, ls, ldig, bwin, out5l), it, wu),
        cuda_ms(lambda: E.verify_digest_plain(la, lr, ls, ldig), pit, pwu),
    )
    log(f"[7] light-client trusting check ({V_LIGHT} validators, trust 1/3, 256 lanes): p50 "
        f"{p50_l:.2f} ms over {len(walls_l)} calls (min {min(walls_l):.2f}, max {max(walls_l):.2f}); "
        f"launches {c_light}; K5 == plain at 256 lanes")

    # ---------------------------------------------------- 8. demotion
    fk = host.PrivKey.from_seed(rng.bytes(32))
    fmsg = b"a vote from outside the set"
    sub = good_items[:40]
    batches = {
        "foreign": sub[:20] + [(fk.pub_key().data, fmsg, fk.sign(fmsg))] + sub[20:]
        + [u_items[I_S_GE_L]],
        "duplicate": sub[:30] + [sub[3]] + sub[30:] + [u_items[I_FLIP]],
    }
    zero_counts()
    for name, batch in batches.items():
        bv = cv.CombBatchVerifier(entry)
        for it_ in batch:
            bv.add(*it_)
        ok, per = bv.verify()
        oracle = CpuEd25519BatchVerifier()
        for it_ in batch:
            oracle.add(*it_)
        require((ok, per) == oracle.verify(), f"demoted {name} batch != host oracle")
        require(not ok and sum(per) == len(batch) - 1, f"demoted {name} batch verdicts")
    c_dem = read_counts("demotion")
    require(c_dem["verify_batch"] == 2 and c_dem["verify_cached"] == 0, f"demotion launches {c_dem}")
    log(f"[8] demotion: a foreign key and a duplicate key each demote a comb batch to the "
        f"uncached verifier; verdicts == host oracle; launches {c_dem}")

    # ---------------------------------------------------- 9. light client at 10,000
    # The trusted headers are at height - 1 (adjacent) and height - 10
    # (skipping, trusted set = the same 10,000); the untrusted one is the
    # block whose commit phase 2 verified.
    root_host = cmerkle._root_from_leaf_hashes_host(
        [cmerkle.leaf_hash(v.bytes()) for v in vals.validators])
    require(vals_hash == root_host, "the set's hash on the card != hashlib's")
    trusted_sh = T.SignedHeader(header_at(height - 1, TS_SECONDS - 7), good)
    far_sh = T.SignedHeader(header_at(height - 10, TS_SECONDS - 70), good)
    new_sh = T.SignedHeader(hdr, good)
    now_ns = (TS_SECONDS + 5) * NS
    cache.ensure(vals.pub_keys_bytes(), device=dev)  # tables warm
    depth = len(Mk.level_sizes(V_MAIN))
    light_walls, light_counts = {}, {}
    for name, call in (
        ("light_adjacent", lambda: light.verify_adjacent(
            trusted_sh, new_sh, vals, TRUSTING_PERIOD_NS, now_ns, device="cuda", comb_cache=cache)),
        ("light_non_adjacent", lambda: light.verify_non_adjacent(
            far_sh, vals, new_sh, vals, TRUSTING_PERIOD_NS, now_ns, trust_level=Fraction(1, 3),
            device="cuda", comb_cache=cache)),
        ("valset_hash", lambda: vals.hash(device="cuda")),
    ):
        walls_ = []
        zero_counts()
        for _ in range(12):
            vals._hash = None  # the memo dropped: every call hashes the set
            t0 = time.perf_counter()
            call()
            walls_.append((time.perf_counter() - t0) * 1e3)
        light_counts[name] = c_ = read_counts(name)
        light_walls[name] = walls_[2:]
        require(c_["sha256_blocks"] == 12 and c_["merkle_level"] == 12 * depth
                and c_["merkle_gather"] == 0, f"{name}: {c_}")
        if name != "valset_hash":
            require(c_["verify_cached"] >= 12 and c_["verify_batch"] == 0
                    and c_["build_a_tables"] == 0, f"{name} did not take the warm comb path: {c_}")
        require(vals.hash(device="cuda") == root_host, f"{name}: the set's hash moved")
    p50_light = {k: float(np.median(w)) for k, w in light_walls.items()}
    bad_hdr = T.Header(**{f: getattr(hdr, f) for f in T.Header.FIELDS})
    bad_hdr.validators_hash = bytes([hdr.validators_hash[0] ^ 1]) + hdr.validators_hash[1:]
    try:
        light.verify_adjacent(trusted_sh, T.SignedHeader(bad_hdr, good), vals, TRUSTING_PERIOD_NS,
                              now_ns, device="cuda", comb_cache=cache)
    except light.ErrInvalidHeader as e:
        refused = str(e)
    else:
        raise AssertionError("a header with a flipped validators_hash verified")
    # the changed set of phase 6 supplied for this header: refused on the hashes
    try:
        light.verify_adjacent(trusted_sh, new_sh, vals2, TRUSTING_PERIOD_NS, now_ns,
                              device="cuda", comb_cache=cache)
    except light.ErrInvalidHeader as e:
        refused_set = str(e)
    else:
        raise AssertionError("the header verified against another validator set")
    require(refused_set.startswith("header validators hash"), f"refusal: {refused_set}")
    log(f"[9] light client at {V_MAIN} validators: the set's hash == hashlib's "
        f"({root_host.hex()[:16]}...); p50 (ms) over 10 calls after 2, hash memo dropped before "
        f"each: " + json.dumps({k: round(v, 3) for k, v in p50_light.items()}))
    log(f"[9] launches: " + json.dumps(light_counts))
    log(f"[9] flipped validators_hash refused: ErrInvalidHeader({refused[:70]}...); the "
        f"changed set of phase 6 refused: ErrInvalidHeader({refused_set[:40]}...)")

    # ---------------------------------------------------- 10. proof serving
    rng_p = np.random.default_rng(SEED + 3)
    leaf_buf = rng_p.bytes(N_LEAVES * LEAF_BYTES)
    leaves = [leaf_buf[i * LEAF_BYTES : (i + 1) * LEAF_BYTES] for i in range(N_LEAVES)]
    t0 = time.perf_counter()
    host_root, host_proofs = cmerkle.proofs_from_byte_slices(leaves)
    host_proofs_ms = (time.perf_counter() - t0) * 1e3
    tree = proof_server.register_tree(leaves)
    queries = [proof_server.encode_query(tree, i) for i in range(N_LEAVES)]
    proof_walls, multi_walls = [], []
    zero_counts()
    for _ in range(12):
        prover = proof_server.ProofProver(device=dev)
        for q in queries:
            prover.add(*q)
        t0 = time.perf_counter()
        ok_p, rows_p = prover.verify()
        proof_walls.append((time.perf_counter() - t0) * 1e3)
    c_proofs = read_counts("proofs")
    require(ok_p and rows_p == host_proofs, "served proofs != proofs_from_byte_slices")
    depth_p = len(Mk.level_sizes(N_LEAVES))
    require(c_proofs["sha256_blocks"] == 12 and c_proofs["merkle_level"] == 12 * depth_p
            and c_proofs["merkle_gather"] == 12, f"proof launches {c_proofs}")
    zero_counts()
    for _ in range(12):
        t0 = time.perf_counter()
        root_m, proofs_m, dedup = cmerkle.device_multiproof(leaves, range(N_LEAVES), device=dev)
        multi_walls.append((time.perf_counter() - t0) * 1e3)
    c_multi = read_counts("multiproof")
    require(root_m == host_root and proofs_m == host_proofs, "multiproof != proofs_from_byte_slices")
    require(c_multi["sha256_blocks"] == 12 and c_multi["merkle_level"] == 12 * depth_p
            and c_multi["merkle_gather"] == 12, f"multiproof launches {c_multi}")
    p50_proofs = float(np.median(proof_walls[2:]))
    p50_multi = float(np.median(multi_walls[2:]))
    log(f"[10] proof serving, {N_LEAVES} leaves of {LEAF_BYTES} B, every leaf queried: all proofs "
        f"== proofs_from_byte_slices (host {host_proofs_ms:.1f} ms); ProofProver.verify p50 "
        f"{p50_proofs:.2f} ms, device_multiproof p50 {p50_multi:.2f} ms (dedup {dedup:.4f}); "
        f"launches {json.dumps(c_proofs)} / {json.dumps(c_multi)}")

    # ---------------------------------------------------- 11. K7-K9 parity, times
    # K7 on rows of 1-3 active blocks with stale bytes past each row's end
    lens7 = rng_p.integers(0, 3 * 64 - 9 + 1, size=N_LEAVES)
    blk7, act7 = sha2.pad_messages_sha256([rng_p.bytes(int(n)) for n in lens7], max_len=3 * 64 - 9)
    blk7 = blk7.copy()
    stale = rng_p.integers(0, 256, size=blk7.shape, dtype=np.uint8)
    past = np.arange(3)[None, :] >= act7[:, None]
    blk7[past] = stale[past]
    b7, a7 = torch.from_numpy(blk7).to(dev), torch.from_numpy(act7).to(dev)
    d7 = sha2.sha256_blocks(b7, a7)
    p7 = sha2.sha256_blocks_plain(b7, a7)
    torch.cuda.synchronize()
    require(torch.equal(d7, p7), "K7 != plain")
    results["sha256_blocks"] = max_abs_err(d7, p7)
    # K8 on every level of both trees; K9 with -1 coordinates
    lvl_checked = 0
    stage_v = Mk.stage_leaves([v.bytes() for v in vals.validators], dev)
    stage_p = Mk.stage_leaves(leaves, dev)
    k8_err = 0
    for blocks_, active_ in (stage_v[:2], stage_p[:2]):
        n_ = blocks_.shape[0]
        flat_ = Mk.all_levels(blocks_, active_)
        offs_ = Mk.level_offsets(n_)
        for lvl, sz in enumerate(Mk.level_sizes(n_)):
            want_ = flat_.clone()
            want_[offs_[lvl + 1] : offs_[lvl + 1] + (sz + 1) // 2] = 0
            Mk.merkle_level_plain(want_, offs_[lvl], sz, offs_[lvl + 1])
            k8_err = max(k8_err, max_abs_err(flat_, want_))
            require(torch.equal(flat_, want_), f"K8 != plain at level {lvl} of {n_} leaves")
            lvl_checked += 1
    results["merkle_level"] = k8_err
    odd = [sz for sz in Mk.level_sizes(V_MAIN) if sz % 2]
    flat_p = Mk.all_levels(*stage_p[:2])
    require(bytes(flat_p[-1].cpu().numpy()) == host_root, "proof tree root != host")
    coord9_np = rng_p.integers(0, flat_p.shape[0], size=N_LEAVES, dtype=np.int32)
    coord9_np[::97] = -1  # rows with no aunt
    coord9 = torch.from_numpy(coord9_np).to(dev)
    g9 = Mk.merkle_gather(flat_p, coord9)
    q9 = Mk.merkle_gather_plain(flat_p, coord9)
    torch.cuda.synchronize()
    require(torch.equal(g9, q9), "K9 != plain")
    n_missing = int((coord9 < 0).sum())
    pc = torch.from_numpy(Mk.proof_coords(N_LEAVES, range(N_LEAVES),
                                          cmerkle._plan_array(N_LEAVES, range(N_LEAVES)))).to(dev)
    pc_flat = pc.reshape(-1)
    require(bool((pc_flat >= 0).all()), "a proof coordinate of a power-of-two tree is -1")
    g9p = Mk.merkle_gather(flat_p, pc_flat)
    lib9 = torch.index_select(flat_p, 0, pc_flat)
    q9p = Mk.merkle_gather_plain(flat_p, pc_flat)
    torch.cuda.synchronize()
    require(torch.equal(g9p, q9p) and torch.equal(g9p, lib9), "K9 != plain / index_select")
    results["merkle_gather"] = max(max_abs_err(g9, q9), max_abs_err(g9p, q9p))
    log(f"[11] K7 == plain on {N_LEAVES} rows of 1-3 active blocks (stale bytes past each row); "
        f"K8 == plain on all {lvl_checked} levels of the {V_MAIN}- and {N_LEAVES}-leaf trees "
        f"(odd levels of the first: {odd}); K9 == plain with {n_missing} coordinates of -1, and "
        f"== plain and index_select on the proofs' {pc_flat.shape[0]} coordinates")
    # times at the proof path's shapes
    blocks_p, active_p = stage_p[:2]
    offs_p, sizes_p = Mk.level_offsets(N_LEAVES), Mk.level_sizes(N_LEAVES)
    flat_t = torch.empty_like(flat_p)
    sha2.launch_k7(blocks_p, active_p, flat_t)
    sum_active7 = int(active_p.sum())

    def k8_tree():
        for lvl, sz in enumerate(sizes_p):
            Mk.merkle_level(flat_t, offs_p[lvl], sz, offs_p[lvl + 1])

    def k8_tree_plain():
        for lvl, sz in enumerate(sizes_p):
            Mk.merkle_level_plain(flat_t, offs_p[lvl], sz, offs_p[lvl + 1])

    out9 = torch.empty((pc_flat.shape[0], 32), dtype=torch.uint8, device=dev)
    timed7 = torch.empty((N_LEAVES, 32), dtype=torch.uint8, device=dev)
    for name, kern, plain in (
        ("sha256_blocks", lambda: sha2.launch_k7(blocks_p, active_p, timed7),
         lambda: sha2.sha256_blocks_plain(blocks_p, active_p)),
        ("merkle_level", k8_tree, k8_tree_plain),
        ("merkle_gather", lambda: Mk.launch_k9(flat_p, pc_flat, out9),
         lambda: Mk.merkle_gather_plain(flat_p, pc_flat)),
    ):
        it, wu, pit, pwu = TIMING[name]
        t[name] = (cuda_ms(kern, it, wu), cuda_ms(plain, pit, pwu))
    require(torch.equal(flat_t, flat_p), "the timed tree != the proof tree")
    it, wu, _, _ = TIMING["merkle_gather"]
    lib9_ms = cuda_ms(lambda: torch.index_select(flat_p, 0, pc_flat, out=out9), it, wu)
    k8_top_ms = cuda_ms(lambda: Mk.merkle_level(flat_t, 0, N_LEAVES, offs_p[1]), 20, 2)

    # ---------------------------------------------------- 12. the record
    # bounds from this run's shapes and data
    width = good_payload.shape[1]
    k5_ops = FIELD_MULS_PER_STRAUS * OPS_PER_FIELD_MUL + OPS_PER_SCALAR_REDUCE
    bound = {
        "parse_verify_payload": (
            "bytes", (V_MAIN * width + V_MAIN * 32 + V_MAIN * nb * 128 + V_MAIN * 4) / HBM_BYTES_PER_S),
        "sha512_blocks": (
            "operations", sum_active * OPS_PER_SHA512_BLOCK / INT32_OPS_PER_S),
        "verify_cached": (
            "operations",
            V_MAIN * (FIELD_MULS_PER_VERIFY * OPS_PER_FIELD_MUL + OPS_PER_SCALAR_REDUCE)
            / INT32_OPS_PER_S),
        "build_a_tables": (
            "operations", V_MAIN * FIELD_MULS_PER_TABLE * OPS_PER_FIELD_MUL / INT32_OPS_PER_S),
        "verify_batch": ("operations", lanes * k5_ops / INT32_OPS_PER_S),
        "verify_batch_256": ("operations", 256 * k5_ops / INT32_OPS_PER_S),
        "assemble_churn": ("bytes", (2 * V_MAIN * A_ROW_BYTES + V_MAIN * 6) / HBM_BYTES_PER_S),
        "sha256_blocks": ("operations", sum_active7 * OPS_PER_SHA256_BLOCK / INT32_OPS_PER_S),
        "merkle_level": (
            "operations", sum(sz // 2 for sz in sizes_p) * 2 * OPS_PER_SHA256_BLOCK / INT32_OPS_PER_S),
        "merkle_gather": ("bytes", pc_flat.shape[0] * (4 + 32 + 32) / HBM_BYTES_PER_S),
    }
    # the other side of each bound, logged for the record
    other = {
        "parse_verify_payload": V_MAIN * nb * 128 * 8 / INT32_OPS_PER_S,
        "sha512_blocks": (V_MAIN * nb * 128 + V_MAIN * 4 + V_MAIN * 64) / HBM_BYTES_PER_S,
        "verify_cached": (V_MAIN * 86 * 96 + V_MAIN * (width + 64)) / HBM_BYTES_PER_S,
        "build_a_tables": (V_MAIN * 32 + V_MAIN * 64 * 8 * 96) / HBM_BYTES_PER_S,
        "verify_batch": lanes * (3 * 32 + 64 + 1) / HBM_BYTES_PER_S,
        "verify_batch_256": 256 * (3 * 32 + 64 + 1) / HBM_BYTES_PER_S,
        "assemble_churn": 0.0,
        "sha256_blocks": (blocks_p.numel() + N_LEAVES * 4 + N_LEAVES * 32) / HBM_BYTES_PER_S,
        "merkle_level": sum(sz * 32 + (sz + 1) // 2 * 32 for sz in sizes_p) / HBM_BYTES_PER_S,
        "merkle_gather": 0.0,
    }
    meta = {
        "parse_verify_payload": ("K1", "cometbft_tpu_torch/csrc/sha2.cu",
                                 "cometbft_tpu/ops/sha2.py:355", ["sha2_parse_verify_payload"]),
        "sha512_blocks": ("K2", "cometbft_tpu_torch/csrc/sha2.cu",
                          "cometbft_tpu/ops/sha2.py:189", ["sha512_blocks"]),
        "build_a_tables": ("K3", "cometbft_tpu_torch/csrc/comb.cu",
                           "cometbft_tpu/ops/comb.py:74", ["comb_build_a_tables"]),
        "verify_cached": ("K4", "cometbft_tpu_torch/csrc/comb.cu",
                          "cometbft_tpu/ops/comb.py:484",
                          ["comb_verify_cached_tree", "comb_verify_cached_seq",
                           "comb_device_verify"]),
        "verify_batch": ("K5", "cometbft_tpu_torch/csrc/ed25519.cu",
                         "cometbft_tpu/ops/ed25519.py:380", ["ed25519_verify_batch"]),
        "assemble_churn": ("K6", "cometbft_tpu_torch/csrc/churn.cu",
                           "cometbft_tpu/models/comb_verifier.py:391", ["comb_assemble_churn"]),
        "sha256_blocks": ("K7", "cometbft_tpu_torch/csrc/merkle.cu",
                          "cometbft_tpu/ops/sha2.py:81", ["sha256_blocks"]),
        "merkle_level": ("K8", "cometbft_tpu_torch/csrc/merkle.cu",
                         "cometbft_tpu/ops/merkle.py:47",
                         ["merkle_root_from_leaves", "merkle_proofs_from_leaves",
                          "merkle_multiproof_from_leaves"]),
        "merkle_gather": ("K9", "cometbft_tpu_torch/csrc/merkle.cu",
                          "cometbft_tpu/ops/merkle.py:117",
                          ["merkle_proofs_from_leaves", "merkle_multiproof_from_leaves"]),
    }
    library = {"assemble_churn": lib6_ms, "merkle_gather": lib9_ms}
    total_launches = {k: sum(p[k] for p in path_launches.values()) for k in read_counts()}
    log(f"[12] launches per path (each read just after the path): {json.dumps(path_launches)}")
    kernels = []
    for name in meta:
        tag, src_, rep, rows_ = meta[name]
        ms, plain_ms = t[name]
        by, secs = bound[name]
        rec = {
            "name": name, "tag": tag, "route": "cuda", "source": src_, "replaces": rep,
            "manifest_rows": rows_, "launches": total_launches[name],
            "max_abs_err": results[name], "parity": results[name] == 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": secs * 1e3, "bound_by": by,
            "library_ms": library.get(name),
        }
        if name == "verify_batch":
            rec.update(lanes=lanes, ms_256=t["verify_batch_256"][0],
                       plain_ms_256=t["verify_batch_256"][1],
                       bound_ms_256=bound["verify_batch_256"][1] * 1e3)
        if name == "merkle_level":  # ms, plain_ms and bound_ms are for one whole tree
            rec.update(launches_per_tree=len(sizes_p), leaves=N_LEAVES, ms_top_level=k8_top_ms)
        kernels.append(rec)
        for key in (name, "verify_batch_256") if name == "verify_batch" else (name,):
            it, wu, pit, pwu = TIMING[key]
            ms, plain_ms = t[key]
            by, secs = bound[key]
            lib_note = f"; library {library[name]:.4f} ms" if name in library else ""
            log(f"[12] {tag} {key}: {ms:.4f} ms over {it} launches after {wu} warm-up "
                f"(plain {plain_ms:.2f} ms over {pit} after {pwu}); bound {secs * 1e3:.4f} ms by "
                f"{by}, other side {other[key] * 1e3:.4f} ms{lib_note}; launches over the paths "
                f"{total_launches[name]}")
    # a verify_commit launches K1, K2 and K4 once each
    device_ms = sum(t[n][0] for n in ("parse_verify_payload", "sha512_blocks", "verify_cached"))
    log(f"[12] total {time.perf_counter() - t_start:.1f} s; verify_commit p50 {p50:.3f} ms, of which "
        f"kernels {device_ms:.3f} ms ({100 * device_ms / p50:.2f}% device busy); table build "
        f"{cold_build_ms:.1f} ms cold, {warm_build_ms:.1f} ms warm, churn {churn_ms:.1f} ms "
        f"beside a verify_commit and {churn_solo_ms:.1f} ms alone, full build of the changed set "
        f"{full_ms:.1f} ms; uncached p50 {p50_u:.2f} ms; "
        f"light-client p50 {p50_l:.2f} ms; at {V_MAIN} validators verify_adjacent p50 "
        f"{p50_light['light_adjacent']:.2f} ms, verify_non_adjacent {p50_light['light_non_adjacent']:.2f}, "
        f"ValidatorSet.hash {p50_light['valset_hash']:.2f}; {N_LEAVES} proofs p50 {p50_proofs:.2f} ms, "
        f"multiproof {p50_multi:.2f} ms")
    log(smi)
    log(json.dumps({"kernels": kernels, "verify_commit_p50_ms": p50,
                    "verify_phases_p50_ms": phase_p50, "table_build_cold_ms": cold_build_ms,
                    "table_build_warm_ms": warm_build_ms, "kernel_ms_per_verify": device_ms,
                    "peak_mem_bytes": peak, "uncached_p50_ms": p50_u,
                    "uncached_phases_p50_ms": phase_p50_u,
                    "set_change_first_call_ms": change_first_ms, "churn_build_ms": churn_ms,
                    "churn_build_solo_ms": churn_solo_ms, "k3_bucket_ms": k3_bucket_ms,
                    "full_build_changed_set_ms": full_ms, "light_trusting_p50_ms": p50_l,
                    "light_10k_p50_ms": p50_light, "proofs_16k_p50_ms": p50_proofs,
                    "multiproof_16k_p50_ms": p50_multi, "multiproof_dedup": dedup,
                    "host_proofs_16k_ms": host_proofs_ms}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
