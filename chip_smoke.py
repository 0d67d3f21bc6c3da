"""Chip smoke test of the PyTorch/CUDA port: drives the port's main path —
ed25519 VerifyCommit over a 10,000-validator commit through the
comb-cached kernels — on one NVIDIA card, holds each kernel against its
plain PyTorch version, and prints the card's numbers.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device and build: the card's name and power limit, the nvcc build of
     every kernel source with its -Xptxas -v register and spill counts;
  2. the main path, with every kernel launch count zeroed just before and
     read just after: the set's table build, verify_commit on a good
     commit, verify_commit on a commit with planted faults (blame on the
     first planted index);
  3. each kernel against its plain version on the card at the main path's
     shapes (byte-exact), the planted commit's bitmap against the plain
     version on every row and the host oracle on the planted rows plus
     256 sampled rows;
  4. times on the card: the table build, verify_commit p50 with the
     verifier's phase timings, each kernel and its plain version by CUDA
     events, peak device memory;
  5. one JSON line with every kernel, then the contract line.

Needs one CUDA card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

V_MAIN = 10_000  # validators on the main path
V_K3_PARITY = 1_024  # K3 against its plain version
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
OPS_PER_SCALAR_REDUCE = (81 + 45) * 4  # K4 Barrett word products, per lane


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
    from cometbft_tpu_torch.crypto import _ref25519 as ref
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.models.verifier import CpuEd25519BatchVerifier
    from cometbft_tpu_torch.ops import comb, sha2
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE, Timestamp

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    t_start = time.perf_counter()

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
    bid = T.BlockID(hash=rng.bytes(32), part_set_header=T.PartSetHeader(total=3, hash=rng.bytes(32)))
    height = 1_000_000
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

    # ---------------------------------------------------- 2. main path
    torch.cuda.reset_peak_memory_stats()
    cache = cv.ValsetCombCache()
    counters = (sha2.LAUNCHES, comb.LAUNCHES)
    for d in counters:
        for k in d:
            d[k] = 0
    t0 = time.perf_counter()
    validation.verify_commit(CHAIN_ID, vals, bid, height, good, device="cuda", comb_cache=cache)
    t_first = time.perf_counter() - t0
    try:
        validation.verify_commit(CHAIN_ID, vals, bid, height, faulted, device="cuda", comb_cache=cache)
    except validation.CommitVerificationError as e:
        blame = str(e)
    else:
        raise AssertionError("the planted commit verified")
    launches = {**sha2.LAUNCHES, **comb.LAUNCHES}
    log(f"[2] main path: good commit verified ({t_first:.2f} s incl. the table build "
        f"of {cache.last_build_ms:.1f} ms); planted commit raised: {blame[:60]}...")
    log(f"[2] launches on the main path: {launches}")
    require(blame.startswith(f"wrong signature (#{first_bad}):"), f"blame {blame!r} != #{first_bad}")
    require(all(n > 0 for n in launches.values()), f"a kernel of the path never launched: {launches}")
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
    for _ in range(12):
        t0 = time.perf_counter()
        validation.verify_commit(CHAIN_ID, vals, bid, height, good, device="cuda", comb_cache=cache)
        walls.append((time.perf_counter() - t0) * 1e3)
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
    cache.ensure(list(reversed(vals.pub_keys_bytes())), device=dev)  # a second set: warm build
    warm_build_ms = cache.last_build_ms
    log(f"[4] table build (V={V_MAIN}, host clock around K3's wrapper and a synchronize): "
        f"{cold_build_ms:.1f} ms in the main path (the process's first K3 launch), "
        f"{warm_build_ms:.1f} ms for a second set")
    log(f"[4] peak device memory on the main path: {peak / 2**20:.1f} MiB")

    # bounds from this run's shapes and data
    width = good_payload.shape[1]
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
    }
    # the other side of each bound, logged for the record
    other = {
        "parse_verify_payload": V_MAIN * nb * 128 * 8 / INT32_OPS_PER_S,
        "sha512_blocks": (V_MAIN * nb * 128 + V_MAIN * 4 + V_MAIN * 64) / HBM_BYTES_PER_S,
        "verify_cached": (V_MAIN * 86 * 96 + V_MAIN * (width + 64)) / HBM_BYTES_PER_S,
        "build_a_tables": (V_MAIN * 32 + V_MAIN * 64 * 8 * 96) / HBM_BYTES_PER_S,
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
    }
    kernels = []
    for name in ("parse_verify_payload", "sha512_blocks", "build_a_tables", "verify_cached"):
        tag, src, rep, rows_ = meta[name]
        ms, plain_ms = t[name]
        by, secs = bound[name]
        kernels.append({
            "name": name, "tag": tag, "route": "cuda", "source": src, "replaces": rep,
            "manifest_rows": rows_, "launches": launches[name],
            "max_abs_err": results[name], "parity": results[name] == 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": secs * 1e3, "bound_by": by,
            "library_ms": None,
        })
        it, wu, pit, pwu = TIMING[name]
        log(f"[4] {tag} {name}: {ms:.4f} ms over {it} launches after {wu} warm-up "
            f"(plain {plain_ms:.2f} ms over {pit} after {pwu}); bound {secs * 1e3:.4f} ms by {by}, "
            f"other side {other[name] * 1e3:.4f} ms; launches on the main path {launches[name]}")
    # a verify_commit launches K1, K2 and K4 once each
    device_ms = sum(t[n][0] for n in ("parse_verify_payload", "sha512_blocks", "verify_cached"))
    log(f"[5] total {time.perf_counter() - t_start:.1f} s; verify_commit p50 {p50:.3f} ms, of which "
        f"kernels {device_ms:.3f} ms ({100 * device_ms / p50:.2f}% device busy); table build "
        f"{cold_build_ms:.1f} ms cold, {warm_build_ms:.1f} ms warm")
    log(smi)
    log(json.dumps({"kernels": kernels, "verify_commit_p50_ms": p50,
                    "verify_phases_p50_ms": phase_p50, "table_build_cold_ms": cold_build_ms,
                    "table_build_warm_ms": warm_build_ms, "kernel_ms_per_verify": device_ms,
                    "peak_mem_bytes": peak}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
