"""Chip smoke test of the PyTorch/CUDA port: drives the port's paths —
ed25519 VerifyCommit over a 10,000-validator commit through the
comb-cached kernels, the uncached (Straus) verifier at the same width, a
validator-set change with its background churn build, a light-client
trusting check on 150 validators, the comb verifier's demotion, the
light client's header checks at 10,000 validators (validator-set hash on
the Merkle kernels, then the commit), batched Merkle proof serving over
a 16,384-leaf tree, the secp256k1 ECDSA lane on a 4,096-transaction
CheckTx batch of the Cosmos, Ethereum and ecrecover wire shapes, and the
BLS12-381 lane on a 10,000-validator aggregate commit, the sharded
verify plane over torch.distributed at world 1 and 4, the verify
service under load, and the blocksync replay of 5,000-validator commits
through the comb path's staging thread, the light client's bisection,
store and divergence detector at 10,000 validators with the attack
evidence they produce and its check, a full node's block and state
stores with the evidence pool over them and the light client's JSON-RPC
front (HTTP provider, verifying client, proxy) at 10,000 validators, and
the service's failover watchdog tripping to the host and restoring — on
one NVIDIA card, holds
each kernel against its plain PyTorch version, and prints the card's
numbers.  Every path that
crypto/batch.create_batch_verifier serves (verify_commit, the light
client, the uncached, secp and BLS verifiers) reaches its kernels
through the verify service (verifysvc/service.py): its host worker
launches them and its collector waits for them.

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
     (byte-exact), K1 through parse_verify_payload also at payload widths
     that are not a multiple of 4 (69-71, 101, 113-115, 197, 241-243,
     259; the wrapper pads them), the planted commit's bitmap against the plain version
     on every row and the host oracle on the planted rows plus 256
     sampled rows; K4 on block-edge batches of 1-10,001 lanes
     (tests/torch_comb_corpus.py) against the plain version and the
     corpus's verdicts, output buffers poisoned first; K3 on edge
     batches of 1-129 keys (tests/torch_group_corpus.py: off-curve keys
     at warp and block edges, non-canonical y, identity and small-order
     keys) against the plain version and the host bigint build;
  4. times of the comb path: the table build, verify_commit p50 with the
     verifier's phase timings (K4 and no K5 launched), each kernel and
     its plain version by CUDA events, peak device memory; K4's time at
     a world-4 rank's 2,504 lanes, K3's and K4's launch shapes (threads
     a key or lane and a block, blocks an SM) and ptxas figures (a spill
     fails), comb.cu's build time;
  5. the uncached path: the commit's 10,000 items with the planted faults
     through the Straus verifier (16,384 lanes), K5 against its plain
     version on every lane and the host oracle on the planted rows plus
     256 sampled rows, p50 over 10 calls, K5's time, launch shape and
     ptxas figures at both group widths (a spill fails); K5 on edge
     batches of 1-12,289 lanes (tests/torch_group_corpus.py) against the
     plain version, the host oracle and the corpus's verdicts, output
     buffers poisoned first;
  6. a validator-set change: 100 of the 10,000 keys replaced; the first
     verify_commit runs uncached (K5, no K4) and starts the background
     churn build (K3 on a 128-key bucket, then K6); its tables against a
     full K3 build; the next verify_commit runs K4; K6 against its plain
     version and index_copy_, timed; K3 at the bucket's 128 keys;
  7. verify_commit_light_trusting (trust 1/3) on a 150-validator set:
     K2 -> K5 at 256 lanes, p50, K5's time at 256 lanes;
  8. demotion: comb batches with a foreign key and with a duplicate key
     against the host oracle;
  9. the light client at 10,000 validators, tables warm and the set's
     hash memo dropped before each call: ValidatorSet.hash (K7 once, K8
     once for the tree) against hashlib, verify_adjacent and
     verify_non_adjacent (trust 1/3; then the comb kernels), a header
     with a flipped validators_hash refused; p50s;
 10. proof serving over 16,384 leaves of 64 bytes, every leaf queried:
     ProofProver (K7, one K8, one K9) and device_multiproof, every
     proof equal to proofs_from_byte_slices's byte for byte; p50s and
     the multiproof's dedup factor;
 11. K7-K9 against their plain versions (byte-exact) — K7 on rows of 1-3
     active blocks with stale bytes, K8 (one launch a tree) on every
     level of both trees and of trees of 2, 3, 2T - 1, 2T, 2T + 1 and
     4 T^2 + 1 leaves (T = 256 threads a block) over poisoned rows, each
     launched twice in a row on one stream (its ticket counter reset), K9
     with -1 coordinates — and their times, K9 beside index_select;
 12. secp inputs: pools pre-signed with the port's host signers (32
     senders a wire shape x 4 transactions, payloads of 40-97 bytes and
     of 234), replayed into batches of 4,096 CheckTx envelopes with 22
     planted rows of every invalid class;
 13. the secp paths through crypto/batch.create_batch_verifier, each with
     its launch counts: the mixed batch (K12<1,1>), its Shamir witness
     (COMETBFT_TPU_SECP_GLV=0: K12<0,1>), a batch without ecrecover rows
     (K12<1,0>, K12<0,0>), and the same with 256-byte sign-bytes, hashed
     off K12 (hashlib SHA-256, K10 Keccak, then K11<*,1> and K11<*,0>);
     GLV and Shamir verdicts identical, every path's verdicts equal to
     the host oracle on the planted rows and 64 sampled rows;
 14. K10 and the eight K11 / K12 instantiations against their plain
     versions on every row, their times beside the one-thread design's, the work each spent
     (the bound's operation count, per row from the run's data), their
     launch shape (threads a row, blocks an SM) and ptxas figures
     (registers, stack; a spill fails, and so do K11 / K12 figures that
     moved); K10 also at row counts on the edges of its warps and blocks
     and through a CUDA graph on the active rows alone; then the eight on
     a block-edge batch against their plain versions and the host oracle;
 15. SecpBatchVerifier.verify p50 over 10 calls with last_timings;
 16. BLS inputs: 10,000 keys whose secrets run a + i b (mod r) from the
     seed (a Jacobian add a key), the aggregate signature (sum sk) H(m),
     checked on 8 keys against PrivKey and aggregate_signatures; planted
     keys of every bad class;
 17. the 10,000-row aggregate commit through crypto/batch.
     create_batch_verifier("bls12_381"): cold (K15 + K14's finishing
     stage), warm p50 with last_timings (K14), a forged aggregate
     signature (one pairing), the planted batch (K15) with its verdicts
     against the host oracle on the planted and 256 sampled rows;
 18. 64 individually signed rows (K13, one 65-pair product), and one
     forged row blamed alone;
 19. types/validation.verify_commit over a 512-validator BLS set, cold
     (K15) and warm (K14), a tampered commit refused;
 20. K13-K15 against their plain versions on all 10,000 rows (byte-exact
     ok bytes and triples), K15's verdicts against K13's; K15 on
     block-edge batches of 1-33 rows, rows of order 3 and 11 and warps
     that all fail before the ladder (tests/torch_bls_corpus.py) against
     the corpus, K13 and the plain version; their times and the work of
     the run's data; bls.cu's launch shapes and ptxas figures (a spill
     fails);
 21. one JSON line with every kernel (rows 23-26 of the kernel table too:
     the sharded entries, their per-rank kernels' bounds summed), then the
     contract line; it runs after phases 22-28 (27 and 28 before 26):
 22. the sharded plane at world 1 (a one-rank NCCL group in this
     process, the comb path bound with set_active_mesh): verify_commit
     over phase 2's set on the good and the planted commit,
     commit_verification_step on phase 5's 16,384 lanes and phase 10's
     16,384 leaves, sharded_merkle_proofs with every leaf queried; every
     output byte for byte the one-device phases'; p50s beside the
     unsharded calls; each entry's time, and its plain chain once, cold;
 23. the same calls at world 4: four spawned ranks sharing this card on
     gloo (NCCL refuses two ranks on one GPU), each holding 2,504 of the
     10,016 lanes' tables and 4,096 of the leaves, reading a corpus the
     parent wrote once; every rank's outputs equal the one-device
     results and every verify launches K1, K2 and K4 once on each rank;
 24. the verify service at full width with the JAX defaults of its
     variables: (a) verify_commit at 10,000 validators, tables warm, p50
     over 10 calls, each launching K1, K2 and K4 once and K5 never, the
     planted commit's blame, and the factory's ServiceBatchVerifier against
     CombBatchVerifier(entry) in turns (the service's own cost); (b) phase
     12's 4,096 CheckTx envelopes through checktx.verify_tx_signature, one
     tx a call from 16 threads, while verify_commit runs: MEMPOOL batches,
     their mean size, the secp launches, every verdict against phase 13's
     and the host oracle, the consensus p50 under the flood, no refusal;
     (c) two tenants flooding MEMPOOL under a tenant quota of 16: the
     rogue tenant refused (scope tenant, checked on the host), the victim
     never; (d) the 10,000-row BLS aggregate commit warm (K14), phase 10's
     tree queried through models/proof_server.prove in requests of 64
     from 8 threads under PROOF (K7 / K8 / K9 once a dispatch, every root
     and proof byte for byte, none answered on the host), one request against a tree evicted between
     its register and its dispatch (proved again on the host by
     _assemble, no launch), and light.verify_adjacent at 10,000
     validators under BACKGROUND;
 25. the blocksync replay at BASELINE.json config 5's width: 5,000
     validators of equal power, 32 commits (the config's 50,000 blocks,
     cut for the time limit) each signed by every validator over its
     Vote sign-bytes, with a flipped sign-bytes byte in one block, a
     foreign key in one and 20% of the rows absent in one: (a)
     blocksync.CommitStreamVerifier under BLOCKSYNC at depth 1 and 2 in
     turns, every block's verdicts against the expected ones (the host
     oracle on the planted rows and 64 sampled rows a block), depth 2
     equal to depth 1, ms a block and blocks/s; (b) the reactor's
     verify-ahead (blocksync.verify_ahead: submit_verify_commit_light,
     depth 2) over the same chain from a cold set, uncached while K3
     builds in the background, then comb, the blocks a route; (c) each
     path's launches; (d) with tracing on, Chrome traces of (a) at depth
     2 and of phase 4's verify_commit under build/, the ms a call of
     every verify.* span and the share of the wall in which the staging
     thread's slab fill overlaps the caller's own work;
 27. the light client at 10,000 validators (light.Client over a MemDB
     LightStore, a chain of 1,000 heights whose set moves by 1,000 keys
     every 100, blocks signed only at the heights asked for): (a) a
     SKIPPING sync 1 -> 1,000 with one honest witness, the trace equal to
     the host's replay of the bisection from the sets' overlaps, every
     stored block decoded back, each new set's hash on K7 + K8 once, each
     hop's commit checks on K2 -> K5 or K1 -> K2 -> K4, its ms and
     launches, the store's decode ms of a 10,000-validator block; cold,
     then from a fresh store with the tables warm (K4, no K5); (b) a
     lunatic primary forked at 700 (another app_hash, the same keys):
     ErrLightClientAttackDetected with evidence to both sides, the
     evidence's common height, byzantine validators and total power
     against a host computation, evidence.verify_light_client_attack on
     the honest chain under CONSENSUS (a trusting and a full check of
     10,000 rows, every signature counted) passing, and refusing the
     evidence with its power + 1 and with a byzantine validator dropped;
     one duplicate vote through verify_duplicate_vote; (c) BASELINE.json
     config 2: a SEQUENTIAL sync over 64 heights of 150 validators, every
     hop K2 -> K5, its p50;
 28. a full node's stores and its JSON-RPC front at 10,000 validators
     (tests/torch_rpc_node.py): (a) GenesisDoc -> make_genesis_state ->
     make_block with 4,096 txs of 256 bytes (data_hash on K7 + K8), its
     PartSet, a commit signed by every validator, BlockStore.save_block
     and StateStore.save over SQLiteDB for 8 heights, the set moving by
     1,000 keys after height 3, every block and part read back with the
     proofs checked; (b) a SKIPPING light.Client syncing 1 -> 8 through
     HTTPProvider over the node's loopback JSON-RPC (the sets' hashes on
     K7 + K8, the commit checks on K2 -> K5 or K1 -> K2 -> K4), every
     light block it fetched equal to the stores' own; (c) VerifyingClient
     reading a block, a commit, a set, a tx and a data proof (merkle_proof
     through the PROOF class: K7 -> K8 -> K9, the class's device minimum
     set to 1 for this lone query), a forged block refused,
     LightProxy answering; (d) EvidencePool over the same stores: a
     duplicate vote added, a tampered one refused, a lunatic attack
     checked under CONSENSUS, both committed in the next block; each
     step's ms and each path's launches;
 26. the verify service's failover, on the card's global service: (a)
     phase 4's verify_commit with failover on (the watchdog ticking, the
     health sentinel started) and off, in turns, their p50s; (b)
     fail_dispatch on phase 7's commit with one flipped signature:
     verified again on the host, the card's blame, one dispatch-error
     re-verify, no trip; (d) slow_collect past a 300-ms client deadline:
     the stall reported twice (the commit and a CheckTx), one artifact,
     the verdicts from the host path; (c) wedge_device on phase 7's
     commit under a 2-s batch deadline: the trip and its time, the
     stranded batch verified on the host in add() order, one forensics
     artifact under build/failover/, then the wedge cleared, the real
     subprocess probe's probation and the restore (the probes' latencies,
     the time to restore), and the 10,000-row commit through K1, K2 and
     K4 once each with phase 2's verdicts; the hub's exposition of the
     verify and health series on a line of its own.

Every phase runs with the service's failover on (COMETBFT_TPU_FAILOVER's
default), and after each one but 26 the run fails unless the service
has made no trip and no host re-verify: a kernel that failed on the card
cannot pass as verdicts from the host.

Needs one CUDA card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
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
# payload widths that are not a multiple of 4, and the rows of each (phase 3)
K1_ODD_WIDTHS = (69, 70, 71, 101, 113, 114, 115, 197, 241, 242, 243, 259)
V_K1_ODD = 1_001
# planted faults: a flipped message byte, s >= L, an undecodable R; absent rows
I_FLIP, I_S_GE_L, I_BAD_R = 4_321, 777, 9_999
ABSENT = [12, 5_000, 8_888]
N_ORACLE_SAMPLE = 256
K4_EDGE_SIZES = (1, 7, 8, 9, 31, 33, 257, 10_001)  # K4's block-edge batches (phase 3)
V_RANK = 2_504  # a world-4 rank's lanes (phase 23): K4 is timed there too
# K5's edge batches (phase 5); 12,288 and 12,289 lanes straddle its change of group width
K5_EDGE_SIZES = (1, 3, 7, 8, 9, 31, 33, 255, 256, 257, 12_288, 12_289)
K3_EDGE_SIZES = (1, 2, 7, 8, 9, 127, 128, 129)  # K3's edge batches (phase 3)
# Run 9m (this script on an NVIDIA H100 80GB HBM3 at 700 W, before K3's and K5's
# redesign; PERF.md), printed beside this run's in the logs; never in the kernels line
RUN_9M = {"K5 16,384 lanes": 3.2597, "K5 256 lanes": 2.9878, "K3 10,000 keys": 9.5967,
          "K3 128 keys (wrapper)": 7.2884, "uncached p50": 24.86, "light-client p50": 4.53,
          "set change first call": 160.8, "churn build beside it": 131.6, "churn build alone": 15.8,
          "peak MiB": 633.6}
# Run 13q (this script on an NVIDIA H100 80GB HBM3 at 700 W, before K2's and
# K14's redesign; PERF.md), printed beside this run's in the logs; never in
# the kernels line
RUN_13Q = {"K2 10,000 rows": 0.0370, "K14 10,000 rows": 0.2541, "K14 finishing stage": 0.1643}
# Run 15a (scripts/torch_short_kernels_ab.py on an NVIDIA H100 80GB HBM3 at 700 W, before K1's and K7's
# redesign; PERF.md): times through a CUDA graph, printed in phases 4 and 11 beside this run's; never in
# the kernels line
RUN_15A = {"K1 10,000 rows": 0.0105, "K7 16,384 x 2": 0.0079, "K7 10,000 x 1": 0.0046}
# The one-thread K4's time at 10,000 lanes (this script on an NVIDIA H100 80GB HBM3 at 700 W, before
# the redesign; PERF.md's run J), printed in phase 4's log beside this run's; never in the kernels line
K4_MS_ONE_THREAD = 0.7288
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
    "build_a_tables_128": (20, 2, 2, 1),  # at the churn bucket's 128 keys
    "verify_cached": (10, 2, 1, 1),
    "verify_batch": (10, 2, 1, 0),  # at 16,384 lanes (the plain version once, cold)
    "verify_batch_256": (20, 2, 2, 1),  # at the light client's 256 lanes
    "assemble_churn": (20, 2, 2, 1),
    "sha256_blocks": (50, 2, 5, 1),  # at the proof tree's 16,384 leaves
    "merkle_tree": (20, 2, 2, 1),  # one launch: every level of the proof tree
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
# K4, per lane, the bound's count: R's decompression, 86 mixed adds of 7,
# the -R add of 9 and 3 doublings of 8
FIELD_MULS_PER_VERIFY = 270 + 86 * 7 + 9 + 3 * 8
# K5, per lane: two decompressions, the -A table (8 conversions, 1
# doubling, 6 cached adds), 64 steps of 4 doublings + a cached add + a
# mixed add, then -R and 3 doublings
FIELD_MULS_PER_STRAUS = 2 * 270 + (8 + 8 + 6 * 8) + 64 * (4 * 8 + 8 + 7) + 9 + 3 * 8


def straus_muls_design(g: int) -> int:
    """K5's multiplies a lane as its group of g threads issues them
    (csrc/straus.cuh), beside the bound's count and never in its place:
    A and R each decoded on g / 2 threads, every cached conversion's 2d T
    on all g, the B-window add as a cached add (8, not 7)."""
    return g * 270 + (8 * g + 8 + 6 * 8) + 64 * (4 * 8 + 8 + 8) + (g + 8 + 3 * 8)


def table_muls_design(g: int) -> int:
    """K3's multiplies a key as its group of g threads issues them
    (csrc/comb_build.cuh): the decoding and each position's cached
    conversion on all g threads, 5 doublings and 3 cached adds a
    position, 3 multiplies an entry forward and 5 back, and on each thread
    the shares' combine (g + 1), one inversion (265) and one more."""
    return g * 270 + 64 * (g + 5 * 8 + 3 * 8) + 512 * 3 + g * (g + 1 + 265 + 1) + 512 * 5
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


def graph_ms(fn, iters: int) -> float:
    """Mean time of fn() on the card by CUDA events around one replay of a
    CUDA graph that holds ``iters`` calls: no host time between launches,
    so a kernel that takes less time than its wrapper's host cost (ctypes
    and Python, ~12-25 us a call) is timed alone, which cuda_ms cannot."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # a warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64).cpu() - b.to(torch.int64).cpu()).abs().max().item())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- secp lane
# The secp256k1 ECDSA lane (K10-K12): a 4,096-transaction CheckTx batch,
# a third in each wire shape, replayed from pools pre-signed with the
# port's host signers (32 senders a shape x 4 transactions, the JAX
# firehose's COMETBFT_TPU_SECP_FIREHOSE_SENDERS), with planted rows of
# every invalid class.
N_SECP = 4_096  # bench.py's top secp batch (verify_secp_tpu_batch_p50_ms)
SECP_SENDERS, SECP_TXS_PER_SENDER = 32, 4
SECP_PAYLOAD = (40, 97)  # sign-bytes 62-119 B: every message fits K12's blocks
SECP_LONG_PAYLOAD = 234  # sign-bytes 256 B: hashed off K12 (host SHA-256, K10)
N_SECP_ORACLE_SAMPLE = 64
SECP_TIMING = {  # (kernel iters, warm-up); the plain versions run once, cold
    "keccak256_blocks": (50, 2),
    "secp": (5, 1),
}
# The one-thread K11 / K12's times at these batches (this script on an
# NVIDIA H100 80GB HBM3 at 700 W, before the redesign), printed in phase
# 14's log beside this run's; never in the kernels line, which holds only
# what this run measured
SECP_MS_ONE_THREAD = {
    "secp_verify_batch": 2.2814, "secp_verify_batch_recover": 2.3968,
    "secp_verify_batch_noglv": 2.8438, "secp_verify_batch_noglv_recover": 3.0166,
    "secp_hash_verify": 2.3407, "secp_hash_verify_recover": 2.4094,
    "secp_hash_verify_noglv": 2.8495, "secp_hash_verify_noglv_recover": 3.0214,
}
# Field multiplies per operation, from the one-thread design of
# csrc/secp256k1.cuh that came first, kept as the bound's yardstick:
# doubling 7, mixed add 11, general add 16, inversion and square root 270;
# a scalar Montgomery multiply (CIOS) is 64 product and 64 reduction
# multiply-adds.
FM_DBL, FM_MADD, FM_ADD, FM_CHAIN = 7, 11, 16, 270
OPS_PER_MONT_MUL = 128 * 4
# Keccak-f per block, from csrc/keccak.cuh: 7,474 32-bit operations
OPS_PER_KECCAK_BLOCK = 7_474
# The one-thread K10's time through a CUDA graph at the long batch's 4,096 x
# 2 blocks (this script on an NVIDIA H100 80GB HBM3 at 700 W, before K10's
# redesign; PERF.md's run 15d), printed in phase 14's log beside this run's;
# never in the kernels line
K10_MS_ONE_THREAD_GRAPH = 0.0137
# K11 / K12's ptxas figures, kept as they were when K10 got its own row
# body (keccak_group.cuh) and K12 kept keccak.cuh's: registers, and bytes
# of stack in the RECOVER instantiations (0 in the others)
SECP_REGISTERS, SECP_STACK_RECOVER = 148, 64


def _nm2_window_muls(n: int) -> int:
    """Montgomery multiplies of sc_inv_mont: 14 table entries, 4 squarings
    per digit after the first, one multiply per nonzero digit."""
    nibs = [((n - 2) >> (4 * i)) & 15 for i in range(63, -1, -1)]
    return 14 + 4 * 63 + sum(1 for d in nibs[1:] if d)


def _signed_digits(k: int, nwin: int) -> list[int]:
    out, carry = [], 0
    for i in range(nwin):
        v = ((k >> (4 * i)) & 15) + carry
        carry = int(v >= 8)
        out.append(v - 16 * carry)
    return out


def secp_row_work(item, glv: bool, fused: bool, mods) -> tuple[int, int, int, int]:
    """(field multiplies, scalar Montgomery multiplies, Keccak blocks,
    SHA-256 blocks) that K11 (fused=False) or K12 (fused=True) spends on
    one row of this run's data, following the branches of the one-thread
    design that came first (the bound's yardstick since then)."""
    host_secp, host_eth, sv, S = mods
    pub, msg, sig = item
    P, N = host_secp.P, host_secp.N
    rec, eth = len(pub) == 20, len(pub) == 65
    kb = sb = 0
    if fused:
        if rec or eth:
            kb = len(msg) // 136 + 1
        else:
            sb = (len(msg) + 9 + 63) // 64
    fm = mm = 0
    fact = None if rec else sv._decode_pub(pub)
    staged = (len(sig) == 65) if rec else (fact is not None and len(sig) == (65 if eth else 64))
    if not staged:
        return 0, 0, 0, 0
    r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:64], "big")
    v = sig[64] if len(sig) == 65 else 0
    if not (0 < r < N and 0 < s <= N // 2 and (v <= 1 or not (rec or eth))):
        return fm, mm, kb, sb
    if rec:
        fm += 3 + FM_CHAIN + 1
        y2 = (pow(r, 3, P) + 7) % P
        y = pow(y2, (P + 1) // 4, P)
        if y * y % P != y2:
            return fm, mm, kb, sb
        if (y & 1) != v:
            y = P - y
    else:
        fm += 4
    h = host_eth.keccak256(msg) if (rec or eth) else hashlib.sha256(msg).digest()
    e = int.from_bytes(h, "big")
    w = pow(r if rec else s, N - 2, N)
    u1 = (-e * w) % N if rec else e * w % N
    u2 = (s if rec else r) * w % N
    mm += 1 + _nm2_window_muls(N) + 2
    fm += FM_DBL + 6 * FM_MADD  # the lane's table of j Q
    if glv:
        halves = [abs(x) for k in (u1, u2) for x in S.split_host(k)]
        mm += 2 * 3
        fm += 2 * 2  # the two 384-bit rounding products, about one field multiply each
        digits = [_signed_digits(k, S.GLV_WINDOWS) for k in halves]
        costs = [FM_MADD, FM_MADD, FM_ADD, FM_ADD + 1]
    else:
        digits = [_signed_digits(k, S.SHAMIR_WINDOWS) for k in (u1, u2)]
        costs = [FM_MADD, FM_ADD]
    top = max((i for d in digits for i, x in enumerate(d) if x), default=-1)
    fm += 4 * max(top, 0) * FM_DBL
    fm += sum(c for d, c in zip(digits, costs) for x in d if x)
    fm += FM_CHAIN + 4  # affine normalisation
    if rec:
        kb += 1  # the address hash
    return fm, mm, kb, sb


# An H100 SM (sm_90): registers, resident threads and blocks, shared
# memory (228 KB, of which each block reserves 1 KB for the system);
# registers are given out to a warp in units of 256
SM_REGS, SM_THREADS, SM_BLOCKS, SM_SMEM, SMEM_RESERVED = 65_536, 2_048, 32, 233_472, 1_024
REG_UNIT = 256


def blocks_per_sm(registers: int, smem: int, threads: int) -> int:
    """The blocks of ``threads`` threads an H100 SM holds at once, from a
    kernel's registers a thread and static shared memory (the figures of
    its ptxas report), as the CUDA occupancy calculator counts them."""
    warps = -(-threads // 32)
    regs_warp = -(-registers * 32 // REG_UNIT) * REG_UNIT
    by_regs = (SM_REGS // regs_warp) // warps if registers else SM_BLOCKS
    by_smem = SM_SMEM // (smem + SMEM_RESERVED)
    return min(by_regs, by_smem, SM_THREADS // threads, SM_BLOCKS)


def ptxas_kernels(report: str, entry_key) -> dict:
    """Registers, static shared memory, stack (the kernel's cumulative
    stack size) and spill bytes of the kernels of one source's kept ptxas
    report, keyed by entry_key(line) of each kernel's "Compiling entry"
    line (None: a kernel not asked for); "any_spill" sums the spills of
    every function in the report."""
    out, cur, any_spill = {}, None, 0
    for line in report.splitlines():
        if "Compiling entry" in line:
            cur = entry_key(line)
            if cur is not None:
                out[cur] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            any_spill += int(m.group(2)) + int(m.group(3))
            if cur and "spill_bytes" not in out[cur]:
                out[cur].update(stack_bytes=int(m.group(1)), spill_bytes=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if cur and m:
            out[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem_bytes"] = int(m.group(1)) if m else 0
            m = re.search(r"(\d+) bytes cumulative stack size", line)
            if m:
                out[cur]["stack_bytes"] = int(m.group(1))
            cur = None
    return {"kernels": out, "any_spill": any_spill}


def secp_phases(dev, rng, log, require, zero_counts, read_counts, cuda_ms, max_abs_err):
    """Phases 12-15 of main(): the secp lane.  Returns (results, times,
    bounds, meta, record) for the kernels JSON line, and the mixed batch
    with its planted rows and phase 13's verdicts for phase 24."""
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto import secp256k1 as host_secp
    from cometbft_tpu_torch.crypto import secp256k1eth as host_eth
    from cometbft_tpu_torch.models import secp_verifier as sv
    from cometbft_tpu_torch.ops import keccak as K
    from cometbft_tpu_torch.ops import secp256k1 as S
    from cometbft_tpu_torch.verifysvc import checktx

    # the block-edge batch's builders, shared with the tests
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_secp_corpus import block_edge_order, infinity_row

    mods = (host_secp, host_eth, sv, S)
    P, N = host_secp.P, host_secp.N
    ktypes = ("secp256k1", "secp256k1eth", "ecrecover")
    signers = {"secp256k1": host_secp.PrivKey, "secp256k1eth": host_eth.PrivKey,
               "ecrecover": host_eth.RecoverPrivKey}

    # ------------------------------------------------ 12. inputs
    t0 = time.perf_counter()
    keys = {kt: [signers[kt].from_seed(rng.bytes(32)) for _ in range(SECP_SENDERS)] for kt in ktypes}

    def pool(payload_len):
        out = {}
        for kt in ktypes:
            txs = []
            for sk in keys[kt]:
                for _ in range(SECP_TXS_PER_SENDER):
                    ln = payload_len if payload_len else int(rng.integers(SECP_PAYLOAD[0], SECP_PAYLOAD[1] + 1))
                    txs.append(checktx.make_signed_tx(sk, rng.bytes(ln)))
            out[kt] = txs
        return out

    pools, long_pools = pool(0), pool(SECP_LONG_PAYLOAD)
    n_signed = 2 * len(ktypes) * SECP_SENDERS * SECP_TXS_PER_SENDER

    def item_of(tx):
        kt, pub, sig, payload = checktx.parse_signed_tx(tx)
        return pub, checktx.SIGN_DOMAIN + payload, sig

    # planted rows: every invalid class of the JAX package's corpus and
    # the firehose storm pool, each from a fresh key
    def planted_rows():
        rows = []

        def signed(kt, tag):
            sk = signers[kt].from_seed(b"planted-" + tag)
            msg = checktx.SIGN_DOMAIN + b"planted " + tag
            return sk, sk.pub_key().data, msg, sk.sign(msg)

        def high_s(sig):
            return sig[:32] + (N - int.from_bytes(sig[32:64], "big")).to_bytes(32, "big") + sig[64:]

        x_ns = 5
        while True:
            y2 = (pow(x_ns, 3, P) + 7) % P
            if pow(y2, (P + 1) // 4, P) ** 2 % P != y2:
                break
            x_ns += 1
        sk, p, m, s = signed("secp256k1", b"c")
        other = host_secp.PrivKey.from_seed(b"planted-other").pub_key().data
        rows += [
            ("tampered signature", (p, m, s[:40] + bytes([s[40] ^ 1]) + s[41:])),
            ("tampered message", (p, m + b"!", s)),
            ("high s", (p, m, high_s(s))),
            ("r = 0", (p, m, bytes(32) + s[32:])),
            ("s = 0", (p, m, s[:32] + bytes(32))),
            ("r >= n", (p, m, N.to_bytes(32, "big") + s[32:])),
            ("s >= n", (p, m, s[:32] + (N + 1).to_bytes(32, "big"))),
            ("wrong key", (other, m, s)),
            ("bad prefix", (b"\x05" + p[1:], m, s)),
            ("x >= p", (b"\x02" + P.to_bytes(32, "big"), m, s)),
            ("off-curve x", (b"\x02" + x_ns.to_bytes(32, "big"), m, s)),
            ("Cosmos key, Ethereum signature length", (p, m, s + b"\x01")),
        ]
        sk, p, m, s = signed("secp256k1eth", b"e")
        rows += [
            ("wrong v", (p, m, s[:64] + bytes([s[64] ^ 1]))),
            ("v = 2", (p, m, s[:64] + b"\x02")),
            ("tampered r", (p, m, bytes([s[0] ^ 1]) + s[1:])),
            ("off-curve Ethereum key", (p[:64] + bytes([p[64] ^ 1]), m, s)),
            ("Ethereum key, Cosmos signature length", (p, m, s[:64])),
            ("high s, flipped v", (p, m, high_s(s[:64] + bytes([s[64] ^ 1])))),
        ]
        sk, p, m, s = signed("ecrecover", b"r")
        rows += [
            ("wrong ecrecover address", (b"\x42" * 20, m, s)),
            ("ecrecover wrong v", (p, m, s[:64] + bytes([s[64] ^ 1]))),
            ("ecrecover r with no square root", (p, m, x_ns.to_bytes(32, "big") + s[32:])),
            ("ecrecover tampered message", (p, m + b"!", s)),
        ]
        return rows

    planted = planted_rows()
    idx_planted = sorted(rng.choice(N_SECP, len(planted), replace=False).tolist())

    def batch_of(pl, shapes=ktypes):
        """(items, planted row indices): pool rows round-robin over the
        shapes, planted rows (those of the shapes) at idx_planted."""
        items = []
        for i in range(N_SECP):
            kt = shapes[i % len(shapes)]
            items.append(item_of(pl[kt][(i // len(shapes)) % len(pl[kt])]))
        rows = []
        for j, i in enumerate(idx_planted):
            if len(planted[j][1][0]) != 20 or "ecrecover" in shapes:
                items[i] = planted[j][1]
                rows.append(i)
        return items, rows

    (mixed, pl_mixed), (no_rec, pl_no_rec) = batch_of(pools), batch_of(pools, ktypes[:2])
    (long_mixed, pl_long), (long_no_rec, pl_long_no_rec) = batch_of(long_pools), batch_of(long_pools, ktypes[:2])
    log(f"[12] secp inputs: {n_signed} signatures in {time.perf_counter() - t0:.1f} s (port host "
        f"signers; {SECP_SENDERS} senders x {SECP_TXS_PER_SENDER} txs x 3 wire shapes, short and "
        f"256-byte sign-bytes), replayed into batches of {N_SECP}; {len(planted)} planted rows at "
        f"{idx_planted[:6]}...: " + "; ".join(lbl for lbl, _ in planted))
    require(all(len(m) <= 119 for _, m, _ in mixed + no_rec), "a short batch message exceeds 119 B")
    require(all(len(m) == 256 for i, (_, m, _) in enumerate(long_mixed) if i not in pl_long),
            "a long batch message is not 256 B")

    # ------------------------------------------------ 13. the paths
    paths = [  # (name, items, GLV, expected launches)
        ("secp_mixed", mixed, "1", {"secp_hash_verify_recover": 1}),
        ("secp_mixed_shamir", mixed, "0", {"secp_hash_verify_noglv_recover": 1}),
        ("secp_no_ecrecover", no_rec, "1", {"secp_hash_verify": 1}),
        ("secp_no_ecrecover_shamir", no_rec, "0", {"secp_hash_verify_noglv": 1}),
        ("secp_long", long_mixed, "1", {"keccak256_blocks": 1, "secp_verify_batch_recover": 1}),
        ("secp_long_shamir", long_mixed, "0", {"keccak256_blocks": 1, "secp_verify_batch_noglv_recover": 1}),
        ("secp_long_no_ecrecover", long_no_rec, "1", {"keccak256_blocks": 1, "secp_verify_batch": 1}),
        ("secp_long_no_ecrecover_shamir", long_no_rec, "0",
         {"keccak256_blocks": 1, "secp_verify_batch_noglv": 1}),
    ]
    secp_names = list(S.LAUNCHES) + ["keccak256_blocks"]
    verdicts, path_counts = {}, {}
    for name, items, glv, want in paths:
        os.environ["COMETBFT_TPU_SECP_GLV"] = glv
        zero_counts()
        bv = cbatch.create_batch_verifier("secp256k1", device=dev)
        for it in items:
            bv.add(*it)
        ok, res = bv.verify()
        got = read_counts(name)
        path_counts[name] = {k: got[k] for k in secp_names}
        verdicts[name] = res
        require(not ok, f"{name}: the planted batch verified")
        require(all(got[k] == want.get(k, 0) for k in secp_names),
                f"{name}: launches {path_counts[name]} != {want}")
    os.environ.pop("COMETBFT_TPU_SECP_GLV", None)
    for a, b in (("secp_mixed", "secp_mixed_shamir"), ("secp_no_ecrecover", "secp_no_ecrecover_shamir"),
                 ("secp_long", "secp_long_shamir"), ("secp_long_no_ecrecover", "secp_long_no_ecrecover_shamir")):
        require(verdicts[a] == verdicts[b], f"GLV and Shamir verdicts differ: {a} / {b}")
    # the host oracle on every planted row and on sampled pool rows
    oracle_rows = {}
    for name, items, pl in (("secp_mixed", mixed, pl_mixed), ("secp_no_ecrecover", no_rec, pl_no_rec),
                            ("secp_long", long_mixed, pl_long),
                            ("secp_long_no_ecrecover", long_no_rec, pl_long_no_rec)):
        pool_rows = [i for i in range(N_SECP) if i not in pl]
        rows = sorted(set(pl) | set(rng.choice(pool_rows, N_SECP_ORACLE_SAMPLE, replace=False).tolist()))
        want = [sv._host_verify_one(*items[i]) for i in rows]
        require([verdicts[name][i] for i in rows] == want, f"{name}: verdicts != host oracle")
        require(not any(verdicts[name][i] for i in pl), f"{name}: a planted row verified")
        require(sum(verdicts[name]) == N_SECP - len(pl), f"{name}: valid-row count")
        oracle_rows[name] = len(rows)
    log(f"[13] secp paths through crypto/batch.create_batch_verifier: every path's verdicts == host "
        f"oracle on the planted and {N_SECP_ORACLE_SAMPLE} sampled rows ({oracle_rows}); GLV == "
        f"Shamir on every batch; launches {json.dumps(path_counts)}")

    # ------------------------------------------------ 14. parity and times
    results, times, bounds = {}, {}, {}
    gtab = S.g_table(dev)
    stages = {
        "hash_verify_recover": (sv.stage_batch(mixed, dev, True, 119), mixed, True, True),
        "hash_verify": (sv.stage_batch(no_rec, dev, True, 119), no_rec, True, False),
        "verify_recover": (sv.stage_batch(long_mixed, dev, False, 119), long_mixed, False, True),
        "verify": (sv.stage_batch(long_no_rec, dev, False, 119), long_no_rec, False, False),
    }
    # K10 on the long batch's Keccak rows, and on rows of 0-300 bytes with
    # stale bytes past each row's last block
    st = stages["verify_recover"][0]
    kb, ka = st["kec_blocks"], st["kec_active"]
    k10 = K.keccak256_blocks(kb, ka)
    p10 = K.keccak256_blocks_plain(kb, ka)
    lens = rng.integers(0, 301, size=N_SECP)
    lens[:6] = [0, 1, 135, 136, 137, 300]
    msgs = [rng.bytes(int(n)) for n in lens]
    sb_np, sa_np = K.pad_messages_keccak(msgs)
    sb_np = sb_np.copy()
    past = np.arange(sb_np.shape[1])[None, :] >= sa_np[:, None]
    sb_np[past] = rng.integers(0, 256, size=(int(past.sum()), K.RATE), dtype=np.uint8)
    sb, sa = torch.from_numpy(sb_np).to(dev), torch.from_numpy(sa_np).to(dev)
    k10s, p10s = K.keccak256_blocks(sb, sa), K.keccak256_blocks_plain(sb, sa)
    torch.cuda.synchronize()
    require(torch.equal(k10, p10) and torch.equal(k10s, p10s), "K10 != plain")
    require([bytes(r) for r in k10s[:64].cpu().numpy()] == [host_eth.keccak256(m) for m in msgs[:64]],
            "K10 != host Keccak")
    results["keccak256_blocks"] = max(max_abs_err(k10, p10), max_abs_err(k10s, p10s))
    out10 = torch.empty_like(k10)
    it, wu = SECP_TIMING["keccak256_blocks"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    K.keccak256_blocks_plain(kb, ka)
    end.record()
    torch.cuda.synchronize()
    times["keccak256_blocks"] = (cuda_ms(lambda: K.launch_k10(kb, ka, out10), it, wu), start.elapsed_time(end))
    act10 = int(ka.sum())
    bounds["keccak256_blocks"] = ("operations", act10 * OPS_PER_KECCAK_BLOCK / INT32_OPS_PER_S,
                                  (kb.numel() + ka.numel() * 4 + kb.shape[0] * 32) / HBM_BYTES_PER_S)
    k10_graph_ms = graph_ms(lambda: K.launch_k10(kb, ka, out10), it)
    # the same rows with the rows at active = 0 left out (the secp lane's Keccak rows alone)
    live10 = ka > 0
    kb_a, ka_a = kb[live10].contiguous(), ka[live10].contiguous()
    out10_a = torch.empty((kb_a.shape[0], 32), dtype=torch.uint8, device=dev)
    K.launch_k10(kb_a, ka_a, out10_a)
    torch.cuda.synchronize()
    require(torch.equal(out10_a, k10[live10]), "K10 on the active rows alone != K10 on the path's batch")
    k10_graph_ms_active = graph_ms(lambda: K.launch_k10(kb_a, ka_a, out10_a), it)
    log(f"[14] K10 == plain on the long batch's {int((ka > 0).sum())} Keccak rows and on {N_SECP} rows "
        f"of 0-300 B with stale bytes; == host Keccak on 64 of them; {times['keccak256_blocks'][0]:.4f} ms by "
        f"events at {kb.shape[0]} x {kb.shape[1]} blocks, {k10_graph_ms:.4f} through a CUDA graph (the one-"
        f"thread K10, run 15d: {K10_MS_ONE_THREAD_GRAPH} ms); {k10_graph_ms_active:.4f} through a graph on the "
        f"{kb_a.shape[0]} active rows alone")
    # K10 at row counts on the edges of its warps (16 pairs) and blocks, 1-3
    # active blocks a row with stale bytes past each row's last block and
    # every 7th row at active = 0 (tests/torch_sha_corpus.py)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_sha_corpus as SC

    warp_rows = 32 // K.THREADS_PER_ROW
    k10_edges = (1, 2, warp_rows - 1, warp_rows, warp_rows + 1, K.ROWS_PER_BLOCK - 1, K.ROWS_PER_BLOCK,
                 K.ROWS_PER_BLOCK + 1, N_SECP + 1)
    for n in k10_edges:
        e_msgs, e_b, e_a = SC.stale_rows_keccak(np.random.default_rng(SEED + 14 + n), n, 3)
        eb, ea = torch.from_numpy(e_b).to(dev), torch.from_numpy(e_a).to(dev)
        got, want = K.keccak256_blocks(eb, ea), K.keccak256_blocks_plain(eb, ea)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"K10 != plain at {n} rows")
        require([bytes(r) for r in got[:64].cpu().numpy()] == SC.digests_keccak(e_msgs[:64], e_a[:64]),
                f"K10 != host Keccak at {n} rows")
        results["keccak256_blocks"] = max(results["keccak256_blocks"], max_abs_err(got, want))
    from cometbft_tpu_torch import _build

    k10_rep = ptxas_kernels(_build.BUILD_LOG["keccak"]["ptxas"], lambda line: "k10" if "k10_kernel" in line else None)
    k10p = k10_rep["kernels"]["k10"]
    require(k10_rep["any_spill"] == 0 and k10p.get("spill_bytes", 1) == 0, f"K10 spills: {k10p}")
    k10_shape = {"threads_per_row": K.THREADS_PER_ROW, "rows_per_block": K.ROWS_PER_BLOCK, **k10p,
                 "graph_ms_active": k10_graph_ms_active, "rows_active": int(kb_a.shape[0])}
    log(f"[14] K10 == plain and the host Keccak at {k10_edges} rows of 1-3 blocks with stale bytes; "
        f"{K.THREADS_PER_ROW} threads a row, {K.ROWS_PER_BLOCK} rows a block; {k10p['registers']} registers, "
        f"{k10p.get('stack_bytes', 0)} bytes of stack, {k10p['spill_bytes']} spilled")

    def secp_entry(line):  # k11_kernel<GLV, RECOVER> / k12_kernel<...> -> LAUNCHES key
        m = re.search(r"(k1[12])_kernelILb([01])ELb([01])E", line)
        return m and S.variant("secp_hash_verify" if m.group(1) == "k12" else "secp_verify_batch",
                               m.group(2) == "1", m.group(3) == "1")

    rep = ptxas_kernels(_build.BUILD_LOG["secp"]["ptxas"], secp_entry)
    ptx = rep["kernels"]
    require(set(ptx) == set(S.LAUNCHES), f"secp.cu's ptxas report names {sorted(ptx)}")
    for name, f in ptx.items():
        require(f.get("spill_bytes", 1) == 0, f"{name} spills: {f}")
        want_ptx = (SECP_REGISTERS, SECP_STACK_RECOVER if "recover" in name else 0)
        require((f.get("registers"), f.get("stack_bytes", 0)) == want_ptx,
                f"{name}: ptxas figures {f} moved from {want_ptx} (registers, stack)")
    require(rep["any_spill"] == 0, f"a function of secp.cu spills {rep['any_spill']} bytes")
    nrb = S.ROWS_PER_BLOCK
    kshape = {name: {"threads_per_row": S.THREADS_PER_ROW, "rows_per_block": nrb,
                     "blocks_per_sm": blocks_per_sm(ptx[name]["registers"], ptx[name]["smem_bytes"],
                                                    S.THREADS_PER_ROW * nrb), **ptx[name]}
              for name in S.LAUNCHES}
    for kind, (st, items, fused, recover) in stages.items():
        rows = (st["qx"], st["qy"], st["q_valid"])
        tail = (st["is_eth"], st["v"], st["is_rec"], st["addr"], gtab)
        if fused:
            hb = (st["sha_blocks"], st["sha_active"], st["kec_blocks"], st["kec_active"])
        else:
            e = sv.staged_e(st)
        for glv in (True, False):
            name = S.variant("secp_hash_verify" if fused else "secp_verify_batch", glv, recover)
            if fused:
                kern = lambda g=glv: S.hash_verify_batch(*hb, *rows, st["r"], st["s"], *tail, glv=g, recover=recover)
                plain = lambda g=glv: S.hash_verify_batch_plain(*hb, *rows, st["r"], st["s"], *tail, glv=g,
                                                                recover=recover)
            else:
                kern = lambda g=glv: S.verify_batch(*rows, e, st["r"], st["s"], *tail, glv=g, recover=recover)
                plain = lambda g=glv: S.verify_batch_plain(*rows, e, st["r"], st["s"], *tail, glv=g,
                                                           recover=recover)
            got = kern()
            start.record()
            want = plain()
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            require(torch.equal(got, want), f"{name} != plain")
            require(got[:N_SECP].tolist() == verdicts["secp_mixed" if recover and fused else
                                                       "secp_no_ecrecover" if fused else
                                                       "secp_long" if recover else
                                                       "secp_long_no_ecrecover"],
                    f"{name} != the path's verdicts")
            results[name] = max_abs_err(got, want)
            it, wu = SECP_TIMING["secp"]
            times[name] = (cuda_ms(kern, it, wu), plain_ms)
            work = [secp_row_work(x, glv, fused, mods) for x in items]
            fm, mm, kbl, sbl = (sum(w[i] for w in work) for i in range(4))
            ops = fm * OPS_PER_FIELD_MUL + mm * OPS_PER_MONT_MUL + kbl * OPS_PER_KECCAK_BLOCK + sbl * OPS_PER_SHA256_BLOCK
            nbytes = N_SECP * (5 * 32 + 3 + 4 + 20 + 1) + (
                st["sha_blocks"].numel() + st["kec_blocks"].numel() + 8 * N_SECP if fused else 0)
            bounds[name] = ("operations", ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
            ks = kshape[name]
            log(f"[14] {name} == plain on all {N_SECP} rows (plain {plain_ms:.1f} ms, once, cold); "
                f"{times[name][0]:.4f} ms (one thread a row: {SECP_MS_ONE_THREAD[name]} ms); {ks['threads_per_row']} threads a row, "
                f"{ks['rows_per_block']} rows a block, {ks['blocks_per_sm']} blocks an SM; {ks['registers']} "
                f"registers, {ks['stack_bytes']} bytes of stack, {ks['spill_bytes']} spilled; work: {fm} field "
                f"and {mm} scalar multiplies, {kbl} Keccak and {sbl} SHA-256 blocks")

    # the block-edge batch (as tests/test_torch_cuda.py): invalid rows at
    # every block's first and last row and between valid ones, a block
    # whose only valid row sits beside a row at infinity, a partial last
    # block; every instantiation against its plain version and the oracle
    inf_row = infinity_row(b"smoke")
    pool_rows = [r for r in mixed[:64] if sv._host_verify_one(*r)]
    edge_items = pool_rows + [x for _, x in planted] + [inf_row]
    edge_want = [sv._host_verify_one(*x) for x in edge_items]
    require(not edge_want[-1], "the infinity row verified on the host")
    n_edge = 3 * nrb + 5
    for recover in (True, False):
        keep = [i for i, x in enumerate(edge_items) if recover or len(x[0]) != sv.ECR_PUB]
        good = [i for i in keep if edge_want[i]]
        bad = [i for i in keep if not edge_want[i]]
        order = block_edge_order(good, bad, len(edge_items) - 1, n_edge, nrb)
        batch = [edge_items[i] for i in order]
        for fused in (True, False):
            st = sv.stage_batch(batch, dev, fused, 119)
            rows = (st["qx"], st["qy"], st["q_valid"])
            tail = (st["is_eth"], st["v"], st["is_rec"], st["addr"], gtab)
            e = None if fused else sv.staged_e(st)
            for glv in (True, False):
                name = S.variant("secp_hash_verify" if fused else "secp_verify_batch", glv, recover)
                if fused:
                    hb = (st["sha_blocks"], st["sha_active"], st["kec_blocks"], st["kec_active"])
                    got = S.hash_verify_batch(*hb, *rows, st["r"], st["s"], *tail, glv=glv, recover=recover)
                    want = S.hash_verify_batch_plain(*hb, *rows, st["r"], st["s"], *tail, glv=glv, recover=recover)
                else:
                    got = S.verify_batch(*rows, e, st["r"], st["s"], *tail, glv=glv, recover=recover)
                    want = S.verify_batch_plain(*rows, e, st["r"], st["s"], *tail, glv=glv, recover=recover)
                torch.cuda.synchronize()
                require(torch.equal(got, want), f"{name} != plain on the block-edge batch")
                require(got[:n_edge].tolist() == [edge_want[i] for i in order],
                        f"{name} != host oracle on the block-edge batch")
                results[name] = max(results[name], max_abs_err(got, want))
    log(f"[14] the eight K11 / K12 instantiations == plain and the host oracle on the block-edge batch "
        f"({n_edge} rows, {nrb}-row blocks: invalid rows at every block's edges, one valid row beside an "
        f"infinity row, a partial block)")

    # ------------------------------------------------ 15. end to end
    p50s, phases = {}, {}
    for name, items, glv in (("secp_mixed", mixed, "1"), ("secp_mixed_shamir", mixed, "0"),
                             ("secp_long", long_mixed, "1")):
        os.environ["COMETBFT_TPU_SECP_GLV"] = glv
        walls, ph = [], []
        for _ in range(12):
            bv = cbatch.create_batch_verifier("secp256k1", device=dev)
            for x in items:
                bv.add(*x)
            t0 = time.perf_counter()
            _, res = bv.verify()
            walls.append((time.perf_counter() - t0) * 1e3)
            ph.append(dict(bv.last_timings))
            require(res == verdicts[name], f"{name}: a timed call's verdicts moved")
        p50s[name] = float(np.median(walls[2:]))
        phases[name] = {k: float(np.median([p[k] for p in ph[2:]])) for k in ph[0]}
    os.environ.pop("COMETBFT_TPU_SECP_GLV", None)
    log(f"[15] SecpBatchVerifier.verify p50 over 10 calls after 2, {N_SECP} rows (ms): "
        f"{json.dumps({k: round(v, 3) for k, v in p50s.items()})}; phases p50: "
        + json.dumps({k: {a: round(b, 3) for a, b in v.items()} for k, v in phases.items()}))

    src_secp = "cometbft_tpu_torch/csrc/secp.cu"
    meta = {"keccak256_blocks": ("K10", "cometbft_tpu_torch/csrc/keccak.cu", "cometbft_tpu/ops/keccak.py:144",
                                 ["keccak256_blocks"])}
    rows_of = {
        "secp_verify_batch": "secp256k1_verify_batch", "secp_verify_batch_recover": "secp256k1_verify_batch_recover",
        "secp_verify_batch_noglv": "secp256k1_verify_batch_noglv",
        "secp_verify_batch_noglv_recover": "secp256k1_verify_batch_noglv_recover",
        "secp_hash_verify": "secp256k1_hash_verify", "secp_hash_verify_recover": "secp256k1_hash_verify_recover",
    }
    for name in S.LAUNCHES:
        k12 = name.startswith("secp_hash_verify")
        tag = ("K12" if k12 else "K11") + "<%d,%d>" % ("noglv" not in name, "recover" in name)
        meta[name] = (tag, src_secp, "cometbft_tpu/ops/secp256k1.py:" + ("996" if k12 else "861"),
                      [rows_of[name]] if name in rows_of else [])
    record = {"secp_p50_ms": p50s, "secp_phases_p50_ms": phases, "secp_rows": N_SECP, "secp_kernels": kshape,
              "secp_decode_cache": dict(sv.CACHE_STATS),
              "secp_planted": len(planted), "secp_path_launches": path_counts, "k10_graph_ms": k10_graph_ms,
              "k10_shape": k10_shape}
    inputs = {"items": mixed, "planted": pl_mixed, "verdicts": verdicts["secp_mixed"]}  # phase 24's flood
    return results, times, bounds, meta, record, inputs


# ---------------------------------------------------------------- BLS lane
# The BLS12-381 lane (K13-K15): a 10,000-validator aggregate commit (the
# main path's set width and bench.py's metric of record), 64 individually
# signed rows, and verify_commit over a 512-validator BLS set.  Keys are
# secrets in a progression sk_i = a + i b (mod r) from the seed, so that
# pk_i = pk_(i-1) + b G is one Jacobian add a key (the host signer's
# ~9 ms a key would take 90 s); the aggregate signature is (sum sk_i)
# H(m), one G2 multiply.  The kernels' work does not depend on the keys'
# discrete logarithms.
N_BLS = 10_000
N_BLS_SINGLES = 64
V_BLS_COMMIT = 512  # >= COMETBFT_TPU_BLS_AGG_DEVICE_MIN: the warm call reaches K14
N_BLS_ORACLE_SAMPLE = 256
BLS_WARM_CALLS = 7  # p50 over the last 5
# planted keys (phase 16): wrong subgroup, x >= p, the infinity encoding, off-curve x
BLS_PLANTED = {17: "wrong subgroup", 4_242: "x >= p", 7_777: "infinity", 9_998: "off-curve x"}
BLS_TIMING = {"validate_g1": (5, 1), "validate_aggregate_g1": (5, 1), "aggregate_g1": (20, 2)}
# field multiplies (csrc/bls381.cuh): doubling 7, mixed add 11, general add
# 16, the on-curve check 3; of them squares 5, 3, 4 and 2.  A multiply is
# 288 32x32->64 multiply-adds, a square 222 (its 66 cross terms once): the
# bound's unit, the function's work.  Every multiply at 288, squares
# included, is printed beside it.
FM_BLS_DBL, FM_BLS_MADD, FM_BLS_ADD, FM_BLS_CURVE = 7, 11, 16, 3
SQ_BLS_DBL, SQ_BLS_MADD, SQ_BLS_ADD, SQ_BLS_CURVE = 5, 3, 4, 2
MULADDS_BLS_MUL, MULADDS_BLS_SQ = 288, 222
OPS_PER_MULADD = 4


def bls_keys(H, a: int, b: int, n: int):
    """Affine public keys of the secrets a + i b, i < n: a Jacobian add a
    key, the Z's inverted together (Montgomery's trick)."""
    F, P = H._FP, H.P
    step = H._jac_mul(F, H._from_affine(F, H.G1_GEN), b)
    acc, jac = H._jac_mul(F, H._from_affine(F, H.G1_GEN), a), []
    for _ in range(n):
        jac.append(acc)
        acc = H._jac_add(F, acc, step)
    pre = [1]
    for _, _, z in jac:
        pre.append(pre[-1] * z % P)
    inv, out = pow(pre[-1], P - 2, P), [None] * n
    for i in range(n - 1, -1, -1):
        zi, inv = inv * pre[i] % P, inv * jac[i][2] % P
        z2 = zi * zi % P
        out[i] = (jac[i][0] * z2 % P, jac[i][1] * z2 * zi % P)
    return out


def bls_g2_mul(H, q, k: int):
    return H._to_affine(H._FP2, H._jac_mul(H._FP2, H._from_affine(H._FP2, q), k))


def bls_tree_work(live: list[bool], TILE: int, FINISH: int) -> int:
    """General adds of K14's stages with both operands non-identity, for
    rows whose identity flags are ``not live`` (an add with an identity
    operand copies the other point)."""
    def tree(flags):
        adds, s = 0, len(flags) // 2
        flags = list(flags)
        while s >= 1:
            for t in range(s):
                adds += flags[t] and flags[t + s]
                flags[t] = flags[t] or flags[t + s]
            s //= 2
        return adds, flags[0]
    n = len(live)
    g = -(-n // TILE)
    adds, parts = 0, []
    for b in range(g):
        tile = live[b * TILE:(b + 1) * TILE]
        a, f = tree(tile + [False] * (TILE - len(tile)))
        adds += a
        parts.append(f)
    lanes = [False] * FINISH
    for j, f in enumerate(parts):
        adds += lanes[j % FINISH] and f
        lanes[j % FINISH] = lanes[j % FINISH] or f
    return adds + tree(lanes)[0]


def bls_phases(dev, rng, log, require, zero_counts, read_counts, cuda_ms, max_abs_err):
    """Phases 16-20 of main(): the BLS lane.  Returns (results, times,
    bounds, meta, record) for the kernels JSON line, and the aggregate
    commit's rows for phase 24."""
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto import bls12381 as H
    from cometbft_tpu_torch.crypto import merkle as cmerkle
    from cometbft_tpu_torch.models import bls_verifier as M
    from cometbft_tpu_torch.ops import bls381 as B
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.verifysvc import MODE_BLS
    from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE, Timestamp

    P, R = H.P, H.R
    names = list(B.LAUNCHES)
    pairings = {"n": 0}
    real_pairing = H._pairings_product_is_one

    def counted_pairing(pairs):
        pairings["n"] += 1
        return real_pairing(pairs)

    H._pairings_product_is_one = counted_pairing
    t_lane = time.perf_counter()

    # ------------------------------------------------ 16. inputs
    t0 = time.perf_counter()
    a, b = (int.from_bytes(rng.bytes(32), "big") % R for _ in range(2))
    affs = bls_keys(H, a, b, N_BLS)
    pubs = [H._g1_compress(p) for p in affs]
    bid = T.BlockID(hash=rng.bytes(32), part_set_header=T.PartSetHeader(total=1, hash=rng.bytes(32)))
    msg = T.Vote(type=PRECOMMIT_TYPE, height=77, round=0, block_id=bid,
                 timestamp=Timestamp(seconds=TS_SECONDS)).sign_bytes(CHAIN_ID)
    hm = H.hash_to_g2(msg)
    sk_sum = (a * N_BLS + b * N_BLS * (N_BLS - 1) // 2) % R
    agg = H._g2_compress(bls_g2_mul(H, hm, sk_sum))
    t_inputs = time.perf_counter() - t0
    # the shortcut against the host signer on the first 8 keys
    first = [H.PrivKey((a + i * b) % R) for i in range(8)]
    require([k.pub_key().data for k in first] == pubs[:8], "progression keys != PrivKey.pub_key")
    require(H.aggregate_signatures([k.sign(msg) for k in first])
            == H._g2_compress(bls_g2_mul(H, hm, sum(k._sk for k in first) % R)),
            "aggregate_signatures of 8 signatures != (sum sk) H(m)")
    # planted keys (tests/test_bls_verify.py recipes)
    x = 1
    while True:
        y = H._fp_sqrt((x ** 3 + 4) % P)
        if y is not None and not H._in_subgroup(H._FP, (x, y)):
            break
        x += 1
    x_off = 5
    while H._fp_sqrt((x_off ** 3 + 4) % P) is not None:
        x_off += 1
    bad = {"wrong subgroup": H._g1_compress((x, y)), "x >= p": bytes([0x9F]) + b"\xff" * 47,
           "infinity": bytes([0xC0]) + b"\x00" * 47,
           "off-curve x": bytes([0x80 | (x_off >> 376)]) + x_off.to_bytes(48, "big")[1:]}
    planted_pubs = list(pubs)
    for i, label in BLS_PLANTED.items():
        planted_pubs[i] = bad[label]
    log(f"[16] BLS inputs: {N_BLS} keys (secrets a + i b from the seed) and the aggregate signature "
        f"in {t_inputs:.2f} s; the first 8 keys == PrivKey.pub_key and their aggregate_signatures == "
        f"(sum sk) H(m) byte for byte; sign-bytes {len(msg)} B; planted {BLS_PLANTED}; pairing core "
        f"{os.path.relpath(H._native_pairing_lib()._name)}")

    # ------------------------------------------------ 17. the aggregate commit
    path_counts, timings, walls = {}, {}, {}

    def drive(name, items, want_ok, want_launch, want_pairings=None, calls=1):
        """``calls`` verifies of ``items``, each through a new verifier
        from the factory, the counts zeroed before the first and read
        after the last -> [(wall ms, last_timings)] per call."""
        zero_counts()
        out = []
        for _ in range(calls):
            pairings["n"] = 0
            bv = cbatch.create_batch_verifier("bls12_381", pubkeys=[p for p, _, _ in items], device=dev)
            require(bv.mode == MODE_BLS, f"{name}: factory gave mode {bv.mode}")
            for it in items:
                bv.add(*it)
            t0 = time.perf_counter()
            ok, res = bv.verify()
            out.append(((time.perf_counter() - t0) * 1e3, dict(bv.last_timings)))
            require((ok, res) == want_ok, f"{name}: verdicts ({ok}, {sum(res)} rows True) != expected")
            if want_pairings is not None:
                require(pairings["n"] == want_pairings, f"{name}: {pairings['n']} pairings")
        got = read_counts(name)
        path_counts[name] = {k: got[k] for k in names}
        want = dict(dict.fromkeys(names, 0), **{k: v * calls for k, v in want_launch.items()})
        require(path_counts[name] == want, f"{name}: launches {path_counts[name]} != {want}")
        return out if calls > 1 else out[0]

    commit_items = [(p, msg, agg) for p in pubs]
    M.reset_caches()
    walls["cold"], timings["cold"] = drive("bls_commit_cold", commit_items, (True, [True] * N_BLS),
                                           {"validate_aggregate_g1": 1, "aggregate_g1_finish": 1}, 1)
    warm = drive("bls_commit_warm", commit_items, (True, [True] * N_BLS),
                 {"aggregate_g1": 1, "aggregate_g1_finish": 1}, 1, calls=BLS_WARM_CALLS)
    walls["warm"] = float(np.median([w for w, _ in warm[2:]]))
    timings["warm"] = {key: float(np.median([t[key] for _, t in warm[2:]])) for key in warm[2][1]}
    forged = H._g2_compress(bls_g2_mul(H, hm, (sk_sum + 1) % R))
    walls["forged"], timings["forged"] = drive(
        "bls_commit_forged", [(p, msg, forged) for p in pubs], (False, [False] * N_BLS),
        {"aggregate_g1": 1, "aggregate_g1_finish": 1}, 1)
    M.reset_caches()
    walls["planted"], timings["planted"] = drive(
        "bls_commit_planted", [(p, msg, agg) for p in planted_pubs], (False, [False] * N_BLS),
        {"validate_aggregate_g1": 1, "aggregate_g1_finish": 1}, 0)
    # K15's verdicts, as the fact cache holds them, against the host oracle
    pool = [i for i in range(N_BLS) if i not in BLS_PLANTED]
    sample = sorted(set(BLS_PLANTED) | set(rng.choice(pool, N_BLS_ORACLE_SAMPLE, replace=False).tolist()))
    cache = M._pk_cache()

    def host_ok(pub):
        aff = M._decode_pub(pub)
        return aff is not None and H._on_curve(H._FP, aff) and H._in_subgroup(H._FP, aff)

    oracle = [host_ok(planted_pubs[i]) for i in sample]
    require([cache.get(planted_pubs[i]) is not None for i in sample] == oracle,
            "K15's verdicts (the fact cache) != host oracle")
    require(sum(oracle) == len(sample) - len(BLS_PLANTED), "the oracle passed a planted key")
    log(f"[17] aggregate commit of {N_BLS} through crypto/batch.create_batch_verifier: cold "
        f"{walls['cold']:.1f} ms {json.dumps({k: round(v, 2) for k, v in timings['cold'].items()})}; warm p50 "
        f"{walls['warm']:.2f} ms over {BLS_WARM_CALLS - 2} calls after 2 "
        f"{json.dumps({k: round(v, 2) for k, v in timings['warm'].items()})}; forged aggregate: every row "
        f"False after one pairing ({walls['forged']:.1f} ms); planted batch: every row False, K15's "
        f"verdicts == host oracle on {len(sample)} rows ({len(BLS_PLANTED)} planted)")

    # ------------------------------------------------ 18. 64 individually signed rows
    a2, b2 = (int.from_bytes(rng.bytes(32), "big") % R for _ in range(2))
    msg2 = b"cometbft-tpu-torch smoke: individually signed rows"
    hm2 = H.hash_to_g2(msg2)
    s_jac = H._from_affine(H._FP2, bls_g2_mul(H, hm2, a2))
    s_step = H._from_affine(H._FP2, bls_g2_mul(H, hm2, b2))
    singles, spubs = [], [H._g1_compress(p) for p in bls_keys(H, a2, b2, N_BLS_SINGLES)]
    for j in range(N_BLS_SINGLES):
        singles.append((spubs[j], msg2, H._g2_compress(H._to_affine(H._FP2, s_jac))))
        s_jac = H._jac_add(H._FP2, s_jac, s_step)
    require(singles[1][2] == H.PrivKey((a2 + b2) % R).sign(msg2), "progression signature != PrivKey.sign")
    walls["singles"], timings["singles"] = drive(
        "bls_singles", singles, (True, [True] * N_BLS_SINGLES), {"validate_g1": 1}, 1)
    forged_row = N_BLS_SINGLES // 4
    bad_singles = list(singles)
    # another message's aggregate signature: a valid point no other row carries
    bad_singles[forged_row] = (singles[forged_row][0], msg2, agg)
    walls["singles_forged"], _ = drive(
        "bls_singles_forged", bad_singles,
        (False, [j != forged_row for j in range(N_BLS_SINGLES)]), {}, 1 + N_BLS_SINGLES)
    log(f"[18] {N_BLS_SINGLES} individually signed rows ({N_BLS_SINGLES} units, keys outside the set): K13 once, one "
        f"{N_BLS_SINGLES + 1}-pair product, {walls['singles']:.1f} ms "
        f"{json.dumps({k: round(v, 2) for k, v in timings['singles'].items()})}; one forged row: only its "
        f"unit False ({walls['singles_forged']:.1f} ms, {N_BLS_SINGLES + 1} pairings)")

    # ------------------------------------------------ 19. verify_commit over a BLS set
    t0 = time.perf_counter()
    a3, b3 = (int.from_bytes(rng.bytes(32), "big") % R for _ in range(2))
    vpubs = [H._g1_compress(p) for p in bls_keys(H, a3, b3, V_BLS_COMMIT)]
    vals = T.ValidatorSet([T.Validator(H.PubKey(p), 10) for p in vpubs])  # the host subgroup check per key
    t_set = time.perf_counter() - t0
    height = 88
    cbid = T.BlockID(hash=rng.bytes(32), part_set_header=T.PartSetHeader(total=1, hash=rng.bytes(32)))
    ts = Timestamp(seconds=TS_SECONDS)  # one timestamp: identical sign-bytes on every row
    sbs = {T.Vote(type=PRECOMMIT_TYPE, height=height, round=0, block_id=cbid, timestamp=ts,
                  validator_address=v.address, validator_index=i).sign_bytes(CHAIN_ID)
           for i, v in enumerate(vals.validators)}
    require(len(sbs) == 1, "the commit's sign-bytes differ between rows")
    (sb,) = sbs
    agg3 = H._g2_compress(bls_g2_mul(H, H.hash_to_g2(sb),
                                     (a3 * V_BLS_COMMIT + b3 * V_BLS_COMMIT * (V_BLS_COMMIT - 1) // 2) % R))
    commit = T.Commit(height=height, round=0, block_id=cbid, signatures=[
        T.CommitSig(2, v.address, ts, agg3) for v in vals.validators])
    vhash = vals.hash(device=dev)  # K7 + K8, outside the counted windows
    require(vhash == cmerkle.hash_from_byte_slices([v.bytes() for v in vals.validators], device=False),
            "the BLS set's hash != hashlib's")
    vc = {}
    M.reset_caches()
    for name, want in (("bls_verify_commit_cold", {"validate_aggregate_g1": 1, "aggregate_g1_finish": 1}),
                       ("bls_verify_commit_warm", {"aggregate_g1": 1, "aggregate_g1_finish": 1})):
        zero_counts()
        t0 = time.perf_counter()
        validation.verify_commit(CHAIN_ID, vals, cbid, height, commit, device=dev)
        vc[name] = (time.perf_counter() - t0) * 1e3
        got = read_counts(name)
        path_counts[name] = {k: got[k] for k in names}
        require(path_counts[name] == dict(dict.fromkeys(names, 0), **want),
                f"{name}: launches {path_counts[name]} != {want}")
    tampered_sigs = list(commit.signatures)
    k_t = V_BLS_COMMIT // 4 + 9
    cs = tampered_sigs[k_t]
    tampered_sigs[k_t] = T.CommitSig(2, cs.validator_address, cs.timestamp, singles[0][2])
    tampered = T.Commit(height=height, round=0, block_id=cbid, signatures=tampered_sigs)
    try:
        validation.verify_commit(CHAIN_ID, vals, cbid, height, tampered, device=dev)
    except validation.CommitVerificationError as e:
        blame = str(e)
    else:
        raise AssertionError("the tampered BLS commit verified")
    # the tampered row's unit and the 511-row unit both fail: blame on #0
    require(blame.startswith("wrong signature (#0): "), f"blame {blame[:40]!r}")
    log(f"[19] verify_commit over a {V_BLS_COMMIT}-validator BLS set (PubKey checks {t_set:.1f} s): "
        f"ValidatorSet.hash {vhash.hex()}; cold {vc['bls_verify_commit_cold']:.1f} ms (K15), warm "
        f"{vc['bls_verify_commit_warm']:.1f} ms (K14); tampered row {k_t}: {blame[:40]}...")

    # ------------------------------------------------ 20. parity and times
    results, times, bounds = {}, {}, {}
    decoded = [M._decode_pub(p) for p in planted_pubs]
    X, Y, valid = B.pack_affine(decoded)
    Xd, Yd, vd = (torch.from_numpy(t_).to(dev) for t_ in (X, Y, valid))
    vd8 = vd.to(torch.uint8)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def plain_timed(fn):
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    ok13 = B.validate_g1(Xd, Yd, vd)
    p13, plain13 = plain_timed(lambda: B.validate_g1_plain(Xd, Yd, vd))
    require(torch.equal(ok13, p13), "K13 != plain")
    require([bool(ok13[i]) for i in sample] == oracle, "K13 != host oracle")
    results["validate_g1"] = max_abs_err(ok13, p13)
    k15 = B.validate_aggregate_g1(Xd, Yd, vd)
    p15, plain15 = plain_timed(lambda: B.validate_aggregate_g1_plain(Xd, Yd, vd))
    require(all(torch.equal(g, w) for g, w in zip(k15, p15)), "K15 != plain")
    require(torch.equal(k15[0], ok13), "K15's verdicts != K13's")
    results["validate_aggregate_g1"] = max(max_abs_err(g, w) for g, w in zip(k15, p15))
    live = ok13.tolist()
    acc = (1, 1, 0)
    for aff, o in zip(decoded, live):
        if o:
            acc = H._jac_add(H._FP, acc, H._from_affine(H._FP, aff))
    host_sum = H._to_affine(H._FP, acc)
    require(B.jac_to_affine_host(*(t_.cpu() for t_ in k15[1:])) == host_sum, "K15's sum != host sum")
    Zd = torch.from_numpy(np.broadcast_to(B.ints_to_words_np([B.ONE_M]), (N_BLS, B.NWORDS)).copy()).to(dev)
    Xk, Yk = (torch.from_numpy(t_).to(dev) for t_ in B.pack_affine(affs)[:2])
    k14 = B.aggregate_g1(Xk, Yk, Zd)
    p14, plain14 = plain_timed(lambda: B.aggregate_g1_plain(Xk, Yk, Zd))
    require(all(torch.equal(g, w) for g, w in zip(k14, p14)), "K14 != plain")
    results["aggregate_g1"] = max(max_abs_err(g, w) for g, w in zip(k14, p14))
    acc = (1, 1, 0)
    for aff in affs:
        acc = H._jac_add(H._FP, acc, H._from_affine(H._FP, aff))
    require(B.jac_to_affine_host(*(t_.cpu() for t_ in k14)) == H._to_affine(H._FP, acc), "K14's sum != host sum")
    # K15 on block-edge batches: every failing class at the first and last
    # row of each group of 8 rows and each tile's last, rows of order 3 and
    # 11 (equal, opposite and infinite operands mid-ladder), batches that
    # all fail before the ladder (tests/torch_bls_corpus.py); ok bytes over
    # a poisoned buffer against the corpus, K13 and plain
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_bls_corpus as BC

    edge_cases = [("mixed", n) for n in BC.EDGE_SIZES] + [("small", 33), ("prefail", 9)]
    # Depth cut, for the run's time limit: the plain K15 once over
    # every edge batch's rows together (its verdicts are row by row),
    # where it ran once a batch (~4-5 s a call at any small N: nine calls
    # of the lane's 150-191 s); each batch's triple is held against the
    # host sum of its valid rows.  The two smallest batches, where the
    # tile and finishing stages split most unevenly, keep a plain call of
    # their own and their triple word for word; so does the 10,000-row
    # parity below.
    word_for_word = {("small", 33), ("prefail", 9)}
    edge_b = [BC.batch(n_e, SEED + n_e, mode) for mode, n_e in edge_cases]
    edge_in = [tuple(torch.from_numpy(t_).to(dev) for t_ in BC.pack(b_e)) for b_e in edge_b]
    p_all = B.validate_aggregate_g1_plain(*(torch.cat([e[k] for e in edge_in]) for k in range(3)))[0]
    off_e = 0
    for (mode, n_e), b_e, (Xe, Ye, ve) in zip(edge_cases, edge_b, edge_in):
        ok_e = torch.full((n_e,), 0xAA, dtype=torch.uint8, device=dev)
        all_e = torch.ones((1,), dtype=torch.uint8, device=dev)
        tri_e = torch.empty((B.PT_WORDS,), dtype=torch.int32, device=dev)
        B.launch_k15(Xe, Ye, ve.to(torch.uint8), ok_e, all_e, B._scratch(n_e, dev), tri_e)
        p_e = p_all[off_e : off_e + n_e]
        off_e += n_e
        k13_e = B.validate_g1(Xe, Ye, ve)
        torch.cuda.synchronize()
        require(ok_e.tolist() == [int(e) for e in b_e["expect"]], f"K15 != the corpus on {mode} {n_e}")
        require(torch.equal(ok_e.bool(), p_e) and torch.equal(ok_e.bool(), k13_e),
                f"K15 != plain / K13 on {mode} {n_e}")
        require(int(all_e) == int(all(b_e["expect"])), f"K15's all-ok byte on {mode} {n_e}")
        acc_e = (1, 1, 0)
        for pt, e in zip(b_e["points"], b_e["expect"]):
            if e:
                acc_e = H._jac_add(H._FP, acc_e, H._from_affine(H._FP, pt))
        tri_w = (tri_e[:B.NWORDS], tri_e[B.NWORDS:2 * B.NWORDS], tri_e[2 * B.NWORDS:])
        require(B.jac_to_affine_host(*(t_.cpu() for t_ in tri_w)) == H._to_affine(H._FP, acc_e),
                f"K15's triple != the host sum on {mode} {n_e}")
        if (mode, n_e) in word_for_word:
            pw = B.validate_aggregate_g1_plain(Xe, Ye, ve)
            require(torch.equal(pw[0], p_e) and all(torch.equal(g, w) for g, w in zip(tri_w, pw[1:])),
                    f"K15's triple != plain word for word on {mode} {n_e}")
        results["validate_aggregate_g1"] = max(results["validate_aggregate_g1"], max_abs_err(ok_e, p_e))
    log(f"[20] K15 == the corpus, K13 and plain (ok bytes over 0xAA, the all-ok byte; the triple == the host "
        f"sum of the valid rows) on {len(edge_cases)} edge batches: " + ", ".join(f"{m} {n}" for m, n in edge_cases)
        + "; depth cut for the run's time limit: one plain K15 call over the edge batches' rows "
        "together, where it ran once a batch; the triple == plain word for word on "
        + ", ".join(f"{m} {n}" for m, n in sorted(word_for_word)))
    log(f"[20] K13, K15 == plain on all {N_BLS} planted rows (ok bytes and the triple word for word), K13 "
        f"== host oracle on {len(sample)} rows, K15's sum == the host sum of the {sum(live)} valid rows; "
        f"K14 == plain on the {N_BLS} keys, its sum == the host sum; plain ms (once, cold): K13 "
        f"{plain13:.1f}, K15 {plain15:.1f}, K14 {plain14:.1f}")

    ok_b = torch.empty((N_BLS,), dtype=torch.uint8, device=dev)
    all_b = torch.ones((1,), dtype=torch.uint8, device=dev)
    part = B._scratch(N_BLS, dev)
    tri = torch.empty((B.PT_WORDS,), dtype=torch.int32, device=dev)
    it, wu = BLS_TIMING["validate_g1"]
    times["validate_g1"] = (cuda_ms(lambda: B.launch_k13(Xd, Yd, vd8, ok_b, all_b), it, wu), plain13)
    it, wu = BLS_TIMING["validate_aggregate_g1"]
    times["validate_aggregate_g1"] = (
        cuda_ms(lambda: B.launch_k15(Xd, Yd, vd8, ok_b, all_b, part, tri), it, wu), plain15)
    it, wu = BLS_TIMING["aggregate_g1"]
    times["aggregate_g1"] = (cuda_ms(lambda: B.launch_k14(Xk, Yk, Zd, part, tri), it, wu), plain14)
    g = -(-N_BLS // B.TILE)
    finish_ms = cuda_ms(lambda: B._launch_finish(part, g, tri), it, wu)
    # the work of this run's data (bls381.cuh's branches), as (field
    # multiplies, of them squares)
    on_curve_rows = sum(1 for d in decoded if d is not None)  # the decoded rows reach the on-curve check
    n_dbl, n_madd = R.bit_length() - 1, bin(R).count("1") - 1
    ladder_muls = n_dbl * FM_BLS_DBL + n_madd * FM_BLS_MADD
    ladder_sqs = n_dbl * SQ_BLS_DBL + n_madd * SQ_BLS_MADD
    rows_ladder = sum(1 for d in decoded if d is not None and H._on_curve(H._FP, d))
    w13 = (on_curve_rows * FM_BLS_CURVE + rows_ladder * ladder_muls,
           on_curve_rows * SQ_BLS_CURVE + rows_ladder * ladder_sqs)
    adds15 = bls_tree_work(live, B.TILE, B.FINISH)
    w15 = (w13[0] + adds15 * FM_BLS_ADD, w13[1] + adds15 * SQ_BLS_ADD)
    adds14 = bls_tree_work([True] * N_BLS, B.TILE, B.FINISH)
    w14 = (adds14 * FM_BLS_ADD, adds14 * SQ_BLS_ADD)
    in13 = N_BLS * (2 * 48 + 1)
    bls_work = {}
    for name, (fm, sq), nbytes in (("validate_g1", w13, in13 + N_BLS + 1),
                                   ("validate_aggregate_g1", w15, in13 + N_BLS + 1 + 144),
                                   ("aggregate_g1", w14, N_BLS * 144 + 144)):
        mul_adds = (fm - sq) * MULADDS_BLS_MUL + sq * MULADDS_BLS_SQ
        bounds[name] = ("operations", mul_adds * OPS_PER_MULADD / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
        bls_work[name] = {"field_muls": fm, "field_squares": sq, "mul_adds": mul_adds,
                          "mul_adds_all_at_288": fm * MULADDS_BLS_MUL}
        how = (f"both launches, the finishing stage alone {finish_ms:.4f} ms; run 13q: "
               f"{RUN_13Q['K14 10,000 rows']} / {RUN_13Q['K14 finishing stage']} ms" if name == "aggregate_g1"
               else f"{rows_ladder} rows through the ladder of {ladder_muls} multiplies")
        log(f"[20] {name}: {times[name][0]:.4f} ms ({how}); work {fm} field multiplies, {sq} of them "
            f"squares: {mul_adds} multiply-adds for the bound (a square at {MULADDS_BLS_SQ}), "
            f"{fm * MULADDS_BLS_MUL} with every multiply at {MULADDS_BLS_MUL}")
    H._pairings_product_is_one = real_pairing

    # launch shapes and ptxas figures (a spill anywhere in bls.cu fails)
    from cometbft_tpu_torch import _build

    def bls_entry(line):
        for key, kern in (("aggregate_g1_finish", "k14_finish_kernel"), ("aggregate_g1", "k14_kernel"),
                          ("validate_aggregate_g1", "k15_kernel")):
            if kern in line:
                return key
        return None

    rep = ptxas_kernels(_build.BUILD_LOG["bls"]["ptxas"], bls_entry)
    ptx = rep["kernels"]
    if "validate_aggregate_g1" in ptx:  # K13 launches K15's kernel, which stops before the tile stage
        ptx["validate_g1"] = dict(ptx["validate_aggregate_g1"])
    require(set(ptx) == set(B.LAUNCHES), f"bls.cu's ptxas report names {sorted(ptx)}")
    for name, f in ptx.items():
        require(f.get("spill_bytes", 1) == 0, f"{name} spills: {f}")
    require(rep["any_spill"] == 0, f"a function of bls.cu spills {rep['any_spill']} bytes")
    # (threads a row, rows a block); K14's two stages run an add on a group of
    # B.GROUP threads, one group an add of a tree's first level
    threads = {"validate_g1": (1, 32), "aggregate_g1": (B.GROUP // 2, B.TILE),
               "aggregate_g1_finish": (B.FINISH_GROUPS * B.GROUP // B.FINISH, B.FINISH),
               "validate_aggregate_g1": (1, B.TILE)}
    bls_shapes = {name: {"threads_per_row": tr, "rows_per_block": rb,
                         "blocks_per_sm": blocks_per_sm(ptx[name]["registers"], ptx[name]["smem_bytes"], tr * rb),
                         **ptx[name]} for name, (tr, rb) in threads.items()}
    log(f"[20] bls.cu ptxas and launch shapes: {json.dumps(bls_shapes)}")
    k15p = ptx["validate_aggregate_g1"]
    log(f"[20] K13 and K15 (one kernel, k15_kernel): {k15p['registers']} registers, "
        f"{k15p.get('stack_bytes', 0)} bytes of stack, {k15p['spill_bytes']} spilled; bls.cu built in "
        f"{_build.BUILD_LOG['bls']['seconds']:.1f} s")
    k14p, k14f = ptx["aggregate_g1"], ptx["aggregate_g1_finish"]
    log(f"[20] K14 {times['aggregate_g1'][0]:.4f} ms at {N_BLS} rows, the finishing stage alone {finish_ms:.4f} "
        f"(run 13q: {RUN_13Q['K14 10,000 rows']} / {RUN_13Q['K14 finishing stage']} ms); a group of {B.GROUP} "
        f"threads an add; tile stage {k14p['registers']} registers, {k14p.get('stack_bytes', 0)} bytes of stack, "
        f"{k14p['spill_bytes']} spilled; finishing stage ({B.FINISH_GROUPS * B.GROUP} threads) "
        f"{k14f['registers']} registers, {k14f.get('stack_bytes', 0)} bytes of stack, {k14f['spill_bytes']} spilled")

    src = "cometbft_tpu_torch/csrc/bls.cu"
    meta = {
        "validate_g1": ("K13", src, "cometbft_tpu/ops/bls381.py:346", ["bls381_validate_g1"]),
        "aggregate_g1": ("K14", src, "cometbft_tpu/ops/bls381.py:273", ["bls381_aggregate_g1"]),
        "validate_aggregate_g1": ("K15", src, "cometbft_tpu/ops/bls381.py:365", ["bls381_validate_aggregate_g1"]),
    }
    for name in bls_shapes:
        bls_shapes[name].update(bls_work.get(name, {}))
    record = {"bls_rows": N_BLS, "bls_commit_ms": walls, "bls_phases_ms": timings, "bls_shapes": bls_shapes,
              "bls_verify_commit_512_ms": vc, "bls_path_launches": path_counts,
              "bls_k14_finish_ms": finish_ms, "bls_lane_s": time.perf_counter() - t_lane}
    return results, times, bounds, meta, record, {"commit_items": commit_items}  # phase 24's warm commit


# ---------------------------------------------------------------- sharded plane
# Rows 23-26 of the kernel table (cometbft_tpu_torch/parallel/): the
# per-rank kernels K1-K9 plus torch.distributed collectives.  World 1 runs
# in this process on NCCL; world 4 runs as four spawned ranks sharing this
# one card on gloo (NCCL refuses two ranks on one GPU), each holding a
# quarter of the comb tables.  Four ranks on one card measure no scaling.
N_SHARD_RANKS = 4
SHARD_GROUP_TIMEOUT_S = 120
SHARD_JOIN_S = 300


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _p50_in_turns(fns: dict, calls: int = 12, warmup: int = 2) -> dict:
    """p50 of the host clock around each fn() and a synchronize, over
    ``calls - warmup`` rounds after ``warmup``; the functions take turns
    (a, b, b, a, ...), so that host noise falls on both alike."""
    walls = {k: [] for k in fns}
    for i in range(calls):
        for k in (list(fns) if i % 2 == 0 else list(reversed(fns))):
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(w[warmup:])) for k, w in walls.items()}


def _planted_blame(validation, chain_id, d, **kw) -> str:
    try:
        validation.verify_commit(chain_id, d["vals"], d["bid"], d["height"], d["faulted"], **kw)
    except validation.CommitVerificationError as e:
        return str(e)
    raise AssertionError("the planted commit verified")


def _sharded_rank(rank: int, world: int, corpus_path: str, out_dir: str) -> None:
    """One spawned rank of the world-4 phase: a gloo group of ``world``
    ranks on this card, the same calls as world 1, its results and
    launch counts written to out_dir/rank<r>.json."""
    import datetime
    import pickle
    import traceback

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        import torch.distributed as dist

        from cometbft_tpu_torch import parallel as P
        from cometbft_tpu_torch.models import comb_verifier as cv
        from cometbft_tpu_torch.ops import comb, sha2
        from cometbft_tpu_torch.ops import ed25519 as E
        from cometbft_tpu_torch.ops import merkle as Mk
        from cometbft_tpu_torch.parallel import verify as PV
        from cometbft_tpu_torch.types import validation
        from cometbft_tpu_torch.verifysvc import reset_global_service

        with open(corpus_path, "rb") as f:
            d = pickle.load(f)
        comb.adopt_b_tables(d["b_table"])  # built once, in the parent
        counters = (sha2.LAUNCHES, comb.LAUNCHES, E.LAUNCHES, cv.LAUNCHES, Mk.LAUNCHES, PV.LAUNCHES)

        def counts():
            got = {k: v for c in counters for k, v in c.items()}
            for c in counters:
                for k in c:
                    c[k] = 0
            return got

        dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "store"),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=SHARD_GROUP_TIMEOUT_S))
        dev = torch.device("cuda")
        mesh = P.make_mesh(device=dev)
        cv.set_active_mesh(mesh)
        res = {"device": str(mesh.device), "comm_device": str(mesh.comm_device)}
        cache = cv.ValsetCombCache()
        counts()
        entry = cache.ensure(d["pubs"], device=dev)
        res["build"] = counts()
        res["lanes"] = [entry.vpad, entry.lo, int(entry.tables.shape[0])]
        kw = dict(device=dev, comb_cache=cache)
        t0 = time.perf_counter()
        validation.verify_commit(d["chain_id"], d["vals"], d["bid"], d["height"], d["good"], **kw)
        res["good_ms"] = (time.perf_counter() - t0) * 1e3
        res["good"] = counts()
        res["blame"] = _planted_blame(validation, d["chain_id"], d, **kw)
        res["planted"] = counts()
        bv = cv.CombBatchVerifier(entry)
        for it in d["items"]:
            bv.add(*it)
        res["per_ok"] = bv.verify() == (False, d["per"])
        payload = torch.from_numpy(cv.assemble_payload(d["items"], np.asarray(d["rows"]), entry.vpad))
        raw = PV.sharded_verify_cached(mesh, entry.tables, entry.valid, entry.pubs, payload,
                                       entry.b_tables).cpu().numpy()
        want = d["bitmap"]
        res["bitmap_ok"] = bool(np.array_equal(raw[: want.size - 1], want[:-1])
                                and not raw[want.size - 1 : -1].any() and raw[-1] == want[-1])
        counts()
        ub = [torch.from_numpy(x) for x in d["ubatch"]]
        blocks, active = torch.from_numpy(d["leaf_blocks"]), torch.from_numpy(d["leaf_active"])
        t0 = time.perf_counter()
        ok, valid, root = PV.commit_verification_step(mesh, *ub, blocks, active)
        torch.cuda.synchronize()
        res["step_ms"] = (time.perf_counter() - t0) * 1e3
        res["step"] = counts()
        res["step_ok"] = bool(not bool(ok) and np.array_equal(valid.cpu().numpy(), d["k5"])
                              and bytes(root.cpu().numpy()) == d["root"])
        t0 = time.perf_counter()
        proot, leaf_sel, aunts = PV.sharded_merkle_proofs(mesh, blocks, active, d["proof_idx"],
                                                          d["proof_sib"])
        torch.cuda.synchronize()
        res["proofs_ms"] = (time.perf_counter() - t0) * 1e3
        res["proofs"] = counts()
        res["proofs_ok"] = bool(bytes(proot.cpu().numpy()) == d["root"]
                                and np.array_equal(leaf_sel.cpu().numpy(), d["nodes"][:, 0])
                                and np.array_equal(aunts.cpu().numpy(), d["nodes"][:, 1:]))
        cv.set_active_mesh(None)
        reset_global_service()  # its host worker ran the collectives: stop it before the group goes
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def sharded_phases(dev, log, require, zero_counts, read_counts, cuda_ms, d):
    """Phases 22 (world 1, NCCL, in this process) and 23 (world 4, gloo,
    spawned ranks on this card).  ``d`` carries the main path's inputs
    and one-device results (phases 2-5, 10-11).  Returns per-row times,
    plain times, parity errors and the record."""
    import datetime
    import multiprocessing as mp
    import pickle
    import tempfile

    import torch.distributed as dist

    from cometbft_tpu_torch import parallel as P
    from cometbft_tpu_torch.crypto import merkle as cmerkle
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.ops import comb, sha2
    from cometbft_tpu_torch.ops import ed25519 as E
    from cometbft_tpu_torch.ops import merkle as Mk
    from cometbft_tpu_torch.parallel import verify as PV
    from cometbft_tpu_torch.types import validation

    t_phase = time.perf_counter()
    chain_id, vals = d["chain_id"], d["vals"]
    ua, ur, us, ublk, uact = d["ubatch"]
    blocks_p, active_p = d["leaf_blocks"], d["leaf_active"]
    n_leaves = blocks_p.shape[0]
    idx = torch.arange(n_leaves, dtype=torch.int32)
    sib = torch.from_numpy(cmerkle._plan_array(n_leaves, range(n_leaves)).astype(np.int32))
    nodes_1 = Mk.merkle_gather(d["flat"], d["coords"])  # the one-device proofs' nodes
    e1 = d["entry"]
    good_bitmap = cv.device_verify(e1.tables, e1.valid, e1.pubs, d["good_payload"], e1.b_tables)
    bv = cv.CombBatchVerifier(e1)
    for it in d["items"]:
        bv.add(*it)
    one_dev = bv.verify()  # phase 3's verdicts on the planted items
    require(not one_dev[0], "the planted items verified")
    torch.cuda.synchronize()

    # ------------------------------------------------ 22. world 1, NCCL
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=SHARD_GROUP_TIMEOUT_S))
    errs, times, p50s, counts = {}, {}, {}, {}
    try:
        mesh = P.make_mesh(device=dev)
        cv.set_active_mesh(mesh)
        scache = cv.ValsetCombCache()
        kw = dict(device=dev, comb_cache=scache)
        zero_counts()
        sentry = scache.ensure(vals.pub_keys_bytes(), device=dev)
        validation.verify_commit(chain_id, vals, d["bid"], d["height"], d["good"], **kw)
        blame = _planted_blame(validation, chain_id, d, **kw)
        counts["commit"] = c = read_counts("sharded_commit")
        require(blame == d["blame"], f"sharded blame {blame!r} != {d['blame']!r}")
        require(c["sharded_verify_cached"] == 2 and c["verify_cached"] == 2
                and c["parse_verify_payload"] == 2 and c["sha512_blocks"] == 2
                and c["build_a_tables"] == 1 and c["verify_batch"] == 0,
                f"world-1 commit path launches {c}")
        require(torch.equal(sentry.tables, d["entry"].tables), "world-1 tables != phase 2's")
        bv = cv.CombBatchVerifier(sentry)
        for it in d["items"]:
            bv.add(*it)
        require(bv.verify() == one_dev, "world-1 CombBatchVerifier != the one-device verdicts")
        planted = d["payload"]
        raw = PV.sharded_verify_cached(mesh, sentry.tables, sentry.valid, sentry.pubs, planted,
                                       sentry.b_tables)
        torch.cuda.synchronize()
        errs["sharded_verify_cached"] = max_abs_err(raw, d["bitmap"])
        require(torch.equal(raw, d["bitmap"]), "world-1 bitmap != phase 3's K4 bitmap")

        def commit_on(mesh_, cache_):
            cv.set_active_mesh(mesh_)
            validation.verify_commit(chain_id, vals, d["bid"], d["height"], d["good"], device=dev,
                                     comb_cache=cache_)

        good_items = d["good_items"]

        def comb_verify(entry_):
            bv_ = cv.CombBatchVerifier(entry_)
            for it in good_items:
                bv_.add(*it)
            require(bv_.verify()[0], "the good batch failed")
            phases[entry_ is sentry].append(bv_.last_timings)

        phases = {True: [], False: []}
        p = _p50_in_turns({"verify_commit": lambda: commit_on(mesh, scache),
                           "verify_commit_unsharded": lambda: commit_on(None, d["cache"]),
                           "comb_verify": lambda: comb_verify(sentry),
                           "comb_verify_unsharded": lambda: comb_verify(e1)})
        cv.set_active_mesh(mesh)
        p50s.update(p)
        verifier_phases = {
            k: {ph: float(np.median([x[ph] for x in phases[sh][2:]])) for ph in phases[sh][0]}
            for k, sh in (("sharded", True), ("unsharded", False))}

        zero_counts()
        ok, valid, root = PV.commit_verification_step(mesh, ua, ur, us, ublk, uact, blocks_p, active_p)
        torch.cuda.synchronize()
        counts["step"] = c = read_counts("sharded_step")
        require(c["sharded_verify_batch"] == 1 and c["sharded_merkle_root"] == 1
                and c["verify_batch"] == 1 and c["sha512_blocks"] == 1 and c["sha256_blocks"] == 1
                and c["merkle_tree"] == 1, f"world-1 step launches {c}")
        errs["sharded_verify_batch"] = max_abs_err(valid, d["k5"])
        require(not bool(ok) and torch.equal(valid, d["k5"].bool()), "world-1 verdicts != phase 5's K5")
        errs["sharded_merkle_root"] = max_abs_err(root, d["flat"][-1])
        require(bytes(root.cpu().numpy()) == d["root"], "world-1 root != the host root")
        p50s.update(_p50_in_turns({
            "commit_step": lambda: PV.commit_verification_step(mesh, ua, ur, us, ublk, uact, blocks_p, active_p),
            "commit_step_unsharded": lambda: (E.verify_batch(ua, ur, us, ublk, uact),
                                              Mk.root_from_leaves(blocks_p, active_p))}))

        zero_counts()
        proot, leaf_sel, aunts = PV.sharded_merkle_proofs(mesh, blocks_p, active_p, idx, sib)
        torch.cuda.synchronize()
        counts["proofs"] = c = read_counts("sharded_proofs")
        require(c["sharded_merkle_proofs"] == 1 and c["merkle_gather"] == 1 and c["sha256_blocks"] == 1,
                f"world-1 proof launches {c}")
        got = torch.cat([leaf_sel[:, None], aunts], dim=1)
        errs["sharded_merkle_proofs"] = max_abs_err(got, nodes_1)
        require(torch.equal(got, nodes_1) and bytes(proot.cpu().numpy()) == d["root"],
                "world-1 proofs != the one-device proofs")
        proofs = d["host_proofs"]
        for k in (0, 1, n_leaves // 3, n_leaves - 1):
            require(bytes(leaf_sel[k].cpu().numpy()) == proofs[k].leaf_hash
                    and [bytes(a) for a in aunts[k].cpu().numpy()] == list(proofs[k].aunts),
                    f"world-1 proof {k} != proofs_from_byte_slices")
        p50s.update(_p50_in_turns({
            "proofs": lambda: PV.sharded_merkle_proofs(mesh, blocks_p, active_p, idx, sib),
            "proofs_unsharded": lambda: Mk.nodes_from_leaves(blocks_p, active_p, torch.from_numpy(
                Mk.proof_coords(n_leaves, idx.numpy(), sib.numpy())).to(dev))}))

        # each entry by CUDA events; the world-1 collectives run on the card
        good_payload = d["good_payload"]
        times["sharded_verify_batch"] = cuda_ms(lambda: PV.sharded_verify_batch(mesh, ua, ur, us, ublk, uact), 10, 2)
        times["sharded_verify_cached"] = cuda_ms(lambda: PV.sharded_verify_cached(
            mesh, sentry.tables, sentry.valid, sentry.pubs, good_payload, sentry.b_tables), 20, 2)
        times["sharded_merkle_root"] = cuda_ms(lambda: PV.sharded_merkle_root(mesh, blocks_p, active_p), 20, 2)
        times["sharded_merkle_proofs"] = cuda_ms(
            lambda: PV.sharded_merkle_proofs(mesh, blocks_p, active_p, idx, sib), 10, 2)
    finally:
        cv.set_active_mesh(None)
        dist.destroy_process_group()
    log(f"[22] world 1 (NCCL, {mesh.device}): verify_commit over {len(vals.validators)} validators "
        f"good and planted (blame {blame[:40]}...), CombBatchVerifier verdicts and the [bitmap | all_ok] "
        f"bytes == phases 2-3; commit_verification_step verdicts == phase 5's K5 on {ua.shape[0]} lanes "
        f"and root == the host root of {n_leaves} leaves; all {n_leaves} proofs == the one-device "
        f"proofs and proofs_from_byte_slices")
    log(f"[22] launches: " + json.dumps(counts))
    log(f"[22] p50 (ms, 10 calls after 2, sharded and unsharded in turns): verify_commit "
        f"{p50s['verify_commit']:.3f} sharded, {p50s['verify_commit_unsharded']:.3f} unsharded (phase 4: "
        f"{d['p50']:.3f}); CombBatchVerifier.verify {p50s['comb_verify']:.3f} / "
        f"{p50s['comb_verify_unsharded']:.3f}; commit_verification_step {p50s['commit_step']:.3f} / "
        f"K2 -> K5 + root {p50s['commit_step_unsharded']:.3f}; sharded_merkle_proofs "
        f"{p50s['proofs']:.3f} / nodes_from_leaves {p50s['proofs_unsharded']:.3f}")
    log(f"[22] CombBatchVerifier phases p50 (ms): " + json.dumps(
        {k: {ph: round(v, 3) for ph, v in x.items()} for k, x in verifier_phases.items()}))

    # the plain chains at the same shapes, once, cold: each row's plain version
    plain, start, end = {}, torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def plain_verify_batch():
        return E.verify_digest_plain(ua, ur, us, sha2.sha512_blocks_plain(ublk, uact))

    def plain_verify_cached():
        e, pl = d["entry"], d["good_payload"]
        blk, act = sha2.parse_verify_payload_plain(pl, e.pubs)
        ok_ = comb.verify_cached_plain(e.tables, e.valid, pl, sha2.sha512_blocks_plain(blk, act), e.b_tables)
        return comb.pack_verdicts(ok_, pl[:, 67] == 1)

    def plain_tree():
        flat = torch.empty((Mk.level_offsets(n_leaves)[-1] + 1, 32), dtype=torch.uint8, device=dev)
        flat[:n_leaves] = sha2.sha256_blocks_plain(blocks_p, active_p)
        Mk.merkle_tree_plain(flat, n_leaves)
        return flat

    for name, fn in (("sharded_verify_batch", plain_verify_batch),
                     ("sharded_verify_cached", plain_verify_cached),
                     ("sharded_merkle_root", lambda: plain_tree()[-1]),
                     ("sharded_merkle_proofs", lambda: Mk.merkle_gather_plain(plain_tree(), d["coords"].reshape(-1)))):
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        plain[name] = start.elapsed_time(end)
        want = {"sharded_verify_batch": d["k5"].bool(), "sharded_verify_cached": good_bitmap,
                "sharded_merkle_root": d["flat"][-1], "sharded_merkle_proofs": nodes_1.reshape(-1, 32)}[name]
        require(torch.equal(out, want), f"{name}: the plain chain != the kernels")
    log(f"[22] plain chains (once, cold, ms): " + json.dumps({k: round(v, 2) for k, v in plain.items()}))

    # ------------------------------------------ 23. world 4, gloo, one card
    t4 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.pkl")
        with open(corpus, "wb") as f:
            pickle.dump({
                "chain_id": chain_id, "vals": vals, "pubs": vals.pub_keys_bytes(), "bid": d["bid"],
                "height": d["height"], "good": d["good"], "faulted": d["faulted"], "items": d["items"],
                "rows": d["rows"], "per": one_dev[1], "bitmap": d["bitmap"].cpu().numpy(),
                "ubatch": [x.cpu().numpy() for x in d["ubatch"]], "k5": d["k5"].cpu().numpy(),
                "leaf_blocks": blocks_p.cpu().numpy(), "leaf_active": active_p.cpu().numpy(),
                "root": d["root"], "proof_idx": idx, "proof_sib": sib, "nodes": nodes_1.cpu().numpy(),
                "b_table": comb.build_b_tables(),
            }, f)
        t_corpus = time.perf_counter() - t4
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_sharded_rank, args=(r, N_SHARD_RANKS, corpus, tmp))
                 for r in range(N_SHARD_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARD_JOIN_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = {}
        for r in range(N_SHARD_RANKS):
            path = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors[r] = f.read()
        require(not hung and not errors and all(p.exitcode == 0 for p in procs),
                f"world-{N_SHARD_RANKS} ranks: hung {hung}, exit codes {[p.exitcode for p in procs]}, "
                f"errors {errors}")
        ranks = []
        for r in range(N_SHARD_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    lanes = -(-len(vals.validators) // (8 * N_SHARD_RANKS)) * 8 * N_SHARD_RANKS
    per = lanes // N_SHARD_RANKS
    for r, res in enumerate(ranks):
        require(res["lanes"] == [lanes, r * per, per], f"rank {r} lanes {res['lanes']}")
        require(res["build"]["build_a_tables"] == 1, f"rank {r} build launches {res['build']}")
        for path in ("good", "planted"):
            c = res[path]
            require(c["parse_verify_payload"] == 1 and c["sha512_blocks"] == 1 and c["verify_cached"] == 1
                    and c["sharded_verify_cached"] == 1 and c["verify_batch"] == 0,
                    f"rank {r} {path} commit: not K1, K2 and K4 once each: {c}")
        require(res["blame"] == d["blame"], f"rank {r} blame {res['blame']!r}")
        require(res["per_ok"] and res["bitmap_ok"], f"rank {r} verdicts or bitmap != phase 3's")
        require(res["step_ok"] and res["proofs_ok"], f"rank {r} step or proofs != the one-device results")
        s = res["step"]
        # one K8 for the rank's subtree, one for the fold of the subtree roots
        require(s["verify_batch"] == 1 and s["sha256_blocks"] == 1 and s["merkle_tree"] == 2,
                f"rank {r} step launches {s}")
        require(res["proofs"]["merkle_gather"] == 1, f"rank {r} proof launches {res['proofs']}")
    w4 = {"ranks": N_SHARD_RANKS, "device": ranks[0]["device"], "comm_device": ranks[0]["comm_device"],
          "lanes_per_rank": per, "leaves_per_rank": n_leaves // N_SHARD_RANKS,
          "launches_per_rank": {k: ranks[0][k] for k in ("build", "good", "planted", "step", "proofs")},
          "good_commit_ms": [r_["good_ms"] for r_ in ranks], "step_ms": [r_["step_ms"] for r_ in ranks],
          "proofs_ms": [r_["proofs_ms"] for r_ in ranks], "corpus_s": t_corpus,
          "wall_s": time.perf_counter() - t4}
    log(f"[23] world {N_SHARD_RANKS} (gloo, every rank on {w4['device']}, collectives on "
        f"{w4['comm_device']}): {lanes} lanes, {per} a rank; every rank's verify_commit blame, "
        f"verdicts, bitmap, commit_verification_step and {n_leaves} proofs == the one-device results; "
        f"K1, K2 and K4 once per verify on every rank; launches per rank "
        + json.dumps(w4["launches_per_rank"]))
    log(f"[23] host clock per rank (ms; {N_SHARD_RANKS} ranks sharing one card measure no scaling): "
        f"good commit {[round(x, 1) for x in w4['good_commit_ms']]}, step "
        f"{[round(x, 1) for x in w4['step_ms']]}, proofs {[round(x, 1) for x in w4['proofs_ms']]}; "
        f"corpus written in {t_corpus:.1f} s, phase {w4['wall_s']:.1f} s")
    record = {"sharded_p50_ms": p50s, "sharded_verifier_phases_p50_ms": verifier_phases,
              "sharded_world1_launches": counts, "sharded_world4": w4,
              "sharded_phase_s": time.perf_counter() - t_phase}
    return times, plain, errs, record


# ---------------------------------------------------------------- the verify service
# Phase 24: the service at full width, with the JAX defaults of its
# variables (batch 4,096, mempool deadline 5 ms, proof deadline 5 ms,
# background 25 ms, queue bounds 16,384 / 8,192, no tenant quota).
SVC_CALLS = 10  # p50 calls of 24(a) and (b), after 2
N_FLOOD_SENDERS = 16  # CheckTx senders of 24(b), one tx a call
N_TENANT_TXS = {"rogue": 1_024, "victim": 256}  # 24(c)
N_TENANT_SENDERS = {"rogue": 32, "victim": 4}
TENANT_QUOTA = 16  # 24(c)'s COMETBFT_TPU_VERIFYSVC_TENANT_QUOTA: the victim's 4 senders stay under it
N_PROOF_QUERIES = 64  # a light client's proof request (24(d))
N_PROOF_SENDERS = 8
BLS_SVC_CALLS = 3  # 24(d)'s warm aggregate commits, after 1
SECP_KEY_TYPE_BYTE = {33: 1, 65: 2, 20: 3}  # pubkey width -> the envelope's key-type byte


def service_phases(dev, log, require, zero_counts, read_counts, d):
    """Phase 24 of main(): the verify service of ``dev`` at full width.
    ``d`` carries the inputs of phases 2, 9, 10, 12-13 and 17.  Returns
    the record."""
    import threading

    from cometbft_tpu_torch import light
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.models import proof_server
    from cometbft_tpu_torch.models import secp_verifier as sv
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.verifysvc import checktx
    from cometbft_tpu_torch.verifysvc import service as S

    t_phase = time.perf_counter()
    smi = d["smi"]
    svc = S.global_service(dev)
    chain_id, vals, bid, height, cache, entry = (d[k] for k in ("chain_id", "vals", "bid", "height", "cache",
                                                                "entry"))
    pubkeys, good_items = vals.pub_keys_bytes(), d["good_items"]
    kw = dict(device=dev, comb_cache=cache)
    rec = {}

    def tallies(before, after):
        return {key: {k: after[key][k] - before[key][k] for k in after[key]}
                for key in ("dispatched_batches", "dispatched_sigs", "rejected")}

    def commit():
        t0 = time.perf_counter()
        validation.verify_commit(chain_id, vals, bid, height, d["good"], **kw)
        return (time.perf_counter() - t0) * 1e3

    # ------------------------------------------------ (a) consensus alone
    before = svc.stats()
    zero_counts()
    walls = [commit() for _ in range(SVC_CALLS + 2)]
    c = read_counts("service_consensus")
    n = SVC_CALLS + 2
    require(c["parse_verify_payload"] == n and c["sha512_blocks"] == n and c["verify_cached"] == n
            and c["verify_batch"] == 0 and c["build_a_tables"] == 0,
            f"24(a): a commit did not launch K1, K2 and K4 once each: {c}")
    blame = _planted_blame(validation, chain_id, d, **kw)
    require(blame == d["blame"], f"24(a): blame {blame!r} != phase 2's {d['blame']!r}")
    t_a = tallies(before, svc.stats())
    require(t_a["dispatched_batches"]["consensus"] == n + 1 and not any(t_a["rejected"].values()),
            f"24(a): service tallies {t_a}")
    p50_alone = float(np.median(walls[2:]))
    split = {"service": [], "direct": []}  # per call: host ms of the factory, the adds, verify(); phases

    def drive(route, make):
        t0 = time.perf_counter()
        bv = make()
        t1 = time.perf_counter()
        for it in good_items:
            bv.add(*it)
        t2 = time.perf_counter()
        require(bv.verify()[0], f"24(a): the good batch failed ({route})")
        t3 = time.perf_counter()
        split[route].append(dict(bv.last_timings, factory_ms=(t1 - t0) * 1e3, add_ms=(t2 - t1) * 1e3,
                                 verify_ms=(t3 - t2) * 1e3))

    turns = _p50_in_turns({
        "service": lambda: drive("service", lambda: cbatch.create_batch_verifier("ed25519", pubkeys, **kw)),
        "direct": lambda: drive("direct", lambda: cv.CombBatchVerifier(entry)),
    })
    split = {r: {k: float(np.median([p[k] for p in v[2:]])) for k in v[0]} for r, v in split.items()}
    rec["service_consensus_p50_ms"] = p50_alone
    rec["service_vs_direct_p50_ms"] = turns
    rec["service_cost_per_commit_ms"] = turns["service"] - turns["direct"]
    rec["service_vs_direct_split_p50_ms"] = split
    log(f"[24a] ({smi}) verify_commit at {len(vals.validators)} validators through the service, tables "
        f"warm: p50 {p50_alone:.2f} ms over {SVC_CALLS} calls after 2 (min {min(walls[2:]):.2f}, max "
        f"{max(walls[2:]):.2f}); each call K1 1, K2 1, K4 1, K5 0 ({c['verify_cached']} / {n}); blame on "
        f"the planted commit == phase 2's; {len(good_items)} items + verify in turns: through the "
        f"factory and service {turns['service']:.2f} ms, CombBatchVerifier(entry) {turns['direct']:.2f} "
        f"ms: the service's own cost {turns['service'] - turns['direct']:.2f} ms a commit; p50 split (ms; "
        f"host clock around the factory, the adds and verify(), then the verifier's phases, the service's "
        f"queue_ms / submit_ms / kernel_ms): "
        + json.dumps({r: {k: round(v, 3) for k, v in ph.items()} for r, ph in split.items()}))

    # ------------------------------------------------ (b) consensus under a CheckTx flood
    sec = d["secp"]
    items, planted, verdicts13 = sec["items"], sec["planted"], sec["verdicts"]

    def envelope(item):
        pub, msg, sig = item
        return (checktx.MAGIC_V2 + bytes([SECP_KEY_TYPE_BYTE[len(pub)]]) + pub + sig
                + msg[len(checktx.SIGN_DOMAIN):])

    txs = [envelope(it) for it in items]
    parsed = []
    for tx in txs:
        _, pub, sig, payload = checktx.parse_signed_tx(tx)
        parsed.append((pub, checktx.SIGN_DOMAIN + payload, sig))
    same = [i for i, it in enumerate(items) if parsed[i] == it]
    got, moved = [None] * len(txs), []
    stop = threading.Event()

    def sender(k):
        first = True
        while True:
            for i in range(k, len(txs), N_FLOOD_SENDERS):
                v = checktx.verify_tx_signature(txs[i], service=svc)
                if first:
                    got[i] = v
                elif v != got[i]:
                    moved.append(i)
            first = False
            if stop.is_set():
                return

    secp_names = ["keccak256_blocks"] + [k for k in read_counts() if k.startswith("secp_")]
    before = svc.stats()
    zero_counts()
    threads = [threading.Thread(target=sender, args=(k,), daemon=True) for k in range(N_FLOOD_SENDERS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    flood_walls = [commit() for _ in range(SVC_CALLS + 2)]
    stop.set()
    for th in threads:
        th.join(600)
    t_flood = time.perf_counter() - t0
    require(not any(th.is_alive() for th in threads), "24(b): a CheckTx sender hung")
    c = read_counts("service_flood")
    t_b = tallies(before, svc.stats())
    n = SVC_CALLS + 2
    require(c["verify_cached"] == n and c["parse_verify_payload"] == n and c["verify_batch"] == 0,
            f"24(b): the commits' launches {c}")
    require(not any(t_b["rejected"].values()), f"24(b): refusals {t_b['rejected']}")
    require(None not in got and not moved, f"24(b): a verdict is missing or moved between passes: {moved[:5]}")
    require(all(got[i] == verdicts13[i] for i in same), "24(b): a CheckTx verdict != phase 13's")
    pool_rows = [i for i in range(len(txs)) if i not in planted]
    rng = np.random.default_rng(SEED + 24)
    rows = sorted(set(planted) | set(rng.choice(pool_rows, N_SECP_ORACLE_SAMPLE, replace=False).tolist()))
    require([got[i] for i in rows] == [sv._host_verify_one(*parsed[i]) for i in rows],
            "24(b): CheckTx verdicts != host oracle")
    require(not any(got[i] for i in planted), "24(b): a planted row verified")
    mp_batches, mp_sigs = t_b["dispatched_batches"]["mempool"], t_b["dispatched_sigs"]["mempool"]
    secp_launches = {k: c[k] for k in secp_names if c[k]}
    n_verify = sum(v for k, v in secp_launches.items() if k != "keccak256_blocks")
    require(mp_sigs >= len(txs) and n_verify == mp_batches,
            f"24(b): {mp_batches} MEMPOOL batches, {mp_sigs} rows, secp launches {secp_launches}")
    require(mp_batches * 4 <= mp_sigs, f"24(b): {mp_batches} batches for {mp_sigs} txs: the class did not merge")
    p50_flood = float(np.median(flood_walls[2:]))
    rec.update(service_flood_consensus_p50_ms=p50_flood, service_flood_mempool_batches=mp_batches,
               service_flood_txs=mp_sigs, service_flood_mean_batch=mp_sigs / mp_batches,
               service_flood_launches=secp_launches, service_flood_s=t_flood)
    log(f"[24b] ({smi}) {len(txs)} CheckTx envelopes ({len(planted)} planted rows; {len(txs) - len(same)} "
        f"planted rows re-read by the envelope's fixed widths) through checktx.verify_tx_signature, one tx a "
        f"call from {N_FLOOD_SENDERS} threads, passes repeated while {n} verify_commit calls ran: "
        f"{mp_sigs} txs in {mp_batches} MEMPOOL batches (mean {mp_sigs / mp_batches:.2f} rows), secp "
        f"launches {json.dumps(secp_launches)} (K12 needs >= {sv.hash_device_min()} rows a batch); every "
        f"verdict == phase 13's ({len(same)} rows) and the host oracle ({len(rows)} rows); 0 refusals; "
        f"verify_commit p50 {p50_flood:.2f} ms under the flood against {p50_alone:.2f} ms alone "
        f"(min {min(flood_walls[2:]):.2f}, max {max(flood_walls[2:]):.2f}); {t_flood:.1f} s")

    # ------------------------------------------------ (c) tenants and a quota
    tsvc = S.VerifyService(tenant_quota=TENANT_QUOTA, device=dev)
    host_calls = []
    real_host = checktx._host_verify

    def counted_host(*a):
        host_calls.append(a)
        return real_host(*a)

    checktx._host_verify = counted_host
    lo = {"rogue": 0, "victim": N_TENANT_TXS["rogue"]}
    tgot = {}
    try:
        def tenant_sender(tenant, k):
            idx = range(lo[tenant], lo[tenant] + N_TENANT_TXS[tenant])
            for i in idx[k::N_TENANT_SENDERS[tenant]]:
                tgot[i] = checktx.verify_tx_signature(txs[i], service=tsvc, tenant=tenant)

        threads = [threading.Thread(target=tenant_sender, args=(tn, k), daemon=True)
                   for tn in N_TENANT_SENDERS for k in range(N_TENANT_SENDERS[tn])]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        t_ten = time.perf_counter() - t0
        require(not any(th.is_alive() for th in threads), "24(c): a tenant's sender hung")
        st = tsvc.stats()
    finally:
        checktx._host_verify = real_host
        tsvc.stop()
    rogue, victim = st["tenants"].get("rogue", {}), st["tenants"].get("victim", {})
    require(len(tgot) == sum(N_TENANT_TXS.values()), f"24(c): {len(tgot)} verdicts")
    require(all(tgot[i] == verdicts13[i] for i in tgot if i in same)
            and all(tgot[i] == got[i] for i in tgot), "24(c): a tenant's verdict != phase 13's")
    require(rogue.get("rejected", 0) > 0 and victim.get("rejected", 0) == 0,
            f"24(c): the quota did not confine the refusals to the rogue tenant: {st['tenants']}")
    require(len(host_calls) == rogue["rejected"] == st["rejected"]["mempool"],
            f"24(c): {len(host_calls)} host checks for {st['rejected']} refusals")
    require(victim.get("dispatched_sigs") == N_TENANT_TXS["victim"], f"24(c): victim tallies {victim}")
    rec["service_tenants"] = {"quota": TENANT_QUOTA, "senders": N_TENANT_SENDERS, "txs": N_TENANT_TXS,
                              "tallies": st["tenants"], "host_checks": len(host_calls), "s": t_ten}
    log(f"[24c] ({smi}) two tenants flood MEMPOOL under COMETBFT_TPU_VERIFYSVC_TENANT_QUOTA={TENANT_QUOTA}: "
        f"rogue {N_TENANT_TXS['rogue']} txs from {N_TENANT_SENDERS['rogue']} threads, victim "
        f"{N_TENANT_TXS['victim']} from {N_TENANT_SENDERS['victim']}: tallies {json.dumps(st['tenants'])}; "
        f"the host path ran {len(host_calls)} times (each a refusal of the rogue tenant, scope=tenant), "
        f"the victim was never refused; every verdict == phase 13's and (b)'s; {t_ten:.1f} s")

    # ------------------------------------------------ (d) the other lanes
    bls_items = d["bls"]["commit_items"]
    bls_walls = []
    before = svc.stats()
    for i in range(BLS_SVC_CALLS + 1):
        zero_counts()
        bv = cbatch.create_batch_verifier("bls12_381", pubkeys=[p for p, _, _ in bls_items], device=dev)
        for it in bls_items:
            bv.add(*it)
        t0 = time.perf_counter()
        ok, res = bv.verify()
        bls_walls.append((time.perf_counter() - t0) * 1e3)
        require(ok and all(res), "24(d): the aggregate commit failed through the service")
        c = read_counts("service_bls" if i else None)
        if i:
            require(c["aggregate_g1"] == 1 and c["aggregate_g1_finish"] == 1 and c["validate_aggregate_g1"] == 0
                    and c["validate_g1"] == 0, f"24(d): a warm commit's launches {c}")
    t_bls = tallies(before, svc.stats())
    require(t_bls["dispatched_batches"]["consensus"] == BLS_SVC_CALLS + 1, f"24(d): BLS tallies {t_bls}")
    p50_bls = float(np.median(bls_walls[1:]))

    leaves, host_proofs, host_root = d["leaves"], d["host_proofs"], d["root"]
    requests = [list(range(j, min(j + N_PROOF_QUERIES, len(leaves))))
                for j in range(0, len(leaves), N_PROOF_QUERIES)]
    bad_proofs, req_walls = [], []

    def prover(k):
        # the front door: register the tree, submit under PROOF, the root
        # and the proofs back in this request's order
        for r in requests[k::N_PROOF_SENDERS]:
            t0 = time.perf_counter()
            root_, proofs_ = proof_server.prove(leaves, r, svc=svc)
            req_walls.append((time.perf_counter() - t0) * 1e3)
            if root_ != host_root or proofs_ != [host_proofs[i] for i in r]:
                bad_proofs.append(r[0])

    # every host path of the front door, counted: a refusal or a timeout
    # (_prove_items(device=False)), a None row re-proved by _assemble, a
    # tree the service proved below its device width (each reaches
    # proofs_from_byte_slices); the 256 requests must take none of them
    real_items, real_host = proof_server._prove_items, proof_server.cmerkle.proofs_from_byte_slices
    host_paths = {"prove_items_host": 0, "proofs_from_byte_slices": 0}

    def counted_items(items_, device):
        if device is False:
            host_paths["prove_items_host"] += 1
        return real_items(items_, device)

    def counted_host(leaves_):
        host_paths["proofs_from_byte_slices"] += 1
        return real_host(leaves_)

    before = svc.stats()
    zero_counts()
    threads = [threading.Thread(target=prover, args=(k,), daemon=True) for k in range(N_PROOF_SENDERS)]
    proof_server._prove_items, proof_server.cmerkle.proofs_from_byte_slices = counted_items, counted_host
    try:
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        t_proofs = time.perf_counter() - t0
    finally:
        proof_server._prove_items, proof_server.cmerkle.proofs_from_byte_slices = real_items, real_host
    require(not any(th.is_alive() for th in threads), "24(d): a proof sender hung")
    require(not any(host_paths.values()), f"24(d): requests answered on the host: {host_paths}")
    c = read_counts("service_proofs")
    t_p = tallies(before, svc.stats())
    require(not bad_proofs, f"24(d): proofs != proofs_from_byte_slices at requests {bad_proofs[:5]}")
    n_disp = t_p["dispatched_batches"]["proof"]
    require(t_p["dispatched_sigs"]["proof"] == len(leaves) and not any(t_p["rejected"].values()),
            f"24(d): proof tallies {t_p}")
    require(c["sha256_blocks"] == c["merkle_tree"] == c["merkle_gather"] == n_disp,
            f"24(d): {n_disp} PROOF dispatches, launches {c}")
    # one request against a tree evicted between its register and its
    # dispatch (a tree cache of one, another tree registered at once): the
    # service answers None rows and _assemble proves again on the host
    real_register, cap = proof_server.register_tree, os.environ.get("COMETBFT_TPU_PROOF_TREE_CACHE")

    def evicting(leaves_):
        digest = real_register(leaves_)
        real_register([b"another tree"])
        return digest

    os.environ["COMETBFT_TPU_PROOF_TREE_CACHE"] = "1"
    proof_server.register_tree = evicting
    proof_server._prove_items, proof_server.cmerkle.proofs_from_byte_slices = counted_items, counted_host
    zero_counts()
    try:
        ev_root, ev_proofs = proof_server.prove(leaves, requests[1], svc=svc)
    finally:
        proof_server._prove_items, proof_server.cmerkle.proofs_from_byte_slices = real_items, real_host
        proof_server.register_tree = real_register
        if cap is None:
            os.environ.pop("COMETBFT_TPU_PROOF_TREE_CACHE", None)
        else:
            os.environ["COMETBFT_TPU_PROOF_TREE_CACHE"] = cap
    c_ev = read_counts()
    require(ev_root == host_root and ev_proofs == [host_proofs[i] for i in requests[1]],
            "24(d): the evicted tree's request != proofs_from_byte_slices")
    require(c_ev["sha256_blocks"] == c_ev["merkle_tree"] == c_ev["merkle_gather"] == 0,
            f"24(d): the evicted tree's request launched {c_ev}")
    require(host_paths == {"prove_items_host": 0, "proofs_from_byte_slices": 1},
            f"24(d): the evicted tree's request took host paths {host_paths}, not _assemble's one re-prove")

    before = svc.stats()
    zero_counts()
    t0 = time.perf_counter()
    verdict = light.verify_adjacent(d["trusted_sh"], d["new_sh"], vals, TRUSTING_PERIOD_NS, d["now_ns"], **kw)
    t_light = (time.perf_counter() - t0) * 1e3
    c = read_counts("service_light")
    t_l = tallies(before, svc.stats())
    require(verdict is None and t_l["dispatched_batches"]["background"] == 1
            and t_l["dispatched_batches"]["consensus"] == 0 and c["verify_cached"] == 1,
            f"24(d): light client tallies {t_l}, launches {c}")
    rec.update(service_bls_warm_p50_ms=p50_bls, service_proof_dispatches=n_disp,
               service_proof_requests=len(requests), service_proofs_s=t_proofs,
               service_proof_request_p50_ms=float(np.median(req_walls)), service_light_adjacent_ms=t_light,
               service_phase_s=time.perf_counter() - t_phase)
    log(f"[24d] ({smi}) the {len(bls_items)}-row BLS aggregate commit through the service, warm: p50 "
        f"{p50_bls:.2f} ms over {BLS_SVC_CALLS} calls after 1, each K14 once (and its finishing stage), no "
        f"K13 / K15; {len(requests)} proof requests of {N_PROOF_QUERIES} queries over phase 10's "
        f"{len(leaves)}-leaf tree from {N_PROOF_SENDERS} threads under PROOF: {n_disp} dispatches, K7 / K8 "
        f"/ K9 {n_disp} launches each, request p50 {float(np.median(req_walls)):.2f} ms, {t_proofs:.2f} s "
        f"in all, through models/proof_server.prove, every root and proof == proofs_from_byte_slices byte "
        f"for byte, no request answered on the host (no refusal, timeout, None row or host-route tree); a "
        f"request against an evicted tree: None rows, proved again on the host by _assemble (no K7 / K8 / "
        f"K9, one proofs_from_byte_slices), the same bytes; light.verify_adjacent at "
        f"{len(vals.validators)} validators under BACKGROUND: verified ({t_light:.1f} ms; 1 background "
        f"batch, K4 once)")
    log(f"[24] the service's phase: {time.perf_counter() - t_phase:.1f} s")
    return rec


# ---------------------------------------------------------------- blocksync replay
# BASELINE.json config 5, "internal/blocksync fast-sync replay: 50k blocks x
# 5k-validator commits streamed": the set's width uncut, its depth cut to
# 32 blocks for the time limit.

V_REPLAY = 5_000  # validators of every replayed commit (BASELINE.json config 5)
N_REPLAY_BLOCKS = 32  # heights h .. h + 31 (the config's 50,000, cut)
REPLAY_HEIGHT = 2_000_000
REPLAY_FLIP = (5, 1_234)  # (block, row): a sign-bytes byte the signer never signed (inside +2/3)
REPLAY_FOREIGN = (11, 2_500)  # (block, row): a key outside the set in (a)'s items
REPLAY_ABSENT = 20  # the block with 20% of its rows absent
REPLAY_TURNS = 2  # (a): depth 1, depth 2, in turns, this many times each
N_REPLAY_ORACLE_SAMPLE = 64  # host-oracle rows a block, beside the planted ones
REPLAY_FILL_REPS = 20  # (a): the lone fills of one block, host clock


def _overlap_ms(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """Total length (ms) of the intersection of two sets of [start, end]
    intervals (each sorted, disjoint within its set)."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += max(0.0, min(e, b[k][1]) - max(s, b[k][0]))
            k += 1
    return total / 1e3


def _span_summary(events: list[dict]) -> dict:
    """{name: [calls, ms a call]} of a trace's verify.* spans."""
    out: dict[str, list] = {}
    for e in events:
        if e.get("ph") == "X" and e["name"].startswith(("verify.", "blocksync.")):
            n = out.setdefault(e["name"], [0, 0.0])
            n[0] += 1
            n[1] += e["dur"] / 1e3
    return {k: [c, round(ms / c, 4)] for k, (c, ms) in sorted(out.items())}


def replay_phases(dev, log, require, zero_counts, read_counts, d):
    """Phase 25 of main(): the blocksync replay at BASELINE.json config 5's
    width.  ``d`` carries phase 2's inputs for the traced verify_commit.
    Returns the record."""
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.blocksync import CommitStreamVerifier, verify_ahead
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.models.verifier import CpuEd25519BatchVerifier
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.utils import tracing
    from cometbft_tpu_torch.verifysvc import ServiceBatchVerifier, global_service
    from cometbft_tpu_torch.wire.canonical import Timestamp

    t_phase = time.perf_counter()
    smi = d["smi"]
    rng = np.random.default_rng(SEED + 25)
    rec = {}

    # ------------------------------------------------ inputs
    t0 = time.perf_counter()
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(V_REPLAY)]
    vals = T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in keys])
    by_addr = {k.pub_key().address(): k for k in keys}
    signers = [by_addr[v.address] for v in vals.validators]
    pubs = vals.pub_keys_bytes()
    alien = host.PrivKey.from_seed(rng.bytes(32))
    chain, items_of, expect_of = [], [], []
    for b in range(N_REPLAY_BLOCKS):
        height = REPLAY_HEIGHT + b
        bid = T.BlockID(hash=rng.bytes(32), part_set_header=T.PartSetHeader(total=1, hash=rng.bytes(32)))
        nanos = rng.integers(0, 1_000_000_000, size=V_REPLAY).tolist()
        absent = set(rng.choice(V_REPLAY, V_REPLAY // 5, replace=False).tolist()) if b == REPLAY_ABSENT else set()
        cs = [T.CommitSig.absent() if i in absent else
              T.CommitSig(T.BLOCK_ID_FLAG_COMMIT, v.address, Timestamp(seconds=TS_SECONDS + b, nanos=nanos[i]), b"")
              for i, v in enumerate(vals.validators)]
        commit = T.Commit(height=height, round=0, block_id=bid, signatures=cs)
        sb = commit.vote_sign_bytes_fn(CHAIN_ID)
        for i, c in enumerate(cs):
            if i not in absent:
                c.signature = signers[i].sign(sb(i))
        if b == REPLAY_FLIP[0]:  # the signer signed nanos; the commit carries nanos ^ 1
            c = cs[REPLAY_FLIP[1]]
            c.timestamp = Timestamp(seconds=c.timestamp.seconds, nanos=c.timestamp.nanos ^ 1)
        chain.append((bid, height, commit))
        items = [(pubs[i], sb(i), c.signature) for i, c in enumerate(cs) if i not in absent]
        expect = [True] * len(items)
        if b == REPLAY_FLIP[0]:
            expect[REPLAY_FLIP[1]] = False
        if b == REPLAY_FOREIGN[0]:  # a foreign key, validly signing its own message
            m = b"foreign-" + items[REPLAY_FOREIGN[1]][1]
            items[REPLAY_FOREIGN[1]] = (alien.pub_key().data, m, alien.sign(m))
        items_of.append(items)
        expect_of.append((all(expect), expect))
    t_inputs = time.perf_counter() - t0
    # the host oracle on every planted row and a sample of each block's rows
    t0 = time.perf_counter()
    n_oracle = 0
    for b, items in enumerate(items_of):
        rows = set(rng.choice(len(items), N_REPLAY_ORACLE_SAMPLE, replace=False).tolist())
        rows |= {REPLAY_FLIP[1]} if b == REPLAY_FLIP[0] else set()
        rows |= {REPLAY_FOREIGN[1]} if b == REPLAY_FOREIGN[0] else set()
        rows = sorted(rows)
        oracle = CpuEd25519BatchVerifier()
        oracle._items = [items[i] for i in rows]
        _, got = oracle.verify()
        require(got == [expect_of[b][1][i] for i in rows], f"25: block {b}'s expected verdicts != the host oracle")
        n_oracle += len(rows)
    log(f"[25] inputs: {V_REPLAY} validators of equal power, {N_REPLAY_BLOCKS} commits at heights "
        f"{REPLAY_HEIGHT}..{REPLAY_HEIGHT + N_REPLAY_BLOCKS - 1} (BASELINE.json config 5: 50,000 blocks x "
        f"5,000-validator commits; depth cut to {N_REPLAY_BLOCKS} blocks for the time limit, width uncut), "
        f"every row signed over its Vote sign-bytes: {t_inputs:.1f} s; planted: block {REPLAY_FLIP[0]} row "
        f"{REPLAY_FLIP[1]} a flipped sign-bytes byte, block {REPLAY_FOREIGN[0]} row {REPLAY_FOREIGN[1]} a "
        f"foreign key (in (a)'s items), block {REPLAY_ABSENT} {V_REPLAY // 5} rows absent; expected verdicts "
        f"== the host oracle on {n_oracle} rows ({time.perf_counter() - t0:.1f} s)")

    # ------------------------------------------------ (a) CommitStreamVerifier, depth 1 and 2 in turns
    cache = cv.ValsetCombCache()
    entry = cache.ensure(pubs, device=dev)
    svc = global_service(dev)
    before = svc.stats()
    runs = {1: [], 2: []}
    outs = {}
    zero_counts()
    for _ in range(REPLAY_TURNS):
        for depth in (1, 2):
            t0 = time.perf_counter()
            got = list(CommitStreamVerifier(entry, depth=depth, service=svc).run(items_of))
            runs[depth].append((time.perf_counter() - t0) * 1e3)
            require(got == expect_of, f"25(a): depth {depth}: a block's verdicts != the expected (host oracle)")
            if depth in outs:
                require(got == outs[depth], f"25(a): depth {depth}'s verdicts moved between turns")
            outs[depth] = got
    require(outs[1] == outs[2], "25(a): depth 2's verdicts != depth 1's")
    c_a = read_counts("replay_stream")
    n_runs = 2 * REPLAY_TURNS
    comb_blocks = N_REPLAY_BLOCKS - 1
    require(c_a["parse_verify_payload"] == c_a["verify_cached"] == comb_blocks * n_runs
            and c_a["sha512_blocks"] == N_REPLAY_BLOCKS * n_runs and c_a["verify_batch"] == n_runs
            and c_a["build_a_tables"] == 0,
            f"25(a): launches {c_a}: each run K1, K4 on {comb_blocks} blocks, K2 on all, K5 on the demoted one")
    st = svc.stats()
    n_bs = st["dispatched_batches"]["blocksync"] - before["dispatched_batches"]["blocksync"]
    require(n_bs == N_REPLAY_BLOCKS * n_runs and not any(
        st["rejected"][k] - before["rejected"][k] for k in st["rejected"]), f"25(a): {n_bs} BLOCKSYNC batches")
    # the stage's fresh page-locked result buffer a call (models/comb_verifier.py): its host cost
    pin_us = []
    for _ in range(200):
        t0 = time.perf_counter()
        torch.empty((entry.vpad // 8 + 1,), dtype=torch.uint8, pin_memory=True)
        pin_us.append((time.perf_counter() - t0) * 1e6)
    rec["replay_pinned_result_alloc_us"] = float(np.median(pin_us))
    ms_block = {k: min(v) / N_REPLAY_BLOCKS for k, v in runs.items()}
    # one block's work alone, with no caller beside it: the staging
    # thread's fill (host clock), and K1, K2 and K4 at the stream's shape
    # by events, each alone and back to back as the stage launches them
    from cometbft_tpu_torch.ops import comb, sha2
    b0 = 0
    items0 = items_of[b0]
    rows0 = np.asarray([entry.index[p] for p, _, _ in items0], dtype=np.int64)
    fills_alone = []
    packed0 = cv._pack(items0)  # as CombBatchVerifier.add() packs them
    for _ in range(REPLAY_FILL_REPS):
        slab = entry.acquire_slab(cv._payload_width(items0))
        t0 = time.perf_counter()
        cv._fill_payload(slab, *packed0, rows0)
        fills_alone.append((time.perf_counter() - t0) * 1e3)
        entry.release_slab(slab)
    payload0 = torch.from_numpy(cv.assemble_payload(items0, rows0, entry.vpad)).to(dev)
    lanes, width0 = payload0.shape
    nb0 = sha2.nblocks_for(width0 - 68)
    blocks0 = torch.empty((lanes, nb0, 128), dtype=torch.uint8, device=dev)
    active0 = torch.empty((lanes,), dtype=torch.int32, device=dev)
    dig0 = torch.empty((lanes, 64), dtype=torch.uint8, device=dev)
    out0 = torch.empty((lanes // 8 + 1,), dtype=torch.uint8, device=dev)
    cnt0 = torch.empty((2,), dtype=torch.int32, device=dev)
    valid0 = entry.valid.to(torch.uint8)
    block_kernels = {
        "parse_verify_payload": lambda: sha2.launch_k1(payload0, entry.pubs, blocks0, active0),
        "sha512_blocks": lambda: sha2.launch_k2(blocks0, active0, dig0),
        "verify_cached": lambda: comb.launch_k4(entry.tables, valid0, payload0, dig0, entry.b_tables, cnt0, out0),
        "device_verify": lambda: cv.device_verify(entry.tables, entry.valid, entry.pubs, payload0, entry.b_tables),
    }
    for fn in block_kernels.values():
        fn()
    torch.cuda.synchronize()
    require(torch.equal(out0, cv.device_verify(entry.tables, entry.valid, entry.pubs, payload0, entry.b_tables))
            and np.array_equal(np.unpackbits(out0[:-1].cpu().numpy(), count=lanes).astype(bool)[rows0],
                               np.asarray(expect_of[b0][1])) and bool(out0[-1]) == expect_of[b0][0],
            f"25(a): block {b0}'s K4 verdicts alone != the expected")
    block_ms = {name: cuda_ms(fn, *TIMING["verify_cached" if name == "device_verify" else name][:2])
                for name, fn in block_kernels.items()}
    k_sum = block_ms["parse_verify_payload"] + block_ms["sha512_blocks"] + block_ms["verify_cached"]
    rec["replay_block_alone"] = {"rows": len(items0), "lanes": lanes, "width": width0, "kernels_ms": block_ms,
                                 "k1_k2_k4_ms": k_sum, "fill_ms_p50": float(np.median(fills_alone)),
                                 "fill_ms": fills_alone,
                                 "k1_k2_k4_share_of_ms_a_block": {f"depth{k}": k_sum / v for k, v in ms_block.items()}}
    rec["replay_ms_per_block"] = {f"depth{k}": v for k, v in ms_block.items()}
    rec["replay_blocks_per_s"] = {f"depth{k}": 1e3 / v for k, v in ms_block.items()}
    rec["replay_runs_ms"] = {f"depth{k}": v for k, v in runs.items()}
    log(f"[25a] ({smi}) CommitStreamVerifier over the {N_REPLAY_BLOCKS} commits under BLOCKSYNC, tables warm, "
        f"depth 1 and 2 in turns x {REPLAY_TURNS}: every block's verdicts == the expected (host oracle), "
        f"in order, depth 2 == depth 1 bit for bit; runs (ms) "
        + json.dumps({k: [round(x, 2) for x in v] for k, v in runs.items()})
        + f"; best run a block: depth 1 {ms_block[1]:.3f} ms ({1e3 / ms_block[1]:.1f} blocks/s), depth 2 "
        f"{ms_block[2]:.3f} ms ({1e3 / ms_block[2]:.1f} blocks/s); launches {json.dumps({k: v for k, v in c_a.items() if v})} "
        f"(the foreign-key block demoted to K2 -> K5); the stage's fresh pinned result buffer "
        f"({entry.vpad // 8 + 1} B) costs {rec['replay_pinned_result_alloc_us']:.1f} us a call (p50 of 200 "
        f"allocations, host clock)")
    log(f"[25a] ({smi}) block {b0} alone ({len(items0)} rows on {lanes} lanes, payload width {width0}): the fill "
        f"p50 {rec['replay_block_alone']['fill_ms_p50']:.3f} ms over {REPLAY_FILL_REPS} (host clock, no caller "
        f"beside it); by events K1 {block_ms['parse_verify_payload']:.4f} ms, K2 {block_ms['sha512_blocks']:.4f}, "
        f"K4 {block_ms['verify_cached']:.4f} (sum {k_sum:.4f}), the three back to back through device_verify "
        f"{block_ms['device_verify']:.4f} ms; K1 + K2 + K4 alone over the best run's ms a block: depth 1 "
        f"{100 * k_sum / ms_block[1]:.2f}%, depth 2 {100 * k_sum / ms_block[2]:.2f}% (a ratio of two "
        f"measurements, not a traced idle share); K4's verdicts == the expected")

    # ------------------------------------------------ (b) the reactor's verify-ahead, from a cold set
    cold = cv.ValsetCombCache()
    zero_counts()
    t0 = time.perf_counter()
    got_b = list(verify_ahead(CHAIN_ID, vals, chain, 2, device=dev, comb_cache=cold))
    t_b = (time.perf_counter() - t0) * 1e3
    cold.join_async()
    c_b = read_counts("replay_verify_ahead")
    require([h for h, _, _ in got_b] == [h for _, h, _ in chain], "25(b): heights out of order")
    for b, (h, route, err) in enumerate(got_b):
        if b == REPLAY_FLIP[0]:
            require(isinstance(err, validation.CommitVerificationError)
                    and str(err).startswith(f"wrong signature (#{REPLAY_FLIP[1]}):"),
                    f"25(b): block {b} not blamed on row {REPLAY_FLIP[1]}: {err!r}")
        else:
            require(err is None, f"25(b): block {b} at height {h} refused: {err!r}")
    routes = [r for _, r, _ in got_b]
    n_route = {r: routes.count(r) for r in sorted(set(routes))}
    require(set(routes) <= {"comb", "plain"} and routes[0] == "plain"
            and routes == sorted(routes, key=lambda r: r == "comb"),
            f"25(b): routes {routes}: uncached first (the cold set), then the comb route once its tables landed")
    # uncached requests of one class may merge into one batch (the plain
    # mode coalesces), so K5 runs at most once a plain block
    require(c_b["build_a_tables"] == 1 and c_b["verify_cached"] == c_b["parse_verify_payload"]
            == n_route.get("comb", 0) and 1 <= c_b["verify_batch"] <= n_route["plain"]
            and c_b["sha512_blocks"] == c_b["verify_cached"] + c_b["verify_batch"],
            f"25(b): launches {c_b} for routes {n_route}")
    rec.update(replay_verify_ahead_routes=n_route, replay_verify_ahead_k5_launches=c_b["verify_batch"],
               replay_verify_ahead_ms=t_b,
               replay_verify_ahead_ms_per_block=t_b / N_REPLAY_BLOCKS)
    log(f"[25b] ({smi}) the reactor's verify-ahead (submit_verify_commit_light under BLOCKSYNC, depth 2) over "
        f"the {N_REPLAY_BLOCKS} commits from a cold set: {json.dumps(n_route)} blocks by route (uncached while "
        f"K3 built the tables in the background, then comb; the uncached blocks in {c_b['verify_batch']} K5 "
        f"launches, merged in the class), {t_b:.1f} ms in all ({t_b / N_REPLAY_BLOCKS:.2f} "
        f"ms a block, the commits' sign-bytes and power tally included); block {REPLAY_FLIP[0]} blamed on row "
        f"{REPLAY_FLIP[1]}, every other commit verified; launches {json.dumps({k: v for k, v in c_b.items() if v})}")

    # ------------------------------------------------ (d) traces
    os.makedirs("build", exist_ok=True)
    real_collect = ServiceBatchVerifier.collect
    tracing.set_enabled(True)  # what COMETBFT_TPU_TRACE=1 sets at import
    try:
        tracing.reset()

        def commits():  # the caller's host work a block: the commit's sign-bytes and items
            for b, (bid, h, commit) in enumerate(chain):
                with tracing.span("replay.assemble", {"height": h}):
                    sb = commit.vote_sign_bytes_fn(CHAIN_ID)
                    items = [(pubs[i], sb(i), c.signature) for i, c in enumerate(commit.signatures)
                             if not c.absent_flag()]
                    if b == REPLAY_FOREIGN[0]:
                        items[REPLAY_FOREIGN[1]] = items_of[b][REPLAY_FOREIGN[1]]
                yield items

        def waited(self, ticket):
            with tracing.span("replay.caller_wait"):
                return real_collect(self, ticket)

        ServiceBatchVerifier.collect = waited
        t0 = time.perf_counter_ns()
        got_d = list(CommitStreamVerifier(entry, depth=2, service=svc).run(commits()))
        t1 = time.perf_counter_ns()
        ServiceBatchVerifier.collect = real_collect
        require(got_d == expect_of, "25(d): the traced run's verdicts != the expected")
        stream_path = os.path.join("build", "trace_replay_depth2.json")
        n_ev = tracing.export_chrome_trace(stream_path)
        events = tracing.chrome_trace_events()
        tracing.reset()
        validation.verify_commit(d["chain_id"], d["vals"], d["bid"], d["height"], d["good"], device=dev,
                                 comb_cache=d["cache"])
        commit_path = os.path.join("build", "trace_verify_commit.json")
        n_ev4 = tracing.export_chrome_trace(commit_path)
        events4 = tracing.chrome_trace_events()
    finally:
        ServiceBatchVerifier.collect = real_collect
        tracing.set_enabled(False)
        tracing.reset()
    names = {e["tid"]: e["args"]["name"] for e in events if e.get("name") == "thread_name"}

    def intervals(name, thread=None):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("ph") == "X" and e["name"] == name
                      and (thread is None or names.get(e["tid"]) == thread))

    fills = intervals("verify.slab_fill")
    require(fills and {names.get(e["tid"]) for e in events if e.get("name") == "verify.slab_fill"}
            == {"comb-stage_0"}, "25(d): the fills did not all run on the staging thread")
    caller = intervals("replay.assemble", "MainThread")
    wall_ms = (t1 - t0) / 1e6
    overlap = _overlap_ms(fills, caller)
    fill_ms = sum(e - s for s, e in fills) / 1e3
    wait_ms = sum(e - s for s, e in intervals("replay.caller_wait", "MainThread")) / 1e3
    spans = _span_summary(events)
    spans4 = _span_summary(events4)
    rec.update(replay_trace={"path": stream_path, "events": n_ev, "wall_ms": wall_ms, "spans": spans,
                             "fill_ms": fill_ms, "fill_overlap_caller_ms": overlap,
                             "fill_overlap_share_of_wall": overlap / wall_ms, "caller_wait_ms": wait_ms},
               verify_commit_trace={"path": commit_path, "events": n_ev4, "spans": spans4})
    log(f"[25d] ({smi}) traces (tracing on, as COMETBFT_TPU_TRACE=1): {stream_path} ({n_ev} events) of (a) at "
        f"depth 2 with the caller assembling each commit from its sign-bytes, {wall_ms:.1f} ms; the staging "
        f"thread's verify.slab_fill {fill_ms:.1f} ms in all, {overlap:.1f} ms of it beside the caller's "
        f"assembly: {100 * overlap / wall_ms:.2f}% of the wall; the caller waited {wait_ms:.1f} ms in collect; "
        f"spans [calls, ms a call] " + json.dumps(spans))
    log(f"[25d] ({smi}) {commit_path} ({n_ev4} events) of phase 4's verify_commit at {len(d['vals'].validators)} "
        f"validators, tables warm: spans [calls, ms a call] " + json.dumps(spans4))
    rec["replay_phase_s"] = time.perf_counter() - t_phase
    log(f"[25] the replay phase: {rec['replay_phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------- failover
# Phase 26: the verify service's failover at full width.  The faults are
# planted only on small batches (phase 7's 150-validator commit, one
# CheckTx): the host verify of an ed25519 signature is pure Python where
# the `cryptography` package is missing, so a stranded 10,000-row commit
# would take minutes to verify again on the host.
FAILOVER_TURNS = 4  # (a): failover on and off in turns, this many times each
FAILOVER_CALLS = 3  # (a): timed verify_commit calls a turn, after 1
FAILOVER_DEADLINE_MS = 2_000  # (c)'s batch deadline
FAILOVER_PROBE_PERIOD_MS = 1_000  # (c)'s probation probe period
FAILOVER_PROBE_TIMEOUT_MS = 120_000  # (c)'s probe deadline: a child that imports torch and starts CUDA
FAILOVER_COLLECT_TIMEOUT_MS = 300  # (d)'s client deadline
FAILOVER_SLOW_S = 2.0  # (d)'s slow_collect
FAILOVER_FLIP = 77  # the row of phase 7's commit whose signature (b)-(d) flip
REVERIFY_CAUSES = ("wedge", "dispatch_error", "submit_error", "collect_error")


def failover_counts() -> dict:
    """The process's failover tallies: trips by the hub and by every
    global service, host re-verifies of every cause."""
    from cometbft_tpu_torch.utils.metrics import hub
    from cometbft_tpu_torch.verifysvc import service as S

    m = hub()
    return {"trips": m.verify_svc_failover.value(direction="to_cpu"),
            "service_trips": sum(s.stats(lock_timeout=5.0)["failover"]["trips"] for s in list(S._GLOBAL.values())),
            "host_reverify": sum(m.verify_svc_host_reverify.value(cause=c) for c in REVERIFY_CAUSES)}


def failover_phases(dev, log, require, zero_counts, read_counts, d):
    """Phase 26 of main(): (a) phase 4's verify_commit with failover on
    (the watchdog ticking, the health sentinel started by the card's
    global service under COMETBFT_TPU_HEALTH=1) and off, in turns; (b) fail_dispatch on phase 7's commit with a flipped signature,
    verified again on the host; (c) wedge_device on it under a 2-s batch
    deadline: the trip, the host re-verify, one forensics artifact, the
    real subprocess probe's probation and the restore, then the
    10,000-row commit through K1 -> K2 -> K4 again; (d) slow_collect past
    a 300-ms client deadline: the stall report (one artifact for two
    stalls) and the host path.  Returns the record."""
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.utils import fail, healthmon
    from cometbft_tpu_torch.utils.flightrec import recorder
    from cometbft_tpu_torch.utils.metrics import hub
    from cometbft_tpu_torch.verifysvc import checktx
    from cometbft_tpu_torch.verifysvc import service as S

    t_phase = time.perf_counter()
    smi = d["smi"]
    art_dir = os.path.join("build", "failover")
    os.makedirs(art_dir, exist_ok=True)
    for fn in os.listdir(art_dir):
        os.remove(os.path.join(art_dir, fn))
    chain_id, vals, bid, height, cache = (d[k] for k in ("chain_id", "vals", "bid", "height", "cache"))
    kw = dict(device=dev, comb_cache=cache)
    knobs = ("COMETBFT_TPU_FAILOVER", "COMETBFT_TPU_FAILOVER_BATCH_DEADLINE_MS",
             "COMETBFT_TPU_FAILOVER_PROBE_PERIOD_MS", "COMETBFT_TPU_FAILOVER_PROBE_TIMEOUT_MS",
             "COMETBFT_TPU_VERIFYSVC_COLLECT_TIMEOUT_MS", "COMETBFT_TPU_HEALTH", "COMETBFT_TPU_HEALTH_DIR")
    saved = {k: os.environ.get(k) for k in knobs}
    m = hub()
    rec = {}

    def fresh_service(**env):
        """The global service of the card made anew under ``env``, its
        artifacts in build/failover."""
        S.reset_global_service()
        for k in knobs:
            if saved[k] is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = saved[k]
        os.environ.update({k: str(v) for k, v in env.items()})
        svc = S.global_service(dev)
        svc.artifact_dir = art_dir
        return svc

    def reverified(cause):
        return m.verify_svc_host_reverify.value(cause=cause)

    # phase 7's commit with one flipped signature: the blame every route must give
    lvals, lcommit = d["lvals"], d["lcommit"]
    cs = lcommit.signatures[FAILOVER_FLIP]
    flipped = type(cs)(cs.block_id_flag, cs.validator_address, cs.timestamp,
                       cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:])
    lbad = type(lcommit)(height=lcommit.height, round=lcommit.round, block_id=lcommit.block_id,
                         signatures=[flipped if i == FAILOVER_FLIP else s for i, s in enumerate(lcommit.signatures)])

    def light(commit):
        """verify_commit_light_trusting on the 150 validators, every
        signature counted -> None or the error's text."""
        try:
            validation.verify_commit_light_trusting(chain_id, lvals, commit, Fraction(1, 3),
                                                    count_all_signatures=True, **kw)
        except validation.CommitVerificationError as e:
            return str(e)
        return None

    try:
        # ------------------------------------------------ (a) the watchdog's cost
        walls = {"on": [], "off": []}
        # the sentinel through the port's entry point: the card's first
        # global service starts it (a first probe at once, then one a
        # minute, the JAX default)
        require(healthmon.monitor() is None, "(a) a health sentinel was already installed")
        try:
            for turn in range(FAILOVER_TURNS):
                for mode in (("on", "off") if turn % 2 == 0 else ("off", "on")):
                    fresh_service(COMETBFT_TPU_FAILOVER=int(mode == "on"), COMETBFT_TPU_HEALTH=1,
                                  COMETBFT_TPU_HEALTH_DIR=art_dir)
                    mon = healthmon.monitor()
                    require(mon is not None, "(a) COMETBFT_TPU_HEALTH=1 started no sentinel with the global service")
                    validation.verify_commit(chain_id, vals, bid, height, d["good"], **kw)
                    for _ in range(FAILOVER_CALLS):
                        t0 = time.perf_counter()
                        validation.verify_commit(chain_id, vals, bid, height, d["good"], **kw)
                        walls[mode].append((time.perf_counter() - t0) * 1e3)
            probes = mon.snapshot()
        finally:
            healthmon.uninstall()
        require(failover_counts()["trips"] == 0, "(a) tripped")
        p50 = {k: float(np.median(v)) for k, v in walls.items()}
        rec["failover_watchdog_p50_ms"] = p50
        log(f"[26a] ({smi}) verify_commit at {len(vals.validators)} validators through the service, "
            f"{FAILOVER_TURNS} turns of {FAILOVER_CALLS} calls each: failover on (watchdog ticking, health "
            f"sentinel started: {probes['probe_attempts']} probe(s), state {probes['state']}, last "
            f"{json.dumps(probes['last_probe'])}) p50 {p50['on']:.2f} ms, off p50 {p50['off']:.2f} ms "
            f"({p50['on'] - p50['off']:+.2f}); 0 trips")

        # ------------------------------------------------ (b) fail_dispatch
        svc = fresh_service()
        zero_counts()
        want_b = light(lbad)
        c_clean = read_counts("failover_clean")
        require(bool(want_b) and want_b.startswith(f"wrong signature (#{FAILOVER_FLIP}):"),
                f"(b) the unfaulted commit's blame: {want_b}")
        require(c_clean["verify_batch"] == 1, f"(b) the unfaulted commit's launches {c_clean}")
        before = reverified("dispatch_error")
        fail.arm("fail_dispatch")
        try:
            zero_counts()
            got_b = light(lbad)
            c_fault = read_counts()
        finally:
            fail.clear("fail_dispatch")
        require(got_b == want_b, f"(b) blame {got_b} != {want_b}")
        require(reverified("dispatch_error") == before + 1, "(b) not one dispatch-error re-verify")
        require(svc.backend_mode == S.MODE_TPU and svc.stats()["failover"]["trips"] == 0, "(b) tripped")
        require(c_fault["verify_batch"] == 0, f"(b) the faulted batch reached the card: {c_fault}")
        require(light(lcommit) is None, "(b) phase 7's commit after the fault")
        log(f"[26b] ({smi}) fail_dispatch on phase 7's {len(lvals.validators)}-validator commit with row "
            f"{FAILOVER_FLIP}'s signature flipped: verified again on the host, blame {got_b!r} == the card's "
            f"(K5 {c_clean['verify_batch']} launch unfaulted, {c_fault['verify_batch']} faulted); "
            f"verify_svc_host_reverify{{cause=dispatch_error}} +1; backend mode tpu")

        # ------------------------------------------------ (d) slow_collect past the client's deadline
        svc = fresh_service(COMETBFT_TPU_VERIFYSVC_COLLECT_TIMEOUT_MS=FAILOVER_COLLECT_TIMEOUT_MS)
        S._reset_stall_gate()
        sec = d["secp"]
        pub, smsg, ssig = sec["items"][0]
        tx = (checktx.MAGIC_V2 + bytes([SECP_KEY_TYPE_BYTE[len(pub)]]) + pub + ssig
              + smsg[len(checktx.SIGN_DOMAIN):])
        stalls0 = {k: m.verify_svc_collect_timeout.value(**{"class": k}) for k in ("consensus", "mempool")}
        fail.arm("slow_collect", FAILOVER_SLOW_S)
        try:
            t0 = time.perf_counter()
            got_d = light(lbad)
            t_d = time.perf_counter() - t0
            got_tx = checktx.verify_tx_signature(tx, service=svc)
        finally:
            fail.clear("slow_collect")
        stalls = {k: m.verify_svc_collect_timeout.value(**{"class": k}) - v for k, v in stalls0.items()}
        arts_d = sorted(os.listdir(art_dir))
        require(got_d == want_b and got_tx == sec["verdicts"][0], f"(d) host-path verdicts {got_d}, {got_tx}")
        require(stalls == {"consensus": 1, "mempool": 1}, f"(d) stall counts {stalls}")
        require(len(arts_d) == 1, f"(d) {len(arts_d)} stall artifacts, not one")
        require(svc.stats()["failover"]["trips"] == 0 and failover_counts()["trips"] == 0, "(d) tripped")
        rec["failover_stall_caller_s"] = t_d
        log(f"[26d] ({smi}) slow_collect {FAILOVER_SLOW_S} s past a {FAILOVER_COLLECT_TIMEOUT_MS}-ms client "
            f"deadline: phase 7's commit with the flipped row answered on the host path in {t_d:.2f} s, blame "
            f"{got_d!r}; a CheckTx (secp) answered {got_tx}; two stall reports "
            f"(verify_svc_collect_timeout {stalls}), one artifact ({arts_d[0]}); no trip")
        for fn in arts_d:
            os.remove(os.path.join(art_dir, fn))

        # ------------------------------------------------ (c) the wedge: trip, re-verify, probe, restore
        svc = fresh_service(COMETBFT_TPU_FAILOVER_BATCH_DEADLINE_MS=FAILOVER_DEADLINE_MS,
                            COMETBFT_TPU_FAILOVER_PROBE_PERIOD_MS=FAILOVER_PROBE_PERIOD_MS,
                            COMETBFT_TPU_FAILOVER_PROBE_TIMEOUT_MS=FAILOVER_PROBE_TIMEOUT_MS)
        real_probe, probe_log = svc._probe_fn, []

        def probe(timeout_s):  # the service's own subprocess probe, its results kept
            res = real_probe(timeout_s)
            probe_log.append(res)
            return res

        svc._probe_fn = probe
        seq0 = (recorder().dump()["entries"] or [{"seq": 0}])[-1]["seq"]
        wedge0 = reverified("wedge")
        zero_counts()
        fail.arm("wedge_device")
        t0 = time.perf_counter()
        try:
            got_c = light(lbad)
            t_answer = time.perf_counter() - t0
            c_wedge = read_counts("failover_wedge")
            deadline = time.monotonic() + 60
            while svc.stats()["failover"]["last_artifact"] is None:
                require(time.monotonic() < deadline, "(c) no forensics artifact")
                time.sleep(0.05)
        finally:
            fail.clear("wedge_device")
        t_clear = time.perf_counter()
        ev = [e for e in recorder().dump()["entries"] if e["seq"] > seq0 and e["kind"] == "verifysvc_failover"]
        require(len(ev) >= 1 and ev[0]["detail"]["direction"] == "to_cpu", f"(c) events {ev}")
        t_trip = ev[0]["mono_ns"] / 1e9 - t0  # the recorder's mono_ns is perf_counter_ns
        fo = svc.stats()["failover"]
        arts_c = sorted(os.listdir(art_dir))
        require(got_c == want_b, f"(c) the stranded batch's blame {got_c} != {want_b}")
        require(fo["trips"] == 1 and "deadline" in fo["last_trip_reason"], f"(c) failover {fo}")
        require(reverified("wedge") == wedge0 + 1, "(c) not one stranded batch re-verified")
        require(c_wedge["verify_batch"] == 1, f"(c) the wedged batch's launches {c_wedge}")
        require(len(arts_c) == 1 and os.path.join(art_dir, arts_c[0]) == fo["last_artifact"],
                f"(c) artifacts {arts_c}, {fo['last_artifact']}")
        deadline = time.monotonic() + 5 * FAILOVER_PROBE_TIMEOUT_MS / 1e3
        while svc.backend_mode != S.MODE_TPU:
            require(time.monotonic() < deadline, f"(c) no restore; probes {[p.to_dict() for p in probe_log]}")
            time.sleep(0.05)
        t_restore = time.perf_counter() - t_clear
        fo = svc.stats()["failover"]
        ok_probes = [p for p in probe_log if p.ok]
        require(fo["restores"] == 1 and len(ok_probes) >= svc.probation_ok, f"(c) failover {fo}")
        zero_counts()
        validation.verify_commit(chain_id, vals, bid, height, d["good"], **kw)
        c_after = read_counts("failover_restored")
        require((c_after["parse_verify_payload"], c_after["sha512_blocks"], c_after["verify_cached"],
                 c_after["verify_batch"]) == (1, 1, 1, 0), f"(c) launches after the restore {c_after}")
        try:
            validation.verify_commit(chain_id, vals, bid, height, d["faulted"], **kw)
            raise AssertionError("(c) the planted commit verified after the restore")
        except validation.CommitVerificationError as e:
            require(str(e) == d["blame"], f"(c) blame after the restore {e} != phase 2's")
        rec.update(failover_trip_s=t_trip, failover_answer_s=t_answer, failover_restore_s=t_restore,
                   failover_probe_s=[p.latency_s for p in probe_log], failover_probes_ok=len(ok_probes))
        log(f"[26c] ({smi}) wedge_device on phase 7's commit under a {FAILOVER_DEADLINE_MS}-ms batch deadline: "
            f"tripped {t_trip:.2f} s after the submit (K5 launched {c_wedge['verify_batch']}), the stranded batch "
            f"verified again on the host in add() order, the caller answered in {t_answer:.2f} s with blame "
            f"{got_c!r}; one artifact {arts_c[0]}; the wedge cleared, the real subprocess probe "
            f"({len(probe_log)} probe(s), latencies {[round(p.latency_s, 2) for p in probe_log]} s, "
            f"{len(ok_probes)} ok: {ok_probes[0].detail if ok_probes else '-'}) restored the card "
            f"{t_restore:.2f} s after the clear; then the {len(vals.validators)}-row commit launched K1 "
            f"{c_after['parse_verify_payload']}, K2 {c_after['sha512_blocks']}, K4 {c_after['verify_cached']}, "
            f"K5 {c_after['verify_batch']}, and the planted commit's blame == phase 2's")
        expo = [ln for ln in m.registry.expose_text().splitlines()
                if "verify_svc" in ln or "health_" in ln or "verify_phase" in ln]
        log("[26] hub exposition (verify_svc_*, verify_phase_seconds, health_*): " + json.dumps("\n".join(expo)))
    finally:
        fail.clear_all()
        healthmon.uninstall()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        S.reset_global_service()
    rec["failover_phase_s"] = time.perf_counter() - t_phase
    log(f"[26] ({smi}) failover phase {rec['failover_phase_s']:.1f} s")
    return rec


LIGHT_HEIGHTS = 1_000  # heights of phase 27's chain (its sets of V_MAIN)
LIGHT_SHIFT = 1_000  # keys the set's window moves ...
LIGHT_EVERY = 100  # ... every this many heights
LIGHT_FORK = 700  # the lunatic primary's first forked height
LIGHT_SEQ_HEIGHTS = 64  # (c): BASELINE.json config 2's sequential sync over V_LIGHT validators


def light_phases(dev, log, require, zero_counts, read_counts, d):
    """Phase 27 of main(): the light client at 10,000 validators over a
    chain whose set moves by 1,000 keys every 100 heights.  (a) a SKIPPING
    sync of 1,000 heights over a MemDB store with one honest witness:
    the trace against the host's replay of the bisection, every stored
    block decoded back, each new set's hash on K7 + K8, each hop's
    commit checks on K2 -> K5 or K1 -> K2 -> K4; cold, then from a fresh
    store with the tables warm; (b) a lunatic primary forked at
    LIGHT_FORK: the attack detected, its evidence against a host
    computation, verify_light_client_attack (CONSENSUS, every signature
    counted) passing and refusing two tamperings, one duplicate vote;
    (c) BASELINE.json config 2: a SEQUENTIAL sync over 64 heights of a
    150-validator chain, every hop K2 -> K5 at 256 lanes.  Returns the
    record."""
    import copy

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_light_corpus as LCo

    from cometbft_tpu_torch import light
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.evidence import verify as EV
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.models.verifier import _next_bucket
    from cometbft_tpu_torch.ops import ed25519 as E
    from cometbft_tpu_torch.store import MemDB
    from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence
    from cometbft_tpu_torch.verifysvc import global_service
    from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE

    t_phase = time.perf_counter()
    smi = d["smi"]
    rec = {}
    chain_id = CHAIN_ID + "-light"
    t0 = time.perf_counter()
    keys = LCo.make_keys(SEED + 27, LIGHT_SHIFT * (LIGHT_HEIGHTS // LIGHT_EVERY) + V_MAIN)
    honest = LCo.Chain(chain_id, keys, LIGHT_HEIGHTS, V_MAIN, LIGHT_SHIFT, LIGHT_EVERY)
    forked = LCo.Chain(chain_id, keys, LIGHT_HEIGHTS, V_MAIN, LIGHT_SHIFT, LIGHT_EVERY, fork_from=LIGHT_FORK,
                       base=honest)
    want = LCo.expected_trace(honest, 1, LIGHT_HEIGHTS)
    overlaps = {f"{a}->{b}": str(Fraction(len(honest.addresses(a) & honest.addresses(b)), V_MAIN))
                for a, b in zip(want, want[1:])}
    t_chain = time.perf_counter() - t0
    t0 = time.perf_counter()
    for h in want:  # signed before the timed syncs: only the heights the bisection asks for
        honest.commit(h)
    forked.commit(LIGHT_HEIGHTS)
    t_sign = time.perf_counter() - t0
    log(f"[27] chain: {len(keys)} keys, {LIGHT_HEIGHTS} heights of {V_MAIN} validators of power 10, the set "
        f"moving by {LIGHT_SHIFT} keys every {LIGHT_EVERY} heights ({t_chain:.1f} s, set hashes on the host); "
        f"expected trace from the sets' overlaps {want} (overlaps {overlaps}, trust 1/3); heights {want} and "
        f"the fork's {LIGHT_HEIGHTS} signed in {t_sign:.1f} s")
    now = LCo.GENESIS_NS + (LIGHT_HEIGHTS + 10) * LCo.BLOCK_NS
    # one entry for each set of the trace: the default two would evict the root's set on the
    # third, and the warm run would build again what the cold one built
    cache = cv.ValsetCombCache(max_entries=len(want))
    kw = dict(device=dev, comb_cache=cache)

    hash_log = []  # (validators, K7 launches, K8 launches) of every set hash computed afresh
    real_hash = T.ValidatorSet.hash

    def logged_hash(self, device="cuda"):
        if self._hash is not None:
            return real_hash(self, device)
        before = read_counts()
        out = real_hash(self, device)
        after = read_counts()
        hash_log.append((len(self.validators), after["sha256_blocks"] - before["sha256_blocks"],
                         after["merkle_tree"] - before["merkle_tree"]))
        return out

    def instrument(client, hops):
        real = client._verify

        def hop(trusted, lb, now_ns):
            before = read_counts()
            t_hop = time.perf_counter()
            try:
                real(trusted, lb, now_ns)
                ok = True
            except light.ErrNewValSetCantBeTrusted:
                ok = False
                raise
            finally:
                after = read_counts()
                hops.append({"from": trusted.height, "to": lb.height, "ok": ok,
                             "ms": (time.perf_counter() - t_hop) * 1e3,
                             "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}})

        client._verify = hop

    def signature_route(launches):
        if launches.get("sha512_blocks", 0) < 1:
            return None
        if launches.get("parse_verify_payload", 0) >= 1 and launches.get("verify_cached", 0) >= 1:
            return "K1->K2->K4" if launches.get("verify_batch", 0) == 0 else "K1->K2->K4 + K2->K5"
        return "K2->K5" if launches.get("verify_batch", 0) >= 1 else None

    def sync(tag):
        """(a): one SKIPPING sync over a fresh store; logs it, then checks it."""
        hops, hash_log[:] = [], []
        primary, witness = LCo.Provider(honest), LCo.Provider(honest)
        store = light.LightStore(MemDB())
        zero_counts()
        t_sync = time.perf_counter()
        client = light.Client(chain_id, light.TrustOptions(TRUSTING_PERIOD_NS, 1, honest.headers[1].hash()),
                              primary, [witness], store, now_fn=lambda: now, **kw)
        instrument(client, hops)
        lb = client.verify_light_block_at_height(LIGHT_HEIGHTS)
        wall = (time.perf_counter() - t_sync) * 1e3
        launches = read_counts(f"light_sync_{tag}")
        hashes = hash_log[:]  # the sync's own; the checks below hash the decoded sets on the host
        stored = [int.from_bytes(k[3:], "big") for k, _ in store.db.iterator(b"lb:", b"lb:\xff")]
        decode_ms, decoded = [], []
        for h in stored:
            t_dec = time.perf_counter()
            decoded.append(store.light_block(h))
            decode_ms.append((time.perf_counter() - t_dec) * 1e3)
        for hp in hops:
            hp["route"] = signature_route(hp["launches"])
        log(f"[27a] ({smi}) {tag} SKIPPING sync 1 -> {LIGHT_HEIGHTS}: {wall:.1f} ms; primary asked "
            f"{primary.asked}; hops "
            + "; ".join(f"{h['from']}->{h['to']} {'ok' if h['ok'] else 'cannot trust'} {h['ms']:.1f} ms "
                        f"{h['route'] or '-'} {h['launches']}" for h in hops)
            + f"; set hashes (validators, K7, K8) {hashes}; store decode of a {V_MAIN}-validator block "
            f"{', '.join(f'{x:.1f}' for x in decode_ms)} ms; launches {launches}")
        require(lb.hash == honest.headers[LIGHT_HEIGHTS].hash(), f"(a) {tag}: the synced block is not the chain's")
        require(stored == want, f"(a) {tag}: stored heights {stored} != the expected trace {want}")
        require([h["to"] for h in hops if h["ok"]] == want[1:], f"(a) {tag}: verified hops {hops} != {want}")
        require(witness.asked == [LIGHT_HEIGHTS], f"(a) {tag}: the witness was asked {witness.asked}")
        for h, back in zip(stored, decoded):
            require(back.hash == honest.headers[h].hash() and back.validator_set.hash(device=False)
                    == honest.set_hash(h), f"(a) {tag}: stored block {h} decoded to another block")
        for hp in hops:
            if hp["ok"]:
                require(hp["route"] is not None,
                        f"(a) {tag}: hop {hp['from']}->{hp['to']} launched no ed25519 chain: {hp['launches']}")
        big = [x for x in hashes if x[0] >= 512]
        require(len(big) == len(want) and all(x[1:] == (1, 1) for x in big),
                f"(a) {tag}: the new sets' hashes did not each launch K7 and K8 once: {hashes}")
        return {"wall_ms": wall, "hops": hops, "asked": primary.asked, "decode_ms": decode_ms,
                "launches": launches, "set_hashes": hashes}

    T.ValidatorSet.hash = logged_hash
    try:
        # ------------------------------------------------ (a) skipping sync
        cold = sync("cold")
        cache.join_async()  # the sets' background builds land
        warm = sync("warm")
        require(warm["launches"]["verify_batch"] == 0 and warm["launches"]["build_a_tables"] == 0
                and warm["launches"]["verify_cached"] >= 2 * len(want) - 1,
                f"(a) warm: the tables were warm, yet {warm['launches']}")
        rec["light_sync_ms"] = {"cold": cold["wall_ms"], "warm": warm["wall_ms"]}
        rec["light_hops"] = {"cold": cold["hops"], "warm": warm["hops"]}
        rec["light_store_decode_ms"] = cold["decode_ms"] + warm["decode_ms"]
        rec["light_trace"] = want

        # ------------------------------------------------ (b) a lunatic primary
        hops_b = []
        primary_f, witness_h = LCo.Provider(forked), LCo.Provider(honest)
        zero_counts()
        t0 = time.perf_counter()
        client_b = light.Client(chain_id, light.TrustOptions(TRUSTING_PERIOD_NS, 1, honest.headers[1].hash()),
                                primary_f, [witness_h], light.LightStore(MemDB()), now_fn=lambda: now, **kw)
        instrument(client_b, hops_b)
        try:
            client_b.verify_light_block_at_height(LIGHT_HEIGHTS)
            raise AssertionError("(b) the lunatic primary's block verified")
        except light.ErrLightClientAttackDetected as e:
            evidence = e.evidence
        t_detect = (time.perf_counter() - t0) * 1e3
        c_detect = read_counts("light_lunatic")
        require(len(evidence) == 2 and len(witness_h.reported_evidence) == 1
                and len(primary_f.reported_evidence) == 1,
                f"(b) evidence {len(evidence)}, to the witness {len(witness_h.reported_evidence)}, to the "
                f"primary {len(primary_f.reported_evidence)}")
        ev = witness_h.reported_evidence[0]
        w_common, w_byz, w_total = LCo.attack_fields(honest, want[-2], LIGHT_HEIGHTS)
        require(ev.common_height == w_common, f"(b) common height {ev.common_height} != {w_common}")
        require([(v.address, v.voting_power) for v in ev.byzantine_validators]
                == [(v.address, v.voting_power) for v in w_byz],
                f"(b) {len(ev.byzantine_validators)} byzantine validators != the host's {len(w_byz)}")
        require(ev.total_voting_power == w_total, f"(b) total power {ev.total_voting_power} != {w_total}")
        require(ev.conflicting_block.hash == forked.headers[LIGHT_HEIGHTS].hash(),
                "(b) the evidence's conflicting block is not the forged one")
        mirror = primary_f.reported_evidence[0]
        require(mirror.conflicting_block.hash == honest.headers[LIGHT_HEIGHTS].hash(),
                "(b) the mirror evidence's conflicting block is not the honest one")
        common_sh = honest.light_block(w_common).signed_header
        trusted_sh = honest.light_block(LIGHT_HEIGHTS).signed_header
        common_vals = honest.vals(w_common)
        svc = global_service(dev)
        before = svc.stats()["dispatched_batches"]["consensus"]
        zero_counts()
        t0 = time.perf_counter()
        EV.verify_light_client_attack(ev, common_sh, trusted_sh, common_vals, chain_id, **kw)
        t_check = (time.perf_counter() - t0) * 1e3
        c_check = read_counts("evidence_check")
        n_consensus = svc.stats()["dispatched_batches"]["consensus"] - before
        require(n_consensus == 2 and c_check["sha512_blocks"] >= 2
                and c_check["verify_cached"] + c_check["verify_batch"] >= 2,
                f"(b) the evidence check: {n_consensus} CONSENSUS batches, launches {c_check}")
        refused = {}
        for what, mutate in (("total power + 1", lambda e: setattr(e, "total_voting_power", e.total_voting_power + 1)),
                             ("a byzantine validator dropped",
                              lambda e: setattr(e, "byzantine_validators", e.byzantine_validators[1:]))):
            bad = copy.copy(ev)
            mutate(bad)
            try:
                EV.verify_light_client_attack(bad, common_sh, trusted_sh, common_vals, chain_id, **kw)
                raise AssertionError(f"(b) the evidence with {what} passed")
            except EV.EvidenceVerificationError as e:
                refused[what] = str(e)
        # one duplicate vote: two host signatures by a validator of the set at the fork's height
        dv_val = honest.validators(LIGHT_HEIGHTS)[0]
        dv_key = next(k for k in keys if k.pub_key().address() == dv_val.address)
        votes = []
        for tag in (b"a", b"b"):
            vote = T.Vote(type=PRECOMMIT_TYPE, height=LIGHT_HEIGHTS, round=0,
                          block_id=T.BlockID(hash=hashlib.sha256(tag).digest(),
                                             part_set_header=T.PartSetHeader(1, hashlib.sha256(tag + b"p").digest())),
                          timestamp=honest.time(LIGHT_HEIGHTS), validator_address=dv_val.address, validator_index=0)
            vote.signature = dv_key.sign(vote.sign_bytes(chain_id))
            votes.append(vote)
        dvals = honest.vals(LIGHT_HEIGHTS)
        dve = DuplicateVoteEvidence.from_votes(votes[0], votes[1], honest.time(LIGHT_HEIGHTS), dvals)
        EV.verify_duplicate_vote(dve, chain_id, dvals)
        bad_dve = copy.copy(dve)
        bad_dve.validator_power += 1
        try:
            EV.verify_duplicate_vote(bad_dve, chain_id, dvals)
            raise AssertionError("(b) a duplicate vote with the wrong power passed")
        except EV.EvidenceVerificationError:
            pass
        log(f"[27b] ({smi}) lunatic primary forked at {LIGHT_FORK}: detected in {t_detect:.1f} ms (hops "
            + "; ".join(f"{h['from']}->{h['to']} {'ok' if h['ok'] else 'cannot trust'} {h['ms']:.1f} ms "
                        f"{signature_route(h['launches']) or '-'}" for h in hops_b)
            + f"; launches {c_detect}); evidence against the primary: common height {ev.common_height}, "
            f"{len(ev.byzantine_validators)} byzantine validators (== the host's, by (-power, address)), total "
            f"power {ev.total_voting_power}, hash {ev.hash().hex()[:16]}; mirror evidence to the primary at "
            f"common height {mirror.common_height}; verify_light_client_attack on the honest {w_common} and "
            f"{LIGHT_HEIGHTS}: passed in {t_check:.2f} ms ({n_consensus} CONSENSUS batches: a trusting check and "
            f"a full check of {V_MAIN} rows, every signature counted; launches {c_check}); refused: "
            + json.dumps(refused) + "; one duplicate vote verified, its power + 1 refused")
        rec.update(light_detect_ms=t_detect, evidence_check_ms=t_check, evidence_check_launches=c_check,
                   evidence_byzantine=len(ev.byzantine_validators), evidence_common_height=ev.common_height)

        # ------------------------------------------------ (c) BASELINE.json config 2
        keys150 = LCo.make_keys(SEED + 28, V_LIGHT)
        chain150 = LCo.Chain(chain_id + "-150", keys150, LIGHT_SEQ_HEIGHTS, V_LIGHT, 0, 1)
        for h in range(1, LIGHT_SEQ_HEIGHTS + 1):
            chain150.commit(h)
        hops_c, lanes = [], []
        primary_c, witness_c = LCo.Provider(chain150), LCo.Provider(chain150)
        real_k5 = E.verify_batch

        def k5_lanes(a, *rest):
            lanes.append(int(a.shape[0]))
            return real_k5(a, *rest)

        E.verify_batch = k5_lanes
        try:
            zero_counts()
            t0 = time.perf_counter()
            client_c = light.Client(chain_id + "-150",
                                    light.TrustOptions(TRUSTING_PERIOD_NS, 1, chain150.headers[1].hash()),
                                    primary_c, [witness_c], light.LightStore(MemDB()), mode=light.SEQUENTIAL,
                                    now_fn=lambda: now, **kw)
            instrument(client_c, hops_c)
            client_c.verify_light_block_at_height(LIGHT_SEQ_HEIGHTS)
            t_seq = (time.perf_counter() - t0) * 1e3
            c_seq = read_counts("light_config2")
        finally:
            E.verify_batch = real_k5
        require(len(hops_c) == LIGHT_SEQ_HEIGHTS - 1 and all(
            h["ok"] and h["launches"].get("verify_batch") == 1 and h["launches"].get("sha512_blocks") == 1
            and not h["launches"].get("verify_cached") for h in hops_c),
            f"(c) a hop did not launch K2 -> K5 once: {[h for h in hops_c if h['launches'].get('verify_batch') != 1]}")
        hop_ms = [h["ms"] for h in hops_c]
        log(f"[27c] ({smi}) BASELINE.json config 2: SEQUENTIAL sync over {LIGHT_SEQ_HEIGHTS} heights of "
            f"{V_LIGHT} validators in {t_seq:.1f} ms; every hop K2 -> K5 (lanes a launch {sorted(set(lanes))}: the "
            f"commit check stops past 2/3, {_next_bucket(V_LIGHT)} lanes would hold all {V_LIGHT}); hop p50 "
            f"{np.median(hop_ms):.2f} ms (min {min(hop_ms):.2f}, max {max(hop_ms):.2f}); launches {c_seq}")
        rec.update(light_config2_sync_ms=t_seq, light_config2_hop_p50_ms=float(np.median(hop_ms)),
                   light_config2_lanes=sorted(set(lanes)))
    finally:
        T.ValidatorSet.hash = real_hash
    rec["light_phase_s"] = time.perf_counter() - t_phase
    log(f"[27] ({smi}) light-client phase {rec['light_phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------- node
# Phase 28: a full node's stores, the evidence pool over them and the light
# client's RPC front at 10,000 validators (tests/torch_rpc_node.py: the
# chain and the loopback JSON-RPC node, the port's own modules).
NODE_HEIGHTS = 8  # the chain's heights (the set moves after NODE_SHIFT_AFTER)
NODE_SHIFT = 1_000  # keys replaced ...
NODE_SHIFT_AFTER = 3  # ... by this height's FinalizeBlock (in effect at 5)
NODE_TXS = 4_096  # txs a block ...
NODE_TX_BYTES = 256  # ... of this many bytes: 1 MiB, under the default max_bytes of 4 MiB
NODE_RPC_TIMEOUT_S = 60  # every JSON-RPC request's


def node_phases(dev, log, require, zero_counts, read_counts, d):
    """Phase 28 of main(): (a) a node's stores over SQLiteDB: a chain of
    NODE_HEIGHTS blocks of NODE_TXS txs (data_hash on K7 + K8) signed by
    V_MAIN validators, the set moving by NODE_SHIFT keys, every block and
    part read back with the proofs checked; (b) a SKIPPING light.Client
    syncing 1 -> top through HTTPProvider over the node's JSON-RPC, every
    light block it fetched equal to the stores' own; (c) VerifyingClient's
    block, commit, validators, tx and data_proof (merkle_proof through the
    PROOF class: K7 -> K8 -> K9, COMETBFT_TPU_PROOF_DEVICE_MIN=1 for the
    lone query), a forged block refused, LightProxy
    answering; (d) EvidencePool over the same stores: a duplicate vote
    checked, added and committed in the next block, a tampered one refused,
    a lunatic LightClientAttackEvidence checked against the stored chain
    (K1 -> K2 -> K4 or K2 -> K5 under CONSENSUS).  Returns the record."""
    import copy
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_rpc_node as RN

    from cometbft_tpu_torch import light
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.evidence import ErrInvalidEvidence, EvidencePool
    from cometbft_tpu_torch.light import rpc as LR
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.rpc import HTTPClient
    from cometbft_tpu_torch.state import StateStore
    from cometbft_tpu_torch.store import BlockStore, SQLiteDB

    t_phase = time.perf_counter()
    smi = d["smi"]
    rec = {}
    chain_id = CHAIN_ID + "-node"
    with tempfile.TemporaryDirectory(prefix="node-") as tmp:
        # ------------------------------------------------ (a) the node's stores
        t0 = time.perf_counter()
        keys = RN.make_keys(SEED + 28, V_MAIN + NODE_SHIFT)
        t_keys = time.perf_counter() - t0
        bs, ss = BlockStore(SQLiteDB(os.path.join(tmp, "blockstore.db"))), StateStore(SQLiteDB(os.path.join(tmp, "state.db")))
        zero_counts()
        t0 = time.perf_counter()
        chain = RN.NodeChain(chain_id, keys, V_MAIN, bs, ss, txs_per_block=NODE_TXS, tx_bytes=NODE_TX_BYTES,
                             shift_after=NODE_SHIFT_AFTER, shift=NODE_SHIFT, seed=SEED + 28, device=dev)
        for _ in range(NODE_HEIGHTS):
            chain.advance()
        t_build = time.perf_counter() - t0
        c_build = read_counts("node_build")
        require(c_build["sha256_blocks"] >= NODE_HEIGHTS and c_build["merkle_tree"] >= NODE_HEIGHTS,
                f"(a) the blocks' data hashes did not run K7 + K8: {c_build}")
        t0 = time.perf_counter()
        n_parts = 0
        for h in range(1, NODE_HEIGHTS + 1):
            meta = bs.load_block_meta(h)
            psh = meta.block_id.part_set_header
            recv = T.PartSet(T.PartSetHeader(psh.total, psh.hash))
            for i in range(psh.total):
                require(recv.add_part(bs.load_block_part(h, i)), f"(a) part {i} of block {h} refused")
            n_parts += psh.total
            back = T.Block.decode(recv.assemble())
            require(back.hash() == chain.blocks[h].hash() == meta.block_id.hash
                    and bs.load_block(h).data.txs == chain.blocks[h].data.txs,
                    f"(a) block {h} did not read back")
        t_read = time.perf_counter() - t0
        vals_at = {h: chain.states[h - 1].validators for h in range(1, NODE_HEIGHTS + 1)}
        require(vals_at[NODE_SHIFT_AFTER + 2].hash(dev) != vals_at[NODE_SHIFT_AFTER + 1].hash(dev)
                and len(vals_at[NODE_HEIGHTS].validators) == V_MAIN, "(a) the set did not move")
        steps = {k: [round(x, 1) for x in v] for k, v in chain.ms.items()}
        log(f"[28a] ({smi}) node stores over SQLiteDB: {NODE_HEIGHTS} blocks of {NODE_TXS} txs of "
            f"{NODE_TX_BYTES} bytes, {V_MAIN} validators of power 10, {NODE_SHIFT} keys replaced after height "
            f"{NODE_SHIFT_AFTER}; keys {t_keys:.1f} s, chain {t_build:.1f} s; ms a height: "
            + "; ".join(f"{k} {v}" for k, v in steps.items())
            + f"; {n_parts} parts read back with their proofs in {t_read * 1e3:.1f} ms; launches {c_build}")
        rec.update(node_build_s=t_build, node_step_ms=chain.ms, node_read_back_ms=t_read * 1e3)

        node = RN.RPCNode(bs, ss, device=dev)
        node.start()
        cache = cv.ValsetCombCache(max_entries=4)
        try:
            # ------------------------------------------------ (b) sync over HTTP
            fetched = []

            class Logged(LR.HTTPProvider):
                def light_block(self, height):
                    t_lb = time.perf_counter()
                    lb = super().light_block(height)
                    fetched.append((height, lb, (time.perf_counter() - t_lb) * 1e3))
                    return lb

            def provider():
                return Logged(chain_id, HTTPClient(node.addr, timeout=NODE_RPC_TIMEOUT_S), device=dev)

            now = RN.GENESIS_NS + 3600 * NS
            zero_counts()
            t0 = time.perf_counter()
            client = light.Client(chain_id, light.TrustOptions(TRUSTING_PERIOD_NS, 1, chain.blocks[1].hash()),
                                  provider(), [provider()], light.LightStore(SQLiteDB(os.path.join(tmp, "light.db"))),
                                  now_fn=lambda: now, device=dev, comb_cache=cache)
            lb = client.verify_light_block_at_height(NODE_HEIGHTS)
            t_sync = (time.perf_counter() - t0) * 1e3
            c_sync = read_counts("node_http_sync")
            require(lb.hash == chain.blocks[NODE_HEIGHTS].hash(), "(b) the synced block is not the node's")
            require(c_sync["sha256_blocks"] >= 2 and c_sync["merkle_tree"] >= 2 and c_sync["sha512_blocks"] >= 2
                    and c_sync["verify_cached"] + c_sync["verify_batch"] >= 2,
                    f"(b) the sync's set hashes or commit checks missed the kernels: {c_sync}")
            store_view = light.BlockStoreProvider(chain_id, bs, ss, device=dev)
            t0 = time.perf_counter()
            for h, got, _ in fetched:
                h = h or bs.height
                if h < bs.height:
                    want = store_view.light_block(h)
                    want_sh, want_vals = want.signed_header, want.validator_set
                else:  # the top: its header and seen commit, as the commit route serves it
                    want_sh = T.SignedHeader(T.Header.from_proto(bs.load_block_meta(h).header), bs.load_seen_commit(h))
                    want_vals = ss.load_validators(h)
                require(got.signed_header.to_proto().encode() == want_sh.to_proto().encode()
                        and [v.to_proto().encode() for v in got.validator_set.validators]
                        == [v.to_proto().encode() for v in want_vals.validators],
                        f"(b) the light block at {h} is not the stores' own")
            t_cmp = (time.perf_counter() - t0) * 1e3
            log(f"[28b] ({smi}) SKIPPING sync 1 -> {NODE_HEIGHTS} through HTTPProvider over loopback JSON-RPC: "
                f"{t_sync:.1f} ms; light blocks fetched (height, ms) "
                f"{[(h, round(ms, 1)) for h, _, ms in fetched]} ({node.calls.get('validators', 0)} validators pages "
                f"of 100, {node.calls.get('commit', 0)} commits), each equal to the stores' own ({t_cmp:.1f} ms); "
                f"launches {c_sync}")
            rec.update(node_http_sync_ms=t_sync, node_light_block_ms=[ms for _, _, ms in fetched])

            # ------------------------------------------------ (c) verified reads
            vc = LR.VerifyingClient(HTTPClient(node.addr, timeout=NODE_RPC_TIMEOUT_S), client)
            mid = NODE_SHIFT_AFTER + 1
            tx_idx = NODE_TXS - 3
            tx = chain.blocks[mid].data.txs[tx_idx]
            reads = {}
            # one light client's lone query goes to the card: the JAX default (64 coalesced
            # queries a tree) would answer it on the host
            prev_min = os.environ.get("COMETBFT_TPU_PROOF_DEVICE_MIN")
            os.environ["COMETBFT_TPU_PROOF_DEVICE_MIN"] = "1"
            zero_counts()
            try:
                for what, call in (("block", lambda: vc.block(mid)), ("commit", lambda: vc.commit(NODE_HEIGHTS)),
                                   ("validators", lambda: vc.validators(NODE_HEIGHTS)),
                                   ("tx", lambda: vc.tx(T.tx_hash(tx).hex())),
                                   ("data_proof", lambda: vc.data_proof(mid, tx_idx))):
                    t0 = time.perf_counter()
                    out = call()
                    reads[what] = (time.perf_counter() - t0) * 1e3
                    if what == "data_proof":
                        proof = out
            finally:
                if prev_min is None:
                    os.environ.pop("COMETBFT_TPU_PROOF_DEVICE_MIN")
                else:
                    os.environ["COMETBFT_TPU_PROOF_DEVICE_MIN"] = prev_min
            c_reads = read_counts("node_verified_reads")
            require(c_reads["merkle_gather"] >= 1 and c_reads["merkle_tree"] >= 1,
                    f"(c) merkle_proof did not run K7 -> K8 -> K9: {c_reads}")
            require(proof["root_hash"] == chain.blocks[mid].header.data_hash.hex().upper(),
                    "(c) the data proof's root is not the block's data_hash")
            forged = T.Block.decode(chain.blocks[mid].encode())
            forged.data = T.Data(forged.data.txs[:-1] + [b"forged"])
            forged.header.data_hash = b""
            forged.fill_header(dev)
            node.forged[mid] = forged
            try:
                vc.block(mid)
                raise AssertionError("(c) the forged block verified")
            except LR.VerificationFailed as e:
                refused = str(e)
            node.forged.clear()
            proxy = LR.LightProxy(vc)
            proxy.start("127.0.0.1:0")
            try:
                via = HTTPClient(proxy.listen_addr, timeout=NODE_RPC_TIMEOUT_S).call("commit", height=mid)
            finally:
                proxy.stop()
            require(via == vc.commit(mid), "(c) the proxy's answer is not the verifying client's")
            log(f"[28c] ({smi}) VerifyingClient reads (ms) " + json.dumps({k: round(v, 1) for k, v in reads.items()})
                + f"; tx {tx_idx} of block {mid} proved into its data_hash; forged block refused ({refused[:60]}...); "
                f"LightProxy answered commit {mid}; launches {c_reads}")
            rec.update(node_verified_reads_ms=reads)

            # ------------------------------------------------ (d) the evidence pool
            pool = EvidencePool(SQLiteDB(os.path.join(tmp, "evidence.db")), ss, bs, device=dev, comb_cache=cache)
            t0 = time.perf_counter()
            dve = chain.duplicate_vote(mid, index=7)
            lca = chain.lunatic(2, mid)
            t_ev_inputs = time.perf_counter() - t0
            ev_ms = {}
            zero_counts()
            t0 = time.perf_counter()
            pool.add_evidence(dve)
            ev_ms["add_duplicate_vote"] = (time.perf_counter() - t0) * 1e3
            bad = copy.copy(dve)
            bad.vote_b = copy.copy(dve.vote_b)
            bad.vote_b.signature = bytes(64)
            try:
                pool.add_evidence(bad)
                raise AssertionError("(d) a tampered duplicate vote was admitted")
            except ErrInvalidEvidence as e:
                bad_reason = str(e.reason)
            t0 = time.perf_counter()
            pool.check_evidence([dve, lca])
            ev_ms["check_block_evidence"] = (time.perf_counter() - t0) * 1e3
            c_ev = read_counts("node_evidence")
            require(c_ev["sha512_blocks"] >= 2 and c_ev["verify_cached"] + c_ev["verify_batch"] >= 2,
                    f"(d) the lunatic evidence's commit checks missed the kernels: {c_ev}")
            require(pool.is_pending(dve) and pool.is_pending(lca) and pool.size() == 2,
                    "(d) the checked evidence is not pending")
            zero_counts()
            t0 = time.perf_counter()
            block = chain.advance(evidence=[dve, lca])
            pool.update(chain.state, block.evidence)
            ev_ms["commit_in_next_block"] = (time.perf_counter() - t0) * 1e3
            c_commit = read_counts("node_evidence_commit")
            require(pool.is_committed(dve) and pool.is_committed(lca) and pool.size() == 0
                    and bs.load_block(NODE_HEIGHTS + 1).evidence_hash() == block.header.evidence_hash,
                    "(d) the evidence was not committed")
            log(f"[28d] ({smi}) EvidencePool over the stores: a duplicate vote at {mid} added, a tampered one "
                f"refused ({bad_reason}), a lunatic attack from common height 2 on {mid} "
                f"({len(lca.byzantine_validators)} byzantine validators, power {lca.total_voting_power}) checked with "
                f"the vote under CONSENSUS, both committed in block {NODE_HEIGHTS + 1}; ms "
                + json.dumps({k: round(v, 1) for k, v in ev_ms.items()})
                + f" (inputs signed in {t_ev_inputs:.1f} s); launches {c_ev}, the next block's {c_commit}")
            rec.update(node_evidence_ms=ev_ms, node_evidence_launches=c_ev)
        finally:
            node.stop()
            cache.join_async()
    rec["node_phase_s"] = time.perf_counter() - t_phase
    log(f"[28] ({smi}) node phase {rec['node_phase_s']:.1f} s")
    return rec


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
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.models.verifier import CpuEd25519BatchVerifier, stage_batch
    from cometbft_tpu_torch.ops import comb, sha2
    from cometbft_tpu_torch.ops import merkle as Mk
    from cometbft_tpu_torch.ops import ed25519 as E
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.verifysvc import MODE_PLAIN
    from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE, Timestamp

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    t_start = time.perf_counter()
    from cometbft_tpu_torch.ops import keccak as Kc
    from cometbft_tpu_torch.ops import bls381 as Bl
    from cometbft_tpu_torch.ops import secp256k1 as Sp

    from cometbft_tpu_torch.parallel import verify as PV

    counters = (sha2.LAUNCHES, comb.LAUNCHES, E.LAUNCHES, cv.LAUNCHES, Mk.LAUNCHES, Kc.LAUNCHES, Sp.LAUNCHES,
                Bl.LAUNCHES, PV.LAUNCHES)
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

    def no_failover(phase):
        """Every phase but 26 runs with failover on (the default) and must
        leave it untouched: a kernel that failed on the card and was
        verified again on the host would otherwise pass unseen."""
        got = failover_counts()
        require(got == {"trips": 0, "service_trips": 0, "host_reverify": 0},
                f"phase {phase}: the verify service tripped or verified on the host: {got}")

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
    no_failover("2")
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
    mlen[:10] = [0, 31, 32, 47, 48, 110, 128, 64, MAXM + 1, (1 << 24) - 1]  # the last two past maxm
    mixed[:, 64], mixed[:, 65], mixed[:, 66] = mlen & 0xFF, (mlen >> 8) & 0xFF, mlen >> 16
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
    log(f"[3] K1, K2 == plain at V={V_MAIN}, maxm={MAXM}, two rows' mlen past maxm (active blocks "
        f"{int(act_k.sum())}, non-live {int((mixed[:, 67] == 0).sum())})")
    # K1 through parse_verify_payload at widths that are not a multiple of 4
    # (the wrapper pads them with zero columns): every mlen edge, rows whose
    # mlen exceeds maxm, rows that are not live; at the callers' width the
    # pad hands the payload itself to K1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_sha_corpus as SC

    require(sha2.pad_width4(payload) is payload, "the pad copied a payload whose width is a multiple of 4")
    for w in K1_ODD_WIDTHS:
        odd_p, odd_k = (torch.from_numpy(x).to(dev) for x in SC.payload_rows(np.random.default_rng(SEED + w),
                                                                             V_K1_ODD, w))
        _, _, ob_k, oa_k, _ = sha2.parse_verify_payload(odd_p, odd_k)
        ob_p, oa_p = sha2.parse_verify_payload_plain(odd_p, odd_k)
        torch.cuda.synchronize()
        require(torch.equal(ob_k, ob_p) and torch.equal(oa_k, oa_p), f"K1 != plain at width {w}")
        results["parse_verify_payload"] = max(results["parse_verify_payload"], max_abs_err(ob_k, ob_p),
                                              max_abs_err(oa_k, oa_p))
    log(f"[3] K1 through parse_verify_payload == plain at the widths {K1_ODD_WIDTHS} (padded to a multiple "
        f"of 4), {V_K1_ODD} rows each with mlen past maxm on some")

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

    # K3 at the edges of its groups, warps and blocks (tests/torch_group_corpus.py):
    # off-curve keys at each warp's first and last key and each block's last,
    # non-canonical y, identity and small-order keys; every size against the
    # plain version, the host bigint build and the corpus's validity, over
    # poisoned buffers
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_group_corpus as GC

    gpool = GC.Pool(SEED + 10)
    for V_e in K3_EDGE_SIZES:
        kb_ = GC.keys(gpool, V_e, SEED + V_e, 32 // comb.BUILD_THREADS_PER_KEY, comb.BUILD_KEYS_PER_BLOCK)
        e_pubs = torch.from_numpy(kb_["pubs"]).to(dev)
        e_tab = torch.full((V_e, 64, 8, 3, 8), -0x55555556, dtype=torch.int32, device=dev)
        e_val = torch.full((V_e,), 0xAA, dtype=torch.uint8, device=dev)
        comb.launch_k3(e_pubs, e_tab, e_val)
        p_tab, p_val = comb.build_a_tables_plain(e_pubs)
        torch.cuda.synchronize()
        require(torch.equal(e_tab, p_tab) and torch.equal(e_val, p_val.to(torch.uint8)),
                f"K3 != plain on the {V_e}-key edge batch")
        h_tab, h_val = comb.build_a_tables_host(kb_["pubs"])
        require(np.array_equal(e_tab.cpu().numpy().view(np.uint32), h_tab)
                and e_val.cpu().numpy().astype(bool).tolist() == h_val.tolist() == kb_["expect"].tolist(),
                f"K3 != the host bigint build or the corpus on the {V_e}-key edge batch")
        results["build_a_tables"] = max(results["build_a_tables"], max_abs_err(e_tab, p_tab))
    del e_tab, p_tab
    log(f"[3] K3 == plain, the host bigint build and the corpus's validity on edge batches of "
        f"{K3_EDGE_SIZES} keys (off-curve keys at warp and block edges, non-canonical y, identity and "
        f"small-order keys), buffers poisoned with 0xAA")

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

    # K4 at the edges of its groups, warps and blocks (tests/torch_comb_corpus.py):
    # failing lanes of every class at each warp's first and last lane and each
    # block's last, non-live lanes beside valid ones, lanes whose k leaves one
    # thread's whole share at the identity, s = 0; every size against the plain
    # version and the corpus's verdicts, all-ok byte included, over a poisoned
    # output buffer
    import torch_comb_corpus as CC

    pool = CC.Pool(SEED + 9)
    pool_tab, pool_val = comb.build_a_tables(torch.from_numpy(pool.pubs).to(dev))
    b_tab = entry.b_tables
    edge_cnt = torch.empty((2,), dtype=torch.int32, device=dev)
    for V_e in K4_EDGE_SIZES:
        for mode in ("mixed", "valid", "valid_dead") if V_e == 257 else ("mixed",):
            eb = CC.batch(pool, V_e, SEED + V_e, mode)
            key = torch.from_numpy(eb["key"]).to(dev)
            e_tab, e_val = pool_tab[key], pool_val[key]
            e_pay, e_dig = torch.from_numpy(eb["payload"]).to(dev), torch.from_numpy(eb["digest"]).to(dev)
            e_out = torch.full(((V_e + 7) // 8 + 1,), 0xAA, dtype=torch.uint8, device=dev)
            comb.launch_k4(e_tab, e_val.to(torch.uint8), e_pay, e_dig, b_tab, edge_cnt, e_out)
            e_ok = comb.verify_cached_plain(e_tab, e_val, e_pay, e_dig, b_tab)
            e_want = comb.pack_verdicts(e_ok, e_pay[:, 67] == 1)
            torch.cuda.synchronize()
            require(torch.equal(e_out, e_want), f"K4 != plain on the {V_e}-lane {mode} edge batch")
            require(np.array_equal(e_out.cpu().numpy(), CC.packed_expect(eb)),
                    f"K4 != the corpus's verdicts on the {V_e}-lane {mode} edge batch")
            results["verify_cached"] = max(results["verify_cached"], max_abs_err(e_out, e_want))
    del e_tab, e_val
    log(f"[3] K4 == plain and the corpus's verdicts on edge batches of {K4_EDGE_SIZES} lanes (failing "
        f"lanes at warp and block edges, non-live lanes, identity shares, s = 0; all-valid and "
        f"valid + failing non-live batches at 257), output buffers poisoned with 0xAA")

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
    pubkeys = vals.pub_keys_bytes()
    for _ in range(12):
        bv = cbatch.create_batch_verifier("ed25519", pubkeys, device=dev, comb_cache=cache)
        require(bv.mode == ("comb", entry), f"the factory gave mode {bv.mode}")
        for it in good_items:
            bv.add(*it)
        ok, _ = bv.verify()
        require(ok, "good batch failed")
        phases.append(dict(bv.last_timings))
    phases = phases[2:]
    p50 = float(np.median(walls))
    phase_p50 = {k: float(np.median([p[k] for p in phases])) for k in phases[0]}
    log(f"[4] verify_commit p50 {p50:.2f} ms over {len(walls)} calls "
        f"(min {min(walls):.2f}, max {max(walls):.2f}); CombBatchVerifier phases p50 through the service "
        f"(ms; queue_ms in its class queue, submit_ms on its host worker, kernel_ms the collector's wait): "
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
    k3_out = (torch.empty((V_MAIN, 64, 8, 3, 8), dtype=torch.int32, device=dev),
              torch.empty((V_MAIN,), dtype=torch.uint8, device=dev))

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
        "build_a_tables": (lambda: comb.launch_k3(entry.pubs, *k3_out), None),
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
    require(torch.equal(k3_out[0], entry.tables), "the timed K3 launches' tables != the main path's")
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
    no_failover("4")
    log(f"[4] peak device memory on the main path: {peak / 2**20:.1f} MiB (run 9m: {RUN_9M['peak MiB']} MiB, "
        f"with K3's V x 16 KB scratch)")

    # K4's launch shape and ptxas figures (a spill fails the run), and its
    # time at a world-4 rank's 2,504 lanes beside the 10,000 above
    out_rank = torch.empty((V_RANK // 8 + 1,), dtype=torch.uint8, device=dev)
    it, wu, _, _ = TIMING["verify_cached"]
    k4_rank_ms = cuda_ms(lambda: comb.launch_k4(entry.tables[:V_RANK], valid_u8[:V_RANK], good_payload[:V_RANK],
                                                dig[:V_RANK], entry.b_tables, cnt, out_rank), it, wu)
    comb_log = _build.BUILD_LOG["comb"]
    comb_ptx = ptxas_kernels(comb_log["ptxas"], lambda line: "verify_cached" if "k4_kernel" in line else
                             "build_a_tables" if "k3_kernel" in line else None)["kernels"]
    k4p, k3p = comb_ptx["verify_cached"], comb_ptx["build_a_tables"]
    require(k4p.get("spill_bytes", 1) == 0, f"K4 spills: {k4p}")
    require(k3p.get("spill_bytes", 1) == 0, f"K3 spills: {k3p}")
    k3_threads = comb.BUILD_THREADS_PER_KEY * comb.BUILD_KEYS_PER_BLOCK
    k3_shape = {"threads_per_key": comb.BUILD_THREADS_PER_KEY, "keys_per_block": comb.BUILD_KEYS_PER_BLOCK,
                "threads_per_block": k3_threads,
                "blocks_per_sm": blocks_per_sm(k3p["registers"], k3p["smem_bytes"], k3_threads), **k3p}
    k4_threads = comb.THREADS_PER_LANE * comb.LANES_PER_BLOCK
    k4_shape = {"threads_per_lane": comb.THREADS_PER_LANE, "lanes_per_block": comb.LANES_PER_BLOCK,
                "threads_per_block": k4_threads,
                "blocks_per_sm": blocks_per_sm(k4p["registers"], k4p["smem_bytes"], k4_threads), **k4p,
                "comb_build_s": comb_log["seconds"], "comb_build_cached": comb_log["cached"]}
    log(f"[4] K4 {t['verify_cached'][0]:.4f} ms at {V_MAIN} lanes (the one-thread design, run J: "
        f"{K4_MS_ONE_THREAD} ms), {k4_rank_ms:.4f} ms at {V_RANK} lanes; {comb.THREADS_PER_LANE} threads a "
        f"lane, {k4_threads} a block, {k4_shape['blocks_per_sm']} blocks an SM; {k4p['registers']} registers, "
        f"{k4p.get('stack_bytes', 0)} bytes of stack, {k4p['spill_bytes']} spilled; comb.cu "
        + ("cached" if comb_log["cached"] else f"built in {comb_log['seconds']:.1f} s")
        + f"; K3 {t['build_a_tables'][0]:.4f} ms at {V_MAIN} keys (run 9m: {RUN_9M['K3 10,000 keys']} ms), "
        f"{comb.BUILD_THREADS_PER_KEY} threads a key, {k3_threads} a block, {k3_shape['blocks_per_sm']} blocks an "
        f"SM; {k3p['registers']} registers, {k3p.get('stack_bytes', 0)} bytes of stack, {k3p['spill_bytes']} spilled")

    # K1's and K2's ptxas figures (a spill fails the run) and their times
    # through a CUDA graph beside runs 15a's and 13q's
    sha_log = _build.BUILD_LOG["sha2"]
    sha_ptx = ptxas_kernels(sha_log["ptxas"], lambda line: "k2" if "k2_kernel" in line else
                            "k1" if "k1_kernel" in line else None)
    k1p, k2p = sha_ptx["kernels"]["k1"], sha_ptx["kernels"]["k2"]
    require(sha_ptx["any_spill"] == 0 and k1p.get("spill_bytes", 1) == 0 and k2p.get("spill_bytes", 1) == 0,
            f"sha2.cu spills: K1 {k1p}, K2 {k2p}")
    graphed = {"parse_verify_payload": graph_ms(lambda: sha2.launch_k1(good_payload, entry.pubs, blocks, active),
                                                TIMING["parse_verify_payload"][0])}
    k2_graph_ms = graph_ms(lambda: sha2.launch_k2(blocks, active, dig), TIMING["sha512_blocks"][0])
    graphed["sha512_blocks"] = k2_graph_ms
    log(f"[4] K1 {t['parse_verify_payload'][0]:.4f} ms by events at {V_MAIN} rows x {nb} blocks, "
        f"{graphed['parse_verify_payload']:.4f} ms with its launches in a CUDA graph (run 15a, a thread a byte: "
        f"{RUN_15A['K1 10,000 rows']} ms); a thread a 16-byte chunk; {k1p['registers']} registers, "
        f"{k1p.get('stack_bytes', 0)} bytes of stack, {k1p['spill_bytes']} spilled")
    log(f"[4] K2 {t['sha512_blocks'][0]:.4f} ms at {V_MAIN} rows x {nb} blocks ({sum_active} active; run 13q: "
        f"{RUN_13Q['K2 10,000 rows']} ms), {k2_graph_ms:.4f} ms with its launches in a CUDA graph (no host time "
        f"between them); {k2p['registers']} registers, {k2p.get('stack_bytes', 0)} bytes of stack, "
        f"{k2p['spill_bytes']} spilled")

    # ---------------------------------------------------- 5. uncached path
    # the commit's 10,000 items with phase 2's planted faults, through the
    # Straus verifier: 16,384 lanes, padding lanes repeating row 0
    u_items = list(good_items)
    for i in planted:
        u_items[i] = items[rows.index(i)]
    zero_counts()
    ubv = cbatch.create_batch_verifier("ed25519", device=dev)  # no pubkeys: MODE_PLAIN
    require(ubv.mode == MODE_PLAIN, f"the factory gave mode {ubv.mode}")
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
        bv = cbatch.create_batch_verifier("ed25519", device=dev)
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

    # K5 at the edges of its groups, warps and blocks (tests/torch_group_corpus.py):
    # failing lanes of every class at each warp's first and last lane and each
    # block's last (s = 0 and s >= L, undecodable R and A, non-canonical y,
    # small-order A and R, k with zero windows); every size against the plain
    # version, the host oracle (once a distinct lane) and the corpus's verdicts,
    # over a poisoned output buffer
    host_ok = {}
    for n_e in K5_EDGE_SIZES:
        lb = GC.lanes(gpool, n_e, SEED + n_e, 32 // E.threads_per_lane(n_e), E.LANES_PER_BLOCK)
        e_in = [torch.from_numpy(lb[k]).to(dev) for k in ("a", "r", "s", "digest")]
        e_out = torch.full((n_e,), 0xAA, dtype=torch.uint8, device=dev)
        E.launch_k5(*e_in, bwin, e_out)
        e_want = E.verify_digest_plain(*e_in).to(torch.uint8)
        torch.cuda.synchronize()
        require(torch.equal(e_out, e_want), f"K5 != plain on the {n_e}-lane edge batch")
        got = e_out.cpu().numpy().astype(bool).tolist()
        for v in range(n_e):
            row = tuple(bytes(lb[k][v]) for k in ("a", "r", "s", "digest"))
            if row not in host_ok:
                host_ok[row] = GC.host_verdict(*row)
            require(got[v] == host_ok[row] == bool(lb["expect"][v]),
                    f"K5 != the host oracle or the corpus at lane {v} ({lb['kinds'][v]}) of the {n_e}-lane batch")
        results["verify_batch"] = max(results["verify_batch"], max_abs_err(e_out, e_want))
    # K5's two instantiations (4 and 2 threads a lane): ptxas figures (a
    # spill fails) and launch shape
    ed_log = _build.BUILD_LOG["ed25519"]
    k5_ptx = ptxas_kernels(ed_log["ptxas"], lambda line: 4 if "k5_kernelILi4E" in line else
                           2 if "k5_kernelILi2E" in line else None)["kernels"]
    k5_shapes = {}
    for g_, k5p in sorted(k5_ptx.items()):
        require(k5p.get("spill_bytes", 1) == 0, f"K5 at {g_} threads a lane spills: {k5p}")
        k5_threads = g_ * E.LANES_PER_BLOCK
        k5_shapes[g_] = {"threads_per_lane": g_, "lanes_per_block": E.LANES_PER_BLOCK,
                         "threads_per_block": k5_threads,
                         "blocks_per_sm": blocks_per_sm(k5p["registers"], k5p["smem_bytes"], k5_threads), **k5p}
    require(sorted(k5_shapes) == [2, 4], f"K5's instantiations in the ptxas report: {sorted(k5_shapes)}")
    log(f"[5] K5 == plain, the host oracle ({len(host_ok)} distinct lanes) and the corpus's verdicts on edge "
        f"batches of {K5_EDGE_SIZES} lanes, output buffers poisoned with 0xAA; K5 {t['verify_batch'][0]:.4f} ms "
        f"at {lanes} lanes (run 9m: {RUN_9M['K5 16,384 lanes']} ms), {E.threads_per_lane(lanes)} threads a lane; "
        f"launch shapes and ptxas figures {json.dumps(k5_shapes)}; ed25519.cu "
        + ("cached" if ed_log["cached"] else f"built in {ed_log['seconds']:.1f} s"))

    no_failover("5")

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
    k3b_out = (torch.empty_like(t_new), torch.empty((bucket,), dtype=torch.uint8, device=dev))
    it, wu, pit, pwu = TIMING["build_a_tables_128"]
    t["build_a_tables_128"] = (cuda_ms(lambda: comb.launch_k3(bucket_pubs, *k3b_out), it, wu),
                               cuda_ms(lambda: comb.build_a_tables_plain(bucket_pubs), pit, pwu))
    require(torch.equal(k3b_out[0], t_new), "K3 into preallocated tables != the bucket's build")
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
        f"allocations included; run 9m: {RUN_9M['K3 128 keys (wrapper)']} ms), the kernel alone "
        f"{t['build_a_tables_128'][0]:.4f} ms")

    no_failover("6")

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
        f"launches {c_light}; K5 == plain at 256 lanes, {t['verify_batch_256'][0]:.4f} ms (run 9m: "
        f"{RUN_9M['K5 256 lanes']} ms)")

    no_failover("7")

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
        bv = cbatch.create_batch_verifier("ed25519", pubkeys, device=dev, comb_cache=cache)
        require(bv.mode == ("comb", entry), f"the factory gave mode {bv.mode}")
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
    log(f"[8] demotion: a foreign key and a duplicate key each demote a comb batch (the service's "
        f"CombBatchVerifier) to the uncached verifier; verdicts == host oracle; launches {c_dem}")

    no_failover("8")

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
        require(c_["sha256_blocks"] == 12 and c_["merkle_tree"] == 12
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

    no_failover("9")

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
    require(c_proofs["sha256_blocks"] == 12 and c_proofs["merkle_tree"] == 12
            and c_proofs["merkle_gather"] == 12, f"proof launches {c_proofs}")
    zero_counts()
    for _ in range(12):
        t0 = time.perf_counter()
        root_m, proofs_m, dedup = cmerkle.device_multiproof(leaves, range(N_LEAVES), device=dev)
        multi_walls.append((time.perf_counter() - t0) * 1e3)
    c_multi = read_counts("multiproof")
    require(root_m == host_root and proofs_m == host_proofs, "multiproof != proofs_from_byte_slices")
    require(c_multi["sha256_blocks"] == 12 and c_multi["merkle_tree"] == 12
            and c_multi["merkle_gather"] == 12, f"multiproof launches {c_multi}")
    p50_proofs = float(np.median(proof_walls[2:]))
    p50_multi = float(np.median(multi_walls[2:]))
    log(f"[10] proof serving, {N_LEAVES} leaves of {LEAF_BYTES} B, every leaf queried: all proofs "
        f"== proofs_from_byte_slices (host {host_proofs_ms:.1f} ms); ProofProver.verify p50 "
        f"{p50_proofs:.2f} ms, device_multiproof p50 {p50_multi:.2f} ms (dedup {dedup:.4f}); "
        f"launches {json.dumps(c_proofs)} / {json.dumps(c_multi)}")

    no_failover("10")

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
    # K8 (one launch a tree) on every level of both trees, each level over
    # rows the plain version never wrote; then on trees of one block, of a
    # partial last block and of stage 2 over more than one chunk of
    # subtree roots, over poisoned rows, launched twice back to back on
    # one stream (the second after the first's ticket counter reset)
    stage_v = Mk.stage_leaves([v.bytes() for v in vals.validators], dev)
    stage_p = Mk.stage_leaves(leaves, dev)
    k8_err = 0
    for blocks_, active_ in (stage_v[:2], stage_p[:2]):
        n_ = blocks_.shape[0]
        flat_ = Mk.all_levels(blocks_, active_)
        require(torch.equal(flat_[:n_], sha2.sha256_blocks_plain(blocks_, active_)),
                f"K7 != plain on the {n_}-leaf tree's leaves")
        want_ = flat_.clone()
        want_[n_:] = 0
        Mk.merkle_tree_plain(want_, n_)
        k8_err = max(k8_err, max_abs_err(flat_, want_))
        require(torch.equal(flat_, want_), f"K8 != plain on the {n_}-leaf tree")
    T8 = Mk.TREE_THREADS
    k8_sizes = (2, 3, 2 * T8 - 1, 2 * T8, 2 * T8 + 1, 4 * T8 * T8 + 1)
    for n_ in k8_sizes:
        rows_ = Mk.level_offsets(n_)[-1] + 1
        want_ = torch.zeros((rows_, 32), dtype=torch.uint8, device=dev)
        want_[:n_] = torch.from_numpy(rng_p.integers(0, 256, size=(n_, 32), dtype=np.uint8)).to(dev)
        twice = [torch.full_like(want_, 0xAA) for _ in range(2)]
        for f_ in twice:
            f_[:n_] = want_[:n_]
        Mk.merkle_tree_plain(want_, n_)
        for f_ in twice:
            Mk.merkle_tree(f_, n_)
        torch.cuda.synchronize()
        for k, f_ in enumerate(twice):
            k8_err = max(k8_err, max_abs_err(f_, want_))
            require(torch.equal(f_, want_), f"K8 launch {k + 1} of 2 != plain on {n_} leaves")
    results["merkle_tree"] = k8_err
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
    log(f"[11] K7 == plain on {N_LEAVES} rows of 1-3 active blocks (stale bytes past each row) and on both "
        f"trees' leaves; "
        f"K8 (one launch a tree) == plain on every level of the {V_MAIN}- and {N_LEAVES}-leaf trees "
        f"(odd levels of the first: {odd}) and of {k8_sizes} leaves over rows poisoned with 0xAA, "
        f"each launched twice back to back; K9 == plain with {n_missing} coordinates of -1, and "
        f"== plain and index_select on the proofs' {pc_flat.shape[0]} coordinates")
    # times at the proof path's shapes
    blocks_p, active_p = stage_p[:2]
    sizes_p = Mk.level_sizes(N_LEAVES)
    flat_t = torch.empty_like(flat_p)
    sha2.launch_k7(blocks_p, active_p, flat_t)
    sum_active7 = int(active_p.sum())

    def k8_tree():
        Mk.merkle_tree(flat_t, N_LEAVES)

    def k8_tree_plain():
        Mk.merkle_tree_plain(flat_t, N_LEAVES)

    out9 = torch.empty((pc_flat.shape[0], 32), dtype=torch.uint8, device=dev)
    timed7 = torch.empty((N_LEAVES, 32), dtype=torch.uint8, device=dev)
    for name, kern, plain in (
        ("sha256_blocks", lambda: sha2.launch_k7(blocks_p, active_p, timed7),
         lambda: sha2.sha256_blocks_plain(blocks_p, active_p)),
        ("merkle_tree", k8_tree, k8_tree_plain),
        ("merkle_gather", lambda: Mk.launch_k9(flat_p, pc_flat, out9),
         lambda: Mk.merkle_gather_plain(flat_p, pc_flat)),
    ):
        it, wu, pit, pwu = TIMING[name]
        t[name] = (cuda_ms(kern, it, wu), cuda_ms(plain, pit, pwu))
    require(torch.equal(flat_t, flat_p), "the timed tree != the proof tree")
    it, wu, _, _ = TIMING["merkle_gather"]
    lib9_ms = cuda_ms(lambda: torch.index_select(flat_p, 0, pc_flat, out=out9), it, wu)
    # the 10,000-leaf tree of ValidatorSet.hash
    flat_v = Mk.all_levels(*stage_v[:2])
    k8_valset_ms = cuda_ms(lambda: Mk.merkle_tree(flat_v, V_MAIN), *TIMING["merkle_tree"][:2])
    # K7 and K9 through a CUDA graph (each takes less on the card than its
    # launch on the host), K7 also at the set tree's 10,000 one-block
    # leaves; K7-K9's ptxas figures (a spill fails the run)
    timed7v = torch.empty((V_MAIN, 32), dtype=torch.uint8, device=dev)
    graphed["sha256_blocks"] = graph_ms(lambda: sha2.launch_k7(blocks_p, active_p, timed7),
                                        TIMING["sha256_blocks"][0])
    k7_valset_graph_ms = graph_ms(lambda: sha2.launch_k7(stage_v[0], stage_v[1], timed7v), TIMING["sha256_blocks"][0])
    require(torch.equal(timed7v, flat_v[:V_MAIN]), "the timed set-tree leaves != the set tree's")
    graphed["merkle_gather"] = graph_ms(lambda: Mk.launch_k9(flat_p, pc_flat, out9), TIMING["merkle_gather"][0])
    mk_log = _build.BUILD_LOG["merkle"]
    mk_ptx = ptxas_kernels(mk_log["ptxas"], lambda line: next(
        (k for k in ("k7_kernel", "k8_kernel", "k9_kernel") if k in line), None))
    require(mk_ptx["any_spill"] == 0 and all(v.get("spill_bytes", 1) == 0 for v in mk_ptx["kernels"].values()),
            f"merkle.cu spills: {mk_ptx}")
    k7p = mk_ptx["kernels"]["k7_kernel"]
    log(f"[11] K7 {t['sha256_blocks'][0]:.4f} ms by events at {N_LEAVES} x {blocks_p.shape[1]} blocks "
        f"({sum_active7} active), {graphed['sha256_blocks']:.4f} ms through a CUDA graph (run 15a: "
        f"{RUN_15A['K7 16,384 x 2']}); {k7_valset_graph_ms:.4f} ms at the set tree's {V_MAIN} x "
        f"{stage_v[0].shape[1]} (run 15a: {RUN_15A['K7 10,000 x 1']}); {k7p['registers']} registers, "
        f"{k7p.get('stack_bytes', 0)} bytes of stack, {k7p['spill_bytes']} spilled; K8 {mk_ptx['kernels']['k8_kernel']}, "
        f"K9 {mk_ptx['kernels']['k9_kernel']}; K9 {t['merkle_gather'][0]:.4f} ms by events, "
        f"{graphed['merkle_gather']:.4f} through a graph")

    # ---------------------------------------------------- 12-15. the secp lane
    secp_results, secp_t, secp_bound, secp_meta, secp_record, secp_inputs = secp_phases(
        dev, np.random.default_rng(SEED + 4), log, require, zero_counts, read_counts, cuda_ms, max_abs_err)
    results.update(secp_results)
    t.update(secp_t)

    no_failover("12-15")

    # ---------------------------------------------------- 16-20. the BLS lane
    bls_results, bls_t, bls_bound, bls_meta, bls_record, bls_inputs = bls_phases(
        dev, np.random.default_rng(SEED + 5), log, require, zero_counts, read_counts, cuda_ms, max_abs_err)
    results.update(bls_results)
    t.update(bls_t)

    no_failover("16-20")

    # ---------------------------------------------------- 22-23. the sharded plane
    shard_t, shard_plain, shard_err, shard_record = sharded_phases(
        dev, log, require, zero_counts, read_counts, cuda_ms, {
            "chain_id": CHAIN_ID, "vals": vals, "bid": bid, "height": height, "good": good,
            "faulted": faulted, "blame": blame, "items": items, "rows": rows, "entry": entry,
            "cache": cache, "good_items": good_items,
            "payload": payload, "bitmap": out_k, "good_payload": good_payload, "p50": p50,
            "ubatch": (ua, ur, us, ublk, uact), "k5": k5_out, "leaf_blocks": stage_p[0],
            "leaf_active": stage_p[1], "root": host_root, "host_proofs": host_proofs,
            "flat": flat_p, "coords": pc,
        })

    no_failover("22-23")

    # ---------------------------------------------------- 24. the verify service
    svc_record = service_phases(dev, log, require, zero_counts, read_counts, {
        "smi": smi, "chain_id": CHAIN_ID, "vals": vals, "bid": bid, "height": height, "good": good,
        "faulted": faulted, "blame": blame, "cache": cache, "entry": entry, "good_items": good_items,
        "secp": secp_inputs, "bls": bls_inputs, "leaves": leaves, "host_proofs": host_proofs,
        "root": host_root, "trusted_sh": trusted_sh, "new_sh": new_sh, "now_ns": now_ns,
    })

    no_failover("24")

    # ---------------------------------------------------- 25. the blocksync replay
    replay_record = replay_phases(dev, log, require, zero_counts, read_counts, {
        "smi": smi, "chain_id": CHAIN_ID, "vals": vals, "bid": bid, "height": height, "good": good,
        "cache": cache,
    })
    no_failover("25")

    # ---------------------------------------------------- 27. the light client
    light_record = light_phases(dev, log, require, zero_counts, read_counts, {"smi": smi})
    no_failover("27")

    # ---------------------------------------------------- 28. the node's stores, pool and RPC front
    node_record = node_phases(dev, log, require, zero_counts, read_counts, {"smi": smi})
    no_failover("28")

    # ---------------------------------------------------- 26. the failover
    failover_record = failover_phases(dev, log, require, zero_counts, read_counts, {
        "smi": smi, "chain_id": CHAIN_ID, "vals": vals, "bid": bid, "height": height, "good": good,
        "faulted": faulted, "blame": blame, "cache": cache, "lvals": lvals, "lcommit": lcommit,
        "secp": secp_inputs,
    })

    # ---------------------------------------------------- 21. the record
    # bounds from this run's shapes and data
    width = good_payload.shape[1]
    k5_ops = FIELD_MULS_PER_STRAUS * OPS_PER_FIELD_MUL + OPS_PER_SCALAR_REDUCE
    k4_lane_ops = FIELD_MULS_PER_VERIFY * OPS_PER_FIELD_MUL + OPS_PER_SCALAR_REDUCE
    bound = {
        "parse_verify_payload": (
            "bytes", (V_MAIN * width + V_MAIN * 32 + V_MAIN * nb * 128 + V_MAIN * 4) / HBM_BYTES_PER_S),
        "sha512_blocks": (
            "operations", sum_active * OPS_PER_SHA512_BLOCK / INT32_OPS_PER_S),
        "verify_cached": (
            "operations",
            V_MAIN * k4_lane_ops / INT32_OPS_PER_S),
        "build_a_tables": (
            "operations", V_MAIN * FIELD_MULS_PER_TABLE * OPS_PER_FIELD_MUL / INT32_OPS_PER_S),
        "build_a_tables_128": (
            "operations", bucket * FIELD_MULS_PER_TABLE * OPS_PER_FIELD_MUL / INT32_OPS_PER_S),
        "verify_batch": ("operations", lanes * k5_ops / INT32_OPS_PER_S),
        "verify_batch_256": ("operations", 256 * k5_ops / INT32_OPS_PER_S),
        "assemble_churn": ("bytes", (2 * V_MAIN * A_ROW_BYTES + V_MAIN * 6) / HBM_BYTES_PER_S),
        "sha256_blocks": ("operations", sum_active7 * OPS_PER_SHA256_BLOCK / INT32_OPS_PER_S),
        "merkle_tree": (
            "operations", sum(sz // 2 for sz in sizes_p) * 2 * OPS_PER_SHA256_BLOCK / INT32_OPS_PER_S),
        "merkle_gather": ("bytes", pc_flat.shape[0] * (4 + 32 + 32) / HBM_BYTES_PER_S),
    }
    # the other side of each bound, logged for the record
    other = {
        "parse_verify_payload": V_MAIN * nb * 128 * 8 / INT32_OPS_PER_S,
        "sha512_blocks": (V_MAIN * nb * 128 + V_MAIN * 4 + V_MAIN * 64) / HBM_BYTES_PER_S,
        "verify_cached": (V_MAIN * 86 * 96 + V_MAIN * (width + 64)) / HBM_BYTES_PER_S,
        "build_a_tables": (V_MAIN * 32 + V_MAIN * 64 * 8 * 96) / HBM_BYTES_PER_S,
        "build_a_tables_128": (bucket * 32 + bucket * 64 * 8 * 96) / HBM_BYTES_PER_S,
        "verify_batch": lanes * (3 * 32 + 64 + 1) / HBM_BYTES_PER_S,
        "verify_batch_256": 256 * (3 * 32 + 64 + 1) / HBM_BYTES_PER_S,
        "assemble_churn": 0.0,
        "sha256_blocks": (blocks_p.numel() + N_LEAVES * 4 + N_LEAVES * 32) / HBM_BYTES_PER_S,
        "merkle_tree": sum(sz * 32 + (sz + 1) // 2 * 32 for sz in sizes_p) / HBM_BYTES_PER_S,
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
        "merkle_tree": ("K8", "cometbft_tpu_torch/csrc/merkle.cu",
                         "cometbft_tpu/ops/merkle.py:47",
                         ["merkle_root_from_leaves", "merkle_proofs_from_leaves",
                          "merkle_multiproof_from_leaves"]),
        "merkle_gather": ("K9", "cometbft_tpu_torch/csrc/merkle.cu",
                          "cometbft_tpu/ops/merkle.py:117",
                          ["merkle_proofs_from_leaves", "merkle_multiproof_from_leaves"]),
    }
    meta.update(secp_meta)
    meta.update(bls_meta)
    for name, (by, secs, other_secs) in {**secp_bound, **bls_bound}.items():
        bound[name] = (by, secs)
        other[name] = other_secs
    library = {"assemble_churn": lib6_ms, "merkle_gather": lib9_ms}
    graphed["keccak256_blocks"] = secp_record["k10_graph_ms"]
    total_launches = {k: sum(p[k] for p in path_launches.values()) for k in read_counts()}
    log(f"[21] launches per path (each read just after the path): {json.dumps(path_launches)}")
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
        if name in graphed:  # a kernel shorter than its launch's host cost: also its time through a CUDA graph
            rec["graph_ms"] = graphed[name]
        if name == "verify_batch":  # launch shapes, ptxas figures, the light client's 256 lanes
            g_big, g_256 = E.threads_per_lane(lanes), E.threads_per_lane(256)
            rec.update(k5_shapes[g_big], lanes=lanes, shape_256=k5_shapes[g_256], ms_256=t["verify_batch_256"][0],
                       plain_ms_256=t["verify_batch_256"][1],
                       bound_ms_256=bound["verify_batch_256"][1] * 1e3,
                       field_muls=FIELD_MULS_PER_STRAUS,
                       field_muls_design=straus_muls_design(g_big),
                       field_muls_design_256=straus_muls_design(g_256),
                       ed25519_build_s=ed_log["seconds"], ed25519_build_cached=ed_log["cached"])
        if name == "build_a_tables":  # launch shape, ptxas figures, the churn bucket's 128 keys
            rec.update(k3_shape, keys=V_MAIN, keys_bucket=bucket, ms_bucket=t["build_a_tables_128"][0],
                       plain_ms_bucket=t["build_a_tables_128"][1],
                       bound_ms_bucket=bound["build_a_tables_128"][1] * 1e3,
                       field_muls=FIELD_MULS_PER_TABLE,
                       field_muls_design=table_muls_design(comb.BUILD_THREADS_PER_KEY))
        if name == "sha256_blocks":  # the set tree's one-block leaves beside the proof tree's
            rec.update(k7p, graph_ms_valset=k7_valset_graph_ms, rows_valset=V_MAIN)
        if name == "parse_verify_payload":
            rec.update(k1p)
        if name == "merkle_tree":  # ms, plain_ms and bound_ms are for one whole tree, one launch
            rec.update(launches_per_tree=1, levels=len(sizes_p), leaves=N_LEAVES, threads_per_block=T8,
                       ms_valset=k8_valset_ms, leaves_valset=V_MAIN,
                       bound_ms_valset=sum(sz // 2 for sz in Mk.level_sizes(V_MAIN)) * 2
                       * OPS_PER_SHA256_BLOCK / INT32_OPS_PER_S * 1e3)
        if name == "verify_cached":  # launch shape, ptxas figures, a world-4 rank's shape
            rec.update(k4_shape, lanes=V_MAIN, lanes_rank=V_RANK, ms_rank=k4_rank_ms,
                       bound_ms_rank=V_RANK * k4_lane_ops / INT32_OPS_PER_S * 1e3,
                       field_muls=FIELD_MULS_PER_VERIFY,
                       # what the group spends (csrc/comb.cu), beside the bound and never in its
                       # place: its fold's THREADS_PER_LANE - 1 full adds where the function needs one
                       field_muls_design=FIELD_MULS_PER_VERIFY + (comb.THREADS_PER_LANE - 2) * 9)
        if name in secp_record["secp_kernels"]:  # launch shape and ptxas figures
            rec.update(secp_record["secp_kernels"][name])
        if name == "keccak256_blocks":  # launch shape, ptxas figures, the active rows alone
            rec.update(secp_record["k10_shape"])
        if name in bls_record["bls_shapes"]:  # launch shape and ptxas figures
            rec.update(bls_record["bls_shapes"][name])
        if name == "aggregate_g1":  # ms and bound_ms cover both stages; launches count the tile stage
            rec.update(finish_launches=total_launches["aggregate_g1_finish"],
                       finish_ms=bls_record["bls_k14_finish_ms"], rows=N_BLS)
        kernels.append(rec)
        extra = {"verify_batch": ("verify_batch_256",), "build_a_tables": ("build_a_tables_128",)}
        for key in (name, *extra.get(name, ())):
            if key in TIMING:
                it, wu, pit, pwu = TIMING[key]
            elif key in BLS_TIMING:  # the plain versions once, cold
                (it, wu), pit, pwu = BLS_TIMING[key], 1, 0
            else:  # the secp lane: the plain versions once, cold
                it, wu = SECP_TIMING["keccak256_blocks" if key == "keccak256_blocks" else "secp"]
                pit, pwu = 1, 0
            ms, plain_ms = t[key]
            by, secs = bound[key]
            lib_note = f"; library {library[name]:.4f} ms" if name in library else ""
            log(f"[21] {tag} {key}: {ms:.4f} ms over {it} launches after {wu} warm-up "
                f"(plain {plain_ms:.2f} ms over {pit} after {pwu}); bound {secs * 1e3:.4f} ms by "
                f"{by}, other side {other[key] * 1e3:.4f} ms{lib_note}; launches over the paths "
                f"{total_launches[name]}")
    # rows 23-26: per-rank kernels plus collectives, timed at world 1 (NCCL)
    # on the main path's shapes; each bound is the sum of its kernels' bounds
    k2_16k = int(uact.sum()) * OPS_PER_SHA512_BLOCK / INT32_OPS_PER_S
    tree_bound = bound["sha256_blocks"][1] + bound["merkle_tree"][1]
    shard_rows = {
        "sharded_verify_batch": (
            "row 23", ":71", "K2 -> K5 per rank; all_reduce(SUM) + all_gather",
            k2_16k + bound["verify_batch"][1]),
        "sharded_verify_cached": (
            "row 24", ":142", "K1 -> K2 -> K4 per rank; all_gather + all_reduce(MIN)",
            bound["parse_verify_payload"][1] + bound["sha512_blocks"][1] + bound["verify_cached"][1]),
        "sharded_merkle_root": (
            "row 25", ":252", "K7 + K8 per rank; all_gather of the subtree roots, K8 fold", tree_bound),
        "sharded_merkle_proofs": (
            "row 26", ":296", "K7 -> K8 -> K9 per rank; one final all_gather (the JAX program has none)",
            tree_bound + bound["merkle_gather"][1]),
    }
    for name, (tag, line, how, secs) in shard_rows.items():
        kernels.append({
            "name": name, "tag": tag, "route": "cuda", "source": "cometbft_tpu_torch/parallel/verify.py",
            "replaces": f"cometbft_tpu/parallel/verify.py{line}", "manifest_rows": [name],
            "launches": total_launches[name], "max_abs_err": shard_err[name],
            "parity": shard_err[name] == 0, "ms": shard_t[name], "plain_ms": shard_plain[name],
            "bound_ms": secs * 1e3, "bound_by": "operations", "library_ms": None, "world": 1,
            "per_rank": how,
        })
        log(f"[21] {tag} {name}: {shard_t[name]:.4f} ms at world 1 (NCCL; {how}); plain chain "
            f"{shard_plain[name]:.2f} ms once, cold; bound {secs * 1e3:.4f} ms (its kernels' bounds "
            f"summed); calls over the paths {total_launches[name]}")
    # a verify_commit launches K1, K2 and K4 once each
    device_ms = sum(t[n][0] for n in ("parse_verify_payload", "sha512_blocks", "verify_cached"))
    log(f"[21] total {time.perf_counter() - t_start:.1f} s; verify_commit p50 {p50:.3f} ms, of which "
        f"kernels {device_ms:.3f} ms ({100 * device_ms / p50:.2f}% device busy); table build "
        f"{cold_build_ms:.1f} ms cold, {warm_build_ms:.1f} ms warm, churn {churn_ms:.1f} ms "
        f"beside a verify_commit and {churn_solo_ms:.1f} ms alone, full build of the changed set "
        f"{full_ms:.1f} ms; uncached p50 {p50_u:.2f} ms; "
        f"light-client p50 {p50_l:.2f} ms; at {V_MAIN} validators verify_adjacent p50 "
        f"{p50_light['light_adjacent']:.2f} ms, verify_non_adjacent {p50_light['light_non_adjacent']:.2f}, "
        f"ValidatorSet.hash {p50_light['valset_hash']:.2f}; {N_LEAVES} proofs p50 {p50_proofs:.2f} ms, "
        f"multiproof {p50_multi:.2f} ms; secp {N_SECP} rows p50 "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in secp_record["secp_p50_ms"].items())
        + f"; BLS aggregate commit of {N_BLS}: cold {bls_record['bls_commit_ms']['cold']:.1f} ms, warm p50 "
        f"{bls_record['bls_commit_ms']['warm']:.2f} ms; BLS lane {bls_record['bls_lane_s']:.1f} s; "
        f"sharded verify_commit at world 1 p50 {shard_record['sharded_p50_ms']['verify_commit']:.2f} ms; "
        f"sharded phases {shard_record['sharded_phase_s']:.1f} s; through the service: verify_commit p50 "
        f"{svc_record['service_consensus_p50_ms']:.2f} ms alone, "
        f"{svc_record['service_flood_consensus_p50_ms']:.2f} under the CheckTx flood (mean MEMPOOL batch "
        f"{svc_record['service_flood_mean_batch']:.2f} rows), the service's cost "
        f"{svc_record['service_cost_per_commit_ms']:.2f} ms a commit; service phase "
        f"{svc_record['service_phase_s']:.1f} s; blocksync replay of {N_REPLAY_BLOCKS} commits of {V_REPLAY}: "
        f"{replay_record['replay_ms_per_block']['depth1']:.2f} ms a block at depth 1, "
        f"{replay_record['replay_ms_per_block']['depth2']:.2f} at depth 2; replay phase "
        f"{replay_record['replay_phase_s']:.1f} s; failover: verify_commit p50 "
        f"{failover_record['failover_watchdog_p50_ms']['on']:.2f} ms with the watchdog on, "
        f"{failover_record['failover_watchdog_p50_ms']['off']:.2f} off, trip {failover_record['failover_trip_s']:.2f} s, "
        f"restore {failover_record['failover_restore_s']:.2f} s after the clear; failover phase "
        f"{failover_record['failover_phase_s']:.1f} s; light client at {V_MAIN}: sync 1 -> {LIGHT_HEIGHTS} "
        f"{light_record['light_sync_ms']['cold']:.1f} ms cold, {light_record['light_sync_ms']['warm']:.1f} warm, "
        f"evidence check {light_record['evidence_check_ms']:.2f} ms, config 2 hop p50 "
        f"{light_record['light_config2_hop_p50_ms']:.2f} ms; light phase {light_record['light_phase_s']:.1f} s; "
        f"node at {V_MAIN}: {NODE_HEIGHTS} blocks built and saved in {node_record['node_build_s']:.1f} s, HTTP sync "
        f"{node_record['node_http_sync_ms']:.1f} ms; node phase {node_record['node_phase_s']:.1f} s")
    log(f"[21] {smi}: beside run 9m (ms) — light-client p50 {p50_l:.2f} ({RUN_9M['light-client p50']}), "
        f"uncached p50 {p50_u:.2f} ({RUN_9M['uncached p50']}), set change's first call {change_first_ms:.1f} "
        f"({RUN_9M['set change first call']}), churn build {churn_ms:.1f} beside it "
        f"({RUN_9M['churn build beside it']}) and {churn_solo_ms:.1f} alone ({RUN_9M['churn build alone']}); "
        f"K5 {t['verify_batch'][0]:.4f} / {t['verify_batch_256'][0]:.4f} at {lanes} / 256 lanes "
        f"({RUN_9M['K5 16,384 lanes']} / {RUN_9M['K5 256 lanes']}), K3 {t['build_a_tables'][0]:.4f} / "
        f"{t['build_a_tables_128'][0]:.4f} at {V_MAIN} / {bucket} keys ({RUN_9M['K3 10,000 keys']} / "
        f"{RUN_9M['K3 128 keys (wrapper)']} through the wrapper)")
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
                    "host_proofs_16k_ms": host_proofs_ms, **secp_record, **bls_record,
                    **shard_record, **svc_record, **replay_record, **light_record, **node_record,
                    **failover_record}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
