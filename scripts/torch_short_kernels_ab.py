"""Compare the short kernels K1 (payload parse), K7 (SHA-256 rows), K9
(Merkle node gather) and K10 (Keccak-256 rows), with K2, K4 and K8 beside
them, of several source trees on one CUDA card, in one process and in
turns.

Each tree's ``cometbft_tpu_torch/csrc/sha2.cu``, ``merkle.cu``,
``keccak.cu``, ``comb.cu`` and ``secp.cu`` are built (all at once; trees
whose copy of a source and of every header it includes is the same
share one build).  A tree is a directory (``.`` for this one, an earlier
commit unpacked with ``git archive``), optionally with named patches
applied to a copy of its sources (``PATCHES``).  secp.cu is built for its
ptxas figures only (K12 inlines sha256.cuh's compression).  Every tree
must equal the plain versions first: K1 on payloads of maxm 128 with
every mlen edge, rows that are not live and rows whose mlen exceeds maxm
(up to 2^24 - 1), over poisoned outputs; K2 on K1's blocks; K4 at 10,000
lanes of tests/torch_comb_corpus.py; K7 on the timed rows and on rows of
1-3 active blocks with stale bytes past each row's end (against hashlib
too); K8 on both trees; K9 on the proofs' coordinates; K10 on its rows.
Then, in turns (trees A..Z, then Z..A), each kernel's time through a
CUDA graph (chip_smoke.graph_ms: ITERS launches captured, one replay
timed, no host time between launches) and by CUDA events around ITERS
launches (``ms``) with ``host_ms``, the host's own time a call:

  - ``k1``: K1 on the comb path's 10,000 rows of maxm 128 (2 blocks);
  - ``k2``: K2 on K1's 10,000 x 2 blocks;
  - ``k4``: K4 at 10,000 lanes;
  - ``k7_16384``: K7 on 16,384 rows of 1-3 active blocks (3 blocks a row);
  - ``k7_proof``: K7 on the proof tree's 16,384 leaves of 64 bytes (2
    blocks), as chip_smoke.py times it;
  - ``k7_10000``: K7 on the validator-set tree's 10,000 leaves (1 block);
  - ``k8_16384``, ``k8_10000``: K8, one whole tree above its leaf hashes;
  - ``k9``: K9 on the proofs' 16,384 x 15 coordinates;
  - ``k10``: K10 on 2,725 rows of 2 blocks, all active (the secp lane's
    Keccak rows alone);
  - ``k10_path``: K10 at the secp lane's shape, 4,096 rows of 2 blocks of
    which 1,371 (seeded) are at active = 0, as
    models/secp_verifier.staged_e launches it.

Before them, one thread's SM cycles a SHA-256 round of each tree's K7 row
body (``k7_round``: ``sha256_row`` over a row of 63 blocks, the card
otherwise idle, its digest checked against hashlib), and one warp's SM
cycles a Keccak round of each tree's K10 row body (``k10_round``: a warp
alone, 32 rows of the one-thread body or 16 pairs of keccak_group.cuh's,
each row K10_ROUND_BLOCKS blocks, digests checked against the host
Keccak).  Prints each tree's kernels' ptxas figures (registers, stack,
spill; K10's beside K11 / K12's), the SASS global loads and stores of its
sha2 and merkle kernels and K10's instruction mix (where the toolkit has
``cuobjdump``), then one JSON line.  Needs the card and nvcc; from the
repo's root:

    python3 scripts/torch_short_kernels_ab.py NAME=DIR[:PATCH[+PATCH...]] ...

e.g. ``parent=out/ab16/parent this=. k10_interleaved=.:k10_interleaved``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as CS  # noqa: E402  (graph_ms, the ptxas parser, shapes)
import torch_k8_k15_ab as AB  # noqa: E402  (library loading, SASS census, event timing)

SEED = 20261018
ITERS = {"k1": 50, "k2": 50, "k4": 10, "k7_16384": 50, "k7_proof": 50, "k7_10000": 50, "k8_16384": 50,
         "k8_10000": 50, "k9": 50, "k10": 50, "k10_path": 50}
OUT = os.path.join(ROOT, "build", "short_ab")  # the trees' patched sources and libraries
SOURCES = ("sha2", "merkle", "keccak", "comb", "secp")
KERNELS = {"sha2": ("k1_kernel", "k2_kernel"), "merkle": ("k7_kernel", "k8_kernel", "k9_kernel"),
           "keccak": ("k10_kernel",), "comb": ("k4_kernel",), "secp": ("k11_kernel", "k12_kernel")}
V_MAIN, MAXM, N_LEAVES, V_K10 = 10_000, 128, 16_384, 2_725
N_K10_PATH = 4_096  # the secp lane's rows; N_K10_PATH - V_K10 of them at active = 0
INCLUDE = re.compile(r'#include "([^"]+)"')

# name -> [(file, the shipped text, its replacement)], applied to a copy of a tree's csrc
PATCHES = {
    # K1's source bytes a byte a load (any width at any offset)
    "k1_byte": [("sha2.cuh", """  if (n <= 0) return 0;
#ifdef __CUDA_ARCH__
  const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(p));
#else
  const uint32_t w = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
#endif
  return n >= 4 ? w : w & ((1u << (8 * n)) - 1u);""", """  uint32_t w = 0;
  UNROLL
  for (int i = 0; i < 4; i++)
    if (i < n) w |= (uint32_t)LDG(p + i) << (8 * i);
  return w;""")],
    "k7_64": [("merkle.cu", "#define K7_THREADS 128 ", "#define K7_THREADS 64 ")],
    # K10's row body with each lane's bits split even / odd over the pair (the whole header replaced)
    "k10_interleaved": [("keccak_group.cuh", None, os.path.join(ROOT, "scripts", "k10_forms",
                                                                 "keccak_group_interleaved.cuh"))],
    # K10's pair body with one, two, four, six, twelve or all 24 rounds a loop trip
    "k10_one_round": [("keccak_group.cuh", '#define KG_ROUNDS_A_TRIP _Pragma("unroll 8")',
                      '#define KG_ROUNDS_A_TRIP _Pragma("unroll 1")')],
    "k10_unroll2": [("keccak_group.cuh", '#define KG_ROUNDS_A_TRIP _Pragma("unroll 8")',
                    '#define KG_ROUNDS_A_TRIP _Pragma("unroll 2")')],
    "k10_unroll4": [("keccak_group.cuh", '#define KG_ROUNDS_A_TRIP _Pragma("unroll 8")',
                    '#define KG_ROUNDS_A_TRIP _Pragma("unroll 4")')],
    "k10_unroll6": [("keccak_group.cuh", '#define KG_ROUNDS_A_TRIP _Pragma("unroll 8")',
                    '#define KG_ROUNDS_A_TRIP _Pragma("unroll 6")')],
    "k10_unroll12": [("keccak_group.cuh", '#define KG_ROUNDS_A_TRIP _Pragma("unroll 8")',
                     '#define KG_ROUNDS_A_TRIP _Pragma("unroll 12")')],
    "k10_unroll24": [("keccak_group.cuh", '#define KG_ROUNDS_A_TRIP _Pragma("unroll 8")',
                     '#define KG_ROUNDS_A_TRIP _Pragma("unroll")')],
    # the first block's loads issued only once the warp's longest row is known
    "k10_load_after": [("keccak_group.cuh", "  kg_load(nxt, row, t);\n  NOUNROLL",
                        "  if (nrun > 0) kg_load(nxt, row, t);\n  NOUNROLL")],
    # K10's pairs at 16 or 64 rows a block
    "k10_t32": [("keccak.cu", "#define K10_THREADS 64 ", "#define K10_THREADS 32 ")],
    "k10_t128": [("keccak.cu", "#define K10_THREADS 64 ", "#define K10_THREADS 128 ")],
    # the one-thread K10 (a tree before keccak_group.cuh) at 32 rows a block
    "k10_one_t32": [("keccak.cu", "int threads = 128;", "int threads = 32;")],
}


def prepare(name: str, spec: str) -> str:
    """The csrc directory of tree spec DIR[:PATCH+...], patched into OUT."""
    tree, _, patches = spec.partition(":")
    src = os.path.join(tree, "cometbft_tpu_torch", "csrc")
    if not patches:
        return src
    dst = os.path.join(OUT, f"src_{name}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for p in patches.split("+"):
        for header, old, new in PATCHES[p]:
            path = os.path.join(dst, header)
            if old is None:  # the whole file from `new`
                shutil.copyfile(new, path)
                continue
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: patch {p} does not apply to {header}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
    return dst


def source_digest(csrc: str, source: str) -> str:
    """Hash of a source and every header it includes, transitively."""
    h, todo, seen = hashlib.sha256(), [f"{source}.cu"], set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        with open(os.path.join(csrc, f), "rb") as fh:
            text = fh.read()
        h.update(f.encode() + b"\0" + text)
        todo += INCLUDE.findall(text.decode())
    return h.hexdigest()[:16]


def start_build(csrc: str, source: str, digest: str):
    from cometbft_tpu_torch import _build

    out = os.path.join(OUT, f"lib{source}_{digest}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(csrc, f"{source}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out, time.perf_counter()


# One thread hashes one row of ROUND_BLOCKS blocks with the tree's
# sha256.cuh row body, timed by clock64: SM cycles a round of K7's chain
# (its loads included), with the card otherwise idle.
ROUND_BLOCKS = 63
ROUND_PROBE = r"""
#include <cuda_runtime.h>

#include "sha256.cuh"

__global__ void sha256_round_probe(const uint8_t* blocks, int nb, uint8_t* out, long long* cyc) {
  const long long t0 = clock64();
  sha256_row(out, blocks, nb, nb);
  cyc[0] = clock64() - t0;
}

extern "C" int sha256_round_probe_run(const void* blocks, int nb, void* out, void* cyc) {
  sha256_round_probe<<<1, 1>>>((const uint8_t*)blocks, nb, (uint8_t*)out, (long long*)cyc);
  return (int)cudaGetLastError();
}
"""


def k7_round_cycles(name: str, csrc: str, dev) -> dict:
    """SM cycles a SHA-256 round of the tree's K7 row body (one thread, one
    row of ROUND_BLOCKS blocks, L2-warm; the third of three launches),
    its digest checked against hashlib."""
    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch.ops import sha2

    src, out = os.path.join(OUT, f"round_probe_{name}.cu"), os.path.join(OUT, f"libround_probe_{name}.so")
    with open(src, "w") as f:
        f.write(ROUND_PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", out, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.sha256_round_probe_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    msg = np.random.default_rng(SEED).bytes(ROUND_BLOCKS * 64 - 9)
    blocks, active = sha2.pad_messages_sha256([msg])
    assert int(active[0]) == ROUND_BLOCKS
    b = torch.from_numpy(blocks).to(dev)
    digest = torch.zeros((32,), dtype=torch.uint8, device=dev)
    cyc = torch.zeros((1,), dtype=torch.int64, device=dev)
    for _ in range(3):
        _build.check(lib.sha256_round_probe_run(b.data_ptr(), ROUND_BLOCKS, digest.data_ptr(), cyc.data_ptr()),
                     "sha256_round_probe")
        torch.cuda.synchronize()
    right = bytes(digest.cpu().numpy()) == hashlib.sha256(msg).digest()
    return {"cycles_a_round": int(cyc.item()) / (64 * ROUND_BLOCKS), "right": right}


# One warp alone hashes rows of K10_ROUND_BLOCKS blocks with the tree's
# K10 row body, timed by clock64: 32 rows on the one-thread body
# (keccak.cuh), 16 pairs on keccak_group.cuh's where the tree has it.  SM
# cycles a Keccak round of a warp's chain (its loads included).
K10_ROUND_BLOCKS = 32
K10_ROUND_PROBE = r"""
#include <cuda_runtime.h>

#if __has_include("keccak_group.cuh")
#include "keccak_group.cuh"
#define PROBE_ROWS 16
#else
#include "keccak.cuh"
#define PROBE_ROWS 32
#endif

__global__ void k10_round_probe(const uint8_t* blocks, int nb, uint32_t* out, long long* cyc) {
  const int t = threadIdx.x;
  __syncwarp();
  const long long t0 = clock64();
#if PROBE_ROWS == 16
  uint32_t dig[KG_GL][4];
  keccak_pair_row(dig, blocks + (size_t)(t >> 1) * nb * KECCAK_RATE, nb, nb, t & 1);
  for (int i = 0; i < 4; i++) out[(t >> 1) * 8 + 2 * i + (t & 1)] = dig[0][i];
#else
  uint64_t a[25];
  keccak256_row_state(a, blocks + (size_t)t * nb * KECCAK_RATE, nb, nb);
  for (int i = 0; i < 4; i++) reinterpret_cast<uint64_t*>(out)[t * 4 + i] = a[i];
#endif
  __syncwarp();
  if (t == 0) cyc[0] = clock64() - t0;
}

extern "C" int k10_round_probe_run(const void* blocks, int nb, void* out, void* cyc) {
  k10_round_probe<<<1, 32>>>((const uint8_t*)blocks, nb, (uint32_t*)out, (long long*)cyc);
  return (int)cudaGetLastError();
}

extern "C" int k10_round_probe_rows() { return PROBE_ROWS; }
"""


def k10_round_cycles(name: str, csrc: str, dev) -> dict:
    """SM cycles a Keccak round of the tree's K10 row body on one warp
    alone (rows of K10_ROUND_BLOCKS blocks, L2-warm; the third of three
    launches), its digests checked against the host Keccak."""
    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch.crypto.keccak import keccak256
    from cometbft_tpu_torch.ops import keccak as K

    src, out = os.path.join(OUT, f"k10_probe_{name}.cu"), os.path.join(OUT, f"libk10_probe_{name}.so")
    with open(src, "w") as f:
        f.write(K10_ROUND_PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", out, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.k10_round_probe_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    rows = lib.k10_round_probe_rows()
    rng = np.random.default_rng(SEED + 1)
    msgs = [rng.bytes(K10_ROUND_BLOCKS * K.RATE - 1) for _ in range(rows)]
    blocks, active = K.pad_messages_keccak(msgs)
    assert (active == K10_ROUND_BLOCKS).all()
    b = torch.from_numpy(blocks).to(dev)
    digest = torch.zeros((rows, 32), dtype=torch.uint8, device=dev)
    cyc = torch.zeros((1,), dtype=torch.int64, device=dev)
    for _ in range(3):
        _build.check(lib.k10_round_probe_run(b.data_ptr(), K10_ROUND_BLOCKS, digest.data_ptr(), cyc.data_ptr()),
                     "k10_round_probe")
        torch.cuda.synchronize()
    right = [bytes(r) for r in digest.cpu().numpy()] == [keccak256(m) for m in msgs]
    return {"rows": rows, "cycles_a_round": int(cyc.item()) / (24 * K10_ROUND_BLOCKS), "right": right}


def op_mix(text: str | None, kernel: str) -> dict | None:
    """SASS instructions of ``kernel`` by opcode (NOPs left out), most
    first; None where the toolkit has no cuobjdump."""
    if text is None:
        return None
    for block in AB.SASS_FUNCTION.split(text)[1:]:
        name, body = block.split("\n", 1)
        if kernel in name:
            ops = [op.split()[0] if not op.startswith("@") else op.split()[1]
                   for _, op in AB.SASS_INSTRUCTION.findall(body)]
            mix = {}
            for o in ops:
                if not o.startswith("NOP"):
                    mix[o.split(".")[0]] = mix.get(o.split(".")[0], 0) + 1
            return dict(sorted(mix.items(), key=lambda kv: -kv[1]))
    return None


def k1_inputs(rng, dev):
    """The timed payload (R || s, a 125- or 126-byte message, live) and a
    parity payload of every mlen edge, rows that are not live and rows
    whose mlen exceeds maxm, with random bytes everywhere else; both of
    width 68 + MAXM, with random pubkeys."""
    timed = rng.integers(0, 256, size=(V_MAIN, 68 + MAXM), dtype=np.uint8)
    mlen = 125 + (np.arange(V_MAIN) & 1)
    timed[:, 64], timed[:, 65], timed[:, 66], timed[:, 67] = mlen, 0, 0, 1
    edge = rng.integers(0, 256, size=(V_MAIN + 1, 68 + MAXM), dtype=np.uint8)
    ml = rng.integers(0, MAXM + 1, size=V_MAIN + 1)
    ml[:14] = [0, 1, 47, 48, 63, 64, 111, 112, MAXM, MAXM + 1, 175, 176, 1 << 20, (1 << 24) - 1]
    edge[:, 64], edge[:, 65], edge[:, 66] = ml & 0xFF, (ml >> 8) & 0xFF, ml >> 16
    edge[:, 67] = (rng.random(V_MAIN + 1) > 0.1).astype(np.uint8)
    pubs = [rng.integers(0, 256, size=(n, 32), dtype=np.uint8) for n in (V_MAIN, V_MAIN + 1)]
    return [(torch.from_numpy(p).to(dev), torch.from_numpy(k).to(dev)) for p, k in ((timed, pubs[0]), (edge, pubs[1]))]


def k7_inputs(rng, dev):
    """name -> (blocks, active, msgs): 16,384 rows of 1-3 active blocks
    with stale bytes past each row's end, the proof tree's 16,384 leaves
    of 64 bytes (the 0x00 prefix included) and the validator-set tree's
    10,000 one-block leaves."""
    from cometbft_tpu_torch.ops import sha2

    out = {}
    lens = rng.integers(0, 3 * 64 - 9 + 1, size=N_LEAVES)
    lens[:8] = [0, 55, 56, 63, 64, 119, 120, 183]
    msgs = [rng.bytes(int(n)) for n in lens]
    blk, act = sha2.pad_messages_sha256(msgs, max_len=3 * 64 - 9)
    blk = blk.copy()
    past = np.arange(3)[None, :] >= act[:, None]
    blk[past] = rng.integers(0, 256, size=(int(past.sum()), 64), dtype=np.uint8)
    out["k7_16384"] = (blk, act, msgs)
    for name, n, ln in (("k7_proof", N_LEAVES, 64), ("k7_10000", V_MAIN, 40)):
        msgs = [b"\x00" + rng.bytes(ln) for _ in range(n)]
        blk, act = sha2.pad_messages_sha256(msgs)
        out[name] = (blk, act, msgs)
    return {k: (torch.from_numpy(b).to(dev), torch.from_numpy(a).to(dev), m) for k, (b, a, m) in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="NAME=DIR[:PATCH+...]: a source tree whose kernels are built")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_short_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch.crypto import merkle as cmerkle
    from cometbft_tpu_torch.ops import comb, keccak as K, merkle as M, sha2

    import torch_comb_corpus as CC

    smi = CS.smi_line()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    trees = dict(t.split("=", 1) for t in args.trees)
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")
    csrcs = {n: prepare(n, spec) for n, spec in trees.items()}
    digests = {(n, s): source_digest(csrcs[n], s) for n in trees for s in SOURCES}
    procs = {}
    for (n, s), d in digests.items():
        if (s, d) not in procs:
            procs[(s, d)] = start_build(csrcs[n], s, d)

    # inputs while the trees build
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    k1_in = k1_inputs(rng, dev)
    k7_in = k7_inputs(rng, dev)
    pool = CC.Pool(SEED)
    eb = CC.batch(pool, V_MAIN, SEED, "valid")
    k4_pay, k4_dig = torch.from_numpy(eb["payload"]).to(dev), torch.from_numpy(eb["digest"]).to(dev)
    k4_key = torch.from_numpy(eb["key"]).to(dev)
    k10_msgs = [rng.bytes(256) for _ in range(V_K10)]
    kb_np, ka_np = K.pad_messages_keccak(k10_msgs)
    kb, ka = torch.from_numpy(kb_np).to(dev), torch.from_numpy(ka_np).to(dev)
    path_msgs = [rng.bytes(256) for _ in range(N_K10_PATH)]
    pb_np, pa_np = K.pad_messages_keccak(path_msgs)
    pa_np[rng.permutation(N_K10_PATH)[: N_K10_PATH - V_K10]] = 0
    pb, pa = torch.from_numpy(pb_np).to(dev), torch.from_numpy(pa_np).to(dev)
    print(f"inputs in {time.perf_counter() - t0:.1f} s", flush=True)

    builds, failed = {}, False
    for (s, d), (proc, out, t_start) in procs.items():
        report, _ = proc.communicate()
        secs = time.perf_counter() - t_start
        if proc.returncode != 0:
            print(f"nvcc failed on {s}.cu ({d})\n{report}", flush=True)
            failed = True
            continue
        rep = CS.ptxas_kernels(report, lambda line, s=s: next(
            (line.split("'")[1] if s == "secp" else k for k in KERNELS[s] if k in line), None))
        builds[(s, d)] = {"lib": AB.load(out, s), "path": out, "ptxas": rep["kernels"], "any_spill": rep["any_spill"],
                          "build_s": secs}
    if failed:
        return 1
    libs, rec = {n: {} for n in trees}, {n: {"tree": trees[n]} for n in trees}
    for (n, s), d in digests.items():
        b = builds[(s, d)]
        libs[n][s] = b["lib"]
        rec[n][f"{s}_ptxas"] = b["ptxas"]
        rec[n][f"{s}_any_spill"] = b["any_spill"]
        rec[n][f"{s}_build_s"] = b["build_s"]
        if s in ("sha2", "merkle", "keccak"):
            text = AB.sass_text(b["path"])
            census = AB.sass_census(text)
            rec[n][f"{s}_sass"] = None if census is None else {
                k: {"instructions": v["instructions"], "memory": v["memory"], "wide": v["wide"]}
                for k, v in census.items()}
            if s == "keccak":
                rec[n]["k10_op_mix"] = op_mix(text, "k10_kernel")
        print(f"{n}: {s}.cu ({d}) built in {b['build_s']:.1f} s; {b['ptxas']}; spills {b['any_spill']}", flush=True)
        if s in ("sha2", "merkle", "keccak"):
            print(f"{n}: {s} SASS {rec[n][f'{s}_sass']}", flush=True)
    for n in trees:
        print(f"{n}: K10 {rec[n]['keccak_ptxas']} beside K11 / K12 {rec[n]['secp_ptxas']}; K10 SASS mix "
              f"{rec[n].get('k10_op_mix')}", flush=True)

    # the plain versions' outputs, and the buffers every tree writes
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    nb1 = sha2.nblocks_for(MAXM)
    want1 = [sha2.parse_verify_payload_plain(p, k) for p, k in k1_in]
    blk1 = [torch.empty((p.shape[0], nb1, 128), dtype=torch.uint8, device=dev) for p, _ in k1_in]
    act1 = [torch.empty((p.shape[0],), dtype=torch.int32, device=dev) for p, _ in k1_in]
    want2 = sha2.sha512_blocks_plain(*want1[0])
    dig2 = torch.empty((V_MAIN, 64), dtype=torch.uint8, device=dev)
    pool_tab, pool_val = comb.build_a_tables(torch.from_numpy(pool.pubs).to(dev))
    k4_tab, k4_val = pool_tab[k4_key].contiguous(), pool_val[k4_key].to(torch.uint8).contiguous()
    b_tab = comb.b_tables(dev)
    want4 = comb.pack_verdicts(comb.verify_cached_plain(k4_tab, k4_val.bool(), k4_pay, k4_dig, b_tab),
                               k4_pay[:, 67] == 1)
    out4, cnt4 = torch.empty_like(want4), torch.empty((2,), dtype=torch.int32, device=dev)
    want7 = {k: sha2.sha256_blocks_plain(b, a) for k, (b, a, _) in k7_in.items()}
    for k, (_, a, msgs) in k7_in.items():
        hl = [hashlib.sha256(m).digest() for m in msgs]
        assert [bytes(r) for r in want7[k].cpu().numpy()] == hl, f"plain K7 != hashlib on {k}"
    dig7 = {k: torch.empty((b.shape[0], 32), dtype=torch.uint8, device=dev) for k, (b, _, _) in k7_in.items()}
    flats = {}
    for n, key in ((N_LEAVES, "k7_proof"), (V_MAIN, "k7_10000")):
        want = torch.zeros((M.level_offsets(n)[-1] + 1, 32), dtype=torch.uint8, device=dev)
        want[:n] = want7[key]
        M.merkle_tree_plain(want, n)
        flats[n] = (want, torch.empty_like(want))
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    coords = torch.from_numpy(M.proof_coords(N_LEAVES, range(N_LEAVES),
                                             cmerkle._plan_array(N_LEAVES, range(N_LEAVES)))).to(dev).reshape(-1)
    want9 = M.merkle_gather_plain(flats[N_LEAVES][0], coords)
    out9 = torch.empty_like(want9)
    want10 = K.keccak256_blocks_plain(kb, ka)
    out10 = torch.empty_like(want10)
    want10p = K.keccak256_blocks_plain(pb, pa)
    out10p = torch.empty_like(want10p)
    from cometbft_tpu_torch.crypto import secp256k1eth as host_eth

    assert [bytes(r) for r in want10[:64].cpu().numpy()] == [host_eth.keccak256(m) for m in k10_msgs[:64]]

    def k1(n, which=0):
        p, k = k1_in[which]
        _build.check(libs[n]["sha2"].k1_parse_verify_payload(
            p.data_ptr(), k.data_ptr(), blk1[which].data_ptr(), act1[which].data_ptr(), p.shape[0], p.shape[1], nb1,
            stream()), "k1")

    def k2(n):
        _build.check(libs[n]["sha2"].k2_sha512_blocks(want1[0][0].data_ptr(), want1[0][1].data_ptr(), dig2.data_ptr(),
                                                      V_MAIN, nb1, stream()), "k2")

    def k4(n):
        _build.check(libs[n]["comb"].k4_verify_cached(
            k4_tab.data_ptr(), k4_val.data_ptr(), k4_pay.data_ptr(), k4_pay.shape[1], k4_dig.data_ptr(),
            b_tab.data_ptr(), cnt4.data_ptr(), out4.data_ptr(), V_MAIN, stream()), "k4")

    def k7(n, key):
        b, a, _ = k7_in[key]
        _build.check(libs[n]["merkle"].k7_sha256_blocks(b.data_ptr(), a.data_ptr(), dig7[key].data_ptr(), b.shape[0],
                                                        b.shape[1], stream()), "k7")

    def k8(n, leaves):
        _build.check(libs[n]["merkle"].k8_merkle_tree(flats[leaves][1].data_ptr(), leaves, counter.data_ptr(),
                                                      stream()), "k8")

    def k9(n):
        f = flats[N_LEAVES][0]
        _build.check(libs[n]["merkle"].k9_merkle_gather(f.data_ptr(), coords.data_ptr(), out9.data_ptr(),
                                                        coords.shape[0], f.shape[0], stream()), "k9")

    def k10(n, path=False):
        b, a, o = (pb, pa, out10p) if path else (kb, ka, out10)
        _build.check(libs[n]["keccak"].k10_keccak256_blocks(b.data_ptr(), a.data_ptr(), o.data_ptr(),
                                                            b.shape[0], b.shape[1], stream()), "k10")

    ok = True
    for n in libs:
        eq = {}
        for which in (0, 1):
            blk1[which].fill_(0xAA)
            act1[which].fill_(-0x55555556)
            k1(n, which)
            eq[f"k1_{which}"] = bool(torch.equal(blk1[which], want1[which][0])
                                     and torch.equal(act1[which], want1[which][1]))
        dig2.fill_(0xAA)
        k2(n)
        eq["k2"] = bool(torch.equal(dig2, want2))
        out4.fill_(0xAA)
        k4(n)
        eq["k4"] = bool(torch.equal(out4, want4))
        for key in k7_in:
            dig7[key].fill_(0xAA)
            k7(n, key)
            eq[key] = bool(torch.equal(dig7[key], want7[key]))
        for leaves, (want, flat) in flats.items():
            flat.fill_(0xAA)
            flat[:leaves] = want[:leaves]
            k8(n, leaves)
            eq[f"k8_{leaves}"] = bool(torch.equal(flat, want))
        out9.fill_(0xAA)
        k9(n)
        eq["k9"] = bool(torch.equal(out9, want9))
        out10.fill_(0xAA)
        k10(n)
        eq["k10"] = bool(torch.equal(out10, want10))
        out10p.fill_(0xAA)
        k10(n, path=True)
        eq["k10_path"] = bool(torch.equal(out10p, want10p))
        rec[n]["equal_plain"] = eq
        ok &= all(eq.values())
        print(f"{n}: == plain {eq}", flush=True)

    for n in libs:
        rec[n]["k7_round"] = k7_round_cycles(n, csrcs[n], dev)
        ok &= rec[n]["k7_round"]["right"]
        print(f"{n}: K7's row body, one thread alone: {rec[n]['k7_round']}", flush=True)
        rec[n]["k10_round"] = k10_round_cycles(n, csrcs[n], dev)
        ok &= rec[n]["k10_round"]["right"]
        print(f"{n}: K10's row body, one warp alone: {rec[n]['k10_round']}", flush=True)

    def fns(n):
        return {"k1": lambda: k1(n), "k2": lambda: k2(n), "k4": lambda: k4(n),
                "k7_16384": lambda: k7(n, "k7_16384"), "k7_proof": lambda: k7(n, "k7_proof"),
                "k7_10000": lambda: k7(n, "k7_10000"), "k8_16384": lambda: k8(n, N_LEAVES),
                "k8_10000": lambda: k8(n, V_MAIN), "k9": lambda: k9(n), "k10": lambda: k10(n),
                "k10_path": lambda: k10(n, path=True)}

    order = list(libs) + list(reversed(libs))
    for f in ITERS:
        for n in order:
            ms, host = AB.timed(fns(n)[f], ITERS[f])
            g = CS.graph_ms(fns(n)[f], ITERS[f])
            r = rec[n].setdefault(f, {"graph_ms": [], "ms": [], "host_ms": []})
            r["graph_ms"].append(g)
            r["ms"].append(ms)
            r["host_ms"].append(host)
    for n in libs:
        print(f"{n}: " + "; ".join(f"{f} graph {rec[n][f]['graph_ms']} ms, events {rec[n][f]['ms']} "
                                   f"(host {rec[n][f]['host_ms']})" for f in ITERS), flush=True)
    shapes = {"k1": [V_MAIN, nb1], "k7_16384": list(k7_in["k7_16384"][0].shape[:2]),
              "k7_proof": list(k7_in["k7_proof"][0].shape[:2]), "k7_10000": list(k7_in["k7_10000"][0].shape[:2]),
              "k9": [int(coords.shape[0])], "k10": list(kb.shape[:2]), "k10_path": list(pb.shape[:2]), "k4": [V_MAIN]}
    active = {k: int(a.sum()) for k, (_, a, _) in k7_in.items()}
    print(smi)
    print(json.dumps({"device": smi, "iters": ITERS, "warmup": AB.WARMUP, "shapes": shapes, "k7_active": active,
                      "k10_active": int(ka.sum()), "k10_path_active": int(pa.sum()), "trees": rec}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
