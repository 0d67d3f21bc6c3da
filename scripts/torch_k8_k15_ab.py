"""Compare the Merkle tree kernel K8, the BLS key-validation kernels K13
and K15, the BLS sum K14 and the SHA-512 kernel K2 of several source
trees on one CUDA card, in one process and in turns.

Each tree's ``cometbft_tpu_torch/csrc/merkle.cu``, ``bls.cu`` and
``sha2.cu`` are built (all at once).  A tree is a directory (``.`` for this one, an
earlier commit unpacked with ``git archive``), optionally with named
patches applied to a copy of its sources (``PATCHES``: another block
size).  A tree whose merkle.cu exports ``k8_merkle_tree``
hashes a tree in one launch; an older one exports ``k8_merkle_level`` and
is driven a launch a level, as its wrapper drove it.  Every tree must
equal the plain versions: K8's every level of the 16,384-leaf proof tree,
the 10,000-leaf validator-set tree and a tree of 4 x 256^2 + 1 leaves
(K8 launched twice back to back), K13's and K15's ok bytes and K15's
triple (with K14's finishing stage) on 10,000 BLS keys with four planted
rows (wrong subgroup, x >= p, host-rejected, off the curve), K14's
triple on the 10,000 keys without them (Z = 1), and K2's digests of
10,000 and 16,384 rows of 1-3 active blocks with random bytes past each
row's end (against the plain version).  Then, by CUDA events and in
turns (trees A..Z, then Z..A):

  - ``k8_16384``, ``k8_10000``: one whole tree above its leaf hashes;
  - ``k15``: K15 and K14's finishing stage on the 10,000 rows (what
    chip_smoke.py times as validate_aggregate_g1);
  - ``k13``: K13 on the same rows;
  - ``k14``: K14's tile and finishing stages on the 10,000 keys (what
    chip_smoke.py times as aggregate_g1); ``k14_finish``: its finishing
    stage alone;
  - ``k2_10000``, ``k2_16384``: K2 on the comb path's 10,000 rows and the
    uncached path's 16,384 lanes of two active blocks (the 125- and
    126-byte vote sign-bytes after R and A), as chip_smoke.py times it;

and, before them, one thread's SM cycles a SHA-512 round of each tree's
K2 row body (``k2_round``: a row of 63 blocks, the card otherwise idle);

each with ``host_ms``, the host's own time a call until it returns, and
K2 also with ``graph_ms``: its launches captured in a CUDA graph and
timed over one replay (chip_smoke.graph_ms), since K2 takes less time
than the host needs to issue a launch.
Prints each tree's kernels' ptxas figures, build seconds and, where the
toolkit has ``cuobjdump``, the SASS instructions of each function of its
bls library (``bls_sass``: the kernels and the out-of-line field and
group routines) and of its sha2 library with each kernel's global loads
and stores (``sha2_sass``), then one JSON line.  Needs the card and nvcc; from the repo's root:

    python3 scripts/torch_k8_k15_ab.py NAME=DIR[:PATCH[+PATCH...]] ...

e.g. ``parent=out/ab/parent this=. t128=.:k8_t128``; a tree of another K15 design is
another directory.
"""

from __future__ import annotations

import argparse
import ctypes
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

import chip_smoke as CS  # noqa: E402  (its ptxas parser, key builder and sizes)

SASS_FUNCTION = re.compile(r"\n\s*Function : ")
SASS_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")

SEED = 20261017
ITERS = {"k8_16384": 50, "k8_10000": 50, "k15": 5, "k13": 5, "k14": 20, "k14_finish": 20, "k2_10000": 50,
         "k2_16384": 50}
WARMUP = 2
GRAPHED = ("k2_10000", "k2_16384")
OUT = os.path.join(ROOT, "build", "k8_k15_ab")  # the trees' sources (patched) and libraries
SOURCES = ("merkle", "bls", "sha2")
N_BIG = 4 * 256 * 256 + 1  # stage 2 over more than one chunk of subtree roots at T = 256

# name -> [(file, the shipped text, its replacement)], applied to a copy of a tree's csrc
PATCHES = {
    "k8_t128": [("merkle_tree.cuh", "#define MERKLE_TREE_THREADS 256 ", "#define MERKLE_TREE_THREADS 128 ")],
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
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: patch {p} does not apply to {header}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
    return dst


def start_build(name: str, csrc: str, source: str):
    from cometbft_tpu_torch import _build

    out = os.path.join(OUT, f"lib{source}_{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(csrc, f"{source}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out, time.perf_counter()


def load(out: str, source: str) -> ctypes.CDLL:
    from cometbft_tpu_torch import _build

    lib = ctypes.CDLL(out)
    sigs = dict(_build.SIGNATURES[source])
    if source == "merkle":
        sigs["k8_merkle_level"] = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for fn, argtypes in sigs.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
    return lib


def k8(lib, flat, n, counter):
    """One tree above its n leaf hashes with the tree's K8: one launch, or
    (an older tree) one a level."""
    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch.ops import merkle as M

    s = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "k8_merkle_tree"):
        _build.check(lib.k8_merkle_tree(flat.data_ptr(), n, counter.data_ptr(), s), "k8_merkle_tree")
        return
    offs = M.level_offsets(n)
    for lvl, sz in enumerate(M.level_sizes(n)):
        _build.check(lib.k8_merkle_level(flat.data_ptr(), offs[lvl], sz, offs[lvl + 1], s), "k8_merkle_level")


def sass_text(lib_path: str) -> str | None:
    """``cuobjdump -sass`` of a built library (its errors after it), or
    None where the toolkit has no cuobjdump."""
    from cometbft_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    run = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True)
    return run.stdout + run.stderr


def sass_census(text: str | None) -> dict | None:
    """SASS instructions of each kernel in ``sass_text``'s output, NOPs
    left out, and of each routine it calls out of line (ptxas compiles a
    copy of each into every kernel that calls it; the listing names only
    the kernel, so a routine is its entry address and its call sites):
    {kernel: {"instructions": n, "callees": [{"instructions": n,
    "call_sites": k}, ...], "memory": {"LDG": n, ...}, "wide": n}}, the
    callees by call sites, most first; "memory" counts the global, shared
    and local loads and stores, "wide" the 16-byte global ones."""
    if text is None:
        return None
    out = {}
    for block in SASS_FUNCTION.split(text)[1:]:
        name, body = block.split("\n", 1)
        ins = [(int(a, 16), op) for a, op in SASS_INSTRUCTION.findall(body) if not op.startswith("NOP")]
        if not ins:
            continue
        sites = {}
        for _, op in ins:
            for t in re.findall(r"CALL\.REL\.NOINC (0x[0-9a-f]+)", op):
                sites[int(t, 16)] = sites.get(int(t, 16), 0) + 1
        starts = sorted(sites) + [ins[-1][0] + 16]
        callees = [{"instructions": sum(1 for a, _ in ins if lo <= a < hi), "call_sites": sites[lo]}
                   for lo, hi in zip(starts, starts[1:])]
        ops = [op.split()[0] if not op.startswith("@") else op.split()[1] for _, op in ins]
        mem = {k: sum(1 for o in ops if o.split(".")[0] == k) for k in ("LDG", "STG", "LDS", "STS", "LDL", "STL")}
        out[name.strip()] = {"instructions": len(ins), "callees": sorted(callees, key=lambda c: -c["call_sites"]),
                             "memory": {k: v for k, v in mem.items() if v},
                             "wide": sum(1 for o in ops if o.split(".")[0] in ("LDG", "STG") and ".128" in o)}
    return out


def bls_rows(dev):
    """10,000 affine keys (secrets a + i b) with rows 17, 4,242, 7,777 and
    9,998 planted (wrong subgroup, x >= p, host-rejected, off the curve),
    packed as the kernels take them; and the keys without the planted
    rows, packed as K14 takes them (Z = R mod p)."""
    import torch_bls_corpus as BC

    from cometbft_tpu_torch.crypto import bls12381 as H
    from cometbft_tpu_torch.ops import bls381 as B

    rng = np.random.default_rng(SEED)
    a, b = (int.from_bytes(rng.bytes(32), "big") % H.R for _ in range(2))
    pts = CS.bls_keys(H, a, b, CS.N_BLS)
    Xk, Yk, _ = B.pack_affine(pts)
    Zk = np.broadcast_to(B.ints_to_words_np([B.ONE_M]), Xk.shape).copy()
    keys = [torch.from_numpy(t).to(dev) for t in (Xk, Yk, Zk)]
    sp = BC.special_rows()
    for i, kind in zip(CS.BLS_PLANTED, ("wrong subgroup", "x >= p", "host-rejected", "off curve")):
        pts[i] = sp[kind]
    X, Y, valid = BC.pack({"points": pts})
    return [torch.from_numpy(t).to(dev) for t in (X, Y, valid.astype(np.uint8))], keys


# One thread hashes one row of SHA_ROUNDS_BLOCKS blocks with the tree's
# sha2.cuh row body, timed by clock64: SM cycles a round of K2's chain
# (its loads included), with the card otherwise idle.
SHA_ROUNDS_BLOCKS = 63
SHA_PROBE = r"""
#include <cuda_runtime.h>

#include "sha2.cuh"

__global__ void sha_round_probe(const uint8_t* blocks, int nb, uint8_t* out, long long* cyc) {
  const long long t0 = clock64();
  sha512_row(out, blocks, nb, nb);
  cyc[0] = clock64() - t0;
}

extern "C" int sha_round_probe_run(const void* blocks, int nb, void* out, void* cyc) {
  sha_round_probe<<<1, 1>>>((const uint8_t*)blocks, nb, (uint8_t*)out, (long long*)cyc);
  return (int)cudaGetLastError();
}
"""


def k2_round_cycles(name: str, csrc: str, dev) -> dict:
    """SM cycles a SHA-512 round of the tree's K2 row body (one thread, one
    row of SHA_ROUNDS_BLOCKS blocks, L2-warm; the third of three
    launches), its digest checked against hashlib."""
    import hashlib

    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch.ops import sha2

    src, out = os.path.join(OUT, f"sha_probe_{name}.cu"), os.path.join(OUT, f"libsha_probe_{name}.so")
    with open(src, "w") as f:
        f.write(SHA_PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", out, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.sha_round_probe_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    msg = np.random.default_rng(SEED).bytes(SHA_ROUNDS_BLOCKS * 128 - 17)
    blocks, active = sha2.pad_messages_sha512([msg])
    assert int(active[0]) == SHA_ROUNDS_BLOCKS
    b = torch.from_numpy(blocks).to(dev)
    digest = torch.zeros((64,), dtype=torch.uint8, device=dev)
    cyc = torch.zeros((1,), dtype=torch.int64, device=dev)
    for _ in range(3):
        _build.check(lib.sha_round_probe_run(b.data_ptr(), SHA_ROUNDS_BLOCKS, digest.data_ptr(), cyc.data_ptr()),
                     "sha_round_probe")
        torch.cuda.synchronize()
    right = bytes(digest.cpu().numpy()) == hashlib.sha512(msg).digest()
    return {"cycles_a_round": int(cyc.item()) / (80 * SHA_ROUNDS_BLOCKS), "right": right}


def k2_rows(n: int, dev):
    """K2's inputs at n rows: the timed batch (messages of R || A || a
    125- or 126-byte sign-bytes, two active blocks a row) and a batch of
    1-3 active blocks (tests/torch_sha_corpus.py), with the plain
    version's digests of both."""
    from cometbft_tpu_torch.ops import sha2

    import torch_sha_corpus as SC

    rng = np.random.default_rng(SEED + n)
    msgs = [rng.bytes(64 + 125 + (i & 1)) for i in range(n)]
    timed_in = sha2.pad_messages_sha512(msgs)
    _, stale, act = SC.stale_rows(rng, n, 3)
    ins = [tuple(torch.from_numpy(t).to(dev) for t in x) for x in (timed_in, (stale, act))]
    return (ins[0], ins[1], *(sha2.sha512_blocks_plain(*x) for x in ins))


def timed(fn, iters: int) -> tuple[float, float]:
    """(ms by CUDA events, ms on the host's clock until the calls return) a call."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="NAME=DIR[:PATCH+...]: a source tree whose kernels are built")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k8_k15_ab: no CUDA device", file=sys.stderr)
        return 2
    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch.ops import bls381 as B
    from cometbft_tpu_torch.ops import merkle as M

    smi = CS.smi_line()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    trees = dict(t.split("=", 1) for t in args.trees)
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")
    csrcs = {n: prepare(n, spec) for n, spec in trees.items()}
    procs = {(n, src): start_build(n, csrcs[n], src) for n in trees for src in SOURCES}
    t0 = time.perf_counter()
    (X, Y, valid), (Xk, Yk, Zk) = bls_rows(dev)  # keys while the trees build
    n_bls = X.shape[0]
    rng = np.random.default_rng(SEED)
    level0 = {n: torch.from_numpy(rng.integers(0, 256, size=(n, 32), dtype=np.uint8)).to(dev)
              for n in (16_384, 10_000, N_BIG)}
    want_tree = {}
    for n, lv in level0.items():
        want_tree[n] = torch.zeros((M.level_offsets(n)[-1] + 1, 32), dtype=torch.uint8, device=dev)
        want_tree[n][:n] = lv
        M.merkle_tree_plain(want_tree[n], n)
    want15 = B.validate_aggregate_g1_plain(X, Y, valid)
    # K15's output as one buffer: the triple (144 bytes), the ok bytes, the all-ok byte
    want15 = torch.cat([w.view(torch.uint8) for w in want15[1:]] + [want15[0].to(torch.uint8)])
    want14 = torch.cat([w.view(torch.uint8) for w in B.aggregate_g1_plain(Xk, Yk, Zk)])
    k2_in = {n: k2_rows(n, dev) for n in (10_000, 16_384)}  # (timed rows, stale rows, plain digests)
    tb = 4 * B.PT_WORDS
    print(f"inputs: {n_bls} BLS rows, trees of {sorted(level0)} leaves and the plain versions in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    libs, rec = {n: {} for n in trees}, {n: {"tree": trees[n]} for n in trees}
    kernels = {"merkle": {"k8": "k8_kernel"},
               "bls": {"k15": "k15_kernel", "k14": "k14_kernel",
                       "k14_finish": "k14_finish_kernel"},
               "sha2": {"k2": "k2_kernel"}}
    failed = False
    for (n, src), (proc, out, t_start) in procs.items():
        report, _ = proc.communicate()
        secs = time.perf_counter() - t_start
        if proc.returncode != 0:
            print(f"{n}: nvcc failed on {src}.cu\n{report}", flush=True)
            failed = True
            continue
        libs[n][src] = load(out, src)
        ks = kernels[src]
        rep = CS.ptxas_kernels(report, lambda line: next((k for k, e in ks.items() if e in line), None))
        rec[n].update({f"{k}_ptxas": v for k, v in rep["kernels"].items()},
                      **{f"{src}_build_s": secs, f"{src}_any_spill": rep["any_spill"]})
        print(f"{n}: {src}.cu built in {secs:.1f} s; {rep['kernels']}; spills {rep['any_spill']}", flush=True)
        if src in ("bls", "sha2"):
            rec[n][f"{src}_sass"] = sass_census(sass_text(out))
            print(f"{n}: {src} SASS instructions a function {rec[n][f'{src}_sass']}", flush=True)
    if failed:
        return 1

    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    flats = {n: torch.empty_like(w) for n, w in want_tree.items()}
    g = -(-n_bls // B.TILE)
    out15 = torch.empty((tb + n_bls + 1,), dtype=torch.uint8, device=dev)
    part = B._scratch(n_bls, dev)
    ok13 = torch.empty((n_bls + 1,), dtype=torch.uint8, device=dev)
    out14 = torch.empty((tb,), dtype=torch.uint8, device=dev)
    g14 = -(-Xk.shape[0] // B.TILE)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def k15(n):
        lib = libs[n]["bls"]
        _build.check(lib.k15_bls_validate_aggregate(X.data_ptr(), Y.data_ptr(), valid.data_ptr(),
                                                    out15[tb:].data_ptr(), out15[-1:].data_ptr(), part.data_ptr(),
                                                    n_bls, stream()), "k15")
        _build.check(lib.k14_bls_aggregate_finish(part.data_ptr(), g, out15.data_ptr(), stream()), "finish")

    def k13(n):
        lib = libs[n]["bls"]
        _build.check(lib.k13_bls_validate(X.data_ptr(), Y.data_ptr(), valid.data_ptr(), ok13.data_ptr(),
                                          ok13[n_bls:].data_ptr(), n_bls, stream()), "k13")

    def k14(n):
        lib = libs[n]["bls"]
        _build.check(lib.k14_bls_aggregate(Xk.data_ptr(), Yk.data_ptr(), Zk.data_ptr(), part.data_ptr(),
                                           Xk.shape[0], stream()), "k14")
        k14_finish(n)

    def k14_finish(n):
        _build.check(libs[n]["bls"].k14_bls_aggregate_finish(part.data_ptr(), g14, out14.data_ptr(), stream()),
                     "finish")

    dig = {r: torch.empty((r, 64), dtype=torch.uint8, device=dev) for r in k2_in}

    def k2(n, rows, which=0):
        blocks, active = k2_in[rows][which]
        _build.check(libs[n]["sha2"].k2_sha512_blocks(blocks.data_ptr(), active.data_ptr(), dig[rows].data_ptr(),
                                                      rows, blocks.shape[1], stream()), "k2")

    ok = True
    for n in libs:
        eq = {}
        for leaves, want in want_tree.items():
            for _ in range(2):  # back to back: the second after the first's counter reset
                flats[leaves].fill_(0xAA)
                flats[leaves][:leaves] = level0[leaves]
                k8(libs[n]["merkle"], flats[leaves], leaves, counter)
                eq.setdefault(f"k8_{leaves}", True)
                eq[f"k8_{leaves}"] &= bool(torch.equal(flats[leaves], want))
        out15.fill_(0xAA)
        out15[-1] = 1
        k15(n)
        eq["k15"] = bool(torch.equal(out15[:-1], want15)) and int(out15[-1]) == 0  # rows are planted
        ok13.fill_(0xAA)
        ok13[n_bls] = 1
        k13(n)
        eq["k13"] = bool(torch.equal(ok13[:n_bls], want15[tb:])) and int(ok13[n_bls]) == 0
        out14.fill_(0xAA)
        k14(n)
        eq["k14"] = bool(torch.equal(out14, want14))
        for rows, (timed_in, stale_in, want_timed, want_stale) in k2_in.items():
            for which, want in ((0, want_timed), (1, want_stale)):
                dig[rows].fill_(0xAA)
                k2(n, rows, which)
                eq.setdefault(f"k2_{rows}", True)
                eq[f"k2_{rows}"] &= bool(torch.equal(dig[rows], want))
        rec[n]["equal_plain"] = eq
        ok &= all(eq.values())
        print(f"{n}: == plain {eq}", flush=True)

    for n in libs:
        rec[n]["k2_round"] = k2_round_cycles(n, csrcs[n], dev)
        ok &= rec[n]["k2_round"]["right"]
        print(f"{n}: K2's row body, one thread alone: {rec[n]['k2_round']}", flush=True)

    def fns(n):
        return {
            "k8_16384": lambda: k8(libs[n]["merkle"], flats[16_384], 16_384, counter),
            "k8_10000": lambda: k8(libs[n]["merkle"], flats[10_000], 10_000, counter),
            "k15": lambda: k15(n),
            "k13": lambda: k13(n),
            "k14": lambda: k14(n),
            "k14_finish": lambda: k14_finish(n),
            "k2_10000": lambda: k2(n, 10_000),
            "k2_16384": lambda: k2(n, 16_384),
        }

    names = list(ITERS)
    order = list(libs) + list(reversed(libs))
    for f in names:
        for n in order:
            ms, host = timed(fns(n)[f], ITERS[f])
            rec[n].setdefault(f, {"ms": [], "host_ms": []})
            rec[n][f]["ms"].append(ms)
            rec[n][f]["host_ms"].append(host)
            if f in GRAPHED:  # a kernel shorter than its host cost: its launches in a CUDA graph too
                rec[n][f].setdefault("graph_ms", []).append(CS.graph_ms(fns(n)[f], ITERS[f]))
    for n in libs:
        print(f"{n}: " + "; ".join(f"{f} {rec[n][f]['ms']} ms (host {rec[n][f]['host_ms']}"
                                   + (f", graph {rec[n][f]['graph_ms']}" if f in GRAPHED else "") + ")"
                                   for f in names), flush=True)
    print(smi)
    print(json.dumps({"device": smi, "iters": ITERS, "warmup": WARMUP, "bls_rows": n_bls,
                      "tree_leaves": sorted(level0), "trees": rec}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
