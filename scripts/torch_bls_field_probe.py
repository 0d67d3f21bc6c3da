"""Latency of the BLS12-381 field multiply, the square, one row's ladder
and one general point add of several source trees' ``csrc/bls381.cuh``
(and ``bls381_group.cuh`` where a tree has it), on one CUDA card.

For each tree a probe library whose kernels include the tree's header
is built with the port's nvcc flags (all trees at once).  One thread of
one block then runs ITERS dependent multiplies (x = x y R^-1), ITERS
dependent squares (s = s^2 R^-1) and ``bls_validate_row`` on one key,
each in a kernel of its own and timed by ``clock64`` (SM cycles) around
it: the cycles of one row's dependent chain, what bounds K13 and K15 at
a few warps an SM.  Then one warp alone on the card runs ADD_ITERS
dependent general adds (acc = acc + q, both at Z != 1) in each form, a
kernel a form: ``g1_add`` (one thread an add, every thread of the warp
its own chain) and ``bg_add`` (a group of four threads an add; the
warp's eight groups each their own chain): the latency of one add of
the BLS trees; then ``bg_tree`` over TREE_PTS points in one block.  A header whose fe_mul takes word pointers (no fe values, no
fe_sq) gets the row's kernel only.  The results must equal Python
integers' (the row must validate; every form's sum the host's).
Prints each tree's ptxas figures for the probe, the SASS instructions
of fe_mul and fe_sq (the routine each kernel calls; ``cuobjdump -sass``,
where the toolkit has it, the whole listing kept beside the library
under build/bls_field_probe/) and of the routines the row calls, the
card's SM clock, then one JSON line.  Needs the card and nvcc; from the
repo's root:

    python3 scripts/torch_bls_field_probe.py NAME=DIR ...

e.g. ``parent=out/ab/parent this=.`` (the parent from ``git archive``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as CS  # noqa: E402  (smi_line, the ptxas parser)
from torch_k8_k15_ab import sass_census, sass_text  # noqa: E402

ITERS = 1000
OUT = os.path.join(ROOT, "build", "bls_field_probe")

# the multiply's and the square's kernels, for a header whose fe_mul and
# fe_sq take and return fe values; the row's kernel runs on any header
# (bls_validate_row's interface is every tree's).  One routine a kernel,
# so that each kernel's listing holds one copy of it.
FIELD = r"""
__global__ void bls_probe_mul(u32* io, long long* cyc, int iters) {
  fe x = fe_ld(io), y = fe_ld(io + BLS_W);
  long long t0 = clock64();
  for (int i = 0; i < iters; i++) x = fe_mul(x, y);
  cyc[0] = clock64() - t0;
  fe_copy(io + 5 * BLS_W, x.w);
}

__global__ void bls_probe_sq(u32* io, long long* cyc, int iters) {
  fe s = fe_ld(io + 2 * BLS_W);
  long long t0 = clock64();
  for (int i = 0; i < iters; i++) s = fe_sq(s);
  cyc[1] = clock64() - t0;
  fe_copy(io + 6 * BLS_W, s.w);
}
"""
# one general add in each form: acc = acc + q, ADD_ITERS times; acc (36
# words) at io + 8 BLS_W, q after it, form f's sum at io + (14 + 3 f) BLS_W
ADDS = r"""
__global__ void bls_probe_add1(u32* io, long long* cyc, int iters) {
  g1p a, q;
  fe_copy(a.X, io + 8 * BLS_W);
  fe_copy(a.Y, io + 9 * BLS_W);
  fe_copy(a.Z, io + 10 * BLS_W);
  fe_copy(q.X, io + 11 * BLS_W);
  fe_copy(q.Y, io + 12 * BLS_W);
  fe_copy(q.Z, io + 13 * BLS_W);
  long long t0 = clock64();
  for (int i = 0; i < iters; i++) g1_add(a, a, q);
  const long long t = clock64() - t0;
  if (threadIdx.x == 0) {
    cyc[3] = t;
    u32* o = io + 14 * BLS_W;
    fe_copy(o, a.X);
    fe_copy(o + BLS_W, a.Y);
    fe_copy(o + 2 * BLS_W, a.Z);
  }
}
"""
ADDS_GROUP = r"""
#include "bls381_group.cuh"

#define TREE_PTS @TREE_PTS@

__global__ void bls_probe_addg(u32* io, long long* cyc, int iters) {
  __shared__ u32 pts[32 / BG_G][2 * BG_PITCH];
  __shared__ u32 files[32 / BG_G][BG_FILE];
  const int k = threadIdx.x / BG_G, tid = threadIdx.x % BG_G;
  const unsigned mask = bg_mask(threadIdx.x);
  for (int w = tid; w < 2 * BLS_PT; w += BG_G) pts[k][w < BLS_PT ? w : w + 1] = io[8 * BLS_W + w];
  __syncwarp();
  long long t0 = clock64();
  for (int i = 0; i < iters; i++) bg_add(pts[k], pts[k], pts[k] + BG_PITCH, files[k], tid, mask);
  __syncwarp();
  const long long t = clock64() - t0;
  if (threadIdx.x == 0) {
    cyc[4] = t;
    for (int w = 0; w < BLS_PT; w++) io[17 * BLS_W + w] = pts[0][w];
  }
}

// K14's tree as its kernels run it (bg_tree) over TREE_PTS
// points in one block: SM cycles and ns (%globaltimer) of the whole tree
__global__ void __launch_bounds__(TREE_PTS * 2) bls_probe_tree(u32* io, long long* cyc) {
  __shared__ u32 pts[TREE_PTS * BG_PITCH];
  __shared__ u32 files[TREE_PTS / 2 * BG_FILE];
  for (int w = threadIdx.x; w < TREE_PTS * BLS_PT; w += blockDim.x)
    pts[w / BLS_PT * BG_PITCH + w % BLS_PT] = io[20 * BLS_W + w];
  __syncthreads();
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long t0 = clock64();
  bg_tree(pts, TREE_PTS, files);
  const long long t = clock64() - t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  if (threadIdx.x == 0) {
    cyc[5] = t;
    cyc[6] = (long long)(g1 - g0);
    for (int w = 0; w < BLS_PT; w++) io[20 * BLS_W + TREE_PTS * BLS_PT + w] = pts[w];
  }
}
"""
TREE_PTS = 128  # the tree probe's points: 7 levels, 64 groups of 4 threads at the first
LAUNCH_ADDS = """  bls_probe_add1<<<1, 32>>>((u32*)io, (long long*)cyc, add_iters);
"""
LAUNCH_ADDS_GROUP = f"""  bls_probe_addg<<<1, 32>>>((u32*)io, (long long*)cyc, add_iters);
  bls_probe_tree<<<1, {2 * TREE_PTS}>>>((u32*)io, (long long*)cyc);
"""
ADD_FORMS = ("g1_add", "group4")  # their sums at io + 14 BLS_W and + 17 BLS_W; the tree's points at + 20 BLS_W
ADD_ITERS = 20
PROBE = r"""
#include <cuda_runtime.h>

#include "bls381.cuh"

// io: x, y, s, then a key's (x, y); out: x y^iters, s^(2^iters), ok
%s
__global__ void bls_probe_row(u32* io, long long* cyc) {
  long long t0 = clock64();
  const bool ok = bls_validate_row(io + 3 * BLS_W, io + 4 * BLS_W, true);
  cyc[2] = clock64() - t0;
  io[7 * BLS_W] = ok ? 1u : 0u;
}

%s
extern "C" int bls_probe(void* io, void* cyc, int iters, int add_iters) {
%s  bls_probe_row<<<1, 1>>>((u32*)io, (long long*)cyc);
%s  return (int)cudaGetLastError();
}
"""
LAUNCH_FIELD = """  bls_probe_mul<<<1, 1>>>((u32*)io, (long long*)cyc, iters);
  bls_probe_sq<<<1, 1>>>((u32*)io, (long long*)cyc, iters);
"""


def probe_source(header: str, group: bool) -> tuple[str, bool]:
    """The probe's source for a header, and whether it probes fe_mul,
    fe_sq and the one-thread adds (the header passes fe values to both);
    ``group``: the tree has bls381_group.cuh, whose adds are probed too."""
    field = bool(re.search(r"\bfe\s+fe_mul\s*\(", header) and re.search(r"\bfe\s+fe_sq\s*\(", header))
    if not field:
        return PROBE % ("", "", "", ""), False
    adds = ADDS + (ADDS_GROUP.replace("@TREE_PTS@", str(TREE_PTS)) if group else "")
    launch = LAUNCH_ADDS + (LAUNCH_ADDS_GROUP if group else "")
    return PROBE % (FIELD, adds, LAUNCH_FIELD, launch), True


def start_build(name: str, tree: str):
    from cometbft_tpu_torch import _build

    csrc = os.path.join(tree, "cometbft_tpu_torch", "csrc")
    with open(os.path.join(csrc, "bls381.cuh")) as f:
        header = f.read()
    src = os.path.join(OUT, f"probe_{name}.cu")
    text, field = probe_source(header, os.path.exists(os.path.join(csrc, "bls381_group.cuh")))
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(OUT, f"libprobe_{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", out, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out, time.perf_counter(), field


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="NAME=DIR: a source tree whose bls381.cuh is probed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bls_field_probe: no CUDA device", file=sys.stderr)
        return 2
    from cometbft_tpu_torch.crypto import bls12381 as H
    from cometbft_tpu_torch.ops import bls381 as B

    smi = CS.smi_line()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(f"device: {smi}; SM clock now, max: {clock}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    os.makedirs(OUT, exist_ok=True)
    trees = dict(t.split("=", 1) for t in args.trees)
    procs = {n: start_build(n, d) for n, d in trees.items()}

    rng = np.random.default_rng(20261018)
    P, RI = B.P, pow(B.R_MONT, -1, B.P)
    x0, y0, s0 = (int.from_bytes(rng.bytes(48), "little") % P for _ in range(3))
    key = H.G1_GEN
    vals = [x0, y0, s0, B.to_mont(key[0]), B.to_mont(key[1]), 0, 0, 0]
    # the adds: acc = [3] G and q = [5] G at random Z; the sum after ADD_ITERS adds, [3 + 5 ADD_ITERS] G
    F = H._FP
    jac = []
    for k in (3, 5):
        x, y = H._to_affine(F, H._jac_mul(F, H._from_affine(F, key), k))
        z = int.from_bytes(rng.bytes(48), "little") % P
        jac += [B.to_mont(x * z * z % P), B.to_mont(y * z**3 % P), B.to_mont(z)]
    want_sum = H._to_affine(F, H._jac_mul(F, H._from_affine(F, key), 3 + 5 * ADD_ITERS))
    # the tree's points: [k] G for k = 1..TREE_PTS at random Z; their sum, [TREE_PTS (TREE_PTS + 1) / 2] G
    tree = []
    acc = H._from_affine(F, key)
    for _ in range(TREE_PTS):
        x, y = H._to_affine(F, acc)
        z = int.from_bytes(rng.bytes(48), "little") % P
        tree += [B.to_mont(x * z * z % P), B.to_mont(y * z**3 % P), B.to_mont(z)]
        acc = H._jac_add(F, acc, H._from_affine(F, key))
    want_tree = H._to_affine(F, H._jac_mul(F, H._from_affine(F, key), TREE_PTS * (TREE_PTS + 1) // 2))
    io0 = torch.from_numpy(B.ints_to_words_np(vals + jac + [0] * 3 * len(ADD_FORMS) + tree + [0] * 3).reshape(-1))
    want_x, want_s = x0, s0
    for _ in range(ITERS):
        want_x = want_x * y0 * RI % P
        want_s = want_s * want_s * RI % P

    rec, ok = {}, True
    for n, (proc, out, t0, field) in procs.items():
        report, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            print(f"{n}: nvcc failed on the probe\n{report}", flush=True)
            ok = False
            continue
        kern = {"mul": "bls_probe_mul", "sq": "bls_probe_sq", "row": "bls_probe_row", "g1_add": "bls_probe_add1",
                "group4": "bls_probe_addg", "tree": "bls_probe_tree"}
        rep = CS.ptxas_kernels(report, lambda line: next((k for k, e in kern.items() if e in line), None))
        text = sass_text(out)
        if text is not None:  # the whole listing beside the library
            with open(out + ".sass", "w") as f:
                f.write(text)
        census = sass_census(text) or {}
        # the routine a kernel calls from the most sites: fe_mul, fe_sq, and for the row the ladder's
        sass = {k: (v["callees"][0]["instructions"] if v["callees"] else None)
                for k in ("mul", "sq") for name, v in census.items() if f"bls_probe_{k}" in name}
        sass["row_callees"] = next((v["callees"] for name, v in census.items() if "bls_probe_row" in name), None)
        # each add kernel's instructions and its callees' (the add routine, fe_mul, ...)
        sass["adds"] = {f: {"instructions": v["instructions"], "callees": v["callees"]} for f, e in kern.items()
                        for name, v in census.items() if f in ADD_FORMS and e in name}
        lib = ctypes.CDLL(out)
        lib.bls_probe.argtypes, lib.bls_probe.restype = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 2, \
            ctypes.c_int
        io = io0.clone().cuda()
        cyc = torch.zeros((3 + len(ADD_FORMS) + 2,), dtype=torch.int64, device="cuda")
        runs = []
        for _ in range(3):  # the first launch loads the module
            io.copy_(io0.cuda())
            cyc.zero_()
            code = lib.bls_probe(io.data_ptr(), cyc.data_ptr(), ITERS, ADD_ITERS)
            torch.cuda.synchronize()
            if code != 0:
                raise SystemExit(f"{n}: probe launch failed ({code})")
            runs.append(cyc.tolist())
        got = B.words_to_ints(io)
        c = runs[-1]
        adds = {}
        for f, form in enumerate(ADD_FORMS):
            w = io[(14 + 3 * f) * B.NWORDS:(17 + 3 * f) * B.NWORDS].cpu()
            if c[3 + f]:  # a form this tree has
                adds[form] = {"cycles": c[3 + f] / ADD_ITERS, "words": w,
                              "right": B.jac_to_affine_host(w[:12], w[12:24], w[24:]) == want_sum}
        words_agree = all(torch.equal(a["words"], adds["g1_add"]["words"]) for a in adds.values())
        tree_rec = None
        if c[5]:
            o = (20 + 3 * TREE_PTS) * B.NWORDS
            w = io[o:o + 3 * B.NWORDS].cpu()
            levels = TREE_PTS.bit_length() - 1
            tree_rec = {"points": TREE_PTS, "levels": levels, "cycles": c[5], "ns": c[6],
                        "cycles_a_level": c[5] / levels, "mhz": c[5] / c[6] * 1e3 if c[6] else None,
                        "right": B.jac_to_affine_host(w[:12], w[12:24], w[24:]) == want_tree}
        right = (got[7] == 1 and (not field or (got[5] == want_x and got[6] == want_s))
                 and all(a["right"] for a in adds.values()) and words_agree
                 and (tree_rec is None or tree_rec["right"]))
        ok &= right
        mul, sq = (c[0] / ITERS, c[1] / ITERS) if field else (None, None)
        add_cycles = {f: a["cycles"] for f, a in adds.items()}
        rec[n] = {"tree": trees[n], "build_s": secs, "ptxas": rep["kernels"], "any_spill": rep["any_spill"],
                  "sass": sass, "cycles_runs": runs, "mul_cycles": mul, "sq_cycles": sq,
                  "ladder_row_cycles": c[2], "add_cycles": add_cycles, "add_words_agree": words_agree,
                  "bg_tree": tree_rec, "right": right}
        print(f"{n}: built in {secs:.1f} s, ptxas {rec[n]['ptxas']}, spills {rep['any_spill']}; SASS {sass}; "
              f"fe_mul {mul} cycles, fe_sq {sq}, one row's validation {c[2]} cycles; one general add (one warp "
              f"alone) {add_cycles} cycles, every form's words g1_add's {words_agree}; K14's tree in one block "
              f"{tree_rec}; == Python {right}", flush=True)
    print(smi)
    print(json.dumps({"device": smi, "sm_clock_mhz_now_max": clock, "iters": ITERS, "add_iters": ADD_ITERS,
                      "trees": rec}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
