"""Latency of the BLS12-381 field multiply, the square and one row's
ladder of several source trees' ``csrc/bls381.cuh``, on one CUDA card.

For each tree a probe library whose kernels include the tree's header
is built with the port's nvcc flags (all trees at once).  One thread of
one block then runs ITERS dependent multiplies (x = x y R^-1), ITERS
dependent squares (s = s^2 R^-1) and ``bls_validate_row`` on one key,
each in a kernel of its own and timed by ``clock64`` (SM cycles) around
it: the cycles of one row's dependent chain, what bounds K13 and K15 at
a few warps an SM.  A header whose fe_mul takes word pointers (no fe
values, no fe_sq) gets the row's kernel only.  The results must equal
Python integers' (the row must validate).
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

extern "C" int bls_probe(void* io, void* cyc, int iters) {
%s  bls_probe_row<<<1, 1>>>((u32*)io, (long long*)cyc);
  return (int)cudaGetLastError();
}
"""
LAUNCH_FIELD = """  bls_probe_mul<<<1, 1>>>((u32*)io, (long long*)cyc, iters);
  bls_probe_sq<<<1, 1>>>((u32*)io, (long long*)cyc, iters);
"""


def probe_source(header: str) -> tuple[str, bool]:
    """The probe's source for a header, and whether it probes fe_mul and
    fe_sq (the header passes fe values to both)."""
    field = bool(re.search(r"\bfe\s+fe_mul\s*\(", header) and re.search(r"\bfe\s+fe_sq\s*\(", header))
    return (PROBE % (FIELD, LAUNCH_FIELD) if field else PROBE % ("", "")), field


def start_build(name: str, tree: str):
    from cometbft_tpu_torch import _build

    csrc = os.path.join(tree, "cometbft_tpu_torch", "csrc")
    with open(os.path.join(csrc, "bls381.cuh")) as f:
        header = f.read()
    src = os.path.join(OUT, f"probe_{name}.cu")
    text, field = probe_source(header)
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
    io0 = torch.from_numpy(B.ints_to_words_np(vals).reshape(-1))
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
        rep = CS.ptxas_kernels(report, lambda line: next((k for k in ("mul", "sq", "row") if f"bls_probe_{k}" in line),
                                                         None))
        text = sass_text(out)
        if text is not None:  # the whole listing beside the library
            with open(out + ".sass", "w") as f:
                f.write(text)
        census = sass_census(text) or {}
        # the routine a kernel calls from the most sites: fe_mul, fe_sq, and for the row the ladder's
        sass = {k: (v["callees"][0]["instructions"] if v["callees"] else None)
                for k in ("mul", "sq") for name, v in census.items() if f"bls_probe_{k}" in name}
        sass["row_callees"] = next((v["callees"] for name, v in census.items() if "bls_probe_row" in name), None)
        lib = ctypes.CDLL(out)
        lib.bls_probe.argtypes, lib.bls_probe.restype = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int], ctypes.c_int
        io = io0.clone().cuda()
        cyc = torch.zeros((3,), dtype=torch.int64, device="cuda")
        runs = []
        for _ in range(3):  # the first launch loads the module
            io.copy_(io0.cuda())
            code = lib.bls_probe(io.data_ptr(), cyc.data_ptr(), ITERS)
            torch.cuda.synchronize()
            if code != 0:
                raise SystemExit(f"{n}: probe launch failed ({code})")
            runs.append(cyc.tolist())
        got = B.words_to_ints(io)
        right = got[7] == 1 and (not field or (got[5] == want_x and got[6] == want_s))
        ok &= right
        c = runs[-1]
        mul, sq = (c[0] / ITERS, c[1] / ITERS) if field else (None, None)
        rec[n] = {"tree": trees[n], "build_s": secs, "ptxas": rep["kernels"], "any_spill": rep["any_spill"],
                  "sass": sass, "cycles_runs": runs, "mul_cycles": mul, "sq_cycles": sq,
                  "ladder_row_cycles": c[2], "right": right}
        print(f"{n}: built in {secs:.1f} s, ptxas {rec[n]['ptxas']}, spills {rep['any_spill']}; SASS {sass}; "
              f"fe_mul {mul} cycles, fe_sq {sq}, one row's validation {c[2]} cycles; == Python {right}", flush=True)
    print(smi)
    print(json.dumps({"device": smi, "sm_clock_mhz_now_max": clock, "iters": ITERS, "trees": rec}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
