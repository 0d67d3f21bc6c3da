"""Compare the K4 (cached ed25519 verify) of several source trees on one
CUDA card, in one process and in turns.

Each tree's ``cometbft_tpu_torch/csrc/comb.cu`` is built (all at once);
a variant of the kernel is a copy of a tree with its source edited, an
earlier commit one unpacked with ``git archive``.  On a 10,000-signature
commit (honest signatures over random 110-byte messages, one message
flipped) every tree's K4 bytes must equal
pack_verdicts(verify_cached_plain) at 10,000 lanes and at 2,504 (a
world-4 rank's share), and so must the world-1 sharded bitmap.  Then,
by CUDA events and in turns (trees A..Z, then Z..A), with each tree's
K4 loaded in place of this tree's:

  - ``k4``, ``k4_rank``: K4 alone at 10,000 and 2,504 lanes;
  - ``row24``: parallel/verify.sharded_verify_cached at world 1 (NCCL)
    on 10,000 lanes;
  - ``chain``: the rank's kernels alone (K1 -> K2 -> K4 through the
    same wrappers): row24 less chain is the collectives and their
    copies;

each with ``host_ms``, the host's own time a call until it returns (the
stream waits on the host where that is near the events' time).  Prints each
tree's k4_kernel ptxas figures and build seconds, then one JSON line.
Needs the card and nvcc; from the repo's root:

    python3 scripts/torch_comb_ab.py NAME=DIR [NAME=DIR ...]

where DIR is a source tree's root (this one's is ``.``).
"""

from __future__ import annotations

import argparse
import ctypes
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402  (its ptxas parser, port picker and shapes)

SEED = 20261017
ITERS, WARMUP = 20, 3  # timed calls after warm-up calls, for each tree and turn
OUT = os.path.join(ROOT, "build", "comb_ab")  # the trees' libraries


def start_build(name: str, tree: str):
    from cometbft_tpu_torch import _build

    out = os.path.join(OUT, f"libcomb_{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(tree, "cometbft_tpu_torch", "csrc", "comb.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out, time.perf_counter()


def commit(dev):
    """(tables, valid, pubs, payload) of CS.V_MAIN honest signatures, row
    CS.I_FLIP's message flipped after signing."""
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.ops import comb

    rng = np.random.default_rng(SEED)
    items = []
    for i in range(CS.V_MAIN):
        key, msg = host.PrivKey.from_seed(rng.bytes(32)), rng.bytes(110)
        sig = key.sign(msg)
        if i == CS.I_FLIP:
            msg = msg[:-1] + bytes([msg[-1] ^ 1])
        items.append((key.pub_key().data, msg, sig))
    pubs = torch.from_numpy(np.stack([np.frombuffer(p, np.uint8) for p, _, _ in items])).to(dev)
    tables, valid = comb.build_a_tables(pubs)
    payload = torch.from_numpy(cv.assemble_payload(items, np.arange(CS.V_MAIN), CS.V_MAIN)).to(dev)
    return tables, valid, pubs, payload


def timed(fn) -> tuple[float, float]:
    """(ms by CUDA events, ms on the host's clock until the calls return) a call."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / ITERS
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS, host


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="NAME=DIR: a source tree whose comb.cu is built")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_comb_ab: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch import parallel as P
    from cometbft_tpu_torch.ops import comb, sha2
    from cometbft_tpu_torch.parallel import verify as PV

    smi = CS.smi_line()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    trees = dict(t.split("=", 1) for t in args.trees)
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")
    procs = {n: start_build(n, d) for n, d in trees.items()}
    t0 = time.perf_counter()
    tables, valid, pubs, payload = commit(dev)  # signs while the trees build
    print(f"inputs: {CS.V_MAIN} lanes in {time.perf_counter() - t0:.1f} s", flush=True)
    libs, rec = {}, {}
    for n, (proc, out, t_start) in procs.items():
        report, _ = proc.communicate()
        secs = time.perf_counter() - t_start
        if proc.returncode != 0:
            print(f"{n}: nvcc failed\n{report}", flush=True)
            return 1
        lib = ctypes.CDLL(out)
        for fn, argtypes in _build.SIGNATURES["comb"].items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
        libs[n] = lib
        ptx = CS.ptxas_kernels(report, lambda line: "k4" if "k4_kernel" in line else None)["kernels"]["k4"]
        rec[n] = {"tree": trees[n], "build_s": secs, **ptx}
        print(f"{n}: built in {secs:.1f} s; {rec[n]}", flush=True)

    def use(n):  # comb.verify_cached / launch_k4 now call tree n's K4
        _build._LIBS["comb"] = libs[n]

    b_tab = comb.b_tables(dev)
    _, _, blocks, active, _ = sha2.parse_verify_payload(payload, pubs)
    digest = sha2.sha512_blocks(blocks, active)
    shapes = {"k4": CS.V_MAIN, "k4_rank": CS.V_RANK}
    want = {s: comb.pack_verdicts(comb.verify_cached_plain(tables[:V], valid[:V], payload[:V], digest[:V], b_tab),
                                  payload[:V, 67] == 1) for s, V in shapes.items()}
    outs = {s: torch.empty((V + 7) // 8 + 1, dtype=torch.uint8, device=dev) for s, V in shapes.items()}
    cnt = torch.empty(2, dtype=torch.int32, device=dev)
    valid_u8 = valid.to(torch.uint8)

    def k4(s):
        V = shapes[s]
        return lambda: comb.launch_k4(tables[:V], valid_u8[:V], payload[:V], digest[:V], b_tab, cnt, outs[s])

    def chain():
        _, _, blk, act, _ = sha2.parse_verify_payload(payload, pubs)
        return comb.verify_cached(tables, valid, payload, sha2.sha512_blocks(blk, act), b_tab)

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{CS._free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = P.make_mesh(device=dev)
        fns = {**{s: k4(s) for s in shapes}, "chain": chain,
               "row24": lambda: PV.sharded_verify_cached(mesh, tables, valid, pubs, payload, b_tab)}
        ok = True
        for n in libs:
            use(n)
            eq = {}
            for s in shapes:
                outs[s].fill_(0xAA)
                fns[s]()
                eq[s] = bool(torch.equal(outs[s], want[s]))
            eq["chain"] = bool(torch.equal(chain(), want["k4"]))
            eq["row24"] = bool(torch.equal(fns["row24"](), want["k4"]))
            rec[n]["equal_plain"] = eq
            ok &= all(eq.values())
            print(f"{n}: == plain {eq}", flush=True)
        order = list(libs) + list(reversed(libs))
        for f, fn in fns.items():
            for n in order:
                use(n)
                ms, host = timed(fn)
                rec[n].setdefault(f, {"ms": [], "host_ms": []})
                rec[n][f]["ms"].append(ms)
                rec[n][f]["host_ms"].append(host)
    finally:
        dist.destroy_process_group()
    for n in libs:
        print(f"{n}: " + "; ".join(f"{f} {rec[n][f]['ms']} ms (host {rec[n][f]['host_ms']})" for f in fns), flush=True)
    print(smi)
    print(json.dumps({"device": smi, "iters": ITERS, "warmup": WARMUP, "lanes": shapes, "trees": rec}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
