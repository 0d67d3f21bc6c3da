"""Time the BLS aggregate commit of several source trees on one CUDA card,
in turns: chip_smoke.py phase 17's warm call, end to end.

Each tree runs in a process of its own, trees A..Z and then Z..A (a
tree's first process builds its kernels and host pairing core under the
tree's own build/).  A process imports the tree's ``cometbft_tpu_torch``
and drives phase 17's commit through ``crypto/batch.create_batch_verifier``
on the card: 10,000 keys (secrets a + i b from the seed), one message,
their aggregate signature; one cold call (K15 and K14's finishing
stage), then ``BLS_WARM_CALLS`` warm ones (K14), each through a new
verifier and each required to pass every row.  It reports the wall p50
of the warm calls after the first two and the medians of their
``last_timings``.  Prints a line a process, the card's name and power
limit, then one JSON line.  Needs the card; from the repo's root:

    python3 scripts/torch_bls_warm_ab.py NAME=DIR ...

e.g. ``parent=out/ab/parent this=.`` (the parent from ``git archive``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261017


def smoke():
    """This tree's chip_smoke.py (its key builder and sizes), whichever
    tree's package is first on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto import bls12381 as H
    from cometbft_tpu_torch.models import bls_verifier as M
    from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE, Timestamp

    CS = smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    a, b = (int.from_bytes(rng.bytes(32), "big") % H.R for _ in range(2))
    pubs = [H._g1_compress(p) for p in CS.bls_keys(H, a, b, CS.N_BLS)]
    bid = T.BlockID(hash=rng.bytes(32), part_set_header=T.PartSetHeader(total=1, hash=rng.bytes(32)))
    msg = T.Vote(type=PRECOMMIT_TYPE, height=77, round=0, block_id=bid,
                 timestamp=Timestamp(seconds=CS.TS_SECONDS)).sign_bytes(CS.CHAIN_ID)
    sk_sum = (a * CS.N_BLS + b * CS.N_BLS * (CS.N_BLS - 1) // 2) % H.R
    agg = H._g2_compress(CS.bls_g2_mul(H, H.hash_to_g2(msg), sk_sum))
    items = [(p, msg, agg) for p in pubs]

    M.reset_caches()
    calls = []
    for _ in range(1 + CS.BLS_WARM_CALLS):
        bv = cbatch.create_batch_verifier("bls12_381", pubkeys=pubs, device=dev)
        for it in items:
            bv.add(*it)
        t0 = time.perf_counter()
        ok, res = bv.verify()
        calls.append(((time.perf_counter() - t0) * 1e3, dict(bv.last_timings)))
        if not ok or not all(res):
            print(json.dumps({"error": "a row failed"}))
            return 1
    warm = calls[3:]  # the cold call, then two warm-up calls
    print(json.dumps({"cold_ms": calls[0][0], "cold": calls[0][1],
                      "warm_p50_ms": float(np.median([w for w, _ in warm])),
                      "warm_ms": [w for w, _ in warm],
                      "warm": {k: float(np.median([t[k] for _, t in warm])) for k in warm[0][1]}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="NAME=DIR: a source tree whose package is driven")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    import torch

    if not torch.cuda.is_available():
        print("torch_bls_warm_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = smoke().smi_line()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    trees = dict(t.split("=", 1) for t in args.trees)
    order = list(trees) + list(reversed(trees))
    rec, ok = {n: {"tree": d, "runs": []} for n, d in trees.items()}, True
    for n in order:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", trees[n]],
                             capture_output=True, text=True)
        lines = run.stdout.strip().splitlines()
        if run.returncode != 0 or not lines:
            print(f"{n}: process failed ({run.returncode})\n{run.stdout[-4000:]}\n{run.stderr[-4000:]}", flush=True)
            ok = False
            continue
        got = json.loads(lines[-1])
        got["process_s"] = time.perf_counter() - t0
        rec[n]["runs"].append(got)
        print(f"{n}: warm p50 {got['warm_p50_ms']:.2f} ms {json.dumps({k: round(v, 2) for k, v in got['warm'].items()})};"
              f" cold {got['cold_ms']:.1f} ms; process {got['process_s']:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"device": smi, "trees": rec}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
