"""Compare the host-bound comb path of several source trees on one CUDA
card, in turns: chip_smoke.py phase 4's ``verify_commit`` and phase
24(a)'s cost of the verify service, at 10,000 validators with the
tables warm.

A tree is a directory holding a ``cometbft_tpu_torch`` package (``.``
for this one, an earlier commit unpacked with ``git archive``).  Two
trees' packages cannot share a process, so each reading is a process of
its own (``--worker DIR``), started in turns: A, B, B, A, A, B, ...
(``--rounds`` passes over the trees, every second one reversed).  A
worker imports only its tree's package and measures, on the same seeded
inputs:

  - ``verify_commit_ms``: types/validation.verify_commit of the signed
    10,000-row commit, VERIFY_CALLS calls after 2, host clock (phase 4);
  - ``service_ms`` / ``direct_ms``: 10,000 ``add()`` + ``verify()``
    through crypto/batch.create_batch_verifier (the service's client)
    and through CombBatchVerifier(entry), in turns, p50 after 2 of
    SERVICE_CALLS (phase 24(a)); ``service_cost_ms`` is their difference,
    and ``split`` the verifiers' ``last_timings`` p50.

The first worker writes the seeded keys' public keys, and the commit's
signatures and timestamps by validator position, to ``--inputs``;
later workers read them (no host signing).  A tree's kernels are built by its first worker; a
library already built by another tree from the same sources (the same
``lib<name>-<hash>.so``) is copied over first.  Prints the card's name
and power limit, each reading, and one JSON line of every reading and
each tree's median.  Needs the card and nvcc; from the repo's root:

    python3 scripts/torch_service_ab.py NAME=DIR ... [--rounds 4]

e.g. ``parent=out/ab18/parent this=.``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261018
V = 10_000  # validators (chip_smoke.py's V_MAIN)
CHAIN_ID = "cometbft-tpu-torch-smoke"
HEIGHT = 1_000_000
TS_SECONDS = 1_700_000_000
VERIFY_CALLS = 20  # phase 4's verify_commit readings, after 2 warm calls
SERVICE_CALLS = 12  # phase 24(a)'s rounds in turns; the first 2 are dropped


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_inputs(T, host, PRECOMMIT_TYPE, Timestamp) -> dict:
    """The seeded set and one commit signed by all of it (host ed25519)."""
    rng = np.random.default_rng(SEED)
    keys = [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(V)]
    vals = T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in keys])
    by_addr = {k.pub_key().address(): k for k in keys}
    bid_hash, psh_hash = rng.bytes(32), rng.bytes(32)
    bid = T.BlockID(hash=bid_hash, part_set_header=T.PartSetHeader(total=3, hash=psh_hash))
    nanos = rng.integers(0, 1_000_000_000, size=V).tolist()
    sigs = []
    for i, v in enumerate(vals.validators):
        vote = T.Vote(type=PRECOMMIT_TYPE, height=HEIGHT, round=0, block_id=bid,
                      timestamp=Timestamp(seconds=TS_SECONDS, nanos=nanos[i]),
                      validator_address=v.address, validator_index=i)
        sigs.append(by_addr[v.address].sign(vote.sign_bytes(CHAIN_ID)))
    return {"pubs": [k.pub_key().data for k in keys], "bid": (bid_hash, psh_hash), "nanos": nanos, "sigs": sigs}


def worker(tree: str, inputs_path: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import cometbft_tpu_torch
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.models import comb_verifier as cv
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE, Timestamp

    if not os.path.abspath(cometbft_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {cometbft_tpu_torch.__file__}, not the tree {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    if os.path.exists(inputs_path):
        with open(inputs_path, "rb") as f:
            inp = pickle.load(f)
    else:
        inp = make_inputs(T, host, PRECOMMIT_TYPE, Timestamp)
        with open(inputs_path, "wb") as f:
            pickle.dump(inp, f)
    # the same keys in the same order make the same set: nanos and sigs
    # are by validator position
    vals = T.ValidatorSet([T.Validator(host.PubKey(p), 10) for p in inp["pubs"]])
    bid = T.BlockID(hash=inp["bid"][0], part_set_header=T.PartSetHeader(total=3, hash=inp["bid"][1]))
    commit_sigs = []
    for i, v in enumerate(vals.validators):
        vote = T.Vote(type=PRECOMMIT_TYPE, height=HEIGHT, round=0, block_id=bid,
                      timestamp=Timestamp(seconds=TS_SECONDS, nanos=inp["nanos"][i]),
                      validator_address=v.address, validator_index=i)
        vote.signature = inp["sigs"][i]
        commit_sigs.append(vote.to_commit_sig())
    good = T.Commit(height=HEIGHT, round=0, block_id=bid, signatures=commit_sigs)
    sb = good.vote_sign_bytes_fn(CHAIN_ID)
    items = [(v.pub_key.bytes(), sb(i), good.signatures[i].signature) for i, v in enumerate(vals.validators)]
    pubkeys = vals.pub_keys_bytes()

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cache = cv.ValsetCombCache()
    entry = cache.ensure(pubkeys, device=dev)
    setup_s = time.perf_counter() - t0
    kw = dict(device=dev, comb_cache=cache)

    walls = []
    for _ in range(VERIFY_CALLS + 2):
        t0 = time.perf_counter()
        validation.verify_commit(CHAIN_ID, vals, bid, HEIGHT, good, **kw)
        walls.append((time.perf_counter() - t0) * 1e3)
    walls = walls[2:]

    split = {"service": [], "direct": []}
    turns = {"service": [], "direct": []}
    makers = {"service": lambda: cbatch.create_batch_verifier("ed25519", pubkeys, **kw),
              "direct": lambda: cv.CombBatchVerifier(entry)}
    for i in range(SERVICE_CALLS):
        for route in (list(makers) if i % 2 == 0 else list(reversed(makers))):
            t0 = time.perf_counter()
            bv = makers[route]()
            for it in items:
                bv.add(*it)
            ok, _ = bv.verify()
            torch.cuda.synchronize()
            turns[route].append((time.perf_counter() - t0) * 1e3)
            if not ok:
                raise RuntimeError(f"the good commit failed ({route})")
            split[route].append(dict(bv.last_timings))
    p50 = {r: float(np.median(w[2:])) for r, w in turns.items()}
    split = {r: {k: float(np.median([p[k] for p in v[2:] if k in p])) for k in v[-1]} for r, v in split.items()}
    from cometbft_tpu_torch.verifysvc import service as S

    S.reset_global_service()
    return {"verify_commit_ms": float(np.median(walls)), "verify_commit_walls_ms": walls,
            "service_ms": p50["service"], "direct_ms": p50["direct"],
            "service_cost_ms": p50["service"] - p50["direct"], "split": split, "setup_s": setup_s}


def share_builds(trees: dict) -> None:
    """Copy every built library of one tree to the others that lack it:
    the file name carries the hash of the sources it was built from."""
    for sub in ("cuda", "host"):
        built = {}
        for d in trees.values():
            src = os.path.join(d, "build", sub)
            if os.path.isdir(src):
                for fn in os.listdir(src):
                    if fn.endswith(".so"):
                        built.setdefault(fn, os.path.join(src, fn))
        for d in trees.values():
            dst = os.path.join(d, "build", sub)
            os.makedirs(dst, exist_ok=True)
            for fn, path in built.items():
                if not os.path.exists(os.path.join(dst, fn)):
                    shutil.copy2(path, os.path.join(dst, fn))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--inputs", default=os.path.join(ROOT, "build", "service_ab_inputs.pkl"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.inputs)))
        return 0
    trees = dict(t.split("=", 1) for t in args.trees)
    if len(trees) < 1:
        ap.error("name at least one tree")
    trees = {k: os.path.abspath(v) for k, v in trees.items()}
    os.makedirs(os.path.dirname(args.inputs), exist_ok=True)
    smi = smi_line()
    print(f"card: {smi}", flush=True)
    order = []
    for r in range(args.rounds):
        order += list(trees) if r % 2 == 0 else list(reversed(trees))
    readings = {k: [] for k in trees}
    for name in order:
        share_builds(trees)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", trees[name],
                              "--inputs", args.inputs], capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], sep="\n", file=sys.stderr)
            raise RuntimeError(f"the worker of {name} exited {out.returncode}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["process_s"] = time.perf_counter() - t0
        readings[name].append(rec)
        print(f"{name}: verify_commit p50 {rec['verify_commit_ms']:.2f} ms; service {rec['service_ms']:.2f} ms, "
              f"direct {rec['direct_ms']:.2f} ms, cost {rec['service_cost_ms']:.2f} ms a commit; "
              f"{rec['process_s']:.1f} s", flush=True)
    median = {k: {m: float(np.median([r[m] for r in v]))
                  for m in ("verify_commit_ms", "service_ms", "direct_ms", "service_cost_ms")}
              for k, v in readings.items()}
    print(json.dumps({"card": smi, "order": order, "median": median, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
