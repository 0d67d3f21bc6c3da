"""Compare the ed25519 kernels K3 (comb table build), K4 (cached verify)
and K5 (uncached Straus verify) of several source trees on one CUDA
card, in one process and in turns.

Each tree's ``cometbft_tpu_torch/csrc/comb.cu`` and ``ed25519.cu`` are
built (all at once).  A tree is a directory (``.`` for this one, an
earlier commit unpacked with ``git archive``), optionally with named
patches applied to a copy of its sources (``PATCHES``: another group
width, launch bound or table chain).  On a 10,000-signature commit
(honest signatures over random 110-byte messages, one message flipped)
every tree must equal the plain versions: K4's bytes at 10,000 and 2,504
lanes (a world-4 rank's share) and the world-1 sharded bitmap; K3's
tables and valid bytes at 10,000 and 128 keys; K5's verdicts at 16,384
lanes (the commit padded as the uncached verifier pads it), 256 and the
sizes between.
Then, by CUDA events and in turns (trees A..Z, then Z..A), with each
tree's libraries loaded in place of this tree's:

  - ``k4``, ``k4_rank``: K4 alone at 10,000 and 2,504 lanes;
  - ``k3``, ``k3_bucket``: K3 alone at 10,000 and 128 keys (a 1% set
    change's churn bucket);
  - ``k5``, ``k5_light``: K5 alone at 16,384 and 256 lanes (the light
    client's trusting check on 150 validators), and at 4,096, 8,192
    and 12,288 lanes, where its group width changes;
  - ``row24``: parallel/verify.sharded_verify_cached at world 1 (NCCL)
    on 10,000 lanes, and ``chain``, the rank's kernels alone (K1 -> K2
    -> K4 through the same wrappers): row24 less chain is the
    collectives and their copies;

each with ``host_ms``, the host's own time a call until it returns.
Prints each tree's kernels' ptxas figures and build seconds, then one
JSON line.  Needs the card and nvcc; from the repo's root:

    python3 scripts/torch_comb_ab.py NAME=DIR[:PATCH[+PATCH...]] ...

e.g. ``parent=out/ab/parent this=. g4=.:k5_g4_only+k3_chain_a``.
"""

from __future__ import annotations

import argparse
import ctypes
import datetime
import hashlib
import json
import os
import shutil
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
OUT = os.path.join(ROOT, "build", "comb_ab")  # the trees' sources (patched) and libraries
SOURCES = ("comb", "ed25519")
V_BUCKET = 128
# K5's shapes: the uncached path's bucket, the light client's, and the sizes
# between them where its group width changes
K5_SHAPES = {"k5": 16_384, "k5_light": 256, "k5_4096": 4_096, "k5_8192": 8_192, "k5_12288": 12_288}

# name -> [(header, the shipped text, its replacement)], applied to a copy of a tree's csrc
PATCHES = {
    # K5 at one group width for every batch size
    "k5_g4_only": [("straus.cuh", "#define STRAUS_G4_MAX_LANES 12288 ", "#define STRAUS_G4_MAX_LANES (1 << 30) ")],
    "k5_g2_only": [("straus.cuh", "#define STRAUS_G4_MAX_LANES 12288 ", "#define STRAUS_G4_MAX_LANES 0 ")],
    # __launch_bounds__ of 8 blocks an SM: <= 128 registers at 4 threads a lane
    "k5_min8": [("straus.cuh", "#define STRAUS_MIN_BLOCKS 6 ", "#define STRAUS_MIN_BLOCKS 8 ")],
    # R decoded by a warp of its own, as K4 does: a block's 16 lanes' R on one
    # extra warp, the group's threads decode A only and meet it at a barrier
    # (launch bounds of 4 blocks an SM, so the larger block keeps its registers)
    "k5_rsplit": [
        ("straus.cuh", "#define STRAUS_MIN_BLOCKS 6 ", "#define STRAUS_MIN_BLOCKS 4 "),
        ("straus.cuh", "  uint32_t dig[16][STRAUS_LANES];                   // kb (words 0-7), s (8-15)\n",
         "  uint32_t dig[16][STRAUS_LANES];                   // kb (words 0-7), s (8-15)\n"
         "  uint8_t r_ok[STRAUS_LANES];\n"),
        ("straus.cuh", """  bool ok[GRP_GL(G)];
  GRP_EACH(G, l) {
    const int odd = GRP_TID(g, l) & 1;
    ge_p3 p;
    ok[l] = ge_from_bytes_zip215(p, odd ? r_enc : a_enc);
    straus_put_point(sm, odd, j, p);
  }
  const bool a_ok = bool_bcast<G>(ok, 0), r_ok = bool_bcast<G>(ok, 1);  // both shuffles on every thread
  const bool pre_ok = s_ok && a_ok && r_ok;
  GRP_SYNC();""", """  ge_p3 pa;
  const bool a_ok = ge_from_bytes_zip215(pa, a_enc);
  straus_put_point(sm, 0, j, pa);
  GRP_SYNC();"""),
        ("straus.cuh", "  straus_get_point(nr, sm, 1, j);\n",
         "  __syncthreads();  // R's warp has decoded the block's R\n"
         "  const bool pre_ok = s_ok && a_ok && sm.r_ok[j];\n"
         "  straus_get_point(nr, sm, 1, j);\n"),
        ("ed25519.cu", "__launch_bounds__(STRAUS_LANES * G, STRAUS_MIN_BLOCKS)",
         "__launch_bounds__(STRAUS_LANES * G + 32, STRAUS_MIN_BLOCKS)"),
        ("ed25519.cu", "  __shared__ StrausShared sm;\n",
         "  __shared__ StrausShared sm;\n"
         "  if (threadIdx.x >= STRAUS_LANES * G) {  // R's warp\n"
         "    const int r = threadIdx.x - STRAUS_LANES * G, lane = blockIdx.x * STRAUS_LANES + r;\n"
         "    if (r < STRAUS_LANES) {\n"
         "      ge_p3 p;\n"
         "      sm.r_ok[r] = ge_from_bytes_zip215(p, r_enc + (size_t)(lane < n ? lane : n - 1) * 32);\n"
         "      straus_put_point(sm, 1, r, p);\n"
         "    }\n"
         "    __syncthreads();\n"
         "    return;\n"
         "  }\n"),
        ("ed25519.cu", "k5_kernel<4><<<blocks, STRAUS_LANES * 4, 0, s>>>",
         "k5_kernel<4><<<blocks, STRAUS_LANES * 4 + 32, 0, s>>>"),
        ("ed25519.cu", "k5_kernel<2><<<blocks, STRAUS_LANES * 2, 0, s>>>",
         "k5_kernel<2><<<blocks, STRAUS_LANES * 2 + 32, 0, s>>>"),
    ],
    "k3_g2": [("comb_build.cuh", "#define COMB_BUILD_G 4 ", "#define COMB_BUILD_G 2 "),
              ("comb_build.cuh", "#define COMB_BUILD_KEYS 8 ", "#define COMB_BUILD_KEYS 16 ")],
    # chain (a), the first design's order: entries 1-7 by seven cached adds of
    # the base b, the next base by doubling 8 b (8 group operations a position)
    "k3_chain_a": [("comb_build.cuh", """    ge_p3 p, t;  // entry e of the position is (e + 1) b
    comb_park<G>(pos, b, live, g);
    grp_dbl<G>(p, b, g);
    comb_park<G>(pos + 1 * COMB_ENTRY_WORDS, p, live, g);
    grp_add_cached<G>(t, p, cb, g);
    comb_park<G>(pos + 2 * COMB_ENTRY_WORDS, t, live, g);
    grp_dbl<G>(p, p, g);
    comb_park<G>(pos + 3 * COMB_ENTRY_WORDS, p, live, g);
    grp_dbl<G>(t, t, g);
    comb_park<G>(pos + 5 * COMB_ENTRY_WORDS, t, live, g);
    grp_add_cached<G>(t, t, cb, g);
    comb_park<G>(pos + 6 * COMB_ENTRY_WORDS, t, live, g);
    grp_add_cached<G>(t, p, cb, g);
    comb_park<G>(pos + 4 * COMB_ENTRY_WORDS, t, live, g);
    grp_dbl<G>(b, p, g);
    comb_park<G>(pos + 7 * COMB_ENTRY_WORDS, b, live, g);
    grp_dbl<G>(b, b, g);  // the next base, 16 b""", """    ge_p3 acc = b;
    comb_park<G>(pos, acc, live, g);
    NOUNROLL
    for (int e = 1; e < COMB_NENT_A; e++) {
      grp_add_cached<G>(acc, acc, cb, g);
      comb_park<G>(pos + e * COMB_ENTRY_WORDS, acc, live, g);
    }
    grp_dbl<G>(b, acc, g);""")],
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


def commit(dev):
    """(tables, valid, pubs, payload, items) of CS.V_MAIN honest
    signatures, row CS.I_FLIP's message flipped after signing."""
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
    tables, valid = comb.build_a_tables_plain(pubs)
    payload = torch.from_numpy(cv.assemble_payload(items, np.arange(CS.V_MAIN), CS.V_MAIN)).to(dev)
    return tables, valid, pubs, payload, items


def uncached_inputs(items, n, dev):
    """K5's (A, R, s, digest) for the first n items, repeated to n lanes
    as the uncached verifier pads a bucket (row 0 again)."""
    rows = [items[i] if i < len(items) else items[0] for i in range(n)]
    cols = [[p for p, _, _ in rows], [s[:32] for _, _, s in rows], [s[32:] for _, _, s in rows],
            [hashlib.sha512(s[:32] + p + m).digest() for p, m, s in rows]]
    return [torch.from_numpy(np.stack([np.frombuffer(x, np.uint8) for x in c])).to(dev) for c in cols]


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


def takes_scratch(csrc: str) -> bool:
    """Whether the tree's K3 entry takes the first design's V x 512 x 8
    scratch argument."""
    with open(os.path.join(csrc, "comb.cu")) as f:
        text = f.read()
    head = text[text.index('extern "C" int k3_build_a_tables'):]
    return "scratch" in head[: head.index(")")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="NAME=DIR[:PATCH+...]: a source tree whose kernels are built")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_comb_ab: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from cometbft_tpu_torch import _build
    from cometbft_tpu_torch import parallel as P
    from cometbft_tpu_torch.ops import comb, sha2
    from cometbft_tpu_torch.ops import ed25519 as E
    from cometbft_tpu_torch.parallel import verify as PV

    smi = CS.smi_line()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    trees = dict(t.split("=", 1) for t in args.trees)
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")
    csrcs = {n: prepare(n, spec) for n, spec in trees.items()}
    procs = {(n, src): start_build(n, csrcs[n], src) for n in trees for src in SOURCES}
    t0 = time.perf_counter()
    tables, valid, pubs, payload, items = commit(dev)  # signs while the trees build
    print(f"inputs: {CS.V_MAIN} lanes in {time.perf_counter() - t0:.1f} s", flush=True)
    libs, rec = {n: {} for n in trees}, {n: {"tree": trees[n]} for n in trees}
    kernels = {"comb": {"k4": "k4_kernel", "k3": "k3_kernel"},
               "ed25519": {"k5_g4": "k5_kernelILi4E", "k5_g2": "k5_kernelILi2E", "k5": "k5_kernelP"}}
    for (n, src), (proc, out, t_start) in procs.items():
        report, _ = proc.communicate()
        secs = time.perf_counter() - t_start
        if proc.returncode != 0:
            print(f"{n}: nvcc failed on {src}.cu\n{report}", flush=True)
            return 1
        lib = ctypes.CDLL(out)
        for fn, argtypes in _build.SIGNATURES[src].items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
        if src == "comb" and takes_scratch(csrcs[n]):
            lib.k3_build_a_tables.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        libs[n][src] = lib
        ks = kernels[src]
        ptx = CS.ptxas_kernels(report, lambda line: next((k for k, e in ks.items() if e in line), None))["kernels"]
        rec[n].update({f"{k}_ptxas": v for k, v in ptx.items()}, **{f"{src}_build_s": secs})
        print(f"{n}: {src}.cu built in {secs:.1f} s; {ptx}", flush=True)

    def use(n):  # the wrappers now call tree n's kernels
        for src in SOURCES:
            _build._LIBS[src] = libs[n][src]

    scratch = {}

    def k3_into(n, pk, tab, val):
        if not takes_scratch(csrcs[n]):
            return comb.launch_k3(pk, tab, val)
        V = pk.shape[0]
        if V not in scratch:
            scratch[V] = torch.empty((V, 512, 8), dtype=torch.int32, device=dev)
        _build.check(libs[n]["comb"].k3_build_a_tables(pk.data_ptr(), tab.data_ptr(), val.data_ptr(),
                                                       scratch[V].data_ptr(), V,
                                                       torch.cuda.current_stream().cuda_stream), "k3")

    b_tab = comb.b_tables(dev)
    _, _, blocks, active, _ = sha2.parse_verify_payload(payload, pubs)
    digest = sha2.sha512_blocks(blocks, active)
    k4_shapes = {"k4": CS.V_MAIN, "k4_rank": CS.V_RANK}
    want = {s: comb.pack_verdicts(comb.verify_cached_plain(tables[:V], valid[:V], payload[:V], digest[:V], b_tab),
                                  payload[:V, 67] == 1) for s, V in k4_shapes.items()}
    outs = {s: torch.empty((V + 7) // 8 + 1, dtype=torch.uint8, device=dev) for s, V in k4_shapes.items()}
    cnt = torch.empty(2, dtype=torch.int32, device=dev)
    valid_u8 = valid.to(torch.uint8)
    k3_shapes = {"k3": CS.V_MAIN, "k3_bucket": V_BUCKET}
    k3_out = {s: (torch.empty((V, 64, 8, 3, 8), dtype=torch.int32, device=dev),
                  torch.empty((V,), dtype=torch.uint8, device=dev)) for s, V in k3_shapes.items()}
    k5_shapes = K5_SHAPES
    k5_in = {s: uncached_inputs(items, n, dev) for s, n in k5_shapes.items()}
    k5_want = {s: E.verify_digest_plain(*k5_in[s]).to(torch.uint8) for s in k5_shapes}
    k5_out = {s: torch.empty((n,), dtype=torch.uint8, device=dev) for s, n in k5_shapes.items()}
    bwin = E.b_window(dev)

    def k4(s):
        V = k4_shapes[s]
        return lambda: comb.launch_k4(tables[:V], valid_u8[:V], payload[:V], digest[:V], b_tab, cnt, outs[s])

    def chain():
        _, _, blk, act, _ = sha2.parse_verify_payload(payload, pubs)
        return comb.verify_cached(tables, valid, payload, sha2.sha512_blocks(blk, act), b_tab)

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{CS._free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = P.make_mesh(device=dev)
        ok = True
        for n in libs:
            use(n)
            eq = {}
            for s in k4_shapes:
                outs[s].fill_(0xAA)
                k4(s)()
                eq[s] = bool(torch.equal(outs[s], want[s]))
            for s, V in k3_shapes.items():
                k3_out[s][0].fill_(-0x55555556)
                k3_out[s][1].fill_(0xAA)
                k3_into(n, pubs[:V], *k3_out[s])
                eq[s] = bool(torch.equal(k3_out[s][0], tables[:V]) and torch.equal(k3_out[s][1], valid_u8[:V]))
            for s in k5_shapes:
                k5_out[s].fill_(0xAA)
                E.launch_k5(*k5_in[s], bwin, k5_out[s])
                eq[s] = bool(torch.equal(k5_out[s], k5_want[s]))
            eq["chain"] = bool(torch.equal(chain(), want["k4"]))
            eq["row24"] = bool(torch.equal(PV.sharded_verify_cached(mesh, tables, valid, pubs, payload, b_tab),
                                           want["k4"]))
            rec[n]["equal_plain"] = eq
            ok &= all(eq.values())
            print(f"{n}: == plain {eq}", flush=True)

        def fns(n):
            out = {s: k4(s) for s in k4_shapes}
            out.update({s: (lambda s=s, V=V: k3_into(n, pubs[:V], *k3_out[s])) for s, V in k3_shapes.items()})
            out.update({s: (lambda s=s: E.launch_k5(*k5_in[s], bwin, k5_out[s])) for s in k5_shapes})
            out["chain"] = chain
            out["row24"] = lambda: PV.sharded_verify_cached(mesh, tables, valid, pubs, payload, b_tab)
            return out

        names = list(fns(next(iter(libs))))
        order = list(libs) + list(reversed(libs))
        for f in names:
            for n in order:
                use(n)
                ms, host = timed(fns(n)[f])
                rec[n].setdefault(f, {"ms": [], "host_ms": []})
                rec[n][f]["ms"].append(ms)
                rec[n][f]["host_ms"].append(host)
    finally:
        dist.destroy_process_group()
    for n in libs:
        print(f"{n}: " + "; ".join(f"{f} {rec[n][f]['ms']} ms (host {rec[n][f]['host_ms']})" for f in names),
              flush=True)
    print(smi)
    print(json.dumps({"device": smi, "iters": ITERS, "warmup": WARMUP,
                      "shapes": {**k4_shapes, **k3_shapes, **k5_shapes}, "trees": rec}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
