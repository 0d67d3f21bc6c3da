"""K5's group algorithm (csrc/straus.cuh on csrc/ge25519_group.cuh)
built for the host: g++ compiles the headers, whose exchange helper then
runs the G threads of a lane's group (4 and 2, the two widths K5
launches) one after another (each thread's products of a phase, the
shuffles as reads of the other threads' slots), and k5_host runs a
whole launch lane by lane.  The
verdict bytes are held against the port's plain K5
(ops/ed25519.verify_digest_plain), the JAX package's host oracle
(cometbft_tpu/crypto/_ref25519.py), the corpus's own verdicts
(tests/torch_group_corpus.py: s = 0, s >= L, undecodable R and A,
non-canonical y, small-order A and R, k with zero windows, failing lanes
at warp and block edges) and, in the slow tier, the JAX package's jitted
verify_prepared.  Each group operation is also held against its
one-thread form (csrc/ge25519.cuh) and the host bigint group law, and
copies of the headers with one fault planted (an operand's routing, the
exchange, a thread's share, a negated entry's coordinates) must fail.
Skips only where no host C++ compiler exists.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ref25519 as jref
from cometbft_tpu_torch.ops import ed25519 as E
import torch_group_corpus as C

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"
SEED = 10
SIZES = [1, 3, 7, 8, 9, 31, 33, 255, 256, 257]

HARNESS = r"""
#include "straus.cuh"

static void h_point(ge_p3& p, const uint32_t* w) {
  fe_from_words(p.X, w);
  fe_from_words(p.Y, w + 8);
  fe_from_words(p.Z, w + 16);
  fe_from_words(p.T, w + 24);
}

static void h_words(uint32_t* w, const ge_p3& p) {
  fe_to_words(w, p.X);
  fe_to_words(w + 8, p.Y);
  fe_to_words(w + 16, p.Z);
  fe_to_words(w + 24, p.T);
}

// For n pairs (p, q) of extended points (32 words each): the group's
// doubling of p, ge_dbl's, the group's cached add p + q, ge_add's.
template <int G>
static void h_ops_g(const uint32_t* ps, const uint32_t* qs, uint32_t* out, int n) {
  grp_t g;
  for (int i = 0; i < n; i++) {
    ge_p3 p, q, r;
    h_point(p, ps + 32 * i);
    h_point(q, qs + 32 * i);
    uint32_t* o = out + 128 * i;
    grp_dbl<G>(r, p, g);
    h_words(o, r);
    ge_dbl(r, p);
    h_words(o + 32, r);
    grp_slots<G> c;
    grp_to_cached<G>(c, q, g);
    grp_add_cached<G>(r, p, c, g);
    h_words(o + 64, r);
    ge_add(r, p, q);
    h_words(o + 96, r);
  }
}

extern "C" {
int h_lanes(void) { return STRAUS_LANES; }
int h_g4_max_lanes(void) { return STRAUS_G4_MAX_LANES; }

void h_k5(const uint8_t* a, const uint8_t* r, const uint8_t* s, const uint8_t* d, const uint32_t* bwin,
          uint8_t* out, int n, int G) {
  if (G == 2) {
    k5_host<2>(a, r, s, d, bwin, out, n);
  } else {
    k5_host<4>(a, r, s, d, bwin, out, n);
  }
}

void h_ops(const uint32_t* ps, const uint32_t* qs, uint32_t* out, int n, int G) {
  if (G == 2) {
    h_ops_g<2>(ps, qs, out, n);
  } else {
    h_ops_g<4>(ps, qs, out, n);
  }
}
}
"""

# name -> (header, the text of the shipped header, the fault put in its place)
MUTATIONS = {
    "operand_routing": ("ge25519_group.cuh", "fe_sel4(a, s * G + GRP_TID(g, l), ypx, ymx, zz, p.T);",
                        "fe_sel4(a, s * G + GRP_TID(g, l), ymx, ypx, zz, p.T);"),
    "exchange": ("ge25519_group.cuh", "q[j] = m.v[j % G][j / G];", "q[j] = m.v[(j + 1) % G][j / G];"),
    "thread_share": ("ge25519_group.cuh", "      const int j = s * G + GRP_TID(g, l);\n      fe a, b;",
                     "      const int j = s * G;\n      fe a, b;"),
    "negated_entry": ("straus.cuh", "const int src = neg && jj < 2 ? 1 - jj : jj;", "const int src = jj;"),
}


def _build(csrc: pathlib.Path, tmp: pathlib.Path) -> ctypes.CDLL:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/straus.cuh with")
    src, out = tmp / "harness.cpp", tmp / "libk5.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(csrc), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    h.h_k5.argtypes = [P_] * 6 + [I_, I_]
    h.h_ops.argtypes = [P_, P_, P_, I_, I_]
    return h


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("k5"))


@pytest.fixture(scope="module")
def pool():
    return C.Pool(SEED)


@pytest.fixture(scope="module")
def bwin():
    return np.ascontiguousarray(E.build_b_window())


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _batch(pool, n, G=None, mode="mixed"):
    """n corpus lanes, failing ones at the edges of the warps of K5's
    group width for n (or of width G)."""
    G = E.threads_per_lane(n) if G is None else G
    return C.lanes(pool, n, SEED + n, 32 // G, E.LANES_PER_BLOCK, mode)


def _run(lib, bwin, b, G) -> np.ndarray:
    """The harness's verdict bytes for batch b at group width G, the
    buffer poisoned first."""
    n = b["a"].shape[0]
    out = np.full(n, 0xAA, np.uint8)
    lib.h_k5(_ptr(b["a"]), _ptr(b["r"]), _ptr(b["s"]), _ptr(b["digest"]), _ptr(bwin), _ptr(out), n, G)
    return out


def _plain(b) -> np.ndarray:
    return E.verify_digest_plain(*(torch.from_numpy(b[k]) for k in ("a", "r", "s", "digest"))).numpy()


def _jax_host_verdict(a: bytes, r: bytes, s: bytes, digest: bytes) -> bool:
    """The JAX package's host group law (_ref25519) with the digest given:
    [8]([s]B - [k]A - R) == identity, k = digest mod L."""
    A, R = jref.decompress(a), jref.decompress(r)
    s_int = int.from_bytes(s, "little")
    if A is None or R is None or s_int >= jref.L:
        return False
    k = int.from_bytes(digest, "little") % jref.L
    q = jref.pt_add(jref.pt_mul(s_int, jref.BASE), jref.pt_neg(jref.pt_add(jref.pt_mul(k, A), R)))
    for _ in range(3):
        q = jref.pt_double(q)
    return jref.pt_is_identity(q)


def test_harness_builds_the_launch_shape(shipped):
    """The wrapper's mirror of the launch shape: lanes a block, and 4
    threads a lane up to the header's batch size, 2 above."""
    assert (shipped.h_lanes(), shipped.h_g4_max_lanes()) == (E.LANES_PER_BLOCK, E.G4_MAX_LANES)
    assert [E.threads_per_lane(n) for n in (1, 256, E.G4_MAX_LANES, E.G4_MAX_LANES + 1, 16_384)] == [4, 4, 4, 2, 2]


def _words(vals) -> np.ndarray:
    return np.frombuffer(b"".join((v % jref.P).to_bytes(32, "little") for v in vals), "<u4").astype(np.uint32)


def _affine(w: np.ndarray):
    X, Y, Z = (int.from_bytes(w[8 * i : 8 * i + 8].astype("<u4").tobytes(), "little") for i in range(3))
    zi = pow(Z, jref.P - 2, jref.P)
    return X * zi % jref.P, Y * zi % jref.P


@pytest.mark.parametrize("G", [4, 2])
def test_group_operations_match_one_thread_forms(shipped, G):
    """The group's doubling and cached add against ge_dbl / ge_add and
    the host bigint law, on projective points with random Z (the
    identity, small-order points, equal and opposite pairs among them)."""
    rng = np.random.default_rng(SEED + 1)
    P = jref.P
    pts = [jref.pt_mul(int.from_bytes(rng.bytes(32), "little"), jref.BASE) for _ in range(12)]
    pts += [jref.IDENT, jref.decompress(C.ORDER8), jref.decompress(C.ORDER2), jref.decompress(C.NC_ORDER4)]
    pairs = [(pts[i], pts[(i * 5 + 3) % len(pts)]) for i in range(len(pts))]
    pairs += [(pts[0], pts[0]), (pts[1], jref.pt_neg(pts[1]))]

    def proj(p):
        z = int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1
        x, y = p[0] * pow(p[2], P - 2, P) % P, p[1] * pow(p[2], P - 2, P) % P
        return [x * z, y * z, z, x * y % P * z]

    ps = np.concatenate([_words(proj(p)) for p, _ in pairs])
    qs = np.concatenate([_words(proj(q)) for _, q in pairs])
    out = np.zeros(128 * len(pairs), np.uint32)
    shipped.h_ops(_ptr(ps), _ptr(qs), _ptr(out), len(pairs), G)
    for i, (p, q) in enumerate(pairs):
        o = out[128 * i : 128 * (i + 1)]
        want_dbl, want_add = jref.pt_double(p), jref.pt_add(p, q)
        for w, want in ((o[:32], want_dbl), (o[32:64], want_dbl), (o[64:96], want_add), (o[96:], want_add)):
            assert _affine(w) == _affine(_words(want)), i


def test_corpus_verdicts_match_jax_host_oracle(pool):
    """Every distinct lane kind of the corpus gets the verdict its kind
    says from the JAX package's host group law."""
    b = _batch(pool, 257)
    seen = set()
    for v in range(257):
        row = tuple(bytes(b[k][v]) for k in ("a", "r", "s", "digest"))
        if row in seen:
            continue
        seen.add(row)
        assert _jax_host_verdict(*row) == bool(b["expect"][v]), (v, b["kinds"][v])
    assert {b["kinds"][v] for v in range(257)} == set(C.LANE_VALID + C.LANE_INVALID)


@pytest.mark.parametrize("G", [4, 2])
@pytest.mark.parametrize("n", SIZES)
def test_group_verdicts_match_plain_and_corpus(shipped, pool, bwin, n, G):
    """Whole launches of 1-257 lanes at both group widths, failing lanes
    at every warp's first and last lane and every block's last: every
    byte equals the plain version's and the corpus's, over a poisoned
    buffer."""
    b = _batch(pool, n, G)
    got = _run(shipped, bwin, b, G)
    assert got.tolist() == b["expect"].astype(np.uint8).tolist()
    assert np.array_equal(got.astype(bool), _plain(b))


@pytest.mark.parametrize("G", [4, 2])
def test_all_valid_batch(shipped, pool, bwin, G):
    b = _batch(pool, 40, G, "valid")
    got = _run(shipped, bwin, b, G)
    assert got.tolist() == [1] * 40 and bool(_plain(b).all())


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_a_planted_fault_fails(pool, bwin, tmp_path, name):
    """A copy of the headers with one fault planted: the harness's bytes
    no longer equal the corpus's verdicts."""
    header, old, new = MUTATIONS[name]
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    text = (csrc / header).read_text()
    assert text.count(old) == 1, f"{name}: the shipped text to mutate is not in {header}"
    (csrc / header).write_text(text.replace(old, new))
    lib = _build(csrc, tmp_path)
    for G in (4, 2):
        b = _batch(pool, 24, G)
        assert _run(lib, bwin, b, G).tolist() != b["expect"].astype(np.uint8).tolist(), G


@pytest.mark.slow
def test_group_verdicts_match_jax_verify_prepared(shipped, pool, bwin):
    """33 corpus lanes through the harness and the JAX package's jitted
    verify_prepared on the CPU (slow: a cold compile of ~150 s), its
    windows of k from the same digests."""
    import jax
    import jax.numpy as jnp
    from cometbft_tpu.ops import ed25519 as JE
    from cometbft_tpu.ops import scalar as jscalar

    b = _batch(pool, 33)
    got = _run(shipped, bwin, b, E.threads_per_lane(33))
    d = jnp.asarray(b["digest"])
    kw = jscalar.limbs_to_windows(jscalar.reduce_mod_l(jscalar.bytes_to_limbs(d, jscalar.NL_X)))
    s = jnp.asarray(b["s"])
    jok = jax.jit(JE.verify_prepared)(jnp.asarray(b["a"]), jnp.asarray(b["r"]), jscalar.bytes_to_windows(s), kw,
                                      jscalar.s_lt_l(s))
    assert np.asarray(jok).tolist() == got.astype(bool).tolist() == b["expect"].tolist()
