"""K4's group algorithm (csrc/comb_verify.cuh) built for the host: g++
compiles the header, whose exchange helper then runs the COMB_T threads
of a lane's group one after another (each thread's share of the table
positions, the fold's rounds, thread 0's verdict) and k4_host runs a
whole launch block by block, packing each block's bytes as the card
does.  The bytes are held against the port's plain K4 + pack_verdicts,
the corpus's own verdicts, the JAX package's host verdict
(cometbft_tpu/crypto/_ref25519.py) and its jitted verify_cached on the
CPU, over batches of 1-257 lanes with failing lanes at warp and block
edges, non-live lanes beside valid ones, lanes whose k leaves a whole
thread's share at the identity, and s = 0.  Skips only where no host
C++ compiler exists.
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
from cometbft_tpu.ops import comb as jcomb
from cometbft_tpu_torch.ops import comb, scalar
import torch_comb_corpus as C

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"
SEED = 9

HARNESS = r"""
#include "comb_verify.cuh"

static uint32_t h_dummy_a[COMB_A_WORDS];
static uint32_t h_dummy_b[COMB_NPOS_B * COMB_NENT_B * COMB_ENTRY_WORDS];

extern "C" {
int h_threads(void) { return COMB_T; }
int h_lanes(void) { return COMB_LANES; }

void h_share(int t, int* lo, int* hi) { comb_share(t, *lo, *hi); }

// The digit each position's lookup takes for n scalars k (8 words each,
// as K4's reduction leaves them) and s: da (n x 64) k's signed digits,
// db (n x 22) s's 12-bit digits.
void h_digits(const uint32_t* k, const uint32_t* s, int* da, int* db, int n) {
  for (int i = 0; i < n; i++) {
    uint32_t dig[COMB_DIG_WORDS];
    comb_bias_digits(dig, k + 8 * i);
    for (int w = 0; w < 8; w++) dig[8 + w] = s[8 * i + w];
    for (int p = 0; p < COMB_NPOS; p++) {
      bool neg, zero;
      const uint32_t* e = comb_entry(h_dummy_a, h_dummy_b, dig, 1, p, neg, zero);
      if (p < COMB_NPOS_A) {
        const int ad = zero ? 0 : (int)((e - h_dummy_a) / COMB_ENTRY_WORDS) - p * COMB_NENT_A + 1;
        da[64 * i + p] = neg ? -ad : ad;
      } else {
        const long off = (long)(e - h_dummy_b) / COMB_ENTRY_WORDS;
        db[22 * i + p - COMB_NPOS_A] = (int)(off - (long)(p - COMB_NPOS_A) * COMB_NENT_B);
      }
    }
  }
}

void h_k4(const uint32_t* tables, const uint8_t* valid, const uint8_t* payload, int width,
          const uint8_t* digest, const uint32_t* btab, uint8_t* out, int V) {
  const K4In in = {tables, valid, payload, width, digest, btab, nullptr, out, V};
  k4_host(in);
}
}
"""


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/comb_verify.cuh with")
    tmp = tmp_path_factory.mktemp("k4")
    src, out = tmp / "harness.cpp", tmp / "libk4.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    h.h_share.argtypes = [I_, P_, P_]
    h.h_digits.argtypes = [P_, P_, P_, P_, I_]
    h.h_k4.argtypes = [P_, P_, P_, I_, P_, P_, P_, I_]
    return h


@pytest.fixture(scope="module")
def pool():
    p = C.Pool(SEED)
    th, vh = comb.build_a_tables_host(p.pubs)
    assert vh.tolist() == [True] * C.POOL_KEYS + [False]
    return p, np.ascontiguousarray(th), vh


@pytest.fixture(scope="module")
def btab():
    return np.array(comb.build_b_tables())  # a writable copy


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _run(lib, pool, btab, b) -> np.ndarray:
    """The harness's output bytes for batch b, the buffer poisoned first."""
    _, th, vh = pool
    V = b["payload"].shape[0]
    tables = np.ascontiguousarray(th[b["key"]])
    valid = np.ascontiguousarray(vh[b["key"]].astype(np.uint8))
    out = np.full((V + 7) // 8 + 1, 0xAA, np.uint8)
    lib.h_k4(_ptr(tables), _ptr(valid), _ptr(b["payload"]), b["payload"].shape[1], _ptr(b["digest"]), _ptr(btab),
             _ptr(out), V)
    return out


_PLAIN: dict = {}


def _plain(pool, btab, b, key) -> np.ndarray:
    """pack_verdicts(verify_cached_plain(...)) of batch b (memoised by key)."""
    if key not in _PLAIN:
        _, th, vh = pool
        idx = torch.from_numpy(b["key"])
        ok = comb.verify_cached_plain(torch.from_numpy(th.view(np.int32))[idx], torch.from_numpy(vh)[idx],
                                      torch.from_numpy(b["payload"]), torch.from_numpy(b["digest"]),
                                      torch.from_numpy(btab.view(np.int32)))
        _PLAIN[key] = comb.pack_verdicts(ok, torch.from_numpy(b["payload"][:, 67] == 1)).numpy()
    return _PLAIN[key]


def _jax_host_verdict(pub: bytes, r_enc: bytes, s_enc: bytes, digest: bytes) -> bool:
    """The JAX package's host verify (_ref25519.verify) with the digest
    given: [8]([s]B - [k]A - R) == identity, k = digest mod L."""
    A, R = jref.decompress(pub), jref.decompress(r_enc)
    s = int.from_bytes(s_enc, "little")
    if A is None or R is None or s >= jref.L:
        return False
    k = int.from_bytes(digest, "little") % jref.L
    q = jref.pt_add(jref.pt_mul(s, jref.BASE), jref.pt_neg(jref.pt_add(jref.pt_mul(k, A), R)))
    for _ in range(3):
        q = jref.pt_double(q)
    return jref.pt_is_identity(q)


def test_harness_builds_the_group_shape(shipped):
    assert (shipped.h_threads(), shipped.h_lanes()) == (comb.THREADS_PER_LANE, comb.LANES_PER_BLOCK)


def test_shares_partition_the_table_positions(shipped):
    """Thread 0 (R's) takes no position, the others contiguous shares
    that differ by at most one, together every position once."""
    lib = shipped
    T = lib.h_threads()
    lo, hi = ctypes.c_int(), ctypes.c_int()
    shares = []
    for t in range(T):
        lib.h_share(t, ctypes.byref(lo), ctypes.byref(hi))
        shares.append((lo.value, hi.value))
    assert shares[0] == (0, 0) and shares[1][0] == 0
    assert all(shares[t][1] == shares[t + 1][0] for t in range(1, T - 1)) and shares[-1][1] == 86
    sizes = [h - l for l, h in shares[1:]]
    assert max(sizes) - min(sizes) <= 1


def test_signed_digits_from_the_biased_scalar(shipped):
    """Every position's digit from one biased add (k + 0x888...8): k's
    signed radix-16 digits and s's 12-bit digits, against the plain
    recoding (ops/scalar.py) and a Python one, on carry chains (nibbles
    of 8 and 7), the ends of [0, L) and random scalars."""
    rng = np.random.default_rng(SEED + 1)
    ks = [0, 1, 7, 8, 9, 15, 16, jref.L - 1, (1 << 252) - 1, 1 << 252,
          int("8" * 63, 16), int("7" * 63, 16), int("f" * 62, 16), int("88" * 31, 16) + 8]
    ks += [int.from_bytes(rng.bytes(32), "little") % jref.L for _ in range(24)]
    ss = [int.from_bytes(rng.bytes(32), "little") for _ in ks]
    ss[:3] = [0, jref.L - 1, (1 << 256) - 1]
    kw = np.array([[(k >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for k in ks], np.uint32)
    sw = np.array([[(s >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for s in ss], np.uint32)
    da = np.zeros((len(ks), 64), np.int32)
    db = np.zeros((len(ks), 22), np.int32)
    shipped.h_digits(_ptr(kw), _ptr(sw), _ptr(da), _ptr(db), len(ks))
    for i, k in enumerate(ks):
        assert sum(int(d) << (4 * p) for p, d in enumerate(da[i])) == k, i
        assert da[i].min() >= -8 and da[i].max() <= 7, i
        assert db[i].tolist() == [(ss[i] >> (12 * p)) & 0xFFF for p in range(22)], i
    k_bytes = torch.from_numpy(kw.view(np.uint8).reshape(len(ks), 32).copy())
    plain = scalar.signed_digits_radix16(scalar.reduce_mod_l(torch.cat([k_bytes, torch.zeros_like(k_bytes)], 1)))
    assert np.array_equal(plain.T.numpy(), da)
    s_bytes = torch.from_numpy(sw.view(np.uint8).reshape(len(ss), 32).copy())
    assert np.array_equal(scalar.digits_radix4096(s_bytes).T.numpy(), db)


@pytest.mark.parametrize("V", [1, 7, 8, 9, 31, 33, 257])
def test_group_bytes_match_plain_and_corpus(shipped, pool, btab, V):
    """Whole launches: failing lanes at every warp's first and last lane
    and every block's last, non-live lanes beside valid ones, the
    identity-share and s = 0 lanes; every byte (the all-ok byte too)
    equals the plain version's and the corpus's, over a poisoned
    buffer."""
    b = C.batch(pool[0], V, SEED + V)
    got = _run(shipped, pool, btab, b)
    assert np.array_equal(got, C.packed_expect(b))
    assert np.array_equal(got, _plain(pool, btab, b, ("mixed", V)))


@pytest.mark.parametrize("mode", ["valid", "valid_dead"])
def test_all_ok_byte(shipped, pool, btab, mode):
    """All-valid lanes, and valid lanes beside failing non-live ones:
    the all-ok byte is 1 and every live lane's bit is set."""
    b = C.batch(pool[0], 70, SEED + 70, mode)
    got = _run(shipped, pool, btab, b)
    assert got[-1] == 1
    assert np.array_equal(got, C.packed_expect(b))
    assert np.array_equal(got, _plain(pool, btab, b, (mode, 70)))


def test_identity_shares_cover_every_thread(shipped, pool, btab):
    """The corpus's zero-digit and s = 0 lanes leave every thread of the
    shipped group but R's with a share of identity entries in some lane,
    and all of them verify."""
    kinds = ["zero_lo", "zero_hi", "s_zero"]
    b = C.batch(pool[0], 96, SEED + 96, "valid")
    keep = [i for i, (k, _) in enumerate(b["kinds"]) if k in kinds]
    sub = {k: v[keep] if isinstance(v, np.ndarray) else [v[i] for i in keep] for k, v in b.items()}
    got = _run(shipped, pool, btab, sub)
    assert np.array_equal(got, C.packed_expect(sub)) and got[-1] == 1
    k = [int.from_bytes(bytes(sub["digest"][i]), "little") % jref.L for i in range(len(keep))]
    s = [int.from_bytes(bytes(sub["payload"][i, 32:64]), "little") for i in range(len(keep))]
    kw = np.array([[(x >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for x in k], np.uint32)
    sw = np.array([[(x >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for x in s], np.uint32)
    da = np.zeros((len(k), 64), np.int32)
    db = np.zeros((len(k), 22), np.int32)
    shipped.h_digits(_ptr(kw), _ptr(sw), _ptr(da), _ptr(db), len(k))
    digits = np.concatenate([da, db], 1)  # B digit 0 selects the stored identity
    lo, hi = ctypes.c_int(), ctypes.c_int()
    for t in range(1, shipped.h_threads()):
        shipped.h_share(t, ctypes.byref(lo), ctypes.byref(hi))
        assert any(not digits[i, lo.value : hi.value].any() for i in range(len(k))), t


def test_group_matches_jax_verify_cached_and_host_ref(shipped, pool, btab):
    """40 lanes (failing lanes at the warp and block edges, non-live
    lanes) through the harness, the JAX package's jitted verify_cached
    (its tree accumulation) on the CPU and its host verify: the same
    verdicts, and the harness's bytes equal packbits(ok & live) and the
    all-ok byte of the JAX verdicts."""
    import jax
    import jax.numpy as jnp

    p, _, _ = pool
    b = C.batch(p, 40, SEED + 40)
    got = _run(shipped, pool, btab, b)
    jt, jv = jcomb.build_a_tables_host(p.pubs)
    key = b["key"]
    pay = b["payload"]
    fn = jax.jit(lambda *x: jcomb.verify_cached(*x, tree=True))
    jok = np.asarray(fn(jnp.asarray(jt[..., key]), jnp.asarray(jv[key]), jnp.asarray(pay[:, :32]),
                        jnp.asarray(pay[:, 32:64]), jnp.asarray(b["digest"]), jcomb.get_b_tables()))
    host = [_jax_host_verdict(p.pub_bytes[key[v]], bytes(pay[v, :32]), bytes(pay[v, 32:64]), bytes(b["digest"][v]))
            for v in range(40)]
    assert jok.tolist() == host == b["expect"].tolist()
    live = pay[:, 67] == 1
    want = np.concatenate([np.packbits(jok & live), [np.uint8(bool(np.all(jok | ~live)))]])
    assert np.array_equal(got, want)
