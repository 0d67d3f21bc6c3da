"""Batched secp256k1 ECDSA verification on the card — K11 and K12, the
port of cometbft_tpu/ops/secp256k1.py.

Kernels (CUDA C++ in csrc/secp.cu; the group arithmetic and the block
algorithm in csrc/secp256k1.cuh, hashing in csrc/keccak.cuh and
csrc/sha256.cuh; SECP_T threads a row, one inversion a block and kind):

  K11 ``verify_batch``       replaces cometbft_tpu/ops/secp256k1.py:861
      (manifest rows secp256k1_verify_batch, _recover, _noglv,
      _noglv_recover): instantiations <GLV, RECOVER>
  K12 ``hash_verify_batch``  replaces :996 (rows secp256k1_hash_verify,
      _recover; the Shamir instantiations <0, *> run under
      COMETBFT_TPU_SECP_GLV=0)

Both compute, per row, exactly the JAX program's verdict: range and
low-s checks, v <= 1 on Ethereum and ecrecover rows, the on-curve check
of the host-decoded key or (ecrecover) the lift of R from r and v,
u1 = e / s and u2 = r / s mod n (ecrecover: -e / r and s / r), the walk
u1 G + u2 Q (GLV over G, phi(G), Q, phi(Q) by default, the Shamir
witness under ``glv=False``), the affine point, and the Cosmos
(x mod n == r), Ethereum (x == r, y parity == v) or ecrecover
(Keccak256(x || y)[12:] == address) verdict.

Layout: every 256-bit value is 8 little-endian 32-bit words held in an
int32 tensor (N, 8) — the port's counterpart of the JAX package's
22 x 12-bit limbs (``ints_to_words_np``; convert.words_from_jax_limbs
carries JAX limb arrays across).  The fixed table of G and phi(G) is
(2, 8, 2, 8) words: [G, phi(G)][j = 1..8][x, y], affine, copied to each
device once (``g_table``).

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors; ``LAUNCHES`` counts kernel launches per
instantiation.  The plain version works on 16 x 16-bit limbs in int64
tensors, canonical (in [0, p) or [0, n)) after every operation, with
selects where the kernel branches.  It computes every row alone (a
Fermat inversion of its own s and Z, a Jacobian table of j Q); the
kernels share the inversions across a block and make the table affine.
An inverse mod a prime is unique and the walk's points do not depend on
their coordinates' scale, so the verdicts are the same bytes.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import _build
from ..crypto import secp256k1 as host_secp
from . import keccak as K
from . import sha2

P = host_secp.P  # 2^256 - 2^32 - 977
N = host_secp.N  # the group order
R_MONT = 1 << 256

LAUNCHES = {
    "secp_verify_batch": 0,  # K11<1,0>
    "secp_verify_batch_recover": 0,  # K11<1,1>
    "secp_verify_batch_noglv": 0,  # K11<0,0>
    "secp_verify_batch_noglv_recover": 0,  # K11<0,1>
    "secp_hash_verify": 0,  # K12<1,0>
    "secp_hash_verify_recover": 0,  # K12<1,1>
    "secp_hash_verify_noglv": 0,  # K12<0,0>
    "secp_hash_verify_noglv_recover": 0,  # K12<0,1>
}


# The kernels' launch shape, csrc/secp256k1.cuh SECP_T and SECP_ROWS
# (held to the header by tests/test_torch_secp.py): threads a row, rows
# (groups) a block, one inversion of each kind a block
THREADS_PER_ROW = 4
ROWS_PER_BLOCK = 32


def variant(base: str, glv: bool, recover: bool) -> str:
    """LAUNCHES key of one instantiation: base 'secp_verify_batch' or
    'secp_hash_verify'."""
    return base + ("" if glv else "_noglv") + ("_recover" if recover else "")


# ------------------------------------------------------- GLV constants
# Derived from the curve as cometbft_tpu/ops/secp256k1.py:162-280 derives
# them: beta / lambda, the short lattice basis (extended Euclid on
# (n, lambda)), the rounding multipliers g_i = round(2^384 |b_j| / n).


def _find_glv() -> tuple[int, int]:
    beta = lam = None
    g = 2
    while beta is None:
        c = pow(g, (P - 1) // 3, P)
        if c != 1:
            beta = c
        g += 1
    g = 2
    while lam is None:
        c = pow(g, (N - 1) // 3, N)
        if c != 1:
            lam = c
        g += 1
    for lc in (lam, lam * lam % N):
        got = host_secp._mul(lc, host_secp.G)
        for bc in (beta, beta * beta % P):
            if got == (bc * host_secp.G[0] % P, host_secp.G[1]):
                return bc, lc
    raise AssertionError("secp256k1 GLV beta/lambda pairing not found")


BETA, LAM = _find_glv()


def _glv_basis() -> tuple[int, int, int, int]:
    rs, ts = [N, LAM], [0, 1]
    while rs[-1] * rs[-1] >= N:
        q = rs[-2] // rs[-1]
        rs.append(rs[-2] - q * rs[-1])
        ts.append(ts[-2] - q * ts[-1])
    q = rs[-2] // rs[-1]
    rs.append(rs[-2] - q * rs[-1])
    ts.append(ts[-2] - q * ts[-1])
    a1, b1 = rs[-2], -ts[-2]
    a2, b2 = min((rs[-3], -ts[-3]), (rs[-1], -ts[-1]), key=lambda v: v[0] * v[0] + v[1] * v[1])
    det = a1 * b2 - a2 * b1
    assert abs(det) == N
    if det < 0:
        a2, b2 = -a2, -b2
    assert (a1 + b1 * LAM) % N == 0 and (a2 + b2 * LAM) % N == 0
    return a1, b1, a2, b2


_A1, _B1, _A2, _B2 = _glv_basis()
G1 = ((1 << 384) * abs(_B2) + N // 2) // N
G2 = ((1 << 384) * abs(_B1) + N // 2) // N
_S1 = 1 if _B2 > 0 else -1
_S2 = 1 if _B1 < 0 else -1
M1 = (-_S1 * _B1) % N
M2 = (-_S2 * _B2) % N
GLV_SIGN_BOUND = 1 << 132
GLV_WINDOWS = 33  # signed 4-bit digits of a |half| < 2^130
SHAMIR_WINDOWS = 65  # signed 4-bit digits of a scalar < 2^256


def split_host(k: int) -> tuple[int, int]:
    """Host mirror of the kernel's split: k -> signed (k1, k2) with
    k1 + lambda k2 == k (mod n), |k_i| < 2^130."""
    c1 = (k * G1 + (1 << 383)) >> 384
    c2 = (k * G2 + (1 << 383)) >> 384
    k2 = (c1 * M1 + c2 * M2) % N
    k1 = (k - LAM * k2) % N
    return (k1 if k1 < GLV_SIGN_BOUND else k1 - N), (k2 if k2 < GLV_SIGN_BOUND else k2 - N)


def header_constants() -> dict[str, int]:
    """The values csrc/secp256k1.cuh carries as word literals (held to
    these by tests/test_torch_secp.py)."""
    return {
        "SECP_N": N, "SECP_NHALF": N // 2, "SECP_R2N": R_MONT * R_MONT % N,
        "SECP_ONE_N_MONT": R_MONT % N, "SECP_R3N": R_MONT ** 3 % N, "SECP_BETA": BETA,
        "SECP_G1": G1, "SECP_G2": G2,
        "SECP_M1R": M1 * R_MONT % N, "SECP_M2R": M2 * R_MONT % N,
        "SECP_LAMR": LAM * R_MONT % N, "SECP_NINV": (-pow(N, -1, 1 << 32)) % (1 << 32),
        "SECP_T": THREADS_PER_ROW, "SECP_ROWS": ROWS_PER_BLOCK,
    }


# ------------------------------------------------------- host packing


def ints_to_words_np(vals) -> np.ndarray:
    """Plain ints (< 2^256) -> (B, 8) int32 little-endian 32-bit words
    (the port's counterpart of cometbft_tpu/ops/secp256k1.py:1041
    ints_to_limbs_np)."""
    n = len(vals)
    if n == 0:
        return np.zeros((0, 8), dtype=np.int32)
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype="<i4").reshape(n, 8).copy()


def be_bytes_to_words_np(b: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 big-endian values -> (B, 8) int32 words."""
    return np.ascontiguousarray(np.asarray(b, dtype=np.uint8)[:, ::-1]).view("<i4").reshape(-1, 8)


def words_to_ints(w) -> list[int]:
    """(B, 8) int32 words (tensor or array) -> plain ints."""
    a = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    a = np.ascontiguousarray(a.astype(np.int32))
    return [int.from_bytes(row.tobytes(), "little") for row in a]


def build_g_table() -> np.ndarray:
    """(2, 8, 2, 8) uint32: [G, phi(G)][j = 1..8][x, y] affine words,
    from the host group law (the counterpart of :555 _build_g_table,
    whose 16 Jacobian Montgomery entries the port's signed digits halve)."""
    out = np.zeros((2, 8, 2, 8), dtype=np.uint32)
    acc = None
    for j in range(8):
        acc = host_secp._add(acc, host_secp.G)
        x, y = acc
        for t, xv in enumerate((x, BETA * x % P)):
            out[t, j, 0] = np.frombuffer(xv.to_bytes(32, "little"), "<u4")
            out[t, j, 1] = np.frombuffer(y.to_bytes(32, "little"), "<u4")
    return out


_G_TABLE: dict[str, torch.Tensor] = {}
_G_TABLE_MTX = threading.Lock()


def g_table(device) -> torch.Tensor:
    """The G / phi(G) table as (2, 8, 2, 8) int32 words on ``device``,
    copied there once per process and device (:577 g_table)."""
    key = str(torch.device(device))
    with _G_TABLE_MTX:
        t = _G_TABLE.get(key)
        if t is None:
            t = torch.from_numpy(build_g_table().view(np.int32).copy()).to(device)
            _G_TABLE[key] = t
        return t


# ------------------------------------------------------- plain: limbs

_M16 = 0xFFFF
_C_P = (1 << 256) - P  # 2^32 + 977
_NP16 = (-pow(N, -1, 1 << 16)) % (1 << 16)
_CONSTS: dict[tuple, torch.Tensor] = {}


def _limbs_of(x: int, n: int = 16) -> list[int]:
    return [(x >> (16 * i)) & _M16 for i in range(n)]


def _const(x: int, dev, n: int = 16) -> torch.Tensor:
    key = (x, n, str(dev))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(_limbs_of(x, n), dtype=torch.int64, device=dev)
        _CONSTS[key] = t
    return t


def _from_words(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 16) int64 limbs."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & _M16, w >> 16], dim=-1).reshape(w.shape[:-1] + (16,))


def _to_words(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[:-1] + (8, 2))
    w = x[..., 0] | (x[..., 1] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Exact carries: columns 0..L-2 become digits in [0, 2^16), the last
    column takes what is carried out of them (it may be negative when
    the value is)."""
    while True:
        c = x >> 16
        if not bool(c[:, :-1].any()):
            return x
        x = torch.cat([x[:, :1] & _M16, (x[:, 1:-1] & _M16) + c[:, :-2], x[:, -1:] + c[:, -2:-1]], 1)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, A) x (N or 1, B) limbs (or a (B,) constant) -> (N, A + B - 1)
    product columns."""
    if b.dim() == 1:
        b = b[None]
    A, B = a.shape[1], b.shape[1]
    outer = a[:, :, None] * b[:, None, :]
    flat = torch.nn.functional.pad(outer, (0, A)).reshape(outer.shape[0], A * (A + B))
    return flat[:, : A * (A + B - 1)].reshape(outer.shape[0], A, A + B - 1).sum(1)


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, width - x.shape[1]))


def _is_zero(x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(1)


def _eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(1)


def _lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b for canonical digit vectors (a constant b broadcasts)."""
    x = a - b
    return _norm(_pad(x, x.shape[1] + 1))[:, -1] < 0


def _where(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(c[:, None], a, b)


# mod p ------------------------------------------------------------


def _fp_canon(x: torch.Tensor) -> torch.Tensor:
    """Digits of a value < 2^256 -> [0, p): subtract p where x + 2^256 - p
    overflows."""
    t = _pad(x, 17).clone()
    t[:, 0] += 977
    t[:, 2] += 1
    t = _norm(t)
    return _where(t[:, 16] > 0, t[:, :16], x)


def _fp_fold(cols: torch.Tensor) -> torch.Tensor:
    """Non-negative columns (N, L <= 31) -> canonical mod p, folding
    2^256 = 2^32 + 977 until no carry is left above 2^256."""
    N_ = cols.shape[0]
    t = torch.zeros((N_, 18), dtype=torch.int64, device=cols.device)
    t[:, :16] = cols[:, :16]
    hi = cols[:, 16:]
    if hi.shape[1]:
        h = hi.shape[1]
        t[:, :h] += 977 * hi
        t[:, 2 : 2 + h] += hi
    while True:
        t = _norm(t)
        top = t[:, 16] + (t[:, 17] << 16)
        if not bool(top.any()):
            return _fp_canon(t[:, :16])
        t = torch.cat([t[:, :16], torch.zeros_like(t[:, :2])], 1)
        t[:, 0] += 977 * (top & _M16)
        t[:, 1] += 977 * (top >> 16)
        t[:, 2] += top & _M16
        t[:, 3] += top >> 16


def fp_mul(a, b):
    return _fp_fold(_conv(a, b))


def fp_sqr(a):
    return fp_mul(a, a)


def _fp_cond_sub(s: torch.Tensor) -> torch.Tensor:
    """Digits (N, 17) of a value < 2p -> [0, p): subtract p where
    s + 2^256 - p reaches 2^256."""
    t = s.clone()
    t[:, 0] += 977
    t[:, 2] += 1
    t = _norm(t)
    return _where(t[:, 16] > 0, t[:, :16], s[:, :16])


def fp_add(a, b):
    return _fp_cond_sub(_norm(_pad(a + b, 17)))


def fp_sub(a, b):
    return _fp_cond_sub(_norm(_pad(a - b + _const(P, a.device), 17)))


def fp_neg(a):
    return fp_sub(torch.zeros_like(a), a)


def _fp_sqr_n(a, n):
    for _ in range(n):
        a = fp_mul(a, a)
    return a


def _fp_x223(a):
    x2 = fp_mul(fp_sqr(a), a)
    x3 = fp_mul(fp_sqr(x2), a)
    t = fp_mul(_fp_sqr_n(x3, 3), x3)
    t = fp_mul(_fp_sqr_n(t, 3), x3)
    x11 = fp_mul(_fp_sqr_n(t, 2), x2)
    x22 = fp_mul(_fp_sqr_n(x11, 11), x11)
    x44 = fp_mul(_fp_sqr_n(x22, 22), x22)
    x88 = fp_mul(_fp_sqr_n(x44, 44), x44)
    t = fp_mul(_fp_sqr_n(x88, 88), x88)
    t = fp_mul(_fp_sqr_n(t, 44), x44)
    return fp_mul(_fp_sqr_n(t, 3), x3), x22, x2


def fp_inv(a):
    """a^(p - 2) by libsecp256k1's addition chain (the kernels invert a
    block's product by a binary GCD instead: the same inverse)."""
    x223, x22, x2 = _fp_x223(a)
    t = fp_mul(_fp_sqr_n(x223, 23), x22)
    t = fp_mul(_fp_sqr_n(t, 5), a)
    t = fp_mul(_fp_sqr_n(t, 3), x2)
    return fp_mul(_fp_sqr_n(t, 2), a)


def fp_sqrt_cand(a):
    """a^((p + 1) / 4)."""
    x223, x22, x2 = _fp_x223(a)
    t = fp_mul(_fp_sqr_n(x223, 23), x22)
    t = fp_mul(_fp_sqr_n(t, 6), x2)
    return _fp_sqr_n(t, 2)


# mod n ------------------------------------------------------------


def _sc_cond_sub(t: torch.Tensor) -> torch.Tensor:
    """Digits (N, 17) of a value < 2n -> canonical [0, n)."""
    d = _norm(t - _const(N, t.device, 17))
    return _where(d[:, 16] >= 0, d[:, :16], t[:, :16])


def sc_mont_mul(a, b):
    """a b R^-1 mod n (R = 2^256), canonical, for a < 2^256, b < n."""
    n_l = _const(N, a.device)
    t = _pad(_conv(a, b), 33).clone()
    for i in range(16):
        q = ((t[:, i] & _M16) * _NP16) & _M16
        t[:, i : i + 16] += q[:, None] * n_l
        t[:, i + 1] += t[:, i] >> 16
    return _sc_cond_sub(_norm(t[:, 16:33]))


def sc_add(a, b):
    return _sc_cond_sub(_norm(_pad(a + b, 17)))


def sc_sub(a, b):
    d = _norm(_pad(a - b, 17))
    dn = _norm(_pad(d[:, :16] + _const(N, a.device), 17))
    return _where(d[:, 16] < 0, dn[:, :16], d[:, :16])


def sc_neg(a):
    return sc_sub(torch.zeros_like(a), a)


_NM2_NIBBLES = [((N - 2) >> (4 * i)) & 15 for i in range(63, -1, -1)]


def sc_inv_mont(xm):
    """x R -> x^-1 R: a 4-bit window over the digits of n - 2
    (_NM2_NIBBLES).  The kernels invert a block's product by a binary GCD
    instead: the same inverse."""
    tab = [_const(R_MONT % N, xm.device).expand_as(xm), xm]
    for _ in range(2, 16):
        tab.append(sc_mont_mul(tab[-1], xm))
    acc = tab[_NM2_NIBBLES[0]]
    for nib in _NM2_NIBBLES[1:]:
        for _ in range(4):
            acc = sc_mont_mul(acc, acc)
        if nib:
            acc = sc_mont_mul(acc, tab[nib])
    return acc


# GLV ----------------------------------------------------------------


def _mul_shift_384(k, g: int):
    t = _conv(k, _const(g, k.device, 17)[None, :])  # (N, 32)
    t = _pad(t, 34).clone()
    t[:, 23] += 1 << 15  # + 2^383
    t = _norm(t)
    return _pad(t[:, 24:33], 16)


def glv_split(k):
    """Canonical (N, 16) k -> (|k1|, k1 < 0, |k2|, k2 < 0)."""
    dev = k.device
    c1 = _mul_shift_384(k, G1)
    c2 = _mul_shift_384(k, G2)
    k2 = sc_add(sc_mont_mul(c1, _const(M1 * R_MONT % N, dev)), sc_mont_mul(c2, _const(M2 * R_MONT % N, dev)))
    k1 = sc_sub(k, sc_mont_mul(k2, _const(LAM * R_MONT % N, dev)))
    out = []
    for kk in (k1, k2):
        neg = ((kk[:, 8] >> 4) != 0) | (kk[:, 9:] != 0).any(1)
        out += [_where(neg, sc_neg(kk), kk), neg]
    return tuple(out)


def recode_signed4(k, nwin: int) -> torch.Tensor:
    """(N, 16) digits -> (N, nwin) signed radix-16 digits in [-8, 8],
    least significant first."""
    nib = torch.stack([(k >> s) & 15 for s in (0, 4, 8, 12)], -1).reshape(k.shape[0], 64)
    nib = _pad(nib, max(nwin, 64))
    out, carry = [], torch.zeros_like(nib[:, 0])
    for i in range(nwin):
        v = nib[:, i] + carry
        carry = (v >= 8).to(torch.int64)
        out.append(v - 16 * carry)
    return torch.stack(out, 1)


# points -----------------------------------------------------------


def _one(like):
    return _const(1, like.device).expand_as(like)


def pt_double(X, Y, Z):
    """dbl-2009-l (a = 0); Z = 0 stays 0."""
    A, B = fp_sqr(X), fp_sqr(Y)
    C = fp_sqr(B)
    D = fp_sub(fp_sub(fp_sqr(fp_add(X, B)), A), C)
    D = fp_add(D, D)
    E = fp_add(fp_add(A, A), A)
    X3 = fp_sub(fp_sub(fp_sqr(E), D), D)
    C8 = fp_add(C, C)
    C8 = fp_add(C8, C8)
    C8 = fp_add(C8, C8)
    Y3 = fp_sub(fp_mul(E, fp_sub(D, X3)), C8)
    Z3 = fp_mul(Y, Z)
    return X3, Y3, fp_add(Z3, Z3)


def _finish_add(acc, U1, S1, H, R, Zprod, inf_acc, other):
    """The common tail of the adds, with the kernel's branches as selects:
    infinity operand, doubling (equal points), infinity (opposite)."""
    HH = fp_sqr(H)
    HHH = fp_mul(H, HH)
    V = fp_mul(U1, HH)
    X3 = fp_sub(fp_sub(fp_sub(fp_sqr(R), HHH), V), V)
    Y3 = fp_sub(fp_mul(R, fp_sub(V, X3)), fp_mul(S1, HHH))
    Z3 = fp_mul(Zprod, H)
    hz, rz = _is_zero(H), _is_zero(R)
    same = hz & rz & ~inf_acc
    if bool(same.any()):
        dX, dY, dZ = pt_double(*acc)
        X3, Y3, Z3 = (_where(same, d, v) for d, v in zip((dX, dY, dZ), (X3, Y3, Z3)))
    opp = hz & ~rz & ~inf_acc
    Z3 = _where(opp, torch.zeros_like(Z3), Z3)
    return tuple(_where(inf_acc, o, v) for o, v in zip(other, (X3, Y3, Z3)))


def pt_add_affine(acc, x2, y2):
    X1, Y1, Z1 = acc
    z1z1 = fp_sqr(Z1)
    U2 = fp_mul(x2, z1z1)
    S2 = fp_mul(fp_mul(y2, Z1), z1z1)
    return _finish_add(acc, X1, Y1, fp_sub(U2, X1), fp_sub(S2, Y1), Z1, _is_zero(Z1), (x2, y2, _one(x2)))


def pt_add(acc, q):
    """acc + q for a q that is never infinity (a table entry)."""
    X1, Y1, Z1 = acc
    X2, Y2, Z2 = q
    z1z1, z2z2 = fp_sqr(Z1), fp_sqr(Z2)
    U1, U2 = fp_mul(X1, z2z2), fp_mul(X2, z1z1)
    S1 = fp_mul(fp_mul(Y1, Z2), z2z2)
    S2 = fp_mul(fp_mul(Y2, Z1), z1z1)
    return _finish_add(acc, U1, S1, fp_sub(U2, U1), fp_sub(S2, S1), fp_mul(Z1, Z2), _is_zero(Z1), q)


def _keep(d, new, old):
    skip = d == 0
    return tuple(_where(skip, o, n_) for n_, o in zip(new, old))


def _add_fixed(acc, d, neg, tab):
    """acc += d * T over the (8, 2, 16) fixed table (signed digit d)."""
    idx = (d.abs() - 1).clamp(min=0)
    x, y = tab[idx, 0], tab[idx, 1]
    y = _where((d < 0) != neg, fp_neg(y), y)
    return _keep(d, pt_add_affine(acc, x, y), acc)


def _add_var(acc, d, neg, T, phi: bool):
    """acc += d * T over the lane tables (N, 8, 3, 16)."""
    idx = (d.abs() - 1).clamp(min=0)
    e = T[torch.arange(T.shape[0], device=T.device), idx]
    X, Y, Z = e[:, 0], e[:, 1], e[:, 2]
    if phi:
        X = fp_mul(X, _const(BETA, X.device).expand_as(X))
    Y = _where((d < 0) != neg, fp_neg(Y), Y)
    return _keep(d, pt_add(acc, (X, Y, Z)), acc)


def walk_plain(u1, u2, px, py, gtab, glv: bool):
    """u1 G + u2 P over canonical limbs, as one joint walk over the
    kernels' signed digits (the kernels split it over their lanes)."""
    one = _one(px)
    T = [(px, py, one), pt_double(px, py, one)]
    for _ in range(2, 8):
        T.append(pt_add_affine(T[-1], px, py))
    T = torch.stack([torch.stack(t, 1) for t in T], 1)  # (N, 8, 3, 16)
    tab = _from_words(gtab.reshape(2, 8, 2, 8))  # (2, 8, 2, 16)
    acc = (one, one, torch.zeros_like(px))
    false = torch.zeros(px.shape[0], dtype=torch.bool, device=px.device)
    if glv:
        a1, na1, a2, na2 = glv_split(u1)
        b1, nb1, b2, nb2 = glv_split(u2)
        d = [recode_signed4(k, GLV_WINDOWS) for k in (a1, a2, b1, b2)]
        for w in range(GLV_WINDOWS - 1, -1, -1):
            if w != GLV_WINDOWS - 1:
                for _ in range(4):
                    acc = pt_double(*acc)
            acc = _add_fixed(acc, d[0][:, w], na1, tab[0])
            acc = _add_fixed(acc, d[1][:, w], na2, tab[1])
            acc = _add_var(acc, d[2][:, w], nb1, T, False)
            acc = _add_var(acc, d[3][:, w], nb2, T, True)
    else:
        d = [recode_signed4(k, SHAMIR_WINDOWS) for k in (u1, u2)]
        for w in range(SHAMIR_WINDOWS - 1, -1, -1):
            if w != SHAMIR_WINDOWS - 1:
                for _ in range(4):
                    acc = pt_double(*acc)
            acc = _add_fixed(acc, d[0][:, w], false, tab[0])
            acc = _add_var(acc, d[1][:, w], false, T, False)
    return acc


def _be_lanes(x):
    """Canonical limbs -> the 4 little-endian Keccak lanes of its 32
    big-endian bytes."""
    lanes = []
    for i in range(4):
        c = 3 - i  # big-endian bytes 8i..8i+7 are the 64-bit chunk 3 - i
        by = [(x[:, 4 * c + k // 2] >> (8 * (k % 2))) & 0xFF for k in range(8)]  # LE bytes of the chunk
        lane = torch.zeros_like(by[0])
        for b in by:  # byte-swapped: the chunk's most significant byte first
            lane = (lane << 8) | b
        lanes.append(lane)
    return lanes


def address_plain(x, y):
    """Keccak256(x_be || y_be)[12:] -> (N, 20) uint8."""
    z = torch.zeros_like(x[:, 0])
    a = _be_lanes(x) + _be_lanes(y) + [z + 1] + [z] * 7 + [z + (-(1 << 63))] + [z] * 8
    return K.lanes_to_bytes(K.keccak_f_plain(a)[:4])[:, 12:]


# ------------------------------------------------------ the plain verify


def _check(n, **arrays) -> torch.device:
    dev = None
    for name, (t, shape, dtypes) in arrays.items():
        if t.shape != (n,) + shape or t.dtype not in dtypes:
            raise _build.LaunchRefused(f"{name} must be {(n,) + shape} of {dtypes}, got {tuple(t.shape)} {t.dtype}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise _build.LaunchRefused(f"{name} is on {t.device}, not {dev}")
    return dev


_BOOL8 = (torch.bool, torch.uint8)


def _check_rows(qx, qy, q_valid, r, s, is_eth, v, is_rec, addr, gtab, e=None):
    n = qx.shape[0]
    words = ((8,), (torch.int32,))
    arrays = dict(qx=(qx,) + words, qy=(qy,) + words, r=(r,) + words, s=(s,) + words,
                  q_valid=(q_valid, (), _BOOL8), is_eth=(is_eth, (), _BOOL8),
                  v=(v, (), (torch.int32,)), is_rec=(is_rec, (), _BOOL8),
                  addr=(addr, (20,), (torch.uint8,)))
    if e is not None:
        arrays["e"] = (e,) + words
    dev = _check(n, **arrays)
    if tuple(gtab.shape) != (2, 8, 2, 8) or gtab.dtype != torch.int32 or gtab.device != dev:
        raise _build.LaunchRefused("gtab must be the (2, 8, 2, 8) int32 g_table on the rows' device")
    return dev


def verify_batch_plain(qx, qy, q_valid, e, r, s, is_eth, v, is_rec, addr, gtab, *,
                       glv=True, recover=False) -> torch.Tensor:
    """Plain version of K11: (N,) bool verdicts."""
    q_valid, is_eth, is_rec = q_valid.bool(), is_eth.bool(), is_rec.bool()
    if not recover:
        is_rec = torch.zeros_like(is_rec)
    qx, qy, e, r, s = (_from_words(t) for t in (qx, qy, e, r, s))
    v = v.to(torch.int64)
    n_l = _const(N, r.device)
    r_ok = ~_is_zero(r) & _lt(r, n_l)
    s_ok = ~_is_zero(s) & _lt(s, n_l) & ~_lt(_const(N // 2, r.device), s)
    v_ok = torch.where(is_eth | is_rec, v <= 1, torch.ones_like(is_eth))
    px, py = _fp_canon(qx), _fp_canon(qy)
    q_ok = q_valid & _eq(fp_sqr(py), fp_add(fp_mul(fp_sqr(px), px), _const(7, r.device).expand_as(px)))
    if recover:
        rx = _fp_canon(r)
        y2 = fp_add(fp_mul(fp_sqr(rx), rx), _const(7, r.device).expand_as(rx))
        ry = fp_sqrt_cand(y2)
        lift_ok = _eq(fp_sqr(ry), y2)
        ry = _where((ry[:, 0] & 1) != v, fp_neg(ry), ry)
        q_ok = torch.where(is_rec, lift_ok, q_ok)
        px, py = _where(is_rec, rx, px), _where(is_rec, ry, py)
    row_pre = q_ok & r_ok & s_ok & v_ok
    # scalars (invalid rows compute on whatever they hold: masked below)
    w_in = _where(is_rec, r, s)
    wm = sc_inv_mont(sc_mont_mul(w_in, _const(R_MONT * R_MONT % N, r.device).expand_as(w_in)))
    u1 = sc_mont_mul(e, wm)
    u1 = _where(is_rec, sc_neg(u1), u1)
    u2 = sc_mont_mul(_where(is_rec, s, r), wm)
    X, Y, Z = walk_plain(u1, u2, px, py, gtab, glv)
    z_ok = ~_is_zero(Z)
    zi = fp_inv(Z)
    zi2 = fp_sqr(zi)
    x, y = fp_mul(X, zi2), fp_mul(fp_mul(Y, zi2), zi)
    x_eq_r = _eq(x, r)
    rn = _norm(_pad(r + n_l, 17))
    rn_ok = (rn[:, 16] == 0) & _lt(rn[:, :16], _const(P, r.device)) & _eq(x, rn[:, :16])
    verdict = torch.where(is_eth, x_eq_r & ((y[:, 0] & 1) == v), x_eq_r | rn_ok)
    if recover:
        verdict = torch.where(is_rec, (address_plain(x, y) == addr).all(1), verdict)
    return row_pre & z_ok & verdict


def digest_e_plain(sha_blocks, sha_active, kec_blocks, kec_active, is_eth, is_rec) -> torch.Tensor:
    """The fused kernel's message hash: Keccak-256 on Ethereum and
    ecrecover rows, SHA-256 on Cosmos rows, read big-endian -> (N, 8)
    int32 words."""
    sha_d = sha2.sha256_blocks_plain(sha_blocks, sha_active)
    kec_d = K.keccak256_blocks_plain(kec_blocks, kec_active)
    dig = torch.where((is_eth.bool() | is_rec.bool())[:, None], kec_d, sha_d)
    by = dig.flip(1).to(torch.int64).reshape(-1, 8, 4)
    w = by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16) | (by[..., 3] << 24)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def hash_verify_batch_plain(sha_blocks, sha_active, kec_blocks, kec_active, qx, qy, q_valid, r, s,
                            is_eth, v, is_rec, addr, gtab, *, glv=True, recover=False) -> torch.Tensor:
    """Plain version of K12."""
    e = digest_e_plain(sha_blocks, sha_active, kec_blocks, kec_active, is_eth, is_rec)
    return verify_batch_plain(qx, qy, q_valid, e, r, s, is_eth, v, is_rec, addr, gtab,
                              glv=glv, recover=recover)


# ------------------------------------------------------------ wrappers


def _c(t: torch.Tensor, dtype=None) -> torch.Tensor:
    return (t if dtype is None else t.to(dtype)).contiguous()


def verify_batch(qx, qy, q_valid, e, r, s, is_eth, v, is_rec, addr, gtab, *,
                 glv=True, recover=False) -> torch.Tensor:
    """(N,) bool verdicts of the batched ECDSA check: K11<glv, recover> on
    CUDA tensors, the plain version on CPU tensors.  Arguments as
    cometbft_tpu/ops/secp256k1.py:861 verify_batch, with (N, 8) int32
    words for the 256-bit values and the port's g_table."""
    dev = _check_rows(qx, qy, q_valid, r, s, is_eth, v, is_rec, addr, gtab, e=e)
    if dev.type == "cpu":
        return verify_batch_plain(qx, qy, q_valid, e, r, s, is_eth, v, is_rec, addr, gtab,
                                  glv=glv, recover=recover)
    if dev.type != "cuda":
        raise _build.LaunchRefused(f"unsupported device {dev}")
    out = torch.empty((qx.shape[0],), dtype=torch.uint8, device=dev)
    args = [_c(qx), _c(qy), _c(q_valid, torch.uint8), _c(e), _c(r), _c(s), _c(is_eth, torch.uint8),
            _c(v), _c(is_rec, torch.uint8), _c(addr), _c(gtab), out]
    with torch.cuda.device(dev):
        code = _build.lib("secp").k11_secp_verify(
            *[a.data_ptr() for a in args], qx.shape[0], int(bool(glv)), int(bool(recover)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "k11_secp_verify")
    LAUNCHES[variant("secp_verify_batch", glv, recover)] += 1
    return out.bool()


def hash_verify_batch(sha_blocks, sha_active, kec_blocks, kec_active, qx, qy, q_valid, r, s,
                      is_eth, v, is_rec, addr, gtab, *, glv=True, recover=False) -> torch.Tensor:
    """The fused hash-to-verdict check: K12<glv, recover> on CUDA tensors,
    the plain version on CPU tensors.  ``sha_blocks`` / ``sha_active``
    are every row's message SHA-256-padded (ops/sha2.pad_messages_sha256),
    ``kec_blocks`` / ``kec_active`` Keccak-padded (ops/keccak.
    pad_messages_keccak); the rest as verify_batch without e."""
    dev = _check_rows(qx, qy, q_valid, r, s, is_eth, v, is_rec, addr, gtab)
    n = qx.shape[0]
    sha2._check_sha256_args(sha_blocks, sha_active)
    K._check_args(kec_blocks, kec_active)
    if sha_blocks.shape[0] != n or kec_blocks.shape[0] != n or sha_blocks.device != dev or kec_blocks.device != dev:
        raise _build.LaunchRefused("the block arrays must hold one row per signature, on the rows' device")
    if dev.type == "cpu":
        return hash_verify_batch_plain(sha_blocks, sha_active, kec_blocks, kec_active, qx, qy, q_valid,
                                       r, s, is_eth, v, is_rec, addr, gtab, glv=glv, recover=recover)
    if dev.type != "cuda":
        raise _build.LaunchRefused(f"unsupported device {dev}")
    sha_blocks, kec_blocks = _c(sha_blocks), _c(kec_blocks)
    if sha_blocks.data_ptr() % 4 or kec_blocks.data_ptr() % 8:
        raise _build.LaunchRefused("K12 reads 4-byte SHA-256 words and 8-byte Keccak lanes: align the block arrays")
    out = torch.empty((n,), dtype=torch.uint8, device=dev)
    # every argument bound to a name until the launch has been enqueued
    args = [sha_blocks, _c(sha_active, torch.int32), kec_blocks, _c(kec_active, torch.int32),
            _c(qx), _c(qy), _c(q_valid, torch.uint8), _c(r), _c(s), _c(is_eth, torch.uint8),
            _c(v), _c(is_rec, torch.uint8), _c(addr), _c(gtab), out]
    p = [a.data_ptr() for a in args]
    with torch.cuda.device(dev):
        code = _build.lib("secp").k12_secp_hash_verify(
            p[0], p[1], sha_blocks.shape[1], p[2], p[3], kec_blocks.shape[1], *p[4:],
            n, int(bool(glv)), int(bool(recover)), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "k12_secp_hash_verify")
    LAUNCHES[variant("secp_hash_verify", glv, recover)] += 1
    return out.bool()
