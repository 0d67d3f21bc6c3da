"""Batched BLS12-381 G1 key validation and pubkey aggregation on the card
— K13, K14 and K15, the port of cometbft_tpu/ops/bls381.py.

Kernels (CUDA C++ in csrc/bls.cu; per-row arithmetic in csrc/bls381.cuh):

  K13 ``validate_g1``            replaces cometbft_tpu/ops/bls381.py:346
  K14 ``aggregate_g1``           replaces :273 (a tile stage, then a
      finishing stage: two launches a call)
  K15 ``validate_aggregate_g1``  replaces :365 (K13's row body, then
      a tile tree in K14's order over the rows that validated; K14's
      finishing stage completes the sum)

What they compute is the JAX package's: KeyValidate of affine pubkeys
(on the curve y^2 = x^3 + 4, [r]P = infinity by double-and-add over the
fixed bits of the group order r, and the host decode's mask; a row the
host rejected never reads True), and the sum of N Jacobian points.  Rows
of K15 that do not validate enter the sum as the identity.

Layout: a field element is 12 little-endian 32-bit words of its
Montgomery form with R = 2^384 — the same R as the JAX package's 32 x
12-bit limbs, so the Montgomery value is the same number and
convert.bls_words_from_jax_limbs is a bit repack.  Values are canonical
([0, p)).  A point is (X, Y, Z) Jacobian, x = X / Z^2, y = Y / Z^3,
infinity Z = 0; the identity the kernels write is (R mod p, R mod p, 0).

Summation order: K14's tile stage sums tiles of ``TILE`` rows in a
binary tree (row t + s into row t, s = TILE / 2, ..., 1), its finishing
stage folds tile partial j into lane j mod ``FINISH`` in order and sums
the lanes in the same tree (each add on a group of ``GROUP`` threads,
csrc/bls381_group.cuh, with g1_add's values).  Jacobian coordinates
depend on that order (the JAX package pairs rows i and i + half), so
parity with the JAX package is on the affine point; the plain versions
follow the kernels' order, so kernel and plain agree word for word on
the triple too.

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors; ``LAUNCHES`` counts kernel launches.
The plain versions work on 24 x 16-bit limbs in int64 tensors,
canonical after every operation, and take the kernels' branches as
selects.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._device import resolve_device

NWORDS = 12
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R_ORDER = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
R_MONT = 1 << 384
R_INV = pow(R_MONT, P - 2, P)
P_INV32 = (-pow(P, -1, 1 << 32)) % (1 << 32)  # -p^-1 mod 2^32, the CIOS multiplier
TILE = 32  # rows of one block of K14's and K15's tile stage
FINISH = 256  # lanes of K14's finishing stage
GROUP = 4  # threads that share one add of K14's trees (csrc/bls.cu BLS_GROUP)
FINISH_GROUPS = 128  # groups of K14's finishing stage (csrc/bls.cu BLS_FINISH_GROUPS)
PT_WORDS = 3 * NWORDS

LAUNCHES = {
    "validate_g1": 0,  # K13
    "aggregate_g1": 0,  # K14, tile stage
    "aggregate_g1_finish": 0,  # K14, finishing stage (after K14's or K15's tile stage)
    "validate_aggregate_g1": 0,  # K15
}


def to_mont(x: int) -> int:
    return x * R_MONT % P


def from_mont(x: int) -> int:
    return x * R_INV % P


ONE_M = to_mont(1)
B_M = to_mont(4)  # the curve constant b = 4
R_BITS = [b == "1" for b in bin(R_ORDER)[2:]]  # most significant first; R_BITS[0] is set


def header_constants() -> dict[str, int]:
    """The values csrc/bls381.cuh carries as word literals (held to these
    by tests/test_torch_bls_ops.py)."""
    return {"BLS_P": P, "BLS_ONE_M": ONE_M, "BLS_B_M": B_M, "BLS_R": R_ORDER, "BLS_PINV": P_INV32}


# ------------------------------------------------------- host packing


def ints_to_words_np(vals) -> np.ndarray:
    """Field ints (< 2^384, already in the Montgomery domain) -> (N, 12)
    int32 little-endian words: one byte view of the 48-byte encodings
    (the counterpart of cometbft_tpu/ops/bls381.py:401 ints_to_limbs_np)."""
    n = len(vals)
    if n == 0:
        return np.zeros((0, NWORDS), dtype=np.int32)
    raw = b"".join(int(v).to_bytes(48, "little") for v in vals)
    return np.frombuffer(raw, dtype="<i4").reshape(n, NWORDS).copy()


def words_to_ints(w) -> list[int]:
    """(N, 12) int32 words (tensor or array) -> the ints they hold."""
    a = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    a = np.ascontiguousarray(a.astype(np.int32)).reshape(-1, NWORDS)
    return [int.from_bytes(row.tobytes(), "little") for row in a]


def pack_affine(points):
    """Affine (x, y) int pairs (None = invalid / infinity) -> numpy
    (X, Y) (N, 12) int32 Montgomery words and valid (N,) bool; None rows
    are zero words (the counterpart of :421 _pack_affine, without the
    power-of-two padding: the kernels take any N)."""
    n = len(points)
    rows = [i for i, a in enumerate(points) if a is not None]
    X = np.zeros((n, NWORDS), dtype=np.int32)
    Y = np.zeros((n, NWORDS), dtype=np.int32)
    valid = np.zeros((n,), dtype=bool)
    if rows:
        X[rows] = ints_to_words_np([to_mont(points[i][0]) for i in rows])
        Y[rows] = ints_to_words_np([to_mont(points[i][1]) for i in rows])
        valid[rows] = True
    return X, Y, valid


def jac_to_affine_host(Xa, Ya, Za):
    """One (12,) Jacobian word triple -> affine int pair, or None for
    infinity; the one inversion runs on the host (:448
    _jac_to_affine_host)."""
    xi, yi, zi = (from_mont(v % P) for v in words_to_ints(torch.stack([Xa, Ya, Za]).reshape(3, NWORDS)))
    if zi == 0:
        return None
    z_inv = pow(zi, P - 2, P)
    z2 = z_inv * z_inv % P
    return (xi * z2 % P, yi * z2 % P * z_inv % P)


# ------------------------------------------------------- plain: limbs
# (N, 24) int64 tensors of 16-bit digits, least significant first.

_L = 2 * NWORDS
_M16 = 0xFFFF
_CONSTS: dict[tuple, torch.Tensor] = {}


def _limbs_of(x: int, n: int = _L) -> list[int]:
    return [(x >> (16 * i)) & _M16 for i in range(n)]


def _const(x: int, dev, n: int = _L) -> torch.Tensor:
    key = (x, n, str(dev))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(_limbs_of(x, n), dtype=torch.int64, device=dev)
        _CONSTS[key] = t
    return t


_PINV384 = (-pow(P, -1, R_MONT)) % R_MONT  # -p^-1 mod 2^384


def _from_words(w: torch.Tensor) -> torch.Tensor:
    """(..., 12) int32 words -> (..., 24) int64 digits."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & _M16, w >> 16], dim=-1).reshape(w.shape[:-1] + (_L,))


def _to_words(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[:-1] + (NWORDS, 2))
    w = x[..., 0] | (x[..., 1] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Exact carries: columns 0..L-2 become digits in [0, 2^16), the last
    column takes what is carried out of them (negative when the value
    is)."""
    while True:
        c = x >> 16
        c[:, -1] = 0
        if not bool(c.any()):
            return x
        x = x - (c << 16)
        x[:, 1:] += c[:, :-1]


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, width - x.shape[1]))


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, A) x (N, B) digits (or a (B,) constant) -> (N, A + B - 1)
    product columns."""
    if b.dim() == 1:
        b = b[None]
    A, B = a.shape[1], b.shape[1]
    outer = a[:, :, None] * b[:, None, :]
    flat = torch.nn.functional.pad(outer, (0, A)).reshape(outer.shape[0], A * (A + B))
    return flat[:, : A * (A + B - 1)].reshape(outer.shape[0], A, A + B - 1).sum(1)


def _where(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(c[:, None], a, b)


def _is_zero(x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(1)


def _eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(1)


def _lt_p(x: torch.Tensor) -> torch.Tensor:
    """x < p for canonical digits of any value < 2^384."""
    return _norm(_pad(x - _const(P, x.device), _L + 1))[:, -1] < 0


def _cond_sub_p(s: torch.Tensor) -> torch.Tensor:
    """Digits (N, 25) of a value < 2p -> [0, p), 24 digits."""
    d = _norm(s - _const(P, s.device, _L + 1))
    return _where(d[:, -1] >= 0, d[:, :_L], s[:, :_L])


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a b R^-1 mod p of canonical digits, canonical."""
    dev = a.device
    t = _norm(_pad(_conv(a, b), 2 * _L))
    m = _norm(_pad(_conv(t[:, :_L], _const(_PINV384, dev))[:, :_L], _L + 1))[:, :_L]
    mp = _norm(_pad(_conv(m, _const(P, dev)), 2 * _L))
    # t + m p = 0 mod R: its low half carries exactly 1 into the high
    # half unless t's low half is 0 (then m = 0)
    carry = (~_is_zero(t[:, :_L])).to(torch.int64)
    u = t[:, _L:] + mp[:, _L:]
    u[:, 0] += carry
    return _cond_sub_p(_norm(_pad(u, _L + 1)))


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub_p(_norm(_pad(a + b, _L + 1)))


def _sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = _norm(_pad(a - b, _L + 1))
    dp = _norm(_pad(d[:, :_L] + _const(P, a.device), _L + 1))
    return _where(d[:, -1] < 0, dp[:, :_L], d[:, :_L])


def _ident(like: torch.Tensor):
    one = _const(ONE_M, like.device).expand_as(like)
    return one, one, torch.zeros_like(like)


def _double(X, Y, Z):
    """dbl-2009-l (a = 0), as csrc/bls381.cuh g1_double; Z = 0 gives the
    identity (R, R, 0)."""
    A, B = _mul(X, X), _mul(Y, Y)
    C = _mul(B, B)
    XB = _add(X, B)
    D = _sub(_mul(XB, XB), _add(A, C))
    D = _add(D, D)
    E = _add(_add(A, A), A)
    X3 = _sub(_mul(E, E), _add(D, D))
    C8 = _add(C, C)
    C8 = _add(C8, C8)
    C8 = _add(C8, C8)
    Y3 = _sub(_mul(E, _sub(D, X3)), C8)
    Z3 = _mul(_add(Y, Y), Z)
    inf = _is_zero(Z)
    return tuple(_where(inf, i, v) for i, v in zip(_ident(X), (X3, Y3, Z3)))


def _add_pts(p1, p2):
    """The complete sum of csrc/bls381.cuh g1_add, its branches as
    selects: an infinity operand gives the other point (Z1 = 0 first),
    equal points the doubling, opposite points the identity (R, R, 0)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    z1z, z2z = _mul(Z1, Z1), _mul(Z2, Z2)
    U1, U2 = _mul(X1, z2z), _mul(X2, z1z)
    S1 = _mul(_mul(Y1, Z2), z2z)
    S2 = _mul(_mul(Y2, Z1), z1z)
    H, Rr = _sub(U2, U1), _sub(S2, S1)
    H2 = _add(H, H)
    I = _mul(H2, H2)
    J = _mul(H, I)
    r2 = _add(Rr, Rr)
    V = _mul(U1, I)
    X3 = _sub(_mul(r2, r2), _add(J, _add(V, V)))
    S1J = _mul(S1, J)
    Y3 = _sub(_mul(r2, _sub(V, X3)), _add(S1J, S1J))
    Z3 = _mul(_mul(Z1, Z2), H)
    Z3 = _add(Z3, Z3)
    out = (X3, Y3, Z3)
    inf1, inf2 = _is_zero(Z1), _is_zero(Z2)
    hz, rz = _is_zero(H), _is_zero(Rr)
    same = hz & rz & ~inf1 & ~inf2
    if bool(same.any()):
        out = tuple(_where(same, d, v) for d, v in zip(_double(X1, Y1, Z1), out))
    opp = hz & ~rz
    out = tuple(_where(opp, i, v) for i, v in zip(_ident(X1), out))
    out = tuple(_where(inf2, a, v) for a, v in zip(p1, out))
    return tuple(_where(inf1, b, v) for b, v in zip(p2, out))


def _on_curve(x, y):
    """x, y canonical and y^2 == x^3 + 4 (Montgomery digits)."""
    lhs = _mul(y, y)
    rhs = _add(_mul(_mul(x, x), x), _const(B_M, x.device).expand_as(x))
    return _lt_p(x) & _lt_p(y) & _eq(lhs, rhs)


def _validate(x, y, valid):
    """K13's row body over the batch: on-curve, then [r]P by left-to-right
    double-and-add from acc = P over the bits of r after the leading one
    (254 doublings, 133 mixed adds), then Z == 0."""
    oncurve = valid & _on_curve(x, y)
    one = _const(ONE_M, x.device).expand_as(x)
    acc = (x, y, one)
    for bit in R_BITS[1:]:
        acc = _double(*acc)
        if bit:
            acc = _add_pts(acc, (x, y, one))
    return oncurve & _is_zero(acc[2])


def _tree(pts, width: int):
    """Sum each group of ``width`` consecutive rows (width a power of two)
    in the kernels' tree: row t + s into row t, s = width / 2, ..., 1."""
    g = pts[0].shape[0] // width
    cur = [c.reshape(g, width, _L) for c in pts]
    s = width // 2
    while s >= 1:
        a = tuple(c[:, :s].reshape(-1, _L) for c in cur)
        b = tuple(c[:, s : 2 * s].reshape(-1, _L) for c in cur)
        cur = [c.reshape(g, s, _L) for c in _add_pts(a, b)]
        s //= 2
    return tuple(c.reshape(g, _L) for c in cur)


def _pad_rows(pts, rows: int):
    n = pts[0].shape[0]
    if n == rows:
        return pts
    ident = _ident(torch.zeros((rows - n, _L), dtype=torch.int64, device=pts[0].device))
    return tuple(torch.cat([c, i]) for c, i in zip(pts, ident))


def _aggregate(pts):
    """K14's two stages: tile sums of TILE rows, then the finishing
    stage's FINISH lanes (lane t folds partials t, t + FINISH, ...)
    summed in the tree.  -> one (1, 24) digit triple."""
    n = pts[0].shape[0]
    g = max(1, -(-n // TILE))
    part = _tree(_pad_rows(pts, g * TILE), TILE)
    folds = -(-g // FINISH)
    part = _pad_rows(part, folds * FINISH)
    acc = _ident(torch.zeros((FINISH, _L), dtype=torch.int64, device=pts[0].device))
    for j in range(folds):
        acc = _add_pts(acc, tuple(c[j * FINISH : (j + 1) * FINISH] for c in part))
    return _tree(acc, FINISH)


# ------------------------------------------- plain versions (words in, words out)


def _w(t: torch.Tensor) -> torch.Tensor:
    return _from_words(t.reshape(-1, NWORDS))


def mul(a, b):
    """Plain Montgomery product of (N, 12) int32 canonical words (the
    port's counterpart of the JAX ``mul``)."""
    return _to_words(_mul(_w(a), _w(b)))


def add(a, b):
    return _to_words(_add(_w(a), _w(b)))


def sub(a, b):
    return _to_words(_sub(_w(a), _w(b)))


def g1_double(X, Y, Z):
    return tuple(_to_words(c) for c in _double(_w(X), _w(Y), _w(Z)))


def g1_add(X1, Y1, Z1, X2, Y2, Z2):
    return tuple(_to_words(c) for c in _add_pts((_w(X1), _w(Y1), _w(Z1)), (_w(X2), _w(Y2), _w(Z2))))


def g1_on_curve(X, Y):
    return _on_curve(_w(X), _w(Y))


def _g1_mul_order(X, Y, Z):
    """[r]P of Jacobian words by the JAX package's ladder (acc from the
    identity, a doubling and a conditional add per bit of r): the plain
    check of the same group law at other inputs than K13's."""
    pt = (_w(X), _w(Y), _w(Z))
    acc = _ident(pt[0])
    for bit in R_BITS:
        acc = _double(*acc)
        if bit:
            acc = _add_pts(acc, pt)
    return tuple(_to_words(c) for c in acc)


def validate_g1_plain(X, Y, valid) -> torch.Tensor:
    """Plain version of K13: (N,) bool."""
    return _validate(_w(X), _w(Y), valid.bool())


def aggregate_g1_plain(X, Y, Z):
    """Plain version of K14: the (12,) word triple of the sum (the
    identity (R, R, 0) for no rows)."""
    if X.shape[0] == 0:
        return _identity_words(X.device)
    return tuple(_to_words(c)[0] for c in _aggregate((_w(X), _w(Y), _w(Z))))


def validate_aggregate_g1_plain(X, Y, valid):
    """Plain version of K15 + K14's finishing stage: (ok, Xa, Ya, Za)."""
    if X.shape[0] == 0:
        return (valid.bool(),) + _identity_words(X.device)
    x, y = _w(X), _w(Y)
    ok = _validate(x, y, valid.bool())
    ident = _ident(x)
    pts = (_where(ok, x, ident[0]), _where(ok, y, ident[1]), _where(ok, ident[0], ident[2]))
    return (ok,) + tuple(_to_words(c)[0] for c in _aggregate(pts))


# ------------------------------------------------------------ wrappers


def _check(n, **arrays) -> torch.device:
    dev = None
    for name, (t, shape, dtypes) in arrays.items():
        if tuple(t.shape) != (n,) + shape or t.dtype not in dtypes:
            raise _build.LaunchRefused(f"{name} must be {(n,) + shape} of {dtypes}, got {tuple(t.shape)} {t.dtype}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise _build.LaunchRefused(f"{name} is on {t.device}, not {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise _build.LaunchRefused(f"unsupported device {dev}")
    return dev


_WORDS = ((NWORDS,), (torch.int32,))
_BOOL8 = ((), (torch.bool, torch.uint8))


def _c(t: torch.Tensor, dtype=None) -> torch.Tensor:
    return (t if dtype is None else t.to(dtype)).contiguous()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def launch_k13(X, Y, valid, ok, all_ok) -> None:
    """K13 into ``ok`` ((N,) uint8) and ``all_ok`` ((1,) uint8, set to 1
    by the caller); all CUDA tensors."""
    with torch.cuda.device(X.device):
        code = _build.lib("bls").k13_bls_validate(
            X.data_ptr(), Y.data_ptr(), valid.data_ptr(), ok.data_ptr(), all_ok.data_ptr(),
            X.shape[0], _stream(X.device))
    _build.check(code, "k13_bls_validate")
    LAUNCHES["validate_g1"] += 1


def _launch_finish(partials, g: int, triple) -> None:
    with torch.cuda.device(partials.device):
        code = _build.lib("bls").k14_bls_aggregate_finish(partials.data_ptr(), g, triple.data_ptr(),
                                                          _stream(partials.device))
    _build.check(code, "k14_bls_aggregate_finish")
    LAUNCHES["aggregate_g1_finish"] += 1


def launch_k14(X, Y, Z, partials, triple) -> None:
    """K14's two stages: tile partials into ``partials`` ((ceil(N /
    TILE), 36) int32 scratch), the sum into ``triple`` ((36,) int32)."""
    n = X.shape[0]
    with torch.cuda.device(X.device):
        code = _build.lib("bls").k14_bls_aggregate(X.data_ptr(), Y.data_ptr(), Z.data_ptr(),
                                                   partials.data_ptr(), n, _stream(X.device))
    _build.check(code, "k14_bls_aggregate")
    LAUNCHES["aggregate_g1"] += 1
    _launch_finish(partials, -(-n // TILE), triple)


def launch_k15(X, Y, valid, ok, all_ok, partials, triple) -> None:
    """K15 (ok bytes, all-ok byte, tile partials of the rows that
    validated), then K14's finishing stage into ``triple``."""
    n = X.shape[0]
    with torch.cuda.device(X.device):
        code = _build.lib("bls").k15_bls_validate_aggregate(
            X.data_ptr(), Y.data_ptr(), valid.data_ptr(), ok.data_ptr(), all_ok.data_ptr(),
            partials.data_ptr(), n, _stream(X.device))
    _build.check(code, "k15_bls_validate_aggregate")
    LAUNCHES["validate_aggregate_g1"] += 1
    _launch_finish(partials, -(-n // TILE), triple)


def _scratch(n: int, dev):
    return torch.empty((max(1, -(-n // TILE)), PT_WORDS), dtype=torch.int32, device=dev)


def validate_g1(X, Y, valid) -> torch.Tensor:
    """(N,) bool: on the curve, in the r-subgroup and host-valid — K13 on
    CUDA tensors, the plain version on CPU tensors.  X, Y: (N, 12) int32
    affine Montgomery words; valid: (N,) bool or uint8."""
    n = X.shape[0]
    dev = _check(n, X=(X,) + _WORDS, Y=(Y,) + _WORDS, valid=(valid,) + _BOOL8)
    if dev.type == "cpu":
        return validate_g1_plain(X, Y, valid)
    ok = torch.empty((n,), dtype=torch.uint8, device=dev)
    all_ok = torch.ones((1,), dtype=torch.uint8, device=dev)
    if n:
        launch_k13(_c(X), _c(Y), _c(valid, torch.uint8), ok, all_ok)
    return ok.bool()


def _identity_words(dev):
    w = torch.from_numpy(ints_to_words_np([ONE_M, ONE_M, 0])).to(dev)
    return w[0], w[1], w[2]


def aggregate_g1(X, Y, Z):
    """The sum of N Jacobian points (N, 12) int32 words -> its (12,) word
    triple: K14 on CUDA tensors, the plain version on CPU tensors."""
    n = X.shape[0]
    dev = _check(n, X=(X,) + _WORDS, Y=(Y,) + _WORDS, Z=(Z,) + _WORDS)
    if dev.type == "cpu":
        return aggregate_g1_plain(X, Y, Z)
    if n == 0:
        return _identity_words(dev)
    triple = torch.empty((PT_WORDS,), dtype=torch.int32, device=dev)
    launch_k14(_c(X), _c(Y), _c(Z), _scratch(n, dev), triple)
    return triple[:NWORDS], triple[NWORDS : 2 * NWORDS], triple[2 * NWORDS :]


def validate_aggregate_g1(X, Y, valid):
    """(ok (N,) bool, Xa, Ya, Za): K13's verdicts and the sum of the rows
    that validated — K15 and K14's finishing stage on CUDA tensors, the
    plain version on CPU tensors."""
    n = X.shape[0]
    dev = _check(n, X=(X,) + _WORDS, Y=(Y,) + _WORDS, valid=(valid,) + _BOOL8)
    if dev.type == "cpu":
        return validate_aggregate_g1_plain(X, Y, valid)
    if n == 0:
        return (torch.zeros((0,), dtype=torch.bool, device=dev),) + _identity_words(dev)
    ok = torch.empty((n,), dtype=torch.uint8, device=dev)
    all_ok = torch.ones((1,), dtype=torch.uint8, device=dev)
    triple = torch.empty((PT_WORDS,), dtype=torch.int32, device=dev)
    launch_k15(_c(X), _c(Y), _c(valid, torch.uint8), ok, all_ok, _scratch(n, dev), triple)
    return ok.bool(), triple[:NWORDS], triple[NWORDS : 2 * NWORDS], triple[2 * NWORDS :]


# ------------------------------------------------------------ device routes
# One host-to-device copy of the packed rows and one device-to-host copy
# of everything the host reads back, on ``device`` ("cuda" by default;
# "cpu" runs the plain versions on the same packing).


def _stage(dev, words, flags=None):
    """Numpy (N, 12) int32 word arrays and optional (N,) flags -> device
    views of one copied buffer: each word array, then the flag bytes."""
    n = words[0].shape[0]
    cuda = dev.type == "cuda"
    nw = 4 * NWORDS * n
    host = torch.empty((len(words) * nw + (0 if flags is None else n),), dtype=torch.uint8, pin_memory=cuda)
    h = host.numpy()
    for k, w in enumerate(words):
        h[k * nw : (k + 1) * nw] = np.ascontiguousarray(w, dtype=np.int32).view(np.uint8).reshape(-1)
    if flags is not None:
        h[len(words) * nw :] = flags
    flat = host.to(dev, non_blocking=True) if cuda else host
    out = [flat[k * nw : (k + 1) * nw].view(torch.int32).view(n, NWORDS) for k in range(len(words))]
    if flags is not None:
        out.append(flat[len(words) * nw :])
    return out


def validate_pubkeys_device(points, device="cuda") -> list[bool]:
    """Batched on-curve + subgroup validation of affine (x, y) int pairs
    (None rows = host-rejected, always False) on ``device``: one K13
    launch (:461 validate_pubkeys_device)."""
    dev = resolve_device(device)
    if not points:
        return []
    X, Y, valid = pack_affine(points)
    return validate_g1(*_stage(dev, (X, Y), valid)).tolist()


def validate_aggregate_device(points, device="cuda"):
    """The fused FastAggregateVerify data plane on ``device``: K15 and
    K14's finishing stage.  Returns (per-row ok list, the aggregate of
    the rows that validated as an affine pair, or None for infinity)
    (:480 validate_aggregate_device)."""
    dev = resolve_device(device)
    n = len(points)
    if n == 0:
        return [], None
    X, Y, valid = pack_affine(points)
    X, Y, valid = _stage(dev, (X, Y), valid)
    if dev.type == "cpu":
        ok, Xa, Ya, Za = validate_aggregate_g1_plain(X, Y, valid)
        return ok.tolist(), jac_to_affine_host(Xa, Ya, Za)
    # one output buffer: the triple (144 bytes), the ok bytes, the all-ok byte
    out = torch.ones((4 * PT_WORDS + n + 1,), dtype=torch.uint8, device=dev)
    triple = out[: 4 * PT_WORDS].view(torch.int32)
    launch_k15(X, Y, valid, out[4 * PT_WORDS : -1], out[-1:], _scratch(n, dev), triple)
    host = out.cpu()
    t = host[: 4 * PT_WORDS].view(torch.int32)
    return (host[4 * PT_WORDS : -1].bool().tolist(),
            jac_to_affine_host(t[:NWORDS], t[NWORDS : 2 * NWORDS], t[2 * NWORDS :]))


def aggregate_pubkeys_device(points, device="cuda"):
    """Sum affine (x, y) int pairs (or compressed 48-byte keys) on
    ``device``: K14.  Returns the aggregate as an affine pair, or None
    for infinity (:502 aggregate_pubkeys_device).  None rows are
    skipped."""
    dev = resolve_device(device)
    pts = []
    for pk in points:
        if isinstance(pk, (bytes, bytearray)):
            from ..crypto import bls12381 as host_bls

            pk = host_bls._g1_decompress(bytes(pk))
        if pk is not None:
            pts.append(pk)
    if not pts:
        return None
    X, Y, _ = pack_affine(pts)
    one = np.broadcast_to(ints_to_words_np([ONE_M]), X.shape)
    return jac_to_affine_host(*aggregate_g1(*_stage(dev, (X, Y, one))))
