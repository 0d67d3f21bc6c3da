"""Edwards25519 group law in plain PyTorch (the plain versions behind
csrc/ge25519.cuh), and the uncached Straus verify built on it.

Points are tuples (X, Y, Z, T) of field tensors shaped (10, *batch)
(extended coordinates, a = -1, x = X/Z, y = Y/Z, T = XY/Z); affine Niels
entries are tuples (y+x, y-x, 2dxy); cached entries are tuples
(Y+X, Y-X, Z, 2dT).  The formulas, and where they carry to keep the
multiply's input contract, are the CUDA headers'.

Kernel (CUDA C++ in csrc/ed25519.cu, lane body in csrc/straus.cuh):

  K5 ``verify_batch``  replaces cometbft_tpu/ops/ed25519.py:339-410
                       (verify_prepared, and verify_batch after its
                       challenge hash, which is K2 of ops/sha2.py); a
                       group of threads_per_lane(n) threads a signature
                       lane shares each point operation
                       (csrc/ge25519_group.cuh), LANES_PER_BLOCK lanes a
                       block

``verify_batch`` launches K2 then K5 for CUDA tensors and runs the plain
chain for CPU tensors; ``LAUNCHES`` counts K5 launches.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import _build
from ..crypto import _ref25519 as ref
from . import field as F
from . import scalar, sha2

NWIN = 64  # radix-16 windows of a 256-bit scalar
NENT_A = 8  # cached entries j * (-A), j = 1..8 (signed digits of k)
NENT_B = 16  # B-window entries j * B, j = 0..15 (unsigned windows of s)

LANES_PER_BLOCK = 16  # K5's lanes a block (STRAUS_LANES in csrc/straus.cuh)
G4_MAX_LANES = 12_288  # K5 runs 4 threads a lane up to this batch, 2 above (STRAUS_G4_MAX_LANES)


def threads_per_lane(n: int) -> int:
    """The group width K5 launches for an n-lane batch."""
    return 4 if n <= G4_MAX_LANES else 2


LAUNCHES = {"verify_batch": 0}


def identity(batch, device):
    z = F.zero(batch, device)
    o = F.one(batch, device)
    return (z, o, o.clone(), z.clone())


def neg(p):
    x, y, z, t = p
    return (-x, y, z, -t)


def add(p, q):
    """Unified addition (add-2008-hwcd-3)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = F.mul(y1 - x1, y2 - x2)
    b = F.mul(y1 + x1, y2 + x2)
    c = F.mul(F.mul(t1, F.named("d2", t1)), t2)
    d = F.mul(z1 + z1, z2)
    e, f, g, h = b - a, d - c, d + c, b + a
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def add_niels(p, n):
    """p + n for an affine Niels entry n = (y+x, y-x, 2dxy)."""
    x1, y1, z1, t1 = p
    ypx, ymx, t2d = n
    a = F.mul(y1 - x1, ymx)
    b = F.mul(y1 + x1, ypx)
    c = F.mul(t1, t2d)
    d = F.carry(z1 + z1)
    e, f, g, h = b - a, d - c, d + c, b + a
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def double(p):
    """dbl-2008-hwcd with a = -1 (E = 2XY, G = Y^2 - X^2,
    F = 2Z^2 - G, H = X^2 + Y^2)."""
    x, y, z, _ = p
    xx, yy, zz = F.square(x), F.square(y), F.square(z)
    h = xx + yy
    g = yy - xx
    e = F.carry(F.square(x + y) - h)
    f = F.carry(zz + zz - g)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def select(cond, p, q):
    return tuple(F.select(cond, a, b) for a, b in zip(p, q))


def is_identity(p):
    """x == 0 and y == z."""
    x, y, z, _ = p
    return F.is_zero(x) & F.eq(y, z)


def decompress(enc: torch.Tensor):
    """(..., 32) uint8 -> (point with batch shape ..., ok (...) bool).

    ZIP-215: y is the low 255 bits taken mod p (non-canonical y
    accepted), x = 0 with sign 1 accepted; ok is False when no square
    root exists (the point is then arbitrary but well formed)."""
    sign = (enc[..., 31].to(torch.int64) >> 7) == 1
    y = F.from_bytes(enc)
    one = F.one(y.shape[1:], y.device)
    yy = F.square(y)
    u = yy - one
    v = F.mul(yy, F.named("d", yy)) + one
    v3 = F.mul(F.square(v), v)
    v7 = F.mul(F.square(v3), v)
    x = F.mul(F.mul(u, v3), F.pow_p58(F.mul(u, v7)))
    vxx = F.mul(v, F.square(x))
    ok_direct = F.eq(vxx, u)
    ok_flipped = F.eq(vxx, -u)
    x = F.select(ok_flipped, F.mul(x, F.named("sqrtm1", x)), x)
    x = F.select(F.is_negative(x) != sign, -x, x)
    return (x, y, one, F.mul(x, y)), ok_direct | ok_flipped


def niels_from_words(w: torch.Tensor, negate=None):
    """(..., 3, 8) canonical words -> Niels tuple of (10, ...) limbs;
    where ``negate`` is set, the entry of the negated point."""
    ypx = F.from_words(w[..., 0, :])
    ymx = F.from_words(w[..., 1, :])
    t2d = F.from_words(w[..., 2, :])
    if negate is None:
        return ypx, ymx, t2d
    return (
        F.select(negate, ymx, ypx),
        F.select(negate, ypx, ymx),
        F.select(negate, -t2d, t2d),
    )



def add_cached(p, c):
    """p + c for a cached entry c = (Y+X, Y-X, Z, 2dT) (8 multiplies;
    D = (2 Z1) Z2 is a multiply output, so F and G need no carry)."""
    x1, y1, z1, t1 = p
    ypx, ymx, z2, t2d = c
    a = F.mul(y1 - x1, ymx)
    b = F.mul(y1 + x1, ypx)
    cc = F.mul(t1, t2d)
    d = F.mul(z1 + z1, z2)
    e, f, g, h = b - a, d - cc, d + cc, b + a
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def to_cached(p):
    """Extended -> cached (Y+X, Y-X, Z, 2dT); Y+X and Y-X stay LOOSE."""
    x, y, z, t = p
    return (y + x, y - x, z, F.mul(t, F.named("d2", t)))


# ------------------------------------------------------------ host tables


def _words(vals: list[int]) -> np.ndarray:
    """Field elements (ints in [0, p)) -> (n, 8) uint32 LE words."""
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").reshape(-1, 8).astype(np.uint32)


def _batch_invert(zs: list[int]) -> list[int]:
    """Montgomery's trick: every 1/z with one modular inversion."""
    P = ref.P
    prefix = [1]
    for z in zs:
        prefix.append(prefix[-1] * z % P)
    inv = pow(prefix[-1], P - 2, P)
    out = [0] * len(zs)
    for k in range(len(zs) - 1, -1, -1):
        out[k] = inv * prefix[k] % P
        inv = inv * zs[k] % P
    return out


def niels_words_host(points: list[tuple]) -> np.ndarray:
    """Extended points (host ints) -> (n, 3, 8) uint32 canonical affine
    Niels words (y+x, y-x, 2dxy)."""
    P = ref.P
    inv_z = _batch_invert([p[2] for p in points])
    vals = []
    for (X, Y, _, _), iz in zip(points, inv_z):
        x, y = X * iz % P, Y * iz % P
        vals += [(y + x) % P, (y - x) % P, x * y % P * ref.D2 % P]
    return _words(vals).reshape(-1, 3, 8)


def build_b_window() -> np.ndarray:
    """(16, 3, 8) uint32: entry j is j * B in canonical affine Niels
    (entry 0 is the identity (1, 1, 0)); the counterpart of
    cometbft_tpu/ops/ed25519.py:276 _build_base_window_table, built from
    the host bigint group law."""
    points = [ref.IDENT, ref.BASE]
    for _ in range(2, NENT_B):
        points.append(ref.pt_add(points[-1], ref.BASE))
    return niels_words_host(points)


_B_WINDOW: dict[str, torch.Tensor] = {}
_B_WINDOW_MTX = threading.Lock()


def b_window(device) -> torch.Tensor:
    """The B-window table as (16, 3, 8) int32 words on ``device`` (one
    copy per device)."""
    key = str(torch.device(device))
    with _B_WINDOW_MTX:
        t = _B_WINDOW.get(key)
        if t is None:
            t = torch.from_numpy(build_b_window().view(np.int32).copy()).to(device)
            _B_WINDOW[key] = t
        return t


# ---------------------------------------------------------- Straus (K5)


def build_var_table(a):
    """The window table of a point: cached entries j * a for j = 1..8,
    stacked on a new axis 1 of every coordinate, (10, 8, *batch) (the
    counterpart of cometbft_tpu/ops/ed25519.py:306, which stores
    j = 0..15 for unsigned windows).  1 doubling and 6 additions."""
    c1 = to_cached(a)
    entries = [c1]
    acc = double(a)
    entries.append(to_cached(acc))
    for _ in range(2, NENT_A):
        acc = add_cached(acc, c1)
        entries.append(to_cached(acc))
    return tuple(torch.stack([e[c] for e in entries], dim=1) for c in range(4))


def lookup_point(table, digit: torch.Tensor):
    """Signed digit d in [-8, 8] (batch,) -> the cached entry d * a from
    ``build_var_table``: entry |d| - 1, negated where d < 0 (swap Y+X and
    Y-X, negate 2dT), the identity (1, 1, 1, 0) where d = 0."""
    n = digit.shape[0]
    lanes = torch.arange(n, device=digit.device)
    idx = (digit.abs() - 1).clamp(min=0)
    ypx, ymx, z, t2d = (c[:, idx, lanes] for c in table)
    neg = digit < 0
    ypx, ymx, t2d = F.select(neg, ymx, ypx), F.select(neg, ypx, ymx), F.select(neg, -t2d, t2d)
    zero = digit == 0
    one, nil = F.one((n,), digit.device), F.zero((n,), digit.device)
    return (
        F.select(zero, one, ypx), F.select(zero, one, ymx),
        F.select(zero, one, z), F.select(zero, nil, t2d),
    )


def verify_prepared(a_enc, r_enc, s_windows, k_digits, s_ok) -> torch.Tensor:
    """Plain version of K5's Straus chain (cometbft_tpu/ops/ed25519.py:339).

    a_enc, r_enc (n, 32) uint8; s_windows (64, n) unsigned 4-bit windows
    of s, most significant first; k_digits (64, n) signed radix-16 digits
    of k = H(R, A, M) mod L in [-8, 7], most significant first; s_ok (n,)
    bool.  Returns (n,) bool: [8](s B + k (-A) - R) == identity, with
    A valid, R decodable and s_ok."""
    n = a_enc.shape[0]
    dev = a_enc.device
    a_pt, a_ok = decompress(a_enc)
    r_pt, r_ok = decompress(r_enc)
    table = build_var_table(neg(a_pt))
    bwin = b_window(dev)
    acc = identity((n,), dev)
    for i in range(NWIN):
        for _ in range(4):
            acc = double(acc)
        acc = add_cached(acc, lookup_point(table, k_digits[i]))
        acc = add_niels(acc, niels_from_words(bwin[s_windows[i]]))
    acc = add(acc, neg(r_pt))
    for _ in range(3):
        acc = double(acc)
    return is_identity(acc) & a_ok & r_ok & s_ok


def verify_digest_plain(a_enc, r_enc, s_bytes, digest) -> torch.Tensor:
    """Plain version of K5: the windows of s and k = digest mod L, then
    ``verify_prepared``."""
    k = scalar.reduce_mod_l(digest)
    k_digits = scalar.signed_digits_radix16(k).flip(0)
    return verify_prepared(
        a_enc, r_enc, scalar.bytes_to_windows(s_bytes), k_digits, scalar.s_lt_l(s_bytes)
    )


def _check_rows(n, **arrays) -> None:
    for name, (t, width) in arrays.items():
        if t.dtype != torch.uint8 or t.shape != (n, width):
            raise _build.LaunchRefused(f"{name} must be ({n}, {width}) uint8")


def verify_digest(a_enc, r_enc, s_bytes, digest) -> torch.Tensor:
    """K5 on the challenge digests: (n,) bool verdicts.  a_enc, r_enc,
    s_bytes (n, 32) uint8, digest (n, 64) uint8 = SHA-512(R || A || M)."""
    n = a_enc.shape[0]
    _check_rows(n, a_enc=(a_enc, 32), r_enc=(r_enc, 32), s_bytes=(s_bytes, 32),
                digest=(digest, 64))
    devs = {t.device for t in (a_enc, r_enc, s_bytes, digest)}
    if len(devs) != 1:
        raise _build.LaunchRefused(f"arguments on several devices: {devs}")
    dev = a_enc.device
    if dev.type == "cpu":
        return verify_digest_plain(a_enc, r_enc, s_bytes, digest)
    if dev.type != "cuda":
        raise _build.LaunchRefused(f"unsupported device {dev}")
    out = torch.empty((n,), dtype=torch.uint8, device=dev)
    launch_k5(a_enc.contiguous(), r_enc.contiguous(), s_bytes.contiguous(),
              digest.contiguous(), b_window(dev), out)
    return out.view(torch.bool)


def launch_k5(a_enc, r_enc, s_bytes, digest, bwin, out) -> None:
    """K5 into a preallocated (n,) uint8 output on the current stream."""
    n = a_enc.shape[0]
    if n == 0:
        return
    with torch.cuda.device(a_enc.device):
        code = _build.lib("ed25519").k5_verify_batch(
            a_enc.data_ptr(), r_enc.data_ptr(), s_bytes.data_ptr(), digest.data_ptr(),
            bwin.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(a_enc.device).cuda_stream,
        )
    _build.check(code, "k5_verify_batch")
    LAUNCHES["verify_batch"] += 1


def verify_batch(a_enc, r_enc, s_bytes, msg_blocks, msg_active) -> torch.Tensor:
    """Uncached batch verification (cometbft_tpu/ops/ed25519.py:380).

    a_enc, r_enc, s_bytes (n, 32) uint8; msg_blocks (n, nb, 128) uint8
    SHA-512-padded R || A || M (ops/sha2.pad_messages_sha512); msg_active
    (n,) int32 live block counts.  Returns (n,) bool.  On the card: K2
    (the challenge hash) then K5; on the CPU their plain versions."""
    digest = sha2.sha512_blocks(msg_blocks, msg_active)
    return verify_digest(a_enc, r_enc, s_bytes, digest)
