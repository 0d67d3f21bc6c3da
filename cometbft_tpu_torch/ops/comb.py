"""Comb-cached Ed25519 verification: the validator-set fast path.

For commit verification the pubkeys are known long in advance, so each
validator's comb table T[i][e] = (e+1) * 16^i * (-A), i < 64, e < 8
(signed digits: a negative digit negates the entry, and the zero digit
needs no entry), is built once per validator set and kept on the card.
A shared radix-4096 comb covers the base point: B_TAB[i][j] =
j * 4096^i * B.  A verification then needs no doublings and no per-
signature table build:

    acc = sum_i T[i][k_i] + sum_i B_TAB[i][s_i] - R,   check [8]acc = 0

Kernels (CUDA C++ in csrc/comb.cu):

  K3 ``build_a_tables``  replaces cometbft_tpu/ops/comb.py:74;
                         BUILD_THREADS_PER_KEY threads a validator
                         (csrc/comb_build.cuh), BUILD_KEYS_PER_BLOCK
                         validators a block
  K4 ``verify_cached``   replaces cometbft_tpu/ops/comb.py:484 (tree and
                         sequential accumulation alike) plus the packbits /
                         all-ok epilogue of models/comb_verifier.py:767;
                         THREADS_PER_LANE threads a signature lane
                         (csrc/comb_verify.cuh), LANES_PER_BLOCK lanes a
                         block

Each wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version below it for a CPU tensor; ``LAUNCHES`` counts kernel
launches.

Table layouts (uint32 words of canonical little-endian field elements;
see csrc/comb.cuh): A tables (V, 64, 8, 3, 8), validator-major, 48 KiB
per validator (~0.5 GB for 10,000 validators); B table (22, 4096, 3, 8),
8.7 MB.  The TPU package's (64, 9, 3, 22, V) int32 limbs and its f32
one-hot MXU select were TPU workarounds; ``convert`` maps between the two.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import _build
from ..crypto import _ref25519 as ref
from . import ed25519 as E
from . import field as F
from . import scalar

NPOS_A = 64  # radix-16 comb positions for the k * (-A) part
NENT_A = 8  # stored entries 1..8 (signed digits)
NPOS_B = 22  # radix-4096 comb positions for the s * B part
NENT_B = 4096
BUILD_THREADS_PER_KEY = 4  # K3's group (COMB_BUILD_G in csrc/comb_build.cuh)
BUILD_KEYS_PER_BLOCK = 8  # K3's validators a block (COMB_BUILD_KEYS)
THREADS_PER_LANE = 4  # K4's group (COMB_T in csrc/comb_verify.cuh)
LANES_PER_BLOCK = 32  # K4's lanes a block (COMB_LANES)

LAUNCHES = {"build_a_tables": 0, "verify_cached": 0}


# ------------------------------------------------------------ host builders


def _host_decompress_zip215(pk: bytes):
    """ZIP-215 decompression on host ints with exactly the kernels'
    semantics: non-canonical y accepted, x = 0 with sign 1 accepted,
    validity = the on-curve check.  Returns ((x, y, 1, xy), ok)."""
    P = ref.P
    enc = int.from_bytes(pk, "little")
    sign = (enc >> 255) & 1
    y = (enc & ((1 << 255) - 1)) % P
    u = (y * y - 1) % P
    v = (ref.D * y % P * y + 1) % P
    x = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    vxx = v * x % P * x % P
    flipped = vxx == (P - u) % P
    ok = vxx == u or flipped
    if flipped:
        x = x * ref.SQRT_M1 % P
    if (x & 1) != sign:
        x = (P - x) % P
    return (x, y, 1, x * y % P), ok


def build_a_tables_host(a_enc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact-bigint build of the A tables in the port's layout: the test
    oracle of K3 (a copy of cometbft_tpu/ops/comb.py:259
    build_a_tables_host, emitting canonical words instead of 12-bit
    limbs).  Invalid pubkeys build from the identity, as K3 does.

    (V, 32) uint8 -> (tables (V, 64, 8, 3, 8) uint32, valid (V,) bool).
    """
    a_enc = np.ascontiguousarray(np.asarray(a_enc, dtype=np.uint8))
    V = int(a_enc.shape[0])
    valid = np.zeros((V,), dtype=bool)
    points = []
    for v in range(V):
        pt, ok = _host_decompress_zip215(a_enc[v].tobytes())
        valid[v] = ok
        base = ref.pt_neg(pt) if ok else ref.IDENT
        for _ in range(NPOS_A):
            acc = base
            for e in range(NENT_A):
                points.append(acc)
                if e + 1 < NENT_A:
                    acc = ref.pt_add(acc, base)
            base = ref.pt_add(acc, acc)  # 16 * (16^i * (-A))
    tables = E.niels_words_host(points).reshape(V, NPOS_A, NENT_A, 3, 8)
    return tables, valid


_B_TABLE = None
_B_TABLE_MTX = threading.Lock()


def build_b_tables() -> np.ndarray:
    """(22, 4096, 3, 8) uint32: entry j of position i is j * 4096^i * B in
    canonical affine Niels (entry 0 is the identity (1, 1, 0)).  A
    constant built once per process on the host with exact integers
    (~90k point additions and one batch inversion)."""
    global _B_TABLE
    with _B_TABLE_MTX:
        if _B_TABLE is None:
            points = []
            base = ref.BASE
            for _ in range(NPOS_B):
                row = [ref.IDENT, base]
                for _j in range(2, NENT_B):
                    row.append(ref.pt_add(row[-1], base))
                points += row
                for _ in range(12):
                    base = ref.pt_add(base, base)
            _B_TABLE = E.niels_words_host(points).reshape(NPOS_B, NENT_B, 3, 8)
            _B_TABLE.setflags(write=False)
        return _B_TABLE


def adopt_b_tables(table: np.ndarray) -> None:
    """Install a B table that another process of this program built (a
    parent handing it to the ranks it spawns), so that each rank does not
    redo the same host arithmetic.  Its entries 0-2 of position 0 and
    entry 1 of position 1 are checked against a fresh computation."""
    global _B_TABLE
    table = np.asarray(table)
    if table.dtype != np.uint32 or table.shape != (NPOS_B, NENT_B, 3, 8):
        raise ValueError("a B table is (22, 4096, 3, 8) uint32")
    b4096 = ref.BASE
    for _ in range(12):
        b4096 = ref.pt_add(b4096, b4096)
    want = E.niels_words_host([ref.IDENT, ref.BASE, ref.pt_add(ref.BASE, ref.BASE), b4096])
    if not (np.array_equal(table[0, :3], want[:3]) and np.array_equal(table[1, 1], want[3])):
        raise ValueError("not the B table: its first entries differ from j * B")
    table = table.copy()
    table.setflags(write=False)
    with _B_TABLE_MTX:
        if _B_TABLE is None:
            _B_TABLE = table


def b_tables(device) -> torch.Tensor:
    """The B table as an int32 tensor (u32 bit patterns) on ``device``."""
    return torch.from_numpy(build_b_tables().view(np.int32).copy()).to(device)


def words_to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor of the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _check_pubs(a_enc: torch.Tensor) -> None:
    if a_enc.dtype != torch.uint8 or a_enc.dim() != 2 or a_enc.shape[1] != 32:
        raise ValueError("pubkeys must be (V, 32) uint8")


# ------------------------------------------------------------------ K3


def build_a_tables_plain(a_enc: torch.Tensor):
    """Plain version of K3: the same tables by batched group operations
    (the 64 position bases by repeated doubling, the 8 entries of every
    position by repeated addition, a two-level batch inversion)."""
    V = a_enc.shape[0]
    dev = a_enc.device
    pt, valid = E.decompress(a_enc)
    pt = E.select(valid, pt, E.identity((V,), dev))
    base = E.neg(pt)
    bases = [base]
    for _ in range(NPOS_A - 1):
        for _ in range(4):
            base = E.double(base)
        bases.append(base)
    bases = tuple(torch.stack([b[c] for b in bases], dim=1) for c in range(4))  # (10, 64, V)
    acc = bases
    entries = [acc]
    for _ in range(NENT_A - 1):
        acc = E.add(acc, bases)
        entries.append(acc)
    ext = tuple(torch.stack([e[c] for e in entries], dim=2) for c in range(4))  # (10, 64, 8, V)
    iz = _batch_invert_plain(ext[2])
    x, y = F.mul(ext[0], iz), F.mul(ext[1], iz)
    t2d = F.mul(F.mul(x, y), F.named("d2", x))
    words = torch.stack([F.to_words(y + x), F.to_words(y - x), F.to_words(t2d)], dim=-2)
    return words_to_i32(words.permute(2, 0, 1, 3, 4)).contiguous(), valid


def _batch_invert_plain(z: torch.Tensor) -> torch.Tensor:
    """1/z for (10, 64, 8, V) nonzero z: Montgomery's trick over the entry
    axis (batched over positions), then over the position axis, so only
    one (10, V) element goes through the inversion chain."""
    pre1 = [z[:, :, 0]]
    for e in range(1, NENT_A):
        pre1.append(F.mul(pre1[-1], z[:, :, e]))  # (10, 64, V)
    tot1 = pre1[-1]
    pre2 = [tot1[:, 0]]
    for i in range(1, NPOS_A):
        pre2.append(F.mul(pre2[-1], tot1[:, i]))  # (10, V)
    inv = F.invert(pre2[-1])
    inv_tot1 = [None] * NPOS_A
    for i in range(NPOS_A - 1, 0, -1):
        inv_tot1[i] = F.mul(inv, pre2[i - 1])
        inv = F.mul(inv, tot1[:, i])
    inv_tot1[0] = inv
    inv = torch.stack(inv_tot1, dim=1)  # (10, 64, V)
    out = [None] * NENT_A
    for e in range(NENT_A - 1, 0, -1):
        out[e] = F.mul(inv, pre1[e - 1])
        inv = F.mul(inv, z[:, :, e])
    out[0] = inv
    return torch.stack(out, dim=2)


def build_a_tables(a_enc: torch.Tensor):
    """(V, 32) uint8 compressed pubkeys -> (tables (V, 64, 8, 3, 8) int32
    words of canonical affine Niels, valid (V,) bool).  Runs once per
    validator set; invalid keys build from the identity."""
    _check_pubs(a_enc)
    if a_enc.device.type == "cpu":
        return build_a_tables_plain(a_enc)
    if a_enc.device.type != "cuda":
        raise ValueError(f"unsupported device {a_enc.device}")
    a_enc = a_enc.contiguous()
    V = a_enc.shape[0]
    dev = a_enc.device
    tables = torch.empty((V, NPOS_A, NENT_A, 3, 8), dtype=torch.int32, device=dev)
    valid = torch.empty((V,), dtype=torch.uint8, device=dev)
    launch_k3(a_enc, tables, valid)
    return tables, valid.bool()


def launch_k3(a_enc, tables, valid_u8) -> None:
    """K3 into preallocated outputs on the current stream: tables
    (V, 64, 8, 3, 8) int32 (16-byte aligned), valid (V,) uint8."""
    V = a_enc.shape[0]
    if V == 0:
        return
    if tables.data_ptr() % 16:
        raise ValueError("K3 writes table entries as 16-byte vectors: tables must be 16-byte aligned")
    code = _build.lib("comb").k3_build_a_tables(
        a_enc.data_ptr(), tables.data_ptr(), valid_u8.data_ptr(), V,
        torch.cuda.current_stream(a_enc.device).cuda_stream,
    )
    _build.check(code, "k3_build_a_tables")
    LAUNCHES["build_a_tables"] += 1


# ------------------------------------------------------------------ K4


def verify_cached_plain(tables, valid, payload, digest, b_tab) -> torch.Tensor:
    """Plain version of K4's per-lane verdict: (V,) bool
    [8](s B + k (-A) - R) == O and A valid, R decodable, s < L."""
    V = payload.shape[0]
    dev = payload.device
    r, s = payload[:, :32], payload[:, 32:64]
    k = scalar.reduce_mod_l(digest)
    kd = scalar.signed_digits_radix16(k)  # (64, V)
    s_ok = scalar.s_lt_l(s)
    sd = scalar.digits_radix4096(s)  # (22, V)
    r_pt, r_ok = E.decompress(r)

    lanes = torch.arange(V, device=dev)[None, :]
    pos = torch.arange(NPOS_A, device=dev)[:, None]
    ent = (kd.abs() - 1).clamp(min=0)
    sel_a = tables[lanes, pos, ent]  # (64, V, 3, 8)
    na = E.niels_from_words(sel_a, negate=kd < 0)
    ident = (F.one((V,), dev), F.one((V,), dev), F.zero((V,), dev))
    sel_b = b_tab[torch.arange(NPOS_B, device=dev)[:, None], sd]  # (22, V, 3, 8)
    nb = E.niels_from_words(sel_b)

    acc = E.identity((V,), dev)
    for i in range(NPOS_A):
        zero_digit = kd[i] == 0
        n = tuple(F.select(zero_digit, z, c[:, i]) for z, c in zip(ident, na))
        acc = E.add_niels(acc, n)
    for i in range(NPOS_B):
        acc = E.add_niels(acc, tuple(c[:, i] for c in nb))
    acc = E.add(acc, E.neg(r_pt))
    for _ in range(3):
        acc = E.double(acc)
    return E.is_identity(acc) & valid.bool() & r_ok & s_ok


def pack_verdicts(ok: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """[packbits(ok & live) | all(ok | ~live)] as one uint8 array, bits in
    numpy.packbits order (lane 0 is bit 7 of byte 0)."""
    V = ok.shape[0]
    bits = (ok & live).to(torch.int32)
    pad = (-V) % 8
    bits = torch.cat([bits, bits.new_zeros(pad)]).reshape(-1, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=ok.device)
    packed = (bits * weights).sum(dim=1).to(torch.uint8)
    all_ok = (ok | ~live).all().to(torch.uint8).reshape(1)
    return torch.cat([packed, all_ok])


def _check_verify_args(tables, valid, payload, digest, b_tab) -> None:
    V = payload.shape[0]
    if tables.dtype != torch.int32 or tables.shape != (V, NPOS_A, NENT_A, 3, 8):
        raise ValueError("tables must be (V, 64, 8, 3, 8) int32")
    if valid.shape != (V,):
        raise ValueError("valid must be (V,)")
    if payload.dtype != torch.uint8 or payload.dim() != 2 or payload.shape[1] < 68:
        raise ValueError("payload must be (V, 68 + maxm) uint8")
    if digest.dtype != torch.uint8 or digest.shape != (V, 64):
        raise ValueError("digest must be (V, 64) uint8")
    if b_tab.dtype != torch.int32 or b_tab.shape != (NPOS_B, NENT_B, 3, 8):
        raise ValueError("b_tab must be (22, 4096, 3, 8) int32")
    devs = {t.device for t in (tables, valid, payload, digest, b_tab)}
    if len(devs) != 1:
        raise ValueError(f"arguments on several devices: {devs}")


def verify_cached(tables, valid, payload, digest, b_tab) -> torch.Tensor:
    """Verdicts of every payload row against the cached tables, packed:
    ((V + 7) // 8 + 1,) uint8 = [packbits(ok & live) | all(ok | ~live)].

    tables (V, 64, 8, 3, 8) int32, valid (V,) bool, payload
    (V, 68 + maxm) uint8 (R, s and live are read from it), digest
    (V, 64) uint8 = SHA-512(R || A || M), b_tab (22, 4096, 3, 8) int32."""
    _check_verify_args(tables, valid, payload, digest, b_tab)
    dev = payload.device
    if dev.type == "cpu":
        ok = verify_cached_plain(tables, valid, payload, digest, b_tab)
        return pack_verdicts(ok, payload[:, 67] == 1)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    V = payload.shape[0]
    out = torch.empty(((V + 7) // 8 + 1,), dtype=torch.uint8, device=dev)
    counters = torch.empty((2,), dtype=torch.int32, device=dev)
    launch_k4(tables.contiguous(), valid.to(torch.uint8).contiguous(),
              payload.contiguous(), digest.contiguous(), b_tab.contiguous(),
              counters, out)
    return out


def launch_k4(tables, valid_u8, payload, digest, b_tab, counters, out) -> None:
    """K4 into a preallocated output on the current stream."""
    V, width = payload.shape
    if V == 0:
        out.fill_(1)
        return
    if tables.data_ptr() % 16 or b_tab.data_ptr() % 16:
        raise ValueError("K4 reads table entries as 16-byte vectors: tables and b_tab must be 16-byte aligned")
    code = _build.lib("comb").k4_verify_cached(
        tables.data_ptr(), valid_u8.data_ptr(), payload.data_ptr(), width,
        digest.data_ptr(), b_tab.data_ptr(), counters.data_ptr(), out.data_ptr(),
        V, torch.cuda.current_stream(payload.device).cuda_stream,
    )
    _build.check(code, "k4_verify_cached")
    LAUNCHES["verify_cached"] += 1
