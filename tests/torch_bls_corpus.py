"""Seeded BLS12-381 G1 rows for the key-validation kernels K13 and K15,
shared by tests/test_torch_bls_rows_host.py, tests/test_torch_cuda.py and
chip_smoke.py (and the field values at the range's edges that
tests/test_torch_bls_field_host.py and tests/test_torch_cuda.py hold the
header's field routines to): subgroup keys, and every class a row can fail on — the
host decode's mask, x >= p, off the curve, on the curve outside the
subgroup, and points of small order (3 and 11), whose ladder meets equal,
opposite and infinite operands — placed at the first and last row of
each group of 8 rows and the last row of each 32-row tile (K15's tile
stage).  Built with the port's host group law; verdicts are the host
oracle's (on the curve and [r]P = infinity)."""

from __future__ import annotations

import numpy as np

from cometbft_tpu_torch.crypto import bls12381 as H
from cometbft_tpu_torch.ops import bls381 as B

P, R = H.P, H.R
COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB  # h: #E(Fp) = h r
GROUP_ROWS, TILE = 8, 32
EDGE_SIZES = (1, 7, 8, 9, 31, 32, 33)
# the classes that fail before the ladder, and those that run it and fail
PREFAIL = ("host-rejected", "x >= p", "off curve")
LADDER_FAIL = ("order 3", "order 11", "wrong subgroup")


def curve_point(x: int) -> tuple[int, int]:
    """The least-x curve point with x' >= x."""
    while True:
        y = H._fp_sqrt((x**3 + 4) % P)
        if y is not None:
            return x, y
        x += 1


def _mul(aff, k: int):
    return H._to_affine(H._FP, H._jac_mul(H._FP, H._from_affine(H._FP, aff), k))


def small_order_point(q: int, x: int = 1) -> tuple[int, int]:
    """A point of prime order q | h: the first curve point from x on
    whose q-primary part is not trivial, multiplied into that part by h r
    over q's whole power in h, then by q until the next multiple is
    infinity."""
    m = COFACTOR * R
    while m % q == 0:
        m //= q
    while True:
        pt = curve_point(x)
        s = _mul(pt, m)
        if s is not None:
            while _mul(s, q) is not None:
                s = _mul(s, q)
            return s
        x = pt[0] + 1


def wrong_subgroup_point(x: int = 1) -> tuple[int, int]:
    while True:
        pt = curve_point(x)
        if not H._in_subgroup(H._FP, pt):
            return pt
        x = pt[0] + 1


def off_curve_x(x: int = 5) -> int:
    while H._fp_sqrt((x**3 + 4) % P) is not None:
        x += 1
    return x


def subgroup_points(n: int, seed: int) -> list[tuple[int, int]]:
    """n subgroup points [a + i b] G, by one Jacobian add a point."""
    rng = np.random.default_rng(seed)
    a, b = int(rng.integers(2, 1 << 62)), int(rng.integers(2, 1 << 62))
    step = H._jac_mul(H._FP, H._from_affine(H._FP, H.G1_GEN), b)
    acc, out = H._jac_mul(H._FP, H._from_affine(H._FP, H.G1_GEN), a), []
    for _ in range(n):
        out.append(H._to_affine(H._FP, acc))
        acc = H._jac_add(H._FP, acc, step)
    return out


_CACHE: dict[str, object] = {}


def special_rows() -> dict[str, tuple[int, int] | None]:
    """One row of each failing class (x >= p as its x's true value)."""
    if not _CACHE:
        xo = off_curve_x()
        _CACHE.update({
            "host-rejected": None, "x >= p": (P + 5, curve_point(7)[1]), "off curve": (xo, 6),
            "order 3": small_order_point(3), "order 11": small_order_point(11),
            "wrong subgroup": wrong_subgroup_point(),
        })
    return dict(_CACHE)


def edge_positions(n: int) -> list[int]:
    """The first and last row of each group of 8 rows, and each tile's last
    row."""
    return sorted({i for i in range(n) if i % GROUP_ROWS in (0, GROUP_ROWS - 1) or i % TILE == TILE - 1})


def batch(n: int, seed: int, mode: str = "mixed") -> dict:
    """n rows: ``mixed`` (subgroup keys, every failing class in turn at
    the edge positions), ``valid``, ``prefail`` (every row fails before
    the ladder) or ``small`` (rows of order 3 and 11
    and subgroup keys, alternating).  Returns {"points": affine pairs or
    None, "kinds", "expect": the host oracle's verdicts}."""
    pts = subgroup_points(n, seed)
    kinds = ["valid"] * n
    special = special_rows()
    if mode == "mixed":
        classes = PREFAIL + LADDER_FAIL
        for k, i in enumerate(edge_positions(n)):
            kinds[i] = classes[(k + seed) % len(classes)]
    elif mode == "prefail":
        kinds = [PREFAIL[(i + seed) % len(PREFAIL)] for i in range(n)]
    elif mode == "small":
        kinds = [("order 3", "valid", "order 11")[i % 3] for i in range(n)]
    elif mode != "valid":
        raise ValueError(mode)
    points = [pts[i] if kinds[i] == "valid" else special[kinds[i]] for i in range(n)]
    expect = [k == "valid" for k in kinds]
    return {"points": points, "kinds": kinds, "expect": expect}


def pack(b: dict):
    """numpy (X, Y) (N, 12) int32 Montgomery words and valid (N,) bool of
    a batch; an x >= p row carries x's own words, as a decoder that did
    not reduce it would hand it on, flagged valid."""
    pts = b["points"]
    X, Y, valid = B.pack_affine([None if p is None or p[0] >= P else p for p in pts])
    for i, p in enumerate(pts):
        if p is not None and p[0] >= P:
            X[i] = B.ints_to_words_np([p[0]])[0]
            Y[i] = B.ints_to_words_np([B.to_mont(p[1])])[0]
            valid[i] = True
    return X, Y, valid


def oracle(point) -> bool:
    """The host's verdict for an affine pair (None: host-rejected)."""
    if point is None or point[0] >= P:
        return False
    return H._on_curve(H._FP, point) and H._in_subgroup(H._FP, point)


def field_edge_values() -> list[int]:
    """Field values at the range's edges: 0, 1, 2, p - 1, p - 2, R mod p
    (one), R^2 mod p, values beside p / 2 and 2^381, and 2^k mod p and
    2^k - 1 at word and half-word edges."""
    R_ = B.R_MONT
    ks = (31, 32, 63, 64, 128, 192, 255, 256, 320, 352, 380, 383, 384, 400)
    vals = [0, 1, 2, P - 1, P - 2, R_ % P, R_ * R_ % P, (P - 1) // 2, (P + 1) // 2, (1 << 381) - 1 - P % 7]
    vals += [pow(2, k, P) for k in ks] + [(1 << k) - 1 for k in (32, 64, 352, 380)]
    return [v % P for v in vals]


def field_random_values(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def field_pairs(seed: int, n_random: int = 400) -> tuple[list[int], list[int]]:
    """Every ordered pair of the edge values, then n_random seeded pairs."""
    e = field_edge_values()
    xs = [x for x in e for _ in e] + field_random_values(n_random, seed)
    ys = [y for _ in e for y in e] + field_random_values(n_random, seed + 1)
    return xs, ys
