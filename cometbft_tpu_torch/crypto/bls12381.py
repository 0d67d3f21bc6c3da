"""BLS12-381 validator keys (minimal-pubkey-size ciphersuite): the port's
copy of cometbft_tpu/crypto/bls12381.py.

Host implementation of the reference's optional BLS key type
(reference: crypto/bls12381/key_bls12381.go — 48-byte G1 pubkeys,
96-byte G2 signatures, ciphersuite
``BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_NUL_``, key_bls12381.go:30-41):
Fp2 and Fp12 towers, G1 and G2 in Jacobian coordinates, ZCash point
compression, RFC 9380 hash-to-G2 (the isogeny-based simplified-SWU suite
``BLS12381G2_XMD:SHA-256_SSWU_RO_`` with the reference's DST), keys,
signatures, aggregates and proofs of possession.

Pairings run in the native core, a copy of the JAX package's
native/bls381.cc kept as hostsrc/bls381.cc and built at first use into
build/host/ (``_build.host_lib``).  Where the JAX package falls back to
the pure-Python pairing when that core cannot be built or loaded, the
port raises: the pure-Python pairing stays here only as the oracle
``_pairings_product_is_one_python``, which tests call by name.

With ``COMETBFT_TPU_BLS_DEVICE=1``, ``fast_aggregate_verify`` sums its
pubkeys on the card (ops/bls381.aggregate_pubkeys_device, K14), as the
JAX package sums them on its accelerator.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
from dataclasses import dataclass

from .hash import sum_truncated

# ---------------------------------------------------------------------------
# Curve parameters.  x is the BLS parameter; everything else derives from it.
# ---------------------------------------------------------------------------

X_PARAM = -0xD201000000010000
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
_x = X_PARAM
H2 = (
    _x**8 - 4 * _x**7 + 5 * _x**6 - 4 * _x**4 + 6 * _x**3 - 4 * _x**2 - 4 * _x + 13
) // 9  # G2 cofactor; kept to pin H_EFF_G2 = H2 * (3x^2 - 3) below

# The reference's exact ciphersuite (key_bls12381.go:30-41): basic
# (NUL) scheme over the standard SSWU G2 suite.
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_NUL_"
POP_DST = b"BLS_POP_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

PUBKEY_SIZE = 48
SIG_SIZE = 96
PRIVKEY_SIZE = 32
KEY_TYPE = "bls12_381"
ENABLED = True


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u^2+1), as tuples (a, b) = a + b*u.  Plain functions, not
# classes — the pairing does ~1e5 of these per verify.
# ---------------------------------------------------------------------------


def f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2_neg(x):
    return (-x[0] % P, -x[1] % P)


def f2_mul(x, y):
    a, b = x
    c, d = y
    ac = a * c
    bd = b * d
    return ((ac - bd) % P, ((a + b) * (c + d) - ac - bd) % P)


def f2_sqr(x):
    a, b = x
    return ((a + b) * (a - b) % P, 2 * a * b % P)


def f2_muls(x, s: int):
    return (x[0] * s % P, x[1] * s % P)


def f2_inv(x):
    a, b = x
    norm = (a * a + b * b) % P
    ninv = pow(norm, P - 2, P)
    return (a * ninv % P, -b * ninv % P)


def f2_conj(x):
    return (x[0], -x[1] % P)


def f2_pow(x, e: int):
    acc = F2_ONE
    while e:
        if e & 1:
            acc = f2_mul(acc, x)
        x = f2_sqr(x)
        e >>= 1
    return acc


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # u + 1, the sextic non-residue

# Is there a square root?  p^2 ≡ 9 mod 16; use the generic Tonelli–Shanks
# over Fp2 via the norm trick: sqrt(a) for a = (x,y) — we use the
# "complex method": sqrt of a+bu via sqrt over Fp of the norm.


def _fp_sqrt(n: int) -> int | None:
    # p ≡ 3 (mod 4)
    cand = pow(n, (P + 1) // 4, P)
    return cand if cand * cand % P == n else None


def f2_sqrt(a):
    """Square root in Fp2 via the complex method, or None."""
    x, y = a
    if y == 0:
        s = _fp_sqrt(x)
        if s is not None:
            return (s, 0)
        # sqrt(x) = sqrt(-x) * u since u^2 = -1
        s = _fp_sqrt(-x % P)
        return None if s is None else (0, s)
    alpha = _fp_sqrt((x * x + y * y) % P)
    if alpha is None:
        return None
    delta = (x + alpha) * pow(2, P - 2, P) % P
    if pow(delta, (P - 1) // 2, P) != 1:
        delta = (x - alpha) * pow(2, P - 2, P) % P
    a0 = _fp_sqrt(delta)
    if a0 is None:
        return None
    b0 = y * pow(2 * a0, P - 2, P) % P
    return (a0, b0)


# ---------------------------------------------------------------------------
# Fp12 = Fp2[w]/(w^6 - xi), as 6-tuples of Fp2 coefficients.
# ---------------------------------------------------------------------------

F12_ZERO = (F2_ZERO,) * 6
F12_ONE = (F2_ONE, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO)


def f12_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f12_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f12_neg(x):
    return tuple(f2_neg(a) for a in x)


def f12_mul(x, y):
    # schoolbook degree-6 polynomial product, reduced by w^6 = xi
    acc = [F2_ZERO] * 11
    for i, xi_ in enumerate(x):
        if xi_ == F2_ZERO:
            continue
        for j, yj in enumerate(y):
            if yj == F2_ZERO:
                continue
            acc[i + j] = f2_add(acc[i + j], f2_mul(xi_, yj))
    out = list(acc[:6])
    for k in range(6, 11):
        out[k - 6] = f2_add(out[k - 6], f2_mul(acc[k], XI))
    return tuple(out)


def f12_sqr(x):
    return f12_mul(x, x)


def f12_conj(x):
    """Conjugation over Fp6: w -> -w (negate odd coefficients).  This is
    the p^6-Frobenius, and the inverse on the cyclotomic subgroup."""
    return tuple(c if i % 2 == 0 else f2_neg(c) for i, c in enumerate(x))


def f12_pow(x, e: int):
    if e < 0:
        x = f12_inv(x)
        e = -e
    acc = F12_ONE
    while e:
        if e & 1:
            acc = f12_mul(acc, x)
        x = f12_sqr(x)
        e >>= 1
    return acc


def _poly_divmod(num, den):
    num = list(num)
    out = [F2_ZERO] * max(len(num) - len(den) + 1, 1)
    dinv = f2_inv(den[-1])
    while len(num) >= len(den) and any(c != F2_ZERO for c in num):
        if num[-1] == F2_ZERO:
            num.pop()
            continue
        shift = len(num) - len(den)
        q = f2_mul(num[-1], dinv)
        out[shift] = q
        for i, d in enumerate(den):
            num[shift + i] = f2_sub(num[shift + i], f2_mul(q, d))
        num.pop()
    while len(num) > 1 and num[-1] == F2_ZERO:
        num.pop()
    return out, num


def f12_inv(x):
    """Inverse via extended Euclid over Fp2[w] against w^6 - xi."""
    mod = [f2_neg(XI), F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ONE]
    a = list(x)
    while len(a) > 1 and a[-1] == F2_ZERO:
        a.pop()
    lm, hm = [F2_ONE], [F2_ZERO]
    low, high = a, mod
    while len(low) > 1 or low[0] != F2_ZERO:
        q, rem = _poly_divmod(high, low)
        # nm = hm - q*lm
        nm = list(hm) + [F2_ZERO] * (len(q) + len(lm) - len(hm))
        for i, qi in enumerate(q):
            if qi == F2_ZERO:
                continue
            for j, lj in enumerate(lm):
                nm[i + j] = f2_sub(nm[i + j], f2_mul(qi, lj))
        while len(nm) > 1 and nm[-1] == F2_ZERO:
            nm.pop()
        hm, lm = lm, nm
        high, low = low, rem
        if len(low) == 1 and low[0] != F2_ZERO:
            break
    cinv = f2_inv(low[0])
    out = [f2_mul(c, cinv) for c in lm]
    out += [F2_ZERO] * (6 - len(out))
    return tuple(out[:6])


# Frobenius: phi(sum a_i w^i) = sum conj(a_i) * c_i * w^i,
# c_i = xi^(i*(p-1)/6).  Constants computed once from the curve params.
_FROB_C = [f2_pow(XI, i * (P - 1) // 6) for i in range(6)]


def f12_frob(x):
    return tuple(f2_mul(f2_conj(c), _FROB_C[i]) for i, c in enumerate(x))


# ---------------------------------------------------------------------------
# Curve groups.  G1 over Fp: y^2 = x^3 + 4.  G2 over Fp2: y^2 = x^3 + 4(u+1).
# Jacobian coordinates (X, Y, Z): x = X/Z^2, y = Y/Z^3.
# ---------------------------------------------------------------------------

G1_GEN = (
    3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
    1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
)
G2_GEN = (
    (
        352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
        3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758,
    ),
    (
        1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
        927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582,
    ),
)


class _Fld:
    """Field-op vtable so one Jacobian implementation serves G1 and G2."""

    __slots__ = ("add", "sub", "mul", "sqr", "neg", "inv", "muls", "zero", "one", "b")

    def __init__(self, add, sub, mul, sqr, neg, inv, muls, zero, one, b):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.neg, self.inv, self.muls = neg, inv, muls
        self.zero, self.one, self.b = zero, one, b


_FP = _Fld(
    lambda a, b: (a + b) % P,
    lambda a, b: (a - b) % P,
    lambda a, b: a * b % P,
    lambda a: a * a % P,
    lambda a: -a % P,
    lambda a: pow(a, P - 2, P),
    lambda a, s: a * s % P,
    0,
    1,
    4,
)
_FP2 = _Fld(
    f2_add, f2_sub, f2_mul, f2_sqr, f2_neg, f2_inv, f2_muls, F2_ZERO, F2_ONE,
    f2_muls(XI, 4),
)


def _jac_dbl(F: _Fld, pt):
    X, Y, Z = pt
    if Z == F.zero:
        return pt
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    D = F.muls(F.sub(F.sqr(F.add(X, B)), F.add(A, C)), 2)
    E = F.muls(A, 3)
    X3 = F.sub(F.sqr(E), F.muls(D, 2))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.muls(C, 8))
    Z3 = F.muls(F.mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _jac_add(F: _Fld, p1, p2):
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if Z1 == F.zero:
        return p2
    if Z2 == F.zero:
        return p1
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 != S2:
            return (F.one, F.one, F.zero)  # infinity
        return _jac_dbl(F, p1)
    H = F.sub(U2, U1)
    I = F.sqr(F.muls(H, 2))
    J = F.mul(H, I)
    rr = F.muls(F.sub(S2, S1), 2)
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(rr), J), F.muls(V, 2))
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.muls(F.mul(S1, J), 2))
    Z3 = F.mul(F.mul(F.muls(F.mul(Z1, Z2), 2), H), F.one)
    return (X3, Y3, Z3)


def _jac_mul(F: _Fld, pt, k: int):
    if k < 0:
        X, Y, Z = pt
        pt = (X, F.neg(Y), Z)
        k = -k
    acc = (F.one, F.one, F.zero)
    while k:
        if k & 1:
            acc = _jac_add(F, acc, pt)
        pt = _jac_dbl(F, pt)
        k >>= 1
    return acc


def _to_affine(F: _Fld, pt):
    X, Y, Z = pt
    if Z == F.zero:
        return None  # infinity
    zi = F.inv(Z)
    zi2 = F.sqr(zi)
    return (F.mul(X, zi2), F.mul(Y, F.mul(zi, zi2)))


def _from_affine(F: _Fld, aff):
    if aff is None:
        return (F.one, F.one, F.zero)
    return (aff[0], aff[1], F.one)


def _on_curve(F: _Fld, aff) -> bool:
    x, y = aff
    return F.sqr(y) == F.add(F.mul(F.sqr(x), x), F.b)


def _in_subgroup(F: _Fld, aff) -> bool:
    return _jac_mul(F, _from_affine(F, aff), R)[2] == F.zero


# ---------------------------------------------------------------------------
# Serialization (ZCash format: compressed, flag bits in the top 3 bits).
# ---------------------------------------------------------------------------

_C_FLAG = 0x80  # compressed
_I_FLAG = 0x40  # infinity
_S_FLAG = 0x20  # y is the lexicographically larger root


def _g1_compress(aff) -> bytes:
    if aff is None:
        out = bytearray(48)
        out[0] = _C_FLAG | _I_FLAG
        return bytes(out)
    x, y = aff
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _C_FLAG
    if y > P - y:
        out[0] |= _S_FLAG
    return bytes(out)


def _g1_decompress(data: bytes):
    """Returns affine point or None for infinity; raises on malformed."""
    if len(data) != 48:
        raise ValueError("bls12381: bad G1 length")
    flags = data[0]
    if not flags & _C_FLAG:
        raise ValueError("bls12381: uncompressed G1 not supported")
    if flags & _I_FLAG:
        if any(data[1:]) or flags & _S_FLAG or data[0] != (_C_FLAG | _I_FLAG):
            raise ValueError("bls12381: malformed infinity")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("bls12381: G1 x out of range")
    y2 = (x * x * x + 4) % P
    y = _fp_sqrt(y2)
    if y is None:
        raise ValueError("bls12381: G1 x not on curve")
    if (y > P - y) != bool(flags & _S_FLAG):
        y = P - y
    return (x, y)


def _g2_compress(aff) -> bytes:
    if aff is None:
        out = bytearray(96)
        out[0] = _C_FLAG | _I_FLAG
        return bytes(out)
    (x0, x1), (y0, y1) = aff
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= _C_FLAG
    if (y1, y0) > ((-y1) % P, (-y0) % P):
        out[0] |= _S_FLAG
    return bytes(out)


def _g2_decompress(data: bytes):
    if len(data) != 96:
        raise ValueError("bls12381: bad G2 length")
    flags = data[0]
    if not flags & _C_FLAG:
        raise ValueError("bls12381: uncompressed G2 not supported")
    if flags & _I_FLAG:
        if any(data[1:]) or flags & _S_FLAG or data[0] != (_C_FLAG | _I_FLAG):
            raise ValueError("bls12381: malformed infinity")
        return None
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("bls12381: G2 x out of range")
    x = (x0, x1)
    y2 = f2_add(f2_mul(f2_sqr(x), x), _FP2.b)
    y = f2_sqrt(y2)
    if y is None:
        raise ValueError("bls12381: G2 x not on curve")
    y0, y1 = y
    if ((y1, y0) > ((-y1) % P, (-y0) % P)) != bool(flags & _S_FLAG):
        y = ((-y0) % P, (-y1) % P)
    return (x, y)


# ---------------------------------------------------------------------------
# Pairing: Miller loop in full Fp12 over the untwisted Q, affine line
# functions (py_ecc-style formulation — simple and auditable; speed is a
# non-goal for this gated key type).
# ---------------------------------------------------------------------------

# w^-2 = w^4 * xi^-1 and w^-3 = w^3 * xi^-1, used to untwist E'(Fp2) -> E(Fp12)
_XI_INV = f2_inv(XI)
_W2_INV = (F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, _XI_INV, F2_ZERO)
_W3_INV = (F2_ZERO, F2_ZERO, F2_ZERO, _XI_INV, F2_ZERO, F2_ZERO)


def _embed_fp2(a):
    return (a, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO)


def _embed_fp(a: int):
    return _embed_fp2((a, 0))


def _untwist(q_aff):
    x, y = q_aff
    return (
        f12_mul(_embed_fp2(x), _W2_INV),
        f12_mul(_embed_fp2(y), _W3_INV),
    )


def _line(p1, p2, t):
    """Evaluate the line through p1,p2 (Fp12 affine points) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    elif y1 == y2:
        lam = f12_mul(
            f12_mul(f12_sqr(x1), _embed_fp(3)), f12_inv(f12_mul(y1, _embed_fp(2)))
        )
    else:
        return f12_sub(xt, x1), None
    line = f12_sub(f12_sub(yt, y1), f12_mul(lam, f12_sub(xt, x1)))
    x3 = f12_sub(f12_sub(f12_sqr(lam), x1), x2)
    y3 = f12_sub(f12_mul(lam, f12_sub(x1, x3)), y1)
    return line, (x3, y3)


_ATE_BITS = bin(-X_PARAM)[2:]


def _miller(q_aff, p_aff):
    """Miller loop value f_{|x|,Q}(P) in Fp12 (both points affine, nonzero)."""
    Q = _untwist(q_aff)
    Pt = (_embed_fp(p_aff[0]), _embed_fp(p_aff[1]))
    T = Q
    f = F12_ONE
    for bit in _ATE_BITS[1:]:
        line, T2 = _line(T, T, Pt)
        f = f12_mul(f12_sqr(f), line)
        T = T2
        if bit == "1":
            line, T2 = _line(T, Q, Pt)
            f = f12_mul(f, line)
            T = T2
    return f


_HARD_EXP = (P**4 - P**2 + 1) // R


def _final_exp(f):
    # easy part: f^((p^6-1)(p^2+1))
    g = f12_mul(f12_conj(f), f12_inv(f))  # f^(p^6-1)
    g = f12_mul(f12_frob(f12_frob(g)), g)  # ^(p^2+1)
    # hard part: ^((p^4-p^2+1)/r)
    return f12_pow(g, _HARD_EXP)


def _native_pairing_lib():
    """The C pairing core (hostsrc/bls381.cc), built and loaded once.  A
    failed build or load raises _build.BuildError: the port has no
    pure-Python fallback on this path."""
    import ctypes

    from .. import _build

    lib = _build.host_lib("bls381")
    lib.bls381_pairing_product_is_one.restype = ctypes.c_int
    return lib


def _limbs6(x: int) -> list[int]:
    return [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(6)]


def _pairings_product_is_one(pairs) -> bool:
    """True iff prod e(Pi, Qi) == 1, for (g1_affine, g2_affine) pairs,
    in the native core.  Infinity on either side contributes the
    identity."""
    import ctypes

    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    if not live:
        return True
    lib = _native_pairing_lib()
    g1 = []
    g2 = []
    for p_aff, q_aff in live:
        g1 += _limbs6(p_aff[0]) + _limbs6(p_aff[1])
        (x0, x1), (y0, y1) = q_aff
        g2 += _limbs6(x0) + _limbs6(x1) + _limbs6(y0) + _limbs6(y1)
    r = lib.bls381_pairing_product_is_one(
        (ctypes.c_uint64 * len(g1))(*g1),
        (ctypes.c_uint64 * len(g2))(*g2),
        len(live),
    )
    return r == 1


def _pairings_product_is_one_python(pairs) -> bool:
    """The pure-Python pairing product (Miller loop in full Fp12, final
    exponentiation): the oracle the tests hold the native core to."""
    f = F12_ONE
    for p_aff, q_aff in pairs:
        if p_aff is not None and q_aff is not None:
            f = f12_mul(f, _miller(q_aff, p_aff))
    return _final_exp(f) == F12_ONE


# ---------------------------------------------------------------------------
# Hash-to-curve: hash_to_field (RFC 9380 §5) + SvdW map (§6.6.1) + cofactor
# clearing.  All constants derived at import from the curve equation.
# ---------------------------------------------------------------------------


def _expand_message_xmd(msg: bytes, dst: bytes, length: int) -> bytes:
    H = hashlib.sha256
    b_in_bytes, r_in_bytes = 32, 64
    ell = -(-length // b_in_bytes)
    if ell > 255 or len(dst) > 255:
        raise ValueError("expand_message_xmd bounds")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * r_in_bytes
    l_i_b = length.to_bytes(2, "big")
    b0 = H(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    bvals = [H(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        prev = bvals[-1]
        x = bytes(a ^ b for a, b in zip(b0, prev))
        bvals.append(H(x + bytes([i]) + dst_prime).digest())
    return b"".join(bvals)[:length]


def _hash_to_field_fp2(msg: bytes, count: int, dst: bytes):
    L = 64
    uniform = _expand_message_xmd(msg, dst, count * 2 * L)
    out = []
    for i in range(count):
        c0 = int.from_bytes(uniform[(2 * i) * L : (2 * i + 1) * L], "big") % P
        c1 = int.from_bytes(uniform[(2 * i + 1) * L : (2 * i + 2) * L], "big") % P
        out.append((c0, c1))
    return out


def _sgn0_fp2(x) -> int:
    a, b = x
    sign_0 = a & 1
    zero_0 = 1 if a == 0 else 0
    sign_1 = b & 1
    return sign_0 | (zero_0 & sign_1)


# Simplified-SWU target curve E': y^2 = x^3 + A'x + B' over Fp2, the
# curve 3-isogenous to G2's (RFC 9380 §8.8.2).  A' = 240·I,
# B' = 1012·(1+I), Z = −(2+I).
_SSWU_A = (0, 240)
_SSWU_B = (1012, 1012)
_SSWU_Z = (P - 2, P - 1)


def _map_to_curve_sswu_g2(u):
    """Simplified SWU for AB ≠ 0 (RFC 9380 §6.6.2), into E'(Fp2)."""

    def gp(x):
        return f2_add(f2_add(f2_mul(f2_sqr(x), x), f2_mul(_SSWU_A, x)), _SSWU_B)

    zu2 = f2_mul(_SSWU_Z, f2_sqr(u))
    tv1 = f2_add(f2_sqr(zu2), zu2)  # Z^2 u^4 + Z u^2
    if tv1 == F2_ZERO:
        x1 = f2_mul(_SSWU_B, f2_inv(f2_mul(_SSWU_Z, _SSWU_A)))
    else:
        x1 = f2_mul(
            f2_mul(f2_neg(_SSWU_B), f2_inv(_SSWU_A)),
            f2_add(F2_ONE, f2_inv(tv1)),
        )
    gx1 = gp(x1)
    y1 = f2_sqrt(gx1)
    if y1 is not None:
        x, y = x1, y1
    else:
        x = f2_mul(zu2, x1)
        y = f2_sqrt(gp(x))
        if y is None:  # impossible by SSWU's exceptional-case analysis
            raise RuntimeError("SSWU: neither candidate is on E'")
    if _sgn0_fp2(u) != _sgn0_fp2(y):
        y = f2_neg(y)
    return (x, y)


def _fp2c(c0: int, c1: int):
    return (c0, c1)


# 3-isogeny E' → E coefficient tables (RFC 9380 Appendix E.3 — public
# protocol constants, ascending powers of x').
_ISO3_XNUM = (
    _fp2c(
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
    ),
    _fp2c(
        0,
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A,
    ),
    _fp2c(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    _fp2c(
        0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
        0,
    ),
)
_ISO3_XDEN = (
    _fp2c(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63,
    ),
    _fp2c(
        0xC,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F,
    ),
    F2_ONE,
)
_ISO3_YNUM = (
    _fp2c(
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    _fp2c(
        0,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE,
    ),
    _fp2c(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    _fp2c(
        0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
        0,
    ),
)
_ISO3_YDEN = (
    _fp2c(
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    _fp2c(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3,
    ),
    _fp2c(
        0x12,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99,
    ),
    F2_ONE,
)

# Cofactor-clearing scalar h_eff for the G2 suite (RFC 9380 §8.8.2).
# Divisible by the G2 cofactor h2, so the result lands in the r-order
# subgroup; the exact multiple matters for conformance (blst clears via
# the equivalent endomorphism method).
H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551
assert H_EFF_G2 == H2 * (3 * X_PARAM**2 - 3), "h_eff must be h2*(3x^2-3)"


def _iso3_map(pt):
    """Evaluate the 3-isogeny E' → E at an affine point (Appendix E.3)."""
    x, y = pt

    def horner(coeffs):
        acc = coeffs[-1]
        for c in reversed(coeffs[:-1]):
            acc = f2_add(f2_mul(acc, x), c)
        return acc

    xden = horner(_ISO3_XDEN)
    yden = horner(_ISO3_YDEN)
    if xden == F2_ZERO or yden == F2_ZERO:
        return None  # kernel point: maps to the identity
    return (
        f2_mul(horner(_ISO3_XNUM), f2_inv(xden)),
        f2_mul(y, f2_mul(horner(_ISO3_YNUM), f2_inv(yden))),
    )


def hash_to_g2(msg: bytes, dst: bytes = DST):
    """hash_to_curve for G2 (RFC 9380 §3): two field elements, two
    SSWU+isogeny maps, add, clear cofactor by h_eff.  Returns an affine
    point in the r-order subgroup."""
    u0, u1 = _hash_to_field_fp2(msg, 2, dst)
    q0 = _iso3_map(_map_to_curve_sswu_g2(u0))
    q1 = _iso3_map(_map_to_curve_sswu_g2(u1))
    s = _from_affine(_FP2, None)  # jacobian identity
    for q in (q0, q1):
        if q is not None:
            s = _jac_add(_FP2, s, _from_affine(_FP2, q))
    cleared = _jac_mul(_FP2, s, H_EFF_G2)
    aff = _to_affine(_FP2, cleared)
    if aff is None:  # astronomically unlikely; retry domain-separated
        return hash_to_g2(msg + b"\x00", dst)
    return aff


# ---------------------------------------------------------------------------
# Keys: reference API shape (key_bls12381.go).
# ---------------------------------------------------------------------------


def _keygen_ikm(ikm: bytes, key_info: bytes = b"") -> int:
    """draft-irtf-cfrg-bls-signature KeyGen: HKDF-SHA256 with the
    BLS-SIG-KEYGEN-SALT-, L=48, rejecting zero."""
    if len(ikm) < 32:
        ikm = hashlib.sha256(ikm).digest()
    salt = b"BLS-SIG-KEYGEN-SALT-"
    L = 48
    while True:
        salt = hashlib.sha256(salt).digest()
        prk = _hmac.new(salt, ikm + b"\x00", hashlib.sha256).digest()
        okm = b""
        t = b""
        i = 1
        info = key_info + L.to_bytes(2, "big")
        while len(okm) < L:
            t = _hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
            okm += t
            i += 1
        sk = int.from_bytes(okm[:L], "big") % R
        if sk != 0:
            return sk


class PrivKey:
    """BLS12-381 private key (reference: key_bls12381.go PrivKey)."""

    __slots__ = ("_sk",)

    def __init__(self, sk: int):
        if not 0 < sk < R:
            raise ValueError("bls12381: secret key out of range")
        self._sk = sk

    @classmethod
    def from_secret(cls, secret: bytes) -> "PrivKey":
        """GenPrivKeyFromSecret (key_bls12381.go:66)."""
        return cls(_keygen_ikm(secret))

    @classmethod
    def generate(cls) -> "PrivKey":
        import os as _os

        return cls.from_secret(_os.urandom(32))

    @classmethod
    def from_bytes(cls, data: bytes) -> "PrivKey":
        if len(data) != PRIVKEY_SIZE:
            raise ValueError("bls12381: bad privkey length")
        return cls(int.from_bytes(data, "big"))

    def bytes(self) -> bytes:
        return self._sk.to_bytes(PRIVKEY_SIZE, "big")

    @property
    def data(self) -> bytes:
        return self.bytes()

    def pub_key(self) -> "PubKey":
        aff = _to_affine(_FP, _jac_mul(_FP, _from_affine(_FP, G1_GEN), self._sk))
        return PubKey(_g1_compress(aff))

    def sign(self, msg: bytes) -> bytes:
        """sig = sk * hash_to_g2(msg) (key_bls12381.go:112)."""
        h = hash_to_g2(msg)
        s = _to_affine(_FP2, _jac_mul(_FP2, _from_affine(_FP2, h), self._sk))
        return _g2_compress(s)

    def zeroize(self) -> None:
        self._sk = 1

    @property
    def type(self) -> str:
        return KEY_TYPE


class PubKey:
    """BLS12-381 public key: 48-byte compressed G1; rejects off-curve,
    out-of-subgroup, and infinite keys (key_bls12381.go:159-172,
    ErrInfinitePubKey)."""

    __slots__ = ("data", "_aff")

    def __init__(self, data: bytes):
        aff = _g1_decompress(data)
        if aff is None:
            raise ValueError("bls12381: pubkey is infinite")
        if not _on_curve(_FP, aff) or not _in_subgroup(_FP, aff):
            raise ValueError("bls12381: pubkey not in subgroup")
        self.data = data
        self._aff = aff

    def bytes(self) -> bytes:
        return self.data

    def address(self) -> bytes:
        """20-byte truncated SHA-256, like every key type
        (key_bls12381.go:174)."""
        return sum_truncated(self.data)

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """e(pk, H(m)) == e(g1, sig), checked as a two-pairing product
        (key_bls12381.go:179-192)."""
        try:
            s = _g2_decompress(sig)
        except ValueError:
            return False
        if s is None or not _on_curve(_FP2, s) or not _in_subgroup(_FP2, s):
            return False
        h = hash_to_g2(msg)
        neg_g1 = (G1_GEN[0], (-G1_GEN[1]) % P)
        return _pairings_product_is_one([(self._aff, h), (neg_g1, s)])

    @property
    def type(self) -> str:
        return KEY_TYPE

    def __eq__(self, other) -> bool:
        return isinstance(other, PubKey) and self.data == other.data

    def __hash__(self) -> int:
        return hash(self.data)


# ---------------------------------------------------------------------------
# Aggregates (blst P1/P2 Aggregate — key_bls12381.go:39-41).
# ---------------------------------------------------------------------------


def aggregate_signatures(sigs: list[bytes]) -> bytes:
    """Sum of G2 signature points."""
    acc = (_FP2.one, _FP2.one, _FP2.zero)
    for sig in sigs:
        s = _g2_decompress(sig)
        if s is None:
            continue
        acc = _jac_add(_FP2, acc, _from_affine(_FP2, s))
    return _g2_compress(_to_affine(_FP2, acc))


def aggregate_verify(pubkeys: list["PubKey"], msgs: list[bytes], agg_sig: bytes) -> bool:
    """prod e(pk_i, H(m_i)) == e(g1, agg_sig).

    Basic-scheme (NUL ciphersuite) AggregateVerify: messages MUST be
    pairwise distinct (draft-irtf-cfrg-bls-signature §3.1.1) — duplicate
    messages degenerate to the same-message case and reopen the rogue-key
    attack the basic scheme otherwise avoids."""
    if len(pubkeys) != len(msgs) or not pubkeys:
        return False
    if len(set(msgs)) != len(msgs):
        return False
    try:
        s = _g2_decompress(agg_sig)
    except ValueError:
        return False
    if s is None or not _on_curve(_FP2, s) or not _in_subgroup(_FP2, s):
        return False
    neg_g1 = (G1_GEN[0], (-G1_GEN[1]) % P)
    pairs = [(pk._aff, hash_to_g2(m)) for pk, m in zip(pubkeys, msgs)]
    pairs.append((neg_g1, s))
    return _pairings_product_is_one(pairs)


def pop_prove(sk: "PrivKey") -> bytes:
    """Proof of possession: sk * hash(pk bytes) under the POP DST
    (draft-irtf-cfrg-bls-signature §3.3.2)."""
    pk = sk.pub_key()
    h = hash_to_g2(pk.data, POP_DST)
    s = _to_affine(_FP2, _jac_mul(_FP2, _from_affine(_FP2, h), sk._sk))
    return _g2_compress(s)


def pop_verify(pk: "PubKey", proof: bytes) -> bool:
    """Verify a proof of possession for pk."""
    try:
        s = _g2_decompress(proof)
    except ValueError:
        return False
    if s is None or not _on_curve(_FP2, s) or not _in_subgroup(_FP2, s):
        return False
    h = hash_to_g2(pk.data, POP_DST)
    neg_g1 = (G1_GEN[0], (-G1_GEN[1]) % P)
    return _pairings_product_is_one([(pk._aff, h), (neg_g1, s)])


def fast_aggregate_verify(pubkeys: list["PubKey"], msg: bytes, agg_sig: bytes) -> bool:
    """Same message, aggregated pubkeys: e(sum pk_i, H(m)) == e(g1, sig).

    SOUND ONLY for keys whose proof of possession has been verified
    (pop_verify) — without PoP an attacker can register
    pk_rogue = x*G1 - pk_victim and forge an "aggregate" the victim never
    signed (the rogue-key attack; draft-irtf-cfrg-bls-signature §3.3).
    Callers MUST check PoPs at key-registration time.

    With COMETBFT_TPU_BLS_DEVICE=1 the pubkey sum (the data-parallel
    part) runs on the card (ops/bls381.aggregate_pubkeys_device, K14);
    pairings always run on the host."""
    if not pubkeys:
        return False
    from .. import envknobs

    if envknobs.get_bool("COMETBFT_TPU_BLS_DEVICE", False) and len(pubkeys) >= 8:
        from ..ops import bls381 as _dev

        # the already-validated affine points: re-decompressing the bytes
        # would redo a host square root per validator
        agg_aff = _dev.aggregate_pubkeys_device([pk._aff for pk in pubkeys])
    else:
        acc = (_FP.one, _FP.one, _FP.zero)
        for pk in pubkeys:
            acc = _jac_add(_FP, acc, _from_affine(_FP, pk._aff))
        agg_aff = _to_affine(_FP, acc)
    try:
        s = _g2_decompress(agg_sig)
    except ValueError:
        return False
    if s is None or not _on_curve(_FP2, s) or not _in_subgroup(_FP2, s):
        return False
    h = hash_to_g2(msg)
    neg_g1 = (G1_GEN[0], (-G1_GEN[1]) % P)
    return _pairings_product_is_one([(agg_aff, h), (neg_g1, s)])
