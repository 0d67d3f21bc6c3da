// secp256k1 field, scalar and group arithmetic, and the per-row ECDSA
// verdict of K11 and K12 (secp.cu).
//
// Representation: a 256-bit value is 8 little-endian 32-bit words
// (word 0 least significant), products are 32x32->64 (mul.wide on the
// card).  The TPU version used 22 x 12-bit int32 limbs and one-hot
// matmuls because the TPU has neither 64-bit products nor fast gathers.
//
// Field (mod p = 2^256 - 2^32 - 977): CANONICAL everywhere — every
// operation takes and returns values in [0, p), so word equality is value
// equality.  A product is reduced with the pseudo-Mersenne fold
// 2^256 = 2^32 + 977 (mod p), see fp_reduce512 for the bound argument.
//
// Scalars (mod n, the group order): Montgomery CIOS with R = 2^256.
// sc_mont_mul(a, b) = a b R^-1 mod n, canonical, for any a < 2^256 and
// b < n (then a b < R n and the CIOS result is < 2n before its one
// conditional subtraction).  A plain value times a constant stored as
// c R mod n gives the plain product: that is how e / s, r / s and the GLV
// products are formed without leaving the plain domain.
//
// Points: Jacobian (X, Y, Z), x = X / Z^2, y = Y / Z^3, infinity is
// Z = 0.  pt_add and pt_add_affine are complete by branches: an
// infinity operand gives the other point, equal points fall to a
// doubling, opposite points give infinity — the same points as the JAX
// package's select-based pt_add (cometbft_tpu/ops/secp256k1.py:500).
//
// Field multiplies per group operation (the unit of the bounds in
// chip_smoke.py): doubling 7 (2M + 5S), mixed add 11 (8M + 3S), general
// add 16 (12M + 4S); inversion and square root 270 each (255 squarings
// and 15 multiplies, the addition chains below).  A scalar inversion is
// 330 Montgomery multiplies (4-bit window over n - 2).
#pragma once

#include "common.cuh"
#include "keccak.cuh"

#ifdef __CUDACC__
#define NOINL __device__ __noinline__
#else
#define NOINL static
#endif

typedef uint32_t u32;
typedef uint64_t u64;

// n, n / 2 (the low-s bound), R^2 mod n, R mod n, -n^-1 mod 2^32
DCONST u32 SECP_N[8] = {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u,
                        0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
DCONST u32 SECP_NHALF[8] = {0x681B20A0u, 0xDFE92F46u, 0x57A4501Du, 0x5D576E73u,
                            0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu};
DCONST u32 SECP_R2N[8] = {0x67D7D140u, 0x896CF214u, 0x0E7CF878u, 0x741496C2u,
                          0x5BCD07C6u, 0xE697F5E4u, 0x81C69BC5u, 0x9D671CD5u};
DCONST u32 SECP_ONE_N_MONT[8] = {0x2FC9BEBFu, 0x402DA173u, 0x50B75FC4u, 0x45512319u,
                                 0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u};
#define SECP_NINV 0x5588B13Fu
// n - 2 in 4-bit digits, most significant first (the Fermat inversion)
DCONST uint8_t SECP_NM2_NIBBLES[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 14,
    11, 10, 10, 14, 13, 12, 14, 6,  10, 15, 4,  8,  10, 0,  3,  11,
    11, 15, 13, 2,  5,  14, 8,  12, 13, 0,  3,  6,  4,  1,  3,  15};
// GLV: beta (a cube root of 1 mod p with lambda G = (beta Gx, Gy)), the
// rounding multipliers g1 (257 bits), g2, and the Montgomery-form
// constants m1 R, m2 R, lambda R mod n of ops/secp256k1.py (derived there
// from the curve; tests/test_torch_secp.py holds these words to them).
DCONST u32 SECP_BETA[8] = {0x8E6AFA40u, 0x3EC693D6u, 0xED0A766Au, 0x630FB68Au,
                           0x53CBCB16u, 0x919BB861u, 0x9A83F8EFu, 0x851695D4u};
DCONST u32 SECP_G1[9] = {0xD0A02FA2u, 0xFE04D548u, 0x0FDDD145u, 0x5FBC92C1u, 0x9D44CFD9u,
                         0x57C1108Du, 0xA8E2F3F6u, 0x14CA50F7u, 0x00000001u};
DCONST u32 SECP_G2[9] = {0x45DBB031u, 0xE893209Au, 0x71E8CA7Fu, 0x3DAA8A14u, 0x9284EB15u,
                         0xE86C90E4u, 0xA7D46BCDu, 0x3086D221u, 0x00000000u};
DCONST u32 SECP_M1R[8] = {0x6621FAABu, 0xB326003Cu, 0xBB8E4702u, 0x9C244F20u,
                          0x45DBB030u, 0xE893209Au, 0x71E8CA7Fu, 0x3DAA8A14u};
DCONST u32 SECP_M2R[8] = {0x5F3B205Au, 0x47A7F580u, 0xF9136BF6u, 0x036E0BBFu,
                          0x2F5FD05Du, 0x01FB2AB7u, 0xF0222EBAu, 0xA0436D3Eu};
DCONST u32 SECP_LAMR[8] = {0xD6DA15E4u, 0x8F26D1DBu, 0xDACAAC2Au, 0x48C9D21Fu,
                           0xAD96826Cu, 0x8C5699F9u, 0x7AA729C6u, 0xACD7BFE8u};

#define SECP_GLV_WINDOWS 33     // signed 4-bit digits of a |half| < 2^130
#define SECP_SHAMIR_WINDOWS 65  // signed 4-bit digits of a scalar < 2^256
// The G table: [G, phi(G)][j = 1..8][x, y][8 words], affine, canonical.
#define SECP_GTAB_WORDS (2 * 8 * 2 * 8)

// ------------------------------------------------------- 256-bit words

DEV void w_copy(u32 r[8], const u32 a[8]) {
  UNROLL
  for (int i = 0; i < 8; i++) r[i] = a[i];
}

DEV void w_set_small(u32 r[8], u32 v) {
  r[0] = v;
  UNROLL
  for (int i = 1; i < 8; i++) r[i] = 0;
}

DEV bool w_is_zero(const u32 a[8]) {
  u32 o = 0;
  UNROLL
  for (int i = 0; i < 8; i++) o |= a[i];
  return o == 0;
}

DEV bool w_eq(const u32 a[8], const u32 b[8]) {
  u32 o = 0;
  UNROLL
  for (int i = 0; i < 8; i++) o |= a[i] ^ b[i];
  return o == 0;
}

// r = a + b, returns the carry out
DEV u32 w_add(u32 r[8], const u32 a[8], const u32 b[8]) {
  u64 acc = 0;
  UNROLL
  for (int i = 0; i < 8; i++) {
    acc += (u64)a[i] + b[i];
    r[i] = (u32)acc;
    acc >>= 32;
  }
  return (u32)acc;
}

// r = a - b, returns the borrow out
DEV u32 w_sub(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 borrow = 0;
  UNROLL
  for (int i = 0; i < 8; i++) {
    u64 d = (u64)a[i] - b[i] - borrow;
    r[i] = (u32)d;
    borrow = (u32)(d >> 32) != 0;
  }
  return borrow;
}

DEV bool w_lt(const u32 a[8], const u32 b[8]) {
  u32 t[8];
  return w_sub(t, a, b) != 0;
}

// r = a + 2^32 + 977 (= a - p mod 2^256), returns the carry out
DEV u32 w_add_c(u32 r[8], const u32 a[8]) {
  u64 acc = (u64)a[0] + 977u;
  r[0] = (u32)acc;
  acc = (acc >> 32) + a[1] + 1u;
  r[1] = (u32)acc;
  acc >>= 32;
  UNROLL
  for (int i = 2; i < 8; i++) {
    acc += a[i];
    r[i] = (u32)acc;
    acc >>= 32;
  }
  return (u32)acc;
}

// r = a - 2^32 - 977 mod 2^256 (= a + p mod 2^256)
DEV void w_sub_c(u32 r[8], const u32 a[8]) {
  u64 d = (u64)a[0] - 977u;
  r[0] = (u32)d;
  u32 borrow = (u32)(d >> 32) != 0;
  d = (u64)a[1] - 1u - borrow;
  r[1] = (u32)d;
  borrow = (u32)(d >> 32) != 0;
  UNROLL
  for (int i = 2; i < 8; i++) {
    d = (u64)a[i] - borrow;
    r[i] = (u32)d;
    borrow = (u32)(d >> 32) != 0;
  }
}

// t = a b, 512 bits (operand scanning; (2^32-1)^2 + 2 (2^32-1) < 2^64)
DEV void w_mul_wide(u32 t[16], const u32 a[8], const u32 b[8]) {
  UNROLL
  for (int i = 0; i < 16; i++) t[i] = 0;
  UNROLL
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
    UNROLL
    for (int j = 0; j < 8; j++) {
      u64 x = (u64)a[j] * b[i] + t[i + j] + c;
      t[i + j] = (u32)x;
      c = x >> 32;
    }
    t[i + 8] = (u32)c;
  }
}

// ------------------------------------------------------------ mod p

// Any 256-bit value -> [0, p) (2^256 < 2p: one subtraction at most).
DEV void fp_canon(u32 r[8], const u32 a[8]) {
  u32 t[8];
  u32 c = w_add_c(t, a);  // a + 2^256 - p overflows iff a >= p
  UNROLL
  for (int i = 0; i < 8; i++) r[i] = c ? t[i] : a[i];
}

// 512-bit t = L + 2^256 H -> t mod p in [0, p).
//   1. u = L + 977 H + 2^32 H: word i takes L[i] + 977 H[i] + H[i-1] and
//      the carry (< 2^11), under 2^43; the top is H[7] + carry < 2^33.
//   2. the top (< 2^33) folds once more as top (2^32 + 977): a value
//      below 2^256 + 2^66, so the carry out is 0 or 1;
//   3. a carry of 1 adds 2^32 + 977 to a value below 2^66: no overflow;
//   4. fp_canon.
DEV void fp_reduce512(u32 r[8], const u32 t[16]) {
  u32 u[8];
  u64 acc = 0;
  UNROLL
  for (int i = 0; i < 8; i++) {
    acc += (u64)t[i] + (u64)t[8 + i] * 977u + (i ? t[7 + i] : 0u);
    u[i] = (u32)acc;
    acc >>= 32;
  }
  u64 top = acc + t[15];
  acc = (u64)u[0] + top * 977u;
  u[0] = (u32)acc;
  acc = (acc >> 32) + u[1] + top;
  u[1] = (u32)acc;
  acc >>= 32;
  UNROLL
  for (int i = 2; i < 8; i++) {
    acc += u[i];
    u[i] = (u32)acc;
    acc >>= 32;
  }
  if (acc) w_add_c(u, u);
  fp_canon(r, u);
}

NOINL void fp_mul(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 t[16];
  w_mul_wide(t, a, b);
  fp_reduce512(r, t);
}

DEV void fp_sqr(u32 r[8], const u32 a[8]) { fp_mul(r, a, a); }

DEV void fp_sqr_n(u32 r[8], const u32 a[8], int n) {
  w_copy(r, a);
  NOUNROLL
  for (int i = 0; i < n; i++) fp_mul(r, r, r);
}

// canonical a, b: a + b < 2p < 2^257
DEV void fp_add(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 s[8], t[8];
  u32 c1 = w_add(s, a, b);
  u32 c2 = w_add_c(t, s);
  UNROLL
  for (int i = 0; i < 8; i++) r[i] = (c1 | c2) ? t[i] : s[i];
}

DEV void fp_sub(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 d[8], t[8];
  u32 borrow = w_sub(d, a, b);
  w_sub_c(t, d);
  UNROLL
  for (int i = 0; i < 8; i++) r[i] = borrow ? t[i] : d[i];
}

DEV void fp_neg(u32 r[8], const u32 a[8]) {
  u32 z[8];
  w_set_small(z, 0);
  fp_sub(r, z, a);
}

// a^(2^k - 1) blocks of the addition chains of p - 2 and (p + 1) / 4
// (block lengths 1, 2, 22, 223; libsecp256k1's chain)
DEV void fp_x223(u32 x223[8], u32 x22[8], u32 x2[8], const u32 a[8]) {
  u32 x3[8], t[8], x11[8], x44[8], x88[8];
  fp_sqr(x2, a);
  fp_mul(x2, x2, a);
  fp_sqr(x3, x2);
  fp_mul(x3, x3, a);
  fp_sqr_n(t, x3, 3);
  fp_mul(t, t, x3);  // x6
  fp_sqr_n(t, t, 3);
  fp_mul(t, t, x3);  // x9
  fp_sqr_n(x11, t, 2);
  fp_mul(x11, x11, x2);
  fp_sqr_n(x22, x11, 11);
  fp_mul(x22, x22, x11);
  fp_sqr_n(x44, x22, 22);
  fp_mul(x44, x44, x22);
  fp_sqr_n(x88, x44, 44);
  fp_mul(x88, x88, x44);
  fp_sqr_n(t, x88, 88);
  fp_mul(t, t, x88);  // x176
  fp_sqr_n(t, t, 44);
  fp_mul(t, t, x44);  // x220
  fp_sqr_n(x223, t, 3);
  fp_mul(x223, x223, x3);
}

// a^(p - 2) = a^-1 for a != 0 (0 -> 0)
DEV void fp_inv(u32 r[8], const u32 a[8]) {
  u32 x223[8], x22[8], x2[8], t[8];
  fp_x223(x223, x22, x2, a);
  fp_sqr_n(t, x223, 23);
  fp_mul(t, t, x22);
  fp_sqr_n(t, t, 5);
  fp_mul(t, t, a);
  fp_sqr_n(t, t, 3);
  fp_mul(t, t, x2);
  fp_sqr_n(t, t, 2);
  fp_mul(r, t, a);
}

// a^((p + 1) / 4): a square root of a when a is a residue
DEV void fp_sqrt_cand(u32 r[8], const u32 a[8]) {
  u32 x223[8], x22[8], x2[8], t[8];
  fp_x223(x223, x22, x2, a);
  fp_sqr_n(t, x223, 23);
  fp_mul(t, t, x22);
  fp_sqr_n(t, t, 6);
  fp_mul(t, t, x2);
  fp_sqr_n(r, t, 2);
}

// y^2 == x^3 + 7 for canonical x, y
DEV bool fp_on_curve(const u32 x[8], const u32 y[8]) {
  u32 l[8], rr[8], seven[8];
  fp_sqr(l, y);
  fp_sqr(rr, x);
  fp_mul(rr, rr, x);
  w_set_small(seven, 7);
  fp_add(rr, rr, seven);
  return w_eq(l, rr);
}

// ------------------------------------------------------------ mod n

NOINL void sc_mont_mul(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 t[10];
  UNROLL
  for (int i = 0; i < 10; i++) t[i] = 0;
  UNROLL
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
    UNROLL
    for (int j = 0; j < 8; j++) {
      u64 x = (u64)a[j] * b[i] + t[j] + c;
      t[j] = (u32)x;
      c = x >> 32;
    }
    u64 x = (u64)t[8] + c;
    t[8] = (u32)x;
    t[9] = (u32)(x >> 32);
    u32 m = t[0] * SECP_NINV;
    x = (u64)m * SECP_N[0] + t[0];
    c = x >> 32;
    UNROLL
    for (int j = 1; j < 8; j++) {
      x = (u64)m * SECP_N[j] + t[j] + c;
      t[j - 1] = (u32)x;
      c = x >> 32;
    }
    x = (u64)t[8] + c;
    t[7] = (u32)x;
    t[8] = t[9] + (u32)(x >> 32);
  }
  // t < 2n: subtract n once when t[8] is set or t[0..7] >= n
  u32 d[8];
  u32 borrow = w_sub(d, t, SECP_N);
  bool sub = t[8] != 0 || !borrow;
  UNROLL
  for (int i = 0; i < 8; i++) r[i] = sub ? d[i] : t[i];
}

// canonical a, b < n
DEV void sc_add(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 s[8], d[8];
  u32 c = w_add(s, a, b);
  u32 borrow = w_sub(d, s, SECP_N);
  bool sub = c || !borrow;
  UNROLL
  for (int i = 0; i < 8; i++) r[i] = sub ? d[i] : s[i];
}

DEV void sc_sub(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 d[8], t[8];
  u32 borrow = w_sub(d, a, b);
  w_add(t, d, SECP_N);
  UNROLL
  for (int i = 0; i < 8; i++) r[i] = borrow ? t[i] : d[i];
}

DEV void sc_neg(u32 r[8], const u32 a[8]) {
  u32 z[8];
  w_set_small(z, 0);
  sc_sub(r, z, a);
}

// xm = x R (Montgomery form) -> x^-1 R: xm^(n-2) in Montgomery arithmetic,
// a 4-bit fixed window (table of xm^0..xm^15 in local memory)
DEV void sc_inv_mont(u32 r[8], const u32 xm[8]) {
  u32 tab[16][8];
  w_copy(tab[0], SECP_ONE_N_MONT);
  w_copy(tab[1], xm);
  NOUNROLL
  for (int j = 2; j < 16; j++) sc_mont_mul(tab[j], tab[j - 1], xm);
  u32 acc[8];
  w_copy(acc, tab[SECP_NM2_NIBBLES[0]]);
  NOUNROLL
  for (int i = 1; i < 64; i++) {
    UNROLL
    for (int k = 0; k < 4; k++) sc_mont_mul(acc, acc, acc);
    int nib = SECP_NM2_NIBBLES[i];
    if (nib) sc_mont_mul(acc, acc, tab[nib]);
  }
  w_copy(r, acc);
}

// ------------------------------------------------------------ GLV

// round(k g / 2^384) for k < 2^256 and a 9-word g: (k g + 2^383) >> 384,
// bits 384..512 of a 544-bit sum (5 words; the rest zero)
DEV void glv_mul_shift_384(u32 c[8], const u32 k[8], const u32 g[9]) {
  u32 t[17];
  UNROLL
  for (int i = 0; i < 17; i++) t[i] = 0;
  UNROLL
  for (int i = 0; i < 9; i++) {
    u64 cc = 0;
    UNROLL
    for (int j = 0; j < 8; j++) {
      u64 x = (u64)k[j] * g[i] + t[i + j] + cc;
      t[i + j] = (u32)x;
      cc = x >> 32;
    }
    t[i + 8] = (u32)cc;
  }
  u64 acc = (u64)t[11] + 0x80000000u;
  acc >>= 32;
  UNROLL
  for (int i = 12; i < 17; i++) {
    acc += t[i];
    c[i - 12] = (u32)acc;
    acc >>= 32;
  }
  c[5] = c[6] = c[7] = 0;
}

// canonical k in [0, n) holding a signed half: k < 2^132 is the half
// itself, anything else is half + n
DEV void glv_signed_abs(u32 mag[8], bool& neg, const u32 k[8]) {
  neg = (k[4] >> 4) != 0 || k[5] != 0 || k[6] != 0 || k[7] != 0;
  if (neg) {
    sc_neg(mag, k);
  } else {
    w_copy(mag, k);
  }
}

// k (canonical, mod n) -> |k1|, |k2| (< 2^130) and their signs with
// k1 + lambda k2 == k (mod n); the device form of _split_host
// (cometbft_tpu/ops/secp256k1.py:244, basis :185-236)
DEV void glv_split(u32 k1[8], bool& n1, u32 k2[8], bool& n2, const u32 k[8]) {
  u32 c1[8], c2[8], t1[8], t2[8], kk2[8], kk1[8];
  glv_mul_shift_384(c1, k, SECP_G1);
  glv_mul_shift_384(c2, k, SECP_G2);
  sc_mont_mul(t1, c1, SECP_M1R);  // c1 m1 mod n
  sc_mont_mul(t2, c2, SECP_M2R);  // c2 m2 mod n
  sc_add(kk2, t1, t2);
  sc_mont_mul(t1, kk2, SECP_LAMR);  // lambda k2 mod n
  sc_sub(kk1, k, t1);
  glv_signed_abs(k1, n1, kk1);
  glv_signed_abs(k2, n2, kk2);
}

// signed radix-16 digits in [-8, 8], least significant first; returns the
// carry out of the last window (0 for the widths used here)
DEV int recode_signed4(int8_t d[], const u32 k[8], int nwin) {
  int carry = 0;
  NOUNROLL
  for (int i = 0; i < nwin; i++) {
    int nib = i < 64 ? (int)((k[i >> 3] >> (4 * (i & 7))) & 15u) : 0;
    int v = nib + carry;
    carry = v >= 8;
    d[i] = (int8_t)(v - 16 * carry);
  }
  return carry;
}

// ------------------------------------------------------------ points

struct jac {
  u32 X[8], Y[8], Z[8];
};

DEV bool pt_is_inf(const jac& p) { return w_is_zero(p.Z); }

DEV void pt_set_inf(jac& p) {
  w_set_small(p.X, 1);
  w_set_small(p.Y, 1);
  w_set_small(p.Z, 0);
}

// dbl-2009-l (a = 0): 2M + 5S.  Z = 0 stays 0.
NOINL void pt_double(jac& r, const jac& p) {
  u32 A[8], B[8], C[8], D[8], E[8], F[8], t[8];
  fp_sqr(A, p.X);
  fp_sqr(B, p.Y);
  fp_sqr(C, B);
  fp_add(t, p.X, B);
  fp_sqr(t, t);
  fp_sub(t, t, A);
  fp_sub(t, t, C);
  fp_add(D, t, t);
  fp_add(E, A, A);
  fp_add(E, E, A);
  fp_sqr(F, E);
  u32 Z3[8];
  fp_mul(Z3, p.Y, p.Z);
  fp_add(r.Z, Z3, Z3);
  fp_sub(r.X, F, D);
  fp_sub(r.X, r.X, D);
  fp_sub(t, D, r.X);
  fp_mul(t, E, t);
  fp_add(C, C, C);
  fp_add(C, C, C);
  fp_add(C, C, C);  // 8C
  fp_sub(r.Y, t, C);
}

// r = p + (x2, y2) for an affine (never infinite) second operand:
// 8M + 3S, complete by branches
NOINL void pt_add_affine(jac& r, const jac& p, const u32 x2[8], const u32 y2[8]) {
  if (pt_is_inf(p)) {
    w_copy(r.X, x2);
    w_copy(r.Y, y2);
    w_set_small(r.Z, 1);
    return;
  }
  u32 z1z1[8], U2[8], S2[8], H[8], R[8];
  fp_sqr(z1z1, p.Z);
  fp_mul(U2, x2, z1z1);
  fp_mul(S2, y2, p.Z);
  fp_mul(S2, S2, z1z1);
  fp_sub(H, U2, p.X);
  fp_sub(R, S2, p.Y);
  if (w_is_zero(H)) {
    if (w_is_zero(R)) {
      jac q = p;
      pt_double(r, q);
    } else {
      pt_set_inf(r);
    }
    return;
  }
  u32 HH[8], HHH[8], V[8], X3[8], t[8];
  fp_sqr(HH, H);
  fp_mul(HHH, H, HH);
  fp_mul(V, p.X, HH);
  fp_sqr(X3, R);
  fp_sub(X3, X3, HHH);
  fp_sub(X3, X3, V);
  fp_sub(X3, X3, V);
  fp_sub(t, V, X3);
  fp_mul(t, R, t);
  fp_mul(HHH, p.Y, HHH);
  fp_sub(r.Y, t, HHH);
  fp_mul(r.Z, p.Z, H);
  w_copy(r.X, X3);
}

// r = p + q, Jacobian: 12M + 4S, complete by branches
NOINL void pt_add(jac& r, const jac& p, const jac& q) {
  if (pt_is_inf(p)) {
    r = q;
    return;
  }
  if (pt_is_inf(q)) {
    r = p;
    return;
  }
  u32 z1z1[8], z2z2[8], U1[8], U2[8], S1[8], S2[8], H[8], R[8];
  fp_sqr(z1z1, p.Z);
  fp_sqr(z2z2, q.Z);
  fp_mul(U1, p.X, z2z2);
  fp_mul(U2, q.X, z1z1);
  fp_mul(S1, p.Y, q.Z);
  fp_mul(S1, S1, z2z2);
  fp_mul(S2, q.Y, p.Z);
  fp_mul(S2, S2, z1z1);
  fp_sub(H, U2, U1);
  fp_sub(R, S2, S1);
  if (w_is_zero(H)) {
    if (w_is_zero(R)) {
      jac pp = p;
      pt_double(r, pp);
    } else {
      pt_set_inf(r);
    }
    return;
  }
  u32 HH[8], HHH[8], V[8], X3[8], t[8], Z3[8];
  fp_sqr(HH, H);
  fp_mul(HHH, H, HH);
  fp_mul(V, U1, HH);
  fp_sqr(X3, R);
  fp_sub(X3, X3, HHH);
  fp_sub(X3, X3, V);
  fp_sub(X3, X3, V);
  fp_sub(t, V, X3);
  fp_mul(t, R, t);
  fp_mul(HHH, S1, HHH);
  fp_mul(Z3, p.Z, q.Z);
  fp_mul(r.Z, Z3, H);
  fp_sub(r.Y, t, HHH);
  w_copy(r.X, X3);
}

// acc += d * T for a signed digit d against the fixed affine table
// (entries 1..8 of G or phi(G), read through the read-only cache: lanes
// read different entries); `neg` flips the sign (a negative GLV half)
DEV void walk_add_fixed(jac& acc, int d, bool neg, const u32* tab) {
  if (d == 0) return;
  int j = (d < 0 ? -d : d) - 1;
  u32 x[8], y[8];
  UNROLL
  for (int i = 0; i < 8; i++) {
    x[i] = LDG(tab + (j * 2 + 0) * 8 + i);
    y[i] = LDG(tab + (j * 2 + 1) * 8 + i);
  }
  if ((d < 0) != neg) fp_neg(y, y);
  pt_add_affine(acc, acc, x, y);
}

// acc += d * T for the lane's own Jacobian table of j Q (j = 1..8, local
// memory); phi multiplies X by beta at lookup instead of keeping a
// second table
DEV void walk_add_var(jac& acc, int d, bool neg, const jac T[8], bool phi) {
  if (d == 0) return;
  jac e = T[(d < 0 ? -d : d) - 1];
  if (phi) fp_mul(e.X, e.X, SECP_BETA);
  if ((d < 0) != neg) fp_neg(e.Y, e.Y);
  pt_add(acc, acc, e);
}

// acc = u1 G + u2 Q for canonical scalars u1, u2 < n and an affine,
// on-curve Q (so j Q is never infinity for j <= 8).  GLV: both scalars
// split into signed halves, 33 windows over G, phi(G), Q, phi(Q).
// Shamir (the witness): 65 windows over G and Q.
template <bool GLV>
DEV void secp_walk(jac& acc, const u32 u1[8], const u32 u2[8], const u32 qx[8],
                   const u32 qy[8], const u32* gtab) {
  jac T[8];
  w_copy(T[0].X, qx);
  w_copy(T[0].Y, qy);
  w_set_small(T[0].Z, 1);
  pt_double(T[1], T[0]);
  NOUNROLL
  for (int j = 2; j < 8; j++) pt_add_affine(T[j], T[j - 1], qx, qy);
  pt_set_inf(acc);
  if (GLV) {
    u32 a1[8], a2[8], b1[8], b2[8];
    bool na1, na2, nb1, nb2;
    glv_split(a1, na1, a2, na2, u1);
    glv_split(b1, nb1, b2, nb2, u2);
    int8_t d[4][SECP_GLV_WINDOWS];
    recode_signed4(d[0], a1, SECP_GLV_WINDOWS);
    recode_signed4(d[1], a2, SECP_GLV_WINDOWS);
    recode_signed4(d[2], b1, SECP_GLV_WINDOWS);
    recode_signed4(d[3], b2, SECP_GLV_WINDOWS);
    NOUNROLL
    for (int w = SECP_GLV_WINDOWS - 1; w >= 0; w--) {
      if (!pt_is_inf(acc)) {
        NOUNROLL
        for (int k = 0; k < 4; k++) pt_double(acc, acc);
      }
      walk_add_fixed(acc, d[0][w], na1, gtab);
      walk_add_fixed(acc, d[1][w], na2, gtab + 16 * 8);
      walk_add_var(acc, d[2][w], nb1, T, false);
      walk_add_var(acc, d[3][w], nb2, T, true);
    }
  } else {
    int8_t d[2][SECP_SHAMIR_WINDOWS];
    recode_signed4(d[0], u1, SECP_SHAMIR_WINDOWS);
    recode_signed4(d[1], u2, SECP_SHAMIR_WINDOWS);
    NOUNROLL
    for (int w = SECP_SHAMIR_WINDOWS - 1; w >= 0; w--) {
      if (!pt_is_inf(acc)) {
        NOUNROLL
        for (int k = 0; k < 4; k++) pt_double(acc, acc);
      }
      walk_add_fixed(acc, d[0][w], false, gtab);
      walk_add_var(acc, d[1][w], false, T, false);
    }
  }
}

// ------------------------------------------------------------ the verdict

// One row of the batched ECDSA check (cometbft_tpu/ops/secp256k1.py:861
// verify_batch).  Inputs are raw 256-bit values as words: the pubkey's
// affine coordinates (host-decoded; q_valid is the host's verdict on the
// encoding), the message hash e, the signature's r and s; is_eth selects
// R||S||V semantics with recovery id v; under RECOVER, is_rec rows carry
// no key: R is lifted from r and v, the signer recovered and its address
// Keccak256(x || y)[12:] compared with addr (20 bytes).
//
// A row that fails validation returns false before the walk: the
// reference's verdict is row_pre AND the rest, so the walk cannot change
// it (the JAX program walks such rows as infinity and masks them).
template <bool GLV, bool RECOVER>
DEV bool secp_verify_row(const u32 qx[8], const u32 qy[8], bool q_valid,
                         const u32 e[8], const u32 r[8], const u32 s[8],
                         bool is_eth, int v, bool is_rec_in, const uint8_t* addr,
                         const u32* gtab) {
  const bool is_rec = RECOVER && is_rec_in;
  bool r_ok = !w_is_zero(r) && w_lt(r, SECP_N);
  bool s_ok = !w_is_zero(s) && w_lt(s, SECP_N) && !w_lt(SECP_NHALF, s);
  bool v_ok = (is_eth || is_rec) ? v <= 1 : true;
  if (!(r_ok && s_ok && v_ok)) return false;
  u32 px[8], py[8];
  if (is_rec) {
    // R = (r, sqrt(r^3 + 7)) with the parity v (r < n < p)
    u32 y2[8], seven[8], chk[8];
    fp_sqr(y2, r);
    fp_mul(y2, y2, r);
    w_set_small(seven, 7);
    fp_add(y2, y2, seven);
    fp_sqrt_cand(py, y2);
    fp_sqr(chk, py);
    if (!w_eq(chk, y2)) return false;  // r^3 + 7 is not a residue
    if ((int)(py[0] & 1u) != v) fp_neg(py, py);
    w_copy(px, r);
  } else {
    if (!q_valid) return false;
    fp_canon(px, qx);
    fp_canon(py, qy);
    if (!fp_on_curve(px, py)) return false;
  }
  // verify rows: u1 = e / s, u2 = r / s; ecrecover rows: u1 = -e / r,
  // u2 = s / r (mod n); e is reduced mod n inside the product
  u32 t[8], wm[8], u1[8], u2[8];
  sc_mont_mul(t, is_rec ? r : s, SECP_R2N);
  sc_inv_mont(wm, t);
  sc_mont_mul(u1, e, wm);
  if (is_rec) sc_neg(u1, u1);
  sc_mont_mul(u2, is_rec ? s : r, wm);
  jac acc;
  secp_walk<GLV>(acc, u1, u2, px, py, gtab);
  if (pt_is_inf(acc)) return false;
  u32 zi[8], zi2[8], x[8], y[8];
  fp_inv(zi, acc.Z);
  fp_sqr(zi2, zi);
  fp_mul(x, acc.X, zi2);
  fp_mul(y, acc.Y, zi2);
  fp_mul(y, y, zi);
  if (is_rec) {
    uint64_t dg[4];
    keccak256_xy(dg, x, y);
    bool same = true;
    for (int b = 12; b < 32; b++) {
      same &= (uint8_t)(dg[b >> 3] >> (8 * (b & 7))) == addr[b - 12];
    }
    return same;
  }
  bool x_eq_r = w_eq(x, r);
  if (is_eth) return x_eq_r && (int)(y[0] & 1u) == v;
  if (x_eq_r) return true;
  // x == r + n (only when r + n < p)
  u32 rn[8], pc[8];
  u32 c = w_add(rn, r, SECP_N);
  if (c) return false;
  u32 c2 = w_add_c(pc, rn);  // rn >= p iff rn + 2^256 - p overflows
  return !c2 && w_eq(x, rn);
}
