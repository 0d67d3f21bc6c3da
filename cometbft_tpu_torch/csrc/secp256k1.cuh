// secp256k1 field, scalar and group arithmetic, and the block algorithm of
// K11 and K12 (secp.cu): SECP_T threads share each row, a block holds
// SECP_ROWS rows and shares one inversion per kind among them.
//
// Representation: a 256-bit value is 8 little-endian 32-bit words
// (word 0 least significant), products are 32x32->64 (mul.wide on the
// card).  The TPU version used 22 x 12-bit int32 limbs and one-hot
// matmuls because the TPU has neither 64-bit products nor fast gathers.
//
// Groups.  SECP_T = 4 threads (lanes) work on one row.  Each runs one
// of the row's four GLV sub-walks (a1 G, a2 phi(G), b1 Q, b2 phi(Q)) in
// one-thread arithmetic, all in registers; two rounds of shuffles (g_xchg)
// then add the four partial points.  Everything else about the row —
// checks, hashing, scalars, the table of j Q, the verdict — every lane of
// the group runs on the same words (the lanes of a warp issue it once),
// so it needs no exchange.  A group's lanes only diverge in their
// sub-walks.
//
// Host build: outside nvcc SECP_GL = SECP_T, a row carries all four
// lanes' sub-walks, the walk loops over them (LANES) and the exchange
// helpers move words between the lane slots, so g++ runs one group (and,
// with secp_block_host, a block) step for step as the card does.
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
// Field multiplies per group operation: doubling 7 (2M + 5S), mixed add
// 11 (8M + 3S), general add 16 (12M + 4S); the square root 270 (255
// squarings and 15 multiplies, the addition chain below).  chip_smoke.py's
// bound counts the work of the one-thread design that came first (general
// adds of 16 for Q, a scalar Fermat chain and a field inversion per row),
// so that the bound stays one yardstick across the PRs.
#pragma once

#include "common.cuh"
#include "keccak.cuh"
#include "sha256.cuh"

typedef uint32_t u32;
typedef uint64_t u64;

// A step that runs once a row (the checks, the square root, the trees of
// the block's inversions, the verdict) or almost never (the doubling of
// equal points) is a call on the card: cicc then optimises it once for
// all the kernels that share it (ptxas still compiles it into each).  The
// walk's field and point operations (DEV) stay inlined.  With the walk's
// combine rounds a loop, secp.cu builds in ~110 s instead of ~175 s on
// an H100 machine's host (PERF.md).
#ifdef __CUDACC__
#define SECP_ONCE __device__ __noinline__
#else
#define SECP_ONCE static inline
#endif

// n, n / 2 (the low-s bound), R^2 mod n, R mod n, R^3 mod n, -n^-1 mod 2^32
DCONST u32 SECP_N[8] = {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u,
                        0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
DCONST u32 SECP_NHALF[8] = {0x681B20A0u, 0xDFE92F46u, 0x57A4501Du, 0x5D576E73u,
                            0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu};
DCONST u32 SECP_R2N[8] = {0x67D7D140u, 0x896CF214u, 0x0E7CF878u, 0x741496C2u,
                          0x5BCD07C6u, 0xE697F5E4u, 0x81C69BC5u, 0x9D671CD5u};
DCONST u32 SECP_ONE_N_MONT[8] = {0x2FC9BEBFu, 0x402DA173u, 0x50B75FC4u, 0x45512319u,
                                 0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u};
DCONST u32 SECP_R3N[8] = {0xE9FF41EDu, 0x7BC0CFE0u, 0x44D4322Cu, 0x00176484u,
                          0xF1D0B2DAu, 0xB1B31347u, 0x18EF116Du, 0x555D800Cu};
#define SECP_NINV 0x5588B13Fu
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
// The G table (gtab): [G, phi(G)][j = 1..8][x, y][8 words], affine, canonical.

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

DEV void w_select(u32 r[8], bool c, const u32 a[8], const u32 b[8]) {
  UNROLL
  for (int i = 0; i < 8; i++) r[i] = c ? a[i] : b[i];
}

DEV bool w_is_zero(const u32 a[8]) {
  u32 o = 0;
  UNROLL
  for (int i = 0; i < 8; i++) o |= a[i];
  return o == 0;
}

DEV bool w_is_one(const u32 a[8]) {
  u32 o = a[0] ^ 1u;
  UNROLL
  for (int i = 1; i < 8; i++) o |= a[i];
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

// a = (a + top 2^256) / 2
DEV void w_shr1(u32 a[8], u32 top) {
  UNROLL
  for (int i = 0; i < 7; i++) a[i] = (a[i] >> 1) | (a[i + 1] << 31);
  a[7] = (a[7] >> 1) | (top << 31);
}

// ------------------------------------------------------------ mod n

DEV void sc_mont_mul(u32 r[8], const u32 a[8], const u32 b[8]) {
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
  w_select(r, t[8] != 0 || !borrow, d, t);
}

// canonical a, b < n
DEV void sc_add(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 s[8], d[8];
  u32 c = w_add(s, a, b);
  u32 borrow = w_sub(d, s, SECP_N);
  w_select(r, c || !borrow, d, s);
}

DEV void sc_sub(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 d[8], t[8];
  u32 borrow = w_sub(d, a, b);
  w_add(t, d, SECP_N);
  w_select(r, borrow != 0, t, d);
}

DEV void sc_neg(u32 r[8], const u32 a[8]) {
  u32 z[8];
  w_set_small(z, 0);
  sc_sub(r, z, a);
}

// a^-1 mod m for an odd prime m and a in [1, m) (0 -> 0): the binary
// extended Euclid, x1 a = u and x2 a = v (mod m) throughout.  Its time
// depends on a; every value here is public.
DEV void w_inv_gcd(u32 r[8], const u32 a[8], const u32 m[8]) {
  u32 u[8], v[8], x1[8], x2[8];
  w_copy(u, a);
  w_copy(v, m);
  w_set_small(x1, 1);
  w_set_small(x2, 0);
  if (w_is_zero(u)) {
    w_set_small(r, 0);
    return;
  }
  NOUNROLL
  while (!w_is_one(u) && !w_is_one(v)) {
    NOUNROLL
    while (!(u[0] & 1u)) {
      w_shr1(u, 0);
      w_shr1(x1, (x1[0] & 1u) ? w_add(x1, x1, m) : 0u);  // x1 / 2 mod m
    }
    NOUNROLL
    while (!(v[0] & 1u)) {
      w_shr1(v, 0);
      w_shr1(x2, (x2[0] & 1u) ? w_add(x2, x2, m) : 0u);
    }
    if (w_lt(u, v)) {
      w_sub(v, v, u);
      if (w_sub(x2, x2, x1)) w_add(x2, x2, m);
    } else {
      w_sub(u, u, v);
      if (w_sub(x1, x1, x2)) w_add(x1, x1, m);
    }
  }
  w_select(r, w_is_one(u), x1, x2);
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
  u32 m[8];
  neg = (k[4] >> 4) != 0 || k[5] != 0 || k[6] != 0 || k[7] != 0;
  sc_neg(m, k);
  w_select(mag, neg, m, k);
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

// Signed radix-16 digits of k < 2^(4 nwin - 2), nwin = 8 NW - 7: the
// digits in [-8, 7] are the nibbles of K = k + sum_i 8 16^i less 8 (the
// representation is unique, so they are those of the plain version's
// recode_signed4).  kd holds K shifted up 28 bits, so the top digit is
// always the top nibble of kd[NW - 1]: digit_next takes it and shifts.
template <int NW>
DEV void digit_words(u32 kd[NW], const u32 k[8]) {
  u32 t[NW];
  u64 acc = 0;
  UNROLL
  for (int j = 0; j < NW; j++) {
    acc += (u64)(j < 8 ? k[j] : 0u) + (j < NW - 1 ? 0x88888888u : 8u);
    t[j] = (u32)acc;
    acc >>= 32;
  }
  kd[0] = t[0] << 28;
  UNROLL
  for (int j = 1; j < NW; j++) kd[j] = (t[j] << 28) | (t[j - 1] >> 4);
}

template <int NW>
DEV int digit_next(u32 kd[NW]) {
  int d = (int)(kd[NW - 1] >> 28) - 8;
  UNROLL
  for (int j = NW - 1; j > 0; j--) kd[j] = (kd[j] << 4) | (kd[j - 1] >> 28);
  kd[0] <<= 4;
  return d;
}

// ------------------------------------------------------------ mod p
// One-thread field arithmetic, in registers (every function inlines).

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

// Any 256-bit value -> [0, p) (2^256 < 2p: one subtraction at most).
DEV void fp_canon(u32 r[8], const u32 a[8]) {
  u32 t[8];
  u32 c = w_add_c(t, a);  // a + 2^256 - p overflows iff a >= p
  w_select(r, c != 0, t, a);
}

// 512-bit t = L + 2^256 H -> t mod p in [0, p), by the pseudo-Mersenne
// fold 2^256 = 2^32 + 977 (mod p):
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

// r = a b mod p for a, b < 2^256 (r may be a or b)
DEV void fp_mul(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 t[16];
  w_mul_wide(t, a, b);
  fp_reduce512(r, t);
}

// t = a^2, 512 bits: the 28 products a_i a_j (i < j) once, doubled by a
// shift, plus the 8 squares a_i^2 (36 products where fp_mul takes 64)
DEV void w_sqr_wide(u32 t[16], const u32 a[8]) {
  u32 s[16];
  UNROLL
  for (int i = 0; i < 16; i++) s[i] = 0;
  UNROLL
  for (int i = 0; i < 7; i++) {
    u64 c = 0;
    UNROLL
    for (int j = i + 1; j < 8; j++) {
      u64 x = (u64)a[i] * a[j] + s[i + j] + c;
      s[i + j] = (u32)x;
      c = x >> 32;
    }
    s[i + 8] = (u32)c;
  }
  u64 acc = 0;
  UNROLL
  for (int i = 0; i < 8; i++) {
    const u64 sq = (u64)a[i] * a[i];
    const u32 d0 = (s[2 * i] << 1) | (i ? s[2 * i - 1] >> 31 : 0u);
    const u32 d1 = (s[2 * i + 1] << 1) | (s[2 * i] >> 31);
    acc += (u64)d0 + (u32)sq;
    t[2 * i] = (u32)acc;
    acc >>= 32;
    acc += (u64)d1 + (sq >> 32);
    t[2 * i + 1] = (u32)acc;
    acc >>= 32;
  }
}

DEV void fp_sqr(u32 r[8], const u32 a[8]) {
  u32 t[16];
  w_sqr_wide(t, a);
  fp_reduce512(r, t);
}

// canonical a, b: a + b < 2p < 2^257
DEV void fp_add(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 s[8], t[8];
  u32 c1 = w_add(s, a, b);
  u32 c2 = w_add_c(t, s);
  w_select(r, (c1 | c2) != 0, t, s);
}

DEV void fp_sub(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 d[8], t[8];
  u32 borrow = w_sub(d, a, b);
  w_sub_c(t, d);
  w_select(r, borrow != 0, t, d);
}

DEV void fp_neg(u32 r[8], const u32 a[8]) {
  u32 z[8];
  w_set_small(z, 0);
  fp_sub(r, z, a);
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

// a^((p + 1) / 4), a square root of a when a is a residue, by a fixed
// addition chain: each step is t = (from < 0 ? t : slot[from]) ^ (2^nsq)
// * slot[mul] (mul < 0: no multiply), then slot[save] = t.  The slots a,
// x2, x3, x11, x22, x44, x88 hold a^(2^k - 1); the blocks of lengths 1,
// 2, 22, 223 are libsecp256k1's chain.  One squaring and one multiply are
// compiled, the slots stay in registers (read and written by selects).
#define SECP_SQRT_STEPS 14
DCONST int8_t SECP_SQRT_CHAIN[SECP_SQRT_STEPS][4] = {
    {0, 1, 0, 1},    {1, 1, 0, 2},    {2, 3, 2, -1},  {-1, 3, 2, -1}, {-1, 2, 1, 3},
    {3, 11, 3, 4},   {4, 22, 4, 5},   {5, 44, 5, 6},  {6, 88, 6, -1}, {-1, 44, 5, -1},
    {-1, 3, 2, -1},  {-1, 23, 4, -1}, {-1, 6, 1, -1}, {-1, 2, -1, -1}};

SECP_ONCE void fp_sqrt_cand(u32 r[8], const u32 a[8]) {
  u32 slot[7][8], t[8], m[8];
  w_copy(slot[0], a);
  w_copy(t, a);
  NOUNROLL
  for (int s = 0; s < SECP_SQRT_STEPS; s++) {
    const int from = SECP_SQRT_CHAIN[s][0], nsq = SECP_SQRT_CHAIN[s][1];
    const int mul = SECP_SQRT_CHAIN[s][2], save = SECP_SQRT_CHAIN[s][3];
    UNROLL
    for (int k = 0; k < 7; k++) w_select(t, from == k, slot[k], t);
    NOUNROLL
    for (int k = 0; k < nsq; k++) fp_sqr(t, t);
    if (mul >= 0) {
      w_copy(m, slot[0]);
      UNROLL
      for (int k = 1; k < 7; k++) w_select(m, mul == k, slot[k], m);
      fp_mul(t, t, m);
    }
    UNROLL
    for (int k = 1; k < 7; k++) w_select(slot[k], save == k, t, slot[k]);
  }
  w_copy(r, t);
}

// ------------------------------------------------------------ points
// One thread's Jacobian points (X, Y, Z): x = X / Z^2, y = Y / Z^3,
// infinity is Z = 0.  pt_madd and pt_add are complete by branches: an
// infinity operand gives the other point, equal points fall to a
// doubling, opposite points give infinity — the same points as the JAX
// package's select-based pt_add (cometbft_tpu/ops/secp256k1.py:500).

struct jac {
  u32 X[8], Y[8], Z[8];
};

DEV bool pt_is_inf(const jac& p) { return w_is_zero(p.Z); }

DEV void pt_set_inf(jac& p) {
  w_set_small(p.X, 1);
  w_set_small(p.Y, 1);
  w_set_small(p.Z, 0);
}

DEV void pt_select(jac& r, bool c, const jac& a, const jac& b) {
  w_select(r.X, c, a.X, b.X);
  w_select(r.Y, c, a.Y, b.Y);
  w_select(r.Z, c, a.Z, b.Z);
}

// dbl-2009-l (a = 0): 2M + 5S.  Z = 0 stays 0.  r may be p.
DEV void pt_double(jac& r, const jac& p) {
  u32 A[8], B[8], C[8], D[8], E[8], F[8], t[8], Z3[8];
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

// The doubling a complete add falls to on equal points: never on an
// honest row, so a call (by value: the caller's point stays in registers)
// rather than one more inlined doubling in every walk.
SECP_ONCE jac pt_double_rare(const jac p) {
  jac r;
  pt_double(r, p);
  return r;
}

// H = x2 Z1^2 - X1 and R = y2 Z1^3 - Y1 of p + (x2, y2)
DEV void pt_madd_hr(u32 H[8], u32 R[8], const jac& p, const u32 x2[8], const u32 y2[8]) {
  u32 z1z1[8], U2[8], S2[8];
  fp_sqr(z1z1, p.Z);
  fp_mul(U2, x2, z1z1);
  fp_mul(S2, y2, p.Z);
  fp_mul(S2, S2, z1z1);
  fp_sub(H, U2, p.X);
  fp_sub(R, S2, p.Y);
}

// p += (x2, y2) for a finite p and H != 0: 8M + 3S in all (Z3 = Z1 H)
DEV void pt_madd_core(jac& p, const u32 H[8], const u32 R[8]) {
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
  fp_sub(p.Y, t, HHH);
  fp_mul(p.Z, p.Z, H);
  w_copy(p.X, X3);
}

// p += (x2, y2) affine, complete; returns true when the points are equal
// and the caller must double p instead
DEV bool pt_madd(jac& p, const u32 x2[8], const u32 y2[8]) {
  if (pt_is_inf(p)) {
    w_copy(p.X, x2);
    w_copy(p.Y, y2);
    w_set_small(p.Z, 1);
    return false;
  }
  u32 H[8], R[8];
  pt_madd_hr(H, R, p, x2, y2);
  if (w_is_zero(H)) {
    if (w_is_zero(R)) return true;
    pt_set_inf(p);
    return false;
  }
  pt_madd_core(p, H, R);
  return false;
}

// r = p + q, Jacobian: 12M + 4S, complete by branches
DEV void pt_add(jac& r, const jac& p, const jac& q) {
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
      r = pt_double_rare(p);
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

// ------------------------------------------------------------ groups

#define SECP_T 4                      // threads per row
#define SECP_ROWS 32                  // rows (groups) per block
#define SECP_BLOCK (SECP_T * SECP_ROWS)
#define SECP_FP_ROOT (SECP_ROWS / 2)  // the group that inverts the first field product
static_assert(SECP_T == 4, "one lane per GLV sub-walk");
static_assert(SECP_ROWS >= 2 && (SECP_ROWS & (SECP_ROWS - 1)) == 0, "SECP_ROWS is a power of 2");

#ifdef __CUDACC__
#define SECP_GL 1  // lanes of its group a thread holds: its own
// The calling thread's place in its group: the group's lanes in the warp,
// its lane in the group.
struct grp {
  u32 mask;
  int lane;
};
#define LID(g, l) ((g).lane)
#else
#define SECP_GL SECP_T  // the host build holds the whole group
struct grp {};
#define LID(g, l) (l)
#endif
#define LANES(l) \
  UNROLL         \
  for (int l = 0; l < SECP_GL; l++)

// r[l] = v[src(l) mod T] for each lane l
template <class F>
DEV void g_xchg(const grp& g, u32 r[SECP_GL], const u32 v[SECP_GL], F src) {
#ifdef __CUDACC__
  r[0] = __shfl_sync(g.mask, v[0], src(g.lane) & (SECP_T - 1), SECP_T);
#else
  u32 t[SECP_GL];
  for (int l = 0; l < SECP_GL; l++) t[l] = v[src(l) & (SECP_T - 1)];
  for (int l = 0; l < SECP_GL; l++) r[l] = t[l];
#endif
}

// orders the group's shared-memory reads before its writes
DEV void g_sync(const grp& g) {
#ifdef __CUDACC__
  __syncwarp(g.mask);
#endif
}

// r[l] = lane l ^ m's point, for each lane l
DEV void g_xchg_pt(const grp& g, jac r[SECP_GL], const jac p[SECP_GL], int m) {
  u32 v[SECP_GL], w[SECP_GL];
  UNROLL
  for (int k = 0; k < 24; k++) {
    LANES(l) v[l] = k < 8 ? p[l].X[k] : k < 16 ? p[l].Y[k - 8] : p[l].Z[k - 16];
    g_xchg(g, w, v, [m](int lane) { return lane ^ m; });
    LANES(l) {
      if (k < 8) r[l].X[k] = w[l];
      else if (k < 16) r[l].Y[k - 8] = w[l];
      else r[l].Z[k - 16] = w[l];
    }
  }
}

// ------------------------------------------------------------ the block

// The kernels' arguments (secp.cu); sha_* / kec_* only for K12.
struct SecpIn {
  const u32 *qx, *qy, *e, *r, *s, *gtab;
  const uint8_t *q_valid, *is_eth, *is_rec, *addr;
  const int32_t* v;
  const uint8_t* sha_blocks;
  const int32_t* sha_active;
  int sha_nb;
  const uint8_t* kec_blocks;
  const int32_t* kec_active;
  int kec_nb;
  uint8_t* out;
  int n;
};

// Montgomery's trick over the block's rows, one heap-ordered product tree
// per kind: node m = node 2m * node 2m + 1, the rows' factors at the
// leaves SECP_ROWS + g; the inverses come down as
// inv(child) = inv(parent) * sibling.  Beside them each row's e, and its
// table of j Q (j = 1..8: Jacobian X, Y for j >= 2 until normalised, then
// affine) with the H of its adds (Z_j = Z_(j-1) H_j, j = 3..8).
struct SecpShared {
  u32 sc[2 * SECP_ROWS][8], sci[2 * SECP_ROWS][8];  // scalars mod n (Montgomery form)
  u32 fp[2 * SECP_ROWS][8], fpi[2 * SECP_ROWS][8];  // field elements mod p
  u32 e[SECP_ROWS][8];
  u32 q[SECP_ROWS][8][2][8];
  u32 qh[SECP_ROWS][6][8];
};

// One group's row (its walk's sum, a jac, is kept beside it)
struct SecpRow {
  int row;    // may be >= n: a group with no row
  bool live;  // a row not (yet) decided false
  bool is_rec, is_eth;
  int v;
};

DCONST u32 SECP_P[8] = {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                        0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};

// A row's factor of the block's field product: x, or 1 for a row that is
// decided or whose x is 0 (the row is then false).  No zero ever enters a
// product, so no row can change another row's inverse.  Every lane of
// the group writes the same words.
DEV void fp_leaf(u32 dst[8], bool& live, const u32 x[8]) {
  u32 one[8];
  w_set_small(one, 1);
  if (live && w_is_zero(x)) live = false;
  w_select(dst, live, x, one);
}

// inputs, checks, the scalar factor, the point and its table
template <bool RECOVER, bool HASH>
SECP_ONCE SecpRow secp_row_start(const SecpIn& in, int gid, int row, SecpShared& sm) {
  SecpRow st;
  st.row = row;
  st.live = row < in.n;
  u32 leaf[8], z8[8];
  w_copy(leaf, SECP_ONE_N_MONT);
  w_set_small(z8, 0);
  if (st.live) {
    const size_t o = (size_t)row * 8;
    const bool rec_in = in.is_rec[row] != 0;
    st.is_rec = RECOVER && rec_in;
    st.is_eth = in.is_eth[row] != 0;
    st.v = in.v[row];
    u32 r[8], s[8], e[8];
    UNROLL
    for (int k = 0; k < 8; k++) {
      r[k] = LDG(in.r + o + k);
      s[k] = LDG(in.s + o + k);
    }
    if (HASH) {
      // e = the row's digest read as a big-endian 256-bit integer: Keccak-256
      // on Ethereum and ecrecover rows, SHA-256 on Cosmos rows
      if (st.is_eth || rec_in) {
        uint64_t a[25];
        keccak256_row_state(a, in.kec_blocks + (size_t)row * in.kec_nb * KECCAK_RATE, in.kec_nb,
                            in.kec_active[row]);
        UNROLL
        for (int k = 0; k < 8; k++) {
          int m = 7 - k;  // digest bytes 4m..4m+3 are the 32-bit half m & 1 of lane m / 2
          e[k] = bswap32((u32)(a[m >> 1] >> (32 * (m & 1))));
        }
      } else {
        u32 h[8];
        sha256_init(h);
        const uint8_t* blocks = in.sha_blocks + (size_t)row * in.sha_nb * 64;
        const int act = in.sha_active[row];
        NOUNROLL
        for (int bk = 0; bk < in.sha_nb && bk < act; bk++) {
          const u32* src = (const u32*)(blocks + (size_t)bk * 64);
          u32 w[16];
          UNROLL
          for (int k = 0; k < 16; k++) w[k] = bswap32(LDG(src + k));
          sha256_compress(h, w);
        }
        UNROLL
        for (int k = 0; k < 8; k++) e[k] = h[7 - k];
      }
    } else {
      UNROLL
      for (int k = 0; k < 8; k++) e[k] = LDG(in.e + o + k);
    }
    w_copy(sm.e[gid], e);
    const bool r_ok = !w_is_zero(r) && w_lt(r, SECP_N);
    const bool s_ok = !w_is_zero(s) && w_lt(s, SECP_N) && !w_lt(SECP_NHALF, s);
    const bool v_ok = (st.is_eth || st.is_rec) ? st.v <= 1 : true;
    // the scalar to invert: s, or r on ecrecover rows, when in range (the
    // JAX program's w_in_ok, :940); 1 otherwise
    if (st.is_rec ? r_ok : s_ok) {
      u32 x[8];
      w_select(x, st.is_rec, r, s);
      sc_mont_mul(leaf, x, SECP_R2N);
    }
    st.live = r_ok && s_ok && v_ok;
    u32 px[8], py[8];
    if (st.live) {
      if (st.is_rec) {
        // R = (r, sqrt(r^3 + 7)) with the parity v (r < n < p)
        u32 y2[8], seven[8], chk[8];
        fp_sqr(y2, r);
        fp_mul(y2, y2, r);
        w_set_small(seven, 7);
        fp_add(y2, y2, seven);
        fp_sqrt_cand(py, y2);
        fp_sqr(chk, py);
        st.live = w_eq(chk, y2);  // else r^3 + 7 is not a residue
        if ((int)(py[0] & 1u) != st.v) fp_neg(py, py);
        w_copy(px, r);
      } else if (in.q_valid[row]) {
        u32 qx[8], qy[8];
        UNROLL
        for (int k = 0; k < 8; k++) {
          qx[k] = LDG(in.qx + o + k);
          qy[k] = LDG(in.qy + o + k);
        }
        fp_canon(px, qx);
        fp_canon(py, qy);
        st.live = fp_on_curve(px, py);
      } else {
        st.live = false;
      }
    }
    if (st.live) {
      // the table of j Q: 2Q by a doubling, then j Q = (j - 1) Q + Q.  Q is
      // on the curve, so j Q for j <= 8 is never infinity, never equal or
      // opposite to Q (n is prime): the adds need no branches, and
      // Z_j = 2 y H_3 ... H_j
      jac p;
      w_copy(p.X, px);
      w_copy(p.Y, py);
      w_set_small(p.Z, 1);
      w_copy(sm.q[gid][0][0], px);
      w_copy(sm.q[gid][0][1], py);
      pt_double(p, p);
      w_copy(sm.q[gid][1][0], p.X);
      w_copy(sm.q[gid][1][1], p.Y);
      NOUNROLL
      for (int j = 3; j <= 8; j++) {
        u32 H[8], R[8];
        pt_madd_hr(H, R, p, px, py);
        pt_madd_core(p, H, R);
        w_copy(sm.q[gid][j - 1][0], p.X);
        w_copy(sm.q[gid][j - 1][1], p.Y);
        w_copy(sm.qh[gid][j - 3], H);
      }
      w_copy(z8, p.Z);
    }
  }
  w_copy(sm.sc[SECP_ROWS + gid], leaf);
  fp_leaf(sm.fp[SECP_ROWS + gid], st.live, z8);
  return st;
}

// Running a block: SECP_EACH(stmt) runs stmt for every group of the
// block after a barrier, with gid (the group), st (its row), acc (its
// walk's sum) and g (its lanes) in scope — on the card the calling
// thread's group after __syncthreads, on the host every group in turn.
// SECP_GROUPS declares them as parameters, SECP_GROUP_ARGS passes them on.
#ifdef __CUDACC__
#define SECP_GROUPS int gid, SecpRow &st, jac &acc, const grp g
#define SECP_GROUP_ARGS gid, st, acc, g
#define SECP_EACH(...) \
  do {                 \
    __syncthreads();   \
    __VA_ARGS__;       \
  } while (0)
#else
#define SECP_GROUPS SecpRow *rows, jac *accs, const grp g
#define SECP_GROUP_ARGS rows, accs, g
#define SECP_EACH(...)                                  \
  do {                                                  \
    for (int gid = 0; gid < SECP_ROWS; gid++) {         \
      SecpRow& st = rows[gid];                          \
      jac& acc = accs[gid];                             \
      (void)st;                                         \
      (void)acc;                                        \
      __VA_ARGS__;                                      \
    }                                                   \
  } while (0)
#endif

// node m = node 2m * node 2m + 1 on level k (SC: the scalar tree too)
template <bool SC>
SECP_ONCE void secp_tree_up(SecpShared& sm, int gid, int k) {
  if (gid >= k) return;
  const int m = k + gid;
  u32 a[8], b[8];
  if (SC) {
    w_copy(a, sm.sc[2 * m]);
    w_copy(b, sm.sc[2 * m + 1]);
    sc_mont_mul(sm.sc[m], a, b);
  }
  w_copy(a, sm.fp[2 * m]);
  w_copy(b, sm.fp[2 * m + 1]);
  fp_mul(sm.fp[m], a, b);
}

// The roots invert by the binary GCD, the scalar one on group 0 while the
// field one runs on group SECP_FP_ROOT, another warp.  The scalar root
// X R (Montgomery) gives (X R)^-1 R^3 R^-1 = X^-1 R.
template <bool SC>
SECP_ONCE void secp_tree_roots(SecpShared& sm, int gid) {
  u32 x[8], y[8];
  if (SC && gid == 0) {
    w_copy(x, sm.sc[1]);
    w_inv_gcd(y, x, SECP_N);
    sc_mont_mul(sm.sci[1], y, SECP_R3N);
  }
  if (gid == (SC ? SECP_FP_ROOT : 0)) {
    w_copy(x, sm.fp[1]);
    w_inv_gcd(sm.fpi[1], x, SECP_P);
  }
}

// inv(child) = inv(parent) * sibling for the children of level k
template <bool SC>
SECP_ONCE void secp_tree_down(SecpShared& sm, int gid, int k) {
  if (gid >= 2 * k) return;
  const int c = 2 * k + gid;
  u32 a[8], b[8];
  if (SC) {
    w_copy(a, sm.sci[c >> 1]);
    w_copy(b, sm.sc[c ^ 1]);
    sc_mont_mul(sm.sci[c], a, b);
  }
  w_copy(a, sm.fpi[c >> 1]);
  w_copy(b, sm.fp[c ^ 1]);
  fp_mul(sm.fpi[c], a, b);
}

// The block's products up the trees, the roots' inverses, and the
// inverses back down to the leaves.
template <bool SC>
DEV void secp_invert(SecpShared& sm, SECP_GROUPS) {
  for (int k = SECP_ROWS / 2; k >= 1; k >>= 1) SECP_EACH(secp_tree_up<SC>(sm, gid, k));
  SECP_EACH(secp_tree_roots<SC>(sm, gid));
  for (int k = 1; k < SECP_ROWS; k <<= 1) SECP_EACH(secp_tree_down<SC>(sm, gid, k));
}

// One lane's sub-walk acc = d . B over its digits.  GLV: lane 0 takes
// G, 1 phi(G) (the fixed affine table), 2 Q and 3 phi(Q) (the row's
// affine table, phi(Q) = (beta x, y) at lookup), 33 windows each;
// Shamir (the witness): lane 0 G and lane 1 Q over 65 windows, lanes 2
// and 3 stay at infinity.  A window is 4 doublings (none while acc is
// infinity) and one mixed add for a nonzero digit.
template <bool GLV>
DEV void secp_walk_lane(jac& acc, int lane, u32 kd[9], bool neg, const u32* gtab,
                        const u32 (*q)[2][8]) {
  constexpr int NW = GLV ? 5 : 9;
  constexpr int NWIN = GLV ? SECP_GLV_WINDOWS : SECP_SHAMIR_WINDOWS;
  const bool fixed = GLV ? lane < 2 : lane == 0;
  const bool phi = GLV && lane == 3;
  const u32* g = gtab + (GLV && lane == 1 ? 8 * 16 : 0);
  pt_set_inf(acc);
  if (!GLV && lane >= 2) return;
  NOUNROLL
  for (int w = 0; w < NWIN; w++) {
    if (!pt_is_inf(acc)) {
      NOUNROLL
      for (int k = 0; k < 4; k++) pt_double(acc, acc);
    }
    const int d = digit_next<NW>(kd);
    if (d != 0) {
      const int j = (d < 0 ? -d : d) - 1;
      const u32* e = fixed ? g + j * 16 : &q[j][0][0];
      u32 x[8], y[8];
      UNROLL
      for (int i = 0; i < 8; i++) {
        x[i] = e[i];
        y[i] = e[8 + i];
      }
      if (phi) fp_mul(x, x, SECP_BETA);
      if ((d < 0) != neg) fp_neg(y, y);
      if (pt_madd(acc, x, y)) acc = pt_double_rare(acc);
    }
  }
}

// the scalars from the block's inverse, the affine table, the lanes'
// sub-walks (each lane's accumulator, digit words and the sign of its GLV
// half) and their sum, acc
template <bool GLV>
DEV void secp_row_walk(const SecpIn& in, int gid, SecpRow& st, jac& acc, const grp g, SecpShared& sm) {
  u32 z[8];
  w_set_small(z, 0);
  if (st.live) {
    jac part[SECP_GL];
    u32 kd[SECP_GL][9];
    bool neg[SECP_GL];
    // verify rows: u1 = e / s, u2 = r / s; ecrecover rows: u1 = -e / r,
    // u2 = s / r (mod n); e is reduced mod n inside the product
    const size_t o = (size_t)st.row * 8;
    u32 wm[8], e[8], u1[8], u2[8], x[8];
    w_copy(wm, sm.sci[SECP_ROWS + gid]);
    w_copy(e, sm.e[gid]);
    sc_mont_mul(u1, e, wm);
    if (st.is_rec) sc_neg(u1, u1);
    UNROLL
    for (int k = 0; k < 8; k++) x[k] = LDG((st.is_rec ? in.s : in.r) + o + k);
    sc_mont_mul(u2, x, wm);
    LANES(l) {
      const int lane = LID(g, l);
      if (GLV) {  // lanes 0, 1: the halves of u1; lanes 2, 3: those of u2
        u32 k1[8], k2[8], h[8];
        bool n1, n2;
        w_select(x, lane < 2, u1, u2);
        glv_split(k1, n1, k2, n2, x);
        w_select(h, lane & 1, k2, k1);
        neg[l] = (lane & 1) ? n2 : n1;
        digit_words<5>(kd[l], h);
      } else {
        w_select(x, lane == 0, u1, u2);
        neg[l] = false;
        digit_words<9>(kd[l], x);
      }
    }
    // the table to affine from Z_8^-1: Z_(j-1)^-1 = Z_j^-1 H_j
    u32 zi[8];
    w_copy(zi, sm.fpi[SECP_ROWS + gid]);
    NOUNROLL
    for (int j = 8; j >= 2; j--) {
      u32 X[8], Y[8], h[8], zi2[8], t[8];
      w_copy(X, sm.q[gid][j - 1][0]);
      w_copy(Y, sm.q[gid][j - 1][1]);
      w_copy(h, sm.qh[gid][j > 2 ? j - 3 : 0]);
      g_sync(g);  // every lane has read entry j before any lane rewrites it
      fp_sqr(zi2, zi);
      fp_mul(t, zi2, zi);
      fp_mul(sm.q[gid][j - 1][0], X, zi2);
      fp_mul(sm.q[gid][j - 1][1], Y, t);
      if (j > 2) fp_mul(zi, zi, h);
    }
    LANES(l) secp_walk_lane<GLV>(part[l], LID(g, l), kd[l], neg[l], in.gtab, sm.q[gid]);
    // the four partial sums: lanes l and l ^ 1, then l and l ^ 2, each pair
    // adding the lower lane's point first, so every lane ends with the
    // same words (a loop, not unrolled: one general add to compile)
    NOUNROLL
    for (int m = 1; m < SECP_T; m <<= 1) {
      jac other[SECP_GL];
      g_xchg_pt(g, other, part, m);
      LANES(l) {
        const bool upper = (LID(g, l) & m) != 0;
        jac a, b;
        pt_select(a, upper, other[l], part[l]);
        pt_select(b, upper, part[l], other[l]);
        pt_add(part[l], a, b);
      }
    }
    acc = part[0];
    w_copy(z, acc.Z);  // infinity: the row is false
  }
  fp_leaf(sm.fp[SECP_ROWS + gid], st.live, z);
}

// the affine point of the walk's sum p and the Cosmos / Ethereum /
// ecrecover verdict
SECP_ONCE void secp_row_finish(const SecpIn& in, int gid, const SecpRow st, const jac p, const grp g,
                               SecpShared& sm) {
  bool ok = false;
  if (st.live) {
    u32 zi[8], zi2[8], x[8], y[8], r[8];
    w_copy(zi, sm.fpi[SECP_ROWS + gid]);
    fp_sqr(zi2, zi);
    fp_mul(x, p.X, zi2);
    fp_mul(y, p.Y, zi2);
    fp_mul(y, y, zi);
    UNROLL
    for (int k = 0; k < 8; k++) r[k] = LDG(in.r + (size_t)st.row * 8 + k);
    if (st.is_rec) {
      const uint8_t* addr = in.addr + (size_t)st.row * 20;
      uint64_t dg[4];
      keccak256_xy(dg, x, y);
      ok = true;
      UNROLL
      for (int b = 12; b < 32; b++) ok &= (uint8_t)(dg[b >> 3] >> (8 * (b & 7))) == addr[b - 12];
    } else {
      const bool x_eq_r = w_eq(x, r);
      if (st.is_eth) {
        ok = x_eq_r && (int)(y[0] & 1u) == st.v;
      } else if (x_eq_r) {
        ok = true;
      } else {
        // x == r + n (only when r + n < p)
        u32 rn[8], pc[8];
        const u32 c = w_add(rn, r, SECP_N);
        ok = !c && !w_add_c(pc, rn) && w_eq(x, rn);  // rn >= p iff rn + 2^256 - p overflows
      }
    }
  }
#ifdef __CUDACC__
  const bool leader = g.lane == 0;
#else
  const bool leader = true;
#endif
  if (st.row < in.n && leader) in.out[st.row] = ok ? 1 : 0;
}

// One block of SECP_ROWS rows (K11: HASH = false, e given; K12: HASH,
// e hashed from the row's blocks).  Outside the sub-walks the lanes of a
// group run the same code on the same words.
//
// Verdicts are exactly those of the plain version: a row that fails a
// check is decided before its walk; the block inverts three products,
// each once (the scalars s, or r on ecrecover rows; the tables' Z_8; the
// walks' final Z), every row's factor nonzero.
template <bool GLV, bool RECOVER, bool HASH>
DEV void secp_block(const SecpIn& in, int block, SecpShared& sm, SECP_GROUPS) {
  SECP_EACH(st = secp_row_start<RECOVER, HASH>(in, gid, block * SECP_ROWS + gid, sm));
  secp_invert<true>(sm, SECP_GROUP_ARGS);
  SECP_EACH(secp_row_walk<GLV>(in, gid, st, acc, g, sm));
  secp_invert<false>(sm, SECP_GROUP_ARGS);
  SECP_EACH(secp_row_finish(in, gid, st, acc, g, sm));
}

#ifndef __CUDACC__
// The host build: every block of the batch in turn.
template <bool GLV, bool RECOVER, bool HASH>
static void secp_block_host(const SecpIn& in) {
  SecpShared* sm = new SecpShared();
  SecpRow* rows = new SecpRow[SECP_ROWS]();
  jac* accs = new jac[SECP_ROWS]();
  grp g;
  for (int b = 0; b * SECP_ROWS < in.n; b++) secp_block<GLV, RECOVER, HASH>(in, b, *sm, rows, accs, g);
  delete[] accs;
  delete[] rows;
  delete sm;
}
#endif
