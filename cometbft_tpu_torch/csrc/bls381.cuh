// BLS12-381 base field and G1 group arithmetic, and the per-row body of
// K13 and K15 (bls.cu).
//
// Representation: a field element is 12 little-endian 32-bit words (word
// 0 least significant) of its Montgomery form a R mod p, R = 2^384 — the
// same R as the JAX package's 32 x 12-bit limbs, so both hold the same
// number.  Products are 32x32->64 (mul.wide on the card); the TPU version
// built them from an outer product and an anti-diagonal matmul because
// the TPU has no 64-bit product.
//
// Field: CANONICAL everywhere — every operation takes and returns values
// in [0, p), so word equality is value equality and zero is all-zero
// words.  fe_mul is CIOS Montgomery multiplication: with a, b < p each of
// its 12 steps keeps t < 2p (t + a b_i + m p < 2p + 2 (2^32 - 1) p, then
// divided by 2^32), so the result needs one conditional subtraction and t
// never needs a 14th word.  p < 2^381, so a + b < 2p < 2^382 never
// carries out of 12 words.
//
// Group: G1 is y^2 = x^3 + 4 (a = 0) over Fp; Jacobian (X, Y, Z),
// x = X / Z^2, y = Y / Z^3, infinity Z = 0; the identity written here is
// (R mod p, R mod p, 0).  g1_add and g1_madd are complete by branches: an
// infinity operand gives the other point (the first operand's test
// first), equal points fall to the doubling, opposite points give the
// identity — the points of the JAX package's select-based g1_add
// (cometbft_tpu/ops/bls381.py:231).  G1 over Fp has no point of order 2,
// so y = 0 occurs only at infinity and the doubling needs no other case.
//
// Field multiplies per group operation (the unit of the bounds in
// chip_smoke.py): doubling 7 (2M + 5S), mixed add 11 (8M + 3S), general
// add 16 (12M + 4S); fe_mul is 288 32x32->64 multiply-adds.
#pragma once

#include "common.cuh"

#ifdef __CUDACC__
#define BLS_NOINL __device__ __noinline__
#else
#define BLS_NOINL static
#endif

typedef uint32_t u32;
typedef uint64_t u64;

#define BLS_W 12           // words of a field element
#define BLS_PT (3 * BLS_W)  // words of a Jacobian point
#define BLS_PINV 0xFFFCFFFDu  // -p^-1 mod 2^32
#define BLS_R_TOP 254         // index of the leading bit of r

// p, R mod p (one), 4 R mod p (b), and the group order r
DCONST u32 BLS_P[12] = {0xFFFFAAABu, 0xB9FEFFFFu, 0xB153FFFFu, 0x1EABFFFEu,
                        0xF6B0F624u, 0x6730D2A0u, 0xF38512BFu, 0x64774B84u,
                        0x434BACD7u, 0x4B1BA7B6u, 0x397FE69Au, 0x1A0111EAu};
DCONST u32 BLS_ONE_M[12] = {0x0002FFFDu, 0x76090000u, 0xC40C0002u, 0xEBF4000Bu,
                            0x53C758BAu, 0x5F489857u, 0x70525745u, 0x77CE5853u,
                            0xA256EC6Du, 0x5C071A97u, 0xFA80E493u, 0x15F65EC3u};
DCONST u32 BLS_B_M[12] = {0x000CFFF3u, 0xAA270000u, 0xFC34000Au, 0x53CC0032u,
                          0x6B0A807Fu, 0x478FE97Au, 0xE6BA24D7u, 0xB1D37EBEu,
                          0xBF78AB2Fu, 0x8EC9733Bu, 0x3D83DE7Eu, 0x09D64551u};
DCONST u32 BLS_R[8] = {0x00000001u, 0xFFFFFFFFu, 0xFFFE5BFEu, 0x53BDA402u,
                       0x09A1D805u, 0x3339D808u, 0x299D7D48u, 0x73EDA753u};

struct g1p {
  u32 X[BLS_W], Y[BLS_W], Z[BLS_W];
};

// ------------------------------------------------------------ field

DEV void fe_copy(u32 r[BLS_W], const u32 a[BLS_W]) {
  UNROLL
  for (int i = 0; i < BLS_W; i++) r[i] = a[i];
}

DEV bool fe_is_zero(const u32 a[BLS_W]) {
  u32 o = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) o |= a[i];
  return o == 0;
}

DEV bool fe_eq(const u32 a[BLS_W], const u32 b[BLS_W]) {
  u32 o = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) o |= a[i] ^ b[i];
  return o == 0;
}

// a < p, for any 384-bit a (the kernels' inputs are held to it)
DEV bool fe_lt_p(const u32 a[BLS_W]) {
  u32 borrow = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) {
    u64 d = (u64)a[i] - BLS_P[i] - borrow;
    borrow = (u32)(d >> 32) & 1u;
  }
  return borrow != 0;
}

// r = a + b mod p (canonical inputs; r may alias either)
DEV void fe_add(u32 r[BLS_W], const u32 a[BLS_W], const u32 b[BLS_W]) {
  u32 s[BLS_W], d[BLS_W];
  u64 acc = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) {
    acc += (u64)a[i] + b[i];
    s[i] = (u32)acc;
    acc >>= 32;
  }
  u32 borrow = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) {
    u64 t = (u64)s[i] - BLS_P[i] - borrow;
    d[i] = (u32)t;
    borrow = (u32)(t >> 32) & 1u;
  }
  UNROLL
  for (int i = 0; i < BLS_W; i++) r[i] = borrow ? s[i] : d[i];
}

// r = a - b mod p (canonical inputs; r may alias either)
DEV void fe_sub(u32 r[BLS_W], const u32 a[BLS_W], const u32 b[BLS_W]) {
  u32 d[BLS_W];
  u32 borrow = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) {
    u64 t = (u64)a[i] - b[i] - borrow;
    d[i] = (u32)t;
    borrow = (u32)(t >> 32) & 1u;
  }
  u32 mask = 0u - borrow;
  u64 acc = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) {
    acc += (u64)d[i] + (BLS_P[i] & mask);
    r[i] = (u32)acc;
    acc >>= 32;
  }
}

// r = a b R^-1 mod p, CIOS (canonical inputs; r may alias either)
BLS_NOINL void fe_mul(u32 r[BLS_W], const u32 a[BLS_W], const u32 b[BLS_W]) {
  u32 t[BLS_W + 1];
  UNROLL
  for (int i = 0; i <= BLS_W; i++) t[i] = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) {
    u32 bi = b[i];
    u64 c = 0;
    UNROLL
    for (int j = 0; j < BLS_W; j++) {
      u64 x = (u64)a[j] * bi + t[j] + c;
      t[j] = (u32)x;
      c = x >> 32;
    }
    t[BLS_W] = (u32)c;  // t < 2p + (2^32 - 1) p < 2^416: no 14th word
    u32 m = t[0] * BLS_PINV;
    u64 x = (u64)m * BLS_P[0] + t[0];
    c = x >> 32;
    UNROLL
    for (int j = 1; j < BLS_W; j++) {
      x = (u64)m * BLS_P[j] + t[j] + c;
      t[j - 1] = (u32)x;
      c = x >> 32;
    }
    x = (u64)t[BLS_W] + c;
    t[BLS_W - 1] = (u32)x;
    t[BLS_W] = (u32)(x >> 32);  // 0: the step leaves t < 2p < 2^382
  }
  u32 d[BLS_W];
  u32 borrow = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) {
    u64 s = (u64)t[i] - BLS_P[i] - borrow;
    d[i] = (u32)s;
    borrow = (u32)(s >> 32) & 1u;
  }
  UNROLL
  for (int i = 0; i < BLS_W; i++) r[i] = borrow ? t[i] : d[i];
}

// ------------------------------------------------------------ group

DEV void g1_set_identity(g1p& r) {
  fe_copy(r.X, BLS_ONE_M);
  fe_copy(r.Y, BLS_ONE_M);
  UNROLL
  for (int i = 0; i < BLS_W; i++) r.Z[i] = 0;
}

DEV void g1_copy(g1p& r, const g1p& p) {
  fe_copy(r.X, p.X);
  fe_copy(r.Y, p.Y);
  fe_copy(r.Z, p.Z);
}

// r = 2 p, dbl-2009-l (a = 0); r may alias p
BLS_NOINL void g1_double(g1p& r, const g1p& p) {
  if (fe_is_zero(p.Z)) {
    g1_set_identity(r);
    return;
  }
  u32 A[BLS_W], B[BLS_W], C[BLS_W], D[BLS_W], E[BLS_W], t[BLS_W], Z3[BLS_W];
  fe_mul(A, p.X, p.X);
  fe_mul(B, p.Y, p.Y);
  fe_mul(C, B, B);
  fe_add(t, p.X, B);
  fe_mul(t, t, t);
  fe_add(D, A, C);
  fe_sub(D, t, D);
  fe_add(D, D, D);  // D = 2 ((X + B)^2 - A - C)
  fe_add(E, A, A);
  fe_add(E, E, A);  // E = 3 A
  fe_add(t, p.Y, p.Y);
  fe_mul(Z3, t, p.Z);  // Z3 = 2 Y Z, before r overwrites p
  fe_mul(t, E, E);
  fe_add(A, D, D);
  fe_sub(r.X, t, A);  // X3 = E^2 - 2 D
  fe_add(C, C, C);
  fe_add(C, C, C);
  fe_add(C, C, C);  // 8 C
  fe_sub(t, D, r.X);
  fe_mul(t, E, t);
  fe_sub(r.Y, t, C);  // Y3 = E (D - X3) - 8 C
  fe_copy(r.Z, Z3);
}

// The tail shared by the adds, for p non-infinite: H = U2 - U1,
// R = S2 - S1, Zp = Z1 Z2.  X3 = (2R)^2 - J - 2V, Y3 = 2R (V - X3) -
// 2 S1 J, Z3 = 2 Zp H with I = (2H)^2, J = H I, V = U1 I.
DEV void g1_add_tail(g1p& r, const g1p& p, const u32 U1[BLS_W], const u32 S1[BLS_W],
                     const u32 H[BLS_W], const u32 R[BLS_W], const u32 Zp[BLS_W]) {
  if (fe_is_zero(H)) {
    if (fe_is_zero(R)) {
      g1_double(r, p);  // equal points
    } else {
      g1_set_identity(r);  // opposite points
    }
    return;
  }
  u32 I[BLS_W], J[BLS_W], V[BLS_W], r2[BLS_W], t[BLS_W], X3[BLS_W], Z3[BLS_W];
  fe_add(t, H, H);
  fe_mul(I, t, t);
  fe_mul(J, H, I);
  fe_add(r2, R, R);
  fe_mul(V, U1, I);
  fe_mul(X3, r2, r2);
  fe_add(t, V, V);
  fe_add(t, J, t);
  fe_sub(X3, X3, t);
  fe_mul(Z3, Zp, H);
  fe_add(Z3, Z3, Z3);
  fe_mul(t, S1, J);
  fe_add(J, t, t);  // J = 2 S1 J
  fe_sub(t, V, X3);
  fe_mul(t, r2, t);
  fe_sub(r.Y, t, J);
  fe_copy(r.X, X3);
  fe_copy(r.Z, Z3);
}

// r = p + q, complete; r may alias p or q
BLS_NOINL void g1_add(g1p& r, const g1p& p, const g1p& q) {
  if (fe_is_zero(p.Z)) {
    g1_copy(r, q);
    return;
  }
  if (fe_is_zero(q.Z)) {
    g1_copy(r, p);
    return;
  }
  u32 z1z[BLS_W], z2z[BLS_W], U1[BLS_W], U2[BLS_W], S1[BLS_W], S2[BLS_W], Zp[BLS_W];
  fe_mul(z1z, p.Z, p.Z);
  fe_mul(z2z, q.Z, q.Z);
  fe_mul(U1, p.X, z2z);
  fe_mul(U2, q.X, z1z);
  fe_mul(S1, p.Y, q.Z);
  fe_mul(S1, S1, z2z);
  fe_mul(S2, q.Y, p.Z);
  fe_mul(S2, S2, z1z);
  fe_mul(Zp, p.Z, q.Z);
  fe_sub(U2, U2, U1);  // H
  fe_sub(S2, S2, S1);  // R
  g1_add_tail(r, p, U1, S1, U2, S2, Zp);
}

// r = p + (x2, y2) for an affine (x2, y2) (Z2 = 1), complete; the same
// point as g1_add with q = (x2, y2, R mod p).  r may alias p.
BLS_NOINL void g1_madd(g1p& r, const g1p& p, const u32 x2[BLS_W], const u32 y2[BLS_W]) {
  if (fe_is_zero(p.Z)) {
    fe_copy(r.X, x2);
    fe_copy(r.Y, y2);
    fe_copy(r.Z, BLS_ONE_M);
    return;
  }
  u32 z1z[BLS_W], U1[BLS_W], S1[BLS_W], H[BLS_W], R[BLS_W], Zp[BLS_W];
  fe_mul(z1z, p.Z, p.Z);
  fe_mul(H, x2, z1z);
  fe_sub(H, H, p.X);  // H = x2 Z1^2 - X1
  fe_mul(R, y2, p.Z);
  fe_mul(R, R, z1z);
  fe_sub(R, R, p.Y);  // R = y2 Z1^3 - Y1
  fe_copy(U1, p.X);
  fe_copy(S1, p.Y);
  fe_copy(Zp, p.Z);
  g1_add_tail(r, p, U1, S1, H, R, Zp);
}

// ------------------------------------------------------------ rows

// K13's row: on the curve (x, y < p and y^2 = x^3 + 4), the host's
// decode mask, and [r]P = infinity by left-to-right double-and-add from
// acc = P over the 254 bits of r after its leading one (254 doublings,
// 133 mixed adds; r ends in ...0001, so the last add is -P + P).  A row
// that fails a check before the ladder skips it.
DEV bool bls_validate_row(const u32 x[BLS_W], const u32 y[BLS_W], bool valid) {
  if (!valid || !fe_lt_p(x) || !fe_lt_p(y)) return false;
  u32 l[BLS_W], rh[BLS_W];
  fe_mul(l, y, y);
  fe_mul(rh, x, x);
  fe_mul(rh, rh, x);
  fe_add(rh, rh, BLS_B_M);
  if (!fe_eq(l, rh)) return false;
  g1p acc;
  fe_copy(acc.X, x);
  fe_copy(acc.Y, y);
  fe_copy(acc.Z, BLS_ONE_M);
  NOUNROLL
  for (int bit = BLS_R_TOP - 1; bit >= 0; bit--) {
    g1_double(acc, acc);
    if ((BLS_R[bit >> 5] >> (bit & 31)) & 1u) g1_madd(acc, acc, x, y);
  }
  return fe_is_zero(acc.Z);
}
