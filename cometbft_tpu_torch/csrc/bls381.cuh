// BLS12-381 base field and G1 group arithmetic, and the per-row body of
// K13 and K15 (bls.cu).
//
// Representation: a field element is 12 little-endian 32-bit words (word
// 0 least significant) of its Montgomery form a R mod p, R = 2^384 — the
// same R as the JAX package's 32 x 12-bit limbs, so both hold the same
// number.  Products are 32x32->64; the TPU version built them from an
// outer product and an anti-diagonal matmul because the TPU has no 64-bit
// product.  Inside the group operations a field element is an `fe`, 12
// words passed and returned by value, so that the compiler keeps it in
// registers across the out-of-line fe_mul and fe_sq; a point (g1p) keeps
// its coordinates as word arrays.
//
// Field: CANONICAL everywhere — every operation takes and returns values
// in [0, p), so word equality is value equality and zero is all-zero
// words.  p < 2^381, so a + b < 2p < 2^382 never carries out of 12 words.
//
// fe_mul and fe_sq are product-scanning Montgomery multiplications with
// the reduction interleaved column by column.  Column k (k = 0..22) sums
// its 32x32->64 products: a_i b_j with i + j = k (fe_sq: the cross terms
// a_i a_j, i < j, doubled, and a_{k/2}^2) and m_j p_{k-j} for the m_j
// already chosen.  No carry links one column's products to another
// column's; only the column's total waits for what the column below
// carries (c) and, for k < 12, m_k = (low word of the total) (-p^-1) mod
// 2^32 waits for the total.  m_k p_0 turns the low word into 0, so only
// its high half is added, and the low word carries 1 unless it was 0
// already.  A column holds at most 12 products of the operands (fe_sq: at
// most 6 cross terms, doubled, and one square) and at most 12 of m and p,
// so its sum with c < 2^38 stays below 25 2^64, and the next c, the sum
// over 2^32 plus 2^32 + 1, below 2^38.  The sum is an fe_col: on the host
// two 64-bit sums, L of the products' low halves (below 24 2^32 + 2^38 <
// 2^39) and H of their high halves (below 24 2^32), so that g++
// desk-checks the arithmetic in portable C++; on the card a 96-bit word
// triple that each product enters through one mad.lo.cc / madc.hi.cc /
// addc chain (ptxas fuses the first two into one multiply-add with a
// 64-bit addend and a carry out).  Columns 12..22 give the result's words
// 0..10 and the last carry its word 11: the result is (a b + m p) / R <
// (p^2 + R p) / R < 2p < 2^382 for a, b < p, so it fits 12 words (the last
// carry < 2^30) and one conditional subtraction of p makes it canonical.
// The add and subtract chains run through the carry flag on the card
// (add.cc / addc, sub.cc / subc) and as 64-bit sums on the host.
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
// add 16 (12M + 4S).  A multiply is 288 32x32->64 multiply-adds (144
// products and 144 of the reduction, the 12 m_k p_0 for their high
// halves only), a square 222 (78 products); both add the 12 m_k.
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

struct fe {
  u32 w[BLS_W];
};

// ------------------------------------------------------------ field

// word i of p for the add chains, where i is a constant after unrolling:
// ~p_i and p_i as immediate operands (the same words as BLS_P, which the
// products read from the constant bank: tests/test_torch_bls_field_host.py).
// BLS_P[i] in the chains costs each group operation's copy 24-42 more
// instructions and K13 / K15 ~0.6% (PERF.md).
DEV u32 bls_p(const int i) {
  constexpr u32 w[BLS_W] = {0xFFFFAAABu, 0xB9FEFFFFu, 0xB153FFFFu, 0x1EABFFFEu, 0xF6B0F624u, 0x6730D2A0u,
                            0xF38512BFu, 0x64774B84u, 0x434BACD7u, 0x4B1BA7B6u, 0x397FE69Au, 0x1A0111EAu};
  return w[i];
}

DEV void fe_copy(u32 r[BLS_W], const u32 a[BLS_W]) {
  UNROLL
  for (int i = 0; i < BLS_W; i++) r[i] = a[i];
}

DEV fe fe_ld(const u32 a[BLS_W]) {
  fe r;
  fe_copy(r.w, a);
  return r;
}

DEV bool fe_is_zero(const u32 a[BLS_W]) {
  u32 o = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) o |= a[i];
  return o == 0;
}

DEV bool fe_eq(const fe& a, const fe& b) {
  u32 o = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) o |= a.w[i] ^ b.w[i];
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

// A word chain's step on the card: add.cc / addc.cc (sub.cc / subc.cc)
// through the carry flag, one asm statement a word, the statements of a
// chain in one unbroken sequence.  The compiler does not see the carry
// flag, and it keeps only volatile asm statements in their order, so
// every statement that sets or reads the flag (here, col_add, fe_mac) is
// volatile: none can move into another's chain.
#ifdef __CUDA_ARCH__
#define BLS_CC(op, r, x, y) asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y))
#endif

// s - p if s >= p, else s (s < 2^384); on the host the difference is
// s + ~p + 1, whose last carry is 1 iff s >= p
DEV fe fe_sub_p_once(const fe& s) {
  fe d;
#ifdef __CUDA_ARCH__
  u32 borrow;
  BLS_CC("sub.cc.u32", d.w[0], s.w[0], bls_p(0));
  UNROLL
  for (int i = 1; i < BLS_W; i++) BLS_CC("subc.cc.u32", d.w[i], s.w[i], bls_p(i));
  BLS_CC("subc.u32", borrow, 0u, 0u);
#else
  u64 acc = 1;
  UNROLL
  for (int i = 0; i < BLS_W; i++) {
    acc += (u64)s.w[i] + (u32)~bls_p(i);
    d.w[i] = (u32)acc;
    acc >>= 32;
  }
  const u32 borrow = (u32)acc - 1u;
#endif
  UNROLL
  for (int i = 0; i < BLS_W; i++) d.w[i] = borrow ? s.w[i] : d.w[i];
  return d;
}

// a + b mod p (canonical inputs)
DEV fe fe_add(const fe& a, const fe& b) {
  fe s;
#ifdef __CUDA_ARCH__
  BLS_CC("add.cc.u32", s.w[0], a.w[0], b.w[0]);
  UNROLL
  for (int i = 1; i < BLS_W; i++) BLS_CC("addc.cc.u32", s.w[i], a.w[i], b.w[i]);
#else
  u64 acc = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) {
    acc += (u64)a.w[i] + b.w[i];
    s.w[i] = (u32)acc;
    acc >>= 32;
  }
#endif
  return fe_sub_p_once(s);
}

// a - b mod p (canonical inputs)
DEV fe fe_sub(const fe& a, const fe& b) {
  fe d;
#ifdef __CUDA_ARCH__
  u32 mask;
  BLS_CC("sub.cc.u32", d.w[0], a.w[0], b.w[0]);
  UNROLL
  for (int i = 1; i < BLS_W; i++) BLS_CC("subc.cc.u32", d.w[i], a.w[i], b.w[i]);
  BLS_CC("subc.u32", mask, 0u, 0u);  // all ones iff a < b: add p back
  BLS_CC("add.cc.u32", d.w[0], d.w[0], bls_p(0) & mask);
  UNROLL
  for (int i = 1; i < BLS_W; i++) BLS_CC("addc.cc.u32", d.w[i], d.w[i], bls_p(i) & mask);
#else
  u64 acc = 1;
  UNROLL
  for (int i = 0; i < BLS_W; i++) {
    acc += (u64)a.w[i] + (u32)~b.w[i];
    d.w[i] = (u32)acc;
    acc >>= 32;
  }
  const u32 mask = (u32)acc - 1u;  // all ones iff a < b: add p back
  acc = 0;
  UNROLL
  for (int i = 0; i < BLS_W; i++) {
    acc += (u64)d.w[i] + (bls_p(i) & mask);
    d.w[i] = (u32)acc;
    acc >>= 32;
  }
#endif
  return d;
}

// the high word of x y (mul.hi on the card)
DEV u32 fe_mulhi(u32 x, u32 y) {
#ifdef __CUDA_ARCH__
  return __umulhi(x, y);
#else
  return (u32)(((u64)x * y) >> 32);
#endif
}

// A column's sum: L + H 2^32 on the host; on the card the word triple
// s2 s1 s0, each add a carry chain
struct fe_col {
#ifdef __CUDA_ARCH__
  u32 s0, s1, s2;
#else
  u64 L, H;
#endif
};

DEV fe_col col_zero() {
  fe_col c;
#ifdef __CUDA_ARCH__
  c.s0 = c.s1 = c.s2 = 0;
#else
  c.L = c.H = 0;
#endif
  return c;
}

// S += lo + hi 2^32
DEV void col_add(fe_col& c, u32 lo, u32 hi) {
#ifdef __CUDA_ARCH__
  asm volatile("add.cc.u32 %0, %0, %3;\n\taddc.cc.u32 %1, %1, %4;\n\taddc.u32 %2, %2, 0;"
      : "+r"(c.s0), "+r"(c.s1), "+r"(c.s2)
      : "r"(lo), "r"(hi));
#else
  c.L += lo;
  c.H += hi;
#endif
}

DEV u32 col_low(const fe_col& c) {
#ifdef __CUDA_ARCH__
  return c.s0;
#else
  return (u32)c.L;
#endif
}

// S >> 32
DEV u64 col_high(const fe_col& c) {
#ifdef __CUDA_ARCH__
  return ((u64)c.s2 << 32) | c.s1;
#else
  return (c.L >> 32) + c.H;
#endif
}

// S = 2 S
DEV void col_double(fe_col& c) {
#ifdef __CUDA_ARCH__
  c.s2 = (c.s2 << 1) | (c.s1 >> 31);
  c.s1 = (c.s1 << 1) | (c.s0 >> 31);
  c.s0 <<= 1;
#else
  c.L <<= 1;
  c.H <<= 1;
#endif
}

// S += x y
DEV void fe_mac(fe_col& c, u32 x, u32 y) {
#ifdef __CUDA_ARCH__
  asm volatile("mad.lo.cc.u32 %0, %3, %4, %0;\n\tmadc.hi.cc.u32 %1, %3, %4, %1;\n\taddc.u32 %2, %2, 0;"
      : "+r"(c.s0), "+r"(c.s1), "+r"(c.s2)
      : "r"(x), "r"(y));
#else
  const u64 t = (u64)x * y;
  c.L += (u32)t;
  c.H += t >> 32;
#endif
}

// The reduction's share of column k, after the column's products are in
// S: the m_j p_{k-j} of the m_j already chosen (the latest last), then c,
// what the column below carries.  Below column 12 it chooses m_k; from
// column 12 on it writes word k - 12 of the result.  Returns the carry
// into column k + 1.
DEV u64 fe_redc_col(const int k, fe_col S, const u64 c, u32 m[BLS_W], fe& t) {
  UNROLL
  for (int j = 0; j < BLS_W; j++)
    if (j < k && k - j < BLS_W) fe_mac(S, m[j], BLS_P[k - j]);
  col_add(S, (u32)c, (u32)(c >> 32));
  if (k < BLS_W) {
    const u32 mk = col_low(S) * BLS_PINV;
    m[k] = mk;
    return col_high(S) + (col_low(S) != 0u) + fe_mulhi(mk, BLS_P[0]);
  }
  t.w[k - BLS_W] = col_low(S);
  return col_high(S);
}

// a b R^-1 mod p (canonical inputs), product scanning
BLS_NOINL fe fe_mul(const fe a, const fe b) {
  u32 m[BLS_W];
  fe t;
  u64 c = 0;
  UNROLL
  for (int k = 0; k < 2 * BLS_W - 1; k++) {
    fe_col S = col_zero();
    UNROLL
    for (int i = 0; i < BLS_W; i++)
      if (i <= k && k - i < BLS_W) fe_mac(S, a.w[i], b.w[k - i]);
    c = fe_redc_col(k, S, c, m, t);
  }
  t.w[BLS_W - 1] = (u32)c;
  return fe_sub_p_once(t);
}

// a^2 R^-1 mod p (canonical input): 66 cross terms, doubled, and 12 squares
BLS_NOINL fe fe_sq(const fe a) {
  u32 m[BLS_W];
  fe t;
  u64 c = 0;
  UNROLL
  for (int k = 0; k < 2 * BLS_W - 1; k++) {
    fe_col S = col_zero();
    UNROLL
    for (int i = 0; i < BLS_W; i++)
      if (i < k - i && k - i < BLS_W) fe_mac(S, a.w[i], a.w[k - i]);
    col_double(S);
    if ((k & 1) == 0) fe_mac(S, a.w[k >> 1], a.w[k >> 1]);
    c = fe_redc_col(k, S, c, m, t);
  }
  t.w[BLS_W - 1] = (u32)c;
  return fe_sub_p_once(t);
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

DEV void g1_store(g1p& r, const fe& X3, const fe& Y3, const fe& Z3) {
  fe_copy(r.X, X3.w);
  fe_copy(r.Y, Y3.w);
  fe_copy(r.Z, Z3.w);
}

// r = 2 p, dbl-2009-l (a = 0); r may alias p
BLS_NOINL void g1_double(g1p& r, const g1p& p) {
  if (fe_is_zero(p.Z)) {
    g1_set_identity(r);
    return;
  }
  const fe X = fe_ld(p.X), Y = fe_ld(p.Y);
  const fe A = fe_sq(X), B = fe_sq(Y), C = fe_sq(B);
  fe D = fe_sub(fe_sq(fe_add(X, B)), fe_add(A, C));
  D = fe_add(D, D);  // D = 2 ((X + B)^2 - A - C)
  const fe E = fe_add(fe_add(A, A), A);  // E = 3 A
  const fe Z3 = fe_mul(fe_add(Y, Y), fe_ld(p.Z));  // Z3 = 2 Y Z
  const fe X3 = fe_sub(fe_sq(E), fe_add(D, D));  // X3 = E^2 - 2 D
  fe C8 = fe_add(C, C);
  C8 = fe_add(C8, C8);
  C8 = fe_add(C8, C8);
  const fe Y3 = fe_sub(fe_mul(E, fe_sub(D, X3)), C8);  // Y3 = E (D - X3) - 8 C
  g1_store(r, X3, Y3, Z3);
}

// The tail shared by the adds, for p non-infinite: H = U2 - U1,
// R = S2 - S1, Zp = Z1 Z2.  X3 = (2R)^2 - J - 2V, Y3 = 2R (V - X3) -
// 2 S1 J, Z3 = 2 Zp H with I = (2H)^2, J = H I, V = U1 I.
DEV void g1_add_tail(g1p& r, const g1p& p, const fe& U1, const fe& S1, const fe& H, const fe& R,
                     const fe& Zp) {
  if (fe_is_zero(H.w)) {
    if (fe_is_zero(R.w)) {
      g1_double(r, p);  // equal points
    } else {
      g1_set_identity(r);  // opposite points
    }
    return;
  }
  const fe I = fe_sq(fe_add(H, H));
  const fe J = fe_mul(H, I);
  const fe r2 = fe_add(R, R);
  const fe V = fe_mul(U1, I);
  const fe X3 = fe_sub(fe_sq(r2), fe_add(J, fe_add(V, V)));
  fe Z3 = fe_mul(Zp, H);
  Z3 = fe_add(Z3, Z3);
  fe J2 = fe_mul(S1, J);
  J2 = fe_add(J2, J2);  // 2 S1 J
  const fe Y3 = fe_sub(fe_mul(r2, fe_sub(V, X3)), J2);
  g1_store(r, X3, Y3, Z3);
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
  const fe Z1 = fe_ld(p.Z), Z2 = fe_ld(q.Z);
  const fe z1z = fe_sq(Z1), z2z = fe_sq(Z2);
  const fe U1 = fe_mul(fe_ld(p.X), z2z), U2 = fe_mul(fe_ld(q.X), z1z);
  const fe S1 = fe_mul(fe_mul(fe_ld(p.Y), Z2), z2z);
  const fe S2 = fe_mul(fe_mul(fe_ld(q.Y), Z1), z1z);
  const fe Zp = fe_mul(Z1, Z2);
  g1_add_tail(r, p, U1, S1, fe_sub(U2, U1), fe_sub(S2, S1), Zp);
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
  const fe X1 = fe_ld(p.X), Y1 = fe_ld(p.Y), Z1 = fe_ld(p.Z);
  const fe z1z = fe_sq(Z1);
  const fe H = fe_sub(fe_mul(fe_ld(x2), z1z), X1);  // H = x2 Z1^2 - X1
  const fe R = fe_sub(fe_mul(fe_mul(fe_ld(y2), Z1), z1z), Y1);  // R = y2 Z1^3 - Y1
  g1_add_tail(r, p, X1, Y1, H, R, Z1);
}

// ------------------------------------------------------------ rows

// K13's row: on the curve (x, y < p and y^2 = x^3 + 4), the host's
// decode mask, and [r]P = infinity by left-to-right double-and-add from
// acc = P over the 254 bits of r after its leading one (254 doublings,
// 133 mixed adds; r ends in ...0001, so the last add is -P + P).  A row
// that fails a check before the ladder skips it.
DEV bool bls_validate_row(const u32 x[BLS_W], const u32 y[BLS_W], bool valid) {
  if (!valid || !fe_lt_p(x) || !fe_lt_p(y)) return false;
  const fe X = fe_ld(x);
  if (!fe_eq(fe_sq(fe_ld(y)), fe_add(fe_mul(fe_sq(X), X), fe_ld(BLS_B_M)))) return false;
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
