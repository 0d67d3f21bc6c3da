// BLS12-381 pairing core of the port's bls12_381 key type: a copy of
// the JAX package's native/bls381.cc, built at first use by
// cometbft_tpu_torch/_build.py (host_lib) and loaded by
// crypto/bls12381.py.
//
// The pure-Python pairing (cometbft_tpu_torch/crypto/bls12381.py) is
// ~1 s per pairing — unusable for the 10k-validator aggregate config.
// This is the native equivalent of the reference's blst dependency
// (crypto/bls12381/key_bls12381.go:40-41,179): an original, compact
// implementation of the optimal-ate pairing product check
//     prod_i e(P_i, Q_i) == 1,   P_i in G1, Q_i in G2,
// which is the only primitive signature verification needs
// (verify = e(-g1, sig) * e(pk, H(m)) == 1; aggregates likewise).
//
// Design notes:
//  - Fp: 6x64-bit Montgomery (CIOS with __uint128).  Constants (R^2,
//    n0') are derived at load time from the modulus, not embedded.
//  - Towers: Fp2 = Fp[u]/(u^2+1); Fp12 = Fp2[w]/(w^6 - xi), xi = 1+u —
//    the same direct degree-6 representation the Python module uses, so
//    the two implementations can be diffed coefficient-by-coefficient.
//  - Miller loop: Jacobian doubling/addition on the TWISTED curve (all
//    point arithmetic in Fp2) with sparse line evaluations placed at
//    w^0 / w^3 / w^5.  The placement follows from the module's untwist
//    convention (bls12381.py _untwist: x = x' w^-2, y = y' w^-3):
//        L = yp - lam' xp w^-1 + (lam' x1' - y1') w^-3,
//    rewritten with w^-1 = w^5 xi^-1, w^-3 = w^3 xi^-1 and scaled by
//    the Fp2 denominator (subfield factors are killed by the final
//    exponentiation, so lines may be scaled by any Fp/Fp2 constant).
//  - Final exponentiation: easy part ((p^6-1)(p^2+1)) with one tower
//    inversion, hard part (p^4-p^2+1)/r by plain square-and-multiply
//    (the exponent bytes are derived at load time from p and r).
//
// Exceptional cases (T == +-Q mid-loop) cannot occur for inputs in the
// prime-order subgroups, which callers enforce (bls12381.py checks
// subgroup membership on deserialization).

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

static const int NL = 6;  // 64-bit limbs per Fp element

// p, little-endian limbs
static const u64 Pmod[NL] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL,
};
// r (group order), little-endian limbs (255 bits -> 4 limbs)
static const u64 Rord[4] = {
    0xffffffff00000001ULL, 0x53bda402fffe5bfeULL,
    0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL,
};
// |x| for BLS12-381 (x = -0xd201000000010000)
static const u64 X_ABS = 0xd201000000010000ULL;

static u64 N0INV;       // -p^-1 mod 2^64
static u64 R2[NL];      // 2^768 mod p (to-Montgomery factor)
static u64 ONE_M[NL];   // 1 in Montgomery form (= 2^384 mod p)

// ---------------------------------------------------------------- raw ops

static inline int raw_add(u64* o, const u64* a, const u64* b) {
  u128 c = 0;
  for (int i = 0; i < NL; i++) {
    c += (u128)a[i] + b[i];
    o[i] = (u64)c;
    c >>= 64;
  }
  return (int)c;
}

static inline int raw_sub(u64* o, const u64* a, const u64* b) {
  u128 br = 0;
  for (int i = 0; i < NL; i++) {
    u128 d = (u128)a[i] - b[i] - br;
    o[i] = (u64)d;
    br = (d >> 64) & 1;
  }
  return (int)br;
}

static inline int raw_cmp(const u64* a, const u64* b) {
  for (int i = NL - 1; i >= 0; i--) {
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  }
  return 0;
}

// ------------------------------------------------------------- Fp (Mont)

struct Fp {
  u64 v[NL];
};

static inline void fp_zero(Fp& o) { memset(o.v, 0, sizeof o.v); }
static inline bool fp_is_zero(const Fp& a) {
  u64 x = 0;
  for (int i = 0; i < NL; i++) x |= a.v[i];
  return x == 0;
}
static inline bool fp_eq(const Fp& a, const Fp& b) {
  return memcmp(a.v, b.v, sizeof a.v) == 0;
}

static inline void fp_add(Fp& o, const Fp& a, const Fp& b) {
  int carry = raw_add(o.v, a.v, b.v);
  if (carry || raw_cmp(o.v, Pmod) >= 0) raw_sub(o.v, o.v, Pmod);
}

static inline void fp_sub(Fp& o, const Fp& a, const Fp& b) {
  if (raw_sub(o.v, a.v, b.v)) raw_add(o.v, o.v, Pmod);
}

static inline void fp_neg(Fp& o, const Fp& a) {
  if (fp_is_zero(a)) { o = a; return; }
  raw_sub(o.v, Pmod, a.v);
}

// CIOS Montgomery multiplication: o = a*b*2^-384 mod p
static void fp_mul(Fp& o, const Fp& a, const Fp& b) {
  u64 t[NL + 2] = {0};
  for (int i = 0; i < NL; i++) {
    u128 c = 0;
    for (int j = 0; j < NL; j++) {
      c += (u128)t[j] + (u128)a.v[i] * b.v[j];
      t[j] = (u64)c;
      c >>= 64;
    }
    c += t[NL];
    t[NL] = (u64)c;
    t[NL + 1] = (u64)(c >> 64);
    u64 m = t[0] * N0INV;
    c = (u128)t[0] + (u128)m * Pmod[0];
    c >>= 64;
    for (int j = 1; j < NL; j++) {
      c += (u128)t[j] + (u128)m * Pmod[j];
      t[j - 1] = (u64)c;
      c >>= 64;
    }
    c += t[NL];
    t[NL - 1] = (u64)c;
    t[NL] = t[NL + 1] + (u64)(c >> 64);
  }
  memcpy(o.v, t, sizeof o.v);
  if (t[NL] || raw_cmp(o.v, Pmod) >= 0) raw_sub(o.v, o.v, Pmod);
}

static inline void fp_sqr(Fp& o, const Fp& a) { fp_mul(o, a, a); }

static Fp ONE_M_fp();

static void fp_pow_pm2(Fp& o, const Fp& a) {
  // a^(p-2): Fermat inversion.  MSB-first square-and-multiply over p-2.
  u64 e[NL];
  u64 two[NL] = {2, 0, 0, 0, 0, 0};
  raw_sub(e, Pmod, two);
  Fp r = ONE_M_fp();
  for (int i = NL * 64 - 1; i >= 0; i--) {
    fp_sqr(r, r);
    if ((e[i / 64] >> (i % 64)) & 1) fp_mul(r, r, a);
  }
  o = r;
}

static Fp ONE_M_fp() {
  Fp x;
  memcpy(x.v, ONE_M, sizeof x.v);
  return x;
}

// ------------------------------------------------------------------- Fp2

struct Fp2 {
  Fp c0, c1;
};

static inline void f2_add(Fp2& o, const Fp2& a, const Fp2& b) {
  fp_add(o.c0, a.c0, b.c0);
  fp_add(o.c1, a.c1, b.c1);
}
static inline void f2_sub(Fp2& o, const Fp2& a, const Fp2& b) {
  fp_sub(o.c0, a.c0, b.c0);
  fp_sub(o.c1, a.c1, b.c1);
}
static inline void f2_neg(Fp2& o, const Fp2& a) {
  fp_neg(o.c0, a.c0);
  fp_neg(o.c1, a.c1);
}
static inline bool f2_is_zero(const Fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
static inline bool f2_eq(const Fp2& a, const Fp2& b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

static void f2_mul(Fp2& o, const Fp2& a, const Fp2& b) {
  // (a0 + a1 u)(b0 + b1 u), u^2 = -1 (3-mul Karatsuba)
  Fp t0, t1, t2, t3;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(t2, a.c0, a.c1);
  fp_add(t3, b.c0, b.c1);
  fp_mul(t2, t2, t3);
  fp_sub(t2, t2, t0);
  fp_sub(t2, t2, t1);
  fp_sub(o.c0, t0, t1);
  o.c1 = t2;
}

static void f2_sqr(Fp2& o, const Fp2& a) {
  // (a0+a1)(a0-a1), 2 a0 a1
  Fp s, d, m;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(m, a.c0, a.c1);
  fp_mul(o.c0, s, d);
  fp_add(o.c1, m, m);
}

static void f2_mul_fp(Fp2& o, const Fp2& a, const Fp& k) {
  fp_mul(o.c0, a.c0, k);
  fp_mul(o.c1, a.c1, k);
}

static void f2_mul_xi(Fp2& o, const Fp2& a) {
  // xi = 1 + u: (a0 - a1) + (a0 + a1) u
  Fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  o.c0 = t0;
  o.c1 = t1;
}

static void f2_inv(Fp2& o, const Fp2& a) {
  // 1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2)
  Fp n, t;
  fp_sqr(n, a.c0);
  fp_sqr(t, a.c1);
  fp_add(n, n, t);
  fp_pow_pm2(n, n);
  fp_mul(o.c0, a.c0, n);
  fp_neg(t, a.c1);
  fp_mul(o.c1, t, n);
}

// ------------------------------------------------------------------ Fp12
// Direct degree-6 extension over Fp2: sum c[i] w^i, w^6 = xi.

struct Fp12 {
  Fp2 c[6];
};

static void f12_one(Fp12& o) {
  memset(&o, 0, sizeof o);
  o.c[0].c0 = ONE_M_fp();
}

static bool f12_is_one(const Fp12& a) {
  Fp12 one;
  f12_one(one);
  for (int i = 0; i < 6; i++)
    if (!f2_eq(a.c[i], one.c[i])) return false;
  return true;
}

static void f12_mul(Fp12& o, const Fp12& x, const Fp12& y) {
  Fp2 acc[11];
  memset(acc, 0, sizeof acc);
  Fp2 t;
  for (int i = 0; i < 6; i++) {
    if (f2_is_zero(x.c[i])) continue;
    for (int j = 0; j < 6; j++) {
      if (f2_is_zero(y.c[j])) continue;
      f2_mul(t, x.c[i], y.c[j]);
      f2_add(acc[i + j], acc[i + j], t);
    }
  }
  for (int k = 10; k >= 6; k--) {
    f2_mul_xi(t, acc[k]);
    f2_add(acc[k - 6], acc[k - 6], t);
  }
  memcpy(o.c, acc, sizeof o.c);
}

static void f12_sqr(Fp12& o, const Fp12& a) { f12_mul(o, a, a); }

static void f12_conj(Fp12& o, const Fp12& a) {
  // w -> -w: negate odd coefficients (the p^6 Frobenius)
  o = a;
  f2_neg(o.c[1], a.c[1]);
  f2_neg(o.c[3], a.c[3]);
  f2_neg(o.c[5], a.c[5]);
}

// Frobenius x -> x^p: conj each Fp2 coefficient, multiply c[i] by
// xi^(i(p-1)/6).  The constants are computed at load time.
static Fp2 FROB_C[6];

static void f2_conj(Fp2& o, const Fp2& a) {
  o.c0 = a.c0;
  fp_neg(o.c1, a.c1);
}

static void f12_frob(Fp12& o, const Fp12& a) {
  Fp2 t;
  for (int i = 0; i < 6; i++) {
    f2_conj(t, a.c[i]);
    f2_mul(o.c[i], t, FROB_C[i]);
  }
}

// Tower inversion: write a = A(w^2) + w B(w^2) with A,B in Fp6 =
// Fp2[v]/(v^3 - xi), v = w^2.  Then 1/a = (A - wB) / (A^2 - v B^2 ...)
// — rather than juggling the iso, invert via the adjugate over Fp6.
struct Fp6 {
  Fp2 c[3];  // over v, v^3 = xi
};

static void f6_mul(Fp6& o, const Fp6& a, const Fp6& b) {
  Fp2 acc[5];
  memset(acc, 0, sizeof acc);
  Fp2 t;
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      f2_mul(t, a.c[i], b.c[j]);
      f2_add(acc[i + j], acc[i + j], t);
    }
  for (int k = 4; k >= 3; k--) {
    f2_mul_xi(t, acc[k]);
    f2_add(acc[k - 3], acc[k - 3], t);
  }
  memcpy(o.c, acc, sizeof o.c);
}

static void f6_sub(Fp6& o, const Fp6& a, const Fp6& b) {
  for (int i = 0; i < 3; i++) f2_sub(o.c[i], a.c[i], b.c[i]);
}

static void f6_mul_v(Fp6& o, const Fp6& a) {
  // multiply by v: (c2 xi, c0, c1)
  Fp2 t;
  f2_mul_xi(t, a.c[2]);
  Fp2 c0 = a.c[0], c1 = a.c[1];
  o.c[0] = t;
  o.c[1] = c0;
  o.c[2] = c1;
}

static void f6_inv(Fp6& o, const Fp6& a) {
  // adjugate method: standard for cubic extensions (v^3 = xi)
  Fp2 A, B, C, t0, t1;
  // A = c0^2 - xi c1 c2 ; B = xi c2^2 - c0 c1 ; C = c1^2 - c0 c2
  f2_sqr(A, a.c[0]);
  f2_mul(t0, a.c[1], a.c[2]);
  f2_mul_xi(t0, t0);
  f2_sub(A, A, t0);
  f2_sqr(B, a.c[2]);
  f2_mul_xi(B, B);
  f2_mul(t0, a.c[0], a.c[1]);
  f2_sub(B, B, t0);
  f2_sqr(C, a.c[1]);
  f2_mul(t0, a.c[0], a.c[2]);
  f2_sub(C, C, t0);
  // F = c0 A + xi (c1 C + c2 B)
  Fp2 F;
  f2_mul(t0, a.c[1], C);
  f2_mul(t1, a.c[2], B);
  f2_add(t0, t0, t1);
  f2_mul_xi(t0, t0);
  f2_mul(F, a.c[0], A);
  f2_add(F, F, t0);
  f2_inv(F, F);
  f2_mul(o.c[0], A, F);
  f2_mul(o.c[1], B, F);
  f2_mul(o.c[2], C, F);
}

static void f12_to_tower(const Fp12& a, Fp6& A, Fp6& B) {
  // a = A(v) + w B(v), v = w^2: even coeffs -> A, odd -> B
  A.c[0] = a.c[0];
  A.c[1] = a.c[2];
  A.c[2] = a.c[4];
  B.c[0] = a.c[1];
  B.c[1] = a.c[3];
  B.c[2] = a.c[5];
}

static void f12_from_tower(Fp12& o, const Fp6& A, const Fp6& B) {
  o.c[0] = A.c[0];
  o.c[2] = A.c[1];
  o.c[4] = A.c[2];
  o.c[1] = B.c[0];
  o.c[3] = B.c[1];
  o.c[5] = B.c[2];
}

static void f12_inv(Fp12& o, const Fp12& a) {
  // 1/(A + wB) = (A - wB)/(A^2 - v B^2)   [w^2 = v]
  Fp6 A, B, A2, B2, D, Di, oA, oB;
  f12_to_tower(a, A, B);
  f6_mul(A2, A, A);
  f6_mul(B2, B, B);
  f6_mul_v(B2, B2);
  f6_sub(D, A2, B2);
  f6_inv(Di, D);
  f6_mul(oA, A, Di);
  Fp6 negDi;
  for (int i = 0; i < 3; i++) f2_neg(negDi.c[i], Di.c[i]);
  f6_mul(oB, B, negDi);
  f12_from_tower(o, oA, oB);
}

// ----------------------------------------------------------- curve types

struct G1Aff {
  Fp x, y;
};
struct G2Aff {
  Fp2 x, y;
};
struct G2Jac {
  Fp2 X, Y, Z;
};

// ------------------------------------------------------------ Miller loop

static Fp2 XI_INV;  // (1+u)^-1, for the w^-1/w^-3 rewrite

// Doubling step: T <- 2T; line through tangent at T, evaluated at P.
static void dbl_step(Fp12& f, G2Jac& T, const G1Aff& p) {
  Fp2 A, B, C, D, E, F, t;
  f2_sqr(A, T.X);                    // X^2
  f2_sqr(B, T.Y);                    // Y^2
  f2_sqr(C, B);                      // Y^4
  f2_add(D, T.X, B);
  f2_sqr(D, D);
  f2_sub(D, D, A);
  f2_sub(D, D, C);
  f2_add(D, D, D);                   // D = 2((X+B)^2 - A - C) = 4XY^2
  f2_add(E, A, A);
  f2_add(E, E, A);                   // E = 3X^2
  f2_sqr(F, E);

  // line (scaled by 2YZ^3, an Fp2 constant — vanishes in final exp):
  //   a0 = 2YZ^3 * yp
  //   a5 = -3X^2 Z^2 * xp * xi^-1
  //   a3 = (3X^3 - 2Y^2) * xi^-1
  Fp2 Z2, l3, l5;
  f2_sqr(Z2, T.Z);
  f2_mul(t, T.Y, T.Z);
  f2_mul(t, t, Z2);
  f2_add(t, t, t);                   // 2YZ^3
  // a0 = 2YZ^3 * yp is Fp2 in general (2YZ^3 is Fp2)
  Fp2 a0v;
  f2_mul_fp(a0v, t, p.y);
  f2_mul(l5, E, Z2);
  f2_mul_fp(l5, l5, p.x);
  f2_neg(l5, l5);
  f2_mul(l5, l5, XI_INV);
  Fp2 X3cu;
  f2_mul(X3cu, A, T.X);              // X^3
  f2_add(t, X3cu, X3cu);
  f2_add(t, t, X3cu);                // 3X^3
  Fp2 twoB;
  f2_add(twoB, B, B);                // 2Y^2
  f2_sub(l3, t, twoB);
  f2_mul(l3, l3, XI_INV);

  Fp12 l;
  memset(&l, 0, sizeof l);
  l.c[0] = a0v;
  l.c[3] = l3;
  l.c[5] = l5;
  f12_mul(f, f, l);

  // point update
  Fp2 X3, Y3, Z3;
  f2_sub(X3, F, D);
  f2_sub(X3, X3, D);                 // F - 2D
  f2_mul(Z3, T.Y, T.Z);
  f2_add(Z3, Z3, Z3);                // 2YZ
  f2_sub(t, D, X3);
  f2_mul(Y3, E, t);
  Fp2 eightC;
  f2_add(eightC, C, C);
  f2_add(eightC, eightC, eightC);
  f2_add(eightC, eightC, eightC);    // 8C
  f2_sub(Y3, Y3, eightC);
  T.X = X3;
  T.Y = Y3;
  T.Z = Z3;
}

// Mixed addition step: T <- T + Q; line through T and Q, evaluated at P.
static void add_step(Fp12& f, G2Jac& T, const G2Aff& q, const G1Aff& p) {
  Fp2 Z2, Z3, U2, S2, H, Rr, t;
  f2_sqr(Z2, T.Z);
  f2_mul(Z3, Z2, T.Z);
  f2_mul(U2, q.x, Z2);
  f2_mul(S2, q.y, Z3);
  f2_sub(H, U2, T.X);                // H = xq Z^2 - X
  f2_sub(Rr, S2, T.Y);               // r = yq Z^3 - Y

  // line (scaled by -(Z H), an Fp2 constant):
  //   a0 = ZH * yp ; a5 = -r * xp * xi^-1 ; a3 = (r xq - ZH yq) * xi^-1
  Fp2 ZH, a0v, l3, l5;
  f2_mul(ZH, T.Z, H);
  f2_mul_fp(a0v, ZH, p.y);
  f2_mul_fp(l5, Rr, p.x);
  f2_neg(l5, l5);
  f2_mul(l5, l5, XI_INV);
  f2_mul(l3, Rr, q.x);
  f2_mul(t, ZH, q.y);
  f2_sub(l3, l3, t);
  f2_mul(l3, l3, XI_INV);

  Fp12 l;
  memset(&l, 0, sizeof l);
  l.c[0] = a0v;
  l.c[3] = l3;
  l.c[5] = l5;
  f12_mul(f, f, l);

  // point update (Jacobian mixed addition)
  Fp2 H2, H3, U1H2, X3, Y3;
  f2_sqr(H2, H);
  f2_mul(H3, H2, H);
  f2_mul(U1H2, T.X, H2);
  f2_sqr(X3, Rr);
  f2_sub(X3, X3, H3);
  f2_sub(X3, X3, U1H2);
  f2_sub(X3, X3, U1H2);              // r^2 - H^3 - 2 X H^2
  f2_sub(t, U1H2, X3);
  f2_mul(Y3, Rr, t);
  f2_mul(t, T.Y, H3);
  f2_sub(Y3, Y3, t);                 // r(XH^2 - X3) - Y H^3
  Fp2 Z3n;
  f2_mul(Z3n, T.Z, H);
  T.X = X3;
  T.Y = Y3;
  T.Z = Z3n;
}

static void miller(Fp12& f, const G2Aff& q, const G1Aff& p) {
  G2Jac T;
  T.X = q.x;
  T.Y = q.y;
  memset(&T.Z, 0, sizeof T.Z);
  T.Z.c0 = ONE_M_fp();
  f12_one(f);
  int top = 63;
  while (!((X_ABS >> top) & 1)) top--;
  for (int i = top - 1; i >= 0; i--) {
    f12_sqr(f, f);
    dbl_step(f, T, p);
    if ((X_ABS >> i) & 1) add_step(f, T, q, p);
  }
}

// --------------------------------------------------- final exponentiation

// hard exponent (p^4 - p^2 + 1)/r, big-endian bits; computed at init
static u64 HARD[40];  // enough limbs for ~1270 bits
static int HARD_BITS;

static void f12_pow_hard(Fp12& o, const Fp12& g) {
  Fp12 r;
  f12_one(r);
  for (int i = HARD_BITS - 1; i >= 0; i--) {
    f12_sqr(r, r);
    if ((HARD[i / 64] >> (i % 64)) & 1) f12_mul(r, r, g);
  }
  o = r;
}

static void final_exp(Fp12& o, const Fp12& f) {
  Fp12 fc, fi, g, g2;
  f12_conj(fc, f);
  f12_inv(fi, f);
  f12_mul(g, fc, fi);        // f^(p^6 - 1)
  f12_frob(g2, g);
  f12_frob(g2, g2);
  f12_mul(g, g2, g);         // ^(p^2 + 1)
  f12_pow_hard(o, g);
}

// ------------------------------------------------- big-int init helpers

// HARD = (p^4 - p^2 + 1) / r, computed with schoolbook bignum at init.
// Working radix 2^32 to keep the division simple.
static void compute_hard() {
  // p as 12 32-bit digits
  const int W = 64;  // 32-bit digits, generous
  uint32_t p32[W] = {0}, acc[W] = {0}, p2[W] = {0}, p4[W] = {0};
  for (int i = 0; i < NL; i++) {
    p32[2 * i] = (uint32_t)Pmod[i];
    p32[2 * i + 1] = (uint32_t)(Pmod[i] >> 32);
  }
  auto mul = [&](const uint32_t* a, const uint32_t* b, uint32_t* o) {
    uint64_t tmp[2 * W] = {0};
    for (int i = 0; i < W; i++) {
      if (!a[i]) continue;
      uint64_t carry = 0;
      for (int j = 0; j + i < W; j++) {
        uint64_t cur = tmp[i + j] + (uint64_t)a[i] * b[j] + carry;
        tmp[i + j] = (uint32_t)cur;
        carry = cur >> 32;
      }
    }
    for (int i = 0; i < W; i++) o[i] = (uint32_t)tmp[i];
  };
  mul(p32, p32, p2);   // p^2
  mul(p2, p2, p4);     // p^4
  // acc = p^4 - p^2 + 1
  int64_t borrow = 0;
  for (int i = 0; i < W; i++) {
    int64_t d = (int64_t)p4[i] - p2[i] - borrow;
    borrow = d < 0;
    acc[i] = (uint32_t)(d + (borrow ? ((int64_t)1 << 32) : 0));
  }
  uint64_t carry = 1;
  for (int i = 0; i < W && carry; i++) {
    uint64_t cur = (uint64_t)acc[i] + carry;
    acc[i] = (uint32_t)cur;
    carry = cur >> 32;
  }
  // divide acc by r (schoolbook long division, 32-bit digits)
  uint32_t r32[W] = {0};
  for (int i = 0; i < 4; i++) {
    r32[2 * i] = (uint32_t)Rord[i];
    r32[2 * i + 1] = (uint32_t)(Rord[i] >> 32);
  }
  int rtop = W - 1;
  while (rtop > 0 && !r32[rtop]) rtop--;
  int atop = W - 1;
  while (atop > 0 && !acc[atop]) atop--;
  uint32_t quo[W] = {0};
  // simple bitwise long division (acc ~1524 bits: fine at init time)
  uint32_t rem[W] = {0};
  for (int bit = (atop + 1) * 32 - 1; bit >= 0; bit--) {
    // rem = rem*2 + bit
    uint32_t c = (acc[bit / 32] >> (bit % 32)) & 1;
    for (int i = W - 1; i > 0; i--)
      rem[i] = (rem[i] << 1) | (rem[i - 1] >> 31);
    rem[0] = (rem[0] << 1) | c;
    // if rem >= r: rem -= r; quo bit 1
    int ge = 0;
    for (int i = W - 1; i >= 0; i--) {
      if (rem[i] != r32[i]) {
        ge = rem[i] > r32[i];
        goto cmp_done;
      }
    }
    ge = 1;
  cmp_done:
    if (ge) {
      int64_t br = 0;
      for (int i = 0; i < W; i++) {
        int64_t d = (int64_t)rem[i] - r32[i] - br;
        br = d < 0;
        rem[i] = (uint32_t)(d + (br ? ((int64_t)1 << 32) : 0));
      }
      quo[bit / 32] |= 1u << (bit % 32);
    }
  }
  memset(HARD, 0, sizeof HARD);
  for (int i = 0; i < 40 * 2 && i < W; i++) {
    HARD[i / 2] |= (u64)quo[i] << (32 * (i % 2));
  }
  HARD_BITS = 0;
  for (int i = 40 * 64 - 1; i >= 0; i--) {
    if ((HARD[i / 64] >> (i % 64)) & 1) {
      HARD_BITS = i + 1;
      break;
    }
  }
}

static void init_consts() {
  // n0inv = -p^-1 mod 2^64 (Newton)
  u64 inv = 1;
  for (int i = 0; i < 6; i++) inv *= 2 - Pmod[0] * inv;
  N0INV = (u64)(0 - inv);
  // ONE_M = 2^384 mod p: start from 1, double 384 times with reduction
  u64 x[NL] = {1, 0, 0, 0, 0, 0};
  for (int k = 0; k < 384; k++) {
    int carry = raw_add(x, x, x);
    if (carry || raw_cmp(x, Pmod) >= 0) raw_sub(x, x, Pmod);
  }
  memcpy(ONE_M, x, sizeof x);
  // R2 = 2^768 mod p: double 384 more times
  for (int k = 0; k < 384; k++) {
    int carry = raw_add(x, x, x);
    if (carry || raw_cmp(x, Pmod) >= 0) raw_sub(x, x, Pmod);
  }
  memcpy(R2, x, sizeof x);
  compute_hard();
  // XI_INV = (1+u)^-1 in Montgomery form
  Fp2 xi;
  xi.c0 = ONE_M_fp();
  xi.c1 = ONE_M_fp();
  f2_inv(XI_INV, xi);
  // FROB_C[i] = xi^(i (p-1)/6): compute via Fp2 exponentiation by the
  // integer (p-1)/6 applied i times multiplicatively.
  // (p-1)/6 fits in 6 limbs.
  u64 e[NL];
  u64 one1[NL] = {1, 0, 0, 0, 0, 0};
  raw_sub(e, Pmod, one1);
  // divide by 6 (single-word long division over limbs, MSB first)
  u64 q[NL] = {0};
  u128 rem = 0;
  for (int i = NL - 1; i >= 0; i--) {
    u128 cur = (rem << 64) | e[i];
    q[i] = (u64)(cur / 6);
    rem = cur % 6;
  }
  // base = xi^((p-1)/6) via square-and-multiply
  Fp2 base;
  base.c0 = ONE_M_fp();
  fp_zero(base.c1);
  {
    Fp2 r = base;  // one
    int started = 0;
    for (int i = NL * 64 - 1; i >= 0; i--) {
      if (started) f2_sqr(r, r);
      if ((q[i / 64] >> (i % 64)) & 1) {
        if (started)
          f2_mul(r, r, xi);
        else {
          r = xi;
          started = 1;
        }
      }
    }
    base = r;
  }
  FROB_C[0].c0 = ONE_M_fp();
  fp_zero(FROB_C[0].c1);
  for (int i = 1; i < 6; i++) f2_mul(FROB_C[i], FROB_C[i - 1], base);
}

// ------------------------------------------------------------ public API

static bool INITED = false;

static void ensure_init() {
  if (!INITED) {
    init_consts();
    INITED = true;
  }
}

static void fp_from_raw(Fp& o, const u64* limbs) {
  Fp t;
  memcpy(t.v, limbs, sizeof t.v);
  Fp r2;
  memcpy(r2.v, R2, sizeof r2.v);
  fp_mul(o, t, r2);  // to Montgomery
}

extern "C" {

// g1s: n * 12 limbs (x, y), g2s: n * 24 limbs (x0, x1, y0, y1);
// all coordinates affine, little-endian 6x64 limbs, NOT Montgomery.
// Returns 1 iff prod e(P_i, Q_i) == 1; -1 on bad input sizes.
int bls381_pairing_product_is_one(const u64* g1s, const u64* g2s, int n) {
  ensure_init();
  Fp12 f, m;
  f12_one(f);
  for (int k = 0; k < n; k++) {
    G1Aff p;
    G2Aff q;
    fp_from_raw(p.x, g1s + k * 12);
    fp_from_raw(p.y, g1s + k * 12 + 6);
    fp_from_raw(q.x.c0, g2s + k * 24);
    fp_from_raw(q.x.c1, g2s + k * 24 + 6);
    fp_from_raw(q.y.c0, g2s + k * 24 + 12);
    fp_from_raw(q.y.c1, g2s + k * 24 + 18);
    miller(m, q, p);
    f12_mul(f, f, m);
  }
  Fp12 out;
  final_exp(out, f);
  return f12_is_one(out) ? 1 : 0;
}

// Single full pairing, raw output for differential testing against the
// Python implementation: out = 72 limbs (6 Fp2 coeffs x 2 Fp x 6 limbs),
// little-endian, non-Montgomery, in the module's w-power order.
void bls381_pairing(const u64* g1, const u64* g2, u64* out) {
  ensure_init();
  G1Aff p;
  G2Aff q;
  fp_from_raw(p.x, g1);
  fp_from_raw(p.y, g1 + 6);
  fp_from_raw(q.x.c0, g2);
  fp_from_raw(q.x.c1, g2 + 6);
  fp_from_raw(q.y.c0, g2 + 12);
  fp_from_raw(q.y.c1, g2 + 18);
  Fp12 m, e;
  miller(m, q, p);
  final_exp(e, m);
  // from Montgomery: multiply by 1
  Fp onep;
  u64 raw1[NL] = {1, 0, 0, 0, 0, 0};
  memcpy(onep.v, raw1, sizeof raw1);
  for (int i = 0; i < 6; i++) {
    Fp a, b;
    fp_mul(a, e.c[i].c0, onep);
    fp_mul(b, e.c[i].c1, onep);
    memcpy(out + i * 12, a.v, sizeof a.v);
    memcpy(out + i * 12 + 6, b.v, sizeof b.v);
  }
}

}  // extern "C"
