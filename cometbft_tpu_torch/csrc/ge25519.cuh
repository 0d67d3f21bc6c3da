// Edwards25519 group law for one lane (a = -1 twisted Edwards, extended
// coordinates X:Y:Z:T with x = X/Z, y = Y/Z, T = XY/Z), ZIP-215
// decompression, and the identity test.
//
// The unified addition law is complete on this curve, so no formula here
// has an exceptional case.  Every formula keeps fe_mul's input contract
// (at most two TIGHT terms summed before a multiply; see fe25519.cuh):
// where a third term would join, the sum is carried first.  Affine Niels
// entries (y+x, y-x, 2dxy) come from canonical table words, so their
// limbs are TIGHT, and a sign flip (swap y+x / y-x, negate 2dxy) keeps
// them TIGHT.
#pragma once

#include "fe25519.cuh"

struct ge_p3 {
  fe X, Y, Z, T;
};

struct ge_niels {
  fe ypx, ymx, t2d;
};

DEV void ge_identity(ge_p3& p) {
  fe_0(p.X);
  fe_1(p.Y);
  fe_1(p.Z);
  fe_0(p.T);
}

DEV void ge_neg(ge_p3& r, const ge_p3& p) {
  fe_neg(r.X, p.X);
  fe_copy(r.Y, p.Y);
  fe_copy(r.Z, p.Z);
  fe_neg(r.T, p.T);
}

// r = p + q (add-2008-hwcd-3): A = (Y1-X1)(Y2-X2), B = (Y1+X1)(Y2+X2),
// C = T1 2d T2, D = 2 Z1 Z2; E = B-A, F = D-C, G = D+C, H = B+A.
DEV void ge_add(ge_p3& r, const ge_p3& p, const ge_p3& q) {
  fe a, b, c, d, t0, t1, d2;
  fe_sub(t0, p.Y, p.X);
  fe_sub(t1, q.Y, q.X);
  fe_mul(a, t0, t1);
  fe_add(t0, p.Y, p.X);
  fe_add(t1, q.Y, q.X);
  fe_mul(b, t0, t1);
  fe_const_d2(d2);
  fe_mul(c, p.T, d2);
  fe_mul(c, c, q.T);
  fe_add(t0, p.Z, p.Z);
  fe_mul(d, t0, q.Z);
  fe e, f, g, h;
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// r = p + n for an affine Niels n (Z2 = 1): 7 multiplies.
DEV void ge_madd(ge_p3& r, const ge_p3& p, const ge_niels& n) {
  fe a, b, c, d, t0;
  fe_sub(t0, p.Y, p.X);
  fe_mul(a, t0, n.ymx);
  fe_add(t0, p.Y, p.X);
  fe_mul(b, t0, n.ypx);
  fe_mul(c, p.T, n.t2d);
  fe_add(d, p.Z, p.Z);
  fe_carry(d);  // D joins F = D - C and G = D + C
  fe e, f, g, h;
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// r = 2p (dbl-2008-hwcd with a = -1, signs folded so that
// E = 2XY, G = Y^2 - X^2, F = 2Z^2 - G, H = X^2 + Y^2).
DEV void ge_dbl(ge_p3& r, const ge_p3& p) {
  fe xx, yy, zz, e, f, g, h, t0;
  fe_sq(xx, p.X);
  fe_sq(yy, p.Y);
  fe_sq(zz, p.Z);
  fe_add(h, xx, yy);
  fe_sub(g, yy, xx);
  fe_add(t0, p.X, p.Y);
  fe_sq(e, t0);
  fe_sub(e, e, h);
  fe_carry(e);
  fe_add(f, zz, zz);
  fe_sub(f, f, g);
  fe_carry(f);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// x == 0 and y == z.
DEV bool ge_is_identity(const ge_p3& p) {
  return fe_is_zero(p.X) && fe_eq(p.Y, p.Z);
}

// Niels entry from 24 canonical words (y+x | y-x | 2dxy), optionally
// negated (the signed-digit lookup): -(x, y) has Niels (y-x, y+x, -2dxy).
DEV void ge_niels_from_words(ge_niels& n, const uint32_t w[24], bool neg) {
  fe a, b, c;
  fe_from_words(a, w);
  fe_from_words(b, w + 8);
  fe_from_words(c, w + 16);
  if (neg) {
    fe_copy(n.ypx, b);
    fe_copy(n.ymx, a);
    fe_neg(n.t2d, c);
  } else {
    fe_copy(n.ypx, a);
    fe_copy(n.ymx, b);
    fe_copy(n.t2d, c);
  }
}

DEV void ge_niels_identity(ge_niels& n) {
  fe_1(n.ypx);
  fe_1(n.ymx);
  fe_0(n.t2d);
}

// ZIP-215 decompression (the semantics of cometbft_tpu ops/ed25519
// decompress): y is the low 255 bits taken mod p (non-canonical y
// accepted), x = sqrt((y^2 - 1) / (d y^2 + 1)) with its sign from bit
// 255; x = 0 with sign 1 is accepted.  Returns false when no square root
// exists (p is then arbitrary but well formed).
DEV bool ge_from_bytes_zip215(ge_p3& p, const uint8_t enc[32]) {
  fe y, u, v, v3, v7, x, t, d, one;
  fe_from_bytes(y, enc);  // bit 255 is ignored by fe_from_words
  bool sign = (enc[31] >> 7) & 1;
  fe_1(one);
  fe_const_d(d);
  fe_sq(t, y);
  fe_sub(u, t, one);
  fe_mul(v, t, d);
  fe_add(v, v, one);
  fe_sq(v3, v);
  fe_mul(v3, v3, v);      // v^3
  fe_sq(v7, v3);
  fe_mul(v7, v7, v);      // v^7
  fe_mul(t, u, v7);
  fe_pow_p58(t, t);       // (u v^7)^((p-5)/8)
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe vxx;
  fe_sq(t, x);
  fe_mul(vxx, v, t);
  bool ok_direct = fe_eq(vxx, u);
  fe nu;
  fe_neg(nu, u);
  bool ok_flipped = fe_eq(vxx, nu);
  fe sm1, xi;
  fe_const_sqrtm1(sm1);
  fe_mul(xi, x, sm1);
  fe_cmov(x, xi, ok_flipped);
  fe nx;
  fe_neg(nx, x);
  fe_cmov(x, nx, fe_is_negative(x) != sign);
  fe_copy(p.X, x);
  fe_copy(p.Y, y);
  fe_1(p.Z);
  fe_mul(p.T, x, y);
  return ok_direct || ok_flipped;
}
