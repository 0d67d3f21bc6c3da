// GF(2^255 - 19) arithmetic for one lane, inlined into the comb kernels.
//
// Radix 2^25.5: ten signed limbs, limb i holds bits [OFF[i], OFF[i+1]) of
// the value, widths 26,25,26,25,... (OFF = 0,26,51,77,102,128,153,179,
// 204,230,255).  The TPU package used 22 x 12-bit int32 limbs because the
// TPU has no 64-bit integer multiply; Hopper has a native 32x32->64
// multiply (IMAD.WIDE), so each product here is one wide multiply and a
// field mul is 100 of them.
//
// Limb bounds (|.| of every limb; w = the limb's width):
//   TIGHT  |limb| < 1.01 * 2^w.  Output of fe_mul / fe_sq / fe_carry and
//          of fe_from_words (which gives limbs in [0, 2^w)).
//   LOOSE  |limb| < 1.1 * 2^27.  What fe_mul accepts: the sum or
//          difference of TWO tight elements (< 2.02 * 2^26).  Anything
//          wider goes through fe_carry first.
// Mul safety: output column k collects exactly ten products f_i g_j
// (i + j = k or k + 10); each carries a factor of at most 2 (both limbs
// odd: the half-bit of the radix) times 19 (wrap past 2^255 = 19 mod p),
// so |column| <= 10 * 38 * (1.1 * 2^27)^2 < 2^62.9 < 2^63 in int64.
// Carry: one sequential pass leaves limbs 1..9 in [0, 2^w) plus the
// incoming carry, and folds carry-out * 19 into limb 0 (|carry-out| <=
// 2^37.9, so 19 * carry < 2^42.2); a second carry of limb 0 into limb 1
// adds < 2^16.2 to limb 1: every limb ends TIGHT.
#pragma once

#include "common.cuh"

struct fe {
  int32_t v[10];
};

DEV int fe_width(int i) { return (i & 1) ? 25 : 26; }
DEV int fe_offset(int i) { return 25 * i + ((i + 1) >> 1); }  // ceil(25.5 i)

DEV void fe_0(fe& h) {
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = 0;
}

DEV void fe_1(fe& h) {
  fe_0(h);
  h.v[0] = 1;
}

DEV void fe_copy(fe& h, const fe& f) {
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i];
}

DEV void fe_add(fe& h, const fe& f, const fe& g) {
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i] + g.v[i];
}

DEV void fe_sub(fe& h, const fe& f, const fe& g) {
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i] - g.v[i];
}

DEV void fe_neg(fe& h, const fe& f) {
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = -f.v[i];
}

// Conditional move: h = b ? g : h (branch-free).
DEV void fe_cmov(fe& h, const fe& g, bool b) {
  int32_t m = -(int32_t)b;
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] ^= m & (h.v[i] ^ g.v[i]);
}

// int64 columns -> TIGHT limbs (see the header note for the bounds).
DEV void fe_carry_wide(fe& h, int64_t c[10]) {
  UNROLL
  for (int i = 0; i < 9; i++) {
    int w = fe_width(i);
    int64_t carry = c[i] >> w;  // arithmetic shift: floor division
    c[i] -= carry * ((int64_t)1 << w);
    c[i + 1] += carry;
  }
  int64_t carry = c[9] >> 25;
  c[9] -= carry * ((int64_t)1 << 25);
  c[0] += carry * 19;
  carry = c[0] >> 26;
  c[0] -= carry * ((int64_t)1 << 26);
  c[1] += carry;
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = (int32_t)c[i];
}

// Any int32 limbs with |limb| < 2^30 -> TIGHT.
DEV void fe_carry(fe& h) {
  UNROLL
  for (int i = 0; i < 9; i++) {
    int w = fe_width(i);
    int32_t carry = h.v[i] >> w;
    h.v[i] -= carry * (1 << w);
    h.v[i + 1] += carry;
  }
  int32_t carry = h.v[9] >> 25;
  h.v[9] -= carry * (1 << 25);
  h.v[0] += carry * 19;
  carry = h.v[0] >> 26;
  h.v[0] -= carry * (1 << 26);
  h.v[1] += carry;
}

// h = f * g; f, g LOOSE; h TIGHT (h may alias f or g).
DEV void fe_mul(fe& h, const fe& f, const fe& g) {
  int64_t c[10];
  UNROLL
  for (int k = 0; k < 10; k++) c[k] = 0;
  UNROLL
  for (int i = 0; i < 10; i++) {
    UNROLL
    for (int j = 0; j < 10; j++) {
      int64_t m = (int64_t)f.v[i] * (int64_t)g.v[j];
      int k = i + j;
      if ((i & 1) && (j & 1)) m *= 2;
      if (k >= 10) {
        m *= 19;
        k -= 10;
      }
      c[k] += m;
    }
  }
  fe_carry_wide(h, c);
}

DEV void fe_sq(fe& h, const fe& f) { fe_mul(h, f, f); }

// h = f^(2^n) for n >= 1.
DEV void fe_sqn(fe& h, const fe& f, int n) {
  fe_sq(h, f);
  NOUNROLL
  for (int i = 1; i < n; i++) fe_sq(h, h);
}

// Limbs from a 256-bit LE value; bit 255 is ignored (limbs cover 255
// bits), values >= p are accepted and stay correct mod p.
DEV void fe_from_words(fe& h, const uint32_t w[8]) {
  UNROLL
  for (int i = 0; i < 10; i++) {
    int off = fe_offset(i), wi = off >> 5, sh = off & 31;
    uint64_t x = (uint64_t)w[wi];
    if (wi + 1 < 8) x |= (uint64_t)w[wi + 1] << 32;
    h.v[i] = (int32_t)((x >> sh) & ((1u << fe_width(i)) - 1));
  }
}

DEV void fe_from_bytes(fe& h, const uint8_t b[32]) {
  uint32_t w[8];
  load_le256_bytes(w, b);
  fe_from_words(h, w);
}

// Canonical limbs in [0, 2^w) with value in [0, p) (ref10 fe_tobytes:
// q = floor((h + 19 * 2^-25 h9 + 1/2) / 2^255) in {-1, 0, 1} for TIGHT h,
// then h - q p with the final carry dropped).
DEV void fe_freeze(fe& h, const fe& f) {
  fe_copy(h, f);
  fe_carry(h);
  int32_t q = (19 * h.v[9] + (1 << 24)) >> 25;
  UNROLL
  for (int i = 0; i < 10; i++) q = (h.v[i] + q) >> fe_width(i);
  h.v[0] += 19 * q;
  UNROLL
  for (int i = 0; i < 9; i++) {
    int w = fe_width(i);
    int32_t carry = h.v[i] >> w;
    h.v[i + 1] += carry;
    h.v[i] -= carry * (1 << w);
  }
  h.v[9] &= (1 << 25) - 1;
}

// Canonical 256-bit LE encoding of f (bit 255 clear).
DEV void fe_to_words(uint32_t w[8], const fe& f) {
  fe t;
  fe_freeze(t, f);
  UNROLL
  for (int i = 0; i < 8; i++) w[i] = 0;
  UNROLL
  for (int i = 0; i < 10; i++) {
    int off = fe_offset(i), wi = off >> 5, sh = off & 31;
    uint64_t x = (uint64_t)(uint32_t)t.v[i] << sh;
    w[wi] |= (uint32_t)x;
    if (wi + 1 < 8) w[wi + 1] |= (uint32_t)(x >> 32);
  }
}

DEV bool fe_is_zero(const fe& f) {
  fe t;
  fe_freeze(t, f);
  int32_t acc = 0;
  UNROLL
  for (int i = 0; i < 10; i++) acc |= t.v[i];
  return acc == 0;
}

// Sign bit of the canonical value (its least significant bit).
DEV bool fe_is_negative(const fe& f) {
  fe t;
  fe_freeze(t, f);
  return t.v[0] & 1;
}

DEV bool fe_eq(const fe& f, const fe& g) {
  fe d;
  fe_sub(d, f, g);
  return fe_is_zero(d);
}

// (x^(2^250 - 1), x^11): the shared head of the inversion and
// square-root exponent chains.
DEV void fe_pow22501(fe& t250, fe& z11, const fe& x) {
  fe z2, z9, t0, t1;
  fe_sq(z2, x);                // x^2
  fe_sqn(t0, z2, 2);           // x^8
  fe_mul(z9, t0, x);           // x^9
  fe_mul(z11, z9, z2);         // x^11
  fe_sq(t0, z11);              // x^22
  fe_mul(t0, t0, z9);          // x^(2^5 - 1)
  fe_sqn(t1, t0, 5);
  fe_mul(t0, t1, t0);          // x^(2^10 - 1)
  fe_sqn(t1, t0, 10);
  fe_mul(t1, t1, t0);          // x^(2^20 - 1)
  fe_sqn(t250, t1, 20);
  fe_mul(t1, t250, t1);        // x^(2^40 - 1)
  fe_sqn(t1, t1, 10);
  fe_mul(t0, t1, t0);          // x^(2^50 - 1)
  fe_sqn(t1, t0, 50);
  fe_mul(t1, t1, t0);          // x^(2^100 - 1)
  fe_sqn(t250, t1, 100);
  fe_mul(t1, t250, t1);        // x^(2^200 - 1)
  fe_sqn(t1, t1, 50);
  fe_mul(t250, t1, t0);        // x^(2^250 - 1)
}

// h = x^(p - 2) = x^(2^255 - 21).
DEV void fe_invert(fe& h, const fe& x) {
  fe t250, z11;
  fe_pow22501(t250, z11, x);
  fe_sqn(t250, t250, 5);
  fe_mul(h, t250, z11);
}

// h = x^((p - 5) / 8) = x^(2^252 - 3).
DEV void fe_pow_p58(fe& h, const fe& x) {
  fe t250, z11;
  fe_pow22501(t250, z11, x);
  fe_sqn(t250, t250, 2);
  fe_mul(h, t250, x);
}

DEV void fe_const_d(fe& h) {
  const int32_t c[10] = {56195235, 13857412, 51736253, 6949390, 114729,
                         24766616, 60832955, 30306712, 48412415, 21499315};
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = c[i];
}

DEV void fe_const_d2(fe& h) {
  const int32_t c[10] = {45281625, 27714825, 36363642, 13898781, 229458,
                         15978800, 54557047, 27058993, 29715967, 9444199};
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = c[i];
}

DEV void fe_const_sqrtm1(fe& h) {
  const int32_t c[10] = {34513072, 25610706, 9377949, 3500415, 12389472,
                         33281959, 41962654, 31548777, 326685, 11406482};
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = c[i];
}
