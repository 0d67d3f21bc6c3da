// Per-lane body of K5 (uncached Straus verify), used by ed25519.cu.
//
// One lane checks one signature against its own pubkey:
//   [8](s B + k (-A) - R) == identity, k = SHA-512(R || A || M) mod L,
// with A and R decoded under ZIP-215 and s < L.  The double-scalar
// product runs as one Straus chain over 64 radix-16 windows, most
// significant first: acc = 16 acc + k_i (-A) + s_i B.
//
// Windows: k in signed digits d_i in [-8, 7] against an 8-entry table
// of j (-A), j = 1..8 (a negative digit negates the entry, the zero
// digit adds the identity); s in unsigned 4-bit windows against the
// shared 16-entry table of j B, j = 0..15 (entry 0 is the identity).
//
// Table layouts:
//   -A table  per lane, in local memory: 8 cached entries
//             (Y+X, Y-X, Z, 2dT) of extended points.
//   B window  [16 entries][3 coords][8 words] canonical affine Niels
//             (y+x, y-x, 2dxy), in global memory, read through the
//             read-only cache (lanes pick different entries).
//
// Limb contract (csrc/fe25519.cuh): every point coordinate that leaves
// a group operation is TIGHT (a multiply output), and a decoded point's
// coordinates are TIGHT.  A cached entry's Y+X and Y-X are the sum and
// difference of two TIGHT elements, so LOOSE, and each feeds one
// multiply directly; Z and 2dT are TIGHT.  Negating an entry swaps
// Y+X / Y-X and negates 2dT, which keeps every bound.
#pragma once

#include "ge25519.cuh"
#include "sc25519.cuh"

#define STRAUS_NWIN 64
#define STRAUS_NENT_A 8
#define STRAUS_NENT_B 16
#define STRAUS_ENTRY_WORDS 24

struct ge_cached {
  fe ypx, ymx, z, t2d;
};

DEV void ge_to_cached(ge_cached& c, const ge_p3& p) {
  fe d2;
  fe_add(c.ypx, p.Y, p.X);
  fe_sub(c.ymx, p.Y, p.X);
  fe_copy(c.z, p.Z);
  fe_const_d2(d2);
  fe_mul(c.t2d, p.T, d2);
}

DEV void ge_cached_identity(ge_cached& c) {
  fe_1(c.ypx);
  fe_1(c.ymx);
  fe_1(c.z);
  fe_0(c.t2d);
}

// r = p + c for a cached c (add-2008-hwcd-3 with 2d T2 precomputed):
// 8 multiplies.  D = (2 Z1) Z2 comes out of a multiply, so TIGHT, and
// F = D - C, G = D + C need no carry.
DEV void ge_add_cached(ge_p3& r, const ge_p3& p, const ge_cached& c) {
  fe a, b, cc, d, t0;
  fe_sub(t0, p.Y, p.X);
  fe_mul(a, t0, c.ymx);
  fe_add(t0, p.Y, p.X);
  fe_mul(b, t0, c.ypx);
  fe_mul(cc, p.T, c.t2d);
  fe_add(t0, p.Z, p.Z);
  fe_mul(d, t0, c.z);
  fe e, f, g, h;
  fe_sub(e, b, a);
  fe_sub(f, d, cc);
  fe_add(g, d, cc);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// The -A table: tab[j - 1] = j (-A) for j = 1..8 (1 doubling, 6 adds).
DEV void straus_build_table(ge_cached tab[STRAUS_NENT_A], const ge_p3& na) {
  ge_p3 acc;
  ge_to_cached(tab[0], na);
  ge_dbl(acc, na);
  ge_to_cached(tab[1], acc);
  NOUNROLL
  for (int j = 2; j < STRAUS_NENT_A; j++) {
    ge_add_cached(acc, acc, tab[0]);
    ge_to_cached(tab[j], acc);
  }
}

DEV bool straus_verify_lane(const uint8_t a_enc[32], const uint8_t r_enc[32],
                            const uint8_t s_enc[32], const uint8_t digest[64],
                            const uint32_t* bwin) {
  uint32_t x[16], k[8], s[8];
  UNROLL
  for (int i = 0; i < 16; i++) {
    x[i] = (uint32_t)digest[4 * i] | ((uint32_t)digest[4 * i + 1] << 8) |
           ((uint32_t)digest[4 * i + 2] << 16) |
           ((uint32_t)digest[4 * i + 3] << 24);
  }
  sc_reduce512(k, x);
  load_le256_bytes(s, s_enc);
  bool s_ok = sc_lt_L(s);
  ge_p3 a, r;
  bool a_ok = ge_from_bytes_zip215(a, a_enc);
  bool r_ok = ge_from_bytes_zip215(r, r_enc);

  ge_cached tab[STRAUS_NENT_A];
  ge_p3 na;
  ge_neg(na, a);
  straus_build_table(tab, na);

  // signed radix-16 digits of k (d = nibble + carry; d >= 8 borrows 16
  // from the next digit; k < 2^253 so the last carry is 0)
  int8_t kd[STRAUS_NWIN];
  int carry = 0;
  UNROLL
  for (int i = 0; i < STRAUS_NWIN; i++) {
    int d = sc_nibble(k, i) + carry;
    carry = d >= 8;
    kd[i] = (int8_t)(d - (carry << 4));
  }

  ge_p3 acc;
  ge_identity(acc);
  ge_cached c;
  ge_niels n;
  uint32_t w[STRAUS_ENTRY_WORDS];
  NOUNROLL
  for (int i = STRAUS_NWIN - 1; i >= 0; i--) {
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    int d = kd[i];
    int ad = d < 0 ? -d : d;
    if (ad == 0) {
      ge_cached_identity(c);
    } else {
      c = tab[ad - 1];
    }
    if (d < 0) {
      fe t;
      fe_copy(t, c.ypx);
      fe_copy(c.ypx, c.ymx);
      fe_copy(c.ymx, t);
      fe_neg(c.t2d, c.t2d);
    }
    ge_add_cached(acc, acc, c);
    const uint32_t* e = bwin + sc_nibble(s, i) * STRAUS_ENTRY_WORDS;
    UNROLL
    for (int j = 0; j < STRAUS_ENTRY_WORDS; j++) w[j] = LDG(e + j);
    ge_niels_from_words(n, w, false);
    ge_madd(acc, acc, n);
  }
  ge_p3 nr;
  ge_neg(nr, r);
  ge_add(acc, acc, nr);
  ge_dbl(acc, acc);
  ge_dbl(acc, acc);
  ge_dbl(acc, acc);
  return ge_is_identity(acc) && a_ok && r_ok && s_ok;
}
