// The comb tables' layout (read by comb.cu's K3 and K4 and by churn.cu's
// K6) and K3's per-thread table build.  K4's group algorithm is in
// comb_verify.cuh.
//
// Table layouts (u32 words, canonical little-endian field elements):
//   A tables  [V][64 positions][8 entries][3 coords][8 words]
//             entry e of position i is (e+1) * 16^i * (-A) in affine
//             Niels form (y+x, y-x, 2dxy); the zero digit needs no entry.
//             Validator-major: a lane's digit picks its own entry, so a
//             warp's 32 lanes read 32 different entries either way; with
//             each 96-byte entry contiguous, every 32-byte sector fetched
//             is fully used.  49,152 bytes per validator.
//   B table   [22 positions][4096 entries][3 coords][8 words]
//             entry j of position i is j * 4096^i * B (entry 0 = identity).
#pragma once

#include "ge25519.cuh"

#define COMB_NPOS_A 64
#define COMB_NENT_A 8
#define COMB_NPOS_B 22
#define COMB_NENT_B 4096
#define COMB_ENTRY_WORDS 24
#define COMB_A_WORDS (COMB_NPOS_A * COMB_NENT_A * COMB_ENTRY_WORDS)

// Build one validator's A table in place.  Pass 1 walks the chain
// j * 16^i * (-A) in extended coordinates and parks each entry's
// canonical X | Y | Z in its own table slot, with the running product of
// the Z's in `pre` (512 x 8 words of scratch); one inversion of the
// total; pass 2 walks back, peeling each entry's 1/Z off the running
// inverse (Montgomery's batch inversion) and overwriting the slot with
// the affine Niels entry.  Returns the ZIP-215 validity of the key; an
// invalid key builds from the identity, so every Z stays nonzero.
DEV bool comb_build_lane(const uint8_t pub[32], uint32_t* tab, uint32_t* pre) {
  ge_p3 a;
  bool ok = ge_from_bytes_zip215(a, pub);
  if (!ok) ge_identity(a);
  ge_p3 p;
  ge_neg(p, a);
  fe run;
  fe_1(run);
  NOUNROLL
  for (int i = 0; i < COMB_NPOS_A; i++) {
    ge_p3 acc = p;
    NOUNROLL
    for (int e = 0; e < COMB_NENT_A; e++) {
      uint32_t* slot = tab + (i * COMB_NENT_A + e) * COMB_ENTRY_WORDS;
      fe_to_words(slot, acc.X);
      fe_to_words(slot + 8, acc.Y);
      fe_to_words(slot + 16, acc.Z);
      fe_mul(run, run, acc.Z);
      fe_to_words(pre + (i * COMB_NENT_A + e) * 8, run);
      if (e + 1 < COMB_NENT_A) ge_add(acc, acc, p);
    }
    ge_dbl(p, acc);  // 16 * 16^i * (-A) = 2 * (8 * 16^i * (-A))
  }
  fe inv;
  fe_invert(inv, run);
  fe d2;
  fe_const_d2(d2);
  NOUNROLL
  for (int k = COMB_NPOS_A * COMB_NENT_A - 1; k >= 0; k--) {
    uint32_t* slot = tab + k * COMB_ENTRY_WORDS;
    fe X, Y, Z, iz;
    fe_from_words(X, slot);
    fe_from_words(Y, slot + 8);
    fe_from_words(Z, slot + 16);
    if (k > 0) {
      fe prev;
      fe_from_words(prev, pre + (k - 1) * 8);
      fe_mul(iz, inv, prev);
    } else {
      fe_copy(iz, inv);
    }
    fe_mul(inv, inv, Z);
    fe x, y, t;
    fe_mul(x, X, iz);
    fe_mul(y, Y, iz);
    fe_add(t, y, x);
    fe_to_words(slot, t);
    fe_sub(t, y, x);
    fe_to_words(slot + 8, t);
    fe_mul(t, x, y);
    fe_mul(t, t, d2);
    fe_to_words(slot + 16, t);
  }
  return ok;
}
