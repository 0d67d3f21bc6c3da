// The comb tables' layout (read by comb.cu's K3 and K4 and by churn.cu's
// K6).  K3's group build is in comb_build.cuh, K4's group algorithm in
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
