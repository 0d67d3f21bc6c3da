// Keccak-256 (the original Ethereum padding 0x01 ... 0x80, rate 136 bytes):
// the per-row body of K10 (keccak.cu) and of the fused hash-to-verdict
// kernel K12 and the ecrecover address hash (secp.cu).
//
// The 25 state lanes are native 64-bit integers in registers, at flat
// index x + 5 y: lane i of a block XORs into state lane i, the host
// absorb order of crypto/keccak.py.  (The TPU version split each lane
// into two uint32 halves because the TPU has no 64-bit integers.)
//
// Operations per Keccak-f[1600], counted from keccak_f1600 below in
// 64-bit operations: theta 55 (20 XORs for the column parities, 5
// rotations and 5 XORs for d, 25 XORs into the state), rho-pi 24
// rotations, chi 75 (NOT, AND, XOR per lane), iota 1: 155 per round,
// 3,720 per permutation.  On this card a 64-bit XOR, AND or NOT is two
// 32-bit operations and a 64-bit rotation two funnel shifts, so 7,440
// 32-bit operations, plus 34 to absorb the 17 lanes of a block: 7,474
// per block.
#pragma once

#include "common.cuh"

#define KECCAK_RATE 136
#define KECCAK_RATE_LANES 17

DCONST uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

// n in [1, 63]
DEV uint64_t rotl64(uint64_t x, int n) { return (x << n) | (x >> (64 - n)); }

DEV void keccak_f1600(uint64_t a[25]) {
  NOUNROLL
  for (int rnd = 0; rnd < 24; rnd++) {
    uint64_t c[5], d[5], b[25];
    UNROLL
    for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    UNROLL
    for (int x = 0; x < 5; x++) d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    UNROLL
    for (int i = 0; i < 25; i++) a[i] ^= d[i % 5];
    // rho + pi: lane (x, y) rotated by its rho offset lands at (y, 2x + 3y)
    b[0] = a[0];
    b[1] = rotl64(a[6], 44);
    b[2] = rotl64(a[12], 43);
    b[3] = rotl64(a[18], 21);
    b[4] = rotl64(a[24], 14);
    b[5] = rotl64(a[3], 28);
    b[6] = rotl64(a[9], 20);
    b[7] = rotl64(a[10], 3);
    b[8] = rotl64(a[16], 45);
    b[9] = rotl64(a[22], 61);
    b[10] = rotl64(a[1], 1);
    b[11] = rotl64(a[7], 6);
    b[12] = rotl64(a[13], 25);
    b[13] = rotl64(a[19], 8);
    b[14] = rotl64(a[20], 18);
    b[15] = rotl64(a[4], 27);
    b[16] = rotl64(a[5], 36);
    b[17] = rotl64(a[11], 10);
    b[18] = rotl64(a[17], 15);
    b[19] = rotl64(a[23], 56);
    b[20] = rotl64(a[2], 62);
    b[21] = rotl64(a[8], 55);
    b[22] = rotl64(a[14], 39);
    b[23] = rotl64(a[15], 41);
    b[24] = rotl64(a[21], 2);
    // chi along each row, then iota
    UNROLL
    for (int y = 0; y < 25; y += 5) {
      UNROLL
      for (int x = 0; x < 5; x++) {
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
      }
    }
    a[0] ^= KECCAK_RC[rnd];
  }
}

// Digest state of one row: `active` permutations of its nblocks padded
// 136-byte blocks (the state stays frozen past the row's own last block,
// the blocks + active contract of sha256_row).  `blocks` is 8-byte
// aligned.  The digest is the first 4 lanes, little-endian.
DEV void keccak256_row_state(uint64_t a[25], const uint8_t* blocks, int nblocks,
                             int active) {
  UNROLL
  for (int i = 0; i < 25; i++) a[i] = 0;
  NOUNROLL
  for (int b = 0; b < nblocks && b < active; b++) {
    const unsigned long long* src =
        (const unsigned long long*)(blocks + (size_t)b * KECCAK_RATE);
    UNROLL
    for (int i = 0; i < KECCAK_RATE_LANES; i++) a[i] ^= (uint64_t)LDG(src + i);
    keccak_f1600(a);
  }
}

// Keccak-256 of the 64-byte message x || y (two 256-bit big-endian
// integers given as 8 little-endian 32-bit words each): one block.
// Returns the 32-byte digest as its first 4 lanes.
DEV void keccak256_xy(uint64_t out[4], const uint32_t x[8], const uint32_t y[8]) {
  uint64_t a[25];
  UNROLL
  for (int i = 0; i < 25; i++) a[i] = 0;
  // the big-endian bytes 8i..8i+7 of a 256-bit value are its 64-bit
  // chunk 3 - i; read little-endian as a lane, that chunk byte-swapped
  UNROLL
  for (int i = 0; i < 4; i++) {
    uint64_t cx = ((uint64_t)x[7 - 2 * i] << 32) | x[6 - 2 * i];
    uint64_t cy = ((uint64_t)y[7 - 2 * i] << 32) | y[6 - 2 * i];
#ifdef __CUDACC__
    a[i] = (uint64_t)__byte_perm(cx >> 32, 0, 0x0123) |
           ((uint64_t)__byte_perm((uint32_t)cx, 0, 0x0123) << 32);
    a[4 + i] = (uint64_t)__byte_perm(cy >> 32, 0, 0x0123) |
               ((uint64_t)__byte_perm((uint32_t)cy, 0, 0x0123) << 32);
#else
    a[i] = __builtin_bswap64(cx);
    a[4 + i] = __builtin_bswap64(cy);
#endif
  }
  a[8] = 0x01ull;                 // pad: 0x01 at byte 64
  a[16] = 0x80ull << 56;          // ... 0x80 at byte 135
  keccak_f1600(a);
  UNROLL
  for (int i = 0; i < 4; i++) out[i] = a[i];
}
