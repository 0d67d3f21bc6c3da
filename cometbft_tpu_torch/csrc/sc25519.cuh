// Scalars mod L = 2^252 + 27742317777372353535851937790883648493 for one
// lane: the challenge reduction, the s < L check, and the comb digits.
//
// Reduction is Barrett in base b = 2^32 (HAC 14.42, k = 8 words):
//   q = floor(floor(x / b^7) * MU / b^9), MU = floor(b^16 / L) (9 words),
//   r = (x - q L) mod b^9, then at most two subtractions of L.
// Word products are 32x32 -> 64 with carries in u64: t = a*b + c + d
// <= (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1 never overflows.
#pragma once

#include "common.cuh"

DEV void sc_L_words(uint32_t l[9]) {
  const uint32_t c[9] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
                         0u, 0u, 0u, 0x10000000u, 0u};
  UNROLL
  for (int i = 0; i < 9; i++) l[i] = c[i];
}

// r = x mod L for a 512-bit LE value x (16 words); r as 8 words.
DEV void sc_reduce512(uint32_t r[8], const uint32_t x[16]) {
  const uint32_t mu[9] = {0x0a2c131bu, 0xed9ce5a3u, 0x086329a7u, 0x2106215du,
                          0xffffffebu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
                          0xfu};
  uint32_t l[9];
  sc_L_words(l);
  // q2 = q1 * MU, q1 = x[7..15]; only words 9..17 (q3) are kept, but the
  // carries out of the low columns are needed, so the full product runs.
  uint32_t q2[18];
  UNROLL
  for (int i = 0; i < 18; i++) q2[i] = 0;
  UNROLL
  for (int i = 0; i < 9; i++) {
    uint64_t carry = 0;
    UNROLL
    for (int j = 0; j < 9; j++) {
      uint64_t t = (uint64_t)x[7 + i] * mu[j] + q2[i + j] + carry;
      q2[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    q2[i + 9] = (uint32_t)carry;
  }
  // r2 = (q3 * L) mod b^9, q3 = q2[9..17]
  uint32_t r2[9];
  UNROLL
  for (int i = 0; i < 9; i++) r2[i] = 0;
  UNROLL
  for (int i = 0; i < 9; i++) {
    uint64_t carry = 0;
    UNROLL
    for (int j = 0; i + j < 9; j++) {
      uint64_t t = (uint64_t)q2[9 + i] * l[j] + r2[i + j] + carry;
      r2[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
  }
  // rr = (x mod b^9) - r2 mod b^9
  uint32_t rr[9];
  uint64_t borrow = 0;
  UNROLL
  for (int i = 0; i < 9; i++) {
    uint64_t t = (uint64_t)x[i] - r2[i] - borrow;
    rr[i] = (uint32_t)t;
    borrow = (t >> 63) & 1;
  }
  // at most two conditional subtractions of L (branch-free)
  UNROLL
  for (int round = 0; round < 2; round++) {
    uint32_t d[9];
    uint64_t bw = 0;
    UNROLL
    for (int i = 0; i < 9; i++) {
      uint64_t t = (uint64_t)rr[i] - l[i] - bw;
      d[i] = (uint32_t)t;
      bw = (t >> 63) & 1;
    }
    uint32_t keep = (uint32_t)0 - (uint32_t)bw;  // all ones when rr < L
    UNROLL
    for (int i = 0; i < 9; i++) rr[i] = (rr[i] & keep) | (d[i] & ~keep);
  }
  UNROLL
  for (int i = 0; i < 8; i++) r[i] = rr[i];
}

// s < L for a 256-bit LE value (ZIP-215 requires canonical s).
DEV bool sc_lt_L(const uint32_t s[8]) {
  uint32_t l[9];
  sc_L_words(l);
  uint64_t bw = 0;
  UNROLL
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)s[i] - l[i] - bw;
    bw = (t >> 63) & 1;
  }
  return bw == 1;
}

// 4-bit nibble i (weight 16^i) of a 256-bit LE value.
DEV int sc_nibble(const uint32_t k[8], int i) {
  return (int)((k[i >> 3] >> (4 * (i & 7))) & 15u);
}

// 12-bit digit i (weight 4096^i, i < 22) of a 256-bit LE value.
DEV int sc_digit12(const uint32_t s[8], int i) {
  int off = 12 * i, wi = off >> 5, sh = off & 31;
  uint64_t x = (uint64_t)s[wi];
  if (wi + 1 < 8) x |= (uint64_t)s[wi + 1] << 32;
  return (int)((x >> sh) & 0xfffu);
}
