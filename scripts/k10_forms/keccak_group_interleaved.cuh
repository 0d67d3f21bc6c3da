// Keccak-256 rows on a pair of threads, bit-interleaved: a form of K10's
// row body (keccak.cu) measured against the shipped one
// (cometbft_tpu_torch/csrc/keccak_group.cuh); scripts/
// torch_short_kernels_ab.py's patch k10_interleaved puts it in that
// header's place.  Same interface as the shipped header.
//
// Thread t of the pair holds, of each of the 25 lanes, the 32 bits
// t, t + 2, ..., t + 62 (h_t: bit j of h_t is bit 2j + t of the lane).
// A 64-bit rotation by an even r = 2k rotates each thread's own word by
// k; by an odd r = 2k + 1 the words cross the pair: h_t' = rotl32(h_(1-t),
// k + 1 - t).  So a round exchanges 17 words (theta's 5 column parities,
// rotated by 1, and the 12 lanes of odd rho offsets) where the shipped
// form exchanges 29, but a block's 17 lanes are split into their even
// and odd bits on the way in (a 4-step unshuffle of each thread's word,
// one shuffle and one byte permute a lane) and the digest's 4 lanes put
// back together on the way out.
#pragma once

#include "keccak.cuh"

#ifdef __CUDACC__
#define KG_GL 1  // threads of its pair a call holds: its own
#define KG_TID(t, l) (t)
#else
#define KG_GL 2  // the host build holds the whole pair
#define KG_TID(t, l) (l)
#endif
#define KG_EACH(l) \
  UNROLL           \
  for (int l = 0; l < KG_GL; l++)
#ifdef __CUDACC__
#define KG_ROUNDS_A_TRIP _Pragma("unroll 8")  // a loop trip of eight rounds
#else
#define KG_ROUNDS_A_TRIP
#endif

// The high word of (hi:lo) << s, s in [0, 31].
DEV uint32_t kg_funnel(uint32_t lo, uint32_t hi, int s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(lo, hi, s);
#else
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
#endif
}

// The thread of its pair whose words a thread reads: its partner.
DEV int kg_src(int t) { return t ^ 1; }

// p[l][i] = the partner's w[i], for i in [from, N).
template <int N>
DEV void kg_exchange(uint32_t p[KG_GL][N], const uint32_t w[KG_GL][N], int t, int from) {
#ifdef __CUDA_ARCH__
  UNROLL
  for (int i = from; i < N; i++) p[0][i] = __shfl_sync(0xffffffffu, w[0][i], kg_src(t), 2);
#else
  KG_EACH(l) {
    for (int i = from; i < N; i++) p[l][i] = w[kg_src(l)][i];
  }
#endif
}


// rotl32(x, s), s in [0, 31].
DEV uint32_t kg_rotl(uint32_t x, int s) { return kg_funnel(x, x, s); }

// The bytes of (b:a) picked by the 4 selector nibbles of s (PRMT).
DEV uint32_t kg_perm(uint32_t a, uint32_t b, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(a, b, s);
#else
  const uint64_t v = ((uint64_t)b << 32) | a;
  uint32_t r = 0;
  for (int i = 0; i < 4; i++) r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
#endif
}

// Even bits of x to its low half, odd bits to its high half, and back.
DEV uint32_t kg_unshuffle(uint32_t x) {
  uint32_t t;
  t = (x ^ (x >> 1)) & 0x22222222u; x ^= t ^ (t << 1);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu; x ^= t ^ (t << 2);
  t = (x ^ (x >> 4)) & 0x00F000F0u; x ^= t ^ (t << 4);
  t = (x ^ (x >> 8)) & 0x0000FF00u; x ^= t ^ (t << 8);
  return x;
}

DEV uint32_t kg_shuffle(uint32_t x) {
  uint32_t t;
  t = (x ^ (x >> 8)) & 0x0000FF00u; x ^= t ^ (t << 8);
  t = (x ^ (x >> 4)) & 0x00F000F0u; x ^= t ^ (t << 4);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu; x ^= t ^ (t << 2);
  t = (x ^ (x >> 1)) & 0x22222222u; x ^= t ^ (t << 1);
  return x;
}

// The round constants' even and odd bits.
DCONST uint32_t KG_RC_I[24][2] = {
    {0x00000001u, 0x00000000u}, {0x00000000u, 0x00000089u}, {0x00000000u, 0x8000008Bu},
    {0x00000000u, 0x80008080u}, {0x00000001u, 0x0000008Bu}, {0x00000001u, 0x00008000u},
    {0x00000001u, 0x80008088u}, {0x00000001u, 0x80000082u}, {0x00000000u, 0x0000000Bu},
    {0x00000000u, 0x0000000Au}, {0x00000001u, 0x00008082u}, {0x00000000u, 0x00008003u},
    {0x00000001u, 0x0000808Bu}, {0x00000001u, 0x8000000Bu}, {0x00000001u, 0x8000008Au},
    {0x00000001u, 0x80000081u}, {0x00000000u, 0x80000081u}, {0x00000000u, 0x80000008u},
    {0x00000000u, 0x00000083u}, {0x00000000u, 0x80008003u}, {0x00000001u, 0x80008088u},
    {0x00000000u, 0x80000088u}, {0x00000001u, 0x00008000u}, {0x00000000u, 0x80008082u}};

// h_t of lane src rotated left by r (a compile-time offset): own word
// for an even r, the partner's (sp) for an odd one, am = 1 - t.
#define KG_ROT(src, r) \
  ((r) % 2 == 0 ? kg_rotl(s[l][src], (r) / 2) : kg_rotl(sp[l][src], (r) / 2 + am[l]))

DEV void kg_f1600(uint32_t s[KG_GL][25], int t) {
  int am[KG_GL];
  KG_EACH(l) am[l] = 1 - KG_TID(t, l);
  KG_ROUNDS_A_TRIP
  for (int rnd = 0; rnd < 24; rnd++) {
    // theta
    uint32_t c[KG_GL][5], cp[KG_GL][5];
    KG_EACH(l) {
      UNROLL
      for (int x = 0; x < 5; x++) c[l][x] = s[l][x] ^ s[l][x + 5] ^ s[l][x + 10] ^ s[l][x + 15] ^ s[l][x + 20];
    }
    kg_exchange<5>(cp, c, t, 0);
    KG_EACH(l) {
      UNROLL
      for (int x = 0; x < 5; x++) {
        const uint32_t d = c[l][(x + 4) % 5] ^ kg_rotl(cp[l][(x + 1) % 5], am[l]);
        UNROLL
        for (int y = 0; y < 25; y += 5) s[l][x + y] ^= d;
      }
    }
    // rho + pi; the 12 lanes of odd offsets come from the partner
    uint32_t sp[KG_GL][25] = {}, b[KG_GL][25];
    const int odd[12] = {12, 18, 10, 16, 22, 1, 13, 4, 17, 8, 14, 15};
#ifdef __CUDA_ARCH__
    UNROLL
    for (int i = 0; i < 12; i++) sp[0][odd[i]] = __shfl_sync(0xffffffffu, s[0][odd[i]], kg_src(t), 2);
#else
    KG_EACH(l) {
      for (int i = 0; i < 12; i++) sp[l][odd[i]] = s[kg_src(l)][odd[i]];
    }
#endif
    KG_EACH(l) {
      b[l][0] = s[l][0];
      b[l][1] = KG_ROT(6, 44);
      b[l][2] = KG_ROT(12, 43);
      b[l][3] = KG_ROT(18, 21);
      b[l][4] = KG_ROT(24, 14);
      b[l][5] = KG_ROT(3, 28);
      b[l][6] = KG_ROT(9, 20);
      b[l][7] = KG_ROT(10, 3);
      b[l][8] = KG_ROT(16, 45);
      b[l][9] = KG_ROT(22, 61);
      b[l][10] = KG_ROT(1, 1);
      b[l][11] = KG_ROT(7, 6);
      b[l][12] = KG_ROT(13, 25);
      b[l][13] = KG_ROT(19, 8);
      b[l][14] = KG_ROT(20, 18);
      b[l][15] = KG_ROT(4, 27);
      b[l][16] = KG_ROT(5, 36);
      b[l][17] = KG_ROT(11, 10);
      b[l][18] = KG_ROT(17, 15);
      b[l][19] = KG_ROT(23, 56);
      b[l][20] = KG_ROT(2, 62);
      b[l][21] = KG_ROT(8, 55);
      b[l][22] = KG_ROT(14, 39);
      b[l][23] = KG_ROT(15, 41);
      b[l][24] = KG_ROT(21, 2);
    }
    KG_EACH(l) {
      UNROLL
      for (int y = 0; y < 25; y += 5) {
        UNROLL
        for (int x = 0; x < 5; x++) s[l][y + x] = b[l][y + x] ^ (~b[l][y + (x + 1) % 5] & b[l][y + (x + 2) % 5]);
      }
      s[l][0] ^= KG_RC_I[rnd][KG_TID(t, l)];
    }
  }
}

// h_t of each of the 17 lanes of the block at blk (8-byte aligned):
// thread t loads word t of a lane and splits it, the pair swaps halves.
DEV void kg_load(uint32_t w[KG_GL][KECCAK_RATE_LANES], const uint8_t* blk, int t) {
  const uint32_t* src = (const uint32_t*)blk;
  uint32_t u[KG_GL][KECCAK_RATE_LANES], up[KG_GL][KECCAK_RATE_LANES];
  KG_EACH(l) {
    UNROLL
    for (int i = 0; i < KECCAK_RATE_LANES; i++) u[l][i] = kg_unshuffle(LDG(src + 2 * i + KG_TID(t, l)));
  }
  kg_exchange<KECCAK_RATE_LANES>(up, u, t, 0);
  KG_EACH(l) {
    const uint32_t sel = KG_TID(t, l) ? 0x3276u : 0x5410u;
    UNROLL
    for (int i = 0; i < KECCAK_RATE_LANES; i++) w[l][i] = kg_perm(u[l][i], up[l][i], sel);
  }
}

DEV void keccak_pair_row(uint32_t dig[KG_GL][4], const uint8_t* row, int act, int nrun, int t) {
  uint32_t s[KG_GL][25], nxt[KG_GL][KECCAK_RATE_LANES], h[KG_GL][4];
  KG_EACH(l) {
    UNROLL
    for (int i = 0; i < 25; i++) s[l][i] = 0;
    UNROLL
    for (int i = 0; i < 4; i++) h[l][i] = 0;
  }
  kg_load(nxt, row, t);
  NOUNROLL
  for (int b = 0; b < nrun; b++) {
    KG_EACH(l) {
      UNROLL
      for (int i = 0; i < KECCAK_RATE_LANES; i++) s[l][i] ^= nxt[l][i];
    }
    if (b + 1 < nrun) kg_load(nxt, row + (size_t)(b + 1) * KECCAK_RATE, t);
    kg_f1600(s, t);
    if (b + 1 == act) {
      KG_EACH(l) {
        UNROLL
        for (int i = 0; i < 4; i++) h[l][i] = s[l][i];
      }
    }
  }
  // back to word t of each lane: the same byte permute, then the shuffle
  uint32_t hp[KG_GL][4];
  kg_exchange<4>(hp, h, t, 0);
  KG_EACH(l) {
    const uint32_t sel = KG_TID(t, l) ? 0x3276u : 0x5410u;
    UNROLL
    for (int i = 0; i < 4; i++) dig[l][i] = kg_shuffle(kg_perm(h[l][i], hp[l][i], sel));
  }
}
