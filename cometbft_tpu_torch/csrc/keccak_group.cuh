// Keccak-256 rows on a pair of threads: K10's row body (keccak.cu).
//
// The one-thread body (keccak.cuh keccak256_row_state, which K12 keeps)
// issues a row's whole chain from one thread: ~180 integer instructions
// a round, 24 rounds a block, and on this card a warp's integer
// instruction takes two cycles of its scheduler's 16-lane pipe.  So a
// batch of a few thousand rows is a few hundred warps of long chains,
// one warp on a scheduler, on a fraction of the SMs.  Here the two
// threads of a pair (neighbouring lanes of a warp) share a row: thread
// t holds the 32-bit word t (t = 0 the low word) of each of the 25
// lanes, so each thread issues half the row's XOR, AND-NOT and rotation
// work and a batch spreads over twice the warps.
//
// The pair runs one instruction stream.  theta's column parities, its
// d words and chi are word-wise (each thread its own words); iota XORs
// word t of the round constant.  A 64-bit rotation by r needs both
// words of its lane, so the partner's word comes by one shuffle: with o
// the thread's own word of the lane and p its partner's,
//   rotl64 by r, r < 32:   word t = funnel(p, o, r)  (the high word of
//                          (o:p) << r)
//   rotl64 by r, r >= 32:  word t = funnel(o, p, r - 32)
// the same formula on both threads.  A round exchanges 29 words: the 5
// column parities (theta's rotation by 1) and the 24 lanes that rho
// rotates (lane 0 is not rotated).  pi is a renaming of registers.
//
// Blocks: thread t loads word t of each of the block's 17 lanes (4-byte
// loads of its 8-byte lanes).  The first block's words are loaded while
// the rows' block counts are read, and each next block's before the
// current block's permutation starts.  Every row of a warp runs as many
// blocks as the warp's longest (min(active, nblocks) of its rows, one
// warp-wide max), so every thread of the warp takes every shuffle; a
// row's digest is its first 4 lanes taken after its own last block, and
// a warp whose rows are all at active = 0 runs no round (zeros: the
// state before any block).  The rounds run eight to a loop trip (three
// trips a permutation): one round a trip leaves its shuffles' latency
// exposed, and a whole permutation unrolled (~3,200 instructions) ran
// slower.
//
// Host build: outside nvcc a call holds both threads of its pair
// (KG_GL = 2 slots of per-thread words), loops over them where the
// card's threads run side by side, and the exchange reads the partner's
// slot where the card shuffles, so g++ runs a pair step for step.
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

// Word t of lane src rotated left by r (a compile-time offset).
#define KG_ROT(src, r) \
  ((r) < 32 ? kg_funnel(sp[l][src], s[l][src], (r) & 31) : kg_funnel(s[l][src], sp[l][src], (r) & 31))

// Keccak-f[1600] on the pair's words (s[l][x + 5 y] is word t of lane
// (x, y)), t the thread's index in its pair.
DEV void kg_f1600(uint32_t s[KG_GL][25], int t) {
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
        const int x1 = (x + 1) % 5;
        const uint32_t d = c[l][(x + 4) % 5] ^ kg_funnel(cp[l][x1], c[l][x1], 1);
        UNROLL
        for (int y = 0; y < 25; y += 5) s[l][x + y] ^= d;
      }
    }
    // rho + pi: lane (x, y) rotated by its rho offset lands at (y, 2x + 3y)
    uint32_t sp[KG_GL][25], b[KG_GL][25];
    kg_exchange<25>(sp, s, t, 1);
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
    // chi along each row, then iota (word t of the round constant)
    KG_EACH(l) {
      UNROLL
      for (int y = 0; y < 25; y += 5) {
        UNROLL
        for (int x = 0; x < 5; x++) s[l][y + x] = b[l][y + x] ^ (~b[l][y + (x + 1) % 5] & b[l][y + (x + 2) % 5]);
      }
      s[l][0] ^= (uint32_t)(KECCAK_RC[rnd] >> (32 * KG_TID(t, l)));
    }
  }
}

// Word t of each of the 17 lanes of the block at blk (8-byte aligned).
DEV void kg_load(uint32_t w[KG_GL][KECCAK_RATE_LANES], const uint8_t* blk, int t) {
  const uint32_t* src = (const uint32_t*)blk;
  KG_EACH(l) {
    UNROLL
    for (int i = 0; i < KECCAK_RATE_LANES; i++) w[l][i] = LDG(src + 2 * i + KG_TID(t, l));
  }
}

// One row on its pair: `act` permutations (the row's own block count,
// clamped to [0, nblocks]) of the row's padded 136-byte blocks at `row`
// (nblocks >= 1: the first block is loaded whatever the counts), inside
// a run of `nrun` >= act blocks that the pair's warp shares.
// dig[l] = word t of each of the first 4 lanes after the row's last
// block (zeros at act = 0).
DEV void keccak_pair_row(uint32_t dig[KG_GL][4], const uint8_t* row, int act, int nrun, int t) {
  uint32_t s[KG_GL][25], nxt[KG_GL][KECCAK_RATE_LANES];
  KG_EACH(l) {
    UNROLL
    for (int i = 0; i < 25; i++) s[l][i] = 0;
    UNROLL
    for (int i = 0; i < 4; i++) dig[l][i] = 0;
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
        for (int i = 0; i < 4; i++) dig[l][i] = s[l][i];
      }
    }
  }
}
