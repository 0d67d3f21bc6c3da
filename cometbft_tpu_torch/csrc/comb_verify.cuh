// K4's group algorithm (comb.cu): COMB_T threads verify one signature
// lane against its validator's cached comb table.
//
// The verdict is the cofactored ZIP-215 check
//   [8](s B + k (-A) - R) == identity, A valid, R decodable, s < L,
// with k = digest mod L.  The sum has 87 terms: -R, 64 A-table entries
// (signed radix-16 digits of k) and 22 B-table entries (radix-4096
// digits of s).  A group splits it so that no thread carries the whole
// chain:
//   - thread 0 decompresses R (the square-root chain, ~270 dependent
//     multiplies that no split shortens) and its partial sum is -R;
//   - threads 1..T-1 start at the identity and share the 86 table
//     positions evenly, each a contiguous range, one mixed add (7
//     multiplies) a position;
//   - the partial sums are folded in ceil(log2 T) rounds, T - 1 full
//     adds (9 multiplies) in all: in round m = 1, 2, 4, ... thread t
//     with t % 2m == 0 adds the partial of thread t + m.  Thread 0 ends
//     with the whole sum, doubles it three times and decides.
// A sum of points in a group is order-free, so the verdict is that of
// the one-thread order (tables' entries and a decodable R lie on the
// curve, where the add is complete); rows whose R does not decode are
// false whatever the sum.
//
// k's signed digits.  The digits d_i in [-8, 7] with k = sum d_i 16^i
// are the nibbles of k + 0x888...8 (64 nibbles of 8) less 8: adding 8
// to every digit maps [-8, 7] onto [0, 15], and a radix-16 form with
// digits in [0, 15] is unique.  k < L < 2^253, so the sum stays below
// 2^256.  One 256-bit add thus carries every share's incoming carry,
// and a thread reads any position's digit on its own.
//
// Layout.  A block holds COMB_LANES = 32 lanes (four output bytes) and
// thread t of every lane sits in warp t: warp 0 runs the 32 lanes'
// square roots and warps 1..T-1 their table adds, every warp on one
// path, and the fold exchanges partial sums through shared memory
// between barriers.  (A group on T neighbouring threads of one warp,
// folding by shuffles, makes R's chain and the adds divergent paths
// that every warp runs one after the other: 0.74-0.76 ms against 0.49
// at 10,000 lanes on an H100, PERF.md.)  At __launch_bounds__(128, 3)
// ptxas caps a thread at 168 registers (three warps a scheduler); what would
// stay live through R's square root or the adds above that cap is kept
// in shared memory or computed again (CombShared, comb_row).  R's warp
// reads no digit: it skips the digest's reduction.
//
// Host build: outside nvcc a thread holds all T slots of its group
// (COMB_GL = COMB_T), loops over them where the card's threads run side
// by side, and the fold adds between the slots, so g++ runs a group
// (and k4_host, a whole launch) step for step as the card does.
#pragma once

#include "comb.cuh"
#include "sc25519.cuh"

#define COMB_T 4           // threads a lane
#define COMB_MIN_BLOCKS 3  // __launch_bounds__: blocks an SM holds at once
#define COMB_LANES 32  // lanes a block
#define COMB_BLOCK (COMB_LANES * COMB_T)
#define COMB_NPOS (COMB_NPOS_A + COMB_NPOS_B)
// more warps a lane fit neither the 48 KB of static shared memory
// (CombShared) nor, at these registers, 10,000 lanes in one wave
static_assert(COMB_T >= 2 && COMB_T <= 4, "threads a lane");

// K4's arguments (comb.cu k4_verify_cached)
struct K4In {
  const uint32_t* tables;  // V x COMB_A_WORDS
  const uint8_t* valid;    // V
  const uint8_t* payload;  // V x width: R | s | mlen | live | message
  int width;
  const uint8_t* digest;   // V x 64: SHA-512(R || A || M)
  const uint32_t* btab;    // COMB_NPOS_B x COMB_NENT_B x 24
  int* counters;           // 2: rows that fail, blocks done
  uint8_t* out;            // (V + 7) / 8 + 1
  int V;
};

#ifdef __CUDACC__
#define COMB_GL 1  // slots of its group a thread holds: its own
struct comb_grp {
  int t;  // the thread's index in its group
};
#define COMB_TID(g, l) ((g).t)
#else
#define COMB_GL COMB_T  // the host build holds the whole group
struct comb_grp {};
#define COMB_TID(g, l) (l)
#endif
#define COMB_EACH(l) \
  UNROLL             \
  for (int l = 0; l < COMB_GL; l++)

// kb = k + 0x888...8: nibble i of kb, less 8, is k's signed digit i.
DEV void comb_bias_digits(uint32_t kb[8], const uint32_t k[8]) {
  uint64_t c = 0;
  UNROLL
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)k[i] + 0x88888888u;
    kb[i] = (uint32_t)c;
    c >>= 32;
  }
}

// A thread's digit words: kb (words 0-7) then s (8-15), word w at
// dig[w * stride].  On the card they sit in shared memory, word-major
// (stride = the block's threads, so a warp's reads hit 32 banks): kept in
// registers through the adds they would cost 16 of them, and a loop
// counter cannot index registers.
#define COMB_DIG_WORDS 16

// The table entry of position p (< 64: A position p, k's signed digit;
// else B position p - 64, s's 12-bit digit), whether to negate it, and
// whether the digit is zero (the entry is then the identity; e points at
// a real entry all the same).
DEV const uint32_t* comb_entry(const uint32_t* tab, const uint32_t* btab, const uint32_t* dig, int stride,
                               int p, bool& neg, bool& zero) {
  if (p < COMB_NPOS_A) {
    const int d = (int)((dig[(p >> 3) * stride] >> (4 * (p & 7))) & 15u) - 8;
    neg = d < 0;
    zero = d == 0;
    const int ad = neg ? -d : d;
    return tab + (p * COMB_NENT_A + (zero ? 0 : ad - 1)) * COMB_ENTRY_WORDS;
  }
  const int i = p - COMB_NPOS_A, off = 12 * i, wi = off >> 5;
  uint64_t x = (uint64_t)dig[(8 + wi) * stride];
  if (wi + 1 < 8) x |= (uint64_t)dig[(9 + wi) * stride] << 32;
  neg = false;
  zero = false;  // entry 0 of each B position is the stored identity
  return btab + ((size_t)i * COMB_NENT_B + ((x >> (off & 31)) & 0xfffu)) * COMB_ENTRY_WORDS;
}

// 24 words of one entry (96 bytes at a multiple of 96 from a 16-byte
// aligned table, which launch_k4 checks): six 16-byte loads.
DEV void comb_load_entry(uint32_t w[COMB_ENTRY_WORDS], const uint32_t* e) {
#ifdef __CUDACC__
  const uint4* q = (const uint4*)e;
  UNROLL
  for (int i = 0; i < COMB_ENTRY_WORDS / 4; i++) {
    const uint4 x = __ldg(q + i);
    w[4 * i] = x.x;
    w[4 * i + 1] = x.y;
    w[4 * i + 2] = x.z;
    w[4 * i + 3] = x.w;
  }
#else
  for (int i = 0; i < COMB_ENTRY_WORDS; i++) w[i] = e[i];
#endif
}

// Lane v's payload row.  Each use computes it anew (one multiply-add)
// rather than keep the pointer live through R's square root.
DEV const uint8_t* comb_row(const K4In& in, int v) {
#ifdef __CUDACC__
  asm volatile("" : "+r"(v));
#endif
  return in.payload + (size_t)v * in.width;
}

// Thread t's table positions [lo, hi): none for thread 0 (R's).
DEV void comb_share(int t, int& lo, int& hi) {
  lo = t == 0 ? 0 : (t - 1) * COMB_NPOS / (COMB_T - 1);
  hi = t == 0 ? 0 : t * COMB_NPOS / (COMB_T - 1);
}

// acc += the entries of positions [lo, hi)
DEV void comb_share_sum(ge_p3& acc, const uint32_t* tab, const uint32_t* btab,
                        const uint32_t* dig, int stride, int lo, int hi) {
  NOUNROLL
  for (int p = lo; p < hi; p++) {
    uint32_t w[COMB_ENTRY_WORDS];
    bool neg, zero;
    comb_load_entry(w, comb_entry(tab, btab, dig, stride, p, neg, zero));
    ge_niels n;
    ge_niels_from_words(n, w, neg);
    if (zero) ge_niels_identity(n);
    ge_madd(acc, acc, n);
  }
}

// A block's shared memory: its threads' digit words, whether R decodes
// (thread 0 of a lane) and the partial sums the fold exchanges.  The
// first two would otherwise stay live in registers through R's square
// root or the adds, the two stretches where __launch_bounds__'s cap
// binds.
struct CombShared {
  uint32_t dig[COMB_DIG_WORDS][COMB_BLOCK];
  uint8_t r_ok[COMB_BLOCK];
  ge_p3 x[COMB_T][COMB_LANES];
};

// Round m of the fold: thread t with t % 2m == 0 and t + m < T adds the
// partial sum of thread t + m = t ^ m (a full add), so after the rounds
// m = 1, 2, 4, ... thread 0 holds the group's sum; j is the lane in its
// block.  Every thread of the block calls it (the block's barriers).
DEV bool comb_folds(int t, int m) { return (t & (2 * m - 1)) == 0 && t + m < COMB_T; }

DEV void comb_fold_round(const comb_grp& g, ge_p3 part[COMB_GL], int m, CombShared& sm, int j) {
#ifdef __CUDACC__
  sm.x[g.t][j] = part[0];
  __syncthreads();
  if (comb_folds(g.t, m)) ge_add(part[0], part[0], sm.x[g.t + m][j]);
  __syncthreads();
#else
  (void)g;
  (void)sm;
  (void)j;
  for (int l = 0; l < COMB_GL; l++) {
    if (comb_folds(l, m)) ge_add(part[l], part[l], part[l ^ m]);
  }
#endif
}

// Lane v's verdict, from its group's threads.  Every thread of the block
// calls it, in range or not (the fold's exchange needs them all); the
// verdict is that of thread 0 (slot 0), the others return false.  R's
// square root comes first, while no other value is live.
DEV bool comb_group_verify(const K4In& in, int v, bool in_range, const comb_grp g, CombShared& sm,
                           int j) {
  ge_p3 part[COMB_GL];
#ifdef __CUDACC__
  uint8_t& r_ok = sm.r_ok[threadIdx.x];
#else
  uint8_t r_ok_slot;
  uint8_t& r_ok = r_ok_slot;
#endif
  r_ok = 0;
  COMB_EACH(l) {
    if (in_range && COMB_TID(g, l) == 0) {
      ge_p3 r;
      r_ok = ge_from_bytes_zip215(r, comb_row(in, v));
      ge_neg(part[l], r);
    } else {
      ge_identity(part[l]);
    }
  }
  // the digits, for a thread with table positions: on the card every
  // thread but R's, on the host every group (its last slot is T - 1)
  if (in_range && COMB_TID(g, COMB_GL - 1) != 0) {
    const uint8_t* dg = in.digest + (size_t)v * 64;
    uint32_t x[16], k[8], kb[8], s[8];
#ifdef __CUDACC__
    uint32_t* dig = &sm.dig[0][threadIdx.x];
    const int stride = COMB_BLOCK;
#else
    uint32_t dig[COMB_DIG_WORDS];
    const int stride = 1;
#endif
    UNROLL
    for (int i = 0; i < 16; i++) {
      x[i] = (uint32_t)dg[4 * i] | ((uint32_t)dg[4 * i + 1] << 8) |
             ((uint32_t)dg[4 * i + 2] << 16) | ((uint32_t)dg[4 * i + 3] << 24);
    }
    sc_reduce512(k, x);
    comb_bias_digits(kb, k);
    load_le256_bytes(s, comb_row(in, v) + 32);
    UNROLL
    for (int i = 0; i < 8; i++) {
      dig[i * stride] = kb[i];
      dig[(8 + i) * stride] = s[i];
    }
    const uint32_t* tab = in.tables + (size_t)v * COMB_A_WORDS;
    COMB_EACH(l) {
      int lo, hi;
      comb_share(COMB_TID(g, l), lo, hi);
      comb_share_sum(part[l], tab, in.btab, dig, stride, lo, hi);
    }
  }
  for (int m = 1; m < COMB_T; m <<= 1) comb_fold_round(g, part, m, sm, j);
  // A valid and s < L are read here rather than kept live through the
  // adds; r_ok is false outside the batch
  bool ok = false;
  if (COMB_TID(g, 0) == 0) {
    ge_p3 acc = part[0];
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    if (r_ok && ge_is_identity(acc)) {
      uint32_t s[8];
      load_le256_bytes(s, comb_row(in, v) + 32);
      ok = sc_lt_L(s) && in.valid[v] != 0;
    }
  }
  return ok;
}

// Output byte b (< COMB_LANES / 8) of a block from its lanes' bits
// (okl[j] = ok & live of lane j): numpy.packbits order, lane 0 of the
// byte in bit 7.
DEV uint8_t comb_pack_byte(const uint8_t okl[COMB_LANES], int b) {
  unsigned x = 0;
  UNROLL
  for (int k = 0; k < 8; k++) x |= (unsigned)(okl[8 * b + k] != 0) << (7 - k);
  return (uint8_t)x;
}

#ifndef __CUDACC__
// The host build of a launch: every block in turn, every lane of a block
// through comb_group_verify with its group's threads in slots, then the
// block's bytes; the all-ok byte from the count of failing rows.
static void k4_host(const K4In& in) {
  const int nbytes = (in.V + 7) / 8;
  CombShared sm;
  comb_grp g;
  int bad = 0;
  for (int blk = 0; blk * COMB_LANES < in.V; blk++) {
    uint8_t okl[COMB_LANES];
    for (int j = 0; j < COMB_LANES; j++) {
      const int v = blk * COMB_LANES + j;
      const bool in_range = v < in.V;
      const bool ok = comb_group_verify(in, v, in_range, g, sm, j);
      const bool live = in_range && in.payload[(size_t)v * in.width + 67] == 1;
      okl[j] = ok && live;
      bad += in_range && !(ok || !live);
    }
    for (int b = 0; b < COMB_LANES / 8; b++) {
      if (blk * (COMB_LANES / 8) + b < nbytes) in.out[blk * (COMB_LANES / 8) + b] = comb_pack_byte(okl, b);
    }
  }
  in.out[nbytes] = bad == 0 ? 1 : 0;
}
#endif
