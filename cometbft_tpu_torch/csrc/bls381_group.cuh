// The BLS12-381 G1 sum of K14's trees (bls.cu) by a group of BG_G = 4
// neighbouring threads of one warp, and the tree itself.
//
// What it is for: the tree's time is its depth (14 levels over 10,000
// rows) times one add's latency, and in one thread an add is its 16 field
// multiplies one after another (bls381.cuh g1_add: ~32K cycles).  The
// upper levels keep most of a block's threads idle, so a group of threads
// shares each add.  g1_add's multiplies fall into five phases of
// independent products, none wider than four:
//   1  Z1^2, Z2^2, Y1 Z2, Y2 Z1
//   2  U1 = X1 Z2^2, U2 = X2 Z1^2, S1 = (Y1 Z2) Z2^2, S2 = (Y2 Z1) Z1^2
//   3  I = (2H)^2, (2R)^2, Zp = Z1 Z2          (H = U2 - U1, R = S2 - S1)
//   4  J = H I, V = U1 I, Zp H
//   5  S1 J, 2R (V - X3)                       (X3 = (2R)^2 - J - 2V)
// then Y3 = 2R (V - X3) - 2 S1 J and Z3 = 2 Zp H.  Product j of a phase
// belongs to thread j of the group; every product is an fe_mul (a square
// too: a phase lasts as long as its slowest product), so an add takes five
// multiplies' latency against sixteen (a group of two, nine multiplies'
// latency, measured slower: PERF.md).  The values are g1_add's, and the
// field is canonical, so the words of the sum are the same: the same point
// representative, the same branches (an infinity operand gives the other,
// equal points the doubling, opposite ones the identity), and the plain
// version (ops/bls381.py) and every parity check hold as they stand.
//
// Exchange: the points and each group's value file (BG_SLOTS field
// elements) live in shared memory; a thread reads its operands there,
// writes its product into its slot and meets its group at __syncwarp on
// the group's lanes, so a thread holds only the operands of the product
// it computes.  The slots are reused across phases only after a barrier
// that follows their last read.  A group's lanes are aligned in their
// warp, so groups that branch apart never wait for each other.
//
// Host build: outside nvcc a call holds all BG_G threads of its group
// (BG_GL = BG_G), loops over them where the card's threads run side by
// side, and the barriers are no-ops, so g++ runs a group step for step.
#pragma once

#include "bls381.cuh"

#define BG_G 4  // threads of a group: the widest phase's products

#ifdef __CUDACC__
#define BG_GL 1  // threads of its group a call holds: its own
#define BG_TID(tid, l) (tid)
#define BG_SYNC(mask) __syncwarp(mask)
#else
#define BG_GL BG_G  // the host build holds the whole group
#define BG_TID(tid, l) (l)
#define BG_SYNC(mask)
#endif

// Product j (< n) of a phase, for each product of this call's threads.
#define BG_EACH(tid, j, n)             \
  for (int l_ = 0; l_ < BG_GL; l_++) \
    if (const int j = BG_TID(tid, l_); j < (n))

#define BG_SLOTS 8
#define BG_FILE (BG_SLOTS * BLS_W + 1)  // words of a group's value file (+1: its banks shift by group)
#define BG_PITCH (BLS_PT + 1)           // words of a point in a tree's shared memory (X, Y, Z, a pad)

DEV fe bg_get(const u32* f, int slot) { return fe_ld(f + slot * BLS_W); }

DEV void bg_put(u32* f, int slot, const fe& v) { fe_copy(f + slot * BLS_W, v.w); }

// The lanes of the group of the calling thread.
DEV unsigned bg_mask(int thread) {
  return ((1u << BG_G) - 1u) << ((thread & 31) & ~(BG_G - 1));
}

// r = p + q, g1_add's point (X, Y, Z: 36 words from each pointer), by the
// BG_G threads of a group; tid is the thread's index in its group, f the
// group's value file.  r may alias p.  Every thread of the group calls it
// with the same pointers.
DEV void bg_add(u32* r, const u32* p, const u32* q, u32* f, const int tid, const unsigned mask) {
  const u32 *X1 = p, *Y1 = p + BLS_W, *Z1 = p + 2 * BLS_W;
  const u32 *X2 = q, *Y2 = q + BLS_W, *Z2 = q + 2 * BLS_W;
  BG_SYNC(mask);  // the group's last add (its writes of p or q, its reads of f) is done
  const bool inf1 = fe_is_zero(Z1), inf2 = fe_is_zero(Z2);
  BG_SYNC(mask);  // p read on every thread before r is written
  if (inf1 || inf2) {
    const u32* s = inf1 ? q : p;
    for (int l = 0; l < BG_GL; l++)
      for (int w = BG_TID(tid, l); w < BLS_PT; w += BG_G) r[w] = s[w];
    return;
  }
  BG_EACH(tid, j, 4) {  // Z1^2, Z2^2, Y1 Z2, Y2 Z1 -> slots 0-3
    const u32* a = j == 0 ? Z1 : j == 1 ? Z2 : j == 2 ? Y1 : Y2;
    const u32* b = (j == 0 || j == 3) ? Z1 : Z2;
    bg_put(f, j, fe_mul(fe_ld(a), fe_ld(b)));
  }
  BG_SYNC(mask);
  BG_EACH(tid, j, 4) {  // U1, U2, S1, S2 -> slots 4-7
    const u32* a = j == 0 ? X1 : j == 1 ? X2 : f + j * BLS_W;
    bg_put(f, 4 + j, fe_mul(fe_ld(a), bg_get(f, (j & 1) ? 0 : 1)));
  }
  BG_SYNC(mask);
  const fe H = fe_sub(bg_get(f, 5), bg_get(f, 4)), R = fe_sub(bg_get(f, 7), bg_get(f, 6));
  if (fe_is_zero(H.w)) {
    if (fe_is_zero(R.w)) {
      if (BG_TID(tid, 0) == 0) {  // equal points: one thread doubles
        g1p d;
        fe_copy(d.X, X1);
        fe_copy(d.Y, Y1);
        fe_copy(d.Z, Z1);
        g1_double(d, d);
        fe_copy(r, d.X);
        fe_copy(r + BLS_W, d.Y);
        fe_copy(r + 2 * BLS_W, d.Z);
      }
    } else {  // opposite points: the identity
      for (int l = 0; l < BG_GL; l++)
        for (int w = BG_TID(tid, l); w < BLS_PT; w += BG_G) r[w] = w < 2 * BLS_W ? BLS_ONE_M[w % BLS_W] : 0u;
    }
    return;
  }
  const fe H2 = fe_add(H, H), R2 = fe_add(R, R);
  BG_EACH(tid, j, 3) {  // I = (2H)^2, (2R)^2, Zp = Z1 Z2 -> slots 0-2
    const fe a = j == 0 ? H2 : j == 1 ? R2 : fe_ld(Z1);
    const fe b = j == 0 ? H2 : j == 1 ? R2 : fe_ld(Z2);
    bg_put(f, j, fe_mul(a, b));
  }
  BG_SYNC(mask);
  BG_EACH(tid, j, 3) {  // J = H I -> 5, V = U1 I -> 7, Zp H -> 3
    const fe a = j == 0 ? H : bg_get(f, j == 1 ? 4 : 2);
    const fe b = j == 2 ? H : bg_get(f, 0);
    bg_put(f, j == 0 ? 5 : j == 1 ? 7 : 3, fe_mul(a, b));
  }
  BG_SYNC(mask);
  const fe J = bg_get(f, 5), V = bg_get(f, 7);
  const fe X3 = fe_sub(bg_get(f, 1), fe_add(J, fe_add(V, V)));
  BG_EACH(tid, j, 2) {  // S1 J -> 0, 2R (V - X3) -> 2
    const fe a = j == 0 ? bg_get(f, 6) : R2;
    const fe b = j == 0 ? J : fe_sub(V, X3);
    bg_put(f, 2 * j, fe_mul(a, b));
  }
  BG_SYNC(mask);
  BG_EACH(tid, j, 3) {  // coordinate j of the sum
    fe o = X3;
    if (j == 1) {
      fe J2 = bg_get(f, 0);
      J2 = fe_add(J2, J2);  // 2 S1 J
      o = fe_sub(bg_get(f, 2), J2);
    } else if (j == 2) {
      o = bg_get(f, 3);
      o = fe_add(o, o);  // 2 Zp H
    }
    fe_copy(r + j * BLS_W, o.w);
  }
}

#ifdef __CUDACC__
// The tree over the block's `width` points at pts (pitch BG_PITCH): point
// t + s into point t, s = width / 2, ..., 1, the sum ending in point 0;
// group k of the block's groups adds t = k, k + groups, ...  files: a
// value file a group.
__device__ void bg_tree(u32* pts, int width, u32* files) {
  const int k = threadIdx.x / BG_G, tid = threadIdx.x % BG_G, groups = blockDim.x / BG_G;
  const unsigned mask = bg_mask(threadIdx.x);
  for (int s = width / 2; s > 0; s >>= 1) {
    for (int t = k; t < s; t += groups)
      bg_add(pts + t * BG_PITCH, pts + t * BG_PITCH, pts + (t + s) * BG_PITCH, files + k * BG_FILE, tid,
                mask);
    __syncthreads();
  }
}
#endif
