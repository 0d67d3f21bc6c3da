// K8's algorithm: every level of an RFC-6962 Merkle tree above level 0 in
// ONE launch (merkle.cu k8_merkle_tree), in place in the flat node tensor
// (level l at the row offset sum of the sizes below it, ops/merkle.py
// level_offsets; level 0 holds the n leaf hashes).
//
// Stage 1, a subtree a block: block b of T threads owns the aligned span
// of 2T level-0 nodes starting at b 2T.  At each level thread t hashes
// the block's pair (2t, 2t + 1) and writes the parent to the block's
// buffer and to the flat tensor; after log2(2T) levels the span is one
// node.  Only the last block's span can be partial, and its trailing odd
// node is then the level's trailing node (b 2T / 2^l is even at every
// level stage 1 hashes), so promoting it unchanged is hash_level's rule.
// Stage 2, the last block to finish: each block fences its writes and
// takes a ticket from a device counter; the block that draws the last
// one (CUDA's threadFenceReduction pattern) reduces the ceil(n / 2T)
// subtree roots to the root, level by level, and resets the counter for
// the next launch on the stream.  A level whose output exceeds T nodes
// (more than 4 T^2 leaves) runs over the flat tensor in chunks of T pairs;
// smaller ones run in the buffer.  Nodes written by other blocks are read
// through L2 (ld.global.cg), never through the non-coherent L1 paths.
//
// A tree of n <= 2T leaves is one block and stage 1 alone.  The time is
// the chain: ceil(log2 n) levels of two dependent SHA-256 compressions
// each, plus one launch, instead of one launch a level.
//
// Host build: outside nvcc MT_EACH runs the block's T threads one after
// another where the card runs them side by side and MT_SYNC is a no-op
// (each level's threads read only the level below), so g++ runs a launch
// block by block: stage 1 of every block, then stage 2.
#pragma once

#include "sha256.cuh"

#define MERKLE_TREE_THREADS 256  // T: threads of a block, which owns 2T level-0 nodes

#ifdef __CUDACC__
#define LDCG(p) __ldcg(p)
#define MT_EACH(t, T) if (const int t = (int)threadIdx.x; true)
#define MT_SYNC() __syncthreads()
#else
#define LDCG(p) (*(p))
#define MT_EACH(t, T) for (int t = 0; t < (T); t++)
#define MT_SYNC()
#endif

// A block's buffer: two levels of at most T nodes each, as the 8
// big-endian state words of each node (the next level reads them as is).
template <int T>
struct MtShared {
  uint32_t w[2][T][8];
};

// log2(N) of a power of two N: mt_log2<2 * T>::v is the levels stage 1
// hashes when the tree has that many.
template <int N>
struct mt_log2 {
  static constexpr int v = 1 + mt_log2<N / 2>::v;
};
template <>
struct mt_log2<1> {
  static constexpr int v = 0;
};

// Levels of an n-leaf tree below its root: len(level_sizes(n)).
DEV int mt_depth(int n) {
  int d = 0;
  for (long long s = n; s > 1; s = (s + 1) / 2) d++;
  return d;
}

// Row offset of level l of an n-leaf tree in the flat tensor.
DEV long long mt_offset(int n, int l) {
  long long off = 0, s = n;
  for (int k = 0; k < l; k++) {
    off += s;
    s = (s + 1) / 2;
  }
  return off;
}

// Node k of a level as big-endian words: from the buffer slot when the
// block holds the level there (cur >= 0), else from the flat tensor row.
template <int T>
DEV void mt_load(uint32_t w[8], const uint8_t* flat, long long row, const MtShared<T>& sm, int cur, int k) {
  if (cur >= 0) {
    UNROLL
    for (int j = 0; j < 8; j++) w[j] = sm.w[cur][k][j];
  } else {
    const uint32_t* src = (const uint32_t*)(flat + (size_t)row * 32);
    UNROLL
    for (int j = 0; j < 8; j++) w[j] = bswap32(LDCG(src + j));
  }
}

// The block's part of levels lvl .. lvl_end - 1 of an n-leaf tree, each
// written as the next level: at level lvl the block owns nodes [base,
// base + span) (clipped to the level's end); each level halves both.  The
// first level is read from the flat tensor (offset off), later ones from
// the buffer while they fit in it.  Ends with a block barrier.
template <int T>
DEV void mt_levels(uint8_t* flat, int n, int lvl, int lvl_end, long long off, int base, int span,
                   MtShared<T>& sm) {
  long long size = ((long long)n + (1LL << lvl) - 1) >> lvl;  // nodes of level lvl
  int cur = -1;  // the buffer holding level lvl, or -1: the flat tensor
  NOUNROLL
  for (; lvl < lvl_end; lvl++) {
    const int cnt = (int)(size - base < span ? size - base : span);  // the block's nodes
    const int m = (cnt + 1) / 2;                                     // its parents
    const long long out = off + size;                                // the next level's offset
    const int nxt = cur == 0 ? 1 : 0;
    const bool keep = m <= T;  // the parents fit in the buffer
    MT_EACH(t, T) {
      NOUNROLL
      for (int i = t; i < m; i += T) {
        uint32_t l[8], st[8];
        mt_load<T>(l, flat, off + base + 2 * i, sm, cur, 2 * i);
        if (2 * i + 1 < cnt) {
          uint32_t r[8];
          mt_load<T>(r, flat, off + base + 2 * i + 1, sm, cur, 2 * i + 1);
          merkle_inner(st, l, r);
        } else {  // the level's odd trailing node: promoted
          UNROLL
          for (int j = 0; j < 8; j++) st[j] = l[j];
        }
        if (keep) {
          UNROLL
          for (int j = 0; j < 8; j++) sm.w[nxt][i][j] = st[j];
        }
        sha256_store(flat + (size_t)(out + base / 2 + i) * 32, st);
      }
    }
    MT_SYNC();
    cur = keep ? nxt : -1;
    off = out;
    size = (size + 1) / 2;
    base /= 2;
    span = (span + 1) / 2;
  }
}

// Stage 1 of block b: its subtree, log2(2T) levels or the whole tree.
template <int T>
DEV void mt_stage1(uint8_t* flat, int n, int b, MtShared<T>& sm) {
  const int depth = mt_depth(n), l1 = mt_log2<2 * T>::v;
  mt_levels<T>(flat, n, 0, depth < l1 ? depth : l1, 0, b * 2 * T, 2 * T, sm);
}

// Stage 2: the levels above the subtree roots (a tree of > 2T leaves).
template <int T>
DEV void mt_stage2(uint8_t* flat, int n, MtShared<T>& sm) {
  const int l1 = mt_log2<2 * T>::v;
  const int roots = (int)(((long long)n + 2 * T - 1) / (2 * T));
  mt_levels<T>(flat, n, l1, mt_depth(n), mt_offset(n, l1), 0, roots, sm);
}

#ifndef __CUDACC__
// The host build of a launch: stage 1 of every block, then stage 2.
template <int T>
static void k8_host(uint8_t* flat, int n) {
  if (n <= 1) return;
  static MtShared<T> sm;
  const int blocks = (int)(((long long)n + 2 * T - 1) / (2 * T));
  for (int b = 0; b < blocks; b++) mt_stage1<T>(flat, n, b, sm);
  if (blocks > 1) mt_stage2<T>(flat, n, sm);
}
#endif
