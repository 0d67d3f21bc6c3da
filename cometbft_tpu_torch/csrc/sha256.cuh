// SHA-256 for K7 (batched rows) and K8 (RFC-6962 inner nodes,
// merkle_tree.cuh), shared by the kernels in merkle.cu; K12 (secp.cu)
// inlines sha256_compress and sha256_store too.
#pragma once

#include "common.cuh"

DCONST uint32_t SHA256_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

DEV void sha256_init(uint32_t st[8]) {
  st[0] = 0x6a09e667u;
  st[1] = 0xbb67ae85u;
  st[2] = 0x3c6ef372u;
  st[3] = 0xa54ff53au;
  st[4] = 0x510e527fu;
  st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu;
  st[7] = 0x5be0cd19u;
}

DEV uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

DEV uint32_t bswap32(uint32_t x) {
#ifdef __CUDACC__
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

// One compression of the 16 big-endian message words w (overwritten: the
// schedule runs in a 16-entry ring).  Per block: 64 rounds of 26 word
// operations (S1 5, ch 4, t1 4, S0 5, maj 5, t2 1, the two state adds 2)
// and 48 schedule words of 13 (s0 5, s1 5, three adds), plus the 8
// state adds: 2,296 32-bit operations.
DEV void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  UNROLL
  for (int t = 0; t < 64; t++) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      uint32_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
      uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
      w[t & 15] = wt;
    }
    uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + SHA256_K[t] + wt;
    uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + mj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// The 8 state words as 32 big-endian bytes.
DEV void sha256_store(uint8_t out[32], const uint32_t st[8]) {
  UNROLL
  for (int i = 0; i < 8; i++) {
    uint32_t x = bswap32(st[i]);
    *(uint32_t*)(out + 4 * i) = x;
  }
}

// K7's row body, with a compression of its own: K8 and K12 inline
// sha256_compress and sha256_store above, and a change to either moves
// how ptxas compiles those kernels.

// The 64 bytes at p as 16 little-endian words: on the card four 16-byte
// loads (p 16-byte aligned), on the host byte by byte.
DEV void sha256_load(uint32_t c[16], const uint8_t* p) {
#ifdef __CUDA_ARCH__
  UNROLL
  for (int q = 0; q < 4; q++) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
    c[4 * q] = v.x;
    c[4 * q + 1] = v.y;
    c[4 * q + 2] = v.z;
    c[4 * q + 3] = v.w;
  }
#else
  for (int i = 0; i < 16; i++)
    c[i] = (uint32_t)p[4 * i] | ((uint32_t)p[4 * i + 1] << 8) | ((uint32_t)p[4 * i + 2] << 16) |
           ((uint32_t)p[4 * i + 3] << 24);
#endif
}

// One compression of a block given as sha256_load's words (message word
// i is bytes 4i..4i+3 big-endian, c[i] byte-reversed).  The same
// operations as sha256_compress, in another order: h + K_t + W_t (and d
// plus it) wait on no word of this round, so from e to the next e run
// only ch and S1 (in parallel) and two adds.
DEV void sha256_compress_row(uint32_t st[8], const uint32_t c[16]) {
  uint32_t w[16];
  UNROLL
  for (int i = 0; i < 16; i++) w[i] = bswap32(c[i]);
  uint32_t a = st[0], b = st[1], cc = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  UNROLL
  for (int t = 0; t < 64; t++) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t hk = h + SHA256_K[t] + wt, dhk = d + hk;
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    const uint32_t mj = (a & b) ^ (a & cc) ^ (b & cc);
    const uint32_t t1 = (hk + ch) + S1;
    h = g;
    g = f;
    f = e;
    e = (dhk + ch) + S1;
    d = cc;
    cc = b;
    b = a;
    a = t1 + (S0 + mj);
  }
  st[0] += a;
  st[1] += b;
  st[2] += cc;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// Digest of one row: `active` compressions of its nblocks 64-byte
// blocks (the state stays frozen past the row's own last block, as in
// the reference's per-row active count; bytes past it are never read),
// written big-endian to out[32]: on the card two 16-byte stores.  Each
// block's words are loaded before the block ahead of it compresses.
// `blocks` and `out` are 16-byte aligned.
DEV void sha256_row(uint8_t out[32], const uint8_t* blocks, int nblocks, int active) {
  uint32_t st[8];
  sha256_init(st);
  const int n = active < nblocks ? active : nblocks;
  uint32_t c[16], next[16];
  if (n > 0) sha256_load(next, blocks);
  NOUNROLL
  for (int b = 0; b < n; b++) {
    UNROLL
    for (int i = 0; i < 16; i++) c[i] = next[i];
    if (b + 1 < n) sha256_load(next, blocks + (size_t)(b + 1) * 64);
    sha256_compress_row(st, c);
  }
  uint32_t o[8];
  UNROLL
  for (int i = 0; i < 8; i++) o[i] = bswap32(st[i]);
#ifdef __CUDA_ARCH__
  reinterpret_cast<uint4*>(out)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(out)[1] = make_uint4(o[4], o[5], o[6], o[7]);
#else
  for (int i = 0; i < 32; i++) out[i] = (uint8_t)(o[i / 4] >> (8 * (i % 4)));
#endif
}

// The RFC-6962 inner node SHA256(0x01 || L || R) of two 32-byte nodes
// given as big-endian words: the 65-byte message is exactly two blocks,
// the second holding R's last byte, 0x80 and the bit length 520.
DEV void merkle_inner(uint32_t st[8], const uint32_t l[8], const uint32_t r[8]) {
  uint32_t w[16];
  w[0] = 0x01000000u | (l[0] >> 8);
  UNROLL
  for (int j = 1; j < 8; j++) w[j] = (l[j - 1] << 24) | (l[j] >> 8);
  w[8] = (l[7] << 24) | (r[0] >> 8);
  UNROLL
  for (int j = 9; j < 16; j++) w[j] = (r[j - 9] << 24) | (r[j - 8] >> 8);
  sha256_init(st);
  sha256_compress(st, w);
  w[0] = (r[7] << 24) | 0x00800000u;
  UNROLL
  for (int j = 1; j < 15; j++) w[j] = 0;
  w[15] = 65 * 8;
  sha256_compress(st, w);
}
