// Per-thread bodies of K7 (batched SHA-256), K8 (one Merkle tree level)
// and K9 (node gather), shared by the kernels in merkle.cu.
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

// Digest of one row: `active` compressions of its nblocks 64-byte
// blocks (the state stays frozen past the row's own last block, as in
// the reference's per-row active count), written big-endian to out[32].
// `blocks` and `out` are 4-byte aligned.
DEV void sha256_row(uint8_t out[32], const uint8_t* blocks, int nblocks,
                    int active) {
  uint32_t st[8];
  sha256_init(st);
  NOUNROLL
  for (int b = 0; b < nblocks && b < active; b++) {
    const uint32_t* src = (const uint32_t*)(blocks + (size_t)b * 64);
    uint32_t w[16];
    UNROLL
    for (int i = 0; i < 16; i++) w[i] = bswap32(LDG(src + i));
    sha256_compress(st, w);
  }
  sha256_store(out, st);
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

// Output node i of a level of n nodes stored at `in` (32 bytes each,
// 16-byte aligned): the inner hash of nodes 2i and 2i + 1, or node 2i
// unchanged when it is the odd trailing node.
DEV void merkle_level_node(uint8_t out[32], const uint8_t* in, int n, int i) {
  const uint32_t* left = (const uint32_t*)(in + (size_t)(2 * i) * 32);
  if (2 * i + 1 >= n) {
    UNROLL
    for (int k = 0; k < 8; k++) ((uint32_t*)out)[k] = LDG(left + k);
    return;
  }
  uint32_t l[8], r[8], st[8];
  UNROLL
  for (int k = 0; k < 8; k++) {
    l[k] = bswap32(LDG(left + k));
    r[k] = bswap32(LDG(left + 8 + k));
  }
  merkle_inner(st, l, r);
  sha256_store(out, st);
}
