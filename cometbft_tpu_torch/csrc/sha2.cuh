// Per-thread bodies of K1 (payload parse + R||A||M block assembly) and
// K2 (batched SHA-512), shared by the kernels in sha2.cu.
#pragma once

#include "common.cuh"

// One byte of the SHA-512-padded R || A || M blocks of one row
// (cometbft_tpu ops/sha2.py ram_blocks_from_parts, column `col` of a
// row of width nblocks * 128):
//   bytes [0, 32) R, [32, 64) A (the cached pubkey), [64, 64 + maxm) the
//   message; every byte at or past total = mlen + 64 is zeroed (slab
//   reuse relies on it), 0x80 goes at `total`, and the 128-bit
//   big-endian bit length fills the last 16 bytes of the row's own final
//   block (only the low 32 bits can be nonzero: mlen < 2^24).
DEV uint8_t k1_block_byte(const uint8_t* row, const uint8_t* pub, int maxm,
                          int col, int* nbr_out) {
  int mlen = (int)row[64] | ((int)row[65] << 8) | ((int)row[66] << 16);
  int total = mlen + 64;
  uint32_t b = 0;
  if (col < 32) {
    b = row[col];
  } else if (col < 64) {
    b = pub[col - 32];
  } else if (col < 64 + maxm) {
    b = row[68 + col - 64];
  }
  if (col >= total) b = 0;
  if (col == total) b |= 0x80u;
  int nbr = (total + 17 + 127) / 128;
  int shift = (nbr * 128 - 1 - col) * 8;
  if (shift >= 0 && shift < 32) b |= ((uint32_t)(total * 8) >> shift) & 0xffu;
  *nbr_out = nbr;
  return (uint8_t)b;
}

DCONST uint64_t SHA512_K[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full,
    0xe9b5dba58189dbbcull, 0x3956c25bf348b538ull, 0x59f111f1b605d019ull,
    0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull, 0xd807aa98a3030242ull,
    0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull,
    0xc19bf174cf692694ull, 0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull,
    0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull, 0x2de92c6f592b0275ull,
    0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full,
    0xbf597fc7beef0ee4ull, 0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull,
    0x06ca6351e003826full, 0x142929670a0e6e70ull, 0x27b70a8546d22ffcull,
    0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull,
    0x92722c851482353bull, 0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull,
    0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull, 0xd192e819d6ef5218ull,
    0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull,
    0x34b0bcb5e19b48a8ull, 0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull,
    0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull, 0x748f82ee5defb2fcull,
    0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull,
    0xc67178f2e372532bull, 0xca273eceea26619cull, 0xd186b8c721c0c207ull,
    0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull, 0x06f067aa72176fbaull,
    0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull,
    0x431d67c49c100d4cull, 0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull,
    0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull};

DEV uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

DEV void sha512_compress(uint64_t st[8], const uint8_t* blk) {
  uint64_t w[16];
  UNROLL
  for (int i = 0; i < 16; i++) {
    uint64_t x = 0;
    UNROLL
    for (int k = 0; k < 8; k++) x = (x << 8) | blk[8 * i + k];
    w[i] = x;
  }
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
  UNROLL
  for (int t = 0; t < 80; t++) {
    uint64_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      uint64_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
      uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
      uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
      wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
      w[t & 15] = wt;
    }
    uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    uint64_t ch = (e & f) ^ (~e & g);
    uint64_t t1 = h + S1 + ch + SHA512_K[t] + wt;
    uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
    uint64_t t2 = S0 + mj;
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

// Digest of one row: `active` compressions of its nblocks blocks (the
// state stays frozen past a row's own final block, as in the reference's
// per-row active count), written big-endian to out[64].
DEV void sha512_row(uint8_t out[64], const uint8_t* blocks, int nblocks,
                    int active) {
  uint64_t st[8] = {0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull,
                    0x3c6ef372fe94f82bull, 0xa54ff53a5f1d36f1ull,
                    0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
                    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};
  NOUNROLL
  for (int b = 0; b < nblocks && b < active; b++) {
    sha512_compress(st, blocks + (size_t)b * 128);
  }
  UNROLL
  for (int i = 0; i < 8; i++) {
    UNROLL
    for (int k = 0; k < 8; k++) out[8 * i + k] = (uint8_t)(st[i] >> (56 - 8 * k));
  }
}
