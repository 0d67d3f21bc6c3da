// Per-thread bodies of K1 (payload parse + R||A||M block assembly) and
// K2 (batched SHA-512), shared by the kernels in sha2.cu.
#pragma once

#include "common.cuh"

// x with its bytes reversed (one byte permute on the card)
DEV uint32_t bswap32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, 0, 0x0123);
#else
  return (x >> 24) | ((x >> 8) & 0xff00u) | ((x << 8) & 0xff0000u) | (x << 24);
#endif
}

// K1's body: the 16 bytes [16c, 16c + 16) of one row's SHA-512-padded
// R || A || M blocks (cometbft_tpu ops/sha2.py ram_blocks_from_parts, a
// row of width nblocks * 128):
//   bytes [0, 32) R, [32, 64) A (the cached pubkey), [64, 64 + maxm) the
//   message (payload bytes from 68 on); every byte at or past total =
//   mlen + 64 is zeroed (slab reuse relies on it), 0x80 goes at `total`,
//   and the 128-bit big-endian bit length fills the last 16 bytes of the
//   row's own final block (only its low 32 bits can be nonzero: mlen <
//   2^24).
// A 16-byte chunk lies wholly in R, in A or in the message (32 and 64
// are multiples of 16), and the row's final word is the last word of a
// chunk (nbr * 128 - 4 is 12 mod 16).  Rows whose mlen exceeds maxm take
// zeros past the message and read and write nothing past their own row.

// The row's live bytes and its own block count, decoded once a thread.
DEV void k1_decode(const uint8_t* row, int* total, int* nbr) {
  const int mlen = (int)LDG(row + 64) | ((int)LDG(row + 65) << 8) | ((int)LDG(row + 66) << 16);
  *total = mlen + 64;
  *nbr = (*total + 17 + 127) / 128;
}

// The n bytes at p (none when n <= 0, all four when n >= 4) as a
// little-endian word, the others 0.  p is 4-byte aligned and its four
// bytes lie in the row: the payload, the pubkeys and the width are
// multiples of 4 (launch_k1 checks), so the message, at row offset 68,
// ends on a word.  On the card one 4-byte load.
DEV uint32_t k1_word(const uint8_t* p, int n) {
  if (n <= 0) return 0;
#ifdef __CUDA_ARCH__
  const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(p));
#else
  const uint32_t w = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
#endif
  return n >= 4 ? w : w & ((1u << (8 * n)) - 1u);
}

// Chunk c of the row as four little-endian words o[0..3].
DEV void k1_chunk(uint32_t o[4], const uint8_t* row, const uint8_t* pub, int maxm, int total, int nbr,
                  int c) {
  const int col = 16 * c;
  const uint8_t* src;
  int take = 16;  // bytes of the chunk taken from src
  if (col < 32) {
    src = row + col;
  } else if (col < 64) {
    src = pub + (col - 32);
  } else {
    src = row + col + 4;
    take = (total < 64 + maxm ? total : 64 + maxm) - col;
  }
  UNROLL
  for (int j = 0; j < 4; j++) o[j] = k1_word(src + 4 * j, take - 4 * j);
  const int t = total - col;
  if (t >= 0 && t < 16) o[t >> 2] |= 0x80u << (8 * (t & 3));
  if (col == nbr * 128 - 16) o[3] |= bswap32((uint32_t)total * 8);
}

// One thread of K1: chunk c of row v, written to out_row (the row's
// nblocks * 128 block bytes; on the card one 16-byte store, out_row
// 16-byte aligned), and the row's active block count (0 for a row that
// is not live) by the thread of chunk 0.
DEV void k1_thread(uint8_t* out_row, int32_t* active, const uint8_t* row, const uint8_t* pub, int maxm,
                   int c) {
  int total, nbr;
  k1_decode(row, &total, &nbr);
  uint32_t o[4];
  k1_chunk(o, row, pub, maxm, total, nbr, c);
#ifdef __CUDA_ARCH__
  reinterpret_cast<uint4*>(out_row)[c] = make_uint4(o[0], o[1], o[2], o[3]);
#else
  for (int i = 0; i < 16; i++) out_row[16 * c + i] = (uint8_t)(o[i / 4] >> (8 * (i % 4)));
#endif
  if (c == 0) *active = LDG(row + 67) == 1 ? nbr : 0;
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

// The 128 bytes at p as 32 little-endian words: on the card eight 16-byte
// loads (p 16-byte aligned), on the host byte by byte
DEV void sha512_load(uint32_t c[32], const uint8_t* p) {
#ifdef __CUDA_ARCH__
  UNROLL
  for (int q = 0; q < 8; q++) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
    c[4 * q] = v.x;
    c[4 * q + 1] = v.y;
    c[4 * q + 2] = v.z;
    c[4 * q + 3] = v.w;
  }
#else
  for (int i = 0; i < 32; i++)
    c[i] = (uint32_t)p[4 * i] | ((uint32_t)p[4 * i + 1] << 8) | ((uint32_t)p[4 * i + 2] << 16) |
           ((uint32_t)p[4 * i + 3] << 24);
#endif
}

// One compression of a block given as sha512_load's words: message word i
// is bytes 8i..8i+7 big-endian, two byte-reversed little-endian words.
DEV void sha512_compress(uint64_t st[8], const uint32_t c[32]) {
  uint64_t w[16];
  UNROLL
  for (int i = 0; i < 16; i++) w[i] = ((uint64_t)bswap32(c[2 * i]) << 32) | bswap32(c[2 * i + 1]);
  uint64_t a = st[0], b = st[1], cc = st[2], d = st[3];
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
    // h + K_t + W_t (and d plus it) wait on no word of this round, so
    // from e to the next e run only ch and S1 (in parallel) and two adds
    const uint64_t hk = h + SHA512_K[t] + wt, dhk = d + hk;
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    const uint64_t mj = (a & b) ^ (a & cc) ^ (b & cc);
    const uint64_t t1 = (hk + ch) + S1;
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

// Digest of one row: `active` compressions of its nblocks blocks (the
// state stays frozen past a row's own final block, as in the reference's
// per-row active count; bytes past it are never read), written
// big-endian to out[64]: on the card four 16-byte stores (out 16-byte
// aligned).  Each block's words are loaded before the block ahead of it
// compresses.
DEV void sha512_row(uint8_t out[64], const uint8_t* blocks, int nblocks, int active) {
  uint64_t st[8] = {0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull,
                    0x3c6ef372fe94f82bull, 0xa54ff53a5f1d36f1ull,
                    0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
                    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};
  const int n = active < nblocks ? active : nblocks;
  uint32_t c[32], next[32];
  if (n > 0) sha512_load(next, blocks);
  NOUNROLL
  for (int b = 0; b < n; b++) {
    UNROLL
    for (int i = 0; i < 32; i++) c[i] = next[i];
    if (b + 1 < n) sha512_load(next, blocks + (size_t)(b + 1) * 128);
    sha512_compress(st, c);
  }
  uint32_t o[16];
  UNROLL
  for (int i = 0; i < 8; i++) {
    o[2 * i] = bswap32((uint32_t)(st[i] >> 32));
    o[2 * i + 1] = bswap32((uint32_t)st[i]);
  }
#ifdef __CUDA_ARCH__
  UNROLL
  for (int q = 0; q < 4; q++)
    reinterpret_cast<uint4*>(out)[q] = make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
#else
  for (int i = 0; i < 64; i++) out[i] = (uint8_t)(o[i / 4] >> (8 * (i % 4)));
#endif
}
