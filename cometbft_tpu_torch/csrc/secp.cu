// K11 and K12: batched secp256k1 ECDSA verification.
//
// K11 k11_secp_verify replaces cometbft_tpu/ops/secp256k1.py:861
// verify_batch (manifest rows secp256k1_verify_batch, _recover, _noglv,
// _noglv_recover): one thread per row runs secp_verify_row<GLV, RECOVER>
// (secp256k1.cuh) — range and low-s checks, the on-curve check or the
// ecrecover lift, the scalar inverse, the GLV (or Shamir) walk, the
// affine normalisation and the Cosmos / Ethereum / ecrecover verdict.
//
// K12 k12_secp_hash_verify replaces :996 hash_verify_batch (rows
// secp256k1_hash_verify, _recover): the same row after hashing the row's
// message on the card — Keccak-256 (keccak.cuh) on Ethereum and ecrecover
// rows, SHA-256 (sha256.cuh) on Cosmos rows — and reading the digest as
// the big-endian integer e (:825 _digest_to_limbs).
//
// Differences of route from the TPU program, with identical verdicts:
// the batch-wide Montgomery inversions (:444, a Hillis-Steele prefix
// product across the batch) become per-lane Fermat inversions — an
// inverse mod a prime is unique, so each row's value is the same, and a
// row that would have been sanitised to 1 (s = 0, Z = 0) is decided
// before it reaches an inversion; the one-hot table selects become
// indexed loads; rows that fail validation skip the walk.
//
// Bound on this card: operations — about 3,900 field multiplies and 350
// scalar Montgomery multiplies per valid row against under 300 bytes of
// input (chip_smoke.py counts them per row from the run's data).  What
// this first version does about it: one thread per row, the Q table in
// local memory, the G and phi(G) tables (1 KB) shared through the
// read-only cache, field multiplies and point operations not inlined to
// keep the four instantiations of each kernel quick to build.
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().
#include <cuda_runtime.h>

#include "secp256k1.cuh"
#include "sha256.cuh"

#define SECP_THREADS 32

template <bool GLV, bool RECOVER>
__global__ void k11_kernel(const u32* __restrict__ qx, const u32* __restrict__ qy,
                           const uint8_t* __restrict__ q_valid,
                           const u32* __restrict__ e, const u32* __restrict__ r,
                           const u32* __restrict__ s,
                           const uint8_t* __restrict__ is_eth,
                           const int32_t* __restrict__ v,
                           const uint8_t* __restrict__ is_rec,
                           const uint8_t* __restrict__ addr,
                           const u32* __restrict__ gtab, uint8_t* __restrict__ out,
                           int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  size_t o = (size_t)i * 8;
  u32 a[8], b[8], ee[8], rr[8], ss[8];
  UNROLL
  for (int k = 0; k < 8; k++) {
    a[k] = qx[o + k];
    b[k] = qy[o + k];
    ee[k] = e[o + k];
    rr[k] = r[o + k];
    ss[k] = s[o + k];
  }
  bool ok = secp_verify_row<GLV, RECOVER>(a, b, q_valid[i] != 0, ee, rr, ss,
                                          is_eth[i] != 0, v[i], is_rec[i] != 0,
                                          addr + (size_t)i * 20, gtab);
  out[i] = ok ? 1 : 0;
}

template <bool GLV, bool RECOVER>
__global__ void k12_kernel(const uint8_t* __restrict__ sha_blocks,
                           const int32_t* __restrict__ sha_active, int sha_nb,
                           const uint8_t* __restrict__ kec_blocks,
                           const int32_t* __restrict__ kec_active, int kec_nb,
                           const u32* __restrict__ qx, const u32* __restrict__ qy,
                           const uint8_t* __restrict__ q_valid,
                           const u32* __restrict__ r, const u32* __restrict__ s,
                           const uint8_t* __restrict__ is_eth,
                           const int32_t* __restrict__ v,
                           const uint8_t* __restrict__ is_rec,
                           const uint8_t* __restrict__ addr,
                           const u32* __restrict__ gtab, uint8_t* __restrict__ out,
                           int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool eth = is_eth[i] != 0, rec = is_rec[i] != 0;
  // e = the row's digest read as a big-endian 256-bit integer
  u32 ee[8];
  if (eth || rec) {
    uint64_t st[25];
    keccak256_row_state(st, kec_blocks + (size_t)i * kec_nb * KECCAK_RATE, kec_nb,
                        kec_active[i]);
    UNROLL
    for (int k = 0; k < 8; k++) {
      int m = 7 - k;  // digest bytes 4m..4m+3 are the 32-bit half m & 1 of lane m / 2
      ee[k] = bswap32((u32)(st[m >> 1] >> (32 * (m & 1))));
    }
  } else {
    u32 st[8];
    sha256_init(st);
    const uint8_t* blocks = sha_blocks + (size_t)i * sha_nb * 64;
    int act = sha_active[i];
    NOUNROLL
    for (int bk = 0; bk < sha_nb && bk < act; bk++) {
      const u32* src = (const u32*)(blocks + (size_t)bk * 64);
      u32 w[16];
      UNROLL
      for (int k = 0; k < 16; k++) w[k] = bswap32(LDG(src + k));
      sha256_compress(st, w);
    }
    UNROLL
    for (int k = 0; k < 8; k++) ee[k] = st[7 - k];
  }
  size_t o = (size_t)i * 8;
  u32 a[8], b[8], rr[8], ss[8];
  UNROLL
  for (int k = 0; k < 8; k++) {
    a[k] = qx[o + k];
    b[k] = qy[o + k];
    rr[k] = r[o + k];
    ss[k] = s[o + k];
  }
  bool ok = secp_verify_row<GLV, RECOVER>(a, b, q_valid[i] != 0, ee, rr, ss, eth,
                                          v[i], rec, addr + (size_t)i * 20, gtab);
  out[i] = ok ? 1 : 0;
}

#define K11_ARGS                                                              \
  (const u32*)qx, (const u32*)qy, (const uint8_t*)q_valid, (const u32*)e,     \
      (const u32*)r, (const u32*)s, (const uint8_t*)is_eth, (const int32_t*)v, \
      (const uint8_t*)is_rec, (const uint8_t*)addr, (const u32*)gtab,          \
      (uint8_t*)out, n

// qx, qy, e, r, s: n x 8 little-endian u32 words; q_valid, is_eth, is_rec:
// n bytes (0 / 1); v: n int32; addr: n x 20 bytes; gtab: the 2 x 8 x 2 x 8
// word G / phi(G) table; out: n bytes (1 = valid).
extern "C" int k11_secp_verify(const void* qx, const void* qy, const void* q_valid,
                               const void* e, const void* r, const void* s,
                               const void* is_eth, const void* v, const void* is_rec,
                               const void* addr, const void* gtab, void* out, int n,
                               int glv, int recover, void* stream) {
  if (n > 0) {
    dim3 grid((n + SECP_THREADS - 1) / SECP_THREADS), block(SECP_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (glv && recover) {
      k11_kernel<true, true><<<grid, block, 0, st>>>(K11_ARGS);
    } else if (glv) {
      k11_kernel<true, false><<<grid, block, 0, st>>>(K11_ARGS);
    } else if (recover) {
      k11_kernel<false, true><<<grid, block, 0, st>>>(K11_ARGS);
    } else {
      k11_kernel<false, false><<<grid, block, 0, st>>>(K11_ARGS);
    }
  }
  return (int)cudaGetLastError();
}

#define K12_ARGS                                                                 \
  (const uint8_t*)sha_blocks, (const int32_t*)sha_active, sha_nb,                \
      (const uint8_t*)kec_blocks, (const int32_t*)kec_active, kec_nb,            \
      (const u32*)qx, (const u32*)qy, (const uint8_t*)q_valid, (const u32*)r,    \
      (const u32*)s, (const uint8_t*)is_eth, (const int32_t*)v,                  \
      (const uint8_t*)is_rec, (const uint8_t*)addr, (const u32*)gtab,            \
      (uint8_t*)out, n

// sha_blocks: n x sha_nb x 64 bytes (4-byte aligned) + sha_active n int32;
// kec_blocks: n x kec_nb x 136 bytes (8-byte aligned) + kec_active n int32;
// the rest as k11_secp_verify, without e.
extern "C" int k12_secp_hash_verify(const void* sha_blocks, const void* sha_active,
                                    int sha_nb, const void* kec_blocks,
                                    const void* kec_active, int kec_nb,
                                    const void* qx, const void* qy,
                                    const void* q_valid, const void* r, const void* s,
                                    const void* is_eth, const void* v,
                                    const void* is_rec, const void* addr,
                                    const void* gtab, void* out, int n, int glv,
                                    int recover, void* stream) {
  if (n > 0) {
    dim3 grid((n + SECP_THREADS - 1) / SECP_THREADS), block(SECP_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (glv && recover) {
      k12_kernel<true, true><<<grid, block, 0, st>>>(K12_ARGS);
    } else if (glv) {
      k12_kernel<true, false><<<grid, block, 0, st>>>(K12_ARGS);
    } else if (recover) {
      k12_kernel<false, true><<<grid, block, 0, st>>>(K12_ARGS);
    } else {
      k12_kernel<false, false><<<grid, block, 0, st>>>(K12_ARGS);
    }
  }
  return (int)cudaGetLastError();
}
