// K11 and K12: batched secp256k1 ECDSA verification.
//
// K11 k11_secp_verify replaces cometbft_tpu/ops/secp256k1.py:861
// verify_batch (manifest rows secp256k1_verify_batch, _recover, _noglv,
// _noglv_recover): range and low-s checks, the on-curve check or the
// ecrecover lift, the scalar inverse, the GLV (or Shamir) walk, the
// affine normalisation and the Cosmos / Ethereum / ecrecover verdict of
// each row (secp_block in secp256k1.cuh).
//
// K12 k12_secp_hash_verify replaces :996 hash_verify_batch (rows
// secp256k1_hash_verify, _recover): the same rows after hashing each
// row's message on the card — Keccak-256 (keccak.cuh) on Ethereum and
// ecrecover rows, SHA-256 (sha256.cuh) on Cosmos rows — and reading the
// digest as the big-endian integer e (:825 _digest_to_limbs).
//
// Bound on this card: operations — about 2,900 field multiplies per
// valid GLV row against under 300 bytes of input (chip_smoke.py counts
// the first design's work per row from the run's data).  The first design
// ran one thread a row: 4,096 rows filled 0.24 warps a scheduler, and a
// row's chain of ~2,900 dependent multiplies went through ~2 KB of stack.
// What this design does about it:
//   1. Several threads per row.  A group of SECP_T = 4 threads holds a
//      row; lane t runs the t-th GLV sub-walk (a1 G, a2 phi(G), b1 Q,
//      b2 phi(Q): 33 windows of 4 doublings and a mixed add each), then
//      two rounds of shuffles add the four partial points.  4,096 rows are
//      512 warps, ~1 a scheduler, and a thread's chain is ~1,300
//      multiplies instead of ~2,900.  (Spreading each field element over
//      8 lanes instead, a multiply exchanging words by shuffles, was
//      correct but 3x slower than the first design on the card: ~30
//      dependent shuffles and ballots a multiply.)  The
//      Shamir witness runs u1 G on lane 0 and u2 Q on lane 1.
//   2. The chain in registers.  The walk's field and point operations
//      are inlined; each lane's digits are shifted out of five words a
//      window; the row's table of j Q lives in shared memory: no table on
//      the stack.  The steps that run once a row, and the doubling that
//      a complete add falls to on equal points, are calls (SECP_ONCE),
//      so that cicc does not optimise them into each of the eight
//      kernels.
//   3. One inversion per block and kind, by Montgomery's trick in shared
//      memory (the JAX program's batch_inverse, :444, per batch): the
//      scalars s (r on ecrecover rows), the tables' Z_8 (whose prefix
//      products give every Z_j^-1) and the walks' final Z.  A row pays
//      three multiplies a value, the block one inversion of each product
//      (a binary GCD; the scalar one on one warp while the first field one
//      runs on another).  Decided rows, and accumulators at infinity,
//      enter as 1.
//   4. The table of j Q is affine after that inversion, so each Q or
//      phi(Q) add is a mixed add (11 multiplies instead of 16).
//   5. Outside the sub-walks (checks, K12's hashing, the scalars, the
//      table, the verdict) the four lanes run the same code on the same
//      words, so nothing needs spreading to the group.
// Differences of route from the TPU program, with identical verdicts:
// the block-wide rather than batch-wide product, inverted by a binary GCD
// rather than a Fermat chain (an inverse mod a prime is unique); the
// one-hot table selects become loads; rows that fail validation skip the
// walk.
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().
#include <cuda_runtime.h>

#include "secp256k1.cuh"

template <bool GLV, bool RECOVER, bool HASH>
__device__ __forceinline__ void secp_kernel_body(const SecpIn& in) {
  __shared__ SecpShared sm;
  const int gid = threadIdx.x / SECP_T;
  grp g;
  g.lane = threadIdx.x & (SECP_T - 1);
  g.mask = ((1u << SECP_T) - 1) << ((threadIdx.x & 31) & ~(SECP_T - 1));
  SecpRow st;
  jac acc;
  secp_block<GLV, RECOVER, HASH>(in, blockIdx.x, sm, gid, st, acc, g);
}

// One block an SM is all a batch fills (4,096 rows are 128 blocks), so
// ptxas may take the registers that four blocks would share: left to aim
// at four, it held the chain to 128 registers and spilled.  The arguments
// are __grid_constant__: the once-a-row calls read them where they lie,
// with no copy on the stack.
template <bool GLV, bool RECOVER>
__global__ void __launch_bounds__(SECP_BLOCK, 1) k11_kernel(const __grid_constant__ SecpIn in) {
  secp_kernel_body<GLV, RECOVER, false>(in);
}

template <bool GLV, bool RECOVER>
__global__ void __launch_bounds__(SECP_BLOCK, 1) k12_kernel(const __grid_constant__ SecpIn in) {
  secp_kernel_body<GLV, RECOVER, true>(in);
}

template <bool K12>
static void secp_launch(const SecpIn& in, int glv, int recover, cudaStream_t st) {
  dim3 grid((in.n + SECP_ROWS - 1) / SECP_ROWS), block(SECP_BLOCK);
  if (glv && recover) {
    if (K12) k12_kernel<true, true><<<grid, block, 0, st>>>(in);
    else k11_kernel<true, true><<<grid, block, 0, st>>>(in);
  } else if (glv) {
    if (K12) k12_kernel<true, false><<<grid, block, 0, st>>>(in);
    else k11_kernel<true, false><<<grid, block, 0, st>>>(in);
  } else if (recover) {
    if (K12) k12_kernel<false, true><<<grid, block, 0, st>>>(in);
    else k11_kernel<false, true><<<grid, block, 0, st>>>(in);
  } else {
    if (K12) k12_kernel<false, false><<<grid, block, 0, st>>>(in);
    else k11_kernel<false, false><<<grid, block, 0, st>>>(in);
  }
}

// qx, qy, e, r, s: n x 8 little-endian u32 words; q_valid, is_eth, is_rec:
// n bytes (0 / 1); v: n int32; addr: n x 20 bytes; gtab: the 2 x 8 x 2 x 8
// word G / phi(G) table; out: n bytes (1 = valid).
extern "C" int k11_secp_verify(const void* qx, const void* qy, const void* q_valid,
                               const void* e, const void* r, const void* s,
                               const void* is_eth, const void* v, const void* is_rec,
                               const void* addr, const void* gtab, void* out, int n,
                               int glv, int recover, void* stream) {
  if (n > 0) {
    const SecpIn in = {(const u32*)qx,      (const u32*)qy,      (const u32*)e,
                       (const u32*)r,       (const u32*)s,       (const u32*)gtab,
                       (const uint8_t*)q_valid, (const uint8_t*)is_eth, (const uint8_t*)is_rec,
                       (const uint8_t*)addr, (const int32_t*)v,  nullptr, nullptr, 0,
                       nullptr,             nullptr,             0,   (uint8_t*)out, n};
    secp_launch<false>(in, glv, recover, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

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
    const SecpIn in = {(const u32*)qx,
                       (const u32*)qy,
                       nullptr,
                       (const u32*)r,
                       (const u32*)s,
                       (const u32*)gtab,
                       (const uint8_t*)q_valid,
                       (const uint8_t*)is_eth,
                       (const uint8_t*)is_rec,
                       (const uint8_t*)addr,
                       (const int32_t*)v,
                       (const uint8_t*)sha_blocks,
                       (const int32_t*)sha_active,
                       sha_nb,
                       (const uint8_t*)kec_blocks,
                       (const int32_t*)kec_active,
                       kec_nb,
                       (uint8_t*)out,
                       n};
    secp_launch<true>(in, glv, recover, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
