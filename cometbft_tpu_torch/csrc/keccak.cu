// K10: batched Keccak-256.
//
// K10 k10_keccak256_blocks replaces cometbft_tpu/ops/keccak.py:144
// keccak256_blocks: a pair of neighbouring threads runs one row's active
// Keccak-f[1600] permutations over its 136-byte padded blocks, each
// thread holding one 32-bit word of each of the 25 state lanes and
// taking its partner's word by a shuffle where a lane is rotated (the
// row body in keccak_group.cuh; the TPU version held each lane as two
// uint32 halves of one row and ran the 24 rounds in a fori_loop over
// stacked lanes).  K12 (secp.cu) keeps the one-thread permutation of
// keccak.cuh.
//
// Bound on this card: operations — 7,474 32-bit operations per block
// (keccak.cuh) against 136 bytes read.  A row's chain of integer
// instructions sets the time at a few thousand rows (a warp on a
// scheduler), so two threads a row halve the chain each thread issues
// and double the warps; K10_THREADS threads a block spread 4,096 rows
// over 128 SMs.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "keccak_group.cuh"

#define K10_THREADS 64  // threads of a K10 block: 32 rows

__global__ void __launch_bounds__(K10_THREADS)
    k10_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ active,
               uint32_t* __restrict__ digest, int n, int nblocks) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = g >> 1, t = g & 1;
  // threads past the last row take every shuffle of their warp, on the
  // last row's blocks, and store nothing
  int act = v < n ? LDG(active + v) : 0;
  act = act < 0 ? 0 : act > nblocks ? nblocks : act;
  const int nrun = (int)__reduce_max_sync(0xffffffffu, (unsigned)act);
  uint32_t dig[KG_GL][4];
  keccak_pair_row(dig, blocks + (size_t)(v < n ? v : n - 1) * nblocks * KECCAK_RATE, act, nrun, t);
  if (v < n) {
    UNROLL
    for (int i = 0; i < 4; i++) digest[(size_t)v * 8 + 2 * i + t] = dig[0][i];
  }
}

// blocks: n x nblocks x 136 bytes (8-byte aligned), nblocks >= 1 (the
// first block is read whatever the counts; launch_k10 zeroes the digests
// of rows of no blocks itself); active: n int32; digest: n x 32 bytes
// (8-byte aligned).
extern "C" int k10_keccak256_blocks(const void* blocks, const void* active,
                                    void* digest, int n, int nblocks,
                                    void* stream) {
  if (nblocks < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const long long threads = 2ll * n;
    k10_kernel<<<(unsigned)((threads + K10_THREADS - 1) / K10_THREADS), K10_THREADS, 0,
                 (cudaStream_t)stream>>>((const uint8_t*)blocks, (const int32_t*)active,
                                         (uint32_t*)digest, n, nblocks);
  }
  return (int)cudaGetLastError();
}
