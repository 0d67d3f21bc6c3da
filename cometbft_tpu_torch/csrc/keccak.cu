// K10: batched Keccak-256.
//
// K10 k10_keccak256_blocks replaces cometbft_tpu/ops/keccak.py:144
// keccak256_blocks: one thread per row runs that row's active
// Keccak-f[1600] permutations over its 136-byte padded blocks, with the 25
// state lanes as native 64-bit integers in registers (the TPU version
// held each lane as two uint32 halves and ran the 24 rounds in a
// fori_loop over stacked lanes).  The permutation lives in keccak.cuh,
// shared with the fused secp kernel K12 (secp.cu).
//
// Bound on this card: operations — 7,474 32-bit operations per block
// (keccak.cuh) against 136 bytes read.  What this first version does
// about it: nothing beyond keeping the state in registers; one row per
// thread, so a batch of a few thousand rows fills a fraction of the card.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "keccak.cuh"

__global__ void k10_kernel(const uint8_t* __restrict__ blocks,
                           const int32_t* __restrict__ active,
                           uint64_t* __restrict__ digest, int n, int nblocks) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  uint64_t a[25];
  keccak256_row_state(a, blocks + (size_t)v * nblocks * KECCAK_RATE, nblocks,
                      active[v]);
  UNROLL
  for (int i = 0; i < 4; i++) digest[(size_t)v * 4 + i] = a[i];
}

// blocks: n x nblocks x 136 bytes (8-byte aligned); active: n int32;
// digest: n x 32 bytes (8-byte aligned).
extern "C" int k10_keccak256_blocks(const void* blocks, const void* active,
                                    void* digest, int n, int nblocks,
                                    void* stream) {
  if (n > 0) {
    int threads = 128;
    k10_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int32_t*)active, (uint64_t*)digest, n,
        nblocks);
  }
  return (int)cudaGetLastError();
}
