// K1 and K2: the hash half of the comb verify path.
//
// K1 k1_parse_verify_payload replaces cometbft_tpu/ops/sha2.py:355
// parse_verify_payload (with ram_blocks_from_parts, :311): it decodes the
// tight payload rows R(32) | s(32) | mlen(3B LE) | live(1B) | msg(maxm)
// and writes each row's SHA-512-padded R || A || M blocks plus its
// active block count (0 for rows that are not live).  One thread per
// (row, byte column).  Bound on this card: bytes — it reads the payload
// and pubkeys once and writes V * nblocks * 128 bytes, with a few integer
// operations per byte.
//
// K2 k2_sha512_blocks replaces cometbft_tpu/ops/sha2.py:189
// sha512_blocks: one thread per row runs that row's active compressions
// on native 64-bit words (the TPU version emulated each 64-bit word as a
// pair of u32).  Bound: operations — 80 rounds of ~60 64-bit integer
// operations per block against 256 bytes in and 64 out per row.
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().
#include <cuda_runtime.h>

#include "sha2.cuh"

__global__ void k1_kernel(const uint8_t* __restrict__ payload,
                          const uint8_t* __restrict__ pubs,
                          uint8_t* __restrict__ blocks,
                          int32_t* __restrict__ active, int V, int width,
                          int nblocks) {
  int row_bytes = nblocks * 128;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)V * row_bytes) return;
  int v = (int)(idx / row_bytes);
  int col = (int)(idx % row_bytes);
  const uint8_t* row = payload + (size_t)v * width;
  int nbr;
  blocks[idx] = k1_block_byte(row, pubs + (size_t)v * 32, width - 68, col, &nbr);
  if (col == 0) active[v] = row[67] == 1 ? nbr : 0;
}

__global__ void k2_kernel(const uint8_t* __restrict__ blocks,
                          const int32_t* __restrict__ active,
                          uint8_t* __restrict__ digest, int V, int nblocks) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  sha512_row(digest + (size_t)v * 64, blocks + (size_t)v * nblocks * 128,
             nblocks, active[v]);
}

extern "C" int k1_parse_verify_payload(const void* payload, const void* pubs,
                                       void* blocks, void* active, int V,
                                       int width, int nblocks, void* stream) {
  long long n = (long long)V * nblocks * 128;
  if (n > 0) {
    int threads = 256;
    unsigned grid = (unsigned)((n + threads - 1) / threads);
    k1_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)payload, (const uint8_t*)pubs, (uint8_t*)blocks,
        (int32_t*)active, V, width, nblocks);
  }
  return (int)cudaGetLastError();
}

extern "C" int k2_sha512_blocks(const void* blocks, const void* active,
                                void* digest, int V, int nblocks,
                                void* stream) {
  if (V > 0) {
    int threads = 64;
    k2_kernel<<<(V + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int32_t*)active, (uint8_t*)digest, V,
        nblocks);
  }
  return (int)cudaGetLastError();
}
