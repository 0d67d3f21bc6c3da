// K1 and K2: the hash half of the comb verify path.
//
// K1 k1_parse_verify_payload replaces cometbft_tpu/ops/sha2.py:355
// parse_verify_payload (with ram_blocks_from_parts, :311): it decodes the
// tight payload rows R(32) | s(32) | mlen(3B LE) | live(1B) | msg(maxm)
// and writes each row's SHA-512-padded R || A || M blocks plus its
// active block count (0 for rows that are not live).  Bound on this
// card: bytes — it reads the payload and pubkeys once and writes
// V * nblocks * 128 bytes.  One thread per 16-byte chunk of a row's
// blocks (sha2.cuh k1_thread): a 2-D launch, x the chunks of a row and
// y the rows, so no thread divides; each decodes its row's mlen once,
// builds its chunk in four 32-bit registers and writes it with one
// 16-byte store (blocks must be 16-byte aligned: launch_k1 checks).  The
// source bytes are read as 4-byte words, which needs a width that is a
// multiple of 4 and 4-byte aligned payload and pubkeys (launch_k1
// refuses others; every caller's width is 68 + a multiple of 32): with a
// byte a load K1 took ~10% longer at 10,000 rows in turns (PERF.md,
// PR 15).
//
// K2 k2_sha512_blocks replaces cometbft_tpu/ops/sha2.py:189
// sha512_blocks: one thread per row runs that row's active compressions
// on native 64-bit words (the TPU version emulated each 64-bit word as a
// pair of u32).  Bound: operations — 80 rounds of ~60 64-bit integer
// operations per block against 256 bytes in and 64 out per row.  What
// the design does about it: a row's chain of 80 rounds a block is short
// next to the instructions around it, so each 128-byte block is read as
// eight 16-byte loads (issued while the block before it compresses) and
// the digest written as four 16-byte stores, where a byte a load and a
// store took 128 load instructions a block and 64 stores a row, each of
// a warp's touching a cache line a thread (rows lie nblocks x 128 bytes
// apart); K2_THREADS rows a block spread 10,000 rows over every SM.  blocks and digest must be 16-byte aligned (launch_k2
// checks).
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().
#include <cuda_runtime.h>

#include "sha2.cuh"

#define K1_THREADS 256  // threads of a K1 block: 16 rows of 16 chunks at maxm 128
#define K2_THREADS 64  // rows of a K2 block: 10,000 rows make 157 blocks

__global__ void __launch_bounds__(K1_THREADS)
    k1_kernel(const uint8_t* __restrict__ payload, const uint8_t* __restrict__ pubs,
              uint8_t* __restrict__ blocks, int32_t* __restrict__ active, int V, int width,
              int nblocks) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const int v = blockIdx.x * blockDim.y + threadIdx.y;
  if (v >= V || c >= nblocks * 8) return;
  k1_thread(blocks + (size_t)v * nblocks * 128, active + v, payload + (size_t)v * width,
            pubs + (size_t)v * 32, width - 68, c);
}

__global__ void __launch_bounds__(K2_THREADS)
    k2_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ active,
              uint8_t* __restrict__ digest, int V, int nblocks) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  sha512_row(digest + (size_t)v * 64, blocks + (size_t)v * nblocks * 128,
             nblocks, active[v]);
}

extern "C" int k1_parse_verify_payload(const void* payload, const void* pubs,
                                       void* blocks, void* active, int V,
                                       int width, int nblocks, void* stream) {
  const int chunks = nblocks * 8;  // 16-byte chunks a row
  if (V > 0 && chunks > 0) {
    const int cx = chunks < 32 ? chunks : 32;
    const dim3 block(cx, K1_THREADS / cx);
    const unsigned gy = (unsigned)((chunks + cx - 1) / cx);
    if (gy > 65535u) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((V + block.y - 1) / block.y), gy);
    k1_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)payload, (const uint8_t*)pubs, (uint8_t*)blocks,
        (int32_t*)active, V, width, nblocks);
  }
  return (int)cudaGetLastError();
}

extern "C" int k2_sha512_blocks(const void* blocks, const void* active,
                                void* digest, int V, int nblocks,
                                void* stream) {
  if (V > 0) {
    k2_kernel<<<(V + K2_THREADS - 1) / K2_THREADS, K2_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int32_t*)active, (uint8_t*)digest, V,
        nblocks);
  }
  return (int)cudaGetLastError();
}
