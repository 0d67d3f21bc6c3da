// K7, K8 and K9: batched SHA-256 and the RFC-6962 Merkle tree.
//
// K7 k7_sha256_blocks replaces cometbft_tpu/ops/sha2.py:81 sha256_blocks:
// one thread per row runs that row's active compressions on native
// 32-bit words, with the message schedule in a 16-entry ring (the TPU
// version shifted a 16-word window every round inside a fori_loop).
// Bound on this card: operations — 2,296 word operations per block
// against 64 bytes read.
//
// K8 k8_merkle_level replaces cometbft_tpu/ops/merkle.py:47 hash_level
// (with _inner_blocks, :38): one thread per output node of one level.  It
// reads the pair (2i, 2i + 1) of level l from the flat node tensor (every
// level, level 0 first, at the offsets of crypto/merkle.multiproof_plan),
// builds 0x01 || L || R and its padding as two blocks of words in
// registers, and writes the digest into level l + 1 of the same tensor;
// the thread of an odd trailing node copies it unchanged.  One launch per
// level.  Bound: operations (two compressions per pair) — but the upper
// levels hold a few nodes each, so a tree's 14 launches are bound by
// launch latency on this card.
//
// K9 k9_merkle_gather replaces cometbft_tpu/ops/merkle.py:117
// _onehot_gather (an f32 one-hot MXU matmul, a TPU workaround): out[k] =
// flat[coord[k]], 32 zero bytes where coord[k] == -1.  One thread per
// (row, 16-byte half), 16-byte vector loads and stores.  Bound: bytes.
//
// All three launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().
#include <cuda_runtime.h>

#include "sha256.cuh"

__global__ void k7_kernel(const uint8_t* __restrict__ blocks,
                          const int32_t* __restrict__ active,
                          uint8_t* __restrict__ digest, int n, int nblocks) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  sha256_row(digest + (size_t)v * 32, blocks + (size_t)v * nblocks * 64,
             nblocks, active[v]);
}

__global__ void k8_kernel(uint8_t* __restrict__ flat, int in_off, int n,
                          int out_off) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (n + 1) / 2) return;
  merkle_level_node(flat + ((size_t)out_off + i) * 32,
                    flat + (size_t)in_off * 32, n, i);
}

__global__ void k9_kernel(const uint4* __restrict__ flat,
                          const int32_t* __restrict__ coord,
                          uint4* __restrict__ out, int k, int nnodes) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * k) return;
  int c = coord[idx >> 1];
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  // coordinates come from the host plan, which refuses any outside
  // [-1, nnodes); the check keeps a bad one from reading out of bounds
  if (c >= 0 && c < nnodes) v = __ldg(flat + 2 * (size_t)c + (idx & 1));
  out[idx] = v;
}

extern "C" int k7_sha256_blocks(const void* blocks, const void* active,
                                void* digest, int n, int nblocks,
                                void* stream) {
  if (n > 0) {
    int threads = 128;
    k7_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int32_t*)active, (uint8_t*)digest, n,
        nblocks);
  }
  return (int)cudaGetLastError();
}

extern "C" int k8_merkle_level(void* flat, int in_off, int n, int out_off,
                               void* stream) {
  int m = (n + 1) / 2;
  if (n > 1) {
    int threads = 128;
    k8_kernel<<<(m + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (uint8_t*)flat, in_off, n, out_off);
  }
  return (int)cudaGetLastError();
}

extern "C" int k9_merkle_gather(const void* flat, const void* coord, void* out,
                                int k, int nnodes, void* stream) {
  if (k > 0) {
    int threads = 256;
    int total = 2 * k;
    k9_kernel<<<(total + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const uint4*)flat, (const int32_t*)coord, (uint4*)out, k, nnodes);
  }
  return (int)cudaGetLastError();
}
