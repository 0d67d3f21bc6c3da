// K7, K8 and K9: batched SHA-256 and the RFC-6962 Merkle tree.
//
// K7 k7_sha256_blocks replaces cometbft_tpu/ops/sha2.py:81 sha256_blocks:
// one thread per row runs that row's active compressions on native
// 32-bit words, with the message schedule in a 16-entry ring (the TPU
// version shifted a 16-word window every round inside a fori_loop).
// Bound on this card: operations — 2,296 word operations per block
// against 64 bytes read.  What the design does about it (sha256.cuh
// sha256_row): at 16,384 rows a thread a row is about one warp a
// scheduler, so a row's chain sets the time; each block is read as four
// 16-byte loads issued before the block ahead of it compresses, h + K +
// W is summed off the chain from e to e, and the digest goes out as two
// 16-byte stores.
// blocks and digest must be 16-byte aligned (launch_k7 checks).
//
// K8 k8_merkle_tree replaces cometbft_tpu/ops/merkle.py:47 hash_level
// (with _inner_blocks, :38) over every level of one tree, as :67
// root_from_leaf_hashes loops it: ONE launch a tree writes every level
// above level 0 into the flat node tensor (level 0 first, at the offsets
// of ops/merkle.py level_offsets), so K9 and the proof routes read every
// level.  Stage 1: a block of MERKLE_TREE_THREADS threads reduces its
// span of 2T leaves in shared memory, a thread a pair; stage 2: the last
// block to finish (a ticket counter, reset by that block) reduces the
// subtree roots (merkle_tree.cuh).  Bound: operations (two compressions
// a pair); the chain of ceil(log2 n) levels of two dependent
// compressions sets the time, which the earlier launch a level spent on
// launch latency.
//
// K9 k9_merkle_gather replaces cometbft_tpu/ops/merkle.py:117
// _onehot_gather (an f32 one-hot MXU matmul, a TPU workaround): out[k] =
// flat[coord[k]], 32 zero bytes where coord[k] == -1.  One thread per
// (row, 16-byte half), 16-byte vector loads and stores.  Bound: bytes.
//
// All three launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().
#include <cuda_runtime.h>

#include "merkle_tree.cuh"

#define K7_THREADS 128  // rows of a K7 block

__global__ void __launch_bounds__(K7_THREADS)
    k7_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ active,
              uint8_t* __restrict__ digest, int n, int nblocks) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  sha256_row(digest + (size_t)v * 32, blocks + (size_t)v * nblocks * 64,
             nblocks, active[v]);
}

template <int T>
__global__ void __launch_bounds__(T) k8_kernel(uint8_t* flat, int n, int* counter) {
  __shared__ MtShared<T> sm;
  __shared__ bool last;
  mt_stage1<T>(flat, n, blockIdx.x, sm);
  if (gridDim.x == 1) return;
  __threadfence();  // this block's subtree root before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
    if (last) *counter = 0;  // every ticket drawn: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  mt_stage2<T>(flat, n, sm);
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
    k7_kernel<<<(n + K7_THREADS - 1) / K7_THREADS, K7_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int32_t*)active, (uint8_t*)digest, n,
        nblocks);
  }
  return (int)cudaGetLastError();
}

// flat: the tree's nodes, level 0 filled; counter: one int32, 0 between
// launches (the last block resets it), used by one stream at a time.  A
// one-leaf tree has no level to hash and launches nothing.
extern "C" int k8_merkle_tree(void* flat, int n, void* counter, void* stream) {
  if (n > 1) {
    const int T = MERKLE_TREE_THREADS, blocks = (int)(((long long)n + 2 * T - 1) / (2 * T));
    k8_kernel<T><<<blocks, T, 0, (cudaStream_t)stream>>>((uint8_t*)flat, n, (int*)counter);
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
