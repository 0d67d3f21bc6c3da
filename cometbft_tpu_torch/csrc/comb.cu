// K3 and K4: the comb half of the verify path.
//
// K3 k3_build_a_tables replaces cometbft_tpu/ops/comb.py:74
// build_a_tables: per validator, ZIP-215 decompression of the pubkey
// (invalid keys build from the identity with valid = 0), negation, the
// 64-position x 8-entry chain of (j * 16^i) * (-A), and normalisation to
// canonical affine Niels with ONE batch inversion per validator.  One
// thread per validator; the table slots double as the chain's scratch
// and `scratch` (V x 512 x 8 words) holds the running Z products.
// Bound on this card: operations — about 10,000 field multiplies (1M
// 32x32->64 products) per validator against 49 KB written.
//
// K4 k4_verify_cached replaces cometbft_tpu/ops/comb.py:484
// verify_cached (both accumulation orders, :572 and :527) and the
// packbits / all-ok epilogue of cometbft_tpu/models/comb_verifier.py:767
// _device_verify.  The TPU's f32 one-hot MXU select becomes a direct
// indexed load.  Bound on this card: operations — per lane R's
// decompression (~270 field multiplies), 86 mixed adds of 7, the -R add
// of 9 and three doublings of 8 (905 multiplies, chip_smoke.py
// FIELD_MULS_PER_VERIFY) against ~8 KB of table reads.  This design
// spends 923: its fold adds COMB_T - 1 = 3 full adds where the function
// needs the one -R add.
// The first design ran one thread a lane through all ~900 multiplies as
// one dependent chain: 10,000 lanes filled ~0.6 warps a scheduler and
// the chain's latency set the time.  This design (comb_verify.cuh) gives
// a lane COMB_T = 4 threads in four warps of a 128-thread block: warp 0
// decompresses R for the block's 32 lanes while warps 1-3 add disjoint
// shares of the 86 table positions, and the partial sums meet in two
// rounds through shared memory (the JAX tree's fold, :572, on a lane's
// threads).  10,000 lanes fill ~2.4 warps a scheduler, the longest chain
// is R's ~300 multiplies, and no warp runs two paths one after the
// other.  The epilogue packs (ok & live) of a block's 32 lanes in
// numpy.packbits order (lane 0 is bit 7 of byte 0) into four bytes,
// counts rows with !(ok | !live) with the block's barrier count and one
// atomic, and the last block to finish writes the all-ok byte.
#include <cuda_runtime.h>

#include "comb_verify.cuh"

__global__ void k3_kernel(const uint8_t* __restrict__ pubs,
                          uint32_t* __restrict__ tables,
                          uint8_t* __restrict__ valid,
                          uint32_t* __restrict__ scratch, int V) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  bool ok = comb_build_lane(pubs + (size_t)v * 32,
                            tables + (size_t)v * COMB_A_WORDS,
                            scratch + (size_t)v * COMB_NPOS_A * COMB_NENT_A * 8);
  valid[v] = ok ? 1 : 0;
}

__global__ void __launch_bounds__(COMB_BLOCK, COMB_MIN_BLOCKS)
    k4_kernel(const __grid_constant__ K4In in) {
  __shared__ CombShared sm;
  __shared__ uint8_t okl[COMB_LANES];
  comb_grp g;
  g.t = threadIdx.x / COMB_LANES;  // the warp
  const int j = threadIdx.x % COMB_LANES;
  const int v = blockIdx.x * COMB_LANES + j;
  const bool in_range = v < in.V;
  const bool ok = comb_group_verify(in, v, in_range, g, sm, j);
  const bool live = in_range && in.payload[(size_t)v * in.width + 67] == 1;
  if (g.t == 0) okl[j] = ok && live;
  const int bad = __syncthreads_count(g.t == 0 && in_range && !(ok || !live));
  const int nbytes = (in.V + 7) / 8;
  const int byte = blockIdx.x * (COMB_LANES / 8) + threadIdx.x;
  if (threadIdx.x < COMB_LANES / 8 && byte < nbytes) in.out[byte] = comb_pack_byte(okl, threadIdx.x);
  if (threadIdx.x == 0) {
    if (bad) atomicAdd(&in.counters[0], bad);
    __threadfence();
    const int done = atomicAdd(&in.counters[1], 1);
    if (done == (int)gridDim.x - 1) in.out[nbytes] = atomicAdd(&in.counters[0], 0) == 0 ? 1 : 0;
  }
}

extern "C" int k3_build_a_tables(const void* pubs, void* tables, void* valid,
                                 void* scratch, int V, void* stream) {
  if (V > 0) {
    int threads = 64;
    k3_kernel<<<(V + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pubs, (uint32_t*)tables, (uint8_t*)valid,
        (uint32_t*)scratch, V);
  }
  return (int)cudaGetLastError();
}

// counters: 2 x int32 device scratch, zeroed here on the stream.
extern "C" int k4_verify_cached(const void* tables, const void* valid,
                                const void* payload, int width,
                                const void* digest, const void* btab,
                                void* counters, void* out, int V,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (V > 0) {
    const K4In in = {(const uint32_t*)tables, (const uint8_t*)valid, (const uint8_t*)payload,
                     width, (const uint8_t*)digest, (const uint32_t*)btab, (int*)counters,
                     (uint8_t*)out, V};
    k4_kernel<<<(V + COMB_LANES - 1) / COMB_LANES, COMB_BLOCK, 0, s>>>(in);
  }
  return (int)cudaGetLastError();
}
