// K13, K14 and K15: batched BLS12-381 G1 key validation and pubkey
// aggregation.
//
// K13 k13_bls_validate replaces cometbft_tpu/ops/bls381.py:346
// validate_g1: one thread per row runs bls_validate_row (bls381.cuh) —
// the host decode's mask, on-curve, [r]P = infinity — and writes one
// verdict byte; a failing row clears the all-ok byte.  It launches K15's
// kernel with no partials, which stops before the tile stage, so that
// one compiled copy of the row body serves both: ptxas compiles a copy of
// each out-of-line routine (fe_mul, fe_sq, g1_double, g1_madd) into every
// kernel, and the copies need not match (with 64-bit column sums on the
// card, a kernel of K13's own got an fe_mul of 1,302 SASS instructions
// against K15's 1,047, and took 5.90 ms against 4.45; PERF.md).
//
// K14 k14_bls_aggregate + k14_bls_aggregate_finish replace :273
// aggregate_g1: the tile stage sums each tile of BLS_TILE rows in a
// shared-memory tree (row t + s into row t, s = BLS_TILE / 2, ..., 1) to
// one partial per block; the finishing stage, one block, folds partial j
// into lane j mod BLS_FINISH in order and sums the BLS_FINISH lanes in
// the same tree.  Two launches a call.  Each add of both trees is shared
// by a group of BLS_GROUP threads (bls381_group.cuh: five phases of
// independent multiplies), one group an add of a tree's first level.
//
// K15 k15_bls_validate_aggregate replaces :365 validate_aggregate_g1:
// K13's row body, then a tile tree over the rows of one thread an add
// (g1_add), a row that did not validate entering as the identity; K14's
// finishing stage completes the sum.  K15's tiles keep this tree rather
// than K14's group tree: with bg_tree in the kernel, ptxas compiles the
// kernel body's ladder otherwise (inline: 162 registers and 240 B of
// stack against 166 and 384) and the rows take ~0.09 ms longer, more than
// the group tree saves (~0.04).  In turns on the H100, K15 took 3.58-3.62
// ms with bg_tree inline (also with the body shaped as here, or in a
// kernel instance of its own) and 4.09 with it out of line, against
// 3.53-3.57 with this tree (PERF.md).
//
// Differences of route from the TPU programs, with identical results:
// the ladder starts from acc = P instead of doubling the identity (the
// same point after the leading bit of r); a row that fails before the
// ladder skips it instead of running it on the identity; the tree pairs
// rows (t, t + s) inside tiles instead of (i, i + half) over the batch,
// so the sum's Jacobian coordinates differ from the JAX program's and
// its affine point does not.
//
// Bound on this card: operations — about 3,240 field multiplies of 288
// multiply-adds per valid row in K13 and K15, 16 per add of the tree in
// K14 (chip_smoke.py counts them from the run's data).  What the design
// does about it: one thread per row, whose time is its chain of field
// multiplies at ~2.4 warps an SM; the product-scanning fe_mul and the
// dedicated fe_sq (bls381.cuh) shorten each multiply, and field elements
// pass to them by value, in registers; field multiplies and point
// operations stay out of line, so the ladder's code stays small; K15's
// tree's points in shared memory with the coordinate word as the slow
// index (conflict-free loads), tiles of 32 rows so that 10,000 rows
// spread over every SM.  K14 does not reach its bound: its time is the
// trees' depth (5 levels in a tile, 9 in the finishing stage over 313
// partials) times one add's latency, so a group of threads shares each
// add; K14's points sit at a pitch of 37 words (bank-shifted rows).
//
// All launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().
#include <cuda_runtime.h>

#include "bls381_group.cuh"

#define BLS_TILE 32     // rows of one tile-stage block (ops/bls381.py TILE)
#define BLS_FINISH 256  // lanes of the finishing stage (ops/bls381.py FINISH)
#define BLS_GROUP 4     // threads that share one add of K14's trees (bls381_group.cuh BG_G)
#define BLS_FINISH_GROUPS 128  // groups of the finishing stage: one an add of its first level
static_assert(BLS_GROUP == BG_G, "K14's groups are bls381_group.cuh's");

__device__ __forceinline__ void sm_store(u32* sm, int stride, int t, const g1p& p) {
  for (int k = 0; k < BLS_W; k++) {
    sm[k * stride + t] = p.X[k];
    sm[(BLS_W + k) * stride + t] = p.Y[k];
    sm[(2 * BLS_W + k) * stride + t] = p.Z[k];
  }
}

__device__ __forceinline__ void sm_load(g1p& p, const u32* sm, int stride, int t) {
  for (int k = 0; k < BLS_W; k++) {
    p.X[k] = sm[k * stride + t];
    p.Y[k] = sm[(BLS_W + k) * stride + t];
    p.Z[k] = sm[(2 * BLS_W + k) * stride + t];
  }
}

// The tree over the block's `width` points in sm: point t + s into
// point t, s = width / 2, ..., 1; the sum ends in point 0.
__device__ void sm_tree(u32* sm, int width) {
  int t = threadIdx.x;
  for (int s = width / 2; s > 0; s >>= 1) {
    if (t < s) {
      g1p a, b;
      sm_load(a, sm, width, t);
      sm_load(b, sm, width, t + s);
      g1_add(a, a, b);
      sm_store(sm, width, t, a);
    }
    __syncthreads();
  }
}

// point 0 of sm -> out[0..35] (X, Y, Z words); a tile block has fewer
// threads than words
__device__ __forceinline__ void sm_emit(u32* out, const u32* sm, int width) {
  for (int k = threadIdx.x; k < BLS_PT; k += blockDim.x) out[k] = sm[k * width];
}

__device__ __forceinline__ void load_row(u32 w[BLS_W], const u32* src, int i) {
  for (int k = 0; k < BLS_W; k++) w[k] = src[(size_t)i * BLS_W + k];
}

// K14's tile stage: the tile's rows (the identity past n) into shared
// memory, summed by groups of BLS_GROUP threads (bls381_group.cuh).
__global__ void __launch_bounds__(BLS_TILE / 2 * BLS_GROUP)
    k14_kernel(const u32* __restrict__ X, const u32* __restrict__ Y,
               const u32* __restrict__ Z, u32* __restrict__ partials, int n) {
  __shared__ u32 pts[BLS_TILE * BG_PITCH];
  __shared__ u32 files[BLS_TILE / 2 * BG_FILE];
  for (int w = threadIdx.x; w < BLS_TILE * BLS_PT; w += blockDim.x) {
    const int t = w / BLS_PT, c = w % BLS_PT / BLS_W, k = w % BLS_W, i = blockIdx.x * BLS_TILE + t;
    const u32* src = c == 0 ? X : c == 1 ? Y : Z;
    pts[t * BG_PITCH + c * BLS_W + k] = i < n ? src[(size_t)i * BLS_W + k] : (c < 2 ? BLS_ONE_M[k] : 0u);
  }
  __syncthreads();
  bg_tree(pts, BLS_TILE, files);
  for (int k = threadIdx.x; k < BLS_PT; k += blockDim.x) partials[(size_t)blockIdx.x * BLS_PT + k] = pts[k];
}

__global__ void __launch_bounds__(BLS_TILE)
    k15_kernel(const u32* __restrict__ X, const u32* __restrict__ Y,
               const uint8_t* __restrict__ valid, uint8_t* __restrict__ ok,
               uint8_t* __restrict__ all_ok, u32* __restrict__ partials, int n) {
  __shared__ u32 sm[BLS_PT * BLS_TILE];
  int t = threadIdx.x, i = blockIdx.x * BLS_TILE + t;
  g1p p;
  g1_set_identity(p);
  if (i < n) {
    u32 x[BLS_W], y[BLS_W];
    load_row(x, X, i);
    load_row(y, Y, i);
    bool o = bls_validate_row(x, y, valid[i] != 0);
    ok[i] = o ? 1 : 0;
    if (!o) {
      *all_ok = 0;
    } else {
      fe_copy(p.X, x);
      fe_copy(p.Y, y);
      fe_copy(p.Z, BLS_ONE_M);
    }
  }
  if (partials == nullptr) return;  // K13: the verdicts only
  sm_store(sm, BLS_TILE, t, p);
  __syncthreads();
  sm_tree(sm, BLS_TILE);
  sm_emit(partials + (size_t)blockIdx.x * BLS_PT, sm, BLS_TILE);
}

// K14's finishing stage, one block of BLS_FINISH_GROUPS groups: lane j
// (j < BLS_FINISH) starts as partial j (the identity past g), then adds
// partials j + BLS_FINISH, j + 2 BLS_FINISH, ... in order; the lanes are
// summed in the tree.  Shared memory (dynamic): the lanes' points, then a
// value file a group.
#define BLS_FINISH_THREADS (BLS_FINISH_GROUPS * BLS_GROUP)
#define BLS_FINISH_SMEM ((BLS_FINISH * BG_PITCH + BLS_FINISH_GROUPS * BG_FILE) * 4)

__global__ void __launch_bounds__(BLS_FINISH_THREADS)
    k14_finish_kernel(const u32* __restrict__ partials, int g, u32* __restrict__ out) {
  extern __shared__ u32 dsm[];
  u32 *pts = dsm, *files = dsm + BLS_FINISH * BG_PITCH;
  for (int w = threadIdx.x; w < BLS_FINISH * BLS_PT; w += blockDim.x) {
    const int j = w / BLS_PT, k = w % BLS_PT;
    pts[j * BG_PITCH + k] = j < g ? partials[w] : (k < 2 * BLS_W ? BLS_ONE_M[k % BLS_W] : 0u);
  }
  __syncthreads();
  const int grp = threadIdx.x / BLS_GROUP, tid = threadIdx.x % BLS_GROUP;
  const unsigned mask = bg_mask(threadIdx.x);
  for (int f = BLS_FINISH; f < g; f += BLS_FINISH)
    for (int t = grp; t < BLS_FINISH && t + f < g; t += BLS_FINISH_GROUPS)
      bg_add(pts + t * BG_PITCH, pts + t * BG_PITCH, partials + (size_t)(t + f) * BLS_PT, files + grp * BG_FILE,
             tid, mask);
  __syncthreads();
  bg_tree(pts, BLS_FINISH, files);
  for (int k = threadIdx.x; k < BLS_PT; k += blockDim.x) out[k] = pts[k];
}

// X, Y: n x 12 words (affine, Montgomery); valid: n bytes; ok: n bytes
// (1 = valid); all_ok: one byte the caller set to 1.
extern "C" int k13_bls_validate(const void* X, const void* Y, const void* valid, void* ok,
                                void* all_ok, int n, void* stream) {
  if (n > 0) {
    dim3 grid((n + BLS_TILE - 1) / BLS_TILE), block(BLS_TILE);
    k15_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const u32*)X, (const u32*)Y, (const uint8_t*)valid, (uint8_t*)ok, (uint8_t*)all_ok, nullptr, n);
  }
  return (int)cudaGetLastError();
}

// X, Y, Z: n x 12 words (Jacobian); partials: ceil(n / 32) x 36 words.
extern "C" int k14_bls_aggregate(const void* X, const void* Y, const void* Z, void* partials,
                                 int n, void* stream) {
  if (n > 0) {
    dim3 grid((n + BLS_TILE - 1) / BLS_TILE), block(BLS_TILE / 2 * BLS_GROUP);
    k14_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const u32*)X, (const u32*)Y, (const u32*)Z, (u32*)partials, n);
  }
  return (int)cudaGetLastError();
}

// as k13_bls_validate, plus partials: ceil(n / 32) x 36 words.
extern "C" int k15_bls_validate_aggregate(const void* X, const void* Y, const void* valid,
                                          void* ok, void* all_ok, void* partials, int n,
                                          void* stream) {
  if (n > 0) {
    dim3 grid((n + BLS_TILE - 1) / BLS_TILE), block(BLS_TILE);
    k15_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const u32*)X, (const u32*)Y, (const uint8_t*)valid, (uint8_t*)ok, (uint8_t*)all_ok,
        (u32*)partials, n);
  }
  return (int)cudaGetLastError();
}

// partials: g x 36 words; out: 36 words (X, Y, Z of the sum).
extern "C" int k14_bls_aggregate_finish(const void* partials, int g, void* out, void* stream) {
  // above 48 KB of shared memory a block is only dynamic, by this attribute
  // (a device's own: set on every call, on the caller's current device)
  cudaError_t e = cudaFuncSetAttribute(k14_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       BLS_FINISH_SMEM);
  if (e != cudaSuccess) return (int)e;
  k14_finish_kernel<<<1, BLS_FINISH_THREADS, BLS_FINISH_SMEM, (cudaStream_t)stream>>>((const u32*)partials, g,
                                                                                     (u32*)out);
  return (int)cudaGetLastError();
}
