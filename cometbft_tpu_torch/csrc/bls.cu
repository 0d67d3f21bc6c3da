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
// one partial per block; the finishing stage, one block of
// BLS_FINISH threads, folds partial j into lane j mod BLS_FINISH in
// order and sums the lanes in the same tree.  Two launches a call.
//
// K15 k15_bls_validate_aggregate replaces :365 validate_aggregate_g1:
// K13's row body, then K14's tile stage over the rows, a row that did
// not validate entering as the identity; K14's finishing stage completes
// the sum.
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
// operations stay out of line, so the ladder's code stays small; the
// tree's points in shared memory with the coordinate word as the slow
// index (conflict-free loads), tiles of 32 rows so that 10,000 rows
// spread over every SM.
//
// All launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().
#include <cuda_runtime.h>

#include "bls381.cuh"

#define BLS_TILE 32     // rows of one tile-stage block (ops/bls381.py TILE)
#define BLS_FINISH 256  // threads of the finishing stage (ops/bls381.py FINISH)

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

__global__ void __launch_bounds__(BLS_TILE)
    k14_kernel(const u32* __restrict__ X, const u32* __restrict__ Y,
               const u32* __restrict__ Z, u32* __restrict__ partials, int n) {
  __shared__ u32 sm[BLS_PT * BLS_TILE];
  int t = threadIdx.x, i = blockIdx.x * BLS_TILE + t;
  g1p p;
  if (i < n) {
    load_row(p.X, X, i);
    load_row(p.Y, Y, i);
    load_row(p.Z, Z, i);
  } else {
    g1_set_identity(p);
  }
  sm_store(sm, BLS_TILE, t, p);
  __syncthreads();
  sm_tree(sm, BLS_TILE);
  sm_emit(partials + (size_t)blockIdx.x * BLS_PT, sm, BLS_TILE);
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

__global__ void __launch_bounds__(BLS_FINISH)
    k14_finish_kernel(const u32* __restrict__ partials, int g, u32* __restrict__ out) {
  __shared__ u32 sm[BLS_PT * BLS_FINISH];
  int t = threadIdx.x;
  g1p acc, q;
  g1_set_identity(acc);
  for (int j = t; j < g; j += BLS_FINISH) {
    const u32* src = partials + (size_t)j * BLS_PT;
    for (int k = 0; k < BLS_W; k++) {
      q.X[k] = src[k];
      q.Y[k] = src[BLS_W + k];
      q.Z[k] = src[2 * BLS_W + k];
    }
    g1_add(acc, acc, q);
  }
  sm_store(sm, BLS_FINISH, t, acc);
  __syncthreads();
  sm_tree(sm, BLS_FINISH);
  sm_emit(out, sm, BLS_FINISH);
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
    dim3 grid((n + BLS_TILE - 1) / BLS_TILE), block(BLS_TILE);
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
  k14_finish_kernel<<<1, BLS_FINISH, 0, (cudaStream_t)stream>>>((const u32*)partials, g,
                                                               (u32*)out);
  return (int)cudaGetLastError();
}
