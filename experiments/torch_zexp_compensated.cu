// The earlier design of csrc/z_expectations_f32.cu (compensated float32 sums,
// two launches per call), kept unchanged below this note so that
// experiments/torch_zexp_probe.py can build and time it beside the current
// kernel on the same card.  Not part of the package; its C interface differs
// from the current one (float32 signs, an (rb, 2, n, T) scratch).
//
// Per-site <Sz>(t) of a block of states, out[j][t] = sum_d signs[j][d] * |psi[d][t]|^2,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel quantumsimulations_tpu/ops/pallas_kernels.py
// `_zexp_kernel` (driven by `z_expectations_f32`).  The contract is that
// function's: p2 = re*re + im*im is formed in the planes' own type (float32 or
// float64) and rounded to float32; the signs are float32; the product is summed
// in float32 (on the CUDA cores, no TF32), as the TPU kernel's f32 dot at
// Precision.HIGHEST, compensated (see Accuracy below).  The TPU wrapper's padding of T to 128 and n to 8 is its
// layout, not the function's, and is dropped: the kernel masks a ragged T.
//
// Bound.  The function reads each (d, t) of both planes once and the sign
// table once, 2*dim*T*itemsize + 4*n*dim bytes, and does about (2n + 3)*dim*T
// operations: 2-4 operations per byte (float64 or float32 planes, n = 14),
// far under the card's 20 (67 TFLOP/s float32 over 3.35 TB/s), so it is bound
// by HBM bandwidth.  At the global Chebyshev route's
// shape (n 14, dim 16384, T 21, float64) that is 6.4 MB, ~2 us: launch latency
// dominates there.
//
// Design.  The TPU kernel is one whole-array MXU dot in VMEM.  Here a block of
// 32 x 8 threads owns 32 columns t and one slice of the rows d: each of its 8
// warps walks every 8th row of the slice, the 32 lanes of a warp reading 32
// neighbouring columns of one row (coalesced), and keeps the n <= 16 site sums
// of its column in registers.  The sign rows of each 64-row tile are staged in
// shared memory.  The 8 warps' sums are added through shared memory.  When
// T is small (the route's T is 21) one column tile would leave the card idle,
// so the rows are also split over `row_blocks` blocks; each writes its partial
// sums to a scratch buffer and a second small kernel adds them (a second pass,
// no atomics, so the order of the sums is fixed and the result deterministic).
//
// Accuracy.  A site's sum is the difference of two large halves (the basis
// states with the site up and down), so a plain float32 sum over dim rows
// loses about sqrt(dim) float32 roundings of the halves' size against a small
// result: ~6e-6 of the largest output at dim 16384 on random planes, ~2e-5 at
// 65536, too close to or over the 1e-5 the reference's test allows.  So every
// sum is carried as an unevaluated pair (hi, lo) of float32s: each product's
// rounding error comes from an fmaf (TwoProduct), each addition's from TwoSum,
// and both go into lo; pairs merge the same way across warps and blocks, and
// the result is hi + lo rounded once.  All float32 operations, about 10 per
// site and row (140 per (d, t) at n = 14): 9 per byte of float64 planes, 17
// of float32 ones, still under the card's 20.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;        // columns per block (lanes of a warp)
constexpr int WARPS = 8;      // row slices per block
constexpr int TILE = 64;      // rows per staged sign tile
constexpr int MAX_SITES = 16;

// re*re + im*im rounded after each operation (no fused multiply-add), as the
// plain version and the reference form it, then rounded to float32
__device__ __forceinline__ float square_sum(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}
__device__ __forceinline__ float square_sum(double a, double b) {
  return static_cast<float>(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)));
}

// (hi, lo) += x exactly up to lo's own rounding (TwoSum)
__device__ __forceinline__ void pair_add(float& hi, float& lo, float x) {
  const float s = __fadd_rn(hi, x);
  const float bp = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bp)), __fsub_rn(x, bp));
  hi = s;
  lo = __fadd_rn(lo, e);
}

// (hi, lo) += sign * p2, the product's rounding error kept too (TwoProduct)
__device__ __forceinline__ void pair_fma(float& hi, float& lo, float sign, float p2) {
  const float prod = __fmul_rn(sign, p2);
  const float err = fmaf(sign, p2, -prod);
  pair_add(hi, lo, prod);
  lo = __fadd_rn(lo, err);
}

// (hi, lo) += (hi2, lo2)
__device__ __forceinline__ void pair_merge(float& hi, float& lo, float hi2, float lo2) {
  pair_add(hi, lo, hi2);
  lo = __fadd_rn(lo, lo2);
}

template <typename Real>
__global__ void __launch_bounds__(TW * WARPS)
zexp_kernel(const Real* __restrict__ re, const Real* __restrict__ im,
            const float* __restrict__ signs, float* __restrict__ part, int n, int dim, int T,
            int rows_per_block) {
  __shared__ float s_sign[MAX_SITES][TILE];
  __shared__ float s_hi[WARPS][MAX_SITES][TW];
  __shared__ float s_lo[WARPS][MAX_SITES][TW];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * TW + lane;
  const int t = blockIdx.x * TW + lane;
  const int d0 = blockIdx.y * rows_per_block;
  const int d1 = min(dim, d0 + rows_per_block);

  float hi[MAX_SITES], lo[MAX_SITES];
#pragma unroll
  for (int j = 0; j < MAX_SITES; ++j) hi[j] = lo[j] = 0.0f;

  for (int base = d0; base < d1; base += TILE) {
    const int rows = min(TILE, d1 - base);
    for (int i = tid; i < n * TILE; i += TW * WARPS) {
      const int j = i / TILE, r = i % TILE;
      s_sign[j][r] = r < rows ? signs[static_cast<size_t>(j) * dim + base + r] : 0.0f;
    }
    __syncthreads();
    if (t < T) {
      for (int r = w; r < rows; r += WARPS) {
        const size_t off = static_cast<size_t>(base + r) * T + t;
        const float p2 = square_sum(re[off], im[off]);
#pragma unroll
        for (int j = 0; j < MAX_SITES; ++j)
          if (j < n) pair_fma(hi[j], lo[j], s_sign[j][r], p2);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < MAX_SITES; ++j) {
    if (j < n) {
      s_hi[w][j][lane] = hi[j];
      s_lo[w][j][lane] = lo[j];
    }
  }
  __syncthreads();
  // warp 0's lanes merge the 8 slices of their column, site by site; one row
  // block writes the result, several write their pairs for zexp_reduce
  if (w == 0 && t < T) {
    const size_t nT = static_cast<size_t>(n) * T;
    for (int j = 0; j < n; ++j) {
      float h = 0.0f, l = 0.0f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) pair_merge(h, l, s_hi[k][j][lane], s_lo[k][j][lane]);
      const size_t o = static_cast<size_t>(j) * T + t;
      if (gridDim.y == 1) {
        part[o] = __fadd_rn(h, l);
      } else {
        part[2 * nT * blockIdx.y + o] = h;
        part[2 * nT * blockIdx.y + nT + o] = l;
      }
    }
  }
}

// out[j][t] = the merge over the row blocks b, in order, of their (hi, lo)
// pairs part[b][0][j][t], part[b][1][j][t], rounded once
__global__ void zexp_reduce(const float* __restrict__ part, float* __restrict__ out, int nT,
                            int row_blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nT) return;
  float h = 0.0f, l = 0.0f;
  for (int b = 0; b < row_blocks; ++b) {
    const size_t o = 2 * static_cast<size_t>(nT) * b + i;
    pair_merge(h, l, part[o], part[o + nT]);
  }
  out[i] = __fadd_rn(h, l);
}

template <typename Real>
int launch(const Real* re, const Real* im, const float* signs, float* out, float* scratch, int n,
           int dim, int T, int row_blocks, cudaStream_t stream) {
  const int rows_per_block = (dim + row_blocks - 1) / row_blocks;
  const dim3 grid((T + TW - 1) / TW, row_blocks);
  float* part = row_blocks > 1 ? scratch : out;
  zexp_kernel<Real><<<grid, dim3(TW, WARPS), 0, stream>>>(re, im, signs, part, n, dim, T,
                                                          rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || row_blocks == 1) return static_cast<int>(err);
  const int nT = n * T;
  zexp_reduce<<<(nT + 255) / 256, 256, 0, stream>>>(scratch, out, nT, row_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes.  re, im: (dim, T) contiguous planes of float32
// (is_double = 0) or float64 (is_double = 1); signs: (n, dim) contiguous
// float32; out: (n, T) contiguous float32, fully written; scratch: (row_blocks,
// 2, n, T) float32 (each block's hi and lo planes), used only when
// row_blocks > 1 (may be null otherwise).
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int qst_z_expectations_f32(const void* re, const void* im, const float* signs,
                                      float* out, float* scratch, int n, int dim, int T,
                                      int row_blocks, int is_double, void* stream) {
  if (n < 1 || n > MAX_SITES || dim < 1 || T < 1 || row_blocks < 1 || row_blocks > dim ||
      row_blocks > 65535 || (row_blocks > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(static_cast<const double*>(re), static_cast<const double*>(im), signs,
                          out, scratch, n, dim, T, row_blocks, st);
  return launch<float>(static_cast<const float*>(re), static_cast<const float*>(im), signs, out,
                       scratch, n, dim, T, row_blocks, st);
}
