// The SIMT design of the ext observable kernel (PRs 6-10), kept so that
// experiments/torch_ext_obs_probe.py can build it and time it beside the
// tensor-core design of quantumsimulations_tpu_torch/csrc/ext_obs_diagonals.cu.
// Same C interface and contract (any dim).  Its text below is unchanged.
//
// Per-site x/y/z and norm^2 sums per limb-pair significance diagonal, straight
// from int8 ext limb planes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel quantumsimulations_tpu/ops/pallas_kernels.py
// `_ext_obs_kernel` (driven by `ext_obs_diagonals_int8`).  Inputs are the
// canonical int8 limb stacks S_re, S_im of a block of states, (L, dim, T)
// with dim = 2^n_sites.  For every limb pair (j, i) with j + i = s < n_diag
// (the full triangle; the wrapper checks the pair tables) and column t, with
// prod = Rj*Ri + Ij*Ii per row (R = S_re, I = S_im limb planes):
//
//   out[s][3n][t]   += sum_rows prod                                (norm^2)
//   out[s][3k+2][t] += sum_a prod[a] - sum_b prod[b]                (z_k)
//   out[s][3k][t]   += sum_a Rj[a]*Ri[b] + Ij[a]*Ii[b]              (x_k)
//   out[s][3k+1][t] += sum_a Rj[a]*Ii[b] - Ij[a]*Ri[b]              (y_k)
//
// where a runs over the level-0 rows of site k (row bit n-1-k clear) and
// b = a + 2^(n-1-k) is its level-1 partner.  Rows 3n+1 .. R-1 are zero.  The
// float64 combine with weights 2^(-5 s) runs outside.  int32 sums are exact in
// any order while dim * 33^2 * n_diag < 2^31 (the wrapper asserts it), so the
// result is bit-identical to the TPU kernel and to the plain PyTorch version.
//
// What the TPU kernel did that Hopper cannot: it walked a sequential grid over
// (column tile, pair), carried each diagonal's sums in the VMEM-resident output
// block from one pair to the next, and re-read two limb planes per pair.
// Hopper blocks run in no order, so here one block owns (one site or the norm,
// 128 columns) and loops over the rows itself, with every diagonal's sums in
// registers: no atomics, no second pass, and each block reads each of the
// n_diag limb planes of R and I once (for a site: the two rows of each level
// pair together).
//
// Bound.  The TPU kernel's cost estimate counts P * dim * T * (6 + 10 n)
// int32 operations (P = 66 pairs) against 2 * n_diag * dim * T bytes of limbs
// read once: about 100 operations per byte, so the work is bound by int32
// operations on the CUDA cores (the tensor cores take no such reductions),
// not by the 3.35 TB/s of HBM.
//
// Design for now: SIMT int32 multiply-adds.  A thread owns one column; per
// level pair of its site it loads the n_diag limbs of R and I at rows a and
// b (one byte each, neighbouring threads on neighbouring columns, so each
// warp load is one 32-byte sector) and updates 3 * n_diag accumulators with
// 8 multiply-adds per limb pair.  The norm block does 2 per limb pair and row.
// Packing limbs four to an int32 for __dp4a is later work.  T need not be a
// multiple of the block width: the last block masks its columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // columns per block
constexpr int MAX_DIAG = 11;  // the JAX package's _EXT_OBS_Q

template <int ND>
__global__ void __launch_bounds__(THREADS)
ext_obs_kernel(const int8_t* __restrict__ s_re, const int8_t* __restrict__ s_im,
               int32_t* __restrict__ out, int dim, int T, int n_sites, int R) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= T) return;
  const int g = blockIdx.y;  // site k in [0, n_sites), or n_sites: the norm
  const size_t plane = static_cast<size_t>(dim) * T;
  const size_t RT = static_cast<size_t>(R) * T;

  if (g == n_sites) {
    int acc[ND];
#pragma unroll
    for (int s = 0; s < ND; ++s) acc[s] = 0;
    for (int r = 0; r < dim; ++r) {
      const size_t off = static_cast<size_t>(r) * T + t;
      int re[ND], im[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        re[j] = s_re[j * plane + off];
        im[j] = s_im[j * plane + off];
      }
#pragma unroll
      for (int s = 0; s < ND; ++s) {
#pragma unroll
        for (int j = 0; j <= s; ++j) acc[s] += re[j] * re[s - j] + im[j] * im[s - j];
      }
    }
#pragma unroll
    for (int s = 0; s < ND; ++s) {
      int32_t* o = out + s * RT + t;
      o[static_cast<size_t>(3 * n_sites) * T] = acc[s];
      for (int row = 3 * n_sites + 1; row < R; ++row) o[static_cast<size_t>(row) * T] = 0;
    }
    return;
  }

  const int shift = n_sites - 1 - g;  // site-g stride: dr = 2^shift
  const int dr = 1 << shift;
  int ax[ND], ay[ND], az[ND];
#pragma unroll
  for (int s = 0; s < ND; ++s) ax[s] = ay[s] = az[s] = 0;
  for (int q = 0; q < dim / 2; ++q) {
    const int a = ((q >> shift) << (shift + 1)) | (q & (dr - 1));  // level-0 row
    const size_t off_a = static_cast<size_t>(a) * T + t;
    const size_t off_b = off_a + static_cast<size_t>(dr) * T;
    int ra[ND], ia[ND], rb[ND], ib[ND];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      ra[j] = s_re[j * plane + off_a];
      ia[j] = s_im[j * plane + off_a];
      rb[j] = s_re[j * plane + off_b];
      ib[j] = s_im[j * plane + off_b];
    }
#pragma unroll
    for (int s = 0; s < ND; ++s) {
#pragma unroll
      for (int j = 0; j <= s; ++j) {
        const int i = s - j;
        ax[s] += ra[j] * rb[i] + ia[j] * ib[i];
        ay[s] += ra[j] * ib[i] - ia[j] * rb[i];
        az[s] += ra[j] * ra[i] + ia[j] * ia[i] - rb[j] * rb[i] - ib[j] * ib[i];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < ND; ++s) {
    int32_t* o = out + s * RT + static_cast<size_t>(3 * g) * T + t;
    o[0] = ax[s];
    o[T] = ay[s];
    o[2 * static_cast<size_t>(T)] = az[s];
  }
}

template <int ND>
int launch(const int8_t* s_re, const int8_t* s_im, int32_t* out, int dim, int T, int n_sites,
           int R, cudaStream_t stream) {
  const dim3 grid((T + THREADS - 1) / THREADS, n_sites + 1);
  ext_obs_kernel<ND><<<grid, THREADS, 0, stream>>>(s_re, s_im, out, dim, T, n_sites, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes.  s_re, s_im: (L, dim, T) contiguous int8 with
// dim = 2^n_sites and L >= n_diag; out: (n_diag, R, T) contiguous int32 with
// R >= 3*n_sites + 1, fully written.  Launches on `stream` and returns
// cudaGetLastError() (0 = ok).
extern "C" int qst_ext_obs_diagonals(const int8_t* s_re, const int8_t* s_im, int32_t* out,
                                     int limbs, int dim, int T, int n_sites, int R, int n_diag,
                                     void* stream) {
  if (n_diag < 1 || n_diag > MAX_DIAG || limbs < n_diag || n_sites < 1 || dim != (1 << n_sites) ||
      R < 3 * n_sites + 1 || T < 1 || n_sites + 1 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_diag) {
    case 1: return launch<1>(s_re, s_im, out, dim, T, n_sites, R, st);
    case 2: return launch<2>(s_re, s_im, out, dim, T, n_sites, R, st);
    case 3: return launch<3>(s_re, s_im, out, dim, T, n_sites, R, st);
    case 4: return launch<4>(s_re, s_im, out, dim, T, n_sites, R, st);
    case 5: return launch<5>(s_re, s_im, out, dim, T, n_sites, R, st);
    case 6: return launch<6>(s_re, s_im, out, dim, T, n_sites, R, st);
    case 7: return launch<7>(s_re, s_im, out, dim, T, n_sites, R, st);
    case 8: return launch<8>(s_re, s_im, out, dim, T, n_sites, R, st);
    case 9: return launch<9>(s_re, s_im, out, dim, T, n_sites, R, st);
    case 10: return launch<10>(s_re, s_im, out, dim, T, n_sites, R, st);
    default: return launch<11>(s_re, s_im, out, dim, T, n_sites, R, st);
  }
}
