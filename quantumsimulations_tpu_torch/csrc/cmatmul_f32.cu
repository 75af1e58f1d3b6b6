// Fused complex matmul on float32 (re, im) planes, batched, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel quantumsimulations_tpu/ops/pallas_kernels.py
// `_cmatmul_kernel` (driven by `cmatmul_f32`): both output planes
//
//     Cr = Ar Br - Ai Bi,    Ci = Ar Bi + Ai Br
//
// come from ONE pass over the A and B tiles, in IEEE float32 with fmaf (the
// reference asks for Precision.HIGHEST, i.e. float32 grade; TF32 would miss
// it).  The TPU version is vmapped over the batch and walks K on a sequential
// grid axis with the sum carried in its output block; here the batch is the
// grid's z axis and each block loops over K itself, so nothing carries over
// between blocks.
//
// Bound.  On the main path (eig32 sweep) the shape is B=39, M=K=128, N=1680:
// 8*B*M*K*N = 8.6 GFLOP per launch against ~0.14 GB of planes moved, about
// 60 FLOP per byte, so the kernel is bound by float32 arithmetic on the CUDA
// cores (about 67 TFLOP/s on an H100 SXM at 700 W without tensor cores,
// ~0.13 ms per launch), not by the 3.35 TB/s of HBM.
//
// Design for that bound.  A 64x64 output tile per 256-thread block, each
// thread holding a 4x4 register tile of BOTH output planes (32 accumulators),
// so every operand read from shared memory feeds 4 fmaf: per k step a thread
// reads 16 floats from shared memory and issues 64 fmaf.  The four input
// planes are staged in shared memory 16 deep in k (16 KB per block).  Thread
// (ty, tx) owns rows ty + 16*i and columns tx + 16*j, so B-tile reads are
// conflict-free and the output stores are coalesced.  Ragged edges (M, N, K
// not multiples of the tile) are masked in the loads (zero fill) and stores;
// no padded copies are made.  Tensor cores (3xTF32 split), wgmma and TMA are
// left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // contraction depth staged per step
constexpr int TM = 4;    // output rows per thread
constexpr int TN = 4;    // output columns per thread
constexpr int RY = BM / TM;  // 16 thread rows
constexpr int RX = BN / TN;  // 16 thread columns
constexpr int THREADS = RY * RX;  // 256

__global__ void __launch_bounds__(THREADS)
cmatmul_f32_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                   const float* __restrict__ br, const float* __restrict__ bi,
                   float* __restrict__ cr, float* __restrict__ ci,
                   int M, int K, int N,
                   long long sa, long long lda,
                   long long sb, long long ldb,
                   long long sc, long long ldc) {
  // A planes stored k-major (transposed) so the compute loop reads a column
  // of the tile; +1 pads the rows apart in the shared-memory banks.
  __shared__ float s_ar[BK][BM + 1];
  __shared__ float s_ai[BK][BM + 1];
  __shared__ float s_br[BK][BN];
  __shared__ float s_bi[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % RX;
  const int ty = tid / RX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  ar += z * sa;
  ai += z * sa;
  br += z * sb;
  bi += z * sb;
  cr += z * sc;
  ci += z * sc;

  float acc_r[TM][TN];
  float acc_i[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_r[i][j] = 0.f;
      acc_i[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (BM x BK): neighbouring threads read neighbouring k.
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int m = idx / BK;
      const int k = idx % BK;
      const int gm = m0 + m;
      const int gk = k0 + k;
      const bool ok = gm < M && gk < K;
      const long long off = gm * lda + gk;
      s_ar[k][m] = ok ? ar[off] : 0.f;
      s_ai[k][m] = ok ? ai[off] : 0.f;
    }
    // B tile (BK x BN): neighbouring threads read neighbouring n.
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int k = idx / BN;
      const int n = idx % BN;
      const int gk = k0 + k;
      const int gn = n0 + n;
      const bool ok = gk < K && gn < N;
      const long long off = gk * ldb + gn;
      s_br[k][n] = ok ? br[off] : 0.f;
      s_bi[k][n] = ok ? bi[off] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a_r[TM], a_i[TM], b_r[TN], b_i[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a_r[i] = s_ar[kk][ty + i * RY];
        a_i[i] = s_ai[kk][ty + i * RY];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b_r[j] = s_br[kk][tx + j * RX];
        b_i[j] = s_bi[kk][tx + j * RX];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_r[i][j] = fmaf(a_r[i], b_r[j], acc_r[i][j]);
          acc_r[i][j] = fmaf(-a_i[i], b_i[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(a_r[i], b_i[j], acc_i[i][j]);
          acc_i[i][j] = fmaf(a_i[i], b_r[j], acc_i[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * RY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * RX;
      if (gn < N) {
        const long long off = gm * ldc + gn;
        cr[off] = acc_r[i][j];
        ci[off] = acc_i[i][j];
      }
    }
  }
}

}  // namespace

// C interface for ctypes.  Row-major planes with unit stride along the last
// axis; s* are the strides between batch entries, ld* between rows (in
// elements).  Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int qst_cmatmul_f32(const float* ar, const float* ai,
                               const float* br, const float* bi,
                               float* cr, float* ci,
                               int batch, int M, int K, int N,
                               long long sa, long long lda,
                               long long sb, long long ldb,
                               long long sc, long long ldc,
                               void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  cmatmul_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ar, ai, br, bi, cr, ci, M, K, N, sa, lda, sb, ldb, sc, ldc);
  return static_cast<int>(cudaGetLastError());
}
