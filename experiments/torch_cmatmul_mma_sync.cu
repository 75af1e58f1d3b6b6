// cmatmul_f32 as first written for the tensor cores: the same C interface
// and 3xTF32 split as quantumsimulations_tpu_torch/csrc/cmatmul_f32.cu, on
// `mma.sync.m16n8k8` instead of `wgmma`.  Kept only as the baseline that
// experiments/torch_cmatmul_variants.py times beside the kernel; nothing in
// the package builds or calls it.
//
// Design: a 64x64 output tile per 256-thread block, eight warps of 32x16
// (two m16 by two n8 fragments of both output planes); the four planes are
// staged 16 deep in k through a three-stage cp.async ring; every warp reads
// its A (K-contiguous, the row fragment) and B (N-contiguous: the col
// fragment takes one k and one n per register) fragments with 32-bit
// shared-memory loads and splits them itself (hi = tf32_rna(x), lo =
// tf32_rna(x - hi), rounded with integer operations); each k8 step's 12
// products start from a zero accumulator and are added to the running sums
// with float32 adds, since the tensor cores' own accumulation truncates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_M = 2;   // warps along the block tile's rows
constexpr int WARPS_N = 4;   // ... and columns
constexpr int MT = 2;        // m16 fragments per warp
constexpr int NT = 2;        // n8 fragments per warp
constexpr int BM = WARPS_M * MT * 16;  // output rows per block (128)
constexpr int BN = WARPS_N * NT * 8;   // output columns per block (64)
constexpr int BK = 16;       // contraction depth per stage
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int MIN_BLOCKS = 2;  // blocks resident per SM (launch bounds)
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int SA = BK + 4;  // A row stride in words (20: conflict-free fragment reads)
constexpr int SB = BN + 8;  // B row stride in words (72: conflict-free fragment reads)
constexpr int A_PLANE = BM * SA;
constexpr int B_PLANE = BK * SB;
constexpr int STAGE_FLOATS = 2 * A_PLANE + 2 * B_PLANE;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes are written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The bits of cvt.rna.tf32.f32(x) for finite x below 2^128 (1 - 2^-12):
// adding half of the kept part's last unit to the sign-magnitude pattern and
// clearing the 13 low bits rounds the magnitude to nearest, ties away from
// zero.  Two integer operations instead of one conversion, which the SM runs
// at an eighth of its float32 rate (16 a clock).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both rounded to TF32 (nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a*b, starting from a zero accumulator
__device__ __forceinline__ void mma_tf32_first(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// Stage one BK slice of the four planes.  VEC: K % 4 == 0, N % 4 == 0 and
// 16-byte aligned planes, so every 16-byte chunk lies wholly inside or
// wholly outside the matrix; otherwise 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void load_stage(float* st, const float* ar, const float* ai,
                                           const float* br, const float* bi, int m0, int n0,
                                           int k0, int M, int K, int N, long long lda,
                                           long long ldb, int tid) {
  constexpr int W = VEC ? 4 : 1;  // floats per copy
  constexpr int A_COPIES = 2 * BM * BK / W;
  constexpr int B_COPIES = 2 * BK * BN / W;
  static_assert(A_COPIES % THREADS == 0 && B_COPIES % THREADS == 0, "copies per thread");
#pragma unroll
  for (int l = 0; l < A_COPIES / THREADS; ++l) {
    const int v = tid + l * THREADS;
    const int p = v / (BM * BK / W);  // plane: 0 re, 1 im
    const int m = (v / (BK / W)) % BM;
    const int k = (v % (BK / W)) * W;
    const int gm = m0 + m, gk = k0 + k;
    const bool ok = gm < M && gk < K;
    const float* src = (p ? ai : ar) + (ok ? gm * lda + gk : 0);
    float* dst = st + p * A_PLANE + m * SA + k;
    if constexpr (VEC) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  }
#pragma unroll
  for (int l = 0; l < B_COPIES / THREADS; ++l) {
    const int v = tid + l * THREADS;
    const int p = v / (BK * BN / W);
    const int k = (v / (BN / W)) % BK;
    const int n = (v % (BN / W)) * W;
    const int gk = k0 + k, gn = n0 + n;
    const bool ok = gk < K && gn < N;
    const float* src = (p ? bi : br) + (ok ? gk * ldb + gn : 0);
    float* dst = st + 2 * A_PLANE + p * B_PLANE + k * SB + n;
    if constexpr (VEC) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  }
}

template <bool VEC, bool PAIR_STORE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
cmatmul_f32_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                   const float* __restrict__ br, const float* __restrict__ bi,
                   float* __restrict__ cr, float* __restrict__ ci,
                   int M, int K, int N,
                   long long sa, long long lda,
                   long long sb, long long ldb,
                   long long sc, long long ldc) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment group (row of A/C, column of B)
  const int t = lane & 3;   // thread in group (k of A/B, column pair of C)
  const int wm = (warp % WARPS_M) * (16 * MT);  // warp's first row in the block tile
  const int wn = (warp / WARPS_M) * (8 * NT);   // warp's first column
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  ar += z * sa;
  ai += z * sa;
  br += z * sb;
  bi += z * sb;
  cr += z * sc;
  ci += z * sc;

  float acc_r[MT][NT][4];
  float acc_i[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc_r[i][j][r] = 0.f;
        acc_i[i][j][r] = 0.f;
      }

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<VEC>(smem + s * STAGE_FLOATS, ar, ai, br, bi, m0, n0, s * BK, M, K, N, lda,
                      ldb, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... and every thread's; stage kt-1 is free
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage<VEC>(smem + (nk % STAGES) * STAGE_FLOATS, ar, ai, br, bi, m0, n0, nk * BK, M,
                      K, N, lda, ldb, tid);
    cp_async_commit();

    const float* s_ar = smem + (kt % STAGES) * STAGE_FLOATS;
    const float* s_ai = s_ar + A_PLANE;
    const float* s_br = s_ar + 2 * A_PLANE;
    const float* s_bi = s_br + B_PLANE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      // A row fragments of the warp's m16 tiles, split into TF32 hi and lo
      uint32_t arh[MT][4], arl[MT][4], aih[MT][4], ail[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = wm + 16 * i + g;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int idx = (r0 + 8 * (q & 1)) * SA + kk + t + 4 * (q >> 1);
          split_tf32(s_ar[idx], arh[i][q], arl[i][q]);
          split_tf32(s_ai[idx], aih[i][q], ail[i][q]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn + 8 * j + g;
        uint32_t brh[2], brl[2], bih[2], bil[2], nbih[2], nbil[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int idx = (kk + t + 4 * q) * SB + col;
          split_tf32(s_br[idx], brh[q], brl[q]);
          split_tf32(s_bi[idx], bih[q], bil[q]);
          nbih[q] = bih[q] ^ 0x80000000u;
          nbil[q] = bil[q] ^ 0x80000000u;
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // this k8 step's products start from zero (small terms first) and
          // are added to the running sums with IEEE float32 adds: the tensor
          // cores' own accumulation truncates, which over a long K drifts
          float pr[4], pi[4];
          mma_tf32_first(pr, arl[i], brh);
          mma_tf32(pr, arh[i], brl);
          mma_tf32(pr, ail[i], nbih);
          mma_tf32(pr, aih[i], nbil);
          mma_tf32(pr, arh[i], brh);
          mma_tf32(pr, aih[i], nbih);
          mma_tf32_first(pi, arl[i], bih);
          mma_tf32(pi, arh[i], bil);
          mma_tf32(pi, ail[i], brh);
          mma_tf32(pi, aih[i], brl);
          mma_tf32(pi, arh[i], bih);
          mma_tf32(pi, aih[i], brh);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc_r[i][j][r] += pr[r];
            acc_i[i][j][r] += pi[r];
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment: registers (0, 1) at row g, columns 2t and 2t+1; (2, 3) at row g+8
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm + 16 * i + g + 8 * h;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int gn = n0 + wn + 8 * j + 2 * t;
        const long long off = gm * ldc + gn;
        const float r0 = acc_r[i][j][2 * h], r1 = acc_r[i][j][2 * h + 1];
        const float i0 = acc_i[i][j][2 * h], i1 = acc_i[i][j][2 * h + 1];
        if (PAIR_STORE && gn + 1 < N) {
          *reinterpret_cast<float2*>(cr + off) = make_float2(r0, r1);
          *reinterpret_cast<float2*>(ci + off) = make_float2(i0, i1);
        } else {
          if (gn < N) {
            cr[off] = r0;
            ci[off] = i0;
          }
          if (gn + 1 < N) {
            cr[off + 1] = r1;
            ci[off + 1] = i1;
          }
        }
      }
    }
  }
}

template <bool VEC, bool PAIR_STORE>
int launch(const float* ar, const float* ai, const float* br, const float* bi, float* cr,
           float* ci, int batch, int M, int K, int N, long long sa, long long lda, long long sb,
           long long ldb, long long sc, long long ldc, cudaStream_t stream) {
  auto kernel = cmatmul_f32_kernel<VEC, PAIR_STORE>;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device; a refused attribute would make the launch fail, so its code is
  // returned
  static unsigned long long opted_in = 0;  // one bit per device
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (dev >= 64 || !((opted_in >> dev) & 1ull)) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if (dev < 64) opted_in |= 1ull << dev;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(ar, ai, br, bi, cr, ci, M, K, N, sa, lda, sb,
                                                ldb, sc, ldc);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// C interface for ctypes.  Row-major planes with unit stride along the last
// axis; s* are the strides between batch entries, ld* between rows (in
// elements).  Launches on `stream` and returns the CUDA error code (0 = ok).
extern "C" int qst_cmatmul_f32(const float* ar, const float* ai,
                               const float* br, const float* bi,
                               float* cr, float* ci,
                               int batch, int M, int K, int N,
                               long long sa, long long lda,
                               long long sb, long long ldb,
                               long long sc, long long ldc,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = lda % 4 == 0 && sa % 4 == 0 && ldb % 4 == 0 && sb % 4 == 0 && K % 4 == 0 &&
                   N % 4 == 0 && aligned(ar, 16) && aligned(ai, 16) && aligned(br, 16) &&
                   aligned(bi, 16);
  const bool pair = ldc % 2 == 0 && sc % 2 == 0 && aligned(cr, 8) && aligned(ci, 8);
  if (vec && pair) return launch<true, true>(ar, ai, br, bi, cr, ci, batch, M, K, N, sa, lda, sb, ldb, sc, ldc, st);
  if (vec) return launch<true, false>(ar, ai, br, bi, cr, ci, batch, M, K, N, sa, lda, sb, ldb, sc, ldc, st);
  if (pair) return launch<false, true>(ar, ai, br, bi, cr, ci, batch, M, K, N, sa, lda, sb, ldb, sc, ldc, st);
  return launch<false, false>(ar, ai, br, bi, cr, ci, batch, M, K, N, sa, lda, sb, ldb, sc, ldc, st);
}
