// Limb-domain matmul with the carry fused in: int8 limb stacks in, canonical
// int8 limbs out, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel quantumsimulations_tpu/ops/limb_kernels.py
// `_limb_kernel` (driven by `limb_matmul_canon`).  A value on the 2^bits grid
// is a stack of L = 10 int8 limbs, limb j weighing 2^(-bits*j).  For
// a (L, M, K) and b (L, K, N) every limb pair (j, i) with j + i = s < S = 12
// is accumulated into the int32 digit s of each output element,
//
//     digit[s][m][n] = sum_{j+i=s} sum_k a[j][m][k] * b[i][k][n]   (72 pairs),
//
// and an exact carry cascade (nearest, ties toward +inf) turns the 12 digits
// into L canonical int8 limbs.  Only the int8 limbs touch device memory.
// int32 sums are exact in any order as long as K * 2^(2*bits) * L < 2^31,
// which the Python wrapper asserts, so the result is bit-identical to the
// TPU kernel whatever order the blocks and threads add in.
//
// Layout.  Without transpose_out the output is (L, M, N).  With it, `tm` is a
// LAYOUT parameter (the callers pass tm = DL): output row m of M-tile
// i = m / tm lands at row m % tm, columns [i*N, (i+1)*N) of (L, tm, (M/tm)*N).
// The launcher passes (row_tile, ldo) = (tm, (M/tm)*N), or (M, N) for the
// plain layout, so one index formula serves both; the CUDA tiles below are
// independent of it.
//
// What the TPU kernel did that Hopper cannot: it carried the K sum in VMEM
// scratch across a sequential grid axis and ran the carry at the last K
// visit.  Hopper blocks run in no order, so each block loops over all of K
// itself (optionally split among KSPLIT groups of its threads, summed through
// shared memory at the end) and runs the carry in its epilogue.
//
// Bound.  2*72*M*N*K integer operations against L*(MK + KN + MN) bytes: at
// the main path's shapes (K = 128 or 1792, M, N = 128..1792) that is 100-600
// operations per byte, so the kernel is bound by int8 operations (1,979 TOPS
// dense on the H100 SXM's tensor cores), not by the 3.35 TB/s of HBM.
//
// Design for now: SIMT __dp4a (four signed int8 products summed into int32
// per instruction) on the CUDA cores, not the tensor cores, so it runs far
// below that bound; mma.sync / wgmma s8 is later work.  Each thread owns a
// 2x2 output tile with 12 digit accumulators each (48 registers; a 4x4 tile
// would need 192), reads the 10 A limbs and 10 B limbs of one K quad (4 k
// packed in an int32) from shared memory and issues 4*72 dp4a per quad.  A is
// staged as [limb][row][quad] (global bytes along k are contiguous, one int32
// load when K % 4 == 0), B as [limb][quad][col] with the four k of a quad
// packed from four rows.  Ragged M, N and K are masked with zero fill in the
// loads and in the stores; no padded copies are made.
//
// Signed arithmetic: the carry needs an arithmetic right shift of negative
// int32.  C++17 leaves `>>` of a negative signed value implementation-defined;
// nvcc emits an arithmetic shift (SHF.R.S32), which is what is relied on here,
// and the tests cover negative digits.  `c << bits` is written c * (1 << bits),
// the same bits without the undefined left shift of a negative value.  The
// cast to int8 keeps the low 8 bits, as JAX's astype does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 10;       // limbs per value (split_apply_ext.GRID_LIMBS)
constexpr int S = L + 2;    // digits: L + GRID_GUARD

template <int BM, int BN, int BK, int KSPLIT>
struct Cfg {
  static constexpr int TPG = (BM / 2) * (BN / 2);  // threads per K group
  static constexpr int THREADS = TPG * KSPLIT;
  static constexpr int QK = BK / 4;                // int32 quads per K chunk
};

__device__ __forceinline__ int pack4(const int8_t* p, int valid) {
  // bytes p[0..3], those at index >= valid read as 0; byte 0 in the low bits
  int w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int v = b < valid ? static_cast<int>(static_cast<uint8_t>(p[b])) : 0;
    w |= v << (8 * b);
  }
  return w;
}

template <int BM, int BN, int BK, int KSPLIT>
__global__ void __launch_bounds__(Cfg<BM, BN, BK, KSPLIT>::THREADS)
limb_matmul_canon_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                         int8_t* __restrict__ out, int M, int K, int N, int bits,
                         int row_tile, int ldo, int a_words) {
  using C = Cfg<BM, BN, BK, KSPLIT>;
  constexpr int QK = C::QK;
  constexpr int TPG = C::TPG;
  constexpr int THREADS = C::THREADS;
  __shared__ int sA[L][BM][QK + 1];  // +1 word keeps the rows in other banks
  __shared__ int sB[L][QK][BN];
  __shared__ int red[KSPLIT > 1 ? S * 4 * TPG : 1];

  const int tid = threadIdx.x;
  const int g = tid / TPG;  // K group
  const int lt = tid % TPG;
  const int tx = lt % (BN / 2);
  const int ty = lt / (BN / 2);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const size_t MK = static_cast<size_t>(M) * K;
  const size_t KN = static_cast<size_t>(K) * N;
  const size_t MN = static_cast<size_t>(M) * N;

  int acc[2][2][S];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int s = 0; s < S; ++s) acc[r][c][s] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A chunk: word (l, m, q) packs a[l][m0+m][k0+4q .. +3]; q fastest.
    for (int idx = tid; idx < L * BM * QK; idx += THREADS) {
      const int q = idx % QK;
      const int m = (idx / QK) % BM;
      const int l = idx / (QK * BM);
      const int gm = m0 + m;
      const int gk = k0 + 4 * q;
      int w = 0;
      if (gm < M && gk < K) {
        const int8_t* p = a + l * MK + static_cast<size_t>(gm) * K + gk;
        w = (a_words && gk + 3 < K) ? *reinterpret_cast<const int*>(p) : pack4(p, K - gk);
      }
      sA[l][m][q] = w;
    }
    // B chunk: word (l, q, n) packs b[l][k0+4q .. +3][n0+n]; n fastest.
    for (int idx = tid; idx < L * QK * BN; idx += THREADS) {
      const int n = idx % BN;
      const int q = (idx / BN) % QK;
      const int l = idx / (BN * QK);
      const int gn = n0 + n;
      const int gk = k0 + 4 * q;
      int w = 0;
      if (gn < N) {
        const int8_t* p = b + l * KN + static_cast<size_t>(gk) * N + gn;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (gk + e < K) w |= static_cast<int>(static_cast<uint8_t>(p[static_cast<size_t>(e) * N])) << (8 * e);
        }
      }
      sB[l][q][n] = w;
    }
    __syncthreads();

    for (int q = g; q < QK; q += KSPLIT) {
      int aw[2][L], bw[2][L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) aw[r][j] = sA[j][ty + r * (BM / 2)][q];
#pragma unroll
        for (int c = 0; c < 2; ++c) bw[c][j] = sB[j][q][tx + c * (BN / 2)];
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = (s - L + 1 > 0 ? s - L + 1 : 0); j <= (s < L - 1 ? s : L - 1); ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              acc[r][c][s] = __dp4a(aw[r][j], bw[c][s - j], acc[r][c][s]);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (KSPLIT > 1) {
    // sum the K groups into group 0, one group at a time through shared memory
    for (int src = 1; src < KSPLIT; ++src) {
      if (g == src) {
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int rc = 0; rc < 4; ++rc) red[(s * 4 + rc) * TPG + lt] = acc[rc / 2][rc % 2][s];
      }
      __syncthreads();
      if (g == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int rc = 0; rc < 4; ++rc) acc[rc / 2][rc % 2][s] += red[(s * 4 + rc) * TPG + lt];
      }
      __syncthreads();
    }
    if (g != 0) return;
  }

  // carry cascade in the epilogue: nearest, ties toward +inf
  const int half = 1 << (bits - 1);
  const int unit = 1 << bits;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gm = m0 + ty + r * (BM / 2);
    if (gm >= M) continue;
    const size_t row_off = static_cast<size_t>(gm % row_tile) * ldo + static_cast<size_t>(gm / row_tile) * N;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gn = n0 + tx + c * (BN / 2);
      if (gn >= N) continue;
      int8_t limb[L];
      int cy = 0;
#pragma unroll
      for (int s = S - 1; s > 0; --s) {
        const int t = acc[r][c][s] + cy;
        cy = (t + half) >> bits;  // arithmetic shift (see header)
        if (s < L) limb[s] = static_cast<int8_t>(t - cy * unit);
      }
      limb[0] = static_cast<int8_t>(acc[r][c][0] + cy);
#pragma unroll
      for (int l = 0; l < L; ++l) out[l * MN + row_off + gn] = limb[l];
    }
  }
}

template <int BM, int BN, int BK, int KSPLIT>
int launch(const int8_t* a, const int8_t* b, int8_t* out, int M, int K, int N, int bits,
           int row_tile, int ldo, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int a_words = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 4 == 0);
  limb_matmul_canon_kernel<BM, BN, BK, KSPLIT>
      <<<grid, Cfg<BM, BN, BK, KSPLIT>::THREADS, 0, stream>>>(a, b, out, M, K, N, bits,
                                                              row_tile, ldo, a_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes.  a (L, M, K), b (L, K, N) contiguous int8; out has
// L planes of M*N bytes, element (l, m, n) at
// l*M*N + (m % row_tile)*ldo + (m / row_tile)*N + n.  Launches on `stream` and
// returns cudaGetLastError() (0 = ok).  Two tile shapes: 32x32 outputs per
// block when that grid fills the card twice over, else 16x16 with K split
// among four thread groups, so the small-M*N, long-K products of the cross
// stage still spread over more SMs.
extern "C" int qst_limb_matmul_canon(const int8_t* a, const int8_t* b, int8_t* out,
                                     int limbs, int M, int K, int N, int bits,
                                     int row_tile, int ldo, void* stream) {
  if (limbs != L || bits < 1 || bits > 7 || row_tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks32 = static_cast<long long>((M + 31) / 32) * ((N + 31) / 32);
  if (blocks32 >= 2 * 132) return launch<32, 32, 32, 1>(a, b, out, M, K, N, bits, row_tile, ldo, st);
  return launch<16, 16, 64, 4>(a, b, out, M, K, N, bits, row_tile, ldo, st);
}
