// Limb-domain matmul with the carry fused in: int8 limb stacks in, canonical
// int8 limbs out, for Hopper (sm_90a), on the int8 tensor cores.
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
// into L canonical int8 limbs.  Only the int8 limbs touch device memory
// (and, when K is split, the int32 digits of the slices).  int32 sums are
// exact in any order as long as K * 2^(2*bits) * L < 2^31, which the Python
// wrapper asserts for the full K, so the result is bit-identical to the TPU
// kernel whatever order the blocks, warps and tensor cores add in, and
// however K is split.
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
// visit.  Hopper blocks run in no order, so K is cut into `ksplit` slices
// (the grid's z axis, chosen by ops/limb_kernels.py::limb_launch_plan so
// that small-output products still fill the card).  Each block sums its
// slice; with ksplit > 1 it writes its int32 digits to a workspace and bumps
// its output tile's counter, and the block that arrives last adds the other
// slices' digits, runs the carry once over all of K and resets the counter
// to 0 for the next launch.  Counters are per output tile, so launches that
// share a counter buffer must run in stream order.
//
// Bound.  2*72*M*N*K integer operations against L*(MK + KN + MN) bytes: at
// the main path's shapes (K = 128 or 1792, M, N = 128..1792) that is 100-600
// operations per byte, so the kernel is bound by int8 operations (1,979 TOPS
// dense on the H100 SXM's tensor cores), not by the 3.35 TB/s of HBM.
//
// Design.  The products run as `mma.sync.m16n8k32.row.col.s32.s8.s8.s32`:
// each warp owns one 16x8 output fragment and keeps its 12 digits as 12 int32
// fragments (48 registers); per 32-deep K step it reads the 10 B limbs'
// fragments (20 registers) and then, one A limb at a time (4 registers),
// issues that limb's live pairs: 72 mma per K step.  A block of 8 warps
// covers a 32x32 output tile.  Shared memory holds one 32-deep K step of all
// limbs: A as [limb][row][k-quad] (K-contiguous: the row fragment; one
// 16-byte load per 16 k when K % 16 == 0), B as [limb][k-quad][col] with the
// four k of a quad packed in one int32 (exactly the col fragment), packed
// from four N-contiguous rows with a 4x4 byte transpose (__byte_perm) when
// N % 4 == 0.  Row strides of 12 (A) and 40 (B) words keep the fragment reads
// free of bank conflicts.  Ragged M, N and K are masked with zero fill in the
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

constexpr int L = 10;        // limbs per value (split_apply_ext.GRID_LIMBS)
constexpr int S = L + 2;     // digits: L + GRID_GUARD
constexpr int TILE_M = 32;   // output rows per block
constexpr int TILE_N = 32;   // output columns per block
constexpr int BK = 32;       // K per step (one mma depth)
constexpr int QK = BK / 4;   // int32 k-quads per step
constexpr int THREADS = 256; // 8 warps of one 16x8 fragment each
constexpr int SA = QK + 4;   // A row stride in words (12)
constexpr int SBW = TILE_N + 8;  // B quad-row stride in words (40)
constexpr int DIGIT_REGS = 4 * S;  // int32 digit registers a thread holds

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

__device__ __forceinline__ void mma_s8(int* c, const int* a, const int* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A16: K % 16 == 0 and a 16-byte aligned (16-byte loads along k).
// B4: N % 4 == 0 and b 4-byte aligned (int32 loads along n, byte transpose).
template <bool A16, bool B4>
__global__ void __launch_bounds__(THREADS, 2)
limb_matmul_canon_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                         int8_t* __restrict__ out, int M, int K, int N, int bits,
                         int row_tile, int ldo, int kslice, int* __restrict__ ws,
                         int* __restrict__ counters) {
  __shared__ __align__(16) int sA[L][TILE_M][SA];
  __shared__ __align__(16) int sB[L][QK][SBW];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment group: A/C row, B column
  const int t = lane & 3;   // thread in group: k-quad of A/B, column pair of C
  const int wm = (warp >> 2) * 16;
  const int wn = (warp & 3) * 8;
  const int m0 = blockIdx.y * TILE_M;
  const int n0 = blockIdx.x * TILE_N;
  const int ks = blockIdx.z;
  const int ksplit = gridDim.z;
  const int kb = ks * kslice;
  const int ke = min(K, kb + kslice);
  const size_t MK = static_cast<size_t>(M) * K;
  const size_t KN = static_cast<size_t>(K) * N;
  const size_t MN = static_cast<size_t>(M) * N;

  int acc[S][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[s][r] = 0;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    if constexpr (A16) {
      // (limb, row, half): 16 bytes = 4 quads; ke is a multiple of 16 here
      for (int v = tid; v < L * TILE_M * 2; v += THREADS) {
        const int h = v & 1;
        const int m = (v >> 1) % TILE_M;
        const int l = v / (2 * TILE_M);
        const int gm = m0 + m;
        const int gk = k0 + 16 * h;
        int4 w = make_int4(0, 0, 0, 0);
        if (gm < M && gk < ke)
          w = *reinterpret_cast<const int4*>(a + l * MK + static_cast<size_t>(gm) * K + gk);
        *reinterpret_cast<int4*>(&sA[l][m][4 * h]) = w;
      }
    } else {
      for (int v = tid; v < L * TILE_M * QK; v += THREADS) {
        const int q = v % QK;
        const int m = (v / QK) % TILE_M;
        const int l = v / (QK * TILE_M);
        const int gm = m0 + m;
        const int gk = k0 + 4 * q;
        int w = 0;
        if (gm < M && gk < ke)
          w = pack4(a + l * MK + static_cast<size_t>(gm) * K + gk, ke - gk);
        sA[l][m][q] = w;
      }
    }
    if constexpr (B4) {
      // (limb, quad, 4 columns): four int32 row loads, 4x4 byte transpose
      for (int v = tid; v < L * QK * (TILE_N / 4); v += THREADS) {
        const int c4 = v % (TILE_N / 4);
        const int q = (v / (TILE_N / 4)) % QK;
        const int l = v / (QK * (TILE_N / 4));
        const int gn = n0 + 4 * c4;
        const int gk = k0 + 4 * q;
        int w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[e] = (gn < N && gk + e < ke)
                     ? *reinterpret_cast<const int*>(b + l * KN + static_cast<size_t>(gk + e) * N + gn)
                     : 0;
        }
        const int t0 = __byte_perm(w[0], w[1], 0x5140);  // r0c0 r1c0 r0c1 r1c1
        const int t1 = __byte_perm(w[0], w[1], 0x7362);  // r0c2 r1c2 r0c3 r1c3
        const int t2 = __byte_perm(w[2], w[3], 0x5140);
        const int t3 = __byte_perm(w[2], w[3], 0x7362);
        *reinterpret_cast<int4*>(&sB[l][q][4 * c4]) =
            make_int4(__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                      __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632));
      }
    } else {
      for (int v = tid; v < L * QK * TILE_N; v += THREADS) {
        const int n = v % TILE_N;
        const int q = (v / TILE_N) % QK;
        const int l = v / (TILE_N * QK);
        const int gn = n0 + n;
        const int gk = k0 + 4 * q;
        int w = 0;
        if (gn < N) {
          const int8_t* p = b + l * KN + static_cast<size_t>(gk) * N + gn;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (gk + e < ke)
              w |= static_cast<int>(static_cast<uint8_t>(p[static_cast<size_t>(e) * N])) << (8 * e);
          }
        }
        sB[l][q][n] = w;
      }
    }
    __syncthreads();

    int bf[L][2];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      bf[i][0] = sB[i][t][wn + g];
      bf[i][1] = sB[i][4 + t][wn + g];
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      int af[4];
      af[0] = sA[j][wm + g][t];
      af[1] = sA[j][wm + g + 8][t];
      af[2] = sA[j][wm + g][4 + t];
      af[3] = sA[j][wm + g + 8][4 + t];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (j + i < S) mma_s8(acc[j + i], af, bf[i]);
      }
    }
    __syncthreads();
  }

  if (ksplit > 1) {
    // workspace [tile][slice][digit register][thread]: coalesced, and each
    // thread reads back exactly the positions it and its peers wrote
    const size_t tile = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    int* mine = ws + (tile * ksplit + ks) * DIGIT_REGS * THREADS;
#pragma unroll
    for (int r = 0; r < DIGIT_REGS; ++r) mine[r * THREADS + tid] = acc[r / 4][r % 4];
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&counters[tile], 1) == ksplit - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int o = 0; o < ksplit; ++o) {
      if (o == ks) continue;
      const int* other = ws + (tile * ksplit + o) * DIGIT_REGS * THREADS;
#pragma unroll
      for (int r = 0; r < DIGIT_REGS; ++r) acc[r / 4][r % 4] += __ldcg(other + r * THREADS + tid);
    }
    if (tid == 0) counters[tile] = 0;
  }

  // carry cascade in the epilogue: nearest, ties toward +inf.  C fragment
  // register r sits at row g + 8*(r/2), column 2t + r%2 of the warp's tile.
  const int half = 1 << (bits - 1);
  const int unit = 1 << bits;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gm = m0 + wm + g + 8 * (r >> 1);
    const int gn = n0 + wn + 2 * t + (r & 1);
    if (gm >= M || gn >= N) continue;
    const size_t row_off = static_cast<size_t>(gm % row_tile) * ldo + static_cast<size_t>(gm / row_tile) * N;
    int8_t limb[L];
    int cy = 0;
#pragma unroll
    for (int s = S - 1; s > 0; --s) {
      const int v = acc[s][r] + cy;
      cy = (v + half) >> bits;  // arithmetic shift (see header)
      if (s < L) limb[s] = static_cast<int8_t>(v - cy * unit);
    }
    limb[0] = static_cast<int8_t>(acc[0][r] + cy);
#pragma unroll
    for (int l = 0; l < L; ++l) out[l * MN + row_off + gn] = limb[l];
  }
}

}  // namespace

// C interface for ctypes.  a (L, M, K), b (L, K, N) contiguous int8; out has
// L planes of M*N bytes, element (l, m, n) at
// l*M*N + (m % row_tile)*ldo + (m / row_tile)*N + n.  The launch plan
// (tile_m, tile_n, k_step, ksplit, kslice) comes from
// ops/limb_kernels.py::limb_launch_plan and must name this build's tile; K
// slice z covers [z*kslice, min(K, (z+1)*kslice)).  With ksplit > 1, `ws`
// holds ws_ints >= tiles*ksplit*48*256 int32 and `counters` one int32 per
// output tile, all 0 before the launch (the kernel leaves them 0).
// Launches on `stream` and returns the CUDA error code (0 = ok).
extern "C" int qst_limb_matmul_canon(const int8_t* a, const int8_t* b, int8_t* out,
                                     int limbs, int M, int K, int N, int bits,
                                     int row_tile, int ldo,
                                     int tile_m, int tile_n, int k_step, int ksplit, int kslice,
                                     int* ws, long long ws_ints, int* counters, void* stream) {
  if (limbs != L || bits < 1 || bits > 7 || row_tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (tile_m != TILE_M || tile_n != TILE_N || k_step != BK) return static_cast<int>(cudaErrorInvalidValue);
  if (ksplit < 1 || ksplit > 65535 || kslice < BK || kslice % BK != 0 ||
      static_cast<long long>(ksplit - 1) * kslice >= (K > 0 ? K : 1) ||
      static_cast<long long>(ksplit) * kslice < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + TILE_N - 1) / TILE_N, (M + TILE_M - 1) / TILE_M, ksplit);
  const long long need = static_cast<long long>(grid.x) * grid.y * ksplit * DIGIT_REGS * THREADS;
  if (ksplit > 1 && (ws == nullptr || counters == nullptr || ws_ints < need))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool a16 = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  if (a16 && b4)
    limb_matmul_canon_kernel<true, true><<<grid, THREADS, 0, st>>>(a, b, out, M, K, N, bits, row_tile, ldo, kslice, ws, counters);
  else if (a16)
    limb_matmul_canon_kernel<true, false><<<grid, THREADS, 0, st>>>(a, b, out, M, K, N, bits, row_tile, ldo, kslice, ws, counters);
  else if (b4)
    limb_matmul_canon_kernel<false, true><<<grid, THREADS, 0, st>>>(a, b, out, M, K, N, bits, row_tile, ldo, kslice, ws, counters);
  else
    limb_matmul_canon_kernel<false, false><<<grid, THREADS, 0, st>>>(a, b, out, M, K, N, bits, row_tile, ldo, kslice, ws, counters);
  return static_cast<int>(cudaGetLastError());
}
