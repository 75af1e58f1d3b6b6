// The exact-limb chain's digit epilogue, for Hopper (sm_90a): int32 digits ->
// canonical int8 limbs, every intermediate digit and carry in registers.
//
// Replaces no Pallas kernel.  The JAX package carries the digits of its ext
// products with XLA element-wise programs (quantumsimulations_tpu/ops/
// extprec.py::_ext_cpanel_product, _ext_carry_i32, ext_add); the port ran
// them as ATen launches, ~230 of 4-8 M elements for one column panel of a
// product, each reading and writing whole int32 planes.  This kernel does the
// same integer arithmetic, bit for bit, in one launch:
//
//   * the panel form (ops/ext_carry.py::ext_carry_panel), after a panel's
//     int8 GEMMs: from the Karatsuba outputs m1, m2, m3 of the S = L + 2
//     significance diagonals, re = m1 - m2 and im = m3 - m1 - m2, each plane
//     carried from digit S - 1 down to 0 (t = d + c, c = (t + 16) >> 5,
//     limb t - 32 c; limb 0 = d + c), the first L limbs written as int8 into
//     the (L, M, N_total) result at the panel's column offset;
//   * the Horner form (ops/ext_carry.py::ext_axpy_traced), the Taylor step's
//     a + p c: per column the S digits d[m] = sum_i p[m - 1 - i] cl[i] of p
//     times the scalar's limbs, carried to L limbs, added to a's limbs and
//     carried again, in one descending pass (both cascades run from the top
//     digit down, so the second consumes each limb of the first as it forms).
//
// Bound.  Bytes: the work is a few integer operations per byte.  The panel
// form reads 3 S int32 digits and writes 2 L int8 limbs per element, (3 * 17
// * 4 + 2 * 15) M N = 234 M N bytes: 0.98 GB, 0.29 ms at 3.35 TB/s, at the
// n12 chain's panel (M 8192, N 512).  The Horner form reads p's and a's L
// limbs and writes L, 45 bytes per column: 3.0 GB, 0.90 ms, at dim 8192.  Its
// ~120 integer multiply-adds per column take ~0.6 ms at the int32 rate
// (64 an SM a clock), under the bytes.
//
// Design.  One thread per 4 adjacent columns (one where the shapes or
// offsets are not multiples of 4): 16-byte loads of the digits, 4-byte
// stores of 4 limbs, adjacent threads on adjacent addresses, so every byte
// leaves or reaches HBM once in whole sectors.  The cascade's carries and
// the Horner form's 15 limbs of p sit in registers; nothing is staged in
// shared memory, since no thread reads another's data.  The panel form's
// int32 sums wrap as the plain version's int32 tensors do, so the two agree
// bit for bit up to ops/extprec.py::ext_cmatmul's headroom bound.  The
// kernel allocates nothing; the wrapper allocates the limbs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 15;             // limbs kept (ops/ext_carry.py EXT_LIMBS)
constexpr int S = L + 2;          // digits: the limbs and two guard digits below them
constexpr int THREADS = 256;

// int32 sums that wrap, as the plain version's int32 tensors do: the
// Karatsuba differences stay in range under ext_cmatmul's headroom assert,
// but a carry added to a digit at that bound may not.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// One step of the carry cascade: the limb of digit d with the carry c from
// below, rounded to nearest, ties toward +inf; c becomes the carry upward
// (|c| < 2^26, so 32 c does not overflow).
__device__ __forceinline__ int carry_step(int d, int& c) {
  const int t = wrap_add(d, c);
  c = wrap_add(t, 16) >> 5;
  return wrap_sub(t, 32 * c);
}

template <int VEC>
__device__ __forceinline__ void load_i32(const int32_t* p, int (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 x = *reinterpret_cast<const int4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void load_i8(const int8_t* p, int (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = static_cast<int8_t>(x >> (8 * k));
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_i8(int8_t* p, const int (&v)[VEC]) {
  if constexpr (VEC == 4) {
    uint32_t x = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) x |= static_cast<uint32_t>(static_cast<uint8_t>(v[k])) << (8 * k);
    *reinterpret_cast<uint32_t*>(p) = x;
  } else {
    *p = static_cast<int8_t>(v[0]);
  }
}

// ws: (3, S, M, n) int32, the panel's m1, m2, m3 per diagonal; re, im: the
// (L, M, ld) int8 results, the panel at columns [p0, p0 + n).  groups = M *
// n / VEC threads, gpr = n / VEC of them per row.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    ext_carry_panel_kernel(const int32_t* __restrict__ ws, int8_t* __restrict__ re,
                           int8_t* __restrict__ im, long long groups, int gpr, int n,
                           long long mn, long long ld, long long plane, long long p0) {
  const long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (g >= groups) return;
  const long long row = g / gpr;
  const int col = static_cast<int>(g - row * gpr) * VEC;
  const int32_t* w = ws + row * n + col;
  const long long o = row * ld + p0 + col;
  int c_re[VEC], c_im[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) c_re[v] = c_im[v] = 0;
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
    int m1[VEC], m2[VEC], m3[VEC], l_re[VEC], l_im[VEC];
    load_i32<VEC>(w + s * mn, m1);
    load_i32<VEC>(w + (S + s) * mn, m2);
    load_i32<VEC>(w + (2 * S + s) * mn, m3);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int d_re = wrap_sub(m1[v], m2[v]);
      const int d_im = wrap_sub(wrap_sub(m3[v], m1[v]), m2[v]);
      l_re[v] = s > 0 ? carry_step(d_re, c_re[v]) : wrap_add(d_re, c_re[v]);
      l_im[v] = s > 0 ? carry_step(d_im, c_im[v]) : wrap_add(d_im, c_im[v]);
    }
    if (s < L) {
      store_i8<VEC>(re + s * plane + o, l_re);
      store_i8<VEC>(im + s * plane + o, l_im);
    }
  }
}

// The scalar's limbs cl[0 .. S - 2]: a limb i >= S - 1 would land on digit
// i + 1 >= S, below every digit kept, so it is never read.
struct Coeffs {
  int c[S - 1];
};

// a, p, out: (L, cols) int8 limb stacks; groups = cols / VEC threads.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    ext_axpy_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ p,
                    int8_t* __restrict__ out, long long groups, long long cols, Coeffs cl) {
  const long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (g >= groups) return;
  const long long col = g * VEC;
  int pv[L][VEC];
#pragma unroll
  for (int j = 0; j < L; ++j) load_i8<VEC>(p + j * cols + col, pv[j]);
  int c_scaled[VEC], c_sum[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) c_scaled[v] = c_sum[v] = 0;
#pragma unroll
  for (int m = S - 1; m >= 0; --m) {
    int d[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) d[v] = 0;
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      const int j = m - 1 - i;
      if (j >= 0 && j < L) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) d[v] += pv[j][v] * cl.c[i];
      }
    }
    // limb m of p c, an int8 as the plain version keeps it
    int scaled[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      scaled[v] = static_cast<int8_t>(m > 0 ? carry_step(d[v], c_scaled[v]) : d[v] + c_scaled[v]);
    if (m < L) {
      int av[VEC], limb[VEC];
      load_i8<VEC>(a + m * cols + col, av);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int sum = av[v] + scaled[v];
        limb[v] = m > 0 ? carry_step(sum, c_sum[v]) : sum + c_sum[v];
      }
      store_i8<VEC>(out + m * cols + col, limb);
    }
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

unsigned int blocks(long long groups) {
  return static_cast<unsigned int>((groups + THREADS - 1) / THREADS);
}

}  // namespace

// C interface for ctypes.  ws: (3, S, M, N) contiguous int32 (m1, m2, m3 of
// each diagonal); re, im: contiguous (L, M, ld) int8, the panel's limbs
// written at columns [p0, p0 + N) of each row.  Launches on `stream` and
// returns the CUDA error code (0 = ok).
extern "C" int qst_ext_carry_panel(const int32_t* ws, int8_t* re, int8_t* im, int M, int N,
                                   long long ld, long long p0, void* stream) {
  if (M < 1 || N < 1 || p0 < 0 || p0 + N > ld || !aligned(ws, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long mn = static_cast<long long>(M) * N, plane = M * ld;
  const bool vec = N % 4 == 0 && ld % 4 == 0 && p0 % 4 == 0 && aligned(ws, 16) &&
                   aligned(re, 4) && aligned(im, 4);
  if (vec) {
    const long long groups = mn / 4;
    ext_carry_panel_kernel<4><<<blocks(groups), THREADS, 0, st>>>(ws, re, im, groups, N / 4, N,
                                                                   mn, ld, plane, p0);
  } else {
    ext_carry_panel_kernel<1><<<blocks(mn), THREADS, 0, st>>>(ws, re, im, mn, N, N, mn, ld, plane,
                                                              p0);
  }
  return static_cast<int>(cudaGetLastError());
}

// a, p, out: contiguous (L, cols) int8; cl: n_cl host int32 limbs of the
// scalar (those past S - 1 are never read).  Launches on `stream` and
// returns the CUDA error code (0 = ok).
extern "C" int qst_ext_axpy(const int8_t* a, const int8_t* p, int8_t* out, long long cols,
                            const int32_t* cl, int n_cl, void* stream) {
  if (cols < 1 || n_cl < 0) return static_cast<int>(cudaErrorInvalidValue);
  Coeffs c{};
  for (int i = 0; i < S - 1 && i < n_cl; ++i) c.c[i] = cl[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols % 4 == 0 && aligned(a, 4) && aligned(p, 4) && aligned(out, 4)) {
    ext_axpy_kernel<4><<<blocks(cols / 4), THREADS, 0, st>>>(a, p, out, cols / 4, cols, c);
  } else {
    ext_axpy_kernel<1><<<blocks(cols), THREADS, 0, st>>>(a, p, out, cols, cols, c);
  }
  return static_cast<int>(cudaGetLastError());
}
