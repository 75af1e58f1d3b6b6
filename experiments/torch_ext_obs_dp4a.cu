// Candidate (a) for the ext observable kernel: the SIMT design of
// experiments/torch_ext_obs_simt.cu with four rows packed into an int32 per
// limb and every limb-pair product taken by `__dp4a` (four int8 multiply-adds
// per instruction).  experiments/torch_ext_obs_probe.py builds and times it
// beside the tensor-core design (quantumsimulations_tpu_torch/csrc/
// ext_obs_diagonals.cu) and the SIMT one; it measures the `__dp4a` issue rate
// that PERF.md's restated bound assumed.  Same C interface and contract.
//
// A thread owns one column; per four level pairs of its site it loads the
// n_diag limbs of R and I at the four level-0 rows and at their partners (one
// byte each, neighbouring threads on neighbouring columns), packs each limb's
// four rows into one int32 (`__byte_perm`) and updates its sums with 8 `__dp4a`
// per limb pair: x and both halves of y and z in separate int32 sums (signs
// by subtraction at the end).  The norm block does 2 per limb pair and 4 rows.
// dim / 2 < 4 (one or two sites) pads the last group with zero rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // columns per block
constexpr int MAX_DIAG = 11;

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return static_cast<int>(__byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                                      0x5410));
}

template <int ND>
__global__ void __launch_bounds__(THREADS)
ext_obs_dp4a_kernel(const int8_t* __restrict__ s_re, const int8_t* __restrict__ s_im,
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
    for (int r0 = 0; r0 < dim; r0 += 4) {
      int re[ND], im[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        int b[2][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = r0 + u < dim;
          const size_t off = j * plane + static_cast<size_t>(r0 + u) * T + t;
          b[0][u] = in ? s_re[off] : 0;
          b[1][u] = in ? s_im[off] : 0;
        }
        re[j] = pack4(b[0][0], b[0][1], b[0][2], b[0][3]);
        im[j] = pack4(b[1][0], b[1][1], b[1][2], b[1][3]);
      }
#pragma unroll
      for (int s = 0; s < ND; ++s)
#pragma unroll
        for (int j = 0; j <= s; ++j) acc[s] = __dp4a(im[j], im[s - j], __dp4a(re[j], re[s - j], acc[s]));
    }
#pragma unroll
    for (int s = 0; s < ND; ++s) {
      int32_t* o = out + s * RT + t;
      o[static_cast<size_t>(3 * n_sites) * T] = acc[s];
      for (int row = 3 * n_sites + 1; row < R; ++row) o[static_cast<size_t>(row) * T] = 0;
    }
    return;
  }

  const int shift = n_sites - 1 - g;
  const int dr = 1 << shift;
  int ax[ND], ayp[ND], aym[ND], azp[ND], azm[ND];
#pragma unroll
  for (int s = 0; s < ND; ++s) ax[s] = ayp[s] = aym[s] = azp[s] = azm[s] = 0;
  for (int q0 = 0; q0 < dim / 2; q0 += 4) {
    int ra[ND], ia[ND], rb[ND], ib[ND];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      int b[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u;
        const bool in = q < dim / 2;
        const int a = ((q >> shift) << (shift + 1)) | (q & (dr - 1));
        const size_t off_a = j * plane + static_cast<size_t>(a) * T + t;
        const size_t off_b = off_a + static_cast<size_t>(dr) * T;
        b[0][u] = in ? s_re[off_a] : 0;
        b[1][u] = in ? s_im[off_a] : 0;
        b[2][u] = in ? s_re[off_b] : 0;
        b[3][u] = in ? s_im[off_b] : 0;
      }
      ra[j] = pack4(b[0][0], b[0][1], b[0][2], b[0][3]);
      ia[j] = pack4(b[1][0], b[1][1], b[1][2], b[1][3]);
      rb[j] = pack4(b[2][0], b[2][1], b[2][2], b[2][3]);
      ib[j] = pack4(b[3][0], b[3][1], b[3][2], b[3][3]);
    }
#pragma unroll
    for (int s = 0; s < ND; ++s) {
#pragma unroll
      for (int j = 0; j <= s; ++j) {
        const int i = s - j;
        ax[s] = __dp4a(ia[j], ib[i], __dp4a(ra[j], rb[i], ax[s]));
        ayp[s] = __dp4a(ra[j], ib[i], ayp[s]);
        aym[s] = __dp4a(ia[j], rb[i], aym[s]);
        azp[s] = __dp4a(ia[j], ia[i], __dp4a(ra[j], ra[i], azp[s]));
        azm[s] = __dp4a(ib[j], ib[i], __dp4a(rb[j], rb[i], azm[s]));
      }
    }
  }
#pragma unroll
  for (int s = 0; s < ND; ++s) {
    int32_t* o = out + s * RT + static_cast<size_t>(3 * g) * T + t;
    o[0] = ax[s];
    o[T] = ayp[s] - aym[s];
    o[2 * static_cast<size_t>(T)] = azp[s] - azm[s];
  }
}

template <int ND>
int launch(const int8_t* s_re, const int8_t* s_im, int32_t* out, int dim, int T, int n_sites,
           int R, cudaStream_t stream) {
  const dim3 grid((T + THREADS - 1) / THREADS, n_sites + 1);
  ext_obs_dp4a_kernel<ND><<<grid, THREADS, 0, stream>>>(s_re, s_im, out, dim, T, n_sites, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
