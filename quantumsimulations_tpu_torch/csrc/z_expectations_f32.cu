// Per-site <Sz>(t) of a block of states, out[j][t] = sum_d signs[j][d] * |psi[d][t]|^2,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel quantumsimulations_tpu/ops/pallas_kernels.py
// `_zexp_kernel` (driven by `z_expectations_f32`).  The contract is that
// function's: p2 = re*re + im*im is formed in the planes' own type (float32 or
// float64, each operation rounded, no fused multiply-add) and rounded to
// float32; each sign is rounded to float32; the result is (n, T) float32.  The
// TPU wrapper's padding of T to 128 and n to 8 is its layout, not the
// function's, and is dropped: the kernel masks a ragged T.
//
// Arithmetic.  A float32 sign times a float32 p2 is exact in float64 (48
// significant bits < 53), so every product enters a float64 sum exactly, and
// the sums stay in float64 to the end: each thread's over its rows, the row
// lanes' in a block, the row slices'.  The result is rounded once to float32.
// That is what the plain version computes (a float64 product of the same
// float32 operands), up to the order of the float64 sums.  A site's sum cancels
// two large halves (the basis states with the site up and down), which a
// float32 sum could not afford; float64 carries 29 bits more than the result
// keeps, so no compensation is needed.
//
// Bound.  The function reads each (d, t) of both planes once and the sign
// table once, 2*dim*T*itemsize + n*dim*sign_itemsize bytes, and does the
// square sum (3 operations) and n float64 multiply-adds per (d, t): at n = 14
// about 1.9 FP64 operations per byte of float64 planes, against the H100's
// ~10 (34 TFLOP/s FP64 without tensor cores over 3.35 TB/s).  So HBM bandwidth
// bounds it, and at the global Chebyshev route's (14, 16384, 21) float64
// (5.5 MB, ~1.6 us of bytes) the launch and the merge's latency do.
//
// Design: one launch per call, a grid of (column tiles) x (row slices) chosen
// by the pure-Python plan ops/zexp.py::zexp_launch_plan, blocks of at most 128
// threads (four resident per SM: <= 128 registers a thread, 48 KB of shared
// memory a block).
//   - Columns.  A thread owns C adjacent columns: C = 2 where T is even and the
//     planes are aligned, so it loads 16 bytes of float64 (8 of float32) per
//     row and plane; else C = 1.  A block has G column groups and R = 128 / G
//     row lanes; thread i owns columns g*C.. of its tile (g = i % G) and rows
//     r, r + R, ... of its slice (r = i / G).
//   - Small T.  Where T <= 128 one tile spans every column (G*C = T), so a
//     block's threads read R whole rows, R*T contiguous elements, with no idle
//     lane: at T = 21, 6 rows of 21 columns a step on 126 threads.  A wider T
//     takes tiles of G = 32: each warp reads 32*C contiguous columns of a row.
//   - Rows.  The rows are cut into slices: as many blocks as the card holds
//     at once (one wave; at (14, 16384, 2048), 32 tiles x 16 slices) where
//     each streams >= 64 KB, else >= two blocks per SM (at T = 21, 272
//     slices of 61 rows).  Blocks past one wave, or unevenly spread over the
//     SMs, cost more than the merge: 544 blocks at 2048 columns took 1.6x
//     as long as 512 (experiments/torch_zexp_variants.py).
//   - Each thread keeps n float64 sums per column in registers (at most 32
//     registers of sums at n = 16, C = 2) and loads U rows of both planes at
//     a time (4 at C = 1, 3 at C = 2: 128 registers) before it uses them,
//     with streaming loads; a tile's first rows are in flight while its sign
//     rows are staged.  (At 2048 columns, streaming loads and U = 3 took
//     0.205 ms against 0.223 for cached loads and U = 2.)  The sign rows of
//     a 128-row tile are staged in shared memory once per block (unrolled,
//     so the loads overlap), rounded to float32 and widened to float64, as
//     [row][site], so one 16-byte shared load gives two sites.  The row
//     lanes' sums are then added in order through shared memory.
//   - Slices merge in the same launch, with no atomics on the sums.  In the
//     one-wave case each block writes its float64 partial tile to a
//     workspace and arrives at a per-tile counter (an acquire-release atomic
//     after a block barrier); the last to arrive adds the tile's partials in
//     slice order, staged in shared memory by asynchronous copies.  In the
//     other case consecutive slices form clusters of up to 16 blocks, which
//     first add their tiles in rank order through distributed shared memory,
//     each block a share of the outputs, into one partial per cluster; the
//     block that arrives last tells its cluster, whose blocks then add the
//     clusters' partials of their shares in order.  (At T = 21, a last block
//     adding 264 partials alone took ~45 us; two levels of last blocks ~16
//     us; clusters ~12 us.)  Every sum's order is fixed by the plan, so the
//     result is deterministic; the last block resets its counter to 0, so a
//     call leaves the counters as the wrapper zeroed them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 128;
constexpr int MAX_SITES = 16;
constexpr int TILE_ROWS = 128;
// most columns of a block's tile
constexpr int MAX_TILE_COLS = 128;
// most blocks of a cluster
constexpr int MAX_CLUSTER = 16;
// doubles per staged sign row: a multiple of 2 (16-byte loads of two sites),
// padded past MAX_SITES so neighbouring rows fall in other banks
constexpr int SIGN_STRIDE = MAX_SITES + 2;
// one shared buffer (48 KB of static shared memory, less the flag): the sign
// tile while the rows stream, then the row lanes' sums, [site][column of the
// thread][thread], then the merges' running sums and staged partials
constexpr int SMEM_DOUBLES = 6136;
static_assert(TILE_ROWS * SIGN_STRIDE <= SMEM_DOUBLES, "the sign tile must fit the shared buffer");
static_assert(MAX_THREADS * 2 * MAX_SITES <= SMEM_DOUBLES, "the row lanes' sums must fit");
static_assert(2 * MAX_SITES * MAX_TILE_COLS <= SMEM_DOUBLES,
              "a merge needs room for a tile's running sums and one staged tile");

struct Plan {
  int n, dim, T;
  int groups, row_lanes, slice_rows, cluster;
};

// re*re + im*im rounded after each operation, as the plain version and the
// reference form it, then rounded to float32
__device__ __forceinline__ float square_sum(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}
__device__ __forceinline__ float square_sum(double a, double b) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) { return __double2float_rn(x); }

// C adjacent values of one row of a plane: one 16-byte (float64) or 8-byte
// (float32) load when C = 2; streaming (evict-first), as each is read once
template <typename Real, int C>
__device__ __forceinline__ void load_cols(const Real* p, Real (&v)[C]) {
  if constexpr (C == 2) {
    if constexpr (sizeof(Real) == 8) {
      const double2 x = __ldcs(reinterpret_cast<const double2*>(p));
      v[0] = x.x;
      v[1] = x.y;
    } else {
      const float2 x = __ldcs(reinterpret_cast<const float2*>(p));
      v[0] = x.x;
      v[1] = x.y;
    }
  } else {
    v[0] = __ldcs(p);
  }
}

// 16 bytes from global to shared memory, through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// True, in every thread of the block, for the block that arrives last of
// `expected` at `counter`.  The block's writes before the call are released
// (barrier, then one acquire-release atomic at GPU scope), and the last block
// acquires every other block's; this is the semaphore of a serial split-K
// reduction.
__device__ __forceinline__ bool arrive_last(int* counter, int expected, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(counter) : "memory");
    *flag = old == expected - 1;
  }
  __syncthreads();
  return *flag;
}

// Merge outputs [o0, o1) (o0 even) of `count` partial tiles src[k * plane +
// o], k = 0 .. count - 1, float64 sums of (site, column) o = j * tile_cols +
// lc: the sum of each o over k, added in order of k from 0.0, is rounded to
// float32 into out[j * T + col0 + lc] (for col0 + lc < T).  The tiles' ranges
// are staged in shared memory as many at a time as fit, by 16-byte
// asynchronous copies all in flight at once; the running sums wait in shared
// memory between batches.
__device__ void merge_tiles(const double* src, size_t plane, int count, int o0, int o1, int T,
                            int col0, int tile_cols, double* buf, float* out) {
  if (o1 <= o0) return;
  const int width = (o1 - o0 + 1) & ~1;
  double* run = buf;
  double* stage = buf + width;
  const int per = (SMEM_DOUBLES - width) / width;
  const int pieces = width / 2;
  for (int k0 = 0; k0 < count; k0 += per) {
    const int kc = min(per, count - k0);
    for (int e = threadIdx.x; e < kc * pieces; e += blockDim.x) {
      const int k = e / pieces, i = e - k * pieces;
      cp_async16(stage + k * width + 2 * i, src + (k0 + k) * plane + o0 + 2 * i);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const bool last = k0 + kc == count;
    for (int i = threadIdx.x; i < o1 - o0; i += blockDim.x) {
      double v = k0 == 0 ? 0.0 : run[i];
      for (int k = 0; k < kc; ++k) v += stage[k * width + i];
      if (!last) {
        run[i] = v;
      } else {
        const int o = o0 + i;
        const int j = o / tile_cols, col = col0 + (o - j * tile_cols);
        if (col < T) out[static_cast<size_t>(j) * T + col] = __double2float_rn(v);
      }
    }
    __syncthreads();
  }
}

template <typename Real, typename Sign, int C>
__global__ void __launch_bounds__(MAX_THREADS, 4)
zexp_kernel(const Real* __restrict__ re, const Real* __restrict__ im,
            const Sign* __restrict__ signs, float* __restrict__ out, double* __restrict__ ws,
            int* __restrict__ counters, const Plan p) {
  __shared__ __align__(16) double smem[SMEM_DOUBLES];
  __shared__ int s_last;
  __shared__ int s_final;
  constexpr int U = C == 1 ? 4 : 3;
  const int n = p.n, dim = p.dim, T = p.T, G = p.groups, R = p.row_lanes;
  const int nth = G * R;
  const int tid = threadIdx.x;
  const int g = tid % G, rl = tid / G;
  const int tile_cols = G * C;
  const int col0 = blockIdx.x * tile_cols + g * C;
  const bool active = col0 < T;  // C = 2 only for an even T: col0 + 1 < T too
  const int slice = blockIdx.y;
  const int d0 = slice * p.slice_rows;
  const int d1 = min(dim, d0 + p.slice_rows);
  const int pairs = (n + 1) / 2;

  double acc[MAX_SITES][C];
#pragma unroll
  for (int j = 0; j < MAX_SITES; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.0;

  for (int base = d0; base < d1; base += TILE_ROWS) {
    const int rows = min(TILE_ROWS, d1 - base);
    // rows r, r + R, ... r + (U-1)*R of both planes (those below `rows`)
    Real a[U][C], b[U][C];
    auto load_step = [&](int r) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * R;
        if (active && rr < rows) {
          const size_t off = static_cast<size_t>(base + rr) * T + col0;
          load_cols<Real, C>(re + off, a[u]);
          load_cols<Real, C>(im + off, b[u]);
        }
      }
    };
    load_step(rl);  // the first step's rows are in flight while the signs are staged
    // sites 0 .. 2*pairs - 1 of the tile's rows; a site n (odd n) is zero
#pragma unroll 8
    for (int k = tid; k < 2 * pairs * rows; k += nth) {
      const int j = k / rows, r = k - j * rows;
      smem[r * SIGN_STRIDE + j] =
          j < n ? static_cast<double>(to_f32(signs[static_cast<size_t>(j) * dim + base + r]))
                : 0.0;
    }
    __syncthreads();
    if (active) {
      for (int r = rl; r < rows; r += U * R) {
        if (r != rl) load_step(r);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int rr = r + u * R;
          if (rr < rows) {
            double q[C];
#pragma unroll
            for (int c = 0; c < C; ++c) q[c] = static_cast<double>(square_sum(a[u][c], b[u][c]));
            const double2* srow = reinterpret_cast<const double2*>(smem + rr * SIGN_STRIDE);
#pragma unroll
            for (int jp = 0; jp < MAX_SITES / 2; ++jp) {
              if (jp < pairs) {
                const double2 s = srow[jp];
#pragma unroll
                for (int c = 0; c < C; ++c) {
                  acc[2 * jp][c] = fma(s.x, q[c], acc[2 * jp][c]);
                  acc[2 * jp + 1][c] = fma(s.y, q[c], acc[2 * jp + 1][c]);
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // the row lanes' sums of each (site, column) o = j * tile_cols + lc,
  // added in lane order
#pragma unroll
  for (int j = 0; j < MAX_SITES; ++j) {
    if (j < n) {
#pragma unroll
      for (int c = 0; c < C; ++c) smem[(j * C + c) * nth + tid] = acc[j][c];
    }
  }
  __syncthreads();
  // partial tiles in the workspace: [partial][column tile][o], `stride`
  // doubles a tile (outs rounded up to even: 16-byte aligned tiles)
  const int S = gridDim.y;
  const int cs = p.cluster;
  const int K = S / cs;  // partials per column tile after the clusters
  const int outs = n * tile_cols;
  const int stride = (outs + 1) & ~1;
  const size_t plane = static_cast<size_t>(gridDim.x) * stride;
  const int col_base = blockIdx.x * tile_cols;
  double* mine = ws + blockIdx.x * stride;  // this tile's partial 0
  for (int o = tid; o < outs; o += nth) {
    const int j = o / tile_cols, lc = o - j * tile_cols;
    const int gg = lc / C, c = lc - gg * C;
    double* slot = smem + (j * C + c) * nth + gg;  // lane 0's: only o reads it
    double v = 0.0;
    for (int r = 0; r < R; ++r) v += slot[r * G];
    if (S == 1) {
      if (col_base + lc < T) out[static_cast<size_t>(j) * T + col_base + lc] = __double2float_rn(v);
    } else if (cs == 1) {
      mine[slice * plane + o] = v;
    } else {
      *slot = v;
    }
  }
  if (S == 1) return;

  if (cs > 1) {
    // the cs blocks of a cluster (consecutive slices) add their tiles through
    // distributed shared memory: block `rank` takes outputs [rank * share,
    // (rank + 1) * share) and adds them over the ranks, in rank order (all
    // loads in flight at once), into the cluster's partial tile
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) s_final = 0;
    cluster.sync();
    const int share = ((outs + cs - 1) / cs + 1) & ~1;
    const int o0 = min(outs, static_cast<int>(cluster.block_rank()) * share);
    const int o1 = min(outs, o0 + share);
    for (int o = o0 + tid; o < o1; o += nth) {
      const int j = o / tile_cols, lc = o - j * tile_cols;
      const int gg = lc / C, c = lc - gg * C;
      double* slot = smem + (j * C + c) * nth + gg;
      double x[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) x[r] = r < cs ? *cluster.map_shared_rank(slot, r) : 0.0;
      double v = 0.0;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < cs) v += x[r];
      if (K > 1)
        mine[(slice / cs) * plane + o] = v;
      else if (col_base + lc < T)
        out[static_cast<size_t>(j) * T + col_base + lc] = __double2float_rn(v);
    }
    if (K == 1) {
      cluster.sync();  // every rank's shared memory stays until it is read
      return;
    }
    // every block arrives at the tile's counter; the one that arrives last
    // of the S tells its cluster, whose blocks then add the K partials of
    // their shares of the outputs in order
    __syncthreads();
    if (tid == 0) {
      int old;
      asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(counters + blockIdx.x)
                   : "memory");
      if (old == S - 1) {
        counters[blockIdx.x] = 0;
        for (int r = 0; r < cs; ++r) *cluster.map_shared_rank(&s_final, r) = 1;
      }
    }
    cluster.sync();  // also: every rank's shared memory stays until it is read
    if (!s_final) return;
    merge_tiles(mine, plane, K, o0, o1, T, col_base, tile_cols, smem, out);
    return;
  }

  // the last of the tile's S blocks to arrive adds the S partials in order
  int* counter = counters + blockIdx.x;
  if (!arrive_last(counter, S, &s_last)) return;
  merge_tiles(mine, plane, K, 0, outs, T, col_base, tile_cols, smem, out);
  if (tid == 0) *counter = 0;
}

template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, int cluster, cudaStream_t st,
                  Args... args) {
  if (cluster == 1) {
    kernel<<<grid, threads, 0, st>>>(args...);
    return static_cast<int>(cudaGetLastError());
  }
  if (cluster > 8) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename Real, typename Sign>
int launch(const void* re, const void* im, const void* signs, float* out, double* ws,
           int* counters, const Plan& p, int cols, int col_tiles, int row_slices,
           cudaStream_t st) {
  const dim3 grid(col_tiles, row_slices);
  const int threads = p.groups * p.row_lanes;
  const Real* r = static_cast<const Real*>(re);
  const Real* i = static_cast<const Real*>(im);
  const Sign* s = static_cast<const Sign*>(signs);
  if (cols == 2)
    return launch_kernel(zexp_kernel<Real, Sign, 2>, grid, threads, p.cluster, st, r, i, s, out,
                         ws, counters, p);
  return launch_kernel(zexp_kernel<Real, Sign, 1>, grid, threads, p.cluster, st, r, i, s, out, ws,
                       counters, p);
}

}  // namespace

// C interface for ctypes.  re, im: (dim, T) contiguous planes of float32
// (plane_bytes 4) or float64 (8); signs: (n, dim) contiguous float32
// (sign_bytes 4) or float64 (8); out: (n, T) contiguous float32, fully
// written.  The launch plan (cols, groups, row_lanes, col_tiles, row_slices,
// slice_rows, cluster) comes from ops/zexp.py::zexp_launch_plan; slices past
// the last row are empty.  With K = row_slices / cluster > 1, `ws` (16-byte
// aligned) holds ws_doubles >= stride * col_tiles * K float64, stride =
// n*groups*cols rounded up to even, and `counters` n_counters >= col_tiles
// int32, all 0 before the launch (the kernel leaves them 0); otherwise both
// may be null.  Launches on `stream` and returns the CUDA error code (0 = ok).
extern "C" int qst_z_expectations_f32(const void* re, const void* im, const void* signs,
                                      float* out, double* ws, long long ws_doubles,
                                      int* counters, int n_counters, int n, int dim, int T,
                                      int cols, int groups, int row_lanes, int col_tiles,
                                      int row_slices, int slice_rows, int cluster,
                                      int plane_bytes, int sign_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n < 1 || n > MAX_SITES || dim < 1 || T < 1) return bad;
  if ((plane_bytes != 4 && plane_bytes != 8) || (sign_bytes != 4 && sign_bytes != 8)) return bad;
  if (cols != 1 && cols != 2) return bad;
  if (cols == 2 && (T % 2 != 0 || reinterpret_cast<uintptr_t>(re) % (2 * plane_bytes) != 0 ||
                    reinterpret_cast<uintptr_t>(im) % (2 * plane_bytes) != 0))
    return bad;
  if (groups < 1 || row_lanes < 1 || groups * row_lanes > MAX_THREADS) return bad;
  const long long tile = static_cast<long long>(groups) * cols;
  if (tile > MAX_TILE_COLS) return bad;
  if (col_tiles < 1 || col_tiles * tile < T || (col_tiles - 1) * tile >= T) return bad;
  if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0) return bad;
  if (row_slices < 1 || row_slices > 65535 || row_slices % cluster != 0 || slice_rows < 1 ||
      static_cast<long long>(row_slices) * slice_rows < dim ||
      static_cast<long long>(row_slices) * slice_rows >= (1LL << 31))
    return bad;
  const int K = row_slices / cluster;
  if (row_slices > 1 && K > 1) {
    const long long stride = (static_cast<long long>(n) * tile + 1) / 2 * 2;
    if (ws == nullptr || counters == nullptr || ws_doubles < stride * col_tiles * K ||
        reinterpret_cast<uintptr_t>(ws) % 16 != 0 || n_counters < col_tiles)
      return bad;
  }
  const Plan p{n, dim, T, groups, row_lanes, slice_rows, cluster};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bytes == 8)
    return sign_bytes == 8
               ? launch<double, double>(re, im, signs, out, ws, counters, p, cols, col_tiles,
                                        row_slices, st)
               : launch<double, float>(re, im, signs, out, ws, counters, p, cols, col_tiles,
                                       row_slices, st);
  return sign_bytes == 8
             ? launch<float, double>(re, im, signs, out, ws, counters, p, cols, col_tiles,
                                     row_slices, st)
             : launch<float, float>(re, im, signs, out, ws, counters, p, cols, col_tiles,
                                    row_slices, st);
}
