// Per-site x/y/z and norm^2 sums per limb-pair significance diagonal, straight
// from int8 ext limb planes, for Hopper (sm_90a), on the int8 tensor cores.
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
// The sums as Grams.  For one column, site k's x and y are the diagonal sums
// (over j + i = s) of the limb Gram [R_a; I_a] [R_b; I_b]^T with K = the
// level pairs, and its z and the norm those of the self-Grams P(X) =
// R_X R_X^T + I_X I_X^T over the level-0 rows (G_aa) and over all rows (N):
// z = 2 G_aa - N.  Each is a run of `mma.sync.m16n8k32.s8.s8.s32` (M, N =
// limbs, K = 32 rows a step) whose int32 fragments are reduced to diagonals
// once per column.  Per 32 level pairs of a site:
//   C1 = [Ra0..7; Ia0..7] x [Rb0..7]   rows 0-7 x+ (Ra Rb), rows 8-15 y- (Ia Rb)
//   C2 = [Ra0..7; Ia0..7] x [Ib0..7]   rows 0-7 y+ (Ra Ib), rows 8-15 x+ (Ia Ib)
//   C3 = [Ha; 0] x Gb  +  [0; Hb] x Ga with H = [R8,R9,R10,I8,I9,I10] and
//        G = [R0..3, I0..3]: the 12 pairs with a limb >= 8 (j + i <= 10 puts
//        the other limb <= 2), both orientations in one fragment (the zero
//        halves of A keep them apart);
//   G_aa = [Ra0..7; Ra8..10] x [Ra0..7] + [Ia0..7; Ia8..10 (rows 11-13)] x
//        [Ia0..7]: symmetric, so one 8-wide tile covers the triangle (an entry
//        with a limb >= 8 counts twice, for itself and its mirror).
// Every C entry is one (kind, j, i) product sum; the reduction adds it, with
// its sign, into diagonal j + i (entries with j + i >= n_diag are dropped).
// 6 mma per 32 level pairs and site, 2 per 32 rows for N: 10.5 K mma a
// column at dim 8192.  Signs come from subtracting int32 results (y, z),
// never from negating int8 operands.
//
// Bound.  The function reads 2 * n_diag * dim * T bytes of limbs once (3.69
// GB at the n12 path's (15, 8192, 20480): 1.10 ms at 3.35 TB/s); its 775 G
// int32 operations take 0.39 ms at the int8 tensor cores' 1,979 TOP/s (the
// Grams compute ~2.3x the pairs needed: 0.9 ms of mma at that rate), so HBM
// bounds the least time.  The earlier SIMT design (experiments/
// torch_ext_obs_simt.cu) spent one int32 multiply-add per pair product and
// re-read each limb byte once per site from L2.
//
// Design: one column per block, all of its rows in shared memory.
//   - Staging.  A cluster of 16 blocks owns 16 adjacent columns.  Each warp
//     asks the Tensor Memory Accelerator for 16-column x 128-row tiles of the
//     limb planes (a 2-D tensor map over (L * dim) rows of T bytes), one at a
//     time into its own 2 KB ring slot, waits on the slot's mbarrier, and its
//     lane 4G + Q transposes columns 4Q .. 4Q + 3 of rows 16G .. 16G + 15 in
//     registers (`__byte_perm`, 8 per 4 x 4 bytes) and stores each column's
//     16 bytes into that column's block through distributed shared memory.
//     So each limb byte leaves HBM once, and each block holds its column as
//     [plane][row] rows of dim bytes: K-major, as the int8 `mma` operands
//     must be.  (sm_90 has no 8-bit `ldmatrix` transpose, and `wgmma` takes
//     8-bit operands only K-major.)  Where T % 16 != 0, dim < 16, a pointer
//     is not 16-byte aligned, the cluster stages one byte at a time instead.
//     A card that cannot place a cluster of 16 such blocks refuses the
//     launch, and the wrapper raises with its CUDA error.
//   - Partners.  With the whole column in shared memory every partner row
//     is local: site k's 32 level pairs at a time are two 16-row chunks of
//     level-0 rows and the same chunks + 2^(n-1-k), read by `ldmatrix` (b16,
//     untransposed: 16 bytes of K a row).  For the four sites whose stride
//     DR is below 16 the pairs lie inside each 16-byte row: two 32-row blocks
//     are read and their level-0 bytes compacted into A, the partners' into
//     B (`__byte_perm` for DR 1 and 2, `shfl` from lanes t ^ 1, t ^ 2 for 4
//     and 8), again 32 level pairs per 6 mma.
//   - Work.  16 warps share the column's mma units (the sites' in order,
//     split evenly, so a warp serves one or two sites) and the norm's; a warp
//     reduces its fragments once per site into shared memory with integer
//     atomics (exact, so the order does not matter: two calls are equal bit
//     for bit), and the block writes the column's n_diag x R sums.
//     tests/test_torch_ext_obs.py mirrors this unit plan in Python and checks
//     that it visits every (site, level pair) and norm row once.
//   - Shared memory: 23 plane slots (R limb j at j, I limb j at 12 + j) of
//     max(dim, 64) + 16 bytes after the scratch and the 32 KB staging ring:
//     218 KB at dim 8192, one block per SM.  The 16-byte pad puts the 8 rows
//     of every `ldmatrix` matrix in 8 bank groups.  Limb planes >= n_diag and
//     rows >= dim are zero.  dim <= 8192.
//   - Measured (experiments/torch_ext_obs_variants.py, H100 SXM at 700 W, at
//     the path's shape): a block's staging and its mma do not overlap (its
//     shared memory holds one column); staging alone takes ~4.5 ms, the mma
//     phase alone ~5.7 ms, the kernel ~9 ms.  The tiles are 16 bytes wide,
//     half a 32-byte sector: plain 16-byte loads of them took ~5.5 ms, as
//     long from L2 as from HBM (bound by the requests an SM keeps in
//     flight); two 64-row ring slots a warp were no faster than one of 128
//     rows, and prefetching the next wave's tiles into L2 was slower (both
//     tried and dropped).  The
//     first version of the mma loops was bound by issue (a branch per
//     register in the strides-below-16 partner swap, ~10 instructions an
//     mma), not by the tensor cores.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_DIAG = 11;   // the JAX package's _EXT_OBS_Q
constexpr int MAX_SITES = 13;  // dim <= 8192: one column's limbs fit in shared memory
constexpr int THREADS = 512;
constexpr int CS = 16;  // blocks (columns) of a cluster
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 23;   // plane slots: R limb j at j, I limb j at I_SLOT + j
constexpr int I_SLOT = 12;
constexpr int ROW_PAD = 16;
// shared int scratch: x, y per (site, diagonal), G_aa per (site, diagonal), N
constexpr int XY_INTS = MAX_SITES * 2 * MAX_DIAG;
constexpr int GAA_INTS = MAX_SITES * MAX_DIAG;
constexpr int SCRATCH_BYTES = ((XY_INTS + GAA_INTS + MAX_DIAG) * 4 + 127) / 128 * 128;
// staging ring: one tile slot per warp, a tile = 16 columns x BOX rows of one
// limb plane (BOX = min(dim, MAX_BOX)), then one mbarrier per slot
constexpr int MAX_BOX = 128;
constexpr int SLOT_BYTES = 16 * MAX_BOX;
constexpr int RING_BYTES = WARPS * SLOT_BYTES;
constexpr int PLANES_OFFSET = SCRATCH_BYTES + RING_BYTES + WARPS * 8;

__host__ __device__ constexpr int plane_stride(int dim) { return (dim > 64 ? dim : 64) + ROW_PAD; }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One 32-row block of a column: f = `ldmatrix` of [R0..7; I0..7] (A rows, K
// 0-15 then 16-31), hg = H then G (8 rows each, K 0-15 then 16-31).
struct Blk {
  uint32_t f[4], hg[4];
};

// Accumulators of one site: the x/y Grams C1, C2 and C3 (its two halves in
// separate registers, so that consecutive mma do not wait on each other) and
// G_aa (R and I parts apart, likewise); the halves are added at the flush.
struct Acc {
  int c1[4], c2[4], c3a[4], c3b[4], gr[4], gi[4];
};

// Per-lane `ldmatrix` row addresses (lane l feeds row l & 7 of matrix l >> 3).
struct Lane {
  uint32_t f, hg;  // slot offsets in bytes
  bool f_hi, hg_hi;  // which 16-row chunk of the block the lane's row reads
};

__device__ __forceinline__ Lane lane_rows(int lane, int ps) {
  const int mat = lane >> 3, row = lane & 7;
  // H = R8 R9 R10 I8 I9 I10, then R3 and R7 (rows whose products are dropped);
  // G = R0 R1 R2 R3 I0 I1 I2 I3
  const int h_slot = row < 3 ? 8 + row : row < 6 ? I_SLOT + 5 + row : (row == 6 ? 3 : 7);
  const int g_slot = row < 4 ? row : I_SLOT + row - 4;
  Lane l;
  l.f = static_cast<uint32_t>(((mat & 1) ? I_SLOT + row : row) * ps);
  l.f_hi = (mat & 2) != 0;
  l.hg = static_cast<uint32_t>((mat < 2 ? h_slot : g_slot) * ps);
  l.hg_hi = (mat & 1) != 0;
  return l;
}

__device__ __forceinline__ void load_blk(Blk& b, uint32_t base, const Lane& l, int lo, int hi) {
  ldsm_x4(b.f, base + l.f + static_cast<uint32_t>(l.f_hi ? hi : lo));
  ldsm_x4(b.hg, base + l.hg + static_cast<uint32_t>(l.hg_hi ? hi : lo));
}

// P(X) over the block's rows, A = `a` (masked or not), B = `x`: C rows 0-7 are
// limbs 0-7 (R R + I I), rows 8-10 R8..10 x R, rows 11-13 I8..10 x I.
__device__ __forceinline__ void self_gram(int (&cr)[4], int (&ci)[4], const Blk& a, const Blk& x,
                                          int g) {
  const bool r_row = g < 3, i_row = g >= 3 && g < 6;  // H row g is R8+g, I8+(g-3), dropped
  mma(cr, a.f[0], r_row ? a.hg[0] : 0u, a.f[2], r_row ? a.hg[1] : 0u, x.f[0], x.f[2]);
  mma(ci, a.f[1], i_row ? a.hg[0] : 0u, a.f[3], i_row ? a.hg[1] : 0u, x.f[1], x.f[3]);
}

// x/y Grams of level-0 rows `a` against their partners `b` (aligned by K).
__device__ __forceinline__ void cross_grams(Acc& acc, const Blk& a, const Blk& b) {
  mma(acc.c1, a.f[0], a.f[1], a.f[2], a.f[3], b.f[0], b.f[2]);
  mma(acc.c2, a.f[0], a.f[1], a.f[2], a.f[3], b.f[1], b.f[3]);
  mma(acc.c3a, a.hg[0], 0u, a.hg[1], 0u, b.hg[2], b.hg[3]);
  mma(acc.c3b, 0u, b.hg[0], 0u, b.hg[1], a.hg[2], a.hg[3]);
}

// For a site of stride DR < 16 the pairs lie inside each 16-byte row of a
// block.  Two words of a lane (the same matrix row in chunks lo and hi) give
// one word of 4 level-0 bytes (a) and one of their partners' (b), aligned:
// bytes picked with `__byte_perm` for strides 1 and 2, quads taken from the
// lanes t ^ 1, t ^ 2 of the same row (`shfl`) for 4 and 8.
template <int DR>
__device__ __forceinline__ void compact(uint32_t lo, uint32_t hi, int lane, uint32_t& a, uint32_t& b) {
  const int t = lane & 3;
  if constexpr (DR == 1) {
    a = __byte_perm(lo, hi, 0x6420);
    b = __byte_perm(lo, hi, 0x7531);
  } else if constexpr (DR == 2) {
    a = __byte_perm(lo, hi, 0x5410);
    b = __byte_perm(lo, hi, 0x7632);
  } else if constexpr (DR == 4) {  // level-0 quads t = 0, 2 of lo, then of hi
    const int src = (lane & ~3) | ((t & 1) << 1);
    const uint32_t al = __shfl_sync(0xffffffffu, lo, src), ah = __shfl_sync(0xffffffffu, hi, src);
    const uint32_t bl = __shfl_sync(0xffffffffu, lo, src + 1), bh = __shfl_sync(0xffffffffu, hi, src + 1);
    a = t < 2 ? al : ah;
    b = t < 2 ? bl : bh;
  } else {  // DR == 8: level-0 quads t = 0, 1 of lo, then of hi
    const uint32_t lx = __shfl_xor_sync(0xffffffffu, lo, 2), hx = __shfl_xor_sync(0xffffffffu, hi, 2);
    a = t < 2 ? lo : hx;
    b = t < 2 ? lx : hi;
  }
}

// 32 level pairs of a site of stride DR < 16: the rows of blocks x (k 0-15 of
// the fragments) and y (k 16-31), compacted into level-0 rows `a` and their
// partners `b`.
template <int DR>
__device__ __forceinline__ void compact_blocks(const Blk& x, const Blk& y, int lane, Blk& a, Blk& b) {
  compact<DR>(x.f[0], x.f[2], lane, a.f[0], b.f[0]);
  compact<DR>(x.f[1], x.f[3], lane, a.f[1], b.f[1]);
  compact<DR>(y.f[0], y.f[2], lane, a.f[2], b.f[2]);
  compact<DR>(y.f[1], y.f[3], lane, a.f[3], b.f[3]);
  compact<DR>(x.hg[0], x.hg[1], lane, a.hg[0], b.hg[0]);
  compact<DR>(y.hg[0], y.hg[1], lane, a.hg[1], b.hg[1]);
  compact<DR>(x.hg[2], x.hg[3], lane, a.hg[2], b.hg[2]);
  compact<DR>(y.hg[2], y.hg[3], lane, a.hg[3], b.hg[3]);
}

__device__ __forceinline__ void zero(int (&c)[4]) { c[0] = c[1] = c[2] = c[3] = 0; }

// Add a symmetric self-Gram fragment (its R and I parts) into its diagonals.
__device__ __forceinline__ void flush_sym(const int (&cr)[4], const int (&ci)[4], int* diag, int nd,
                                          int g, int t) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    if (m >= 14) continue;
    const int j = m < 11 ? m : m - 3;
    const int s = j + col, v = cr[e] + ci[e];
    if (s < nd && v != 0) atomicAdd(&diag[s], j >= 8 ? 2 * v : v);
  }
}

// Add a warp's x/y/G_aa fragments of one site into its diagonals.
__device__ __forceinline__ void flush_site(const Acc& acc, int* xs, int* ys, int* gaa, int nd, int g,
                                           int t) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    {  // C1: a-side [R; I] limb m & 7 times b-side R limb col
      const int s = (m & 7) + col;
      if (s < nd) {
        if (m < 8) atomicAdd(&xs[s], acc.c1[e]);
        else atomicAdd(&ys[s], -acc.c1[e]);
      }
    }
    {  // C2: times b-side I limb col
      const int s = (m & 7) + col;
      if (s < nd) {
        if (m < 8) atomicAdd(&ys[s], acc.c2[e]);
        else atomicAdd(&xs[s], acc.c2[e]);
      }
    }
    {  // C3: rows 0-5 a-side H x b-side G, rows 8-13 b-side H x a-side G
      const int mm = m & 7;
      if (mm < 6) {
        const bool h_im = mm >= 3, g_im = col >= 4;
        const int s = 8 + mm % 3 + (col & 3);
        const bool a_im = m < 8 ? h_im : g_im, b_im = m < 8 ? g_im : h_im;
        const int v = acc.c3a[e] + acc.c3b[e];  // one of the two is 0 here
        if (s < nd) {
          if (a_im == b_im) atomicAdd(&xs[s], v);
          else if (b_im) atomicAdd(&ys[s], v);  // Ra Ib
          else atomicAdd(&ys[s], -v);           // Ia Rb
        }
      }
    }
  }
  flush_sym(acc.gr, acc.gi, gaa, nd, g, t);
}

// 4 words (4 rows of 4 bytes) -> 4 words (4 columns of 4 rows), in place.
__device__ __forceinline__ void transpose4(uint32_t& x0, uint32_t& x1, uint32_t& x2, uint32_t& x3) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140), t1 = __byte_perm(x0, x1, 0x7362);
  const uint32_t t2 = __byte_perm(x2, x3, 0x5140), t3 = __byte_perm(x2, x3, 0x7362);
  x0 = __byte_perm(t0, t2, 0x5410);
  x1 = __byte_perm(t0, t2, 0x7632);
  x2 = __byte_perm(t1, t3, 0x5410);
  x3 = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_tile(uint32_t slot, uint32_t bar, const CUtensorMap* tm, int col,
                                         int row, int bytes) {
  // the slot's last reads (generic proxy) come before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(slot),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// Staging: the cluster's 16-column x BOX-row tiles of every limb plane < nd,
// a share per warp of each block.  A warp's lane 0 asks the Tensor Memory
// Accelerator for one tile at a time into the warp's ring slot; when it has
// landed, lane 4G + Q (G < BOX/16) transposes columns 4Q .. 4Q + 3 of rows
// 16G .. 16G + 15 in registers (`__byte_perm`) and stores each column's 16
// bytes into that column's block.
__device__ __forceinline__ void stage_tma(cg::cluster_group& cluster, unsigned char* planes,
                                          unsigned char* ring, uint64_t* bars,
                                          const CUtensorMap* tm_re, const CUtensorMap* tm_im,
                                          int dim, int nd, int col0, int rank, int ps, int box) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int boxes = dim / box, tiles = 2 * nd * boxes;
  const unsigned char* slot = ring + warp * SLOT_BYTES;
  const uint32_t slot_s = smem_addr(slot), bar = smem_addr(bars + warp);
  const int G = lane >> 2, Q = lane & 3;
  uint32_t parity = 0;
  for (int it = rank + CS * warp; it < tiles; it += CS * WARPS, parity ^= 1) {
    const int pl = it / boxes, bx = it - pl * boxes;
    if (lane == 0)
      tma_tile(slot_s, bar, (pl & 1) ? tm_im : tm_re, col0, (pl >> 1) * dim + bx * box, 16 * box);
    mbar_wait(bar, parity);
    if (G < box / 16) {
      uint32_t w[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) w[r] = *reinterpret_cast<const uint32_t*>(slot + (16 * G + r) * 16 + 4 * Q);
      // after this, w[4m + b] holds rows 4m..4m+3 of column 4Q + b
#pragma unroll
      for (int m = 0; m < 4; ++m) transpose4(w[4 * m], w[4 * m + 1], w[4 * m + 2], w[4 * m + 3]);
      unsigned char* dst = planes + ((pl & 1) ? I_SLOT + (pl >> 1) : (pl >> 1)) * ps + bx * box + 16 * G;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        uint4* p = reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, 4 * Q + b));
        *p = make_uint4(w[b], w[4 + b], w[8 + b], w[12 + b]);
      }
    }
    __syncwarp();
  }
}

__device__ __forceinline__ void stage_bytes(cg::cluster_group& cluster, unsigned char* planes,
                                            const int8_t* s_re, const int8_t* s_im, int dim, int T,
                                            int nd, int col0, int rank, int ps) {
  const size_t total = static_cast<size_t>(2 * nd) * dim * CS;
  for (size_t f = static_cast<size_t>(rank) * THREADS + threadIdx.x; f < total;
       f += static_cast<size_t>(CS) * THREADS) {
    const int c = static_cast<int>(f % CS);
    const size_t rest = f / CS;
    const int row = static_cast<int>(rest % dim), pl = static_cast<int>(rest / dim);
    const int j = pl >> 1;
    const bool im = (pl & 1) != 0;
    const int col = col0 + c;
    const int8_t v = col < T ? (im ? s_im : s_re)[(static_cast<size_t>(j) * dim + row) * T + col] : 0;
    *cluster.map_shared_rank(planes + (im ? I_SLOT + j : j) * ps + row, c) = static_cast<unsigned char>(v);
  }
}

// 32 level pairs of a site of stride DR < 16 per unit: rows 64u .. 64u + 63
// (two blocks), compacted.
template <int DR>
__device__ __forceinline__ void compact_units(Acc& acc, uint32_t base, const Lane& ln, int lo, int hi,
                                              int lane, int g) {
  for (int u = lo; u < hi; ++u) {
    Blk x, y, a, b;
    load_blk(x, base, ln, 64 * u, 64 * u + 16);
    load_blk(y, base, ln, 64 * u + 32, 64 * u + 48);
    compact_blocks<DR>(x, y, lane, a, b);
    cross_grams(acc, a, b);
    self_gram(acc.gr, acc.gi, a, a, g);
  }
}

// Units of a site: 32 level pairs each.
__device__ __forceinline__ int site_units(int dim) { return max(1, dim / 64); }

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
ext_obs_kernel(const int8_t* __restrict__ s_re, const int8_t* __restrict__ s_im,
               const __grid_constant__ CUtensorMap tm_re, const __grid_constant__ CUtensorMap tm_im,
               int32_t* __restrict__ out, int dim, int T, int n_sites, int R, int nd, int box) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* xy_sm = reinterpret_cast<int*>(smem);  // [site][x, y][diagonal]
  int* gaa_sm = xy_sm + XY_INTS;              // [site][diagonal]
  int* n_sm = gaa_sm + GAA_INTS;              // [diagonal]
  unsigned char* ring = smem + SCRATCH_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + SCRATCH_BYTES + RING_BYTES);
  unsigned char* planes = smem + PLANES_OFFSET;
  const int ps = plane_stride(dim);
  const int tid = threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int col0 = static_cast<int>(blockIdx.x) / CS * CS;
  const int t = col0 + rank;

  // zero what no block of the cluster writes: the scratch, planes of limbs >=
  // nd and (in 16-byte words) the rows >= dim of the others
  for (int i = tid; i < SCRATCH_BYTES / 4; i += THREADS) xy_sm[i] = 0;
  for (int slot = tid >> 5; slot < SLOTS; slot += WARPS) {
    const int j = slot < I_SLOT ? slot : slot - I_SLOT;
    uint4* row = reinterpret_cast<uint4*>(planes + slot * ps);
    for (int w = (j >= nd || dim < 16 ? 0 : dim / 16) + (tid & 31); w < ps / 16; w += 32)
      row[w] = make_uint4(0, 0, 0, 0);
  }
  if (VEC && tid < WARPS) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + tid)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block runs, and its zeros are in, before the cluster writes
  if constexpr (VEC) stage_tma(cluster, planes, ring, bars, &tm_re, &tm_im, dim, nd, col0, rank, ps, box);
  else stage_bytes(cluster, planes, s_re, s_im, dim, T, nd, col0, rank, ps);
  cluster.sync();  // the cluster's rows are in every block's shared memory
  if (t >= T) return;

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const Lane ln = lane_rows(lane, ps);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(planes));

  const int uk = site_units(dim), total = n_sites * uk;
  const int u_begin = warp * total / WARPS, u_end = (warp + 1) * total / WARPS;
  int first = 0;
  for (int k = 0; k < n_sites; ++k) {
    const int sh = n_sites - 1 - k, dr = 1 << sh;
    const int lo = max(u_begin, first) - first, hi = min(u_end, first + uk) - first;
    first += uk;
    if (lo >= hi) continue;
    Acc acc;
    zero(acc.c1); zero(acc.c2); zero(acc.c3a); zero(acc.c3b); zero(acc.gr); zero(acc.gi);
    switch (dr) {
      case 1: compact_units<1>(acc, base, ln, lo, hi, lane, g); break;
      case 2: compact_units<2>(acc, base, ln, lo, hi, lane, g); break;
      case 4: compact_units<4>(acc, base, ln, lo, hi, lane, g); break;
      case 8: compact_units<8>(acc, base, ln, lo, hi, lane, g); break;
      default:
        // 32 level pairs: level-0 rows p = 32u .. 32u + 31 in two 16-row chunks
        for (int u = lo; u < hi; ++u) {
          const int p0 = 32 * u, p1 = p0 + 16;
          const int a0 = ((p0 >> sh) << (sh + 1)) | (p0 & (dr - 1));
          const int a1 = ((p1 >> sh) << (sh + 1)) | (p1 & (dr - 1));
          Blk a, b;
          load_blk(a, base, ln, a0, a1);
          load_blk(b, base, ln, a0 + dr, a1 + dr);
          cross_grams(acc, a, b);
          self_gram(acc.gr, acc.gi, a, a, g);
        }
    }
    flush_site(acc, xy_sm + k * 2 * MAX_DIAG, xy_sm + k * 2 * MAX_DIAG + MAX_DIAG,
               gaa_sm + k * MAX_DIAG, nd, g, tq);
  }
  {  // the norm's self-Gram over all rows, 32 at a time
    const int nb = max(1, dim / 32);
    int cr[4], ci[4];
    zero(cr);
    zero(ci);
    for (int u = warp * nb / WARPS; u < (warp + 1) * nb / WARPS; ++u) {
      Blk x;
      load_blk(x, base, ln, 32 * u, 32 * u + 16);
      self_gram(cr, ci, x, x, g);
    }
    flush_sym(cr, ci, n_sm, nd, g, tq);
  }
  __syncthreads();

  for (int i = tid; i < nd * R; i += THREADS) {
    const int s = i / R, row = i - s * R;
    int v = 0;
    if (row < 3 * n_sites) {
      const int k = row / 3, kind = row - 3 * k;
      v = kind < 2 ? xy_sm[(k * 2 + kind) * MAX_DIAG + s] : 2 * gaa_sm[k * MAX_DIAG + s] - n_sm[s];
    } else if (row == 3 * n_sites) {
      v = n_sm[s];
    }
    out[(static_cast<size_t>(s) * R + row) * T + t] = v;
  }
}

// A 2-D tensor map of one (L, dim, T) int8 stack as (L * dim) rows of T bytes,
// tiles of 16 columns x box rows.
cudaError_t tensor_map(CUtensorMap* m, const int8_t* p, int rows, int T, int box) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                  reinterpret_cast<void**>(&encode),
                                                  cudaEnableDefault, &q);
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return e != cudaSuccess ? e : cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(T)};
  const cuuint32_t boxes[2] = {16, static_cast<cuuint32_t>(box)};
  const cuuint32_t elems[2] = {1, 1};
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p), dims, strides,
                            boxes, elems, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool VEC>
cudaError_t launch(const int8_t* s_re, const int8_t* s_im, int32_t* out, int limbs, int dim, int T,
                   int n_sites, int R, int nd, cudaStream_t st) {
  auto kernel = ext_obs_kernel<VEC>;
  const int smem = PLANES_OFFSET + SLOTS * plane_stride(dim);
  const int box = dim < MAX_BOX ? dim : MAX_BOX;
  CUtensorMap tm_re = {}, tm_im = {};
  if (VEC) {
    cudaError_t e = tensor_map(&tm_re, s_re, limbs * dim, T, box);
    if (e == cudaSuccess) e = tensor_map(&tm_im, s_im, limbs * dim, T, box);
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS * ((T + CS - 1) / CS));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, s_re, s_im, tm_re, tm_im, out, dim, T, n_sites, R, nd, box);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  s_re, s_im: (L, dim, T) contiguous int8 with
// dim = 2^n_sites <= 8192 and L >= n_diag; out: (n_diag, R, T) contiguous
// int32 with R >= 3*n_sites + 1, fully written.  Launches on `stream` and
// returns the launch's CUDA error code (0 = ok).
extern "C" int qst_ext_obs_diagonals(const int8_t* s_re, const int8_t* s_im, int32_t* out,
                                     int limbs, int dim, int T, int n_sites, int R, int n_diag,
                                     void* stream) {
  if (n_diag < 1 || n_diag > MAX_DIAG || limbs < n_diag || n_sites < 1 || n_sites > MAX_SITES ||
      dim != (1 << n_sites) || R < 3 * n_sites + 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = T % 16 == 0 && dim >= 16 &&
                   reinterpret_cast<uintptr_t>(s_re) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(s_im) % 16 == 0;
  const cudaError_t e = vec ? launch<true>(s_re, s_im, out, limbs, dim, T, n_sites, R, n_diag, st)
                            : launch<false>(s_re, s_im, out, limbs, dim, T, n_sites, R, n_diag, st);
  return static_cast<int>(e);
}

