// Exact int8 GEMM, C (M, N) int32 = A (M, K) int8 @ B (K, N) int8, for Hopper
// (sm_90a), on the int8 tensor cores through `wgmma`.
//
// Replaces no Pallas kernel.  The JAX package runs every limb-pair product of
// its limb tiers (the ext chain and advance, the Ozaki products) as an XLA
// dot `s8 x s8 -> s32`; the port called `torch._int_mm`, which cuBLASLt
// served with an sm80 `mma.sync` kernel (`cutlass_80_tensorop_i16832gemm_s8`)
// at about 47% of the card's int8 rate, and with a `wmma` kernel where N is
// padded to 8.  `wgmma` is the only way to the full rate.  Int32 sums are exact
// in any order while the callers' headroom asserts hold, so C equals
// `torch._int_mm`'s result bit for bit, whatever the tiling or split of K.
//
// Bound.  Operations: 2 M K N at the int8 tensor cores' 1,979 TOP/s (dense,
// H100 SXM at 700 W).  The main path (ops/extprec.py::ext_cmatmul) has M 8192,
// N 512 (a column panel) and K from 8192 to 122,880 (1 to 15 limb pairs of one
// significance diagonal): 0.52 ms of operations at the longest K, against
// 0.30 ms to read A (1 GB) once from HBM at 3.35 TB/s.  So the kernel is bound
// by the tensor cores only if each A tile leaves HBM once.  For N <= 64 (the
// first doubling passes of the chain) A's bytes bound it instead.
//
// Design.
//   * Layout.  Both operands are K-major in device memory on every call path:
//     A an (M, L K) row-major limb stack sliced along K, B the transpose of a
//     K-contiguous (N, L K) copy.  K-major is the only layout int8 `wgmma`
//     takes, so neither operand is transposed or copied.  The Tensor Memory
//     Accelerator (TMA) reads 128-byte K slices of both (2-D tensor maps over
//     rows of lda and ldb bytes, 128-byte swizzle) into shared memory; its
//     zero fill outside the matrix takes ragged M, N and K, and the stores
//     are masked, so no padded copy is made.  Base pointers and row strides
//     must be 16-byte aligned (the wrapper checks).
//   * A block: one producer warpgroup, of which one thread issues the TMA
//     copies, and two consumer warpgroups, each issuing
//     `wgmma.mma_async.m64nBNk32.s32.s8.s8` over 64 rows of a 128 x BN tile
//     with a 64 x BN int32 accumulator in registers (128 a thread at BN 256).
//     A ring of STAGES slots (A 16 KB + B BN x 128 bytes each; 4 x 48 KB at
//     BN 256) with a full and an empty mbarrier per slot: the consumers keep
//     one stage of `wgmma` in flight and release the slot before it.  At BN
//     256 ptxas fits a thread in 154 registers without spills, under the 168
//     that 384 threads leave each, so no registers are moved from the
//     producer to the consumers (`setmaxnreg`).
//   * Tiles.  BN 256 for N > 128, 128 for 64 < N <= 128 ("wide"); the smallest
//     of 8, 16, 32, 64 that holds N for N <= 64 ("narrow": one pass over A,
//     since one tile holds every column).  The block index walks groups of 16
//     row-blocks with their N-tiles, so the blocks that share an A row-block
//     (and a B column-block) run at the same time and the second read of a
//     tile comes from L2: at N 512 the whole grid (64 x 2 tiles) is one wave.
//   * Split K.  Where the tiles leave SMs idle (N <= 256 at M 8192, and every
//     narrow shape), the grid's z axis splits K into equal runs of 128-byte
//     slices and the blocks add their sums into a zeroed C with int32 atomics
//     (exact in any order, so two calls are equal bit for bit).  The tile
//     sizes and the split come from the shapes alone:
//     ops/int8_gemm.py::int8_gemm_plan.
//   * The kernel allocates nothing; the wrapper allocates C.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                 // rows of a block tile: two consumer warpgroups of 64
constexpr int BK = 128;                 // bytes of K per stage: one 128-byte swizzle row
constexpr int CONSUMERS = 2;            // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_TILE = BM * BK;         // bytes of one A slot
constexpr int GROUP_M = 16;             // row-blocks per group of the tile walk
constexpr int ALIGN = 1024;             // a 128-byte swizzle atom: 8 rows of 128 bytes

template <int BN>
struct Tile {
  static constexpr bool WIDE = BN >= 128;
  static constexpr int STAGE = A_TILE + BN * BK;  // bytes of one ring slot
  // wide: one block an SM (227 KB); narrow: two, so one block's loads run
  // under the other's first and last stages
  static constexpr int BUDGET = WIDE ? 232448 : 115712;
  static constexpr int FIT = (BUDGET - ALIGN - 256) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int MIN_BLOCKS = WIDE ? 1 : 2;
  static constexpr int SMEM = ALIGN + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(STAGES >= 2 && SMEM <= BUDGET, "ring does not fit");
};

template <int BN>
struct Mma;

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(int32_t* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(int32_t* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(int32_t* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(int32_t* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(int32_t* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(int32_t* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one 128-byte x rows tile of a 2-D tensor map at (k, row) into shared
// memory; the slot's full barrier counts its bytes
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* tm, int k, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of the accumulator across a wgmma
// fence, commit or wait
template <int R>
__device__ __forceinline__ void pin(int32_t* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int BN>
__global__ void __launch_bounds__(THREADS, Tile<BN>::MIN_BLOCKS)
int8_gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                 int32_t* __restrict__ c, int M, int N, int k_tiles, int splits) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t full = base + T::STAGES * T::STAGE;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * T::STAGES;        // empty[s] at empty + 8 s

  // the tile walk: groups of GROUP_M row-blocks, row-blocks fastest in a group
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int tile = blockIdx.x;
  const int per_group = GROUP_M * n_tiles;
  const int first_m = tile / per_group * GROUP_M;
  const int group_m = min(m_tiles - first_m, GROUP_M);
  const int in_group = tile % per_group;
  const int m0 = (first_m + in_group % group_m) * BM;
  const int n0 = in_group / group_m * BN;
  // this block's run of K slices
  const int kt0 = static_cast<int>(static_cast<long long>(k_tiles) * blockIdx.z / splits);
  const int kt1 = static_cast<int>(static_cast<long long>(k_tiles) * (blockIdx.z + 1) / splits);

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t bar = full + 8 * stage;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                     "r"(T::STAGE)
                     : "memory");
        const uint32_t slot = base + stage * T::STAGE;
        tma_tile(slot, &tm_a, kt * BK, m0, bar);
        tma_tile(slot + A_TILE, &tm_b, kt * BK, n0, bar);
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg - 1 owns rows 64 (wg - 1) .. 64 wg - 1 of the tile
  const int row_off = (wg - 1) * 64 * BK;
  int32_t d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = kt0; kt < kt1; ++kt) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t slot = base + stage * T::STAGE;
    const uint64_t da = smem_desc(slot + row_off), db = smem_desc(slot + A_TILE);
    pin<BN / 2>(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) Mma<BN>::run(d, da + 2 * kk, db + 2 * kk);  // +32 bytes of K
    wgmma_commit();
    pin<BN / 2>(d);
    wgmma_wait<1>();  // the previous stage's products are done: release its slot
    pin<BN / 2>(d);
    if (kt > kt0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * prev);
    prev = stage;
    if (++stage == T::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  pin<BN / 2>(d);
  if (kt1 == kt0) return;

  // accumulator: register 4j + (0, 1) at row g, columns 8j + 2t (+1) of the
  // warp's 16 rows; 4j + (2, 3) at row g + 8
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = m0 + (wg - 1) * 64 + ((threadIdx.x & 127) >> 5) * 16 + g;
  const bool atomic = splits > 1, pairs = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M || col >= N) continue;
      int32_t* p = c + static_cast<long long>(row) * N + col;
      const int32_t v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (atomic) {
        atomicAdd(p, v0);
        if (col + 1 < N) atomicAdd(p + 1, v1);
      } else if (pairs) {
        *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
      } else {
        p[0] = v0;
        if (col + 1 < N) p[1] = v1;
      }
    }
  }
}

// A 2-D tensor map of `rows` rows of `inner` int8 values, `stride` bytes
// apart, read in tiles of 128 bytes x box_rows rows with the 128-byte swizzle;
// what lies outside the matrix reads as zero.
cudaError_t tensor_map(CUtensorMap* m, const int8_t* p, long long inner, long long rows,
                       long long stride, int box_rows) {
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
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t boxes[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elems[2] = {1, 1};
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p), dims,
                            strides, boxes, elems, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN>
cudaError_t launch(const int8_t* a, const int8_t* b, int32_t* c, int M, int N, int K,
                   long long lda, long long ldb, int splits, cudaStream_t st) {
  auto kernel = int8_gemm_kernel<BN>;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per device
  static unsigned long long opted_in = 0;  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !((opted_in >> dev) & 1ull)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 64) opted_in |= 1ull << dev;
  }
  CUtensorMap tm_a, tm_b;
  e = tensor_map(&tm_a, a, K, M, lda, BM);
  if (e == cudaSuccess) e = tensor_map(&tm_b, b, K, N, ldb, BN);
  if (e != cudaSuccess) return e;
  const int k_tiles = (K + BK - 1) / BK;
  const dim3 grid(((M + BM - 1) / BM) * ((N + BN - 1) / BN), 1, splits);
  kernel<<<grid, THREADS, Tile<BN>::SMEM, st>>>(tm_a, tm_b, c, M, N, k_tiles, splits);
  return cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// C interface for ctypes.  a: M rows of K int8 values, lda bytes apart; b: N
// rows of K int8 values (the columns of the (K, N) operand), ldb bytes apart;
// c: (M, N) contiguous int32, zeroed by the caller when splits > 1 (the
// blocks add into it), fully written otherwise.  bn and splits from
// ops/int8_gemm.py::int8_gemm_plan.  Launches on `stream` and returns the
// CUDA error code (0 = ok).
extern "C" int qst_int8_gemm(const int8_t* a, const int8_t* b, int32_t* c, int M, int N, int K,
                             long long lda, long long ldb, int bn, int splits, void* stream) {
  const long long k_tiles = (static_cast<long long>(K) + BK - 1) / BK;
  const long long tiles = ((static_cast<long long>(M) + BM - 1) / BM) * ((N + bn - 1) / bn);
  if (M < 1 || N < 1 || K < 1 || lda < K || ldb < K || lda % 16 || ldb % 16 || !aligned(a) ||
      !aligned(b) || splits < 1 || splits > k_tiles || splits > 65535 || tiles > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 256: return static_cast<int>(launch<256>(a, b, c, M, N, K, lda, ldb, splits, st));
    case 128: return static_cast<int>(launch<128>(a, b, c, M, N, K, lda, ldb, splits, st));
    case 64: return static_cast<int>(launch<64>(a, b, c, M, N, K, lda, ldb, splits, st));
    case 32: return static_cast<int>(launch<32>(a, b, c, M, N, K, lda, ldb, splits, st));
    case 16: return static_cast<int>(launch<16>(a, b, c, M, N, K, lda, ldb, splits, st));
    case 8: return static_cast<int>(launch<8>(a, b, c, M, N, K, lda, ldb, splits, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
