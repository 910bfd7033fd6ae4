// The Hopper core of the bf16 champion scans (sm_90a): `wgmma` fed by a
// TMA ring with a producer warp.  packed2k_best.cu instantiates it; the
// other instances of bf16_scan.cuh (packed3 and the superseded packed
// forms, tile_champions, argmin2, argmin_bf16) are to move onto it.
//
// It implements packed2k's point of bf16_scan.cuh's axes (one pass, the
// norm in W's lanes, the global champion); the instance that moves here
// next adds its passes, norm term or epilogue as template parameters.
//
// What bounds a scan on this card, and what the design does about it:
// - Bytes: the DB streams once per call (level 0 of npr_1024: 1,048,576
//   rows x 448 used bytes = 140 us at 3.35 TB/s).  One producer warp keeps
//   a ring of up to MAX_STAGES DB tiles in flight with TMA
//   (`cp.async.bulk.tensor.2d`, full/empty mbarriers), so no consumer
//   thread spends an instruction or a register on the copy, and the grid
//   is sized to about one block per SM: each block walks one long run of
//   tiles, so the ring's fill is paid once per SM.
// - Operations: 2 M N k_used bf16 products (M = 344: 163 us at 989
//   TFLOP/s).  Up to three consumer warpgroups each own 64 query rows and
//   run `wgmma.mma_async m64n64k16` with both operands read from shared
//   memory by the tensor cores (no ldmatrix, no per-thread shared loads):
//   the query rows are loaded once per block by TMA and stay resident.
// - L2 -> SM traffic: every query tile's blocks read every DB tile, so a
//   call moves (query tiles) x the DB from L2 to the SMs, and on the card
//   that runs at about 4 TB/s.  So a block takes as many query rows as it
//   can (three warpgroups: 192 rows, two tiles at M = 344 instead of
//   three), the tiles are cut evenly (blocks of equal work stay in step,
//   and the later ones find each DB tile still in L2), and where the
//   queries of three warpgroups leave no room for a ring of two stages
//   (k_used > 352) a block takes two.
// - Lanes: k_used (a multiple of 16) is cut into 32-lane boxes with the
//   64-byte swizzle (a 64-byte box row is the swizzle span), so at k_used =
//   224 exactly the 448 used bytes of a row are read: the 128-byte swizzle
//   would read 64-lane boxes, 512 bytes a row, +14% bytes.  A k_used that
//   is an odd multiple of 16 reads 16 unused lanes in its last box and
//   skips them in the product.
// - Registers: 12 consumer warps + 1 producer warp = 416 threads, so the
//   compiler may give each up to 152 registers; a consumer needs its 32
//   accumulators, 4 champion registers and addresses, far below that, so
//   no `setmaxnreg` rebalancing is needed (and the producer is one warp,
//   not a warpgroup, so it holds little to give).
//
// The wgmma accumulator of m64nNk16 puts, in each warp's 16 rows, rows g
// and g+8 and columns 2 tig, 2 tig + 1 of every 8-column block in one
// thread (g = lane / 4, tig = lane % 4) -- the mma.sync layout -- so the
// fold and the quad reduce are bf16_scan.cuh's.  Within a thread the
// columns arrive in increasing DB row order, so a strict `>` keeps the
// lowest row of equal scores; the quad reduce and the merge use the full
// lexicographic (score, lowest index) rule.  Rows past N (the TMA box past
// the tensor's end reads zeros, which would score 0) are masked.

#pragma once

#include <cuda.h>

#include "bf16_scan.cuh"

namespace ia_hopper {

constexpr int CONSUMERS = 3;                     // consumer warpgroups, most
constexpr int WG_ROWS = 64;                      // query rows a warpgroup
constexpr int BN = 64;                           // DB rows a stage
constexpr int BOX = 32;                          // lanes a TMA box
constexpr int BOX_BYTES = 64 * BOX * 2;          // a box of 64 rows
constexpr int THREADS = 128 * CONSUMERS + 32;    // + the producer warp
constexpr int MAX_STAGES = 8;
constexpr int MAX_KSTEPS = 32;                   // k_used <= 512
constexpr int SMEM_ALIGN = 1024;                 // the swizzle's repeat
// dynamic shared memory a block may take: 227 KiB less room for the
// static barriers
constexpr int SMEM_DYN_MAX = 232448 - 1024;

static_assert(WG_ROWS == BN, "query and DB boxes share one shape");

struct HopperArgs {
  int m, n;
  int consumers;        // consumer warpgroups of a launch, 2..CONSUMERS
  int bm;               // query rows a block, <= 64 consumers
  int nbox;             // ceil(k_used / 32) boxes a row
  int stages;           // ring stages, 1..MAX_STAGES
  int tiles_per_chunk;  // BN-row DB tiles a block
  int smem;             // dynamic shared memory, >= smem_bytes(...)
  float* val;           // partials (n_chunks, m)
  int* idx;
};

// dynamic shared memory a launch needs: the alignment slack, the resident
// query rows of its consumer warpgroups and the ring
inline int smem_bytes(int nbox, int stages, int consumers) {
  return SMEM_ALIGN + (consumers + stages) * nbox * BOX_BYTES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 2-D tensor map (lane c0, row c1) into shared memory,
// completing `bytes` on the barrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand in the 64-byte swizzle: rows of 64
// bytes, 8-row groups 512 bytes apart (SBO); the leading offset is unused
// by swizzled K-major layouts
__device__ __forceinline__ uint64_t desc_sw64(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B^T over one k step, both operands K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// fold one tile's scores into the running champions of rows g and g+8;
// with MASK only the columns c < lim (DB rows below N) count
template <bool MASK>
__device__ __forceinline__ void fold_tile(const float (&d)[32], int gbase,
                                          int lim, float& bv0, int& bi0,
                                          float& bv1, int& bi1) {
  float tv0 = -INFINITY, tv1 = -INFINITY;
  int tc0 = 0, tc1 = 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + e;
      if (!MASK || c < lim) {
        if (d[4 * j + e] > tv0) {
          tv0 = d[4 * j + e];
          tc0 = c;
        }
        if (d[4 * j + 2 + e] > tv1) {
          tv1 = d[4 * j + 2 + e];
          tc1 = c;
        }
      }
    }
  }
  if (tv0 > bv0) {
    bv0 = tv0;
    bi0 = gbase + tc0;
  }
  if (tv1 > bv1) {
    bv1 = tv1;
    bi1 = gbase + tc1;
  }
}

// a position in the ring: stage and the parity of its current phase
struct Ring {
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Grid (query tiles of a.bm rows, DB chunks of tiles_per_chunk tiles);
// THREADS threads: warpgroups 0..a.consumers-1 consume (any past them
// idle), the last warp produces.  KSTEPS = k_used / 16 is a template
// parameter so that a tile's wgmma chain is one branch-free block: with a
// runtime count the compiler fences the accumulators between every two
// wgmma.
template <int KSTEPS>
__global__ void __launch_bounds__(THREADS, 1)
    scan_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap wmap, HopperArgs a) {
  __shared__ __align__(8) uint64_t bars[2 * MAX_STAGES + 1];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + SMEM_ALIGN - 1) & ~uint32_t(SMEM_ALIGN - 1);
  const int stage_bytes = a.nbox * BOX_BYTES;
  const uint32_t q_base = base;
  const uint32_t w_base = base + a.consumers * stage_bytes;
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[MAX_STAGES]);
  const uint32_t qfull = smem_u32(&bars[2 * MAX_STAGES]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * a.bm;
  const int q_end = min(a.m, q0 + a.bm);  // this block's query rows
  // warpgroups with at least one of them
  const int live = min(a.consumers, (q_end - q0 + WG_ROWS - 1) / WG_ROWS);
  const int n_tiles = (a.n + BN - 1) / BN;
  const int t_begin = blockIdx.y * a.tiles_per_chunk;
  const int t_end = min(n_tiles, t_begin + a.tiles_per_chunk);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * live);  // one arrival per warp
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {
    // producer: the resident query rows once, then the ring
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      mbar_expect_tx(qfull, live * stage_bytes);
      for (int wg = 0; wg < live; ++wg)
        for (int b = 0; b < a.nbox; ++b)
          tma_load_2d(q_base + (wg * a.nbox + b) * BOX_BYTES, &qmap, qfull,
                      b * BOX, q0 + wg * WG_ROWS);
      Ring r{0, 0};
      for (int t = t_begin; t < t_end; ++t) {
        // the first pass over the ring finds every stage free
        mbar_wait(empty0 + 8 * r.stage, r.phase ^ 1);
        const uint32_t full = full0 + 8 * r.stage;
        mbar_expect_tx(full, stage_bytes);
        for (int b = 0; b < a.nbox; ++b)
          tma_load_2d(w_base + r.stage * stage_bytes + b * BOX_BYTES, &wmap,
                      full, b * BOX, t * BN);
        r.next(a.stages);
      }
    }
  } else if ((warp >> 2) < live) {
    // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64), those below
    // q_end its own (the rest belong to the next query tile or are past M)
    const int wg = warp >> 2;
    const int g = lane >> 2, tig = lane & 3;
    const int r0 = q0 + wg * WG_ROWS + (warp & 3) * 16 + g, r1 = r0 + 8;
    const uint32_t qa_base = q_base + wg * stage_bytes;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float bv0 = -INFINITY, bv1 = -INFINITY;
    int bi0 = INT_MAX, bi1 = INT_MAX;
    mbar_wait(qfull, 0);
    Ring r{0, 0};
    for (int t = t_begin; t < t_end; ++t) {
      mbar_wait(full0 + 8 * r.stage, r.phase);
      const uint32_t wb = w_base + r.stage * stage_bytes;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        // k step ks: box ks / 2, its 16-lane half ks % 2 (32 bytes in)
        const uint32_t off = (ks >> 1) * BOX_BYTES + (ks & 1) * 32;
        wgmma_m64n64k16(acc, desc_sw64(qa_base + off), desc_sw64(wb + off),
                        ks > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * r.stage);
      r.next(a.stages);
      const int gbase = t * BN + 2 * tig;
      if (t * BN + BN <= a.n) {
        fold_tile<false>(acc, gbase, BN, bv0, bi0, bv1, bi1);
      } else {
        fold_tile<true>(acc, gbase, a.n - gbase, bv0, bi0, bv1, bi1);
      }
    }
    // the four threads of a row group hold disjoint columns
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov0 = __shfl_xor_sync(0xffffffffu, bv0, off);
      const int oi0 = __shfl_xor_sync(0xffffffffu, bi0, off);
      const float ov1 = __shfl_xor_sync(0xffffffffu, bv1, off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, bi1, off);
      ia_scan::fold(bv0, bi0, ov0, oi0);
      ia_scan::fold(bv1, bi1, ov1, oi1);
    }
    if (tig == 0) {
      const size_t o = (size_t)blockIdx.y * a.m;
      if (r0 < q_end) {
        a.val[o + r0] = bv0;
        a.idx[o + r0] = bi0;
      }
      if (r1 < q_end) {
        a.val[o + r1] = bv1;
        a.idx[o + r1] = bi1;
      }
    }
  }
  // the warps of a warpgroup with no row of this tile have nothing to do
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a (rows, k) row-major bf16 array, boxes of 32 lanes x
// 64 rows in the 64-byte swizzle; reads past the last row give zeros
inline int bf16_rows_map(CUtensorMap* map, const void* ptr, int rows,
                         int k) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {BOX, 64};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One champion scan over grid (ceil(m / a.bm), n_chunks), then the merge
// of the partials; returns the first CUDA error.  The shared memory limit
// is raised on every launch: the attribute belongs to the current device.
template <int KSTEPS>
int launch_best(const void* qa, const void* w, int k, HopperArgs a,
                int n_chunks, int* out_idx, float* out_val,
                cudaStream_t s) {
  CUtensorMap qmap, wmap;
  int e = bf16_rows_map(&qmap, qa, a.m, k);
  if (e != cudaSuccess) return e;
  e = bf16_rows_map(&wmap, w, a.n, k);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(scan_kernel<KSTEPS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           a.smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.m + a.bm - 1) / a.bm, n_chunks);
  scan_kernel<KSTEPS><<<grid, THREADS, a.smem, s>>>(qmap, wmap, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ia_scan::best_merge_kernel<<<a.m, 32, 0, s>>>(a.val, a.idx, a.m, n_chunks,
                                                out_idx, out_val);
  return cudaGetLastError();
}

// launch_best of the instance with ksteps = k_used / 16 k steps (1..32)
template <int KSTEPS = 1>
int launch_best_k(int ksteps, const void* qa, const void* w, int k,
                  HopperArgs a, int n_chunks, int* out_idx, float* out_val,
                  cudaStream_t s) {
  if constexpr (KSTEPS > MAX_KSTEPS) {
    return cudaErrorInvalidValue;
  } else {
    if (ksteps == KSTEPS)
      return launch_best<KSTEPS>(qa, w, k, a, n_chunks, out_idx, out_val, s);
    return launch_best_k<KSTEPS + 1>(ksteps, qa, w, k, a, n_chunks, out_idx,
                                     out_val, s);
  }
}

}  // namespace ia_hopper
