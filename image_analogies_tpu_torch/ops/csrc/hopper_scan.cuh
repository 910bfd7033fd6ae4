// The Hopper core of the bf16 scans (sm_90a): `wgmma` fed by a TMA ring
// with a producer warp.  Every bf16 scan of the port is an instance of it:
// - packed2k_best.cu (the main path: one pass, the norm in W's lanes, the
//   global champion: EpiBest);
// - argmin2.cu (two_pass: the hi/lo query blocks folded, the fp32 norms in
//   the ring, the lexicographic top-2: EpiTop2);
// - packed3_best.cu (exact_hi2 up to 256 lanes: two folded query sets
//   against W1 and a third against a second weight stream W2 (TWO), the
//   norms in the ring, the global champion of dots - norm: EpiBestSub);
// - pertile_champions.cu (scan_rescue: FOLD or one query set, the norms in
//   the ring, one champion of dots - norm per scan tile, written in place:
//   EpiTile);
// - argmin_bf16.cu (batched and rowwise: one query set, the norms in the
//   ring, the global champion of 2 dots - norm: EpiBestL2);
// - the four packed forms the main path superseded, one source each
//   (packed2_best.cu: TWO, EpiBestSub; packed1w_best.cu: FOLD, EpiBestSub;
//   packed2wn_best.cu: TWO, the norm in W's lanes, EpiBest;
//   packed1wn_best.cu: FOLD, EpiBest; entries by `scan_best`);
// - tile_champions.cu (packed_champions: TWO, with or without FOLD, one
//   champion of dots - norm per output tile: EpiTile).
// packed3w_best.cu (packed3 and its per-tile champions past 256 lanes) and
// packed2kw_best.cu (packed2k past 512 lanes) have kernels of their own,
// built from the helpers and epilogues here (their query rows partly in
// registers as the wgmma A operand: wgmma_rs_n32).
//
// What bounds a scan on this card, and what the design does about it:
// - Bytes: the DB streams once per call (level 0 of npr_1024: 1,048,576
//   rows x 448 used bytes = 140 us at 3.35 TB/s).  One producer warp keeps
//   a ring of up to MAX_STAGES DB tiles in flight with TMA
//   (`cp.async.bulk.tensor.2d`, full/empty mbarriers), so no consumer
//   thread spends an instruction or a register on the copy, and the grid
//   is sized to about one block per SM: each block walks one long run of
//   tiles, so the ring's fill is paid once per SM.  A scan with a separate
//   norm array (kNorms) has the producer copy each full tile's fp32 norms
//   into the stage too (a 1-D `cp.async.bulk` on the same full barrier);
//   the ragged last tile reads its norms from global memory.
// - Operations: 2 M N k_used bf16 products per query block (M = 344: 163
//   us at 989 TFLOP/s for packed2k; twice the rows with FOLD, three times
//   with FOLD and TWO).  Up to three
//   consumer warpgroups each own 64 query rows and run
//   `wgmma.mma_async m64nNk16` with both operands read from shared memory
//   by the tensor cores (no ldmatrix, no per-thread shared loads): the
//   query rows (with FOLD the hi and the lo block, with TWO a third block)
//   are loaded once per block by TMA and stay resident.  A tile's products
//   are one chain of dependent steps into one accumulator, and on the card a block's pace
//   followed the chain, not the tensor cores' rate (per 64-row tile of
//   argmin2 about 1,800 cycles with two warpgroups or three): so argmin2
//   takes 128-row tiles (m64n128k16, twice the work a step) where they
//   fit, `tile_rows`.
// - L2 -> SM traffic: every query tile's blocks read every DB tile, so a
//   call moves (query tiles) x the DB from L2 to the SMs, and on the card
//   that runs at about 4 TB/s.  So a block takes as many query rows as it
//   can (three warpgroups: 192 rows, two tiles at M = 344 instead of
//   three), the tiles are cut evenly (blocks of equal work stay in step,
//   and the later ones find each DB tile still in L2), and where the
//   queries of three warpgroups leave no room for a ring of two stages a
//   block takes two (one at the widest folded lanes).
// - Lanes: k_used (a multiple of 16) is cut into 32-lane boxes with the
//   64-byte swizzle (a 64-byte box row is the swizzle span), so at k_used =
//   224 exactly the 448 used bytes of a row are read: the 128-byte swizzle
//   would read 64-lane boxes, 512 bytes a row, +14% bytes.  A k_used that
//   is an odd multiple of 16 reads 16 unused lanes in its last box and
//   skips them in the product.
// - Shared memory: a warpgroup's resident query sets and at least one
//   ring stage must fit in a block's 227 KiB.  Two query sets beside a
//   stage of both weight streams leave no room for 64-row tiles past 448
//   lanes (the packed2 forms and the unfolded champions at 464-512), so
//   those instances take 32-row tiles (m64n32k16), `tile_rows`.
// - Registers: 12 consumer warps + 1 producer warp = 416 threads; ptxas
//   gives each at most 128.  packed2k's instances take 58-96, argmin2's
//   (64 accumulators at 128-row tiles) 96-128 with no spills, packed3's
//   93-128 (its 240- and 256-lane instances spill 12-16 bytes),
//   pertile's 95-128 (128 at every 128-row instance; some unfolded 176-
//   240-lane and folded 304-384-lane ones spill 4-44 bytes),
//   argmin_bf16's 115-128 (two instances spill 8 bytes), so the
//   epilogues hold no score arrays and a second accumulator set (to
//   overlap a tile's epilogue with the next chain) does not fit; the
//   producer is one warp, not a warpgroup, so `setmaxnreg` has little to
//   move.
//
// The wgmma accumulator of m64nNk16 puts, in each warp's 16 rows, rows g
// and g+8 and columns 2 tig, 2 tig + 1 of every 8-column block in one
// thread (g = lane / 4, tig = lane % 4) -- the mma.sync layout.  Within a
// thread the columns arrive in increasing DB row order, so a strict `>`
// keeps the lowest row of equal scores; the quad reduce and the merge use
// the full lexicographic (score, lowest index) rule.  Rows past N (the TMA box past
// the tensor's end reads zeros, which would score 0) are masked.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

// The helpers every scan's entry and merge share: the lexicographic
// (score, lowest index) rule, the merge of per-chunk partials and the
// argument checks.
namespace ia_scan {

__device__ __forceinline__ bool lex_better(float va, int ia, float vb,
                                           int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void fold(float& bv, int& bi, float v, int i) {
  if (lex_better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

// insert (v, i) into the sorted pair (v1, i1) > (v2, i2); keys are distinct
// (the top-2 merge of argmin2.cu and EpiTop2)
__device__ __forceinline__ void fold2(float& v1, int& i1, float& v2, int& i2,
                                      float v, int i) {
  if (lex_better(v, i, v1, i1)) {
    v2 = v1;
    i2 = i1;
    v1 = v;
    i1 = i;
  } else if (lex_better(v, i, v2, i2)) {
    v2 = v;
    i2 = i;
  }
}

// one warp per query: lexicographic maximum over the chunks' partials
__global__ void best_merge_kernel(const float* __restrict__ part_val,
                                  const int* __restrict__ part_idx, int m,
                                  int n_chunks, int* __restrict__ out_idx,
                                  float* __restrict__ out_val) {
  const int gm = blockIdx.x, lane = threadIdx.x;
  float v = -INFINITY;
  int id = INT_MAX;
  for (int c = lane; c < n_chunks; c += 32)
    fold(v, id, part_val[(size_t)c * m + gm], part_idx[(size_t)c * m + gm]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, id, off);
    fold(v, id, ov, oi);
  }
  if (lane == 0) {
    out_idx[gm] = id;
    out_val[gm] = v;
  }
}

inline int use_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device) return cudaSetDevice(device);
  return cudaSuccess;
}

// the argument checks every entry makes: K a multiple of 128 up to kmax
// (512 but for packed2kw_best.cu's 1,152), k_used a multiple of 16 in
// (0, K]
inline bool shape_ok(int m, int n, int k, int k_used, int n_chunks,
                     int kmax = 512) {
  return m > 0 && n > 0 && n_chunks > 0 && k_used > 0 && k_used <= k &&
         k_used % 16 == 0 && k % 128 == 0 && k <= kmax;
}

}  // namespace ia_scan

extern "C" const char* ia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace ia_hopper {

constexpr int CONSUMERS = 3;                     // consumer warpgroups, most
constexpr int WG_ROWS = 64;                      // query rows a warpgroup
constexpr int BOX = 32;                          // lanes a TMA box
constexpr int QBOX_BYTES = WG_ROWS * BOX * 2;    // a query box of 64 rows
constexpr int THREADS = 128 * CONSUMERS + 32;    // + the producer warp
constexpr int MAX_STAGES = 8;
constexpr int MAX_KSTEPS = 32;                   // k_used <= 512
constexpr int SMEM_ALIGN = 1024;                 // the swizzle's repeat
// dynamic shared memory a block may take: 227 KiB less room for the
// static barriers
constexpr int SMEM_DYN_MAX = 232448 - 1024;

struct HopperArgs {
  int m, n;
  int consumers;        // consumer warpgroups of a launch, 1..CONSUMERS
  int bm;               // query rows a block, <= 64 consumers
  int nbox;             // ceil(k_used / 32) boxes a row
  int stages;           // ring stages, 1..MAX_STAGES
  int tiles_per_chunk;  // DB tiles a block
  int smem;             // dynamic shared memory, >= smem_bytes(...)
  const float* norm;    // (n,) fp32 norms of an epilogue with kNorms
  float* val;           // partials (n_chunks, m)
  int* idx;
  float* val2;          // EpiTop2: second place
  int* idx2;
  int tile_sub;         // EpiTile: DB tiles an output tile
};

// resident query sets of a warpgroup: one, a folded second, a third
// against the second weight stream
__host__ __device__ constexpr int query_sets(bool fold, bool two) {
  return 1 + (fold ? 1 : 0) + (two ? 1 : 0);
}

// dynamic shared memory a launch needs: the alignment slack, the resident
// query rows of its consumer warpgroups (`qsets` blocks each), the ring of
// `bn`-row tiles of `streams` weight arrays and, with norms, each stage's
// fp32 norms
__host__ __device__ constexpr int smem_bytes(int nbox, int stages,
                                            int consumers, int qsets,
                                            int streams, bool norms, int bn) {
  return SMEM_ALIGN + consumers * qsets * nbox * QBOX_BYTES +
         stages * (streams * nbox * bn * BOX * 2 + (norms ? bn * 4 : 0));
}

// DB rows a tile (a ring stage): 128 for an epilogue that takes them
// (kWide) up to k_used = 256.  A tile's wgmma chain is 2 KSTEPS (folded)
// dependent steps into one accumulator; at 64 rows a step's latency, not
// the tensor cores, sets the pace, and m64n128k16 does twice the work a
// step.  Past 256 lanes the 128-row stages leave no room.  Else 64 where
// one stage of 64-row tiles of `streams` weight arrays fits beside one
// warpgroup's `qsets` query sets, and 32 where it does not (two sets and
// two streams past 448 lanes).
__host__ __device__ constexpr int tile_rows(bool wide, int ksteps,
                                            int qsets = 1, int streams = 1,
                                            bool norms = false) {
  return wide && ksteps <= 16 ? 128
         : smem_bytes((ksteps + 1) / 2, 1, 1, qsets, streams, norms, 64) <=
                 SMEM_DYN_MAX
             ? 64
             : 32;
}

// the DB rows of a tile of the instance <FOLD, TWO, Epi> at ksteps k steps
template <bool FOLD, bool TWO, class Epi>
__host__ __device__ constexpr int scan_rows(int ksteps) {
  return tile_rows(Epi::kWide, ksteps, query_sets(FOLD, TWO), TWO ? 2 : 1,
                   Epi::kNorms);
}

// the checks every C entry makes of a launch plan
inline bool plan_ok(int n, int bn, int nbox, int consumers, int bm,
                    int stages, int tiles_per_chunk, int smem, int n_chunks,
                    int qsets, int streams, bool norms) {
  const int n_tiles = (n + bn - 1) / bn;
  return consumers >= 1 && consumers <= CONSUMERS && bm >= 1 &&
         bm <= consumers * WG_ROWS && stages >= 1 && stages <= MAX_STAGES &&
         smem >= smem_bytes(nbox, stages, consumers, qsets, streams, norms,
                            bn) &&
         smem <= SMEM_DYN_MAX && tiles_per_chunk >= 1 &&
         (long long)(n_chunks - 1) * tiles_per_chunk < n_tiles &&
         (long long)n_chunks * tiles_per_chunk >= n_tiles;
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

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of global
// memory into shared memory, completing them on the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
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

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B^T over one k step, m64n64k16, both operands K-major in shared
// memory
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
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

// d (+)= A B^T over one k step, m64n128k16, both operands K-major in shared
// memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B^T over one k step, m64n32k16, both operands K-major in shared
// memory
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the wgmma of a tile of N DB rows
template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (N == 128) {
    wgmma_m64n128k16(d, da, db, scale_d);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16(d, da, db, scale_d);
  } else {
    wgmma_m64n32k16(d, da, db, scale_d);
  }
}

// d (+)= A B^T over one k step, m64n32k16, A from registers (the mma.sync
// A fragment of each warp's 16 rows), B in shared memory (packed3w_best.cu,
// packed2kw_best.cu)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&qa)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(qa[0]), "r"(qa[1]), "r"(qa[2]), "r"(qa[3]), "l"(db),
        "r"(scale_d));
}

// the same, m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&qa)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, "
      "0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(qa[0]), "r"(qa[1]), "r"(qa[2]), "r"(qa[3]), "l"(db),
        "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&qa)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, qa, db, scale_d);
  } else {
    wgmma_rs_n32(d, qa, db, scale_d);
  }
}

// The epilogues.  Each folds one tile's accumulators into its state for
// rows g and g+8 (tile<MASK, FIRST, N>: N DB rows a tile; with MASK only
// the columns c < lim, DB rows below N, count; FIRST marks a block's first
// tile), reduces the four threads of a row group, and writes one partial
// per (chunk, row), or with kTile one champion per (output tile, row).
// An epilogue with norms (kNorms) reads the norms of columns 8 j + 2 tig
// and 8 j + 2 tig + 1 from the stage (ns, at 8 tig bytes in) or, for the
// ragged last tile, from global memory (norm).

// the global champion of scores that carry their norm in W's lanes
// (packed2k, packed2wn, packed1wn): the maximum of the dots, lowest index
// on ties
struct EpiBest {
  static constexpr bool kNorms = false;
  static constexpr bool kWide = false;  // 64- or 32-row tiles (tile_rows)
  static constexpr bool kTile = false;  // one write per (chunk, row)
  float bv0 = -INFINITY, bv1 = -INFINITY;
  int bi0 = INT_MAX, bi1 = INT_MAX;

  template <bool MASK, bool FIRST, int N>
  __device__ __forceinline__ void tile(const float (&d)[N / 2], uint32_t,
                                       const float*, int gbase, int lim) {
    float tv0 = -INFINITY, tv1 = -INFINITY;
    int tc0 = 0, tc1 = 0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
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

  __device__ __forceinline__ void reduce_quad() {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov0 = __shfl_xor_sync(0xffffffffu, bv0, off);
      const int oi0 = __shfl_xor_sync(0xffffffffu, bi0, off);
      const float ov1 = __shfl_xor_sync(0xffffffffu, bv1, off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, bi1, off);
      ia_scan::fold(bv0, bi0, ov0, oi0);
      ia_scan::fold(bv1, bi1, ov1, oi1);
    }
  }

  __device__ __forceinline__ void write(const HopperArgs& a, size_t o,
                                        int r0, int r1, int q_end) const {
    if (r0 < q_end) {
      a.val[o + r0] = bv0;
      a.idx[o + r0] = bi0;
    }
    if (r1 < q_end) {
      a.val[o + r1] = bv1;
      a.idx[o + r1] = bi1;
    }
  }
};

// The lexicographic top-2 of score = 2 dots - norm, the exact negation of
// the L2 score dbn - 2 q.db (argmin2.cu negates back).  A block's first
// tile (and the ragged last one) takes every score through the full rule
// (fold2): so a padding row (+inf norm, score -inf) takes an empty second
// place, as the lowest-index -inf.  After it a score can enter only by
// beating the running second place of its thread and the row's threshold
// t: the second best value the row's four threads held after their last
// insert.  Two entries of lower index at least that good exist and are
// only ever displaced by better ones, so a score <= t can never place, and
// since the columns of a thread arrive in increasing row order, a strict
// `>` is the lexicographic rule there.  A row's scores of a tile are
// tested at once and the (branch-free) insert runs only where one passes,
// after warm-up in a few tiles of a hundred; the scores are recomputed
// there rather than held, so the epilogue needs no registers beyond the
// accumulators and its state.
struct EpiTop2 {
  static constexpr bool kNorms = true;
  static constexpr bool kWide = true;  // 128-row tiles where they fit
  static constexpr bool kTile = false;
  float v0 = -INFINITY, w0 = -INFINITY, v1 = -INFINITY, w1 = -INFINITY;
  int i0 = INT_MAX, j0 = INT_MAX, i1 = INT_MAX, j1 = INT_MAX;
  float t0 = -INFINITY, t1 = -INFINITY;  // the rows' thresholds

  // (s, c) into the sorted pair (v, i) > (w, j) if it beats w and the
  // threshold t; c is above every index held
  __device__ __forceinline__ static void insert(float& v, int& i, float& w,
                                                int& j, float t, float s,
                                                int c) {
    const bool in = s > fmaxf(w, t);
    const bool top = in && s > v;
    w = top ? v : (in ? s : w);
    j = top ? i : (in ? c : j);
    v = top ? s : v;
    i = top ? c : i;
  }

  // the second best value of the row's four threads' pairs (v, w)
  __device__ __forceinline__ static float quad_second(float v, float w) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const float ow = __shfl_xor_sync(0xffffffffu, w, off);
      w = fmaxf(fminf(v, ov), fmaxf(w, ow));
      v = fmaxf(v, ov);
    }
    return w;
  }

  // the norms of 8-column block j
  template <bool MASK>
  __device__ __forceinline__ static float2 norms(int j, uint32_t ns,
                                                 const float* norm,
                                                 int gbase, int lim) {
    if constexpr (MASK) {
      float2 r;
      r.x = 8 * j < lim ? __ldg(norm + gbase + 8 * j) : INFINITY;
      r.y = 8 * j + 1 < lim ? __ldg(norm + gbase + 8 * j + 1) : INFINITY;
      return r;
    } else {
      return lds_f2(ns + 32 * j);
    }
  }

  template <bool MASK, bool FIRST, int N>
  __device__ __forceinline__ void tile(const float (&d)[N / 2], uint32_t ns,
                                       const float* norm, int gbase,
                                       int lim) {
    if constexpr (MASK || FIRST) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 n = norms<MASK>(j, ns, norm, gbase, lim);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + e;
          const float nc = e ? n.y : n.x;
          if (!MASK || c < lim) {
            ia_scan::fold2(v0, i0, w0, j0, 2.0f * d[4 * j + e] - nc,
                           gbase + c);
            ia_scan::fold2(v1, i1, w1, j1, 2.0f * d[4 * j + 2 + e] - nc,
                           gbase + c);
          }
        }
      }
    } else {
      const float h0 = fmaxf(w0, t0), h1 = fmaxf(w1, t1);
      bool hit0 = false, hit1 = false;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 n = lds_f2(ns + 32 * j);
        hit0 |= 2.0f * d[4 * j] - n.x > h0;
        hit0 |= 2.0f * d[4 * j + 1] - n.y > h0;
        hit1 |= 2.0f * d[4 * j + 2] - n.x > h1;
        hit1 |= 2.0f * d[4 * j + 3] - n.y > h1;
      }
      if (hit0) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const float2 n = lds_f2(ns + 32 * j);
          insert(v0, i0, w0, j0, t0, 2.0f * d[4 * j] - n.x, gbase + 8 * j);
          insert(v0, i0, w0, j0, t0, 2.0f * d[4 * j + 1] - n.y,
                 gbase + 8 * j + 1);
        }
      }
      if (hit1) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const float2 n = lds_f2(ns + 32 * j);
          insert(v1, i1, w1, j1, t1, 2.0f * d[4 * j + 2] - n.x,
                 gbase + 8 * j);
          insert(v1, i1, w1, j1, t1, 2.0f * d[4 * j + 3] - n.y,
                 gbase + 8 * j + 1);
        }
      }
      // a threshold moves only where a score was inserted
      if (!__any_sync(0xffffffffu, hit0 || hit1)) return;
    }
    t0 = quad_second(v0, w0);
    t1 = quad_second(v1, w1);
  }

  __device__ __forceinline__ void reduce_quad() {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov0 = __shfl_xor_sync(0xffffffffu, v0, off);
      const int oi0 = __shfl_xor_sync(0xffffffffu, i0, off);
      const float ow0 = __shfl_xor_sync(0xffffffffu, w0, off);
      const int oj0 = __shfl_xor_sync(0xffffffffu, j0, off);
      const float ov1 = __shfl_xor_sync(0xffffffffu, v1, off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, i1, off);
      const float ow1 = __shfl_xor_sync(0xffffffffu, w1, off);
      const int oj1 = __shfl_xor_sync(0xffffffffu, j1, off);
      ia_scan::fold2(v0, i0, w0, j0, ov0, oi0);
      ia_scan::fold2(v0, i0, w0, j0, ow0, oj0);
      ia_scan::fold2(v1, i1, w1, j1, ov1, oi1);
      ia_scan::fold2(v1, i1, w1, j1, ow1, oj1);
    }
  }

  __device__ __forceinline__ void write(const HopperArgs& a, size_t o,
                                        int r0, int r1, int q_end) const {
    if (r0 < q_end) {
      a.val[o + r0] = v0;
      a.idx[o + r0] = i0;
      a.val2[o + r0] = w0;
      a.idx2[o + r0] = j0;
    }
    if (r1 < q_end) {
      a.val[o + r1] = v1;
      a.idx[o + r1] = i1;
      a.val2[o + r1] = w1;
      a.idx2[o + r1] = j1;
    }
  }
};

// The global champion of score = S dots - norm, S = 1 (packed3, packed2,
// packed1w: dots - dbnh, EpiBestSub) or 2 (argmin_bf16: 2 dots - dbn, the
// exact negation of the L2 score dbn - 2 dots, EpiBestL2; its merge
// negates back), with the norms of the stage, or of global memory for the
// ragged last tile: the maximum, lowest index on ties, in fp32 with one
// subtract: the score bits of the first design's instances (2 dots is
// exact, so a fused multiply-add gives the same value).  A row's scores of
// a tile cost one subtract and one max each; only a tile maximum that beats the running best looks up its lowest
// column (recomputing the scores, the same fp32 values), which after the
// first few tiles is rare.  A padding row (+inf norm) scores -inf, which a
// strict `>` never takes, so a thread, and a chunk, that saw only padding
// keeps (-inf, INT_MAX) and loses every lexicographic merge to a real row.
// The state, the quad reduce and the write are EpiBest's.  WIDE: 128-row
// tiles up to k_used = 256 (`tile_rows`); packed3 keeps 64 (128-row ones
// leave room for three query sets only on two warpgroups: three query
// tiles at M = 352).
template <int S, bool WIDE>
struct EpiBestNorm : EpiBest {
  static_assert(S == 1 || S == 2, "score = dots - norm or 2 dots - norm");
  static constexpr bool kNorms = true;
  static constexpr bool kWide = WIDE;

  __device__ __forceinline__ static float score(float d, float n) {
    if constexpr (S == 1) {
      return d - n;
    } else {
      return 2.0f * d - n;
    }
  }

  // the lowest column of this thread's row (r = 0: row g; r = 2: row
  // g + 8) whose score is s
  template <bool MASK, int N>
  __device__ __forceinline__ static int first_col(const float (&d)[N / 2],
                                                  int r, float s, uint32_t ns,
                                                  const float* norm,
                                                  int gbase, int lim) {
    int col = 0;
#pragma unroll
    for (int j = N / 8 - 1; j >= 0; --j) {
      const float2 n = EpiTop2::norms<MASK>(j, ns, norm, gbase, lim);
#pragma unroll
      for (int e = 1; e >= 0; --e) {
        const int c = 8 * j + e;
        if ((!MASK || c < lim) &&
            score(d[4 * j + r + e], e ? n.y : n.x) == s)
          col = c;
      }
    }
    return col;
  }

  template <bool MASK, bool FIRST, int N>
  __device__ __forceinline__ void tile(const float (&d)[N / 2], uint32_t ns,
                                       const float* norm, int gbase,
                                       int lim) {
    float tv0 = -INFINITY, tv1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 n = EpiTop2::norms<MASK>(j, ns, norm, gbase, lim);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + e;
        const float nc = e ? n.y : n.x;
        if (!MASK || c < lim) {
          tv0 = fmaxf(tv0, score(d[4 * j + e], nc));
          tv1 = fmaxf(tv1, score(d[4 * j + 2 + e], nc));
        }
      }
    }
    if (tv0 > bv0) {
      bi0 = gbase + first_col<MASK, N>(d, 0, tv0, ns, norm, gbase, lim);
      bv0 = tv0;
    }
    if (tv1 > bv1) {
      bi1 = gbase + first_col<MASK, N>(d, 2, tv1, ns, norm, gbase, lim);
      bv1 = tv1;
    }
  }
};

using EpiBestSub = EpiBestNorm<1, false>;
using EpiBestL2 = EpiBestNorm<2, true>;

// One champion of score = dots - norm per output tile of a.tile_sub DB
// tiles (pertile_champions: a scan tile, or a part of one that a merge
// folds; packed_champions: a DB tile of tile_n rows), by EpiBestSub's
// max-first fold.  The kernel flushes it after the
// DB tile that ends an output tile -- the quad reduce, then the write to
// row t / tile_sub of the output -- and resets it to (-inf, the next
// output tile's first row), so a tile of padding rows only (-inf scores,
// which a strict `>` never takes) keeps (-inf, its first row), as
// `jnp.argmax` over -inf gives.  Chunks are whole output tiles, so no
// write is left at a chunk's end.  WIDE: 128-row DB tiles up to k_used =
// 256 (`tile_rows`), for output tiles of a multiple of 128 rows; else 64
// (32 for two query sets and two streams past 448 lanes).
template <bool WIDE>
struct EpiTile : EpiBestSub {
  static constexpr bool kWide = WIDE;
  static constexpr bool kTile = true;

  __device__ __forceinline__ void reset(int row) {
    bv0 = bv1 = -INFINITY;
    bi0 = bi1 = row;
  }
};

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
// wgmma.  The query tensor holds query_sets(FOLD, TWO) blocks of m rows:
// with FOLD (2m, k), hi rows then lo rows, each DB tile running the hi
// chain, then the lo chain, into one accumulator; with TWO a last block
// against the second weight stream (wmap2), whose tile rides the stage
// after the first's boxes.  k16 steps run pass, then k step, in order (the
// first design's mma.sync order, whose bits the instances kept).  A tile
// has scan_rows<FOLD, TWO, Epi>(KSTEPS) DB rows.
template <int KSTEPS, bool FOLD, bool TWO, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    scan_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap wmap2, HopperArgs a) {
  // resident query blocks a warpgroup
  constexpr int QSETS = query_sets(FOLD, TWO);
  constexpr int BN = scan_rows<FOLD, TWO, Epi>(KSTEPS);
  constexpr int WBOX_BYTES = BN * BOX * 2;  // a DB box of BN rows
  __shared__ __align__(8) uint64_t bars[2 * MAX_STAGES + 1];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + SMEM_ALIGN - 1) & ~uint32_t(SMEM_ALIGN - 1);
  const int qset_bytes = a.nbox * QBOX_BYTES;
  const int wtile_bytes = a.nbox * WBOX_BYTES;  // one stream's tile
  const int stage_bytes = (TWO ? 2 : 1) * wtile_bytes;
  const uint32_t q_base = base;
  const uint32_t w_base = base + a.consumers * QSETS * qset_bytes;
  const uint32_t n_base = w_base + a.stages * stage_bytes;  // kNorms only
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
      if constexpr (TWO)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(&wmap2))
                     : "memory");
      mbar_expect_tx(qfull, live * QSETS * qset_bytes);
      for (int wg = 0; wg < live; ++wg)
        for (int p = 0; p < QSETS; ++p)
          for (int b = 0; b < a.nbox; ++b)
            // block p starts at row p m; a box past it reads the next
            // block's rows into query rows this block does not own
            tma_load_2d(q_base + ((wg * QSETS + p) * a.nbox + b) * QBOX_BYTES,
                        &qmap, qfull, b * BOX, p * a.m + q0 + wg * WG_ROWS);
      Ring r{0, 0};
      for (int t = t_begin; t < t_end; ++t) {
        // the first pass over the ring finds every stage free
        mbar_wait(empty0 + 8 * r.stage, r.phase ^ 1);
        const uint32_t full = full0 + 8 * r.stage;
        // a full tile's norms ride the stage; the ragged last tile's are
        // read from global memory by the consumers
        const bool norms = Epi::kNorms && t * BN + BN <= a.n;
        mbar_expect_tx(full, stage_bytes + (norms ? BN * 4 : 0));
        for (int b = 0; b < a.nbox; ++b)
          tma_load_2d(w_base + r.stage * stage_bytes + b * WBOX_BYTES, &wmap,
                      full, b * BOX, t * BN);
        if constexpr (TWO) {
          for (int b = 0; b < a.nbox; ++b)
            tma_load_2d(w_base + r.stage * stage_bytes + wtile_bytes +
                            b * WBOX_BYTES,
                        &wmap2, full, b * BOX, t * BN);
        }
        if (norms)
          bulk_load(n_base + r.stage * BN * 4, a.norm + (size_t)t * BN,
                    BN * 4, full);
        r.next(a.stages);
      }
    }
  } else if ((warp >> 2) < live) {
    // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64), those below
    // q_end its own (the rest belong to the next query tile or are past M)
    const int wg = warp >> 2;
    const int g = lane >> 2, tig = lane & 3;
    const int r0 = q0 + wg * WG_ROWS + (warp & 3) * 16 + g, r1 = r0 + 8;
    const uint32_t qa_base = q_base + wg * QSETS * qset_bytes;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    Epi ep;
    if constexpr (Epi::kTile) ep.reset(t_begin * BN);
    mbar_wait(qfull, 0);
    Ring r{0, 0};
    for (int t = t_begin; t < t_end; ++t) {
      mbar_wait(full0 + 8 * r.stage, r.phase);
      const uint32_t wb = w_base + r.stage * stage_bytes;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int p = 0; p < QSETS; ++p) {
        // the last pass of a TWO scan reads the second stream's tile
        const uint32_t wp = (TWO && p == QSETS - 1) ? wb + wtile_bytes : wb;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          // k step ks: box ks / 2, its 16-lane half ks % 2 (32 bytes in)
          wgmma_k16<BN>(acc,
                        desc_sw64(qa_base + p * qset_bytes +
                                  (ks >> 1) * QBOX_BYTES + (ks & 1) * 32),
                        desc_sw64(wp + (ks >> 1) * WBOX_BYTES + (ks & 1) * 32),
                        p > 0 || ks > 0);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      const uint32_t empty = empty0 + 8 * r.stage;
      const uint32_t ns = n_base + r.stage * (BN * 4) + 8 * tig;
      // an epilogue that reads the stage's norms releases it after them
      if constexpr (!Epi::kNorms) {
        if (lane == 0) mbar_arrive(empty);
      }
      r.next(a.stages);
      const int gbase = t * BN + 2 * tig;
      if (t * BN + BN > a.n) {
        ep.template tile<true, true, BN>(acc, ns, a.norm, gbase,
                                         a.n - gbase);
      } else if (Epi::kNorms && t == t_begin) {
        ep.template tile<false, true, BN>(acc, ns, a.norm, gbase, BN);
      } else {
        ep.template tile<false, false, BN>(acc, ns, a.norm, gbase, BN);
      }
      if constexpr (Epi::kNorms) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty);
      }
      if constexpr (Epi::kTile) {
        // the last DB tile of an output tile: its champions, in place
        if ((t + 1) % a.tile_sub == 0) {
          ep.reduce_quad();
          if (tig == 0)
            ep.write(a, (size_t)(t / a.tile_sub) * a.m, r0, r1, q_end);
          ep.reset((t + 1) * BN);
        }
      }
    }
    if constexpr (!Epi::kTile) {
      // the four threads of a row group hold disjoint columns
      ep.reduce_quad();
      if (tig == 0) ep.write(a, (size_t)blockIdx.y * a.m, r0, r1, q_end);
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
// box_rows rows in the 64-byte swizzle; reads past the last row give zeros
inline int bf16_rows_map(CUtensorMap* map, const void* ptr, int rows, int k,
                         int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {BOX, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One scan over grid (ceil(m / a.bm), n_chunks), writing the partials;
// q is (query_sets(FOLD, TWO) m, k), w2 the second stream (TWO only).
// Returns the first CUDA error.  The shared memory limit is raised on
// every launch: the attribute belongs to the current device.
template <int KSTEPS, bool FOLD, bool TWO, class Epi>
int launch_scan(const void* q, const void* w, const void* w2, int k,
                const HopperArgs& a, int n_chunks, cudaStream_t s) {
  constexpr int BN = scan_rows<FOLD, TWO, Epi>(KSTEPS);
  CUtensorMap qmap, wmap, wmap2;
  int e = bf16_rows_map(&qmap, q, query_sets(FOLD, TWO) * a.m, k, WG_ROWS);
  if (e != cudaSuccess) return e;
  e = bf16_rows_map(&wmap, w, a.n, k, BN);
  if (e != cudaSuccess) return e;
  wmap2 = wmap;
  if constexpr (TWO) {
    e = bf16_rows_map(&wmap2, w2, a.n, k, BN);
    if (e != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute(scan_kernel<KSTEPS, FOLD, TWO, Epi>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           a.smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.m + a.bm - 1) / a.bm, n_chunks);
  scan_kernel<KSTEPS, FOLD, TWO, Epi>
      <<<grid, THREADS, a.smem, s>>>(qmap, wmap, wmap2, a);
  return cudaGetLastError();
}

// launch_scan of the instance with ksteps = k_used / 16 k steps (1..KMAX)
template <bool FOLD, bool TWO, class Epi, int KMAX = MAX_KSTEPS,
          int KSTEPS = 1>
int launch_scan_k(int ksteps, const void* q, const void* w, const void* w2,
                  int k, const HopperArgs& a, int n_chunks, cudaStream_t s) {
  if constexpr (KSTEPS > KMAX) {
    return cudaErrorInvalidValue;
  } else {
    if (ksteps == KSTEPS)
      return launch_scan<KSTEPS, FOLD, TWO, Epi>(q, w, w2, k, a, n_chunks, s);
    return launch_scan_k<FOLD, TWO, Epi, KMAX, KSTEPS + 1>(
        ksteps, q, w, w2, k, a, n_chunks, s);
  }
}

// The C entry of a global-champion instance: q (query_sets(FOLD, TWO) m,
// k), w (and w2 with TWO) (n, k) bf16, norm (n,) fp32 (with Epi::kNorms),
// all contiguous and 16-byte aligned; K in {128, 256, 384, 512}, k_used a
// multiple of 16 up to 16 KMAX, lanes at and past it skipped.  The launch
// plan (consumers .. n_chunks) comes from ops/match.py; the entry only
// refuses one outside the instance's limits.  Scans into the partials
// part_val/part_idx (n_chunks, m), then best_merge_kernel folds them into
// out_idx/out_val (m,) by the lexicographic rule.  Launches on `stream`,
// returns the first CUDA error.
template <bool FOLD, bool TWO, class Epi, int KMAX = MAX_KSTEPS>
int scan_best(const void* q, const void* w, const void* w2, const void* norm,
              int m, int n, int k, int k_used, int consumers, int bm,
              int stages, int tiles_per_chunk, int smem, int n_chunks,
              float* part_val, int* part_idx, int* out_idx, float* out_val,
              int device, void* stream) {
  const int ksteps = k_used / 16;
  const int nbox = (k_used + BOX - 1) / BOX;
  if (!ia_scan::shape_ok(m, n, k, k_used, n_chunks) || ksteps > KMAX ||
      (TWO && w2 == nullptr) || (Epi::kNorms && norm == nullptr) ||
      !plan_ok(n, scan_rows<FOLD, TWO, Epi>(ksteps), nbox, consumers, bm,
               stages, tiles_per_chunk, smem, n_chunks,
               query_sets(FOLD, TWO), TWO ? 2 : 1, Epi::kNorms)) {
    return cudaErrorInvalidValue;
  }
  int e = ia_scan::use_device(device);
  if (e != cudaSuccess) return e;
  HopperArgs a{};
  a.m = m;
  a.n = n;
  a.consumers = consumers;
  a.bm = bm;
  a.nbox = nbox;
  a.stages = stages;
  a.tiles_per_chunk = tiles_per_chunk;
  a.smem = smem;
  a.norm = static_cast<const float*>(norm);
  a.val = part_val;
  a.idx = part_idx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = launch_scan_k<FOLD, TWO, Epi, KMAX>(ksteps, q, w, w2, k, a, n_chunks,
                                          s);
  if (e != cudaSuccess) return e;
  ia_scan::best_merge_kernel<<<m, 32, 0, s>>>(part_val, part_idx, m,
                                              n_chunks, out_idx, out_val);
  return cudaGetLastError();
}

// The bf16 query block of fp32 queries q (m, k), written by the C entries
// of the scans that take fp32 queries (one launch in place of a wrapper's
// cast): with split (q_split) the hi rows (the truncated bf16, by bit
// mask: exact) then the lo rows (the residual, exact in fp32, rounded to
// nearest), (2m, k); else q rounded to nearest, (m, k) -- the bits of
// ops/match.py `_scan_queries`
__global__ void scan_queries_kernel(const float* __restrict__ q, int m, int k,
                                    int split,
                                    __nv_bfloat16* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)m * k;
  if (e >= total) return;
  const float x = q[e];
  if (split) {
    const float hi = __uint_as_float(__float_as_uint(x) & 0xffff0000u);
    out[e] = __float2bfloat16_rn(hi);
    out[total + e] = __float2bfloat16_rn(x - hi);
  } else {
    out[e] = __float2bfloat16_rn(x);
  }
}

// scan_queries_kernel over q (m, k) into out on stream s; returns the
// first CUDA error
inline int write_scan_queries(const float* q, int m, int k, int split,
                              __nv_bfloat16* out, cudaStream_t s) {
  const int threads = 256;
  const size_t total = (size_t)m * k;
  scan_queries_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                        0, s>>>(q, m, k, split, out);
  return cudaGetLastError();
}

}  // namespace ia_hopper
