// The packed3 scan past 256 lanes (exact_hi2 on RGB sources at patch 7,
// or with the temporal block) on Hopper: one or two query sets of each
// warpgroup held in registers as the wgmma A operand, the others resident
// in shared memory, a TMA ring of both weight streams.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py:523
// `_packed_best_kernel` in its form `packed3_best` (:840, entry
// `pallas_packed_best` :582) at 256 < k_used <= 512.  Per query row m: the
// lexicographic (score, lowest index) maximum over DB rows n < N of
//
//   q[m].W1[n] + q[M+m].W1[n] + q[2M+m].W2[n] - dbnh[n]
//
// over the first k_used lanes, bf16 operands, fp32 accumulation, with the
// query rows [q1|q1], [q2|q2], [q1|q3] (one (3M, K) tensor) and W1 =
// [d1|d2], W2 = [d3|d1]: the six products of exact_hi2's bf16_6x set.
// Padding rows carry dbnh = +inf and never win.  Up to 256 lanes the form
// is packed3_best.cu (ops/match.py `_packed3_route`).  The same kernel
// with the per-tile epilogue (EpiTile) gives the per-tile champions of
// these passes past 256 lanes (`_packed_kernel`, pallas_match.py:426, in
// its wrapper `packed3_champions` :874; ops/match.py `_champions_route`):
// per query row and DB tile of tile_n rows the (max, first argmax),
// tile-major, an all-padding tile (-inf, its first row).
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s) at M = 352, N =
// 1,048,576: three passes of 2 x 352 x N x 2L products, 0.66 ms at 2L =
// 296 and 0.93 ms at 2L = 414, against 0.2-0.3 ms to stream both weight
// arrays' used lanes once; so operations bound it.  What stands in the
// way, and what the design does about it:
// - Room for query rows: three query sets of 64 rows take 110-160 KB at
//   these widths, so the Hopper core (hopper_scan.cuh, every set in shared
//   memory) has no room for a ring stage of both streams.  Here the wgmma
//   A operand of the first pass (or the first two) comes from registers (4
//   a thread a k step: 68-128 a set), loaded once per block, and only the
//   other sets sit in shared memory.  Up to 26 k steps (k_used 416) two
//   sets fit in registers and a block runs two consumer warpgroups; past
//   that one set, one warpgroup.
// - The chain: a tile's 3 KSTEPS dependent wgmma steps into one
//   accumulator take ~35 ns a m64n32k16 step on the card whatever else
//   runs, so a block's second warpgroup (a second chain, and half the
//   query tiles: each re-reads both streams from L2) halves the time.
// - Shared memory for the ring: a stage carries a W1 and a W2 tile and
//   the tile's fp32 norms; 64-row tiles where two such stages fit beside
//   the resident sets (17-18 k steps), else 32-row tiles (m64n32k16).
//   Past 28 k steps (k_used > 448) one set of 64 rows and one 32-row stage
//   fill the shared memory: a single stage, so load and compute take
//   turns (those widths are on no preset's path).
// - Registers: two sets take 8 KSTEPS a thread, so the block has no
//   producer warp (a ninth warp puts three on one of the SM's four
//   register-file quarters and caps a thread at 168; with eight or fewer a
//   thread may take 255): thread 0 issues the loads.  The descriptors are
//   a per-tile base plus a constant offset a step, so the compiler does
//   not hoist 3 KSTEPS 64-bit descriptors into the registers the sets need.
// A tile's chain runs pass 0 and 1 against W1, pass 2 against W2, k16
// steps in order within each pass (the first design's order, as it ran
// these widths before), into one accumulator; the epilogue subtracts the
// stage's norms and keeps the champion (hopper_scan.cuh EpiBestSub: blocks
// write per-chunk partials that best_merge_kernel reduces by the same
// rule; or EpiTile, each output tile's champion written in place).

#include "hopper_scan.cuh"

namespace {

using namespace ia_hopper;

constexpr int KMIN = 17;  // k_used > 256
constexpr int KMAX = 32;  // k_used <= 512

// query sets a warpgroup holds in registers: passes 0 .. reg_sets - 1
// (two up to 26 k steps: 208 registers of A fragments, at 255 a thread)
__host__ __device__ constexpr int reg_sets(int ksteps) {
  return ksteps <= 26 ? 2 : 1;
}

// consumer warpgroups an instance runs at most: two where two sets sit in
// registers, else one
__host__ __device__ constexpr int max_consumers(int ksteps) {
  return reg_sets(ksteps) == 2 ? 2 : 1;
}

// No producer warp (see the header): thread 0 issues the TMA loads.
__host__ __device__ constexpr int threads_of(int ksteps) {
  return 128 * max_consumers(ksteps);
}

// DB rows a tile: 64 where a ring of two such stages (a W1 and a W2 tile
// and their norms) fits beside the shared-memory sets of the most
// consumers, else 32
__host__ __device__ constexpr int w_tile_rows(int ksteps) {
  return smem_bytes((ksteps + 1) / 2, 2, max_consumers(ksteps),
                    3 - reg_sets(ksteps), 2, true, 64) <= SMEM_DYN_MAX
             ? 64
             : 32;
}

// two bf16 of row `row` of the (3m, k) query tensor at lane `col`, zero for
// a row past the query set
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* q, int k,
                                           int set, int m, int row,
                                           int col) {
  if (row >= m) return 0u;
  return __ldg(reinterpret_cast<const unsigned int*>(
      q + ((size_t)set * m + row) * k + col));
}

// the TMA loads of DB tile t into the ring stage at wb (norms at nb): its
// W1 and W2 boxes and, for a full tile, its norms (the ragged last tile's
// are read from global memory by the epilogue)
template <int BN, int NBOX>
__device__ __forceinline__ void load_tile(const CUtensorMap* wmap,
                                          const CUtensorMap* wmap2,
                                          const HopperArgs& a, uint32_t full,
                                          uint32_t wb, uint32_t nb, int t) {
  constexpr int WBOX_BYTES = BN * BOX * 2;
  constexpr int WTILE_BYTES = NBOX * WBOX_BYTES;
  const bool norms = t * BN + BN <= a.n;
  mbar_expect_tx(full, 2 * WTILE_BYTES + (norms ? BN * 4 : 0));
  for (int b = 0; b < NBOX; ++b) {
    tma_load_2d(wb + b * WBOX_BYTES, wmap, full, b * BOX, t * BN);
    tma_load_2d(wb + WTILE_BYTES + b * WBOX_BYTES, wmap2, full, b * BOX,
                t * BN);
  }
  if (norms) bulk_load(nb, a.norm + (size_t)t * BN, BN * 4, full);
}

// Grid (query tiles of a.bm rows, DB chunks of tiles_per_chunk tiles);
// threads_of(KSTEPS) threads, warpgroups 0..a.consumers-1 consuming (any
// past them idle).  Passes 0..RSETS-1 read their query rows from
// registers, the rest from the shared-memory sets.  Thread 0 loads those
// sets and the first a.stages DB tiles, then at the top of each tile the
// tile a.stages - 1 ahead into the stage the previous tile freed: every
// warpgroup released it a tile earlier, so the wait is short and the
// warpgroups stay in step.  Epi: EpiBestSub (one partial per (chunk, row))
// or EpiTile<false> (one champion per (output tile of a.tile_sub DB tiles,
// row), flushed after the output tile's last DB tile; chunks are whole
// output tiles).
template <int KSTEPS, class Epi>
__global__ void __launch_bounds__(threads_of(KSTEPS), 1)
    packed3w_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap wmap2,
                    const __nv_bfloat16* __restrict__ q, int k,
                    HopperArgs a) {
  constexpr int RSETS = reg_sets(KSTEPS);
  constexpr int SSETS = 3 - RSETS;  // shared-memory sets a warpgroup
  constexpr int BN = w_tile_rows(KSTEPS);
  constexpr int NBOX = (KSTEPS + 1) / 2;  // 32-lane boxes a row (a.nbox)
  constexpr int WBOX_BYTES = BN * BOX * 2;  // a DB box of BN rows
  constexpr int QSET_BYTES = NBOX * QBOX_BYTES;
  constexpr int WTILE_BYTES = NBOX * WBOX_BYTES;  // one stream's tile
  constexpr int STAGE_BYTES = 2 * WTILE_BYTES;
  __shared__ __align__(8) uint64_t bars[2 * MAX_STAGES + 1];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + SMEM_ALIGN - 1) & ~uint32_t(SMEM_ALIGN - 1);
  const uint32_t q_base = base;
  const uint32_t w_base = base + a.consumers * SSETS * QSET_BYTES;
  const uint32_t n_base = w_base + a.stages * STAGE_BYTES;
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
  // the warps of a warpgroup with no row of this tile have nothing to do
  if ((warp >> 2) >= live) return;

  if (threadIdx.x == 0) {
    // the shared-memory query sets once, and the ring's first fill
    mbar_expect_tx(qfull, live * SSETS * QSET_BYTES);
    for (int wg = 0; wg < live; ++wg)
      for (int s = 0; s < SSETS; ++s)
        for (int b = 0; b < NBOX; ++b)
          // set RSETS + s starts at row (RSETS + s) m; a box past it reads
          // the next set's rows (or zeros past 3m) into query rows this
          // block does not own
          tma_load_2d(q_base + ((wg * SSETS + s) * NBOX + b) * QBOX_BYTES,
                      &qmap, qfull, b * BOX,
                      (RSETS + s) * a.m + q0 + wg * WG_ROWS);
    for (int s = 0; s < a.stages && t_begin + s < t_end; ++s)
      load_tile<BN, NBOX>(&wmap, &wmap2, a, full0 + 8 * s,
                          w_base + s * STAGE_BYTES, n_base + s * BN * 4,
                          t_begin + s);
  }

  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64), those below
  // q_end its own (the rest belong to the next query tile or are past M)
  const int wg = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = q0 + wg * WG_ROWS + (warp & 3) * 16 + g, r1 = r0 + 8;
  // the A fragments of passes 0..RSETS-1, loaded once: rows r0 and r1,
  // lanes 16 ks + 2 tig (+1) and + 8 (+9) (the mma.sync A layout)
  uint32_t qr[RSETS][KSTEPS][4];
#pragma unroll
  for (int p = 0; p < RSETS; ++p) {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int col = 16 * ks + 2 * tig;
      qr[p][ks][0] = q_pair(q, k, p, a.m, r0, col);
      qr[p][ks][1] = q_pair(q, k, p, a.m, r1, col);
      qr[p][ks][2] = q_pair(q, k, p, a.m, r0, col + 8);
      qr[p][ks][3] = q_pair(q, k, p, a.m, r1, col + 8);
      // opaque from here on: kept in registers, never re-read per tile
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(qr[p][ks][i]));
    }
  }
  // the descriptor of this warpgroup's first shared-memory set
  const uint64_t qs_desc = desc_sw64(q_base + wg * SSETS * QSET_BYTES);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  Epi ep;
  if constexpr (Epi::kTile) ep.reset(t_begin * BN);
  mbar_wait(qfull, 0);
  Ring r{0, 0};   // the stage of tile t
  Ring rf{0, 0};  // the stage of tile t - 1, refilled at the top of tile t
  for (int t = t_begin; t < t_end; ++t) {
    if (threadIdx.x == 0 && t > t_begin && t - 1 + a.stages < t_end) {
      mbar_wait(empty0 + 8 * rf.stage, rf.phase);
      load_tile<BN, NBOX>(&wmap, &wmap2, a, full0 + 8 * rf.stage,
                          w_base + rf.stage * STAGE_BYTES,
                          n_base + rf.stage * BN * 4, t - 1 + a.stages);
      rf.next(a.stages);
    }
    __syncwarp();
    mbar_wait(full0 + 8 * r.stage, r.phase);
    // the descriptors of this tile: a base and a constant offset (in 16-byte
    // units, the descriptor's address field) a step.  The bases are made
    // opaque here, so the compiler cannot hoist 3 KSTEPS 64-bit descriptors
    // out of the loop into registers that the query fragments need.
    uint64_t wd = desc_sw64(w_base + r.stage * STAGE_BYTES);
    uint64_t qd = qs_desc;
    asm volatile("" : "+l"(wd), "+l"(qd));
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // k step ks of pass p: box ks / 2, its 16-lane half ks % 2 (32 bytes
    // in); pass 2 reads the second stream's tile.  Each step's descriptors
    // are computed between the step before and this one (the bases pass
    // through an empty asm after every step), not all at the tile's top.
    auto wdesc = [&](int p, int ks) {
      return wd + ((p == 2 ? WTILE_BYTES : 0) + (ks >> 1) * WBOX_BYTES +
                   (ks & 1) * 32) / 16;
    };
#pragma unroll
    for (int p = 0; p < RSETS; ++p) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        wgmma_rs<BN>(acc, qr[p][ks], wdesc(p, ks), p > 0 || ks > 0);
        asm volatile("" : "+l"(wd));
      }
    }
#pragma unroll
    for (int p = RSETS; p < 3; ++p) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        wgmma_k16<BN>(acc,
                      qd + ((p - RSETS) * QSET_BYTES + (ks >> 1) * QBOX_BYTES +
                            (ks & 1) * 32) / 16,
                      wdesc(p, ks), 1);
        asm volatile("" : "+l"(wd), "+l"(qd));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    const uint32_t empty = empty0 + 8 * r.stage;
    const uint32_t ns = n_base + r.stage * (BN * 4) + 8 * tig;
    r.next(a.stages);
    const int gbase = t * BN + 2 * tig;
    if (t * BN + BN > a.n) {
      ep.template tile<true, true, BN>(acc, ns, a.norm, gbase, a.n - gbase);
    } else {
      ep.template tile<false, false, BN>(acc, ns, a.norm, gbase, BN);
    }
    // the epilogue read the stage's norms: release it after them
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
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

template <int KSTEPS, class Epi>
int launch_w(const void* q, const void* w1, const void* w2, int k,
             const HopperArgs& a, int n_chunks, cudaStream_t s) {
  constexpr int BN = w_tile_rows(KSTEPS);
  CUtensorMap qmap, wmap, wmap2;
  int e = bf16_rows_map(&qmap, q, 3 * a.m, k, WG_ROWS);
  if (e != cudaSuccess) return e;
  e = bf16_rows_map(&wmap, w1, a.n, k, BN);
  if (e != cudaSuccess) return e;
  e = bf16_rows_map(&wmap2, w2, a.n, k, BN);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(packed3w_kernel<KSTEPS, Epi>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           a.smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.m + a.bm - 1) / a.bm, n_chunks);
  packed3w_kernel<KSTEPS, Epi><<<grid, threads_of(KSTEPS), a.smem, s>>>(
      qmap, wmap, wmap2, static_cast<const __nv_bfloat16*>(q), k, a);
  return cudaGetLastError();
}

// launch_w of the instance with ksteps k steps (KMIN..KMAX)
template <class Epi, int KSTEPS = KMIN>
int launch_w_k(int ksteps, const void* q, const void* w1, const void* w2,
               int k, const HopperArgs& a, int n_chunks, cudaStream_t s) {
  if constexpr (KSTEPS > KMAX) {
    return cudaErrorInvalidValue;
  } else {
    if (ksteps == KSTEPS)
      return launch_w<KSTEPS, Epi>(q, w1, w2, k, a, n_chunks, s);
    return launch_w_k<Epi, KSTEPS + 1>(ksteps, q, w1, w2, k, a, n_chunks, s);
  }
}

// The arguments of a launch plan, or false where the shape or the plan is
// outside the kernel's limits (k in {384, 512}, k_used in (256, 512], at
// most max_consumers warpgroups, the shared memory of the plan's ring)
bool w_args(const void* dbnh, int m, int n, int k, int k_used, int consumers,
            int bm, int stages, int tiles_per_chunk, int smem, int n_chunks,
            HopperArgs* a) {
  const int ksteps = k_used / 16;
  const int nbox = (k_used + BOX - 1) / BOX;
  if (!ia_scan::shape_ok(m, n, k, k_used, n_chunks) ||
      (k != 384 && k != 512) || ksteps < KMIN || ksteps > KMAX ||
      consumers > max_consumers(ksteps) ||
      !plan_ok(n, w_tile_rows(ksteps), nbox, consumers, bm, stages,
               tiles_per_chunk, smem, n_chunks, 3 - reg_sets(ksteps), 2,
               true)) {
    return false;
  }
  *a = HopperArgs{};
  a->m = m;
  a->n = n;
  a->consumers = consumers;
  a->bm = bm;
  a->nbox = nbox;
  a->stages = stages;
  a->tiles_per_chunk = tiles_per_chunk;
  a->smem = smem;
  a->norm = static_cast<const float*>(dbnh);
  return true;
}

}  // namespace

extern "C" {

// q (3m, k) rows [q1|q1] then [q2|q2] then [q1|q3], w1/w2 (n, k) bf16,
// dbnh (n,) fp32 half norms (+inf on padding rows), all contiguous and
// 16-byte aligned; k in {384, 512}; k_used a multiple of 16 in (256, 512],
// lanes at and past it skipped.  consumers (warpgroups of 64 query rows,
// at most 2 up to k_used 416, else 1), bm (query rows a block), stages
// (ring depth), tiles_per_chunk (DB tiles of 64 rows up to k_used 288,
// else 32, a block) and smem come from the launch plan (ops/match.py
// `_packed3w_plan`); the entry only refuses a plan outside the kernel's
// limits.  part_val/part_idx (n_chunks, m) scratch; out_idx/out_val (m,).
// Launches on `stream`, returns the first CUDA error.
int ia_packed3w_best(const void* q, const void* w1, const void* w2,
                     const void* dbnh, int m, int n, int k, int k_used,
                     int consumers, int bm, int stages, int tiles_per_chunk,
                     int smem, int n_chunks, float* part_val, int* part_idx,
                     int* out_idx, float* out_val, int device,
                     void* stream) {
  HopperArgs a;
  if (!w_args(dbnh, m, n, k, k_used, consumers, bm, stages, tiles_per_chunk,
              smem, n_chunks, &a)) {
    return cudaErrorInvalidValue;
  }
  int e = ia_scan::use_device(device);
  if (e != cudaSuccess) return e;
  a.val = part_val;
  a.idx = part_idx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = launch_w_k<EpiBestSub>(k_used / 16, q, w1, w2, k, a, n_chunks, s);
  if (e != cudaSuccess) return e;
  ia_scan::best_merge_kernel<<<m, 32, 0, s>>>(part_val, part_idx, m,
                                              n_chunks, out_idx, out_val);
  return cudaGetLastError();
}

// The per-tile champions of the same scan (packed3_champions past 256
// lanes): ia_tile_champions' arguments (fold must be 1) with this kernel's
// plan (ops/match.py `_champions_plan` over `_packed3w_plan`); n a
// multiple of tile_n, tile_n a multiple of the DB tile (64 rows up to
// k_used 288, else 32), tiles_per_chunk whole output tiles.  out_val/
// out_idx (n / tile_n, m): per (tile, row) the (max, first argmax) of the
// scores, an all-padding tile (-inf, its first row).
int ia_packed3w_champions(const void* q, const void* w1, const void* w2,
                          const void* dbnh, int m, int n, int k, int k_used,
                          int fold, int tile_n, int consumers, int bm,
                          int stages, int tiles_per_chunk, int smem,
                          int n_chunks, float* out_val, int* out_idx,
                          int device, void* stream) {
  HopperArgs a;
  const int bn = w_tile_rows(k_used / 16);
  if (!fold || tile_n <= 0 || tile_n % bn != 0 || n % tile_n != 0 ||
      tiles_per_chunk % (tile_n / bn) != 0 ||
      !w_args(dbnh, m, n, k, k_used, consumers, bm, stages, tiles_per_chunk,
              smem, n_chunks, &a)) {
    return cudaErrorInvalidValue;
  }
  int e = ia_scan::use_device(device);
  if (e != cudaSuccess) return e;
  a.val = out_val;
  a.idx = out_idx;
  a.tile_sub = tile_n / bn;
  return launch_w_k<EpiTile<false>>(k_used / 16, q, w1, w2, k, a, n_chunks,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
