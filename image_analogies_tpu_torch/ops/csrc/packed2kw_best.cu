// The packed2k scan past 512 lanes (RGB sources with
// color_mode="source_rgb" at patch 7, or with the temporal block) on
// Hopper: two consumer warpgroups, the first k steps of each one's query
// rows held in registers as the wgmma A operand and the rest resident in
// shared memory, a TMA ring of 32-row DB tiles.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py:523
// `_packed_best_kernel` in its form `packed2k_best` (:739) at the widths
// the JAX kernel takes past 512 lanes: L = 148 at patch 5 with the
// temporal block (608 lanes); L = 207 at super_resolution's patch 7 (832,
// 688 at its coarsest level); with the temporal block too, L = 256
// (1,040).  The function is packed2k_best.cu's: per query row m, the
// lexicographic (score, lowest index) maximum over DB rows n < N of
// qa[m, :k_used] . wk[n, :k_used], bf16 operands, fp32 accumulation.  Up to
// 512 lanes the form is packed2k_best.cu (ops/match.py `_packed2k_route`).
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s): at M = 352, N =
// 1,048,576 and 4L + 3 = 831 lanes the products are 618 us and the DB's
// bytes 520 us, so the call is bound by operations.  What stands in the
// way, and what the design does about it:
// - L2 -> SM traffic: every query tile's blocks read the whole DB from L2
//   (about 4 TB/s on the card), so the call moves (query tiles) x N x 2
//   k_used bytes.  A block takes two warpgroups, 128 query rows: M = 352
//   is three query tiles, not the six of one warpgroup a block.
// - Room for query rows: two warpgroups' 64 resident rows take 128 bytes
//   a lane each (213 KB at 832 lanes), which leaves no room for a ring.
//   So the first R = reg_ksteps(KSTEPS) k steps of each warpgroup's rows
//   sit in registers (4 a thread a k step), loaded once per block, and
//   only the other KSTEPS - R in shared memory (32-lane boxes from lane
//   16 R).  R is the fewest k steps that leave room for a ring of three
//   32-row stages, or of two where three would take more than REG_KMAX k
//   steps of registers (1,040 lanes: 43 k steps, two stages), or of one
//   (past 1,040 lanes, on no preset's path).
// - Registers: R k steps take 4 R a thread beside 16 accumulators, so the
//   block has no producer warp (a ninth warp caps a thread at 168
//   registers; with eight a thread may take 255): thread 0 issues the
//   loads.  The fragments are loaded through two row pointers at constant
//   offsets (a per-load address would hold two registers a load in
//   flight: 300-630 bytes of spills at 832-1,040 lanes), and the
//   descriptors are a per-tile base plus a constant offset a step, so the
//   compiler does not hoist KSTEPS 64-bit descriptors into the registers
//   the fragments need.
// A tile's chain runs k16 steps 0 .. KSTEPS - 1 in order into one
// accumulator, the register steps first: the order of the core's instance
// that ran these widths before, so its picks and val bits stay.  Two
// chains a warpgroup (a tile's second half beside the next one's first,
// in two accumulators) gave the same bits and ran slower on the card: at
// M = 352 the call moves three query tiles' reads of the DB from L2 at
// about 3.7 TB/s, so the chain is not what holds it.  The epilogue is the
// core's EpiBest: blocks write per-chunk partials that best_merge_kernel
// reduces by the same rule.

#include "hopper_scan.cuh"

namespace {

using namespace ia_hopper;

constexpr int KMIN = 33;     // k_used > 512
constexpr int KMAX = 72;     // k_used <= 1,152
constexpr int CONS = 2;      // consumer warpgroups a block
constexpr int BN = 32;       // DB rows a tile (m64n32k16)
constexpr int REG_KMAX = 44;  // k steps in registers at most: 176 a thread
constexpr int THREADS_W = 128 * CONS;  // no producer warp
constexpr int WBOX_BYTES = BN * BOX * 2;  // a DB box of BN rows

// dynamic shared memory of a block at ksteps k steps, r of them in
// registers: the alignment slack, the shared-memory k steps of CONS
// warpgroups' 64 query rows in 32-lane boxes, and a ring of `stages`
// BN-row DB tiles of ceil(ksteps / 2) boxes
__host__ __device__ constexpr int w_smem(int ksteps, int r, int stages) {
  return SMEM_ALIGN + CONS * ((ksteps - r + 1) / 2) * QBOX_BYTES +
         stages * ((ksteps + 1) / 2) * WBOX_BYTES;
}

// the fewest register k steps that leave room for a ring of `stages`
__host__ __device__ constexpr int min_reg(int ksteps, int stages) {
  int r = 0;
  while (r < ksteps && w_smem(ksteps, r, stages) > SMEM_DYN_MAX) ++r;
  return r;
}

// k steps of a warpgroup's query rows held in registers: the fewest for a
// ring of three stages, else of two, else of one, within REG_KMAX
__host__ __device__ constexpr int reg_ksteps(int ksteps) {
  return min_reg(ksteps, 3) <= REG_KMAX   ? min_reg(ksteps, 3)
         : min_reg(ksteps, 2) <= REG_KMAX ? min_reg(ksteps, 2)
                                          : min_reg(ksteps, 1);
}

// the TMA loads of DB tile t into the ring stage at wb
template <int NBOX>
__device__ __forceinline__ void load_tile(const CUtensorMap* wmap,
                                          uint32_t full, uint32_t wb, int t) {
  mbar_expect_tx(full, NBOX * WBOX_BYTES);
  for (int b = 0; b < NBOX; ++b)
    tma_load_2d(wb + b * WBOX_BYTES, wmap, full, b * BOX, t * BN);
}

// Grid (query tiles of a.bm rows, DB chunks of tiles_per_chunk tiles);
// THREADS_W threads, warpgroups with a row of the tile consuming (the
// other idle).  Thread 0 loads the shared-memory query boxes and the first
// a.stages DB tiles, then at the top of each tile the tile a.stages - 1
// ahead into the stage the previous tile freed: every warpgroup released
// it a tile earlier, so the wait is short and the warpgroups stay in step.
template <int KSTEPS>
__global__ void __launch_bounds__(THREADS_W, 1)
    packed2kw_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __nv_bfloat16* __restrict__ q, int k,
                     HopperArgs a) {
  constexpr int R = reg_ksteps(KSTEPS);
  constexpr int SK = KSTEPS - R;  // k steps in shared memory
  static_assert(R >= 1 && SK >= 1 && R <= REG_KMAX, "register k steps");
  constexpr int SBOX = (SK + 1) / 2;  // their boxes, from lane 16 R
  constexpr int NBOX = (KSTEPS + 1) / 2;  // a DB row's boxes
  constexpr int QSET_BYTES = SBOX * QBOX_BYTES;
  constexpr int STAGE_BYTES = NBOX * WBOX_BYTES;
  __shared__ __align__(8) uint64_t bars[2 * MAX_STAGES + 1];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + SMEM_ALIGN - 1) & ~uint32_t(SMEM_ALIGN - 1);
  const uint32_t q_base = base;
  const uint32_t w_base = base + CONS * QSET_BYTES;
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[MAX_STAGES]);
  const uint32_t qfull = smem_u32(&bars[2 * MAX_STAGES]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * a.bm;
  const int q_end = min(a.m, q0 + a.bm);  // this block's query rows
  // warpgroups with at least one of them
  const int live = min(CONS, (q_end - q0 + WG_ROWS - 1) / WG_ROWS);
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
    // the shared-memory k steps of the query rows once (a box past row m
    // reads zeros, one past q_end rows this block does not own), and the
    // ring's first fill
    mbar_expect_tx(qfull, live * QSET_BYTES);
    for (int wg = 0; wg < live; ++wg)
      for (int b = 0; b < SBOX; ++b)
        tma_load_2d(q_base + (wg * SBOX + b) * QBOX_BYTES, &qmap, qfull,
                    16 * R + b * BOX, q0 + wg * WG_ROWS);
    for (int s = 0; s < a.stages && t_begin + s < t_end; ++s)
      load_tile<NBOX>(&wmap, full0 + 8 * s, w_base + s * STAGE_BYTES,
                      t_begin + s);
  }

  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64), those below
  // q_end its own
  const int wg = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = q0 + wg * WG_ROWS + (warp & 3) * 16 + g, r1 = r0 + 8;
  // the A fragments of k steps 0 .. R - 1, loaded once: rows r0 and r1,
  // lanes 16 ks + 2 tig (+1) and + 8 (+9) (the mma.sync A layout), zero
  // for a row past m.  Two row pointers (rows clamped to m - 1) and
  // constant offsets, so the loads in flight hold no address registers.
  const uint32_t* p0 = reinterpret_cast<const uint32_t*>(
      q + (size_t)min(r0, a.m - 1) * k + 2 * tig);
  const uint32_t* p1 = reinterpret_cast<const uint32_t*>(
      q + (size_t)min(r1, a.m - 1) * k + 2 * tig);
  const uint32_t m0 = r0 < a.m ? ~0u : 0u, m1 = r1 < a.m ? ~0u : 0u;
  uint32_t qr[R][4];
#pragma unroll
  for (int ks = 0; ks < R; ++ks) {
    qr[ks][0] = __ldg(p0 + 8 * ks) & m0;
    qr[ks][1] = __ldg(p1 + 8 * ks) & m1;
    qr[ks][2] = __ldg(p0 + 8 * ks + 4) & m0;
    qr[ks][3] = __ldg(p1 + 8 * ks + 4) & m1;
    // opaque from here on: kept in registers, never re-read per tile
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(qr[ks][i]));
  }
  // the descriptor of this warpgroup's shared-memory query boxes
  const uint64_t qs_desc = desc_sw64(q_base + wg * QSET_BYTES);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  EpiBest ep;
  mbar_wait(qfull, 0);
  Ring r{0, 0};   // the stage of tile t
  Ring rf{0, 0};  // the stage of tile t - 1, refilled at the top of tile t
  for (int t = t_begin; t < t_end; ++t) {
    if (threadIdx.x == 0 && t > t_begin && t - 1 + a.stages < t_end) {
      mbar_wait(empty0 + 8 * rf.stage, rf.phase);
      load_tile<NBOX>(&wmap, full0 + 8 * rf.stage,
                      w_base + rf.stage * STAGE_BYTES, t - 1 + a.stages);
      rf.next(a.stages);
    }
    __syncwarp();
    mbar_wait(full0 + 8 * r.stage, r.phase);
    // the descriptors of this tile: a base and a constant offset (in
    // 16-byte units, the descriptor's address field) a step; the bases
    // pass through an empty asm after every step, so each step's
    // descriptors are computed between the step before and this one
    uint64_t wd = desc_sw64(w_base + r.stage * STAGE_BYTES);
    uint64_t qd = qs_desc;
    asm volatile("" : "+l"(wd), "+l"(qd));
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // k step ks of the DB tile: box ks / 2, its 16-lane half ks % 2 (32
    // bytes in)
    auto wdesc = [&](int ks) {
      return wd + ((ks >> 1) * WBOX_BYTES + (ks & 1) * 32) / 16;
    };
#pragma unroll
    for (int ks = 0; ks < R; ++ks) {
      wgmma_rs_n32(acc, qr[ks], wdesc(ks), ks > 0);
      asm volatile("" : "+l"(wd));
    }
#pragma unroll
    for (int j = 0; j < SK; ++j) {
      wgmma_m64n32k16(acc,
                      qd + ((j >> 1) * QBOX_BYTES + (j & 1) * 32) / 16,
                      wdesc(R + j), 1);
      asm volatile("" : "+l"(wd), "+l"(qd));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    // the epilogue reads only the accumulators: release the stage now
    if (lane == 0) mbar_arrive(empty0 + 8 * r.stage);
    r.next(a.stages);
    const int gbase = t * BN + 2 * tig;
    if (t * BN + BN > a.n) {
      ep.template tile<true, true, BN>(acc, 0, nullptr, gbase, a.n - gbase);
    } else {
      ep.template tile<false, false, BN>(acc, 0, nullptr, gbase, BN);
    }
  }
  // the four threads of a row group hold disjoint columns
  ep.reduce_quad();
  if (tig == 0) ep.write(a, (size_t)blockIdx.y * a.m, r0, r1, q_end);
}

template <int KSTEPS>
int launch_w(const void* q, const void* w, int k, const HopperArgs& a,
             int n_chunks, cudaStream_t s) {
  CUtensorMap qmap, wmap;
  int e = bf16_rows_map(&qmap, q, a.m, k, WG_ROWS);
  if (e != cudaSuccess) return e;
  e = bf16_rows_map(&wmap, w, a.n, k, BN);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(packed2kw_kernel<KSTEPS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           a.smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.m + a.bm - 1) / a.bm, n_chunks);
  packed2kw_kernel<KSTEPS><<<grid, THREADS_W, a.smem, s>>>(
      qmap, wmap, static_cast<const __nv_bfloat16*>(q), k, a);
  return cudaGetLastError();
}

// launch_w of the instance with ksteps k steps (KSTEPS..KMAX)
template <int KSTEPS = KMIN>
int launch_w_k(int ksteps, const void* q, const void* w, int k,
               const HopperArgs& a, int n_chunks, cudaStream_t s) {
  if constexpr (KSTEPS > KMAX) {
    return cudaErrorInvalidValue;
  } else {
    if (ksteps == KSTEPS) return launch_w<KSTEPS>(q, w, k, a, n_chunks, s);
    return launch_w_k<KSTEPS + 1>(ksteps, q, w, k, a, n_chunks, s);
  }
}

}  // namespace

extern "C" {

// qa (m, k) and wk (n, k) bf16, contiguous and 16-byte aligned; k a
// multiple of 128 up to 1,152; k_used a multiple of 16 in (512, 1152],
// query lanes at and past it zero and skipped.  reg_k (the kernel's
// reg_ksteps(k_used / 16)), consumers (2), bm (query rows a block, <=
// 128), stages, tiles_per_chunk (32-row DB tiles a block) and smem come
// from the launch plan (ops/match.py `_packed2kw_plan`); the entry only
// refuses a plan outside the kernel's limits.  The grid is (ceil(m / bm),
// n_chunks).  part_val/part_idx (n_chunks, m) scratch; out_idx/out_val
// (m,).  Launches on `stream`, returns the first CUDA error.
int ia_packed2kw_best(const void* qa, const void* wk, int m, int n, int k,
                      int k_used, int reg_k, int consumers, int bm,
                      int stages, int tiles_per_chunk, int smem, int n_chunks,
                      float* part_val, int* part_idx, int* out_idx,
                      float* out_val, int device, void* stream) {
  const int ksteps = k_used / 16;
  // the core's plan checks with no resident query set, then this kernel's
  // shared memory: the query boxes past the register k steps and the ring
  if (!ia_scan::shape_ok(m, n, k, k_used, n_chunks, 16 * KMAX) ||
      ksteps < KMIN || ksteps > KMAX || consumers != CONS ||
      reg_k != reg_ksteps(ksteps) ||
      !plan_ok(n, BN, (k_used + BOX - 1) / BOX, consumers, bm, stages,
               tiles_per_chunk, smem, n_chunks, 0, 1, false) ||
      smem < w_smem(ksteps, reg_k, stages)) {
    return cudaErrorInvalidValue;
  }
  int e = ia_scan::use_device(device);
  if (e != cudaSuccess) return e;
  HopperArgs a{};
  a.m = m;
  a.n = n;
  a.bm = bm;
  a.stages = stages;
  a.tiles_per_chunk = tiles_per_chunk;
  a.smem = smem;
  a.val = part_val;
  a.idx = part_idx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = launch_w_k(ksteps, qa, wk, k, a, n_chunks, s);
  if (e != cudaSuccess) return e;
  ia_scan::best_merge_kernel<<<m, 32, 0, s>>>(part_val, part_idx, m,
                                              n_chunks, out_idx, out_val);
  return cudaGetLastError();
}

}  // extern "C"
