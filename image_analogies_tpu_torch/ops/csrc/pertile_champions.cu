// Per-tile champion scan of the bf16 centered DB: the pertile_champions
// instances of the Hopper core (hopper_scan.cuh) with the per-tile
// epilogue (EpiTile), the fp32 half norms riding the ring and, under
// q_split, the hi and lo query blocks folded into one accumulator.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py:300 `_pertile_kernel`
// (entry `pallas_pertile_champions` :348, wrapper
// `pertile_champions_queries`), the scan of the scan_rescue anchor.  Per
// query row m and scan tile t of tile_n DB rows: the (max, first argmax)
// over the tile's rows n of  s2 = q[m].db[n] - dbnh[n],  bf16 operands,
// fp32 accumulation, written tile-major to (n / tile_n, m) with global row
// indices.  Ties go to the lowest row of the tile; padding rows carry dbnh
// = +inf, so an all-padding tile gives (-inf, its first row).  With
// q_split the query block is (2m, K), hi rows then lo rows, folded: each DB
// tile's hi k steps, then its lo k steps, into one fp32 accumulator (the
// order of the first design, which this replaced, so the same scores bit
// for bit).
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s) at level 0 of npr_1024
// (M = 352 as 704 hi/lo rows, N = 1,048,576, F = 68 of 128 lanes, scan
// tile 4,096): 2 x 704 x N x 68 products = 101 us, against 44 us to stream
// the DB's 68 lanes and the half norms once; so operations bound it, and
// the L2 -> SM traffic of two query tiles reading the DB's three 32-lane
// boxes (~0.4 GB) is close behind.  The design (hopper_scan.cuh): the
// products on `wgmma` from shared memory over 128-row DB tiles (a tile's
// 2 x 5 dependent steps at 80 lanes), the query rows resident, the DB
// tiles and their norms copied by a producer warp's TMA ring; an epilogue
// that takes a row's tile maximum first (one subtract and one max a score)
// and does the quad reduce once per scan tile (32 DB tiles at level 0),
// writing each scan tile's champion in place.  Blocks walk whole scan
// tiles; where the scan tiles are too few to fill the card (levels 1-4 of
// npr_1024: 16-64 of them) a scan tile is cut into `parts` output tiles
// and pertile_merge_kernel folds their champions by the same rule.

#include "hopper_scan.cuh"

using ia_scan::fold;

namespace {

// one thread per (scan tile, query row): the lexicographic maximum of the
// scan tile's `parts` partial champions (part-major: (tiles parts, m))
__global__ void pertile_merge_kernel(const float* __restrict__ part_val,
                                     const int* __restrict__ part_idx,
                                     int m, int ntiles, int parts,
                                     float* __restrict__ out_val,
                                     int* __restrict__ out_idx) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ntiles * m) return;
  const int t = e / m, r = e - t * m;
  size_t o = (size_t)t * parts * m + r;
  float v = part_val[o];
  int i = part_idx[o];
  for (int p = 1; p < parts; ++p) {
    o += m;
    fold(v, i, part_val[o], part_idx[o]);
  }
  out_val[e] = v;
  out_idx[e] = i;
}

// the instance of k_used lanes: 128-row DB tiles where the scan tile is a
// multiple of 128 rows and k_used <= 256 (EpiTile<true>), else 64
template <bool FOLD>
int launch_tiles(bool wide, int k_used, const void* q, const void* db, int k,
                 const ia_hopper::HopperArgs& a, int n_chunks,
                 cudaStream_t s) {
  using namespace ia_hopper;
  const int ksteps = k_used / 16;
  if (wide)
    return launch_scan_k<FOLD, false, EpiTile<true>, 16>(ksteps, q, db,
                                                         nullptr, k, a,
                                                         n_chunks, s);
  return launch_scan_k<FOLD, false, EpiTile<false>>(ksteps, q, db, nullptr, k,
                                                    a, n_chunks, s);
}

}  // namespace

extern "C" {

// q the query block, (m or 2m, k) bf16; or with qf32 the (m, k) fp32
// queries, of which the entry first writes the block into qk ((2m, k)
// bf16 with q_split, else (m, k)): one launch in place of the wrapper's
// split.  db (n, k) bf16, dbnh (n,) fp32 half norms (+inf on padding
// rows), all contiguous and 16-byte aligned; k in {128, 256, 384, 512};
// lanes at and past k_used (a multiple of 16) are skipped.  n a
// multiple of tile_n, tile_n a multiple of 64.  consumers (warpgroups of
// 64 query rows, 1..3), bm (query rows a block), stages (ring depth),
// tiles_per_chunk (DB tiles a block: whole output tiles), smem and parts
// (output tiles a scan tile) come from the launch plan (ops/match.py
// `_pertile_plan`); the entry only refuses a plan outside the kernel's
// limits.  out_val/out_idx (n / tile_n, m); with parts > 1 the blocks
// write part_val/part_idx (n / tile_n * parts, m) and the merge folds
// them.  Launches on `stream`, returns the first CUDA error.
int ia_pertile_champions(const void* q, int qf32, void* qk, const void* db,
                         const void* dbnh, int m, int n, int k, int k_used,
                         int q_split, int tile_n, int consumers, int bm,
                         int stages, int tiles_per_chunk, int smem,
                         int n_chunks, int parts, float* part_val,
                         int* part_idx, float* out_val, int* out_idx,
                         int device, void* stream) {
  using namespace ia_hopper;
  if (!ia_scan::shape_ok(m, n, k, k_used, n_chunks) || tile_n <= 0 ||
      tile_n % 64 != 0 || n % tile_n != 0 || parts < 1 ||
      (qf32 && qk == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const bool wide = tile_n % 128 == 0 && k_used <= 256;
  const int bn = tile_rows(wide, k_used / 16);
  const int sub = tile_n / bn;  // DB tiles a scan tile
  const int nbox = (k_used + BOX - 1) / BOX;
  if (sub % parts != 0 || tiles_per_chunk % (sub / parts) != 0 ||
      (parts > 1 && (part_val == nullptr || part_idx == nullptr)) ||
      !plan_ok(n, bn, nbox, consumers, bm, stages, tiles_per_chunk, smem,
               n_chunks, query_sets(q_split != 0, false), 1, true)) {
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
  a.norm = static_cast<const float*>(dbnh);
  a.val = parts > 1 ? part_val : out_val;
  a.idx = parts > 1 ? part_idx : out_idx;
  a.tile_sub = sub / parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qf32) {
    e = write_scan_queries(static_cast<const float*>(q), m, k, q_split,
                           static_cast<__nv_bfloat16*>(qk), s);
    if (e != cudaSuccess) return e;
    q = qk;
  }
  e = q_split ? launch_tiles<true>(wide, k_used, q, db, k, a, n_chunks, s)
              : launch_tiles<false>(wide, k_used, q, db, k, a, n_chunks, s);
  if (e != cudaSuccess || parts == 1) return e;
  const int ntiles = n / tile_n;
  const int threads = 256;
  pertile_merge_kernel<<<(ntiles * m + threads - 1) / threads, threads, 0,
                         s>>>(part_val, part_idx, m, ntiles, parts, out_val,
                              out_idx);
  return cudaGetLastError();
}

}  // extern "C"
