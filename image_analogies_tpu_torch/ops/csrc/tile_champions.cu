// Per-tile champions of the packed passes: the packed_champions instances
// of the Hopper core (hopper_scan.cuh) with the per-tile epilogue
// (EpiTile), two weight streams, the half norms in the ring and, folded, a
// third query set.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py:426 `_packed_kernel`
// (entry `pallas_packed_champions` :468, wrappers `packed2_champions` :857
// and `packed3_champions` :874).  Per query row m and DB tile t of tile_n
// rows: the (max, first argmax) over the tile's rows n of
//
//   q[m].W1[n] (+ q[M+m].W1[n] folded) + q[S M+m].W2[n] - dbnh[n]
//
// (S = 1, or 2 folded) over the first k_used lanes, bf16 operands, fp32
// accumulation, written tile-major to (n / tile_n, m) with global row
// indices.  Ties go to the lowest row of the tile; padding rows carry dbnh =
// +inf, so an all-padding tile gives (-inf, its first row), as `jnp.argmax`
// over -inf does.  The JAX tests use the function as the witness that the
// in-kernel champion of packed_best's forms equals the per-tile champions
// plus a select; it runs on no path.  Folded past 256 lanes three query
// sets leave no room for a ring stage of both streams: those widths are
// packed3w_best.cu's (ops/match.py `_champions_route`).
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s) at level 0 of npr_1024
// (M = 352, N = 1,048,576, 2L = 110 of 128 lanes, tile 4,096), folded:
// three passes of 2 M N 2L products = 246 us, against 0.14 ms to stream both
// weight arrays' used lanes and the half norms once: operations bound it.
// The design is packed3_best.cu's chain (every query set resident, a stage
// of a W1 and a W2 tile of 64 rows -- 32 for two sets past 448 lanes -- and
// their norms, k16 steps in order within each pass into one fp32
// accumulator: the first design's order, so its val bits) with
// pertile_champions.cu's epilogue: a tile's maximum first, and the quad
// reduce and the write of an output tile's champion in place after its
// last DB tile.  Chunks are whole output tiles, so no merge follows.

#include "hopper_scan.cuh"

namespace {

constexpr int KMAX_FOLD = 16;  // folded: k_used <= 256

}  // namespace

extern "C" {

// q (2m, k) rows qa then qb, or folded (3m, k) rows [qa; qa fold; qb],
// w1/w2 (n, k) bf16, dbnh (n,) fp32 half norms (+inf on padding rows), all
// contiguous and 16-byte aligned; k in {128, 256, 384, 512}; lanes at and
// past k_used (a multiple of 16; folded at most 256) are skipped.  n a
// multiple of tile_n, tile_n a multiple of the DB tile (64 rows, 32 past
// 448 lanes unfolded).  consumers (warpgroups of 64 query rows, 1..3), bm
// (query rows a block), stages (ring depth), tiles_per_chunk (DB tiles a
// block: whole output tiles) and smem come from the launch plan
// (ops/match.py `_champions_plan`); the entry only refuses a plan outside
// the kernel's limits.  out_val/out_idx (n / tile_n, m).  Launches on
// `stream`, returns the first CUDA error.
int ia_tile_champions(const void* q, const void* w1, const void* w2,
                      const void* dbnh, int m, int n, int k, int k_used,
                      int fold, int tile_n, int consumers, int bm,
                      int stages, int tiles_per_chunk, int smem,
                      int n_chunks, float* out_val, int* out_idx, int device,
                      void* stream) {
  using namespace ia_hopper;
  using Epi = EpiTile<false>;
  const int ksteps = k_used / 16;
  const int bn = fold ? scan_rows<true, true, Epi>(ksteps)
                      : scan_rows<false, true, Epi>(ksteps);
  const int nbox = (k_used + BOX - 1) / BOX;
  if (!ia_scan::shape_ok(m, n, k, k_used, n_chunks) ||
      (fold && ksteps > KMAX_FOLD) || w2 == nullptr || dbnh == nullptr ||
      tile_n <= 0 || tile_n % bn != 0 || n % tile_n != 0 ||
      tiles_per_chunk % (tile_n / bn) != 0 ||
      !plan_ok(n, bn, nbox, consumers, bm, stages, tiles_per_chunk, smem,
               n_chunks, query_sets(fold != 0, true), 2, true)) {
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
  a.val = out_val;
  a.idx = out_idx;
  a.tile_sub = tile_n / bn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fold ? launch_scan_k<true, true, Epi, KMAX_FOLD>(ksteps, q, w1, w2, k,
                                                         a, n_chunks, s)
              : launch_scan_k<false, true, Epi>(ksteps, q, w1, w2, k, a,
                                                n_chunks, s);
}

}  // extern "C"
