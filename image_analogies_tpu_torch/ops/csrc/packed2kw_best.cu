// The packed2k instance of the Hopper scan core (hopper_scan.cuh) past 512
// lanes: 33-72 k steps, k_used 528-1,152.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py:523
// `_packed_best_kernel` in its form `packed2k_best` (:739) at the widths
// the JAX kernel takes past 512 lanes: the packed2k scan of RGB sources
// with color_mode="source_rgb" (L = 148 at patch 5 with the temporal
// block: 608 lanes; L = 207 at super_resolution's patch 7: 832, 688 at its
// coarsest level; with the temporal block too, L = 256: 1,040).  The
// function is packed2k_best.cu's: per query row m, the lexicographic
// (score, lowest index) maximum over DB rows n < N of qa[m, :k_used] .
// wk[n, :k_used], bf16 operands, fp32 accumulation.
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s): at M = 352, N =
// 1,048,576 and 4L + 3 = 831 lanes the products are 618 us and the DB's
// bytes 520 us, so the call is bound by operations.  The design is the
// core's, with what the width leaves: one warpgroup's 64 resident query
// rows take 128 bytes a lane (135 KB at 1,040 lanes, read in 1,056-lane
// boxes), so a block runs one consumer warpgroup and a ring of 64-row
// stages up to 896 lanes and of 32-row stages past them (`tile_rows`):
// two stages at 528-576 lanes, one from 592 on.  With one stage the TMA
// copy of a tile and its wgmma chain do not overlap within a block.

#include "hopper_scan.cuh"

extern "C" {

// qa (m, k) and wk (n, k) bf16, contiguous and 16-byte aligned; k a
// multiple of 128 up to 1,152; k_used a multiple of 16 in (512, 1152],
// query lanes at and past it zero and skipped.  consumers (1), bm,
// stages, tiles_per_chunk and smem come from the launch plan (ops/match.py
// `_packed2kw_plan`); the entry only refuses a plan outside the kernel's
// limits.  The grid is (ceil(m / bm), n_chunks).  part_val/part_idx
// (n_chunks, m) scratch; out_idx/out_val (m,).  Launches on `stream`,
// returns the first CUDA error.
int ia_packed2kw_best(const void* qa, const void* wk, int m, int n, int k,
                      int k_used, int consumers, int bm, int stages,
                      int tiles_per_chunk, int smem, int n_chunks,
                      float* part_val, int* part_idx, int* out_idx,
                      float* out_val, int device, void* stream) {
  if (consumers != 1) return cudaErrorInvalidValue;
  return ia_hopper::scan_best<false, false, ia_hopper::EpiBest, 72, 33>(
      qa, wk, nullptr, nullptr, m, n, k, k_used, consumers, bm, stages,
      tiles_per_chunk, smem, n_chunks, part_val, part_idx, out_idx, out_val,
      device, stream);
}

}  // extern "C"
