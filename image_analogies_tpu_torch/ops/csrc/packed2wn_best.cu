// The packed2wn form of the packed scan on the Hopper core (hopper_scan.cuh):
// two query sets against two weight streams, the norm riding W1's lanes.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py:523 `_packed_best_kernel`
// (entry `pallas_packed_best` :582) in its form `packed2wn_best` (:781), which
// the main path's packed2k superseded: on no path.  Per query row m: the
// lexicographic (score, lowest index) maximum over DB rows n < N of
//
//   qa[m].W1n[n] + qb[m].W2[n]
//
// over the first k_used lanes, bf16 operands, fp32 accumulation, with qa =
// [q1|q1|1 1 1] and qb = [q2|q1|0] (one (2M, K) tensor), W1n = [d1|d2|n1 n2
// n3] (-||d||^2/2 split into three bf16 lanes, ops/match.py `add_norm_lanes`)
// and W2 = [d1|d3]: packed2's product set with the norm, 4L + 3 lanes of
// products.  Padding rows carry a norm of -3e38 in their lanes and never win.
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s) at M = 352, N = 1,048,576, L
// = 55: 2 M N (4L + 3) products = 166 us, against 140 us to stream both weight
// arrays' used lanes once: operations bound it.  The design is the core's:
// both query sets resident in shared memory, a producer warp's TMA ring, a
// tile's k16 steps in order within each pass into one fp32 accumulator (the
// first design's order, so its val bits), the max-first champion (EpiBest) and
// per-chunk partials that best_merge_kernel reduces by the same rule; 64-row
// DB tiles, 32-row ones past 448 lanes.

#include "hopper_scan.cuh"

extern "C" {

// q (2m, k) rows qa then qb, w1 (n, k) W1n and w2 (n, k) bf16; dbnh is not
// read; all contiguous and 16-byte aligned; k in {128, 256, 384, 512}; lanes
// at and past k_used (a multiple of 16) are skipped.  The launch plan
// (consumers, bm, stages, tiles_per_chunk, smem, n_chunks) comes from
// ops/match.py `_packed_form_plan`; part_val/part_idx (n_chunks, m) scratch;
// out_idx/out_val (m,).  Launches on `stream`, returns the first CUDA error
// (ia_hopper::scan_best).
int ia_packed2wn_best(const void* q, const void* w1, const void* w2,
                      const void* dbnh, int m, int n, int k, int k_used,
                      int consumers, int bm, int stages, int tiles_per_chunk,
                      int smem, int n_chunks, float* part_val, int* part_idx,
                      int* out_idx, float* out_val, int device, void* stream) {
  return ia_hopper::scan_best<false, true, ia_hopper::EpiBest>(
      q, w1, w2, nullptr, m, n, k, k_used, consumers, bm, stages,
      tiles_per_chunk, smem, n_chunks, part_val, part_idx, out_idx, out_val,
      device, stream);
}

}  // extern "C"
