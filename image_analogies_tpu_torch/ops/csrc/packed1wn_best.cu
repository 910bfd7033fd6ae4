// The packed1wn form of the packed scan on the Hopper core (hopper_scan.cuh):
// two folded query sets against one weight stream, the norm riding its lanes.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py:523 `_packed_best_kernel`
// (entry `pallas_packed_best` :582) in its form `packed1wn_best` (:819), which
// the main path's packed2k superseded: on no path.  Per query row m: the
// lexicographic (score, lowest index) maximum over DB rows n < N of
//
//   q[m].W1n[n] + q[M+m].W1n[n]
//
// over the first k_used lanes, bf16 operands, fp32 accumulation, with the
// query rows [q1|q1|1 1 1] and [q2|0|0] (one (2M, K) tensor, ops/match.py
// `norm_query_rows`) and W1n = [d1|d2|n1 n2 n3]: q1.d1 + q1.d2 + q2.d1 -
// ||d||^2/2, 3L + 3 lanes of products (the JAX package rejected the form for
// parity).  Padding rows carry a norm of -3e38 in their lanes and never win.
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s) at M = 352, N = 1,048,576, L
// = 55: 2 M N (3L + 3) products = 125 us, against 71 us to stream W1n's used
// lanes once: operations bound it.  The design is the core's: both query sets
// resident in shared memory, a producer warp's TMA ring, a tile's k16 steps in
// order within each pass into one fp32 accumulator (the first design's order,
// so its val bits), the max-first champion (EpiBest) and per-chunk partials
// that best_merge_kernel reduces by the same rule; 64-row DB tiles at every
// width.

#include "hopper_scan.cuh"

extern "C" {

// q (2m, k) rows [q1|q1|1 1 1] then [q2|0|0], w1 (n, k) W1n bf16; w2 and dbnh
// are not read; all contiguous and 16-byte aligned; k in {128, 256, 384, 512};
// lanes at and past k_used (a multiple of 16) are skipped.  The launch plan
// (consumers, bm, stages, tiles_per_chunk, smem, n_chunks) comes from
// ops/match.py `_packed_form_plan`; part_val/part_idx (n_chunks, m) scratch;
// out_idx/out_val (m,).  Launches on `stream`, returns the first CUDA error
// (ia_hopper::scan_best).
int ia_packed1wn_best(const void* q, const void* w1, const void* w2,
                      const void* dbnh, int m, int n, int k, int k_used,
                      int consumers, int bm, int stages, int tiles_per_chunk,
                      int smem, int n_chunks, float* part_val, int* part_idx,
                      int* out_idx, float* out_val, int device, void* stream) {
  return ia_hopper::scan_best<true, false, ia_hopper::EpiBest>(
      q, w1, nullptr, nullptr, m, n, k, k_used, consumers, bm, stages,
      tiles_per_chunk, smem, n_chunks, part_val, part_idx, out_idx, out_val,
      device, stream);
}

}  // extern "C"
