// The packed1w form of the packed scan on the Hopper core (hopper_scan.cuh):
// two folded query sets against one weight stream, the half norms in the ring.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py:523 `_packed_best_kernel`
// (entry `pallas_packed_best` :582) in its form `packed1w_best` (:673), which
// the main path's packed2k superseded: on no path.  Per query row m: the
// lexicographic (score, lowest index) maximum over DB rows n < N of
//
//   q[m].W1[n] + q[M+m].W1[n] - dbnh[n]
//
// over the first k_used lanes, bf16 operands, fp32 accumulation, with the
// query rows [q1|q1] and [q2|0] (one (2M, K) tensor) and W1 = [d1|d2]: q1.d1 +
// q1.d2 + q2.d1, 3L lanes of products (the JAX package rejected the form for
// parity).  Padding rows carry dbnh = +inf and never win.
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s) at M = 352, N = 1,048,576, L
// = 55: two passes of 2 M N 2L products (3L of them nonzero: 123 us), against
// 70 us to stream W1's 2L lanes and the half norms once: operations bound it.
// The design is the core's: both query sets resident in shared memory, a
// producer warp's TMA ring, a tile's k16 steps in order within each pass into
// one fp32 accumulator (the first design's order, so its val bits), the
// max-first champion (EpiBestSub) and per-chunk partials that
// best_merge_kernel reduces by the same rule; 64-row DB tiles at every width.

#include "hopper_scan.cuh"

extern "C" {

// q (2m, k) rows [q1|q1] then [q2|0], w1 (n, k) bf16, dbnh (n,) fp32 half
// norms (+inf on padding rows); w2 is not read; all contiguous and 16-byte
// aligned; k in {128, 256, 384, 512}; lanes at and past k_used (a multiple of
// 16) are skipped.  The launch plan (consumers, bm, stages, tiles_per_chunk,
// smem, n_chunks) comes from ops/match.py `_packed_form_plan`;
// part_val/part_idx (n_chunks, m) scratch; out_idx/out_val (m,).  Launches on
// `stream`, returns the first CUDA error (ia_hopper::scan_best).
int ia_packed1w_best(const void* q, const void* w1, const void* w2,
                     const void* dbnh, int m, int n, int k, int k_used,
                     int consumers, int bm, int stages, int tiles_per_chunk,
                     int smem, int n_chunks, float* part_val, int* part_idx,
                     int* out_idx, float* out_val, int device, void* stream) {
  return ia_hopper::scan_best<true, false, ia_hopper::EpiBestSub>(
      q, w1, nullptr, dbnh, m, n, k, k_used, consumers, bm, stages,
      tiles_per_chunk, smem, n_chunks, part_val, part_idx, out_idx, out_val,
      device, stream);
}

}  // extern "C"
