// The packed3 instance of the Hopper scan core (hopper_scan.cuh): the
// exact_hi2 scan up to 256 lanes.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py:523
// `_packed_best_kernel` in its form `packed3_best` (:840, entry
// `pallas_packed_best` :582).  Per query row m: the lexicographic (score,
// lowest index) maximum over DB rows n < N of
//
//   q[m].W1[n] + q[M+m].W1[n] + q[2M+m].W2[n] - dbnh[n]
//
// over the first k_used lanes, bf16 operands, fp32 accumulation, with the
// query rows [q1|q1], [q2|q2], [q1|q3] (one (3M, K) tensor) and W1 =
// [d1|d2], W2 = [d3|d1]: the six products of exact_hi2's bf16_6x set.
// Padding rows carry dbnh = +inf and never win.  Past 256 lanes three
// resident query sets leave no room for one ring stage of both streams:
// those widths are packed3w_best.cu's (ops/match.py `_packed3_route`).
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s) at level 0 of npr_1024
// (M = 352, N = 1,048,576, 2L = 110 of 128 lanes): three passes of 2 x 352
// x N x 110 products = 246 us, against 0.14 ms to stream both weight
// arrays' used lanes and the norms once; so operations bound it.  The
// design (hopper_scan.cuh): every stage of the TMA ring carries the W1 and
// the W2 tile (four 32-lane boxes each, 512 bytes a row) and the tile's
// fp32 norms; each consumer warpgroup keeps its three query sets resident
// and runs a tile's chain, pass 0 and 1 against W1, pass 2 against W2, k16
// steps in order within each pass (the first design's order, so its val
// bits), into one accumulator; the epilogue subtracts the
// stage's norms and keeps the champion (EpiBestSub).  Blocks write
// per-chunk partials; best_merge_kernel reduces them by the same rule.

#include "hopper_scan.cuh"

namespace {

constexpr int KMAX = 16;  // k_used <= 256 (ops/match.py `_packed3_route`)

}  // namespace

extern "C" {

// q (3m, k) rows [q1|q1] then [q2|q2] then [q1|q3], w1/w2 (n, k) bf16,
// dbnh (n,) fp32 half norms (+inf on padding rows), all contiguous and
// 16-byte aligned; k in {128, 256, 384, 512}; lanes at and past k_used (a
// multiple of 16, at most 256) are skipped.  consumers (warpgroups of 64
// query rows, 1..3), bm (query rows a block), stages (ring depth),
// tiles_per_chunk (64-row DB tiles a block) and smem come from the launch
// plan (ops/match.py `_packed3_plan`); the entry only refuses a plan
// outside the kernel's limits.  part_val/part_idx (n_chunks, m)
// scratch; out_idx/out_val (m,).  Launches on `stream`, returns the first
// CUDA error.
int ia_packed3_best(const void* q, const void* w1, const void* w2,
                    const void* dbnh, int m, int n, int k, int k_used,
                    int consumers, int bm, int stages,
                    int tiles_per_chunk, int smem, int n_chunks,
                    float* part_val, int* part_idx, int* out_idx,
                    float* out_val, int device, void* stream) {
  return ia_hopper::scan_best<true, true, ia_hopper::EpiBestSub, KMAX>(
      q, w1, w2, dbnh, m, n, k, k_used, consumers, bm, stages,
      tiles_per_chunk, smem, n_chunks, part_val, part_idx, out_idx, out_val,
      device, stream);
}

}  // extern "C"
