// The packed2k instance of the Hopper scan core (hopper_scan.cuh): the
// main path's scan at levels 0-1 of npr_1024.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py:523
// `_packed_best_kernel` in its form `packed2k_best` (:739).  Per query row
// m: the lexicographic (score, lowest index) maximum over DB rows n < N of
// qa[m, :k_used] . wk[n, :k_used], bf16 operands, fp32 accumulation, with
// qa rows [q1|q1|1 1 1|q2|q1|0] and wk rows [d1|d2|n1 n2 n3|d1|d3|0]: the
// product set q1.d1 + q1.d2 + q2.d1 + q1.d3 - |d|^2/2, the norm riding
// three bf16 lanes.  The other forms are packed3_best.cu (and
// packed3w_best.cu past 256 lanes) and, on no path, packed2_best.cu,
// packed1w_best.cu, packed2wn_best.cu and packed1wn_best.cu.
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s): at level 0 (N =
// 1,048,576, 223 used lanes) the DB alone is 140 us of bytes; the products
// are 163 us at M = 344 (the port's widest batch), so the widest segment
// is bound by operations and the narrower ones (M <= 256) by bytes.  The
// design (hopper_scan.cuh) reads the DB once per call through a TMA ring
// with exactly the used lanes, and keeps both product operands in shared
// memory for `wgmma`.

#include "hopper_scan.cuh"

extern "C" {

// qa (m, k) and wk (n, k) bf16, contiguous and 16-byte aligned; k in
// {128, 256, 384, 512}; query lanes at and past k_used (a multiple of 16)
// are zero and skipped.  consumers (warpgroups of 64 query rows, 2 or 3),
// bm (query rows a block, <= 64 consumers), stages (ring depth),
// tiles_per_chunk (64-row tiles a block) and smem (dynamic shared memory
// of a block) come from the launch plan (ops/match.py `_packed2k_plan`);
// the entry only refuses a plan outside the kernel's limits.  The grid is
// (ceil(m / bm), n_chunks).  part_val/part_idx (n_chunks, m) scratch;
// out_idx/out_val (m,).  Launches on `stream`, returns the first CUDA
// error.
int ia_packed2k_best(const void* qa, const void* wk, int m, int n, int k,
                     int k_used, int consumers, int bm, int stages,
                     int tiles_per_chunk, int smem, int n_chunks,
                     float* part_val, int* part_idx, int* out_idx,
                     float* out_val, int device, void* stream) {
  if (consumers < 2) return cudaErrorInvalidValue;
  return ia_hopper::scan_best<false, false, ia_hopper::EpiBest>(
      qa, wk, nullptr, nullptr, m, n, k, k_used, consumers, bm, stages,
      tiles_per_chunk, smem, n_chunks, part_val, part_idx, out_idx, out_val,
      device, stream);
}

}  // extern "C"
