// Single-bf16-pass L2 argmin: an instance of the bf16 scan template
// (bf16_scan.cuh) with one pass, the L2 norm term and the global epilogue.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py `_argmin_kernel` as the
// batched and rowwise strategies reach it, at Precision.DEFAULT: one bf16
// MXU pass with fp32 accumulation, which `pallas_argmin_l2(bf16=True)`
// spells out with explicit bf16 operands (entry
// `pallas_argmin_l2_prepadded`, wrapper `prepadded_argmin_queries`).  Per
// query row m: the lexicographic (score, lowest index) minimum over DB rows
// of  score = dbn - 2 q.db,  q and db rounded to bf16, dbn the exact fp32
// norm of the unrounded row and +inf on padding rows, which lose every
// compare.  The template keeps the exact negation 2 q.db - dbn as a
// maximum; l2_merge_kernel merges the per-chunk partials by the same order
// (init `_IDX_INF` = 2^31-1, so an empty chunk loses to every real row) and
// negates back.
//
// Bound at level 0 of batched npr_1024 (M = 1024 queries, N = 1,048,576
// rows, F = 68 live lanes of 128): 2*M*N*F = 1.46e11 bf16 operations, ~148
// us at 989 TFLOP/s, against ~47 us to stream the DB's 68 lanes and its
// norms at 3.35 TB/s: bound by operations.  At M = 1024 the grid holds
// eight 128-row query tiles, so each DB chunk is read by eight blocks at
// once and the DB streams from device memory about once per call.

#include "bf16_scan.cuh"

using namespace ia_scan;

namespace {

// one warp per query: lexicographic maximum over the chunks' partials,
// negated back to dbn - 2 dots
__global__ void l2_merge_kernel(const float* __restrict__ part_val,
                                const int* __restrict__ part_idx, int m,
                                int n_chunks, int* __restrict__ out_idx,
                                float* __restrict__ out_val) {
  const int gm = blockIdx.x, lane = threadIdx.x;
  float v = -INFINITY;
  int id = INT_MAX;
  for (int c = lane; c < n_chunks; c += 32)
    fold(v, id, part_val[(size_t)c * m + gm], part_idx[(size_t)c * m + gm]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, id, off);
    fold(v, id, ov, oi);
  }
  if (lane == 0) {
    out_idx[gm] = id;
    out_val[gm] = -v;
  }
}

}  // namespace

extern "C" {

// q (m, k) bf16, db (n, k) bf16, dbn (n,) fp32 full row norms (+inf on
// padding rows).  part_* (n_chunks, m) scratch; out_idx/out_val (m,).
int ia_argmin_l2_bf16(const void* q, const void* db, const void* dbn, int m,
                      int n, int k, int k_used, int n_chunks,
                      float* part_val, int* part_idx, int* out_idx,
                      float* out_val, int device, void* stream) {
  if (!shape_ok(m, n, k, k_used, n_chunks)) return cudaErrorInvalidValue;
  int e = use_device(device);
  if (e != cudaSuccess) return e;
  ScanArgs a{};
  a.qa = static_cast<const __nv_bfloat16*>(q);
  a.w1 = static_cast<const __nv_bfloat16*>(db);
  a.norm = static_cast<const float*>(dbn);
  a.m = m;
  a.n = n;
  a.ksteps_used = k_used / 16;
  const int n_tiles = (n + BN - 1) / BN;
  a.tiles_per_chunk = (n_tiles + n_chunks - 1) / n_chunks;
  a.val = part_val;
  a.idx = part_idx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = launch_k<false, false, NORM_L2, EPI_BEST>(k, a, n_chunks, s);
  if (e != cudaSuccess) return e;
  l2_merge_kernel<<<m, 32, 0, s>>>(part_val, part_idx, m, n_chunks, out_idx,
                                   out_val);
  return cudaGetLastError();
}

}  // extern "C"
