// Lexicographic top-2 L2 scan of the bf16 centered DB: instances of the
// bf16 scan template (bf16_scan.cuh) with the top-2 epilogue.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py `_argmin2_kernel`
// (entry `pallas_argmin2_l2_prepadded`, wrapper
// `prepadded_argmin2_queries`), the scan of the two_pass anchor.  Per query
// row m: the two lexicographically smallest (score, index) pairs over DB
// rows of  score = dbn - 2 q.db,  ordered by `_lex_lt` (lowest index on
// ties).  The template keeps the exact negation 2 q.db - dbn as a maximum
// and this file negates back.  Padding rows (+inf dbn) lose every compare;
// with a single real row the second place is (+inf, a padding row).  With
// q_split the query block is (2m, K) hi rows then lo rows, folded.
//
// Blocks write per-chunk top-2 partials; top2_merge_kernel merges them by
// the same order (init `_IDX_INF` = 2^31-1).  Bound at level 0 of npr_1024
// as the per-tile scan's (tile_champions.cu): 2*704*N*68 bf16 operations
// (q_split), ~0.10 ms, against ~0.04 ms to stream the DB's 68 lanes.

#include "bf16_scan.cuh"

using namespace ia_scan;

namespace {

// one warp per query: top-2 over the chunks' partials, negated back
__global__ void top2_merge_kernel(const float* __restrict__ v1p,
                                  const int* __restrict__ i1p,
                                  const float* __restrict__ v2p,
                                  const int* __restrict__ i2p, int m,
                                  int n_chunks, int* __restrict__ i1,
                                  float* __restrict__ v1,
                                  int* __restrict__ i2,
                                  float* __restrict__ v2) {
  const int gm = blockIdx.x, lane = threadIdx.x;
  float a = -INFINITY, b = -INFINITY;
  int ia = INT_MAX, ib = INT_MAX;
  for (int c = lane; c < n_chunks; c += 32) {
    const size_t o = (size_t)c * m + gm;
    fold2(a, ia, b, ib, v1p[o], i1p[o]);
    fold2(a, ia, b, ib, v2p[o], i2p[o]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oa = __shfl_xor_sync(0xffffffffu, a, off);
    const int oia = __shfl_xor_sync(0xffffffffu, ia, off);
    const float ob = __shfl_xor_sync(0xffffffffu, b, off);
    const int oib = __shfl_xor_sync(0xffffffffu, ib, off);
    fold2(a, ia, b, ib, oa, oia);
    fold2(a, ia, b, ib, ob, oib);
  }
  if (lane == 0) {
    i1[gm] = ia;
    v1[gm] = -a;
    i2[gm] = ib;
    v2[gm] = -b;
  }
}

}  // namespace

extern "C" {

// q (m or 2m, k) bf16, db (n, k) bf16, dbn (n,) fp32 full row norms (+inf
// on padding rows).  part_* (n_chunks, m) scratch; i1/v1/i2/v2 (m,).
int ia_argmin2(const void* q, const void* db, const void* dbn, int m, int n,
               int k, int k_used, int q_split, int n_chunks, float* part_v1,
               int* part_i1, float* part_v2, int* part_i2, int* i1,
               float* v1, int* i2, float* v2, int device, void* stream) {
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
  a.val = part_v1;
  a.idx = part_i1;
  a.val2 = part_v2;
  a.idx2 = part_i2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = q_split ? launch_k<true, false, NORM_L2, EPI_TOP2>(k, a, n_chunks, s)
              : launch_k<false, false, NORM_L2, EPI_TOP2>(k, a, n_chunks, s);
  if (e != cudaSuccess) return e;
  top2_merge_kernel<<<m, 32, 0, s>>>(part_v1, part_i1, part_v2, part_i2, m,
                                     n_chunks, i1, v1, i2, v2);
  return cudaGetLastError();
}

}  // extern "C"
