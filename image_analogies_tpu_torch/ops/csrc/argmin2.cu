// Lexicographic top-2 L2 scan of the bf16 centered DB: the argmin2
// instances of the Hopper core (hopper_scan.cuh) with the top-2 epilogue
// (EpiTop2), the fp32 norms riding the ring and, under q_split, the hi and
// lo query blocks folded into one accumulator.
//
// Replaces: image_analogies_tpu/ops/pallas_match.py `_argmin2_kernel`
// (entry `pallas_argmin2_l2_prepadded`, wrapper
// `prepadded_argmin2_queries`), the scan of the two_pass anchor.  Per query
// row m: the two lexicographically smallest (score, index) pairs over DB
// rows of  score = dbn - 2 q.db,  ordered by `_lex_lt` (lowest index on
// ties).  The core keeps the exact negation 2 q.db - dbn as a maximum and
// the merge negates back.  Padding rows (+inf dbn) lose every compare;
// with a single real row the second place is (+inf, the lowest padding
// row).  With q_split the query block is (2m, K) hi rows then lo rows,
// folded: each DB tile's hi k steps, then its lo k steps, into one fp32
// accumulator (the order of the first design, which this replaced).
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s) at level 0 of npr_1024
// (M = 352 as 704 hi/lo rows, N = 1,048,576, 80 of 128 lanes used): 2 x
// 704 x N x 80 products = 119 us, against 61 us to stream the DB's three
// 32-lane boxes (192 B a row) and 4 MiB of norms once; so operations bound
// it, and the L2 -> SM traffic of two query tiles reading the DB (~0.4 GB,
// ~0.1 ms at the ~4 TB/s measured for packed2k) is close behind.  The
// design: the products on `wgmma` from shared memory over 128-row DB tiles
// (hopper_scan.cuh: a tile's ten dependent steps, not the tensor cores'
// rate, set the pace, and m64n128k16 does twice the work a step); the
// norms copied once per stage by the producer instead of loaded per score;
// and a top-2 epilogue whose common case is one subtract and one compare a
// score against the running second place and the row's threshold.
//
// Blocks write per-chunk top-2 partials; top2_merge_kernel merges them by
// the same order (init `_IDX_INF` = 2^31-1).

#include "hopper_scan.cuh"

using ia_scan::fold2;

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
// on padding rows), all contiguous and 16-byte aligned; k in {128, 256,
// 384, 512}; lanes at and past k_used (a multiple of 16) are skipped.
// consumers (warpgroups of 64 query rows, 1..3), bm (query rows a block),
// stages (ring depth), tiles_per_chunk and smem come from the launch plan
// (ops/match.py `_argmin2_plan`); the entry only refuses a plan outside
// the kernel's limits.  part_* (n_chunks, m) scratch; i1/v1/i2/v2 (m,).
// Launches on `stream`, returns the first CUDA error.
int ia_argmin2(const void* q, const void* db, const void* dbn, int m, int n,
               int k, int k_used, int q_split, int consumers, int bm,
               int stages, int tiles_per_chunk, int smem, int n_chunks,
               float* part_v1, int* part_i1, float* part_v2, int* part_i2,
               int* i1, float* v1, int* i2, float* v2, int device,
               void* stream) {
  using namespace ia_hopper;
  if (!ia_scan::shape_ok(m, n, k, k_used, n_chunks)) {
    return cudaErrorInvalidValue;
  }
  const int nbox = (k_used + BOX - 1) / BOX;
  if (!plan_ok(n, tile_rows(true, k_used / 16), nbox, consumers, bm,
               stages, tiles_per_chunk, smem, n_chunks,
               query_sets(q_split != 0, false), 1, true)) {
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
  a.norm = static_cast<const float*>(dbn);
  a.val = part_v1;
  a.idx = part_i1;
  a.val2 = part_v2;
  a.idx2 = part_i2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ksteps = k_used / 16;
  e = q_split ? launch_scan_k<true, false, EpiTop2>(ksteps, q, db, nullptr, k,
                                                   a, n_chunks, s)
              : launch_scan_k<false, false, EpiTop2>(ksteps, q, db, nullptr,
                                                     k, a, n_chunks, s);
  if (e != cudaSuccess) return e;
  top2_merge_kernel<<<m, 32, 0, s>>>(part_v1, part_i1, part_v2, part_i2, m,
                                     n_chunks, i1, v1, i2, v2);
  return cudaGetLastError();
}

}  // extern "C"
