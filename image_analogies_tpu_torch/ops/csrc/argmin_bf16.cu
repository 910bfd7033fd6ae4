// Single-bf16-pass L2 argmin: the argmin_bf16 instances of the Hopper core
// (hopper_scan.cuh) with one query set, the fp32 norms riding the ring and
// the global champion of 2 q.db - dbn (EpiBestL2).
//
// Replaces: image_analogies_tpu/ops/pallas_match.py `_argmin_kernel` as the
// batched and rowwise strategies reach it, at Precision.DEFAULT: one bf16
// MXU pass with fp32 accumulation, which `pallas_argmin_l2(bf16=True)`
// spells out with explicit bf16 operands (entry
// `pallas_argmin_l2_prepadded`, wrapper `prepadded_argmin_queries`).  Per
// query row m: the lexicographic (score, lowest index) minimum over DB rows
// of  score = dbn - 2 q.db,  q rounded to bf16 to nearest, db a bf16 DB,
// dbn the exact fp32 norm of the unrounded row and +inf on padding rows,
// which lose every compare.  The core keeps the exact negation 2 q.db - dbn
// as a maximum; l2_merge_kernel merges the per-chunk partials by the same
// order (init `_IDX_INF` = 2^31-1, so a chunk of padding rows only, which
// keeps (-inf, INT_MAX), loses to every real row) and negates back.  A
// tile's k16 steps run in order into one fp32 accumulator and the score is
// one 2 d - n, as in the first design, which this replaced.
//
// Bound on one H100 (989 TFLOP/s bf16, 3.35 TB/s) at level 0 of batched
// npr_1024 (M = 1024 queries, N = 1,048,576 rows, F = 68 live lanes of
// 128): 2 M N F = 1.46e11 bf16 operations, 148 us, against 47 us to stream
// the DB's 68 lanes and its norms once: bound by operations.  The design
// (hopper_scan.cuh): the products on `wgmma` from shared memory over
// 128-row DB tiles (a tile's five dependent m64n128k16 steps at 80 lanes),
// the query rows resident, the DB tiles and their norms copied by a
// producer warp's TMA ring; an epilogue that takes a row's tile maximum
// first (one subtract and one max a score).  Three consumer warpgroups
// hold 192 query rows a block, so M = 1024 takes six query tiles of 171
// rows (ops/match.py `_argmin_bf16_plan`), each reading the DB from L2.
// The entry writes the bf16 query block of fp32 queries itself.

#include "hopper_scan.cuh"

using ia_scan::fold;

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

// q the (m, k) bf16 query block; or with qf32 the (m, k) fp32 queries, of
// which the entry first writes the block, rounded to nearest, into qk ((m,
// k) bf16).  db (n, k) bf16, dbn (n,) fp32 full row norms (+inf on padding
// rows), all contiguous and 16-byte aligned; k in {128, 256, 384, 512};
// lanes at and past k_used (a multiple of 16) are skipped.  consumers
// (warpgroups of 64 query rows, 1..3), bm (query rows a block), stages
// (ring depth), tiles_per_chunk and smem come from the launch plan
// (ops/match.py `_argmin_bf16_plan`); the entry only refuses a plan outside
// the kernel's limits.  part_* (n_chunks, m) scratch; out_idx/out_val
// (m,).  Launches on `stream`, returns the first CUDA error.
int ia_argmin_l2_bf16(const void* q, int qf32, void* qk, const void* db,
                      const void* dbn, int m, int n, int k, int k_used,
                      int consumers, int bm, int stages, int tiles_per_chunk,
                      int smem, int n_chunks, float* part_val, int* part_idx,
                      int* out_idx, float* out_val, int device,
                      void* stream) {
  using namespace ia_hopper;
  if (!ia_scan::shape_ok(m, n, k, k_used, n_chunks) ||
      (qf32 && qk == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int nbox = (k_used + BOX - 1) / BOX;
  if (!plan_ok(n, tile_rows(EpiBestL2::kWide, k_used / 16), nbox, consumers,
               bm, stages, tiles_per_chunk, smem, n_chunks,
               query_sets(false, false), 1, EpiBestL2::kNorms)) {
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
  a.val = part_val;
  a.idx = part_idx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qf32) {
    e = write_scan_queries(static_cast<const float*>(q), m, k, 0,
                           static_cast<__nv_bfloat16*>(qk), s);
    if (e != cudaSuccess) return e;
    q = qk;
  }
  e = launch_scan_k<false, false, EpiBestL2>(k_used / 16, q, db, nullptr, k,
                                             a, n_chunks, s);
  if (e != cudaSuccess) return e;
  l2_merge_kernel<<<m, 32, 0, s>>>(part_val, part_idx, m, n_chunks, out_idx,
                                   out_val);
  return cudaGetLastError();
}

}  // extern "C"
