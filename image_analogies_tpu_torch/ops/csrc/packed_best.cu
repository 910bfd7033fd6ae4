// Global-champion instances of the bf16 scan template (bf16_scan.cuh).
//
// Replaces: image_analogies_tpu/ops/pallas_match.py `_packed_best_kernel`
// (entry `pallas_packed_best`) in four of its six forms; packed2k (the main
// path's scan: no fold, one stream, the norm in W's lanes) is
// packed2k_best.cu, packed3 (exact_hi2) is packed3_best.cu up to 256 lanes
// and packed3w_best.cu past them, all on Hopper kernels:
//
//   form       FOLD  TWO  norm        product set (score maximised)
//   packed2    no    yes  - dbnh      [q1|q1].W1 + [q2|q1].W2
//   packed1w   yes   no   - dbnh      [q1|q1].W1 + [q2|0].W1
//   packed2wn  no    yes  in W lanes  [q1|q1|1].W1n + [q2|q1|0].W2
//   packed1wn  yes   no   in W lanes  [q1|q1|1].W1n + [q2|0|0].W1n
//
// Per query row m: the lexicographic (score, lowest index) maximum over DB
// rows.  Blocks write one partial per (query, DB chunk); best_merge_kernel
// reduces them by the same rule — deterministic, no float atomics.  The
// bound and design are in bf16_scan.cuh.

#include "bf16_scan.cuh"

using namespace ia_scan;

namespace {

template <bool FOLD, bool TWO, int NORM>
int launch_best(int k, const ScanArgs& a, int n_chunks, int* out_idx,
                float* out_val, cudaStream_t s) {
  int e = launch_k<FOLD, TWO, NORM, EPI_BEST>(k, a, n_chunks, s);
  if (e != cudaSuccess) return e;
  best_merge_kernel<<<a.m, 32, 0, s>>>(a.val, a.idx, a.m, n_chunks, out_idx,
                                       out_val);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qa (m or 2m, k), qb (m, k), w1/w2 (n, k) bf16; dbnh (n,) fp32 — all
// contiguous and 16-byte aligned; qb/w2/dbnh may be null where the form
// does not read them.  k in {128, 256, 384, 512}; lanes >= k_used (a
// multiple of 16) are skipped.  part_val/part_idx (n_chunks, m) scratch;
// out_idx/out_val (m,).  Launches on `stream`, returns cudaGetLastError().
// The packed2k form (fold_a = 0, two_streams = 0, norm_in_w = 1) is not
// taken: its entry is ia_packed2k_best; nor is packed3 (fold_a = 1,
// two_streams = 1, norm_in_w = 0), whose entries are ia_packed3_best and
// ia_packed3w_best.
int ia_packed_best(const void* qa, const void* qb, const void* w1,
                   const void* w2, const void* dbnh, int m, int n, int k,
                   int k_used, int fold_a, int two_streams, int norm_in_w,
                   int n_chunks, float* part_val, int* part_idx,
                   int* out_idx, float* out_val, int device, void* stream) {
  if (!shape_ok(m, n, k, k_used, n_chunks)) return cudaErrorInvalidValue;
  int e = use_device(device);
  if (e != cudaSuccess) return e;
  ScanArgs a{};
  a.qa = static_cast<const __nv_bfloat16*>(qa);
  a.qb = static_cast<const __nv_bfloat16*>(qb);
  a.w1 = static_cast<const __nv_bfloat16*>(w1);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.norm = static_cast<const float*>(dbnh);
  a.m = m;
  a.n = n;
  a.ksteps_used = k_used / 16;
  const int n_tiles = (n + BN - 1) / BN;
  a.tiles_per_chunk = (n_tiles + n_chunks - 1) / n_chunks;
  a.val = part_val;
  a.idx = part_idx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int form = (fold_a ? 4 : 0) | (two_streams ? 2 : 0) |
                   (norm_in_w ? 1 : 0);
  switch (form) {
    case 2:  // packed2
      return launch_best<false, true, NORM_SUB>(k, a, n_chunks, out_idx,
                                                out_val, s);
    case 4:  // packed1w
      return launch_best<true, false, NORM_SUB>(k, a, n_chunks, out_idx,
                                                out_val, s);
    case 3:  // packed2wn
      return launch_best<false, true, NORM_IN_W>(k, a, n_chunks, out_idx,
                                                 out_val, s);
    case 5:  // packed1wn
      return launch_best<true, false, NORM_IN_W>(k, a, n_chunks, out_idx,
                                                 out_val, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
