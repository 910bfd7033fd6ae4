// Per-tile champion scans: instances of the first-design bf16 scan
// template (bf16_scan.cuh) with the per-tile epilogue.  On the card only
// `packed_champions` runs here; `pertile_champions` (scan_rescue's scan)
// runs pertile_champions.cu on the Hopper core, and the entry's one-stream
// form (the scan_rescue scan of the first design) is kept for the same
// C interface.
//
// Replaces, in image_analogies_tpu/ops/pallas_match.py, `_packed_kernel`
// (entry `pallas_packed_champions`, wrappers `packed2_champions` /
// `packed3_champions`): two streams, qa.W1 [+ qa_fold.W1] + qb.W2 - dbnh.
// The product sets and the bound are those of packed_best.cu's packed2 /
// packed3 forms; the JAX tests use this entry as the witness that the
// in-kernel champion equals per-tile champions plus a select.
//
// Per query row m and DB tile t of `tile_n` rows: (max, argmax) written
// tile-major to (ntiles, m).  Ties go to the first row of the tile; an
// all-padding tile (+inf dbnh) gives -inf at its first row, as `jnp.argmax`
// over -inf does.

#include "bf16_scan.cuh"

using namespace ia_scan;

extern "C" {

// qa (m or 2m, k), w1 (n, k) bf16, dbnh (n,) fp32; with two_streams also
// qb (m, k) and w2 (n, k) bf16 (null otherwise).  n a multiple of tile_n,
// tile_n a multiple of 64.  out_val/out_idx (n / tile_n, m).  n_chunks: DB
// chunks of whole tiles.
int ia_tile_champions(const void* qa, const void* qb, const void* w1,
                      const void* w2, const void* dbnh, int m, int n, int k,
                      int k_used, int fold_a, int two_streams, int tile_n,
                      int n_chunks, float* out_val, int* out_idx, int device,
                      void* stream) {
  if (!shape_ok(m, n, k, k_used, n_chunks) || tile_n <= 0 ||
      tile_n % BN != 0 || n % tile_n != 0 ||
      (two_streams && (qb == nullptr || w2 == nullptr)))
    return cudaErrorInvalidValue;
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
  a.tile_sub = tile_n / BN;
  const int ntiles = n / tile_n;
  const int per = (ntiles + n_chunks - 1) / n_chunks;  // tiles per chunk
  a.tiles_per_chunk = per * a.tile_sub;
  a.val = out_val;
  a.idx = out_idx;
  const int chunks = (ntiles + per - 1) / per;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two_streams) {
    return fold_a ? launch_k<true, true, NORM_SUB, EPI_TILE>(k, a, chunks, s)
                  : launch_k<false, true, NORM_SUB, EPI_TILE>(k, a, chunks, s);
  }
  return fold_a ? launch_k<true, false, NORM_SUB, EPI_TILE>(k, a, chunks, s)
                : launch_k<false, false, NORM_SUB, EPI_TILE>(k, a, chunks, s);
}

}  // extern "C"
