// Lane-packed bf16 champion scan on the tensor cores, for Hopper (sm_90a).
//
// Replaces: image_analogies_tpu/ops/pallas_match.py `_packed_best_kernel`
// (entry `pallas_packed_best`) in its shipping form `packed2k_best`
// (one_stream=True, norm_in_w=True, fold_a=False) — the exact_hi2_2p anchor
// scan of the wavefront main path.
//
// Computes, per query row m, the lexicographic (score, lowest index)
// maximum over DB rows n of   score[m, n] = qa[m] . wk[n]   with bf16
// operands and fp32 accumulation.  With wk = [d1|d2|n1 n2 n3|d1|d3|0] and
// qa = [q1|q1|1 1 1|q2|q1|0] that one K-wide dot is
// q1.d1 + q1.d2 + q2.d1 + q1.d3 - ||d||^2/2.  bf16 x bf16 products are exact
// in fp32; only the summation order differs from the TPU's.  Padding rows
// carry finite -3e38 norm lanes and lose every max.
//
// What bounds it on this card: at the main path's level 0 (M <= 352
// queries, N = 1,048,576 DB rows, K = 256 lanes, 224 of them used) one call
// streams the whole 448-512 MiB packed DB — ten times the 50 MB L2, so every
// call reads it from HBM (~0.14-0.16 ms at 3.35 TB/s) — and does
// 2*M*N*K ~ 1.7e11 bf16 operations (~0.17 ms at the 989 TFLOP/s dense bf16
// peak).  Both limits are close, so the kernel must read the DB once per
// call and keep the tensor cores busy.
//
// Design (first, simple version): `mma.sync.m16n8k16` bf16 with fp32
// accumulators.  Each warp holds its 16 query rows as A fragments in
// registers for the whole scan; the block's 8 warps (128 queries) share
// 64-row DB tiles staged in shared memory by `cp.async` with double
// buffering (row stride padded by 16 bytes against bank conflicts).  The
// accumulator layout is known (rows g and g+8, columns 2*tig, 2*tig+1), so
// each thread folds its scores into a running lexicographic champion in
// registers; the four threads of a row group reduce by shuffle at the end.
// Blocks over (query tile, DB chunk) run in parallel — query tiles fastest,
// so the blocks sharing a DB chunk read it together and hit L2 — and write
// partial (score, idx) pairs that a second kernel merges with the same
// lexicographic rule: deterministic, no float atomics.  wgmma, TMA and warp
// specialisation are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // queries per block (16 per warp)
constexpr int BN = 64;          // DB rows per shared-memory tile
constexpr int ROW_PAD = 8;      // bf16 elements of padding per tile row

__device__ __forceinline__ bool lex_better(float va, int ia, float vb,
                                           int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_16816(float& c0, float& c1, float& c2,
                                          float& c3, const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void fold(float& bv, int& bi, float v, int i) {
  if (lex_better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

template <int KSTEPS>
__global__ void __launch_bounds__(THREADS, 1)
packed_partial_kernel(const __nv_bfloat16* __restrict__ qa, int m,
                      const __nv_bfloat16* __restrict__ wk, int n,
                      int ksteps_used, int tiles_per_chunk,
                      float* __restrict__ part_val,
                      int* __restrict__ part_idx) {
  constexpr int K = KSTEPS * 16;
  constexpr int LDS = K + ROW_PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BM + warp * 16;
  const bool warp_live = m0 < m;
  const int chunk = blockIdx.y;
  const int n_tiles = (n + BN - 1) / BN;
  const int t_begin = chunk * tiles_per_chunk;
  const int t_end = min(n_tiles, t_begin + tiles_per_chunk);

  // A fragments: rows g / g+8 of this warp's 16 queries, k pairs 2*tig and
  // 2*tig+8 of each 16-wide k step
  uint32_t afrag[KSTEPS][4];
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qa);
  const int r0 = m0 + g, r1 = m0 + g + 8;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int c = ks * 16 + tig * 2;
    const bool ku = ks < ksteps_used;
    afrag[ks][0] = (ku && r0 < m) ? q32[((size_t)r0 * K + c) >> 1] : 0u;
    afrag[ks][1] = (ku && r1 < m) ? q32[((size_t)r1 * K + c) >> 1] : 0u;
    afrag[ks][2] = (ku && r0 < m) ? q32[((size_t)r0 * K + c + 8) >> 1] : 0u;
    afrag[ks][3] = (ku && r1 < m) ? q32[((size_t)r1 * K + c + 8) >> 1] : 0u;
  }

  float bv0 = -INFINITY, bv1 = -INFINITY;
  int bi0 = INT_MAX, bi1 = INT_MAX;

  const int row_chunks = ksteps_used * 2;  // 16-byte pieces per used row
  auto load_tile = [&](int t, int buf) {
    const int n0 = t * BN;
    for (int e = tid; e < BN * row_chunks; e += THREADS) {
      const int r = e / row_chunks, piece = e % row_chunks;
      const int gn = n0 + r;
      __nv_bfloat16* dst = sb + ((size_t)buf * BN + r) * LDS + piece * 8;
      if (gn < n) {
        cp_async16(dst, wk + (size_t)gn * K + piece * 8);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  if (t_begin < t_end) {
    load_tile(t_begin, 0);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      const __nv_bfloat16* tile = sb + (size_t)buf * BN * LDS;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
        const __nv_bfloat16* brow = tile + (nt * 8 + g) * LDS + tig * 2;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          if (ks < ksteps_used) {
            const uint32_t b0 =
                *reinterpret_cast<const uint32_t*>(brow + ks * 16);
            const uint32_t b1 =
                *reinterpret_cast<const uint32_t*>(brow + ks * 16 + 8);
            mma_16816(c0, c1, c2, c3, afrag[ks], b0, b1);
          }
        }
        const int gn = t * BN + nt * 8 + tig * 2;
        if (gn < n) {
          fold(bv0, bi0, c0, gn);
          fold(bv1, bi1, c2, gn);
        }
        if (gn + 1 < n) {
          fold(bv0, bi0, c1, gn + 1);
          fold(bv1, bi1, c3, gn + 1);
        }
      }
    }
    __syncthreads();
  }

  // the four threads of a row group hold disjoint columns of rows g, g+8
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, bv0, off);
    int oi = __shfl_xor_sync(0xffffffffu, bi0, off);
    fold(bv0, bi0, ov, oi);
    ov = __shfl_xor_sync(0xffffffffu, bv1, off);
    oi = __shfl_xor_sync(0xffffffffu, bi1, off);
    fold(bv1, bi1, ov, oi);
  }
  if (tig == 0) {
    if (r0 < m) {
      part_val[(size_t)chunk * m + r0] = bv0;
      part_idx[(size_t)chunk * m + r0] = bi0;
    }
    if (r1 < m) {
      part_val[(size_t)chunk * m + r1] = bv1;
      part_idx[(size_t)chunk * m + r1] = bi1;
    }
  }
}

// one warp per query: lexicographic maximum over the chunks' partials
__global__ void packed_merge_kernel(const float* __restrict__ part_val,
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
    out_val[gm] = v;
  }
}

int use_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device) return cudaSetDevice(device);
  return cudaSuccess;
}

template <int KSTEPS>
int launch(const __nv_bfloat16* qa, int m, const __nv_bfloat16* wk, int n,
           int ksteps_used, int n_chunks, float* part_val, int* part_idx,
           int* out_idx, float* out_val, cudaStream_t s) {
  constexpr int smem = 2 * BN * (KSTEPS * 16 + ROW_PAD) * 2;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_partial_kernel<KSTEPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles_per_chunk = (n_tiles + n_chunks - 1) / n_chunks;
  dim3 grid((m + BM - 1) / BM, n_chunks);
  packed_partial_kernel<KSTEPS><<<grid, THREADS, smem, s>>>(
      qa, m, wk, n, ksteps_used, tiles_per_chunk, part_val, part_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  packed_merge_kernel<<<m, 32, 0, s>>>(part_val, part_idx, m, n_chunks,
                                       out_idx, out_val);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qa (m, k) bf16, wk (n, k) bf16, both contiguous and 16-byte aligned;
// k in {128, 256, 384, 512}; lanes >= k_used (a multiple of 16) are skipped.
// part_val/part_idx (n_chunks, m) scratch; out_idx/out_val (m,).  Launches
// on `stream` and returns cudaGetLastError().
int ia_packed_best(const void* qa, int m, const void* wk, int n, int k,
                   int k_used, int n_chunks, float* part_val, int* part_idx,
                   int* out_idx, float* out_val, int device, void* stream) {
  if (m <= 0 || n <= 0 || n_chunks <= 0 || k_used <= 0 || k_used > k ||
      k_used % 16 != 0)
    return cudaErrorInvalidValue;
  int e = use_device(device);
  if (e != cudaSuccess) return e;
  const auto* q = static_cast<const __nv_bfloat16*>(qa);
  const auto* w = static_cast<const __nv_bfloat16*>(wk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ku = k_used / 16;
  switch (k) {
    case 128:
      return launch<8>(q, m, w, n, ku, n_chunks, part_val, part_idx, out_idx,
                       out_val, s);
    case 256:
      return launch<16>(q, m, w, n, ku, n_chunks, part_val, part_idx,
                        out_idx, out_val, s);
    case 384:
      return launch<24>(q, m, w, n, ku, n_chunks, part_val, part_idx,
                        out_idx, out_val, s);
    case 512:
      return launch<32>(q, m, w, n, ku, n_chunks, part_val, part_idx,
                        out_idx, out_val, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* ia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
