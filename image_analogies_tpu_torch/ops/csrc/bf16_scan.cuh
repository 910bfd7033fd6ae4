// The first-design bf16 tensor-core scan template (sm_90a, mma.sync),
// the core of the champion scans not yet on the Hopper core
// (hopper_scan.cuh, which serves packed2k, packed3, argmin2,
// pertile_champions and argmin_bf16): packed_best.cu (the four superseded
// packed forms) and tile_champions.cu (packed_champions) each instantiate
// it and add their C entry.
//
// Replaces the family of Pallas kernels in
// image_analogies_tpu/ops/pallas_match.py that score bf16 query rows
// against a bf16 DB with fp32 accumulation and keep a champion:
// `_packed_best_kernel` (global champion, its forms but packed2k),
// `_packed_kernel` and `_pertile_kernel` (one champion per DB tile).  They
// differ along three compile-time axes:
//
// - passes: one to three (query row block, weight stream) pairs summed into
//   ONE fp32 accumulator — pass 0 is qa rows [0, m) against W1; with FOLD,
//   qa rows [m, 2m) against W1 (the hi/lo or q1/q2 row blocks); with TWO,
//   qb rows [0, m) against W2.  The TPU sums the folded blocks after
//   separate accumulations; one accumulator is another fp32 order, covered
//   by the callers' stated tolerances.
// - norm term: NORM_IN_W (the -||d||^2/2 term rides W's lanes) or NORM_SUB
//   (score = dots - dbnh[n]).
// - epilogue: EPI_BEST (global champion: per-chunk partials + a
//   lexicographic merge), EPI_TILE (one champion per `tile_n` rows, written
//   tile-major (ntiles, m)).  Every comparison is the lexicographic
//   (score, lowest index) rule of `_lex_lt`, so ties go to the lowest row
//   everywhere, exactly as the TPU's strict cross-tile compare plus
//   first-occurrence argmax.
//
// What bounds it on this card: at level 0 of npr_1024 every instance
// streams a DB of 1,048,576 rows once per call (256-512 MiB, ten times the
// 50 MB L2: ~0.08-0.16 ms at 3.35 TB/s) and does 2*rows*N*K_used bf16
// operations (0.12-0.25 ms at the 989 TFLOP/s dense bf16 peak), so the
// kernel must read the DB once per call and keep the tensor cores fed.
//
// Design (first, simple version):
// `mma.sync.m16n8k16` bf16 with fp32 accumulators.  Where they fit (passes
// * K/16 <= 32, at most 128 registers), each warp holds its 16 query rows
// of every pass as A fragments in registers for the whole scan; past that
// (three passes at K >= 256, two at K >= 384: exact_hi2 on RGB sources)
// the warp re-reads each fragment from global memory (L1/L2) once per DB
// tile and applies it to all eight 8-row column blocks, with the same
// accumulation order, so both variants give the same bits.  The block's 8
// warps (128 queries) share 64-row DB tiles of each stream, staged in
// shared memory by `cp.async` with double buffering (single buffering where
// two streams at K = 512 would not fit; row stride padded by 16 bytes
// against bank conflicts).  The accumulator layout is known (rows g and
// g+8, columns 2*tig and 2*tig+1), so each thread folds its scores into
// running champions in registers; the four threads of a row group reduce
// by shuffle.  Blocks over (query tile, DB chunk) run in parallel, query
// tiles fastest so the blocks sharing a DB chunk read it together and hit
// L2.  Lanes at and past k_used are skipped (zero on the query side).
// wgmma, TMA and warp specialisation are hopper_scan.cuh's; each instance
// here moves there in its own redesign.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace ia_scan {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // output query rows per block (16 per warp)
constexpr int BN = 64;          // DB rows per shared-memory tile
constexpr int ROW_PAD = 8;      // bf16 elements of padding per tile row
// A fragments live in registers up to passes * K/16 = 32 k-steps (four
// words each); past that they are re-read per DB tile
constexpr int MAX_FRAG_STEPS = 32;
// shared memory a block may opt into on sm_90 (227 KiB)
constexpr int SMEM_MAX = 232448;

enum Norm { NORM_IN_W = 0, NORM_SUB = 1 };
enum Epi { EPI_BEST = 0, EPI_TILE = 1 };

struct ScanArgs {
  const __nv_bfloat16* qa;  // (m, k), or (2m, k) with FOLD
  const __nv_bfloat16* qb;  // (m, k) against w2 (TWO only)
  const __nv_bfloat16* w1;  // (n, k)
  const __nv_bfloat16* w2;  // (n, k) (TWO only)
  const float* norm;        // (n,): dbnh (NORM_SUB)
  int m, n, ksteps_used;
  int tiles_per_chunk;  // BN-row tiles per block
  int tile_sub;         // EPI_TILE: BN-row tiles per output tile
  // EPI_BEST: partials (n_chunks, m); EPI_TILE: (ntiles, m)
  float* val;
  int* idx;
};

__device__ __forceinline__ bool lex_better(float va, int ia, float vb,
                                           int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void fold(float& bv, int& bi, float v, int i) {
  if (lex_better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

// insert (v, i) into the sorted pair (v1, i1) > (v2, i2); keys are distinct
// (the top-2 merges of argmin2.cu and hopper_scan.cuh's EpiTop2)
__device__ __forceinline__ void fold2(float& v1, int& i1, float& v2, int& i2,
                                      float v, int i) {
  if (lex_better(v, i, v1, i1)) {
    v2 = v1;
    i2 = i1;
    v1 = v;
    i1 = i;
  } else if (lex_better(v, i, v2, i2)) {
    v2 = v;
    i2 = i;
  }
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

template <bool FOLD, bool TWO>
struct Passes {
  static constexpr int count = 1 + (FOLD ? 1 : 0) + (TWO ? 1 : 0);
  static constexpr int streams = TWO ? 2 : 1;
  // pass p reads stream 1 (W2) only for the last pass of a TWO scan
  static constexpr __host__ __device__ int stream(int p) {
    return (TWO && p == count - 1) ? 1 : 0;
  }
};

// the layout of one instance: whether the A fragments stay in registers,
// how many DB tile buffers, and the dynamic shared memory they take
template <int KSTEPS, bool FOLD, bool TWO>
struct Layout {
  using P = Passes<FOLD, TWO>;
  static constexpr bool a_regs = P::count * KSTEPS <= MAX_FRAG_STEPS;
  static constexpr int tile_bytes = P::streams * BN * (KSTEPS * 16 + ROW_PAD)
                                    * 2;
  static constexpr int nbuf = 2 * tile_bytes <= SMEM_MAX ? 2 : 1;
  static constexpr int smem = nbuf * tile_bytes;
};

// the score a champion is kept on: bigger is better for every form
template <int NORM>
__device__ __forceinline__ float score(float dots, const float* norm,
                                       int gn) {
  if constexpr (NORM == NORM_SUB) {
    return dots - __ldg(norm + gn);
  } else {
    return dots;
  }
}

template <int KSTEPS, bool FOLD, bool TWO, int NORM, int EPI>
__global__ void __launch_bounds__(THREADS, 1) scan_kernel(ScanArgs a) {
  using P = Passes<FOLD, TWO>;
  using L = Layout<KSTEPS, FOLD, TWO>;
  constexpr int PASSES = P::count;
  constexpr int STREAMS = P::streams;
  constexpr int K = KSTEPS * 16;
  constexpr int LDS = K + ROW_PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [buffer][stream][BN][LDS], L::nbuf buffers
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int m = a.m, n = a.n;
  const int m0 = blockIdx.x * BM + warp * 16;
  const bool warp_live = m0 < m;
  const int chunk = blockIdx.y;
  const int n_tiles = (n + BN - 1) / BN;
  const int t_begin = chunk * a.tiles_per_chunk;
  const int t_end = min(n_tiles, t_begin + a.tiles_per_chunk);
  const int ksteps_used = a.ksteps_used;

  // the A fragment of pass p, k step ks: rows g / g+8 of this warp's 16
  // queries, k pairs 2*tig and 2*tig+8 of the 16-wide k step
  const int r0 = m0 + g, r1 = m0 + g + 8;
  auto load_frag = [&](int p, int ks, uint32_t(&f)[4]) {
    const bool from_b = TWO && p == PASSES - 1;
    const int off = (FOLD && p == 1) ? m : 0;  // the folded row block
    const uint32_t* q32 =
        reinterpret_cast<const uint32_t*>(from_b ? a.qb : a.qa);
    const size_t s0 = (size_t)(r0 + off) * K, s1 = (size_t)(r1 + off) * K;
    const int c = ks * 16 + tig * 2;
    const bool ku = ks < ksteps_used;
    f[0] = (ku && r0 < m) ? __ldg(q32 + ((s0 + c) >> 1)) : 0u;
    f[1] = (ku && r1 < m) ? __ldg(q32 + ((s1 + c) >> 1)) : 0u;
    f[2] = (ku && r0 < m) ? __ldg(q32 + ((s0 + c + 8) >> 1)) : 0u;
    f[3] = (ku && r1 < m) ? __ldg(q32 + ((s1 + c + 8) >> 1)) : 0u;
  };
  // every pass's fragments in registers, where they fit
  uint32_t afrag[L::a_regs ? PASSES : 1][L::a_regs ? KSTEPS : 1][4];
  if constexpr (L::a_regs) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) load_frag(p, ks, afrag[p][ks]);
    }
  }

  float bv0 = -INFINITY, bv1 = -INFINITY;
  int bi0 = INT_MAX, bi1 = INT_MAX;

  const int row_chunks = ksteps_used * 2;  // 16-byte pieces per used row
  auto load_tile = [&](int t, int buf) {
    const int n0 = t * BN;
#pragma unroll
    for (int s = 0; s < STREAMS; ++s) {
      const __nv_bfloat16* w = s == 0 ? a.w1 : a.w2;
      for (int e = tid; e < BN * row_chunks; e += THREADS) {
        const int r = e / row_chunks, piece = e % row_chunks;
        const int gn = n0 + r;
        __nv_bfloat16* dst =
            sb + (((size_t)buf * STREAMS + s) * BN + r) * LDS + piece * 8;
        if (gn < n) {
          cp_async16(dst, w + (size_t)gn * K + piece * 8);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  };

  // the B fragment of pass p, column block nt, k step ks from the tile
  auto load_b = [&](int buf, int p, int nt, int ks, uint32_t& b0,
                    uint32_t& b1) {
    const __nv_bfloat16* brow =
        sb + (((size_t)buf * STREAMS + P::stream(p)) * BN + nt * 8 + g) *
                 LDS + tig * 2 + ks * 16;
    b0 = *reinterpret_cast<const uint32_t*>(brow);
    b1 = *reinterpret_cast<const uint32_t*>(brow + 8);
  };

  // the four threads of a row group hold disjoint columns of rows g, g+8
  auto reduce_quad = [&]() {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov0 = __shfl_xor_sync(0xffffffffu, bv0, off);
      const int oi0 = __shfl_xor_sync(0xffffffffu, bi0, off);
      const float ov1 = __shfl_xor_sync(0xffffffffu, bv1, off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, bi1, off);
      fold(bv0, bi0, ov0, oi0);
      fold(bv1, bi1, ov1, oi1);
    }
  };

  // fold the scores of column block nt of tile t into the champions
  auto consume = [&](int t, int nt, float c0, float c1, float c2,
                     float c3) {
    const int gn = t * BN + nt * 8 + tig * 2;
    if (gn < n) {
      fold(bv0, bi0, score<NORM>(c0, a.norm, gn), gn);
      fold(bv1, bi1, score<NORM>(c2, a.norm, gn), gn);
    }
    if (gn + 1 < n) {
      fold(bv0, bi0, score<NORM>(c1, a.norm, gn + 1), gn + 1);
      fold(bv1, bi1, score<NORM>(c3, a.norm, gn + 1), gn + 1);
    }
  };

  if (L::nbuf == 2 && t_begin < t_end) {
    load_tile(t_begin, 0);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = L::nbuf == 2 ? (t - t_begin) & 1 : 0;
    if (L::nbuf == 1) {
      load_tile(t, 0);
      cp_async_commit();
      cp_async_wait<0>();
    } else if (t + 1 < t_end) {
      load_tile(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      if constexpr (L::a_regs) {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
#pragma unroll
          for (int p = 0; p < PASSES; ++p) {
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks) {
              if (ks < ksteps_used) {
                uint32_t b0, b1;
                load_b(buf, p, nt, ks, b0, b1);
                mma_16816(c0, c1, c2, c3, afrag[p][ks], b0, b1);
              }
            }
          }
          consume(t, nt, c0, c1, c2, c3);
        }
      } else {
        // one fragment at a time against every column block: each
        // accumulator sees the same (pass, k step) order as above
        float acc[BN / 8][4];
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
          acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
#pragma unroll 1
          for (int ks = 0; ks < ksteps_used; ++ks) {
            uint32_t f[4];
            load_frag(p, ks, f);
#pragma unroll
            for (int nt = 0; nt < BN / 8; ++nt) {
              uint32_t b0, b1;
              load_b(buf, p, nt, ks, b0, b1);
              mma_16816(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3], f,
                        b0, b1);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
          consume(t, nt, acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
      }
      if constexpr (EPI == EPI_TILE) {
        // the block's chunk holds whole output tiles: flush at each end
        if ((t + 1) % a.tile_sub == 0) {
          reduce_quad();
          const size_t o = (size_t)(t / a.tile_sub) * m;
          if (tig == 0) {
            if (r0 < m) {
              a.val[o + r0] = bv0;
              a.idx[o + r0] = bi0;
            }
            if (r1 < m) {
              a.val[o + r1] = bv1;
              a.idx[o + r1] = bi1;
            }
          }
          bv0 = bv1 = -INFINITY;
          bi0 = bi1 = INT_MAX;
        }
      }
    }
    __syncthreads();
  }

  if constexpr (EPI != EPI_TILE) {
    reduce_quad();
    if (tig == 0) {
      const size_t o = (size_t)chunk * m;
      if (r0 < m) {
        a.val[o + r0] = bv0;
        a.idx[o + r0] = bi0;
      }
      if (r1 < m) {
        a.val[o + r1] = bv1;
        a.idx[o + r1] = bi1;
      }
    }
  }
}

// one warp per query: lexicographic maximum over the chunks' partials
__global__ void best_merge_kernel(const float* __restrict__ part_val,
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

inline int use_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device) return cudaSetDevice(device);
  return cudaSuccess;
}

// Launch one instance over grid (query tiles, n_chunks); returns
// cudaGetLastError().
template <int KSTEPS, bool FOLD, bool TWO, int NORM, int EPI>
int launch_scan(const ScanArgs& a, int n_chunks, cudaStream_t s) {
  constexpr int smem = Layout<KSTEPS, FOLD, TWO>::smem;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<KSTEPS, FOLD, TWO, NORM, EPI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.m + BM - 1) / BM, n_chunks);
  scan_kernel<KSTEPS, FOLD, TWO, NORM, EPI><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// K in {128, 256, 384, 512} -> the instance with K/16 k-steps
template <bool FOLD, bool TWO, int NORM, int EPI>
int launch_k(int k, const ScanArgs& a, int n_chunks, cudaStream_t s) {
  switch (k) {
    case 128:
      return launch_scan<8, FOLD, TWO, NORM, EPI>(a, n_chunks, s);
    case 256:
      return launch_scan<16, FOLD, TWO, NORM, EPI>(a, n_chunks, s);
    case 384:
      return launch_scan<24, FOLD, TWO, NORM, EPI>(a, n_chunks, s);
    case 512:
      return launch_scan<32, FOLD, TWO, NORM, EPI>(a, n_chunks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// common argument checks of the C entries
inline bool shape_ok(int m, int n, int k, int k_used, int n_chunks) {
  return m > 0 && n > 0 && n_chunks > 0 && k_used > 0 && k_used <= k &&
         k_used % 16 == 0 && k % 128 == 0 && k <= 512;
}

}  // namespace ia_scan

extern "C" const char* ia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
