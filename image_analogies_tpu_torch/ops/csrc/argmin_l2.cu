// Fused fp32 L2 argmin over the patch DB, for Hopper (sm_90a).
//
// Replaces: image_analogies_tpu/ops/pallas_match.py `_argmin_kernel` at
// Precision.HIGHEST (entry `pallas_argmin_l2_prepadded`), the exact_hi
// anchor scan of the wavefront main path.
//
// Computes, per query m, the lexicographic (score, index) minimum over DB
// rows n of   score[m, n] = dbn[n] - 2 * q[m] . db[n, :F]   (the caller
// adds ||q||^2), lowest index on ties.  Padding rows carry dbn = +inf and
// never beat a real row.  Each score is ONE fmaf chain over k = 0..F-1 in
// order from 0, then dbn - 2*acc: no split-K, no tree sums, no TF32, so the
// scores (and the picks) are the same bits whatever the launch plan.
//
// What bounds it on this card: at the main path's widest shape (level 2 of
// npr_1024: M = 88 queries, N = 65,536 rows, F = 68 of 128 lanes) one call
// does 0.78 GFLOP of fp32 FMAs, 11.7 us at the CUDA cores' 67 TFLOP/s, and
// reads 17.8 MB of DB, 5.4 us at 3.35 TB/s (and the lane-padded DB fits
// the 50 MB L2).  So it is bound by FMA issue, and by the shared-memory
// path that feeds the FMAs: an SM issues four warp-FMAs a cycle but
// delivers one warp-wide float a cycle from shared memory (a broadcast
// LDS.128 still writes 512 bytes of registers), so a thread wants about
// four FMAs per float it loads.  At levels 3-4 (N = 16,384 and 4,096,
// M <= 48) the work is 1-3 us and the fixed cost of a call is the kernel:
// one launch, no host-side allocation past the outputs.  Measured on the
// H100 (PERF.md): a launch between two events costs ~5 us before any
// work, and the first tile's copy, the FMA loop and the merge's atomics
// share the rest; 256-row tiles (4.6 FMAs per float), rings of three or
// four stages and two blocks per SM were no faster than this layout.
//
// Design:
// - One block of 8 warps holds up to 128 queries in shared memory, staged
//   once per block (zero past M and past F).  Warp w owns queries w + 8i
//   (i < NQ, a template parameter = ceil(M / 8) capped at 16), so the main
//   path's M (a multiple of 8) computes no padded query; M > 128 (or a
//   wide F whose queries fill the shared memory) takes a second grid
//   dimension of query chunks.
// - Lane l owns rows l + 32j (j < 4) of a 128-row DB tile.  Per float4 of
//   k it loads 4 DB float4s and, per query, one broadcast float4, then does
//   16 FMAs: 2.9 FMAs per loaded float at NQ = 11.
// - The block walks its chunk of tiles through a two-stage shared-memory
//   ring fed by 16-byte cp.async copies (zero-filled past F and past N, so
//   no lane past F changes a score); the next tile's copy (and its norms)
//   is in flight while this one is computed.  Tiles and queries are stored
//   k-chunk-major ([float4 column][row]) with one float4 of padding per
//   column: the rows a warp reads at one column are consecutive 16-byte
//   words (no bank conflicts), the copies' writes along a row step one
//   bank group, and every shared address in the FMA loop is a base plus an
//   immediate.  F > 72 is streamed as k slabs of <= 18 float4 columns, one
//   per stage, with the accumulators carried across slabs (same k order).
// - Epilogue per tile: a running lexicographic champion per (lane, query)
//   in registers; after the last tile a warp shuffle reduces the 32 lanes.
// - One launch: each warp posts its champion per query as one 64-bit key
//   (order-preserving float bits, -0 folded to +0 with a flag bit, then
//   the index) with atomicMin into a workspace that holds all-ones between
//   calls, one 128-byte line per query (keys packed into a few lines
//   serialise every block's atomics in one L2 slice); the last block to draw a ticket (after __threadfence) swaps the
//   keys back to all-ones, writes (idx, val) and resets the ticket.  The
//   minimum of keys is the lexicographic minimum, whatever the order of
//   the atomics, so results are deterministic; no float atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BN = 128;               // DB rows per tile (a power of two)
constexpr int ROWS = BN / 32;         // rows per lane
constexpr int SROW = BN + 1;          // float4s per stage column (+1 pad)
constexpr int MAX_NQ = 16;            // queries per warp: 128 per block
constexpr int MAX_SLAB4 = 18;         // float4 columns per stage: 72 floats
constexpr int SMEM_LIMIT = 232448 - 1024;  // dynamic bytes, static reserve
constexpr int MAX_DEVICES = 16;
constexpr unsigned long long KEY_EMPTY = ~0ull;
// uint64s between two queries' keys: one 128-byte line each, so the
// blocks' atomics on different queries go to different L2 slices
constexpr int KEY_STRIDE = 16;

__device__ __forceinline__ bool lex_lt(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// 64-bit key whose unsigned order is the lexicographic (value, index)
// order of lex_lt on non-NaN values (-0 == +0, the index decides); the
// lowest bit remembers a -0 so the value comes back bit for bit
__device__ __forceinline__ unsigned long long encode(float v, int id) {
  unsigned bits = __float_as_uint(v), negz = 0u;
  if ((bits & 0x7fffffffu) == 0u) {
    negz = bits >> 31;
    bits = 0u;
  }
  const unsigned vkey = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((unsigned long long)vkey << 32) |
         ((unsigned long long)((unsigned)id << 1) | negz);
}

__device__ __forceinline__ void decode(unsigned long long key, float* v,
                                       int* id) {
  const unsigned vkey = (unsigned)(key >> 32), lo = (unsigned)key;
  unsigned bits = (vkey & 0x80000000u) ? (vkey & 0x7fffffffu) : ~vkey;
  if (lo & 1u) bits = 0x80000000u;
  *v = __uint_as_float(bits);
  *id = (int)(lo >> 1);
}

// 16-byte global->shared copy; bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// 4-byte global->shared copy, zero-filled when `src_bytes` is 0
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// float4 columns of F and the k slabs (of slab4 columns) a stage holds
struct Layout {
  int kc, n_slabs, slab4;
};

__host__ __device__ inline Layout layout(int f) {
  Layout l;
  l.kc = (f + 3) / 4;
  l.n_slabs = (l.kc + MAX_SLAB4 - 1) / MAX_SLAB4;
  l.slab4 = (l.kc + l.n_slabs - 1) / l.n_slabs;
  return l;
}

// one stage: slab4 columns of SROW float4s, then the tile's BN norms
__host__ __device__ inline int stage_bytes(const Layout& l) {
  return 16 * l.slab4 * SROW + 4 * BN;
}

inline int smem_bytes(int f, int nq) {
  const Layout l = layout(f);
  return 16 * l.kc * WARPS * nq + 2 * stage_bytes(l);
}

template <int NQ>
__global__ void __launch_bounds__(THREADS, 1)
argmin_l2_kernel(const float* __restrict__ q, int m, int ldq,
                 const float* __restrict__ db, int n, int lddb, int f,
                 const float* __restrict__ dbn, int tiles_per_chunk,
                 unsigned long long* __restrict__ keys,
                 unsigned* __restrict__ ticket, int* __restrict__ out_idx,
                 float* __restrict__ out_val) {
  extern __shared__ __align__(16) float4 smem[];
  __shared__ bool last_block;
  constexpr int QROWS = WARPS * NQ;
  const Layout lay = layout(f);
  const int stage4 = stage_bytes(lay) / 16;
  float4* qs = smem;                          // [kc][QROWS]
  float4* stages = qs + lay.kc * QROWS;       // 2 x ([slab4][SROW] + norms)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * QROWS;
  const int n_tiles = (n + BN - 1) / BN;
  const int t0 = blockIdx.x * tiles_per_chunk;
  const int units = (min(n_tiles, t0 + tiles_per_chunk) - t0) * lay.n_slabs;

  // unit u = (tile t0 + u / n_slabs, k slab u % n_slabs) into stage u & 1,
  // one copy group; element e = r * cs + c (row r, column c) walks rows in
  // global order and steps (r, c) without a division per element
  auto issue = [&](int u) {
    const int s = u % lay.n_slabs;
    const int n0 = (t0 + u / lay.n_slabs) * BN;
    const int c0 = s * lay.slab4;
    const int cs = min(lay.slab4, lay.kc - c0);
    float4* st = stages + (u & 1) * stage4;
    const int dr = THREADS / cs, dc = THREADS % cs;
    int r = tid / cs, c = tid - r * cs;
    for (; r < BN; r += dr, c += dc) {
      if (c >= cs) {
        c -= cs;
        ++r;
        if (r >= BN) break;
      }
      const int gn = n0 + r, gk = 4 * (c0 + c);
      const int bytes = gn < n ? min(16, 4 * (f - gk)) : 0;
      cp_async16(st + c * SROW + r,
                 bytes > 0 ? db + (size_t)gn * lddb + gk : db, bytes);
    }
    if (s == lay.n_slabs - 1 && tid < BN / 4) {  // the tile's norms
      const int gn = n0 + 4 * tid;
      const int bytes = max(0, min(16, 4 * (n - gn)));
      cp_async16(st + lay.slab4 * SROW + tid, bytes > 0 ? dbn + gn : dbn,
                 bytes);
    }
    cp_async_commit();
  };

  // the queries (zero past M and past F) travel in unit 0's copy group
  for (int e = tid; e < QROWS * lay.kc; e += THREADS) {
    const int r = e % QROWS, c = e / QROWS, gm = m0 + r, gk = 4 * c;
    const float* src = q + (size_t)gm * ldq + gk;
    if (gm >= m) {
      cp_async16(qs + e, q, 0);
    } else if (ldq % 4 == 0) {  // rows 16-byte aligned: one copy
      cp_async16(qs + e, src, min(16, 4 * (f - gk)));
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        cp_async4(reinterpret_cast<float*>(qs + e) + x,
                  gk + x < f ? src + x : q, gk + x < f ? 4 : 0);
    }
  }
  if (units > 0) issue(0);

  float acc[NQ][ROWS];
  float best_v[NQ];
  int best_i[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    best_v[i] = INFINITY;
    best_i[i] = INT_MAX;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) acc[i][j] = 0.f;
  }

  for (int u = 0; u < units; ++u) {
    cp_async_wait_all();
    __syncthreads();  // unit u landed; every warp is done with unit u-1
    if (u + 1 < units) issue(u + 1);
    const int s = u % lay.n_slabs;
    const int c0 = s * lay.slab4;
    const int cs = min(lay.slab4, lay.kc - c0);
    const float4* st = stages + (u & 1) * stage4;
    const float4* bp = st + lane;
    const float4* qp = qs + c0 * QROWS + warp;
#pragma unroll 2
    for (int c = 0; c < cs; ++c, bp += SROW, qp += QROWS) {
      float4 b[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) b[j] = bp[32 * j];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float4 a = qp[WARPS * i];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
    if (s == lay.n_slabs - 1) {
      const int n0 = (t0 + u / lay.n_slabs) * BN;
      const float* nrm = reinterpret_cast<const float*>(st + lay.slab4 * SROW);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int r = lane + 32 * j, gn = n0 + r;
        if (gn < n) {
          const float nn = nrm[r];
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            const float sc = nn - 2.f * acc[i][j];
            if (lex_lt(sc, gn, best_v[i], best_i[i])) {
              best_v[i] = sc;
              best_i[i] = gn;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < NQ; ++i) acc[i][j] = 0.f;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    float v = best_v[i];
    int id = best_i[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, id, off);
      if (lex_lt(ov, oi, v, id)) {
        v = ov;
        id = oi;
      }
    }
    const int gm = m0 + warp + WARPS * i;
    if (lane == 0 && gm < m)
      atomicMin(keys + (size_t)gm * KEY_STRIDE, encode(v, id));
  }

  // the last block to finish turns the keys into (idx, val) and leaves the
  // workspace as the next call expects it
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_block = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int gm = tid; gm < m; gm += THREADS) {
    float v;
    int id;
    decode(atomicExch(keys + (size_t)gm * KEY_STRIDE, KEY_EMPTY), &v, &id);
    out_idx[gm] = id;
    out_val[gm] = v;
  }
  if (tid == 0) atomicExch(ticket, 0u);
}

typedef void (*KernelFn)(const float*, int, int, const float*, int, int, int,
                         const float*, int, unsigned long long*, unsigned*,
                         int*, float*);

const KernelFn KERNELS[MAX_NQ] = {
    &argmin_l2_kernel<1>,  &argmin_l2_kernel<2>,  &argmin_l2_kernel<3>,
    &argmin_l2_kernel<4>,  &argmin_l2_kernel<5>,  &argmin_l2_kernel<6>,
    &argmin_l2_kernel<7>,  &argmin_l2_kernel<8>,  &argmin_l2_kernel<9>,
    &argmin_l2_kernel<10>, &argmin_l2_kernel<11>, &argmin_l2_kernel<12>,
    &argmin_l2_kernel<13>, &argmin_l2_kernel<14>, &argmin_l2_kernel<15>,
    &argmin_l2_kernel<16>};

// dynamic shared memory each instance was opened to, per device
int g_smem_set[MAX_DEVICES][MAX_NQ];

int use_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device) return cudaSetDevice(device);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// q (m, ldq) fp32, db (n, lddb) fp32 of which the first f columns are read
// (lddb a multiple of 4; q, db and dbn 16-byte aligned), dbn (n,) fp32.
// Launch plan (ops/match.py _argmin_plan): nq queries per warp (8 nq per
// query chunk), grid (n_chunks, q_chunks), tiles_per_chunk 256-row DB tiles
// per block.  keys (>= 16 m,) uint64 (query m's at 16 m) all-ones and
// ticket (1,) uint32 zero on entry, left so on exit; out_idx/out_val (m,).  Launches on `stream` and
// returns cudaGetLastError().
int ia_argmin_l2(const float* q, int m, int ldq, const float* db, int n,
                 int lddb, int f, const float* dbn, int nq, int q_chunks,
                 int n_chunks, int tiles_per_chunk, void* keys, void* ticket,
                 int* out_idx, float* out_val, int device, void* stream) {
  const int n_tiles = (n + BN - 1) / BN;
  if (m <= 0 || n <= 0 || f <= 0 || f > ldq || f > lddb || lddb % 4 ||
      nq < 1 || nq > MAX_NQ || q_chunks < 1 || q_chunks * WARPS * nq < m ||
      n_chunks < 1 || tiles_per_chunk < 1 ||
      (n_chunks - 1) * tiles_per_chunk >= n_tiles ||
      n_chunks * tiles_per_chunk < n_tiles || device < 0 ||
      device >= MAX_DEVICES)
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(f, nq);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  int e = use_device(device);
  if (e != cudaSuccess) return e;
  KernelFn fn = KERNELS[nq - 1];
  if (g_smem_set[device][nq - 1] < smem) {
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    g_smem_set[device][nq - 1] = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fn<<<dim3(n_chunks, q_chunks), THREADS, smem, s>>>(
      q, m, ldq, db, n, lddb, f, dbn, tiles_per_chunk,
      static_cast<unsigned long long*>(keys), static_cast<unsigned*>(ticket),
      out_idx, out_val);
  return cudaGetLastError();
}

const char* ia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
