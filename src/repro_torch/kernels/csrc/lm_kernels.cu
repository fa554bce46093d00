// Hand-written CUDA kernels of the LM serving and training paths, for Hopper
// (built for sm_90a by repro_torch/kernels/_build.py in the same nvcc call as
// the MRI kernels).
//
// Entry points take device pointers and the CUDA stream as plain C values
// (bound with ctypes), launch on that stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() so the Python wrapper can raise on
// a refused launch.  Inputs are float32 or bfloat16; sums and softmax
// statistics are float32; outputs are rounded to the input's type (round
// to nearest even, as torch's own conversion).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;          // masked score (finite: no inf - inf)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// 16 bytes of T <-> float[16 / sizeof(T)]
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* v) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) v[i] = to_f32(e[i]);
}

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* v) {
  unpack16<T>(*reinterpret_cast<const uint4*>(p), v);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* v) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// N consecutive elements of W as float, in 16-byte loads where N * sizeof(W)
// allows (the pointer is then 16-byte aligned), else one by one.
template <typename W, int N>
__device__ __forceinline__ void load_f32(const W* p, float* v) {
  constexpr int E = 16 / static_cast<int>(sizeof(W));
  if constexpr (N % E == 0) {
#pragma unroll
    for (int c = 0; c < N; c += E) load16(p + c, v + c);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f32(p[i]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// ---------------------------------------------------------------------------
// rmsnorm: out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w, f32 math,
// output in x's type, weight read in its own type.
// Replaces repro/kernels/rmsnorm.py:_rmsnorm_kernel (the pallas_call of
// rmsnorm).  Bound: bytes (read x and w once, write out once; 4 flops per
// element).  At qwen3-14b the rows are 5120 wide (hidden state: 4 rows a
// decode step, up to 4096 a prefill) or 128 wide (per-head q/k norm, B*H*S
// rows); at rwkv6-3b 2560 wide.
// What bounds it is bytes in flight: one DRAM round trip is about a
// microsecond, the whole 1024 x 5120 bf16 row set moves in 6.3 us, so every
// SM needs tens of KB of loads outstanding at once, and a row must be read
// from DRAM only once.  Design: each row is loaded into registers in
// 16-byte vectors (8 bf16 or 4 f32), all of a thread's loads issued before
// its first add, summed in f32, and scaled and stored from the registers
// (one pass).  The thread count follows the width:
// * narrow rows (at most 32 vectors, e.g. 128 wide): G = the next power of
//   two >= d / V threads a row, one vector each, 256 / G rows a block,
//   reduced with G-lane shuffles (no idle half warps at d = 128 bf16);
// * wide rows: one block a row, VPT = 4 (8 past 2048 vectors) vectors a
//   thread, warp shuffles then one shared-memory sum over the warps; 160
//   threads at 5120 bf16, so a whole 1024-row prefill is resident at once
//   (12 blocks an SM, 120 KB of loads in flight) and the 4-row decode
//   shape costs one load round trip, one barrier and one store;
// * widths or pointers that do not allow 16-byte vectors (or rows past
//   4096 vectors): one warp a row, scalar loads, the row read twice.
// The TPU tiling (row blocks padded to the sublane, the whole feature axis
// in one VMEM tile) does not carry over: the ragged last block just has
// idle threads.
// ---------------------------------------------------------------------------
constexpr int kNormThreads = 256;      // narrow and scalar kernels
constexpr int kWideMaxThreads = 512;   // wide kernel: threads a row, at most

template <typename T, typename W, int G>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_narrow_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                      long long rows, int d, float eps) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const long long row = static_cast<long long>(blockIdx.x) * (kNormThreads / G) + threadIdx.x / G;
  const int c = (threadIdx.x % G) * V;
  const bool active = row < rows && c < d;
  float v[V], wv[V];
  float ss = 0.f;
  if (active) {
    load16(x + row * d + c, v);
    load_f32<W, V>(w + c, wv);
#pragma unroll
    for (int i = 0; i < V; ++i) ss = fmaf(v[i], v[i], ss);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (!active) return;
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = (v[i] * inv) * wv[i];
  store16(out + row * d + c, v);
}

template <typename T, typename W, int VPT>
__global__ void __launch_bounds__(kWideMaxThreads)
rmsnorm_wide_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                    int d, float eps) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  __shared__ float part[kWideMaxThreads / 32];
  const int nvec = d / V;
  const long long base = static_cast<long long>(blockIdx.x) * d;
  uint4 raw[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {  // every load in flight before the first add
    const int idx = threadIdx.x + j * blockDim.x;
    raw[j] = idx < nvec ? *reinterpret_cast<const uint4*>(x + base + idx * V)
                        : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    float v[V];
    unpack16<T>(raw[j], v);
#pragma unroll
    for (int i = 0; i < V; ++i) ss = fmaf(v[i], v[i], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;  // every thread sums the warps in the same order
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) total += part[i];
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int idx = threadIdx.x + j * blockDim.x;
    if (idx < nvec) {
      float v[V], wv[V];
      unpack16<T>(raw[j], v);
      load_f32<W, V>(w + idx * V, wv);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = (v[i] * inv) * wv[i];
      store16(out + base + idx * V, v);
    }
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_scalar_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                      long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (kNormThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp shares the row
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int i = lane; i < d; i += 32) orow[i] = from_f32<T>((to_f32(xr[i]) * inv) * to_f32(w[i]));
}

int grid_or_error(long long blocks, unsigned* out) {
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  *out = static_cast<unsigned>(blocks);
  return 0;
}

template <typename T, typename W, int G>
int launch_norm_narrow(const void* x, const void* w, void* out, long long rows, int d,
                       float eps, cudaStream_t st) {
  unsigned grid;
  if (int e = grid_or_error((rows + kNormThreads / G - 1) / (kNormThreads / G), &grid)) return e;
  rmsnorm_narrow_kernel<T, W, G><<<grid, kNormThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W, int VPT>
int launch_norm_wide(const void* x, const void* w, void* out, long long rows, int d, float eps,
                     cudaStream_t st) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int threads = ((d / V + VPT - 1) / VPT + 31) / 32 * 32;
  unsigned grid;
  if (int e = grid_or_error(rows, &grid)) return e;
  rmsnorm_wide_kernel<T, W, VPT><<<grid, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch_rmsnorm(const void* x, const void* w, void* out, long long rows, int d, float eps,
                   cudaStream_t st) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int nvec = d / V;
  const bool vec = d % V == 0 && aligned16(x) && aligned16(w) && aligned16(out);
  if (vec && nvec <= 32) {
    if (nvec <= 1) return launch_norm_narrow<T, W, 1>(x, w, out, rows, d, eps, st);
    if (nvec <= 2) return launch_norm_narrow<T, W, 2>(x, w, out, rows, d, eps, st);
    if (nvec <= 4) return launch_norm_narrow<T, W, 4>(x, w, out, rows, d, eps, st);
    if (nvec <= 8) return launch_norm_narrow<T, W, 8>(x, w, out, rows, d, eps, st);
    if (nvec <= 16) return launch_norm_narrow<T, W, 16>(x, w, out, rows, d, eps, st);
    return launch_norm_narrow<T, W, 32>(x, w, out, rows, d, eps, st);
  }
  if (vec && nvec <= 4 * kWideMaxThreads) {
    return launch_norm_wide<T, W, 4>(x, w, out, rows, d, eps, st);
  }
  if (vec && nvec <= 8 * kWideMaxThreads) {
    return launch_norm_wide<T, W, 8>(x, w, out, rows, d, eps, st);
  }
  unsigned grid;
  if (int e = grid_or_error((rows + kNormThreads / 32 - 1) / (kNormThreads / 32), &grid)) return e;
  rmsnorm_scalar_kernel<T, W><<<grid, kNormThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// flash_attention: o = softmax(q k^T * scale + mask) v per (batch, query
// head), GQA (query head h reads kv head h / (Hq / Hkv)), causal and
// sliding-window masks, query i at position i + Skv - Sq (aligned to the
// end of the keys, so one kernel covers prefill and single-token decode),
// rows that see no key -> 0.
// Replaces repro/kernels/flash_attention.py:_flash_kernel (the pallas_call
// of flash_attention).  Bound: operations at prefill sizes (4 * D flops
// per unmasked query-key pair against 2 * D bytes per key row): the bf16
// tensor-core rate.  The TPU kernel's sequential kv grid axis with
// (m, l, acc) carried in VMEM scratch becomes the loop over key tiles
// inside one block; key tiles that causality or the window mask out for
// every query of the block are never loaded, as the Pallas kernel's
// pl.when guard skips them; the ragged ends (Sq, Skv not multiples of the
// tiles) are masked here, so the wrapper pads nothing.
//
// bf16 inputs: flash_mma_kernel, on the tensor cores (FA2's design with
// mma.sync.m16n8k16, bf16 operands, f32 accumulators).  One block of 4
// warps per (64-query tile, query head, batch); each warp owns 16 query
// rows, its Q fragments loaded once into registers with ldmatrix.  K and V
// tiles of 64 keys stay bf16 in shared memory, rows padded by 16 bytes so
// the 8 row addresses of an ldmatrix (ldmatrix.trans for V) fall in 8
// different bank groups.  The copies are cp.async into two buffers: V of
// tile j lands while S = Q K_j^T runs, K of tile j+1 while the softmax and
// P V_j run.  S is scaled by scale * log2 e in f32; the online softmax
// works on the accumulator fragments (each thread holds 2 rows, row max
// and sum over its quad with two shuffles, exp2f, one rescale of O per
// tile); P is rounded to bf16 in registers and is the A operand of the
// P V product directly (the accumulator layout of m16n8 is the operand
// layout of m16k16), so it never goes through shared memory.  The row sum
// l adds the unrounded f32 P.  Masks are evaluated only on tiles that cut
// the causal diagonal, the window edge or the end of the keys.  The grid
// puts the query heads on x and the query tiles on y, last tile first:
// blocks start in x-fastest order, so the tiles that see the most keys
// under causality start first over all heads and the grid's tail is
// short (with the tiles on x, longest first only within each head, the
// heaviest blocks of the last heads started last).  Shared memory: Q, K and
// V tiles, 3 x 64 x (D + 8) x 2 bytes (52 KB at D = 128, dynamic); the
// output goes through the Q tile for 16-byte stores.  What still bounds it
// (PERF.md has its time against the bf16 tensor rate): every warp reads
// the whole K and V tile through ldmatrix, 128 KB of shared-memory reads
// a block per tile, about as many SM clocks as the block's 512 mma, with
// three barriers a tile; wgmma on K/V tiles that a warpgroup reads once
// is the next step.
//
// f32 inputs: flash_fma_kernel, the first version, on the f32 FMA units.
// TF32 tensor cores would keep about three decimal digits, and the f32
// path is what the card-vs-CPU checks use to hold the model to 1e-3 x
// max |logit|, so it stays exact f32.  One block of 256 threads per
// (64-query tile, query head, batch); four neighbouring threads share a
// query row (a quarter of q, pre-scaled by scale * log2 e, and of the
// accumulator each, as float4 chunks interleaved so the four read 64
// contiguous bytes of a shared key row); keys stream through shared memory
// in f32 tiles of 32; partial dot products are summed over the four
// threads with two xor shuffles.
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;   // query rows per block
constexpr int kMmaKeys = 64;               // keys per K/V tile
constexpr int kMmaThreads = 32 * kMmaWarps;
static_assert(kMmaRows == kMmaKeys, "the Q, K and V tiles share one row count");

constexpr int mma_smem_bytes(int d) { return 3 * kMmaKeys * (d + 8) * 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) of a (rows, D) bf16 matrix into a padded shared
// tile, rows >= nrows zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int nrows) {
  constexpr int CH = D / 8;       // 16-byte chunks a row
  constexpr int S = D + 8;
  for (int idx = threadIdx.x; idx < kMmaKeys * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = row0 + r < nrows;
    cp_async16(smem_u32(dst + r * S + c * 8),
               src + static_cast<long long>(ok ? row0 + r : 0) * D + c * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int hq, int hkv, int sq, int skv, int causal, int window, float scale_log2) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int S = D + 8;        // padded row stride, elements
  constexpr int KD = D / 16;      // k steps of Q K^T
  constexpr int ND = D / 8;       // n tiles of O
  constexpr int NK = kMmaKeys / 8;  // n tiles of S
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* s_q = reinterpret_cast<bf16*>(mma_smem);
  bf16* s_k = s_q + kMmaRows * S;
  bf16* s_v = s_k + kMmaKeys * S;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;     // mma fragment row group, column pair
  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q_tile = (gridDim.y - 1 - blockIdx.y) * kMmaRows;  // longest rows first
  const int offset = skv - sq;
  const bf16* qb = q + (static_cast<long long>(b) * hq + h) * sq * D;
  const bf16* kb = k + (static_cast<long long>(b) * hkv + hk) * skv * D;
  const bf16* vb = v + (static_cast<long long>(b) * hkv + hk) * skv * D;
  bf16* ob = o + (static_cast<long long>(b) * hq + h) * sq * D;

  // key tiles some query of this block can see
  const int q_lo = q_tile + offset;
  const int q_hi = min(q_tile + kMmaRows, sq) - 1 + offset;
  const int k_end = causal ? min(skv, q_hi + 1) : skv;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin = (k_begin / kMmaKeys) * kMmaKeys;

  load_tile<D>(s_q, qb, q_tile, sq);
  if (k_begin < k_end) load_tile<D>(s_k, kb, k_begin, skv);
  cp_async_commit();

  const int pos0 = q_tile + warp * 16 + g + offset;  // this thread's rows: pos0, pos0 + 8
  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int k0 = k_begin; k0 < k_end; k0 += kMmaKeys) {
    cp_async_wait<0>();
    __syncthreads();              // K tile (and Q) landed; every warp is done with V
    if (k0 == k_begin) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldsm_x4(smem_u32(s_q + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8),
                qf[kk]);
      }
    }
    load_tile<D>(s_v, vb, k0, skv);
    cp_async_commit();

    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {   // two key n-tiles per ldmatrix.x4
        uint32_t bk[4];
        ldsm_x4(smem_u32(s_k + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 +
                         ((lane >> 3) & 1) * 8),
                bk);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();              // every warp is done with K
    if (k0 + kMmaKeys < k_end) load_tile<D>(s_k, kb, k0 + kMmaKeys, skv);
    cp_async_commit();

    // scale, mask (only tiles that cut the diagonal, the window edge or
    // the end of the keys), online softmax on the fragments
    const bool masked = k0 + kMmaKeys > skv || (causal && k0 + kMmaKeys - 1 > q_lo) ||
                        (window > 0 && k0 <= q_hi - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          const int pos = pos0 + (e >> 1) * 8;
          bool ok = key < skv;
          if (causal) ok = ok && key <= pos;
          if (window > 0) ok = ok && key > pos - window;
          x = ok ? x : -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];   // no key seen yet: p = 0
      const float alpha = exp2f(m[r] - base[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - base[e >> 1]);
        l[e >> 1] += p;
        s[j][e] = p;
      }
    }

    cp_async_wait<1>();
    __syncthreads();              // V tile landed (the next K may still be on its way)
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {   // two dim n-tiles per ldmatrix.x4.trans
        uint32_t bv[4];
        ldsm_x4_trans(smem_u32(s_v + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                               dp * 16 + (lane >> 4) * 8),
                      bv);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // epilogue: 1 / l, bf16, through this warp's rows of the Q tile
  cp_async_wait<0>();
  __syncthreads();
  bf16* so = s_q + warp * 16 * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = l[r] > 0.f ? 1.f / l[r] : 1.f;  // no key seen: acc is 0
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(so + (g + 8 * r) * S + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    const int qi = q_tile + warp * 16 + g + 8 * r;
    if (lse != nullptr && t4 == 0 && qi < sq) {   // natural log; +inf: no key seen
      lse[(static_cast<long long>(b) * hq + h) * sq + qi] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : INFINITY;
    }
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH;
    const int qi = q_tile + warp * 16 + r;
    if (qi < sq) {
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(qi) * D + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * S + c * 8);
    }
  }
}

template <int D>
int launch_flash_mma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                     int hq, int hkv, int sq, int skv, int causal, int window, float scale,
                     cudaStream_t st) {
  constexpr int smem = mma_smem_bytes(D);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(hq, (sq + kMmaRows - 1) / kMmaRows, b);
  flash_mma_kernel<D><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, hq, hkv, sq, skv, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kFlashRows = 64;   // query rows per block
constexpr int kFlashKeys = 32;   // keys per shared-memory tile (one mask bit each)
constexpr int kRowThreads = 4;   // threads sharing one query row
constexpr int kFlashThreads = kFlashRows * kRowThreads;

template <int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int hq, int hkv, int sq, int skv, int causal, int window, float scale_log2) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int C = D / 16;                  // float4 chunks a thread holds
  __shared__ float4 ks[kFlashKeys][D / 4];
  __shared__ float4 vs[kFlashKeys][D / 4];

  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;           // query row within the tile
  const int g = tid % kRowThreads;           // this thread's chunk phase
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q_tile = blockIdx.x * kFlashRows;
  const int qi = q_tile + r;
  const int offset = skv - sq;
  const int qpos = qi + offset;
  const bool row_ok = qi < sq;
  const long long q_row = ((static_cast<long long>(b) * hq + h) * sq + qi) * D;
  const float* kb = k + (static_cast<long long>(b) * hkv + hk) * skv * D;
  const float* vb = v + (static_cast<long long>(b) * hkv + hk) * skv * D;

  // chunk c of this thread = dims 16c + 4g .. 16c + 4g + 3
  float4 qv[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 t = row_ok ? *reinterpret_cast<const float4*>(q + q_row + 16 * c + 4 * g)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    qv[c] = make_float4(t.x * scale_log2, t.y * scale_log2, t.z * scale_log2, t.w * scale_log2);
  }
  float m = kNegInf, l = 0.f;

  // key tiles some query of this block can see
  const int q_lo = q_tile + offset;
  const int q_hi = min(q_tile + kFlashRows, sq) - 1 + offset;
  const int k_end = causal ? min(skv, q_hi + 1) : skv;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin = (k_begin / kFlashKeys) * kFlashKeys;

  for (int k0 = k_begin; k0 < k_end; k0 += kFlashKeys) {
    for (int idx = tid; idx < kFlashKeys * (D / 4); idx += kFlashThreads) {
      const int j = idx / (D / 4), e = idx % (D / 4);  // key row, float4 chunk
      const bool ok = k0 + j < skv;
      const long long at = static_cast<long long>(k0 + j) * D + 4 * e;
      ks[j][e] = ok ? *reinterpret_cast<const float4*>(kb + at) : make_float4(0.f, 0.f, 0.f, 0.f);
      vs[j][e] = ok ? *reinterpret_cast<const float4*>(vb + at) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    float s[kFlashKeys];
    unsigned valid = 0u;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kFlashKeys; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 kk = ks[j][4 * c + g];
        part = fmaf(qv[c].x, kk.x, part);
        part = fmaf(qv[c].y, kk.y, part);
        part = fmaf(qv[c].z, kk.z, part);
        part = fmaf(qv[c].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      bool ok = kp < skv;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      s[j] = ok ? part : kNegInf;
      valid |= (ok ? 1u : 0u) << j;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kFlashKeys; ++j) {
      const float p = ((valid >> j) & 1u) ? exp2f(s[j] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vv = vs[j][4 * c + g];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();
  }

  if (row_ok) {
    const float inv = l > 0.f ? 1.f / l : 1.f;  // no key seen: acc is 0
#pragma unroll
    for (int c = 0; c < C; ++c) {
      *reinterpret_cast<float4*>(o + q_row + 16 * c + 4 * g) =
          make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv, acc[c].w * inv);
    }
    if (lse != nullptr && g == 0) {   // natural log; +inf: no key seen
      lse[(static_cast<long long>(b) * hq + h) * sq + qi] =
          l > 0.f ? (m + log2f(l)) * kLn2 : INFINITY;
    }
  }
}

template <int D>
int launch_flash_fma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                     int hq, int hkv, int sq, int skv, int causal, int window, float scale,
                     cudaStream_t st) {
  const dim3 grid((sq + kFlashRows - 1) / kFlashRows, hq, b);
  flash_fma_kernel<D><<<grid, kFlashThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, hq, hkv, sq, skv, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward kernels of the training path.  The JAX package trains through
// plain jnp (its Pallas kernels have no custom_vjp), so these have no TPU
// kernel to replace: they are the gradients of rmsnorm_*_kernel and
// flash_*_kernel above, held on the card against autograd through the
// plain versions (repro_torch/kernels/ref.py).  Both are deterministic by
// design: no float atomics, every sum in a fixed order, so a training run
// restarted from a checkpoint ends bit for bit where an uninterrupted one
// does.
//
// rmsnorm_bwd: with r = rsqrt(mean(x^2) + eps) and g = dy * w,
//   dx = r g - x r^3 mean(g x),   dw = sum over rows of dy (x r).
// Bound: bytes (read x, dy once, write dx once; dw is d wide).  Design: one
// block of 256 threads walks a contiguous run of rows, each thread owning
// the columns tid + 256 j (J of them, J >= d / 256, a template constant so
// the row stays in registers); the two row sums go through warp shuffles
// and one shared-memory sum over the 8 warps in a fixed order (double
// buffered: one barrier a row).  Each block keeps its dw partial in
// registers and writes it once to a (blocks, d) f32 scratch; a second
// kernel sums the partials column by column in block order.  The block
// count depends on the row count only, so the sums' order does too.
// ---------------------------------------------------------------------------
constexpr int kNormBwdThreads = 256;

template <typename T, typename W, int J>
__global__ void __launch_bounds__(kNormBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ dw_part, long long rows, int d,
                   long long rows_per_block, float eps) {
  __shared__ float red[2][2][kNormBwdThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  float wv[J], acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = tid + j * kNormBwdThreads;
    wv[j] = c < d ? to_f32(w[c]) : 0.f;
    acc[j] = 0.f;
  }
  int parity = 0;
  for (long long row = r0; row < r1; ++row) {
    const long long base = row * d;
    float xv[J], dyv[J];
    float sxx = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = tid + j * kNormBwdThreads;
      xv[j] = c < d ? to_f32(x[base + c]) : 0.f;
      dyv[j] = c < d ? to_f32(dy[base + c]) : 0.f;
      sxx = fmaf(xv[j], xv[j], sxx);
      sgx = fmaf(dyv[j] * wv[j], xv[j], sgx);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sxx += __shfl_xor_sync(0xffffffffu, sxx, off);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
    }
    if (lane == 0) {
      red[parity][0][warp] = sxx;
      red[parity][1][warp] = sgx;
    }
    __syncthreads();
    float txx = 0.f, tgx = 0.f;   // every thread sums the warps in the same order
#pragma unroll
    for (int i = 0; i < kNormBwdThreads / 32; ++i) {
      txx += red[parity][0][i];
      tgx += red[parity][1][i];
    }
    parity ^= 1;
    const float inv = rsqrtf(txx / static_cast<float>(d) + eps);
    const float coef = (tgx / static_cast<float>(d)) * inv * inv * inv;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = tid + j * kNormBwdThreads;
      if (c < d) {
        dx[base + c] = from_f32<T>(inv * (dyv[j] * wv[j]) - xv[j] * coef);
        acc[j] = fmaf(dyv[j], xv[j] * inv, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = tid + j * kNormBwdThreads;
    if (c < d) dw_part[static_cast<long long>(blockIdx.x) * d + c] = acc[j];
  }
}

template <typename W>
__global__ void __launch_bounds__(kNormBwdThreads)
rmsnorm_dw_reduce_kernel(const float* __restrict__ dw_part, W* __restrict__ dw, int parts, int d) {
  const int c = blockIdx.x * kNormBwdThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += dw_part[static_cast<long long>(p) * d + c];
  dw[c] = from_f32<W>(s);
}

template <typename T, typename W, int J>
int launch_rmsnorm_bwd_j(const void* x, const void* w, const void* dy, void* dx, float* part,
                         void* dw, long long rows, int d, int blocks, float eps, cudaStream_t st) {
  const long long per = (rows + blocks - 1) / blocks;
  rmsnorm_bwd_kernel<T, W, J><<<blocks, kNormBwdThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, d, per, eps);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  rmsnorm_dw_reduce_kernel<W><<<(d + kNormBwdThreads - 1) / kNormBwdThreads, kNormBwdThreads, 0,
                                st>>>(part, static_cast<W*>(dw), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kNormBwdMaxJ = 32;   // widths up to 256 * 32 = 8192

template <typename T, typename W>
int launch_rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, float* part,
                       void* dw, long long rows, int d, int blocks, float eps, cudaStream_t st) {
  const int j = (d + kNormBwdThreads - 1) / kNormBwdThreads;
#define NORM_BWD_CASE(J) \
  if (j <= J) return launch_rmsnorm_bwd_j<T, W, J>(x, w, dy, dx, part, dw, rows, d, blocks, eps, st);
  NORM_BWD_CASE(1)
  NORM_BWD_CASE(2)
  NORM_BWD_CASE(4)
  NORM_BWD_CASE(8)
  NORM_BWD_CASE(12)
  NORM_BWD_CASE(16)
  NORM_BWD_CASE(20)
  NORM_BWD_CASE(24)
  NORM_BWD_CASE(32)
#undef NORM_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// flash attention backward.  With s = scale q k, p = exp(s - lse) (lse from
// the forward), dp = dO v, delta = rowsum(dO o) and ds = p (dp - delta):
//   dV = sum p^T dO,  dK = scale sum ds^T q,  dQ = scale sum ds k.
// Two kernels sum the gradients, so that no float atomics are needed: one
// owns a key tile and sums dK and dV over every query that sees it, the
// other owns a query tile and sums dQ over its keys.  Both recompute s and
// dp: 14 D flops a visible pair and query head against the bound's 10 D
// (dS through device memory, 1 GB a danube layer, per-key-tile dQ partials,
// 2.7 GB, or float atomics, which break the exact restart, cost more).
// Masks as in the forward (causal, window, queries aligned to the end of
// the keys); a row that sees no key has lse = +inf, so p = 0, its dq is 0
// and it adds nothing to dk and dv.  Every output element is summed by one
// thread in a fixed order, so the gradients are the same on every run.
// Bound: operations (10 D flops per visible query-key pair and query head,
// the bf16 tensor rate for bf16).
//
// bf16 inputs, on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// accumulators and statistics; the forward's fragment helpers above):
// * flash_bwd_delta_kernel: delta = rowsum(dO o) in f32, once, into a
//   (B, Hq, Sq) f32 scratch (8 lanes a row, 16-byte loads, xor shuffles
//   in a fixed order).
// * flash_bwd_mma_dkdv_kernel, in the transposed form, so that P^T and
//   dS^T never leave registers: one block of 4 warps per (64-key tile, KV
//   head, batch), each warp owning 16 keys with its K and V fragments
//   loaded once with ldmatrix (D = 128 reads them from shared memory each
//   tile instead, to stay under 255 registers).  The block walks its
//   group's query heads and, for each, the 64-query tiles that can see its
//   keys, in a fixed order; the Q and dO tiles (rows padded as in the
//   forward) and the tile's lse and delta come through a cp.async double
//   buffer, one barrier a tile.  S^T = K Q^T and dP^T = V dO^T take Q and
//   dO rows as B operands through ldmatrix (as K in the forward); P^T =
//   exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T - delta) by
//   column; both, rounded to bf16 in registers, are the A operands of
//   dV += P^T dO and dK += dS^T Q directly (the m16n8 accumulator layout
//   is the m16k16 operand layout), B through ldmatrix.trans (as V in the
//   forward).  The epilogue scales dK, rounds dK and dV to bf16 and stores
//   16-byte rows through the warp's rows of the K and V tiles.  Grid: KV
//   heads on x, key tiles on y, low tiles first: under causality they see
//   the most queries, so the heaviest blocks start first.
// * flash_bwd_mma_dq_kernel, the forward's shape with new roles: one block
//   of 4 warps per (64-query tile, query head, batch), its Q and dO
//   fragments in registers, K and V tiles through a cp.async double
//   buffer; S = Q K^T and dP = dO V^T (V rows through ldmatrix, in K's
//   place), P from lse, dS = P (dP - delta) rounded to bf16 as the A
//   operand of dQ += dS K (K through ldmatrix.trans, in V's place); dQ
//   scaled in the epilogue.  Grid as the forward's.
// Masks are evaluated only on tiles that cut the causal diagonal, the
// window edge or the ragged ends.  What still bounds them: every warp
// reads whole tiles through ldmatrix, as the forward does, and mma.sync
// reaches a part of the tensor rate; wgmma on TMA-fed tiles is the next
// step.
//
// f32 inputs, on the f32 FMA units (exact f32, which the f32 checks at
// 1e-3 x max |grad| need): flash_bwd_dkdv_kernel, one block per (32-key
// tile, KV head, batch), K and V of its tile in shared memory, walking its
// group's query heads and the 32-query tiles that see it and recomputing
// delta from dO and O; flash_bwd_dq_kernel, one block per (32-query tile,
// query head, batch).  Each tile step is two small products through shared
// memory: step A, a warp's lanes on the 32 keys and its 4 query rows (q
// and dO rows read as broadcast float4, K and V rows padded to D + 1
// floats so the 32 lanes hit 32 banks) gives s and dp; step B, 8 threads
// per output row, each accumulating D / 8 interleaved columns.
// ---------------------------------------------------------------------------
constexpr int kBwdTile = 32;       // queries and keys per tile
constexpr int kBwdThreads = 256;   // 8 warps

template <int D>
struct BwdSmem {                   // one layout for both kernels (floats)
  static constexpr int KS = D + 1;                 // padded K / V row
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + kBwdTile * KS;
  static constexpr int q_off = ((v_off + kBwdTile * KS) + 3) / 4 * 4;   // float4 aligned
  static constexpr int do_off = q_off + kBwdTile * D;
  static constexpr int p_off = do_off + kBwdTile * D;
  static constexpr int ds_off = p_off + kBwdTile * (kBwdTile + 1);
  static constexpr int lse_off = ds_off + kBwdTile * (kBwdTile + 1);
  static constexpr int delta_off = lse_off + kBwdTile;
  static constexpr int floats = delta_off + kBwdTile;
  static constexpr int bytes = floats * 4;
};

// rows [row0, row0 + 32) of a (rows, D) matrix into shared f32 with row
// stride `stride`, rows >= nrows zero
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, int stride, const float* src, int row0,
                                              int nrows) {
  for (int idx = threadIdx.x; idx < kBwdTile * D; idx += kBwdThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * stride + c] = row0 + r < nrows ? src[static_cast<long long>(row0 + r) * D + c]
                                           : 0.f;
  }
}

// lse (in log2 units) and delta = rowsum(dO o) of query rows [q0, q0 + 32):
// 8 threads a row, summed over the 8 with shuffles in a fixed order
template <int D>
__device__ __forceinline__ void row_stats(float* s_lse, float* s_delta, const float* ob,
                                          const float* dob, const float* lseb, int q0, int sq) {
  const int r = threadIdx.x >> 3, g = threadIdx.x & 7;
  const int qi = q0 + r;
  float part = 0.f;
  if (qi < sq) {
    for (int c = g; c < D; c += 8) {
      const long long at = static_cast<long long>(qi) * D + c;
      part = fmaf(dob[at], ob[at], part);
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  part += __shfl_xor_sync(0xffffffffu, part, 4);
  if (g == 0) {
    s_delta[r] = part;
    s_lse[r] = qi < sq ? lseb[qi] * kLog2e : INFINITY;
  }
}

// step A: p and ds of the tile's (query, key) pairs.  Lane = key, the warp's
// query rows warp + 8 i.  Writes ds (and p, when s_p is not null) as
// [query][key] with row stride 33.
template <int D>
__device__ __forceinline__ void tile_p_ds(const float* smem, float* s_p, float* s_ds, int q0,
                                          int k0, int sq, int skv, int offset, int causal,
                                          int window, float scale_log2) {
  using L = BwdSmem<D>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* kr = smem + L::k_off + lane * L::KS;
  const float* vr = smem + L::v_off + lane * L::KS;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    const float k0v = kr[c], k1v = kr[c + 1], k2v = kr[c + 2], k3v = kr[c + 3];
    const float v0v = vr[c], v1v = vr[c + 1], v2v = vr[c + 2], v3v = vr[c + 3];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp + 8 * i;
      const float4 qv = *reinterpret_cast<const float4*>(smem + L::q_off + r * D + c);
      const float4 dv = *reinterpret_cast<const float4*>(smem + L::do_off + r * D + c);
      s[i] = fmaf(qv.x, k0v, fmaf(qv.y, k1v, fmaf(qv.z, k2v, fmaf(qv.w, k3v, s[i]))));
      dp[i] = fmaf(dv.x, v0v, fmaf(dv.y, v1v, fmaf(dv.z, v2v, fmaf(dv.w, v3v, dp[i]))));
    }
  }
  const int key = k0 + lane;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp + 8 * i;
    const int qi = q0 + r;
    const int pos = qi + offset;
    bool ok = qi < sq && key < skv;
    if (causal) ok = ok && key <= pos;
    if (window > 0) ok = ok && key > pos - window;
    const float p = ok ? exp2f(s[i] * scale_log2 - smem[L::lse_off + r]) : 0.f;
    const float ds = p * (dp[i] - smem[L::delta_off + r]);
    if (s_p != nullptr) s_p[r * (kBwdTile + 1) + lane] = p;
    s_ds[r * (kBwdTile + 1) + lane] = ds;
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ o, const float* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ dk, float* __restrict__ dv,
                      int hq, int hkv, int sq, int skv, int causal, int window, float scale) {
  using L = BwdSmem<D>;
  constexpr int C = D / 8;
  extern __shared__ __align__(16) float bwd_smem[];
  const int k0 = blockIdx.x * kBwdTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int offset = skv - sq;
  const float scale_log2 = scale * kLog2e;
  const long long kv_base = (static_cast<long long>(b) * hkv + hk) * skv * D;
  load_rows_f32<D>(bwd_smem + L::k_off, L::KS, k + kv_base, k0, skv);
  load_rows_f32<D>(bwd_smem + L::v_off, L::KS, v + kv_base, k0, skv);

  // query rows that can see a key of this tile: position >= k0 (causal),
  // position < last key + window
  const int k_last = min(k0 + kBwdTile, skv) - 1;
  int q_begin = causal ? max(0, k0 - offset) : 0;
  q_begin = q_begin / kBwdTile * kBwdTile;
  const int q_end = window > 0 ? min(sq, k_last + window - offset) : sq;

  const int kr = threadIdx.x >> 3, g = threadIdx.x & 7;   // step B: key row, column phase
  float dka[C], dva[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dka[c] = dva[c] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const long long q_base = (static_cast<long long>(b) * hq + h) * sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kBwdTile) {
      __syncthreads();            // the last tile's Q, dO, P and dS are read
      load_rows_f32<D>(bwd_smem + L::q_off, D, q + q_base * D, q0, sq);
      load_rows_f32<D>(bwd_smem + L::do_off, D, dout + q_base * D, q0, sq);
      row_stats<D>(bwd_smem + L::lse_off, bwd_smem + L::delta_off, o + q_base * D,
                      dout + q_base * D, lse + q_base, q0, sq);
      __syncthreads();
      tile_p_ds<D>(bwd_smem, bwd_smem + L::p_off, bwd_smem + L::ds_off, q0, k0, sq, skv,
                   offset, causal, window, scale_log2);
      __syncthreads();
      const float* s_q = bwd_smem + L::q_off;
      const float* s_do = bwd_smem + L::do_off;
      for (int r = 0; r < kBwdTile; ++r) {
        const float p = bwd_smem[L::p_off + r * (kBwdTile + 1) + kr];
        const float ds = bwd_smem[L::ds_off + r * (kBwdTile + 1) + kr];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dva[c] = fmaf(p, s_do[r * D + g + 8 * c], dva[c]);
          dka[c] = fmaf(ds, s_q[r * D + g + 8 * c], dka[c]);
        }
      }
    }
  }
  if (k0 + kr < skv) {
    const long long at = kv_base + static_cast<long long>(k0 + kr) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[at + g + 8 * c] = dka[c] * scale;
      dv[at + g + 8 * c] = dva[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ o, const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dq, int hq, int hkv, int sq,
                    int skv, int causal, int window, float scale) {
  using L = BwdSmem<D>;
  constexpr int C = D / 8;
  extern __shared__ __align__(16) float bwd_smem[];
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdTile;   // rows that see most keys first
  const int hk = h / (hq / hkv);
  const int offset = skv - sq;
  const float scale_log2 = scale * kLog2e;
  const long long q_base = (static_cast<long long>(b) * hq + h) * sq;
  const long long kv_base = (static_cast<long long>(b) * hkv + hk) * skv * D;
  load_rows_f32<D>(bwd_smem + L::q_off, D, q + q_base * D, q0, sq);
  load_rows_f32<D>(bwd_smem + L::do_off, D, dout + q_base * D, q0, sq);
  row_stats<D>(bwd_smem + L::lse_off, bwd_smem + L::delta_off, o + q_base * D,
                  dout + q_base * D, lse + q_base, q0, sq);

  // key tiles some query of this tile can see
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + kBwdTile, sq) - 1 + offset;
  const int k_end = causal ? min(skv, q_hi + 1) : skv;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin = k_begin / kBwdTile * kBwdTile;

  const int qr = threadIdx.x >> 3, g = threadIdx.x & 7;   // step B: query row, column phase
  float dqa[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dqa[c] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kBwdTile) {
    __syncthreads();              // the last tile's K and dS are read
    load_rows_f32<D>(bwd_smem + L::k_off, L::KS, k + kv_base, k0, skv);
    load_rows_f32<D>(bwd_smem + L::v_off, L::KS, v + kv_base, k0, skv);
    __syncthreads();
    tile_p_ds<D>(bwd_smem, nullptr, bwd_smem + L::ds_off, q0, k0, sq, skv, offset, causal,
                 window, scale_log2);
    __syncthreads();
    const float* s_k = bwd_smem + L::k_off;
    for (int j = 0; j < kBwdTile; ++j) {
      const float ds = bwd_smem[L::ds_off + qr * (kBwdTile + 1) + j];
#pragma unroll
      for (int c = 0; c < C; ++c) dqa[c] = fmaf(ds, s_k[j * L::KS + g + 8 * c], dqa[c]);
    }
  }
  if (q0 + qr < sq) {
    const long long at = (q_base + q0 + qr) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) dq[at + g + 8 * c] = dqa[c] * scale;
  }
}

template <int D>
int launch_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, void* dq, void* dk, void* dv, int b,
                     int hq, int hkv, int sq, int skv, int causal, int window, float scale,
                     cudaStream_t st) {
  constexpr int smem = BwdSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_kv((skv + kBwdTile - 1) / kBwdTile, hkv, b);
  flash_bwd_dkdv_kernel<D><<<grid_kv, kBwdThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, static_cast<float*>(dk),
      static_cast<float*>(dv), hq, hkv, sq, skv, causal, window, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_q(hq, (sq + kBwdTile - 1) / kBwdTile, b);
  flash_bwd_dq_kernel<D><<<grid_q, kBwdThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, static_cast<float*>(dq), hq, hkv,
      sq, skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBwdMmaTile = 64;    // keys and queries per tile of the bf16 backward
static_assert(kBwdMmaTile == kMmaKeys && kMmaThreads == 2 * kBwdMmaTile,
              "the bf16 backward stages its tiles with load_tile and one lse or delta "
              "value a thread");
constexpr int kDeltaRowLanes = 8;  // lanes summing one row of the delta kernel
constexpr int kDeltaThreads = 256;

// dK/dV: K and V tiles, two Q and two dO tiles (bf16, padded rows), two
// (lse, delta) pairs of a query tile (f32)
constexpr int dkdv_smem_bytes(int d) {
  return 6 * kBwdMmaTile * (d + 8) * 2 + 2 * 2 * kBwdMmaTile * 4;
}
// dQ: Q and dO tiles, two K and two V tiles
constexpr int dq_smem_bytes(int d) { return 6 * kBwdMmaTile * (d + 8) * 2; }

// 4 bytes global -> shared, zero-filled when !full (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

template <int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  constexpr int CH = D / 8;        // 16-byte chunks a row
  const long long row =
      (static_cast<long long>(blockIdx.x) * kDeltaThreads + threadIdx.x) / kDeltaRowLanes;
  const int g = threadIdx.x % kDeltaRowLanes;
  float part = 0.f;
  if (row < rows) {
    for (int c = g; c < CH; c += kDeltaRowLanes) {
      float a[8], b[8];
      load16<bf16>(o + row * D + c * 8, a);
      load16<bf16>(dout + row * D + c * 8, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) part = fmaf(a[i], b[i], part);
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  part += __shfl_xor_sync(0xffffffffu, part, 4);
  if (g == 0 && row < rows) delta[row] = part;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_mma_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int hq, int hkv, int sq,
                          int skv, int causal, int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int T = kBwdMmaTile;
  constexpr int S = D + 8;          // padded row stride, elements
  constexpr int KD = D / 16;        // k steps of K Q^T and V dO^T
  constexpr int ND = D / 8;         // n tiles of dK and dV
  constexpr int NQ = T / 8;         // n tiles of S^T and dP^T (queries)
  constexpr bool kKvRegs = D <= 80; // K and V fragments held in registers
  constexpr int KR = kKvRegs ? KD : 1;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* s_k = reinterpret_cast<bf16*>(mma_smem);
  bf16* s_v = s_k + T * S;
  bf16* s_qb = s_v + T * S;                                    // [2][T][S]
  bf16* s_dob = s_qb + 2 * T * S;                              // [2][T][S]
  float* s_stat = reinterpret_cast<float*>(s_dob + 2 * T * S); // [2][lse T, delta T]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;     // mma fragment row group, column pair
  const int hk = blockIdx.x, k0 = blockIdx.y * T, b = blockIdx.z;
  const int group = hq / hkv;
  const int offset = skv - sq;
  const float scale_log2 = scale * kLog2e;
  const long long kv_base = (static_cast<long long>(b) * hkv + hk) * skv * D;

  // query rows that can see a key of this tile: position >= k0 (causal),
  // position < last key + window
  const int k_last = min(k0 + T, skv) - 1;
  int q_begin = causal ? max(0, k0 - offset) : 0;
  q_begin = q_begin / T * T;
  const int q_end = window > 0 ? min(sq, k_last + window - offset) : sq;
  const int nq = q_end > q_begin ? (q_end - q_begin + T - 1) / T : 0;
  const int steps = group * nq;   // (query head, query tile) pairs, head-major

  // step i's Q and dO tiles and its lse and delta into buffer `buf`
  auto stage = [&](int i, int buf) {
    const long long row0 = (static_cast<long long>(b) * hq + hk * group + i / nq) * sq;
    const int q0 = q_begin + (i % nq) * T;
    load_tile<D>(s_qb + buf * T * S, q + row0 * D, q0, sq);
    load_tile<D>(s_dob + buf * T * S, dout + row0 * D, q0, sq);
    const int r = threadIdx.x & (T - 1);
    const bool ok = q0 + r < sq;
    cp_async4(smem_u32(s_stat + buf * 2 * T + threadIdx.x),
              (threadIdx.x < T ? lse : delta) + row0 + (ok ? q0 + r : 0), ok);
  };

  load_tile<D>(s_k, k + kv_base, k0, skv);
  load_tile<D>(s_v, v + kv_base, k0, skv);
  cp_async_commit();
  if (steps > 0) stage(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();                // K and V landed

  uint32_t kf[KR][4], vf[KR][4];
  if constexpr (kKvRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int at = (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(smem_u32(s_k + at), kf[kk]);
      ldsm_x4(smem_u32(s_v + at), vf[kk]);
    }
  }
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: key0, key0 + 8

  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    cp_async_wait<0>();
    __syncthreads();              // step i landed; every warp is done with the other buffer
    if (i + 1 < steps) stage(i + 1, buf ^ 1);
    cp_async_commit();
    const bf16* s_q = s_qb + buf * T * S;
    const bf16* s_do = s_dob + buf * T * S;
    const float* s_lse = s_stat + buf * 2 * T;
    const float* s_delta = s_lse + T;
    const int q0 = q_begin + (i % nq) * T;

    // S^T = K Q^T, dP^T = V dO^T (this warp's 16 keys x 64 queries)
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      if constexpr (kKvRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ka[e] = kf[kk][e];
          va[e] = vf[kk][e];
        }
      } else {
        const int at = (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(smem_u32(s_k + at), ka);
        ldsm_x4(smem_u32(s_v + at), va);
      }
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {   // two query n-tiles per ldmatrix.x4
        const int at = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 +
                       ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bo[4];
        ldsm_x4(smem_u32(s_q + at), bq);
        ldsm_x4(smem_u32(s_do + at), bo);
        mma_bf16(st[2 * np], ka, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dpt[2 * np], va, bo[0], bo[1]);
        mma_bf16(dpt[2 * np + 1], va, bo[2], bo[3]);
      }
    }

    // P^T and dS^T by column (query); masks only on tiles that cut the
    // diagonal, the window edge or the ragged ends
    const int q_hi = min(q0 + T, sq) - 1 + offset;
    const bool masked = q0 + T > sq || k0 + T > skv || (causal && k0 + T - 1 > q0 + offset) ||
                        (window > 0 && k0 <= q_hi - window);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j * 8 + 2 * t4 + c;
        const float l2 = s_lse[col] * kLog2e;
        const float dl = s_delta[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          float p = exp2f(fmaf(st[j][e], scale_log2, -l2));
          if (masked) {
            const int key = key0 + 8 * r, pos = q0 + col + offset;
            bool ok = q0 + col < sq && key < skv;
            if (causal) ok = ok && key <= pos;
            if (window > 0) ok = ok && key > pos - window;
            p = ok ? p : 0.f;
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dl);
        }
      }
    }

    // dV += P^T dO, dK += dS^T Q: P^T and dS^T in bf16 as A operands
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {   // two dim n-tiles per ldmatrix.x4.trans
        const int at = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + dp * 16 +
                       (lane >> 4) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(smem_u32(s_do + at), bo);
        ldsm_x4_trans(smem_u32(s_q + at), bq);
        mma_bf16(dva[2 * dp], pa, bo[0], bo[1]);
        mma_bf16(dva[2 * dp + 1], pa, bo[2], bo[3]);
        mma_bf16(dka[2 * dp], da, bq[0], bq[1]);
        mma_bf16(dka[2 * dp + 1], da, bq[2], bq[3]);
      }
    }
  }

  // epilogue: dK x scale, bf16, through this warp's rows of the K and V
  // tiles (no other warp reads them)
  cp_async_wait<0>();
  __syncwarp();
  bf16* sk = s_k + warp * 16 * S;
  bf16* sv = s_v + warp * 16 * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int at = (g + 8 * r) * S + j * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(sk + at) =
          __floats2bfloat162_rn(dka[j][2 * r] * scale, dka[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(sv + at) =
          __floats2bfloat162_rn(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH;
    const int key = k0 + warp * 16 + r;
    if (key < skv) {
      const long long at = kv_base + static_cast<long long>(key) * D + c * 8;
      *reinterpret_cast<uint4*>(dk + at) = *reinterpret_cast<const uint4*>(sk + r * S + c * 8);
      *reinterpret_cast<uint4*>(dv + at) = *reinterpret_cast<const uint4*>(sv + r * S + c * 8);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_mma_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int hq, int hkv, int sq, int skv, int causal,
                        int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int T = kBwdMmaTile;
  constexpr int S = D + 8;          // padded row stride, elements
  constexpr int KD = D / 16;        // k steps of Q K^T and dO V^T
  constexpr int ND = D / 8;         // n tiles of dQ
  constexpr int NK = T / 8;         // n tiles of S and dP (keys)
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* s_q = reinterpret_cast<bf16*>(mma_smem);
  bf16* s_do = s_q + T * S;
  bf16* s_kb = s_do + T * S;        // [2][T][S]
  bf16* s_vb = s_kb + 2 * T * S;    // [2][T][S]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q_tile = (gridDim.y - 1 - blockIdx.y) * T;   // rows that see the most keys first
  const int offset = skv - sq;
  const float scale_log2 = scale * kLog2e;
  const long long row0 = (static_cast<long long>(b) * hq + h) * sq;
  const bf16* kb = k + (static_cast<long long>(b) * hkv + hk) * skv * D;
  const bf16* vb = v + (static_cast<long long>(b) * hkv + hk) * skv * D;

  // key tiles some query of this tile can see
  const int q_lo = q_tile + offset;
  const int q_hi = min(q_tile + T, sq) - 1 + offset;
  const int k_end = causal ? min(skv, q_hi + 1) : skv;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin = k_begin / T * T;

  load_tile<D>(s_q, q + row0 * D, q_tile, sq);
  load_tile<D>(s_do, dout + row0 * D, q_tile, sq);
  cp_async_commit();
  if (k_begin < k_end) {
    load_tile<D>(s_kb, kb, k_begin, skv);
    load_tile<D>(s_vb, vb, k_begin, skv);
  }
  cp_async_commit();

  // this thread's rows (pos0, pos0 + 8): lse in log2 units (+inf past the
  // end: p = 0) and delta
  const int pos0 = q_tile + warp * 16 + g + offset;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q_tile + warp * 16 + g + 8 * r;
    l2[r] = qi < sq ? lse[row0 + qi] * kLog2e : INFINITY;
    dl[r] = qi < sq ? delta[row0 + qi] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();                // Q and dO landed
  uint32_t qf[KD][4], of[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int at = (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(smem_u32(s_q + at), qf[kk]);
    ldsm_x4(smem_u32(s_do + at), of[kk]);
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += T, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();              // this tile landed; every warp is done with the other buffer
    if (k0 + T < k_end) {
      load_tile<D>(s_kb + (buf ^ 1) * T * S, kb, k0 + T, skv);
      load_tile<D>(s_vb + (buf ^ 1) * T * S, vb, k0 + T, skv);
    }
    cp_async_commit();
    const bf16* s_k = s_kb + buf * T * S;
    const bf16* s_v = s_vb + buf * T * S;

    // S = Q K^T, dP = dO V^T (this warp's 16 queries x 64 keys)
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {   // two key n-tiles per ldmatrix.x4
        const int at = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 +
                       ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldsm_x4(smem_u32(s_k + at), bk);
        ldsm_x4(smem_u32(s_v + at), bv);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        mma_bf16(dp[2 * np], of[kk], bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], of[kk], bv[2], bv[3]);
      }
    }

    // P from lse, dS = P (dP - delta) in place of S
    const bool masked = k0 + T > skv || (causal && k0 + T - 1 > q_lo) ||
                        (window > 0 && k0 <= q_hi - window);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(s[j][e], scale_log2, -l2[r]));
        if (masked) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          const int pos = pos0 + 8 * r;
          bool ok = key < skv;
          if (causal) ok = ok && key <= pos;
          if (window > 0) ok = ok && key > pos - window;
          p = ok ? p : 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[r]);
      }
    }

    // dQ += dS K: dS in bf16 as the A operand, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {   // two dim n-tiles per ldmatrix.x4.trans
        uint32_t bk[4];
        ldsm_x4_trans(smem_u32(s_k + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                               dn * 16 + (lane >> 4) * 8),
                      bk);
        mma_bf16(acc[2 * dn], da, bk[0], bk[1]);
        mma_bf16(acc[2 * dn + 1], da, bk[2], bk[3]);
      }
    }
  }

  // epilogue: dQ x scale, bf16, through this warp's rows of the Q tile (no
  // other warp reads them)
  cp_async_wait<0>();
  __syncwarp();
  bf16* so = s_q + warp * 16 * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(so + (g + 8 * r) * S + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
  __syncwarp();
  constexpr int CH = D / 8;
  bf16* dqb = dq + row0 * D;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH;
    const int qi = q_tile + warp * 16 + r;
    if (qi < sq) {
      *reinterpret_cast<uint4*>(dqb + static_cast<long long>(qi) * D + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * S + c * 8);
    }
  }
}

template <int D>
int launch_flash_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq, void* dk,
                         void* dv, int b, int hq, int hkv, int sq, int skv, int causal,
                         int window, float scale, cudaStream_t st) {
  constexpr int smem_kv = dkdv_smem_bytes(D), smem_q = dq_smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_mma_dkdv_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(flash_bwd_mma_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const bf16* dd = static_cast<const bf16*>(dout);
  const long long rows = static_cast<long long>(b) * hq * sq;
  const long long rows_per_block = kDeltaThreads / kDeltaRowLanes;
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block),
                              kDeltaThreads, 0, st>>>(static_cast<const bf16*>(o), dd, delta, rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_kv(hkv, (skv + kBwdMmaTile - 1) / kBwdMmaTile, b);
  flash_bwd_mma_dkdv_kernel<D><<<grid_kv, kMmaThreads, smem_kv, st>>>(
      qq, kk, vv, dd, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv, sq,
      skv, causal, window, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_q(hq, (sq + kBwdMmaTile - 1) / kBwdMmaTile, b);
  flash_bwd_mma_dq_kernel<D><<<grid_q, kMmaThreads, smem_q, st>>>(
      qq, kk, vv, dd, lse, delta, static_cast<bf16*>(dq), hq, hkv, sq, skv, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (rows, d) and out in f32 (x_bf16 = 0) or bf16; w (d,) in f32 or bf16.
int rt_rmsnorm(const void* x, const void* w, void* out, long long rows, int d, int x_bf16,
               int w_bf16, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (w_bf16) return launch_rmsnorm<bf16, bf16>(x, w, out, rows, d, eps, st);
    return launch_rmsnorm<bf16, float>(x, w, out, rows, d, eps, st);
  }
  if (w_bf16) return launch_rmsnorm<float, bf16>(x, w, out, rows, d, eps, st);
  return launch_rmsnorm<float, float>(x, w, out, rows, d, eps, st);
}

// q (b, hq, sq, d), k and v (b, hkv, skv, d), o like q; contiguous, one
// type (f32 or bf16), 16-byte aligned; d in {16, 64, 80, 128}; window <= 0 =
// none.  lse: null, or (b, hq, sq) f32 that takes each row's log-sum-exp of
// the scaled scores (natural log; +inf for a row that sees no key), which
// the backward reads; o is the same with or without it.
int rt_flash_attention(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                       int hq, int hkv, int sq, int skv, int d, int causal, int window,
                       float scale, int bf16_inputs, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || hq == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  if (bf16_inputs && (sq + kMmaRows - 1) / kMmaRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);   // query tiles ride on gridDim.y
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d * 2 + (bf16_inputs ? 1 : 0)) {
    case 16 * 2 + 1: return launch_flash_mma<16>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, skv, causal, window, scale, st);
    case 64 * 2 + 1: return launch_flash_mma<64>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, skv, causal, window, scale, st);
    case 80 * 2 + 1: return launch_flash_mma<80>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, skv, causal, window, scale, st);
    case 128 * 2 + 1: return launch_flash_mma<128>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, skv, causal, window, scale, st);
    case 16 * 2: return launch_flash_fma<16>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, skv, causal, window, scale, st);
    case 64 * 2: return launch_flash_fma<64>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, skv, causal, window, scale, st);
    case 80 * 2: return launch_flash_fma<80>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, skv, causal, window, scale, st);
    case 128 * 2: return launch_flash_fma<128>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, skv, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Gradient of rt_rmsnorm: dy, dx like x; dw like w.  dw_part: (blocks, d)
// f32 scratch, blocks in [1, rows]; d <= 8192.
int rt_rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw_part,
                   void* dw, long long rows, int d, int blocks, int x_bf16, int w_bf16, float eps,
                   void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0 || blocks > rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dw_part);
  if (x_bf16) {
    if (w_bf16) return launch_rmsnorm_bwd<bf16, bf16>(x, w, dy, dx, part, dw, rows, d, blocks, eps, st);
    return launch_rmsnorm_bwd<bf16, float>(x, w, dy, dx, part, dw, rows, d, blocks, eps, st);
  }
  if (w_bf16) return launch_rmsnorm_bwd<float, bf16>(x, w, dy, dx, part, dw, rows, d, blocks, eps, st);
  return launch_rmsnorm_bwd<float, float>(x, w, dy, dx, part, dw, rows, d, blocks, eps, st);
}

// Gradient of rt_flash_attention: o and lse from its forward, dout like q;
// dq like q, dk and dv like k (written whole, nothing accumulated).
// delta: (b, hq, sq) f32 scratch for bf16 inputs (rowsum(dout o)), null
// for f32 (whose kernels compute it themselves).
int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, void* delta, void* dq, void* dk,
                           void* dv, int b, int hq, int hkv, int sq, int skv, int d, int causal,
                           int window, float scale, int bf16_inputs, void* stream) {
  const int tile = bf16_inputs ? kBwdMmaTile : kBwdTile;   // query tiles ride on gridDim.y
  if (hkv <= 0 || hq % hkv != 0 || hq > 65535 || hkv > 65535 || b > 65535 ||
      (sq + tile - 1) / tile > 65535 ||
      (bf16_inputs && ((skv + tile - 1) / tile > 65535 || delta == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || hq == 0 || sq == 0 || skv == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define FLASH_BWD_CASE(D)                                                                      \
  case D * 2 + 1:                                                                              \
    return launch_flash_bwd_mma<D>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, sq, skv,  \
                                   causal, window, scale, st);                                 \
  case D * 2:                                                                                  \
    return launch_flash_bwd<D>(q, k, v, o, dout, l, dq, dk, dv, b, hq, hkv, sq, skv,         \
                               causal, window, scale, st);
  switch (d * 2 + (bf16_inputs ? 1 : 0)) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(80)
    FLASH_BWD_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_CASE
}

}  // extern "C"
