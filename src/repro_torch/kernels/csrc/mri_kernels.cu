// Hand-written CUDA kernels of the MRI reconstruction path, for Hopper
// (built for sm_90a by repro_torch/kernels/_build.py with one nvcc call).
//
// Every entry point takes device pointers and the CUDA stream as plain C
// values (bound with ctypes), launches on that stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
//
// Common design, for all four kernels:
// * complex64 is read directly as float2 (interleaved re/im).  The TPU
//   kernels split re/im planes only because Pallas has no complex dtype.
// * Each output element is owned by one thread, which loops over the coils
//   c = 0..C-1 in order: no atomics, so every result is the same from run
//   to run.  The TPU tiling (VMEM budgets, lane padding) does not carry
//   over: there is no tile limit on a per-thread coil loop.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride cap: 16 blocks per H100 SM

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, a.y * b.y), fmaf(a.y, b.x, -a.x * b.y));
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// ---------------------------------------------------------------------------
// complex_elementprod: out[f, j] = a[f, j] * conj?(b[f / fpm, j]): b holds
// one map set per fpm frames (fpm = frames: one set broadcast over f, the
// single-slice path; fpm = F: a batch of B slices, each with its own set).
// Replaces repro/kernels/complex_elementprod.py:_cprod_kernel (and a vmap
// over it, which gives each batch item its own b).
// Bound: bytes (read a and b once, write out once; 6 flops per element).
// Design: a grid-stride loop over the M map elements; each thread keeps
// b[s, j] in a register and walks the fpm frames of set s, so b is read
// from device memory once instead of once per frame.  `out` may BE `a`
// (the staged chain runs in place on the arena), so the pointers carry no
// __restrict__; a batch of frames is loaded before it is stored, which is
// safe because out[i] aliases a[i] exactly or not at all.
// ---------------------------------------------------------------------------
__global__ void cprod_kernel(const float2* a, const float2* b, float2* out,
                             long long frames, long long m, long long fpm, int conj) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < m; j += stride) {
    for (long long f0 = 0; f0 < frames; f0 += fpm) {
      float2 bj = b[(f0 / fpm) * m + j];
      if (conj) bj.y = -bj.y;
      const long long f1 = f0 + fpm < frames ? f0 + fpm : frames;
      long long f = f0;
      for (; f + 4 <= f1; f += 4) {
        const float2 v0 = a[(f + 0) * m + j], v1 = a[(f + 1) * m + j];
        const float2 v2 = a[(f + 2) * m + j], v3 = a[(f + 3) * m + j];
        out[(f + 0) * m + j] = cmul(v0, bj);
        out[(f + 1) * m + j] = cmul(v1, bj);
        out[(f + 2) * m + j] = cmul(v2, bj);
        out[(f + 3) * m + j] = cmul(v3, bj);
      }
      for (; f < f1; ++f) out[f * m + j] = cmul(a[f * m + j], bj);
    }
  }
}

// ---------------------------------------------------------------------------
// coil_combine: out[f, p] = sum_c x[f, c, p]  (kRss: sqrt(sum_c |x|^2), f32).
// Replaces repro/kernels/coil_combine.py:_sum_kernel/_rss_kernel (via
// _combine).  Bound: bytes (read x once, write out once).
// Design: one thread per output pixel, coalesced along p; the coil loop
// has no stores, so its loads are issued back to back.
// ---------------------------------------------------------------------------
template <bool kRss>
__global__ void coil_combine_kernel(const float2* __restrict__ x, void* out,
                                    long long frames, int coils, long long hw) {
  const long long n = frames * hw;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const long long f = i / hw, p = i - f * hw;
    const float2* src = x + f * coils * hw + p;
    float re = 0.f, im = 0.f;
#pragma unroll 8
    for (int c = 0; c < coils; ++c) {
      const float2 v = src[c * hw];
      if (kRss) {
        re += fmaf(v.x, v.x, v.y * v.y);
      } else {
        re += v.x;
        im += v.y;
      }
    }
    if (kRss) static_cast<float*>(out)[i] = sqrtf(re);
    else static_cast<float2*>(out)[i] = make_float2(re, im);
  }
}

// ---------------------------------------------------------------------------
// fused_epilogue: out[f, p] = sum_c x[f, c, p] * conj(s[f / fpm, c, p])
// (kRss: sqrt(sum_c |x * conj(s)|^2), f32); s holds one map set per fpm
// frames, as in cprod_kernel.
// Replaces repro/kernels/mri_fused.py:_epilogue_sum_kernel/_epilogue_rss_kernel
// (fused_epilogue).  Bound: bytes (read x and s once, write out once).
// Design: the coil_combine loop with the product fused in, so the
// (F, C, H, W) product never reaches device memory; a map set (C*H*W*8
// bytes) is re-read per frame of its set from L2.
// ---------------------------------------------------------------------------
template <bool kRss>
__global__ void fused_epilogue_kernel(const float2* __restrict__ x,
                                      const float2* __restrict__ s, void* out,
                                      long long frames, int coils, long long hw,
                                      long long fpm) {
  const long long n = frames * hw;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const long long f = i / hw, p = i - f * hw;
    const float2* src = x + f * coils * hw + p;
    const float2* sf = s + (f / fpm) * coils * hw + p;
    float re = 0.f, im = 0.f;
#pragma unroll 8
    for (int c = 0; c < coils; ++c) {
      const float2 v = cmul_conj(src[c * hw], sf[c * hw]);
      if (kRss) {
        re += fmaf(v.x, v.x, v.y * v.y);
      } else {
        re += v.x;
        im += v.y;
      }
    }
    if (kRss) static_cast<float*>(out)[i] = sqrtf(re);
    else static_cast<float2*>(out)[i] = make_float2(re, im);
  }
}

// ---------------------------------------------------------------------------
// dft_recon: the whole chain, IDFT2 -> *conj(S) -> combine, for 16 output
// rows of one frame:  out = sum_c (M_H K_c M_W) * conj(S_c)  (kRss:
// sqrt(sum_c |.|^2), f32); frame f reads map set f / fpm of S, as in
// cprod_kernel.
// Replaces repro/kernels/mri_fused.py:_dft_recon_kernel (_dft_recon).
// Bound: operations, 8*F*C*H*W*(H+W) fp32 flops for the two DFT passes;
// issued here as 3 TF32 tensor-core products each (3xTF32).
// Design: one block of 8 warps per (frame f, row tile a0..a0+15); warp q
// owns the 8-column tiles q, q + 8, ... (kTiles = ceil(W / 64) of them, the
// last one possibly empty).  Per coil, in coil order:
//   stage 1: T = M_H[a-tile, :] K_c, an m16n8k8 product over h; the M_H
//            tile sits in shared memory for the whole block, K_c fragments
//            come straight from global memory (each element read once per
//            block, a warp's 32 loads filling whole 32-byte sectors), one
//            k-step ahead of the products;
//   stage 2: Y = T M_W over w, T from shared memory, M_W fragments from
//            global memory (L2-resident, read once per block and coil,
//            stored in fragment order: one 16-byte load a tile), split as
//            loaded;
//   epilogue: acc += Y conj(S_c), acc in shared memory, each element
//            owned by one thread: the coil sum is in order, with no atomics
//            and no second pass.
// So a frame of K crosses from L2 once per 16 output rows (10 times a call
// at 160 rows), where a block per output row read it 160 times, and every
// thread of the block works in both stages.
// Precision (3xTF32): every operand x is split into hi = tf32(x) and
// lo = tf32(x - hi) (nearest, ties away from zero); a real product takes
// hi*lo + lo*hi + hi*hi (lo*lo, below 2^-22 of the product, is dropped).
// A complex product is four real ones, the -Im*Im term through a negated
// A.  The tensor core truncates as it accumulates, so the twelve products
// of one k-step go into a zeroed partial and only that partial is added
// (rounded) into the running sum: fed the running sum, the mma carried 8x
// the error of fp32 FMAs and missed the 1e-4 band.  Every operand is split
// where it is loaded or stored: the M_H tile once per block, T once per
// coil, K and M_W once per use.  M_W (idft_tables, built once per shape by
// init()) is in B-fragment order (below); it streams from L2 once per block
// and coil, so its bytes count (stored split, 16 bytes an element, it made
// the kernel about 15% slower).
// Operand order: an mma takes each operand in consecutive registers, so
// every operand is stored in the order one 16-byte load puts it there (a
// gather of scattered values cost a MOV per value, as many as the mma's):
// an A-operand tile (the M_H rows, T) holds, per row pair (g, g + 8),
// 8-deep k-group and plane, the 4 values {(g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)} of each lane t side by side; M_W holds, per k-group, t
// and column n, {re (t), re (t + 4), im (t), im (t + 4)}, so b0 and b1 of
// a plane come split into one register pair.
// Ragged edges: the M_H tile is zero beyond H and T beyond W, so the k-rows
// past H or W multiply zeros; loads past the edge are clamped to the last
// row or column (finite values, discarded or multiplied by zero), so the
// inner loops carry no masks.
// Shared memory (recon_smem_bytes): the M_H tile and T as A-operand tiles
// of 8 row pairs, each a run of 8-deep k-groups of 64 floats (4 planes x
// 4 lanes x 4 values) padded by 16 floats, so the 8 lanes of a quarter warp
// (2 row pairs x 4 lanes) hit 32 distinct banks; then acc, 16 rows of W
// float2 (+16 floats).  104,448 bytes at 160 x 160 (two blocks an SM),
// 165,888 at 256 x 256; no coil term.
// ---------------------------------------------------------------------------
constexpr int kReconRows = 16;   // one m16 tile of output rows a block
constexpr int kReconWarps = 8;
constexpr int kReconThreads = kReconWarps * 32;
constexpr int kReconTiles = 4;   // 8-column tiles a warp owns at W = 256
constexpr int kReconMaxDim = kReconTiles * kReconWarps * 8;

// floats per row pair of an A-operand tile of depth n, and per row of acc
__host__ __device__ constexpr int recon_stride(int n) { return ((n + 7) / 8) * 64 + 16; }
__host__ __device__ constexpr int acc_stride(int w) { return ((w + 7) / 8) * 16 + 16; }
constexpr long long recon_smem_bytes(int h, int w) {
  return (8LL * (recon_stride(h) + recon_stride(w)) + 1LL * kReconRows * acc_stride(w)) *
         sizeof(float);
}

// offset of (row r, column k, plane p) in an A-operand tile of row-pair
// stride rs
__device__ __forceinline__ int a_tile_offset(int rs, int r, int k, int p) {
  return (r & 7) * rs + (k >> 3) * 64 + p * 16 + (k & 3) * 4 + ((k >> 2) & 1) * 2 + (r >> 3);
}

// f32 -> TF32 bit pattern, round to nearest, ties away from zero (the
// rounding of cvt.rna.tf32.f32, in two integer operations; finite x)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x -> (hi, lo) TF32 pair
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// A operand of one k-step (a0: row g, col t; a1: row g + 8; a2, a3: col
// t + 4) in its four planes (hi re, hi im, lo re, lo im): one 16-byte load
// a plane from an A-operand tile; and -Im for the -Im*Im term.
struct FragA {
  uint4 hr, hi, lr, li, nhi, nli;
  __device__ __forceinline__ void load(const float* tile, int rs, int g, int t, int k0) {
    const uint4* p = reinterpret_cast<const uint4*>(tile + g * rs + (k0 >> 3) * 64 + t * 4);
    hr = p[0];
    hi = p[4];
    lr = p[8];
    li = p[12];
    nhi = make_uint4(hi.x ^ 0x80000000u, hi.y ^ 0x80000000u, hi.z ^ 0x80000000u,
                     hi.w ^ 0x80000000u);
    nli = make_uint4(li.x ^ 0x80000000u, li.y ^ 0x80000000u, li.z ^ 0x80000000u,
                     li.w ^ 0x80000000u);
  }
};

// d += a * b, one m16n8k8 TF32 product with f32 accumulation; b = (b0, b1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// (yr, yi) += A * B for one 8-column tile and one k-step, 3xTF32, through
// a zeroed partial.  B in fragment order: bh = (hi re b0, hi re b1, hi im
// b0, hi im b1), bl the same of lo (b0: row t, b1: row t + 4).
__device__ __forceinline__ void cmma_3xtf32(float (&yr)[4], float (&yi)[4], const FragA& a,
                                            const uint4& bh, const uint4& bl) {
  float pr[4] = {0.f, 0.f, 0.f, 0.f}, pi[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(pr, a.hr, bl.x, bl.y);   // Re A Re B
  mma_tf32(pr, a.lr, bh.x, bh.y);
  mma_tf32(pr, a.hr, bh.x, bh.y);
  mma_tf32(pr, a.nhi, bl.z, bl.w);  // -Im A Im B
  mma_tf32(pr, a.nli, bh.z, bh.w);
  mma_tf32(pr, a.nhi, bh.z, bh.w);
  mma_tf32(pi, a.hr, bl.z, bl.w);   // Re A Im B
  mma_tf32(pi, a.lr, bh.z, bh.w);
  mma_tf32(pi, a.hr, bh.z, bh.w);
  mma_tf32(pi, a.hi, bl.x, bl.y);   // Im A Re B
  mma_tf32(pi, a.li, bh.x, bh.y);
  mma_tf32(pi, a.hi, bh.x, bh.y);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    yr[e] += pr[e];
    yi[e] += pi[e];
  }
}

// a B operand in fragment order, v = (re b0, re b1, im b0, im b1) (b0 at
// row t, b1 at row t + 4), split: (hi, lo)
__device__ __forceinline__ void split_b(float4 v, uint4& bh, uint4& bl) {
  split_tf32(v.x, bh.x, bl.x);
  split_tf32(v.y, bh.y, bl.y);
  split_tf32(v.z, bh.z, bl.z);
  split_tf32(v.w, bh.w, bl.w);
}

// kTiles: the most 8-column tiles a warp owns at this W (ceil(W / 64)); a
// warp's last tile may be empty (W = 160: warps 0-3 own 3, warps 4-7 own 2),
// the others never are, so only the last one sits behind a (warp-uniform)
// branch and the rest interleave freely.
template <bool kRss, int kTiles>
__global__ void __launch_bounds__(kReconThreads, 2)
dft_recon_kernel(const float2* __restrict__ k, const float2* __restrict__ s,
                 const float2* __restrict__ mh, const float4* __restrict__ mw, void* out,
                 int coils, int h, int w, int fpm) {
  // mw: (ceil(W / 8), 4, W) float4, [k-group][t][column] (re, im of rows
  // 8 k-group + t and + t + 4, interleaved)
  extern __shared__ __align__(16) float recon_smem[];
  const int hs = recon_stride(h), ws = recon_stride(w), as = acc_stride(w);
  float* mh_s = recon_smem;                         // A-operand tile of M_H rows
  float* t_s = mh_s + 8 * hs;                       // A-operand tile of T
  float* acc_s = t_s + 8 * ws;                      // (16, W) float2 coil sums
  const int a0 = blockIdx.x * kReconRows, f = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int hk = (h + 7) & ~7, wk = (w + 7) & ~7;
  const bool last_tile = (warp + (kTiles - 1) * kReconWarps) * 8 < wk;
  // the B column each lane reads in each of its tiles (clamped to W - 1)
  int ncol[kTiles];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) ncol[j] = min((warp + j * kReconWarps) * 8 + g, w - 1);
  for (int i = threadIdx.x; i < kReconRows * hk; i += blockDim.x) {
    const int r = i / hk, col = i - r * hk;
    const float2 v = (a0 + r < h && col < h) ? mh[static_cast<long long>(a0 + r) * h + col]
                                             : make_float2(0.f, 0.f);
    const int o = a_tile_offset(hs, r, col, 0);
    uint32_t hr, lr, hi, li;
    split_tf32(v.x, hr, lr);
    split_tf32(v.y, hi, li);
    mh_s[o] = __uint_as_float(hr);
    mh_s[o + 16] = __uint_as_float(hi);
    mh_s[o + 32] = __uint_as_float(lr);
    mh_s[o + 48] = __uint_as_float(li);
  }
  for (int i = threadIdx.x; i < kReconRows * as; i += blockDim.x) acc_s[i] = 0.f;
  const long long hw = static_cast<long long>(h) * w;
  __syncthreads();
  for (int c = 0; c < coils; ++c) {
    const float2* kc = k + (static_cast<long long>(f) * coils + c) * hw;
    float yr[kTiles][4], yi[kTiles][4];
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yr[j][e] = yi[j][e] = 0.f;
    // stage 1: T = M_H[a-tile, :] K_c, the raw K of k-step k0 + 8 loaded
    // while k0 computes; rows past H clamp (the M_H tile is zero there)
    float2 ka0[kTiles], ka1[kTiles], kb0[kTiles], kb1[kTiles];
    auto load_k = [&](int k0, float2 (&r0)[kTiles], float2 (&r1)[kTiles]) {
      const float2* row0 = kc + static_cast<long long>(min(k0 + t4, h - 1)) * w;
      const float2* row1 = kc + static_cast<long long>(min(k0 + t4 + 4, h - 1)) * w;
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        r0[j] = __ldg(row0 + ncol[j]);
        r1[j] = __ldg(row1 + ncol[j]);
      }
    };
    auto step1 = [&](int k0, const float2 (&r0)[kTiles], const float2 (&r1)[kTiles]) {
      FragA a;
      a.load(mh_s, hs, g, t4, k0);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        if (j < kTiles - 1 || last_tile) {
          uint4 bh, bl;
          split_b(make_float4(r0[j].x, r1[j].x, r0[j].y, r1[j].y), bh, bl);
          cmma_3xtf32(yr[j], yi[j], a, bh, bl);
        }
      }
    };
    load_k(0, ka0, ka1);
    for (int k0 = 0; k0 < hk; k0 += 16) {
      load_k(k0 + 8, kb0, kb1);
      step1(k0, ka0, ka1);
      if (k0 + 8 < hk) {
        load_k(k0 + 16, ka0, ka1);
        step1(k0 + 8, kb0, kb1);
      }
    }
    // T (rows g, g + 8; columns 2t, 2t + 1 of each tile) -> its A-operand
    // tile, zero past W, split once here for the 8 warps that read it
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int col = (warp + j * kReconWarps) * 8 + 2 * t4;
      if (col < wk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = col + (e & 1);
          const int o = a_tile_offset(ws, g + (e >> 1) * 8, cc, 0);
          uint32_t hr, lr, hi, li;
          split_tf32(cc < w ? yr[j][e] : 0.f, hr, lr);
          split_tf32(cc < w ? yi[j][e] : 0.f, hi, li);
          t_s[o] = __uint_as_float(hr);
          t_s[o + 16] = __uint_as_float(hi);
          t_s[o + 32] = __uint_as_float(lr);
          t_s[o + 48] = __uint_as_float(li);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) yr[j][e] = yi[j][e] = 0.f;
    }
    __syncthreads();
    // stage 2: Y = T M_W, M_W of k-step k0 + 8 loaded while k0 computes
    // (past W the table is zero, as is T)
    float4 ma[kTiles], mb[kTiles];
    auto load_m = [&](int k0, float4 (&r)[kTiles]) {
      const float4* row = mw + static_cast<long long>(min(k0, wk - 8) / 2 + t4) * w;
#pragma unroll
      for (int j = 0; j < kTiles; ++j) r[j] = __ldg(row + ncol[j]);
    };
    auto step2 = [&](int k0, const float4 (&r)[kTiles]) {
      FragA a;
      a.load(t_s, ws, g, t4, k0);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        if (j < kTiles - 1 || last_tile) {
          uint4 bh, bl;
          split_b(r[j], bh, bl);
          cmma_3xtf32(yr[j], yi[j], a, bh, bl);
        }
      }
    };
    load_m(0, ma);
    for (int k0 = 0; k0 < wk; k0 += 16) {
      load_m(k0 + 8, mb);
      step2(k0, ma);
      if (k0 + 8 < wk) {
        load_m(k0 + 16, ma);
        step2(k0 + 8, mb);
      }
    }
    // epilogue: acc += Y conj(S_c); a thread's two columns of a row are one
    // 16-byte word of acc
    const float2* sc = s + (static_cast<long long>(f / fpm) * coils + c) * hw;
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int col = (warp + j * kReconWarps) * 8 + 2 * t4;
      if (col < wk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = g + half * 8, row = a0 + r;
          float4* acc = reinterpret_cast<float4*>(acc_s + r * as + 2 * col);
          float4 v = *acc;
          float2 p[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int e = half * 2 + q;
            const float2 sv = (row < h && col + q < w)
                                  ? __ldg(sc + static_cast<long long>(row) * w + col + q)
                                  : make_float2(0.f, 0.f);
            p[q] = cmul_conj(make_float2(yr[j][e], yi[j][e]), sv);
          }
          if (kRss) {
            v.x += fmaf(p[0].x, p[0].x, p[0].y * p[0].y);
            v.z += fmaf(p[1].x, p[1].x, p[1].y * p[1].y);
          } else {
            v.x += p[0].x;
            v.y += p[0].y;
            v.z += p[1].x;
            v.w += p[1].y;
          }
          *acc = v;
        }
      }
    }
    __syncthreads();   // T is rewritten by the next coil's stage 1
  }
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int col = (warp + j * kReconWarps) * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >> 1) * 8, row = a0 + r, cc = col + (e & 1);
      if (row < h && cc < w) {
        const float2 v = *reinterpret_cast<const float2*>(acc_s + r * as + 2 * cc);
        const long long o = (static_cast<long long>(f) * h + row) * w + cc;
        if (kRss) static_cast<float*>(out)[o] = sqrtf(v.x);
        else static_cast<float2*>(out)[o] = v;
      }
    }
  }
}

template <bool kRss, int kTiles>
int launch_dft_recon(const float2* k, const float2* s, const float2* mh, const float4* mw,
                     void* out, int frames, int coils, int h, int w, int fpm,
                     cudaStream_t st) {
  const int smem = static_cast<int>(recon_smem_bytes(h, w));
  cudaFuncSetAttribute(dft_recon_kernel<kRss, kTiles>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((h + kReconRows - 1) / kReconRows, frames);
  dft_recon_kernel<kRss, kTiles><<<grid, kReconThreads, smem, st>>>(k, s, mh, mw, out, coils,
                                                                     h, w, fpm);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRss>
int launch_dft_recon(const float2* k, const float2* s, const float2* mh, const float4* mw,
                     void* out, int frames, int coils, int h, int w, int fpm,
                     cudaStream_t st) {
  switch ((w + kReconWarps * 8 - 1) / (kReconWarps * 8)) {
    case 1: return launch_dft_recon<kRss, 1>(k, s, mh, mw, out, frames, coils, h, w, fpm, st);
    case 2: return launch_dft_recon<kRss, 2>(k, s, mh, mw, out, frames, coils, h, w, fpm, st);
    case 3: return launch_dft_recon<kRss, 3>(k, s, mh, mw, out, frames, coils, h, w, fpm, st);
    default: return launch_dft_recon<kRss, 4>(k, s, mh, mw, out, frames, coils, h, w, fpm, st);
  }
}

}  // namespace

extern "C" {

const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int rt_cprod(const void* a, const void* b, void* out, long long frames,
             long long m, long long fpm, int conj, void* stream) {
  if (fpm < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (frames > 0 && m > 0) {
    cprod_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(a), static_cast<const float2*>(b),
        static_cast<float2*>(out), frames, m, fpm, conj);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_coil_combine(const void* x, void* out, int rss, long long frames,
                    int coils, long long hw, void* stream) {
  const long long n = frames * hw;
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float2* xp = static_cast<const float2*>(x);
    if (rss) coil_combine_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(xp, out, frames, coils, hw);
    else coil_combine_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(xp, out, frames, coils, hw);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_fused_epilogue(const void* x, const void* s, void* out, int rss,
                      long long frames, int coils, long long hw, long long fpm,
                      void* stream) {
  if (fpm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = frames * hw;
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float2* xp = static_cast<const float2*>(x);
    const float2* sp = static_cast<const float2*>(s);
    if (rss) fused_epilogue_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(xp, sp, out, frames, coils, hw, fpm);
    else fused_epilogue_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(xp, sp, out, frames, coils, hw, fpm);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_dft_recon(const void* k, const void* s, const void* mh, const void* mw,
                 void* out, int rss, int frames, int coils, int h, int w, int fpm,
                 void* stream) {
  if (h > kReconMaxDim || w > kReconMaxDim || frames > 65535 || fpm < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (frames == 0 || h == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  const float2 *kp = static_cast<const float2*>(k), *sp = static_cast<const float2*>(s);
  const float2* mhp = static_cast<const float2*>(mh);
  const float4* mwp = static_cast<const float4*>(mw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rss ? launch_dft_recon<true>(kp, sp, mhp, mwp, out, frames, coils, h, w, fpm, st)
             : launch_dft_recon<false>(kp, sp, mhp, mwp, out, frames, coils, h, w, fpm, st);
}

}  // extern "C"
