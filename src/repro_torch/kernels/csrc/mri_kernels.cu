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
// * One thread computes one output element and loops over the coils
//   c = 0..C-1 in order: no atomics, so every result is the same from run
//   to run.  The TPU tiling (VMEM budgets, lane padding) does not carry
//   over: there is no tile limit on a per-thread coil loop.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride cap: 16 blocks per H100 SM
constexpr int kMaxDynamicSmem = 232448;  // 227 KB opt-in limit of one block
constexpr int kCoilChunk = 8;  // coils kept in registers in the DFT stage 2

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
// complex_elementprod: out[f, j] = a[f, j] * conj?(b[j]), b broadcast over f.
// Replaces repro/kernels/complex_elementprod.py:_cprod_kernel.
// Bound: bytes (read a and b once, write out once; 6 flops per element).
// Design: a grid-stride loop over the M map elements; each thread keeps
// b[j] in a register and walks the F frames, so b is read from device
// memory once instead of once per frame.  `out` may BE `a` (the staged
// chain runs in place on the arena), so the pointers carry no __restrict__;
// a batch of frames is loaded before it is stored, which is safe because
// out[i] aliases a[i] exactly or not at all.
// ---------------------------------------------------------------------------
__global__ void cprod_kernel(const float2* a, const float2* b, float2* out,
                             long long frames, long long m, int conj) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < m; j += stride) {
    float2 bj = b[j];
    if (conj) bj.y = -bj.y;
    long long f = 0;
    for (; f + 4 <= frames; f += 4) {
      const float2 v0 = a[(f + 0) * m + j], v1 = a[(f + 1) * m + j];
      const float2 v2 = a[(f + 2) * m + j], v3 = a[(f + 3) * m + j];
      out[(f + 0) * m + j] = cmul(v0, bj);
      out[(f + 1) * m + j] = cmul(v1, bj);
      out[(f + 2) * m + j] = cmul(v2, bj);
      out[(f + 3) * m + j] = cmul(v3, bj);
    }
    for (; f < frames; ++f) out[f * m + j] = cmul(a[f * m + j], bj);
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
// fused_epilogue: out[f, p] = sum_c x[f, c, p] * conj(s[c, p])
// (kRss: sqrt(sum_c |x * conj(s)|^2), f32).
// Replaces repro/kernels/mri_fused.py:_epilogue_sum_kernel/_epilogue_rss_kernel
// (fused_epilogue).  Bound: bytes (read x and s once, write out once).
// Design: the coil_combine loop with the product fused in, so the
// (F, C, H, W) product never reaches device memory; s (C*H*W*8 bytes) is
// re-read per frame from L2.
// ---------------------------------------------------------------------------
template <bool kRss>
__global__ void fused_epilogue_kernel(const float2* __restrict__ x,
                                      const float2* __restrict__ s, void* out,
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
      const float2 v = cmul_conj(src[c * hw], s[c * hw + p]);
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
// dft_recon: the whole chain for one frame row, IDFT2 -> *conj(S) -> combine.
// Replaces repro/kernels/mri_fused.py:_dft_recon_kernel (_dft_recon).
// Bound: operations, 8*F*C*H*W*(H+W) fp32 flops for the two DFT passes.
// Design: one block per (frame f, output row a).
//   Stage 1: T[c, w] = sum_h M_H[a, h] * K[f, c, h, w] for every coil, into
//            shared memory (C*W*8 bytes; above 48 KB by opt-in).
//   Stage 2: one thread per output column b computes
//            Y[c, b] = sum_w T[c, w] * M_W[w, b] (M_W is symmetric, so the
//            read along b is coalesced), kCoilChunk coils at a time in
//            registers so each M_W element is loaded once per chunk, then
//            accumulates Y * conj(S[c, a, b]) (or its |.|^2) over c in order.
// Precision: plain fp32 FMA, no TF32, which keeps the 1e-4 band against
// the radix FFT.  Every block re-reads its frame of K from L2.
// ---------------------------------------------------------------------------
template <bool kRss>
__global__ void dft_recon_kernel(const float2* __restrict__ k,
                                 const float2* __restrict__ s,
                                 const float2* __restrict__ mh,
                                 const float2* __restrict__ mw, void* out,
                                 int coils, int h, int w) {
  extern __shared__ float2 t[];  // (coils, w)
  const int a = blockIdx.x, f = blockIdx.y;
  const float2* kf = k + static_cast<long long>(f) * coils * h * w;
  const float2* mrow = mh + static_cast<long long>(a) * h;
  for (int idx = threadIdx.x; idx < coils * w; idx += blockDim.x) {
    const int c = idx / w, col = idx - c * w;
    const float2* src = kf + static_cast<long long>(c) * h * w + col;
    float re = 0.f, im = 0.f;
#pragma unroll 8
    for (int r = 0; r < h; ++r) {
      const float2 m = mrow[r], v = src[static_cast<long long>(r) * w];
      re = fmaf(m.x, v.x, re);
      re = fmaf(-m.y, v.y, re);
      im = fmaf(m.x, v.y, im);
      im = fmaf(m.y, v.x, im);
    }
    t[idx] = make_float2(re, im);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < w; b += blockDim.x) {
    float acc_re = 0.f, acc_im = 0.f;
    for (int c0 = 0; c0 < coils; c0 += kCoilChunk) {
      const int nc = min(kCoilChunk, coils - c0);
      float yr[kCoilChunk], yi[kCoilChunk];
#pragma unroll
      for (int q = 0; q < kCoilChunk; ++q) yr[q] = yi[q] = 0.f;
#pragma unroll 4
      for (int col = 0; col < w; ++col) {
        const float2 m = mw[static_cast<long long>(col) * w + b];
#pragma unroll
        for (int q = 0; q < kCoilChunk; ++q) {
          if (q < nc) {
            const float2 v = t[(c0 + q) * w + col];
            yr[q] = fmaf(v.x, m.x, yr[q]);
            yr[q] = fmaf(-v.y, m.y, yr[q]);
            yi[q] = fmaf(v.x, m.y, yi[q]);
            yi[q] = fmaf(v.y, m.x, yi[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kCoilChunk; ++q) {
        if (q < nc) {
          const float2 sv = s[(static_cast<long long>(c0 + q) * h + a) * w + b];
          const float2 p = cmul_conj(make_float2(yr[q], yi[q]), sv);
          if (kRss) {
            acc_re += fmaf(p.x, p.x, p.y * p.y);
          } else {
            acc_re += p.x;
            acc_im += p.y;
          }
        }
      }
    }
    const long long o = (static_cast<long long>(f) * h + a) * w + b;
    if (kRss) static_cast<float*>(out)[o] = sqrtf(acc_re);
    else static_cast<float2*>(out)[o] = make_float2(acc_re, acc_im);
  }
}

}  // namespace

extern "C" {

const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int rt_cprod(const void* a, const void* b, void* out, long long frames,
             long long m, int conj, void* stream) {
  if (frames > 0 && m > 0) {
    cprod_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(a), static_cast<const float2*>(b),
        static_cast<float2*>(out), frames, m, conj);
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
                      long long frames, int coils, long long hw, void* stream) {
  const long long n = frames * hw;
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float2* xp = static_cast<const float2*>(x);
    const float2* sp = static_cast<const float2*>(s);
    if (rss) fused_epilogue_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(xp, sp, out, frames, coils, hw);
    else fused_epilogue_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(xp, sp, out, frames, coils, hw);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_dft_recon(const void* k, const void* s, const void* mh, const void* mw,
                 void* out, int rss, int frames, int coils, int h, int w,
                 void* stream) {
  const long long smem = static_cast<long long>(coils) * w * sizeof(float2);
  if (smem > kMaxDynamicSmem || frames > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || h == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(h, frames);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2 *kp = static_cast<const float2*>(k), *sp = static_cast<const float2*>(s);
  const float2 *mhp = static_cast<const float2*>(mh), *mwp = static_cast<const float2*>(mw);
  if (rss) {
    if (smem > 48 * 1024) cudaFuncSetAttribute(dft_recon_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    dft_recon_kernel<true><<<grid, kThreads, smem, st>>>(kp, sp, mhp, mwp, out, coils, h, w);
  } else {
    if (smem > 48 * 1024) cudaFuncSetAttribute(dft_recon_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    dft_recon_kernel<false><<<grid, kThreads, smem, st>>>(kp, sp, mhp, mwp, out, coils, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
