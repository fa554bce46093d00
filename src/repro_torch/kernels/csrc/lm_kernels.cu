// Hand-written CUDA kernels of the LM serving path, for Hopper (built for
// sm_90a by repro_torch/kernels/_build.py in the same nvcc call as the MRI
// kernels).
//
// Entry points take device pointers and the CUDA stream as plain C values
// (bound with ctypes), launch on that stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() so the Python wrapper can raise on
// a refused launch.  Inputs are float32 or bfloat16; all arithmetic is
// float32; outputs are rounded to the input's type (round to nearest even,
// as torch's own conversion).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;          // masked score (finite: no inf - inf)
constexpr float kLog2e = 1.4426950408889634f;

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
__device__ __forceinline__ void load16(const T* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) v[i] = to_f32(e[i]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* v) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// 4 consecutive elements of T <-> float4 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  return make_float4(to_f32(e[0]), to_f32(e[1]), to_f32(e[2]), to_f32(e[3]));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  uint2 raw;
  bf16* e = reinterpret_cast<bf16*>(&raw);
  e[0] = from_f32<bf16>(v.x);
  e[1] = from_f32<bf16>(v.y);
  e[2] = from_f32<bf16>(v.z);
  e[3] = from_f32<bf16>(v.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// ---------------------------------------------------------------------------
// rmsnorm: out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w, f32 math,
// output in x's type, weight read in its own type.
// Replaces repro/kernels/rmsnorm.py:_rmsnorm_kernel (the pallas_call of
// rmsnorm).  Bound: bytes (read x and w once, write out once; 4 flops per
// element).  At qwen3-14b the rows are 5120 wide (hidden state, 1 to 4096
// rows) or 128 wide (per-head q/k norm, B*H*S rows).
// Design: one warp per row, 8 rows per block.  Lanes read the row in
// 16-byte vectors (8 bf16 or 4 f32; scalar loads when the width or a
// pointer does not allow it), sum x^2 in f32 and reduce with warp shuffles,
// then read the row again (from L1/L2: 10 KB at d=5120) to scale and store.
// The TPU tiling (row blocks padded to the sublane, the whole feature axis
// in one VMEM tile) does not carry over: a warp walks any width, and the
// ragged last block just has idle warps.
// ---------------------------------------------------------------------------
constexpr int kNormWarps = 8;

template <typename T, typename W>
__global__ void __launch_bounds__(kNormWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
               long long rows, int d, float eps, int vec) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kNormWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp shares the row
  const T* xr = x + row * d;
  T* orow = out + row * d;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  float ss = 0.f;
  if (vec) {
    for (int c = lane * V; c < d; c += 32 * V) {
      float v[V];
      load16(xr + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) ss = fmaf(v[i], v[i], ss);
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float v = to_f32(xr[i]);
      ss = fmaf(v, v, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  if (vec) {
    for (int c = lane * V; c < d; c += 32 * V) {
      float v[V];
      load16(xr + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = (v[i] * inv) * to_f32(w[c + i]);
      store16(orow + c, v);
    }
  } else {
    for (int i = lane; i < d; i += 32) orow[i] = from_f32<T>((to_f32(xr[i]) * inv) * to_f32(w[i]));
  }
}

template <typename T, typename W>
int launch_rmsnorm(const void* x, const void* w, void* out, long long rows, int d, float eps,
                   cudaStream_t st) {
  const long long blocks = (rows + kNormWarps - 1) / kNormWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (d % (16 / static_cast<int>(sizeof(T))) == 0) && aligned16(x) && aligned16(out);
  rmsnorm_kernel<T, W><<<static_cast<unsigned>(blocks), kNormWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), rows, d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// flash_attention: o = softmax(q k^T * scale + mask) v per (batch, query
// head), GQA (query head h reads kv head h / (Hq / Hkv)), causal and
// sliding-window masks, query i at position i + Skv - Sq (aligned to the
// end of the keys, so one kernel covers prefill and single-token decode),
// rows that see no key -> 0.
// Replaces repro/kernels/flash_attention.py:_flash_kernel (the pallas_call
// of flash_attention).  Bound: operations at prefill sizes
// (4 * D flops per unmasked query-key pair against 2 * D bytes per key
// row); this first version runs on the f32 FMA units, not the tensor cores.
// Design: one block of 256 threads per (64-query tile, query head, batch).
// Four neighbouring threads share a query row: each holds a quarter of q
// (pre-scaled by scale * log2 e, so the softmax uses exp2) and of the f32
// accumulator in registers, as float4 chunks interleaved so the four
// threads read 64 contiguous bytes of a shared-memory key row (no bank
// conflicts; the other rows of the warp read the same address, a
// broadcast).  Keys stream through shared memory in tiles of 32 (K and V
// converted to f32 on load, 32 KB at D = 128).  Per tile: the 32 partial
// dot products are summed over the four threads with two xor shuffles,
// masked, and folded into the running max and sum (online softmax, one
// rescale of the accumulator per tile).  Key tiles that causality or the
// window mask out for every query of the block are never loaded, as the
// Pallas kernel's pl.when guard skips them; the ragged ends (Sq, Skv not
// multiples of the tiles) are masked here, so the wrapper pads nothing.
// The TPU kernel's sequential kv grid axis with (m, l, acc) carried in
// VMEM scratch becomes the loop over key tiles inside one block.
// ---------------------------------------------------------------------------
constexpr int kFlashRows = 64;   // query rows per block
constexpr int kFlashKeys = 32;   // keys per shared-memory tile (one mask bit each)
constexpr int kRowThreads = 4;   // threads sharing one query row
constexpr int kFlashThreads = kFlashRows * kRowThreads;

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int hq, int hkv, int sq, int skv, int causal, int window,
             float scale_log2) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int C = D / 16;                  // float4 chunks a thread holds
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte load
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
  const T* kb = k + (static_cast<long long>(b) * hkv + hk) * skv * D;
  const T* vb = v + (static_cast<long long>(b) * hkv + hk) * skv * D;

  // chunk c of this thread = dims 16c + 4g .. 16c + 4g + 3
  float4 qv[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 t = row_ok ? load4(q + q_row + 16 * c + 4 * g) : make_float4(0.f, 0.f, 0.f, 0.f);
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
    for (int idx = tid; idx < kFlashKeys * (D / V); idx += kFlashThreads) {
      const int j = idx / (D / V), e = (idx % (D / V)) * V;  // key row, first element
      float kv[V], vv[V];
      if (k0 + j < skv) {
        load16(kb + static_cast<long long>(k0 + j) * D + e, kv);
        load16(vb + static_cast<long long>(k0 + j) * D + e, vv);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) kv[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < V / 4; ++t) {
        ks[j][e / 4 + t] = make_float4(kv[4 * t], kv[4 * t + 1], kv[4 * t + 2], kv[4 * t + 3]);
        vs[j][e / 4 + t] = make_float4(vv[4 * t], vv[4 * t + 1], vv[4 * t + 2], vv[4 * t + 3]);
      }
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
      store4(o + q_row + 16 * c + 4 * g,
             make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv, acc[c].w * inv));
    }
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
                 int sq, int skv, int causal, int window, float scale, cudaStream_t st) {
  const dim3 grid((sq + kFlashRows - 1) / kFlashRows, hq, b);
  flash_kernel<T, D><<<grid, kFlashThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, sq, skv, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_flash(int d, const void* q, const void* k, const void* v, void* o, int b, int hq,
                   int hkv, int sq, int skv, int causal, int window, float scale,
                   cudaStream_t st) {
  switch (d) {
    case 64: return launch_flash<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, st);
    case 80: return launch_flash<T, 80>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, st);
    case 128: return launch_flash<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// type (f32 or bf16), 16-byte aligned; d in {64, 80, 128}; window <= 0 = none.
int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int b, int hq,
                       int hkv, int sq, int skv, int d, int causal, int window, float scale,
                       int bf16_inputs, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || hq == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_inputs) return dispatch_flash<bf16>(d, q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, st);
  return dispatch_flash<float>(d, q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, st);
}

}  // extern "C"
