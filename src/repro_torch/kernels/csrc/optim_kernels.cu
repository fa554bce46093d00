// Hand-written CUDA kernels of the port's optimizer (AdamW with f32 master
// weights and global-norm clipping, src/repro_torch/optim/adamw.py), for
// Hopper (built for sm_90a by repro_torch/kernels/_build.py in the same nvcc
// call as the other kernels).
//
// They replace no TPU kernel: the JAX package's optimizer
// (src/repro/optim/adamw.py) is plain jnp, which XLA fuses into a pass or
// two over the state.  The port's plain version is a chain of some twenty
// PyTorch elementwise ops and copies a leaf, each reading and writing f32
// temporaries in device memory (about 200 bytes a parameter), and the
// clip's norm a cast, a square and a sum a leaf (about 18 bytes).
//
// Bound: bytes.  The update needs its own streams only: the gradient (in the
// parameter's type, or f32 after the int8 compression), the f32 master, m
// and v read; master, m, v and the
// parameter written (28 bytes a parameter for bf16 parameters, 32 for
// f32), at about 17 flops a parameter.  The norm needs the gradient read
// once (2 or 4 bytes).  Design: one pass each, no temporaries in device
// memory; 16-byte loads and stores, 8 elements a thread per iteration of a
// grid-stride loop; a scalar-load variant where a pointer is not 16-byte
// aligned (a ZeRO-1 piece cut at an odd offset).  The clip needs the
// global norm before any leaf may change, so the passes cannot be fewer
// than two.
//
// The entry points take device pointers and the CUDA stream as plain C
// values (bound with ctypes), launch on that stream, do not synchronise,
// allocate nothing, and return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kSMs = 132;                   // H100 SXM
constexpr int kUpdateBlocks = kSMs * 4;     // grid-stride cap: the blocks resident at once
constexpr int kSumUnroll = 4;               // 16-byte vectors in flight a thread (sum of squares)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// 8 consecutive elements of T as floats, from vector i (of 8) of src: one
// 16-byte load for bf16, two for f32.  Streaming loads and stores: each
// byte of the optimizer's streams is touched once a step.
template <typename T>
struct Vec8;

template <>
struct Vec8<bf16> {
  static __device__ __forceinline__ void load(const bf16* src, long long i, float (&out)[8]) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(src) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* dst, long long i, const float (&in)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(in[2 * k], in[2 * k + 1]);
    __stcs(reinterpret_cast<uint4*>(dst) + i, raw);
  }
};

template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* src, long long i, float (&out)[8]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(src) + 2 * i);
    const float4 b = __ldcs(reinterpret_cast<const float4*>(src) + 2 * i + 1);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* dst, long long i, const float (&in)[8]) {
    __stcs(reinterpret_cast<float4*>(dst) + 2 * i, make_float4(in[0], in[1], in[2], in[3]));
    __stcs(reinterpret_cast<float4*>(dst) + 2 * i + 1, make_float4(in[4], in[5], in[6], in[7]));
  }
};

// ---------------------------------------------------------------------------
// adamw_update_kernel<TP, TG, kVec>: one leaf (or one ZeRO-1 piece) of AdamW
// in place, and its parameter cast to TP; the gradient comes in TG (the
// parameter's type, or f32 after the int8 gradient compression).
// The step's scalars scale, lr, c1 and c2 are 0-d f32 tensors on the device
// (a step captured into a CUDA graph replays with each step's values), read
// once a thread; scale may be null (no clip: scale 1).  b1, 1 - b1, b2,
// 1 - b2, eps and the weight decay come as f32 values, rounded from Python's
// doubles as PyTorch rounds a Python scalar against an f32 tensor.  Each
// element's arithmetic is the plain version's (optim/adamw.py's
// _update_leaf_plain), op for op in the same order, each rounded once
// (the _rn intrinsics: nothing contracted into an FMA), so the kernel
// writes the plain version's bits:
//   g32 = g * scale
//   m'  = b1 m + (1 - b1) g32
//   v'  = b2 v + ((1 - b2) g32) g32
//   master' = master - lr ((m' / c1) / (sqrt(v' / c2) + eps) + wd master)
//   p   = TP(master')  (round to nearest even for bf16)
// kVec: every pointer 16-byte aligned, so 8 elements a thread an iteration
// in 16-byte vectors and the last n % 8 elements by the scalar loop; else
// the scalar loop throughout.
// ---------------------------------------------------------------------------
struct AdamWArgs {
  const float* scale;  // null: no clip, scale 1
  const float* lr;
  const float* c1;
  const float* c2;
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void adamw_element(float g, float& w, float& m, float& v, float s,
                                              float lr, float c1, float c2,
                                              const AdamWArgs& a) {
  const float g32 = __fmul_rn(g, s);
  const float m1 = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g32));
  const float v1 = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g32), g32));
  const float delta = __fdiv_rn(__fdiv_rn(m1, c1),
                                __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, c2)), a.eps));
  w = __fsub_rn(w, __fmul_rn(lr, __fadd_rn(delta, __fmul_rn(a.wd, w))));
  m = m1;
  v = v1;
}

template <typename TP, typename TG, bool kVec>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(TP* __restrict__ p, float* __restrict__ master, const TG* __restrict__ g,
                    float* __restrict__ m, float* __restrict__ v, long long n, AdamWArgs a) {
  const float s = a.scale ? *a.scale : 1.f;
  const float lr = *a.lr, c1 = *a.c1, c2 = *a.c2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long nv = n / 8;
#pragma unroll 1
    for (long long i = tid; i < nv; i += stride) {
      float gg[8], w[8], mm[8], vv[8];
      Vec8<TG>::load(g, i, gg);
      Vec8<float>::load(master, i, w);
      Vec8<float>::load(m, i, mm);
      Vec8<float>::load(v, i, vv);
#pragma unroll
      for (int k = 0; k < 8; ++k) adamw_element(gg[k], w[k], mm[k], vv[k], s, lr, c1, c2, a);
      Vec8<float>::store(master, i, w);
      Vec8<float>::store(m, i, mm);
      Vec8<float>::store(v, i, vv);
      Vec8<TP>::store(p, i, w);
    }
    done = nv * 8;
  }
#pragma unroll 1
  for (long long i = done + tid; i < n; i += stride) {
    float w = master[i], mm = m[i], vv = v[i];
    adamw_element(to_f32(g[i]), w, mm, vv, s, lr, c1, c2, a);
    master[i] = w;
    m[i] = mm;
    v[i] = vv;
    p[i] = from_f32<TP>(w);
  }
}

template <typename TP, typename TG>
int launch_adamw(void* p, void* master, const void* g, void* m, void* v, long long n,
                 const AdamWArgs& a, cudaStream_t st) {
  const bool vec = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(master) |
                     reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(v)) & 15u) == 0;
  const long long items = vec ? (n / 8 > 0 ? n / 8 : n) : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kUpdateBlocks) blocks = kUpdateBlocks;
  TP* pt = static_cast<TP*>(p);
  const TG* gt = static_cast<const TG*>(g);
  float* w = static_cast<float*>(master);
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  if (vec) {
    adamw_update_kernel<TP, TG, true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        pt, w, gt, mm, vv, n, a);
  } else {
    adamw_update_kernel<TP, TG, false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        pt, w, gt, mm, vv, n, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The clip's sum of squares, deterministic: no float atomics, so a replay
// and a lane give the same bits.
// sumsq_partial_kernel<T, kVec>: one leaf's gradient read once in its own
// type; each thread sums its elements' f32 squares (8 at a time, pairwise,
// each group of 8 added to the thread's Kahan-compensated sum), the block
// sums its threads in a fixed tree (warp shuffles, then the warps), and
// block b writes slot b of the leaf's `slots` slots of the partials buffer
// (which the wrapper zeroes: a leaf smaller than `slots` blocks leaves its
// other slots 0).  The grid depends on n alone, so the order of every sum
// does too.
// sumsq_final_kernel: one block; a warp sums a leaf's slots (each lane its
// strided slots in order, then a shuffle tree), and one thread adds the
// leaves' sums in the tree's order, as the plain version's left fold does.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum8_squares(const float (&e)[8]) {
  float q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = __fmul_rn(e[k], e[k]);
  return __fadd_rn(__fadd_rn(__fadd_rn(q[0], q[1]), __fadd_rn(q[2], q[3])),
                   __fadd_rn(__fadd_rn(q[4], q[5]), __fadd_rn(q[6], q[7])));
}

struct Kahan {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float x) {
    const float y = __fsub_rn(x, c);
    const float t = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(t, s), y);
    s = t;
  }
  __device__ __forceinline__ float total() const { return __fsub_rn(s, c); }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
sumsq_partial_kernel(const T* __restrict__ g, long long n, float* __restrict__ partial) {
  __shared__ float warps[kThreads / 32];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  Kahan acc;
  long long done = 0;
  if (kVec) {
    const long long nv = n / 8;
#pragma unroll 1
    for (long long i = tid; i < nv; i += kSumUnroll * stride) {
      float e[kSumUnroll][8];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        if (i + u * stride < nv) Vec8<T>::load(g, i + u * stride, e[u]);
      }
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        if (i + u * stride < nv) acc.add(sum8_squares(e[u]));
      }
    }
    done = nv * 8;
  }
#pragma unroll 1
  for (long long i = done + tid; i < n; i += stride) {
    const float x = to_f32(g[i]);
    acc.add(__fmul_rn(x, x));
  }
  const float w = warp_sum(acc.total());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = w;
  __syncthreads();
  if (warp == 0) {
    const float b = warp_sum(lane < kThreads / 32 ? warps[lane] : 0.f);
    if (lane == 0) partial[blockIdx.x] = b;
  }
}

constexpr int kFinalChunk = 1024;  // leaves summed into shared memory at a time

__global__ void __launch_bounds__(kThreads)
sumsq_final_kernel(const float* __restrict__ partial, int leaves, int slots,
                   float* __restrict__ out) {
  __shared__ float leaf_sum[kFinalChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float total = 0.f;
  for (int base = 0; base < leaves; base += kFinalChunk) {
    const int count = leaves - base < kFinalChunk ? leaves - base : kFinalChunk;
    for (int l = warp; l < count; l += kThreads / 32) {
      const float* row = partial + static_cast<long long>(base + l) * slots;
      float x = 0.f;
      for (int j = lane; j < slots; j += 32) x = __fadd_rn(x, row[j]);
      x = warp_sum(x);
      if (lane == 0) leaf_sum[l] = x;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int l = 0; l < count; ++l) total = (base + l == 0) ? leaf_sum[0]
                                                                : __fadd_rn(total, leaf_sum[l]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = total;
}

template <typename T>
int launch_sumsq(const void* g, long long n, float* partial, int slots, cudaStream_t st) {
  const bool vec = (reinterpret_cast<uintptr_t>(g) & 15u) == 0;
  const long long items = vec && n / 8 > 0 ? (n / 8 + kSumUnroll - 1) / kSumUnroll : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > slots) blocks = slots;
  const T* gt = static_cast<const T*>(g);
  if (vec) {
    sumsq_partial_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        gt, n, partial);
  } else {
    sumsq_partial_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        gt, n, partial);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One leaf's AdamW update in place: p (n elements, bf16 if bf16_param else
// f32) written from the new master; master, m, v f32; g bf16 if bf16_grad
// else f32.  scale may be null (no clip: scale 1); lr, c1, c2 are 0-d f32
// device tensors.
int rt_adamw_update(void* p, void* master, const void* g, void* m, void* v, long long n,
                    int bf16_param, int bf16_grad, const void* scale, const void* lr, const void* c1,
                    const void* c2, float b1, float omb1, float b2, float omb2, float eps,
                    float wd, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdamWArgs a{static_cast<const float*>(scale), static_cast<const float*>(lr),
                    static_cast<const float*>(c1), static_cast<const float*>(c2),
                    b1, omb1, b2, omb2, eps, wd};
  if (bf16_param) {
    if (bf16_grad) return launch_adamw<bf16, bf16>(p, master, g, m, v, n, a, st);
    return launch_adamw<bf16, float>(p, master, g, m, v, n, a, st);
  }
  if (bf16_grad) return launch_adamw<float, bf16>(p, master, g, m, v, n, a, st);
  return launch_adamw<float, float>(p, master, g, m, v, n, a, st);
}

// Partial sums of squares of g (n elements, bf16 if bf16_input else f32)
// into partial[0, slots): at most `slots` blocks, one slot each.
int rt_sumsq_partial(const void* g, long long n, int bf16_input, void* partial, int slots,
                     void* stream) {
  if (n <= 0 || slots < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (bf16_input) return launch_sumsq<bf16>(g, n, part, slots, st);
  return launch_sumsq<float>(g, n, part, slots, st);
}

// out[0] = the sum over `leaves` rows of `slots` partials, each row summed
// first, the rows then added in order.
int rt_sumsq_final(const void* partial, int leaves, int slots, void* out, void* stream) {
  if (leaves < 1 || slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  sumsq_final_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), leaves, slots, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
