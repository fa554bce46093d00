// Hand-written CUDA kernel of the paper's listing-1/4 example (Negate), for
// Hopper (built for sm_90a by repro_torch/kernels/_build.py in the same nvcc
// call as the other kernels).
//
// The entry point takes device pointers and the CUDA stream as plain C
// values (bound with ctypes), launches on that stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride cap: 16 blocks per H100 SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// negate: out[i] = 1 - x[i], computed in f32 and rounded once to x's type
// (bit-exact against 1 - x in f32; in bf16 torch's own elementwise kernels
// also compute in f32 and round once).
// Replaces repro/kernels/negate.py:_negate_kernel (the pallas_call of
// negate).  Bound: bytes (read x once, write out once; one flop per
// element).
// Design: a grid-stride loop over 16-byte vectors (4 f32 or 8 bf16 per
// load and store) when both pointers are 16-byte aligned, then a scalar
// tail for the last n % V elements; otherwise scalar throughout.  `out` may
// be `x` itself (element i is read before it is written, by the same
// thread).  The TPU version's padding of the flat array to a multiple of
// its VMEM block does not carry over: the tail is a bound check.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void negate_kernel(const T* x, T* out, long long n, int vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long i = tid; i < nv; i += stride) {
      uint4 raw = reinterpret_cast<const uint4*>(x)[i];
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int c = 0; c < V; ++c) e[c] = from_f32<T>(1.f - to_f32(e[c]));
      reinterpret_cast<uint4*>(out)[i] = raw;
    }
    done = nv * V;
  }
  for (long long i = done + tid; i < n; i += stride) out[i] = from_f32<T>(1.f - to_f32(x[i]));
}

template <typename T>
int launch_negate(const void* x, void* out, long long n, cudaStream_t st) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  long long blocks = ((vec ? n / V : n) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  negate_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x and out (n elements, contiguous) in f32 (bf16_input = 0) or bf16; out may be x.
int rt_negate(const void* x, void* out, long long n, int bf16_input, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_input) return launch_negate<bf16>(x, out, n, st);
  return launch_negate<float>(x, out, n, st);
}

}  // extern "C"
