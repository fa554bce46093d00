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

constexpr int kThreads = 128;
constexpr int kSMs = 132;  // H100 SXM
constexpr int kMaxBlocks = kSMs * 32;  // grid-stride cap: two waves of 16 blocks an SM

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
// Design: when both pointers are 16-byte aligned, a grid-stride loop over
// batches of u 16-byte vectors (V = 4 f32 or 8 bf16 elements each): a
// thread loads all u vectors of its batch into registers before its first
// store, so u loads are in flight per thread.  u is U = 4 when the batches
// still give every SM a block, else 1 (a small array, such as the
// quickstart's 256 x 256 image, gains more from blocks on more SMs than
// from bytes in flight per thread).  `out` may be `x` itself, which keeps
// the compiler from moving a load above an earlier store; a thread reads
// only the elements it writes, so loading the whole batch first stays
// correct in place.  The batches of one warp are interleaved (vector q of
// lane l at q * L + l, L the warp's batches), so each of the u loads and
// stores of a warp covers consecutive 16-byte vectors.  The last
// n % (V * u) elements are a scalar tail; misaligned pointers take the
// scalar loop throughout (u = 0).  The grid is sized from the batches and
// capped at two waves of 16 blocks an SM.  The TPU version's padding of
// the flat array to a multiple of its VMEM block does not carry over: the
// tail is a bound check.
// ---------------------------------------------------------------------------
constexpr int kNegUnroll = 4;  // U: the most 16-byte vectors in flight per thread

// u: 16-byte vectors a batch (1 or U), or 0 for the scalar loop; nb = n / (V * u)
// whole batches, divided on the host (a 64-bit division is a long call here)
template <typename T>
__global__ void negate_kernel(const T* x, T* out, long long n, long long nb, int u) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int U = kNegUnroll;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (u) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
#pragma unroll 1  // no trip-count division ahead of the first load
    for (long long i = tid; i < nb; i += stride) {
      const long long first = i & ~31LL;  // the warp's first batch
      const long long lanes = nb - first < 32 ? nb - first : 32;
      const long long at = first * u + (i - first);
      uint4 raw[U];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        if (q < u) raw[q] = xv[at + q * lanes];
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        if (q >= u) break;
        T* e = reinterpret_cast<T*>(&raw[q]);
#pragma unroll
        for (int c = 0; c < V; ++c) e[c] = from_f32<T>(1.f - to_f32(e[c]));
        ov[at + q * lanes] = raw[q];
      }
    }
    done = nb * V * u;
  }
#pragma unroll 1
  for (long long i = done + tid; i < n; i += stride) out[i] = from_f32<T>(1.f - to_f32(x[i]));
}

template <typename T>
int launch_negate(const void* x, void* out, long long n, cudaStream_t st) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const int u = !aligned ? 0 : n / (V * kNegUnroll) >= static_cast<long long>(kSMs) * kThreads
                                   ? kNegUnroll : 1;
  const long long nb = u ? n / (V * u) : 0;
  long long blocks = ((u ? nb : n) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  negate_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, nb, u);
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
