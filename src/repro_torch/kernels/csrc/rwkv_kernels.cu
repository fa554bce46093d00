// Hand-written CUDA kernel of the RWKV6 serving path, for Hopper (built for
// sm_90a by repro_torch/kernels/_build.py in the same nvcc call as the other
// kernels).
//
// The entry point takes device pointers and the CUDA stream as plain C
// values (bound with ctypes), launches on that stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// wkv6: the RWKV6 (Finch) time-mix recurrence per (batch, head)
//   o_t[j] = sum_i r_t[i] * s[i][j] + a_t * v_t[j],  a_t = sum_i r_t[i] u[i] k_t[i]
//   s[i][j] <- s[i][j] * exp(-exp(w_t[i])) + k_t[i] * v_t[j]
// (the bonus term r_t diag(u) k_t^T v_t factors into the scalar a_t).
// r, k, v (B, T, H, D) in T (f32 or bf16), w (B, T, H, D) f32, u (H, D)
// f32, state (B, H, D, D) f32; out (B, T, H, D) in T; all arithmetic f32.
// Replaces repro/kernels/wkv6.py:_wkv6_kernel (the pallas_call of wkv6).
// Bound: operations at prefill sizes (5 D^2 + O(D) flops per step and head
// against 14 D bytes), the state's bytes at decode (T = 1).
// Design: one block of D threads per (batch, head); thread j owns column j
// of the state, D floats in registers, read once at the start and written
// once at the end.  A thread reads and writes only its own column, so the
// final state may be written over the initial one in place (decode passes
// the same cache tensor as both).  Steps are staged in shared memory a tile
// at a time (r, k and the decay exp(-exp(w)), computed once per element
// with expf, as one float4 per (step, i); v beside it; a_t reduced over the
// block with warp shuffles while staging), so a barrier is paid per tile,
// not per step; every thread then reads the float4 of row i as a broadcast
// and spends one FMA on the output and a multiply and an FMA on the state
// per (i, j).  The output sum runs over four partial accumulators to break
// the FMA dependency chain.  The TPU kernel's grid over time blocks, with
// the state carried in VMEM scratch and T padded to a multiple of 8, becomes
// the loop over tiles inside one block; a ragged T is just the loop bound.
// With B * H blocks of D threads (40 blocks at the rwkv6-3b prefill) the
// kernel is latency-bound: a chunked form on the tensor cores is a later
// step.
// ---------------------------------------------------------------------------
constexpr int kWkvTileElems = 2048;  // steps per tile * D: 40 KB of shared memory

template <typename T, int D>
__global__ void __launch_bounds__(D)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u, const float* state_in,
            float* state_out, T* __restrict__ out, int t_len, int heads) {
  static_assert(D % 32 == 0 || (D < 32 && (D & (D - 1)) == 0), "D: a power of two or n * 32");
  constexpr int TT = kWkvTileElems / D;
  constexpr int LANES = D < 32 ? D : 32;  // threads of the block in one warp
  constexpr int WARPS = D / LANES;
  constexpr unsigned MASK = D < 32 ? (1u << D) - 1u : 0xffffffffu;
  __shared__ float4 rkd[TT][D];  // (r_i, k_i, decay_i, unused) per staged step
  __shared__ float vs[TT][D];
  __shared__ float ap[TT][WARPS];  // a_t, summed per warp

  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const long long step = static_cast<long long>(heads) * D;  // between t and t + 1
  const long long base = static_cast<long long>(b) * t_len * step + static_cast<long long>(h) * D + j;
  const long long sbase = static_cast<long long>(bh) * D * D + j;
  const float uj = u[h * D + j];

  float s[D];
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = state_in ? state_in[sbase + static_cast<long long>(i) * D] : 0.f;

  for (int t0 = 0; t0 < t_len; t0 += TT) {
    const int nt = min(TT, t_len - t0);
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      const long long off = base + static_cast<long long>(t0 + tt) * step;
      const float rj = to_f32(r[off]), kj = to_f32(k[off]);
      rkd[tt][j] = make_float4(rj, kj, expf(-expf(w[off])), 0.f);
      vs[tt][j] = to_f32(v[off]);
      float a = rj * uj * kj;
#pragma unroll
      for (int m = LANES / 2; m > 0; m >>= 1) a += __shfl_xor_sync(MASK, a, m);
      if (j % LANES == 0) ap[tt][j / LANES] = a;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = vs[tt][j];
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) a += ap[tt][q];
      float o[4] = {a * vj, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float4 e = rkd[tt][i];
        o[i & 3] = fmaf(e.x, s[i], o[i & 3]);
        s[i] = fmaf(s[i], e.z, e.y * vj);
      }
      out[base + static_cast<long long>(t0 + tt) * step] = from_f32<T>((o[0] + o[1]) + (o[2] + o[3]));
    }
    __syncthreads();  // the next tile overwrites the staged steps
  }

#pragma unroll
  for (int i = 0; i < D; ++i) state_out[sbase + static_cast<long long>(i) * D] = s[i];
}

template <typename T, int D>
int launch_wkv6(const void* r, const void* k, const void* v, const void* w, const void* u,
                const void* state_in, void* state_out, void* out, int b, int t, int h,
                cudaStream_t st) {
  wkv6_kernel<T, D><<<b * h, D, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(state_in), static_cast<float*>(state_out),
      static_cast<T*>(out), t, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wkv6(int d, const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* state_in, void* state_out, void* out, int b,
                  int t, int h, cudaStream_t st) {
  switch (d) {
    case 8: return launch_wkv6<T, 8>(r, k, v, w, u, state_in, state_out, out, b, t, h, st);
    case 64: return launch_wkv6<T, 64>(r, k, v, w, u, state_in, state_out, out, b, t, h, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// r, k, v, out (b, t, h, d) in f32 (bf16_inputs = 0) or bf16; w (b, t, h, d),
// u (h, d), state_in (b, h, d, d; NULL = zeros) and state_out f32; all
// contiguous.  state_out may be state_in itself; d in {8, 64} (the configs' head
// sizes: SMOKE and full width).
int rt_wkv6(const void* r, const void* k, const void* v, const void* w, const void* u,
            const void* state_in, void* state_out, void* out, int b, int t, int h, int d,
            int bf16_inputs, void* stream) {
  if (b < 0 || t < 0 || h < 0 || static_cast<long long>(b) * h > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_inputs) return dispatch_wkv6<bf16>(d, r, k, v, w, u, state_in, state_out, out, b, t, h, st);
  return dispatch_wkv6<float>(d, r, k, v, w, u, state_in, state_out, out, b, t, h, st);
}

}  // extern "C"
