// Hand-written CUDA kernels of the RWKV6 path, for Hopper (built for sm_90a
// by repro_torch/kernels/_build.py in the same nvcc call as the other
// kernels): the recurrence (serving, and the training forward, which also
// checkpoints its state) and its gradient (training).
//
// Each entry point takes device pointers and the CUDA stream as plain C
// values (bound with ctypes), launches on that stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

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
// Design: the recurrence is sequential in t, so the parallelism is in the
// (D x D) state of each (batch, head), spread over threads and SMs:
// * Column slices across blocks: grid (B * H, D / JC); a block owns JC = 32
//   columns of one head's state (80 blocks at the rwkv6-3b prefill, 320 at
//   a 4-slot decode step), as 16 column pairs of 8 lanes: 128 threads.
// * Row groups across lanes: the G = 8 lanes of a column pair sit side by
//   side in one warp, lane g holding rows g, g + G, g + 2G, ... of both
//   columns (2 D / G floats in registers: 16 at D = 64), which it takes
//   from and returns to shared memory, where the block's state slice
//   passes between global memory and registers in whole 16-byte pieces of
//   rows (one 128-byte row slice per 8 lanes; a lane's own elements would
//   spread each warp-wide load over 8 rows).  Per step a lane
//   reads each of its rows' (r, k, decay) once from shared memory for two
//   columns, and spends a multiply and two FMAs per state element, into two
//   partial sums of each o_j.  The lanes' partials meet in a reduce-scatter
//   (one shuffle that hands column 1 to the upper four lanes and column 0 to
//   the lower four, then log2(G / 2) shuffles), off the state's dependency
//   chain; lanes 0 and 4 put o_j for the two columns into a shared tile of
//   the block's outputs, which the block stores, coalesced, once per tile
//   (a partial last tile, such as a decode step's, stores o_j directly and
//   so pays one barrier, not two).
// * Tile staging: each block stages TT steps at a time in shared memory,
//   one float4 (r_i, k_i, decay_i = exp(-exp(w_i)), v_i) per (step, row)
//   for all D rows, and a_t in D / 32 partial sums reduced with shuffles
//   while staging; a barrier is paid twice per tile, not per step.
//   All the tile's global loads are issued before any is used, and a full
//   tile is staged without a branch.  The r, k, w and v of a head are read
//   by its D / JC column blocks, which run together, so the repeat mostly
//   hits L2.  In a step, the G lanes of a column pair read G consecutive
//   float4 (conflict-free) that the warp's other pairs read as a broadcast.
// A thread reads and writes only its own (rows, columns) elements of the
// state, so the final state may be written over the initial one in place
// (decode passes the same cache tensor as both).  The TPU kernel's grid
// over time blocks, with the state carried in VMEM scratch and T padded to
// a multiple of 8, becomes the loop over tiles inside one block; a ragged
// T is just the loop bound.  Still a sequential f32 recurrence: a chunked
// form on the tensor cores is the next step.
// The training forward (CKPT) also writes the state entering every
// kWkvChunk-th step to ckpt (B, H, ceil(T / kWkvChunk), D, D) f32, each
// thread its own elements: what wkv6_bwd_kernel recomputes a chunk's states
// from (the recurrence cannot be run backwards: a decay exp(-exp(w))
// underflows to 0 in f32, so a state is never recovered by division).
// ---------------------------------------------------------------------------
// steps between two of the training forward's state checkpoints
constexpr int kWkvChunk = 16;
template <int D>
struct WkvLayout {
  static constexpr int G = D < 8 ? D : 8;          // lanes of one column pair (row groups)
  static constexpr int RPT = D / G;                // state rows per thread
  static constexpr int CPT = 2;                    // state columns per thread
  static constexpr int JC = D < 32 ? D : 32;       // columns per block
  static constexpr int THREADS = JC / CPT * G;
  static constexpr int TT = D < 32 ? 64 : 2048 / D;  // steps per staged tile
  static constexpr int SPR = THREADS / D;          // steps staged per round of the block
  static constexpr int ROUNDS = TT / SPR;          // staging rounds per tile
  static constexpr int LANES = D < 32 ? D : 32;    // lanes of one a_t partial
  static constexpr int PARTS = D / LANES;          // a_t partials per step
};

// Stages the nt steps of a tile: thread x takes row i = x % D of step
// it * SPR + x / D in round it; off0 is the offset of its first element,
// (t0 + x / D, i).  A whole tile (FULL) issues all its global loads before
// it uses any; a partial one (a ragged end, a decode step) runs only the
// rounds it needs, one after another.
template <bool FULL, typename T, int D>
__device__ __forceinline__ void wkv6_stage(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, long long off0, long long step, float ui, int nt,
    float4 (&rkd)[WkvLayout<D>::TT][D],
    float (&ap)[WkvLayout<D>::TT][WkvLayout<D>::PARTS]) {
  using L = WkvLayout<D>;
  constexpr int SPR = L::SPR, ROUNDS = L::ROUNDS, LANES = L::LANES;
  const int x = threadIdx.x, i = x % D, srow = x / D;
  // round it: the decay, a_t's partial sums (shuffles over LANES rows), the
  // shared stores
  auto put = [&](int it, float ri, float ki, float wi, float vi) {
    const int tt = it * SPR + srow;
    float a = ri * ui * ki;
#pragma unroll
    for (int q = LANES / 2; q > 0; q >>= 1) a += __shfl_xor_sync(0xffffffffu, a, q);
    if (FULL || tt < nt) {
      rkd[tt][i] = make_float4(ri, ki, expf(-expf(wi)), vi);
      if (i % LANES == 0) ap[tt][i / LANES] = a;
    }
  };
  if (FULL) {
    float ra[ROUNDS], ka[ROUNDS], wa[ROUNDS], va[ROUNDS];
#pragma unroll
    for (int it = 0; it < ROUNDS; ++it) {  // every load of the tile in flight at once
      const long long off = off0 + static_cast<long long>(it * SPR) * step;  // off0: step srow
      ra[it] = to_f32(r[off]);
      ka[it] = to_f32(k[off]);
      wa[it] = w[off];
      va[it] = to_f32(v[off]);
    }
#pragma unroll
    for (int it = 0; it < ROUNDS; ++it) put(it, ra[it], ka[it], wa[it], va[it]);
  } else {
    const int rounds = (nt + SPR - 1) / SPR;  // the same for the whole block
#pragma unroll 1
    for (int it = 0; it < rounds; ++it) {
      const long long off = off0 + static_cast<long long>(it * SPR) * step;
      const bool live = it * SPR + srow < nt;
      put(it, live ? to_f32(r[off]) : 0.f, live ? to_f32(k[off]) : 0.f, live ? w[off] : 0.f,
          live ? to_f32(v[off]) : 0.f);
    }
  }
}

template <typename T, int D, bool CKPT>
__global__ void __launch_bounds__(WkvLayout<D>::THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u, const float* state_in,
            float* state_out, T* __restrict__ out, float* __restrict__ ckpt, int t_len,
            int heads) {
  using L = WkvLayout<D>;
  constexpr int G = L::G, RPT = L::RPT, JC = L::JC, NT = L::THREADS, TT = L::TT;
  constexpr int PARTS = L::PARTS;
  static_assert(D >= 8 && (D & (D - 1)) == 0, "D: a power of two, at least 8");
  static_assert(L::CPT == 2 && NT % 32 == 0 && NT % D == 0 && TT % L::SPR == 0 && 32 % G == 0,
                "column pairs, whole warps, whole column groups in a warp, whole rounds");
  __shared__ float4 rkd[TT][D];    // (r_i, k_i, decay_i, v_i) per staged step
  __shared__ float ap[TT][PARTS];  // a_t, in PARTS partial sums
  __shared__ float os[TT][JC];     // the block's outputs of the tile
  __shared__ __align__(16) float sb[D][JC + 4];  // the state slice in and out (rows padded)

  const int x = threadIdx.x;
  const int g = x % G;                     // row group: rows g, g + G, ...
  const int half = g >= G / 2;             // after the reduce-scatter: column c + half
  const int c = x / G * 2;                 // this thread's column pair in the block
  const int j = blockIdx.y * JC + c;       // ... in the head
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const long long step = static_cast<long long>(heads) * D;  // between t and t + 1
  const long long base = static_cast<long long>(b) * t_len * step + static_cast<long long>(h) * D;
  const long long sbase = static_cast<long long>(bh) * D * D + blockIdx.y * JC;  // (bh, 0, j0)
  const float ui = u[h * D + x % D];

  // The block's (D x JC) state slice moves between global and shared memory
  // in whole 16-byte pieces of rows (a warp reads 4 rows of 128 bytes per
  // load), and each thread takes its own elements from shared memory: its
  // own loads would touch 8 rows per warp-wide load.
  constexpr int V4 = JC / 4, SQ = (D * V4 + NT - 1) / NT;  // float4 a row, a thread
  float4 sq[SQ];
#pragma unroll
  for (int q = 0; q < SQ; ++q) {
    const int f = x + q * NT;
    if (f < D * V4) {
      sq[q] = state_in ? *reinterpret_cast<const float4*>(
                             state_in + sbase + static_cast<long long>(f / V4) * D + f % V4 * 4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  auto slice_to_shared = [&]() {
#pragma unroll
    for (int q = 0; q < SQ; ++q) {
      const int f = x + q * NT;
      if (f < D * V4) *reinterpret_cast<float4*>(&sb[f / V4][f % V4 * 4]) = sq[q];
    }
  };
  float2 s[RPT];                   // rows m * G + g, columns j and j + 1
  auto own_from_shared = [&]() {
#pragma unroll
    for (int m = 0; m < RPT; ++m) s[m] = *reinterpret_cast<const float2*>(&sb[m * G + g][c]);
  };
  // the training forward: the state entering step t, at every chunk's first step
  const long long cbase = static_cast<long long>(bh) * ((t_len + kWkvChunk - 1) / kWkvChunk);
  auto checkpoint = [&](int t) {
    if (CKPT && t % kWkvChunk == 0) {
      float* dst = ckpt + (cbase + t / kWkvChunk) * D * D + j;
#pragma unroll
      for (int m = 0; m < RPT; ++m) *reinterpret_cast<float2*>(dst + (m * G + g) * D) = s[m];
    }
  };

  // step tt of the staged tile: returns o of column c + half, whole on
  // lanes g = 0 and G / 2
  auto run_step = [&](int tt) -> float {
    const float2 vj = make_float2(rkd[tt][j].w, rkd[tt][j + 1].w);
    float o0[2] = {0.f, 0.f}, o1[2] = {0.f, 0.f};
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const float4 e = rkd[tt][m * G + g];
      o0[m & 1] = fmaf(e.x, s[m].x, o0[m & 1]);
      o1[m & 1] = fmaf(e.x, s[m].y, o1[m & 1]);
      s[m].x = fmaf(s[m].x, e.z, e.y * vj.x);
      s[m].y = fmaf(s[m].y, e.z, e.y * vj.y);
    }
    const float p0 = o0[0] + o0[1], p1 = o1[0] + o1[1];
    float p = (half ? p1 : p0) + __shfl_xor_sync(0xffffffffu, half ? p0 : p1, G / 2);
#pragma unroll
    for (int q = G / 4; q > 0; q >>= 1) p += __shfl_xor_sync(0xffffffffu, p, q);
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < PARTS; ++q) a += ap[tt][q];
    return fmaf(a, half ? vj.y : vj.x, p);
  };

  for (int t0 = 0; t0 < t_len; t0 += TT) {
    const int nt = min(TT, t_len - t0);
    const long long off0 = base + static_cast<long long>(t0 + x / D) * step + x % D;
    if (nt == TT) {
      wkv6_stage<true, T, D>(r, k, v, w, off0, step, ui, nt, rkd, ap);
      if (t0 == 0) slice_to_shared();
      __syncthreads();
      if (t0 == 0) own_from_shared();
#pragma unroll 2
      for (int tt = 0; tt < TT; ++tt) {
        checkpoint(t0 + tt);
        const float o = run_step(tt);
        if (g % (G / 2) == 0) os[tt][c + half] = o;
      }
      __syncthreads();  // the outputs are in os; the next tile may overwrite the staged steps
      for (int e = x; e < TT * JC; e += NT) {
        out[base + static_cast<long long>(t0 + e / JC) * step + blockIdx.y * JC + e % JC] =
            from_f32<T>(os[e / JC][e % JC]);
      }
    } else {  // the last tile, partial (a ragged end, a decode step): no tile follows,
              // so its outputs go straight out and it needs one barrier, not two
      wkv6_stage<false, T, D>(r, k, v, w, off0, step, ui, nt, rkd, ap);
      if (t0 == 0) slice_to_shared();
      __syncthreads();
      if (t0 == 0) own_from_shared();
      for (int tt = 0; tt < nt; ++tt) {
        checkpoint(t0 + tt);
        const float o = run_step(tt);
        if (g % (G / 2) == 0) {
          out[base + static_cast<long long>(t0 + tt) * step + j + half] = from_f32<T>(o);
        }
      }
    }
  }

  if (t_len > 0) {  // each thread writes only its own elements: no barrier before
#pragma unroll
    for (int m = 0; m < RPT; ++m) *reinterpret_cast<float2*>(&sb[m * G + g][c]) = s[m];
  } else {
    slice_to_shared();
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < SQ; ++q) {
    const int f = x + q * NT;
    if (f < D * V4) {
      float* dst = state_out + sbase + static_cast<long long>(f / V4) * D + f % V4 * 4;
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&sb[f / V4][f % V4 * 4]);
    }
  }
}

template <typename T, int D>
int launch_wkv6(const void* r, const void* k, const void* v, const void* w, const void* u,
                const void* state_in, void* state_out, void* out, void* ckpt, int b, int t,
                int h, cudaStream_t st) {
  using L = WkvLayout<D>;
  const dim3 grid(static_cast<unsigned>(b * h), D / L::JC);
  auto kern = ckpt ? wkv6_kernel<T, D, true> : wkv6_kernel<T, D, false>;
  kern<<<grid, L::THREADS, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(state_in), static_cast<float*>(state_out),
      static_cast<T*>(out), static_cast<float*>(ckpt), t, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wkv6(int d, const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* state_in, void* state_out, void* out, void* ckpt,
                  int b, int t, int h, cudaStream_t st) {
  switch (d) {
    case 8: return launch_wkv6<T, 8>(r, k, v, w, u, state_in, state_out, out, ckpt, b, t, h, st);
    case 64:
      return launch_wkv6<T, 64>(r, k, v, w, u, state_in, state_out, out, ckpt, b, t, h, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// wkv6_bwd: the gradient of the recurrence, what jax.grad through the JAX
// package's plain wkv6 (kernels/ref.py, a lax.scan) computes.  With a_t =
// exp(-exp(w_t)) acting on the rows i (the k index) and G_t = dL/ds_t:
//   G_{t-1} = diag(a_t) G_t + r_t^T do_t          (from G_T = dstate_out)
//   dr_t[i] = sum_j s_{t-1}[i][j] do_t[j] + u_i k_t[i] (v_t . do_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j] + u_i r_t[i] (v_t . do_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) do_t[j]
//   dw_t[i] = -exp(w_t[i]) a_t[i] sum_j s_{t-1}[i][j] G_t[i][j]
//   du_i    = sum_{b, t} r_t[i] k_t[i] (v_t . do_t);   dstate_in = G_0.
// The JAX package trains through the plain scan, so there is no Pallas
// kernel of the gradient to replace; this is the gradient of
// repro/kernels/wkv6.py:_wkv6_kernel's function.
// Bound: the bytes (r, k, v, w, do read; dr, dk, dv, dw written) at the
// training shape; 13 D^2 flops a step and head against them make it
// operations-bound at fp32 (the cost model in kernels/wkv6.py).
// Design: the forward's layout (grid (B * H, D / JC), a block owning JC = 32
// columns, G = 8 lanes of a column pair each holding D / G rows of both
// columns), since s, G and dv are independent across columns.  The chunks
// of kWkvChunk steps run last to first; each is staged in shared memory
// (r, k, a, v, do, exp(w) a row; v . do and sum_i r_i u_i k_i a step), its
// states are recomputed from the forward's checkpoint (the forward's own
// fmaf form) into a thread-private scratch in global memory (JC x D x
// kWkvChunk floats a block: 42 MB in all at (4, 2048, 40, 64), about L2's
// size), then the steps run backwards with G in registers.  dv is a sum
// over rows: the forward's reduce-scatter over the 8 lanes.  dr, dk and
// dw are sums over columns: xor shuffles over the warp's column pairs, one
// partial a warp into shared memory, one barrier a step (double-buffered),
// the warps' partials added in warp order and written, per column block, to
// part; wkv6_bwd_finish_kernel adds the column blocks' partials in order,
// and du's per-(batch, head) sums over the batch in order.  No float
// atomics: every sum is taken in one fixed order, so two runs agree bit
// for bit.  A simple kernel: a barrier and a scratch round trip a step.
// ---------------------------------------------------------------------------
struct WkvBwdArgs {
  const void *r, *k, *v, *w, *u, *ckpt, *dout, *dstate_out;
  void *dstate_in, *dr, *dk, *dv, *dw, *du, *part, *du_part, *scratch;
  int b, t, h;
  cudaStream_t st;
};

template <typename T, int D>
__global__ void __launch_bounds__(WkvLayout<D>::THREADS)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ ckpt, const T* __restrict__ dout,
                const float* __restrict__ dstate_out, float* __restrict__ dstate_in,
                T* __restrict__ dv, float* __restrict__ part, float* __restrict__ du_part,
                float2* __restrict__ scratch, int t_len, int heads, int batch) {
  using L = WkvLayout<D>;
  constexpr int G = L::G, RPT = L::RPT, JC = L::JC, NT = L::THREADS, C = kWkvChunk;
  constexpr int W = NT / 32, LANES = L::LANES, PARTS = L::PARTS;
  static_assert(NT % D == 0 && (C * D) % NT == 0 && NT >= D && 32 % G == 0,
                "whole rows a round, a thread's staged row fixed, whole column pairs a warp");
  __shared__ float4 rkav[C][D];     // r_i, k_i, a_i, v_i per staged step
  __shared__ float2 dew[C][D];      // do_i, exp(w_i)
  __shared__ float2 sc[C][PARTS];   // partial sums of (v . do, sum_i r_i u_i k_i)
  __shared__ float prt[2][W][3][D]; // a warp's column sums of dr, dk, dw, double-buffered

  const int x = threadIdx.x, g = x % G, half = g >= G / 2, c = x / G * 2, warp = x / 32;
  const int y = blockIdx.y, j = y * JC + c;
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const long long step = static_cast<long long>(heads) * D;
  const long long base = static_cast<long long>(b) * t_len * step + static_cast<long long>(h) * D;
  const long long plane = static_cast<long long>(batch) * t_len * step;  // one part plane
  const int nc = (t_len + C - 1) / C;
  const float* ck = ckpt + static_cast<long long>(bh) * nc * D * D + j;
  float2* scr = scratch + (static_cast<long long>(bh) * gridDim.y + y) * C * RPT * NT + x;
  const int xi = x % D;             // the row this thread stages and reduces
  const float ui = u[h * D + xi];

  float2 gs[RPT];                   // G: rows m * G + g, columns j and j + 1
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    gs[m] = dstate_out ? *reinterpret_cast<const float2*>(
                             dstate_out + (static_cast<long long>(bh) * D + m * G + g) * D + j)
                       : make_float2(0.f, 0.f);
  }
  float du_acc = 0.f;
  int buf = 0;
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * C, n = min(C, t_len - t0);
    __syncthreads();  // the later chunk's steps are done with the staged values
#pragma unroll
    for (int e0 = 0; e0 < C * D; e0 += NT) {
      const int tt = (e0 + x) / D;
      const bool live = tt < n;
      const long long off = base + static_cast<long long>(t0 + tt) * step + xi;
      const float ri = live ? to_f32(r[off]) : 0.f, ki = live ? to_f32(k[off]) : 0.f;
      const float vi = live ? to_f32(v[off]) : 0.f, wi = live ? w[off] : 0.f;
      const float doi = live ? to_f32(dout[off]) : 0.f;
      float vd = vi * doi, bo = ri * ui * ki;
#pragma unroll
      for (int q = LANES / 2; q > 0; q >>= 1) {
        vd += __shfl_xor_sync(0xffffffffu, vd, q);
        bo += __shfl_xor_sync(0xffffffffu, bo, q);
      }
      if (live) {
        const float ew = expf(wi);
        rkav[tt][xi] = make_float4(ri, ki, expf(-ew), vi);
        dew[tt][xi] = make_float2(doi, ew);
        if (xi % LANES == 0) sc[tt][xi / LANES] = make_float2(vd, bo);
      }
    }
    __syncthreads();
    // the chunk's states s_{t-1}, recomputed from its checkpoint
    float2 s[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      s[m] = *reinterpret_cast<const float2*>(ck + (static_cast<long long>(ci) * D + m * G + g) * D);
    }
    for (int tt = 0; tt < n; ++tt) {
      const float2 vj = make_float2(rkav[tt][j].w, rkav[tt][j + 1].w);
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        scr[(tt * RPT + m) * NT] = s[m];
        const float4 e = rkav[tt][m * G + g];
        s[m].x = fmaf(s[m].x, e.z, e.y * vj.x);
        s[m].y = fmaf(s[m].y, e.z, e.y * vj.y);
      }
    }
    for (int tt = n - 1; tt >= 0; --tt) {
      const float2 vj = make_float2(rkav[tt][j].w, rkav[tt][j + 1].w);
      const float2 doj = make_float2(dew[tt][j].x, dew[tt][j + 1].x);
      float drp[RPT], dkp[RPT], dwp[RPT];
      float dv0 = 0.f, dv1 = 0.f;
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const float2 sp = scr[(tt * RPT + m) * NT];
        const float4 e = rkav[tt][m * G + g];
        const float2 gm = gs[m];
        drp[m] = fmaf(sp.x, doj.x, sp.y * doj.y);
        dkp[m] = fmaf(gm.x, vj.x, gm.y * vj.y);
        dwp[m] = fmaf(sp.x, gm.x, sp.y * gm.y);
        dv0 = fmaf(gm.x, e.y, dv0);
        dv1 = fmaf(gm.y, e.y, dv1);
        gs[m].x = fmaf(e.z, gm.x, e.x * doj.x);
        gs[m].y = fmaf(e.z, gm.y, e.x * doj.y);
      }
      // column sums over the warp's column pairs (lanes g, g + G, ...)
#pragma unroll
      for (int q = G; q < 32; q <<= 1) {
#pragma unroll
        for (int m = 0; m < RPT; ++m) {
          drp[m] += __shfl_xor_sync(0xffffffffu, drp[m], q);
          dkp[m] += __shfl_xor_sync(0xffffffffu, dkp[m], q);
          dwp[m] += __shfl_xor_sync(0xffffffffu, dwp[m], q);
        }
      }
      if (x % 32 < G) {
#pragma unroll
        for (int m = 0; m < RPT; ++m) {
          prt[buf][warp][0][m * G + g] = drp[m];
          prt[buf][warp][1][m * G + g] = dkp[m];
          prt[buf][warp][2][m * G + g] = dwp[m];
        }
      }
      // dv: the row sums of the two columns meet in the forward's reduce-scatter
      float p = (half ? dv1 : dv0) + __shfl_xor_sync(0xffffffffu, half ? dv0 : dv1, G / 2);
#pragma unroll
      for (int q = G / 4; q > 0; q >>= 1) p += __shfl_xor_sync(0xffffffffu, p, q);
      float vdo = 0.f, bonus = 0.f;
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        vdo += sc[tt][q].x;
        bonus += sc[tt][q].y;
      }
      const long long row = base + static_cast<long long>(t0 + tt) * step;
      if (g % (G / 2) == 0) dv[row + j + half] = from_f32<T>(fmaf(bonus, half ? doj.y : doj.x, p));
      __syncthreads();
      // the warps' partials in warp order, the u terms (once: column block 0)
      // and dw's factor; du's per-row sum over this (batch, head)'s steps
      for (int e = x; e < 3 * D; e += NT) {
        const int q = e / D;
        float val = 0.f;
#pragma unroll
        for (int wp = 0; wp < W; ++wp) val += prt[buf][wp][q][xi];
        const float4 ri = rkav[tt][xi];
        if (q == 2) {
          val *= -(dew[tt][xi].y * ri.z);
        } else if (y == 0) {
          val = fmaf(ui * (q == 0 ? ri.y : ri.x), vdo, val);
          if (q == 0) du_acc = fmaf(ri.x * ri.y, vdo, du_acc);
        }
        part[(static_cast<long long>(y) * 3 + q) * plane + row + xi] = val;
      }
      buf ^= 1;
    }
  }
  if (dstate_in) {
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      *reinterpret_cast<float2*>(dstate_in + (static_cast<long long>(bh) * D + m * G + g) * D + j) =
          gs[m];
    }
  }
  if (y == 0 && x < D) du_part[static_cast<long long>(bh) * D + x] = du_acc;
}

// dr, dk (in T) and dw: the column blocks' partials added in block order; du:
// the (batch, head) sums added in batch order
template <typename T>
__global__ void __launch_bounds__(256)
wkv6_bwd_finish_kernel(const float* __restrict__ part, const float* __restrict__ du_part,
                       T* __restrict__ dr, T* __restrict__ dk, float* __restrict__ dw,
                       float* __restrict__ du, long long n, int ny, int batch, int hd) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long e = first; e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int y = 0; y < ny; ++y) {
      s0 += part[(y * 3 + 0) * n + e];
      s1 += part[(y * 3 + 1) * n + e];
      s2 += part[(y * 3 + 2) * n + e];
    }
    dr[e] = from_f32<T>(s0);
    dk[e] = from_f32<T>(s1);
    dw[e] = s2;
  }
  if (first < hd) {
    float s = 0.f;
    for (int bb = 0; bb < batch; ++bb) s += du_part[static_cast<long long>(bb) * hd + first];
    du[first] = s;
  }
}

template <typename T, int D>
int launch_wkv6_bwd(const WkvBwdArgs& a) {
  using L = WkvLayout<D>;
  const int ny = D / L::JC;
  wkv6_bwd_kernel<T, D><<<dim3(static_cast<unsigned>(a.b * a.h), ny), L::THREADS, 0, a.st>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.w), static_cast<const float*>(a.u),
      static_cast<const float*>(a.ckpt), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.dstate_out), static_cast<float*>(a.dstate_in),
      static_cast<T*>(a.dv), static_cast<float*>(a.part), static_cast<float*>(a.du_part),
      static_cast<float2*>(a.scratch), a.t, a.h, a.b);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(a.b) * a.t * a.h * D;
  const int hd = a.h * D;
  const long long want = (std::max(n, static_cast<long long>(hd)) + 255) / 256;
  const int blocks = static_cast<int>(std::max<long long>(std::min<long long>(want, 132 * 16),
                                                          (hd + 255) / 256));
  wkv6_bwd_finish_kernel<T><<<blocks, 256, 0, a.st>>>(
      static_cast<const float*>(a.part), static_cast<const float*>(a.du_part),
      static_cast<T*>(a.dr), static_cast<T*>(a.dk), static_cast<float*>(a.dw),
      static_cast<float*>(a.du), n, ny, a.b, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wkv6_bwd(int d, const WkvBwdArgs& a) {
  switch (d) {
    case 8: return launch_wkv6_bwd<T, 8>(a);
    case 64: return launch_wkv6_bwd<T, 64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// r, k, v, out (b, t, h, d) in f32 (bf16_inputs = 0) or bf16; w (b, t, h, d),
// u (h, d), state_in (b, h, d, d; NULL = zeros) and state_out f32; all
// contiguous.  state_out may be state_in itself; d in {8, 64} (the configs' head
// sizes: SMOKE and full width).  ckpt (b, h, ceil(t / kWkvChunk), d, d) f32,
// or NULL (serving): the training forward's state checkpoints.
int rt_wkv6(const void* r, const void* k, const void* v, const void* w, const void* u,
            const void* state_in, void* state_out, void* out, void* ckpt, int b, int t, int h,
            int d, int bf16_inputs, void* stream) {
  if (b < 0 || t < 0 || h < 0 || static_cast<long long>(b) * h > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_inputs) {
    return dispatch_wkv6<bf16>(d, r, k, v, w, u, state_in, state_out, out, ckpt, b, t, h, st);
  }
  return dispatch_wkv6<float>(d, r, k, v, w, u, state_in, state_out, out, ckpt, b, t, h, st);
}

// The gradient of rt_wkv6 (with ckpt) for the output gradient dout (b, t, h,
// d) in r's type and the final state's dstate_out (b, h, d, d) f32 (NULL =
// zeros): dr, dk, dv (b, t, h, d) in r's type, dw (b, t, h, d) f32, du (h,
// d) f32 and, when dstate_in is not NULL, the initial state's (b, h, d, d)
// f32.  Scratch the caller allocates: part (d / 32 or 1, 3, b, t, h, d) f32,
// du_part (b, h, d) f32 and scratch (b, h, kWkvChunk, d, d) f32.  t >= 1;
// all contiguous.
int rt_wkv6_bwd(const void* r, const void* k, const void* v, const void* w, const void* u,
                const void* ckpt, const void* dout, const void* dstate_out, void* dstate_in,
                void* dr, void* dk, void* dv, void* dw, void* du, void* part, void* du_part,
                void* scratch, int b, int t, int h, int d, int bf16_inputs, void* stream) {
  if (b < 0 || t < 1 || h < 0 || static_cast<long long>(b) * h > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  const WkvBwdArgs a{r, k, v, w, u, ckpt, dout, dstate_out, dstate_in, dr, dk, dv, dw, du,
                     part, du_part, scratch, b, t, h, static_cast<cudaStream_t>(stream)};
  if (bf16_inputs) return dispatch_wkv6_bwd<bf16>(d, a);
  return dispatch_wkv6_bwd<float>(d, a);
}

}  // extern "C"
