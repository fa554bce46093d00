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

#include <cstdint>

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
// thread its own elements: the S0 of each of wkv6_bwd_chunk_kernel's chunks
// (the recurrence cannot be run backwards: a decay exp(-exp(w)) underflows
// to 0 in f32, so a state is never recovered by division).
// ---------------------------------------------------------------------------
// steps between two of the training forward's state checkpoints: the
// backward's chunk
constexpr int kWkvChunk = 32;
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
// exp(-exp(w_t)) acting on the rows i (the k index), G_t = dL/ds_t and
// dlambda_t = a_t sum_j s_{t-1}[i][j] G_t[i][j] (so dw_t = -exp(w_t) dlambda_t):
//   G_{t-1} = diag(a_t) G_t + r_t^T do_t          (from G_T = dstate_out)
//   dr_t[i] = sum_j s_{t-1}[i][j] do_t[j] + u_i k_t[i] (v_t . do_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j] + u_i r_t[i] (v_t . do_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) do_t[j]
//   du_i    = sum_{b, t} r_t[i] k_t[i] (v_t . do_t);   dstate_in = G_0.
// The JAX package trains through the plain scan, so there is no Pallas
// kernel of the gradient to replace; this is the gradient of
// repro/kernels/wkv6.py:_wkv6_kernel's function.
// Bound: operations (the cost model in kernels/wkv6.py: 14 D^2 flops a step
// and head at the fp32 rate) at the training shape.
// Design: chunk-parallel over chunks of C = kWkvChunk steps, the forward's
// state checkpoint S0 entering each.  Within a chunk (t0 .. t1 - 1, E(x, y) the
// product of the decays a_{y+1} .. a_x, each <= 1, so no factor overflows and
// a decay that underflows zeroes every span that holds it) the gradient has
// closed forms in S0 and G_end = G_{t1-1}:
//   dr'_t = E(t-1, t0-1) (S0 do_t) + sum_{tau<t} E(t-1, tau) k_tau (v_tau . do_t)
//   dk'_t = E(t1-1, t) (G_end v_t) + sum_{sig>t} E(sig-1, t) r_sig (do_sig . v_t)
//   dv'_t = G_end^T (E(t1-1, t) k_t) + sum_{sig>t} B[sig][t] do_sig,
//           B[sig][tau] = sum_i E(sig-1, tau) r_sig k_tau
//   dlambda_t = E(t1-1, t0-1) rowsum(S0 . G_end)
//           + sum_{sig>t} r_sig E(sig-1, t0-1) (S0 do_sig)
//           + sum_{tau<t} k_tau E(t1-1, tau) (G_end v_tau)
//           + sum_{tau<t<sig} E(sig-1, tau) k_tau r_sig (v_tau . do_sig)
// (every term of dlambda_t holds a_t: it is exactly 0 where a_t underflows,
// which a difference of state-sized sums would not give).  Four kernels:
// * wkv6_bwd_contrib_kernel, every (batch, head, chunk) at once: the chunk's
//   term of G's scan, (r . E(t-1, t0-1))^T do, a D x C by C x D product on
//   the tensor cores, and E(t1-1, t0-1).
// * wkv6_bwd_scan_kernel: the only sequential part, the chunk-level scan
//   G_{t0-1} = diag(E(t1-1, t0-1)) G_end + term, elementwise (a thread four
//   elements of one head's G, chunks last to first, terms loaded four
//   chunks ahead), writing G_end of every chunk over its term (B, H, nc, D,
//   D) and ds0; no chain or barrier a chunk stands in its way.
// * wkv6_bwd_chunk_kernel: every (batch, head, chunk) at once, grid (B * H,
//   nc) (10240 blocks at the rwkv6-3b layer); the chunk's
//   r, k, v, do (in their type), S0 and G_end by cp.async into shared
//   memory, the decays and exp(w) beside them.  The products do S0^T,
//   v G_end^T, do v^T (whose diagonal is v . do) and K~ G_end run on the
//   tensor cores as 3xTF32 mma.sync m16n8k8 (a bf16 operand is exact in
//   TF32 and skips its lo term; a warp splits its A fragment once for all
//   its n8 tiles); the terms with a per-element relative decay stay on FMA:
//   each row's thread walks 8 x 8 tiles of the tau < sig triangle (the
//   rows' two groups take sig-tiles a and NTILE - 1 - a, so the work splits
//   evenly), every decay a product of per-step decays over its span
//   (tile-local prefix and suffix products and whole tiles' products
//   between, never a quotient); B's per-pair sums over the rows meet in a
//   shuffle reduce-scatter and the warps' partials in shared memory;
//   dlambda's pairs tau < t < sig are tile prefix, suffix and between-tile
//   sums of the same products.  dv adds B^T do to K~ G_end in the same mma
//   accumulators; dk, dlambda and du's partial close the chunk in passes
//   over its steps, two threads a row; dr, dk, dv and dw are written once,
//   du as per-(b, chunk) partials that wkv6_bwd_du_kernel adds in order.
//   Shared memory (103,552 bytes at bf16, D = 64) holds two blocks an SM.
// C = 32: the checkpoints and G_end are 168 MB each at the rwkv6-3b layer
// (335 MB at 16); at 64 the groups' partials no longer leave room for two
// blocks an SM.  A guarded global read keeps its address in bounds whether
// or not it is taken (the compiler may issue it anyway).
// No float atomics: every sum is taken in one fixed order, so two runs agree
// bit for bit.
// ---------------------------------------------------------------------------
struct WkvBwdArgs {
  const void *r, *k, *v, *w, *u, *ckpt, *dout, *dstate_out;
  void *dstate_in, *dr, *dk, *dv, *dw, *du, *gend, *tot, *du_part;
  int b, t, h;
  cudaStream_t st;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full (src then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

// The chunk's rows t0 .. t0 + C - 1 of a (B, T, H, D) input of type T into a
// shared (C, stride) tile by cp.async, 16 bytes a copy; rows from n on are
// zeros (their source address stays in bounds all the same).
template <typename T, int D, int C, int NT>
__device__ __forceinline__ void stage_rows(T* dst, int stride, const T* src, long long base,
                                           long long step, int n) {
  constexpr int E = 16 / sizeof(T), PR = D / E;   // elements a copy, copies a row
  static_assert(D % E == 0, "whole 16-byte pieces a row");
#pragma unroll
  for (int f = threadIdx.x; f < C * PR; f += NT) {
    const int tt = f / PR, p = f % PR;
    cp_async16(smem_u32(dst + tt * stride + p * E),
               src + base + static_cast<long long>(min(tt, n - 1)) * step + p * E, tt < n);
  }
}

// The chunk's decays exp(-exp(w)) into a shared (C, D) tile (and exp(w)
// into ew when not null), float4 loads all in flight together; decay 1 and
// exp(w) 0 from row n on.
template <int D, int C, int NT>
__device__ __forceinline__ void stage_decays(float* dst, float* ew, const float* w,
                                             long long base, long long step, int n) {
  static_assert(D % 4 == 0, "float4 rows");
  constexpr int Q = C * D / 4, R = (Q + NT - 1) / NT;
  float4 v[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int f = threadIdx.x + m * NT, tt = min(f / (D / 4), n - 1);
    v[m] = f < Q ? *reinterpret_cast<const float4*>(w + base + static_cast<long long>(tt) * step +
                                                    f % (D / 4) * 4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int f = threadIdx.x + m * NT;
    if (f < Q) {
      const bool live = f / (D / 4) < n;
      const float4 e = live ? make_float4(expf(v[m].x), expf(v[m].y), expf(v[m].z), expf(v[m].w))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + f * 4) =
          make_float4(expf(-e.x), expf(-e.y), expf(-e.z), expf(-e.w));
      if (ew) *reinterpret_cast<float4*>(ew + f * 4) = e;
    }
  }
}
// every cp.async of this thread landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// d += a * b, one m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<bf16> {
  static constexpr bool value = true;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// acc[n] += A B for the warp's m16 row tile at m0 and the NN n8 tiles at
// n0 + 8 n, over K (a multiple of 8), 3xTF32: per k-step and tile a_lo b_hi,
// a_hi b_lo, a_hi b_hi, in that order; an operand exact in TF32 (AX, BX:
// bf16 values) has lo = 0 and its term is skipped.  Each k-step's A
// fragment is loaded and split once for all NN tiles.  fa(row, col) and
// fb(k, col) read the operands' f32 values (fragment order: a0 row g col t,
// a1 row g + 8, a2 / a3 col t + 4; b0 k t col g, b1 k t + 4).
template <bool AX, bool BX, int K, int NN, typename FA, typename FB>
__device__ __forceinline__ void mma3_rows(float (&acc)[NN][4], int m0, int n0, FA fa, FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {fa(m0 + g, k0 + t4), fa(m0 + g + 8, k0 + t4), fa(m0 + g, k0 + t4 + 4),
                         fa(m0 + g + 8, k0 + t4 + 4)};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(av[e], ah[e], al[e]);
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      const int col = n0 + nt * 8 + g;
      const float bv[2] = {fb(k0 + t4, col), fb(k0 + t4 + 4, col)};
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) split_tf32(bv[e], bh[e], bl[e]);
      if (!AX) mma_tf32(acc[nt], al, bh);
      if (!BX) mma_tf32(acc[nt], ah, bl);
      mma_tf32(acc[nt], ah, bh);
    }
  }
}

// ---- the chunk-level scan of G ---------------------------------------------
// wkv6_bwd_contrib_kernel, every (batch, head, chunk) at once: the chunk's
// term of G's scan, (r . E(t-1, t0-1))^T do (D x C by C x D, 3xTF32
// mma.sync, a warp a 16-row tile of G), into gend's slot of the chunk, and
// E(t1-1, t0-1) into tot; the exclusive prefix products a chain a row.
template <int D>
constexpr int kRowsPad = D < 16 ? 16 : D;   // G's rows padded to a whole m16 tile

template <int D>
struct WkvContribLayout {
  static constexpr int C = kWkvChunk;
  static constexpr int MT = (D + 15) / 16;        // m16 tiles of G's rows, a warp each
  static constexpr int NT = MT * 32;
  static constexpr int RP = (D < 16 ? 16 : D) + 8;  // (r . E) rows: conflict-free A loads
  static constexpr int DP = D + 8;                // r and do rows: conflict-free B loads
};

template <typename T, int D>
__global__ void __launch_bounds__(WkvContribLayout<D>::NT)
wkv6_bwd_contrib_kernel(const T* __restrict__ r, const float* __restrict__ w,
                        const T* __restrict__ dout, float* __restrict__ gend,
                        float* __restrict__ tot, int t_len, int heads) {
  using L = WkvContribLayout<D>;
  constexpr int C = L::C, NT = L::NT, RP = L::RP, DP = L::DP;
  __shared__ __align__(16) T s_r[C][DP];
  __shared__ __align__(16) T s_do[C][DP];
  __shared__ __align__(16) float s_dec[C][D];
  __shared__ float s_rh[C][RP];   // r . E(t-1, t0-1); rows past D zero
  const int x = threadIdx.x, warp = x >> 5, lane = x & 31, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / heads, h = bh % heads;
  const int t0 = c * C, n = min(C, t_len - t0);
  const long long step = static_cast<long long>(heads) * D;
  const long long base =
      (static_cast<long long>(b) * t_len + t0) * step + static_cast<long long>(h) * D;
  stage_rows<T, D, C, NT>(&s_r[0][0], DP, r, base, step, n);
  stage_rows<T, D, C, NT>(&s_do[0][0], DP, dout, base, step, n);
  stage_decays<D, C, NT>(&s_dec[0][0], nullptr, w, base, step, n);
  cp_async_wait_all();
  __syncthreads();
  if (x < D) {
    float p = 1.f;
#pragma unroll
    for (int tt = 0; tt < C; ++tt) {
      s_rh[tt][x] = to_f32(s_r[tt][x]) * p;
      p *= s_dec[tt][x];
    }
    tot[(static_cast<long long>(bh) * nc + c) * D + x] = p;
  } else if (x < kRowsPad<D>) {
#pragma unroll
    for (int tt = 0; tt < C; ++tt) s_rh[tt][x] = 0.f;
  }
  __syncthreads();
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  mma3_rows<false, IsBf16<T>::value, C, D / 8>(
      acc, warp * 16, 0, [&](int i, int tt) { return s_rh[tt][i]; },
      [&](int tt, int j) { return to_f32(s_do[tt][j]); });
  float* dst = gend + (static_cast<long long>(bh) * nc + c) * D * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = warp * 16 + g + 8 * hf;
      if (row < D) {
        *reinterpret_cast<float2*>(dst + row * D + nt * 8 + 2 * t4) =
            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      }
    }
  }
}

// wkv6_bwd_scan_kernel: the scan itself, elementwise, a thread four
// elements (i, j .. j + 3) of one (batch, head)'s G, chunks last to first:
// G_end of chunk c replaces the chunk's term in gend, then G = fmaf(tot, G,
// term); the last G is ds0.  The terms are loaded four chunks ahead.
constexpr int kScanThreads = 256;
__global__ void __launch_bounds__(kScanThreads)
wkv6_bwd_scan_kernel(const float* __restrict__ dstate_out, float* __restrict__ gend,
                     const float* __restrict__ tot, float* __restrict__ dstate_in, int nc, int d,
                     long long n4) {
  const long long q = static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (q >= n4) return;
  const int per = d * d / 4;                       // float4 a (batch, head)'s G
  const long long bh = q / per;
  const int f = static_cast<int>(q % per);
  float4 g4 = dstate_out ? reinterpret_cast<const float4*>(dstate_out)[q]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* gp = reinterpret_cast<float4*>(gend) + bh * nc * per + f;   // chunk c: gp[c * per]
  const float* tp = tot + bh * nc * d + f * 4 / d;                      // chunk c: tp[c * d]
  auto step = [&](float4 term, float tc) {
    g4 = make_float4(fmaf(tc, g4.x, term.x), fmaf(tc, g4.y, term.y), fmaf(tc, g4.z, term.z),
                     fmaf(tc, g4.w, term.w));
  };
  int c = nc - 1;
  for (; c >= 3; c -= 4) {
    float4 term[4];
    float tc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      term[u] = gp[static_cast<long long>(c - u) * per];
      tc[u] = tp[static_cast<long long>(c - u) * d];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      gp[static_cast<long long>(c - u) * per] = g4;
      step(term[u], tc[u]);
    }
  }
  for (; c >= 0; --c) {
    const float4 term = gp[static_cast<long long>(c) * per];
    const float tc = tp[static_cast<long long>(c) * d];
    gp[static_cast<long long>(c) * per] = g4;
    step(term, tc);
  }
  if (dstate_in) reinterpret_cast<float4*>(dstate_in)[q] = g4;
}

// ---- the chunks ------------------------------------------------------------
constexpr int kBwdTile = 8;   // steps of a tile of the FMA part

template <typename T, int D>
struct WkvBwdLayout {
  static constexpr int C = kWkvChunk, TS = kBwdTile, NTILE = C / TS, NG = NTILE / 2;
  static constexpr int RW = D < 32 ? D : 32;   // rows whose B sums one warp's shuffles take
  static constexpr int WPG = D / RW;           // row segments (warps) of a group
  static constexpr int NT = D * NG < 32 ? 32 : D * NG;
  static constexpr int NW = NT / 32;
  static constexpr int MT = C / 16, ND = D / 8;
  // the products' split: a warp takes MPW m16 tiles of rows and 1 / WPM of their n8 tiles
  static constexpr int WPM = NW >= MT ? NW / MT : 1, MPW = MT > NW ? MT / NW : 1;
  static constexpr int TP = IsBf16<T>::value ? D + 8 : D + 4;  // staged row stride (elements)
  static constexpr int SP = D + 4;   // S0, G_end, K~: conflict-free A / B fragment loads
  static constexpr int XP = D + 8;   // fragment-stored (C, D) rows: conflict-free float2 stores
  static constexpr int AP = C + 8;
  static constexpr int IN = round16(C * TP * static_cast<int>(sizeof(T)));
  static constexpr int O_R = 0, O_K = IN, O_V = 2 * IN, O_DO = 3 * IN, O_DEC = 4 * IN;
  // S0 and G_end, then the groups' dk and dlambda partials
  static constexpr int O_U = O_DEC + round16(C * D * 4);
  static constexpr int O_XR = O_U + round16(cmax(2 * D * SP, 2 * NG * C * D) * 4);
  static constexpr int O_XK = O_XR + round16(C * XP * 4);
  // K~, then B's warp partials
  static constexpr int O_KT = O_XK + round16(C * XP * 4);
  static constexpr int O_A = O_KT + round16(cmax(C * SP, WPG * C * C) * 4);
  static constexpr int O_TOT = O_A + round16(C * AP * 4);
  static constexpr int O_P = O_TOT + round16(D * 4);
  static constexpr int O_BO = O_P + round16(D * 4);
  static constexpr int O_PRE = O_BO + round16(C * 4);
  static constexpr int O_EW = O_PRE + round16(NTILE * D * 4);
  static constexpr int SMEM = O_EW + round16(C * D * 4);
};

// One splitting stage of reduce_scatter8: N of the 2N values kept (the upper
// half where lane & o), each plus the partner lane's value of the same index.
template <int N>
__device__ __forceinline__ void split_stage(float (&v)[8], int o, bool up, unsigned mask) {
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const float lo = v[m], hi = v[m + N];
    v[m] = (up ? hi : lo) + __shfl_xor_sync(mask, up ? lo : hi, o);
  }
}

// v[0..7] summed over the RW lanes of a row segment in xor-shuffle order
// (offsets RW / 2, ..., 1): the first three stages split the values
// (reduce-scatter), the rest add; returns the sum of v[idx], idx from the
// lane's bits.  mask: the lanes taking part.
template <int RW>
__device__ __forceinline__ float reduce_scatter8(float (&v)[8], int lane, unsigned mask,
                                                 int& idx) {
  static_assert(RW >= 8, "three splitting stages");
  const bool u4 = lane & (RW / 2), u2 = lane & (RW / 4), u1 = lane & (RW / 8);
  split_stage<4>(v, RW / 2, u4, mask);
  split_stage<2>(v, RW / 4, u2, mask);
  split_stage<1>(v, RW / 8, u1, mask);
  idx = (u4 ? 4 : 0) + (u2 ? 2 : 0) + (u1 ? 1 : 0);
#pragma unroll
  for (int o = RW / 16; o > 0; o >>= 1) v[0] += __shfl_xor_sync(mask, v[0], o);
  return v[0];
}

template <typename T, int D>
__global__ void __launch_bounds__(WkvBwdLayout<T, D>::NT, 2)
wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ w, const float* __restrict__ u,
                      const float* __restrict__ ckpt, const float* __restrict__ gend,
                      const T* __restrict__ dout, T* __restrict__ dr, T* __restrict__ dk,
                      T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
                      int t_len, int heads) {
  using L = WkvBwdLayout<T, D>;
  constexpr int C = L::C, TS = L::TS, NG = L::NG, NT = L::NT, NW = L::NW, RW = L::RW;
  constexpr int TP = L::TP, SP = L::SP, XP = L::XP, AP = L::AP, MT = L::MT, ND = L::ND;
  constexpr bool EX = IsBf16<T>::value;
  constexpr int WPM = L::WPM, MPW = L::MPW, NND = ND / WPM, NNA = C / 8 / WPM;
  static_assert(C % 16 == 0 && L::NTILE % 2 == 0 && D % 8 == 0 && NT >= 2 * D &&
                    MPW * NW == MT * WPM && ND % WPM == 0 && (C / 8) % WPM == 0 &&
                    C % (NW * (32 / RW)) == 0,
                "whole m16 tiles, paired sig-tiles, whole n8 tiles, two row threads a row, "
                "the products' tiles split evenly over the warps, whole staging rounds");
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_r = reinterpret_cast<T*>(smem + L::O_R);
  T* s_k = reinterpret_cast<T*>(smem + L::O_K);
  T* s_v = reinterpret_cast<T*>(smem + L::O_V);
  T* s_do = reinterpret_cast<T*>(smem + L::O_DO);
  float* s_dec = reinterpret_cast<float*>(smem + L::O_DEC);   // (C, D) decays, 1 past the end
  float* s_s0 = reinterpret_cast<float*>(smem + L::O_U);      // (D, SP)
  float* s_g = s_s0 + D * SP;                                  // (D, SP)
  float* s_dkp = reinterpret_cast<float*>(smem + L::O_U);     // (NG, C, D), after the products
  float* s_lamp = s_dkp + NG * C * D;                          // (NG, C, D)
  float* s_xr = reinterpret_cast<float*>(smem + L::O_XR);     // (C, XP): S0 do_t
  float* s_xk = reinterpret_cast<float*>(smem + L::O_XK);     // (C, XP): G_end v_t
  float* s_kt = reinterpret_cast<float*>(smem + L::O_KT);     // (C, SP): K~ = E(t1-1, t) k_t
  float* s_bp = s_kt;                                          // (WPG, C, C), after the products
  float* s_a = reinterpret_cast<float*>(smem + L::O_A);       // (C, AP): do_sig . v_tau
  float* s_tot = reinterpret_cast<float*>(smem + L::O_TOT);
  float* s_p = reinterpret_cast<float*>(smem + L::O_P);
  float* s_bo = reinterpret_cast<float*>(smem + L::O_BO);
  float* s_pre = reinterpret_cast<float*>(smem + L::O_PRE);   // (NTILE, D): E(a TS - 1, t0-1)
  float* s_ew = reinterpret_cast<float*>(smem + L::O_EW);     // (C, D): exp(w), 0 past the end

  const int x = threadIdx.x, lane = x & 31, warp = x >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / heads, h = bh % heads;
  const int t0 = c * C, n = min(C, t_len - t0);
  const long long step = static_cast<long long>(heads) * D;
  const long long base =
      (static_cast<long long>(b) * t_len + t0) * step + static_cast<long long>(h) * D;
  const long long sbase = (static_cast<long long>(bh) * nc + c) * D * D;

  // ---- staging by cp.async: S0, G_end, the chunk's steps (zero past the
  // end); the decays (1 past the end) meanwhile
#pragma unroll
  for (int f = x; f < D * D / 4; f += NT) {
    const int i = f / (D / 4), j = f % (D / 4) * 4;
    cp_async16(smem_u32(s_s0 + i * SP + j), ckpt + sbase + i * D + j);
    cp_async16(smem_u32(s_g + i * SP + j), gend + sbase + i * D + j);
  }
  stage_rows<T, D, C, NT>(s_r, TP, r, base, step, n);
  stage_rows<T, D, C, NT>(s_k, TP, k, base, step, n);
  stage_rows<T, D, C, NT>(s_v, TP, v, base, step, n);
  stage_rows<T, D, C, NT>(s_do, TP, dout, base, step, n);
  stage_decays<D, C, NT>(s_dec, s_ew, w, base, step, n);
  cp_async_wait_all();
  __syncthreads();

  // ---- K~ and E(t1-1, t0-1) (a suffix chain a row), P = rowsum(S0 . G_end)
  // and the tiles' prefix products (a prefix chain a row), the bonus sums
  // sum_i (r_i u_i) k_i
  if (x < D) {
    float s = 1.f;
#pragma unroll
    for (int tt = C - 1; tt >= 0; --tt) {
      s_kt[tt * SP + x] = s * to_f32(s_k[tt * TP + x]);
      s *= s_dec[tt * D + x];
    }
    s_tot[x] = s;
  } else if (x < 2 * D) {
    const int i = x - D;
    float p = 0.f;
    for (int j = 0; j < D; j += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(s_s0 + i * SP + j);
      const float4 g4 = *reinterpret_cast<const float4*>(s_g + i * SP + j);
      p = fmaf(a4.x, g4.x, p);
      p = fmaf(a4.y, g4.y, p);
      p = fmaf(a4.z, g4.z, p);
      p = fmaf(a4.w, g4.w, p);
    }
    s_p[i] = p;
    float pre = 1.f;   // the exclusive prefix products at each tile's first step
#pragma unroll
    for (int tt = 0; tt < C; ++tt) {
      if (tt % TS == 0) s_pre[tt / TS * D + i] = pre;
      pre *= s_dec[tt * D + i];
    }
  }
  for (int tt = warp * (32 / RW) + lane / RW; tt < C; tt += NW * (32 / RW)) {
    const int l = lane % RW;
    float p = to_f32(s_r[tt * TP + l]) * u[h * D + l] * to_f32(s_k[tt * TP + l]);
#pragma unroll
    for (int m = 1; m < D / RW; ++m) {
      const int i = l + m * RW;
      p = fmaf(to_f32(s_r[tt * TP + i]) * u[h * D + i], to_f32(s_k[tt * TP + i]), p);
    }
#pragma unroll
    for (int o = RW / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (l == 0) s_bo[tt] = p;
  }
  __syncthreads();

  // ---- the products (3xTF32 mma.sync): do S0^T, v G_end^T, do v^T into
  // shared memory, K~ G_end into each warp's dv accumulators; a warp takes
  // the m16 row tiles mrow .. mrow + MPW - 1 and 1 / WPM of their n8 tiles
  auto store_rows = [&](float* dst, int stride, int m0, int n0, const float (&d)[4]) {
    *reinterpret_cast<float2*>(dst + (m0 + g) * stride + n0 + 2 * t4) = make_float2(d[0], d[1]);
    *reinterpret_cast<float2*>(dst + (m0 + g + 8) * stride + n0 + 2 * t4) =
        make_float2(d[2], d[3]);
  };
  auto stg = [](const T* s, int stride) {
    return [=](int row, int col) { return to_f32(s[row * stride + col]); };
  };
  const int mrow = warp / WPM * MPW, npart = warp % WPM;
  float xv[MPW][NND][4];   // dv: row tile mrow + mi, n8 tiles npart * NND + nt
#pragma unroll
  for (int mi = 0; mi < MPW; ++mi) {
    const int m0 = (mrow + mi) * 16;
    {
      float acc[NND][4] = {};
      mma3_rows<EX, false, D, NND>(acc, m0, npart * NND * 8, stg(s_do, TP),
                                   [&](int j, int i) { return s_s0[i * SP + j]; });
#pragma unroll
      for (int nt = 0; nt < NND; ++nt) store_rows(s_xr, XP, m0, (npart * NND + nt) * 8, acc[nt]);
    }
    {
      float acc[NND][4] = {};
      mma3_rows<EX, false, D, NND>(acc, m0, npart * NND * 8, stg(s_v, TP),
                                   [&](int j, int i) { return s_g[i * SP + j]; });
#pragma unroll
      for (int nt = 0; nt < NND; ++nt) store_rows(s_xk, XP, m0, (npart * NND + nt) * 8, acc[nt]);
    }
    {
      float acc[NNA][4] = {};
      mma3_rows<EX, EX, D, NNA>(acc, m0, npart * NNA * 8, stg(s_do, TP),
                                [&](int j, int tau) { return to_f32(s_v[tau * TP + j]); });
#pragma unroll
      for (int nt = 0; nt < NNA; ++nt) store_rows(s_a, AP, m0, (npart * NNA + nt) * 8, acc[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NND; ++nt) {
      xv[mi][nt][0] = xv[mi][nt][1] = xv[mi][nt][2] = xv[mi][nt][3] = 0.f;
    }
    mma3_rows<false, false, D, NND>(xv[mi], m0, npart * NND * 8,
                                    [&](int tt, int i) { return s_kt[tt * SP + i]; },
                                    [&](int i, int j) { return s_g[i * SP + j]; });
  }
  __syncthreads();

  // ---- the terms with a relative decay: a row's thread, 8 x 8 tiles
  if (x < D * NG) {
    constexpr unsigned kMask = D * NG >= 32 ? 0xffffffffu : (1u << (D * NG)) - 1u;
    const int q = x / D, i = x % D, seg = i / RW;
    const float ui = u[h * D + i];
    float* dkp = s_dkp + q * C * D + i;     // [tt * D]
    float* lamp = s_lamp + q * C * D + i;
    for (int tt = 0; tt < C; ++tt) {
      dkp[tt * D] = 0.f;
      lamp[tt * D] = 0.f;
    }
    auto dec = [&](int tt) { return s_dec[tt * D + i]; };
    // B's per-pair sums of a sig row over the segment's rows, into its warp partial
    auto b_row = [&](float (&bb)[TS], int sig, int tau0) {
      int idx;
      const float s = reduce_scatter8<RW>(bb, lane, kMask, idx);
      if (lane % (RW / 8) == 0) s_bp[(seg * C + sig) * C + tau0 + idx] = s;
    };
    auto a_row = [&](int sig, int tau0, float (&av)[TS]) {
      const float4 a0 = *reinterpret_cast<const float4*>(s_a + sig * AP + tau0);
      const float4 a1 = *reinterpret_cast<const float4*>(s_a + sig * AP + tau0 + 4);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
    };
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int a = pass == 0 ? q : L::NTILE - 1 - q, sa = a * TS;
      const float pre_a = s_pre[a * D + i];   // E(sa-1, t0-1)
      float lp[TS], rs[TS], dr_acc[TS], lam_a[TS];
      lp[0] = 1.f;
#pragma unroll
      for (int s = 1; s < TS; ++s) lp[s] = lp[s - 1] * dec(sa + s - 1);
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        rs[s] = to_f32(s_r[(sa + s) * TP + i]);
        lam_a[s] = 0.f;
      }
      {   // the diagonal tile: pairs q < s inside sig-tile a
        float ks[TS], e[TS][TS], drt[TS], dkt[TS];
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          ks[s] = to_f32(s_k[(sa + s) * TP + i]);
          drt[s] = dkt[s] = 0.f;
        }
#pragma unroll
        for (int s = 1; s < TS; ++s) {
          e[s][s - 1] = 1.f;
#pragma unroll
          for (int qq = s - 2; qq >= 0; --qq) e[s][qq] = e[s][qq + 1] * dec(sa + qq + 1);
        }
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          float av[TS], bb[TS], run = 0.f;
          a_row(sa + s, sa, av);
#pragma unroll
          for (int qq = 0; qq < TS; ++qq) {
            if (qq < s) {
              const float ek = e[s][qq] * ks[qq], er = e[s][qq] * rs[s];
              drt[s] = fmaf(ek, av[qq], drt[s]);
              dkt[qq] = fmaf(er, av[qq], dkt[qq]);
              bb[qq] = er * ks[qq];
              if (qq < s - 1) {   // pairs qq < t < s: dlambda inside the tile
                run += rs[s] * (ek * av[qq]);
                lam_a[qq + 1] += run;
              }
            } else {
              bb[qq] = 0.f;
            }
          }
          b_row(bb, sa + s, sa);
        }
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          dkp[(sa + s) * D] += dkt[s];
          dr_acc[s] = drt[s];
        }
      }
      float span = 1.f;   // E(sa-1, tb+TS-1): the whole tiles between
#pragma unroll 1
      for (int bt = a - 1; bt >= 0; --bt) {
        const int tb = bt * TS;
        float ks[TS], ls[TS], lps[TS], drt[TS], dkt[TS];
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          ks[s] = to_f32(s_k[(tb + s) * TP + i]);
          lps[s] = lp[s] * span;
          drt[s] = dkt[s] = 0.f;
        }
        ls[TS - 1] = 1.f;
#pragma unroll
        for (int qq = TS - 2; qq >= 0; --qq) ls[qq] = ls[qq + 1] * dec(tb + qq + 1);
        const float tile_prod = ls[0] * dec(tb);
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          float av[TS], bb[TS];
          a_row(sa + s, tb, av);
#pragma unroll
          for (int qq = 0; qq < TS; ++qq) {
            const float e = lps[s] * ls[qq], ek = e * ks[qq], er = e * rs[s];
            drt[s] = fmaf(ek, av[qq], drt[s]);
            dkt[qq] = fmaf(er, av[qq], dkt[qq]);
            bb[qq] = er * ks[qq];
          }
          b_row(bb, sa + s, tb);
        }
        float run = 0.f;   // dlambda, t in tau-tile bt: the pairs tau < t
#pragma unroll
        for (int qq = 0; qq < TS; ++qq) {
          dkp[(tb + qq) * D] += dkt[qq];
          if (qq) lamp[(tb + qq) * D] += run;
          run = fmaf(ks[qq], dkt[qq], run);
        }
        run = 0.f;         // t in sig-tile a: the pairs sig > t
#pragma unroll
        for (int s = TS - 1; s >= 0; --s) {
          if (s < TS - 1) lam_a[s] += run;
          run = fmaf(rs[s], drt[s], run);
        }
        for (int tt = tb + TS; tt < sa; ++tt) lamp[tt * D] += run;   // the tiles between
#pragma unroll
        for (int s = 0; s < TS; ++s) dr_acc[s] += drt[s];
        span *= tile_prod;
      }
#pragma unroll
      for (int s = 0; s < TS; ++s) {   // dr; r_sig E(sig-1, t0-1) (S0 do_sig) for dlambda
        const int sig = sa + s;
        const float xr = (pre_a * lp[s]) * s_xr[sig * XP + i];
        const float val = fmaf(ui * to_f32(s_k[sig * TP + i]), s_a[sig * AP + sig], xr + dr_acc[s]);
        if (sig < n) dr[base + static_cast<long long>(sig) * step + i] = from_f32<T>(val);
        s_xr[sig * XP + i] = rs[s] * xr;
        lamp[sig * D] += lam_a[s];
      }
    }
  }
  __syncthreads();

  // ---- dv = fmaf(bonus, do, K~ G_end + B^T do)
#pragma unroll
  for (int mi = 0; mi < MPW; ++mi) {
    const int m0 = (mrow + mi) * 16;
    mma3_rows<false, EX, C, NND>(
        xv[mi], m0, npart * NND * 8,
        [&](int tau, int sig) {
          float sb = 0.f;
          if (sig > tau) {
            sb = s_bp[sig * C + tau];
#pragma unroll
            for (int sg = 1; sg < L::WPG; ++sg) sb += s_bp[(sg * C + sig) * C + tau];
          }
          return sb;
        },
        stg(s_do, TP));
#pragma unroll
    for (int nt = 0; nt < NND; ++nt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int tau = m0 + g + 8 * hf, j = (npart * NND + nt) * 8 + 2 * t4;
        if (tau < n) {
          const float v0 = fmaf(s_bo[tau], to_f32(s_do[tau * TP + j]), xv[mi][nt][2 * hf]);
          const float v1 = fmaf(s_bo[tau], to_f32(s_do[tau * TP + j + 1]), xv[mi][nt][2 * hf + 1]);
          T* dst = dv + base + static_cast<long long>(tau) * step + j;
          dst[0] = from_f32<T>(v0);
          dst[1] = from_f32<T>(v1);
        }
      }
    }
  }

  // ---- dk, dlambda and du's partial, two threads a row: backwards, dk (and
  // k_tau E(t1-1, tau) (G_end v_tau) for dlambda) beside the suffix sums
  // over sig > t and du's partial; then forwards dlambda and dw, half the
  // steps a thread (the second half's prefix sum taken again in order)
  if (x < D) {
    const int i = x;
    const float ui = u[h * D + i];
    float suf = 1.f;
#pragma unroll
    for (int tt = C - 1; tt >= 0; --tt) {
      float dki = s_dkp[tt * D + i];
#pragma unroll
      for (int q = 1; q < NG; ++q) dki += s_dkp[(q * C + tt) * D + i];
      const float xk = suf * s_xk[tt * XP + i];
      const float val = fmaf(ui * to_f32(s_r[tt * TP + i]), s_a[tt * AP + tt], xk + dki);
      if (tt < n) dk[base + static_cast<long long>(tt) * step + i] = from_f32<T>(val);
      s_xk[tt * XP + i] = to_f32(s_k[tt * TP + i]) * xk;
      suf *= s_dec[tt * D + i];
    }
  } else if (x < 2 * D) {
    const int i = x - D;
    float s1 = 0.f;
#pragma unroll
    for (int tt = C - 1; tt >= 0; --tt) {
      const float l1 = s1;
      s1 += s_xr[tt * XP + i];
      s_xr[tt * XP + i] = l1;
    }
    float du_acc = 0.f;
#pragma unroll
    for (int tt = 0; tt < C; ++tt) {
      if (tt < n) {
        du_acc = fmaf(to_f32(s_r[tt * TP + i]) * to_f32(s_k[tt * TP + i]), s_a[tt * AP + tt],
                      du_acc);
      }
    }
    du_part[(static_cast<long long>(b) * nc + c) * step + h * D + i] = du_acc;
  }
  __syncthreads();
  if (x < 2 * D) {
    const int i = x % D, t_lo = x / D * (C / 2);
    const float tp = s_tot[i] * s_p[i];
    float s2 = 0.f;
    for (int tt = 0; tt < t_lo; ++tt) s2 += s_xk[tt * XP + i];
#pragma unroll
    for (int tt = t_lo; tt < t_lo + C / 2; ++tt) {
      float lam = (tp + s_xr[tt * XP + i]) + s2;
#pragma unroll
      for (int q = 0; q < NG; ++q) lam += s_lamp[(q * C + tt) * D + i];
      s2 += s_xk[tt * XP + i];
      if (tt < n) dw[base + static_cast<long long>(tt) * step + i] = -(s_ew[tt * D + i] * lam);
    }
  }
}

// du: the (batch, chunk) partials added in batch, then chunk order
__global__ void __launch_bounds__(256)
wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int batch, int nc,
                   int hd) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hd) return;
  float s = 0.f;
  for (int bb = 0; bb < batch; ++bb) {
    for (int c = 0; c < nc; ++c) s += du_part[(static_cast<long long>(bb) * nc + c) * hd + e];
  }
  du[e] = s;
}

template <typename T, int D>
int launch_wkv6_bwd(const WkvBwdArgs& a) {
  using L = WkvBwdLayout<T, D>;
  const int nc = (a.t + kWkvChunk - 1) / kWkvChunk;
  const unsigned bh = static_cast<unsigned>(a.b * a.h);
  wkv6_bwd_contrib_kernel<T, D><<<dim3(bh, nc), WkvContribLayout<D>::NT, 0, a.st>>>(
      static_cast<const T*>(a.r), static_cast<const float*>(a.w), static_cast<const T*>(a.dout),
      static_cast<float*>(a.gend), static_cast<float*>(a.tot), a.t, a.h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n4 = static_cast<long long>(bh) * D * D / 4;
  wkv6_bwd_scan_kernel<<<static_cast<unsigned>((n4 + kScanThreads - 1) / kScanThreads),
                         kScanThreads, 0, a.st>>>(
      static_cast<const float*>(a.dstate_out), static_cast<float*>(a.gend),
      static_cast<const float*>(a.tot), static_cast<float*>(a.dstate_in), nc, D, n4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_bwd_chunk_kernel<T, D><<<dim3(bh, nc), L::NT, L::SMEM, a.st>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.w), static_cast<const float*>(a.u),
      static_cast<const float*>(a.ckpt), static_cast<const float*>(a.gend),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dr), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), static_cast<float*>(a.dw), static_cast<float*>(a.du_part), a.t, a.h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int hd = a.h * D;
  wkv6_bwd_du_kernel<<<(hd + 255) / 256, 256, 0, a.st>>>(
      static_cast<const float*>(a.du_part), static_cast<float*>(a.du), a.b, nc, hd);
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
// f32.  Scratch the caller allocates, nc = ceil(t / kWkvChunk): gend (b, h,
// nc, d, d) f32 (each chunk's term of G's scan, then G at the end of every
// chunk), tot (b, h, nc, d) f32 (each chunk's whole decay) and du_part (b,
// nc, h, d) f32.  t >= 1; all contiguous.
int rt_wkv6_bwd(const void* r, const void* k, const void* v, const void* w, const void* u,
                const void* ckpt, const void* dout, const void* dstate_out, void* dstate_in,
                void* dr, void* dk, void* dv, void* dw, void* du, void* gend, void* tot,
                void* du_part, int b, int t, int h, int d, int bf16_inputs, void* stream) {
  if (b < 0 || t < 1 || h < 0 || static_cast<long long>(b) * h > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  const WkvBwdArgs a{r, k, v, w, u, ckpt, dout, dstate_out, dstate_in, dr, dk, dv, dw, du,
                     gend, tot, du_part, b, t, h, static_cast<cudaStream_t>(stream)};
  if (bf16_inputs) return dispatch_wkv6_bwd<bf16>(d, a);
  return dispatch_wkv6_bwd<float>(d, a);
}

}  // extern "C"
