// K4b: the backward of the RWKV-6 WKV recurrence (K4) for Hopper.
//
// Replaces the reference's gradient of its chunked scan,
// `jax.lax.scan(jax.checkpoint(chunk_step))` in src/repro/models/rwkv.py
// (autodiff of `_wkv_step`; not a Pallas kernel).  Per (batch, head), with
// the f32 N x N state S [k-index, v-index] from S_{-1} = 0,
//     o_t = r_t^T (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// and G_t the gradient of S_t (the final state's gradient at t = S - 1, or
// 0), backwards in time:
//     dr_t = S_{t-1} do_t + u * k_t (v_t . do_t)
//     dk_t = G_t v_t + u * r_t (v_t . do_t)
//     dv_t = G_t^T k_t + do_t (sum_i r_ti u_i k_ti)
//     dw_t = rowsum(S_{t-1} * G_t)
//     du   = sum over b, t of r_t * k_t (v_t . do_t)
//     G_{t-1} = diag(w_t) G_t + r_t do_t^T.
// All f32.  No division by w (decays reach 0): the states S_{t-1} are
// recomputed forwards from checkpoints, never recovered backwards.
//
// What bounds it on an H100: at rwkv6-3b's training shape (B 8, H 40, S
// 2048, N 64) there are 2.684e9 state elements x steps.  Recomputing S is 3
// f32 operations an element and step, stepping G 3, and dr, dk, dv, dw 2
// each: 14, 37.6 GFLOP, 0.56 ms at 67 TFLOP/s.  It must read r, k, v, w and
// do and write dr, dk, dv and dw, 1.51 GB, 0.45 ms at 3.35 TB/s: operations
// bound it.  The recurrence is sequential in t; what runs in parallel is
// the B x H x N^2 state elements.
//
// Three launches, no atomics, so a second launch gives the same bits:
//   1. `ckpt`: one block a (b, h) re-runs the forward from S = 0 and writes
//      the state before every chunk of T = 8 steps to a scratch buffer,
//      B x H x ceil(S / T) x N x N f32 (1.34 GB at the training shape), each
//      chunk's as float4 [column float4][row], so that a warp's 32 rows are
//      one 512-byte store.
//   2. `main`: one block a (b, h) walks the chunks in reverse.  For each it
//      reloads the chunk's checkpoint, recomputes the chunk's T states
//      S_{t-1} into shared memory (T x N x N f32, 128 KB at N = 64), then
//      steps G backwards over the chunk, reading S_{t-1} back.  Thread
//      (row i, column segment) holds row i of G over C = 16 columns; a warp
//      is 32 rows of one segment.  Each element and step is independent
//      (S_ij and G_ij evolve alone); only the gradients' sums couple them.
//      dr, dk and dw sum over columns: a thread sums its C, writes its
//      partial for (step, row) to shared memory, and after the chunk one
//      thread a (step, row) adds the N / C segments' partials in order.  dv
//      sums over rows: the warp's 32 rows are reduced and scattered by
//      shuffles (5 rounds), and the N / 32 row groups' partials added in
//      order after the chunk.  du's per-(b, h) partial is kept by the
//      threads of segment 0, over t in reverse.
//   3. `du`: du[h, i] = the partials summed over b in order.
// The inputs are staged a chunk at a time into shared memory by 16-byte
// asynchronous copies (cp.async, two buffers: the next chunk's copies are in
// flight while one computes), so r, k, v, w and do need n-stride 1 and
// their other strides and bases on the 16-byte granule: the model's (B, S,
// H, N) views and contiguous tensors.  The wrapper (kernels/wkv6_bwd.py)
// copies any other layout first.  The gradients are written through their
// own strides.  A full chunk's steps are unrolled, so that the independent
// work of neighbouring steps interleaves.
//
// A simple first kernel: one block of N / C x N / 32 warps a (b, h), and at
// N = 64 the 181 KB of shared memory leave one block an SM (8 warps), so
// the 320 blocks of the training shape run in three waves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 8;   // steps a chunk (checkpoint spacing, shared-memory history)
constexpr int C = 16;  // state columns a thread
constexpr unsigned FULL = 0xffffffffu;

template <int N>
struct Shape {
  static constexpr int NSEG = N / C;      // column segments
  static constexpr int NRG = N / 32;      // row groups (one warp's lanes each)
  static constexpr int NT = 32 * NSEG * NRG;
  static_assert(N % 32 == 0 && N % C == 0, "head size");
};

struct Strides {
  long long b, h, s;  // element strides; the n-stride is 1
};

// Sums V values over the lanes that differ only in the lane bits M, M / 2,
// .., 1 (2M lanes), scattering: while a lane holds more than one value, a
// round keeps the half selected by its bit M (the upper half when it is set)
// and adds the partner's copy of that half; once one is left, the rounds
// add the partner's.  Lane l ends with value ((l % 2M) / (2M / V)), summed
// over the 2M lanes, in a[0].  (As in csrc/wkv6.cu.)
template <int V, int M>
__device__ __forceinline__ void reduce_scatter(float (&a)[V], int lane) {
  if constexpr (M >= 1) {
    if constexpr (V > 1) {
      constexpr int HV = V / 2;
      const bool hi = (lane & M) != 0;
      float kept[HV];
#pragma unroll
      for (int j = 0; j < HV; ++j) {
        const float send = hi ? a[j] : a[j + HV];
        const float keep = hi ? a[j + HV] : a[j];
        kept[j] = keep + __shfl_xor_sync(FULL, send, M);
      }
      reduce_scatter<HV, M / 2>(kept, lane);
      a[0] = kept[0];
    } else {
      a[0] += __shfl_xor_sync(FULL, a[0], M);
      reduce_scatter<1, M / 2>(a, lane);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m /= 2) x += __shfl_xor_sync(FULL, x, m);
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most the K most recent groups of this thread's copies are pending
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// starts copying steps [t0, t0 + nt) of a (B, H, S, N) tensor into
// dst[T][N], 16 bytes a copy, NT threads from `tid` (cp.async: the next
// chunk is in flight while this one computes)
template <int N, int NT>
__device__ __forceinline__ void stage(float* dst, const float* src, Strides st, int b, int h,
                                      int t0, int nt, int tid) {
  const float* base = src + b * st.b + h * st.h;
  for (int idx = tid; idx < nt * (N / 4); idx += NT) {
    const int d = idx / (N / 4);
    const int q = idx % (N / 4);
    cp_async16(dst + d * N + 4 * q, base + (long long)(t0 + d) * st.s + 4 * q);
  }
}

// pass 1: the state before each chunk, ckpt[b, h, c] = S_{c T - 1}
template <int N>
__global__ void __launch_bounds__(Shape<N>::NT)
    wkv6_bwd_ckpt(const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ w, Strides sk, Strides sv, Strides sw,
                  float* __restrict__ ckpt, int H, int S) {
  using Sh = Shape<N>;
  __shared__ __align__(16) float s_k[2][T][N];  // two buffers: chunk c and c + 1
  __shared__ __align__(16) float s_w[2][T][N];
  __shared__ __align__(16) float s_v[2][T][N];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i = 32 * (warp % Sh::NRG) + lane;  // this thread's state row
  const int c0 = C * (warp / Sh::NRG);         // its first column
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nch = (S + T - 1) / T;
  // the checkpoints' layout is this kernel's and the main pass's own: per
  // chunk, float4 [column float4][row], so a warp's store is 512 bytes in a row
  float4* out = reinterpret_cast<float4*>(ckpt) + ((long long)b * H + h) * nch * N * N / 4 +
                (c0 / 4) * N + i;

  // chunks 0 .. nch - 2 are run (full chunks: (c + 1) T < S); the last
  // chunk's states are the main pass's
  auto prefetch = [&](int c) {
    const int buf = c & 1;
    stage<N, Sh::NT>(&s_k[buf][0][0], k, sk, b, h, c * T, T, tid);
    stage<N, Sh::NT>(&s_w[buf][0][0], w, sw, b, h, c * T, T, tid);
    stage<N, Sh::NT>(&s_v[buf][0][0], v, sv, b, h, c * T, T, tid);
  };
  if (nch > 1) prefetch(0);
  cp_async_commit();
  float st[C];
#pragma unroll
  for (int j = 0; j < C; ++j) st[j] = 0.0f;
  for (int c = 0; c < nch; ++c) {
    float4* dst = out + (long long)c * N * N / 4;
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      dst[q * N] = make_float4(st[4 * q], st[4 * q + 1], st[4 * q + 2], st[4 * q + 3]);
    if (c == nch - 1) break;
    if (c + 1 < nch - 1) prefetch(c + 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c's copies
    __syncthreads();
    const int buf = c & 1;
#pragma unroll
    for (int d = 0; d < T; ++d) {
      const float ki = s_k[buf][d][i];
      const float wi = s_w[buf][d][i];
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 v4 = ld4(&s_v[buf][d][c0 + 4 * q]);
        st[4 * q] = fmaf(wi, st[4 * q], ki * v4.x);
        st[4 * q + 1] = fmaf(wi, st[4 * q + 1], ki * v4.y);
        st[4 * q + 2] = fmaf(wi, st[4 * q + 2], ki * v4.z);
        st[4 * q + 3] = fmaf(wi, st[4 * q + 3], ki * v4.w);
      }
    }
    __syncthreads();  // before chunk c + 2 is staged over this one
  }
}

// the main pass's shared memory, carved from the dynamic allocation
template <int N>
struct Smem {
  float4 hist[T][N / 4][N];                  // S_{t-1}: [step][column float4][row]
  float part[3][Shape<N>::NSEG][T][N];       // dr, dk, dw partials per segment
  float dvp[Shape<N>::NRG][T][N];            // dv partials per row group
  // the inputs, two buffers (the chunk computed and the next one in flight)
  alignas(16) float r[2][T][N];
  alignas(16) float k[2][T][N];
  alignas(16) float v[2][T][N];
  alignas(16) float w[2][T][N];
  alignas(16) float dout[2][T][N];
  float u[N];
  float vdo[T];    // v_t . do_t
  float bonus[T];  // sum_i r_ti u_i k_ti
};

// pass 2: the chunks in reverse, G stepped backwards through each
template <int N>
__global__ void __launch_bounds__(Shape<N>::NT, 1)
    wkv6_bwd_main(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ dout, Strides sr, Strides sk, Strides sv,
                  Strides sw, Strides sd, const float* __restrict__ u,
                  const float* __restrict__ dstate, const float* __restrict__ ckpt,
                  float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                  float* __restrict__ dw, Strides sg, float* __restrict__ du_part, int H,
                  int S) {
  using Sh = Shape<N>;
  constexpr int NW = Sh::NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int rg = warp % Sh::NRG;
  const int seg = warp / Sh::NRG;
  const int i = 32 * rg + lane;  // this thread's state row
  const int c0 = C * seg;        // its first column
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long bh = (long long)b * H + h;
  const int nch = (S + T - 1) / T;

  for (int idx = tid; idx < N; idx += Sh::NT) sm.u[idx] = u[h * N + idx];
  float g[C];  // G_t's row i, columns c0 ..
  if (dstate != nullptr) {
    const float* src = dstate + bh * N * N + i * N + c0;
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 x = ld4(src + 4 * q);
      g[4 * q] = x.x;
      g[4 * q + 1] = x.y;
      g[4 * q + 2] = x.z;
      g[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) g[j] = 0.0f;
  }
  float du_acc = 0.0f;  // segment 0: sum over t of r_ti k_ti (v_t . do_t)
  const long long gbase = b * sg.b + h * sg.h;

  // chunk c's inputs go to buffer (nch - 1 - c) & 1 by cp.async, and its
  // checkpoint row to registers, while chunk c + 1 computes
  auto prefetch = [&](int c, float4 (&ck)[C / 4]) {
    const int buf = (nch - 1 - c) & 1;
    const int t0 = c * T;
    const int nt = min(T, S - t0);
    stage<N, Sh::NT>(&sm.r[buf][0][0], r, sr, b, h, t0, nt, tid);
    stage<N, Sh::NT>(&sm.k[buf][0][0], k, sk, b, h, t0, nt, tid);
    stage<N, Sh::NT>(&sm.v[buf][0][0], v, sv, b, h, t0, nt, tid);
    stage<N, Sh::NT>(&sm.w[buf][0][0], w, sw, b, h, t0, nt, tid);
    stage<N, Sh::NT>(&sm.dout[buf][0][0], dout, sd, b, h, t0, nt, tid);
    const float4* src = reinterpret_cast<const float4*>(ckpt) + (bh * nch + c) * N * N / 4 +
                        (c0 / 4) * N + i;
#pragma unroll
    for (int q = 0; q < C / 4; ++q) ck[q] = src[q * N];
  };
  float4 ck[C / 4];
  prefetch(nch - 1, ck);
  cp_async_commit();

  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * T;
    const int nt = min(T, S - t0);
    const int buf = (nch - 1 - c) & 1;
    float st[C];  // the chunk's first S_{t-1}, from its checkpoint
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      st[4 * q] = ck[q].x;
      st[4 * q + 1] = ck[q].y;
      st[4 * q + 2] = ck[q].z;
      st[4 * q + 3] = ck[q].w;
    }
    if (c > 0) prefetch(c - 1, ck);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c's copies
    __syncthreads();

    // per step: v_t . do_t and the bonus sum, one warp a step
    for (int d = warp; d < nt; d += NW) {
      float a = 0.0f, e = 0.0f;
#pragma unroll
      for (int m = 0; m < N / 32; ++m) {
        const int j = lane + 32 * m;
        a = fmaf(sm.v[buf][d][j], sm.dout[buf][d][j], a);
        e = fmaf(sm.r[buf][d][j], sm.u[j] * sm.k[buf][d][j], e);
      }
      a = warp_sum(a);
      e = warp_sum(e);
      if (lane == 0) {
        sm.vdo[d] = a;
        sm.bonus[d] = e;
      }
    }

    // the chunk's states S_{t-1} into the history (this thread's own tile)
    auto fwd_step = [&](int d) {
#pragma unroll
      for (int q = 0; q < C / 4; ++q)
        sm.hist[d][c0 / 4 + q][i] =
            make_float4(st[4 * q], st[4 * q + 1], st[4 * q + 2], st[4 * q + 3]);
      const float ki = sm.k[buf][d][i];
      const float wi = sm.w[buf][d][i];
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 v4 = ld4(&sm.v[buf][d][c0 + 4 * q]);
        st[4 * q] = fmaf(wi, st[4 * q], ki * v4.x);
        st[4 * q + 1] = fmaf(wi, st[4 * q + 1], ki * v4.y);
        st[4 * q + 2] = fmaf(wi, st[4 * q + 2], ki * v4.z);
        st[4 * q + 3] = fmaf(wi, st[4 * q + 3], ki * v4.w);
      }
    };
    // a full chunk unrolled, so that independent steps' work interleaves
    if (nt == T) {
#pragma unroll
      for (int d = 0; d < T; ++d) fwd_step(d);
    } else {
      for (int d = 0; d < nt; ++d) fwd_step(d);
    }
    __syncthreads();  // vdo and bonus

    // backwards over the chunk: G holds G_t on entry to step t
    auto back_step = [&](int d) {
      const float ri = sm.r[buf][d][i];
      const float ki = sm.k[buf][d][i];
      const float wi = sm.w[buf][d][i];
      float pr = 0.0f, pk = 0.0f, pw = 0.0f;
      float dvq[C];
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 s4 = sm.hist[d][c0 / 4 + q][i];
        const float4 v4 = ld4(&sm.v[buf][d][c0 + 4 * q]);
        const float4 o4 = ld4(&sm.dout[buf][d][c0 + 4 * q]);
        const float se[4] = {s4.x, s4.y, s4.z, s4.w};
        const float ve[4] = {v4.x, v4.y, v4.z, v4.w};
        const float oe[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& gj = g[4 * q + e];
          pr = fmaf(se[e], oe[e], pr);
          pk = fmaf(gj, ve[e], pk);
          pw = fmaf(se[e], gj, pw);
          dvq[4 * q + e] = gj * ki;
          gj = fmaf(wi, gj, ri * oe[e]);  // G_{t-1}
        }
      }
      sm.part[0][seg][d][i] = pr;
      sm.part[1][seg][d][i] = pk;
      sm.part[2][seg][d][i] = pw;
      reduce_scatter<C, 16>(dvq, lane);  // lane l: column c0 + l / 2, summed over 32 rows
      if ((lane & 1) == 0) sm.dvp[rg][d][c0 + lane / 2] = dvq[0];
      if (seg == 0) du_acc = fmaf(ri * ki, sm.vdo[d], du_acc);
    };
    if (nt == T) {
#pragma unroll
      for (int d = T - 1; d >= 0; --d) back_step(d);
    } else {
      for (int d = nt - 1; d >= 0; --d) back_step(d);
    }
    __syncthreads();  // the partials

    // the chunk's gradients: the partials summed in a fixed order
    for (int idx = tid; idx < nt * N; idx += Sh::NT) {
      const int d = idx / N;
      const int n = idx % N;
      float sr_ = 0.0f, sk_ = 0.0f, sw_ = 0.0f, sv_ = 0.0f;
#pragma unroll
      for (int p = 0; p < Sh::NSEG; ++p) {
        sr_ += sm.part[0][p][d][n];
        sk_ += sm.part[1][p][d][n];
        sw_ += sm.part[2][p][d][n];
      }
#pragma unroll
      for (int p = 0; p < Sh::NRG; ++p) sv_ += sm.dvp[p][d][n];
      const float vdo = sm.vdo[d];
      const long long at = gbase + (long long)(t0 + d) * sg.s + n;
      dr[at] = fmaf(sm.u[n] * sm.k[buf][d][n], vdo, sr_);
      dk[at] = fmaf(sm.u[n] * sm.r[buf][d][n], vdo, sk_);
      dv[at] = fmaf(sm.dout[buf][d][n], sm.bonus[d], sv_);
      dw[at] = sw_;
    }
    __syncthreads();  // before chunk c - 2 is staged over this one
  }
  if (seg == 0) du_part[bh * N + i] = du_acc;
}

// pass 3: du[h, n] = sum over b, in order, of the (b, h) partials
__global__ void wkv6_bwd_du(const float* __restrict__ du_part, float* __restrict__ du, int B,
                            int HN) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= HN) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s += du_part[(long long)b * HN + idx];
  du[idx] = s;
}

// the dynamic shared memory above 48 KB, set once on each device for each
// specialisation (bit `slot` of a per-device mask)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int slot) {
  static unsigned long long set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (set[dev] >> slot & 1ull) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set[dev] |= 1ull << slot;
  return err;
}

Strides strides_at(const long long* st) { return Strides{st[0], st[1], st[2]}; }

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* dout, const float* dstate, float* ckpt, float* dr, float* dk,
           float* dv, float* dw, float* du_part, float* du, int B, int H, int S,
           const long long* st, cudaStream_t stream) {
  using Sh = Shape<N>;
  const Strides sr = strides_at(st), sk = strides_at(st + 4), sv = strides_at(st + 8),
                sw = strides_at(st + 12), sd = strides_at(st + 16), sg = strides_at(st + 20);
  const dim3 grid(H, B);
  wkv6_bwd_ckpt<N><<<grid, Sh::NT, 0, stream>>>(k, v, w, sk, sv, sw, ckpt, H, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = static_cast<int>(sizeof(Smem<N>));
  err = allow_smem(wkv6_bwd_main<N>, bytes, N == 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_main<N><<<grid, Sh::NT, bytes, stream>>>(r, k, v, w, dout, sr, sk, sv, sw, sd, u,
                                                     dstate, ckpt, dr, dk, dv, dw, sg,
                                                     du_part, H, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HN = H * N;
  wkv6_bwd_du<<<(HN + 255) / 256, 256, 0, stream>>>(du_part, du, B, HN);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const float*, const float*, const float*, const float*, const float*,
                         const float*, const float*, float*, float*, float*, float*, float*,
                         float*, float*, int, int, int, const long long*, cudaStream_t);

LaunchFn pick(int N) {
  switch (N) {
    case 32:
      return launch<32>;
    case 64:
      return launch<64>;
    default:
      return nullptr;
  }
}

}  // namespace

// r, k, v, w, dout: (B, H, S, N) f32 with the element strides strides[0..3],
// [4..7], [8..11], [12..15], [16..19] (b, h, s, n): n-stride 1, the other
// strides and the pointers on the 16-byte granule; u: (H, N) f32
// contiguous; dstate: (B, H, N, N) f32 contiguous, or NULL for a zero
// final-state gradient; ckpt: B x H x ceil(S / 8) x N x N f32 scratch;
// dr, dk, dv, dw: (B, H, S, N) f32 written through the strides
// strides[20..23]; du_part: B x H x N f32 scratch; du: (H, N) f32
// contiguous.  N in {32, 64}, S >= 1.  Launches the three passes on
// `stream` and returns a cudaError_t (0 when every launch was accepted).
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* dout, const void* dstate, void* ckpt,
                              void* dr, void* dk, void* dv, void* dw, void* du_part, void* du,
                              int B, int H, int S, int N, const long long* strides,
                              void* stream) {
  const LaunchFn fn = pick(N);
  if (fn == nullptr || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int t = 0; t < 5; ++t)
    if (strides[4 * t + 3] != 1) return static_cast<int>(cudaErrorInvalidValue);
  return fn(static_cast<const float*>(r), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(w),
            static_cast<const float*>(u), static_cast<const float*>(dout),
            static_cast<const float*>(dstate), static_cast<float*>(ckpt),
            static_cast<float*>(dr), static_cast<float*>(dk), static_cast<float*>(dv),
            static_cast<float*>(dw), static_cast<float*>(du_part), static_cast<float*>(du), B,
            H, S, strides, static_cast<cudaStream_t>(stream));
}

// N -> bytes of dynamic shared memory of the main pass (0 for an unbuilt N)
extern "C" int repro_wkv6_bwd_smem(int N) {
  switch (N) {
    case 32:
      return static_cast<int>(sizeof(Smem<32>));
    case 64:
      return static_cast<int>(sizeof(Smem<64>));
    default:
      return 0;
  }
}
