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
// the B x H x N^2 state elements, and S_ij and G_ij each evolve alone: only
// the gradients' sums couple the elements (dr, dk, dw over columns j, dv
// over rows i).
//
// Three launches, no atomics, one owner for every sum, added in a fixed
// order, so a second launch gives the same bits:
//   1. `ckpt`: re-runs the forward from S = 0 and writes the state before
//      every segment of SEG = 64 steps, B x H x ceil(S / 64) x N x N f32
//      (168 MB at the training shape, an eighth of a checkpoint every 8
//      steps).  A block a 16-column slice of a (b, h), a thread a 2-row x
//      4-column tile; k, w and v by TMA in a ring of CK_SLOTS slots of TC
//      steps.
//   2. `main`: one block a (b, h), 16 warps at N = 64.  Thread (row i,
//      column segment) holds row i of S and of G over C = 8 columns in
//      registers; a warp is 32 rows of one segment.  The segments are walked
//      in reverse.  A segment is re-run forwards once from its checkpoint,
//      the state before each of its chunks of T = 8 steps kept in shared
//      memory (8 x 16 KB).  Then its chunks in reverse: each chunk's 8
//      states S_{t-1} are recomputed from its sub-checkpoint into registers
//      (64 a thread) and G is stepped backwards over them.  S is so computed
//      three times (pass 1, the segment, the chunk), 2 FP32 instructions an
//      element and step more than twice, for an eighth of the checkpoint
//      bytes and no history in shared memory.  dr, dk and dw sum over
//      columns: a thread's FMA chain over its 8, its partial for (step, row)
//      to shared memory, and after the chunk one thread a (step, row) adds
//      the N / 8 segments' partials in order.  dv sums over rows: the warp's
//      32 rows by a reduce-scatter (lane l ends with column c0 + l / 4), the
//      N / 32 row groups added in order after the chunk.  v_t . do_t and the
//      bonus sum_i r_ti u_i k_ti: one warp a step.  du's per-(b, h) partial
//      is kept by the threads of segment 0, over t in reverse.  Two block
//      barriers a chunk: the per-step sums, and the partials (the per-step
//      sums are double-buffered by chunk, so the next chunk starts without
//      one).
//   3. `du`: du[h, i] = the partials summed over b in order.
// The main pass's inputs come by TMA through rank-4 tensor maps over the
// (B, H, S, N) strides (as K4's, csrc/wkv6.cu): a chunk a slot in a ring of
// SLOTS, each slot completed on an mbarrier and freed by an mbarrier of the
// block's threads; one thread refills a slot as soon as every thread has
// released it, so the next chunk is in flight while one computes.  TMA
// fills steps past S with zeros, which are never computed.  So r, k, v, w
// and do need n-stride 1 with their other strides and bases on the 16-byte
// granule: the model's (B, S, H, N) views and contiguous tensors.  The wrapper
// (kernels/wkv6_bwd.py) copies any other layout first.  The gradients are
// written through their own strides.
//
// Occupancy: 205 KB of shared memory and 128 registers a thread give one
// 16-warp block an SM; the 320 blocks of the training shape take 3 waves
// of 132 (2.42 of work).
//
// Variants timed on the card and not kept (chip_smoke.py's time_wkv6_bwd on
// a copy of this file with the variant, at (8, 40, 2048, 64), whole / main
// pass; NVIDIA H100 80GB HBM3, 700 W):
//   - this kernel with the main pass's inputs staged by every thread's
//     cp.async (the kernel it replaced), a block barrier before each
//     chunk in place of the mbarriers: 5.01 / 4.65 with 2 slots, 4.99 /
//     4.61 with 3, against this kernel's 4.01 / 3.64 in the same call.
//     The five pointers and strides it needs push the main pass at N 64
//     over its 128 registers (72 bytes of spill), where the tensor maps
//     live in the parameter space;
// and five forms of a thread-block cluster of 4 blocks of 4 warps a (b, h),
// 16 columns and 12 warps an SM each, a thread a 2 x 4 tile with the
// chunk's states in registers, the row sums over the slices added in the
// owning block's shared memory through distributed shared memory:
//   - a block and a cluster barrier every 4 steps: 5.91 ms;
//   - the cluster barrier split (arrived after the pushes, waited after the
//     next 4 steps), v . do and the bonus moved to pass 1: 5.96 / 5.08;
//   - v . do and the bonus back, the owner's work over every warp: 6.57 /
//     6.20;
//   - the row sums and dv in the warp by shuffles, no block barrier, the
//     owner's rows written by bulk stores: 7.66 / 7.29;
//   - every thread's partials stored into the owner's shared memory by
//     st.async, completing on its mbarrier, no barrier at all: 10.60 /
//     10.23.
// A clock64 count in a copy of each showed the blocks waiting most of the
// time: at barriers, on the owner's data, or in latency chains between
// them, with 4 steps x 8 elements of a thread's work between two of them
// (this kernel: 8 steps x 8 elements; the kernel it replaced, with its
// chunk's states in shared memory: 8 x 16).  This kernel with a ring of 4
// slots (3 chunks in flight, for the segment's re-run, which computes
// little a chunk): 4.03 / 3.66, against 4.00 / 3.62 with 2.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int T = 8;          // steps a chunk: the register history
constexpr int SEG = 64;       // steps a segment: the checkpoint spacing
constexpr int NCH = SEG / T;  // chunks a segment: its sub-checkpoints
constexpr int W = 16;         // state columns a block of the checkpoint pass
constexpr int TC = 16;        // steps a ring slot of the checkpoint pass
constexpr int CK_SLOTS = 4;   // ring slots of the checkpoint pass
constexpr int SLOTS = 2;      // ring slots of the main pass (a chunk each)
constexpr unsigned FULL = 0xffffffffu;

// the checkpoint pass: a block a 16-column slice of one (b, h), a thread a
// 2-row x 4-column tile
template <int N>
struct Slice {
  static constexpr int CL = N / W;   // slices
  static constexpr int RP = N / 2;   // row pairs
  static constexpr int NT = 4 * RP;  // threads: RP row pairs x W / 4 column groups
  static_assert(N % 32 == 0, "head size");
};

// the main pass: a block a (b, h), a thread a row x C columns; a warp 32
// rows of one column segment
template <int N>
struct Block {
  static constexpr int C = 8;                  // state columns a thread
  static constexpr int NSEG = N / C;           // column segments
  static constexpr int NRG = N / 32;           // row groups (one warp's lanes each)
  static constexpr int NT = 32 * NSEG * NRG;   // 512 at N 64, 128 at N 32
  static_assert(N % 32 == 0, "head size");
};

struct Strides {
  long long b, h, s;  // element strides; the n-stride is 1
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m /= 2) x += __shfl_xor_sync(FULL, x, m);
  return x;
}

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

// one forward step S = diag(w_t) S + k_t v_t^T on a thread's tile: rows i0,
// i0 + 1 (k, w: the step's N rows) and columns jc .. jc + 3 (v: the slice's)
__device__ __forceinline__ void fwd_step(float (&x)[2][4], const float* k, const float* w,
                                         const float* v, int i0, int jc) {
  const float2 k2 = ld2(k + i0);
  const float2 w2 = ld2(w + i0);
  const float4 v4 = ld4(v + jc);
  const float ka[2] = {k2.x, k2.y};
  const float wa[2] = {w2.x, w2.y};
  const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[a][j] = fmaf(wa[a], x[a][j], ka[a] * vj[j]);
}

__device__ __forceinline__ float4 as4(const float (&x)[4]) {
  return make_float4(x[0], x[1], x[2], x[3]);
}

// the checkpoints' layout, this file's own: per (b, h, segment, column
// slice q) the slice's N x 16 state as float4 [column group][row of the
// pair][pair], so a warp's load or store of one row of its pairs is 512
// contiguous bytes
template <int N>
__device__ __forceinline__ float4* ckpt_tile(float* ckpt, long long bh, int nseg, int s, int q,
                                             int cg, int a, int rp) {
  using Sl = Slice<N>;
  return reinterpret_cast<float4*>(ckpt) + ((bh * nseg + s) * Sl::CL + q) * (N * W / 4) +
         (2 * cg + a) * Sl::RP + rp;
}

// ---- pass 1: the state before each segment ---------------------------------

template <int N>
struct CkptSmem {
  alignas(128) float k[CK_SLOTS][TC][N];
  alignas(128) float w[CK_SLOTS][TC][N];
  alignas(128) float v[CK_SLOTS][TC][W];
  uint64_t full[CK_SLOTS];
  uint64_t empty[CK_SLOTS];
};

// block (q, h, b) runs the forward on its slice's 16 columns, the main
// pass's thread tiles, and writes the state before every segment (the
// first's is zero)
template <int N>
__global__ void __launch_bounds__(Slice<N>::NT)
    wkv6_bwd_ckpt(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap vmap, float* __restrict__ ckpt, int H, int S) {
  using Sh = Slice<N>;
  constexpr uint32_t BYTES = TC * (2 * N + W) * sizeof(float);
  __shared__ CkptSmem<N> sm;
  const int q = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rp = tid % Sh::RP;
  const int cg = tid / Sh::RP;
  const int nseg = (S + SEG - 1) / SEG;
  const int n_entries = (nseg - 1) * (SEG / TC);  // steps 0 .. 64 (nseg - 1) - 1, all full

  auto issue = [&](int e) {  // one thread: steps [e TC, e TC + TC) into slot e % CK_SLOTS
    const int sl = e % CK_SLOTS;
    const uint32_t bar = smem_u32(&sm.full[sl]);
    mbar_expect_tx(bar, BYTES);
    tma_load_4d(smem_u32(&sm.k[sl][0][0]), &kmap, bar, 0, e * TC, h, b);
    tma_load_4d(smem_u32(&sm.w[sl][0][0]), &wmap, bar, 0, e * TC, h, b);
    tma_load_4d(smem_u32(&sm.v[sl][0][0]), &vmap, bar, W * q, e * TC, h, b);
  };
  if (tid == 0) {
    prefetch_tensormap(&kmap);
    prefetch_tensormap(&wmap);
    prefetch_tensormap(&vmap);
#pragma unroll
    for (int s = 0; s < CK_SLOTS; ++s) {
      mbar_init(smem_u32(&sm.full[s]), 1);
      mbar_init(smem_u32(&sm.empty[s]), Sh::NT);
    }
    mbar_init_fence();
    for (int e = 0; e < CK_SLOTS && e < n_entries; ++e) issue(e);
  }
  __syncthreads();

  const long long bh = (long long)b * H + h;
  float x[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[a][j] = 0.0f;
  auto store = [&](int s) {
#pragma unroll
    for (int a = 0; a < 2; ++a) *ckpt_tile<N>(ckpt, bh, nseg, s, q, cg, a, rp) = as4(x[a]);
  };
  store(0);
  for (int e = 0; e < n_entries; ++e) {
    const int sl = e % CK_SLOTS;
    if (tid == 0 && e >= 1 && e + CK_SLOTS - 1 < n_entries) {
      // the slot entry e - 1 used, once every thread is done with it
      mbar_wait(smem_u32(&sm.empty[(e - 1) % CK_SLOTS]), ((e - 1) / CK_SLOTS) & 1);
      issue(e + CK_SLOTS - 1);
    }
    mbar_wait(smem_u32(&sm.full[sl]), (e / CK_SLOTS) & 1);
#pragma unroll
    for (int d = 0; d < TC; ++d) fwd_step(x, sm.k[sl][d], sm.w[sl][d], sm.v[sl][d], 2 * rp, 4 * cg);
    mbar_arrive(smem_u32(&sm.empty[sl]));
    if ((e + 1) % (SEG / TC) == 0) store((e + 1) / (SEG / TC));
  }
}

// ---- pass 2: the segments and their chunks in reverse -----------------------

// the main pass's shared memory, carved from the dynamic allocation
template <int N>
struct MainSmem {
  using Bl = Block<N>;
  // the ring: a chunk's r, k, w, v, do (all N columns)
  alignas(128) float r[SLOTS][T][N];
  alignas(128) float k[SLOTS][T][N];
  alignas(128) float w[SLOTS][T][N];
  alignas(128) float v[SLOTS][T][N];
  alignas(128) float dout[SLOTS][T][N];
  // the segment's state before each chunk: [chunk][column float4][row]
  float4 sub[NCH][N / 4][N];
  float part[3][Bl::NSEG][T][N];  // dr's, dk's, dw's partials per column segment
  float dvp[Bl::NRG][T][N];       // dv's partials per row group
  float u[N];
  float vdo[2][T];    // v_t . do_t, by chunk parity
  float bonus[2][T];  // sum_i r_ti u_i k_ti, by chunk parity
  uint64_t full[SLOTS];   // the ring's slots: loaded
  uint64_t empty[SLOTS];  // the ring's slots: used by every thread
};

struct Entry {
  int t0;    // first step
  bool bwd;  // a chunk walked backwards (r, k, w, v, do), or one of a segment's re-run (k, w, v)
};

// the ring's e-th chunk: the segments from the last, each re-run forwards
// over its chunks but the last, then walked backwards over all of them
__device__ __forceinline__ Entry entry_at(int e, int S) {
  const int nseg = (S + SEG - 1) / SEG;
  const int nch_last = (S - (nseg - 1) * SEG + T - 1) / T;
  const int e_last = 2 * nch_last - 1;
  int s, idx, nch;
  if (e < e_last) {
    s = nseg - 1;
    idx = e;
    nch = nch_last;
  } else {
    const int e2 = e - e_last;
    s = nseg - 2 - e2 / (2 * NCH - 1);
    idx = e2 % (2 * NCH - 1);
    nch = NCH;
  }
  if (idx < nch - 1) return Entry{s * SEG + idx * T, false};
  return Entry{s * SEG + (2 * (nch - 1) - idx) * T, true};
}

// one forward step on a thread's row i x C columns: S = fma(w_i, S, k_i v_j)
template <int C>
__device__ __forceinline__ void row_step(float (&x)[C], float ki, float wi, const float* v) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 v4 = ld4(v + 4 * q);
    x[4 * q] = fmaf(wi, x[4 * q], ki * v4.x);
    x[4 * q + 1] = fmaf(wi, x[4 * q + 1], ki * v4.y);
    x[4 * q + 2] = fmaf(wi, x[4 * q + 2], ki * v4.z);
    x[4 * q + 3] = fmaf(wi, x[4 * q + 3], ki * v4.w);
  }
}

template <int N>
__global__ void __launch_bounds__(Block<N>::NT, 1)
    wkv6_bwd_main(const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap dmap, const float* __restrict__ u,
                  const float* __restrict__ dstate, const float* __restrict__ ckpt,
                  float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                  float* __restrict__ dw, Strides sg, float* __restrict__ du_part, int H, int S) {
  using Bl = Block<N>;
  constexpr int C = Bl::C;
  constexpr int NT = Bl::NT;
  constexpr int NW = NT / 32;
  constexpr uint32_t FWD_BYTES = T * 3 * N * sizeof(float);
  constexpr uint32_t BWD_BYTES = T * 5 * N * sizeof(float);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MainSmem<N>& sm = *reinterpret_cast<MainSmem<N>*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int rg = warp % Bl::NRG;
  const int seg = warp / Bl::NRG;
  const int i = 32 * rg + lane;  // this thread's state row
  const int c0 = C * seg;        // its first column
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long bh = (long long)b * H + h;
  const int nseg = (S + SEG - 1) / SEG;
  const int nch_last = (S - (nseg - 1) * SEG + T - 1) / T;
  const int n_entries = 2 * nch_last - 1 + (nseg - 1) * (2 * NCH - 1);

  auto issue = [&](int e) {  // one thread: the ring's e-th chunk into slot e % SLOTS
    const int sl = e % SLOTS;
    const Entry en = entry_at(e, S);
    const uint32_t bar = smem_u32(&sm.full[sl]);
    mbar_expect_tx(bar, en.bwd ? BWD_BYTES : FWD_BYTES);
    tma_load_4d(smem_u32(&sm.k[sl][0][0]), &kmap, bar, 0, en.t0, h, b);
    tma_load_4d(smem_u32(&sm.w[sl][0][0]), &wmap, bar, 0, en.t0, h, b);
    tma_load_4d(smem_u32(&sm.v[sl][0][0]), &vmap, bar, 0, en.t0, h, b);
    if (en.bwd) {
      tma_load_4d(smem_u32(&sm.r[sl][0][0]), &rmap, bar, 0, en.t0, h, b);
      tma_load_4d(smem_u32(&sm.dout[sl][0][0]), &dmap, bar, 0, en.t0, h, b);
    }
  };
  auto acquire = [&](int e) { mbar_wait(smem_u32(&sm.full[e % SLOTS]), (e / SLOTS) & 1); };
  // this thread is done with the ring's e-th chunk; once every thread is,
  // one thread refills its slot with chunk e + SLOTS (the ones between are
  // in flight)
  auto release = [&](int e) {
    mbar_arrive(smem_u32(&sm.empty[e % SLOTS]));
    if (tid == 0 && e + SLOTS < n_entries) {
      mbar_wait(smem_u32(&sm.empty[e % SLOTS]), (e / SLOTS) & 1);
      issue(e + SLOTS);
    }
  };
  if (tid == 0) {
    prefetch_tensormap(&rmap);
    prefetch_tensormap(&kmap);
    prefetch_tensormap(&wmap);
    prefetch_tensormap(&vmap);
    prefetch_tensormap(&dmap);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(smem_u32(&sm.full[s]), 1);
      mbar_init(smem_u32(&sm.empty[s]), NT);
    }
    mbar_init_fence();
    for (int e = 0; e < SLOTS && e < n_entries; ++e) issue(e);
  }
  for (int idx = tid; idx < N; idx += NT) sm.u[idx] = u[h * N + idx];
  __syncthreads();

  float g[C];  // G_t's row i, columns c0 ..
  if (dstate != nullptr) {
    const float* src = dstate + bh * N * N + (long long)i * N + c0;
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
  int e = 0;   // the ring's chunk
  int cb = 0;  // the parity of the chunks walked backwards so far

  for (int s = nseg - 1; s >= 0; --s) {
    const int t_seg = s * SEG;
    const int nch = (min(SEG, S - t_seg) + T - 1) / T;
    // the segment re-run forwards from its checkpoint (pass 1's tiles: the
    // 16-column slice c0 / 16, its column groups c0 % 16 / 4 and the next,
    // row i of pair i / 2); the state before each chunk kept in shared memory
    float x[C];
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const int col = c0 + 4 * q;
      const float4 c4 = *ckpt_tile<N>(const_cast<float*>(ckpt), bh, nseg, s, col / W,
                                      (col % W) / 4, i % 2, i / 2);
      x[4 * q] = c4.x;
      x[4 * q + 1] = c4.y;
      x[4 * q + 2] = c4.z;
      x[4 * q + 3] = c4.w;
      sm.sub[0][col / 4][i] = c4;
    }
    for (int c = 0; c + 1 < nch; ++c, ++e) {
      acquire(e);
      const int sl = e % SLOTS;
#pragma unroll
      for (int d = 0; d < T; ++d) row_step<C>(x, sm.k[sl][d][i], sm.w[sl][d][i], &sm.v[sl][d][c0]);
      release(e);
#pragma unroll
      for (int q = 0; q < C / 4; ++q)
        sm.sub[c + 1][c0 / 4 + q][i] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }

    for (int c = nch - 1; c >= 0; --c, ++e, cb ^= 1) {
      acquire(e);
      const int sl = e % SLOTS;
      const int t0 = t_seg + c * T;
      const int nt = min(T, S - t0);
      // per step: v_t . do_t and the bonus sum, one warp a step
      for (int d = warp; d < T; d += NW) {
        float a = 0.0f, bo = 0.0f;
#pragma unroll
        for (int m = 0; m < N / 32; ++m) {
          const int j = lane + 32 * m;
          a = fmaf(sm.v[sl][d][j], sm.dout[sl][d][j], a);
          bo = fmaf(sm.r[sl][d][j], sm.u[j] * sm.k[sl][d][j], bo);
        }
        a = warp_sum(a);
        bo = warp_sum(bo);
        if (lane == 0) {
          sm.vdo[cb][d] = a;
          sm.bonus[cb][d] = bo;
        }
      }
      // the chunk's states S_{t-1} into registers
      float hs[T][C];
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 c4 = sm.sub[c][c0 / 4 + q][i];
        hs[0][4 * q] = c4.x;
        hs[0][4 * q + 1] = c4.y;
        hs[0][4 * q + 2] = c4.z;
        hs[0][4 * q + 3] = c4.w;
      }
#pragma unroll
      for (int d = 1; d < T; ++d) {
        if (d < nt) {
#pragma unroll
          for (int j = 0; j < C; ++j) hs[d][j] = hs[d - 1][j];
          row_step<C>(hs[d], sm.k[sl][d - 1][i], sm.w[sl][d - 1][i], &sm.v[sl][d - 1][c0]);
        }
      }
      __syncthreads();  // vdo and bonus

      // backwards over the chunk: g holds G_t on entry to step t
#pragma unroll
      for (int d = T - 1; d >= 0; --d) {
        if (d >= nt) continue;
        const float ri = sm.r[sl][d][i];
        const float ki = sm.k[sl][d][i];
        const float wi = sm.w[sl][d][i];
        float pr = 0.0f, pk = 0.0f, pw = 0.0f;
        float dvq[C];
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 v4 = ld4(&sm.v[sl][d][c0 + 4 * q]);
          const float4 o4 = ld4(&sm.dout[sl][d][c0 + 4 * q]);
          const float ve[4] = {v4.x, v4.y, v4.z, v4.w};
          const float oe[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const int j = 4 * q + e4;
            pr = fmaf(hs[d][j], oe[e4], pr);
            pk = fmaf(g[j], ve[e4], pk);
            pw = fmaf(hs[d][j], g[j], pw);
            dvq[j] = g[j] * ki;
            g[j] = fmaf(wi, g[j], ri * oe[e4]);  // G_{t-1}
          }
        }
        sm.part[0][seg][d][i] = pr;
        sm.part[1][seg][d][i] = pk;
        sm.part[2][seg][d][i] = pw;
        reduce_scatter<C, 16>(dvq, lane);  // lane l: column c0 + l / 4, summed over 32 rows
        if ((lane & 3) == 0) sm.dvp[rg][d][c0 + lane / 4] = dvq[0];
        if (seg == 0) du_acc = fmaf(ri * ki, sm.vdo[cb][d], du_acc);
      }
      __syncthreads();  // the partials

      // the chunk's gradients: the partials summed in a fixed order
      for (int idx = tid; idx < nt * N; idx += NT) {
        const int d = idx / N;
        const int n = idx % N;
        float sr_ = 0.0f, sk_ = 0.0f, sw_ = 0.0f, sv_ = 0.0f;
#pragma unroll
        for (int p = 0; p < Bl::NSEG; ++p) {
          sr_ += sm.part[0][p][d][n];
          sk_ += sm.part[1][p][d][n];
          sw_ += sm.part[2][p][d][n];
        }
#pragma unroll
        for (int p = 0; p < Bl::NRG; ++p) sv_ += sm.dvp[p][d][n];
        const float vdo = sm.vdo[cb][d];
        const long long at = gbase + (long long)(t0 + d) * sg.s + n;
        dr[at] = fmaf(sm.u[n] * sm.k[sl][d][n], vdo, sr_);
        dk[at] = fmaf(sm.u[n] * sm.r[sl][d][n], vdo, sk_);
        dv[at] = fmaf(sm.dout[sl][d][n], sm.bonus[cb][d], sv_);
        dw[at] = sw_;
      }
      // part and dvp are next written after the next chunk's first barrier,
      // vdo and bonus in the other buffer: no barrier here
      release(e);
    }
  }
  if (seg == 0) du_part[bh * N + i] = du_acc;
}

// ---- pass 3: du -------------------------------------------------------------

// du[h, n] = sum over b, in order, of the (b, h) partials
__global__ void wkv6_bwd_du(const float* __restrict__ du_part, float* __restrict__ du, int B,
                            int HN) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= HN) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s += du_part[(long long)b * HN + idx];
  du[idx] = s;
}

// ---- host side --------------------------------------------------------------

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

// a rank-4 map over a (B, H, S, N) f32 view with element strides `st` (b,
// h, s, n; n == 1), boxes of `steps` steps by `cols` values
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int H, int S, int N,
              const long long* st, int cols, int steps) {
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 4, (cuuint64_t)st[1] * 4,
                                 (cuuint64_t)st[0] * 4};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)steps, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
                           strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS;
}

Strides strides_at(const long long* st) { return Strides{st[0], st[1], st[2]}; }

template <int N>
int main_smem_bytes() {
  return static_cast<int>(sizeof(MainSmem<N>));
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* dout, const float* dstate, float* ckpt, float* dr, float* dk, float* dv,
           float* dw, float* du_part, float* du, int B, int H, int S, const long long* st,
           cudaStream_t stream) {
  using Sl = Slice<N>;
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ck_k, ck_w, ck_v, rm, km, wm, vm, dm;
  const long long *sr = st, *sk = st + 4, *sv = st + 8, *sw = st + 12, *sd = st + 16;
  if (!make_map(enc, &ck_k, k, B, H, S, N, sk, N, TC) ||
      !make_map(enc, &ck_w, w, B, H, S, N, sw, N, TC) ||
      !make_map(enc, &ck_v, v, B, H, S, N, sv, W, TC) ||
      !make_map(enc, &rm, r, B, H, S, N, sr, N, T) || !make_map(enc, &km, k, B, H, S, N, sk, N, T) ||
      !make_map(enc, &wm, w, B, H, S, N, sw, N, T) || !make_map(enc, &vm, v, B, H, S, N, sv, N, T) ||
      !make_map(enc, &dm, dout, B, H, S, N, sd, N, T))
    return static_cast<int>(cudaErrorInvalidValue);
  wkv6_bwd_ckpt<N><<<dim3(Sl::CL, H, B), Sl::NT, 0, stream>>>(ck_k, ck_w, ck_v, ckpt, H, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = main_smem_bytes<N>();
  err = allow_smem(wkv6_bwd_main<N>, bytes, N == 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_main<N><<<dim3(H, B), Block<N>::NT, bytes, stream>>>(
      rm, km, wm, vm, dm, u, dstate, ckpt, dr, dk, dv, dw, strides_at(st + 20), du_part, H, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HN = H * N;
  wkv6_bwd_du<<<(HN + 255) / 256, 256, 0, stream>>>(du_part, du, B, HN);
  return static_cast<int>(cudaGetLastError());
}

// what the occupancy calculator gives a pass: out[0] dynamic shared memory,
// out[1] threads a block, out[2] resident blocks an SM
template <int N>
int info(int which, int* out) {
  int blocks = 0;
  cudaError_t err;
  if (which == 0) {
    out[0] = 0;
    out[1] = Slice<N>::NT;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_bwd_ckpt<N>, out[1], 0);
  } else {
    out[0] = main_smem_bytes<N>();
    out[1] = Block<N>::NT;
    err = allow_smem(wkv6_bwd_main<N>, out[0], N == 64);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_bwd_main<N>, out[1],
                                                          out[0]);
  }
  out[2] = blocks;
  return static_cast<int>(err);
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
// strides and the pointers on the 16-byte granule (TMA's); u: (H, N) f32
// contiguous; dstate: (B, H, N, N) f32 contiguous, or NULL for a zero
// final-state gradient; ckpt: B x H x ceil(S / 64) x N x N f32 scratch;
// dr, dk, dv, dw: (B, H, S, N) f32 written through the strides
// strides[20..23], n-stride 1 and the other strides multiples of 4;
// du_part: B x H x N f32 scratch; du: (H, N) f32 contiguous.  N in {32,
// 64}, S >= 1.  Launches the three passes on `stream` and returns a
// cudaError_t (0 when every launch was accepted).
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* dout, const void* dstate, void* ckpt,
                              void* dr, void* dk, void* dv, void* dw, void* du_part, void* du,
                              int B, int H, int S, int N, const long long* strides,
                              void* stream) {
  const LaunchFn fn = pick(N);
  if (fn == nullptr || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int t = 0; t < 6; ++t)
    if (strides[4 * t + 3] != 1) return static_cast<int>(cudaErrorInvalidValue);
  return fn(static_cast<const float*>(r), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(w),
            static_cast<const float*>(u), static_cast<const float*>(dout),
            static_cast<const float*>(dstate), static_cast<float*>(ckpt),
            static_cast<float*>(dr), static_cast<float*>(dk), static_cast<float*>(dv),
            static_cast<float*>(dw), static_cast<float*>(du_part), static_cast<float*>(du), B,
            H, S, strides, static_cast<cudaStream_t>(stream));
}

// N, which (0: the checkpoint pass, 1: the main pass) -> out[0] bytes of
// dynamic shared memory, out[1] threads a block, out[2] resident blocks an SM
// (the occupancy calculator's, on the current device); returns a
// cudaError_t (cudaErrorInvalidValue for an unbuilt N)
extern "C" int repro_wkv6_bwd_info(int N, int which, int* out) {
  switch (N) {
    case 32:
      return info<32>(which, out);
    case 64:
      return info<64>(which, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
