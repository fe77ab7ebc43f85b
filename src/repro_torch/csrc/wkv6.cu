// K4: the RWKV-6 WKV recurrence for Hopper.
//
// Replaces the Pallas TPU kernel `wkv6` in src/repro/kernels/wkv6.py (body
// `_wkv_kernel`).  Per (batch, head), over the S time steps in order, from a
// zero f32 N x N state S [k-index, v-index]:
//     o_t = r_t^T (S + (u * k_t) v_t^T),   S <- diag(w_t) S + k_t v_t^T.
// Takes f32 r, k, v, w of shape (B, H, S, N) through their strides (the
// model's (B, S, H, N) activations need no copies) and u (H, N); writes o and
// the final state, which the reference recomputes on the host.
//
// What bounds it on an H100: at the rwkv6-3b prefill shape (B 8, H 40,
// S 2048, N 64) it must read r, k, v, w and write o and the final state,
// 844 MB, 0.2520 ms at 3.35 TB/s.  Its least arithmetic is 5 f32 operations
// per state element and step once the bonus term is factored out,
//     o_t[j] = sum_i r_i S_ij + v_j (sum_i r_i u_i k_i),
// 13.6 GFLOP, 0.204 ms at 67 TFLOP/s: bytes bound it.  On the CUDA cores a
// step is 3 instructions per state element (kv = k_i v_j, S_ij = fma(w_i,
// S_ij, kv), acc_j = fma(r_i, S_ij, acc_j)): 8.05e9 instructions, 0.240 ms
// at the 33.5e12 FP32 instructions/s the 67 TFLOP/s stand for, just under
// the byte bound.  So the kernel is bound by instruction issue, and its
// design spends as few issue slots as it can beside those FP32 ones.  The
// recurrence is sequential in t, so what the card can run in parallel is
// B x H x N^2 state elements, not B x H heads.
//
// The kernel reads r, k, v and w by TMA, so it takes N-stride 1 with the
// other strides and the bases 16-byte aligned: the model's views and
// contiguous tensors.  The wrapper (kernels/wkv6.py) copies any other layout
// into fresh (B, S, H, N) buffers first.
//
// Column j of the state evolves on its own (o_t[j] and S[:, j] need only
// S[:, j], v_t[j] and the whole of r_t, k_t, w_t), so one warp, a block of its own, owns NC = 32 columns of
// one (b, h): 640 warps at the prefill shape, independent of each other.
// Lane (cg, rg) holds a 16 x 4 register tile of the state at N = 64 (8 x 4
// at N = 32): C = 4 adjacent columns, and the rows of float4 chunks q G + rg
// of the G = 4 lanes that share those columns, so those G lanes read G
// adjacent float4s of r, k and w and every column group reads the same ones
// (one shared-memory wavefront, each value serving 4 columns).  The G
// partial sums of o_t are reduced and scattered by shuffles (2 rounds, each
// halving the values a lane holds), leaving each lane o_t of one column.
//   A full chunk advances two steps at once:
//     S_t+2 = (w_t w_t+1) S_t + (k_t w_t+1) v_t^T + k_t+1 v_t+1^T,
//     o_t+1 = (r_t+1 w_t)^T S_t + c v_t + bonus,  c = sum_i r_t+1,i k_t,i,
// 5 instructions per state element for the two steps (2.5 a step, an issue
// floor of 0.200 ms) and two independent sums per column, which a single
// warp issues faster.  Products of decays only, no division, so decays down
// to 0 are exact.  A chunk pass first computes, per chunk of TC = 16 steps,
// the bonus sums b_t = sum_i r_i u_i k_i, the pairs' c and their row
// products r_t+1 w_t, w_t w_t+1, k_t w_t+1 into shared memory (N / 4 lanes
// a pair of steps, reduced by shuffles); each column then adds v_t[j] b_t
// (and v_t[j] c) to its reduced sum by FMAs.  The ragged last chunk goes
// one step at a time.
//   Lane 0 keeps a ring of STAGES = 2 slots, each TC steps of r, k, w (all N
// rows) and v (the warp's columns), filled by TMA through rank-4 tensor maps
// over the (B, H, S, N) strides and completed on an mbarrier per slot; TMA
// fills steps past S with zeros, which are never computed.  A slot is
// refilled as soon as its chunk is consumed, so the next chunk is in flight
// while one computes; five such warps fit an SM's shared memory.  o is
// staged per chunk in shared memory (two buffers) and written by one TMA
// store per chunk; the final state once, as float4 rows.  r, k and w are
// read by both warps of a head at N = 64; L2 serves the second read (a
// variant whose loads all hit one chunk, so L2, timed the same).  The pair
// loop is not unrolled: with the chunk unrolled, the kernel ran slower, more
// so with longer chunks.
//   What holds it: the 640 warps land on 528 warp schedulers, so 112 of them
// run two warps, and those set the time; a lone warp issues at well under
// one instruction a cycle.  Variants timed on the card and not kept: one
// block of two warps a head sharing one ring, column blocks of 16 (1280
// warps), rows split over two warps, 8 x 8 lane tiles, partial sums of o
// reduced through shared memory, one step at a time, shorter chunks and
// more stages.
//
// The TPU kernel's per-head VMEM state and `fori_loop` over time become
// per-thread registers and the staged time loop.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace ring {

using namespace hopper;

constexpr int NC = 32;          // state columns per warp (one warp a block)
constexpr int C = 4;            // columns per lane (one float4 of v)
constexpr int G = 32 * C / NC;  // lanes sharing a column, each with N / G rows
constexpr int TC = 16;          // time steps per ring slot
constexpr int STAGES = 2;       // ring slots
constexpr unsigned FULL = 0xffffffffu;
static_assert(G == C, "the reduce-scatter of C sums over G lanes leaves one a lane");

template <int N>
struct Smem {
  alignas(128) float r[STAGES][TC][N];
  alignas(128) float k[STAGES][TC][N];
  alignas(128) float w[STAGES][TC][N];
  alignas(128) float v[STAGES][TC][NC];
  alignas(128) float o[2][TC][NC];
  // per pair of steps (t, t + 1) = (2 m, 2 m + 1) of the chunk: r_{t+1} w_t,
  // w_t w_{t+1} and k_t w_{t+1}, and c_m = sum_i r_{t+1,i} k_{t,i}
  alignas(16) float rw[TC / 2][N];
  alignas(16) float ww[TC / 2][N];
  alignas(16) float kw[TC / 2][N];
  float c[TC / 2];
  float b[TC];
  uint64_t full[STAGES];
};

// Sums V values over the lanes that differ only in the lane bits M, M / 2,
// .., 1 (2M lanes), scattering: while a lane holds more than one value, a
// round keeps the half selected by its bit M (the upper half when it is set)
// and adds the partner's copy of that half; once one is left, the rounds
// add the partner's.  Lane l ends with value ((l % 2M) / (2M / V)), summed
// over the 2M lanes, in a[0].
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int N>
__global__ void __launch_bounds__(32)
    wkv6_ring(const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap omap, const float* __restrict__ u,
              float* __restrict__ state, int H, int S) {
  constexpr int R = N / G;       // state rows per lane
  constexpr int Q = R / 4;       // float4 row chunks per lane
  constexpr int L = N / 4;       // lanes per pair of steps in the chunk pass
  constexpr int P = 32 / L;      // pairs per pass of the chunk pass
  constexpr int M = TC / 2 / P;  // pairs per lane in the chunk pass
  constexpr uint32_t SLOT_BYTES = TC * (3 * N + NC) * sizeof(float);
  static_assert(Q >= 1 && M >= 1 && 2 * M <= L && NC <= N && TC % 2 == 0, "tile shape");
  __shared__ Smem<N> sm;

  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * NC;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rg = lane % G;  // row group: float4 row chunks q G + rg
  const int cg = lane / G;  // column group: columns c0 + cg * C + [0, C);
                            // the reduced o_t is column cg * C + rg = lane
  const int nchunks = (S + TC - 1) / TC;

  auto fill = [&](int p) {  // lane 0: chunk p into its slot
    const int s = p % STAGES;
    const uint32_t bar = smem_u32(&sm.full[s]);
    mbar_expect_tx(bar, SLOT_BYTES);
    const int t0 = p * TC;
    tma_load_4d(smem_u32(&sm.r[s][0][0]), &rmap, bar, 0, t0, h, b);
    tma_load_4d(smem_u32(&sm.k[s][0][0]), &kmap, bar, 0, t0, h, b);
    tma_load_4d(smem_u32(&sm.w[s][0][0]), &wmap, bar, 0, t0, h, b);
    tma_load_4d(smem_u32(&sm.v[s][0][0]), &vmap, bar, c0, t0, h, b);
  };
  if (lane == 0) {
    prefetch_tensormap(&rmap);
    prefetch_tensormap(&kmap);
    prefetch_tensormap(&vmap);
    prefetch_tensormap(&wmap);
    prefetch_tensormap(&omap);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&sm.full[s]), 1);
    mbar_init_fence();
    for (int p = 0; p < STAGES && p < nchunks; ++p) fill(p);
  }
  __syncwarp();

  // u of the chunk pass's float4 (lane % L), and the state tile
  const int bf = lane % L;
  const float* uh = u + h * N + 4 * bf;
  const float4 u4 = make_float4(uh[0], uh[1], uh[2], uh[3]);
  float st[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) st[i][j] = 0.0f;

  for (int p = 0; p < nchunks; ++p) {
    const int s = p % STAGES;
    const int ob = p & 1;
    const int nt = min(TC, S - p * TC);
    if (lane == 0) bulk_wait_read<1>();  // o[ob]'s store of chunk p - 2 has read it
    mbar_wait(smem_u32(&sm.full[s]), (p / STAGES) & 1);

    // the chunk pass: b_t = sum_i r_ti u_i k_ti for the chunk's steps, and
    // each pair's products and c_m.  Lane l takes float4 f = l % L of pairs
    // l / L + P m; its partial sums over the float4 are then reduced over the
    // L lanes of a pair
    {
      float bp[2 * M], cp[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int pr = lane / L + P * m;
        const int t = 2 * pr;
        const float4 r0 = ld4(&sm.r[s][t][4 * bf]);
        const float4 k0 = ld4(&sm.k[s][t][4 * bf]);
        const float4 w0 = ld4(&sm.w[s][t][4 * bf]);
        const float4 r1 = ld4(&sm.r[s][t + 1][4 * bf]);
        const float4 k1 = ld4(&sm.k[s][t + 1][4 * bf]);
        const float4 w1 = ld4(&sm.w[s][t + 1][4 * bf]);
        bp[2 * m] = fmaf(r0.w, u4.w * k0.w,
                         fmaf(r0.z, u4.z * k0.z, fmaf(r0.y, u4.y * k0.y, r0.x * (u4.x * k0.x))));
        bp[2 * m + 1] =
            fmaf(r1.w, u4.w * k1.w,
                 fmaf(r1.z, u4.z * k1.z, fmaf(r1.y, u4.y * k1.y, r1.x * (u4.x * k1.x))));
        cp[m] = fmaf(r1.w, k0.w, fmaf(r1.z, k0.z, fmaf(r1.y, k0.y, r1.x * k0.x)));
        *reinterpret_cast<float4*>(&sm.rw[pr][4 * bf]) =
            make_float4(r1.x * w0.x, r1.y * w0.y, r1.z * w0.z, r1.w * w0.w);
        *reinterpret_cast<float4*>(&sm.ww[pr][4 * bf]) =
            make_float4(w0.x * w1.x, w0.y * w1.y, w0.z * w1.z, w0.w * w1.w);
        *reinterpret_cast<float4*>(&sm.kw[pr][4 * bf]) =
            make_float4(k0.x * w1.x, k0.y * w1.y, k0.z * w1.z, k0.w * w1.w);
      }
      reduce_scatter<2 * M, L / 2>(bp, lane);
      reduce_scatter<M, L / 2>(cp, lane);
      if (bf % (L / (2 * M)) == 0) {
        const int j = bf / (L / (2 * M));  // = 2 m + (second step of the pair)
        sm.b[2 * (lane / L + P * (j / 2)) + j % 2] = bp[0];
      }
      if (bf % (L / M) == 0) sm.c[lane / L + P * (bf / (L / M))] = cp[0];
    }
    __syncwarp();

    // two steps at once: S_t+2 = w_t w_t+1 S_t + (k_t w_t+1) v_t^T + k_t+1 v_t+1^T
    // (5 instructions per state element for the two steps), o_t from r_t S_t
    // and o_t+1 from (r_t+1 w_t) S_t + c v_t, each with its bonus v b
    auto pair = [&](int pr) {
      const int t = 2 * pr;
      const float4 v04 = ld4(&sm.v[s][t][cg * C]);
      const float4 v14 = ld4(&sm.v[s][t + 1][cg * C]);
      const float v0[C] = {v04.x, v04.y, v04.z, v04.w};
      const float v1[C] = {v14.x, v14.y, v14.z, v14.w};
      float acc0[C], acc1[C];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int f = 4 * (q * G + rg);  // first of the four rows
        const float4 r4 = ld4(&sm.r[s][t][f]);
        const float4 a4 = ld4(&sm.rw[pr][f]);
        const float4 k4 = ld4(&sm.k[s][t + 1][f]);
        const float4 e4 = ld4(&sm.kw[pr][f]);
        const float4 d4 = ld4(&sm.ww[pr][f]);
        const float re[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ae[4] = {a4.x, a4.y, a4.z, a4.w};
        const float ke[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ee[4] = {e4.x, e4.y, e4.z, e4.w};
        const float de[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < C; ++j) {
            float& x = st[4 * q + e][j];
            const bool first = q == 0 && e == 0;
            acc0[j] = first ? re[e] * x : fmaf(re[e], x, acc0[j]);
            acc1[j] = first ? ae[e] * x : fmaf(ae[e], x, acc1[j]);
            x = fmaf(de[e], x, fmaf(ee[e], v0[j], ke[e] * v1[j]));
          }
        }
      }
      reduce_scatter<C, G / 2>(acc0, lane);
      reduce_scatter<C, G / 2>(acc1, lane);
      const float vc0 = sm.v[s][t][lane];
      sm.o[ob][t][lane] = fmaf(vc0, sm.b[t], acc0[0]);
      sm.o[ob][t + 1][lane] =
          fmaf(sm.v[s][t + 1][lane], sm.b[t + 1], fmaf(vc0, sm.c[pr], acc1[0]));
    };

    // one step (the ragged last chunk): S_t+1 = w_t S_t + k_t v_t^T
    auto step = [&](int t) {
      const float* rt = sm.r[s][t];
      const float* kt = sm.k[s][t];
      const float* wt = sm.w[s][t];
      const float4 v4 = ld4(&sm.v[s][t][cg * C]);
      const float vv[C] = {v4.x, v4.y, v4.z, v4.w};
      float acc[C];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int f = 4 * (q * G + rg);  // first of the four rows
        const float4 r4 = ld4(rt + f);
        const float4 k4 = ld4(kt + f);
        const float4 w4 = ld4(wt + f);
        const float re[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ke[4] = {k4.x, k4.y, k4.z, k4.w};
        const float we[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < C; ++j) {
            float& x = st[4 * q + e][j];
            acc[j] = (q == 0 && e == 0) ? re[e] * x : fmaf(re[e], x, acc[j]);
            x = fmaf(we[e], x, ke[e] * vv[j]);
          }
        }
      }
      reduce_scatter<C, G / 2>(acc, lane);
      sm.o[ob][t][lane] = fmaf(sm.v[s][t][lane], sm.b[t], acc[0]);
    };
    if (nt == TC) {  // a loop, not unrolled: the unrolled chunk ran slower
#pragma unroll 1
      for (int pr = 0; pr < TC / 2; ++pr) pair(pr);
    } else {
      for (int t = 0; t < nt; ++t) step(t);
    }

    fence_proxy_async();  // this lane's o stores, before the TMA store reads them
    __syncwarp();         // every lane is done with slot s and o[ob]
    if (lane == 0) {
      if (p + STAGES < nchunks) fill(p + STAGES);
      tma_store_4d(&omap, smem_u32(&sm.o[ob][0][0]), c0, p * TC, h, b);
      bulk_commit();
    }
  }

  float* sp = state + ((long long)b * H + h) * N * N + c0 + cg * C;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(sp + (long long)(4 * (q * G + rg) + e) * N) =
          make_float4(st[4 * q + e][0], st[4 * q + e][1], st[4 * q + e][2], st[4 * q + e][3]);
  if (lane == 0) bulk_wait_read<0>();  // the o stores have read o before the block exits
}

// a rank-4 map over a (B, H, S, N) f32 view with element strides `st`
// (b, h, s, n; n == 1), boxes of TC steps by `cols` values
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int H, int S, int N,
              const long long* st, int cols) {
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 4, (cuuint64_t)st[1] * 4,
                                 (cuuint64_t)st[0] * 4};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)TC, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
                           strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS;
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* o, float* state, int B, int H, int S, const long long* st,
           cudaStream_t stream) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap rm, km, vm, wm, om;
  if (!make_map(enc, &rm, r, B, H, S, N, st, N) || !make_map(enc, &km, k, B, H, S, N, st, N) ||
      !make_map(enc, &vm, v, B, H, S, N, st, NC) || !make_map(enc, &wm, w, B, H, S, N, st, N) ||
      !make_map(enc, &om, o, B, H, S, N, st + 4, NC))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / NC, H, B);
  wkv6_ring<N><<<grid, 32, 0, stream>>>(rm, km, vm, wm, om, u, state, H, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ring

using LaunchFn = int (*)(const float*, const float*, const float*, const float*, const float*,
                         float*, float*, int, int, int, const long long*, cudaStream_t);

LaunchFn pick(int N) {
  switch (N) {
    case 32:
      return ring::launch<32>;
    case 64:
      return ring::launch<64>;
    default:
      return nullptr;
  }
}

}  // namespace

// r, k, v, w: (B, H, S, N) f32 sharing the element strides strides[0..3]
// (b, h, s, n) with n-stride 1, the other strides and the pointers 16-byte
// aligned (TMA's granule); u: (H, N) f32 contiguous; o: (B, H, S, N) f32 with the strides
// strides[4..7]; state: (B, H, N, N) f32 contiguous, written with the final
// state.  N in {32, 64}.  Launches on `stream` and returns a cudaError_t (0
// when the launch was accepted).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, void* o, void* state, int B, int H, int S, int N,
                          const long long* strides, void* stream) {
  const LaunchFn fn = pick(N);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(static_cast<const float*>(r), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(w),
            static_cast<const float*>(u), static_cast<float*>(o), static_cast<float*>(state), B,
            H, S, strides, static_cast<cudaStream_t>(stream));
}
