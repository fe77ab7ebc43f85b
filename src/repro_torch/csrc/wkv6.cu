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
// S 2048, N 64) it reads r, k, v, w and writes o, 839 MB, and does 7 f32
// operations per state element per step, 18.8 GFLOP without tensor cores:
// 0.25 ms at 3.35 TB/s against 0.28 ms at 67 TFLOP/s, so it is bound by
// operations, barely.  The recurrence is sequential in t, so what the card
// can run in parallel is B x H x N^2 state elements, not B x H heads.
//
// Design: column n of the state evolves on its own (o_t[n] and S[:, n] need
// only S[:, n], v_t[n] and the whole of r_t, k_t, w_t).  So a block owns one
// (b, h) and CB = 32 columns; each column is shared by SPLIT = 4
// neighbouring threads, each holding N / 4 rows of it in registers, and o_t[n]
// is summed over the four with two warp shuffles.  At N = 64 that is 640
// blocks of 128 threads for the 320 heads.  The block stages TC = 32 steps
// of r, k, w (all rows) and v (its columns) in shared memory per pass, so it
// synchronises twice per 32 steps; a thread's rows interleave with its
// neighbours' (row = i * 4 + part) so the four lanes of a column read four
// consecutive words, free of bank conflicts.  The TPU kernel's per-head VMEM
// state and `fori_loop` over time become per-thread registers and the staged
// time loop.

#include <cuda_runtime.h>

namespace {

constexpr int SPLIT = 4;  // threads per state column

struct Strides {
  long long b, h, s, n;
};

template <int N>
__global__ void __launch_bounds__(32 * SPLIT)
    wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, float* __restrict__ o,
             float* __restrict__ state, int H, int S, Strides si, Strides so) {
  constexpr int CB = 32;               // columns per block
  constexpr int RN = N / SPLIT;        // rows per thread
  constexpr int THREADS = CB * SPLIT;
  constexpr int TC = 32;               // time steps staged per pass
  __shared__ float rs[TC][N];
  __shared__ float ks[TC][N];
  __shared__ float ws[TC][N];
  __shared__ float vs[TC][CB];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int c0 = blockIdx.x * CB;
  const int tid = threadIdx.x;
  const int col = tid / SPLIT;
  const int part = tid % SPLIT;

  const long long base = b * si.b + h * si.h;
  float st[RN];
  float ur[RN];
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    st[i] = 0.0f;
    ur[i] = u[h * N + i * SPLIT + part];
  }
  float* op = o + b * so.b + h * so.h + (long long)(c0 + col) * so.n;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int nt = min(TC, S - t0);
    __syncthreads();  // the previous pass is consumed
    for (int e = tid; e < TC * N; e += THREADS) {
      const int t = e / N;
      const int n = e % N;
      const long long at = base + (long long)(t0 + t) * si.s + n * si.n;
      const bool ok = t < nt;
      rs[t][n] = ok ? r[at] : 0.0f;
      ks[t][n] = ok ? k[at] : 0.0f;
      ws[t][n] = ok ? w[at] : 0.0f;
    }
    for (int e = tid; e < TC * CB; e += THREADS) {
      const int t = e / CB;
      const int c = e % CB;
      vs[t][c] = t < nt ? v[base + (long long)(t0 + t) * si.s + (c0 + c) * si.n] : 0.0f;
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float vv = vs[t][col];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        const int row = i * SPLIT + part;
        const float kv = ks[t][row] * vv;
        acc = fmaf(rs[t][row], fmaf(ur[i], kv, st[i]), acc);
        st[i] = fmaf(ws[t][row], st[i], kv);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) op[(long long)(t0 + t) * so.s] = acc;
    }
  }

  float* sp = state + ((long long)b * H + h) * N * N + c0 + col;
#pragma unroll
  for (int i = 0; i < RN; ++i) sp[(long long)(i * SPLIT + part) * N] = st[i];
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* o, float* state, int B, int H, int S,
           const long long* st, cudaStream_t stream) {
  const dim3 grid(N / 32, H, B);
  const Strides si{st[0], st[1], st[2], st[3]};
  const Strides so{st[4], st[5], st[6], st[7]};
  wkv6_fwd<N><<<grid, 32 * SPLIT, 0, stream>>>(r, k, v, w, u, o, state, H, S, si, so);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w: (B, H, S, N) f32 sharing the element strides strides[0..3]
// (b, h, s, n); u: (H, N) f32 contiguous; o: (B, H, S, N) f32 with the
// strides strides[4..7]; state: (B, H, N, N) f32 contiguous, written with the
// final state.  N in {32, 64}.  Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, void* o, void* state, int B, int H, int S,
                          int N, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* of = static_cast<float*>(o);
  float* sf = static_cast<float*>(state);
  switch (N) {
    case 32:
      return launch<32>(rf, kf, vf, wf, uf, of, sf, B, H, S, strides, s);
    case 64:
      return launch<64>(rf, kf, vf, wf, uf, of, sf, B, H, S, strides, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
