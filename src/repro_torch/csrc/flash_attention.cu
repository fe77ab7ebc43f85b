// K3: forward flash attention for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_flash_kernel`): softmax
// attention with an online softmax (running max m, running sum l and the
// output accumulator kept in f32), logits scaled by 1/sqrt(hd), keys at or
// past `kv_len` masked, a top-left aligned causal mask (qpos >= kpos, both
// from 0, also when Sq != Sk), masked logits set to -1e30, the probabilities
// rounded to V's dtype before the P.V product, and out = acc / max(l, 1e-30).
// A row whose keys are all masked (kv_len == 0) therefore averages V, as the
// reference does.  Takes f32 or bf16; q, k, v and o are read and written
// through their strides, so the model's (B, S, H, hd) activations need no
// transposed copies.  GQA is native: query head h reads KV head h / G.
//
// What bounds it on an H100: at the granite-3-2b prefill shape (B 8, H 32,
// S 2048, hd 64, bf16, causal) the two products are 137 GFLOP against 168 MB
// of q, k, v and o, so it is bound by operations: 0.14 ms at the dense bf16
// tensor-core peak.  This kernel does its products as f32 FMAs on the CUDA
// cores (exact products of bf16 inputs, f32 sums), so it cannot approach that
// bound; tensor cores (mma.sync / wgmma) and TMA are later work.
//
// Design: one 128-thread block per (query block of 128 rows, head, batch),
// one query row per thread with its q row and its accumulator in registers.
// The block walks the key blocks in order, staging BK keys and values in
// shared memory as f32; every thread reads them as broadcast float4s.  Keys
// are scored 16 at a time, each group one online-softmax update.  The TPU
// kernel's sequential kv grid axis with VMEM scratch becomes this in-block
// loop.  Key blocks that the causal mask hides from every row of the block
// are never loaded (the Pallas kernel's `pl.when` skip), nor are blocks past
// kv_len; both contribute exactly 0 to a row that has a valid key.  When
// kv_len == 0 no row has one, and every key is visited, as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 128;  // query rows per block, one per thread
constexpr int SUB = 16;  // keys per online-softmax update
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the reference's `p.astype(v.dtype)`
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Strides {
  long long b, h, s, d;
};

template <typename T, int HD>
__global__ void __launch_bounds__(BQ)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int G, int Sq, int Sk,
              int kv_len, int causal, float scale, Strides sq, Strides sk,
              Strides sv, Strides so) {
  constexpr int BK = 64;  // keys staged per tile: both tiles fit in 32 KB at HD 64
  __shared__ __align__(16) float Ks[BK][HD];
  __shared__ __align__(16) float Vs[BK][HD];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row = q0 + threadIdx.x;
  const bool live_row = row < Sq;

  float qr[HD];
  {
    const T* qp = q + b * sq.b + h * sq.h + (long long)row * sq.s;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = live_row ? to_f32(qp[d * sq.d]) : 0.0f;
  }
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
  float m = NEG_INF;
  float l = 0.0f;

  // keys past k_end are masked for every row of the block and, since each
  // row has a valid key (key 0) when kv_len > 0, contribute exactly 0
  const bool any_valid = kv_len > 0;
  int k_end = any_valid ? kv_len : Sk;
  if (causal && any_valid) k_end = min(k_end, q0 + BQ);
  const int hk = h / G;
  const T* kp = k + b * sk.b + hk * sk.h;
  const T* vp = v + b * sv.b + hk * sv.h;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    const int nj = min(BK, k_end - k0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < BK * HD; e += BQ) {
      const int j = e / HD;
      const int d = e % HD;
      const long long key = k0 + j;
      const bool ok = j < nj;
      Ks[j][d] = ok ? to_f32(kp[key * sk.s + d * sk.d]) : 0.0f;
      Vs[j][d] = ok ? to_f32(vp[key * sv.s + d * sv.d]) : 0.0f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < nj; j0 += SUB) {
      // a group wholly past this row's diagonal adds exactly 0 to it
      if (causal && any_valid && k0 + j0 > row) break;
      float s[SUB];
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        const int key = k0 + j;
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][d]);
          dot = fmaf(qr[d], kk.x, dot);
          dot = fmaf(qr[d + 1], kk.y, dot);
          dot = fmaf(qr[d + 2], kk.z, dot);
          dot = fmaf(qr[d + 3], kk.w, dot);
        }
        const bool valid = key < kv_len && (!causal || key <= row);
        // a slot past the staged keys does not exist: -inf gives it p = 0
        s[jj] = j < nj ? (valid ? dot * scale : NEG_INF) : -INFINITY;
        mx = fmaxf(mx, s[jj]);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float pr = round_to<T>(p);
        const float* vrow = Vs[j0 + jj];
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vrow[d]);
          acc[d] = fmaf(pr, vv.x, acc[d]);
          acc[d + 1] = fmaf(pr, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(pr, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(pr, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (live_row) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    T* op = o + b * so.b + h * so.h + (long long)row * so.s;
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d * so.d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int G, int Sq, int Sk, int kv_len, int causal, const long long* st,
           cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides so{st[12], st[13], st[14], st[15]};
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_fwd<T, HD><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), G, Sq, Sk, kv_len, causal, scale, sq, sk, sv, so);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(int hd, const void* q, const void* k, const void* v, void* o, int B,
                int H, int G, int Sq, int Sk, int kv_len, int causal,
                const long long* st, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, G, Sq, Sk, kv_len, causal, st, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, G, Sq, Sk, kv_len, causal, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// o (B, H, Sq, hd) = attention of q (B, H, Sq, hd) over k, v (B, H / G, Sk, hd).
// `strides` holds 16 element strides: (b, h, s, d) of q, k, v and o in turn.
// dtype: 0 = float32, 1 = bfloat16; hd in {32, 64}; 0 <= kv_len <= Sk
// (Sk when every key is valid).  Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int H, int G,
                                     int Sq, int Sk, int hd, int kv_len, int causal,
                                     const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return by_head_dim<float>(hd, q, k, v, o, B, H, G, Sq, Sk, kv_len, causal,
                                strides, s);
    case 1:
      return by_head_dim<__nv_bfloat16>(hd, q, k, v, o, B, H, G, Sq, Sk, kv_len,
                                        causal, strides, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
