// K3b: backward flash attention for Hopper, on the CUDA cores.
//
// Replaces the reference's `fusedkernel_flash_bwd` region
// (src/repro/models/layers.py, the backward of `_flash_attend_core`, its
// `jax.custom_vjp`): FlashAttention-2's backward in linear memory, with P
// recomputed from the log-sum-exp rows the forward (K3) wrote.  The
// reference has no Pallas kernel for it; the comment above its
// `fusedkernel_` regions names them the regions the Pallas kernels
// implement.  Per (query row, key) pair the mask keeps:
//   P  = exp(s * scale - lse)           (s = q . k; masked s = -1e30)
//   dP = dO . v
//   dS = P (dP - delta) * scale         (delta = rowsum(dO * O))
//   dq += dS k,  dk += dS q,  dv += P dO
// In bf16, P and dS are rounded to bf16 before their products, as the
// reference's `.astype` calls round them; every sum is f32.  The masks are
// K3's: a top-left causal mask (qpos >= kpos, also when Sq != Sk), keys at
// or past `kv_len` masked; blocks past them are skipped only when
// kv_len > 0 (then each row has a valid key and a skipped pair adds exactly
// 0), so a row whose keys are all masked is computed as the reference does.
// GQA is native: query head h reads KV head h / G.
//
// Three launches, no atomics: every sum has one owner, so the result is the
// same bits run after run.
//   1. `bwd_delta`: delta (B, H, Sq), one warp a row.
//   2. `bwd_dq`: a block owns 64 query rows of one (batch, head) and loops
//      over the key tiles of 64 they see.
//   3. `bwd_dkdv`: a block owns 64 keys of one (batch, KV head) and loops
//      over the G query heads of its group and every query tile of 64 that
//      sees them.
// Each block stages its tiles in shared memory as f32 rows (head dim + 4
// floats, so float4 reads of 16 consecutive rows fall on distinct banks).
// Its 256 threads each compute a 4 x 4 piece of the 64 x 64 S and dP tiles
// (rows ty + 16 i, columns tx + 16 j, float4 reads along the head dim),
// write P and dS to shared memory, and then each accumulate 4 rows by
// hd / 16 columns of dq (or of dk and dv) in registers.  Reads go through
// the callers' strides, so any layout is read in place.
//
// What bounds it on an H100: at granite-3-2b's training shape (B 8, H 32
// over 8 KV heads, S 2048, hd 64, bf16, causal) the backward's five products
// are 10 hd operations per kept pair, 344 GFLOP: 0.35 ms at the dense bf16
// tensor-core peak of 989 TFLOP/s, against ~0.2 GB of inputs and outputs.
// These kernels run seven products (S and dP are computed in both passes)
// on the CUDA cores, whose f32 peak is 67 TFLOP/s: this simple design is at
// least 7 ms there.  Head dims 32, 64 and 128 are built; the wrapper
// zero-pads others up to the next one and passes the scale of its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr int BR = 64;             // query rows (dq) or keys (dk/dv) a block owns
constexpr int BC = 64;             // keys (dq) or query rows (dk/dv) per inner tile
constexpr int THREADS = 256;       // 16 x 16, each a 4 x 4 piece of a 64 x 64 tile
constexpr int PAD = 4;             // floats past the end of each shared row
constexpr int LDT = BC + PAD;      // row length of the P and dS tiles

struct Strides {
  long long b, h, s, d;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back (the reference's `.astype(dtype)` before a product)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// rows [row0, row0 + BR) of one head of `src` into `dst` (BR rows of HD + PAD
// floats), zeros past `limit`
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss, long long sd,
                                          int row0, int limit) {
  constexpr int LD = HD + PAD;
  for (int e = threadIdx.x; e < BR * HD; e += THREADS) {
    const int r = e / HD;
    const int d = e % HD;
    const int row = row0 + r;
    dst[r * LD + d] = row < limit ? to_f(src[(long long)row * ss + (long long)d * sd]) : 0.0f;
  }
}

// acc[i][j] = A[ty + 16 i] . Bm[tx + 16 j] over the head dim
template <int HD>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A, const float* Bm,
                                         int ty, int tx) {
  constexpr int LD = HD + PAD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4];
    float4 b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][c] += sum_r W[r][ty * 4 + i] * X[r][tx * CW + c] over the BC rows r
// of W (P or dS, LDT floats a row) and X (a staged tile)
template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[4][HD / 16], const float* W,
                                           const float* X, int ty, int tx) {
  constexpr int LD = HD + PAD;
  constexpr int CW = HD / 16;
#pragma unroll 4
  for (int r = 0; r < BC; ++r) {
    const float4 w = *reinterpret_cast<const float4*>(&W[r * LDT + ty * 4]);
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < CW; c += 2) {
      const float2 x = *reinterpret_cast<const float2*>(&X[r * LD + tx * CW + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][c] = fmaf(wv[i], x.x, acc[i][c]);
        acc[i][c + 1] = fmaf(wv[i], x.y, acc[i][c + 1]);
      }
    }
  }
}

template <int HD>
constexpr int smem_dq() {
  return (4 * BR * (HD + PAD) + BC * LDT) * 4;
}
template <int HD>
constexpr int smem_dkdv() {
  return (4 * BR * (HD + PAD) + 2 * BC * LDT + 2 * BC) * 4;
}

// delta[b, h, row] = sum_d dO * O, one warp a row
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
              int H, int Sq, int hd, long long rows, Strides so, Strides sdo) {
  const long long r = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int row = (int)(r % Sq);
  const long long bh = r / Sq;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const T* op = o + b * so.b + h * so.h + row * so.s;
  const T* dp = dout + b * sdo.b + h * sdo.h + row * sdo.s;
  float sum = 0.0f;
  for (int d = lane; d < hd; d += 32) sum = fmaf(to_f(op[d * so.d]), to_f(dp[d * sdo.d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[r] = sum;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int H, G, Sq, Sk, kv_len, causal;
  float scale;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
};

// P and dS of pair (row, key) from the raw dots s and dp
__device__ __forceinline__ void pair_grads(float s, float dp, int row, int key, float lse,
                                           float delta, const Args& a, float& p, float& ds) {
  if (row >= a.Sq || key >= a.Sk) {  // a slot past the staged rows or keys
    p = 0.0f;
    ds = 0.0f;
    return;
  }
  const bool valid = key < a.kv_len && (!a.causal || key <= row);
  p = expf((valid ? s * a.scale : NEG_INF) - lse);
  ds = p * (dp - delta) * a.scale;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) bwd_dq(const Args a) {
  constexpr int LD = HD + PAD;
  constexpr int CW = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BR * LD;
  float* Ks = dOs + BR * LD;
  float* Vs = Ks + BC * LD;
  float* dSt = Vs + BC * LD;  // [key][row]

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int hk = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // the most keys first
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h;
  load_tile<T, HD>(Qs, q, a.sq.s, a.sq.d, q0, a.Sq);
  load_tile<T, HD>(dOs, dout, a.sdo.s, a.sdo.d, q0, a.Sq);

  float lse[4], delta[4];
  const long long rbase = ((long long)b * a.H + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse[i] = row < a.Sq ? a.lse[rbase + row] : 0.0f;
    delta[i] = row < a.Sq ? a.delta[rbase + row] : 0.0f;
  }
  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;
  }

  const bool any_valid = a.kv_len > 0;
  int k_end = any_valid ? a.kv_len : a.Sk;
  if (a.causal && any_valid) k_end = min(k_end, q0 + BR);
  for (int k0 = 0; k0 < k_end; k0 += BC) {
    __syncthreads();  // the previous tile is consumed (and Q, dO are staged)
    load_tile<T, HD>(Ks, k, a.sk.s, a.sk.d, k0, a.Sk);
    load_tile<T, HD>(Vs, v, a.sv.s, a.sv.d, k0, a.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<HD>(s, Qs, Ks, ty, tx);
    dot_tile<HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p, ds;
        pair_grads(s[i][j], dp[i][j], q0 + ty + 16 * i, k0 + tx + 16 * j, lse[i], delta[i], a,
                   p, ds);
        dSt[(tx + 16 * j) * LDT + ty + 16 * i] = round_to<T>(ds);
      }
    }
    __syncthreads();
    accumulate<HD>(acc, dSt, Ks, ty, tx);
  }

  T* dq = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < a.Sq) {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        dq[(long long)row * a.sdq.s + (long long)(tx * CW + c) * a.sdq.d] = from_f<T>(acc[i][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) bwd_dkdv(const Args a) {
  constexpr int LD = HD + PAD;
  constexpr int CW = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BR * LD;
  float* Qs = Vs + BR * LD;
  float* dOs = Qs + BC * LD;
  float* Ps = dOs + BC * LD;    // [row][key]
  float* dSs = Ps + BC * LDT;   // [row][key]
  float* lse_s = dSs + BC * LDT;
  float* delta_s = lse_s + BC;

  const int KV = a.H / a.G;
  const int b = blockIdx.x / KV;
  const int hk = blockIdx.x % KV;
  const int k0 = blockIdx.y * BR;  // the most query tiles first when causal
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  load_tile<T, HD>(Ks, static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h, a.sk.s, a.sk.d,
                   k0, a.Sk);
  load_tile<T, HD>(Vs, static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h, a.sv.s, a.sv.d,
                   k0, a.Sk);
  float dk[4][CW], dv[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < CW; ++c) dk[i][c] = dv[i][c] = 0.0f;
  }

  const bool any_valid = a.kv_len > 0;
  // with a valid key in every row, keys at or past kv_len get nothing, and
  // under the causal mask rows before k0 see none of these keys
  const bool none = any_valid && k0 >= a.kv_len;
  const int first = (a.causal && any_valid) ? (k0 / BC) * BC : 0;
  for (int g = 0; g < a.G && !none; ++g) {
    const int h = hk * a.G + g;
    const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
    const T* dout = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
    const long long rbase = ((long long)b * a.H + h) * a.Sq;
    for (int q0 = first; q0 < a.Sq; q0 += BC) {
      __syncthreads();  // the previous tile is consumed
      load_tile<T, HD>(Qs, q, a.sq.s, a.sq.d, q0, a.Sq);
      load_tile<T, HD>(dOs, dout, a.sdo.s, a.sdo.d, q0, a.Sq);
      if (threadIdx.x < BC) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.Sq ? a.lse[rbase + row] : 0.0f;
        delta_s[threadIdx.x] = row < a.Sq ? a.delta[rbase + row] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile<HD>(s, Ks, Qs, ty, tx);   // S^T: keys ty + 16 i, rows tx + 16 j
      dot_tile<HD>(dp, Vs, dOs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          float p, ds;
          pair_grads(s[i][j], dp[i][j], q0 + r, k0 + ty + 16 * i, lse_s[r], delta_s[r], a, p,
                     ds);
          Ps[r * LDT + ty + 16 * i] = round_to<T>(p);
          dSs[r * LDT + ty + 16 * i] = round_to<T>(ds);
        }
      }
      __syncthreads();
      accumulate<HD>(dv, Ps, dOs, ty, tx);
      accumulate<HD>(dk, dSs, Qs, ty, tx);
    }
  }

  T* dkp = static_cast<T*>(a.dk) + b * a.sdk.b + hk * a.sdk.h;
  T* dvp = static_cast<T*>(a.dv) + b * a.sdv.b + hk * a.sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key < a.Sk) {
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const long long d = tx * CW + c;
        dkp[(long long)key * a.sdk.s + d * a.sdk.d] = from_f<T>(dk[i][c]);
        dvp[(long long)key * a.sdv.s + d * a.sdv.d] = from_f<T>(dv[i][c]);
      }
    }
  }
}

// the dynamic shared memory above 48 KB, set once on each device for each
// kernel (bit `slot` of a per-device mask)
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

template <typename T, int HD>
int launch(const Args& a, int B, int slot, cudaStream_t stream) {
  cudaError_t err = allow_smem(bwd_dq<T, HD>, smem_dq<HD>(), 2 * slot);
  if (err == cudaSuccess) err = allow_smem(bwd_dkdv<T, HD>, smem_dkdv<HD>(), 2 * slot + 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq<T, HD><<<dim3(B * a.H, (a.Sq + BR - 1) / BR), THREADS, smem_dq<HD>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv<T, HD>
      <<<dim3(B * (a.H / a.G), (a.Sk + BR - 1) / BR), THREADS, smem_dkdv<HD>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const Args& a, const void* o, Strides so, float* delta, int B, int hd, int slot,
        cudaStream_t stream) {
  const long long rows = (long long)B * a.H * a.Sq;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  bwd_delta<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(a.dout), delta, a.H, a.Sq, hd, rows, so,
      a.sdo);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (hd) {
    case 32:
      return launch<T, 32>(a, B, slot, stream);
    case 64:
      return launch<T, 64>(a, B, slot + 1, stream);
    case 128:
      return launch<T, 128>(a, B, slot + 2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dq (B, H, Sq, hd), dk and dv (B, H / G, Sk, hd) of attention of q over k, v
// (B, H / G, Sk, hd), given its output o, the output's gradient dout (both
// (B, H, Sq, hd)) and the forward's log-sum-exp rows `lse`, a contiguous
// (B, H, Sq) float32 buffer; `delta` is a scratch buffer of that shape.
// `strides` holds 32 element strides: (b, h, s, d) of q, k, v, o, dout, dq,
// dk and dv in turn.  dtype: 0 = float32, 1 = bfloat16 (all eight tensors);
// hd in {32, 64, 128}; 0 <= kv_len <= Sk; (Sq + 63) / 64 and (Sk + 63) / 64
// below 65536.  `scale` is the forward's.  Launches on `stream` and returns
// a cudaError_t (0 when every launch was accepted).
extern "C" int repro_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* delta, void* dq, void* dk, void* dv, int B,
                                         int H, int G, int Sq, int Sk, int hd, int kv_len,
                                         int causal, float scale, const long long* st,
                                         void* stream) {
  auto strides = [&](int i) { return Strides{st[4 * i], st[4 * i + 1], st[4 * i + 2], st[4 * i + 3]}; };
  const Args a{q,  k,  v,      dout,   lse,       delta,      dq,         dk,         dv,
               H,  G,  Sq,     Sk,     kv_len,    causal,     scale,      strides(0), strides(1),
               strides(2), strides(4), strides(5), strides(6), strides(7)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(a, o, strides(3), delta, B, hd, 0, s);
  if (dtype == 1) return run<__nv_bfloat16>(a, o, strides(3), delta, B, hd, 3, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bytes of dynamic shared memory a block of the dq and of the dk/dv kernel
// takes at head dim hd (-1 for a head dim that is not built)
extern "C" int repro_flash_attention_bwd_smem(int which, int hd) {
  switch (hd) {
    case 32:
      return which == 0 ? smem_dq<32>() : smem_dkdv<32>();
    case 64:
      return which == 0 ? smem_dq<64>() : smem_dkdv<64>();
    case 128:
      return which == 0 ? smem_dq<128>() : smem_dkdv<128>();
    default:
      return -1;
  }
}
