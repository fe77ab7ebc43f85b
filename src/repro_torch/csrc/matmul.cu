// K1: the paper's MM kernel (and the serving `prefill`) for Hopper.
//
// Replaces the Pallas TPU kernel `matmul` in src/repro/kernels/matmul.py
// (body `_mm_kernel`): C = A @ B with an f32 accumulator, cast to A's dtype
// once at the end.  Takes f32 or bf16 inputs; the sum is always IEEE f32 FMA
// (no TF32, no tensor cores), so f32 output matches a plain f32 product.
//
// What bounds it on an H100: at the main path's 2048^3 f32 shape the product
// is 17.2 GFLOP against 48 MiB of operands, so it is bound by operations: the
// non-tensor f32 peak (67 TFLOP/s on the SXM part) gives 0.26 ms.  The card
// only approaches that peak when every FMA's operands come from registers.
//
// Design: each 256-thread block owns a 128x128 tile of C and walks K in
// steps of 8.  A step stages an 8x128 slice of A and of B in shared memory
// (converted to f32 on load, stored k-major so the inner loop reads both as
// float4), and each thread then does 8x8 register FMAs per k from 8 values of
// A and 8 of B: 64 FMAs per 16 shared loads.  The TPU kernel's sequential K
// grid axis with a VMEM accumulator becomes the in-block K loop with the
// accumulator in registers.
//
// A and B are read through their strides, so the serving `prefill` operand
// x.T (a transposed view) costs no copy: the staging loop lets neighbouring
// threads walk whichever dimension has unit stride, which keeps global loads
// coalesced for either layout.  Ragged edges are masked (zero-filled loads,
// skipped stores) instead of padding each dimension to 128 as the TPU
// wrapper does.  No wgmma or TMA yet: a simple kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps the k-major shared stores free of bank conflicts

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    mm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
              int M, int N, int K, long long sam, long long sak, long long sbk,
              long long sbn) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN);  // row group of this thread's 8x8 micro-tile
  const int tc = tid % (BN / TN);  // column group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // which dimension neighbouring threads walk while staging (unit stride)
  const bool a_k_fast = (sak == 1);
  const bool b_n_fast = (sbn == 1) || (sbk != 1);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int mm = a_k_fast ? e / BK : e % BM;
      const int kk = a_k_fast ? e % BK : e / BM;
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K)
                       ? to_f32(A[(long long)gm * sam + (long long)gk * sak])
                       : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (BN * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int nn = b_n_fast ? e % BN : e / BK;
      const int kk = b_n_fast ? e / BN : e % BK;
      const int gn = n0 + nn;
      const int gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K)
                       ? to_f32(B[(long long)gk * sbk + (long long)gn * sbn])
                       : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tr * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][tr * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tc * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tc * TN + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tr * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tc * TN + j;
      if (gn < N) C[(long long)gm * N + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           long long sam, long long sak, long long sbk, long long sbn,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), M, N,
      K, sam, sak, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C (M x N, contiguous, A's dtype) = A (M x K, strides sam/sak) @ B (K x N,
// strides sbk/sbn).  dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int repro_matmul(int dtype, const void* a, const void* b, void* c, int M,
                            int N, int K, long long sam, long long sak,
                            long long sbk, long long sbn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
    case 1:
      return launch<__nv_bfloat16>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
