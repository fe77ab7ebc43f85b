// K2: the paper's MA kernel (and the serving `decode`) for Hopper.
//
// Replaces the Pallas TPU kernel `matadd` in src/repro/kernels/matadd.py
// (body `_add_kernel`): the elementwise C = A + B in the input dtype, for
// float32, bfloat16 and int32.  The result is bit-exact against a plain add:
// f32 and int32 add natively (int32 wraps), and bf16 adds in f32 and then
// rounds to nearest even, which gives the correctly rounded bf16 sum, as
// PyTorch's and XLA's CPU adds do.
//
// What bounds it on an H100: one FMA-free add per element against 3 x 4 bytes
// moved (f32), so it is bound by bytes: at the main path's 2048^2 f32 shape,
// 48 MiB over 3.35 TB/s is 15 us.  The card reaches its memory rate only with
// wide, coalesced accesses and enough of them in flight.
//
// Design: one pass over the flattened arrays.  Each thread moves 16 bytes of
// A and B per iteration (uint4: 4 f32 / 8 bf16 / 4 int32), neighbouring
// threads on neighbouring addresses, in a grid-stride loop; the < 16-byte tail
// is done element by element.  The TPU kernel's (bm, bn) VMEM blocks, whose
// sizes had to divide the shape, become a flat index space that takes any
// shape.  When a pointer is not 16-byte aligned the whole pass runs with
// scalar accesses instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1 << 20;

__device__ __forceinline__ float add1(float x, float y) { return x + y; }
__device__ __forceinline__ int add1(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));
}
__device__ __forceinline__ __nv_bfloat16 add1(__nv_bfloat16 x, __nv_bfloat16 y) {
  return __float2bfloat16_rn(__bfloat162float(x) + __bfloat162float(y));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    add_vec(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
            long long n) {
  constexpr int VEC = 16 / sizeof(T);
  const long long nvec = n / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4* c4 = reinterpret_cast<uint4*>(c);
  for (long long v = t0; v < nvec; v += stride) {
    uint4 x = a4[v];
    uint4 y = b4[v];
    uint4 z;
    const T* xs = reinterpret_cast<const T*>(&x);
    const T* ys = reinterpret_cast<const T*>(&y);
    T* zs = reinterpret_cast<T*>(&z);
#pragma unroll
    for (int i = 0; i < VEC; ++i) zs[i] = add1(xs[i], ys[i]);
    c4[v] = z;
  }
  for (long long i = nvec * VEC + t0; i < n; i += stride) c[i] = add1(a[i], b[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    add_scalar(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
               long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    c[i] = add1(a[i], b[i]);
}

template <typename T>
int launch(const void* a, const void* b, void* c, long long n, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c)) &
                        15) == 0;
  const long long work = aligned ? (n + VEC - 1) / VEC : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* pc = static_cast<T*>(c);
  if (aligned)
    add_vec<T><<<(unsigned)blocks, THREADS, 0, stream>>>(pa, pb, pc, n);
  else
    add_scalar<T><<<(unsigned)blocks, THREADS, 0, stream>>>(pa, pb, pc, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C = A + B over n contiguous elements.  dtype: 0 = float32, 1 = bfloat16,
// 2 = int32.  Launches on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).
extern "C" int repro_matadd(int dtype, const void* a, const void* b, void* c,
                            long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(a, b, c, n, s);
    case 1:
      return launch<__nv_bfloat16>(a, b, c, n, s);
    case 2:
      return launch<int>(a, b, c, n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
