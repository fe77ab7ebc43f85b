// K2: the paper's MA kernel (and the serving `decode`) for Hopper.
//
// Replaces the Pallas TPU kernel `matadd` in src/repro/kernels/matadd.py
// (body `_add_kernel`): the elementwise C = A + B in the input dtype, for
// float32, bfloat16 and int32.  The result is bit-exact against a plain add:
// f32 and int32 add natively (int32 wraps), and bf16 adds in f32 and then
// rounds to nearest even, which gives the correctly rounded bf16 sum, as
// PyTorch's and XLA's CPU adds do.
//
// What bounds it on an H100: one add per element against 3 x 4 bytes moved
// (f32), so it is bound by bytes: at the main path's 2048^2 f32 shape, 48 MiB
// over 3.35 TB/s is 15 us.  The card reaches its memory rate only with wide,
// coalesced accesses and enough of them in flight on every SM.
//
// Design: one streaming pass over the flattened arrays.  The index space is
// cut into chunks of THREADS x UNROLL 16-byte vectors (4 f32 / 8 bf16 / 4
// int32 each); a chunk's thread starts its UNROLL loads of A and of B, all
// independent, before the first add, neighbouring threads on neighbouring
// vectors.  The grid is as many blocks as the SMs hold at once (occupancy
// query), capped at the chunk count, and walks the chunks.  Inputs are
// read through the non-coherent path without allocating in L1 and the
// output is stored with the streaming (evict-first) hint, so the pass does
// not push out of L2 what the next kernel reads.  The < 16-byte tail is
// done element by element.  The TPU kernel's (bm, bn) VMEM blocks, whose
// sizes had to divide the shape, become a flat index space that takes any
// shape.  When a pointer is not 16-byte aligned the whole pass runs with
// scalar accesses instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // 16-byte loads of each input in flight per thread

__device__ __forceinline__ float add1(float x, float y) { return x + y; }
__device__ __forceinline__ int add1(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));
}
__device__ __forceinline__ __nv_bfloat16 add1(__nv_bfloat16 x, __nv_bfloat16 y) {
  return __float2bfloat16_rn(__bfloat162float(x) + __bfloat162float(y));
}

// read once: the non-coherent path, no L1 allocation
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

template <typename T>
__device__ __forceinline__ uint4 add_vec(const uint4& x, const uint4& y) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 z;
  const T* xs = reinterpret_cast<const T*>(&x);
  const T* ys = reinterpret_cast<const T*>(&y);
  T* zs = reinterpret_cast<T*>(&z);
#pragma unroll
  for (int i = 0; i < VEC; ++i) zs[i] = add1(xs[i], ys[i]);
  return z;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    add_stream(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
               long long n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr long long CHUNK = (long long)THREADS * UNROLL;
  const long long nvec = n / VEC;
  const long long nchunk = (nvec + CHUNK - 1) / CHUNK;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4* c4 = reinterpret_cast<uint4*>(c);
  for (long long ch = blockIdx.x; ch < nchunk; ch += gridDim.x) {
    const long long v0 = ch * CHUNK + threadIdx.x;
    uint4 x[UNROLL], y[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v0 + u * THREADS < nvec) x[u] = load_stream(a4 + v0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v0 + u * THREADS < nvec) y[u] = load_stream(b4 + v0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v0 + u * THREADS < nvec) __stcs(c4 + v0 + u * THREADS, add_vec<T>(x[u], y[u]));
  }
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = nvec * VEC + (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride)
    c[i] = add1(a[i], b[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    add_scalar(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
               long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    c[i] = add1(a[i], b[i]);
}

constexpr int MAX_DEVICES = 64;

// blocks of `kernel` that all the SMs of the current device hold at once,
// queried once per device and kept in `cache`
cudaError_t resident_blocks(const void* kernel, int (&cache)[MAX_DEVICES], long long* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    cache[dev] = sms * per_sm;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

template <typename T>
int launch(const void* a, const void* b, void* c, long long n, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr long long CHUNK = (long long)THREADS * UNROLL;
  static int stream_cache[MAX_DEVICES] = {0};
  static int scalar_cache[MAX_DEVICES] = {0};
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c)) &
                        15) == 0;
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* pc = static_cast<T*>(c);
  long long resident = 0;
  const cudaError_t err =
      aligned ? resident_blocks(reinterpret_cast<const void*>(add_stream<T>), stream_cache,
                                &resident)
              : resident_blocks(reinterpret_cast<const void*>(add_scalar<T>), scalar_cache,
                                &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough blocks for the work (chunks of vectors, or of THREADS scalars),
  // at most what the card holds at once
  const long long work = aligned ? (n / VEC + CHUNK - 1) / CHUNK : (n + THREADS - 1) / THREADS;
  long long blocks = work < resident ? work : resident;
  if (blocks < 1) blocks = 1;
  if (aligned)
    add_stream<T><<<(unsigned)blocks, THREADS, 0, stream>>>(pa, pb, pc, n);
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
