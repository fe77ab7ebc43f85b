// K1: the paper's MM kernel (and the serving `prefill`) for Hopper.
//
// Replaces the Pallas TPU kernel `matmul` in src/repro/kernels/matmul.py
// (body `_mm_kernel`): C = A @ B with an f32 accumulator, cast to A's dtype
// once at the end, for f32 or bf16 inputs.
//
// What bounds it on an H100: at the main path's 2048^3 f32 shape (the
// serving prefill, x @ x.T) the product is 17.2 GFLOP against 48 MiB of
// operands.  IEEE f32 FMAs on the CUDA cores stop at 67 TFLOP/s (0.256 ms);
// only the tensor cores go faster, and they take f32 only as TF32 (10
// mantissa bits).  One TF32 pass leaves each product with a relative error
// near 2^-11, which over K = 2048 unit-normal terms gives errors near 3e-2
// on entries close to 0: far outside the f32 tolerance (rtol = atol =
// 2e-4 x K / 128, 3.2e-3 at K = 2048).  So f32 runs as 3xTF32: each operand
// x is split into hi = x with its low 13 mantissa bits cleared (exactly a
// TF32 value) and lo = x - hi (exact in f32, |lo| < 2^-10 |x|), and the
// tensor cores sum hi*hi + hi*lo + lo*hi in f32.  The dropped lo*lo is below
// 2^-20 of each product and lo's own TF32 rounding below 2^-21, so each
// product keeps about 20 bits.  Three TF32 passes at 494.5 TFLOP/s (dense,
// SXM part) bound the 2048^3 product by operations at 3 x 17.2 GFLOP /
// 494.5 TFLOP/s = 0.104 ms; the 48 MiB at 3.35 TB/s take 0.015 ms.
//
// The tensor cores' own f32 accumulation rounds toward zero, so a sum kept
// in one wgmma accumulator over all of K drifts by up to one unit in the
// last place of the running sum per wgmma: over the 768 wgmmas of K = 2048
// that left errors several times those of a plain f32 product (measured on
// an H100).  Each 32-deep k-block therefore starts a fresh accumulator (12
// wgmmas), which is then added to a total in registers by ordinary rounded
// f32 adds; the error against a float64 product is then of the size of a
// plain f32 product's.
//
// Design (`wgmma` path; PTX wrappers in hopper.cuh): a block of 384 threads
// owns a 128 x 128 tile of C.  A producer warpgroup, lowered to 24
// registers a thread by setmaxnreg, has one thread load 128-byte-wide
// k-blocks of A and B by TMA (128-byte swizzle, zero fill past the edges)
// into a ring of four mbarrier-guarded stages.  Two consumer warpgroups of
// 64 rows each take them in turn.  In f32 each k-block is prepared while the
// tensor cores run the one before: the consumers split B's tile into K-major
// hi and lo tiles in one of two split slots (a TF32 wgmma reads B only
// K-major from shared memory, so an MN-major B, the MM DAG's row-major
// layout, is transposed by the same pass), and each thread loads its A
// fragments straight from the stage into registers and splits them there
// (TF32 wgmma takes A from registers), which spares A's hi and lo tiles in
// shared memory and the tensor cores' three reads of them.  The stage is
// then free for the next load.  Split writes are made visible to the
// tensor cores' async proxy by fence.proxy.async and a named barrier over
// both warpgroups; a second barrier before the split keeps a slot from
// being rewritten while the other warpgroup's wgmmas still read it.  Each
// k-block runs three m64n128k8 TF32 wgmma passes per k8 step, lo*hi and
// hi*lo before hi*hi.  In bf16 the stage's tiles feed one bf16 wgmma pass
// per k16 step with no split, an MN-major operand read through the
// transpose bit, and one group of wgmmas stays in flight.  The TPU kernel's
// sequential K grid axis with a VMEM accumulator becomes this in-block K
// loop over the ring with the sum in registers; it is cast to A's dtype and
// stored with masked stores.
//
// TMA addresses an operand only when one of its two strides is 1, the other
// a multiple of 16 bytes, and its base 16-byte aligned.  Any other operand
// (the ragged 2047 x 1999 x 1000 case: a row of 1999 f32 is not a multiple
// of 16 bytes) runs the `fma` path: IEEE f32 FMAs on the CUDA cores, each
// 256-thread block a 128 x 128 tile with an 8 x 8 register tile per thread,
// operands read through their strides.  The wrapper (kernels/matmul.py)
// picks the path from the layout alone.
//
// Non-finite inputs give non-finite outputs, but the split can turn an
// infinite product into NaN (inf * 0 in a cross term) where plain f32 gives
// +-inf.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// fma: IEEE f32 FMAs on the CUDA cores, any strides
// ---------------------------------------------------------------------------

namespace fma_path {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps the k-major shared stores free of bank conflicts

// Each block stages an 8-deep slice of A and B in shared memory per step
// (converted to f32, stored k-major so the inner loop reads both as float4)
// and each thread does 8 x 8 register FMAs per k.  Neighbouring threads walk
// whichever dimension has unit stride while staging, so global loads stay
// coalesced for either layout; ragged edges are zero-filled and masked.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    mm_fma(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C, int M, int N,
           int K, long long sam, long long sak, long long sbk, long long sbn) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN);  // row group of this thread's 8x8 micro-tile
  const int tc = tid % (BN / TN);  // column group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
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
      As[kk][mm] =
          (gm < M && gk < K) ? to_f32(A[(long long)gm * sam + (long long)gk * sak]) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (BN * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int nn = b_n_fast ? e % BN : e / BK;
      const int kk = b_n_fast ? e / BN : e % BK;
      const int gn = n0 + nn;
      const int gk = k0 + kk;
      Bs[kk][nn] =
          (gn < N && gk < K) ? to_f32(B[(long long)gk * sbk + (long long)gn * sbn]) : 0.0f;
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
int launch(const void* a, const void* b, void* c, int M, int N, int K, long long sam,
           long long sak, long long sbk, long long sbn, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_fma<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                          static_cast<T*>(c), M, N, K, sam, sak, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fma_path

// ---------------------------------------------------------------------------
// wgmma: TMA ring + tensor cores (3xTF32 in f32, one bf16 pass in bf16)
// ---------------------------------------------------------------------------

namespace wgmma_path {

using namespace hopper;

constexpr int BM = 128;  // rows of C per block: two consumer warpgroups of 64
constexpr int BN = 128;  // columns of C per block
constexpr int CONSUMERS = 2;
constexpr int CONSUMER_THREADS = CONSUMERS * 128;
constexpr int THREADS = CONSUMER_THREADS + 128;  // and one producer warpgroup
constexpr int PRODUCER_REGS = 24;                // 128 * 24 + 256 * 240 <= 65536
constexpr int CONSUMER_REGS = 240;
constexpr int ROW = 128;         // bytes of one swizzled row of a tile
constexpr int TILE = BM * ROW;   // one operand's k-block: 16 KB (BM == BN)
constexpr uint32_t SPLIT_BAR = 1;  // named barrier of the consumer warpgroups
static_assert(BM == BN, "A and B tiles share one size");

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int BK = 32;      // k per 128-byte row
  static constexpr int STAGES = 4;   // TMA ring of A and B k-blocks
  static constexpr int SLOTS = 2;    // split slots: B hi, B lo
  static constexpr int MN_BOX = 32;  // an MN-major box: 32 rows (128 bytes) x BK k
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BK = 64;
  static constexpr int STAGES = 4;
  static constexpr int SLOTS = 0;
  static constexpr int MN_BOX = 64;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// the ring, the split slots, 2 * STAGES mbarriers, and slack to align the
// base to the 1024 bytes a 128-byte swizzle repeats
template <typename T>
constexpr int smem_bytes() {
  return 2 * (Cfg<T>::STAGES + Cfg<T>::SLOTS) * TILE + 64 + 1024;
}
static_assert(smem_bytes<float>() <= 232448, "over the 227 KB a block may use");
static_assert(smem_bytes<__nv_bfloat16>() <= 232448, "over the 227 KB a block may use");

// One k-block of an operand (BM rows from r0, k from k0) into `dst`.
// K-major: one box of BM rows x 128 bytes of k.  MN-major: BM / MN_BOX
// boxes of BK k-rows x 128 bytes of rows, each BK * ROW bytes.
template <typename T, bool MN>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int r0, int k0) {
  using C = Cfg<T>;
  if constexpr (MN) {
#pragma unroll
    for (int j = 0; j < BM / C::MN_BOX; ++j)
      tma_load_2d(dst + j * C::BK * ROW, map, bar, r0 + j * C::MN_BOX, k0);
  } else {
    tma_load_2d(dst, map, bar, k0, r0);
  }
}

// x = hi + lo with hi a TF32 value (low 13 mantissa bits cleared) and lo
// exact in f32; lo = 0 where hi == x, which keeps +-inf from giving NaN
__device__ __forceinline__ void split1(float x, float& hi, float& lo) {
  hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  lo = hi == x ? 0.0f : x - hi;
}
__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
  split1(x.x, hi.x, lo.x);
  split1(x.y, hi.y, lo.y);
  split1(x.z, hi.z, lo.z);
  split1(x.w, hi.w, lo.w);
}

// byte offset of (row r, column c) in a tile of 128-byte rows of f32 with
// the 128-byte swizzle: the 16-byte chunk index is XORed with the row
// within its 8-row group
__device__ __forceinline__ int swz_off(int r, int c) {
  return r * ROW + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// Split B's f32 k-block at `src` (as TMA left it) into K-major hi and lo
// tiles; each of the 256 consumer threads (`ct`) takes 4 of the 1024
// 16-byte chunks.  A K-major source has the destination's layout, so a chunk
// keeps its offset.  An MN-major source is transposed: a thread gathers 4
// k of one row (lanes on neighbouring rows of one swizzled box row, so the
// gathers hit 32 distinct banks) and stores them as one chunk.
template <bool MN>
__device__ __forceinline__ void split_tile(uint8_t* smem, int src, int hi, int lo, int ct) {
  constexpr int PER = TILE / 16 / CONSUMER_THREADS;
  constexpr int BK = Cfg<float>::BK;
  if constexpr (!MN) {
    float4 x[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j)
      x[j] = *reinterpret_cast<const float4*>(smem + src + 16 * (ct + j * CONSUMER_THREADS));
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int off = 16 * (ct + j * CONSUMER_THREADS);
      float4 h, l;
      split4(x[j], h, l);
      *reinterpret_cast<float4*>(smem + hi + off) = h;
      *reinterpret_cast<float4*>(smem + lo + off) = l;
    }
  } else {
    constexpr int BOX = Cfg<float>::MN_BOX;
    float4 x[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = ct + j * CONSUMER_THREADS;
      const int r = c % BM;
      const int kq = c / BM;  // which 4 k
      const uint8_t* box = smem + src + (r / BOX) * BK * ROW;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = *reinterpret_cast<const float*>(box + swz_off(4 * kq + e, r % BOX));
      x[j] = make_float4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = ct + j * CONSUMER_THREADS;
      const int off = swz_off(c % BM, 4 * (c / BM));
      float4 h, l;
      split4(x[j], h, l);
      *reinterpret_cast<float4*>(smem + hi + off) = h;
      *reinterpret_cast<float4*>(smem + lo + off) = l;
    }
  }
}

// This thread's TF32 A fragments of one f32 k-block (BK / 8 k8 steps of 4
// values, the layout wgmma_tf32 takes from registers), read from the raw
// stage tile at `src`: K-major, (row, k) is at swz_off(row, k); MN-major, in
// box row / MN_BOX at swz_off(k, row % MN_BOX)
template <bool MN>
__device__ __forceinline__ void load_a(const uint8_t* src, int wg, int t,
                                       float (&a)[Cfg<float>::BK / 8][4]) {
  constexpr int BK = Cfg<float>::BK;
  constexpr int BOX = Cfg<float>::MN_BOX;
  const int r0 = 64 * wg + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e & 1);
      const int k = 8 * kk + t % 4 + 4 * (e >> 1);
      const int off = MN ? (r / BOX) * BK * ROW + swz_off(k, r % BOX) : swz_off(r, k);
      a[kk][e] = *reinterpret_cast<const float*>(src + off);
    }
  }
}

// descriptor of k-step `kk` (32 bytes of k) of a 64- or 128-row K-major tile
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk) {
  return make_desc(tile + 32 * kk, 16, 8 * ROW, SWIZZLE_128B);
}

// descriptor of k16-step `kk` of a bf16 operand: K-major as above, or
// MN-major (64-row boxes of BK k-rows, read transposed: the leading offset
// is the distance between two 64-row boxes, the stride offset that between
// groups of 8 k-rows)
template <bool MN>
__device__ __forceinline__ uint64_t bf16_desc(uint32_t tile, int kk) {
  constexpr int BK = Cfg<__nv_bfloat16>::BK;
  if constexpr (MN) return make_desc(tile + 16 * kk * ROW, BK * ROW, 8 * ROW, SWIZZLE_128B);
  return kdesc(tile, kk);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x, float y);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// AMN / BMN: the operand is MN-major (its M or N stride is 1), else K-major
template <typename T, bool AMN, bool BMN>
__global__ void __launch_bounds__(THREADS, 1)
    mm_wgmma(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
             T* __restrict__ C, int M, int N, int K) {
  using Cf = Cfg<T>;
  constexpr int BK = Cf::BK;
  constexpr int STAGES = Cf::STAGES;
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ uint8_t smem_raw[];
  // everything below is an offset from the 1024-aligned base: `smem + off`
  // for thread loads and stores, `base + off` for TMA, wgmma and mbarriers
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw_base);
  auto stage = [](int s) { return 2 * s * TILE; };  // A, then B at + TILE
  constexpr int SPLIT = 2 * STAGES * TILE;           // slot p: B hi, then B lo
  const uint32_t bars = base + SPLIT + 2 * Cf::SLOTS * TILE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // the producer warpgroup: one thread works
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      prefetch_tensormap(&amap);
      prefetch_tensormap(&bmap);
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), 2 * TILE);  // zero-filled parts count too
        load_tile<T, AMN>(base + stage(s), &amap, full(s), m0, i * BK);
        load_tile<T, BMN>(base + stage(s) + TILE, &bmap, full(s), n0, i * BK);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 rows of C
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  // f32: `acc` holds one k-block (the tensor cores' fragment), `total` the
  // sum over k-blocks; bf16: `acc` holds the whole sum.  The first wgmma
  // into `acc` overwrites it (scale-d 0), so no other instruction writes it.
  float acc[64];
  float total[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) total[e] = 0.0f;

  if constexpr (F32) {
    float a_raw[BK / 8][4];  // this thread's A fragments of the next k-block
    uint32_t a_hi[BK / 8][4];
    uint32_t a_lo[BK / 8][4];
    // k-block i's stage: B split into slot i % 2 once both warpgroups are
    // past wgmma(i - 2), the last reader of that slot, and this thread's A
    // fragments loaded; then the stage may be reloaded
    auto take_stage = [&](int i) {
      const int s = i % STAGES;
      const int slot = SPLIT + (i & 1) * 2 * TILE;
      mbar_wait(full(s), (i / STAGES) & 1);
      bar_sync(SPLIT_BAR, CONSUMER_THREADS);
      split_tile<BMN>(smem, stage(s) + TILE, slot, slot + TILE, threadIdx.x);
      fence_proxy_async();
      bar_sync(SPLIT_BAR, CONSUMER_THREADS);  // the split tiles are whole and visible
      load_a<AMN>(smem + stage(s), wg, t, a_raw);
      mbar_arrive_if(empty(s), t == 0);
    };
    auto split_a = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float h, l;
          split1(a_raw[kk][e], h, l);
          a_hi[kk][e] = __float_as_uint(h);
          a_lo[kk][e] = __float_as_uint(l);
        }
      }
    };
    // the three passes over k-block i into a fresh fragment
    auto mma_kblock = [&](int i) {
      const uint32_t b_hi = base + SPLIT + (i & 1) * 2 * TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        wgmma_tf32(acc, a_lo[kk], kdesc(b_hi, kk), kk > 0);     // lo * hi
        wgmma_tf32(acc, a_hi[kk], kdesc(b_hi + TILE, kk), 1);  // hi * lo
        wgmma_tf32(acc, a_hi[kk], kdesc(b_hi, kk), 1);         // hi * hi
      }
      wgmma_commit();
    };
    // the fragment of one k-block added to the total by rounded f32 adds;
    // the fences keep the next A fragments from being written before the
    // wgmmas that read the current ones are done
    auto promote = [&]() {
      wgmma_wait<0>();
      reg_fence(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        reg_fence(a_hi[kk]);
        reg_fence(a_lo[kk]);
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) total[e] += acc[e];
    };
    // k-block i + 1 is split and loaded while the tensor cores run k-block
    // i; the last k-block is peeled so nothing branches while a wgmma is in
    // flight
    take_stage(0);
    split_a();
    for (int i = 0; i + 1 < nk; ++i) {
      mma_kblock(i);
      take_stage(i + 1);
      promote();
      split_a();
    }
    mma_kblock(nk - 1);
    promote();
  } else {
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      mbar_wait(full(s), (i / STAGES) & 1);
      // this warpgroup's 64 rows of A: 64 K-major rows or, MN-major, one box
      // of BK k-rows; both are 8 KB
      static_assert(BK * ROW == 64 * ROW, "an MN-major bf16 box holds 64 rows");
      const uint32_t a = base + stage(s) + wg * 64 * ROW;
      const uint32_t b = base + stage(s) + TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<AMN, BMN>(acc, bf16_desc<AMN>(a, kk), bf16_desc<BMN>(b, kk), i > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // wgmma(i - 1) is done: its stage may be reloaded
      mbar_arrive_if(empty((i + STAGES - 1) % STAGES), t == 0 && i > 0);
    }
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int e = 0; e < 64; ++e) total[e] = acc[e];
  }

  // the m64n128 fragment: total[4n + 2i + j] is (row 16 (t / 32) + (t % 32) / 4
  // + 8 i, column 8 n + 2 (t % 4) + j) of this warpgroup's 64 x 128 tile
  const int row0 = m0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  const int col0 = n0 + 2 * (t % 4);
  const bool pairs = (N & 1) == 0;  // then every even column starts an aligned pair
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= M) continue;
    T* c = C + (long long)row * N;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = col0 + 8 * n;
      const float x = total[4 * n + 2 * i];
      const float y = total[4 * n + 2 * i + 1];
      if (pairs && col + 1 < N) {
        store_pair<T>(c + col, x, y);
      } else {
        if (col < N) c[col] = from_f32<T>(x);
        if (col + 1 < N) c[col + 1] = from_f32<T>(y);
      }
    }
  }
}

// a rank-2 map over one operand (`rows` x K, strides s_rows and s_k in
// elements, one of them 1) with the boxes load_tile takes
template <typename T>
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rows, int K,
              long long s_rows, long long s_k) {
  using Cf = Cfg<T>;
  const bool mn = s_k != 1;
  const cuuint64_t dims[2] = {(cuuint64_t)(mn ? rows : K), (cuuint64_t)(mn ? K : rows)};
  const cuuint64_t strides[1] = {(cuuint64_t)((mn ? s_k : s_rows) * (long long)sizeof(T))};
  const cuuint32_t box[2] = {(cuuint32_t)(mn ? Cf::MN_BOX : Cf::BK),
                             (cuuint32_t)(mn ? Cf::BK : BM)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, Cf::TMA_TYPE, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <typename T, bool AMN, bool BMN>
int launch_kernel(const CUtensorMap& am, const CUtensorMap& bm, T* c, int M, int N, int K,
                  cudaStream_t stream) {
  // the dynamic shared memory above 48 KB, set once on each device
  static unsigned long long attr_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(attr_set >> dev & 1ull)) {
    const cudaError_t err = cudaFuncSetAttribute(
        mm_wgmma<T, AMN, BMN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1ull << dev;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_wgmma<T, AMN, BMN><<<grid, THREADS, smem_bytes<T>(), stream>>>(am, bm, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K, long long sam,
           long long sak, long long sbk, long long sbn, cudaStream_t stream) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap am, bm;
  if (!make_map<T>(enc, &am, a, M, K, sam, sak) || !make_map<T>(enc, &bm, b, N, K, sbn, sbk))
    return static_cast<int>(cudaErrorInvalidValue);
  T* pc = static_cast<T*>(c);
  const bool amn = sak != 1;
  const bool bmn = sbk != 1;
  if (amn) {
    return bmn ? launch_kernel<T, true, true>(am, bm, pc, M, N, K, stream)
               : launch_kernel<T, true, false>(am, bm, pc, M, N, K, stream);
  }
  return bmn ? launch_kernel<T, false, true>(am, bm, pc, M, N, K, stream)
             : launch_kernel<T, false, false>(am, bm, pc, M, N, K, stream);
}

}  // namespace wgmma_path

}  // namespace

// C (M x N, contiguous, A's dtype) = A (M x K, strides sam/sak) @ B (K x N,
// strides sbk/sbn).  dtype: 0 = float32, 1 = bfloat16.  path: 0 = fma (any
// strides), 1 = wgmma (each operand with exactly one stride 1, the other a
// multiple of 16 bytes, its base 16-byte aligned; K >= 1).  Launches on
// `stream` and returns a cudaError_t (0 when the launch was accepted).
extern "C" int repro_matmul(int dtype, int path, const void* a, const void* b, void* c, int M,
                            int N, int K, long long sam, long long sak, long long sbk,
                            long long sbn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0 && dtype == 0)
    return fma_path::launch<float>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
  if (path == 0 && dtype == 1)
    return fma_path::launch<__nv_bfloat16>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
  if (path == 1 && dtype == 0)
    return wgmma_path::launch<float>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
  if (path == 1 && dtype == 1)
    return wgmma_path::launch<__nv_bfloat16>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bytes of dynamic shared memory a block of the wgmma kernel takes for
// `dtype` (-1 for a dtype that is not built); the fma kernel takes none
extern "C" int repro_matmul_smem(int dtype) {
  return dtype == 0 ? wgmma_path::smem_bytes<float>() : dtype == 1 ? wgmma_path::smem_bytes<__nv_bfloat16>() : -1;
}
