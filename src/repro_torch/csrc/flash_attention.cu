// K3: forward flash attention for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_flash_kernel`): softmax
// attention with an online softmax (running max m, running sum l and the
// output accumulator kept in f32), logits scaled by `scale`, keys at or
// past `kv_len` masked, a top-left aligned causal mask (qpos >= kpos, both
// from 0, also when Sq != Sk), masked logits set to -1e30, the probabilities
// rounded to V's dtype before the P.V product, and out = acc / max(l, 1e-30).
// A row whose keys are all masked (kv_len == 0) therefore averages V, as the
// reference does.  Where the caller passes `lse` (training: the backward K3b
// reads it), each row's log-sum-exp of its scaled logits is written there,
// lse = m + log(max(l, 1e-30)) in natural-log units as the reference's
// `_flash_fwd_inner` computes it; serving passes nullptr and nothing else
// changes.  GQA is native: query head h reads KV head h / G.  Built
// for head dims 32, 64, 96 and 128, in f32 or bf16.  The caller passes the
// scale, 1/sqrt of its own head dim: the wrapper zero-pads q, k and v of any
// other head dim up to the next built one (zero columns add nothing to
// Q K^T, and the output's extra columns are cropped), so the scale cannot
// be the template's.
//
// What bounds it on an H100: at the granite-3-2b prefill shape (B 8, H 32,
// S 2048, hd 64, bf16, causal) the two products are 137.5 GFLOP against
// 168 MB of q, k, v and o, so it is bound by operations: 0.139 ms at the
// dense bf16 tensor-core peak of 989 TFLOP/s.
//
// bf16 (the served path) runs on the tensor cores, as FlashAttention-3 does
// without its extras.  One block of 384 threads covers 128 query rows of one
// (batch, head): two consumer warpgroups of 64 rows each and one producer
// warpgroup, which hands most of its registers to the consumers
// (setmaxnreg: 24 and 240 a thread).  The producer's first thread loads Q
// once and then the K and V tiles of 128 keys by TMA into a ring of three
// stages, each guarded by a "full" and an "empty" mbarrier, so later tiles
// arrive while one is computed.  The tensor maps are built on the host for
// each call over the strided (B, S, heads, hd) storage, with a 128-byte
// swizzle where hd is a multiple of 64 (two 64-wide boxes at hd 128) and a
// 64-byte one of 32-wide boxes otherwise (one at hd 32, three at hd 96);
// TMA's zero fill gives the ragged tails past Sq and Sk.  Each consumer warpgroup
// computes S = Q K^T with wgmma (both operands K-major in shared memory),
// masks only the tiles that cross the causal diagonal, kv_len or Sk,
// updates m and l in registers (row max and sum by shuffles within each quad
// of the accumulator layout; l sums the unrounded p), rounds P to bf16 in
// registers and adds P V with a second wgmma whose A operand is those
// registers (the m64nBK accumulator fragment is the m64nHDk16 A fragment,
// converted pairwise) and whose B is the V tile in shared memory, MN-major,
// read transposed.  Each warpgroup issues tile i's S before tile i - 1's
// P V, so its softmax of tile i runs while the tensor cores do that P V; the
// two warpgroups also overlap each other's softmax and products.  The scale
// times log2(e) is folded into exp2.  Query blocks are launched with the
// most keys first, so the causal diagonal's heavy blocks do not finish last.
//
// hd 96 (minicpm3-4b's MLA: qk_nope 64 + qk_rope 32, v zero-padded to 96 by
// the model) is built as three 32-wide boxes a row with the 64-byte swizzle:
// S = Q K^T is 6 k16 steps, two in each box, and P V one m64n96k16 wgmma a
// k16 step whose B spans the three boxes of V, one leading offset (a box,
// 8 KB) apart.  Q and three stages of K and V take 168 KB of shared memory
// (hd 128: 224 KB) and the accumulator 48 registers (64).  At the prefill
// shape (B 8, H 40, S 2048, causal) its 4 x 96 operations a kept pair take
// 0.261 ms at the bf16 tensor peak; until this build the wrapper zero-padded
// q, k and v to 128, three copies of 168 MB a layer, and the kernel did 4/3
// of the products.
//
// bf16 at a few query rows (the wrapper's `split` path: Sq <= 4; whisper's
// decode cross-attention has one query over 1500 encoder frames) is bound
// by bytes: a key costs 4 hd operations a query row against 4 hd bytes of K
// and V, so at one row the tensor cores would idle 63 of the 64 rows of
// each wgmma, and the CUDA cores' f32 rate (67 TFLOP/s, 20 operations a
// byte of the 3.35 TB/s) covers the arithmetic of up to ~16 rows inside the
// time the bytes take.  The prefill launch gives such a call one block of
// 128 mostly empty rows a (batch, head), 160 blocks of 384 threads at
// whisper's shape on 132 SMs, each walking all 12 key tiles in turn.
// Instead the keys of each (batch, KV head) are cut into splits (the
// wrapper's rule, from the shapes alone: ceil(rows / 4) tiles of 128 keys,
// rows = min(G Sq, 16), so the partials stay near 1/16 of the keys' bytes;
// 12 splits of one tile at whisper's (8, 20/20, 1 over 1500, 64)).  An item
// is one split of all G x Sq query rows of a KV head (16 at most; more rows
// make more row groups, each rereading the keys), so K and V are read once.
// Persistent blocks of 128 threads, as many as the SMs hold, take the items
// in turn; in each, thread 0 keeps two steps (a tile of K and V and the
// item's q rows) in flight by TMA, with the prefill kernel's boxes and
// swizzle, each stage completing on its mbarrier, while the block computes
// one: each key's dots in f32 (a thread a key), the online softmax (a warp
// a row) with the prefill kernel's masks, rounding and -1e30, and P V (a
// thread per two output columns, the tile's keys in order, in up to 4 key
// slices summed in order where the rows have few columns).  An item writes
// its rows' (m, l) and unnormalised O in f32 to a scratch buffer the
// wrapper allocates; a second kernel, launched as a programmatic dependent
// launch so its start overlaps the first's tail, takes M = max m and sums
// l and O over the splits in order, each times 2^(m - M), and writes out =
// O / max(l, 1e-30) and the LSE.  No atomics: a second launch gives the
// same bits, and the split count depends on the shapes alone (which block
// takes an item does not change its sums), so a CUDA graph's replays give
// eager decode's bits.  Splits whose keys all lie past the last key any row
// sees (causal, or past kv_len > 0) are neither run nor merged.  Forms of
// this kernel with per-thread cp.async copies into 64-key tiles were bound
// by their copy and index instructions, not by bytes; issuing the copies by
// TMA from one thread, 128-key tiles and index math once an item make the
// split kernel take 0.021 ms at whisper's shape on an H100 (SXM, 700 W;
// scripts/time_attention_rows.py), ~89% of the HBM rate.
//
// f32 runs on the tensor cores as 3xTF32, as K1 does (matmul.cu): each
// operand x is split into hi = x with its low 13 mantissa bits cleared and
// lo = x - hi, and each product is lo.hi + hi.lo + hi.hi in three
// mma.sync m16n8k8 TF32 passes (attention_tf32.cuh); the dropped lo.lo is
// below 2^-20 of the product.  tests/test_torch_attention_tf32.py emulates
// the scheme and holds it to the reference at K3's f32 tolerance, 2e-5,
// which one TF32 pass misses by two orders of magnitude.  The tensor cores'
// f32 accumulation rounds toward zero, so each tile's S and each 8 columns
// of its P V start a fresh accumulator (24 and 12 mma.syncs at hd 64),
// added to the running O by ordinary f32 arithmetic.  A block of 2 warps
// covers 32 query rows of one (batch, head), 16 a warp; Q is staged once
// and K and V tiles of 32 keys go through two cp.async stages (16-byte
// copies where the last dimension is contiguous, 4-byte ones through any
// other strides), so the next tile loads while one is computed.  Staged
// rows are hd + 4 floats long, so every fragment read hits 32 banks.  P
// goes from its accumulator straight into the A operand of P V: the
// accumulator holds columns 2t and 2t + 1 where a TF32 A fragment wants t
// and t + 4, so P V takes its keys in that order and reads V's rows to
// match, and no value moves between lanes.  Only tiles that cross kv_len,
// Sk or the diagonal of one of the warp's rows are masked, and the query
// blocks with the most keys launch first.  At lm-100m's training shape (B
// 4, H 12 over 4 KV heads, S 128, hd 64, causal) that is 192 blocks for
// 132 SMs; its 4 hd operations a kept pair take 0.0006 ms as three TF32
// passes at 494.5 TFLOP/s against 0.0013 ms for its 4.2 MB of q, k, v and
// o at 3.35 TB/s, so bytes bound it, and what paces the kernel is the
// latency of each warp's chain of at most 4 tiles.  No served path runs
// it.
//
// Blocks are skipped (causal, or past kv_len) only when kv_len > 0: then
// every row has a valid key and a skipped key would add exactly 0.  With
// kv_len == 0 every key is visited, as in the reference.
//
// The logit cap (the reference's `logit_cap`, a model's
// `attn_logit_softcap`): where the caller passes cap > 0, each scaled logit
// s becomes cap tanh(s / cap) before the mask, as the reference's
// `_flash_fwd_inner` does, and the row max, the sum and the LSE are those of
// the capped logits.  The cap is a template flag of every kernel, so the
// uncapped kernels are the code they were.  f32 takes `tanhf` (a few ulp),
// since its tolerance is 2e-5.  bf16 forms t = tanh(s scale / cap) in place
// of the raw dot (hopper::tanh_ex2: 1 - 2 / (2^(2|x| log2 e) + 1), absolute
// error ~3e-7, where tanh.approx.f32's ~2^-11 relative would move a logit by
// ~0.025 at cap 50), and the exponent becomes t (cap log2 e) in place of
// s (scale log2 e): the softmax after it is unchanged.  What that costs: the
// tanh takes two special-function operations (ex2, rcp) beside the ex2 of P,
// and an H100 issues 16 of them a clock per SM, 4.18e12 a second, so at the
// granite-3-2b shape the capped kernel's floor is 3 x 537,133,056 kept
// pairs / 4.18e12 = 0.385 ms, above its 0.139 ms tensor bound: a capped K3
// is bound by the special-function unit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "attention_tf32.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // the reference's mask value

struct Strides {
  long long b, h, s, d;
};

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores (mma.sync), K and V staged by cp.async
// ---------------------------------------------------------------------------

namespace f32 {

using namespace tf32;

constexpr int WARPS = 2;             // a warp owns 16 query rows
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;       // query rows a block
constexpr int BK = 32;               // keys a tile

template <int HD>
struct Cfg {
  static constexpr int LD = HD + 4;  // floats a staged row: fragment reads hit 32 banks
  static constexpr int TILE = BK * LD;
  // Q, then two stages of a K and a V tile
  static constexpr int SMEM = (BQ * LD + 4 * TILE) * 4;
};

template <int HD, bool CAP>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                   int H, int G, int Sq, int Sk, int kv_len, int causal, float scale, float cap,
                   int vec, Strides sq, Strides sk, Strides sv, Strides so) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD;
  constexpr int NT = BK / 8;  // 8-key blocks of S
  constexpr int ND = HD / 8;  // 8-column blocks of O
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + BQ * LD;  // stage s: K at KVs + 2 s TILE, V after it

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the most keys first
  const int warp = threadIdx.x / 32;
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  const int w0 = q0 + 16 * warp;  // the warp's first row; this thread's are w0 + g, + 8
  // keys past k_end are masked for every row of the block and, since each
  // row has a valid key (key 0) when kv_len > 0, contribute exactly 0
  const bool any_valid = kv_len > 0;
  int k_end = any_valid ? kv_len : Sk;
  if (causal && any_valid) k_end = min(k_end, q0 + BQ);
  const int n_tiles = (k_end + BK - 1) / BK;
  const int hk = h / G;
  const float* kp = k + b * sk.b + hk * sk.h;
  const float* vp = v + b * sv.b + hk * sv.h;
  auto stage_kv = [&](int i) {
    float* Ks = KVs + 2 * (i & 1) * C::TILE;
    stage_rows<HD>(Ks, LD, kp, sk.s, sk.d, i * BK, BK, Sk, vec & 2, threadIdx.x, THREADS);
    stage_rows<HD>(Ks + C::TILE, LD, vp, sv.s, sv.d, i * BK, BK, Sk, vec & 4, threadIdx.x,
                   THREADS);
    cp_commit();
  };
  stage_rows<HD>(Qs, LD, q + b * sq.b + h * sq.h, sq.s, sq.d, q0, BQ, Sq, vec & 1, threadIdx.x,
                 THREADS);
  stage_kv(0);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};  // this thread's part of each row's sum
  const float* Qw = Qs + 16 * warp * LD;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      stage_kv(i + 1);  // into the stage tile i - 1 used
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile i (and Q) staged by every thread
    const float* Ks = KVs + 2 * (i & 1) * C::TILE;
    const float* Vs = Ks + C::TILE;
    const int k0 = i * BK;

    // S = Q K^T, a fresh accumulator each tile
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const Split<4> a = frag_a(Qw + 8 * kk, LD, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma3(s[n], a, frag_bt(Ks + 8 * n * LD + 8 * kk, LD, g, t));
    }

    // the online softmax; only a tile that crosses kv_len, Sk or the
    // diagonal of one of the warp's rows is masked
    const bool mask = k0 + BK > kv_len || (causal && k0 + BK - 1 > w0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (CAP) x = cap * tanhf(x / cap);
        if (mask) {
          const int row = w0 + g + 8 * (e >> 1);
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const bool valid = key < kv_len && (!causal || key <= row);
          // a slot past Sk does not exist: -inf gives it p = 0
          x = valid ? x : (key < Sk ? NEG_INF : -INFINITY);
        }
        s[n][e] = x;
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = expf(s[n][2 * r + j] - m_new);
          s[n][2 * r + j] = p;
          sum += p;
        }
      }
      l[r] = l[r] * corr[r] + sum;
      m[r] = m_new;
    }

    // O = O corr + P V: P is the A operand straight from its accumulator
    // (k renumbered), and each 8 columns of O take a fresh accumulator over
    // the tile's keys, added to O by ordinary f32 arithmetic
    Split<4> pa[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) pa[n] = frag_a(s[n]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NT; ++n) mma3(part, pa[n], frag_b(Vs + 8 * n * LD + 8 * nd, LD, g, t));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = fmaf(acc[nd][e], corr[e >> 1], part[e]);
    }
    __syncthreads();  // tile i consumed: its stage takes tile i + 2
  }

  // out = O / max(l, 1e-30), l summed over the quad that shares each row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = w0 + g + 8 * r;
    if (row < Sq) {
      const float inv = 1.0f / fmaxf(lr, 1e-30f);
      float* op = o + b * so.b + h * so.h + (long long)row * so.s;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        op[(8 * nd + 2 * t) * so.d] = acc[nd][2 * r] * inv;
        op[(8 * nd + 2 * t + 1) * so.d] = acc[nd][2 * r + 1] * inv;
      }
      if (lse != nullptr && t == 0)
        lse[((long long)b * H + h) * Sq + row] = m[r] + logf(fmaxf(lr, 1e-30f));
    }
  }
}

template <int HD, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int G, int Sq, int Sk, int kv_len, int causal, float scale, float cap,
           const long long* st, cudaStream_t stream) {
  using C = Cfg<HD>;
  // the dynamic shared memory above 48 KB (hd 128), set once on each device
  // for each specialisation
  static unsigned long long attr_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(attr_set >> dev & 1ull)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tf32<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1ull << dev;
  }
  const int vec = int(vec_ok(q, st)) | int(vec_ok(k, st + 4)) << 1 | int(vec_ok(v, st + 8)) << 2;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  const Strides sq{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides so{st[12], st[13], st[14], st[15]};
  flash_fwd_tf32<HD, CAP><<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, G, Sq, Sk, kv_len, causal,
      scale, cap, vec, sq, sk, sv, so);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace bf16 {

using namespace hopper;

constexpr int BQ = 128;          // query rows per block
constexpr int STAGES = 3;        // K/V tiles in flight
constexpr int CONSUMERS = 2;     // warpgroups of 64 query rows
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and one producer warpgroup
// registers a thread of each role keeps (setmaxnreg): the producer gives
// its share to the consumers, 128 * 24 + 256 * 240 <= 65536
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Cfg {
  static constexpr int BK = 128;                       // keys per tile
  static constexpr int RB = HD % 64 == 0 ? 128 : 64;   // bytes per swizzled row of a box
  static constexpr int BOX = RB / 2;                   // hd values per box
  static constexpr int NBOX = HD / BOX;                // boxes per row: 1, 1, 3, 2
  static_assert(NBOX * BOX == HD, "a row is whole boxes");
  static constexpr uint32_t SWIZZLE = RB == 128 ? SWIZZLE_128B : SWIZZLE_64B;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;  // one K or V tile
  // Q, the ring of K and V tiles, 3 + 2 * STAGES mbarriers' worth of room,
  // and slack to align the base to the 1024 bytes a 128-byte swizzle repeats
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 64 + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64nN accumulator fragment: thread t of the warpgroup holds, for each
// 8-column block n, d[4n + 2i + j] = (row 16 (t / 32) + (t % 32) / 4 + 8 i,
// column 8 n + 2 (t % 4) + j).

// One online-softmax step on the S tile in `s` (raw dots): afterwards s
// holds p, m and l (this thread's partial sums) are updated, and corr[i] is
// the factor by which the O rows (i = 0: row0, 1: row0 + 8) must be scaled.
// MASK: logits of masked keys become -1e30, of slots past Sk -inf; the
// others are scaled.  CAP: each dot first becomes t = tanh(s tanh_scale),
// tanh_scale = scale / cap, in place, and `scale_log2` is cap log2(e), so the
// exponent is the capped logit in base 2.
template <bool MASK, bool CAP, int NS>
__device__ __forceinline__ void softmax_step(float (&s)[NS], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale_log2,
                                             float tanh_scale, int row0, int key0, int Sk,
                                             int kv_len, int causal) {
  if (CAP) {
#pragma unroll
    for (int e = 0; e < NS; ++e) s[e] = tanh_ex2(s[e] * tanh_scale);
  }
  float sl = scale_log2;
  if (MASK) {
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int row = row0 + 8 * ((e >> 1) & 1);
      const int key = key0 + 8 * (e >> 2) + (e & 1);
      const bool valid = key < kv_len && (!causal || key <= row);
      s[e] = valid ? s[e] * scale_log2 : (key < Sk ? NEG_INF : -INFINITY);
    }
    sl = 1.0f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
      mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * sl);
    corr[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < NS / 4; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ex2(fmaf(s[4 * n + 2 * i + j], sl, -m_new));
        s[4 * n + 2 * i + j] = p;
        sum += p;
      }
    }
    l[i] = l[i] * corr[i] + sum;
  }
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int H, int G, int Sq, int Sk, int kv_len, int causal,
              float scale_log2, float tanh_scale, Strides so) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + C::Q_BYTES;  // stage s: K at sKV + 2 s KV_BYTES, V after it
  const uint32_t bars = sKV + 2 * STAGES * C::KV_BYTES;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the most keys first
  const bool any_valid = kv_len > 0;
  int k_end = any_valid ? kv_len : Sk;
  if (causal && any_valid) k_end = min(k_end, q0 + BQ);
  const int n_tiles = (k_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // the producer warpgroup: one thread works
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int r = 0; r < C::NBOX; ++r)
        tma_load_4d(sQ + r * BQ * C::RB, &qmap, q_full, r * C::BOX, q0, h, b);
      const int hk = h / G;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::KV_BYTES);
        const uint32_t sK = sKV + 2 * s * C::KV_BYTES;
        for (int r = 0; r < C::NBOX; ++r) {
          tma_load_4d(sK + r * BK * C::RB, &kmap, full(s), r * C::BOX, i * BK, hk, b);
          tma_load_4d(sK + C::KV_BYTES + r * BK * C::RB, &vmap, full(s), r * C::BOX, i * BK,
                      hk, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int wg_first = q0 + 64 * wg;
  const int row0 = wg_first + 16 * (t / 32) + (t % 32) / 4;  // and row0 + 8
  const int col0 = 2 * (t % 4);                              // and + 1, in each 8 block
  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};

  // with BK == BQ every tile holds a key at or before some row of each
  // warpgroup, so both warpgroups compute every tile
  static_assert(BK == BQ, "a tile wholly past a warpgroup's diagonal would need a skip");
  float sacc[BK / 2];
  uint32_t pa[BK / 16][4];  // P of the previous tile, bf16 pairs

  // O += P V for the tile in stage `s`: BK / 16 steps of k16 over the keys,
  // P from registers, V's 16 key rows of each step read transposed
  // (MN-major); the boxes of a row (two of 64 at hd 128, three of 32 at hd
  // 96) are one leading offset apart
  auto issue_pv = [&](int s) {
    const uint32_t sV = sKV + (2 * s + 1) * C::KV_BYTES;
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
      wgmma_rs(acc, pa[c], make_desc(sV + 16 * c * C::RB, BK * C::RB, 8 * C::RB, C::SWIZZLE));
    wgmma_commit();
  };

  // S = Q K^T for tile i: HD / 16 steps of k16; a step's 32 bytes sit
  // within one swizzled row of a box, so its descriptor is the box's plus
  // the offset
  auto issue_s = [&](int i) {
    const uint32_t sK = sKV + 2 * (i % STAGES) * C::KV_BYTES;
    mbar_wait(full(i % STAGES), (i / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int box = kk * 32 / C::RB;
      const int off = (kk * 32) % C::RB;
      const uint64_t da =
          make_desc(sQ + box * BQ * C::RB + 64 * wg * C::RB + off, 16, 8 * C::RB, C::SWIZZLE);
      const uint64_t db = make_desc(sK + box * BK * C::RB + off, 16, 8 * C::RB, C::SWIZZLE);
      wgmma_ss(sacc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O *= corr, then P (in sacc) rounded to the bf16 pairs of the A fragment
  auto rescale_and_pack = [&](const float (&corr)[2]) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * n + e] *= corr[e >> 1];
    }
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[c][r] = pack_bf16(sacc[8 * c + 2 * r], sacc[8 * c + 2 * r + 1]);
    }
  };
  // Tile i > 0, software-pipelined: S of tile i is issued ahead of P V of
  // tile i - 1, and tile i's softmax runs while the tensor cores do that
  // P V.  Nothing branches while that P V is in flight (ptxas would
  // serialise the wgmmas), so the masked and unmasked tiles run in two
  // loops, each with its own softmax.
  auto pipelined = [&](int i, auto mask) {
    issue_s(i);
    issue_pv((i - 1) % STAGES);
    wgmma_wait<1>();  // S done; P V of tile i - 1 may still run
    reg_fence(sacc);
    float corr[2];
    softmax_step<decltype(mask)::value, CAP>(sacc, m, l, corr, scale_log2, tanh_scale, row0,
                                             i * BK + col0, Sk, kv_len, causal);
    wgmma_wait<0>();  // P V of tile i - 1 is done: its stage and pa are free
    reg_fence(acc);
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) reg_fence(pa[c]);
    if (lane == 0) mbar_arrive(empty((i - 1) % STAGES));
    rescale_and_pack(corr);
  };

  // tiles [0, n_plain) need no mask: all their keys are below kv_len and
  // at or before every row of this warpgroup
  int n_plain = 0;
  if (any_valid) n_plain = min(n_tiles, causal ? min(kv_len, wg_first + 1) / BK : kv_len / BK);

  mbar_wait(q_full, 0);
  issue_s(0);
  wgmma_wait<0>();
  reg_fence(sacc);
  {
    float corr[2];
    if (n_plain > 0)
      softmax_step<false, CAP>(sacc, m, l, corr, scale_log2, tanh_scale, row0, col0, Sk,
                               kv_len, causal);
    else
      softmax_step<true, CAP>(sacc, m, l, corr, scale_log2, tanh_scale, row0, col0, Sk, kv_len,
                              causal);
    rescale_and_pack(corr);
  }
  for (int i = 1; i < n_plain; ++i) pipelined(i, std::false_type());
  for (int i = max(1, n_plain); i < n_tiles; ++i) pipelined(i, std::true_type());
  wgmma_fence();
  issue_pv((n_tiles - 1) % STAGES);
  wgmma_wait<0>();
  reg_fence(acc);

  // out = O / max(l, 1e-30), l summed over the quad that shares each row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.0f / fmaxf(li, 1e-30f);
    const int row = row0 + 8 * i;
    if (row < Sq) {
      __nv_bfloat16* op = o + b * so.b + h * so.h + (long long)row * so.s + col0;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      // m is in log2 units of the scaled (capped) logits, but a row whose keys are all
      // masked keeps the unscaled -1e30 (the reference's -1e30 + log l)
      if (lse != nullptr && t % 4 == 0)
        lse[((long long)b * H + h) * Sq + row] =
            m[i] == NEG_INF ? NEG_INF + logf(fmaxf(li, 1e-30f))
                            : (m[i] + log2f(fmaxf(li, 1e-30f))) * LN2;
    }
  }
}

// a rank-4 map over the (B, heads, S, hd) view with element strides `st`
// (b, h, s, d; d == 1), boxes of `rows` rows by BOX hd values
template <int HD>
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int S, int heads, int B,
              const long long* st, int rows) {
  using C = Cfg<HD>;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::BOX, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         C::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <int HD, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int G,
           int Sq, int Sk, int kv_len, int causal, float scale, float cap, const long long* st,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  if (!make_map<HD>(enc, &qm, q, Sq, H, B, st, BQ) ||
      !make_map<HD>(enc, &km, k, Sk, H / G, B, st + 4, C::BK) ||
      !make_map<HD>(enc, &vm, v, Sk, H / G, B, st + 8, C::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  // the dynamic shared memory above 48 KB, set once on each device for each
  // specialisation (each template instance has its own flags)
  static unsigned long long attr_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(attr_set >> dev & 1ull)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1ull << dev;
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  const Strides so{st[12], st[13], st[14], st[15]};
  // capped, the exponent is tanh(s scale / cap) times cap log2(e)
  const float scale_log2 = LOG2E * (CAP ? cap : scale);
  const float tanh_scale = CAP ? scale / cap : 0.0f;
  flash_fwd<HD, CAP><<<grid, THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, H, G, Sq, Sk, kv_len, causal, scale_log2,
      tanh_scale, so);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// bf16 at a few query rows: the keys split over blocks, then a merge
// ---------------------------------------------------------------------------

namespace split {

using namespace hopper;
using bf16::ex2;
using bf16::LN2;
using bf16::LOG2E;

constexpr int THREADS = 128;
constexpr int TK = 128;         // keys a tile: a thread a key
constexpr int ROWS = 16;        // query rows an item, of the G x Sq rows of its KV head
constexpr int STAGES = 2;       // tiles in flight a block
constexpr int MERGE_WARPS = 4;  // a merge block: one output row, its splits in 4 runs

template <int HD>
struct Cfg {
  using T = bf16::Cfg<HD>;                  // the prefill kernel's boxes and swizzle
  static constexpr int RB = T::RB;          // bytes a swizzled row of a box
  static constexpr int BOX = T::BOX;        // hd values a box
  static constexpr int KV_BYTES = TK * HD * 2;  // one K or V tile, NBOX boxes
  static constexpr int QLD = (HD + 63) / 64 * 64;  // a q row's values: 128-byte aligned rows
  static constexpr int NP = ROWS * HD / 2 / THREADS;  // output column pairs a thread, at most
  // a stage: the K and V tiles, then an item's q rows, in 1024-byte units
  // (the 128-byte swizzle's period)
  __host__ __device__ static constexpr int stage_bytes(int rows) {
    return (2 * KV_BYTES + rows * QLD * 2 + 1023) / 1024 * 1024;
  }
  // the stages, their mbarriers, then in f32 the P V key slices' sums, a
  // tile's logits (then P), each row's m, l and rescale factor; and slack to
  // align the base to 1024
  static constexpr int smem(int rows) {
    return STAGES * stage_bytes(rows) + 8 * STAGES + THREADS * 2 * 4 + rows * (TK + 3) * 4 +
           1024;
  }
  static constexpr int SMEM = smem(ROWS);
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// byte offset of the 16-byte chunk `chunk` (of hd / 8) of row j in a TMA tile
// of TK rows stored as boxes of BOX values with the box's swizzle
template <int HD>
__device__ __forceinline__ uint32_t tile_off(int j, int chunk) {
  using C = Cfg<HD>;
  constexpr int CPB = C::BOX / 8;  // chunks a box row
  const int box = chunk / CPB;
  const int cc = chunk % CPB;
  const int swz = C::RB == 128 ? (j & 7) : ((j >> 1) & 3);
  return box * TK * C::RB + j * C::RB + ((cc ^ swz) << 4);
}

// An item: one split of one group of up to ROWS query rows of a (batch, KV
// head); `tiles` steps of TK keys
struct Item {
  int b, kh, row0, rows, split, k_begin, k_end, tiles;
};

// item `it` of the numbering below (split fastest, then row group, KV head
// and batch)
__device__ __forceinline__ Item item_of(int it, int n_active, int n_rg, int Kh, int R, int chunk,
                                        int k_stop) {
  Item x;
  x.split = it % n_active;
  const int grp = it / n_active;
  const int rg = grp % n_rg;
  x.b = grp / n_rg / Kh;
  x.kh = grp / n_rg % Kh;
  x.row0 = rg * ROWS;
  x.rows = min(ROWS, R - x.row0);
  x.k_begin = x.split * chunk;
  x.k_end = min(x.k_begin + chunk, k_stop);
  x.tiles = (x.k_end - x.k_begin + TK - 1) / TK;
  return x;
}

// Thread 0's load of step (x, tile) into the stage at `st` on mbarrier
// `bar`: the tile's K and V rows (TMA zero-fills past Sk; rows past the
// item's last key are never read) and the item's q rows
template <int HD>
__device__ __forceinline__ void issue_step(uint32_t st, uint32_t bar, const Item& x, int tile,
                                           const CUtensorMap* qmap, const CUtensorMap* kmap,
                                           const CUtensorMap* vmap, int G, int Sq) {
  using C = Cfg<HD>;
  mbar_expect_tx(bar, 2 * C::KV_BYTES + x.rows * HD * 2);
  const int k0 = x.k_begin + tile * TK;
#pragma unroll
  for (int box = 0; box < C::T::NBOX; ++box) {
    tma_load_4d(st + box * TK * C::RB, kmap, bar, box * C::BOX, k0, x.kh, x.b);
    tma_load_4d(st + C::KV_BYTES + box * TK * C::RB, vmap, bar, box * C::BOX, k0, x.kh, x.b);
  }
#pragma unroll 1
  for (int r = 0; r < x.rows; ++r) {
    const int i = x.row0 + r;
    tma_load_4d(st + 2 * C::KV_BYTES + r * C::QLD * 2, qmap, bar, 0, i % Sq, x.kh * G + i / Sq,
                x.b);
  }
}

// The keys of each (batch, KV head) are cut into n_split splits of `chunk`
// keys; an item is one split of one group of up to ROWS query rows (row i of
// KV head kh's G x Sq rows is query head kh G + i / Sq at position i % Sq).
// Items whose keys all lie at or past k_stop (the last key any row sees:
// kv_len > 0, and Sq where causal) add exactly 0 and are not run; the
// others, n_active a group, are numbered split-fastest, and block x takes
// items x, x + gridDim.x, ...  A step is one tile of TK keys of an item.
// Thread 0 keeps STAGES steps' K and V tiles and q rows in flight by TMA,
// each stage completing on its mbarrier, while the block computes one:
// S = the tile's dots (a thread a key, every row), the online softmax (a
// warp a row; m, l across the item's tiles), O = O corr + P V (a thread a
// column pair; where rows x hd / 2 < THREADS the tile's keys are cut into
// up to 4 slices, summed in order).  An item's last step writes its rows'
// (m, l) and unnormalised O in f32.
template <int HD, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)  // 1: ptxas spills at its own target
    flash_fwd_split(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int H, int G, int Sq, int Sk, int kv_len,
                    int causal, float scale_log2, float tanh_scale, int chunk, int n_rg,
                    int n_split, int n_active, int n_items) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_split[];
  const int R = G * Sq;
  const int rmax = R < ROWS ? R : ROWS;  // rows of the largest item
  const int sbytes = C::stage_bytes(rmax);
  const uint32_t base = (smem_u32(smem_split) + 1023) & ~1023u;
  uint8_t* gbase = smem_split + (base - smem_u32(smem_split));
  const uint32_t bars = base + STAGES * sbytes;
  float2* Red = reinterpret_cast<float2*>(gbase + STAGES * sbytes + 8 * STAGES);
  float* Sc = reinterpret_cast<float*>(Red + THREADS);
  float* Ms = Sc + rmax * TK;
  float* Ls = Ms + rmax;
  float* Cs = Ls + rmax;
  const int Kh = H / G;
  const int t = threadIdx.x;
  const bool any_valid = kv_len > 0;
  int k_stop = any_valid ? kv_len : Sk;
  if (causal && any_valid) k_stop = min(k_stop, Sq);

  auto item = [&](int it) { return item_of(it, n_active, n_rg, Kh, R, chunk, k_stop); };

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
    prefetch_tensormap(&qmap);
    prefetch_tensormap(&kmap);
    prefetch_tensormap(&vmap);
  }
  __syncthreads();

  // the load cursor (thread 0) runs STAGES steps ahead of the compute
  // cursor
  int ld_it = blockIdx.x, ld_tile = 0;
  Item ld = item(ld_it < n_items ? ld_it : 0);
  if (t == 0) {
#pragma unroll 1
    for (int s = 0; s < STAGES && ld_it < n_items; ++s) {
      issue_step<HD>(base + s * sbytes, bars + 8 * s, ld, ld_tile, &qmap, &kmap, &vmap, G, Sq);
      if (++ld_tile == ld.tiles) {
        ld_tile = 0;
        ld_it += gridDim.x;
        ld = item(ld_it < n_items ? ld_it : 0);
      }
    }
  }

  float acc[C::NP][2];
  int n = 0;  // the block's steps so far
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const Item x = item(it);
    const int rows = x.rows;
    const int pairs = rows * (HD / 2);
    const int ks = pairs * 4 <= THREADS ? 4 : pairs * 2 <= THREADS ? 2 : 1;
    for (int r = t; r < rows; r += THREADS) {  // m, l and O start afresh
      Ms[r] = NEG_INF;
      Ls[r] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < C::NP; ++i) acc[i][0] = acc[i][1] = 0.0f;
    for (int tile = 0; tile < x.tiles; ++tile, ++n) {
      const int slot = n % STAGES;
      const uint8_t* Kg = gbase + slot * sbytes;
      const uint8_t* Vg = Kg + C::KV_BYTES;
      const __nv_bfloat16* Qs = reinterpret_cast<const __nv_bfloat16*>(Kg + 2 * C::KV_BYTES);
      const int k0 = x.k_begin + tile * TK;
      const int nk = min(TK, x.k_end - k0);
      mbar_wait(bars + 8 * slot, (n / STAGES) & 1);

      // S: thread t takes key t of the tile for every row, four rows at a
      // time: the dot in f32 over hd in order, then capped, scaled to log2
      // units and masked as the prefill kernel does
      const int key = k0 + t;
#pragma unroll 1
      for (int r0 = 0; r0 < rows; r0 += 4) {
        float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(Kg + tile_off<HD>(t, c));
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
          float kf[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(k2[e]);
            kf[2 * e] = f.x;
            kf[2 * e + 1] = f.y;
          }
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            if (r0 + rr < rows) {
              const uint4 qraw =
                  *reinterpret_cast<const uint4*>(Qs + (r0 + rr) * C::QLD + 8 * c);
              const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qraw);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(q2[e]);
                dot[rr] = fmaf(f.x, kf[2 * e], dot[rr]);
                dot[rr] = fmaf(f.y, kf[2 * e + 1], dot[rr]);
              }
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int r = r0 + rr;
          if (r < rows) {
            float xv = dot[rr];
            if (CAP) xv = tanh_ex2(xv * tanh_scale);
            const bool valid = key < kv_len && (!causal || key <= (x.row0 + r) % Sq);
            // a slot past the item's keys does not exist: -inf gives it p = 0
            Sc[r * TK + t] = t >= nk ? -INFINITY : valid ? xv * scale_log2 : NEG_INF;
          }
        }
      }
      __syncthreads();

      // the online softmax, a warp a row: m and l updated, P rounded to
      // bf16 (l sums the unrounded p, as the prefill kernel's)
      {
        const int lane = t % 32;
        for (int r = t / 32; r < rows; r += THREADS / 32) {
          float xs[TK / 32];
          float mx = -INFINITY;
#pragma unroll
          for (int u = 0; u < TK / 32; ++u) {
            xs[u] = Sc[r * TK + lane + 32 * u];
            mx = fmaxf(mx, xs[u]);
          }
#pragma unroll
          for (int d = 16; d > 0; d /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
          const float m_old = Ms[r];
          const float m_new = fmaxf(m_old, mx);
          float sum = 0.0f;
#pragma unroll
          for (int u = 0; u < TK / 32; ++u) {
            const float p = ex2(xs[u] - m_new);
            sum += p;
            Sc[r * TK + lane + 32 * u] = round_bf16(p);
          }
#pragma unroll
          for (int d = 16; d > 0; d /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, d);
          __syncwarp();  // every lane has read Ms[r]
          if (lane == 0) {
            const float corr = ex2(m_old - m_new);
            Ms[r] = m_new;
            Ls[r] = Ls[r] * corr + sum;
            Cs[r] = corr;
          }
        }
      }
      __syncthreads();

      // O = O corr + P V over the tile's keys below nk in order; with few
      // column pairs, key slices of TK / ks keys summed in slice order
      if (ks == 1) {
#pragma unroll
        for (int i = 0; i < C::NP; ++i) {
          const int p = t + THREADS * i;
          if (p < pairs) {
            const int r = p / (HD / 2);
            const int c = 2 * (p % (HD / 2));
            const float* pr = Sc + r * TK;
            float o0 = acc[i][0] * Cs[r];
            float o1 = acc[i][1] * Cs[r];
            for (int j = 0; j < nk; ++j) {
              const float2 vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  Vg + tile_off<HD>(j, c / 8) + (c % 8) * 2));
              o0 = fmaf(pr[j], vv.x, o0);
              o1 = fmaf(pr[j], vv.y, o1);
            }
            acc[i][0] = o0;
            acc[i][1] = o1;
          }
        }
      } else {
        const int per = THREADS / ks;  // threads a slice
        const int p = t % per;
        const int sl = t / per;
        if (p < pairs) {
          const int r = p / (HD / 2);
          const int c = 2 * (p % (HD / 2));
          const float* pr = Sc + r * TK;
          float o0 = 0.0f, o1 = 0.0f;
          const int j0 = sl * (TK / ks);
          const int j1 = min(j0 + TK / ks, nk);
          for (int j = j0; j < j1; ++j) {
            const float2 vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                Vg + tile_off<HD>(j, c / 8) + (c % 8) * 2));
            o0 = fmaf(pr[j], vv.x, o0);
            o1 = fmaf(pr[j], vv.y, o1);
          }
          Red[t] = make_float2(o0, o1);
        }
        __syncthreads();
        if (sl == 0 && p < pairs) {
          const int r = p / (HD / 2);
          float2 sum = Red[p];
          for (int w = 1; w < ks; ++w) {
            sum.x += Red[w * per + p].x;
            sum.y += Red[w * per + p].y;
          }
          acc[0][0] = fmaf(acc[0][0], Cs[r], sum.x);
          acc[0][1] = fmaf(acc[0][1], Cs[r], sum.y);
        }
      }
      __syncthreads();  // the step's stage, P and the slices' sums consumed
      if (t == 0 && ld_it < n_items) {
        issue_step<HD>(base + slot * sbytes, bars + 8 * slot, ld, ld_tile, &qmap, &kmap, &vmap, G,
                       Sq);
        if (++ld_tile == ld.tiles) {
          ld_tile = 0;
          ld_it += gridDim.x;
          ld = item(ld_it < n_items ? ld_it : 0);
        }
      }
    }

    // the item's partials of row (b, h, qi) and split s at
    // ((b H + h) Sq + qi) n_split + s; with key slices, the first slice's
    // threads hold O
#pragma unroll
    for (int i = 0; i < C::NP; ++i) {
      const int p = t + THREADS * i;
      if (ks == 1 ? p < pairs : i == 0 && t < pairs) {
        const int ri = x.row0 + p / (HD / 2);
        const long long prow = ((long long)x.b * H + x.kh * G + ri / Sq) * Sq + ri % Sq;
        *reinterpret_cast<float2*>(part_o + (prow * n_split + x.split) * HD +
                                   2 * (p % (HD / 2))) = make_float2(acc[i][0], acc[i][1]);
      }
    }
    for (int r = t; r < rows; r += THREADS) {
      const int ri = x.row0 + r;
      const long long prow = ((long long)x.b * H + x.kh * G + ri / Sq) * Sq + ri % Sq;
      *reinterpret_cast<float2*>(part_ml + (prow * n_split + x.split) * 2) =
          make_float2(Ms[r], Ls[r]);
    }
    __syncthreads();  // m and l read before the next item resets them
  }
  // the merge may launch: it waits for this grid to finish before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// One block an output row: M = max m over the row's active splits; each
// warp sums l and O over its run of consecutive splits in order, each times
// 2^(m - M), and the first warp adds the runs in order; out = O / max(l,
// 1e-30) and the LSE from M and l, as the prefill kernel forms them.  Each
// warp's loads of its run are independent, so they fly together.  Splits at
// or past n_active hold no key any row sees and are not read.
template <int HD>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
    flash_fwd_merge(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Sq,
                    int n_split, int n_active, Strides so) {
  constexpr int NC = (HD + 63) / 64;  // column pairs a lane: 2 lane + 64 i
  // launched early (programmatic dependent launch): wait until the split
  // kernel has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float red_o[MERGE_WARPS][HD];
  __shared__ float red_l[MERGE_WARPS];
  const long long row = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + row * n_split;
  const float* po = part_o + row * n_split * HD;
  float M = NEG_INF;
  for (int s = lane; s < n_active; s += 32) M = fmaxf(M, ml[s].x);
#pragma unroll
  for (int d = 16; d > 0; d /= 2) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, d));
  const int per = (n_active + MERGE_WARPS - 1) / MERGE_WARPS;
  const int s_end = min(n_active, (warp + 1) * per);
  float l = 0.0f;
  float acc[NC][2];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i][0] = acc[i][1] = 0.0f;
#pragma unroll 4
  for (int s = warp * per; s < s_end; ++s) {
    const float2 x = ml[s];
    const float w = ex2(x.x - M);
    l = fmaf(w, x.y, l);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 2 * lane + 64 * i;
      if (c < HD) {
        const float2 y = *reinterpret_cast<const float2*>(po + (long long)s * HD + c);
        acc[i][0] = fmaf(w, y.x, acc[i][0]);
        acc[i][1] = fmaf(w, y.y, acc[i][1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 2 * lane + 64 * i;
    if (c < HD) {
      red_o[warp][c] = acc[i][0];
      red_o[warp][c + 1] = acc[i][1];
    }
  }
  if (lane == 0) red_l[warp] = l;
  __syncthreads();
  if (warp != 0) return;
  l = red_l[0];
#pragma unroll
  for (int w = 1; w < MERGE_WARPS; ++w) l += red_l[w];
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  const long long b = row / ((long long)H * Sq);
  const int h = row / Sq % H;
  const int qi = row % Sq;
  __nv_bfloat16* op = o + b * so.b + h * so.h + (long long)qi * so.s;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 2 * lane + 64 * i;
    if (c < HD) {
      float x0 = red_o[0][c], x1 = red_o[0][c + 1];
#pragma unroll
      for (int w = 1; w < MERGE_WARPS; ++w) {
        x0 += red_o[w][c];
        x1 += red_o[w][c + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(op + c) = __floats2bfloat162_rn(x0 * inv, x1 * inv);
    }
  }
  // M is in log2 units of the scaled (capped) logits, but a row whose keys
  // are all masked keeps the unscaled -1e30 (the reference's -1e30 + log l)
  if (lse != nullptr && lane == 0)
    lse[row] = M == NEG_INF ? NEG_INF + logf(fmaxf(l, 1e-30f))
                            : (M + log2f(fmaxf(l, 1e-30f))) * LN2;
}

// a rank-4 map over q's (B, H, Sq, hd) view with element strides `st` (b,
// h, s, d; d == 1), one row a box, not swizzled
template <int HD>
bool q_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int Sq, int H, int B,
           const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)Sq, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)HD, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, float* part, int B,
           int H, int G, int Sq, int Sk, int kv_len, int causal, float scale, float cap,
           int n_split, int chunk, const long long* st, cudaStream_t stream) {
  using C = Cfg<HD>;
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  if (!q_map<HD>(enc, &qm, q, Sq, H, B, st) ||
      !bf16::make_map<HD>(enc, &km, k, Sk, H / G, B, st + 4, TK) ||
      !bf16::make_map<HD>(enc, &vm, v, Sk, H / G, B, st + 8, TK))
    return static_cast<int>(cudaErrorInvalidValue);
  // the dynamic shared memory above 48 KB, and the largest shared-memory
  // carveout, so the SM keeps as many blocks as it has room for; set once on
  // each device for each specialisation
  static unsigned long long attr_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(attr_set >> dev & 1ull)) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_split<HD, CAP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_fwd_split<HD, CAP>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1ull << dev;
  }
  const int R = G * Sq;
  const int n_rg = (R + ROWS - 1) / ROWS;
  const int rmax = R < ROWS ? R : ROWS;
  // the splits holding a key some row sees
  int k_stop = kv_len > 0 ? kv_len : Sk;
  if (causal && kv_len > 0 && Sq < k_stop) k_stop = Sq;
  const int n_active = (k_stop + chunk - 1) / chunk;
  const long long n_items = (long long)B * (H / G) * n_rg * n_active;
  if (n_items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // persistent blocks: as many as the SMs keep at once, or one an item
  const int smem = C::smem(rmax);
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, flash_fwd_split<HD, CAP>, THREADS, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(n_items < resident ? n_items : resident);
  const Strides so{st[12], st[13], st[14], st[15]};
  const long long rows_total = (long long)B * H * Sq;
  float* part_ml = part + rows_total * n_split * HD;
  // capped, the exponent is tanh(s scale / cap) times cap log2(e)
  const float scale_log2 = LOG2E * (CAP ? cap : scale);
  const float tanh_scale = CAP ? scale / cap : 0.0f;
  flash_fwd_split<HD, CAP><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, part, part_ml, H, G, Sq, Sk, kv_len, causal, scale_log2, tanh_scale, chunk,
      n_rg, n_split, n_active, static_cast<int>(n_items));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the merge as a programmatic dependent launch: its blocks start as the
  // split kernel's last ones finish and wait (griddepcontrol.wait) for its
  // writes, so the launch gap between the two kernels is hidden
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows_total));
  cfg.blockDim = dim3(MERGE_WARPS * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* po = part;
  const float* pml = part_ml;
  auto* out = static_cast<__nv_bfloat16*>(o);
  err = cudaLaunchKernelEx(&cfg, flash_fwd_merge<HD>, po, pml, out, lse, H, Sq, n_split, n_active,
                           so);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

using LaunchFn = int (*)(const void*, const void*, const void*, void*, float*, float*, int, int,
                         int, int, int, int, int, float, float, int, int, const long long*,
                         cudaStream_t);

template <bool CAP>
LaunchFn pick(int hd) {
  switch (hd) {
    case 32:
      return launch<32, CAP>;
    case 64:
      return launch<64, CAP>;
    case 96:
      return launch<96, CAP>;
    case 128:
      return launch<128, CAP>;
    default:
      return nullptr;
  }
}

}  // namespace split

using LaunchFn = int (*)(const void*, const void*, const void*, void*, float*, int, int, int,
                         int, int, int, int, float, float, const long long*, cudaStream_t);

int dynamic_smem(int dtype, int hd) {
  const bool f = dtype == 0;
  switch (hd) {
    case 32:
      return f ? f32::Cfg<32>::SMEM : bf16::Cfg<32>::SMEM;
    case 64:
      return f ? f32::Cfg<64>::SMEM : bf16::Cfg<64>::SMEM;
    case 96:
      return f ? f32::Cfg<96>::SMEM : bf16::Cfg<96>::SMEM;
    case 128:
      return f ? f32::Cfg<128>::SMEM : bf16::Cfg<128>::SMEM;
    default:
      return -1;
  }
}

template <bool CAP>
LaunchFn pick(int dtype, int hd) {
  const bool f = dtype == 0;
  switch (hd) {
    case 32:
      return f ? f32::launch<32, CAP> : bf16::launch<32, CAP>;
    case 64:
      return f ? f32::launch<64, CAP> : bf16::launch<64, CAP>;
    case 96:
      return f ? f32::launch<96, CAP> : bf16::launch<96, CAP>;
    case 128:
      return f ? f32::launch<128, CAP> : bf16::launch<128, CAP>;
    default:
      return nullptr;
  }
}

}  // namespace

// o (B, H, Sq, hd) = attention of q (B, H, Sq, hd) over k, v (B, H / G, Sk, hd).
// `strides` holds 16 element strides: (b, h, s, d) of q, k, v and o in turn.
// dtype: 0 = float32 (any strides), 1 = bfloat16 (d strides 1, the others and
// the pointers 16-byte aligned, o's row stride even); hd in {32, 64, 96, 128};
// 0 <= kv_len <= Sk (Sk when every key is valid); (Sq + 127) / 128 < 65536
// in bfloat16 and (Sq + 31) / 32 < 65536 in float32.
// Logits are scaled by `scale`: 1/sqrt(hd) of the caller's head dim, which is
// smaller than hd when the caller zero-padded q, k and v up to a built size;
// where cap > 0 each scaled logit s becomes cap tanh(s / cap) (cap <= 0: no
// cap).  `lse`: nullptr, or a contiguous (B, H, Sq) float32 buffer that
// receives each row's log-sum-exp of its scaled (capped) logits (natural
// log).
// Launches on `stream` and returns a cudaError_t (0 when the launch was
// accepted).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* o, float* lse, int B, int H, int G, int Sq, int Sk,
                                     int hd, int kv_len, int causal, float scale, float cap,
                                     const long long* strides, void* stream) {
  const bool capped = cap > 0.0f;
  const LaunchFn fn = !(dtype == 0 || dtype == 1) ? nullptr
                      : capped                     ? pick<true>(dtype, hd)
                                                   : pick<false>(dtype, hd);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, lse, B, H, G, Sq, Sk, kv_len, causal, scale, capped ? cap : 0.0f,
            strides, static_cast<cudaStream_t>(stream));
}

// bytes of dynamic shared memory a block of the (dtype, hd) kernel takes
// (-1 for a pair that is not built)
extern "C" int repro_flash_attention_smem(int dtype, int hd) { return dynamic_smem(dtype, hd); }

// The same attention for bfloat16 q, k, v at a few query rows, its keys split
// over blocks: split s takes keys [s chunk, (s + 1) chunk), s < n_split,
// and writes its rows' partial (m, l, O) into `part`, a float32 buffer of
// B H Sq n_split (hd + 2) values; a second kernel merges them in order of s.
// q, k, v as repro_flash_attention's bfloat16 ones (o's last stride 1, its
// row stride even); hd in {32, 64, 96, 128}; n_split chunk >= Sk.
extern "C" int repro_flash_attention_split(const void* q, const void* k, const void* v, void* o,
                                           float* lse, float* part, int B, int H, int G, int Sq,
                                           int Sk, int hd, int kv_len, int causal, float scale,
                                           float cap, int n_split, int chunk,
                                           const long long* strides, void* stream) {
  const bool capped = cap > 0.0f;
  const split::LaunchFn fn = capped ? split::pick<true>(hd) : split::pick<false>(hd);
  if (fn == nullptr || n_split < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, lse, part, B, H, G, Sq, Sk, kv_len, causal, scale, capped ? cap : 0.0f,
            n_split, chunk, strides, static_cast<cudaStream_t>(stream));
}

// bytes of shared memory a block of the split kernel at head dim hd takes
// at most (-1 for a head dim that is not built)
extern "C" int repro_flash_attention_split_smem(int hd) {
  switch (hd) {
    case 32:
      return split::Cfg<32>::SMEM;
    case 64:
      return split::Cfg<64>::SMEM;
    case 96:
      return split::Cfg<96>::SMEM;
    case 128:
      return split::Cfg<128>::SMEM;
    default:
      return -1;
  }
}
