// K3b: backward flash attention for Hopper.
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
// GQA is native: query head h reads KV head h / G.  Head dims 32, 64 and
// 128 are built; the wrapper zero-pads others up to the next one and passes
// the scale of its own.
//
// No atomics: every sum has one owner, so the result is the same bits run
// after run.  A dq block owns query rows of one (batch, head) and loops
// over the key tiles they see; a dk/dv block owns keys of one (batch, KV
// head) and loops over the G query heads of its group and every query tile
// that sees them.  The price of owning every sum is that S and dP are
// computed by both kinds of block: seven products, not the five of a
// backward that adds dq with atomics.  In bf16 that is three launches (a
// row-statistics pass, the dq kernel, the dk/dv kernel), in f32 one.
//
// What bounds it on an H100: at granite-3-2b's training shape (B 8, H 32
// over 8 KV heads, S 2048, hd 64, bf16, causal) the five products of a
// backward are 10 hd operations per kept pair, 344 GFLOP: 0.348 ms at the
// dense bf16 tensor-core peak of 989 TFLOP/s, against ~0.2 GB of inputs and
// outputs, so operations bound it.  The seven products these kernels run
// are 14 hd, 481 GFLOP: 0.487 ms.
//
// bf16 (the training path) runs on the tensor cores, as K3's forward does.
// Both kernels are blocks of 384 threads: two consumer warpgroups and one
// producer warpgroup, which hands most of its registers to the consumers
// (setmaxnreg 24 and 240).  The producer's first thread loads the block's
// own rows once by TMA and streams the other side's tiles through a ring of
// stages, each guarded by a "full" and an "empty" mbarrier, so later tiles
// arrive while one is computed.  The tensor maps are built on the host for
// each call over the strided (B, S, heads, hd) storage, with a 128-byte
// swizzle (two 64-wide boxes at hd 128; a 64-byte swizzle at hd 32); TMA's
// zero fill gives the ragged tails.
//   * `bwd_dq_wgmma`: 128 query rows, 64 a consumer warpgroup; Q and dO
//     loaded once; K and V tiles of BK keys (128 at hd 32 and 64, 64 at hd
//     128, so S, dP, dq and the dS fragment fit in 240 registers) through
//     the ring.  S = Q K^T and dP = dO V^T are SS wgmmas (both operands
//     K-major); dS is rounded to bf16 in registers, where the m64nBK
//     accumulator fragment is the A fragment of dq += dS K, an RS wgmma
//     whose B, the K tile, is read MN-major (transposed).
//   * `bwd_dkdv_wgmma`: 128 keys, 64 a consumer warpgroup; K and V loaded
//     once; for each of the G query heads, the query tiles of BQT rows (64
//     at hd 32 and 64, 32 at hd 128) from the first that sees the block's
//     keys, each with its LSE and delta rows (bulk copies).  S^T = K Q^T and
//     dP^T = V dO^T are SS wgmmas; P^T and dS^T become bf16 A fragments; dv
//     += P^T dO and dk += dS^T Q are RS wgmmas that read the same Q and dO
//     tiles MN-major.  Key blocks with the most query tiles launch first.
// Each consumer issues tile i's S and dP ahead of tile i - 1's
// dS-products, so its exponentials of tile i run while the tensor cores do
// those products; the two warpgroups also overlap each other.  Only the
// tiles that cross the causal diagonal, kv_len or the sequence end are
// masked, in loops of their own: a branch while a wgmma is in flight would
// make ptxas serialise them.  P = exp2(s scale log2(e) - lse log2(e)): the
// row-statistics pass writes lse log2(e) and delta in rows padded to 128,
// the padding's LSE +inf, so a query row past Sq gets P = 0 and needs no
// mask.  What this does about the CUDA-core design it replaced: the
// products run on the tensor cores instead of f32 FMAs (67 against 989
// TFLOP/s); TMA loads whole swizzled bf16 tiles asynchronously, ahead of
// their use, instead of every thread converting one element at a time
// between two __syncthreads; tiles stay bf16 in shared memory, half the
// bytes of f32 staging.  A block still fills an SM (its 384 threads take
// the register file; 129 KB of shared memory for the dq block at hd 64,
// 99 KB for the dk/dv block), but its two consumers and its producer
// overlap one another.  The repeated S and dP stay: they are the price of
// owning every sum.
//
// f32 runs on the tensor cores as 3xTF32, as K3's f32 kernel does: each
// operand split into a TF32 hi part and a TF32 lo part, each product
// lo.hi + hi.lo + hi.hi in three mma.sync m16n8k8 TF32 passes
// (attention_tf32.cuh), a fresh accumulator for each product of a tile
// (the tensor cores' f32 sums round toward zero) added into dq, dk or dv
// by ordinary f32 adds.  tests/test_torch_attention_tf32.py emulates the
// five products so and holds them to the reference's fusedkernel_flash_bwd
// and to jax.vjp at 1e-4 x max |grad|, which one TF32 pass misses.  One
// launch holds both kinds of block, 4 warps each; neither reads what the
// other writes:
//   * a dq block owns 64 query rows of one (batch, head), 16 a warp: Q and
//     dO staged once, K and V tiles of 32 keys through two cp.async stages
//     (16-byte copies where the last dimension is contiguous, 4-byte ones
//     through any other strides).  It forms delta = rowsum(dO o) of its own
//     rows, recomputes S and dP and adds dS K into dq; a warp skips the
//     tiles wholly past its rows' diagonal.
//   * a dk/dv block owns 16 keys of one (batch, KV head), K and V staged
//     once.  Its work is the (query head, 16-row tile) pairs whose rows see
//     the keys: warp w takes pairs w, w + 4, ... and streams their Q, dO, O
//     and LSE rows through two stages of its own, synchronised within the
//     warp alone, so no warp waits for another at a tile.  It forms each
//     tile's delta from O and dO, recomputes S^T and dP^T, and adds P^T dO
//     into dv and dS^T Q into dk; at the end warp 0 adds the four warps'
//     sums in warp order.
// P^T and dS^T go from their accumulators straight into the A operands of
// those products, in the accumulators' k order (attention_tf32.cuh).  At
// lm-100m's training shape (B 4, H 12 over 4 KV heads, S 128, hd 64,
// causal) the launch has 128 dk/dv and 96 dq blocks for 132 SMs.  Its 10 hd
// operations a kept pair take 0.0015 ms as three TF32 passes at 494.5
// TFLOP/s against 0.0025 ms for its 8.4 MB at 3.35 TB/s, so bytes bound it;
// what paces the kernel is latency: the busiest dk/dv warp streams 6 tiles
// (3 heads x 2 of its block's 8), each a chain of dependent mma.syncs and
// exponentials.
//
// The logit cap (K3's, a model's `attn_logit_softcap`): where the caller
// passes cap > 0, the kernels recompute t = tanh(s scale / cap) from each
// pair's dot, P = exp(cap t - lse), and carry the cap's derivative in dS:
//   dS = P (dP - delta) (1 - t^2) scale
// which is the gradient of the capped forward.  The reference's
// `fusedkernel_flash_bwd` leaves 1 - t^2 out (ROADMAP section 3, fault 7), so
// its capped gradients are wrong wherever its flash branch runs; the port's
// agree with autodiff of the capped forward.  t is formed from the unmasked
// dot of every pair (a masked pair still has P = 0, except in a row whose
// keys are all masked, where every key has P = 1 / Sk as in the forward).
// The cap is a template flag, so the uncapped kernels are the code they were
// and no branch runs while a wgmma is in flight.  t comes from `tanhf` in
// f32 and from hopper::tanh_ex2 in bf16 (two special-function operations,
// absolute error ~3e-7; tanh.approx.f32 errs by ~2^-11 relative), formed in
// place of the raw dot in the same element loop as P and dS, so no array
// lives across the loop and the registers stay those of the uncapped
// kernels plus a few scalars.  Each kernel recomputes t (ex2 and rcp) and P
// (ex2), so a capped pair costs six special-function operations, three in
// the dq kernel and three in the dk/dv kernel; an H100 issues 16 a clock per
// SM, 4.18e12 a second, so at granite-3-2b's training shape the floor is
// 6 x 537,133,056 kept pairs / 4.18e12 = 0.771 ms, above the 0.348 ms
// five-product tensor bound.  The row-statistics pass does not depend on
// the cap.

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

// the dynamic shared memory above 48 KB of a dq and a dk/dv kernel, set
// once on each device: bit dev of `set`, a static of the caller's template
// instance, so each specialisation has flags of its own
template <typename DQ, typename DKDV>
cudaError_t allow_smem(unsigned long long& set, DQ dq, int dq_bytes, DKDV dkdv, int dkdv_bytes) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (set >> dev & 1ull) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err == cudaSuccess) set |= 1ull << dev;
  return err;
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores (mma.sync), one launch of dq and dk/dv blocks
// ---------------------------------------------------------------------------

namespace f32 {

using namespace tf32;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows a dq block owns, 16 a warp
constexpr int BK = 32;          // keys a dq block's tile
constexpr int BKV = 16;         // keys a dk/dv block owns
constexpr int BQW = 16;         // query rows of a dk/dv warp's tile

template <int HD>
struct Cfg {
  static constexpr int LD = HD + 4;  // floats a staged row: fragment reads hit 32 banks
  // a dq block: Q and dO, then two stages of a K and a V tile
  static constexpr int SMEM_DQ = (2 * BQ * LD + 4 * BK * LD) * 4;
  // a dk/dv warp's stage: its tile of Q, dO and O rows, their LSE and delta
  static constexpr int STAGE = 3 * BQW * LD + 2 * BQW;
  // a dk/dv block: K and V, then two stages for each warp
  static constexpr int SMEM_KV = (2 * BKV * LD + 2 * WARPS * STAGE) * 4;
  static constexpr int SMEM = SMEM_DQ > SMEM_KV ? SMEM_DQ : SMEM_KV;
  // at hd 128, where dk and dv alone take 128 registers a thread, fewer
  // head-dim steps of S and dP are unrolled at once, and P^T and dS^T are
  // split at each use rather than held split: no spill
  static constexpr bool LEAN = HD > 64;
  static constexpr int UNROLL = LEAN ? 4 : HD / 8;
  // the warps' dk and dv, added at the end, take the stages' room
  static_assert(WARPS * 2 * 32 * HD <= 2 * WARPS * STAGE, "no room for the partial sums");
};

struct Args {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv;
  int B, H, G, Sq, Sk, kv_len, causal;
  int vec;  // bit i: tensor i of q, k, v, o, dout takes 16-byte copies
  float scale, cap;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

// P and dS of the pair (row, key) from its raw dots s = q.k and dp = dO.v.
// MASK: the pair may be masked by kv_len or the causal mask, or lie past Sq
// or Sk (a slot of a staged tile that holds no row or key: p = ds = 0).
// CAP: the logit capped to cap tanh(s scale / cap) and dS times 1 - tanh^2.
template <bool MASK, bool CAP>
__device__ __forceinline__ void pair_grads(float s, float dp, int row, int key, float lse,
                                           float delta, const Args& a, float& p, float& ds) {
  if (MASK && (row >= a.Sq || key >= a.Sk)) {
    p = 0.0f;
    ds = 0.0f;
    return;
  }
  const bool valid = !MASK || (key < a.kv_len && (!a.causal || key <= row));
  if (CAP) {
    const float t = tanhf(s * a.scale / a.cap);
    p = expf((valid ? a.cap * t : NEG_INF) - lse);
    ds = p * (dp - delta) * (1.0f - t * t) * a.scale;
  } else {
    p = expf((valid ? s * a.scale : NEG_INF) - lse);
    ds = p * (dp - delta) * a.scale;
  }
}

// A dq block: 16 query rows a warp of one (batch, head); it loops over the
// key tiles they see, recomputing S and dP, and owns dq of its rows.
template <int HD, bool CAP>
__device__ __forceinline__ void dq_block(const Args& a, float* smem, int idx) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD;
  constexpr int NT = BK / 8;
  constexpr int ND = HD / 8;
  const int BH = a.B * a.H;
  const int q0 = ((a.Sq + BQ - 1) / BQ - 1 - idx / BH) * BQ;  // the most keys first
  const int b = idx % BH / a.H;
  const int h = idx % BH % a.H;
  const int hk = h / a.G;
  const int warp = threadIdx.x / 32;
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  const int w0 = q0 + 16 * warp;
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* KVs = dOs + BQ * LD;  // stage s: K at KVs + 2 s BK LD, V after it

  const bool any_valid = a.kv_len > 0;
  int k_end = any_valid ? a.kv_len : a.Sk;
  if (a.causal && any_valid) k_end = min(k_end, q0 + BQ);
  const int n_tiles = (k_end + BK - 1) / BK;
  const float* kp = a.k + b * a.sk.b + hk * a.sk.h;
  const float* vp = a.v + b * a.sv.b + hk * a.sv.h;
  auto stage_kv = [&](int i) {
    float* Ks = KVs + 2 * (i & 1) * BK * LD;
    stage_rows<HD>(Ks, LD, kp, a.sk.s, a.sk.d, i * BK, BK, a.Sk, a.vec & 2, threadIdx.x,
                   THREADS);
    stage_rows<HD>(Ks + BK * LD, LD, vp, a.sv.s, a.sv.d, i * BK, BK, a.Sk, a.vec & 4,
                   threadIdx.x, THREADS);
    cp_commit();
  };
  stage_rows<HD>(Qs, LD, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, a.sq.d, q0, BQ, a.Sq,
                 a.vec & 1, threadIdx.x, THREADS);
  stage_rows<HD>(dOs, LD, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.s, a.sdo.d, q0, BQ, a.Sq,
                 a.vec & 16, threadIdx.x, THREADS);
  stage_kv(0);

  // the LSE and delta = rowsum(dO o) of this thread's rows w0 + g and w0 + g
  // + 8 (0 past Sq), delta summed over the quad that shares the row
  float lse[2], delta[2];
  const long long rbase = ((long long)b * a.H + h) * a.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    float sum = 0.0f;
    lse[r] = 0.0f;
    if (row < a.Sq) {
      lse[r] = a.lse[rbase + row];
      const float* op = a.o + b * a.so.b + h * a.so.h + (long long)row * a.so.s;
      const float* dp = a.dout + b * a.sdo.b + h * a.sdo.h + (long long)row * a.sdo.s;
      for (int d = t; d < HD; d += 4) sum = fmaf(dp[d * a.sdo.d], op[d * a.so.d], sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[r] = sum;
  }

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  }
  const float* Qw = Qs + 16 * warp * LD;
  const float* dOw = dOs + 16 * warp * LD;
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      stage_kv(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* Ks = KVs + 2 * (i & 1) * BK * LD;
    const float* Vs = Ks + BK * LD;
    const int k0 = i * BK;

    // a tile wholly past the diagonal of the warp's rows adds exactly 0
    // to them (each row has a valid key when kv_len > 0)
    if (a.causal && any_valid && k0 > w0 + 15) {
      __syncthreads();
      continue;
    }
    // S = Q K^T and dP = dO V^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    }
#pragma unroll C::UNROLL
    for (int kk = 0; kk < HD / 8; ++kk) {
      const Split<4> qa = frag_a(Qw + 8 * kk, LD, g, t);
      const Split<4> da = frag_a(dOw + 8 * kk, LD, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma3(s[n], qa, frag_bt(Ks + 8 * n * LD + 8 * kk, LD, g, t));
        mma3(dp[n], da, frag_bt(Vs + 8 * n * LD + 8 * kk, LD, g, t));
      }
    }
    // dS in place of S; a tile is masked only where it crosses kv_len, Sk
    // or the diagonal of one of the warp's rows
    const bool mask = k0 + BK > a.kv_len || (a.causal && k0 + BK - 1 > w0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = w0 + g + 8 * (e >> 1);
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        float p, ds;
        if (mask)
          pair_grads<true, CAP>(s[n][e], dp[n][e], row, key, lse[e >> 1], delta[e >> 1], a, p,
                                ds);
        else
          pair_grads<false, CAP>(s[n][e], dp[n][e], row, key, lse[e >> 1], delta[e >> 1], a, p,
                                 ds);
        s[n][e] = ds;
      }
    }
    // dq += dS K, each 8 columns a fresh accumulator over the tile's keys
    Split<4> dsa[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) dsa[n] = frag_a(s[n]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NT; ++n) mma3(part, dsa[n], frag_b(Ks + 8 * n * LD + 8 * nd, LD, g, t));
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[nd][e] += part[e];
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row < a.Sq) {
      float* out = a.dq + b * a.sdq.b + h * a.sdq.h + (long long)row * a.sdq.s;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        out[(8 * nd + 2 * t) * a.sdq.d] = dq[nd][2 * r];
        out[(8 * nd + 2 * t + 1) * a.sdq.d] = dq[nd][2 * r + 1];
      }
    }
  }
}

// A dk/dv block: 16 keys of one (batch, KV head), owning dk and dv of
// them.  Its work is the (query head of the group, 16-row tile) pairs whose
// rows see the keys; warp w takes pairs w, w + WARPS, ... and streams its
// own tiles through two stages of its own (its lanes synchronise only with
// each other), and at the end warp 0 adds the warps' sums in warp order.
template <int HD, bool CAP>
__device__ __forceinline__ void dkdv_block(const Args& a, float* smem, int idx) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD;
  constexpr int ND = HD / 8;
  const int KV = a.H / a.G;
  const int BKH = a.B * KV;
  const int k0 = idx / BKH * BKV;  // the most query rows first when causal
  const int b = idx % BKH / KV;
  const int hk = idx % BKH % KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  float* Ks = smem;
  float* Vs = Ks + BKV * LD;
  float* stages = Vs + BKV * LD;
  float* mine = stages + 2 * warp * C::STAGE;  // this warp's two stages: Q, dO, O, LSE, delta

  stage_rows<HD>(Ks, LD, a.k + b * a.sk.b + hk * a.sk.h, a.sk.s, a.sk.d, k0, BKV, a.Sk,
                 a.vec & 2, threadIdx.x, THREADS);
  stage_rows<HD>(Vs, LD, a.v + b * a.sv.b + hk * a.sv.h, a.sv.s, a.sv.d, k0, BKV, a.Sk,
                 a.vec & 4, threadIdx.x, THREADS);
  cp_commit();
  // with a valid key in every row, keys at or past kv_len get nothing, and
  // under the causal mask rows before k0 see none of these keys
  const bool any_valid = a.kv_len > 0;
  const bool none = any_valid && k0 >= a.kv_len;
  const int first = (a.causal && any_valid) ? k0 / BQW * BQW : 0;
  const int per_head = none || first >= a.Sq ? 0 : (a.Sq - first + BQW - 1) / BQW;
  const int n_items = a.G * per_head;
  auto stage_item = [&](int it, int j) {
    float* S = mine + (j & 1) * C::STAGE;
    const int h = hk * a.G + it / per_head;
    const int r0 = first + it % per_head * BQW;
    stage_rows<HD>(S, LD, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, a.sq.d, r0, BQW, a.Sq,
                   a.vec & 1, lane, 32);
    stage_rows<HD>(S + BQW * LD, LD, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.s, a.sdo.d, r0,
                   BQW, a.Sq, a.vec & 16, lane, 32);
    stage_rows<HD>(S + 2 * BQW * LD, LD, a.o + b * a.so.b + h * a.so.h, a.so.s, a.so.d, r0,
                   BQW, a.Sq, a.vec & 8, lane, 32);
    const float* lp = a.lse + ((long long)b * a.H + h) * a.Sq;
    if (lane < BQW) {
      const bool ok = r0 + lane < a.Sq;
      cp_async4(S + 3 * BQW * LD + lane, ok ? lp + r0 + lane : lp, ok ? 4 : 0);
    }
    cp_commit();
  };
  if (warp < n_items)
    stage_item(warp, 0);
  else
    cp_commit();  // an empty group, so the wait below covers K and V
  cp_wait<1>();  // K and V, by this thread
  __syncthreads();  // ... and by every thread

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  }
  for (int it = warp, j = 0; it < n_items; it += WARPS, ++j) {
    if (it + WARPS < n_items) {
      stage_item(it + WARPS, j + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();  // the tile staged by every lane of the warp
    float* S = mine + (j & 1) * C::STAGE;
    const float* Qt = S;
    const float* dOt = Qt + BQW * LD;
    const float* Ot = dOt + BQW * LD;
    const float* lse_t = S + 3 * BQW * LD;
    float* delta_t = S + 3 * BQW * LD + BQW;
    const int r0 = first + it % per_head * BQW;

    // delta of the tile's rows, two lanes a row, in four partial sums each
    {
      const int r = lane / 2;
      const int d0 = lane % 2 * (HD / 2);
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int d = 0; d < HD / 2; d += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          part[u] = fmaf(dOt[r * LD + d0 + d + u], Ot[r * LD + d0 + d + u], part[u]);
      }
      float sum = (part[0] + part[1]) + (part[2] + part[3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (lane % 2 == 0) delta_t[r] = sum;
    }
    __syncwarp();

    // S^T = K Q^T and dP^T = V dO^T: the 16 keys by the tile's 16 rows
    float st[2][4], dpt[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
    }
#pragma unroll C::UNROLL
    for (int kk = 0; kk < HD / 8; ++kk) {
      const Split<4> ka = frag_a(Ks + 8 * kk, LD, g, t);
      const Split<4> va = frag_a(Vs + 8 * kk, LD, g, t);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma3(st[n], ka, frag_bt(Qt + 8 * n * LD + 8 * kk, LD, g, t));
        mma3(dpt[n], va, frag_bt(dOt + 8 * n * LD + 8 * kk, LD, g, t));
      }
    }
    // P^T in place of S^T, dS^T in place of dP^T
    const bool mask = r0 + BQW > a.Sq || k0 + BKV > a.kv_len || (a.causal && k0 + BKV - 1 > r0);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + g + 8 * (e >> 1);
        const int rr = 8 * n + 2 * t + (e & 1);  // the row within the tile
        float p, ds;
        if (mask)
          pair_grads<true, CAP>(st[n][e], dpt[n][e], r0 + rr, key, lse_t[rr], delta_t[rr], a,
                                p, ds);
        else
          pair_grads<false, CAP>(st[n][e], dpt[n][e], r0 + rr, key, lse_t[rr], delta_t[rr], a,
                                 p, ds);
        st[n][e] = p;
        dpt[n][e] = ds;
      }
    }
    // dv += P^T dO and dk += dS^T Q, each 8 columns a fresh accumulator over
    // the tile's 16 rows
    Split<4> pa[2], dsa[2];
    if (!C::LEAN) {
      pa[0] = frag_a(st[0]);
      pa[1] = frag_a(st[1]);
      dsa[0] = frag_a(dpt[0]);
      dsa[1] = frag_a(dpt[1]);
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float pk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma3(pv, C::LEAN ? frag_a(st[n]) : pa[n], frag_b(dOt + 8 * n * LD + 8 * nd, LD, g, t));
        mma3(pk, C::LEAN ? frag_a(dpt[n]) : dsa[n], frag_b(Qt + 8 * n * LD + 8 * nd, LD, g, t));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv[nd][e] += pv[e];
        dk[nd][e] += pk[e];
      }
    }
    __syncwarp();  // the stage is read: the next prefetch may take it
  }

  // the warps' dk and dv into the stages' room, then warp 0 adds them in
  // warp order and stores them
  cp_wait<0>();
  __syncthreads();
  float* part = stages + warp * 2 * 32 * HD;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      part[(4 * nd + e) * 32 + lane] = dk[nd][e];
      part[32 * HD + (4 * nd + e) * 32 + lane] = dv[nd][e];
    }
  }
  __syncthreads();
  if (warp > 0) return;
  for (int w = 1; w < WARPS; ++w) {
    const float* theirs = stages + w * 2 * 32 * HD;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[nd][e] += theirs[(4 * nd + e) * 32 + lane];
        dv[nd][e] += theirs[32 * HD + (4 * nd + e) * 32 + lane];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + g + 8 * r;
    if (key < a.Sk) {
      float* dkp = a.dk + b * a.sdk.b + hk * a.sdk.h + (long long)key * a.sdk.s;
      float* dvp = a.dv + b * a.sdv.b + hk * a.sdv.h + (long long)key * a.sdv.s;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          dkp[(8 * nd + 2 * t + j) * a.sdk.d] = dk[nd][2 * r + j];
          dvp[(8 * nd + 2 * t + j) * a.sdv.d] = dv[nd][2 * r + j];
        }
      }
    }
  }
}

// One launch: blocks [0, n_kv) are dk/dv blocks, the rest dq blocks.
// Neither kind reads what the other writes, so they need no order.
template <int HD, bool CAP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_tf32(const Args a, int n_kv) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < n_kv)
    dkdv_block<HD, CAP>(a, smem, blockIdx.x);
  else
    dq_block<HD, CAP>(a, smem, blockIdx.x - n_kv);
}

template <int HD, bool CAP>
int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<HD>;
  static unsigned long long smem_set = 0;
  const cudaError_t err =
      allow_smem(smem_set, flash_bwd_tf32<HD, CAP>, C::SMEM, flash_bwd_tf32<HD, CAP>, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_kv = (long long)a.B * (a.H / a.G) * ((a.Sk + BKV - 1) / BKV);
  const long long n_dq = (long long)a.B * a.H * ((a.Sq + BQ - 1) / BQ);
  if (n_kv + n_dq > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_tf32<HD, CAP><<<(unsigned)(n_kv + n_dq), THREADS, C::SMEM, stream>>>(a, (int)n_kv);
  return static_cast<int>(cudaGetLastError());
}

template <bool CAP>
int run(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32, CAP>(a, stream);
    case 64:
      return launch<64, CAP>(a, stream);
    case 128:
      return launch<128, CAP>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BQ = 128;                         // query rows a dq block owns
constexpr int BKV = 128;                        // keys a dk/dv block owns
constexpr int DQ_STAGES = 3;                    // K/V tiles in flight
constexpr int DKDV_STAGES = 4;                  // Q/dO tiles in flight
constexpr int CONSUMERS = 2;                    // warpgroups of 64 rows or keys
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and one producer warpgroup
// registers a thread of each role keeps (setmaxnreg): the producer gives
// its share to the consumers, 128 * 24 + 256 * 240 = 384 * 168, what the
// block starts with
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int RB = HD >= 64 ? 128 : 64;  // bytes per swizzled row of a box
  static constexpr int BOX = RB / 2;              // hd values per box
  static constexpr int NBOX = HD / BOX;           // boxes per row: 1, 1, 2
  static constexpr uint32_t SWIZZLE = RB == 128 ? SWIZZLE_128B : SWIZZLE_64B;
  static constexpr int BK = HD > 64 ? 64 : 128;   // keys per tile of the dq kernel
  static constexpr int BQT = HD > 64 ? 32 : 64;   // query rows per tile of the dk/dv kernel
  static constexpr int OWN = BQ * HD * 2;         // Q or dO of a dq block, K or V of a dk/dv one
  static constexpr int K_TILE = BK * HD * 2;      // one K or V tile
  static constexpr int Q_TILE = BQT * HD * 2;     // one Q or dO tile
  static constexpr int RS_TILE = 2 * BQT * 4;     // the LSE and delta rows of a Q tile
  // the block's own rows, the ring, room for the mbarriers, and slack to
  // align the base to the 1024 bytes a 128-byte swizzle repeats
  static constexpr int SMEM_DQ = 2 * OWN + 2 * DQ_STAGES * K_TILE + 128 + 1024;
  static constexpr int SMEM_DKDV =
      2 * OWN + DKDV_STAGES * (2 * Q_TILE + RS_TILE) + 128 + 1024;
};
static_assert(BQ == BKV, "the block's own rows take the same room in both kernels");

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
// column 8 n + 2 (t % 4) + j).  Its k16 slice c, rounded to bf16 pairwise
// (x[8c + 2r], x[8c + 2r + 1]) -> a[c][r], is the A fragment of an RS wgmma.
template <int NS>
__device__ __forceinline__ void to_a_fragment(uint32_t (&a)[NS / 8][4], const float (&x)[NS]) {
#pragma unroll
  for (int c = 0; c < NS / 8; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[c][r] = pack_bf16(x[8 * c + 2 * r], x[8 * c + 2 * r + 1]);
  }
}

// d = A B^T over the HD / 16 k16 steps of the head dim, both operands
// K-major in shared memory: A's 64 rows at `a` in boxes A_ROWS rows apart,
// B's NS / 2 rows at `b` in boxes B_ROWS rows apart; a step's 32 bytes sit
// within one swizzled row of a box.  Each descriptor is its operand's base
// plus the step's offset (in the address field, 16-byte units): with the
// descriptors built whole for each step, ptxas spilled the hd 128 dk/dv
// kernel.
template <int HD, int A_ROWS, int B_ROWS, int NS>
__device__ __forceinline__ void ss_product(float (&d)[NS], uint32_t a, uint32_t b) {
  using C = Cfg<HD>;
  const uint64_t da = make_desc(a, 16, 8 * C::RB, C::SWIZZLE);
  const uint64_t db = make_desc(b, 16, 8 * C::RB, C::SWIZZLE);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int box = kk * 32 / C::RB;
    const int off = (kk * 32) % C::RB;
    wgmma_ss(d, da + ((box * A_ROWS * C::RB + off) >> 4),
             db + ((box * B_ROWS * C::RB + off) >> 4), kk > 0);
  }
}

// d += A B over the ROWS / 16 k16 steps of a tile of ROWS rows: A from
// registers (its k16 slices in a), B the tile at `b` read MN-major
// (transposed); at hd 128 the two boxes of a row are one leading offset apart
template <int HD, int ROWS>
__device__ __forceinline__ void rs_product(float (&d)[HD / 2], const uint32_t (&a)[ROWS / 16][4],
                                           uint32_t b) {
  using C = Cfg<HD>;
  const uint64_t db = make_desc(b, ROWS * C::RB, 8 * C::RB, C::SWIZZLE);
#pragma unroll
  for (int c = 0; c < ROWS / 16; ++c) wgmma_rs(d, a[c], db + ((16 * c * C::RB) >> 4));
}

// dq's tile: s holds S (raw dots, rows x keys), dp dP; afterwards s holds dS.
// lse2 = lse log2(e) and delta of this thread's rows row0 and row0 + 8.
// MASK: logits of masked keys become -1e30 (scaled).  CAP: t = tanh(s
// tanh_scale) (tanh_scale = scale / cap) in place of the dot, `scale_log2` is
// cap log2(e), and dS carries 1 - t^2.
template <bool MASK, bool CAP, int NS>
__device__ __forceinline__ void dq_grads(float (&s)[NS], const float (&dp)[NS],
                                         const float (&lse2)[2], const float (&delta)[2],
                                         float scale_log2, float tanh_scale, float scale,
                                         float neg2, int row0, int key0, int kv_len,
                                         int causal) {
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    const int i = (e >> 1) & 1;
    const float t = CAP ? tanh_ex2(s[e] * tanh_scale) : s[e];
    float x = fmaf(t, scale_log2, -lse2[i]);
    if (MASK) {
      const int row = row0 + 8 * i;
      const int key = key0 + 8 * (e >> 2) + (e & 1);
      const bool valid = key < kv_len && (!causal || key <= row);
      x = valid ? x : neg2 - lse2[i];
    }
    if (CAP)
      s[e] = ex2(x) * (dp[e] - delta[i]) * fmaf(-t, t, 1.0f) * scale;
    else
      s[e] = ex2(x) * (dp[e] - delta[i]) * scale;
  }
}

// dk/dv's tile: s holds S^T (keys x query rows), dp dP^T; afterwards s holds
// P^T and dp dS^T.  `rs` points at this thread's first column of the tile's
// lse2 row, the tile's delta row BQT floats later.  CAP as in dq_grads.
template <bool MASK, bool CAP, int NS>
__device__ __forceinline__ void dkdv_grads(float (&s)[NS], float (&dp)[NS], const float* rs,
                                           float scale_log2, float tanh_scale, float scale,
                                           float neg2, int key0, int row0, int kv_len,
                                           int causal) {
  constexpr int BQT = 2 * NS;
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(rs + 8 * n);
    const float2 dl = *reinterpret_cast<const float2*>(rs + BQT + 8 * n);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * n + 2 * i + j;
        const float lse2 = j ? l2.y : l2.x;
        const float t = CAP ? tanh_ex2(s[e] * tanh_scale) : s[e];
        float x = fmaf(t, scale_log2, -lse2);
        if (MASK) {
          const int key = key0 + 8 * i;
          const int row = row0 + 8 * n + j;
          const bool valid = key < kv_len && (!causal || key <= row);
          x = valid ? x : neg2 - lse2;
        }
        const float p = ex2(x);
        if (CAP)
          dp[e] = p * (dp[e] - (j ? dl.y : dl.x)) * fmaf(-t, t, 1.0f) * scale;
        else
          dp[e] = p * (dp[e] - (j ? dl.y : dl.x)) * scale;
        s[e] = p;
      }
    }
  }
}

// lse2 = lse log2(e) and delta = rowsum(dO * O) for each row of the padded
// (B * H, Sq_pad) layout; a row past Sq gets lse2 = +inf (so its P is 0)
// and delta 0.  A group of HD / 8 lanes takes a row, each lane 8 values: one
// 16-byte load of o and of dout where `vec` says both allow it (d stride 1,
// the rows and bases 16-byte aligned), else 8 loads through the strides.
template <int HD>
__global__ void __launch_bounds__(256)
    bwd_rowstats(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ lse2,
                 float* __restrict__ delta, int H, int Sq, int Sq_pad, Strides so, Strides sdo,
                 int vec) {
  constexpr int L = HD / 8;         // lanes a row
  constexpr int ROWS = 256 / L;     // rows a block: 64, 32 or 16, dividing Sq_pad
  const int per_head = Sq_pad / ROWS;
  const int bh = blockIdx.x / per_head;
  const int row = (blockIdx.x % per_head) * ROWS + threadIdx.x / L;
  const int part = threadIdx.x % L;
  const bool live = row < Sq;
  float sum = 0.0f;
  if (live) {
    const int b = bh / H;
    const int h = bh % H;
    const __nv_bfloat16* op = o + b * so.b + h * so.h + row * so.s + 8 * part * so.d;
    const __nv_bfloat16* dp = dout + b * sdo.b + h * sdo.h + row * sdo.s + 8 * part * sdo.d;
    if (vec) {
      const uint4 x = *reinterpret_cast<const uint4*>(op);
      const uint4 y = *reinterpret_cast<const uint4*>(dp);
      const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(xs[e]);
        const float2 c = __bfloat1622float2(ys[e]);
        sum = fmaf(a.y, c.y, fmaf(a.x, c.x, sum));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sum = fmaf(__bfloat162float(op[e * so.d]), __bfloat162float(dp[e * sdo.d]), sum);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0) {
    const long long r = (long long)bh * Sq_pad + row;
    delta[r] = live ? sum : 0.0f;
    lse2[r] = live ? __fmul_rn(lse[(long long)bh * Sq + row], LOG2E) : INFINITY;
  }
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap dmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const float* __restrict__ lse2,
                 const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int G,
                 int Sq, int Sk, int Sq_pad, int kv_len, int causal, float scale,
                 float scale_log2, float tanh_scale, Strides sdq) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  constexpr int ST = DQ_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + C::OWN;
  const uint32_t sKV = sdO + C::OWN;  // stage s: K at sKV + 2 s K_TILE, V after it
  const uint32_t bars = sKV + 2 * ST * C::K_TILE;
  const uint32_t own_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

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
    mbar_init(own_full, 1);
    for (int s = 0; s < ST; ++s) {
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
      prefetch_tensormap(&dmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      mbar_expect_tx(own_full, 2 * C::OWN);
      for (int r = 0; r < C::NBOX; ++r) {
        tma_load_4d(sQ + r * BQ * C::RB, &qmap, own_full, r * C::BOX, q0, h, b);
        tma_load_4d(sdO + r * BQ * C::RB, &dmap, own_full, r * C::BOX, q0, h, b);
      }
      const int hk = h / G;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty(s), ((i / ST) - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::K_TILE);
        const uint32_t sK = sKV + 2 * s * C::K_TILE;
        for (int r = 0; r < C::NBOX; ++r) {
          tma_load_4d(sK + r * BK * C::RB, &kmap, full(s), r * C::BOX, i * BK, hk, b);
          tma_load_4d(sK + C::K_TILE + r * BK * C::RB, &vmap, full(s), r * C::BOX, i * BK, hk,
                      b);
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
  const long long rbase = ((long long)b * H + h) * Sq_pad;   // rows below Sq_pad: in range
  const float l2[2] = {lse2[rbase + row0], lse2[rbase + row0 + 8]};
  const float dl[2] = {delta[rbase + row0], delta[rbase + row0 + 8]};
  const float neg2 = __fmul_rn(NEG_INF, LOG2E);  // a masked logit, as lse2 of a row of them
  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.0f;
  float sacc[BK / 2];
  float dpacc[BK / 2];
  uint32_t frag[BK / 16][4];  // dS of the previous tile, bf16 pairs

  // S = Q K^T and dP = dO V^T for tile i
  auto issue_sdp = [&](int i) {
    const uint32_t sK = sKV + 2 * (i % ST) * C::K_TILE;
    mbar_wait(full(i % ST), (i / ST) & 1);
    wgmma_fence();
    ss_product<HD, BQ, BK>(sacc, sQ + 64 * wg * C::RB, sK);
    ss_product<HD, BQ, BK>(dpacc, sdO + 64 * wg * C::RB, sK + C::K_TILE);
    wgmma_commit();
  };
  // dq += dS K for tile i, dS from registers, the K tile read MN-major
  auto issue_dq = [&](int i) {
    rs_product<HD, BK>(acc, frag, sKV + 2 * (i % ST) * C::K_TILE);
    wgmma_commit();
  };
  // Tile i > 0, software-pipelined: S and dP of tile i are issued ahead of
  // dq's product of tile i - 1, and tile i's dS is computed while the
  // tensor cores do that product.  Nothing branches while it is in flight
  // (ptxas would serialise the wgmmas), so the masked and unmasked tiles run
  // in two loops.
  auto pipelined = [&](int i, auto mask) {
    issue_sdp(i);
    issue_dq(i - 1);
    wgmma_wait<1>();  // S and dP done; dq's product of tile i - 1 may still run
    reg_fence(sacc);
    reg_fence(dpacc);
    dq_grads<decltype(mask)::value, CAP>(sacc, dpacc, l2, dl, scale_log2, tanh_scale, scale,
                                         neg2, row0, i * BK + col0, kv_len, causal);
    wgmma_wait<0>();  // tile i - 1 is done: its stage and frag are free
    reg_fence(acc);
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) reg_fence(frag[c]);
    if (lane == 0) mbar_arrive(empty((i - 1) % ST));
    to_a_fragment(frag, sacc);
  };

  // tiles [0, n_plain) need no mask: all their keys are below kv_len and
  // at or before every row of this warpgroup
  int n_plain = 0;
  if (any_valid) n_plain = min(n_tiles, causal ? min(kv_len, wg_first + 1) / BK : kv_len / BK);

  mbar_wait(own_full, 0);
  issue_sdp(0);
  wgmma_wait<0>();
  reg_fence(sacc);
  reg_fence(dpacc);
  if (n_plain > 0)
    dq_grads<false, CAP>(sacc, dpacc, l2, dl, scale_log2, tanh_scale, scale, neg2, row0, col0,
                         kv_len, causal);
  else
    dq_grads<true, CAP>(sacc, dpacc, l2, dl, scale_log2, tanh_scale, scale, neg2, row0, col0,
                        kv_len, causal);
  to_a_fragment(frag, sacc);
  for (int i = 1; i < n_plain; ++i) pipelined(i, std::false_type());
  for (int i = max(1, n_plain); i < n_tiles; ++i) pipelined(i, std::true_type());
  wgmma_fence();
  issue_dq(n_tiles - 1);
  wgmma_wait<0>();
  reg_fence(acc);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row < Sq) {
      __nv_bfloat16* p = dq + b * sdq.b + h * sdq.h + (long long)row * sdq.s + col0;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    }
  }
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap dmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const float* __restrict__ lse2,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int G, int Sq, int Sk, int Sq_pad,
                   int kv_len, int causal, float scale, float scale_log2, float tanh_scale,
                   Strides sdk, Strides sdv) {
  using C = Cfg<HD>;
  constexpr int BQT = C::BQT;
  constexpr int ST = DKDV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + C::OWN;
  const uint32_t sQD = sV + C::OWN;  // stage s: Q at sQD + 2 s Q_TILE, dO after it
  const uint32_t sRS = sQD + 2 * ST * C::Q_TILE;  // stage s: lse2 and delta rows
  const uint32_t bars = sRS + ST * C::RS_TILE;
  const uint32_t own_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  const int KV = H / G;
  const int b = blockIdx.x / KV;
  const int hk = blockIdx.x % KV;
  const int k0 = blockIdx.y * BKV;  // the most query tiles first when causal
  const bool any_valid = kv_len > 0;
  // with a valid key in every row, keys at or past kv_len get nothing, and
  // under the causal mask rows before k0 see none of these keys
  const int first = (causal && any_valid) ? k0 / BQT : 0;
  const int n_per = (any_valid && k0 >= kv_len) ? 0 : max(0, (Sq + BQT - 1) / BQT - first);
  const int n_tiles = G * n_per;  // head g's tiles are [g n_per, (g + 1) n_per)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0 && n_tiles > 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&dmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      mbar_expect_tx(own_full, 2 * C::OWN);
      for (int r = 0; r < C::NBOX; ++r) {
        tma_load_4d(sK + r * BKV * C::RB, &kmap, own_full, r * C::BOX, k0, hk, b);
        tma_load_4d(sV + r * BKV * C::RB, &vmap, own_full, r * C::BOX, k0, hk, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        const int g = i / n_per;
        const int j = first + i - g * n_per;
        const int h = hk * G + g;
        if (i >= ST) mbar_wait(empty(s), ((i / ST) - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::Q_TILE + C::RS_TILE);
        const uint32_t sq = sQD + 2 * s * C::Q_TILE;
        for (int r = 0; r < C::NBOX; ++r) {
          tma_load_4d(sq + r * BQT * C::RB, &qmap, full(s), r * C::BOX, j * BQT, h, b);
          tma_load_4d(sq + C::Q_TILE + r * BQT * C::RB, &dmap, full(s), r * C::BOX, j * BQT, h,
                      b);
        }
        // rows of Sq_pad (a multiple of 128) padded: in range and 16-byte aligned
        const long long row = ((long long)b * H + h) * Sq_pad + (long long)j * BQT;
        bulk_load(sRS + s * C::RS_TILE, lse2 + row, BQT * 4, full(s));
        bulk_load(sRS + s * C::RS_TILE + BQT * 4, delta + row, BQT * 4, full(s));
      }
    }
    return;
  }

  // a consumer warpgroup: 64 keys
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int kw = k0 + 64 * wg;
  const int key0 = kw + 16 * (t / 32) + (t % 32) / 4;  // and key0 + 8
  const int col0 = 2 * (t % 4);
  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) dk_acc[e] = dv_acc[e] = 0.0f;

  if (n_tiles > 0) {
    const float neg2 = __fmul_rn(NEG_INF, LOG2E);
    // the first n_mask tiles of each head cross this warpgroup's diagonal or
    // kv_len; the rest see every one of its keys from every row
    int n_mask = n_per;
    if (any_valid && kw + 64 <= kv_len)
      n_mask = causal ? min(n_per, max(0, (kw + 63 + BQT - 1) / BQT - first)) : 0;
    const float* rs_base =
        reinterpret_cast<const float*>(smem_raw + (sRS - smem_u32(smem_raw))) + col0;
    float sacc[BQT / 2];
    float dpacc[BQT / 2];
    uint32_t pf[BQT / 16][4];  // P^T of the previous tile, bf16 pairs
    uint32_t df[BQT / 16][4];  // dS^T of the previous tile

    // S^T = K Q^T and dP^T = V dO^T for tile i
    auto issue_sdp = [&](int i) {
      const uint32_t sq = sQD + 2 * (i % ST) * C::Q_TILE;
      mbar_wait(full(i % ST), (i / ST) & 1);
      wgmma_fence();
      ss_product<HD, BKV, BQT>(sacc, sK + 64 * wg * C::RB, sq);
      ss_product<HD, BKV, BQT>(dpacc, sV + 64 * wg * C::RB, sq + C::Q_TILE);
      wgmma_commit();
    };
    // dv += P^T dO and dk += dS^T Q for tile i, the Q and dO tiles read
    // MN-major
    auto issue_dkdv = [&](int i) {
      const uint32_t sq = sQD + 2 * (i % ST) * C::Q_TILE;
      rs_product<HD, BQT>(dv_acc, pf, sq + C::Q_TILE);
      rs_product<HD, BQT>(dk_acc, df, sq);
      wgmma_commit();
    };
    auto grads = [&](int i, auto mask) {
      const int j = first + i % n_per;
      dkdv_grads<decltype(mask)::value, CAP>(sacc, dpacc,
                                             rs_base + (i % ST) * (C::RS_TILE / 4), scale_log2,
                                             tanh_scale, scale, neg2, key0, j * BQT + col0,
                                             kv_len, causal);
    };
    auto pack = [&]() {
      to_a_fragment(pf, sacc);
      to_a_fragment(df, dpacc);
    };
    // as in the dq kernel: tile i's S^T and dP^T ahead of tile i - 1's dk
    // and dv products, masked and unmasked tiles in loops of their own
    auto pipelined = [&](int i, auto mask) {
      issue_sdp(i);
      issue_dkdv(i - 1);
      wgmma_wait<1>();
      reg_fence(sacc);
      reg_fence(dpacc);
      grads(i, mask);
      wgmma_wait<0>();
      reg_fence(dk_acc);
      reg_fence(dv_acc);
#pragma unroll
      for (int c = 0; c < BQT / 16; ++c) {
        reg_fence(pf[c]);
        reg_fence(df[c]);
      }
      if (lane == 0) mbar_arrive(empty((i - 1) % ST));
      pack();
    };

    mbar_wait(own_full, 0);
    issue_sdp(0);
    wgmma_wait<0>();
    reg_fence(sacc);
    reg_fence(dpacc);
    if (n_mask > 0)
      grads(0, std::true_type());
    else
      grads(0, std::false_type());
    pack();
    for (int g = 0; g < G; ++g) {
      const int i0 = g * n_per;
      for (int jj = g == 0 ? 1 : 0; jj < n_mask; ++jj) pipelined(i0 + jj, std::true_type());
      for (int jj = max(n_mask, g == 0 ? 1 : 0); jj < n_per; ++jj)
        pipelined(i0 + jj, std::false_type());
    }
    wgmma_fence();
    issue_dkdv(n_tiles - 1);
    wgmma_wait<0>();
    reg_fence(dk_acc);
    reg_fence(dv_acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key < Sk) {
      __nv_bfloat16* pk = dk + b * sdk.b + hk * sdk.h + (long long)key * sdk.s + col0;
      __nv_bfloat16* pv = dv + b * sdv.b + hk * sdv.h + (long long)key * sdv.s + col0;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(pk + 8 * n) =
            __floats2bfloat162_rn(dk_acc[4 * n + 2 * i], dk_acc[4 * n + 2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(pv + 8 * n) =
            __floats2bfloat162_rn(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
      }
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

// the three launches; `scratch` holds lse2 and then delta, B H Sq_pad floats
// each.  st: the 32 strides of the C entry point.
template <int HD, bool CAP>
int run(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int H, int G,
        int Sq, int Sk, int kv_len, int causal, float scale, float cap, const long long* st,
        cudaStream_t stream) {
  using C = Cfg<HD>;
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int KV = H / G;
  CUtensorMap q_dq, d_dq, k_dq, v_dq, q_kv, d_kv, k_kv, v_kv;
  if (!make_map<HD>(enc, &q_dq, q, Sq, H, B, st, BQ) ||
      !make_map<HD>(enc, &d_dq, dout, Sq, H, B, st + 16, BQ) ||
      !make_map<HD>(enc, &k_dq, k, Sk, KV, B, st + 4, C::BK) ||
      !make_map<HD>(enc, &v_dq, v, Sk, KV, B, st + 8, C::BK) ||
      !make_map<HD>(enc, &q_kv, q, Sq, H, B, st, C::BQT) ||
      !make_map<HD>(enc, &d_kv, dout, Sq, H, B, st + 16, C::BQT) ||
      !make_map<HD>(enc, &k_kv, k, Sk, KV, B, st + 4, BKV) ||
      !make_map<HD>(enc, &v_kv, v, Sk, KV, B, st + 8, BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(smem_set, bwd_dq_wgmma<HD, CAP>, C::SMEM_DQ,
                               bwd_dkdv_wgmma<HD, CAP>, C::SMEM_DKDV);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int Sq_pad = (Sq + BQ - 1) / BQ * BQ;
  const long long rows = (long long)B * H * Sq_pad;
  float* lse2 = scratch;
  float* delta = scratch + rows;
  auto strides = [&](int i) {
    return Strides{st[4 * i], st[4 * i + 1], st[4 * i + 2], st[4 * i + 3]};
  };
  const Strides so = strides(3), sdo = strides(4);
  auto aligned = [](const void* p, Strides t) {
    return t.d == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0 && t.b % 8 == 0 &&
           t.h % 8 == 0 && t.s % 8 == 0;
  };
  bwd_rowstats<HD><<<(unsigned)(rows / (256 / (HD / 8))), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, lse2,
      delta, H, Sq, Sq_pad, so, sdo, int(aligned(o, so) && aligned(dout, sdo)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // capped, P's exponent is tanh(s scale / cap) times cap log2(e)
  const float scale_log2 = (CAP ? cap : scale) * LOG2E;
  const float tanh_scale = CAP ? scale / cap : 0.0f;
  bwd_dq_wgmma<HD, CAP><<<dim3(B * H, Sq_pad / BQ), THREADS, C::SMEM_DQ, stream>>>(
      q_dq, d_dq, k_dq, v_dq, lse2, delta, static_cast<__nv_bfloat16*>(dq), H, G, Sq, Sk, Sq_pad,
      kv_len, causal, scale, scale_log2, tanh_scale, strides(5));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_wgmma<HD, CAP>
      <<<dim3(B * KV, (Sk + BKV - 1) / BKV), THREADS, C::SMEM_DKDV, stream>>>(
          q_kv, d_kv, k_kv, v_kv, lse2, delta, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), H, G, Sq, Sk, Sq_pad, kv_len, causal, scale,
          scale_log2, tanh_scale, strides(6), strides(7));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// the bf16 kernels at head dim hd, capped or not
template <bool CAP>
int run_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int H, int G,
           int Sq, int Sk, int hd, int kv_len, int causal, float scale, float cap,
           const long long* st, cudaStream_t s) {
  switch (hd) {
    case 32:
      return tc::run<32, CAP>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, G, Sq, Sk,
                              kv_len, causal, scale, cap, st, s);
    case 64:
      return tc::run<64, CAP>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, G, Sq, Sk,
                              kv_len, causal, scale, cap, st, s);
    case 128:
      return tc::run<128, CAP>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, G, Sq, Sk,
                               kv_len, causal, scale, cap, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dq (B, H, Sq, hd), dk and dv (B, H / G, Sk, hd) of attention of q over k, v
// (B, H / G, Sk, hd), given its output o, the output's gradient dout (both
// (B, H, Sq, hd)) and the forward's log-sum-exp rows `lse`, a contiguous
// (B, H, Sq) float32 buffer; `scratch` is a float32 buffer of 2 B H Sq_pad
// values, Sq_pad = Sq rounded up to a multiple of 128, 16-byte aligned, in
// bfloat16 (float32 takes none: nullptr).
// `strides` holds 32 element strides: (b, h, s, d) of q, k, v, o, dout, dq,
// dk and dv in turn.  dtype: 0 = float32 (any strides), 1 = bfloat16 (all
// eight tensors; q, k, v and dout with d stride 1, the other strides and
// the pointers 16-byte aligned; dq, dk and dv with d stride 1 and even
// strides); hd in {32, 64, 128}; 0 <= kv_len <= Sk; in bfloat16 (Sq + 127)
// / 128 and (Sk + 127) / 128 below 65536.  `scale` and `cap` are the forward's (cap <= 0:
// no cap).  Launches on `stream` and returns a cudaError_t (0 when every
// launch was accepted).
extern "C" int repro_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* scratch, void* dq, void* dk, void* dv, int B,
                                         int H, int G, int Sq, int Sk, int hd, int kv_len,
                                         int causal, float scale, float cap,
                                         const long long* st, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool capped = cap > 0.0f;
  if (dtype == 1) {
    return capped ? run_tc<true>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, G, Sq, Sk, hd,
                                 kv_len, causal, scale, cap, st, s)
                  : run_tc<false>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, G, Sq, Sk,
                                  hd, kv_len, causal, scale, 0.0f, st, s);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto strides = [&](int i) {
    return Strides{st[4 * i], st[4 * i + 1], st[4 * i + 2], st[4 * i + 3]};
  };
  const void* in[5] = {q, k, v, o, dout};
  int vec = 0;
  for (int i = 0; i < 5; ++i) vec |= int(tf32::vec_ok(in[i], st + 4 * i)) << i;
  const f32::Args a{static_cast<const float*>(q),    static_cast<const float*>(k),
                    static_cast<const float*>(v),    static_cast<const float*>(o),
                    static_cast<const float*>(dout), lse,
                    static_cast<float*>(dq),         static_cast<float*>(dk),
                    static_cast<float*>(dv),         B,
                    H,                               G,
                    Sq,                              Sk,
                    kv_len,                          causal,
                    vec,                             scale,
                    capped ? cap : 0.0f,             strides(0),
                    strides(1),                      strides(2),
                    strides(3),                      strides(4),
                    strides(5),                      strides(6),
                    strides(7)};
  return capped ? f32::run<true>(a, hd, s) : f32::run<false>(a, hd, s);
}

// bytes of dynamic shared memory a block of the dq (which 0) or the dk/dv
// (which 1) kernel of dtype 0 (float32) or 1 (bfloat16) takes at head dim hd
// (-1 for a head dim that is not built); float32 has one kernel, whose
// blocks are of both kinds
extern "C" int repro_flash_attention_bwd_smem(int dtype, int which, int hd) {
  const bool tc = dtype == 1;
  switch (hd) {
    case 32:
      return tc ? (which == 0 ? tc::Cfg<32>::SMEM_DQ : tc::Cfg<32>::SMEM_DKDV)
                : f32::Cfg<32>::SMEM;
    case 64:
      return tc ? (which == 0 ? tc::Cfg<64>::SMEM_DQ : tc::Cfg<64>::SMEM_DKDV)
                : f32::Cfg<64>::SMEM;
    case 128:
      return tc ? (which == 0 ? tc::Cfg<128>::SMEM_DQ : tc::Cfg<128>::SMEM_DKDV)
                : f32::Cfg<128>::SMEM;
    default:
      return -1;
  }
}
