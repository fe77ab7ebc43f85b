// 3xTF32 building blocks of K3's and K3b's f32 kernels (flash_attention.cu,
// flash_attention_bwd.cu): warp-level tensor-core products (mma.sync
// m16n8k8 TF32) with every f32 operand split into two TF32 parts, and
// cp.async staging of f32 rows into shared memory.  Included by those two
// sources; not compiled on its own.
//
// Fragments of one m16n8k8 product, lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8):  a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):  c0 (row g, col 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// An accumulator holds columns 2t and 2t + 1 where an A fragment wants t and
// t + 4, so a product whose A is an accumulator (P V, dS K, P^T dO, dS^T Q)
// renumbers its k index: k t is column 2t and k t + 4 is column 2t + 1 of
// each 8-block.  Its B reads the same two rows of its staged tile (rows 2t
// and 2t + 1), and no value moves between lanes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a TF32 value),
// lo = x - hi is exact in f32, and the tensor cores read lo's top 19 bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// d += a b, one TF32 pass
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand split for 3xTF32: the hi and lo parts of its fragment
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
};

// d += a b in three TF32 passes, the cross terms lo.hi and hi.lo before
// hi.hi; lo.lo (below 2^-20 of the product) is dropped
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a, const Split<2>& b) {
  mma(d, a.lo, b.hi[0], b.hi[1]);
  mma(d, a.hi, b.lo[0], b.lo[1]);
  mma(d, a.hi, b.hi[0], b.hi[1]);
}

// The A fragment of the 16 x 8 block at `s` (row-major, `ld` floats a row)
__device__ __forceinline__ Split<4> frag_a(const float* s, int ld, int g, int t) {
  Split<4> f;
  split(s[g * ld + t], f.hi[0], f.lo[0]);
  split(s[(g + 8) * ld + t], f.hi[1], f.lo[1]);
  split(s[g * ld + t + 4], f.hi[2], f.lo[2]);
  split(s[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
  return f;
}

// The A fragment of an accumulator, its k index renumbered (see above)
__device__ __forceinline__ Split<4> frag_a(const float (&c)[4]) {
  Split<4> f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// The B fragment of X^T for the 8 x 8 block of staged rows at `s`: n is a
// row (a key of Q K^T), k a column (the head dim)
__device__ __forceinline__ Split<2> frag_bt(const float* s, int ld, int g, int t) {
  Split<2> f;
  split(s[g * ld + t], f.hi[0], f.lo[0]);
  split(s[g * ld + t + 4], f.hi[1], f.lo[1]);
  return f;
}

// The B fragment of X for the 8 x 8 block of staged rows at `s`, in an
// accumulator's k order: k t is row 2t, k t + 4 row 2t + 1; n a column
__device__ __forceinline__ Split<2> frag_b(const float* s, int ld, int g, int t) {
  Split<2> f;
  split(s[2 * t * ld + g], f.hi[0], f.lo[0]);
  split(s[(2 * t + 1) * ld + g], f.hi[1], f.lo[1]);
  return f;
}

// ---- cp.async ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (16 or 0) from src to dst, zeros where bytes is 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// `bytes` (4 or 0) from src to dst, a zero where bytes is 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows) of one (batch, head) slice `src` (row stride ss,
// column stride sd, COLS columns) into `dst` (`ld` floats a row), zeros at
// and past row `limit`, by the block's `nthreads` threads: 16-byte copies
// where `vec` (sd == 1, ss and the slice's base 16-byte aligned), else 4-byte
// copies through any strides.
template <int COLS>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, long long ss,
                                           long long sd, int row0, int rows, int limit, bool vec,
                                           int tid, int nthreads) {
  if (vec) {
    constexpr int C4 = COLS / 4;
    for (int e = tid; e < rows * C4; e += nthreads) {
      const int r = e / C4;
      const int c = (e % C4) * 4;
      const bool ok = row0 + r < limit;
      cp_async16(dst + r * ld + c, ok ? src + (long long)(row0 + r) * ss + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * COLS; e += nthreads) {
      const int r = e / COLS;
      const int c = e % COLS;
      const bool ok = row0 + r < limit;
      cp_async4(dst + r * ld + c, ok ? src + (long long)(row0 + r) * ss + c * sd : src,
                ok ? 4 : 0);
    }
  }
}

// Can stage_rows take 16-byte copies of a tensor with element strides
// st[0..3] (b, h, s, d) at `p`: a contiguous last dimension, and every other
// stride and the base a multiple of 16 bytes
inline bool vec_ok(const void* p, const long long* st) {
  return st[3] == 1 && st[0] % 4 == 0 && st[1] % 4 == 0 && st[2] % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace tf32
