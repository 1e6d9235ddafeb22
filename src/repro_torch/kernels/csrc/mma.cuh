// Warp-level tensor-core fragments shared by K1's fp32 forward and K1-bwd:
// cp.async rings, ldmatrix, mma.sync for bf16 (m16n8k16) and for fp32 as
// 3xTF32 (m16n8k8), behind one operand-type policy, Mma<T>, so that a kernel
// is written once for both types.  ldmatrix loads the bf16 fragments and the
// fp32 ones that are not transposed (an 8 x 8 b16 matrix is 8 rows of 4
// fp32 words, one word a lane, as the tf32 fragments lay them out).
//
// Fragments follow the PTX ISA's layouts for mma.m16n8k{8,16}.row.col: lane
// = 4 * g + t; an accumulator c[4] of a 16 x 8 tile holds (row g, cols 2t,
// 2t+1) in c[0], c[1] and (row g + 8, the same cols) in c[2], c[3].
//
// Shared-memory tiles are row-major with a padded leading dimension
// (Mma<T>::kPad elements), so that the fragment loads hit 32 distinct banks:
// fp32 rows of D + 4 words (4 mod 32), bf16 rows of 2 D + 16 bytes (the 8
// rows one ldmatrix reads land on 8 distinct 16-byte bank groups).
//
// Three loads give the two operands of a product:
//   load_a   A (16 rows x kK) from a tile stored [row][k];
//   load_b   B (kK x 8) from a tile stored [n][k] (K-major, as K in Q K^T);
//   load_b_t B (kK x 8) from a tile stored [k][n] (as V in P V);
// and a_from_c turns kK / 8 accumulator tiles (a product's result, such as
// the scores) into the A operand of the next product without shared memory.
// load_a pairs with load_b, a_from_c with load_b_t: for fp32 the second pair
// runs the 8 keys of a k-step in the order (0, 2, 4, 6, 1, 3, 5, 7), which
// the accumulator layout gives for free and which changes no sum.
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): each fp32 operand a is split as
// big = tf32(a) and small = tf32(a - big) (cvt.rna: round to nearest, ties
// away, to 10 mantissa bits); a b ~ big_a big_b + big_a small_b + small_a
// big_b, the small terms first, small_a small_b dropped.  That keeps close to
// fp32's accuracy at a third of the TF32 tensor-core rate (495 / 3 TFLOP/s on
// the H100, against 67 on the CUDA cores); one TF32 pass keeps about three
// digits.  repro_torch.kernels.ref.matmul_3xtf32 is the same arithmetic in
// plain PyTorch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// cp.async: copies into shared memory that run while the warp computes
// ---------------------------------------------------------------------------

// 16 bytes from `src` to `dst` (both 16-byte aligned); zeros when !valid
// (nothing is read then, but `src` must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from `src` to `dst`; zero when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying `rows` rows of D values of T into a tile with leading
// dimension LD: row r from `src + r * row_stride`, rows at or past `valid`
// as zeros (read from `base`, a valid address, with size 0).
template <typename T, int D, int LD, int NTHREADS>
__device__ __forceinline__ void async_rows(T* dst, const T* src, long long row_stride, int rows,
                                           int valid, const T* base) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CHUNKS = D / E;
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c * E, ok ? src + r * row_stride + c * E : base, ok);
  }
}

// Start copying n floats, element i from src[i * stride]; zeros at or past
// `valid`.
template <int NTHREADS>
__device__ __forceinline__ void async_floats(float* dst, const float* src, long long stride, int n,
                                             int valid, const float* base) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    const bool ok = i < valid;
    cp_async4(dst + i, ok ? src + i * stride : base, ok);
  }
}

// ---------------------------------------------------------------------------
// the instructions
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d (16 x 8, fp32) += a (16 x 8, tf32) b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// the operand-type policy
// ---------------------------------------------------------------------------

template <typename T>
struct Mma;

// fp32 operands as 3xTF32.  A fragment: (row g, k t), (row g + 8, k t),
// (row g, k t + 4), (row g + 8, k t + 4); B fragment: (k t, n g), (k t + 4,
// n g); each split into big and small.
template <>
struct Mma<float> {
  static constexpr int kK = 8;     // depth of one mma
  static constexpr int kPad = 4;   // elements of row padding in shared memory
  struct A {
    uint32_t big[4];
    uint32_t small[4];
  };
  struct B {
    uint32_t big[2];
    uint32_t small[2];
  };

  template <int N>
  __device__ static __forceinline__ void split(const float (&x)[N], uint32_t (&big)[N],
                                               uint32_t (&small)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      big[i] = to_tf32(x[i]);
      small[i] = to_tf32(x[i] - __uint_as_float(big[i]));
    }
  }

  // s at (row0, k0) of a tile stored [row][k]: one ldmatrix.x4, whose 8 x 8
  // b16 matrices are 8 rows of 4 fp32 words, so that each lane receives the
  // word (row g, k t) of each: rows 0-7 and 8-15 at k 0-3, then at k 4-7
  __device__ static __forceinline__ A load_a(const float* s, int ld, int lane) {
    uint32_t r[4];
    ldmatrix_x4(r, s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 4 * (lane >> 4));
    const float x[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                        __uint_as_float(r[3])};
    A a;
    split(x, a.big, a.small);
    return a;
  }

  // s at (n0, k0) of a tile stored [n][k]: one ldmatrix.x2, n 0-7 at k 0-3
  // and at k 4-7 (lanes 0-15 address them)
  __device__ static __forceinline__ B load_b(const float* s, int ld, int lane) {
    uint32_t r[2];
    ldmatrix_x2(r, s + (lane & 7) * ld + 4 * ((lane >> 3) & 1));
    const float x[2] = {__uint_as_float(r[0]), __uint_as_float(r[1])};
    B b;
    split(x, b.big, b.small);
    return b;
  }

  // s at (k0, n0) of a tile stored [k][n]; k-step order (0, 2, 4, 6, 1, 3, 5, 7)
  __device__ static __forceinline__ B load_b_t(const float* s, int ld, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float x[2] = {s[(2 * t) * ld + g], s[(2 * t + 1) * ld + g]};
    B b;
    split(x, b.big, b.small);
    return b;
  }

  // the accumulator tile c[0..3] (16 x 8) as an A operand over its 8
  // columns, in load_b_t's k order
  __device__ static __forceinline__ A a_from_c(const float* c) {
    const float x[4] = {c[0], c[2], c[1], c[3]};
    A a;
    split(x, a.big, a.small);
    return a;
  }

  // the three products, the small terms first: pass 0 small_a big_b, 1
  // big_a small_b, 2 big_a big_b
  static constexpr int kPasses = 3;
  __device__ static __forceinline__ void mma_pass(int pass, float (&d)[4], const A& a,
                                                  const B& b) {
    if (pass == 0) {
      mma_tf32(d, a.small, b.big);
    } else if (pass == 1) {
      mma_tf32(d, a.big, b.small);
    } else {
      mma_tf32(d, a.big, b.big);
    }
  }
};

// bf16 operands, one m16n8k16 mma; fragments through ldmatrix.
template <>
struct Mma<__nv_bfloat16> {
  static constexpr int kK = 16;
  static constexpr int kPad = 8;
  struct A {
    uint32_t x[4];
  };
  struct B {
    uint32_t x[2];
  };

  // four 8 x 8 matrices: rows 0-7 and 8-15 of k 0-7, then of k 8-15
  __device__ static __forceinline__ A load_a(const __nv_bfloat16* s, int ld, int lane) {
    A a;
    ldmatrix_x4(a.x, s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4));
    return a;
  }

  // two 8 x 8 matrices, n 0-7 at k 0-7 and at k 8-15 (lanes 0-15 address them)
  __device__ static __forceinline__ B load_b(const __nv_bfloat16* s, int ld, int lane) {
    B b;
    ldmatrix_x2(b.x, s + (lane & 7) * ld + 8 * ((lane >> 3) & 1));
    return b;
  }

  // k rows 0-7 and 8-15 of 8 columns, transposed on the way
  __device__ static __forceinline__ B load_b_t(const __nv_bfloat16* s, int ld, int lane) {
    B b;
    ldmatrix_x2_trans(b.x, s + (lane & 15) * ld);
    return b;
  }

  // two accumulator tiles c[0..7] (16 x 16) as an A operand, rounded to bf16
  __device__ static __forceinline__ A a_from_c(const float* c) {
    A a;
    a.x[0] = pack_bf16(c[0], c[1]);
    a.x[1] = pack_bf16(c[2], c[3]);
    a.x[2] = pack_bf16(c[4], c[5]);
    a.x[3] = pack_bf16(c[6], c[7]);
    return a;
  }

  static constexpr int kPasses = 1;
  __device__ static __forceinline__ void mma_pass(int, float (&d)[4], const A& a, const B& b) {
    mma_bf16(d, a.x, b.x);
  }
};

// d[i] += a b[i] and e[i] += a2 b2[i] for i < N, pass by pass: the 2 N
// products of one pass are independent, so that an mma does not wait on the
// one before it (3xTF32's three passes into one accumulator would otherwise
// run back to back).
template <typename T, int N>
__device__ __forceinline__ void mma_n2(float (*d)[4], const typename Mma<T>::A& a,
                                       const typename Mma<T>::B* b, float (*e)[4],
                                       const typename Mma<T>::A& a2,
                                       const typename Mma<T>::B* b2) {
#pragma unroll
  for (int p = 0; p < Mma<T>::kPasses; ++p)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      Mma<T>::mma_pass(p, d[i], a, b[i]);
      Mma<T>::mma_pass(p, e[i], a2, b2[i]);
    }
}

// d[i] += a b[i] for i < N, pass by pass, as mma_n2.
template <typename T, int N>
__device__ __forceinline__ void mma_n(float (*d)[4], const typename Mma<T>::A& a,
                                      const typename Mma<T>::B* b) {
#pragma unroll
  for (int p = 0; p < Mma<T>::kPasses; ++p)
#pragma unroll
    for (int i = 0; i < N; ++i) Mma<T>::mma_pass(p, d[i], a, b[i]);
}

// Two fp32 values to `dst` (8-byte aligned) in the type of `dst`.
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

}  // namespace repro_torch
