// Pieces shared by K3 (ssd_scan.cu) and its gradient (ssd_scan_bwd.cu): the
// fp64 cumsum of dA inside a chunk, the input strides, to_f32, the staging
// of fp32 or bf16 tiles into shared memory as fp32, and the 3xTF32 split
// and fragment loads of Mma<float> (mma.cuh) from those tiles.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace repro_torch {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;          // longest chunk
constexpr int kMaxN = 128;          // largest state dimension

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// dA of the lane's rows of a chunk (up to 4, zero past `valid`), the
// input of chunk_cumsum_from: loaded apart, so that a caller can issue the
// loads before other work.
template <typename T>
__device__ __forceinline__ void chunk_da(float (&da)[4], const T* dA_bh, long long as_t, int t0,
                                         int valid, int Q, int lane) {
  const int per = (Q + 31) / 32;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = lane * per + e;
    da[e] = (e < per && r < valid) ? to_f32(dA_bh[(t0 + r) * as_t]) : 0.f;
  }
}

// Inclusive fp64 cumsum over the chunk's rows [0, Q) of the values that
// chunk_da gave each lane of warp 0.
__device__ __forceinline__ void chunk_cumsum_from(double* cum, const float (&da)[4], int Q,
                                                  int lane) {
  const int per = (Q + 31) / 32;
  double v[4];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < per) run += da[e];
    v[e] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const double excl = incl - run;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = lane * per + e;
    if (e < per && r < Q) cum[r] = excl + v[e];
  }
}

// Inclusive fp64 cumsum of dA over the chunk's rows [0, Q) (zero past
// `valid`), by warp 0: up to 4 values a lane.
template <typename T>
__device__ __forceinline__ void chunk_cumsum(double* cum, const T* dA_bh, long long as_t, int t0,
                                             int valid, int Q, int lane) {
  float da[4];
  chunk_da(da, dA_bh, as_t, t0, valid, Q, lane);
  chunk_cumsum_from(cum, da, Q, lane);
}

struct Strides {
  long long xs_b, xs_t, xs_h, as_b, as_t, as_h, bs_b, bs_t, cs_b, cs_t;
};

__host__ __device__ __forceinline__ int round8(int n) { return (n + 7) / 8 * 8; }

// ---------------------------------------------------------------------------
// staging into shared memory
// ---------------------------------------------------------------------------

// Start copying rows x cols values (cols a multiple of 4) of a row-major
// source, row r at src + r·stride, into a tile with leading dimension ld
// (a multiple of 4, 16-byte aligned); rows at or past rows_ok and columns
// at or past cols_ok (a multiple of 4) are zeros, read from `safe`, a valid
// address, with size 0.  fp32 goes by cp.async, 16 bytes where the rows are
// 16-byte aligned, else 4; wait for it with cp_async_wait.
__device__ __forceinline__ void stage_tile(float* dst, int ld, const float* src, long long stride,
                                           int rows, int rows_ok, int cols, int cols_ok,
                                           const void* safe) {
  const float* s0 = static_cast<const float*>(safe);
  if (((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(stride * 4)) & 15) == 0) {
    const int per = cols / 4;
    const bool pow2 = (per & (per - 1)) == 0;     // every tile but N's: shifts, not divisions
    const int sh = __ffs(per) - 1;
    for (int idx = threadIdx.x; idx < rows * per; idx += blockDim.x) {
      const int r = pow2 ? idx >> sh : idx / per;
      const int c = (pow2 ? idx & (per - 1) : idx % per) * 4;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : s0, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
      const int r = idx / cols;
      const int c = idx % cols;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async4(dst + r * ld + c, ok ? src + r * stride + c : s0, ok);
    }
  }
}

// bf16: loads widened to fp32 and stored at once (visible after a barrier).
__device__ __forceinline__ void stage_tile(float* dst, int ld, const __nv_bfloat16* src,
                                           long long stride, int rows, int rows_ok, int cols,
                                           int cols_ok, const void*) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(stride * 2)) & 7) == 0;
  const int per = cols / 4;
  for (int idx = threadIdx.x; idx < rows * per; idx += blockDim.x) {
    const int r = idx / per;
    const int c = (idx % per) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_ok && c < cols_ok) {
      const __nv_bfloat16* p = src + r * stride + c;
      if (vec) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        v = make_float4(a.x, a.y, b.x, b.y);
      } else {
        v = make_float4(__bfloat162float(p[0]), __bfloat162float(p[1]), __bfloat162float(p[2]),
                        __bfloat162float(p[3]));
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

__device__ __forceinline__ void zero_tile(float* dst, int ld, int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    dst[(idx / cols) * ld + idx % cols] = 0.f;
  }
}

using MF = Mma<float>;

// ---------------------------------------------------------------------------
// fragments: fp32 values from shared memory, split for 3xTF32 (lane = 4g + t)
// ---------------------------------------------------------------------------

// The 3xTF32 split of x: big = tf32(x), rounded to nearest with ties away
// from zero (cvt.rna's rounding, in two integer operations), and small = x −
// big, whose bits past TF32's the tensor core does not read (rounding them
// toward zero); a·b ≈ big_a big_b + big_a small_b + small_a big_b.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ MF::A split_a(float a0, float a1, float a2, float a3) {
  MF::A a;
  split(a0, a.big[0], a.small[0]);
  split(a1, a.big[1], a.small[1]);
  split(a2, a.big[2], a.small[2]);
  split(a3, a.big[3], a.small[3]);
  return a;
}

__device__ __forceinline__ MF::B split_b(float b0, float b1) {
  MF::B b;
  split(b0, b.big[0], b.small[0]);
  split(b1, b.big[1], b.small[1]);
  return b;
}

// A (16 x 8) at (r0, k0) of a tile stored [row][k] (ld ≡ 4 mod 32: the 8 rows
// an 8 x 8 b16 matrix of ldmatrix reads hit 8 distinct 16-byte bank groups),
// its rows g and g + 8 scaled by s0 and s1: one ldmatrix.x4, whose matrices
// are rows 0-7 and 8-15 at k 0-3, then at k 4-7 (Mma<float>::load_a's)
__device__ __forceinline__ MF::A ld_a(const float* s, int ld, int r0, int k0, int lane,
                                      float s0 = 1.f, float s1 = 1.f) {
  uint32_t r[4];
  ldmatrix_x4(r, s + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + k0 + 4 * (lane >> 4));
  return split_a(__uint_as_float(r[0]) * s0, __uint_as_float(r[1]) * s1,
                 __uint_as_float(r[2]) * s0, __uint_as_float(r[3]) * s1);
}

// A (16 x 8) at (r0, k0) of a tile stored [k][row] (ld ≡ 8 mod 32)
__device__ __forceinline__ MF::A ld_a_t(const float* s, int ld, int r0, int k0, int g, int t) {
  const float* p = s + (k0 + t) * ld + r0 + g;
  return split_a(p[0], p[8], p[4 * ld], p[4 * ld + 8]);
}

// B (8 x 8) at (k0, n0) of a tile stored [k][n] (ld ≡ 8 mod 32), its rows
// k0 + t and k0 + t + 4 scaled by s0 and s1
__device__ __forceinline__ MF::B ld_b(const float* s, int ld, int k0, int n0, int g, int t,
                                      float s0 = 1.f, float s1 = 1.f) {
  const float* p = s + (k0 + t) * ld + n0 + g;
  return split_b(p[0] * s0, p[4 * ld] * s1);
}

// B (8 x 8) at (k0, n0) of a tile stored [n][k] (ld ≡ 4 mod 32): one
// ldmatrix.x2, n 0-7 at k 0-3 and at k 4-7 (lanes 0-15 address them)
__device__ __forceinline__ MF::B ld_b_t(const float* s, int ld, int n0, int k0, int lane) {
  uint32_t r[2];
  ldmatrix_x2(r, s + (n0 + (lane & 7)) * ld + k0 + 4 * ((lane >> 3) & 1));
  return split_b(__uint_as_float(r[0]), __uint_as_float(r[1]));
}

}  // namespace repro_torch
