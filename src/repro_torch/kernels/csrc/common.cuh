// Helpers shared by the attention kernels: 16-byte loads that widen fp32 or
// bf16 to fp32, stores that narrow fp32 back to the tensor's type, and K1's
// mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Values of T held by one 16-byte load.
template <typename T>
struct Vec16 {
  static constexpr int kElems = 16 / sizeof(T);
};

// Read 16 bytes at `src` (16-byte aligned) into kElems floats, times `scale`.
__device__ __forceinline__ void load16(const float* src, float* dst, float scale) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x * scale;
  dst[1] = v.y * scale;
  dst[2] = v.z * scale;
  dst[3] = v.w * scale;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst, float scale) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x * scale;
    dst[2 * i + 1] = f.y * scale;
  }
}

// Write 4 floats to `dst` (aligned to 4 elements) in the type of `dst`.
__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

__device__ __forceinline__ void store1(float* dst, float a) { *dst = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float a) { *dst = __float2bfloat16_rn(a); }

// Stage `nrows` rows of D values into shared memory as fp32, row r read from
// `src + r * row_stride` and written at `dst + r * LD`; rows at or past
// `valid` are filled with zeros so that masked keys never carry NaN.
template <typename T, int D, int LD, int NTHREADS>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long row_stride,
                                           int nrows, int valid, float scale) {
  constexpr int E = Vec16<T>::kElems;
  constexpr int CHUNKS = D / E;
  for (int idx = threadIdx.x; idx < nrows * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    float vals[E];
    if (r < valid) {
      load16(src + r * row_stride + c * E, vals, scale);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) vals[i] = 0.f;
    }
    float* d = dst + r * LD + c * E;
#pragma unroll
    for (int i = 0; i < E; i += 4) store4(d + i, vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

// Whether query position qpos sees key j under K1's mask: j < seq_k and,
// when causal, j <= qpos and qpos - j < window (window <= 0: none).
__device__ __forceinline__ bool key_visible(int j, int qpos, int seq_k, int causal, int window) {
  bool ok = j < seq_k;
  if (causal) {
    ok = ok && j <= qpos;
    if (window > 0) ok = ok && (qpos - j) < window;
  }
  return ok;
}

// Whether KV tile [k0, k0 + bk) needs the mask for query positions
// [q_lo, q_hi] (offset included): true when S's end, the causal diagonal or
// the window's start crosses it.  Mirrored by
// repro_torch.kernels.flash_attention.tile_needs_mask.
__device__ __forceinline__ bool tile_needs_mask(int k0, int bk, int seq_k, int q_lo, int q_hi,
                                                int causal, int window) {
  if (k0 + bk > seq_k) return true;
  if (!causal) return false;
  if (k0 + bk - 1 > q_lo) return true;
  return window > 0 && q_hi - k0 >= window;
}

// 2^x in one instruction (MUFU.EX2); 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace repro_torch
