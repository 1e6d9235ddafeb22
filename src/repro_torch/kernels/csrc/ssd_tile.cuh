// Pieces of K3 (ssd_scan.cu): the register-tiled fp32 product of a 128-row
// output tile, fed from shared-memory slices of depth 16 (256 threads, each
// 4 rows x CPT columns); and, shared with its gradient (ssd_scan_bwd.cu),
// the fp64 cumsum of dA inside a chunk, the input strides and to_f32.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kThreads = 256;
constexpr int kKS = 16;             // depth of a staged slice
constexpr int kRows = 128;          // rows of a block's output tile, 4 a thread
constexpr int kLDA = kRows + 4;     // row stride of the left operand's slice
constexpr int kMaxPT = 64;          // widest tile of state columns
constexpr int kLDB = kMaxPT + 4;    // row stride of the right operand's rows
constexpr int kMaxQ = 128;          // longest chunk
constexpr int kMaxN = 128;          // largest state dimension

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Column c (of CPT) of thread column group tx in a tile of 8·CPT columns.
template <int CPT>
__device__ __forceinline__ int col_of(int tx, int c) {
  if (CPT == 8) return c < 4 ? tx * 4 + c : 32 + tx * 4 + (c - 4);
  return tx * CPT + c;
}

template <int CPT>
__device__ __forceinline__ void load_cols(const float* row, int tx, float (&v)[CPT]) {
  if constexpr (CPT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(row + tx * 2);
    v[0] = a.x;
    v[1] = a.y;
  } else if constexpr (CPT == 4) {
    const float4 a = *reinterpret_cast<const float4*>(row + tx * 4);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(row + tx * 4);
    const float4 b = *reinterpret_cast<const float4*>(row + 32 + tx * 4);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
    v[4] = b.x;
    v[5] = b.y;
    v[6] = b.z;
    v[7] = b.w;
  }
}

// acc[r][c] += Σ_k As[k][row0 + r] · Bs[k][col_of(tx, c)] over one slice.
template <int CPT>
__device__ __forceinline__ void mma_slice(float (&acc)[4][CPT], const float* As, const float* Bs,
                                          int row0, int tx) {
#pragma unroll
  for (int k = 0; k < kKS; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(As + k * kLDA + row0);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float bv[CPT];
    load_cols<CPT>(Bs + k * kLDB, tx, bv);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
  }
}

// Inclusive fp64 cumsum of dA over the chunk's rows [0, Q) (zero past
// `valid`), by warp 0: up to 4 values a lane.
template <typename T>
__device__ __forceinline__ void chunk_cumsum(double* cum, const T* dA_bh, long long as_t, int t0,
                                             int valid, int Q, int lane) {
  const int per = (Q + 31) / 32;
  double v[4];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = lane * per + e;
    if (e < per && r < valid) run += to_f32(dA_bh[(t0 + r) * as_t]);
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

struct Strides {
  long long xs_b, xs_t, xs_h, as_b, as_t, as_h, bs_b, bs_t, cs_b, cs_t;
};

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) / 16 * 16; }

}  // namespace repro_torch
