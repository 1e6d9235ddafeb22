// Causal GQA flash attention for prefill and chunked prefill (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel).  Queries are the last T of S keys (bottom-right causal
// alignment, offset S - T); an optional window keeps q_pos - kv_pos < window.
//
// Layout: q (B, T, Hq, D), k/v (B, S, Hkv, D), o (B, T, Hq, D); the T/S, head
// and D dimensions are dense, the batch dimension takes any stride (the model
// passes views of its slot cache).  Query head h reads KV head h / (Hq / Hkv).
//
// Two kernels share that contract.  bf16 inputs (the model's type) take
// flash_fwd_mma_kernel below: both products on the tensor cores through
// mma.sync, described there.  fp32 inputs take flash_fwd_kernel, which keeps
// fp32 products on the CUDA cores so that it matches the plain version to
// 2e-4.
//
// flash_fwd_kernel: one block per (64-row query tile, query head, batch), 256 threads,
// four threads per query row.  The block stages the query tile once and then
// walks 64-row KV tiles through shared memory as fp32.  Each thread scores 16
// keys of its row, the row's four threads combine max and sum with shuffles,
// and each thread owns a quarter of the row's fp32 accumulator (D/4 values,
// interleaved in 16-byte chunks so that the four threads hit distinct banks).
// Whole KV tiles past the causal edge or before the window are skipped; the
// ragged edges of T and S are masked, never padded.
#include "common.cuh"

#include <math.h>

#include <type_traits>

namespace repro_torch {
namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kThreadsPerRow = kThreads / kBlockQ;  // 4

template <int D>
constexpr int smem_bytes() {
  return 3 * 64 * (D + 4) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int seq_q, int seq_k, int num_heads, int num_kv_heads,
                 long long q_sb, long long k_sb, long long v_sb, long long o_sb,
                 float scale, int causal, int window) {
  constexpr int LD = D + 4;                       // padded fp32 row
  constexpr int NS = kBlockK / kThreadsPerRow;    // scores per thread (16)
  constexpr int NC = D / (4 * kThreadsPerRow);    // float4 chunks of acc per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (num_heads / num_kv_heads);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid / kThreadsPerRow;
  const int part = tid % kThreadsPerRow;
  const int offset = seq_k - seq_q;

  const long long q_rs = static_cast<long long>(num_heads) * D;
  const long long kv_rs = static_cast<long long>(num_kv_heads) * D;
  stage_rows<T, D, LD, kThreads>(Qs, q + b * q_sb + q0 * q_rs + static_cast<long long>(h) * D,
                                 q_rs, kBlockQ, min(kBlockQ, seq_q - q0), scale);

  // KV tiles this query tile can see.
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + kBlockQ, seq_q) - 1 + offset;
  int k_begin = 0;
  int k_end = seq_k;
  if (causal) {
    k_end = min(seq_k, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  k_begin = (k_begin / kBlockK) * kBlockK;

  const int qpos = q0 + row + offset;
  float acc[4 * NC];
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed before it is overwritten
    const int valid = min(kBlockK, seq_k - k0);
    stage_rows<T, D, LD, kThreads>(Ks, k + b * k_sb + k0 * kv_rs + static_cast<long long>(hk) * D,
                                   kv_rs, kBlockK, valid, 1.f);
    stage_rows<T, D, LD, kThreads>(Vs, v + b * v_sb + k0 * kv_rs + static_cast<long long>(hk) * D,
                                   kv_rs, kBlockK, valid, 1.f);
    __syncthreads();

    // scores of this row against keys part, part + 4, ..., part + 60
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    const float* qr = Qs + row * LD;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (part + kThreadsPerRow * i) * LD + d);
        s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int j = k0 + part + kThreadsPerRow * i;
      bool ok = j < seq_k;
      if (causal) {
        ok = ok && j <= qpos;
        if (window > 0) ok = ok && (qpos - j) < window;
      }
      s[i] = ok ? s[i] : -INFINITY;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float alpha = 1.f;
    float psum = 0.f;
    if (m_new == -INFINITY) {
      // nothing visible to this row yet: every p is 0
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
    } else {
      alpha = expf(m - m_new);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = expf(s[i] - m_new);
        psum += s[i];
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4 * NC; ++i) acc[i] *= alpha;

    // acc += P @ V: key j's p lives in thread (j % 4) of the row, at s[j / 4]
    const int base = lane & ~(kThreadsPerRow - 1);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
      for (int hh = 0; hh < kThreadsPerRow; ++hh) {
        const float p = __shfl_sync(0xffffffffu, s[i], base | hh);
        const float* vr = Vs + (hh + kThreadsPerRow * i) * LD;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * (part + kThreadsPerRow * c));
          acc[4 * c] += p * vv.x;
          acc[4 * c + 1] += p * vv.y;
          acc[4 * c + 2] += p * vv.z;
          acc[4 * c + 3] += p * vv.w;
        }
      }
    }
  }

  if (q0 + row < seq_q) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a fully masked row gives 0
    T* orow = o + b * o_sb + (q0 + row) * q_rs + static_cast<long long>(h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store4(orow + 4 * (part + kThreadsPerRow * c), acc[4 * c] * inv, acc[4 * c + 1] * inv,
             acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the two products on the tensor cores (mma.sync m16n8k16, fp32 sums)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps, 16 query rows each

template <int D>
constexpr int mma_smem_bytes() {
  return 3 * 64 * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c += a (16x16 bf16, row-major) * b (16x8 bf16, col-major), fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `nrows` rows of D bf16 values into shared memory (row stride LDS),
// 16 bytes a thread at a time; rows at or past `valid` become zeros.
template <int D, int LDS>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int nrows, int valid) {
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < nrows * CHUNKS; idx += kMmaThreads) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LDS + c * 8) = val;
  }
}

// Same contract as flash_fwd_kernel, for bf16.  One block per (64-row query
// tile, query head, batch); warp w owns query rows 16w..16w+15.  The warp
// keeps its Q fragments, the tile's scores and its fp32 output accumulator
// in registers; the scores become the A operand of P @ V without leaving
// them (the FlashAttention-2 arrangement).  K and V tiles are staged in
// shared memory once per block and read with ldmatrix.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int seq_q, int seq_k, int num_heads, int num_kv_heads, long long q_sb,
                     long long k_sb, long long v_sb, long long o_sb, float scale, int causal,
                     int window) {
  constexpr int LDS = D + 8;  // padded row: ldmatrix rows land on distinct banks
  constexpr int KD = D / 16;  // k-steps of Q K^T, and pairs of output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + 64 * LDS;
  __nv_bfloat16* Vs = Ks + 64 * LDS;

  const int q0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (num_heads / num_kv_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row
  const int t = lane % 4;  // fragment column pair
  const int offset = seq_k - seq_q;
  const long long q_rs = static_cast<long long>(num_heads) * D;
  const long long kv_rs = static_cast<long long>(num_kv_heads) * D;

  copy_rows<D, LDS>(Qs, q + b * q_sb + q0 * q_rs + static_cast<long long>(h) * D, q_rs, 64,
                    min(64, seq_q - q0));
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qa[kk], Qs + (16 * warp + lane % 16) * LDS + 16 * kk + (lane / 16) * 8);

  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + 64, seq_q) - 1 + offset;
  int k_begin = 0;
  int k_end = seq_k;
  if (causal) {
    k_end = min(seq_k, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  k_begin = (k_begin / 64) * 64;

  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)
  const int row0 = q0 + 16 * warp + g;                     // this thread's rows: row0, row0 + 8
  const int qpos[2] = {row0 + offset, row0 + 8 + offset};
  float acc[2 * KD][4];
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = k_begin; k0 < k_end; k0 += 64) {
    __syncthreads();  // the previous tile is consumed before it is overwritten
    const int valid = min(64, seq_k - k0);
    copy_rows<D, LDS>(Ks, k + b * k_sb + k0 * kv_rs + static_cast<long long>(hk) * D, kv_rs, 64,
                      valid);
    copy_rows<D, LDS>(Vs, v + b * v_sb + k0 * kv_rs + static_cast<long long>(hk) * D, kv_rs, 64,
                      valid);
    __syncthreads();

    // S = Q K^T: eight 16x8 tiles of scores per warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Ks + (16 * jj + lane % 8 + (lane / 16) * 8) * LDS + 16 * kk +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * jj], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jj + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // mask, scale to the log2 domain, and take each row's max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int qp = qpos[e >> 1];
        bool ok = key < seq_k;
        if (causal) {
          ok = ok && key <= qp;
          if (window > 0) ok = ok && (qp - key) < window;
        }
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible: p = 0
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_use[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < 2 * KD; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += P V: the score tiles, rounded to bf16, are the A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jd = 0; jd < KD; ++jd) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * LDS + 16 * jd +
                                  (lane / 16) * 8);
        mma_bf16(acc[2 * jd], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * jd + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < seq_q) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // a fully masked row gives 0
      __nv_bfloat16* orow = o + b * o_sb + row * q_rs + static_cast<long long>(h) * D;
#pragma unroll
      for (int j = 0; j < 2 * KD; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Tq, int Sk,
                   int Hq, int Hkv, long long q_sb, long long k_sb, long long v_sb,
                   long long o_sb, float scale, int causal, int window, cudaStream_t stream) {
  dim3 grid((Tq + kBlockQ - 1) / kBlockQ, Hq, B);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int bytes = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal, window);
  } else {
    constexpr int bytes = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal, window);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int Tq,
                       int Sk, int Hq, int Hkv, long long q_sb, long long k_sb, long long v_sb,
                       long long o_sb, float scale, int causal, int window,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// Strides are in elements.  dtype: 0 = float32, 1 = bfloat16.  window <= 0
// means no window.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int T, int S, int Hq, int Hkv, int D, long long q_sb,
                                   long long k_sb, long long v_sb, long long o_sb, float scale,
                                   int causal, int window, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return repro_torch::dispatch_d<float>(D, q, k, v, o, B, T, S, Hq, Hkv, q_sb, k_sb, v_sb,
                                          o_sb, scale, causal, window, st);
  }
  if (dtype == 1) {
    return repro_torch::dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, T, S, Hq, Hkv, q_sb, k_sb,
                                                  v_sb, o_sb, scale, causal, window, st);
  }
  return cudaErrorInvalidValue;
}
