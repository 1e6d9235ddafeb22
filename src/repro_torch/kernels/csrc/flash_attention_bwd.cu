// Gradient of K1, the causal GQA flash attention (sm_90a).
//
// K1 (csrc/flash_attention.cu) replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention.  The JAX package trains
// through its dense jnp attention, which XLA differentiates, and has no
// backward kernel; the port trains through K1, so this is K1's gradient,
// computed from what K1 saves: q, k, v, its output o and the fp32
// log-sum-exp of each row's scaled scores, lse (B, T, Hq).  Query t sits at
// key position q_offset + t (S - T by default); causal with an optional
// window (q_pos - kv_pos < window), or no mask at all; a row whose lse is
// -inf saw no key and gets zero gradient.
//
// Layout: q, o, do, dq (B, T, Hq, D); k, v, dk, dv (B, S, Hkv, D), all
// dense; lse and delta (B, T, Hq) fp32.  Query head h reads KV head
// h / (Hq / Hkv).  fp32 or bf16 in and out, fp32 products and sums.
//
// Three launches:
//   1. delta = rowsum(do * o), one warp a row;
//   2. dk, dv: one block per (key tile, KV head, batch).  It stages its K and
//      V tile once and walks the G query heads of its group and, for each,
//      the query tiles that see the key tile (q_tile_range in
//      repro_torch/kernels/flash_attention.py), recomputing
//      P = exp(q k^T scale - lse) and accumulating dV += P^T dO,
//      dS = P * (dO V^T - delta), dK += dS^T Q scale in registers;
//   3. dq: one block per (query tile, query head, batch), walking the key
//      tiles it sees (kv_tile_range): dQ += dS K scale.
// The G heads of a group are summed inside one block and nothing is added
// across blocks, so there are no atomics and the gradient is the same from
// run to run.
//
// What bounds it: at the qwen2_5_3b training shape (B=4, T=S=512, 16 query
// and 2 KV heads of 128, causal) the gradient is five products of
// 2 T S_eff D a (batch, head), about 10.7 GFLOP on 10.5 MB in fp32, so the
// card's arithmetic is the bound.  This first design keeps every product on
// the CUDA cores in fp32 (bf16 is widened when staged), with tiles staged
// through shared memory as fp32 rows padded against bank conflicts; wgmma,
// TMA and warp specialisation are for a later design.  Tiles: 64 query rows
// (four threads a row) and 32 keys; at D = 256 that is 218,624 bytes of
// shared memory, opted in past 48 KB.
#include "common.cuh"

#include <math.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;                          // query rows a tile
constexpr int kBlockK = 32;                          // keys a tile
constexpr int kRowThreads = kThreads / kBlockQ;      // 4 threads a query row
constexpr int kKeyThreads = kThreads / kBlockK;      // 8 threads a key row
constexpr int kScores = kBlockK / kRowThreads;       // S and dP entries a thread (8)
constexpr int kLDP = kBlockK + 4;                    // P and dS row (36 = 4 mod 32 banks)

template <int D>
struct BwdTile {
  static constexpr int kLD = D + 4;                  // padded fp32 row of Q, dO, K, V
  static constexpr int kKeyChunks = D / (4 * kKeyThreads);   // float4s of dK, dV a thread
  static constexpr int kRowChunks = D / (4 * kRowThreads);   // float4s of dQ a thread
  // K and V (kBlockK rows), Q and dO (kBlockQ rows), P and dS, lse and delta
  static constexpr int kSmemBytes =
      (2 * kBlockK * kLD + 2 * kBlockQ * kLD + 2 * kBlockQ * kLDP + 2 * kBlockQ) *
      static_cast<int>(sizeof(float));
};

__device__ __forceinline__ bool visible(int j, int qpos, int seq_k, int causal, int window) {
  bool ok = j < seq_k;
  if (causal) {
    ok = ok && j <= qpos;
    if (window > 0) ok = ok && (qpos - j) < window;
  }
  return ok;
}

// Stage the query tile q0 .. q0 + 63 of head h: Q times `scale`, dO, and
// each row's lse (-inf past T, so that those rows give P = 0) and delta.
template <typename T, int D>
__device__ __forceinline__ void stage_queries(float* Qs, float* dOs, float* lse_s, float* delta_s,
                                              const T* q, const T* dout, const float* lse,
                                              const float* delta, int b, int h, int q0,
                                              int seq_q, int num_heads, float scale) {
  constexpr int LD = BwdTile<D>::kLD;
  const long long q_rs = static_cast<long long>(num_heads) * D;
  const long long base = (static_cast<long long>(b) * seq_q + q0) * q_rs + static_cast<long long>(h) * D;
  const int valid = min(kBlockQ, seq_q - q0);
  stage_rows<T, D, LD, kThreads>(Qs, q + base, q_rs, kBlockQ, valid, scale);
  stage_rows<T, D, LD, kThreads>(dOs, dout + base, q_rs, kBlockQ, valid, 1.f);
  if (threadIdx.x < kBlockQ) {
    const int r = threadIdx.x;
    const long long idx = (static_cast<long long>(b) * seq_q + q0 + r) * num_heads + h;
    lse_s[r] = r < valid ? lse[idx] : -INFINITY;
    delta_s[r] = r < valid ? delta[idx] : 0.f;
  }
}

// Stage the key tile k0 .. k0 + 31 of KV head hk: K and V, zeros past S.
template <typename T, int D>
__device__ __forceinline__ void stage_keys(float* Ks, float* Vs, const T* k, const T* v, int b,
                                           int hk, int k0, int seq_k, int num_kv_heads) {
  constexpr int LD = BwdTile<D>::kLD;
  const long long kv_rs = static_cast<long long>(num_kv_heads) * D;
  const long long base = (static_cast<long long>(b) * seq_k + k0) * kv_rs + static_cast<long long>(hk) * D;
  const int valid = min(kBlockK, seq_k - k0);
  stage_rows<T, D, LD, kThreads>(Ks, k + base, kv_rs, kBlockK, valid, 1.f);
  stage_rows<T, D, LD, kThreads>(Vs, v + base, kv_rs, kBlockK, valid, 1.f);
}

// For query row `row` of the staged tile and keys k0 + part + 4 i: the
// scaled scores S = Qs K^T (Qs carries the scale), P = exp(S - lse) (0 where
// masked or where the row saw no key), dP = dO V^T and dS = P (dP - delta).
// Writes P (when Ps is not null) and dS into the tiles, row-major.
template <int D>
__device__ __forceinline__ void probs_and_dscores(const float* Qs, const float* dOs,
                                                  const float* Ks, const float* Vs, float* Ps,
                                                  float* dSs, const float* lse_s,
                                                  const float* delta_s, int row, int part,
                                                  int k0, int qpos, int seq_k, int causal,
                                                  int window) {
  constexpr int LD = BwdTile<D>::kLD;
  float s[kScores];
  float dp[kScores];
#pragma unroll
  for (int i = 0; i < kScores; ++i) {
    s[i] = 0.f;
    dp[i] = 0.f;
  }
  const float* qr = Qs + row * LD;
  const float* orow = dOs + row * LD;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(qr + d);
    const float4 ov = *reinterpret_cast<const float4*>(orow + d);
#pragma unroll
    for (int i = 0; i < kScores; ++i) {
      const int key = part + kRowThreads * i;
      const float4 kv = *reinterpret_cast<const float4*>(Ks + key * LD + d);
      const float4 vv = *reinterpret_cast<const float4*>(Vs + key * LD + d);
      s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      dp[i] += ov.x * vv.x + ov.y * vv.y + ov.z * vv.z + ov.w * vv.w;
    }
  }
  const float lse_r = lse_s[row];
  const float delta_r = delta_s[row];
  const bool seen = lse_r != -INFINITY;
#pragma unroll
  for (int i = 0; i < kScores; ++i) {
    const int key = part + kRowThreads * i;
    const bool ok = seen && visible(k0 + key, qpos, seq_k, causal, window);
    const float p = ok ? expf(s[i] - lse_r) : 0.f;
    if (Ps != nullptr) Ps[row * kLDP + key] = p;
    dSs[row * kLDP + key] = p * (dp[i] - delta_r);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  constexpr int E = Vec16<T>::kElems;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float sum = 0.f;
  for (int d = lane * E; d < D; d += 32 * E) {
    float a[E];
    float g[E];
    load16(o + row * D + d, a, 1.f);
    load16(dout + row * D + d, g, 1.f);
#pragma unroll
    for (int i = 0; i < E; ++i) sum += a[i] * g[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int seq_q, int seq_k, int num_heads, int num_kv_heads, float scale,
                      int causal, int window, int offset) {
  using C = BwdTile<D>;
  constexpr int LD = C::kLD;
  constexpr int NC = C::kKeyChunks;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlockK * LD;
  float* Qs = Vs + kBlockK * LD;
  float* dOs = Qs + kBlockQ * LD;
  float* Ps = dOs + kBlockQ * LD;
  float* dSs = Ps + kBlockQ * kLDP;
  float* lse_s = dSs + kBlockQ * kLDP;
  float* delta_s = lse_s + kBlockQ;

  const int k0 = blockIdx.x * kBlockK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = num_heads / num_kv_heads;
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;    // query row of S, dP
  const int part = tid % kRowThreads;
  const int krow = tid / kKeyThreads;   // key row of dK, dV
  const int kpart = tid % kKeyThreads;

  stage_keys<T, D>(Ks, Vs, k, v, b, hk, k0, seq_k, num_kv_heads);

  // the query rows that see a key of this tile (q_tile_range)
  const int k_last = min(k0 + kBlockK, seq_k) - 1;
  int t_lo = 0;
  int t_hi = seq_q - 1;
  if (causal) {
    t_lo = max(0, k0 - offset);
    if (window > 0) t_hi = min(t_hi, k_last + window - 1 - offset);
  }
  const int qt_first = t_lo / kBlockQ;
  const int qt_end = t_lo <= t_hi ? t_hi / kBlockQ + 1 : qt_first;

  float dk_acc[4 * NC];
  float dv_acc[4 * NC];
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = qt_first; qt < qt_end; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the previous query tile is consumed before it is overwritten
      stage_queries<T, D>(Qs, dOs, lse_s, delta_s, q, dout, lse, delta, b, h, q0, seq_q,
                          num_heads, scale);
      __syncthreads();
      probs_and_dscores<D>(Qs, dOs, Ks, Vs, Ps, dSs, lse_s, delta_s, row, part, k0,
                           q0 + row + offset, seq_k, causal, window);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Qs (Qs carries the scale)
      for (int r = 0; r < kBlockQ; ++r) {
        const float p = Ps[r * kLDP + krow];
        const float ds = dSs[r * kLDP + krow];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = 4 * (kpart + kKeyThreads * c);
          const float4 ov = *reinterpret_cast<const float4*>(dOs + r * LD + col);
          const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LD + col);
          dv_acc[4 * c] += p * ov.x;
          dv_acc[4 * c + 1] += p * ov.y;
          dv_acc[4 * c + 2] += p * ov.z;
          dv_acc[4 * c + 3] += p * ov.w;
          dk_acc[4 * c] += ds * qv.x;
          dk_acc[4 * c + 1] += ds * qv.y;
          dk_acc[4 * c + 2] += ds * qv.z;
          dk_acc[4 * c + 3] += ds * qv.w;
        }
      }
    }
  }

  if (k0 + krow < seq_k) {
    const long long kv_rs = static_cast<long long>(num_kv_heads) * D;
    const long long base =
        (static_cast<long long>(b) * seq_k + k0 + krow) * kv_rs + static_cast<long long>(hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * (kpart + kKeyThreads * c);
      store4(dk + base + col, dk_acc[4 * c], dk_acc[4 * c + 1], dk_acc[4 * c + 2],
             dk_acc[4 * c + 3]);
      store4(dv + base + col, dv_acc[4 * c], dv_acc[4 * c + 1], dv_acc[4 * c + 2],
             dv_acc[4 * c + 3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int seq_q, int seq_k,
                    int num_heads, int num_kv_heads, float scale, int causal, int window,
                    int offset) {
  using C = BwdTile<D>;
  constexpr int LD = C::kLD;
  constexpr int NC = C::kRowChunks;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlockK * LD;
  float* Qs = Vs + kBlockK * LD;
  float* dOs = Qs + kBlockQ * LD;
  float* dSs = dOs + kBlockQ * LD + kBlockQ * kLDP;   // the P tile's room is unused here
  float* lse_s = dSs + kBlockQ * kLDP;
  float* delta_s = lse_s + kBlockQ;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (num_heads / num_kv_heads);
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int part = tid % kRowThreads;

  stage_queries<T, D>(Qs, dOs, lse_s, delta_s, q, dout, lse, delta, b, h, q0, seq_q, num_heads,
                      scale);

  // the key tiles this query tile sees (kv_tile_range)
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + kBlockQ, seq_q) - 1 + offset;
  int k_begin = 0;
  int k_end = seq_k;
  if (causal) {
    k_end = min(seq_k, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  k_begin = (k_begin / kBlockK) * kBlockK;

  float acc[4 * NC];
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous key tile and dS are consumed
    stage_keys<T, D>(Ks, Vs, k, v, b, hk, k0, seq_k, num_kv_heads);
    __syncthreads();
    probs_and_dscores<D>(Qs, dOs, Ks, Vs, nullptr, dSs, lse_s, delta_s, row, part, k0,
                         q0 + row + offset, seq_k, causal, window);
    __syncthreads();
    for (int key = 0; key < kBlockK; ++key) {
      const float ds = dSs[row * kLDP + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + key * LD + 4 * (part + kRowThreads * c));
        acc[4 * c] += ds * kv.x;
        acc[4 * c + 1] += ds * kv.y;
        acc[4 * c + 2] += ds * kv.z;
        acc[4 * c + 3] += ds * kv.w;
      }
    }
  }

  if (q0 + row < seq_q) {
    const long long q_rs = static_cast<long long>(num_heads) * D;
    T* out = dq + (static_cast<long long>(b) * seq_q + q0 + row) * q_rs + static_cast<long long>(h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store4(out + 4 * (part + kRowThreads * c), acc[4 * c] * scale, acc[4 * c + 1] * scale,
             acc[4 * c + 2] * scale, acc[4 * c + 3] * scale);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Tq, int Sk,
           int Hq, int Hkv, float scale, int causal, int window, int offset,
           cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * Tq * Hq;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), dop, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int bytes = BwdTile<D>::kSmemBytes;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid_kv((Sk + kBlockK - 1) / kBlockK, Hkv, B);
  flash_bwd_dkdv_kernel<T, D><<<grid_kv, kThreads, bytes, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Tq, Sk, Hq, Hkv,
      scale, causal, window, offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid_q((Tq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, bytes, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), Tq, Sk, Hq, Hkv, scale, causal, window,
      offset);
  return cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
             int B, int Tq, int Sk, int Hq, int Hkv, float scale, int causal, int window,
             int offset, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Tq, Sk, Hq, Hkv, scale,
                           causal, window, offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Tq, Sk, Hq, Hkv, scale,
                           causal, window, offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Tq, Sk, Hq, Hkv, scale,
                            causal, window, offset, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Tq, Sk, Hq, Hkv, scale,
                            causal, window, offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// The gradient of K1.  dtype 0 is fp32, 1 bf16; every tensor dense; lse (the
// forward's) and delta (scratch) are (B, T, Hq) fp32; window <= 0 means no
// window; query t sits at key position q_offset + t.  Three launches on
// `stream`.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse, void* delta,
                                   void* dq, void* dk, void* dv, int B, int T, int S, int Hq,
                                   int Hkv, int D, float scale, int causal, int window,
                                   int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0)
    return repro_torch::launch_d<float>(D, q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, B, T, S,
                                        Hq, Hkv, scale, causal, window, q_offset, st);
  if (dtype == 1)
    return repro_torch::launch_d<__nv_bfloat16>(D, q, k, v, o, dout, lse_f, delta_f, dq, dk, dv,
                                                B, T, S, Hq, Hkv, scale, causal, window,
                                                q_offset, st);
  return cudaErrorInvalidValue;
}
