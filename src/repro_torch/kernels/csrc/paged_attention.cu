// Paged decode attention: one query token per sequence over a paged KV pool
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (_paged_kernel).  The Pallas version dereferences the block table in its
// index map (scalar prefetch); here each block reads its own row of the
// table.
//
// Layout: q (B, Hq, D) dense; k/v pages (num_pages, page_size, Hkv, D)
// dense; block_tables (B, pages_per_seq) int32 dense; context_lens (B,)
// int32; o (B, Hq, D).  The G = Hq / Hkv query heads of KV head hk are
// hk*G .. hk*G + G - 1.
//
// Design: one block per (KV head, sequence), 256 threads.  The block stages
// its G query vectors once, then walks the sequence in tiles of 64 keys
// (64 / page_size pages) up to context_len, gathering each key's K and V row
// through the table into shared memory as fp32.  One thread scores one
// (head, key) pair, one warp per head runs the online-softmax update in fp32,
// and each thread owns fixed (head, dim) elements of the fp32 accumulator.
// Keys at or past context_len are masked and staged as zeros.  The bound is
// bytes: every K/V byte of the context is read once.  One block per (KV head,
// sequence) leaves most SMs idle at small batch; splitting long contexts
// across blocks is later work.
#include "common.cuh"

#include <math.h>

namespace repro_torch {
namespace {

constexpr int kTileK = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxElems = 8;  // accumulator values per thread: G * D <= 2048

template <int D>
int smem_bytes(int G) {
  const int LD = D + 4;
  return (G * LD + 2 * kTileK * LD + G * (kTileK + 1) + 3 * G) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                 const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                 const int* __restrict__ context_lens, T* __restrict__ o, int num_heads,
                 int num_kv_heads, int page_size, int pages_per_seq, float scale) {
  constexpr int LD = D + 4;
  constexpr int E = Vec16<T>::kElems;
  constexpr int CHUNKS = D / E;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = num_heads / num_kv_heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* Qs = smem;                  // (G, LD)
  float* Ks = Qs + G * LD;           // (kTileK, LD)
  float* Vs = Ks + kTileK * LD;      // (kTileK, LD)
  float* Ss = Vs + kTileK * LD;      // (G, kTileK + 1) scores, then p
  float* Ms = Ss + G * (kTileK + 1); // (G,) running max
  float* Ls = Ms + G;                // (G,) running sum
  float* As = Ls + G;                // (G,) rescale of this tile

  const int ctx = min(context_lens[b], pages_per_seq * page_size);
  const int* table = block_tables + static_cast<long long>(b) * pages_per_seq;

  stage_rows<T, D, LD, kThreads>(Qs, q + (static_cast<long long>(b) * num_heads + hk * G) * D, D,
                                 G, G, scale);
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = -INFINITY;
    Ls[g] = 0.f;
  }

  const int n_elems = G * D;
  float acc[kMaxElems];
#pragma unroll
  for (int e = 0; e < kMaxElems; ++e) acc[e] = 0.f;

  for (int k0 = 0; k0 < ctx; k0 += kTileK) {
    __syncthreads();  // the previous tile is consumed before it is overwritten
    // gather the tile's K and V rows through the block table
    for (int idx = tid; idx < kTileK * CHUNKS; idx += kThreads) {
      const int j = idx / CHUNKS;
      const int c = idx % CHUNKS;
      const int key = k0 + j;
      float kv[E];
      float vv[E];
      if (key < ctx) {
        const long long page = table[key / page_size];
        const long long off =
            ((page * page_size + key % page_size) * num_kv_heads + hk) * D + c * E;
        load16(k_pages + off, kv, 1.f);
        load16(v_pages + off, vv, 1.f);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) kv[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < E; i += 4) {
        store4(Ks + j * LD + c * E + i, kv[i], kv[i + 1], kv[i + 2], kv[i + 3]);
        store4(Vs + j * LD + c * E + i, vv[i], vv[i + 1], vv[i + 2], vv[i + 3]);
      }
    }
    __syncthreads();

    // one (head, key) score per thread
    for (int idx = tid; idx < G * kTileK; idx += kThreads) {
      const int g = idx / kTileK;
      const int j = idx % kTileK;
      const float* qr = Qs + g * LD;
      const float* kr = Ks + j * LD;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr + d);
        const float4 c = *reinterpret_cast<const float4*>(kr + d);
        s += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
      }
      Ss[g * (kTileK + 1) + j] = (k0 + j < ctx) ? s : -INFINITY;
    }
    __syncthreads();

    // online softmax, one warp per head; key k0 is always visible, so the
    // new max is finite
    for (int g = warp; g < G; g += kWarps) {
      float* sr = Ss + g * (kTileK + 1);
      const float a = sr[lane];
      const float c = sr[lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int w = 16; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float pa = expf(a - m_new);
      const float pc = expf(c - m_new);
      sr[lane] = pa;
      sr[lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int w = 16; w > 0; w /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V over this tile's visible keys
    const int jmax = min(kTileK, ctx - k0);
#pragma unroll
    for (int e = 0; e < kMaxElems; ++e) {
      const int idx = tid + e * kThreads;
      if (idx < n_elems) {
        const int g = idx / D;
        const int d = idx % D;
        const float* pr = Ss + g * (kTileK + 1);
        float s = 0.f;
        for (int j = 0; j < jmax; ++j) s += pr[j] * Vs[j * LD + d];
        acc[e] = acc[e] * As[g] + s;
      }
    }
  }
  __syncthreads();

  T* orow = o + (static_cast<long long>(b) * num_heads + hk * G) * D;
#pragma unroll
  for (int e = 0; e < kMaxElems; ++e) {
    const int idx = tid + e * kThreads;
    if (idx < n_elems) {
      const float l = Ls[idx / D];
      store1(orow + idx, l > 0.f ? acc[e] / l : 0.f);  // an empty context gives 0
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* ctx, void* o, int B, int Hq, int Hkv, int page_size,
                   int pages_per_seq, float scale, cudaStream_t stream) {
  const int bytes = smem_bytes<D>(Hq / Hkv);
  cudaError_t err = cudaFuncSetAttribute(paged_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  paged_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables, ctx,
      static_cast<T*>(o), Hq, Hkv, page_size, pages_per_seq, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp, const int* tables,
                       const int* ctx, void* o, int B, int Hq, int Hkv, int page_size,
                       int pages_per_seq, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, kp, vp, tables, ctx, o, B, Hq, Hkv, page_size, pages_per_seq, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, kp, vp, tables, ctx, o, B, Hq, Hkv, page_size, pages_per_seq, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, kp, vp, tables, ctx, o, B, Hq, Hkv, page_size, pages_per_seq,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                   const void* block_tables, const void* context_lens, void* o,
                                   int B, int Hq, int Hkv, int D, int page_size,
                                   int pages_per_seq, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tables = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(context_lens);
  if (dtype == 0) {
    return repro_torch::dispatch_d<float>(D, q, k_pages, v_pages, tables, ctx, o, B, Hq, Hkv,
                                          page_size, pages_per_seq, scale, st);
  }
  if (dtype == 1) {
    return repro_torch::dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, tables, ctx, o, B, Hq,
                                                  Hkv, page_size, pages_per_seq, scale, st);
  }
  return cudaErrorInvalidValue;
}
