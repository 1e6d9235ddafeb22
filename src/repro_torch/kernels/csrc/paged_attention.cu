// Paged decode attention: one query token per sequence over a paged KV pool
// (sm_90a), split across the context (flash-decoding).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (_paged_kernel).  The Pallas version dereferences the block table in its
// index map (scalar prefetch) and walks a sequence's pages along a
// sequential grid axis; here each block reads its own slice of the table.
//
// Layout: q (B, Hq, D) dense; k/v pages (num_pages, page_size, Hkv, D)
// dense; block_tables (B, pages_per_seq) int32 dense; context_lens (B,)
// int32; o (B, Hq, D).  The G = Hq / Hkv query heads of KV head hk are
// hk*G .. hk*G + G - 1.
//
// Bound: bytes.  Every K/V byte of a context is read once, for all G query
// heads of its KV head together, and each byte takes two FLOPs a head.
//
// Design, two launches:
// 1. paged_fwd_partial: one block of 128 threads per (partition, KV head,
//    sequence).  A partition is kPartition = 64 consecutive keys (a multiple
//    of every page size; 32, 128 and 256 were slower on the H100, PERF.md);
//    the number of partitions comes from pages_per_seq, a shape, never from
//    context_lens, so the host reads no device value.  A
//    block whose partition starts at or past its context writes m = -inf,
//    l = 0 and exits.  The others stage their slice of the block table and
//    their G query rows, then stream the partition's K tiles and then its V
//    tiles (64 keys in bf16, 32 in fp32) through a two-stage ring in shared
//    memory, kept in the input type and filled by 16-byte cp.async, so the
//    gather of the next tile overlaps the math of this one.  The scores of
//    the whole partition stay in shared memory: after the last K tile one
//    warp per head takes the partition's max m and sum l of exp(s - m), and
//    the V tiles accumulate acc = sum p v in fp32.  (m, l, acc) go to fp32
//    scratch of shape (B, Hq, partitions[, D]).
// 2. paged_fwd_merge: one block of D threads per (query head, sequence)
//    combines the partitions exactly, o = sum exp(m_i - M) acc_i /
//    sum exp(m_i - M) l_i over the non-empty ones; an empty context gives 0.
#include "common.cuh"

#include <math.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroupElems = 2048;            // G * D the accumulator holds
constexpr int kMaxPairs = kMaxGroupElems / 2 / kThreads;  // (g, d) pairs a thread
constexpr int kPartition = 64;                  // keys a block of the first launch covers
constexpr int kMinPage = 8;                     // smallest page size

// Keys per staged tile: 64 rows of bf16 or 32 of fp32, about 17 KB at D = 128.
template <typename T>
struct TileK {
  static constexpr int value = sizeof(T) == 2 ? 64 : 32;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Row stride of a staged tile, in elements: D plus 16 bytes, so that the
// 16-byte reads of consecutive rows fall on different banks.
template <typename T, int D>
struct RowLd {
  static constexpr int value = D + 16 / static_cast<int>(sizeof(T));
};

// fp32 words ahead of the ring (queries, scores, m, l), rounded up to 16
// bytes so that the ring's cp.async destinations stay aligned.
__host__ __device__ constexpr int float_words(int G, int D) {
  return (G * (D + 4) + G * kPartition + 2 * G + 3) / 4 * 4;
}

template <typename T, int D>
constexpr int partial_smem_bytes(int G, int page_size) {
  return static_cast<int>(sizeof(float)) * float_words(G, D) +
         2 * TileK<T>::value * RowLd<T, D>::value * static_cast<int>(sizeof(T)) +
         static_cast<int>(sizeof(int)) * (kPartition / page_size);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_fwd_partial(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                  const int* __restrict__ context_lens, float* __restrict__ m_out,
                  float* __restrict__ l_out, float* __restrict__ acc_out, int num_heads,
                  int num_kv_heads, int page_size, int pages_per_seq, float scale) {
  constexpr int TK = TileK<T>::value;
  constexpr int LDK = RowLd<T, D>::value;
  constexpr int LDQ = D + 4;
  constexpr int E = Vec16<T>::kElems;
  constexpr int CHUNKS = D / E;

  const int part = blockIdx.x;
  const int num_parts = gridDim.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = num_heads / num_kv_heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // partials of query head hk*G + g live at row (b * Hq + hk * G + g) * num_parts + part
  const long long row0 = (static_cast<long long>(b) * num_heads + hk * G) * num_parts + part;

  const int ctx = min(context_lens[b], pages_per_seq * page_size);
  const int start = part * kPartition;
  if (start >= ctx) {  // an empty partition: the merge skips it
    for (int g = tid; g < G; g += kThreads) {
      m_out[row0 + static_cast<long long>(g) * num_parts] = -INFINITY;
      l_out[row0 + static_cast<long long>(g) * num_parts] = 0.f;
    }
    return;
  }
  const int n = min(kPartition, ctx - start);  // visible keys of this partition

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (G, LDQ) scaled queries
  float* Ss = Qs + G * LDQ;                     // (G, kPartition) scores, then p
  float* Ms = Ss + G * kPartition;              // (G,) max of the partition
  float* Ls = Ms + G;                           // (G,) sum of p
  T* ring = reinterpret_cast<T*>(Qs + float_words(G, D));  // 2 x (TK, LDK)
  int* tbl = reinterpret_cast<int*>(ring + 2 * TK * LDK);  // the partition's pages

  const int first_page = start / page_size;
  const int n_pages = (n + page_size - 1) / page_size;
  const int* table = block_tables + static_cast<long long>(b) * pages_per_seq + first_page;
  for (int i = tid; i < n_pages; i += kThreads) tbl[i] = table[i];
  stage_rows<T, D, LDQ, kThreads>(Qs, q + (static_cast<long long>(b) * num_heads + hk * G) * D,
                                  D, G, G, scale);
  __syncthreads();  // tbl is read by the first tile's copies

  const int n_k = (n + TK - 1) / TK;  // K tiles, then as many V tiles
  const int n_tiles = 2 * n_k;
  auto issue = [&](int t) {
    const T* pool = t < n_k ? k_pages : v_pages;
    const int k0 = (t < n_k ? t : t - n_k) * TK;
    T* dst = ring + (t & 1) * TK * LDK;
    for (int idx = tid; idx < TK * CHUNKS; idx += kThreads) {
      const int r = idx / CHUNKS;
      const int c = idx % CHUNKS;
      const int key = k0 + r;
      // keys past the context are zero-filled (src-size 0) from a valid address
      const int kk = key < n ? key : 0;
      const long long page = tbl[kk / page_size];
      const T* src = pool + ((page * page_size + kk % page_size) * num_kv_heads + hk) * D + c * E;
      cp_async16(dst + r * LDK + c * E, src, key < n ? 16 : 0);
    }
  };

  const int n_pairs = G * D / 2;
  float acc[kMaxPairs][2];
#pragma unroll
  for (int e = 0; e < kMaxPairs; ++e) acc[e][0] = acc[e][1] = 0.f;

  issue(0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) issue(t + 1);
    cp_async_commit();  // possibly empty, so that wait_group 1 always means tile t
    cp_async_wait_1();
    __syncthreads();
    const T* tile = ring + (t & 1) * TK * LDK;
    if (t < n_k) {
      // scores of this K tile: one (head, key) pair a thread
      const int k0 = t * TK;
      for (int idx = tid; idx < G * TK; idx += kThreads) {
        const int g = idx / TK;
        const int j = idx % TK;
        if (k0 + j < n) {
          const float* qr = Qs + g * LDQ;
          const T* kr = tile + j * LDK;
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < CHUNKS; ++c) {
            float kv[E];
            load16(kr + c * E, kv, 1.f);
#pragma unroll
            for (int i = 0; i < E; i += 4) {
              const float4 a = *reinterpret_cast<const float4*>(qr + c * E + i);
              s += a.x * kv[i] + a.y * kv[i + 1] + a.z * kv[i + 2] + a.w * kv[i + 3];
            }
          }
          Ss[g * kPartition + k0 + j] = s;
        }
      }
      if (t == n_k - 1) {
        __syncthreads();
        // the partition's softmax statistics, one warp per head; n >= 1, so
        // the max is finite
        for (int g = warp; g < G; g += kWarps) {
          float* sr = Ss + g * kPartition;
          float mx = -INFINITY;
          for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
          for (int w = 16; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
          float sum = 0.f;
          for (int j = lane; j < n; j += 32) {
            const float p = expf(sr[j] - mx);
            sr[j] = p;
            sum += p;
          }
#pragma unroll
          for (int w = 16; w > 0; w /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
          if (lane == 0) {
            Ms[g] = mx;
            Ls[g] = sum;
          }
        }
      }
    } else {
      // acc += p @ V over this V tile's visible keys; a thread owns (g, d, d+1)
      const int k0 = (t - n_k) * TK;
      const int jmax = min(TK, n - k0);
#pragma unroll
      for (int e = 0; e < kMaxPairs; ++e) {
        const int idx = tid + e * kThreads;
        if (idx < n_pairs) {
          const int g = (2 * idx) / D;
          const int d = (2 * idx) % D;
          const float* pr = Ss + g * kPartition + k0;
          float s0 = 0.f;
          float s1 = 0.f;
          for (int j = 0; j < jmax; ++j) {
            const float p = pr[j];
            const float2 v = load2(tile + j * LDK + d);
            s0 += p * v.x;
            s1 += p * v.y;
          }
          acc[e][0] += s0;
          acc[e][1] += s1;
        }
      }
    }
    __syncthreads();  // the tile is consumed before the next copy overwrites it
  }

  for (int g = tid; g < G; g += kThreads) {
    m_out[row0 + static_cast<long long>(g) * num_parts] = Ms[g];
    l_out[row0 + static_cast<long long>(g) * num_parts] = Ls[g];
  }
#pragma unroll
  for (int e = 0; e < kMaxPairs; ++e) {
    const int idx = tid + e * kThreads;
    if (idx < n_pairs) {
      const int g = (2 * idx) / D;
      const int d = (2 * idx) % D;
      *reinterpret_cast<float2*>(acc_out + (row0 + static_cast<long long>(g) * num_parts) * D + d) =
          make_float2(acc[e][0], acc[e][1]);
    }
  }
}

template <typename T>
__global__ void paged_fwd_merge(const float* __restrict__ m_in, const float* __restrict__ l_in,
                                const float* __restrict__ acc_in, T* __restrict__ o,
                                int num_heads, int num_parts, int D) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const long long row = (static_cast<long long>(b) * num_heads + h) * num_parts;
  float M = -INFINITY;
  for (int p = 0; p < num_parts; ++p) M = fmaxf(M, m_in[row + p]);
  float num = 0.f;
  float den = 0.f;
  if (M != -INFINITY) {
    for (int p = 0; p < num_parts; ++p) {
      const float m = m_in[row + p];
      if (m == -INFINITY) continue;  // an empty partition: its acc was never written
      const float w = expf(m - M);
      num += w * acc_in[(row + p) * D + d];
      den += w * l_in[row + p];
    }
  }
  store1(o + (static_cast<long long>(b) * num_heads + h) * D + d, den > 0.f ? num / den : 0.f);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* ctx, float* m, float* l, float* acc, void* o, int B, int Hq,
                   int Hkv, int page_size, int pages_per_seq, int num_parts, float scale,
                   cudaStream_t stream) {
  // the most any group and page size take stays within the 48 KB a block
  // gets without raising its limit
  static_assert(partial_smem_bytes<T, D>(kMaxGroupElems / D, kMinPage) <= 48 * 1024,
                "paged_fwd_partial needs more than 48 KB of shared memory");
  const int bytes = partial_smem_bytes<T, D>(Hq / Hkv, page_size);
  paged_fwd_partial<T, D><<<dim3(num_parts, Hkv, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables, ctx,
      m, l, acc, Hq, Hkv, page_size, pages_per_seq, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_fwd_merge<T><<<dim3(Hq, B), D, 0, stream>>>(m, l, acc, static_cast<T*>(o), Hq,
                                                   num_parts, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp, const int* tables,
                       const int* ctx, float* m, float* l, float* acc, void* o, int B, int Hq,
                       int Hkv, int page_size, int pages_per_seq, int num_parts, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, kp, vp, tables, ctx, m, l, acc, o, B, Hq, Hkv, page_size,
                           pages_per_seq, num_parts, scale, stream);
    case 64:
      return launch<T, 64>(q, kp, vp, tables, ctx, m, l, acc, o, B, Hq, Hkv, page_size,
                           pages_per_seq, num_parts, scale, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, tables, ctx, m, l, acc, o, B, Hq, Hkv, page_size,
                            pages_per_seq, num_parts, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// m_part, l_part: (B, Hq, num_parts) fp32 scratch; acc_part: (B, Hq,
// num_parts, D) fp32 scratch, with num_parts = max(1, ceil(pages_per_seq *
// page_size / 64)); the page size divides 64 and Hq / Hkv * D <= 2048.
// dtype: 0 = float32, 1 = bfloat16.  Two launches on `stream`.  Returns a
// cudaError_t (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                   const void* block_tables, const void* context_lens,
                                   void* m_part, void* l_part, void* acc_part, void* o, int B,
                                   int Hq, int Hkv, int D, int page_size, int pages_per_seq,
                                   float scale, int dtype, void* stream) {
  using repro_torch::kMaxGroupElems;
  using repro_torch::kMinPage;
  using repro_torch::kPartition;
  if (page_size < kMinPage || kPartition % page_size || Hkv <= 0 || Hq % Hkv ||
      Hq / Hkv * D > kMaxGroupElems || pages_per_seq < 0) {
    return cudaErrorInvalidValue;
  }
  const int num_parts = pages_per_seq * page_size > kPartition
                            ? (pages_per_seq * page_size + kPartition - 1) / kPartition
                            : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tables = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(context_lens);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  float* acc = static_cast<float*>(acc_part);
  if (dtype == 0) {
    return repro_torch::dispatch_d<float>(D, q, k_pages, v_pages, tables, ctx, m, l, acc, o, B,
                                          Hq, Hkv, page_size, pages_per_seq, num_parts, scale,
                                          st);
  }
  if (dtype == 1) {
    return repro_torch::dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, tables, ctx, m, l,
                                                  acc, o, B, Hq, Hkv, page_size, pages_per_seq,
                                                  num_parts, scale, st);
  }
  return cudaErrorInvalidValue;
}
