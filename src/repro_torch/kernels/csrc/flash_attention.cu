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
// What bounds it: at the llama3_8b prefill shape (T=512 after 512 cached
// tokens, 32 query and 8 KV heads of 128) the two products are 6.45 GFLOP on
// 12.6 MB of inputs, about 500 operations a byte, so the card's bf16
// tensor-core rate is the bound; only wgmma reaches it.
//
// Two kernels share the contract.  bf16 inputs (the model's type) take
// flash_fwd_wgmma_kernel, the Hopper design described above it.  fp32 inputs
// take flash_fwd_kernel, which keeps fp32 products on the CUDA cores so that
// it matches the plain version to 2e-4.
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

#include <cuda.h>  // CUtensorMap and its enums; libcuda itself is not linked
#include <math.h>

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
// bf16: TMA into a ring of shared-memory stages, both products on wgmma,
// GQA-packed query tiles
// ---------------------------------------------------------------------------
//
// flash_fwd_wgmma_kernel: one block per (query tile, packed head group, KV
// head, batch).  A tile's 64 * NWG rows are `pack` query heads of one KV head
// (the largest power of two dividing both G and the rows) at consecutive
// positions, in (position, head) order: q[b, t, h0:h0+pack, :] is contiguous,
// so the tile is one 3-D box of TMA and each K/V tile is staged once for all
// the packed heads instead of once per head.
//
// Warp roles.  The last warpgroup is the producer: one thread issues TMA loads
// (Q once, then K and V tiles into a two-stage ring guarded by full and
// empty mbarriers), and beside two consumer warpgroups the producer gives
// them its registers (setmaxnreg).  Each consumer warpgroup owns 64 rows: S = Q K^T runs as a
// wgmma with both operands in shared memory (K-major), the online softmax runs
// in registers in the log2 domain, and O += P V runs as a wgmma with P from
// registers (rounded to bf16) and V in shared memory read MN-major.  The next
// tile's Q K^T is issued before this tile's P V, so that its softmax overlaps
// the P V product on the tensor cores.
//
// Shared memory follows TMA's swizzle: 128-byte rows (D = 64, and D = 128 as
// two 64-column slabs) use the 128B swizzle, 64-byte rows (D = 32) the 64B
// swizzle, and the wgmma descriptors name the same layout.  Out-of-range rows
// of Q (past T) and of K/V (past S) arrive as zeros; the masks decide.  Only a
// KV tile that an edge crosses (the causal diagonal, the window's start or
// S's end) is masked (tile_needs_mask); interior tiles skip the arithmetic.
// Blocks are ordered so that the query tiles that see the most keys start
// first.

template <int D, int BK, int NWG>
struct Tile {
  static constexpr int kRows = 64 * NWG;                // query rows a block
  static constexpr int kRowBytes = D >= 64 ? 128 : 64;  // bytes of a row of one slab
  static constexpr int kCols = kRowBytes / 2;           // bf16 columns of a slab
  static constexpr int kSlabs = D / kCols;              // 2 at D = 128, else 1
  static constexpr int kLayout = D >= 64 ? 1 : 2;       // wgmma descriptor: 128B or 64B swizzle
  static constexpr int kGroupBytes = 8 * kRowBytes;     // one 8-row core group
  static constexpr int kStages = 2;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = BK * D * 2;
  static constexpr int kThreads = 128 * (NWG + 1);      // consumers, then the producer
  static constexpr int kBarrierBytes = 8 * (1 + 4 * kStages);
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period
  static constexpr int kSmemBytes = 1024 + kQBytes + 2 * kStages * kKVBytes + kBarrierBytes;
  static_assert(kSmemBytes <= 232448, "more shared memory than a block may have");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  A wait that
// lasts seconds means a broken pipeline: it traps, so the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 28)) __trap();
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout (1 = 128B, 2 = 64B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie registers that an asynchronous wgmma reads or writes to this point of
// the program, so that the compiler moves no use of them across a wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int NREG>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(NREG));
}
template <int NREG>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(NREG));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (m64n64, fp32) = A (smem) * B (smem), both K-major; d is overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64n128, fp32) = A (smem) * B (smem), both K-major; d is overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64n32, fp32) += A (registers, bf16) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (m64n64, fp32) += A (registers, bf16) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (m64n128, fp32) += A (registers, bf16) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(N == 128, "S tiles are 64 or 128 keys wide");
    wgmma_ss_n128(d, desc_a, desc_b, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 32) {
    wgmma_rs_n32(d, a, desc_b);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc_b);
  } else {
    static_assert(N == 128, "head dims are 32, 64 or 128");
    wgmma_rs_n128(d, a, desc_b);
  }
}

// Issue S = Q K^T for this warpgroup's 64 rows against one K tile and commit
// it as one wgmma group.  Both operands are K-major: a k16 step moves 32
// bytes along a swizzled row, and D = 128 crosses into the second slab.
template <int D, int BK, int NWG>
__device__ __forceinline__ void qk_issue(float (&s)[BK / 2], uint32_t q_addr, uint32_t k_addr) {
  using C = Tile<D, BK, NWG>;
  constexpr int kSteps = C::kCols / 16;  // k16 steps within a slab
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int slab = kk / kSteps;
    const int step = kk % kSteps;
    const uint64_t da = gmma_desc(q_addr + slab * C::kRows * C::kRowBytes + step * 32, 16,
                                  C::kGroupBytes, C::kLayout);
    const uint64_t db = gmma_desc(k_addr + slab * BK * C::kRowBytes + step * 32, 16,
                                  C::kGroupBytes, C::kLayout);
    wgmma_ss<BK>(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V for one V tile and commit it.  P is the A operand from
// registers; V is the B operand read MN-major (its rows are keys, its
// columns the output dims): a k16 step moves 16 rows, the 8-row groups are
// kGroupBytes apart and the two 64-column slabs of D = 128 kKV/2 apart.
template <int D, int BK, int NWG>
__device__ __forceinline__ void pv_issue(float (&acc)[D / 2], const uint32_t (&p)[BK / 16][4],
                                         uint32_t v_addr) {
  using C = Tile<D, BK, NWG>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = gmma_desc(v_addr + kk * 16 * C::kRowBytes, BK * C::kRowBytes,
                                  C::kGroupBytes, C::kLayout);
    wgmma_rs<D>(acc, p[kk], db);
  }
  wgmma_commit();
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

// The online softmax of one S tile for this thread's two rows (fragment rows
// g and g + 8), in the log2 domain and in place: scales (and, with MASK,
// masks) the scores, updates the running max m and sum l, turns s into P and
// returns each row's rescale factor of the accumulator.  The sum takes P
// before it is rounded to bf16, as the plain version's fp32 softmax does.
// The mask compares each column's compile-time offset from the thread's
// first key (k0 + 2t) with the row's first and last visible key.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, int k0,
                                             const int (&qpos)[2], int t, int seq_k, int causal,
                                             int window) {
  int lo[2] = {0, 0};
  int hi[2] = {0, 0};
  if constexpr (MASK) {
    const int base = k0 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int first = 0;
      int last = seq_k - 1;
      if (causal) {
        last = min(last, qpos[r]);
        if (window > 0) first = qpos[r] - window + 1;
      }
      lo[r] = first - base;
      hi[r] = last - base;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if constexpr (MASK) {
        const int col = 8 * j + (e & 1);
        x = (col >= lo[e >> 1] && col <= hi[e >> 1]) ? x : -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible: p = 0
    alpha[r] = fast_exp2(m[r] - m_use[r]);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = fast_exp2(s[4 * j + e] - m_use[e >> 1]);
      sum[e >> 1] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * alpha[r] + sum[r];
  }
}

// P rounded to bf16 as the A fragments of P V: the S accumulator's layout is
// the A fragment layout of a k16 step (keys 16kk..16kk+15 are the chunks 2kk
// and 2kk + 1).
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int BK>
__device__ __forceinline__ void softmax_tile(bool mask, float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], float scale_log2,
                                             int k0, const int (&qpos)[2], int t, int seq_k,
                                             int causal, int window) {
  if (mask) {
    softmax_tile<BK, true>(s, m, l, alpha, scale_log2, k0, qpos, t, seq_k, causal, window);
  } else {
    softmax_tile<BK, false>(s, m, l, alpha, scale_log2, k0, qpos, t, seq_k, causal, window);
  }
}

// Same contract as flash_fwd_kernel, for bf16 (see the note above).  The
// maps are 4-D (D, heads, positions, batch); q's boxes are (slab columns,
// pack, positions, 1), k's and v's (slab columns, 1, BK, 1).
template <int D, int BK, int NWG>
__global__ void __launch_bounds__(Tile<D, BK, NWG>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       int batch, int seq_q, int seq_k, int num_heads, int num_kv_heads,
                       int pack_log2, int q_tiles, long long o_sb, float scale_log2, int causal,
                       int window) {
  using C = Tile<D, BK, NWG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sK = sQ + C::kQBytes;
  unsigned char* sV = sK + C::kStages * C::kKVBytes;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + C::kStages * C::kKVBytes);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + C::kStages;
  uint64_t* empty_k = full_v + C::kStages;
  uint64_t* empty_v = empty_k + C::kStages;

  // the block's tile: the heaviest query tiles (last in T) come first
  const int group = num_heads / num_kv_heads;
  const int groups = group >> pack_log2;
  const int positions = C::kRows >> pack_log2;
  const int per_tile = groups * num_kv_heads * batch;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int hg = rest % groups;
  rest /= groups;
  const int hk = rest % num_kv_heads;
  const int b = rest / num_kv_heads;
  const int q0 = qt * positions;
  const int head0 = hk * group + (hg << pack_log2);

  // the KV tiles it sees
  const int offset = seq_k - seq_q;
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + positions, seq_q) - 1 + offset;
  int k_begin = 0;
  int k_end = seq_k;
  if (causal) {
    k_end = min(seq_k, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  const int kt_begin = k_begin / BK;
  const int n_tiles = (k_end + BK - 1) / BK - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(&full_k[st], 1);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty_k[st], 128 * NWG);
      mbar_init(&empty_v[st], 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer: one thread keeps the ring full ----
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int sl = 0; sl < C::kSlabs; ++sl)
        tma_load_4d(sQ + sl * C::kRows * C::kRowBytes, &tm_q, bar_q, sl * C::kCols, head0, q0, b);
      // K of tile i + 1 goes out before V of tile i: a K stage frees as soon
      // as its S is computed, a V stage only after its P V
      auto load = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* full,
                      uint64_t* empty, int i) {
        const int st = i % C::kStages;
        mbar_wait(&empty[st], ((i / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::kKVBytes);
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl)
          tma_load_4d(ring + st * C::kKVBytes + sl * BK * C::kRowBytes, map, &full[st],
                      sl * C::kCols, hk, (kt_begin + i) * BK, b);
      };
      load(&tm_k, sK, full_k, empty_k, 0);
      for (int i = 0; i < n_tiles; ++i) {
        if (i + 1 < n_tiles) load(&tm_k, sK, full_k, empty_k, i + 1);
        load(&tm_v, sV, full_v, empty_v, i);
      }
    }
  } else {
    // ---- consumers: 64 rows a warpgroup ----
    if constexpr (NWG == 2) setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int row0 = 64 * wg + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
    const int qpos[2] = {q0 + (row0 >> pack_log2) + offset,
                         q0 + ((row0 + 8) >> pack_log2) + offset};
    const uint32_t q_addr = smem_u32(sQ) + wg * 64 * C::kRowBytes;
    const uint32_t k_addr = smem_u32(sK);
    const uint32_t v_addr = smem_u32(sV);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2];
    float s[BK / 2];
    uint32_t p[BK / 16][4];

    mbar_wait(bar_q, 0);
    // the first tile: S, then its softmax (nothing to rescale yet)
    mbar_wait(&full_k[0], 0);
    qk_issue<D, BK, NWG>(s, q_addr, k_addr);
    wgmma_wait<0>();
    reg_fence(s);
    mbar_arrive(&empty_k[0]);
    softmax_tile<BK>(tile_needs_mask(kt_begin * BK, BK, seq_k, q_lo, q_hi, causal, window), s,
                     m, l, alpha, scale_log2, kt_begin * BK, qpos, t, seq_k, causal, window);
    pack_p<BK>(s, p);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % C::kStages;
      const int prev = (i - 1) % C::kStages;
      const int k0 = (kt_begin + i) * BK;
      // S of this tile and P V of the previous one go out together ...
      mbar_wait(&full_k[st], (i / C::kStages) & 1);
      reg_fence(acc);
      reg_fence(p);
      qk_issue<D, BK, NWG>(s, q_addr, k_addr + st * C::kKVBytes);
      mbar_wait(&full_v[prev], ((i - 1) / C::kStages) & 1);
      pv_issue<D, BK, NWG>(acc, p, v_addr + prev * C::kKVBytes);
      // ... and this tile's softmax runs while P V is on the tensor cores
      wgmma_wait<1>();
      reg_fence(s);
      mbar_arrive(&empty_k[st]);
      softmax_tile<BK>(tile_needs_mask(k0, BK, seq_k, q_lo, q_hi, causal, window), s, m, l,
                       alpha, scale_log2, k0, qpos, t, seq_k, causal, window);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(p);
      mbar_arrive(&empty_v[prev]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      pack_p<BK>(s, p);
    }
    // P V of the last tile
    const int last = (n_tiles - 1) % C::kStages;
    mbar_wait(&full_v[last], ((n_tiles - 1) / C::kStages) & 1);
    reg_fence(acc);
    reg_fence(p);
    wgmma_fence();
    pv_issue<D, BK, NWG>(acc, p, v_addr + last * C::kKVBytes);
    wgmma_wait<0>();
    reg_fence(acc);

    // epilogue: normalise by l and write bf16 in the packed order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const int pos = q0 + (row >> pack_log2);
      if (pos < seq_q) {
        const int head = head0 + (row & ((1 << pack_log2) - 1));
        const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // a fully masked row gives 0
        __nv_bfloat16* orow =
            o + b * o_sb + (static_cast<long long>(pos) * num_heads + head) * D + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Tq,
                       int Sk, int Hq, int Hkv, long long q_sb, long long k_sb, long long v_sb,
                       long long o_sb, float scale, int causal, int window,
                       cudaStream_t stream) {
  dim3 grid((Tq + kBlockQ - 1) / kBlockQ, Hq, B);
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal, window);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, found through the runtime so that nothing links
// libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kErrTensorMap = 1000;    // + the CUresult of a refused encoding
constexpr int kErrNoEncoder = 3000;    // the driver has no cuTensorMapEncodeTiled

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(sym);
  }();
  return fn;
}

// A 4-D map (D, heads, positions, batch) over a bf16 tensor dense past its
// batch dimension, whose batch stride is batch_stride elements; boxes of
// (cols, box_heads, box_rows, 1); positions past n read as zeros.
int encode_map(CUtensorMap* map, const void* base, int D, int heads, int n, int B,
               long long batch_stride, int cols, int box_heads, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
         cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(res);
}

template <int D, int BK, int NWG>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Tq, int Sk,
                int Hq, int Hkv, long long q_sb, long long k_sb, long long v_sb, long long o_sb,
                float scale, int causal, int window, int pack_log2, cudaStream_t stream) {
  using C = Tile<D, BK, NWG>;
  const int positions = C::kRows >> pack_log2;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_map(&tm_q, q, D, Hq, Tq, B, q_sb, C::kCols, 1 << pack_log2, positions);
  if (err == 0) err = encode_map(&tm_k, k, D, Hkv, Sk, B, k_sb, C::kCols, 1, BK);
  if (err == 0) err = encode_map(&tm_v, v, D, Hkv, Sk, B, v_sb, C::kCols, 1, BK);
  if (err != 0) return err;
  const int q_tiles = (Tq + positions - 1) / positions;
  const long long blocks =
      static_cast<long long>(q_tiles) * ((Hq / Hkv) >> pack_log2) * Hkv * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, BK, NWG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::kSmemBytes);
  if (e != cudaSuccess) return e;
  flash_fwd_wgmma_kernel<D, BK, NWG><<<static_cast<unsigned>(blocks), C::kThreads,
                                       C::kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), B, Tq, Sk, Hq, Hkv, pack_log2, q_tiles,
      o_sb, scale * 1.4426950408889634f, causal, window);  // exp(x) = exp2(x * log2 e)
  return cudaGetLastError();
}

// The three tile choices: 64 rows and 64 or 128 keys (one consumer
// warpgroup), 128 rows and 64 keys (two; with 128 keys they would spill).
template <int D>
int launch_bf16_tiles(int block_rows, int block_keys, const void* q, const void* k,
                      const void* v, void* o, int B, int Tq, int Sk, int Hq, int Hkv,
                      long long q_sb, long long k_sb, long long v_sb, long long o_sb, float scale,
                      int causal, int window, int pack_log2, cudaStream_t stream) {
  if (block_rows == 64 && block_keys == 64)
    return launch_bf16<D, 64, 1>(q, k, v, o, B, Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb, scale,
                                 causal, window, pack_log2, stream);
  if (block_rows == 64 && block_keys == 128)
    return launch_bf16<D, 128, 1>(q, k, v, o, B, Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb, scale,
                                  causal, window, pack_log2, stream);
  if (block_rows == 128 && block_keys == 64)
    return launch_bf16<D, 64, 2>(q, k, v, o, B, Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb, scale,
                                 causal, window, pack_log2, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// fp32 inputs.  Strides are in elements; window <= 0 means no window.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       int B, int T, int S, int Hq, int Hkv, int D,
                                       long long q_sb, long long k_sb, long long v_sb,
                                       long long o_sb, float scale, int causal, int window,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return repro_torch::launch_f32<float, 32>(q, k, v, o, B, T, S, Hq, Hkv, q_sb, k_sb, v_sb,
                                                o_sb, scale, causal, window, st);
    case 64:
      return repro_torch::launch_f32<float, 64>(q, k, v, o, B, T, S, Hq, Hkv, q_sb, k_sb, v_sb,
                                                o_sb, scale, causal, window, st);
    case 128:
      return repro_torch::launch_f32<float, 128>(q, k, v, o, B, T, S, Hq, Hkv, q_sb, k_sb, v_sb,
                                                 o_sb, scale, causal, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 inputs, with the wrapper's plan: block_rows query rows a block and
// block_keys keys a KV tile (64 x 64, 64 x 128 or 128 x 64), 2^pack_log2
// query heads packed into a tile.  Every batch stride (elements) must be a multiple of 8
// and every base 16-byte aligned, as TMA requires.  Returns a cudaError_t,
// 1000 + the CUresult of a tensor map the driver refused, or 3000 when the
// driver lacks cuTensorMapEncodeTiled.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        int B, int T, int S, int Hq, int Hkv, int D,
                                        long long q_sb, long long k_sb, long long v_sb,
                                        long long o_sb, float scale, int causal, int window,
                                        int block_rows, int block_keys, int pack_log2,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return repro_torch::launch_bf16_tiles<32>(block_rows, block_keys, q, k, v, o, B, T, S, Hq,
                                               Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal, window,
                                               pack_log2, st);
    case 64:
      return repro_torch::launch_bf16_tiles<64>(block_rows, block_keys, q, k, v, o, B, T, S, Hq,
                                               Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal, window,
                                               pack_log2, st);
    case 128:
      return repro_torch::launch_bf16_tiles<128>(block_rows, block_keys, q, k, v, o, B, T, S, Hq,
                                                Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal, window,
                                                pack_log2, st);
    default:
      return cudaErrorInvalidValue;
  }
}
