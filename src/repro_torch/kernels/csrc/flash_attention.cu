// Causal GQA flash attention for prefill and chunked prefill (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel).  Query t sits at key position q_offset + t; the Pallas
// kernel's alignment, the queries being the last T of S keys, is q_offset =
// S - T, the wrapper's default.  An optional window keeps q_pos - kv_pos <
// window.  A caller that merges two segments of keys (the deferred KV append:
// a cached prefix, then the new chunk) passes q_offset = S for the prefix,
// where the causal mask is vacuous and only the window applies, and asks for
// each row's log-sum-exp of its scaled scores, lse = m + log l, in fp32
// (B, T, Hq); a row that sees no key gets lse = -inf and output 0.
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
// Two kernels share the contract, both on the tensor cores.  bf16 inputs
// (the model's serving type) take flash_fwd_wgmma_kernel, described below.
// fp32 inputs (training, which keeps the reference's fp32 arithmetic) take
// flash_fwd_f32_kernel, the last kernel of this file: mma.sync on 3xTF32
// operands (mma.cuh), which holds the plain version's 2e-4 where one TF32
// pass would not.
#include "common.cuh"
#include "mma.cuh"

#include <cuda.h>  // CUtensorMap and its enums; libcuda itself is not linked
#include <math.h>

namespace repro_torch {
namespace {

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
// Shared memory follows TMA's swizzle: 128-byte rows (D = 64, and D = 128 and
// 256 as two and four 64-column slabs) use the 128B swizzle, 64-byte rows (D = 32) the 64B
// swizzle, and the wgmma descriptors name the same layout.  Out-of-range rows
// of Q (past T) and of K/V (past S) arrive as zeros; the masks decide.  Only a
// KV tile that an edge crosses (the causal diagonal, the window's start or
// S's end) is masked (tile_needs_mask); interior tiles skip the arithmetic.
// Blocks are ordered so that the query tiles that see the most keys start
// first.

constexpr int kSmemLimit = 232448;  // shared memory a block may have on the H100 (227 KB)

// Dynamic shared memory of flash_fwd_wgmma_kernel<D, BK, NWG>: 1024 bytes of
// slack to align the tiles to the swizzle's 1024-byte period, the Q tile,
// the K and V rings of two stages, the mbarriers.  Mirrored by
// repro_torch.kernels.flash_attention.smem_bytes.
constexpr int wgmma_smem_bytes(int D, int BK, int NWG) {
  return 1024 + 64 * NWG * D * 2 + 2 * 2 * BK * D * 2 + 8 * (1 + 4 * 2);
}

template <int D, int BK, int NWG>
struct Tile {
  static constexpr int kRows = 64 * NWG;                // query rows a block
  static constexpr int kRowBytes = D >= 64 ? 128 : 64;  // bytes of a row of one slab
  static constexpr int kCols = kRowBytes / 2;           // bf16 columns of a slab
  static constexpr int kSlabs = D / kCols;              // 4 at D = 256, 2 at D = 128, else 1
  static constexpr int kLayout = D >= 64 ? 1 : 2;       // wgmma descriptor: 128B or 64B swizzle
  static constexpr int kGroupBytes = 8 * kRowBytes;     // one 8-row core group
  static constexpr int kStages = 2;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = BK * D * 2;
  static constexpr int kThreads = 128 * (NWG + 1);      // consumers, then the producer
  static constexpr int kBarrierBytes = 8 * (1 + 4 * kStages);
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period
  static constexpr int kSmemBytes = 1024 + kQBytes + 2 * kStages * kKVBytes + kBarrierBytes;
  static_assert(kSmemBytes == wgmma_smem_bytes(D, BK, NWG),
                "wgmma_smem_bytes disagrees with the tile");
  static_assert(kSmemBytes <= kSmemLimit, "more shared memory than a block may have");
};

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
    static_assert(N == 128, "one P V product is 32, 64 or 128 columns wide");
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
// kGroupBytes apart and the 64-column slabs BK * kRowBytes apart.  A product
// covers at most 128 columns, so D = 256 takes two, each on its half of the
// accumulator (the fragments of columns 128.. follow those of 0..127) and
// its two slabs of V.
template <int D, int BK, int NWG>
__device__ __forceinline__ void pv_issue(float (&acc)[D / 2], const uint32_t (&p)[BK / 16][4],
                                         uint32_t v_addr) {
  using C = Tile<D, BK, NWG>;
  constexpr int kN = D > 128 ? 128 : D;  // columns of one product
#pragma unroll
  for (int part = 0; part < D / kN; ++part) {
    float(&d)[kN / 2] = *reinterpret_cast<float(*)[kN / 2]>(&acc[part * kN / 2]);
    const uint32_t base = v_addr + part * (kN / C::kCols) * BK * C::kRowBytes;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = gmma_desc(base + kk * 16 * C::kRowBytes, BK * C::kRowBytes,
                                    C::kGroupBytes, C::kLayout);
      wgmma_rs<kN>(d, p[kk], db);
    }
  }
  wgmma_commit();
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

// The contract at the top of this file, for bf16 (see the note above).  The
// maps are 4-D (D, heads, positions, batch); q's boxes are (slab columns,
// pack, positions, 1), k's and v's (slab columns, 1, BK, 1).
template <int D, int BK, int NWG>
__global__ void __launch_bounds__(Tile<D, BK, NWG>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       int batch, int seq_q, int seq_k, int num_heads, int num_kv_heads,
                       int pack_log2, int q_tiles, long long o_sb, float scale_log2, int causal,
                       int window, int offset, float* __restrict__ lse) {
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

  // the KV tiles it sees: none when the window ends before the keys do (a
  // segment of cached keys whose queries all lie past the window)
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + positions, seq_q) - 1 + offset;
  int k_begin = 0;
  int k_end = seq_k;
  if (causal) {
    k_end = min(seq_k, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  const int kt_begin = k_begin / BK;
  const int n_tiles = k_begin < k_end ? (k_end + BK - 1) / BK - kt_begin : 0;

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
    if (threadIdx.x == 128 * NWG && n_tiles > 0) {
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

    if (n_tiles > 0) {
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
    }

    // epilogue: normalise by l and write bf16 in the packed order, and the
    // log-sum-exp (m and l are in the log2 domain) unpacked to (b, t, head)
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
        if (lse != nullptr && t == 0)
          lse[(static_cast<long long>(b) * seq_q + pos) * num_heads + head] =
              l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : -INFINITY;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 mma.sync, K and V through a cp.async ring
// ---------------------------------------------------------------------------
//
// flash_fwd_f32_kernel<D, BK>: one block of four warps per (64-row query
// tile, query head, batch), the query tiles that see the most keys first
// (blocks in the order of repro_torch.kernels.flash_attention.f32_block_coords).
// Each warp owns 16 query rows, FlashAttention-2's layout.  The block copies
// its Q tile once, then K and V tiles of BK keys through a two-stage
// cp.async ring, so that the next tile loads while this one is multiplied.
// S = Q K^T and O += P V are 3xTF32 mma.sync (mma.cuh): the scores stay in
// registers and become P V's A operand, split into big and small like any
// other operand.  The online softmax runs in fp32 registers in the log2
// domain; each thread keeps its columns' share of a row's sum, and the four
// threads of a row add theirs at the end.  KV tiles the rows cannot see are
// skipped whole, and only a tile that an edge crosses is masked
// (tile_needs_mask); the ragged edges of T and S arrive as zero rows.
//
// What bounds it: at qwen2_5_3b's training shape (B=4, T=S=512, 16 query
// heads of 128, causal) the two products are 4.3 GFLOP on 25 MB, so the
// arithmetic: 3xTF32 at 495 / 3 TFLOP/s.  The key tile per D (launch_f32's
// instantiations, mirrored by repro_torch.kernels.flash_attention.F32_KEYS,
// chosen with scripts/time_fp32_tiles.py) keeps two blocks on an SM up to
// D = 128 (101,376 bytes at D = 128); at D = 256 one block of 199,680 bytes
// with 32-key tiles, 218 registers and no spills.  The three TF32 products
// of a k-step run pass by pass over a row of accumulators (mma_n), so that
// no mma waits on the one before it.

constexpr int kF32Warps = 4;
constexpr int kF32Rows = 16 * kF32Warps;   // query rows a block
constexpr int kF32Stages = 2;              // K/V tiles in flight

// Dynamic shared memory of flash_fwd_f32_kernel<D, BK>: the Q tile and the
// K and V rings, fp32 rows padded by Mma<float>::kPad.  Mirrored by
// repro_torch.kernels.flash_attention.f32_smem_bytes.
constexpr int f32_smem_bytes(int D, int BK) {
  return (kF32Rows + 2 * kF32Stages * BK) * (D + Mma<float>::kPad) * 4;
}

template <int D, int BK>
__global__ void __launch_bounds__(32 * kF32Warps)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int batch, int seq_q,
                     int seq_k, int num_heads, int num_kv_heads, int q_tiles, long long q_sb,
                     long long k_sb, long long v_sb, long long o_sb, float scale_log2,
                     int causal, int window, int offset, float* __restrict__ lse) {
  using M = Mma<float>;
  constexpr int LD = D + M::kPad;
  constexpr int NT = 32 * kF32Warps;
  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;
  float* Ks = Qs + kF32Rows * LD;
  float* Vs = Ks + kF32Stages * BK * LD;

  // the block's tile: the heaviest query tiles (last in T) come first
  const int per_tile = num_heads * batch;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int h = rest % num_heads;
  const int b = rest / num_heads;
  const int hk = h / (num_heads / num_kv_heads);
  const int q0 = qt * kF32Rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row0 = 16 * warp + (lane >> 2);   // fragment rows row0 and row0 + 8

  const long long q_rs = static_cast<long long>(num_heads) * D;
  const long long kv_rs = static_cast<long long>(num_kv_heads) * D;
  const float* kb = k + b * k_sb + static_cast<long long>(hk) * D;
  const float* vb = v + b * v_sb + static_cast<long long>(hk) * D;
  async_rows<float, D, LD, NT>(Qs, q + b * q_sb + q0 * q_rs + static_cast<long long>(h) * D,
                               q_rs, kF32Rows, seq_q - q0, q);

  // KV tiles this query tile can see (kv_tile_range)
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + kF32Rows, seq_q) - 1 + offset;
  int k_begin = 0;
  int k_end = seq_k;
  if (causal) {
    k_end = min(seq_k, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  const int n_tiles = k_begin < k_end ? (k_end - (k_begin / BK) * BK + BK - 1) / BK : 0;
  k_begin = (k_begin / BK) * BK;

  auto load_kv = [&](int stage, int k0) {
    async_rows<float, D, LD, NT>(Ks + stage * BK * LD, kb + k0 * kv_rs, kv_rs, BK, seq_k - k0, k);
    async_rows<float, D, LD, NT>(Vs + stage * BK * LD, vb + k0 * kv_rs, kv_rs, BK, seq_k - k0, v);
  };
  if (n_tiles > 0) load_kv(0, k_begin);
  cp_async_commit();

  const int qpos[2] = {q0 + row0 + offset, q0 + row0 + 8 + offset};
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this thread's columns' share of each row's sum

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = k_begin + i * BK;
    const int st = i % kF32Stages;
    if (i + 1 < n_tiles) {
      load_kv(st ^ 1, k0 + BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + st * BK * LD;
    const float* Vt = Vs + st * BK * LD;

    // S = Q K^T for the warp's 16 rows
    float s[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      const M::A a = M::load_a(Qs + 16 * warp * LD + 8 * kk, LD, lane);
      M::B b[BK / 8];
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) b[nb] = M::load_b(Kt + 8 * nb * LD + 8 * kk, LD, lane);
      mma_n<float, BK / 8>(s, a, b);
    }

    // the online softmax, in place: s becomes P
    const bool mask = tile_needs_mask(k0, BK, seq_k, q_lo, q_hi, causal, window);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[nb][2 * r + e] * scale_log2;
          if (mask && !key_visible(k0 + 8 * nb + 2 * t + e, qpos[r], seq_k, causal, window))
            x = -INFINITY;
          s[nb][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet: every p is 0
      alpha[r] = fast_exp2(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(s[nb][2 * r + e] - m_use);
          s[nb][2 * r + e] = p;
          sum += p;
        }
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      acc[nb][0] *= alpha[0];
      acc[nb][1] *= alpha[0];
      acc[nb][2] *= alpha[1];
      acc[nb][3] *= alpha[1];
    }

    // O += P V, 8 keys a step, 4 column tiles at a time
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const M::A a = M::a_from_c(s[kk]);
#pragma unroll
      for (int nb = 0; nb < D / 8; nb += 4) {
        M::B b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = M::load_b_t(Vt + 8 * kk * LD + 8 * (nb + i), LD, lane);
        mma_n<float, 4>(acc + nb, a, b);
      }
    }
    __syncthreads();   // this stage is consumed before it is loaded again
  }
  cp_async_wait<0>();

  // epilogue: each row's sum from its four threads, O / l and the lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int pos = q0 + row0 + 8 * r;
    if (pos < seq_q) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;   // a fully masked row gives 0
      float* orow = o + b * o_sb + pos * q_rs + static_cast<long long>(h) * D + 2 * t;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        store2(orow + 8 * nb, acc[nb][2 * r] * inv, acc[nb][2 * r + 1] * inv);
      if (lse != nullptr && t == 0)
        lse[(static_cast<long long>(b) * seq_q + pos) * num_heads + h] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The fp32 kernel at head dim D with KV tiles of BK keys; block_keys is the
// wrapper's plan and must be BK.
template <int D, int BK>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Tq,
                       int Sk, int Hq, int Hkv, long long q_sb, long long k_sb, long long v_sb,
                       long long o_sb, float scale, int causal, int window, int offset,
                       float* lse, int block_keys, cudaStream_t stream) {
  if (block_keys != BK) return cudaErrorInvalidValue;
  const int q_tiles = (Tq + kF32Rows - 1) / kF32Rows;
  const long long blocks = static_cast<long long>(q_tiles) * Hq * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int bytes = f32_smem_bytes(D, BK);
  static_assert(bytes <= kSmemLimit, "more shared memory than a block may have");
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<D, BK><<<static_cast<unsigned>(blocks), 32 * kF32Warps, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), B, Tq, Sk, Hq, Hkv, q_tiles, q_sb, k_sb, v_sb, o_sb,
      scale * 1.4426950408889634f, causal, window, offset, lse);   // exp(x) = exp2(x log2 e)
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
                float scale, int causal, int window, int offset, float* lse, int pack_log2,
                cudaStream_t stream) {
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
      o_sb, scale * 1.4426950408889634f, causal, window, offset,  // exp(x) = exp2(x log2 e)
      lse);
  return cudaGetLastError();
}

// The three tile choices: 64 rows and 64 or 128 keys (one consumer
// warpgroup), 128 rows and 64 keys (two; with 128 keys they would spill).
// At D = 256, 64 x 128 needs more shared memory than a block may have and
// is not built.
template <int D>
int launch_bf16_tiles(int block_rows, int block_keys, const void* q, const void* k,
                      const void* v, void* o, int B, int Tq, int Sk, int Hq, int Hkv,
                      long long q_sb, long long k_sb, long long v_sb, long long o_sb, float scale,
                      int causal, int window, int offset, float* lse, int pack_log2,
                      cudaStream_t stream) {
  if (block_rows == 64 && block_keys == 64)
    return launch_bf16<D, 64, 1>(q, k, v, o, B, Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb, scale,
                                 causal, window, offset, lse, pack_log2, stream);
  if constexpr (wgmma_smem_bytes(D, 128, 1) <= kSmemLimit) {
    if (block_rows == 64 && block_keys == 128)
      return launch_bf16<D, 128, 1>(q, k, v, o, B, Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb,
                                    scale, causal, window, offset, lse, pack_log2, stream);
  }
  if (block_rows == 128 && block_keys == 64)
    return launch_bf16<D, 64, 2>(q, k, v, o, B, Tq, Sk, Hq, Hkv, q_sb, k_sb, v_sb, o_sb, scale,
                                 causal, window, offset, lse, pack_log2, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// fp32 inputs.  Strides are in elements; window <= 0 means no window; query
// t sits at key position q_offset + t; lse is null or (B, T, Hq) fp32;
// block_keys is the wrapper's plan (F32_KEYS), the only tile built for D.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       int B, int T, int S, int Hq, int Hkv, int D,
                                       long long q_sb, long long k_sb, long long v_sb,
                                       long long o_sb, float scale, int causal, int window,
                                       int q_offset, void* lse, int block_keys, void* stream) {
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return repro_torch::launch_f32<32, 64>(q, k, v, o, B, T, S, Hq, Hkv, q_sb, k_sb, v_sb,
                                             o_sb, scale, causal, window, q_offset, lse_f,
                                             block_keys, st);
    case 64:
      return repro_torch::launch_f32<64, 64>(q, k, v, o, B, T, S, Hq, Hkv, q_sb, k_sb, v_sb,
                                             o_sb, scale, causal, window, q_offset, lse_f,
                                             block_keys, st);
    case 128:
      return repro_torch::launch_f32<128, 32>(q, k, v, o, B, T, S, Hq, Hkv, q_sb, k_sb, v_sb,
                                              o_sb, scale, causal, window, q_offset, lse_f,
                                              block_keys, st);
    case 256:
      return repro_torch::launch_f32<256, 32>(q, k, v, o, B, T, S, Hq, Hkv, q_sb, k_sb, v_sb,
                                              o_sb, scale, causal, window, q_offset, lse_f,
                                              block_keys, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 inputs, with the wrapper's plan: block_rows query rows a block and
// block_keys keys a KV tile (64 x 64, 64 x 128 or 128 x 64; not 64 x 128 at
// D = 256), 2^pack_log2 query heads packed into a tile; q_offset and lse as
// for fp32.  Every batch stride (elements) must be a multiple of 8 and every
// base 16-byte aligned, as TMA requires.  Returns a cudaError_t,
// 1000 + the CUresult of a tensor map the driver refused, or 3000 when the
// driver lacks cuTensorMapEncodeTiled.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        int B, int T, int S, int Hq, int Hkv, int D,
                                        long long q_sb, long long k_sb, long long v_sb,
                                        long long o_sb, float scale, int causal, int window,
                                        int q_offset, void* lse, int block_rows, int block_keys,
                                        int pack_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (D) {
    case 32:
      return repro_torch::launch_bf16_tiles<32>(block_rows, block_keys, q, k, v, o, B, T, S, Hq,
                                               Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal, window,
                                               q_offset, lse_f, pack_log2, st);
    case 64:
      return repro_torch::launch_bf16_tiles<64>(block_rows, block_keys, q, k, v, o, B, T, S, Hq,
                                               Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal, window,
                                               q_offset, lse_f, pack_log2, st);
    case 128:
      return repro_torch::launch_bf16_tiles<128>(block_rows, block_keys, q, k, v, o, B, T, S, Hq,
                                                Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal, window,
                                                q_offset, lse_f, pack_log2, st);
    case 256:
      return repro_torch::launch_bf16_tiles<256>(block_rows, block_keys, q, k, v, o, B, T, S, Hq,
                                                Hkv, q_sb, k_sb, v_sb, o_sb, scale, causal, window,
                                                q_offset, lse_f, pack_log2, st);
    default:
      return cudaErrorInvalidValue;
  }
}
