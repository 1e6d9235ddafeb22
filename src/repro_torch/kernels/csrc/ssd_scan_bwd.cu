// Gradient of the Mamba2 chunked SSD scan (K3-bwd), sm_90a.
//
// K3 (ssd_scan.cu) replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel), which has no gradient: the JAX package trains through its
// jnp chunked scan (repro/models/layers.py::ssd_chunked_ref), which XLA
// differentiates.  The port trains through K3, so K3 gets this gradient.
// Per chunk c, with cum the inclusive cumsum of dA inside it, S_c the state
// entering it, G_c the gradient of the state leaving it, L[i,j] =
// exp(cum_i − cum_j) for i ≥ j, ecum = exp(cum) and w_j = exp(cum_last − cum_j):
//   G_{c-1} = exp(cum_last)·G_c + Cᵀ·(ecum ∘ dy)              (reverse scan)
//   M_h     = L ∘ (dy·xdtᵀ)
//   dxdt    = (C·Bᵀ ∘ L)ᵀ·dy + w ∘ (B·G_c)
//   dC      = Σ_h [M_h·B + (ecum ∘ dy)·S_cᵀ] = (Σ_h M_h)·B + Σ_h (ecum_h ∘ dy_h)·S_hᵀ
//   dB      = Σ_h [M_hᵀ·C + (w ∘ xdt)·G_cᵀ]  = (Σ_h M_h)ᵀ·C + Σ_h (w_h ∘ xdt_h)·G_hᵀ
//   dcum_i  = Σ_{j<i} (C·Bᵀ ∘ M)_ij − Σ_{k>i} (C·Bᵀ ∘ M)_ki (the diagonal cancels)
//             + ecum_i ⟨C_i, (dy·S_cᵀ)_i⟩ − ⟨xdt_i, w_i (B·G_c)_i⟩ (+ ⟨G_c, S_{c+1}⟩ last)
//   ddA     = the reverse cumsum of dcum inside the chunk
// (C and B do not depend on the head, so the heads' sum of dB and dC is
// taken inside the products).  G_{-1} is the initial state's gradient.  The
// plain version of these kernels is repro_torch.kernels.ref.ssd_scan_bwd_tiled.
//
// Layout: xdt (B, T, H, P), dA (B, T, H), Bm and Cm (B, T, N) as K3's
// forward reads them (fp32 or bf16, own strides, last axis dense); dy
// (B, T, H, P) fp32 dense; the states from K3's forward, fp32 dense: carry
// (B, chunks, H, N, P), where chunk c < chunks − 1 published its end state,
// the initial state (B, H, N, P) or null, the final state (B, H, N, P); the
// final state's gradient (B, H, N, P) or null.  Outputs fp32 dense: dxdt
// (B, T, H, P), ddA (B, T, H), dB and dC (B, T, N), the initial state's
// gradient (B, H, N, P) when there is an initial state.
//
// Bound: operations (at mamba2_370m's training shape 30.7 GFLOP against
// 292 MB).  Every product runs on the tensor cores as 3xTF32 mma.sync
// m16n8k8 (mma.cuh's Mma<float> fragments and passes): each fp32 operand is
// split into big = tf32(a), rounded to nearest, and small = a − big, and
// three products are taken, the small ones first, so that the gradients
// keep fp32's accuracy at a third of the TF32 rate.  On an H100 mma.sync
// reaches about 300 of TF32's 495 TFLOP/s, and building the fragments (the
// shared-memory loads and the split) costs about as much as the mma.
// Operands are staged into shared memory by cp.async once per block or
// phase (bf16 inputs are widened to fp32 on the way), rows padded so that
// ldmatrix and the scalar fragment loads hit distinct banks; N is padded to
// a multiple of 8 with zeros there.  The intra-chunk products walk only the
// 16-row strips of the causal triangle.  Two rules keep the mma pipe fed:
// no mma sits under a condition that differs between warps (ptxas would
// reconverge the warp around each one), so products past a strip's range
// multiply zeros or clamped tiles and only the stores are guarded; and the
// two kernels with most of the work run 16 warps a block (4 pairs of strips
// x 4 quarters of the columns, at most 128 registers a thread), so that a
// scheduler has four warps to switch between.
//
// Design: four launches, a fifth when the heads are cut into groups; no
// atomics, so a run gives the same bits every time.
// 1. ssd_bwd_chunk, grid (Q/64 + H·P/PT, chunks, B), 8 warps: C·Bᵀ over the
//    lower triangle once per chunk (64 rows a block) into scratch CB (B,
//    chunks, Q, Q), stored transposed (row j, column i: C_i·B_j for i ≥ j);
//    per (head, PT state columns) the chunk's own ΔG = Cᵀ·(ecum ∘ dy) into
//    scratch G (B, chunks, H, N, P), and from the first column tile the fp64
//    cumsum of dA with ecum and w into scratch cumx (B, chunks, H, 4Q) and
//    exp(cum_last) into decay (B, chunks, H).
// 2. ssd_bwd_state, grid (N·P/1024, H, B): the reverse scan over the chunks,
//    in place in G: a thread holds 4 values of the running gradient, and at
//    each chunk, from the last to the first, writes G_c over ΔG_c (read a
//    step ahead) and steps to G_{c-1}; what is left is the initial state's
//    gradient.
// 3. ssd_bwd_grads, grid (H, chunks, B), 16 warps, per (chunk, head): raw =
//    dy·xdtᵀ over the triangle, whose epilogue forms (C·Bᵀ ∘ L)ᵀ in place of
//    CB's transpose in shared memory and dcum's intra-chunk terms; then per
//    tile of PT state columns dxdt = (C·Bᵀ ∘ L)ᵀ·dy (each strip from its own
//    depth on) + w ∘ (B·G_c) with dcum's B term, and dy·S_cᵀ for dcum's C
//    term.  Four regions of shared memory take the operands in turn ((C·Bᵀ
//    ∘ L)ᵀ, then xdt beside S; dy; xdt, then B, then C; G), each staged
//    while a product runs.  dcum's terms are fp32 products summed in fp64,
//    partial sums kept per warp in fixed slots and added in a fixed order;
//    ddA is their reverse cumsum, a fixed tree over one warp.
// 4. ssd_bwd_bc, grid (halves of N · groups of heads, chunks, B), 16 warps:
//    per head of the group and slice of P (a ring of two stages filled by
//    cp.async while the other is multiplied) raw = dy·xdtᵀ over the
//    triangle, added as L ∘ raw into Msum in shared memory, and the state
//    parts (ecum ∘ dy)·Sᵀ and (w ∘ xdt)·Gᵀ of this half's columns, summed
//    over the heads in the accumulators; then Msum·B and Msumᵀ·C.  With one
//    group (the chunks fill the card) dB and dC are written directly; else
//    per-group partials (B, chunks, groups, Q, N), which
// 5. ssd_bwd_group_sum adds in the order g = 0 .. groups − 1.
// A ragged last chunk reads zeros past T, as the forward does: dA = 0 and
// xdt = B = C = dy = 0 there, so those positions add nothing anywhere.
#include "mma.cuh"
#include "ssd_tile.cuh"

#include <math.h>

namespace repro_torch {
namespace {

using MF = Mma<float>;

constexpr int kWarps = kThreads / 32;   // ssd_bwd_chunk's 8 warps
constexpr int kWide = 512;              // threads of ssd_bwd_grads and ssd_bwd_bc
constexpr int kWideWarps = kWide / 32;  // 16: 4 pairs of strips x 4 quarters of columns
constexpr int kHalf = 64;               // widest column half of N in ssd_bwd_bc
constexpr int kParts = 16;              // fp64 rows of dcum's partial sums in ssd_bwd_grads
constexpr int kStateVals = 4;           // values a thread of the state scan
constexpr int kSmemLimit = 232448;      // shared memory a block may use
constexpr int kMaxDevices = 16;         // devices whose attributes are cached

// L = exp(cum_i − cum_j) for i ≥ j: the difference taken in fp64 and rounded
// to fp32 only then (an fp32 cumsum that reaches −90 over a chunk carries
// errors of ~1e-5, which exp would turn into relative errors)
__device__ __forceinline__ float decay_ij(double cum_i, double cum_j) {
  return expf(static_cast<float>(cum_i - cum_j));
}

__host__ __device__ __forceinline__ int round8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ __forceinline__ int p_tile(int P) {
  return P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : 16;
}
__host__ __device__ __forceinline__ int p_slice(int P) { return P % 32 == 0 ? 32 : 16; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Dynamic shared memory of each launch (bytes), mirrored by
// repro_torch.kernels.ssd_scan_bwd.smem_bytes.
__host__ __device__ __forceinline__ int chunk_smem(int Q, int N8, int PT) {
  return 12 * Q + 4 * imax((imin(Q, 64) + Q) * (N8 + 4), Q * (N8 + 8) + Q * (PT + 8));
}
// ssd_bwd_grads' first region: C·Bᵀ (∘ L), then a tile of xdt beside one of S
__host__ __device__ __forceinline__ int region0(int Q, int N8, int PT) {
  return imax(Q * (Q + 4), (Q + N8) * (PT + 4));
}
__host__ __device__ __forceinline__ int grads_smem(int Q, int N8, int PT) {
  return 16 * Q + 8 * (kParts * Q + kWideWarps) +
         4 * (region0(Q, N8, PT) + Q * (PT + 4) + Q * (imax(PT, N8) + 4) + N8 * (PT + 8));
}
__host__ __device__ __forceinline__ int ring_stage(int Q, int PS, int HW) {
  return 2 * Q * (PS + 4) + 2 * HW * (PS + 4) + 4 * Q;
}
__host__ __device__ __forceinline__ int bc_smem(int Q, int PS, int HW) {
  return 4 * (Q * (Q + 4) + imax(2 * ring_stage(Q, PS, HW), 2 * Q * (HW + 8)));
}

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

// a, or zeros where `in` is false (a select, not a branch)
__device__ __forceinline__ MF::A keep(const MF::A& a, bool in) {
  MF::A z;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    z.big[i] = in ? a.big[i] : 0u;
    z.small[i] = in ? a.small[i] : 0u;
  }
  return z;
}

// acc[s][j] += A(s, k)·B(k, j) for the warp's two strips s and two column
// tiles j, k in [0, depth) by 8; A(s, k) is zero where strip s takes no
// part.  The strips share each B fragment, and the three passes run over
// every accumulator in turn, so that an mma does not wait on the one before
// it.  No mma sits under a condition that varies between warps: ptxas would
// reconverge the warp around each one (WARPSYNC), which costs more than the
// products it skips.
template <class LA, class LB>
__device__ __forceinline__ void pair_mma_range(float (&acc)[2][2][4], int k_begin, int depth, LA la,
                                               LB lb) {
#pragma unroll 2
  for (int k = k_begin; k < depth; k += 8) {
    const MF::A x0 = la(0, k);
    const MF::A x1 = la(1, k);
    MF::B bb[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) bb[j] = lb(k, j);
#pragma unroll
    for (int p = 0; p < MF::kPasses; ++p) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        MF::mma_pass(p, acc[0][j], x0, bb[j]);
        MF::mma_pass(p, acc[1][j], x1, bb[j]);
      }
    }
  }
}

template <class LA, class LB>
__device__ __forceinline__ void pair_mma(float (&acc)[2][2][4], int depth, LA la, LB lb) {
  pair_mma_range(acc, 0, depth, la, lb);
}

// As pair_mma for a product triangular in its depth: strip 0 takes k in
// [k0, depth), strip 1 in [k1, depth), k0 ≤ k1; below k1 only strip 0 runs.
// The loops' bounds differ between warps but no mma is under a condition.
template <class LA, class LB>
__device__ __forceinline__ void pair_mma_from(float (&acc)[2][2][4], int k0, int k1, int depth,
                                              LA la, LB lb) {
  for (int k = k0; k < k1; k += 8) {
    const MF::A x0 = la(0, k);
    MF::B bb[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) bb[j] = lb(k, j);
#pragma unroll
    for (int p = 0; p < MF::kPasses; ++p) {
#pragma unroll
      for (int j = 0; j < 2; ++j) MF::mma_pass(p, acc[0][j], x0, bb[j]);
    }
  }
  pair_mma_range(acc, k1, depth, la, lb);
}

// The 16 warps of ssd_bwd_grads and ssd_bwd_bc: warp (pair, q) owns strips
// lo = pair and hi = S − 1 − pair of the chunk's S (lo alone for the middle
// strip of an odd S; none for pair ≥ ceil(S/2)), so that the four pairs
// share the causal triangle evenly.  Of the triangle (a Q x Q product in
// 16 x 8 tiles) it owns each strip's column tiles nt ≡ q (mod 4) left of the
// strip's end (tiles(r) of strip r: at most 2 of lo, 4 of hi, 4 or 5 in all
// at S = 8); of a product with output columns, the column tiles 2q and
// 2q + 1 of each 64.  Mirrored by repro_torch.kernels.ssd_scan_bwd.tri_tiles.
// A warp without a strip, or without a second one, still multiplies
// (strips clamped into the chunk) but writes nothing of it.
struct Roles {
  int lo, hi, q;
  bool active, two;
  // column tiles of strip r this warp owns
  __device__ __forceinline__ int tiles(int r) const { return imax(0, (2 * r + 5 - q) / 4); }
};

__device__ __forceinline__ Roles roles(int warp, int S) {
  Roles r;
  const int lo = warp >> 2;
  const int hi = S - 1 - lo;
  r.active = lo <= hi;
  r.two = lo < hi;
  r.lo = imin(lo, S - 1);
  r.hi = r.two ? hi : r.lo;
  r.q = warp & 3;
  return r;
}

// rlo[s] += Y(strip lo)·X(tile q + 4s)ᵀ, rhi[s] likewise for strip hi,
// over depth [0, depth): Y rows i and X rows j both stored [row][k].  Both
// strips take the same column tiles, so each B fragment is loaded once for
// the two; every slot is multiplied (tiles past the chunk clamped to its
// last, nt_max), and only the triangle's (s < tiles(strip)) are read after.
__device__ __forceinline__ void tri_product(float (&rlo)[2][4], float (&rhi)[4][4], const float* Y,
                                            int ldy, const float* X, int ldx, int depth,
                                            int nt_max, const Roles& ro, int lane) {
#pragma unroll 2
  for (int k = 0; k < depth; k += 8) {
    const MF::A a0 = ld_a(Y, ldy, 16 * ro.lo, k, lane);
    const MF::A a1 = ld_a(Y, ldy, 16 * ro.hi, k, lane);
    MF::B bb[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) bb[s] = ld_b_t(X, ldx, 8 * imin(ro.q + 4 * s, nt_max), k, lane);
#pragma unroll
    for (int p = 0; p < MF::kPasses; ++p) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s < 2) MF::mma_pass(p, rlo[s], a0, bb[s]);
        MF::mma_pass(p, rhi[s], a1, bb[s]);
      }
    }
  }
}

// Calls f(s, acc[s]) for the first n (at most NS) tiles of a strip.
template <int NS, class F>
__device__ __forceinline__ void each_tile(const float (&acc)[NS][4], int n, F f) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s < n) f(s, acc[s]);
  }
}

// Calls f(i, j, v) for the four values of accumulator tile (strip, nt).
template <class F>
__device__ __forceinline__ void tile_values(const float (&acc)[4], int strip, int nt, int g,
                                            int t, F f) {
  const int i = 16 * strip + g;
  const int j = 8 * nt + 2 * t;
  f(i, j, acc[0]);
  f(i, j + 1, acc[1]);
  f(i + 8, j, acc[2]);
  f(i + 8, j + 1, acc[3]);
}

__device__ __forceinline__ double quad_sum(double v) {    // over the lanes of a row (t)
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ double column_sum(double v) {  // over the 8 row groups (g)
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// ---------------------------------------------------------------------------
// 1. per chunk: C·Bᵀ over the triangle (a block per 64 rows); per (head, PT
//    state columns) ΔG, and the cumsum with its exponentials
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk(const T* __restrict__ dA, const T* __restrict__ Bm, const T* __restrict__ Cm,
              const float* __restrict__ dy, float* __restrict__ CB, float* __restrict__ G,
              float* __restrict__ cumx, float* __restrict__ decay, int T_len, int H, int P,
              int N, int Q, Strides st) {
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.y;
  const int t0 = c * Q;
  const int valid = min(Q, T_len - t0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int N8 = round8(N);
  const int PT = p_tile(P);
  const int n_cb = (Q + 63) / 64;
  const long long bc = static_cast<long long>(b) * n_chunks + c;

  extern __shared__ float4 smem4[];
  double* cum = reinterpret_cast<double*>(smem4);         // (Q,)
  float* ecum = reinterpret_cast<float*>(cum + Q);        // (Q,)
  float* tiles = ecum + Q;

  const T* B_c = Bm + b * st.bs_b + t0 * st.bs_t;
  const T* C_c = Cm + b * st.cs_b + t0 * st.cs_t;

  if (static_cast<int>(blockIdx.x) < n_cb) {
    // C·Bᵀ, rows [r0, r1) and the columns left of each strip's end: C's
    // rows and B's rows [0, r1) staged [row][n]
    const int r0 = blockIdx.x * 64;
    const int r1 = min(Q, r0 + 64);
    const int ld = N8 + 4;
    float* Cs = tiles;
    float* Bs = tiles + (r1 - r0) * ld;
    stage_tile(Cs, ld, C_c + r0 * st.cs_t, st.cs_t, r1 - r0, valid - r0, N8, N, Cm);
    stage_tile(Bs, ld, B_c, st.bs_t, r1, valid, N8, N, Bm);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int s0 = r0 / 16;
    const int s1 = r1 / 16;
    const int total = s1 * (s1 + 1) - s0 * (s0 + 1);   // strip r has 2(r + 1) tiles
    float* cb = CB + bc * Q * Q;
    for (int it = 0; it < (total + kWarps - 1) / kWarps; ++it) {
      const int idx = imin(warp + kWarps * it, total - 1);
      int r = s0;
      int nt = idx;
      while (nt >= 2 * (r + 1)) {
        nt -= 2 * (r + 1);
        ++r;
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < N8; k += 8) {
        const MF::A a = ld_a(Cs, ld, 16 * r - r0, k, lane);
        const MF::B bb = ld_b_t(Bs, ld, 8 * nt, k, lane);
#pragma unroll
        for (int p = 0; p < MF::kPasses; ++p) MF::mma_pass(p, acc, a, bb);
      }
      if (warp + kWarps * it >= total) continue;
      // transposed: row j = 8 nt + 2t (+1), column i = 16 r + g (+8)
      float* out = cb + (8 * nt + 2 * t) * Q + 16 * r + g;
      out[0] = acc[0];
      out[Q] = acc[1];
      out[8] = acc[2];
      out[Q + 8] = acc[3];
    }
    return;
  }

  // ΔG of head h, state columns p0 .. p0 + PT: Cᵀ (rows n) over depth i
  const int hb = blockIdx.x - n_cb;
  const int h = hb / (P / PT);
  const int p0 = (hb % (P / PT)) * PT;
  const int ldc = N8 + 8;
  const int ldy = PT + 8;
  float* Cs = tiles;               // [i][n]
  float* Ys = tiles + Q * ldc;     // [i][p]
  stage_tile(Cs, ldc, C_c, st.cs_t, Q, valid, N8, N, Cm);
  const float* dy_c = dy + (static_cast<long long>(b) * T_len + t0) * H * P + h * P + p0;
  stage_tile(Ys, ldy, dy_c, static_cast<long long>(H) * P, Q, valid, PT, PT, dy);
  cp_async_commit();
  if (warp == 0) chunk_cumsum(cum, dA + b * st.as_b + h * st.as_h, st.as_t, t0, valid, Q, lane);
  __syncthreads();
  const double cl = cum[Q - 1];
  float* cx = cumx + (bc * H + h) * 4 * Q;
  for (int i = tid; i < Q; i += kThreads) {
    const float e = i < valid ? expf(static_cast<float>(cum[i])) : 0.f;
    ecum[i] = e;
    if (p0 == 0) {
      reinterpret_cast<double*>(cx)[i] = cum[i];
      cx[2 * Q + i] = e;
      cx[3 * Q + i] = i < valid ? expf(static_cast<float>(cl - cum[i])) : 0.f;
    }
  }
  if (p0 == 0 && tid == 0) decay[bc * H + h] = expf(static_cast<float>(cl));
  cp_async_wait<0>();
  __syncthreads();
  // every warp multiplies (rows and columns clamped into the tiles); only
  // those with rows of N write
  const int ntc = PT / 8;
  const int m0 = imin(16 * warp, N8 - 8);
  float acc[8][4] = {};
  for (int k = 0; k < Q; k += 8) {
    const MF::A a = ld_a_t(Cs, ldc, m0, k, g, t);
    const float e0 = ecum[k + t];
    const float e1 = ecum[k + t + 4];
    MF::B bb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bb[j] = ld_b(Ys, ldy, k, 8 * imin(j, ntc - 1), g, t, e0, e1);
#pragma unroll
    for (int p = 0; p < MF::kPasses; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) MF::mma_pass(p, acc[j], a, bb[j]);
    }
  }
  if (16 * warp >= N8) return;
  float* out = G + (bc * H + h) * static_cast<long long>(N) * P + p0;
  const int n = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= ntc) continue;
    if (n < N) store2(out + n * P + 8 * j + 2 * t, acc[j][0], acc[j][1]);
    if (n + 8 < N) store2(out + (n + 8) * P + 8 * j + 2 * t, acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// 2. the reverse scan over chunks, in place: ΔG_c in, G_c out
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state(float* __restrict__ G, const float* __restrict__ decay,
              const float* __restrict__ d_final, float* __restrict__ d_init, int H, int NP,
              int n_chunks) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const int base = blockIdx.x * kStateVals * kThreads + threadIdx.x;
  float g[kStateVals];
#pragma unroll
  for (int e = 0; e < kStateVals; ++e) {
    const int idx = base + e * kThreads;
    g[e] = (d_final != nullptr && idx < NP) ? d_final[bh * NP + idx] : 0.f;
  }
  // ΔG of the chunk before is read before G_c is written over ΔG_c, so the
  // reads of one step overlap the arithmetic of the step before
  auto load = [&](int c, float (&d)[kStateVals]) {
    const float* gc = G + ((static_cast<long long>(b) * n_chunks + c) * H + h) * NP;
#pragma unroll
    for (int e = 0; e < kStateVals; ++e) {
      const int idx = base + e * kThreads;
      d[e] = idx < NP ? gc[idx] : 0.f;
    }
  };
  float d[kStateVals];
  load(n_chunks - 1, d);
  for (int c = n_chunks - 1; c >= 0; --c) {
    const long long bch = (static_cast<long long>(b) * n_chunks + c) * H + h;
    float d_next[kStateVals] = {};
    if (c > 0) load(c - 1, d_next);
    const float a = decay[bch];
    float* gc = G + bch * NP;
#pragma unroll
    for (int e = 0; e < kStateVals; ++e) {
      const int idx = base + e * kThreads;
      if (idx < NP) gc[idx] = g[e];
      g[e] = fmaf(a, g[e], d[e]);
      d[e] = d_next[e];
    }
  }
  if (d_init != nullptr) {
#pragma unroll
    for (int e = 0; e < kStateVals; ++e) {
      const int idx = base + e * kThreads;
      if (idx < NP) d_init[bh * NP + idx] = g[e];
    }
  }
}

// ---------------------------------------------------------------------------
// 3. per (chunk, head): dxdt and ddA
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kWide, 1)
ssd_bwd_grads(const T* __restrict__ xdt, const T* __restrict__ Bm, const T* __restrict__ Cm,
              const float* __restrict__ dy, const float* __restrict__ CB,
              const float* __restrict__ G, const float* __restrict__ cumx,
              const float* __restrict__ carry, const float* __restrict__ init_state,
              const float* __restrict__ final_state, float* __restrict__ dx,
              float* __restrict__ ddA, int T_len, int H, int P, int N, int Q, Strides st) {
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.y;
  const int t0 = c * Q;
  const int valid = min(Q, T_len - t0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int N8 = round8(N);
  const int PT = p_tile(P);
  const int n_pt = P / PT;
  const int S = Q / 16;
  const long long bc = static_cast<long long>(b) * n_chunks + c;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long NP = static_cast<long long>(N) * P;
  const Roles ro = roles(warp, S);

  extern __shared__ float4 smem4[];
  double* cum = reinterpret_cast<double*>(smem4);             // (Q,), then ecum and w
  float* ecum = reinterpret_cast<float*>(cum + Q);            // (Q,) exp(cum), 0 past valid
  float* w = ecum + Q;                                        // (Q,) exp(cum_last − cum)
  double* parts = reinterpret_cast<double*>(w + Q);           // (kParts, Q)
  double* red = parts + kParts * Q;                           // (kWideWarps,)
  const int ld0 = Q + 4;
  const int ld1 = PT + 4;
  const int ldb = N8 + 4;
  const int ld3 = PT + 8;
  const int lds = PT + 4;
  float* R0 = reinterpret_cast<float*>(red + kWideWarps);    // (C·Bᵀ (∘ L))ᵀ, then xdt and S
  float* R1 = R0 + region0(Q, N8, PT);                        // dy
  float* R2 = R1 + Q * ld1;                                   // xdt, then B, then C
  float* R3 = R2 + Q * (imax(PT, N8) + 4);                    // G
  float* Ss = R0 + Q * ld1;                                   // S beside xdt in R0

  // the states around this chunk, from K3's forward, and G_c
  const float* S_in = c == 0 ? (init_state != nullptr ? init_state + bh * NP : nullptr)
                             : carry + ((bc - 1) * H + h) * NP;
  const float* S_out = c == n_chunks - 1 ? final_state + bh * NP : carry + (bc * H + h) * NP;
  const float* Gc = G + (bc * H + h) * NP;
  const T* x_c = xdt + b * st.xs_b + t0 * st.xs_t + h * st.xs_h;
  const T* C_c = Cm + b * st.cs_b + t0 * st.cs_t;
  const float* dy_c = dy + (static_cast<long long>(b) * T_len + t0) * H * P + h * P;
  const long long dys = static_cast<long long>(H) * P;

  for (int i = tid; i < kParts * Q; i += kWide) parts[i] = 0.0;
  // C·Bᵀ's transpose: row i from the strip of i on (what the triangle reads)
  auto stage_cb = [&]() {
    const float* cb = CB + bc * Q * Q;
    const int per = Q / 4;
    for (int idx = tid; idx < Q * per; idx += kWide) {
      const int i = idx / per;
      const int j = (idx % per) * 4;
      if (j >= 16 * (i / 16)) cp_async16(R0 + i * ld0 + j, cb + i * Q + j, true);
    }
  };
  // three groups: what raw's product reads; the cumsum and C·Bᵀ, which its
  // epilogue reads; G
  stage_tile(R1, ld1, dy_c, dys, Q, valid, PT, PT, dy);
  stage_tile(R2, ld1, x_c, st.xs_t, Q, valid, PT, PT, xdt);
  cp_async_commit();
  stage_tile(reinterpret_cast<float*>(cum), 4 * Q, cumx + (bc * H + h) * 4 * Q, 0, 1, 1, 4 * Q,
             4 * Q, cumx);
  stage_cb();
  cp_async_commit();
  stage_tile(R3, ld3, Gc, P, N8, N, PT, PT, G);
  cp_async_commit();

  // raw = dy·xdtᵀ over the triangle, summed over the tiles of P
  float rlo[2][4] = {};
  float rhi[4][4] = {};
  for (int pt = 0; pt < n_pt; ++pt) {
    if (pt > 0) {
      __syncthreads();
      stage_tile(R1, ld1, dy_c + pt * PT, dys, Q, valid, PT, PT, dy);
      stage_tile(R2, ld1, x_c + pt * PT, st.xs_t, Q, valid, PT, PT, xdt);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<2>();
    }
    __syncthreads();
    tri_product(rlo, rhi, R1, ld1, R2, ld1, PT, 2 * S - 1, ro, lane);
  }
  cp_async_wait<1>();
  __syncthreads();  // xdt is consumed; the cumsum and C·Bᵀ are in place
  stage_tile(R2, ldb, Bm + b * st.bs_b + t0 * st.bs_t, st.bs_t, Q, valid, N8, N, Bm);
  cp_async_commit();

  // the epilogue: (C·Bᵀ ∘ L)ᵀ in place of C·Bᵀ's transpose (each position
  // one thread's), and the row sums left of the diagonal and column sums
  // below it of (C·Bᵀ ∘ L) ∘ raw, in fp64: a row's by the four warps of its
  // pair (slots 0-3 by quarter), a column's by one warp of each pair (slots
  // 4 + pair)
  if (ro.active) {
    auto epilogue = [&](const auto& acc, int strip) {
      double rs0 = 0.0;
      double rs1 = 0.0;
      each_tile(acc, ro.tiles(strip), [&](int s, const float (&a)[4]) {
        const int nt = ro.q + 4 * s;
        double cs0 = 0.0;
        double cs1 = 0.0;
        tile_values(a, strip, nt, g, t, [&](int i, int j, float raw) {
          const bool in = j <= i && i < valid;
          const float l = in ? decay_ij(cum[i], cum[j]) : 0.f;
          const float cbl = in ? R0[j * ld0 + i] * l : 0.f;
          R0[j * ld0 + i] = cbl;
          const double v = j < i ? static_cast<double>(cbl * raw) : 0.0;
          if ((i & 8) == 0) {
            rs0 += v;
          } else {
            rs1 += v;
          }
          if ((j & 1) == 0) {
            cs0 += v;
          } else {
            cs1 += v;
          }
        });
        cs0 = column_sum(cs0);
        cs1 = column_sum(cs1);
        if (g == 0) {
          parts[(4 + ro.lo) * Q + 8 * nt + 2 * t] += cs0;
          parts[(4 + ro.lo) * Q + 8 * nt + 2 * t + 1] += cs1;
        }
      });
      rs0 = quad_sum(rs0);
      rs1 = quad_sum(rs1);
      if (t == 0) {
        parts[ro.q * Q + 16 * strip + g] = rs0;
        parts[ro.q * Q + 16 * strip + g + 8] = rs1;
      }
    };
    epilogue(rlo, ro.lo);
    if (ro.two) epilogue(rhi, ro.hi);
  }

  // per tile of P: dxdt = (C·Bᵀ ∘ L)ᵀ·dy + w ∘ (B·G_c), dcum's B term from
  // its state part, and dcum's C term from dy·S_cᵀ.  A warp owns the rows of
  // its strips and the column tiles 2q, 2q + 1 of the tile (none past PT).
  double bt[2][2] = {};         // B term, C term: [strip lo, hi][row g, g + 8]
  double ct[2][2] = {};
  for (int pt = 0; pt < n_pt; ++pt) {
    const int p0 = pt * PT;
    if (pt > 0) {
      stage_cb();
      stage_tile(R2, ldb, Bm + b * st.bs_b + t0 * st.bs_t, st.bs_t, Q, valid, N8, N, Bm);
      stage_tile(R3, ld3, Gc + p0, P, N8, N, PT, PT, G);
    }
    if (n_pt > 1) stage_tile(R1, ld1, dy_c + p0, dys, Q, valid, PT, PT, dy);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // B, G, dy and C·Bᵀ are in place
    if (pt > 0) {
      // (C·Bᵀ ∘ L)ᵀ again (the first tile's came with raw's epilogue): row j,
      // column i
      for (int idx = tid; idx < Q * Q; idx += kWide) {
        const int j = idx / Q;
        const int i = idx % Q;
        if (i < 16 * (j / 16)) continue;
        const bool in = j <= i && i < valid;
        R0[j * ld0 + i] = in ? R0[j * ld0 + i] * decay_ij(cum[i], cum[j]) : 0.f;
      }
      __syncthreads();
    }

    // a warp's columns, clamped into the tile for the tiles past it
    auto col = [&](int j) { return imin(8 * (2 * ro.q + j), PT - 8); };
    float adx[2][2][4] = {};
    pair_mma_from(adx, 16 * ro.lo, 16 * ro.hi, Q,
                  [&](int s, int k) { return ld_a(R0, ld0, 16 * (s ? ro.hi : ro.lo), k, lane); },
                  [&](int k, int j) { return ld_b(R1, ld1, k, col(j), g, t); });
    __syncthreads();  // C·Bᵀ ∘ L is consumed: xdt and S take its place
    stage_tile(R0, ld1, x_c + p0, st.xs_t, Q, valid, PT, PT, xdt);
    if (S_in != nullptr) {
      stage_tile(Ss, lds, S_in + p0, P, N8, N, PT, PT, carry);
    } else {
      zero_tile(Ss, lds, N8, PT);
    }
    cp_async_commit();
    float abg[2][2][4] = {};
    pair_mma(abg, N8,
             [&](int s, int k) { return ld_a(R2, ldb, 16 * (s ? ro.hi : ro.lo), k, lane); },
             [&](int k, int j) { return ld_b(R3, ld3, k, col(j), g, t); });
    __syncthreads();  // B and G are consumed: C takes B's place
    stage_tile(R2, ldb, C_c, st.cs_t, Q, valid, N8, N, Cm);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // xdt and S are in place
    if (ro.active) {
      // dxdt, and the B term ⟨xdt_i, w_i (B·G_c)_i⟩
#pragma unroll
      for (int si = 0; si < 2; ++si) {
        if (si == 1 && !ro.two) break;
        const int r = si ? ro.hi : ro.lo;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (8 * (2 * ro.q + j) >= PT) continue;
          const int col = 8 * (2 * ro.q + j) + 2 * t;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 16 * r + g + 8 * e;
            if (i >= valid) continue;
            const float v0 = w[i] * abg[si][j][2 * e];
            const float v1 = w[i] * abg[si][j][2 * e + 1];
            float* out = dx + ((static_cast<long long>(b) * T_len + t0 + i) * H + h) * P + p0 + col;
            store2(out, adx[si][j][2 * e] + v0, adx[si][j][2 * e + 1] + v1);
            const float* xr = R0 + i * ld1 + col;
            bt[si][e] += static_cast<double>(xr[0] * v0) + static_cast<double>(xr[1] * v1);
          }
        }
      }
    }
    // the C term: Σ_n C_in (dy·S_cᵀ)_in, 64 columns of N at a time
    for (int n0 = 0; n0 < N8; n0 += 64) {
      const int nb = n0 + 16 * ro.q;
      float acs[2][2][4] = {};
      pair_mma(acs, PT,
               [&](int s, int k) { return ld_a(R1, ld1, 16 * (s ? ro.hi : ro.lo), k, lane); },
               [&](int k, int j) { return ld_b_t(Ss, lds, imin(nb + 8 * j, N8 - 8), k, lane); });
      if (n0 == 0) {
        cp_async_wait<0>();
        __syncthreads();  // C is in place
      }
#pragma unroll
      for (int si = 0; si < 2; ++si) {
        if (!ro.active || (si == 1 && !ro.two)) break;
        const int r = si ? ro.hi : ro.lo;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = nb + 8 * j + 2 * t;
          if (n >= N) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 16 * r + g + 8 * e;
            const float* cr = R2 + i * ldb + n;
            ct[si][e] += static_cast<double>(cr[0] * acs[si][j][2 * e]) +
                         static_cast<double>(cr[1] * acs[si][j][2 * e + 1]);
          }
        }
      }
    }
    __syncthreads();  // every region is consumed
  }
  if (ro.active) {
#pragma unroll
    for (int si = 0; si < 2; ++si) {
      if (si == 1 && !ro.two) break;
      const int r = si ? ro.hi : ro.lo;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const double b_sum = quad_sum(bt[si][e]);
        const double c_sum = quad_sum(ct[si][e]);
        const int i = 16 * r + g + 8 * e;
        if (t == 0) {
          parts[(8 + ro.q) * Q + i] = b_sum;
          parts[(12 + ro.q) * Q + i] = c_sum * static_cast<double>(ecum[i]);
        }
      }
    }
  }

  // ⟨G_c, S_{c+1}⟩ at the last position, summed in a fixed order
  double part = 0.0;
#pragma unroll 8
  for (long long idx = tid; idx < NP; idx += kWide) {
    part += static_cast<double>(Gc[idx] * S_out[idx]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) red[warp] = part;
  __syncthreads();  // red and every partial of dcum are written
  if (tid < valid) {
    // rows' intra terms, less the columns', less the B terms, plus the C
    // terms, each group of four in its slots' order
    double d = 0.0;
    for (int k = 0; k < 4; ++k) d += parts[k * Q + tid];
    for (int k = 4; k < 8; ++k) d -= parts[k * Q + tid];
    for (int k = 8; k < 12; ++k) d -= parts[k * Q + tid];
    for (int k = 12; k < 16; ++k) d += parts[k * Q + tid];
    if (tid == valid - 1) {
      double total = 0.0;
      for (int k = 0; k < kWideWarps; ++k) total += red[k];
      d += total;
    }
    parts[tid] = d;
  } else if (tid < Q) {
    parts[tid] = 0.0;
  }
  __syncthreads();

  // ddA: the reverse cumsum of dcum over the chunk's positions, by warp 0:
  // each lane's (up to 4) positions, then the lanes above it, in a fixed tree
  if (warp == 0) {
    const int per = (Q + 31) / 32;
    double v[4];
    double run = 0.0;
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const int i = lane * per + e;
      if (e < per && i < Q) run += parts[i];
      v[e] = run;
    }
    double incl = run;      // Σ over this lane and the lanes above it
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const double o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    double above = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) above = 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = lane * per + e;
      if (e < per && i < valid) {
        ddA[(static_cast<long long>(b) * T_len + t0 + i) * H + h] = static_cast<float>(v[e] + above);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 4. per (chunk, group of heads, half of N): dB and dC
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kWide, 1)
ssd_bwd_bc(const T* __restrict__ xdt, const T* __restrict__ Bm, const T* __restrict__ Cm,
           const float* __restrict__ dy, const float* __restrict__ G,
           const float* __restrict__ cumx, const float* __restrict__ carry,
           const float* __restrict__ init_state, float* __restrict__ dB, float* __restrict__ dC,
           float* __restrict__ partB, float* __restrict__ partC, int T_len, int H, int P, int N,
           int Q, int hg, Strides st) {
  const int N8 = round8(N);
  const int halves = (N8 + kHalf - 1) / kHalf;
  const int half = blockIdx.x % halves;
  const int grp = blockIdx.x / halves;
  const int groups = gridDim.x / halves;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.y;
  const int t0 = c * Q;
  const int valid = min(Q, T_len - t0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int S = Q / 16;
  const int HW = imin(kHalf, N8);
  const int n0 = half * kHalf;
  const int nh = imin(HW, N8 - n0);        // columns of this half (padded N)
  const int PS = p_slice(P);
  const int n_ps = P / PS;
  const int h0 = grp * hg;
  const int n_sl = (imin(H, h0 + hg) - h0) * n_ps;
  const long long bc = static_cast<long long>(b) * n_chunks + c;
  const long long NP = static_cast<long long>(N) * P;
  const Roles ro = roles(warp, S);

  extern __shared__ float4 smem4[];
  const int ldm = Q + 4;
  const int ldp = PS + 4;
  const int ldh = HW + 8;
  const int stage_floats = ring_stage(Q, PS, HW);
  float* Ms = reinterpret_cast<float*>(smem4);     // Σ_h M_h, [i][j]
  float* ring = Ms + Q * ldm;
  const T* B_c = Bm + b * st.bs_b + t0 * st.bs_t;
  const T* C_c = Cm + b * st.cs_b + t0 * st.cs_t;

  // slice sl: head h0 + sl / n_ps, columns (sl % n_ps)·PS of P, into stage k:
  // dy and xdt [i][p]; S and G, rows n0 .. n0 + HW, [n][p]; cum, ecum and w
  auto issue = [&](int sl, int k) {
    const int h = h0 + sl / n_ps;
    const int p0 = (sl % n_ps) * PS;
    float* Ys = ring + k * stage_floats;
    float* Xs = Ys + Q * ldp;
    float* Ss = Xs + Q * ldp;
    float* Gs = Ss + HW * ldp;
    float* cx = Gs + HW * ldp;
    const long long bh = static_cast<long long>(b) * H + h;
    stage_tile(Ys, ldp, dy + (static_cast<long long>(b) * T_len + t0) * H * P + h * P + p0,
               static_cast<long long>(H) * P, Q, valid, PS, PS, dy);
    stage_tile(Xs, ldp, xdt + b * st.xs_b + t0 * st.xs_t + h * st.xs_h + p0, st.xs_t, Q, valid,
               PS, PS, xdt);
    const float* S_in = c == 0 ? (init_state != nullptr ? init_state + bh * NP : nullptr)
                               : carry + ((bc - 1) * H + h) * NP;
    if (S_in != nullptr) {
      stage_tile(Ss, ldp, S_in + n0 * P + p0, P, HW, N - n0, PS, PS, carry);
    } else {
      zero_tile(Ss, ldp, HW, PS);
    }
    stage_tile(Gs, ldp, G + (bc * H + h) * NP + n0 * P + p0, P, HW, N - n0, PS, PS, G);
    stage_tile(cx, 4 * Q, cumx + (bc * H + h) * 4 * Q, 0, 1, 1, 4 * Q, 4 * Q, cumx);
  };

  // the warp's column tiles 2q, 2q + 1 of the half, clamped into it
  auto hcol = [&](int j) { return imin(16 * ro.q + 8 * j, nh - 8); };
  float rlo[2][4] = {};
  float rhi[4][4] = {};
  float aC[2][2][4] = {};
  float aB[2][2][4] = {};
  issue(0, 0);
  cp_async_commit();
  for (int sl = 0; sl < n_sl; ++sl) {
    if (sl + 1 < n_sl) issue(sl + 1, (sl + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // slice sl is in place
    const int h = h0 + sl / n_ps;
    const float* Ys = ring + (sl & 1) * stage_floats;
    const float* Xs = Ys + Q * ldp;
    const float* Ss = Xs + Q * ldp;
    const float* Gs = Ss + HW * ldp;
    const float* cx = Gs + HW * ldp;
    const double* cum = reinterpret_cast<const double*>(cx);
    const float* ecum = cx + 2 * Q;
    const float* w = cx + 3 * Q;
    if (sl % n_ps == 0) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int e = 0; e < 4; ++e) rlo[s][e] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int e = 0; e < 4; ++e) rhi[s][e] = 0.f;
      }
    }
    tri_product(rlo, rhi, Ys, ldp, Xs, ldp, PS, 2 * S - 1, ro, lane);
    // the state parts: (ecum ∘ dy)·Sᵀ into dC's, (w ∘ xdt)·Gᵀ into dB's
    const int il = 16 * ro.lo + g;
    const int ih = 16 * ro.hi + g;
    const float el0 = ecum[il], el1 = ecum[il + 8], eh0 = ecum[ih], eh1 = ecum[ih + 8];
    const float wl0 = w[il], wl1 = w[il + 8], wh0 = w[ih], wh1 = w[ih + 8];
    pair_mma(aC, PS,
             [&](int s, int k) {
               return s ? ld_a(Ys, ldp, 16 * ro.hi, k, lane, eh0, eh1)
                        : ld_a(Ys, ldp, 16 * ro.lo, k, lane, el0, el1);
             },
             [&](int k, int j) { return ld_b_t(Ss, ldp, hcol(j), k, lane); });
    pair_mma(aB, PS,
             [&](int s, int k) {
               return s ? ld_a(Xs, ldp, 16 * ro.hi, k, lane, wh0, wh1)
                        : ld_a(Xs, ldp, 16 * ro.lo, k, lane, wl0, wl1);
             },
             [&](int k, int j) { return ld_b_t(Gs, ldp, hcol(j), k, lane); });
    if (ro.active && sl % n_ps == n_ps - 1) {
      // Msum (+)= L ∘ raw at the positions this warp owns
      const bool first = h == h0;
      auto add = [&](const auto& acc, int strip) {
        each_tile(acc, ro.tiles(strip), [&](int s, const float (&a)[4]) {
          tile_values(a, strip, ro.q + 4 * s, g, t, [&](int i, int j, float raw) {
            const bool in = j <= i && i < valid;
            const float m = in ? raw * decay_ij(cum[i], cum[j]) : 0.f;
            Ms[i * ldm + j] = first ? m : Ms[i * ldm + j] + m;
          });
        });
      };
      add(rlo, ro.lo);
      if (ro.two) add(rhi, ro.hi);
    }
    __syncthreads();  // stage sl & 1 is consumed
  }

  // this half's columns of B and C, [j][n]; then Msum·B and Msumᵀ·C
  float* Bh = ring;
  float* Ch = ring + Q * ldh;
  stage_tile(Bh, ldh, B_c + n0, st.bs_t, Q, valid, HW, N - n0, Bm);
  stage_tile(Ch, ldh, C_c + n0, st.cs_t, Q, valid, HW, N - n0, Cm);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Msum's triangle: row strip r takes columns below 16(r + 1) in Msum·B and
  // rows from 16r on in Msumᵀ·C (the rest of Msum is not written)
  pair_mma(aC, Q,
           [&](int s, int k) {
             const int r = s ? ro.hi : ro.lo;
             return keep(ld_a(Ms, ldm, 16 * r, k, lane), k < 16 * (r + 1));
           },
           [&](int k, int j) { return ld_b(Bh, ldh, k, hcol(j), g, t); });
  pair_mma_from(aB, 16 * ro.lo, 16 * ro.hi, Q,
                [&](int s, int k) { return ld_a_t(Ms, ldm, 16 * (s ? ro.hi : ro.lo), k, g, t); },
                [&](int k, int j) { return ld_b(Ch, ldh, k, hcol(j), g, t); });
  if (!ro.active) return;
#pragma unroll
  for (int si = 0; si < 2; ++si) {
    if (si == 1 && !ro.two) break;
    const int r = si ? ro.hi : ro.lo;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + 16 * ro.q + 8 * j + 2 * t;
      if (16 * ro.q + 8 * j >= nh || n >= N) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 16 * r + g + 8 * e;
        if (i >= valid) continue;
        float* oc;
        float* ob;
        if (groups == 1) {
          oc = dC + (static_cast<long long>(b) * T_len + t0 + i) * N + n;
          ob = dB + (static_cast<long long>(b) * T_len + t0 + i) * N + n;
        } else {
          const long long row = (bc * groups + grp) * Q + i;
          oc = partC + row * N + n;
          ob = partB + row * N + n;
        }
        store2(oc, aC[si][j][2 * e], aC[si][j][2 * e + 1]);
        store2(ob, aB[si][j][2 * e], aB[si][j][2 * e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 5. dB and dC: the groups' partials summed in order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_sum(const float* __restrict__ partB, const float* __restrict__ partC,
                  float* __restrict__ dB, float* __restrict__ dC, int T_len, int N, int Q,
                  int n_chunks, int groups, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % N);
  const int tt = static_cast<int>((idx / N) % T_len);
  const long long b = idx / (static_cast<long long>(N) * T_len);
  const long long stride = static_cast<long long>(Q) * N;
  const long long base = ((b * n_chunks + tt / Q) * groups * Q + tt % Q) * N + n;
  float sb = 0.f;
  float sc = 0.f;
  for (int k = 0; k < groups; ++k) {
    sb += partB[base + k * stride];
    sc += partC[base + k * stride];
  }
  dB[idx] = sb;
  dC[idx] = sc;
}

template <class K>
cudaError_t allow_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  done = err == cudaSuccess;
  return err;
}

template <typename T>
cudaError_t launch(const void* xdt_v, const void* dA_v, const void* Bm_v, const void* Cm_v,
                   const float* dy, const float* carry, const float* init_state,
                   const float* final_state, const float* d_final, float* CB, float* G,
                   float* cumx, float* decay, float* partB, float* partC, float* dx, float* ddA,
                   float* dB, float* dC, float* d_init, int B, int T_len, int H, int P, int N,
                   int Q, int hg, const Strides& st, cudaStream_t stream) {
  if (Q < 16 || Q > kMaxQ || Q % 16 || N < 4 || N > kMaxN || N % 4 || P < 16 || P % 16 ||
      T_len < 1 || B < 1 || H < 1 || hg < 1) {
    return cudaErrorInvalidValue;
  }
  const T* xdt = static_cast<const T*>(xdt_v);
  const T* dA = static_cast<const T*>(dA_v);
  const T* Bm = static_cast<const T*>(Bm_v);
  const T* Cm = static_cast<const T*>(Cm_v);
  const int n_chunks = (T_len + Q - 1) / Q;
  const int N8 = round8(N);
  const int PT = p_tile(P);
  const int HW = imin(kHalf, N8);
  const int halves = (N8 + kHalf - 1) / kHalf;
  const int groups = (H + hg - 1) / hg;
  const int NP = N * P;
  // raise the dynamic shared-memory limit once per device
  static bool configured[kMaxDevices][3] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  bool scratch[3] = {};
  bool* done = dev < kMaxDevices ? configured[dev] : scratch;
  if ((err = allow_smem(ssd_bwd_chunk<T>, done[0])) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_grads<T>, done[1])) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_bc<T>, done[2])) != cudaSuccess) return err;

  ssd_bwd_chunk<T><<<dim3((Q + 63) / 64 + H * (P / PT), n_chunks, B), kThreads,
                     chunk_smem(Q, N8, PT), stream>>>(dA, Bm, Cm, dy, CB, G, cumx, decay, T_len,
                                                      H, P, N, Q, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int per_block = kStateVals * kThreads;
  ssd_bwd_state<<<dim3((NP + per_block - 1) / per_block, H, B), kThreads, 0, stream>>>(
      G, decay, d_final, d_init, H, NP, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_grads<T><<<dim3(H, n_chunks, B), kWide, grads_smem(Q, N8, PT), stream>>>(
      xdt, Bm, Cm, dy, CB, G, cumx, carry, init_state, final_state, dx, ddA, T_len, H, P, N,
      Q, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_bc<T><<<dim3(halves * groups, n_chunks, B), kWide, bc_smem(Q, p_slice(P), HW),
                  stream>>>(xdt, Bm, Cm, dy, G, cumx, carry, init_state, dB, dC, partB, partC,
                            T_len, H, P, N, Q, hg, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (groups > 1) {
    const long long total = static_cast<long long>(B) * T_len * N;
    ssd_bwd_group_sum<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                        stream>>>(partB, partC, dB, dC, T_len, N, Q, n_chunks, groups, total);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace
}  // namespace repro_torch

// Scratch (dense fp32, nothing needs clearing): CB (B, chunks, Q, Q), C·Bᵀ
// transposed; G (B, chunks, H, N, P); cumx (B, chunks, H, 4Q); decay (B,
// chunks, H); with more than one head group the partials of dB and dC (B,
// chunks, ceil(H / group_heads), Q, N) each; chunks = ceil(T / Q).  init_state,
// d_final and d_init may be null (d_init must be null when init_state is).
// strides (in elements): xdt b, t, h; dA b, t, h; Bm b, t; Cm b, t.  dtype:
// 0 = float32, 1 = bfloat16 (xdt, dA, Bm, Cm share it).  Four or five
// launches on `stream`.  Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_bwd(const void* xdt, const void* dA, const void* Bm, const void* Cm,
                            const void* dy, const void* carry, const void* init_state,
                            const void* final_state, const void* d_final, void* cb, void* g,
                            void* cumx, void* decay, void* dbp, void* dcp, void* dx, void* ddA,
                            void* dB, void* dC, void* d_init, int B, int T, int H, int P, int N,
                            int Q, int group_heads, long long xs_b, long long xs_t,
                            long long xs_h, long long as_b, long long as_t, long long as_h,
                            long long bs_b, long long bs_t, long long cs_b, long long cs_t,
                            int dtype, void* stream) {
  const repro_torch::Strides st{xs_b, xs_t, xs_h, as_b, as_t, as_h, bs_b, bs_t, cs_b, cs_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_dy = static_cast<const float*>(dy);
  const float* f_carry = static_cast<const float*>(carry);
  const float* f_s0 = static_cast<const float*>(init_state);
  const float* f_sT = static_cast<const float*>(final_state);
  const float* f_dT = static_cast<const float*>(d_final);
  float* f_cb = static_cast<float*>(cb);
  float* f_g = static_cast<float*>(g);
  float* f_cx = static_cast<float*>(cumx);
  float* f_dec = static_cast<float*>(decay);
  float* f_dbp = static_cast<float*>(dbp);
  float* f_dcp = static_cast<float*>(dcp);
  float* f_dx = static_cast<float*>(dx);
  float* f_da = static_cast<float*>(ddA);
  float* f_db = static_cast<float*>(dB);
  float* f_dc = static_cast<float*>(dC);
  float* f_d0 = static_cast<float*>(d_init);
  if ((f_s0 == nullptr) != (f_d0 == nullptr)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    return repro_torch::launch<float>(xdt, dA, Bm, Cm, f_dy, f_carry, f_s0, f_sT, f_dT, f_cb,
                                      f_g, f_cx, f_dec, f_dbp, f_dcp, f_dx, f_da, f_db,
                                      f_dc, f_d0, B, T, H, P, N, Q, group_heads, st, s);
  }
  if (dtype == 1) {
    return repro_torch::launch<__nv_bfloat16>(xdt, dA, Bm, Cm, f_dy, f_carry, f_s0, f_sT, f_dT,
                                              f_cb, f_g, f_cx, f_dec, f_dbp, f_dcp, f_dx,
                                              f_da, f_db, f_dc, f_d0, B, T, H, P, N, Q,
                                              group_heads, st, s);
  }
  return cudaErrorInvalidValue;
}
