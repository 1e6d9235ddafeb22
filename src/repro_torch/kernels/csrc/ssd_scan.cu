// Mamba2 chunked SSD scan (state-space duality), sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (_ssd_kernel).
// Per chunk of Q positions, with cum the inclusive cumsum of dA inside it:
//   y     = (C·Bᵀ ∘ L)·xdt + exp(cum) ∘ (C·S_prev),  L[i,j] = exp(cum_i − cum_j), i ≥ j
//   S_new = exp(cum_last)·S_prev + Bᵀ·(exp(cum_last − cum) ∘ xdt)
// The exponent of L is masked before exp (the upper triangle would overflow).
// cum is summed in fp64 and each difference rounded to fp32 only then: an
// fp32 cumsum that reaches -90 over a chunk carries absolute errors of ~1e-5,
// which every decay exp(cum_i − cum_j) turns into a relative error of y.
//
// Layout: xdt (B, T, H, P) and dA (B, T, H), Bm and Cm (B, T, N), each read
// through its own batch/time(/head) strides with the last axis dense, in fp32
// or bf16; initial_state (B, H, N, P) fp32 dense or null; y (B, T, H, P) fp32
// dense; state_out (B, H, N, P) fp32 dense.  Arithmetic is fp32 but for
// the cumsum of dA.
//
// Bound: operations.  The products need fp32's accuracy (the plain version
// is held to 2e-4; one TF32 pass keeps three digits), so the least time is
// theirs at 3xTF32's rate on the tensor cores, 495 / 3 TFLOP/s (mamba2_370m
// prefill, T = 512: 0.68 GFLOP, 0.0042 ms, against 11 MB in and out,
// 0.0033 ms).  The scratch between the launches and the chunks' end states
// add as many bytes again, so at the training shape (B = 4, T = 2048) the
// bytes come close to the operations' time.
//
// Design: the chunked-SSD decomposition (Mamba2, arXiv:2405.21060 §6) in two
// launches, both parallel over chunks.  The Pallas kernel carries the state
// in VMEM along a sequential chunk axis of its grid; here every chunk is a
// block of its own.  Every product is a 3xTF32 mma.sync m16n8k8 with
// mma.cuh's Mma<float> fragments and passes, split as K3-bwd splits them
// (ssd_tile.cuh): big = tf32(x) rounded to nearest, small = x − big (the
// tensor core reads its top bits), three products, the small terms first,
// small·small dropped (repro_torch.kernels.ref.matmul_3xtf32).  Operands sit
// in shared memory with rows padded so that ldmatrix and the scalar
// fragment loads hit distinct banks; N is padded with zeros there.  No mma
// sits under a condition that differs between warps (ptxas would reconverge
// the warp around each one): where warps take different shares, the bounds
// of their k loops differ.
// 1. ssd_fwd_chunk, grid (ceil(Q/32) + H·P/PT, chunks, B), 8 warps, two
//    blocks an SM:
//    - a block per 32 rows of a chunk computes C·Bᵀ over the causal
//      triangle's 16 x 8 tiles, four tiles a warp at a time (it depends on
//      neither the head nor the state column), into fp32 scratch CB (B,
//      chunks, Q, Q), row i, the columns below the end of i's 16-row strip.
//      From bf16 inputs both operands are exact in TF32 (their small parts
//      are zero), so this product takes the one TF32 pass big·big, which
//      gives the bits of the three;
//    - a block per (head, PT state columns) stages B and xdt with cp.async,
//      takes the chunk's fp64 cumsum of dA (its dA loaded ahead of the
//      tiles) and the state contribution ΔS = Bᵀ·(w ∘ xdt), w = exp(cum_last
//      − cum), into scratch dS (B, chunks, H, N, P): warp (m, half) owns two
//      16-row strips of N and half of the columns.  It writes the chunk's
//      decay exp(cum_last) into decay (B, chunks, H) and the cumsum with
//      exp(cum) into cumx (B, chunks, H, 3Q), and clears the chunk's flags
//      (B, chunks, H, P/PT).
// 2. ssd_fwd_scan, grid (P/PT, H, chunks·B), 16 warps, one block an SM,
//    the chunks in launch order: a block takes its chunk's starting state
//    S_prev by a look-back that never waits.  From the chunk before its own
//    it walks back to the nearest one whose flag says that its end state is
//    published in carry (B, chunks, H, N, P), or to the initial state, and
//    adds the ΔS of the chunks in between, each decayed to its own start; it
//    stores its own end state decay·S_prev + ΔS (the last chunk's blocks the
//    final state instead) and publishes it after the next barrier.  A walk
//    is as long as the chunks still in flight ahead of it, so the state
//    passing reads O(chunks) values, not O(chunks²).  It then computes
//    y = [C·Bᵀ ∘ L | exp(cum) ∘ C] · [xdt ; S_prev], one product of depth
//    Q + N, in slices of 32: each slice's values are loaded into registers
//    a slice ahead (C·Bᵀ's columns below the causal edge and xdt's rows,
//    then C's columns; S_prev stays in shared memory whole), and written
//    into one of two shared buffers with L or exp(cum) applied to the left
//    operand (L's mask a select, so values above the causal edge are never
//    read) and the right one transposed to [p][k], while other warps still
//    multiply the slice before: one barrier a slice.  Warp (pair, group)
//    owns the 16-row strips pair and S − 1 − pair of the chunk's S and a
//    quarter of the PT columns, so that the four pairs share the triangle
//    evenly; a strip skips the k-steps above its causal edge.
// A ragged last chunk (T not a multiple of Q) is loaded with zeros past T:
// a masked position has dA = 0 and xdt = B = C = 0, so it multiplies the
// state by exp(0) = 1 and adds nothing, which is exact.
#include "ssd_tile.cuh"

#include <math.h>
#include <type_traits>

namespace repro_torch {
namespace {

constexpr int kChunkThreads = 256;        // threads of a block of ssd_fwd_chunk, two blocks an SM
constexpr int kChunkWarps = kChunkThreads / 32;
constexpr int kScanThreads = 512;         // threads of a block of ssd_fwd_scan, one block an SM
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kSlice = 32;                // depth of a slice of the scan's product
constexpr int kLdA = kSlice + 4;          // row stride of a slice's operands [i][k] and [p][k]
constexpr int kCBRows = 32;               // rows of C·Bᵀ a block of the first launch
constexpr int kCBTiles = 4;               // column tiles of C·Bᵀ a warp multiplies at once
constexpr int kMaxDevices = 16;           // devices whose attributes are cached

// Passes of C·Bᵀ: from bf16 inputs the small parts are zero, so big·big alone
template <typename T>
constexpr int kFirstPass = std::is_same<T, float>::value ? 0 : MF::kPasses - 1;

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int round32(int n) { return (n + 31) / 32 * 32; }

// Dynamic shared memory of each launch (bytes): the fp64 cumsum and one fp32
// vector of Q; then ssd_fwd_chunk's C rows over B's, or B's rows [j][n]
// beside xdt's [j][p]; ssd_fwd_scan's S_prev [n][p] and two buffers of a
// slice's operands, [i][k] and [p][k].
__host__ __device__ __forceinline__ int chunk_smem(int Q, int N8, int PT) {
  return 12 * Q + 4 * imax((imin(Q, kCBRows) + Q) * (N8 + 4), Q * (N8 + 8) + Q * (PT + 8));
}
__host__ __device__ __forceinline__ int scan_smem(int Q, int N, int PT) {
  return 12 * Q + 4 * (round32(N) * (PT + 8) + 2 * (Q + PT) * kLdA);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Whether rows of T at `base`, `stride` elements apart, take load4's
// vector loads (16 bytes of fp32, 8 of bf16).
template <typename T>
__device__ __forceinline__ bool vec_rows(const T* base, long long stride) {
  constexpr int kAlign = 4 * sizeof(T);
  return ((reinterpret_cast<uintptr_t>(base) | static_cast<uintptr_t>(stride * sizeof(T))) %
          kAlign) == 0;
}

// Four consecutive values at p as fp32 into v (zeros where !ok).
__device__ __forceinline__ void load4(float* v, const float* p, bool ok, bool vec) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok) x = vec ? *reinterpret_cast<const float4*>(p) : make_float4(p[0], p[1], p[2], p[3]);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(float* v, const __nv_bfloat16* p, bool ok, bool vec) {
  float2 a = make_float2(0.f, 0.f);
  float2 b = a;
  if (ok && vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  } else if (ok) {
    a = make_float2(__bfloat162float(p[0]), __bfloat162float(p[1]));
    b = make_float2(__bfloat162float(p[2]), __bfloat162float(p[3]));
  }
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// B (8 x 8) of the NT column tiles n0 + 8j at k0 of a tile stored [n][k]
// (ld / 4 odd), split: an ldmatrix.x4 for each two tiles (n 0-7 at k 0-3 and
// 4-7, then the next 8 n), .x2 (ld_b_t) for a lone one
template <int NT>
__device__ __forceinline__ void ld_b_tiles(MF::B (&b)[NT], const float* s, int ld, int n0, int k0,
                                           int lane) {
  if constexpr (NT == 1) {
    b[0] = ld_b_t(s, ld, n0, k0, lane);
  } else {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, s + (n0 + 8 * j + (lane & 7) + 8 * (lane >> 4)) * ld + k0 +
                         4 * ((lane >> 3) & 1));
      b[j] = split_b(__uint_as_float(r[0]), __uint_as_float(r[1]));
      b[j + 1] = split_b(__uint_as_float(r[2]), __uint_as_float(r[3]));
    }
  }
}

// acc[s][j] += A(s, k)·B(k, j) over one slice of the scan's product for the
// warp's strips s = 0 (lo, rows r_lo) and 1 (hi, rows r_hi) and its NT
// column tiles from n0, A stored [i][k] and B [p][k] (ld kLdA): both strips
// over the slice's first n_lo k-steps of 8, strip hi alone over the k-steps
// from there to n_hi.  The bounds differ between warps; no mma is under a
// condition.  The strips share each B fragment, and the three passes run
// over every accumulator in turn, so that an mma does not wait on the one
// before it.
template <int NT>
__device__ __forceinline__ void strips_mma(float (&acc)[2][NT][4], int n_lo, int n_hi,
                                           const float* A, const float* B, int r_lo, int r_hi,
                                           int n0, int lane) {
  for (int ks = 0; ks < n_lo; ++ks) {
    const MF::A a0 = ld_a(A, kLdA, r_lo, 8 * ks, lane);
    const MF::A a1 = ld_a(A, kLdA, r_hi, 8 * ks, lane);
    MF::B bb[NT];
    ld_b_tiles<NT>(bb, B, kLdA, n0, 8 * ks, lane);
#pragma unroll
    for (int p = 0; p < MF::kPasses; ++p) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        MF::mma_pass(p, acc[0][j], a0, bb[j]);
        MF::mma_pass(p, acc[1][j], a1, bb[j]);
      }
    }
  }
  for (int ks = n_lo; ks < n_hi; ++ks) {
    const MF::A a1 = ld_a(A, kLdA, r_hi, 8 * ks, lane);
    MF::B bb[NT];
    ld_b_tiles<NT>(bb, B, kLdA, n0, 8 * ks, lane);
#pragma unroll
    for (int p = 0; p < MF::kPasses; ++p) {
#pragma unroll
      for (int j = 0; j < NT; ++j) MF::mma_pass(p, acc[1][j], a1, bb[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. per chunk: C·Bᵀ over the triangle (a block per kCBRows rows); per (head, PT
//    state columns) ΔS, the decay and the cumsum with exp(cum)
// ---------------------------------------------------------------------------
template <typename T, int PT>
__global__ void __launch_bounds__(kChunkThreads, 2)
ssd_fwd_chunk(const T* __restrict__ xdt, const T* __restrict__ dA, const T* __restrict__ Bm,
              const T* __restrict__ Cm, float* __restrict__ CB, float* __restrict__ dS,
              float* __restrict__ cumx, float* __restrict__ decay, int* __restrict__ flags,
              int T_len, int H, int P, int N, int Q, Strides st) {
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
  const int n_cb = (Q + kCBRows - 1) / kCBRows;
  const long long bc = static_cast<long long>(b) * n_chunks + c;

  extern __shared__ float4 smem4[];
  double* cum = reinterpret_cast<double*>(smem4);     // (Q,)
  float* w = reinterpret_cast<float*>(cum + Q);       // (Q,) exp(cum_last − cum), 0 past valid
  float* tiles = w + Q;

  const T* B_c = Bm + b * st.bs_b + t0 * st.bs_t;
  const T* C_c = Cm + b * st.cs_b + t0 * st.cs_t;

  if (static_cast<int>(blockIdx.x) < n_cb) {
    // C·Bᵀ, rows [r0, r1) and the columns left of each strip's end: C's
    // rows and B's rows [0, r1) staged [row][n]
    const int r0 = blockIdx.x * kCBRows;
    const int r1 = min(Q, r0 + kCBRows);
    const int ld = N8 + 4;
    float* Cs = tiles;
    float* Bs = tiles + (r1 - r0) * ld;
    stage_tile(Cs, ld, C_c + r0 * st.cs_t, st.cs_t, r1 - r0, valid - r0, N8, N, Cm);
    stage_tile(Bs, ld, B_c, st.bs_t, r1, valid, N8, N, Bm);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // a warp's item: kCBTiles column tiles of one strip (strip r has 2(r + 1)
    // tiles, so ceil((r + 1) / 2) items); tiles past the strip's last are
    // multiplied clamped to it and not stored
    int total = 0;
    for (int r = r0 / 16; r < r1 / 16; ++r) total += (r + 2) / 2;
    float* cb = CB + bc * Q * Q;
    for (int it = 0; it < (total + kChunkWarps - 1) / kChunkWarps; ++it) {
      int r = r0 / 16;
      int q = imin(warp + kChunkWarps * it, total - 1);
      while (q >= (r + 2) / 2) {
        q -= (r + 2) / 2;
        ++r;
      }
      const int last = 2 * r + 1;
      float acc[kCBTiles][4] = {};
#pragma unroll 2
      for (int k = 0; k < N8; k += 8) {
        const MF::A a = ld_a(Cs, ld, 16 * r - r0, k, lane);
        MF::B bb[kCBTiles];
#pragma unroll
        for (int u = 0; u < kCBTiles; ++u) {
          bb[u] = ld_b_t(Bs, ld, 8 * imin(kCBTiles * q + u, last), k, lane);
        }
#pragma unroll
        for (int p = kFirstPass<T>; p < MF::kPasses; ++p) {
#pragma unroll
          for (int u = 0; u < kCBTiles; ++u) MF::mma_pass(p, acc[u], a, bb[u]);
        }
      }
      if (warp + kChunkWarps * it >= total) continue;
#pragma unroll
      for (int u = 0; u < kCBTiles; ++u) {
        const int nt = kCBTiles * q + u;
        if (nt > last) continue;
        // row i = 16 r + g (+8), column j = 8 nt + 2t (+1)
        float* out = cb + static_cast<long long>(16 * r + g) * Q + 8 * nt + 2 * t;
        store2(out, acc[u][0], acc[u][1]);
        store2(out + 8 * Q, acc[u][2], acc[u][3]);
      }
    }
    return;
  }

  // ΔS of head h, state columns p0 .. p0 + PT: Bᵀ (rows n) over depth j,
  // B and xdt staged [j][n] and [j][p], xdt times w_j as its fragments load
  const int hb = blockIdx.x - n_cb;
  const int n_pt = P / PT;
  const int h = hb / n_pt;
  const int p0 = (hb % n_pt) * PT;
  const int ldb = N8 + 8;
  const int ldx = PT + 8;
  float* Bs = tiles;               // [j][n]
  float* Xs = tiles + Q * ldb;     // [j][p]
  float da[4];                     // warp 0's dA, loaded ahead of the tiles
  if (warp == 0) chunk_da(da, dA + b * st.as_b + h * st.as_h, st.as_t, t0, valid, Q, lane);
  stage_tile(Bs, ldb, B_c, st.bs_t, Q, valid, N8, N, Bm);
  stage_tile(Xs, ldx, xdt + b * st.xs_b + t0 * st.xs_t + h * st.xs_h + p0, st.xs_t, Q, valid,
             PT, PT, xdt);
  cp_async_commit();
  if (warp == 0) chunk_cumsum_from(cum, da, Q, lane);
  __syncthreads();
  const double cl = cum[Q - 1];
  float* cx = cumx + (bc * H + h) * 3 * Q;
  for (int i = tid; i < Q; i += kChunkThreads) {
    w[i] = i < valid ? expf(static_cast<float>(cl - cum[i])) : 0.f;
    if (p0 == 0) {
      reinterpret_cast<double*>(cx)[i] = cum[i];
      cx[2 * Q + i] = expf(static_cast<float>(cum[i]));
    }
  }
  if (p0 == 0 && tid == 0) decay[bc * H + h] = expf(static_cast<float>(cl));
  if (tid == 0) flags[bc * H * n_pt + hb] = 0;  // (head, column tile) = hb
  cp_async_wait<0>();
  __syncthreads();
  // warp (m, column half): rows 32m .. 32m + 31 of N (two strips of 16) and
  // half of the column tiles, so that each B value is split by 4 warps and
  // each Bᵀ value by 2; every warp multiplies (its rows clamped into the
  // tile), only the strips with rows of N write
  constexpr int NH = PT / 16;     // column tiles of a warp
  static_assert(kChunkWarps == 8, "8 warps: 4 pairs of strips x 2 column halves");
  const int m = warp >> 1;
  const int m0 = imin(32 * m, N8 - 8);
  const int m1 = imin(32 * m + 16, N8 - 8);
  const int c0 = (warp & 1) * 8 * NH;
  float acc[2][NH][4] = {};
#pragma unroll 2
  for (int k = 0; k < Q; k += 8) {
    const MF::A a0 = ld_a_t(Bs, ldb, m0, k, g, t);
    const MF::A a1 = ld_a_t(Bs, ldb, m1, k, g, t);
    const float w0 = w[k + t];
    const float w1 = w[k + t + 4];
    MF::B bb[NH];
#pragma unroll
    for (int j = 0; j < NH; ++j) bb[j] = ld_b(Xs, ldx, k, c0 + 8 * j, g, t, w0, w1);
#pragma unroll
    for (int p = 0; p < MF::kPasses; ++p) {
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        MF::mma_pass(p, acc[0][j], a0, bb[j]);
        MF::mma_pass(p, acc[1][j], a1, bb[j]);
      }
    }
  }
  float* out = dS + (bc * H + h) * static_cast<long long>(N) * P + p0 + c0;
#pragma unroll
  for (int si = 0; si < 2; ++si) {
    const int n = 32 * m + 16 * si + g;
    if (n - g >= N8) continue;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      if (n < N) store2(out + n * P + 8 * j + 2 * t, acc[si][j][0], acc[si][j][1]);
      if (n + 8 < N) store2(out + (n + 8) * P + 8 * j + 2 * t, acc[si][j][2], acc[si][j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. per (chunk, head, column tile): S_prev by look-back, then y
// ---------------------------------------------------------------------------
template <typename T, int PT>
__global__ void __launch_bounds__(kScanThreads, 1)
ssd_fwd_scan(const T* __restrict__ xdt, const T* __restrict__ Cm,
             const float* __restrict__ init_state, const float* __restrict__ CB,
             const float* __restrict__ cumx, const float* __restrict__ dS,
             const float* __restrict__ decay, float* __restrict__ carry, int* __restrict__ flags,
             float* __restrict__ y, float* __restrict__ state_out, int T_len, int H, int P,
             int N, int Q, int n_chunks, Strides st) {
  constexpr int kGroups = kScanWarps / 4;          // column groups: warps of a pair of strips
  constexpr int NT = PT < 8 * kGroups ? 1 : PT / (8 * kGroups);   // column tiles of a warp
  constexpr int ldx = PT + 8;     // row stride of S_prev
  constexpr int kRowsA = kScanThreads / 8;      // rows of the left operand a pass, 8 lanes a row
  constexpr int kPassA = kMaxQ / kRowsA;
  constexpr int kGroupsX = kScanThreads / PT;  // groups of 4 rows of xdt or S_prev a pass
  constexpr int kPassX = (kSlice / 4 + kGroupsX - 1) / kGroupsX;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int n_batch = gridDim.z / n_chunks;
  const int b = blockIdx.z % n_batch;
  const int c = blockIdx.z / n_batch;  // chunks in launch order
  const long long bc = static_cast<long long>(b) * n_chunks + c;
  const int t0 = c * Q;
  const int valid = min(Q, T_len - t0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int S = Q / 16;                           // strips of 16 rows
  const int n_intra = (Q + kSlice - 1) / kSlice;  // slices of C·Bᵀ ∘ L
  const int NS = round32(N);
  const int n_sl = n_intra + NS / kSlice;         // then of exp(cum) ∘ C

  extern __shared__ float4 smem4[];
  double* cum = reinterpret_cast<double*>(smem4);           // (Q,)
  float* ecum = reinterpret_cast<float*>(cum + Q);          // (Q,) exp(cum)
  float* Ss = ecum + Q;                                     // (NS, ldx) S_prev, [n][p]
  // two buffers of a slice's operands: A (Q, kLdA) [i][k], then B (PT,
  // kLdA) [p][k]
  float* slices = Ss + NS * ldx;
  const int buffer = (Q + PT) * kLdA;

  // the chunk's cumsum and exp(cum), from the first launch
  stage_tile(reinterpret_cast<float*>(cum), 3 * Q, cumx + (bc * H + h) * 3 * Q, 0, 1, 1, 3 * Q,
             3 * Q, cumx);
  cp_async_commit();

  // a slice's raw values, loaded into registers a slice ahead: 4 of the
  // left operand's row a_r + kRowsA e (C·Bᵀ's columns of the slice below the
  // causal edge, or C's) and 4 rows of xdt's column x_p
  const int a_r = tid >> 3;
  const int a_c = (tid & 7) * 4;
  const int x_p = tid % PT;       // xdt's column; its rows 4 x_g .. 4 x_g + 3 of the slice
  const int x_g = tid / PT;
  const float* cb = CB + bc * Q * Q;
  const T* x_c0 = xdt + b * st.xs_b + t0 * st.xs_t + h * st.xs_h + p0;
  const T* C_c = Cm + b * st.cs_b + t0 * st.cs_t;
  const bool vc_ok = vec_rows(C_c, st.cs_t);
  float ra[kPassA][4];
  float rx[kPassX][4];
  auto fetch = [&](int s) {
    if (s < n_intra) {
      const int k0 = kSlice * s;
#pragma unroll
      for (int e = 0; e < kPassA; ++e) {
        const int i = a_r + kRowsA * e;
        load4(ra[e], cb + i * Q + k0 + a_c, i < Q && i >= k0 && k0 + a_c < Q, true);
      }
#pragma unroll
      for (int e = 0; e < kPassX; ++e) {
        const int j = 4 * (x_g + kGroupsX * e);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = j < kSlice && k0 + j + u < valid;
          rx[e][u] = ok ? to_f32(x_c0[(k0 + j + u) * st.xs_t + x_p]) : 0.f;
        }
      }
    } else {
      const int n = kSlice * (s - n_intra) + a_c;
#pragma unroll
      for (int e = 0; e < kPassA; ++e) {
        const int i = a_r + kRowsA * e;
        load4(ra[e], C_c + i * st.cs_t + n, i < valid && n < N, vc_ok);
      }
    }
  };
  fetch(0);   // slice 0's values, under the look-back's loads

  // S_prev by look-back: walk from chunk c-1 towards chunk 0 and stop at
  // the first chunk whose end state is published (flag set) or at the
  // initial state; a chunk on the way adds its ΔS and multiplies the
  // factor f by its decay.  A thread owns up to PT / 4 values (n, p) and
  // issues all its loads of a step at once (faster than fewer loads in
  // flight: PERF.md).
  constexpr int kMaxE = kMaxN * PT / kScanThreads;
  const long long bh = static_cast<long long>(b) * H + h;
  const int n_pt = P / PT;
  __shared__ int published[2];
  float sp[kMaxE];
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) sp[e] = 0.f;
  float f = 1.f;
  for (int j = c - 1;; --j) {
    const float* src;  // N x PT values to add, times f
    bool last = j < 0;
    long long bj = 0;
    if (last) {
      if (init_state == nullptr) break;
      src = init_state + bh * N * P + p0;
    } else {
      bj = static_cast<long long>(b) * n_chunks + j;
      if (tid == 0) published[j & 1] = load_acquire(flags + (bj * H + h) * n_pt + blockIdx.x);
      __syncthreads();  // the slot is next written two steps on, after another barrier
      last = published[j & 1] != 0;
      src = (last ? carry : dS) + (bj * H + h) * N * P + p0;
    }
    float v[kMaxE];
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      const int idx = tid + e * kScanThreads;
      const int n = idx / PT;
      v[e] = n < N ? __ldcg(src + static_cast<long long>(n) * P + idx % PT) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) sp[e] = fmaf(f, v[e], sp[e]);
    if (last) break;
    f *= decay[bj * H + h];
  }
  {
    // this chunk's end state decay·S_prev + ΔS: published for the chunks
    // after it (the flag is set after the next barrier), or the final state
    const float a = decay[bc * H + h];
    const float* d = dS + (bc * H + h) * N * P + p0;
    float* dst = c == n_chunks - 1 ? state_out + bh * N * P + p0
                                   : carry + (bc * H + h) * N * P + p0;
    float v[kMaxE];
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      const int idx = tid + e * kScanThreads;
      const int n = idx / PT;
      v[e] = n < N ? d[static_cast<long long>(n) * P + idx % PT] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      const int idx = tid + e * kScanThreads;
      const int n = idx / PT;
      if (n < N) dst[static_cast<long long>(n) * P + idx % PT] = fmaf(sp[e], a, v[e]);
    }
  }
  // S_prev into shared memory (rows N .. NS zeros), the right operand of
  // the state slices
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    const int idx = tid + e * kScanThreads;
    if (idx < NS * PT) Ss[(idx / PT) * ldx + idx % PT] = sp[e];
  }
  cp_async_wait<0>();
  __syncthreads();  // cum, exp(cum) and S_prev are in place
  // every end state is stored before the flag says so: the barrier orders
  // the block's stores before thread 0's, and its release store makes them
  // visible with the flag
  if (tid == 0 && c < n_chunks - 1) store_release(flags + (bc * H + h) * n_pt + blockIdx.x, 1);

  // warp (pair, group): strips lo = pair and hi = S − 1 − pair (lo alone
  // for the middle strip of an odd S; none for pair ≥ ceil(S/2)), and NT
  // column tiles of the kGroups groups (groups past the tile repeat the
  // last one's, clamped, and store nothing)
  const int pair = warp / kGroups;
  const bool active = pair <= S - 1 - pair;
  const bool two = pair < S - 1 - pair;
  const int lo = imin(pair, S - 1);
  const int hi = two ? S - 1 - pair : lo;
  const int tile0 = (warp % kGroups) * NT;
  const bool own = 8 * tile0 < PT;
  const int cbase = 8 * imin(tile0, PT / 8 - NT);

  // slice s's operands into buffer s & 1 from the registers fetch filled:
  // the left one with L (below the causal edge; a select, so that masked
  // values are never read) or exp(cum) applied, the right one transposed
  auto prep = [&](int s) {
    float* As = slices + (s & 1) * buffer;
    float* Bs = As + Q * kLdA;
    if (s < n_intra) {
      const int k0 = kSlice * s;
#pragma unroll
      for (int e = 0; e < kPassA; ++e) {
        const int i = a_r + kRowsA * e;
        if (i < Q && i >= k0) {
          const double ci = cum[i];
          float x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = k0 + a_c + u;
            const float l = __expf(static_cast<float>(ci - cum[imin(j, Q - 1)]));
            x[u] = j <= i ? ra[e][u] * l : 0.f;
          }
          store4(As + i * kLdA + a_c, x[0], x[1], x[2], x[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < kPassX; ++e) {
        const int j = 4 * (x_g + kGroupsX * e);
        if (j < kSlice) store4(Bs + x_p * kLdA + j, rx[e][0], rx[e][1], rx[e][2], rx[e][3]);
      }
    } else {
      const int n0 = kSlice * (s - n_intra);
#pragma unroll
      for (int e = 0; e < kPassA; ++e) {
        const int i = a_r + kRowsA * e;
        if (i < Q) {
          const float ei = ecum[i];
          const float x[4] = {ra[e][0] * ei, ra[e][1] * ei, ra[e][2] * ei, ra[e][3] * ei};
          store4(As + i * kLdA + a_c, x[0], x[1], x[2], x[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < kPassX; ++e) {
        const int j = 4 * (x_g + kGroupsX * e);
        if (j < kSlice) {
          const float* sv = Ss + (n0 + j) * ldx + x_p;
          const float x[4] = {sv[0], sv[ldx], sv[2 * ldx], sv[3 * ldx]};
          store4(Bs + x_p * kLdA + j, x[0], x[1], x[2], x[3]);
        }
      }
    }
  };
  float acc[2][NT][4] = {};
  prep(0);
  if (n_sl > 1) fetch(1);
  __syncthreads();  // slice 0's operands are in place
  for (int s = 0; s < n_sl; ++s) {
    // k-steps of 8 a strip takes: of the intra-chunk slices only those below
    // its causal edge (strip r ends at 16(r + 1)), of the state slices all
    int k_lo = kSlice / 8;
    int k_hi = kSlice / 8;
    if (s < n_intra) {
      k_lo = imin(k_lo, imax(0, (16 * (lo + 1) - kSlice * s) / 8));
      k_hi = imin(k_hi, imax(0, (16 * (hi + 1) - kSlice * s) / 8));
    }
    const float* As = slices + (s & 1) * buffer;
    strips_mma<NT>(acc, two ? k_lo : 0, active ? k_hi : 0, As, As + Q * kLdA, 16 * lo, 16 * hi,
                   cbase, lane);
    // the next slice's operands into the other buffer (consumed a barrier ago)
    // while other warps still multiply, and the one after into registers
    if (s + 1 < n_sl) prep(s + 1);
    if (s + 2 < n_sl) fetch(s + 2);
    __syncthreads();  // slice s + 1's operands are in place, slice s's consumed
  }

  if (!active || !own) return;
#pragma unroll
  for (int si = 0; si < 2; ++si) {
    if (si == 0 && !two) continue;
    const int r = si ? hi : lo;
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 16 * r + g + 8 * e;
        if (i >= valid) continue;
        float* out = y + ((static_cast<long long>(b) * T_len + t0 + i) * H + h) * P + p0 + cbase +
                     8 * jt + 2 * t;
        store2(out, acc[si][jt][2 * e], acc[si][jt][2 * e + 1]);
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit once per device, to the most
// any shape needs, rather than on every call.
template <class K>
cudaError_t allow_smem(K kernel, bool (&configured)[kMaxDevices], int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && configured[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  return err;
}

template <typename T, int PT>
cudaError_t launch_tile(const T* xdt, const T* dA, const T* Bm, const T* Cm,
                        const float* init_state, float* CB, float* dS, float* cumx, float* carry,
                        float* decay, int* flags, float* y, float* state_out, int B, int T_len,
                        int H, int P, int N, int Q, const Strides& st, cudaStream_t stream) {
  static bool chunk_configured[kMaxDevices] = {};
  static bool scan_configured[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(ssd_fwd_chunk<T, PT>, chunk_configured, chunk_smem(kMaxQ, kMaxN, PT));
  if (err != cudaSuccess) return err;
  err = allow_smem(ssd_fwd_scan<T, PT>, scan_configured, scan_smem(kMaxQ, kMaxN, PT));
  if (err != cudaSuccess) return err;
  const int n_chunks = (T_len + Q - 1) / Q;
  ssd_fwd_chunk<T, PT><<<dim3((Q + kCBRows - 1) / kCBRows + H * (P / PT), n_chunks, B),
                         kChunkThreads, chunk_smem(Q, round8(N), PT), stream>>>(
      xdt, dA, Bm, Cm, CB, dS, cumx, decay, flags, T_len, H, P, N, Q, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_fwd_scan<T, PT><<<dim3(P / PT, H, n_chunks * B), kScanThreads, scan_smem(Q, N, PT),
                        stream>>>(xdt, Cm, init_state, CB, cumx, dS, decay, carry, flags, y,
                                  state_out, T_len, H, P, N, Q, n_chunks, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xdt, const void* dA, const void* Bm, const void* Cm,
                   const float* init_state, float* CB, float* dS, float* cumx, float* carry,
                   float* decay, int* flags, float* y, float* state_out, int B, int T_len, int H,
                   int P, int N, int Q, int col_tile, const Strides& st, cudaStream_t stream) {
  if (Q < 16 || Q > kMaxQ || Q % 16 || N < 4 || N > kMaxN || N % 4 || col_tile <= 0 ||
      P % col_tile || T_len < 1) {
    return cudaErrorInvalidValue;
  }
  const T* x = static_cast<const T*>(xdt);
  const T* a = static_cast<const T*>(dA);
  const T* bm = static_cast<const T*>(Bm);
  const T* cm = static_cast<const T*>(Cm);
  switch (col_tile) {
    case 16:
      return launch_tile<T, 16>(x, a, bm, cm, init_state, CB, dS, cumx, carry, decay, flags, y,
                                state_out, B, T_len, H, P, N, Q, st, stream);
    case 32:
      return launch_tile<T, 32>(x, a, bm, cm, init_state, CB, dS, cumx, carry, decay, flags, y,
                                state_out, B, T_len, H, P, N, Q, st, stream);
    case 64:
      return launch_tile<T, 64>(x, a, bm, cm, init_state, CB, dS, cumx, carry, decay, flags, y,
                                state_out, B, T_len, H, P, N, Q, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// Scratch (dense): CB (B, chunks, Q, Q), dS and carry (B, chunks, H, N, P),
// cumx (B, chunks, H, 3Q: the cumsum as Q doubles, then exp(cum)) and decay
// (B, chunks, H) fp32, flags (B, chunks, H, P / col_tile) int32, with chunks
// = ceil(T / Q), cumx 8-byte aligned; nothing needs clearing beforehand.
// col_tile (16, 32 or 64, dividing P) is the number of state columns a
// block owns.  strides (in elements): xdt b, t, h; dA b, t, h; Bm b, t; Cm
// b, t.  init_state may be null (a zero state).  dtype: 0 = float32, 1 =
// bfloat16 (xdt, dA, Bm, Cm share it).  Two launches on `stream`.  Returns a
// cudaError_t (0 on success).
extern "C" int ssd_scan_fwd(const void* xdt, const void* dA, const void* Bm, const void* Cm,
                            const void* init_state, void* cb, void* ds, void* cumx, void* carry,
                            void* decay, void* flags, void* y, void* state_out, int B, int T,
                            int H, int P, int N, int Q, int col_tile, long long xs_b,
                            long long xs_t, long long xs_h, long long as_b, long long as_t,
                            long long as_h, long long bs_b, long long bs_t, long long cs_b,
                            long long cs_t, int dtype, void* stream) {
  const repro_torch::Strides st{xs_b, xs_t, xs_h, as_b, as_t, as_h, bs_b, bs_t, cs_b, cs_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s0 = static_cast<const float*>(init_state);
  float* CB = static_cast<float*>(cb);
  float* dS = static_cast<float*>(ds);
  float* cx = static_cast<float*>(cumx);
  float* cr = static_cast<float*>(carry);
  float* dec = static_cast<float*>(decay);
  int* fl = static_cast<int*>(flags);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(state_out);
  if (dtype == 0) {
    return repro_torch::launch<float>(xdt, dA, Bm, Cm, s0, CB, dS, cx, cr, dec, fl, yo, so, B, T,
                                      H, P, N, Q, col_tile, st, s);
  }
  if (dtype == 1) {
    return repro_torch::launch<__nv_bfloat16>(xdt, dA, Bm, Cm, s0, CB, dS, cx, cr, dec, fl, yo,
                                              so, B, T, H, P, N, Q, col_tile, st, s);
  }
  return cudaErrorInvalidValue;
}
