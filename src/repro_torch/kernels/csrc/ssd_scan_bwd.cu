// Gradient of the Mamba2 chunked SSD scan (K3-bwd), sm_90a.
//
// K3 (ssd_scan.cu) replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel), which has no gradient: the JAX package trains through its
// jnp chunked scan (repro/models/layers.py::ssd_chunked_ref), which XLA
// differentiates.  The port trains through K3, so K3 gets this gradient.
// Per chunk c, with cum the inclusive cumsum of dA inside it, S_c the state
// entering it, G_c the gradient of the state leaving it, L[i,j] =
// exp(cum_i − cum_j) for i ≥ j and w_j = exp(cum_last − cum_j):
//   G_{c-1} = exp(cum_last)·G_c + Σ_i exp(cum_i)·C_i ⊗ dy_i   (reverse scan)
//   M       = L ∘ (dy·xdtᵀ)
//   dxdt    = (C·Bᵀ ∘ L)ᵀ·dy + (B ∘ w)·G_c
//   dC_h    = M·B + (dy ∘ exp(cum))·S_cᵀ
//   dB_h    = Mᵀ·C + (xdt ∘ w)·G_cᵀ
//   dcum_i  = C_i·dC_h,i − B_i·dB_h,i, plus ⟨G_c, S_{c+1}⟩ at the last position
//           = Σ_{j<i} (C·Bᵀ ∘ M)_ij − Σ_{k>i} (C·Bᵀ ∘ M)_ki (the diagonal cancels)
//             + C_i·(dy ∘ exp(cum))_i·S_cᵀ − B_i·(xdt ∘ w)_i·G_cᵀ (+ ⟨G_c, S_{c+1}⟩)
//   ddA     = the reverse cumsum of dcum inside the chunk
// and dB, dC are the sums of dB_h, dC_h over the heads.  G_{-1} is the
// initial state's gradient.  The plain version of these passes is
// repro_torch.kernels.ref.ssd_scan_bwd_two_pass.
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
// Bound: operations, about three times K3's forward; fp32 on the CUDA
// cores, register-tiled as K3's forward is (ssd_tile.cuh: 256 threads, each
// 4 rows × 8 columns of a 128 × 64 tile, slices of depth 16 through shared
// memory, the next slice read into registers while one is multiplied).  The
// design is the plain one: right first, fast later.  The two launches with
// products hold two blocks an SM (128 registers; ssd_bwd_grads spills to
// local memory): on an H100, at mamba2_370m's training shape, that took
// 2.90 ms against 3.69 ms with one block an SM at 250 registers.
//
// Design: four launches, none with atomics, so a run gives the same bits
// every time.
// 1. ssd_bwd_chunk, grid (Q/64 + H·P/64, chunks, B): C·Bᵀ once per chunk
//    (it depends on no head) into scratch CB (B, chunks, Q, Q); per (head,
//    64 state columns), the chunk's own ΔG = Σ_i exp(cum_i)·C_i ⊗ dy_i into
//    scratch G (B, chunks, H, N, P), and exp(cum_last) into decay
//    (B, chunks, H).
// 2. ssd_bwd_state, grid (N·P/1024, H, B): the reverse scan over the chunks,
//    in place in G: a thread holds 4 values of the running gradient, and at
//    each chunk, from the last to the first, writes G_c over ΔG_c (read a
//    step ahead) and steps to G_{c-1}; what is left is the initial state's
//    gradient.
// 3. ssd_bwd_grads, grid (H, chunks, B): per (chunk, head) the products
//    above.  M stays in shared memory (Q × Q fp32); dxdt and ddA are
//    written directly, dB_h and dC_h into fp32 partials (B, chunks, H, Q, N).
//    ddA sums many terms of both signs, so dcum is summed in fp64 from fp32
//    products, in its second form: the state parts of dC_h and dB_h are
//    accumulated first and their dcum terms read off before the
//    intra-chunk products join them.
//    The states S_c and S_{c+1} are K3's forward's own (carry, the initial
//    and the final state): kept, not recomputed.
// 4. ssd_bwd_head_sum: dB and dC, the H partials summed in the order
//    h = 0 .. H − 1.
// A ragged last chunk reads zeros past T, as the forward does: dA = 0 and
// xdt = B = C = dy = 0 there, so those positions add nothing anywhere.
#include "ssd_tile.cuh"

#include <math.h>

namespace repro_torch {
namespace {

constexpr int kCPT = 8;                 // columns a thread: tiles of 64
constexpr int kTile = 8 * kCPT;         // columns of an output tile
constexpr int kLDM = kMaxQ + 4;         // row stride of M in shared memory
constexpr int kStateVals = 4;           // values a thread of the state scan
constexpr int kMaxDevices = 16;         // devices whose attributes are cached

// Shared memory of a block of ssd_bwd_grads: cum, dcum, the column sums of
// C·Bᵀ ∘ M and the warps' partial sums (fp64); exp(cum), w, the two operand
// slices and M (fp32).
constexpr int kGradSmem =
    static_cast<int>(sizeof(double)) * (3 * kMaxQ + kThreads / 32) +
    static_cast<int>(sizeof(float)) * (2 * kMaxQ + kKS * kLDA + kKS * kLDB + kMaxQ * kLDM);

__device__ __forceinline__ void zero(float (&acc)[4][kCPT]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < kCPT; ++q) acc[r][q] = 0.f;
  }
}

// acc += A·B over k in [0, depth), A(r, k) for the tile's 128 rows and
// B(k, c) for its 64 columns, staged kKS deep through shared memory; the
// next slice's values are read into registers while this slice is
// multiplied, as in K3's forward.  fa and fb are called for every row and
// column of the tile and must return 0 where there is nothing.
template <class FA, class FB>
__device__ __forceinline__ void gemm(float (&acc)[4][kCPT], float* As, float* Bs, int depth,
                                     FA fa, FB fb) {
  constexpr int kAV = kKS * kRows / kThreads;   // values of A a thread stages
  constexpr int kBV = kKS * kTile / kThreads;   // and of B
  const int tid = threadIdx.x;
  float ra[kAV];
  float rb[kBV];
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < kAV; ++e) {
      const int idx = tid + e * kThreads;
      const int k = k0 + idx % kKS;
      ra[e] = k < depth ? fa(idx / kKS, k) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kBV; ++e) {
      const int idx = tid + e * kThreads;
      const int k = k0 + idx / kTile;
      rb[e] = k < depth ? fb(k, idx % kTile) : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < depth; k0 += kKS) {
    __syncthreads();  // the previous slice is consumed
#pragma unroll
    for (int e = 0; e < kAV; ++e) {
      const int idx = tid + e * kThreads;
      As[(idx % kKS) * kLDA + idx / kKS] = ra[e];
    }
#pragma unroll
    for (int e = 0; e < kBV; ++e) {
      const int idx = tid + e * kThreads;
      Bs[(idx / kTile) * kLDB + idx % kTile] = rb[e];
    }
    __syncthreads();
    if (k0 + kKS < depth) load(k0 + kKS);
    mma_slice<kCPT>(acc, As, Bs, (tid / 8) * 4, tid % 8);
  }
}

// Sum of v over the 8 threads that share a row group (lanes 8g .. 8g + 7).
__device__ __forceinline__ double row_group_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// ---------------------------------------------------------------------------
// 1. per chunk: C·Bᵀ (Q/64 blocks); ΔG and the decay (a block per head and
//    64 state columns)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk(const T* __restrict__ dA, const T* __restrict__ Bm, const T* __restrict__ Cm,
              const float* __restrict__ dy, float* __restrict__ CB, float* __restrict__ G,
              float* __restrict__ decay, int T_len, int H, int P, int N, int Q, Strides st) {
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.y;
  const int t0 = c * Q;
  const int valid = min(Q, T_len - t0);
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int row0 = (tid / 8) * 4;
  const long long bc = static_cast<long long>(b) * n_chunks + c;
  const int n_cb = (Q + kTile - 1) / kTile;
  const int n_pt = (P + kTile - 1) / kTile;

  __shared__ __align__(16) float As[kKS * kLDA];
  __shared__ __align__(16) float Bs[kKS * kLDB];
  __shared__ double cum[kMaxQ];
  __shared__ float ecum[kMaxQ];

  const T* B_b = Bm + b * st.bs_b;
  const T* C_b = Cm + b * st.cs_b;
  float acc[4][kCPT];
  zero(acc);

  if (static_cast<int>(blockIdx.x) < n_cb) {
    // C·Bᵀ: rows i, columns j0 .. j0 + 64
    const int j0 = blockIdx.x * kTile;
    gemm(acc, As, Bs, N,
         [&](int i, int n) { return i < valid ? to_f32(C_b[(t0 + i) * st.cs_t + n]) : 0.f; },
         [&](int n, int j) {
           return j0 + j < valid ? to_f32(B_b[(t0 + j0 + j) * st.bs_t + n]) : 0.f;
         });
    float* cb = CB + bc * Q * Q;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = row0 + r;
      if (i >= Q) continue;
#pragma unroll
      for (int q = 0; q < kCPT; ++q) {
        const int j = j0 + col_of<kCPT>(tx, q);
        if (j < Q) cb[static_cast<long long>(i) * Q + j] = acc[r][q];
      }
    }
    return;
  }

  // ΔG of head h, state columns p0 .. p0 + 64: rows n, depth i
  const int h = (blockIdx.x - n_cb) / n_pt;
  const int p0 = ((blockIdx.x - n_cb) % n_pt) * kTile;
  if (tid < 32) chunk_cumsum(cum, dA + b * st.as_b + h * st.as_h, st.as_t, t0, valid, Q, tid);
  __syncthreads();
  for (int i = tid; i < kMaxQ; i += kThreads) {
    ecum[i] = i < valid ? expf(static_cast<float>(cum[i])) : 0.f;
  }
  if (p0 == 0 && tid == 0) decay[bc * H + h] = expf(static_cast<float>(cum[Q - 1]));
  __syncthreads();  // ecum is written: the product reads it before its first barrier
  const float* dy_bh = dy + (static_cast<long long>(b) * T_len + t0) * H * P + h * P + p0;
  gemm(acc, As, Bs, Q,
       [&](int n, int i) {
         return (n < N && i < valid) ? to_f32(C_b[(t0 + i) * st.cs_t + n]) * ecum[i] : 0.f;
       },
       [&](int i, int p) {
         return (i < valid && p0 + p < P) ? dy_bh[static_cast<long long>(i) * H * P + p] : 0.f;
       });
  float* g = G + (bc * H + h) * N * P + p0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = row0 + r;
    if (n >= N) continue;
#pragma unroll
    for (int q = 0; q < kCPT; ++q) {
      const int p = col_of<kCPT>(tx, q);
      if (p0 + p < P) g[static_cast<long long>(n) * P + p] = acc[r][q];
    }
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
// 3. per (chunk, head): M, dC_h, dB_h, dxdt, dcum and ddA
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_grads(const T* __restrict__ xdt, const T* __restrict__ dA, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const float* __restrict__ dy,
              const float* __restrict__ CB, const float* __restrict__ G,
              const float* __restrict__ carry, const float* __restrict__ init_state,
              const float* __restrict__ final_state, float* __restrict__ dx,
              float* __restrict__ ddA, float* __restrict__ dBp, float* __restrict__ dCp,
              int T_len, int H, int P, int N, int Q, Strides st) {
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.y;
  const int t0 = c * Q;
  const int valid = min(Q, T_len - t0);
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int row0 = (tid / 8) * 4;
  const long long bc = static_cast<long long>(b) * n_chunks + c;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long NP = static_cast<long long>(N) * P;

  extern __shared__ float4 smem4[];
  double* cum = reinterpret_cast<double*>(smem4);         // (kMaxQ,)
  double* dcum = cum + kMaxQ;                             // (kMaxQ,)
  double* dcol = dcum + kMaxQ;                            // (kMaxQ,) column sums
  double* red = dcol + kMaxQ;                             // (kThreads / 32,)
  float* ecum = reinterpret_cast<float*>(red + kThreads / 32);  // (kMaxQ,) exp(cum), 0 past valid
  float* w = ecum + kMaxQ;                                // (kMaxQ,) exp(cum_last − cum)
  float* As = w + kMaxQ;                                  // (kKS, kLDA)
  float* Bs = As + kKS * kLDA;                            // (kKS, kLDB)
  float* M = Bs + kKS * kLDB;                             // (kMaxQ, kLDM)

  // the states around this chunk, from K3's forward, and G_c
  const float* S_in = c == 0 ? (init_state != nullptr ? init_state + bh * NP : nullptr)
                             : carry + ((bc - 1) * H + h) * NP;
  const float* S_out = c == n_chunks - 1 ? final_state + bh * NP : carry + (bc * H + h) * NP;
  const float* Gc = G + (bc * H + h) * NP;

  if (tid < 32) chunk_cumsum(cum, dA + b * st.as_b + h * st.as_h, st.as_t, t0, valid, Q, tid);
  __syncthreads();
  const double cum_last = cum[Q - 1];
  for (int i = tid; i < kMaxQ; i += kThreads) {
    ecum[i] = i < valid ? expf(static_cast<float>(cum[i])) : 0.f;
    w[i] = i < valid ? expf(static_cast<float>(cum_last - cum[i])) : 0.f;
  }
  __syncthreads();  // ecum and w are written

  const T* x_bh = xdt + b * st.xs_b + h * st.xs_h;
  const float* dy_bh = dy + static_cast<long long>(b) * T_len * H * P + h * P;
  const T* B_b = Bm + b * st.bs_b;
  const T* C_b = Cm + b * st.cs_b;
  auto X = [&](int j, int p) {
    return j < valid ? to_f32(x_bh[(t0 + j) * st.xs_t + p]) : 0.f;
  };
  auto DY = [&](int i, int p) {
    return i < valid ? dy_bh[static_cast<long long>(t0 + i) * H * P + p] : 0.f;
  };
  auto Bv = [&](int j, int n) { return j < valid ? to_f32(B_b[(t0 + j) * st.bs_t + n]) : 0.f; };
  auto Cv = [&](int i, int n) { return i < valid ? to_f32(C_b[(t0 + i) * st.cs_t + n]) : 0.f; };
  const float* cb = CB + bc * Q * Q;
  float acc[4][kCPT];

  // M = L ∘ (dy·xdtᵀ): rows i, columns j, depth p
  for (int j0 = 0; j0 < Q; j0 += kTile) {
    zero(acc);
    gemm(acc, As, Bs, P, DY, [&](int p, int j) { return X(j0 + j, p); });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = row0 + r;
#pragma unroll
      for (int q = 0; q < kCPT; ++q) {
        const int j = j0 + col_of<kCPT>(tx, q);
        if (j < kMaxQ) {
          M[i * kLDM + j] =
              (j <= i && i < valid) ? acc[r][q] * expf(static_cast<float>(cum[i] - cum[j])) : 0.f;
        }
      }
    }
  }

  // dcum's intra-chunk terms: row i of C·Bᵀ ∘ M left of the diagonal (the
  // first 128 threads) less column i below it (the other 128)
  __syncthreads();  // M is written
  {
    const int i = tid % kMaxQ;
    double s = 0.0;
    if (tid < kMaxQ) {
      const int end = i < valid ? i : 0;  // rows past the chunk read nothing of C·Bᵀ
      for (int j = 0; j < end; ++j) {
        s += static_cast<double>(cb[static_cast<long long>(i) * Q + j] * M[i * kLDM + j]);
      }
      dcum[i] = s;
    } else {
      for (int k = i + 1; k < valid; ++k) {
        s += static_cast<double>(cb[static_cast<long long>(k) * Q + i] * M[k * kLDM + i]);
      }
      dcol[i] = s;
    }
  }

  // dC_h = (dy ∘ exp(cum))·S_cᵀ + M·B: rows i, columns n; the state part's
  // dcum_i += C_i·(it) first
  for (int n0 = 0; n0 < N; n0 += kTile) {
    zero(acc);
    if (S_in != nullptr) {
      gemm(acc, As, Bs, P, [&](int i, int p) { return DY(i, p) * ecum[i]; },
           [&](int p, int n) { return n0 + n < N ? S_in[(n0 + n) * P + p] : 0.f; });
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = row0 + r;
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < kCPT; ++q) {
          const int n = n0 + col_of<kCPT>(tx, q);
          if (n < N) s += static_cast<double>(Cv(i, n) * acc[r][q]);
        }
        s = row_group_sum(s);
        if (tx == 0 && i < valid) dcum[i] += s;
      }
    }
    gemm(acc, As, Bs, Q, [&](int i, int j) { return M[i * kLDM + j]; },
         [&](int j, int n) { return n0 + n < N ? Bv(j, n0 + n) : 0.f; });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = row0 + r;
      if (i >= valid) continue;
#pragma unroll
      for (int q = 0; q < kCPT; ++q) {
        const int n = n0 + col_of<kCPT>(tx, q);
        if (n < N) dCp[((bc * H + h) * Q + i) * N + n] = acc[r][q];
      }
    }
  }

  // dB_h = (xdt ∘ w)·G_cᵀ + Mᵀ·C: rows j, columns n; the state part's
  // dcum_j −= B_j·(it) first
  for (int n0 = 0; n0 < N; n0 += kTile) {
    zero(acc);
    gemm(acc, As, Bs, P, [&](int j, int p) { return X(j, p) * w[j]; },
         [&](int p, int n) { return n0 + n < N ? Gc[(n0 + n) * P + p] : 0.f; });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = row0 + r;
      double s = 0.0;
#pragma unroll
      for (int q = 0; q < kCPT; ++q) {
        const int n = n0 + col_of<kCPT>(tx, q);
        if (n < N) s += static_cast<double>(Bv(j, n) * acc[r][q]);
      }
      s = row_group_sum(s);
      if (tx == 0 && j < valid) dcum[j] -= s;
    }
    gemm(acc, As, Bs, Q, [&](int j, int i) { return j < Q ? M[i * kLDM + j] : 0.f; },
         [&](int i, int n) { return n0 + n < N ? Cv(i, n0 + n) : 0.f; });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = row0 + r;
      if (j >= valid) continue;
#pragma unroll
      for (int q = 0; q < kCPT; ++q) {
        const int n = n0 + col_of<kCPT>(tx, q);
        if (n < N) dBp[((bc * H + h) * Q + j) * N + n] = acc[r][q];
      }
    }
  }

  // dxdt = (C·Bᵀ ∘ L)ᵀ·dy + (B ∘ w)·G_c: rows j, columns p
  for (int p0 = 0; p0 < P; p0 += kTile) {
    zero(acc);
    gemm(acc, As, Bs, Q,
         [&](int j, int i) {
           return (j <= i && i < valid)
                      ? cb[static_cast<long long>(i) * Q + j] *
                            expf(static_cast<float>(cum[i] - cum[j]))
                      : 0.f;
         },
         [&](int i, int p) { return p0 + p < P ? DY(i, p0 + p) : 0.f; });
    gemm(acc, As, Bs, N, [&](int j, int n) { return Bv(j, n) * w[j]; },
         [&](int n, int p) { return p0 + p < P ? Gc[n * P + p0 + p] : 0.f; });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = row0 + r;
      if (j >= valid) continue;
      float* dxr = dx + ((static_cast<long long>(b) * T_len + t0 + j) * H + h) * P + p0;
#pragma unroll
      for (int q = 0; q < kCPT; ++q) {
        const int p = col_of<kCPT>(tx, q);
        if (p0 + p < P) dxr[p] = acc[r][q];
      }
    }
  }

  // ⟨G_c, S_{c+1}⟩ at the last position, summed in a fixed order
  double part = 0.0;
  for (long long idx = tid; idx < NP; idx += kThreads) {
    part += static_cast<double>(Gc[idx] * S_out[idx]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (tid % 32 == 0) red[tid / 32] = part;
  __syncthreads();  // red, and every dcum term of the rows, are written
  if (tid < valid) {
    dcum[tid] -= dcol[tid];
    if (tid == valid - 1) {
      double total = 0.0;
      for (int k = 0; k < kThreads / 32; ++k) total += red[k];
      dcum[tid] += total;
    }
  }
  __syncthreads();

  // ddA: the reverse cumsum of dcum over the chunk's positions
  for (int k = tid; k < valid; k += kThreads) {
    double s = 0.0;
    for (int i = valid - 1; i >= k; --i) s += dcum[i];
    ddA[(static_cast<long long>(b) * T_len + t0 + k) * H + h] = static_cast<float>(s);
  }
}

// ---------------------------------------------------------------------------
// 4. dB and dC: the heads' partials summed in order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssd_bwd_head_sum(const float* __restrict__ dBp, const float* __restrict__ dCp,
                 float* __restrict__ dB, float* __restrict__ dC, int T_len, int H, int N, int Q,
                 int n_chunks, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % N);
  const int t = static_cast<int>((idx / N) % T_len);
  const long long b = idx / (static_cast<long long>(N) * T_len);
  const long long stride = static_cast<long long>(Q) * N;
  const long long base = ((b * n_chunks + t / Q) * H * Q + t % Q) * N + n;
  float sb = 0.f;
  float sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += dBp[base + h * stride];
    sc += dCp[base + h * stride];
  }
  dB[idx] = sb;
  dC[idx] = sc;
}

template <typename T>
cudaError_t launch(const void* xdt_v, const void* dA_v, const void* Bm_v, const void* Cm_v,
                   const float* dy, const float* carry, const float* init_state,
                   const float* final_state, const float* d_final, float* CB, float* G,
                   float* decay, float* dBp, float* dCp, float* dx, float* ddA, float* dB,
                   float* dC, float* d_init, int B, int T_len, int H, int P, int N, int Q,
                   const Strides& st, cudaStream_t stream) {
  if (Q < kKS || Q > kMaxQ || Q % kKS || N < 4 || N > kMaxN || N % 4 || P < kKS || P % kKS ||
      T_len < 1 || B < 1 || H < 1) {
    return cudaErrorInvalidValue;
  }
  const T* xdt = static_cast<const T*>(xdt_v);
  const T* dA = static_cast<const T*>(dA_v);
  const T* Bm = static_cast<const T*>(Bm_v);
  const T* Cm = static_cast<const T*>(Cm_v);
  const int n_chunks = (T_len + Q - 1) / Q;
  const int n_cb = (Q + kTile - 1) / kTile;
  const int n_pt = (P + kTile - 1) / kTile;
  const int NP = N * P;
  ssd_bwd_chunk<T><<<dim3(n_cb + H * n_pt, n_chunks, B), kThreads, 0, stream>>>(
      dA, Bm, Cm, dy, CB, G, decay, T_len, H, P, N, Q, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_block = kStateVals * kThreads;
  ssd_bwd_state<<<dim3((NP + per_block - 1) / per_block, H, B), kThreads, 0, stream>>>(
      G, decay, d_final, d_init, H, NP, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // raise the dynamic shared-memory limit once per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(ssd_bwd_grads<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGradSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  ssd_bwd_grads<T><<<dim3(H, n_chunks, B), kThreads, kGradSmem, stream>>>(
      xdt, dA, Bm, Cm, dy, CB, G, carry, init_state, final_state, dx, ddA, dBp, dCp, T_len, H,
      P, N, Q, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(B) * T_len * N;
  ssd_bwd_head_sum<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                     stream>>>(dBp, dCp, dB, dC, T_len, H, N, Q, n_chunks, total);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Scratch (dense fp32, nothing needs clearing): CB (B, chunks, Q, Q), G
// (B, chunks, H, N, P), decay (B, chunks, H), dBp and dCp (B, chunks, H, Q,
// N), with chunks = ceil(T / Q).  init_state, d_final and d_init may be
// null (d_init must be null when init_state is).  strides (in elements):
// xdt b, t, h; dA b, t, h; Bm b, t; Cm b, t.  dtype: 0 = float32, 1 =
// bfloat16 (xdt, dA, Bm, Cm share it).  Four launches on `stream`.
// Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_bwd(const void* xdt, const void* dA, const void* Bm, const void* Cm,
                            const void* dy, const void* carry, const void* init_state,
                            const void* final_state, const void* d_final, void* cb, void* g,
                            void* decay, void* dbp, void* dcp, void* dx, void* ddA, void* dB,
                            void* dC, void* d_init, int B, int T, int H, int P, int N, int Q,
                            long long xs_b, long long xs_t, long long xs_h, long long as_b,
                            long long as_t, long long as_h, long long bs_b, long long bs_t,
                            long long cs_b, long long cs_t, int dtype, void* stream) {
  const repro_torch::Strides st{xs_b, xs_t, xs_h, as_b, as_t, as_h, bs_b, bs_t, cs_b, cs_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_dy = static_cast<const float*>(dy);
  const float* f_carry = static_cast<const float*>(carry);
  const float* f_s0 = static_cast<const float*>(init_state);
  const float* f_sT = static_cast<const float*>(final_state);
  const float* f_dT = static_cast<const float*>(d_final);
  float* f_cb = static_cast<float*>(cb);
  float* f_g = static_cast<float*>(g);
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
                                      f_g, f_dec, f_dbp, f_dcp, f_dx, f_da, f_db, f_dc, f_d0, B,
                                      T, H, P, N, Q, st, s);
  }
  if (dtype == 1) {
    return repro_torch::launch<__nv_bfloat16>(xdt, dA, Bm, Cm, f_dy, f_carry, f_s0, f_sT, f_dT,
                                              f_cb, f_g, f_dec, f_dbp, f_dcp, f_dx, f_da, f_db,
                                              f_dc, f_d0, B, T, H, P, N, Q, st, s);
  }
  return cudaErrorInvalidValue;
}
