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
// Bound: operations.  The products run in fp32 on the CUDA cores, to hold
// the plain version to 2e-4.
//
// Design: the chunked-SSD decomposition (Mamba2, arXiv:2405.21060 §6) in two
// launches.  The Pallas kernel carries the state in VMEM along a sequential
// chunk axis of its grid; here every chunk is a block of its own.
// 1. ssd_fwd_chunk, grid (H·P/PT + Q/32, chunks, B), parallel over chunks:
//    - Q/32 blocks a chunk compute C·Bᵀ once (it depends on neither the
//      head nor the state column) over the causal triangle, 32 columns
//      each, and write it, transposed, with Cᵀ below it into fp32 scratch AT
//      (B, chunks, Q + N, Q): the left operand of the second launch;
//    - the other blocks, one per (head, tile of PT state columns), take the
//      chunk's fp64 cumsum of dA and its state contribution
//      ΔS = Bᵀ·(exp(cum_last − cum) ∘ xdt) into scratch dS (B, chunks, H, N,
//      P), and the chunk's decay exp(cum_last) into decay (B, chunks, H);
//      they also clear the chunk's flags (B, chunks, H, P/PT).
// 2. ssd_fwd_scan, grid (P/PT, H, chunks·B), parallel over chunks too, the
//    chunks in launch order: a block takes its chunk's starting state S_prev
//    by a look-back that never waits.  From the chunk before its own it
//    walks back to the nearest one whose flag says that its end state is
//    published in carry (B, chunks, H, N, P), or to the initial state, and
//    adds the ΔS of the chunks in between, each decayed to its own start.
//    It then publishes its own end state decay·S_prev + ΔS (the last chunk's
//    blocks write the final state instead) and computes
//    y = [(C·Bᵀ)ᵀ ∘ L | Cᵀ ∘ exp(cum)]ᵀ · [xdt ; S_prev], one product of
//    depth Q + N.  A walk is as long as the chunks still in flight ahead of
//    it, so the state passing reads O(chunks) values, not O(chunks²).
// Both products are register-tiled: 256 threads, each 4 rows × PT/8 columns
// of a 128-row tile, fed from shared-memory slices of depth 16 that the next
// slice's global loads (held in registers) overlap.  Warps whose rows all lie
// above the causal edge of a slice skip it.  A ragged last chunk (T not a
// multiple of Q) is staged with zeros past T: a masked position has dA = 0
// and xdt = 0, so it multiplies the state by exp(0) = 1 and adds nothing,
// which is exact.
#include "ssd_tile.cuh"

#include <math.h>

namespace repro_torch {
namespace {

constexpr int kCBCols = 32;         // columns of C·Bᵀ a block of the first launch
constexpr int kMaxDevices = 16;     // devices whose attributes are cached

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// ---------------------------------------------------------------------------
// 1. per chunk: C·Bᵀ and Cᵀ (Q/32 blocks), ΔS and the decay (a block per
//    head and column tile)
// ---------------------------------------------------------------------------
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_chunk(const T* __restrict__ xdt, const T* __restrict__ dA, const T* __restrict__ Bm,
              const T* __restrict__ Cm, float* __restrict__ AT, float* __restrict__ dS,
              float* __restrict__ decay, int* __restrict__ flags, int T_len, int H, int P, int N,
              int Q, Strides st) {
  constexpr int PT = 8 * CPT;
  const int n_pt = P / PT;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.y;
  const int t0 = c * Q;
  const int valid = min(Q, T_len - t0);
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int row0 = (tid / 8) * 4;
  const int warp = tid / 32;
  const long long bc = static_cast<long long>(b) * n_chunks + c;

  __shared__ __align__(16) float As[kKS * kLDA];
  __shared__ __align__(16) float Bs[kKS * kLDB];
  __shared__ double cum[kMaxQ];
  __shared__ float w[kMaxQ];

  const T* B_b = Bm + b * st.bs_b;
  const T* C_b = Cm + b * st.cs_b;

  if (blockIdx.x >= H * n_pt) {
    // C·Bᵀ as rows j, columns i0 .. i0 + kCBCols (the causal part j <= i),
    // and those columns of Cᵀ
    const int i0 = (blockIdx.x - H * n_pt) * kCBCols;
    float* at = AT + bc * (Q + N) * Q;
    // thread -> slice row kk = tid % 16 (of n); rows j = tid / 16 + 16u of B
    // and i0 + tid / 16 + 16u of C
    const int kk = tid % kKS;
    const int r16 = tid / kKS;
    constexpr int UB = kRows / 16;
    constexpr int UC = kCBCols / 16;
    float rb[UB];
    float rc[UC];
    auto load = [&](int n0) {
      const bool ok = n0 + kk < N;
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int j = r16 + 16 * u;
        rb[u] = (ok && j < valid) ? to_f32(B_b[(t0 + j) * st.bs_t + n0 + kk]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        const int i = i0 + r16 + 16 * u;
        rc[u] = (ok && i < valid) ? to_f32(C_b[(t0 + i) * st.cs_t + n0 + kk]) : 0.f;
      }
    };
    float acc[4][kCBCols / 8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < kCBCols / 8; ++q) acc[r][q] = 0.f;
    }
    load(0);
    for (int n0 = 0; n0 < N; n0 += kKS) {
      __syncthreads();  // the previous slice is consumed
#pragma unroll
      for (int u = 0; u < UB; ++u) As[kk * kLDA + r16 + 16 * u] = rb[u];
#pragma unroll
      for (int u = 0; u < UC; ++u) Bs[kk * kLDB + r16 + 16 * u] = rc[u];
      __syncthreads();
      if (n0 + kKS < N) load(n0 + kKS);
      for (int idx = tid; idx < kKS * kCBCols; idx += kThreads) {
        const int kr = idx / kCBCols;
        const int ii = idx % kCBCols;
        if (n0 + kr < N && i0 + ii < Q) {
          at[static_cast<long long>(Q + n0 + kr) * Q + i0 + ii] = Bs[kr * kLDB + ii];
        }
      }
      // a warp's rows j = 16w .. 16w+15 meet a causal column i >= j
      if (16 * warp < Q && 16 * warp < i0 + kCBCols) {
        mma_slice<kCBCols / 8>(acc, As, Bs, row0, tx);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = row0 + r;
      if (j >= Q) continue;
#pragma unroll
      for (int q = 0; q < kCBCols / 8; ++q) {
        const int i = i0 + col_of<kCBCols / 8>(tx, q);
        if (i < Q) at[static_cast<long long>(j) * Q + i] = acc[r][q];
      }
    }
    return;
  }

  // ΔS of head h, state columns p0 .. p0 + PT
  const int h = blockIdx.x / n_pt;
  const int p0 = (blockIdx.x % n_pt) * PT;
  if (warp == 0) chunk_cumsum(cum, dA + b * st.as_b + h * st.as_h, st.as_t, t0, valid, Q, tid);
  __syncthreads();
  const double cum_last = cum[Q - 1];
  for (int i = tid; i < Q; i += kThreads) {
    w[i] = i < valid ? expf(static_cast<float>(cum_last - cum[i])) : 0.f;
  }
  if (p0 == 0 && tid == 0) decay[bc * H + h] = expf(static_cast<float>(cum_last));
  if (tid == 0) flags[bc * H * n_pt + blockIdx.x] = 0;  // (head, column tile) = blockIdx.x
  const T* x_bh = xdt + b * st.xs_b + h * st.xs_h + p0;

  // thread -> slice row kk = tid / 16; 8 of its B values, PT / 16 of its xdt
  constexpr int XV = PT / 16;
  const int kk = tid / 16;
  const int cA = (tid % 16) * 8;
  const int cX = (tid % 16) * XV;
  float ra[8];
  float rx[XV];
  auto load = [&](int j0) {
    const int j = j0 + kk;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ra[e] = (j < valid && cA + e < N) ? to_f32(B_b[(t0 + j) * st.bs_t + cA + e]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < XV; ++e) rx[e] = j < valid ? to_f32(x_bh[(t0 + j) * st.xs_t + cX + e]) : 0.f;
  };

  float acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[r][q] = 0.f;
  }
  load(0);
  for (int j0 = 0; j0 < Q; j0 += kKS) {
    __syncthreads();  // the previous slice is consumed (and w is written)
    store4(As + kk * kLDA + cA, ra[0], ra[1], ra[2], ra[3]);
    store4(As + kk * kLDA + cA + 4, ra[4], ra[5], ra[6], ra[7]);
    const float wj = w[j0 + kk];
#pragma unroll
    for (int e = 0; e < XV; ++e) Bs[kk * kLDB + cX + e] = wj * rx[e];
    __syncthreads();
    if (j0 + kKS < Q) load(j0 + kKS);
    mma_slice<CPT>(acc, As, Bs, row0, tx);
  }
  float* ds = dS + ((bc * H + h) * N) * P + p0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = row0 + r;
    if (n >= N) continue;
#pragma unroll
    for (int q = 0; q < CPT; ++q) ds[static_cast<long long>(n) * P + col_of<CPT>(tx, q)] = acc[r][q];
  }
}

// ---------------------------------------------------------------------------
// 2. per (chunk, head, column tile): S_prev by look-back, then y
// ---------------------------------------------------------------------------
__host__ __device__ __forceinline__ int scan_smem_bytes(int N) {
  return static_cast<int>(sizeof(double)) * kMaxQ +
         static_cast<int>(sizeof(float)) * (kMaxQ + kKS * kLDA + kKS * kLDB + round16(N) * kLDB);
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_scan(const T* __restrict__ xdt, const T* __restrict__ dA,
             const float* __restrict__ init_state, const float* __restrict__ AT,
             const float* __restrict__ dS, const float* __restrict__ decay,
             float* __restrict__ carry, int* __restrict__ flags, float* __restrict__ y,
             float* __restrict__ state_out, int T_len, int H, int P, int N, int Q, int n_chunks,
             Strides st) {
  constexpr int PT = 8 * CPT;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int n_batch = gridDim.z / n_chunks;
  const int b = blockIdx.z % n_batch;
  const int c = blockIdx.z / n_batch;  // chunks in launch order
  const long long bc = static_cast<long long>(b) * n_chunks + c;
  const int t0 = c * Q;
  const int valid = min(Q, T_len - t0);
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int row0 = (tid / 8) * 4;
  const int warp = tid / 32;
  const int NS = round16(N);

  extern __shared__ float4 smem4[];
  double* cum = reinterpret_cast<double*>(smem4);           // (kMaxQ,)
  float* ecum = reinterpret_cast<float*>(cum + kMaxQ);      // (kMaxQ,) exp(cum)
  float* As = ecum + kMaxQ;                                 // (kKS, kLDA)
  float* Bs = As + kKS * kLDA;                              // (kKS, kLDB) xdt rows
  float* Ss = Bs + kKS * kLDB;                              // (NS, kLDB) S_prev

  if (warp == 0) chunk_cumsum(cum, dA + b * st.as_b + h * st.as_h, st.as_t, t0, valid, Q, tid);

  // S_prev by look-back: walk from chunk c-1 towards chunk 0 and stop at
  // the first chunk whose end state is published (flag set) or at the
  // initial state; a chunk on the way adds its ΔS and multiplies the
  // factor f by its decay.  A thread owns up to PT / 2 values (n, p) and
  // issues all its loads of a step at once (faster than fewer loads in
  // flight: PERF.md).
  constexpr int kMaxE = kMaxN * PT / kThreads;
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
      const int idx = tid + e * kThreads;
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
    // after it, or the final state
    const float a = decay[bc * H + h];
    const float* d = dS + (bc * H + h) * N * P + p0;
    const bool final_chunk = c == n_chunks - 1;
    float* dst = final_chunk ? state_out + bh * N * P + p0 : carry + (bc * H + h) * N * P + p0;
    float v[kMaxE];
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      const int idx = tid + e * kThreads;
      const int n = idx / PT;
      v[e] = n < N ? d[static_cast<long long>(n) * P + idx % PT] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      const int idx = tid + e * kThreads;
      const int n = idx / PT;
      if (n < N) dst[static_cast<long long>(n) * P + idx % PT] = fmaf(sp[e], a, v[e]);
    }
    if (!final_chunk) {
      __threadfence();
      __syncthreads();  // every value is stored before the flag says so
      if (tid == 0) store_release(flags + (bc * H + h) * n_pt + blockIdx.x, 1);
    }
  }
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    const int idx = tid + e * kThreads;
    if (idx < NS * PT) Ss[(idx / PT) * kLDB + idx % PT] = sp[e];
  }
  __syncthreads();  // cum is written
  for (int i = tid; i < kMaxQ; i += kThreads) {
    ecum[i] = i < Q ? expf(static_cast<float>(cum[i])) : 0.f;
  }

  const float* at = AT + bc * (Q + N) * Q;
  const T* x_bh = xdt + b * st.xs_b + h * st.xs_h + p0;
  const int n_g = Q / kKS;           // slices of the intra-chunk term
  const int n_s = n_g + NS / kKS;    // then those of the state term

  // thread -> slice row kk = tid / 16; 8 values of AT, PT / 16 of xdt
  constexpr int XV = PT / 16;
  const int kk = tid / 16;
  const int cA = (tid % 16) * 8;
  const int cX = (tid % 16) * XV;
  float ra[8];
  float rx[XV];
  auto load = [&](int s) {
    const int row = s * kKS + kk;  // row of AT: j < Q, then Q + n
    if (row < Q + N && cA < Q) {
      const float4 a = *reinterpret_cast<const float4*>(at + static_cast<long long>(row) * Q + cA);
      const float4 d = *reinterpret_cast<const float4*>(at + static_cast<long long>(row) * Q + cA + 4);
      ra[0] = a.x;
      ra[1] = a.y;
      ra[2] = a.z;
      ra[3] = a.w;
      ra[4] = d.x;
      ra[5] = d.y;
      ra[6] = d.z;
      ra[7] = d.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) ra[e] = 0.f;
    }
    if (s < n_g) {
#pragma unroll
      for (int e = 0; e < XV; ++e) {
        rx[e] = row < valid ? to_f32(x_bh[(t0 + row) * st.xs_t + cX + e]) : 0.f;
      }
    }
  };

  float acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[r][q] = 0.f;
  }
  load(0);
  for (int s = 0; s < n_s; ++s) {
    const int k0 = s * kKS;
    __syncthreads();  // the previous slice is consumed (and ecum is written)
    float v[8];
    if (s < n_g) {
      // (C·Bᵀ ∘ L)ᵀ: row j, columns i; the mask goes on the exponent
      const int j = k0 + kk;
      const double cj = cum[j];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = cA + e;
        v[e] = (i < Q && j <= i) ? ra[e] * expf(static_cast<float>(cum[i] - cj)) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < XV; ++e) Bs[kk * kLDB + cX + e] = rx[e];
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = cA + e < kMaxQ ? ra[e] * ecum[cA + e] : 0.f;
    }
    store4(As + kk * kLDA + cA, v[0], v[1], v[2], v[3]);
    store4(As + kk * kLDA + cA + 4, v[4], v[5], v[6], v[7]);
    __syncthreads();
    if (s + 1 < n_s) load(s + 1);
    if (s < n_g) {
      // a warp's rows i = 16w .. 16w+15 see column j only if i >= j
      if (16 * warp + 15 >= k0) mma_slice<CPT>(acc, As, Bs, row0, tx);
    } else {
      mma_slice<CPT>(acc, As, Ss + (k0 - Q) * kLDB, row0, tx);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + r;
    if (i >= valid) continue;
    float* yr = y + ((static_cast<long long>(b) * T_len + t0 + i) * H + h) * P + p0;
#pragma unroll
    for (int q = 0; q < CPT; ++q) yr[col_of<CPT>(tx, q)] = acc[r][q];
  }
}

template <typename T, int CPT>
cudaError_t launch_tile(const T* xdt, const T* dA, const T* Bm, const T* Cm,
                        const float* init_state, float* AT, float* dS, float* carry,
                        float* decay, int* flags, float* y, float* state_out, int B, int T_len,
                        int H, int P, int N, int Q, const Strides& st, cudaStream_t stream) {
  constexpr int PT = 8 * CPT;
  const int n_chunks = (T_len + Q - 1) / Q;
  ssd_fwd_chunk<T, CPT><<<dim3(H * (P / PT) + Q / kCBCols + (Q % kCBCols != 0), n_chunks, B),
                          kThreads, 0, stream>>>(
      xdt, dA, Bm, Cm, AT, dS, decay, flags, T_len, H, P, N, Q, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // raise the kernel's dynamic shared-memory limit once per device, to the
  // most any N needs, rather than on every call
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(ssd_fwd_scan<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               scan_smem_bytes(kMaxN));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const int bytes = scan_smem_bytes(N);
  ssd_fwd_scan<T, CPT><<<dim3(P / PT, H, n_chunks * B), kThreads, bytes, stream>>>(
      xdt, dA, init_state, AT, dS, decay, carry, flags, y, state_out, T_len, H, P, N, Q, n_chunks,
      st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xdt, const void* dA, const void* Bm, const void* Cm,
                   const float* init_state, float* AT, float* dS, float* carry, float* decay,
                   int* flags, float* y, float* state_out, int B, int T_len, int H, int P, int N,
                   int Q, int col_tile, const Strides& st, cudaStream_t stream) {
  if (Q < kKS || Q > kMaxQ || Q % kKS || N < 4 || N > kMaxN || N % 4 || col_tile <= 0 ||
      P % col_tile || T_len < 1) {
    return cudaErrorInvalidValue;
  }
  const T* x = static_cast<const T*>(xdt);
  const T* a = static_cast<const T*>(dA);
  const T* bm = static_cast<const T*>(Bm);
  const T* cm = static_cast<const T*>(Cm);
  switch (col_tile) {
    case 16:
      return launch_tile<T, 2>(x, a, bm, cm, init_state, AT, dS, carry, decay, flags, y,
                               state_out, B, T_len, H, P, N, Q, st, stream);
    case 32:
      return launch_tile<T, 4>(x, a, bm, cm, init_state, AT, dS, carry, decay, flags, y,
                               state_out, B, T_len, H, P, N, Q, st, stream);
    case 64:
      return launch_tile<T, 8>(x, a, bm, cm, init_state, AT, dS, carry, decay, flags, y,
                               state_out, B, T_len, H, P, N, Q, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// Scratch (dense): AT (B, chunks, Q + N, Q), dS and carry (B, chunks, H, N,
// P) and decay (B, chunks, H) fp32, flags (B, chunks, H, P / col_tile)
// int32, with chunks = ceil(T / Q); nothing needs clearing beforehand.
// col_tile (16, 32 or 64, dividing P) is the number of state columns a
// block owns.  strides (in elements): xdt b, t, h; dA b, t, h; Bm b, t; Cm
// b, t.  init_state may be null (a zero state).  dtype: 0 = float32, 1 =
// bfloat16 (xdt, dA, Bm, Cm share it).  Two launches on `stream`.  Returns a
// cudaError_t (0 on success).
extern "C" int ssd_scan_fwd(const void* xdt, const void* dA, const void* Bm, const void* Cm,
                            const void* init_state, void* at, void* ds, void* carry, void* decay,
                            void* flags, void* y, void* state_out, int B, int T, int H, int P,
                            int N, int Q, int col_tile, long long xs_b, long long xs_t,
                            long long xs_h, long long as_b, long long as_t, long long as_h,
                            long long bs_b, long long bs_t, long long cs_b, long long cs_t,
                            int dtype, void* stream) {
  const repro_torch::Strides st{xs_b, xs_t, xs_h, as_b, as_t, as_h, bs_b, bs_t, cs_b, cs_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s0 = static_cast<const float*>(init_state);
  float* AT = static_cast<float*>(at);
  float* dS = static_cast<float*>(ds);
  float* cr = static_cast<float*>(carry);
  float* dec = static_cast<float*>(decay);
  int* fl = static_cast<int*>(flags);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(state_out);
  if (dtype == 0) {
    return repro_torch::launch<float>(xdt, dA, Bm, Cm, s0, AT, dS, cr, dec, fl, yo, so, B, T, H,
                                      P, N, Q, col_tile, st, s);
  }
  if (dtype == 1) {
    return repro_torch::launch<__nv_bfloat16>(xdt, dA, Bm, Cm, s0, AT, dS, cr, dec, fl, yo, so,
                                              B, T, H, P, N, Q, col_tile, st, s);
  }
  return cudaErrorInvalidValue;
}
