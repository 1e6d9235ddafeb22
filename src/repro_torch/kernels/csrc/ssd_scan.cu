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
// Design: the Pallas kernel carries the state in VMEM along a sequential
// chunk axis of its grid.  Here one block of 256 threads owns (b, h, a tile of
// kPT = 16 state columns) and walks the chunks in order, keeping its N × 16
// slice of the state in registers (and a copy in shared memory for the
// y_inter product).  The P columns of the state are independent, so the tile
// splits P: B = 1, H = 32, P = 64 gives 128 blocks on 132 SMs.  Each block
// stages the chunk's B and C (Q × N, fp32) once and computes C·Bᵀ one block of
// 16 rows at a time (16 × Q), skipping the columns past the causal edge, so
// the Q × Q score tile never has to fit at once: at Q = N = 128 a block takes
// 174 KB of dynamic shared memory.  A ragged last chunk (T not a multiple of
// Q) is staged with zeros past T: a masked position has dA = 0 and xdt = 0,
// so it multiplies the state by exp(0) = 1 and adds nothing, which is exact.
//
// Bound: operations.  The products run on the CUDA cores in fp32 (to hold the
// plain version to 2e-4), fed from shared memory with float4 loads; C·Bᵀ is
// recomputed by every (head, column tile) block, four times the work of
// computing it once per chunk.  No tensor cores, no cp.async/TMA pipelining.
#include "common.cuh"

#include <math.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kPT = 16;        // state columns (of P) per block
constexpr int kMaxQ = 128;     // longest chunk
constexpr int kMaxN = 128;     // largest state dimension
constexpr int kRowBlock = 16;  // rows of C·Bᵀ held in shared memory at once
constexpr int kStageUnroll = 8;  // loads in flight per thread while staging

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ __forceinline__ int smem_floats(int Q, int N) {
  const int LDN = N + 4;
  const int LDG = Q + 4;
  return 2 * Q                 // cum (fp64)
         + 2 * Q * LDN         // Cs, Bs
         + 3 * Q * kPT         // Xs, Xw, Ys
         + kRowBlock * LDG     // Gs
         + N * kPT             // Ss
         + Q;                  // ecum
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ xdt, const T* __restrict__ dA, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ init_state,
               float* __restrict__ y, float* __restrict__ state_out, int T_len, int H, int P,
               int N, int Q, long long xs_b, long long xs_t, long long xs_h, long long as_b,
               long long as_t, long long as_h, long long bs_b, long long bs_t, long long cs_b,
               long long cs_t) {
  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int LDN = N + 4;
  const int LDG = Q + 4;
  const int n_rb = Q / kRowBlock;

  extern __shared__ float4 smem4[];
  double* cum = reinterpret_cast<double*>(smem4);  // (Q,) inclusive cumsum of dA
  float* smem = reinterpret_cast<float*>(cum + Q);
  float* Cs = smem;                  // (Q, LDN) the chunk's C rows
  float* Bs = Cs + Q * LDN;          // (Q, LDN) the chunk's B rows
  float* Xs = Bs + Q * LDN;          // (Q, kPT) xdt
  float* Xw = Xs + Q * kPT;          // (Q, kPT) xdt · exp(cum_last − cum)
  float* Ys = Xw + Q * kPT;          // (Q, kPT) y of the chunk
  float* Gs = Ys + Q * kPT;          // (kRowBlock, LDG) rows of (C·Bᵀ ∘ L)
  float* Ss = Gs + kRowBlock * LDG;  // (N, kPT) state slice at the chunk's start
  float* ecum = Ss + N * kPT;        // (Q,) exp(cum)

  // state update mapping: thread -> state row sn, columns sq*8 .. sq*8+7
  const int sn = tid % kMaxN;
  const int sq = tid / kMaxN;
  // y mapping: thread -> rows yr + 16k, column yp
  const int yr = tid / kPT;
  const int yp = tid % kPT;

  const long long state_row =
      ((static_cast<long long>(b) * H + h) * N + sn) * P + p0 + sq * 8;
  float s_reg[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    s_reg[q] = (sn < N && init_state != nullptr) ? init_state[state_row + q] : 0.f;
  }
  if (sn < N) {
#pragma unroll
    for (int q = 0; q < 8; q += 4) {
      store4(Ss + sn * kPT + sq * 8 + q, s_reg[q], s_reg[q + 1], s_reg[q + 2], s_reg[q + 3]);
    }
  }

  const T* xdt_bh = xdt + b * xs_b + h * xs_h + p0;
  const T* dA_bh = dA + b * as_b + h * as_h;
  const T* B_b = Bm + b * bs_b;
  const T* C_b = Cm + b * cs_b;

  const int n_chunks = (T_len + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int valid = min(Q, T_len - t0);
    __syncthreads();  // the previous chunk is done with every tile

    // ---- stage the chunk; rows at or past `valid` are zeros ----
    // kStageUnroll elements of B and of C a thread per round, all loads issued
    // before any store, so that the block keeps many loads in flight
    for (int base = 0; base < Q * N; base += kThreads * kStageUnroll) {
      float bv[kStageUnroll];
      float cv[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int idx = base + u * kThreads + tid;
        const int r = idx / N;
        const int n = idx - r * N;
        bv[u] = 0.f;
        cv[u] = 0.f;
        if (idx < Q * N && r < valid) {
          bv[u] = to_f32(B_b[(t0 + r) * bs_t + n]);
          cv[u] = to_f32(C_b[(t0 + r) * cs_t + n]);
        }
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int idx = base + u * kThreads + tid;
        const int r = idx / N;
        if (idx < Q * N) {
          Bs[r * LDN + idx - r * N] = bv[u];
          Cs[r * LDN + idx - r * N] = cv[u];
        }
      }
    }
    for (int idx = tid; idx < Q * kPT; idx += kThreads) {
      const int r = idx / kPT;
      const int p = idx % kPT;
      Xs[idx] = r < valid ? to_f32(xdt_bh[(t0 + r) * xs_t + p]) : 0.f;
    }
    // inclusive cumsum of dA over the chunk, in fp64: warp 0, up to 4 values
    // a lane
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      double v[4];
      double run = 0.0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lane * per + e;
        if (e < per && r < valid) run += to_f32(dA_bh[(t0 + r) * as_t]);
        v[e] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const double o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const double excl = incl - run;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lane * per + e;
        if (e < per && r < Q) cum[r] = excl + v[e];
      }
    }
    __syncthreads();
    const double cum_last = cum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) ecum[i] = expf(static_cast<float>(cum[i]));
    for (int idx = tid; idx < Q * kPT; idx += kThreads) {
      Xw[idx] = Xs[idx] * expf(static_cast<float>(cum_last - cum[idx / kPT]));
    }

    // ---- y_inter = exp(cum_i) · (C_i · S_prev), for rows yr + 16k ----
    {
      float acc[kMaxQ / kRowBlock];
#pragma unroll
      for (int k = 0; k < kMaxQ / kRowBlock; ++k) acc[k] = 0.f;
      for (int n = 0; n < N; n += 4) {
        const float s0 = Ss[(n + 0) * kPT + yp];
        const float s1 = Ss[(n + 1) * kPT + yp];
        const float s2 = Ss[(n + 2) * kPT + yp];
        const float s3 = Ss[(n + 3) * kPT + yp];
#pragma unroll
        for (int k = 0; k < kMaxQ / kRowBlock; ++k) {
          if (k < n_rb) {
            const float4 cv =
                *reinterpret_cast<const float4*>(Cs + (k * kRowBlock + yr) * LDN + n);
            acc[k] += cv.x * s0 + cv.y * s1 + cv.z * s2 + cv.w * s3;
          }
        }
      }
      __syncthreads();  // ecum is written
#pragma unroll
      for (int k = 0; k < kMaxQ / kRowBlock; ++k) {
        if (k < n_rb) {
          const int i = k * kRowBlock + yr;
          Ys[i * kPT + yp] = acc[k] * ecum[i];
        }
      }
    }

    // ---- y_intra, one block of 16 rows at a time ----
    const int gj = tid % kMaxQ;           // column of C·Bᵀ this thread computes
    const int gr0 = (tid / kMaxQ) * 8;    // its first row within the row block
    for (int rb = 0; rb < n_rb; ++rb) {
      const int i0 = rb * kRowBlock;
      const int jend = i0 + kRowBlock;    // columns past the block's last row are masked
      if (gj < jend) {
        float g[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) g[r] = 0.f;
        const float* brow = Bs + gj * LDN;
        const float* crow = Cs + (i0 + gr0) * LDN;
        for (int n = 0; n < N; n += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(brow + n);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 cv = *reinterpret_cast<const float4*>(crow + r * LDN + n);
            g[r] += cv.x * bv.x + cv.y * bv.y + cv.z * bv.z + cv.w * bv.w;
          }
        }
        const double cj = cum[gj];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + gr0 + r;
          // mask the exponent, not the result
          Gs[(gr0 + r) * LDG + gj] =
              gj <= i ? g[r] * expf(static_cast<float>(cum[i] - cj)) : 0.f;
        }
      }
      __syncthreads();
      {
        // four independent sums, so the FMA chain does not serialise the loop
        const int i = i0 + yr;
        const float* grow = Gs + yr * LDG;
        float s0 = 0.f;
        float s1 = 0.f;
        float s2 = 0.f;
        float s3 = 0.f;
        int j = 0;
        for (; j + 3 <= i; j += 4) {
          const float4 g = *reinterpret_cast<const float4*>(grow + j);
          s0 += g.x * Xs[j * kPT + yp];
          s1 += g.y * Xs[(j + 1) * kPT + yp];
          s2 += g.z * Xs[(j + 2) * kPT + yp];
          s3 += g.w * Xs[(j + 3) * kPT + yp];
        }
        for (; j <= i; ++j) s0 += grow[j] * Xs[j * kPT + yp];
        Ys[i * kPT + yp] += (s0 + s1) + (s2 + s3);
      }
      __syncthreads();
    }

    // ---- write y of the valid rows ----
    for (int idx = tid; idx < valid * kPT; idx += kThreads) {
      const int r = idx / kPT;
      const int p = idx % kPT;
      y[((static_cast<long long>(b) * T_len + t0 + r) * H + h) * P + p0 + p] = Ys[idx];
    }

    // ---- S = exp(cum_last)·S + Bᵀ·Xw ----
    if (sn < N) {
      float upd[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) upd[q] = 0.f;
      for (int j = 0; j < valid; ++j) {
        const float bv = Bs[j * LDN + sn];
        const float4 x0 = *reinterpret_cast<const float4*>(Xw + j * kPT + sq * 8);
        const float4 x1 = *reinterpret_cast<const float4*>(Xw + j * kPT + sq * 8 + 4);
        upd[0] += bv * x0.x;
        upd[1] += bv * x0.y;
        upd[2] += bv * x0.z;
        upd[3] += bv * x0.w;
        upd[4] += bv * x1.x;
        upd[5] += bv * x1.y;
        upd[6] += bv * x1.z;
        upd[7] += bv * x1.w;
      }
      const float decay = expf(static_cast<float>(cum_last));
#pragma unroll
      for (int q = 0; q < 8; ++q) s_reg[q] = s_reg[q] * decay + upd[q];
#pragma unroll
      for (int q = 0; q < 8; q += 4) {
        store4(Ss + sn * kPT + sq * 8 + q, s_reg[q], s_reg[q + 1], s_reg[q + 2], s_reg[q + 3]);
      }
    }
  }

  if (sn < N) {
#pragma unroll
    for (int q = 0; q < 8; ++q) state_out[state_row + q] = s_reg[q];
  }
}

template <typename T>
cudaError_t launch(const void* xdt, const void* dA, const void* Bm, const void* Cm,
                   const float* init_state, float* y, float* state_out, int B, int T_len, int H,
                   int P, int N, int Q, const long long* strides, cudaStream_t stream) {
  if (Q < kRowBlock || Q > kMaxQ || Q % kRowBlock || N < 4 || N > kMaxN || N % 4 || P % kPT) {
    return cudaErrorInvalidValue;
  }
  const int bytes = smem_floats(Q, N) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(P / kPT, H, B);
  ssd_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(dA), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), init_state, y, state_out, T_len, H, P, N, Q, strides[0],
      strides[1], strides[2], strides[3], strides[4], strides[5], strides[6], strides[7],
      strides[8], strides[9]);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// strides (in elements): xdt b, t, h; dA b, t, h; Bm b, t; Cm b, t.
// init_state may be null (a zero state).  dtype: 0 = float32, 1 = bfloat16
// (xdt, dA, Bm, Cm share it).  Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_fwd(const void* xdt, const void* dA, const void* Bm, const void* Cm,
                            const void* init_state, void* y, void* state_out, int B, int T,
                            int H, int P, int N, int Q, long long xs_b, long long xs_t,
                            long long xs_h, long long as_b, long long as_t, long long as_h,
                            long long bs_b, long long bs_t, long long cs_b, long long cs_t,
                            int dtype, void* stream) {
  const long long strides[10] = {xs_b, xs_t, xs_h, as_b, as_t, as_h, bs_b, bs_t, cs_b, cs_t};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s0 = static_cast<const float*>(init_state);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(state_out);
  if (dtype == 0) {
    return repro_torch::launch<float>(xdt, dA, Bm, Cm, s0, yo, so, B, T, H, P, N, Q, strides, st);
  }
  if (dtype == 1) {
    return repro_torch::launch<__nv_bfloat16>(xdt, dA, Bm, Cm, s0, yo, so, B, T, H, P, N, Q,
                                              strides, st);
  }
  return cudaErrorInvalidValue;
}
