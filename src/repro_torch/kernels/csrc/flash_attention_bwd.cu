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
// h / G, G = Hq / Hkv.  fp32 or bf16 in and out.
//
// Launches, in order:
//   1. delta = rowsum(do * o), one warp a row;
//   2. dK, dV: one block per (key tile, query head, batch), the key tiles
//      whose walks are longest (the first, under the causal mask) first.  It
//      copies its K and V tile once and walks the query tiles that see it
//      (q_tile_range in repro_torch/kernels/flash_attention.py), their Q, dO,
//      lse and delta coming through a two-stage cp.async ring.  Each warp
//      owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T for them in
//      registers, P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta),
//      then dV += P^T dO and dK += dS^T Q with those as A operands.  At
//      D = 256 two warps share 16 keys, each accumulating half of dK's and
//      dV's columns (the accumulators of all 256 would not fit).  With
//      G = 1 the block writes dK and dV; with G > 1 it writes its head's fp32
//      partial, (B, S, Hq, D) each, to scratch the wrapper allocates, and
//   3. one launch sums each KV head's G partials in the order g = 0..G-1;
//   4. dQ: one block per (64-row query tile, query head, batch), the tiles
//      that see the most keys first, walking the key tiles it sees
//      (kv_tile_range) through a two-stage ring of K and V: dQ += dS K.
// Nothing is added across blocks except by launch 3 in a fixed order, so
// there are no atomics and the gradient is the same bits from run to run.
//
// Products: all five (S, dP, dV, dK, dQ) are mma.sync (mma.cuh).  bf16
// stays bf16 in shared memory and multiplies as m16n8k16, with P and dS
// rounded to bf16 for their products, as FlashAttention-2 does; fp32
// multiplies as 3xTF32 m16n8k8, P and dS split like any other operand, which
// keeps the reference's fp32 arithmetic to 1e-3 of the largest gradient
// entry.  Sums are fp32 throughout.
//
// What bounds it: at the qwen2_5_3b training shape (B=4, T=S=512, 16 query
// and 2 KV heads of 128, causal) the gradient is five products of
// 2 T S_eff D a (batch, head), about 10.7 GFLOP on 75.6 MB in fp32, so the
// arithmetic: 3xTF32 at 495 / 3 TFLOP/s in fp32, bf16 at 989 TFLOP/s (where
// only wgmma reaches the rate).  Tiles per (type, D) are BwdTiles below
// (chosen at D = 128 with scripts/time_fp32_tiles.py); they keep two blocks
// on an SM where the shared memory allows it.  Each k-step loads a row of B
// fragments first and issues its products pass by pass (mma_n2), so that
// 3xTF32's three products into one accumulator do not run back to back.
#include "common.cuh"
#include "mma.cuh"

#include <math.h>

namespace repro_torch {
namespace {

constexpr int kSmemLimit = 232448;   // shared memory a block may have on the H100 (227 KB)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;           // query (dK/dV) or key (dQ) tiles in flight
constexpr int kDqRows = 16 * kWarps; // query rows a dQ block
constexpr float kLog2e = 1.4426950408889634f;

// Tiles per (type, D), mirrored by repro_torch.kernels.flash_attention_bwd.TILES:
// kRows query rows a dK/dV ring stage; kSplit warps sharing 16 keys, each
// with D / kSplit columns of dK and dV; kDqKeys keys a dQ ring stage.
template <int kRows_, int kSplit_, int kDqKeys_>
struct TilesOf {
  static constexpr int kRows = kRows_;
  static constexpr int kSplit = kSplit_;
  static constexpr int kDqKeys = kDqKeys_;
};
template <typename T, int D>
struct BwdTiles;
template <> struct BwdTiles<float, 32> : TilesOf<32, 1, 64> {};
template <> struct BwdTiles<float, 64> : TilesOf<32, 1, 64> {};
template <> struct BwdTiles<float, 128> : TilesOf<16, 1, 16> {};
template <> struct BwdTiles<float, 256> : TilesOf<16, 2, 16> {};
template <> struct BwdTiles<__nv_bfloat16, 32> : TilesOf<32, 1, 64> {};
template <> struct BwdTiles<__nv_bfloat16, 64> : TilesOf<32, 1, 64> {};
template <> struct BwdTiles<__nv_bfloat16, 128> : TilesOf<32, 1, 32> {};
template <> struct BwdTiles<__nv_bfloat16, 256> : TilesOf<32, 2, 32> {};

template <typename T, int D>
struct BwdTile {
  using Tiles = BwdTiles<T, D>;
  static constexpr int kLD = D + Mma<T>::kPad;              // padded row of a tile
  static constexpr int kRows = Tiles::kRows;
  static constexpr int kKeys = 16 * kWarps / Tiles::kSplit; // keys a dK/dV block
  static constexpr int kCols = D / Tiles::kSplit;           // dK/dV columns a warp
  static constexpr int kDqKeys = Tiles::kDqKeys;
  // K and V; the Q and dO ring; the lse and delta ring.  Mirrored by
  // repro_torch.kernels.flash_attention_bwd.smem_bytes.
  static constexpr int kDkdvSmem = (2 * kKeys + 2 * kStages * kRows) * kLD * sizeof(T) +
                                   2 * kStages * kRows * 4;
  // Q and dO; the K and V ring; lse and delta.
  static constexpr int kDqSmem = (2 * kDqRows + 2 * kStages * kDqKeys) * kLD * sizeof(T) +
                                 2 * kDqRows * 4;
  static_assert(kRows % Mma<T>::kK == 0 && kDqKeys % Mma<T>::kK == 0, "tiles of whole k-steps");
  static_assert(kDkdvSmem <= kSmemLimit && kDqSmem <= kSmemLimit,
                "more shared memory than a block may have");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  constexpr int E = Vec16<T>::kElems;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
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
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ dk_part, float* __restrict__ dv_part, int batch,
                      int seq_q, int seq_k, int num_heads, int num_kv_heads, float scale,
                      float scale_log2, int causal, int window, int offset) {
  using C = BwdTile<T, D>;
  using M = Mma<T>;
  constexpr int LD = C::kLD;
  constexpr int BQ = C::kRows;
  constexpr int BK = C::kKeys;
  constexpr int KK = M::kK;
  constexpr int NC = C::kCols / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BK * LD;
  T* Qs = Vs + BK * LD;
  T* dOs = Qs + kStages * BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kStages * BQ * LD);
  float* delta_s = lse_s + kStages * BQ;

  // the block's tile: key tiles in order, the first (longest walk) first
  const int per_tile = num_heads * batch;
  const int kt = static_cast<int>(blockIdx.x) / per_tile;
  const int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int h = rest % num_heads;
  const int b = rest / num_heads;
  const int hk = h / (num_heads / num_kv_heads);
  const int k0 = kt * BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kr = 16 * (warp / C::Tiles::kSplit);   // the warp's first key row in the tile
  const int col0 = (warp % C::Tiles::kSplit) * C::kCols;

  const long long q_rs = static_cast<long long>(num_heads) * D;
  const long long kv_rs = static_cast<long long>(num_kv_heads) * D;
  const T* qb = q + static_cast<long long>(b) * seq_q * q_rs + static_cast<long long>(h) * D;
  const T* dob = dout + static_cast<long long>(b) * seq_q * q_rs + static_cast<long long>(h) * D;
  const long long kv_base = static_cast<long long>(b) * seq_k * kv_rs + static_cast<long long>(hk) * D;
  const float* lseb = lse + static_cast<long long>(b) * seq_q * num_heads + h;
  const float* deltab = delta + static_cast<long long>(b) * seq_q * num_heads + h;

  async_rows<T, D, LD, kThreads>(Ks, k + kv_base + k0 * kv_rs, kv_rs, BK, seq_k - k0, k);
  async_rows<T, D, LD, kThreads>(Vs, v + kv_base + k0 * kv_rs, kv_rs, BK, seq_k - k0, v);

  // the query tiles that see a key of this tile (q_tile_range)
  const int k_last = min(k0 + BK, seq_k) - 1;
  int t_lo = 0;
  int t_hi = seq_q - 1;
  if (causal) {
    t_lo = max(0, k0 - offset);
    if (window > 0) t_hi = min(t_hi, k_last + window - 1 - offset);
  }
  const int qt_first = t_lo / BQ;
  const int n_q = t_lo <= t_hi ? t_hi / BQ + 1 - qt_first : 0;

  auto load_q = [&](int stage, int q0) {
    const int valid = seq_q - q0;
    async_rows<T, D, LD, kThreads>(Qs + stage * BQ * LD, qb + q0 * q_rs, q_rs, BQ, valid, q);
    async_rows<T, D, LD, kThreads>(dOs + stage * BQ * LD, dob + q0 * q_rs, q_rs, BQ, valid, dout);
    async_floats<kThreads>(lse_s + stage * BQ, lseb + static_cast<long long>(q0) * num_heads,
                           num_heads, BQ, valid, lse);
    async_floats<kThreads>(delta_s + stage * BQ, deltab + static_cast<long long>(q0) * num_heads,
                           num_heads, BQ, valid, delta);
  };
  if (n_q > 0) load_q(0, qt_first * BQ);
  cp_async_commit();

  float dk_acc[NC][4];
  float dv_acc[NC][4];
#pragma unroll
  for (int nb = 0; nb < NC; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[nb][e] = 0.f;
      dv_acc[nb][e] = 0.f;
    }

  for (int i = 0; i < n_q; ++i) {
    const int q0 = (qt_first + i) * BQ;
    const int st = i % kStages;
    if (i + 1 < n_q) {
      load_q(st ^ 1, q0 + BQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + st * BQ * LD;
    const T* dOt = dOs + st * BQ * LD;
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
    float sp[BQ / 8][4];
    float dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sp[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll 4
    for (int kk = 0; kk < D / KK; ++kk) {
      const typename M::A ak = M::load_a(Ks + kr * LD + kk * KK, LD, lane);
      const typename M::A av = M::load_a(Vs + kr * LD + kk * KK, LD, lane);
      typename M::B bq[BQ / 8];
      typename M::B bo[BQ / 8];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        bq[j] = M::load_b(Qt + 8 * j * LD + kk * KK, LD, lane);
        bo[j] = M::load_b(dOt + 8 * j * LD + kk * KK, LD, lane);
      }
      mma_n2<T, BQ / 8>(sp, ak, bq, dp, av, bo);
    }

    // P^T and dS^T in place; rows past T arrive as zeros and add nothing
    const bool mask = tile_needs_mask(k0, BK, seq_k, q0 + offset,
                                      min(q0 + BQ, seq_q) - 1 + offset, causal, window);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        const int key = k0 + kr + g + 8 * (e >> 1);
        const float lse2 = lse_t[qi] * kLog2e;
        const bool ok = lse2 != -INFINITY &&
                        (!mask || key_visible(key, q0 + qi + offset, seq_k, causal, window));
        const float p = ok ? fast_exp2(sp[j][e] * scale_log2 - lse2) : 0.f;
        sp[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_t[qi]);
      }

    // dV += P^T dO and dK += dS^T Q over this tile's queries
#pragma unroll
    for (int kk = 0; kk < BQ / KK; ++kk) {
      const typename M::A ap = M::a_from_c(&sp[kk * KK / 8][0]);
      const typename M::A ads = M::a_from_c(&dp[kk * KK / 8][0]);
#pragma unroll
      for (int nb = 0; nb < NC; nb += 2) {
        typename M::B bo[2];
        typename M::B bq[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          bo[i] = M::load_b_t(dOt + kk * KK * LD + col0 + 8 * (nb + i), LD, lane);
          bq[i] = M::load_b_t(Qt + kk * KK * LD + col0 + 8 * (nb + i), LD, lane);
        }
        mma_n2<T, 2>(dv_acc + nb, ap, bo, dk_acc + nb, ads, bq);
      }
    }
    __syncthreads();   // this stage is consumed before it is loaded again
  }
  cp_async_wait<0>();

  // dK = scale dS^T Q (the scores were Q K^T scale); dV as summed
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + g + 8 * r;
    if (key >= seq_k) continue;
    const long long pos = static_cast<long long>(b) * seq_k + key;
    if (dk_part != nullptr) {
      const long long off = (pos * num_heads + h) * D + col0 + 2 * t;
#pragma unroll
      for (int nb = 0; nb < NC; ++nb) {
        store2(dk_part + off + 8 * nb, dk_acc[nb][2 * r] * scale, dk_acc[nb][2 * r + 1] * scale);
        store2(dv_part + off + 8 * nb, dv_acc[nb][2 * r], dv_acc[nb][2 * r + 1]);
      }
    } else {
      const long long off = (pos * num_kv_heads + hk) * D + col0 + 2 * t;
#pragma unroll
      for (int nb = 0; nb < NC; ++nb) {
        store2(dk + off + 8 * nb, dk_acc[nb][2 * r] * scale, dk_acc[nb][2 * r + 1] * scale);
        store2(dv + off + 8 * nb, dv_acc[nb][2 * r], dv_acc[nb][2 * r + 1]);
      }
    }
  }
}

// dK and dV of each KV head: the sum of its G query heads' fp32 partials,
// g = 0..G-1 in order, in the output's type; four values a thread.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                        T* __restrict__ dk, T* __restrict__ dv, long long n4, int D,
                        int num_kv_heads, int group) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n4) return;
  const long long e = 4 * i;
  const int d = static_cast<int>(e % D);
  const long long row = e / D;   // (b * S + s) * Hkv + hk
  const long long base = row * group * D + d;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 sv = sk;
  for (int gi = 0; gi < group; ++gi) {
    const float4 a = *reinterpret_cast<const float4*>(dk_part + base + static_cast<long long>(gi) * D);
    const float4 c = *reinterpret_cast<const float4*>(dv_part + base + static_cast<long long>(gi) * D);
    sk.x += a.x;
    sk.y += a.y;
    sk.z += a.z;
    sk.w += a.w;
    sv.x += c.x;
    sv.y += c.y;
    sv.z += c.z;
    sv.w += c.w;
  }
  store4(dk + e, sk.x, sk.y, sk.z, sk.w);
  store4(dv + e, sv.x, sv.y, sv.z, sv.w);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int batch, int seq_q,
                    int seq_k, int num_heads, int num_kv_heads, int q_tiles, float scale,
                    float scale_log2, int causal, int window, int offset) {
  using C = BwdTile<T, D>;
  using M = Mma<T>;
  constexpr int LD = C::kLD;
  constexpr int BK = C::kDqKeys;
  constexpr int KK = M::kK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kDqRows * LD;
  T* Ks = dOs + kDqRows * LD;
  T* Vs = Ks + kStages * BK * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + kStages * BK * LD);
  float* delta_s = lse_s + kDqRows;

  // the block's tile: the heaviest query tiles (last in T) come first
  const int per_tile = num_heads * batch;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int h = rest % num_heads;
  const int b = rest / num_heads;
  const int hk = h / (num_heads / num_kv_heads);
  const int q0 = qt * kDqRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row0 = 16 * warp + (lane >> 2);   // fragment rows row0 and row0 + 8

  const long long q_rs = static_cast<long long>(num_heads) * D;
  const long long kv_rs = static_cast<long long>(num_kv_heads) * D;
  const long long q_base = (static_cast<long long>(b) * seq_q + q0) * q_rs + static_cast<long long>(h) * D;
  const T* kb = k + static_cast<long long>(b) * seq_k * kv_rs + static_cast<long long>(hk) * D;
  const T* vb = v + static_cast<long long>(b) * seq_k * kv_rs + static_cast<long long>(hk) * D;
  const long long row_base = (static_cast<long long>(b) * seq_q + q0) * num_heads + h;
  const int valid = seq_q - q0;
  async_rows<T, D, LD, kThreads>(Qs, q + q_base, q_rs, kDqRows, valid, q);
  async_rows<T, D, LD, kThreads>(dOs, dout + q_base, q_rs, kDqRows, valid, dout);
  async_floats<kThreads>(lse_s, lse + row_base, num_heads, kDqRows, valid, lse);
  async_floats<kThreads>(delta_s, delta + row_base, num_heads, kDqRows, valid, delta);

  // the key tiles this query tile sees (kv_tile_range)
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + kDqRows, seq_q) - 1 + offset;
  int k_begin = 0;
  int k_end = seq_k;
  if (causal) {
    k_end = min(seq_k, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  const int n_tiles = k_begin < k_end ? (k_end - (k_begin / BK) * BK + BK - 1) / BK : 0;
  k_begin = (k_begin / BK) * BK;

  auto load_kv = [&](int stage, int k0) {
    async_rows<T, D, LD, kThreads>(Ks + stage * BK * LD, kb + k0 * kv_rs, kv_rs, BK, seq_k - k0, k);
    async_rows<T, D, LD, kThreads>(Vs + stage * BK * LD, vb + k0 * kv_rs, kv_rs, BK, seq_k - k0, v);
  };
  if (n_tiles > 0) load_kv(0, k_begin);
  cp_async_commit();

  const int qpos[2] = {q0 + row0 + offset, q0 + row0 + 8 + offset};
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = k_begin + i * BK;
    const int st = i % kStages;
    if (i + 1 < n_tiles) {
      load_kv(st ^ 1, k0 + BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * BK * LD;
    const T* Vt = Vs + st * BK * LD;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float s[BK / 8][4];
    float dp[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = 0.f;
        dp[nb][e] = 0.f;
      }
#pragma unroll 4
    for (int kk = 0; kk < D / KK; ++kk) {
      const typename M::A aq = M::load_a(Qs + 16 * warp * LD + kk * KK, LD, lane);
      const typename M::A ao = M::load_a(dOs + 16 * warp * LD + kk * KK, LD, lane);
      typename M::B bk[BK / 8];
      typename M::B bv[BK / 8];
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
        bk[nb] = M::load_b(Kt + 8 * nb * LD + kk * KK, LD, lane);
        bv[nb] = M::load_b(Vt + 8 * nb * LD + kk * KK, LD, lane);
      }
      mma_n2<T, BK / 8>(s, aq, bk, dp, ao, bv);
    }

    // dS = P (dP - delta) in place of s
    const bool mask = tile_needs_mask(k0, BK, seq_k, q_lo, q_hi, causal, window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lse2 = lse_s[row0 + 8 * r] * kLog2e;
      const float dl = delta_s[row0 + 8 * r];
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = lse2 != -INFINITY &&
                          (!mask || key_visible(k0 + 8 * nb + 2 * t + e, qpos[r], seq_k, causal,
                                                window));
          const float p = ok ? fast_exp2(s[nb][2 * r + e] * scale_log2 - lse2) : 0.f;
          s[nb][2 * r + e] = p * (dp[nb][2 * r + e] - dl);
        }
    }

    // dQ += dS K over this tile's keys
#pragma unroll
    for (int kk = 0; kk < BK / KK; ++kk) {
      const typename M::A a = M::a_from_c(&s[kk * KK / 8][0]);
#pragma unroll
      for (int nb = 0; nb < D / 8; nb += 4) {
        typename M::B b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = M::load_b_t(Kt + kk * KK * LD + 8 * (nb + i), LD, lane);
        mma_n<T, 4>(acc + nb, a, b);
      }
    }
    __syncthreads();   // this stage is consumed before it is loaded again
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + row0 + 8 * r;
    if (pos >= seq_q) continue;
    T* out = dq + (static_cast<long long>(b) * seq_q + pos) * q_rs + static_cast<long long>(h) * D + 2 * t;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      store2(out + 8 * nb, acc[nb][2 * r] * scale, acc[nb][2 * r + 1] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, float* dk_part,
           float* dv_part, int B, int Tq, int Sk, int Hq, int Hkv, float scale, int causal,
           int window, int offset, cudaStream_t stream) {
  using C = BwdTile<T, D>;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const bool partial = Hq != Hkv;
  if (partial && (dk_part == nullptr || dv_part == nullptr)) return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;

  const long long rows = static_cast<long long>(B) * Tq * Hq;
  const long long delta_blocks = (rows + kWarps - 1) / kWarps;
  if (delta_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), dop, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long kv_blocks = static_cast<long long>((Sk + C::kKeys - 1) / C::kKeys) * Hq * B;
  if (kv_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDkdvSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<static_cast<unsigned>(kv_blocks), kThreads, C::kDkdvSmem,
                                stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      partial ? dk_part : nullptr, partial ? dv_part : nullptr, B, Tq, Sk, Hq, Hkv, scale,
      scale_log2, causal, window, offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (partial) {
    const long long n4 = static_cast<long long>(B) * Sk * Hkv * D / 4;
    const long long blocks = (n4 + 255) / 256;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    flash_bwd_reduce_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), n4, D, Hkv, Hq / Hkv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const int q_tiles = (Tq + kDqRows - 1) / kDqRows;
  const long long q_blocks = static_cast<long long>(q_tiles) * Hq * B;
  if (q_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<static_cast<unsigned>(q_blocks), kThreads, C::kDqSmem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), B, Tq, Sk, Hq, Hkv, q_tiles, scale,
      scale_log2, causal, window, offset);
  return cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
             float* dk_part, float* dv_part, int B, int Tq, int Sk, int Hq, int Hkv, float scale,
             int causal, int window, int offset, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, dk_part, dv_part, B, Tq,
                           Sk, Hq, Hkv, scale, causal, window, offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, dk_part, dv_part, B, Tq,
                           Sk, Hq, Hkv, scale, causal, window, offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, dk_part, dv_part, B, Tq,
                            Sk, Hq, Hkv, scale, causal, window, offset, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, dk_part, dv_part, B, Tq,
                            Sk, Hq, Hkv, scale, causal, window, offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// The gradient of K1.  dtype 0 is fp32, 1 bf16; every tensor dense; lse (the
// forward's) and delta (scratch) are (B, T, Hq) fp32; dk_part and dv_part
// are (B, S, Hq, D) fp32 scratch when Hq > Hkv, else null; window <= 0
// means no window; query t sits at key position q_offset + t.  Three
// launches on `stream`, four when Hq > Hkv.  Returns a cudaError_t (0 on
// success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse, void* delta,
                                   void* dq, void* dk, void* dv, void* dk_part, void* dv_part,
                                   int B, int T, int S, int Hq, int Hkv, int D, float scale,
                                   int causal, int window, int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  float* dkp = static_cast<float*>(dk_part);
  float* dvp = static_cast<float*>(dv_part);
  if (dtype == 0)
    return repro_torch::launch_d<float>(D, q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, dkp,
                                        dvp, B, T, S, Hq, Hkv, scale, causal, window, q_offset,
                                        st);
  if (dtype == 1)
    return repro_torch::launch_d<__nv_bfloat16>(D, q, k, v, o, dout, lse_f, delta_f, dq, dk, dv,
                                                dkp, dvp, B, T, S, Hq, Hkv, scale, causal,
                                                window, q_offset, st);
  return cudaErrorInvalidValue;
}
