// Flash-attention backward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Two TPU kernels of tpunet/ops/flash_attention.py are replaced here:
//   * _flash_dq_kernel (:136, launched by _flash_bwd at :438) by
//     flash_dq_bf16_kernel (bf16, D <= 128) and flash_dq_kernel (f32, and
//     bf16 with D > 128): dQ_i = sum_j dS_ij K_j, one block per
//     (batch*head, q tile), K/V tiles streamed through shared memory with
//     the forward's causal and sliding-window k-loop bounds;
//   * _flash_dkv_kernel (:183, launched at :464) by flash_dkv_bf16_kernel
//     (bf16, D <= 128) and flash_dkv_kernel (f32, and bf16 with D > 128):
//     dV_j = sum_i P_ij^T dO_i, dK_j = sum_i dS_ij^T Q_i, one block per
//     (batch*kv head, k tile), looping over the GQA group's q heads and the
//     q tiles (causal start k0 / BQ, window end
//     min(n_qt, cdiv(k0 + BK - 1 + window, BQ))). The whole group is summed
//     inside the block in f32 and dK/dV are written once: no atomics, and
//     the group and q loops run in a fixed order, so the result is bitwise
//     deterministic run to run. Each dQ block owns its rows and walks its
//     k tiles in order, so dQ is bitwise deterministic too.
// All recompute P = exp(scale * q.k - lse) from the forward's per-row lse
// (B*H, Sq) f32, and take delta = rowsum(dO * O) (B*H, Sq) f32 from the
// wrapper; dS = P * (dP - delta) * scale with dP = dO . V^T, exactly the TPU
// kernels' arithmetic. Masked entries (causal/window) give P = 0 and
// dS = 0; ragged tails (q or k positions past Sq/Sk) are zero in shared
// memory and P = 0 there.
//
// Rows that see no key (causal with a window, qpos >= Sk + window - 1, so
// only when Sq > Sk) follow the JAX reference (attention_reference under
// jax.vjp): their scores are Sk equal NEG_INFs, so P = 1/Sk on every key
// while the mask blocks every gradient through the scores. They add nothing
// to dQ (all their entries are masked) or dK, and each dV row of their kv
// head gains (1/Sk) * sum of their dO over the GQA group: one D-vector per
// (batch, kv head), summed by each dK/dV block in a fixed order (heads, then
// rows) and added to its rows before the store. A launch without such rows
// skips it (a uniform branch).
//
// Layout: q/dO are (B, Sq, H, D) and k/v (B, Sk, Hkv, D), read through
// their batch/sequence/head strides (unit stride in D), GQA through kv head
// h / group, so neither a repeat nor a transpose copy exists. dQ is written
// contiguous (B, Sq, H, D), dK/dV contiguous (B, Sk, Hkv, D), each in its
// input's dtype.
//
// Tensor cores (flash_dq_bf16_kernel, flash_dkv_bf16_kernel). For bf16
// inputs the TPU kernels run Precision.DEFAULT (_dot_precision, :267-272):
// one bf16 MXU pass, so P and dS enter their products rounded to bf16 and
// every product accumulates in f32; here every product is a wgmma with bf16
// operands and f32 accumulators, and P and dS are rounded to bf16 in
// registers. Tiles arrive by TMA into the 128-byte swizzled layout wgmma
// reads (sm90.cuh); one producer warp issues the copies, two consumer
// warpgroups of 64 rows each run the products, and setmaxnreg gives the
// consumers 232 registers (the producer 40).
//
// flash_dq_bf16_kernel. What bounds it: at the training shape (B4 S2048 H16
// D128 causal) dQ is 103 GFLOP (6*D per unmasked pair) against ~34 MB: the
// tensor cores, 0.104 ms at 989 TFLOP/s. The design, for that bound:
//   * one block per (batch*head, 128-row q tile), heaviest causal tile
//     first; Q and dO for the block's rows are loaded once by TMA, each row's
//     lse * log2(e) and delta sit in registers;
//   * K and V tiles of 64 keys stream through a 3-stage TMA ring with the
//     forward's k-loop bounds; only edge tiles apply a mask;
//   * each k tile, each warpgroup: S = Q.K^T and dP = dO.V^T as SS-wgmma
//     (both K-major as stored); P = exp2(S * scale * log2e - lse * log2e)
//     and dS = P (dP - delta) scale on the accumulator fragments, rounded to
//     bf16 A fragments in registers; dQ += dS.K as an RS-wgmma with K read
//     MN-major through the transpose bit (no transposed copy);
//   * the warpgroup pipelines its tiles as the forward does: S_j, dP_j and
//     dQ += dS_(j-1).K_(j-1) are issued together, and dS_j is formed while
//     the tensor cores still work on the dQ product;
//   * dQ (64 x D f32 a warpgroup) stays in registers and is stored once as
//     bf16; ragged rows are never written.
//
// flash_dkv_bf16_kernel. What bounds it: at the training shape dK/dV is 137
// GFLOP (8*D per unmasked pair) against ~50 MB: the tensor cores, 0.139 ms
// at 989 TFLOP/s. The design, for that bound:
//   * one block per (batch*kv head, 128-row k tile); two consumer
//     warpgroups own 64 k rows each, and their K and V rows stay in shared
//     memory for the whole block; dK and dV (64 x D f32 each a warpgroup)
//     stay in registers;
//   * Q and dO tiles of 64 rows stream through a 2-stage ring by TMA, with
//     the tile's lse * log2(e) and delta stored beside them by the producer
//     warp;
//   * the block works on the transposed scores, so that every product
//     reads its operands as stored: S^T = K.Q^T and dP^T = V.dO^T are
//     SS-wgmma (both K-major), P^T and dS^T are formed on the accumulator
//     fragments, and dV += P^T.dO and dK += dS^T.Q are RS-wgmma with P^T
//     and dS^T as bf16 register A fragments and dO and Q read MN-major
//     through the transpose bit.
// bf16 with 128 < D <= 256 keeps the CUDA-core kernels (explicit branches
// in dispatch): a 64 x D f32 dK plus dV no longer fit a warpgroup's
// registers, and dQ's 128 f32 a thread plus S and dP leave no room.
//
// flash_dq_kernel and flash_dkv_kernel run on the CUDA cores: inputs become
// f32 on their way into shared memory and every product is an f32 FMA (no
// TF32), the counterpart of Precision.HIGHEST for f32 inputs; bf16 with
// D > 128 accumulates in f32 as well. 256-thread blocks (32 row groups x 8
// column lanes) with register tiles of RPT rows x CPT score columns and
// RPT x D/8 output columns per thread, so each shared-memory load feeds
// several FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;  // 32 row groups x 8 column lanes

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hkv, Sq, Sk, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  int causal;
  int window;  // 0 = no window
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// True when query qpos attends key kpos (both in range).
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  if (!p.causal) return true;
  bool keep = qpos >= kpos;
  if (p.window > 0) keep = keep && (qpos - kpos) < p.window;
  return keep;
}

// The first query position that sees no key (causal with a window), or Sq
// when every row sees one.
__device__ __forceinline__ int first_no_key_row(int causal, int window,
                                                int Sq, int Sk) {
  return causal && window > 0 ? min(Sq, Sk + window - 1) : Sq;
}

// Column d of the dV term of the rows that see no key: (1/Sk) * the sum of
// dO over the GQA group's heads h0..h0+group-1 and rows q_first..Sq-1, in
// f32, heads then rows in order, so every block gets the same bits.
template <typename T>
__device__ float no_key_dv(const T* dout, long long sb, long long ss,
                           long long sh, int b, int h0, int group,
                           int q_first, int Sq, int Sk, int d) {
  float u = 0.f;
  for (int g = 0; g < group; ++g) {
    const T* col = dout + b * sb + (h0 + g) * sh + d;
#pragma unroll 4
    for (int qpos = q_first; qpos < Sq; ++qpos) u += load_f32(col + qpos * ss);
  }
  return u / Sk;
}

// ---------------------------------------------------------------- dQ ----

template <int DMAX, int BQ, int BK>
struct DqSmem {
  static constexpr int kRowStride = DMAX + 1;  // sQ / sdO rows
  static constexpr int kTStride = BK + 1;      // sKt / sVt rows (transposed)
  static constexpr int kSStride = BK + 8;      // sdS rows
  static constexpr int kQ = BQ * kRowStride;
  static constexpr int kKt = DMAX * kTStride;
  static constexpr int kS = BQ * kSStride;
  static constexpr size_t kBytes = sizeof(float) * (2 * kQ + 2 * kKt + kS);
};

template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const Params p) {
  constexpr int RPT = BQ / 32;   // q rows per thread
  constexpr int CPT = BK / 8;    // score columns per thread
  constexpr int DPT = DMAX / 8;  // dQ columns per thread
  using S = DqSmem<DMAX, BQ, BK>;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + S::kQ;
  float* sKt = sdO + S::kQ;
  float* sVt = sKt + S::kKt;
  float* sdS = sVt + S::kKt;

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int D = p.D;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int qpos = q0 + r;
    const bool ok = qpos < p.Sq;
    sQ[r * S::kRowStride + d] = ok ? load_f32(qg + qpos * p.q_ss + d) : 0.f;
    sdO[r * S::kRowStride + d] = ok ? load_f32(dog + qpos * p.do_ss + d) : 0.f;
  }
  float lse[RPT], delta[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 32 * i;
    const bool ok = qpos < p.Sq;
    lse[i] = ok ? p.lse[(long long)bh * p.Sq + qpos] : 0.f;
    delta[i] = ok ? p.delta[(long long)bh * p.Sq + qpos] : 0.f;
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  // The forward's k-loop bounds.
  const int n_kt = (p.Sk + BK - 1) / BK;
  int kt_end = n_kt;
  if (p.causal) kt_end = min(n_kt, (q0 + BQ + BK - 1) / BK);
  int kt_start = 0;
  if (p.causal && p.window > 0) kt_start = max(q0 - (p.window - 1), 0) / BK;

  for (int kt = kt_start; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers are done with sKt/sVt/sdS
    for (int e = tid; e < BK * D; e += kThreads) {
      const int c = e / D, d = e - c * D;
      const int kpos = k0 + c;
      const bool ok = kpos < p.Sk;
      sKt[d * S::kTStride + c] = ok ? load_f32(kg + kpos * p.k_ss + d) : 0.f;
      sVt[d * S::kTStride + c] = ok ? load_f32(vg + kpos * p.v_ss + d) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = sQ[(ty + 32 * i) * S::kRowStride + d];
        ov[i] = sdO[(ty + 32 * i) * S::kRowStride + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = sKt[d * S::kTStride + tx + 8 * j];
        vv[j] = sVt[d * S::kTStride + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 32 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 8 * j;
        const int kpos = k0 + c;
        float pr = 0.f;
        if (qpos < p.Sq && kpos < p.Sk && visible(p, qpos, kpos)) {
          pr = expf(p.scale * s[i][j] - lse[i]);
        }
        sdS[r * S::kSStride + c] = pr * (dp[i][j] - delta[i]) * p.scale;
      }
    }
    __syncthreads();

    const int c_end = min(BK, p.Sk - k0);
#pragma unroll 2
    for (int c = 0; c < c_end; ++c) {
      float ds[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) ds[i] = sdS[(ty + 32 * i) * S::kSStride + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float kv = sKt[(tx + 8 * j) * S::kTStride + c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

  // dQ is contiguous (B, Sq, H, D).
  T* dqg = static_cast<T*>(p.dq) + ((long long)b * p.Sq * p.H + h) * D;
  const long long dq_ss = (long long)p.H * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 32 * i;
    if (qpos >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 8 * j;
      if (d < D) store_from_f32(dqg + qpos * dq_ss + d, acc[i][j]);
    }
  }
}

// -------------------------------------------------------------- dK/dV ----

template <int DMAX, int BK, int BQ>
struct DkvSmem {
  static constexpr int kRowStride = DMAX + 1;  // sK / sV rows
  static constexpr int kTStride = BQ + 1;      // sQt / sdOt rows (transposed)
  static constexpr int kPStride = BQ + 8;      // sP / sdS rows
  static constexpr int kK = BK * kRowStride;
  static constexpr int kQt = DMAX * kTStride;
  static constexpr int kP = BK * kPStride;
  static constexpr size_t kBytes =  // ..., lse, delta, the no-key dV term
      sizeof(float) * (2 * kK + 2 * kQt + 2 * kP + 2 * BQ + DMAX);
};

template <typename T, int DMAX, int BK, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const Params p) {
  constexpr int RPT = BK / 32;   // k rows per thread
  constexpr int CPT = BQ / 8;    // score (q) columns per thread
  constexpr int DPT = DMAX / 8;  // dK/dV columns per thread
  using S = DkvSmem<DMAX, BK, BQ>;

  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + S::kK;
  float* sQt = sV + S::kK;
  float* sdOt = sQt + S::kQt;
  float* sP = sdOt + S::kQt;
  float* sdS = sP + S::kP;
  float* sLse = sdS + S::kP;
  float* sDelta = sLse + BQ;
  float* sU = sDelta + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int D = p.D;
  const int k0 = blockIdx.x * BK;
  const int bkv = blockIdx.y;
  const int b = bkv / p.Hkv;
  const int hk = bkv % p.Hkv;
  const int group = p.H / p.Hkv;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  for (int e = tid; e < BK * D; e += kThreads) {
    const int c = e / D, d = e - c * D;
    const int kpos = k0 + c;
    const bool ok = kpos < p.Sk;
    sK[c * S::kRowStride + d] = ok ? load_f32(kg + kpos * p.k_ss + d) : 0.f;
    sV[c * S::kRowStride + d] = ok ? load_f32(vg + kpos * p.v_ss + d) : 0.f;
  }

  float dk[RPT][DPT], dv[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  // The TPU kernel's q-loop bounds: the first q tile holding a row that sees
  // key k0 (causal), and the last one whose newest row still sees the
  // tile's oldest key (window).
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int it_start = p.causal ? k0 / BQ : 0;
  int it_end = n_qt;
  if (p.causal && p.window > 0) {
    it_end = min(n_qt, (k0 + BK - 1 + p.window + BQ - 1) / BQ);
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long bh = (long long)b * p.H + h;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int it = it_start; it < it_end; ++it) {
      const int q0 = it * BQ;
      __syncthreads();  // previous tile's readers are done with sQt..sDelta
      for (int e = tid; e < BQ * D; e += kThreads) {
        const int r = e / D, d = e - r * D;
        const int qpos = q0 + r;
        const bool ok = qpos < p.Sq;
        sQt[d * S::kTStride + r] = ok ? load_f32(qg + qpos * p.q_ss + d) : 0.f;
        sdOt[d * S::kTStride + r] =
            ok ? load_f32(dog + qpos * p.do_ss + d) : 0.f;
      }
      for (int r = tid; r < BQ; r += kThreads) {
        const int qpos = q0 + r;
        const bool ok = qpos < p.Sq;
        sLse[r] = ok ? p.lse[bh * p.Sq + qpos] : 0.f;
        sDelta[r] = ok ? p.delta[bh * p.Sq + qpos] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this thread's RPT k rows.
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv[i] = sK[(ty + 32 * i) * S::kRowStride + d];
          vv[i] = sV[(ty + 32 * i) * S::kRowStride + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qv[j] = sQt[d * S::kTStride + tx + 8 * j];
          ov[j] = sdOt[d * S::kTStride + tx + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int c = ty + 32 * i;
        const int kpos = k0 + c;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int r = tx + 8 * j;
          const int qpos = q0 + r;
          float pr = 0.f;
          if (qpos < p.Sq && kpos < p.Sk && visible(p, qpos, kpos)) {
            pr = expf(p.scale * s[i][j] - sLse[r]);
          }
          sP[c * S::kPStride + r] = pr;
          sdS[c * S::kPStride + r] = pr * (dp[i][j] - sDelta[r]) * p.scale;
        }
      }
      __syncthreads();

      const int r_end = min(BQ, p.Sq - q0);
#pragma unroll 2
      for (int r = 0; r < r_end; ++r) {
        float pr[RPT], ds[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pr[i] = sP[(ty + 32 * i) * S::kPStride + r];
          ds[i] = sdS[(ty + 32 * i) * S::kPStride + r];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float ov = sdOt[(tx + 8 * j) * S::kTStride + r];
          const float qv = sQt[(tx + 8 * j) * S::kTStride + r];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            dv[i][j] = fmaf(pr[i], ov, dv[i][j]);
            dk[i][j] = fmaf(ds[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

  const int q_first = first_no_key_row(p.causal, p.window, p.Sq, p.Sk);
  if (q_first < p.Sq) {  // rows that see no key: dV += their dO / Sk
    for (int d = tid; d < D; d += kThreads) {
      sU[d] = no_key_dv(static_cast<const T*>(p.dout), p.do_sb, p.do_ss,
                        p.do_sh, b, hk * group, group, q_first, p.Sq, p.Sk,
                        d);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        if (tx + 8 * j < D) dv[i][j] += sU[tx + 8 * j];
  }

  // dK/dV are contiguous (B, Sk, Hkv, D).
  const long long base = ((long long)b * p.Sk * p.Hkv + hk) * D;
  const long long kv_ss = (long long)p.Hkv * D;
  T* dkg = static_cast<T*>(p.dk) + base;
  T* dvg = static_cast<T*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kpos = k0 + ty + 32 * i;
    if (kpos >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 8 * j;
      if (d < D) {
        store_from_f32(dkg + kpos * kv_ss + d, dk[i][j]);
        store_from_f32(dvg + kpos * kv_ss + d, dv[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------- launch ----

template <typename T, int DMAX, int BQ, int BK>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  auto kernel = flash_dq_kernel<T, DMAX, BQ, BK>;
  const size_t bytes = DqSmem<DMAX, BQ, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DMAX, int BK, int BQ>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  auto kernel = flash_dkv_kernel<T, DMAX, BK, BQ>;
  const size_t bytes = DkvSmem<DMAX, BK, BQ>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sk + BK - 1) / BK, p.B * p.Hkv);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}


// ------------------------------------------- dK/dV, bf16, tensor cores ----

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWgThreads = 384;  // 2 consumer warpgroups + 1 producer

struct DkvArgs {
  CUtensorMap tq, tk, tv, tdo;
  const float* lse;
  const float* delta;
  const __nv_bfloat16* dout;  // the no-key dV term reads it directly
  long long do_sb, do_ss, do_sh;
  void* dk;
  void* dv;
  int H, Hkv, Sq, Sk, D;
  int causal;
  int window;
  float scale;
  float scale_log2;
};

template <int DT>
struct DkvTile {
  static constexpr int kBK = 128;  // k rows: 2 consumer warpgroups x 64
  static constexpr int kBQ = 64;   // q rows a step
  static constexpr int kStages = 2;
  static constexpr int kKBytes = kBK * DT * 2;  // K (or V), resident
  static constexpr int kQBytes = kBQ * DT * 2;  // Q (or dO), one stage
  static constexpr int kTiles = 2 * kKBytes + kStages * 2 * kQBytes;
  static constexpr int kRows = kStages * 2 * kBQ * 4;  // lse, delta
  static constexpr int kBars = 8 * (2 * kStages + 1);
  static constexpr size_t kSmem =  // slack, tiles, rows, barriers, dV term
      1024 + kTiles + kRows + kBars + 4 * DT;
};

template <int DT>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_bf16_kernel(const __grid_constant__ DkvArgs a) {
  using Tile = DkvTile<DT>;
  constexpr int BK = Tile::kBK, BQ = Tile::kBQ, NS = Tile::kStages;
  constexpr int NC = DT / 64;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = base;
  uint8_t* sV = base + Tile::kKBytes;
  uint8_t* sQO = base + 2 * Tile::kKBytes;  // stage s: Q, then dO
  float* sRows = reinterpret_cast<float*>(base + Tile::kTiles);
  uint64_t* kvbar =
      reinterpret_cast<uint64_t*>(base + Tile::kTiles + Tile::kRows);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + NS;
  float* sU = reinterpret_cast<float*>(base + Tile::kTiles + Tile::kRows +
                                       Tile::kBars);

  const int bkv = blockIdx.x;
  const int b = bkv / a.Hkv;
  const int hk = bkv % a.Hkv;
  const int group = a.H / a.Hkv;
  const int k0 = blockIdx.y * BK;

  // The TPU kernel's q-loop bounds: the first q tile holding a row that
  // sees key k0 (causal), and the last one whose newest row still sees the
  // tile's oldest key (window).
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int it_start = a.causal ? k0 / BQ : 0;
  int it_end = n_qt;
  if (a.causal && a.window > 0) {
    it_end = min(n_qt, (k0 + BK - 1 + a.window + BQ - 1) / BQ);
  }
  const int n_q = max(it_end - it_start, 0);
  const int total = group * n_q;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kvbar, 1);
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&full[s], 33);  // TMA bytes + the producer's 32 lanes
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: warp 8 loads
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kvbar, 2 * Tile::kKBytes);
        for (int c = 0; c < NC; ++c) {
          sm90::tma_load_4d(sK + c * BK * 128, &a.tk, kvbar, c * 64, k0, hk,
                            b);
          sm90::tma_load_4d(sV + c * BK * 128, &a.tv, kvbar, c * 64, k0, hk,
                            b);
        }
      }
      for (int it = 0; it < total; ++it) {
        const int g = it / n_q;
        const int h = hk * group + g;
        const int q0 = (it_start + it - g * n_q) * BQ;
        const int s = it % NS;
        sm90::mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
        uint8_t* sq = sQO + s * 2 * Tile::kQBytes;
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[s], 2 * Tile::kQBytes);
          for (int c = 0; c < NC; ++c) {
            sm90::tma_load_4d(sq + c * BQ * 128, &a.tq, &full[s], c * 64, q0,
                              h, b);
            sm90::tma_load_4d(sq + Tile::kQBytes + c * BQ * 128, &a.tdo,
                              &full[s], c * 64, q0, h, b);
          }
        }
        const long long row0 = ((long long)b * a.H + h) * a.Sq;
        float* rows = sRows + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int qpos = q0 + r;
          const bool ok = qpos < a.Sq;
          rows[r] = ok ? a.lse[row0 + qpos] * kLog2e : 0.f;
          rows[BQ + r] = ok ? a.delta[row0 + qpos] : 0.f;
        }
        sm90::mbar_arrive(&full[s]);
      }
    }
  } else {  // consumer warpgroups: 64 k rows each
    sm90::setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int kw0 = k0 + wg * 64;                  // the warpgroup's rows
    const int kr = kw0 + warp * 16 + (lane >> 2);  // rows kr, kr + 8
    const int cq = 2 * (lane & 3);                 // column in an 8-group
    const uint32_t k_addr = sm90::smem_u32(sK) + wg * 64 * 128;
    const uint32_t v_addr = sm90::smem_u32(sV) + wg * 64 * 128;

    float dk[DT / 2], dv[DT / 2];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(kvbar, 0);
    for (int it = 0; it < total; ++it) {
      const int g = it / n_q;
      const int q0 = (it_start + it - g * n_q) * BQ;
      const int s = it % NS;
      const uint32_t q_addr =
          sm90::smem_u32(sQO) + s * 2 * Tile::kQBytes;
      const uint32_t o_addr = q_addr + Tile::kQBytes;
      sm90::mbar_wait(&full[s], (it / NS) & 1);

      // S^T = K.Q^T and dP^T = V.dO^T, 64 k rows x BQ q columns.
      float st[BQ / 2], dpt[BQ / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        sm90::wgmma_ss(
            st, sm90::desc_sw128(k_addr + (kk >> 2) * BK * 128 + off, 16, 1024),
            sm90::desc_sw128(q_addr + (kk >> 2) * BQ * 128 + off, 16, 1024),
            kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        sm90::wgmma_ss(
            dpt, sm90::desc_sw128(v_addr + (kk >> 2) * BK * 128 + off, 16, 1024),
            sm90::desc_sw128(o_addr + (kk >> 2) * BQ * 128 + off, 16, 1024),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // P^T = exp(scale * S^T - lse) and dS^T = P^T (dP^T - delta) scale.
      const float* rows = sRows + s * 2 * BQ;
      const bool need_mask =
          q0 + BQ > a.Sq ||
          (a.causal && (q0 < kw0 + 63 ||
                        (a.window > 0 && q0 + BQ - 1 - kw0 >= a.window)));
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 8 * (i >> 2) + cq + (i & 1);
        float pv = sm90::ex2(fmaf(st[i], a.scale_log2, -rows[c]));
        if (need_mask) {
          const int qpos = q0 + c;
          const int kpos = kr + 8 * ((i >> 1) & 1);
          if (qpos >= a.Sq ||
              (a.causal && (qpos < kpos ||
                            (a.window > 0 && qpos - kpos >= a.window)))) {
            pv = 0.f;
          }
        }
        st[i] = pv;
        dpt[i] = pv * (dpt[i] - rows[BQ + c]) * a.scale;
      }

      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      sm90::to_a_frags(st, pa);
      sm90::to_a_frags(dpt, da);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        sm90::wgmma_rs(dv, pa[kk],
                       sm90::desc_sw128(o_addr + kk * 2048, BQ * 128, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        sm90::wgmma_rs(dk, da[kk],
                       sm90::desc_sw128(q_addr + kk * 2048, BQ * 128, 1024));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::fence_regs(pa);
      sm90::fence_regs(da);
      sm90::mbar_arrive(&empty[s]);
    }

    const int q_first = first_no_key_row(a.causal, a.window, a.Sq, a.Sk);
    if (q_first < a.Sq) {  // rows that see no key: dV += their dO / Sk
      if (threadIdx.x < a.D) {
        sU[threadIdx.x] =
            no_key_dv(a.dout, a.do_sb, a.do_ss, a.do_sh, b, hk * group,
                      group, q_first, a.Sq, a.Sk, threadIdx.x);
      }
      sm90::bar_sync<1, 256>();  // the consumers only
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < a.D) {
#pragma unroll
          for (int i = 0; i < 4; ++i) dv[4 * j + i] += sU[col + (i & 1)];
        }
      }
    }

    // dK/dV are contiguous (B, Sk, Hkv, D).
    __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk);
    __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = kr + 8 * r;
      if (kpos >= a.Sk) continue;
      const long long row = (((long long)b * a.Sk + kpos) * a.Hkv + hk) * a.D;
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < a.D) {
          *reinterpret_cast<__nv_bfloat162*>(dkg + row + col) =
              __floats2bfloat162_rn(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dvg + row + col) =
              __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <int DT>
cudaError_t launch_dkv_bf16(const Params& p, cudaStream_t stream) {
  using Tile = DkvTile<DT>;
  DkvArgs a;
  if (!sm90_host::bf16_bshd_map(&a.tq, p.q, p.B, p.Sq, p.H, p.D, p.q_sb,
                                p.q_ss, p.q_sh, Tile::kBQ) ||
      !sm90_host::bf16_bshd_map(&a.tdo, p.dout, p.B, p.Sq, p.H, p.D, p.do_sb,
                                p.do_ss, p.do_sh, Tile::kBQ) ||
      !sm90_host::bf16_bshd_map(&a.tk, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb,
                                p.k_ss, p.k_sh, Tile::kBK) ||
      !sm90_host::bf16_bshd_map(&a.tv, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb,
                                p.v_ss, p.v_sh, Tile::kBK)) {
    return cudaErrorInvalidValue;
  }
  a.lse = p.lse;
  a.delta = p.delta;
  a.dout = static_cast<const __nv_bfloat16*>(p.dout);
  a.do_sb = p.do_sb;
  a.do_ss = p.do_ss;
  a.do_sh = p.do_sh;
  a.dk = p.dk;
  a.dv = p.dv;
  a.H = p.H;
  a.Hkv = p.Hkv;
  a.Sq = p.Sq;
  a.Sk = p.Sk;
  a.D = p.D;
  a.causal = p.causal;
  a.window = p.window;
  a.scale = p.scale;
  a.scale_log2 = p.scale * kLog2e;
  auto kernel = flash_dkv_bf16_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.Hkv, (p.Sk + Tile::kBK - 1) / Tile::kBK);
  kernel<<<grid, kWgThreads, Tile::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------- dQ, bf16, tensor cores ----

struct DqArgs {
  CUtensorMap tq, tk, tv, tdo;
  const float* lse;
  const float* delta;
  void* dq;
  int H, Hkv, Sq, Sk, D;
  int causal;
  int window;
  float scale;
  float scale_log2;
};

template <int DT>
struct DqTile {
  static constexpr int kBQ = 128;  // q rows: 2 consumer warpgroups x 64
  static constexpr int kBK = 64;   // keys a step
  // The pipelined consumers hold two stages at a time (K_it and K_(it-1)),
  // so a third lets the next load run ahead.
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kBQ * DT * 2;   // Q (or dO), resident
  static constexpr int kKVBytes = kBK * DT * 2;  // one K (or V) tile
  static constexpr int kTiles = 2 * kQBytes + kStages * 2 * kKVBytes;
  static constexpr size_t kSmem =  // alignment slack, tiles, barriers
      1024 + kTiles + 8 * (2 * kStages + 1);
};

template <int DT>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq_bf16_kernel(const __grid_constant__ DqArgs a) {
  using Tile = DqTile<DT>;
  constexpr int BQ = Tile::kBQ, BK = Tile::kBK, NS = Tile::kStages;
  constexpr int NC = DT / 64;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* sdO = base + Tile::kQBytes;
  uint8_t* sKV = base + 2 * Tile::kQBytes;  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Tile::kTiles);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tile first

  // The forward's k-loop bounds. A row that sees no key finds every entry
  // of the tiles it visits masked, so its dQ is 0.
  const int n_kt = (a.Sk + BK - 1) / BK;
  int kt_end = n_kt;
  if (a.causal) kt_end = min(n_kt, (q0 + BQ + BK - 1) / BK);
  int kt_start = 0;
  if (a.causal && a.window > 0) kt_start = max(q0 - (a.window - 1), 0) / BK;
  const int n_it = max(kt_end - kt_start, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init(qbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      sm90::mbar_arrive_expect_tx(qbar, 2 * Tile::kQBytes);
      for (int c = 0; c < NC; ++c) {
        sm90::tma_load_4d(sQ + c * BQ * 128, &a.tq, qbar, c * 64, q0, h, b);
        sm90::tma_load_4d(sdO + c * BQ * 128, &a.tdo, qbar, c * 64, q0, h,
                          b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % NS;
        sm90::mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * Tile::kKVBytes);
        uint8_t* sk = sKV + s * 2 * Tile::kKVBytes;
        uint8_t* sv = sk + Tile::kKVBytes;
        const int k0 = (kt_start + it) * BK;
        for (int c = 0; c < NC; ++c) {
          sm90::tma_load_4d(sk + c * BK * 128, &a.tk, &full[s], c * 64, k0,
                            hk, b);
          sm90::tma_load_4d(sv + c * BK * 128, &a.tv, &full[s], c * 64, k0,
                            hk, b);
        }
      }
    }
  } else {  // consumer warpgroups: 64 q rows each
    sm90::setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int wq0 = q0 + wg * 64;                  // the warpgroup's rows
    const int qr = wq0 + warp * 16 + (lane >> 2);  // rows qr, qr + 8
    const int cq = 2 * (lane & 3);                 // column in an 8-group
    const uint32_t q_addr = sm90::smem_u32(sQ) + wg * 64 * 128;
    const uint32_t o_addr = sm90::smem_u32(sdO) + wg * 64 * 128;
    const uint32_t kv_addr = sm90::smem_u32(sKV);

    float lse2[2], dlt[2];  // the rows' lse * log2(e) and delta
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qr + 8 * r;
      const bool ok = qpos < a.Sq;
      lse2[r] = ok ? a.lse[(long long)bh * a.Sq + qpos] * kLog2e : 0.f;
      dlt[r] = ok ? a.delta[(long long)bh * a.Sq + qpos] : 0.f;
    }

    float dq[DT / 2];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) dq[i] = 0.f;
    float st[BK / 2], dpt[BK / 2];
    uint32_t da[BK / 16][4];

    // S = Q.K^T and dP = dO.V^T of the tile in stage s: 64 rows x BK keys.
    auto scores = [&](int s) {
      const uint32_t k_addr = kv_addr + s * 2 * Tile::kKVBytes;
      const uint32_t v_addr = k_addr + Tile::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        sm90::wgmma_ss(
            st, sm90::desc_sw128(q_addr + (kk >> 2) * BQ * 128 + off, 16, 1024),
            sm90::desc_sw128(k_addr + (kk >> 2) * BK * 128 + off, 16, 1024),
            kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        sm90::wgmma_ss(
            dpt, sm90::desc_sw128(o_addr + (kk >> 2) * BQ * 128 + off, 16, 1024),
            sm90::desc_sw128(v_addr + (kk >> 2) * BK * 128 + off, 16, 1024),
            kk > 0);
      }
    };
    // dS = P (dP - delta) scale into dpt, P = exp2(S scale log2e - lse
    // log2e); masked and out-of-range keys give dS = 0 (their P may be inf
    // for a row whose lse is NEG_INF, so it is replaced, never multiplied).
    auto grads = [&](int it) {
      const int k0 = (kt_start + it) * BK;
      const bool need_mask =
          k0 + BK > a.Sk ||
          (a.causal && (k0 + BK - 1 > wq0 ||
                        (a.window > 0 && wq0 + 63 - k0 >= a.window)));
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float pv = sm90::ex2(fmaf(st[i], a.scale_log2, -lse2[r]));
        if (need_mask) {
          const int kpos = k0 + 8 * (i >> 2) + cq + (i & 1);
          const int qpos = qr + 8 * r;
          if (kpos >= a.Sk ||
              (a.causal && (qpos < kpos ||
                            (a.window > 0 && qpos - kpos >= a.window)))) {
            pv = 0.f;
          }
        }
        dpt[i] = pv * (dpt[i] - dlt[r]) * a.scale;
      }
    };
    // dQ += dS.K, K (BK keys x DT) of stage s read MN-major.
    auto dq_product = [&](int s) {
      const uint32_t k_addr = kv_addr + s * 2 * Tile::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        sm90::wgmma_rs(dq, da[kk],
                       sm90::desc_sw128(k_addr + kk * 2048, BK * 128, 1024));
      }
    };

    sm90::mbar_wait(qbar, 0);
    if (n_it > 0) {
      sm90::mbar_wait(&full[0], 0);
      sm90::wgmma_fence();
      scores(0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      grads(0);
      sm90::to_a_frags(dpt, da);
    }
    // Software pipeline inside the warpgroup: S_it, dP_it and
    // dQ += dS_(it-1).K_(it-1) are issued together, and dS_it is formed
    // while the tensor cores still work on the dQ product.
    for (int it = 1; it < n_it; ++it) {
      const int s = it % NS;
      const int sp = (it - 1) % NS;
      sm90::mbar_wait(&full[s], (it / NS) & 1);
      sm90::wgmma_fence();
      scores(s);
      sm90::wgmma_commit();
      dq_product(sp);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S_it and dP_it are ready; dQ may still run
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      grads(it);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(da);
      sm90::mbar_arrive(&empty[sp]);
      sm90::to_a_frags(dpt, da);
    }
    if (n_it > 0) {
      sm90::wgmma_fence();
      dq_product((n_it - 1) % NS);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(da);
    }

    // dQ is contiguous (B, Sq, H, D).
    __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qr + 8 * r;
      if (qpos >= a.Sq) continue;
      const long long row = (((long long)b * a.Sq + qpos) * a.H + h) * a.D;
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < a.D) {
          *reinterpret_cast<__nv_bfloat162*>(dqg + row + col) =
              __floats2bfloat162_rn(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <int DT>
cudaError_t launch_dq_bf16(const Params& p, cudaStream_t stream) {
  using Tile = DqTile<DT>;
  DqArgs a;
  if (!sm90_host::bf16_bshd_map(&a.tq, p.q, p.B, p.Sq, p.H, p.D, p.q_sb,
                                p.q_ss, p.q_sh, Tile::kBQ) ||
      !sm90_host::bf16_bshd_map(&a.tdo, p.dout, p.B, p.Sq, p.H, p.D, p.do_sb,
                                p.do_ss, p.do_sh, Tile::kBQ) ||
      !sm90_host::bf16_bshd_map(&a.tk, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb,
                                p.k_ss, p.k_sh, Tile::kBK) ||
      !sm90_host::bf16_bshd_map(&a.tv, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb,
                                p.v_ss, p.v_sh, Tile::kBK)) {
    return cudaErrorInvalidValue;
  }
  a.lse = p.lse;
  a.delta = p.delta;
  a.dq = p.dq;
  a.H = p.H;
  a.Hkv = p.Hkv;
  a.Sq = p.Sq;
  a.Sk = p.Sk;
  a.D = p.D;
  a.causal = p.causal;
  a.window = p.window;
  a.scale = p.scale;
  a.scale_log2 = p.scale * kLog2e;
  auto kernel = flash_dq_bf16_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.H, (p.Sq + Tile::kBQ - 1) / Tile::kBQ);
  kernel<<<grid, kWgThreads, Tile::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// Tiles by head dim. Shared memory per block (bytes): the CUDA-core dQ
// 85 K / 151 K / 138 K and dK/dV 104 K / 170 K / 145 K for D <= 64 / 128 /
// 256; the tensor-core dQ 81 K / 161 K and dK/dV 68 K / 134 K for
// D <= 64 / 128. All under the 227 KB a block may use.
template <typename T>
cudaError_t dispatch(const Params& p, int which, cudaStream_t s) {
  if (which == 0) {
    if constexpr (sizeof(T) == 2) {  // bf16 dQ: tensor cores to D = 128
      if (p.D <= 64) return launch_dq_bf16<64>(p, s);
      if (p.D <= 128) return launch_dq_bf16<128>(p, s);
      return launch_dq<T, 256, 32, 32>(p, s);  // CUDA cores (see the note)
    } else {
      if (p.D <= 64) return launch_dq<T, 64, 64, 64>(p, s);
      if (p.D <= 128) return launch_dq<T, 128, 64, 64>(p, s);
      return launch_dq<T, 256, 32, 32>(p, s);
    }
  }
  if constexpr (sizeof(T) == 2) {  // bf16 dK/dV: tensor cores to D = 128
    if (p.D <= 64) return launch_dkv_bf16<64>(p, s);
    if (p.D <= 128) return launch_dkv_bf16<128>(p, s);
    return launch_dkv<T, 256, 32, 32>(p, s);  // CUDA cores (see the note)
  } else {
    if (p.D <= 64) return launch_dkv<T, 64, 64, 64>(p, s);
    if (p.D <= 128) return launch_dkv<T, 128, 64, 64>(p, s);
    return launch_dkv<T, 256, 32, 32>(p, s);
  }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* delta, void* dq,
        void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int D,
        long long q_sb, long long q_ss, long long q_sh, long long k_sb,
        long long k_ss, long long k_sh, long long v_sb, long long v_ss,
        long long v_sh, long long do_sb, long long do_ss, long long do_sh,
        int causal, int window, float scale, int dtype, void* stream) {
  if (D < 8 || D > 256 || D % 8 || Hkv <= 0 || H % Hkv) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return (int)cudaSuccess;
  Params p{q,    k,    v,    dout, lse,  delta, dq,   dk,   dv,
           B,    H,    Hkv,  Sq,   Sk,   D,     q_sb, q_ss, q_sh,
           k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,  do_sb, do_ss, do_sh,
           causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, which, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, which, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Each returns
// the cudaError_t of its launch (0 = launched); the caller checks it.
extern "C" int tpunet_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int H, int Hkv,
    int Sq, int Sk, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, int causal, int window, float scale, int dtype,
    void* stream) {
  return run(0, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, Hkv,
             Sq, Sk, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             do_sb, do_ss, do_sh, causal, window, scale, dtype, stream);
}

extern "C" int tpunet_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Hkv, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, int causal, int window, float scale,
    int dtype, void* stream) {
  return run(1, q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hkv, Sq,
             Sk, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             do_sb, do_ss, do_sh, causal, window, scale, dtype, stream);
}
