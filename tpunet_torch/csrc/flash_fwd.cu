// Flash-attention forward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel tpunet/ops/flash_attention.py:_flash_kernel
// (launched by _flash_fwd_impl). It computes exactly what that kernel
// computes: softmax(q k^T * scale) v with an online softmax over K/V tiles,
// f32 running state (m, l, acc), the causal k-loop upper bound
// cdiv(q_end, BK), the sliding-window lower bound
// max(q0 - (window - 1), 0) / BK, elementwise NEG_INF (-1e30) masking of
// partial tiles, GQA through kv head h / group (no repeated K/V), and the
// per-row logsumexp lse = m + log(l) the backward pass will read.
//
// Layout: q/o are (B, Sq, H, D), k/v (B, Sk, Hkv, D), read directly
// through their batch/sequence/head strides (the last dim must be unit
// stride), so the wrapper makes no flatten/transpose copies. lse is
// (B*H, Sq) f32. Ragged Sq/Sk tails are masked here; causal aligns q and k
// positions at 0 for any Sq, Sk, as attention_reference does.
//
// Numerics: inputs are converted to f32 on their way into shared memory
// and every product is an f32 FMA (no TF32), the counterpart of
// Precision.HIGHEST on the TPU for f32 inputs; bf16 inputs accumulate in
// f32 as well. O is written in the input dtype.
//
// What bounds it on the card: at the serving shapes (D = 128, S <= 1024)
// attention does ~2*D flops per score against a few bytes, so the
// arithmetic bounds it, not HBM. This first version runs it on the CUDA
// cores (67 TFLOP/s f32 peak) from shared memory, with a register tile of
// RPT x 8 scores and RPT x D/8 outputs per thread so each shared-memory
// load feeds several FMAs; the bf16 tensor-core path (mma/wgmma, TMA
// pipelining) is later work. One 128-thread block per (batch*head,
// 64-row q tile); K/V tiles of 64 rows are staged in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF mask value
constexpr int kThreads = 128;      // 16 row groups x 8 column lanes
constexpr int kBK = 64;            // keys per tile
constexpr int kKtStride = kBK + 1; // transposed-K row stride (bank spread)
constexpr int kPStride = kBK + 8;  // probability-tile row stride

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, Hkv, Sq, Sk, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
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

template <int DMAX, int BQ>
struct Smem {
  static constexpr int kQStride = DMAX + 1;
  static constexpr int kQ = BQ * kQStride;      // sQ[BQ][DMAX+1], scaled q
  static constexpr int kKt = DMAX * kKtStride;  // sKt[DMAX][BK+1], k^T
  static constexpr int kV = kBK * DMAX;         // sV[BK][DMAX]
  static constexpr int kP = BQ * kPStride;      // sP[BQ][BK+8]
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKt + kV + kP);
};

template <typename T, int DMAX, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int RPT = BQ / 16;   // q rows per thread
  constexpr int CPT = kBK / 8;   // score columns per thread
  constexpr int DPT = DMAX / 8;  // output columns per thread
  using S = Smem<DMAX, BQ>;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKt = sQ + S::kQ;
  float* sV = sKt + S::kKt;
  float* sP = sV + S::kV;

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // column lane: score cols tx+8j, out cols tx+8j
  const int ty = tid >> 3;  // row group: rows ty + 16*i
  const int D = p.D;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Stage the q tile once, pre-scaled like the TPU kernel (q * scale).
  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int qpos = q0 + r;
    sQ[r * S::kQStride + d] =
        qpos < p.Sq ? load_f32(qg + qpos * p.q_ss + d) * p.scale : 0.f;
  }

  float acc[RPT][DPT];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // The TPU kernel's loop bounds: causal stops at the tile holding the
  // tile's last row's own position; a window starts at the tile holding
  // the FIRST row's oldest visible key (elementwise masks trim the rest).
  const int n_kt = (p.Sk + kBK - 1) / kBK;
  int kt_end = n_kt;
  if (p.causal) kt_end = min(n_kt, (q0 + BQ + kBK - 1) / kBK);
  int kt_start = 0;
  if (p.causal && p.window > 0) kt_start = max(q0 - (p.window - 1), 0) / kBK;

  for (int kt = kt_start; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's readers are done with sKt/sV/sP
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e - c * D;
      const int kpos = k0 + c;
      const bool ok = kpos < p.Sk;
      sKt[d * kKtStride + c] = ok ? load_f32(kg + kpos * p.k_ss + d) : 0.f;
      sV[c * DMAX + d] = ok ? load_f32(vg + kpos * p.v_ss + d) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty + 16 * i) * S::kQStride + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sKt[d * kKtStride + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float x = s[i][j];
        if (kpos >= p.Sk) {
          x = -INFINITY;  // ragged tail: contributes exactly 0
        } else if (p.causal) {
          bool keep = qpos >= kpos;
          if (p.window > 0) keep = keep && (qpos - kpos) < p.window;
          if (!keep) x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // The 8 column lanes of a row are adjacent lanes of one warp.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pv = expf(s[i][j] - m_new);
        rs += pv;
        sP[r * kPStride + tx + 8 * j] = pv;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int c_end = min(kBK, p.Sk - k0);
#pragma unroll 2
    for (int c = 0; c < c_end; ++c) {
      float pr[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = sP[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = sV[c * DMAX + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 8 * j;
      if (d < D) store_from_f32(og + qpos * p.o_ss + d, acc[i][j] * inv);
    }
    if (tx == 0) p.lse[(long long)bh * p.Sq + qpos] = m[i] + logf(l[i]);
  }
}

template <typename T, int DMAX, int BQ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX, BQ>;
  const size_t bytes = Smem<DMAX, BQ>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64, 64>(p, stream);
  if (p.D <= 128) return launch<T, 128, 64>(p, stream);
  return launch<T, 256, 32>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launch (0 = launched); the caller checks it.
extern "C" int tpunet_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int H, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, int dtype, void* stream) {
  if (D < 8 || D > 256 || D % 8 || Hkv <= 0 || H % Hkv) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  Params p{q,    k,    v,    o,    lse,  B,    H,    Hkv,
           Sq,   Sk,   D,    q_sb, q_ss, q_sh, k_sb, k_ss,
           k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal,
           window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(p, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
