// Flash-attention forward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel tpunet/ops/flash_attention.py:_flash_kernel
// (:73, launched by _flash_fwd_impl at :376). Both kernels here compute
// exactly what it computes: softmax(q k^T * scale) v with an online softmax
// over K/V tiles, f32 running state (m, l, acc), the causal k-loop upper
// bound cdiv(q_end, BK), the sliding-window lower bound
// max(q0 - (window - 1), 0) / BK, elementwise NEG_INF (-1e30) masking of
// partial tiles, -inf (P = 0) past a ragged Sk, causal aligned at position
// 0 for any Sq, Sk, GQA through kv head h / group (no repeated K/V), and
// the per-row logsumexp lse = m + log(l), (B*H, Sq) f32, that the backward
// reads. q/o are (B, Sq, H, D), k/v (B, Sk, Hkv, D), read through their
// batch/sequence/head strides (unit stride in D): no flatten/transpose copy.
//
// Rows that see no key (causal with a window, qpos >= Sk + window - 1, so
// only when Sq > Sk) get the JAX reference's answer: the softmax of Sk
// equal NEG_INF scores, o = the mean of V over all Sk keys and
// lse = NEG_INF (+ log Sk, which f32 absorbs). A block holding such a row
// walks every k tile from the first: each masked score is NEG_INF, so such
// a row sums all Sk keys with weight 1, while a row that sees keys drops
// what it summed before its first visible key (the online rescale by
// exp(NEG_INF - m) is exactly 0). Blocks without such rows keep the TPU
// kernel's bounds and do no extra work; l is never 0.
//
// bf16: flash_fwd_bf16_kernel, tensor cores. For bf16 inputs the TPU kernel
// runs Precision.DEFAULT (_dot_precision, :267-272): one bf16 MXU pass, so
// P enters the P.V product rounded to bf16 and every product accumulates in
// f32. The same here: S = Q.K^T and O += P.V are wgmma products with bf16
// operands and f32 accumulators, and P is rounded to bf16 in registers.
// (The TPU rounds q * scale to bf16 before its pass; here the scale
// multiplies the f32 scores, which is no less exact.)
// What bounds it: at the training shape (B4 S2048 H16 D128 causal) the
// forward is 68.7 GFLOP against ~34 MB, so the tensor cores bound it:
// 0.0695 ms at 989 TFLOP/s. The design, for that bound:
//   * one block per (batch*head, 128-row q tile), launched heaviest causal
//     tile first; two consumer warpgroups own 64 q rows each (wgmma's M),
//     one producer warp issues every global->shared copy;
//   * Q (once) and a ring of K/V stages arrive by TMA into the 128-byte
//     swizzled bf16 layout wgmma reads (sm90.cuh), completion counted on
//     mbarriers, so the next tiles' copies overlap this tile's products;
//     TMA's zero fill supplies ragged tails and pads D up to the tile's D
//     (64/128/256), whose extra output columns are never stored;
//   * S = Q.K^T is an SS-wgmma (both K-major as stored); the online softmax
//     runs on the accumulator fragments, rows reduced across the 4 threads
//     that hold them, in the log2 domain (the scale folds into the
//     exponent's FMA on tiles without a mask); O += P.V is an RS-wgmma with
//     P converted to bf16 A fragments in registers and V read MN-major
//     through the transpose bit (no transposed copy);
//   * each warpgroup pipelines its tiles: S_j = Q.K_j and O += P_(j-1).V_(j-1)
//     are issued together and the softmax of S_j runs while the tensor
//     cores still work on P.V, so the exponentials no longer wait for the
//     products or the products for them;
//   * setmaxnreg moves registers from the producer to the consumers
//     (O for D = 256 is 128 f32 registers a thread).
// Tiles: 128 q rows; 128 keys and 3 stages for D <= 128, 64 keys and 2
// stages for D = 256 (shared memory 225 / 193 KB a block; one block an SM).
//
// f32: flash_fwd_kernel, the CUDA cores, unchanged since it was first
// ported: inputs staged in shared memory and every product an f32 FMA (no
// TF32), the counterpart of Precision.HIGHEST for f32 inputs. One
// 128-thread block per (batch*head, 64-row q tile) with a register tile of
// RPT x 8 scores and RPT x D/8 outputs per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }

// True when one of the rows q0..q0+rows-1 (< Sq) sees no key. Such a row
// is past Sk, so the causal k-loop end is already the last k tile.
__device__ __forceinline__ bool holds_no_key_row(int causal, int window,
                                                 int q0, int rows, int Sq,
                                                 int Sk) {
  return causal && window > 0 && min(q0 + rows, Sq) - 1 >= Sk + window - 1;
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
  if (holds_no_key_row(p.causal, p.window, q0, BQ, p.Sq, p.Sk)) kt_start = 0;

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

cudaError_t dispatch_f32(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<float, 64, 64>(p, stream);
  if (p.D <= 128) return launch<float, 128, 64>(p, stream);
  return launch<float, 256, 32>(p, stream);
}

// ---------------------------------------------------- bf16, tensor cores --

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInfL2 = kNegInf * kLog2e;  // NEG_INF in the log2 domain
constexpr int kWgThreads = 384;  // 2 consumer warpgroups + 1 producer

struct Bf16Args {
  CUtensorMap tq, tk, tv;
  void* o;
  float* lse;
  int H, Hkv, Sq, Sk, D;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;
  float scale_log2;  // scale * log2(e): the softmax runs on exp2
};

template <int DT, int BK>
struct Bf16Tile {
  static constexpr int kBQ = 128;  // 2 consumer warpgroups x 64 rows
  // The pipelined consumers hold two stages at a time (K_it and V_(it-1)),
  // so a third lets the next load run ahead; D = 256 has room for two.
  static constexpr int kStages = DT <= 128 ? 3 : 2;
  static constexpr int kQBytes = kBQ * DT * 2;
  static constexpr int kKVBytes = BK * DT * 2;  // one K (or V) tile
  static constexpr int kTiles = kQBytes + kStages * 2 * kKVBytes;
  static constexpr size_t kSmem =  // alignment slack, tiles, barriers
      1024 + kTiles + 8 * (2 * kStages + 1);
};

// S = Q.K^T for one warpgroup: 64 q rows x BK keys, contraction over DT.
template <int DT, int BK, int BQ>
__device__ __forceinline__ void qk_product(float (&sc)[BK / 2],
                                           uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    sm90::wgmma_ss(
        sc, sm90::desc_sw128(q_addr + (kk >> 2) * BQ * 128 + off, 16, 1024),
        sm90::desc_sw128(k_addr + (kk >> 2) * BK * 128 + off, 16, 1024),
        kk > 0);
  }
}

// O += P.V, P as bf16 register fragments, V (BK keys x DT) MN-major.
template <int DT, int BK>
__device__ __forceinline__ void pv_product(float (&o)[DT / 2],
                                           const uint32_t (&pa)[BK / 16][4],
                                           uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    sm90::wgmma_rs(o, pa[kk],
                   sm90::desc_sw128(v_addr + kk * 2048, BK * 128, 1024));
  }
}

// One tile of the online softmax on the accumulator fragment sc (raw
// scores in, P out), in the log2 domain: x = s * scale * log2(e). Rows are
// qr and qr + 8; the 4 threads of a row reduce with shuffles. Without a
// mask the scale folds into the exponent's FMA; with one, masked scores
// become NEG_INF (-inf past Sk) before the max, as on the TPU.
template <int N, bool kMask>
__device__ __forceinline__ void online_softmax(float (&sc)[N], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               const Bf16Args& a, int k0,
                                               int qr, int cq) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = sc[i];
    if (kMask) {
      x *= a.scale_log2;
      const int kpos = k0 + 8 * (i >> 2) + cq + (i & 1);
      const int qpos = qr + 8 * ((i >> 1) & 1);
      if (kpos >= a.Sk) {
        x = -INFINITY;  // ragged tail: contributes exactly 0
      } else if (a.causal && (qpos < kpos || (a.window > 0 &&
                                              qpos - kpos >= a.window))) {
        x = kNegInfL2;
      }
      sc[i] = x;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], kMask ? mx[r] : mx[r] * a.scale_log2);
    alpha[r] = sm90::ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float mr = m[(i >> 1) & 1];
    const float pv = kMask ? sm90::ex2(sc[i] - mr)
                            : sm90::ex2(fmaf(sc[i], a.scale_log2, -mr));
    sc[i] = pv;
    l[(i >> 1) & 1] += pv;
  }
}

template <int DT, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ Bf16Args a) {
  using Tile = Bf16Tile<DT, BK>;
  constexpr int BQ = Tile::kBQ, NS = Tile::kStages, NC = DT / 64;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* sKV = base + Tile::kQBytes;  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Tile::kTiles);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tile first

  const int n_kt = (a.Sk + BK - 1) / BK;
  int kt_end = n_kt;
  if (a.causal) kt_end = min(n_kt, (q0 + BQ + BK - 1) / BK);
  int kt_start = 0;
  if (a.causal && a.window > 0) kt_start = max(q0 - (a.window - 1), 0) / BK;
  if (holds_no_key_row(a.causal, a.window, q0, BQ, a.Sq, a.Sk)) kt_start = 0;
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
      sm90::mbar_arrive_expect_tx(qbar, Tile::kQBytes);
      for (int c = 0; c < NC; ++c)
        sm90::tma_load_4d(sQ + c * BQ * 128, &a.tq, qbar, c * 64, q0, h, b);
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
    const uint32_t kv_addr = sm90::smem_u32(sKV);

    float o[DT / 2];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInfL2, kNegInfL2};
    float l[2] = {0.f, 0.f};  // this thread's partial row sums
    float alpha[2];
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];

    // Tile `it`'s scores into sc, then its online softmax: P (f32, in sc),
    // the row rescale alpha, and m, l updated.
    auto softmax = [&](int it) {
      const int k0 = (kt_start + it) * BK;
      const bool need_mask =
          k0 + BK > a.Sk ||
          (a.causal && (k0 + BK - 1 > wq0 ||
                        (a.window > 0 && wq0 + 63 - k0 >= a.window)));
      if (need_mask) {
        online_softmax<BK / 2, true>(sc, m, l, alpha, a, k0, qr, cq);
      } else {
        online_softmax<BK / 2, false>(sc, m, l, alpha, a, k0, qr, cq);
      }
    };

    sm90::mbar_wait(qbar, 0);
    if (n_it > 0) {
      sm90::mbar_wait(&full[0], 0);
      sm90::wgmma_fence();
      qk_product<DT, BK, BQ>(sc, q_addr, kv_addr);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      softmax(0);
      sm90::to_a_frags(sc, pa);
    }
    // Software pipeline inside the warpgroup: S_it = Q.K_it and
    // O += P_(it-1).V_(it-1) are issued together, and the softmax of S_it
    // runs while the tensor cores still work on P.V.
    for (int it = 1; it < n_it; ++it) {
      const int s = it % NS;
      const int sp = (it - 1) % NS;
#pragma unroll
      for (int i = 0; i < DT / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      sm90::mbar_wait(&full[s], (it / NS) & 1);
      sm90::wgmma_fence();
      qk_product<DT, BK, BQ>(sc, q_addr, kv_addr + s * 2 * Tile::kKVBytes);
      sm90::wgmma_commit();
      pv_product<DT, BK>(o, pa,
                         kv_addr + sp * 2 * Tile::kKVBytes + Tile::kKVBytes);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S_it is ready; P.V may still run
      sm90::fence_regs(sc);
      softmax(it);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      sm90::mbar_arrive(&empty[sp]);
      sm90::to_a_frags(sc, pa);
    }
    if (n_it > 0) {
      const int sp = (n_it - 1) % NS;
#pragma unroll
      for (int i = 0; i < DT / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      sm90::wgmma_fence();
      pv_product<DT, BK>(o, pa,
                         kv_addr + sp * 2 * Tile::kKVBytes + Tile::kKVBytes);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
    }

    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb +
                        h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qpos = qr + 8 * r;
      if (qpos >= a.Sq) continue;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < a.D) {
          *reinterpret_cast<__nv_bfloat162*>(og + qpos * a.o_ss + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                    o[4 * j + 2 * r + 1] * inv);
        }
      }
      if ((lane & 3) == 0) {  // a row without a key: NEG_INF, exactly
        a.lse[(long long)bh * a.Sq + qpos] =
            m[r] == kNegInfL2 ? kNegInf : m[r] * kLn2 + logf(l[r]);
      }
    }
  }
}

template <int DT, int BK>
cudaError_t launch_bf16(Bf16Args& a, int B, const Params& p,
                        cudaStream_t stream) {
  using Tile = Bf16Tile<DT, BK>;
  if (!sm90_host::bf16_bshd_map(&a.tq, p.q, B, p.Sq, p.H, p.D, p.q_sb,
                                p.q_ss, p.q_sh, Tile::kBQ) ||
      !sm90_host::bf16_bshd_map(&a.tk, p.k, B, p.Sk, p.Hkv, p.D, p.k_sb,
                                p.k_ss, p.k_sh, BK) ||
      !sm90_host::bf16_bshd_map(&a.tv, p.v, B, p.Sk, p.Hkv, p.D, p.v_sb,
                                p.v_ss, p.v_sh, BK)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_bf16_kernel<DT, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * p.H, (p.Sq + Tile::kBQ - 1) / Tile::kBQ);
  kernel<<<grid, kWgThreads, Tile::kSmem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Params& p, cudaStream_t stream) {
  Bf16Args a;
  a.o = p.o;
  a.lse = p.lse;
  a.H = p.H;
  a.Hkv = p.Hkv;
  a.Sq = p.Sq;
  a.Sk = p.Sk;
  a.D = p.D;
  a.o_sb = p.o_sb;
  a.o_ss = p.o_ss;
  a.o_sh = p.o_sh;
  a.causal = p.causal;
  a.window = p.window;
  a.scale_log2 = p.scale * kLog2e;
  if (p.D <= 64) return launch_bf16<64, 128>(a, p.B, p, stream);
  if (p.D <= 128) return launch_bf16<128, 128>(a, p.B, p, stream);
  return launch_bf16<256, 64>(a, p.B, p, stream);
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
  if (dtype == 0) return (int)dispatch_f32(p, s);
  if (dtype == 1) return (int)dispatch_bf16(p, s);
  return (int)cudaErrorInvalidValue;
}
