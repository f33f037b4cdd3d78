// Flash-attention forward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel tpunet/ops/flash_attention.py:_flash_kernel
// (:73, launched by _flash_fwd_impl at :376). Every kernel here computes
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
// bf16 and f16: flash_fwd_bf16_kernel<T, DT, BK>, tensor cores, with the
// element type T (__nv_bfloat16 or __half) a template parameter; both
// types run the same code, and wgmma's operand type follows T (sm90.cuh).
// For bf16 inputs the TPU kernel runs Precision.DEFAULT (_dot_precision,
// :267-272): one bf16 MXU pass, so P enters the P.V product rounded to
// bf16 and every product accumulates in f32. The same here: S = Q.K^T and
// O += P.V are wgmma products with 16-bit operands and f32 accumulators,
// and P is rounded to T in registers. (The TPU rounds q * scale to bf16
// before its pass; here the scale multiplies the f32 scores, which is no
// less exact.) For f16 inputs P is rounded to f16: its 11-bit significand
// keeps P closer to the JAX reference on the CPU (f32 arithmetic on f16
// inputs) than bf16's 8 bits keep the bf16 kernel to its reference.
// What bounds it: at the training shape (B4 S2048 H16 D128 causal) the
// forward is 68.7 GFLOP against ~34 MB, so the tensor cores bound it:
// 0.0695 ms at 989 TFLOP/s (the same for f16). The design, for that bound:
//   * one block per (batch*head, 128-row q tile), launched heaviest causal
//     tile first; two consumer warpgroups own 64 q rows each (wgmma's M),
//     one producer warp issues every global->shared copy;
//   * Q (once) and a ring of K/V stages arrive by TMA into the 128-byte
//     swizzled 16-bit layout wgmma reads (sm90.cuh), completion counted on
//     mbarriers, so the next tiles' copies overlap this tile's products;
//     TMA's zero fill supplies ragged tails and pads D up to the tile's D
//     (64/128/256), whose extra output columns are never stored;
//   * S = Q.K^T is an SS-wgmma (both K-major as stored); the online softmax
//     runs on the accumulator fragments, rows reduced across the 4 threads
//     that hold them, in the log2 domain (the scale folds into the
//     exponent's FMA on tiles without a mask); O += P.V is an RS-wgmma with
//     P converted to 16-bit A fragments in registers and V read MN-major
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
// f32: flash_fwd_f32_kernel<DT>, the CUDA cores. For f32 inputs the TPU
// kernel runs Precision.HIGHEST, so every product here is an exact f32 FMA
// (no TF32, no 3xTF32). What bounds it: at the training shape the forward
// is 68.7 GFLOP, 34.4 G FMA, against ~270 MB: the FMA pipe, 1.03 ms at
// 67 TFLOP/s. An FMA needs two operands, and shared memory delivers 128
// bytes a clock to an SM whose 128 lanes issue 128 FMAs a clock, so the
// design is about operand reuse, occupancy and overlap:
//   * one 256-thread block (8 warps, one block an SM) per (batch*head,
//     128-row q tile; 64 rows at D = 256), heaviest causal tile first;
//   * each thread keeps an 8 x 8 score tile (8 q rows x 8 keys) and an 8 x
//     DT/16 output tile in registers; every operand is a 16-byte shared
//     load, so 8 Q loads and 8 K loads feed 256 FMAs (S, along D from
//     row-major tiles) and 8 P loads and 8 V loads feed 256 (P.V, along
//     the keys); rows padded by 4 floats keep the loads free of bank
//     conflicts;
//   * Q is resident; K and V stream as 8704-float chunks (K: 128 keys x 64
//     columns; V: 8192/DT keys x DT columns) through a 2-stage cp.async
//     ring, 16 bytes a copy, so the next chunk loads while this one's FMAs
//     run; zero-size copies fill ragged rows and columns past D;
//   * the online softmax runs in registers in the log2 domain (rows
//     reduced by shuffles across the 16 lanes that hold them), and P goes
//     through shared memory to the threads that own its output columns.
// Shared memory: 168 / 200 / 166 KiB a block at DT = 64 / 128 / 256.
//
// Head dims above 256, every dtype: flash_fwd_wide_kernel<T> (T = float,
// __nv_bfloat16, __half) on the CUDA cores, with one grid axis over
// 128-column slices of the head dim (flash_wide.cuh). bf16 and f16 inputs
// round P to T before P.V and accumulate in f32, as the tensor-core kernel
// does; f32 runs exact f32 FMA. A simple design, right at any head dim.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wide.cuh"
#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInfL2 = kNegInf * kLog2e;  // NEG_INF in the log2 domain

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

// True when one of the rows q0..q0+rows-1 (< Sq) sees no key. Such a row
// is past Sk, so the causal k-loop end is already the last k tile.
__device__ __forceinline__ bool holds_no_key_row(int causal, int window,
                                                 int q0, int rows, int Sq,
                                                 int Sk) {
  return causal && window > 0 && min(q0 + rows, Sq) - 1 >= Sk + window - 1;
}

// The TPU kernel's k-loop bounds for the q rows q0..q0+rows-1: causal stops
// at the tile holding the last row's own position; a window starts at the
// tile holding the FIRST row's oldest visible key (elementwise masks trim
// the rest); a block holding a row that sees no key starts at tile 0.
struct KRange {
  int start, end;
};

__device__ __forceinline__ KRange k_range(int causal, int window, int q0,
                                          int rows, int Sq, int Sk, int bk) {
  const int n_kt = (Sk + bk - 1) / bk;
  KRange r{0, n_kt};
  if (causal) r.end = min(n_kt, (q0 + rows + bk - 1) / bk);
  if (causal && window > 0) r.start = max(q0 - (window - 1), 0) / bk;
  if (holds_no_key_row(causal, window, q0, rows, Sq, Sk)) r.start = 0;
  return r;
}

// True when some entry of the (rows x bk) score tile at (q0, k0) is masked:
// past Sk, above the causal diagonal or outside the window.
__device__ __forceinline__ bool tile_needs_mask(int causal, int window,
                                                int q0, int rows, int k0,
                                                int bk, int Sk) {
  return k0 + bk > Sk ||
         (causal && (k0 + bk - 1 > q0 ||
                     (window > 0 && q0 + rows - 1 - k0 >= window)));
}

// ------------------------------------------------------ f32, CUDA cores --

constexpr int kF32BK = 128;  // keys a tile

// Tiles of flash_fwd_f32_kernel<DT>. K and V stream through one ring of
// kStages chunks of 128 x kCW floats: K as 128 keys x kCW head-dim columns
// (DT / kCW chunks a tile), V as kVK keys x DT columns (128 / kVK = DT /
// kCW chunks a tile). Rows are padded by 4 floats: 16-byte loads stay
// aligned and 8 rows at one column fall in 8 different 4-bank groups.
template <int DT>
struct F32Tile {
  static constexpr int kThreads = 256;              // 16 row groups x 16 lanes
  static constexpr int kRG = kThreads / 16;         // row groups
  static constexpr int kBQ = DT <= 128 ? 128 : 64;  // q rows a block
  static constexpr int kRPT = kBQ / kRG;            // q rows a thread
  static constexpr int kCols = DT / 16;             // output columns a thread
  static constexpr int kCW = 64;                    // K chunk columns
  static constexpr int kStages = 2;                 // the cp.async ring
  static constexpr int kKStride = kCW + 4;          // K chunk rows
  static constexpr int kStageFloats = kF32BK * kKStride;
  static constexpr int kQStride = DT + 4;           // sQ and V chunk rows
  static constexpr int kPStride = kF32BK + 4;       // sP rows
  static constexpr int kVK = kF32BK * kCW / DT;     // keys a V chunk
  static constexpr int kNC = DT / kCW;              // K (or V) chunks a tile
  static constexpr int kCopies = kF32BK * kCW / 4 / kThreads;  // a thread's
  static constexpr size_t kSmem =
      sizeof(float) * (kBQ * kQStride + kBQ * kPStride +
                       kStages * kStageFloats);
  static_assert(kVK * kQStride <= kStageFloats, "V chunk over its stage");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// f32 forward on the CUDA cores, exact f32 FMA. One block per (batch*head,
// kBQ-row q tile), heaviest causal tile first. Thread (ty, tx) owns q rows
// ty + RG i, the tile's keys tx + 16j (j < 8) and output columns
// 64g + 4tx + e (e < 4): an RPT x 8 score tile and an RPT x DT/16 output
// tile in registers, every operand read as a 16-byte shared load.
template <int DT>
__global__ void __launch_bounds__(F32Tile<DT>::kThreads, 1)
flash_fwd_f32_kernel(const Params p) {
  using Tile = F32Tile<DT>;
  constexpr int BQ = Tile::kBQ, RPT = Tile::kRPT, NCOL = Tile::kCols;
  constexpr int QS = Tile::kQStride, PS = Tile::kPStride, VK = Tile::kVK;
  constexpr int NC = Tile::kNC, NS = Tile::kStages, CW = Tile::kCW;
  constexpr int KS = Tile::kKStride, RG = Tile::kRG, NT = Tile::kThreads;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sP = sQ + BQ * QS;
  float* sRing = sP + BQ * PS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tile first

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const KRange kr = k_range(p.causal, p.window, q0, BQ, p.Sq, p.Sk, kF32BK);
  const int total = max(kr.end - kr.start, 0) * 2 * NC;  // chunks

  // Chunk g: tile kr.start + g / (2 NC); its K columns CW c.. (c < NC),
  // then its V keys VK c.. . 16 bytes a copy; rows past Sk and columns past
  // D arrive as zeros.
  auto issue = [&](int g) {
    float* st = sRing + (g % NS) * Tile::kStageFloats;
    const int k0 = (kr.start + g / (2 * NC)) * kF32BK;
    const int part = g % (2 * NC);
#pragma unroll
    for (int u = 0; u < Tile::kCopies; ++u) {
      const int e = tid + NT * u;
      if (part < NC) {
        const int r = e / (CW / 4), f = 4 * (e % (CW / 4));
        const int col = CW * part + f, kpos = k0 + r;
        const bool ok = kpos < p.Sk && col < p.D;
        sm90::cp_async16(st + r * KS + f,
                         ok ? kg + kpos * p.k_ss + col : kg, ok ? 16 : 0);
      } else {
        const int r = e / (DT / 4), col = 4 * (e % (DT / 4));
        const int kpos = k0 + (part - NC) * VK + r;
        const bool ok = kpos < p.Sk && col < p.D;
        sm90::cp_async16(st + r * QS + col,
                         ok ? vg + kpos * p.v_ss + col : vg, ok ? 16 : 0);
      }
    }
  };

  // The q tile, unscaled (the scale folds into the exponent), with chunk 0.
  for (int e = tid; e < BQ * DT / 4; e += NT) {
    const int r = e / (DT / 4), col = 4 * (e % (DT / 4));
    const int qpos = q0 + r;
    const bool ok = qpos < p.Sq && col < p.D;
    sm90::cp_async16(sQ + r * QS + col, ok ? qg + qpos * p.q_ss + col : qg,
                     ok ? 16 : 0);
  }
#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {
    if (g < total) issue(g);
    sm90::cp_async_commit();
  }

  float s[RPT][8], o[RPT][NCOL], m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInfL2;
    l[i] = 0.f;  // this thread's partial row sum
#pragma unroll
    for (int c = 0; c < NCOL; ++c) o[i][c] = 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;

  for (int g = 0; g < total; ++g) {
    sm90::cp_async_wait<NS - 2>();
    __syncthreads();  // chunk g is in; every thread is done with chunk g-1
    if (g + NS - 1 < total) issue(g + NS - 1);
    sm90::cp_async_commit();
    const float* st = sRing + (g % NS) * Tile::kStageFloats;
    const int part = g % (2 * NC);
    if (part < NC) {  // S += Q[:, CW part ..] . K_chunk^T
      if (part == 0) {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      }
#pragma unroll 1
      for (int d = 0; d < CW; d += 4) {
        float4 kv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          kv[j] = sm90::lds4(st + (tx + 16 * j) * KS + d);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float4 qv = sm90::lds4(sQ + (ty + RG * i) * QS + CW * part + d);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
          }
        }
      }
      if (part == NC - 1) {
        // Online softmax of the tile in the log2 domain; P into sP. Masked
        // scores become NEG_INF (-inf past Sk) before the max, as on the
        // TPU; without a mask the scale folds into the exponent's FMA.
        const int k0 = (kr.start + g / (2 * NC)) * kF32BK;
        const bool mask = tile_needs_mask(p.causal, p.window, q0, BQ, k0,
                                          kF32BK, p.Sk);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int qpos = q0 + ty + RG * i;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float x = s[i][j];
            if (mask) {
              const int kpos = k0 + tx + 16 * j;
              const bool hidden =
                  p.causal && (qpos < kpos ||
                               (p.window > 0 && qpos - kpos >= p.window));
              x = kpos >= p.Sk ? -INFINITY
                               : (hidden ? kNegInfL2 : x * scale_log2);
              s[i][j] = x;
            }
            mx = fmaxf(mx, x);
          }
#pragma unroll
          for (int off = 1; off < 16; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[i], mask ? mx : mx * scale_log2);
          const float alpha = sm90::ex2(m[i] - m_new);
          m[i] = m_new;
          l[i] *= alpha;
#pragma unroll
          for (int c = 0; c < NCOL; ++c) o[i][c] *= alpha;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float pv = mask ? sm90::ex2(s[i][j] - m_new)
                                  : sm90::ex2(fmaf(s[i][j], scale_log2,
                                                   -m_new));
            l[i] += pv;
            sP[(ty + RG * i) * PS + tx + 16 * j] = pv;
          }
        }
      }
    } else {  // O += P[:, VK c ..] . V_chunk
      const float* pp = sP + (part - NC) * VK;
#pragma unroll 2
      for (int c = 0; c < VK; c += 4) {
        float4 pr[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          pr[i] = sm90::lds4(pp + (ty + RG * i) * PS + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 vv[NCOL / 4];
#pragma unroll
          for (int gg = 0; gg < NCOL / 4; ++gg)
            vv[gg] = sm90::lds4(st + (c + e) * QS + 64 * gg + 4 * tx);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float pe = e == 0 ? pr[i].x
                             : e == 1 ? pr[i].y
                             : e == 2 ? pr[i].z
                                      : pr[i].w;
#pragma unroll
            for (int gg = 0; gg < NCOL / 4; ++gg) {
              o[i][4 * gg] = fmaf(pe, vv[gg].x, o[i][4 * gg]);
              o[i][4 * gg + 1] = fmaf(pe, vv[gg].y, o[i][4 * gg + 1]);
              o[i][4 * gg + 2] = fmaf(pe, vv[gg].z, o[i][4 * gg + 2]);
              o[i][4 * gg + 3] = fmaf(pe, vv[gg].w, o[i][4 * gg + 3]);
            }
          }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int qpos = q0 + ty + RG * i;
    if (qpos >= p.Sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int gg = 0; gg < NCOL / 4; ++gg) {
      const int col = 64 * gg + 4 * tx;
      if (col < p.D) {
        *reinterpret_cast<float4*>(og + qpos * p.o_ss + col) =
            make_float4(o[i][4 * gg] * inv, o[i][4 * gg + 1] * inv,
                        o[i][4 * gg + 2] * inv, o[i][4 * gg + 3] * inv);
      }
    }
    if (tx == 0) {  // a row without a key: NEG_INF, exactly
      p.lse[(long long)bh * p.Sq + qpos] =
          m[i] == kNegInfL2 ? kNegInf : m[i] * kLn2 + logf(l[i]);
    }
  }
}

template <int DT>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  using Tile = F32Tile<DT>;
  auto kernel = flash_fwd_f32_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.H, (p.Sq + Tile::kBQ - 1) / Tile::kBQ);
  kernel<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch_f32<64>(p, stream);
  if (p.D <= 128) return launch_f32<128>(p, stream);
  return launch_f32<256>(p, stream);
}

// ------------------------------------- head dims above 256, every dtype --

// Forward for D > 256, any element type T (flash_wide.cuh gives the
// design). One block per (batch*head, 64-row q tile, 128-column slice of
// the head dim), heaviest causal tile first, with the k-loop bounds of the
// other kernels (k_range, 64-key steps). Each step: S over the whole head
// dim in 64-column chunks of Q and K; the online softmax of the tile in
// registers, in the log2 domain (rows reduced across the 16 lanes that
// hold them; l sums P unrounded), P rounded to T into shared memory; then
// O += P.V over the block's slice of V. Slice 0 writes lse.
template <typename T>
__global__ void __launch_bounds__(wide::kThreads)
flash_fwd_wide_kernel(const Params p) {
  using namespace wide;
  extern __shared__ float smem[];
  float* sQ = smem;        // a Q chunk, then (with sK) the V slice
  float* sK = sQ + kChunk;
  float* sV = smem;
  float* sP = sK + kChunk;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  const int s0 = blockIdx.z * kSlice;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const KRange kr = k_range(p.causal, p.window, q0, kRows, p.Sq, p.Sk, kRows);
  const float scale_log2 = p.scale * kLog2e;

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInfL2;
    l[i] = 0.f;  // this thread's partial row sum
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
  }

  for (int kt = kr.start; kt < kr.end; ++kt) {
    const int k0 = kt * kRows;
    float s[4][4] = {};
    for (int c0 = 0; c0 < p.D; c0 += kCW) {
      __syncthreads();  // every thread is done with the previous tiles
      load_tile<kCW, kCS>(sQ, qg, p.q_ss, q0, p.Sq, c0, p.D);
      load_tile<kCW, kCS>(sK, kg, p.k_ss, k0, p.Sk, c0, p.D);
      __syncthreads();
      f32_score_chunk<4, 4, kCW, kCS, kCS>(s, sQ, sK, tx, ty);
    }
    // Masked scores become NEG_INF (-inf past Sk) before the max, as on
    // the TPU: a select on every entry.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool hidden =
            p.causal && (qpos < kpos ||
                         (p.window > 0 && qpos - kpos >= p.window));
        const float x = kpos >= p.Sk ? -INFINITY
                        : hidden     ? kNegInfL2
                                     : s[i][j] * scale_log2;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = sm90::ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = sm90::ex2(s[i][j] - m_new);
        l[i] += pv;
        sP[(ty + 16 * i) * kCS + tx + 16 * j] = rounded<T>(pv);
      }
    }
    __syncthreads();  // every thread is done with the Q and K chunks
    load_tile<kSlice, kSS>(sV, vg, p.v_ss, k0, p.Sk, s0, p.D);
    __syncthreads();
    f32_product_chunk<4, 8, kRows, kCS, kSS>(o, sP, sV, tx, ty);
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
    store_slice_row(og + qpos * p.o_ss, o[i], 1.f / l[i], s0, p.D, tx);
    if (blockIdx.z == 0 && tx == 0) {  // a row without a key: NEG_INF
      p.lse[(long long)bh * p.Sq + qpos] =
          m[i] == kNegInfL2 ? kNegInf : m[i] * kLn2 + logf(l[i]);
    }
  }
}

template <typename T>
cudaError_t launch_wide(const Params& p, cudaStream_t stream) {
  using namespace wide;
  auto kernel = flash_fwd_wide_kernel<T>;
  const size_t smem = sizeof(float) * 3 * kChunk;
  static_assert(kSliceTile <= 2 * kChunk, "the V slice over Q and K");
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.H, (p.Sq + kRows - 1) / kRows,
            (p.D + kSlice - 1) / kSlice);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------ bf16 and f16, tensor cores --

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
template <typename T, int DT, int BK, int BQ>
__device__ __forceinline__ void qk_product(float (&sc)[BK / 2],
                                           uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    sm90::wgmma_ss<T>(
        sc, sm90::desc_sw128(q_addr + (kk >> 2) * BQ * 128 + off, 16, 1024),
        sm90::desc_sw128(k_addr + (kk >> 2) * BK * 128 + off, 16, 1024),
        kk > 0);
  }
}

// O += P.V, P as 16-bit register fragments, V (BK keys x DT) MN-major.
template <typename T, int DT, int BK>
__device__ __forceinline__ void pv_product(float (&o)[DT / 2],
                                           const uint32_t (&pa)[BK / 16][4],
                                           uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    sm90::wgmma_rs<T>(o, pa[kk],
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

template <typename T, int DT, int BK>
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

  const KRange kr = k_range(a.causal, a.window, q0, BQ, a.Sq, a.Sk, BK);
  const int kt_start = kr.start;
  const int n_it = max(kr.end - kr.start, 0);

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
      if (tile_needs_mask(a.causal, a.window, wq0, 64, k0, BK, a.Sk)) {
        online_softmax<BK / 2, true>(sc, m, l, alpha, a, k0, qr, cq);
      } else {
        online_softmax<BK / 2, false>(sc, m, l, alpha, a, k0, qr, cq);
      }
    };

    sm90::mbar_wait(qbar, 0);
    if (n_it > 0) {
      sm90::mbar_wait(&full[0], 0);
      sm90::wgmma_fence();
      qk_product<T, DT, BK, BQ>(sc, q_addr, kv_addr);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      softmax(0);
      sm90::to_a_frags<T>(sc, pa);
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
      qk_product<T, DT, BK, BQ>(sc, q_addr, kv_addr + s * 2 * Tile::kKVBytes);
      sm90::wgmma_commit();
      pv_product<T, DT, BK>(o, pa,
                         kv_addr + sp * 2 * Tile::kKVBytes + Tile::kKVBytes);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S_it is ready; P.V may still run
      sm90::fence_regs(sc);
      softmax(it);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      sm90::mbar_arrive(&empty[sp]);
      sm90::to_a_frags<T>(sc, pa);
    }
    if (n_it > 0) {
      const int sp = (n_it - 1) % NS;
#pragma unroll
      for (int i = 0; i < DT / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      sm90::wgmma_fence();
      pv_product<T, DT, BK>(o, pa,
                         kv_addr + sp * 2 * Tile::kKVBytes + Tile::kKVBytes);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
    }

    T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
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
          sm90::store2<T>(og + qpos * a.o_ss + col, o[4 * j + 2 * r] * inv,
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

template <typename T, int DT, int BK>
cudaError_t launch_16(Bf16Args& a, int B, const Params& p,
                      cudaStream_t stream) {
  using Tile = Bf16Tile<DT, BK>;
  if (!sm90_host::bshd_map<T>(&a.tq, p.q, B, p.Sq, p.H, p.D, p.q_sb, p.q_ss,
                              p.q_sh, Tile::kBQ) ||
      !sm90_host::bshd_map<T>(&a.tk, p.k, B, p.Sk, p.Hkv, p.D, p.k_sb,
                              p.k_ss, p.k_sh, BK) ||
      !sm90_host::bshd_map<T>(&a.tv, p.v, B, p.Sk, p.Hkv, p.D, p.v_sb,
                              p.v_ss, p.v_sh, BK)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_bf16_kernel<T, DT, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * p.H, (p.Sq + Tile::kBQ - 1) / Tile::kBQ);
  kernel<<<grid, kWgThreads, Tile::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_16(const Params& p, cudaStream_t stream) {
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
  if (p.D <= 64) return launch_16<T, 64, 128>(a, p.B, p, stream);
  if (p.D <= 128) return launch_16<T, 128, 128>(a, p.B, p, stream);
  return launch_16<T, 256, 64>(a, p.B, p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Strides are in elements.
// Returns the cudaError_t of the launch (0 = launched); the caller checks
// it.
extern "C" int tpunet_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int H, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, int dtype, void* stream) {
  if (D < 8 || D % 8 || Hkv <= 0 || H % Hkv) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  Params p{q,    k,    v,    o,    lse,  B,    H,    Hkv,
           Sq,   Sk,   D,    q_sb, q_ss, q_sh, k_sb, k_ss,
           k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal,
           window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 256) {
    if (dtype == 0) return (int)launch_wide<float>(p, s);
    if (dtype == 1) return (int)launch_wide<__nv_bfloat16>(p, s);
    if (dtype == 2) return (int)launch_wide<__half>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return (int)dispatch_f32(p, s);
  if (dtype == 1) return (int)dispatch_16<__nv_bfloat16>(p, s);
  if (dtype == 2) return (int)dispatch_16<__half>(p, s);
  return (int)cudaErrorInvalidValue;
}
