// Flash-attention forward for Hopper (sm_90a), plain C ABI for ctypes: one
// entry point, four kernels by dtype and head dim (bf16/f16 on the tensor
// cores, f32 on the CUDA cores; up to head dim 256 and above it).
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
// Head dims above 256 (the wide route). What bounds it: at D320 B1 S1024
// H16 Hkv4 causal the forward is 10.7 GFLOP against ~10 MB: the tensor
// cores for bf16/f16 (0.011 ms at 989 TFLOP/s), the FMA pipe for f32 (0.16
// ms at 67 TFLOP/s). No tile of the kernels above fits: Q for 128 rows is
// 80 KiB at D = 320 and grows with D, and a 64 x D f32 O is more than a
// warpgroup's registers above D = 256. Both designs split O's columns into
// spans and form the scores once for all of them:
//   * bf16/f16, flash_fwd_wide_bf16_kernel<T> (wgmma + TMA): one block per
//     (batch*head, 64-row q tile), heaviest causal tile first, 64-key
//     steps with the other kernels' k-loop bounds. The two consumer
//     warpgroups share the q tile: each forms the partial S over its half
//     of the head dim's 64-column chunks (SS-wgmma, K-major as stored), they
//     swap the partial sums through shared memory (s0 + s1 in both, so both
//     hold the same bits), both run the same online softmax on the
//     fragments, and each adds P.V into its own span of at most four
//     64-column chunks (RS-wgmma, P rounded to T in registers, V read
//     MN-major). So the scores are formed once a block, and a block covers
//     up to eight chunks (D <= 512); above that, grid.z takes groups of at
//     most eight chunks and each group's block forms the scores itself
//     (D = 576: two groups, 1.5x the counted FLOPs). Nothing is resident:
//     every 64 x 64 tile (Q and K chunks for the scores, V chunks for the
//     products) streams through a 10-tile TMA ring per warpgroup, filled by
//     one producer thread, so no head dim is too wide. Each warpgroup
//     releases a score chunk as soon as its product is done and keeps one
//     step of V; the P.V of step t - 1 is issued behind the scores of step
//     t, so the exponentials of step t run while the tensor cores add it.
//   * f32, flash_fwd_wide_f32_kernel (CUDA cores, exact f32 FMA, no TF32):
//     flash_fwd_f32_kernel's design with a span axis: one 256-thread block
//     per (batch*head, 64-row q tile, 128-column span of O), 128-key
//     steps, 4 x 8 register tiles of S and O a thread, the FMA loops of
//     f32_fma.cuh. The span blocks of a q tile run as one thread-block
//     cluster (at most 8; grid.z padded to a multiple, a block past D only
//     helps with the scores) and form the scores once a cluster: block r
//     forms the partial S over its share of the d-chunks, each block sums
//     its share of S's entries over the cluster's partials in rank order
//     and the cluster gathers the sums through distributed shared memory,
//     so every block holds the same bits and reads about two tiles a step
//     whatever the cluster's size. (The backward's dQ splits the keys
//     instead, because a dQ row that sees one key is a cancellation in
//     dP; the forward has none: a partial sum per block moves S by an ulp,
//     and every block sees the same S.) Nothing is resident: each step's
//     own d-chunks of Q and K and the span's V chunks stream through a
//     3-stage cp.async ring. Up to D = 1024 (eight spans, one cluster a
//     tile) the work is the counted FLOPs plus the zero columns of a last
//     span past D (D = 320: 1.1x). That is the layout's boundary: above it
//     clusters stay at 8 (f32_cluster.cuh), grid.z is rounded up to a
//     multiple of 8, and each cluster forms the scores itself, its blocks
//     past D only helping (D = 1160: two clusters, 1.6x).
// Both keep every rule above: lse (B*H, Sq) f32, rows without a key, masks
// as a select, heaviest tile first, no atomics, bitwise deterministic.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_cluster.cuh"
#include "f32_fma.cuh"
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

// ----------------------------- head dims above 256: f32, CUDA cores --

constexpr int kWideRows = 64;    // flash_fwd_wide_f32_kernel's q rows a block
constexpr int kWideSpan = 128;   // its output columns a block
constexpr int kWideCW = 64;      // d-chunk columns
constexpr int kWideCS = kWideCW + 4;      // d-chunk rows (Q, then K)
constexpr int kWidePS = kF32BK + 4;       // partial-score and P rows
constexpr int kWideVK = 64;               // keys a V chunk
constexpr int kWideVS = kWideSpan + 4;    // V chunk rows
constexpr int kWideStages = 3;            // the cp.async ring
// A stage: a d-chunk (64 q rows, then 128 keys, 64 columns) or a V chunk
// (64 keys x the span's 128 columns).
constexpr int kWideStage = (kWideRows + kF32BK) * kWideCS;
static_assert(kWideVK * kWideVS <= kWideStage, "V chunk over its stage");
constexpr size_t kWideSmem =  // partial scores (then P), sums, the ring
    sizeof(float) * (2 * kWideRows * kWidePS + kWideStages * kWideStage);
static_assert(kWideSmem <= 232448, "over the 227 KB a block may use");

// The score tile s (kWideRows x 128, this thread's entries at rows
// ty + 16i and keys tx + 16j) made whole from each cluster block's
// partial: each block stores its own in sp, then sums its share of the
// tile's entries (entry e = 128 row + key belongs to block e CN / 8192)
// over every block's partial in rank order into ss, and after a second
// cluster barrier reads each entry from its owner's ss. Every entry is one
// sum in rank order, so every block holds the same bits, and a block
// reads about two tiles through distributed shared memory whatever the
// cluster's size. sp is free on return; ss is read by the cluster until
// the next call's first barrier (and the kernel's last one).
__device__ __forceinline__ void cluster_scores(float (&s)[4][8], float* sp,
                                               float* ss, int tx, int ty) {
  namespace cg = cooperative_groups;
  constexpr int kEntries = kWideRows * kF32BK;
  cg::cluster_group cl = cg::this_cluster();
  const unsigned cn = cl.num_blocks(), rank = cl.block_rank();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sp[(ty + 16 * i) * kWidePS + tx + 16 * j] = s[i][j];
  cl.sync();  // every block's partial is stored
  // The block's entries [lo, hi), at most kPer a thread (clusters of 3 or
  // more: D > 256 has at least 3 spans).
  constexpr int kPer = (kEntries / 3 + 256) / 256;
  const int lo = (rank * kEntries + cn - 1) / cn;
  const int hi = ((rank + 1) * kEntries + cn - 1) / cn;
  float sum[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) sum[u] = 0.f;
#pragma unroll 1
  for (unsigned r = 0; r < cn; ++r) {
    const uint32_t base = sm90::cluster_addr(sm90::smem_u32(sp), r);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = lo + threadIdx.x + 256 * u;
      if (e < hi) {
        sum[u] += sm90::ld_cluster(base +
                                   4 * ((e >> 7) * kWidePS + (e & 127)));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = lo + threadIdx.x + 256 * u;
    if (e < hi) ss[(e >> 7) * kWidePS + (e & 127)] = sum[u];
  }
  cl.sync();  // every entry's sum is stored
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = ty + 16 * i, key = tx + 16 * j;
      const unsigned owner = ((row * kF32BK + key) * cn) / kEntries;
      s[i][j] = sm90::ld_cluster(sm90::cluster_addr(
          sm90::smem_u32(ss + row * kWidePS + key), owner));
    }
}

// R rows pos0..pos0+R-1 of one head (src at the head, row stride ss), W
// head-dim columns from c0, into R rows of row stride LD: 16 bytes a copy,
// zeros past row lim or column D.
template <int R, int W, int LD>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long ss, int pos0, int lim,
                                          int c0, int D) {
#pragma unroll
  for (int u = 0; u < R * W / 4 / 256; ++u) {
    const int e = threadIdx.x + 256 * u;
    const int r = e / (W / 4), cc = 4 * (e % (W / 4));
    const int pos = pos0 + r, col = c0 + cc;
    const bool ok = pos < lim && col < D;
    sm90::cp_async16(dst + r * LD + cc, ok ? src + pos * ss + col : src,
                     ok ? 16 : 0);
  }
}

// f32 forward for D > 256 (the design notes at the top). Thread (ty, tx)
// owns q rows ty + 16i (i < 4), the step's keys tx + 16j (j < 8) and the
// span's columns 64g + 4tx + e (g < 2, e < 4). Each step: block r's
// d-chunks of S (Q and K chunks), cluster_scores, the online softmax of
// the tile in the log2 domain (rows reduced across the 16 lanes that hold
// them, a select on every masked entry), P into the score tile, then
// O += P.V over the span in two 64-key V chunks.
__global__ void __launch_bounds__(256, 1)
flash_fwd_wide_f32_kernel(const Params p) {
  constexpr int NS = kWideStages, SF = kWideStage, RQ = kWideRows;
  constexpr int CS = kWideCS, PS = kWidePS, VS = kWideVS;

  extern __shared__ float smem[];
  float* sP = smem;  // the block's partial scores, then P
  float* sS = sP + RQ * PS;  // the sums of the block's share of the scores
  float* sRing = sS + RQ * PS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * RQ;  // heaviest tile first
  const int s0 = kWideSpan * blockIdx.z;  // the span's first column
  const bool has_span = s0 < p.D;
  const int2 own = own_chunks<kWideCW>(p.D);
  const int cd0 = own.x, ncd = own.y;
  const int per = ncd + (has_span ? kF32BK / kWideVK : 0);  // chunks a step
  const KRange kr = k_range(p.causal, p.window, q0, RQ, p.Sq, p.Sk, kF32BK);
  const int total = max(kr.end - kr.start, 0) * per;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Chunk g of step g / per: the block's d-chunks (Q, then K), then the
  // span's V chunks.
  auto issue = [&](int g) {
    float* st = sRing + (g % NS) * SF;
    const int k0 = (kr.start + g / per) * kF32BK;
    const int part = g % per;
    if (part < ncd) {
      const int c0 = kWideCW * (cd0 + part);
      copy_rows<RQ, kWideCW, CS>(st, qg, p.q_ss, q0, p.Sq, c0, p.D);
      copy_rows<kF32BK, kWideCW, CS>(st + RQ * CS, kg, p.k_ss, k0, p.Sk, c0,
                                     p.D);
    } else {
      copy_rows<kWideVK, kWideSpan, VS>(st, vg, p.v_ss,
                                        k0 + kWideVK * (part - ncd), p.Sk,
                                        s0, p.D);
    }
  };
#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {
    if (g < total) issue(g);
    sm90::cp_async_commit();
  }

  float s[4][8], o[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInfL2;
    l[i] = 0.f;  // this thread's partial row sum
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;

  for (int g = 0; g < total; ++g) {
    sm90::cp_async_wait<NS - 2>();
    __syncthreads();  // chunk g is in; every thread is done with chunk g-1
    if (g + NS - 1 < total) issue(g + NS - 1);
    sm90::cp_async_commit();
    const float* st = sRing + (g % NS) * SF;
    const int part = g % per;
    if (part < ncd) {
      f32_score_chunk<4, 8, kWideCW, CS, CS>(s, st, st + RQ * CS, tx, ty,
                                             part == 0);
      if (part == ncd - 1) {
        cluster_scores(s, sP, sS, tx, ty);
        // Online softmax of the tile; masked scores become NEG_INF (-inf
        // past Sk) before the max, as on the TPU; without a mask the scale
        // folds into the exponent's FMA.
        const int k0 = (kr.start + g / per) * kF32BK;
        const bool mask = tile_needs_mask(p.causal, p.window, q0, RQ, k0,
                                          kF32BK, p.Sk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = q0 + ty + 16 * i;
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
          for (int c = 0; c < 8; ++c) o[i][c] *= alpha;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float pv = mask ? sm90::ex2(s[i][j] - m_new)
                                  : sm90::ex2(fmaf(s[i][j], scale_log2,
                                                   -m_new));
            l[i] += pv;
            sP[(ty + 16 * i) * PS + tx + 16 * j] = pv;
          }
        }
      }
    } else {  // O += P[:, 64 c ..] . V_chunk
      f32_product_chunk<4, 8, kWideVK, PS, VS>(
          o, sP + kWideVK * (part - ncd), st, tx, ty);
    }
  }
  sm90::cp_async_wait<0>();
  cooperative_groups::this_cluster().sync();  // no block reads sS any more
  if (!has_span) return;

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int gg = 0; gg < 2; ++gg) {
      const int col = s0 + 64 * gg + 4 * tx;
      if (col < p.D) {
        *reinterpret_cast<float4*>(og + qpos * p.o_ss + col) =
            make_float4(o[i][4 * gg] * inv, o[i][4 * gg + 1] * inv,
                        o[i][4 * gg + 2] * inv, o[i][4 * gg + 3] * inv);
      }
    }
    if (blockIdx.z == 0 && tx == 0) {  // a row without a key: NEG_INF
      p.lse[(long long)bh * p.Sq + qpos] =
          m[i] == kNegInfL2 ? kNegInf : m[i] * kLn2 + logf(l[i]);
    }
  }
}

// Launches flash_fwd_wide_f32_kernel: cdiv(D, 128) spans, in clusters of
// f32_cluster.cuh's policy.
cudaError_t launch_wide_f32(const Params& p, cudaStream_t stream) {
  const int nsp = (p.D + kWideSpan - 1) / kWideSpan;
  const dim3 grid(p.B * p.H, (p.Sq + kWideRows - 1) / kWideRows, nsp);
  return launch_clusters(flash_fwd_wide_f32_kernel, grid, 256, kWideSmem, p,
                         stream, span_cluster(nsp));
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

// ------------------------ head dims above 256: bf16 and f16, tensor cores --

// Shared memory of flash_fwd_wide_bf16_kernel: a ring of kItems 64 x 64
// 16-bit tiles for each consumer warpgroup, the two warpgroups' partial
// scores (f32 fragments) for two step parities, and each ring's barriers.
struct WideFwdTile {
  static constexpr int kItem = 64 * 128;  // one 64 x 64 16-bit tile, bytes
  // A warpgroup holds at most one step's V (kSpan tiles) and two score
  // chunks (Q and K each) at once; two more let the next chunk land.
  static constexpr int kItems = 10;
  static constexpr int kSpan = 4;  // 64-column chunks a warpgroup's span
  static constexpr int kRings = 2 * kItems * kItem;
  static constexpr int kSwap = 2 * 2 * 32 * 128 * 4;
  static constexpr size_t kSmem =  // slack, rings, partial scores, barriers
      1024 + kRings + kSwap + 8 * 2 * 2 * kItems;
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// bf16/f16 forward for D > 256 (the design notes at the top). The block
// owns q rows q0..q0+63 and the output chunks [gb, gb + gn), blockIdx.z's
// share of the cdiv(D, 64) chunks split evenly over gridDim.z groups of at
// most 2 kSpan; warpgroup 0 adds P.V into the first gn / 2 of them,
// warpgroup 1 into the rest. Warpgroup 0 forms the partial scores over the
// chunks [0, nch / 2), warpgroup 1 over the rest. The producer thread
// puts into warpgroup w's ring, alternating between the rings, step 0's
// score chunks (Q, then K), then for each later step t its score chunks
// and step t - 1's V chunks, and last the last step's V: a warpgroup uses
// step t - 1's V after step t's scores, and the ring is a FIFO, so this
// order lets it hold one step's V and still stream any number of score
// chunks.
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wide_bf16_kernel(const __grid_constant__ Bf16Args a) {
  using W = WideFwdTile;
  constexpr int NS = W::kItems;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  float* sX = reinterpret_cast<float*>(base + W::kRings);
  uint64_t* full =  // ring w's slot s: full[w NS + s]
      reinterpret_cast<uint64_t*>(base + W::kRings + W::kSwap);
  uint64_t* empty = full + 2 * NS;

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;  // heaviest tile first
  const int nch = (a.D + 63) / 64;
  const int nc0 = nch / 2, nc1 = nch - nc0;  // score chunks a warpgroup
  const int gb = blockIdx.z * nch / gridDim.z;
  const int gn = (blockIdx.z + 1) * nch / gridDim.z - gb;
  const int ns0 = gn / 2, ns1 = gn - ns0;  // span chunks a warpgroup
  const KRange kr = k_range(a.causal, a.window, q0, 64, a.Sq, a.Sk, 64);
  const int n_it = max(kr.end - kr.start, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * NS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int put0 = 0, put1 = 0;  // tiles put into each ring
      auto put = [&](int w, int& n, const CUtensorMap* map, int c, int row,
                     int head) {
        const int s = w * NS + n % NS;
        sm90::mbar_wait(&empty[s], ((n / NS) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], W::kItem);
        sm90::tma_load_4d(base + s * W::kItem, map, &full[s], 64 * c, row,
                          head, b);
        ++n;
      };
      for (int t = 0; t <= n_it; ++t) {
        const int k0 = (kr.start + t) * 64;
        for (int i = 0; i < nc1 && t < n_it; ++i) {
          if (i < nc0) {
            put(0, put0, &a.tq, i, q0, h);
            put(0, put0, &a.tk, i, k0, hk);
          }
          put(1, put1, &a.tq, nc0 + i, q0, h);
          put(1, put1, &a.tk, nc0 + i, k0, hk);
        }
        for (int j = 0; j < ns1 && t > 0; ++j) {
          if (j < ns0) put(0, put0, &a.tv, gb + j, k0 - 64, hk);
          put(1, put1, &a.tv, gb + ns0 + j, k0 - 64, hk);
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  const int wg = threadIdx.x >> 7;
  const int t128 = threadIdx.x & 127;
  const int warp = t128 >> 5;
  const int lane = t128 & 31;
  const int qr = q0 + warp * 16 + (lane >> 2);  // rows qr, qr + 8
  const int cq = 2 * (lane & 3);                // column in an 8-group
  const int nc = wg ? nc1 : nc0;                // the warpgroup's
  const int ns = wg ? ns1 : ns0;                // score and span chunks
  const int sb = gb + (wg ? ns0 : 0);           // its span's first chunk
  const int per = 2 * nc + ns;                  // its tiles a step
  // The ring's tile numbers of step t's first score tile and first V tile.
  auto s_tile = [&](int t) { return t > 0 ? (t - 1) * per + 2 * nc : 0; };
  auto v_tile = [&](int t) {
    return t * per + 2 * nc + (t + 1 < n_it ? 2 * nc : 0);
  };
  const uint32_t ring = sm90::smem_u32(base) + wg * NS * W::kItem;
  uint64_t* fullw = full + wg * NS;
  uint64_t* emptyw = empty + wg * NS;
  auto tile = [&](int n) { return ring + (n % NS) * W::kItem; };
  auto arrived = [&](int n) { sm90::mbar_wait(&fullw[n % NS], (n / NS) & 1); };
  auto release = [&](int n) { sm90::mbar_arrive(&emptyw[n % NS]); };

  float acc[W::kSpan][32];
#pragma unroll
  for (int j = 0; j < W::kSpan; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  float m[2] = {kNegInfL2, kNegInfL2};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums
  float alpha[2];
  float sc[32];
  uint32_t pa[4][4];

  // O = O alpha + P.V over the span, step t's V tiles, P in pa.
  auto pv = [&](int t) {
#pragma unroll
    for (int j = 0; j < W::kSpan; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] *= alpha[(i >> 1) & 1];
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < W::kSpan; ++j) {
      if (j < ns) {
        const int n = v_tile(t) + j;
        arrived(n);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sm90::wgmma_rs<T>(acc[j], pa[kk],
                            sm90::desc_sw128(tile(n) + kk * 2048, 8192, 1024));
        }
      }
    }
    sm90::wgmma_commit();
  };
  auto pv_done = [&](int t) {
#pragma unroll
    for (int j = 0; j < W::kSpan; ++j) sm90::fence_regs(acc[j]);
    sm90::fence_regs(pa);
    for (int j = 0; j < ns; ++j) release(v_tile(t) + j);
  };

  for (int t = 0; t < n_it; ++t) {
    const int n0 = s_tile(t);
    // The partial scores over the warpgroup's chunks; each chunk's tiles
    // go back to the producer once its product is done.
    for (int i = 0; i < nc; ++i) {
      arrived(n0 + 2 * i);
      arrived(n0 + 2 * i + 1);
      const uint32_t qa = tile(n0 + 2 * i), ka = tile(n0 + 2 * i + 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_ss<T>(sc, sm90::desc_sw128(qa + 32 * kk, 16, 1024),
                          sm90::desc_sw128(ka + 32 * kk, 16, 1024),
                          i > 0 || kk > 0);
      }
      sm90::wgmma_commit();
      if (i > 0) {
        sm90::wgmma_wait<1>();  // chunk i - 1 is done
        release(n0 + 2 * i - 2);
        release(n0 + 2 * i - 1);
      }
    }
    // The last step's P.V goes in behind the scores and runs on while the
    // scores are swapped and their exponentials taken.
    if (t > 0) {
      pv(t - 1);
      sm90::wgmma_wait<1>();
    } else {
      sm90::wgmma_wait<0>();
    }
    sm90::fence_regs(sc);
    release(n0 + 2 * nc - 2);
    release(n0 + 2 * nc - 1);

    // S = the two warpgroups' partial sums, the same bits in both.
    float* mine = sX + ((t & 1) * 2 + wg) * 32 * 128;
    const float* theirs = sX + ((t & 1) * 2 + (wg ^ 1)) * 32 * 128;
#pragma unroll
    for (int i = 0; i < 32; ++i) mine[i * 128 + t128] = sc[i];
    sm90::bar_sync<1, 256>();  // the consumers only
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] += theirs[i * 128 + t128];

    const int k0 = (kr.start + t) * 64;
    if (tile_needs_mask(a.causal, a.window, q0, 64, k0, 64, a.Sk)) {
      online_softmax<32, true>(sc, m, l, alpha, a, k0, qr, cq);
    } else {
      online_softmax<32, false>(sc, m, l, alpha, a, k0, qr, cq);
    }
    if (t > 0) {
      sm90::wgmma_wait<0>();
      pv_done(t - 1);
    }
    sm90::to_a_frags<T>(sc, pa);
  }
  if (n_it > 0) {
    pv(n_it - 1);
    sm90::wgmma_wait<0>();
    pv_done(n_it - 1);
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
    for (int j = 0; j < W::kSpan; ++j) {
      if (j < ns) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = 64 * (sb + j) + 8 * jj + cq;
          if (col < a.D) {
            sm90::store2<T>(og + qpos * a.o_ss + col,
                            acc[j][4 * jj + 2 * r] * inv,
                            acc[j][4 * jj + 2 * r + 1] * inv);
          }
        }
      }
    }
    if (wg == 0 && blockIdx.z == 0 && (lane & 3) == 0) {  // NEG_INF: no key
      a.lse[(long long)bh * a.Sq + qpos] =
          m[r] == kNegInfL2 ? kNegInf : m[r] * kLn2 + logf(l[r]);
    }
  }
}

// One block per (batch*head, 64-row q tile, group of at most 2 kSpan
// chunks of the head dim).
template <typename T>
cudaError_t launch_wide_16(Bf16Args& a, const Params& p,
                           cudaStream_t stream) {
  using W = WideFwdTile;
  if (!sm90_host::bshd_map<T>(&a.tq, p.q, p.B, p.Sq, p.H, p.D, p.q_sb,
                              p.q_ss, p.q_sh, 64) ||
      !sm90_host::bshd_map<T>(&a.tk, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb,
                              p.k_ss, p.k_sh, 64) ||
      !sm90_host::bshd_map<T>(&a.tv, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb,
                              p.v_ss, p.v_sh, 64)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_wide_bf16_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::kSmem);
  if (err != cudaSuccess) return err;
  const int nch = (p.D + 63) / 64;
  dim3 grid(p.B * p.H, (p.Sq + 63) / 64,
            (nch + 2 * W::kSpan - 1) / (2 * W::kSpan));
  kernel<<<grid, kWgThreads, W::kSmem, stream>>>(a);
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
  if (p.D > 256) return launch_wide_16<T>(a, p, stream);
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
  if (dtype == 0) {
    return (int)(D > 256 ? launch_wide_f32(p, s) : dispatch_f32(p, s));
  }
  if (dtype == 1) return (int)dispatch_16<__nv_bfloat16>(p, s);
  if (dtype == 2) return (int)dispatch_16<__half>(p, s);
  return (int)cudaErrorInvalidValue;
}
