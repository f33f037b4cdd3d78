// Flash-attention backward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Two TPU kernels of tpunet/ops/flash_attention.py are replaced here:
//   * _flash_dq_kernel (:136, launched by _flash_bwd at :438) by
//     flash_dq_bf16_kernel (bf16, f16, D <= 256), flash_dq_wide_bf16_kernel
//     (bf16, f16, D > 256), flash_dq_f32_kernel (f32, D <= 256) and
//     flash_dq_wide_f32_kernel (f32, D > 256): dQ_i = sum_j dS_ij K_j, one
//     block per (batch*head, q tile), K/V tiles streamed through shared
//     memory with the forward's causal and sliding-window k-loop bounds;
//   * _flash_dkv_kernel (:183, launched at :464) by flash_dkv_bf16_kernel
//     (bf16, f16, D <= 128), flash_dkv_bf16_dsplit_kernel (bf16, f16,
//     128 < D <= 256), flash_dkv_wide_bf16_kernel (bf16, f16, D > 256),
//     flash_dkv_f32_kernel (f32, D <= 256) and flash_dkv_wide_f32_kernel
//     (f32, D > 256):
//     dV_j = sum_i P_ij^T dO_i, dK_j = sum_i dS_ij^T Q_i, one block per
//     (batch*kv head, k tile), looping over the GQA group's q heads and the
//     q tiles (causal start k0 / BQ, window end
//     min(n_qt, cdiv(k0 + BK - 1 + window, BQ))). The whole group is summed
//     inside the block in f32 and dK/dV are written once: no atomics, and
//     the group and q loops run in a fixed order, so the result is bitwise
//     deterministic run to run. Each dQ block owns its rows and walks its
//     k tiles in order, so dQ is bitwise deterministic too.
// Head dims above 256 put a span of the output's columns on grid.z (the
// notes below).
// Every grid puts batch * heads on grid.x (up to 2^31 - 1 blocks).
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
// Tensor cores (flash_dq_bf16_kernel, flash_dkv_bf16_kernel,
// flash_dkv_bf16_dsplit_kernel), every 16-bit head dim, with the element
// type T (__nv_bfloat16 or __half) a template parameter. For bf16
// inputs the TPU kernels run Precision.DEFAULT (_dot_precision, :267-272):
// one bf16 MXU pass, so P and dS enter their products rounded to bf16 and
// every product accumulates in f32; here every product is a wgmma with
// 16-bit operands and f32 accumulators, and P and dS are rounded to T in
// registers (f16's 11-bit significand keeps them closer to the JAX
// reference's f32 arithmetic on f16 inputs than bf16 does). Tiles arrive
// by TMA into the 128-byte swizzled layout wgmma reads (sm90.cuh); one
// producer warp issues the copies, two consumer warpgroups run the
// products, and setmaxnreg gives the consumers 232 registers (the
// producer 40).
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
//     through the transpose bit;
//   * the masks (causal, window, ragged q rows) are a select on every
//     score entry, never a branch: compiled as a branch per entry, the
//     same arithmetic took 1.3x as long at the training shape.
//
// Head dims 128 < D <= 256 (zero-filled by TMA up to 256). What bounds
// them: at B2 S2048 H16 D256 causal, the work of the training shape, dQ is
// 103 GFLOP and dK/dV 137 GFLOP against ~170 / ~200 MB: the tensor cores,
// 0.104 / 0.139 ms. The D <= 128 designs do not fit at 256: Q and dO for
// 128 rows take 128 KiB, leaving room for one 64-key K/V stage, and a
// 64 x 256 f32 dK plus dV is 256 registers a thread. What the design does:
//   * flash_dq_bf16_kernel<256> keeps the dQ design with 32-key K/V tiles
//     (three 32 KiB stages beside Q and dO: 225 KiB a block). S and dP are
//     m64n32 SS-wgmma over 16 k16 steps, dQ += dS.K one m64n256 RS-wgmma
//     per 16 keys, K read MN-major with LBO = 32 keys x 128 B = 4096 bytes
//     to the next 64 head-dim columns. A thread holds dQ (128 f32), S and
//     dP (16 + 16) and dS (8). The narrow score products issue four times
//     as many wgmma per FLOP as the dQ product does.
//   * flash_dkv_bf16_dsplit_kernel splits the head dim between
//     the two consumer warpgroups: one block per (batch*kv head, 64-row k
//     tile), K and V resident (32 KiB each), 32-row Q/dO tiles through a
//     3-stage ring (195 KiB a block). Warpgroup 0 forms S^T, warpgroup 1
//     dP^T (m64n32 SS-wgmma over all of D), they swap them through 2 x 16
//     KiB of shared memory, and warpgroup w adds P^T.dO and dS^T.Q into
//     its 128 columns of dV and dK (m64n128 RS-wgmma, LBO = 32 rows x
//     128 B). Each step is a chain (scores, wait, swap, exponentials,
//     dK/dV products, wait) with no overlap inside a warpgroup. It shares
//     the block set-up, the producer warp, the exponentials, masks and dK/dV
//     products, the no-key dV term and the store with flash_dkv_bf16_kernel
//     (DkvBlock, dkv_produce, dkv_consume); only the score products differ.
//
// f32 runs on the CUDA cores, every product an exact f32 FMA (no TF32, no
// 3xTF32), the counterpart of Precision.HIGHEST for f32 inputs.
//
// flash_dkv_f32_kernel. What bounds it: at the training shape dK/dV is 137
// GFLOP, 68.7 G FMA, against ~400 MB: the FMA pipe, 2.05 ms at 67
// TFLOP/s. Shared memory delivers 128 bytes a clock to an SM whose 128
// lanes issue 128 FMAs a clock, so the design is about operand reuse,
// occupancy and overlap:
//   * one 256-thread block (8 warps, one block an SM) per (batch*kv head,
//     64-row k tile; 32 rows at D = 256), the heaviest causal tile first;
//     K and V resident;
//   * each thread keeps 4 x 8 tiles of S^T and dP^T (4 k rows x 8 q
//     columns) and 4 x DT/16 tiles of dK and dV in registers; every operand
//     is a 16-byte shared load: 4 K loads and 8 Q loads feed 128 FMAs of
//     S^T = K.Q^T read along D from row-major tiles (dP^T = V.dO^T the
//     same), 4 P^T loads and 8 dO loads feed 128 FMAs of dV += P^T.dO
//     (dK += dS^T.Q the same); rows padded by 4 floats keep the loads free
//     of bank conflicts, and nothing is transposed in shared memory;
//   * each step's Q and dO (128 q rows of one head) stream as 8192-float
//     chunks through a 2-stage cp.async ring, 16 bytes a copy: as 64-column
//     d-chunks for S^T and dP^T, then as row chunks for dV and dK, so the
//     next chunk loads while this one's FMAs run; zero-size copies fill
//     ragged rows and columns past D. (Against 4 stages of 32 columns, the
//     half as many block barriers took 10 % off at the training shape.)
//   * P^T and dS^T go through shared memory to the threads that own their
//     dK/dV columns; the masks are a select on every entry.
//
// flash_dq_f32_kernel. What bounds it: at the training shape dQ is 103
// GFLOP, 51.5 G FMA, against ~340 MB: the FMA pipe, 1.54 ms at 67
// TFLOP/s. The design is flash_dkv_f32_kernel's with the roles of q and k
// swapped, and shares its inner loops:
//   * one 256-thread block per (batch*head, 64-row q tile; 32 rows at
//     D = 256), each head's tiles one after another, heaviest first; Q and
//     dO resident;
//   * each thread keeps 4 x 8 tiles of S and dP (4 q rows x 8 keys) and a
//     4 x DT/16 tile of dQ in registers; 4 Q loads and 8 K loads feed 128
//     FMAs of S = Q.K^T along D (dP = dO.V^T the same), 4 dS loads and 8 K
//     loads feed 128 FMAs of dQ += dS.K;
//   * each step's K and V (128 keys) stream through the 2-stage cp.async
//     ring: as 64-column d-chunks for S and dP, then K again as row chunks
//     for dQ, read along D from row-major K: no transposed copy, and the
//     next chunk loads while this one's FMAs run;
//   * dS goes through a padded shared tile to the threads that own its dQ
//     columns; the masks are a select on every entry.
//
// Head dims above 256 (the wide route). What bounds it: at D320 B1 S1024
// H16 Hkv4 causal dK/dV is 21.5 GFLOP and dQ 16.1 GFLOP against ~12 MB:
// the tensor cores for bf16/f16 (0.022 / 0.016 ms), the FMA pipe for f32
// (0.32 / 0.24 ms). No layout of the D <= 256 kernels fits: K and V for
// 64 rows take 80 KiB at D = 320 and grow with D, and a 64 x D f32 dK plus
// dV (or 128 x D dQ) does not fit in registers. What the design does:
//   * a block owns a span of the output's columns, on grid.z, and needs
//     the scores over the whole head dim;
//   * bf16/f16 (flash_dq_wide_bf16_kernel, flash_dkv_wide_bf16_kernel, one
//     function, wide_bwd_block): every span block forms the scores itself,
//     so the work is the counted FLOPs times (nsp + 1) / 2 for dK/dV and
//     (2 nsp + 1) / 3 for dQ with nsp spans (D = 320: two spans, 1.5x and
//     1.67x, where the 128-column slices before this design gave 2x and
//     2.33x). Spans of at most four 64-column chunks, the cdiv(D, 64)
//     chunks split evenly (D = 320: 2 + 3 chunks; TMA zero-fills the last
//     chunk past D, so every D that is a multiple of 8 runs). Nothing is
//     resident: each step streams every operand through a 5-stage TMA
//     ring, one 64-column chunk of all four 64-row tiles a stage, the
//     span's chunks last, held for the products; so no head dim is too
//     wide. Warpgroup 0 forms S^T (dK/dV) or S (dQ) and P, warpgroup 1 dP^T
//     or dP and dS from warpgroup 0's P (f32 through shared memory), all
//     products wgmma with P and dS rounded to T in registers; dK/dV:
//     warpgroup 0 dV, warpgroup 1 dK over the span; dQ: warpgroup 1 dQ
//     while warpgroup 0 starts the next step's scores;
//   * f32 (flash_dkv_wide_f32_kernel, flash_dq_wide_f32_kernel<CN>): the
//     f32 kernels' design on the CUDA cores (the FMA loops of f32_fma.cuh,
//     a cp.async ring) with a span axis, nothing resident (the operand the
//     D <= 256 kernels keep resident streams beside each d-chunk), and the
//     scores formed once a cluster instead of once a span: the span blocks
//     of a tile run as one thread-block cluster and share the scores
//     through distributed shared memory. dK/dV (128-column spans, 64 k
//     rows, a 3-stage ring) splits the d-chunks of S^T and dP^T over the
//     cluster and adds the partial sums in rank order; dQ (192-column
//     spans, 64 q rows, clusters of 2, 4 or 8) splits each step's keys, so
//     that every dP entry stays one sequential chain of FMAs over D (the
//     notes before cluster_scores say why), and swaps dS. Up to D = 1024
//     (dK/dV) and 1536 (dQ) the work is the counted FLOPs plus the zero
//     columns of a last span past D; beyond, each cluster of 8 forms the
//     scores itself (f32_cluster.cuh).
// Both keep the other kernels' rules: no atomics, the GQA group summed in
// the block in a fixed order, the no-key dV term, masks as a select.

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
__device__ __forceinline__ float load_f32(const __half* p) {
  return __half2float(*p);
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

// ------------------------------------------------- f32, CUDA cores ----

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kF32Threads = 256;  // 16 row groups x 16 column lanes
constexpr int kF32Step = 128;     // q rows (dK/dV) or keys (dQ) a step
constexpr int kF32CW = 64;        // d-chunk columns
constexpr int kF32CS = kF32CW + 4;  // d-chunk rows
constexpr int kF32Stages = 2;     // the cp.async ring
constexpr int kF32StageFloats = kF32Step * kF32CS;
// 16-byte copies of one ring stage a thread issues.
constexpr int kF32Copies = kF32Step * kF32CW / 4 / kF32Threads;
constexpr int kF32PS = kF32Step + 4;  // P^T, dS^T and dS rows

// Tiles of flash_dkv_f32_kernel<DT>. K and V stay resident; each step's Q
// and dO stream through a 2-stage ring of 128 x kF32CW-float chunks, twice:
// as d-chunks (128 q rows x kF32CW columns, DT / kF32CW of each) for S^T
// and dP^T, then as q-chunks (kQK rows x DT columns, 128 / kQK =
// DT / kF32CW of each) for dV and dK. Rows are padded by 4 floats: 16-byte
// loads stay aligned and 8 rows at one column fall in 8 different 4-bank
// groups.
template <int DT>
struct DkvF32Tile {
  static constexpr int kBK = DT <= 128 ? 64 : 32;  // k rows a block
  static constexpr int kRK = kBK / 16;             // k rows a thread
  static constexpr int kCols = DT / 16;            // dK/dV columns a thread
  static constexpr int kRowStride = DT + 4;        // sK, sV, q-chunk rows
  static constexpr int kQK = kF32Step * kF32CW / DT;  // q rows a q-chunk
  static constexpr int kNC = DT / kF32CW;          // chunks of each kind
  static constexpr size_t kSmem =  // K, V, P^T, dS^T, the ring, dV term
      sizeof(float) * (2 * kBK * kRowStride + 2 * kBK * kF32PS +
                       kF32Stages * kF32StageFloats + DT);
  static_assert(kQK * kRowStride <= kF32StageFloats, "q-chunk over its stage");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// f32 dK/dV on the CUDA cores, exact f32 FMA. One 256-thread block per
// (batch*kv head, kBK-row k tile), heaviest causal tile (the first) first.
// Thread (ty, tx) owns k rows ty + 16i (i < kRK), the step's q columns
// tx + 16j (j < 8) of S^T and dP^T, and dK/dV columns 64g + 4tx + e
// (e < 4): kRK x 8 score tiles and kRK x DT/16 dK and dV tiles in
// registers, every operand read as a 16-byte shared load.
template <int DT>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_dkv_f32_kernel(const Params p) {
  using Tile = DkvF32Tile<DT>;
  constexpr int BK = Tile::kBK, RK = Tile::kRK, NCOL = Tile::kCols;
  constexpr int RS = Tile::kRowStride, PS = kF32PS, QK = Tile::kQK;
  constexpr int NC = Tile::kNC, NS = kF32Stages;

  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * RS;
  float* sPt = sV + BK * RS;
  float* sdSt = sPt + BK * PS;
  float* sRing = sdSt + BK * PS;
  float* sU = sRing + NS * kF32StageFloats;  // the no-key dV term

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bkv = blockIdx.x;
  const int b = bkv / p.Hkv;
  const int hk = bkv % p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.y * BK;
  const bool causal = p.causal != 0;
  const bool windowed = causal && p.window > 0;
  const float scale_log2 = p.scale * kLog2e;

  // The TPU kernel's q-loop bounds: the first q tile holding a row that
  // sees key k0 (causal), and the last one whose newest row still sees the
  // tile's oldest key (window); walked once per q head of the GQA group.
  const int n_qt = (p.Sq + kF32Step - 1) / kF32Step;
  const int it_start = causal ? k0 / kF32Step : 0;
  int it_end = n_qt;
  if (windowed) {
    it_end = min(n_qt, (k0 + BK - 1 + p.window + kF32Step - 1) / kF32Step);
  }
  const int n_q = max(it_end - it_start, 0);
  const int total = group * n_q * 4 * NC;  // chunks

  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  for (int e = tid; e < BK * DT / 4; e += kF32Threads) {
    const int r = e / (DT / 4), col = 4 * (e % (DT / 4));
    const int kpos = k0 + r;
    const bool ok = kpos < p.Sk && col < p.D;
    sm90::cp_async16(sK + r * RS + col, ok ? kg + kpos * p.k_ss + col : kg,
                     ok ? 16 : 0);
    sm90::cp_async16(sV + r * RS + col, ok ? vg + kpos * p.v_ss + col : vg,
                     ok ? 16 : 0);
  }

  // Chunk g of step g / (4 NC) (q head hk * group + step / n_q, q tile
  // it_start + step % n_q): Q d-chunks, dO d-chunks, dO q-chunks, Q
  // q-chunks. 16 bytes a copy; rows past Sq and columns past D arrive as
  // zeros. (Written out in each kernel: the same copies through a shared
  // function made this kernel 4 % slower on an H100.)
  auto issue = [&](int g) {
    float* st = sRing + (g % NS) * kF32StageFloats;
    const int step = g / (4 * NC), part = g % (4 * NC);
    const int h = hk * group + step / n_q;
    const int q0 = (it_start + step % n_q) * kF32Step;
    const int kind = part / NC, c = part % NC;
    const bool is_q = kind == 0 || kind == 3;
    const float* src = static_cast<const float*>(is_q ? p.q : p.dout) + b *
        (is_q ? p.q_sb : p.do_sb) + h * (is_q ? p.q_sh : p.do_sh);
    const long long ss = is_q ? p.q_ss : p.do_ss;
#pragma unroll
    for (int u = 0; u < kF32Copies; ++u) {
      const int e = tid + kF32Threads * u;
      int r, col, dst;
      if (kind < 2) {  // 128 rows x CW columns
        r = e / (kF32CW / 4);
        dst = 4 * (e % (kF32CW / 4));
        col = kF32CW * c + dst;
        dst += r * kF32CS;
      } else {  // QK rows x DT columns
        r = QK * c + e / (DT / 4);
        col = 4 * (e % (DT / 4));
        dst = (e / (DT / 4)) * RS + col;
      }
      const int qpos = q0 + r;
      const bool ok = qpos < p.Sq && col < p.D;
      sm90::cp_async16(st + dst, ok ? src + qpos * ss + col : src,
                       ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {  // K and V join the first group
    if (g < total) issue(g);
    sm90::cp_async_commit();
  }

  float st[RK][8], dpt[RK][8], dk[RK][NCOL], dv[RK][NCOL];
  float lse2[8], dlt[8];  // the step's q columns: lse * log2(e), delta
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < total; ++g) {
    sm90::cp_async_wait<NS - 2>();
    __syncthreads();  // chunk g is in; every thread is done with chunk g-1
    if (g + NS - 1 < total) issue(g + NS - 1);
    sm90::cp_async_commit();
    const float* sc = sRing + (g % NS) * kF32StageFloats;
    const int step = g / (4 * NC), part = g % (4 * NC);
    const int kind = part / NC, c = part % NC;
    const int q0 = (it_start + step % n_q) * kF32Step;
    if (part == 0) {
      const long long row0 =
          ((long long)b * p.H + hk * group + step / n_q) * p.Sq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qpos = q0 + tx + 16 * j;
        const bool ok = qpos < p.Sq;
        lse2[j] = ok ? p.lse[row0 + qpos] * kLog2e : 0.f;
        dlt[j] = ok ? p.delta[row0 + qpos] : 0.f;
      }
    }
    if (kind == 0) {
      f32_score_chunk<RK, 8, kF32CW, RS, kF32CS>(st, sK + kF32CW * c, sc,
                                                 tx, ty, c == 0);
    } else if (kind == 1) {
      f32_score_chunk<RK, 8, kF32CW, RS, kF32CS>(dpt, sV + kF32CW * c, sc,
                                                 tx, ty, c == 0);
      if (c == NC - 1) {
        // P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T -
        // delta) scale, both 0 where the causal, window or ragged-row mask
        // holds: a select on every entry, never a branch (a no-key row's
        // exponential is inf before the mask).
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          const int kpos = k0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int qpos = q0 + tx + 16 * j;
            const bool masked =
                (qpos >= p.Sq) |
                (causal & ((qpos < kpos) |
                           (windowed & (qpos - kpos >= p.window))));
            float pv = sm90::ex2(fmaf(st[i][j], scale_log2, -lse2[j]));
            pv = masked ? 0.f : pv;
            sPt[(ty + 16 * i) * PS + tx + 16 * j] = pv;
            sdSt[(ty + 16 * i) * PS + tx + 16 * j] =
                pv * (dpt[i][j] - dlt[j]) * p.scale;
          }
        }
      }
    } else if (kind == 2) {
      f32_product_chunk<RK, NCOL, QK, PS, RS>(dv, sPt + QK * c, sc, tx, ty);
    } else {
      f32_product_chunk<RK, NCOL, QK, PS, RS>(dk, sdSt + QK * c, sc, tx, ty);
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // K and V are in even when the block had no step

  const int q_first = first_no_key_row(p.causal, p.window, p.Sq, p.Sk);
  if (q_first < p.Sq) {  // rows that see no key: dV += their dO / Sk
    for (int d = tid; d < p.D; d += kF32Threads) {
      sU[d] = no_key_dv(static_cast<const float*>(p.dout), p.do_sb, p.do_ss,
                        p.do_sh, b, hk * group, group, q_first, p.Sq, p.Sk,
                        d);
    }
    __syncthreads();
#pragma unroll
    for (int gg = 0; gg < NCOL / 4; ++gg) {
      const int col = 64 * gg + 4 * tx;
      if (col < p.D) {
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dv[i][4 * gg + e] += sU[col + e];
      }
    }
  }

  // dK/dV are contiguous (B, Sk, Hkv, D).
  float* dkg = static_cast<float*>(p.dk);
  float* dvg = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= p.Sk) continue;
    const long long row = (((long long)b * p.Sk + kpos) * p.Hkv + hk) * p.D;
#pragma unroll
    for (int gg = 0; gg < NCOL / 4; ++gg) {
      const int col = 64 * gg + 4 * tx;
      if (col < p.D) {
        *reinterpret_cast<float4*>(dkg + row + col) =
            make_float4(dk[i][4 * gg], dk[i][4 * gg + 1], dk[i][4 * gg + 2],
                        dk[i][4 * gg + 3]);
        *reinterpret_cast<float4*>(dvg + row + col) =
            make_float4(dv[i][4 * gg], dv[i][4 * gg + 1], dv[i][4 * gg + 2],
                        dv[i][4 * gg + 3]);
      }
    }
  }
}

template <int DT>
cudaError_t launch_dkv_f32(const Params& p, cudaStream_t stream) {
  using Tile = DkvF32Tile<DT>;
  auto kernel = flash_dkv_f32_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.Hkv, (p.Sk + Tile::kBK - 1) / Tile::kBK);
  kernel<<<grid, kF32Threads, Tile::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// Tiles of flash_dq_f32_kernel<DT>, flash_dkv_f32_kernel's with the roles
// of q and k swapped. Q and dO stay resident; each step's K and V (128
// keys) stream through the 2-stage ring: as d-chunks (128 keys x kF32CW
// columns, DT / kF32CW of each) for S and dP, then K again as k-chunks
// (kKC keys x DT columns, DT / kF32CW of them) for dQ.
template <int DT>
struct DqF32Tile {
  static constexpr int kBQ = DT <= 128 ? 64 : 32;  // q rows a block
  static constexpr int kRQ = kBQ / 16;             // q rows a thread
  static constexpr int kCols = DT / 16;            // dQ columns a thread
  static constexpr int kRowStride = DT + 4;        // sQ, sdO, k-chunk rows
  static constexpr int kKC = kF32Step * kF32CW / DT;  // keys a k-chunk
  static constexpr int kNC = DT / kF32CW;          // chunks of each kind
  static constexpr size_t kSmem =  // Q, dO, dS, the ring
      sizeof(float) * (2 * kBQ * kRowStride + kBQ * kF32PS +
                       kF32Stages * kF32StageFloats);
  static_assert(kKC * kRowStride <= kF32StageFloats, "k-chunk over its stage");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// f32 dQ on the CUDA cores, exact f32 FMA. One 256-thread block per
// (batch*head, kBQ-row q tile). B*H sits on grid.x (any count), yet a
// linear block index runs each head's q tiles one after another, heaviest
// causal tile first, so a head's K and V stay in L2. Thread (ty, tx) owns
// q rows ty + 16i (i < kRQ), the step's keys tx + 16j (j < 8) of S and dP,
// and dQ columns 64g + 4tx + e (e < 4): kRQ x 8 score tiles and a
// kRQ x DT/16 dQ tile in registers, every operand read as a 16-byte shared
// load. dS goes through shared memory to the threads that own its dQ
// columns; the masks are a select on every entry.
template <int DT>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_dq_f32_kernel(const Params p) {
  using Tile = DqF32Tile<DT>;
  constexpr int BQ = Tile::kBQ, RQ = Tile::kRQ, NCOL = Tile::kCols;
  constexpr int RS = Tile::kRowStride, PS = kF32PS, KC = Tile::kKC;
  constexpr int NC = Tile::kNC, NS = kF32Stages;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * RS;
  float* sdS = sdO + BQ * RS;
  float* sRing = sdS + BQ * PS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long lin = blockIdx.x + (long long)gridDim.x * blockIdx.y;
  const int bh = (int)(lin / gridDim.y);
  const int q0 = (gridDim.y - 1 - (int)(lin % gridDim.y)) * BQ;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const bool causal = p.causal != 0;
  const bool windowed = causal && p.window > 0;
  const float scale_log2 = p.scale * kLog2e;

  // The TPU kernel's k-loop bounds: causal stops at the tile holding the
  // last row's own position, a window starts at the tile holding the first
  // row's oldest visible key.
  const int n_kt = (p.Sk + kF32Step - 1) / kF32Step;
  const int kt_end = causal ? min(n_kt, (q0 + BQ + kF32Step - 1) / kF32Step)
                            : n_kt;
  const int kt_start = windowed ? max(q0 - (p.window - 1), 0) / kF32Step : 0;
  const int total = max(kt_end - kt_start, 0) * 3 * NC;  // chunks

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dog =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  for (int e = tid; e < BQ * DT / 4; e += kF32Threads) {
    const int r = e / (DT / 4), col = 4 * (e % (DT / 4));
    const int qpos = q0 + r;
    const bool ok = qpos < p.Sq && col < p.D;
    sm90::cp_async16(sQ + r * RS + col, ok ? qg + qpos * p.q_ss + col : qg,
                     ok ? 16 : 0);
    sm90::cp_async16(sdO + r * RS + col,
                     ok ? dog + qpos * p.do_ss + col : dog, ok ? 16 : 0);
  }

  // Chunk g of step g / (3 NC) (k tile kt_start + step): K d-chunks, V
  // d-chunks, K k-chunks. 16 bytes a copy; rows past Sk and columns past D
  // arrive as zeros.
  auto issue = [&](int g) {
    float* st = sRing + (g % NS) * kF32StageFloats;
    const int step = g / (3 * NC), part = g % (3 * NC);
    const int k0 = (kt_start + step) * kF32Step;
    const int kind = part / NC, c = part % NC;
    const float* src = kind == 1 ? vg : kg;
    const long long ss = kind == 1 ? p.v_ss : p.k_ss;
#pragma unroll
    for (int u = 0; u < kF32Copies; ++u) {
      const int e = tid + kF32Threads * u;
      int r, col, dst;
      if (kind < 2) {  // 128 keys x CW columns
        r = e / (kF32CW / 4);
        dst = 4 * (e % (kF32CW / 4));
        col = kF32CW * c + dst;
        dst += r * kF32CS;
      } else {  // KC keys x DT columns
        r = KC * c + e / (DT / 4);
        col = 4 * (e % (DT / 4));
        dst = (e / (DT / 4)) * RS + col;
      }
      const int kpos = k0 + r;
      const bool ok = kpos < p.Sk && col < p.D;
      sm90::cp_async16(st + dst, ok ? src + kpos * ss + col : src,
                       ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {  // Q and dO join the first group
    if (g < total) issue(g);
    sm90::cp_async_commit();
  }

  float s[RQ][8], dp[RQ][8], dq[RQ][NCOL];
  float lse2[RQ], dlt[RQ];  // the rows' lse * log2(e) and delta
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty + 16 * i;
    const bool ok = qpos < p.Sq;
    lse2[i] = ok ? p.lse[(long long)bh * p.Sq + qpos] * kLog2e : 0.f;
    dlt[i] = ok ? p.delta[(long long)bh * p.Sq + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) dq[i][c] = 0.f;
  }

  for (int g = 0; g < total; ++g) {
    sm90::cp_async_wait<NS - 2>();
    __syncthreads();  // chunk g is in; every thread is done with chunk g-1
    if (g + NS - 1 < total) issue(g + NS - 1);
    sm90::cp_async_commit();
    const float* sc = sRing + (g % NS) * kF32StageFloats;
    const int step = g / (3 * NC), part = g % (3 * NC);
    const int kind = part / NC, c = part % NC;
    if (kind == 0) {
      f32_score_chunk<RQ, 8, kF32CW, RS, kF32CS>(s, sQ + kF32CW * c, sc, tx,
                                                 ty, c == 0);
    } else if (kind == 1) {
      f32_score_chunk<RQ, 8, kF32CW, RS, kF32CS>(dp, sdO + kF32CW * c, sc,
                                                 tx, ty, c == 0);
      if (c == NC - 1) {
        // dS = P (dP - delta) scale with P = exp2(S scale log2e - lse
        // log2e), 0 where the causal, window or ragged-key mask holds: a
        // select on every entry (a no-key row's exponential is inf before
        // the mask, and all of its entries are masked).
        const int k0 = (kt_start + step) * kF32Step;
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const int qpos = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int kpos = k0 + tx + 16 * j;
            const bool masked =
                (kpos >= p.Sk) |
                (causal & ((qpos < kpos) |
                           (windowed & (qpos - kpos >= p.window))));
            float pv = sm90::ex2(fmaf(s[i][j], scale_log2, -lse2[i]));
            pv = masked ? 0.f : pv;
            sdS[(ty + 16 * i) * PS + tx + 16 * j] =
                pv * (dp[i][j] - dlt[i]) * p.scale;
          }
        }
      }
    } else {
      f32_product_chunk<RQ, NCOL, KC, PS, RS>(dq, sdS + KC * c, sc, tx, ty);
    }
  }
  sm90::cp_async_wait<0>();

  // dQ is contiguous (B, Sq, H, D); ragged rows are never written.
  float* dqg = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
    const long long row = (((long long)b * p.Sq + qpos) * p.H + h) * p.D;
#pragma unroll
    for (int gg = 0; gg < NCOL / 4; ++gg) {
      const int col = 64 * gg + 4 * tx;
      if (col < p.D) {
        *reinterpret_cast<float4*>(dqg + row + col) =
            make_float4(dq[i][4 * gg], dq[i][4 * gg + 1], dq[i][4 * gg + 2],
                        dq[i][4 * gg + 3]);
      }
    }
  }
}

template <int DT>
cudaError_t launch_dq_f32(const Params& p, cudaStream_t stream) {
  using Tile = DqF32Tile<DT>;
  auto kernel = flash_dq_f32_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.H, (p.Sq + Tile::kBQ - 1) / Tile::kBQ);
  kernel<<<grid, kF32Threads, Tile::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------ head dims above 256: f32, CUDA cores --

constexpr int kWideStages = 3;     // flash_dkv_wide_f32_kernel's ring
constexpr int kWideDkvSpan = 128;  // its dK/dV columns a block
// Its stage: a d-chunk (128 q rows, then 64 k rows) or a q-chunk.
constexpr int kWideDkvStage = (kF32Step + 64) * kF32CS;
constexpr int kWideDqSpan = 192;            // flash_dq_wide_f32_kernel's
constexpr int kWideDqKC = 64;               // dQ columns a block, keys a
constexpr int kWideDqRS = kWideDqSpan + 4;  // k-chunk and its row stride

// The f32 wide kernels (D > 256) put their spans on grid.z and launch the
// span blocks of one tile as a thread-block cluster, so the scores are
// formed once a cluster instead of once a span. dK/dV: each block forms
// the partial S^T and dP^T over its share of the head dim's d-chunks
// (own_chunks), and cluster_scores sums the cluster's partials in rank
// order through distributed shared memory, so every block gets the same
// bits; clusters follow f32_cluster.cuh's policy (min(spans, 8)). dQ
// (flash_dq_wide_f32_kernel) splits the keys instead: a row that sees one
// key has dQ = dS K with dS = P (dP - delta) scale, a cancellation to the
// last bits of dP, so each dP entry keeps the one sequential chain of FMAs
// over D that the other kernels (and the plain version's matrix product)
// use.

// The score tiles a and b made whole from each cluster block's partials,
// this thread's entries (rows ty + 16i, columns tx + 16j): each block
// stores its own in sa and sb (row stride kF32PS), then adds every block's
// in rank order. sa and sb are free again on return.
template <int R>
__device__ __forceinline__ void cluster_scores(float (&a)[R][8],
                                               float (&b)[R][8], float* sa,
                                               float* sb, int tx, int ty) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sa[(ty + 16 * i) * kF32PS + tx + 16 * j] = a[i][j];
      sb[(ty + 16 * i) * kF32PS + tx + 16 * j] = b[i][j];
      a[i][j] = b[i][j] = 0.f;
    }
  cl.sync();  // every block's partials are stored
  const uint32_t at = 4 * (ty * kF32PS + tx);
#pragma unroll 1
  for (unsigned r = 0; r < cl.num_blocks(); ++r) {
    const uint32_t ra = sm90::cluster_addr(sm90::smem_u32(sa) + at, r);
    const uint32_t rb = sm90::cluster_addr(sm90::smem_u32(sb) + at, r);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t off = 4 * (16 * i * kF32PS + 16 * j);
        a[i][j] += sm90::ld_cluster(ra + off);
        b[i][j] += sm90::ld_cluster(rb + off);
      }
  }
  cl.sync();  // every block is done reading
}

// R rows pos0..pos0+R-1 of one head (src at the head, row stride ss),
// head-dim columns c0..c0+kF32CW-1, into R rows of a ring stage (row
// stride kF32CS): 16 bytes a copy, zeros past row lim or column D.
template <int R>
__device__ __forceinline__ void copy_chunk_rows(float* dst, const float* src,
                                                long long ss, int pos0,
                                                int lim, int c0, int D) {
#pragma unroll
  for (int u = 0; u < R * kF32CW / 4 / kF32Threads; ++u) {
    const int e = threadIdx.x + kF32Threads * u;
    const int r = e / (kF32CW / 4), cc = 4 * (e % (kF32CW / 4));
    const int pos = pos0 + r, col = c0 + cc;
    const bool ok = pos < lim && col < D;
    sm90::cp_async16(dst + r * kF32CS + cc, ok ? src + pos * ss + col : src,
                     ok ? 16 : 0);
  }
}

// f32 dK/dV for D > 256, on the CUDA cores, exact f32 FMA: flash_dkv_f32
// _kernel<128>'s design with a span axis. One 256-thread block per
// (batch*kv head, 64-row k tile, 128-column span of dK/dV), the span blocks
// of a k tile a cluster (f32_cluster.cuh: min(spans, 8), grid.z rounded up
// to a multiple, a block past D only helping form the scores).
// Nothing is resident: each step's d-chunks (128 q rows of Q or dO and the
// block's 64 rows of K or V, 64 columns) and q-chunks (64 q rows of dO or
// Q, the span's columns) stream through a 3-stage cp.async ring. Block r
// of the cluster forms the partial S^T and dP^T over its share of the
// d-chunks (own_chunks), cluster_scores adds the cluster's shares, and
// every block then forms P^T and dS^T and adds P^T.dO and dS^T.Q into its
// span (the FMA loops of f32_fma.cuh, every mask a select).
__global__ void __launch_bounds__(kF32Threads, 1)
flash_dkv_wide_f32_kernel(const Params p) {
  constexpr int DT = kWideDkvSpan, BK = 64, RK = BK / 16, NCOL = DT / 16;
  constexpr int RS = DT + 4, PS = kF32PS, QK = kF32Step * kF32CW / DT;
  constexpr int NC = DT / kF32CW, NS = kWideStages;
  constexpr int SF = kWideDkvStage;

  extern __shared__ float smem[];
  float* sPt = smem;
  float* sdSt = sPt + BK * PS;
  float* sRing = sdSt + BK * PS;
  float* sU = sRing + NS * SF;  // the no-key dV term

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bkv = blockIdx.x;
  const int b = bkv / p.Hkv;
  const int hk = bkv % p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.y * BK;
  const int s0 = DT * blockIdx.z;  // the span's first column
  const int2 own = own_chunks<kF32CW>(p.D);
  const int cd0 = own.x, ncd = own.y;  // the block's d-chunks of the scores
  const int per = 2 * ncd + 2 * NC;    // chunks a step
  const bool causal = p.causal != 0;
  const bool windowed = causal && p.window > 0;
  const float scale_log2 = p.scale * kLog2e;

  const int n_qt = (p.Sq + kF32Step - 1) / kF32Step;
  const int it_start = causal ? k0 / kF32Step : 0;
  int it_end = n_qt;
  if (windowed) {
    it_end = min(n_qt, (k0 + BK - 1 + p.window + kF32Step - 1) / kF32Step);
  }
  const int n_q = max(it_end - it_start, 0);
  const int total = group * n_q * per;  // chunks

  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Chunk `part` of a step: Q d-chunks (with K), dO d-chunks (with V), dO
  // q-chunks, Q q-chunks.
  auto kind_of = [&](int part, int& kind, int& c) {
    const bool d_chunk = part < 2 * ncd;
    kind = d_chunk ? part / ncd : 2 + (part - 2 * ncd) / NC;
    c = d_chunk ? part % ncd : (part - 2 * ncd) % NC;
  };
  auto issue = [&](int g) {
    float* st = sRing + (g % NS) * SF;
    const int step = g / per, part = g % per;
    const int h = hk * group + step / n_q;
    const int q0 = (it_start + step % n_q) * kF32Step;
    int kind, c;
    kind_of(part, kind, c);
    const bool is_q = kind == 0 || kind == 3;
    const float* src = static_cast<const float*>(is_q ? p.q : p.dout) + b *
        (is_q ? p.q_sb : p.do_sb) + h * (is_q ? p.q_sh : p.do_sh);
    const long long ss = is_q ? p.q_ss : p.do_ss;
    if (kind < 2) {
      const int c0 = kF32CW * (cd0 + c);
      copy_chunk_rows<kF32Step>(st, src, ss, q0, p.Sq, c0, p.D);
      copy_chunk_rows<BK>(st + kF32Step * kF32CS, kind == 0 ? kg : vg,
                          kind == 0 ? p.k_ss : p.v_ss, k0, p.Sk, c0, p.D);
    } else {  // QK rows x the span's columns
#pragma unroll
      for (int u = 0; u < kF32Copies; ++u) {
        const int e = tid + kF32Threads * u;
        const int r = QK * c + e / (DT / 4), cc = 4 * (e % (DT / 4));
        const int qpos = q0 + r, col = s0 + cc;
        const bool ok = qpos < p.Sq && col < p.D;
        sm90::cp_async16(st + (e / (DT / 4)) * RS + cc,
                         ok ? src + qpos * ss + col : src, ok ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {
    if (g < total) issue(g);
    sm90::cp_async_commit();
  }

  float st[RK][8], dpt[RK][8], dk[RK][NCOL], dv[RK][NCOL];
  float lse2[8], dlt[8];  // the step's q columns: lse * log2(e), delta
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < total; ++g) {
    sm90::cp_async_wait<NS - 2>();
    __syncthreads();  // chunk g is in; every thread is done with chunk g-1
    if (g + NS - 1 < total) issue(g + NS - 1);
    sm90::cp_async_commit();
    const float* sc = sRing + (g % NS) * SF;
    const int step = g / per, part = g % per;
    int kind, c;
    kind_of(part, kind, c);
    const int q0 = (it_start + step % n_q) * kF32Step;
    if (kind == 0) {
      f32_score_chunk<RK, 8, kF32CW, kF32CS, kF32CS>(
          st, sc + kF32Step * kF32CS, sc, tx, ty, c == 0);
    } else if (kind == 1) {
      f32_score_chunk<RK, 8, kF32CW, kF32CS, kF32CS>(
          dpt, sc + kF32Step * kF32CS, sc, tx, ty, c == 0);
      if (c == ncd - 1) {
        // The cluster's scores, then the step's rows' lse and delta
        // (loaded here, where they are used, to spare registers).
        cluster_scores(st, dpt, sPt, sdSt, tx, ty);
        const long long row0 =
            ((long long)b * p.H + hk * group + step / n_q) * p.Sq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qpos = q0 + tx + 16 * j;
          const bool ok = qpos < p.Sq;
          lse2[j] = ok ? p.lse[row0 + qpos] * kLog2e : 0.f;
          dlt[j] = ok ? p.delta[row0 + qpos] : 0.f;
        }
        // P^T and dS^T, 0 where the causal, window or ragged-row mask
        // holds: a select on every entry.
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          const int kpos = k0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int qpos = q0 + tx + 16 * j;
            const bool masked =
                (qpos >= p.Sq) |
                (causal & ((qpos < kpos) |
                           (windowed & (qpos - kpos >= p.window))));
            float pv = sm90::ex2(fmaf(st[i][j], scale_log2, -lse2[j]));
            pv = masked ? 0.f : pv;
            sPt[(ty + 16 * i) * PS + tx + 16 * j] = pv;
            sdSt[(ty + 16 * i) * PS + tx + 16 * j] =
                pv * (dpt[i][j] - dlt[j]) * p.scale;
          }
        }
      }
    } else if (kind == 2) {
      f32_product_chunk<RK, NCOL, QK, PS, RS>(dv, sPt + QK * c, sc, tx, ty);
    } else {
      f32_product_chunk<RK, NCOL, QK, PS, RS>(dk, sdSt + QK * c, sc, tx, ty);
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();

  const int q_first = first_no_key_row(p.causal, p.window, p.Sq, p.Sk);
  if (q_first < p.Sq) {  // rows that see no key: dV += their dO / Sk
    for (int d = tid; d < DT; d += kF32Threads) {
      sU[d] = s0 + d < p.D
                  ? no_key_dv(static_cast<const float*>(p.dout), p.do_sb,
                              p.do_ss, p.do_sh, b, hk * group, group,
                              q_first, p.Sq, p.Sk, s0 + d)
                  : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int gg = 0; gg < NCOL / 4; ++gg) {
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[i][4 * gg + e] += sU[64 * gg + 4 * tx + e];
    }
  }

  // dK/dV are contiguous (B, Sk, Hkv, D).
  float* dkg = static_cast<float*>(p.dk);
  float* dvg = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= p.Sk) continue;
    const long long row =
        (((long long)b * p.Sk + kpos) * p.Hkv + hk) * p.D + s0;
#pragma unroll
    for (int gg = 0; gg < NCOL / 4; ++gg) {
      const int col = 64 * gg + 4 * tx;
      if (s0 + col < p.D) {
        *reinterpret_cast<float4*>(dkg + row + col) =
            make_float4(dk[i][4 * gg], dk[i][4 * gg + 1], dk[i][4 * gg + 2],
                        dk[i][4 * gg + 3]);
        *reinterpret_cast<float4*>(dvg + row + col) =
            make_float4(dv[i][4 * gg], dv[i][4 * gg + 1], dv[i][4 * gg + 2],
                        dv[i][4 * gg + 3]);
      }
    }
  }
}

cudaError_t launch_dkv_wide_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (2 * 64 * kF32PS +
                                           kWideStages * kWideDkvStage +
                                           kWideDkvSpan);
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  const int nsp = (p.D + kWideDkvSpan - 1) / kWideDkvSpan;
  const dim3 grid(p.B * p.Hkv, (p.Sk + 63) / 64, nsp);
  return launch_clusters(flash_dkv_wide_f32_kernel, grid, kF32Threads, smem,
                         p, stream, span_cluster(nsp));
}

// f32 dQ for D > 256, on the CUDA cores, exact f32 FMA. One 256-thread
// block per (batch*head, 64-row q tile, 192-column span of dQ), the span
// blocks of a q tile a cluster of CN (a power of two: the span count
// rounded up, at most 8; a block whose span lies past D only helps with
// the scores). Each 128-key step, block r of the cluster forms S and dP
// for its 128 / CN keys, [16 NJ r, 16 NJ r + 16 NJ), over the whole head
// dim in 64-column d-chunks (each stage: those keys' K and V columns and
// the block's Q and dO columns), then dS for them into its dS tile; the
// cluster swaps its dS columns through distributed shared memory, and each
// block adds dS.K over all 128 keys into its span of dQ (K in 64-key
// k-chunks of the span's columns). Thread (ty, tx) owns q rows ty + 16i
// (i < 4), keys tx + 16 (NJ r + j) (j < NJ) and dQ columns 64g + 4tx + e
// (g < 3, e < 4), every operand a 16-byte shared load (f32_fma.cuh). The
// scores are formed once a cluster, each entry by one chain of FMAs over
// D; every mask is a select.

template <int CN>
struct WideDqF32Tile {
  static constexpr int kNJ = 8 / CN;       // key columns a thread forms
  static constexpr int kKeys = 16 * kNJ;   // keys a block forms a step
  // A d-chunk stage: K and V rows of the block's keys, then Q and dO rows.
  static constexpr int kScoreFloats = (2 * kKeys + 2 * 64) * kF32CS;
  static constexpr int kStageFloats =
      kScoreFloats > kWideDqKC * kWideDqRS ? kScoreFloats
                                           : kWideDqKC * kWideDqRS;
  static constexpr size_t kSmem =  // dS, the ring
      sizeof(float) * (64 * kF32PS + kF32Stages * kStageFloats);
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

template <int CN>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_dq_wide_f32_kernel(const Params p) {
  namespace cg = cooperative_groups;
  using Tile = WideDqF32Tile<CN>;
  constexpr int NJ = Tile::kNJ, KEYS = Tile::kKeys, NS = kF32Stages;
  constexpr int SF = Tile::kStageFloats, PS = kF32PS, RS = kWideDqRS;
  constexpr int NCOL = kWideDqSpan / 16;

  extern __shared__ float smem[];
  float* sdS = smem;
  float* sRing = sdS + 64 * PS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long lin = blockIdx.x + (long long)gridDim.x * blockIdx.y;
  const int bh = (int)(lin / gridDim.y);
  const int q0 = (gridDim.y - 1 - (int)(lin % gridDim.y)) * 64;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int rank = blockIdx.z % CN;  // cluster dims (1, 1, CN)
  const int kb = KEYS * rank;        // the block's keys in a step
  const int s0 = kWideDqSpan * blockIdx.z;  // the span's first column
  const bool has_span = s0 < p.D;
  const int ncd = (p.D + kF32CW - 1) / kF32CW;  // d-chunks
  const int per = ncd + (has_span ? 128 / kWideDqKC : 0);  // chunks a step
  const bool causal = p.causal != 0;
  const bool windowed = causal && p.window > 0;
  const float scale_log2 = p.scale * kLog2e;

  const int n_kt = (p.Sk + kF32Step - 1) / kF32Step;
  const int kt_end =
      causal ? min(n_kt, (q0 + 64 + kF32Step - 1) / kF32Step) : n_kt;
  const int kt_start = windowed ? max(q0 - (p.window - 1), 0) / kF32Step : 0;
  const int steps = max(kt_end - kt_start, 0);
  const int total = steps * per;  // chunks

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dog =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Chunk g of step g / per: d-chunks c < ncd (the block's keys' K and V
  // rows, the q tile's Q and dO rows, columns 64c..64c+63), then the span's
  // k-chunks. 16 bytes a copy; rows past Sk (Sq) and columns past D arrive
  // as zeros.
  auto issue = [&](int g) {
    float* st = sRing + (g % NS) * SF;
    const int step = g / per, c = g % per;
    const int k0 = (kt_start + step) * kF32Step;
    if (c < ncd) {
      const int c0 = kF32CW * c;
      copy_chunk_rows<KEYS>(st, kg, p.k_ss, k0 + kb, p.Sk, c0, p.D);
      copy_chunk_rows<KEYS>(st + KEYS * kF32CS, vg, p.v_ss, k0 + kb, p.Sk,
                            c0, p.D);
      copy_chunk_rows<64>(st + 2 * KEYS * kF32CS, qg, p.q_ss, q0, p.Sq, c0,
                          p.D);
      copy_chunk_rows<64>(st + (2 * KEYS + 64) * kF32CS, dog, p.do_ss, q0,
                          p.Sq, c0, p.D);
    } else {  // kWideDqKC keys x the span's columns
#pragma unroll
      for (int u = 0; u < kWideDqKC * kWideDqSpan / 4 / kF32Threads; ++u) {
        const int e = tid + kF32Threads * u;
        const int r = e / (kWideDqSpan / 4), cc = 4 * (e % (kWideDqSpan / 4));
        const int kpos = k0 + kWideDqKC * (c - ncd) + r, col = s0 + cc;
        const bool ok = kpos < p.Sk && col < p.D;
        sm90::cp_async16(st + r * RS + cc, ok ? kg + kpos * p.k_ss + col : kg,
                         ok ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {
    if (g < total) issue(g);
    sm90::cp_async_commit();
  }

  float s[4][NJ], dp[4][NJ], dq[4][NCOL];
  float lse2[4], dlt[4];  // the rows' lse * log2(e) and delta
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    const bool ok = qpos < p.Sq;
    lse2[i] = ok ? p.lse[(long long)bh * p.Sq + qpos] * kLog2e : 0.f;
    dlt[i] = ok ? p.delta[(long long)bh * p.Sq + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) dq[i][c] = 0.f;
  }

  cg::cluster_group cl = cg::this_cluster();
  for (int g = 0; g < total; ++g) {
    sm90::cp_async_wait<NS - 2>();
    __syncthreads();  // chunk g is in; every thread is done with chunk g-1
    if (g + NS - 1 < total) issue(g + NS - 1);
    sm90::cp_async_commit();
    const float* sc = sRing + (g % NS) * SF;
    const int step = g / per, c = g % per;
    if (c < ncd) {
      f32_score_chunk<4, NJ, kF32CW, kF32CS, kF32CS>(
          s, sc + 2 * KEYS * kF32CS, sc, tx, ty, c == 0);
      f32_score_chunk<4, NJ, kF32CW, kF32CS, kF32CS>(
          dp, sc + (2 * KEYS + 64) * kF32CS, sc + KEYS * kF32CS, tx, ty,
          c == 0);
      if (c == ncd - 1) {
        // dS = P (dP - delta) scale with P = exp2(S scale log2e - lse
        // log2e), 0 where the causal, window or ragged-key mask holds (a
        // select), for the block's keys; then the cluster's other keys.
        cl.sync();  // every block is done reading the last step's dS
        const int k0 = (kt_start + step) * kF32Step;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int kpos = k0 + kb + tx + 16 * j;
            const bool masked =
                (kpos >= p.Sk) |
                (causal & ((qpos < kpos) |
                           (windowed & (qpos - kpos >= p.window))));
            float pv = sm90::ex2(fmaf(s[i][j], scale_log2, -lse2[i]));
            pv = masked ? 0.f : pv;
            sdS[(ty + 16 * i) * PS + kb + tx + 16 * j] =
                pv * (dp[i][j] - dlt[i]) * p.scale;
          }
        }
        cl.sync();  // every block's dS columns are stored
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int owner = j / NJ;
            if (owner != rank) {
              const int at = (ty + 16 * i) * PS + tx + 16 * j;
              sdS[at] = sm90::ld_cluster(
                  sm90::cluster_addr(sm90::smem_u32(sdS + at), owner));
            }
          }
      }
    } else {
      f32_product_chunk<4, NCOL, kWideDqKC, PS, RS>(
          dq, sdS + kWideDqKC * (c - ncd), sc, tx, ty);
    }
  }
  sm90::cp_async_wait<0>();
  cl.sync();  // no block leaves while another may read its dS
  if (!has_span) return;

  // dQ is contiguous (B, Sq, H, D); ragged rows are never written.
  float* dqg = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
    const long long row =
        (((long long)b * p.Sq + qpos) * p.H + h) * p.D + s0;
#pragma unroll
    for (int gg = 0; gg < NCOL / 4; ++gg) {
      const int col = 64 * gg + 4 * tx;
      if (s0 + col < p.D) {
        *reinterpret_cast<float4*>(dqg + row + col) =
            make_float4(dq[i][4 * gg], dq[i][4 * gg + 1], dq[i][4 * gg + 2],
                        dq[i][4 * gg + 3]);
      }
    }
  }
}

// Launches flash_dq_wide_f32_kernel: cdiv(D, 192) spans rounded up to a
// power of two (at most 8) a cluster, and to a multiple of 8 beyond.
cudaError_t launch_dq_wide_f32(const Params& p, cudaStream_t stream) {
  const int nsp = (p.D + kWideDqSpan - 1) / kWideDqSpan;
  int cn = 2;
  while (cn < nsp && cn < 8) cn *= 2;
  void (*kernel)(const Params) = cn == 2   ? flash_dq_wide_f32_kernel<2>
                                 : cn == 4 ? flash_dq_wide_f32_kernel<4>
                                           : flash_dq_wide_f32_kernel<8>;
  const size_t smem = cn == 2   ? WideDqF32Tile<2>::kSmem
                      : cn == 4 ? WideDqF32Tile<4>::kSmem
                                : WideDqF32Tile<8>::kSmem;
  const dim3 grid(p.B * p.H, (p.Sq + 63) / 64, nsp);
  return launch_clusters(kernel, grid, kF32Threads, smem, p, stream, cn);
}

// ------------------------------------------- dK/dV, bf16, tensor cores ----

constexpr int kWgThreads = 384;  // 2 consumer warpgroups + 1 producer

struct DkvArgs {
  CUtensorMap tq, tk, tv, tdo;
  const float* lse;
  const float* delta;
  const void* dout;  // the no-key dV term reads it directly
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
  static constexpr int kD = DT;
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

// flash_dkv_bf16_dsplit_kernel's tiles (128 < D <= 256).
struct DkvSplitTile {
  static constexpr int kD = 256;
  static constexpr int kBK = 64;  // k rows, shared by both warpgroups
  static constexpr int kBQ = 32;  // q rows a step
  static constexpr int kStages = 3;
  static constexpr int kKBytes = kBK * kD * 2;  // K (or V), resident
  static constexpr int kQBytes = kBQ * kD * 2;  // Q (or dO), one stage
  static constexpr int kTiles = 2 * kKBytes + kStages * 2 * kQBytes;
  static constexpr int kRows = kStages * 2 * kBQ * 4;  // lse, delta
  static constexpr int kBars = 8 * (2 * kStages + 1);
  // The swapped S^T / dP^T fragments: 2 steps x 2 warpgroups x 64 x kBQ.
  static constexpr int kSwap = 2 * 2 * 64 * kBQ * 4;
  static constexpr size_t kSmem =  // slack, tiles, rows, barriers, dV term
      1024 + kTiles + kRows + kBars + 4 * kD + kSwap;
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// A bf16 dK/dV block of Tile::kBK k rows (flash_dkv_bf16_kernel,
// flash_dkv_bf16_dsplit_kernel): its shared memory, its batch, kv head and
// first key, and the TPU kernel's q-loop bounds: the first q tile holding a
// row that sees key k0 (causal) to the last one whose newest row still sees
// the tile's oldest key (window), walked once per q head of the GQA group
// (`total` steps). Thread 0 initialises the barriers and the block syncs.
template <typename Tile>
struct DkvBlock {
  uint8_t* sK;
  uint8_t* sV;
  uint8_t* sQO;     // stage s: Q, then dO
  float* sRows;     // stage s: lse * log2(e), then delta
  uint64_t* kvbar;  // K and V
  uint64_t* full;
  uint64_t* empty;
  float* sU;        // the no-key dV term, Tile::kD floats
  int b, hk, group, k0, it_start, n_q, total;

  __device__ __forceinline__ DkvBlock(const DkvArgs& a, uint8_t* smem_raw) {
    constexpr int BK = Tile::kBK, BQ = Tile::kBQ, NS = Tile::kStages;
    uint8_t* base =
        smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
    sK = base;
    sV = base + Tile::kKBytes;
    sQO = base + 2 * Tile::kKBytes;
    sRows = reinterpret_cast<float*>(base + Tile::kTiles);
    kvbar = reinterpret_cast<uint64_t*>(base + Tile::kTiles + Tile::kRows);
    full = kvbar + 1;
    empty = full + NS;
    sU = reinterpret_cast<float*>(base + Tile::kTiles + Tile::kRows +
                                  Tile::kBars);

    const int bkv = blockIdx.x;
    b = bkv / a.Hkv;
    hk = bkv % a.Hkv;
    group = a.H / a.Hkv;
    k0 = blockIdx.y * BK;
    const int n_qt = (a.Sq + BQ - 1) / BQ;
    it_start = a.causal ? k0 / BQ : 0;
    int it_end = n_qt;
    if (a.causal && a.window > 0) {
      it_end = min(n_qt, (k0 + BK - 1 + a.window + BQ - 1) / BQ);
    }
    n_q = max(it_end - it_start, 0);
    total = group * n_q;

    if (threadIdx.x == 0) {
      sm90::mbar_init(kvbar, 1);
      for (int s = 0; s < NS; ++s) {
        sm90::mbar_init(&full[s], 33);  // TMA bytes + the producer's 32 lanes
        sm90::mbar_init(&empty[s], 256);
      }
      sm90::mbar_fence_init();
    }
    __syncthreads();
  }
};

// The producer warp of a bf16 dK/dV block: K and V once, then Q, dO,
// lse * log2(e) and delta of each step through the ring.
template <typename Tile>
__device__ __forceinline__ void dkv_produce(const DkvArgs& a,
                                            const DkvBlock<Tile>& blk) {
  constexpr int BK = Tile::kBK, BQ = Tile::kBQ, NS = Tile::kStages;
  constexpr int NC = Tile::kD / 64;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    sm90::mbar_arrive_expect_tx(blk.kvbar, 2 * Tile::kKBytes);
    for (int c = 0; c < NC; ++c) {
      sm90::tma_load_4d(blk.sK + c * BK * 128, &a.tk, blk.kvbar, c * 64,
                        blk.k0, blk.hk, blk.b);
      sm90::tma_load_4d(blk.sV + c * BK * 128, &a.tv, blk.kvbar, c * 64,
                        blk.k0, blk.hk, blk.b);
    }
  }
  for (int it = 0; it < blk.total; ++it) {
    const int g = it / blk.n_q;
    const int h = blk.hk * blk.group + g;
    const int q0 = (blk.it_start + it - g * blk.n_q) * BQ;
    const int s = it % NS;
    sm90::mbar_wait(&blk.empty[s], ((it / NS) & 1) ^ 1);
    uint8_t* sq = blk.sQO + s * 2 * Tile::kQBytes;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&blk.full[s], 2 * Tile::kQBytes);
      for (int c = 0; c < NC; ++c) {
        sm90::tma_load_4d(sq + c * BQ * 128, &a.tq, &blk.full[s], c * 64, q0,
                          h, blk.b);
        sm90::tma_load_4d(sq + Tile::kQBytes + c * BQ * 128, &a.tdo,
                          &blk.full[s], c * 64, q0, h, blk.b);
      }
    }
    const long long row0 = ((long long)blk.b * a.H + h) * a.Sq;
    float* rows = blk.sRows + s * 2 * BQ;
    for (int r = lane; r < BQ; r += 32) {
      const int qpos = q0 + r;
      const bool ok = qpos < a.Sq;
      rows[r] = ok ? a.lse[row0 + qpos] * kLog2e : 0.f;
      rows[BQ + r] = ok ? a.delta[row0 + qpos] : 0.f;
    }
    sm90::mbar_arrive(&blk.full[s]);
  }
}

// A consumer warpgroup of a bf16 dK/dV block: dK and dV of the 64 k rows
// from kw0, columns [c0, c0 + NCOL), in registers (NCOL / 2 f32 each a
// thread). Each step, `scores(st, dpt, q_addr, o_addr, it)` leaves the
// rows' S^T = K.Q^T and dP^T = V.dO^T against the step's Tile::kBQ q rows
// in st and dpt (f32 accumulator fragments, waited on); then P^T =
// exp(scale * S^T - lse) and dS^T = P^T (dP^T - delta) scale on the
// fragments, both 0 where the causal, window or ragged-row mask holds;
// dV += P^T.dO and dK += dS^T.Q as RS-wgmma with P^T and dS^T as bf16 A
// fragments and dO and Q read MN-major through the transpose bit
// (64-column blocks kBQ * 128 bytes apart, 2048 bytes a k16 step). Then
// the no-key dV term and the bf16 store of the rows below Sk.
template <typename T, typename Tile, int NCOL, typename Scores>
__device__ __forceinline__ void dkv_consume(const DkvArgs& a,
                                            const DkvBlock<Tile>& blk,
                                            int kw0, int c0, Scores scores) {
  constexpr int BQ = Tile::kBQ, NS = Tile::kStages;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int kr = kw0 + warp * 16 + (lane >> 2);  // rows kr, kr + 8
  const int cq = 2 * (lane & 3);                 // column in an 8-group
  const uint32_t cols = (c0 / 64) * BQ * 128;    // dO / Q column offset
  const bool causal = a.causal != 0;
  const bool windowed = causal && a.window > 0;

  float dk[NCOL / 2], dv[NCOL / 2];
#pragma unroll
  for (int i = 0; i < NCOL / 2; ++i) dk[i] = dv[i] = 0.f;

  sm90::mbar_wait(blk.kvbar, 0);
  for (int it = 0; it < blk.total; ++it) {
    const int g = it / blk.n_q;
    const int q0 = (blk.it_start + it - g * blk.n_q) * BQ;
    const int s = it % NS;
    const uint32_t q_addr = sm90::smem_u32(blk.sQO) + s * 2 * Tile::kQBytes;
    const uint32_t o_addr = q_addr + Tile::kQBytes;
    sm90::mbar_wait(&blk.full[s], (it / NS) & 1);

    float st[BQ / 2], dpt[BQ / 2];
    scores(st, dpt, q_addr, o_addr, it);

    // Masked entries are selected away, not branched around (see the note
    // at the top of the file).
    const float* rows = blk.sRows + s * 2 * BQ;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int c = 8 * (i >> 2) + cq + (i & 1);
      const int qpos = q0 + c;
      const int kpos = kr + 8 * ((i >> 1) & 1);
      const bool masked =
          (qpos >= a.Sq) |
          (causal & ((qpos < kpos) | (windowed & (qpos - kpos >= a.window))));
      float pv = sm90::ex2(fmaf(st[i], a.scale_log2, -rows[c]));
      pv = masked ? 0.f : pv;
      st[i] = pv;
      dpt[i] = pv * (dpt[i] - rows[BQ + c]) * a.scale;
    }

    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    sm90::to_a_frags<T>(st, pa);
    sm90::to_a_frags<T>(dpt, da);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      sm90::wgmma_rs<T>(dv, pa[kk], sm90::desc_sw128(o_addr + cols + kk * 2048,
                                                  BQ * 128, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      sm90::wgmma_rs<T>(dk, da[kk], sm90::desc_sw128(q_addr + cols + kk * 2048,
                                                  BQ * 128, 1024));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::fence_regs(pa);
    sm90::fence_regs(da);
    sm90::mbar_arrive(&blk.empty[s]);
  }

  const int q_first = first_no_key_row(a.causal, a.window, a.Sq, a.Sk);
  if (q_first < a.Sq) {  // rows that see no key: dV += their dO / Sk
    if (threadIdx.x < a.D) {
      blk.sU[threadIdx.x] =
          no_key_dv(static_cast<const T*>(a.dout), a.do_sb, a.do_ss,
                    a.do_sh, blk.b,
                    blk.hk * blk.group, blk.group, q_first, a.Sq, a.Sk,
                    threadIdx.x);
    }
    sm90::bar_sync<1, 256>();  // the consumers only
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j) {
      const int col = c0 + 8 * j + cq;
      if (col < a.D) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[4 * j + i] += blk.sU[col + (i & 1)];
      }
    }
  }

  // dK/dV are contiguous (B, Sk, Hkv, D).
  T* dkg = static_cast<T*>(a.dk);
  T* dvg = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = kr + 8 * r;
    if (kpos >= a.Sk) continue;
    const long long row =
        (((long long)blk.b * a.Sk + kpos) * a.Hkv + blk.hk) * a.D;
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j) {
      const int col = c0 + 8 * j + cq;
      if (col < a.D) {
        sm90::store2<T>(dkg + row + col, dk[4 * j + 2 * r],
                        dk[4 * j + 2 * r + 1]);
        sm90::store2<T>(dvg + row + col, dv[4 * j + 2 * r],
                        dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dK/dV for D <= DT <= 128: each consumer warpgroup owns 64 of the block's
// 128 k rows and all DT columns, and forms its rows' S^T and dP^T.
template <typename T, int DT>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_bf16_kernel(const __grid_constant__ DkvArgs a) {
  using Tile = DkvTile<DT>;
  constexpr int BK = Tile::kBK, BQ = Tile::kBQ;

  extern __shared__ uint8_t smem_raw[];
  const DkvBlock<Tile> blk(a, smem_raw);

  if (threadIdx.x >= 256) {  // producer warpgroup: warp 8 loads
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x < 288) dkv_produce(a, blk);
  } else {  // consumer warpgroups: 64 k rows each
    sm90::setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7;
    const uint32_t k_addr = sm90::smem_u32(blk.sK) + wg * 64 * 128;
    const uint32_t v_addr = sm90::smem_u32(blk.sV) + wg * 64 * 128;
    // S^T = K.Q^T and dP^T = V.dO^T, 64 k rows x BQ q columns.
    auto scores = [&](auto& st, auto& dpt, uint32_t q_addr, uint32_t o_addr,
                      int) {
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        sm90::wgmma_ss<T>(
            st, sm90::desc_sw128(k_addr + (kk >> 2) * BK * 128 + off, 16, 1024),
            sm90::desc_sw128(q_addr + (kk >> 2) * BQ * 128 + off, 16, 1024),
            kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        sm90::wgmma_ss<T>(
            dpt, sm90::desc_sw128(v_addr + (kk >> 2) * BK * 128 + off, 16, 1024),
            sm90::desc_sw128(o_addr + (kk >> 2) * BQ * 128 + off, 16, 1024),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
    };
    dkv_consume<T, Tile, DT>(a, blk, blk.k0 + wg * 64, 0, scores);
  }
}

// The tensor-core dK/dV kernels' arguments (and the wide dQ kernel's),
// the tensor maps' boxes bq rows of q and dO and bk rows of k and v; false
// when the driver refuses a map (pointer or strides not 16-byte aligned).
template <typename T>
bool tc_args(const Params& p, int bq, int bk, DkvArgs* a) {
  if (!sm90_host::bshd_map<T>(&a->tq, p.q, p.B, p.Sq, p.H, p.D, p.q_sb,
                              p.q_ss, p.q_sh, bq) ||
      !sm90_host::bshd_map<T>(&a->tdo, p.dout, p.B, p.Sq, p.H, p.D, p.do_sb,
                              p.do_ss, p.do_sh, bq) ||
      !sm90_host::bshd_map<T>(&a->tk, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb,
                              p.k_ss, p.k_sh, bk) ||
      !sm90_host::bshd_map<T>(&a->tv, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb,
                              p.v_ss, p.v_sh, bk)) {
    return false;
  }
  a->lse = p.lse;
  a->delta = p.delta;
  a->dout = p.dout;
  a->do_sb = p.do_sb;
  a->do_ss = p.do_ss;
  a->do_sh = p.do_sh;
  a->dk = p.dk;
  a->dv = p.dv;
  a->H = p.H;
  a->Hkv = p.Hkv;
  a->Sq = p.Sq;
  a->Sk = p.Sk;
  a->D = p.D;
  a->causal = p.causal;
  a->window = p.window;
  a->scale = p.scale;
  a->scale_log2 = p.scale * kLog2e;
  return true;
}

// Launches a bf16 dK/dV `kernel` whose tiles (Tile::kBK k rows, Tile::kBQ
// q rows) and shared memory Tile describes, one block per (batch*kv head,
// k tile).
template <typename T, typename Tile, typename Kernel>
cudaError_t launch_dkv_tiles(const Params& p, Kernel kernel,
                             cudaStream_t stream) {
  DkvArgs a;
  if (!tc_args<T>(p, Tile::kBQ, Tile::kBK, &a)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.Hkv, (p.Sk + Tile::kBK - 1) / Tile::kBK);
  kernel<<<grid, kWgThreads, Tile::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DT>
cudaError_t launch_dkv_bf16(const Params& p, cudaStream_t stream) {
  return launch_dkv_tiles<T, DkvTile<DT>>(p, flash_dkv_bf16_kernel<T, DT>,
                                          stream);
}

// ------------------- dK/dV, bf16, tensor cores, head dim split (D = 256) --

// dK/dV for 128 < D <= 256: the two consumer warpgroups split the head dim,
// not the rows. Warpgroup w keeps dK and dV columns [128w, 128w + 128) of
// all 64 k rows (64 + 64 f32 a thread). Both need the whole S^T and dP^T of
// the 64 rows (m64n32 SS-wgmma over all of D): warpgroup 0 forms S^T and
// warpgroup 1 dP^T, and they swap them through shared memory behind a
// named barrier (8 * D FLOP issued a pair, where forming both in each
// warpgroup issues 12 * D and measured 2-4 % slower, PERF.md).
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_bf16_dsplit_kernel(const __grid_constant__ DkvArgs a) {
  using Tile = DkvSplitTile;
  constexpr int BK = Tile::kBK, BQ = Tile::kBQ, D = Tile::kD;

  extern __shared__ uint8_t smem_raw[];
  const DkvBlock<Tile> blk(a, smem_raw);
  float* sX = blk.sU + D;  // the swap buffers, one per step parity

  if (threadIdx.x >= 256) {  // producer warpgroup: warp 8 loads
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x < 288) dkv_produce(a, blk);
  } else {  // consumer warpgroups: all 64 k rows, half of D each
    sm90::setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7;
    const int t = threadIdx.x & 127;
    const uint32_t a_addr = sm90::smem_u32(wg ? blk.sV : blk.sK);
    auto scores = [&](auto& st, auto& dpt, uint32_t q_addr, uint32_t o_addr,
                      int it) {
      // Warpgroup 0: S^T = K.Q^T; warpgroup 1: dP^T = V.dO^T. Then each
      // reads the other's from the same fragment slots.
      float mine[BQ / 2];
      const uint32_t b_addr = wg ? o_addr : q_addr;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        sm90::wgmma_ss<T>(
            mine,
            sm90::desc_sw128(a_addr + (kk >> 2) * BK * 128 + off, 16, 1024),
            sm90::desc_sw128(b_addr + (kk >> 2) * BQ * 128 + off, 16, 1024),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(mine);
      float* x = sX + (it & 1) * 2 * (BQ / 2) * 128;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) x[(wg * (BQ / 2) + i) * 128 + t] = mine[i];
      sm90::bar_sync<2, 256>();
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const float other = x[((1 - wg) * (BQ / 2) + i) * 128 + t];
        st[i] = wg ? other : mine[i];
        dpt[i] = wg ? mine[i] : other;
      }
    };
    dkv_consume<T, Tile, D / 2>(a, blk, blk.k0, wg * (D / 2), scores);
  }
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
  // Keys a step. At D = 256, Q and dO take 128 KiB, so a K/V stage of 64
  // keys (64 KiB) leaves room for one stage only; 32 keys fit three.
  static constexpr int kBK = DT <= 128 ? 64 : 32;
  // The pipelined consumers hold two stages at a time (K_it and K_(it-1)),
  // so a third lets the next load run ahead.
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kBQ * DT * 2;   // Q (or dO), resident
  static constexpr int kKVBytes = kBK * DT * 2;  // one K (or V) tile
  static constexpr int kTiles = 2 * kQBytes + kStages * 2 * kKVBytes;
  static constexpr size_t kSmem =  // alignment slack, tiles, barriers
      1024 + kTiles + 8 * (2 * kStages + 1);
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

template <typename T, int DT>
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
        sm90::wgmma_ss<T>(
            st, sm90::desc_sw128(q_addr + (kk >> 2) * BQ * 128 + off, 16, 1024),
            sm90::desc_sw128(k_addr + (kk >> 2) * BK * 128 + off, 16, 1024),
            kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        sm90::wgmma_ss<T>(
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
        sm90::wgmma_rs<T>(dq, da[kk],
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
      sm90::to_a_frags<T>(dpt, da);
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
      sm90::to_a_frags<T>(dpt, da);
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
    T* dqg = static_cast<T*>(a.dq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qr + 8 * r;
      if (qpos >= a.Sq) continue;
      const long long row = (((long long)b * a.Sq + qpos) * a.H + h) * a.D;
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < a.D) {
          sm90::store2<T>(dqg + row + col, dq[4 * j + 2 * r],
                          dq[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <typename T, int DT>
cudaError_t launch_dq_bf16(const Params& p, cudaStream_t stream) {
  using Tile = DqTile<DT>;
  DqArgs a;
  if (!sm90_host::bshd_map<T>(&a.tq, p.q, p.B, p.Sq, p.H, p.D, p.q_sb,
                              p.q_ss, p.q_sh, Tile::kBQ) ||
      !sm90_host::bshd_map<T>(&a.tdo, p.dout, p.B, p.Sq, p.H, p.D, p.do_sb,
                              p.do_ss, p.do_sh, Tile::kBQ) ||
      !sm90_host::bshd_map<T>(&a.tk, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb,
                              p.k_ss, p.k_sh, Tile::kBK) ||
      !sm90_host::bshd_map<T>(&a.tv, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb,
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
  auto kernel = flash_dq_bf16_kernel<T, DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.H, (p.Sq + Tile::kBQ - 1) / Tile::kBQ);
  kernel<<<grid, kWgThreads, Tile::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------- head dims above 256: bf16 and f16, tensor cores --

// The wide tensor-core kernels' arguments: DkvArgs, and dQ's output.
struct WideArgs : DkvArgs {
  void* dq;
};

// Shared memory of flash_dq_wide_bf16_kernel and flash_dkv_wide_bf16_kernel:
// a ring of kStages stages, each one 64-column chunk of the head dim of four
// 64-row tiles (M0, M1: the block's own rows; N0, N1: the step's rows), the
// warpgroup-0 P fragments in f32 for two step parities, the barriers and
// the no-key dV term of the span.
struct WideTile {
  static constexpr int kChunk = 64 * 128;  // one 64 x 64 16-bit tile, bytes
  static constexpr int kStage = 4 * kChunk;
  static constexpr int kStages = 5;  // > the 4 span chunks a step holds
  static constexpr int kSwap = 2 * 32 * 128 * 4;
  static constexpr int kSpan = 4;  // 64-column chunks of a span, at most
  static constexpr size_t kSmem =  // slack, stages, P, barriers, dV term
      1024 + kStages * kStage + kSwap + 8 * 2 * kStages + 4 * 64 * kSpan;
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// One block of the wide tensor-core backward (kDkv: dK/dV, else dQ). The
// block owns 64 rows of the output (k rows for dK/dV, q rows for dQ) and a
// span of its 64-column chunks, [64 sb, 64 (sb + ns)), blockIdx.z's share
// of the cdiv(D, 64) chunks split evenly between gridDim.z spans of at most
// kSpan chunks. Its steps walk the other side's 64-row tiles with the other
// kernels' loop bounds: for dK/dV the GQA group's q heads and their q tiles,
// for dQ the k tiles. In the transposed form of dK/dV the block's rows are
// M and the step's rows N: S^T = K.Q^T and dP^T = V.dO^T; for dQ S = Q.K^T
// and dP = dO.V^T; M0/M1/N0/N1 are K/V/Q/dO for dK/dV and Q/dO/K/V for dQ.
//
// Each step streams the head dim: one stage per 64-column chunk with the
// four tiles' columns, the span's chunks last. Warpgroup 0 forms the
// scores M0.N0^T, warpgroup 1 M1.N1^T (m64n64 SS-wgmma, K-major as
// stored), each stage released as soon as both are done with it, except
// the span's, which the products read. Warpgroup 0 turns its scores into P
// (exp2, every mask a select) and passes them to warpgroup 1 through
// shared memory (f32 fragments, one buffer per step parity), which forms
// dS = P (dP - delta) scale. Products (RS-wgmma, P and dS rounded to T in
// registers, the N tile read MN-major through the transpose bit), over the
// span's chunks: dK/dV, warpgroup 0 dV += P^T.dO and warpgroup 1
// dK += dS^T.Q; dQ, warpgroup 1 dQ += dS.K while warpgroup 0 runs ahead
// into the next step's scores. The accumulators (64 x 64 f32 per chunk, at
// most kSpan) stay in registers and are stored once.
template <typename T, bool kDkv>
__device__ __forceinline__ void wide_bwd_block(const WideArgs& a) {
  using W = WideTile;
  constexpr int NS = W::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  float* sX = reinterpret_cast<float*>(base + NS * W::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + NS * W::kStage +
                                               W::kSwap);
  uint64_t* empty = full + NS;
  float* sU = reinterpret_cast<float*>(empty + NS);  // the no-key dV term

  const int heads = kDkv ? a.Hkv : a.H;  // of the block's own rows
  const int b = blockIdx.x / heads;
  const int hm = blockIdx.x % heads;
  const int group = a.H / a.Hkv;
  // Heaviest causal tile first: the first k tile, the last q tile.
  const int m0 = (kDkv ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * 64;
  const int nch = (a.D + 63) / 64;
  const int sb = blockIdx.z * nch / gridDim.z;
  const int ns = (blockIdx.z + 1) * nch / gridDim.z - sb;
  const bool causal = a.causal != 0;
  const bool windowed = causal && a.window > 0;

  // The TPU kernels' loop bounds (64-row tiles on both sides).
  int n_first, n_tiles, steps;
  if constexpr (kDkv) {  // q tiles that see the block's keys, per q head
    const int n_qt = (a.Sq + 63) / 64;
    n_first = causal ? m0 / 64 : 0;
    const int end =
        windowed ? min(n_qt, (m0 + 126 + a.window) / 64) : n_qt;
    n_tiles = max(end - n_first, 0);
    steps = group * n_tiles;
  } else {  // k tiles the block's q rows see
    const int n_kt = (a.Sk + 63) / 64;
    const int end = causal ? min(n_kt, (m0 + 127) / 64) : n_kt;
    n_first = windowed ? max(m0 - (a.window - 1), 0) / 64 : 0;
    n_tiles = max(end - n_first, 0);
    steps = n_tiles;
  }
  // Step t's N-side head and first row.
  auto step_at = [&](int t, int& hn, int& n0) {
    const int g = n_tiles > 0 ? t / n_tiles : 0;
    hn = kDkv ? hm * group + g : hm / group;
    n0 = (n_first + t - g * n_tiles) * 64;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const CUtensorMap* mmap0 = kDkv ? &a.tk : &a.tq;
      const CUtensorMap* mmap1 = kDkv ? &a.tv : &a.tdo;
      const CUtensorMap* nmap0 = kDkv ? &a.tq : &a.tk;
      const CUtensorMap* nmap1 = kDkv ? &a.tdo : &a.tv;
      int item = 0;
      for (int t = 0; t < steps; ++t) {
        int hn, n0;
        step_at(t, hn, n0);
        for (int i = 0; i < nch; ++i, ++item) {
          const int c = 64 * ((sb + ns + i) % nch);  // the span's chunks last
          const int s = item % NS;
          sm90::mbar_wait(&empty[s], ((item / NS) & 1) ^ 1);
          uint8_t* st = base + s * W::kStage;
          uint64_t* bar = &full[s];
          sm90::mbar_arrive_expect_tx(bar, W::kStage);
          sm90::tma_load_4d(st, mmap0, bar, c, m0, hm, b);
          sm90::tma_load_4d(st + W::kChunk, mmap1, bar, c, m0, hm, b);
          sm90::tma_load_4d(st + 2 * W::kChunk, nmap0, bar, c, n0, hn, b);
          sm90::tma_load_4d(st + 3 * W::kChunk, nmap1, bar, c, n0, hn, b);
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
  const int mr = m0 + warp * 16 + (lane >> 2);  // rows mr, mr + 8
  const int cq = 2 * (lane & 3);                // column in an 8-group
  const bool prod = kDkv || wg == 1;            // holds a product
  const uint32_t stage0 = sm90::smem_u32(base);

  // dQ: the block's rows' lse * log2(e) (warpgroup 0) or delta (1).
  float rstat[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = mr + 8 * r;
    const long long at = (long long)blockIdx.x * a.Sq + qpos;
    rstat[r] = (!kDkv && qpos < a.Sq)
                   ? (wg == 0 ? a.lse[at] * kLog2e : a.delta[at])
                   : 0.f;
  }

  float acc[W::kSpan][32];
#pragma unroll
  for (int j = 0; j < W::kSpan; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

  int item = 0;
  for (int t = 0; t < steps; ++t, item += nch) {
    int hn, n0;
    step_at(t, hn, n0);
    // dK/dV: the step's q columns' lse * log2(e) (warpgroup 0) or delta
    // (1), columns n0 + 8j + cq + e.
    float cstat[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qpos = n0 + 8 * j + cq + e;
        const long long at = ((long long)b * a.H + hn) * a.Sq + qpos;
        cstat[2 * j + e] = (kDkv && qpos < a.Sq)
                               ? (wg == 0 ? a.lse[at] * kLog2e : a.delta[at])
                               : 0.f;
      }

    // Scores over the head dim, chunk by chunk.
    float sc[32];
    for (int i = 0; i < nch; ++i) {
      const int s = (item + i) % NS;
      sm90::mbar_wait(&full[s], ((item + i) / NS) & 1);
      const uint32_t am = stage0 + s * W::kStage + wg * W::kChunk;
      const uint32_t bn = am + 2 * W::kChunk;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_ss<T>(sc, sm90::desc_sw128(am + 32 * kk, 16, 1024),
                          sm90::desc_sw128(bn + 32 * kk, 16, 1024),
                          i > 0 || kk > 0);
      }
      sm90::wgmma_commit();
      if (i > 0) {
        sm90::wgmma_wait<1>();  // chunk i - 1 is done
        if (i - 1 < nch - ns || !prod) {
          sm90::mbar_arrive(&empty[(item + i - 1) % NS]);
        }
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    if (!prod) sm90::mbar_arrive(&empty[(item + nch - 1) % NS]);

    // P (warpgroup 0), then dS (warpgroup 1) on the fragments.
    float* x = sX + (t & 1) * 32 * 128;
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = n0 + 8 * (i >> 2) + cq + (i & 1);
        const int row = mr + 8 * ((i >> 1) & 1);
        const int qpos = kDkv ? col : row, kpos = kDkv ? row : col;
        const bool masked =
            (kDkv ? qpos >= a.Sq : kpos >= a.Sk) |
            (causal & ((qpos < kpos) | (windowed & (qpos - kpos >= a.window))));
        const float l = kDkv ? cstat[2 * (i >> 2) + (i & 1)]
                             : rstat[(i >> 1) & 1];
        float pv = sm90::ex2(fmaf(sc[i], a.scale_log2, -l));
        pv = masked ? 0.f : pv;
        sc[i] = pv;
        x[i * 128 + t128] = pv;
      }
    }
    sm90::bar_sync<1, 256>();  // the consumers only
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float dl = kDkv ? cstat[2 * (i >> 2) + (i & 1)]
                              : rstat[(i >> 1) & 1];
        sc[i] = x[i * 128 + t128] * (sc[i] - dl) * a.scale;
      }
    }

    // The span's products: dV += P^T.dO (warpgroup 0) and dK += dS^T.Q
    // (1), or dQ += dS.K (1); the N tile MN-major, 16 rows a k16 step.
    if (prod) {
      uint32_t fr[4][4];
      sm90::to_a_frags<T>(sc, fr);
      const int tile = kDkv && wg == 0 ? 3 : 2;  // dO, else Q or K
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < W::kSpan; ++j) {
        if (j < ns) {
          const uint32_t bt = stage0 +
                              ((item + nch - ns + j) % NS) * W::kStage +
                              tile * W::kChunk;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            sm90::wgmma_rs<T>(acc[j], fr[kk],
                              sm90::desc_sw128(bt + kk * 2048, 8192, 1024));
          }
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < W::kSpan; ++j) sm90::fence_regs(acc[j]);
      sm90::fence_regs(fr);
      for (int j = 0; j < ns; ++j) {
        sm90::mbar_arrive(&empty[(item + nch - ns + j) % NS]);
      }
    }
  }
  if (!prod) return;

  const int rows = kDkv ? a.Sk : a.Sq;
  if constexpr (kDkv) {
    const int q_first = first_no_key_row(a.causal, a.window, a.Sq, a.Sk);
    if (q_first < a.Sq && wg == 0) {  // rows that see no key: dV += dO / Sk
      for (int d = t128; d < 64 * ns; d += 128) {
        const int col = 64 * sb + d;
        sU[d] = col < a.D ? no_key_dv(static_cast<const T*>(a.dout), a.do_sb,
                                      a.do_ss, a.do_sh, b, hm * group, group,
                                      q_first, a.Sq, a.Sk, col)
                          : 0.f;
      }
      sm90::bar_sync<2, 128>();  // warpgroup 0 only
#pragma unroll
      for (int j = 0; j < W::kSpan; ++j) {
        if (j < ns) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            acc[j][i] += sU[64 * j + 8 * (i >> 2) + cq + (i & 1)];
          }
        }
      }
    }
  }

  // dQ (B, Sq, H, D), dK and dV (B, Sk, Hkv, D), contiguous.
  T* out = static_cast<T*>(kDkv ? (wg == 0 ? a.dv : a.dk) : a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = mr + 8 * r;
    if (row >= rows) continue;
    T* o = out + (((long long)b * rows + row) * heads + hm) * a.D;
#pragma unroll
    for (int j = 0; j < W::kSpan; ++j) {
      if (j < ns) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = 64 * (sb + j) + 8 * jj + cq;
          if (col < a.D) {
            sm90::store2<T>(o + col, acc[j][4 * jj + 2 * r],
                            acc[j][4 * jj + 2 * r + 1]);
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq_wide_bf16_kernel(const __grid_constant__ WideArgs a) {
  wide_bwd_block<T, false>(a);
}

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_wide_bf16_kernel(const __grid_constant__ WideArgs a) {
  wide_bwd_block<T, true>(a);
}

// which: 0 dQ, 1 dK/dV. One block per (batch * heads of the output, 64-row
// tile, span), cdiv(cdiv(D, 64), kSpan) spans.
template <typename T>
cudaError_t launch_wide_bf16(const Params& p, int which,
                             cudaStream_t stream) {
  WideArgs a;
  if (!tc_args<T>(p, 64, 64, &a)) return cudaErrorInvalidValue;
  a.dq = p.dq;
  auto kernel = which == 0 ? flash_dq_wide_bf16_kernel<T>
                           : flash_dkv_wide_bf16_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WideTile::kSmem);
  if (err != cudaSuccess) return err;
  const int nch = (p.D + 63) / 64;
  dim3 grid(p.B * (which == 0 ? p.H : p.Hkv),
            ((which == 0 ? p.Sq : p.Sk) + 63) / 64,
            (nch + WideTile::kSpan - 1) / WideTile::kSpan);
  kernel<<<grid, kWgThreads, WideTile::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// Tiles by head dim. Shared memory per block (KiB): the CUDA-core (f32)
// dQ 135 / 167 / 150 and dK/dV 168 / 201 / 167 for D <= 64 / 128 / 256;
// the tensor-core (bf16, f16) dQ 81 / 161 / 225 and dK/dV 68 / 134 / 195
// for D <= 64 / 128 / 256; the wide kernels (D > 256, every dtype) dQ 85
// and dK/dV 103. All under the 227 KiB a block may use.
template <typename T>
cudaError_t dispatch(const Params& p, int which, cudaStream_t s) {
  if (p.D > 256) {
    if constexpr (sizeof(T) == 2) {  // bf16/f16: tensor cores
      return launch_wide_bf16<T>(p, which, s);
    } else {
      return which == 0 ? launch_dq_wide_f32(p, s)
                        : launch_dkv_wide_f32(p, s);
    }
  }
  if (which == 0) {
    if constexpr (sizeof(T) == 2) {  // bf16/f16 dQ: tensor cores
      if (p.D <= 64) return launch_dq_bf16<T, 64>(p, s);
      if (p.D <= 128) return launch_dq_bf16<T, 128>(p, s);
      return launch_dq_bf16<T, 256>(p, s);
    } else {
      if (p.D <= 64) return launch_dq_f32<64>(p, s);
      if (p.D <= 128) return launch_dq_f32<128>(p, s);
      return launch_dq_f32<256>(p, s);
    }
  }
  if constexpr (sizeof(T) == 2) {  // bf16/f16 dK/dV: tensor cores
    if (p.D <= 64) return launch_dkv_bf16<T, 64>(p, s);
    if (p.D <= 128) return launch_dkv_bf16<T, 128>(p, s);
    return launch_dkv_tiles<T, DkvSplitTile>(
        p, flash_dkv_bf16_dsplit_kernel<T>, s);
  } else {
    if (p.D <= 64) return launch_dkv_f32<64>(p, s);
    if (p.D <= 128) return launch_dkv_f32<128>(p, s);
    return launch_dkv_f32<256>(p, s);
  }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* delta, void* dq,
        void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int D,
        long long q_sb, long long q_ss, long long q_sh, long long k_sb,
        long long k_ss, long long k_sh, long long v_sb, long long v_ss,
        long long v_sh, long long do_sb, long long do_ss, long long do_sh,
        int causal, int window, float scale, int dtype, void* stream) {
  if (D < 8 || D % 8 || Hkv <= 0 || H % Hkv) {
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
  if (dtype == 2) return (int)dispatch<__half>(p, which, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Strides are in elements.
// Each returns the cudaError_t of its launch (0 = launched); the caller
// checks it.
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
