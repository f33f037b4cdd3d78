// The tiles and helpers of flash_fwd_wide_kernel (flash_fwd.cu): the
// forward at head dims above 256, where no tile of the other forward
// kernels fits, in every dtype (float, __nv_bfloat16, __half) on the CUDA
// cores. (The wide backward has its own designs in flash_bwd.cu: the
// tensor cores for bf16 and f16, the f32 kernels with a span axis.)
//
// The design fits any head dim. A block owns 64 q rows and one 128-column
// slice of the head dim: grid.z walks the slices, and the block writes
// only its slice of o. Every score product runs over the whole head dim in
// 64-column chunks loaded into shared memory, so every slice block of a
// tile computes the same scores in the same order: bit for bit the same
// lse and P, and one block (slice 0) writes lse. The slice product P.V
// reads 64 x 128 tiles of the slice's columns.
//
// Tiles hold f32 in shared memory: each element is converted once as it
// is loaded (exact for bf16 and f16), and every product is an f32 FMA.
// For bf16 and f16 the TPU kernels run Precision.DEFAULT, one 16-bit MXU
// pass with f32 accumulation; so P is rounded to T before P.V
// (`rounded`), as the tensor-core kernels do, and the products of 16-bit
// inputs are exact in f32. For f32 nothing is rounded: exact f32 FMA, the
// counterpart of Precision.HIGHEST.
//
// 256 threads: thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16i
// (i < 4) of every tile, score columns tx + 16j (j < 4) and slice columns
// 64g + 4tx + e (g < 2, e < 4). Loads are synchronous, one barrier on each
// side of a chunk: a simple design, right at every head dim; its speed is
// ROADMAP B.9b's work.

#pragma once

#include "f32_fma.cuh"
#include "sm90.cuh"

namespace wide {

constexpr int kThreads = 256;
constexpr int kRows = 64;               // rows a block and keys (q rows) a step
constexpr int kCW = 64;                 // head-dim columns a score chunk
constexpr int kSlice = 128;             // output columns a block
constexpr int kCS = kCW + 4;            // row stride of chunks, P and dS
constexpr int kSS = kSlice + 4;         // row stride of slice tiles
constexpr int kChunk = kRows * kCS;     // floats of a chunk (or P, dS) tile
constexpr int kSliceTile = kRows * kSS;  // floats of a slice tile
static_assert(kRows == kCW, "P and dS tiles share the chunks' stride");

// Four consecutive elements as f32 (16 bytes of f32, 8 of a 16-bit type;
// the wrapper keeps both aligned).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
template <typename T>
__device__ __forceinline__ void st4(T* p, float a, float b, float c,
                                    float d) {
  sm90::store2<T>(p, a, b);
  sm90::store2<T>(p + 2, c, d);
}

// x as an operand of type T reads it: rounded to T (nearest even) for bf16
// and f16, x itself for f32.
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half2float(__float2half_rn(x));
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// Rows r0..r0+63 of one head of a (B, S, H, D) tensor (`base` points at
// the head, `ss` is the sequence stride), columns c0..c0+W-1, into a
// 64-row f32 tile of row stride LD. Rows past S and columns past D read as
// zeros.
template <int W, int LD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long ss, int r0, int S,
                                          int c0, int D) {
#pragma unroll
  for (int n = 0; n < kRows * W / 4 / kThreads; ++n) {
    const int u = threadIdx.x + kThreads * n;
    const int r = u / (W / 4), c = 4 * (u % (W / 4));
    const int pos = r0 + r, col = c0 + c;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < S && col < D) x = ld4(base + pos * ss + col);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// One row r of a thread's slice accumulator, times mul, into out (the
// output row's first element), the slice starting at column s0: columns
// past D are not written.
template <typename T>
__device__ __forceinline__ void store_slice_row(T* out, const float (&r)[8],
                                                float mul, int s0, int D,
                                                int tx) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int col = s0 + 64 * g + 4 * tx;
    if (col < D) {
      st4(out + col, r[4 * g] * mul, r[4 * g + 1] * mul, r[4 * g + 2] * mul,
          r[4 * g + 3] * mul);
    }
  }
}

}  // namespace wide
