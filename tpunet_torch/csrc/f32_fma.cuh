// The register-tiled f32 FMA loops of the CUDA-core kernels: the f32 dQ
// and dK/dV kernels, at every head dim (flash_bwd.cu), and the f32 wide
// forward (flash_fwd.cu). A 256-thread block is 16 row groups x 16 column lanes:
// thread (ty, tx) owns rows ty + 16i of its accumulator and, by the loop,
// columns tx + 16j (score products) or 64g + 4tx + e (row-chunk products).
// Every operand is a 16-byte shared load; the tiles are f32 in shared
// memory, row-major with padded strides.

#pragma once

#include "sm90.cuh"

// acc[i][j] += A[ty + 16i][0, W) . B[tx + 16j][0, W), A of row stride AS
// and B of row stride BS; zero first sets acc to 0. The score products:
// S and dP (dQ; A the resident or streamed Q or dO, B a K or V d-chunk),
// S^T and dP^T (dK/dV), the f32 wide forward's S. NJ + NI 16-byte loads feed
// 4 NI NJ FMAs.
template <int NI, int NJ, int W, int AS, int BS>
__device__ __forceinline__ void f32_score_chunk(float (&acc)[NI][NJ],
                                                const float* a,
                                                const float* b, int tx,
                                                int ty, bool zero = false) {
  if (zero) {
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < W; d += 4) {
    float4 bv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = sm90::lds4(b + (tx + 16 * j) * BS + d);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float4 av = sm90::lds4(a + (ty + 16 * i) * AS + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][4g + e] += sum over r < R of A[ty + 16i][r] * B[r][64g + 4tx + e]
// (g < NCOL / 4, e < 4), A of row stride AS and B of row stride BS: the
// products of P, dS, P^T or dS^T with a row chunk (dQ += dS.K; dV += P^T.dO
// and dK += dS^T.Q; the wide forward's o += P.V). NI + NCOL 16-byte loads
// feed 4 NI NCOL FMAs.
template <int NI, int NCOL, int R, int AS, int BS>
__device__ __forceinline__ void f32_product_chunk(float (&acc)[NI][NCOL],
                                                  const float* a,
                                                  const float* b, int tx,
                                                  int ty) {
#pragma unroll 2
  for (int r = 0; r < R; r += 4) {
    float4 pr[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) pr[i] = sm90::lds4(a + (ty + 16 * i) * AS + r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 ov[NCOL / 4];
#pragma unroll
      for (int gg = 0; gg < NCOL / 4; ++gg)
        ov[gg] = sm90::lds4(b + (r + e) * BS + 64 * gg + 4 * tx);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float pe = e == 0 ? pr[i].x
                         : e == 1 ? pr[i].y
                         : e == 2 ? pr[i].z
                                  : pr[i].w;
#pragma unroll
        for (int gg = 0; gg < NCOL / 4; ++gg) {
          acc[i][4 * gg] = fmaf(pe, ov[gg].x, acc[i][4 * gg]);
          acc[i][4 * gg + 1] = fmaf(pe, ov[gg].y, acc[i][4 * gg + 1]);
          acc[i][4 * gg + 2] = fmaf(pe, ov[gg].z, acc[i][4 * gg + 2]);
          acc[i][4 * gg + 3] = fmaf(pe, ov[gg].w, acc[i][4 * gg + 3]);
        }
      }
    }
  }
}
