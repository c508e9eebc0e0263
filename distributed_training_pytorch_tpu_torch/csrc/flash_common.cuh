// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu; the masked
// logit and the stride triple also by flash_bwd_wgmma.cu): the tile sizes, the thread
// layout of the CUDA-core kernels, f32 <-> storage-type conversion and the strided stage.
//
// Thread layout of the CUDA-core kernels: 128 threads = 4 warps x 16 rows of a 64-row tile;
// within a warp, lane / 8 picks 4 consecutive rows (row_base .. row_base + 3) and the 8
// lanes that share them (l8 = lane % 8) take columns l8, l8 + 8, ... of the other
// operand's 64-row tile. So a row's partial results are reduced by shuffles over 8 lanes,
// and a row of a score tile in shared memory is written and read by one warp only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dtp_flash {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 128;  // 4 warps x 16 rows; 8 lanes share a row
constexpr float NEG_INF = -1e30f;  // the JAX kernels' masked logit (f32-safe, unlike -inf)
constexpr float LOG2E = 1.4426950408889634f;  // the wgmma kernels' exponentials are exp2
static_assert(BQ == BK, "stage_tile stages 64 rows of either operand");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the storage type T and widened back: the JAX kernels' .astype(input dtype)
// of p and ds before their products.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

struct Strides {
  long long b, t, h;  // element strides of [B, T, H, D]; D has stride 1
};

// Stage rows [row0, row0 + 64) of one (batch, head) into dst[64][D + 4] as f32, zero past
// `limit`. Neighbouring threads read neighbouring d: coalesced. The row stride D + 4 keeps
// float4 reads 16-byte aligned and spreads the 8 rows a quarter warp reads over 8 distinct
// groups of 4 banks.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src, Strides s,
                                           int bi, int hi, int row0, int limit) {
  constexpr int LD = D + 4;
  const T* base = src + bi * s.b + hi * s.h;
  for (int e = threadIdx.x; e < BK * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * LD + c] = row < limit ? to_f32(base[row * s.t + c]) : 0.f;
  }
}

// acc[i][j] += sum_d A[row_base + i][d] * B[l8 + 8 j][d]: a 4 x 8 block of a 64 x 64
// product of two staged tiles, one FMA per multiply-add on the CUDA cores.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][8], const float* A, const float* B,
                                         int row_base, int l8) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&A[(row_base + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&B[(l8 + 8 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float a = acc[i][j];
        a = fmaf(av[i].x, bv[j].x, a);
        a = fmaf(av[i].y, bv[j].y, a);
        a = fmaf(av[i].z, bv[j].z, a);
        a = fmaf(av[i].w, bv[j].w, a);
        acc[i][j] = a;
      }
  }
}

}  // namespace dtp_flash
