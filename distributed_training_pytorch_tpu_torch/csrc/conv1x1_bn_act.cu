// Fused 1x1 convolution + folded BatchNorm affine + activation for Hopper (sm_90a):
// out[n, o] = act((sum_k x[n, k] * w[o, k]) * scale[o] + bias[o]), sums in f32.
//
// Replaces distributed_training_pytorch_tpu/ops/pallas.py::_conv1x1_kernel (launched by
// conv1x1_bn_act). It computes that kernel's function, not its blocks: the TPU kernel
// holds a whole [block_rows, Cin] slab of x and the whole [Cin, Cout] weight in VMEM and
// pads the rows to a multiple of block_rows; here one thread block owns a 128-row x
// 64-channel output tile and walks the input channels in steps of 32 through shared
// memory, rows past N and channels past Cin or Cout are masked by index, and nothing is
// padded or copied. x is read through its (b, h, w) element strides with a unit channel
// stride, so a channels-last activation, and the stride-2 view x[:, :, ::2, ::2] of a
// projection shortcut, are read in place.
//
// bf16 inputs multiply on the tensor cores (nvcuda::wmma, 16x16x16 bf16 fragments with
// f32 accumulators: each of the 8 warps owns a 32x32 quarter-column of the tile); f32
// inputs multiply on the CUDA cores, one FMA per multiply-add, so f32 results are f32
// sums (no TF32). The accumulators go through shared memory to the epilogue, which applies
// the per-output-channel affine in f32, then identity, relu or the tanh-approximate gelu
// of the f32 pre-activation (flax nn.gelu, jax.nn.gelu(approximate=True)), then casts to
// the output type.
//
// Bound at ResNet-50's stage-1 shapes (N = 802,816 rows at batch 256, Cin/Cout 64/256,
// bf16): about 28 FLOP a byte, far below the card's 295, so the bound is bytes (x read
// once, out written once): 0.06 to 0.18 ms a launch at 3.35 TB/s. This first version
// stages each K step synchronously (load, barrier, multiply), re-reads a row tile of x
// once per 64-channel column tile (from L2: the column tiles of one row tile are
// neighbouring blocks), and stores 2-byte outputs; TMA-fed wgmma with a persistent
// schedule is the later step toward the bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (distributed_training_pytorch_tpu_torch/ops/_build.py). The C entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int BM = 128;       // output rows (pixels) per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // input channels per K step
constexpr int THREADS = 256;  // 8 warps
constexpr int LDC = BN + 4;   // f32 accumulator tile row stride (a multiple of 4: wmma's ldm)

// Shared-memory row stride of a staged tile, in elements: bf16 rows of 40 (80 B: wmma
// wants a multiple of 8 elements and 32-B aligned fragment rows, which 16-row steps give),
// f32 rows of 36 (144 B: 16-B aligned float4 reads that fall on 8 distinct bank groups).
template <typename T>
struct Stage;
template <>
struct Stage<float> {
  static constexpr int LDS = BK + 4;
};
template <>
struct Stage<__nv_bfloat16> {
  static constexpr int LDS = BK + 8;
};

template <typename T>
constexpr int tiles_bytes() {
  return (BM + BN) * Stage<T>::LDS * static_cast<int>(sizeof(T));
}
constexpr int max_i(int a, int b) { return a > b ? a : b; }
// The staged x and w tiles and, after the K loop, the f32 accumulator tile share one buffer.
constexpr int SMEM_BYTES =
    max_i(max_i(tiles_bytes<float>(), tiles_bytes<__nv_bfloat16>()), BM * LDC * 4);

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

// Stage x[row0 .. row0 + BM, k0 .. k0 + BK) and w[col0 .. col0 + BN, k0 .. k0 + BK) into
// As[BM][LDS] and Ws[BN][LDS], zero past N, Cout or Cin. Neighbouring threads read
// neighbouring channels. VEC: 16-byte loads (the launcher checks that Cin, the strides and
// both pointers allow them); else one element a thread.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(T* As, T* Ws, const T* __restrict__ x,
                                      const T* __restrict__ w, const long long* roff, int row0,
                                      int col0, int k0, int N, int Cin, int Cout) {
  constexpr int LDS = Stage<T>::LDS;
  if constexpr (VEC) {
    constexpr int VE = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes
    constexpr int CPR = BK / VE;                           // 16-byte chunks a row
    for (int e = threadIdx.x; e < (BM + BN) * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * VE;
      const int k = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      T* dst;
      if (r < BM) {
        dst = As + r * LDS + c;
        if (row0 + r < N && k < Cin) v = *reinterpret_cast<const uint4*>(x + roff[r] + k);
      } else {
        const int o = r - BM;
        dst = Ws + o * LDS + c;
        if (col0 + o < Cout && k < Cin)
          v = *reinterpret_cast<const uint4*>(w + static_cast<long long>(col0 + o) * Cin + k);
      }
      *reinterpret_cast<uint4*>(dst) = v;
    }
  } else {
    for (int e = threadIdx.x; e < (BM + BN) * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int k = k0 + c;
      T v = from_f32<T>(0.f);
      if (r < BM) {
        if (row0 + r < N && k < Cin) v = x[roff[r] + k];
        As[r * LDS + c] = v;
      } else {
        const int o = r - BM;
        if (col0 + o < Cout && k < Cin) v = w[static_cast<long long>(col0 + o) * Cin + k];
        Ws[o * LDS + c] = v;
      }
    }
  }
}

// C[BM][LDC] = As . Ws^T over one K step, accumulated into the warp's wmma fragments:
// warp (wr, wc) = (warp / 2, warp % 2) owns rows wr*32 .. +32 and columns wc*32 .. +32.
using namespace nvcuda;
using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void mma_step(AccFrag (&acc)[2][2], const __nv_bfloat16* As,
                                         const __nv_bfloat16* Ws, int wr, int wc) {
  constexpr int LDS = Stage<__nv_bfloat16>::LDS;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Ws + (wc * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

// The f32 K step on the CUDA cores: thread (tr, tc) = (tid / 16, tid % 16) owns rows
// tr*8 .. tr*8 + 7 and columns tc, tc + 16, tc + 32, tc + 48 of the tile.
__device__ __forceinline__ void fma_step(float (&acc)[8][4], const float* As, const float* Ws,
                                         int tr, int tc) {
  constexpr int LDS = Stage<float>::LDS;
#pragma unroll 2
  for (int kk = 0; kk < BK; kk += 4) {
    float4 a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(&As[(tr * 8 + i) * LDS + kk]);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(&Ws[(tc + 16 * j) * LDS + kk]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// act: 0 identity, 1 relu, 2 tanh-approximate gelu.
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);  // sqrt(2/pi)
    return 0.5f * v * (1.f + tanhf(inner));
  }
  return v;
}

template <typename T, typename O, bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv1x1_bn_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          O* __restrict__ out, int N, int H, int W, int Cin, int Cout,
                          long long sb, long long sh, long long sw, int col_tiles, int act) {
  constexpr int LDS = Stage<T>::LDS;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ long long roff[BM];
  T* As = reinterpret_cast<T*>(smem);
  T* Ws = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem);

  // Neighbouring blocks share a row tile, so its x comes from L2 after the first read.
  const int col0 = (blockIdx.x % col_tiles) * BN;
  const int row0 = (blockIdx.x / col_tiles) * BM;
  if (threadIdx.x < BM) {
    const int n = row0 + threadIdx.x;
    long long off = 0;
    if (n < N) {
      const int hw = H * W;
      off = static_cast<long long>(n / hw) * sb + static_cast<long long>((n % hw) / W) * sh +
            static_cast<long long>(n % W) * sw;
    }
    roff[threadIdx.x] = off;
  }

  const int warp = threadIdx.x / 32;
  const int wr = warp / 2, wc = warp % 2;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  AccFrag acc_mma[2][2];
  float acc_fma[8][4];
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc_mma[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_fma[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    __syncthreads();  // roff is written (first step), or the previous step's tiles are read
    stage<T, VEC>(As, Ws, x, w, roff, row0, col0, k0, N, Cin, Cout);
    __syncthreads();
    if constexpr (sizeof(T) == 2)
      mma_step(acc_mma, As, Ws, wr, wc);
    else
      fma_step(acc_fma, As, Ws, tr, tc);
  }
  __syncthreads();  // every warp is done with the staged tiles: Cs takes their place

  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16, acc_mma[i][j],
                                LDC, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(tr * 8 + i) * LDC + tc + 16 * j] = acc_fma[i][j];
  }
  __syncthreads();

  // Epilogue: neighbouring threads write neighbouring output channels of a row.
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int n = row0 + r, o = col0 + c;
    if (n < N && o < Cout) {
      const float v = Cs[r * LDC + c] * scale[o] + bias[o];
      out[static_cast<long long>(n) * Cout + o] = from_f32<O>(activate(v, act));
    }
  }
}

template <typename T, typename O>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* bias, void* out,
                   int N, int H, int W, int Cin, int Cout, long long sb, long long sh,
                   long long sw, int act, cudaStream_t stream) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
  const bool vec = Cin % VE == 0 && sb % VE == 0 && sh % VE == 0 && sw % VE == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int col_tiles = (Cout + BN - 1) / BN;
  const long long blocks = static_cast<long long>(col_tiles) * ((N + BM - 1) / BM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  O* ot = static_cast<O*>(out);
  if (vec)
    conv1x1_bn_act_kernel<T, O, true><<<grid, THREADS, 0, stream>>>(
        xt, wt, scale, bias, ot, N, H, W, Cin, Cout, sb, sh, sw, col_tiles, act);
  else
    conv1x1_bn_act_kernel<T, O, false><<<grid, THREADS, 0, stream>>>(
        xt, wt, scale, bias, ot, N, H, W, Cin, Cout, sb, sh, sw, col_tiles, act);
  return cudaGetLastError();
}

}  // namespace

// x: [B, H, W, Cin] read through its element strides (sb, sh, sw) with a unit channel
// stride, N = B * H * W rows; w: contiguous [Cout, Cin] of x's type; scale, bias:
// contiguous f32 [Cout]; out: contiguous [N, Cout]. in_dtype / out_dtype: 0 = float32,
// 1 = bfloat16. act: 0 identity, 1 relu, 2 tanh-approximate gelu.
extern "C" int dtp_conv1x1_bn_act(const void* x, const void* w, const void* scale,
                                  const void* bias, void* out, int in_dtype, int out_dtype,
                                  int N, int H, int W, int Cin, int Cout, long long sb,
                                  long long sh, long long sw, int act, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (in_dtype == 0 && out_dtype == 0)
    err = launch<float, float>(x, w, sc, bi, out, N, H, W, Cin, Cout, sb, sh, sw, act, st);
  else if (in_dtype == 0 && out_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, w, sc, bi, out, N, H, W, Cin, Cout, sb, sh, sw, act, st);
  else if (in_dtype == 1 && out_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, w, sc, bi, out, N, H, W, Cin, Cout, sb, sh, sw, act, st);
  else if (in_dtype == 1 && out_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, sc, bi, out, N, H, W, Cin, Cout, sb, sh, sw,
                                               act, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
