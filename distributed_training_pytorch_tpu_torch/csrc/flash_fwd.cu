// Flash-attention forward on the CUDA cores (sm_90a): O = softmax(D^-0.5 * Q K^T, masked) V
// plus the per-row log-sum-exp, on [B, T, H, D] tensors read through strides, for f32
// inputs (D = 8 to 128) and bf16 inputs with D = 8, 16 or 32. bf16 at D = 64 and 128, the
// shapes of the models' paths, run the tensor-core kernel of flash_fwd_wgmma.cu;
// ops/flash_attention.py::kernel_variant picks the file by dtype and D.
//
// Replaces distributed_training_pytorch_tpu/ops/pallas.py::_fwd_kernel (launched by
// _fwd_call) for those inputs. It computes that kernel's function, not its blocks: the TPU
// kernel holds a whole [T, D] K/V slab in VMEM and runs one 1024-row q-block per grid step;
// here one thread block owns a 64-row query tile of one (batch, head) and streams 64-row
// K/V tiles through shared memory, carrying the running max, sum and output accumulator in
// f32 registers (the online softmax). Masking follows the TPU kernel exactly: keys at or
// past seq_len (the caller's valid_len, or Tk) and, when causal, keys after the query get
// the logit -1e30; a row whose sum l is 0 divides by 1. p is rounded to the input type
// before P V, l sums the unrounded p. Key tiles wholly above the diagonal are skipped,
// which changes no real row: each of them sees key 0 in the first tile.
//
// Its products run on the CUDA cores in f32 (one FMA per multiply-add; q, k and v are
// widened to f32 as they are staged), so it is bound by those FMAs and shared-memory
// reads, far above the inputs' bound (bytes, for attention at these widths): the f32
// inputs' parity bound leaves no cheaper product, and the small head dims are below the
// wgmma tiles' 64-column rows. Every input element is read from device memory once per
// query tile that needs it (K/V tiles come from L2 for the other tiles), the [T, T] scores
// never leave the SM, and the ragged edge is masked in place, with no transpose or pad
// copies.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (distributed_training_pytorch_tpu_torch/ops/_build.py). The C entry point returns
// cudaGetLastError() after the launch.

#include "flash_common.cuh"

#include <cstdint>

namespace {

using namespace dtp_flash;

// Dynamic shared memory of one block: Q, K and V tiles in f32 with rows of D + 4, and P.
constexpr int smem_bytes(int D) {
  return (BQ * (D + 4) + 2 * BK * (D + 4) + BQ * (BK + 1)) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int H, int Tq, int seq_len, int causal,
                     float scale) {
  // Rows of D + 4 (see stage_tile); P's stride BK + 1 spreads its rows over the banks.
  constexpr int LD = D + 4;
  constexpr int LP = BK + 1;
  constexpr int DJ = D / 8;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  // Causal tiles further down the sequence do more work: launch them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int l8 = lane % 8;                                    // column slot within a row
  const int row_base = (threadIdx.x / 32) * 16 + (lane / 8) * 4;  // this thread's 4 rows

  stage_tile<T, D>(Qs, q, sq, bi, hi, q0, Tq);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(seq_len, q0 + BQ) : seq_len;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V (and, first time round, nothing) is free
    stage_tile<T, D>(Ks, k, sk, bi, hi, k0, seq_len);
    stage_tile<T, D>(Vs, v, sv, bi, hi, k0, seq_len);
    __syncthreads();

    // s[i][j]: row row_base + i against key k0 + l8 + 8 j.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    tile_dot<D>(s, Qs, Ks, row_base, l8);

    // Mask, then the online softmax; the 8 lanes that share a row reduce by shuffles.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + row_base + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + l8 + 8 * j;
        const bool keep = kj < seq_len && (!causal || qi >= kj);
        s[i][j] = keep ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
      // P V takes p rounded to the input type, as _fwd_kernel's p.astype(v.dtype); l
      // summed the unrounded p above.
#pragma unroll
      for (int j = 0; j < 8; ++j) Ps[(row_base + i) * LP + l8 + 8 * j] = round_to<T>(s[i][j]);
    }
    __syncwarp();  // a row's P is written and read by the 8 lanes of one warp

    // acc[i][j] += sum_c P[row_base + i][c] * V[c][l8 + 8 j]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(row_base + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * LD + l8 + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + row_base + i;
    if (qi >= Tq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + bi * so.b + qi * so.t + hi * so.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[l8 + 8 * j] = from_f32<T>(acc[i][j] / l_safe);
    if (l8 == 0) lse[((long long)bi * H + hi) * Tq + qi] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   Strides sq, Strides sk, Strides sv, Strides so, int B, int H, int Tq,
                   int seq_len, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes(D);
  auto kernel = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, sv, so, H, Tq, seq_len, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* o, float* lse,
                     Strides sq, Strides sk, Strides sv, Strides so, int B, int H, int Tq,
                     int seq_len, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, lse, sq, sk, sv, so, B, H, Tq, seq_len, causal, scale, stream);
    case 16: return launch<T, 16>(q, k, v, o, lse, sq, sk, sv, so, B, H, Tq, seq_len, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, sq, sk, sv, so, B, H, Tq, seq_len, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, sq, sk, sv, so, B, H, Tq, seq_len, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, sq, sk, sv, so, B, H, Tq, seq_len, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for [B, T, H, D] with the D
// stride 1; lse is a contiguous f32 [B, H, Tq]. Keys at or past seq_len are masked.
extern "C" int dtp_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int dtype, int B, int H, int Tq, int seq_len, int D,
                             long long sqb, long long sqt, long long sqh, long long skb,
                             long long skt, long long skh, long long svb, long long svt,
                             long long svh, long long sob, long long sot, long long soh,
                             int causal, float scale, void* stream) {
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh}, so{sob, sot, soh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0)
    err = launch_d<float>(D, q, k, v, o, lse_f, sq, sk, sv, so, B, H, Tq, seq_len, causal, scale, st);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(D, q, k, v, o, lse_f, sq, sk, sv, so, B, H, Tq, seq_len, causal, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Dynamic shared memory one block of the kernel takes at head dim D (0 for an unsupported D).
extern "C" int dtp_flash_fwd_smem_bytes(int D) {
  return (D == 8 || D == 16 || D == 32 || D == 64 || D == 128) ? smem_bytes(D) : 0;
}
