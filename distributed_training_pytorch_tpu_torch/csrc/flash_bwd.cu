// Flash-attention backward on the CUDA cores (sm_90a): dq, and dk with dv, of
// O = softmax(D^-0.5 * Q K^T, masked) V, on [B, T, H, D] tensors read through strides, for
// f32 inputs (D = 8 to 128) and bf16 inputs with D = 8, 16 or 32. bf16 at D = 64 and 128,
// the shapes of the models' training paths, run the tensor-core kernels of
// flash_bwd_wgmma.cu; ops/flash_attention.py::kernel_variant picks the file by dtype and D.
//
// Replaces distributed_training_pytorch_tpu/ops/pallas.py::_bwd_dq_kernel (launched by
// _dq_call) and ::_bwd_dkv_kernel (launched by _dkv_call) for those inputs. Both recompute
// the attention weights from the forward's per-row log-sum-exp, p = exp(s - lse), under the
// forward's masks (logit -1e30 for keys at or past seq_len and, when causal, keys after the
// query by absolute index), and take delta = rowsum(dO * O) from the caller:
//
//   dq_i = scale * sum_j ds_ij k_j               (flash_bwd_dq_kernel)
//   dk_j = scale * sum_i ds_ij q_i,  dv_j = sum_i p_ij dO_i   (flash_bwd_dkv_kernel)
//   with dp_ij = dO_i . v_j and ds_ij = p_ij (dp_ij - delta_i).
//
// As in the JAX kernels, ds (and p, for dv) is rounded to the input dtype before its
// product, and every product accumulates in f32. The TPU kernels hold whole [T, D] slabs
// in VMEM and walk 1024-row blocks; here a thread block owns 64 rows of one (batch, head)
// and streams 64-row tiles of the other side through shared memory:
//
// * dq: one block per 64 query rows; keeps Q, dO, lse and delta of its rows, and streams
//   K/V tiles. Causal: only key tiles that start at or before its last row.
// * dk/dv: one block per 64 key rows; keeps K, V and the f32 dk/dv accumulators, and
//   streams Q/dO tiles with their lse and delta. Causal: only query tiles that end at or
//   after its first key. Query rows past Tq are masked by index (p = 0), since nothing is
//   padded: the JAX kernel relies on zero-padded dO and delta there instead.
//
// Key rows at or past seq_len get p = 0 in both kernels, so they receive dk = dv = 0.
//
// The products run on the CUDA cores in f32 (inputs widened as they are staged): f32 needs
// that, since the tensor cores read f32 only as TF32, which misses the f32 parity bound.
// What bounds it is those FMAs (67 TFLOP/s at most) and the shared-memory reads that feed
// them. What the design keeps out of device memory: the [T, T] scores, p and ds never
// leave the SM, and the ragged edges are masked in place with no pad or transpose copies.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (distributed_training_pytorch_tpu_torch/ops/_build.py). Each C entry point returns
// cudaGetLastError() after its launch.

#include "flash_common.cuh"

namespace {

using namespace dtp_flash;

constexpr int LP = 64 + 1;  // row stride of a 64 x 64 p or ds tile: spreads its rows over banks

// Dynamic shared memory of one block. dq: Q, dO, K, V tiles and ds. dk/dv: K, V, Q, dO
// tiles, p and ds, and the query tile's lse and delta.
constexpr int dq_smem_bytes(int D) {
  return (4 * 64 * (D + 4) + 64 * LP) * static_cast<int>(sizeof(float));
}
constexpr int dkv_smem_bytes(int D) {
  return (4 * 64 * (D + 4) + 2 * 64 * LP + 2 * 64) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, int H, int Tq, int seq_len, int causal, float scale) {
  constexpr int LD = D + 4;
  constexpr int DJ = D / 8;  // dq columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;

  // Causal tiles further down the sequence do more work: launch them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int l8 = lane % 8;
  const int row_base = (threadIdx.x / 32) * 16 + (lane / 8) * 4;

  stage_tile<T, D>(Qs, q, sq, bi, hi, q0, Tq);
  stage_tile<T, D>(dOs, dO, sdo, bi, hi, q0, Tq);
  const long long stat0 = ((long long)bi * H + hi) * Tq;
  float lse_r[4], delta_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + row_base + i;
    lse_r[i] = qi < Tq ? lse[stat0 + qi] : 0.f;
    delta_r[i] = qi < Tq ? delta[stat0 + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(seq_len, q0 + BQ) : seq_len;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V is free (first time round: Q/dO staged)
    stage_tile<T, D>(Ks, k, sk, bi, hi, k0, seq_len);
    stage_tile<T, D>(Vs, v, sv, bi, hi, k0, seq_len);
    __syncthreads();

    // s and dp for rows row_base + i against keys k0 + l8 + 8 j.
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D>(s, Qs, Ks, row_base, l8);
    tile_dot<D>(dp, dOs, Vs, row_base, l8);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + row_base + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + l8 + 8 * j;
        const bool keep = kj < seq_len && (!causal || qi >= kj);
        const float p = expf((keep ? s[i][j] * scale : NEG_INF) - lse_r[i]);
        dSs[(row_base + i) * LP + l8 + 8 * j] = round_to<T>(p * (dp[i][j] - delta_r[i]));
      }
    }
    __syncwarp();  // a row's ds is written and read by the 8 lanes of one warp

    // acc[i][j] += sum_c ds[row_base + i][c] * K[c][l8 + 8 j]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(row_base + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = Ks[c * LD + l8 + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + row_base + i;
    if (qi >= Tq) continue;
    T* row = dq + bi * sdq.b + qi * sdq.t + hi * sdq.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[l8 + 8 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dO,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
                         Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int Tq,
                         int Tk, int seq_len, int causal, float scale) {
  constexpr int LD = D + 4;
  constexpr int DJ = D / 8;  // dk/dv columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;   // [key row][query], rounded to T
  float* dSs = Ps + BK * LP;   // [key row][query], rounded to T
  float* lse_s = dSs + BK * LP;
  float* delta_s = lse_s + BQ;

  // Causal: the first key tiles meet the most query tiles; launch them first.
  const int k0 = blockIdx.x * BK;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int l8 = lane % 8;
  const int row_base = (threadIdx.x / 32) * 16 + (lane / 8) * 4;  // this thread's 4 keys

  stage_tile<T, D>(Ks, k, sk, bi, hi, k0, seq_len);
  stage_tile<T, D>(Vs, v, sv, bi, hi, k0, seq_len);
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // A tile wholly at or past seq_len has p = 0 everywhere: its dk/dv stay 0. Causal: query
  // tiles before this key tile see none of its keys (BQ == BK keeps the tiles aligned).
  const long long stat0 = ((long long)bi * H + hi) * Tq;
  const int q_begin = causal ? k0 : 0;
  const int q_end = k0 < seq_len ? Tq : 0;
  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();  // the previous query tile is free (first time round: K/V staged)
    stage_tile<T, D>(Qs, q, sq, bi, hi, q0, Tq);
    stage_tile<T, D>(dOs, dO, sdo, bi, hi, q0, Tq);
    for (int e = threadIdx.x; e < BQ; e += THREADS) {
      const int qi = q0 + e;
      lse_s[e] = qi < Tq ? lse[stat0 + qi] : 0.f;
      delta_s[e] = qi < Tq ? delta[stat0 + qi] : 0.f;
    }
    __syncthreads();

    // Transposed scores: s[i][j] for key k0 + row_base + i against query q0 + l8 + 8 j,
    // and dp[i][j] = dO[query] . V[key].
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D>(s, Ks, Qs, row_base, l8);
    tile_dot<D>(dp, Vs, dOs, row_base, l8);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + row_base + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = l8 + 8 * j;
        const int qi = q0 + c;
        const bool keep = kj < seq_len && (!causal || qi >= kj);
        const float p = qi < Tq ? expf((keep ? s[i][j] * scale : NEG_INF) - lse_s[c]) : 0.f;
        Ps[(row_base + i) * LP + c] = round_to<T>(p);
        dSs[(row_base + i) * LP + c] = round_to<T>(p * (dp[i][j] - delta_s[c]));
      }
    }
    __syncwarp();  // a key row's p and ds are written and read by the 8 lanes of one warp

    // dv[i][j] += sum_c p[row_base + i][c] * dO[c][l8 + 8 j]; dk likewise with ds and Q.
#pragma unroll 2
    for (int c = 0; c < BQ; ++c) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[(row_base + i) * LP + c];
        ds[i] = dSs[(row_base + i) * LP + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float dov = dOs[c * LD + l8 + 8 * j];
        const float qv = Qs[c * LD + l8 + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(p[i], dov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + row_base + i;
    if (kj >= Tk) continue;
    T* dk_row = dk + bi * sdk.b + kj * sdk.t + hi * sdk.h;
    T* dv_row = dv + bi * sdv.b + kj * sdv.t + hi * sdv.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_row[l8 + 8 * j] = from_f32<T>(dk_acc[i][j] * scale);
      dv_row[l8 + 8 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dO;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, H, Tq, Tk, seq_len, causal;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a) {
  constexpr int smem = dq_smem_bytes(D);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), a.lse, a.delta, static_cast<T*>(a.dq), a.sq, a.sk, a.sv,
      a.sdo, a.sdq, a.H, a.Tq, a.seq_len, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a) {
  constexpr int smem = dkv_smem_bytes(D);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + BK - 1) / BK, a.H, a.B);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H, a.Tq, a.Tk, a.seq_len, a.causal, a.scale);
  return cudaGetLastError();
}

// Dispatch on dtype (0 = float32, 1 = bfloat16) and head dim to launch_dq or launch_dkv.
template <bool DQ>
cudaError_t dispatch(int dtype, int D, const BwdArgs& a) {
#define DTP_BWD_CASE(T, DD) \
  case DD:                  \
    return DQ ? launch_dq<T, DD>(a) : launch_dkv<T, DD>(a);
  if (dtype == 0) {
    switch (D) {
      DTP_BWD_CASE(float, 8)
      DTP_BWD_CASE(float, 16)
      DTP_BWD_CASE(float, 32)
      DTP_BWD_CASE(float, 64)
      DTP_BWD_CASE(float, 128)
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      DTP_BWD_CASE(__nv_bfloat16, 8)
      DTP_BWD_CASE(__nv_bfloat16, 16)
      DTP_BWD_CASE(__nv_bfloat16, 32)
      default: return cudaErrorInvalidValue;  // D = 64, 128: flash_bwd_wgmma.cu
    }
  }
#undef DTP_BWD_CASE
  return cudaErrorInvalidValue;
}

bool known_head_dim(int D) { return D == 8 || D == 16 || D == 32 || D == 64 || D == 128; }

}  // namespace

// Strides are in elements, for [B, T, H, D] tensors with the D stride 1 (q, dq: Tq rows;
// k, v, dk, dv: Tk rows). lse and delta are contiguous f32 [B, H, Tq]. Keys at or past
// seq_len are masked. dtype: 0 = float32 (D = 8 to 128), 1 = bfloat16 (D = 8, 16, 32);
// anything else returns cudaErrorInvalidValue without a launch.
extern "C" int dtp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                                const void* lse, const void* delta, void* dq, int dtype,
                                int B, int H, int Tq, int Tk, int seq_len, int D,
                                long long sqb, long long sqt, long long sqh, long long skb,
                                long long skt, long long skh, long long svb, long long svt,
                                long long svh, long long sdob, long long sdot, long long sdoh,
                                long long sdqb, long long sdqt, long long sdqh, int causal,
                                float scale, void* stream) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dO = dO;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.sq = {sqb, sqt, sqh};
  a.sk = {skb, skt, skh};
  a.sv = {svb, svt, svh};
  a.sdo = {sdob, sdot, sdoh};
  a.sdq = {sdqb, sdqt, sdqh};
  a.B = B;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.seq_len = seq_len;
  a.causal = causal;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<true>(dtype, D, a));
}

extern "C" int dtp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int dtype, int B, int H, int Tq, int Tk, int seq_len, int D,
                                 long long sqb, long long sqt, long long sqh, long long skb,
                                 long long skt, long long skh, long long svb, long long svt,
                                 long long svh, long long sdob, long long sdot, long long sdoh,
                                 long long sdkb, long long sdkt, long long sdkh, long long sdvb,
                                 long long sdvt, long long sdvh, int causal, float scale,
                                 void* stream) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dO = dO;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  a.sq = {sqb, sqt, sqh};
  a.sk = {skb, skt, skh};
  a.sv = {svb, svt, svh};
  a.sdo = {sdob, sdot, sdoh};
  a.sdk = {sdkb, sdkt, sdkh};
  a.sdv = {sdvb, sdvt, sdvh};
  a.B = B;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.seq_len = seq_len;
  a.causal = causal;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<false>(dtype, D, a));
}

// Dynamic shared memory one block of each kernel takes at head dim D (0 for an unsupported D).
extern "C" int dtp_flash_bwd_dq_smem_bytes(int D) { return known_head_dim(D) ? dq_smem_bytes(D) : 0; }
extern "C" int dtp_flash_bwd_dkv_smem_bytes(int D) { return known_head_dim(D) ? dkv_smem_bytes(D) : 0; }
