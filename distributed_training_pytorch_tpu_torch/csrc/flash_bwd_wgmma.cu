// Flash-attention backward on Hopper's tensor cores (sm_90a): dq, and dk with dv, for bf16
// [B, T, H, D] tensors with D = 64 or 128, with wgmma products fed by TMA.
//
// Replaces distributed_training_pytorch_tpu/ops/pallas.py::_bwd_dq_kernel (launched by
// _dq_call) and ::_bwd_dkv_kernel (launched by _dkv_call) for those inputs; f32 inputs and
// bf16 at D = 8, 16, 32 run the CUDA-core kernels of flash_bwd.cu (wgmma reads f32 only as
// TF32, which the f32 parity bound does not allow). The function is the same as there:
//
//   p_ij = exp(scale * q_i . k_j - lse_i) under the forward's masks (logit -1e30 for keys at
//          or past seq_len and, when causal, keys after the query by absolute index; query
//          rows at or past Tq have p = 0), dp_ij = dO_i . v_j, ds_ij = p_ij (dp_ij - delta_i);
//   dq_i = scale * sum_j ds_ij k_j;   dk_j = scale * sum_i ds_ij q_i;   dv_j = sum_i p_ij dO_i,
//
// with p and ds rounded to bf16 before their products and every product accumulated in f32.
//
// Design. One warpgroup (128 threads) per thread block and every product a wgmma
// m64n64k16 (hopper_common.cuh):
// * dq (flash_bwd_dq_wgmma_kernel): one block per (b, h, 64 query rows). Q and dO stay in
//   shared memory; 64-row K and V tiles stream through a 2-stage ring of TMA loads
//   (128-byte swizzle, one mbarrier a stage), so tile i + 1 is in flight while tile i is
//   multiplied. Per tile: S = Q K^T and dP = dO V^T with both operands in shared memory
//   (K-major as stored); p and ds in registers on the accumulator fragment of S and dP;
//   dQ += dS K with dS as the register A operand (the accumulator fragment of a product
//   over 64 keys, packed in bf16 pairs, is the A fragment of the next product over those
//   keys) and the same K tile read MN-major. Causal: key tiles past the block's last row
//   are skipped, and the blocks further down the sequence are launched first.
// * dk/dv (flash_bwd_dkv_wgmma_kernel): one block per (b, h, 64 key rows). K and V stay in
//   shared memory; 64-row Q and dO tiles stream through the ring, with their lse and delta
//   staged in shared memory one tile ahead. Per tile: S^T = K Q^T and dP^T = V dO^T, p^T
//   and ds^T in registers, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as the
//   register A operands and the Q and dO tiles read MN-major. No score tile goes through
//   shared memory. Causal: query tiles before the block's first key are skipped.
// * The ragged edges: TMA zero-fills rows past the tensor's T, and every edge or diagonal
//   tile is also masked by index; outputs are written as bf16 through their strides.
//
// Bound at the training shape (GPT-2-small, B=64, T=1024, H=12, D=64, causal, 524,800
// (query, key) pairs per (batch, head)): dq does 3 products a pair (s, dp, ds.K) = 155
// GFLOP, 0.157 ms at 989 TFLOP/s, against 510 MB (0.152 ms at 3.35 TB/s); dk/dv does 4 (s,
// dp, p^T.dO, ds^T.Q) = 206 GFLOP, 0.209 ms, against 610 MB (0.182 ms): both bound by
// operations, which is why the products moved onto the tensor cores. Still open: s and dp
// are computed by both kernels (7 products a pair where one fused backward needs 5), the
// exponentials and the products of one block do not overlap (one warpgroup, no producer
// warp), and blocks are not persistent.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (distributed_training_pytorch_tpu_torch/ops/_build.py). The tensor maps are encoded on
// the host for each launch; each C entry point returns cudaGetLastError() after its launch.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using dtp_flash::LOG2E;
using dtp_flash::NEG_INF;
using dtp_flash::Strides;
using namespace dtp_hopper;
using bf16 = __nv_bfloat16;

// Dynamic shared memory: 1024 bytes of alignment slack, six 64-row tiles of D/64 regions
// each (dq: Q, dO, then K and V in each of 2 stages; dk/dv: K, V, then Q and dO in each
// stage), the dk/dv kernel's staged lse and delta (2 stages x 2 x 64 f32), three mbarriers.
constexpr int dq_wgmma_smem_bytes(int D) { return 1024 + 6 * (D / 64) * REGION_BYTES + 64; }
constexpr int dkv_wgmma_smem_bytes(int D) { return 1024 + 6 * (D / 64) * REGION_BYTES + 2 * 2 * 64 * 4 + 64; }

// p and ds on the accumulator fragments of S and dP of the dq kernel (rows: queries,
// columns: keys), packed in bf16 as the A fragments of dS K. lse2 is lse * log2(e).
template <bool MASKED>
__device__ __forceinline__ void dq_scores(const float (&s)[32], const float (&dp)[32], uint32_t (&ds_a)[4][4],
                                          const float (&lse2)[2], const float (&delta)[2], float scale2, int qrow,
                                          int kcol, int seq_len, int causal) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * h + e;
        float x = s[idx] * scale2;
        if (MASKED) {
          const int qi = qrow + 8 * h, kj = kcol + 8 * j + e;
          x = (kj < seq_len && (!causal || qi >= kj)) ? x : NEG_INF * LOG2E;
        }
        const float p = exp2f(x - lse2[h]);
        ds[e] = p * (dp[idx] - delta[h]);
      }
      ds_a[j / 2][2 * (j % 2) + h] = pack_bf16(ds[0], ds[1]);
    }
}

// p^T and ds^T on the accumulator fragments of S^T and dP^T of the dk/dv kernel (rows:
// keys, columns: queries), packed as the A fragments of P^T dO and dS^T Q. stats holds the
// query tile's lse * log2(e) (stats[0..63]) and delta (stats[64..127]).
template <bool MASKED>
__device__ __forceinline__ void dkv_scores(const float (&s)[32], const float (&dp)[32], uint32_t (&p_a)[4][4],
                                           uint32_t (&ds_a)[4][4], const float* stats, float scale2, int krow,
                                           int qcol, int c0, int Tq, int seq_len, int causal) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * h + e;
        const int c = 8 * j + c0 + e;
        float x = s[idx] * scale2;
        if (MASKED) {
          const int kj = krow + 8 * h, qi = qcol + c;
          x = (kj < seq_len && (!causal || qi >= kj)) ? x : NEG_INF * LOG2E;
          p[e] = qi < Tq ? exp2f(x - stats[c]) : 0.f;
        } else {
          p[e] = exp2f(x - stats[c]);
        }
        ds[e] = p[e] * (dp[idx] - stats[64 + c]);
      }
      p_a[j / 2][2 * (j % 2) + h] = pack_bf16(p[0], p[1]);
      ds_a[j / 2][2 * (j % 2) + h] = pack_bf16(ds[0], ds[1]);
    }
}

template <int D>
__global__ void __launch_bounds__(WG)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, Strides sdq, int H, int Tq, int seq_len, int causal,
                              float scale) {
  constexpr int NR = D / 64;
  constexpr int OP = NR * REGION_BYTES;  // one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align_1024(smem_raw);
  uint8_t* dOs = Qs + OP;
  uint8_t* stages = dOs + OP;  // stage s: K at stages + 2 s OP, V right after it
  uint64_t* bar = reinterpret_cast<uint64_t*>(stages + 4 * OP);  // [0]: Q and dO; [1 + s]: stage s

  // Causal blocks further down the sequence do more work: launch them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;  // this thread's rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);              // and columns c0, c0 + 1 of each group of 8
  const int k_end = causal ? min(seq_len, q0 + 64) : seq_len;
  const int n_tiles = (k_end + 63) / 64;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar[0], 2 * OP);
    load_tile<D>(Qs, &tm_q, &bar[0], q0, hi, bi);
    load_tile<D>(dOs, &tm_do, &bar[0], q0, hi, bi);
    for (int s = 0; s < 2 && s < n_tiles; ++s) {
      mbar_arrive_expect_tx(&bar[1 + s], 2 * OP);
      load_tile<D>(stages + 2 * s * OP, &tm_k, &bar[1 + s], 64 * s, hi, bi);
      load_tile<D>(stages + (2 * s + 1) * OP, &tm_v, &bar[1 + s], 64 * s, hi, bi);
    }
  }

  const long long stat0 = ((long long)bi * H + hi) * Tq;
  float lse2[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r0 + 8 * h;
    lse2[h] = qi < Tq ? lse[stat0 + qi] * LOG2E : 0.f;
    delta_r[h] = qi < Tq ? delta[stat0 + qi] : 0.f;
  }
  const float scale2 = scale * LOG2E;
  float acc[NR][32];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[r][i] = 0.f;

  const uint64_t q_desc = sw128_desc(Qs), do_desc = sw128_desc(dOs);
  mbar_wait(&bar[0], 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1, k0 = 64 * i;
    uint8_t* Ks = stages + 2 * s * OP;
    const uint64_t k_desc = sw128_desc(Ks), v_desc = sw128_desc(Ks + OP);
    mbar_wait(&bar[1 + s], (i >> 1) & 1);

    float sc[32], dp[32];
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    tile_product<D>(sc, q_desc, k_desc);
    tile_product<D>(dp, do_desc, v_desc);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    uint32_t ds_a[4][4];
    if ((causal && k0 + 63 > q0) || k0 + 64 > seq_len) {
      dq_scores<true>(sc, dp, ds_a, lse2, delta_r, scale2, q0 + r0, k0 + c0, seq_len, causal);
    } else {
      dq_scores<false>(sc, dp, ds_a, lse2, delta_r, scale2, q0 + r0, k0 + c0, seq_len, causal);
    }
    fence_frag(ds_a);
    fence_acc(acc);
    wgmma_fence();
    register_product<NR>(acc, ds_a, k_desc);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);

    __syncthreads();  // every warp is done with stage s: refill it with tile i + 2
    if (tid == 0 && i + 2 < n_tiles) {
      fence_proxy_async();
      mbar_arrive_expect_tx(&bar[1 + s], 2 * OP);
      load_tile<D>(Ks, &tm_k, &bar[1 + s], k0 + 128, hi, bi);
      load_tile<D>(Ks + OP, &tm_v, &bar[1 + s], k0 + 128, hi, bi);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r0 + 8 * h;
    if (qi >= Tq) continue;
    bf16* row = dq + bi * sdq.b + qi * sdq.t + hi * sdq.h;
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * r + 8 * j + c0) =
            __floats2bfloat162_rn(acc[r][4 * j + 2 * h] * scale, acc[r][4 * j + 2 * h + 1] * scale);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(WG)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk, Strides sdv, int H, int Tq,
                               int Tk, int seq_len, int causal, float scale) {
  constexpr int NR = D / 64;
  constexpr int OP = NR * REGION_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align_1024(smem_raw);
  uint8_t* Vs = Ks + OP;
  uint8_t* stages = Vs + OP;  // stage s: Q at stages + 2 s OP, dO right after it
  float* stats = reinterpret_cast<float*>(stages + 4 * OP);  // stage s: lse * log2(e) [64], delta [64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(stats + 2 * 128);  // [0]: K and V; [1 + s]: stage s

  // Causal: the first key blocks meet the most query tiles; they are launched first.
  const int k0 = blockIdx.x * 64;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;  // this thread's key rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);
  // A block wholly at or past seq_len has p = 0 everywhere: its dk/dv stay 0. Causal: query
  // tiles before this block see none of its keys.
  const int q_begin = causal ? k0 : 0;
  const int q_end = k0 < seq_len ? Tq : 0;
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + 63) / 64 : 0;
  const long long stat0 = ((long long)bi * H + hi) * Tq;
  const float scale2 = scale * LOG2E;

  float dk_acc[NR][32], dv_acc[NR][32];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[r][i] = dv_acc[r][i] = 0.f;

  // This thread's share of a query tile's statistics: lse (threads 0-63) or delta (64-127).
  auto stat = [&](int q0) {
    const int qi = q0 + tid % 64;
    if (qi >= Tq) return 0.f;
    return tid < 64 ? lse[stat0 + qi] * LOG2E : delta[stat0 + qi];
  };

  if (n_tiles > 0) {
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
      mbar_fence_init();
    }
    stats[tid] = stat(q_begin);
    __syncthreads();
    if (tid == 0) {
      mbar_arrive_expect_tx(&bar[0], 2 * OP);
      load_tile<D>(Ks, &tm_k, &bar[0], k0, hi, bi);
      load_tile<D>(Vs, &tm_v, &bar[0], k0, hi, bi);
      for (int s = 0; s < 2 && s < n_tiles; ++s) {
        mbar_arrive_expect_tx(&bar[1 + s], 2 * OP);
        load_tile<D>(stages + 2 * s * OP, &tm_q, &bar[1 + s], q_begin + 64 * s, hi, bi);
        load_tile<D>(stages + (2 * s + 1) * OP, &tm_do, &bar[1 + s], q_begin + 64 * s, hi, bi);
      }
    }
    const uint64_t k_desc = sw128_desc(Ks), v_desc = sw128_desc(Vs);
    mbar_wait(&bar[0], 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i & 1, q0 = q_begin + 64 * i;
      uint8_t* Qs = stages + 2 * s * OP;
      const uint64_t q_desc = sw128_desc(Qs), do_desc = sw128_desc(Qs + OP);
      const float next_stat = i + 1 < n_tiles ? stat(q0 + 64) : 0.f;  // in flight during the products
      mbar_wait(&bar[1 + s], (i >> 1) & 1);

      float sc[32], dp[32];
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      tile_product<D>(sc, k_desc, q_desc);
      tile_product<D>(dp, v_desc, do_desc);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      uint32_t p_a[4][4], ds_a[4][4];
      const float* st = stats + 128 * s;
      if ((causal && q0 < k0 + 63) || k0 + 64 > seq_len || q0 + 64 > Tq) {
        dkv_scores<true>(sc, dp, p_a, ds_a, st, scale2, k0 + r0, q0, c0, Tq, seq_len, causal);
      } else {
        dkv_scores<false>(sc, dp, p_a, ds_a, st, scale2, k0 + r0, q0, c0, Tq, seq_len, causal);
      }
      fence_frag(p_a);
      fence_frag(ds_a);
      fence_acc(dv_acc);
      fence_acc(dk_acc);
      wgmma_fence();
      register_product<NR>(dv_acc, p_a, do_desc);
      register_product<NR>(dk_acc, ds_a, q_desc);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(dv_acc);
      fence_acc(dk_acc);

      if (i + 1 < n_tiles) stats[128 * (s ^ 1) + tid] = next_stat;
      __syncthreads();  // stage s is read, the next tile's statistics written: refill stage s
      if (tid == 0 && i + 2 < n_tiles) {
        fence_proxy_async();
        mbar_arrive_expect_tx(&bar[1 + s], 2 * OP);
        load_tile<D>(Qs, &tm_q, &bar[1 + s], q0 + 128, hi, bi);
        load_tile<D>(Qs + OP, &tm_do, &bar[1 + s], q0 + 128, hi, bi);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = k0 + r0 + 8 * h;
    if (kj >= Tk) continue;
    bf16* dk_row = dk + bi * sdk.b + kj * sdk.t + hi * sdk.h;
    bf16* dv_row = dv + bi * sdv.b + kj * sdv.t + hi * sdv.h;
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * r + 8 * j + c0;
        *reinterpret_cast<__nv_bfloat162*>(dk_row + col) =
            __floats2bfloat162_rn(dk_acc[r][4 * j + 2 * h] * scale, dk_acc[r][4 * j + 2 * h + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_row + col) =
            __floats2bfloat162_rn(dv_acc[r][4 * j + 2 * h], dv_acc[r][4 * j + 2 * h + 1]);
      }
  }
}

struct Args {
  const void *q, *k, *v, *dO;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, H, Tq, Tk, seq_len, causal;
  float scale;
  cudaStream_t stream;
};

// The four inputs' tensor maps: q and dO over Tq rows, k and v over Tk.
template <int D>
cudaError_t input_maps(const Args& a, CUtensorMap (&maps)[4]) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dO};
  const Strides strides[4] = {a.sq, a.sk, a.sv, a.sdo};
  const int rows[4] = {a.Tq, a.Tk, a.Tk, a.Tq};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = make_bf16_bthd_map(&maps[i], ptrs[i], a.B, rows[i], a.H, D, strides[i].b,
                                               strides[i].t, strides[i].h);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq(const Args& a) {
  CUtensorMap maps[4];
  cudaError_t err = input_maps<D>(a, maps);
  if (err != cudaSuccess) return err;
  constexpr int smem = dq_wgmma_smem_bytes(D);
  auto kernel = flash_bwd_dq_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + 63) / 64, a.H, a.B);
  kernel<<<grid, WG, smem, a.stream>>>(maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, static_cast<bf16*>(a.dq),
                                       a.sdq, a.H, a.Tq, a.seq_len, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  CUtensorMap maps[4];
  cudaError_t err = input_maps<D>(a, maps);
  if (err != cudaSuccess) return err;
  constexpr int smem = dkv_wgmma_smem_bytes(D);
  auto kernel = flash_bwd_dkv_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + 63) / 64, a.H, a.B);
  kernel<<<grid, WG, smem, a.stream>>>(maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, static_cast<bf16*>(a.dk),
                                       static_cast<bf16*>(a.dv), a.sdk, a.sdv, a.H, a.Tq, a.Tk, a.seq_len, a.causal,
                                       a.scale);
  return cudaGetLastError();
}

}  // namespace

// The same arguments as dtp_flash_bwd_dq / dtp_flash_bwd_dkv (flash_bwd.cu). These take
// dtype 1 (bfloat16) with D = 64 or 128 only, and inputs that TMA can read: a 16-byte-aligned
// base and b, t, h element strides that are positive multiples of 8 (any stride of a size-1
// dimension). Anything else returns cudaErrorInvalidValue without a launch.
extern "C" int dtp_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* dO,
                                      const void* lse, const void* delta, void* dq, int dtype, int B, int H,
                                      int Tq, int Tk, int seq_len, int D, long long sqb, long long sqt,
                                      long long sqh, long long skb, long long skt, long long skh, long long svb,
                                      long long svt, long long svh, long long sdob, long long sdot,
                                      long long sdoh, long long sdqb, long long sdqt, long long sdqh, int causal,
                                      float scale, void* stream) {
  Args a{};
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
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return static_cast<int>(launch_dq<64>(a));
  if (D == 128) return static_cast<int>(launch_dq<128>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dtp_flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const void* dO,
                                       const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
                                       int H, int Tq, int Tk, int seq_len, int D, long long sqb, long long sqt,
                                       long long sqh, long long skb, long long skt, long long skh, long long svb,
                                       long long svt, long long svh, long long sdob, long long sdot,
                                       long long sdoh, long long sdkb, long long sdkt, long long sdkh,
                                       long long sdvb, long long sdvt, long long sdvh, int causal, float scale,
                                       void* stream) {
  Args a{};
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
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return static_cast<int>(launch_dkv<64>(a));
  if (D == 128) return static_cast<int>(launch_dkv<128>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory one block of each kernel takes at head dim D (0 for an unsupported D).
extern "C" int dtp_flash_bwd_dq_wgmma_smem_bytes(int D) {
  return D == 64 || D == 128 ? dq_wgmma_smem_bytes(D) : 0;
}
extern "C" int dtp_flash_bwd_dkv_wgmma_smem_bytes(int D) {
  return D == 64 || D == 128 ? dkv_wgmma_smem_bytes(D) : 0;
}
