// Flash-attention forward on Hopper's tensor cores (sm_90a): O = softmax(D^-0.5 * Q K^T,
// masked) V and the per-row natural log-sum-exp, for bf16 [B, T, H, D] tensors with D = 64
// or 128, with wgmma products fed by TMA.
//
// Replaces distributed_training_pytorch_tpu/ops/pallas.py::_fwd_kernel (launched by
// _fwd_call) for those inputs; f32 inputs and bf16 at D = 8, 16, 32 run the CUDA-core
// kernel of flash_fwd.cu (wgmma reads f32 only as TF32, which the f32 parity bound does not
// allow). The function is the same as there: keys at or past seq_len (the caller's
// valid_len, or Tk) and, when causal, keys after the query by absolute index get the logit
// -1e30; the online softmax keeps its running max and sum in f32; p is rounded to bf16
// before the P V product while l sums the unrounded p (_fwd_kernel's p.astype(v.dtype));
// a row whose l is 0 divides by 1; Tq and Tk may differ.
//
// Design. One warpgroup (128 threads) per thread block, one block per (b, h, 64 query
// rows), and every product a wgmma m64n64k16 (hopper_common.cuh). The Q tile arrives by
// TMA once and stays in shared memory; 64-row K and V tiles stream through a 2-stage ring
// of TMA loads (128-byte swizzle, one mbarrier a stage), so tile i + 1 is in flight while
// tile i is multiplied. Per tile: S = Q K^T with both operands in shared memory; the mask
// (on edge and diagonal tiles only) and the online softmax on S's accumulator fragment, in
// base 2 with D^-0.5 log2(e) folded into one multiply, each row's max and sum reduced over
// the 4 lanes that hold it; acc *= alpha; then acc += P V with P packed in bf16 as the
// register A operand (the accumulator fragment of a product over 64 keys is the A fragment
// of the next product over those keys) and the V tile read MN-major. No score tile goes
// through shared memory. Causal: key tiles past the block's last row are skipped, and the
// blocks further down the sequence, which do the most tiles, are launched first. Tiles run
// from key 0 upward, so every real row meets key 0 in its first tile and a tile that masks
// a whole row adds exp(-huge) = 0 to it. TMA zero-fills rows past the tensor's T; o is
// written as bf16 through its strides, rows at or past Tq skipped; lse (natural log:
// m2 ln 2 + ln l) goes to the contiguous f32 [B, H, Tq] the backward and the ring's merge
// read.
//
// Bound at the training shape (GPT-2-small, B=64, T=1024, H=12, D=64, causal: 524,800
// (query, key) pairs per (batch, head)): 2 products a pair = 103 GFLOP, 0.104 ms at 989
// TFLOP/s, against 405 MB of q, k, v, o and lse (0.121 ms at 3.35 TB/s): bound by bytes,
// narrowly. Still open: the exponentials and the products of one block do not overlap (one
// warpgroup, no producer warp; S of tile i + 1 is not issued before the softmax of tile i),
// and blocks are not persistent.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (distributed_training_pytorch_tpu_torch/ops/_build.py). The tensor maps are encoded on
// the host for each launch; the C entry point returns cudaGetLastError() after the launch.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using dtp_flash::LOG2E;
using dtp_flash::NEG_INF;
using dtp_flash::Strides;
using namespace dtp_hopper;
using bf16 = __nv_bfloat16;

constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared memory: 1024 bytes of alignment slack, five 64-row tiles of D/64 regions
// each (Q, then K and V in each of 2 stages), three mbarriers.
constexpr int fwd_wgmma_smem_bytes(int D) { return 1024 + 5 * (D / 64) * REGION_BYTES + 64; }

// One tile of the online softmax on S's accumulator fragment (rows: this thread's queries
// qrow and qrow + 8; columns: keys). s becomes the base-2 logits; m2 and l, each row's
// running max (base 2) and sum, are updated; alpha is what the output accumulator must be
// scaled by; p_a is p packed in bf16 as the A fragments of P V.
template <bool MASKED>
__device__ __forceinline__ void online_softmax(float (&s)[32], uint32_t (&p_a)[4][4], float (&m2)[2],
                                               float (&l)[2], float (&alpha)[2], float scale2, int qrow, int kcol,
                                               int seq_len, int causal) {
  float mx[2] = {m2[0], m2[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * h + e;
        float x = s[idx] * scale2;
        if (MASKED) {
          const int qi = qrow + 8 * h, kj = kcol + 8 * j + e;
          x = (kj < seq_len && (!causal || qi >= kj)) ? x : NEG_INF * LOG2E;
        }
        s[idx] = x;
        mx[h] = fmaxf(mx[h], x);
      }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = exp2f(m2[h] - mx[h]);
    m2[h] = mx[h];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p0 = exp2f(s[4 * j + 2 * h] - m2[h]);
      const float p1 = exp2f(s[4 * j + 2 * h + 1] - m2[h]);
      sum[h] += p0 + p1;
      p_a[j / 2][2 * (j % 2) + h] = pack_bf16(p0, p1);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * alpha[h] + sum[h];
  }
}

template <int D>
__global__ void __launch_bounds__(WG)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, float* __restrict__ lse,
                           Strides so, int H, int Tq, int seq_len, int causal, float scale) {
  constexpr int NR = D / 64;
  constexpr int OP = NR * REGION_BYTES;  // one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align_1024(smem_raw);
  uint8_t* stages = Qs + OP;  // stage s: K at stages + 2 s OP, V right after it
  uint64_t* bar = reinterpret_cast<uint64_t*>(stages + 4 * OP);  // [0]: Q; [1 + s]: stage s

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
    mbar_arrive_expect_tx(&bar[0], OP);
    load_tile<D>(Qs, &tm_q, &bar[0], q0, hi, bi);
    for (int s = 0; s < 2 && s < n_tiles; ++s) {
      mbar_arrive_expect_tx(&bar[1 + s], 2 * OP);
      load_tile<D>(stages + 2 * s * OP, &tm_k, &bar[1 + s], 64 * s, hi, bi);
      load_tile<D>(stages + (2 * s + 1) * OP, &tm_v, &bar[1 + s], 64 * s, hi, bi);
    }
  }

  const float scale2 = scale * LOG2E;
  float m2[2] = {NEG_INF * LOG2E, NEG_INF * LOG2E}, l[2] = {0.f, 0.f};
  float acc[NR][32];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[r][i] = 0.f;

  const uint64_t q_desc = sw128_desc(Qs);
  mbar_wait(&bar[0], 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1, k0 = 64 * i;
    uint8_t* Ks = stages + 2 * s * OP;
    const uint64_t k_desc = sw128_desc(Ks), v_desc = sw128_desc(Ks + OP);
    mbar_wait(&bar[1 + s], (i >> 1) & 1);

    float sc[32];
    fence_regs(sc);
    wgmma_fence();
    tile_product<D>(sc, q_desc, k_desc);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    uint32_t p_a[4][4];
    float alpha[2];
    if ((causal && k0 + 63 > q0) || k0 + 64 > seq_len) {
      online_softmax<true>(sc, p_a, m2, l, alpha, scale2, q0 + r0, k0 + c0, seq_len, causal);
    } else {
      online_softmax<false>(sc, p_a, m2, l, alpha, scale2, q0 + r0, k0 + c0, seq_len, causal);
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) acc[r][idx] *= alpha[(idx / 2) % 2];
    fence_frag(p_a);
    fence_acc(acc);
    wgmma_fence();
    register_product<NR>(acc, p_a, v_desc);
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

  const long long stat0 = ((long long)bi * H + hi) * Tq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r0 + 8 * h;
    if (qi >= Tq) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    bf16* row = o + bi * so.b + qi * so.t + hi * so.h;
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * r + 8 * j + c0) =
            __floats2bfloat162_rn(acc[r][4 * j + 2 * h] / l_safe, acc[r][4 * j + 2 * h + 1] / l_safe);
      }
    if (lane % 4 == 0) lse[stat0 + qi] = m2[h] * LN2 + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, Strides sq, Strides sk,
                   Strides sv, Strides so, int B, int H, int Tq, int seq_len, int causal, float scale,
                   cudaStream_t stream) {
  // q over Tq rows; k and v over seq_len rows, so TMA zero-fills the keys past it.
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const Strides strides[3] = {sq, sk, sv};
  const int rows[3] = {Tq, seq_len, seq_len};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err =
        make_bf16_bthd_map(&maps[i], ptrs[i], B, rows[i], H, D, strides[i].b, strides[i].t, strides[i].h);
    if (err != cudaSuccess) return err;
  }
  constexpr int smem = fwd_wgmma_smem_bytes(D);
  auto kernel = flash_fwd_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + 63) / 64, H, B);
  kernel<<<grid, WG, smem, stream>>>(maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, so, H, Tq, seq_len,
                                     causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The same arguments as dtp_flash_fwd (flash_fwd.cu). This takes dtype 1 (bfloat16) with
// D = 64 or 128 only, seq_len >= 1, and inputs that TMA can read: a 16-byte-aligned base and
// b, t, h element strides that are positive multiples of 8 (any stride of a size-1
// dimension). Anything else returns cudaErrorInvalidValue without a launch.
extern "C" int dtp_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                                   int B, int H, int Tq, int seq_len, int D, long long sqb, long long sqt,
                                   long long sqh, long long skb, long long skt, long long skh, long long svb,
                                   long long svt, long long svh, long long sob, long long sot, long long soh,
                                   int causal, float scale, void* stream) {
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh}, so{sob, sot, soh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype != 1 || seq_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return static_cast<int>(launch<64>(q, k, v, o, lse_f, sq, sk, sv, so, B, H, Tq, seq_len, causal, scale, st));
  if (D == 128) return static_cast<int>(launch<128>(q, k, v, o, lse_f, sq, sk, sv, so, B, H, Tq, seq_len, causal, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory one block of the kernel takes at head dim D (0 for an unsupported D).
extern "C" int dtp_flash_fwd_wgmma_smem_bytes(int D) { return D == 64 || D == 128 ? fwd_wgmma_smem_bytes(D) : 0; }
