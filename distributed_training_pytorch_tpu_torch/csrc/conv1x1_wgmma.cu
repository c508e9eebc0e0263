// Fused 1x1 convolution + folded BatchNorm affine + activation on Hopper's tensor cores
// (sm_90a), for bf16 in and out: out[n, o] = act((sum_k x[n, k] * w[o, k]) * scale[o] +
// bias[o]), sums in f32, the affine and the activation in f32, one rounding to bf16.
//
// Replaces distributed_training_pytorch_tpu/ops/pallas.py::_conv1x1_kernel (launched by
// conv1x1_bn_act) for bf16 in and out with Cin a multiple of 64 up to 512 and Cout a
// multiple of 64; f32, bf16 -> f32 and other channel counts run the CUDA-core kernel of
// conv1x1_bn_act.cu (ops/conv1x1.py::conv1x1_variant names the one that runs).
//
// Bound at ResNet-50's shapes (batch 256, bf16): about 28 FLOP a byte against the card's
// 295, so the bytes bound it (x read once, out written once): 0.06 to 0.18 ms a launch at
// 3.35 TB/s. The design keeps as many of those bytes in flight as shared memory allows and
// reads each x row once per column tile of up to 256 output channels:
//
// * One warpgroup (128 threads) a block; a persistent grid of as many blocks as fit on the
//   SMs, block b owning the column tile b % ncol and walking the row tiles b / ncol, + G, ...
//   (G = grid / ncol), so the blocks of one row tile run side by side and its second read
//   (ncol = 2, Cout 512) comes from L2.
// * The block's weight column tile ([NR * 64 output channels, Cin], K-major B operand,
//   one 64 x 64 region per 64 channels of each) arrives by TMA once and stays in shared
//   memory, with its scale and bias.
// * x row tiles ([rows, Cin] as Cin / 64 regions, K-major A operand) stream through a ring
//   of 2 to 4 stages of TMA loads (128-byte swizzle, one mbarrier a stage): the next
//   tiles' loads are in flight during this tile's products and epilogue.
// * Products: wgmma m64n64k16, NR accumulators of 32 registers (128 at Cout 256), one
//   commit group per 64-channel chunk in chunk order, so the epilogue of chunk r waits for
//   its own products only and runs while the tensor cores work on chunks r + 1, ...
// * Epilogue on the accumulator fragment: each thread's columns are fixed, the affine and
//   the activation (identity, relu, or the tanh-approximate gelu of the f32 pre-activation,
//   a template argument so that identity and relu carry no gelu arithmetic) run in f32 and
//   round once to bf16 into a swizzled 64 x 64 staging region (two alternate), which all
//   128 threads then write out as 16-byte stores, 8 threads to a 128-byte row.
// Measured on the card and not kept: a TMA store of the staging region (slower: one
// thread's stores and their bulk-group waits per chunk), stores straight from the
// fragment (4-byte pieces, much slower), one wgmma of N = 64 NR a k-step (no faster), two
// consumer warpgroups sharing the weight and the ring (slower), and a deeper ring with
// narrower column tiles for the shortcut (slower). With the x loads and the stores taken
// out, a 64 -> 256 launch still takes most of its time: the epilogue's instructions, not
// the bytes, hold this design back (PERF.md).
//
// x is read through its strides with a unit channel stride, as one of two TMA geometries
// the wrapper picks (ops/conv1x1.py::tma_rows): rows one stride apart (a contiguous or
// channels-last activation), in boxes of 64 rows; or, for the stride-2 view
// x[:, ::2, ::2, :] of a projection shortcut, whose (b, h) flatten but whose w does not,
// (w, b * h) with boxes of whole image rows (28 x 2 = 56 rows at ResNet-50's 28 x 28).
// Rows past the tensor are zero-filled on the load and skipped on the store.
//
// Shared memory: 1024 bytes of alignment slack, Cin / 64 * NR weight regions, stages *
// Cin / 64 x regions, 2 staging regions, scale and bias (2 KB), the mbarriers; at most 27
// regions (plan_channels() sizes the ring per shape and keeps every shape under 227 KB).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (distributed_training_pytorch_tpu_torch/ops/_build.py). The tensor maps are encoded on
// the host for each launch; the C entry point returns cudaGetLastError() after the launch.

#include <algorithm>

#include "hopper_common.cuh"

namespace {

using namespace dtp_hopper;
using bf16 = __nv_bfloat16;

constexpr int MAX_REGIONS = 27;
constexpr int OUT_STAGES = 2;  // staging regions
constexpr int EXTRA_BYTES = 1024 + 2048 + 128;  // alignment slack, scale and bias, mbarriers

// What one launch walks: the column tiles, x's TMA geometry and the ring depths.
struct Plan {
  int kr;          // Cin / 64 regions of x and of the weight
  int nr;          // 64-channel output chunks a column tile: the accumulators
  int ncol;        // column tiles
  int stages;      // x ring depth, in row tiles
  int cout;
  int n_rows, rows_w, tiles_w, box_w, box_bh, n_tiles;
};

int plan_smem_bytes(const Plan& p) {
  return EXTRA_BYTES + (p.kr * p.nr + p.stages * p.kr + OUT_STAGES) * REGION_BYTES;
}

// The column tiling and the x ring's depth for Cin -> Cout; false for channel counts the
// kernel does not take. The fewest column tiles of at most 4 chunks whose weight fits beside
// a ring of 2 x tiles and the staging; then as deep an x ring as fits, up to 4 tiles.
bool plan_channels(int cin, int cout, Plan& p) {
  if (cin < 64 || cin > 512 || cin % 64 != 0 || cout < 64 || cout % 64 != 0) return false;
  p.kr = cin / 64;
  p.cout = cout;
  const int chunks = cout / 64;
  for (p.nr = (chunks + (chunks + 3) / 4 - 1) / ((chunks + 3) / 4); p.nr > 1; --p.nr)
    if (p.kr * p.nr + 2 * p.kr + OUT_STAGES <= MAX_REGIONS) break;
  if (p.kr * p.nr + 2 * p.kr + OUT_STAGES > MAX_REGIONS) return false;
  p.ncol = (chunks + p.nr - 1) / p.nr;
  p.stages = std::min(4, (MAX_REGIONS - p.kr * p.nr - OUT_STAGES) / p.kr);
  return true;
}

// ACT: 0 identity, 1 relu, 2 tanh-approximate gelu (as conv1x1_bn_act.cu's epilogue). A
// template argument, so that an identity or relu epilogue carries no gelu arithmetic.
template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == 1) return fmaxf(v, 0.f);
  if (ACT == 2) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);  // sqrt(2/pi)
    return 0.5f * v * (1.f + tanhf(inner));
  }
  return v;
}

// One 64-channel chunk of the accumulator fragment through the affine and the activation
// into the staging region `stg`, rounded to bf16: each thread writes its two rows' pairs of
// columns as 4-byte words, at the 128-byte swizzle's chunk positions (row % 8 == lane / 4).
template <int ACT>
__device__ __forceinline__ void stage_chunk(uint8_t* stg, const float (&acc)[32], const float* sc, const float* bi,
                                            int r0, int lane) {
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 s2 = *reinterpret_cast<const float2*>(sc + 8 * j + c0);
    const float2 b2 = *reinterpret_cast<const float2*>(bi + 8 * j + c0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = activate<ACT>(acc[4 * j + 2 * h] * s2.x + b2.x);
      const float v1 = activate<ACT>(acc[4 * j + 2 * h + 1] * s2.y + b2.y);
      *reinterpret_cast<uint32_t*>(stg + (r0 + 8 * h) * 128 + ((j ^ (lane / 4)) << 4) + 4 * (lane % 4)) =
          pack_bf16(v0, v1);
    }
  }
}

template <int NR>
__global__ void __launch_bounds__(WG, 1)
    conv1x1_bn_act_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                                bf16* __restrict__ out, const float* __restrict__ scale,
                                const float* __restrict__ bias, const Plan p, int act) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ws = align_1024(smem_raw);               // region (k, r) at Ws + (k NR + r) REGION_BYTES
  uint8_t* Xs = Ws + p.kr * NR * REGION_BYTES;      // stage s, region k at Xs + (s kr + k) REGION_BYTES
  uint8_t* Os = Xs + p.stages * p.kr * REGION_BYTES;  // staging region q at Os + q REGION_BYTES
  float* sc = reinterpret_cast<float*>(Os + OUT_STAGES * REGION_BYTES);
  float* bi = sc + NR * 64;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bi + NR * 64);  // [0]: weight; [1 + s]: x stage s

  const int tid = threadIdx.x, lane = tid % 32;
  const int chunk0 = (blockIdx.x % p.ncol) * NR;  // the column tile's first 64-channel chunk
  const int n_chunks = min(NR, p.cout / 64 - chunk0);
  const int first = blockIdx.x / p.ncol, step = gridDim.x / p.ncol;
  const int n_mine = first < p.n_tiles ? (p.n_tiles - 1 - first) / step + 1 : 0;
  const int box_rows = p.box_w * p.box_bh;

  auto load_x = [&](int s, int t) {
    const int tw = t % p.tiles_w, tbh = t / p.tiles_w;
    mbar_arrive_expect_tx(&bar[1 + s], p.kr * box_rows * 128);
    for (int k = 0; k < p.kr; ++k)
      tma_load_box(Xs + (s * p.kr + k) * REGION_BYTES, &tm_x, &bar[1 + s], 0, tw * p.box_w, k, tbh * p.box_bh);
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + p.stages; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  for (int o = tid; o < NR * 64; o += WG) {
    const int c = chunk0 * 64 + o;
    sc[o] = c < p.cout ? scale[c] : 0.f;
    bi[o] = c < p.cout ? bias[c] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar[0], p.kr * n_chunks * REGION_BYTES);
    for (int k = 0; k < p.kr; ++k)
      for (int r = 0; r < n_chunks; ++r)
        tma_load_box(Ws + (k * NR + r) * REGION_BYTES, &tm_w, &bar[0], 0, (chunk0 + r) * 64, k, 0);
    for (int s = 0; s < p.stages && s < n_mine; ++s) load_x(s, first + s * step);
  }

  const int r0 = 16 * (tid / 32) + lane / 4;  // this thread's rows r0 and r0 + 8 of the fragment
  float acc[NR][32] = {};
  int slot = 0;  // the staging region the next chunk goes to
  mbar_wait(&bar[0], 0);
  for (int i = 0; i < n_mine; ++i) {
    const int s = i % p.stages, t = first + i * step;
    mbar_wait(&bar[1 + s], (i / p.stages) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      for (int k = 0; k < p.kr; ++k) {
        const uint64_t x_desc = sw128_desc(Xs + (s * p.kr + k) * REGION_BYTES);
        const uint64_t w_desc = sw128_desc(Ws + (k * NR + r) * REGION_BYTES);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(acc[r], x_desc + kmajor_step(kk), w_desc + kmajor_step(kk), (k | kk) != 0);
      }
      wgmma_commit();
    }
    const int tw = t % p.tiles_w, tbh = t / p.tiles_w;
    const int row0 = tbh * p.box_bh * p.rows_w + tw * p.box_w;  // the tile's first output row
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      wgmma_wait(NR - 1 - r);
      fence_regs(acc[r]);
      if (r == NR - 1) {
        __syncthreads();
        if (tid == 0 && i + p.stages < n_mine) {
          fence_proxy_async();
          load_x(s, t + p.stages * step);
        }
      }
      if (r >= n_chunks) continue;
      // The chunk goes into a staging region, then out as 16-byte stores, 8 threads a row.
      // Two regions alternate: a thread writes region q only after the barrier that
      // follows every thread's reads of it, two chunks back.
      uint8_t* stg = Os + slot * REGION_BYTES;
      if (act == 0) {
        stage_chunk<0>(stg, acc[r], sc + r * 64, bi + r * 64, r0, lane);
      } else if (act == 1) {
        stage_chunk<1>(stg, acc[r], sc + r * 64, bi + r * 64, r0, lane);
      } else {
        stage_chunk<2>(stg, acc[r], sc + r * 64, bi + r * 64, r0, lane);
      }
      __syncthreads();
      bf16* dst = out + static_cast<long long>(row0) * p.cout + (chunk0 + r) * 64;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = tid + WG * q, rr = e / 8, c16 = e % 8;
        if (rr < box_rows && row0 + rr < p.n_rows) {
          *reinterpret_cast<uint4*>(dst + static_cast<long long>(rr) * p.cout + 8 * c16) =
              *reinterpret_cast<const uint4*>(stg + rr * 128 + ((c16 ^ (rr % 8)) << 4));
        }
      }
      slot ^= 1;
    }
  }
}

template <int NR>
cudaError_t launch(const CUtensorMap (&maps)[2], bf16* out, const float* scale, const float* bias, const Plan& p,
                   int act, cudaStream_t stream) {
  auto kernel = conv1x1_bn_act_wgmma_kernel<NR>;
  const int smem = plan_smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WG, smem)) != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // Persistent: at most the blocks that fit at once, a multiple of ncol, none without a tile.
  const long long work = static_cast<long long>(p.n_tiles) * p.ncol;
  long long blocks = std::min(work, static_cast<long long>(sms) * per_sm);
  blocks = std::max(static_cast<long long>(p.ncol), blocks / p.ncol * p.ncol);
  kernel<<<static_cast<unsigned>(blocks), WG, smem, stream>>>(maps[0], maps[1], out, scale, bias, p, act);
  return cudaGetLastError();
}

}  // namespace

// x: bf16 rows of Cin channels (unit stride) as the wrapper's TMA geometry gives them:
// output row bh * rows_w + w is x at (w, bh), with element strides stride_w and stride_bh,
// read in boxes of box_w x box_bh rows (either box_bh = 1, or box_w = rows_w and
// box_w * box_bh <= 64); N = rows_w * rows_bh output rows. w: contiguous bf16 [Cout, Cin];
// scale, bias: contiguous f32 [Cout]; out: contiguous bf16 [N, Cout]. act: 0 identity,
// 1 relu, 2 tanh-approximate gelu. Cin a multiple of 64 up to 512, Cout a multiple of 64;
// anything else, or a view TMA cannot read (a base not 16-byte aligned, strides not
// positive multiples of 8), returns cudaErrorInvalidValue without a launch.
extern "C" int dtp_conv1x1_bn_act_wgmma(const void* x, const void* w, const void* scale, const void* bias, void* out,
                                        int Cin, int Cout, int rows_w, int rows_bh, long long stride_w,
                                        long long stride_bh, int box_w, int box_bh, int act, void* stream) {
  Plan p{};
  if (!plan_channels(Cin, Cout, p) || rows_w < 1 || rows_bh < 1 || box_w < 1 || box_bh < 1 ||
      box_w * box_bh > 64 || (box_bh > 1 && box_w != rows_w) || act < 0 || act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(rows_w) * rows_bh;
  if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.n_rows = static_cast<int>(n);
  p.rows_w = rows_w;
  p.box_w = box_w;
  p.box_bh = box_bh;
  p.tiles_w = (rows_w + box_w - 1) / box_w;
  const long long n_tiles = static_cast<long long>(p.tiles_w) * ((rows_bh + box_bh - 1) / box_bh);
  p.n_tiles = static_cast<int>(n_tiles);
  CUtensorMap maps[2];
  const int kr = Cin / 64;
  cudaError_t err = make_bf16_map(&maps[0], x, {64, rows_w, kr, rows_bh}, {stride_w, 64, stride_bh},
                                  {64, box_w, 1, box_bh});
  if (err == cudaSuccess) err = make_bf16_map(&maps[1], w, {64, Cout, kr, 1}, {Cin, 64, 64}, {64, 64, 1, 1});
  if (err != cudaSuccess) return static_cast<int>(err);
  bf16* o = static_cast<bf16*>(out);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.nr) {
    case 1: return static_cast<int>(launch<1>(maps, o, sc, bi, p, act, st));
    case 2: return static_cast<int>(launch<2>(maps, o, sc, bi, p, act, st));
    case 3: return static_cast<int>(launch<3>(maps, o, sc, bi, p, act, st));
    default: return static_cast<int>(launch<4>(maps, o, sc, bi, p, act, st));
  }
}

// Dynamic shared memory one block of the kernel takes for Cin -> Cout (0 for channel
// counts it does not take).
extern "C" int dtp_conv1x1_bn_act_wgmma_smem_bytes(int Cin, int Cout) {
  Plan p{};
  return plan_channels(Cin, Cout, p) ? plan_smem_bytes(p) : 0;
}
