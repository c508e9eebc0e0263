// The elementwise part of the fused 1x1 convolution's backward, in one pass over the
// gradient: dz[n, o] = to_dz_type(mask[n, o] * f32(g[n, o]) * scale[o]), where the mask is
// y > 0 for a relu epilogue (y the forward's output) and 1 for identity.
//
// Replaces the elementwise part of distributed_training_pytorch_tpu/ops/pallas.py::
// _conv1x1_bwd (g cast to f32, the relu mask, the multiply by scale, the cast to x's dtype),
// which XLA fuses into the operands of that backward's dots and PyTorch would run as three
// passes over [N, Cout] with f32 intermediates. The GEMMs dx = dz w and dw = dz^T x stay
// torch.matmul, as they stay XLA dots in the JAX package.
//
// Bound: bytes. g is read once (y too for relu) and dz written once: at ResNet-50's shapes
// in bf16, 4 bytes an element for identity, 1.18 G elements over one step's nine launches,
// 1.4 ms at 3.35 TB/s. Each thread moves 8 elements at a time as 16-byte loads and stores
// of bf16 (32 bytes of f32) where Cout is a multiple of 8 and every pointer is 16-byte
// aligned, else one element at a time; a grid-stride loop over as many blocks as fill the
// card. The arithmetic is the plain version's, one f32 multiply rounded once, so the two
// are bit-equal.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (distributed_training_pytorch_tpu_torch/ops/_build.py). The C entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int VE = 8;  // elements a thread moves at a time on the vector path

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// 8 consecutive elements as f32: one 16-byte load of bf16, two of f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[VE]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[VE]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[VE]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[VE]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The plain version's arithmetic: where(y > 0, g, 0) for relu, then times scale.
__device__ __forceinline__ float dz_of(float g, float y, float s, int relu) {
  const float gz = relu && !(y > 0.f) ? 0.f : g;
  return gz * s;
}

template <typename G, typename D, bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv1x1_bwd_dz_kernel(const G* __restrict__ g, const G* __restrict__ y, const float* __restrict__ scale,
                          D* __restrict__ dz, long long total, int cout, int relu) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if constexpr (VEC) {
    for (long long c = first; c < total / VE; c += stride) {
      const long long e = c * VE;
      const int o = static_cast<int>(e % cout);  // cout % 8 == 0: the 8 share a row
      float gv[VE], yv[VE] = {}, out[VE];
      load8(g + e, gv);
      if (relu) load8(y + e, yv);
#pragma unroll
      for (int i = 0; i < VE; ++i) out[i] = dz_of(gv[i], yv[i], __ldg(scale + o + i), relu);
      store8(dz + e, out);
    }
  } else {
    for (long long e = first; e < total; e += stride) {
      const float yv = relu ? to_f32(y[e]) : 0.f;
      dz[e] = from_f32<D>(dz_of(to_f32(g[e]), yv, __ldg(scale + e % cout), relu));
    }
  }
}

template <typename G, typename D>
cudaError_t launch(const void* g, const void* y, const float* scale, void* dz, long long total, int cout, int relu,
                   cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = cout % VE == 0 && aligned(g) && aligned(dz) && (!relu || aligned(y));
  const long long items = vec ? total / VE : total;
  const long long blocks = std::max(1LL, std::min((items + THREADS - 1) / THREADS, 16LL * sms));
  const G* gt = static_cast<const G*>(g);
  const G* yt = static_cast<const G*>(y);
  D* dt = static_cast<D*>(dz);
  if (vec)
    conv1x1_bwd_dz_kernel<G, D, true><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(gt, yt, scale, dt,
                                                                                          total, cout, relu);
  else
    conv1x1_bwd_dz_kernel<G, D, false><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(gt, yt, scale, dt,
                                                                                           total, cout, relu);
  return cudaGetLastError();
}

}  // namespace

// g, y: contiguous [rows, Cout] of g_dtype (y, the forward's output, is read only for
// act = 1, relu; it may be null for act = 0, identity); scale: contiguous f32 [Cout]; dz:
// contiguous [rows, Cout] of dz_dtype. Dtypes: 0 = float32, 1 = bfloat16. Anything else
// returns cudaErrorInvalidValue without a launch.
extern "C" int dtp_conv1x1_bwd_dz(const void* g, const void* y, const void* scale, void* dz, int g_dtype,
                                  int dz_dtype, long long rows, int Cout, int act, void* stream) {
  if (rows <= 0 || Cout <= 0 || act < 0 || act > 1 || (act == 1 && y == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = rows * Cout;
  const float* sc = static_cast<const float*>(scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (g_dtype == 0 && dz_dtype == 0)
    err = launch<float, float>(g, y, sc, dz, total, Cout, act, st);
  else if (g_dtype == 0 && dz_dtype == 1)
    err = launch<float, __nv_bfloat16>(g, y, sc, dz, total, Cout, act, st);
  else if (g_dtype == 1 && dz_dtype == 0)
    err = launch<__nv_bfloat16, float>(g, y, sc, dz, total, Cout, act, st);
  else if (g_dtype == 1 && dz_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(g, y, sc, dz, total, Cout, act, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
