// Hopper (sm_90a) building blocks of the tensor-core kernels here, in raw PTX: shared-memory
// matrix descriptors for wgmma over 128-byte-swizzled tiles, the two wgmma forms the
// attention kernels use (both operands in shared memory; A from registers with B read
// transposed), the warpgroup fences, mbarriers, TMA tile loads, the products over whole
// 64-row tiles built from them, and the host-side encoding of a bf16 view (a [B, T, H, D]
// one, or any 4-D one) as a TMA tensor map.
//
// Tile layout shared by TMA and wgmma: a "region" is 64 rows x 64 bf16 (128 bytes a row,
// 8 KiB), 1024-byte aligned, written by one TMA box with CU_TENSOR_MAP_SWIZZLE_128B, so
// the 16-byte chunk c of row r lands at chunk c ^ (r % 8). A D = 128 tile is two regions
// (d 0-63, then d 64-127). Read as a K-major operand (rows are M or N, the 64 columns are
// K), one k16 step is 32 bytes along the row; read as an MN-major operand (rows are K,
// columns are N), one k16 step is 16 rows, 2048 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dtp_hopper {

constexpr int REGION_BYTES = 64 * 128;  // one 64 x 64 bf16 region

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- wgmma ------------------------------------------------------------------------------

// Matrix descriptor of a 128-byte-swizzled operand at `tile` (bits 0-13: address >> 4;
// 16-29: leading byte offset >> 4; 32-45: stride byte offset >> 4; 62-63: 1 = SWIZZLE_128B).
// The stride byte offset is the step between groups of 8 rows (1024 bytes). The leading
// byte offset is unused by both layouts here (K-major: K stays inside the 128-byte row;
// MN-major: N = 64 is one swizzle atom wide), so it is set to 1024 as well.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until every committed wgmma group of this warpgroup has completed.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most `pending` (0 to 3) of this warpgroup's committed wgmma groups are still
// running; the count is an immediate of the instruction, hence the switch.
__device__ __forceinline__ void wgmma_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); break;
    case 1: asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); break;
    case 2: asm volatile("wgmma.wait_group.sync.aligned 2;\n" ::: "memory"); break;
    default: asm volatile("wgmma.wait_group.sync.aligned 3;\n" ::: "memory"); break;
  }
}

// Keep the compiler from moving reads or writes of wgmma operands across the asynchronous
// instructions (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], bf16 in, f32 accumulate; A and B in shared
// memory, both K-major. d is the accumulator fragment: thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1):
// d[4 j + 0, 1] on the first row, d[4 j + 2, 3] on the second. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64] with A from registers and B in shared memory,
// MN-major (its rows are K, its 64 columns N: read transposed, which bf16 allows). The A
// fragment is that of mma.m16n8k16 per warp: a[0] = (row g, k 2c, 2c + 1), a[1] = (row
// g + 8, same k), a[2] = (row g, k 8 + 2c, + 1), a[3] = (row g + 8, same), with g = lane / 4
// and c = lane % 4 on the warp's 16 rows; low half = lower k. That is the accumulator
// fragment of a previous product over the same rows, columns 16 kk .. 16 kk + 15, packed.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Two f32 rounded to bf16 and packed, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- mbarrier and TMA -------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// Make the initialised barriers visible to the TMA unit (the async proxy).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// A phase that never completes is a fault of the pipeline: after 2^28 polls (seconds) the
// wait traps, so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// Order this thread's earlier shared-memory accesses before later async-proxy (TMA) ones.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box (64 d x 64 rows of one (batch, head)) of a 4-D tensor map into shared memory;
// coordinates (d, t, h, b), innermost first. Rows past the tensor's T are zero-filled.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, uint64_t* bar, int d, int t,
                                             int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d), "r"(t), "r"(h), "r"(b)
      : "memory");
}

// ---- 64-row tiles -----------------------------------------------------------------------

constexpr int WG = 128;  // one warpgroup: the threads of every wgmma kernel's block

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The TMA loads of one 64-row tile (all D) of one (batch, head) into `dst`, on `bar`.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int row0, int hi,
                                          int bi) {
#pragma unroll
  for (int r = 0; r < D / 64; ++r) tma_load_box(dst + r * REGION_BYTES, map, bar, 64 * r, row0, hi, bi);
}

// Descriptor offsets (in the descriptor's 16-byte units) of k16 step kk: along D of a
// K-major tile, and along the 64 rows of region r of an MN-major tile.
__device__ __forceinline__ uint64_t kmajor_step(int kk) {
  return uint64_t((kk / 4) * REGION_BYTES + (kk % 4) * 32) >> 4;
}
__device__ __forceinline__ uint64_t mnmajor_step(int r, int kk) {
  return uint64_t(r * REGION_BYTES + kk * 2048) >> 4;
}

// acc (=) A B^T over D for two 64-row K-major tiles: S = Q K^T and the like.
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[32], uint64_t a_desc, uint64_t b_desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(acc, a_desc + kmajor_step(kk), b_desc + kmajor_step(kk), kk > 0);
}

// acc[r] += A B for A in registers (64 x 64, four k16 fragments) and B a 64-row MN-major
// tile, region r giving d columns 64 r .. 64 r + 63.
template <int NR>
__device__ __forceinline__ void register_product(float (&acc)[NR][32], const uint32_t (&a)[4][4], uint64_t b_desc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < NR; ++r) wgmma_rs_tb(acc[r], a[kk], b_desc + mnmajor_step(r, kk));
}

template <int NR>
__device__ __forceinline__ void fence_acc(float (&acc)[NR][32]) {
#pragma unroll
  for (int r = 0; r < NR; ++r) fence_regs(acc[r]);
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
}

// ---- host: tensor maps ------------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver-API function; it is fetched through the runtime's
// entry-point query, so the library links against the runtime alone.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status{};
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// The tensor map of a 4-D bf16 view with the sizes `dims` (innermost first; dims[0] has unit
// stride), the element strides of dims 1 to 3, and the box `box` (box[0] at most 64), with
// the 128-byte swizzle: a box's rows of 64 elements land as the rows of a region. TMA needs a
// 16-byte-aligned base and strides that are positive multiples of 16 bytes.
inline cudaError_t make_bf16_map(CUtensorMap* map, const void* ptr, const long long (&dims)[4],
                                 const long long (&strides)[3], const int (&box)[4]) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (strides[i] <= 0 || strides[i] % 8 != 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (dims[i] < 1 || box[i] < 1 || box[i] > 256) return cudaErrorInvalidValue;
  if (box[0] > 64) return cudaErrorInvalidValue;
  const cuuint64_t gdims[4] = {cuuint64_t(dims[0]), cuuint64_t(dims[1]), cuuint64_t(dims[2]), cuuint64_t(dims[3])};
  const cuuint64_t gstrides[3] = {cuuint64_t(strides[0]) * 2, cuuint64_t(strides[1]) * 2, cuuint64_t(strides[2]) * 2};
  const cuuint32_t gbox[4] = {cuuint32_t(box[0]), cuuint32_t(box[1]), cuuint32_t(box[2]), cuuint32_t(box[3])};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdims, gstrides,
                              gbox, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a bf16 [B, T, H, D] view with element strides (sb, st, sh) and a unit
// D stride, read in boxes of 64 d x 64 rows x 1 head x 1 batch. A size-1 dimension's stride
// is never used, so it is replaced by one that is valid.
inline cudaError_t make_bf16_bthd_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int D,
                                      long long sb, long long st, long long sh) {
  if (B == 1) sb = D;
  if (H == 1) sh = D;
  if (T == 1) st = D;
  return make_bf16_map(map, ptr, {D, T, H, B}, {st, sh, sb}, {64, 64, 1, 1});
}

}  // namespace dtp_hopper
