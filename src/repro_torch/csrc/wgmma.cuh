// Warpgroup matrix products (wgmma) on Hopper (sm_90a) over bf16 tiles
// that TMA writes to shared memory, shared by flash_prefill
// (csrc/flash_prefill.cu) and its backward (csrc/flash_prefill_bwd.cu):
// the panel layout of a tile, its tensor maps, the shared-memory matrix
// descriptors (K-major and MN-major), the SS m64n64k16 product, the RS
// m64n{32,64,128,256}k16 products with an MN-major (transposed) B, the
// fences around them, and the bf16 packing and ex2 of the softmax
// between them.
//
// A tile of R rows and head dim HD is NP panels of R rows of SW bytes
// (PC bf16 columns), each panel in the SW-byte swizzle that TMA writes and
// the descriptors name: 128 bytes (64 columns), 64 bytes at hd 32. hd 16
// runs the hd-32 tiles (`tile_hd`): its tensor maps are 16 columns wide
// and their 32-column boxes read the columns past 16 as zeros.
//
// The accumulator of a 64 x N product holds, in register 4 j + e of the
// thread of lane (g = lane / 4, t = lane % 4) in warp w, row 16 w + g
// (+ 8 when e >= 2) and column 8 j + 2 t + (e & 1); the RS form takes a
// 64 x 16 A in four bf16x2 registers of the same rows (`pack_bf16` of
// that fragment rounded to bf16: k step kk is registers 8 kk .. 8 kk + 7).
#pragma once

#include <cuda_bf16.h>

#include "tma.cuh"

namespace wg {

using tma::smem_u32;

// The head dim the tiles of head dim HD hold: hd 16 runs the hd-32
// tiles, its columns past 16 zeros.
template <int HD>
__host__ __device__ constexpr int tile_hd() { return HD < 32 ? 32 : HD; }

// The panels of a tile of head dim HD (a tile head dim: 32, 64, 128,
// 256).
template <int HD>
struct Panels {
  static_assert(HD % 32 == 0, "panels of 64 or 128 bytes");
  static constexpr int SW = HD == 32 ? 64 : 128;
  static constexpr int PC = SW / 2;
  static constexpr int NP = HD / PC;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte swizzle
  static constexpr uint64_t MODE = SW == 128 ? 1 : 2;
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets, layout type (swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// K-major operand (rows x HD, HD contiguous) of a tile of R rows at
// `tile`, columns [16 kk, 16 kk + 16): 8-row groups SW * 8 bytes apart; a
// step inside a swizzled panel moves the start by 32 bytes.
template <int HD, int R>
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile,
                                                int kk) {
  using L = Panels<HD>;
  const int col = 16 * kk;
  const uint32_t addr = smem_u32(tile) + (col / L::PC) * R * L::SW
                        + (col % L::PC) * 2;
  return make_desc(addr, 16, 8 * L::SW, L::MODE);
}

// MN-major operand (rows x HD, HD contiguous, read as the 16 x HD B of a
// product whose k runs over the rows) of a tile of R rows, rows
// [16 kk, 16 kk + 16): 8-row groups SW * 8 bytes apart (stride offset),
// panels of PC columns R * SW bytes apart (leading offset).
template <int HD, int R>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk) {
  using L = Panels<HD>;
  return make_desc(smem_u32(tile) + 16 * kk * L::SW, R * L::SW,
                   8 * L::SW, L::MODE);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of a wgmma's registers across
// the fence / wait that order them
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(d) ACC4(d, 0), ACC4(d, 4), ACC4(d, 8), ACC4(d, 12)
#define ACC32(d) ACC16(d), ACC4(d, 16), ACC4(d, 20), ACC4(d, 24), \
    ACC4(d, 28)
#define ACC64(d) ACC32(d), ACC4(d, 32), ACC4(d, 36), ACC4(d, 40),      \
    ACC4(d, 44), ACC4(d, 48), ACC4(d, 52), ACC4(d, 56), ACC4(d, 60)
// registers b .. b + 63 of d (the second half of m64n256's 128)
#define ACC16_AT(d, b) ACC4(d, b), ACC4(d, b + 4), ACC4(d, b + 8),    \
    ACC4(d, b + 12)
#define ACC64_AT(d, b) ACC16_AT(d, b), ACC16_AT(d, b + 16),            \
    ACC16_AT(d, b + 32), ACC16_AT(d, b + 48)

// D (64 x N, fp32): wgmma_ss_n64 sets (scale_d = 0) or adds A (64 x 16,
// shared, K-major) B^T (B 64 x 16, shared, K-major); wgmma_rs_nN adds
// A (64 x 16, four bf16x2 registers a thread) B (16 x N, shared,
// MN-major, imm-trans-b = 1).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ACC64(d), ACC64_AT(d, 64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x HD) += A (64 x 16, registers) B (16 x HD, shared, MN-major)
template <int HD>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HD == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (HD == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A (hd, rows, heads) bf16 tensor map whose box is one panel of
// `box_rows` rows of one head; out-of-range rows read as zeros, and so
// do the columns past 16 of hd 16's 32-column box.
template <int HD>
bool make_map(PFN_cuTensorMapEncodeTiled_v12000 enc, CUtensorMap* map,
              const void* ptr, int rows, int heads, int box_rows) {
  using L = Panels<tile_hd<HD>()>;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)rows * HD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::PC, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, L::TMA_SWIZZLE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
