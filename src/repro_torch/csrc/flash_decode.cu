// Flash GQA decode attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_decode` of the JAX package
// (src/repro/kernels/flash_decode.py): one new query token per batch slot
// against its dense KV cache, every slot at its own fill level kv_len[b]
// (continuous-batching decode of the served planner).
//
// What bounds it on an H100: each cache row is read once and used for G
// q heads (~4*G operations per 4 bytes), far below the card's ~295
// operations per byte, so it is bound by the bytes of K and V it must
// read: 2 * kv_len[b] * Hkv * hd * 2 bytes per slot.
//
// Design (the tile arithmetic is decode_tile.cuh's, shared with the
// paged and verify kernels so their rows are bitwise these rows):
//   * one thread block per (kv head, batch slot) holds all G q rows of
//     that kv head, so each K/V row is read from device memory once and
//     serves the G rows;
//   * the block loops over 128-key tiles only up to kv_len[b]. The TPU
//     kernel reads the whole cache and masks it; tiles past kv_len would
//     change nothing (alpha = 1, p = 0), so stopping early gives the same
//     result while moving only the bytes the slot holds;
//   * m, l and acc stay fp32; a slot with kv_len 0 writes 0, not NaN;
//   * no split over the key axis: with few slots the grid is small
//     (B * Hkv blocks). A split-K version must come to all four kernels
//     of decode_tile.cuh at once, or verify rows stop being decode rows.
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

template <int HD>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc,
                    const int* __restrict__ kv_len,
                    __nv_bfloat16* __restrict__ out,
                    int Hkv, int G, int Sk, float cap, float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long row0 = ((long long)b * Hkv * G + (long long)hk * G) * HD;
  const DenseRows<HD> rows{((long long)b * Hkv + hk) * Sk * HD};
  attend_rows<HD>(q + row0, out + row0, kc, vc, rows, 0, G, 1, kv_len[b],
                  Sk, cap, scale);
}

}  // namespace

// q: (B,Hq,hd), caches: (B,Hkv,Sk,hd) bf16 contiguous, hd in {32, 64,
// 128}; kv_len: (B,) int32 on the device; out: (B,Hq,hd) bf16. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int flash_decode_bf16(const void* q, const void* k_cache,
                                 const void* v_cache, const void* kv_len,
                                 void* out, int B, int Hq, int Hkv, int Sk,
                                 int hd, float cap, float scale,
                                 void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  return (int)dispatch_hd(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    cudaError_t err = prepare<HD>(flash_decode_kernel<HD>, G);
    if (err != cudaSuccess || B == 0) return err;
    dim3 grid(Hkv, B);
    flash_decode_kernel<HD><<<grid, NT, dyn_smem_bytes<HD>(G),
                              (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
        (const __nv_bfloat16*)v_cache, (const int*)kv_len,
        (__nv_bfloat16*)out, Hkv, G, Sk, cap, scale);
    return cudaGetLastError();
  });
}
