// Speculative-verify attention for Hopper (sm_90a), plain CUDA C++:
// flash_verify (dense KV cache) and flash_verify_paged (paged KV pool).
//
// Replaces the Pallas TPU kernels `flash_verify` and `flash_verify_paged`
// of the JAX package (src/repro/kernels/flash_verify.py): W = K+1 query
// rows per batch slot (the carried token and K draft proposals), row w
// causal at absolute position kv_len[b] - W + w, where kv_len counts the
// cache rows after the verify write.
//
// What bounds them on an H100: as flash_decode, the bytes of the K/V
// rows the slot holds, 2 * kv_len[b] * Hkv * hd * 2 bytes, read once for
// all G*W rows of a kv head (15 at G = 3, K = 4); the operations grow
// with W but stay far below the card's ~295 per byte.
//
// Design: one thread block per (kv head, slot) holds all G*W rows, so
// each K/V tile is staged once for all of them (decode_tile.cuh's
// routine, taking the rows in groups of 8 with m and l in shared
// memory). Row (g, w) has the key limit kv_len[b] - W + w + 1; the block
// loops to the largest limit; a row takes part only in the tiles that
// start below its own limit, and its P.V loop runs only to that limit.
// Each row therefore repeats flash_decode's operations for one token at
// its position and is bitwise that decode row, which is what makes
// speculative decoding emit exactly the non-speculative tokens on the
// card. flash_verify_paged stages its tiles as flash_decode_paged does.
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

template <int HD>
__global__ void __launch_bounds__(NT)
flash_verify_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc,
                    const int* __restrict__ kv_len,
                    __nv_bfloat16* __restrict__ out, int Hkv, int G, int W,
                    int Sk, float cap, float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long row0 =
      ((long long)b * Hkv * G + (long long)hk * G) * W * HD;
  const DenseRows<HD> rows{((long long)b * Hkv + hk) * Sk * HD};
  attend_rows<HD>(q + row0, out + row0, kc, vc, rows, G * W, W, kv_len[b],
                  Sk, cap, scale);
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_verify_paged_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kp,
                          const __nv_bfloat16* __restrict__ vp,
                          const int* __restrict__ tab,
                          const int* __restrict__ kv_len,
                          __nv_bfloat16* __restrict__ out, int Hkv, int G,
                          int W, int nb, int bs, int mb, float cap,
                          float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long row0 =
      ((long long)b * Hkv * G + (long long)hk * G) * W * HD;
  const PagedRows<HD> rows{tab + (long long)b * mb, nb, Hkv, hk, bs};
  attend_rows<HD>(q + row0, out + row0, kp, vp, rows, G * W, W, kv_len[b],
                  mb * bs, cap, scale);
}

}  // namespace

// q: (B,Hq,W,hd), caches: (B,Hkv,Sk,hd) bf16 contiguous, hd in {32, 64,
// 128}; kv_len: (B,) int32 on the device; out: (B,Hq,W,hd) bf16.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_verify_bf16(const void* q, const void* k_cache,
                                 const void* v_cache, const void* kv_len,
                                 void* out, int B, int Hq, int Hkv, int W,
                                 int Sk, int hd, float cap, float scale,
                                 void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int rows = Hq / Hkv * W;
  return (int)dispatch_hd(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    cudaError_t err = prepare<HD>(flash_verify_kernel<HD>, rows);
    if (err != cudaSuccess || B == 0) return err;
    dim3 grid(Hkv, B);
    flash_verify_kernel<HD><<<grid, NT, dyn_smem_bytes<HD>(rows),
                              (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
        (const __nv_bfloat16*)v_cache, (const int*)kv_len,
        (__nv_bfloat16*)out, Hkv, Hq / Hkv, W, Sk, cap, scale);
    return cudaGetLastError();
  });
}

// q: (B,Hq,W,hd); pages: (nb,Hkv,bs,hd) bf16 contiguous, hd in {32, 64,
// 128}; block_tab: (B,mb) int32; kv_len: (B,) int32, all on the device;
// out: (B,Hq,W,hd) bf16. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int flash_verify_paged_bf16(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* block_tab,
                                       const void* kv_len, void* out, int B,
                                       int Hq, int Hkv, int W, int nb,
                                       int bs, int mb, int hd, float cap,
                                       float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || W <= 0 || nb <= 0 || bs <= 0)
    return (int)cudaErrorInvalidValue;
  const int rows = Hq / Hkv * W;
  return (int)dispatch_hd(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    cudaError_t err = prepare<HD>(flash_verify_paged_kernel<HD>, rows);
    if (err != cudaSuccess || B == 0) return err;
    dim3 grid(Hkv, B);
    flash_verify_paged_kernel<HD><<<grid, NT, dyn_smem_bytes<HD>(rows),
                                    (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
        (const __nv_bfloat16*)v_pages, (const int*)block_tab,
        (const int*)kv_len, (__nv_bfloat16*)out, Hkv, Hq / Hkv, W, nb, bs,
        mb, cap, scale);
    return cudaGetLastError();
  });
}
