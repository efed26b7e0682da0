// Speculative-verify attention for Hopper (sm_90a), plain CUDA C++:
// flash_verify (dense KV cache) and flash_verify_paged (paged KV pool).
//
// Replaces the Pallas TPU kernels `flash_verify` and `flash_verify_paged`
// of the JAX package (src/repro/kernels/flash_verify.py): W = K+1 query
// rows per batch slot (the carried token and K draft proposals), row w
// causal at absolute position kv_len[b] - W + w, where kv_len counts the
// cache rows after the verify write.
//
// What bounds them on an H100: the bytes of the K/V rows the slot holds,
// 2 * kv_len[b] * Hkv * hd * 2 bytes, read once for all G*W rows of a kv
// head, and 2 * 2 * hd operations per row and key: 2 * hd in Q.K^T,
// whose bf16 operands the card takes at 989 TFLOP/s, and 2 * hd in P.V,
// whose fp32 p it takes at 67 TFLOP/s (~125 TFLOP/s for the mix). That
// is G*W operations a byte against 125 TFLOP/s / 3.35 TB/s = 37, so the
// operations bound it from ~38 rows a kv head (kimi-k2's 40 at W = 5;
// the planner's 15 is bound by the bytes).
//
// Both run decode_warp.cuh's routine, which flash_decode and
// flash_decode_paged run too (as W = 1): a warp owns one row for the
// whole walk over the keys, with m, l and acc in registers; the warps of
// a block (at most 4; 8 at head dim 128) share the slot's 128-key K/V
// tiles, which the copy engine brings through a 4-entry ring; the grid is
// (kv head, slot, blocks of the kv head's warps), so any G and W work
// (kimi's 72 rows at W = 9 are 72 warps in 9 blocks) and the rows of the
// longest slot are spread over several SMs. flash_verify fills the ring
// from the dense cache, flash_verify_paged through the block table (the
// paged source, see flash_decode_paged.cu); the arithmetic is one piece
// of code. Row (g, w) has the key limit kv_len[b] - W + w + 1; it takes
// part only in the tiles that start below it and its P.V loop runs only
// to it, so it repeats flash_decode's operations for one token at its
// position and is bitwise that decode row, which is what makes
// speculative decoding emit exactly the non-speculative tokens on the
// card; paged verify is bitwise dense verify on the gathered view.
#include <numeric>

#include "decode_warp.cuh"

namespace {

using namespace decode_warp;

// one resident block is enough (the ring bounds blocks per SM): ptxas
// may then give each thread the registers that keep the loads in flight
template <int HD>
__global__ void __launch_bounds__(decode_warp::block_warps<HD>() * 32, 1)
flash_verify_kernel(const __grid_constant__ CUtensorMap tk,
                    const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ vc,
                    const int* __restrict__ kv_len,
                    __nv_bfloat16* __restrict__ out, int Hkv, int G, int W,
                    int Sk, float cap, float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long pair = (long long)b * Hkv + hk;
  DenseSource<HD> src{&tk, (int)pair, vc + pair * Sk * HD};
  attend_warps<HD>(q + pair * G * W * HD, out + pair * G * W * HD, src, G,
                   W, kv_len[b], Sk, cap, scale);
}

template <int HD>
__global__ void __launch_bounds__(decode_warp::block_warps<HD>() * 32, 1)
flash_verify_paged_kernel(const __grid_constant__ CUtensorMap tk,
                          const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kp,
                          const __nv_bfloat16* __restrict__ vp,
                          const int* __restrict__ tab,
                          const int* __restrict__ kv_len,
                          __nv_bfloat16* __restrict__ out, int Hkv, int G,
                          int W, int nb, int bs, int mb, int g, float cap,
                          float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long pair = (long long)b * Hkv + hk;
  PagedSource<HD> src{&tk, kp, vp, tab + (long long)b * mb, nb, Hkv, hk,
                      bs, g};
  attend_warps<HD>(q + pair * G * W * HD, out + pair * G * W * HD, src, G,
                   W, kv_len[b], mb * bs, cap, scale);
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
  const int G = Hq / Hkv;
  return (int)dispatch_hd(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    return launch<HD>(
        flash_verify_kernel<HD>, KPlanes{k_cache, Sk, B * Hkv, NT}, B, Hkv,
        G, W, (cudaStream_t)stream, (const __nv_bfloat16*)q,
        (const __nv_bfloat16*)v_cache, (const int*)kv_len,
        (__nv_bfloat16*)out, Hkv, G, W, Sk, cap, scale);
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
  const int G = Hq / Hkv, g = std::gcd(bs, NT);
  return (int)dispatch_hd(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    return launch<HD>(
        flash_verify_paged_kernel<HD>,
        KPlanes{k_pages, bs, nb * Hkv, g < 8 ? 0 : g}, B, Hkv, G, W,
        (cudaStream_t)stream, (const __nv_bfloat16*)q,
        (const __nv_bfloat16*)k_pages, (const __nv_bfloat16*)v_pages,
        (const int*)block_tab, (const int*)kv_len, (__nv_bfloat16*)out, Hkv,
        G, W, nb, bs, mb, g, cap, scale);
  });
}
