// Paged flash GQA decode attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_decode_paged` of the JAX package
// (src/repro/kernels/flash_decode_paged.py): one new query token per
// batch slot against a paged KV pool (n_blocks, Hkv, bs, hd) shared by
// every slot, each slot's logical rows named by its row of a (B, mb)
// block table; entries >= n_blocks are sentinels and clamp to the last
// block, as the plain version's gather does.
//
// What bounds it on an H100: as flash_decode, the bytes of the K/V rows
// the slot holds, 2 * kv_len[b] * Hkv * hd * 2 bytes; the table adds
// 4 bytes per block of the slot.
//
// Design: flash_decode's kernel with another source. The routine
// (decode_warp.cuh's attend_warps: a warp per q row, the warps of a
// block sharing 128-key K/V tiles through a 4-entry ring the copy engine
// fills, grid (kv head, slot, blocks of the kv head's rows)) is the same
// code; its PagedSource fills a tile in row boxes of g = gcd(bs, 128)
// rows, each inside one pool block, spread over the block's warps: a
// thread reads one table entry, a tile ahead, and issues K as swizzled
// TMA boxes through a tensor map over the pool (HD, bs, n_blocks * Hkv)
// and V as one bulk copy per row box. Block sizes that are not a
// multiple of 8 copy K with the block's threads instead (a TMA box must
// start on the swizzle's 8-row period). The TPU kernel walks one block per grid step and so
// reduces over bs-key tiles; this kernel reduces over the same 128-key
// tiles as flash_decode at any block size, so its output is bitwise
// flash_decode's on the gathered view.
#include <numeric>

#include "decode_warp.cuh"

namespace {

using namespace decode_warp;

// one resident block is enough (the ring bounds blocks per SM): ptxas
// may then give each thread the registers that keep the loads in flight
template <int HD>
__global__ void __launch_bounds__(decode_warp::block_warps<HD>() * 32, 1)
flash_decode_paged_kernel(const __grid_constant__ CUtensorMap tk,
                          const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kp,
                          const __nv_bfloat16* __restrict__ vp,
                          const int* __restrict__ tab,
                          const int* __restrict__ kv_len,
                          __nv_bfloat16* __restrict__ out, int Hkv, int G,
                          int nb, int bs, int mb, int g, float cap,
                          float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long pair = (long long)b * Hkv + hk;
  PagedSource<HD> src{&tk, kp, vp, tab + (long long)b * mb, nb, Hkv, hk,
                      bs, g};
  attend_warps<HD>(q + pair * G * HD, out + pair * G * HD, src, G, 1,
                   kv_len[b], mb * bs, cap, scale);
}

}  // namespace

// q: (B,Hq,hd); pages: (nb,Hkv,bs,hd) bf16 contiguous, hd in {16, 32,
// 64, 128, 256}; block_tab: (B,mb) int32; kv_len: (B,) int32, all on the
// device; out: (B,Hq,hd) bf16.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_decode_paged_bf16(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* block_tab,
                                       const void* kv_len, void* out, int B,
                                       int Hq, int Hkv, int nb, int bs,
                                       int mb, int hd, float cap,
                                       float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || nb <= 0 || bs <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv, g = std::gcd(bs, NT);
  return (int)dispatch_hd(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    return launch<HD>(flash_decode_paged_kernel<HD>,
                      KPlanes{k_pages, bs, nb * Hkv, g < 8 ? 0 : g}, B, Hkv,
                      G, 1, (cudaStream_t)stream, (const __nv_bfloat16*)q,
                      (const __nv_bfloat16*)k_pages,
                      (const __nv_bfloat16*)v_pages, (const int*)block_tab,
                      (const int*)kv_len, (__nv_bfloat16*)out, Hkv, G, nb,
                      bs, mb, g, cap, scale);
  });
}
