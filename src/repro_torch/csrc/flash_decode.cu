// Flash GQA decode attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_decode` of the JAX package
// (src/repro/kernels/flash_decode.py): one new query token per batch slot
// against its dense KV cache, every slot at its own fill level kv_len[b]
// (continuous-batching decode of the served planner).
//
// What bounds it on an H100: each cache row is read once and used for G
// q heads, G operations a byte, half of them on bf16 operands (Q.K^T,
// 989 TFLOP/s on the card) and half with an fp32 p (P.V, 67 TFLOP/s):
// below the mix's ~125 TFLOP/s / 3.35 TB/s = 37 at every G served (<= 8),
// so it is bound by the bytes of K and V it must read:
// 2 * kv_len[b] * Hkv * hd * 2 bytes per slot.
//
// Design: decode_warp.cuh's routine with its dense source, shared with
// flash_verify (decode is its W = 1), so a verify row is bitwise the
// decode row at its position, and with the paged twins (the same routine
// with the paged source), so paged and dense decode agree bit for bit:
//   * a warp owns a q row for the whole walk over the keys, with m, l
//     and acc in registers; the grid is (kv head, slot, blocks of at
//     most 4 of the kv head's G warps; 8 at head dims 128 and 256), so
//     the rows of a (kv head, slot) walk their keys side by side on
//     separate warp schedulers;
//   * the warps of a block share the slot's 128-key K/V tiles, which
//     the copy engine brings through a 4-entry ring (3 at head dim
//     256; K and V alternate; K by swizzled TMA tensor copies, V by one
//     bulk copy), one phase ahead of the arithmetic;
//   * the block loops over tiles only up to kv_len[b]. The TPU kernel
//     reads the whole cache and masks it; tiles past kv_len would
//     change nothing (alpha = 1, p = 0), so stopping early gives the
//     same result while moving only the bytes the slot holds;
//   * m, l and acc stay fp32; a slot with kv_len 0 writes 0, not NaN;
//   * no split over the key axis: a split-K version must come to all
//     four kernels of the decode family at once, or verify rows stop
//     being decode rows and paged stops being dense.
#include "decode_warp.cuh"

namespace {

using namespace decode_warp;

// one resident block is enough (the ring bounds blocks per SM): ptxas
// may then give each thread the registers that keep the loads in flight
template <int HD>
__global__ void __launch_bounds__(decode_warp::block_warps<HD>() * 32, 1)
flash_decode_kernel(const __grid_constant__ CUtensorMap tk,
                    const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ vc,
                    const int* __restrict__ kv_len,
                    __nv_bfloat16* __restrict__ out,
                    int Hkv, int G, int Sk, float cap, float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long pair = (long long)b * Hkv + hk;
  DenseSource<HD> src{&tk, (int)pair, vc + pair * Sk * HD};
  attend_warps<HD>(q + pair * G * HD, out + pair * G * HD, src, G, 1,
                   kv_len[b], Sk, cap, scale);
}

}  // namespace

// q: (B,Hq,hd), caches: (B,Hkv,Sk,hd) bf16 contiguous, hd in {16, 32,
// 64, 128, 256}; kv_len: (B,) int32 on the device; out: (B,Hq,hd) bf16.
// Launches on `stream` and returns cudaGetLastError().
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
    return launch<HD>(flash_decode_kernel<HD>,
                      KPlanes{k_cache, Sk, B * Hkv, NT}, B, Hkv, G, 1,
                      (cudaStream_t)stream, (const __nv_bfloat16*)q,
                      (const __nv_bfloat16*)v_cache, (const int*)kv_len,
                      (__nv_bfloat16*)out, Hkv, G, Sk, cap, scale);
  });
}
