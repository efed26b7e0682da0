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
// Design: flash_decode's grid (one block per (kv head, slot)) and its
// tile routine (decode_tile.cuh). The staging loop reads logical key
// k0 + r of each 128-key tile from block tab[b, (k0 + r) / bs] at offset
// (k0 + r) % bs. A K/V row is 128 contiguous bytes inside a block, so
// the 16-byte loads stay coalesced per row and any block size that
// divides the logical length works (the engine's default is 16). Only
// rows below kv_len[b] are read. The TPU kernel walks one block per grid
// step and so reduces over bs-key tiles; this kernel reduces over the
// same 128-key tiles as flash_decode, so its output is bitwise
// flash_decode's on the gathered view: paged and dense decode agree bit
// for bit on the card.
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

template <int HD>
__global__ void __launch_bounds__(NT)
flash_decode_paged_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kp,
                          const __nv_bfloat16* __restrict__ vp,
                          const int* __restrict__ tab,
                          const int* __restrict__ kv_len,
                          __nv_bfloat16* __restrict__ out, int Hkv, int G,
                          int nb, int bs, int mb, float cap, float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long row0 = ((long long)b * Hkv * G + (long long)hk * G) * HD;
  const PagedRows<HD> rows{tab + (long long)b * mb, nb, Hkv, hk, bs};
  attend_rows<HD>(q + row0, out + row0, kp, vp, rows, 0, G, 1, kv_len[b],
                  mb * bs, cap, scale);
}

}  // namespace

// q: (B,Hq,hd); pages: (nb,Hkv,bs,hd) bf16 contiguous, hd in {32, 64,
// 128}; block_tab: (B,mb) int32; kv_len: (B,) int32, all on the device;
// out: (B,Hq,hd) bf16.
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
  const int G = Hq / Hkv;
  return (int)dispatch_hd(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    cudaError_t err = prepare<HD>(flash_decode_paged_kernel<HD>, G);
    if (err != cudaSuccess || B == 0) return err;
    dim3 grid(Hkv, B);
    flash_decode_paged_kernel<HD><<<grid, NT, dyn_smem_bytes<HD>(G),
                                    (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
        (const __nv_bfloat16*)v_pages, (const int*)block_tab,
        (const int*)kv_len, (__nv_bfloat16*)out, Hkv, G, nb, bs, mb, cap,
        scale);
    return cudaGetLastError();
  });
}
