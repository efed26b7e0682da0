// The paged decode kernels' attention routine for Hopper (sm_90a).
//
// flash_decode, flash_decode_paged, flash_verify and flash_verify_paged
// all compute, for some query rows of one (kv head, batch slot), the
// online-softmax attention over the first `lim` keys of that slot's K/V
// rows, each row with its own key limit. Only the paged twins,
// flash_decode_paged and flash_verify_paged, still run attend_rows (and
// tile_update) below, until they move to the dense kernels' routine,
// decode_warp.cuh's attend_warps, which does each row's operations
// exactly as this one does; this routine is then deleted. The shared
// pieces (NT, NEG_INF, warp_sum, warp_max, dispatch_hd) stay here.
// The two kernels of this routine read each key's K/V row from a block
// of a paged pool named by a block table (PagedRows) and differ only in
// how many rows a block holds (G for decode, G*W for verify), so they do
// the same arithmetic per query row over the same key partition:
//
//   * keys are taken in tiles of NT = 128, staged through dynamic shared
//     memory with 16-byte loads; K rows are padded to HD/2 + 1 words (an
//     odd count: 17, 33, 65) so that one thread per key reads its row
//     without bank conflicts;
//   * a row takes part in a tile only if the tile starts below the
//     row's own key limit, and inside it masks the keys at or past the
//     limit, so a verify row at kv_len L repeats exactly the operations
//     a decode row at kv_len L does (same tiles, same masks, same fp32
//     operations in the same order), and their outputs are equal bit
//     for bit; a paged row reads the same values as a dense row over
//     the gathered view, so paged and dense are equal too;
//   * rows are updated in groups of at most MAX_R = 8 (the register
//     arrays below); m and l live in shared memory between groups and
//     tiles, acc stays in shared fp32;
//   * every multiply-add of the update is an explicit fmaf, so FMA
//     contraction cannot differ between the four kernels;
//   * block reductions use a fixed order, so the result does not vary
//     from run to run; a row with no keys writes 0 (acc / max(l, 1e-30));
//   * the head dim HD is a template parameter; every kernel file
//     instantiates HD = 32, 64 and 128 and its launcher dispatches on hd.
//     The operations per element do not depend on HD, so every contract
//     above holds at each head dim. The K/V tiles live in static shared
//     memory up to HD = 64 and in dynamic shared memory at HD = 128
//     (65 KB there, over the 48 KB static limit).
//
// What bounds these kernels on an H100: each K/V row is read once from
// device memory and serves the block's rows (G or G*W query rows, ~4
// operations per row per 2-byte element), far below the card's ~295
// operations per byte, so they are bound by the bytes of the K/V rows
// they must read: 2 * kv_len * Hkv * hd * 2 bytes per slot.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace decode_tile {

constexpr int NT = 128;            // threads per block = keys per tile
constexpr int MAX_R = 8;           // rows updated together (registers)
constexpr int MAX_ROWS = 64;       // rows one block holds (G, or a
                                   // chunk of G*W)
constexpr int NWARP = NT / 32;
constexpr float NEG_INF = -1e30f;

// padded K row of head dim HD, in bf16 elements (HD/2 + 1 words: odd)
template <int HD>
__host__ __device__ constexpr int kstride() { return HD + 2; }

// Whether the K/V tiles of head dim HD are static shared memory: they
// are where they fit under the 48 KB static limit beside the block's
// other arrays (HD <= 64). In dynamic shared memory at HD = 64 nvcc gave
// the verify kernels 56-64 registers where static tiles get 85-90, and
// verify ran 11-13% slower on an H100; at HD = 128 they must be dynamic.
template <int HD>
__host__ __device__ constexpr bool static_tiles() { return HD <= 64; }

// Dynamic shared memory a block holding `rows` query rows needs: the
// staged K tile (padded rows) and V tile unless they are static, then
// the rows' fp32 q and acc.
template <int HD>
inline size_t dyn_smem_bytes(int rows) {
  const size_t tiles = static_tiles<HD>() ? 0
      : (size_t)NT * (kstride<HD>() + HD) * sizeof(__nv_bfloat16);
  return tiles + (size_t)2 * rows * HD * sizeof(float);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Where logical key `key` of one slot lives in a paged pool
// (n_blocks, Hkv, bs, HD): block tab[key / bs] (sentinels >= n_blocks
// clamp to the last block, as the plain version's gather does), row
// key % bs. A row is HD contiguous elements (2*HD bytes), so any block
// size works.
template <int HD>
struct PagedRows {
  const int* tab;   // this slot's row of the block table
  int nb, Hkv, hk, bs;
  __device__ __forceinline__ long long operator()(int key) const {
    int blk = tab[key / bs];
    blk = blk < 0 ? 0 : (blk >= nb ? nb - 1 : blk);
    return (((long long)blk * Hkv + hk) * bs + key % bs) * HD;
  }
};

// Stage keys [k0, k0 + NT) into sK (padded) and sV; keys at or past n
// are zeros.
template <int HD, class Rows>
__device__ __forceinline__ void stage_tile(
    __nv_bfloat16* sK, __nv_bfloat16* sV, const __nv_bfloat16* kc,
    const __nv_bfloat16* vc, const Rows& rows, int k0, int n) {
  for (int i = threadIdx.x; i < NT * HD / 8; i += NT) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
    if (k0 + r < n) {
      const long long off = rows(k0 + r) + c;
      kv4 = *reinterpret_cast<const uint4*>(kc + off);
      vv4 = *reinterpret_cast<const uint4*>(vc + off);
    }
    *reinterpret_cast<uint4*>(sV + r * HD + c) = vv4;
    uint32_t* kdst =
        reinterpret_cast<uint32_t*>(sK + r * kstride<HD>() + c);
    kdst[0] = kv4.x; kdst[1] = kv4.y; kdst[2] = kv4.z; kdst[3] = kv4.w;
  }
}

// One staged tile's online-softmax update of rows [r0, r0 + nr) of the
// block (nr <= MAX_R): scores, tile max, p, tile sum, then l and acc.
// Thread t owns key k0 + t. A row whose key limit sLim[r] is at or below
// k0 is left untouched. Ends with every thread past its reads of sP,
// sV and sRed; the new m and l are in sM/sL once it returns.
template <int HD>
__device__ __forceinline__ void tile_update(
    const __nv_bfloat16* sK, const __nv_bfloat16* sV, const float* sQ,
    float* sAcc, float* sM, float* sL, const int* sLim, float* sP,
    float* sRed, int r0, int nr, int k0, float cap, float scale) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  bool on[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) on[r] = r < nr && k0 < sLim[r0 + r];

  // scores: q . k for every row of the group, d in order
  const __nv_bfloat162* kr =
      reinterpret_cast<const __nv_bfloat162*>(sK + t * kstride<HD>());
  float dot[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) dot[r] = 0.f;
#pragma unroll 8
  for (int d2 = 0; d2 < HD / 2; ++d2) {
    const float2 kf = __bfloat1622float2(kr[d2]);
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (on[r]) {
        const float* qr = sQ + (r0 + r) * HD;
        dot[r] = fmaf(qr[2 * d2], kf.x, dot[r]);
        dot[r] = fmaf(qr[2 * d2 + 1], kf.y, dot[r]);
      }
    }
  }
  float s[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    s[r] = NEG_INF;
    if (on[r] && k0 + t < sLim[r0 + r]) {
      float x = dot[r] * scale;
      if (cap != 0.f) x = cap * tanhf(x / cap);
      s[r] = x;
    }
  }

  // tile max per row (exact in any order)
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (on[r]) {
      const float w = warp_max(s[r]);
      if (lane == 0) sRed[r * NWARP + warp] = w;
    }
  }
  __syncthreads();
  float m_new[MAX_R], alpha[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    m_new[r] = NEG_INF;
    alpha[r] = 1.f;
    if (on[r]) {
      float mc = sRed[r * NWARP];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) mc = fmaxf(mc, sRed[r * NWARP + w]);
      const float m_old = sM[r0 + r];
      m_new[r] = fmaxf(m_old, mc);
      alpha[r] = expf(m_old - m_new[r]);
    }
  }
  __syncthreads();   // every thread has read sRed before it is reused

  // probabilities and their tile sum per row (fixed tree order)
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (on[r]) {
      const float p = k0 + t < sLim[r0 + r] ? expf(s[r] - m_new[r]) : 0.f;
      sP[r * NT + t] = p;
      const float w = warp_sum(p);
      if (lane == 0) sRed[r * NWARP + warp] = w;
    }
  }
  __syncthreads();
  float l_new[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    l_new[r] = 0.f;
    if (on[r]) {
      float ps = sRed[r * NWARP];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) ps += sRed[r * NWARP + w];
      l_new[r] = fmaf(alpha[r], sL[r0 + r], ps);
    }
  }

  // acc[r][d] = alpha * acc + sum_j p[r][j] * V[j][d], keys in order
  for (int o = t; o < nr * HD; o += NT) {
    const int r = o / HD, d = o % HD;
    const int kn = min(NT, sLim[r0 + r] - k0);
    if (kn <= 0) continue;
    float a = 0.f;
    for (int j = 0; j < kn; ++j)
      a = fmaf(sP[r * NT + j], __bfloat162float(sV[j * HD + d]), a);
    float ar = 1.f;
#pragma unroll
    for (int rr = 0; rr < MAX_R; ++rr) if (rr == r) ar = alpha[rr];
    float* acc = sAcc + r0 * HD + o;
    *acc = fmaf(*acc, ar, a);
  }
  __syncthreads();
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (on[r]) {
        sM[r0 + r] = m_new[r];
        sL[r0 + r] = l_new[r];
      }
    }
  }
}

// The whole block: `nrows` query rows (q rows contiguous at qp, out rows
// at op), the rows row0 .. row0 + nrows - 1 of the kv head's G * W; row
// i = g * W + w at key limit kv_len - W + w + 1, clamped to [0, Sk].
// Decode is W = 1, row0 = 0. A verify block holds a chunk of at most
// MAX_ROWS rows; which chunk does not change a row's arithmetic. Needs
// dyn_smem_bytes<HD>(nrows) of dynamic shared memory.
template <int HD, class Rows>
__device__ __forceinline__ void attend_rows(
    const __nv_bfloat16* __restrict__ qp, __nv_bfloat16* __restrict__ op,
    const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const Rows& rows, int row0,
    int nrows, int W, int kv_len, int Sk, float cap, float scale) {
  __shared__ float sP[MAX_R * NT];
  __shared__ float sRed[MAX_R * NWARP];
  __shared__ float sM[MAX_ROWS], sL[MAX_ROWS];
  __shared__ int sLim[MAX_ROWS];
  extern __shared__ __align__(16) float dyn[];
  __nv_bfloat16* sK;
  __nv_bfloat16* sV;
  float* sQ;
  if constexpr (static_tiles<HD>()) {
    __shared__ __align__(16) __nv_bfloat16 sKs[NT * kstride<HD>()];
    __shared__ __align__(16) __nv_bfloat16 sVs[NT * HD];
    sK = sKs;
    sV = sVs;
    sQ = dyn;
  } else {
    // K/V tiles first, at offsets known when compiling; then q and acc
    sK = reinterpret_cast<__nv_bfloat16*>(dyn);
    sV = sK + NT * kstride<HD>();
    sQ = reinterpret_cast<float*>(sV + NT * HD);
  }
  float* sAcc = sQ + nrows * HD;

  const int t = threadIdx.x;
  for (int i = t; i < nrows * HD; i += NT) {
    sQ[i] = __bfloat162float(qp[i]);
    sAcc[i] = 0.f;
  }
  for (int r = t; r < nrows; r += NT) {
    const int lim = kv_len - W + (row0 + r) % W + 1;
    sLim[r] = lim < 0 ? 0 : (lim > Sk ? Sk : lim);
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }
  __syncthreads();

  // tiles up to the largest limit (the last row's, w = W - 1)
  const int n = kv_len < 0 ? 0 : (kv_len > Sk ? Sk : kv_len);
  for (int k0 = 0; k0 < n; k0 += NT) {
    stage_tile<HD>(sK, sV, kc, vc, rows, k0, n);
    __syncthreads();
    for (int r0 = 0; r0 < nrows; r0 += MAX_R)
      tile_update<HD>(sK, sV, sQ, sAcc, sM, sL, sLim, sP, sRed, r0,
                  min(MAX_R, nrows - r0), k0, cap, scale);
  }
  __syncthreads();   // the last group's l is in sL

  for (int o = t; o < nrows * HD; o += NT)
    op[o] = __float2bfloat16_rn(sAcc[o] / fmaxf(sL[o / HD], 1e-30f));
}

// Host side: allow `rows` rows' dynamic shared memory for `kernel` (an
// instance for head dim HD) and check the row limit of one block (a
// verify block's chunk). Returns a CUDA error code.
template <int HD, class Kernel>
inline cudaError_t prepare(Kernel kernel, int rows) {
  if (rows <= 0 || rows > MAX_ROWS) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dyn_smem_bytes<HD>(rows));
}

// Call `launch` with the head dim as a compile-time constant
// (std::integral_constant<int, HD>) for the head dims the kernels are
// built for; any other hd returns cudaErrorInvalidValue.
template <class Launch>
inline cudaError_t dispatch_hd(int hd, Launch launch) {
  switch (hd) {
    case 32: return launch(std::integral_constant<int, 32>{});
    case 64: return launch(std::integral_constant<int, 64>{});
    case 128: return launch(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace decode_tile
