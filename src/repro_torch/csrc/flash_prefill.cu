// Flash prefill attention for Hopper (sm_90a), CUDA C++ on the tensor
// cores.
//
// Replaces the Pallas TPU kernel `flash_prefill` of the JAX package
// (src/repro/kernels/flash_prefill.py): GQA online-softmax attention of
// q (B,Hq,Sq,hd) over k, v (B,Hkv,Sk,hd), causal, sliding-window and
// softcap variants, a runtime q_offset (the absolute position of q row
// 0), fp32 m/l/acc and output acc / max(l, 1e-30) in bf16. It serves
// prefill (Sk == Sq, q_offset 0) and chunked-prefill / prefix extends
// (Sk = cache length, q_offset = the first new row's position).
//
// What bounds it on an H100: ~4*hd operations per visible (q, k) pair and
// q head (two products) against ~(2*Hq*Sq + 2*Hkv*keys)*hd*2 bytes. At
// the planner's 1,024-token causal prefill (12/4 heads of 64) that is
// 1.61 G operations against 4.2 MB, ~384 operations a byte, above the
// ~295 at which an H100's bf16 tensor cores (989 TFLOP/s) and not its
// memory (3.35 TB/s) become the limit: a bound of 1.6 us. Both products
// therefore run on the tensor cores (wgmma); the softmax between them
// (scale, mask, max, exp2, sum, the bf16 pack of P) is the CUDA cores'
// share and takes most of the kernel's instructions.
//
// Design:
//   * one block per (64-row q tile, q head, batch): one warpgroup of 128
//     threads, the M = 64 of wgmma. q tiles run last-first (the causal
//     tiles with the most keys start first). G q heads of one kv head
//     are G blocks that read the same K/V tiles: the second reads hit
//     L2, and the kernel does not pack heads into one block;
//   * S = Q K^T is `wgmma.mma_async m64n64k16` with Q and K from shared
//     memory (both K-major), hd/16 steps into 32 fp32 registers a
//     thread. O += P V is `m64n{hd}k16` with P from registers (the S
//     fragment rounded to bf16, which the RS form takes as it lies) and
//     V from shared memory as a transposed (MN-major) B operand;
//   * Q and a ring of STAGES K/V tiles arrive by TMA (3-D tensor maps
//     (hd, rows, batch*heads), so rows past Sq or Sk of one head read
//     as zeros and never as the next head's rows), each stage completing
//     an mbarrier. Thread 0 issues the loads; a stage is refilled with
//     the tile STAGES ahead once every thread is past its products, so
//     the next tiles' loads overlap this tile's products and softmax.
//     Products and softmax overlap across the 2-4 blocks resident on an
//     SM (82/96/128 registers at hd 32/64/128, 57-113 KB of shared
//     memory). Issuing tile i's S behind tile i-1's P V inside one
//     warpgroup (softmax under P V) gave the same bits but ran 10-25%
//     slower on an H100 80GB HBM3 at 700 W (148 registers at hd 128);
//   * shared-memory tiles are panels of the swizzle span (128 bytes =
//     64 columns; 64 bytes at hd 32) in the 128/64-byte swizzle that
//     TMA writes and the wgmma descriptors name (csrc/wgmma.cuh, shared
//     with the backward, csrc/flash_prefill_bwd.cu); hd is a template
//     parameter and the panels a multiple of it, so a larger hd is one
//     more instance: hd 256 is four panels and an m64n256 P V product
//     (128 fp32 accumulators a thread), its 32 KB Q tile and three
//     64 KB K/V stages 225 KB of the 227 KB a block may hold (the stage
//     count is the most, up to 3, that the head dim's tiles fit: the
//     arithmetic does not depend on it);
//   * hd 16 runs the hd-32 tiles: the tensor maps are 16 columns wide
//     and their 32-column boxes read the columns past 16 as zeros (TMA's
//     fill past a tensor's edge), so S takes one k step, P V adds exact
//     zeros to 16 unwritten output columns, and every row is still one
//     fixed computation;
//   * ragged Sq and Sk are masked in the kernel; any Sq, any Sk.
//
// The contract that chunked prefill and prefix hits rest on: a q row at
// absolute position p has the same bits in one prefill (Sk = S,
// q_offset 0) and in any extend that holds it (any Sk, q_offset, Sq,
// any place in its 64-row tile). The kernel keeps it three ways:
//   * the k-tile partition is fixed: tiles of BK = 64 keys from key 0.
//     A block visits the tiles from the first its window leaves any row
//     (rounded down to a tile) to its last row's causal bound; a tile
//     masked for all of a row's keys leaves that row exactly as it was
//     (m unchanged, alpha exactly 1 by select, p exactly 0 by select,
//     acc * 1 + 0), so where a block starts or stops does not show;
//   * masked entries are exactly 0 (a select, never exp of a large
//     negative); a masked score reads NEG_INF in the max;
//   * every row's arithmetic is independent of its place in the tile:
//     a thread's columns depend only on its lane % 4, the row max and
//     the row sum take the thread's own columns in a fixed order, then
//     the quad's two xor-shuffles (commutative, so all four lanes hold
//     the same bits), l is summed per thread across tiles and over the
//     quad at the end, and there is no warp-uniform shortcut (no
//     "skip the rescale when no max moved"). The tensor cores compute
//     each element of a product from its own row and column.
//
// Numerics: P is rounded to bf16 for the second product (the JAX kernel
// multiplies P V in fp32): about one bf16 rounding of each p, inside
// the kernel-vs-plain tolerance |diff| <= 1e-2 + 1e-2 |plain|.
#include <cuda_bf16.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace tma;
using namespace wg;

constexpr int BQ = 64;        // q rows per block: one warpgroup's M
constexpr int BK = 64;        // keys per k tile, tiles from key 0
constexpr int NTH = 128;      // one warpgroup
constexpr int SMEM_MAX = 232448;   // shared memory a block may hold
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of tile head dim HD (panels: wgmma.cuh): the Q tile,
// then STAGES (K tile, V tile) pairs, 1,024-byte aligned, with 1 KB of
// the block's shared memory left for its barriers.
template <int HD>
struct Layout : Panels<HD> {
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int T_BYTES = BK * HD * 2;
  static constexpr int FIT = (SMEM_MAX - 2048 - Q_BYTES) / (2 * T_BYTES);
  static constexpr int STAGES = FIT < 3 ? FIT : 3;   // K/V tiles in flight
  static_assert(STAGES >= 2, "two K/V stages at least");
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * T_BYTES;
};

// K/V tile `i` of a block's loop (keys [k0, k0 + BK) of kv head row
// `kvh`) into ring stage i % STAGES, arming its barrier (HD: the tile
// head dim).
template <int HD>
__device__ __forceinline__ void load_kv(uint8_t* sKV, uint64_t* bar_kv,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int i,
                                        int k0, int kvh) {
  using L = Layout<HD>;
  const int s = i % L::STAGES;
  uint8_t* sk = sKV + s * 2 * L::T_BYTES;
  bar_expect(&bar_kv[s], 2 * L::T_BYTES);
#pragma unroll
  for (int p = 0; p < L::NP; ++p) {
    tma_load(sk + p * BK * L::SW, tk, &bar_kv[s], p * L::PC, k0, kvh);
    tma_load(sk + L::T_BYTES + p * BK * L::SW, tv, &bar_kv[s], p * L::PC,
             k0, kvh);
  }
}

// ----------------------------------------------------------- kernel ----

template <int HD>
__global__ void __launch_bounds__(NTH)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                     int Sq, int Sk, int q_offset, int causal, int window,
                     float cap, float scale) {
  constexpr int TH = tile_hd<HD>();    // the tiles' head dim
  using L = Layout<TH>;
  constexpr int STAGES = L::STAGES;
  constexpr int NO = TH / 2;           // O registers a thread
  constexpr int KS = BK / 16;          // k steps of P V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_kv[STAGES];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sKV = sQ + L::Q_BYTES;      // stage s: K, then V

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int kvh = b * Hkv + hq / (Hq / Hkv);

  // k tiles [t0, t0 + n) of the partition from key 0
  const int rows_end = min(q0 + BQ, Sq);
  int kend = Sk;
  if (causal) kend = min(kend, q_offset + rows_end);
  const int kbeg = window ? max(0, q_offset + q0 - window + 1) : 0;
  const int t0 = kbeg / BK;
  const int n = max(0, (kend + BK - 1) / BK - t0);

  if (tid == 0) {
    bar_init(&bar_q);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) bar_init(&bar_kv[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect(&bar_q, L::Q_BYTES);
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
      tma_load(sQ + p * BQ * L::SW, &tq, &bar_q, p * L::PC, q0,
               b * Hq + hq);
    for (int i = 0; i < min(STAGES, n); ++i)
      load_kv<TH>(sKV, bar_kv, &tk, &tv, i, (t0 + i) * BK, kvh);
  }
  __syncwarp();

  // this thread's rows (g, g + 8 of its warp's 16) and their positions
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp + g;
  const int pos0 = q_offset + r0, pos1 = pos0 + 8;
  const float sl2 = scale * LOG2E;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  bar_wait(&bar_q, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const int k0 = (t0 + i) * BK;
    const uint8_t* sK = sKV + s * 2 * L::T_BYTES;
    const uint8_t* sV = sK + L::T_BYTES;
    bar_wait(&bar_kv[s], (i / STAGES) & 1);

    // S = Q K^T (at hd 16 one k step: the tiles' other 16 columns are
    // zeros). The first k step overwrites sc (scale_d = 0); zeroing
    // it here anyway tells the compiler that the last tile's p are dead:
    // with sc carried across tiles ptxas gave 146/115/100 registers at
    // hd 128/64/32 instead of 128/96/82.
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    reg_fence<32>(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sc, desc_kmajor<TH, BQ>(sQ, kk),
                   desc_kmajor<TH, BK>(sK, kk), kk > 0);
    wg_commit();
    wg_wait0();
    reg_fence<32>(sc);

    // logits in log2 units; masked entries NEG_INF and flagged. Register
    // 4j + e holds row (e < 2 ? g : g + 8), key k0 + 8j + 2t + (e & 1).
    const bool masked = k0 + BK > Sk
        || (causal && k0 + BK - 1 > q_offset + q0)
        || (window && q_offset + q0 + BQ - 1 - k0 >= window);
    uint32_t live = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x;
      if (cap != 0.f) x = cap * tanhf(sc[j] * scale / cap) * LOG2E;
      else x = sc[j] * sl2;
      if (masked) {
        const int key = k0 + 8 * (j / 4) + 2 * t + (j & 1);
        const int pos = (j & 2) ? pos1 : pos0;
        bool ok = key < Sk;
        if (causal) ok = ok && key <= pos;
        if (window) ok = ok && pos - key < window;
        if (!ok) {
          x = NEG_INF;
          live &= ~(1u << j);
        }
      }
      sc[j] = x;
    }

    // row max: own columns in order, then the quad (xor 1, xor 2)
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[j], sc[j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j + 2], sc[j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = mn0 == m0 ? 1.f : ex2(m0 - mn0);
    const float a1 = mn1 == m1 ? 1.f : ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // p (exactly 0 where masked), the thread's row sums in column order,
    // and P as the bf16 A fragments of P V (k step kk: keys 16 kk ..)
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float mm = (j & 2) ? mn1 : mn0;
      sc[j] = (live >> j) & 1u ? ex2(sc[j] - mm) : 0.f;
      if (j & 2) ps1 += sc[j];
      else ps0 += sc[j];
    }
    l0 = fmaf(l0, a0, ps0);
    l1 = fmaf(l1, a1, ps1);
    uint32_t pa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] *= (j & 2) ? a1 : a0;

    // O += P V
    reg_fence<NO>(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<TH>(o, pa[kk], desc_mn<TH, BK>(sV, kk));
    wg_commit();
    wg_wait0();
    reg_fence<NO>(o);

    // every thread is past this stage's tiles: refill it STAGES ahead
    __syncthreads();
    if (tid == 0 && i + STAGES < n)
      load_kv<TH>(sKV, bar_kv, &tk, &tv, i + STAGES, k0 + STAGES * BK, kvh);
    __syncwarp();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* op = out + ((long long)(b * Hq + hq) * Sq + r0) * HD
                      + 2 * t;
  // columns 8 j + 2 t, + 1; at hd 16 the tiles' columns past 16 are not
  // written
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * HD + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// --------------------------------------------------------------- host ----

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Hq, int Hkv, int Sq, int Sk, int q_offset,
                   int causal, int window, float cap, float scale,
                   cudaStream_t stream) {
  using L = Layout<tile_hd<HD>()>;
  PFN_cuTensorMapEncodeTiled_v12000 enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map<HD>(enc, &mq, q, Sq, B * Hq, BQ)
      || !make_map<HD>(enc, &mk, k, Sk, B * Hkv, BK)
      || !make_map<HD>(enc, &mv, v, Sk, B * Hkv, BK))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_prefill_kernel<HD><<<grid, NTH, L::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, Hq, Hkv, Sq, Sk, q_offset, causal,
      window, cap, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B,Hq,Sq,hd), k/v: (B,Hkv,Sk,hd), out: (B,Hq,Sq,hd); all bf16,
// contiguous, 16-byte aligned; hd in {16, 32, 64, 128, 256}. Launches on
// `stream` and returns cudaGetLastError() (an empty cache, Sk = 0, writes
// zeros).
extern "C" int flash_prefill_bf16(const void* q, const void* k,
                                  const void* v, void* out, int B, int Hq,
                                  int Hkv, int Sq, int Sk, int hd,
                                  int q_offset, int causal, int window,
                                  float cap, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (Sk == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)B * Hq * Sq * hd * 2, st);
  switch (hd) {
    case 16:
      return (int)launch<16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, q_offset,
                             causal, window, cap, scale, st);
    case 32:
      return (int)launch<32>(q, k, v, out, B, Hq, Hkv, Sq, Sk, q_offset,
                             causal, window, cap, scale, st);
    case 64:
      return (int)launch<64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, q_offset,
                             causal, window, cap, scale, st);
    case 128:
      return (int)launch<128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, q_offset,
                              causal, window, cap, scale, st);
    default:
      return (int)launch<256>(q, k, v, out, B, Hq, Hkv, Sq, Sk, q_offset,
                              causal, window, cap, scale, st);
  }
}
