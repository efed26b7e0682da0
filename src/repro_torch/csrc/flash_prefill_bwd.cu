// The backward of flash prefill attention for Hopper (sm_90a), CUDA C++ on
// the tensor cores.
//
// Replaces no TPU kernel: the JAX package trains under its reference
// backend (plain jnp attention, differentiated by jax.grad) and has no
// backward kernel. The port has no backend switch, so on the card a
// train-mode layer's attention runs `flash_prefill` (csrc/flash_prefill.cu)
// and its gradient must come from a kernel too
// (kernels/flash_prefill.py:FlashPrefillFn). It computes dQ, dK and dV of
// what the forward computes: GQA (q head h reads kv head h / G), causal
// or not, sliding `window`, logit softcap `cap` (x = cap tanh(s / cap))
// and `scale`, q_offset 0, Sq rows over Sk keys (Sq != Sk: whisper's
// cross-attention, non-causal), at head dims 16, 32, 64, 128 and 256,
// from q, k, v and dO, all bf16; outputs bf16, every sum in fp32.
//
// What bounds it on an H100: the function needs five hd-long products
// a visible (q row, key) pair and q head (s = q.k, dP = dO.v, dV += p dO,
// dK += dS q, dQ += dS k), 10 hd operations, against reading q, k, v,
// dO and writing dq, dk, dv once, ~2 hd (3 Hq Sq + 4 Hkv Sk) bytes. At
// the planner's training shape (B 8 x S 256, 12/4 heads of 64, causal)
// that is 2.0 G operations against 14.2 MB: bytes bound, 4.2 us; at the
// long rows of the dense families' training (starcoder2-3b's 24/2 heads
// of 128 over 4,608 rows) 322 G operations, 0.33 ms on the bf16 tensor
// cores (989 TFLOP/s) against 0.02 ms of bytes. So every product runs
// on the tensor cores (wgmma, bf16 operands, fp32 accumulators in
// registers, the helpers of csrc/wgmma.cuh shared with the forward), and
// every tile arrives by TMA through the forward's 3-D tensor maps (rows
// past a head's Sq or Sk read as zeros, never as the next head's rows).
//
// Design: three passes, launched in order on one stream by one C entry
// point; a block is one warpgroup (128 threads, the M = 64 of wgmma), or
// two in the dK/dV pass (below).
//   * rows (`prefill_bwd_rows`): one block per (64-row q tile, q head,
//     batch), q tiles last-first. Q and dO arrive once, K/V tiles through
//     a 2-stage TMA ring. Per key tile S = Q K^T and dP = dO V^T (SS
//     m64n64k16, hd/16 k steps each); each row keeps its online max m,
//     l = sum 2^(x - m) and e = sum 2^(x - m) dP, rescaled when m moves
//     as the forward rescales its accumulator, in log2 units. It writes
//     L = m + log2 l and D = e / l = sum p dP, fp32, into scratch the
//     wrapper allocates with Sq rounded up to 64 rows a head, so that
//     the dK/dV pass reads a q tile's 64 values as one aligned bulk copy.
//     D is taken from the kernel's own p: rowsum(dO * O) of the forward's
//     bf16 output would leave each row's dS a nonzero sum, and dQ, dK a
//     part along the row's mean key (5% of whisper-smoke's decoder wq
//     gradient against the plain version);
//   * dK/dV (`prefill_bwd_dkdv`): one block per (64-key tile, kv head,
//     batch), the keys the M of every product. K and V arrive once; for
//     each of the G q heads in order and each q tile that can see the
//     key tile (from the first q tile whose last row reaches the tile's
//     first key when causal, to the last row the window lets see its
//     last key; every q tile when neither), Q, dO, L and D arrive
//     through a TMA ring of 2 stages a warpgroup (the next items' loads
//     overlap these' products). S^T = K Q^T and dP^T = V dO^T (SS); P^T =
//     2^(x - L), exactly 0 by select where masked and on rows past Sq;
//     dS^T = P^T (dP^T - D) dx/ds, with dx/ds = scale (1 - tanh^2) under
//     a cap and scale without. P^T and dS^T, rounded to bf16, are packed
//     in registers as the RS A operand of dV += P^T dO and dK += dS^T Q,
//     whose B operands are the dO and Q tiles read MN-major (as the
//     forward reads V);
//   * dQ (`prefill_bwd_dq`): one block per (64-row q tile, q head,
//     batch), as the rows pass: S and dP (SS), P = 2^(x - L) and dS as
//     above, rounded to bf16, and dQ += dS K (RS, K read MN-major).
// The kernel does nine hd-long products a visible pair where the function
// needs five (the rows and dQ passes both compute S and dP), so at 9/5 of
// the operations bound at best.
//
// Choices where the card pushes back:
//   * hd 256: dK and dV at 64 x 256 in fp32 are 256 registers a thread,
//     past the 255 a thread may hold. At hd 256 a dK/dV block is two
//     warpgroups that take every item together: warpgroup 0 computes
//     S^T, P^T and dV, warpgroup 1 S^T, dP^T, dS^T and dK (five products
//     a pair there instead of four: S^T in both), 128 accumulators a
//     thread each. One warpgroup's two sweeps (dV over the items, then
//     dK over them again) took 0.245 device ms at 8/4 heads over 1,024
//     rows against the two warpgroups' 0.196 (H100 80GB HBM3, 700 W).
//     Up to hd 128 dV and dK stay in one warpgroup (64 + 64 accumulators
//     at hd 128);
//   * hd 16 runs the hd-32 tiles (the forward's trick): the tensor maps
//     are 16 columns wide and their 32-column boxes read the columns past
//     16 as zeros, S and dP take one k step, and dQ, dK, dV write only
//     the 16 real columns (the others hold exact zeros);
//   * grid under-fill: the dK/dV grid is (key tiles, Hkv, B) and each
//     block a serial chain of G x (q tiles) items: 64 blocks at kimi-k2's
//     8 kv heads over 512 keys, 144 at starcoder2-3b's 2 over 4,608 keys
//     (768 items each), on 132 SMs. Where the grid has fewer blocks than
//     two an SM, a block (up to hd 128) is two warpgroups that take
//     alternate items from a 4-stage ring, each with its own dK and dV;
//     at the end warpgroup 1's sums are added to warpgroup 0's through
//     shared memory, in that order. The chain halves, the bits stay
//     fixed, and no partial reaches device memory (a split of the G
//     heads over blocks would need fp32 partials and a fourth, reducing
//     launch). Where the grid fills the SMs, a block is one warpgroup
//     (2-3 blocks an SM: whisper's 1,920 blocks took 0.39 device ms in
//     this pass with one warpgroup a block, 0.64 with two; kimi's 64
//     0.19 with one, 0.13 with two; starcoder2's 144 2.34 and 1.49; H100
//     80GB HBM3, 700 W). The choice follows the grid and the card's SM
//     count, so a shape always takes the same code;
//   * numerics: P and dS are rounded to bf16 before their products, as
//     the forward rounds P (one bf16 rounding of each term, inside the
//     card's |kernel - plain| <= 2e-2 + 2e-2 |plain|; the CPU tests
//     emulate this arithmetic against jax.grad of the JAX oracle);
//   * shared memory: the rows and dQ passes' rings are 2 K/V stages at
//     every head dim (97 KB at hd 128: two blocks an SM; 193 KB at hd
//     256: one); the dK/dV pass's (Q, dO) ring has 2 stages a warpgroup
//     up to hd 128 (98 KB with one warpgroup at hd 128, 163 KB with two)
//     and 2 that both warpgroups read at hd 256 (194 KB);
//   * masks: a tile that any of Sq, Sk, the causal edge or the window may
//     cut is masked element by element (a select, never exp of a large
//     negative), so a fully masked entry adds exactly 0.
// No atomics and every sum in a fixed order (the G heads and q tiles in
// order, or alternate items and then the two warpgroups' sums in order;
// the k tiles in order, the quads' xor-shuffles): two calls give the
// same bits.
#include <cuda_bf16.h>
#include <math.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace tma;
using namespace wg;

constexpr int BT = 64;        // rows of a q tile, keys of a k tile
constexpr int NTH = 128;      // one warpgroup
constexpr int STAGES = 2;     // ring stages of the rows and dQ passes
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The tiles and shared memory of head dim HD (tile head dim TH: hd 16
// runs the hd-32 tiles). Every tile is 1,024-byte aligned.
template <int HD>
struct Bwd {
  static constexpr int TH = tile_hd<HD>();
  static constexpr int T_BYTES = BT * TH * 2;     // one 64-row bf16 tile
  static constexpr int NO = TH / 2;               // accumulators a thread
  static constexpr int KQ = HD / 16;              // k steps of S and dP
  // the dK/dV pass at hd 256: two warpgroups, dV and dK of every item
  static constexpr bool SPLIT = TH > 128;
  // rows and dQ passes: Q, dO, then STAGES (K, V)
  static constexpr int ROW_SMEM = 1024 + 2 * T_BYTES + STAGES * 2 * T_BYTES;
  // dK/dV pass of WGS warpgroups: K, V, kv_stages (Q, dO), then as many
  // (L, D) of 64 floats; the (Q, dO) ring then holds warpgroup 1's fp32
  // dV and dK
  static constexpr int LD_BYTES = 2 * BT * 4;
  __host__ __device__ static constexpr int kv_stages(int wgs) {
    return SPLIT ? 2 : 2 * wgs;
  }
  __host__ __device__ static constexpr int kv_smem(int wgs) {
    return 1024 + 2 * T_BYTES + kv_stages(wgs) * (2 * T_BYTES + LD_BYTES);
  }
  static_assert(ROW_SMEM <= 232448 - 1024, "a block's shared memory");
};

struct Params {
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* lse;        // (B, Hq, Sqp): L in log2 units
  float* dsum;       // (B, Hq, Sqp): D
  int Hq, Hkv, Sq, Sk, Sqp, causal, window;
  float cap, scale;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ bool visible(const Params& p, int row, int key) {
  bool ok = row < p.Sq && key < p.Sk;
  if (p.causal) ok = ok && key <= row;
  if (p.window) ok = ok && row - key < p.window;
  return ok;
}

// whether some (row, key) of q tile q0 and key tile k0 may be masked
__device__ __forceinline__ bool tile_cut(const Params& p, int q0, int k0) {
  return q0 + BT > p.Sq || k0 + BT > p.Sk
         || (p.causal && k0 + BT - 1 > q0)
         || (p.window && q0 + BT - 1 - k0 >= p.window);
}

// the logit of a raw dot s in log2 units, and dx/ds in natural units
__device__ __forceinline__ float logit2(const Params& p, float s,
                                        float* dxds) {
  if (p.cap != 0.f) {
    const float th = tanhf(s * p.scale / p.cap);
    *dxds = p.scale * (1.f - th * th);
    return p.cap * th * LOG2E;
  }
  *dxds = p.scale;
  return s * p.scale * LOG2E;
}

// rows [row, row + 64) of head `head` of maps ta and tb into dst and
// dst + T_BYTES, completing `bar` (which also expects `extra` bytes)
template <int TH>
__device__ __forceinline__ void load_pair(uint8_t* dst,
                                          const CUtensorMap* ta,
                                          const CUtensorMap* tb,
                                          uint64_t* bar, int row, int head,
                                          int extra) {
  using L = Panels<TH>;
  constexpr int T = BT * TH * 2;
  bar_expect(bar, 2 * T + extra);
#pragma unroll
  for (int pn = 0; pn < L::NP; ++pn) {
    tma_load(dst + pn * BT * L::SW, ta, bar, pn * L::PC, row, head);
    tma_load(dst + T + pn * BT * L::SW, tb, bar, pn * L::PC, row, head);
  }
}

// the four bf16x2 A fragments of each of the 4 k steps of a 64 x 64
// fp32 accumulator
__device__ __forceinline__ void pack_a(uint32_t a[4][4], const float* x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// S (or S^T) and, with DP, dP (or dP^T) of one tile pair: 64 x 64 fp32
// each, a's rows against b's (both K-major, hd/16 k steps), in one
// commit group
template <int HD, bool DP>
__device__ __forceinline__ void two_products(float* s, const uint8_t* a0,
                                             const uint8_t* b0, float* dp,
                                             const uint8_t* a1,
                                             const uint8_t* b1) {
  using L = Bwd<HD>;
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
  reg_fence<32>(s);
  if constexpr (DP) {
#pragma unroll
    for (int j = 0; j < 32; ++j) dp[j] = 0.f;
    reg_fence<32>(dp);
  }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < L::KQ; ++kk)
    wgmma_ss_n64(s, desc_kmajor<L::TH, BT>(a0, kk),
                 desc_kmajor<L::TH, BT>(b0, kk), kk > 0);
  if constexpr (DP) {
#pragma unroll
    for (int kk = 0; kk < L::KQ; ++kk)
      wgmma_ss_n64(dp, desc_kmajor<L::TH, BT>(a1, kk),
                   desc_kmajor<L::TH, BT>(b1, kk), kk > 0);
  }
  wg_commit();
  wg_wait0();
  reg_fence<32>(s);
  if constexpr (DP) reg_fence<32>(dp);
}

// 64 x TH fp32 accumulators (rows r0, r0 + 8 of the thread) to bf16 rows
// of `out` (row stride HD), rows < rows, the HD real columns
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float* acc, int r0,
                                           int rows, int t) {
  __nv_bfloat16* op = out + (long long)r0 * HD + 2 * t;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < rows)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * HD + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ------------------------------------------------- rows and dQ passes ----

// The loop of a block of the rows pass (DQ false) or the dQ pass (DQ
// true) over the key tiles its q tile sees.
template <int HD, bool DQ>
__device__ __forceinline__ void q_tile_pass(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const Params& p, uint8_t* smem,
    uint64_t* bar_q, uint64_t* bar_kv) {
  using L = Bwd<HD>;
  constexpr int TH = L::TH;
  uint8_t* sQ = align1024(smem);
  uint8_t* sdO = sQ + L::T_BYTES;
  uint8_t* sKV = sdO + L::T_BYTES;     // stage s: K, then V

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int qh = b * p.Hq + hq;
  const int kvh = b * p.Hkv + hq / (p.Hq / p.Hkv);

  // key tiles [t0, t0 + n) of the partition from key 0
  int kend = p.Sk;
  if (p.causal) kend = min(kend, min(q0 + BT, p.Sq));
  const int kbeg = p.window ? max(0, q0 - p.window + 1) : 0;
  const int t0 = kbeg / BT;
  const int n = max(0, (kend + BT - 1) / BT - t0);

  if (tid == 0) {
    bar_init(bar_q);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) bar_init(&bar_kv[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_pair<TH>(sQ, tq, tdo, bar_q, q0, qh, 0);
    for (int i = 0; i < min(STAGES, n); ++i)
      load_pair<TH>(sKV + i * 2 * L::T_BYTES, tk, tv, &bar_kv[i],
                    (t0 + i) * BT, kvh, 0);
  }
  __syncwarp();

  // this thread's rows (g, g + 8 of its warp's 16)
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  const long long lrow = (long long)qh * p.Sqp;
  // rows pass: m, l = sum 2^(x - m), e = sum 2^(x - m) dP of each row
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, e0 = 0.f, e1 = 0.f;
  // dQ pass: each row's L and D, and dQ
  float L0 = 0.f, L1 = 0.f, D0 = 0.f, D1 = 0.f;
  float dq[DQ ? L::NO : 1];
  if constexpr (DQ) {
    L0 = p.lse[lrow + r0];
    L1 = p.lse[lrow + r1];
    D0 = p.dsum[lrow + r0];
    D1 = p.dsum[lrow + r1];
#pragma unroll
    for (int i = 0; i < L::NO; ++i) dq[i] = 0.f;
  }

  bar_wait(bar_q, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const int k0 = (t0 + i) * BT;
    const uint8_t* sK = sKV + s * 2 * L::T_BYTES;
    const uint8_t* sV = sK + L::T_BYTES;
    bar_wait(&bar_kv[s], (i / STAGES) & 1);

    float sc[32], dp[32];
    two_products<HD, true>(sc, sQ, sK, dp, sdO, sV);

    // register 4j + e: row (e < 2 ? r0 : r1), key k0 + 8j + 2t + (e & 1)
    const bool cut = tile_cut(p, q0, k0);
    if constexpr (!DQ) {
      uint32_t live = 0xffffffffu;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float dxds;
        float x = logit2(p, sc[j], &dxds);
        if (cut && !visible(p, (j & 2) ? r1 : r0,
                            k0 + 8 * (j / 4) + 2 * t + (j & 1))) {
          x = NEG_INF;
          live &= ~(1u << j);
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
      float ps0 = 0.f, ps1 = 0.f, es0 = 0.f, es1 = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float mm = (j & 2) ? mn1 : mn0;
        const float pr = (live >> j) & 1u ? ex2(sc[j] - mm) : 0.f;
        if (j & 2) {
          ps1 += pr;
          es1 = fmaf(pr, dp[j], es1);
        } else {
          ps0 += pr;
          es0 = fmaf(pr, dp[j], es0);
        }
      }
      l0 = fmaf(l0, a0, ps0);
      l1 = fmaf(l1, a1, ps1);
      e0 = fmaf(e0, a0, es0);
      e1 = fmaf(e1, a1, es1);
      m0 = mn0;
      m1 = mn1;
    } else {
      // dS = p (dP - D) dx/ds, exactly 0 where masked
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float dxds;
        const float x = logit2(p, sc[j], &dxds);
        const bool ok = !cut || visible(p, (j & 2) ? r1 : r0,
                                        k0 + 8 * (j / 4) + 2 * t + (j & 1));
        const float pr = ok ? ex2(x - ((j & 2) ? L1 : L0)) : 0.f;
        sc[j] = ok ? pr * (dp[j] - ((j & 2) ? D1 : D0)) * dxds : 0.f;
      }
      uint32_t da[4][4];
      pack_a(da, sc);
      // dQ += dS K
      reg_fence<L::NO>(dq);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<TH>(dq, da[kk], desc_mn<TH, BT>(sK, kk));
      wg_commit();
      wg_wait0();
      reg_fence<L::NO>(dq);
    }

    // every thread is past this stage's tiles: refill it STAGES ahead
    __syncthreads();
    if (tid == 0 && i + STAGES < n)
      load_pair<TH>(sKV + s * 2 * L::T_BYTES, tk, tv, &bar_kv[s],
                    k0 + STAGES * BT, kvh, 0);
    __syncwarp();
  }

  if constexpr (!DQ) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
    e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
    e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
    // every row of the padded scratch (rows past Sq: L +inf, D 0)
    if (t == 0) {
      p.lse[lrow + r0] = l0 > 0.f ? m0 + log2f(l0) : INFINITY;
      p.lse[lrow + r1] = l1 > 0.f ? m1 + log2f(l1) : INFINITY;
      p.dsum[lrow + r0] = l0 > 0.f ? e0 / l0 : 0.f;
      p.dsum[lrow + r1] = l1 > 0.f ? e1 / l1 : 0.f;
    }
  } else {
    store_rows<HD>(p.dq + (long long)qh * p.Sq * HD, dq, r0, p.Sq, t);
  }
}

template <int HD>
__global__ void __launch_bounds__(NTH)
prefill_bwd_rows(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_kv[STAGES];
  q_tile_pass<HD, false>(&tq, &tk, &tv, &tdo, p, smem_raw, &bar_q, bar_kv);
}

template <int HD>
__global__ void __launch_bounds__(NTH)
prefill_bwd_dq(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_kv[STAGES];
  q_tile_pass<HD, true>(&tq, &tk, &tv, &tdo, p, smem_raw, &bar_q, bar_kv);
}

// ------------------------------------------------------------ dK, dV ----

// One (q head, q tile) item of a dK/dV block: S^T, P^T, then dV += P^T dO
// (DV) and dP^T, dS^T, dK += dS^T Q (DK). sQ, sdO: the item's tiles; sL,
// sD: its rows' L and D.
template <int HD, bool DV, bool DK>
__device__ __forceinline__ void kv_item(const Params& p, float* dv,
                                        float* dk, const uint8_t* sK,
                                        const uint8_t* sV,
                                        const uint8_t* sQ,
                                        const uint8_t* sdO, const float* sL,
                                        const float* sD, int q0, int k0,
                                        int kr0, int t) {
  using L = Bwd<HD>;
  constexpr int TH = L::TH;
  float st[32], dpt[DK ? 32 : 1];
  two_products<HD, DK>(st, sK, sQ, dpt, sV, sdO);

  // register 4j + e: key (e < 2 ? kr0 : kr0 + 8), q row q0 + c with
  // c = 8j + 2t + (e & 1)
  const bool cut = tile_cut(p, q0, k0);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * (j / 4) + 2 * t + (j & 1);
    float dxds;
    const float x = logit2(p, st[j], &dxds);
    const bool ok = !cut || visible(p, q0 + c, (j & 2) ? kr0 + 8 : kr0);
    const float pr = ok ? ex2(x - sL[c]) : 0.f;
    st[j] = pr;
    if constexpr (DK) dpt[j] = ok ? pr * (dpt[j] - sD[c]) * dxds : 0.f;
  }
  uint32_t pa[4][4], da[4][4];
  if constexpr (DV) pack_a(pa, st);
  if constexpr (DK) pack_a(da, dpt);
  if constexpr (DV) reg_fence<L::NO>(dv);
  if constexpr (DK) reg_fence<L::NO>(dk);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (DV) wgmma_rs<TH>(dv, pa[kk], desc_mn<TH, BT>(sdO, kk));
    if constexpr (DK) wgmma_rs<TH>(dk, da[kk], desc_mn<TH, BT>(sQ, kk));
  }
  wg_commit();
  wg_wait0();
  if constexpr (DV) reg_fence<L::NO>(dv);
  if constexpr (DK) reg_fence<L::NO>(dk);
}

// Item i of a dK/dV block into ring stage i % ST: q head row qh0 + i / nq
// of the maps, q tile qt0 + i % nq; its Q and dO tiles, its rows' L and D.
template <int TH, int ST>
__device__ __forceinline__ void load_item(
    const CUtensorMap* tq, const CUtensorMap* tdo, const Params& p,
    uint8_t* sQd, float* sLD, uint64_t* bar_it, int i, int nq, int qt0,
    int qh0) {
  constexpr int T = BT * TH * 2;
  const int s = i % ST;
  const int qh = qh0 + i / nq, q0 = (qt0 + i % nq) * BT;
  float* ld = sLD + s * 2 * BT;
  load_pair<TH>(sQd + s * 2 * T, tq, tdo, &bar_it[s], q0, qh, 2 * BT * 4);
  const long long lrow = (long long)qh * p.Sqp + q0;
  bulk_load(ld, p.lse + lrow, BT * 4, &bar_it[s]);
  bulk_load(ld + BT, p.dsum + lrow, BT * 4, &bar_it[s]);
}

// WGS warpgroups a block (2 at hd 256, SPLIT)
template <int HD, int WGS>
__global__ void __launch_bounds__(WGS * NTH)
prefill_bwd_dkdv(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo, const Params p) {
  using L = Bwd<HD>;
  constexpr int TH = L::TH, ST = L::kv_stages(WGS), NO = L::NO;
  static_assert(!L::SPLIT || WGS == 2, "hd 256 splits dV and dK");
  static_assert(L::kv_smem(WGS) <= 232448 - 1024, "a block's shared memory");
  static_assert(L::SPLIT || 2 * NO * NTH * 4 <= ST * 2 * L::T_BYTES,
                "warpgroup 1's sums fit the ring");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t bar_it[ST];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + L::T_BYTES;
  uint8_t* sQd = sV + L::T_BYTES;      // stage s: Q, then dO
  float* sLD = reinterpret_cast<float*>(sQd + ST * 2 * L::T_BYTES);

  const int tid = threadIdx.x;
  const int wg = tid / NTH, wt = tid % NTH;    // warpgroup, its thread
  const int warp = wt / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BT, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int kvh = b * p.Hkv + blockIdx.y;
  const int qh0 = b * p.Hq + blockIdx.y * G;   // the group's first q head

  // q tiles [qt0, qt0 + nq) that see a key of [k0, k0 + 64), for each of
  // the G q heads in order: items i = g nq + (qt - qt0)
  const int qbeg = p.causal ? k0 : 0;
  const int qend = p.window ? min(p.Sq, k0 + BT - 1 + p.window) : p.Sq;
  const int qt0 = qbeg / BT;
  const int nq = max(0, (qend + BT - 1) / BT - qt0);
  const int n = G * nq;

  if (tid == 0) {
    bar_init(&bar_kv);
#pragma unroll
    for (int s = 0; s < ST; ++s) bar_init(&bar_it[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_pair<TH>(sK, &tk, &tv, &bar_kv, k0, kvh, 0);
    for (int i = 0; i < min(ST, n); ++i)
      load_item<TH, ST>(&tq, &tdo, p, sQd, sLD, bar_it, i, nq, qt0, qh0);
  }
  __syncwarp();

  const int g = lane / 4, t = lane % 4;
  const int kr0 = k0 + 16 * warp + g;
  __nv_bfloat16* dk_out = p.dk + (long long)kvh * p.Sk * HD;
  __nv_bfloat16* dv_out = p.dv + (long long)kvh * p.Sk * HD;
  // SPLIT: warpgroup 0's dV or warpgroup 1's dK in acc; else each
  // warpgroup's dV in acc, dK in acc2, over its items
  float acc[NO], acc2[L::SPLIT ? 1 : NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;
  if constexpr (!L::SPLIT) {
#pragma unroll
    for (int j = 0; j < NO; ++j) acc2[j] = 0.f;
  }
  bar_wait(&bar_kv, 0);

  if constexpr (L::SPLIT) {
    // every item by both warpgroups: S^T, P^T and dV by warpgroup 0;
    // S^T, dP^T, dS^T and dK by warpgroup 1
    for (int i = 0; i < n; ++i) {
      const int s = i % ST;
      bar_wait(&bar_it[s], (i / ST) & 1);
      const uint8_t* sQ = sQd + s * 2 * L::T_BYTES;
      const float* sL = sLD + s * 2 * BT;
      const int q0 = (qt0 + i % nq) * BT;
      if (wg == 0)
        kv_item<HD, true, false>(p, acc, nullptr, sK, sV, sQ,
                                 sQ + L::T_BYTES, sL, sL + BT, q0, k0, kr0,
                                 t);
      else
        kv_item<HD, false, true>(p, nullptr, acc, sK, sV, sQ,
                                 sQ + L::T_BYTES, sL, sL + BT, q0, k0, kr0,
                                 t);
      // both warpgroups are past this stage: refill it ST items ahead
      __syncthreads();
      if (tid == 0 && i + ST < n)
        load_item<TH, ST>(&tq, &tdo, p, sQd, sLD, bar_it, i + ST, nq, qt0,
                          qh0);
      __syncwarp();
    }
    store_rows<HD>(wg == 0 ? dv_out : dk_out, acc, kr0, p.Sk, t);
  } else if constexpr (WGS == 1) {
    // every item in order, dV and dK
    for (int i = 0; i < n; ++i) {
      const int s = i % ST;
      bar_wait(&bar_it[s], (i / ST) & 1);
      const uint8_t* sQ = sQd + s * 2 * L::T_BYTES;
      const float* sL = sLD + s * 2 * BT;
      kv_item<HD, true, true>(p, acc, acc2, sK, sV, sQ, sQ + L::T_BYTES, sL,
                              sL + BT, (qt0 + i % nq) * BT, k0, kr0, t);
      // every thread is past this stage: refill it ST items ahead
      __syncthreads();
      if (tid == 0 && i + ST < n)
        load_item<TH, ST>(&tq, &tdo, p, sQd, sLD, bar_it, i + ST, nq, qt0,
                          qh0);
      __syncwarp();
    }
    store_rows<HD>(dv_out, acc, kr0, p.Sk, t);
    store_rows<HD>(dk_out, acc2, kr0, p.Sk, t);
  } else {
    // step j: warpgroup w takes item 2 j + w, dV and dK
    for (int j = 0; 2 * j < n; ++j) {
      const int i = 2 * j + wg;
      if (i < n) {
        const int s = i % ST;
        bar_wait(&bar_it[s], (i / ST) & 1);
        const uint8_t* sQ = sQd + s * 2 * L::T_BYTES;
        const float* sL = sLD + s * 2 * BT;
        kv_item<HD, true, true>(p, acc, acc2, sK, sV, sQ, sQ + L::T_BYTES,
                                sL, sL + BT, (qt0 + i % nq) * BT, k0, kr0,
                                t);
      }
      // both warpgroups are past this step's stages: refill them ST
      // items ahead
      __syncthreads();
      if (tid == 0)
        for (int r = 2 * j + ST; r < min(2 * j + ST + 2, n); ++r)
          load_item<TH, ST>(&tq, &tdo, p, sQd, sLD, bar_it, r, nq, qt0,
                            qh0);
      __syncwarp();
    }
    // warpgroup 1's sums added to warpgroup 0's, in that order, through
    // the ring (every load issued has landed and been read)
    float* red = reinterpret_cast<float*>(sQd);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        red[j * NTH + wt] = acc[j];
        red[(NO + j) * NTH + wt] = acc2[j];
      }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j] += red[j * NTH + wt];
        acc2[j] += red[(NO + j) * NTH + wt];
      }
      store_rows<HD>(dv_out, acc, kr0, p.Sk, t);
      store_rows<HD>(dk_out, acc2, kr0, p.Sk, t);
    }
  }
}

// --------------------------------------------------------------- host ----

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const Params& p, int B,
                   cudaStream_t stream) {
  using L = Bwd<HD>;
  PFN_cuTensorMapEncodeTiled_v12000 enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<HD>(enc, &mq, q, p.Sq, B * p.Hq, BT)
      || !make_map<HD>(enc, &mdo, dout, p.Sq, B * p.Hq, BT)
      || !make_map<HD>(enc, &mk, k, p.Sk, B * p.Hkv, BT)
      || !make_map<HD>(enc, &mv, v, p.Sk, B * p.Hkv, BT))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = [] {
    cudaError_t e = allow_smem(prefill_bwd_rows<HD>, L::ROW_SMEM);
    if (e == cudaSuccess)
      e = allow_smem(prefill_bwd_dkdv<HD, 2>, L::kv_smem(2));
    if constexpr (!L::SPLIT)
      if (e == cudaSuccess)
        e = allow_smem(prefill_bwd_dkdv<HD, 1>, L::kv_smem(1));
    if (e == cudaSuccess) e = allow_smem(prefill_bwd_dq<HD>, L::ROW_SMEM);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const dim3 qgrid((p.Sq + BT - 1) / BT, p.Hq, B);
  const dim3 kgrid((p.Sk + BT - 1) / BT, p.Hkv, B);
  prefill_bwd_rows<HD><<<qgrid, NTH, L::ROW_SMEM, stream>>>(mq, mk, mv, mdo,
                                                           p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // two warpgroups a dK/dV block (each its own items, summed in a fixed
  // order) where the grid leaves SMs to spare for a second block each;
  // one where it fills them (more blocks an SM: 2-3 of one warpgroup
  // against 1 of two)
  if (L::SPLIT || kgrid.x * kgrid.y * kgrid.z < 2u * sms)
    prefill_bwd_dkdv<HD, 2><<<kgrid, 2 * NTH, L::kv_smem(2), stream>>>(
        mq, mk, mv, mdo, p);
  else if constexpr (!L::SPLIT)
    prefill_bwd_dkdv<HD, 1><<<kgrid, NTH, L::kv_smem(1), stream>>>(
        mq, mk, mv, mdo, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  prefill_bwd_dq<HD><<<qgrid, NTH, L::ROW_SMEM, stream>>>(mq, mk, mv, mdo,
                                                         p);
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq: (B,Hq,Sq,hd); k, v, dk, dv: (B,Hkv,Sk,hd); all bf16,
// contiguous, 16-byte aligned. lse, dsum: fp32 scratch of (B,Hq,Sqp) with
// Sqp = Sq rounded up to a multiple of 64 (the wrapper allocates it so).
// q_offset is 0 (the wrapper refuses any other); causal or not, Sq and Sk
// any (causal rows see keys 0..row); hd in {16, 32, 64, 128, 256}, the
// forward's head dims. Launches the three passes on `stream` and returns
// the first launch error, else cudaSuccess.
extern "C" int flash_prefill_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* dk, void* dv, void* lse, void* dsum,
    int B, int Hq, int Hkv, int Sq, int Sk, int hd, int causal, int window,
    float cap, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Sk == 0) return (int)cudaSuccess;
  Params p{(__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
           (float*)lse, (float*)dsum, Hq, Hkv, Sq, Sk,
           (Sq + BT - 1) / BT * BT, causal, window, cap, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 16) return (int)launch<16>(q, k, v, dout, p, B, st);
  if (hd == 32) return (int)launch<32>(q, k, v, dout, p, B, st);
  if (hd == 64) return (int)launch<64>(q, k, v, dout, p, B, st);
  if (hd == 128) return (int)launch<128>(q, k, v, dout, p, B, st);
  return (int)launch<256>(q, k, v, dout, p, B, st);
}
