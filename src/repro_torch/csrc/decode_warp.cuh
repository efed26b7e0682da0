// The decode family's attention routine for Hopper (sm_90a): a warp per
// row, K/V through an asynchronous ring.
//
// flash_decode, flash_decode_paged, flash_verify and flash_verify_paged
// all compute, for the query rows of one (kv head, batch slot), the
// online-softmax attention over the first `lim` keys of that slot's K/V
// rows, each row with its own key limit. All four run attend_warps below;
// they differ only in where a tile's K/V rows come from, a source
// (DenseSource: the slot's (Sk, HD) slab of a dense cache; PagedSource:
// the blocks of a paged pool its row of the block table names). The
// source only fills the ring; every row's arithmetic is this one piece of
// code, in this order, so a row has the same bits in all four kernels
// (verify row == decode row at its position, paged == dense on the
// gathered view, any block size alike):
//
//   * keys in tiles of NT = 128 from key 0; a row takes part in a tile
//     only if the tile starts below its limit;
//   * score: dot = fmaf(q[d], k[d], dot), d ascending, q in fp32; then
//     x = dot * scale and, where cap != 0, cap * tanhf(x / cap); keys at
//     or past the limit score NEG_INF. The products are __fmul_rn, so no
//     contraction can fold them into a later subtraction;
//   * the tile max (exact in any order), m_new = max(m, tile max),
//     alpha = expf(m - m_new), p = expf(s - m_new) and exactly 0 past the
//     limit;
//   * the tile sum: each group of 32 consecutive keys by warp_sum's xor
//     butterfly (16, 8, 4, 2, 1), then the four group sums in order, then
//     l = fmaf(alpha, l, sum);
//   * P.V: a = fmaf(p_j, v_jd, a) for j from 0 to min(NT, lim - k0) - 1
//     in order, from 0; then acc = fmaf(acc, alpha, a);
//   * out = bf16_rn(acc / max(l, 1e-30)): a row with no keys writes 0.
//
// How the work is organised (the arithmetic above is fixed; this is
// what the card changes):
//
//   * a warp owns one row for the whole walk over the keys: m, l and acc
//     live in its registers (HD/32 fp32 of acc per lane); no row state
//     passes through shared memory and no block barrier separates rows.
//     Its key limit is uniform over the warp, so are its loops and
//     branches;
//   * scores: lane l holds keys l, 32+l, 64+l and 96+l of the tile: four
//     independent fmaf chains, and each group of 32 keys is one
//     warp_sum, the tree above. P.V: lane l owns HD/32 adjacent columns,
//     one chain over j each; p is read back from the warp's own row of
//     shared memory as a broadcast. Tile i - 1's P.V and tile
//     i's scores run in one stretch of code (a phase), so their
//     independent chains interleave;
//   * a block holds up to block_warps warps (8 at HD 128, else 4), which
//     share every staged K/V tile. K and V tiles alternate through a
//     ring of NSTAGE = 4 entries filled by the copy engine, one phase
//     ahead, so the consumer spends no instructions on loads; one block
//     barrier per phase frees the entries of the phase before. Only keys
//     below the block's largest limit are loaded. The dense source
//     issues a K tile as HD / PC swizzled TMA boxes of NT rows and a V
//     tile as one bulk copy, from thread 0; the paged source issues a
//     tile in row boxes of g = gcd(bs, NT) rows (one pool block's rows,
//     contiguous in the pool), spread over the block's warps, one row box
//     and one table entry a thread, read a tile ahead;
//   * the grid is (Hkv, B, blocks of a kv head's G * W rows): rows are
//     split over blocks (each re-reads its slot's K/V, from L2 mostly),
//     keys never are, so any G and W work. Two rows a warp (sharing the
//     K/V reads and bf16 conversions) were slower at every served shape
//     and won only past ~10 k rows a call on an H100 (PERF.md §6).
//
// What bounds it on an H100: each key costs 2 * 2 * HD operations per
// row (2 * HD in Q.K^T, bf16 operands, 989 TFLOP/s on the card; 2 * HD
// in P.V, fp32 p, 67 TFLOP/s; ~125 TFLOP/s for the mix) against
// 2 * 2 * HD bytes of K/V read once for all G or G*W rows of a kv head:
// `rows` operations a byte, against 125 TFLOP/s / 3.35 TB/s = 37. Decode
// (G <= 8) is bound by the bytes, verify by the operations from ~38 rows
// a kv head (kimi-k2's 40 at W = 5). With ragged slots the longest
// slot's rows, each walked by one warp, set the critical path.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "tma.cuh"

namespace decode_warp {

using namespace tma;

constexpr int NT = 128;            // keys a tile
constexpr int NSTAGE = 4;          // ring entries (K and V tiles alternate)
constexpr float NEG_INF = -1e30f;

// Warps a block of head dim HD holds at most: 8 at HD 128, where the
// ring (128 KB) lets one block reside on an SM, so an SM still runs 8
// warps; 4 below, where two or more blocks reside on an SM and smaller
// blocks spread a kv head's rows over more SMs.
template <int HD>
__host__ __device__ constexpr int block_warps() { return HD == 128 ? 8 : 4; }

// K tiles arrive by TMA in boxes of PC = min(HD, 64) columns and NT rows
// (two boxes at HD 128), swizzled by the copy engine: the 16-byte chunk
// c of a box row r lands at chunk c ^ (r mod 8) (128-byte rows, HD >= 64)
// or c ^ ((r / 2) mod 4) (64-byte rows, HD 32), so eight lanes reading
// chunk t of eight consecutive keys hit eight different bank groups. V
// tiles arrive as one plain copy (lanes read one row at a time).
template <int HD>
struct KBox {
  static constexpr int PC = HD < 64 ? HD : 64;        // box columns
  static constexpr int CPB = PC / 8;                   // chunks a box row
  static constexpr CUtensorMapSwizzle SWIZZLE =
      PC == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // element offset of chunk t of key row r in a staged K tile
  __device__ static __forceinline__ int at(int r, int t) {
    const int b = t / CPB, c = t % CPB;
    const int pc = PC == 64 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
    return b * NT * PC + r * PC + pc * 8;
  }
};

// Dynamic shared memory of a block of `nw` warps: 1 KB of alignment for
// the swizzled ring, the ring, then each warp's fp32 q row and two
// buffers of its p row.
template <int HD>
__host__ __device__ constexpr size_t smem_bytes(int nw) {
  return 1024 + (size_t)NSTAGE * NT * HD * sizeof(__nv_bfloat16)
      + (size_t)nw * (HD + 2 * NT) * sizeof(float);
}

__device__ __forceinline__ float bf_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// The largest of the warp's 32 values, exactly: fp32 bits mapped to
// ints of the same order (no NaN reaches here), one redux.
__device__ __forceinline__ float warp_fmax(float x) {
  int i = __float_as_int(x);
  i = __reduce_max_sync(0xffffffffu, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// The sum of the warp's 32 values by the xor butterfly 16, 8, 4, 2, 1.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Where a tile's K/V rows come from. A source is called by every thread
// of the block: start(n) once, when the block's largest key limit n is
// known, then, after the ring's barriers are set up, k / v for each tile
// below n in the ring's entry order (K of tile 0, V of tile 0, K of tile
// 1, ...): stage the tile's keys
// [k0, min(k0 + NT, n)) into the ring slot dst (K at KBox's positions, V
// as plain rows of HD) and make `bar`'s phase complete when they have
// landed. Rows of a slot at or past n may hold anything: a score there
// is replaced by NEG_INF and P.V never reads such a V row.

// A dense cache: the slot's K slab is box plane `pair` of the K cache's
// tensor map tk (NT-row boxes; rows past Sk read as zeros), its V slab
// (Sk, HD) at vc. Thread 0 issues every copy.
template <int HD>
struct DenseSource {
  const CUtensorMap* tk;
  int pair;
  const __nv_bfloat16* vc;

  __device__ __forceinline__ void start(int) {}
  __device__ __forceinline__ void k(__nv_bfloat16* dst, uint64_t* bar,
                                    int k0, int) {
    if (threadIdx.x != 0) return;
    bar_expect(bar, NT * HD * 2);
#pragma unroll
    for (int b = 0; b < HD / KBox<HD>::PC; ++b)
      tma_load(dst + b * NT * KBox<HD>::PC, tk, bar, b * KBox<HD>::PC, k0,
               pair);
  }
  __device__ __forceinline__ void v(__nv_bfloat16* dst, uint64_t* bar,
                                    int k0, int n) {
    if (threadIdx.x != 0) return;
    const int bytes = min(NT, n - k0) * HD * 2;
    bar_expect(bar, bytes);
    bulk_load(dst, vc + (long long)k0 * HD, bytes, bar);
  }
};

// A paged pool (nb, Hkv, bs, HD) of K at kp and V at vp: key `key` of the
// slot is row key % bs of block tab[key / bs], the entry clamped to
// [0, nb - 1] (a sentinel reads the last block, as the plain version's
// gather does). A tile goes in nrb = NT / g row boxes of g = gcd(bs, NT)
// rows (a power of 2): a row box never crosses a pool block or a tile, so
// it is one run of the pool. Row box j is issued by lane j / nw of warp
// j % nw (nw warps a block), so each warp issues a share of the copies,
// which a warp issues one lane at a time: V by one bulk copy of its rows
// below n; K, where g >= 8 (a box then starts on a row of the swizzle's
// 8-row period, as KBox::at assumes), by HD / PC TMA boxes of g rows
// through the pool's tensor map tk, (HD, bs, nb * Hkv), plane
// blk * Hkv + hk. Where g < 8 the block's threads copy K's 16-byte chunks
// to KBox::at's positions themselves (the next phase's block barrier
// orders them before their reads; the entry's barrier completes at
// once). Row boxes at or past n are not loaded. Thread 0 sets each
// entry's byte count; a copy may land before it, which leaves the
// barrier's phase open.
//
// With boxes (nrb <= 16: one row box a thread at most) each thread walks
// its row box's table index and row in block from tile to tile by adds,
// with no division, and reads its table entry two copies before it
// issues from it, clamping it only then, so the read's latency hides
// behind a phase: cur / cur_r are the raw entry and the row in its block
// of the tile whose K is issued next (V of a tile follows its K), nxt /
// nxt_r of the tile after, (pq, pr) the table index and row of the tile
// after that, which is read next.
template <int HD>
struct PagedSource {
  const CUtensorMap* tk;
  const __nv_bfloat16* kp;
  const __nv_bfloat16* vp;
  const int* tab;       // this slot's row of the block table
  int nb, Hkv, hk, bs, g;
  int lg = 0, nrb = 0, box = 0, dq = 0, dr = 0, pq = 0, pr = 0;
  int cur = 0, cur_r = 0, nxt = 0, nxt_r = 0;

  __device__ __forceinline__ bool boxes() const { return g >= 8; }
  __device__ __forceinline__ int clamp(int blk) const {
    return blk < 0 ? 0 : (blk >= nb ? nb - 1 : blk);
  }
  // element offset of row r of block blk in the pool
  __device__ __forceinline__ long long row(int blk, int r) const {
    return (((long long)blk * Hkv + hk) * bs + r) * HD;
  }
  // (box mode) this thread's raw table entry for tile t, 0 where its row
  // box holds no key below n; then (pq, pr) step to tile t + 1
  __device__ __forceinline__ int read_entry(int t, int n) {
    const int e = box < nrb && t * NT + box * g < n ? tab[pq] : 0;
    pr += dr;
    pq += dq;
    if (pr >= bs) {
      pr -= bs;
      ++pq;
    }
    return e;
  }

  __device__ __forceinline__ void start(int n) {
    lg = __ffs(g) - 1;
    nrb = NT >> lg;
    box = (threadIdx.x >> 5) + (blockDim.x >> 5) * (threadIdx.x & 31);
    if (boxes()) {
      pq = box * g / bs;
      pr = box * g % bs;
      dq = NT / bs;
      dr = NT % bs;
      cur_r = pr;
      cur = read_entry(0, n);
      nxt_r = pr;
      nxt = read_entry(1, n);
    }
  }
  __device__ __forceinline__ void k(__nv_bfloat16* dst, uint64_t* bar,
                                    int k0, int n) {
    constexpr int PC = KBox<HD>::PC, CPR = HD / 8;
    if (!boxes()) {
      const int rows = min(NT, n - k0);
#pragma unroll 4
      for (int i = threadIdx.x; i < rows * CPR; i += blockDim.x) {
        const int r = i / CPR, t = i % CPR, key = k0 + r;
        *reinterpret_cast<uint4*>(dst + KBox<HD>::at(r, t)) =
            *reinterpret_cast<const uint4*>(
                kp + row(clamp(tab[key / bs]), key % bs) + t * 8);
      }
      if (threadIdx.x == 0) bar_expect(bar, 0);
      return;
    }
    if (threadIdx.x == 0)
      bar_expect(bar, min(nrb, (n - k0 + g - 1) >> lg) * g * HD * 2);
    if (box < nrb && k0 + box * g < n) {
      const int plane = clamp(cur) * Hkv + hk;
#pragma unroll
      for (int b = 0; b < HD / PC; ++b)
        tma_load(dst + b * NT * PC + box * g * PC, tk, bar, b * PC, cur_r,
                 plane);
    }
  }
  __device__ __forceinline__ void v(__nv_bfloat16* dst, uint64_t* bar,
                                    int k0, int n) {
    if (threadIdx.x == 0) bar_expect(bar, min(NT, n - k0) * HD * 2);
    if (boxes()) {
      const int kb = k0 + box * g;
      if (box < nrb && kb < n)
        bulk_load(dst + box * g * HD, vp + row(clamp(cur), cur_r),
                  min(g, n - kb) * HD * 2, bar);
      cur = nxt;
      cur_r = nxt_r;
      nxt_r = pr;
      nxt = read_entry(k0 / NT + 2, n);
      return;
    }
    for (int j = box; j < nrb; j += blockDim.x) {
      const int kb = k0 + j * g;
      if (kb < n)
        bulk_load(dst + j * g * HD, vp + row(clamp(tab[kb / bs]), kb % bs),
                  min(g, n - kb) * HD * 2, bar);
    }
  }
};

// The rows of one (kv head, slot): q rows at qp, out rows at op, row
// (g, w) at (g * W + w) * HD; the slot's Sk K/V rows come from `src` (a
// DenseSource or a PagedSource).
// Row (g, w) has the key limit kv_len - W + w + 1, clamped to [0, Sk];
// decode is W = 1. Warp `warp` of block z takes row w * G + g = z * nw +
// warp (the rows of one w are consecutive, so a block's limits are a few
// consecutive ones). Needs smem_bytes<HD>(nw) of dynamic shared memory.
//
// The walk is in phases: phase i runs tile i - 1's P.V (V of tile i - 1)
// and tile i's scores (K of tile i) in one stretch of code, so their
// independent fmaf chains interleave; then tile i's softmax. Ring entry
// 2i holds K of tile i, entry 2i + 1 V of tile i; phase i needs entries
// 2i - 1 and 2i, and loads entries up to 2i + NSTAGE - 2 (one phase
// ahead at NSTAGE = 4) into the slots that phase i - 1 has released.
template <int HD, class Source>
__device__ __forceinline__ void attend_warps(
    const __nv_bfloat16* __restrict__ qp, __nv_bfloat16* __restrict__ op,
    Source& src, int G, int W, int kv_len, int Sk, float cap, float scale) {
  constexpr int CPR = HD / 8;      // 16-byte chunks of a K/V row
  constexpr int TILE = NT * HD;    // elements of a ring slot
  constexpr int CW = HD / 32;      // P.V columns a lane owns
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[NSTAGE];   // one per ring slot
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(
      smem + ((1024 - (smem_u32(smem) & 1023)) & 1023));
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  float* sQ = reinterpret_cast<float*>(ring + NSTAGE * TILE)
      + warp * (HD + 2 * NT);
  float* sP = sQ + HD;             // two buffers of NT p

  const int rows = G * W;
  const int row = blockIdx.z * nw + warp;
  const bool active = row < rows;
  const int w = active ? row / G : 0, g = row % G;
  const auto clampk = [Sk](int x) { return x < 0 ? 0 : (x > Sk ? Sk : x); };
  const int lim = active ? clampk(kv_len - W + w + 1) : 0;
  // tiles up to the largest limit of the block's rows (its last row's w)
  const int last = min(rows, (int)(blockIdx.z + 1) * nw) - 1;
  const int n = clampk(kv_len - W + last / G + 1);
  const int ntile = (n + NT - 1) / NT;
  src.start(n);    // (a paged source's first table reads go out here)

  // this warp's q row in fp32
  for (int d = lane; d < HD; d += 32)
    sQ[d] = active ? __bfloat162float(qp[((long long)g * W + w) * HD + d])
                   : 0.f;

  // entry e: K (e even) or V (e odd) of tile e / 2, into ring slot
  // e % NSTAGE, by the source; the slot's barrier completes when the
  // entry's bytes have landed
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NSTAGE; ++i) bar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int issued = 0;
  auto fill = [&](int upto) {
    for (; issued <= upto && issued < 2 * ntile; ++issued) {
      const int e = issued, k0 = (e >> 1) * NT;
      __nv_bfloat16* dst = ring + (e % NSTAGE) * TILE;
      uint64_t* bar = &bars[e % NSTAGE];
      if (e & 1)
        src.v(dst, bar, k0, n);
      else
        src.k(dst, bar, k0, n);
    }
  };
  // wait for entry e (its slot's (e / NSTAGE)-th fill)
  auto landed = [&](int e) {
    bar_wait(&bars[e % NSTAGE], (e / NSTAGE) & 1);
  };

  float m = NEG_INF, l = 0.f, alpha = 1.f, acc[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) acc[c] = 0.f;

  // phase ph: P.V of tile ph - 1 (PV) and the scores of tile ph (SC)
  auto phase = [&](int ph, auto SC, auto PV) {
    constexpr bool sc = decltype(SC)::value, pv = decltype(PV)::value;
    const int k0 = ph * NT;
    float dot[4] = {0.f, 0.f, 0.f, 0.f}, a[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) a[c] = 0.f;
    const __nv_bfloat16* kt = ring + ((2 * ph) % NSTAGE) * TILE;
    const __nv_bfloat16* vt =
        ring + ((2 * ph + NSTAGE - 1) % NSTAGE) * TILE + lane * CW;
    const float* pp = sP + ((ph + 1) & 1) * NT;    // tile ph - 1's p

    // scores: keys k0 + 32c + lane, c = 0..3; chunk t of their K rows and
    // of q (registers kb) loaded one step before its fmafs
    struct KBuf { uint4 k[4]; float4 q[2]; };
    auto kload = [&](int t, KBuf& kb) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kb.k[c] = *reinterpret_cast<const uint4*>(
            kt + KBox<HD>::at(32 * c + lane, t));
      kb.q[0] = *reinterpret_cast<const float4*>(sQ + t * 8);
      kb.q[1] = *reinterpret_cast<const float4*>(sQ + t * 8 + 4);
    };
    auto kfma = [&](const KBuf& kb) {
      const float4 qa = kb.q[0], qb = kb.q[1];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 u = kb.k[c];
        float x = dot[c];
        x = fmaf(qa.x, bf_lo(u.x), x);
        x = fmaf(qa.y, bf_hi(u.x), x);
        x = fmaf(qa.z, bf_lo(u.y), x);
        x = fmaf(qa.w, bf_hi(u.y), x);
        x = fmaf(qb.x, bf_lo(u.z), x);
        x = fmaf(qb.y, bf_hi(u.z), x);
        x = fmaf(qb.z, bf_lo(u.w), x);
        x = fmaf(qb.w, bf_hi(u.w), x);
        dot[c] = x;
      }
    };
    // P.V: a[c] = fmaf(p_j, v_jc, a[c]) for key j of the tile, in slices
    // of 8 keys whose V words and p (registers vb) are loaded one step
    // before their fmafs
    constexpr int VW = CW == 4 ? 2 : 1;       // 32-bit V words a step
    struct VBuf { uint32_t v[8][VW]; float4 p[2]; };
    auto vword = [&](int j, uint32_t* w) {
      const __nv_bfloat16* r = vt + j * HD;
      if constexpr (CW == 4) {
        const uint2 u = *reinterpret_cast<const uint2*>(r);
        w[0] = u.x;
        w[VW - 1] = u.y;
      } else if constexpr (CW == 2) {
        w[0] = *reinterpret_cast<const uint32_t*>(r);
      } else {
        w[0] = *reinterpret_cast<const unsigned short*>(r);
      }
    };
    auto vload = [&](int j0, VBuf& vb) {
#pragma unroll
      for (int i = 0; i < 8; ++i) vword(j0 + i, vb.v[i]);
      vb.p[0] = *reinterpret_cast<const float4*>(pp + j0);
      vb.p[1] = *reinterpret_cast<const float4*>(pp + j0 + 4);
    };
    auto vstep = [&](const uint32_t* w, float pj) {
      float v[CW];
      if constexpr (CW == 4) {
        v[0] = bf_lo(w[0]); v[1] = bf_hi(w[0]);
        v[2] = bf_lo(w[VW - 1]); v[3] = bf_hi(w[VW - 1]);
      } else if constexpr (CW == 2) {
        v[0] = bf_lo(w[0]); v[1] = bf_hi(w[0]);
      } else {
        v[0] = bf_lo(w[0]);
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) a[c] = fmaf(pj, v[c], a[c]);
    };
    auto vfma = [&](const VBuf& vb) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 q4 = vb.p[i / 4];
        vstep(vb.v[i], (i & 3) == 0 ? q4.x : (i & 3) == 1 ? q4.y
                     : (i & 3) == 2 ? q4.z : q4.w);
      }
    };

    if constexpr (sc) {
      // 16 slices: K chunk u / KE (every KE-th slice) and, where a tile
      // ph - 1 is to finish (a scored tile ph >= 1 means it is whole for
      // this row), its keys 8u .. 8u + 7
      constexpr int KE = 16 / CPR;
      KBuf kb[2];
      VBuf vb[2];
      kload(0, kb[0]);
      if constexpr (pv) vload(0, vb[0]);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (u + 1 < 16) {
          if ((u + 1) % KE == 0) kload((u + 1) / KE, kb[((u + 1) / KE) & 1]);
          if constexpr (pv) vload(8 * (u + 1), vb[(u + 1) & 1]);
        }
        if (u % KE == 0) kfma(kb[(u / KE) & 1]);
        if constexpr (pv) vfma(vb[u & 1]);
      }
    } else {
      // the row's last tile: P.V over its min(NT, lim - (k0 - NT)) keys
      const int kn = min(NT, lim - (k0 - NT));
      int j = 0;
      for (; j + 8 <= kn; j += 8) {
        VBuf vb;
        vload(j, vb);
        vfma(vb);
      }
      for (; j < kn; ++j) {
        uint32_t w[VW];
        vword(j, w);
        vstep(w, pp[j]);
      }
    }
    if constexpr (pv) {
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[c] = fmaf(acc[c], alpha, a[c]);
    }
    if constexpr (sc) {
      // branch-free but for cap (uniform), so the warp stays converged
      // for the reductions; keys past the limit score NEG_INF, p = 0
      float* pc = sP + (ph & 1) * NT;
      float s[4], mc = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = __fmul_rn(dot[c], scale);
        if (cap != 0.f) x = __fmul_rn(cap, tanhf(x / cap));
        s[c] = k0 + 32 * c + lane < lim ? x : NEG_INF;
        mc = fmaxf(mc, s[c]);
      }
      const float m_new = fmaxf(m, warp_fmax(mc));
      alpha = expf(m - m_new);
      float p[4], ps;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(s[c] - m_new);
        p[c] = k0 + 32 * c + lane < lim ? e : 0.f;
        pc[32 * c + lane] = p[c];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float gs = warp_sum(p[c]);
        ps = c == 0 ? gs : ps + gs;
      }
      l = fmaf(alpha, l, ps);
      m = m_new;
    }
  };

  fill(NSTAGE - 2);
  for (int ph = 0; ph <= ntile; ++ph) {
    __syncthreads();               // phase ph - 1 is done with its slots
    fill(2 * ph + NSTAGE - 2);     // into the slots phase ph - 1 released
    if (ph > 0) landed(2 * ph - 1);
    if (ph < ntile) landed(2 * ph);
    const int k0 = ph * NT;
    if (ph < ntile && k0 < lim) {  // warp-uniform, as every branch here
      if (ph > 0)
        phase(ph, std::true_type{}, std::true_type{});
      else
        phase(ph, std::true_type{}, std::false_type{});
    } else if (ph > 0 && k0 - NT < lim) {
      phase(ph, std::false_type{}, std::true_type{});
    }
  }

  if (active) {
    __nv_bfloat16* o = op + ((long long)g * W + w) * HD + lane * CW;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < CW; ++c) o[c] = __float2bfloat16_rn(acc[c] / den);
  }
}

// K as a tensor map: `planes` planes of (rows, HD) bf16 at k, viewed as
// (HD, rows, planes), whose box is PC columns of `box_rows` rows of one
// plane, swizzled as KBox says; rows past a plane's end read as zeros.
// A dense cache is B * Hkv planes of Sk rows (boxes of NT rows); a paged
// pool nb * Hkv planes of bs rows (boxes of a row box's g rows).
struct KPlanes {
  const void* k;
  int rows, planes, box_rows;    // box_rows 0: no copy reads K by TMA
};

template <int HD>
inline cudaError_t k_map(CUtensorMap* map, const KPlanes& kl) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)kl.rows,
                              (cuuint64_t)kl.planes};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)kl.rows * HD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)KBox<HD>::PC,
                             (cuuint32_t)kl.box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(kl.k), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, KBox<HD>::SWIZZLE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
      ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch `kernel` (the instance for HD) over (Hkv, B, blocks of a kv
// head's G * W rows, at most block_warps a block, the rows spread evenly
// over the blocks), with K's tensor map (built here, per call) first
// among its arguments. Returns a CUDA error code.
template <int HD, class Kernel, class... Args>
cudaError_t launch(Kernel kernel, const KPlanes& kl, int B, int Hkv, int G,
                   int W, cudaStream_t stream, Args... args) {
  constexpr int MW = block_warps<HD>();
  const int rows = G * W;
  const int blocks = (rows + MW - 1) / MW;
  const int nw = (rows + blocks - 1) / blocks;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<HD>(MW));
  if (err != cudaSuccess || B == 0) return err;
  CUtensorMap tk{};     // an empty cache (no rows) loads nothing
  if (kl.rows > 0 && kl.box_rows > 0) err = k_map<HD>(&tk, kl);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B, blocks);
  kernel<<<grid, nw * 32, smem_bytes<HD>(nw), stream>>>(tk, args...);
  return cudaGetLastError();
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

}  // namespace decode_warp
