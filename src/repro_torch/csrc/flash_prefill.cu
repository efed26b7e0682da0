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
//     TMA writes and the wgmma descriptors name; hd is a template
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

namespace {

using namespace tma;

constexpr int BQ = 64;        // q rows per block: one warpgroup's M
constexpr int BK = 64;        // keys per k tile, tiles from key 0
constexpr int NTH = 128;      // one warpgroup
constexpr int SMEM_MAX = 232448;   // shared memory a block may hold
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The head dim the tiles of head dim HD hold: hd 16 runs the hd-32
// tiles, its columns past 16 zeros.
template <int HD>
__host__ __device__ constexpr int tile_hd() { return HD < 32 ? 32 : HD; }

// Shared memory of tile head dim HD: a tile of R rows is NP panels of R
// rows of SW bytes (PC columns), each panel swizzled over SW bytes; the
// Q tile, then STAGES (K tile, V tile) pairs, 1,024-byte aligned, with
// 1 KB of the block's shared memory left for its barriers.
template <int HD>
struct Layout {
  static_assert(HD % 32 == 0, "panels of 64 or 128 bytes");
  static constexpr int SW = HD == 32 ? 64 : 128;
  static constexpr int PC = SW / 2;
  static constexpr int NP = HD / PC;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int T_BYTES = BK * HD * 2;
  static constexpr int FIT = (SMEM_MAX - 2048 - Q_BYTES) / (2 * T_BYTES);
  static constexpr int STAGES = FIT < 3 ? FIT : 3;   // K/V tiles in flight
  static_assert(STAGES >= 2, "two K/V stages at least");
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * T_BYTES;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte swizzle
  static constexpr uint64_t MODE = SW == 128 ? 1 : 2;
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

// ------------------------------------------------------------ wgmma ----

// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets, layout type (swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// K-major operand (rows x HD, HD contiguous: Q or K) of a tile of R rows
// at `tile`, columns [16 kk, 16 kk + 16): 8-row groups SW * 8 bytes
// apart; a step inside a swizzled panel moves the start by 32 bytes.
template <int HD, int R>
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile,
                                                int kk) {
  using L = Layout<HD>;
  const int col = 16 * kk;
  const uint32_t addr = smem_u32(tile) + (col / L::PC) * R * L::SW
                        + (col % L::PC) * 2;
  return make_desc(addr, 16, 8 * L::SW, L::MODE);
}

// MN-major operand (keys x HD, HD contiguous: V as the B of P V), keys
// [16 kk, 16 kk + 16): 8-key groups SW * 8 bytes apart (stride offset),
// panels of PC columns BK * SW bytes apart (leading offset).
template <int HD>
__device__ __forceinline__ uint64_t desc_v(const uint8_t* tile, int kk) {
  using L = Layout<HD>;
  return make_desc(smem_u32(tile) + 16 * kk * L::SW, BK * L::SW,
                   8 * L::SW, L::MODE);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of a wgmma's registers across
// the fence / wait that order them
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(d) ACC4(d, 0), ACC4(d, 4), ACC4(d, 8), ACC4(d, 12)
#define ACC32(d) ACC16(d), ACC4(d, 16), ACC4(d, 20), ACC4(d, 24), \
    ACC4(d, 28)
#define ACC64(d) ACC32(d), ACC4(d, 32), ACC4(d, 36), ACC4(d, 40),      \
    ACC4(d, 44), ACC4(d, 48), ACC4(d, 52), ACC4(d, 56), ACC4(d, 60)
// registers b .. b + 63 of d (the second half of m64n256's 128)
#define ACC16_AT(d, b) ACC4(d, b), ACC4(d, b + 4), ACC4(d, b + 8),    \
    ACC4(d, b + 12)
#define ACC64_AT(d, b) ACC16_AT(d, b), ACC16_AT(d, b + 16),            \
    ACC16_AT(d, b + 32), ACC16_AT(d, b + 48)

// D (64 x N, fp32): wgmma_ss_n64 sets (scale_d = 0) or adds A (64 x 16,
// shared, K-major) B^T (B 64 x 16, shared, K-major); wgmma_rs_nN adds
// A (64 x 16, four bf16x2 registers a thread) B (16 x N, shared,
// MN-major, imm-trans-b = 1).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ACC64(d), ACC64_AT(d, 64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HD == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (HD == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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
    for (int kk = 0; kk < KS; ++kk) wgmma_pv<TH>(o, pa[kk], desc_v<TH>(sV, kk));
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

// A (hd, rows, heads) bf16 tensor map whose box is one panel of
// `box_rows` rows of one head; out-of-range rows read as zeros, and so
// do the columns past 16 of hd 16's 32-column box.
template <int HD>
bool make_map(PFN_cuTensorMapEncodeTiled_v12000 enc, CUtensorMap* map,
              const void* ptr, int rows, int heads, int box_rows) {
  using L = Layout<tile_hd<HD>()>;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)rows * HD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::PC, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, L::TMA_SWIZZLE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
