// The backward of flash prefill attention for Hopper (sm_90a), CUDA C++.
//
// Replaces no TPU kernel: the JAX package trains under its reference
// backend (plain jnp attention, differentiated by jax.grad) and has no
// backward kernel. The port has no backend switch, so on the card a
// train-mode layer's attention runs `flash_prefill` (csrc/flash_prefill.cu)
// and its gradient must come from a kernel too
// (kernels/flash_prefill.py:FlashPrefillFn). It computes dQ, dK and dV of
// what the forward computes: GQA (q head h reads kv head h / G), causal,
// sliding `window`, logit softcap `cap` (x = cap tanh(s / cap)) and
// `scale`, q_offset 0, at head dims 32, 64 and 128, from q, k, v, the
// forward's output O and dO, all bf16; outputs bf16, every sum in fp32.
//
// What bounds it on an H100: the function needs five hd-long products
// a visible (q row, key) pair and q head (s = q.k, dP = dO.v, dV += p dO,
// dK += dS q, dQ += dS k), 10 hd operations, against reading q, k, v, O,
// dO and writing dq, dk, dv once, ~2 hd (4 Hq Sq + 4 Hkv Sk) bytes. At
// the planner's training shape (B 8 x S 256, 12/4 heads of 64, causal)
// that is 2.0 G operations against 16.8 MB: bytes bound, 5.0 us
// (2.0 us on the bf16 tensor cores). This first kernel does seven such
// products (the dQ pass recomputes s and dP) in fp32 on the CUDA cores
// (67 TFLOP/s), so ~42 us is its own floor; tensor cores and TMA are
// later work.
//
// Design (simple first): three passes, launched in order on one stream
// by one C entry point.
//   * rows: one block per (64-row q tile, q head, batch) recomputes each
//     row's log-sum-exp L = m + log(sum exp(x - m)) over its visible keys
//     from q and k (online over 64-key tiles, per thread then over the 16
//     threads of the row in a fixed shuffle order), and D = rowsum(dO * O)
//     from the forward's bf16 O, both fp32, into scratch the wrapper
//     allocates;
//   * dK/dV: one block per (64-key tile, kv head, batch) keeps the tile's
//     K, V and its dK, dV sums; it loops over the G q heads of the group
//     and, for each, over the 64-row q tiles that can see the tile (the
//     causal edge and the window's far edge as the forward masks them).
//     It recomputes p = exp(x - L) (exactly 0 where masked), dP = dO.v
//     and dS = p (dP - D) dx/ds, with dx/ds = scale (1 - tanh^2) under a
//     cap and scale without, then adds dV += p^T dO and dK += dS^T Q;
//   * dQ: one block per (64-row q tile, q head, batch) loops over the key
//     tiles its rows see and adds dQ += dS K.
// Tiles live in shared memory as fp32, rows padded to hd + 1 words so
// the 16 threads of a half-warp read 16 rows in 16 banks. 256 threads a
// block; a thread owns 4 x 4 entries of a 64 x 64 score tile (rows
// 4 ty + a, keys tx + 16 c) and 4 rows x hd/16 columns of a 64 x hd sum.
// No atomics and every sum in a fixed order: two calls give the same
// bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;        // rows of a q tile, keys of a k tile
constexpr int NTH = 256;      // threads a block: a 16 x 16 grid

template <int HD>
struct Layout {
  static constexpr int LD = HD + 1;            // padded row, in floats
  static constexpr int TILE = BT * LD;         // one 64 x hd tile
  static constexpr int SQ = BT + 1;            // padded 64 x 64 tile row
  // rows and dQ passes: Q, dO (dQ only), K, V (dQ only); dS; L, D
  // dK/dV pass: K, V, Q, dO; P, dS; L, D
  static constexpr int SMEM = (4 * TILE + 2 * BT * SQ + 2 * BT) * 4;
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* lse;
  float* dsum;
  int Hq, Hkv, Sq, Sk, causal, window;
  float cap, scale;
};

__device__ __forceinline__ bool visible(const Params& p, int pos, int key) {
  bool ok = key < p.Sk;
  if (p.causal) ok = ok && key <= pos;
  if (p.window) ok = ok && pos - key < p.window;
  return ok;
}

// rows [r0, r0 + 64) of a (rows, hd) bf16 matrix into a padded fp32 tile;
// rows past `rows` read as zeros
template <int HD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const __nv_bfloat16* src,
                                          int r0, int rows) {
  using L = Layout<HD>;
  for (int i = threadIdx.x; i < BT * HD; i += NTH) {
    const int r = i / HD, d = i % HD;
    dst[r * L::LD + d] = r0 + r < rows
        ? __bfloat162float(src[(long long)(r0 + r) * HD + d]) : 0.f;
  }
}

// acc[a][c] = sum_d A[4 ty + a][d] * B[tx + 16 c][d], d in order
template <int HD>
__device__ __forceinline__ void dot_tile(float acc[4][4], const float* sA,
                                         const float* sB, int ty, int tx) {
  using L = Layout<HD>;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = sA[(4 * ty + a) * L::LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = sB[(tx + 16 * c) * L::LD + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
  }
}

// the logit x of a raw dot q.k and dx/d(dot)
__device__ __forceinline__ float logit(const Params& p, float dot,
                                       float* dxds) {
  if (p.cap != 0.f) {
    const float t = tanhf(dot * p.scale / p.cap);
    *dxds = p.scale * (1.f - t * t);
    return p.cap * t;
  }
  *dxds = p.scale;
  return dot * p.scale;
}

// p and dS of the 64 x 64 tile (q rows q0.., keys k0..) into sP / sdS
// (sP may be null): the thread's 4 x 4 entries. Needs sQ, sdO, sK, sV,
// sL, sD in place.
template <int HD>
__device__ __forceinline__ void ds_tile(const Params& p, const float* sQ,
                                        const float* sdO, const float* sK,
                                        const float* sV, const float* sL,
                                        const float* sD, float* sP,
                                        float* sdS, int q0, int k0, int ty,
                                        int tx) {
  using L = Layout<HD>;
  float s[4][4], dp[4][4];
  dot_tile<HD>(s, sQ, sK, ty, tx);
  dot_tile<HD>(dp, sdO, sV, ty, tx);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * ty + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      float dxds;
      const float x = logit(p, s[a][c], &dxds);
      const bool ok = q0 + r < p.Sq && visible(p, q0 + r, k0 + j);
      const float pr = ok ? expf(x - sL[r]) : 0.f;
      if (sP != nullptr) sP[r * L::SQ + j] = pr;
      sdS[r * L::SQ + j] = pr * (dp[a][c] - sD[r]) * dxds;
    }
  }
}

// k tiles [t0, t1) that rows [q0, q0 + 64) see
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int* t0,
                                          int* t1) {
  int kend = p.Sk;
  if (p.causal) kend = min(kend, min(q0 + BT, p.Sq));
  const int kbeg = p.window ? max(0, q0 - p.window + 1) : 0;
  *t0 = kbeg / BT;
  *t1 = max(*t0, (kend + BT - 1) / BT);
}

// ------------------------------------------------------------- rows ----

template <int HD>
__global__ void __launch_bounds__(NTH)
bwd_rows_kernel(const Params p) {
  using L = Layout<HD>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + L::TILE;
  const int q0 = blockIdx.x * BT, hq = blockIdx.y, b = blockIdx.z;
  const int kvh = b * p.Hkv + hq / (p.Hq / p.Hkv);
  const long long qbase = (long long)(b * p.Hq + hq) * p.Sq;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  // D = rowsum(dO * O) in fp32, d in order: thread r < 64 takes row r
  if (tid < BT && q0 + tid < p.Sq) {
    const __nv_bfloat16* od = p.o + (qbase + q0 + tid) * HD;
    const __nv_bfloat16* dd = p.dout + (qbase + q0 + tid) * HD;
    float acc = 0.f;
    for (int d = 0; d < HD; ++d)
      acc = fmaf(__bfloat162float(dd[d]), __bfloat162float(od[d]), acc);
    p.dsum[qbase + q0 + tid] = acc;
  }
  load_tile<HD>(sQ, p.q + qbase * HD, q0, p.Sq);
  int t0, t1;
  key_tiles(p, q0, &t0, &t1);
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  for (int t = t0; t < t1; ++t) {
    __syncthreads();
    load_tile<HD>(sK, p.k + (long long)kvh * p.Sk * HD, t * BT, p.Sk);
    __syncthreads();
    float s[4][4];
    dot_tile<HD>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int pos = q0 + 4 * ty + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!visible(p, pos, t * BT + tx + 16 * c)) continue;
        float dxds;
        const float x = logit(p, s[a][c], &dxds);
        if (x > m[a]) {
          l[a] = l[a] * expf(m[a] - x) + 1.f;
          m[a] = x;
        } else {
          l[a] += expf(x - m[a]);
        }
      }
    }
  }
  // the row's 16 threads (one half-warp), xor 1, 2, 4, 8
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int off = 1; off < 16; off *= 2) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[a], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[a], off);
      const float mn = fmaxf(m[a], mo);
      if (mn == -INFINITY) continue;
      l[a] = l[a] * expf(m[a] - mn) + lo * expf(mo - mn);
      m[a] = mn;
    }
    const int r = q0 + 4 * ty + a;
    if (tx == 0 && r < p.Sq)
      p.lse[qbase + r] = l[a] > 0.f ? m[a] + logf(l[a]) : INFINITY;
  }
}

// ------------------------------------------------------------ dK, dV ----

template <int HD>
__global__ void __launch_bounds__(NTH)
bwd_dkdv_kernel(const Params p) {
  using L = Layout<HD>;
  constexpr int NC = HD / 16;          // columns a thread owns
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + L::TILE;
  float* sQ = sV + L::TILE;
  float* sdO = sQ + L::TILE;
  float* sP = sdO + L::TILE;
  float* sdS = sP + BT * L::SQ;
  float* sL = sdS + BT * L::SQ;
  float* sD = sL + BT;
  const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const long long kbase = (long long)(b * p.Hkv + kvh) * p.Sk;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<HD>(sK, p.k + kbase * HD, k0, p.Sk);
  load_tile<HD>(sV, p.v + kbase * HD, k0, p.Sk);
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[a][c] = dv[a][c] = 0.f;

  // q rows that see a key of [k0, k0 + 64)
  const int qbeg = p.causal ? k0 : 0;
  const int qend = p.window ? min(p.Sq, k0 + BT - 1 + p.window) : p.Sq;
  for (int g = 0; g < G; ++g) {
    const int hq = kvh * G + g;
    const long long qbase = (long long)(b * p.Hq + hq) * p.Sq;
    for (int q0 = (qbeg / BT) * BT; q0 < qend; q0 += BT) {
      __syncthreads();
      load_tile<HD>(sQ, p.q + qbase * HD, q0, p.Sq);
      load_tile<HD>(sdO, p.dout + qbase * HD, q0, p.Sq);
      if (tid < BT) {
        const bool in = q0 + tid < p.Sq;
        sL[tid] = in ? p.lse[qbase + q0 + tid] : INFINITY;
        sD[tid] = in ? p.dsum[qbase + q0 + tid] : 0.f;
      }
      __syncthreads();
      ds_tile<HD>(p, sQ, sdO, sK, sV, sL, sD, sP, sdS, q0, k0, ty, tx);
      __syncthreads();
      // dV[key][d] += sum_r P[r][key] dO[r][d]; dK likewise with dS, Q;
      // keys 4 ty + a, columns tx + 16 c, r in order
      for (int r = 0; r < BT; ++r) {
        float pr[4], sr[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pr[a] = sP[r * L::SQ + 4 * ty + a];
          sr[a] = sdS[r * L::SQ + 4 * ty + a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float od = sdO[r * L::LD + tx + 16 * c];
          const float qd = sQ[r * L::LD + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            dv[a][c] = fmaf(pr[a], od, dv[a][c]);
            dk[a][c] = fmaf(sr[a], qd, dk[a][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + 4 * ty + a;
    if (j >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      p.dk[(kbase + j) * HD + tx + 16 * c] = __float2bfloat16_rn(dk[a][c]);
      p.dv[(kbase + j) * HD + tx + 16 * c] = __float2bfloat16_rn(dv[a][c]);
    }
  }
}

// ---------------------------------------------------------------- dQ ----

template <int HD>
__global__ void __launch_bounds__(NTH)
bwd_dq_kernel(const Params p) {
  using L = Layout<HD>;
  constexpr int NC = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + L::TILE;
  float* sK = sdO + L::TILE;
  float* sV = sK + L::TILE;
  float* sdS = sV + L::TILE;
  float* sL = sdS + 2 * BT * L::SQ;
  float* sD = sL + BT;
  const int q0 = blockIdx.x * BT, hq = blockIdx.y, b = blockIdx.z;
  const int kvh = b * p.Hkv + hq / (p.Hq / p.Hkv);
  const long long qbase = (long long)(b * p.Hq + hq) * p.Sq;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<HD>(sQ, p.q + qbase * HD, q0, p.Sq);
  load_tile<HD>(sdO, p.dout + qbase * HD, q0, p.Sq);
  if (tid < BT) {
    const bool in = q0 + tid < p.Sq;
    sL[tid] = in ? p.lse[qbase + q0 + tid] : INFINITY;
    sD[tid] = in ? p.dsum[qbase + q0 + tid] : 0.f;
  }
  float dq[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[a][c] = 0.f;
  int t0, t1;
  key_tiles(p, q0, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    __syncthreads();
    load_tile<HD>(sK, p.k + (long long)kvh * p.Sk * HD, t * BT, p.Sk);
    load_tile<HD>(sV, p.v + (long long)kvh * p.Sk * HD, t * BT, p.Sk);
    __syncthreads();
    ds_tile<HD>(p, sQ, sdO, sK, sV, sL, sD, nullptr, sdS, q0, t * BT, ty,
                tx);
    __syncthreads();
    // dQ[r][d] += sum_key dS[r][key] K[key][d]: rows 4 ty + a, columns
    // tx + 16 c, keys in order
    for (int j = 0; j < BT; ++j) {
      float sr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sr[a] = sdS[(4 * ty + a) * L::SQ + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kd = sK[j * L::LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) dq[a][c] = fmaf(sr[a], kd, dq[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + 4 * ty + a;
    if (r >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      p.dq[(qbase + r) * HD + tx + 16 * c] = __float2bfloat16_rn(dq[a][c]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using L = Layout<HD>;
  static const cudaError_t attr = [] {
    cudaError_t e = allow_smem(bwd_rows_kernel<HD>, L::SMEM);
    if (e == cudaSuccess) e = allow_smem(bwd_dkdv_kernel<HD>, L::SMEM);
    if (e == cudaSuccess) e = allow_smem(bwd_dq_kernel<HD>, L::SMEM);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 qgrid((p.Sq + BT - 1) / BT, p.Hq, B);
  const dim3 kgrid((p.Sk + BT - 1) / BT, p.Hkv, B);
  bwd_rows_kernel<HD><<<qgrid, NTH, L::SMEM, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv_kernel<HD><<<kgrid, NTH, L::SMEM, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dq_kernel<HD><<<qgrid, NTH, L::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B,Hq,Sq,hd); k, v, dk, dv: (B,Hkv,Sk,hd); all bf16,
// contiguous. lse, dsum: (B,Hq,Sq) fp32 scratch. q_offset is 0 (the
// wrapper refuses any other); hd in {32, 64, 128}. Launches the three
// passes on `stream` and returns the first launch error, else
// cudaSuccess.
extern "C" int flash_prefill_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum,
    int B, int Hq, int Hkv, int Sq, int Sk, int hd, int causal, int window,
    float cap, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (hd != 32 && hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Sk == 0) return (int)cudaSuccess;
  Params p{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
           (const __nv_bfloat16*)v, (const __nv_bfloat16*)o,
           (const __nv_bfloat16*)dout, (__nv_bfloat16*)dq,
           (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (float*)lse,
           (float*)dsum, Hq, Hkv, Sq, Sk, causal, window, cap, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 32) return (int)launch<32>(p, B, st);
  if (hd == 64) return (int)launch<64>(p, B, st);
  return (int)launch<128>(p, B, st);
}
