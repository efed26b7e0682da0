// The backward of flash prefill attention for Hopper (sm_90a), CUDA C++.
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
// that is 2.0 G operations against 14.2 MB: bytes bound, 4.2 us
// (2.0 us on the bf16 tensor cores). This first kernel does nine such
// products (the rows pass computes s and dP, the dQ pass recomputes
// both) in fp32 on the CUDA cores (67 TFLOP/s), so ~54 us is its own
// floor; tensor cores and TMA are later work.
//
// Design (simple first): three passes, launched in order on one stream
// by one C entry point.
//   * rows: one block per (64-row q tile, q head, batch) recomputes each
//     row's log-sum-exp L = m + log(sum exp(x - m)) over its visible keys
//     from q and k, and D = sum_j p_j dP_j (dP = dO.v) from dO and v,
//     both online over 64-key tiles (per thread, then over the 16
//     threads of the row in a fixed shuffle order), fp32, into scratch
//     the wrapper allocates. D is rowsum(dO * O) of the exact output;
//     taken from the forward's output instead, rounded to bf16 after a
//     P V in bf16, a row's dS would not sum to 0 and dQ, dK would gain a
//     part along the row's mean key (5% of whisper-smoke's decoder wq
//     gradient against the plain version). So the forward's output is
//     not an input;
//   * dK/dV: one block per (64-key tile, kv head, batch) keeps the tile's
//     K, V and its dK, dV sums; it loops over the G q heads of the group
//     and, for each, over the 64-row q tiles that can see the tile (the
//     causal edge and the window's far edge as the forward masks them;
//     every q tile when not causal). It recomputes p = exp(x - L)
//     (exactly 0 where masked, and on rows past Sq), dP = dO.v and
//     dS = p (dP - D) dx/ds, with dx/ds = scale (1 - tanh^2) under a
//     cap and scale without, then adds dV += p^T dO and dK += dS^T Q;
//   * dQ: one block per (64-row q tile, q head, batch) loops over the key
//     tiles its rows see (all Sk keys when not causal) and adds
//     dQ += dS K.
// Tiles live in shared memory, rows padded so that the 16 threads of a
// half-warp read 16 rows in 16 banks. 256 threads a block; a thread owns
// 4 x 4 entries of a 64 x 64 score tile (rows 4 ty + a, keys tx + 16 c)
// and 4 rows x hd/16 columns of a 64 x hd sum (one column at hd 16).
// The q, k, v and dO tiles are only read, and hold bf16 values: up to hd
// 128 they are staged as fp32 (rows of hd + 1 words); at hd 256 fp32
// tiles would need (4 64 257 + 2 64 65 + 2 64) 4 = 296,960 B, past a
// block's 232,448 B, so there they are staged as the bf16 they are (rows
// of hd + 2 = 258 values, 129 words: an odd stride, so 16 rows of one
// column still fall in 16 banks) and widened to fp32 as they are read:
// 4 64 258 2 + (2 64 65 + 2 64) 4 = 165,888 B, one block an SM. The
// widening is exact, so the arithmetic is that of the fp32 tiles (bf16
// tiles at every head dim give the same bits, but were 6-17% slower at
// hd 32-128 on an H100: a convert a shared read). P and
// dS stay fp32. No atomics and every sum in a fixed order: two calls
// give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BT = 64;        // rows of a q tile, keys of a k tile
constexpr int NTH = 256;      // threads a block: a 16 x 16 grid

template <int HD>
struct Layout {
  // element of the q, k, v and dO tiles (see the design note)
  using T = typename std::conditional<(HD > 128), __nv_bfloat16,
                                      float>::type;
  static constexpr int LD = sizeof(T) == 4 ? HD + 1 : HD + 2;  // padded row
  static constexpr int TILE = BT * LD;         // one 64 x hd tile
  static constexpr int SQ = BT + 1;            // padded 64 x 64 tile row
  // rows and dQ passes: Q, dO, K, V; then in fp32 dS (dQ only); L, D
  // (dQ only). dK/dV pass: K, V, Q, dO; then P, dS; L, D
  static constexpr int TILES_BYTES = 4 * TILE * (int)sizeof(T);
  static constexpr int SMEM = TILES_BYTES + (2 * BT * SQ + 2 * BT) * 4;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* d, __nv_bfloat16 x) {
  *d = __bfloat162float(x);
}
__device__ __forceinline__ void put(__nv_bfloat16* d, __nv_bfloat16 x) {
  *d = x;
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
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

// rows [r0, r0 + 64) of a (rows, hd) bf16 matrix into a padded tile;
// rows past `rows` read as zeros
template <int HD>
__device__ __forceinline__ void load_tile(typename Layout<HD>::T* dst,
                                          const __nv_bfloat16* src,
                                          int r0, int rows) {
  using L = Layout<HD>;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < BT * HD; i += NTH) {
    const int r = i / HD, d = i % HD;
    put(&dst[r * L::LD + d],
        r0 + r < rows ? src[(long long)(r0 + r) * HD + d] : zero);
  }
}

// acc[a][c] = sum_d A[4 ty + a][d] * B[tx + 16 c][d], d in order
template <int HD>
__device__ __forceinline__ void dot_tile(float acc[4][4],
                                         const typename Layout<HD>::T* sA,
                                         const typename Layout<HD>::T* sB,
                                         int ty, int tx) {
  using L = Layout<HD>;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = f32(sA[(4 * ty + a) * L::LD + d]);
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = f32(sB[(tx + 16 * c) * L::LD + d]);
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
__device__ __forceinline__ void ds_tile(const Params& p,
                                        const typename Layout<HD>::T* sQ,
                                        const typename Layout<HD>::T* sdO,
                                        const typename Layout<HD>::T* sK,
                                        const typename Layout<HD>::T* sV,
                                        const float* sL,
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
  using T = typename L::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + L::TILE;
  T* sK = sdO + L::TILE;
  T* sV = sK + L::TILE;
  const int q0 = blockIdx.x * BT, hq = blockIdx.y, b = blockIdx.z;
  const int kvh = b * p.Hkv + hq / (p.Hq / p.Hkv);
  const long long qbase = (long long)(b * p.Hq + hq) * p.Sq;
  const long long kvbase = (long long)kvh * p.Sk * HD;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<HD>(sQ, p.q + qbase * HD, q0, p.Sq);
  load_tile<HD>(sdO, p.dout + qbase * HD, q0, p.Sq);
  int t0, t1;
  key_tiles(p, q0, &t0, &t1);
  // a row's running max m, l = sum exp(x - m), e = sum exp(x - m) dP
  float m[4], l[4], e[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = e[a] = 0.f;
  }
  for (int t = t0; t < t1; ++t) {
    __syncthreads();
    load_tile<HD>(sK, p.k + kvbase, t * BT, p.Sk);
    load_tile<HD>(sV, p.v + kvbase, t * BT, p.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<HD>(s, sQ, sK, ty, tx);
    dot_tile<HD>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int pos = q0 + 4 * ty + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!visible(p, pos, t * BT + tx + 16 * c)) continue;
        float dxds;
        const float x = logit(p, s[a][c], &dxds);
        if (x > m[a]) {
          const float r = expf(m[a] - x);
          l[a] = l[a] * r + 1.f;
          e[a] = e[a] * r + dp[a][c];
          m[a] = x;
        } else {
          const float w = expf(x - m[a]);
          l[a] += w;
          e[a] = fmaf(w, dp[a][c], e[a]);
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
      const float eo = __shfl_xor_sync(0xffffffffu, e[a], off);
      const float mn = fmaxf(m[a], mo);
      if (mn == -INFINITY) continue;
      const float ra = expf(m[a] - mn), rb = expf(mo - mn);
      l[a] = l[a] * ra + lo * rb;
      e[a] = e[a] * ra + eo * rb;
      m[a] = mn;
    }
    const int r = q0 + 4 * ty + a;
    if (tx == 0 && r < p.Sq) {
      p.lse[qbase + r] = l[a] > 0.f ? m[a] + logf(l[a]) : INFINITY;
      p.dsum[qbase + r] = l[a] > 0.f ? e[a] / l[a] : 0.f;
    }
  }
}

// ------------------------------------------------------------ dK, dV ----

template <int HD>
__global__ void __launch_bounds__(NTH)
bwd_dkdv_kernel(const Params p) {
  using L = Layout<HD>;
  using T = typename L::T;
  constexpr int NC = HD / 16;          // columns a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + L::TILE;
  T* sQ = sV + L::TILE;
  T* sdO = sQ + L::TILE;
  float* sP = reinterpret_cast<float*>(smem + L::TILES_BYTES);
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
          const float od = f32(sdO[r * L::LD + tx + 16 * c]);
          const float qd = f32(sQ[r * L::LD + tx + 16 * c]);
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
  using T = typename L::T;
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + L::TILE;
  T* sK = sdO + L::TILE;
  T* sV = sK + L::TILE;
  float* sdS = reinterpret_cast<float*>(smem + L::TILES_BYTES);
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
        const float kd = f32(sK[j * L::LD + tx + 16 * c]);
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

// q, dout, dq: (B,Hq,Sq,hd); k, v, dk, dv: (B,Hkv,Sk,hd); all bf16,
// contiguous. lse, dsum: (B,Hq,Sq) fp32 scratch. q_offset is 0 (the
// wrapper refuses any other); causal or not, Sq and Sk any (causal rows
// see keys 0..row); hd in {16, 32, 64, 128, 256}, the forward's head
// dims. Launches the three passes on `stream` and returns the first
// launch error, else cudaSuccess.
extern "C" int flash_prefill_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* dk, void* dv, void* lse, void* dsum,
    int B, int Hq, int Hkv, int Sq, int Sk, int hd, int causal, int window,
    float cap, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Sk == 0) return (int)cudaSuccess;
  Params p{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
           (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
           (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
           (float*)lse, (float*)dsum, Hq, Hkv, Sq, Sk, causal, window, cap,
           scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 16) return (int)launch<16>(p, B, st);
  if (hd == 32) return (int)launch<32>(p, B, st);
  if (hd == 64) return (int)launch<64>(p, B, st);
  if (hd == 128) return (int)launch<128>(p, B, st);
  return (int)launch<256>(p, B, st);
}
