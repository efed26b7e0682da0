// Flash GQA decode attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_decode` of the JAX package
// (src/repro/kernels/flash_decode.py): one new query token per batch slot
// against its dense KV cache, every slot at its own fill level kv_len[b]
// (continuous-batching decode of the served planner).
//
// What bounds it on an H100: each cache row is read once and used for G
// q heads (~4*G operations per 4 bytes), far below the card's ~295
// operations per byte, so it is bound by the bytes of K and V it must
// read: 2 * kv_len[b] * Hkv * hd * 2 bytes per slot.
//
// Design:
//   * one thread block per (kv head, batch slot) holds all G q rows of
//     that kv head, so each K/V row is read from device memory once and
//     serves the G rows;
//   * the block loops over 128-key tiles only up to kv_len[b]. The TPU
//     kernel reads the whole cache and masks it; tiles past kv_len would
//     change nothing (alpha = 1, p = 0), so stopping early gives the same
//     result while moving only the bytes the slot holds;
//   * K/V tiles are staged through shared memory with coalesced 16-byte
//     loads; K rows are padded to an odd number of 4-byte words so that
//     one thread per key reads its row without bank conflicts;
//   * m, l and acc stay fp32; block reductions use a fixed order, so the
//     result does not vary from run to run;
//   * a slot with kv_len 0 writes 0 (acc / max(l, 1e-30)), not NaN.
//   * no split over the key axis: with few slots the grid is small
//     (B * Hkv blocks). If a split-K version comes, the speculative
//     verify kernel must use the same split so its rows stay bitwise
//     equal to decode rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads per block = keys per tile
constexpr int HD = 64;         // head dim this build serves
constexpr int MAX_G = 8;       // q heads per kv head this build serves
constexpr int KSTRIDE = HD + 2;  // padded K row (33 words: conflict-free)
constexpr int NWARP = NT / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(NT)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc,
                    const int* __restrict__ kv_len,
                    __nv_bfloat16* __restrict__ out,
                    int Hkv, int G, int Sk, float cap, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sK[NT * KSTRIDE];
  __shared__ __align__(16) __nv_bfloat16 sV[NT * HD];
  __shared__ float sQ[MAX_G * HD];
  __shared__ float sP[MAX_G * NT];
  __shared__ float sAcc[MAX_G * HD];
  __shared__ float sRed[MAX_G * NWARP];

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int Hq = Hkv * G;

  int n = kv_len[b];
  n = n < 0 ? 0 : (n > Sk ? Sk : n);

  const __nv_bfloat16* qp = q + ((long long)b * Hq + (long long)hk * G) * HD;
  const __nv_bfloat16* kp = kc + (((long long)b * Hkv + hk) * Sk) * HD;
  const __nv_bfloat16* vp = vc + (((long long)b * Hkv + hk) * Sk) * HD;

  for (int i = t; i < G * HD; i += NT) {
    sQ[i] = __bfloat162float(qp[i]);
    sAcc[i] = 0.f;
  }
  float m[MAX_G], l[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) { m[g] = NEG_INF; l[g] = 0.f; }
  __syncthreads();

  const int n_tiles = (n + NT - 1) / NT;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * NT;
    // stage the tile: V with 16-byte stores, K into the padded layout
    for (int i = t; i < NT * HD / 8; i += NT) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (k0 + r < n) {
        kv4 = *reinterpret_cast<const uint4*>(kp + (long long)(k0 + r) * HD + c);
        vv4 = *reinterpret_cast<const uint4*>(vp + (long long)(k0 + r) * HD + c);
      }
      *reinterpret_cast<uint4*>(sV + r * HD + c) = vv4;
      uint32_t* kdst = reinterpret_cast<uint32_t*>(sK + r * KSTRIDE + c);
      kdst[0] = kv4.x; kdst[1] = kv4.y; kdst[2] = kv4.z; kdst[3] = kv4.w;
    }
    __syncthreads();

    // scores: thread t owns key k0 + t, for every q row of the group
    const bool ok = k0 + t < n;
    float s[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) s[g] = NEG_INF;
    if (ok) {
      const __nv_bfloat162* kr =
          reinterpret_cast<const __nv_bfloat162*>(sK + t * KSTRIDE);
      float dot[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) dot[g] = 0.f;
#pragma unroll 8
      for (int d2 = 0; d2 < HD / 2; ++d2) {
        const float2 kf = __bfloat1622float2(kr[d2]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            dot[g] = fmaf(sQ[g * HD + 2 * d2], kf.x, dot[g]);
            dot[g] = fmaf(sQ[g * HD + 2 * d2 + 1], kf.y, dot[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          float x = dot[g] * scale;
          if (cap != 0.f) x = cap * tanhf(x / cap);
          s[g] = x;
        }
      }
    }

    // tile max per row (exact in any order)
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const float w = warp_max(s[g]);
        if (lane == 0) sRed[g * NWARP + warp] = w;
      }
    }
    __syncthreads();
    float m_new[MAX_G], alpha[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      m_new[g] = m[g];
      alpha[g] = 1.f;
      if (g < G) {
        float mc = sRed[g * NWARP];
#pragma unroll
        for (int w = 1; w < NWARP; ++w) mc = fmaxf(mc, sRed[g * NWARP + w]);
        m_new[g] = fmaxf(m[g], mc);
        alpha[g] = expf(m[g] - m_new[g]);
      }
    }
    __syncthreads();   // every thread has read sRed before it is reused

    // probabilities and their tile sum per row (fixed tree order)
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const float p = ok ? expf(s[g] - m_new[g]) : 0.f;
        sP[g * NT + t] = p;
        const float w = warp_sum(p);
        if (lane == 0) sRed[g * NWARP + warp] = w;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        float ps = sRed[g * NWARP];
#pragma unroll
        for (int w = 1; w < NWARP; ++w) ps += sRed[g * NWARP + w];
        l[g] = alpha[g] * l[g] + ps;
        m[g] = m_new[g];
      }
    }

    // acc[g][d] = alpha * acc + sum_j p[g][j] * V[j][d], keys in order
    const int kn = min(NT, n - k0);
    for (int o = t; o < G * HD; o += NT) {
      const int g = o / HD, d = o % HD;
      float a = 0.f;
      for (int j = 0; j < kn; ++j)
        a = fmaf(sP[g * NT + j], __bfloat162float(sV[j * HD + d]), a);
      float ag = 1.f;
#pragma unroll
      for (int gg = 0; gg < MAX_G; ++gg) if (gg == g) ag = alpha[gg];
      sAcc[o] = sAcc[o] * ag + a;
    }
    __syncthreads();
  }

  __nv_bfloat16* op = out + ((long long)b * Hq + (long long)hk * G) * HD;
  for (int o = t; o < G * HD; o += NT) {
    const int g = o / HD;
    float lg = 0.f;
#pragma unroll
    for (int gg = 0; gg < MAX_G; ++gg) if (gg == g) lg = l[gg];
    op[o] = __float2bfloat16_rn(sAcc[o] / fmaxf(lg, 1e-30f));
  }
}

}  // namespace

// q: (B,Hq,hd), caches: (B,Hkv,Sk,hd) bf16 contiguous; kv_len: (B,) int32
// on the device; out: (B,Hq,hd) bf16. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int flash_decode_bf16(const void* q, const void* k_cache,
                                 const void* v_cache, const void* kv_len,
                                 void* out, int B, int Hq, int Hkv, int Sk,
                                 int hd, float cap, float scale,
                                 void* stream) {
  if (hd != HD || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAX_G)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  dim3 grid(Hkv, B);
  flash_decode_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
      (const __nv_bfloat16*)v_cache, (const int*)kv_len,
      (__nv_bfloat16*)out, Hkv, Hq / Hkv, Sk, cap, scale);
  return (int)cudaGetLastError();
}
