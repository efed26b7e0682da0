// Flash prefill attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_prefill` of the JAX package
// (src/repro/kernels/flash_prefill.py). It serves prefill (Sk == Sq,
// q_offset 0) and chunked-prefill / prefix extend (Sk = cache length,
// q_offset = absolute position of q row 0) of the served planner.
//
// What bounds it on an H100: at prefill shapes attention does ~2*Sq*Sk*hd
// operations per head against ~(Sq+2*Sk)*hd*2 bytes, so it is an
// operations-bound kernel and the ceiling is the tensor cores. This first
// version uses fp32 FMAs on the CUDA cores and no tensor cores (wgmma/TMA
// come later), so it runs far below that ceiling; it is written to be
// right first.
//
// Design:
//   * one thread block per (64-row q tile, q head, batch); one thread per
//     q row. The TPU kernel's sequential k grid axis becomes a loop inside
//     the block over 64-key tiles, in order, from key 0 up to the tile's
//     causal bound q_offset + tile_end;
//   * K/V tiles are staged through shared memory (bf16); q row, running
//     max m, sum l and the accumulator stay fp32 in registers;
//   * every row is computed by its own thread with a fixed order of
//     operations that does not depend on the other rows of its tile, and
//     the k-tile partition always starts at key 0. A fully masked tile
//     leaves m, l and acc exactly unchanged (alpha = exp(0) = 1, p = 0).
//     So a row at absolute position p gives the same bits in prefill
//     (Sk = S) and in extend (Sk = cache length, any q_offset), which is
//     what makes chunked prefill and prefix hits match monolithic prefill;
//   * ragged Sq/Sk edges are masked, so any Sq works (the TPU kernel's
//     halve-until-it-divides block rule is not used).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // q rows per block (= threads per block)
constexpr int BK = 64;         // keys per k tile
constexpr int HD = 64;         // head dim this build serves
constexpr float NEG_INF = -1e30f;

__global__ void __launch_bounds__(BQ)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     int Hq, int Hkv, int Sq, int Sk, int q_offset,
                     int causal, int window, float cap, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sK[BK * HD];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * HD];
  __shared__ float sS[BK * BQ];          // scores, [key][row]

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int hk = hq / G;

  const int row = q0 + t;
  const bool active = row < Sq;
  const long long qpos = (long long)q_offset + row;

  const __nv_bfloat16* qp = q + (((long long)b * Hq + hq) * Sq) * HD;
  const __nv_bfloat16* kp = k + (((long long)b * Hkv + hk) * Sk) * HD;
  const __nv_bfloat16* vp = v + (((long long)b * Hkv + hk) * Sk) * HD;

  float qr[HD];
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? __bfloat162float(qp[(long long)row * HD + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // keys this block can see: up to its last row's causal bound
  const int rows_end = min(q0 + BQ, Sq);
  long long kend = Sk;
  if (causal) {
    long long bound = (long long)q_offset + rows_end;
    kend = bound < kend ? bound : kend;
  }
  const int n_tiles = (int)((kend + BK - 1) / BK);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    // stage the K/V tile: 16-byte vectors, zero past Sk
    for (int i = t; i < BK * HD / 8; i += BQ) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk) {
        kv4 = *reinterpret_cast<const uint4*>(kp + (long long)(k0 + r) * HD + c);
        vv4 = *reinterpret_cast<const uint4*>(vp + (long long)(k0 + r) * HD + c);
      }
      *reinterpret_cast<uint4*>(sK + r * HD + c) = kv4;
      *reinterpret_cast<uint4*>(sV + r * HD + c) = vv4;
    }
    __syncthreads();

    if (active) {
      float m_cur = NEG_INF;
      for (int j = 0; j < BK; ++j) {
        const int kpos = k0 + j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && (kpos <= qpos);
        if (window) ok = ok && (qpos - kpos < window);
        float s = NEG_INF;
        if (ok) {
          float dot = 0.f;
          const __nv_bfloat162* kr =
              reinterpret_cast<const __nv_bfloat162*>(sK + j * HD);
#pragma unroll
          for (int d2 = 0; d2 < HD / 2; ++d2) {
            const float2 kf = __bfloat1622float2(kr[d2]);
            dot = fmaf(qr[2 * d2], kf.x, dot);
            dot = fmaf(qr[2 * d2 + 1], kf.y, dot);
          }
          s = dot * scale;
          if (cap != 0.f) s = cap * tanhf(s / cap);
        }
        sS[j * BQ + t] = s;
        m_cur = fmaxf(m_cur, s);
      }
      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
      for (int j = 0; j < BK; ++j) {
        const float s = sS[j * BQ + t];
        const int kpos = k0 + j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && (kpos <= qpos);
        if (window) ok = ok && (qpos - kpos < window);
        const float p = ok ? expf(s - m_new) : 0.f;
        psum += p;
        const __nv_bfloat162* vr =
            reinterpret_cast<const __nv_bfloat162*>(sV + j * HD);
#pragma unroll
        for (int d2 = 0; d2 < HD / 2; ++d2) {
          const float2 vf = __bfloat1622float2(vr[d2]);
          acc[2 * d2] = fmaf(p, vf.x, acc[2 * d2]);
          acc[2 * d2 + 1] = fmaf(p, vf.y, acc[2 * d2 + 1]);
        }
      }
      l = alpha * l + psum;
      m = m_new;
    }
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* op = out + (((long long)b * Hq + hq) * Sq + row) * HD;
#pragma unroll
    for (int d2 = 0; d2 < HD / 2; ++d2) {
      reinterpret_cast<__nv_bfloat162*>(op)[d2] =
          __floats2bfloat162_rn(acc[2 * d2] * inv, acc[2 * d2 + 1] * inv);
    }
  }
}

}  // namespace

// q: (B,Hq,Sq,hd), k/v: (B,Hkv,Sk,hd), out: (B,Hq,Sq,hd); all bf16,
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_prefill_bf16(const void* q, const void* k,
                                  const void* v, void* out, int B, int Hq,
                                  int Hkv, int Sq, int Sk, int hd,
                                  int q_offset, int causal, int window,
                                  float cap, float scale, void* stream) {
  if (hd != HD || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_prefill_kernel<<<grid, BQ, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Hq, Hkv, Sq, Sk,
      q_offset, causal, window, cap, scale);
  return (int)cudaGetLastError();
}
