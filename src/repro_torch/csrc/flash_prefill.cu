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
//   * one thread block per (64-row q tile, q head, batch); each q row is
//     owned by P threads (P = 1 at head dims 32 and 64, P = 2 at 128),
//     each holding HD/P of its dims. The TPU kernel's sequential k grid
//     axis becomes a loop inside the block over 64-key tiles, in order,
//     from key 0 up to the tile's causal bound q_offset + tile_end;
//   * K/V tiles are staged through dynamic shared memory (bf16); each
//     thread's slice of the q row and of the accumulator stays fp32 in
//     registers (HD/P <= 64 values each, so HD = 128 does not spill), the
//     running max m and sum l too;
//   * every row is computed by its own threads with a fixed order of
//     operations that does not depend on the other rows of its tile, and
//     the k-tile partition always starts at key 0. With P = 2 a score is
//     the sum of the two halves' dot products (the lower half's first,
//     exchanged by one warp shuffle), the same in both threads. A fully
//     masked tile leaves m, l and acc exactly unchanged (alpha = exp(0) =
//     1, p = 0). So a row at absolute position p gives the same bits in
//     prefill (Sk = S) and in extend (Sk = cache length, any q_offset),
//     which is what makes chunked prefill and prefix hits match monolithic
//     prefill;
//   * the head dim HD is a template parameter, instantiated for 32, 64
//     and 128; at 32 and 64 (P = 1) the operations per row are those of
//     the first, head-dim-64-only version of this kernel;
//   * ragged Sq/Sk edges are masked, so any Sq works (the TPU kernel's
//     halve-until-it-divides block rule is not used).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // keys per k tile
constexpr float NEG_INF = -1e30f;

// threads per q row at head dim HD
template <int HD>
__host__ __device__ constexpr int parts() { return HD > 64 ? HD / 64 : 1; }

template <int HD>
__global__ void __launch_bounds__(BQ * parts<HD>())
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     int Hq, int Hkv, int Sq, int Sk, int q_offset,
                     int causal, int window, float cap, float scale) {
  constexpr int P = parts<HD>();
  constexpr int DH = HD / P;             // dims per thread
  constexpr int NTH = BQ * P;            // threads per block
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* sK = smem;              // [BK][HD]
  __nv_bfloat16* sV = smem + BK * HD;    // [BK][HD]
  __shared__ float sS[BK * BQ];          // scores, [key][row]

  const int t = threadIdx.x;
  const int lr = t / P;                  // row within the tile
  const int part = t % P;                // which HD/P dims
  const int d0 = part * DH;
  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int hk = hq / G;

  const int row = q0 + lr;
  const bool active = row < Sq;
  // the lanes of this row (P = 2: an aligned pair; rows of one warp may
  // take different branches, so row-level syncs name only the pair)
  const unsigned row_lanes = P == 1 ? 1u << (t & 31)
                                    : 3u << ((t & 31) & ~1);
  const long long qpos = (long long)q_offset + row;

  const __nv_bfloat16* qp = q + (((long long)b * Hq + hq) * Sq) * HD;
  const __nv_bfloat16* kp = k + (((long long)b * Hkv + hk) * Sk) * HD;
  const __nv_bfloat16* vp = v + (((long long)b * Hkv + hk) * Sk) * HD;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? __bfloat162float(qp[(long long)row * HD + d0 + d])
                   : 0.f;
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
    for (int i = t; i < BK * HD / 8; i += NTH) {
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

    // a row's threads share its active flag and every mask below
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
              reinterpret_cast<const __nv_bfloat162*>(sK + j * HD + d0);
#pragma unroll
          for (int d2 = 0; d2 < DH / 2; ++d2) {
            const float2 kf = __bfloat1622float2(kr[d2]);
            dot = fmaf(qr[2 * d2], kf.x, dot);
            dot = fmaf(qr[2 * d2 + 1], kf.y, dot);
          }
          if constexpr (P == 2) {
            const float other = __shfl_xor_sync(row_lanes, dot, 1);
            dot = part == 0 ? dot + other : other + dot;
          }
          s = dot * scale;
          if (cap != 0.f) s = cap * tanhf(s / cap);
        }
        if (part == 0) sS[j * BQ + lr] = s;
        m_cur = fmaxf(m_cur, s);
      }
      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
      if constexpr (P > 1) __syncwarp(row_lanes);   // row's scores in sS
      for (int j = 0; j < BK; ++j) {
        const float s = sS[j * BQ + lr];
        const int kpos = k0 + j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && (kpos <= qpos);
        if (window) ok = ok && (qpos - kpos < window);
        const float p = ok ? expf(s - m_new) : 0.f;
        psum += p;
        const __nv_bfloat162* vr =
            reinterpret_cast<const __nv_bfloat162*>(sV + j * HD + d0);
#pragma unroll
        for (int d2 = 0; d2 < DH / 2; ++d2) {
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
    __nv_bfloat16* op =
        out + (((long long)b * Hq + hq) * Sq + row) * HD + d0;
#pragma unroll
    for (int d2 = 0; d2 < DH / 2; ++d2) {
      reinterpret_cast<__nv_bfloat162*>(op)[d2] =
          __floats2bfloat162_rn(acc[2 * d2] * inv, acc[2 * d2 + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Hq, int Hkv, int Sq, int Sk, int q_offset,
                   int causal, int window, float cap, float scale,
                   cudaStream_t stream) {
  const int smem = 2 * BK * HD * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_prefill_kernel<HD><<<grid, BQ * parts<HD>(), smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Hq, Hkv, Sq, Sk,
      q_offset, causal, window, cap, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B,Hq,Sq,hd), k/v: (B,Hkv,Sk,hd), out: (B,Hq,Sq,hd); all bf16,
// contiguous; hd in {32, 64, 128}. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int flash_prefill_bf16(const void* q, const void* k,
                                  const void* v, void* out, int B, int Hq,
                                  int Hkv, int Sq, int Sk, int hd,
                                  int q_offset, int causal, int window,
                                  float cap, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (hd != 32 && hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 32)
    return (int)launch<32>(q, k, v, out, B, Hq, Hkv, Sq, Sk, q_offset,
                           causal, window, cap, scale, st);
  if (hd == 64)
    return (int)launch<64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, q_offset,
                           causal, window, cap, scale, st);
  return (int)launch<128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, q_offset,
                          causal, window, cap, scale, st);
}
