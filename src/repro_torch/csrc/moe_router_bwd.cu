// The backward of the fused MoE router (softmax + top-k) for Hopper
// (sm_90a), plain CUDA C++.
//
// Replaces no TPU kernel: the JAX package trains under its reference
// backend (jax.lax.top_k of the softmax, differentiated by jax.grad) and
// has no backward kernel for `moe_router_topk`
// (src/repro/kernels/moe_router.py). The port has no backend switch, so
// on the card a training MoE layer routes through `moe_router_topk`
// (csrc/moe_router.cu) and the routing weights' gradient must come from
// a kernel too (kernels/moe_router.py:MoeRouterFn). The forward's weights
// are the chosen probabilities renormalised by their sum, w_j =
// exp(l_j) / sum_{i chosen} exp(l_i): a softmax over the chosen logits
// alone, so for a token with weights w (k), ids idx (k) and cotangent dw
//   dlogit[idx_j] = w_j (dw_j - s),  s = sum_j w_j dw_j,
// and every expert that was not chosen gets 0. (The 1e-9 clamp of the
// sum never binds: the sum is at least the largest probability, >= 1/E.)
//
// What bounds it on an H100: it reads w, idx and dw (12 k bytes a token)
// and writes the full (T, E) row of dlogits, zeros included (4 E bytes a
// token), with ~3 k operations a token: bound by bytes, by the writes.
// At the cut arctic training path (T = 1,024, E = 16, k = 2) that is
// 90 KB, ~27 ns at 3.35 TB/s, so one launch's fixed cost is the whole
// time.
//
// Design: one warp per token row, ROW_WARPS rows a block, as the forward.
// Every lane reads the row's k weights, ids and cotangents (k <= 8, one
// cache line each) and forms s in choice order j = 0 .. k-1 with one
// fmaf a term from 0, so every lane holds the same bits. Lane l then
// writes experts l, l + 32, ...: for each it looks the expert up among
// the k ids (a chosen expert appears once) and stores w_j (dw_j - s) or
// 0. The row is written in full by one launch: no separate zero fill.
// No atomics, and every sum in a fixed order: two calls give the same
// bits.
#include <cuda_runtime.h>

namespace {

constexpr int ROW_WARPS = 4;       // token rows per block, a warp each
constexpr int MAXK = 8;            // experts per token

__global__ void __launch_bounds__(ROW_WARPS * 32)
moe_router_bwd_kernel(const float* __restrict__ w,
                      const int* __restrict__ idx,
                      const float* __restrict__ dw,
                      float* __restrict__ dlogits, int T, int E, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (row >= T) return;
  const long long r = (long long)row * k;
  float wj[MAXK], gj[MAXK];
  int ij[MAXK];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    if (j < k) {
      wj[j] = w[r + j];
      ij[j] = idx[r + j];
      s = fmaf(wj[j], dw[r + j], s);
      gj[j] = dw[r + j];
    } else {
      wj[j] = 0.f;
      ij[j] = -1;
      gj[j] = 0.f;
    }
  }
  float* out = dlogits + (long long)row * E;
  for (int e = lane; e < E; e += 32) {
    float g = 0.f;
#pragma unroll
    for (int j = 0; j < MAXK; ++j)
      if (ij[j] == e) g = __fmul_rn(wj[j], __fsub_rn(gj[j], s));
    out[e] = g;
  }
}

}  // namespace

// w: (T,k) fp32, idx: (T,k) int32 and dw: (T,k) fp32 (the forward's
// weights and ids and the weights' cotangent); dlogits: (T,E) fp32
// output; all contiguous, on the device; 0 < k <= min(8, E). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int moe_router_bwd_f32(const void* w, const void* idx,
                                  const void* dw, void* dlogits, int T,
                                  int E, int k, void* stream) {
  if (E <= 0 || k <= 0 || k > MAXK || k > E || T < 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  moe_router_bwd_kernel<<<(T + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32,
                          0, (cudaStream_t)stream>>>(
      (const float*)w, (const int*)idx, (const float*)dw, (float*)dlogits,
      T, E, k);
  return (int)cudaGetLastError();
}
