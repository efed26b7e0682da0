// Fused MoE router (row softmax + top-k) for Hopper (sm_90a), plain CUDA
// C++.
//
// Replaces the Pallas TPU kernel `moe_router_topk` of the JAX package
// (src/repro/kernels/moe_router.py): for each token row of fp32 router
// logits (T, E), the softmax over the E experts, then k passes of an
// argmax (ties to the lowest expert id, as lax.top_k), the chosen
// probabilities renormalised by their sum clamped at 1e-9, and the ids as
// int32. k <= 8 and E <= 512, the TPU kernel's limits.
//
// What bounds it on an H100: each logit is read once and each of the k
// weights and ids written once, T*E*4 + T*k*8 bytes, with ~(4 + 2k)
// operations per logit, far below the card's ~295 operations per byte:
// bound by bytes. At decode (T = the engine's slots) those bytes take
// nanoseconds, so one launch is the whole cost.
//
// Design (what the TPU kernel computes, not its (block_t, E) tiling):
//   * one warp per token row, 8 rows per block; lane l holds the logits
//     of experts l, l + 32, ... in registers (at most 16 at E = 512), so
//     the row is read with coalesced loads and never leaves registers;
//   * softmax: the row max and the sum of exp(x - max) by warp shuffles
//     (a butterfly, so every lane holds the same bits), then p / sum as
//     the TPU kernel divides;
//   * k passes of a warp argmax under the order "larger probability, or
//     equal probability and lower expert id"; the lane that holds the
//     winner sets it to -1e30 before the next pass. The chosen
//     probabilities are summed in pass order, as the TPU kernel does;
//   * every index into the register arrays is a compile-time constant
//     (the loops are unrolled with guards), so nothing spills to local
//     memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;           // token rows per block
constexpr int MAXV = 16;           // logits per lane: E <= 32 * MAXV
constexpr int MAXK = 8;            // experts per token
constexpr float NEG_INF = -1e30f;

__global__ void __launch_bounds__(WARPS * 32)
moe_router_topk_kernel(const float* __restrict__ logits,
                       float* __restrict__ w_out, int* __restrict__ idx_out,
                       int T, int E, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= T) return;              // the whole warp leaves together
  const float* x = logits + (long long)row * E;

  float p[MAXV];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int e = lane + 32 * i;
    p[i] = e < E ? x[e] : -INFINITY;
    mx = fmaxf(mx, p[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    p[i] = lane + 32 * i < E ? expf(p[i] - mx) : 0.f;
    sum += p[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
  for (int i = 0; i < MAXV; ++i)
    p[i] = lane + 32 * i < E ? p[i] / sum : NEG_INF;

  float tot = 0.f, my_w = 0.f;
  int my_i = 0;
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    if (j < k) {
      // this lane's best (its ids ascend with i: strict > keeps the
      // lowest id among equals), then the warp's best
      float bv = -INFINITY;
      int bi = E;
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        if (p[i] > bv) {
          bv = p[i];
          bi = lane + 32 * i;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
#pragma unroll
      for (int i = 0; i < MAXV; ++i)
        if (lane + 32 * i == bi) p[i] = NEG_INF;
      tot += bv;
      if (lane == j) {
        my_w = bv;
        my_i = bi;
      }
    }
  }
  if (lane < k) {
    w_out[(long long)row * k + lane] = my_w / fmaxf(tot, 1e-9f);
    idx_out[(long long)row * k + lane] = my_i;
  }
}

}  // namespace

// logits: (T,E) fp32 contiguous, E <= 512; w: (T,k) fp32 and idx: (T,k)
// int32 outputs, k <= min(8, E); all on the device. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int moe_router_topk_f32(const void* logits, void* w, void* idx,
                                   int T, int E, int k, void* stream) {
  if (E <= 0 || E > 32 * MAXV || k <= 0 || k > MAXK || k > E || T < 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  const int blocks = (T + WARPS - 1) / WARPS;
  moe_router_topk_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (float*)w, (int*)idx, T, E, k);
  return (int)cudaGetLastError();
}
