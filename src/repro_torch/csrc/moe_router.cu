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
// nanoseconds, and one row's chain of dependent instructions is the whole
// cost, so the design shortens that chain.
//
// Design (what the TPU kernel computes, not its (block_t, E) tiling):
//   * one warp per token row, ROW_WARPS rows per block; lane l holds the
//     logits of experts l, l + 32, ..., l + 32 (V - 1) in registers, with V
//     a template parameter: the instance is the smallest of 1, 2, 4, 8, 12
//     and 16 that covers ceil(E / 32), and 16 takes any E <= 512. No lane
//     walks slots past its row's experts but the ragged last one;
//   * softmax: the row max and the sum of exp(x - max) by warp shuffles
//     (a butterfly, so every lane holds the same bits), then p / sum as
//     the TPU kernel divides (expf and an IEEE division: no fast math);
//   * each lane orders its V probabilities once, descending, by insertion
//     in ascending expert id: an equal value goes below the ones already
//     there, so equal probabilities stay in ascending id. It keeps the
//     first L = min(V, 8) (no lane is chosen more than k <= 8 times);
//     empty entries hold the sentinel -1e30;
//   * k passes over the 32 lists' heads: a redux.sync max of the heads'
//     bits taken as signed ints, then a redux.sync min of the expert id
//     over the lanes whose head has those bits; the winning lane shifts
//     its list by one. The int order is the float order here because
//     every candidate is a probability >= +0.0 (non-negative bits, which
//     order as the floats do) or the sentinel (negative bits, below every
//     probability); k <= E, so a probability always wins. A lane's head
//     is its lowest id among its equal maxima, so the min over the heads
//     is the row's lowest id among its equal maxima. NaN logits are
//     outside the contract, as they are for the plain version;
//   * the chosen probabilities are summed in pass order, as the TPU
//     kernel does, and lane j writes pass j's weight and id;
//   * every index into the register arrays is a compile-time constant
//     (the loops are unrolled, the list shifts by selects), so nothing
//     lives in local memory.
//
// Bits: the same at every instance V that covers E. The max and the sum
// see the row's values in the same order whatever V is (a slot past E
// adds +0.0 or takes fmaxf with -inf, neither of which changes a bit),
// and the passes choose what a k-pass argmax over the row chooses.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int ROW_WARPS = 4;       // token rows per block, a warp each
constexpr int MAXV = 16;           // logits per lane: E <= 32 * MAXV
constexpr int MAXK = 8;            // experts per token
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int V>
__global__ void __launch_bounds__(ROW_WARPS * 32)
moe_router_topk_kernel(const float* __restrict__ logits,
                       float* __restrict__ w_out, int* __restrict__ idx_out,
                       int T, int E, int k) {
  constexpr int L = V < MAXK ? V : MAXK;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (row >= T) return;              // the whole warp leaves together
  const float* x = logits + (long long)row * E;

  float p[V];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = lane + 32 * i;
    p[i] = e < E ? x[e] : -INFINITY;
    mx = fmaxf(mx, p[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    p[i] = lane + 32 * i < E ? expf(p[i] - mx) : 0.f;
    sum += p[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(FULL, sum, o);

  // this lane's probabilities, descending, equal ones in ascending id
  float hv[L];
  int hi[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    hv[j] = NEG_INF;
    hi[j] = INT_MAX;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = lane + 32 * i;
    const float v = e < E ? p[i] / sum : NEG_INF;
#pragma unroll
    for (int j = L - 1; j > 0; --j) {  // reads hv[j - 1] before it moves
      if (v > hv[j]) {
        const bool up = v > hv[j - 1];
        hv[j] = up ? hv[j - 1] : v;
        hi[j] = up ? hi[j - 1] : e;
      }
    }
    if (v > hv[0]) {
      hv[0] = v;
      hi[0] = e;
    }
  }

  float tot = 0.f, my_w = 0.f;
  int my_i = 0;
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    if (j < k) {
      const int head = __float_as_int(hv[0]);
      const int best = __reduce_max_sync(FULL, head);
      const int win = __reduce_min_sync(FULL, head == best ? hi[0]
                                                           : INT_MAX);
      if (hi[0] == win) {
#pragma unroll
        for (int m = 0; m + 1 < L; ++m) {
          hv[m] = hv[m + 1];
          hi[m] = hi[m + 1];
        }
        hv[L - 1] = NEG_INF;
        hi[L - 1] = INT_MAX;
      }
      const float bv = __int_as_float(best);
      tot += bv;
      if (lane == j) {
        my_w = bv;
        my_i = win;
      }
    }
  }
  if (lane < k) {
    w_out[(long long)row * k + lane] = my_w / fmaxf(tot, 1e-9f);
    idx_out[(long long)row * k + lane] = my_i;
  }
}

template <int V>
int launch(const void* logits, void* w, void* idx, int T, int E, int k,
           cudaStream_t stream) {
  moe_router_topk_kernel<V><<<(T + ROW_WARPS - 1) / ROW_WARPS,
                              ROW_WARPS * 32, 0, stream>>>(
      (const float*)logits, (float*)w, (int*)idx, T, E, k);
  return (int)cudaGetLastError();
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
  const int v = (E + 31) / 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (v <= 1) return launch<1>(logits, w, idx, T, E, k, s);
  if (v <= 2) return launch<2>(logits, w, idx, T, E, k, s);
  if (v <= 4) return launch<4>(logits, w, idx, T, E, k, s);
  if (v <= 8) return launch<8>(logits, w, idx, T, E, k, s);
  if (v <= 12) return launch<12>(logits, w, idx, T, E, k, s);
  return launch<16>(logits, w, idx, T, E, k, s);
}
