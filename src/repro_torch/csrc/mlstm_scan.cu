// Stabilized mLSTM scan for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `mlstm_scan` of the JAX package
// (src/repro/kernels/mlstm_scan.py): per (batch row, head) bh, from an
// explicit initial state (C0 (hd, hd), n0 (hd,), m0) over timesteps
// t = 0 .. S-1, with k pre-scaled by the wrapper (ks = k * scale),
//   logf = logsigmoid(f_t)              (the stable form)
//   m'   = max(logf + m, i_t)
//   fw   = exp(logf + m - m'),  iw = exp(i_t - m')
//   C    = C fw + iw (ks_t v_t^T)
//   n    = n fw + iw ks_t
//   h_t  = C^T q_t / max(|n . q_t|, exp(-m'))
// and the state after the last step. All fp32. It carries xlstm's mLSTM
// layers: each prefill and extend (B = 1, S = the chunk) and each decode
// (B = the engine's slots, S = 1).
//
// What bounds it on an H100: 5 hd^2 + O(hd) fp32 operations per (bh, t)
// (C fw + (iw ks) v^T is a multiply and a multiply-add per element of C,
// the C^T q readout a multiply-add) against 4 (3 hd + 2) bytes of q, k, v,
// i, f and 4 hd bytes of h: at hd = 192 some 60 operations per byte, above
// the fp32 CUDA-core rate's ~20 per byte, so a long prefill is bound by
// operations (xlstm-125m's 1,024-token prefill, B H = 4: ~0.76 G
// operations, ~11 us at 67 TFLOP/s). At decode (S = 1) the state read and
// written (~8 hd^2 bytes per bh, ~9.5 MB over 8 slots of 4 heads) bounds
// it at ~3 us. In practice the sequential chain over S sets the prefill
// time: each step waits for the last, so what counts is how much of a
// step's work sits on one warp's path and how often the block meets.
//
// Design (what the TPU kernel computes and keeps out of device memory, not
// its grid): the TPU kernel keeps one head's whole (hd, hd) C in VMEM and
// steps it per grid row. Here one head's C at hd = 192 is 144 KB of fp32:
// more than a thread's registers or a block's static shared memory. The
// recurrence's columns are independent once n and m are known: column e
// of C is updated from ks, v_e, fw and iw, and read out as num_e =
// sum_d C[d,e] q_d. So the grid is (hd / EC column tiles, B H), and a
// block has EC x 8 stepping threads and one producer warp: stepping
// thread (g, l) holds column tile*EC + l of C for the rows of row group g,
// [g hd/8, (g+1) hd/8), in registers, with n of the same rows, for the
// whole scan. EC is 8 in a launch of many steps (96 blocks at xlstm's
// B H = 4 prefill, a warp a scheduler) and 16 in a one-step launch (384
// blocks at 8 decode slots, three on an SM; C's rows read and written 64
// bytes at a time). Every block steps its own copy of n and m, with the same
// code on the same inputs, so the copies are bitwise identical (the
// `n_tiles` / `m_tiles` outputs, written only when asked for, let a check
// see that); only tile 0 writes n and m out.
//
// The timesteps go in tiles of 8, two buffers deep, and the block meets
// once a tile. While the stepping threads run tile k's steps back to back
// (each step: the C and n updates of their rows and their two chains over
// them, num for the column and n . q, written as partials to [8][8][EC]
// and [8][8] shared arrays), the producer warp reduces tile k-1's
// partials (each output a sum over the 8 row groups in order from 0, then
// the division) and stages tile k+1: q and ks (all hd rows) and the
// block's EC columns of v by asynchronous copies, and the tile's gates,
// computed once (lane j takes step j's logsigmoid, the m chain runs over
// shuffles, lane j then takes step j's fw, iw and exp(-m')). So the
// stepping threads never wait on the gates, the copies or the reduction.
//
// Every step is the same code with explicit roundings: the state updates
// are the plain version's separate products and sums (__fmul_rn,
// __fadd_rn: never contracted into an FMA), so C and n differ from it only
// through expf / log1pf rounding of fw and iw; the reductions are a fixed
// order (each thread's rows in order, then the 8 row groups in order,
// whatever EC is). A step's bits depend only on its inputs and the carried
// state, never on where it sits in a tile or a launch, nor on EC: a scan
// split at any seam (the state of the first part fed to the second) gives
// the bits of one scan, and S one-step launches give the bits of one
// S-step launch. These are also the bits of the form of this kernel that
// stepped one timestep a barrier with every thread computing the gates,
// which did the same operations in the same order.
#include <cuda_runtime.h>
#include <math.h>

#include "tma.cuh"

namespace {

constexpr int RG = 8;           // row groups: a column's sums go in this order
constexpr int TT = 8;           // timesteps a tile

__device__ __forceinline__ float log_sigmoid(float x) {
  // min(x, 0) - log1p(exp(-|x|)): no overflow for either sign
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

template <int HD, int EC>
__global__ void __launch_bounds__(EC * RG + 32, 1)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ ks,
                  const float* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, const float* __restrict__ C0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  float* __restrict__ h, float* __restrict__ C1,
                  float* __restrict__ n1, float* __restrict__ m1,
                  float* __restrict__ n_tiles, float* __restrict__ m_tiles,
                  int S) {
  constexpr int NC = EC * RG;   // stepping threads; then the producer warp
  constexpr int RPT = HD / RG;  // rows of C and n per stepping thread
  constexpr int NTILE = HD / EC;
  constexpr int RS = (RG + 1) * EC;  // padded step row of the partials
  static_assert(RPT % 4 == 0 && EC % 4 == 0, "rows and columns go by 4");
  __shared__ __align__(16) float sq[2][TT][HD];
  __shared__ __align__(16) float sk[2][TT][HD];
  __shared__ __align__(16) float sv[2][TT][EC];
  __shared__ float gate[2][3][TT];  // fw, iw, exp(-m')
  __shared__ float red_num[2][TT][RS];
  __shared__ float red_nq[2][TT][RG];

  const int tile = blockIdx.x;
  const long long bh = blockIdx.y;
  const long long row0 = bh * S;                 // the (bh, t = 0) row
  const int tiles = (S + TT - 1) / TT;
  const bool producer = threadIdx.x >= NC;
  const int pl = threadIdx.x - NC;               // the producer's lane
  const int lane = threadIdx.x % EC;
  const int g = threadIdx.x / EC;
  const int e = tile * EC + lane;
  const int d0 = g * RPT;
  float m = m0[bh];             // carried by the producer, which runs the gates

  // producer: tile k's q, ks and v by asynchronous copies, and its gates
  auto stage = [&](int k) {
    const int u = k & 1, nt = min(TT, S - k * TT);
    const long long r0 = row0 + (long long)k * TT;
    float it = 0.f, fv = 0.f;
    if (pl < nt) {
      it = ig[r0 + pl];
      fv = fg[r0 + pl];
    }
    for (int x = pl; x < nt * (HD / 4); x += 32) {
      tma::copy_async<16>(&sq[u][0][0] + 4 * x, q + r0 * HD + 4 * x);
      tma::copy_async<16>(&sk[u][0][0] + 4 * x, ks + r0 * HD + 4 * x);
    }
    for (int x = pl; x < nt * (EC / 4); x += 32) {
      const int t = x / (EC / 4), c4 = 4 * (x % (EC / 4));
      tma::copy_async<16>(&sv[u][t][c4],
                          v + (r0 + t) * HD + tile * EC + c4);
    }
    const float lf = pl < nt ? log_sigmoid(fv) : 0.f;
    float aj = 0.f, mj = 0.f;
#pragma unroll
    for (int jj = 0; jj < TT; ++jj) {
      const float lfj = __shfl_sync(0xffffffffu, lf, jj);
      const float itj = __shfl_sync(0xffffffffu, it, jj);
      if (jj < nt) {
        const float a = __fadd_rn(lfj, m);
        const float m_new = fmaxf(a, itj);
        if (jj == pl) {
          aj = a;
          mj = m_new;
        }
        m = m_new;
      }
    }
    if (pl < nt) {
      gate[u][0][pl] = expf(__fsub_rn(aj, mj));
      gate[u][1][pl] = expf(__fsub_rn(it, mj));
      gate[u][2][pl] = expf(-mj);
    }
  };
  // producer: tile k's outputs from the stepping threads' partials
  auto reduce = [&](int k) {
    const int u = k & 1, nt = min(TT, S - k * TT);
    const long long r0 = row0 + (long long)k * TT;
    for (int o = pl; o < nt * EC; o += 32) {
      const int j = o / EC, ee = o % EC;
      float tn = 0.f, tq = 0.f;
#pragma unroll
      for (int w = 0; w < RG; ++w) {  // the same order for every column
        tn = __fadd_rn(tn, red_num[u][j][w * EC + ee]);
        tq = __fadd_rn(tq, red_nq[u][j][w]);
      }
      const float den = fmaxf(fabsf(tq), gate[u][2][j]);
      h[(r0 + j) * HD + tile * EC + ee] = __fdiv_rn(tn, den);
    }
  };
  // stepping threads: tile k's steps
  float c[RPT], n[RPT];
  auto steps = [&](int k) {
    const int u = k & 1, nt = min(TT, S - k * TT);
    for (int j = 0; j < nt; ++j) {
      const float fw = gate[u][0][j];
      const float iw = gate[u][1][j];
      const float ve = sv[u][j][lane];
      const float4* kr = reinterpret_cast<const float4*>(&sk[u][j][d0]);
      const float4* qr = reinterpret_cast<const float4*>(&sq[u][j][d0]);
      float num = 0.f, nq = 0.f;
#pragma unroll
      for (int r4 = 0; r4 < RPT / 4; ++r4) {
        const float4 k4 = kr[r4], q4 = qr[r4];
        const float kd[4] = {k4.x, k4.y, k4.z, k4.w};
        const float qd[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int r = 4 * r4 + w;
          c[r] = __fadd_rn(__fmul_rn(c[r], fw),
                           __fmul_rn(iw, __fmul_rn(kd[w], ve)));
          n[r] = __fadd_rn(__fmul_rn(n[r], fw), __fmul_rn(iw, kd[w]));
          num = fmaf(c[r], qd[w], num);
          nq = fmaf(n[r], qd[w], nq);
        }
      }
      red_num[u][j][g * EC + lane] = num;
      if (lane == 0) red_nq[u][j][g] = nq;
    }
  };

  if (producer) {
    if (tiles > 0) stage(0);
    tma::copy_wait();
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      c[r] = C0[(bh * HD + d0 + r) * HD + e];
      n[r] = n0[bh * HD + d0 + r];
    }
  }
  __syncthreads();              // tile 0 is staged
  for (int k = 0; k < tiles; ++k) {
    if (producer) {
      if (k > 0) reduce(k - 1);
      __syncwarp();             // tile k-1's gates are read before reuse
      if (k + 1 < tiles) stage(k + 1);
      tma::copy_wait();
    } else {
      steps(k);
    }
    __syncthreads();            // tile k's partials, tile k+1's rows
  }
  if (producer) {
    if (tiles > 0) reduce(tiles - 1);
    if (pl == 0) {
      if (tile == 0) m1[bh] = m;
      if (m_tiles != nullptr) m_tiles[bh * NTILE + tile] = m;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    C1[(bh * HD + d0 + r) * HD + e] = c[r];
    if (tile == 0 && lane == 0) n1[bh * HD + d0 + r] = n[r];
    if (n_tiles != nullptr && lane == 0)
      n_tiles[(bh * NTILE + tile) * HD + d0 + r] = n[r];
  }
}

struct Args {
  const void *q, *ks, *v, *ig, *fg, *C0, *n0, *m0;
  void *h, *C1, *n1, *m1, *n_tiles, *m_tiles;
  int BH, S;
  cudaStream_t st;
};

template <int HD, int EC>
cudaError_t launch(const Args& a) {
  const dim3 grid(HD / EC, a.BH);
  mlstm_scan_kernel<HD, EC><<<grid, EC * RG + 32, 0, a.st>>>(
      (const float*)a.q, (const float*)a.ks, (const float*)a.v,
      (const float*)a.ig, (const float*)a.fg, (const float*)a.C0,
      (const float*)a.n0, (const float*)a.m0, (float*)a.h, (float*)a.C1,
      (float*)a.n1, (float*)a.m1, (float*)a.n_tiles, (float*)a.m_tiles,
      a.S);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_cols(const Args& a, int ec) {
  return ec == 8 ? launch<HD, 8>(a) : launch<HD, 16>(a);
}

}  // namespace

// q, ks, v: (BH,S,hd); ig, fg: (BH,S); C0: (BH,hd,hd); n0: (BH,hd); m0:
// (BH,); outputs h: (BH,S,hd), C1, n1, m1 shaped as the state; n_tiles
// (BH, hd/ec, hd) and m_tiles (BH, hd/ec): every column tile's own n and
// m after the last step, or null to skip them. All fp32, contiguous,
// 16-byte aligned, on the device. hd in {32, 64, 128, 192} and ec (the
// columns of C a block holds) in {8, 16}; any other value returns
// cudaErrorInvalidValue. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int mlstm_scan_f32(const void* q, const void* ks, const void* v,
                              const void* ig, const void* fg, const void* C0,
                              const void* n0, const void* m0, void* h,
                              void* C1, void* n1, void* m1, void* n_tiles,
                              void* m_tiles, int BH, int S, int hd, int ec,
                              void* stream) {
  if (BH < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (hd != 32 && hd != 64 && hd != 128 && hd != 192)
    return (int)cudaErrorInvalidValue;
  if (ec != 8 && ec != 16) return (int)cudaErrorInvalidValue;
  if (BH == 0) return (int)cudaSuccess;
  const Args a{q, ks, v, ig, fg, C0, n0, m0, h, C1, n1, m1, n_tiles,
               m_tiles, BH, S, (cudaStream_t)stream};
  switch (hd) {
    case 32: return (int)launch_cols<32>(a, ec);
    case 64: return (int)launch_cols<64>(a, ec);
    case 128: return (int)launch_cols<128>(a, ec);
    default: return (int)launch_cols<192>(a, ec);
  }
}
