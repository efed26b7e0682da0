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
// it at ~3 us. In practice the sequential chain over S sets the prefill time:
// each step waits for the last.
//
// Design (what the TPU kernel computes and keeps out of device memory, not
// its grid): the TPU kernel keeps one head's whole (hd, hd) C in VMEM and
// steps it per grid row. Here one head's C at hd = 192 is 144 KB of fp32:
// more than a thread's registers or a block's static shared memory, and
// one block per head would fill 4 of 132 SMs at prefill. The recurrence's
// columns are independent once n and m are known: column e of C is updated
// from ks, v_e, fw and iw, and read out as num_e = sum_d C[d,e] q_d. So the
// grid is (hd / 32 column tiles, B H), 256 threads a block: lane l of warp
// g holds column tile*32 + l of C for rows [g hd/8, (g+1) hd/8) in
// registers, with n of the same rows, for the whole scan. Every block
// steps its own copy of n and m, with the same code on the same inputs, so
// the copies are bitwise identical (the `n_tiles` / `m_tiles` outputs,
// written only when asked for, let a check see that); only tile 0 writes
// n and m out. Per tile of 16 timesteps the block stages q and ks (all hd
// rows), its 32 columns of v, i and f in shared memory once, with loads
// coalesced across the block; each step reads them as broadcasts. A step's
// two reductions over d (num for the block's columns, n . q) are a chain
// of fmaf over the thread's rows, then a sum over the 8 warps in warp
// order through a double-buffered shared array: one __syncthreads per
// step. hd = 192 gives 6 x B H blocks (24 at a B = 1 prefill of
// xlstm-125m, 192 at 8 decode slots); hd 32, 64 and 128 are built too.
//
// Every step is the same code with explicit roundings: the state updates
// are the plain version's separate products and sums (__fmul_rn,
// __fadd_rn: never contracted into an FMA), so C and n differ from it only
// through expf / log1pf rounding of fw and iw; the reductions are a fixed
// order. A step's bits depend only on its inputs and the carried state,
// never on where it sits in a tile or a launch: a scan split at any seam
// (the state of the first part fed to the second) gives the bits of one
// scan, and S one-step launches give the bits of one S-step launch.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int EC = 32;          // columns of C per block: one per lane
constexpr int NT = 256;         // threads per block
constexpr int RG = NT / EC;     // row groups: one per warp
constexpr int TT = 16;          // timesteps staged per tile

__device__ __forceinline__ float log_sigmoid(float x) {
  // min(x, 0) - log1p(exp(-|x|)): no overflow for either sign
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ ks,
                  const float* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, const float* __restrict__ C0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  float* __restrict__ h, float* __restrict__ C1,
                  float* __restrict__ n1, float* __restrict__ m1,
                  float* __restrict__ n_tiles, float* __restrict__ m_tiles,
                  int S) {
  constexpr int RPT = HD / RG;  // rows of C and n per thread
  constexpr int NTILE = HD / EC;
  __shared__ float sq[TT][HD];
  __shared__ float sk[TT][HD];
  __shared__ float sv[TT][EC];
  __shared__ float si[TT];
  __shared__ float sf[TT];
  __shared__ float red_num[2][RG][EC];
  __shared__ float red_nq[2][RG];

  const int tile = blockIdx.x;
  const long long bh = blockIdx.y;
  const int lane = threadIdx.x % EC;
  const int g = threadIdx.x / EC;
  const int e = tile * EC + lane;
  const int d0 = g * RPT;
  const long long row0 = bh * S;                 // the (bh, t = 0) row

  float c[RPT], n[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    c[r] = C0[(bh * HD + d0 + r) * HD + e];
    n[r] = n0[bh * HD + d0 + r];
  }
  float m = m0[bh];

  for (int t0 = 0; t0 < S; t0 += TT) {
    const int nt = min(TT, S - t0);
    __syncthreads();                // the previous tile's rows are read
    for (int x = threadIdx.x; x < nt * HD; x += NT) {
      sq[x / HD][x % HD] = q[(row0 + t0) * HD + x];
      sk[x / HD][x % HD] = ks[(row0 + t0) * HD + x];
    }
    for (int x = threadIdx.x; x < nt * EC; x += NT)
      sv[x / EC][x % EC] = v[(row0 + t0 + x / EC) * HD + tile * EC + x % EC];
    if (threadIdx.x < nt) {
      si[threadIdx.x] = ig[row0 + t0 + threadIdx.x];
      sf[threadIdx.x] = fg[row0 + t0 + threadIdx.x];
    }
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      const float i_t = si[j];
      const float a = __fadd_rn(log_sigmoid(sf[j]), m);
      const float m_new = fmaxf(a, i_t);
      const float fw = expf(__fsub_rn(a, m_new));
      const float iw = expf(__fsub_rn(i_t, m_new));
      const float ve = sv[j][lane];
      float num = 0.f, nq = 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float kd = sk[j][d0 + r];
        const float qd = sq[j][d0 + r];
        c[r] = __fadd_rn(__fmul_rn(c[r], fw),
                         __fmul_rn(iw, __fmul_rn(kd, ve)));
        n[r] = __fadd_rn(__fmul_rn(n[r], fw), __fmul_rn(iw, kd));
        num = fmaf(c[r], qd, num);
        nq = fmaf(n[r], qd, nq);
      }
      const int buf = (t0 + j) & 1;
      red_num[buf][g][lane] = num;
      if (lane == 0) red_nq[buf][g] = nq;
      __syncthreads();
      if (g == 0) {                 // the same order for every column
        float tn = 0.f, tq = 0.f;
#pragma unroll
        for (int w = 0; w < RG; ++w) {
          tn = __fadd_rn(tn, red_num[buf][w][lane]);
          tq = __fadd_rn(tq, red_nq[buf][w]);
        }
        const float den = fmaxf(fabsf(tq), expf(-m_new));
        h[(row0 + t0 + j) * HD + e] = __fdiv_rn(tn, den);
      }
      m = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    C1[(bh * HD + d0 + r) * HD + e] = c[r];
    if (tile == 0 && lane == 0) n1[bh * HD + d0 + r] = n[r];
    if (n_tiles != nullptr && lane == 0)
      n_tiles[(bh * NTILE + tile) * HD + d0 + r] = n[r];
  }
  if (threadIdx.x == 0) {
    if (tile == 0) m1[bh] = m;
    if (m_tiles != nullptr) m_tiles[bh * NTILE + tile] = m;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* ks, const void* v,
                   const void* ig, const void* fg, const void* C0,
                   const void* n0, const void* m0, void* h, void* C1,
                   void* n1, void* m1, void* n_tiles, void* m_tiles, int BH,
                   int S, cudaStream_t st) {
  const dim3 grid(HD / EC, BH);
  mlstm_scan_kernel<HD><<<grid, NT, 0, st>>>(
      (const float*)q, (const float*)ks, (const float*)v, (const float*)ig,
      (const float*)fg, (const float*)C0, (const float*)n0, (const float*)m0,
      (float*)h, (float*)C1, (float*)n1, (float*)m1, (float*)n_tiles,
      (float*)m_tiles, S);
  return cudaGetLastError();
}

}  // namespace

// q, ks, v: (BH,S,hd); ig, fg: (BH,S); C0: (BH,hd,hd); n0: (BH,hd); m0:
// (BH,); outputs h: (BH,S,hd), C1, n1, m1 shaped as the state; n_tiles
// (BH, hd/32, hd) and m_tiles (BH, hd/32): every column tile's own n and m
// after the last step, or null to skip them. All fp32, contiguous, on the
// device. hd in {32, 64, 128, 192} (any other hd returns
// cudaErrorInvalidValue). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int mlstm_scan_f32(const void* q, const void* ks, const void* v,
                              const void* ig, const void* fg, const void* C0,
                              const void* n0, const void* m0, void* h,
                              void* C1, void* n1, void* m1, void* n_tiles,
                              void* m_tiles, int BH, int S, int hd,
                              void* stream) {
  if (BH < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (hd != 32 && hd != 64 && hd != 128 && hd != 192)
    return (int)cudaErrorInvalidValue;
  if (BH == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (hd) {
    case 32:
      err = launch<32>(q, ks, v, ig, fg, C0, n0, m0, h, C1, n1, m1, n_tiles,
                       m_tiles, BH, S, st);
      break;
    case 64:
      err = launch<64>(q, ks, v, ig, fg, C0, n0, m0, h, C1, n1, m1, n_tiles,
                       m_tiles, BH, S, st);
      break;
    case 128:
      err = launch<128>(q, ks, v, ig, fg, C0, n0, m0, h, C1, n1, m1,
                        n_tiles, m_tiles, BH, S, st);
      break;
    default:
      err = launch<192>(q, ks, v, ig, fg, C0, n0, m0, h, C1, n1, m1,
                        n_tiles, m_tiles, BH, S, st);
      break;
  }
  return (int)err;
}
