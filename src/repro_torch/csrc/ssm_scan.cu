// Selective SSM scan for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `ssm_scan` of the JAX package
// (src/repro/kernels/ssm_scan.py): per batch row b and channel d, from an
// explicit initial state h0[b, d, :] over timesteps t = 0 .. S-1,
//   a      = exp(dt[b,t,d] * A[d, :])
//   h      = a * h + (dt[b,t,d] * x[b,t,d]) * B_[b,t,:]
//   y[b,t,d] = sum_n h * C_[b,t,:]
// and the state after the last step, h_last[b, d, :]. All fp32. It carries
// hymba's SSM branch: each layer's prefill (B = 1, S = prompt) and decode
// (B = the engine's slots, S = 1).
//
// What bounds it on an H100: each input is read once and each output
// written once, and the work is ~4n operations per (b, t, d), far below the
// card's ~295 operations per byte: bound by bytes. At decode (B = 8, S = 1,
// di = 1600, n = 16) the h0 / h_last traffic dominates (~1.8 MB, ~0.5 us at
// 3.35 TB/s); at a 1,024-token prefill (B = 1) dt, x and y do (~20 MB,
// ~6 us). In practice the launch sets its time at decode, and at prefill
// the sequential dependency chain over S does: ceil(1600 / 128) = 13 blocks
// leave most of the 132 SMs idle. A chunked parallel scan, or n split over
// lanes, is later work.
//
// Design (what the TPU kernel computes and keeps out of device memory, not
// its grid): the TPU kernel carries the (block_d, n) state in VMEM across
// its sequential s-blocks. Here one thread owns one (b, d) channel and
// holds its n states and its row of A in registers for the whole scan; the
// sequential s axis is a loop inside the thread. Blocks of 128 channels
// over ceil(di / 128) x B, the ragged channel edge masked. Per tile of 32
// timesteps the block stages the (32, n) rows of B_ and C_ in shared memory
// once (every thread reads the same row: broadcast), and each thread loads
// its own dt and x of the tile into registers with loads coalesced across
// the block's threads before the tile's dependent steps begin.
//
// Every step is the same code with explicit roundings: the products are
// __fmul_rn (never contracted into an FMA), the state update is one fmaf,
// and y is a chain of fmaf over n = 0 .. N-1 from 0. So a step's bits
// depend only on its inputs and the carried state, never on where the
// step sits in a tile or a launch: a scan split at any seam (h_last of the
// first part fed as h0 of the second) gives the bits of one scan, and S
// one-step launches give the bits of one S-step launch.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BD = 128;        // channels (threads) per block
constexpr int TT = 32;         // timesteps per staged tile

template <int N>
__global__ void __launch_bounds__(BD)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_last, int S,
                int di) {
  __shared__ float sB[TT][N];
  __shared__ float sC[TT][N];
  const int d = blockIdx.x * BD + threadIdx.x;
  const int b = blockIdx.y;
  const bool active = d < di;

  float h[N], a_row[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a_row[i] = active ? A[(long long)d * N + i] : 0.f;
    h[i] = active ? h0[((long long)b * di + d) * N + i] : 0.f;
  }
  const long long row0 = (long long)b * S;       // (b, t = 0) row
  const float* bp = Bm + row0 * N;
  const float* cp = Cm + row0 * N;

  for (int t0 = 0; t0 < S; t0 += TT) {
    const int nt = min(TT, S - t0);
    __syncthreads();                // the previous tile's rows are read
    for (int i = threadIdx.x; i < TT * N; i += BD) {
      const bool ok = i / N < nt;
      sB[i / N][i % N] = ok ? bp[(long long)t0 * N + i] : 0.f;
      sC[i / N][i % N] = ok ? cp[(long long)t0 * N + i] : 0.f;
    }
    float rdt[TT], rx[TT];
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const bool ok = active && j < nt;
      const long long off = (row0 + t0 + j) * di + d;
      rdt[j] = ok ? dt[off] : 0.f;
      rx[j] = ok ? x[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      if (j < nt) {                 // the same for every thread
        const float dtv = rdt[j];
        const float dx = __fmul_rn(dtv, rx[j]);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float a = expf(__fmul_rn(dtv, a_row[i]));
          h[i] = fmaf(a, h[i], __fmul_rn(dx, sB[j][i]));
          acc = fmaf(h[i], sC[j][i], acc);
        }
        if (active) y[(row0 + t0 + j) * di + d] = acc;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      h_last[((long long)b * di + d) * N + i] = h[i];
  }
}

template <int N>
cudaError_t launch(const void* dt, const void* x, const void* Bm,
                   const void* Cm, const void* A, const void* h0, void* y,
                   void* h_last, int B, int S, int di, cudaStream_t st) {
  const dim3 grid((di + BD - 1) / BD, B);
  ssm_scan_kernel<N><<<grid, BD, 0, st>>>(
      (const float*)dt, (const float*)x, (const float*)Bm, (const float*)Cm,
      (const float*)A, (const float*)h0, (float*)y, (float*)h_last, S, di);
  return cudaGetLastError();
}

}  // namespace

// dt, x: (B,S,di); B_, C_: (B,S,n); A: (di,n); h0: (B,di,n); outputs y:
// (B,S,di) and h_last: (B,di,n); all fp32, contiguous, on the device. n in
// {8, 16} (any other n returns cudaErrorInvalidValue). Launches on `stream`
// and returns cudaGetLastError().
extern "C" int ssm_scan_f32(const void* dt, const void* x, const void* Bm,
                            const void* Cm, const void* A, const void* h0,
                            void* y, void* h_last, int B, int S, int di,
                            int n, void* stream) {
  if (B < 0 || S < 0 || di < 0) return (int)cudaErrorInvalidValue;
  if (n != 8 && n != 16) return (int)cudaErrorInvalidValue;
  if (B == 0 || di == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      n == 8 ? launch<8>(dt, x, Bm, Cm, A, h0, y, h_last, B, S, di, st)
             : launch<16>(dt, x, Bm, Cm, A, h0, y, h_last, B, S, di, st);
  return (int)err;
}
