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
// ~6 us). The sequential chain over S is what a design has to spread: one
// thread per channel leaves a B = 1 prefill on ceil(1600 / 128) = 13 SMs
// with n dependent steps of y per timestep.
//
// Design (what the TPU kernel computes and keeps out of device memory, not
// its grid): the TPU kernel carries the (block_d, n) state in VMEM across
// its sequential s-blocks. Here a channel's n states lie over n lanes of a
// warp (16 at n = 16, 8 at n = 8): lane i keeps h_i and A[d, i] in
// registers for the whole scan, and a warp covers 32 / n consecutive
// channels, so its slice of h0, A and h_last is 32 consecutive floats. A
// block of 128 threads covers 128 / n channels; the grid is
// ceil(di / (128 / n)) x B blocks (200 at hymba's B = 1 prefill, 1,600 at
// 8 decode slots). Tiles of up to 64 timesteps (as many as the launch has:
// a decode stages one row) of the block's dt and x columns and of B_ and
// C_ are staged in shared memory by per-thread asynchronous copies, two
// buffers deep: the next tile's copies are in flight while this tile is
// stepped. Per full sub-tile of n steps a lane first computes every step's
// exp(dt A_i) and (dt x) B_i, independent of the state, then runs the
// chain h_i = fmaf(a, h_i, bx), one fmaf a step (a shorter tail, such as
// a decode's one step, computes only its own steps, one after the other,
// with the same operations), and writes its h_i of
// every step into its channel's history in shared memory. Then lane l of
// the channel sums step l's history against that step's row of C_ in
// order i = 0 .. n-1: the n dependent fmafs of y run on n lanes at once
// instead of in series. A channel's lanes and its history stay in one
// warp, so the sub-tile needs only __syncwarp; the block meets twice a
// tile (the tile has landed; its y is in shared memory for a coalesced
// write-out). Histories and C_ rows are padded to n + 1 floats, so the
// history's writes and the lanes' reads over steps hit distinct banks.
//
// Every step is the same code with explicit roundings: the products are
// __fmul_rn (never contracted into an FMA), the state update is one fmaf,
// and y is a chain of fmaf over n = 0 .. N-1 from 0. So a step's bits
// depend only on its inputs and the carried state, never on where the
// step sits in a tile or a launch: a scan split at any seam (h_last of the
// first part fed as h0 of the second) gives the bits of one scan, and S
// one-step launches give the bits of one S-step launch. These are also
// the bits of the one-thread-per-channel form of this kernel, which did
// the same operations in the same order.
#include <cuda_runtime.h>
#include <math.h>

#include "tma.cuh"

namespace {

constexpr int NT = 128;        // threads per block
constexpr int TS = 64;         // timesteps staged per tile

template <int N>
__global__ void __launch_bounds__(NT)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_last, int S,
                int di) {
  constexpr int CPB = NT / N;  // channels per block
  constexpr int HS = N + 1;    // padded row of a history and of C_
  __shared__ float sdt[2][TS][CPB];
  __shared__ float sx[2][TS][CPB];
  __shared__ float sB[2][TS][N];
  __shared__ float sC[2][TS][HS];
  __shared__ float sy[TS][CPB + 1];
  __shared__ float hist[CPB][N][HS];  // a channel's h at a sub-tile's steps
  const int c = threadIdx.x / N;      // this lane's channel in the block
  const int i = threadIdx.x % N;      // its state; in y, its step
  const int d0 = blockIdx.x * CPB;
  const int b = blockIdx.y;
  const bool active = d0 + c < di;
  const long long st = ((long long)b * di + d0 + c) * N + i;
  const long long row0 = (long long)b * S;       // (b, t = 0) row

  // the tile of timesteps from t0 into buffer u, one element a copy; a
  // ragged channel's elements stay uncopied (its lanes' results are never
  // stored)
  auto fetch = [&](int t0, int u) {
    const int nt = min(TS, S - t0);
    for (int k = threadIdx.x; k < nt * CPB; k += NT) {
      const int t = k / CPB, cc = k % CPB;
      if (d0 + cc < di) {
        const long long off = (row0 + t0 + t) * di + d0 + cc;
        tma::copy_async<4>(&sdt[u][t][cc], dt + off);
        tma::copy_async<4>(&sx[u][t][cc], x + off);
      }
    }
    for (int k = threadIdx.x; k < nt * N; k += NT) {
      tma::copy_async<4>(&sB[u][k / N][k % N], Bm + (row0 + t0) * N + k);
      tma::copy_async<4>(&sC[u][k / N][k % N], Cm + (row0 + t0) * N + k);
    }
  };

  const float a_i = active ? A[(long long)(d0 + c) * N + i] : 0.f;
  float h = active ? h0[st] : 0.f;
  if (S > 0) fetch(0, 0);
  int u = 0;
  for (int t0 = 0; t0 < S; t0 += TS, u ^= 1) {
    const int nt = min(TS, S - t0);
    tma::copy_wait();
    __syncthreads();            // the tile has landed; the last y is out
    if (t0 + TS < S) fetch(t0 + TS, u ^ 1);
    for (int s0 = 0; s0 < nt; s0 += N) {
      const int ns = min(N, nt - s0);
      if (ns == N) {            // the same for every lane of the block
        // every step's gain and input first, then the chain
        float av[N], bx[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float dtv = sdt[u][s0 + k][c];
          const float dx = __fmul_rn(dtv, sx[u][s0 + k][c]);
          av[k] = expf(__fmul_rn(dtv, a_i));
          bx[k] = __fmul_rn(dx, sB[u][s0 + k][i]);
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
          h = fmaf(av[k], h, bx[k]);
          hist[c][k][i] = h;
        }
      } else {                  // a short tail (a decode's one step)
        for (int k = 0; k < ns; ++k) {
          const float dtv = sdt[u][s0 + k][c];
          const float dx = __fmul_rn(dtv, sx[u][s0 + k][c]);
          const float a = expf(__fmul_rn(dtv, a_i));
          h = fmaf(a, h, __fmul_rn(dx, sB[u][s0 + k][i]));
          hist[c][k][i] = h;
        }
      }
      __syncwarp();
      if (i < ns) {
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n)
          acc = fmaf(hist[c][i][n], sC[u][s0 + i][n], acc);
        sy[s0 + i][c] = acc;
      }
      __syncwarp();             // the history is read before it is reused
    }
    __syncthreads();            // the tile's y is in shared memory
    for (int k = threadIdx.x; k < nt * CPB; k += NT) {
      const int t = k / CPB, cc = k % CPB;
      if (d0 + cc < di) y[(row0 + t0 + t) * di + d0 + cc] = sy[t][cc];
    }
  }
  if (active) h_last[st] = h;
}

template <int N>
cudaError_t launch(const void* dt, const void* x, const void* Bm,
                   const void* Cm, const void* A, const void* h0, void* y,
                   void* h_last, int B, int S, int di, cudaStream_t st) {
  constexpr int CPB = NT / N;
  const dim3 grid((di + CPB - 1) / CPB, B);
  ssm_scan_kernel<N><<<grid, NT, 0, st>>>(
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
