// The backward of the selective SSM scan for Hopper (sm_90a), plain CUDA
// C++.
//
// Replaces no TPU kernel: the JAX package trains under its reference
// backend (a chunked associative scan, differentiated by jax.grad) and
// has no backward kernel for `ssm_scan` (src/repro/kernels/ssm_scan.py).
// The port has no backend switch, so on the card a training hymba layer
// scans with `ssm_scan` (csrc/ssm_scan.cu) and the scan's gradient must
// come from a kernel too (kernels/ssm_scan.py:SsmScanFn). Per batch row b
// and channel d, the forward steps h_t = a_t h_{t-1} + (dt_t x_t) B_t with
// a_t = exp(dt_t A) and reads y_t = sum_n h_t C_t. From the cotangents dy
// (B,S,di) and dh_last (B,di,n) the reverse recurrence is, for t = S-1
// .. 0, with g the gradient of the state after step t (dh_last at first):
//   dh     = g + dy_t C_t                    (the gradient of h_t)
//   ddt_t  = x_t sum_n dh B_t + sum_n dh h_{t-1} a_t A
//   dx_t   = dt_t sum_n dh B_t
//   dB_t  += dh dt_t x_t,   dC_t += dy_t h_t (both summed over channels)
//   dA    += dh h_{t-1} a_t dt_t             (summed over b and t)
//   g      = dh a_t
// and dh0 = g at the end. All fp32.
//
// What bounds it on an H100: it reads dt, x, dy (B,S,di), B_, C_ (B,S,n),
// A, h0 and dh_last once and writes ddt, dx, dB_, dC_, dA and dh0 once,
// with ~12 n operations a (b, t, d): ~4 x 5 bytes a (b, t, d), ~10
// operations a byte at n = 16, below the card's ~20 fp32 operations a
// byte: bound by bytes. At hymba's training shape (B 2, S 2,048, di
// 1,600, n 16) that is ~134 MB, ~40 us at 3.35 TB/s. This first kernel
// also writes and reads per-block partials of dB_ and dC_ (B x 200 x S x
// n floats each) and recomputes the states twice, so ~4x that is its own
// floor; the sequential chain over S is what sets its time.
//
// Design (correct and simple first): the forward's layout, a channel's n
// states over n lanes, 128 / n channels a block of 128 threads, grid
// (di / (128 / n), B). Two launches from one C entry point, in order on
// one stream:
//   * scan: each lane steps its state forward from h0 with the forward
//     kernel's operations (__fmul_rn products, one fmaf a step), so it
//     meets the forward's h bit for bit, and writes the state at the start
//     of every TS-step tile to the `h_ck` scratch. Then, tile by tile from
//     the last, it reloads the tile's start state, recomputes the tile's
//     states into shared memory (`hist`), and steps the reverse recurrence
//     back over the tile with one fmaf and two products a step, storing dh
//     of every step (`gdh`) and summing its dA term in its register in
//     reverse order of t. After the tile, with the block met once, the
//     sums across lanes are taken in a fixed order: lane l of a channel
//     takes steps l, l + n, ... and sums dh B_ and dh h_{t-1} a A over the
//     state in order 0 .. n-1 (ddt, dx); thread p takes (step, state)
//     pairs and sums dh dt x and dy h over the block's channels in order
//     (this block's partials of dB_ and dC_, written to `pB`, `pC`). Each
//     lane writes its dA sum over t to `pA` and its final g as dh0;
//   * reduce: dB_ and dC_ are the blocks' partials summed in block order,
//     dA the batch rows' sums in row order.
// Tiles of TS = 32 steps are staged in shared memory by plain loads (no
// double buffering); `hist` and `gdh` rows are padded to 129 floats so a
// channel's lanes reading n steps of one state hit distinct banks.
// No atomics and every sum in a fixed order: two calls give the same
// bits.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;        // threads per block
constexpr int TS = 32;         // timesteps a tile (a checkpoint of h)
constexpr int HR = NT + 1;     // padded row of hist and gdh

struct Params {
  const float *dt, *x, *Bm, *Cm, *A, *h0, *dy, *dhl;
  float *ddt, *dx, *dB, *dC, *dA, *dh0, *hck, *pB, *pC, *pA;
  int B, S, di, nblk;
};

template <int N>
__global__ void __launch_bounds__(NT)
ssm_scan_bwd_kernel(const Params p) {
  constexpr int CPB = NT / N;  // channels per block
  __shared__ float sdt[TS][CPB], sx[TS][CPB], sdy[TS][CPB];
  __shared__ float sB[TS][N], sC[TS][N];
  __shared__ float hist[TS + 1][HR];  // h before step s at s, after at s+1
  __shared__ float gdh[TS][HR];       // the gradient of h after step s
  __shared__ float sA[CPB][N];
  const int tid = threadIdx.x;
  const int c = tid / N, i = tid % N;
  const int d0 = blockIdx.x * CPB;
  const int b = blockIdx.y;
  const int S = p.S, di = p.di;
  const bool active = d0 + c < di;
  const long long st = ((long long)b * di + d0 + c) * N + i;
  const long long row0 = (long long)b * S;
  const int tiles = (S + TS - 1) / TS;
  const float a_i = active ? p.A[(long long)(d0 + c) * N + i] : 0.f;
  sA[c][i] = a_i;               // read after the first stage's barrier

  // tile t0's inputs into shared memory; a ragged channel's entries are 0
  auto stage = [&](int t0, bool grads) {
    const int nt = min(TS, S - t0);
    __syncthreads();            // the last tile's values are read
    for (int k = tid; k < nt * CPB; k += NT) {
      const int t = k / CPB, cc = k % CPB;
      const bool in = d0 + cc < di;
      const long long off = (row0 + t0 + t) * di + d0 + cc;
      sdt[t][cc] = in ? p.dt[off] : 0.f;
      sx[t][cc] = in ? p.x[off] : 0.f;
      if (grads) sdy[t][cc] = in ? p.dy[off] : 0.f;
    }
    for (int k = tid; k < nt * N; k += NT) {
      sB[k / N][k % N] = p.Bm[(row0 + t0) * N + k];
      if (grads) sC[k / N][k % N] = p.Cm[(row0 + t0) * N + k];
    }
    __syncthreads();
  };
  // one forward step, the forward kernel's operations
  auto step = [&](int s, float h) {
    const float dtv = sdt[s][c];
    const float dxv = __fmul_rn(dtv, sx[s][c]);
    const float a = expf(__fmul_rn(dtv, a_i));
    return fmaf(a, h, __fmul_rn(dxv, sB[s][i]));
  };
  auto ck_at = [&](int k) {   // (b, tile k, d, i) of h_ck
    return (((long long)b * tiles + k) * di + d0 + c) * N + i;
  };

  // forward: the state at the start of every tile
  float h = active ? p.h0[st] : 0.f;
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * TS, nt = min(TS, S - t0);
    if (active) p.hck[ck_at(k)] = h;
    stage(t0, false);
    for (int s = 0; s < nt; ++s) h = step(s, h);
  }

  // reverse, tile by tile from the last
  float g = active ? p.dhl[st] : 0.f;
  float dA = 0.f;
  for (int k = tiles - 1; k >= 0; --k) {
    const int t0 = k * TS, nt = min(TS, S - t0);
    stage(t0, true);
    h = active ? p.hck[ck_at(k)] : 0.f;
    hist[0][tid] = h;
    for (int s = 0; s < nt; ++s) {
      h = step(s, h);
      hist[s + 1][tid] = h;
    }
    for (int s = nt - 1; s >= 0; --s) {
      const float dtv = sdt[s][c];
      const float a = expf(__fmul_rn(dtv, a_i));
      const float dh = fmaf(sdy[s][c], sC[s][i], g);
      gdh[s][tid] = dh;
      dA = fmaf(__fmul_rn(dh, hist[s][tid]), __fmul_rn(a, dtv), dA);
      g = __fmul_rn(dh, a);
    }
    __syncthreads();            // gdh and hist of the tile are complete
    // ddt and dx: lane i of channel c takes steps i, i + N, ...
    for (int s = i; s < nt; s += N) {
      const float dtv = sdt[s][c];
      float ddx = 0.f, sa = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float dh = gdh[s][c * N + j];
        const float aj = sA[c][j];
        const float a = expf(__fmul_rn(dtv, aj));
        ddx = fmaf(dh, sB[s][j], ddx);
        sa = fmaf(__fmul_rn(__fmul_rn(dh, hist[s][c * N + j]), a), aj, sa);
      }
      if (active) {
        const long long off = (row0 + t0 + s) * di + d0 + c;
        p.ddt[off] = fmaf(ddx, sx[s][c], sa);
        p.dx[off] = __fmul_rn(ddx, dtv);
      }
    }
    // this block's partials of dB_ and dC_ over its channels, in order
    for (int q = tid; q < nt * N; q += NT) {
      const int s = q / N, j = q % N;
      float pb = 0.f, pc = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPB; ++cc) {
        const float dxv = __fmul_rn(sdt[s][cc], sx[s][cc]);
        pb = fmaf(gdh[s][cc * N + j], dxv, pb);
        pc = fmaf(sdy[s][cc], hist[s + 1][cc * N + j], pc);
      }
      const long long off =
          (((long long)b * p.nblk + blockIdx.x) * S + t0 + s) * N + j;
      p.pB[off] = pb;
      p.pC[off] = pc;
    }
  }
  if (active) {
    p.dh0[st] = g;
    p.pA[st] = dA;
  }
}

// dB_, dC_ (B,S,n): the blocks' partials in block order; dA (di,n): the
// batch rows' in row order
__global__ void ssm_scan_bwd_reduce(const Params p, int n) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nbc = (long long)p.B * p.S * n;
  if (q < nbc) {
    const long long b = q / ((long long)p.S * n), r = q % ((long long)p.S * n);
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < p.nblk; ++k) {
      const long long off = (b * p.nblk + k) * p.S * n + r;
      sb = __fadd_rn(sb, p.pB[off]);
      sc = __fadd_rn(sc, p.pC[off]);
    }
    p.dB[q] = sb;
    p.dC[q] = sc;
  } else if (q < nbc + (long long)p.di * n) {
    const long long r = q - nbc;
    float sa = 0.f;
    for (int b = 0; b < p.B; ++b)
      sa = __fadd_rn(sa, p.pA[(long long)b * p.di * n + r]);
    p.dA[r] = sa;
  }
}

template <int N>
cudaError_t launch(Params p, cudaStream_t st) {
  constexpr int CPB = NT / N;
  p.nblk = (p.di + CPB - 1) / CPB;
  ssm_scan_bwd_kernel<N><<<dim3(p.nblk, p.B), NT, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)p.B * p.S * N + (long long)p.di * N;
  ssm_scan_bwd_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p,
                                                                        N);
  return cudaGetLastError();
}

}  // namespace

// dt, x, dy: (B,S,di); B_, C_: (B,S,n); A: (di,n); h0, dh_last: (B,di,n);
// outputs ddt, dx (B,S,di), dB_, dC_ (B,S,n), dA (di,n), dh0 (B,di,n);
// scratch h_ck (B, ceil(S/32), di, n), pB, pC (B, ceil(di/(128/n)), S, n)
// and pA (B, di, n); all fp32, contiguous, on the device. n in {8, 16}
// (any other n returns cudaErrorInvalidValue). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int ssm_scan_bwd_f32(
    const void* dt, const void* x, const void* Bm, const void* Cm,
    const void* A, const void* h0, const void* dy, const void* dh_last,
    void* ddt, void* dx, void* dB, void* dC, void* dA, void* dh0,
    void* h_ck, void* pB, void* pC, void* pA, int B, int S, int di, int n,
    void* stream) {
  if (B < 0 || S < 0 || di < 0) return (int)cudaErrorInvalidValue;
  if (n != 8 && n != 16) return (int)cudaErrorInvalidValue;
  if (B == 0 || di == 0) return (int)cudaSuccess;
  Params p{(const float*)dt, (const float*)x, (const float*)Bm,
           (const float*)Cm, (const float*)A, (const float*)h0,
           (const float*)dy, (const float*)dh_last, (float*)ddt, (float*)dx,
           (float*)dB, (float*)dC, (float*)dA, (float*)dh0, (float*)h_ck,
           (float*)pB, (float*)pC, (float*)pA, B, S, di, 0};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(n == 8 ? launch<8>(p, st) : launch<16>(p, st));
}
