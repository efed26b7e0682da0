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
// 1,600, n 16) that is ~134 MB, ~40 us at 3.35 TB/s. What a design has
// to spread is the chain over S, and what it has to keep off the chain
// (and out of device memory) is everything else: the states' gains, the
// sums over the n states and over the channels.
//
// Design: the forward's layout, a channel's n states over n lanes of a
// warp, 128 / n channels a block of 128 threads, grid (blocks rounded up
// to whole clusters of CL = 8, B). The states at the start of every 16
// steps, h_ck (B, ceil(S/16), di, n), are the forward kernel's: under
// SsmScanFn the training forward writes them as it steps (ssm_scan.cu's
// `h_ck` output), and a direct call runs the forward kernel for them alone
// first (no y). They are the states the forward had, bit for bit. So one
// walk forward over each tile and one back are all that is serial. Two
// launches from this entry, in order on one stream:
//   * scan, tile by tile from the last, in tiles of TS = 32 steps where
//     every cluster of the grid is resident at once (the occupancy query),
//     else 16 (4 blocks an SM, not 3: one wave of more blocks beats two of
//     fewer). The next tile's dt, x, dy, B_ and C_ are in flight
//     (per-thread cp.async, two buffers) while this one is walked, staged a
//     row a channel or a state so that a lane reads four steps at once;
//     the block meets once a tile. A lane first steps its state forward
//     from the tile's saved start with the forward's operations (every
//     step's gain a = exp(dt A) and input (dt x) B_ first, then the fmaf
//     chain), keeping the tile's gains and prior states in registers and
//     the states after each step in shared memory (the channels' sums
//     read them). Then it walks back: dh = fmaf(dy, C_, g), one product for
//     dh h_{t-1}, dA's fmaf, dh h_{t-1} a kept in shared memory, g = dh a:
//     the only chain. After every n steps lane l of a channel sums step l's
//     dh B_ and dh h_{t-1} a A over the states in order 0 .. n-1 (ddt, dx)
//     from that shared memory, with no exp of its own. After the tile,
//     thread p takes a step and TS n / 128 states and sums dh dt x and dy h
//     over the block's channels in order: this block's partials of dB_ and
//     dC_, kept in shared memory two tiles deep. The cluster then sums its
//     blocks' partials through distributed shared memory in block order,
//     each block a slice, and only that sum goes to device memory (`pB`,
//     `pC`: B x clusters x S x n floats, a CL-th of one partial a block).
//     The cluster's barrier is split: a block arrives after a tile's
//     partials and waits only after the next tile's walk. Each lane writes
//     its dA sum over t to `pA` and its last g as dh0;
//   * reduce: dB_ and dC_ are the clusters' sums added in cluster order,
//     dA the batch rows' sums in row order.
// What holds it back on the card: a tile's phases (the walks, the
// channels' sums, the cluster's sums) follow one another, each short of
// work at 1 to 4 blocks an SM, and a cluster's 8 blocks keep the pace of
// its busiest SM.
// No atomics, and every sum in a fixed order that depends on neither S,
// nor the tile, nor the launch: two calls give the same bits. ddt, dx, dA
// and dh0 take the same operations in the same order as the kernel's
// first form (a block's partials too); dB_ and dC_ differ from it only by
// where the sum over the blocks is parted (a cluster's blocks, then the
// clusters).
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int NT = 128;        // threads per block
constexpr int CKS = 16;        // timesteps between two saved states
constexpr int CL = 8;          // blocks a cluster
// padded row of hist and gdh: 17 mod 32, so a channel's lanes reading n
// steps of one state, and the partials' threads reading a state over 16
// steps, hit distinct banks
constexpr int HR = NT + 17;

struct Params {
  const float *dt, *x, *Bm, *Cm, *A, *hck, *dy, *dhl;
  float *ddt, *dx, *dB, *dC, *dA, *dh0, *pB, *pC, *pA;
  int B, S, di, ncl;
};

template <int N, int TS>
struct Smem {
  static constexpr int CPB = NT / N;  // channels per block
  // a row a channel (dt, x, dy) or a state (B_, C_), a step a column: a
  // lane reads four steps of its row at once, and the lanes that read a
  // step each (the sums, the partials) read consecutive floats; rows padded
  // so that the channels of a warp fall on other banks
  static constexpr int TR = N == 16 ? TS : TS + 8;
  __align__(16) float dt[2][CPB][TR], x[2][CPB][TR], dy[2][CPB][TR];
  __align__(16) float Bm[2][N][TS + 4], Cm[2][N][TS + 4];
  float hist[TS][HR];           // each lane's state after step s
  float gdh[TS][HR];            // each lane's dh at step s
  float tu[CPB][N][N + 1];      // a sub-tile's dh h_{t-1} a, by channel
  float ddt[TS][CPB], dx[TS][CPB];
  float part[2][2][TS][N];      // dB_, dC_ partials, two tiles deep
};

// TS = 16 or 32 steps a tile: 32 halves the tiles' fixed costs (barriers,
// the cluster's sums) but holds 3 blocks an SM, not 4
template <int N, int TS>
__global__ void __cluster_dims__(CL, 1, 1)
__launch_bounds__(NT, TS == 16 ? 4 : 3) ssm_bwd_scan(const Params p) {
  using SM = Smem<N, TS>;
  constexpr int CPB = SM::CPB;
  constexpr int PER = 2 * TS * N / CL;  // partials a block sums a tile
  constexpr int JP = TS * N / NT;       // states a thread's partials take
  static_assert(TS % N == 0 && TS % CKS == 0 && N % 4 == 0 && JP >= 1,
                "whole sub-tiles of whole 4-step reads, whole pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);
  const float* __restrict__ dt = p.dt;
  const float* __restrict__ x = p.x;
  const float* __restrict__ Bm = p.Bm;
  const float* __restrict__ Cm = p.Cm;
  const float* __restrict__ dy = p.dy;
  const float* __restrict__ hck = p.hck;
  const int tid = threadIdx.x;
  const int c = tid / N, i = tid % N;
  const int d0 = blockIdx.x * CPB;
  const int b = blockIdx.y;
  const int S = p.S, di = p.di;
  const uint32_t rank = tma::cluster_rank();
  const int cid = blockIdx.x / CL;
  const bool active = d0 + c < di;
  const long long st = ((long long)b * di + d0 + c) * N + i;
  const long long row0 = (long long)b * S;
  const int tiles = (S + TS - 1) / TS;
  const int cks = (S + CKS - 1) / CKS;
  float Aj[N];                  // A of the lane's channel, every state
#pragma unroll
  for (int j = 0; j < N; ++j)
    Aj[j] = active ? p.A[(long long)(d0 + c) * N + j] : 0.f;
  const float a_i = active ? p.A[(long long)(d0 + c) * N + i] : 0.f;
  // a ragged channel's staged values are 0 in both buffers (never copied)
  for (int q = tid; q < 2 * TS * CPB; q += NT) {
    const int u = q / (TS * CPB), cc = q / TS % CPB, t = q % TS;
    if (d0 + cc >= di) sm.dt[u][cc][t] = sm.x[u][cc][t] = sm.dy[u][cc][t] = 0.f;
  }
  auto ck_at = [&](int k) {   // (b, tile k's first state, d, i) of h_ck
    return (((long long)b * cks + k * (TS / CKS)) * di + d0 + c) * N + i;
  };
  // tile k's inputs into buffer u by asynchronous copies
  auto fetch = [&](int k, int u) {
    const int t0 = k * TS, nt = min(TS, S - t0);
    for (int q = tid; q < nt * CPB; q += NT) {
      const int t = q / CPB, cc = q % CPB;
      if (d0 + cc < di) {
        const long long off = (row0 + t0 + t) * di + d0 + cc;
        tma::copy_async<4>(&sm.dt[u][cc][t], dt + off);
        tma::copy_async<4>(&sm.x[u][cc][t], x + off);
        tma::copy_async<4>(&sm.dy[u][cc][t], dy + off);
      }
    }
    for (int q = tid; q < nt * N; q += NT) {
      tma::copy_async<4>(&sm.Bm[u][q % N][q / N], Bm + (row0 + t0) * N + q);
      tma::copy_async<4>(&sm.Cm[u][q % N][q / N], Cm + (row0 + t0) * N + q);
    }
  };
  // the cluster's sum of tile k's partials, this block's slice of them
  auto cluster_sum = [&](int k) {
    const int t0 = k * TS, nt = min(TS, S - t0);
#pragma unroll
    for (int x0 = 0; x0 < PER; x0 += NT) {
      const int q = rank * PER + x0 + tid;
      const int w = q / (TS * N), s = q / N % TS, j = q % N;
      if (x0 + tid < PER && s < nt) {
        const float* src = &sm.part[k & 1][w][s][j];
        float x[CL];
#pragma unroll
        for (int r = 0; r < CL; ++r) x[r] = *tma::cluster_map(src, r);
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < CL; ++r) v = __fadd_rn(v, x[r]);
        (w ? p.pC : p.pB)[(((long long)b * p.ncl + cid) * S + t0 + s) * N
                          + j] = v;
      }
    }
  };

  float g = active ? p.dhl[st] : 0.f;
  float dA = 0.f;
  float h_next = active && tiles > 0 ? hck[ck_at(tiles - 1)] : 0.f;
  if (tiles > 0) fetch(tiles - 1, 0);
  int u = 0;
  for (int k = tiles - 1; k >= 0; --k, u ^= 1) {
    const int t0 = k * TS, nt = min(TS, S - t0);
    tma::copy_wait();
    __syncthreads();            // tile k has landed; tile k+1 is read
    if (k > 0) fetch(k - 1, u ^ 1);
    float h = h_next;
    if (k > 0) h_next = active ? hck[ck_at(k - 1)] : 0.f;
    // the tile's walks; a whole tile's steps take no test of their own, so
    // the compiler may overlap a step's loads and products with the last
    auto walk = [&](auto full) {
    constexpr bool F = decltype(full)::value;
    // forward over the tile from its saved start: gains and inputs of n
    // steps first, then the chain (the forward kernel's operations)
    float av[TS], hp[TS];
#pragma unroll
    for (int s0 = 0; s0 < TS; s0 += N) {
      float bx[N];
#pragma unroll
      for (int kk = 0; kk < N; kk += 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(
            &sm.dt[u][c][s0 + kk]);
        const float4 x4 = *reinterpret_cast<const float4*>(
            &sm.x[u][c][s0 + kk]);
        const float4 b4 = *reinterpret_cast<const float4*>(
            &sm.Bm[u][i][s0 + kk]);
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
        const float xx[4] = {x4.x, x4.y, x4.z, x4.w};
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          av[s0 + kk + q] = expf(__fmul_rn(dd[q], a_i));
          bx[kk + q] = __fmul_rn(__fmul_rn(dd[q], xx[q]), bb[q]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < N; ++kk) {
        const int s = s0 + kk;
        hp[s] = h;
        if (F || s < nt) h = fmaf(av[s], h, bx[kk]);
        sm.hist[s][tid] = h;
      }
    }
    // back over the tile; after every n steps, their ddt and dx
    float4 d4, y4, c4;          // steps s-3 .. s, read at s % 4 == 3
#pragma unroll
    for (int s = TS - 1; s >= 0; --s) {
      if (s % 4 == 3) {
        d4 = *reinterpret_cast<const float4*>(&sm.dt[u][c][s - 3]);
        y4 = *reinterpret_cast<const float4*>(&sm.dy[u][c][s - 3]);
        c4 = *reinterpret_cast<const float4*>(&sm.Cm[u][i][s - 3]);
      }
      if (F || s < nt) {
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
        const float yy[4] = {y4.x, y4.y, y4.z, y4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float dtv = dd[s % 4];
        const float dh = fmaf(yy[s % 4], cv[s % 4], g);
        sm.gdh[s][tid] = dh;
        const float ph = __fmul_rn(dh, hp[s]);
        dA = fmaf(ph, __fmul_rn(av[s], dtv), dA);
        sm.tu[c][s % N][i] = __fmul_rn(ph, av[s]);
        g = __fmul_rn(dh, av[s]);
      }
      if (s % N == 0) {
        __syncwarp();           // the channel's n steps are in
        const int sl = s + i;   // lane i takes step s + i
        if (F || sl < nt) {
          float ddx = 0.f, sa = 0.f;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            ddx = fmaf(sm.gdh[sl][c * N + j], sm.Bm[u][j][sl], ddx);
            sa = fmaf(sm.tu[c][i][j], Aj[j], sa);
          }
          sm.ddt[sl][c] = fmaf(ddx, sm.x[u][c][sl], sa);
          sm.dx[sl][c] = __fmul_rn(ddx, sm.dt[u][c][sl]);
        }
        __syncwarp();           // tu is read before the next sub-tile
      }
    }
    };
    if (nt == TS)
      walk(std::true_type{});
    else
      walk(std::false_type{});
    if (k + 1 < tiles) {        // tile k+1's partials are in every block
      tma::cluster_wait();
      cluster_sum(k + 1);
    }
    __syncthreads();            // the tile's dh, states, ddt and dx
    for (int q = tid; q < nt * CPB; q += NT) {
      const int t = q / CPB, cc = q % CPB;
      if (d0 + cc < di) {
        const long long off = (row0 + t0 + t) * di + d0 + cc;
        p.ddt[off] = sm.ddt[t][cc];
        p.dx[off] = sm.dx[t][cc];
      }
    }
    // this block's partials of dB_ and dC_ over its channels, in order:
    // thread p takes step p % TS and JP states
    {
      const int s = tid % TS, j0 = tid / TS * JP;
      if (s < nt) {
        float pb[JP], pc[JP];
#pragma unroll
        for (int q = 0; q < JP; ++q) pb[q] = pc[q] = 0.f;
#pragma unroll
        for (int cc = 0; cc < CPB; ++cc) {
          const float dxv = __fmul_rn(sm.dt[u][cc][s], sm.x[u][cc][s]);
          const float dyv = sm.dy[u][cc][s];
#pragma unroll
          for (int q = 0; q < JP; ++q) {
            pb[q] = fmaf(sm.gdh[s][cc * N + j0 + q], dxv, pb[q]);
            pc[q] = fmaf(dyv, sm.hist[s][cc * N + j0 + q], pc[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < JP; ++q) {
          sm.part[k & 1][0][s][j0 + q] = pb[q];
          sm.part[k & 1][1][s][j0 + q] = pc[q];
        }
      }
    }
    tma::cluster_arrive();
  }
  if (tiles > 0) {
    tma::cluster_wait();
    cluster_sum(0);
  }
  tma::cluster_arrive();        // no block leaves while its partials are
  tma::cluster_wait();          // read by another
  if (active) {
    p.dh0[st] = g;
    p.pA[st] = dA;
  }
}

// dB_, dC_ (B,S,n): the clusters' sums in cluster order; dA (di,n): the
// batch rows' in row order
__global__ void ssm_bwd_reduce(const Params p, int n) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nbc = (long long)p.B * p.S * n;
  if (q < nbc) {
    const long long b = q / ((long long)p.S * n), r = q % ((long long)p.S * n);
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < p.ncl; ++k) {
      const long long off = (b * p.ncl + k) * p.S * n + r;
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

template <int N, int TS>
cudaError_t launch_scan(const Params& p, cudaStream_t st) {
  const int smem = (int)sizeof(Smem<N, TS>);
  ssm_bwd_scan<N, TS><<<dim3(p.ncl * CL, p.B), NT, smem, st>>>(p);
  return cudaGetLastError();
}

// clusters of the TS-step kernel that the card holds at once (0 if the
// query fails)
template <int N, int TS>
int resident_clusters(const Params& p) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ncl * CL, p.B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = sizeof(Smem<N, TS>);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, ssm_bwd_scan<N, TS>, &cfg)
      != cudaSuccess) {
    (void)cudaGetLastError();
    return 0;
  }
  return n;
}

template <int N>
cudaError_t launch(Params p, cudaStream_t st) {
  constexpr int CPB = NT / N;
  p.ncl = ((p.di + CPB - 1) / CPB + CL - 1) / CL;
  cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd_scan<N, 16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem<N, 16>));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        ssm_bwd_scan<N, 32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem<N, 32>));
  if (err != cudaSuccess) return err;
  // 32-step tiles where every cluster is resident at once, else 16 (one
  // wave of more blocks beats two of fewer)
  err = p.ncl * p.B <= resident_clusters<N, 32>(p) ? launch_scan<N, 32>(p, st)
                                                   : launch_scan<N, 16>(p, st);
  if (err != cudaSuccess) return err;
  const long long total = (long long)p.B * p.S * N + (long long)p.di * N;
  ssm_bwd_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p, N);
  return cudaGetLastError();
}

}  // namespace

// dt, x, dy: (B,S,di); B_, C_: (B,S,n); A: (di,n); h0, dh_last: (B,di,n);
// h_ck (B, ceil(S/16), di, n): the forward's state at the start of every
// 16 steps (ssm_scan_f32's h_ck output; h0 itself is not read);
// outputs ddt, dx (B,S,di), dB_, dC_ (B,S,n), dA (di,n), dh0 (B,di,n);
// scratch pB, pC (B, ceil(ceil(di/(128/n))/8), S, n) and pA (B, di, n);
// all fp32, contiguous, 16-byte aligned, on the device. n in {8, 16} (any
// other n returns cudaErrorInvalidValue). Launches on `stream` and
// returns the first launch error, or cudaGetLastError().
extern "C" int ssm_scan_bwd_f32(
    const void* dt, const void* x, const void* Bm, const void* Cm,
    const void* A, const void* h0, const void* dy, const void* dh_last,
    void* ddt, void* dx, void* dB, void* dC, void* dA, void* dh0,
    void* h_ck, void* pB, void* pC, void* pA, int B, int S, int di, int n,
    void* stream) {
  (void)h0;
  if (B < 0 || S < 0 || di < 0) return (int)cudaErrorInvalidValue;
  if (n != 8 && n != 16) return (int)cudaErrorInvalidValue;
  if (B == 0 || di == 0) return (int)cudaSuccess;
  Params p{(const float*)dt, (const float*)x, (const float*)Bm,
           (const float*)Cm, (const float*)A, (const float*)h_ck,
           (const float*)dy, (const float*)dh_last, (float*)ddt, (float*)dx,
           (float*)dB, (float*)dC, (float*)dA, (float*)dh0, (float*)pB,
           (float*)pC, (float*)pA, B, S, di, 0};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(n == 8 ? launch<8>(p, st) : launch<16>(p, st));
}
