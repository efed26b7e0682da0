// The backward of the stabilized mLSTM scan for Hopper (sm_90a), plain
// CUDA C++.
//
// Replaces no TPU kernel: the JAX package trains under its reference
// backend (the chunkwise mLSTM, differentiated by jax.grad) and has no
// backward kernel for `mlstm_scan` (src/repro/kernels/mlstm_scan.py). The
// port has no backend switch, so on the card a training mLSTM layer scans
// with `mlstm_scan` (csrc/mlstm_scan.cu) and the scan's gradient must come
// from a kernel too (kernels/mlstm_scan.py:MlstmScanFn). Per (batch row,
// head) bh the forward steps, with ks = k scale,
//   a_t = logsigmoid(f_t) + m_{t-1},  m_t = max(a_t, i_t)
//   fw = exp(a_t - m_t),  iw = exp(i_t - m_t)
//   C_t = fw C_{t-1} + iw ks_t v_t^T,  n_t = fw n_{t-1} + iw ks_t
//   h_t = C_t^T q_t / den_t,  den_t = max(|n_t . q_t|, exp(-m_t))
// and from the cotangents dh (S, hd) and of the final state (dC, dn, dm)
// the reverse recurrence, t = S-1 .. 0, with G, dn and dm the gradients
// of C_t, n_t and m_t from the later steps (the final state's at first):
//   dnum = dh_t / den_t,  dden = -(dh_t . num_t) / den_t^2
//   dnq, dem: dden to |n.q| (times sign(n.q)) or to exp(-m) by the max
//     (half each on a tie, as autograd splits a max)
//   G += q_t dnum^T,  dn += q_t dnq
//   dq_t  = C_t dnum + n_t dnq
//   dks_t = iw (G v_t + dn),  dv_t = iw G^T ks_t
//   dfw = <G, C_{t-1}> + dn . n_{t-1},  diw = v_t . G^T ks_t + dn . ks_t
//   dm_t = dm - dem exp(-m_t) - dfw fw - diw iw, split by the max
//     between a_t and i_t (half each on a tie)
//   di_t = diw iw + (dm_t's share),  da = dfw fw + (dm_t's share)
//   df_t = da sigmoid(-f_t),  dm = da,  G = fw G,  dn = fw dn
// and dk = scale dks; the gradient of the initial state is the last G,
// dn and dm. All fp32. The gradient is the function's as computed: the
// denominator's exp(-m) floor (which a fresh state's first steps take)
// and the stabiliser's max are differentiated as branches.
//
// What bounds it on an H100: ~12 hd^2 operations a (bh, t) (the C and G
// updates, the four column and row sums over C and G, the C recompute)
// against reading q, k, v, dh and the gates and writing dq, dk, dv, di,
// df once (~28 hd bytes): at hd = 192, ~80 operations a byte, above the
// fp32 CUDA-core rate's ~20: bound by operations. At xlstm-125m's
// training shape (B 8, H 4, S 256, hd 192) that is ~3.6 G operations,
// ~54 us at 67 TFLOP/s. Only three chains are serial over t: the scalar
// m, n (a row at a time, its gain the scalar fw) and, given the forward's
// gates, each element of G (its own scalar recurrence); dn and dm follow
// from their sums. The design runs those chains alone and everything
// else beside them, in parallel over t or over the (row, column) plane.
//
// Five launches from one C entry point, in order on one stream:
//   * gates, a block of hd threads a bh, S in chunks of CH = 32 steps
//     staged two deep (ks, i, f): the chunk's logsigmoid(f) in parallel,
//     the scalar m chain alone on one thread, then fw, iw, exp(-m) in
//     parallel; n's chain a row a thread (the forward's operations, so n
//     meets its bits). Each step's gates and n go to scratch.
//   * den, a block a (16 steps, bh), in parallel over t: n . q a warp a
//     step (each lane's rows in order, then a butterfly: the first form's
//     bits), den, and dnum = dh / den for all (t, e).
//   * columns: the (row, column) plane of G is independent given the
//     gates, so a block holds all hd rows of EC = 4 columns, a row a
//     thread (grid hd / 4 column tiles x BH: 192 blocks at a B H = 4
//     prefill), in thread block clusters of CL = 8 tiles. A first walk
//     steps C forward over S with the forward's operations and writes it
//     at the start of every CK = 8-step chunk; then, a chunk at a time
//     from the last, a thread rebuilds the chunk's C rows in registers and
//     steps G back over them. q, ks, v, dnum and the gates are staged two
//     chunks deep by per-thread cp.async. Each step's row sums over the
//     tile's 4 columns (C dnum, G v) are a thread's own; its column sums
//     (G^T ks, for dv, and <G, C_{t-1}>) are a warp's shuffles in a fixed
//     pattern, two steps' ten sums at once, kept in shared memory until
//     the chunk's end, when the block meets once and adds its warps in
//     order (dv written; the tile's <G, C_{t-1}> to scratch). The row sums go across the
//     cluster's 8 tiles through distributed shared memory, in tile order,
//     a step a block, and only those sums reach device memory (hd/32
//     partials a step, a CL-th of one a tile); the cluster's
//     barrier is split: a block arrives after a chunk, waits at the start
//     of the next and issues its reads of the other tiles' row sums there,
//     and adds them after that chunk's walk, which hides the reads.
//   * sums, a block a (16 steps, bh), all in parallel over t: the
//     clusters' row sums in cluster order, the tiles' <G, C_{t-1}> in tile
//     order; dden from q . (C dnum) (= num . dnum) and the max's split,
//     dq = n dnq + C dnum, and the G-part of diw as ks . (G v).
//   * chain, a block a bh, 16-step chunks staged two deep: dn's reverse
//     chain a row a thread (its inputs read first, then the chain alone,
//     then dk and the two products of each step, with n_{t-1} and ks_t),
//     the products' sums over the rows (one butterfly a warp for all the
//     chunk's 32 sums, then the warps in order), then the scalar dm chain
//     alone on one thread; di and df in parallel after it.
// What holds it back on the card: the columns pass, a chunk's phases one
// after another at 3 blocks (18 warps) an SM, its column sums (8
// shuffles a step) and its rebuild of C; the chains' passes, one block
// a bh, where B H is small.
// No atomics, and every sum in a fixed order that depends on neither S
// nor the launch: two calls give the same bits.
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int EC = 4;           // columns of dC a block
constexpr int CL = 8;           // column tiles a thread block cluster
constexpr int CK = 8;           // steps a chunk (between two saved C)
constexpr int CH = 32;          // steps a chunk of the gates pass
constexpr int DCH = 16;         // steps a block of the den pass
constexpr int HCH = 16;         // steps a block of the sums, a chunk of dn
constexpr int NG = 7;           // gate planes: fw iw em nq den a m
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float *q, *ks, *v, *ig, *fg, *C0, *n0, *m0, *dh, *dC1, *dn1, *dm1;
  float *dq, *dk, *dv, *di, *df, *dC0, *dn0, *dm0;
  float *gates, *nS, *dnum, *Cck, *pscal, *pdq, *pdk;
  int BH, S;
  float scale;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  // the forward kernel's: min(x, 0) - log1p(exp(-|x|))
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the sums over a warp of 2M values a lane, halving them at each level
// (a lane keeps the half its bit of the level picks and adds its
// partner's): lane l is left with value l's sum
template <int M>
__device__ __forceinline__ void warp_halve(float (&v)[2 * M], int lane) {
  const bool hi = lane & M;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const float keep = hi ? v[q + M] : v[q];
    const float send = hi ? v[q] : v[q + M];
    v[q] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, M));
  }
  if constexpr (M > 1) warp_halve<M / 2>(reinterpret_cast<float(&)[M]>(v),
                                         lane);
}

// the max's share of a cotangent: (to x, to y) for max(x, y), half each
// on a tie
__device__ __forceinline__ float2 max_split(float x, float y, float g) {
  if (x > y) return make_float2(g, 0.f);
  if (y > x) return make_float2(0.f, g);
  return make_float2(0.5f * g, 0.5f * g);
}

// ---------------------------------------------------------------- gates --
template <int HD>
struct GateSmem {
  __align__(16) float ks[2][CH][HD];
  float ig[2][CH], fg[2][CH];
  float lf[CH], a[CH], m[CH], fw[CH], iw[CH];
};

// the true chains, a block a bh: m on one thread, n a row a thread
template <int HD>
__global__ void __launch_bounds__(HD) mlstm_bwd_gates(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GateSmem<HD>& sm = *reinterpret_cast<GateSmem<HD>*>(smem_raw);
  const float* __restrict__ ks = p.ks;
  float* __restrict__ nS = p.nS;
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const int S = p.S;
  float* gp = p.gates + bh * NG * S;
  auto stage = [&](int t0, int u) {
    const int nt = min(CH, S - t0);
    const long long r0 = (bh * S + t0) * HD;
    for (int x = d; x < nt * HD / 4; x += HD)
      tma::copy_async<16>(&sm.ks[u][0][0] + 4 * x, ks + r0 + 4 * x);
    if (d < nt) {
      tma::copy_async<4>(&sm.ig[u][d], p.ig + bh * S + t0 + d);
      tma::copy_async<4>(&sm.fg[u][d], p.fg + bh * S + t0 + d);
    }
  };
  float n = p.n0[bh * HD + d];
  float m = p.m0[bh];
  if (S > 0) stage(0, 0);
  int u = 0;
  for (int t0 = 0; t0 < S; t0 += CH, u ^= 1) {
    const int nt = min(CH, S - t0);
    tma::copy_wait();
    __syncthreads();            // the chunk has landed; the last is read
    if (t0 + CH < S) stage(t0 + CH, u ^ 1);
    if (d < nt) sm.lf[d] = log_sigmoid(sm.fg[u][d]);
    __syncthreads();
    if (d == 0) {               // the m chain
#pragma unroll 8
      for (int j = 0; j < nt; ++j) {
        const float a = __fadd_rn(sm.lf[j], m);
        m = fmaxf(a, sm.ig[u][j]);
        sm.a[j] = a;
        sm.m[j] = m;
      }
    }
    __syncthreads();
    if (d < nt) {
      const float a = sm.a[d], mn = sm.m[d];
      const float fw = expf(__fsub_rn(a, mn));
      const float iw = expf(__fsub_rn(sm.ig[u][d], mn));
      sm.fw[d] = fw;
      sm.iw[d] = iw;
      gp[t0 + d] = fw;
      gp[S + t0 + d] = iw;
      gp[2 * S + t0 + d] = expf(-mn);
      gp[5 * S + t0 + d] = a;
      gp[6 * S + t0 + d] = mn;
    }
    __syncthreads();
    const long long r0 = (bh * S + t0) * HD;
#pragma unroll 8
    for (int j = 0; j < nt; ++j) {  // n's chain, the forward's operations
      n = __fadd_rn(__fmul_rn(n, sm.fw[j]), __fmul_rn(sm.iw[j],
                                                     sm.ks[u][j][d]));
      nS[r0 + j * HD + d] = n;
    }
  }
}

// -------------------------------------------------------------- den --
// in parallel, a block a (DCH steps, bh): n . q a warp a step (each lane's
// rows in order, then a butterfly), den, and dnum = dh / den
template <int HD>
__global__ void __launch_bounds__(HD) mlstm_bwd_den(const Params p) {
  constexpr int W = HD / 32, R = HD / 32;
  __shared__ float sden[DCH];
  const float* __restrict__ q = p.q;
  const float* __restrict__ nS = p.nS;
  const float* __restrict__ dh = p.dh;
  float* __restrict__ dnum = p.dnum;
  const long long bh = blockIdx.y;
  const int t0 = blockIdx.x * DCH;
  const int d = threadIdx.x, lane = d & 31, w = d >> 5;
  const int S = p.S, nt = min(DCH, S - t0);
  float* gp = p.gates + bh * NG * S;
  for (int j = w; j < nt; j += W) {
    const long long r0 = (bh * S + t0 + j) * HD;
    float nq = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      nq = fmaf(nS[r0 + lane + 32 * r], q[r0 + lane + 32 * r], nq);
    nq = __shfl_sync(FULL, warp_sum(nq), 0);
    if (lane == 0) {
      const float den = fmaxf(fabsf(nq), gp[2 * S + t0 + j]);
      gp[3 * S + t0 + j] = nq;
      gp[4 * S + t0 + j] = den;
      sden[j] = den;
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int j = 0; j < nt; ++j) {
    const long long r = (bh * S + t0 + j) * HD + d;
    dnum[r] = __fdiv_rn(dh[r], sden[j]);
  }
}

// -------------------------------------------------------------- columns --
template <int HD>
struct ColSmem {
  __align__(16) float q[2][CK][HD];
  __align__(16) float ks[2][CK][HD];
  __align__(16) float v[2][CK][EC];
  __align__(16) float dn[2][CK][EC];
  float fw[2][CK], iw[2][CK];
  float rows[2][CK][2][HD];     // C dnum, G v of each row, two chunks deep
  float wred[CK][HD / 32][EC + 1];  // a warp's G^T ks and <G, C_{t-1}>
};

template <int HD>
__global__ void __cluster_dims__(CL, 1, 1)
__launch_bounds__(HD, HD >= 64 ? 576 / HD : 8)  // hd 32: one warp a block
mlstm_bwd_columns(const Params p) {
  using L = ColSmem<HD>;
  constexpr int W = HD / 32, NTILE = HD / EC, NCL = HD / EC / CL;
  constexpr int PER = CK * 2 * HD / CL;  // row sums a block adds a chunk
  static_assert(CK % 2 == 0 && 2 * (EC + 1) <= 16,
                "whole pairs of steps, a pair's sums in 16 slots");
  static_assert(PER % HD == 0, "a block adds whole rows of partials");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  L& sm = *reinterpret_cast<L*>(smem_raw);
  const float* __restrict__ q = p.q;
  const float* __restrict__ ks = p.ks;
  const float* __restrict__ v = p.v;
  const float* __restrict__ dnum = p.dnum;
  const float* __restrict__ gates = p.gates;
  float* __restrict__ Cck = p.Cck;
  const int tile = blockIdx.x;
  const long long bh = blockIdx.y;
  const int d = threadIdx.x, lane = d & 31, w = d >> 5;
  const int e0 = tile * EC;
  const int S = p.S;
  const int chunks = (S + CK - 1) / CK;
  const uint32_t rank = tma::cluster_rank();
  const int cid = tile / CL;
  const long long qrow0 = bh * S;
  auto ck_at = [&](int k) {     // (bh, tile, chunk k, row d) of C_ck
    return (((bh * NTILE + tile) * chunks + k) * HD + d) * EC;
  };
  // chunk k into buffer u: ks, v and the gates; q and dnum for the walk
  // back (rev)
  auto stage = [&](int k, int u, bool rev) {
    const int t0 = k * CK, nt = min(CK, S - t0);
    const long long r0 = (qrow0 + t0) * HD;
    for (int x = d; x < nt * HD / 4; x += HD) {
      tma::copy_async<16>(&sm.ks[u][0][0] + 4 * x, ks + r0 + 4 * x);
      if (rev) tma::copy_async<16>(&sm.q[u][0][0] + 4 * x, q + r0 + 4 * x);
    }
    if (d < nt) {
      tma::copy_async<16>(&sm.v[u][d][0], v + r0 + d * HD + e0);
      if (rev)
        tma::copy_async<16>(&sm.dn[u][d][0], dnum + r0 + d * HD + e0);
      tma::copy_async<4>(&sm.fw[u][d], gates + bh * NG * S + t0 + d);
      tma::copy_async<4>(&sm.iw[u][d], gates + (bh * NG + 1) * S + t0 + d);
    }
  };
  // one forward step of this thread's row, the forward kernel's operations
  auto fstep = [&](float (&c)[EC], int u, int j) {
    const float fw = sm.fw[u][j], iw = sm.iw[u][j], kd = sm.ks[u][j][d];
    const float4 v4 = *reinterpret_cast<const float4*>(&sm.v[u][j][0]);
    const float ve[EC] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < EC; ++e)
      c[e] = __fadd_rn(__fmul_rn(c[e], fw), __fmul_rn(iw, __fmul_rn(kd,
                                                                  ve[e])));
  };
  // the cluster's sums of chunk k's row sums, this block's rows of them:
  // the blocks' rows read (right after the cluster's wait), then, once the
  // chunk's walk has hidden that read, added in tile order and stored
  constexpr int NR = PER / HD;  // rows of sums a thread takes
  auto cluster_load = [&](int k, float (&y)[NR][CL]) {
#pragma unroll
    for (int x = 0; x < NR; ++x) {
      const int f = rank * PER + x * HD + d;
#pragma unroll
      for (int r = 0; r < CL; ++r)
        y[x][r] = *tma::cluster_map(
            &sm.rows[k & 1][f / (2 * HD)][f / HD % 2][f % HD], r);
    }
  };
  auto cluster_store = [&](int k, const float (&y)[NR][CL]) {
    const int t0 = k * CK, nt = min(CK, S - t0);
#pragma unroll
    for (int x = 0; x < NR; ++x) {
      const int f = rank * PER + x * HD + d;
      const int j = f / (2 * HD), which = f / HD % 2, dd = f % HD;
      if (j < nt) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < CL; ++r) s = __fadd_rn(s, y[x][r]);
        (which ? p.pdk : p.pdq)[((bh * NCL + cid) * S + t0 + j) * HD + dd] =
            s;
      }
    }
  };

  // forward: C at the start of every chunk
  float c[EC];
  {
    const float4 c4 = *reinterpret_cast<const float4*>(
        p.C0 + (bh * HD + d) * HD + e0);
    c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
  }
  if (chunks > 1) stage(0, 0, false);
  for (int k = 0; k < chunks; ++k) {
    const int u = k & 1;
    tma::copy_wait();
    __syncthreads();            // chunk k has landed; chunk k-1 is read
    if (k + 2 < chunks) stage(k + 1, u ^ 1, false);
    *reinterpret_cast<float4*>(Cck + ck_at(k)) =
        make_float4(c[0], c[1], c[2], c[3]);
    if (k + 1 < chunks) {       // the last chunk's steps are not needed
#pragma unroll                  // (and every other chunk is whole)
      for (int j = 0; j < CK; ++j) fstep(c, u, j);
    }
  }
  __syncthreads();              // the walk's buffers are read

  // back, a chunk at a time from the last
  float G[EC];
  {
    const float4 g4 = *reinterpret_cast<const float4*>(
        p.dC1 + (bh * HD + d) * HD + e0);
    G[0] = g4.x; G[1] = g4.y; G[2] = g4.z; G[3] = g4.w;
  }
  float4 cnext = make_float4(0.f, 0.f, 0.f, 0.f);
  if (chunks > 0) {
    stage(chunks - 1, 0, true);
    cnext = *reinterpret_cast<const float4*>(Cck + ck_at(chunks - 1));
  }
  int u = 0;
  for (int k = chunks - 1; k >= 0; --k, u ^= 1) {
    const int t0 = k * CK, nt = min(CK, S - t0);
    tma::copy_wait();
    __syncthreads();            // chunk k has landed; chunk k+1 is read
    if (k > 0) stage(k - 1, u ^ 1, true);
    float ys[NR][CL];
    if (k + 1 < chunks) {       // chunk k+1's row sums are in every block
      tma::cluster_wait();
      cluster_load(k + 1, ys);
    }
    const float4 cstart = cnext;
    if (k > 0)
      cnext = *reinterpret_cast<const float4*>(Cck + ck_at(k - 1));
    // the chunk's walks; a whole chunk's steps take no test of their own,
    // so the compiler may overlap a step's loads and sums with the last
    auto walk = [&](auto full) {
    constexpr bool F = decltype(full)::value;
    float ch[CK + 1][EC];       // C before each step of the chunk
    ch[0][0] = cstart.x; ch[0][1] = cstart.y;
    ch[0][2] = cstart.z; ch[0][3] = cstart.w;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
#pragma unroll
      for (int e = 0; e < EC; ++e) ch[j + 1][e] = ch[j][e];
      if (F || j < nt) fstep(ch[j + 1], u, j);
    }
    // a pair of steps' column terms (G ks, <G, C_{t-1}>), the odd step's
    // first: their sums over the warp are taken a pair at a time
    float pc[2 * (EC + 1)];
#pragma unroll
    for (int j = CK - 1; j >= 0; --j) {
      const int o = j % 2 ? 0 : EC + 1;
      if (F || j < nt) {
        const float qd = sm.q[u][j][d], kd = sm.ks[u][j][d];
        const float fw = sm.fw[u][j];
        const float4 n4 = *reinterpret_cast<const float4*>(&sm.dn[u][j][0]);
        const float4 v4 = *reinterpret_cast<const float4*>(&sm.v[u][j][0]);
        const float dn[EC] = {n4.x, n4.y, n4.z, n4.w};
        const float ve[EC] = {v4.x, v4.y, v4.z, v4.w};
        float rdq = 0.f, rgv = 0.f, gcp = 0.f;
#pragma unroll
        for (int e = 0; e < EC; ++e) {
          G[e] = fmaf(qd, dn[e], G[e]);          // the gradient of C_t
          rdq = fmaf(ch[j + 1][e], dn[e], rdq);  // C_t dnum
          rgv = fmaf(G[e], ve[e], rgv);          // G v_t
          pc[o + e] = __fmul_rn(G[e], kd);       // G^T ks_t, this row
          gcp = fmaf(G[e], ch[j][e], gcp);       // <G, C_{t-1}>, this row
        }
        pc[o + EC] = gcp;
        sm.rows[k & 1][j][0][d] = rdq;
        sm.rows[k & 1][j][1][d] = rgv;
#pragma unroll
        for (int e = 0; e < EC; ++e) G[e] = __fmul_rn(G[e], fw);
      } else {
#pragma unroll
        for (int e = 0; e <= EC; ++e) pc[o + e] = 0.f;
      }
      if (j % 2 == 0) {         // the pair's 10 sums over the warp
        float v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) v[q] = q < 2 * (EC + 1) ? pc[q] : 0.f;
        warp_halve<8>(v, lane);  // lanes l, l + 16: half-warp sums of l % 16
        const float sum = __fadd_rn(v[0], __shfl_xor_sync(FULL, v[0], 16));
        const int slot = lane % 16;  // both halves hold it: both store it
        if (slot < 2 * (EC + 1))
          sm.wred[slot <= EC ? j + 1 : j][w][slot % (EC + 1)] = sum;
      }
    }
    };
    if (nt == CK)
      walk(std::true_type{});
    else
      walk(std::false_type{});
    if (k + 1 < chunks) cluster_store(k + 1, ys);
    __syncthreads();            // the chunk's row and warp sums
    // dv and the tile's <G, C_{t-1}>: the warps in order
    for (int x = d; x < nt * (EC + 1); x += HD) {
      const int j = x / (EC + 1), e = x % (EC + 1);
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < W; ++ww) s = __fadd_rn(s, sm.wred[j][ww][e]);
      if (e < EC)
        p.dv[(qrow0 + t0 + j) * HD + e0 + e] = __fmul_rn(sm.iw[u][j], s);
      else
        p.pscal[(bh * (NTILE + 4) + tile) * S + t0 + j] = s;
    }
    tma::cluster_arrive();
  }
  if (chunks > 0) {
    float ys[NR][CL];
    tma::cluster_wait();
    cluster_load(0, ys);
    cluster_store(0, ys);
  }
  tma::cluster_arrive();        // no block leaves while its sums are read
  tma::cluster_wait();          // by another
  *reinterpret_cast<float4*>(p.dC0 + (bh * HD + d) * HD + e0) =
      make_float4(G[0], G[1], G[2], G[3]);
}

// ----------------------------------------------------------------- sums --
template <int HD>
__global__ void __launch_bounds__(HD) mlstm_bwd_sums(const Params p) {
  constexpr int W = HD / 32, R = HD / 32, NTILE = HD / EC,
                NCL = HD / EC / CL;
  __shared__ float spq[HCH][HD], spk[HCH][HD];
  __shared__ float sdnq[HCH];
  const float* __restrict__ q = p.q;
  const float* __restrict__ ks = p.ks;
  const float* __restrict__ pdq = p.pdq;
  float* __restrict__ pdk = p.pdk;
  const long long bh = blockIdx.y;
  const int t0 = blockIdx.x * HCH;
  const int d = threadIdx.x, lane = d & 31, w = d >> 5;
  const int S = p.S, nt = min(HCH, S - t0);
  const float* gp = p.gates + bh * NG * S;
  float* ps = p.pscal + bh * (NTILE + 4) * S;
  for (int j = 0; j < nt; ++j) {   // the clusters' sums, in cluster order
    const long long t = t0 + j;
    float pq = 0.f, pk = 0.f;
#pragma unroll
    for (int c = 0; c < NCL; ++c) {
      const long long off = ((bh * NCL + c) * S + t) * HD + d;
      pq = __fadd_rn(pq, pdq[off]);
      pk = __fadd_rn(pk, pdk[off]);
    }
    spq[j][d] = pq;
    spk[j][d] = pk;
    pdk[(bh * NCL * S + t) * HD + d] = pk;  // G v, for the chain
  }
  __syncthreads();
  for (int j = w; j < nt; j += W) {  // a warp a step
    const int t = t0 + j;
    const long long r0 = (bh * S + t) * HD;
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int dd = lane + 32 * r;
      x = fmaf(q[r0 + dd], spq[j][dd], x);   // num . dnum
      y = fmaf(ks[r0 + dd], spk[j][dd], y);  // v . G^T ks
    }
    x = warp_sum(x);
    y = warp_sum(y);
    if (lane == 0) {
      const float den = gp[4 * S + t], nq = gp[3 * S + t];
      const float dden = -__fdiv_rn(x, den);
      const float2 sp = max_split(fabsf(nq), gp[2 * S + t], dden);
      const float sgn = nq > 0.f ? 1.f : (nq < 0.f ? -1.f : 0.f);
      const float dnq = __fmul_rn(sp.x, sgn);
      float sfw = 0.f;
      for (int c = 0; c < NTILE; ++c) sfw = __fadd_rn(sfw, ps[c * S + t]);
      ps[NTILE * S + t] = dnq;
      ps[(NTILE + 1) * S + t] = sp.y;      // dem
      ps[(NTILE + 2) * S + t] = y;         // diw's G term
      ps[(NTILE + 3) * S + t] = sfw;       // dfw's G term
      sdnq[j] = dnq;
    }
  }
  __syncthreads();
  for (int j = 0; j < nt; ++j) {
    const long long r = (bh * S + t0 + j) * HD + d;
    p.dq[r] = fmaf(p.nS[r], sdnq[j], spq[j][d]);
  }
}

// ---------------------------------------------------------------- chain --
template <int HD>
struct ChainSmem {
  // a chunk's q, ks, G v and n_{t-1} rows and its steps' scalars, two
  // chunks deep
  __align__(16) float rows[2][4][HCH][HD];
  float sc[2][10][HCH];         // dnq dem diw_G dfw_G fw iw em a i f
  float red[HD / 32][2 * HCH];  // each warp's sums of dn n_{t-1}, dn ks
  // a step's dem exp(-m), dfw fw, diw iw, 1 + exp(f) and which of a, i
  // the max took; then the dm chain's da and the max's share to i
  float X[HCH], Y[HCH], Z[HCH], ef[HCH], da[HCH], msy[HCH];
  int cmp[HCH];
};

// a block a bh: dn's reverse chain a row a thread (its inputs read first,
// then the chain alone, then dk and the two products of each step), the
// products' sums over the rows (a warp's butterfly that leaves lane l
// with value l, then the warps in order), the dm chain's terms a thread a
// step, the scalar dm chain alone on one thread; di and df of the chunk
// follow in parallel
template <int HD>
__global__ void __launch_bounds__(HD) mlstm_bwd_chain(const Params p) {
  constexpr int W = HD / 32, NTILE = HD / EC, NCL = HD / EC / CL;
  static_assert(2 * HCH == 32, "a chunk's products are a warp's values");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChainSmem<HD>& sm = *reinterpret_cast<ChainSmem<HD>*>(smem_raw);
  float* __restrict__ dk = p.dk;
  const long long bh = blockIdx.x;
  const int d = threadIdx.x, lane = d & 31, w = d >> 5;
  const int S = p.S;
  const float* gp = p.gates + bh * NG * S;
  const float* ps = p.pscal + (bh * (NTILE + 4) + NTILE) * S;
  const float* pkb = p.pdk + bh * NCL * S * HD;
  const int chunks = (S + HCH - 1) / HCH;
  // chunk k into buffer u
  auto stage = [&](int k, int u) {
    const int t0 = k * HCH, nt = min(HCH, S - t0);
    const long long r0 = (bh * S + t0) * HD;
    for (int x = d; x < nt * HD / 4; x += HD) {
      tma::copy_async<16>(&sm.rows[u][0][0][0] + 4 * x, p.q + r0 + 4 * x);
      tma::copy_async<16>(&sm.rows[u][1][0][0] + 4 * x, p.ks + r0 + 4 * x);
      tma::copy_async<16>(&sm.rows[u][2][0][0] + 4 * x,
                          pkb + (long long)t0 * HD + 4 * x);
      const int j = 4 * x / HD;  // n_{t-1}: n0 before the first step
      tma::copy_async<16>(&sm.rows[u][3][0][0] + 4 * x,
                          t0 + j > 0 ? p.nS + r0 - HD + 4 * x
                                     : p.n0 + bh * HD + 4 * x - j * HD);
    }
    if (d < nt) {
      const float* src[10] = {ps, ps + S, ps + 2 * S, ps + 3 * S, gp,
                              gp + S, gp + 2 * S, gp + 5 * S,
                              p.ig + bh * S, p.fg + bh * S};
#pragma unroll
      for (int k2 = 0; k2 < 10; ++k2)
        tma::copy_async<4>(&sm.sc[u][k2][d], src[k2] + t0 + d);
    }
  };
  // di and df of chunk k from its da and the max's shares
  auto finish = [&](int k) {
    const int t0 = k * HCH;
    if (d < min(HCH, S - t0)) {
      p.di[bh * S + t0 + d] = __fadd_rn(sm.Z[d], sm.msy[d]);
      p.df[bh * S + t0 + d] = __fdiv_rn(sm.da[d], sm.ef[d]);
    }
  };
  float dn = p.dn1[bh * HD + d];
  float dm = p.dm1[bh];
  if (chunks > 0) stage(chunks - 1, 0);
  int u = 0;
  for (int k = chunks - 1; k >= 0; --k, u ^= 1) {
    const int t0 = k * HCH, nt = min(HCH, S - t0);
    tma::copy_wait();
    __syncthreads();            // the chunk has landed; the last is done
    if (k + 1 < chunks) finish(k + 1);
    if (k > 0) stage(k - 1, u ^ 1);
    const float(*sc)[HCH] = sm.sc[u];
    float v[2 * HCH];           // the steps' dn n_{t-1}, then dn ks
    auto dn_walk = [&](auto full) {
      constexpr bool F = decltype(full)::value;
      float qv[HCH], dnq[HCH], fw[HCH], dnt[HCH];
#pragma unroll
      for (int j = 0; j < HCH; ++j) {
        qv[j] = sm.rows[u][0][j][d];
        dnq[j] = sc[0][j];
        fw[j] = sc[4][j];
      }
#pragma unroll
      for (int j = HCH - 1; j >= 0; --j) {
        if (F || j < nt) {
          dnt[j] = fmaf(qv[j], dnq[j], dn);  // the gradient of n_t
          dn = __fmul_rn(dnt[j], fw[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < HCH; ++j) {
        v[j] = v[HCH + j] = 0.f;
        if (F || j < nt) {
          dk[(bh * S + t0 + j) * HD + d] = __fmul_rn(
              __fmul_rn(sc[5][j], __fadd_rn(sm.rows[u][2][j][d], dnt[j])),
              p.scale);
          v[j] = __fmul_rn(dnt[j], sm.rows[u][3][j][d]);
          v[HCH + j] = __fmul_rn(dnt[j], sm.rows[u][1][j][d]);
        }
      }
    };
    if (nt == HCH)
      dn_walk(std::true_type{});
    else
      dn_walk(std::false_type{});
    warp_halve<HCH>(v, lane);   // lane l: the warp's sum of value l
    sm.red[w][lane] = v[0];
    __syncthreads();            // the warps' sums
    if (d < nt) {               // step d's terms of the dm chain
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int ww = 0; ww < W; ++ww) {
        x = __fadd_rn(x, sm.red[ww][d]);
        y = __fadd_rn(y, sm.red[ww][HCH + d]);
      }
      const float dfw = __fadd_rn(sc[3][d], x);
      const float diw = __fadd_rn(sc[2][d], y);
      const float a = sc[7][d], it = sc[8][d];
      sm.X[d] = __fmul_rn(sc[1][d], sc[6][d]);
      sm.Y[d] = __fmul_rn(dfw, sc[4][d]);
      sm.Z[d] = __fmul_rn(diw, sc[5][d]);
      sm.ef[d] = __fadd_rn(1.f, expf(sc[9][d]));
      sm.cmp[d] = a > it ? 0 : (it > a ? 1 : 2);
    }
    __syncthreads();            // the chunk's dm terms
    if (d == 0) {               // the dm chain: its terms first, then alone
      float X[HCH], Y[HCH], Z[HCH], da[HCH], sy[HCH];
      int cmp[HCH];
#pragma unroll
      for (int j = 0; j < HCH; ++j) {
        X[j] = sm.X[j];
        Y[j] = sm.Y[j];
        Z[j] = sm.Z[j];
        cmp[j] = sm.cmp[j];
      }
#pragma unroll
      for (int j = HCH - 1; j >= 0; --j) {
        if (j < nt) {
          const float dmt = __fsub_rn(__fsub_rn(__fsub_rn(dm, X[j]), Y[j]),
                                      Z[j]);
          // max_split(a, i, dmt)
          const float sx = cmp[j] == 0 ? dmt
                                       : (cmp[j] == 1 ? 0.f : 0.5f * dmt);
          sy[j] = cmp[j] == 1 ? dmt : (cmp[j] == 0 ? 0.f : 0.5f * dmt);
          dm = __fadd_rn(Y[j], sx);
          da[j] = dm;
        }
      }
#pragma unroll
      for (int j = 0; j < HCH; ++j) {
        if (j < nt) {
          sm.da[j] = da[j];
          sm.msy[j] = sy[j];
        }
      }
    }
  }
  __syncthreads();              // chunk 0's da
  if (chunks > 0) finish(0);
  p.dn0[bh * HD + d] = dn;
  if (d == 0) p.dm0[bh] = dm;
}

template <typename K>
cudaError_t smem_attr(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const int gsm = (int)sizeof(GateSmem<HD>);
  const int csm = (int)sizeof(ColSmem<HD>);
  const int hsm = (int)sizeof(ChainSmem<HD>);
  cudaError_t err = smem_attr(mlstm_bwd_gates<HD>, gsm);
  if (err == cudaSuccess) err = smem_attr(mlstm_bwd_columns<HD>, csm);
  if (err == cudaSuccess) err = smem_attr(mlstm_bwd_chain<HD>, hsm);
  if (err != cudaSuccess) return err;
  mlstm_bwd_gates<HD><<<p.BH, HD, gsm, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.S > 0) {
    mlstm_bwd_den<HD><<<dim3((p.S + DCH - 1) / DCH, p.BH), HD, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  mlstm_bwd_columns<HD><<<dim3(HD / EC, p.BH), HD, csm, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.S > 0) {
    mlstm_bwd_sums<HD><<<dim3((p.S + HCH - 1) / HCH, p.BH), HD, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  mlstm_bwd_chain<HD><<<p.BH, HD, hsm, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, ks (k times scale), v, dh: (BH,S,hd); ig, fg: (BH,S); C0, dC1:
// (BH,hd,hd); n0, dn1: (BH,hd); m0, dm1: (BH,); outputs dq, dk (k's
// gradient: scale times ks's), dv (BH,S,hd), di, df (BH,S), dC0, dn0, dm0
// shaped as the state; scratch gates (BH,7,S), n_steps and dnum (BH,S,hd),
// C_ck (BH, hd/4, ceil(S/8), hd, 4), p_scal (BH, hd/4 + 4, S), p_dq and
// p_dk (BH, hd/32, S, hd). All fp32, contiguous, 16-byte aligned, on the
// device. hd in {32, 64, 128, 192}; any other returns
// cudaErrorInvalidValue. Launches on `stream` and returns the first launch
// error, or cudaGetLastError().
extern "C" int mlstm_scan_bwd_f32(
    const void* q, const void* ks, const void* v, const void* ig,
    const void* fg, const void* C0, const void* n0, const void* m0,
    const void* dh, const void* dC1, const void* dn1, const void* dm1,
    void* dq, void* dk, void* dv, void* di, void* df, void* dC0, void* dn0,
    void* dm0, void* gates, void* n_steps, void* dnum, void* C_ck,
    void* p_scal, void* p_dq, void* p_dk, int BH, int S, int hd,
    float scale, void* stream) {
  if (BH < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (hd != 32 && hd != 64 && hd != 128 && hd != 192)
    return (int)cudaErrorInvalidValue;
  if (BH == 0) return (int)cudaSuccess;
  const Params p{(const float*)q, (const float*)ks, (const float*)v,
                 (const float*)ig, (const float*)fg, (const float*)C0,
                 (const float*)n0, (const float*)m0, (const float*)dh,
                 (const float*)dC1, (const float*)dn1, (const float*)dm1,
                 (float*)dq, (float*)dk, (float*)dv, (float*)di, (float*)df,
                 (float*)dC0, (float*)dn0, (float*)dm0, (float*)gates,
                 (float*)n_steps, (float*)dnum, (float*)C_ck, (float*)p_scal,
                 (float*)p_dq, (float*)p_dk, BH, S, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32: return (int)launch<32>(p, st);
    case 64: return (int)launch<64>(p, st);
    case 128: return (int)launch<128>(p, st);
    default: return (int)launch<192>(p, st);
  }
}
