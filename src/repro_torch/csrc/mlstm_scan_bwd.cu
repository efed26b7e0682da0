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
// ~54 us at 67 TFLOP/s. The sequential chain over S is what sets the
// time of this first kernel.
//
// Design (correct and simple first): three launches from one C entry
// point, in order on one stream.
//   * gates: a warp a bh steps the forward's gate chain and n (lane l
//     holds rows l, l + 32, ...) with the forward kernel's operations, and
//     writes each step's fw, iw, exp(-m), n . q, den, a and m and each
//     step's n to scratch. n . q is each lane's rows in order, then a
//     butterfly over the lanes, lane 0's bits.
//   * columns: the forward's split of C, a block a (tile of EC = 8
//     columns, bh), 8 row groups x EC threads, thread (g, l) holding the
//     rows [g hd/8, (g+1) hd/8) of column tile*8 + l. It steps C forward
//     from C0 with the forward's operations (so C meets the forward's
//     bits) and writes C every CK = 8 steps to scratch; then, CK steps at
//     a time from the last, it recomputes those steps' C into shared
//     memory and steps G back over them. Each step's sums over its rows
//     and columns go through shared memory in a fixed order (a row's over
//     the block's columns in order, a column's over the row groups in
//     order, then the tile's scalars over its columns in order): the
//     tile's partials of dq and dks's G v (rows), dv (whole: a column's
//     rows are all in the block), and the tile's partial sums of dh . num,
//     v . G^T ks and <G, C_{t-1}>. After the first step it writes G as
//     dC0.
//   * heads: a block of hd threads a bh steps back over t: sums the
//     tiles' partials in tile order, adds the n terms (dn is carried
//     here, a row a thread; its two dot products a warp butterfly, then
//     the warps in order), and runs the gates' reverse chain.
// No atomics and every sum in a fixed order: two calls give the same
// bits.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RG = 8;           // row groups of a column tile
constexpr int EC = 8;           // columns of C a block (the backward's)
constexpr int CK = 8;           // steps between two checkpoints of C
constexpr int NG = 7;           // gate planes: fw iw em nq den a m
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float *q, *ks, *v, *ig, *fg, *C0, *n0, *m0, *dh, *dC1, *dn1, *dm1;
  float *dq, *dk, *dv, *di, *df, *dC0, *dn0, *dm0;
  float *gates, *nS, *Cck, *pscal, *pdq, *pdk;
  int BH, S;
  float scale;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  // the forward kernel's: min(x, 0) - log1p(exp(-|x|))
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float* gate(const Params& p, long long bh,
                                       int plane, int t) {
  return p.gates + (bh * NG + plane) * p.S + t;
}

// ---------------------------------------------------------------- gates --
template <int HD>
__global__ void __launch_bounds__(32) mlstm_bwd_gates(const Params p) {
  constexpr int R = HD / 32;
  const long long bh = blockIdx.x;
  const int lane = threadIdx.x;
  const int S = p.S;
  float n[R];
#pragma unroll
  for (int r = 0; r < R; ++r) n[r] = p.n0[bh * HD + lane + 32 * r];
  float m = p.m0[bh];
  for (int t = 0; t < S; ++t) {
    const long long row = (bh * S + t) * HD;
    const float it = p.ig[bh * S + t];
    const float a = __fadd_rn(log_sigmoid(p.fg[bh * S + t]), m);
    const float mn = fmaxf(a, it);
    const float fw = expf(__fsub_rn(a, mn));
    const float iw = expf(__fsub_rn(it, mn));
    const float em = expf(-mn);
    float nq = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int d = lane + 32 * r;
      n[r] = __fadd_rn(__fmul_rn(n[r], fw), __fmul_rn(iw, p.ks[row + d]));
      nq = fmaf(n[r], p.q[row + d], nq);
      p.nS[row + d] = n[r];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) nq += __shfl_xor_sync(FULL, nq, o);
    nq = __shfl_sync(FULL, nq, 0);
    if (lane == 0) {
      *gate(p, bh, 0, t) = fw;
      *gate(p, bh, 1, t) = iw;
      *gate(p, bh, 2, t) = em;
      *gate(p, bh, 3, t) = nq;
      *gate(p, bh, 4, t) = fmaxf(fabsf(nq), em);
      *gate(p, bh, 5, t) = a;
      *gate(p, bh, 6, t) = mn;
    }
    m = mn;
  }
}

// -------------------------------------------------------------- columns --
template <int HD>
struct ColSmem {
  static constexpr int RPT = HD / RG;
  static constexpr int CSTR = HD * EC + RG * 8;  // a step of Cs, padded
  static constexpr int FLOATS = (CK + 1) * CSTR + 2 * CK * HD + 2 * CK * EC
                                + 3 * CK + 2 * HD * (EC + 1) + 3 * RG * EC
                                + 3 * EC;
};

template <int HD>
__global__ void __launch_bounds__(EC * RG) mlstm_bwd_columns(const Params p) {
  using L = ColSmem<HD>;
  constexpr int RPT = L::RPT, NTILE = HD / EC;
  extern __shared__ float smem[];
  float* Cs = smem;                               // [CK+1] steps of C
  float* sq = Cs + (CK + 1) * L::CSTR;            // [CK][HD]
  float* sk = sq + CK * HD;                       // [CK][HD]
  float* sv = sk + CK * HD;                       // [CK][EC]
  float* sdh = sv + CK * EC;                      // [CK][EC]
  float* sg = sdh + CK * EC;                      // [3][CK] fw iw den
  float* rows_a = sg + 3 * CK;                    // [HD][EC+1] C dnum
  float* rows_b = rows_a + HD * (EC + 1);         // [HD][EC+1] G v
  float* cols = rows_b + HD * (EC + 1);           // [3][RG][EC]
  float* cout = cols + 3 * RG * EC;               // [3][EC]

  const int tile = blockIdx.x;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int l = tid % EC, g = tid / EC;
  const int e = tile * EC + l;
  const int d0 = g * RPT;
  const int S = p.S;
  const int chunks = (S + CK - 1) / CK;
  const long long qrow0 = bh * S;
  auto cs = [&](int j, int r) -> float& {
    return Cs[j * L::CSTR + (d0 + r) * EC + l + g * 8];
  };
  auto ck_at = [&](int k, int r) {   // (bh, chunk k, row, column)
    return ((bh * chunks + k) * HD + d0 + r) * HD + e;
  };

  // forward: C at the start of every chunk
  float c[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) c[r] = p.C0[(bh * HD + d0 + r) * HD + e];
  for (int k = 0; k < chunks; ++k) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) p.Cck[ck_at(k, r)] = c[r];
    const int nt = min(CK, S - k * CK);
    for (int j = 0; j < nt; ++j) {
      const int t = k * CK + j;
      const float fw = *gate(p, bh, 0, t), iw = *gate(p, bh, 1, t);
      const float ve = p.v[(qrow0 + t) * HD + e];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float kd = p.ks[(qrow0 + t) * HD + d0 + r];
        c[r] = __fadd_rn(__fmul_rn(c[r], fw),
                         __fmul_rn(iw, __fmul_rn(kd, ve)));
      }
    }
  }

  // reverse, a chunk at a time from the last
  float G[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) G[r] = p.dC1[(bh * HD + d0 + r) * HD + e];
  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * CK, nt = min(CK, S - t0);
    __syncthreads();            // the last chunk's shared values are read
    for (int x = tid; x < nt * HD; x += EC * RG) {
      sq[x] = p.q[(qrow0 + t0) * HD + x];
      sk[x] = p.ks[(qrow0 + t0) * HD + x];
    }
    for (int x = tid; x < nt * EC; x += EC * RG) {
      const int j = x / EC, ll = x % EC;
      sv[x] = p.v[(qrow0 + t0 + j) * HD + tile * EC + ll];
      sdh[x] = p.dh[(qrow0 + t0 + j) * HD + tile * EC + ll];
    }
    for (int x = tid; x < 3 * nt; x += EC * RG) {
      const int w = x / nt, j = x % nt;
      sg[w * CK + j] = *gate(p, bh, w == 2 ? 4 : w, t0 + j);
    }
    __syncthreads();
    // this chunk's C, recomputed from its checkpoint
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      c[r] = p.Cck[ck_at(k, r)];
      cs(0, r) = c[r];
    }
    for (int j = 0; j < nt; ++j) {
      const float fw = sg[j], iw = sg[CK + j], ve = sv[j * EC + l];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        c[r] = __fadd_rn(__fmul_rn(c[r], fw),
                         __fmul_rn(iw, __fmul_rn(sk[j * HD + d0 + r], ve)));
        cs(j + 1, r) = c[r];
      }
    }
    for (int j = nt - 1; j >= 0; --j) {
      const int t = t0 + j;
      const float fw = sg[j], iw = sg[CK + j], den = sg[2 * CK + j];
      const float ve = sv[j * EC + l];
      const float dnum = __fdiv_rn(sdh[j * EC + l], den);
      float gks = 0.f, num = 0.f, gcp = 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int d = d0 + r;
        const float qd = sq[j * HD + d], kd = sk[j * HD + d];
        const float ct = cs(j + 1, r);
        G[r] = fmaf(qd, dnum, G[r]);
        rows_a[d * (EC + 1) + l] = __fmul_rn(ct, dnum);
        rows_b[d * (EC + 1) + l] = __fmul_rn(G[r], ve);
        gks = fmaf(G[r], kd, gks);
        num = fmaf(ct, qd, num);
        gcp = fmaf(G[r], cs(j, r), gcp);
      }
      cols[(0 * RG + g) * EC + l] = gks;
      cols[(1 * RG + g) * EC + l] = num;
      cols[(2 * RG + g) * EC + l] = gcp;
      __syncthreads();          // the step's row and column partials
      const long long prow = ((bh * NTILE + tile) * S + t) * HD;
      for (int d = tid; d < HD; d += EC * RG) {
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int ll = 0; ll < EC; ++ll) {
          sa = __fadd_rn(sa, rows_a[d * (EC + 1) + ll]);
          sb = __fadd_rn(sb, rows_b[d * (EC + 1) + ll]);
        }
        p.pdq[prow + d] = sa;
        p.pdk[prow + d] = sb;
      }
      if (tid < EC) {
        float cg = 0.f, cn = 0.f, cc = 0.f;
#pragma unroll
        for (int w = 0; w < RG; ++w) {
          cg = __fadd_rn(cg, cols[(0 * RG + w) * EC + tid]);
          cn = __fadd_rn(cn, cols[(1 * RG + w) * EC + tid]);
          cc = __fadd_rn(cc, cols[(2 * RG + w) * EC + tid]);
        }
        p.dv[(qrow0 + t) * HD + tile * EC + tid] = __fmul_rn(iw, cg);
        cout[tid] = __fmul_rn(sv[j * EC + tid], cg);
        cout[EC + tid] = __fmul_rn(sdh[j * EC + tid], cn);
        cout[2 * EC + tid] = cc;
      }
      __syncthreads();          // the tile's column sums
      if (tid == 0) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int ll = 0; ll < EC; ++ll) {
          s0 = __fadd_rn(s0, cout[EC + ll]);
          s1 = __fadd_rn(s1, cout[ll]);
          s2 = __fadd_rn(s2, cout[2 * EC + ll]);
        }
        float* ps = p.pscal + (bh * NTILE + tile) * 3 * S + t;
        ps[0] = s0;             // dh . num over the tile's columns
        ps[S] = s1;             // v . G^T ks
        ps[2 * S] = s2;         // <G, C_{t-1}>
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) G[r] = __fmul_rn(G[r], fw);
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) p.dC0[(bh * HD + d0 + r) * HD + e] = G[r];
}

// ---------------------------------------------------------------- heads --
// the sum of one value a thread over the block's HD threads: a butterfly
// a warp, then the warps in order; every thread gets the same bits
template <int HD>
__device__ __forceinline__ float block_sum(float v, float* red) {
  constexpr int W = HD / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();              // red's last values are read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < W; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

// the max's share of a cotangent: (to x, to y) for max(x, y), half each
// on a tie
__device__ __forceinline__ float2 max_split(float x, float y, float g) {
  if (x > y) return make_float2(g, 0.f);
  if (y > x) return make_float2(0.f, g);
  return make_float2(0.5f * g, 0.5f * g);
}

template <int HD>
__global__ void __launch_bounds__(HD) mlstm_bwd_heads(const Params p) {
  constexpr int NTILE = HD / EC;
  __shared__ float red[HD / 32];
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const int S = p.S;
  float dn = p.dn1[bh * HD + d];
  float dm = p.dm1[bh];
  for (int t = S - 1; t >= 0; --t) {
    const long long row = (bh * S + t) * HD;
    const float fw = *gate(p, bh, 0, t), iw = *gate(p, bh, 1, t);
    const float em = *gate(p, bh, 2, t), nq = *gate(p, bh, 3, t);
    const float den = *gate(p, bh, 4, t), a = *gate(p, bh, 5, t);
    const float it = p.ig[bh * S + t], ft = p.fg[bh * S + t];
    float snum = 0.f, sdiw = 0.f, sdfw = 0.f, pq = 0.f, pk = 0.f;
    for (int k = 0; k < NTILE; ++k) {
      const float* ps = p.pscal + (bh * NTILE + k) * 3 * S + t;
      snum = __fadd_rn(snum, ps[0]);
      sdiw = __fadd_rn(sdiw, ps[S]);
      sdfw = __fadd_rn(sdfw, ps[2 * S]);
      const long long prow = ((bh * NTILE + k) * S + t) * HD + d;
      pq = __fadd_rn(pq, p.pdq[prow]);
      pk = __fadd_rn(pk, p.pdk[prow]);
    }
    const float dden = -__fdiv_rn(snum, __fmul_rn(den, den));
    const float2 sp = max_split(fabsf(nq), em, dden);
    const float sgn = nq > 0.f ? 1.f : (nq < 0.f ? -1.f : 0.f);
    const float dnq = __fmul_rn(sp.x, sgn), dem = sp.y;
    const float nt = p.nS[row + d];
    const float np = t > 0 ? p.nS[row - HD + d] : p.n0[bh * HD + d];
    const float kd = p.ks[row + d];
    dn = fmaf(p.q[row + d], dnq, dn);              // the gradient of n_t
    p.dq[row + d] = fmaf(nt, dnq, pq);
    p.dk[row + d] = __fmul_rn(__fmul_rn(iw, __fadd_rn(pk, dn)), p.scale);
    const float dfw = __fadd_rn(sdfw, block_sum<HD>(__fmul_rn(dn, np), red));
    const float diw = __fadd_rn(sdiw, block_sum<HD>(__fmul_rn(dn, kd), red));
    const float dmt = __fsub_rn(
        __fsub_rn(__fsub_rn(dm, __fmul_rn(dem, em)), __fmul_rn(dfw, fw)),
        __fmul_rn(diw, iw));
    const float2 ms = max_split(a, it, dmt);
    const float da = __fadd_rn(__fmul_rn(dfw, fw), ms.x);
    if (d == 0) {
      p.di[bh * S + t] = __fadd_rn(__fmul_rn(diw, iw), ms.y);
      p.df[bh * S + t] = __fdiv_rn(da, __fadd_rn(1.f, expf(ft)));
    }
    dm = da;
    dn = __fmul_rn(dn, fw);
  }
  p.dn0[bh * HD + d] = dn;
  if (d == 0) p.dm0[bh] = dm;
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t st) {
  mlstm_bwd_gates<HD><<<p.BH, 32, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = ColSmem<HD>::FLOATS * 4;
  err = cudaFuncSetAttribute(mlstm_bwd_columns<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  mlstm_bwd_columns<HD><<<dim3(HD / EC, p.BH), EC * RG, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_heads<HD><<<p.BH, HD, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, ks (k times scale), v, dh: (BH,S,hd); ig, fg: (BH,S); C0, dC1:
// (BH,hd,hd); n0, dn1: (BH,hd); m0, dm1: (BH,); outputs dq, dk (k's
// gradient: scale times ks's), dv (BH,S,hd), di, df (BH,S), dC0, dn0, dm0
// shaped as the state; scratch gates (BH,7,S), n_steps (BH,S,hd), C_ck
// (BH, ceil(S/8), hd, hd), p_scal (BH, hd/8, 3, S), p_dq and p_dk (BH,
// hd/8, S, hd). All fp32, contiguous, on the device. hd in {32, 64, 128,
// 192}; any other returns cudaErrorInvalidValue. Launches on `stream`
// and returns the first launch error, or cudaGetLastError().
extern "C" int mlstm_scan_bwd_f32(
    const void* q, const void* ks, const void* v, const void* ig,
    const void* fg, const void* C0, const void* n0, const void* m0,
    const void* dh, const void* dC1, const void* dn1, const void* dm1,
    void* dq, void* dk, void* dv, void* di, void* df, void* dC0, void* dn0,
    void* dm0, void* gates, void* n_steps, void* C_ck, void* p_scal,
    void* p_dq, void* p_dk, int BH, int S, int hd, float scale,
    void* stream) {
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
                 (float*)n_steps, (float*)C_ck, (float*)p_scal, (float*)p_dq,
                 (float*)p_dk, BH, S, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32: return (int)launch<32>(p, st);
    case 64: return (int)launch<64>(p, st);
    case 128: return (int)launch<128>(p, st);
    default: return (int)launch<192>(p, st);
  }
}
