// Ragged causal GQA flash attention for Hopper (sm_90a), fp32, forward and
// backward, with a plain C interface (loaded with ctypes).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention/kernel.py:
//   flash_fwd     <- flash_attention / _fwd_call / _fwd_kernel
//   flash_bwd_dq  <- flash_attention_bwd / _bwd_call / _dq_kernel
//   flash_bwd_dkv <- flash_attention_bwd / _bwd_call / _dkv_kernel
//                    (and the GQA group-sum the reference does outside)
//
// Semantics (identical to the reference):
//   q (B,S,H,D), k/v (B,T,Hkv,D), all contiguous fp32; query head h reads
//   kv head h / (H/Hkv).  Queries are right-aligned when S < T: query row i
//   sits at key position i + (T - S).  Causal, sliding `window` (0 = none)
//   and tanh `softcap` (0 = none) masks; masked scores are NEG_INF = -1e30,
//   l_safe = max(l, 1e-20), lse = m + log(l_safe).  Batch rows b >= num_valid
//   write exact zeros to every output (downstream masked sums multiply them
//   by 0, and 0 * NaN would poison the gradient).  num_valid is read from
//   device memory, so the caller never syncs with the host for it.
//
// What bounds it on an H100: at the training shapes (S = T = 1024, D = 256,
// causal) each q tile meets up to 16 kv tiles, ~64 flops per byte moved from
// device memory, so the bound is arithmetic: 67 TFLOP/s of fp32 outside the
// tensor cores.  These first versions run on the CUDA cores and are limited
// by shared-memory bandwidth in their inner products; tensor cores (TF32 or
// bf16 wgmma) and TMA pipelining are the later step.
//
// Design.  The TPU kernel walks a sequential grid axis over kv blocks and
// carries (m, l, acc) in VMEM scratch between grid steps.  Blocks on a GPU run
// in no order, so each block here owns one output tile and loops over the
// other axis itself, keeping its accumulators in registers:
//   * 256 threads as a 16 x 16 grid (tx, ty); thread (tx, ty) owns score rows
//     ty + 16 i and score columns tx + 16 j of a tile, and output columns
//     tx + 16 k.  A row's 16 owners are 16 lanes of one warp, so row max and
//     row sum are warp shuffles.
//   * tiles live in shared memory with a row stride of D + 1 floats so that
//     the column walks of the inner products hit distinct banks.  At D = 256
//     a block holds ~210 KB, above the 48 KB default, so every launch first
//     raises the block's dynamic shared-memory limit.
//   * tiles that no visible (q, k) pair reaches are skipped
//     (_tile_visible in the reference); num_valid-padded blocks exit at once.
//   * the 128-lane head_dim padding of the TPU version is not carried over:
//     D is a template parameter over {32, 64, 128, 256}.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;  // threads per block (16 x 16)

struct Geom {
  int B, S, T, H, Hkv;
  int causal, window;
  float softcap, sm_scale;
};

__device__ __forceinline__ int num_valid_rows(const int* nv, int B) {
  return nv ? *nv : B;
}

// Does any pair of (query rows [q_first, q_last], keys [k_first, k_last])
// survive the masks?  Positions are absolute key positions.
__device__ __forceinline__ bool tile_visible(int q_first, int q_last,
                                             int k_first, int k_last,
                                             const Geom& g) {
  if (g.causal && k_first > q_last) return false;
  if (g.window > 0 && k_last <= q_first - g.window) return false;
  return true;
}

__device__ __forceinline__ bool pair_visible(int qpos, int kpos,
                                             const Geom& g) {
  if (kpos >= g.T) return false;
  if (g.causal && kpos > qpos) return false;
  if (g.window > 0 && kpos <= qpos - g.window) return false;
  return true;
}

__device__ __forceinline__ float soft(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [row0, row0 + nrows) of head `head` of a (B, L, NH, D) tensor into a
// shared tile with row stride `stride`; rows past L are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* __restrict__ src,
                                          int b, int row0, int nrows, int L,
                                          int NH, int head) {
  for (int i = threadIdx.x; i < nrows * D; i += NT) {
    const int r = i / D, c = i % D, row = row0 + r;
    dst[r * stride + c] =
        row < L ? src[((size_t)(b * L + row) * NH + head) * D + c] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void zero_rows(float* __restrict__ dst, int b,
                                          int row0, int nrows, int L, int NH,
                                          int head) {
  for (int i = threadIdx.x; i < nrows * D; i += NT) {
    const int r = i / D, c = i % D, row = row0 + r;
    if (row < L) dst[((size_t)(b * L + row) * NH + head) * D + c] = 0.f;
  }
}

// ------------------------------------------------------------------ forward

template <int D>
struct FwdCfg {
  static constexpr int BQ = 64, BK = 64, DP = D + 1, PP = BK + 1;
  static constexpr size_t smem =
      (size_t)(BQ * DP + BK * DP + BK * D + BQ * PP) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ nv_ptr,
               float* __restrict__ out, float* __restrict__ lse, Geom g) {
  using C = FwdCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, DP = C::DP, PP = C::PP;
  constexpr int RQ = BQ / 16, CK = BK / 16, DK = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP
  float* Ks = Qs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;    // BK x D
  float* Ps = Vs + BK * D;     // BQ x PP

  const int nq = gridDim.x;
  const int iq = nq - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (g.H / g.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = iq * BQ;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    zero_rows<D>(out, b, row0, BQ, g.S, g.H, h);
    for (int r = threadIdx.x; r < BQ; r += NT)
      if (row0 + r < g.S) lse[((size_t)b * g.H + h) * g.S + row0 + r] = 0.f;
    return;
  }

  load_tile<D>(Qs, DP, q, b, row0, BQ, g.S, g.H, h);

  float m[RQ], l[RQ], acc[RQ][DK];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) acc[i][kk] = 0.f;
  }

  const int shift = g.T - g.S;
  const int q_first = row0 + shift, q_last = q_first + BQ - 1;
  const int nk = (g.T + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k_first = ik * BK;
    if (!tile_visible(q_first, q_last, k_first, k_first + BK - 1, g)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, DP, k, b, k_first, BK, g.T, g.Hkv, kvh);
    load_tile<D>(Vs, D, v, b, k_first, BK, g.T, g.Hkv, kvh);
    __syncthreads();

    float sc[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RQ], bk[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) bk[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = row0 + ty + 16 * i + shift;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        float s = soft(sc[i][j] * g.sm_scale, g.softcap);
        if (!pair_visible(qpos, k_first + tx + 16 * j, g)) s = NEG_INF;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      const float m_cur = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_cur);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(sc[i][j] - m_cur);
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + row_sum16(ps);
      m[i] = m_cur;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) acc[i][kk] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float vv[DK];
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) vv[kk] = Vs[c * D + tx + 16 * kk];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) acc[i][kk] = fmaf(p, vv[kk], acc[i][kk]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = row0 + ty + 16 * i;
    if (s >= g.S) continue;
    const float l_safe = fmaxf(l[i], 1e-20f);
    float* o = out + ((size_t)(b * g.S + s) * g.H + h) * D;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) o[tx + 16 * kk] = acc[i][kk] / l_safe;
    if (tx == 0) lse[((size_t)b * g.H + h) * g.S + s] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------- backward
//
// Per visible (q tile, kv tile) pair, as in the reference's _bwd_tile:
//   s_soft = softcap(q k^T * sm_scale)    p  = exp(s_soft - lse), masked to 0
//   dp = dO v^T                           ds = p (dp - delta) [* (1 - (s_soft/cap)^2)]
//   dq += ds k * sm_scale   dk += ds^T q * sm_scale   dv += p^T dO

// scores and dO v^T of one tile: thread rows ty + 16 i, columns tx + 16 j;
// writes p and ds for those entries into shared P / dS tiles
template <int D, int RQ, int CK, int PP>
__device__ __forceinline__ void bwd_tile(const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs,
                                         const float* lse_r,
                                         const float* delta_r, int row0,
                                         int k_first, const Geom& g,
                                         float* Ps, float* dSs) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RQ], ao[RQ], bk[CK], bv[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      a[i] = Qs[(ty + 16 * i) * DP + d];
      ao[i] = dOs[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      bk[j] = Ks[(tx + 16 * j) * DP + d];
      bv[j] = Vs[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
        dp[i][j] = fmaf(ao[i], bv[j], dp[i][j]);
      }
  }
  const int shift = g.T - g.S;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    const int qpos = row0 + r + shift;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int c = tx + 16 * j;
      const float s_soft = soft(sc[i][j] * g.sm_scale, g.softcap);
      float p = 0.f, ds = 0.f;
      if (pair_visible(qpos, k_first + c, g) && row0 + r < g.S) {
        p = expf(s_soft - lse_r[r]);
        ds = p * (dp[i][j] - delta_r[r]);
        if (g.softcap > 0.f) {
          const float t = s_soft / g.softcap;
          ds *= 1.f - t * t;
        }
      }
      if (Ps) Ps[r * PP + c] = p;
      dSs[r * PP + c] = ds;
    }
  }
}

template <int D>
struct DqCfg {
  static constexpr int BQ = 64, BK = 32, DP = D + 1, PP = BK + 1;
  static constexpr size_t smem =
      (size_t)(2 * BQ * DP + 2 * BK * DP + BQ * PP + 2 * BQ) * sizeof(float);
};

// one block per (b, q head, q tile), looping over kv tiles
template <int D>
__global__ void __launch_bounds__(NT)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ nv_ptr, float* __restrict__ dq, Geom g) {
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, DP = C::DP, PP = C::PP;
  constexpr int RQ = BQ / 16, CK = BK / 16, DK = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x DP
  float* dOs = Qs + BQ * DP;    // BQ x DP
  float* Ks = dOs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;     // BK x DP
  float* dSs = Vs + BK * DP;    // BQ x PP
  float* lse_r = dSs + BQ * PP; // BQ
  float* delta_r = lse_r + BQ;  // BQ

  const int nq = gridDim.x;
  const int iq = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (g.H / g.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = iq * BQ;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    zero_rows<D>(dq, b, row0, BQ, g.S, g.H, h);
    return;
  }

  load_tile<D>(Qs, DP, q, b, row0, BQ, g.S, g.H, h);
  load_tile<D>(dOs, DP, dout, b, row0, BQ, g.S, g.H, h);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const bool in = row0 + r < g.S;
    const size_t at = ((size_t)b * g.H + h) * g.S + row0 + r;
    lse_r[r] = in ? lse[at] : 0.f;
    delta_r[r] = in ? delta[at] : 0.f;
  }

  float acc[RQ][DK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) acc[i][kk] = 0.f;

  const int shift = g.T - g.S;
  const int q_first = row0 + shift, q_last = q_first + BQ - 1;
  const int nk = (g.T + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k_first = ik * BK;
    if (!tile_visible(q_first, q_last, k_first, k_first + BK - 1, g)) continue;
    __syncthreads();
    load_tile<D>(Ks, DP, k, b, k_first, BK, g.T, g.Hkv, kvh);
    load_tile<D>(Vs, DP, v, b, k_first, BK, g.T, g.Hkv, kvh);
    __syncthreads();
    bwd_tile<D, RQ, CK, PP>(Qs, dOs, Ks, Vs, lse_r, delta_r, row0, k_first, g,
                            nullptr, dSs);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float kv[DK];
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) kv[kk] = Ks[c * DP + tx + 16 * kk];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float ds = dSs[(ty + 16 * i) * PP + c];
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) acc[i][kk] = fmaf(ds, kv[kk], acc[i][kk]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = row0 + ty + 16 * i;
    if (s >= g.S) continue;
    float* o = dq + ((size_t)(b * g.S + s) * g.H + h) * D;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) o[tx + 16 * kk] = acc[i][kk] * g.sm_scale;
  }
}

template <int D>
struct DkvCfg {
  static constexpr int BQ = 64, BK = 32, DP = D + 1, PP = BK + 1;
  static constexpr size_t smem =
      (size_t)(2 * BK * DP + 2 * BQ * DP + 2 * BQ * PP + 2 * BQ) *
      sizeof(float);
};

// one block per (b, kv head, k tile), looping over the kv head's `rep` query
// heads and their q tiles: dk / dv come out already summed over the group
template <int D>
__global__ void __launch_bounds__(NT)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ nv_ptr, float* __restrict__ dk,
               float* __restrict__ dv, Geom g) {
  using C = DkvCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, DP = C::DP, PP = C::PP;
  constexpr int RQ = BQ / 16, CK = BK / 16, RK = BK / 16, DK = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;             // BK x DP
  float* Vs = Ks + BK * DP;     // BK x DP
  float* Qs = Vs + BK * DP;     // BQ x DP
  float* dOs = Qs + BQ * DP;    // BQ x DP
  float* Ps = dOs + BQ * DP;    // BQ x PP
  float* dSs = Ps + BQ * PP;    // BQ x PP
  float* lse_r = dSs + BQ * PP; // BQ
  float* delta_r = lse_r + BQ;  // BQ

  const int ik = blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rep = g.H / g.Hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k_first = ik * BK;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    zero_rows<D>(dk, b, k_first, BK, g.T, g.Hkv, kvh);
    zero_rows<D>(dv, b, k_first, BK, g.T, g.Hkv, kvh);
    return;
  }

  load_tile<D>(Ks, DP, k, b, k_first, BK, g.T, g.Hkv, kvh);
  load_tile<D>(Vs, DP, v, b, k_first, BK, g.T, g.Hkv, kvh);

  // thread (tx, ty) owns key rows ty + 16 i and head-dim columns tx + 16 kk
  float dk_acc[RK][DK], dv_acc[RK][DK];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) dk_acc[i][kk] = dv_acc[i][kk] = 0.f;

  const int shift = g.T - g.S;
  const int nq = (g.S + BQ - 1) / BQ;
  for (int hh = kvh * rep; hh < (kvh + 1) * rep; ++hh) {
    for (int iq = 0; iq < nq; ++iq) {
      const int row0 = iq * BQ;
      const int q_first = row0 + shift;
      if (!tile_visible(q_first, q_first + BQ - 1, k_first, k_first + BK - 1,
                        g))
        continue;
      __syncthreads();
      load_tile<D>(Qs, DP, q, b, row0, BQ, g.S, g.H, hh);
      load_tile<D>(dOs, DP, dout, b, row0, BQ, g.S, g.H, hh);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const bool in = row0 + r < g.S;
        const size_t at = ((size_t)b * g.H + hh) * g.S + row0 + r;
        lse_r[r] = in ? lse[at] : 0.f;
        delta_r[r] = in ? delta[at] : 0.f;
      }
      __syncthreads();
      bwd_tile<D, RQ, CK, PP>(Qs, dOs, Ks, Vs, lse_r, delta_r, row0, k_first,
                              g, Ps, dSs);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[RK], dsv[RK], qv[DK], dov[DK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Ps[r * PP + ty + 16 * i];
          dsv[i] = dSs[r * PP + ty + 16 * i];
        }
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          qv[kk] = Qs[r * DP + tx + 16 * kk];
          dov[kk] = dOs[r * DP + tx + 16 * kk];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int kk = 0; kk < DK; ++kk) {
            dv_acc[i][kk] = fmaf(pv[i], dov[kk], dv_acc[i][kk]);
            dk_acc[i][kk] = fmaf(dsv[i], qv[kk], dk_acc[i][kk]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int t = k_first + ty + 16 * i;
    if (t >= g.T) continue;
    const size_t at = ((size_t)(b * g.T + t) * g.Hkv + kvh) * D;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      dk[at + tx + 16 * kk] = dk_acc[i][kk] * g.sm_scale;
      dv[at + tx + 16 * kk] = dv_acc[i][kk];
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, const int* nv,
               float* out, float* lse, Geom g, cudaStream_t st) {
  using C = FwdCfg<D>;
  if (int e = set_smem(fwd_kernel<D>, C::smem)) return e;
  dim3 grid((g.S + C::BQ - 1) / C::BQ, g.H, g.B);
  fwd_kernel<D><<<grid, NT, C::smem, st>>>(q, k, v, nv, out, lse, g);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* o,
              const float* lse, const float* delta, const int* nv, float* dq,
              Geom g, cudaStream_t st) {
  using C = DqCfg<D>;
  if (int e = set_smem(dq_kernel<D>, C::smem)) return e;
  dim3 grid((g.S + C::BQ - 1) / C::BQ, g.H, g.B);
  dq_kernel<D><<<grid, NT, C::smem, st>>>(q, k, v, o, lse, delta, nv, dq, g);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const float* o,
               const float* lse, const float* delta, const int* nv, float* dk,
               float* dv, Geom g, cudaStream_t st) {
  using C = DkvCfg<D>;
  if (int e = set_smem(dkv_kernel<D>, C::smem)) return e;
  dim3 grid((g.T + C::BK - 1) / C::BK, g.Hkv, g.B);
  dkv_kernel<D><<<grid, NT, C::smem, st>>>(q, k, v, o, lse, delta, nv, dk, dv,
                                           g);
  return (int)cudaGetLastError();
}

constexpr int kBadHeadDim = -1;

}  // namespace

extern "C" {

// All pointers are device pointers; num_valid may be null (= all B rows).
// Returns 0 on success, a cudaError_t code if the launch was refused, or -1
// for a head_dim outside {32, 64, 128, 256}.
int flash_fwd(const float* q, const float* k, const float* v,
              const int* num_valid, float* out, float* lse, int B, int S,
              int T, int H, int Hkv, int D, int causal, int window,
              float softcap, float sm_scale, void* stream) {
  Geom g{B, S, T, H, Hkv, causal, window, softcap, sm_scale};
  cudaStream_t st = (cudaStream_t)stream;
#define CALL_FWD(DD) launch_fwd<DD>(q, k, v, num_valid, out, lse, g, st)
  switch (D) {
    case 32: return CALL_FWD(32);
    case 64: return CALL_FWD(64);
    case 128: return CALL_FWD(128);
    case 256: return CALL_FWD(256);
    default: return kBadHeadDim;
  }
#undef CALL_FWD
}

int flash_bwd_dq(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* delta,
                 const int* num_valid, float* dq, int B, int S, int T, int H,
                 int Hkv, int D, int causal, int window, float softcap,
                 float sm_scale, void* stream) {
  Geom g{B, S, T, H, Hkv, causal, window, softcap, sm_scale};
  cudaStream_t st = (cudaStream_t)stream;
#define CALL_DQ(DD) \
  launch_dq<DD>(q, k, v, dout, lse, delta, num_valid, dq, g, st)
  switch (D) {
    case 32: return CALL_DQ(32);
    case 64: return CALL_DQ(64);
    case 128: return CALL_DQ(128);
    case 256: return CALL_DQ(256);
    default: return kBadHeadDim;
  }
#undef CALL_DQ
}

int flash_bwd_dkv(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  const int* num_valid, float* dk, float* dv, int B, int S,
                  int T, int H, int Hkv, int D, int causal, int window,
                  float softcap, float sm_scale, void* stream) {
  Geom g{B, S, T, H, Hkv, causal, window, softcap, sm_scale};
  cudaStream_t st = (cudaStream_t)stream;
#define CALL_DKV(DD) \
  launch_dkv<DD>(q, k, v, dout, lse, delta, num_valid, dk, dv, g, st)
  switch (D) {
    case 32: return CALL_DKV(32);
    case 64: return CALL_DKV(64);
    case 128: return CALL_DKV(128);
    case 256: return CALL_DKV(256);
    default: return kBadHeadDim;
  }
#undef CALL_DKV
}

}  // extern "C"
