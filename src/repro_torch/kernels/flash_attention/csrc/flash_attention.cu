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
// causal) each q tile meets up to 32 kv tiles, ~64 flops per byte moved from
// device memory, so the bound is arithmetic: three TF32 products per fp32
// one at 495 TFLOP/s on the tensor cores (67 TFLOP/s of fp32 on the CUDA
// cores is the fp32 bound).  At D = 256 a block holds ~200 KB of shared
// memory, above the 48 KB default, so every launch first raises the
// kernel's dynamic shared-memory limit.
//
// The TPU kernel walks a sequential grid axis over kv blocks and carries
// (m, l, acc) in VMEM scratch between grid steps.  Blocks on a GPU run in no
// order, so each block here owns one output tile and loops over the other
// axis itself, keeping its accumulators in registers.  Tiles that no visible
// (q, k) pair reaches are skipped (_tile_visible in the reference);
// num_valid-padded blocks write zeros and exit.  The 128-lane head_dim
// padding of the TPU version is not carried over: D is a template parameter
// over {32, 64, 96, 128, 256} (the swizzle works within 32-column groups, so
// any multiple of 32 tiles), and the Python wrapper zero-pads any other
// head_dim up to the next of these.
//
// All three kernels run their products on the tensor cores, with the
// helpers of ../../csrc/mma_tf32.cuh:
//   * mma.sync m16n8k8 in TF32 with the 3xTF32 split (x = hi + lo, both
//     TF32; a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in fp32),
//     which keeps the products near fp32 accuracy where plain TF32 keeps
//     ~11 bits (CUTLASS's OpMultiplyAddFastF32);
//   * 8 warps a block; tiles in shared memory without padding, row stride D,
//     column c of row r stored at c ^ (((r & 3) << 3) | (r & 4)): the A/B
//     fragment loads that walk rows with the lane group (g) and those that
//     walk columns with it both hit 32 distinct banks, and 16-byte chunks
//     stay whole for cp.async and ldmatrix;
//   * fragments whose 4-float rows lie whole in shared memory (A, and B
//     taken from an [n][k] tile) come by ldmatrix, the others by 32-bit
//     loads; the products over D keep four accumulator chains a tile (even
//     and odd k steps, big and small terms) so the mma latency overlaps;
//   * the next K/V tile (forward, dq) or q/dO tile (dk/dv) is copied with
//     cp.async into a second stage while the current one computes; ragged
//     edges are zero-filled by cp.async's source-size operand;
//   * accumulator fragments are not A fragments ((g, 2t) against (g, t)), so
//     P and dS go to the next product through a small shared tile.
// flash_fwd: one block per (q tile of 64, head, batch row), longest causal
// rows first; warp w owns rows 16 (w % 4) and half w / 4 of the score
// columns and of the output columns; row max and sum are combined across
// the two halves through shared memory.
// flash_bwd_dkv: one block per (k tile of 32, query head, batch row), as the
// reference's (B, H, nk, nq) grid, k tiles with the most visible q tiles
// first; it writes per-query-head dk/dv partials (B,T,H,D) when H > Hkv, and
// dkv_sum_kernel adds each kv head's group in a fixed order (no atomics, so
// a run repeats bit for bit).
// flash_bwd_dq: one block per (q tile of 32, query head, batch row), longest
// causal rows first, Q, dO, lse and delta resident, two stages of K and V:
// 200,960 B at D 256.  A 64-row q tile would need 128 KB for Q and dO alone,
// and two stages of K and V beside it do not fit in 227 KB; 32 rows also
// give 512 blocks at the gemma shapes (2048 at the hybrid ones) where 64
// gave 256.  Warp w computes S and dP on query rows 16 (w % 2), key columns
// 8 (w / 2) of each kv tile, writes dS to a 32 x 32 shared tile, then adds
// dS K into query rows 16 (w % 2), head-dim columns (D / 4)(w / 2).  Each
// block owns its dq rows, so a run repeats bit for bit.  ptxas (CUDA 12.8):
// dq_kernel<256> 143 registers, no spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "../../csrc/mma_tf32.cuh"
#include "flash_common.cuh"

namespace {


// rows [row0, row0 + R) of head `head` of a (B, L, NH, D) tensor into a
// swizzled R x D tile, 16 bytes a thread; rows past L are zero-filled
template <int D, int R>
__device__ __forceinline__ void copy_tile(float* dst,
                                          const float* __restrict__ src, int b,
                                          int row0, int L, int NH, int head) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < R * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4, row = row0 + r;
    const bool in = row < L;
    const float* from =
        in ? src + ((size_t)(b * L + row) * NH + head) * D + c : src;
    cp_async16(dst + swz<D>(r, c), from, in ? 16 : 0);
  }
}

// ------------------------------------------------------------------ forward

template <int D>
struct FwdCfg {
  static constexpr int BQ = 64, BK = 32;
  // Q; two stages of K and V; P; the two column halves' row maxima and sums
  static constexpr size_t smem =
      (size_t)(BQ * D + 4 * BK * D + BQ * BK + 4 * BQ) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ nv_ptr,
               float* __restrict__ out, float* __restrict__ lse, Geom g) {
  using C = FwdCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NO = D / 16;  // O n-tiles a warp
  extern __shared__ __align__(16) float tc_smem[];
  float* Qs = tc_smem;            // BQ x D
  float* Ks = Qs + BQ * D;        // 2 x BK x D
  float* Vs = Ks + 2 * BK * D;    // 2 x BK x D
  float* Ps = Vs + 2 * BK * D;    // BQ x BK
  float* red = Ps + BQ * BK;      // max [2][BQ], then sum [2][BQ]

  const int per = g.H * g.B, nq = (g.S + BQ - 1) / BQ;
  const int iq = nq - 1 - (int)(blockIdx.x / per);  // longest rows first
  const int h = (int)(blockIdx.x % per) % g.H, b = (int)(blockIdx.x % per) / g.H;
  const int kvh = h / (g.H / g.Hkv);
  const int row0 = iq * BQ;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    zero_rows<D>(out, b, row0, BQ, g.S, g.H, h);
    for (int r = threadIdx.x; r < BQ; r += NT)
      if (row0 + r < g.S) lse[((size_t)b * g.H + h) * g.S + row0 + r] = 0.f;
    return;
  }

  const int warp = threadIdx.x >> 5, gq = lane_g(), tq = lane_t();
  const int wr = (warp & 3) * 16;  // this warp's 16 rows
  const int wc = warp >> 2;        // its half of the S and of the O columns
  const int shift = g.T - g.S;
  const int2 range =
      visible_range<true>((g.T + BK - 1) / BK, BK, row0, BQ, g);

  copy_tile<D, BQ>(Qs, q, b, row0, g.S, g.H, h);
  if (range.x <= range.y) {
    copy_tile<D, BK>(Ks, k, b, range.x * BK, g.T, g.Hkv, kvh);
    copy_tile<D, BK>(Vs, v, b, range.x * BK, g.T, g.Hkv, kvh);
  }
  cp_commit();

  float o[NO][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int ik = range.x; ik <= range.y; ++ik) {
    const int stage = (ik - range.x) & 1;
    cp_wait_all();
    __syncthreads();  // this tile landed; the other stage's readers are done
    if (ik < range.y) {
      copy_tile<D, BK>(Ks + (stage ^ 1) * BK * D, k, b, (ik + 1) * BK, g.T,
                       g.Hkv, kvh);
      copy_tile<D, BK>(Vs + (stage ^ 1) * BK * D, v, b, (ik + 1) * BK, g.T,
                       g.Hkv, kvh);
    }
    cp_commit();
    const float* Kt = Ks + stage * BK * D;
    const float* Vt = Vs + stage * BK * D;
    const int k_first = ik * BK;

    // S = Q K^T on rows wr.., columns wc * 16 + {0, 8}; four chains a
    // tile (even / odd k step, big / small terms), added at the end
    float acc[2][2][2][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) (&acc[0][0][0][0])[i] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 16) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        uint32_t ah[4], al[4], bh[2][2], bl[2][2];
        load_a<D>(Qs, wr, k0 + 8 * par, ah, al);
        load_bt2<D>(Kt, wc * 16, k0 + 8 * par, bh, bl);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma3(acc[par][0][j], acc[par][1][j], ah, al, bh[j], bl[j]);
      }
    }
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = (acc[0][0][j][e] + acc[1][0][j][e]) +
                  (acc[0][1][j][e] + acc[1][1][j][e]);

    // scale, softcap, mask; row maxima over both column halves
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + gq + 8 * (e >> 1);
        const int c = wc * 16 + 8 * j + 2 * tq + (e & 1);
        float x = soft(s[j][e] * g.sm_scale, g.softcap);
        if (!pair_visible(row0 + r + shift, k_first + c, g)) x = NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = quad_max(mx[hh]);
      if (tq == 0) red[wc * BQ + wr + gq + 8 * hh] = mx[hh];
    }
    __syncthreads();
    float m_cur[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wr + gq + 8 * hh;
      m_cur[hh] = fmaxf(m[hh], fmaxf(red[r], red[BQ + r]));
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + gq + 8 * (e >> 1);
        const int c = wc * 16 + 8 * j + 2 * tq + (e & 1);
        const float p = expf(s[j][e] - m_cur[e >> 1]);
        Ps[swz<BK>(r, c)] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ps[hh] = quad_sum(ps[hh]);
      if (tq == 0) red[(2 + wc) * BQ + wr + gq + 8 * hh] = ps[hh];
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wr + gq + 8 * hh;
      const float alpha = expf(m[hh] - m_cur[hh]);
      l[hh] = l[hh] * alpha + (red[2 * BQ + r] + red[3 * BQ + r]);
      m[hh] = m_cur[hh];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * hh] *= alpha;
        o[j][2 * hh + 1] *= alpha;
      }
    }

    // O += P V on rows wr.., columns wc * D / 2 ..
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 8) {
      uint32_t ah[4], al[4];
      load_a<BK>(Ps, wr, k0, ah, al);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t bh[2], bl[2];
        load_b<D>(Vt, k0, wc * (D / 2) + 8 * j, bh, bl);
        mma3(o[j], o[j], ah, al, bh, bl);
      }
    }
  }
  cp_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s_row = row0 + wr + gq + 8 * hh;
    if (s_row >= g.S) continue;
    const float l_safe = fmaxf(l[hh], 1e-20f);
    float* o_row = out + ((size_t)(b * g.S + s_row) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = wc * (D / 2) + 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(o_row + c) =
          make_float2(o[j][2 * hh] / l_safe, o[j][2 * hh + 1] / l_safe);
    }
    if (wc == 0 && tq == 0)
      lse[((size_t)b * g.H + h) * g.S + s_row] = m[hh] + logf(l_safe);
  }
}

// ---------------------------------------------------------------- backward
//
// Per visible (q tile, kv tile) pair, as in the reference's _bwd_tile:
//   s_soft = softcap(q k^T * sm_scale)    p  = exp(s_soft - lse), masked to 0
//   dp = dO v^T                           ds = p (dp - delta) [* (1 - (s_soft/cap)^2)]
//   dq += ds k * sm_scale   dk += ds^T q * sm_scale   dv += p^T dO

template <int D>
struct DqCfg {
  static constexpr int BQ = 32, BK = 32;
  // Q and dO; two stages of K and V; dS; lse and delta
  static constexpr size_t smem =
      (size_t)(2 * BQ * D + 4 * BK * D + BQ * BK + 2 * BQ) * sizeof(float);
};

// one block per (q tile of 32, query head, batch row), longest causal rows
// first, looping over the visible kv tiles
template <int D>
__global__ void __launch_bounds__(NT, 1)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ nv_ptr, float* __restrict__ dq, Geom g) {
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NT2 = D / 32;  // dq n-tiles a warp
  extern __shared__ __align__(16) float tc_smem[];
  float* Qs = tc_smem;            // BQ x D
  float* dOs = Qs + BQ * D;       // BQ x D
  float* Ks = dOs + BQ * D;       // 2 x BK x D
  float* Vs = Ks + 2 * BK * D;    // 2 x BK x D
  float* dSs = Vs + 2 * BK * D;   // BQ x BK
  float* rows = dSs + BQ * BK;    // lse BQ, delta BQ

  const int per = g.H * g.B, nq = (g.S + BQ - 1) / BQ;
  const int iq = nq - 1 - (int)(blockIdx.x / per);  // longest rows first
  const int h = (int)(blockIdx.x % per) % g.H, b = (int)(blockIdx.x % per) / g.H;
  const int kvh = h / (g.H / g.Hkv);
  const int row0 = iq * BQ;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    zero_rows<D>(dq, b, row0, BQ, g.S, g.H, h);
    return;
  }

  const int warp = threadIdx.x >> 5, gq = lane_g(), tq = lane_t();
  const int m1 = (warp & 1) * 16;        // query rows of both phases
  const int n1 = (warp >> 1) * 8;        // key columns of S and dP
  const int c2 = (warp >> 1) * (D / 4);  // head-dim columns of dq
  const int shift = g.T - g.S;
  const size_t at = ((size_t)b * g.H + h) * g.S;
  const int2 range =
      visible_range<true>((g.T + BK - 1) / BK, BK, row0, BQ, g);

  copy_tile<D, BQ>(Qs, q, b, row0, g.S, g.H, h);
  copy_tile<D, BQ>(dOs, dout, b, row0, g.S, g.H, h);
  copy_rows<BQ>(rows, lse, at, row0, g.S);
  copy_rows<BQ>(rows + BQ, delta, at, row0, g.S);
  if (range.x <= range.y) {
    copy_tile<D, BK>(Ks, k, b, range.x * BK, g.T, g.Hkv, kvh);
    copy_tile<D, BK>(Vs, v, b, range.x * BK, g.T, g.Hkv, kvh);
  }
  cp_commit();

  float dq_acc[NT2][4];
#pragma unroll
  for (int j = 0; j < NT2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  for (int ik = range.x; ik <= range.y; ++ik) {
    const int stage = (ik - range.x) & 1;
    cp_wait_all();
    __syncthreads();  // this tile landed; the other stage's readers are done
    if (ik < range.y) {
      copy_tile<D, BK>(Ks + (stage ^ 1) * BK * D, k, b, (ik + 1) * BK, g.T,
                       g.Hkv, kvh);
      copy_tile<D, BK>(Vs + (stage ^ 1) * BK * D, v, b, (ik + 1) * BK, g.T,
                       g.Hkv, kvh);
    }
    cp_commit();
    const float* Kt = Ks + stage * BK * D;
    const float* Vt = Vs + stage * BK * D;
    const int k_first = ik * BK;

    // S = Q K^T and dP = dO V^T on query rows m1.., key columns n1..; four
    // chains a product (even / odd k step, big / small terms)
    float acc[2][2][2][4];  // [product][parity][big, small]
#pragma unroll
    for (int i = 0; i < 32; ++i) (&acc[0][0][0][0])[i] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 16) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        load_a<D>(Qs, m1, k0 + 8 * par, ah, al);
        load_bt<D>(Kt, n1, k0 + 8 * par, bh, bl);
        mma3(acc[0][par][0], acc[0][par][1], ah, al, bh, bl);
        load_a<D>(dOs, m1, k0 + 8 * par, ah, al);
        load_bt<D>(Vt, n1, k0 + 8 * par, bh, bl);
        mma3(acc[1][par][0], acc[1][par][1], ah, al, bh, bl);
      }
    }
    // p = exp(s_soft - lse), ds = p (dp - delta) [* (1 - (s_soft/cap)^2)]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m1 + gq + 8 * (e >> 1), c = n1 + 2 * tq + (e & 1);
      const float sc = (acc[0][0][0][e] + acc[0][1][0][e]) +
                       (acc[0][0][1][e] + acc[0][1][1][e]);
      const float dp = (acc[1][0][0][e] + acc[1][1][0][e]) +
                       (acc[1][0][1][e] + acc[1][1][1][e]);
      const float s_soft = soft(sc * g.sm_scale, g.softcap);
      float ds = 0.f;
      if (row0 + r < g.S && pair_visible(row0 + r + shift, k_first + c, g)) {
        ds = expf(s_soft - rows[r]) * (dp - rows[BQ + r]);
        if (g.softcap > 0.f) {
          const float t = s_soft / g.softcap;
          ds *= 1.f - t * t;
        }
      }
      dSs[swz<BK>(r, c)] = ds;
    }
    __syncthreads();

    // dQ += dS K on query rows m1.., head-dim columns c2..
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 8) {
      uint32_t sh[4], sl[4];
      load_a<BK>(dSs, m1, k0, sh, sl);
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        uint32_t bh[2], bl[2];
        load_b<D>(Kt, k0, c2 + 8 * j, bh, bl);
        mma3(dq_acc[j], dq_acc[j], sh, sl, bh, bl);
      }
    }
  }
  cp_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s = row0 + m1 + gq + 8 * hh;
    if (s >= g.S) continue;
    float* o = dq + ((size_t)(b * g.S + s) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < NT2; ++j) {
      const int c = c2 + 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(o + c) =
          make_float2(dq_acc[j][2 * hh] * g.sm_scale,
                      dq_acc[j][2 * hh + 1] * g.sm_scale);
    }
  }
}


template <int D>
struct DkvCfg {
  static constexpr int BK = 32, BQ = 32;
  // K, V; two stages of Q, dO, lse and delta; P^T and dS^T
  static constexpr size_t smem =
      (size_t)(2 * BK * D + 4 * BQ * D + 4 * BQ + 2 * BK * BQ) * sizeof(float);
};

// one block per (k tile, query head, batch row), looping over the visible q
// tiles: dk / dv of this query head alone, written to head h of a
// (B, T, H, D) tensor (the outputs themselves when H == Hkv, else the
// partials that dkv_sum_kernel adds up)
template <int D>
__global__ void __launch_bounds__(NT, 1)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ nv_ptr, float* __restrict__ dk,
               float* __restrict__ dv, Geom g) {
  using C = DkvCfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, NT2 = D / 32;  // dk/dv n-tiles a warp
  extern __shared__ __align__(16) float tc_smem[];
  float* Ks = tc_smem;             // BK x D
  float* Vs = Ks + BK * D;         // BK x D
  float* Qs = Vs + BK * D;         // 2 x BQ x D
  float* dOs = Qs + 2 * BQ * D;    // 2 x BQ x D
  float* rows = dOs + 2 * BQ * D;  // 2 x (lse BQ, delta BQ)
  float* Pt = rows + 4 * BQ;       // BK x BQ
  float* dSt = Pt + BK * BQ;       // BK x BQ

  const int per = g.H * g.B;
  const int ik = (int)(blockIdx.x / per);  // causal: most q tiles first
  const int h = (int)(blockIdx.x % per) % g.H, b = (int)(blockIdx.x % per) / g.H;
  const int kvh = h / (g.H / g.Hkv);
  const int k_first = ik * BK;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    zero_rows<D>(dk, b, k_first, BK, g.T, g.H, h);
    zero_rows<D>(dv, b, k_first, BK, g.T, g.H, h);
    return;
  }

  const int warp = threadIdx.x >> 5, gq = lane_g(), tq = lane_t();
  const int m1 = (warp & 1) * 16;        // key rows of both phases
  const int n1 = (warp >> 1) * 8;        // query columns of S^T and dP^T
  const int c2 = (warp >> 1) * (D / 4);  // head-dim columns of dk and dv
  const int shift = g.T - g.S;
  const size_t at = ((size_t)b * g.H + h) * g.S;
  const int2 range =
      visible_range<false>((g.S + BQ - 1) / BQ, BQ, k_first, BK, g);

  copy_tile<D, BK>(Ks, k, b, k_first, g.T, g.Hkv, kvh);
  copy_tile<D, BK>(Vs, v, b, k_first, g.T, g.Hkv, kvh);
  if (range.x <= range.y) {
    copy_tile<D, BQ>(Qs, q, b, range.x * BQ, g.S, g.H, h);
    copy_tile<D, BQ>(dOs, dout, b, range.x * BQ, g.S, g.H, h);
    copy_rows<BQ>(rows, lse, at, range.x * BQ, g.S);
    copy_rows<BQ>(rows + BQ, delta, at, range.x * BQ, g.S);
  }
  cp_commit();

  float dk_acc[NT2][4], dv_acc[NT2][4];
#pragma unroll
  for (int j = 0; j < NT2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int iq = range.x; iq <= range.y; ++iq) {
    const int stage = (iq - range.x) & 1;
    cp_wait_all();
    __syncthreads();  // this tile landed; the other stage's readers are done
    if (iq < range.y) {
      const int next = (iq + 1) * BQ, o = stage ^ 1;
      copy_tile<D, BQ>(Qs + o * BQ * D, q, b, next, g.S, g.H, h);
      copy_tile<D, BQ>(dOs + o * BQ * D, dout, b, next, g.S, g.H, h);
      copy_rows<BQ>(rows + 2 * o * BQ, lse, at, next, g.S);
      copy_rows<BQ>(rows + (2 * o + 1) * BQ, delta, at, next, g.S);
    }
    cp_commit();
    const float* Qt = Qs + stage * BQ * D;
    const float* dOt = dOs + stage * BQ * D;
    const float* lse_t = rows + 2 * stage * BQ;
    const float* delta_t = lse_t + BQ;
    const int row0 = iq * BQ;

    // S^T = K Q^T and dP^T = V dO^T on key rows m1.., query columns n1..;
    // four chains a product (even / odd k step, big / small terms)
    float acc[2][2][2][4];  // [product][parity][big, small]
#pragma unroll
    for (int i = 0; i < 32; ++i) (&acc[0][0][0][0])[i] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 16) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        load_a<D>(Ks, m1, k0 + 8 * par, ah, al);
        load_bt<D>(Qt, n1, k0 + 8 * par, bh, bl);
        mma3(acc[0][par][0], acc[0][par][1], ah, al, bh, bl);
        load_a<D>(Vs, m1, k0 + 8 * par, ah, al);
        load_bt<D>(dOt, n1, k0 + 8 * par, bh, bl);
        mma3(acc[1][par][0], acc[1][par][1], ah, al, bh, bl);
      }
    }
    float sc[4], dp[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[e] = (acc[0][0][0][e] + acc[0][1][0][e]) +
              (acc[0][0][1][e] + acc[0][1][1][e]);
      dp[e] = (acc[1][0][0][e] + acc[1][1][0][e]) +
              (acc[1][0][1][e] + acc[1][1][1][e]);
    }
    // p = exp(s_soft - lse), ds = p (dp - delta) [* (1 - (s_soft/cap)^2)]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = m1 + gq + 8 * (e >> 1), qc = n1 + 2 * tq + (e & 1);
      const float s_soft = soft(sc[e] * g.sm_scale, g.softcap);
      float p = 0.f, ds = 0.f;
      if (row0 + qc < g.S && pair_visible(row0 + qc + shift, k_first + kr, g)) {
        p = expf(s_soft - lse_t[qc]);
        ds = p * (dp[e] - delta_t[qc]);
        if (g.softcap > 0.f) {
          const float t = s_soft / g.softcap;
          ds *= 1.f - t * t;
        }
      }
      Pt[swz<BQ>(kr, qc)] = p;
      dSt[swz<BQ>(kr, qc)] = ds;
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q on key rows m1.., columns c2..
#pragma unroll
    for (int k0 = 0; k0 < BQ; k0 += 8) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      load_a<BQ>(Pt, m1, k0, ph, pl);
      load_a<BQ>(dSt, m1, k0, sh, sl);
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        uint32_t bh[2], bl[2];
        load_b<D>(dOt, k0, c2 + 8 * j, bh, bl);
        mma3(dv_acc[j], dv_acc[j], ph, pl, bh, bl);
        load_b<D>(Qt, k0, c2 + 8 * j, bh, bl);
        mma3(dk_acc[j], dk_acc[j], sh, sl, bh, bl);
      }
    }
  }
  cp_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = k_first + m1 + gq + 8 * hh;
    if (t >= g.T) continue;
    const size_t row = ((size_t)(b * g.T + t) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < NT2; ++j) {
      const int c = c2 + 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(dk + row + c) =
          make_float2(dk_acc[j][2 * hh] * g.sm_scale,
                      dk_acc[j][2 * hh + 1] * g.sm_scale);
      *reinterpret_cast<float2*>(dv + row + c) =
          make_float2(dv_acc[j][2 * hh], dv_acc[j][2 * hh + 1]);
    }
  }
}

// dk[b, t, j] = sum over r of dk_heads[b, t, j * rep + r], r in order (and dv
// alike), a float4 a thread: the deterministic GQA group-sum
__global__ void __launch_bounds__(NT)
    dkv_sum_kernel(const float4* __restrict__ dk_heads,
                   const float4* __restrict__ dv_heads,
                   float4* __restrict__ dk, float4* __restrict__ dv, int n,
                   int rep, int d4) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const size_t base = (size_t)(i / d4) * rep * d4 + i % d4;
  float4 a = dk_heads[base], c = dv_heads[base];
  for (int r = 1; r < rep; ++r) {
    const float4 x = dk_heads[base + (size_t)r * d4];
    const float4 y = dv_heads[base + (size_t)r * d4];
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  dk[i] = a;
  dv[i] = c;
}

// ------------------------------------------------------------------ launch

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, const int* nv,
               float* out, float* lse, Geom g, cudaStream_t st) {
  using C = FwdCfg<D>;
  if (int e = set_smem(fwd_kernel<D>, C::smem)) return e;
  const int nq = (g.S + C::BQ - 1) / C::BQ;
  fwd_kernel<D><<<nq * g.H * g.B, NT, C::smem, st>>>(q, k, v, nv, out, lse,
                                                     g);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* o,
              const float* lse, const float* delta, const int* nv, float* dq,
              Geom g, cudaStream_t st) {
  using C = DqCfg<D>;
  if (int e = set_smem(dq_kernel<D>, C::smem)) return e;
  const int nq = (g.S + C::BQ - 1) / C::BQ;
  dq_kernel<D><<<nq * g.H * g.B, NT, C::smem, st>>>(q, k, v, o, lse, delta, nv,
                                                    dq, g);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const float* o,
               const float* lse, const float* delta, const int* nv, float* dk,
               float* dv, float* dk_heads, float* dv_heads, Geom g,
               cudaStream_t st) {
  using C = DkvCfg<D>;
  const int rep = g.H / g.Hkv;
  if (rep > 1 && !(dk_heads && dv_heads)) return kNoScratch;
  if (int e = set_smem(dkv_kernel<D>, C::smem)) return e;
  const int nk = (g.T + C::BK - 1) / C::BK;
  dkv_kernel<D><<<nk * g.H * g.B, NT, C::smem, st>>>(
      q, k, v, o, lse, delta, nv, rep > 1 ? dk_heads : dk,
      rep > 1 ? dv_heads : dv, g);
  if (int e = (int)cudaGetLastError()) return e;
  if (rep > 1) {
    const int n = g.B * g.T * g.Hkv * (D / 4);
    dkv_sum_kernel<<<(n + NT - 1) / NT, NT, 0, st>>>(
        reinterpret_cast<const float4*>(dk_heads),
        reinterpret_cast<const float4*>(dv_heads),
        reinterpret_cast<float4*>(dk), reinterpret_cast<float4*>(dv), n, rep,
        D / 4);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers, 16-byte aligned; num_valid may be null
// (= all B rows).  Returns 0 on success, a cudaError_t code if a launch was
// refused, -1 for a head_dim outside {32, 64, 96, 128, 256}, -2 when H > Hkv and
// flash_bwd_dkv was given no (B, T, H, D) scratch for the per-head partials.
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
    case 96: return CALL_FWD(96);
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
    case 96: return CALL_DQ(96);
    case 128: return CALL_DQ(128);
    case 256: return CALL_DQ(256);
    default: return kBadHeadDim;
  }
#undef CALL_DQ
}

// dk_heads / dv_heads: (B, T, H, D) scratch for the per-query-head partials,
// used (and required) only when H > Hkv
int flash_bwd_dkv(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  const int* num_valid, float* dk, float* dv, float* dk_heads,
                  float* dv_heads, int B, int S, int T, int H, int Hkv, int D,
                  int causal, int window, float softcap, float sm_scale,
                  void* stream) {
  Geom g{B, S, T, H, Hkv, causal, window, softcap, sm_scale};
  cudaStream_t st = (cudaStream_t)stream;
#define CALL_DKV(DD)                                                       \
  launch_dkv<DD>(q, k, v, dout, lse, delta, num_valid, dk, dv, dk_heads,   \
                 dv_heads, g, st)
  switch (D) {
    case 32: return CALL_DKV(32);
    case 64: return CALL_DKV(64);
    case 96: return CALL_DKV(96);
    case 128: return CALL_DKV(128);
    case 256: return CALL_DKV(256);
    default: return kBadHeadDim;
  }
#undef CALL_DKV
}

}  // extern "C"
