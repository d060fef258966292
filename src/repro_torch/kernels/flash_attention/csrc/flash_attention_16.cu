// Ragged causal GQA flash attention for Hopper (sm_90a) on bf16 and fp16
// inputs, forward and backward, with a plain C interface (loaded with
// ctypes).  The fp32 entry stays in flash_attention.cu.
//
// Replaces, for 16-bit inputs, the Pallas TPU kernels of
// src/repro/kernels/flash_attention/kernel.py:
//   flash_fwd_16     <- flash_attention / _fwd_kernel
//   flash_bwd_dq_16  <- flash_attention_bwd / _dq_kernel
//   flash_bwd_dkv_16 <- flash_attention_bwd / _dkv_kernel (and the GQA
//                       group-sum the reference does outside)
//   flash_delta_16   <- flash_attention_bwd's delta = rowsum(dO . O)
// As the TPU kernels do, they read q, k, v and dO at 2 bytes a value, widen
// them on the chip and store out, dq, dk and dv in the inputs' type; lse and
// delta are fp32.  Semantics, masks, padded batch rows (b >= num_valid:
// exact zeros) and the launch geometry are flash_attention.cu's
// (flash_common.cuh).
//
// Products run on the 16-bit tensor cores with fp32 accumulation: Q K^T and
// dO V^T of 16-bit inputs are exact products summed in fp32, as the TPU
// kernel's fp32 dot of the widened blocks (up to summation order).  P and
// dS are rounded to the input's type before P V, dS K, P^T dO and dS^T Q,
// as FlashAttention-2/3 do (the TPU kernel keeps them fp32: a deliberate
// difference, ROADMAP queue 3).
//
// What bounds them on an H100: at the training shapes (S = T >= 1024,
// causal) each q tile meets up to 16-32 kv tiles, hundreds of flops per
// byte, so the bound is the 989 TFLOP/s of the 16-bit tensor cores.
//
// flash_fwd_16 is FlashAttention-3's shape: one producer warp keeps a ring
// of two K/V stages filled by TMA (cp.async.bulk.tensor, mbarriers with
// transaction counts; K and V of a stage have barriers of their own, so
// K_{i+1} streams in once S_{i-1} is done); consumer warpgroups of 64
// query rows compute
// S = Q K^T with wgmma m64nBKk16 (Q and K in shared memory), the online
// softmax in fp32 registers (base 2), convert P to 16 bits in registers and
// feed it as wgmma's A operand for O += P V (V in shared memory, N-major).
// All tiles use TMA's 64-byte swizzle: each row of D values is D / 32
// atoms of 32 columns, one TMA box per atom, and the wgmma descriptors walk
// atoms and 16-column k steps inside them.  O's fp32 accumulator stays in
// registers: D / 2 a thread.  At D 256 that is 128, so one consumer
// warpgroup (64 query rows, a ring of two 64-row K/V tiles: 160 KB of
// shared memory); at D <= 128 two warpgroups (128 query rows) share a ring
// of three K/V tiles of 64 rows (128 at D <= 96).  One block of 160 or 288
// threads an SM.  Tile i's S is issued together with P_{i-1} V_{i-1}, and
// its softmax runs while that product does.
//
// flash_bwd_dq_16 / flash_bwd_dkv_16 keep flash_attention.cu's grids (dq: a
// block per (q tile, query head, batch row), longest causal rows first;
// dk/dv: a block per (k tile, query head, batch row), per-head fp32 partials
// into (B,T,H,D) scratch when H > Hkv, then dkv_sum16_kernel adds each
// group in a fixed order and writes 16 bits).  Their products are one
// mma.sync m16n8k16 each (../../csrc/mma_16.cuh), tiles come by 16-byte
// cp.async into swizzled 16-bit tiles and fragments by ldmatrix (.trans for
// the [k][n] operands).  At 2 bytes a value the tiles hold twice the rows
// of the fp32 kernels: dq takes 64 query rows and 64-key K/V tiles in two
// stages (200.5 KB at D 256; two blocks an SM at D <= 128), dk/dv 64 keys
// at D 256 (32 below) and 64-row Q/dO tiles in two stages (209 KB at D
// 256).  Warps tile each product as WM x WN = 8 warps.  They use
// mma.sync, not wgmma, so the CPU emulator (tools/cuda_emu) rehearses them.

#ifndef CUDA_EMU
#include <cuda.h>
#endif
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "../../csrc/mma_16.cuh"
#include "flash_common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T zero16() {
  return H16<T>::of_f(0.f);
}

template <typename T, int D>
__device__ __forceinline__ void zero_rows16(T* __restrict__ dst, int b,
                                            int row0, int nrows, int L, int NH,
                                            int head, int nthreads) {
  for (int i = threadIdx.x; i < nrows * D; i += nthreads) {
    const int r = i / D, c = i % D, row = row0 + r;
    if (row < L) dst[((size_t)(b * L + row) * NH + head) * D + c] = zero16<T>();
  }
}

// rows [row0, row0 + R) of head `head` of a (B, L, NH, D) 16-bit tensor
// into a swizzled R x D tile, 16 bytes (8 values) a copy; rows past L are
// zero-filled
template <int D, int R, typename T>
__device__ __forceinline__ void copy_tile16(T* dst, const T* __restrict__ src,
                                            int b, int row0, int L, int NH,
                                            int head) {
  constexpr int C8 = D / 8;
  for (int i = threadIdx.x; i < R * C8; i += NT) {
    const int r = i / C8, c = (i % C8) * 8, row = row0 + r;
    const bool in = row < L;
    const T* from = in ? src + ((size_t)(b * L + row) * NH + head) * D + c : src;
    cp_async16v(dst + swz16<D>(r, c), from, in ? 16 : 0);
  }
}

// c[j] += a B_j for the N n-tiles j of B (N even), from n0 on, of a
// swizzled [n][k] tile (B is its transpose) at k step k0
template <int W, int N, typename T>
__device__ __forceinline__ void mma_row_nk(float (&c)[N][4],
                                           const uint32_t (&a)[4],
                                           const T* s, int n0, int k0) {
  static_assert(N % 2 == 0, "pairs of n tiles");
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    uint32_t b[2][2];
    load_b16_nk2<W>(s, n0 + 8 * j, k0, b);
    mma16<T>(c[j], a, b[0]);
    mma16<T>(c[j + 1], a, b[1]);
  }
}

// the same from a swizzled [k][n] tile (B is the tile), N odd too (dk/dv
// at D 32 and 96)
template <int W, int N, typename T>
__device__ __forceinline__ void mma_row_kn(float (&c)[N][4],
                                           const uint32_t (&a)[4],
                                           const T* s, int k0, int n0) {
#pragma unroll
  for (int j = 0; j + 1 < N; j += 2) {
    uint32_t b[2][2];
    load_b16_kn2<W>(s, k0, n0 + 8 * j, b);
    mma16<T>(c[j], a, b[0]);
    mma16<T>(c[j + 1], a, b[1]);
  }
  if constexpr (N % 2) {
    uint32_t b[2];
    load_b16_kn<W>(s, k0, n0 + 8 * (N - 1), b);
    mma16<T>(c[N - 1], a, b);
  }
}

// Is every pair of query rows [row0, row0 + nq) and keys [k0, k0 + nk)
// in range and visible?  Then a tile needs no per-pair mask.
__device__ __forceinline__ bool tile_whole(int row0, int nq, int k0, int nk,
                                           const Geom& g) {
  const int shift = g.T - g.S;
  return row0 + nq <= g.S && k0 + nk <= g.T &&
         (!g.causal || k0 + nk - 1 <= row0 + shift) &&
         (g.window <= 0 || k0 > row0 + nq - 1 + shift - g.window);
}

// ---------------------------------------------------------------- backward
//
// Per visible (q tile, kv tile) pair, as in the reference's _bwd_tile:
//   s_soft = softcap(q k^T * sm_scale)    p  = exp(s_soft - lse), masked to 0
//   dp = dO v^T                           ds = p (dp - delta) [* (1 - (s_soft/cap)^2)]
//   dq += ds k * sm_scale   dk += ds^T q * sm_scale   dv += p^T dO

template <int D>
struct Dq16Cfg {
  static constexpr int BQ = 64, BK = 64;
  // two blocks an SM where both fit (107 KB at D 128; at D 256 one block
  // takes 200.5 KB, and 128 registers a thread would spill)
  static constexpr int MINB = D <= 128 ? 2 : 1;
  // Q and dO; two stages of K and V; dS (16-bit); then lse and delta (fp32)
  static constexpr size_t smem =
      (size_t)(2 * BQ * D + 4 * BK * D + BQ * BK) * 2 + 2 * BQ * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT, Dq16Cfg<D>::MINB)
    dq16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ nv_ptr, T* __restrict__ dq, Geom g) {
  using C = Dq16Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK;
  constexpr int WM = BQ / 16, WN = 8 / WM;  // warps over rows x columns
  constexpr int NS = BK / 8 / WN;           // S and dP n-tiles a warp
  constexpr int ND = D / 8 / WN;            // dq n-tiles a warp
  extern __shared__ __align__(16) float tc_smem[];
  T* Qs = reinterpret_cast<T*>(tc_smem);  // BQ x D
  T* dOs = Qs + BQ * D;                   // BQ x D
  T* Ks = dOs + BQ * D;                   // 2 x BK x D
  T* Vs = Ks + 2 * BK * D;                // 2 x BK x D
  T* dSs = Vs + 2 * BK * D;               // BQ x BK
  float* rows = reinterpret_cast<float*>(dSs + BQ * BK);  // lse, delta

  const int per = g.H * g.B, nq = (g.S + BQ - 1) / BQ;
  const int iq = nq - 1 - (int)(blockIdx.x / per);  // longest rows first
  const int h = (int)(blockIdx.x % per) % g.H, b = (int)(blockIdx.x % per) / g.H;
  const int kvh = h / (g.H / g.Hkv);
  const int row0 = iq * BQ;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    zero_rows16<T, D>(dq, b, row0, BQ, g.S, g.H, h, NT);
    return;
  }

  const int warp = threadIdx.x >> 5, gq = lane_g(), tq = lane_t();
  const int m1 = (warp % WM) * 16;            // query rows of both phases
  const int n1 = (warp / WM) * (BK / WN);     // key columns of S and dP
  const int c2 = (warp / WM) * (D / WN);      // head-dim columns of dq
  const int shift = g.T - g.S;
  const size_t at = ((size_t)b * g.H + h) * g.S;
  const int2 range =
      visible_range<true>((g.T + BK - 1) / BK, BK, row0, BQ, g);

  copy_tile16<D, BQ>(Qs, q, b, row0, g.S, g.H, h);
  copy_tile16<D, BQ>(dOs, dout, b, row0, g.S, g.H, h);
  copy_rows<BQ>(rows, lse, at, row0, g.S);
  copy_rows<BQ>(rows + BQ, delta, at, row0, g.S);
  if (range.x <= range.y) {
    copy_tile16<D, BK>(Ks, k, b, range.x * BK, g.T, g.Hkv, kvh);
    copy_tile16<D, BK>(Vs, v, b, range.x * BK, g.T, g.Hkv, kvh);
  }
  cp_commit();

  float dq_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  for (int ik = range.x; ik <= range.y; ++ik) {
    const int stage = (ik - range.x) & 1;
    cp_wait_all();
    __syncthreads();  // this tile landed; the other stage's readers are done
    if (ik < range.y) {
      copy_tile16<D, BK>(Ks + (stage ^ 1) * BK * D, k, b, (ik + 1) * BK, g.T,
                         g.Hkv, kvh);
      copy_tile16<D, BK>(Vs + (stage ^ 1) * BK * D, v, b, (ik + 1) * BK, g.T,
                         g.Hkv, kvh);
    }
    cp_commit();
    const T* Kt = Ks + stage * BK * D;
    const T* Vt = Vs + stage * BK * D;
    const int k_first = ik * BK;
    const bool whole = tile_whole(row0, BQ, k_first, BK, g);

    // S = Q K^T and dP = dO V^T on query rows m1.., key columns n1..
    float sa[NS][4], pa[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t aq[4], ad[4];
      load_a16<D>(Qs, m1, k0, aq);
      load_a16<D>(dOs, m1, k0, ad);
      mma_row_nk<D, NS>(sa, aq, Kt, n1, k0);
      mma_row_nk<D, NS>(pa, ad, Vt, n1, k0);
    }
    // p = exp(s_soft - lse), ds = p (dp - delta) [* (1 - (s_soft/cap)^2)],
    // rounded to T into the dS tile
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m1 + gq + 8 * hh, c = n1 + 8 * j + 2 * tq;
        float ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 2 * hh + x;
          const float s_soft = soft(sa[j][e] * g.sm_scale, g.softcap);
          ds[x] = 0.f;
          if (whole || (row0 + r < g.S &&
                        pair_visible(row0 + r + shift, k_first + c + x, g))) {
            ds[x] = expf(s_soft - rows[r]) * (pa[j][e] - rows[BQ + r]);
            if (g.softcap > 0.f) {
              const float t = s_soft / g.softcap;
              ds[x] *= 1.f - t * t;
            }
          }
        }
        *reinterpret_cast<uint32_t*>(dSs + swz16<BK>(r, c)) =
            pack2<T>(ds[0], ds[1]);
      }
    __syncthreads();

    // dQ += dS K on query rows m1.., head-dim columns c2..
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      uint32_t as[4];
      load_a16<BK>(dSs, m1, k0, as);
      mma_row_kn<D, ND>(dq_acc, as, Kt, k0, c2);
    }
  }
  cp_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s = row0 + m1 + gq + 8 * hh;
    if (s >= g.S) continue;
    T* o = dq + ((size_t)(b * g.S + s) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = c2 + 8 * j + 2 * tq;
      *reinterpret_cast<uint32_t*>(o + c) =
          pack2<T>(dq_acc[j][2 * hh] * g.sm_scale,
                   dq_acc[j][2 * hh + 1] * g.sm_scale);
    }
  }
}

template <int D>
struct Dkv16Cfg {
  // 64-key tiles at D 256 (1.3x faster there), 32 below (64 is slower)
  static constexpr int BK = D == 256 ? 64 : 32, BQ = 64;
  // K, V; two stages of Q and dO; P^T and dS^T (16-bit); two stages of lse
  // and delta (fp32)
  static constexpr size_t smem =
      (size_t)(2 * BK * D + 4 * BQ * D + 2 * BK * BQ) * 2 +
      4 * BQ * sizeof(float);
};

// one block per (k tile, query head, batch row), looping over the visible q
// tiles: dk / dv of this query head alone, written to head h of a
// (B, T, H, D) tensor: 16-bit outputs when H == Hkv, else fp32 partials
// that dkv_sum16_kernel adds up (`partial`)
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    dkv16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ nv_ptr, void* __restrict__ dk,
                 void* __restrict__ dv, int partial, Geom g) {
  using C = Dkv16Cfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ;
  constexpr int WM = BK / 16, WN = 8 / WM;  // warps over rows x columns
  constexpr int NS = BQ / 8 / WN;           // S^T and dP^T n-tiles a warp
  constexpr int ND = D / 8 / WN;            // dk / dv n-tiles a warp
  extern __shared__ __align__(16) float tc_smem[];
  T* Ks = reinterpret_cast<T*>(tc_smem);  // BK x D
  T* Vs = Ks + BK * D;                    // BK x D
  T* Qs = Vs + BK * D;                    // 2 x BQ x D
  T* dOs = Qs + 2 * BQ * D;               // 2 x BQ x D
  T* Pt = dOs + 2 * BQ * D;               // BK x BQ
  T* dSt = Pt + BK * BQ;                  // BK x BQ
  float* rows = reinterpret_cast<float*>(dSt + BK * BQ);  // 2 x (lse, delta)

  const int per = g.H * g.B;
  const int ik = (int)(blockIdx.x / per);  // causal: most q tiles first
  const int h = (int)(blockIdx.x % per) % g.H, b = (int)(blockIdx.x % per) / g.H;
  const int kvh = h / (g.H / g.Hkv);
  const int k_first = ik * BK;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    if (partial) {
      zero_rows<D>(static_cast<float*>(dk), b, k_first, BK, g.T, g.H, h);
      zero_rows<D>(static_cast<float*>(dv), b, k_first, BK, g.T, g.H, h);
    } else {
      zero_rows16<T, D>(static_cast<T*>(dk), b, k_first, BK, g.T, g.H, h, NT);
      zero_rows16<T, D>(static_cast<T*>(dv), b, k_first, BK, g.T, g.H, h, NT);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, gq = lane_g(), tq = lane_t();
  const int m1 = (warp % WM) * 16;         // key rows of both phases
  const int n1 = (warp / WM) * (BQ / WN);  // query columns of S^T and dP^T
  const int c2 = (warp / WM) * (D / WN);   // head-dim columns of dk and dv
  const int shift = g.T - g.S;
  const size_t at = ((size_t)b * g.H + h) * g.S;
  const int2 range =
      visible_range<false>((g.S + BQ - 1) / BQ, BQ, k_first, BK, g);

  copy_tile16<D, BK>(Ks, k, b, k_first, g.T, g.Hkv, kvh);
  copy_tile16<D, BK>(Vs, v, b, k_first, g.T, g.Hkv, kvh);
  if (range.x <= range.y) {
    copy_tile16<D, BQ>(Qs, q, b, range.x * BQ, g.S, g.H, h);
    copy_tile16<D, BQ>(dOs, dout, b, range.x * BQ, g.S, g.H, h);
    copy_rows<BQ>(rows, lse, at, range.x * BQ, g.S);
    copy_rows<BQ>(rows + BQ, delta, at, range.x * BQ, g.S);
  }
  cp_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int iq = range.x; iq <= range.y; ++iq) {
    const int stage = (iq - range.x) & 1;
    cp_wait_all();
    __syncthreads();  // this tile landed; the other stage's readers are done
    if (iq < range.y) {
      const int next = (iq + 1) * BQ, o = stage ^ 1;
      copy_tile16<D, BQ>(Qs + o * BQ * D, q, b, next, g.S, g.H, h);
      copy_tile16<D, BQ>(dOs + o * BQ * D, dout, b, next, g.S, g.H, h);
      copy_rows<BQ>(rows + 2 * o * BQ, lse, at, next, g.S);
      copy_rows<BQ>(rows + (2 * o + 1) * BQ, delta, at, next, g.S);
    }
    cp_commit();
    const T* Qt = Qs + stage * BQ * D;
    const T* dOt = dOs + stage * BQ * D;
    const float* lse_t = rows + 2 * stage * BQ;
    const float* delta_t = lse_t + BQ;
    const int row0 = iq * BQ;
    const bool whole = tile_whole(row0, BQ, k_first, BK, g);

    // S^T = K Q^T and dP^T = V dO^T on key rows m1.., query columns n1..
    float sa[NS][4], pa[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t ak[4], av[4];
      load_a16<D>(Ks, m1, k0, ak);
      load_a16<D>(Vs, m1, k0, av);
      mma_row_nk<D, NS>(sa, ak, Qt, n1, k0);
      mma_row_nk<D, NS>(pa, av, dOt, n1, k0);
    }
    // p = exp(s_soft - lse), ds = p (dp - delta) [* (1 - (s_soft/cap)^2)],
    // rounded to T into the P^T and dS^T tiles
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kr = m1 + gq + 8 * hh, qc = n1 + 8 * j + 2 * tq;
        float p[2], ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 2 * hh + x;
          const float s_soft = soft(sa[j][e] * g.sm_scale, g.softcap);
          p[x] = ds[x] = 0.f;
          if (whole || (row0 + qc + x < g.S &&
                        pair_visible(row0 + qc + x + shift, k_first + kr, g))) {
            p[x] = expf(s_soft - lse_t[qc + x]);
            ds[x] = p[x] * (pa[j][e] - delta_t[qc + x]);
            if (g.softcap > 0.f) {
              const float t = s_soft / g.softcap;
              ds[x] *= 1.f - t * t;
            }
          }
        }
        *reinterpret_cast<uint32_t*>(Pt + swz16<BQ>(kr, qc)) =
            pack2<T>(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dSt + swz16<BQ>(kr, qc)) =
            pack2<T>(ds[0], ds[1]);
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q on key rows m1.., columns c2..
#pragma unroll
    for (int k0 = 0; k0 < BQ; k0 += 16) {
      uint32_t ap[4], as[4];
      load_a16<BQ>(Pt, m1, k0, ap);
      load_a16<BQ>(dSt, m1, k0, as);
      mma_row_kn<D, ND>(dv_acc, ap, dOt, k0, c2);
      mma_row_kn<D, ND>(dk_acc, as, Qt, k0, c2);
    }
  }
  cp_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = k_first + m1 + gq + 8 * hh;
    if (t >= g.T) continue;
    const size_t row = ((size_t)(b * g.T + t) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = c2 + 8 * j + 2 * tq;
      const float k0 = dk_acc[j][2 * hh] * g.sm_scale,
                  k1 = dk_acc[j][2 * hh + 1] * g.sm_scale;
      if (partial) {
        *reinterpret_cast<float2*>(static_cast<float*>(dk) + row + c) =
            make_float2(k0, k1);
        *reinterpret_cast<float2*>(static_cast<float*>(dv) + row + c) =
            make_float2(dv_acc[j][2 * hh], dv_acc[j][2 * hh + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<T*>(dk) + row + c) =
            pack2<T>(k0, k1);
        *reinterpret_cast<uint32_t*>(static_cast<T*>(dv) + row + c) =
            pack2<T>(dv_acc[j][2 * hh], dv_acc[j][2 * hh + 1]);
      }
    }
  }
}

// dk[b, t, j] = sum over r of dk_heads[b, t, j * rep + r], r in order (and dv
// alike), in fp32, rounded once to T; four values a thread: the
// deterministic GQA group-sum
template <typename T>
__global__ void __launch_bounds__(NT)
    dkv_sum16_kernel(const float4* __restrict__ dk_heads,
                     const float4* __restrict__ dv_heads,
                     uint2* __restrict__ dk, uint2* __restrict__ dv, int n,
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
  uint2 ka, va;
  ka.x = pack2<T>(a.x, a.y); ka.y = pack2<T>(a.z, a.w);
  va.x = pack2<T>(c.x, c.y); va.y = pack2<T>(c.z, c.w);
  dk[i] = ka;
  dv[i] = va;
}

// a . b of two pairs of 16-bit values, each product exact in fp32
template <typename T>
__device__ __forceinline__ float dot2(uint32_t a, uint32_t b) {
  return H16<T>::to_f(H16<T>::of_bits(a & 0xffffu)) *
             H16<T>::to_f(H16<T>::of_bits(b & 0xffffu)) +
         H16<T>::to_f(H16<T>::of_bits(a >> 16)) *
             H16<T>::to_f(H16<T>::of_bits(b >> 16));
}

// delta[b, h, s] = sum over d of dO[b, s, h, d] O[b, s, h, d]: each product
// of two 16-bit values exact in fp32, summed in fp32 (the reference's
// rowsum of the widened tensors); one warp a (b, s, h) row, 16 bytes a
// load when rows are whole 16-byte chunks (D % 8 == 0)
template <typename T>
__global__ void __launch_bounds__(NT)
    delta16_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                   float* __restrict__ delta, int rows, int S, int H, int D) {
  const int row = (int)(blockIdx.x * (NT / 32) + (threadIdx.x >> 5));
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* a = dout + (size_t)row * D;
  const T* o = out + (size_t)row * D;
  float acc = 0.f;
  if (D % 8 == 0) {
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* o4 = reinterpret_cast<const uint4*>(o);
    for (int c = lane; c < D / 8; c += 32) {
      const uint4 x = a4[c], y = o4[c];
      acc += (dot2<T>(x.x, y.x) + dot2<T>(x.y, y.y)) +
             (dot2<T>(x.z, y.z) + dot2<T>(x.w, y.w));
    }
  } else {
    for (int c = lane; c < D; c += 32)
      acc += H16<T>::to_f(a[c]) * H16<T>::to_f(o[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

#ifndef CUDA_EMU
// ------------------------------------------------------------------ forward

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Fwd16Cfg {
  static constexpr int NWG = D <= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int BK = D <= 96 ? 128 : 64;  // keys of a K/V tile
  static constexpr int STAGES = D == 256 ? 2 : 3;  // K/V tiles in the ring
  static constexpr int BQ = 64 * NWG;            // query rows of a block
  static constexpr int NTF = 128 * NWG + 32;     // + one producer warp
  static constexpr int ATOMS = D / 32;           // 64-byte swizzle atoms
  static constexpr uint32_t q_bytes = BQ * D * 2, kv_bytes = BK * D * 2;
  // Q, STAGES x (K, V), 4 STAGES + 1 barriers, 1 KB to align the tiles
  static constexpr size_t smem =
      1024 + q_bytes + 2 * STAGES * kv_bytes + (4 * STAGES + 1) * 8;
};

// S = Q K^T for one warpgroup: D / 16 k steps, two a 32-column atom (the
// descriptors step 32 bytes into an atom, then to the next atom); the
// first overwrites s
template <typename T, int D, int BQ, int BK>
__device__ __forceinline__ void fwd_qk(float (&s)[BK / 2], uint32_t q_base,
                                       uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 1) * 32;  // bytes into the atom
    wgmma_ss<T, BK>(s, wg_desc(q_base + (kk >> 1) * BQ * 64 + off, 16, 512),
                    wg_desc(k_base + (kk >> 1) * BK * 64 + off, 16, 512),
                    kk > 0);
  }
}

// O += P V: for each k step of 16 keys, one m64n32k16 a 32-column atom of
// V (N-major: 8-key row groups 512 bytes apart)
template <typename T, int D, int BK>
__device__ __forceinline__ void fwd_pv(float (&o)[D / 32][16],
                                       const uint32_t (&pf)[BK / 16][4],
                                       uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int a = 0; a < D / 32; ++a)
      wgmma_rs32<T>(o[a], pf[kk],
                    wg_desc(v_base + a * BK * 64 + kk * 16 * 64, 512, 512));
}

// the online softmax of one S tile (base 2): scale, softcap, mask (unless
// `whole`: every pair of the warpgroup's rows and the tile's keys is
// visible), new row maxima, p = exp2(s - m) in place, l rescaled and
// summed (this thread's columns; the quad's are added at the end); alpha
// rescales O.  Thread rows qrow and qrow + 8 (query positions before the
// shift), keys from k_first.
template <int BK>
__device__ __forceinline__ void fwd_softmax(float (&s)[BK / 2], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2],
                                            bool whole, int qrow, int k_first,
                                            const Geom& g) {
  const int tq = lane_t(), shift = g.T - g.S;
  const float scale2 = g.sm_scale * LOG2E;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int hh = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * tq + (e & 1);
    float x = g.softcap > 0.f
                  ? g.softcap * tanhf(s[e] * g.sm_scale / g.softcap) * LOG2E
                  : s[e] * scale2;
    if (!whole && !pair_visible(qrow + 8 * hh + shift, k_first + c, g))
      x = NEG_INF;
    s[e] = x;
    mx[hh] = fmaxf(mx[hh], x);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float m_cur = fmaxf(m[hh], quad_max(mx[hh]));
    alpha[hh] = exp2f(m[hh] - m_cur);
    m[hh] = m_cur;
    l[hh] *= alpha[hh];
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int hh = (e >> 1) & 1;
    s[e] = exp2f(s[e] - m[hh]);
    l[hh] += s[e];
  }
}

// P (B K / 2 fp32 accumulator values) to 16 bits, laid out as wgmma's A
// fragments: k step kk (16 keys) is accumulator columns 16 kk .. + 15
template <typename T, int BK>
__device__ __forceinline__ void fwd_p16(const float (&s)[BK / 2],
                                        uint32_t (&pf)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pf[kk][x] = pack2<T>(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

template <typename T, int D>
__global__ void __launch_bounds__(Fwd16Cfg<D>::NTF, 1)
    fwd16_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const int* __restrict__ nv_ptr, T* __restrict__ out,
                 float* __restrict__ lse, Geom g) {
  using C = Fwd16Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES, AT = C::ATOMS;
  extern __shared__ __align__(1024) uint8_t fwd_smem[];
  uint8_t* base = fwd_smem + ((1024 - (smem_u32(fwd_smem) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);  // AT atoms of BQ x 32
  T* Ks = reinterpret_cast<T*>(base + C::q_bytes);  // ST x AT x BK x 32
  T* Vs = reinterpret_cast<T*>(base + C::q_bytes + ST * C::kv_bytes);
  // a full and an empty barrier for each stage's K and for its V: K_i
  // comes back to the producer once S_i is done, V_i once P_i V_i is
  uint64_t* k_full =
      reinterpret_cast<uint64_t*>(base + C::q_bytes + 2 * ST * C::kv_bytes);
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;
  uint64_t* q_full = v_empty + ST;

  const int per = g.H * g.B, nq = (g.S + BQ - 1) / BQ;
  const int iq = nq - 1 - (int)(blockIdx.x / per);  // longest rows first
  const int h = (int)(blockIdx.x % per) % g.H, b = (int)(blockIdx.x % per) / g.H;
  const int kvh = h / (g.H / g.Hkv);
  const int row0 = iq * BQ;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    zero_rows16<T, D>(out, b, row0, BQ, g.S, g.H, h, C::NTF);
    for (int r = threadIdx.x; r < BQ; r += C::NTF)
      if (row0 + r < g.S) lse[((size_t)b * g.H + h) * g.S + row0 + r] = 0.f;
    return;
  }

  const int2 range = visible_range<true>((g.T + BK - 1) / BK, BK, row0, BQ, g);
  const int n = range.y - range.x + 1;  // >= 1: a query sees its own key
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 128 * C::NWG);
      mbar_init(&v_empty[s], 128 * C::NWG);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp == 4 * C::NWG) {
    // producer: Q once, then K and V of each visible kv tile into the ring
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(q_full, C::q_bytes);
      for (int a = 0; a < AT; ++a)
        tma_load_4d(Qs + a * BQ * 32, &tm_q, q_full, 32 * a, h, row0, b);
      for (int i = 0; i < n; ++i) {
        const int st = i % ST, u = i / ST, key0 = (range.x + i) * BK;
        if (u > 0) mbar_wait(&k_empty[st], (u - 1) & 1);
        mbar_expect_tx(&k_full[st], C::kv_bytes);
        for (int a = 0; a < AT; ++a)
          tma_load_4d(Ks + (st * AT + a) * BK * 32, &tm_k, &k_full[st],
                      32 * a, kvh, key0, b);
        if (u > 0) mbar_wait(&v_empty[st], (u - 1) & 1);
        mbar_expect_tx(&v_full[st], C::kv_bytes);
        for (int a = 0; a < AT; ++a)
          tma_load_4d(Vs + (st * AT + a) * BK * 32, &tm_v, &v_full[st],
                      32 * a, kvh, key0, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows row0 + 64 wg .. + 63; warp w of
  // it rows 16 w .. + 15 of those (thread rows gq and gq + 8).  Tile i's
  // S = Q K_i^T is issued with P_{i-1} V_{i-1}; its softmax runs while that
  // product does, then O is rescaled and P_i converted.
  const int wg = warp >> 2, w = warp & 3, gq = lane_g(), tq = lane_t();
  const int qr0 = row0 + 64 * wg, qrow = qr0 + 16 * w + gq;
  float o[AT][16], s[BK / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f},
                              alpha[2];
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int a = 0; a < AT; ++a)
#pragma unroll
    for (int e = 0; e < 16; ++e) o[a][e] = 0.f;

  const uint32_t q_base = smem_u32(Qs) + wg * 64 * 64;
  const uint32_t k0_base = smem_u32(Ks), v0_base = smem_u32(Vs);
  // tile 0 (every block of a valid row sees at least one: a query sees its
  // own key), then tiles 1 .. n - 1 with no wgmma under a branch (ptxas
  // serializes wgmma in paths it cannot prove uniform)
  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  wg_fence();
  fwd_qk<T, D, BQ, BK>(s, q_base, k0_base);
  wg_commit();
  wg_wait<0>();
  mbar_arrive(&k_empty[0]);
  fence_regs(s);
  fwd_softmax<BK>(s, m, l, alpha, tile_whole(qr0, 64, range.x * BK, BK, g),
                  qrow, range.x * BK, g);
  fwd_p16<T, BK>(s, pf);
  for (int i = 1; i < n; ++i) {
    const int st = i % ST, prev = (i - 1) % ST, k_first = (range.x + i) * BK;
    mbar_wait(&k_full[st], (i / ST) & 1);
    mbar_wait(&v_full[prev], ((i - 1) / ST) & 1);
    wg_fence();
    fwd_qk<T, D, BQ, BK>(s, q_base, k0_base + st * C::kv_bytes);
    wg_commit();
    fwd_pv<T, D, BK>(o, pf, v0_base + prev * C::kv_bytes);
    wg_commit();
    wg_wait<1>();  // S_i has landed; P_{i-1} V_{i-1} may still run
    mbar_arrive(&k_empty[st]);
    fence_regs(s);
    fwd_softmax<BK>(s, m, l, alpha, tile_whole(qr0, 64, k_first, BK, g),
                    qrow, k_first, g);
    wg_wait<0>();
    mbar_arrive(&v_empty[prev]);
#pragma unroll
    for (int a = 0; a < AT; ++a) {
      fence_regs(o[a]);
#pragma unroll
      for (int e = 0; e < 16; ++e) o[a][e] *= alpha[(e >> 1) & 1];
    }
    fwd_p16<T, BK>(s, pf);
  }
  mbar_wait(&v_full[(n - 1) % ST], ((n - 1) / ST) & 1);
  wg_fence();
  fwd_pv<T, D, BK>(o, pf, v0_base + ((n - 1) % ST) * C::kv_bytes);
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int a = 0; a < AT; ++a) fence_regs(o[a]);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l_row = quad_sum(l[hh]);
    const int s_row = qrow + 8 * hh;
    if (s_row >= g.S) continue;
    const float l_safe = fmaxf(l_row, 1e-20f), inv = 1.f / l_safe;
    T* o_row = out + ((size_t)(b * g.S + s_row) * g.H + h) * D;
#pragma unroll
    for (int a = 0; a < AT; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(o_row + 32 * a + 8 * j + 2 * tq) =
            pack2<T>(o[a][4 * j + 2 * hh] * inv, o[a][4 * j + 2 * hh + 1] * inv);
    if (tq == 0)
      lse[((size_t)b * g.H + h) * g.S + s_row] = (m[hh] + log2f(l_safe)) * LN2;
  }
}
#endif  // CUDA_EMU

// ------------------------------------------------------------------ launch

constexpr int kNoTensorMap = -3;

#ifndef CUDA_EMU
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, reached through the
// runtime (so the library links no libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, L, NH, D) 16-bit tensor as a 4-d TMA map (D innermost) whose box is
// one 32-column atom of `rows` rows of one head, 64-byte swizzled; rows past
// L come as zeros
template <typename T>
int tensor_map(CUtensorMap* map, const void* ptr, int B, int L, int NH,
               int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kNoTensorMap;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)NH, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)NH * D * 2,
                                 (cuuint64_t)L * NH * D * 2};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kNoTensorMap;
}

template <typename T, int D>
int launch_fwd16(const void* q, const void* k, const void* v, const int* nv,
                 void* out, float* lse, Geom g, cudaStream_t st) {
  using C = Fwd16Cfg<D>;
  CUtensorMap mq, mk, mv;
  if (int e = tensor_map<T>(&mq, q, g.B, g.S, g.H, D, C::BQ)) return e;
  if (int e = tensor_map<T>(&mk, k, g.B, g.T, g.Hkv, D, C::BK)) return e;
  if (int e = tensor_map<T>(&mv, v, g.B, g.T, g.Hkv, D, C::BK)) return e;
  if (int e = set_smem(fwd16_kernel<T, D>, C::smem)) return e;
  const int nq = (g.S + C::BQ - 1) / C::BQ;
  fwd16_kernel<T, D><<<nq * g.H * g.B, C::NTF, C::smem, st>>>(
      mq, mk, mv, nv, static_cast<T*>(out), lse, g);
  return (int)cudaGetLastError();
}
#endif  // CUDA_EMU

template <typename T, int D>
int launch_dq16(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const float* delta, const int* nv, void* dq,
                Geom g, cudaStream_t st) {
  using C = Dq16Cfg<D>;
  if (int e = set_smem(dq16_kernel<T, D>, C::smem)) return e;
  const int nq = (g.S + C::BQ - 1) / C::BQ;
  dq16_kernel<T, D><<<nq * g.H * g.B, NT, C::smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o), lse, delta, nv,
      static_cast<T*>(dq), g);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv16(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const float* delta, const int* nv,
                 void* dk, void* dv, float* dk_heads, float* dv_heads, Geom g,
                 cudaStream_t st) {
  using C = Dkv16Cfg<D>;
  const int rep = g.H / g.Hkv;
  if (rep > 1 && !(dk_heads && dv_heads)) return kNoScratch;
  if (int e = set_smem(dkv16_kernel<T, D>, C::smem)) return e;
  const int nk = (g.T + C::BK - 1) / C::BK;
  dkv16_kernel<T, D><<<nk * g.H * g.B, NT, C::smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o), lse, delta, nv,
      rep > 1 ? static_cast<void*>(dk_heads) : dk,
      rep > 1 ? static_cast<void*>(dv_heads) : dv, rep > 1, g);
  if (int e = (int)cudaGetLastError()) return e;
  if (rep > 1) {
    const int n = g.B * g.T * g.Hkv * (D / 4);
    dkv_sum16_kernel<T><<<(n + NT - 1) / NT, NT, 0, st>>>(
        reinterpret_cast<const float4*>(dk_heads),
        reinterpret_cast<const float4*>(dv_heads), static_cast<uint2*>(dk),
        static_cast<uint2*>(dv), n, rep, D / 4);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0 = bfloat16, 1 = float16; D a template argument
#define DISPATCH16(dtype, D, CALL)                 \
  do {                                             \
    if ((dtype) == 1) {                            \
      using T = __half;                            \
      switch (D) {                                 \
        case 32: { constexpr int DD = 32; return CALL; }   \
        case 64: { constexpr int DD = 64; return CALL; }   \
        case 96: { constexpr int DD = 96; return CALL; }   \
        case 128: { constexpr int DD = 128; return CALL; } \
        case 256: { constexpr int DD = 256; return CALL; } \
        default: return kBadHeadDim;               \
      }                                            \
    } else {                                       \
      using T = __nv_bfloat16;                     \
      switch (D) {                                 \
        case 32: { constexpr int DD = 32; return CALL; }   \
        case 64: { constexpr int DD = 64; return CALL; }   \
        case 96: { constexpr int DD = 96; return CALL; }   \
        case 128: { constexpr int DD = 128; return CALL; } \
        case 256: { constexpr int DD = 256; return CALL; } \
        default: return kBadHeadDim;               \
      }                                            \
    }                                              \
  } while (0)

extern "C" {

// q, k, v, dout, out, dq, dk, dv are device pointers to 16-bit values of
// `dtype` (0 bfloat16, 1 float16), lse / delta / the dk, dv scratch fp32;
// all 16-byte aligned; num_valid may be null (= all B rows).  Returns 0 on
// success, a cudaError_t code if a launch was refused, -1 for a head_dim
// outside {32, 64, 96, 128, 256}, -2 when H > Hkv and flash_bwd_dkv_16 was
// given no (B, T, H, D) fp32 scratch for the per-head partials, -3 when the
// driver's TMA descriptor encoder is missing or refuses a tensor.
#ifndef CUDA_EMU
int flash_fwd_16(int dtype, const void* q, const void* k, const void* v,
                 const int* num_valid, void* out, float* lse, int B, int S,
                 int T_, int H, int Hkv, int D, int causal, int window,
                 float softcap, float sm_scale, void* stream) {
  Geom g{B, S, T_, H, Hkv, causal, window, softcap, sm_scale};
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH16(dtype, D,
             (launch_fwd16<T, DD>(q, k, v, num_valid, out, lse, g, st)));
}
#endif  // CUDA_EMU

int flash_bwd_dq_16(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const int* num_valid, void* dq, int B, int S, int T_,
                    int H, int Hkv, int D, int causal, int window,
                    float softcap, float sm_scale, void* stream) {
  Geom g{B, S, T_, H, Hkv, causal, window, softcap, sm_scale};
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH16(dtype, D,
             (launch_dq16<T, DD>(q, k, v, dout, lse, delta, num_valid, dq, g,
                                 st)));
}

// dk_heads / dv_heads: (B, T, H, D) fp32 scratch for the per-head partials,
// used (and required) only when H > Hkv
int flash_bwd_dkv_16(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* num_valid, void* dk, void* dv,
                     float* dk_heads, float* dv_heads, int B, int S, int T_,
                     int H, int Hkv, int D, int causal, int window,
                     float softcap, float sm_scale, void* stream) {
  Geom g{B, S, T_, H, Hkv, causal, window, softcap, sm_scale};
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH16(dtype, D,
             (launch_dkv16<T, DD>(q, k, v, dout, lse, delta, num_valid, dk,
                                  dv, dk_heads, dv_heads, g, st)));
}

// delta (B, H, S) fp32 = rowsum(dout * out) of two (B, S, H, D) tensors
int flash_delta_16(int dtype, const void* dout, const void* out,
                   float* delta, int B, int S, int H, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * S * H, blocks = (rows + NT / 32 - 1) / (NT / 32);
  if (dtype == 1)
    delta16_kernel<__half><<<blocks, NT, 0, st>>>(
        static_cast<const __half*>(dout), static_cast<const __half*>(out),
        delta, rows, S, H, D);
  else
    delta16_kernel<__nv_bfloat16><<<blocks, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dout),
        static_cast<const __nv_bfloat16*>(out), delta, rows, S, H, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
