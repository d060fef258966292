// Mamba-2 SSD intra-chunk kernels for Hopper (sm_90a), fp32, forward and
// backward, with a plain C interface (loaded with ctypes).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan/kernel.py:
//   ssd_fwd <- ssd_intra_chunk / _ssd_kernel
//   ssd_bwd <- its vector-Jacobian product, which the reference does not
//              have (its kernel path cannot be differentiated; it trains
//              through the plain chunked scan)
//
// Semantics, per (batch b, chunk c, head h), over the chunk's cl steps:
//   a_cum = cumsum(a);  L_ij = exp(a_cum_i - a_cum_j) for i >= j, else 0
//   G = C B^T;  Sc = G o L;  Y = Sc X  (y_diag);  w_j = exp(a_cum_last - a_cum_j)
//   S = X^T (B o w)  (the chunk's state, P x N)
// and, for cotangents dY (cl x P) and dS (P x N):
//   dX = Sc^T dY + (B o w) dS^T          dSc = dY X^T (lower triangle)
//   dG = dSc o L;  dC = dG B;            dB = dG^T C + w o (X dS)
//   d a_cum_i += sum_j dSc_ij Sc_ij,     d a_cum_j -= sum_i dSc_ij Sc_ij
//   d a_cum_last += sum_j w_j q_j,       d a_cum_j -= w_j q_j,
//   q_j = sum_p X_jp (B dS^T)_jp;        dA = reverse cumsum of d a_cum.
// L is never evaluated above the diagonal: there a_cum_i - a_cum_j > 0 and
// its exp may overflow, and 0 * inf would be NaN.
//
// Layouts: x (B,nc,cl,H,P), a (B,nc,cl,H), b/c (B,nc,cl,G,N) with B and C
// per group (head h reads group h / (H / G); G == H is the reference's
// per-head layout), y (B,nc,cl,H,P), states and dS (B,nc,H,P,N), contiguous
// fp32; ssd_bwd writes dB and dC per head, (B,nc,cl,H,N), and the wrapper
// sums each group's heads.  One head's rows are strided by H*P, one group's
// by G*N; each block loads its rows with those strides (each row is P or N
// contiguous floats), so the wrapper makes no permuted copy.  Sizes: cl <=
// 64, P <= 64, N <= 128, any value >= 1, G dividing H (the wrapper raises
// outside them).
//
// What bounds them on an H100: at the mamba2-1.3b cell (cl 64, P 64, N 128,
// H 64, G 1) the forward moves X, y, a and the states (~270 MB) and B and C
// once per group (4 MB), ~20 flops per byte; the backward ~210 KB an item.
// Both sit below the tensor cores' ridge, so the bound is the bytes (3.35
// TB/s) once the products leave the CUDA cores.
//
// Shared by both: tensor cores, asynchronous copies, no serial section.
//   * Tiles are compile-time: 64 rows (cl or P), 64 (P or cl) or 128 (N)
//     columns, unpadded and swizzled as in ../../csrc/mma_tf32.cuh; smaller
//     or ragged shapes zero-fill the rest of each tile (cp.async's
//     source-size operand), and zeros change none of the sums.  Rows come
//     by 16-byte cp.async when P (N) is a multiple of 4 and the tensors are
//     16-byte aligned, else by 4-byte copies.
//   * Products on mma.sync m16n8k8 TF32 with the 3xTF32 split, fp32
//     accumulate.  Wherever G = C B^T, Sc, dSc or dG enters a product, only
//     the 20 16 x 8 tiles that touch the lower triangle are computed or read.
//   * Prefix sums are warp scans (__shfl_up/down_sync).  No atomics, so a
//     run repeats bit for bit.
//
// ssd_fwd: one block per (b, c, a run of up to `run` heads of one group),
// run 8 by default (512 blocks at the cell; PERF.md section 6 has the
// choice).  C B^T is the same for every head of a group, so the block
// copies the group's B and C once (with the run's a) and forms G = C B^T
// once, on the 20 lower-triangle tiles (8 warps; warp w takes tiles w, w +
// 8, w + 16), while warps scan a_cum and w for every head of the run.  Then
// for each head it streams X through a ring of three stages (the first a
// buffer of its own, the other two C's buffer once G is formed; X of head j
// + 2 is copied while head j computes) and forms
//   y = Sc X       Sc = G o L_h built in the A fragments, L never evaluated
//                  above the diagonal; row tiles paired {0, 3} / {1, 2} and k
//                  stopping at the diagonal, so every warp does equal work
//   state = (X o w)^T B   w scales the X fragments in registers; B, shared
//                  by the run's heads, is never rescaled.
// Outputs go straight from the accumulators as 16-byte rows: lanes 2t and
// 2t + 1 swap one float pair by a shuffle, so each writes 4 consecutive
// floats of one row (scalar stores where P, N or alignment do not allow).
// Shared memory: B, C (64 KB), G (16 KB), X's own stage (16 KB) and 3 x run
// x 64 floats of a, a_cum and w: 104,448 bytes at run 8, so two blocks
// share an SM, and one block's copies overlap the other's products.  One
// sync a head.  ptxas (CUDA 12.8): 127 registers, no spills.
//
// ssd_bwd (B and C read by group; each item's arithmetic is that of the
// per-head layout):
//   * All seven products on 3xTF32 mma.sync; G and dSc on the lower-triangle
//     tiles (warp w takes tiles w, w + 8, w + 16), Sc^T dY, dG B and dG^T C
//     over k ranges that stop at the diagonal.  The last three pair row
//     tiles {0, 3} and {1, 2}, so each warp does the same work.
//   * Prefix sums: a_cum, and the reverse cumsum that gives dA with the w q
//     tail.  The row and column sums of dSc o Sc are reduced inside each
//     warp's tile, written as per-tile partials and added in a fixed order
//     by 64 threads; q's partials likewise.
//   * Occupancy: the B, C, X, dY and dS tiles alone are 128 KB, so two
//     blocks of an SM cannot both hold an item.  The kernel is persistent
//     instead: one block of 8 warps an SM walks items (b, c, h), h fastest,
//     blockIdx.x, blockIdx.x + gridDim.x, ...; B and C have two stages, and
//     the next item's B and C (its group's rows) are copied while the
//     current item computes.  X, dY and a, then dS, are copied as soon as
//     the current item is done with them, in two commit groups, so the next
//     item computes G = C B^T while they are in flight and dSc while dS is.
//     Shared memory: two stages of B and C (128 KB), X, dY, dS (64 KB), Sc,
//     dG (32 KB) and 2,688 B of row data and partials: 232,064 of the
//     232,448 bytes a block may hold.  ptxas (CUDA 12.8): 211 registers, no
//     spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

#include "../../csrc/mma_tf32.cuh"

namespace {

constexpr int NT = 256;  // threads per block (8 warps)
constexpr int MAX_CL = 64, MAX_P = 64, MAX_N = 128;
constexpr int CL = MAX_CL, PM = MAX_P, NM = MAX_N;  // the tiles' sizes
constexpr int NTRI = 20;  // 16 x 8 tiles of a CL x CL tile on or below the diagonal
constexpr unsigned FULL = 0xffffffffu;

struct Geom {
  int B, nc, cl, H, G, P, N;
};

// offset of row i of head h, chunk c, batch b in a (B, nc, cl, H, D) tensor
__device__ __forceinline__ size_t row_off(const Geom& g, int b, int c, int i,
                                          int h, int D) {
  return ((((size_t)b * g.nc + c) * g.cl + i) * g.H + h) * (size_t)D;
}

// offset of row i of group grp in a (B, nc, cl, G, N) tensor (B or C)
__device__ __forceinline__ size_t grp_off(const Geom& g, int b, int c, int i,
                                          int grp) {
  return ((((size_t)b * g.nc + c) * g.cl + i) * g.G + grp) * (size_t)g.N;
}

// offset of head h's (P, N) state in a (B, nc, H, P, N) tensor
__device__ __forceinline__ size_t state_off(const Geom& g, int b, int c,
                                            int h) {
  return (((size_t)b * g.nc + c) * g.H + h) * g.P * (size_t)g.N;
}

// row tile (16 rows) and column tile (8 columns) of lower-triangle tile tl:
// row tile m holds tiles m (m + 1) .. m (m + 1) + 2 m + 1
__device__ __forceinline__ void tri_tile(int tl, int& i0, int& j0) {
  const int m = tl < 2 ? 0 : tl < 6 ? 1 : tl < 12 ? 2 : 3;
  i0 = 16 * m;
  j0 = 8 * (tl - m * (m + 1));
}

// rows [0, nrows) x columns [0, ncols) of a matrix whose row r starts at
// src + base + r * stride, into a swizzled 64 x W tile; the rest of the tile
// is zero-filled.  vec: ncols % 4 == 0 and src 16-byte aligned.
template <int W>
__device__ __forceinline__ void copy_tile(float* dst,
                                          const float* __restrict__ src,
                                          size_t base, size_t stride,
                                          int nrows, int ncols, bool vec) {
  if (vec) {
    constexpr int C4 = W / 4;
    for (int i = threadIdx.x; i < 64 * C4; i += NT) {
      const int r = i / C4, col = (i % C4) * 4;
      const bool in = r < nrows && col < ncols;
      cp_async16(dst + swz<W>(r, col), in ? src + base + r * stride + col : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * W; i += NT) {
      const int r = i / W, col = i % W;
      const bool in = r < nrows && col < ncols;
      cp_async4(dst + swz<W>(r, col), in ? src + base + r * stride + col : src,
                in ? 4 : 0);
    }
  }
}

// G = C B^T on this warp's lower-triangle tiles (w, w + 8, w + 16), into the
// swizzled CL x CL tile out
__device__ __forceinline__ void cbt_tiles(const float* Cs, const float* Bs,
                                          float* out, int warp) {
  const int gq = lane_g(), tq = lane_t();
  for (int tl = warp; tl < NTRI; tl += 8) {
    int i0, j0;
    tri_tile(tl, i0, j0);
    float acc[2][2][4];  // [parity][big, small]
#pragma unroll
    for (int i = 0; i < 16; ++i) (&acc[0][0][0])[i] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < NM; k0 += 16) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        load_a<NM>(Cs, i0, k0 + 8 * par, ah, al);
        load_bt<NM>(Bs, j0, k0 + 8 * par, bh, bl);
        mma3(acc[par][0], acc[par][1], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[swz<CL>(i0 + gq + 8 * (e >> 1), j0 + 2 * tq + (e & 1))] =
          (acc[0][0][e] + acc[1][0][e]) + (acc[0][1][e] + acc[1][1][e]);
  }
}

// ------------------------------------------------------------------ forward

constexpr int MAX_RUN = 16;  // most heads one forward block takes

size_t fwd_smem(int run) {
  return (size_t)(2 * CL * NM + CL * CL + CL * PM + 3 * run * CL) *
         sizeof(float);
}
static_assert(2 * (2 * CL * NM + CL * CL + CL * PM + 3 * 8 * CL) * 4 + 2048 <=
                  233472,
              "ssd_fwd: two blocks of run 8 no longer share an SM");

struct FwdArgs {
  const float *x, *a, *bm, *cm;
  float *y, *st;
  int run;     // heads of one group a block takes
  int vp, vn;  // 16-byte copies and stores along P, along N
};

// A fragment of Sc = G o L at rows i0.., columns k0.. (the mma_tf32.cuh
// layout), from the swizzled G tile and a_cum: L_ij = exp(a_cum_i -
// a_cum_j) for j <= i, and Sc is 0 above the diagonal, where L is never
// evaluated (its exponent is positive there and may overflow)
__device__ __forceinline__ void load_sc(const float* Gs, const float* ac,
                                        int i0, int k0, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const int l = threadIdx.x & 31, mat = l >> 3;
  const int gq = lane_g(), tq = lane_t();
  uint32_t r[4];
  ldsm_x4(r, Gs + swz<CL>(i0 + (l & 7) + 8 * (mat & 1), k0 + 4 * (mat >> 1)));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + gq + 8 * (i & 1), col = k0 + tq + 4 * (i >> 1);
    const float v =
        col <= row ? __uint_as_float(r[i]) * expf(ac[row] - ac[col]) : 0.f;
    split(v, hi[i], lo[i]);
  }
}

// A fragment of (X o w)^T at rows (P) m0.., columns (steps) k0.., from the
// swizzled [k][m] X tile, each step's X scaled by its w (w0 = w[k0 + t],
// w1 = w[k0 + t + 4])
__device__ __forceinline__ void load_xwt(const float* Xs, int m0, int k0,
                                         float w0, float w1,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int gq = lane_g(), tq = lane_t();
  split(Xs[swz<PM>(k0 + tq, m0 + gq)] * w0, hi[0], lo[0]);
  split(Xs[swz<PM>(k0 + tq, m0 + gq + 8)] * w0, hi[1], lo[1]);
  split(Xs[swz<PM>(k0 + tq + 4, m0 + gq)] * w1, hi[2], lo[2]);
  split(Xs[swz<PM>(k0 + tq + 4, m0 + gq + 8)] * w1, hi[3], lo[3]);
}

// one 16 x 8 accumulator tile, v = (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1) relative to (row g of row_g / row_g8, column col0), into
// rows whose starts are row_g and row_g8 (null when the row is outside the
// output), columns < ncols.  vec (ncols % 4 == 0, rows 16-byte aligned):
// lanes 2t and 2t + 1 swap a pair, and each writes 4 floats of one row.
__device__ __forceinline__ void store_tile(float* row_g, float* row_g8,
                                           int col0, int ncols,
                                           const float (&v)[4], bool vec) {
  const int tq = lane_t();
  if (vec) {
    const bool odd = tq & 1;
    const float r0 = __shfl_xor_sync(FULL, odd ? v[0] : v[2], 1);
    const float r1 = __shfl_xor_sync(FULL, odd ? v[1] : v[3], 1);
    const int col = col0 + 2 * (tq & 2);
    float* row = odd ? row_g8 : row_g;
    if (row != nullptr && col < ncols)
      *reinterpret_cast<float4*>(row + col) =
          odd ? make_float4(r0, r1, v[2], v[3]) : make_float4(v[0], v[1], r0, r1);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* row = e < 2 ? row_g : row_g8;
      const int col = col0 + 2 * tq + (e & 1);
      if (row != nullptr && col < ncols) row[col] = v[e];
    }
  }
}

__device__ __forceinline__ void issue_x(float* Xs, const FwdArgs& p,
                                        const Geom& g, int b, int c, int h) {
  copy_tile<PM>(Xs, p.x, row_off(g, b, c, 0, h, g.P), (size_t)g.H * g.P,
                g.cl, g.P, p.vp);
}

// item = (b, c, group, run of heads), the run fastest, so the blocks of one
// (b, c, group) start together and share its B and C in L2
__global__ void __launch_bounds__(NT, 2) ssd_fwd_kernel(FwdArgs p, Geom g) {
  extern __shared__ __align__(16) float tc_smem[];
  float* Bs = tc_smem;                // CL x NM
  float* Cs = Bs + CL * NM;           // CL x NM: C, then X stages 1 and 2
  float* Gs = Cs + CL * NM;           // CL x CL: G on the lower-triangle tiles
  float* X0 = Gs + CL * CL;           // CL x PM: X stage 0
  float* abuf = X0 + CL * PM;         // run x CL: a, head by head
  float* acum = abuf + p.run * CL;    // run x CL
  float* wbuf = acum + p.run * CL;    // run x CL
  // X ring: head j's X in stage j % 3 (X0, then the two halves of Cs)
  auto xbuf = [&](int j) { return j % 3 ? Cs + (j % 3 - 1) * CL * PM : X0; };

  const int R = g.H / g.G, nr = (R + p.run - 1) / p.run;
  long long it = blockIdx.x;
  const int r = (int)(it % nr);
  it /= nr;
  const int grp = (int)(it % g.G);
  it /= g.G;
  const int c = (int)(it % g.nc), b = (int)(it / g.nc);
  const int h0 = grp * R + r * p.run, nh = min(p.run, R - r * p.run);
  const int cl = g.cl;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane_g();

  // copy groups: (B, C, a), X of head 0, X of head 1
  const size_t bc = grp_off(g, b, c, 0, grp), bc_stride = (size_t)g.G * g.N;
  copy_tile<NM>(Bs, p.bm, bc, bc_stride, cl, g.N, p.vn);
  copy_tile<NM>(Cs, p.cm, bc, bc_stride, cl, g.N, p.vn);
  for (int i = threadIdx.x; i < p.run * CL; i += NT) {
    const int j = i % p.run, row = i / p.run;  // a run's heads are adjacent
    const bool in = j < nh && row < cl;
    cp_async4(abuf + j * CL + row, in ? p.a + row_off(g, b, c, row, h0 + j, 1)
                                      : p.a,
              in ? 4 : 0);
  }
  cp_commit();
  issue_x(X0, p, g, b, c, h0);
  cp_commit();
  cp_wait<1>();  // B, C and a landed (X of head 0 may be in flight)
  __syncthreads();

  // a_cum = cumsum(a) and w = exp(a_cum_last - a_cum) of head j on warp j:
  // two steps a lane, then a warp scan; rows past cl hold a = 0, so the
  // total is a_cum_last
  for (int j = warp; j < nh; j += NT / 32) {
    const float a0 = abuf[j * CL + 2 * lane], a1 = abuf[j * CL + 2 * lane + 1];
    float s = a0 + a1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(FULL, s, d);
      if (lane >= d) s += o;
    }
    float before = __shfl_up_sync(FULL, s, 1);
    if (lane == 0) before = 0.f;
    const float total = __shfl_sync(FULL, s, 31);
    const float c0 = before + a0;
    acum[j * CL + 2 * lane] = c0;
    acum[j * CL + 2 * lane + 1] = s;
    wbuf[j * CL + 2 * lane] = expf(total - c0);
    wbuf[j * CL + 2 * lane + 1] = expf(total - s);
  }
  cbt_tiles(Cs, Bs, Gs, warp);
  __syncthreads();  // G, a_cum and w complete; C is read
  if (nh > 1) issue_x(xbuf(1), p, g, b, c, h0 + 1);
  cp_commit();

  // y: row tiles {0, 3} (even warps) or {1, 2} (odd), columns p0 .. p0 + 15;
  // state: every row tile, columns n0 .. n0 + 15
  const int mt0 = (warp & 1) ? 1 : 0, mt1 = (warp & 1) ? 2 : 3;
  const int p0 = (warp >> 1) * 16, n0 = warp * 16;
  for (int j = 0; j < nh; ++j) {
    cp_wait<1>();     // X of head j landed (head j + 1's may be in flight)
    __syncthreads();  // ... for all; every warp is done with head j - 1
    if (j + 2 < nh) issue_x(xbuf(j + 2), p, g, b, c, h0 + j + 2);
    cp_commit();
    const float* Xs = xbuf(j);
    const float* ac = acum + j * CL;
    const float* w = wbuf + j * CL;
    const int h = h0 + j;

    // y = Sc X, k stopping at the diagonal
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i0 = 16 * (m ? mt1 : mt0);
      float big[2][4], small[2][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) (&big[0][0])[i] = (&small[0][0])[i] = 0.f;
      for (int k0 = 0; k0 < i0 + 16; k0 += 8) {
        uint32_t ah[4], al[4];
        load_sc(Gs, ac, i0, k0, ah, al);
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          uint32_t bh[2], bl[2];
          load_b<PM>(Xs, k0, p0 + 8 * jn, bh, bl);
          mma3(big[jn], small[jn], ah, al, bh, bl);
        }
      }
      const int r0 = i0 + gq, r8 = r0 + 8;
      float* yg = r0 < cl ? p.y + row_off(g, b, c, r0, h, g.P) : nullptr;
      float* y8 = r8 < cl ? p.y + row_off(g, b, c, r8, h, g.P) : nullptr;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const float v[4] = {big[jn][0] + small[jn][0], big[jn][1] + small[jn][1],
                            big[jn][2] + small[jn][2], big[jn][3] + small[jn][3]};
        store_tile(yg, y8, p0 + 8 * jn, g.P, v, p.vp);
      }
    }

    // state = (X o w)^T B, (P x N)
    float acc[4][2][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) (&acc[0][0][0])[i] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < CL; k0 += 8) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) load_b<NM>(Bs, k0, n0 + 8 * jn, bh[jn], bl[jn]);
      const float w0 = w[k0 + lane_t()], w1 = w[k0 + lane_t() + 4];
#pragma unroll
      for (int mp = 0; mp < 4; ++mp) {
        uint32_t ah[4], al[4];
        load_xwt(Xs, 16 * mp, k0, w0, w1, ah, al);
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
          mma3(acc[mp][jn], acc[mp][jn], ah, al, bh[jn], bl[jn]);
      }
    }
    float* out = p.st + state_off(g, b, c, h);
#pragma unroll
    for (int mp = 0; mp < 4; ++mp) {
      const int r0 = 16 * mp + gq, r8 = r0 + 8;
      float* sg = r0 < g.P ? out + (size_t)r0 * g.N : nullptr;
      float* s8 = r8 < g.P ? out + (size_t)r8 * g.N : nullptr;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
        store_tile(sg, s8, n0 + 8 * jn, g.N, acc[mp][jn], p.vn);
    }
  }
}

// ----------------------------------------------------------------- backward

// part: the row (NTRI x 16) and column (NTRI x 8) partials of dSc o Sc,
// later q's partials (4 x CL)
constexpr int PART = NTRI * 24;
constexpr size_t BWD_SMEM =
    (size_t)(4 * CL * NM + 2 * CL * PM + PM * NM + 2 * CL * CL + 3 * CL +
             PART) *
    sizeof(float);
static_assert(BWD_SMEM <= 232448, "ssd_bwd: above a block's shared memory");
static_assert(4 * CL <= PART, "q's partials overlay the dSc o Sc partials");

__device__ __forceinline__ void item_coords(long long it, const Geom& g,
                                            int& b, int& c, int& h) {
  h = (int)(it % g.H);
  const long long bc = it / g.H;
  c = (int)(bc % g.nc);
  b = (int)(bc / g.nc);
}

struct BwdArgs {
  const float *x, *a, *bm, *cm, *dy, *ds;
  float *dx, *da, *db, *dc;
  int vp, vn;  // 16-byte copies and float2 stores along P, along N
};

__device__ __forceinline__ void issue_bc(float* Bs, float* Cs,
                                         const BwdArgs& p, const Geom& g,
                                         long long it) {
  int b, c, h;
  item_coords(it, g, b, c, h);
  const size_t at = grp_off(g, b, c, 0, h / (g.H / g.G)),
               stride = (size_t)g.G * g.N;
  copy_tile<NM>(Bs, p.bm, at, stride, g.cl, g.N, p.vn);
  copy_tile<NM>(Cs, p.cm, at, stride, g.cl, g.N, p.vn);
}

__device__ __forceinline__ void issue_xya(float* Xs, float* dYs, float* abuf,
                                          const BwdArgs& p, const Geom& g,
                                          long long it) {
  int b, c, h;
  item_coords(it, g, b, c, h);
  const size_t at = row_off(g, b, c, 0, h, g.P), stride = (size_t)g.H * g.P;
  copy_tile<PM>(Xs, p.x, at, stride, g.cl, g.P, p.vp);
  copy_tile<PM>(dYs, p.dy, at, stride, g.cl, g.P, p.vp);
  if (threadIdx.x < CL) {
    const int i = threadIdx.x;
    const bool in = i < g.cl;
    cp_async4(abuf + i, in ? p.a + row_off(g, b, c, i, h, 1) : p.a,
              in ? 4 : 0);
  }
}

__device__ __forceinline__ void issue_ds(float* dSs, const BwdArgs& p,
                                         const Geom& g, long long it) {
  int b, c, h;
  item_coords(it, g, b, c, h);
  copy_tile<NM>(dSs, p.ds, state_off(g, b, c, h), g.N, g.P, g.N, p.vn);
}

// rows r (< nrows) of a (.., D) output at out + row_off of row r, columns
// col, col + 1 (< ncols): one float2 where vec allows
__device__ __forceinline__ void store2(float* out, int col, int ncols,
                                       float v0, float v1, bool vec) {
  if (vec) {
    if (col < ncols) *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
  } else {
    if (col < ncols) out[col] = v0;
    if (col + 1 < ncols) out[col + 1] = v1;
  }
}

// persistent: block blockIdx.x walks items blockIdx.x + k gridDim.x, item
// = (b, c, h) with h fastest
__global__ void __launch_bounds__(NT, 1)
    ssd_bwd_kernel(BwdArgs p, Geom g) {
  extern __shared__ __align__(16) float tc_smem[];
  float* BCs = tc_smem;           // 2 stages x (B, C), each CL x NM
  float* Xs = BCs + 4 * CL * NM;  // CL x PM
  float* dYs = Xs + CL * PM;      // CL x PM
  float* dSs = dYs + CL * PM;     // PM x NM
  float* Scs = dSs + PM * NM;     // CL x CL: G, then Sc
  float* dGs = Scs + CL * CL;     // CL x CL: dG
  float* acum = dGs + CL * CL;    // CL
  float* abuf = acum + CL;        // CL: the a of the item in flight
  float* dacum = abuf + CL;       // CL
  float* part = dacum + CL;       // PART

  const long long items = (long long)g.B * g.nc * g.H;
  const int cl = g.cl;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane_g(), tq = lane_t();
  // row tiles {0, 3} (even warps) or {1, 2} (odd) of dX, dC and dB
  const int mt0 = (warp & 1) ? 1 : 0, mt1 = (warp & 1) ? 2 : 3;
  const int p0 = (warp >> 1) * 16;  // dX columns p0 .. p0 + 15
  const int n0 = (warp >> 1) * 32;  // dC / dB columns n0 .. n0 + 31

  long long it = blockIdx.x;
  issue_bc(BCs, BCs + CL * NM, p, g, it);
  cp_commit();
  issue_xya(Xs, dYs, abuf, p, g, it);
  cp_commit();
  issue_ds(dSs, p, g, it);
  cp_commit();

  for (int n = 0; it < items; it += gridDim.x, ++n) {
    const float* Bs = BCs + (n & 1) * 2 * CL * NM;
    const float* Cs = Bs + CL * NM;
    int b, c, h;
    item_coords(it, g, b, c, h);
    cp_wait<2>();     // B, C landed (X, dY, a and dS may be in flight)
    __syncthreads();  // ... for all; the other stage's last readers are done
    if (it + gridDim.x < items) {
      float* nb = BCs + ((n + 1) & 1) * 2 * CL * NM;
      issue_bc(nb, nb + CL * NM, p, g, it + gridDim.x);
    }
    cp_commit();

    // G = C B^T on this warp's lower-triangle tiles, into Scs
    cbt_tiles(Cs, Bs, Scs, warp);

    cp_wait<2>();     // X, dY and a landed (dS, the next B and C in flight)
    __syncthreads();
    if (warp == 0) {  // a_cum = cumsum(a): two steps a lane, then a warp scan
      const float a0 = abuf[2 * lane], a1 = abuf[2 * lane + 1];
      float s = a0 + a1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += o;
      }
      float before = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) before = 0.f;
      acum[2 * lane] = before + a0;
      acum[2 * lane + 1] = s;
    }
    // dSc = dY X^T on the same tiles, kept in registers
    float dsc[3][4];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int tl = warp + 8 * u;
      if (tl >= NTRI) continue;
      int i0, j0;
      tri_tile(tl, i0, j0);
      float acc[2][2][4];
#pragma unroll
      for (int i = 0; i < 16; ++i) (&acc[0][0][0])[i] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < PM; k0 += 16) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          load_a<PM>(dYs, i0, k0 + 8 * par, ah, al);
          load_bt<PM>(Xs, j0, k0 + 8 * par, bh, bl);
          mma3(acc[par][0], acc[par][1], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dsc[u][e] =
            (acc[0][0][e] + acc[1][0][e]) + (acc[0][1][e] + acc[1][1][e]);
    }
    __syncthreads();  // a_cum ready

    // Sc = G o L and dG = dSc o L (zero above the diagonal, where exp is
    // never evaluated); each tile's row and column sums of dSc o Sc
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int tl = warp + 8 * u;
      if (tl >= NTRI) continue;
      int i0, j0;
      tri_tile(tl, i0, j0);
      float rs[2] = {0.f, 0.f}, cs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = i0 + gq + 8 * (e >> 1), col = j0 + 2 * tq + (e & 1);
        const int at = swz<CL>(r, col);
        float sc = 0.f, dg = 0.f, dseg = 0.f;
        if (col <= r) {
          const float l = expf(acum[r] - acum[col]);
          sc = Scs[at] * l;
          dg = dsc[u][e] * l;
          dseg = dsc[u][e] * sc;
        }
        Scs[at] = sc;
        dGs[at] = dg;
        rs[e >> 1] += dseg;
        cs[e & 1] += dseg;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float v = quad_sum(rs[hh]);
        if (tq == 0) part[tl * 16 + gq + 8 * hh] = v;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = cs[e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gq == 0) part[NTRI * 16 + tl * 8 + 2 * tq + e] = v;
      }
    }

    cp_wait<1>();     // dS landed (the next B and C may be in flight)
    __syncthreads();  // ... for all; Sc, dG and the partials complete
    if (threadIdx.x < CL) {  // d a_cum from L: row sums minus column sums
      const int k = threadIdx.x, mr = k >> 4, nj = k >> 3;
      float s = 0.f;
      for (int j = 0; j <= 2 * mr + 1; ++j)
        s += part[(mr * (mr + 1) + j) * 16 + (k & 15)];
      for (int m = nj >> 1; m < 4; ++m)
        s -= part[NTRI * 16 + (m * (m + 1) + nj) * 8 + (k & 7)];
      dacum[k] = s;
    }
    __syncthreads();  // the partials are read; part takes q's partials

    const float acum_last = acum[cl - 1];
    // dX = w o (B dS^T) + Sc^T dY on row tiles mt0, mt1, columns p0..;
    // q_j's partial over these columns
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int j0 = 16 * (m ? mt1 : mt0);
      float big[2][4], small[2][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) (&big[0][0])[i] = (&small[0][0])[i] = 0.f;
#pragma unroll 4
      for (int k0 = 0; k0 < NM; k0 += 8) {
        uint32_t ah[4], al[4], bh[2][2], bl[2][2];
        load_a<NM>(Bs, j0, k0, ah, al);
        load_bt2<NM>(dSs, p0, k0, bh, bl);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma3(big[j], small[j], ah, al, bh[j], bl[j]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = j0 + gq + 8 * hh;
        const float w = expf(acum_last - acum[r]);
        float qp = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float t = big[j][2 * hh + e] + small[j][2 * hh + e];
            qp += Xs[swz<PM>(r, p0 + 8 * j + 2 * tq + e)] * t;
            big[j][2 * hh + e] = w * t;
            small[j][2 * hh + e] = 0.f;
          }
        qp = quad_sum(qp);
        if (tq == 0) part[(warp >> 1) * CL + r] = qp;
      }
      for (int k0 = j0; k0 < CL; k0 += 8) {
        uint32_t ah[4], al[4];
        load_at<CL>(Scs, j0, k0, ah, al);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bh[2], bl[2];
          load_b<PM>(dYs, k0, p0 + 8 * j, bh, bl);
          mma3(big[j], small[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = j0 + gq + 8 * hh;
        if (r >= cl) continue;
        float* out = p.dx + row_off(g, b, c, r, h, g.P);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          store2(out, p0 + 8 * j + 2 * tq, g.P,
                 big[j][2 * hh] + small[j][2 * hh],
                 big[j][2 * hh + 1] + small[j][2 * hh + 1], p.vp);
      }
    }

    // dC = dG B on row tiles mt0, mt1, columns n0..; k stops at the diagonal
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i0 = 16 * (m ? mt1 : mt0);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 16; ++i) (&acc[0][0])[i] = 0.f;
      for (int k0 = 0; k0 < i0 + 16; k0 += 8) {
        uint32_t ah[4], al[4];
        load_a<CL>(dGs, i0, k0, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[2], bl[2];
          load_b<NM>(Bs, k0, n0 + 8 * j, bh, bl);
          mma3(acc[j], acc[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = i0 + gq + 8 * hh;
        if (r >= cl) continue;
        float* out = p.dc + row_off(g, b, c, r, h, g.N);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store2(out, n0 + 8 * j + 2 * tq, g.N, acc[j][2 * hh],
                 acc[j][2 * hh + 1], p.vn);
      }
    }

    // dB = w o (X dS) + dG^T C on row tiles mt0, mt1, columns n0..
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int j0 = 16 * (m ? mt1 : mt0);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 16; ++i) (&acc[0][0])[i] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < PM; k0 += 8) {
        uint32_t ah[4], al[4];
        load_a<PM>(Xs, j0, k0, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[2], bl[2];
          load_b<NM>(dSs, k0, n0 + 8 * j, bh, bl);
          mma3(acc[j], acc[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float w = expf(acum_last - acum[j0 + gq + 8 * hh]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][2 * hh] *= w;
          acc[j][2 * hh + 1] *= w;
        }
      }
      for (int k0 = j0; k0 < CL; k0 += 8) {
        uint32_t ah[4], al[4];
        load_at<CL>(dGs, j0, k0, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[2], bl[2];
          load_b<NM>(Cs, k0, n0 + 8 * j, bh, bl);
          mma3(acc[j], acc[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = j0 + gq + 8 * hh;
        if (r >= cl) continue;
        float* out = p.db + row_off(g, b, c, r, h, g.N);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store2(out, n0 + 8 * j + 2 * tq, g.N, acc[j][2 * hh],
                 acc[j][2 * hh + 1], p.vn);
      }
    }

    __syncthreads();  // X, dY, dS, Sc, dG read; q's partials complete
    if (it + gridDim.x < items) {
      issue_xya(Xs, dYs, abuf, p, g, it + gridDim.x);
      cp_commit();
      issue_ds(dSs, p, g, it + gridDim.x);
      cp_commit();
    } else {
      cp_commit();
      cp_commit();
    }
    if (warp == 0) {
      // d a_cum_j -= w_j q_j, d a_cum_last += sum_j w_j q_j; then dA =
      // reverse cumsum of d a_cum: two steps a lane, then a warp scan
      float v[2], wq = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * lane + e;
        const float q = (part[k] + part[CL + k]) +
                        (part[2 * CL + k] + part[3 * CL + k]);
        const float wk = expf(acum_last - acum[k]) * q;
        v[e] = dacum[k] - wk;
        wq += wk;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wq += __shfl_xor_sync(0xffffffffu, wq, off);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (2 * lane + e == cl - 1) v[e] += wq;
      float s = v[0] + v[1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, s, d);
        if (lane + d < 32) s += o;
      }
      float after = __shfl_down_sync(0xffffffffu, s, 1);
      if (lane == 31) after = 0.f;
      const float da2[2] = {s, after + v[1]};
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (2 * lane + e < cl) p.da[row_off(g, b, c, 2 * lane + e, h, 1)] = da2[e];
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

constexpr int kBadShape = -1;

bool bad_shape(const Geom& g) {
  return g.B < 1 || g.nc < 1 || g.cl < 1 || g.H < 1 || g.G < 1 || g.P < 1 ||
         g.N < 1 || g.cl > MAX_CL || g.P > MAX_P || g.N > MAX_N ||
         g.H % g.G != 0;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if ((uintptr_t)q % 16) return false;
  return true;
}

}  // namespace

extern "C" {

// All pointers are device pointers.  Returns 0 on success, a cudaError_t
// code if the launch was refused, or -1 for sizes outside cl <= 64, P <= 64,
// N <= 128, G dividing H (and run outside 1..16, or too many blocks).
// run: heads of one group a forward block takes.
int ssd_fwd(const float* x, const float* a, const float* b, const float* c,
            float* y, float* states, int run, int B, int nc, int cl, int H,
            int G, int P, int N, void* stream) {
  Geom g{B, nc, cl, H, G, P, N};
  if (bad_shape(g) || run < 1 || run > MAX_RUN) return kBadShape;
  const int R = H / G;
  const long long items = (long long)B * nc * G * ((R + run - 1) / run);
  if (items > 0x7fffffffLL) return kBadShape;
  const size_t smem = fwd_smem(run);
  if (int e = set_smem(ssd_fwd_kernel, smem)) return e;
  FwdArgs p{x, a, b, c, y, states, run,
            P % 4 == 0 && aligned16({x, y}),
            N % 4 == 0 && aligned16({b, c, states})};
  ssd_fwd_kernel<<<(unsigned)items, NT, smem, (cudaStream_t)stream>>>(p, g);
  return (int)cudaGetLastError();
}

// db and dc are per head, (B, nc, cl, H, N); b and c per group.
int ssd_bwd(const float* x, const float* a, const float* b, const float* c,
            const float* dy, const float* ds, float* dx, float* da, float* db,
            float* dc, int B, int nc, int cl, int H, int G, int P, int N,
            void* stream) {
  Geom g{B, nc, cl, H, G, P, N};
  if (bad_shape(g)) return kBadShape;
  if (int e = set_smem(ssd_bwd_kernel, BWD_SMEM)) return e;
  int dev = 0, sms = 0;
  if (int e = cudaGetDevice(&dev)) return e;
  if (int e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev))
    return e;
  const long long items = (long long)B * nc * H;
  const int grid = items < sms ? (int)items : sms;
  BwdArgs p{x, a, b, c, dy, ds, dx, da, db, dc,
            P % 4 == 0 && aligned16({x, dy, dx}),
            N % 4 == 0 && aligned16({b, c, ds, db, dc})};
  ssd_bwd_kernel<<<grid, NT, BWD_SMEM, (cudaStream_t)stream>>>(p, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
