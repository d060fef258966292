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
// Layouts are the reference's: x (B,nc,cl,H,P), a (B,nc,cl,H), b/c
// (B,nc,cl,H,N), y (B,nc,cl,H,P), states and dS (B,nc,H,P,N), contiguous
// fp32.  One head's rows are strided by H*P (or H*N); each block loads its
// head's rows with those strides (each row is P or N contiguous floats), so
// the wrapper makes no permuted copy.
//
// What bounds it on an H100: at the mamba2-1.3b shapes (cl 64, P 64, N 128)
// a block does ~2.6 MFLOP (forward) or ~6 MFLOP (backward) on ~130 KB (~210
// KB) of device memory, ~20-30 flops per byte, so the bound is near the
// ridge of fp32 on the CUDA cores (67 TFLOP/s against 3.35 TB/s).  This first
// version runs the small products on the CUDA cores from shared memory, with
// a 4 x 4 (or 4 x 8) register tile per thread; tensor cores (TF32 mma /
// wgmma) are the later step.
//
// Design.  The TPU kernel gives one grid step to each (b, c, h) and keeps
// the (cl x cl) decay matrix in VMEM.  Here one block of 256 threads owns one
// (b, c, h): every operand of the chunk sits in shared memory (rows padded
// by one float so that the column walks hit distinct banks), the prefix sum
// of a is one thread's sequential loop (cl <= 64), and each small matrix
// product runs on a 16 x 16 thread grid in which thread (tx, ty) owns rows
// ty + 16 i and columns tx + 16 j of the output.  A row's 16 owners are 16
// lanes of one warp, so row reductions (q_j) are warp shuffles.  At the
// largest shapes a block holds 100 KB (forward) or 167 KB (backward) of
// shared memory, above the 48 KB default, so every launch first raises the
// kernel's dynamic shared-memory limit.  Sizes are runtime values bounded by
// cl <= 64, P <= 64, N <= 128 (the wrapper raises outside them).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;  // threads per block (16 x 16)
constexpr int MAX_CL = 64, MAX_P = 64, MAX_N = 128;

struct Geom {
  int B, nc, cl, H, P, N;
};

// acc[i][j] += sum_{k<K} A(ty + 16 i, k) * Bm(tx + 16 j, k) for rows < M,
// columns < Nc; operands outside the output's range read as zero.
template <int RM, int RN, class FA, class FB>
__device__ __forceinline__ void mm_acc(float (&acc)[RM][RN], int M, int Nc,
                                       int K, FA A, FB Bm) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      av[i] = r < M ? A(r, k) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = tx + 16 * j;
      bv[j] = col < Nc ? Bm(col, k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
}

// offset of row i of head h, chunk c, batch b in a (B, nc, cl, H, D) tensor
__device__ __forceinline__ size_t row_off(const Geom& g, int b, int c, int i,
                                          int h, int D) {
  return ((((size_t)b * g.nc + c) * g.cl + i) * g.H + h) * (size_t)D;
}

// the chunk's cl rows of one head into a shared tile with row stride D + 1
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          const Geom& g, int b, int c, int h,
                                          int D) {
  for (int idx = threadIdx.x; idx < g.cl * D; idx += NT) {
    const int r = idx / D, col = idx % D;
    dst[r * (D + 1) + col] = src[row_off(g, b, c, r, h, D) + col];
  }
}

// a_cum (prefix sum of the chunk's a, fp32, sequential) and w
__device__ __forceinline__ void decays(float* acum, float* w,
                                       const float* __restrict__ a,
                                       const Geom& g, int b, int c, int h) {
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < g.cl; ++i) {
      s += a[row_off(g, b, c, i, h, 1)];
      acum[i] = s;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g.cl; i += NT)
    w[i] = expf(acum[g.cl - 1] - acum[i]);
}

size_t fwd_smem(const Geom& g) {
  const int cl = g.cl, P = g.P, N = g.N;
  return (size_t)(cl * (P + 1) + 2 * cl * (N + 1) + cl * (cl + 1) + 2 * cl) *
         sizeof(float);
}

size_t bwd_smem(const Geom& g) {
  const int cl = g.cl, P = g.P, N = g.N;
  return (size_t)(2 * cl * (P + 1) + 2 * cl * (N + 1) + P * (N + 1) +
                  2 * cl * (cl + 1) + 4 * cl) *
         sizeof(float);
}

// ------------------------------------------------------------------ forward

__global__ void __launch_bounds__(NT)
    ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ bm, const float* __restrict__ cm,
                   float* __restrict__ y, float* __restrict__ st, Geom g) {
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int cl = g.cl, P = g.P, N = g.N;
  const int XP = P + 1, NP = N + 1, CP = cl + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* Xs = smem;              // cl x XP
  float* Bs = Xs + cl * XP;      // cl x NP
  float* Cs = Bs + cl * NP;      // cl x NP
  float* Ss = Cs + cl * NP;      // cl x CP: Sc = (C B^T) o L
  float* acum = Ss + cl * CP;    // cl
  float* w = acum + cl;          // cl

  load_rows(Xs, x, g, b, c, h, P);
  load_rows(Bs, bm, g, b, c, h, N);
  load_rows(Cs, cm, g, b, c, h, N);
  decays(acum, w, a, g, b, c, h);
  __syncthreads();

  {  // Sc = (C B^T) o L, zero above the diagonal
    float acc[4][4];
    zero(acc);
    mm_acc(acc, cl, cl, N, [&](int i, int k) { return Cs[i * NP + k]; },
           [&](int j, int k) { return Bs[j * NP + k]; });
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = ty + 16 * ii, j = tx + 16 * jj;
        if (i < cl && j < cl)
          Ss[i * CP + j] = i >= j ? acc[ii][jj] * expf(acum[i] - acum[j]) : 0.f;
      }
  }
  __syncthreads();

  {  // y_diag = Sc X
    float acc[4][4];
    zero(acc);
    mm_acc(acc, cl, P, cl, [&](int i, int k) { return Ss[i * CP + k]; },
           [&](int p, int k) { return Xs[k * XP + p]; });
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = ty + 16 * ii, p = tx + 16 * jj;
        if (i < cl && p < P) y[row_off(g, b, c, i, h, P) + p] = acc[ii][jj];
      }
  }

  {  // state = X^T (B o w), (P x N)
    float acc[4][8];
    zero(acc);
    mm_acc(acc, P, N, cl, [&](int p, int k) { return Xs[k * XP + p]; },
           [&](int n, int k) { return Bs[k * NP + n] * w[k]; });
    float* out = st + ((((size_t)b * g.nc + c) * g.H + h) * P) * (size_t)N;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int p = ty + 16 * ii, n = tx + 16 * jj;
        if (p < P && n < N) out[(size_t)p * N + n] = acc[ii][jj];
      }
  }
}

// ----------------------------------------------------------------- backward

__global__ void __launch_bounds__(NT)
    ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ bm, const float* __restrict__ cm,
                   const float* __restrict__ dy, const float* __restrict__ ds,
                   float* __restrict__ dx, float* __restrict__ da,
                   float* __restrict__ db, float* __restrict__ dc, Geom g) {
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int cl = g.cl, P = g.P, N = g.N;
  const int XP = P + 1, NP = N + 1, CP = cl + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* Xs = smem;               // cl x XP
  float* dYs = Xs + cl * XP;      // cl x XP
  float* Bs = dYs + cl * XP;      // cl x NP
  float* Cs = Bs + cl * NP;       // cl x NP
  float* dSs = Cs + cl * NP;      // P x NP
  float* Ss = dSs + P * NP;       // cl x CP: Sc
  float* Ts = Ss + cl * CP;       // cl x CP: dSc, then dG
  float* acum = Ts + cl * CP;     // cl
  float* w = acum + cl;           // cl
  float* dacum = w + cl;          // cl
  float* q = dacum + cl;          // cl

  load_rows(Xs, x, g, b, c, h, P);
  load_rows(dYs, dy, g, b, c, h, P);
  load_rows(Bs, bm, g, b, c, h, N);
  load_rows(Cs, cm, g, b, c, h, N);
  {
    const float* src = ds + ((((size_t)b * g.nc + c) * g.H + h) * P) * (size_t)N;
    for (int idx = threadIdx.x; idx < P * N; idx += NT)
      dSs[(idx / N) * NP + idx % N] = src[idx];
  }
  decays(acum, w, a, g, b, c, h);
  __syncthreads();

  {  // Sc = (C B^T) o L and dSc = dY X^T, both zero above the diagonal
    float acc[4][4];
    zero(acc);
    mm_acc(acc, cl, cl, N, [&](int i, int k) { return Cs[i * NP + k]; },
           [&](int j, int k) { return Bs[j * NP + k]; });
    float acd[4][4];
    zero(acd);
    mm_acc(acd, cl, cl, P, [&](int i, int k) { return dYs[i * XP + k]; },
           [&](int j, int k) { return Xs[j * XP + k]; });
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = ty + 16 * ii, j = tx + 16 * jj;
        if (i < cl && j < cl) {
          const bool low = i >= j;
          Ss[i * CP + j] = low ? acc[ii][jj] * expf(acum[i] - acum[j]) : 0.f;
          Ts[i * CP + j] = low ? acd[ii][jj] : 0.f;
        }
      }
  }
  __syncthreads();

  // d a_cum from the decay matrix: row sums minus column sums of dSc o Sc
  for (int k = threadIdx.x; k < cl; k += NT) {
    float s = 0.f;
    for (int j = 0; j <= k; ++j) s += Ts[k * CP + j] * Ss[k * CP + j];
    for (int i = k; i < cl; ++i) s -= Ts[i * CP + k] * Ss[i * CP + k];
    dacum[k] = s;
  }
  __syncthreads();
  // dG = dSc o L, in place
  for (int idx = threadIdx.x; idx < cl * cl; idx += NT) {
    const int i = idx / cl, j = idx % cl;
    if (i >= j) Ts[i * CP + j] *= expf(acum[i] - acum[j]);
  }

  {  // dX = Sc^T dY + w o (B dS^T);  q_j = sum_p X_jp (B dS^T)_jp
    float acc[4][4];
    zero(acc);
    mm_acc(acc, cl, P, N, [&](int j, int k) { return Bs[j * NP + k]; },
           [&](int p, int k) { return dSs[p * NP + k]; });
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int j = ty + 16 * ii;
      float part = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int p = tx + 16 * jj;
        if (j < cl && p < P) part += Xs[j * XP + p] * acc[ii][jj];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (tx == 0 && j < cl) q[j] = part;
      const float wj = j < cl ? w[j] : 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] *= wj;
    }
    mm_acc(acc, cl, P, cl, [&](int j, int k) { return Ss[k * CP + j]; },
           [&](int p, int k) { return dYs[k * XP + p]; });
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = ty + 16 * ii, p = tx + 16 * jj;
        if (j < cl && p < P) dx[row_off(g, b, c, j, h, P) + p] = acc[ii][jj];
      }
  }
  __syncthreads();  // dG and q complete

  {  // dC = dG B
    float acc[4][8];
    zero(acc);
    mm_acc(acc, cl, N, cl, [&](int i, int k) { return Ts[i * CP + k]; },
           [&](int n, int k) { return Bs[k * NP + n]; });
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = ty + 16 * ii, n = tx + 16 * jj;
        if (i < cl && n < N) dc[row_off(g, b, c, i, h, N) + n] = acc[ii][jj];
      }
  }

  {  // dB = w o (X dS) + dG^T C
    float acc[4][8];
    zero(acc);
    mm_acc(acc, cl, N, P, [&](int j, int k) { return Xs[j * XP + k]; },
           [&](int n, int k) { return dSs[k * NP + n]; });
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int j = ty + 16 * ii;
      const float wj = j < cl ? w[j] : 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[ii][jj] *= wj;
    }
    mm_acc(acc, cl, N, cl, [&](int j, int k) { return Ts[k * CP + j]; },
           [&](int n, int k) { return Cs[k * NP + n]; });
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = ty + 16 * ii, n = tx + 16 * jj;
        if (j < cl && n < N) db[row_off(g, b, c, j, h, N) + n] = acc[ii][jj];
      }
  }

  // the decay w's share of d a_cum, then dA = reverse cumsum of d a_cum
  if (threadIdx.x == 0) {
    float tail = 0.f, s = 0.f;
    for (int j = 0; j < cl; ++j) tail += w[j] * q[j];
    for (int k = cl - 1; k >= 0; --k) {
      s += dacum[k] - w[k] * q[k] + (k == cl - 1 ? tail : 0.f);
      da[row_off(g, b, c, k, h, 1)] = s;
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
  return g.B < 1 || g.nc < 1 || g.cl < 1 || g.H < 1 || g.P < 1 || g.N < 1 ||
         g.cl > MAX_CL || g.P > MAX_P || g.N > MAX_N || g.nc > 65535 ||
         g.B > 65535;
}

}  // namespace

extern "C" {

// All pointers are device pointers.  Returns 0 on success, a cudaError_t
// code if the launch was refused, or -1 for sizes outside cl <= 64, P <= 64,
// N <= 128.
int ssd_fwd(const float* x, const float* a, const float* b, const float* c,
            float* y, float* states, int B, int nc, int cl, int H, int P,
            int N, void* stream) {
  Geom g{B, nc, cl, H, P, N};
  if (bad_shape(g)) return kBadShape;
  const size_t smem = fwd_smem(g);
  if (int e = set_smem(ssd_fwd_kernel, smem)) return e;
  dim3 grid(H, nc, B);
  ssd_fwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(x, a, b, c, y,
                                                           states, g);
  return (int)cudaGetLastError();
}

int ssd_bwd(const float* x, const float* a, const float* b, const float* c,
            const float* dy, const float* ds, float* dx, float* da, float* db,
            float* dc, int B, int nc, int cl, int H, int P, int N,
            void* stream) {
  Geom g{B, nc, cl, H, P, N};
  if (bad_shape(g)) return kBadShape;
  const size_t smem = bwd_smem(g);
  if (int e = set_smem(ssd_bwd_kernel, smem)) return e;
  dim3 grid(H, nc, B);
  ssd_bwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      x, a, b, c, dy, ds, dx, da, db, dc, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
