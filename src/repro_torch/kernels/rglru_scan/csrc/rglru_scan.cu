// RG-LRU linear-recurrence kernels for Hopper (sm_90a), fp32, forward and
// backward, with a plain C interface (loaded with ctypes).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rglru_scan/kernel.py:
//   rglru_fwd <- rglru_linear_scan / _rglru_kernel
//   rglru_bwd <- its vector-Jacobian product, which the reference does not
//                have (its kernel path cannot be differentiated; it trains
//                through the plain associative scan)
//
// Semantics, per (batch b, column w), over t = 0..L-1:
//   h_t = a_t * h_{t-1} + bx_t,  h_{-1} = h0 (or 0);  hT = h_{L-1}
// and, for cotangents dh (of h) and dhT (of hT), with g_L = 0 and a_L = 0:
//   g_t = dh_t + [t == L-1] dhT + a_{t+1} g_{t+1}
//   da_t = g_t h_{t-1};  dbx_t = g_t;  dh0 = a_0 g_0.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn, no
// fused multiply-add), in the order the plain PyTorch versions take, so the
// kernels and the plain versions agree to the bit.
//
// Layouts are the reference's: a, bx, h, dh, da, dbx (B,L,W); h0, hT, dhT,
// dh0 (B,W); contiguous fp32.  Any W.
//
// What bounds it on an H100: bytes.  The forward reads a and bx and writes
// h (3 B L W floats), the backward reads a, h, dh and writes da, dbx (5 B L
// W floats), one or two flops per float.  At the recurrentgemma-9b cell
// (B 2, L 2048, W 4096) that is 201 MB and 336 MB, 0.06 and 0.10 ms at
// 3.35 TB/s.
//
// Design.  The TPU kernel tiles W into 128-lane blocks and walks time with
// the carry in vector registers.  Here one thread owns one column w and
// walks its L steps with the carry in a register; consecutive threads own
// consecutive columns, so each step's loads and stores are coalesced 128-byte
// rows of a warp.  The loads do not depend on the carry, so each thread
// first loads UNROLL steps into registers (UNROLL loads of each operand in
// flight at once) and then runs the dependent chain over them.  The grid is
// only B W threads (8192 at the cell: two warps per SM), so the walk is
// bound by the latency of each group of loads, not by the memory's rate; a
// chunked scan (per-chunk local scans, then a carry fix-up) is the later
// redesign that fills the card.  One warp per block spreads the warps over
// as many SMs as possible.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 32;      // threads per block: one warp
constexpr int UNROLL = 16;  // steps loaded ahead of the dependent chain

__global__ void __launch_bounds__(NT)
rglru_fwd_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                 const float* __restrict__ h0, float* __restrict__ h,
                 float* __restrict__ hT, int L, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;
  const int b = blockIdx.y;
  const size_t col = (size_t)b * L * W + w;
  float carry = h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;
  int t = 0;
  for (; t + UNROLL <= L; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t i = col + (size_t)(t + u) * W;
      av[u] = __ldg(a + i);
      bv[u] = __ldg(bx + i);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
      h[col + (size_t)(t + u) * W] = carry;
    }
  }
  for (; t < L; ++t) {
    const size_t i = col + (size_t)t * W;
    carry = __fadd_rn(__fmul_rn(__ldg(a + i), carry), __ldg(bx + i));
    h[i] = carry;
  }
  hT[(size_t)b * W + w] = carry;
}

// Reverse walk.  c carries a_{t+1} g_{t+1} (dhT at the start); h_{t-1} is
// read from the saved output, h0 (or 0) at t = 0.
__global__ void __launch_bounds__(NT)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ h0, const float* __restrict__ dh,
                 const float* __restrict__ dhT, float* __restrict__ da,
                 float* __restrict__ dbx, float* __restrict__ dh0, int L,
                 int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;
  const int b = blockIdx.y;
  const size_t col = (size_t)b * L * W + w;
  const float first = h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;
  float c = dhT[(size_t)b * W + w];
  int t = L;  // steps [t, L) are done
  for (; t - UNROLL >= 0; t -= UNROLL) {
    const int t0 = t - UNROLL;
    float av[UNROLL], dv[UNROLL], hp[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t i = col + (size_t)(t0 + u) * W;
      av[u] = __ldg(a + i);
      dv[u] = __ldg(dh + i);
      hp[u] = t0 + u > 0 ? __ldg(h + i - W) : first;
    }
#pragma unroll
    for (int u = UNROLL - 1; u >= 0; --u) {
      const size_t i = col + (size_t)(t0 + u) * W;
      const float g = __fadd_rn(dv[u], c);
      da[i] = __fmul_rn(g, hp[u]);
      dbx[i] = g;
      c = __fmul_rn(av[u], g);
    }
  }
  for (--t; t >= 0; --t) {
    const size_t i = col + (size_t)t * W;
    const float g = __fadd_rn(__ldg(dh + i), c);
    da[i] = __fmul_rn(g, t > 0 ? __ldg(h + i - W) : first);
    dbx[i] = g;
    c = __fmul_rn(__ldg(a + i), g);
  }
  if (dh0 != nullptr) dh0[(size_t)b * W + w] = c;
}

}  // namespace

extern "C" {

// h0 may be null (zero initial state).  Returns cudaGetLastError() after the
// launch.
int rglru_fwd(const float* a, const float* bx, const float* h0, float* h,
              float* hT, int B, int L, int W, cudaStream_t stream) {
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_fwd_kernel<<<grid, NT, 0, stream>>>(a, bx, h0, h, hT, L, W);
  return (int)cudaGetLastError();
}

// h0 and dh0 are both null or both set.
int rglru_bwd(const float* a, const float* h, const float* h0,
              const float* dh, const float* dhT, float* da, float* dbx,
              float* dh0, int B, int L, int W, cudaStream_t stream) {
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_bwd_kernel<<<grid, NT, 0, stream>>>(a, h, h0, dh, dhT, da, dbx, dh0,
                                            L, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
