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
// All three are FlashAttention-3's shape: TMA (cp.async.bulk.tensor,
// mbarriers with transaction counts) keeps a ring of tiles filled ahead of
// consumer warpgroups of 64 rows that run wgmma.  Every operand is a
// [rows][D] tile of q, k, v or dO in one layout: TMA's 64-byte swizzle,
// each row of D values D / 32 atoms of 32 columns (the forward's 128-byte
// swizzle: D / 64 atoms of 64 where D allows), one TMA box per atom;
// the wgmma descriptors walk atoms and 16-column k steps inside them.  Every
// product has one of two forms: SS (both operands K-major in shared
// memory: S = Q K^T and dP = dO V^T, and in the dk/dv kernel S^T = K Q^T
// and dP^T = V dO^T, the same tiles in the other roles) or RS (A from
// registers: P or dS in 16 bits, converted in the accumulator's layout,
// which is wgmma's A-fragment layout; B a [k][n] tile, N-major: O += P V,
// dQ += dS K, dV += P^T dO, dK += dS^T Q; up to 128 columns, four atoms,
// a wgmma).  Computing S^T and dP^T directly puts P^T
// and dS^T where the RS products take them, so nothing is staged through
// shared memory.  No wgmma sits under a branch that is not uniform over its
// warpgroup (ptxas serializes them there, C7520): masked tiles differ from
// whole ones in their elementwise code only.  An mbarrier wait of over 4 s
// traps (../../csrc/mma_16.cuh), so a lost arrival is an error, not a hang
// (the forward's named barriers have no timeout: turn_begin says why their
// arrivals balance).
//
// flash_fwd_16: a block per (q tile of 128 rows, query head, batch row),
// longest causal rows first; two consumer warpgroups of 64 query rows and
// no producer warp (Fwd16Cfg).  Thread 0 of warpgroup 1 loads Q once and
// a ring of two K/V stages by TMA, in band (K and V on barriers of their
// own): K_{i+2} once both warpgroups have S_i, V_{i+2} once both have
// P_i V_i.  Tiles are swizzled in 128-byte rows (64-column atoms) where D
// is a multiple of 64, else 64.  Per K/V tile S = Q K^T (SS), the online
// softmax in fp32 registers (base 2, exponentials on ex2.approx.ftz),
// O += P V (RS, one wgmma of D columns a 16-key step).  The softmax is
// specialized on the softcap and on the tile needing its per-pair mask,
// chosen by branches uniform over the warpgroup.  K/V tiles are 128 keys
// up to D 128 (O, S and P take D / 2 + 64 + 32 registers a thread) and 64
// at D 256 (128 + 32 + 16).  Within a warpgroup S_i is issued with
// P_{i-1} V_{i-1} and its softmax runs while that product does; between
// the two, named barriers make them take turns to issue those rounds, so
// one warpgroup's softmax runs under the other's products
// (FlashAttention-3's ping-pong).  O's fp32 accumulator stays in registers
// and is scaled and stored once.
//
// No kernel has a producer warp: a ninth warp puts three on one quarter
// of the SM's register file and caps every thread at 168 registers, which
// their accumulators overflow (ptxas does not raise a warpgroup's
// allocation after setmaxnreg).  A consumer refills the ring in band
// instead, as each stage comes free, and keeps 255.  Each backward kernel
// starts S (S^T) and dP (dP^T) together and computes p f, the softcap's
// factor folded in, while dP runs, then dS = p f (dP - delta).
//
// flash_bwd_dq_16: a block per (q tile, query head, batch row), longest
// causal rows first; Q and dO once, then a ring of K/V tiles loaded by
// thread 0 (Dq16Cfg: two warpgroups and 128-key tiles at D 128, else one
// warpgroup and 64-key tiles, two blocks an SM below D 256); per tile S and
// dP (SS), dS in registers, dQ += dS K (RS); dQ's fp32 accumulator (D / 2
// registers a thread) is scaled and stored once.
//
// flash_bwd_dkv_16: a block per (k tile, kv head, batch row, split of the
// kv head's group of query heads); K and V once, then a ring of Q / dO
// tiles with their lse and delta (warp 0: Q and dO by TMA, lse and delta by
// cp.async counted on the same barrier), walked head by head of the split,
// each head's visible q tiles in order; per tile S^T and dP^T (SS), P^T and
// dS^T in registers, dV += P^T dO while dS^T is computed, then dK += dS^T Q
// (RS).  dK and dV sum the group in fp32 registers and are cast once.  A
// warpgroup of 64 keys accumulates dK and dV (D registers a thread; at D 96
// and 128 one a block, two blocks an SM; at D <= 64 two a block, 128-row
// Q/dO tiles).  At D 256 that would be 256 registers, so two warpgroups
// share one 64-key tile, warpgroup 0 accumulating dV (S^T only) and
// warpgroup 1 dK (S^T and dP^T), 128 registers each (Dkv16Cfg).  With one
// split (the whole group in a block) dk and dv are stored in 16 bits
// directly; where the (k tile, kv head, batch row) grid alone would leave
// SMs idle, the group is cut into splits (dkv16_splits), each storing an
// fp32 partial that dkv_sum16_kernel adds in a fixed order.  Every sum has
// a fixed order, so two launches agree bit for bit.

#ifndef CUDA_EMU
#include <cuda.h>
#endif
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/mma_16.cuh"
#include "flash_common.cuh"

namespace {

// rows [row0, row0 + nrows) of head `head` of a (B, L, NH, D) tensor of E
// (fp32 or 16-bit) set to zero by `nthreads` threads
template <typename E, int D>
__device__ __forceinline__ void zero_head_rows(E* __restrict__ dst, int b,
                                               int row0, int nrows, int L,
                                               int NH, int head,
                                               int nthreads) {
  E z;
  if constexpr (std::is_same<E, float>::value) z = 0.f;
  else z = H16<E>::of_f(0.f);
  for (int i = threadIdx.x; i < nrows * D; i += nthreads) {
    const int r = i / D, c = i % D, row = row0 + r;
    if (row < L) dst[((size_t)(b * L + row) * NH + head) * D + c] = z;
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
  // a block a q tile of BQ query rows: two consumer warpgroups of 64 rows
  // share each K/V tile and take turns to issue their products; 128-key
  // tiles up to D 128, 64-key tiles at D 256 (O is 128 registers a thread
  // there); P V one wgmma of RS_N columns a 16-key step (measured on the
  // card with tools/kernel_variants.py --flash16-fwd)
  static constexpr int BK = D <= 128 ? 128 : 64;  // keys of a K/V tile
  static constexpr int STAGES = 2;                // K/V tiles in the ring
  static constexpr int RS_N = D;                  // columns of a P V wgmma
  static constexpr int BQ = 128;                  // query rows of a block
  // the consumer warpgroups alone, one thread of the last refilling the
  // ring as it goes (no producer warp: a ninth warp would cap every thread
  // at 168 registers, and O, S and P take up to 176)
  static constexpr int NTF = 2 * BQ;
  // tiles in rows of SW bytes swizzled, atoms of SW / 2 columns: 128 where
  // D is a multiple of 64, else 64
  static constexpr int SW = D % 64 == 0 ? 128 : 64;
  static constexpr int AC = SW / 2;               // columns of an atom
  static constexpr int ATOMS = D / AC;
  static constexpr uint32_t q_bytes = BQ * D * 2, kv_bytes = BK * D * 2;
  // Q, STAGES x (K, V), 4 STAGES + 1 barriers, 1 KB to align the tiles
  static constexpr size_t smem =
      1024 + q_bytes + 2 * STAGES * kv_bytes + (4 * STAGES + 1) * 8;
};
// S = Q K^T for one warpgroup: D / 16 k steps, SW / 32 an atom of SW / 2
// columns (the descriptors step 32 bytes into an atom, then to the next
// atom; rows SW bytes apart); the first overwrites s
template <typename T, int D, int BQ, int BK, int SW = 64>
__device__ __forceinline__ void fwd_qk(float (&s)[BK / 2], uint32_t q_base,
                                       uint32_t k_base) {
  constexpr int KA = SW / 32;  // k steps an atom
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % KA) * 32;  // bytes into the atom
    wgmma_ss<T, BK>(
        s, wg_desc<SW>(q_base + (kk / KA) * BQ * SW + off, 16, 8 * SW),
        wg_desc<SW>(k_base + (kk / KA) * BK * SW + off, 16, 8 * SW), kk > 0);
  }
}

// acc (64 x D fp32: D / 32 groups of 16 values a thread) += A B, A the K /
// 16 k steps of af (16-bit A fragments), B a [K][D] tile at b_base
// (N-major: atoms of SW / 2 columns, K * SW bytes apart, rows SW bytes
// apart): one wgmma of RS_N columns a k step and column group.  O += P V in
// the forward, dQ += dS K, dV += P^T dO and dK += dS^T Q in the backward.
template <typename T, int D, int K, int RS_N, int SW = 64>
__device__ __forceinline__ void rs_product(float (&acc)[D / 32][16],
                                           const uint32_t (&af)[K / 16][4],
                                           uint32_t b_base) {
  constexpr int AC = SW / 2;  // columns of an atom
  static_assert(D % RS_N == 0 && RS_N % AC == 0, "whole column groups");
  constexpr int G = RS_N / AC;                          // atoms a wgmma
  constexpr uint32_t lbo = G == 1 ? 8 * SW : K * SW;    // atom to atom
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int c = 0; c < D / RS_N; ++c)
      wgmma_rs<T, RS_N>(
          *reinterpret_cast<float(*)[RS_N / 2]>(&acc[c * RS_N / 32][0]),
          af[kk],
          wg_desc<SW>(b_base + c * G * K * SW + kk * 16 * SW, lbo, 8 * SW));
}

// the online softmax of one S tile (raw scores, fp32) in base 2, for a
// softcap (CAP) or none and with the per-pair mask (MASK) or without it
// (every pair of the warpgroup's rows and the tile's keys visible): the
// new row maxima m (base-2 units), p = 2^(x - m) in place, l rescaled and
// summed (this thread's columns; the quad's are added at the end); alpha
// rescales O.  Without a softcap the scale is folded into the exponent's
// fma.  Thread rows qrow and qrow + 8 (query positions before the shift),
// keys from k_first.
template <int BK, bool CAP, bool MASK>
__device__ __forceinline__ void fwd_softmax_of(float (&s)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int qrow,
                                               int k_first, const Geom& g) {
  const int tq = lane_t(), shift = g.T - g.S;
  // x (below) times f is the base-2 exponent
  const float f = CAP ? 1.f : g.sm_scale * LOG2E;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int hh = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * tq + (e & 1);
    float x = s[e];
    if constexpr (CAP)
      x = g.softcap * LOG2E * tanhf(x * (g.sm_scale / g.softcap));
    if (MASK && !pair_visible(qrow + 8 * hh + shift, k_first + c, g))
      x = NEG_INF;
    s[e] = x;
    mx[hh] = fmaxf(mx[hh], x);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float m_cur = fmaxf(m[hh], quad_max(mx[hh]) * f);
    alpha[hh] = ex2(m[hh] - m_cur);
    m[hh] = m_cur;
    l[hh] *= alpha[hh];
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int hh = (e >> 1) & 1;
    // a masked pair is 0 also where its row has seen no visible key yet
    // (m then holds the scaled NEG_INF, which fma does not cancel exactly)
    const float p = ex2(fmaf(s[e], f, -m[hh]));
    s[e] = MASK && s[e] == NEG_INF ? 0.f : p;
    l[hh] += s[e];
  }
}

// fwd_softmax_of chosen by branches uniform over the warpgroup (`whole`
// is the warpgroup's, the softcap the launch's), none holding a wgmma
template <int BK>
__device__ __forceinline__ void fwd_softmax(float (&s)[BK / 2], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2],
                                            bool whole, int qrow, int k_first,
                                            const Geom& g) {
  if (g.softcap > 0.f) {
    if (whole) fwd_softmax_of<BK, true, false>(s, m, l, alpha, qrow, k_first, g);
    else fwd_softmax_of<BK, true, true>(s, m, l, alpha, qrow, k_first, g);
  } else {
    if (whole) fwd_softmax_of<BK, false, false>(s, m, l, alpha, qrow, k_first, g);
    else fwd_softmax_of<BK, false, true>(s, m, l, alpha, qrow, k_first, g);
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

// The warpgroups' turns: warpgroup wg issues a round of products (S_i with
// P_{i-1} V_{i-1}) only after the other has issued its previous round, so
// that one's softmax runs while the other's products do.  Named barrier
// 1 + wg is wg's turn: it waits there with the other's 128 threads
// arriving.  Both warpgroups walk the same n K/V tiles, n + 1 rounds each;
// warpgroup 1 arrives once ahead (warpgroup 0 goes first) and not after its
// last round, so every wait meets exactly one arrival.  bar.sync has no
// timeout, so these waits are outside the 4-s barrier trap: the balance
// holds because the round counts are equal by construction, and an edit
// that lets them differ hangs the card instead of trapping.
__device__ __forceinline__ void turn_begin(int wg) { named_sync(1 + wg, 256); }

__device__ __forceinline__ void turn_end(int wg, bool last) {
  if (!(wg == 1 && last)) named_arrive(2 - wg, 256);
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
  constexpr int SW = C::SW, AC = C::AC, OG = D / 32;  // O: OG x 16 a thread
  extern __shared__ __align__(1024) uint8_t fwd_smem[];
  uint8_t* base = fwd_smem + ((1024 - (smem_u32(fwd_smem) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);  // AT atoms of BQ x AC
  T* Ks = reinterpret_cast<T*>(base + C::q_bytes);  // ST x AT x BK x AC
  T* Vs = reinterpret_cast<T*>(base + C::q_bytes + ST * C::kv_bytes);
  // a full and an empty barrier for each stage's K and for its V: K_i
  // comes back to the loader once S_i is done, V_i once P_i V_i is
  uint64_t* k_full =
      reinterpret_cast<uint64_t*>(base + C::q_bytes + 2 * ST * C::kv_bytes);
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;
  uint64_t* q_full = v_empty + ST;

  const int per = g.H * g.B, nq = (g.S + BQ - 1) / BQ;
  const int iq = nq - 1 - (int)(blockIdx.x / per);  // longest rows first
  const int h = (int)(blockIdx.x % per) % g.H;
  const int b = (int)(blockIdx.x % per) / g.H, kvh = h / (g.H / g.Hkv);
  const int row0 = iq * BQ;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    zero_head_rows<T, D>(out, b, row0, BQ, g.S, g.H, h, C::NTF);
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
      mbar_init(&k_empty[s], C::NTF / 32);  // a warp's lane 0
      mbar_init(&v_empty[s], C::NTF / 32);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the loader, thread 0 of the last warpgroup (the one that issues its
  // products second, so the other is done with a stage first): Q once, the
  // ring's first ST tiles, then K_{i+ST} once both have S_i and V_{i+ST}
  // once both have P_i V_i
  const int wg = threadIdx.x >> 7;
  const bool loader = threadIdx.x == C::NTF - 128;
  auto load = [&](const CUtensorMap* map, T* ring, uint64_t* full, int i) {
    const int st = i % ST;
    mbar_expect_tx(&full[st], C::kv_bytes);
    for (int a = 0; a < AT; ++a)
      tma_load_4d(ring + (st * AT + a) * BK * AC, map, &full[st], AC * a, kvh,
                  (range.x + i) * BK, b);
  };
  if (loader) {
    mbar_expect_tx(q_full, C::q_bytes);
    for (int a = 0; a < AT; ++a)
      tma_load_4d(Qs + a * BQ * AC, &tm_q, q_full, AC * a, h, row0, b);
    for (int i = 0; i < min(n, ST); ++i) {
      load(&tm_k, Ks, k_full, i);
      load(&tm_v, Vs, v_full, i);
    }
  }
  __syncwarp();
  // K_i back to the loader (each warp's lane 0 arrives; the loader then
  // refills its stage with K_{i+ST}), and V_i alike
  auto release = [&](const CUtensorMap* map, T* ring, uint64_t* full,
                     uint64_t* empty, int i) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[i % ST]);
    if (loader && i + ST < n) {
      mbar_wait(&empty[i % ST], (i / ST) & 1);
      load(map, ring, full, i + ST);
    }
    __syncwarp();
  };

  // warpgroup wg owns query rows row0 + 64 wg .. + 63; warp w of it rows
  // 16 w .. + 15 of those (thread rows gq and gq + 8).  Tile i's S = Q K_i^T
  // is issued with P_{i-1} V_{i-1}; its softmax runs while that product
  // (and the other warpgroup's round) does, then O is rescaled and P_i
  // converted.  No wgmma sits under a branch (ptxas serializes wgmma in
  // paths it cannot prove uniform).
  const int w = (threadIdx.x >> 5) & 3, gq = lane_g(), tq = lane_t();
  const int qr0 = row0 + 64 * wg, qrow = qr0 + 16 * w + gq;
  float o[OG][16], s[BK / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f},
                              alpha[2];
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int a = 0; a < OG; ++a)
#pragma unroll
    for (int e = 0; e < 16; ++e) o[a][e] = 0.f;

  const uint32_t q_base = smem_u32(Qs) + wg * 64 * SW;
  const uint32_t k0_base = smem_u32(Ks), v0_base = smem_u32(Vs);
  if (wg == 1) named_arrive(1, 256);  // warpgroup 0 goes first
  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  turn_begin(wg);
  wg_fence();
  fwd_qk<T, D, BQ, BK, SW>(s, q_base, k0_base);
  wg_commit();
  turn_end(wg, false);
  wg_wait<0>();
  release(&tm_k, Ks, k_full, k_empty, 0);
  fence_regs(s);
  fwd_softmax<BK>(s, m, l, alpha, tile_whole(qr0, 64, range.x * BK, BK, g),
                  qrow, range.x * BK, g);
  fwd_p16<T, BK>(s, pf);
  for (int i = 1; i < n; ++i) {
    const int st = i % ST, prev = (i - 1) % ST, k_first = (range.x + i) * BK;
    const bool whole = tile_whole(qr0, 64, k_first, BK, g);
    mbar_wait(&k_full[st], (i / ST) & 1);
    mbar_wait(&v_full[prev], ((i - 1) / ST) & 1);
    turn_begin(wg);
    wg_fence();
    // S_i, then P_{i-1} V_{i-1}, which runs under S_i's softmax
    fwd_qk<T, D, BQ, BK, SW>(s, q_base, k0_base + st * C::kv_bytes);
    wg_commit();
    rs_product<T, D, BK, C::RS_N, SW>(o, pf, v0_base + prev * C::kv_bytes);
    wg_commit();
    turn_end(wg, false);
    wg_wait<1>();  // S_i has landed; P_{i-1} V_{i-1} may still run
    release(&tm_k, Ks, k_full, k_empty, i);
    fence_regs(s);
    fwd_softmax<BK>(s, m, l, alpha, whole, qrow, k_first, g);
    wg_wait<0>();
    release(&tm_v, Vs, v_full, v_empty, i - 1);
#pragma unroll
    for (int a = 0; a < OG; ++a) {
      fence_regs(o[a]);
#pragma unroll
      for (int e = 0; e < 16; ++e) o[a][e] *= alpha[(e >> 1) & 1];
    }
    fwd_p16<T, BK>(s, pf);
  }
  mbar_wait(&v_full[(n - 1) % ST], ((n - 1) / ST) & 1);
  turn_begin(wg);
  wg_fence();
  rs_product<T, D, BK, C::RS_N, SW>(o, pf,
                                    v0_base + ((n - 1) % ST) * C::kv_bytes);
  wg_commit();
  turn_end(wg, true);
  wg_wait<0>();
#pragma unroll
  for (int a = 0; a < OG; ++a) fence_regs(o[a]);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l_row = quad_sum(l[hh]);
    const int s_row = qrow + 8 * hh;
    if (s_row >= g.S) continue;
    const float l_safe = fmaxf(l_row, 1e-20f), inv = 1.f / l_safe;
    T* o_row = out + ((size_t)(b * g.S + s_row) * g.H + h) * D;
#pragma unroll
    for (int a = 0; a < OG; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(o_row + 32 * a + 8 * j + 2 * tq) =
            pack2<T>(o[a][4 * j + 2 * hh] * inv,
                     o[a][4 * j + 2 * hh + 1] * inv);
    if (tq == 0)
      lse[((size_t)b * g.H + h) * g.S + s_row] = (m[hh] + log2f(l_safe)) * LN2;
  }
}
#endif  // CUDA_EMU

#ifndef CUDA_EMU
// ---------------------------------------------------------------- backward
//
// Per visible (q tile, kv tile) pair, as in the reference's _bwd_tile:
//   s_soft = softcap(q k^T * sm_scale)    p  = exp(s_soft - lse), masked to 0
//   dp = dO v^T                           ds = p (dp - delta) [* (1 - (s_soft/cap)^2)]
//   dq += ds k * sm_scale   dk += ds^T q * sm_scale   dv += p^T dO
// An accumulator value e of a thread sits at row 16 w + g + 8 ((e >> 1) & 1)
// of its warpgroup's 64 and column 8 (e >> 2) + 2 t + (e & 1).

// exp(s_soft - lse) of one raw score s (lse2 = lse log2(e)); f is the
// softcap's factor 1 - (s_soft / cap)^2 on dS (CAP), else 1
template <bool CAP>
__device__ __forceinline__ float bwd_p(float s, float lse2, const Geom& g,
                                       float& f) {
  if constexpr (CAP) {
    const float t = tanhf(s * g.sm_scale / g.softcap);
    f = 1.f - t * t;
    return ex2(g.softcap * LOG2E * t - lse2);
  } else {
    f = 1.f;
    return ex2(s * (g.sm_scale * LOG2E) - lse2);
  }
}

// The products of a tile are started together and their elementwise work
// is split in two passes, so that the first runs while the second product
// does: p f (masked) from S alone, then dS = p f (dP - delta) once dP has
// landed (p (dP - delta) f in the reference's order: an fp32 rounding
// apart).  The first pass is specialized on the softcap (CAP) and on the
// tile needing its per-pair mask (MASK: not `whole`), chosen by a branch
// that is uniform over the block and holds no wgmma.

// the dq kernel's first pass: s (S = Q K^T) becomes p f in place.  Rows are
// the queries qrow and qrow + 8 (positions before the shift; lse2 theirs),
// columns keys from k_first.
template <int BK, bool CAP, bool MASK>
__device__ __forceinline__ void dq_pf_of(float (&s)[BK / 2],
                                         const float (&lse2)[2], int qrow,
                                         int k_first, const Geom& g) {
  const int tq = lane_t(), shift = g.T - g.S;
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int hh = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * tq + (e & 1);
    const int r = qrow + 8 * hh;
    float f, p = bwd_p<CAP>(s[e], lse2[hh], g, f);
    if (MASK && !(r < g.S && pair_visible(r + shift, k_first + c, g)))
      p = 0.f;
    s[e] = p * f;
  }
}

template <int BK>
__device__ __forceinline__ void dq_pf(float (&s)[BK / 2],
                                      const float (&lse2)[2], bool whole,
                                      int qrow, int k_first, const Geom& g) {
  if (g.softcap > 0.f) {
    if (whole) dq_pf_of<BK, true, false>(s, lse2, qrow, k_first, g);
    else dq_pf_of<BK, true, true>(s, lse2, qrow, k_first, g);
  } else {
    if (whole) dq_pf_of<BK, false, false>(s, lse2, qrow, k_first, g);
    else dq_pf_of<BK, false, true>(s, lse2, qrow, k_first, g);
  }
}

// the dk/dv kernel's first pass: P^T of s (S^T = K Q^T) into pf, in 16
// bits as wgmma's A fragments, and, when PF, p f into s in place.  Rows are
// the keys krow and krow + 8, columns queries from row0 (lse_s: the tile's
// lse, one a query).
template <typename T, int BQ, bool PF, bool CAP, bool MASK>
__device__ __forceinline__ void dkv_p_of(float (&s)[BQ / 2],
                                         uint32_t (&pf)[BQ / 16][4],
                                         const float* lse_s, int krow,
                                         int row0, const Geom& g) {
  const int tq = lane_t(), shift = g.T - g.S;
#pragma unroll
  for (int m = 0; m < BQ / 4; ++m) {
    float p[2], f[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int e = 2 * m + x, hh = (e >> 1) & 1;
      const int c = 8 * (e >> 2) + 2 * tq + x;
      p[x] = bwd_p<CAP>(s[e], lse_s[c] * LOG2E, g, f[x]);
      if (MASK && !(row0 + c < g.S &&
                    pair_visible(row0 + c + shift, krow + 8 * hh, g)))
        p[x] = 0.f;
      if constexpr (PF) s[e] = p[x] * f[x];
    }
    pf[m >> 2][m & 3] = pack2<T>(p[0], p[1]);
  }
}

template <typename T, int BQ, bool PF>
__device__ __forceinline__ void dkv_p(float (&s)[BQ / 2],
                                      uint32_t (&pf)[BQ / 16][4],
                                      const float* lse_s, bool whole,
                                      int krow, int row0, const Geom& g) {
  if (g.softcap > 0.f) {
    if (whole) dkv_p_of<T, BQ, PF, true, false>(s, pf, lse_s, krow, row0, g);
    else dkv_p_of<T, BQ, PF, true, true>(s, pf, lse_s, krow, row0, g);
  } else {
    if (whole) dkv_p_of<T, BQ, PF, false, false>(s, pf, lse_s, krow, row0, g);
    else dkv_p_of<T, BQ, PF, false, true>(s, pf, lse_s, krow, row0, g);
  }
}

// the second pass: ds = (p f) (dp - delta) into `out`, delta a row's (the
// dq kernel: dlt[hh]) or a column's (the dk/dv kernel: dlt_s[c])
template <int N, bool ROW_DELTA>
__device__ __forceinline__ void bwd_ds(float (&out)[N / 2],
                                       const float (&pf)[N / 2],
                                       const float (&dp)[N / 2],
                                       const float* dlt) {
  const int tq = lane_t();
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const int hh = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * tq + (e & 1);
    out[e] = pf[e] * (dp[e] - dlt[ROW_DELTA ? hh : c]);
  }
}

// the widest RS product a head dim takes whole: 128 columns, else 64, else 32
template <int D>
constexpr int rs_width() {
  return D % 128 == 0 ? 128 : D % 64 == 0 ? 64 : 32;
}

// a warpgroup's 64 x D fp32 accumulator times `scale` into the thread's
// rows `row` and row + 8 (those below L) of head `head` of a (B, L, NH, D)
// tensor: fp32 when f32, else T
template <typename T, int D>
__device__ __forceinline__ void store_rows(void* dst,
                                           const float (&acc)[D / 32][16],
                                           float scale, bool f32, int b,
                                           int row, int L, int NH, int head) {
  const int tq = lane_t();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r >= L) continue;
    const size_t at = ((size_t)(b * L + r) * NH + head) * D;
#pragma unroll
    for (int a = 0; a < D / 32; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * a + 8 * j + 2 * tq;
        const float x0 = acc[a][4 * j + 2 * hh] * scale,
                    x1 = acc[a][4 * j + 2 * hh + 1] * scale;
        if (f32)
          *reinterpret_cast<float2*>(static_cast<float*>(dst) + at + c) =
              make_float2(x0, x1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<T*>(dst) + at + c) =
              pack2<T>(x0, x1);
      }
  }
}

template <int D>
struct Dq16Cfg {
  // D 128: two warpgroups (128 query rows) and 128-key tiles; else one
  // warpgroup and 64-key tiles, two blocks an SM below D 256 (measured on
  // the card with tools/kernel_variants.py --flash16)
  static constexpr int NWG = D == 128 ? 2 : 1;    // consumer warpgroups
  static constexpr int MINB = D <= 96 ? 2 : 1;    // blocks an SM
  static constexpr int BQ = 64 * NWG;             // query rows of a block
  static constexpr int BK = D == 128 ? 128 : 64;  // keys of a K/V tile
  static constexpr int STAGES = 2;                // K/V tiles in the ring
  static constexpr int RS_N = rs_width<D>();      // columns of a dQ wgmma
  // the consumer warpgroups alone, thread 0 loading the ring as it goes
  // (as in the dk/dv kernel: no ninth warp, so 255 registers a thread hold
  // S and dP of 128-key tiles beside dQ at D <= 128)
  static constexpr int NTF = 128 * NWG;
  static constexpr int ATOMS = D / 32;            // 64-byte swizzle atoms
  static constexpr uint32_t q_bytes = BQ * D * 2, kv_bytes = BK * D * 2;
  // Q, dO, STAGES x (K, V), 2 STAGES + 1 barriers, 1 KB to align the tiles
  static constexpr size_t smem = 1024 + 2 * q_bytes + 2 * STAGES * kv_bytes +
                                 (2 * STAGES + 1) * 8;
};

template <typename T, int D>
__global__ void __launch_bounds__(Dq16Cfg<D>::NTF, Dq16Cfg<D>::MINB)
    dq16_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int* __restrict__ nv_ptr, T* __restrict__ dq, Geom g) {
  using C = Dq16Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES, AT = C::ATOMS;
  extern __shared__ __align__(1024) uint8_t dq_smem[];
  uint8_t* base = dq_smem + ((1024 - (smem_u32(dq_smem) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);  // AT atoms of BQ x 32
  T* dOs = reinterpret_cast<T*>(base + C::q_bytes);
  T* Ks = reinterpret_cast<T*>(base + 2 * C::q_bytes);  // ST x AT x BK x 32
  T* Vs = reinterpret_cast<T*>(base + 2 * C::q_bytes + ST * C::kv_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + 2 * C::q_bytes +
                                               2 * ST * C::kv_bytes);
  uint64_t* empty = full + ST;  // every consumer is done with the stage
  uint64_t* q_full = empty + ST;

  const int per = g.H * g.B, nq = (g.S + BQ - 1) / BQ;
  const int iq = nq - 1 - (int)(blockIdx.x / per);  // longest rows first
  const int h = (int)(blockIdx.x % per) % g.H, b = (int)(blockIdx.x % per) / g.H;
  const int kvh = h / (g.H / g.Hkv);
  const int row0 = iq * BQ;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    zero_head_rows<T, D>(dq, b, row0, BQ, g.S, g.H, h, C::NTF);
    return;
  }

  const int2 range = visible_range<true>((g.T + BK - 1) / BK, BK, row0, BQ, g);
  const int n = range.y - range.x + 1;  // >= 1: a query sees its own key
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NTF);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // thread 0 loads: Q and dO once, K and V of kv tile i into stage i % ST
  const bool loader = threadIdx.x == 0;
  auto load = [&](int i) {
    const int st = i % ST, key0 = (range.x + i) * BK;
    mbar_expect_tx(&full[st], 2 * C::kv_bytes);
    for (int a = 0; a < AT; ++a) {
      tma_load_4d(Ks + (st * AT + a) * BK * 32, &tm_k, &full[st], 32 * a,
                  kvh, key0, b);
      tma_load_4d(Vs + (st * AT + a) * BK * 32, &tm_v, &full[st], 32 * a,
                  kvh, key0, b);
    }
  };
  if (loader) {
    mbar_expect_tx(q_full, 2 * C::q_bytes);
    for (int a = 0; a < AT; ++a) {
      tma_load_4d(Qs + a * BQ * 32, &tm_q, q_full, 32 * a, h, row0, b);
      tma_load_4d(dOs + a * BQ * 32, &tm_do, q_full, 32 * a, h, row0, b);
    }
    for (int i = 0; i < min(n, ST); ++i) load(i);
  }
  __syncwarp();

  // warpgroup wg owns query rows row0 + 64 wg .. + 63, warp w of it rows
  // 16 w .. + 15 of those (thread rows gq and gq + 8)
  const int warp = threadIdx.x >> 5, wg = warp >> 2, w = warp & 3;
  const int qr0 = row0 + 64 * wg, qrow = qr0 + 16 * w + lane_g();
  const size_t at = ((size_t)b * g.H + h) * g.S;
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = qrow + 8 * hh;
    lse2[hh] = r < g.S ? lse[at + r] * LOG2E : 0.f;
    dlt[hh] = r < g.S ? delta[at + r] : 0.f;
  }
  float acc[AT][16], s[BK / 2], dp[BK / 2];
  uint32_t dsf[BK / 16][4];
#pragma unroll
  for (int a = 0; a < AT; ++a)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[a][e] = 0.f;

  const uint32_t q_base = smem_u32(Qs) + wg * 64 * 64;
  const uint32_t do_base = smem_u32(dOs) + wg * 64 * 64;
  const uint32_t k0_base = smem_u32(Ks), v0_base = smem_u32(Vs);
  // tile i's S and dP are started together; p f runs while dP does.  Before
  // tile i, thread 0 refills the stage tile i - 1 freed with tile i - 1 + ST.
  mbar_wait(q_full, 0);
  for (int i = 0; i < n; ++i) {
    if (loader && i > 0 && i - 1 + ST < n) {
      mbar_wait(&empty[(i - 1) % ST], ((i - 1) / ST) & 1);
      load(i - 1 + ST);
    }
    __syncwarp();
    const int st = i % ST, k_first = (range.x + i) * BK;
    const uint32_t k_base = k0_base + st * C::kv_bytes;
    mbar_wait(&full[st], (i / ST) & 1);
    wg_fence();
    fwd_qk<T, D, BQ, BK>(s, q_base, k_base);
    wg_commit();
    fwd_qk<T, D, BQ, BK>(dp, do_base, v0_base + st * C::kv_bytes);
    wg_commit();
    wg_wait<1>();  // S has landed; dP may still run
    fence_regs(s);
    dq_pf<BK>(s, lse2, tile_whole(qr0, 64, k_first, BK, g), qrow, k_first,
              g);
    wg_wait<0>();
    fence_regs(dp);
    bwd_ds<BK, true>(s, s, dp, dlt);
    fwd_p16<T, BK>(s, dsf);
    wg_fence();
    rs_product<T, D, BK, C::RS_N>(acc, dsf, k_base);
    wg_commit();
    wg_wait<0>();
    mbar_arrive(&empty[st]);
  }
#pragma unroll
  for (int a = 0; a < AT; ++a) fence_regs(acc[a]);
  store_rows<T, D>(dq, acc, g.sm_scale, false, b, qrow, g.S, g.H, h);
}

template <int D>
struct Dkv16Cfg {
  // a warpgroup of 64 keys accumulates dK and dV: one a block, two blocks
  // an SM at D 96 and 128; two a block and 128-row Q/dO tiles at D <= 64
  // (measured on the card with tools/kernel_variants.py --flash16).  D 256
  // (ROLES): one 64-key tile, warpgroup 0 accumulating dV and warpgroup 1 dK
  static constexpr bool ROLES = D > 128;
  static constexpr int NWG = ROLES || D <= 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int MINB = NWG == 1 ? 2 : 1;         // blocks an SM
  static constexpr int BK = ROLES ? 64 : 64 * NWG;      // keys of a block
  static constexpr int BQ = D <= 64 ? 128 : 64;  // query rows of a Q/dO tile
  static constexpr int STAGES = NWG == 2 && !ROLES ? 3 : 2;  // ring's tiles
  static constexpr int RS_N = rs_width<D>();    // columns of a dK, dV wgmma
  // the consumer warpgroups alone, warp 0 loading the ring as it goes (no
  // producer warp: dK, dV, S^T and dP^T take 192 registers a thread at D
  // 128, over the 168 a ninth warp would leave)
  static constexpr int NTF = 128 * NWG;
  static constexpr int ATOMS = D / 32;          // 64-byte swizzle atoms
  static_assert(!ROLES || NWG == 2, "the roles take two warpgroups");
  static constexpr uint32_t kv_bytes = BK * D * 2, q_bytes = BQ * D * 2;
  // K, V, STAGES x (Q, dO), STAGES x (lse, delta), 2 STAGES + 1
  // barriers, 1 KB to align the tiles
  static constexpr size_t smem = 1024 + 2 * kv_bytes +
                                 STAGES * (2 * q_bytes + 2 * BQ * 4) +
                                 (2 * STAGES + 1) * 8;
};

// the dk/dv kernel's ring of Q/dO tiles, filled by warp 0: item i (query
// head h0 + i / nvis, q tile first + i % nvis) into stage i % STAGES, Q and
// dO by TMA (lane 0), its lse and delta by the warp's lanes' cp.async (zero
// past S); each lane's arrival on the stage's full barrier comes when its
// copies have landed, so the warp does not wait for them
template <typename T, int D>
struct DkvRing {
  const CUtensorMap* tm_q;
  const CUtensorMap* tm_do;
  const float* lse;
  const float* delta;
  T* Qs;
  T* dOs;
  float* rows;
  uint64_t* full;
  int nvis, first, h0, b;

  __device__ __forceinline__ void load(int i, const Geom& g) const {
    using C = Dkv16Cfg<D>;
    constexpr int BQ = C::BQ, AT = C::ATOMS;
    const int st = i % C::STAGES, lane = threadIdx.x & 31;
    const int hq = h0 + i / nvis, r0 = (first + i % nvis) * BQ;
    const size_t at = ((size_t)b * g.H + hq) * g.S + r0;
    float* row_s = rows + st * 2 * BQ;
    if (lane == 0) {
      mbar_expect_tx_only(&full[st], 2 * C::q_bytes);
      for (int a = 0; a < AT; ++a) {
        tma_load_4d(Qs + (st * AT + a) * BQ * 32, tm_q, &full[st], 32 * a, hq,
                    r0, b);
        tma_load_4d(dOs + (st * AT + a) * BQ * 32, tm_do, &full[st], 32 * a,
                    hq, r0, b);
      }
    }
    for (int r = lane; r < BQ; r += 32) {
      const bool in = r0 + r < g.S;
      cp_async4(row_s + r, in ? lse + at + r : lse, in ? 4 : 0);
      cp_async4(row_s + BQ + r, in ? delta + at + r : delta, in ? 4 : 0);
    }
    mbar_arrive_cp_async(&full[st]);
  }
};

// one consumer warpgroup of the dk/dv kernel: keys key0 .. + 63 of the
// block's K and V tiles (k_base, v_base: its rows), over the n items of
// the ring (n / nvis heads of nvis q tiles each); accumulates dK (DK) and
// dV (DV) and stores them into head `oh` of (B, T, out_heads, D) dk / dv,
// fp32 when f32.  Warp 0 of the block, before item i, refills the stage
// that item i - 1 freed with item i - 1 + STAGES.
template <typename T, int D, bool DK, bool DV>
__device__ __forceinline__ void dkv_consume(
    uint32_t k_base, uint32_t v_base, uint32_t q0_base, uint32_t do0_base,
    const DkvRing<T, D>& ring, uint64_t* kv_full, uint64_t* empty, int n,
    int key0, void* dk, void* dv, bool f32, int out_heads, int oh,
    const Geom& g) {
  using C = Dkv16Cfg<D>;
  constexpr int BQ = C::BQ, ST = C::STAGES, AT = C::ATOMS;
  const bool loader = threadIdx.x < 32;
  const int krow = key0 + 16 * ((threadIdx.x >> 5) & 3) + lane_g();
  float dk_acc[AT][16], dv_acc[AT][16], s[BQ / 2], dp[BQ / 2];
  uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
  for (int a = 0; a < AT; ++a)
#pragma unroll
    for (int e = 0; e < 16; ++e) dk_acc[a][e] = dv_acc[a][e] = 0.f;

  if (n > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n; ++i) {
    if (loader && i > 0 && i - 1 + ST < n) {
      mbar_wait(&empty[(i - 1) % ST], ((i - 1) / ST) & 1);
      ring.load(i - 1 + ST, g);
    }
    __syncwarp();
    const int st = i % ST, row0 = (ring.first + i % ring.nvis) * BQ;
    const uint32_t q_base = q0_base + st * C::q_bytes;
    const uint32_t do_base = do0_base + st * C::q_bytes;
    const float* lse_s = ring.rows + st * 2 * BQ;
    mbar_wait(&ring.full[st], (i / ST) & 1);
    const bool whole = tile_whole(row0, BQ, key0, 64, g);
    wg_fence();
    fwd_qk<T, D, C::BK, BQ>(s, k_base, q_base);
    wg_commit();
    if constexpr (DK) {
      fwd_qk<T, D, C::BK, BQ>(dp, v_base, do_base);
      wg_commit();
    }
    wg_wait<DK ? 1 : 0>();  // S^T has landed; dP^T may still run
    fence_regs(s);
    dkv_p<T, BQ, DK>(s, pf, lse_s, whole, krow, row0, g);
    if constexpr (DV) {
      wg_fence();
      rs_product<T, D, BQ, C::RS_N>(dv_acc, pf, do_base);
      wg_commit();
    }
    if constexpr (DK) {
      wg_wait<DV ? 1 : 0>();  // dP^T has landed; dV += P^T dO may still run
      fence_regs(dp);
      bwd_ds<BQ, false>(dp, s, dp, lse_s + BQ);
      fwd_p16<T, BQ>(dp, dsf);
      wg_fence();
      rs_product<T, D, BQ, C::RS_N>(dk_acc, dsf, q_base);
      wg_commit();
    }
    wg_wait<0>();
    mbar_arrive(&empty[st]);
  }
  if constexpr (DK) {
#pragma unroll
    for (int a = 0; a < AT; ++a) fence_regs(dk_acc[a]);
    store_rows<T, D>(dk, dk_acc, g.sm_scale, f32, ring.b, krow, g.T,
                     out_heads, oh);
  }
  if constexpr (DV) {
#pragma unroll
    for (int a = 0; a < AT; ++a) fence_regs(dv_acc[a]);
    store_rows<T, D>(dv, dv_acc, 1.f, f32, ring.b, krow, g.T, out_heads, oh);
  }
}

// one block per (k tile, kv head, batch row, split of the kv head's group of
// query heads): dk / dv of the split's heads summed in fp32 registers,
// stored in 16 bits into (B, T, Hkv, D) dk / dv when splits == 1, else as
// fp32 partials into head kvh * splits + split of (B, T, Hkv splits, D)
// ones that dkv_sum16_kernel adds
template <typename T, int D>
__global__ void __launch_bounds__(Dkv16Cfg<D>::NTF, Dkv16Cfg<D>::MINB)
    dkv16_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ nv_ptr, void* __restrict__ dk,
                 void* __restrict__ dv, int splits, Geom g) {
  using C = Dkv16Cfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, ST = C::STAGES, AT = C::ATOMS;
  extern __shared__ __align__(1024) uint8_t dkv_smem[];
  uint8_t* base = dkv_smem + ((1024 - (smem_u32(dkv_smem) & 1023)) & 1023);
  T* Ks = reinterpret_cast<T*>(base);  // AT atoms of BK x 32
  T* Vs = reinterpret_cast<T*>(base + C::kv_bytes);
  T* Qs = reinterpret_cast<T*>(base + 2 * C::kv_bytes);  // ST x AT x BQ x 32
  T* dOs = reinterpret_cast<T*>(base + 2 * C::kv_bytes + ST * C::q_bytes);
  // ST x (BQ lse, BQ delta)
  float* rows = reinterpret_cast<float*>(base + 2 * C::kv_bytes +
                                         2 * ST * C::q_bytes);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows + ST * 2 * BQ);
  uint64_t* full = kv_full + 1;  // a stage's Q, dO, lse and delta landed
  uint64_t* empty = full + ST;   // every consumer is done with the stage

  const int per = g.Hkv * g.B * splits;
  const int ik = (int)(blockIdx.x / per);  // causal: most q tiles first
  const int rem = (int)(blockIdx.x % per), split = rem % splits;
  const int kvh = (rem / splits) % g.Hkv, b = rem / (splits * g.Hkv);
  const int hps = g.H / g.Hkv / splits;  // query heads of the split
  const int k_first = ik * BK;
  const bool f32 = splits > 1;
  const int out_heads = g.Hkv * splits, oh = kvh * splits + split;

  if (b >= num_valid_rows(nv_ptr, g.B)) {
    if (f32) {
      zero_head_rows<float, D>(static_cast<float*>(dk), b, k_first, BK, g.T,
                               out_heads, oh, C::NTF);
      zero_head_rows<float, D>(static_cast<float*>(dv), b, k_first, BK, g.T,
                               out_heads, oh, C::NTF);
    } else {
      zero_head_rows<T, D>(static_cast<T*>(dk), b, k_first, BK, g.T,
                           out_heads, oh, C::NTF);
      zero_head_rows<T, D>(static_cast<T*>(dv), b, k_first, BK, g.T,
                           out_heads, oh, C::NTF);
    }
    return;
  }

  const int2 range =
      visible_range<false>((g.S + BQ - 1) / BQ, BQ, k_first, BK, g);
  const int nvis = max(range.y - range.x + 1, 0);  // 0: no query sees these keys
  const int n = hps * nvis;
  const DkvRing<T, D> ring{&tm_q, &tm_do, lse, delta, Qs, dOs, rows, full,
                           nvis, range.x, kvh * (g.H / g.Hkv) + split * hps,
                           b};
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the lanes of warp 0
      mbar_init(&empty[s], C::NTF);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // warp 0: K and V once, then the ring's first STAGES items
  if (threadIdx.x < 32) {
    if (n > 0 && threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * C::kv_bytes);
      for (int a = 0; a < AT; ++a) {
        tma_load_4d(Ks + a * BK * 32, &tm_k, kv_full, 32 * a, kvh, k_first, b);
        tma_load_4d(Vs + a * BK * 32, &tm_v, kv_full, 32 * a, kvh, k_first, b);
      }
    }
    for (int i = 0; i < min(n, ST); ++i) ring.load(i, g);
  }
  __syncwarp();

  const int wg = threadIdx.x >> 7;
  const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);
  const uint32_t q0 = smem_u32(Qs), do0 = smem_u32(dOs);
  if constexpr (C::ROLES) {
    if (wg == 0)
      dkv_consume<T, D, false, true>(k_base, v_base, q0, do0, ring, kv_full,
                                     empty, n, k_first, dk, dv, f32,
                                     out_heads, oh, g);
    else
      dkv_consume<T, D, true, false>(k_base, v_base, q0, do0, ring, kv_full,
                                     empty, n, k_first, dk, dv, f32,
                                     out_heads, oh, g);
  } else {
    // warpgroup wg: keys k_first + 64 wg .. + 63, rows 64 wg .. of K and V
    dkv_consume<T, D, true, true>(k_base + wg * 64 * 64, v_base + wg * 64 * 64,
                                  q0, do0, ring, kv_full, empty, n,
                                  k_first + 64 * wg, dk, dv, f32, out_heads,
                                  oh, g);
  }
}

// dk[b, t, j] = sum over r of part[b, t, j * rep + r], r in order (and dv
// alike), in fp32, rounded once to T; four values a thread: adds the
// fp32 partials of a kv head's splits in a fixed order
template <typename T>
__global__ void __launch_bounds__(NT)
    dkv_sum16_kernel(const float4* __restrict__ dk_part,
                     const float4* __restrict__ dv_part,
                     uint2* __restrict__ dk, uint2* __restrict__ dv, int n,
                     int rep, int d4) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const size_t base = (size_t)(i / d4) * rep * d4 + i % d4;
  float4 a = dk_part[base], c = dv_part[base];
  for (int r = 1; r < rep; ++r) {
    const float4 x = dk_part[base + (size_t)r * d4];
    const float4 y = dv_part[base + (size_t)r * d4];
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  uint2 ka, va;
  ka.x = pack2<T>(a.x, a.y); ka.y = pack2<T>(a.z, a.w);
  va.x = pack2<T>(c.x, c.y); va.y = pack2<T>(c.z, c.w);
  dk[i] = ka;
  dv[i] = va;
}
#endif  // CUDA_EMU

// ------------------------------------------------------------------ launch

constexpr int kNoTensorMap = -3;
constexpr int kNoDevice = -4;

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
// one atom of SW / 2 columns (SW-byte swizzled rows) of `rows` rows of one
// head; rows past L come as zeros
template <typename T, int SW = 64>
int tensor_map(CUtensorMap* map, const void* ptr, int B, int L, int NH,
               int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kNoTensorMap;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)NH, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)NH * D * 2,
                                 (cuuint64_t)L * NH * D * 2};
  const cuuint32_t box[4] = {SW / 2, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kNoTensorMap;
}

template <typename T, int D>
int launch_fwd16(const void* q, const void* k, const void* v, const int* nv,
                 void* out, float* lse, Geom g, cudaStream_t st) {
  using C = Fwd16Cfg<D>;
  CUtensorMap mq, mk, mv;
  if (int e = tensor_map<T, C::SW>(&mq, q, g.B, g.S, g.H, D, C::BQ)) return e;
  if (int e = tensor_map<T, C::SW>(&mk, k, g.B, g.T, g.Hkv, D, C::BK))
    return e;
  if (int e = tensor_map<T, C::SW>(&mv, v, g.B, g.T, g.Hkv, D, C::BK))
    return e;
  if (int e = set_smem(fwd16_kernel<T, D>, C::smem)) return e;
  const int nq = (g.S + C::BQ - 1) / C::BQ;
  fwd16_kernel<T, D><<<nq * g.H * g.B, C::NTF, C::smem, st>>>(
      mq, mk, mv, nv, static_cast<T*>(out), lse, g);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq16(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const float* delta, const int* nv, void* dq,
                Geom g, cudaStream_t st) {
  using C = Dq16Cfg<D>;
  CUtensorMap mq, mk, mv, mo;
  if (int e = tensor_map<T>(&mq, q, g.B, g.S, g.H, D, C::BQ)) return e;
  if (int e = tensor_map<T>(&mk, k, g.B, g.T, g.Hkv, D, C::BK)) return e;
  if (int e = tensor_map<T>(&mv, v, g.B, g.T, g.Hkv, D, C::BK)) return e;
  if (int e = tensor_map<T>(&mo, o, g.B, g.S, g.H, D, C::BQ)) return e;
  if (int e = set_smem(dq16_kernel<T, D>, C::smem)) return e;
  const int nq = (g.S + C::BQ - 1) / C::BQ;
  dq16_kernel<T, D><<<nq * g.H * g.B, C::NTF, C::smem, st>>>(
      mq, mk, mv, mo, lse, delta, nv, static_cast<T*>(dq), g);
  return (int)cudaGetLastError();
}

// How many splits the dk/dv kernel cuts each kv head's group of H / Hkv
// query heads into: the fewest (a divisor of the group) for which its
// (k tile, kv head, batch row, split) grid has a block for every SM of the
// card (one block an SM fits; causal k tiles differ in work, and the
// blocks with the most go first).  At llama3-8b's training shapes (B 2,
// T 2048, Hkv 8: 16 k tiles of 128) that is 1, the whole group in a
// block; at gemma-2b's (B 2, T 1024, Hkv 1: 16 k tiles of 64) 8.  Returns
// kNoDevice if the card's SM count cannot be read.
template <int D>
int dkv16_splits(int B, int T_, int H, int Hkv) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return kNoDevice;
  const int BK = Dkv16Cfg<D>::BK, rep = H / Hkv;
  const int blocks = (T_ + BK - 1) / BK * Hkv * B;
  int s = 1;
  while (s < rep && (rep % s || blocks * s < sms)) ++s;
  return s;
}

template <typename T, int D>
int launch_dkv16(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const float* delta, const int* nv,
                 void* dk, void* dv, float* dk_part, float* dv_part, Geom g,
                 cudaStream_t st) {
  using C = Dkv16Cfg<D>;
  const int splits = dkv16_splits<D>(g.B, g.T, g.H, g.Hkv);
  if (splits < 1) return splits;
  if (splits > 1 && !(dk_part && dv_part)) return kNoScratch;
  CUtensorMap mq, mk, mv, mo;
  if (int e = tensor_map<T>(&mq, q, g.B, g.S, g.H, D, C::BQ)) return e;
  if (int e = tensor_map<T>(&mk, k, g.B, g.T, g.Hkv, D, C::BK)) return e;
  if (int e = tensor_map<T>(&mv, v, g.B, g.T, g.Hkv, D, C::BK)) return e;
  if (int e = tensor_map<T>(&mo, o, g.B, g.S, g.H, D, C::BQ)) return e;
  if (int e = set_smem(dkv16_kernel<T, D>, C::smem)) return e;
  const int nk = (g.T + C::BK - 1) / C::BK;
  dkv16_kernel<T, D><<<nk * g.Hkv * g.B * splits, C::NTF, C::smem, st>>>(
      mq, mk, mv, mo, lse, delta, nv,
      splits > 1 ? static_cast<void*>(dk_part) : dk,
      splits > 1 ? static_cast<void*>(dv_part) : dv, splits, g);
  if (int e = (int)cudaGetLastError()) return e;
  if (splits > 1) {
    const int n = g.B * g.T * g.Hkv * (D / 4);
    dkv_sum16_kernel<T><<<(n + NT - 1) / NT, NT, 0, st>>>(
        reinterpret_cast<const float4*>(dk_part),
        reinterpret_cast<const float4*>(dv_part), static_cast<uint2*>(dk),
        static_cast<uint2*>(dv), n, splits, D / 4);
  }
  return (int)cudaGetLastError();
}
#endif  // CUDA_EMU

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
// `dtype` (0 bfloat16, 1 float16), lse / delta / the dk, dv partials fp32;
// all 16-byte aligned; num_valid may be null (= all B rows).  Returns 0 on
// success, a cudaError_t code if a launch was refused, -1 for a head_dim
// outside {32, 64, 96, 128, 256}, -2 when flash_bwd_dkv_16 splits the GQA
// groups (flash_bwd_dkv_16_splits > 1) and was given no fp32 partials, -3
// when cuTensorMapEncodeTiled is missing or refuses a tensor,
// -4 when the card's SM count cannot be read.
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

// How many splits flash_bwd_dkv_16 cuts each kv head's group of query heads
// into on the current card at these shapes (dkv16_splits), or a negative
// code.  Past 1, it needs dk_part / dv_part: (B, T, Hkv * splits, D) fp32
// each.
int flash_bwd_dkv_16_splits(int B, int T_, int H, int Hkv, int D) {
  switch (D) {
    case 32: return dkv16_splits<32>(B, T_, H, Hkv);
    case 64: return dkv16_splits<64>(B, T_, H, Hkv);
    case 96: return dkv16_splits<96>(B, T_, H, Hkv);
    case 128: return dkv16_splits<128>(B, T_, H, Hkv);
    case 256: return dkv16_splits<256>(B, T_, H, Hkv);
    default: return kBadHeadDim;
  }
}

// dk_part / dv_part: (B, T, Hkv * splits, D) fp32 partials, used (and
// required) only when flash_bwd_dkv_16_splits > 1
int flash_bwd_dkv_16(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* num_valid, void* dk, void* dv,
                     float* dk_part, float* dv_part, int B, int S, int T_,
                     int H, int Hkv, int D, int causal, int window,
                     float softcap, float sm_scale, void* stream) {
  Geom g{B, S, T_, H, Hkv, causal, window, softcap, sm_scale};
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH16(dtype, D,
             (launch_dkv16<T, DD>(q, k, v, dout, lse, delta, num_valid, dk,
                                  dv, dk_part, dv_part, g, st)));
}
#endif  // CUDA_EMU

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
