// RWKV-6 WKV recurrence, backward: for each batch*head row, with
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,       w_t = exp(logw_t), S_{-1} = 0
//   o_t = r_t S_{t-1} + (r_t . (u (.) k_t)) v_t
//
// and the gradients do_t of every output (and dS, the gradient of the final
// state S_{T-1}, where the caller has one), the gradients of every input.
// With G_t the gradient of S_t (G_{T-1} = dS, else 0):
//
//   dr_t    = S_{t-1} do_t + u (.) k_t (do_t . v_t)
//   dk_t    = G_t v_t      + r_t (.) u (do_t . v_t)
//   dv_t    = G_t^T k_t    + (r_t . (u (.) k_t)) do_t
//   dlogw_t = w_t (.) rowsum(G_t (.) S_{t-1})
//   du      = sum_t r_t (.) k_t (do_t . v_t)
//   G_{t-1} = diag(w_t) G_t + r_t do_t^T
//
// (kernels/wkv6/ref.py::wkv6_bwd_ref is this recurrence in PyTorch, step
// by step; wkv6_bwd_chunked_ref is the chunked form below.)
//
// Replaces no TPU kernel: the reference has no backward kernel and trains
// by differentiating its lax.scan (repro/kernels/wkv6/ref.py::wkv6_ref).
// This kernel carries the gradient of the forward of
// repro/kernels/wkv6/kernel.py::wkv6_kernel (csrc/wkv6.cu here).
//
// The chunked form, chunks of L steps (32; 16 at D > 64, where shared
// memory is short), as wkv6.cu's forward: with lc the inclusive and lcp
// the exclusive cumsum of logw in the chunk (per channel), S_c the state
// at chunk c's start and G_c the state's gradient at its last step,
//
//   S_{c+1} = exp(lc[L-1]) S_c + (k exp(lc[L-1] - lc))^T v
//   G_{c-1} = exp(lc[L-1]) G_c + (r exp(lcp))^T do
//
// and, inside a chunk, with B[t, s] = do_t . v_s and the forward's A[t, s]
// (the bonus on its diagonal):
//
//   dr[t] = exp(lcp[t]) (do_t S_c^T) + sum_{s<t} B[t,s] k[s] exp(lcp[t]-lc[s])
//           + u k[t] B[t,t]
//   dk[t] = exp(lc[L-1]-lc[t]) (v_t G_c^T)
//           + sum_{s>t} B[s,t] r[s] exp(lcp[s]-lc[t]) + r[t] u B[t,t]
//   dv[t] = (k exp(lc[L-1] - lc))[t] G_c + sum_{s>=t} A[s,t] do_s
//   dlogw[t] = q[t] - k[t] dk[t] + r[t] u k[t] B[t,t]
//   q[t]  = rowsum(G_c (.) S_{c+1}) + sum_{s>t in the chunk} (r dr - k dk)[s]
//
// (q[t] is rowsum(G_t (.) S_t); rowsum(G_{t-1} S_{t-1}) - rowsum(G_t S_t)
// = r_t (S_{t-1} do_t) - k_t (G_t v_t), so dlogw is the in-chunk reverse
// cumsum plus the state term.)  Every exponent is a difference of cumsums
// that is <= 0 (logw <= 0): the sums over s in an earlier or later 8-step
// sub-block are factored through the sub-block boundaries, exp(lcp[t] -
// lc[s]) = rdec[t] mid[I,J] kdec[s] with rdec[t] = exp(lcp[t] - lcp[8J]),
// kdec[s] = exp(lc[8I+7] - lc[s]), mid[I,J] = exp(lcp[8J] - lc[8I+7]), as
// wkv6.cu's A is, and the sub-blocks on the diagonal are summed elementwise
// with exp(min(lcp[t] - lc[s], 0)).  lcp is the exclusive cumsum itself,
// never lc - logw.  Strong decays (w underflowing to 0) give factors of 0,
// never a quotient of two; under weak decays G grows T-fold and q with it,
// and q is summed from the chunk's end, where it is one D-term rowsum.
//
// Design on the H100, four kernels on one stream, each (row, chunk) a CTA
// but the scan:
//   update  every chunk's own terms of the two carries at once: U_c = (k
//           exp(lc[L-1] - lc))^T v and V_c = (r exp(lcp))^T do, (D x L)
//           (L x D) products on the tensor cores (mma.sync m16n8k8 in
//           3xTF32), and exp(lc[L-1]), into a workspace;
//   scan    the only sequential stage, a thread an element of a row's
//           state: S_{c+1} = exp(lc[L-1]) S_c + U_c forward and G_{c-1} =
//           exp(lc[L-1]) G_c + V_c back, nc dependent adds in place over
//           U and V, their inputs loaded ahead (2 D^2 threads a row);
//   chunk   every (row, chunk) at once, a CTA of 8 warps: the chunk's
//           cumsums and decays (as wkv6.cu), then B = do v^T, A, do S_c^T,
//           v G_c^T, kS G_c, A^T do and the factored off-diagonal sums of
//           dr and dk on the tensor cores (3xTF32, bf16 operands exact and
//           not split), the diagonal sub-blocks and the bonus terms on the
//           CUDA cores, then dlogw's reverse cumsum a thread a (sub-block,
//           channel); rowsum(G_c S_{c+1}) and G_c are loaded beside the
//           inputs.  2,048 CTAs at BH 64;
//   du      each (row, chunk)'s du summed over the chunks and the rows that
//           share a bonus row, in a fixed order: no atomics, so two runs
//           give the same bits.
//
// Bound on the H100: at B 8 x H 32 rows of T = 1024 steps, D = 64, bf16,
// its bytes (r, k, v, do, logw read and dr, dk, dv, dlogw written once)
// take 0.110 ms at 3.35 TB/s; the chunked form's products would take
// 0.079 ms on the tensor cores (3xTF32), so the bytes bound it, as they do
// the forward (chip_smoke.py::wkv6_bwd_bound).  This design also moves the
// chunk states through device memory (U, V, S_c and G_c, D^2 fp32 each a
// chunk: written twice and read ~4 times) and reads its inputs twice.
//
// Summation: the products and sums run in another order than the plain
// version's step-by-step einsum, and the decays are products of
// exponentials of cumsum differences: the two agree to a tolerance
// (kernels/wkv6/cases.py::TOL).  The build keeps --fmad=false; the sums on
// the CUDA cores are written as fmaf where they chain.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2**x for x <= 0 on the special-function unit (results below 2**-126
// flushed to 0, far under the tolerance); the cumsums are in log2 units.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo for the 3xTF32 products (as wkv6.cu): adding half a TF32 ulp
// to the bits rounds to nearest; lo = x - hi is exact and rounded the same
// way.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of eight of a warp's C[16 x 8 NT] += A[16 x 8] B[8 x 8 NT] in
// 3xTF32, the three products in three accumulators (hi*hi, lo*hi, hi*lo).
// AX / BX: A / B is exact in TF32 (read from bf16), so it is not split and
// its lo products are 0.  fa(i, kk): A at row i of the tile, column kk;
// fb(kk, j): B at row kk, column j of the warp's 8 NT columns (kk absolute,
// from k).  Layout of m16n8k8 (PTX ISA): g = lane / 4, q = lane % 4; A (g,
// q), (g+8, q), (g, q+4), (g+8, q+4); B (q, g), (q+4, g); C (g, 2q), (g,
// 2q+1), (g+8, 2q), (g+8, 2q+1).
template <int NT, bool AX, bool BX, class FA, class FB>
__device__ __forceinline__ void mma_kstep(float (&hh)[NT][4],
                                          float (&lh)[NT][4],
                                          float (&hl)[NT][4], int lane,
                                          int k, FA fa, FB fb) {
  const int g = lane >> 2, q = lane & 3;
  uint32_t ah[4], al[4];
  const float a0 = fa(g, k + q), a1 = fa(g + 8, k + q);
  const float a2 = fa(g, k + q + 4), a3 = fa(g + 8, k + q + 4);
  if (AX) {
    ah[0] = __float_as_uint(a0);
    ah[1] = __float_as_uint(a1);
    ah[2] = __float_as_uint(a2);
    ah[3] = __float_as_uint(a3);
  } else {
    split(a0, ah[0], al[0]);
    split(a1, ah[1], al[1]);
    split(a2, ah[2], al[2]);
    split(a3, ah[3], al[3]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t bh[2], bl[2];
    if (BX) {
      bh[0] = __float_as_uint(fb(k + q, 8 * j + g));
      bh[1] = __float_as_uint(fb(k + q + 4, 8 * j + g));
    } else {
      split(fb(k + q, 8 * j + g), bh[0], bl[0]);
      split(fb(k + q + 4, 8 * j + g), bh[1], bl[1]);
      mma_tf32(hl[j], ah, bl);
    }
    if (!AX) mma_tf32(lh[j], al, bh);
    mma_tf32(hh[j], ah, bh);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// (lh + hl) + hh, element x of tile j.
template <int NT>
__device__ __forceinline__ float sum3(const float (&hh)[NT][4],
                                      const float (&lh)[NT][4],
                                      const float (&hl)[NT][4], int j,
                                      int x) {
  return (lh[j][x] + hl[j][x]) + hh[j][x];
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// DP: D padded to 16, 32, 64 or 128 (channels past D are zeros, logw 0,
// which change nothing).  L: steps a chunk.
template <int DP>
struct Dims {
  static constexpr int L = DP <= 64 ? 32 : 16;
  static constexpr int NB = L / 8;     // 8-step sub-blocks a chunk
  static constexpr int MT = L / 16;    // 16-step row tiles a chunk
};

// Steps t0 .. t0 + L - 1 (n of them inside T) of one (T, D) input into an
// (L, P) fp32 tile, zeros past T and D: 16 bytes a load where ``vec`` (D ==
// DP and every row 16-byte aligned), else an element a load.
template <typename X, int L, int DP, int P, int NTH>
__device__ __forceinline__ void load_tile(float* dst, const X* src,
                                          int64_t base, int64_t st, int t0,
                                          int n, int D, bool vec) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(X);
    for (int idx = threadIdx.x; idx < L * DP / E; idx += NTH) {
      const int t = idx / (DP / E), d = (idx % (DP / E)) * E;
      float x[E];
      if (t < n) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + base + (int64_t)(t0 + t) * st + d);
        const X* e = reinterpret_cast<const X*>(&raw);
#pragma unroll
        for (int i = 0; i < E; ++i) x[i] = to_f(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < E; i += 4) {
        *reinterpret_cast<float4*>(dst + t * P + d + i) =
            make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < L * DP; idx += NTH) {
      const int t = idx / DP, d = idx % DP;
      dst[t * P + d] = t < n && d < D
                           ? to_f(src[base + (int64_t)(t0 + t) * st + d])
                           : 0.f;
    }
  }
}

// ------------------------------------------------------------ update --
// Each chunk's own terms of the two carries, every (row, chunk) at once:
//   U_c = (k exp(lc[L-1] - lc))^T v, into S_{c+1}'s slot of sws;
//   V_c = (r exp(lcp))^T do, into G_{c-1}'s slot of gws (c >= 1);
//   wl_c = exp(lc[L-1]).
// The scan below then only adds: S_{c+1} = wl_c S_c + U_c, G_{c-1} = wl_c
// G_c + V_c.
template <int DP>
struct Update {
  static constexpr int L = Dims<DP>::L, NB = Dims<DP>::NB;
  static constexpr int NW = 8, NTH = 32 * NW;
  static constexpr int P = DP + 4;      // row stride of (L, DP) tiles
  static constexpr int NT = 2;          // 8-column tiles a warp task
  static constexpr int TASKS = (DP / 16) * (DP / 8 / NT);   // a product
  static constexpr int SMEM = (5 * L * P + NB * DP) * 4;
};

template <typename In, int DP>
__global__ void __launch_bounds__(256)
    wkv6_bwd_update(const In* __restrict__ r, const In* __restrict__ k,
                    const In* __restrict__ v, const float* __restrict__ logw,
                    const In* __restrict__ dout, int H, int T, int D,
                    int64_t sb, int64_t sh, int64_t st, int vec,
                    float* __restrict__ sws, float* __restrict__ gws,
                    float* __restrict__ wl) {
  using C = Update<DP>;
  constexpr int L = C::L, NB = C::NB, P = C::P, NTH = C::NTH, NT = C::NT;
  constexpr bool VX = sizeof(In) == 2;   // v and do exact in TF32
  extern __shared__ __align__(16) float f[];
  float* LC = f;              // logw, then lc (log2 units)
  float* KS = LC + L * P;     // k, then k exp(lc[L-1] - lc)
  float* RG = KS + L * P;     // r, then r exp(lcp)
  float* V = RG + L * P;
  float* G = V + L * P;       // do
  float* TOT = G + L * P;     // a sub-block's logw sum (NB, DP)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int row = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int t0 = c * L, n = min(L, T - t0);
  const int64_t base = (int64_t)(row / H) * sb + (int64_t)(row % H) * sh;

  load_tile<In, L, DP, P, NTH>(KS, k, base, st, t0, n, D, vec);
  load_tile<In, L, DP, P, NTH>(RG, r, base, st, t0, n, D, vec);
  load_tile<In, L, DP, P, NTH>(V, v, base, st, t0, n, D, vec);
  load_tile<In, L, DP, P, NTH>(G, dout, base, st, t0, n, D, vec);
  load_tile<float, L, DP, P, NTH>(LC, logw, base, st, t0, n, D, vec);
  __syncthreads();
  // the cumsum in log2 units, a thread a (sub-block, channel), then the
  // sub-blocks' prefixes (as the chunk kernel)
  for (int it = tid; it < NB * DP; it += NTH) {
    const int J = it / DP, d = it % DP;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * J + i;
      acc = fmaf(LC[t * P + d], kLog2e, acc);
      LC[t * P + d] = acc;
    }
    TOT[J * DP + d] = acc;
  }
  __syncthreads();
  for (int it = tid; it < NB * DP; it += NTH) {
    const int J = it / DP, d = it % DP;
    float pJ = 0.f, lcL = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < J) pJ += TOT[j * DP + d];
      lcL += TOT[j * DP + d];
    }
    float prev = pJ;   // lcp of the step
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * J + i;
      const float lct = pJ + LC[t * P + d];
      KS[t * P + d] *= ex2(lcL - lct);
      RG[t * P + d] *= ex2(prev);
      prev = lct;
    }
    if (J == 0) wl[((int64_t)row * nc + c) * DP + d] = ex2(lcL);
  }
  __syncthreads();
  // U_c = KS^T V and V_c = RG^T G: (DP, DP) each, a warp a 16 x 16 task
  float* su = sws + ((int64_t)row * (nc + 1) + c + 1) * DP * DP;
  float* gv = gws + ((int64_t)row * nc + c - 1) * DP * DP;
  for (int task = warp; task < 2 * C::TASKS; task += C::NW) {
    const bool second = task >= C::TASKS;
    if (second && c == 0) continue;   // G_{-1} is not needed
    const int tt = second ? task - C::TASKS : task;
    const int ib = 16 * (tt / (DP / 8 / NT)), jb = 8 * NT * (tt % (DP / 8 / NT));
    const float* A = second ? RG : KS;
    const float* B = second ? G : V;
    float hh[NT][4], lh[NT][4], hl[NT][4];
    zero(hh);
    zero(lh);
    zero(hl);
#pragma unroll
    for (int ks = 0; ks < L / 8; ++ks) {
      mma_kstep<NT, false, VX>(
          hh, lh, hl, lane, 8 * ks,
          [&](int i, int t) { return A[t * P + ib + i]; },
          [&](int t, int j) { return B[t * P + jb + j]; });
    }
    float* dst = second ? gv : su;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float* p0 = dst + (ib + g) * DP + jb + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(p0) =
          make_float2(sum3(hh, lh, hl, j, 0), sum3(hh, lh, hl, j, 1));
      *reinterpret_cast<float2*>(p0 + 8 * DP) =
          make_float2(sum3(hh, lh, hl, j, 2), sum3(hh, lh, hl, j, 3));
    }
  }
}

// -------------------------------------------------------------- scan --
// The two carries, a thread an element of the (DP, DP) state of a row:
// pass 0 (blockIdx.z == 0) S_0 = 0, S_{c+1} = wl_c S_c + U_c in place;
// pass 1 G_{nc-1} = dS (or 0), G_{c-1} = wl_c G_c + V_c in place.  The
// only sequential stage: nc dependent adds, their inputs loaded ahead.
template <int DP>
__global__ void __launch_bounds__(256)
    wkv6_bwd_scan(const float* __restrict__ dstate, int D, int nc,
                  const float* __restrict__ wl, float* __restrict__ sws,
                  float* __restrict__ gws) {
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= DP * DP) return;
  const int row = blockIdx.x, i = e / DP, j = e % DP;
  const float* w = wl + (int64_t)row * nc * DP + i;
  if (blockIdx.z == 0) {
    float* p = sws + (int64_t)row * (nc + 1) * DP * DP + e;
    float s = 0.f;
    p[0] = s;
#pragma unroll 8
    for (int c = 0; c < nc; ++c) {
      float* pc = p + (int64_t)(c + 1) * DP * DP;
      s = w[c * DP] * s + *pc;
      *pc = s;
    }
  } else {
    float* p = gws + (int64_t)row * nc * DP * DP + e;
    float gv = (dstate != nullptr && i < D && j < D)
                   ? dstate[((int64_t)row * D + i) * D + j]
                   : 0.f;
    p[(int64_t)(nc - 1) * DP * DP] = gv;
#pragma unroll 8
    for (int c = nc - 1; c >= 1; --c) {
      float* pc = p + (int64_t)(c - 1) * DP * DP;
      gv = w[c * DP] * gv + *pc;
      *pc = gv;
    }
  }
}

// ------------------------------------------------------------- chunk --
template <typename In, int DP>
struct Chunk {
  static constexpr int L = Dims<DP>::L, NB = Dims<DP>::NB;
  static constexpr int MT = Dims<DP>::MT;
  static constexpr int NW = 8;
  static constexpr int NTH = 32 * NW;
  static constexpr int P = DP + 4;      // row stride of (L, DP) tiles
  static constexpr int PB = L + 4;      // row stride of B and A
  static constexpr int PS = DP + 4;     // row stride of the staged state
  // output tiles (16 steps x 8 NTO channels): a warp's
  static constexpr int NTO = cmax(1, MT * (DP / 8) / NW);
  static constexpr int NGO = DP / 8 / NTO;
  static constexpr int O_WT = MT * NGO;
  // fp32 buffers, in floats
  static constexpr int F_R = 0, F_K = L * P, F_V = 2 * L * P, F_D = 3 * L * P;
  static constexpr int F_LC = 4 * L * P, F_RD = 5 * L * P, F_KD = 6 * L * P;
  static constexpr int F_DR = 7 * L * P, F_DK = 8 * L * P;
  static constexpr int F_B = 9 * L * P, F_A = F_B + L * PB;
  static constexpr int F_ST = F_A + L * PB;
  static constexpr int F_MID = F_ST + DP * PS;
  static constexpr int F_GJ = F_MID + NB * NB * DP;
  static constexpr int F_HI = F_GJ + NB * DP;
  static constexpr int F_TOT = F_HI + NB * DP;
  static constexpr int F_U = F_TOT + NB * DP;
  static constexpr int F_QG = F_U + DP;
  static constexpr int F_WL = F_QG + DP;
  static constexpr int FLOATS = F_WL + DP;
  static constexpr int SMEM = 4 * FLOATS;
  static_assert((DP / 8) % NTO == 0, "warp tiles");
  static_assert(O_WT <= NW, "at most one output tile a warp");
};

template <typename In, int DP>
__global__ void __launch_bounds__(256)
    wkv6_bwd_chunk(const In* __restrict__ r, const In* __restrict__ k,
                   const In* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, const In* __restrict__ dout,
                   int H, int T, int D, int64_t sb, int64_t sh, int64_t st,
                   int64_t sub, int64_t suh, int vec,
                   const float* __restrict__ sws,
                   const float* __restrict__ gws, In* __restrict__ dr,
                   In* __restrict__ dk, In* __restrict__ dv,
                   float* __restrict__ dlogw, float* __restrict__ du_part) {
  using C = Chunk<In, DP>;
  constexpr int L = C::L, NB = C::NB, P = C::P, PB = C::PB, PS = C::PS;
  constexpr int NTH = C::NTH, NW = C::NW, NTO = C::NTO;
  constexpr bool VX = sizeof(In) == 2;   // raw inputs exact in TF32
  extern __shared__ __align__(16) float f[];
  float* R = f + C::F_R;
  float* K = f + C::F_K;
  float* V = f + C::F_V;
  float* Dd = f + C::F_D;
  float* LC = f + C::F_LC;    // logw, then lc (absolute in the chunk, log2)
  float* RD = f + C::F_RD;    // rdec = exp(lcp[t] - lcp[8J])
  float* KD = f + C::F_KD;    // kdec = exp(lc[8I+7] - lc[s])
  float* DR = f + C::F_DR;
  float* DK = f + C::F_DK;
  float* BM = f + C::F_B;     // B[t, s] = do_t . v_s
  float* AM = f + C::F_A;     // the forward's A, bonus on the diagonal
  float* ST = f + C::F_ST;    // S_c, then G_c (DP, PS)
  float* MID = f + C::F_MID;  // mid[I][J][d]
  float* GJ = f + C::F_GJ;    // exp(lcp[8J])
  float* HI = f + C::F_HI;    // exp(lc[L-1] - lc[8I+7])
  float* TOT = f + C::F_TOT;  // a sub-block's logw sum
  float* US = f + C::F_U;
  float* QG = f + C::F_QG;    // rowsum(G_c (.) S_c)
  float* WL = f + C::F_WL;    // exp(lc[L-1])

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int row = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int t0 = c * L, n = min(L, T - t0);
  const int64_t base = (int64_t)(row / H) * sb + (int64_t)(row % H) * sh;
  const float* urow = u + (int64_t)(row / H) * sub + (int64_t)(row % H) * suh;
  const float* s0 = sws + ((int64_t)row * (nc + 1) + c) * DP * DP;
  const float* g0 = gws + ((int64_t)row * nc + c) * DP * DP;

  // ---- 0. the chunk's inputs, S_c staged, A zeroed ----------------------
  load_tile<In, L, DP, P, NTH>(R, r, base, st, t0, n, D, vec);
  load_tile<In, L, DP, P, NTH>(K, k, base, st, t0, n, D, vec);
  load_tile<In, L, DP, P, NTH>(V, v, base, st, t0, n, D, vec);
  load_tile<In, L, DP, P, NTH>(Dd, dout, base, st, t0, n, D, vec);
  load_tile<float, L, DP, P, NTH>(LC, logw, base, st, t0, n, D, vec);
  for (int idx = tid; idx < DP * DP / 4; idx += NTH) {
    const int i = idx / (DP / 4), j = (idx % (DP / 4)) * 4;
    *reinterpret_cast<float4*>(ST + i * PS + j) =
        *reinterpret_cast<const float4*>(s0 + i * DP + j);
  }
  for (int idx = tid; idx < L * PB; idx += NTH) AM[idx] = 0.f;
  for (int d = tid; d < DP; d += NTH) US[d] = d < D ? urow[d] : 0.f;
  // G_c into registers (at DP <= 64), staged over S_c below
  constexpr int NG = DP <= 64 ? (DP * DP / 4 + NTH - 1) / NTH : 1;
  float4 gpre[NG];
  if constexpr (DP <= 64) {
#pragma unroll
    for (int e = 0; e < NG; ++e) {
      const int idx = tid + NTH * e;
      if (idx < DP * DP / 4) {
        gpre[e] = *reinterpret_cast<const float4*>(g0 + idx * 4);
      }
    }
  }
  __syncthreads();

  // ---- 1. the cumsum of logw in log2 units, a thread a (sub-block,
  // channel) -------------------------------------------------------------
  for (int it = tid; it < NB * DP; it += NTH) {
    const int J = it / DP, d = it % DP;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * J + i;
      acc = fmaf(LC[t * P + d], kLog2e, acc);
      LC[t * P + d] = acc;
    }
    TOT[J * DP + d] = acc;
  }
  __syncthreads();
  // ---- 2. block prefixes and every decay (each exponent <= 0) ----------
  for (int it = tid; it < NB * DP; it += NTH) {
    const int J = it / DP, d = it % DP;
    float pre[NB + 1], pJ = 0.f, pJ1 = 0.f;
    pre[0] = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      pre[j + 1] = pre[j] + TOT[j * DP + d];
      if (j == J) {
        pJ = pre[j];
        pJ1 = pre[j + 1];
      }
    }
    const float lcL = pre[NB];
    float prev = pJ;   // lcp of the step
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * J + i;
      const float lct = pJ + LC[t * P + d];
      RD[t * P + d] = ex2(prev - pJ);
      KD[t * P + d] = ex2(pJ1 - lct);
      LC[t * P + d] = lct;
      prev = lct;
    }
#pragma unroll
    for (int I = 0; I < NB; ++I) {
      MID[(I * NB + J) * DP + d] = I < J ? ex2(pJ - pre[I + 1]) : 0.f;
    }
    GJ[J * DP + d] = ex2(pJ);
    HI[J * DP + d] = ex2(lcL - pJ1);
    if (J == 0) WL[d] = ex2(lcL);
  }
  __syncthreads();

  // ---- 3. B = do v^T; A's off-diagonal and diagonal sub-blocks; dr's
  // state term exp(lcp) (do S_c^T) -----------------------------------------
  for (int wt = warp; wt < C::MT * (L / 8); wt += NW) {
    const int tb = 16 * (wt / (L / 8)), cb = 8 * (wt % (L / 8));
    float hh[1][4], lh[1][4], hl[1][4];
    zero(hh);
    zero(lh);
    zero(hl);
#pragma unroll 4
    for (int ks = 0; ks < DP / 8; ++ks) {
      mma_kstep<1, VX, VX>(
          hh, lh, hl, lane, 8 * ks,
          [&](int i, int d) { return Dd[(tb + i) * P + d]; },
          [&](int d, int j) { return V[(cb + j) * P + d]; });
    }
    float* b0 = BM + (tb + g) * PB + cb + 2 * q;
    b0[0] = sum3(hh, lh, hl, 0, 0);
    b0[1] = sum3(hh, lh, hl, 0, 1);
    b0[8 * PB] = sum3(hh, lh, hl, 0, 2);
    b0[8 * PB + 1] = sum3(hh, lh, hl, 0, 3);
  }
  // A's off-diagonal sub-blocks (as wkv6.cu): row tile m against source
  // block I <= 2m; rows of blocks J <= I are zeroed through mid, not stored
  for (int a = warp; a < C::MT * C::MT; a += NW) {
    int m = 0;
    while ((m + 1) * (m + 1) <= a) ++m;
    const int I = a - m * m, tb = 16 * m;
    float hh[1][4], lh[1][4], hl[1][4];
    zero(hh);
    zero(lh);
    zero(hl);
#pragma unroll 2
    for (int ks = 0; ks < DP / 8; ++ks) {
      mma_kstep<1, false, false>(
          hh, lh, hl, lane, 8 * ks,
          [&](int i, int d) {
            return R[(tb + i) * P + d] * RD[(tb + i) * P + d] *
                   MID[(I * NB + 2 * m + (i >> 3)) * DP + d];
          },
          [&](int d, int j) {
            return K[(8 * I + j) * P + d] * KD[(8 * I + j) * P + d];
          });
    }
    float* a0 = AM + (tb + g) * PB + 8 * I + 2 * q;
    if (I < 2 * m) {
      a0[0] = sum3(hh, lh, hl, 0, 0);
      a0[1] = sum3(hh, lh, hl, 0, 1);
    }
    a0[8 * PB] = sum3(hh, lh, hl, 0, 2);
    a0[8 * PB + 1] = sum3(hh, lh, hl, 0, 3);
  }
  // A's diagonal sub-blocks, a thread a (t, s <= t in t's block): the
  // decayed products, and the bonus on the diagonal
  for (int it = tid; it < L * 8; it += NTH) {
    const int t = it / 8, sl = it % 8, b = t & ~7, s = b + sl;
    if (s > t) continue;
    float acc = 0.f;
    if (s == t) {
      for (int d = 0; d < DP; ++d) {
        acc = fmaf(R[t * P + d] * US[d], K[t * P + d], acc);
      }
    } else {
      for (int d = 0; d < DP; ++d) {
        const float lpt = t ? LC[(t - 1) * P + d] : 0.f;
        acc = fmaf(R[t * P + d] * K[s * P + d],
                   ex2(fminf(lpt - LC[s * P + d], 0.f)), acc);
      }
    }
    AM[t * PB + s] = acc;
  }
  // dr's state term: exp(lcp[t]) = rdec exp(lcp[8J]) times do_t S_c^T
  for (int wt = warp; wt < C::O_WT; wt += NW) {
    const int tb = 16 * (wt / C::NGO), cb = 8 * NTO * (wt % C::NGO);
    float hh[NTO][4], lh[NTO][4], hl[NTO][4];
    zero(hh);
    zero(lh);
    zero(hl);
#pragma unroll 2
    for (int ks = 0; ks < DP / 8; ++ks) {
      mma_kstep<NTO, VX, false>(
          hh, lh, hl, lane, 8 * ks,
          [&](int i, int j) { return Dd[(tb + i) * P + j]; },
          [&](int j, int i) { return ST[(cb + i) * PS + j]; });
    }
#pragma unroll
    for (int j = 0; j < NTO; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = tb + g + 8 * (x >> 1), d = cb + 8 * j + 2 * q + (x & 1);
        DR[t * P + d] =
            RD[t * P + d] * GJ[(t >> 3) * DP + d] * sum3(hh, lh, hl, j, x);
      }
    }
  }
  __syncthreads();

  // ---- G_c staged over S_c, a thread its own float4s of both;
  // rowsum(G_c (.) S_c) over the DP / 4 lanes that hold a row ---------------
  {
    constexpr int RL = DP / 4;   // lanes a row
#pragma unroll
    for (int e = 0; e < (DP * DP / 4 + NTH - 1) / NTH; ++e) {
      const int idx = tid + NTH * e;
      const bool in = idx < DP * DP / 4;
      float4* pos = reinterpret_cast<float4*>(ST + (idx / RL) * PS +
                                              (idx % RL) * 4);
      float part = 0.f;
      if (in) {
        float4 gv;
        if constexpr (DP <= 64) {
          gv = gpre[e];
        } else {
          gv = *reinterpret_cast<const float4*>(g0 + idx * 4);
        }
        const float4 sv = *pos;
        part = fmaf(gv.x, sv.x, fmaf(gv.y, sv.y, fmaf(gv.z, sv.z,
                                                       gv.w * sv.w)));
        *pos = gv;
      }
#pragma unroll
      for (int o = 1; o < RL; o <<= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      if (in && idx % RL == 0) QG[idx / RL] = part;
    }
  }
  __syncthreads();

  // ---- 4. a warp an output tile: dr's off-diagonal sum; dk's state term
  // (kept in registers) and off-diagonal sum; dv.  The off-diagonal sums
  // leave out the adjacent pair across a block boundary (phase 5 adds it) --
  float dks[NTO][4];
  for (int wt = warp; wt < C::O_WT; wt += NW) {
    const int m = wt / C::NGO, tb = 16 * m, cb = 8 * NTO * (wt % C::NGO);
    float acc[NTO][4];
    // dr: sum over source blocks I < J(t): mid[I, J(t)] (B[t, I] kE[I])
    zero(acc);
    for (int I = 0; I <= 2 * m; ++I) {
      float hh[NTO][4], lh[NTO][4], hl[NTO][4];
      zero(hh);
      zero(lh);
      zero(hl);
      mma_kstep<NTO, false, false>(
          hh, lh, hl, lane, 8 * I,
          [&](int i, int s) {
            return tb + i == s + 1 ? 0.f : BM[(tb + i) * PB + s];
          },
          [&](int s, int d) {
            return K[s * P + cb + d] * KD[s * P + cb + d];
          });
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int J = 2 * m + (x >> 1), d = cb + 8 * j + 2 * q + (x & 1);
          acc[j][x] = fmaf(MID[(I * NB + J) * DP + d],
                           sum3(hh, lh, hl, j, x), acc[j][x]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NTO; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = tb + g + 8 * (x >> 1), d = cb + 8 * j + 2 * q + (x & 1);
        DR[t * P + d] += RD[t * P + d] * acc[j][x];
      }
    }
    // dk: exp(lc[L-1] - lc[t]) (v_t G_c^T) + kdec sum over source blocks
    // J > I(t) of mid[I(t), J] (B[J, t]^T rA[J])
    {
      float hh[NTO][4], lh[NTO][4], hl[NTO][4];
      zero(hh);
      zero(lh);
      zero(hl);
#pragma unroll 2
      for (int ks = 0; ks < DP / 8; ++ks) {
        mma_kstep<NTO, VX, false>(
            hh, lh, hl, lane, 8 * ks,
            [&](int i, int j) { return V[(tb + i) * P + j]; },
            [&](int j, int i) { return ST[(cb + i) * PS + j]; });
      }
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = tb + g + 8 * (x >> 1), d = cb + 8 * j + 2 * q + (x & 1);
          dks[j][x] = KD[t * P + d] * HI[(t >> 3) * DP + d] *
                      sum3(hh, lh, hl, j, x);
          acc[j][x] = 0.f;
        }
      }
    }
    for (int J = 2 * m + 1; J < NB; ++J) {
      float hh[NTO][4], lh[NTO][4], hl[NTO][4];
      zero(hh);
      zero(lh);
      zero(hl);
      mma_kstep<NTO, false, false>(
          hh, lh, hl, lane, 8 * J,
          [&](int i, int s) {
            return s == tb + i + 1 ? 0.f : BM[s * PB + tb + i];
          },
          [&](int s, int d) {
            return R[s * P + cb + d] * RD[s * P + cb + d];
          });
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int I = 2 * m + (x >> 1), d = cb + 8 * j + 2 * q + (x & 1);
          acc[j][x] = fmaf(MID[(I * NB + J) * DP + d],
                           sum3(hh, lh, hl, j, x), acc[j][x]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NTO; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = tb + g + 8 * (x >> 1), d = cb + 8 * j + 2 * q + (x & 1);
        DK[t * P + d] = KD[t * P + d] * acc[j][x];
      }
    }
    // dv = kS G_c + A^T do, kS = kE exp(lc[L-1] - lc[8I+7])
    {
      float hh[NTO][4], lh[NTO][4], hl[NTO][4];
      zero(hh);
      zero(lh);
      zero(hl);
#pragma unroll 2
      for (int ks = 0; ks < DP / 8; ++ks) {
        mma_kstep<NTO, false, false>(
            hh, lh, hl, lane, 8 * ks,
            [&](int i, int d) {
              const int t = tb + i;
              return K[t * P + d] * KD[t * P + d] * HI[(t >> 3) * DP + d];
            },
            [&](int d, int j) { return ST[d * PS + cb + j]; });
      }
      for (int ks = 2 * m; ks < L / 8; ++ks) {
        mma_kstep<NTO, false, VX>(
            hh, lh, hl, lane, 8 * ks,
            [&](int i, int s) { return AM[s * PB + tb + i]; },
            [&](int s, int j) { return Dd[s * P + cb + j]; });
      }
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = tb + g + 8 * (x >> 1), d = cb + 8 * j + 2 * q + (x & 1);
          if (t < n && d < D) {
            store1(dv + base + (int64_t)(t0 + t) * st + d,
                   sum3(hh, lh, hl, j, x));
          }
        }
      }
    }
  }
  __syncthreads();

  // dk's state term into v's slot (free now)
  float* DKS = V;
  if (warp < C::O_WT) {
    const int tb = 16 * (warp / C::NGO), cb = 8 * NTO * (warp % C::NGO);
#pragma unroll
    for (int j = 0; j < NTO; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        DKS[(tb + g + 8 * (x >> 1)) * P + cb + 8 * j + 2 * q + (x & 1)] =
            dks[j][x];
      }
    }
  }
  __syncthreads();

  // ---- 5. the diagonal sub-blocks' pairs two or more steps apart, the
  // adjacent pairs (their decay exp(lcp[t] - lc[t-1]) is 1) and the bonus,
  // a thread a (t, channel); dr and dk out; DR and DK keep the parts dlogw
  // reads (drf = dr's state term and far pairs, dkf = dk's far pairs) -------
  for (int idx = tid; idx < L * DP; idx += NTH) {
    const int t = idx / DP, d = idx % DP, b = t & ~7;
    const float lpt = t ? LC[(t - 1) * P + d] : 0.f, lct = LC[t * P + d];
    const float bt = BM[t * PB + t];
    float xr = DR[t * P + d], xk = DK[t * P + d];
#pragma unroll
    for (int sl = 0; sl < 8; ++sl) {
      const int s = b + sl;
      if (s < t - 1) {
        xr = fmaf(BM[t * PB + s] * K[s * P + d],
                  ex2(fminf(lpt - LC[s * P + d], 0.f)), xr);
      } else if (s > t + 1) {
        const float lps = LC[(s - 1) * P + d];
        xk = fmaf(BM[s * PB + t] * R[s * P + d], ex2(fminf(lps - lct, 0.f)),
                  xk);
      }
    }
    DR[t * P + d] = xr;
    DK[t * P + d] = xk;
    float yr = xr, yk = DKS[t * P + d] + xk;
    if (t > 0) yr = fmaf(BM[t * PB + t - 1], K[(t - 1) * P + d], yr);
    if (t + 1 < L) yk = fmaf(BM[(t + 1) * PB + t], R[(t + 1) * P + d], yk);
    yr = fmaf(US[d] * K[t * P + d], bt, yr);
    yk = fmaf(R[t * P + d] * US[d], bt, yk);
    if (t < n && d < D) {
      const int64_t off = base + (int64_t)(t0 + t) * st + d;
      store1(dr + off, yr);
      store1(dk + off, yk);
    }
  }
  __syncthreads();

  // ---- 6. dlogw[t] = exp(lc[L-1]) rowsum(G_c S_c) + sum_{s>t} r drf[s]
  // + sum_{s<t} k dks[s] - sum_{s>=t} k dkf[s], a thread a (sub-block,
  // channel): the sub-blocks' sums first (and their du), then each walks
  // its own steps; the chunk's du ---------------------------------------
  float* SA = TOT;        // free since phase 2: a sub-block's sum of r drf
  float* SB = GJ;         // free since phase 3: of k dks
  float* SC = HI;         // free since phase 4: of k dkf
  float* SD = MID;        // free since phase 4: of r k (do . v)
  for (int it = tid; it < NB * DP; it += NTH) {
    const int J = it / DP, d = it % DP;
    float a = 0.f, bb = 0.f, cc = 0.f, du = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * J + i;
      const float rt = R[t * P + d], kt = K[t * P + d];
      a = fmaf(rt, DR[t * P + d], a);
      bb = fmaf(kt, DKS[t * P + d], bb);
      cc = fmaf(kt, DK[t * P + d], cc);
      du = fmaf(rt * kt, BM[t * PB + t], du);
    }
    SA[J * DP + d] = a;
    SB[J * DP + d] = bb;
    SC[J * DP + d] = cc;
    SD[J * DP + d] = du;
  }
  __syncthreads();
  for (int it = tid; it < NB * DP; it += NTH) {
    const int J = it / DP, d = it % DP;
    const float qg = WL[d] * QG[d];
    float a = 0.f, bb = 0.f, cc = 0.f;
    for (int j = NB - 1; j > J; --j) {
      a += SA[j * DP + d];
      cc += SC[j * DP + d];
    }
    for (int j = 0; j < J; ++j) bb += SB[j * DP + d];
    float pre[8];   // sum_{s<t} k dks[s], t in the sub-block
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * J + i;
      pre[i] = bb;
      bb = fmaf(K[t * P + d], DKS[t * P + d], bb);
    }
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      const int t = 8 * J + i;
      cc = fmaf(K[t * P + d], DK[t * P + d], cc);
      if (t < n && d < D) {
        dlogw[base + (int64_t)(t0 + t) * st + d] = ((qg + a) + pre[i]) - cc;
      }
      a = fmaf(R[t * P + d], DR[t * P + d], a);
    }
    if (J == 0) {
      float du = 0.f;
      for (int j = 0; j < NB; ++j) du += SD[j * DP + d];
      du_part[((int64_t)row * nc + c) * DP + d] = du;
    }
  }
}

// du[h, d] = sum over b < nb, then over the chunks, of du_part[b * nh + h],
// in that order.
template <int DP>
__global__ void wkv6_bwd_du_sum(const float* __restrict__ du_part, int nb,
                                int nh, int nc, int D,
                                float* __restrict__ du) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nh * D) return;
  const int h = idx / D, d = idx % D;
  float acc = 0.f;
  for (int b = 0; b < nb; ++b) {
    const float* p = du_part + ((int64_t)b * nh + h) * nc * DP + d;
    for (int c = 0; c < nc; ++c) acc += p[(int64_t)c * DP];
  }
  du[idx] = acc;
}

template <typename Kern>
cudaError_t opt_in(Kern kern, int smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename In, int DP>
int run(const void* r, const void* k, const void* v, const float* logw,
        const float* u, const void* dout, const float* dstate, int rows,
        int H, int T, int D, int64_t sb, int64_t sh, int64_t st, int64_t sub,
        int64_t suh, void* dr, void* dk, void* dv, float* dlogw, float* du,
        int nb, int nh, float* ws, cudaStream_t s) {
  using CU = Update<DP>;
  using CK = Chunk<In, DP>;
  constexpr int L = Dims<DP>::L;
  const int nc = (T + L - 1) / L;
  float* sws = ws;
  float* gws = sws + (int64_t)rows * (nc + 1) * DP * DP;
  float* du_part = gws + (int64_t)rows * nc * DP * DP;
  float* wl = du_part + (int64_t)rows * nc * DP;
  auto update = wkv6_bwd_update<In, DP>;
  auto chunk = wkv6_bwd_chunk<In, DP>;
  static bool opted_in = false;  // the shared-memory opt-in, once an instance
  if (!opted_in) {
    cudaError_t err = opt_in(update, CU::SMEM);
    if (err == cudaSuccess) err = opt_in(chunk, CK::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const In* ri = static_cast<const In*>(r);
  const In* ki = static_cast<const In*>(k);
  const In* vi = static_cast<const In*>(v);
  const In* gi = static_cast<const In*>(dout);
  // 16-byte loads where every row is 16-byte aligned and D fills DP
  constexpr int E = 16 / (int)sizeof(In);
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = D == DP && al(r) && al(k) && al(v) && al(dout) &&
                  al(logw) && sb % E == 0 && sh % E == 0 && st % E == 0;
  update<<<dim3(rows, nc), CU::NTH, CU::SMEM, s>>>(
      ri, ki, vi, logw, gi, H, T, D, sb, sh, st, vec, sws, gws, wl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_scan<DP><<<dim3(rows, (DP * DP + 255) / 256, 2), 256, 0, s>>>(
      dstate, D, nc, wl, sws, gws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk<<<dim3(rows, nc), CK::NTH, CK::SMEM, s>>>(
      ri, ki, vi, logw, u, gi, H, T, D, sb, sh, st, sub, suh, vec, sws, gws,
      static_cast<In*>(dr), static_cast<In*>(dk), static_cast<In*>(dv),
      dlogw, du_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = nh * D;
  wkv6_bwd_du_sum<DP><<<(n + 255) / 256, 256, 0, s>>>(du_part, nb, nh, nc,
                                                       D, du);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int dispatch(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const void* dout, const float* dstate, int rows,
             int H, int T, int D, int64_t sb, int64_t sh, int64_t st,
             int64_t sub, int64_t suh, void* dr, void* dk, void* dv,
             float* dlogw, float* du, int nb, int nh, float* ws,
             cudaStream_t s) {
#define WKV6_BWD_RUN(DP)                                                   \
  run<In, DP>(r, k, v, logw, u, dout, dstate, rows, H, T, D, sb, sh, st,   \
              sub, suh, dr, dk, dv, dlogw, du, nb, nh, ws, s)
  if (D <= 16) return WKV6_BWD_RUN(16);
  if (D <= 32) return WKV6_BWD_RUN(32);
  if (D <= 64) return WKV6_BWD_RUN(64);
  return WKV6_BWD_RUN(128);
#undef WKV6_BWD_RUN
}

template <int DP>
long long ws_floats(int T) {
  const long long nc = (T + Dims<DP>::L - 1) / Dims<DP>::L;
  return (2 * nc + 1) * DP * DP + 2 * nc * DP;
}

}  // namespace

// The workspace a row needs, in floats: its chunk-start states, the
// state's gradient at each chunk's end, each chunk's du and its decay
// exp(lc[L-1]).
extern "C" long long wkv6_bwd_workspace(int T, int D) {
  if (D <= 16) return ws_floats<16>(T);
  if (D <= 32) return ws_floats<32>(T);
  if (D <= 64) return ws_floats<64>(T);
  return ws_floats<128>(T);
}

// r, k, v, dout, dr, dk, dv: (B, H, T, D) in the element type (bf16 != 0:
// bf16, else fp32) at strides (sb, sh, st, 1), all alike; logw, dlogw: fp32
// at the same strides; u: fp32, the bonus row of b*H + h at u + b*sub +
// h*suh (unit stride); dstate: the final state's gradient (B*H, D, D) fp32,
// or null for none.  du: (nh, D) fp32, du[h] the sum of rows b*nh + h for
// b < nb (nb * nh == B * H); ws: B*H * wkv6_bwd_workspace(T, D) fp32
// scratch, 16-byte aligned.  1 <= D <= 128.  Returns the launch error, if
// any (cudaErrorInvalidValue for arguments out of range).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const float* logw, const float* u,
                               const void* dout, const float* dstate, int B,
                               int H, int T, int D, long long sb,
                               long long sh, long long st, long long sub,
                               long long suh, int bf16, void* dr, void* dk,
                               void* dv, float* dlogw, float* du, int nb,
                               int nh, float* ws, void* stream) {
  if (D < 1 || D > 128 || B < 0 || H < 1 || T < 1 || nb * nh != B * H ||
      (T + 15) / 16 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * H;
  if (rows == 0) return 0;
  return bf16 ? dispatch<__nv_bfloat16>(r, k, v, logw, u, dout, dstate, rows,
                                        H, T, D, sb, sh, st, sub, suh, dr, dk,
                                        dv, dlogw, du, nb, nh, ws, s)
              : dispatch<float>(r, k, v, logw, u, dout, dstate, rows, H, T,
                                D, sb, sh, st, sub, suh, dr, dk, dv, dlogw,
                                du, nb, nh, ws, s);
}
