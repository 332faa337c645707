// RWKV-6 WKV recurrence: for each batch*head row, from a zero state,
//
//   o_t = r_t S_{t-1} + (r_t . (u (.) k_t)) v_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,      w_t = exp(logw_t)
//
// and the final state S_T (D x D, fp32).
//
// Replaces repro/kernels/wkv6/kernel.py::wkv6_kernel, and computes what it
// computes: chunks of L steps in log space, an (L, L) causal matrix A, an
// (L, D) x (D, D) product with the carried state and a D x L x D state
// update.  Within a chunk, with lc the inclusive and lcp the exclusive
// cumsum of logw (both per channel d), for t, s in the chunk:
//
//   o[t]  = (r[t] exp(lcp[t])) S + sum_{s<=t} A[t,s] v[s]
//   A[t,s] = sum_d r[t,d] k[s,d] exp(lcp[t,d] - lc[s,d])     s < t
//   A[t,t] = sum_d r[t,d] u[d] k[t,d]                       (the bonus)
//   S'    = diag(exp(lc[L-1])) S + (k exp(lc[L-1] - lc))^T v
//
// Every exponent is <= 0 (logw <= 0, so lc does not increase) and nothing
// overflows: A's off-diagonal 8-step sub-blocks (s in block I, t in block
// J > I) are factored as rA[t] mid[I,J] kE[s] with
//   rA[t] = r[t] exp(lcp[t] - lcp[8J]),  kE[s] = k[s] exp(lc[8I+7] - lc[s]),
//   mid[I,J] = exp(lcp[8J] - lc[8I+7]),
// and r exp(lcp) = rA exp(lcp[8J]), k exp(lc[L-1] - lc) = kE exp(lc[L-1] -
// lc[8I+7]) reuse them; the diagonal sub-blocks are summed elementwise with
// exp(min(lcp[t] - lc[s], 0)), as the reference does, the bonus with them
// (kernels/wkv6/ref.py::wkv6_chunked_ref is this form in PyTorch).
//
// Design on the H100:
//   the four products (A's off-diagonal sub-blocks, the inter-chunk
//   r S, A v and the state update) run on the tensor cores, mma.sync
//   m16n8k8 in TF32 with the 3xTF32 split: x = hi + lo, both TF32
//   roundings, hi*hi + hi*lo + lo*hi summed in fp32, about fp32 accuracy
//   (one TF32 pass would keep three digits); bf16 v is exact in TF32 and
//   is not split; the three products go to three accumulators, so no
//   chain of dependent mma is longer than the k-steps
//   the exponentials and the diagonal sub-blocks run on the CUDA cores:
//   cumsums in log2 units, one ex2.approx each
//   one CTA of 8 warps per row (and per block of DV value columns when
//   D > 64), two CTAs an SM: A, the cumsums and the exponentials depend on
//   r, k and logw only and are made once a row; each warp keeps its tiles
//   of S in mma accumulators across the chunks, and a copy in shared
//   memory is the B operand of the next chunk's r S
//   a chunk is five phases between barriers: the cumsums a thread a
//   (sub-block, channel), then the block prefixes and every decayed operand
//   (r exp(lcp), k exp(lc[L-1] - lc) in logw's now free slot, the factors
//   of A); the state update, A (its off-diagonal tiles on the warps whose
//   diagonal rows are short) and r S; A v and the output; the state's copy
//   the next chunk's r, k, v (their dtype) and logw stream into a second
//   shared-memory buffer with cp.async while this chunk computes (16-byte
//   copies where the rows are aligned, else plain loads)
//   o is written in r's dtype and layout, the state in fp32; rows are
//   addressed by strides (unit stride on the last axis), so a (B, H, T, D)
//   view of the model's (B, T, H, D) projections is read where it lies;
//   channels past D and steps past T are zeros that change nothing
//
// Bound on the H100: bytes.  At the model's prefill (256 rows of 1024
// steps, D = 64, bf16 r, k, v) the kernel must move 205.6 MB (0.061 ms at
// 3.35 TB/s); the chunked form's products, three times for the split, take
// 0.033 ms at 495 TFLOP/s TF32 and its elementwise work ~0.01 ms at 67
// TFLOP/s fp32.
//
// Summation: the products and sums run in another order than the plain
// version's step-by-step einsum, and the decays are products of
// exponentials of cumsum differences: the two agree to a tolerance
// (kernels/wkv6/cases.py::TOL).  The build keeps --fmad=false; the sums on
// the CUDA cores (the cumsum, the bonus and the diagonal sub-blocks) are
// written as fmaf.
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
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2**x for x <= 0 on the special-function unit (ex2.approx; results below
// 2**-126 flushed to 0, far under the tolerance).  The kernel keeps its
// cumsums in log2 units, so exp(lc_a - lc_b) is ex2 of their difference.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo for the 3xTF32 products.  The tensor cores read a TF32
// operand from the top 19 bits of its register and ignore the rest, so
// adding half a TF32 ulp (0x1000) to the bits rounds to nearest (ties away
// from zero, as cvt.rna); hi's dropped bits are masked off only to form lo
// = x - hi, which is exact and is rounded the same way.  The inputs are
// finite.
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
// 3xTF32, the three products in three accumulators (hi*hi, lo*hi, hi*lo)
// so that no chain of dependent mma is longer than the k-steps.  BX: B is
// exact in TF32 (v read from bf16), so it is not split and hi*lo is 0.
// fa(i, kk): A at row i of the tile, column kk; fb(kk, j): B at row kk,
// column j of the warp's 8 NT columns (kk absolute, from k).  Layout of
// m16n8k8 (PTX ISA): g = lane / 4, q = lane % 4; A (g, q), (g+8, q), (g,
// q+4), (g+8, q+4); B (q, g), (q+4, g); C (g, 2q), (g, 2q+1), (g+8, 2q),
// (g+8, 2q+1).
template <int NT, bool BX = false, class FA, class FB>
__device__ __forceinline__ void mma_kstep(float (&hh)[NT][4],
                                          float (&lh)[NT][4],
                                          float (&hl)[NT][4], int lane,
                                          int k, FA fa, FB fb) {
  const int g = lane >> 2, q = lane & 3;
  uint32_t ah[4], al[4];
  split(fa(g, k + q), ah[0], al[0]);
  split(fa(g + 8, k + q), ah[1], al[1]);
  split(fa(g, k + q + 4), ah[2], al[2]);
  split(fa(g + 8, k + q + 4), ah[3], al[3]);
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
    mma_tf32(lh[j], al, bh);
    mma_tf32(hh[j], ah, bh);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// In: element type of r, k, v, o.  DK: channels (D <= DK, a multiple of 16).
// DV: value columns a CTA.  L: steps a chunk (a multiple of 16).  NW: warps.
template <typename In, int DK, int DV, int L, int NW>
struct Cfg {
  static constexpr int NTH = 32 * NW;
  static constexpr int NB = L / 8;     // 8-step sub-blocks a chunk
  static constexpr int MT = L / 16;    // 16-step row tiles a chunk
  static constexpr int P = DK + 4;     // row stride of (L, DK) tiles
  static constexpr int PV = DV + 8;    // row stride of S
  static constexpr int PK = DK + 8;    // row stride of logw, then kS
  static constexpr int DG = DK / 8;    // 8-channel groups
  static constexpr int PA = L + 4;     // row stride of A
  // state tiles (16 channels x 8 columns): NTS a warp tile
  static constexpr int NTS = cmax(1, (DK / 16) * (DV / 8) / NW);
  static constexpr int NGS = DV / 8 / NTS;
  static constexpr int S_WT = (DK / 16) * NGS;
  static constexpr int S_PW = (S_WT + NW - 1) / NW;
  // output tiles (16 steps x 8 columns): NTO a warp tile
  static constexpr int NTO = cmax(1, MT * (DV / 8) / NW);
  static constexpr int NGO = DV / 8 / NTO;
  static constexpr int O_WT = MT * NGO;
  // a stage: r, k (L, DK) In; v (L, DVS) In; logw (L, PK) fp32, whose slot
  // then holds the state update's decayed k.  v's and logw's rows are
  // padded so that fragments read 32 banks
  static constexpr int DVS = DV + 8;
  static constexpr int ST_K = L * DK * (int)sizeof(In);
  static constexpr int ST_V = 2 * ST_K;
  static constexpr int ST_LW = ST_V + L * DVS * (int)sizeof(In);
  static constexpr int STAGE = ST_LW + L * PK * 4;
  // fp32 work buffers after the two stages
  static constexpr int F_RA = L * P;
  static constexpr int F_KE = 2 * L * P;
  static constexpr int F_QS = 3 * L * P;
  static constexpr int F_S = 4 * L * P;
  static constexpr int F_A = F_S + DK * PV;
  static constexpr int F_MID = F_A + L * PA;
  static constexpr int F_TOT = F_MID + NB * NB * DK;
  static constexpr int F_W = F_TOT + NB * DK;
  static constexpr int F_U = F_W + DK;
  static constexpr int FLOATS = F_U + DK;
  static constexpr int SMEM = 2 * STAGE + 4 * FLOATS;
  // two CTAs an SM where shared memory allows (228 KB an SM, 1 KB of it
  // reserved a CTA) and D <= 64: registers are then held to 128 a thread
  // at 8 warps (at D = 128 the state's tiles need more)
  static constexpr int MINB = DK <= 64 && 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(DK % 16 == 0 && DV % 8 == 0 && L % 16 == 0, "tile shapes");
  static_assert((DV / 8) % NTS == 0 && (DV / 8) % NTO == 0, "warp tiles");
  static_assert(STAGE % 16 == 0, "stage alignment");
};

template <typename In, int DK, int DV, int L, int NW>
__global__ void __launch_bounds__(32 * NW, (Cfg<In, DK, DV, L, NW>::MINB))
    wkv6_chunk_kernel(const In* __restrict__ r, const In* __restrict__ k,
                      const In* __restrict__ v,
                      const float* __restrict__ logw,
                      const float* __restrict__ u, int H, int T, int D,
                      int64_t sb, int64_t sh, int64_t st, int64_t sub,
                      int64_t suh, int vec, In* __restrict__ o,
                      float* __restrict__ state) {
  using C = Cfg<In, DK, DV, L, NW>;
  constexpr int P = C::P, PV = C::PV, PA = C::PA, NB = C::NB, NTH = C::NTH;
  constexpr int PK = C::PK;
  constexpr int DG = C::DG, DVS = C::DVS;
  constexpr bool VX = sizeof(In) == 2;  // v is exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  float* f = reinterpret_cast<float*>(smem + 2 * C::STAGE);
  float* lc = f;
  float* rA = f + C::F_RA;
  float* kE = f + C::F_KE;
  float* qS = f + C::F_QS;
  float* Ss = f + C::F_S;
  float* As = f + C::F_A;
  float* mid = f + C::F_MID;
  float* tot = f + C::F_TOT;
  float* wL = f + C::F_W;
  float* us = f + C::F_U;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int row = blockIdx.x, c0 = blockIdx.y * DV;
  const int dv = min(DV, D - c0);  // this CTA's value columns
  const int64_t base = (int64_t)(row / H) * sb + (int64_t)(row % H) * sh;

  // zeros in both stages: channels and columns past D are never loaded and
  // stay 0; steps past T hold an earlier chunk's finite values, masked
  for (int e = tid; e < 2 * C::STAGE / 16; e += NTH) {
    reinterpret_cast<int4*>(smem)[e] = make_int4(0, 0, 0, 0);
  }
  const float* urow = u + (int64_t)(row / H) * sub + (int64_t)(row % H) * suh;
  for (int d = tid; d < DK; d += NTH) us[d] = d < D ? urow[d] : 0.f;
  for (int e = tid; e < DK * PV; e += NTH) Ss[e] = 0.f;
  __syncthreads();

  // chunk starting at t0 -> stage buf (cp.async 16-byte pieces, or plain
  // copies); one commit group a call
  auto load = [&](int buf, int t0) {
    unsigned char* sg = smem + buf * C::STAGE;
    In* sr = reinterpret_cast<In*>(sg);
    In* sk = reinterpret_cast<In*>(sg + C::ST_K);
    In* sv = reinterpret_cast<In*>(sg + C::ST_V);
    float* sl = reinterpret_cast<float*>(sg + C::ST_LW);
    const int n = min(L, T - t0);
    if (vec) {
      // pieces of 16 bytes: a row has ppr <= PPR of them (constant divisors)
      constexpr int E = 16 / (int)sizeof(In);
      constexpr int PPR = DK / E, PPV = DV / E, PPL = DK / 4;
      const int ppr = D / E, ppv = dv / E, ppl = D / 4;
      for (int e = tid; e < n * PPR; e += NTH) {
        const int t = e / PPR, p = e % PPR;
        if (p >= ppr) continue;
        const int64_t gi = base + (int64_t)(t0 + t) * st + p * E;
        cp_async16(sr + t * DK + p * E, r + gi);
        cp_async16(sk + t * DK + p * E, k + gi);
      }
      for (int e = tid; e < n * PPV; e += NTH) {
        const int t = e / PPV, p = e % PPV;
        if (p >= ppv) continue;
        cp_async16(sv + t * DVS + p * E,
                   v + base + (int64_t)(t0 + t) * st + c0 + p * E);
      }
      for (int e = tid; e < n * PPL; e += NTH) {
        const int t = e / PPL, p = e % PPL;
        if (p >= ppl) continue;
        cp_async16(sl + t * PK + p * 4,
                   logw + base + (int64_t)(t0 + t) * st + p * 4);
      }
    } else {
      for (int e = tid; e < n * D; e += NTH) {
        const int t = e / D, d = e - t * D;
        const int64_t gi = base + (int64_t)(t0 + t) * st + d;
        sr[t * DK + d] = r[gi];
        sk[t * DK + d] = k[gi];
        sl[t * PK + d] = logw[gi];
      }
      for (int e = tid; e < n * dv; e += NTH) {
        const int t = e / dv, j = e - t * dv;
        sv[t * DVS + j] = v[base + (int64_t)(t0 + t) * st + c0 + j];
      }
    }
    cp_async_commit();
  };

  float sacc[C::S_PW][C::NTS][4];
#pragma unroll
  for (int i = 0; i < C::S_PW; ++i) zero(sacc[i]);

  const int nchunks = (T + L - 1) / L;
  if (nchunks > 0) load(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * L, n = min(L, T - t0);
    if (c + 1 < nchunks) {
      load((c + 1) & 1, t0 + L);
    } else {
      cp_async_commit();  // an empty group keeps wait_group 1 right
    }
    cp_async_wait_one();
    __syncthreads();
    unsigned char* sg = smem + (c & 1) * C::STAGE;
    const In* sr = reinterpret_cast<const In*>(sg);
    const In* sk = reinterpret_cast<const In*>(sg + C::ST_K);
    const In* sv = reinterpret_cast<const In*>(sg + C::ST_V);
    float* sl = reinterpret_cast<float*>(sg + C::ST_LW);
    float* kS = sl;  // logw's slot, once step 1 has read it

    // ---- 1. the cumsum of logw in log2 units (lc below), a thread a
    // (sub-block, channel): its eight steps, then the sub-blocks' totals
    // summed in order --------------------------------------------------------
    for (int it = tid; it < NB * DK; it += NTH) {
      const int J = it / DK, d = it - J * DK;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * J + i;
        acc = t < n ? fmaf(sl[t * PK + d], kLog2e, acc) : acc;
        lc[t * P + d] = acc;
      }
      tot[J * DK + d] = acc;
    }
    __syncthreads();
    // every exponent below is <= 0: lc does not increase, and lc at a
    // sub-block's last step is the next sub-block's prefix, bit for bit
    for (int it = tid; it < NB * DK; it += NTH) {
      const int J = it / DK, d = it - J * DK;
      float pre[NB + 1], pJ = 0.f, pJ1 = 0.f;
      pre[0] = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        pre[j + 1] = pre[j] + tot[j * DK + d];
        if (j == J) {  // (no runtime index into pre: it stays in registers)
          pJ = pre[j];
          pJ1 = pre[j + 1];
        }
      }
      const float lcL = pre[NB];
      const float gJv = ex2(pJ), hIv = ex2(lcL - pJ1);
      float prev = pJ;  // lcp of the step
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * J + i;
        const float lct = pJ + lc[t * P + d];
        const bool in = t < n;
        const float rv = in ? to_f(sr[t * DK + d]) : 0.f;
        const float kv = in ? to_f(sk[t * DK + d]) : 0.f;
        const float ra = rv * ex2(prev - pJ);
        rA[t * P + d] = ra;
        qS[t * P + d] = ra * gJv;
        const float ke = kv * ex2(pJ1 - lct);
        kE[t * P + d] = ke;
        kS[t * PK + d] = ke * hIv;
        lc[t * P + d] = lct;
        prev = lct;
      }
#pragma unroll
      for (int I = 0; I < NB; ++I) {
        mid[(I * NB + J) * DK + d] = I < J ? ex2(pJ - pre[I + 1]) : 0.f;
      }
      if (J == 0) wL[d] = ex2(lcL);
    }
    __syncthreads();

    // ---- 2. the state update, A, r S ---------------------------------------
    // the state: S = exp(lc[L-1]) S + kS^T v, kS = kE exp(lc[L-1] - lc[e])
#pragma unroll
    for (int i = 0; i < C::S_PW; ++i) {
      const int wt = warp + NW * i;
      if (wt < C::S_WT) {
        const int db = 16 * (wt / C::NGS), cb = 8 * C::NTS * (wt % C::NGS);
        const float w0 = wL[db + g], w1 = wL[db + g + 8];
        float lh[C::NTS][4], hl[C::NTS][4];
        zero(lh);
        zero(hl);
#pragma unroll
        for (int j = 0; j < C::NTS; ++j) {
          sacc[i][j][0] *= w0;
          sacc[i][j][1] *= w0;
          sacc[i][j][2] *= w1;
          sacc[i][j][3] *= w1;
        }
#pragma unroll
        for (int ks = 0; ks < L / 8; ++ks) {
          mma_kstep<C::NTS, VX>(
              sacc[i], lh, hl, lane, 8 * ks,
              [&](int ii, int s) { return kS[s * PK + db + ii]; },
              [&](int s, int j) { return to_f(sv[s * DVS + cb + j]); });
        }
#pragma unroll
        for (int j = 0; j < C::NTS; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) sacc[i][j][x] += lh[j][x] + hl[j][x];
      }
    }
    // A's off-diagonal sub-blocks on the tensor cores: row tile m (steps
    // 16m..16m+15) against source block I <= 2m; rows of blocks J <= I are
    // zeroed through mid and not stored.  The even warps take them: the odd
    // ones hold the diagonal sub-blocks' longer rows below
    for (int a = (warp & 1) ? C::MT * C::MT : warp >> 1; a < C::MT * C::MT;
         a += NW >> 1) {
      int m = 0;
      while ((m + 1) * (m + 1) <= a) ++m;
      const int I = a - m * m, tb = 16 * m;
      float hh[1][4], lh[1][4], hl[1][4];
      zero(hh);
      zero(lh);
      zero(hl);
#pragma unroll 2
      for (int ks = 0; ks < DK / 8; ++ks) {
        mma_kstep<1>(
            hh, lh, hl, lane, 8 * ks,
            [&](int i, int d) {
              return rA[(tb + i) * P + d] *
                     mid[(I * NB + 2 * m + (i >> 3)) * DK + d];
            },
            [&](int d, int j) { return kE[(8 * I + j) * P + d]; });
      }
      float* a0 = As + (tb + g) * PA + 8 * I + 2 * q;
      if (I < 2 * m) {
        a0[0] = (lh[0][0] + hl[0][0]) + hh[0][0];
        a0[1] = (lh[0][1] + hl[0][1]) + hh[0][1];
      }
      a0[8 * PA] = (lh[0][2] + hl[0][2]) + hh[0][2];
      a0[8 * PA + 1] = (lh[0][3] + hl[0][3]) + hh[0][3];
    }
    // A's diagonal sub-blocks, a thread a (step t, channels dg + DG x): t's
    // row of its sub-block (s < t: the decayed products; s == t: the bonus,
    // apart, so that no lane waits on another's; s > t: 0), summed over the
    // channel groups by shuffles; on rows of an even sub-block, the next
    // sub-block's part of the row tile is zeroed.  (Interleaved channels: a
    // warp's lanes read 32 banks.)
    for (int it = tid; it < L * DG; it += NTH) {
      const int t = it / DG, dg = it - t * DG, tl = t & 7, b = t & ~7;
      float rt[8], lpt[8], acc[8], bonus = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int d = dg + DG * x;
        rt[x] = t < n ? to_f(sr[t * DK + d]) : 0.f;
        lpt[x] = t ? lc[(t - 1) * P + d] : 0.f;
        acc[x] = 0.f;
        bonus = fmaf(rt[x] * us[d], to_f(sk[t * DK + d]), bonus);
      }
#pragma unroll
      for (int sl = 0; sl < 7; ++sl) {
        if (sl < tl) {
          const int s = b + sl;
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int d = dg + DG * x;
            acc[sl] = fmaf(rt[x] * to_f(sk[s * DK + d]),
                           ex2(fminf(lpt[x] - lc[s * P + d], 0.f)), acc[sl]);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < DG; off <<= 1) {
        bonus += __shfl_xor_sync(0xffffffffu, bonus, off);
#pragma unroll
        for (int sl = 0; sl < 7; ++sl) {
          acc[sl] += __shfl_xor_sync(0xffffffffu, acc[sl], off);
        }
      }
      if (dg == 0) {
#pragma unroll
        for (int sl = 0; sl < 8; ++sl) {
          As[t * PA + b + sl] = sl == tl ? bonus : acc[sl];
        }
      } else if (dg == 1 && (b & 8) == 0) {
#pragma unroll
        for (int sl = 0; sl < 8; ++sl) As[t * PA + b + 8 + sl] = 0.f;
      }
    }
    // o's first term, qS S = (rA exp(lcp[8J])) S, kept in registers for
    // step 3
    const int om = warp / C::NGO, otb = 16 * om;
    const int ocb = 8 * C::NTO * (warp % C::NGO);
    static_assert(C::O_WT == NW, "one output tile a warp");
    float ohh[C::NTO][4], olh[C::NTO][4], ohl[C::NTO][4];
    zero(ohh);
    zero(olh);
    zero(ohl);
#pragma unroll 2
    for (int ks = 0; ks < DK / 8; ++ks) {
      mma_kstep<C::NTO>(
          ohh, olh, ohl, lane, 8 * ks,
          [&](int i, int d) { return qS[(otb + i) * P + d]; },
          [&](int d, int j) { return Ss[d * PV + ocb + j]; });
    }
    __syncthreads();

    // ---- 3. o += A v, and out -----------------------------------------------
    for (int ks = 0; ks < 2 * om + 2; ++ks) {
      mma_kstep<C::NTO, VX>(
          ohh, olh, ohl, lane, 8 * ks,
          [&](int i, int s) { return As[(otb + i) * PA + s]; },
          [&](int s, int j) { return to_f(sv[s * DVS + ocb + j]); });
    }
#pragma unroll
    for (int j = 0; j < C::NTO; ++j) {
      const int col = ocb + 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = otb + g + 8 * h;
        if (t < n && col < dv) {
          const float x0 = (olh[j][2 * h] + ohl[j][2 * h]) + ohh[j][2 * h];
          const float x1 =
              (olh[j][2 * h + 1] + ohl[j][2 * h + 1]) + ohh[j][2 * h + 1];
          In* dst = o + base + (int64_t)(t0 + t) * st + c0 + col;
          if (vec) {
            store2(dst, x0, x1);
          } else {
            store1(dst, x0);
            if (col + 1 < dv) store1(dst + 1, x1);
          }
        }
      }
    }
    __syncthreads();

    // ---- 4. the new state for the next chunk's r S -------------------------
#pragma unroll
    for (int i = 0; i < C::S_PW; ++i) {
      const int wt = warp + NW * i;
      if (wt < C::S_WT) {
        const int db = 16 * (wt / C::NGS), cb = 8 * C::NTS * (wt % C::NGS);
#pragma unroll
        for (int j = 0; j < C::NTS; ++j) {
          float* p0 = Ss + (db + g) * PV + cb + 8 * j + 2 * q;
          p0[0] = sacc[i][j][0];
          p0[1] = sacc[i][j][1];
          p0[8 * PV] = sacc[i][j][2];
          p0[8 * PV + 1] = sacc[i][j][3];
        }
      }
    }
  }

  // the final state, rows d < D, columns c0 .. c0 + dv
#pragma unroll
  for (int i = 0; i < C::S_PW; ++i) {
    const int wt = warp + NW * i;
    if (wt < C::S_WT) {
      const int db = 16 * (wt / C::NGS), cb = 8 * C::NTS * (wt % C::NGS);
#pragma unroll
      for (int j = 0; j < C::NTS; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int d = db + g + 8 * (x >> 1);
          const int col = cb + 8 * j + 2 * q + (x & 1);
          if (d < D && col < dv) {
            state[((int64_t)row * D + d) * D + c0 + col] = sacc[i][j][x];
          }
        }
      }
    }
  }
}

template <typename In, int DK, int DV, int L, int NW>
int run(const void* r, const void* k, const void* v, const float* logw,
        const float* u, int rows, int H, int T, int D, int64_t sb,
        int64_t sh, int64_t st, int64_t sub, int64_t suh, int vec, void* o,
        float* state, cudaStream_t s) {
  using C = Cfg<In, DK, DV, L, NW>;
  auto kern = wkv6_chunk_kernel<In, DK, DV, L, NW>;
  static bool opted_in = false;  // the shared-memory opt-in, once an instance
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(rows, (D + DV - 1) / DV);
  kern<<<grid, C::NTH, C::SMEM, s>>>(
      static_cast<const In*>(r), static_cast<const In*>(k),
      static_cast<const In*>(v), logw, u, H, T, D, sb, sh, st, sub, suh, vec,
      static_cast<In*>(o), state);
  return static_cast<int>(cudaGetLastError());
}

// The shape a width runs at: DK channels, DV value columns a CTA, L steps a
// chunk (32, the reference's default; 16 where shared memory is short),
// NW warps.  (At the model's D = 64, chunks of 16 and 64 steps timed slower
// than 32 on the H100: PERF.md.)
template <typename In>
int dispatch(const void* r, const void* k, const void* v, const float* logw,
             const float* u, int rows, int H, int T, int D, int64_t sb,
             int64_t sh, int64_t st, int64_t sub, int64_t suh, int vec,
             void* o, float* state, cudaStream_t s) {
#define WKV6_RUN(DK, DV, L, NW)                                            \
  run<In, DK, DV, L, NW>(r, k, v, logw, u, rows, H, T, D, sb, sh, st, sub, \
                         suh, vec, o, state, s)
  if (D <= 16) return WKV6_RUN(16, 16, 32, 4);
  if (D <= 32) return WKV6_RUN(32, 32, 32, 4);
  if (D <= 64) return WKV6_RUN(64, 64, 32, 8);
  return WKV6_RUN(128, 64, 16, 8);
#undef WKV6_RUN
}

}  // namespace

// r, k, v, o: (B, H, T, D) in the element type (bf16 != 0: bf16, else
// fp32) at strides (sb, sh, st, 1), all four alike; logw: fp32 at the same
// strides; u: fp32, the bonus row of b*H + h at u + b*sub + h*suh (unit
// stride); state: (B*H, D, D) fp32.  1 <= D <= 128.
// vec != 0 promises 16-byte aligned rows: every pointer 16-byte aligned and
// D, sb, sh, st multiples of 16 bytes' worth of elements (of r's type and of
// fp32).  Returns the launch error, if any (cudaErrorInvalidValue for
// arguments out of range).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const float* logw, const float* u, int B, int H,
                           int T, int D, long long sb, long long sh,
                           long long st, long long sub, long long suh,
                           int bf16, int vec, void* o,
                           float* state, void* stream) {
  if (D < 1 || D > 128 || B < 0 || H < 1 || T < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * H;
  if (rows == 0) return 0;
  return bf16 ? dispatch<__nv_bfloat16>(r, k, v, logw, u, rows, H, T, D, sb,
                                        sh, st, sub, suh, vec, o, state, s)
              : dispatch<float>(r, k, v, logw, u, rows, H, T, D, sb, sh, st,
                                sub, suh, vec, o, state, s);
}
