// Forward softmax attention with an online softmax (flash attention), GQA
// and an optional causal mask:
//
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / group, j] / sqrt(d))
//                      v[b, h / group, j]
//
// over the keys j < Tk (and j <= i when causal, both counted from 0), with
// the scores, the running max, the denominator and the accumulator in
// fp32; o is written once, in q's dtype.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_kernel (grid
// (B, Hq, Tq / bq, Tk / bk), the key tiles a sequential grid axis with the
// running max, denominator and accumulator in VMEM scratch carried across
// it, fully masked key tiles skipped, keys past kv_len masked after the
// wrapper pads both sequence axes to the tile).  TPU grid steps run in
// order; CTAs here run in no order, so the key tiles become a loop inside
// one CTA and nothing is carried between CTAs:
//
//   one CTA per (b, h, 64-row query tile), 4 warps, each warp owning 16
//   query rows with their max, sum and accumulator slice in registers; the
//   CTAs of the last (largest causal) query tile of every head go first
//   the loop over 64-key tiles stops after the last key any row of the
//   tile may see: the diagonal tile when causal (the TPU kernel's skip of
//   fully masked tiles) and Tk otherwise
//   K and V tiles are staged through shared memory, zero past Tk; rows
//   past Tq compute on zeros and write nothing: no padding copy, nothing
//   read or written out of bounds
//   masked scores are the reference's finite NEG_INF = -1e30, so
//   exp(m_prev - m_new) stays defined while a row has seen only masked
//   keys (no live row can: key 0 is in the first tile and seen by all)
//
// bf16 inputs: both products on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 sums).  Q stays in registers as A fragments for the whole
// loop; the score fragments become the A fragments of P V without leaving
// registers (P rounded to bf16 for the product, the denominator summed in
// fp32); V is stored transposed in shared memory so each B fragment is one
// 32-bit load.  fp32 inputs: the same loop on the CUDA cores in fp32, each
// thread a 4 x 8 block of the score tile and 4 rows x d/8 columns of the
// output (the products cannot go to the bf16 tensor cores and keep the
// fp32 contract).
//
// Tensors are addressed by strides with a unit stride on d, so the
// (B, H, T, d) views of the model's (B, T, H, d) projections are read
// where they lie and o can be written in that layout; every other stride
// is a multiple of 16 bytes and the bases 16-byte aligned (the wrapper
// checks), for 16-byte loads.
//
// Bound on the H100 at the glm4 prefill (B 8, Hq 32, Hkv 2, T 1024, d 128,
// causal): 4 d T(T+1)/2 B Hq = 68.8 GFLOP against 142.6 MB read and
// written: 0.0696 ms at 989 TFLOP/s bf16 and 0.0426 ms at 3.35 TB/s, so
// the operations bound it; the design puts both products on the tensor
// cores and never stores the (T, T) scores.  What it leaves for later
// (ROADMAP B.7): wgmma and TMA, a pipeline of K/V tiles (cp.async),
// ldmatrix in place of the transposing V store, warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows a CTA
constexpr int BK = 64;    // keys a tile
constexpr int NT = 128;   // threads a CTA (4 warps)
constexpr int PAD = 8;    // bf16 elements of padding a shared-memory row
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, group, Tq, Tk, causal;
  int64_t sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot;
  float scale;
};

// The keys a query tile starting at row q0 must visit: [0, end).
__device__ __forceinline__ int key_end(const Args& a, int q0) {
  return a.causal ? min(a.Tk, min(a.Tq, q0 + BQ)) : a.Tk;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------- bf16 --
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): A regs
// {row g, row g+8} x {cols 2t.., cols 2t+8..}; B regs {rows 2t.., rows
// 2t+8..} at col g; C {row g, row g+8} x cols 2t, 2t+1.
template <int D>
__global__ void __launch_bounds__(NT) flash_bf16(const Args a) {
  constexpr int LDQ = D + PAD, LDK = D + PAD, LDV = BK + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LDQ;   // [BK][LDK]
  __nv_bfloat16* Vt = Ks + BK * LDK;   // [D][LDV], V transposed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) +
                           b * a.sqb + h * a.sqh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) +
                           b * a.skb + hk * a.skh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) +
                           b * a.svb + hk * a.svh;
  constexpr int VEC = D / 8;           // 16-byte vectors a row
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int idx = tid; idx < BQ * VEC; idx += NT) {
    const int r = idx / VEC, c = (idx % VEC) * 8;
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c) =
        q0 + r < a.Tq ? *reinterpret_cast<const uint4*>(
                            q + (int64_t)(q0 + r) * a.sqt + c)
                      : zero;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;        // this thread's rows r0, r0 + 8
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = ld32(Qs + r0 * LDQ + c);
    qa[ks][1] = ld32(Qs + (r0 + 8) * LDQ + c);
    qa[ks][2] = ld32(Qs + r0 * LDQ + c + 8);
    qa[ks][3] = ld32(Qs + (r0 + 8) * LDQ + c + 8);
  }

  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float oacc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dn][e] = 0.f;
  }
  const int row0 = q0 + r0, row1 = row0 + 8;
  const int kend = key_end(a, q0);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                   // the last tile's readers are done
    for (int idx = tid; idx < BK * VEC; idx += NT) {
      const int r = idx / VEC, c = (idx % VEC) * 8;
      *reinterpret_cast<uint4*>(Ks + r * LDK + c) =
          k0 + r < a.Tk ? *reinterpret_cast<const uint4*>(
                              k + (int64_t)(k0 + r) * a.skt + c)
                        : zero;
    }
    for (int idx = tid; idx < BK * VEC; idx += NT) {
      const int r = idx % BK, c = (idx / BK) * 8;   // lanes on rows
      uint4 val = k0 + r < a.Tk ? *reinterpret_cast<const uint4*>(
                                      v + (int64_t)(k0 + r) * a.svt + c)
                                : zero;
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * LDV + r] = e8[e];
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LDK + ks * 16 + 2 * t;
        const uint32_t kb[2] = {ld32(kr), ld32(kr + 8)};
        mma_16816(s[nt], qa[ks], kb);
      }
    }
    float mx0 = m_r[0], mx1 = m_r[1];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + nt * 8 + 2 * t + (e & 1);
        const int i = e < 2 ? row0 : row1;
        const bool ok = j < a.Tk && (!a.causal || i >= j);
        s[nt][e] = ok ? s[nt][e] * a.scale : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float al0 = expf(m_r[0] - mx0), al1 = expf(m_r[1] - mx1);
    m_r[0] = mx0;
    m_r[1] = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mx0);
      s[nt][1] = expf(s[nt][1] - mx0);
      s[nt][2] = expf(s[nt][2] - mx1);
      s[nt][3] = expf(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    // this thread's part of each row sum; the four threads of a row are
    // added at the end (every part is rescaled by the same alpha)
    l_r[0] = l_r[0] * al0 + sum0;
    l_r[1] = l_r[1] * al1 + sum1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      oacc[dn][0] *= al0;
      oacc[dn][1] *= al0;
      oacc[dn][2] *= al1;
      oacc[dn][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* vr = Vt + (dn * 8 + g) * LDV + kk * 16 + 2 * t;
        const uint32_t vb[2] = {ld32(vr), ld32(vr + 8)};
        mma_16816(oacc[dn], pa, vb);
      }
    }
  }

  float l0 = l_r[0], l1 = l_r[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.sob +
                     h * a.soh;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (row0 < a.Tq) {
      *reinterpret_cast<uint32_t*>(o + (int64_t)row0 * a.sot + c) =
          pack_bf16(oacc[dn][0] / l0, oacc[dn][1] / l0);
    }
    if (row1 < a.Tq) {
      *reinterpret_cast<uint32_t*>(o + (int64_t)row1 * a.sot + c) =
          pack_bf16(oacc[dn][2] / l1, oacc[dn][3] / l1);
    }
  }
}

// ---------------------------------------------------------------- fp32 --
// Thread (tr, tc) = (tid / 8, tid % 8) owns rows 4 tr .. 4 tr + 3 of the
// tile, keys tc + 8 c (c < 8) of the score tile and output columns
// tc + 8 c (c < D / 8); a row's eight owners are eight neighbouring lanes.
template <int D>
__global__ void __launch_bounds__(NT) flash_fp32(const Args a) {
  constexpr int LDQ = D + 1, LDK = D + 1, LDP = BK + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BQ][LDQ]
  float* Ks = Qs + BQ * LDQ;                         // [BK][LDK]
  float* Vs = Ks + BK * LDK;                         // [BK][D]
  float* Ps = Vs + BK * D;                           // [BQ][LDP]

  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int bh = blockIdx.x, b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float* q = static_cast<const float*>(a.q) + b * a.sqb + h * a.sqh;
  const float* k = static_cast<const float*>(a.k) + b * a.skb + hk * a.skh;
  const float* v = static_cast<const float*>(a.v) + b * a.svb + hk * a.svh;
  constexpr int VEC = D / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int idx = tid; idx < BQ * VEC; idx += NT) {
    const int r = idx / VEC, c = (idx % VEC) * 4;
    const float4 x = q0 + r < a.Tq ? *reinterpret_cast<const float4*>(
                                         q + (int64_t)(q0 + r) * a.sqt + c)
                                   : zero;
    float* dst = Qs + r * LDQ + c;
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }

  float m_r[4], l_r[4], acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }
  const int kend = key_end(a, q0);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * VEC; idx += NT) {
      const int r = idx / VEC, c = (idx % VEC) * 4;
      const bool in = k0 + r < a.Tk;
      const float4 x = in ? *reinterpret_cast<const float4*>(
                                k + (int64_t)(k0 + r) * a.skt + c)
                          : zero;
      float* dst = Ks + r * LDK + c;
      dst[0] = x.x;
      dst[1] = x.y;
      dst[2] = x.z;
      dst[3] = x.w;
      *reinterpret_cast<float4*>(Vs + r * D + c) =
          in ? *reinterpret_cast<const float4*>(v + (int64_t)(k0 + r) *
                                                        a.svt + c)
             : zero;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
    }
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * tr + i) * LDQ + dd];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = Ks[(tc + 8 * c) * LDK + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] += qv[i] * kv[c];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * tr + i;
      float mx = m_r[i];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = k0 + tc + 8 * c;
        const bool ok = j < a.Tk && (!a.causal || row >= j);
        s[i][c] = ok ? s[i][c] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float al = expf(m_r[i] - mx);
      m_r[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = expf(s[i][c] - mx);
        sum += s[i][c];
        Ps[(4 * tr + i) * LDP + tc + 8 * c] = s[i][c];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l_r[i] = l_r[i] * al + sum;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= al;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[D / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * tr + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) vv[c] = Vs[j * D + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < D / 8; ++c) acc[i][c] += pv[i] * vv[c];
      }
    }
  }

  float* o = static_cast<float*>(a.o) + b * a.sob + h * a.soh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= a.Tq) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      o[(int64_t)row * a.sot + tc + 8 * c] = acc[i][c] / l;
    }
  }
}

template <int D>
int launch(const Args& a, int B, int bf16, cudaStream_t s) {
  const dim3 grid(B * a.Hq, (a.Tq + BQ - 1) / BQ);
  cudaError_t err;
  if (bf16) {
    const int smem = (BQ * (D + PAD) + BK * (D + PAD) + D * (BK + PAD)) *
                     (int)sizeof(__nv_bfloat16);
    err = cudaFuncSetAttribute(
        flash_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bf16<D><<<grid, NT, smem, s>>>(a);
  } else {
    const int smem = (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) *
                     (int)sizeof(float);
    err = cudaFuncSetAttribute(
        flash_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fp32<D><<<grid, NT, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, Tq, d), k and v (B, Hkv, Tk, d), o (B, Hq, Tq, d), each at its
// strides (b, h, t, 1), in bf16 (bf16 != 0) or fp32; d in {16, 32, 64,
// 128}; Hq a multiple of Hkv; Tk >= 1.  Returns the launch error, if any
// (cudaErrorInvalidValue for arguments out of range).
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Tq, int Tk, int d, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, long long sob,
    long long soh, long long sot, int causal, int bf16, void* stream) {
  if (B < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Tq < 0 || Tk < 1 ||
      (Tq + BQ - 1) / BQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Tq == 0) return 0;
  Args a{q,   k,   v,   o,   Hq,  Hq / Hkv, Tq,  Tk,  causal ? 1 : 0,
         sqb, sqh, sqt, skb, skh, skt,      svb, svh, svt, sob,
         soh, sot, 1.0f / sqrtf(static_cast<float>(d))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(a, B, bf16, s);
    case 32: return launch<32>(a, B, bf16, s);
    case 64: return launch<64>(a, B, bf16, s);
    case 128: return launch<128>(a, B, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
