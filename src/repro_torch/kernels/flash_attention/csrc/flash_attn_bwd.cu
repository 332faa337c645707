// Backward of softmax attention with GQA and an optional causal mask, from
// the forward's output o and row log-sum-exp lse (natural-log units, fp32,
// (B, Hq, Tq), as flash_attn.cu writes it):
//
//   delta[i] = sum_c do[i, c] o[i, c]
//   P[i, j]  = exp(q[i] . k[j] / sqrt(d) - lse[i])     (0 where masked)
//   dP[i, j] = do[i] . v[j]
//   dS[i, j] = P[i, j] (dP[i, j] - delta[i]) / sqrt(d)
//   dq[i]    = sum_j dS[i, j] k[j]
//   dk[j]    = sum_{h in j's group} sum_i dS[i, j] q[i]
//   dv[j]    = sum_{h in j's group} sum_i P[i, j] do[i]
//
// over the keys j < Tk (and j <= i when causal, both counted from 0), with
// every score, weight and sum in fp32.  dq, dk and dv are written once, in
// the inputs' dtype.
//
// Replaces no Pallas kernel: the reference differentiates
// repro/models/flash_jnp.py::flash_mha through its custom VJP (_flash_bwd,
// :85), two lax.scans in jnp over query and key chunks that carry dk and dv
// across the query chunks.  Blocks here run in no order, so that carry
// becomes two kernels that own what they write, with no atomics, and two
// runs give the same bits:
//
//   dq kernel    one CTA a (b, q head, query tile): its prologue computes
//                the tile's delta (written to a workspace for the next
//                kernel), then it walks the key tiles up to the diagonal,
//                recomputing P from lse, and keeps dq in registers;
//   dk/dv kernel one CTA a (b, KV head, key tile), launched after the dq
//                kernel on the same stream: it walks the query heads of
//                the KV head's group and, for each, the query tiles from
//                the diagonal on, in a fixed order, and keeps dk and dv in
//                registers.
//
// A row that saw no key (its lse the reference's finite NEG_INF = -1e30)
// and every row past Tq get an lse of +inf in shared memory, so their
// weights exp(s - lse) are exactly 0, not exp of a rounding residual.
// Keys past Tk are masked; causal tiles above the diagonal are skipped.
//
// Bound on the H100 at GLM-4 9B's training microbatch (B 2, Hq 32, Hkv 2,
// T 4096, d 128, causal, bf16): five products of 2 d operations a causal
// pair (S, dP, dV, dK, dQ), 5 * 2 d * T(T+1)/2 * B * Hq ~ 687 GFLOP: 0.695
// ms at 989 TFLOP/s bf16, against ~285 MB read and written once (0.085 ms
// at 3.35 TB/s).  The tensor cores bound it.  This design does seven
// products, not five: each kernel recomputes S and dP for itself.
//
// bf16 inputs: the products on the tensor cores, mma.sync m16n8k16 with
// fp32 accumulators, operands staged in shared memory (rows padded by 16
// bytes, so ldmatrix reads no bank twice) and read by ldmatrix; P and dS
// go from the fp32 accumulators to bf16 A fragments in registers, as the
// forward's P does (that rounding, 2^-9 relative, is the bf16 tolerance's
// reason).  Four warps a CTA, 16 rows (queries, or keys) a warp.  Tiles
// are loaded with plain 16-byte loads; no cp.async, TMA or wgmma yet: a
// simple kernel that is right first.
//
// fp32 inputs: the same two kernels on the CUDA cores in fp32 (the bf16
// tensor cores would break the fp32 contract), 32 x 32 tiles, each thread
// one row and a quarter of the columns.
//
// Tensors are addressed by strides with a unit stride on d; every other
// stride is a multiple of 16 bytes and the bases 16-byte aligned (the
// wrapper checks, and copies do once where it is not so).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // (B, Hq, Tq), natural log
  float* delta;        // (B, Hq, Tq) workspace: written by the dq kernel
  void* dq;
  void* dk;
  void* dv;
  int Hq, Hkv, group, Tq, Tk, causal;
  // element strides (b, h, t) of q, k, v, o, do, dq, dk, dv
  long long s[8][3];
  float scale;         // 1 / sqrt(d)
  float scale_log2;    // log2(e) / sqrt(d)
};

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

template <typename T>
__device__ __forceinline__ const T* at(const void* p, const Args& a, int t,
                                       int b, int h) {
  return static_cast<const T*>(p) + b * a.s[t][0] + h * a.s[t][1];
}
template <typename T>
__device__ __forceinline__ T* at_mut(void* p, const Args& a, int t, int b,
                                     int h) {
  return static_cast<T*>(p) + b * a.s[t][0] + h * a.s[t][1];
}

// The lse the kernels use: +inf for a row past Tq or one that saw no key,
// so its weights come out 0.  ``log2`` asks for base 2 (the bf16 kernels'
// exp2).
__device__ __forceinline__ float row_lse(const Args& a, int bh, int row,
                                         bool log2) {
  if (row >= a.Tq) return INFINITY;
  const float l = a.lse[static_cast<long long>(bh) * a.Tq + row];
  if (l <= NEG_INF * 0.5f) return INFINITY;
  return log2 ? l * LOG2E : l;
}

// ---------------------------------------------------------------- bf16 --
namespace tc {

constexpr int NT = 128;      // four warps
constexpr int BQ = 64;       // dq kernel: query rows a CTA
constexpr int BK = 64;       // dq kernel: keys a step; dk/dv: keys a CTA
constexpr int BQ2 = 32;      // dk/dv kernel: query rows a step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16) * b (16 x 8, bf16).  Fragments:
// g = lane / 4, t = lane % 4; a: {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}; b: {(k 2t.., n g), (k 2t + 8.., n g)}; c: {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// The A fragment of rows r0 .. r0 + 15, columns c0 .. c0 + 15 of a
// row-major tile with LD elements a row.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* s,
                                       int r0, int c0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = c0 + (lane >> 4) * 8;
  ldsm_x4(a, s + r * LD + c);
}

// B fragments of two n8 tiles (n0 .. n0 + 15, k0 .. k0 + 15) of a tile
// stored [n][k]: b[0..1] the first tile's, b[2..3] the second's.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t* b,
                                          const __nv_bfloat16* s, int n0,
                                          int k0, int lane) {
  const int n = n0 + (lane & 7) + (lane >> 4) * 8;
  const int k = k0 + ((lane >> 3) & 1) * 8;
  ldsm_x4(b, s + n * LD + k);
}

// The same of a tile stored [k][n] (ldmatrix's transpose).
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t* b,
                                          const __nv_bfloat16* s, int k0,
                                          int n0, int lane) {
  const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int n = n0 + (lane >> 4) * 8;
  ldsm_x4_t(b, s + k * LD + n);
}

// Rows r0 .. r0 + R - 1 of a (T, D) bf16 slice with row stride st into a
// shared tile of LD elements a row; zeros past T.
template <int D, int R, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long st, int r0, int T) {
  constexpr int VEC = D / 8;
  for (int i = threadIdx.x; i < R * VEC; i += NT) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) {
      x = *reinterpret_cast<const uint4*>(src + (r0 + r) * st + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

// Keys a query tile starting at q0 (of R rows) must visit: [0, end).
__device__ __forceinline__ int key_end(const Args& a, int q0, int R) {
  return a.causal ? min(a.Tk, min(a.Tq, q0 + R)) : a.Tk;
}

template <int D>
constexpr int dq_smem() {
  return (2 * BQ + 2 * BK) * (D + 8) * 2 + 2 * BQ * 4;
}
template <int D>
constexpr int dkdv_smem() {
  return (2 * BK + 2 * BQ2) * (D + 8) * 2 + 2 * BQ2 * 4;
}

template <int D>
__global__ void __launch_bounds__(NT) bwd_dq_bf16(const Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * LD;
  __nv_bfloat16* Ks = dOs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + BK * LD);
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // last tiles first
  using bf = __nv_bfloat16;
  const bf* q = at<bf>(a.q, a, Q, b, h);
  const bf* k = at<bf>(a.k, a, K, b, hk);
  const bf* v = at<bf>(a.v, a, V, b, hk);
  const bf* o = at<bf>(a.o, a, O, b, h);
  const bf* dout = at<bf>(a.dout, a, DO, b, h);

  load_tile<D, BQ, LD>(Qs, q, a.s[Q][2], q0, a.Tq);
  load_tile<D, BQ, LD>(dOs, dout, a.s[DO][2], q0, a.Tq);
  // delta: two threads a row, each half of d, added in a fixed order
  {
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float sum = 0.f;
    if (row < a.Tq) {
      const bf* orow = o + row * a.s[O][2] + half * (D / 2);
      const bf* drow = dout + row * a.s[DO][2] + half * (D / 2);
#pragma unroll 4
      for (int c = 0; c < D / 2; ++c) {
        sum += __bfloat162float(drow[c]) * __bfloat162float(orow[c]);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      delta_s[r] = sum;
      lse_s[r] = row_lse(a, bh, row, true);
      if (row < a.Tq) a.delta[static_cast<long long>(bh) * a.Tq + row] = sum;
    }
  }

  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  }
  const int kend = key_end(a, q0, BQ);
  const float sl2 = a.scale_log2, sc = a.scale;

#pragma unroll 1
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // the last tile's readers (and the prologue) done
    load_tile<D, BK, LD>(Ks, k, a.s[K][2], k0, a.Tk);
    load_tile<D, BK, LD>(Vs, v, a.s[V][2], k0, a.Tk);
    __syncthreads();
    const float l0 = lse_s[wr + g], l1 = lse_s[wr + g + 8];
    const float d0 = delta_s[wr + g], d1 = delta_s[wr + g + 8];

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, Qs, wr, kk * 16, lane);
      load_a<LD>(da, dOs, wr, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < BK / 16; ++nt) {
        uint32_t kb[4], vb[4];
        load_b_nk<LD>(kb, Ks, nt * 16, kk * 16, lane);
        load_b_nk<LD>(vb, Vs, nt * 16, kk * 16, lane);
        mma16816(s[2 * nt], qa, kb[0], kb[1]);
        mma16816(s[2 * nt + 1], qa, kb[2], kb[3]);
        mma16816(dp[2 * nt], da, vb[0], vb[1]);
        mma16816(dp[2 * nt + 1], da, vb[2], vb[3]);
      }
    }
    // dS = P (dP - delta) / sqrt(d), packed as A fragments of 16 keys
    uint32_t dsa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float p = exp2f(s[j][e] * sl2 - (e < 2 ? l0 : l1));
        if (col >= a.Tk || (a.causal && col > row)) p = 0.f;
        ds[e] = p * (dp[j][e] - (e < 2 ? d0 : d1)) * sc;
      }
      dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dq += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < D / 16; ++nt) {
        uint32_t kb[4];
        load_b_kn<LD>(kb, Ks, kk * 16, nt * 16, lane);
        mma16816(dq[2 * nt], dsa[kk], kb[0], kb[1]);
        mma16816(dq[2 * nt + 1], dsa[kk], kb[2], kb[3]);
      }
    }
  }

  bf* dqp = at_mut<bf>(a.dq, a, DQ, b, h);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (row0 < a.Tq) {
      *reinterpret_cast<uint32_t*>(dqp + row0 * a.s[DQ][2] + col) =
          pack_bf16(dq[j][0], dq[j][1]);
    }
    if (row1 < a.Tq) {
      *reinterpret_cast<uint32_t*>(dqp + row1 * a.s[DQ][2] + col) =
          pack_bf16(dq[j][2], dq[j][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) bwd_dkdv_bf16(const Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK * LD;
  __nv_bfloat16* Qs = Vs + BK * LD;
  __nv_bfloat16* dOs = Qs + BQ2 * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ2 * LD);
  float* delta_s = lse_s + BQ2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const int k0 = blockIdx.y * BK;   // the first tiles see the most queries
  using bf = __nv_bfloat16;
  load_tile<D, BK, LD>(Ks, at<bf>(a.k, a, K, b, hk), a.s[K][2], k0, a.Tk);
  load_tile<D, BK, LD>(Vs, at<bf>(a.v, a, V, b, hk), a.s[V][2], k0, a.Tk);

  const int wr = warp * 16;
  const int key0 = k0 + wr + g, key1 = key0 + 8;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  }
  const float sl2 = a.scale_log2, sc = a.scale;
  // causal: query i sees key j when i >= j, so no query tile before the
  // one holding row k0 sees this key tile
  const int q_start = a.causal ? (k0 / BQ2) * BQ2 : 0;

#pragma unroll 1
  for (int h = hk * a.group; h < (hk + 1) * a.group; ++h) {
    const int bh = b * a.Hq + h;
    const bf* q = at<bf>(a.q, a, Q, b, h);
    const bf* dout = at<bf>(a.dout, a, DO, b, h);
#pragma unroll 1
    for (int q0 = q_start; q0 < a.Tq; q0 += BQ2) {
      __syncthreads();   // the last step's readers done
      load_tile<D, BQ2, LD>(Qs, q, a.s[Q][2], q0, a.Tq);
      load_tile<D, BQ2, LD>(dOs, dout, a.s[DO][2], q0, a.Tq);
      if (tid < BQ2) {
        const int row = q0 + tid;
        lse_s[tid] = row_lse(a, bh, row, true);
        delta_s[tid] = row < a.Tq
                           ? a.delta[static_cast<long long>(bh) * a.Tq + row]
                           : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ2 queries a warp
      float st[BQ2 / 8][4], dpt[BQ2 / 8][4];
#pragma unroll
      for (int j = 0; j < BQ2 / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, Ks, wr, kk * 16, lane);
        load_a<LD>(va, Vs, wr, kk * 16, lane);
#pragma unroll
        for (int nt = 0; nt < BQ2 / 16; ++nt) {
          uint32_t qb[4], db[4];
          load_b_nk<LD>(qb, Qs, nt * 16, kk * 16, lane);
          load_b_nk<LD>(db, dOs, nt * 16, kk * 16, lane);
          mma16816(st[2 * nt], ka, qb[0], qb[1]);
          mma16816(st[2 * nt + 1], ka, qb[2], qb[3]);
          mma16816(dpt[2 * nt], va, db[0], db[1]);
          mma16816(dpt[2 * nt + 1], va, db[2], db[3]);
        }
      }
      uint32_t pa[BQ2 / 16][4], dsa[BQ2 / 16][4];
#pragma unroll
      for (int j = 0; j < BQ2 / 8; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + 2 * t + (e & 1);
          const int key = e < 2 ? key0 : key1;
          float w = exp2f(st[j][e] * sl2 - lse_s[ql]);
          if (key >= a.Tk || (a.causal && q0 + ql < key)) w = 0.f;
          p[e] = w;
          ds[e] = w * (dpt[j][e] - delta_s[ql]) * sc;
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dv += P^T dO, dk += dS^T Q
#pragma unroll
      for (int kk = 0; kk < BQ2 / 16; ++kk) {
#pragma unroll
        for (int nt = 0; nt < D / 16; ++nt) {
          uint32_t ob[4], qb[4];
          load_b_kn<LD>(ob, dOs, kk * 16, nt * 16, lane);
          load_b_kn<LD>(qb, Qs, kk * 16, nt * 16, lane);
          mma16816(dv[2 * nt], pa[kk], ob[0], ob[1]);
          mma16816(dv[2 * nt + 1], pa[kk], ob[2], ob[3]);
          mma16816(dk[2 * nt], dsa[kk], qb[0], qb[1]);
          mma16816(dk[2 * nt + 1], dsa[kk], qb[2], qb[3]);
        }
      }
    }
  }

  bf* dkp = at_mut<bf>(a.dk, a, DK, b, hk);
  bf* dvp = at_mut<bf>(a.dv, a, DV, b, hk);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (key0 < a.Tk) {
      *reinterpret_cast<uint32_t*>(dkp + key0 * a.s[DK][2] + col) =
          pack_bf16(dk[j][0], dk[j][1]);
      *reinterpret_cast<uint32_t*>(dvp + key0 * a.s[DV][2] + col) =
          pack_bf16(dv[j][0], dv[j][1]);
    }
    if (key1 < a.Tk) {
      *reinterpret_cast<uint32_t*>(dkp + key1 * a.s[DK][2] + col) =
          pack_bf16(dk[j][2], dk[j][3]);
      *reinterpret_cast<uint32_t*>(dvp + key1 * a.s[DV][2] + col) =
          pack_bf16(dv[j][2], dv[j][3]);
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------- fp32 --
namespace f32 {

constexpr int NT = 128;   // four warps; thread (r, c) = (tid / 4, tid % 4)
constexpr int BR = 32;    // rows (queries, or keys) a CTA or step

template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int r0, int T) {
  constexpr int VEC = D / 4;
  for (int i = threadIdx.x; i < BR * VEC; i += NT) {
    const int r = i / VEC, c = (i % VEC) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) {
      x = *reinterpret_cast<const float4*>(src + (r0 + r) * st + c);
    }
    float* p = dst + r * (D + 1) + c;
    p[0] = x.x;
    p[1] = x.y;
    p[2] = x.z;
    p[3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* x, const float* y) {
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) s += x[c] * y[c];
  return s;
}

template <int D>
constexpr int dq_smem() {
  return (4 * BR * (D + 1) + BR * (BR + 1)) * 4;
}
template <int D>
constexpr int dkdv_smem() {
  return (4 * BR * (D + 1) + 2 * BR * (BR + 1) + 2 * BR) * 4;
}

template <int D>
__global__ void __launch_bounds__(NT) bwd_dq_fp32(const Args a) {
  constexpr int LD = D + 1, LP = BR + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + BR * LD;
  float* Ks = dOs + BR * LD;
  float* Vs = Ks + BR * LD;
  float* Ds = Vs + BR * LD;   // [BR][LP]: dS

  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int bh = blockIdx.x, b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int row = q0 + r;
  const float* q = at<float>(a.q, a, Q, b, h);
  const float* k = at<float>(a.k, a, K, b, hk);
  const float* v = at<float>(a.v, a, V, b, hk);
  const float* o = at<float>(a.o, a, O, b, h);
  const float* dout = at<float>(a.dout, a, DO, b, h);

  load_tile<D>(Qs, q, a.s[Q][2], q0, a.Tq);
  load_tile<D>(dOs, dout, a.s[DO][2], q0, a.Tq);
  // delta: a row's four threads each a quarter of d (every fourth
  // column), added in a fixed order
  float delta = 0.f;
  if (row < a.Tq) {
    for (int cc = c; cc < D; cc += 4) {
      delta += dout[row * a.s[DO][2] + cc] * o[row * a.s[O][2] + cc];
    }
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta += __shfl_xor_sync(0xffffffffu, delta, 2);
  if (c == 0 && row < a.Tq) {
    a.delta[static_cast<long long>(bh) * a.Tq + row] = delta;
  }
  const float lse = row_lse(a, bh, row, false);

  float dq[D / 4];
#pragma unroll
  for (int m = 0; m < D / 4; ++m) dq[m] = 0.f;
  const int kend = a.causal ? min(a.Tk, min(a.Tq, q0 + BR)) : a.Tk;
#pragma unroll 1
  for (int k0 = 0; k0 < kend; k0 += BR) {
    __syncthreads();
    load_tile<D>(Ks, k, a.s[K][2], k0, a.Tk);
    load_tile<D>(Vs, v, a.s[V][2], k0, a.Tk);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < BR / 4; ++j) {
      const int kl = c + 4 * j, key = k0 + kl;
      const float s = dot<D>(Qs + r * LD, Ks + kl * LD);
      const float dp = dot<D>(dOs + r * LD, Vs + kl * LD);
      float p = expf(s * a.scale - lse);
      if (key >= a.Tk || (a.causal && key > row)) p = 0.f;
      Ds[r * LP + kl] = p * (dp - delta) * a.scale;
    }
    __syncthreads();
#pragma unroll 2
    for (int kl = 0; kl < BR; ++kl) {
      const float ds = Ds[r * LP + kl];
#pragma unroll
      for (int m = 0; m < D / 4; ++m) dq[m] += ds * Ks[kl * LD + c + 4 * m];
    }
  }
  if (row < a.Tq) {
    float* dqp = at_mut<float>(a.dq, a, DQ, b, h) + row * a.s[DQ][2];
#pragma unroll
    for (int m = 0; m < D / 4; ++m) dqp[c + 4 * m] = dq[m];
  }
}

template <int D>
__global__ void __launch_bounds__(NT) bwd_dkdv_fp32(const Args a) {
  constexpr int LD = D + 1, LP = BR + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BR * LD;
  float* Qs = Vs + BR * LD;
  float* dOs = Qs + BR * LD;
  float* Ps = dOs + BR * LD;   // [BR keys][LP]: P^T
  float* Ds = Ps + BR * LP;    // [BR keys][LP]: dS^T
  float* lse_s = Ds + BR * LP;
  float* delta_s = lse_s + BR;

  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const int k0 = blockIdx.y * BR, key = k0 + r;
  load_tile<D>(Ks, at<float>(a.k, a, K, b, hk), a.s[K][2], k0, a.Tk);
  load_tile<D>(Vs, at<float>(a.v, a, V, b, hk), a.s[V][2], k0, a.Tk);

  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int m = 0; m < D / 4; ++m) dk[m] = dv[m] = 0.f;
  const int q_start = a.causal ? k0 : 0;
#pragma unroll 1
  for (int h = hk * a.group; h < (hk + 1) * a.group; ++h) {
    const int bh = b * a.Hq + h;
    const float* q = at<float>(a.q, a, Q, b, h);
    const float* dout = at<float>(a.dout, a, DO, b, h);
#pragma unroll 1
    for (int q0 = q_start; q0 < a.Tq; q0 += BR) {
      __syncthreads();
      load_tile<D>(Qs, q, a.s[Q][2], q0, a.Tq);
      load_tile<D>(dOs, dout, a.s[DO][2], q0, a.Tq);
      if (tid < BR) {
        const int qrow = q0 + tid;
        lse_s[tid] = row_lse(a, bh, qrow, false);
        delta_s[tid] =
            qrow < a.Tq ? a.delta[static_cast<long long>(bh) * a.Tq + qrow]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < BR / 4; ++j) {
        const int ql = c + 4 * j;
        const float s = dot<D>(Ks + r * LD, Qs + ql * LD);
        const float dp = dot<D>(Vs + r * LD, dOs + ql * LD);
        float p = expf(s * a.scale - lse_s[ql]);
        if (key >= a.Tk || (a.causal && q0 + ql < key)) p = 0.f;
        Ps[r * LP + ql] = p;
        Ds[r * LP + ql] = p * (dp - delta_s[ql]) * a.scale;
      }
      __syncthreads();
#pragma unroll 2
      for (int ql = 0; ql < BR; ++ql) {
        const float p = Ps[r * LP + ql], ds = Ds[r * LP + ql];
#pragma unroll
        for (int m = 0; m < D / 4; ++m) {
          dv[m] += p * dOs[ql * LD + c + 4 * m];
          dk[m] += ds * Qs[ql * LD + c + 4 * m];
        }
      }
    }
  }
  if (key < a.Tk) {
    float* dkp = at_mut<float>(a.dk, a, DK, b, hk) + key * a.s[DK][2];
    float* dvp = at_mut<float>(a.dv, a, DV, b, hk) + key * a.s[DV][2];
#pragma unroll
    for (int m = 0; m < D / 4; ++m) {
      dkp[c + 4 * m] = dk[m];
      dvp[c + 4 * m] = dv[m];
    }
  }
}

}  // namespace f32

template <typename Kern>
cudaError_t launch_one(Kern kern, dim3 grid, int threads, int smem,
                       const Args& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int D>
int launch(const Args& a, int B, int bf16, cudaStream_t s) {
  // the dq kernel (and delta) first, then dk and dv, on one stream
  const dim3 dq_grid(B * a.Hq, (a.Tq + (bf16 ? tc::BQ : f32::BR) - 1) /
                                   (bf16 ? tc::BQ : f32::BR));
  const dim3 kv_grid(B * a.Hkv, (a.Tk + (bf16 ? tc::BK : f32::BR) - 1) /
                                    (bf16 ? tc::BK : f32::BR));
  cudaError_t err =
      bf16 ? launch_one(tc::bwd_dq_bf16<D>, dq_grid, tc::NT,
                        tc::dq_smem<D>(), a, s)
           : launch_one(f32::bwd_dq_fp32<D>, dq_grid, f32::NT,
                        f32::dq_smem<D>(), a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bf16 ? launch_one(tc::bwd_dkdv_bf16<D>, kv_grid, tc::NT,
                          tc::dkdv_smem<D>(), a, s)
             : launch_one(f32::bwd_dkdv_fp32<D>, kv_grid, f32::NT,
                          f32::dkdv_smem<D>(), a, s);
  return static_cast<int>(err);
}

}  // namespace

// q (B, Hq, Tq, d), k and v (B, Hkv, Tk, d), o and do (B, Hq, Tq, d), lse
// (B, Hq, Tq) fp32 contiguous; delta a (B, Hq, Tq) fp32 workspace; dq, dk,
// dv shaped as q, k, v.  strides: 24 element strides, (b, h, t) of q, k, v,
// o, do, dq, dk, dv in that order, each tensor's d stride 1.  bf16 != 0
// for bf16 tensors, else fp32; d in {16, 32, 64, 128}.  Two kernels on
// ``stream``: dq (and delta), then dk and dv.  Returns the launch error, if
// any (cudaErrorInvalidValue for arguments out of range).
extern "C" int flash_attn_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Tq, int Tk, int d,
    const long long* strides, int causal, int bf16, void* stream) {
  // grids: (B * H, row tiles); the y axis holds at most 65535 tiles
  if (B < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Tq < 0 || Tk < 1 ||
      static_cast<long long>(B) * Hq >= (1LL << 31) ||
      (Tq + 31) / 32 > 65535 || (Tk + 31) / 32 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Tq == 0) return 0;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.Tq = Tq;
  a.Tk = Tk;
  a.causal = causal ? 1 : 0;
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < 3; ++j) a.s[i][j] = strides[3 * i + j];
  }
  a.scale = 1.0f / sqrtf(static_cast<float>(d));
  a.scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(d)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(a, B, bf16, s);
    case 32: return launch<32>(a, B, bf16, s);
    case 64: return launch<64>(a, B, bf16, s);
    case 128: return launch<128>(a, B, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
