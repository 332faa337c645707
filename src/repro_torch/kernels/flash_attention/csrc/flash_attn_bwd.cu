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
// becomes kernels that own what they write, with no atomics, and two runs
// give the same bits.
//
// Bound on the H100 at GLM-4 9B's training microbatch (B 2, Hq 32, Hkv 2,
// T 4096, d 128, causal, bf16): five products of 2 d operations a causal
// pair (S, dP, dV, dK, dQ), 5 * 2 d * T(T+1)/2 * B * Hq ~ 687 GFLOP: 0.695
// ms at 989 TFLOP/s bf16, against ~285 MB read and written once (0.085 ms
// at 3.35 TB/s).  The tensor cores bound it, and only wgmma reaches their
// rate.
//
// bf16 inputs: four kernels on one stream, all on the Hopper pattern of
// the forward (flash_attn.cu; the shared pieces are in hopper.cuh):
//
//   prep     one thread group a row: delta = rowsum(do * o) and the row's
//            lse in base 2, both into a workspace padded to 128 rows; a
//            row past Tq or one that saw no key (its lse the reference's
//            finite NEG_INF = -1e30) gets lse +inf, so its weights
//            exp2(s - lse) are exactly 0, not exp of a rounding residual.
//   dk/dv    one CTA a (b, KV head, 64-key tile, chunk of the group's
//            query heads), the tiles that see the most queries first.  A
//            producer warpgroup gives its registers away (setmaxnreg) and
//            one thread loads the CTA's K and V once, then streams the
//            chunk's heads' Q and dO tiles of 64 queries by TMA, with each
//            tile's lse and delta rows by 1-D bulk copies, through an
//            mbarrier ring.  Two consumer warpgroups take the 64 keys in two
//            roles: one computes S^T = K Q^T on wgmma m64n64 (both operands
//            in shared memory), P^T in registers (masked only on tiles that
//            cross the diagonal), hands P^T to the other through shared
//            memory (a named barrier a stage), and runs dV += P^T dO with
//            P^T packed to bf16 A fragments and dO read as it lies
//            ([query][d], the transpose bit); the other computes dP^T = V
//            dO^T, dS^T from the P^T it is handed, and dK += dS^T Q.  Each
//            holds one 64 x d accumulator: both dK and dV beside S^T and
//            dP^T need ~200 registers a thread at d 128, where ptxas gives
//            the consumers 168, the launch's share (both in each warpgroup
//            spill 440 bytes a thread).
//   reduce   where the group is split into chunks (enough CTAs for about
//            four an SM), the dk/dv kernel writes fp32 partials, and this
//            pass adds them in chunk order and writes dk and dv: a fixed
//            order, so deterministic.
//            (At GLM-4's microbatch, 3 chunks of 6, 6 and 4 heads: 50 MB
//            written and read again, ~0.03 ms of bytes.)  A group of one
//            chunk writes dk and dv directly.
//   dq       one CTA a (b, query head, 128-query tile), the last (longest
//            causal) tiles first; the forward's shape with dO beside Q: Q
//            and dO loaded once, K and V tiles of 64 keys through the ring,
//            S = Q K^T and dP = dO V^T on wgmma m64n64 from shared memory,
//            dS in registers, dQ += dS K with K read as it lies.
//
// dq has its own kernel, so S and dP are computed twice: seven products,
// not five (0.97 ms of tensor work at GLM-4's microbatch instead of
// 0.695).  The other way, fp32 dq sums in the dk/dv kernel with the adds
// to each query tile serialised in key-tile order, saves two products but
// makes every CTA wait on the one before it for each query tile and moves
// a (B Hq Tq d) fp32 sum through L2 once a key tile (~17 GB at GLM-4's
// microbatch, some 5 ms at L2's rate), where this way moves nothing
// between kernels but delta and lse.
//
// fp32 inputs (the 2-layer fp32 cuts that hold the card against the CPU):
// as before, the same two loops on the CUDA cores in fp32 (the bf16 tensor
// cores would break the fp32 contract), 32 x 32 tiles, each thread one row
// and a quarter of the columns; the dq kernel's prologue writes delta.
//
// Tensors are addressed by strides with a unit stride on d; every other
// stride is a multiple of 16 bytes and the bases 16-byte aligned (the
// wrapper checks, and copies do once where it is not so), as TMA needs.
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // (B, Hq, Tq), natural log
  float* delta;        // fp32 path: (B, Hq, Tq), written by the dq kernel
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
namespace hb {

using bf = __nv_bfloat16;

constexpr int NT = 384;              // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40;    // setmaxnreg: 128 x 40 + 256 x 232
constexpr int CONSUMER_REGS = 232;   // = 384 x 168, the launch's share
constexpr int BQ = 128;      // dq kernel: query rows a CTA
constexpr int BKQ = 64;      // dq kernel: keys a step
constexpr int BKV = 64;      // dk/dv kernel: keys a CTA
constexpr int BQS = 64;      // dk/dv kernel: queries a step
constexpr int STAGES = 3;    // ring depth, both kernels
constexpr int ROWS = 128;    // lse and delta rows padded to a multiple
constexpr int BOX = 64;      // rows a TMA box
static_assert(BQ == 2 * BOX && BKV == BOX && BKQ == BOX && BQS == BOX,
              "tiles are one or two TMA boxes of rows");

struct HArgs {
  int B;
  int Tqp, Tkp;        // rows of the lse / delta workspace, of the partials
  int nq;              // dq kernel: query tiles a head
  int nkt;             // dk/dv kernel: key tiles
  int nch, hs;         // dk/dv kernel: chunks a group, heads a chunk
  const float* lse2;   // (B Hq, Tqp): lse in base 2, +inf where no weight
  const float* delta;  // (B Hq, Tqp)
  float* part;         // (2, nch, B Hkv, Tkp, d) fp32 partials of dk, dv
};

// The swizzled panel layout of a width-D tile (hopper.cuh).
template <int D>
struct Geo {
  static constexpr int PC = D < 64 ? D : 64;   // bf16 columns a panel row
  static constexpr int NP = D / PC;            // panels
  static constexpr int ROWB = PC * 2;          // bytes a panel row
  static constexpr int MODE = ROWB == 128 ? 1 : (ROWB == 64 ? 2 : 3);
  static constexpr uint32_t HI = desc_hi(8 * ROWB, MODE);
};

__host__ __device__ constexpr int dq_smem(int d) {
  return (2 * BQ + 2 * STAGES * BKQ) * d * 2 + 1024 + (1 + 2 * STAGES) * 8;
}
__host__ __device__ constexpr int dkdv_smem(int d) {
  return (2 * BKV + 2 * STAGES * BQS) * d * 2 + STAGES * BQS / 2 * 128 * 4 +
         2 * STAGES * BQS * 4 + 1024 + (1 + 2 * STAGES) * 8;
}

// delta and the base-2 lse of rows 0 .. Tqp - 1 of every head: D / 8
// threads a row, 8 columns (16 bytes of o and of do) each, their sums
// added by shuffles in a fixed order.
template <int D>
__global__ void __launch_bounds__(256)
    bwd_prep_bf16(const Args a, const HArgs h, float* lse2, float* delta) {
  constexpr int TPR = D / 8, RPB = 256 / TPR;
  const int bh = blockIdx.y, b = bh / a.Hq, hq = bh % a.Hq;
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  const int c = (threadIdx.x % TPR) * 8;
  float sum = 0.f;
  if (row < a.Tq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        at<bf>(a.o, a, O, b, hq) + row * a.s[O][2] + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        at<bf>(a.dout, a, DO, b, hq) + row * a.s[DO][2] + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(o2[i]);
      const float2 y = __bfloat1622float2(g2[i]);
      sum += x.x * y.x;
      sum += x.y * y.y;
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (threadIdx.x % TPR == 0 && row < h.Tqp) {
    const long long i = static_cast<long long>(bh) * h.Tqp + row;
    lse2[i] = row_lse(a, bh, row, true);
    delta[i] = row < a.Tq ? sum : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    bwd_dq_hopper(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo, const Args a,
                  const HArgs h) {
  using G = Geo<D>;
  constexpr int PC = G::PC, NP = G::NP, ROWB = G::ROWB;
  constexpr uint32_t HI = G::HI;
  constexpr uint32_t KV_TILE = BKQ * D * 2;      // bytes of a K or V tile
  constexpr uint32_t STAGE16 = KV_TILE >> 4;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf* Qs = reinterpret_cast<bf*>(base);      // [NP][BQ][PC]
  bf* dOs = Qs + BQ * D;                     // [NP][BQ][PC]
  bf* Ks = dOs + BQ * D;                     // [STAGES][NP][BKQ][PC]
  bf* Vs = Ks + STAGES * BKQ * D;            // [STAGES][NP][BKQ][PC]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * BKQ * D);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + STAGES;

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7),
                             0);
  const int heads = h.B * a.Hq, bh = blockIdx.x % heads;
  const int b = bh / a.Hq, hq = bh % a.Hq, hk = hq / a.group;
  const int q0 = (h.nq - 1 - static_cast<int>(blockIdx.x) / heads) * BQ;
  const int kend = a.causal ? min(a.Tk, min(a.Tq, q0 + BQ)) : a.Tk;
  const int n = (kend + BKQ - 1) / BKQ;   // key tiles, visited last first

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kv_full + s, 1);
      mbar_init(kv_empty + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     PRODUCER_REGS));
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&tdo);
      mbar_expect_tx(q_full, 2 * BQ * D * 2);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int half = 0; half < BQ / BOX; ++half) {
          const int off = (p * BQ + half * BOX) * PC;
          tma_load(Qs + off, &tq, q_full, p * PC, q0 + half * BOX, hq, b);
          tma_load(dOs + off, &tdo, q_full, p * PC, q0 + half * BOX, hq, b);
        }
      }
#pragma unroll 1
      for (int it = 0; it < n; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = (n - 1 - it) * BKQ;
        mbar_wait(kv_empty + s, ph ^ 1);
        mbar_expect_tx(kv_full + s, 2 * KV_TILE);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int off = (s * NP + p) * BKQ * PC;
          tma_load(Ks + off, &tk, kv_full + s, p * PC, k0, hk, b);
          tma_load(Vs + off, &tv, kv_full + s, p * PC, k0, hk, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     CONSUMER_REGS));
    const int cw = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int rmin = q0 + cw * 64;
    const int row0 = rmin + warp * 16 + g, row1 = row0 + 8;
    const long long ri = static_cast<long long>(bh) * h.Tqp;
    const float l0 = h.lse2[ri + row0], l1 = h.lse2[ri + row1];
    const float d0 = h.delta[ri + row0], d1 = h.delta[ri + row1];
    const float sl2 = a.scale_log2, sc = a.scale;

    float sacc[BKQ / 2], pacc[BKQ / 2], dq[D / 2];
    uint32_t dsa[BKQ / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    // descriptors, stage 0: this warpgroup's Q and dO rows (A, K-major);
    // K and V (B, K-major) for S and dP; K again (B, MN-major: leading
    // byte offset one panel) for dQ += dS K
    const uint32_t q_lo = desc_lo(smem_u32(Qs + cw * 64 * PC), 16);
    const uint32_t o_lo = desc_lo(smem_u32(dOs + cw * 64 * PC), 16);
    const uint32_t k_lo = desc_lo(smem_u32(Ks), 16);
    const uint32_t v_lo = desc_lo(smem_u32(Vs), 16);
    const uint32_t kt_lo = desc_lo(smem_u32(Ks), BKQ * ROWB);

    mbar_wait(q_full, 0);
#pragma unroll 1
    for (int it = 0; it < n; ++it) {
      const int s = it % STAGES;
      const int k0 = (n - 1 - it) * BKQ;
      mbar_wait(kv_full + s, (it / STAGES) & 1);
      wgmma_fence();
      {
        const uint32_t qd = opaque(q_lo), od = opaque(o_lo);
        const uint32_t kd = opaque(k_lo + s * STAGE16);
        const uint32_t vd = opaque(v_lo + s * STAGE16);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const int p = ks * 16 / PC, c = ks * 16 % PC;
          const uint32_t ao = (p * BQ * ROWB + c * 2) / 16;
          const uint32_t bo = (p * BKQ * ROWB + c * 2) / 16;
          if (ks == 0) {
            wgmma_ss_n64<true>(sacc, desc(qd + ao, HI), desc(kd + bo, HI));
            wgmma_ss_n64<true>(pacc, desc(od + ao, HI), desc(vd + bo, HI));
          } else {
            wgmma_ss_n64<false>(sacc, desc(qd + ao, HI), desc(kd + bo, HI));
            wgmma_ss_n64<false>(pacc, desc(od + ao, HI), desc(vd + bo, HI));
          }
        }
      }
      wgmma_commit();
      wgmma_wait0();
      pin<BKQ / 2>(sacc);
      pin<BKQ / 2>(pacc);
      // dS = P (dP - delta) / sqrt(d); keys past Tk and, causal, after the
      // row are masked on the tiles that hold any
      const bool edge =
          k0 + BKQ > a.Tk || (a.causal && k0 + BKQ - 1 > rmin);
#pragma unroll
      for (int j = 0; j < BKQ / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_ftz(fmaf(sacc[4 * j + e], sl2, -(e < 2 ? l0 : l1)));
          if (edge) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= a.Tk || (a.causal && col > row)) p = 0.f;
          }
          ds[e] = p * (pacc[4 * j + e] - (e < 2 ? d0 : d1)) * sc;
        }
        dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
      {
        const uint32_t td = opaque(kt_lo + s * STAGE16);
#pragma unroll
        for (int kk = 0; kk < BKQ / 16; ++kk) {
          wgmma_rs<D>(dq, dsa[kk], desc(td + kk * 16 * ROWB / 16, HI));
        }
      }
      wgmma_commit();
      wgmma_wait0();
      pin<D / 2>(dq);
      release(kv_empty + s, lane);
    }

    bf* dqp = at_mut<bf>(a.dq, a, DQ, b, hq);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (row0 < a.Tq) {
        *reinterpret_cast<uint32_t*>(dqp + row0 * a.s[DQ][2] + col) =
            pack_bf16(dq[4 * j], dq[4 * j + 1]);
      }
      if (row1 < a.Tq) {
        *reinterpret_cast<uint32_t*>(dqp + row1 * a.s[DQ][2] + col) =
            pack_bf16(dq[4 * j + 2], dq[4 * j + 3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    bwd_dkdv_hopper(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const Args a,
                    const HArgs h) {
  using G = Geo<D>;
  constexpr int PC = G::PC, NP = G::NP, ROWB = G::ROWB;
  constexpr uint32_t HI = G::HI;
  constexpr uint32_t QT = BQS * D * 2;    // bytes of a Q or dO tile
  constexpr uint32_t STAGE16 = QT >> 4;
  constexpr int MAIL = BQS / 8;           // float4s of P a thread a step

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf* Ks = reinterpret_cast<bf*>(base);      // [NP][BKV][PC]
  bf* Vs = Ks + BKV * D;                     // [NP][BKV][PC]
  bf* Qs = Vs + BKV * D;                     // [STAGES][NP][BQS][PC]
  bf* dOs = Qs + STAGES * BQS * D;           // [STAGES][NP][BQS][PC]
  // P^T from the P warpgroup to the dS warpgroup: [STAGES][MAIL][128]
  float4* mail = reinterpret_cast<float4*>(dOs + STAGES * BQS * D);
  float* ls = reinterpret_cast<float*>(mail + STAGES * MAIL * 128);  // lse2
  float* dls = ls + STAGES * BQS;                                    // delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dls + STAGES * BQS);
  uint64_t* st_full = kv_full + 1;
  uint64_t* st_empty = st_full + STAGES;

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7),
                             0);
  // CTA: key tile (first: the ones that see the most queries), then (b,
  // KV head), then the chunk of the group's query heads
  const int per = h.B * a.Hkv * h.nch;
  const int kt = blockIdx.x / per, rest = blockIdx.x % per;
  const int ch = rest % h.nch, bhk = rest / h.nch;
  const int b = bhk / a.Hkv, hk = bhk % a.Hkv;
  const int k0 = kt * BKV;
  const int h0 = hk * a.group + ch * h.hs;
  const int h1 = min((hk + 1) * a.group, h0 + h.hs);
  // causal: query i sees key j when i >= j, so no query tile before the
  // one holding row k0 sees this key tile
  const int qs0 = a.causal ? (k0 / BQS) * BQS : 0;
  const int nqt = qs0 < a.Tq ? (a.Tq - qs0 + BQS - 1) / BQS : 0;
  const int steps = (h1 - h0) * nqt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(st_full + s, 1);
      mbar_init(st_empty + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     PRODUCER_REGS));
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&tdo);
      mbar_expect_tx(kv_full, 2 * BKV * D * 2);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load(Ks + p * BKV * PC, &tk, kv_full, p * PC, k0, hk, b);
        tma_load(Vs + p * BKV * PC, &tv, kv_full, p * PC, k0, hk, b);
      }
#pragma unroll 1
      for (int i = 0; i < steps; ++i) {
        const int s = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        const int hq = h0 + i / nqt, q0 = qs0 + (i % nqt) * BQS;
        mbar_wait(st_empty + s, ph ^ 1);
        mbar_expect_tx(st_full + s, 2 * QT + 2 * BQS * 4);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int off = (s * NP + p) * BQS * PC;
          tma_load(Qs + off, &tq, st_full + s, p * PC, q0, hq, b);
          tma_load(dOs + off, &tdo, st_full + s, p * PC, q0, hq, b);
        }
        const long long ro =
            static_cast<long long>(b * a.Hq + hq) * h.Tqp + q0;
        bulk_load(ls + s * BQS, h.lse2 + ro, BQS * 4, st_full + s);
        bulk_load(dls + s * BQS, h.delta + ro, BQS * 4, st_full + s);
      }
    }
  } else {
    // ------------------------------------------------------- consumers --
    // Both warpgroups take the CTA's 64 keys, in two roles: the P one
    // computes S^T = K Q^T, P^T, hands P^T over, then dV += P^T dO; the dS
    // one computes dP^T = V dO^T, takes P^T, then dS^T and dK += dS^T Q.
    // Two products each a step, and each keeps one 64 x d accumulator (a
    // warpgroup holding both dK and dV beside S^T and dP^T would need ~200
    // registers a thread at d 128, past the 168 the launch gives).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     CONSUMER_REGS));
    const int cw = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
    const float sl2 = a.scale_log2, sc = a.scale;
    const bool p_role = cw == 0;

    float sacc[BQS / 2], acc[D / 2];
    uint32_t fr[BQS / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // descriptors, stage 0: K or V (A, K-major); Q or dO (B, K-major) for
    // S^T or dP^T; dO or Q (B, MN-major: leading byte offset one panel)
    // for dV += P^T dO or dK += dS^T Q
    const uint32_t a_lo = desc_lo(smem_u32(p_role ? Ks : Vs), 16);
    const uint32_t b_lo = desc_lo(smem_u32(p_role ? Qs : dOs), 16);
    const uint32_t bt_lo = desc_lo(smem_u32(p_role ? dOs : Qs), BQS * ROWB);

    mbar_wait(kv_full, 0);
#pragma unroll 1
    for (int i = 0; i < steps; ++i) {
      const int s = i % STAGES;
      const int q0 = qs0 + (i % nqt) * BQS;
      mbar_wait(st_full + s, (i / STAGES) & 1);
      wgmma_fence();
      {
        const uint32_t ad = opaque(a_lo), bd = opaque(b_lo + s * STAGE16);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const int p = ks * 16 / PC, c = ks * 16 % PC;
          const uint32_t ao = (p * BKV * ROWB + c * 2) / 16;
          const uint32_t bo = (p * BQS * ROWB + c * 2) / 16;
          if (ks == 0) {
            wgmma_ss_n64<true>(sacc, desc(ad + ao, HI), desc(bd + bo, HI));
          } else {
            wgmma_ss_n64<false>(sacc, desc(ad + ao, HI), desc(bd + bo, HI));
          }
        }
      }
      wgmma_commit();
      wgmma_wait0();
      pin<BQS / 2>(sacc);
      float4* box = mail + s * MAIL * 128 + tid;
      if (p_role) {
        // P^T: rows keys, columns queries, a query's lse from the stage;
        // causal, a query before the key is masked on the tiles that hold
        // any
        const float* lr = ls + s * BQS;
        const bool edge = a.causal && q0 < k0 + BKV;
#pragma unroll
        for (int j = 0; j < BQS / 8; ++j) {
          const int qc = j * 8 + 2 * t;
          const float2 lq = *reinterpret_cast<const float2*>(lr + qc);
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float w = exp2_ftz(fmaf(sacc[4 * j + e], sl2,
                                    -((e & 1) ? lq.y : lq.x)));
            if (edge && q0 + qc + (e & 1) < (e < 2 ? key0 : key1)) w = 0.f;
            p[e] = w;
          }
          box[j * 128] = make_float4(p[0], p[1], p[2], p[3]);
          fr[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
          fr[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        }
        asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + s) : "memory");
      } else {
        // dS^T = P^T (dP^T - delta) / sqrt(d), P^T from the P warpgroup
        const float* dr = dls + s * BQS;
        named_sync(1 + s, 256);
#pragma unroll
        for (int j = 0; j < BQS / 8; ++j) {
          const int qc = j * 8 + 2 * t;
          const float2 dq2 = *reinterpret_cast<const float2*>(dr + qc);
          const float4 p = box[j * 128];
          const float ds0 = p.x * (sacc[4 * j] - dq2.x) * sc;
          const float ds1 = p.y * (sacc[4 * j + 1] - dq2.y) * sc;
          const float ds2 = p.z * (sacc[4 * j + 2] - dq2.x) * sc;
          const float ds3 = p.w * (sacc[4 * j + 3] - dq2.y) * sc;
          fr[j >> 1][(j & 1) * 2] = pack_bf16(ds0, ds1);
          fr[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds2, ds3);
        }
      }
      wgmma_fence();
      {
        const uint32_t btd = opaque(bt_lo + s * STAGE16);
#pragma unroll
        for (int kk = 0; kk < BQS / 16; ++kk) {
          wgmma_rs<D>(acc, fr[kk], desc(btd + kk * 16 * ROWB / 16, HI));
        }
      }
      wgmma_commit();
      wgmma_wait0();
      pin<D / 2>(acc);
      release(st_empty + s, lane);
    }

    // dV from the P warpgroup, dK from the dS one
    if (h.nch == 1) {
      bf* dst = p_role ? at_mut<bf>(a.dv, a, DV, b, hk)
                       : at_mut<bf>(a.dk, a, DK, b, hk);
      const long long st = p_role ? a.s[DV][2] : a.s[DK][2];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (key0 < a.Tk) {
          *reinterpret_cast<uint32_t*>(dst + key0 * st + col) =
              pack_bf16(acc[4 * j], acc[4 * j + 1]);
        }
        if (key1 < a.Tk) {
          *reinterpret_cast<uint32_t*>(dst + key1 * st + col) =
              pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    } else {
      // partials (2, nch, B Hkv, Tkp, d): dk first, then dv
      const long long bhkv = static_cast<long long>(h.B) * a.Hkv;
      float* dst = h.part + (((p_role ? h.nch : 0) + ch) * bhkv + bhk) *
                                static_cast<long long>(h.Tkp) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + 2 * t;
        *reinterpret_cast<float2*>(dst + key0 * D + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(dst + key1 * D + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// dk and dv of every key: the chunks' partials added in chunk order, four
// columns a thread.
template <int D>
__global__ void __launch_bounds__(256)
    bwd_dkdv_reduce(const Args a, const HArgs h) {
  constexpr int V4 = D / 4;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long bhkv = static_cast<long long>(h.B) * a.Hkv;
  if (idx >= bhkv * a.Tk * V4) return;
  const int c = static_cast<int>(idx % V4) * 4;
  const long long r = idx / V4;
  const int key = static_cast<int>(r % a.Tk);
  const int bhk = static_cast<int>(r / a.Tk);
  const int b = bhk / a.Hkv, hk = bhk % a.Hkv;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ch = 0; ch < h.nch; ++ch) {
      const float4 x = *reinterpret_cast<const float4*>(
          h.part + (((static_cast<long long>(which) * h.nch + ch) * bhkv +
                     bhk) * h.Tkp + key) * D + c);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    bf* dst = which ? at_mut<bf>(a.dv, a, DV, b, hk) + key * a.s[DV][2]
                    : at_mut<bf>(a.dk, a, DK, b, hk) + key * a.s[DK][2];
    uint2 packed;
    packed.x = pack_bf16(acc.x, acc.y);
    packed.y = pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>(dst + c) = packed;
  }
}

}  // namespace hb

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
int launch_fp32(const Args& a, int B, cudaStream_t s) {
  // the dq kernel (and delta) first, then dk and dv, on one stream
  const dim3 dq_grid(B * a.Hq, (a.Tq + f32::BR - 1) / f32::BR);
  const dim3 kv_grid(B * a.Hkv, (a.Tk + f32::BR - 1) / f32::BR);
  cudaError_t err = launch_one(f32::bwd_dq_fp32<D>, dq_grid, f32::NT,
                               f32::dq_smem<D>(), a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_one(f32::bwd_dkdv_fp32<D>, kv_grid, f32::NT,
                                     f32::dkdv_smem<D>(), a, s));
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return sms;
}

long long round_up(long long x, long long m) { return (x + m - 1) / m * m; }

// The bf16 kernels' shape: padded rows, tiles, and the split of each
// group's query heads into chunks, enough dk/dv CTAs for about four an SM
// (and at most a chunk a head).  ``bytes`` the workspace: lse2 and delta,
// then the partials where a group has more than one chunk.
struct Plan {
  hb::HArgs h;
  long long off_delta, off_part, bytes;
};

Plan plan_bf16(int B, int Hq, int Hkv, int Tq, int Tk, int d) {
  Plan p{};
  const int group = Hq / Hkv;
  p.h.B = B;
  p.h.nq = (Tq + hb::BQ - 1) / hb::BQ;
  p.h.nkt = (Tk + hb::BKV - 1) / hb::BKV;
  p.h.Tqp = static_cast<int>(round_up(Tq, hb::ROWS));
  p.h.Tkp = p.h.nkt * hb::BKV;
  const long long base = static_cast<long long>(B) * Hkv * p.h.nkt;
  long long want = (4LL * sm_count() + base - 1) / base;
  want = want < 1 ? 1 : (want > group ? group : want);
  p.h.hs = static_cast<int>((group + want - 1) / want);
  p.h.nch = (group + p.h.hs - 1) / p.h.hs;
  const long long rows = static_cast<long long>(B) * Hq * p.h.Tqp * 4;
  p.off_delta = round_up(rows, 256);
  p.off_part = p.off_delta + round_up(rows, 256);
  p.bytes = p.off_part + (p.h.nch > 1 ? 2LL * p.h.nch * B * Hkv * p.h.Tkp *
                                            d * 4
                                      : 0);
  return p;
}

template <int D>
int launch_bf16(Args a, int B, unsigned char* ws, cudaStream_t s) {
  constexpr int PC = D < 64 ? D : 64;
  const CUtensorMapSwizzle sw = PC == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : PC == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  Plan p = plan_bf16(B, a.Hq, a.Hkv, a.Tq, a.Tk, D);
  float* lse2 = reinterpret_cast<float*>(ws);
  float* delta = reinterpret_cast<float*>(ws + p.off_delta);
  p.h.lse2 = lse2;
  p.h.delta = delta;
  p.h.part = reinterpret_cast<float*>(ws + p.off_part);
  CUtensorMap mq, mk, mv, mdo;
  if (!tensor_map(&mq, a.q, D, a.Tq, a.Hq, B, a.s[Q][2], a.s[Q][1],
                  a.s[Q][0], PC, hb::BOX, sw) ||
      !tensor_map(&mk, a.k, D, a.Tk, a.Hkv, B, a.s[K][2], a.s[K][1],
                  a.s[K][0], PC, hb::BOX, sw) ||
      !tensor_map(&mv, a.v, D, a.Tk, a.Hkv, B, a.s[V][2], a.s[V][1],
                  a.s[V][0], PC, hb::BOX, sw) ||
      !tensor_map(&mdo, a.dout, D, a.Tq, a.Hq, B, a.s[DO][2], a.s[DO][1],
                  a.s[DO][0], PC, hb::BOX, sw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int RPB = 256 / (D / 8);
  const dim3 prep_grid((p.h.Tqp + RPB - 1) / RPB, B * a.Hq);
  hb::bwd_prep_bf16<D><<<prep_grid, 256, 0, s>>>(a, p.h, lse2, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int kv_smem = hb::dkdv_smem(D);
  err = cudaFuncSetAttribute(hb::bwd_dkdv_hopper<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long kv_ctas =
      static_cast<long long>(p.h.nkt) * B * a.Hkv * p.h.nch;
  hb::bwd_dkdv_hopper<D><<<static_cast<unsigned>(kv_ctas), hb::NT, kv_smem,
                           s>>>(mq, mk, mv, mdo, a, p.h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.h.nch > 1) {
    const long long n = static_cast<long long>(B) * a.Hkv * a.Tk * (D / 4);
    hb::bwd_dkdv_reduce<D><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             s>>>(a, p.h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int dq_smem = hb::dq_smem(D);
  err = cudaFuncSetAttribute(hb::bwd_dq_hopper<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long dq_ctas = static_cast<long long>(B) * a.Hq * p.h.nq;
  hb::bwd_dq_hopper<D><<<static_cast<unsigned>(dq_ctas), hb::NT, dq_smem,
                         s>>>(mq, mk, mv, mdo, a, p.h);
  return static_cast<int>(cudaGetLastError());
}

bool valid_d(int d) { return d == 16 || d == 32 || d == 64 || d == 128; }

}  // namespace

// The workspace one call needs, in bytes: bf16 (bf16 != 0), the rows'
// base-2 lse and delta padded to 128 rows and, where a group's query heads
// are split into chunks (the split depends on the current device's SM
// count), the dk/dv kernel's fp32 partials; fp32, delta (B, Hq, Tq).
// Returns -1 for arguments out of range.
extern "C" long long flash_attn_bwd_workspace(int B, int Hq, int Hkv, int Tq,
                                              int Tk, int d, int bf16) {
  if (B < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Tq < 0 || Tk < 1 ||
      !valid_d(d)) {
    return -1;
  }
  if (!bf16) return static_cast<long long>(B) * Hq * Tq * 4;
  return plan_bf16(B, Hq, Hkv, Tq, Tk, d).bytes;
}

// q (B, Hq, Tq, d), k and v (B, Hkv, Tk, d), o and do (B, Hq, Tq, d), lse
// (B, Hq, Tq) fp32 contiguous; ws a flash_attn_bwd_workspace-sized,
// 256-byte aligned scratch; dq, dk, dv shaped as q, k, v.  strides: 24
// element strides, (b, h, t) of q, k, v, o, do, dq, dk, dv in that order,
// each tensor's d stride 1.  bf16 != 0 for bf16 tensors, else fp32; d in
// {16, 32, 64, 128}.  bf16: four kernels on ``stream`` (prep, dk/dv, the
// partials' sum where there are any, dq); fp32: two (dq and delta, then dk
// and dv).  Returns the launch error, if any (cudaErrorInvalidValue for
// arguments out of range).
extern "C" int flash_attn_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* ws, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Tq, int Tk, int d,
    const long long* strides, int causal, int bf16, void* stream) {
  // fp32 grids: (B * H, row tiles), the y axis at most 65535 tiles; bf16
  // grids: one axis of CTAs
  if (B < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Tq < 0 || Tk < 1 ||
      !valid_d(d) || static_cast<long long>(B) * Hq >= (1LL << 31) ||
      (Tq + 31) / 32 > 65535 || (Tk + 31) / 32 > 65535 ||
      static_cast<long long>(B) * Hq * ((Tq + 127) / 128) >= (1LL << 31) ||
      static_cast<long long>(B) * Hq * ((Tk + 63) / 64) >= (1LL << 31)) {
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
  a.delta = static_cast<float*>(ws);
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
  unsigned char* w = static_cast<unsigned char*>(ws);
  switch (d) {
    case 16: return bf16 ? launch_bf16<16>(a, B, w, s) : launch_fp32<16>(a, B, s);
    case 32: return bf16 ? launch_bf16<32>(a, B, w, s) : launch_fp32<32>(a, B, s);
    case 64: return bf16 ? launch_bf16<64>(a, B, w, s) : launch_fp32<64>(a, B, s);
    default: return bf16 ? launch_bf16<128>(a, B, w, s) : launch_fp32<128>(a, B, s);
  }
}

// The bf16 kernels' shape at head width d, for reports: info[0..7] =
// dynamic shared memory of the dk/dv and the dq kernel, threads a CTA,
// producer and consumer registers a thread (setmaxnreg), keys a dk/dv CTA,
// queries a dq CTA, ring stages.  Returns cudaErrorInvalidValue for
// another d.
extern "C" int flash_attn_bwd_config(int d, int* info) {
  if (!valid_d(d)) return static_cast<int>(cudaErrorInvalidValue);
  info[0] = hb::dkdv_smem(d);
  info[1] = hb::dq_smem(d);
  info[2] = hb::NT;
  info[3] = hb::PRODUCER_REGS;
  info[4] = hb::CONSUMER_REGS;
  info[5] = hb::BKV;
  info[6] = hb::BQ;
  info[7] = hb::STAGES;
  return 0;
}
