// Forward softmax attention with an online softmax (flash attention), GQA,
// an optional causal mask and, with it, an optional sliding window:
//
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / group, j] / sqrt(d))
//                      v[b, h / group, j]
//
// over the keys j < Tk (and j <= i when causal, both counted from 0; and
// i - j < window with a window, the reference's models/attention.py::_mask),
// with the scores, the running max, the denominator and the accumulator in
// fp32; o is written once, in q's dtype.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_kernel (grid
// (B, Hq, Tq / bq, Tk / bk), the key tiles a sequential grid axis with the
// running max, denominator and accumulator in VMEM scratch carried across
// it, fully masked key tiles skipped, keys past kv_len masked after the
// wrapper pads both sequence axes to the tile).  TPU grid steps run in
// order; CTAs here run in no order, so the key tiles become a loop inside
// one CTA, which stops after the last key any of its rows may see (the
// diagonal when causal: the TPU kernel's skip of fully masked tiles), and
// nothing is carried between CTAs.  Masked scores are the reference's
// finite NEG_INF = -1e30, so exp(m_prev - m_new) stays defined.
//
// Bound on the H100 at the glm4 prefill (B 8, Hq 32, Hkv 2, T 1024, d 128,
// causal): 4 d T(T+1)/2 B Hq = 68.8 GFLOP against 142.6 MB read and
// written: 0.0696 ms at 989 TFLOP/s bf16 and 0.0426 ms at 3.35 TB/s, so
// the tensor cores bound it, and only wgmma reaches their rate.
//
// bf16 inputs: flash_hopper<D>, persistent and warp-specialised: one CTA
// of three warpgroups an SM, walking work items (b, h, 128-row query tile)
// w = blockIdx.x, + gridDim.x, ..., the last (largest causal) query tile
// of every head first.
//
//   producer   warpgroup 0 gives its registers away (setmaxnreg) and one
//              thread issues every copy: an item's Q once its last S
//              product is done with the previous Q, and the K and V tiles
//              through a ring of STAGES buffers that runs on across
//              items, each buffer with a full and an empty mbarrier (K and
//              V apart, so S = Q K^T starts while V is in flight).  Copies
//              are TMA loads through 4-D tensor maps over (d, T, H, B) at
//              the tensors' own strides, so strided views are read where
//              they lie and rows past T arrive as zeros (no padding copy,
//              no bounds tests).  So the next item's loads run under this
//              item's products: a CTA's start-up latency is paid once an
//              SM, not once a query tile.
//   consumers  warpgroups 1 and 2 own 64 query rows each: S = Q K^T on
//              wgmma with both operands in shared memory (K-major), the
//              online softmax in registers in base 2 (log2(e) / sqrt(d)
//              folded into one explicit fmaf, then ex2.approx.ftz), the
//              mask applied only on tiles that cross the diagonal or Tk,
//              and O += P V on wgmma with P packed to bf16 from the S
//              accumulator in registers and V read as it lies, [key][d],
//              as an MN-major B operand (the transpose bit): no
//              transposing store.  The two warpgroups take turns issuing
//              products (named barriers), so one's softmax runs under the
//              other's products.  O is normalised, rounded to bf16, staged
//              in shared memory and written by a TMA store, which drops
//              rows past Tq and runs on under the next item.
//
// Keys a tile: 128.  A tile's P V product is issued and waited for before
// the next tile's S = Q K^T: at d = 128 a 64 x 128 fp32 score tile, a P
// and the 64 x 128 accumulator do not fit the consumers' registers all at
// once (issuing the two together spilled 232 bytes and "serialized wgmma
// due to insufficient register resources"; 64-key tiles avoided that but
// ran slower), and one after the other they do, with no spill.
//
// Shared tiles are stored as the TMA swizzle leaves them: rows of
// min(d, 64) bf16 (128, 64 or 32 bytes) in panels, with the 128B, 64B or
// 32B swizzle that matches the row; d = 128 takes two panels.  The wgmma
// descriptors name the same swizzle.  The TMA, mbarrier and wgmma helpers
// are in hopper.cuh, shared with the backward (flash_attn_bwd.cu).
//
// What holds it back (H100, the glm4 prefill, PERF.md): about
// scaled_dot_product_attention's time and ~2x its bound.  Each item pays
// a prologue (its first S product alone) and an epilogue (normalise,
// stage, store) that nothing overlaps, and the causal items are short (4.5
// key tiles on average); K and V are re-read from L2 by every CTA of the
// 16 query heads of a KV head (no cluster multicast).
//
// fp32 inputs: flash_fp32<D>, the same loop on the CUDA cores in fp32, 64
// rows a CTA of 4 warps, each thread a 4 x 8 block of the score tile and 4
// rows x d/8 columns of the output (the products cannot go to the bf16
// tensor cores and keep the fp32 contract).  fp32 training (the 2-layer
// fp32 cuts that hold the card against the CPU) runs it.
//
// Both kernels write each row's log-sum-exp when the launch is given an
// lse tensor: natural-log units, the backward's input (flash_attn_bwd.cu).
// With none, serving runs exactly as before.
//
// The sliding window (Hymba's 4,096; the reference runs it in jnp,
// flash_jnp.py::_blk_mask): a query tile's keys start at its first row's
// window, max(0, q0 - window + 1), rounded down to a key tile, so tiles
// wholly below every row's window are never loaded (the producer's TMA loop
// and the consumers walk the same tiles, item_of); the tiles that cross
// the window's lower edge are masked as the diagonal's are.  A row that
// sees no key (only where Tq > Tk + window - 1) keeps the rule of the
// kernels' padded rows: weights 0, o = 0, lse NEG_INF.  A window of Tq or
// more masks nothing and gives the bits of no window.
//
// Tensors are addressed by strides with a unit stride on d; every other
// stride is a multiple of 16 bytes and the bases 16-byte aligned (the
// wrapper checks), as TMA and the fp32 kernel's 16-byte loads need.
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------- bf16 --
namespace hop {

constexpr int BQ = 128;       // query rows a CTA: two consumer warpgroups
constexpr int BK = 128;       // keys a tile
constexpr int STAGES = 2;     // K and V buffers in the ring
constexpr int NT = 384;       // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40;    // setmaxnreg: 128 x 40 + 256 x 232
constexpr int CONSUMER_REGS = 232;   // = 384 x 168, the launch's share

// Dynamic shared memory at head width d: Q, O's staging tile, the K and V
// rings, the alignment slack (tiles sit on 1024-byte swizzle patterns),
// the barriers.
__host__ __device__ constexpr int smem_bytes(int d) {
  return (2 * BQ + 2 * STAGES * BK) * d * 2 + 1024 +
         (2 + 4 * STAGES) * 8;
}

struct Args {
  int B, Hq, group, Tq, Tk, causal;
  int window;                 // sliding window (causal only), or 0
  int nq;                     // query tiles a head
  float scale_log2;           // log2(e) / sqrt(d)
  float* lse;                 // (B, Hq, Tq) row log-sum-exp, or null
};

// Work item w: head (b, h) and query tile; the last (largest causal) query
// tile of every head first, so the persistent CTAs, which take items w =
// blockIdx.x, + gridDim.x, ..., start on the longest ones.
struct Item {
  int b, h, hk, q0;
  int t0, n;                  // key tiles t0 .. t0 + n - 1, last first
};

__device__ __forceinline__ Item item_of(const Args& a, int w) {
  const int heads = a.B * a.Hq, bh = w % heads;
  Item x;
  x.b = bh / a.Hq;
  x.h = bh % a.Hq;
  x.hk = x.h / a.group;
  x.q0 = (a.nq - 1 - w / heads) * BQ;
  const int kend =
      a.causal ? min(a.Tk, min(a.Tq, x.q0 + BQ)) : a.Tk;
  const int tend = (kend + BK - 1) / BK;
  // the first row's window; a tile whose rows see no key at all still
  // visits its last key tile, masked whole
  x.t0 = a.window > 0 ? min(max(0, x.q0 - a.window + 1) / BK, tend - 1) : 0;
  x.n = tend - x.t0;
  return x;
}


constexpr int TURN = 3;   // named barriers TURN, TURN + 1: whose products

// Accumulator layout of wgmma m64nN (and the A operand from registers):
// warp w of the warpgroup holds rows 16 w + g and 16 w + g + 8 (g = lane /
// 4); register 4 j + e holds column 8 j + 2 (lane % 4) + (e & 1) of row
// 16 w + g + 8 (e >> 1), as mma.sync's m16n8 fragments side by side.
template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_hopper(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to, const Args a) {
  constexpr int PC = D < 64 ? D : 64;   // bf16 columns a panel row
  constexpr int NP = D / PC;            // panels a tile
  constexpr int ROWB = PC * 2;          // bytes a panel row
  constexpr int MODE = ROWB == 128 ? 1 : (ROWB == 64 ? 2 : 3);
  constexpr int SWB = ROWB == 128 ? 3 : (ROWB == 64 ? 2 : 1);
  constexpr uint32_t SBO = 8 * ROWB;    // next 8 rows of a panel
  constexpr uint32_t TILE = BK * D * 2;
  static_assert(BQ == BK, "one box shape serves Q, K and V");
  static_assert(BK == 128, "S = Q K^T is one m64n128 product a step");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(base);  // [NP][BQ][PC]
  __nv_bfloat16* Os = Qs + BQ * D;             // [NP][BQ][PC]
  __nv_bfloat16* Ks = Os + BQ * D;             // [STAGES][NP][BK][PC]
  __nv_bfloat16* Vs = Ks + STAGES * BK * D;    // [STAGES][NP][BK][PC]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * BK * D);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  // The warpgroup, read from lane 0 so the compiler knows it is uniform
  // across the warp (setmaxnreg needs the role branches to be).
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7),
                             0);
  const int items = a.B * a.Hq * a.nq;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, CONSUMER_WARPS);
      mbar_init(v_empty + s, CONSUMER_WARPS);
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
      prefetch_map(&to);
      int kv = 0;   // position in the K/V ring, over every item
#pragma unroll 1
      for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
        const Item x = item_of(a, w);
        mbar_wait(q_empty, (j & 1) ^ 1);   // the last item's S products
        mbar_expect_tx(q_full, BQ * D * 2);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load(Qs + p * BQ * PC, &tq, q_full, p * PC, x.q0, x.h, x.b);
        }
#pragma unroll 1
        for (int it = 0; it < x.n; ++it, ++kv) {
          const int s = kv % STAGES;
          const uint32_t ph = (kv / STAGES) & 1;
          const int k0 = (x.t0 + x.n - 1 - it) * BK;
          mbar_wait(k_empty + s, ph ^ 1);
          mbar_expect_tx(k_full + s, TILE);
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            tma_load(Ks + (s * NP + p) * BK * PC, &tk, k_full + s, p * PC,
                     k0, x.hk, x.b);
          }
          mbar_wait(v_empty + s, ph ^ 1);
          mbar_expect_tx(v_full + s, TILE);
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            tma_load(Vs + (s * NP + p) * BK * PC, &tv, v_full + s, p * PC,
                     k0, x.hk, x.b);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     CONSUMER_REGS));
    const int cw = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const float sl2 = a.scale_log2;

    float sacc[BK / 2], oacc[D / 2];
    uint32_t pa[BK / 16][4];
    float m0, m1, l0, l1;
    int rmin, row0, row1;

    // Descriptors, first tile of each operand: this warpgroup's Q rows; K
    // and V of stage 0 (V's leading byte offset: one panel, the distance
    // between its MN-major atoms of 64 columns).
    constexpr uint32_t HI = desc_hi(SBO, MODE);
    constexpr uint32_t STAGE = TILE >> 4;   // one K or V stage, 16-B units
    const uint32_t q_lo = desc_lo(smem_u32(Qs + cw * 64 * PC), 16);
    const uint32_t k_lo = desc_lo(smem_u32(Ks), 16);
    const uint32_t v_lo = desc_lo(smem_u32(Vs), BK * ROWB);

    // S = Q K^T on stage s: D / 16 products of 16 columns of d.
    auto issue_s = [&](int s) {
      const uint32_t qd = opaque(q_lo), kd = opaque(k_lo + s * STAGE);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int p = ks * 16 / PC, c = ks * 16 % PC;
        const uint64_t da = desc(qd + (p * BQ * ROWB + c * 2) / 16, HI);
        const uint64_t db = desc(kd + (p * BK * ROWB + c * 2) / 16, HI);
        if (ks == 0) {
          wgmma_ss_n128_first(sacc, da, db);
        } else {
          wgmma_ss_n128(sacc, da, db);
        }
      }
    };
    // O += P V on stage s: BK / 16 products of 16 keys.
    auto issue_pv = [&](int s) {
      const uint32_t vd = opaque(v_lo + s * STAGE);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_rs<D>(oacc, pa[kk], desc(vd + kk * 16 * ROWB / 16, HI));
      }
    };
    // Online softmax of the score tile of keys k0 ..: mask (edge tiles
    // only: Tk, the diagonal, the window's lower edge), row max over the
    // quad, rescale, P packed as A fragments.
    auto softmax = [&](int k0) {
      const bool edge = k0 + BK > a.Tk || (a.causal && k0 + BK - 1 > rmin) ||
                        (a.window > 0 && rmin + 63 - k0 >= a.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= a.Tk || (a.causal && col > row) ||
                (a.window > 0 && row - col >= a.window)) {
              sacc[4 * j + e] = NEG_INF;
            }
          }
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // exp(s / sqrt(d) - m / sqrt(d)) = exp2(s * sl2 - m * sl2); a row
      // that has seen only masked keys gets weights exp2(NEG_INF * sl2) =
      // 0 (not exp2 of the rounding residual of NEG_INF * sl2 twice)
      const float nb0 = mx0 == NEG_INF ? 0.f : -mx0 * sl2;
      const float nb1 = mx1 == NEG_INF ? 0.f : -mx1 * sl2;
      const float al0 = exp2_ftz(fmaf(m0, sl2, nb0));
      const float al1 = exp2_ftz(fmaf(m1, sl2, nb1));
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = exp2_ftz(fmaf(sacc[4 * j], sl2, nb0));
        const float p1 = exp2_ftz(fmaf(sacc[4 * j + 1], sl2, nb0));
        const float p2 = exp2_ftz(fmaf(sacc[4 * j + 2], sl2, nb1));
        const float p3 = exp2_ftz(fmaf(sacc[4 * j + 3], sl2, nb1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      // this thread's part of each row sum; the quad's parts are added at
      // the end (each is rescaled by the same alpha)
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        oacc[4 * i] *= al0;
        oacc[4 * i + 1] *= al0;
        oacc[4 * i + 2] *= al1;
        oacc[4 * i + 3] *= al1;
      }
    };
    auto hand_over = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(TURN + 1 - cw) : "memory");
    };

    // The warpgroups take turns issuing products: the first turn is
    // warpgroup 0's, and each turn hands the next to the other (across
    // items too), so one's softmax runs while the other's products occupy
    // the tensor cores.  A turn issues tile it - 1's O += P V, waits for it
    // (its P registers are free again), then tile it's S = Q K^T.
    if (cw == 1) asm volatile("bar.arrive %0, 256;\n" ::"r"(TURN) : "memory");
    int kv = 0;   // position in the K/V ring, over every item
#pragma unroll 1
    for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
      const Item x = item_of(a, w);
      const bool last_item = w + static_cast<int>(gridDim.x) >= items;
      rmin = x.q0 + cw * 64;                 // this warpgroup's rows
      row0 = rmin + warp * 16 + g;
      row1 = row0 + 8;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
      m0 = m1 = NEG_INF;
      l0 = l1 = 0.f;
      mbar_wait(q_full, j & 1);

      // the first tile: S alone
      {
        const int s = kv % STAGES;
        mbar_wait(k_full + s, (kv / STAGES) & 1);
        named_sync(TURN + cw, 256);
        wgmma_fence();
        issue_s(s);
        wgmma_commit();
        hand_over();
        wgmma_wait0();
        pin<BK / 2>(sacc);
        release(k_empty + s, lane);
        if (x.n == 1) release(q_empty, lane);   // the item's last S
        softmax((x.t0 + x.n - 1) * BK);
      }
#pragma unroll 1
      for (int it = 1; it < x.n; ++it) {
        const int s = (kv + it) % STAGES, sp = (kv + it - 1) % STAGES;
        mbar_wait(k_full + s, ((kv + it) / STAGES) & 1);
        mbar_wait(v_full + sp, ((kv + it - 1) / STAGES) & 1);
        named_sync(TURN + cw, 256);
        wgmma_fence();
        issue_pv(sp);
        wgmma_commit();
        wgmma_wait0();
        pin<D / 2>(oacc);
        release(v_empty + sp, lane);
        wgmma_fence();
        issue_s(s);
        wgmma_commit();
        hand_over();
        wgmma_wait0();
        pin<BK / 2>(sacc);
        release(k_empty + s, lane);
        if (it == x.n - 1) release(q_empty, lane);
        softmax((x.t0 + x.n - 1 - it) * BK);
      }
      // the last tile's O += P V; warpgroup 1's last turn of all hands
      // over nothing
      {
        const int sp = (kv + x.n - 1) % STAGES;
        mbar_wait(v_full + sp, ((kv + x.n - 1) / STAGES) & 1);
        named_sync(TURN + cw, 256);
        wgmma_fence();
        issue_pv(sp);
        wgmma_commit();
        if (!(last_item && cw == 1)) hand_over();
        wgmma_wait0();
        pin<D / 2>(oacc);
        release(v_empty + sp, lane);
      }
      kv += x.n;

      // ---- epilogue: normalise, round, stage in this warpgroup's rows of
      // Os once its last store has read them, one TMA store (rows past Tq
      // dropped), left in flight under the next item
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      if (a.lse != nullptr && t == 0) {
        // the row's log-sum-exp of the scaled scores in natural-log units,
        // as the backward reads it: the softmax ran in base 2 on s * sl2,
        // so lse = (m sl2 + log2 l) ln 2; a row that saw no key keeps
        // NEG_INF
        float* lr = a.lse + static_cast<long long>(x.b * a.Hq + x.h) * a.Tq;
        if (row0 < a.Tq) {
          lr[row0] = m0 == NEG_INF ? NEG_INF
                                   : (m0 * sl2 + log2f(fmaxf(l0, 1e-30f))) *
                                         0.6931471805599453f;
        }
        if (row1 < a.Tq) {
          lr[row1] = m1 == NEG_INF ? NEG_INF
                                   : (m1 * sl2 + log2f(fmaxf(l1, 1e-30f))) *
                                         0.6931471805599453f;
        }
      }
      // one division a row, then multiplies (64 IEEE divisions a thread
      // would cost the epilogue more than the rest of it)
      const float r0 = 1.f / fmaxf(l0, 1e-30f);
      const float r1 = 1.f / fmaxf(l1, 1e-30f);
      if (tid == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      named_sync(1 + cw, 128);
      unsigned char* ob = reinterpret_cast<unsigned char*>(Os);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = jj * 8 + 2 * t, p = col / PC, cin = col % PC;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = cw * 64 + warp * 16 + g + 8 * hf;
          uint32_t off = r * ROWB + cin * 2;
          off ^= ((off >> 7) & ((1u << SWB) - 1u)) << 4;
          const float inv = hf ? r1 : r0;
          *reinterpret_cast<uint32_t*>(ob + p * BQ * ROWB + off) = pack_bf16(
              oacc[4 * jj + 2 * hf] * inv, oacc[4 * jj + 2 * hf + 1] * inv);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + cw, 128);
      if (tid == 0) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_store(&to, Os + p * BQ * PC + cw * 64 * PC, p * PC, rmin, x.h,
                    x.b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

}  // namespace hop

// ---------------------------------------------------------------- fp32 --
constexpr int BQ = 64;    // query rows a CTA
constexpr int BK = 64;    // keys a tile
constexpr int NT = 128;   // threads a CTA (4 warps)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, group, Tq, Tk, causal, window;
  int64_t sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot;
  float scale;
  float* lse;   // (B, Hq, Tq) row log-sum-exp (natural log), or null
};

// The keys a query tile starting at row q0 must visit: [key_begin,
// key_end), key_begin its first row's window rounded down to a tile (a
// tile whose rows see no key visits none: o = 0, lse NEG_INF).
__device__ __forceinline__ int key_end(const Args& a, int q0) {
  return a.causal ? min(a.Tk, min(a.Tq, q0 + BQ)) : a.Tk;
}
__device__ __forceinline__ int key_begin(const Args& a, int q0) {
  return a.window > 0 ? max(0, q0 - a.window + 1) / BK * BK : 0;
}

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

  for (int k0 = key_begin(a, q0); k0 < kend; k0 += BK) {
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
        const bool ok = j < a.Tk && (!a.causal || row >= j) &&
                        (a.window <= 0 || row - j < a.window);
        s[i][c] = ok ? s[i][c] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // a row that has seen only masked keys gets weights expf(NEG_INF) =
      // 0, not expf(NEG_INF - NEG_INF) = 1 (the window's rows whose keys
      // start in a later tile)
      const float mb = mx == NEG_INF ? 0.f : mx;
      const float al = expf(m_r[i] - mb);
      m_r[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = expf(s[i][c] - mb);
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
    if (a.lse != nullptr && tc == 0) {   // natural log: m_r is scaled
      a.lse[static_cast<int64_t>(bh) * a.Tq + row] =
          m_r[i] == NEG_INF ? NEG_INF : m_r[i] + logf(l);
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      o[(int64_t)row * a.sot + tc + 8 * c] = acc[i][c] / l;
    }
  }
}

template <int D>
int launch_fp32(const Args& a, int B, cudaStream_t s) {
  const dim3 grid(B * a.Hq, (a.Tq + BQ - 1) / BQ);
  const int smem = (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fp32<D><<<grid, NT, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a, int B, int Hkv, cudaStream_t s) {
  constexpr int PC = D < 64 ? D : 64;
  const CUtensorMapSwizzle sw = PC == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : PC == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap mq, mk, mv, mo;
  if (!tensor_map(&mq, a.q, D, a.Tq, a.Hq, B, a.sqt, a.sqh, a.sqb, PC,
                  hop::BQ, sw) ||
      !tensor_map(&mk, a.k, D, a.Tk, Hkv, B, a.skt, a.skh, a.skb, PC,
                  hop::BK, sw) ||
      !tensor_map(&mv, a.v, D, a.Tk, Hkv, B, a.svt, a.svh, a.svb, PC,
                  hop::BK, sw) ||
      !tensor_map(&mo, a.o, D, a.Tq, a.Hq, B, a.sot, a.soh, a.sob, PC, 64,
                  sw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nq = (a.Tq + hop::BQ - 1) / hop::BQ;
  const hop::Args ha{B,  a.Hq, a.group, a.Tq, a.Tk, a.causal, a.window, nq,
                     static_cast<float>(1.4426950408889634 /
                                        sqrt(static_cast<double>(D))),
                     a.lse};
  const int smem = hop::smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      hop::flash_hopper<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one CTA an SM (or an item), each walking its items
  const long long items = static_cast<long long>(B) * a.Hq * nq;
  const int grid = static_cast<int>(items < sms ? items : sms);
  hop::flash_hopper<D><<<grid, hop::NT, smem, s>>>(mq, mk, mv, mo, ha);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Args& a, int B, int Hkv, int bf16, cudaStream_t s) {
  return bf16 ? launch_bf16<D>(a, B, Hkv, s) : launch_fp32<D>(a, B, s);
}

}  // namespace

// q (B, Hq, Tq, d), k and v (B, Hkv, Tk, d), o (B, Hq, Tq, d), each at its
// strides (b, h, t, 1), in bf16 (bf16 != 0) or fp32; d in {16, 32, 64,
// 128}; Hq a multiple of Hkv; Tk >= 1; window >= 0 (0: none; taken only
// with causal).  lse: null, or a (B, Hq, Tq) fp32
// contiguous tensor that takes each row's log-sum-exp of the scaled scores
// in natural-log units (the backward's input; a row that saw no key gets
// NEG_INF).  Returns the launch error, if any (cudaErrorInvalidValue for
// arguments out of range).
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int Hq,
    int Hkv, int Tq, int Tk, int d, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, long long sob,
    long long soh, long long sot, int causal, int window, int bf16,
    void* stream) {
  // the fp32 kernel's grid has a y axis of query tiles; the bf16 kernel
  // numbers its work items in an int
  if (B < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Tq < 0 || Tk < 1 ||
      window < 0 || (!bf16 && (Tq + BQ - 1) / BQ > 65535) ||
      (bf16 && static_cast<long long>(B) * Hq * ((Tq + hop::BQ - 1) /
                                                  hop::BQ) >= (1LL << 31))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Tq == 0) return 0;
  Args a{q,   k,   v,   o,   Hq,  Hq / Hkv, Tq,  Tk,  causal ? 1 : 0,
         causal ? window : 0,
         sqb, sqh, sqt, skb, skh, skt,      svb, svh, svt, sob,
         soh, sot, 1.0f / sqrtf(static_cast<float>(d)), lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(a, B, Hkv, bf16, s);
    case 32: return launch<32>(a, B, Hkv, bf16, s);
    case 64: return launch<64>(a, B, Hkv, bf16, s);
    case 128: return launch<128>(a, B, Hkv, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 kernel's shape at head width d, for reports: info[0..6] =
// dynamic shared memory bytes, threads a CTA, producer and consumer
// registers a thread (setmaxnreg), query rows a CTA, keys a tile, ring
// stages.  Returns cudaErrorInvalidValue for another d.
extern "C" int flash_attn_config(int d, int* info) {
  if (d != 16 && d != 32 && d != 64 && d != 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  info[0] = hop::smem_bytes(d);
  info[1] = hop::NT;
  info[2] = hop::PRODUCER_REGS;
  info[3] = hop::CONSUMER_REGS;
  info[4] = hop::BQ;
  info[5] = hop::BK;
  info[6] = hop::STAGES;
  return 0;
}
