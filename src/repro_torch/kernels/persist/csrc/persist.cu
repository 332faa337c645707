// Persistent whole-traversal megakernel: one launch walks every octree
// level for every query tile.
//
// Replaces repro/kernels/persist/kernel.py::persist_kernel (built by
// make_persist_call) for the resident layout with fp32 rows: one CTA per
// tile of `bq` pool slots runs the tile's level loop end to end, with the
// same per-tile contract as the TPU kernel -- its own `fcap`-lane
// frontier, spill ring and outputs -- so verdicts, every counter and the
// overflow that drives escalation come out identical.
//
// Per level:
//   phase A  each live lane gathers its query's OBB (an indexed load; the
//            TPU kernel used a one-hot matmul), its node's fp32 row, builds
//            the node box from the Morton code and runs sact_tile; terminal
//            hits fold their payload into the tile's `best` (shared memory,
//            atomicMin), and candidates stash (child mask, child start).
//   barrier  the expand gate `payload < best[owner]` must see all of this
//            level's folds.
//   phase B  expanding lanes write their children in lane order
//            (parent-major, octant-minor) at an exclusive block scan of
//            popcount(mask), chunked over the live lanes with a running
//            carry; children past `fcap` go to the spill ring at
//            (cursor + pos - fcap) % ring_cap and count as overflow.
//
// The frontier lives in a device-memory workspace of T x 6 x fcap int32
// (query/node slot pairs double-buffered, plus the stash): at the starting
// bucket of paper-scale queries (fcap = 16384) two slot pairs alone need
// 256 KB per tile, more than a block's 227 KB of shared memory.
//
// Bound on the H100: per tested node one 16 B row and one 60 B OBB
// gather (both L2-resident: the fp32 table is at most ~14 MiB at paper
// scale) and ~100 fp32 operations; the design is latency-bound on the
// level barrier and on the few CTAs one query batch makes (one per 128
// queries), which is what a later optimisation has to attack.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../sact/csrc/node_box.cuh"
#include "../../sact/csrc/sact_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kExitCodes = 18;
constexpr int kPayloadInf = 0x7fffffff;

// Exclusive scan of one int per thread over the block; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return excl;
}

template <bool USE_SPHERES>
__global__ void __launch_bounds__(kThreads) persist_kernel(
    const float* __restrict__ scal, const int* __restrict__ sot,
    const int* __restrict__ nvalid, const float* __restrict__ obb,
    const int4* __restrict__ meta, const int* __restrict__ payload,
    const int* __restrict__ owner, int* __restrict__ best_out,
    int* __restrict__ per_level_out, int* __restrict__ hist_out,
    int* __restrict__ scalars_out, int* __restrict__ ring_out,
    int* __restrict__ work, int bq, int fcap, int depth, int n_max,
    int ring_cap) {
  extern __shared__ int best[];  // bq cells, one per owner slot
  __shared__ int hist[kExitCodes];
  __shared__ int warp_sums[kWarps];
  __shared__ int s_owned, s_leaf, s_axis;

  const int t = blockIdx.x, tid = threadIdx.x;
  const int L = depth + 1;
  const int q_base = t * bq;
  const int scene = sot[t];
  const int sb = scene * (3 + L);
  const int* own_tile = owner + q_base;
  const int* pay_tile = payload + q_base;
  int* ws = work + (int64_t)t * 6 * fcap;
  int* fq[2] = {ws, ws + fcap};
  int* fn[2] = {ws + 2 * fcap, ws + 3 * fcap};
  int* st_mask = ws + 4 * fcap;
  int* st_start = ws + 5 * fcap;
  int* ring = ring_out + (int64_t)t * ring_cap * 2;

  if (tid == 0) { s_owned = 0; s_leaf = 0; s_axis = 0; }
  if (tid < kExitCodes) hist[tid] = 0;
  __syncthreads();
  for (int i = tid; i < bq; i += kThreads) {
    best[i] = kPayloadInf;
    if (own_tile[i] >= 0) atomicAdd(&s_owned, 1);
  }
  for (int i = tid; i < ring_cap * 2; i += kThreads) ring[i] = 0;
  __syncthreads();
  // Live prefix: slots with an owner, and before the pool's valid count.
  const int n_q = min(s_owned, min(max(nvalid[0] - q_base, 0), bq));
  int n_live = min(n_q, fcap);
  for (int lane = tid; lane < n_live; lane += kThreads) {
    fq[0][lane] = q_base + lane;
    fn[0][lane] = scene;  // scene s's root sits at flat index s of level 0
  }
  __syncthreads();

  const float lo0 = scal[sb], lo1 = scal[sb + 1], lo2 = scal[sb + 2];
  int leaf = 0, axis = 0;          // this thread's share
  int nodes = 0, overflow = 0, cursor = 0;  // block-uniform
  for (int level = 0; level < L; ++level) {
    const int slot = level & 1;
    if (tid == 0) per_level_out[t * L + level] = n_live;
    if (n_live == 0) continue;
    const float cell = scal[sb + 3 + level];
    const float node_h = cell * 0.5f;
    const int4* meta_l = meta + (int64_t)level * n_max;
    const bool leaf_level = level == depth;

    // ---- phase A: SACT, fold, stash ------------------------------------
    for (int lane = tid; lane < n_live; lane += kThreads) {
      const int q = fq[slot][lane];
      const int idx = fn[slot][lane];
      const int ql = q - q_base;
      const int4 row = meta_l[min(max(idx, 0), n_max - 1)];
      float node_c[3];
      node_centre((uint32_t)row.x, lo0, lo1, lo2, cell, node_c);
      const float* o = obb + (int64_t)q * 15;
      SactPair p;
      for (int i = 0; i < 3; ++i) {
        p.t[i] = o[i] - node_c[i];
        p.oh[i] = o[3 + i];
        p.ah[i] = node_h;
        for (int j = 0; j < 3; ++j) {
          p.R[i][j] = o[6 + 3 * i + j];
          p.A[i][j] = fabsf(p.R[i][j]) + SACT_EPS;
        }
      }
      bool hit;
      const int exit_code = sact_tile<USE_SPHERES>(p, &hit);
      const bool is_term = row.y != 0 || leaf_level;
      if (hit && is_term) {
        const int own = own_tile[ql];
        if (own >= 0 && own < bq) atomicMin(&best[own], pay_tile[ql]);
      }
      if (is_term) {
        ++leaf;
        atomicAdd(&hist[exit_code], 1);
      }
      axis += axis_tests_from_exit(exit_code);
      st_mask[lane] = (hit && !is_term) ? row.w : 0;
      st_start[lane] = row.z;
    }
    __syncthreads();

    // ---- phase B: gate, scan, expand (lane order) ----------------------
    int carry = 0;
    for (int c0 = 0; c0 < n_live; c0 += kThreads) {
      const int lane = c0 + tid;
      int mask = 0, n_child = 0, q = 0;
      if (lane < n_live && (mask = st_mask[lane]) != 0) {
        q = fq[slot][lane];
        const int ql = q - q_base;
        const int own = own_tile[ql];
        const int b = (own >= 0 && own < bq) ? best[own] : kPayloadInf;
        if (pay_tile[ql] < b) n_child = __popc(mask);
      }
      int total;
      const int base = carry + block_exclusive_scan(n_child, warp_sums, &total);
      if (n_child > 0) {
        const int start = st_start[lane];
        int k = 0;
        for (int j = 0; j < 8; ++j) {
          if (!((mask >> j) & 1)) continue;
          const int pos = base + k;
          if (pos < fcap) {
            fq[1 - slot][pos] = q;
            fn[1 - slot][pos] = start + k;
          } else {
            const int r = (cursor + (pos - fcap)) % ring_cap;
            ring[2 * r] = q;
            ring[2 * r + 1] = start + k;
          }
          ++k;
        }
      }
      carry += total;
    }
    nodes += n_live;
    const int spill = max(carry - fcap, 0);
    overflow += spill;
    cursor = (cursor + spill) % ring_cap;
    n_live = min(carry, fcap);
    __syncthreads();  // the next level reads the slot written above
  }

  atomicAdd(&s_leaf, leaf);
  atomicAdd(&s_axis, axis);
  __syncthreads();
  for (int i = tid; i < bq; i += kThreads) best_out[(int64_t)t * bq + i] = best[i];
  if (tid < kExitCodes) hist_out[t * kExitCodes + tid] = hist[tid];
  if (tid == 0) {
    int* sc = scalars_out + t * 8;
    sc[0] = nodes;
    sc[1] = s_leaf;
    sc[2] = s_axis;
    sc[3] = nodes * 15;
    sc[4] = USE_SPHERES ? 2 * nodes : 0;
    sc[5] = overflow;
    sc[6] = overflow;  // spilled pairs
    sc[7] = 0;         // meta rows streamed: 0 in the resident layout
  }
}

}  // namespace

extern "C" int persist_launch(const float* scal, const int* sot,
                              const int* nvalid, const float* obb,
                              const int* meta, const int* payload,
                              const int* owner, int* best, int* per_level,
                              int* hist, int* scalars, int* ring, int* work,
                              int num_tiles, int bq, int fcap, int depth,
                              int n_max, int ring_cap, int use_spheres,
                              void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int) * (size_t)bq;
  const int4* meta4 = reinterpret_cast<const int4*>(meta);
  if (use_spheres) {
    persist_kernel<true><<<num_tiles, kThreads, smem, s>>>(
        scal, sot, nvalid, obb, meta4, payload, owner, best, per_level, hist,
        scalars, ring, work, bq, fcap, depth, n_max, ring_cap);
  } else {
    persist_kernel<false><<<num_tiles, kThreads, smem, s>>>(
        scal, sot, nvalid, obb, meta4, payload, owner, best, per_level, hist,
        scalars, ring, work, bq, fcap, depth, n_max, ring_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
