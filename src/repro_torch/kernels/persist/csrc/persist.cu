// Persistent whole-traversal megakernel: one launch walks every octree
// level for every query tile.
//
// Replaces repro/kernels/persist/kernel.py::persist_kernel (built by
// make_persist_call) for the resident layout with fp32 rows, with the same
// per-tile contract as the TPU kernel -- each tile of `bq` pool slots has
// its own `fcap`-lane frontier, spill ring and outputs -- so verdicts,
// every counter and the overflow that drives escalation come out
// identical (persist_tiles_ref is the plain version).
//
// A tile runs on a thread-block cluster of kCluster CTAs of kThreads
// threads (one cluster per tile), so a heavy tile is not left to one SM
// while most of the others have long finished: the paper-scale queries'
// heaviest tile holds 10-20x the nodes of the mean one.  Each CTA stages
// the tile's bq x 15 OBB block, owners and payloads in shared memory once
// (the TPU kernel's obb_tile), so a lane gathers no OBB from device memory.
//
// Per level each rank takes a contiguous share of the level's lanes, and
// each thread a contiguous run of its rank's share:
//   phase A  each lane loads its (query, node) pair, then the node's fp32
//            row (software-pipelined two lanes ahead), builds the node box
//            from the Morton code and runs the SACT straight through
//            (sact_tile.cuh); a terminal hit folds its payload into this
//            rank's best[owner], a candidate adds its child count to this
//            rank's per-slot count (both in shared memory, by level
//            parity), and each lane stashes (child mask | slot << 8, child
//            start): the run's first in a register, the rest in the
//            workspace, private to the thread; the children's rows are
//            prefetched for the next level.
//   cluster barrier: every rank's folds and counts of the level are in.
//   gate     each CTA reads every rank's best and counts (distributed
//            shared memory) once a slot: gate = payload < the least best of
//            the owner, and each rank's total = its gated counts, so every
//            rank knows every rank's total with no second barrier.
//   phase B  each thread sums popc(mask) over its run's gated lanes; one
//            block scan gives the run's first position after the ranks
//            before it; the thread writes its children in lane order
//            (parent-major, octant-minor) into a shared-memory stage, from
//            which the CTA stores them coalesced.  Lane order is rank-major,
//            so positions, the spill ring at (cursor + pos - fcap) %
//            ring_cap and every counter are those of a one-CTA walk.
//   level's end: while no rank wrote more children than it has threads,
//            each rank's share of the next level is its own children, kept
//            in its stage, and the level ends with a block barrier; else
//            the children go to the workspace, the next level is split
//            afresh, and the level ends with a cluster barrier.
// The leaf level expands nothing, so it runs phase A alone.  Per-CTA exit
// histograms and leaf and axis counts are summed into rank 0 at the end,
// and every rank's best words are min-folded into rank 0's `fin` words,
// which nothing else writes after the set-up (a rank can reach the end
// while rank 0 still copies its best words at the last expanding level's
// gate); the spill cursor and overflow are the same in every rank.
//
// The frontier lives in a device-memory workspace of T x 6 x fcap int32
// ((query, node) pairs double-buffered, plus the stash): a tile's level
// can hold more lanes than a block's 227 KB of shared memory (the starting
// bucket of paper-scale queries is 16,384 lanes, and escalation grows it).
// Frontier loads bypass L1 (ld.global.cg): another SM of the cluster
// wrote them.
//
// Bound on the H100: per tested node one 8 B pair and one 16 B row (both
// L2-resident: the fp32 table is at most ~14 MiB at paper scale) and ~100
// fp32 operations, so the bound is far below a microsecond.  What sets
// the time is the heaviest tile's chain of levels: ~3 us a level of
// cross-SM latency (the fold barrier, the remote reads of the gate, the
// level's last barrier) and local barriers and scans, whatever its width,
// then the widest levels' runs of lanes a thread, each lane a chain of
// dependent loads and the SACT's arithmetic, which the cluster shortens
// by spreading the tile over kCluster SMs.
//
// kCluster and kThreads were chosen by timing (PERF.md section 6);
// tools/persist_fps_variants.py builds copies of this file with other
// values, and tools/persist_trace.cu times each level's phases.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../sact/csrc/node_box.cuh"
#include "../../sact/csrc/sact_tile.cuh"

// Phase marks, empty in this build: tools/persist_trace.cu defines them to
// time each level's phases on the card.
#ifndef PERSIST_MARK
#define PERSIST_MARK(level, k)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// CTAs an SM that the register budget must allow: 96 registers a thread,
// which the SACT's pair and the pipelined loads need without a spill (at
// 64 or 80 it spills).  At 128 threads that is five CTAs an SM.
constexpr int kMinBlocks = kThreads * 96 > 65536 ? 1 : 65536 / (kThreads * 96);
constexpr int kExitCodes = 18;
constexpr int kPayloadInf = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads % 32 == 0 && kThreads >= 64 && kThreads <= 1024,
              "kThreads: a multiple of 32 in [64, 1024]");
static_assert(kCluster >= 1 && kCluster <= 8, "kCluster: 1 to 8 CTAs");

// Pairs a CTA stages in shared memory: its children of one level, stored
// coalesced from there (and kept there for the next level while every
// rank's share is at most a lane a thread).
constexpr int kStage = 4096;
static_assert(kStage >= kThreads, "a rank's own share must fit the stage");

// Words of one CTA's shared memory before the stage, for `bq` slots: the
// OBB block, owner, payload, two best and two candidate words, a gate and
// a fin word a slot; even, so that the stage is 8-byte aligned.
__host__ __device__ constexpr int slot_words(int bq) {
  return (bq * (15 + 8) + 1) & ~1;
}

// Dynamic shared memory of one CTA for `bq` slots: the slot words, then
// the stage.  A tile past a block's 227 KB is refused at launch.
size_t smem_bytes(int bq) {
  return (size_t)slot_words(bq) * sizeof(int) + kStage * sizeof(int2);
}

// Exclusive scan of one int per thread over the block (one barrier);
// *total gets the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  // every warp scans the warp totals itself: no second barrier
  int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, w, o);
    if (lane >= o) w += y;
  }
  *total = __shfl_sync(kFull, w, kWarps - 1);
  const int before = warp > 0 ? __shfl_sync(kFull, w, warp - 1) : 0;
  return before + x - v;
}

template <bool USE_SPHERES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) persist_kernel(
    const float* __restrict__ scal, const int* __restrict__ sot,
    const int* __restrict__ nvalid, const float* __restrict__ obb,
    const int4* __restrict__ meta, const int* __restrict__ payload,
    const int* __restrict__ owner, int* __restrict__ best_out,
    int* __restrict__ per_level_out, int* __restrict__ hist_out,
    int* __restrict__ scalars_out, int* __restrict__ ring_out,
    int* __restrict__ work, int bq, int fcap, int depth, int n_max,
    int ring_cap) {
  extern __shared__ float4 smem4[];
  float* obb_s = reinterpret_cast<float*>(smem4);  // bq x 15
  int* own_s = reinterpret_cast<int*>(obb_s + bq * 15);
  int* pay_s = own_s + bq;
  int* best = pay_s + bq;   // [2][bq] this rank's folds, by level parity
  int* cand = best + 2 * bq;   // [2][bq] candidate children, per slot
  int* gate = cand + 2 * bq;   // payload < best[owner], per slot
  int* fin = gate + bq;        // rank 0's: every rank's final best words
  int2* stage = reinterpret_cast<int2*>(smem4) + slot_words(bq) / 2;
  __shared__ int hist[kExitCodes];
  __shared__ int warp_sums[kWarps];
  __shared__ int rank_tot[kCluster];
  __shared__ int s_leaf, s_axis;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.x / kCluster, tid = threadIdx.x;
  const int L = depth + 1;
  const int q_base = t * bq;
  const int scene = sot[t];
  const int sb = scene * (3 + L);
  int2* ws = reinterpret_cast<int2*>(work + (int64_t)t * 6 * fcap);
  int2* front[2] = {ws, ws + fcap};   // (query, node) pairs
  int2* stash = ws + 2 * (int64_t)fcap;
  int2* ring = reinterpret_cast<int2*>(ring_out) + (int64_t)t * ring_cap;

  if (tid == 0) { s_leaf = 0; s_axis = 0; }
  if (tid < kExitCodes) hist[tid] = 0;
  const float* obb_t = obb + (int64_t)q_base * 15;
  for (int i = tid; i < bq * 15; i += kThreads) obb_s[i] = obb_t[i];
  for (int i = tid; i < 4 * bq; i += kThreads)
    best[i] = i < 2 * bq ? kPayloadInf : 0;   // and cand
  for (int i = tid; i < bq; i += kThreads) fin[i] = kPayloadInf;
  int owned = 0;
  for (int i0 = 0; i0 < bq; i0 += kThreads) {
    const int i = i0 + tid;
    int own = -1;
    if (i < bq) {
      own = owner[q_base + i];
      own_s[i] = own;
      pay_s[i] = payload[q_base + i];
    }
    owned += __syncthreads_count(own >= 0);
  }
  for (int i = rank * kThreads + tid; i < ring_cap; i += kCluster * kThreads)
    ring[i] = make_int2(0, 0);
  // Every CTA of the cluster is running and set up before any rank reads
  // another's shared memory.
  cluster.sync();
  PERSIST_MARK(0, 0);

  // Live prefix: slots with an owner, and before the pool's valid count.
  const int n_q = min(owned, min(max(nvalid[0] - q_base, 0), bq));
  int n_live = min(n_q, fcap);
  const float lo0 = scal[sb], lo1 = scal[sb + 1], lo2 = scal[sb + 2];
  int leaf = 0, axis = 0;                    // this thread's share
  int nodes = 0, overflow = 0, cursor = 0;   // the same in every rank
  // Where this rank's lanes of the level are: the whole level's lanes
  // split rank-major (in the device workspace), or the children this rank
  // wrote at the level before ([own_lo, own_hi), kept in `stage`).
  bool own_level = false;
  int own_lo = 0, own_hi = 0, fold_p = 0;
  for (int level = 0; level < L; ++level) {
    const int p = level & 1;
    if (rank == 0 && tid == 0) per_level_out[t * L + level] = n_live;
    if (n_live == 0) continue;
    fold_p = p;
    int* best_p = best + p * bq;
    int* cand_p = cand + p * bq;
    const int2* cur = front[p];
    int2* nxt = front[1 - p];
    const float cell = scal[sb + 3 + level];
    const float node_h = cell * 0.5f;
    const int4* meta_l = meta + (int64_t)level * n_max;
    const bool leaf_level = level == depth;
    int r_lo, r_n;
    if (own_level) {
      r_lo = own_lo;
      r_n = own_hi - own_lo;
    } else {
      r_lo = (int)((int64_t)n_live * rank / kCluster);
      r_n = (int)((int64_t)n_live * (rank + 1) / kCluster) - r_lo;
    }
    // this thread's run of the rank's lanes: [a, b)
    const int per = r_n / kThreads, extra = r_n % kThreads;
    const int a = r_lo + tid * per + min(tid, extra);
    const int b = a + per + (tid < extra ? 1 : 0);
    if (tid < kCluster) rank_tot[tid] = 0;

    // ---- phase A: SACT, fold, candidates, stash -------------------------
    auto pair_at = [&](int lane) -> int2 {
      if (level == 0) return make_int2(q_base + lane, scene);
      return own_level ? stage[lane - r_lo] : __ldcg(cur + lane);
    };
    auto row_of = [&](int idx) -> int4 {
      return __ldg(meta_l + min(max(idx, 0), n_max - 1));
    };
    int2 f_next = make_int2(0, 0), f_after = make_int2(0, 0);
    int4 r_next = make_int4(0, 0, 0, 0);
    if (a < b) {
      f_next = pair_at(a);
      r_next = row_of(f_next.y);
    }
    if (a + 1 < b) f_after = pair_at(a + 1);
    int2 first = make_int2(0, 0);   // the run's first stash, in registers
    for (int lane = a; lane < b; ++lane) {
      const int q = f_next.x;
      const int4 row = r_next;
      if (lane + 1 < b) {
        f_next = f_after;
        r_next = row_of(f_next.y);
      }
      if (lane + 2 < b) f_after = pair_at(lane + 2);
      const int ql = q - q_base;
      float node_c[3];
      node_centre((uint32_t)row.x, lo0, lo1, lo2, cell, node_c);
      SactObb ob;
      sact_obb(obb_s + ql * 15, &ob);
      const float tv[3] = {ob.c[0] - node_c[0], ob.c[1] - node_c[1],
                           ob.c[2] - node_c[2]};
      const float ah[3] = {node_h, node_h, node_h};
      bool hit;
      const int exit_code =
          sact_tile<USE_SPHERES, SactMode::kStraight>(ob, tv, ah, &hit);
      const bool is_term = row.y != 0 || leaf_level;
      const int mask = (hit && !is_term) ? (row.w & 0xff) : 0;
      if (hit && is_term) {   // fold the payload into the owner's best
        const int own = own_s[ql];
        if (own >= 0 && own < bq) atomicMin(best_p + own, pay_s[ql]);
      }
      if (is_term) {
        ++leaf;
        atomicAdd(&hist[exit_code], 1);
      }
      axis += axis_tests_from_exit(exit_code);
      if (!leaf_level) {
        if (mask) {
          atomicAdd(cand_p + ql, __popc(mask));
          // the children's rows, for the next level: into this SM's L1,
          // where the rank keeps its own children (and, the positions
          // being rank-major, often also where the level is split afresh)
          const int4* rows = meta_l + n_max + row.z;
          asm volatile("prefetch.global.L1 [%0];" :: "l"(rows));
          asm volatile("prefetch.global.L1 [%0];"
                       :: "l"(rows + __popc(mask) - 1));
        }
        const int2 st = make_int2(mask | (ql << 8), row.z);
        if (lane == a) first = st; else stash[lane] = st;
      }
    }
    PERSIST_MARK(level, 1);
    nodes += n_live;
    if (leaf_level) break;   // no children: the level ends with phase A
    cluster.sync();          // every rank's folds and counts of the level
    PERSIST_MARK(level, 2);

    // ---- gate and the ranks' totals -----------------------------------------
    // gate: payload < the least best of the owner over the ranks; each
    // rank's total: its gated candidate children.  The next level folds
    // into the other parity, which starts from this level's.
    int tot[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) tot[r] = 0;
    for (int i = tid; i < bq; i += kThreads) {
      const int own = own_s[i];
      const bool owned_slot = own >= 0 && own < bq;
      int m = kPayloadInf, c[kCluster];
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {   // one round of remote loads
        if (owned_slot) m = min(m, cluster.map_shared_rank(best_p, r)[own]);
        c[r] = cluster.map_shared_rank(cand_p, r)[i];
      }
      const bool g = owned_slot && pay_s[i] < m;
      gate[i] = g;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) tot[r] += g ? c[r] : 0;
      best[(1 - p) * bq + i] = best_p[i];
      cand[(1 - p) * bq + i] = 0;
    }
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const int v = __reduce_add_sync(kFull, tot[r]);
      if ((tid & 31) == 0 && v != 0) atomicAdd(&rank_tot[r], v);
    }
    __syncthreads();
    PERSIST_MARK(level, 3);

    // ---- phase B: count, scan, expand -------------------------------------
    int cnt = 0;
    for (int lane = a; lane < b; ++lane) {
      const int2 s = lane == a ? first : stash[lane];
      const int m = s.x & 0xff;
      if (m != 0 && gate[s.x >> 8]) cnt += __popc(m);
    }
    int block_total;
    const int excl = block_exclusive_scan(cnt, warp_sums, &block_total);
    int base = 0, total = 0, widest = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const int v = rank_tot[r];
      base += r < rank ? v : 0;
      total += v;
      widest = max(widest, v);
    }
    // The next level reads each rank's own children from `stage` while no
    // rank has more than a lane a thread; else the whole level, split
    // afresh, from the workspace.
    const bool own_next = widest <= kThreads;
    PERSIST_MARK(level, 4);
    // Children in lane order at base + excl, staged in shared memory a
    // window of kStage positions at a time and stored coalesced.
    for (int w = 0; w < block_total; w += kStage) {
      const int w_end = w + kStage;
      int off = excl;
      for (int lane = a; lane < b && cnt > 0 && off < w_end; ++lane) {
        const int2 s = lane == a ? first : stash[lane];
        const int m = s.x & 0xff;
        if (m == 0 || !gate[s.x >> 8]) continue;
        const int c = __popc(m);
        const int q = q_base + (s.x >> 8);
        for (int k = max(w - off, 0); k < c && off + k < w_end; ++k)
          stage[off + k - w] = make_int2(q, s.y + k);
        off += c;
      }
      __syncthreads();
      // nothing leaves the stage while the next level reads it there and
      // no child of this CTA spills
      const int n_w = (own_next && base + block_total <= fcap)
                          ? 0 : min(kStage, block_total - w);
      for (int k = tid; k < n_w; k += kThreads) {
        const int pos = base + w + k;
        if (pos >= fcap)
          ring[((unsigned)cursor + (unsigned)(pos - fcap)) % (unsigned)ring_cap]
              = stage[k];
        else if (!own_next)
          nxt[pos] = stage[k];
      }
      if (w_end < block_total) __syncthreads();   // the stage is reused
    }
    const int spill = max(total - fcap, 0);
    overflow += spill;
    cursor = (int)(((unsigned)cursor + (unsigned)spill) % (unsigned)ring_cap);
    n_live = min(total, fcap);
    own_level = own_next;
    own_lo = min(base, fcap);
    own_hi = min(base + block_total, fcap);
    PERSIST_MARK(level, 5);
    // the next level reads what this CTA staged, or what every rank stored
    if (own_next) __syncthreads(); else cluster.sync();
    PERSIST_MARK(level, 6);
  }

  // ---- sums into rank 0, outputs -------------------------------------------
  leaf = __reduce_add_sync(kFull, leaf);
  axis = __reduce_add_sync(kFull, axis);
  if ((tid & 31) == 0) {
    atomicAdd(&s_leaf, leaf);
    atomicAdd(&s_axis, axis);
  }
  __syncthreads();
  // Into rank 0's fin words, never into its best words: with no cluster
  // barrier after the last expanding level (its children stayed in each
  // rank's stage), rank 0 may still be copying best_p into the parity that
  // this rank folded its leaf level into.
  const int* best_f = best + fold_p * bq;
  int* fin0 = cluster.map_shared_rank(fin, 0);
  for (int i = tid; i < bq; i += kThreads)
    if (best_f[i] != kPayloadInf) atomicMin(fin0 + i, best_f[i]);
  if (rank != 0) {
    if (tid == 0) {
      atomicAdd(cluster.map_shared_rank(&s_leaf, 0), s_leaf);
      atomicAdd(cluster.map_shared_rank(&s_axis, 0), s_axis);
    }
    if (tid < kExitCodes)
      atomicAdd(cluster.map_shared_rank(hist, 0) + tid, hist[tid]);
  }
  cluster.sync();   // every rank's folds and counts are in rank 0
  PERSIST_MARK(15, 7);
  if (rank != 0) return;
  for (int i = tid; i < bq; i += kThreads)
    best_out[(int64_t)t * bq + i] = fin[i];
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

cudaLaunchConfig_t launch_config(int num_tiles, int bq, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_tiles * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(bq);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool USE_SPHERES>
int launch(const float* scal, const int* sot, const int* nvalid,
           const float* obb, const int4* meta, const int* payload,
           const int* owner, int* best, int* per_level, int* hist,
           int* scalars, int* ring, int* work, int num_tiles, int bq,
           int fcap, int depth, int n_max, int ring_cap, cudaStream_t s) {
  // A failed call's error is also the runtime's last error, which
  // cudaGetLastError returns and clears, so that no later launch reports it.
  const size_t smem = smem_bytes(bq);
  if (smem <= 48 * 1024 ||
      cudaFuncSetAttribute(persist_kernel<USE_SPHERES>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(num_tiles, bq, s, attr);
    cudaLaunchKernelEx(&cfg, persist_kernel<USE_SPHERES>, scal, sot, nvalid,
                       obb, meta, payload, owner, best, per_level, hist,
                       scalars, ring, work, bq, fcap, depth, n_max, ring_cap);
  }
  return static_cast<int>(cudaGetLastError());
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
  const int4* meta4 = reinterpret_cast<const int4*>(meta);
  return use_spheres
             ? launch<true>(scal, sot, nvalid, obb, meta4, payload, owner,
                            best, per_level, hist, scalars, ring, work,
                            num_tiles, bq, fcap, depth, n_max, ring_cap, s)
             : launch<false>(scal, sot, nvalid, obb, meta4, payload, owner,
                             best, per_level, hist, scalars, ring, work,
                             num_tiles, bq, fcap, depth, n_max, ring_cap, s);
}

// The launch shape, for reports: out[0..3] = CTAs a cluster, threads a CTA,
// dynamic shared memory a CTA for `bq` slots, and how many such clusters
// the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int persist_shape(int bq, int* out) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, bq, nullptr, attr);
  const size_t smem = smem_bytes(bq);
  int clusters = 0;
  if (smem <= 48 * 1024 ||
      cudaFuncSetAttribute(persist_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) == cudaSuccess)
    cudaOccupancyMaxActiveClusters(&clusters, persist_kernel<false>, &cfg);
  out[0] = kCluster;
  out[1] = kThreads;
  out[2] = (int)smem;
  out[3] = clusters;
  return static_cast<int>(cudaGetLastError());
}
