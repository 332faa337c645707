// Persistent whole-traversal megakernel: one launch walks every octree
// level for every query tile.
//
// Replaces repro/kernels/persist/kernel.py::persist_kernel (built by
// make_persist_call), with the same per-tile contract as the TPU kernel --
// each tile of `bq` pool slots has its own `fcap`-lane frontier, spill
// ring and outputs -- so verdicts, every counter and the overflow that
// drives escalation come out identical (persist_tiles_ref is the plain
// version), for rows in each of the three formats and in both layouts.
//
// Rows (template FMT): fp32 (int4), bf16 (int2) or u8 (int) a node,
// decoded in registers (node_box.cuh::decode_row) into the same integer
// cell coordinates, so every format gives the same centres, verdicts and
// counters.  A u8 row holds only the node's octant: each lane carries its
// parent's Morton code beside its (query, node) pair, in the workspace,
// the stage and the stash (not in the spill ring, whose pairs are only
// (query, node), as in the TPU kernel).
//
// Layouts (template STREAM): the rows are read from device memory through
// L2 in both.  Under the streamed layout the TPU kernel fetches each level in
// windows of `wsub` rows over the tile's scene extent (off, cnt), only
// the windows some lane of the tile points into, each rounded out to
// whole 8-row chunks, and counts the rows into `meta_rows`; this kernel
// computes that count.  Every rank marks the windows its lanes touch in
// one bitmap of the tile's workspace slice, by level parity; after the
// barrier that ends the level's phase A (the fold barrier, or the final
// one after the leaf level) rank 0 adds each set window's span once and
// clears its words.
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
//   phase A  each lane loads its (query, node) pair, then the node's row
//            (software-pipelined two lanes ahead; u8 also the parent code),
//            marks the row's window (streamed layout), builds the node box
//            from the decoded cell coordinates and runs the SACT straight through
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
// ((query, node) pairs double-buffered, plus the stash; u8 adds 3 x fcap
// for the code lanes, and the streamed layout the window bitmaps past
// shared memory: persist_work_words): a tile's level
// can hold more lanes than a block's 227 KB of shared memory (the starting
// bucket of paper-scale queries is 16,384 lanes, and escalation grows it).
// Frontier loads bypass L1 (ld.global.cg): another SM of the cluster
// wrote them.
//
// Bound on the H100: per tested node one 8 B pair and one 4-16 B row (the
// paper-scale tables fit L2; fig_bigscene's do not) and ~100 fp32
// operations: below a microsecond at paper scale.  What sets
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

// Row formats, in the order of repro_torch.core.quantize.META_FORMATS.
constexpr int kFp32 = 0, kBf16 = 1, kU8 = 2;
template <int FMT> struct MetaRow { using T = int4; };
template <> struct MetaRow<kBf16> { using T = int2; };
template <> struct MetaRow<kU8> { using T = int; };

// Words of the streamed layout's window bitmap: a bit a window of a level.
__host__ __device__ constexpr int win_words(int nwin) {
  return (nwin + 31) / 32;
}

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

// Dynamic shared memory of one CTA for `bq` slots: the slot words, the
// stage and u8's codes of the staged pairs.  A tile past a block's 227 KB
// is refused at launch.
size_t smem_bytes(int bq, int fmt) {
  size_t b = (size_t)slot_words(bq) * sizeof(int) + kStage * sizeof(int2);
  if (fmt == kU8) b += kStage * sizeof(int);
  return b;
}

// int32 words of one tile's workspace slice: the (query, node) pairs of
// both frontier slots and the stash; u8's code lanes of both slots and the
// stash; the streamed layout's window bitmaps (by level parity).  A
// multiple of 4 words, so that every slice is 16-byte aligned.
long long work_words(int fcap, int fmt, int nwin) {
  long long w = 6LL * fcap;
  if (fmt == kU8) w += 3LL * fcap;
  if (nwin > 0) w += 2LL * win_words(nwin);
  return (w + 3) & ~3LL;
}

// Rows the TPU kernel fetches for window w of a level whose scene extent
// is [off, off + cnt): the window's occupied rows rounded out to whole
// 8-row chunks; 0 for an empty window.
__device__ __forceinline__ int window_span(int w, int wsub, int off,
                                           int cnt) {
  const long long lo = (long long)w * wsub;
  const long long occ = min(max((long long)cnt - lo, 0LL), (long long)wsub);
  if (occ <= 0) return 0;
  const long long g_lo = off + lo, g_hi = g_lo + occ;
  return (int)(((g_hi + 7) & ~7LL) - (g_lo & ~7LL));
}


// The kernel's arguments; `meta` holds rows of the instance's format.
struct PersistArgs {
  const float* scal;
  const int* off;      // (S * L,) each scene's first row of each level
  const int* cnt;      // (S * L,) and its rows
  const int* sot;
  const int* nvalid;
  const float* obb;
  const void* meta;
  const int* payload;
  const int* owner;
  int* best_out;
  int* per_level_out;
  int* hist_out;
  int* scalars_out;
  int* ring_out;
  int* work;
  long long tile_words;
  int bq, fcap, depth, n_max, ring_cap;
  int streamed, wsub, nwin;
  int wshift;   // log2(wsub) when wsub is a power of two, else -1
};

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

template <bool USE_SPHERES, int FMT, bool STREAM>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    persist_kernel(const PersistArgs args) {
  using Row = typename MetaRow<FMT>::T;
  constexpr bool kCode = FMT == kU8;
  // a template flag: the resident instances carry no window code
  constexpr bool streamed = STREAM;
  const float* __restrict__ scal = args.scal;
  const int* __restrict__ owner = args.owner;
  const int* __restrict__ payload = args.payload;
  const Row* __restrict__ meta = static_cast<const Row*>(args.meta);
  const int bq = args.bq, fcap = args.fcap, depth = args.depth;
  const int n_max = args.n_max, ring_cap = args.ring_cap;
  const int wsub = args.wsub, nwin = args.nwin, wshift = args.wshift;
  const int W = win_words(nwin);
  extern __shared__ float4 smem4[];
  float* obb_s = reinterpret_cast<float*>(smem4);  // bq x 15
  int* own_s = reinterpret_cast<int*>(obb_s + bq * 15);
  int* pay_s = own_s + bq;
  int* best = pay_s + bq;   // [2][bq] this rank's folds, by level parity
  int* cand = best + 2 * bq;   // [2][bq] candidate children, per slot
  int* gate = cand + 2 * bq;   // payload < best[owner], per slot
  int* fin = gate + bq;        // rank 0's: every rank's final best words
  int2* stage = reinterpret_cast<int2*>(smem4) + slot_words(bq) / 2;
  int* stage_code = reinterpret_cast<int*>(stage + kStage);   // u8
  __shared__ int hist[kExitCodes];
  __shared__ int warp_sums[kWarps];
  __shared__ int rank_tot[kCluster];
  __shared__ int s_leaf, s_axis, s_meta;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.x / kCluster, tid = threadIdx.x;
  const int L = depth + 1;
  const int q_base = t * bq;
  const int scene = args.sot[t];
  const int sb = scene * (3 + L);
  int* wt = args.work + (int64_t)t * args.tile_words;
  int2* ws = reinterpret_cast<int2*>(wt);
  int2* front[2] = {ws, ws + fcap};   // (query, node) pairs
  int2* stash = ws + 2 * (int64_t)fcap;
  // u8: the parent code of each pair of both slots, and of each stash entry
  int* codes = wt + 6 * (int64_t)fcap;
  int* stash_code = codes + 2 * (int64_t)fcap;
  // the window bitmaps that every rank marks, by level parity: [2][W]
  int* win = codes + (kCode ? 3 * (int64_t)fcap : 0);
  int2* ring = reinterpret_cast<int2*>(args.ring_out) + (int64_t)t * ring_cap;
  // After the barrier that ends a level's phase A (parity p), on rank 0:
  // each window set at the level (off, cnt) adds its span once; the words
  // are cleared for the level after next, which no rank marks before the
  // next level's fold barrier.
  int meta_rows = 0;   // rank 0's threads' share
  auto win_sum = [&](int p, int off_l, int cnt_l) {
    if (!streamed || rank != 0) return;
    int* words = win + p * W;
    for (int i = tid; i < W; i += kThreads) {
      int v = __ldcg(words + i);
      if (v == 0) continue;
      __stcg(words + i, 0);
      for (; v; v &= v - 1)
        meta_rows += window_span(i * 32 + __ffs(v) - 1, wsub, off_l, cnt_l);
    }
  };

  if (tid == 0) { s_leaf = 0; s_axis = 0; s_meta = 0; }
  if (tid < kExitCodes) hist[tid] = 0;
  if (streamed && rank == 0) {   // both parities start empty
    for (int i = tid; i < 2 * W; i += kThreads) win[i] = 0;
  }
  const float* obb_t = args.obb + (int64_t)q_base * 15;
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
  const int n_q = min(owned, min(max(args.nvalid[0] - q_base, 0), bq));
  int n_live = min(n_q, fcap);
  const float lo0 = scal[sb], lo1 = scal[sb + 1], lo2 = scal[sb + 2];
  int leaf = 0, axis = 0;                    // this thread's share
  int nodes = 0, overflow = 0, cursor = 0;   // the same in every rank
  // Where this rank's lanes of the level are: the whole level's lanes
  // split rank-major (in the device workspace), or the children this rank
  // wrote at the level before ([own_lo, own_hi), kept in `stage`).
  bool own_level = false;
  int own_lo = 0, own_hi = 0, fold_p = 0, fold_level = 0;
  for (int level = 0; level < L; ++level) {
    const int p = level & 1;
    if (rank == 0 && tid == 0) args.per_level_out[t * L + level] = n_live;
    if (n_live == 0) continue;
    fold_p = p;
    fold_level = level;
    int* best_p = best + p * bq;
    int* cand_p = cand + p * bq;
    const int2* cur = front[p];
    int2* nxt = front[1 - p];
    const int* cur_code = codes + p * (int64_t)fcap;
    int* nxt_code = codes + (1 - p) * (int64_t)fcap;
    const float cell = scal[sb + 3 + level];
    const float node_h = cell * 0.5f;
    const Row* meta_l = meta + (int64_t)level * n_max;
    const bool leaf_level = level == depth;
    int off_l = 0, cnt_l = 0, last_w = -1;
    int* win_p = win + p * W;   // the level's window bitmap
    if (streamed) {
      off_l = args.off[scene * L + level];
      cnt_l = args.cnt[scene * L + level];
    }
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
    auto code_at = [&](int lane) -> int {
      if (level == 0) return 0;   // every root's parent code
      return own_level ? stage_code[lane - r_lo] : __ldcg(cur_code + lane);
    };
    auto row_of = [&](int idx) -> Row {
      return __ldg(meta_l + min(max(idx, 0), n_max - 1));
    };
    int2 f_next = make_int2(0, 0), f_after = make_int2(0, 0);
    Row r_next = {};
    int c_next = 0;
    if (a < b) {
      f_next = pair_at(a);
      r_next = row_of(f_next.y);
      if (kCode) c_next = code_at(a);
    }
    if (a + 1 < b) f_after = pair_at(a + 1);
    int2 first = make_int2(0, 0);   // the run's first stash, in registers
    int first_code = 0;
    for (int lane = a; lane < b; ++lane) {
      const int q = f_next.x, node = f_next.y;
      const Row row = r_next;
      const int pcode = c_next;
      if (lane + 1 < b) {
        f_next = f_after;
        r_next = row_of(f_next.y);
        if (kCode) c_next = code_at(lane + 1);
      }
      if (lane + 2 < b) f_after = pair_at(lane + 2);
      if (streamed) {   // mark the lane's window (runs share windows)
        const int x = max(node - off_l, 0);
        const int w = min(wshift >= 0 ? x >> wshift : x / wsub, nwin - 1);
        if (w != last_w) {
          last_w = w;
          int* word = win_p + (w >> 5);
          const int bit = 1 << (w & 31);
          if (!(*(volatile int*)word & bit)) atomicOr(word, bit);
        }
      }
      const int ql = q - q_base;
      const NodeRow nr = decode_row(row, level, pcode);
      float node_c[3];
      node_centre_xyz(nr.xyz, lo0, lo1, lo2, cell, node_c);
      SactObb ob;
      sact_obb(obb_s + ql * 15, &ob);
      const float tv[3] = {ob.c[0] - node_c[0], ob.c[1] - node_c[1],
                           ob.c[2] - node_c[2]};
      const float ah[3] = {node_h, node_h, node_h};
      bool hit;
      const int exit_code =
          sact_tile<USE_SPHERES, SactMode::kStraight>(ob, tv, ah, &hit);
      const bool is_term = nr.full || leaf_level;
      const int mask = (hit && !is_term) ? (nr.child_mask & 0xff) : 0;
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
          const Row* rows = meta_l + n_max + nr.child_start;
          asm volatile("prefetch.global.L1 [%0];" :: "l"(rows));
          asm volatile("prefetch.global.L1 [%0];"
                       :: "l"(rows + __popc(mask) - 1));
        }
        const int2 st = make_int2(mask | (ql << 8), nr.child_start);
        if (lane == a) {
          first = st;
          first_code = nr.code;
        } else {
          stash[lane] = st;
          if (kCode) stash_code[lane] = nr.code;
        }
      }
    }
    PERSIST_MARK(level, 1);
    nodes += n_live;
    if (leaf_level) break;   // no children: the level ends with phase A
    cluster.sync();          // every rank's folds, counts and windows
    PERSIST_MARK(level, 2);
    win_sum(p, off_l, cnt_l);

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
        const int code = kCode ? (lane == a ? first_code : stash_code[lane])
                               : 0;
        for (int k = max(w - off, 0); k < c && off + k < w_end; ++k) {
          stage[off + k - w] = make_int2(q, s.y + k);
          if (kCode) stage_code[off + k - w] = code;
        }
        off += c;
      }
      __syncthreads();
      // nothing leaves the stage while the next level reads it there and
      // no child of this CTA spills
      const int n_w = (own_next && base + block_total <= fcap)
                          ? 0 : min(kStage, block_total - w);
      for (int k = tid; k < n_w; k += kThreads) {
        const int pos = base + w + k;
        if (pos >= fcap) {
          ring[((unsigned)cursor + (unsigned)(pos - fcap)) % (unsigned)ring_cap]
              = stage[k];
        } else if (!own_next) {
          nxt[pos] = stage[k];
          if (kCode) nxt_code[pos] = stage_code[k];
        }
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
  if (streamed) {   // the leaf level's windows
    win_sum(fold_p, args.off[scene * L + fold_level],
            args.cnt[scene * L + fold_level]);
    meta_rows = __reduce_add_sync(kFull, meta_rows);
    if ((tid & 31) == 0) atomicAdd(&s_meta, meta_rows);
    __syncthreads();
  }
  for (int i = tid; i < bq; i += kThreads)
    args.best_out[(int64_t)t * bq + i] = fin[i];
  if (tid < kExitCodes) args.hist_out[t * kExitCodes + tid] = hist[tid];
  if (tid == 0) {
    int* sc = args.scalars_out + t * 8;
    sc[0] = nodes;
    sc[1] = s_leaf;
    sc[2] = s_axis;
    sc[3] = nodes * 15;
    sc[4] = USE_SPHERES ? 2 * nodes : 0;
    sc[5] = overflow;
    sc[6] = overflow;  // spilled pairs
    sc[7] = s_meta;    // meta rows streamed: 0 in the resident layout
  }
}

cudaLaunchConfig_t launch_config(int num_tiles, size_t smem, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_tiles * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch (num_tiles > 0), or with occupancy != nullptr report how many
// clusters of this shape the card holds at once.  A failed call's error is
// also the runtime's last error, which cudaGetLastError returns and
// clears, so that no later launch reports it.
template <bool USE_SPHERES, int FMT, bool STREAM>
int run(const PersistArgs& a, int num_tiles, cudaStream_t s, int* occupancy) {
  auto* kernel = persist_kernel<USE_SPHERES, FMT, STREAM>;
  const size_t smem = smem_bytes(a.bq, FMT);
  if (smem <= 48 * 1024 ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        launch_config(max(num_tiles, 1), smem, s, attr);
    if (occupancy != nullptr)
      cudaOccupancyMaxActiveClusters(occupancy, kernel, &cfg);
    else
      cudaLaunchKernelEx(&cfg, kernel, a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int run_format(const PersistArgs& a, int num_tiles, cudaStream_t s,
               int use_spheres, int* occupancy) {
  if (a.streamed)
    return use_spheres ? run<true, FMT, true>(a, num_tiles, s, occupancy)
                       : run<false, FMT, true>(a, num_tiles, s, occupancy);
  return use_spheres ? run<true, FMT, false>(a, num_tiles, s, occupancy)
                     : run<false, FMT, false>(a, num_tiles, s, occupancy);
}

int dispatch(const PersistArgs& a, int num_tiles, cudaStream_t s,
             int use_spheres, int fmt, int* occupancy) {
  switch (fmt) {
    case kFp32: return run_format<kFp32>(a, num_tiles, s, use_spheres,
                                         occupancy);
    case kBf16: return run_format<kBf16>(a, num_tiles, s, use_spheres,
                                         occupancy);
    case kU8: return run_format<kU8>(a, num_tiles, s, use_spheres, occupancy);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// int32 words of one tile's workspace slice (the caller allocates
// num_tiles of them): `fmt` indexes META_FORMATS, `nwin` is the windows of
// a level under the streamed layout (0: resident).
extern "C" long long persist_work_words(int fcap, int fmt, int nwin) {
  return work_words(fcap, fmt, nwin);
}

extern "C" int persist_launch(const float* scal, const int* sot,
                              const int* nvalid, const float* obb,
                              const int* meta, const int* payload,
                              const int* owner, const int* off,
                              const int* cnt, int* best, int* per_level,
                              int* hist, int* scalars, int* ring, int* work,
                              int num_tiles, int bq, int fcap, int depth,
                              int n_max, int ring_cap, int use_spheres,
                              int fmt, int streamed, int wsub, void* stream) {
  if (num_tiles <= 0) return 0;
  if (streamed && wsub < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nwin = streamed ? (n_max + wsub - 1) / wsub : 0;
  int wshift = -1;
  if (streamed && (wsub & (wsub - 1)) == 0)
    for (wshift = 0; (1 << wshift) < wsub; ++wshift) {}
  const PersistArgs a = {scal, off, cnt, sot, nvalid, obb, meta, payload,
                         owner, best, per_level, hist, scalars, ring, work,
                         work_words(fcap, fmt, nwin), bq, fcap, depth, n_max,
                         ring_cap, streamed, streamed ? wsub : 0, nwin,
                         wshift};
  return dispatch(a, num_tiles, static_cast<cudaStream_t>(stream),
                  use_spheres, fmt, nullptr);
}

// The launch shape, for reports: out[0..3] = CTAs a cluster, threads a CTA,
// dynamic shared memory a CTA for `bq` slots of rows in format `fmt` with
// `nwin` windows a level (0: resident), and how many such clusters the
// card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int persist_shape(int bq, int fmt, int nwin, int* out) {
  PersistArgs a = {};
  a.bq = bq;
  a.streamed = nwin > 0;
  a.nwin = nwin;
  int clusters = 0;
  const int err = dispatch(a, 1, nullptr, 0, fmt, &clusters);
  out[0] = kCluster;
  out[1] = kThreads;
  out[2] = (int)smem_bytes(bq, fmt);
  out[3] = clusters;
  return err;
}
