// Ball query: for each query, the first k point indices (ascending) whose
// squared distance is at most r2, -1 padded, and count = min(hits, k).
//
// Replaces repro/kernels/ballquery/kernel.py::ballquery_kernel (built by
// make_ballquery_call).  The TPU kernel walks point tiles in order for a
// tile of queries, places hits with a cumsum and a one-hot reduction, and
// skips a point tile once every query of its tile is full (a lax.cond per
// tile).
//
// Bound on the H100: 9 fp32 operations a pair tested, and the clouds read
// once; at the encoder's shapes both are far below a microsecond.  What
// sets the time is the instructions a warp issues for each 32-point chunk
// (10 a lane for its point: 9 operations and a compare, which --fmad=false
// and the exact distance fix) and everything else it issues per chunk,
// and, for a ball that fills late or never, the chain of chunks it walks.
// The design:
//   a CTA of kThreads threads owns one cloud and a block of `qb` of its
//   queries (ops.py::query_block sizes the block so that the grid covers
//   every SM whenever batch x m allows it);
//   it stages the cloud in shared memory as structure-of-arrays (x[],
//   y[], z[]), in tiles of up to kTile points: a thread a point issues
//   three 4-byte asynchronous copies (cp.async), so any N and any
//   alignment take the same path; past one tile, the next tile's copies
//   are in flight (double-buffered) while the current one is walked;
//   each point lands in the slot that puts chunk c's point l at lane l's
//   c-th float of a trip, so a warp walks kChunks 32-point chunks a trip
//   with one vector load a coordinate, and its kChunks ballots are the
//   chunks' hit masks in ascending index order;
//   a trip issues all its loads and distances, then its ballots; the warp
//   adds their popcounts to its count and lane 0 logs the masks in shared
//   memory; the walk stops at k;
//   after the walk the warp places the logged hits: a lane a mask word,
//   one warp scan of the words' popcounts gives each word's first rank,
//   and each lane stores its word's hits below k, in ascending order;
//   with fewer queries than warps (qb < kWarps) a query's kWarps / qb
//   warps each walk a contiguous segment of the tile (of kSegTrips trips
//   at least: a shorter segment does not repay its barrier), and a prefix
//   over the segments' counts (shared memory, one barrier) gives each
//   segment's first rank, so one ball's walk takes a segment's trips; the
//   launch takes this instance (SPLIT) only where the first tile splits,
//   as the split's code alone slows a whole walk by ~4 % (PERF.md);
//   before a CTA walks its next tile, a block-wide vote
//   (__syncthreads_and) stops it once every query of its block holds k --
//   the reference's tile skip, per query block (the copies of the tile it
//   would walk next have landed by then and go unused).
//
// Squared distances are (dx*dx + dy*dy) + dz*dz with d = q - p, the
// reference body's order; the build uses --fmad=false.  r2 comes from the
// host as float32(radius * radius) of the double product, the reference's
// threshold.  Slots past the tile's last point hold NaN, which never hits.
// kChunks, kTile, kSplit and kSegTrips were chosen by timing;
// tools/ballquery_sact_variants.py builds copies of this file with other
// values.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;              // 32-point chunks a trip
constexpr int kTrip = 32 * kChunks;     // points a trip
constexpr int kTile = 2048;             // points a staged tile
constexpr int kLogWords = kTile / 32;   // hit masks of a tile, a warp
constexpr int kMaxBlock = 64;           // queries a CTA (ops.py's bound)
constexpr bool kSplit = true;           // below kWarps queries, split them
constexpr int kSegTrips = 2;            // trips a segment at least

static_assert(kChunks == 2 || kChunks == 4 || kChunks == 8,
              "kChunks: 2, 4 or 8 chunks a trip");
static_assert(kTile % kTrip == 0, "a tile is whole trips");

// Floats between one coordinate array of a buffer and the next: the
// tile's points rounded up to a trip, plus 4 so that the three arrays
// start on different banks (and stay 16-byte aligned).
__host__ __device__ constexpr int coord_stride(int n) {
  return ((n < kTile ? n : kTile) + kTrip - 1) / kTrip * kTrip + 4;
}

// Dynamic shared memory: the block's queries and counts, each warp's
// segment count and mask log, then one or two coordinate buffers.
__host__ __device__ constexpr int head_words(int qb) {
  return 4 * qb + ((qb + 3) & ~3) + kWarps + kWarps * kLogWords;
}

size_t smem_bytes(int n, int qb) {
  const int buffers = n > kTile ? 2 : 1;
  return sizeof(float) * ((size_t)head_words(qb)
                          + (size_t)buffers * 3 * coord_stride(n));
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

// The slot of a tile's point p: chunk c's point l of a trip sits at lane
// l's c-th float of that trip.
__device__ __forceinline__ int slot_of(int p) {
  return (p & ~(kTrip - 1)) | ((p & 31) * kChunks) | ((p & (kTrip - 1)) >> 5);
}

// Issue the copies of points [p0, p0 + nt) of `cloud` into `buf` (x at 0,
// y at stride, z at 2 * stride), and NaN into the slots up to the next
// whole trip.
__device__ __forceinline__ void stage_tile(float* buf, int stride,
                                           const float* cloud, int p0,
                                           int nt) {
  for (int p = threadIdx.x; p < nt; p += kThreads) {
    const float* src = cloud + 3 * ((int64_t)p0 + p);
    const int slot = slot_of(p);
    copy_async4(buf + slot, src);
    copy_async4(buf + stride + slot, src + 1);
    copy_async4(buf + 2 * stride + slot, src + 2);
  }
  const int pad = (nt + kTrip - 1) / kTrip * kTrip;
  for (int p = nt + threadIdx.x; p < pad; p += kThreads) {
    const int slot = slot_of(p);
    buf[slot] = buf[stride + slot] = buf[2 * stride + slot] = CUDART_NAN_F;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void load_chunks(const float* a, float* v) {
  if constexpr (kChunks == 2) {
    const float2 x = *reinterpret_cast<const float2*>(a);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int h = 0; h < kChunks; h += 4) {
      const float4 x = *reinterpret_cast<const float4*>(a + h);
      v[h] = x.x;
      v[h + 1] = x.y;
      v[h + 2] = x.z;
      v[h + 3] = x.w;
    }
  }
}

// One query's walk over trips [tr0, tr1) of a staged tile, until it has
// `need` hits.  Lane 0 logs each trip's chunk masks in `log`; returns the
// hits and sets *trips to the trips walked.
__device__ __forceinline__ int walk(const float* buf, int stride, int tr0,
                                    int tr1, float4 q, float r2, int need,
                                    unsigned* log, int* trips) {
  const int lane = threadIdx.x & 31;
  int own = 0, tr = tr0;
  for (; tr < tr1 && own < need; ++tr) {
    const int j = tr * kTrip + kChunks * lane;
    float x[kChunks], y[kChunks], z[kChunks];
    load_chunks(buf + j, x);
    load_chunks(buf + stride + j, y);
    load_chunks(buf + 2 * stride + j, z);
    bool hit[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const float dx = q.x - x[c], dy = q.y - y[c], dz = q.z - z[c];
      float d2 = dx * dx;
      d2 = d2 + dy * dy;
      d2 = d2 + dz * dz;
      hit[c] = d2 <= r2;
    }
    unsigned mask[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      mask[c] = __ballot_sync(kFull, hit[c]);
      own += __popc(mask[c]);
    }
    if (lane == 0) {
      unsigned* at = log + (tr - tr0) * kChunks;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) at[c] = mask[c];
    }
  }
  *trips = tr - tr0;
  return own;
}

// Store the hits of the warp's `words` logged masks, in ascending order,
// at ranks rank0, rank0 + 1, ... below k; word w's bit b is point
// point0 + 32 * w + b.
__device__ __forceinline__ void place(const unsigned* log, int words,
                                      int rank0, int k, int point0,
                                      int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  __syncwarp();   // lane 0's log is visible to the warp
  for (int w0 = 0; w0 < words && rank0 < k; w0 += 32) {
    const int w = w0 + lane;
    unsigned m = w < words ? log[w] : 0u;
    const int c = __popc(m);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    for (int r = rank0 + incl - c; m != 0u && r < k; ++r) {
      out[r] = point0 + 32 * w + __ffs(m) - 1;
      m &= m - 1u;
    }
    rank0 += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();   // the log is free for the next walk
}

template <bool SPLIT>
__global__ void __launch_bounds__(kThreads) ballquery_kernel(
    const float* __restrict__ queries, const float* __restrict__ points,
    int m, int n, int qb, float r2, int k, int* __restrict__ idx,
    int* __restrict__ count) {
  extern __shared__ float4 smem4[];
  float4* q_s = smem4;                                   // [qb]
  int* cnt_s = reinterpret_cast<int*>(q_s + qb);         // [qb]
  int* seg_s = cnt_s + ((qb + 3) & ~3);                  // [kWarps]
  unsigned* logs = reinterpret_cast<unsigned*>(seg_s + kWarps);
  float* bufs = reinterpret_cast<float*>(smem4) + head_words(qb);
  const int stride = coord_stride(n);
  const int per_cloud = (m + qb - 1) / qb;
  const int b = blockIdx.x / per_cloud;
  const int m0 = (blockIdx.x - b * per_cloud) * qb;
  const int nq = min(qb, m - m0);
  const int64_t q0 = (int64_t)b * m + m0;     // the block's first query
  const float* cloud = points + (int64_t)b * n * 3;
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 0) stage_tile(bufs, stride, cloud, 0, min(n, kTile));
  for (int i = threadIdx.x; i < nq; i += kThreads) {
    const float* qp = queries + 3 * (q0 + i);
    q_s[i] = make_float4(qp[0], qp[1], qp[2], 0.0f);
    cnt_s[i] = 0;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* log = logs + warp * kLogWords;
  bool full = false;   // every query of this warp holds k
  for (int t = 0; t < tiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile t has landed, every warp is done with tile t - 1, and the block
    // stops once every query holds k
    if (__syncthreads_and(full)) break;
    if (t + 1 < tiles) {
      const int p1 = (t + 1) * kTile;
      stage_tile(bufs + ((t + 1) & 1) * 3 * stride, stride, cloud, p1,
                 min(n - p1, kTile));
    }
    const float* buf = bufs + (t & 1) * 3 * stride;
    const int trips = (min(n - t * kTile, kTile) + kTrip - 1) / kTrip;
    // warps a query, each walking a segment of at least kSegTrips trips
    const int split =
        SPLIT ? min(kWarps / qb, max(trips / kSegTrips, 1)) : 1;
    full = true;
    if (split == 1) {
      for (int ql = warp; ql < nq; ql += kWarps) {
        const int have = cnt_s[ql];
        if (have < k) {
          int walked;
          const int own = walk(buf, stride, 0, trips, q_s[ql], r2, k - have,
                               log, &walked);
          place(log, walked * kChunks, have, k, t * kTile,
                idx + (q0 + ql) * k);
          if (lane == 0) cnt_s[ql] = have + own;
          full = full && have + own >= k;
        }
      }
    } else {
      const int ql = warp / split, s = warp - ql * split;
      const int seg = (trips + split - 1) / split;
      const int tr0 = min(s * seg, trips), tr1 = min(tr0 + seg, trips);
      const int have = ql < nq ? cnt_s[ql] : k;
      int own = 0, walked = 0;
      if (have < k) {
        own = walk(buf, stride, tr0, tr1, q_s[ql], r2, k - have, log,
                   &walked);
      }
      if (lane == 0) seg_s[warp] = own;
      __syncthreads();
      if (have < k) {
        int before = 0, total = 0;
        for (int i = 0; i < split; ++i) {
          const int c = seg_s[ql * split + i];
          before += i < s ? c : 0;
          total += c;
        }
        place(log, walked * kChunks, have + before, k,
              t * kTile + tr0 * kTrip, idx + (q0 + ql) * k);
        if (s == 0 && lane == 0) cnt_s[ql] = have + total;
        full = have + total >= k;
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int ql = warp; ql < nq; ql += kWarps) {
    const int cnt = min(cnt_s[ql], k);
    int* out = idx + (q0 + ql) * k;
    for (int s = cnt + lane; s < k; s += 32) out[s] = -1;
    if (lane == 0) count[q0 + ql] = cnt;
  }
}

}  // namespace

// queries (batch * m, 3) fp32, points (batch, n, 3) fp32; idx (batch * m,
// k) int32, count (batch * m,) int32; qb queries a CTA, 1 to kMaxBlock.
// Returns the launch error, if any.
extern "C" int ballquery_launch(const float* queries, const float* points,
                                int batch, int m, int n, float r2, int k,
                                int qb, int* idx, int* count, void* stream) {
  if (qb < 1 || qb > kMaxBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the split where the first tile gives a query's warps two segments at
  // least; elsewhere the instance without it (its code alone slows a walk)
  const int trips = ((n < kTile ? n : kTile) + kTrip - 1) / kTrip;
  auto* kernel = kSplit && 2 * qb <= kWarps && trips >= 2 * kSegTrips
                     ? ballquery_kernel<true> : ballquery_kernel<false>;
  const size_t smem = smem_bytes(n, qb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (int64_t)batch * ((m + qb - 1) / qb);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      queries, points, m, n, qb, r2, k, idx, count);
  return static_cast<int>(cudaGetLastError());
}
