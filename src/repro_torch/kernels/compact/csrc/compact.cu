// Stable stream compaction: pack the masked lanes of C int32 channels, in
// lane order, into the first count = min(total, n_out) slots of each
// output channel; survivors whose slot would be n_out or more are dropped,
// and every slot from count to n_out holds zero.
//
// Replaces repro/kernels/compact/kernel.py::compact_kernel (built by
// make_compact_call) together with its count-and-scan pass
// (repro/kernels/compact/ops.py::_compact_pallas).  The TPU kernel walks
// the blocks in order, so each block finds its output base in a running
// sum; here blocks run in parallel, and one launch does all of it in a
// single pass with decoupled look-back:
//
//   tickets   each CTA takes a tile id from an atomic ticket, so every
//             tile below a running CTA's has started: waiting on a
//             predecessor cannot deadlock.
//   lanes     a lane tile (256 threads x 32 lanes) reads its mask once, as
//             16-byte vectors; each thread's 32 lanes become a bit set,
//             and a block scan of their popcounts gives every survivor its
//             rank in the tile.  The tile publishes its count, then looks
//             back over its predecessors' status words (the whole block,
//             256 words a round) until it meets an inclusive prefix,
//             publishes its own inclusive prefix, and writes its survivors
//             below n_out in lane order: a channel at a time, each thread
//             puts its survivors' values at their ranks in a shared-memory
//             stage (a thread with more than 4 survivors reads its 32 lanes
//             as 16-byte vectors, one with fewer reads only its
//             survivors), and the block writes the tile's run of slots
//             with coalesced stores.
//             The last lane tile writes count.
//   tail      the tiles after the last lane tile wait for the total and
//             zero the slots [count, n_out) of their share of the output,
//             so no caller memset is needed.
//
// A status word is 64 bits, flag and value together, so one store
// publishes both: (generation << 2 | flag) above the 32-bit value, flag 1
// = the tile's own count, 2 = its inclusive prefix.  The words and the
// ticket are scratch that the wrapper keeps per device and stream and
// reuses.  The ticket is put back to 0 by the CTA that draws the last one
// (every CTA has drawn by then).  The words are not reset: each call
// carries a new generation, never 0, and a word of another generation
// reads as "not yet published", so a call needs no memset.  (A reset of
// the words by the last CTA would need to know that every look-back has
// finished reading, which no CTA knows.)
//
// Channels come by pointer, up to MAX_CH, each (n,) int32; the output is
// (channels, n_out) int32, channel-major.
//
// Bound on the H100: bytes -- the mask (1 B a lane) read once, the kept
// survivors' values read once and n_out slots a channel written once, a
// handful of integer operations a lane.  The design reads the mask once,
// reads values near survivors only, writes every slot once with
// coalesced stores, and is one launch with no memset, so a call costs the
// host one dispatch.  What it leaves (PERF.md): the tail CTAs wait for
// the last lane tile, and a frontier's survivors crowd into its first
// tiles, whose few CTAs do most of the work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 32;                     // lanes a thread
static_assert(kPerThread % 16 == 0 && kPerThread <= 32, "a bit a lane");
constexpr int kTile = kThreads * kPerThread;       // lanes a tile: 8192
constexpr int kZeroTile = kThreads * 16;           // tail slots a CTA
constexpr int kWarps = kThreads / 32;
constexpr int MAX_CH = 4;
constexpr unsigned long long kAggregate = 1, kInclusive = 2;

struct Channels {
  const int* in[MAX_CH];
};

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// A spin of more than ~10 s (a status word that never comes) traps, so it
// fails the launch instead of hanging the card.
__device__ __forceinline__ void spin_guard(long long start) {
  if (clock64() - start > 20000000000LL) __trap();
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long w) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(p) = w;
}

// 0 (not published in this generation), kAggregate or kInclusive.
__device__ __forceinline__ unsigned flag_of(unsigned long long w,
                                            unsigned gen) {
  const unsigned hi = static_cast<unsigned>(w >> 32);
  return (hi >> 2) == gen ? (hi & 3u) : 0u;
}

__device__ __forceinline__ unsigned long long make_status(
    unsigned long long flag, unsigned gen, unsigned value) {
  return ((static_cast<unsigned long long>(gen) << 2 | flag) << 32) | value;
}

// Bit i set when lane base + i is masked (kPerThread lanes, bytes 0/1).
__device__ __forceinline__ unsigned lane_bits(const uint8_t* __restrict__ mask,
                                              long long base, int n) {
  unsigned bits = 0;
  if (base + kPerThread <= n &&
      (reinterpret_cast<uintptr_t>(mask + base) & 15) == 0) {
#pragma unroll
    for (int v = 0; v < kPerThread / 16; ++v) {
      const uint4 x = *reinterpret_cast<const uint4*>(mask + base + 16 * v);
      const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // one bit a byte: byte b's low bit to bit b of the nibble
        const unsigned b = __vcmpne4(w[k], 0u) & 0x01010101u;
        bits |= ((b * 0x01020408u) >> 24 & 0xFu) << (16 * v + 4 * k);
      }
    }
  } else {
    for (int i = 0; i < kPerThread; ++i) {
      if (base + i < n && mask[base + i] != 0) bits |= 1u << i;
    }
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads) compact_kernel(
    const uint8_t* __restrict__ mask, Channels ch, int channels, int n,
    int n_out, int n_lane_tiles, int* __restrict__ out,
    int* __restrict__ count, unsigned long long* __restrict__ status,
    unsigned* __restrict__ ticket, unsigned gen) {
  __shared__ int tile_s, total_s;
  __shared__ int warp_sums[kWarps], near_s[kWarps], part_s[kWarps];
  __shared__ int stage_s[kTile];         // a channel's survivors, in order
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == gridDim.x - 1) atomicExch(ticket, 0u);   // every CTA has drawn
    tile_s = static_cast<int>(t);
  }
  __syncthreads();
  const int tile = tile_s;

  if (tile >= n_lane_tiles) {
    // ------------------------------------------------------------ tail --
    if (warp == 0) {
      int total = 0;
      if (n_lane_tiles > 0) {
        const unsigned long long* last = status + (n_lane_tiles - 1);
        const long long start = clock64();
        unsigned long long w;
        do {
          spin_guard(start);
          w = load_status(last);
        } while (flag_of(w, gen) != kInclusive);
        total = static_cast<int>(static_cast<unsigned>(w));
      } else if (tile == 0 && lane == 0) {
        *count = 0;                   // no lanes: the first CTA writes it
      }
      if (lane == 0) total_s = total;
    }
    __syncthreads();
    const int cnt = min(total_s, n_out);
    const long long lo = static_cast<long long>(tile - n_lane_tiles) *
                         kZeroTile;
    const long long hi = min(lo + kZeroTile, static_cast<long long>(n_out));
#pragma unroll
    for (int c = 0; c < MAX_CH; ++c) {
      if (c >= channels) break;
      int* o = out + static_cast<long long>(c) * n_out;
      for (long long s = max(lo, static_cast<long long>(cnt)) + tid; s < hi;
           s += kThreads) {
        o[s] = 0;
      }
    }
    return;
  }

  // ------------------------------------------------------------- lanes --
  const long long first = static_cast<long long>(tile) * kTile +
                          static_cast<long long>(tid) * kPerThread;
  unsigned bits = lane_bits(mask, first, n);
  const int mine = __popc(bits);
  int incl = mine;                       // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = incl - mine, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_sums[w];
    agg += warp_sums[w];
  }

  // Publish the count (tile 0: its inclusive prefix), then look back over
  // a window of kThreads predecessors a round, the nearest in thread 0,
  // until the window holds an inclusive prefix: a window's words are read
  // at once, so a tile waits on at most ceil(tile / kThreads) rounds, not
  // on a chain of its neighbours.
  if (tid == 0) {
    store_status(status + tile,
                 make_status(tile == 0 ? kInclusive : kAggregate, gen, agg));
  }
  int excl = 0;
  for (int j = tile - 1; j >= 0; j -= kThreads) {
    const int p = j - tid;
    unsigned long long w = 0;
    unsigned f = kInclusive;                 // before tile 0: 0, inclusive
    if (p >= 0) {
      const long long start = clock64();
      do {
        spin_guard(start);
        w = load_status(status + p);
        f = flag_of(w, gen);
      } while (f == 0);
    }
    const unsigned inc = __ballot_sync(0xffffffffu, f == kInclusive);
    if (lane == 0) near_s[warp] = inc ? warp * 32 + __ffs(inc) - 1 : kThreads;
    __syncthreads();
    int stop = kThreads;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) stop = min(stop, near_s[k]);
    // the counts up to the nearest inclusive prefix, and that prefix
    int part = tid <= stop ? static_cast<int>(static_cast<unsigned>(w)) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, o);
    }
    if (lane == 0) part_s[warp] = part;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWarps; ++k) excl += part_s[k];
    if (stop < kThreads) break;
  }
  if (tile > 0 && tid == 0) {
    store_status(status + tile, make_status(kInclusive, gen, excl + agg));
  }
  if (tile == n_lane_tiles - 1 && tid == 0) *count = min(excl + agg, n_out);

  // Survivors to their slots, one channel at a time: each thread puts its
  // survivors' values at their ranks in the tile's shared-memory stage
  // (a thread with many survivors -- a frontier's children sit side by
  // side -- reads its 32 lanes as eight 16-byte vectors), then the block
  // writes the tile's run of slots [excl, excl + agg) out with coalesced
  // stores.
  const int keep = min(agg, max(n_out - excl, 0));   // slots below n_out
  if (keep == 0) return;                 // (uniform across the block)
  const bool dense = __popc(bits) > 4 && first + kPerThread <= n;
#pragma unroll
  for (int c = 0; c < MAX_CH; ++c) {     // static indices: ch stays in
    if (c >= channels) break;            // registers, not local memory
    const int* in = ch.in[c] + first;
    if (dense && (reinterpret_cast<uintptr_t>(in) & 15) == 0) {
      int v[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread / 4; ++k) {
        *reinterpret_cast<int4*>(v + 4 * k) =
            *reinterpret_cast<const int4*>(in + 4 * k);
      }
      int r = before;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if ((bits >> i) & 1u) stage_s[r++] = v[i];
      }
    } else {
      int r = before;
      for (unsigned b = bits; b != 0; b &= b - 1) {
        stage_s[r++] = in[__ffs(b) - 1];
      }
    }
    __syncthreads();
    int* o = out + static_cast<long long>(c) * n_out + excl;
    for (int j = tid; j < keep; j += kThreads) o[j] = stage_s[j];
    __syncthreads();                     // the stage is rewritten next
  }
}

}  // namespace

// mask (n,) bytes 0/1; vals[c] (n,) int32 for c < channels <= 4; out
// (channels, n_out) int32, written in full (zero past count); count (1,)
// int32.  status holds at least max(ceil(n / 8192), 1) 64-bit words and
// ticket one 32-bit word, both reused across calls on one stream: ticket
// 0 before the first call (the launch leaves it 0), status words of
// generations other than gen (gen in [1, 2**30)).  One launch.  Returns
// the launch error, if any.
extern "C" int compact_launch(const uint8_t* mask, const int* const* vals,
                              int channels, int n, int n_out, int* out,
                              int* count, unsigned long long* status,
                              unsigned* ticket, unsigned gen, void* stream) {
  if (channels < 0 || channels > MAX_CH || n < 0 || n_out < 0 || gen == 0 ||
      gen >= (1u << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Channels ch{};
  for (int c = 0; c < channels; ++c) ch.in[c] = vals[c];
  const int n_lane_tiles = (n + kTile - 1) / kTile;
  const int n_zero_tiles = (n_out + kZeroTile - 1) / kZeroTile;
  const int grid = n_lane_tiles + n_zero_tiles > 0
                       ? n_lane_tiles + n_zero_tiles : 1;
  compact_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mask, ch, channels, n, n_out, n_lane_tiles, out, count, status, ticket,
      gen);
  return static_cast<int>(cudaGetLastError());
}
