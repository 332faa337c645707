// Stable stream compaction: pack the masked lanes of C int32 channels, in
// lane order, into the first count = min(total, n_out) slots of each
// output channel; survivors whose slot would be n_out or more are dropped.
//
// Replaces repro/kernels/compact/kernel.py::compact_kernel (built by
// make_compact_call) together with its count-and-scan pass
// (repro/kernels/compact/ops.py::_compact_pallas).  The TPU kernel walks
// the blocks in order and stores a one-hot-reduced window per block; on
// the GPU blocks run in parallel, so the pass that gives every block its
// output base runs first:
//   count    one block per 256 lanes: __ballot_sync + __popc per warp
//   scan     one block: exclusive scan of the block counts in place, with
//            a running carry over chunks of 1024; writes count
//   scatter  one block per 256 lanes re-scans its own mask in lane order
//            (ballot, popc of the lower lanes, warp offsets in shared
//            memory) and writes each survivor with slot < n_out.
// No device-wide library primitive is used.  The caller zero-fills the
// output, so slots past count hold zeros.
//
// Channels are channel-major: vals (C, n), out (C, n_out).
//
// Bound on the H100: bytes -- the mask (1 B a lane) and the surviving rows
// are read once and the survivors written once, a handful of integer
// operations a lane.  The design reads the mask twice (count, scatter;
// the second read hits L2 at frontier sizes) and touches a channel value
// only for survivors.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;          // lanes per block (the TPU kernel's bn)
constexpr int kWarps = kBlock / 32;
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kBlock) count_kernel(
    const uint8_t* __restrict__ mask, int n, int* __restrict__ blk) {
  __shared__ int warp_counts[kWarps];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool m = i < n && mask[i] != 0;
  const unsigned bits = __ballot_sync(0xffffffffu, m);
  if (lane == 0) warp_counts[warp] = __popc(bits);
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_counts[w];
    blk[blockIdx.x] = s;
  }
}

// Exclusive scan of blk[0..nblk) in place; *count = min(total, n_out).
__global__ void __launch_bounds__(kScanThreads) scan_kernel(
    int* __restrict__ blk, int nblk, int n_out, int* __restrict__ count) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int c0 = 0; c0 < nblk; c0 += kScanThreads) {
    const int i = c0 + threadIdx.x;
    const int v = i < nblk ? blk[i] : 0;
    int x = v;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    if (i < nblk) blk[i] = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
  if (threadIdx.x == 0) *count = min(carry, n_out);
}

__global__ void __launch_bounds__(kBlock) scatter_kernel(
    const uint8_t* __restrict__ mask, const int* __restrict__ vals, int n,
    int channels, const int* __restrict__ base, int n_out,
    int* __restrict__ out) {
  __shared__ int warp_counts[kWarps];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool m = i < n && mask[i] != 0;
  const unsigned bits = __ballot_sync(0xffffffffu, m);
  if (lane == 0) warp_counts[warp] = __popc(bits);
  __syncthreads();
  if (!m) return;
  int pos = base[blockIdx.x] + __popc(bits & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) pos += warp_counts[w];
  if (pos >= n_out) return;
  for (int c = 0; c < channels; ++c) {
    out[(int64_t)c * n_out + pos] = vals[(int64_t)c * n + i];
  }
}

}  // namespace

// mask (n,) bytes 0/1; vals (channels, n) int32; out (channels, n_out)
// int32, zero-filled by the caller; blk (ceil(n / 256),) int32 scratch;
// count (1,) int32.  Returns the launch error, if any.
extern "C" int compact_launch(const uint8_t* mask, const int* vals, int n,
                              int channels, int n_out, int* blk, int* out,
                              int* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (n + kBlock - 1) / kBlock;
  if (nblk > 0) count_kernel<<<nblk, kBlock, 0, s>>>(mask, n, blk);
  scan_kernel<<<1, kScanThreads, 0, s>>>(blk, nblk, n_out, count);
  if (nblk > 0 && n_out > 0) {
    scatter_kernel<<<nblk, kBlock, 0, s>>>(mask, vals, n, channels, blk,
                                           n_out, out);
  }
  return static_cast<int>(cudaGetLastError());
}
