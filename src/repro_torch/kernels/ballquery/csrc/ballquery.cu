// Ball query: for each query, the first k point indices (ascending) whose
// squared distance is at most r2, -1 padded, and count = min(hits, k).
//
// Replaces repro/kernels/ballquery/kernel.py::ballquery_kernel (built by
// make_ballquery_call).  The TPU kernel walks point tiles in order for a
// tile of queries, places hits with a cumsum and a one-hot reduction, and
// skips a point tile only once every query of its tile is full (a
// lax.cond per tile).  Here one warp owns one query and walks the cloud
// in ascending 32-point chunks: each lane tests one point, __ballot_sync
// gathers the chunk's hits and __popc of the lower lanes gives each hit
// its rank, so hits land in ascending index order.  The warp stops as soon
// as its query holds k -- the per-query conditional return of the
// paper's ball query on RoboCore (section IV), finer than the TPU's
// per-tile skip.  The grid covers batch * m queries, 8 warps a block.
//
// Squared distances are (dx*dx + dy*dy) + dz*dz with d = q - p, the
// reference body's order; the build uses --fmad=false.  r2 comes from the
// host as float32(radius * radius) of the double product, the
// reference's threshold.
//
// Bound on the H100: bytes and operations both scale with the pairs a
// query must test before its k-th hit (9 fp32 operations a pair); the
// clouds are read from L2 by many queries, so at the encoder's shapes
// the time is set by the pairs tested and the chunk loop's latency, not
// by device-memory bytes.  Early exit keeps the tested pairs to what the
// data needs; neighbouring lanes read neighbouring points.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / 32;

__global__ void __launch_bounds__(kBlock) ballquery_kernel(
    const float* __restrict__ queries, const float* __restrict__ points,
    int total, int m, int n, float r2, int k, int* __restrict__ idx,
    int* __restrict__ count) {
  const int64_t q = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= total) return;  // the whole warp leaves together
  const float qx = queries[3 * q], qy = queries[3 * q + 1],
              qz = queries[3 * q + 2];
  const float* p = points + (q / m) * (int64_t)n * 3;
  int* out = idx + q * k;
  const unsigned lower = (1u << lane) - 1u;
  int cnt = 0;
  for (int c0 = 0; c0 < n && cnt < k; c0 += 32) {
    const int j = c0 + lane;
    bool hit = false;
    if (j < n) {
      const float dx = qx - p[3 * j], dy = qy - p[3 * j + 1],
                  dz = qz - p[3 * j + 2];
      float d2 = dx * dx;
      d2 = d2 + dy * dy;
      d2 = d2 + dz * dz;
      hit = d2 <= r2;
    }
    const unsigned bits = __ballot_sync(kFull, hit);
    const int rank = cnt + __popc(bits & lower);
    if (hit && rank < k) out[rank] = j;
    cnt += __popc(bits);
  }
  cnt = min(cnt, k);
  for (int s = cnt + lane; s < k; s += 32) out[s] = -1;
  if (lane == 0) count[q] = cnt;
}

}  // namespace

// queries (batch * m, 3) fp32, points (batch, n, 3) fp32; idx (batch * m,
// k) int32, count (batch * m,) int32.  Returns the launch error, if any.
extern "C" int ballquery_launch(const float* queries, const float* points,
                                int batch, int m, int n, float r2, int k,
                                int* idx, int* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * m;
  const int blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    ballquery_kernel<<<blocks, kBlock, 0, s>>>(queries, points, total, m, n,
                                               r2, k, idx, count);
  }
  return static_cast<int>(cudaGetLastError());
}
