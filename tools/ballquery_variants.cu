// The ball-query kernel of the parent design, built and timed beside the
// shipped src/repro_torch/kernels/ballquery/csrc/ballquery.cu by
// tools/ballquery_sact_variants.py: one warp a query walking its cloud
// from device memory, 32 points a trip, each trip's loads behind the last
// trip's exit test.  Its outputs equal the plain version's, index for
// index.  Built with the port's nvcc flags (--fmad=false).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) bq_parent(
    const float* __restrict__ queries, const float* __restrict__ points,
    int total, int m, int n, float r2, int k, int* __restrict__ idx,
    int* __restrict__ count) {
  const int64_t q = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
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

// Arguments as ballquery_launch's, without qb.
extern "C" int bq_parent_launch(const float* queries, const float* points,
                                int batch, int m, int n, float r2, int k,
                                int* idx, int* count, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  const int total = batch * m;
  bq_parent<<<(total + kWarps - 1) / kWarps, kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(queries, points, total, m,
                                                   n, r2, k, idx, count);
  return static_cast<int>(cudaGetLastError());
}
