// Variants of the ray-march kernel (src/repro_torch/kernels/march/csrc/
// march.cu), built and timed beside it by tools/march_variants.py.  The
// shipped source is included, so every variant of its design is an
// instance of the shipped template; each keeps the reference's order and
// roundings step by step, so every variant's outputs equal the shipped
// kernel's bit for bit.  What differs:
//   serial        the first design: one thread a ray, a serial loop whose
//                 every step waits on its divides and its grid load, CTAs
//                 of 128 threads
//   <L>x<G>/<grid> the shipped design with L lanes a ray and G steps a lane
//                 a round, the grid read through L1 ("l1"), copied into
//                 shared memory as bytes ("bytes", cp.async) or as bits
//                 ("bits", packed from 16-byte loads), about one CTA an SM
//                 or a fixed CTA size
// Built with the port's nvcc flags (--fmad=false, as the shipped kernel).
#include "../src/repro_torch/kernels/march/csrc/march.cu"

namespace {

__global__ void __launch_bounds__(128)
    march_serial_kernel(const uint8_t* __restrict__ occ, int H, int W,
                        float ox, float oy, float cell, float max_range,
                        float2* __restrict__ pos,
                        const float2* __restrict__ dirv,
                        float* __restrict__ dist,
                        uint8_t* __restrict__ active, int R, int n_steps) {
  const int r = blockIdx.x * 128 + threadIdx.x;
  if (r >= R || !active[r]) return;
  float2 p = pos[r];
  const float2 d = dirv[r];
  float t = dist[r];
  bool live = true;
  for (int s = 0; s < n_steps && live; ++s) {
    const float nx = __fadd_rn(p.x, __fmul_rn(d.x, cell));
    const float ny = __fadd_rn(p.y, __fmul_rn(d.y, cell));
    const int i =
        static_cast<int>(floorf(__fdiv_rn(__fsub_rn(nx, ox), cell)));
    const int j =
        static_cast<int>(floorf(__fdiv_rn(__fsub_rn(ny, oy), cell)));
    const bool inb = i >= 0 && i < H && j >= 0 && j < W;
    const bool blocked =
        !inb || __ldg(occ + static_cast<int64_t>(i) * W + j) != 0;
    const float nt = __fadd_rn(t, cell);
    live = !(blocked || nt >= max_range);
    p = make_float2(nx, ny);
    t = nt;
  }
  pos[r] = p;
  dist[r] = t;
  active[r] = live ? 1 : 0;
}

// Four bytes -> four bits (byte m nonzero -> bit m).
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// The grid copied into shared memory as bits, packed from 16-byte loads
// (occ 16-byte aligned).
struct BitsGrid {
  const uint8_t* occ;
  int H, W;
  __device__ __forceinline__ void begin(uint8_t* s) const {
    uint32_t* words = reinterpret_cast<uint32_t*>(s);
    const int n = H * W, nw = (n + 31) / 32;
    for (int k = threadIdx.x; k < nw; k += blockDim.x) {
      uint32_t bits = 0;
      if (32 * k + 32 <= n) {
        const uint4* v = reinterpret_cast<const uint4*>(occ + 32 * k);
        const uint4 a = __ldg(v), b = __ldg(v + 1);
        bits = pack4(a.x) | pack4(a.y) << 4 | pack4(a.z) << 8 |
               pack4(a.w) << 12 | pack4(b.x) << 16 | pack4(b.y) << 20 |
               pack4(b.z) << 24 | pack4(b.w) << 28;
      } else {
        for (int m = 0; 32 * k + m < n; ++m)
          bits |= (occ[32 * k + m] != 0 ? 1u : 0u) << m;
      }
      words[k] = bits;
    }
  }
  __device__ __forceinline__ void end() const { __syncthreads(); }
  __device__ __forceinline__ bool occupied(const uint8_t* s, int i,
                                           int j) const {
    const int k = i * W + j;
    return (reinterpret_cast<const uint32_t*>(s)[k >> 5] >> (k & 31)) & 1u;
  }
};

template <class Grid>
int launch_cfg(int cfg, const Grid& grid, const Rays& q, int threads,
               size_t smem, cudaStream_t st) {
  switch (cfg) {
    case 0: launch_march<1, 4>(grid, q, threads, smem, st); break;
    case 1: launch_march<4, 4>(grid, q, threads, smem, st); break;
    case 2: launch_march<8, 1>(grid, q, threads, smem, st); break;
    case 3: launch_march<8, 2>(grid, q, threads, smem, st); break;
    case 4: launch_march<8, 4>(grid, q, threads, smem, st); break;
    case 5: launch_march<16, 1>(grid, q, threads, smem, st); break;
    case 6: launch_march<16, 2>(grid, q, threads, smem, st); break;
    case 7: launch_march<32, 1>(grid, q, threads, smem, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// which 0: the serial design; which 1 + 8 * route + cfg: the shipped design
// at launch_cfg's (lanes, steps) cfg over route 0 (L1), 1 (bytes in shared
// memory), 2 (bits in shared memory).  threads: a CTA's (0: about one CTA
// an SM; the serial design always runs 128).  The rest as march_launch.
extern "C" int variant_launch(int which, int threads, const uint8_t* occ,
                              int H, int W, float ox, float oy, float cell,
                              float max_range, float* pos, const float* dirv,
                              float* dist, uint8_t* active, int R,
                              int n_steps, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    march_serial_kernel<<<(R + 127) / 128, 128, 0, st>>>(
        occ, H, W, ox, oy, cell, max_range, reinterpret_cast<float2*>(pos),
        reinterpret_cast<const float2*>(dirv), dist, active, R, n_steps);
    return static_cast<int>(cudaGetLastError());
  }
  const Rays q{ox, oy, cell, max_range, reinterpret_cast<float2*>(pos),
               reinterpret_cast<const float2*>(dirv), dist, active, R,
               n_steps};
  const int route = (which - 1) / 8, cfg = (which - 1) % 8;
  const int64_t cells = static_cast<int64_t>(H) * W;
  const bool aligned = reinterpret_cast<uintptr_t>(occ) % 16 == 0;
  int err = 0;
  if (route == 0)
    err = launch_cfg(cfg, GlobalGrid{occ, H, W}, q, threads, 0, st);
  else if (route == 1 && cells <= kStageMax && aligned)
    err = launch_cfg(cfg, SharedGrid{occ, H, W}, q, threads,
                     (cells + 15) / 16 * 16, st);
  else if (route == 2 && cells <= 8 * kStageMax && aligned)
    err = launch_cfg(cfg, BitsGrid{occ, H, W}, q, threads,
                     (cells + 31) / 32 * 4, st);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  return err ? err : static_cast<int>(cudaGetLastError());
}

// The serial design with march_launch's signature, for timing its call
// through the port's wrapper.
extern "C" int serial_launch(const uint8_t* occ, int H, int W, float ox,
                             float oy, float cell, float max_range,
                             float* pos, const float* dirv, float* dist,
                             uint8_t* active, int R, int n_steps,
                             void* stream) {
  if (H < 1 || W < 1 || R < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R > 0 && n_steps > 0)
    return variant_launch(0, 128, occ, H, W, ox, oy, cell, max_range, pos,
                          dirv, dist, active, R, n_steps, stream);
  return static_cast<int>(cudaGetLastError());
}
