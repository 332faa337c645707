// RWKV-6 WKV recurrence, backward: for each batch*head row, with
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,       w_t = exp(logw_t), S_{-1} = 0
//   o_t = r_t S_{t-1} + (r_t . (u (.) k_t)) v_t
//
// and the gradients do_t of every output (and dS, the gradient of the final
// state S_{T-1}, where the caller has one), the gradients of every input.
// With G_t the gradient of S_t (G_{T-1} = dS, else 0), walking t down from
// T - 1:
//
//   dr_t    = S_{t-1} do_t + u (.) k_t (do_t . v_t)
//   dk_t    = G_t v_t      + r_t (.) u (do_t . v_t)
//   dv_t    = G_t^T k_t    + (r_t . (u (.) k_t)) do_t
//   dlogw_t = w_t (.) rowsum(G_t (.) S_{t-1})
//   du     += r_t (.) k_t (do_t . v_t)
//   G_{t-1} = diag(w_t) G_t + r_t do_t^T
//
// (kernels/wkv6/ref.py::wkv6_bwd_ref is this recurrence in PyTorch).
//
// Replaces no TPU kernel: the reference has no backward kernel and trains
// by differentiating its lax.scan (repro/kernels/wkv6/ref.py::wkv6_ref).
// This kernel carries the gradient of the forward of
// repro/kernels/wkv6/kernel.py::wkv6_kernel (csrc/wkv6.cu here).
//
// Every decay is taken as it comes, w_t = exp(logw_t) <= 1 multiplying a
// state or a gradient, never divided out or taken as the exponential of a
// difference of cumsums, so strong decays (w underflowing to 0) lose nothing:
// dlogw_t is w_t times the sum it multiplies, exactly as the recurrence says.
//
// Design on the H100 (simple first; making it fast is later work):
//   one CTA per row, 4 threads a state row: thread (i, q) holds S[i, j] and
//   G[i, j] for the DP/4 columns j = 4c + q in registers (DP: D rounded up
//   to 16, 32, 64 or 128), so every sum over j is its own columns and two
//   shuffles; no barrier inside a step
//   three walks over the sequence, chunk by chunk (C steps: r, k, v, do and
//   w of a chunk staged in shared memory as fp32, with the two dot products
//   a step needs, do . v and r . (u (.) k)):
//     F  forward: S from 0, dr_t, and S at each chunk's start into a
//        workspace (a thread's own elements)
//     B1 backward: G from dS; each chunk recomputes its C states S_{t-1}
//        from the workspace into the thread's own slots of shared memory,
//        then dk_t, dlogw_t and the row's du in reverse
//     B2 backward, transposed: thread (j, q) holds G[i, j] for i = 4c + q,
//        so dv_t's sum over i is its own; it needs no S
//   du is summed over the rows that share a bonus row by a second, small
//   kernel in a fixed order: no atomics, so two runs give the same bits
//
// Bound on the H100: at B 8 x H 32 rows of T = 1024 steps, D = 64, bf16,
// its bytes (r, k, v, do, logw read and dr, dk, dv, dlogw written once)
// take 0.110 ms at 3.35 TB/s; a chunked backward's products would take
// 0.079 ms on the tensor cores (3xTF32), so the bytes bound it, as they do
// the forward (chip_smoke.py::wkv6_bwd_bound).  This step form's own 14
// D^2 + 12 D fp32 operations a row and step would take 0.227 ms at 67
// TFLOP/s; it runs ~20 D^2 a step with its recomputes, but what holds it
// is the sequential dependence: each of a pass's T steps waits on the one
// before, and a row runs on one CTA (3.4 ms there, chip_smoke.py phase
// 27).
//
// Summation: per thread in column order, then the two shuffles; the plain
// version sums in einsum order, so the two agree to a tolerance
// (kernels/wkv6/cases.py::TOL).  The build keeps --fmad=false.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The sum of x over the 4 threads of a state row (lanes 4a .. 4a + 3).
__device__ __forceinline__ float sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// DP: the padded width; C: steps a chunk, so that a chunk's C states of the
// thread's own elements (C * DP * DP floats) take at most 128 KB of shared
// memory.
template <int DP>
struct Cfg {
  static constexpr int NTH = 4 * DP;                 // threads
  static constexpr int NC = DP / 4;                  // columns a thread
  static constexpr int C = DP <= 32 ? 32 : 32768 / (DP * DP);
  static constexpr int NW = NTH / 32;                // warps
  // shared memory, in floats: r, k, v, do, w and two output buffers, each
  // (C, DP); the two dots (C each); the chunk's states (C, NC, NTH)
  static constexpr int IN = C * DP;
  static constexpr int SMEM_F = 7 * IN + 2 * C + C * NC * NTH;
  static constexpr int SMEM = 4 * SMEM_F;
};

template <typename In, int DP>
struct Row {
  const In* r;
  const In* k;
  const In* v;
  const In* dout;
  const float* logw;
  const float* u;   // the row's bonus row, unit stride
  int64_t st;       // step stride (elements)
  int T, D;
};

// Stage steps t0 .. t0 + C - 1 of the row (zeros past T and past D; w = 1
// there, which leaves a state alone), then the two dots of each step.
template <typename In, int DP>
__device__ void stage(const Row<In, DP>& row, int t0, float* sr, float* sk,
                      float* sv, float* sd, float* sw, float* dov,
                      float* rku, const float* su) {
  using K = Cfg<DP>;
  __syncthreads();  // the previous chunk is done with the buffers
  for (int idx = threadIdx.x; idx < K::IN; idx += K::NTH) {
    const int s = idx / DP, d = idx % DP, t = t0 + s;
    float r = 0.f, k = 0.f, v = 0.f, g = 0.f, w = 1.f;
    if (t < row.T && d < row.D) {
      const int64_t off = (int64_t)t * row.st + d;
      r = to_f(row.r[off]);
      k = to_f(row.k[off]);
      v = to_f(row.v[off]);
      g = to_f(row.dout[off]);
      w = expf(row.logw[off]);
    }
    sr[idx] = r;
    sk[idx] = k;
    sv[idx] = v;
    sd[idx] = g;
    sw[idx] = w;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < K::C; s += K::NW) {
    float a = 0.f, b = 0.f;
    for (int d = lane; d < DP; d += 32) {
      a += sd[s * DP + d] * sv[s * DP + d];
      b += sr[s * DP + d] * su[d] * sk[s * DP + d];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      dov[s] = a;
      rku[s] = b;
    }
  }
  __syncthreads();
}

template <typename In, int DP>
__global__ void __launch_bounds__(4 * DP)
    wkv6_bwd_kernel(const In* __restrict__ r, const In* __restrict__ k,
                    const In* __restrict__ v, const float* __restrict__ logw,
                    const float* __restrict__ u, const In* __restrict__ dout,
                    const float* __restrict__ dstate, int H, int T, int D,
                    int64_t sb, int64_t sh, int64_t st, int64_t sub,
                    int64_t suh, In* __restrict__ dr, In* __restrict__ dk,
                    In* __restrict__ dv, float* __restrict__ dlogw,
                    float* __restrict__ du_rows, float* __restrict__ ckpt) {
  using K = Cfg<DP>;
  extern __shared__ float smem[];
  float* sr = smem;
  float* sk = sr + K::IN;
  float* sv = sk + K::IN;
  float* sd = sv + K::IN;
  float* sw = sd + K::IN;
  float* so = sw + K::IN;        // a pass's output rows, (C, DP)
  float* so2 = so + K::IN;       // B1's second output rows
  float* dov = so2 + K::IN;      // do_t . v_t
  float* rku = dov + K::C;       // r_t . (u (.) k_t)
  float* sst = rku + K::C;       // the chunk's states, (C, NC, NTH)
  __shared__ float su[DP];

  const int row_id = blockIdx.x;
  const int b = row_id / H, h = row_id % H;
  const int64_t base = (int64_t)b * sb + (int64_t)h * sh;
  Row<In, DP> row{r + base, k + base, v + base, dout + base, logw + base,
                  u + (int64_t)b * sub + (int64_t)h * suh, st, T, D};
  const int tid = threadIdx.x;
  for (int d = tid; d < DP; d += K::NTH) su[d] = d < D ? row.u[d] : 0.f;
  const int nck = (T + K::C - 1) / K::C;
  float* ck = ckpt + (int64_t)row_id * nck * K::NC * K::NTH;
  const float* ds = dstate ? dstate + (int64_t)row_id * D * D : nullptr;

  // thread (a, q): state row a (F, B1) or column a (B2), slots 4c + q
  const int a = tid >> 2, q = tid & 3;
  float x[K::NC];   // S (F, B1's recompute)
  float g[K::NC];   // G

  // ---- F: forward, dr and the chunk checkpoints -----------------------
#pragma unroll
  for (int c = 0; c < K::NC; ++c) x[c] = 0.f;
  for (int ci = 0; ci < nck; ++ci) {
    const int t0 = ci * K::C;
    stage<In, DP>(row, t0, sr, sk, sv, sd, sw, dov, rku, su);
#pragma unroll
    for (int c = 0; c < K::NC; ++c) {
      ck[((int64_t)ci * K::NC + c) * K::NTH + tid] = x[c];
    }
    for (int s = 0; s < K::C; ++s) {
      const float* vs = sv + s * DP;
      const float* gs = sd + s * DP;
      float p = 0.f;
#pragma unroll
      for (int c = 0; c < K::NC; ++c) p += x[c] * gs[4 * c + q];
      p = sum4(p);
      if (q == 0) so[s * DP + a] = p;
      const float wa = sw[s * DP + a], ka = sk[s * DP + a];
#pragma unroll
      for (int c = 0; c < K::NC; ++c) x[c] = wa * x[c] + ka * vs[4 * c + q];
    }
    __syncthreads();
    for (int idx = tid; idx < K::IN; idx += K::NTH) {
      const int s = idx / DP, d = idx % DP, t = t0 + s;
      if (t < T && d < D) {
        store1(dr + base + (int64_t)t * st + d,
               so[idx] + su[d] * sk[idx] * dov[s]);
      }
    }
  }

  // ---- B1: backward, dk, dlogw and the row's du ------------------------
#pragma unroll
  for (int c = 0; c < K::NC; ++c) {
    const int j = 4 * c + q;
    g[c] = (ds && a < D && j < D) ? ds[a * D + j] : 0.f;
  }
  float du_acc = 0.f;
  for (int ci = nck - 1; ci >= 0; --ci) {
    const int t0 = ci * K::C;
    stage<In, DP>(row, t0, sr, sk, sv, sd, sw, dov, rku, su);
    // the chunk's states before each step, from its checkpoint
#pragma unroll
    for (int c = 0; c < K::NC; ++c) {
      x[c] = ck[((int64_t)ci * K::NC + c) * K::NTH + tid];
    }
    for (int s = 0; s < K::C; ++s) {
      const float* vs = sv + s * DP;
      const float wa = sw[s * DP + a], ka = sk[s * DP + a];
#pragma unroll
      for (int c = 0; c < K::NC; ++c) {
        sst[(s * K::NC + c) * K::NTH + tid] = x[c];
        x[c] = wa * x[c] + ka * vs[4 * c + q];
      }
    }
    for (int s = K::C - 1; s >= 0; --s) {
      const float* vs = sv + s * DP;
      const float* gs = sd + s * DP;
      float pw = 0.f, pk = 0.f;
#pragma unroll
      for (int c = 0; c < K::NC; ++c) {
        pw += g[c] * sst[(s * K::NC + c) * K::NTH + tid];
        pk += g[c] * vs[4 * c + q];
      }
      pw = sum4(pw);
      pk = sum4(pk);
      const float wa = sw[s * DP + a], ra = sr[s * DP + a];
      if (q == 0) {
        so[s * DP + a] = wa * pw;                      // dlogw
        so2[s * DP + a] = pk;                          // dk, but the bonus
        du_acc += ra * sk[s * DP + a] * dov[s];
      }
#pragma unroll
      for (int c = 0; c < K::NC; ++c) g[c] = wa * g[c] + ra * gs[4 * c + q];
    }
    __syncthreads();
    for (int idx = tid; idx < K::IN; idx += K::NTH) {
      const int s = idx / DP, d = idx % DP, t = t0 + s;
      if (t < T && d < D) {
        const int64_t off = base + (int64_t)t * st + d;
        dlogw[off] = so[idx];
        store1(dk + off, so2[idx] + sr[idx] * su[d] * dov[s]);
      }
    }
  }
  if (q == 0 && a < D) du_rows[(int64_t)row_id * D + a] = du_acc;

  // ---- B2: backward, transposed, dv ------------------------------------
#pragma unroll
  for (int c = 0; c < K::NC; ++c) {
    const int i = 4 * c + q;
    g[c] = (ds && a < D && i < D) ? ds[i * D + a] : 0.f;
  }
  for (int ci = nck - 1; ci >= 0; --ci) {
    const int t0 = ci * K::C;
    stage<In, DP>(row, t0, sr, sk, sv, sd, sw, dov, rku, su);
    for (int s = K::C - 1; s >= 0; --s) {
      const float* ks = sk + s * DP;
      const float* rs = sr + s * DP;
      const float* ws = sw + s * DP;
      float p = 0.f;
#pragma unroll
      for (int c = 0; c < K::NC; ++c) p += g[c] * ks[4 * c + q];
      p = sum4(p);
      const float ga = sd[s * DP + a];
      if (q == 0) so[s * DP + a] = p;
#pragma unroll
      for (int c = 0; c < K::NC; ++c) {
        g[c] = ws[4 * c + q] * g[c] + rs[4 * c + q] * ga;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < K::IN; idx += K::NTH) {
      const int s = idx / DP, d = idx % DP, t = t0 + s;
      if (t < T && d < D) {
        store1(dv + base + (int64_t)t * st + d, so[idx] + rku[s] * sd[idx]);
      }
    }
  }
}

// du[h, d] = sum over b < nb of du_rows[b * nh + h, d], b in order.
__global__ void wkv6_du_sum_kernel(const float* __restrict__ du_rows, int nb,
                                   int nh, int D, float* __restrict__ du) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nh * D) return;
  const int h = idx / D, d = idx % D;
  float acc = 0.f;
  for (int b = 0; b < nb; ++b) acc += du_rows[((int64_t)b * nh + h) * D + d];
  du[idx] = acc;
}

template <typename In, int DP>
int run(const void* r, const void* k, const void* v, const float* logw,
        const float* u, const void* dout, const float* dstate, int rows,
        int H, int T, int D, int64_t sb, int64_t sh, int64_t st, int64_t sub,
        int64_t suh, void* dr, void* dk, void* dv, float* dlogw,
        float* du_rows, float* ckpt, cudaStream_t s) {
  using K = Cfg<DP>;
  auto kern = wkv6_bwd_kernel<In, DP>;
  static bool opted_in = false;  // the shared-memory opt-in, once an instance
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  kern<<<rows, K::NTH, K::SMEM, s>>>(
      static_cast<const In*>(r), static_cast<const In*>(k),
      static_cast<const In*>(v), logw, u, static_cast<const In*>(dout),
      dstate, H, T, D, sb, sh, st, sub, suh, static_cast<In*>(dr),
      static_cast<In*>(dk), static_cast<In*>(dv), dlogw, du_rows, ckpt);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int dispatch(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const void* dout, const float* dstate, int rows,
             int H, int T, int D, int64_t sb, int64_t sh, int64_t st,
             int64_t sub, int64_t suh, void* dr, void* dk, void* dv,
             float* dlogw, float* du_rows, float* ckpt, cudaStream_t s) {
#define WKV6_BWD_RUN(DP)                                                   \
  run<In, DP>(r, k, v, logw, u, dout, dstate, rows, H, T, D, sb, sh, st,   \
              sub, suh, dr, dk, dv, dlogw, du_rows, ckpt, s)
  if (D <= 16) return WKV6_BWD_RUN(16);
  if (D <= 32) return WKV6_BWD_RUN(32);
  if (D <= 64) return WKV6_BWD_RUN(64);
  return WKV6_BWD_RUN(128);
#undef WKV6_BWD_RUN
}

template <int DP>
long long ckpt_floats(int T) {
  using K = Cfg<DP>;
  return (long long)((T + K::C - 1) / K::C) * K::NC * K::NTH;
}

}  // namespace

// The workspace a row needs, in floats (the chunk checkpoints of its state).
extern "C" long long wkv6_bwd_workspace(int T, int D) {
  if (D <= 16) return ckpt_floats<16>(T);
  if (D <= 32) return ckpt_floats<32>(T);
  if (D <= 64) return ckpt_floats<64>(T);
  return ckpt_floats<128>(T);
}

// r, k, v, dout, dr, dk, dv: (B, H, T, D) in the element type (bf16 != 0:
// bf16, else fp32) at strides (sb, sh, st, 1), all alike; logw, dlogw: fp32
// at the same strides; u: fp32, the bonus row of b*H + h at u + b*sub +
// h*suh (unit stride); dstate: the final state's gradient (B*H, D, D) fp32,
// or null for none.  du: (nh, D) fp32, du[h] the sum of rows b*nh + h for
// b < nb (nb * nh == B * H); du_rows: (B*H, D) fp32 scratch; ckpt:
// B*H * wkv6_bwd_workspace(T, D) fp32 scratch.  1 <= D <= 128.  Returns
// the launch error, if any (cudaErrorInvalidValue for arguments out of
// range).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const float* logw, const float* u,
                               const void* dout, const float* dstate, int B,
                               int H, int T, int D, long long sb,
                               long long sh, long long st, long long sub,
                               long long suh, int bf16, void* dr, void* dk,
                               void* dv, float* dlogw, float* du, int nb,
                               int nh, float* du_rows, float* ckpt,
                               void* stream) {
  if (D < 1 || D > 128 || B < 0 || H < 1 || T < 1 || nb * nh != B * H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * H;
  if (rows == 0) return 0;
  const int err =
      bf16 ? dispatch<__nv_bfloat16>(r, k, v, logw, u, dout, dstate, rows, H,
                                     T, D, sb, sh, st, sub, suh, dr, dk, dv,
                                     dlogw, du_rows, ckpt, s)
           : dispatch<float>(r, k, v, logw, u, dout, dstate, rows, H, T, D,
                             sb, sh, st, sub, suh, dr, dk, dv, dlogw,
                             du_rows, ckpt, s);
  if (err != 0) return err;
  const int n = nh * D;
  wkv6_du_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(du_rows, nb, nh, D, du);
  return static_cast<int>(cudaGetLastError());
}
