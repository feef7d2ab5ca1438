// The port's Norm (batch-of-1 BatchNorm) and the LeakyReLU after it, forward
// and backward: two kernels a direction.
//
// Replaces no Pallas kernel: the JAX package leaves the Norm to XLA, which
// fuses it. As tensor ops, each Norm with its activation dispatched ~23 ops
// forward and ~45 backward and moved ~85 bytes an element in bf16 (a float32
// copy of the input saved for the backward among them); the 70 Norms of the
// 3D MulResUnet were the largest share of its step, on the device and in the
// host's dispatch (PERF.md). For an input x of B lanes x (N, C, S) (S the
// spatial voxels, NCDHW, contiguous within a lane), per (lane, channel),
// n = N S:
//
//   dpi_norm_forward:  mean = s1 / n, var = max(s2 / n - mean^2, 0) from the
//                      float32 sums s1 = sum x, s2 = sum x^2 (the one-pass
//                      statistics of Norm.forward); g = scale rsqrt(var +
//                      eps), b = bias - mean g; z = act(x g + b) in float32,
//                      rounded once to x's dtype. act: LeakyReLU(0.2) or the
//                      identity.
//   dpi_norm_backward: dy = dz act'(x g + b) (the pre-activation recomputed,
//                      not saved); from Sy = sum dy and Sxy = sum dy x,
//                      dbias = Sy, Gg = Sxy - mean Sy, dscale = Gg rstd,
//                      dvar = -scale Gg rstd^3 / 2 (0 where s2/n - mean^2 < 0,
//                      as autograd of the clamp gives), dmean = -g Sy -
//                      2 mean dvar, and dx = g dy + c1 x + c0 with c1 =
//                      2 dvar / n, c0 = dmean / n, in one pass.
//
// What bounds them on an H100 (3.35 TB/s): bytes, ~1 flop a byte. An element
// moves 16 bytes a step in bf16 (the statistics read x, the apply reads x and
// writes z; the backward's sums read x and dz, its elementwise pass reads x
// and dz and writes dx), 32 in float32. Where a Norm's input fits in the
// 50 MB L2 the second pass of a direction finds it there: the first pass
// loads with the default policy, the last one streams (ld.global.cs).
//
// Design.
//  * Grid: x = channel x part, y = lane. A (lane, channel)'s S voxels are
//    split into `parts` ranges of 16-byte units (8 bf16 or 4 float32), one a
//    block; the wrapper picks `parts` from C and S alone (about 1024 blocks a
//    lane where the channel is long enough), so lane b of a lane launch runs
//    what a one-lane launch on its input runs, bit for bit. A thread issues
//    the loads of 4 units, 256 units apart, before it uses them. Inputs whose
//    channels are not all 16-byte aligned take a scalar path in the same
//    kernels (then every launch on them does).
//  * Sums: float32 accumulators a thread, warp shuffles, the warps in order
//    through shared memory, one write of the block's two partials to a
//    workspace. The block that takes the channel's last ticket (an unsigned
//    atomicAdd after a __threadfence, on a counter the wrapper zeroes once)
//    adds the partials in a fixed order, writes the channel's statistics or
//    gradient constants and resets the counter, as csrc/fused_loss.cu does.
//    No float atomics: a call repeats bit for bit.
//  * The elementwise passes read their channel's constants once a block; the
//    products and sums are rounded as written (no FMA contraction), so
//    x g + b is the plain version's float32 value from the same g and b.
// 64-bit offsets throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kUnroll = 4;     // 16-byte units a thread loads before it uses them
constexpr int kStat = 8;       // floats a channel in `stats`: g, b, mean, rstd, scale, keep
constexpr int kCoef = 4;       // floats a channel in `coef`: g, b, c1, c0
constexpr float kSlope = 0.2f;

typedef unsigned short bf16_bits;

__device__ __forceinline__ unsigned to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// 16-byte units: V elements, loaded as float32, stored rounded to T
template <typename T>
struct Unit;

template <>
struct Unit<bf16_bits> {
  static constexpr int V = 8;
  template <bool kStream>
  __device__ static __forceinline__ void load(const bf16_bits* p, long long q, bool valid,
                                              float (&x)[V]) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (valid) {
      const uint4* src = reinterpret_cast<const uint4*>(p) + q;
      u = kStream ? __ldcs(src) : __ldg(src);
    }
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ void store(bf16_bits* p, long long q, const float (&x)[V]) {
    reinterpret_cast<uint4*>(p)[q] =
        make_uint4(to_bf16(x[0]) | (to_bf16(x[1]) << 16), to_bf16(x[2]) | (to_bf16(x[3]) << 16),
                   to_bf16(x[4]) | (to_bf16(x[5]) << 16), to_bf16(x[6]) | (to_bf16(x[7]) << 16));
  }
  __device__ static __forceinline__ float load1(const bf16_bits* p, long long i) {
    return __uint_as_float(static_cast<unsigned>(p[i]) << 16);
  }
  __device__ static __forceinline__ void store1(bf16_bits* p, long long i, float x) {
    p[i] = static_cast<bf16_bits>(to_bf16(x));
  }
};

template <>
struct Unit<float> {
  static constexpr int V = 4;
  template <bool kStream>
  __device__ static __forceinline__ void load(const float* p, long long q, bool valid,
                                              float (&x)[V]) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {
      const float4* src = reinterpret_cast<const float4*>(p) + q;
      a = kStream ? __ldcs(src) : __ldg(src);
    }
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
  __device__ static __forceinline__ void store(float* p, long long q, const float (&x)[V]) {
    reinterpret_cast<float4*>(p)[q] = make_float4(x[0], x[1], x[2], x[3]);
  }
  __device__ static __forceinline__ float load1(const float* p, long long i) { return p[i]; }
  __device__ static __forceinline__ void store1(float* p, long long i, float x) { p[i] = x; }
};

// This block's range [lo, hi) of a channel's `units` units
__device__ __forceinline__ void part_range(long long units, int parts, long long& lo,
                                           long long& hi) {
  const int p = blockIdx.x % parts;
  const long long chunk = (units + parts - 1) / parts;
  lo = p * chunk;
  hi = lo + chunk < units ? lo + chunk : units;
}

// The block's two sums: warp shuffles (a fixed tree), then the warps in order
// through shared memory; thread 0 gets the result.
__device__ __forceinline__ void block_sum2(float (&s)[2], float (*part)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
  if (lane == 0) {
    part[warp][0] = s[0];
    part[warp][1] = s[1];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j] = part[0][j];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) s[j] += part[w][j];
    }
  }
}

// Writes the block's partials; true in the block that took the channel's last
// ticket, which then holds the channel's two sums in thread 0's s (the
// partials added in block order by the same reduction).
__device__ __forceinline__ bool reduce_channel(float (&s)[2], float2* ws, unsigned* ticket,
                                               int parts) {
  __shared__ float part[kThreads / 32][2];
  __shared__ bool last;
  block_sum2(s, part);
  if (threadIdx.x == 0) {
    ws[blockIdx.x % parts] = make_float2(s[0], s[1]);
    __threadfence();  // the partials are visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(parts - 1);
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  s[0] = 0.f;
  s[1] = 0.f;
  for (int b = threadIdx.x; b < parts; b += kThreads) {
    const float2 w = __ldcg(ws + b);
    s[0] += w.x;
    s[1] += w.y;
  }
  __syncthreads();  // part is reused
  block_sum2(s, part);
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch on this stream
  return true;
}

__device__ __forceinline__ float pre_act(float x, float g, float b) {
  return __fadd_rn(__fmul_rn(x, g), b);
}

__device__ __forceinline__ float act(float y, int leaky) {
  return leaky && !(y > 0.f) ? __fmul_rn(y, kSlope) : y;
}

// dz act'(y): LeakyReLU's backward takes the slope where y > 0 is false
__device__ __forceinline__ float act_grad(float y, float dz, int leaky) {
  return leaky && !(y > 0.f) ? __fmul_rn(dz, kSlope) : dz;
}

// The layout the kernels share: lane blockIdx.y, channel c of C, N samples of
// S voxels; each tensor's lane starts `*_lane` elements after the previous.
struct Shape {
  long long S, x_lane, y_lane, z_lane;  // x, a second input (dz), the output
  int N, C, parts, vec, leaky;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) norm_stats_kernel(
    const T* __restrict__ x, Shape sh, const float* __restrict__ scale,
    const float* __restrict__ bias, long long p_lane, float eps, float2* __restrict__ ws,
    unsigned* __restrict__ ticket, float* __restrict__ stats) {
  constexpr int V = Unit<T>::V;
  const int c = blockIdx.x / sh.parts;
  const long long lane = blockIdx.y, ch = lane * sh.C + c;
  x += lane * sh.x_lane + c * sh.S;
  float s[2] = {0.f, 0.f};
  long long lo, hi;
  part_range(sh.vec ? sh.S / V : sh.S, sh.parts, lo, hi);
  for (int n = 0; n < sh.N; ++n) {
    const T* xn = x + static_cast<long long>(n) * sh.C * sh.S;
    if (sh.vec) {
      for (long long q = lo + threadIdx.x; q < hi; q += kUnroll * kThreads) {
        float v[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          Unit<T>::template load<false>(xn, q + u * kThreads, q + u * kThreads < hi, v[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int i = 0; i < V; ++i) {
            s[0] += v[u][i];
            s[1] = fmaf(v[u][i], v[u][i], s[1]);
          }
      }
    } else {
      for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
        const float v = Unit<T>::load1(xn, i);
        s[0] += v;
        s[1] = fmaf(v, v, s[1]);
      }
    }
  }
  if (!reduce_channel(s, ws + ch * sh.parts, ticket + ch, sh.parts)) return;
  if (threadIdx.x == 0) {
    const float n = static_cast<float>(static_cast<long long>(sh.N) * sh.S);
    const float mean = __fdiv_rn(s[0], n);
    const float raw = __fsub_rn(__fdiv_rn(s[1], n), __fmul_rn(mean, mean));
    const float var = raw > 0.f ? raw : 0.f;
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    const float sc = scale[lane * p_lane + c];
    const float g = __fmul_rn(sc, rstd);
    const float b = __fsub_rn(bias[lane * p_lane + c], __fmul_rn(mean, g));
    float4* dst = reinterpret_cast<float4*>(stats + ch * kStat);
    dst[0] = make_float4(g, b, mean, rstd);
    dst[1] = make_float4(sc, raw >= 0.f ? 1.f : 0.f, 0.f, 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) norm_apply_kernel(
    const T* __restrict__ x, T* __restrict__ z, Shape sh, const float* __restrict__ stats) {
  constexpr int V = Unit<T>::V;
  const int c = blockIdx.x / sh.parts;
  const long long lane = blockIdx.y, ch = lane * sh.C + c;
  x += lane * sh.x_lane + c * sh.S;
  z += lane * sh.z_lane + c * sh.S;
  const float g = stats[ch * kStat], b = stats[ch * kStat + 1];
  long long lo, hi;
  part_range(sh.vec ? sh.S / V : sh.S, sh.parts, lo, hi);
  for (int n = 0; n < sh.N; ++n) {
    const long long off = static_cast<long long>(n) * sh.C * sh.S;
    if (sh.vec) {
      for (long long q = lo + threadIdx.x; q < hi; q += kUnroll * kThreads) {
        float v[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          Unit<T>::template load<true>(x + off, q + u * kThreads, q + u * kThreads < hi, v[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (q + u * kThreads < hi) {
#pragma unroll
            for (int i = 0; i < V; ++i) v[u][i] = act(pre_act(v[u][i], g, b), sh.leaky);
            Unit<T>::store(z + off, q + u * kThreads, v[u]);
          }
        }
      }
    } else {
      for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
        Unit<T>::store1(z + off, i, act(pre_act(Unit<T>::load1(x + off, i), g, b), sh.leaky));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) norm_grad_sums_kernel(
    const T* __restrict__ x, const T* __restrict__ dz, Shape sh, const float* __restrict__ stats,
    float2* __restrict__ ws, unsigned* __restrict__ ticket, float* __restrict__ coef,
    float* __restrict__ dscale, float* __restrict__ dbias) {
  constexpr int V = Unit<T>::V;
  const int c = blockIdx.x / sh.parts;
  const long long lane = blockIdx.y, ch = lane * sh.C + c;
  x += lane * sh.x_lane + c * sh.S;
  dz += lane * sh.y_lane + c * sh.S;
  const float g = stats[ch * kStat], b = stats[ch * kStat + 1];
  float s[2] = {0.f, 0.f};  // sum dy, sum dy x
  long long lo, hi;
  part_range(sh.vec ? sh.S / V : sh.S, sh.parts, lo, hi);
  for (int n = 0; n < sh.N; ++n) {
    const long long off = static_cast<long long>(n) * sh.C * sh.S;
    if (sh.vec) {
      for (long long q = lo + threadIdx.x; q < hi; q += kUnroll * kThreads) {
        float v[kUnroll][V], d[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool valid = q + u * kThreads < hi;
          Unit<T>::template load<false>(x + off, q + u * kThreads, valid, v[u]);
          Unit<T>::template load<false>(dz + off, q + u * kThreads, valid, d[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int i = 0; i < V; ++i) {
            // a unit past hi loads zeros: dy = 0 adds nothing
            const float dy = act_grad(pre_act(v[u][i], g, b), d[u][i], sh.leaky);
            s[0] += dy;
            s[1] = fmaf(dy, v[u][i], s[1]);
          }
      }
    } else {
      for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
        const float xv = Unit<T>::load1(x + off, i);
        const float dy = act_grad(pre_act(xv, g, b), Unit<T>::load1(dz + off, i), sh.leaky);
        s[0] += dy;
        s[1] = fmaf(dy, xv, s[1]);
      }
    }
  }
  if (!reduce_channel(s, ws + ch * sh.parts, ticket + ch, sh.parts)) return;
  if (threadIdx.x == 0) {
    const float4 lo4 = *reinterpret_cast<const float4*>(stats + ch * kStat);
    const float4 hi4 = *reinterpret_cast<const float4*>(stats + ch * kStat + 4);
    const float mean = lo4.z, rstd = lo4.w, sc = hi4.x, keep = hi4.y;
    const float n = static_cast<float>(static_cast<long long>(sh.N) * sh.S);
    const float sy = s[0], sxy = s[1];
    const float gg = __fsub_rn(sxy, __fmul_rn(mean, sy));  // d/dg, b's share included
    const float r3 = __fmul_rn(__fmul_rn(rstd, rstd), rstd);
    const float dvar = keep != 0.f ? __fmul_rn(__fmul_rn(__fmul_rn(gg, sc), -0.5f), r3) : 0.f;
    const float dmean = __fadd_rn(-__fmul_rn(g, sy), __fmul_rn(dvar, __fmul_rn(-2.f, mean)));
    dscale[ch] = __fmul_rn(gg, rstd);
    dbias[ch] = sy;
    reinterpret_cast<float4*>(coef + ch * kCoef)[0] =
        make_float4(g, b, __fdiv_rn(__fmul_rn(2.f, dvar), n), __fdiv_rn(dmean, n));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) norm_grad_kernel(
    const T* __restrict__ x, const T* __restrict__ dz, T* __restrict__ dx, Shape sh,
    const float* __restrict__ coef) {
  constexpr int V = Unit<T>::V;
  const int c = blockIdx.x / sh.parts;
  const long long lane = blockIdx.y, ch = lane * sh.C + c;
  x += lane * sh.x_lane + c * sh.S;
  dz += lane * sh.y_lane + c * sh.S;
  dx += lane * sh.z_lane + c * sh.S;
  const float4 k = *reinterpret_cast<const float4*>(coef + ch * kCoef);
  const float g = k.x, b = k.y, c1 = k.z, c0 = k.w;
  long long lo, hi;
  part_range(sh.vec ? sh.S / V : sh.S, sh.parts, lo, hi);
  for (int n = 0; n < sh.N; ++n) {
    const long long off = static_cast<long long>(n) * sh.C * sh.S;
    if (sh.vec) {
      for (long long q = lo + threadIdx.x; q < hi; q += kUnroll * kThreads) {
        float v[kUnroll][V], d[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool valid = q + u * kThreads < hi;
          Unit<T>::template load<true>(x + off, q + u * kThreads, valid, v[u]);
          Unit<T>::template load<true>(dz + off, q + u * kThreads, valid, d[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (q + u * kThreads < hi) {
#pragma unroll
            for (int i = 0; i < V; ++i) {
              const float dy = act_grad(pre_act(v[u][i], g, b), d[u][i], sh.leaky);
              d[u][i] = __fadd_rn(__fadd_rn(__fmul_rn(g, dy), __fmul_rn(c1, v[u][i])), c0);
            }
            Unit<T>::store(dx + off, q + u * kThreads, d[u]);
          }
        }
      }
    } else {
      for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
        const float xv = Unit<T>::load1(x + off, i);
        const float dy = act_grad(pre_act(xv, g, b), Unit<T>::load1(dz + off, i), sh.leaky);
        Unit<T>::store1(dx + off, i, __fadd_rn(__fadd_rn(__fmul_rn(g, dy), __fmul_rn(c1, xv)), c0));
      }
    }
  }
}

Shape make_shape(long long S, long long x_lane, long long y_lane, long long z_lane, int N, int C,
                 int parts, int vec, int leaky) {
  Shape sh;
  sh.S = S;
  sh.x_lane = x_lane;
  sh.y_lane = y_lane;
  sh.z_lane = z_lane;
  sh.N = N;
  sh.C = C;
  sh.parts = parts;
  sh.vec = vec;
  sh.leaky = leaky;
  return sh;
}

}  // namespace

// z = act(Norm(x)) of `lanes` lanes of (N, C, S) x (bf16 when is_bf16, else
// float32; lane b at x + b x_lane) into z (lane b at z + b z_lane), and each
// (lane, channel)'s statistics into stats (lanes x C x 8 float32: g, b, mean,
// rstd, scale, keep). scale and bias: lane b's C floats at b p_lane. ws holds
// lanes x C x parts float2, ticket lanes x C counters, 0 before the launch
// and after it; both belong to one stream at a time. vec: every channel of
// every lane 16-byte aligned (S a multiple of the unit).
extern "C" int dpi_norm_forward(const void* x, void* z, long long S, long long x_lane,
                                long long z_lane, int N, int C, int lanes, int parts, int vec,
                                int leaky, int is_bf16, const float* scale, const float* bias,
                                long long p_lane, float eps, void* ws, unsigned* ticket,
                                float* stats, void* stream) {
  const Shape sh = make_shape(S, x_lane, 0, z_lane, N, C, parts, vec, leaky);
  const dim3 grid(static_cast<unsigned>(C) * parts, lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* w = static_cast<float2*>(ws);
  if (is_bf16) {
    norm_stats_kernel<bf16_bits><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16_bits*>(x), sh, scale, bias, p_lane, eps, w, ticket, stats);
    norm_apply_kernel<bf16_bits><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16_bits*>(x), static_cast<bf16_bits*>(z), sh, stats);
  } else {
    norm_stats_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), sh, scale,
                                                        bias, p_lane, eps, w, ticket, stats);
    norm_apply_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                                        static_cast<float*>(z), sh, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx, dscale and dbias of act(Norm(x)) from dz (lane b at dz + b dz_lane),
// with the forward's stats; coef (lanes x C x 4 float32) receives g, b, c1
// and c0, dscale and dbias lanes x C floats. ws and ticket as the forward's.
extern "C" int dpi_norm_backward(const void* x, const void* dz, void* dx, long long S,
                                 long long x_lane, long long dz_lane, long long dx_lane, int N,
                                 int C, int lanes, int parts, int vec, int leaky, int is_bf16,
                                 const float* stats, void* ws, unsigned* ticket, float* coef,
                                 float* dscale, float* dbias, void* stream) {
  const Shape sh = make_shape(S, x_lane, dz_lane, dx_lane, N, C, parts, vec, leaky);
  const dim3 grid(static_cast<unsigned>(C) * parts, lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* w = static_cast<float2*>(ws);
  if (is_bf16) {
    const bf16_bits* xb = static_cast<const bf16_bits*>(x);
    const bf16_bits* db = static_cast<const bf16_bits*>(dz);
    norm_grad_sums_kernel<bf16_bits><<<grid, kThreads, 0, st>>>(xb, db, sh, stats, w, ticket,
                                                                coef, dscale, dbias);
    norm_grad_kernel<bf16_bits><<<grid, kThreads, 0, st>>>(xb, db, static_cast<bf16_bits*>(dx),
                                                           sh, coef);
  } else {
    const float* xf = static_cast<const float*>(x);
    const float* df = static_cast<const float*>(dz);
    norm_grad_sums_kernel<float><<<grid, kThreads, 0, st>>>(xf, df, sh, stats, w, ticket, coef,
                                                            dscale, dbias);
    norm_grad_kernel<float><<<grid, kThreads, 0, st>>>(xf, df, static_cast<float*>(dx), sh,
                                                       coef);
  }
  return static_cast<int>(cudaGetLastError());
}
