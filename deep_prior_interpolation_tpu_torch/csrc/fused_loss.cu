// Fused masked-loss sums and their gradient in `out`.
//
// Replaces the Pallas TPU kernel in
// deep_prior_interpolation_tpu/ops/pallas_kernels.py (_metrics_kernel,
// reached through _fused_sums) and the one pass that XLA fuses the plain
// backward _loss_sums_bwd into. With d = (o - t) m over the flattened `out`
// (o, bfloat16 or float32), `img` (t) and `mask` (m), both float32:
//
//   dpi_loss_sums:       s = (sum |d|, sum d^2, sum t^2, sum (t-o)^2,
//                             sum t, sum o, sum o^2, sum t o), float32
//   dpi_loss_sums_grad:  grad = g0 sign(d) m + 2 g1 d m - 2 g3 (t - o) + g5
//                               + 2 g6 o + g7 t, in out's dtype
//
// What bounds both on an H100 (3.35 TB/s, 67 TFLOP/s fp32): bytes. There is
// no reuse and about 2 flops a byte. At the flagship's 4.19 M voxels with
// bf16 `out` the forward reads 10 bytes a voxel (42 MB, 12.5 us) and the
// backward moves 12 (50 MB, 15.0 us); the launch and the grid's ramp are of
// the same order, so both are single launches.
//
// Design.
//  * Persistent grid: the wrapper asks dpi_loss_blocks for the blocks that
//    fit on the card at once (occupancy x SMs) and launches at most that
//    many, fewer for a small n; a grid-stride walk covers the rest.
//  * Coalesced wide loads: the unit is 4 voxels, one float4 each of `img`
//    and `mask` and 8 bytes of bf16 `out` (a float4 of float32), so the
//    lanes of a warp read one contiguous 512-byte run of each float32 input
//    per instruction (256 bytes of bf16), with ld.global.cs (__ldcs:
//    streamed, nothing is reused). A thread issues the loads of 8 units
//    (forward; 4 in the backward, which also stores), a grid stride apart,
//    before it uses them: at the flagship size the forward's persistent grid
//    issues every load in one pass. A unit past n loads zeros, which
//    add 0 to every sum, so there is no remainder loop. Bases that are not
//    all 16-byte aligned, and the last n % 4 voxels, take a scalar path in
//    the same kernel.
//  * Forward sums: 8 float32 accumulators a thread, warp shuffles, the
//    warps' sums through shared memory in warp order, then one write of the
//    block's 8 partials to a workspace. The block that takes the last
//    ticket (an unsigned atomicAdd on a counter the wrapper zeroes once,
//    after a __threadfence) reads all partials at once, adds them in a
//    fixed order with the same block reduction, writes the 8 sums and
//    resets the counter. One launch, no float atomics: repeated calls on the
//    same inputs are bit-identical.
//  * Backward: one elementwise pass with the same units and loads, and
//    stores of the same width. The 8 incoming gradients are read from the
//    device (no host read); the formula is the JAX package's, term by term
//    in float32 with rounded (non-contracted) multiplies and adds, so it
//    rounds as the plain version does, and the result is rounded once to
//    out's dtype (round to nearest even).
// 64-bit offsets throughout.
//
// Still left (PERF.md has the figures): at the flagship size the backward
// runs within ~7 % of its bound, the forward at ~77 % of its bound's speed.
// Its read stream reaches less of the card's rate than the backward's mixed
// reads and writes do; its tail (the blocks' fences and tickets and the last
// block's sum) is the smaller part of the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kSums = 8;
// 4-voxel units a thread loads before it uses them: the forward covers the
// flagship in one pass of the persistent grid, the backward in two
constexpr int kUnrollSums = 8;
constexpr int kUnrollGrad = 4;

typedef unsigned short bf16_bits;

__device__ __forceinline__ float from_bf16(unsigned bits16) { return __uint_as_float(bits16 << 16); }

__device__ __forceinline__ unsigned to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// the 4 voxels of unit q, as float32; zeros where `valid` is false
__device__ __forceinline__ void load4(const bf16_bits* p, long long q, bool valid, float (&x)[4]) {
  uint2 u = make_uint2(0u, 0u);
  if (valid) u = __ldcs(reinterpret_cast<const uint2*>(p) + q);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void load4(const float* p, long long q, bool valid, float (&x)[4]) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) a = __ldcs(reinterpret_cast<const float4*>(p) + q);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ float load1(const bf16_bits* p, long long i) { return from_bf16(__ldcs(p + i)); }
__device__ __forceinline__ float load1(const float* p, long long i) { return __ldcs(p + i); }

__device__ __forceinline__ void store4(bf16_bits* p, long long q, const float (&x)[4]) {
  reinterpret_cast<uint2*>(p)[q] =
      make_uint2(to_bf16(x[0]) | (to_bf16(x[1]) << 16), to_bf16(x[2]) | (to_bf16(x[3]) << 16));
}

__device__ __forceinline__ void store4(float* p, long long q, const float (&x)[4]) {
  reinterpret_cast<float4*>(p)[q] = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store1(bf16_bits* p, long long i, float x) { p[i] = to_bf16(x); }
__device__ __forceinline__ void store1(float* p, long long i, float x) { p[i] = x; }

__device__ __forceinline__ void accumulate(float (&s)[kSums], float o, float t, float m) {
  const float d = (o - t) * m, r = t - o;
  s[0] += fabsf(d);
  s[1] += d * d;
  s[2] += t * t;
  s[3] += r * r;
  s[4] += t;
  s[5] += o;
  s[6] += o * o;
  s[7] += t * o;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The block's 8 sums: warp shuffles (a fixed tree), then the warps in
// order through shared memory; thread 0 gets the result.
__device__ __forceinline__ void block_sums(float (&s)[kSums], float (*part)[kSums]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kSums; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kSums; ++j) part[warp][j] = s[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kSums; ++j) {
      s[j] = part[0][j];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) s[j] += part[w][j];
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) loss_sums_kernel(
    const OutT* __restrict__ o, const float* __restrict__ t, const float* __restrict__ m,
    long long n, int vec, float* __restrict__ ws, unsigned* __restrict__ ticket,
    float* __restrict__ sums) {
  float s[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) s[j] = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;  // voxels the 4-voxel units cover
  if (vec) {
    const long long units = n / 4;
    for (long long q = first; q < units; q += kUnrollSums * stride) {
      float xo[kUnrollSums][4], xt[kUnrollSums][4], xm[kUnrollSums][4];
#pragma unroll
      for (int u = 0; u < kUnrollSums; ++u) {
        const bool valid = q + u * stride < units;
        load4(o, q + u * stride, valid, xo[u]);
        load4(t, q + u * stride, valid, xt[u]);
        load4(m, q + u * stride, valid, xm[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnrollSums; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) accumulate(s, xo[u][i], xt[u][i], xm[u][i]);
    }
    done = units * 4;
  }
  for (long long i = done + first; i < n; i += stride)
    accumulate(s, load1(o, i), load1(t, i), load1(m, i));

  __shared__ float part[kThreads / 32][kSums];
  __shared__ bool last;
  block_sums(s, part);
  if (threadIdx.x == 0) {
    float4* dst = reinterpret_cast<float4*>(ws + static_cast<long long>(blockIdx.x) * kSums);
    dst[0] = make_float4(s[0], s[1], s[2], s[3]);
    dst[1] = make_float4(s[4], s[5], s[6], s[7]);
    __threadfence();  // the partials are visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: every thread loads its blocks' partials at once (L2,
  // not L1), adds them in block order, then the same block reduction
  __threadfence();
#pragma unroll
  for (int j = 0; j < kSums; ++j) s[j] = 0.f;
#pragma unroll 4
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    const float4* src = reinterpret_cast<const float4*>(ws + static_cast<long long>(b) * kSums);
    const float4 lo = __ldcg(src), hi = __ldcg(src + 1);
    s[0] += lo.x; s[1] += lo.y; s[2] += lo.z; s[3] += lo.w;
    s[4] += hi.x; s[5] += hi.y; s[6] += hi.z; s[7] += hi.w;
  }
  __syncthreads();  // part is reused
  block_sums(s, part);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kSums; ++j) sums[j] = s[j];
    *ticket = 0u;  // ready for the next launch on this stream
  }
}

struct Grads {  // the coefficients of the terms that depend on out
  float g0, g1x2, g3x2, g5, g6x2, g7;
};

// d/d_out of the sums, as _loss_sums_bwd writes it, each product and sum
// rounded (no FMA contraction):
//   g0 sign(d) m + (2 g1) d m + (-2 g3)(t - o) + g5 + (2 g6) o + g7 t
__device__ __forceinline__ float grad1(float o, float t, float m, const Grads& g) {
  const float d = __fmul_rn(__fsub_rn(o, t), m);
  const float sign = d > 0.f ? 1.f : (d < 0.f ? -1.f : d);  // 0 stays 0, NaN NaN
  float r = __fmul_rn(__fmul_rn(g.g0, sign), m);
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(g.g1x2, d), m));
  r = __fadd_rn(r, __fmul_rn(g.g3x2, __fsub_rn(t, o)));
  r = __fadd_rn(r, g.g5);
  r = __fadd_rn(r, __fmul_rn(g.g6x2, o));
  return __fadd_rn(r, __fmul_rn(g.g7, t));
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) loss_grad_kernel(
    const OutT* __restrict__ o, const float* __restrict__ t, const float* __restrict__ m,
    const float* __restrict__ gin, OutT* __restrict__ grad, long long n, int vec) {
  // doubling and negating are exact, so these are the JAX package's
  // g[1] * 2.0, g[3] * (-2.0) and g[6] * 2.0
  const Grads g = {gin[0], 2.f * gin[1], -2.f * gin[3], gin[5], 2.f * gin[6], gin[7]};
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long units = n / 4;
    for (long long q = first; q < units; q += kUnrollGrad * stride) {
      float xo[kUnrollGrad][4], xt[kUnrollGrad][4], xm[kUnrollGrad][4];
#pragma unroll
      for (int u = 0; u < kUnrollGrad; ++u) {
        const bool valid = q + u * stride < units;
        load4(o, q + u * stride, valid, xo[u]);
        load4(t, q + u * stride, valid, xt[u]);
        load4(m, q + u * stride, valid, xm[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnrollGrad; ++u) {
        if (q + u * stride < units) {
          float r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) r[i] = grad1(xo[u][i], xt[u][i], xm[u][i], g);
          store4(grad, q + u * stride, r);
        }
      }
    }
    done = units * 4;
  }
  for (long long i = done + first; i < n; i += stride)
    store1(grad, i, grad1(load1(o, i), load1(t, i), load1(m, i), g));
}

template <typename Kernel>
int max_blocks(Kernel kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  *blocks = sms * per_sm;
  return static_cast<int>(err);
}

// the grid: at most `blocks`, and no more than `unroll` units a thread needs
int grid_for(long long n, int blocks, int unroll) {
  const long long per_block = 4LL * unroll * kThreads;
  const long long want = (n + per_block - 1) / per_block;
  return static_cast<int>(want < 1 ? 1 : (want < blocks ? want : blocks));
}

}  // namespace

// Blocks of the forward (which = 0) or backward (1) kernel that fit on the
// current device at once, for bf16 (out_bf16 = 1) or float32 `out`: the
// forward's workspace needs 8 floats for each.
extern "C" int dpi_loss_blocks(int which, int out_bf16, int* blocks) {
  if (which == 0)
    return out_bf16 ? max_blocks(loss_sums_kernel<bf16_bits>, blocks)
                    : max_blocks(loss_sums_kernel<float>, blocks);
  return out_bf16 ? max_blocks(loss_grad_kernel<bf16_bits>, blocks)
                  : max_blocks(loss_grad_kernel<float>, blocks);
}

// The 8 sums into `sums`. `ws` holds 8 floats for each of `blocks` blocks
// and `ticket` is 0 before the launch and after it; both belong to one
// stream at a time.
extern "C" int dpi_loss_sums(const void* o, const float* t, const float* m, long long n,
                             int out_bf16, int blocks, float* ws, unsigned* ticket, float* sums,
                             void* stream) {
  const int grid = grid_for(n, blocks, kUnrollSums);
  const int vec = aligned16(o) && aligned16(t) && aligned16(m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    loss_sums_kernel<bf16_bits><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16_bits*>(o), t, m, n, vec, ws, ticket, sums);
  else
    loss_sums_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(o), t, m, n, vec, ws, ticket, sums);
  return static_cast<int>(cudaGetLastError());
}

// grad (n values of out's dtype) from the 8 incoming gradients `g` (float32,
// on the device).
extern "C" int dpi_loss_sums_grad(const void* o, const float* t, const float* m, const float* g,
                                  void* grad, long long n, int out_bf16, int blocks,
                                  void* stream) {
  const int grid = grid_for(n, blocks, kUnrollGrad);
  const int vec = aligned16(o) && aligned16(t) && aligned16(m) && aligned16(grad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    loss_grad_kernel<bf16_bits><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16_bits*>(o), t, m, g, static_cast<bf16_bits*>(grad), n, vec);
  else
    loss_grad_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(o), t, m, g, static_cast<float*>(grad), n, vec);
  return static_cast<int>(cudaGetLastError());
}
