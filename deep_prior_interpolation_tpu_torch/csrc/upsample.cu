// Backward of the x2 half-pixel linear upsample (align_corners=False), 2D
// and 3D, as a gather: each input sample sums the output gradients that its
// value reached, with fixed weights, in a fixed order, with no atomics.
//
// No TPU kernel stands behind it: the JAX package leaves the backward of
// jax.image.resize (deep_prior_interpolation_tpu/models/blocks.py:upsample)
// to XLA. PyTorch's CUDA backward of F.interpolate scatters with atomic adds,
// so two runs of one state drift apart; this one gives the same bits every
// time, which an exact resume of a solve needs.
//
// Per axis of n input samples (2n output samples), input i gathers
//
//   gin[i] = 0.25 g[2i-1] + w0 g[2i] + w1 g[2i+1] + 0.25 g[2i+2]
//
// with w0 = 0.75 (1 at i = 0, where the clamped source at 2i-1 moves its
// quarter onto the edge sample), w1 = 0.75 (1 at i = n-1), and g outside
// [0, 2n) read as 0 (so n = 1 gives g[0] + g[1]). The sum is rounded after
// each multiply and add (no contraction), in that order, along W, then H,
// then D: the plain version in ops/upsample.py does the same tensor ops in
// the same order, so the two agree bit for bit in float32. In 3D this is a
// separable 4 x 4 x 4 stencil over grad_out.
//
// What bounds it on an H100 (3.35 TB/s): bytes. grad_out is 2^nd times the
// input's size and is read once; grad_in is written once: (8 + 1) x the
// input's bytes in 3D, (4 + 1) in 2D, at a few flops a byte.
//
// Design.
//  * A block owns one (n, c) plane's tile of TH x TW input samples (a thread
//    each) and, in 3D, a range of D planes that it walks in order, so the
//    D halo is read once a range and not once a plane.
//  * Each step stages two output planes' tiles, (2 TH + 2) x (2 TW + 2) with
//    a one-sample halo, in shared memory as float32, reduces them along W
//    into shared memory and along H into registers: the thread's value for
//    each output plane. A ring of two such values from the step before gives
//    the four D taps of its input plane.
//  * float32 throughout; grad_in is rounded once to its dtype (bf16 or
//    float32, round to nearest even).
// 64-bit offsets throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned short bf16_bits;

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const bf16_bits* p, long long i) {
  return __uint_as_float(static_cast<unsigned>(p[i]) << 16);
}
__device__ __forceinline__ void store(float* p, long long i, float x) { p[i] = x; }
__device__ __forceinline__ void store(bf16_bits* p, long long i, float x) {
  p[i] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// 0.25 a + w0 b + w1 c + 0.25 d, each product and sum rounded, in this order
__device__ __forceinline__ float gather4(float a, float b, float c, float d, int i, int n) {
  const float w0 = i == 0 ? 1.0f : 0.75f;
  const float w1 = i == n - 1 ? 1.0f : 0.75f;
  float s = __fmul_rn(0.25f, a);
  s = __fadd_rn(s, __fmul_rn(w0, b));
  s = __fadd_rn(s, __fmul_rn(w1, c));
  return __fadd_rn(s, __fmul_rn(0.25f, d));
}

struct Tile {
  int th, tw;         // input samples of the tile: rows, columns (= blockDim.y, .x)
  int rows, cols;     // its output tile with the halo: 2 th + 2, 2 tw + 2
};

// The thread's H- and W-reduced value of output planes j0 and j0 + 1 (0 for
// a plane outside [0, dout)) into v[0], v[1]; `nplanes` is 1 or 2.
template <typename T>
__device__ __forceinline__ void reduce_planes(const T* __restrict__ g, long long plane0, int j0,
                                              int nplanes, int dout, int hh, int ww, int h0,
                                              int w0, int h, const Tile& t, float* sg, float* sw,
                                              float (&v)[2]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int ho = 2 * hh, wo = 2 * ww;  // output rows and columns
  const int per_plane = t.rows * t.cols;
  __syncthreads();  // the previous call's W reduction is done with sg
  for (int q = tid; q < nplanes * per_plane; q += nthreads) {
    const int p = q / per_plane, rc = q - p * per_plane;
    const int r = rc / t.cols, c = rc - r * t.cols;
    const int j = j0 + p, oh = 2 * h0 - 1 + r, ow = 2 * w0 - 1 + c;
    float x = 0.0f;
    if (j >= 0 && j < dout && oh >= 0 && oh < ho && ow >= 0 && ow < wo)
      x = load(g, ((plane0 + j) * ho + oh) * static_cast<long long>(wo) + ow);
    sg[q] = x;
  }
  __syncthreads();
  // along W: output tile row r, input column w0 + l, from columns 2l .. 2l + 3
  const int wrows = nplanes * t.rows;
  for (int q = tid; q < wrows * t.tw; q += nthreads) {
    const int pr = q / t.tw, l = q - pr * t.tw;
    const float* s = sg + pr * t.cols + 2 * l;
    sw[q] = gather4(s[0], s[1], s[2], s[3], w0 + l, ww);
  }
  __syncthreads();
  // along H: input row h, from W-reduced rows 2 (h - h0) .. + 3
  const int l = threadIdx.x, m = threadIdx.y;
  for (int p = 0; p < nplanes; ++p) {
    const float* s = sw + (p * t.rows + 2 * m) * t.tw + l;
    v[p] = gather4(s[0], s[t.tw], s[2 * t.tw], s[3 * t.tw], h, hh);
  }
}

// g: (planes, dout, 2H, 2W); gin: (planes, D, H, W) with dout = 2 D in 3D;
// in 2D D = dout = 1 and the D pass is skipped. Grid: x = plane x H tile x
// W tile, y = range of `span` D planes.
template <typename T>
__global__ void upsample_bwd_kernel(const T* __restrict__ g, T* __restrict__ gin, int d, int hh,
                                    int ww, int has_d, int span, int tiles_h, int tiles_w) {
  extern __shared__ float smem[];
  Tile t;
  t.tw = blockDim.x;
  t.th = blockDim.y;
  t.rows = 2 * t.th + 2;
  t.cols = 2 * t.tw + 2;
  float* sg = smem;                        // 2 planes x rows x cols
  float* sw = smem + 2 * t.rows * t.cols;  // 2 planes x rows x tw

  const long long bx = blockIdx.x;
  const long long tiles = static_cast<long long>(tiles_h) * tiles_w;
  const long long plane = bx / tiles;
  const int tile = static_cast<int>(bx - plane * tiles);
  const int h0 = (tile / tiles_w) * t.th, w0 = (tile % tiles_w) * t.tw;
  const int h = h0 + threadIdx.y, w = w0 + threadIdx.x;
  const bool mine = h < hh && w < ww;
  const long long hw = static_cast<long long>(hh) * ww;

  if (!has_d) {
    float v[2];
    reduce_planes(g, plane, 0, 1, 1, hh, ww, h0, w0, h, t, sg, sw, v);
    if (mine) store(gin, plane * hw + static_cast<long long>(h) * ww + w, v[0]);
    return;
  }
  const int dout = 2 * d;
  const long long plane0 = plane * dout;
  const int d0 = blockIdx.y * span, d1 = min(d, d0 + span);
  float prev[2], next[2];  // output planes 2 i - 1, 2 i; then 2 i + 1, 2 i + 2
  reduce_planes(g, plane0, 2 * d0 - 1, 2, dout, hh, ww, h0, w0, h, t, sg, sw, prev);
  for (int i = d0; i < d1; ++i) {
    reduce_planes(g, plane0, 2 * i + 1, 2, dout, hh, ww, h0, w0, h, t, sg, sw, next);
    if (mine)
      store(gin, (plane * d + i) * hw + static_cast<long long>(h) * ww + w,
            gather4(prev[0], prev[1], next[0], next[1], i, d));
    prev[0] = next[0];
    prev[1] = next[1];
  }
}

}  // namespace

extern "C" {

// grad_in (planes, D, H, W) of the x2 linear upsample from grad_out (planes,
// 2D, 2H, 2W) (has_d) or, in 2D, (planes, 2H, 2W) into (planes, H, W) with
// d = 1. A block is tw x th threads over a tile of the input and walks
// `span` D planes. Returns the launch's CUDA error.
int dpi_upsample_bwd(const void* g, void* gin, long long planes, int d, int h, int w, int has_d,
                     int bf16, int th, int tw, int span, void* stream) {
  const int tiles_h = (h + th - 1) / th, tiles_w = (w + tw - 1) / tw;
  const long long bx = planes * tiles_h * tiles_w;
  const int by = has_d ? (d + span - 1) / span : 1;
  if (bx <= 0 || bx > 0x7fffffffLL || by > 65535 || th * tw > 1024) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bx), by), block(tw, th);
  // two planes of the output tile, then of its W reduction
  const size_t smem = sizeof(float) * 2 * (2 * th + 2) * ((2 * tw + 2) + tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    upsample_bwd_kernel<bf16_bits><<<grid, block, smem, st>>>(
        static_cast<const bf16_bits*>(g), static_cast<bf16_bits*>(gin), d, h, w, has_d, span,
        tiles_h, tiles_w);
  else
    upsample_bwd_kernel<float><<<grid, block, smem, st>>>(
        static_cast<const float*>(g), static_cast<float*>(gin), d, h, w, has_d, span, tiles_h,
        tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
