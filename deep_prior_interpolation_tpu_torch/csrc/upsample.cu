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
// the same order, so the two agree bit for bit in float32, and in bf16,
// where the float32 sum is rounded once. In 3D this is a separable
// 4 x 4 x 4 stencil over grad_out.
//
// What bounds it on an H100 (3.35 TB/s): bytes. grad_out is 2^nd times the
// input's size and is read once; grad_in is written once: (8 + 1) x the
// input's bytes in 3D, (4 + 1) in 2D, at a few flops a byte.
//
// Two kernels, chosen up front by ops/upsample.py's planner (`plan`), never
// one after the other failed:
//
// upsample_bwd_tma, wherever TMA can read grad_out: its rows (2W elements)
// a multiple of 16 bytes and its base 16-byte aligned.
//  * A tensor map sees grad_out as (2W, 2H, 2D, planes) (3D) or (2W, 2H,
//    planes) (2D). A block owns a TH x TW tile of input samples in each of P
//    planes and walks a range of D planes (3D) or of groups of P planes
//    (2D). Each step is one box of (2 TW + pad) x (2 TH + 2) output samples
//    of the tile with its one-sample halo, by 2 output D planes (3D) or 1,
//    by P planes. It starts at output row 2 h0 - 1 and at column 2 w0 - A,
//    16 bytes left of the tile (TMA takes no inner start that is not a
//    multiple of 16 bytes), and spans 2 TW + 2 A columns. TMA fills what
//    lies outside the tensor, negative coordinates included, with zeros:
//    that is "g outside [0, 2n) reads as 0" on every axis, D too, since D
//    is an axis of its own in the map.
//  * Thread 0 keeps `stages` boxes in flight in a ring of shared-memory
//    stages, each with a `full` mbarrier (TMA's byte count) and an `empty`
//    one (one arrive a warp). Warps compute a stage as soon as it lands and
//    release it by an arrive; thread 0 refills it with the box `stages`
//    steps ahead. No __syncthreads() after the set-up.
//  * A thread owns 4 adjacent input columns of K input rows of one plane:
//    it reads each of its 2 K + 2 staged rows with one (bf16) or two
//    (float32) 16-byte shared loads and two of 4 bytes, reduces it along W into
//    4 values in registers, and folds those into its K x 4 H sums in row
//    order. In 3D the H-reduced values of the step before (output planes
//    2i - 1, 2i) stay in registers and meet this step's (2i + 1, 2i + 2) in
//    the D pass, so each output plane is staged once a range. Tile, stage
//    and thread indices come from compile-time tile sizes: no division in
//    the loops. A thread stores its 4 columns with one 8- (bf16) or 16-byte
//    (float32) store a row.
//
// upsample_bwd_direct, for every other gradient (rows of 2, 6, 10, ... bf16
// elements; a view at an unaligned offset): each step stages two output
// planes' tiles in shared memory as float32 with plain loads, reduces them
// along W into shared memory and along H into registers, with a ring of two
// such values for the D taps.
//
// Both: float32 throughout, grad_in rounded once to its dtype (bf16 or
// float32, round to nearest even); 64-bit offsets.

#include <cuda.h>  // CUtensorMap and its enums; the encode call is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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
__device__ __forceinline__ float gather4w(float a, float b, float c, float d, float w0, float w1) {
  float s = __fmul_rn(0.25f, a);
  s = __fadd_rn(s, __fmul_rn(w0, b));
  s = __fadd_rn(s, __fmul_rn(w1, c));
  return __fadd_rn(s, __fmul_rn(0.25f, d));
}

// the weights of input i of n: w0 (1 at i = 0) and w1 (1 at i = n - 1)
__device__ __forceinline__ float edge0(int i) { return i == 0 ? 1.0f : 0.75f; }
__device__ __forceinline__ float edge1(int i, int n) { return i == n - 1 ? 1.0f : 0.75f; }

__device__ __forceinline__ float gather4(float a, float b, float c, float d, int i, int n) {
  return gather4w(a, b, c, d, edge0(i), edge1(i, n));
}

// ---- upsample_bwd_direct ----------------------------------------------------

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
__global__ void upsample_bwd_direct(const T* __restrict__ g, T* __restrict__ gin, int d, int hh,
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

// ---- upsample_bwd_tma -------------------------------------------------------

constexpr int kMaxStages = 8;
constexpr int kBarBytes = 128;  // kMaxStages full, then kMaxStages empty mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// The staged output samples p[-1] .. p[8] as float32 (p 16-byte aligned):
// one 16-byte shared load and two of 4 bytes.
__device__ __forceinline__ void load_row(const bf16_bits* p, float (&x)[10]) {
  const uint32_t a = *reinterpret_cast<const uint32_t*>(p - 2);
  const uint4 b = *reinterpret_cast<const uint4*>(p);
  const uint32_t c = *reinterpret_cast<const uint32_t*>(p + 8);
  const uint32_t u[4] = {b.x, b.y, b.z, b.w};
  x[0] = __uint_as_float(a & 0xffff0000u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i + 1] = __uint_as_float(u[i] << 16);
    x[2 * i + 2] = __uint_as_float(u[i] & 0xffff0000u);
  }
  x[9] = __uint_as_float(c << 16);
}
__device__ __forceinline__ void load_row(const float* p, float (&x)[10]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = p[-1];
  x[1] = a.x, x[2] = a.y, x[3] = a.z, x[4] = a.w;
  x[5] = b.x, x[6] = b.y, x[7] = b.z, x[8] = b.w;
  x[9] = p[8];
}

// Four adjacent results at p, 4-element aligned, in one store.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16_bits* p, const float (&v)[4]) {
  uint32_t b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = __bfloat16_as_ushort(__float2bfloat16_rn(v[j]));
  *reinterpret_cast<uint2*>(p) = make_uint2(b[0] | b[1] << 16, b[2] | b[3] << 16);
}

// TMA reads a box from an inner coordinate whose byte offset is a multiple
// of 16 (an odd one is an illegal instruction): a box row starts A = 16
// bytes left of the tile's first output column 2 w0 (A samples: 8 bf16, 4
// float32), so its halo sample 2 w0 - 1 is at A - 1, and spans 2 TW + 2 A.
template <typename T>
__host__ __device__ constexpr int box_lead() {
  return 16 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int box_cols(int tw) {
  return 2 * tw + 2 * box_lead<T>();
}

template <typename T, int TW, int TH, int K, int P, bool HAS_D>
struct TmaShape {
  static constexpr int CG = TW / 4, RG = TH / K;         // thread columns, thread rows
  static constexpr int THREADS = P * RG * CG, WARPS = THREADS / 32;
  static constexpr int LEAD = box_lead<T>(), BC = box_cols<T>(TW), BR = 2 * TH + 2;
  static constexpr int NDP = HAS_D ? 2 : 1;
  static constexpr int PLANE = BR * BC;                  // elements of a staged plane
  static constexpr uint32_t BYTES = P * NDP * PLANE * sizeof(T);  // of a box
  static constexpr int PITCH = (BYTES + 127) / 128 * 128;          // between stages
  static_assert(TW % 4 == 0 && TH % K == 0 && THREADS % 32 == 0, "tile");
};

// g (through `map`): (planes, 2D, 2H, 2W) in 3D, (planes, 2H, 2W) in 2D;
// gin: (planes, D, H, W), D = 1 in 2D. Grid x: tile (fastest), plane group
// (3D), range; a range is `span` D planes (3D) or `span` plane groups (2D)
// of the `units` there are (D, or the plane groups).
template <typename T, int TW, int TH, int K, int P, bool HAS_D>
__global__ void __launch_bounds__(TmaShape<T, TW, TH, K, P, HAS_D>::THREADS)
    upsample_bwd_tma(const __grid_constant__ CUtensorMap map, T* __restrict__ gin, int planes,
                     int d, int hh, int ww, int tiles_w, int tiles, int groups, int units,
                     int span, int stages) {
  using S = TmaShape<T, TW, TH, K, P, HAS_D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem_raw + kBarBytes;

  const int t = threadIdx.x;
  const int cg = t % S::CG, rg = (t / S::CG) % S::RG, p = t / (S::CG * S::RG);
  int b = blockIdx.x;
  const int tile = b % tiles;
  b /= tiles;
  const int grp = b % groups, first = (b / groups) * span;
  const int w0 = (tile % tiles_w) * TW, h0 = (tile / tiles_w) * TH;
  // loads: 3D, span + 1 pairs of output planes (2i - 1, 2i) from i = first;
  // 2D, span plane groups
  const int n = min(span, units - first) + (HAS_D ? 1 : 0);

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const CUtensorMap* mp = &map;
  auto issue = [&](int k, int s) {
    mbar_expect_tx(&full[s], S::BYTES);
    if constexpr (HAS_D)
      tma_load_4d(ring + s * S::PITCH, mp, 2 * w0 - S::LEAD, 2 * h0 - 1, 2 * (first + k) - 1,
                  grp * P, &full[s]);
    else
      tma_load_3d(ring + s * S::PITCH, mp, 2 * w0 - S::LEAD, 2 * h0 - 1, (first + k) * P,
                  &full[s]);
  };
  if (t == 0)
    for (int k = 0; k < min(stages, n); ++k) issue(k, k);

  float w0w[4], w1w[4], w0h[K], w1h[K];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w0w[j] = edge0(w0 + 4 * cg + j);
    w1w[j] = edge1(w0 + 4 * cg + j, ww);
  }
#pragma unroll
  for (int m = 0; m < K; ++m) {
    w0h[m] = edge0(h0 + rg * K + m);
    w1h[m] = edge1(h0 + rg * K + m, hh);
  }
  // along W, then along H, in the plain version's order: the thread's K x 4
  // values of one staged plane (its rows 2 rg K .. 2 rg K + 2 K + 1)
  auto reduce = [&](const T* src, float (&acc)[K][4]) {
#pragma unroll
    for (int r = 0; r < 2 * K + 2; ++r) {
      float x[10], v[4];
      load_row(src + r * S::BC, x);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = gather4w(x[2 * j], x[2 * j + 1], x[2 * j + 2], x[2 * j + 3], w0w[j], w1w[j]);
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int q = r - 2 * m;  // which of output row m's four taps row r is
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (q == 0) acc[m][j] = __fmul_rn(0.25f, v[j]);
          if (q == 1) acc[m][j] = __fadd_rn(acc[m][j], __fmul_rn(w0h[m], v[j]));
          if (q == 2) acc[m][j] = __fadd_rn(acc[m][j], __fmul_rn(w1h[m], v[j]));
          if (q == 3) acc[m][j] = __fadd_rn(acc[m][j], __fmul_rn(0.25f, v[j]));
        }
      }
    }
  };
  const int w = w0 + 4 * cg;
  const bool vec = ww % 4 == 0;
  auto put = [&](long long plane, int i, const float (&v)[K][4]) {
    if (plane >= planes || w >= ww) return;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int h = h0 + rg * K + m;
      if (h >= hh) return;
      T* dst = gin + ((plane * d + i) * hh + h) * static_cast<long long>(ww) + w;
      if (vec) {
        store4(dst, v[m]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (w + j < ww) store(dst, j, v[m][j]);
      }
    }
  };

  const int offset = p * S::NDP * S::PLANE + 2 * rg * K * S::BC + S::LEAD + 8 * cg;
  float prev[2][K][4];
  int s = 0;
  uint32_t phase = 0;
  for (int k = 0; k < n; ++k) {
    mbar_wait(&full[s], phase);
    const T* src = reinterpret_cast<const T*>(ring + s * S::PITCH) + offset;
    float cur[S::NDP][K][4];
#pragma unroll
    for (int q = 0; q < S::NDP; ++q) reduce(src + q * S::PLANE, cur[q]);
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(&empty[s]);
    if (t == 0 && k + stages < n) {
      mbar_wait(&empty[s], phase);  // every warp is done with the stage
      issue(k + stages, s);
    }
    if constexpr (HAS_D) {
      if (k > 0) {
        const int i = first + k - 1;
        const float a = edge0(i), c = edge1(i, d);
        float out[K][4];
#pragma unroll
        for (int m = 0; m < K; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            out[m][j] = gather4w(prev[0][m][j], prev[1][m][j], cur[0][m][j], cur[1][m][j], a, c);
        put(static_cast<long long>(grp) * P + p, i, out);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int m = 0; m < K; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) prev[q][m][j] = cur[q][m][j];
    } else {
      put(static_cast<long long>(first + k) * P + p, 0, cur[0]);
    }
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
}

// ---- host -------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

template <typename T, int TW, int TH, int K, int P, bool HAS_D>
cudaError_t launch_tma(const void* g, void* gin, int planes, int d, int h, int w, int stages,
                       int span, cudaStream_t st) {
  using S = TmaShape<T, TW, TH, K, P, HAS_D>;
  auto* kernel = upsample_bwd_tma<T, TW, TH, K, P, HAS_D>;
  const long long esz = sizeof(T);
  if ((2 * w * esz) % 16 || reinterpret_cast<uintptr_t>(g) % 16 || stages < 1 ||
      stages > kMaxStages || span < 1)
    return cudaErrorInvalidValue;
  const int tiles_w = (w + TW - 1) / TW, tiles = tiles_w * ((h + TH - 1) / TH);
  const int pgroups = (planes + P - 1) / P;
  const int groups = HAS_D ? pgroups : 1, units = HAS_D ? d : pgroups;
  const long long blocks = static_cast<long long>(tiles) * groups * ((units + span - 1) / span);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = kBarBytes + stages * S::PITCH;

  // cuTensorMapEncodeTiled (a cu* entry point) fails without a context
  // current on this thread; autograd's device thread has none before its
  // first CUDA call, and this kernel may be a backward's first node.
  // cudaSetDevice makes the device's primary context current.
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorInvalidValue;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const cuuint64_t wo = 2 * w, ho = 2 * h, dout = 2 * d;
  const cuuint64_t dims[4] = {wo, ho, HAS_D ? dout : static_cast<cuuint64_t>(planes),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[3] = {wo * esz, ho * wo * esz, dout * ho * wo * esz};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(S::BC), static_cast<cuuint32_t>(S::BR),
                             HAS_D ? 2u : static_cast<cuuint32_t>(P), static_cast<cuuint32_t>(P)};
  const cuuint32_t estr[4] = {1u, 1u, 1u, 1u};
  if (enc(&map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
          HAS_D ? 4 : 3, const_cast<void*>(g), dims, strides, box, estr,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;

  // raise this kernel's shared-memory limit once a device
  static uint64_t raised = 0;
  if (!(raised >> (dev & 63) & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    raised |= 1ull << (dev & 63);
  }
  kernel<<<static_cast<unsigned>(blocks), S::THREADS, smem, st>>>(
      map, static_cast<T*>(gin), planes, d, h, w, tiles_w, tiles, groups, units, span, stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// grad_in (planes, D, H, W) of the x2 linear upsample from grad_out (planes,
// 2D, 2H, 2W) (has_d) or, in 2D, (planes, 2H, 2W) into (planes, H, W) with
// d = 1, by upsample_bwd_direct. A block is tw x th threads over a tile of
// the input and walks `span` D planes. Returns the launch's CUDA error.
int dpi_upsample_bwd_direct(const void* g, void* gin, long long planes, int d, int h, int w,
                            int has_d, int bf16, int th, int tw, int span, void* stream) {
  const int tiles_h = (h + th - 1) / th, tiles_w = (w + tw - 1) / tw;
  const long long bx = planes * tiles_h * tiles_w;
  const int by = has_d ? (d + span - 1) / span : 1;
  if (bx <= 0 || bx > 0x7fffffffLL || by > 65535 || th * tw > 1024) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bx), by), block(tw, th);
  // two planes of the output tile, then of its W reduction
  const size_t smem = sizeof(float) * 2 * (2 * th + 2) * ((2 * tw + 2) + tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    upsample_bwd_direct<bf16_bits><<<grid, block, smem, st>>>(
        static_cast<const bf16_bits*>(g), static_cast<bf16_bits*>(gin), d, h, w, has_d, span,
        tiles_h, tiles_w);
  else
    upsample_bwd_direct<float><<<grid, block, smem, st>>>(
        static_cast<const float*>(g), static_cast<float*>(gin), d, h, w, has_d, span, tiles_h,
        tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// The same by upsample_bwd_tma, with tile configuration `cfg` (an index of
// ops/upsample.py's TMA_CONFIGS: TW, TH, K, P), a ring of `stages` boxes and
// `span` D planes (3D) or plane groups (2D) a block. g must be 16-byte
// aligned and 2 w x its element size a multiple of 16 bytes. Launches on
// `stream`, does not synchronise; returns a CUDA error code, 0 on success.
int dpi_upsample_bwd_tma(const void* g, void* gin, int planes, int d, int h, int w, int has_d,
                         int bf16, int cfg, int stages, int span, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DPI_TMA(ID, TW, TH, K, P)                                                              \
  case ID:                                                                                     \
    if (bf16 && has_d)                                                                         \
      return launch_tma<bf16_bits, TW, TH, K, P, true>(g, gin, planes, d, h, w, stages, span, st); \
    if (bf16)                                                                                  \
      return launch_tma<bf16_bits, TW, TH, K, P, false>(g, gin, planes, d, h, w, stages, span, st); \
    if (has_d)                                                                                 \
      return launch_tma<float, TW, TH, K, P, true>(g, gin, planes, d, h, w, stages, span, st); \
    return launch_tma<float, TW, TH, K, P, false>(g, gin, planes, d, h, w, stages, span, st);
  switch (cfg) {
    DPI_TMA(0, 64, 16, 4, 1)
    DPI_TMA(1, 32, 16, 4, 2)
    DPI_TMA(2, 16, 16, 4, 4)
    DPI_TMA(3, 8, 8, 4, 16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DPI_TMA
}

}  // extern "C"
