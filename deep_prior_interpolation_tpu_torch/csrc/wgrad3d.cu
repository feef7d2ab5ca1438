// Weight gradient of a same-pad, stride-1, batch-1 3D convolution.
//
// Replaces the Pallas TPU kernel in
// deep_prior_interpolation_tpu/ops/pallas_wgrad.py (_make_kernel, reached
// through _pallas_wgrad_unpadded / pallas_wgrad_s1), in the port's NCDHW
// layout:
//
//   x (1, Ci, D, H, W), dy (1, Co, D, H, W)  ->  dW (Co, Ci, k, k, k) float32
//   dW[co, ci, t] = sum_s dy[co, s] * x[ci, s + t - p],   p = (k - 1) / 2
//
// with zero padding implicit: taps that fall outside the volume are masked
// on all three axes and nothing is padded in device memory. Both operands
// are contiguous along the flattened spatial axis s (V = D*H*W), which is
// therefore the contraction axis: huge (4.19 M at the flagship) against a
// tiny Co x Ci output (at most a few hundred by a hundred).
//
// What bounds it on an H100: bytes. The heaviest flagship shape (67 -> 4
// at full resolution) must read x and dy once, (67+4) * 4.19 M * 2 B =
// 595 MB, ~178 us at 3.35 TB/s, while its 61 GFLOP take ~61 us at the bf16
// tensor-core rate.
//
// Two kernels, one per input type; each writes per-split float32 partial
// sums to a workspace [splits][Co][Ci][taps] that a third kernel sums in a
// fixed split order (no float atomics: deterministic).
//
// bfloat16 (the flagship's net), wgrad3d_mma: tensor cores through
// mma.sync m16n8k16 (bf16 in, float32 accumulate).
//  * grid (tap pair (t0, t1), ci-tile of 16 x co-tile of 8*NT, row split).
//    A block reads, for each (d, h) row of dy in its split, the one x row
//    (d + t0 - p, h + t1 - p) that the pair needs; all k W-taps t2 come from
//    that row in shared memory, shifted. So x is read k^2 = 9 times from
//    L2/device memory (not 27), and the pair is the fastest grid index so the
//    9 blocks of a split run together and share those reads in L2.
//  * each of the 4 warps takes its own rows and stages a 64-wide w segment
//    of x (16 ci, with the zero halo) and of dy (8*NT co) in its own shared
//    memory, then runs k * NT mma per 16 positions: M = ci, N = co, K = w.
//    Rows whose x row lies outside the volume read only padding: skipped.
//  * the 4 warps' accumulators are summed through shared memory at the end.
//  * staging moves 8 bf16 per 16-byte load when the rows are aligned
//    (W % 8 == 0, the flagship's case), else one at a time; smem row strides
//    of 72 (dy) and 88 (x) bf16 keep the fragment reads free of bank conflicts.
// float32 (nets with dtype float32, which must stay float32), wgrad3d_fma:
//  * grid (tap, co-tile x ci-tile, K-split); one tap per block, so x is read
//    27 times (k = 3), the tap the fastest grid index for L2 reuse.
//  * 256 threads stride over the block's K-slab of positions; each keeps a
//    CO_T x CI_T register tile (64 float32 accumulators) and does CO_T * CI_T
//    FMAs per position on CUDA cores; warp shuffles and shared memory reduce
//    the block's tile.
// 64-bit offsets throughout (Ci * V reaches 2.8e8 at the flagship).
// Not yet done (the ways to the bound): read x once for all 27 taps (a 3D
// halo tile), double-buffer the staging with cp.async/TMA, wgmma.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---- float32: CUDA cores -----------------------------------------------

template <int CO_T, int CI_T>
__global__ void __launch_bounds__(kThreads)
wgrad3d_fma(const float* __restrict__ x, const float* __restrict__ dy,
            float* __restrict__ ws, int ci, int co, int D, int H, int W, int k,
            long long slab) {
  const int tap = blockIdx.x;
  const int n_ci_tiles = (ci + CI_T - 1) / CI_T;
  const int ci0 = (blockIdx.y % n_ci_tiles) * CI_T;
  const int co0 = (blockIdx.y / n_ci_tiles) * CO_T;
  const int split = blockIdx.z;
  const int p = (k - 1) / 2;
  const int dd = tap / (k * k) - p;
  const int dh = (tap / k) % k - p;
  const int dw = tap % k - p;
  const long long V = (long long)D * H * W;
  const long long off = ((long long)dd * H + dh) * W + dw;
  const int n_co = co - co0 < CO_T ? co - co0 : CO_T;
  const int n_ci = ci - ci0 < CI_T ? ci - ci0 : CI_T;
  const float* xb = x + (long long)ci0 * V;
  const float* dyb = dy + (long long)co0 * V;

  float acc[CO_T][CI_T];
#pragma unroll
  for (int a = 0; a < CO_T; ++a)
#pragma unroll
    for (int b = 0; b < CI_T; ++b) acc[a][b] = 0.f;

  const long long HW = (long long)H * W;
  const long long s_begin = (long long)split * slab;
  const long long s_end = s_begin + slab < V ? s_begin + slab : V;
  for (long long s = s_begin + threadIdx.x; s < s_end; s += kThreads) {
    const int d = (int)(s / HW);
    const int rem = (int)(s - d * HW);
    const int h = rem / W;
    const int w = rem - h * W;
    if ((unsigned)(d + dd) >= (unsigned)D || (unsigned)(h + dh) >= (unsigned)H ||
        (unsigned)(w + dw) >= (unsigned)W)
      continue;  // the tap reads the zero padding
    const long long src = s + off;
    float dv[CO_T], xv[CI_T];
#pragma unroll
    for (int a = 0; a < CO_T; ++a) dv[a] = a < n_co ? dyb[a * V + s] : 0.f;
#pragma unroll
    for (int b = 0; b < CI_T; ++b) xv[b] = b < n_ci ? xb[b * V + src] : 0.f;
#pragma unroll
    for (int a = 0; a < CO_T; ++a)
#pragma unroll
      for (int b = 0; b < CI_T; ++b) acc[a][b] = fmaf(dv[a], xv[b], acc[a][b]);
  }

  __shared__ float red[kWarps][CO_T * CI_T];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < CO_T; ++a)
#pragma unroll
    for (int b = 0; b < CI_T; ++b) {
      float v = acc[a][b];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][a * CI_T + b] = v;
    }
  __syncthreads();
  const long long taps = (long long)k * k * k;
  float* wsb = ws + (long long)split * co * ci * taps;
  for (int i = threadIdx.x; i < CO_T * CI_T; i += kThreads) {
    const int a = i / CI_T;
    const int b = i % CI_T;
    if (a < n_co && b < n_ci) {
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) v += red[wi][i];
      wsb[((long long)(co0 + a) * ci + (ci0 + b)) * taps + tap] = v;
    }
  }
}

// ---- bfloat16: tensor cores ------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kSeg = 64;       // w positions per staged segment
constexpr int kDyStride = 72;  // dy smem row: 36 words = 4 mod 32 banks
constexpr int kXStride = 88;   // x smem row: 44 words = 12 mod 32 banks
constexpr int kXOff = 8;       // x segment interior starts 16-byte aligned

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// NT: co tile of 8 * NT; KW: kernel size. Block = 4 warps. vec: every row
// of x and dy starts 16-byte aligned (W % 8 == 0, aligned bases), so the
// staging moves 8 bf16 per load; otherwise one at a time.
template <int NT, int KW>
__global__ void __launch_bounds__(kMmaWarps * 32)
wgrad3d_mma(const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
            float* __restrict__ ws, int ci, int co, int D, int H, int W, int slab_rows,
            int vec) {
  constexpr int P = (KW - 1) / 2;
  constexpr int XW = kSeg + 2 * P;  // staged x width (with the halo)
  constexpr int X0 = kXOff - P;     // smem column of the segment's first x
  constexpr int COT = 8 * NT;
  static_assert(P <= kXOff && kXOff + kSeg + P <= kXStride, "x segment overflows its row");
  __shared__ __align__(16) uint16_t xs[kMmaWarps][16][kXStride];
  __shared__ __align__(16) uint16_t dys[kMmaWarps][COT][kDyStride];
  __shared__ float red[kMmaWarps][NT * 4][32];

  const int t0 = blockIdx.x / KW;
  const int t1 = blockIdx.x % KW;
  const int n_ci_tiles = (ci + 15) / 16;
  const int ci0 = (blockIdx.y % n_ci_tiles) * 16;
  const int co0 = (blockIdx.y / n_ci_tiles) * COT;
  const int split = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // mma group: A/C row, B column
  const int tg = lane & 3;   // thread in group
  const long long V = (long long)D * H * W;
  const uint16_t* xb = x + (long long)ci0 * V;
  const uint16_t* dyb = dy + (long long)co0 * V;
  uint16_t (*xw)[kXStride] = xs[warp];
  uint16_t (*dw)[kDyStride] = dys[warp];

  float acc[KW][NT][4];
#pragma unroll
  for (int a = 0; a < KW; ++a)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][n][j] = 0.f;

  const int rows = D * H;
  const int r_begin = split * slab_rows;
  const int r_end = r_begin + slab_rows < rows ? r_begin + slab_rows : rows;
  for (int r = r_begin + warp; r < r_end; r += kMmaWarps) {
    const int d = r / H;
    const int h = r - d * H;
    const int xd = d + t0 - P;
    const int xh = h + t1 - P;
    if ((unsigned)xd >= (unsigned)D || (unsigned)xh >= (unsigned)H) continue;
    const long long dy_row = (long long)r * W;
    const long long x_row = ((long long)xd * H + xh) * W;
    for (int w0 = 0; w0 < W; w0 += kSeg) {
      __syncwarp();
      if (vec) {
        // whole 8-wide chunks: in range or not at all, since W % 8 == 0
        for (int i = lane; i < COT * (kSeg / 8); i += 32) {
          const int c = i / (kSeg / 8);
          const int j = i - c * (kSeg / 8);
          const int w = w0 + 8 * j;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (co0 + c < co && w < W)
            v = *reinterpret_cast<const uint4*>(dyb + (long long)c * V + dy_row + w);
          *reinterpret_cast<uint4*>(&dw[c][8 * j]) = v;
        }
        for (int i = lane; i < 16 * (kSeg / 8); i += 32) {
          const int c = i / (kSeg / 8);
          const int j = i - c * (kSeg / 8);
          const int w = w0 + 8 * j;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (ci0 + c < ci && w < W)
            v = *reinterpret_cast<const uint4*>(xb + (long long)c * V + x_row + w);
          *reinterpret_cast<uint4*>(&xw[c][kXOff + 8 * j]) = v;
        }
        for (int i = lane; i < 16 * 2 * P; i += 32) {  // the halo, both sides
          const int c = i / (2 * P);
          const int e = i - c * (2 * P);
          const int col = e < P ? X0 + e : kXOff + kSeg + (e - P);
          const int gw = w0 + col - kXOff;
          uint16_t v = 0;
          if (ci0 + c < ci && (unsigned)gw < (unsigned)W) v = xb[(long long)c * V + x_row + gw];
          xw[c][col] = v;
        }
      } else {
        for (int i = lane; i < COT * kSeg; i += 32) {
          const int c = i / kSeg;
          const int w = i - c * kSeg;
          uint16_t v = 0;
          if (co0 + c < co && w0 + w < W) v = dyb[(long long)c * V + dy_row + w0 + w];
          dw[c][w] = v;
        }
        for (int i = lane; i < 16 * XW; i += 32) {
          const int c = i / XW;
          const int w = i - c * XW;
          const int gw = w0 - P + w;
          uint16_t v = 0;
          if (ci0 + c < ci && (unsigned)gw < (unsigned)W) v = xb[(long long)c * V + x_row + gw];
          xw[c][X0 + w] = v;
        }
      }
      __syncwarp();
#pragma unroll
      for (int ks = 0; ks < kSeg / 16; ++ks) {
        const int k0 = ks * 16 + 2 * tg;
        uint32_t b[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // B[k][n] = dy[co0 + 8n + g][w0 + k]: k = 2tg, 2tg+1 | 2tg+8, 2tg+9
          b[n][0] = *reinterpret_cast<const uint32_t*>(&dw[8 * n + g][k0]);
          b[n][1] = *reinterpret_cast<const uint32_t*>(&dw[8 * n + g][k0 + 8]);
        }
#pragma unroll
        for (int t2 = 0; t2 < KW; ++t2) {
          // A[m][k] = x[ci0 + m][w0 + k + t2 - P] = xw[m][X0 + k + t2]
          const int kk = X0 + k0 + t2;
          const uint32_t a0 = pack2(xw[g][kk], xw[g][kk + 1]);
          const uint32_t a1 = pack2(xw[g + 8][kk], xw[g + 8][kk + 1]);
          const uint32_t a2 = pack2(xw[g][kk + 8], xw[g][kk + 9]);
          const uint32_t a3 = pack2(xw[g + 8][kk + 8], xw[g + 8][kk + 9]);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_bf16(acc[t2][n], a0, a1, a2, a3, b[n][0], b[n][1]);
        }
      }
    }
  }

  // sum the 4 warps' tiles; C[m][n]: c0,c1 -> (g, 2tg+{0,1}), c2,c3 -> (g+8, ...)
  const long long taps = (long long)KW * KW * KW;
  float* wsb = ws + (long long)split * co * ci * taps;
#pragma unroll
  for (int t2 = 0; t2 < KW; ++t2) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][n * 4 + j][lane] = acc[t2][n][j];
    __syncthreads();
    if (warp == 0) {
      const long long tap = ((long long)t0 * KW + t1) * KW + t2;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = 0.f;
#pragma unroll
          for (int wi = 0; wi < kMmaWarps; ++wi) v += red[wi][n * 4 + j][lane];
          const int cim = ci0 + g + (j >= 2 ? 8 : 0);
          const int con = co0 + 8 * n + 2 * tg + (j & 1);
          if (cim < ci && con < co) wsb[((long long)con * ci + cim) * taps + tap] = v;
        }
    }
    __syncthreads();
  }
}

// out[i] = sum over splits of ws[split][i], in split order.
__global__ void wgrad3d_reduce(const float* __restrict__ ws, float* __restrict__ out,
                               long long n, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += ws[(long long)s * n + i];
    out[i] = v;
  }
}

template <int CO_T, int CI_T>
cudaError_t launch_fma_tile(const float* x, const float* dy, float* ws, int ci, int co, int D,
                            int H, int W, int k, int splits, cudaStream_t stream) {
  const long long V = (long long)D * H * W;
  const long long slab = (V + splits - 1) / splits;
  const int tiles = ((co + CO_T - 1) / CO_T) * ((ci + CI_T - 1) / CI_T);
  const dim3 grid(k * k * k, tiles, splits);
  wgrad3d_fma<CO_T, CI_T><<<grid, kThreads, 0, stream>>>(x, dy, ws, ci, co, D, H, W, k, slab);
  return cudaGetLastError();
}

cudaError_t launch_fma(const float* x, const float* dy, float* ws, int ci, int co, int D,
                       int H, int W, int k, int splits, int tile, cudaStream_t stream) {
  switch (tile) {
    case 4: return launch_fma_tile<4, 16>(x, dy, ws, ci, co, D, H, W, k, splits, stream);
    case 8: return launch_fma_tile<8, 8>(x, dy, ws, ci, co, D, H, W, k, splits, stream);
    case 16: return launch_fma_tile<16, 4>(x, dy, ws, ci, co, D, H, W, k, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int NT, int KW>
cudaError_t launch_mma_nt(const void* x, const void* dy, float* ws, int ci, int co, int D,
                          int H, int W, int splits, int vec, cudaStream_t stream) {
  const int tiles = ((co + 8 * NT - 1) / (8 * NT)) * ((ci + 15) / 16);
  const int slab_rows = (D * H + splits - 1) / splits;
  const dim3 grid(KW * KW, tiles, splits);
  wgrad3d_mma<NT, KW><<<grid, kMmaWarps * 32, 0, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy), ws, ci, co, D, H, W,
      slab_rows, vec);
  return cudaGetLastError();
}

template <int KW>
cudaError_t launch_mma(const void* x, const void* dy, float* ws, int ci, int co, int D,
                       int H, int W, int splits, int tile, int vec, cudaStream_t stream) {
  switch (tile) {
    case 1: return launch_mma_nt<1, KW>(x, dy, ws, ci, co, D, H, W, splits, vec, stream);
    case 2: return launch_mma_nt<2, KW>(x, dy, ws, ci, co, D, H, W, splits, vec, stream);
    case 4: return launch_mma_nt<4, KW>(x, dy, ws, ci, co, D, H, W, splits, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dy: device pointers to contiguous (1, Ci|Co, D, H, W) tensors of one
// dtype (is_bf16 ? bfloat16 : float32); ws: float32 [splits, Co*Ci*k^3];
// out: float32 (Co, Ci, k, k, k). bfloat16: k in {3, 5, 7}, tile = NT in
// {1, 2, 4} (co tile 8*NT), splits of (d, h) rows, vec = 1 only if W % 8 == 0
// and x, dy are 16-byte aligned. float32: any odd k, tile = co tile in
// {4, 8, 16} (ci tile 64/tile), splits of positions; vec unused.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int dpi_wgrad3d(const void* x, const void* dy, float* ws, float* out,
                           int ci, int co, int D, int H, int W, int k, int splits,
                           int tile, int is_bf16, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (!is_bf16) {
    err = launch_fma(static_cast<const float*>(x), static_cast<const float*>(dy), ws, ci, co,
                     D, H, W, k, splits, tile, st);
  } else if (k == 3) {
    err = launch_mma<3>(x, dy, ws, ci, co, D, H, W, splits, tile, vec, st);
  } else if (k == 5) {
    err = launch_mma<5>(x, dy, ws, ci, co, D, H, W, splits, tile, vec, st);
  } else if (k == 7) {
    err = launch_mma<7>(x, dy, ws, ci, co, D, H, W, splits, tile, vec, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)co * ci * k * k * k;
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  wgrad3d_reduce<<<(int)blocks, 256, 0, st>>>(ws, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}
