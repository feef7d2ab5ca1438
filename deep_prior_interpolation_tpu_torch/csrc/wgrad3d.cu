// Weight gradient of a same-pad, stride-1, batch-1 3D convolution, for one
// lane or for B lanes (B independent convolutions of one shape) at once.
//
// Replaces the Pallas TPU kernel in
// deep_prior_interpolation_tpu/ops/pallas_wgrad.py (_make_kernel, reached
// through _pallas_wgrad_unpadded / pallas_wgrad_s1), in the port's NCDHW
// layout:
//
//   x (1, Ci, D, H, W), dy (1, Co, D, H, W)  ->  dW (Co, Ci, k, k, k) float32
//   dW[co, ci, t] = sum_s dy[co, s] * x[ci, s + t - p],   p = (k - 1) / 2
//
// with zero padding implicit. The contraction axis is the volume (4.19 M
// positions at the flagship) against a tiny Co x Ci x k^3 output.
//
// Lanes: x (B, Ci, D, H, W) and dy (B, Co, D, H, W) give dW (B, Co, Ci, k,
// k, k) in one launch, lane b's dW from lane b's x and dy alone: the
// counterpart of the batching rule of pallas_call under jax.vmap, which adds
// the lane as a grid dimension. Here the lane is the outer part of the
// grid's z (z = lane * dranges + D range), so the clusters of a tile's
// splits never span two lanes; the tensor maps have the lane as a fifth dim,
// so a box past a lane's channels is zero-filled as it is at B = 1. Every
// lane runs the one-lane grid on its own data, so each lane's dW is
// bit-identical to a one-lane launch of the same plan.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s fp32):
//  * full resolution (256x128x128), bf16: bytes. 67 -> 4 must read
//    (67 + 4) * 4.19 M * 2 B = 595 MB, 0.178 ms, against 61 GFLOP, 0.061 ms.
//  * deep levels (32x16x16, 16x8x8), bf16: operations and latency. 212 -> 128
//    reads 5.6 MB (1.7 us) but does 12 GFLOP (12 us) over only 8,192
//    positions, so the grid must come from channel tiles and D ranges, and
//    each block's few steps pay its pipeline fill and its sums.
//  * float32 (CUDA-core FMAs): operations. 25 -> 16 at full resolution is
//    91 GFLOP, 1.35 ms at 67 TFLOP/s.
//
// Design. S is the streamed operand and R the shifted one; the wrapper
// (ops/wgrad.py) plans the grid and, at a shape's first call, times its
// candidate grids, with either operand as S. With S = x the sum reads
// dW[co, ci, t] = sum_s x[ci, s] dy[co, s + t' - p] with the tap flipped
// (t' = k - 1 - t per axis), so the kernel always computes
// out[S][R][u] = sum_s S[s] R[s + u - p].
//  * Plane walk: a block owns a tile of S channels x R channels x taps and
//    a band of hb rows (all of W), and walks a range of D planes. S is
//    streamed through shared memory once, one plane a step; R sits in a
//    ring of t0b + stages - 1 planes (t0b = k for k = 3), so the k depth taps
//    reuse it: every plane of both operands is read once per block.
//  * Staging: TMA (cp.async.bulk.tensor; 5D tensor maps made on the host
//    with cuTensorMapEncodeTiled, found through the runtime's driver entry
//    point, so no -lcuda) when rows are 16-byte aligned. One thread issues,
//    an mbarrier per stage reports, and `stages` (2-4) planes are in flight
//    while the block computes. R boxes start at w = -8 (16 bytes) and h = -p,
//    so the zero halo on every edge comes from the copy's out-of-bounds
//    fill. Other widths and unaligned bases take plain loads in the same
//    kernel, into the same layout.
//  * Flat S (bf16, W % 8 == 0): the band's hb rows lie end to end and each
//    channel, not each row, is padded to an odd number of 16-byte units. So
//    no position of W = 16, 32 or 8 is wasted, ldmatrix is free of bank
//    conflicts (8 channels, 8 bank groups), and bands may be even (8 rows at
//    H = 16 and 8). R's rows are padded to an odd number of 16-byte units,
//    and its ring planes to an odd number of rows, for the same reason.
//  * bf16: tensor cores, mma.sync m16n8k16, M = S channels, N = R channels
//    (R of at most 4 channels: R channels x taps), K = 16 flattened
//    positions of the band. A comes from ldmatrix.x4 and feeds the 9
//    (t1, t2) taps of the warp's t0; B of the three t2 shifts of a row is
//    cut from three aligned 32-bit loads with byte permutes. A warp holds
//    mt (1-3) m-tiles x 9 taps of accumulators.
//  * float32: FMAs on CUDA cores, the same walk and staging. A thread holds
//    4 S x 4 R channels x the k W taps of one (t0, t1). float32 stays
//    float32: no TF32.
//  * Sums: the block's tile goes through shared memory to dW's layout, in
//    runs of contiguous floats. A launch of one split (band x D range)
//    writes dW; of 2-8 splits, the splits of a tile form a thread-block
//    cluster whose blocks add their tiles through distributed shared memory
//    in rank order; of more, blocks write float32 workspace planes that a
//    second kernel adds 16 at a time in a fixed order. No atomics: the
//    result is bit-identical from call to call.
// 64-bit offsets for global memory (Ci * V reaches 2.8e8 at the flagship).
//
// Still left (PERF.md has the figures): wgmma, which would read both
// operands from shared memory once per warpgroup, where mma.sync fragments
// make shared-memory bandwidth the limit of the deep shapes (212 -> 128 runs
// at about cuDNN's speed); at full resolution the copies and the compute of
// a block run more in sequence than overlapped, so 67 -> 4 stays at ~2.5x
// its bound; and TMA multicast within a cluster would cut the L2 reads of
// S tiles that several blocks share.

#include <cuda.h>  // CUtensorMap and its enums; the driver call is found at run time
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

struct Plan {
  int sc, rc, D, H, W, k;                  // S and R channels, volume, kernel
  int mt, mg, nb, rcw, wt, t0b, hb, rsw, rsr, scs;  // tile shape (see ops/wgrad.py Plan)
  int planes, sgroups, ngroups, bands, dranges, stages;
  int xs;                                  // 1: S is x (taps flipped)
  int tma;
  int lanes;                               // B: independent convolutions
};

constexpr int kBarBytes = 128;   // up to 16 mbarriers, one a stage
constexpr int kMaxCluster = 8;   // splits summed in a cluster's shared memory, at most
constexpr int kZeroBytes = 128;  // a zero chunk for the half k-step past a row

__host__ __device__ __forceinline__ long long r128(long long n) { return (n + 127) / 128 * 128; }

// S staged flat: the band's hb rows of W (= rsw) positions end to end, each
// channel padded to scs (an odd number of 16-byte units) instead of each row.
__host__ __device__ __forceinline__ bool flat_s(const Plan& P) { return P.scs != P.hb * P.rsw; }

// Rows of an R plane in the ring: the band and its k - 1 halo rows, one more
// when that is even (hb even, flat S only), so that R's channel stride is an
// odd number of 16-byte units too.
__host__ __device__ __forceinline__ int ring_rows(const Plan& P) { return (P.hb + P.k - 1) | 1; }

// ---- PTX wrappers -------------------------------------------------------

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

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of the same shared-memory location in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// ---- staging: where a block is, and its plane walk ----------------------

// Shared memory: [mbarriers | zero chunk | `stages` S stages of cs x scs |
// R ring of t0b + stages - 1 planes of cr x rr x rsr], and at the end the
// block's tile of sums over the stages. An R row starts at
// w = -8 (bf16) or -4 (float32): a TMA box must start on a 16-byte boundary
// of the row, so the -p halo sits inside those columns.
template <typename T>
struct Block {
  int lane, s0, r0, tb, h0, d_lo, nsteps, e0, split, p, rr, nslot, cs, cr, wpad;
  long long sstage, rplane;  // elements of one S stage / one R plane
  T* S;
  T* R;
  uint64_t* bar;
  T* zero;
  __device__ __forceinline__ T* s_of(int step, int stages) const {
    return S + (long long)(step % stages) * sstage;
  }
  __device__ __forceinline__ T* r_of(int j) const { return R + (long long)(j % nslot) * rplane; }
};

template <typename T>
__device__ __forceinline__ Block<T> block_of(const Plan& P, unsigned char* smem, int cs, int cr) {
  Block<T> b;
  const int tapblocks = P.k / P.t0b;
  const int ng = blockIdx.x % P.ngroups;
  const int rest = blockIdx.x / P.ngroups;
  b.tb = rest % tapblocks;
  b.s0 = (rest / tapblocks) * cs;
  b.r0 = ng * cr;
  b.cs = cs;
  b.cr = cr;
  const int dz = blockIdx.z % P.dranges;
  b.lane = blockIdx.z / P.dranges;
  b.h0 = blockIdx.y * P.hb;
  b.d_lo = dz * P.planes;
  b.nsteps = min(P.D, b.d_lo + P.planes) - b.d_lo;
  b.p = (P.k - 1) / 2;
  b.e0 = b.d_lo + b.tb * P.t0b - b.p;  // the first R plane of the ring
  b.split = blockIdx.y * P.dranges + dz;
  b.rr = ring_rows(P);
  b.nslot = P.t0b + P.stages - 1;
  b.wpad = 16 / (int)sizeof(T);
  b.sstage = r128((long long)cs * P.scs * sizeof(T)) / sizeof(T);
  b.rplane = r128((long long)cr * b.rr * P.rsr * sizeof(T)) / sizeof(T);
  b.bar = reinterpret_cast<uint64_t*>(smem);
  b.zero = reinterpret_cast<T*>(smem + kBarBytes);
  b.S = reinterpret_cast<T*>(smem + kBarBytes + kZeroBytes);
  b.R = b.S + P.stages * b.sstage;
  return b;
}

// Step i reads S plane d_lo + i and R planes e0 + j for the block's local j
// in [i, i + t0b); step 0 brings all t0b, every later step the last one.
// R plane j lives in ring slot j % nslot, which step i + stages refills
// once step i, the last to read plane i, is done.
template <typename T>
__device__ __forceinline__ void issue(const Plan& P, const Block<T>& b, int i,
                                      const CUtensorMap* smap, const CUtensorMap* rmap) {
  uint64_t* bar = b.bar + (i % P.stages);
  const int j_lo = i == 0 ? 0 : i + P.t0b - 1;
  const int j_hi = i + P.t0b;
  const uint32_t sbox = (uint32_t)(b.cs * P.scs * sizeof(T));
  const uint32_t rbox = (uint32_t)(b.cr * b.rr * P.rsr * sizeof(T));
  mbar_expect_tx(bar, sbox + (uint32_t)(j_hi - j_lo) * rbox);
  if (flat_s(P))
    tma_load_5d(b.s_of(i, P.stages), smap, b.h0 * P.W, 0, b.d_lo + i, b.s0, b.lane, bar);
  else
    tma_load_5d(b.s_of(i, P.stages), smap, 0, b.h0, b.d_lo + i, b.s0, b.lane, bar);
  for (int j = j_lo; j < j_hi; ++j)
    tma_load_5d(b.r_of(j), rmap, -b.wpad, b.h0 - b.p, b.e0 + j, b.r0, b.lane, bar);
}

// The same boxes by plain loads, all threads: dst[c][r][j] =
// src[c0 + c][d][h0 + r][w0 + j], zero outside the volume; `flat`: the plane
// is one row of H x W positions.
template <typename T>
__device__ __forceinline__ void load_box(T* dst, const T* __restrict__ src, const Plan& P, int C,
                                         int c0, int nch, int d, int h0, int rows, int w0,
                                         int width, bool flat = false) {
  const int per_ch = rows * width;
  const long long HW = (long long)P.H * P.W;
  const unsigned row_len = flat ? (unsigned)HW : (unsigned)P.W;
  const bool plane_in = (unsigned)d < (unsigned)P.D;
  for (int idx = threadIdx.x; idx < nch * per_ch; idx += blockDim.x) {
    const int c = idx / per_ch;
    const int rem = idx - c * per_ch;
    const int r = rem / width;
    const int h = h0 + r;
    const int w = w0 + rem - r * width;
    T v = T(0);
    if (plane_in && c0 + c < C && (unsigned)h < (unsigned)P.H && (unsigned)w < row_len)
      v = src[((long long)(c0 + c) * P.D + d) * HW + (long long)h * P.W + w];
    dst[idx] = v;
  }
}

// Before the walk: barriers, the zero chunk, the first `stages` steps in flight.
template <typename T>
__device__ __forceinline__ void walk_begin(const Plan& P, const Block<T>& b,
                                           const CUtensorMap* smap, const CUtensorMap* rmap) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < P.stages; ++s) mbar_init(b.bar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < kZeroBytes / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(b.zero)[i] = 0u;
  __syncthreads();
  if (P.tma && threadIdx.x == 0)
    for (int i = 0; i < P.stages && i < b.nsteps; ++i) issue(P, b, i, smap, rmap);
}

// The block's lane of a (B, C, D, H, W) operand of C channels.
template <typename T>
__device__ __forceinline__ const T* lane_of(const T* g, const Plan& P, const Block<T>& b, int C) {
  return g + (long long)b.lane * C * P.D * P.H * P.W;
}

// Step i's data is in shared memory when this returns.
template <typename T>
__device__ __forceinline__ void walk_wait(const Plan& P, const Block<T>& b, int i,
                                          const T* __restrict__ Sg, const T* __restrict__ Rg) {
  if (P.tma) {
    mbar_wait(b.bar + (i % P.stages), (i / P.stages) & 1);
    return;
  }
  Sg = lane_of(Sg, P, b, P.sc);
  Rg = lane_of(Rg, P, b, P.rc);
  __syncthreads();
  if (flat_s(P))  // the band's rows end to end: one "row" of scs positions from (h0, 0)
    load_box(b.s_of(i, P.stages), Sg, P, P.sc, b.s0, b.cs, b.d_lo + i, 0, 1, b.h0 * P.W, P.scs,
             true);
  else
    load_box(b.s_of(i, P.stages), Sg, P, P.sc, b.s0, b.cs, b.d_lo + i, b.h0, P.hb, 0, P.rsw);
  for (int j = i == 0 ? 0 : i + P.t0b - 1; j < i + P.t0b; ++j)
    load_box(b.r_of(j), Rg, P, P.rc, b.r0, b.cr, b.e0 + j, b.h0 - b.p, b.rr, -b.wpad, P.rsr);
  __syncthreads();
}

// After step i: once every warp is done with its buffers, refill them
// with step i + stages.
template <typename T>
__device__ __forceinline__ void walk_next(const Plan& P, const Block<T>& b, int i,
                                          const CUtensorMap* smap, const CUtensorMap* rmap) {
  if (!P.tma) return;
  __syncthreads();
  if (threadIdx.x == 0 && i + P.stages < b.nsteps) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    issue(P, b, i + P.stages, smap, rmap);
  }
}

// ---- the block's sums: through shared memory to dW's layout ---------------

// After the walk the block's sums go to a tile [co][ci][tap] in shared
// memory (over the S stages), its taps those of the tap block, in dW's order:
// tap u of the kernel is dW's tap t = u, or k - 1 - u on each axis when S is
// x. A tile row (one co) is ld = nci x taps floats, rounded up to odd so the
// lanes of a warp's stores spread over the banks. (sl, rl): S and R channel
// within the block; u0l: t0 within the block.
struct Tile {
  int btaps, nci, ld, co0, ci0, t_lo;
};

template <typename T>
__device__ __forceinline__ Tile tile_of(const Plan& P, const Block<T>& b) {
  Tile t;
  t.btaps = P.t0b * P.k * P.k;
  t.nci = P.xs ? b.cs : b.cr;
  t.ld = (t.nci * t.btaps) | 1;
  t.co0 = P.xs ? b.r0 : b.s0;
  t.ci0 = P.xs ? b.s0 : b.r0;
  t.t_lo = (P.xs ? P.k / P.t0b - 1 - b.tb : b.tb) * t.btaps;  // the tap block's first tap
  return t;
}

__device__ __forceinline__ int tile_at(const Plan& P, const Tile& t, int sl, int rl, int u0l,
                                       int u1, int u2) {
  const int k = P.k;
  const int tl = P.xs ? ((P.t0b - 1 - u0l) * k + k - 1 - u1) * k + k - 1 - u2
                      : (u0l * k + u1) * k + u2;
  return P.xs ? rl * t.ld + sl * t.btaps + tl : sl * t.ld + rl * t.btaps + tl;
}

// The tile's rows to dst: dW itself when the launch has one split, else the
// block's split of the workspace, in dW's layout: a warp a row, a row a
// contiguous run of floats for k = 3 (runs of k^2, one a ci, for k = 5, 7).
__device__ __forceinline__ void store_tile(const Plan& P, const Tile& t, int nco, int split,
                                           const float* tile, float* __restrict__ dst) {
  const int k = P.k;
  const int taps = k * k * k;
  const int Ci = P.xs ? P.sc : P.rc;
  const int Co = P.xs ? P.rc : P.sc;
  const int rows = min(nco, Co - t.co0);
  const int run = min(t.nci, Ci - t.ci0) * t.btaps;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  float* out = dst + (long long)split * Co * Ci * taps;
  for (int r = threadIdx.x >> 5; r < rows; r += warps) {
    const float* src = tile + r * t.ld;
    float* o = out + ((long long)(t.co0 + r) * Ci + t.ci0) * taps + t.t_lo;
    if (t.btaps == taps) {
      for (int i = lane; i < run; i += 32) o[i] = src[i];
    } else {
      for (int i = lane; i < run; i += 32) {
        const int c = i / t.btaps;
        o[c * taps + i - c * t.btaps] = src[i];
      }
    }
  }
}

// 2 to kMaxCluster splits: the launch makes the splits of one tile a cluster
// (1 x bands x dranges blocks). Every block's tile is read in place through
// distributed shared memory, summed in rank order and written to dW, each
// block taking every parts-th element: no workspace, no second kernel.
__device__ __forceinline__ void cluster_sum_tile(const Plan& P, const Tile& t, int nco,
                                                 const float* tile, float* __restrict__ out) {
  const int parts = P.bands * P.dranges;
  const int taps = P.k * P.k * P.k;
  const int Ci = P.xs ? P.sc : P.rc;
  const int Co = P.xs ? P.rc : P.sc;
  const int rows = min(nco, Co - t.co0);
  const int run = min(t.nci, Ci - t.ci0) * t.btaps;
  uint32_t base[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) base[q] = q < parts ? map_rank(smem_u32(tile), q) : 0u;
  cluster_sync();  // every block's tile is in its shared memory
  const int step = parts * blockDim.x;
  for (int idx = cluster_rank() * blockDim.x + threadIdx.x; idx < rows * t.ld; idx += step) {
    const int r = idx / t.ld;
    const int i = idx - r * t.ld;
    if (i >= run) continue;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < parts) v += ld_cluster(base[q] + 4u * (uint32_t)idx);
    const int c = i / t.btaps;
    out[((long long)(t.co0 + r) * Ci + t.ci0 + c) * taps + t.t_lo + i - c * t.btaps] = v;
  }
  cluster_sync();  // no block leaves while another reads its tile
}

// The block's tile to its lane's dW: alone, summed over its cluster, or to
// its split of the lane's workspace.
__device__ __forceinline__ void finish_tile(const Plan& P, const Tile& t, int nco, int split,
                                            int lane, const float* tile, float* __restrict__ dst) {
  const int parts = P.bands * P.dranges;
  dst += (long long)lane * (parts > kMaxCluster ? parts : 1) * P.sc * P.rc * P.k * P.k * P.k;
  if (parts > 1 && parts <= kMaxCluster)
    cluster_sum_tile(P, t, nco, tile, dst);
  else
    store_tile(P, t, nco, parts > 1 ? split : 0, tile, dst);
}

// ---- bfloat16: tensor cores ---------------------------------------------

// Warp w = (m-group, R group, tap group), tap group fastest. k = 3: the tap
// group is t0 and the warp holds its 9 (t1, t2) taps; k = 5, 7: the block
// holds one t0 (its tap block) and the warp one t1, k taps t2.
//
// A (S, 16 channels x 16 positions) comes from ldmatrix.x4. B (16 positions
// x 8 columns) for tap t2 starts t2 - p columns off the 4-byte grid when
// t2 - p is odd: a thread's pair of positions is then cut from two aligned
// 32-bit loads with a byte permute. RCW = 8: the 8 columns of an n-tile are
// 8 R channels of one tap, and the loads are shared by the taps of one row
// (t2 - p = -1, 0, 1 read the words at -2, 0 and 2 of the pair). RCW = 4,
// 2, 1 (R of at most 4, 2, 1 channels): an n-tile's columns are RCW
// channels times 8 / RCW taps, so few R channels fill the tile; each
// thread then keeps its own offset and byte selector for each n-tile.
template <int KW, int MT, int RCW>
__global__ void __launch_bounds__(MT < 3 ? 512 : 384, 1)
wgrad3d_mma(const uint16_t* __restrict__ Sg, const uint16_t* __restrict__ Rg,
            float* __restrict__ dst, const Plan P, const __grid_constant__ CUtensorMap smap,
            const __grid_constant__ CUtensorMap rmap) {
  constexpr int TPW = KW == 3 ? 9 : KW;
  constexpr int T1W = KW == 3 ? 3 : 1;  // t1 rows of taps a warp
  constexpr int PK = (KW - 1) / 2;
  constexpr int NT = RCW == 8 ? TPW : (TPW * RCW + 7) / 8;  // n-tiles a warp
  extern __shared__ __align__(128) unsigned char smem[];
  const Block<uint16_t> b = block_of<uint16_t>(P, smem, 16 * MT * P.mg, RCW * P.nb);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wt = warp % P.wt;
  const int nbi = (warp / P.wt) % P.nb;
  const int mgi = warp / (P.wt * P.nb);
  const int u0 = KW == 3 ? wt : b.tb;
  const int u1w = KW == 3 ? 0 : wt;  // the warp's first t1
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int chS = P.scs;
  const int chR = b.rr * P.rsr;
  const int u = P.rsw / 8;     // 8-position chunks a row
  const int nchunk = P.hb * u; // when odd, the last k-step's second half is past the band
  const int nks = (nchunk + 1) / 2;
  // A rows of ldmatrix.x4: lanes 0-15 k 0-7, 16-31 k 8-15; rows g, g + 8
  const int half_a = lane >> 4;
  uint32_t a_off[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
    a_off[m] = 2u * (uint32_t)((((mgi * MT + m) * 16) + (lane & 7) + ((lane >> 3) & 1) * 8) * chS +
                               half_a * 8);
  // B, RCW = 8: this thread's R channel and first position, from the row's
  // origin. RCW < 8: for n-tile j, column g is channel g % RCW of tap
  // (j * 8 + g) / RCW; its word offset and the byte selector of its shift.
  const int b_lane = (nbi * RCW + (RCW == 8 ? g : 0)) * chR + (u1w * P.rsr) + b.wpad + 2 * tg;
  int b_off[RCW == 8 ? 1 : NT];
  uint32_t b_sel[RCW == 8 ? 1 : NT];
  if (RCW < 8) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + g;
      const int tl = c / RCW < TPW ? c / RCW : TPW - 1;  // past the taps: any, dropped
      const int u1 = KW == 3 ? tl / 3 : wt;
      const int sft = (KW == 3 ? tl % 3 : tl) - PK;
      b_off[j] = (b_lane + (c % RCW) * chR + (u1 - u1w) * P.rsr) / 2 + (sft - (sft & 1)) / 2;
      b_sel[j] = (sft & 1) ? 0x5432u : 0x3210u;
    }
  }
  const uint32_t zero = smem_u32(b.zero);

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  walk_begin(P, b, &smap, &rmap);
  for (int i = 0; i < b.nsteps; ++i) {
    walk_wait(P, b, i, Sg, Rg);
    const int jr = i + u0 - b.tb * P.t0b;  // this warp's R plane, local index
    const int pl = b.e0 + jr;
    if ((unsigned)pl < (unsigned)P.D) {  // a plane outside the volume adds 0
      const uint32_t sb = smem_u32(b.s_of(i, P.stages));
      const uint16_t* rb = b.r_of(jr) + b_lane;
      int row0 = 0, col0 = 0;  // chunk 2 ks as (row, 8-column) of the band
#pragma unroll 2
      for (int ks = 0; ks < nks; ++ks) {
        const bool a_ok = 2 * ks + half_a < nchunk;
        uint32_t af[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldsm_x4(a_ok ? sb + a_off[m] + 32u * ks : zero, af[m][0], af[m][1], af[m][2], af[m][3]);
        // chunk 2 ks + 1 (k 8-15); past the band it pairs with A's zeros
        int row1 = row0, col1 = col0 + 1;
        if (col1 == u) { col1 = 0; ++row1; }
        if (2 * ks + 1 >= nchunk) { row1 = row0; col1 = col0; }
        if (RCW < 8) {
          const uint32_t* w0 = reinterpret_cast<const uint32_t*>(b.r_of(jr)) +
                               (row0 * P.rsr + 8 * col0) / 2;
          const uint32_t* w1 = reinterpret_cast<const uint32_t*>(b.r_of(jr)) +
                               (row1 * P.rsr + 8 * col1) / 2;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t b0 = __byte_perm(w0[b_off[j]], w0[b_off[j] + 1], b_sel[j]);
            const uint32_t b1 = __byte_perm(w1[b_off[j]], w1[b_off[j] + 1], b_sel[j]);
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j], af[m], b0, b1);
          }
        }
        const uint32_t* q0 = reinterpret_cast<const uint32_t*>(rb + row0 * P.rsr + 8 * col0);
        const uint32_t* q1 = reinterpret_cast<const uint32_t*>(rb + row1 * P.rsr + 8 * col1);
#pragma unroll
        for (int t1 = 0; t1 < (RCW == 8 ? T1W : 0); ++t1) {
          const uint32_t* r0 = q0 + t1 * (P.rsr / 2);
          const uint32_t* r1 = q1 + t1 * (P.rsr / 2);
#pragma unroll
          for (int t2 = 0; t2 < KW; ++t2) {
            const int sft = t2 - PK;  // compile-time after unrolling
            uint32_t b0, b1;
            if (sft % 2 == 0) {
              b0 = r0[sft / 2];
              b1 = r1[sft / 2];
            } else {
              const int lo = (sft - 1) / 2;
              b0 = __byte_perm(r0[lo], r0[lo + 1], 0x5432);
              b1 = __byte_perm(r1[lo], r1[lo + 1], 0x5432);
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_bf16(acc[m][(t1 * KW + t2) % NT], af[m], b0, b1);
          }
        }
        col0 += 2;
        while (col0 >= u) { col0 -= u; ++row0; }
      }
    }
    walk_next(P, b, i, &smap, &rmap);
  }

  // C fragment: c0, c1 -> (S row g, R col 2tg + {0, 1}); c2, c3 -> row g + 8.
  __syncthreads();  // every warp is done with the staged planes
  float* tile = reinterpret_cast<float*>(b.S);
  const Tile tt = tile_of(P, b);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * tg + (e & 1);  // of the n-tile
        const int tl = RCW == 8 ? j : (j * 8 + col) / RCW;
        const int sl = (mgi * MT + m) * 16 + g + (e >= 2 ? 8 : 0);
        const int rl = nbi * RCW + (RCW == 8 ? col : col % RCW);
        const int u1 = KW == 3 ? tl / 3 : wt;
        const int u2 = KW == 3 ? tl % 3 : tl;
        if (tl < TPW) tile[tile_at(P, tt, sl, rl, u0 - b.tb * P.t0b, u1, u2)] = acc[m][j][e];
      }
  __syncthreads();
  finish_tile(P, tt, P.xs ? b.cr : b.cs, b.split, b.lane, tile, dst);
}

// ---- float32: CUDA cores ----------------------------------------------

// Thread = (tap pair (t0, t1), 4-channel R group r4, 4-channel S group s4),
// s4 fastest. Channels interleave (s4 + a * mg) so the 8 lanes of a
// 16-byte load phase read 8 channels: 8 bank groups. Lanes past mg * nb * wt
// only stage.
template <int KW>
__global__ void __launch_bounds__(512, 1)
wgrad3d_fma(const float* __restrict__ Sg, const float* __restrict__ Rg, float* __restrict__ dst,
            const Plan P, const __grid_constant__ CUtensorMap smap,
            const __grid_constant__ CUtensorMap rmap) {
  constexpr int NW = KW + 3;  // R window of a 4-position chunk over k taps
  extern __shared__ __align__(128) unsigned char smem[];
  const Block<float> b = block_of<float>(P, smem, 4 * P.mg, 4 * P.nb);
  const int s4 = threadIdx.x % P.mg;
  const int rest = threadIdx.x / P.mg;
  const int r4 = rest % P.nb;
  const int wtg = rest / P.nb;
  const bool active = wtg < P.wt;
  const int u0 = KW == 3 ? wtg / 3 : b.tb;
  const int u1 = KW == 3 ? wtg % 3 : wtg;
  const int chS = P.scs;
  const int chR = b.rr * P.rsr;

  float acc[KW][4][4];
#pragma unroll
  for (int t = 0; t < KW; ++t)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][a][c] = 0.f;

  walk_begin(P, b, &smap, &rmap);
  for (int i = 0; i < b.nsteps; ++i) {
    walk_wait(P, b, i, Sg, Rg);
    const int jr = i + u0 - b.tb * P.t0b;
    if (active && (unsigned)(b.e0 + jr) < (unsigned)P.D) {
      const float* Sb = b.s_of(i, P.stages) + s4 * chS;
      const float* Rb = b.r_of(jr) + r4 * chR + u1 * P.rsr;
      for (int row = 0; row < P.hb; ++row) {
        const float* srow = Sb + row * P.rsw;
        const float* rrow = Rb + row * P.rsr;
        for (int q = 0; q < P.rsw; q += 4) {
          float4 sv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            sv[a] = *reinterpret_cast<const float4*>(srow + a * P.mg * chS + q);
          // column q + pos + t of S meets R column q + pos + t - p, stored
          // at q + pos + t - p + 4
          float rv[4][NW];
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int v = 0; v < NW; ++v) rv[c][v] = rrow[c * P.nb * chR + q + 4 - (KW - 1) / 2 + v];
#pragma unroll
          for (int t = 0; t < KW; ++t)
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                float s = acc[t][a][c];
                s = fmaf(sv[a].x, rv[c][t], s);
                s = fmaf(sv[a].y, rv[c][t + 1], s);
                s = fmaf(sv[a].z, rv[c][t + 2], s);
                s = fmaf(sv[a].w, rv[c][t + 3], s);
                acc[t][a][c] = s;
              }
        }
      }
    }
    walk_next(P, b, i, &smap, &rmap);
  }

  __syncthreads();  // every thread is done with the staged planes
  float* tile = reinterpret_cast<float*>(b.S);
  const Tile tt = tile_of(P, b);
  if (active)
#pragma unroll
    for (int t = 0; t < KW; ++t)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tile[tile_at(P, tt, s4 + a * P.mg, r4 + c * P.nb, u0 - b.tb * P.t0b, u1, t)] = acc[t][a][c];
  __syncthreads();
  finish_tile(P, tt, P.xs ? b.cr : b.cs, b.split, b.lane, tile, dst);
}

// The partial sums, in a fixed order: plane c * group * stride of `dst`
// (c = blockIdx.y) becomes the sum of planes (c * group + j) * stride of
// `src`, j < group. Passes in place with stride 1, 16, 256, ... and a last
// one into dW leave the total there. blockIdx.z is the lane: its planes lie
// src_lane (dst_lane) floats after the lane before's.
__global__ void wgrad3d_sum(const float* src, float* dst, long long n, int planes, int stride,
                            int group, long long src_lane, long long dst_lane) {
  src += blockIdx.z * src_lane;
  dst += blockIdx.z * dst_lane;
  const int first = blockIdx.y * group;
  const int last = min(first + group, (planes + stride - 1) / stride);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int j = first; j < last; ++j) v += src[(long long)j * stride * n + i];
    dst[(long long)first * stride * n + i] = v;
  }
}

// ---- host -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no -lcuda).
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

// A 5D map (W, H, D, C, B) of a contiguous (B, C, D, H, W) tensor, box
// (bw, bh, 1, bc, 1), zero fill outside (past a lane's C channels too).
bool make_map(CUtensorMap* map, const void* ptr, bool bf16, int B, int C, int D, int H, int W,
              int bw, int bh, int bc) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t esz = bf16 ? 2 : 4;
  const cuuint64_t dims[5] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)C,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {W * esz, (cuuint64_t)H * W * esz, (cuuint64_t)D * H * W * esz,
                                 (cuuint64_t)C * D * H * W * esz};
  const cuuint32_t box[5] = {(cuuint32_t)bw, (cuuint32_t)bh, 1u, (cuuint32_t)bc, 1u};
  const cuuint32_t estr[5] = {1u, 1u, 1u, 1u, 1u};
  return enc(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5,
             const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <auto kernel, typename T>
cudaError_t launch(dim3 grid, int threads, int smem, cudaStream_t st, const T* s, const T* r,
                   float* dst, const Plan& P, const CUtensorMap& sm, const CUtensorMap& rm) {
  // raise this kernel's shared-memory limit once a device, to the most it may take
  static uint64_t raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(raised >> (dev & 63) & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    raised |= 1ull << (dev & 63);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  const int parts = P.bands * P.dranges;
  if (parts > 1 && parts <= kMaxCluster) {  // the splits of a tile: one cluster
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = P.bands;
    attr[0].val.clusterDim.z = P.dranges;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, kernel, s, r, dst, P, sm, rm);
}

}  // namespace

// s, r: device pointers to contiguous (B, C, D, H, W) tensors of one dtype
// (bfloat16 or float32): S, the streamed operand, and R, the shifted one (x
// and dy if xs, else dy and x). out: float32 (B, Co, Ci, k, k, k); ws: float32
// [B, bands * dranges, Co*Ci*k^3], unused (may be null) with up to kMaxCluster
// splits. arg: 28 ints, in order is_bf16, tma, xs, then the fields of
// ops/wgrad.py's Plan from sc to smem, then B; tma = 1 only if every row and
// base is 16-byte aligned and every box dimension is <= 256.
// Launches on `stream`, does not synchronise; returns a CUDA error code, 0
// on success.
extern "C" int dpi_wgrad3d(const void* s, const void* r, float* ws, float* out, const int* arg,
                           void* stream) {
  const int is_bf16 = arg[0], tma = arg[1], xs = arg[2], sc = arg[3], rc = arg[4];
  const int D = arg[5], H = arg[6], W = arg[7], k = arg[8], mt = arg[9], mg = arg[10];
  const int nb = arg[11], rcw = arg[12], wt = arg[13], t0b = arg[14], hb = arg[15];
  const int rsw = arg[16], rsr = arg[17], scs = arg[18], planes = arg[19], sgroups = arg[20];
  const int ngroups = arg[21], bands = arg[22], dranges = arg[23], stages = arg[24];
  const int threads = arg[25], smem = arg[26], lanes = arg[27];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan P{sc, rc, D, H, W, k, mt, mg, nb, rcw, wt, t0b, hb, rsw, rsr, scs, planes, sgroups,
               ngroups, bands, dranges, stages, xs, tma, lanes};
  const int cs = is_bf16 ? 16 * mt * mg : 4 * mg;
  const int cr = is_bf16 ? rcw * nb : 4 * nb;
  CUtensorMap sm, rm;
  memset(&sm, 0, sizeof(sm));
  memset(&rm, 0, sizeof(rm));
  if (tma) {
    // cuTensorMapEncodeTiled (a cu* entry point, not the runtime's) fails
    // without a context current on this thread. A thread whose first CUDA
    // call this is has none yet: autograd's device thread, in a backward
    // whose first node is this conv. cudaSetDevice makes the device's
    // primary context current.
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaSetDevice(dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // S: boxes of rows (rsw, hb), or with flat_s one run of scs positions of
  // the plane seen as a single row of H x W
  if (tma && !((flat_s(P) ? make_map(&sm, s, is_bf16, lanes, sc, D, 1, H * W, scs, 1, cs)
                          : make_map(&sm, s, is_bf16, lanes, sc, D, H, W, rsw, hb, cs)) &&
               make_map(&rm, r, is_bf16, lanes, rc, D, H, W, rsr, ring_rows(P), cr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(sgroups * ngroups * (k / t0b), bands, dranges * lanes);
  const int splits = bands * dranges;
  float* dst = splits <= kMaxCluster ? out : ws;
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    const uint16_t* S = static_cast<const uint16_t*>(s);
    const uint16_t* R = static_cast<const uint16_t*>(r);
#define DPI_MMA(K, M, C)                                                                    \
  if (k == K && mt == M && rcw == C)                                                       \
    err = launch<wgrad3d_mma<K, M, C>>(grid, threads, smem, st, S, R, dst, P, sm, rm);
    DPI_MMA(3, 1, 8) DPI_MMA(3, 2, 8) DPI_MMA(3, 3, 8)
    DPI_MMA(3, 1, 4) DPI_MMA(3, 2, 4) DPI_MMA(3, 3, 4)
    DPI_MMA(3, 1, 2) DPI_MMA(3, 2, 2) DPI_MMA(3, 3, 2)
    DPI_MMA(3, 1, 1) DPI_MMA(3, 2, 1) DPI_MMA(3, 3, 1)
    DPI_MMA(5, 1, 8) DPI_MMA(7, 1, 8)
#undef DPI_MMA
  } else {
    const float* S = static_cast<const float*>(s);
    const float* R = static_cast<const float*>(r);
    if (k == 3) err = launch<wgrad3d_fma<3>>(grid, threads, smem, st, S, R, dst, P, sm, rm);
    if (k == 5) err = launch<wgrad3d_fma<5>>(grid, threads, smem, st, S, R, dst, P, sm, rm);
    if (k == 7) err = launch<wgrad3d_fma<7>>(grid, threads, smem, st, S, R, dst, P, sm, rm);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits <= kMaxCluster) return 0;
  // more than 16 splits: sum them 16 at a time in place first, then into dW
  const long long n = (long long)sc * rc * k * k * k;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  const long long ws_lane = (long long)splits * n;
  int stride = 1;
  for (; splits > 16 * stride; stride *= 16)
    wgrad3d_sum<<<dim3(blocks, (splits + 16 * stride - 1) / (16 * stride), lanes), 256, 0, st>>>(
        ws, ws, n, splits, stride, 16, ws_lane, ws_lane);
  wgrad3d_sum<<<dim3(blocks, 1, lanes), 256, 0, st>>>(ws, out, n, splits, stride,
                                                     (splits + stride - 1) / stride, ws_lane, n);
  return static_cast<int>(cudaGetLastError());
}
