// K6a: standalone 3x3 stride-1 SAME convolution + bias (+ ReLU), bf16 out;
// K6b: its weight gradient dW = sum_p x-patch(p)^T . g(p), f32.
//
// Replace the TPU kernels of `mmr_tpu/ops/pallas/conv3x3_packed.py`:
// `_conv_packed` (the `pl.pallas_call` at :283) and `_conv_packed_dw` (:323),
// reached through `conv3x3p_bias_act` (:375), whose VJP runs K6a again for
// dx (flipped, transposed taps, zero bias) and K6b for dW (:390-411).
//
// K6a computes, for NHWC bf16 x (n, height, width, cin) and HWIO weights
// rounded to bf16, y = conv3x3_SAME(x, W) + bias (f32 accumulation, bias
// added in f32, optional ReLU) stored bf16: K1 (fused_conv.cu) without its
// prologue, lazy upsample, concat and moments. K6b computes, for the same x
// and the bf16 output gradient g (n, height, width, cout),
// dW[tap][ci][co] = sum over pixels p of x(p + tap - 1)[ci] * g(p)[co] in f32
// (zero outside the image).
//
// The TPU kernels pack p pixels x cp channels into 128-lane rows and multiply
// block-Toeplitz tap matrices (up to 8x wasted MACs) so that no lane moves.
// That layout is not ported. K6a runs on common.cuh's conv_wg_kernel (M =
// one 64-pixel output row segment; block = 2 warpgroups x 4 rows at N <= 32
// output channels, 4 warpgroups x 2 rows at N = 64; per stage of a cp.async
// ring one 16-channel chunk's halo tile and its 9 taps for the block's N;
// wgmma m64nNk16 from shared memory). K6b has its own kernel,
// conv3x3_dw_kernel (below: its design and bound).
//
// Bound of K6a on an H100: at the Path-A decoder's shapes (output 64x64 ..
// 256x256, cin 16..320, cout 10..64) a conv moves 2*(cin + cout) bytes per
// pixel for 2*9*cin*cout operations: 9*cin*cout/(cin + cout) op/byte, from
// 55 (the head, 16 -> 10) to 480 (320 -> 64). The cin >= 128, cout = 64
// convs sit above the 295 op/byte ridge (tensor-core bound at best), the
// narrow ones below it (memory-bound).
//
// K8a / K8b: K8a on the narrow tile at cin, cout <= 32 (narrow_conv_kernel,
// below), on K6a's kernel above; K8b on K6b's; both at f32 storage as well.
// They replace the round-1 shifted-GEMM conv of
// `mmr_tpu/ops/pallas/conv3x3.py`:
// `_conv3x3_pallas` (the `pl.pallas_call` at :165) and `_conv3x3_dw_pallas`
// (:208), reached through `conv3x3_bias_act` (:250) when `_FORCE_PALLAS` is
// set; its VJP runs K8a again for dx and K8b for dW (:266-286). K8a takes
// x in any float type rounded to bf16 on chip (:96-97) and stores y in x's
// type (:179); an f32 x is rounded to bf16 as its tile is staged (through
// registers: cp.async does not convert; no separate cast pass), bias and
// ReLU stay in the f32 epilogue (:112-118).
// The TPU kernel's channel-major (B, C, (H+4)*Wp) canvas, lane rolls and
// (9C, P) tap stack (:60-97, :141-150) are its layout and are not ported.
// K8b reads dy in x's type, as the VJP passes it (g.astype(x.dtype)), and
// stages it as bf16 for the tensor-core products where the TPU kernel
// reads dy as f32: dW differs from an f32-dy reference by the rounding of
// dy, within the JAX suite's own bound for this kernel, 1e-2 of max|ref|
// (tests/test_conv3x3_kernel.py:41-52).
//
// conv3x3_dw_kernel (K6b, K8b). Bound on an H100: 2*9*cin*cout operations
// a pixel against 2*(cin + cout) bytes (x and g read once; dW is small).
// K8b's shape, 16 -> 16 on (32, 512, 512) bf16, does 72 op/byte, far below
// the 295 op/byte ridge: 537 MB or 0.160 ms. Path A's K6b launches run
// from 55 op/byte (the head's dW, 16 -> 10) to 480 (320 -> 64); the cout =
// 64 ones with cin >= 128 sit above the ridge (one smp_UNet++ step's 17
// launches: 0.221 ms summed). What the design does about it:
// - One input, no prologue, no lazy x2, so nothing passes through
//   registers on the way to shared memory: bf16 x and g with channels a
//   multiple of 8 come by TMA (one thread issues one box a 8-channel group
//   and tile, zero outside the tensor; an mbarrier a ring stage counts the
//   bytes), other even channel counts (the head's 10 output channels) by
//   4-byte cp.async; only odd channel counts (K8's 3, 5) and f32 storage
//   (K8b, rounded to bf16) are loaded into registers and stored. The
//   registers hold the accumulators.
// - Staging bounds the kernel (on an H100 SXM, K8b's copies alone took
//   0.365 ms at 4-row tiles, its products alone 0.12), and the halo rows
//   are staged again by the tile below, so tiles are as tall as shared
//   memory allows: 12, 8, 4 or 2 rows in 2-6 stages with 2 blocks a SM at
//   cin <= 32, 3 rows in 3 stages at 1 block a SM above (DwCfg).
// - Shared memory for the live channels only: a stage holds the pixel
//   tile's g (N/8 8-channel groups x kRows x 64 pixels, 16 bytes a pixel)
//   and x's halo tile ((kRows + 2) x 66 pixels) for 2 (cin <= 16), 4 (cin
//   <= 32) or 8 (a 64-channel chunk) groups. Consecutive pixels of a group
//   are consecutive 16-byte rows (one TMA box with an 8-channel inner
//   dimension writes exactly that), so every 8 x 8 matrix the tensor cores
//   read is 128 contiguous bytes (no bank conflict, no swizzle needed), and
//   a tap's operand is the same tile at a whole-row offset (no im2col).
// - cin <= 32 (K8b, K6b's 16- and 32-channel rows, K8's cin 3, 5, 10, 24):
//   mma.sync m16n8k16 with M = 16 input channels a fragment, so no M row is
//   wasted beyond rounding cin up to 16; A by ldmatrix.trans from the tap's
//   shifted pixel rows, B (g) likewise once per 16-pixel step for all 9
//   taps. Chosen over wgmma with M = 4 taps x 16 channels, which needs an
//   im2col copy of every tile (9x the shared-memory writes) and still
//   rounds 9 taps to 12: these shapes are memory-bound, and the legacy MMA
//   rate is far above what their bytes allow. 8 warps split N and the
//   pixels; each warp holds 9 taps x 2 fragments (72 f32) of sums.
// - cin > 32: wgmma m64nNk16, M = one 64-channel chunk of x, N = up to 64
//   output channels (cout 64 in one block: x staged once a chunk, not once
//   a 32-channel N tile), both operands from shared memory; warpgroup ky
//   keeps taps (ky, 0..2), 3 x N/2 f32 a thread.
// - Persistent grid from the card: blocks = rows x cols, cols = the x
//   chunks x the N tiles, rows = the SM count x the resident blocks a SM
//   (occupancy at the kernel's attributes, set on every launch) over cols.
//   Block (row, col) walks pixel tiles row, row + rows, ...; the blocks of
//   one grid row take the same tile together, so the chunks share g in L2.
// - Deterministic: each block writes one row of its sums (the warps of a
//   mma.sync block added in a fixed order through shared memory), and
//   dw_rows_reduce_kernel adds the rows in row order into HWIO dW. No
//   atomics, no zero fill: a second launch gives the same bits.

#include "narrow_tile.cuh"

namespace {

template <class T>
cudaError_t conv_fwd(const void* x, int cin, const void* wt,
                     const void* bias, void* y, int n, int height, int width,
                     int cout, int np, int ntile, int relu, cudaStream_t s) {
  WgParams<T> p{};
  p.a = static_cast<const T*>(x);
  p.c = cin;
  p.ah = height;
  p.aw = width;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.np = np;
  p.n = n;
  p.oh = height;
  p.ow = width;
  p.bias = static_cast<const float*>(bias);
  p.relu = relu;
  p.out[0].y = static_cast<T*>(y);
  p.out[0].c = cout;
  p.out[0].act = kNone;
  p.n_out = 1;
  return launch_conv_wg(ntile, p, s);
}

bool bad_shape(int cin, int cout, int np, int ntile) {
  return cin < 1 || cout < 1 || np < cout ||
         (ntile != 16 && ntile != 32 && ntile != 64) || np % ntile != 0;
}

// ------------------------------------------------------------- K6b / K8b

constexpr int kDwCols = 64;   // output pixels of a dW tile row

// kMode 0 (cin <= 16) and 1 (cin <= 32): mma.sync; 2: 64-channel chunks
// on wgmma. N: output channels a block (16, 32 or 64).
template <int kMode, int N>
struct DwCfg {
  static constexpr bool kWide = kMode == 2;
  static constexpr int kGroups = kWide ? 8 : 2 * (kMode + 1);  // of x
  static constexpr int kM = 8 * kGroups;          // x channels a block
  static constexpr int kThreads = kWide ? 384 : 256;
  static constexpr int kCols = kDwCols;
  // x rows of a group's halo tile at r tile rows, padded to a multiple of
  // 8 (each group starts on 128 bytes, as a TMA destination must)
  static constexpr int group_rows(int r) {
    return ((r + 2) * (kCols + 2) + 7) / 8 * 8;
  }
  // bytes of a stage at r tile rows
  static constexpr int stage_bytes(int r) {
    return 16 * (kGroups * group_rows(r) + N / 8 * r * kCols);
  }
  // the narrow modes' shared memory, 2 blocks a SM
  static constexpr int kNarrowSmem = 113 * 1024;
  // Tile rows: the halo rows are staged again by the tile below, and
  // staging bounds these kernels (on an H100 SXM at 700 W, K8b's copies
  // alone took 0.365 ms at 4 rows, 0.326 at 8), so tiles are as tall as
  // shared memory allows: 3 rows and 3 stages in the wide mode (1 block a
  // SM; 2 rows took 13 % longer, 4 rows in 2 stages 21 %), else the most
  // of 12, 8, 4, 2 rows whose 2 stages leave room for 2 blocks a SM, and as
  // many stages as fit kNarrowSmem (6 at most; K8b at 3 or 5 stages took
  // the same time).
  static constexpr int kRows = kWide                                  ? 3
                               : 2 * stage_bytes(12) <= kNarrowSmem ? 12
                               : 2 * stage_bytes(8) <= kNarrowSmem  ? 8
                               : 2 * stage_bytes(4) <= kNarrowSmem  ? 4
                                                                    : 2;
  static constexpr int kStages =
      kWide ? 3 : (kNarrowSmem / stage_bytes(kRows) < 6
                       ? kNarrowSmem / stage_bytes(kRows) : 6);
  static constexpr int kHalo = (kRows + 2) * (kCols + 2);  // x rows a group
  static constexpr int kGS = group_rows(kRows);            // their stride
  static constexpr int kPix = kRows * kCols;               // g rows a group
  static constexpr int kSteps = kPix / 16;                 // K steps a tile
  static constexpr int kXUnits = kGroups * kGS;
  static constexpr int kStageBytes = 16 * (kXUnits + N / 8 * kPix);
  // the ring, then one mbarrier a stage (the TMA copies' completion)
  static constexpr int kSmem = kStages * kStageBytes + 8 * kStages;
  static_assert(kStages >= 2, "the ring needs a tile in flight");
};

// the mma.sync modes' warps: m fragments (16 channels) and n fragments (8
// output channels) a warp, kNG warps along N x kKG along the K steps
template <int kMode, int N>
struct DwWarps {
  static constexpr int kMF = kMode + 1;
  static constexpr int kNF = 2 / kMF;
  static constexpr int kNG = N / (8 * kNF);
  static constexpr int kKG = 8 / kNG;
};

template <class T>
struct DwParams {
  const T* x;          // (n, height, width, cin)
  const T* g;          // (n, height, width, cout)
  float* part;         // (rows, len): one row of sums a grid row
  int cin, cout, n, height, width;
  int chunks, cols;    // kM-channel chunks of x; chunks x N tiles
  int cpad, np, len;   // kM * chunks, N * N tiles, 9 * cpad * np
  int rows, tiles_y, tiles_x, tiles;
  int xtma, gtma;      // x's / g's groups come by TMA (the maps)
  int xmode, gmode;    // else: DwStage of x and g
};

// Issue the copies of pixel tile t (x's halo tile for channels c0 ..
// c0 + kM, g's tile for output channels n0 .. n0 + N) into ring slot
// `slot`, whose mbarrier is `bar`: by TMA (thread 0, one box a group) where
// the maps allow, else by every thread (cp.async or registers).
template <int kMode, int N, class T>
__device__ __forceinline__ void dw_stage(const DwParams<T>& p,
                                         const CUtensorMap& tx,
                                         const CUtensorMap& tg, int t, int c0,
                                         int n0, unsigned char* slot,
                                         uint32_t bar) {
  using C = DwCfg<kMode, N>;
  const int per_image = p.tiles_y * p.tiles_x;
  const int b = t / per_image, r = t - b * per_image;
  const int py0 = r / p.tiles_x * C::kRows, px0 = r % p.tiles_x * C::kCols;
  const uint32_t sx = smem_addr(slot), sg = sx + 16 * C::kXUnits;
  if ((p.xtma || p.gtma) && threadIdx.x == 0) {
    mbar_expect_tx(bar, (p.xtma ? 16 * C::kGroups * C::kHalo : 0) +
                            (p.gtma ? 16 * (N / 8) * C::kPix : 0));
    if (p.xtma) {
#pragma unroll
      for (int grp = 0; grp < C::kGroups; ++grp)
        tma_load(sx + 16 * grp * C::kGS, tx, bar, c0 + 8 * grp, px0 - 1,
                 py0 - 1, b);
    }
    if (p.gtma) {
#pragma unroll
      for (int grp = 0; grp < N / 8; ++grp)
        tma_load(sg + 16 * grp * C::kPix, tg, bar, n0 + 8 * grp, px0, py0, b);
    }
  }
  // consecutive threads take consecutive 8-channel groups of a pixel, then
  // the next pixel: a warp copies contiguous runs of device memory
  if (!p.xtma) {
#pragma unroll 2
    for (int i = threadIdx.x; i < C::kGroups * C::kHalo;
         i += C::kThreads) {
      const int u = i / C::kGroups, grp = i - u * C::kGroups;
      const int yy = py0 - 1 + u / (C::kCols + 2);
      const int xx = px0 - 1 + u % (C::kCols + 2);
      const int c = c0 + 8 * grp;
      const bool in = yy >= 0 && yy < p.height && xx >= 0 && xx < p.width;
      dw_stage_row(slot + 16 * (grp * C::kGS + u), p.x,
                   ((size_t)(b * p.height + yy) * p.width + xx) * p.cin + c,
                   p.cin - c, in, p.xmode);
    }
  }
  if (!p.gtma) {
#pragma unroll 2
    for (int j = threadIdx.x; j < N / 8 * C::kPix; j += C::kThreads) {
      const int u = j / (N / 8), grp = j - u * (N / 8);
      const int yy = py0 + u / C::kCols, xx = px0 + u % C::kCols;
      const int c = n0 + 8 * grp;
      dw_stage_row(slot + 16 * (C::kXUnits + grp * C::kPix + u), p.g,
                   ((size_t)(b * p.height + yy) * p.width + xx) * p.cout + c,
                   p.cout - c, yy < p.height && xx < p.width, p.gmode);
    }
  }
  // rows stored through registers, read by wgmma (the async proxy)
  if (C::kWide && (p.xmode >= kRegs8 || p.gmode >= kRegs8))
    fence_proxy_async();
}

// The narrow modes' products over one staged tile: for each 16-pixel K step
// of the warp, B (g) by ldmatrix.trans once, then for each tap A (x at the
// tap's pixel shift) by ldmatrix.trans and the mma.sync of every fragment.
template <int kMode, int N>
__device__ __forceinline__ void dw_mma_tile(
    uint32_t sa,
    float (&acc)[9][DwWarps<kMode, N>::kMF][DwWarps<kMode, N>::kNF][4]) {
  using C = DwCfg<kMode, N>;
  using W = DwWarps<kMode, N>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = warp % W::kNG, kg = warp / W::kNG;
  const int j = lane >> 3, r = lane & 7;
  const uint32_t sb = sa + 16 * C::kXUnits;
#pragma unroll 1
  for (int i = 0; i < C::kSteps / W::kKG; ++i) {
    const int ks = kg + i * W::kKG;   // this warp's K steps
    const int rr = ks / (C::kCols / 16), px = ks % (C::kCols / 16) * 16;
    // matrix j: output-channel group ng * kNF + j / 2, pixels 8 * (j % 2) ..
    uint32_t bf[4];
    const uint32_t gb =
        sb + 16 * ((ng * W::kNF + (j >> 1)) * C::kPix + rr * C::kCols + px +
                   r + 8 * (j & 1));
    if constexpr (W::kNF == 2) ldsm_x4_t(bf, gb);
    else ldsm_x2_t(bf, gb);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int u0 = (rr + tap / 3) * (C::kCols + 2) + px + tap % 3;
#pragma unroll
      for (int mf = 0; mf < W::kMF; ++mf) {
        // matrix j: channel group 2 * mf + j % 2, pixels 8 * (j / 2) ..
        uint32_t a[4];
        ldsm_x4_t(a, sa + 16 * ((2 * mf + (j & 1)) * C::kGS + u0 + r +
                                8 * (j >> 1)));
#pragma unroll
        for (int nf = 0; nf < W::kNF; ++nf)
          mma16816(acc[tap][mf][nf], a, bf[2 * nf], bf[2 * nf + 1]);
      }
    }
  }
}

template <int kMode, int N, class T>
__global__ void __launch_bounds__(DwCfg<kMode, N>::kThreads,
                                  DwCfg<kMode, N>::kWide ? 1 : 2)
    conv3x3_dw_kernel(const DwParams<T> p,
                      const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tg) {
  using C = DwCfg<kMode, N>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int col = blockIdx.x % p.cols, row = blockIdx.x / p.cols;
  const int c0 = col % p.chunks * C::kM, n0 = col / p.chunks * N;
  const int mine = (p.tiles - row + p.rows - 1) / p.rows;  // tiles to do
  const uint32_t sbase = smem_addr(smem);
  const uint32_t bars = sbase + C::kStages * C::kStageBytes;
  float* out = p.part + (size_t)row * p.len;
  // stage q: tile row + q * rows into slot q % kStages, its barrier
  auto stage = [&](int q) {
    dw_stage<kMode, N>(p, tx, tg, row + q * p.rows, c0, n0,
                       smem + q % C::kStages * C::kStageBytes,
                       bars + 8 * (q % C::kStages));
  };
  // tile q has landed: its TMA boxes (the barrier's (q / kStages)-th phase)
  // and this thread's cp.async groups; then every thread's
  auto landed = [&](int q) {
    if (p.xtma || p.gtma)
      mbar_wait(bars + 8 * (q % C::kStages), (q / C::kStages) & 1);
    cp_async_wait<C::kStages - 2>();
    __syncthreads();
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < C::kStages - 1; ++q) {
    if (q < mine) stage(q);
    cp_async_commit();
  }

  if constexpr (C::kWide) {
    const int ky = threadIdx.x >> 7;
    float acc[3][N / 2];
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int k = 0; k < N / 2; ++k) acc[t][k] = 0.f;
    for (int q = 0; q < mine; ++q) {
      landed(q);  // and slot q - 1's readers are done
      const uint32_t sa = sbase + q % C::kStages * C::kStageBytes;
      const uint32_t sb = sa + 16 * C::kXUnits;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::kSteps; ++ks) {
        const int rr = ks / (C::kCols / 16), px = ks % (C::kCols / 16) * 16;
        const uint64_t db =
            gmma_desc(sb + 16 * (rr * C::kCols + px), 128, 16 * C::kPix);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int ua = (rr + ky) * (C::kCols + 2) + px + kx;
          Wgmma<N>::template mma<1, 1>(
              acc[kx], gmma_desc(sa + 16 * ua, 128, 16 * C::kGS), db);
        }
      }
      wgmma_commit();
      // the next stage's copies while the products run (slot q - 1)
      if (q + C::kStages - 1 < mine) stage(q + C::kStages - 1);
      cp_async_commit();
      wgmma_wait_all();
#pragma unroll
      for (int t = 0; t < 3; ++t) fence_regs<N / 2>(acc[t]);
    }
    cp_async_wait_all();
    // accumulators k, k + 1 of tap (ky, kx): channel 16 w + l / 4 + 8 *
    // ((k / 2) % 2) of the chunk, output channels 8 (k / 4) + 2 (l % 4) + 0, 1
    const int w = (threadIdx.x >> 5) & 3, l = threadIdx.x & 31;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int k = 0; k < N / 2; k += 2) {
        const int ci = 16 * w + (l >> 2) + 8 * ((k >> 1) & 1);
        const int co = 8 * (k >> 2) + 2 * (l & 3);
        *reinterpret_cast<float2*>(
            out + ((size_t)(ky * 3 + kx) * p.cpad + c0 + ci) * p.np + n0 +
            co) = make_float2(acc[kx][k], acc[kx][k + 1]);
      }
  } else {
    using W = DwWarps<kMode, N>;
    float acc[9][W::kMF][W::kNF][4];
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int m = 0; m < W::kMF; ++m)
#pragma unroll
        for (int n = 0; n < W::kNF; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[t][m][n][k] = 0.f;
    for (int q = 0; q < mine; ++q) {
      landed(q);
      if (q + C::kStages - 1 < mine) stage(q + C::kStages - 1);
      cp_async_commit();
      dw_mma_tile<kMode, N>(sbase + q % C::kStages * C::kStageBytes, acc);
    }
    cp_async_wait_all();
    __syncthreads();  // the ring is free: the warps' sums meet there
    // per tap: warp w's 8 sums a lane at red[(w * 8 + v) * 32 + lane]; the
    // block's sum of (ci, n) adds the kKG pixel-split warps in order
    float* red = reinterpret_cast<float*>(smem);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
      for (int m = 0; m < W::kMF; ++m)
#pragma unroll
        for (int n = 0; n < W::kNF; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            red[(warp * 8 + (m * W::kNF + n) * 4 + k) * 32 + lane] =
                acc[tap][m][n][k];
      __syncthreads();
      for (int e = threadIdx.x; e < C::kM * N; e += C::kThreads) {
        const int ci = e / N, co = e % N;
        const int nfrag = co >> 3;
        const int v = ((ci >> 4) * W::kNF + nfrag % W::kNF) * 4 +
                      2 * ((ci >> 3) & 1) + (co & 1);
        const int ln = 4 * (ci & 7) + ((co & 7) >> 1);
        const int ng = nfrag / W::kNF;
        float s = 0.f;
        for (int kg = 0; kg < W::kKG; ++kg)
          s += red[((kg * W::kNG + ng) * 8 + v) * 32 + ln];
        out[((size_t)tap * p.cpad + c0 + ci) * p.np + n0 + co] = s;
      }
      __syncthreads();
    }
  }
}

// dw[j] (HWIO (3, 3, cin, cout) f32, j < 9 * cin * cout) = the sum over the
// grid rows i of part[i][col(j)] in a fixed order: P = blockDim.x / 32 row
// phases (i mod P, P a power of two chosen from the rows, so that a thread
// adds about 16 of them), each summed in row order by four running sums over
// i, i + P, i + 2P, i + 3P, ... added last to first, then the phases in
// order. One block per 32 outputs; a warp reads 32 consecutive columns.
__global__ void __launch_bounds__(1024) dw_rows_reduce_kernel(
    const float* __restrict__ part, int rows, int len, int cin, int cout,
    int cpad, int np, float* __restrict__ dw) {
  __shared__ float red[32][33];
  const int lane = threadIdx.x & 31, ph = threadIdx.x >> 5;
  const int phases = blockDim.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const int total = 9 * cin * cout;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (j < total) {
    const int co = j % cout, ci = j / cout % cin, tap = j / (cout * cin);
    const float* col = part + (size_t)(tap * cpad + ci) * np + co;
    int i = ph;
    for (; i + 3 * phases < rows; i += 4 * phases) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s[k] += col[(size_t)(i + phases * k) * len];
    }
    for (int k = 0; i < rows; i += phases, ++k) s[k] += col[(size_t)i * len];
  }
  red[ph][lane] = (s[3] + s[2]) + (s[1] + s[0]);
  __syncthreads();
  if (ph == 0 && j < total) {
    float t = 0.f;
    for (int k = 0; k < phases; ++k) t += red[k][lane];
    dw[j] = t;
  }
}

// the reduction's row phases: about 16 rows a thread, 1 to 32
inline int dw_reduce_phases(int rows) {
  int p = 1;
  while (p < 32 && rows > 16 * p) p *= 2;
  return p;
}

template <class T>
using DwKernel = void (*)(DwParams<T>, CUtensorMap, CUtensorMap);

struct DwLaunch {
  int mode, ntile, threads, smem, rows;   // rows: of a pixel tile
};

template <int kMode, int N, class T>
DwKernel<T> dw_pick(DwLaunch* l) {
  l->threads = DwCfg<kMode, N>::kThreads;
  l->smem = DwCfg<kMode, N>::kSmem;
  l->rows = DwCfg<kMode, N>::kRows;
  return conv3x3_dw_kernel<kMode, N, T>;
}

template <int kMode, class T>
DwKernel<T> dw_pick_n(DwLaunch* l) {
  switch (l->ntile) {
    case 16: return dw_pick<kMode, 16, T>(l);
    case 32: return dw_pick<kMode, 32, T>(l);
    default: return dw_pick<kMode, 64, T>(l);
  }
}

// the kernel at mode l->mode and output-channel tile l->ntile (16, 32, 64)
template <class T>
DwKernel<T> dw_kernel(DwLaunch* l) {
  switch (l->mode) {
    case 0: return dw_pick_n<0, T>(l);
    case 1: return dw_pick_n<1, T>(l);
    default: return dw_pick_n<2, T>(l);
  }
}

inline int dw_mode(int cin) { return cin <= 16 ? 0 : cin <= 32 ? 1 : 2; }
inline int dw_ntile(int cout) { return cout <= 16 ? 16 : cout <= 32 ? 32 : 64; }

// out[0..6) = {blocks, blocks a SM, SMs, dynamic shared memory, grid rows,
// row length}
struct DwGrid {
  int blocks, per_sm, sms, smem, rows, len;
  int tile_rows;   // output rows of a pixel tile
};

// Fill p's geometry, set the kernel's launch attributes (on every launch)
// and size its grid on the current card; *k: the kernel, *threads its block.
template <class T>
cudaError_t dw_grid(DwParams<T>* p, DwKernel<T>* k, int* threads,
                    DwGrid* g) {
  if (p->cin < 1 || p->cout < 1 || p->n < 1 || p->height < 1 ||
      p->width < 1)
    return cudaErrorInvalidValue;
  DwLaunch l{dw_mode(p->cin), dw_ntile(p->cout), 0, 0, 0};
  *k = dw_kernel<T>(&l);
  *threads = l.threads;
  const int m = l.mode == 0 ? 16 : l.mode == 1 ? 32 : 64;
  const int ntiles = (p->cout + l.ntile - 1) / l.ntile;
  p->chunks = (p->cin + m - 1) / m;
  p->cols = p->chunks * ntiles;
  p->cpad = m * p->chunks;
  p->np = l.ntile * ntiles;
  p->len = 9 * p->cpad * p->np;
  p->tiles_y = (p->height + l.rows - 1) / l.rows;
  p->tiles_x = (p->width + kDwCols - 1) / kDwCols;
  p->tiles = p->n * p->tiles_y * p->tiles_x;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&g->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = hopper_attrs(*k, l.smem);
  if (e == cudaSuccess)
    e = resident_per_sm(*k, l.threads, l.smem, dev, &g->per_sm);
  if (e == cudaSuccess && g->per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  int rows = g->per_sm * g->sms / p->cols;
  if (rows > p->tiles) rows = p->tiles;
  if (rows < 1) rows = 1;
  p->rows = g->rows = rows;
  g->blocks = rows * p->cols;
  g->smem = l.smem;
  g->len = p->len;
  g->tile_rows = l.rows;
  return cudaSuccess;
}

template <class T>
cudaError_t conv_dw(const void* x, int cin, const void* g, int cout,
                    void* part, int part_rows, void* dw, int n, int height,
                    int width, cudaStream_t s) {
  DwParams<T> p{};
  p.x = static_cast<const T*>(x);
  p.g = static_cast<const T*>(g);
  p.part = static_cast<float*>(part);
  p.cin = cin;
  p.cout = cout;
  p.n = n;
  p.height = height;
  p.width = width;
  p.xmode = dw_stage_mode<T>(x, cin);
  p.gmode = dw_stage_mode<T>(g, cout);
  DwKernel<T> k;
  int threads = 0;
  DwGrid grid{};
  cudaError_t e = dw_grid(&p, &k, &threads, &grid);
  if (e != cudaSuccess) return e;
  if (part_rows < grid.rows) return cudaErrorInvalidValue;
  CUtensorMap tx{}, tg{};
  if (sizeof(T) == 2) {
    const int r = grid.tile_rows;
    p.xtma = nhwc_map(&tx, x, n, height, width, cin, kDwCols + 2, r + 2);
    p.gtma = nhwc_map(&tg, g, n, height, width, cout, kDwCols, r);
  }
  k<<<grid.blocks, threads, grid.smem, s>>>(p, tx, tg);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dw_rows_reduce_kernel<<<(9 * cin * cout + 31) / 32,
                          32 * dw_reduce_phases(p.rows), 0, s>>>(
      p.part, p.rows, p.len, cin, cout, p.cpad, p.np,
      static_cast<float*>(dw));
  return cudaGetLastError();
}

// ------------------------------------------------------------ K8a narrow
// K8a at cin <= 32 and cout <= 32 (its main shape, 16 -> 16, and its dx)
// on narrow_tile.cuh's tile: y = conv(x, W) + bias (+ ReLU) from the
// accumulator fragments, stored in x's type through the warp's slice of
// shared memory by coalesced 16-byte stores. Its own C entry: K6a and the
// wider K8a keep conv_wg_kernel. Bound on an H100: at 16 -> 16 on (32, 512,
// 512) bf16 a pass reads and writes 268 MB each for 38.7 GFLOP, 36 op/byte,
// far under the 295 op/byte ridge: bytes, 0.160 ms; the tile stages 1.20x
// the input (its halo), reading each value once from device memory.

template <class T>
struct NarrowConvParams {
  const T* x;                  // (n, height, width, cin)
  const __nv_bfloat16* taps;   // (k16, 9, 32 lanes, NF, 4) B fragments
  const float* bias;           // (cout,) or null
  T* y;                        // (n, height, width, cout)
  int cin, cout, n, height, width, relu;
  int chunks, tiles_x, tiles_y, tiles;   // one chunk
  int tma, mode;               // x by TMA, else its DwStage
};

// the kernel's shared memory: the ring, the taps (bytes), the bias and
// each warp's run of outputs
template <int G8, int NF, class T>
struct NarrowConv {
  using C = NarrowCfg<G8, NF>;
  static constexpr int kTaps = 9 * 32 * NF * 8 * C::kK16;
  static constexpr int kSmem =
      C::kRing + kTaps + 8 * NF * 4 + 8 * 16 * 8 * NF * (int)sizeof(T);
};

template <int G8, int NF, class T>
struct NarrowConvEpi {
  static constexpr bool kPrologue = false;
  const NarrowConvParams<T>& p;
  unsigned char* taps;   // (k16, 9, 32, NF, 4) B fragments
  float* bias;           // (8 NF,), zero beyond cout
  T* run;                // this warp's 16 x cout outputs

  __device__ __forceinline__ void setup() {
    for (int i = threadIdx.x; i < NarrowConv<G8, NF, T>::kTaps / 16;
         i += kNarrowThreads)
      reinterpret_cast<uint4*>(taps)[i] =
          reinterpret_cast<const uint4*>(p.taps)[i];
    for (int i = threadIdx.x; i < 8 * NF; i += kNarrowThreads)
      bias[i] = p.bias != nullptr && i < p.cout ? p.bias[i] : 0.f;
  }
  __device__ void prologue(unsigned char*, int, int, int) {}
  __device__ void fetch(int, int, int) {}

  template <int MT>
  __device__ __forceinline__ void tile(float (&acc)[MT][NF][4], int b,
                                       int ty0, int tx0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int px0 = tx0 + 16 * (warp & 3);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int oy = ty0 + (warp >> 2) * MT + i;
      int npix = p.width - px0 < 16 ? p.width - px0 : 16;
      if (oy >= p.height) npix = 0;
      if (npix <= 0) continue;   // the warp's run lies outside the image
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int k = 0; k < 4; k += 2) {   // channels co, co + 1 of a pixel
          const int co = 8 * f + 2 * q, pix = g + 4 * k;
          if (co >= p.cout) continue;
          float v0 = acc[i][f][k] + bias[co];
          float v1 = acc[i][f][k + 1] + bias[co + 1];
          if (p.relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          store2(run + pix * p.cout + co, v0, v1, co + 1 < p.cout,
                 p.cout % 2 == 0);
        }
      __syncwarp();
      warp_store_run(p.y + ((size_t)(b * p.height + oy) * p.width + px0) *
                               p.cout,
                     run, npix * p.cout, lane);
      __syncwarp();
    }
  }
};

template <int G8, int NF, class T>
__global__ void __launch_bounds__(kNarrowThreads, 2)
    narrow_conv_kernel(const __grid_constant__ NarrowConvParams<T> p,
                       const __grid_constant__ CUtensorMap tx) {
  using K = NarrowConv<G8, NF, T>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* taps = smem + K::C::kRing;
  float* bias = reinterpret_cast<float*>(taps + K::kTaps);
  T* run = reinterpret_cast<T*>(bias + 8 * NF) +
           (threadIdx.x >> 5) * 16 * 8 * NF;
  NarrowConvEpi<G8, NF, T> e{p, taps, bias, run};
  narrow_walk<G8, NF, T>(p, tx, smem, taps, e);
}

template <class T>
using NarrowConvKernel = void (*)(NarrowConvParams<T>, CUtensorMap);

template <int G8, int NF, class T>
NarrowConvKernel<T> narrow_pick(int* smem, int* rows) {
  *smem = NarrowConv<G8, NF, T>::kSmem;
  *rows = NarrowCfg<G8, NF>::kRows;
  return narrow_conv_kernel<G8, NF, T>;
}

// the tile at cin <= 16 (2 channel groups) or <= 32 (4), cout <= 16 (NF 2)
// or <= 32 (4)
template <class T>
NarrowConvKernel<T> narrow_kernel_for(int cin, int cout, int* smem,
                                      int* rows) {
  if (cin <= 16)
    return cout <= 16 ? narrow_pick<2, 2, T>(smem, rows)
                      : narrow_pick<2, 4, T>(smem, rows);
  return cout <= 16 ? narrow_pick<4, 2, T>(smem, rows)
                    : narrow_pick<4, 4, T>(smem, rows);
}

// Fill p's tiles, set the kernel's launch attributes and size its grid on
// the current card; *k: the kernel.
template <class T>
cudaError_t narrow_conv_grid(NarrowConvParams<T>* p, NarrowConvKernel<T>* k,
                             NarrowGrid* g) {
  if (p->cin < 1 || p->cin > 32 || p->cout < 1 || p->cout > 32 || p->n < 1 ||
      p->height < 1 || p->width < 1)
    return cudaErrorInvalidValue;
  int smem = 0, rows = 0;
  *k = narrow_kernel_for<T>(p->cin, p->cout, &smem, &rows);
  p->chunks = 1;
  p->tiles_y = (p->height + rows - 1) / rows;
  p->tiles_x = (p->width + kNarrowCols - 1) / kNarrowCols;
  p->tiles = p->n * p->tiles_y * p->tiles_x;
  return narrow_grid(*k, smem, p->tiles, rows, g);
}

template <class T>
cudaError_t conv_narrow(const void* x, int cin, const void* taps,
                        const void* bias, void* y, int n, int height,
                        int width, int cout, int relu, cudaStream_t s) {
  NarrowConvParams<T> p{};
  p.x = static_cast<const T*>(x);
  p.taps = static_cast<const __nv_bfloat16*>(taps);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<T*>(y);
  p.cin = cin;
  p.cout = cout;
  p.n = n;
  p.height = height;
  p.width = width;
  p.relu = relu;
  p.mode = dw_stage_mode<T>(x, cin);
  NarrowConvKernel<T> k;
  NarrowGrid g{};
  cudaError_t e = narrow_conv_grid(&p, &k, &g);
  if (e != cudaSuccess) return e;
  CUtensorMap tx{};
  if (sizeof(T) == 2)
    p.tma = nhwc_map(&tx, x, n, height, width, cin, kNarrowCols + 2,
                     g.rows + 2);
  k<<<g.blocks, kNarrowThreads, g.smem, s>>>(p, tx);
  return cudaGetLastError();
}

}  // namespace

// K8a host entry on the narrow tile (cin <= 32, cout <= 32). x: (n, height,
// width, cin), f32 when x_f32 else bf16; taps: (k16, 9, 32, NF, 4) bf16,
// the mma.sync B fragments (ops/fused_conv.py::_narrow_frags) with k16 = 1
// at cin <= 16 else 2 and NF = 2 at cout <= 16 else 4; bias: (cout,) f32
// or null; y: (n, height, width, cout) in x's type. One launch of a
// persistent grid. Returns a cudaError_t.
extern "C" int mmr_conv3x3_narrow(const void* x, int x_f32, int cin,
                                  const void* taps, const void* bias, void* y,
                                  int n, int height, int width, int cout,
                                  int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_f32 ? conv_narrow<float>(x, cin, taps, bias, y, n, height,
                                          width, cout, relu, s)
                     : conv_narrow<__nv_bfloat16>(x, cin, taps, bias, y, n,
                                                  height, width, cout, relu,
                                                  s));
}

// The grid mmr_conv3x3_narrow launches at these arguments: out[0..6) =
// {blocks, blocks a SM, SMs, dynamic shared memory, pixel tiles, tile
// rows}; it sets the kernel's launch attributes as the launch does.
// Returns a cudaError_t.
extern "C" int mmr_conv3x3_narrow_grid(int n, int height, int width, int cin,
                                       int cout, int x_f32, void* out) {
  NarrowGrid g{};
  cudaError_t e;
  if (x_f32) {
    NarrowConvParams<float> p{};
    p.cin = cin, p.cout = cout, p.n = n, p.height = height, p.width = width;
    NarrowConvKernel<float> k;
    e = narrow_conv_grid(&p, &k, &g);
  } else {
    NarrowConvParams<__nv_bfloat16> p{};
    p.cin = cin, p.cout = cout, p.n = n, p.height = height, p.width = width;
    NarrowConvKernel<__nv_bfloat16> k;
    e = narrow_conv_grid(&p, &k, &g);
  }
  if (e != cudaSuccess) return (int)e;
  put_grid(g, out);
  return 0;
}

// Dynamic shared memory in bytes (what = 0) or resident blocks per SM at
// the launch's attributes (what = 1) of narrow_conv_kernel at bf16
// storage: kind 0 (cin <= 16) or 1 (cin <= 32), ntile 16 or 32 (cout).
// Returns -1 otherwise.
extern "C" int mmr_conv3x3_narrow_info(int what, int kind, int ntile) {
  if (kind < 0 || kind > 1 || (ntile != 16 && ntile != 32)) return -1;
  int smem = 0, rows = 0, dev = 0, per_sm = -1;
  const NarrowConvKernel<__nv_bfloat16> k =
      narrow_kernel_for<__nv_bfloat16>(kind ? 32 : 16, ntile, &smem, &rows);
  if (!what) return smem;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      hopper_attrs(k, smem) != cudaSuccess ||
      resident_per_sm(k, kNarrowThreads, smem, dev, &per_sm) != cudaSuccess)
    return -1;
  return per_sm;
}

// K6a / K8a host entry (plain C interface, bound with ctypes). x: (n,
// height, width, cin), f32 when x_f32 else bf16; wt: (cin chunks of 16, 9,
// 2, np, 8) bf16 (common.cuh's tap pack) with np = cout padded to a
// multiple of ntile in {16, 32, 64}; bias: (cout,) f32 or null; y: (n,
// height, width, cout) in x's type. Returns a cudaError_t.
extern "C" int mmr_conv3x3(const void* x, int x_f32, int cin, const void* wt,
                           const void* bias, void* y, int n, int height,
                           int width, int cout, int np, int ntile, int relu,
                           void* stream) {
  if (bad_shape(cin, cout, np, ntile)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_f32 ? conv_fwd<float>(x, cin, wt, bias, y, n, height, width,
                                       cout, np, ntile, relu, s)
                     : conv_fwd<__nv_bfloat16>(x, cin, wt, bias, y, n, height,
                                               width, cout, np, ntile, relu,
                                               s));
}

// K6b / K8b host entry. x: (n, height, width, cin) and g: (n, height,
// width, cout), both f32 when x_f32 else bf16; part: f32 scratch of
// part_rows rows of the length mmr_conv3x3_dw_grid reports (at least its
// grid rows); dw: (3, 3, cin, cout) f32, written whole. One launch of a
// persistent grid, then the reduction of its rows. Returns a cudaError_t.
extern "C" int mmr_conv3x3_dw(const void* x, int x_f32, int cin,
                              const void* g, int cout, void* part,
                              int part_rows, void* dw, int n, int height,
                              int width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_f32 ? conv_dw<float>(x, cin, g, cout, part, part_rows, dw,
                                      n, height, width, s)
                     : conv_dw<__nv_bfloat16>(x, cin, g, cout, part,
                                              part_rows, dw, n, height, width,
                                              s));
}

// The grid mmr_conv3x3_dw launches at these arguments: out[0..6) = {blocks,
// blocks a SM, SMs, dynamic shared memory, grid rows (the scratch rows it
// needs), row length}; it sets the kernel's launch attributes as the launch
// does. Returns a cudaError_t.
extern "C" int mmr_conv3x3_dw_grid(int n, int height, int width, int cin,
                                   int cout, int x_f32, void* out) {
  DwGrid grid{};
  int threads = 0;
  cudaError_t e;
  if (x_f32) {
    DwParams<float> p{};
    p.cin = cin, p.cout = cout, p.n = n, p.height = height, p.width = width;
    DwKernel<float> k;
    e = dw_grid(&p, &k, &threads, &grid);
  } else {
    DwParams<__nv_bfloat16> p{};
    p.cin = cin, p.cout = cout, p.n = n, p.height = height, p.width = width;
    DwKernel<__nv_bfloat16> k;
    e = dw_grid(&p, &k, &threads, &grid);
  }
  if (e != cudaSuccess) return (int)e;
  int* o = static_cast<int*>(out);
  o[0] = grid.blocks;
  o[1] = grid.per_sm;
  o[2] = grid.sms;
  o[3] = grid.smem;
  o[4] = grid.rows;
  o[5] = grid.len;
  return 0;
}

// Dynamic shared memory in bytes (what = 0) or resident blocks per SM at
// the launch's attributes (what = 1) of conv3x3_dw_kernel at bf16 storage:
// mode 0 (cin <= 16), 1 (cin <= 32) or 2 (64-channel chunks), ntile 16, 32
// or 64. Returns -1 otherwise.
extern "C" int mmr_conv3x3_dw_info(int what, int mode, int ntile) {
  if (mode < 0 || mode > 2 || (ntile != 16 && ntile != 32 && ntile != 64))
    return -1;
  DwLaunch l{mode, ntile, 0, 0, 0};
  const DwKernel<__nv_bfloat16> k = dw_kernel<__nv_bfloat16>(&l);
  if (!what) return l.smem;
  int dev = 0, per_sm = -1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      hopper_attrs(k, l.smem) != cudaSuccess ||
      resident_per_sm(k, l.threads, l.smem, dev, &per_sm) != cudaSuccess)
    return -1;
  return per_sm;
}
