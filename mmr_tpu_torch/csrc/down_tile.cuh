// Device code shared by the stride-2 pair K2 (fused_conv_down.cu) and K4
// (fused_conv_down_bwd.cu), whose depthwise tiles also run at stride 1 (the
// depthwise mode of K1 and K3): the output tiles, the source tile staged
// into shared memory by cp.async with the prologue applied once per staged
// value, the mma.sync m16n8k16 product, and the blocks' rows of sums added
// in a fixed order (no atomics: every result is the same from run to run).
//
// A tile is kDownTH output rows x TW output columns of one image. At stride
// S its source tile is rows S*r0 - 1 .. S*r0 + S*(kDownTH - 1) + 1 and
// columns S*c0 - 1 .. S*c0 + S*(TW - 1) + 1 (the windows with their
// one-pixel halo: at stride 1 each output row reads one new source row, at
// stride 2 two). In NHWC each source row of the tile is one contiguous run
// of bytes: it is copied as the 16-byte chunks that hold it ("raw", at the
// row's `lead`, the first column's address mod 16), then the prologue pass
// writes the bf16 prologue'd values compactly ("act", zero outside the
// image: the padding comes after the prologue).

#pragma once

#include "common.cuh"

namespace {

constexpr int kDownTH = 4;          // output rows of a tile
constexpr int kDownThreads = 256;
constexpr int kDenseTW = 64;        // output columns of a dense tile
constexpr int kDwTW = 32;           // of a depthwise tile
constexpr int kDwWideTW = 16;       // of a stride-2 one above 64 channels
constexpr int kDenseMaxCin = 16;    // the dense kernels' channel limits
constexpr int kDenseMaxCout = 32;
constexpr int kDwMaxC = 96;         // the depthwise kernels' widest C
constexpr int kDownMaxSmem = 227 * 1024;   // an H100 block's shared memory

struct DownTile {
  int b, r0, c0;   // image, first output row, first output column
};

// the channels the kernels take: dense cin <= 16 and cout <= 32, depthwise
// cin == cout a multiple of 8 up to kDwMaxC
inline bool down_channels_ok(int cin, int cout, int depthwise) {
  if (depthwise)
    return cout == cin && cin % 8 == 0 && cin >= 8 && cin <= kDwMaxC;
  return cin >= 1 && cin <= kDenseMaxCin && cout >= 1 && cout <= kDenseMaxCout;
}

// the depthwise widths whose block sums reduce by warp shuffles over the
// lanes of a channel group (the warps' partial rows at a stride of 64
// channels); the other widths reduce through ordered_unit_sums
__host__ __device__ inline bool dw_warp_sums(int c) {
  return c == 8 || c == 16 || c == 32 || c == 64;
}

// output columns of a tile: dense 64; depthwise 32, or 16 at stride 2 above
// 64 channels (two raw tiles of 9 x 33 source pixels then fit a block)
inline int down_tile_cols(int depthwise, int c, int stride) {
  if (!depthwise) return kDenseTW;
  return stride == 2 && c > 64 ? kDwWideTW : kDwTW;
}

// the tile grid of an (n, h, w) input at `stride`, tiles of tw output
// columns: tiles_y x tiles_x tiles an image
struct DownTiles {
  int y, x, all;
};

inline DownTiles down_tiles(int n, int h, int w, int tw, int stride) {
  DownTiles t;
  t.y = ((h + stride - 1) / stride + kDownTH - 1) / kDownTH;
  t.x = ((w + stride - 1) / stride + tw - 1) / tw;
  t.all = n * t.y * t.x;
  return t;
}

// tile t of an image grid of tiles_y x tiles_x tiles, in (image, row,
// column) order
__device__ __forceinline__ DownTile down_tile(int t, int tiles_y, int tiles_x,
                                              int tw) {
  DownTile d;
  d.c0 = (t % tiles_x) * tw;
  t /= tiles_x;
  d.r0 = (t % tiles_y) * kDownTH;
  d.b = t / tiles_y;
  return d;
}

template <int TW, int kStride = 2>
struct SrcTile {
  static constexpr int kRows = kStride * (kDownTH - 1) + 3;
  static constexpr int kCols = kStride * (TW - 1) + 3;
  // bytes of a raw row: the values, up to 15 bytes of lead and a chunk's tail
  __host__ __device__ static int raw_stride(int cin) {
    return (kCols * cin * 2 + 47) & ~15;
  }
  __host__ __device__ static int raw_bytes(int cin) {
    return kRows * raw_stride(cin);
  }
  __host__ __device__ static int act_stride(int cin) { return kCols * cin; }
  __host__ __device__ static int act_bytes(int cin) {
    return (kRows * act_stride(cin) * 2 + 15) & ~15;
  }
};

// byte address of (image b, row iy, column col) of x; col may be -1
__device__ __forceinline__ long long src_addr(const __nv_bfloat16* x, int b,
                                              int iy, int col, int h, int w,
                                              int cin) {
  return (long long)reinterpret_cast<uintptr_t>(x) +
         (((long long)(b * h + iy) * w + col) * cin) * 2;
}

// a 16-byte cp.async that reads `bytes` (1..16) and zero-fills the rest
__device__ __forceinline__ void cp_async_n(uint32_t dst, long long src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Issue the cp.async copies of tile t's source rows into `raw` (x 16-byte
// aligned; x_end: the byte address one past x). The caller commits, waits
// and synchronizes.
template <int TW, int kStride = 2>
__device__ void stage_src(const __nv_bfloat16* x, long long x_end,
                          const DownTile& t, int h, int w, int cin,
                          char* raw) {
  using S = SrcTile<TW, kStride>;
  const int rs = S::raw_stride(cin), cpr = rs / 16;
  const int col0 = kStride * t.c0 - 1;
  const int cs = max(0, col0), ce = min(w, col0 + S::kCols);
  if (cs >= ce) return;
  const uint32_t base = smem_addr(raw);
  for (int i = threadIdx.x; i < S::kRows * cpr; i += kDownThreads) {
    const int r = i / cpr, k = i - r * cpr;
    const int iy = kStride * t.r0 - 1 + r;
    if (iy < 0 || iy >= h) continue;
    const long long tile0 = src_addr(x, t.b, iy, col0, h, w, cin);
    const long long a =
        (src_addr(x, t.b, iy, cs, h, w, cin) & ~15LL) + 16LL * k;
    if (a >= src_addr(x, t.b, iy, ce, h, w, cin)) continue;
    const long long left = x_end - a;
    cp_async_n(base + r * rs + (uint32_t)(a - (tile0 & ~15LL)), a,
               left < 16 ? (int)left : 16);
  }
}

// act = the prologue of every in-image value of the raw tile, rounded to
// bf16; 0 outside the image. s, t: the prologue vectors (read only when
// act_k != kNone).
template <int TW, int kStride = 2>
__device__ void activate_src(const __nv_bfloat16* x, const DownTile& t,
                             int h, int w, int cin, const char* raw,
                             __nv_bfloat16* act, const float* s,
                             const float* tv, int act_k) {
  using S = SrcTile<TW, kStride>;
  const int rs = S::raw_stride(cin), as = S::act_stride(cin);
  if (cin % 8 == 0) {   // 8-channel vectors; every row's lead is 0
    const int g = cin / 8, units = S::kCols * g;
    for (int i = threadIdx.x; i < S::kRows * units; i += kDownThreads) {
      const int r = i / units, u = i - r * units, j = u / g;
      const int c = (u - j * g) * 8;
      const int iy = kStride * t.r0 - 1 + r, ix = kStride * t.c0 - 1 + j;
      uint4 o = make_uint4(0, 0, 0, 0);
      if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
        o = *reinterpret_cast<const uint4*>(raw + r * rs + (j * cin + c) * 2);
        prologue8(reinterpret_cast<__nv_bfloat16*>(&o), s + c, tv + c, act_k);
      }
      *reinterpret_cast<uint4*>(act + r * as + j * cin + c) = o;
    }
    return;
  }
  for (int i = threadIdx.x; i < S::kRows * S::kCols; i += kDownThreads) {
    const int r = i / S::kCols, j = i - r * S::kCols;
    const int iy = kStride * t.r0 - 1 + r, ix = kStride * t.c0 - 1 + j;
    __nv_bfloat16* dst = act + r * as + j * cin;
    if (iy < 0 || iy >= h || ix < 0 || ix >= w) {
      for (int ci = 0; ci < cin; ++ci) dst[ci] = __float2bfloat16_rn(0.f);
      continue;
    }
    const int lead =
        (int)(src_addr(x, t.b, iy, kStride * t.c0 - 1, h, w, cin) & 15);
    const __nv_bfloat16* src =
        reinterpret_cast<const __nv_bfloat16*>(raw + r * rs + lead) + j * cin;
    for (int ci = 0; ci < cin; ++ci) {
      float v = __bfloat162float(src[ci]);
      if (act_k != kNone)
        v = __bfloat162float(
            __float2bfloat16_rn(prologue(v, s[ci], tv[ci], act_k)));
      dst[ci] = __float2bfloat16_rn(v);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// act[base + off], 0 for off < 0 (a padded row of the patch matrix)
__device__ __forceinline__ __nv_bfloat16 tap_at(const __nv_bfloat16* act,
                                                int base, int off) {
  return off < 0 ? __float2bfloat16_rn(0.f) : act[base + off];
}

// out[j], j < units * nv: the sum, over ph = 0 .. kDownThreads / units - 1
// in that order, of v[j % nv] of thread ph * units + j / nv (each thread
// holds the sums of one unit of nv <= 8 columns). red: 8 * kDownThreads
// floats of shared memory. Every thread of the block calls it.
__device__ __forceinline__ void ordered_unit_sums(const float (&v)[8],
                                                  int nv, int units,
                                                  float* red, float* out) {
#pragma unroll
  for (int k = 0; k < 8; ++k) red[threadIdx.x * 8 + k] = v[k];
  __syncthreads();
  const int phases = kDownThreads / units;
  for (int j = threadIdx.x; j < units * nv; j += kDownThreads) {
    float s = 0.f;
    for (int ph = 0; ph < phases; ++ph)
      s += red[(ph * units + j / nv) * 8 + j % nv];
    out[j] = s;
  }
  __syncthreads();
}

// out[j] = the sum over rows i of part[i * len + j] in a fixed order: 32
// row phases (i mod 32) of a 1024-thread block, each summed in row order
// by four running sums over i, i + 32, i + 64, i + 96, ... added last to
// first, then the phases in order. One block per 32 columns.
__global__ void __launch_bounds__(1024) down_rows_reduce_kernel(
    const float* __restrict__ part, int rows, int len,
    float* __restrict__ out) {
  __shared__ float red[32][33];
  const int col = threadIdx.x & 31, ph = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + col;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (j < len) {
    int i = ph;
    for (; i + 96 < rows; i += 128) {
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] += part[(size_t)(i + 32 * k) * len + j];
    }
    for (int k = 0; i < rows; i += 32, ++k) s[k] += part[(size_t)i * len + j];
  }
  red[ph][col] = (s[3] + s[2]) + (s[1] + s[0]);
  __syncthreads();
  if (ph == 0 && j < len) {
    float t = 0.f;
    for (int k = 0; k < 32; ++k) t += red[k][col];
    out[j] = t;
  }
}

cudaError_t launch_rows_reduce(const float* part, int rows, int len,
                               float* out, cudaStream_t s) {
  down_rows_reduce_kernel<<<(len + 31) / 32, 1024, 0, s>>>(part, rows, len,
                                                          out);
  return cudaGetLastError();
}

// the persistent grid of one launch: blocks = min(per_sm * sms, tiles),
// block i takes tiles i, i + blocks, ... and writes row i of the block sums
struct DownGrid {
  int blocks;
  int per_sm;   // resident blocks a SM at the kernel's launch attributes
  int sms;      // the card's SMs
};

// Set the kernel's launch attributes (hopper_attrs, on every launch as for
// the other Hopper kernels) and size its persistent grid over `tiles` tiles.
// On an error the runtime's last error is cleared and returned.
template <class K>
cudaError_t down_grid(K kernel, int smem, int tiles, DownGrid* g) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&g->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = hopper_attrs(kernel, smem);
  if (e == cudaSuccess) e = resident_per_sm(kernel, kDownThreads, smem, dev,
                                         &g->per_sm);
  if (e == cudaSuccess && g->per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  const int fit = g->per_sm * g->sms;
  g->blocks = fit < tiles ? fit : tiles;
  return cudaSuccess;
}

// out[0..4) = {blocks, blocks a SM, SMs, dynamic shared memory} of a launch
// (the *_grid entries)
template <class K>
int report_grid(K kernel, int smem, int tiles, int* out) {
  DownGrid g{};
  const cudaError_t e = down_grid(kernel, smem, tiles, &g);
  if (e != cudaSuccess) return (int)e;
  out[0] = g.blocks;
  out[1] = g.per_sm;
  out[2] = g.sms;
  out[3] = smem;
  return 0;
}

}  // namespace
