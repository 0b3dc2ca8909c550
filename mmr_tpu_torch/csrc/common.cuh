// Device code shared by the fused 3x3 conv kernels: K1 (fused_conv.cu), its
// backward K3 (fused_conv_bwd.cu), the head+loss pair K5a/K5b
// (head_loss.cu) and the stride-2 pair K2/K4 (prologue, moments, dy prep).
//
// Tile geometry of the stride-1 kernels: one block = kTH output rows x kTW
// pixels; an input is staged 16 channels at a time as a (kTH+2) x (kTW+2)
// halo tile in shared memory; products run on the tensor cores as WMMA
// bf16 m16n16k16 with f32 accumulators (one warp per output row).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTW = 16;                      // output pixels per warp (WMMA M)
constexpr int kTH = 8;                       // output rows per block (= warps)
constexpr int kKC = 16;                      // input channels per chunk (WMMA K)
constexpr int kMaxIn = 8;
constexpr int kThreads = kTH * 32;
constexpr int kTilePix = (kTH + 2) * (kTW + 2);
constexpr unsigned kFull = 0xffffffffu;

enum Act { kNone = 0, kRelu = 1, kHswish = 2, kLinear = 3 };

struct Input {
  const __nv_bfloat16* x;  // NHWC; at (height/2, width/2) when up2x
  const float* scale;      // (c,) or null when act == kNone
  const float* shift;
  int c;
  int act;
  int up2x;
  int chunk0;              // first 16-channel chunk of this input in wt
};

__device__ __forceinline__ float prologue(float v, float s, float t, int act) {
  // no FMA contraction: the plain version multiplies and adds separately
  v = __fadd_rn(__fmul_rn(v, s), t);
  if (act == kRelu) return fmaxf(v, 0.f);
  if (act == kHswish) {
    const float g = fminf(fmaxf(__fadd_rn(v, 3.f), 0.f), 6.f);
    return __fmul_rn(__fmul_rn(v, g), 1.f / 6.f);
  }
  return v;
}

// d act(v) / dv, hswish taking 0 at v <= -3 and 1 at v >= 3
// (packed_chain.py::_act_grad)
__device__ __forceinline__ float act_grad(float v, int act) {
  if (act == kRelu) return v > 0.f ? 1.f : 0.f;
  if (act == kHswish)
    return v <= -3.f ? 0.f : (v >= 3.f ? 1.f : (2.f * v + 3.f) / 6.f);
  return 1.f;
}

// pro(x[idx]) of channel c, rounded to bf16 (identity without a prologue)
__device__ __forceinline__ float load_act(const __nv_bfloat16* x,
                                          const float* scale,
                                          const float* shift, int act,
                                          size_t idx, int c) {
  const float v = __bfloat162float(x[idx]);
  if (act == kNone) return v;
  return __bfloat162float(
      __float2bfloat16_rn(prologue(v, scale[c], shift[c], act)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Stage the (kTH+2) x (kTW+2) pixel halo tile of 16 channels [c0, c0+16)
// of one input, prologue applied and rounded to bf16, zeros outside the
// image and beyond the input's channels.
__device__ void load_tile(const Input& in, int b, int height, int width,
                          int ty0, int tx0, int c0, __nv_bfloat16* tile) {
  const int hs = in.up2x ? height >> 1 : height;
  const int ws = in.up2x ? width >> 1 : width;
  const bool vec = (in.c % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(in.x) % 16 == 0);
  for (int i = threadIdx.x; i < kTilePix * 2; i += blockDim.x) {
    const int pix = i >> 1;
    const int cb = c0 + (i & 1) * 8;
    const int yy = ty0 - 1 + pix / (kTW + 2);
    const int xx = tx0 - 1 + pix % (kTW + 2);
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = 0.f;
    if (yy >= 0 && yy < height && xx >= 0 && xx < width && cb < in.c) {
      const int sy = in.up2x ? yy >> 1 : yy;
      const int sx = in.up2x ? xx >> 1 : xx;
      const __nv_bfloat16* src =
          in.x + ((size_t)(b * hs + sy) * ws + sx) * in.c + cb;
      if (vec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(e[k]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (cb + k < in.c) v[k] = __bfloat162float(src[k]);
      }
      if (in.act != kNone) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (cb + k < in.c)
            v[k] = prologue(v[k], in.scale[cb + k], in.shift[cb + k], in.act);
      }
    }
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(v[k]);
    *reinterpret_cast<uint4*>(tile + pix * kKC + (i & 1) * 8) =
        *reinterpret_cast<const uint4*>(o);
  }
}

// Copy one chunk's (9, kKC, kN) weight slice [n0, n0+kN) into shared memory
// with a padded row stride ns (avoids bank conflicts on the B loads).
__device__ void load_weights(const __nv_bfloat16* wg, int np, int n0, int kn,
                             __nv_bfloat16* wsm, int ns) {
  const int vpr = kn / 8;
  for (int i = threadIdx.x; i < 9 * kKC * vpr; i += blockDim.x) {
    const int row = i / vpr;
    const int col = (i % vpr) * 8;
    *reinterpret_cast<uint4*>(wsm + row * ns + col) =
        *reinterpret_cast<const uint4*>(wg + (size_t)row * np + n0 + col);
  }
}

// The 9 taps of one staged chunk: warp w accumulates output row w,
// 16 pixels x NF fragments of 16 output channels.
template <int NF>
__device__ __forceinline__ void mma_chunk(
    const __nv_bfloat16* tile, const __nv_bfloat16* wsm, int ns, int warp,
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a;
    wmma::load_matrix_sync(a, tile + ((warp + dy) * (kTW + 2) + dx) * kKC,
                           kKC);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bm;
      wmma::load_matrix_sync(bm, wsm + tap * kKC * ns + f * 16, ns);
      wmma::mma_sync(acc[f], a, bm, acc[f]);
    }
  }
}

// --------------------------------------------------------------- dy sources
// What a backward kernel convolves: the upstream gradient dy of a conv
// output, staged as bf16 tiles. PlainDy reads a stored NHWC tensor; the
// head-loss source (head_loss.cu) synthesizes d(logits) on the fly.

struct PlainDy {
  const __nv_bfloat16* dy;  // (n, height, width, c)
  int c;

  // halo tile of channels [c0, c0+16), zeros outside the image
  __device__ void halo_tile(int b, int height, int width, int ty0, int tx0,
                            int c0, __nv_bfloat16* tile) const {
    const Input in{dy, nullptr, nullptr, c, kNone, 0, 0};
    load_tile(in, b, height, width, ty0, tx0, c0, tile);
  }

  // the kTH x kTW output pixels' channels [n0, n0+kn) at row stride ld
  __device__ void core_tile(int b, int height, int width, int ty0, int tx0,
                            int n0, int kn, __nv_bfloat16* dyt, int ld,
                            float* /*bsum*/) const {
    const int groups = kn / 8;
    const bool vec = (c % 8 == 0) &&
                     (reinterpret_cast<uintptr_t>(dy) % 16 == 0);
    for (int i = threadIdx.x; i < kTH * kTW * groups; i += blockDim.x) {
      const int pix = i / groups;
      const int g = i % groups;
      const int cb = n0 + g * 8;
      const int yy = ty0 + pix / kTW;
      const int xx = tx0 + pix % kTW;
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(0.f);
      if (yy < height && xx < width && cb < c) {
        const __nv_bfloat16* src =
            dy + ((size_t)(b * height + yy) * width + xx) * c + cb;
        if (vec) {
          *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int k = 0; k < 8 && cb + k < c; ++k) o[k] = src[k];
        }
      }
      *reinterpret_cast<uint4*>(dyt + pix * ld + g * 8) =
          *reinterpret_cast<const uint4*>(o);
    }
  }
};

// ----------------------------------------------------------- backward: dx
// dx of one forward input: a forward-style 3x3 conv of dy over the
// input's weight slice with flipped, transposed taps (wt: (dy chunks, 9,
// 16, np) over the input's channels), then the prologue's backward
// gm = g * act'(s*x + t): dx = gm*s (bf16), dscale += gm*x, dshift += gm.
// A lazily x2-upsampled input sums the 2x2 fine gradients at source
// resolution. SAME padding carries no gradient: only in-image positions
// are written.

struct DxParams {
  Input x;                  // the forward input (raw, prologue, up2x, c)
  const __nv_bfloat16* wt;  // (dy chunks, 9, kKC, np) transposed taps
  __nv_bfloat16* dx;        // raw-shaped gradient
  float* dscale;            // (c,) or null when x.act == kNone
  float* dshift;
  int n, height, width, np; // the conv's (fine) resolution
};

template <int NF>
constexpr int dx_smem_bytes() {
  return kTilePix * kKC * 2 + 9 * kKC * (NF * 16 + 8) * 2 + kTH * 256 * 4 +
         2 * NF * 16 * 4;
}

template <int NF, class Src>
__global__ void __launch_bounds__(kThreads)
    conv_dx_kernel(const DxParams p, const Src src) {
  constexpr int kN = NF * 16;
  constexpr int kNS = kN + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = tile + kTilePix * kKC;
  float* stage = reinterpret_cast<float*>(wsm + 9 * kKC * kNS);
  float* dsum = stage + kTH * 256;  // (2, kN)

  const int tiles_x = (p.width + kTW - 1) / kTW;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int b = blockIdx.y;
  const int n0 = blockIdx.z * kN;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 2 * kN; i += blockDim.x) dsum[i] = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);
  const int nch = (src.c + kKC - 1) / kKC;
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();
    src.halo_tile(b, p.height, p.width, ty0, tx0, ch * kKC, tile);
    load_weights(p.wt + (size_t)ch * 9 * kKC * p.np, p.np, n0, kN, wsm, kNS);
    __syncthreads();
    mma_chunk<NF>(tile, wsm, kNS, warp, acc);
  }

  const Input& x = p.x;
  const int t = threadIdx.x;
  const int cg = (t & 1) * 8;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(stage + warp * 256, acc[f], 16,
                            wmma::mem_row_major);
    __syncthreads();
    const int ci0 = n0 + f * 16 + cg;
    int sy, sx, hs, ws;
    float g[8];
    bool ok;
    if (!x.up2x) {
      const int pix = t >> 1, row = pix >> 4, px = pix & 15;
      sy = ty0 + row;
      sx = tx0 + px;
      hs = p.height;
      ws = p.width;
      ok = sy < hs && sx < ws;
#pragma unroll
      for (int k = 0; k < 8; ++k) g[k] = stage[row * 256 + px * 16 + cg + k];
    } else {
      // 2x2 fine pixels -> one source pixel; 4 x 8 source pixels a block
      const int spix = t >> 1, srow = spix >> 3, spx = spix & 7;
      sy = (ty0 >> 1) + srow;
      sx = (tx0 >> 1) + spx;
      hs = p.height >> 1;
      ws = p.width >> 1;
      ok = t < 64 && sy < hs && sx < ws;
#pragma unroll
      for (int k = 0; k < 8; ++k) g[k] = 0.f;
      if (t < 64) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int k = 0; k < 8; ++k)
              g[k] += stage[(2 * srow + i) * 256 + (2 * spx + j) * 16 + cg + k];
      }
    }
    if (ok) {
      const size_t base = ((size_t)(b * hs + sy) * ws + sx) * x.c;
      for (int k = 0; k < 8; ++k) {
        const int ci = ci0 + k;
        if (ci >= x.c) break;
        float d = g[k];
        if (x.act != kNone) {
          const float xi = __bfloat162float(x.x[base + ci]);
          const float s = x.scale[ci];
          const float v = __fadd_rn(__fmul_rn(xi, s), x.shift[ci]);
          const float gm = d * act_grad(v, x.act);
          d = gm * s;
          atomicAdd(&dsum[f * 16 + cg + k], gm * xi);
          atomicAdd(&dsum[kN + f * 16 + cg + k], gm);
        }
        p.dx[base + ci] = __float2bfloat16_rn(d);
      }
    }
    __syncthreads();
  }
  if (x.act != kNone) {
    for (int i = threadIdx.x; i < kN; i += blockDim.x) {
      const int ci = n0 + i;
      if (ci < x.c) {
        atomicAdd(&p.dscale[ci], dsum[i]);
        atomicAdd(&p.dshift[ci], dsum[kN + i]);
      }
    }
  }
}

// ----------------------------------------------------------- backward: dW
// dW[tap][ci][co] = sum over all output pixels p of a(p + tap - 1)[ci] *
// dy(p)[co], with a the prologue'd (bf16) input as the forward staged it.
// Blocks: x = one 16-channel input chunk (over all inputs), y = one tile of
// kN output channels, z = a share of the pixel tiles. Warp w of 9 owns tap
// w and keeps its NF 16x16 f32 fragments in registers over the block's
// pixel tiles; the block's partial sums reach dw by f32 atomics (order-
// dependent rounding, ~1e-6 relative). With bias != null the chunk-0
// blocks also sum dy (f32, before rounding) into dbias (HeadDy only).

constexpr int kDwThreads = 9 * 32;

struct DwParams {
  Input in[kMaxIn];
  int n_in;
  float* dw;     // (chunks, 9, kKC, np) f32
  float* dbias;  // (np,) f32 or null
  int n, height, width, np;
};

template <int NF>
constexpr int dw_smem_bytes() {
  return kTilePix * kKC * 2 + kTH * kTW * (NF * 16 + 8) * 2 + 9 * 256 * 4 +
         NF * 16 * 4;
}

template <int NF, class Src>
__global__ void __launch_bounds__(kDwThreads)
    conv_dw_kernel(const DwParams p, const Src src) {
  constexpr int kN = NF * 16;
  constexpr int kNS = kN + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dyt = tile + kTilePix * kKC;
  float* stage = reinterpret_cast<float*>(dyt + kTH * kTW * kNS);
  float* bsum = stage + 9 * 256;  // (kN,)

  const int chunk = blockIdx.x;
  int j = 0;
  while (j + 1 < p.n_in && chunk >= p.in[j + 1].chunk0) ++j;
  const Input& in = p.in[j];
  const int c0 = (chunk - in.chunk0) * kKC;
  const int n0 = blockIdx.y * kN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool with_bias = p.dbias != nullptr && chunk == 0;
  for (int i = threadIdx.x; i < kN; i += blockDim.x) bsum[i] = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  const int tiles_x = (p.width + kTW - 1) / kTW;
  const int tiles_y = (p.height + kTH - 1) / kTH;
  const int total = p.n * tiles_y * tiles_x;
  const int dy_ = warp / 3, dx_ = warp % 3;
  for (int tt = blockIdx.z; tt < total; tt += gridDim.z) {
    const int b = tt / (tiles_y * tiles_x);
    const int r = tt % (tiles_y * tiles_x);
    const int ty0 = (r / tiles_x) * kTH;
    const int tx0 = (r % tiles_x) * kTW;
    __syncthreads();
    load_tile(in, b, p.height, p.width, ty0, tx0, c0, tile);
    src.core_tile(b, p.height, p.width, ty0, tx0, n0, kN, dyt, kNS,
                  with_bias ? bsum : nullptr);
    __syncthreads();
#pragma unroll 2
    for (int row = 0; row < kTH; ++row) {
      // A = a^T: (16 channels) x (16 pixels of row+dy, from col dx)
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a;
      wmma::load_matrix_sync(
          a, tile + ((row + dy_) * (kTW + 2) + dx_) * kKC, kKC);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bm;
        wmma::load_matrix_sync(bm, dyt + row * kTW * kNS + f * 16, kNS);
        wmma::mma_sync(acc[f], a, bm, acc[f]);
      }
    }
  }

  float* st = stage + warp * 256;
  float* out = p.dw + ((size_t)chunk * 9 + warp) * kKC * p.np + n0;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(st, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      atomicAdd(&out[(size_t)(e >> 4) * p.np + f * 16 + (e & 15)], st[e]);
    __syncwarp();
  }
  if (with_bias) {
    __syncthreads();
    for (int i = threadIdx.x; i < kN; i += blockDim.x)
      atomicAdd(&p.dbias[n0 + i], bsum[i]);
  }
}

template <int NF, class Src>
cudaError_t launch_dw(const DwParams& p, const Src& src, int n_chunks,
                      cudaStream_t stream) {
  constexpr int smem = dw_smem_bytes<NF>();
  cudaError_t e = cudaFuncSetAttribute(
      conv_dw_kernel<NF, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const int tiles = p.n * ((p.height + kTH - 1) / kTH) *
                    ((p.width + kTW - 1) / kTW);
  const int xy = n_chunks * (p.np / (NF * 16));
  int split = (132 * 8 + xy - 1) / xy;
  if (split > tiles) split = tiles;
  if (split < 1) split = 1;
  const dim3 grid(n_chunks, p.np / (NF * 16), split);
  conv_dw_kernel<NF, Src><<<grid, kDwThreads, smem, stream>>>(p, src);
  return cudaGetLastError();
}

template <int NF, class Src>
cudaError_t launch_dx(const DxParams& p, const Src& src,
                      cudaStream_t stream) {
  constexpr int smem = dx_smem_bytes<NF>();
  cudaError_t e = cudaFuncSetAttribute(
      conv_dx_kernel<NF, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const int tiles = ((p.width + kTW - 1) / kTW) * ((p.height + kTH - 1) / kTH);
  const dim3 grid(tiles, p.n, p.np / (NF * 16));
  conv_dx_kernel<NF, Src><<<grid, kThreads, smem, stream>>>(p, src);
  return cudaGetLastError();
}

template <class Src>
cudaError_t launch_dw_nf(int nf, const DwParams& p, const Src& src,
                         int n_chunks, cudaStream_t s) {
  switch (nf) {
    case 1: return launch_dw<1>(p, src, n_chunks, s);
    case 2: return launch_dw<2>(p, src, n_chunks, s);
    case 4: return launch_dw<4>(p, src, n_chunks, s);
    case 8: return launch_dw<8>(p, src, n_chunks, s);
    default: return cudaErrorInvalidValue;
  }
}

template <class Src>
cudaError_t launch_dx_nf(int nf, const DxParams& p, const Src& src,
                         cudaStream_t s) {
  switch (nf) {
    case 1: return launch_dx<1>(p, src, s);
    case 2: return launch_dx<2>(p, src, s);
    case 4: return launch_dx<4>(p, src, s);
    case 8: return launch_dx<8>(p, src, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- dy prep
// The moments cotangent folded into dy: dye = dy + dm0 + 2*y*dm1 (every
// pixel of a stride-1 or stride-2 output is valid), stored bf16 when
// dmom != null; dbias += sum of the f32 dye when dbias != null. The grid
// is a multiple of c blocks of 256 threads, so each thread keeps one
// channel and one register sum.

__global__ void __launch_bounds__(256) dy_prep_kernel(
    const __nv_bfloat16* dy, const __nv_bfloat16* y, const float* dmom,
    __nv_bfloat16* dye, float* dbias, long long total, int c) {
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int ch = (int)(start % c);
  float sum = 0.f;
  for (long long i = start; i < total; i += stride) {
    float g = __bfloat162float(dy[i]);
    if (dmom != nullptr) {
      g = g + dmom[ch] + 2.f * __bfloat162float(y[i]) * dmom[c + ch];
      dye[i] = __float2bfloat16_rn(g);
    }
    sum += g;
  }
  if (dbias != nullptr) atomicAdd(&dbias[ch], sum);
}

cudaError_t launch_dy_prep(const void* dy, const void* y, const void* dmom,
                           void* dye, void* dbias, long long total, int c,
                           cudaStream_t s) {
  if (dmom == nullptr && dbias == nullptr) return cudaSuccess;
  long long blocks = (total + 255) / 256;
  const long long cap = 264LL * c;   // a multiple of c: fixed channel/thread
  if (blocks > cap) blocks = cap;
  blocks = ((blocks + c - 1) / c) * c;
  dy_prep_kernel<<<(int)blocks, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(dmom),
      static_cast<__nv_bfloat16*>(dye), static_cast<float*>(dbias), total, c);
  return cudaGetLastError();
}

}  // namespace
