// K1: multi-input fused 3x3 stride-1 SAME convolution, forward (eval).
//
// Replaces the TPU kernel `_fused_fwd_kernel` reached through
// `mmr_tpu/ops/pallas/packed_chain.py::fused_conv` (`_fwd_call`, the
// `pl.pallas_call` at packed_chain.py:1070).
//
// Computes, for NHWC bf16 tensors,
//     y = sum_j conv3x3_SAME(pro_j(x_j) [x2-nearest if up2x_j], W_j) + bias
// with pro_j(v) = act_j(s_j * v + t_j) evaluated in f32 and rounded to bf16
// before the multiply-accumulate (where the TPU kernel rounds), f32
// accumulation, and y stored raw in bf16. The concat of the inputs, the
// activated inputs and the upsampled inputs never reach device memory: each
// block reads the raw inputs and applies prologue and upsample while it
// stages its tile in shared memory. SAME padding is zero AFTER the prologue
// (act(0*s + t) != 0), and a lazy x2 input's border is the fine tensor's.
//
// Bound on an H100: the UNet++ decoder convs move ~50-400 bytes of input and
// output per output pixel for 2*9*Cin*Cout operations, so at bf16 tensor-core
// rates most launches sit below the 295 op/byte ridge (memory-bound) and the
// 64x80 ones with Cin >= 300 above it. The design reads every input pixel
// from device memory once per block (the 1-pixel halo is re-read from L2)
// and runs the products on the tensor cores (WMMA bf16 m16n16k16, f32
// accumulators in registers): one block = 8 output rows x 16 pixels x up to
// 128 output channels, one warp per row, input channels in chunks of 16.
// Tile loads are not yet overlapped with the products (no cp.async/TMA
// pipeline, no wgmma): that is later work.

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

struct Params {
  Input in[kMaxIn];
  int n_in;
  const __nv_bfloat16* wt;  // (chunks, 9, kKC, np), zero-padded
  const float* bias;        // (cout,) or null
  __nv_bfloat16* y;         // (n, height, width, cout)
  int n, height, width, cout, np;
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

// Stage the (kTH+2) x (kTW+2) pixel halo tile of 16 channels [c0, c0+16)
// of one input, prologue applied and rounded to bf16, zeros outside the
// image and beyond the input's channels.
__device__ void load_tile(const Input& in, int b, int height, int width,
                          int ty0, int tx0, int c0, __nv_bfloat16* tile) {
  const int hs = in.up2x ? height >> 1 : height;
  const int ws = in.up2x ? width >> 1 : width;
  const bool vec = (in.c % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(in.x) % 16 == 0);
  for (int i = threadIdx.x; i < kTilePix * 2; i += kThreads) {
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
  for (int i = threadIdx.x; i < 9 * kKC * vpr; i += kThreads) {
    const int row = i / vpr;
    const int col = (i % vpr) * 8;
    *reinterpret_cast<uint4*>(wsm + row * ns + col) =
        *reinterpret_cast<const uint4*>(wg + (size_t)row * np + n0 + col);
  }
}

template <int NF>
__global__ void __launch_bounds__(kThreads) fused_conv_kernel(const Params p) {
  constexpr int kN = NF * 16;
  constexpr int kNS = kN + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = tile + kTilePix * kKC;
  float* stage = reinterpret_cast<float*>(wsm + 9 * kKC * kNS);

  const int tiles_x = (p.width + kTW - 1) / kTW;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int b = blockIdx.y;
  const int n0 = blockIdx.z * kN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int j = 0; j < p.n_in; ++j) {
    const Input in = p.in[j];
    const int nch = (in.c + kKC - 1) / kKC;
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();  // previous chunk's products are done with smem
      load_tile(in, b, p.height, p.width, ty0, tx0, ch * kKC, tile);
      load_weights(p.wt + (size_t)(in.chunk0 + ch) * 9 * kKC * p.np, p.np,
                   n0, kN, wsm, kNS);
      __syncthreads();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(
            a, tile + ((warp + dy) * (kTW + 2) + dx) * kKC, kKC);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bm;
          wmma::load_matrix_sync(bm, wsm + tap * kKC * kNS + f * 16, kNS);
          wmma::mma_sync(acc[f], a, bm, acc[f]);
        }
      }
    }
  }

  // epilogue: per-warp 16x16 staging, + bias, round to bf16, masked store
  float* st = stage + warp * 256;
  const int oy = ty0 + warp;
  const int px = lane >> 1;
  const int cg = (lane & 1) * 8;
  const int ox = tx0 + px;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(st, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    const int co = n0 + f * 16 + cg;
    if (oy < p.height && ox < p.width && co < p.cout) {
      __nv_bfloat16* dst =
          p.y + ((size_t)(b * p.height + oy) * p.width + ox) * p.cout + co;
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float v = st[px * 16 + cg + k];
        if (p.bias != nullptr && co + k < p.cout) v += p.bias[co + k];
        o[k] = __float2bfloat16_rn(v);
      }
      if (co + 8 <= p.cout && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
      } else {
        for (int k = 0; k < 8 && co + k < p.cout; ++k) dst[k] = o[k];
      }
    }
    __syncwarp();
  }
}

template <int NF>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kN = NF * 16;
  const int smem = kTilePix * kKC * 2 + 9 * kKC * (kN + 8) * 2 +
                   kTH * 256 * 4;
  cudaError_t e = cudaFuncSetAttribute(
      fused_conv_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const int tiles = ((p.width + kTW - 1) / kTW) * ((p.height + kTH - 1) / kTH);
  const dim3 grid(tiles, p.n, p.np / kN);
  fused_conv_kernel<NF><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Host entry (plain C interface, bound with ctypes). Per-input arrays have
// n_in entries. np is cout padded to a multiple of 16*nf, nf in {1,2,4,8}
// the 16-channel output fragments per block. Returns a cudaError_t.
extern "C" int mmr_fused_conv(int n_in, const void* const* xs,
                              const void* const* scales,
                              const void* const* shifts, const int* cs,
                              const int* acts, const int* ups, const void* wt,
                              const void* bias, void* y, int n, int height,
                              int width, int cout, int np, int nf,
                              void* stream) {
  if (n_in < 1 || n_in > kMaxIn || np % (16 * nf) != 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  int chunk = 0;
  for (int j = 0; j < n_in; ++j) {
    p.in[j].x = static_cast<const __nv_bfloat16*>(xs[j]);
    p.in[j].scale = static_cast<const float*>(scales[j]);
    p.in[j].shift = static_cast<const float*>(shifts[j]);
    p.in[j].c = cs[j];
    p.in[j].act = acts[j];
    p.in[j].up2x = ups[j];
    p.in[j].chunk0 = chunk;
    chunk += (cs[j] + kKC - 1) / kKC;
  }
  p.n_in = n_in;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.n = n;
  p.height = height;
  p.width = width;
  p.cout = cout;
  p.np = np;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1: return (int)launch<1>(p, s);
    case 2: return (int)launch<2>(p, s);
    case 4: return (int)launch<4>(p, s);
    case 8: return (int)launch<8>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
