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
// (zero outside the image): the dW half of K3 (fused_conv_bwd.cu).
//
// The TPU kernels pack p pixels x cp channels into 128-lane rows and multiply
// block-Toeplitz tap matrices (up to 8x wasted MACs) so that no lane moves.
// That layout is not ported. Here both kernels reuse the tile machinery of
// common.cuh: a block stages a (kTH+2) x (kTW+2) halo tile of 16 input
// channels in shared memory and multiplies on the tensor cores (WMMA bf16
// m16n16k16, f32 accumulators), so each input pixel is read from device
// memory once per block and its halo from L2.
//
// Bound on an H100: at the Path-A decoder's shapes (output 64x64 .. 256x256,
// cin 16..320, cout 10..64) a conv moves 2*(cin + cout) bytes per pixel for
// 2*9*cin*cout operations: 9*cin*cout/(cin + cout) op/byte, from 55 (the
// head, 16 -> 10) to 480 (320 -> 64). The cin >= 128, cout = 64 convs sit
// above the 295 op/byte ridge (tensor-core bound at best), the narrow ones
// below it (memory-bound). The design reads x and writes y once; loads are
// not yet overlapped with the
// products (no cp.async/TMA ring, WMMA not wgmma) and the weights are
// re-staged per 16-channel chunk per block: later work. K6b's blocks add
// their partial dW into device memory with f32 atomics: run to run, dW
// differs by f32 rounding (~1e-6 relative).

#include "common.cuh"

namespace {

struct ConvParams {
  Input x;                   // act kNone, up2x 0
  const __nv_bfloat16* wt;   // (chunks, 9, kKC, np), zero-padded
  const float* bias;         // (cout,) or null
  __nv_bfloat16* y;          // (n, height, width, cout)
  int n, height, width, cout, np, relu;
};

template <int NF>
constexpr int conv_smem_bytes() {
  return kTilePix * kKC * 2 + 9 * kKC * (NF * 16 + 8) * 2 + kTH * 256 * 4;
}

template <int NF>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(const ConvParams p) {
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

  const int nch = (p.x.c + kKC - 1) / kKC;
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();  // the previous chunk's products are done with smem
    load_tile(p.x, b, p.height, p.width, ty0, tx0, ch * kKC, tile);
    load_weights(p.wt + (size_t)ch * 9 * kKC * p.np, p.np, n0, kN, wsm, kNS);
    __syncthreads();
    mma_chunk<NF>(tile, wsm, kNS, warp, acc);
  }

  // epilogue: per-warp 16x16 staging, + bias (f32), ReLU, round to bf16,
  // masked store; lane = (pixel, 8-channel half)
  float* st = stage + warp * 256;
  const int oy = ty0 + warp;
  const int px = lane >> 1;
  const int cg = (lane & 1) * 8;
  const int ox = tx0 + px;
  const bool inside = oy < p.height && ox < p.width;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(st, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    const int co = n0 + f * 16 + cg;
    if (inside && co < p.cout) {
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float v = st[px * 16 + cg + k];
        if (p.bias != nullptr && co + k < p.cout) v += p.bias[co + k];
        if (p.relu) v = fmaxf(v, 0.f);
        o[k] = __float2bfloat16_rn(v);
      }
      __nv_bfloat16* dst =
          p.y + ((size_t)(b * p.height + oy) * p.width + ox) * p.cout + co;
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
cudaError_t launch(const ConvParams& p, cudaStream_t stream) {
  constexpr int smem = conv_smem_bytes<NF>();
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int tiles = ((p.width + kTW - 1) / kTW) * ((p.height + kTH - 1) / kTH);
  const dim3 grid(tiles, p.n, p.np / (NF * 16));
  conv3x3_kernel<NF><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Input plain_input(const void* x, int c) {
  return Input{static_cast<const __nv_bfloat16*>(x), nullptr, nullptr, c,
               kNone, 0, 0};
}

}  // namespace

// K6a host entry (plain C interface, bound with ctypes). x: (n, height,
// width, cin) bf16; wt: (cin chunks, 9, 16, np) bf16 with np = cout padded
// to a multiple of 16*nf, nf in {1, 2, 4, 8}; bias: (cout,) f32 or null;
// y: (n, height, width, cout) bf16. Returns a cudaError_t.
extern "C" int mmr_conv3x3(const void* x, int cin, const void* wt,
                           const void* bias, void* y, int n, int height,
                           int width, int cout, int np, int nf, int relu,
                           void* stream) {
  if (cin < 1 || cout < 1 || np < cout || np % (16 * nf) != 0)
    return (int)cudaErrorInvalidValue;
  ConvParams p{};
  p.x = plain_input(x, cin);
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.n = n;
  p.height = height;
  p.width = width;
  p.cout = cout;
  p.np = np;
  p.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1: return (int)launch<1>(p, s);
    case 2: return (int)launch<2>(p, s);
    case 4: return (int)launch<4>(p, s);
    case 8: return (int)launch<8>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6b host entry. x: (n, height, width, cin) bf16; g: (n, height, width,
// cout) bf16; dw: a zeroed (cin chunks, 9, 16, np) f32 buffer, np = cout
// padded to a multiple of 16*nf. Returns a cudaError_t.
extern "C" int mmr_conv3x3_dw(const void* x, int cin, const void* g, int cout,
                              void* dw, int n, int height, int width, int np,
                              int nf, void* stream) {
  if (cin < 1 || cout < 1 || np < cout || np % (16 * nf) != 0)
    return (int)cudaErrorInvalidValue;
  DwParams q{};
  q.in[0] = plain_input(x, cin);
  q.n_in = 1;
  q.dw = static_cast<float*>(dw);
  q.dbias = nullptr;
  q.n = n;
  q.height = height;
  q.width = width;
  q.np = np;
  const PlainDy src{static_cast<const __nv_bfloat16*>(g), cout};
  return (int)launch_dw_nf(nf, q, src, (cin + kKC - 1) / kKC,
                           static_cast<cudaStream_t>(stream));
}
