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
// That layout is not ported. Both kernels run on common.cuh's Hopper
// mainloops, each read of x or g staged once per block by cp.async into a
// ring of 2 stages (3 at 64 output channels) and multiplied by wgmma
// m64nNk16 from shared memory: K6a on conv_wg_kernel (M = one 64-pixel
// output row segment; block = 2 warpgroups x 4 rows at N <= 32 output
// channels, 4 warpgroups x 2 rows at N = 64; per stage one 16-channel
// chunk's halo tile and its 9 taps for the block's N), K6b on
// conv_dw_wg_kernel (M = 64 input channels, N = 16 or 32 output channels,
// K = 16-pixel steps over tiles of 4 x 64 output pixels; one warpgroup per
// tap row; x staged through registers one tile ahead).
// No shape runs on mma.sync: a narrow input (cin < 64) leaves K6b's M rows
// beyond cin zero.
//
// Bound on an H100: at the Path-A decoder's shapes (output 64x64 .. 256x256,
// cin 16..320, cout 10..64) a conv moves 2*(cin + cout) bytes per pixel for
// 2*9*cin*cout operations: 9*cin*cout/(cin + cout) op/byte, from 55 (the
// head, 16 -> 10) to 480 (320 -> 64). The cin >= 128, cout = 64 convs sit
// above the 295 op/byte ridge (tensor-core bound at best), the narrow ones
// below it (memory-bound). K6b's blocks add their partial dW into device
// memory with f32 atomics: run to run, dW differs by f32 rounding (~1e-6
// relative).
//
// K8a / K8b: the same two kernels at f32 storage as well. They replace the
// round-1 shifted-GEMM conv of `mmr_tpu/ops/pallas/conv3x3.py`:
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
// (tests/test_conv3x3_kernel.py:41-52). At the shape the TPU kernel was
// written for (16 -> 16 channels on (32, 512, 512), bf16) a conv does 72
// op/byte, below the ridge: memory-bound, ~0.16 ms per direction.

#include "common.cuh"

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

template <class T>
cudaError_t conv_dw(const void* x, int cin, const void* g, int cout, void* dw,
                    int n, int height, int width, int np, int ntile,
                    cudaStream_t s) {
  DwWgParams<T> q{};
  q.in[0] = plain_input<T>(x, cin);
  q.n_in = 1;
  q.dy = static_cast<const T*>(g);
  q.cout = cout;
  q.dw = static_cast<float*>(dw);
  const int chunks = (cin + 63) / 64;
  q.cpad = 64 * chunks;
  q.np = np;
  q.n = n;
  q.height = height;
  q.width = width;
  return launch_dw_wg(ntile, q, chunks, s);
}

bool bad_shape(int cin, int cout, int np, int ntile) {
  return cin < 1 || cout < 1 || np < cout ||
         (ntile != 16 && ntile != 32 && ntile != 64) || np % ntile != 0;
}

}  // namespace

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
// width, cout), both f32 when x_f32 else bf16; dw: a zeroed (9, 64 *
// ceil(cin / 64), np) f32 buffer, np = cout padded to a multiple of ntile
// in {16, 32}. Returns a cudaError_t.
extern "C" int mmr_conv3x3_dw(const void* x, int x_f32, int cin,
                              const void* g, int cout, void* dw, int n,
                              int height, int width, int np, int ntile,
                              void* stream) {
  if (bad_shape(cin, cout, np, ntile)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_f32 ? conv_dw<float>(x, cin, g, cout, dw, n, height, width,
                                      np, ntile, s)
                     : conv_dw<__nv_bfloat16>(x, cin, g, cout, dw, n, height,
                                              width, np, ntile, s));
}
