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
//
// K8a / K8b: the same two kernels at f32 storage as well. They replace the
// round-1 shifted-GEMM conv of `mmr_tpu/ops/pallas/conv3x3.py`:
// `_conv3x3_pallas` (the `pl.pallas_call` at :165) and `_conv3x3_dw_pallas`
// (:208), reached through `conv3x3_bias_act` (:250) when `_FORCE_PALLAS` is
// set; its VJP runs K8a again for dx and K8b for dW (:266-286). K8a takes
// x in any float type rounded to bf16 on chip (:96-97) and stores y in x's
// type (:179); an f32 x is rounded to bf16 as its tile is staged (no
// separate cast pass), bias and ReLU stay in the f32 epilogue (:112-118).
// The TPU kernel's channel-major (B, C, (H+4)*Wp) canvas, lane rolls and
// (9C, P) tap stack (:60-97, :141-150) are its layout and are not ported.
// K8b reads dy in x's type, as the VJP passes it (g.astype(x.dtype)), and
// stages it as bf16 for the WMMA products where the TPU kernel reads dy as
// f32: dW differs from an f32-dy reference by the rounding of dy, within
// the JAX suite's own bound for this kernel, 1e-2 of max|ref|
// (tests/test_conv3x3_kernel.py:41-52). At the shape the TPU kernel was
// written for (16 -> 16 channels on (32, 512, 512), bf16) a conv does 72
// op/byte, below the ridge: memory-bound, ~0.16 ms per direction.

#include "common.cuh"

// The kernels are common.cuh's conv3x3_kernel<NF, T> and conv_dw_kernel
// over one InputT<T> and a PlainDyT<T> source, T = bf16 (K6, and K8 on
// bf16) or f32 (K8 on f32 storage).

namespace {

template <class T>
cudaError_t conv_fwd(const void* x, int cin, const void* wt,
                     const void* bias, void* y, int n, int height, int width,
                     int cout, int np, int nf, int relu, cudaStream_t s) {
  ConvParamsT<T> p{};
  p.x = plain_input<T>(x, cin);
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<T*>(y);
  p.n = n;
  p.height = height;
  p.width = width;
  p.cout = cout;
  p.np = np;
  p.relu = relu;
  return launch_conv_nf(nf, p, s);
}

template <class T>
cudaError_t conv_dw(const void* x, int cin, const void* g, int cout, void* dw,
                    int n, int height, int width, int np, int nf,
                    cudaStream_t s) {
  DwParamsT<T> q{};
  q.in[0] = plain_input<T>(x, cin);
  q.n_in = 1;
  q.dw = static_cast<float*>(dw);
  q.dbias = nullptr;
  q.n = n;
  q.height = height;
  q.width = width;
  q.np = np;
  const PlainDyT<T> src{static_cast<const T*>(g), cout};
  return launch_dw_nf(nf, q, src, (cin + kKC - 1) / kKC, s);
}

bool bad_shape(int cin, int cout, int np, int nf) {
  return cin < 1 || cout < 1 || np < cout || nf < 1 || np % (16 * nf) != 0;
}

}  // namespace

// K6a / K8a host entry (plain C interface, bound with ctypes). x: (n,
// height, width, cin), f32 when x_f32 else bf16; wt: (cin chunks, 9, 16,
// np) bf16 with np = cout padded to a multiple of 16*nf, nf in {1, 2, 4,
// 8}; bias: (cout,) f32 or null; y: (n, height, width, cout) in x's type.
// Returns a cudaError_t.
extern "C" int mmr_conv3x3(const void* x, int x_f32, int cin, const void* wt,
                           const void* bias, void* y, int n, int height,
                           int width, int cout, int np, int nf, int relu,
                           void* stream) {
  if (bad_shape(cin, cout, np, nf)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_f32 ? conv_fwd<float>(x, cin, wt, bias, y, n, height, width,
                                       cout, np, nf, relu, s)
                     : conv_fwd<__nv_bfloat16>(x, cin, wt, bias, y, n, height,
                                               width, cout, np, nf, relu, s));
}

// K6b / K8b host entry. x: (n, height, width, cin) and g: (n, height,
// width, cout), both f32 when x_f32 else bf16; dw: a zeroed (cin chunks,
// 9, 16, np) f32 buffer, np = cout padded to a multiple of 16*nf. Returns
// a cudaError_t.
extern "C" int mmr_conv3x3_dw(const void* x, int x_f32, int cin,
                              const void* g, int cout, void* dw, int n,
                              int height, int width, int np, int nf,
                              void* stream) {
  if (bad_shape(cin, cout, np, nf)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_f32 ? conv_dw<float>(x, cin, g, cout, dw, n, height, width,
                                      np, nf, s)
                     : conv_dw<__nv_bfloat16>(x, cin, g, cout, dw, n, height,
                                              width, np, nf, s));
}
