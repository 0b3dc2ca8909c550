// K2: fused 3x3 stride-2 pad-(1,1) convolution, forward (eval).
//
// Replaces the TPU kernel `_down_fwd_kernel` reached through
// `mmr_tpu/ops/pallas/packed_chain.py::fused_conv_down` (`_down_fwd_call`,
// the `pl.pallas_call` at packed_chain.py:1786).
//
// Computes, for NHWC bf16 tensors, y[r, c] = sum over the 3x3 window at
// source rows/cols 2r-1 .. 2r+1 of pro(x) * W (+ bias), with the same
// optional prologue pro(v) = act(s*v + t) as K1 (f32, rounded to bf16 before
// the multiply-accumulate; zero padding AFTER the prologue), f32
// accumulation and y stored raw in bf16. Two specialisations:
//
// - dense (the mbv3 stem, Cin = 3): one thread per output pixel computes
//   all output channels from the 9 x Cin source values it reads once
//   (6-byte pixels: scalar loads, cached in L1 across the overlapping
//   windows of neighbouring threads); weights live in shared memory as f32.
// - depthwise (b0_0, C = 16): one thread per (output pixel, channel), so a
//   warp reads contiguous channel runs. The TPU kernel ran the depthwise
//   conv as a diagonal-expanded dense conv at C x the MACs; here it does the
//   9 MACs per output value the function needs.
//
// Bound on an H100: both launches do 2*9*Cin ops per output value against
// 2 bytes per input value read and output value written, far below the
// 295 op/byte ridge, so they are bound by device-memory bytes; the design
// reads each input byte from device memory about once (the overlapping 3x3
// windows hit L1/L2) and writes each output once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { kNone = 0, kRelu = 1, kHswish = 2, kLinear = 3 };

constexpr int kThreads = 256;
constexpr int kCoBlock = 16;

struct DownParams {
  const __nv_bfloat16* x;  // (n, h, w, cin)
  const float* scale;      // (cin,) or null when act == kNone
  const float* shift;
  int act;
  const __nv_bfloat16* wt;  // dense: (9, cin, cout); depthwise: (9, cin)
  const float* bias;        // (cout,) or null
  __nv_bfloat16* y;         // (n, ho, wo, cout)
  int n, h, w, cin, cout, ho, wo;
};

__device__ __forceinline__ float prologue(float v, float s, float t, int act) {
  v = __fadd_rn(__fmul_rn(v, s), t);
  if (act == kRelu) return fmaxf(v, 0.f);
  if (act == kHswish) {
    const float g = fminf(fmaxf(__fadd_rn(v, 3.f), 0.f), 6.f);
    return __fmul_rn(__fmul_rn(v, g), 1.f / 6.f);
  }
  return v;
}

__device__ __forceinline__ float load_act(const DownParams& p, size_t idx,
                                          int c) {
  const float v = __bfloat162float(p.x[idx]);
  if (p.act == kNone) return v;
  return __bfloat162float(__float2bfloat16_rn(
      prologue(v, p.scale[c], p.shift[c], p.act)));
}

__global__ void __launch_bounds__(kThreads) down_dense_kernel(
    const DownParams p) {
  extern __shared__ float wsm[];  // (9, cin, cout) f32
  const int nw = 9 * p.cin * p.cout;
  for (int i = threadIdx.x; i < nw; i += blockDim.x)
    wsm[i] = __bfloat162float(p.wt[i]);
  __syncthreads();

  const long long total = (long long)p.n * p.ho * p.wo;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int ox = (int)(idx % p.wo);
    const long long t = idx / p.wo;
    const int oy = (int)(t % p.ho);
    const int b = (int)(t / p.ho);
    __nv_bfloat16* dst = p.y + (size_t)idx * p.cout;
    for (int co0 = 0; co0 < p.cout; co0 += kCoBlock) {
      float acc[kCoBlock];
#pragma unroll
      for (int k = 0; k < kCoBlock; ++k) acc[k] = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const int iy = 2 * oy - 1 + tap / 3;
        const int ix = 2 * ox - 1 + tap % 3;
        if (iy < 0 || iy >= p.h || ix < 0 || ix >= p.w) continue;
        const size_t base = ((size_t)(b * p.h + iy) * p.w + ix) * p.cin;
        for (int ci = 0; ci < p.cin; ++ci) {
          const float v = load_act(p, base + ci, ci);
          const float* wr = wsm + (tap * p.cin + ci) * p.cout + co0;
#pragma unroll
          for (int k = 0; k < kCoBlock; ++k)
            if (co0 + k < p.cout) acc[k] = fmaf(v, wr[k], acc[k]);
        }
      }
      __align__(16) __nv_bfloat16 o[kCoBlock];
#pragma unroll
      for (int k = 0; k < kCoBlock; ++k) {
        float v = acc[k];
        if (p.bias != nullptr && co0 + k < p.cout) v += p.bias[co0 + k];
        o[k] = __float2bfloat16_rn(v);
      }
      __nv_bfloat16* d = dst + co0;
      if (co0 + kCoBlock <= p.cout &&
          reinterpret_cast<uintptr_t>(d) % 16 == 0) {
        reinterpret_cast<uint4*>(d)[0] = reinterpret_cast<const uint4*>(o)[0];
        reinterpret_cast<uint4*>(d)[1] = reinterpret_cast<const uint4*>(o)[1];
      } else {
        for (int k = 0; k < kCoBlock && co0 + k < p.cout; ++k) d[k] = o[k];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) down_dw_kernel(
    const DownParams p) {
  const long long total = (long long)p.n * p.ho * p.wo * p.cin;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % p.cin);
    const long long pix = idx / p.cin;
    const int ox = (int)(pix % p.wo);
    const long long t = pix / p.wo;
    const int oy = (int)(t % p.ho);
    const int b = (int)(t / p.ho);
    float acc = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int iy = 2 * oy - 1 + tap / 3;
      const int ix = 2 * ox - 1 + tap % 3;
      if (iy < 0 || iy >= p.h || ix < 0 || ix >= p.w) continue;
      const float v =
          load_act(p, ((size_t)(b * p.h + iy) * p.w + ix) * p.cin + c, c);
      acc = fmaf(v, __bfloat162float(p.wt[tap * p.cin + c]), acc);
    }
    if (p.bias != nullptr) acc += p.bias[c];
    p.y[idx] = __float2bfloat16_rn(acc);
  }
}

}  // namespace

// Host entry (plain C interface, bound with ctypes). depthwise != 0 selects
// the depthwise kernel (then cout == cin). Returns a cudaError_t.
extern "C" int mmr_fused_conv_down(const void* x, const void* scale,
                                   const void* shift, int act, const void* wt,
                                   const void* bias, void* y, int n, int h,
                                   int w, int cin, int cout, int depthwise,
                                   void* stream) {
  DownParams p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.act = act;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.ho = (h + 1) / 2;
  p.wo = (w + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long work =
      (long long)n * p.ho * p.wo * (depthwise ? (long long)cin : 1LL);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  if (depthwise) {
    if (cout != cin) return (int)cudaErrorInvalidValue;
    down_dw_kernel<<<(int)blocks, kThreads, 0, s>>>(p);
  } else {
    const int smem = 9 * cin * cout * (int)sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    down_dense_kernel<<<(int)blocks, kThreads, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}
