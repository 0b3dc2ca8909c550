// K2: fused 3x3 stride-2 pad-(1,1) convolution, forward, with the optional
// BN moments of its output.
//
// Replaces the TPU kernel `_down_fwd_kernel` reached through
// `mmr_tpu/ops/pallas/packed_chain.py::fused_conv_down` (`_down_fwd_call`,
// the `pl.pallas_call` at packed_chain.py:1786).
//
// Computes, for NHWC bf16 tensors, y[r, c] = sum over the 3x3 window at
// source rows/cols 2r-1 .. 2r+1 of pro(x) * W (+ bias), with the same
// optional prologue pro(v) = act(s*v + t) as K1 (f32, rounded to bf16 before
// the multiply-accumulate; zero padding AFTER the prologue), f32
// accumulation and y stored raw in bf16. With mom != null it also emits
// mom[0][c] += sum y, mom[1][c] += sum y^2 from the f32 values (bias
// included) before the rounding: per-block shared sums, then f32 atomics.
// Two specialisations:
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

#include "common.cuh"

namespace {

constexpr int kCoBlock = 16;

struct DownParams {
  const __nv_bfloat16* x;  // (n, h, w, cin)
  const float* scale;      // (cin,) or null when act == kNone
  const float* shift;
  int act;
  const __nv_bfloat16* wt;  // dense: (9, cin, cout); depthwise: (9, cin)
  const float* bias;        // (cout,) or null
  __nv_bfloat16* y;         // (n, ho, wo, cout)
  float* mom;               // (2, cout) or null
  int n, h, w, cin, cout, ho, wo;
};

__global__ void __launch_bounds__(kThreads) down_dense_kernel(
    const DownParams p) {
  extern __shared__ float wsm[];  // (9, cin, cout) f32, then (2, cout) sums
  float* msm = wsm + 9 * p.cin * p.cout;
  const int nw = 9 * p.cin * p.cout;
  for (int i = threadIdx.x; i < nw; i += blockDim.x)
    wsm[i] = __bfloat162float(p.wt[i]);
  for (int i = threadIdx.x; i < 2 * p.cout; i += blockDim.x) msm[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long total = (long long)p.n * p.ho * p.wo;
  // block-uniform trip count: the moments' warp shuffles need every lane
  for (long long base = (long long)blockIdx.x * blockDim.x; base < total;
       base += (long long)gridDim.x * blockDim.x) {
    const long long idx = base + threadIdx.x;
    const bool ok = idx < total;
    const int ox = (int)(idx % p.wo);
    const long long t = idx / p.wo;
    const int oy = (int)(t % p.ho);
    const int b = (int)(t / p.ho);
    __nv_bfloat16* dst = p.y + (size_t)idx * p.cout;
    for (int co0 = 0; co0 < p.cout; co0 += kCoBlock) {
      float acc[kCoBlock];
#pragma unroll
      for (int k = 0; k < kCoBlock; ++k) acc[k] = 0.f;
      for (int tap = 0; tap < 9 && ok; ++tap) {
        const int iy = 2 * oy - 1 + tap / 3;
        const int ix = 2 * ox - 1 + tap % 3;
        if (iy < 0 || iy >= p.h || ix < 0 || ix >= p.w) continue;
        const size_t base_i = ((size_t)(b * p.h + iy) * p.w + ix) * p.cin;
        for (int ci = 0; ci < p.cin; ++ci) {
          const float v = load_act(p.x, p.scale, p.shift, p.act, base_i + ci,
                                   ci);
          const float* wr = wsm + (tap * p.cin + ci) * p.cout + co0;
#pragma unroll
          for (int k = 0; k < kCoBlock; ++k)
            if (co0 + k < p.cout) acc[k] = fmaf(v, wr[k], acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kCoBlock; ++k)
        if (p.bias != nullptr && co0 + k < p.cout) acc[k] += p.bias[co0 + k];
      if (ok) {
        __align__(16) __nv_bfloat16 o[kCoBlock];
#pragma unroll
        for (int k = 0; k < kCoBlock; ++k) o[k] = __float2bfloat16_rn(acc[k]);
        __nv_bfloat16* d = dst + co0;
        if (co0 + kCoBlock <= p.cout &&
            reinterpret_cast<uintptr_t>(d) % 16 == 0) {
          reinterpret_cast<uint4*>(d)[0] = reinterpret_cast<const uint4*>(o)[0];
          reinterpret_cast<uint4*>(d)[1] = reinterpret_cast<const uint4*>(o)[1];
        } else {
          for (int k = 0; k < kCoBlock && co0 + k < p.cout; ++k) d[k] = o[k];
        }
      }
      if (p.mom != nullptr) {
#pragma unroll
        for (int k = 0; k < kCoBlock; ++k) {
          const float v = (ok && co0 + k < p.cout) ? acc[k] : 0.f;
          const float s1 = warp_sum(v);
          const float s2 = warp_sum(v * v);
          if (lane == 0 && co0 + k < p.cout) {
            atomicAdd(&msm[co0 + k], s1);
            atomicAdd(&msm[p.cout + co0 + k], s2);
          }
        }
      }
    }
  }
  if (p.mom != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * p.cout; i += blockDim.x)
      atomicAdd(&p.mom[i], msm[i]);
  }
}

__global__ void __launch_bounds__(kThreads) down_dw_kernel(
    const DownParams p) {
  extern __shared__ float msm[];  // (2, cin) block sums
  for (int i = threadIdx.x; i < 2 * p.cin; i += blockDim.x) msm[i] = 0.f;
  __syncthreads();
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
      const float v = load_act(p.x, p.scale, p.shift, p.act,
                               ((size_t)(b * p.h + iy) * p.w + ix) * p.cin + c,
                               c);
      acc = fmaf(v, __bfloat162float(p.wt[tap * p.cin + c]), acc);
    }
    if (p.bias != nullptr) acc += p.bias[c];
    p.y[idx] = __float2bfloat16_rn(acc);
    if (p.mom != nullptr) {
      atomicAdd(&msm[c], acc);
      atomicAdd(&msm[p.cin + c], acc * acc);
    }
  }
  if (p.mom != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * p.cin; i += blockDim.x)
      atomicAdd(&p.mom[i], msm[i]);
  }
}

}  // namespace

// Host entry (plain C interface, bound with ctypes). depthwise != 0 selects
// the depthwise kernel (then cout == cin). mom: a zeroed (2, cout) f32
// buffer or null. Returns a cudaError_t.
extern "C" int mmr_fused_conv_down(const void* x, const void* scale,
                                   const void* shift, int act, const void* wt,
                                   const void* bias, void* y, void* mom, int n,
                                   int h, int w, int cin, int cout,
                                   int depthwise, void* stream) {
  DownParams p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.act = act;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.mom = static_cast<float*>(mom);
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
    down_dw_kernel<<<(int)blocks, kThreads, 2 * cin * (int)sizeof(float), s>>>(
        p);
  } else {
    const int smem = (9 * cin * cout + 2 * cout) * (int)sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    down_dense_kernel<<<(int)blocks, kThreads, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}
