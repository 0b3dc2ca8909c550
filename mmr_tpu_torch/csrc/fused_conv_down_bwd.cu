// K4: the backward of K2 (fused 3x3 stride-2 pad-(1,1) conv).
//
// Replaces the TPU kernel `_down_bwd_kernel` (packed_chain.py:1577)
// reached through `_down_bwd_call` (packed_chain.py:1800, the
// `pl.pallas_call` at :1877).
//
// Given the forward's raw bf16 input x with its pending prologue, the
// weights, the stored output y, dy and the moments cotangent dmom, computes
//   dye   = dy + dm0 + 2*y*dm1 (bf16)   and   dbias = sum dye (f32)
//   dW[tap][ci][co] = sum_o a(2o - 1 + tap)[ci] * dye(o)[co]     (f32)
//   dx (optional) = prologue_bwd(the stride-2 transposed conv of dye)
//   dscale, dshift = sums of gm*x and gm, gm = g * act'(s*x + t)
// with a the bf16 prologue'd input as the forward read it. The TPU
// kernel's diagonal-expanded depthwise taps and phase pairs are layout
// artefacts and are not carried over:
//
// - dense (the mbv3 stem, Cin = 3 -> 16, dW only: its input is the image):
//   each block stages 64 output pixels' 9*Cin prologue'd source values and
//   their Cout dye values in shared memory; thread o owns dW entry o
//   (9*Cin*Cout of them) and sums the products over the block's pixels;
//   block sums reach dW by f32 atomics.
// - depthwise (b0_0, C = 16): dW by one thread per (output pixel, channel)
//   with 9 register sums (the block's 256 threads keep fixed channels);
//   dx by one thread per (source pixel, channel) gathering the <= 4 taps
//   whose stride-2 window covers it (dye row/col parity), then the
//   prologue backward (the stem's BN + hardswish).
//
// f32 atomics sum the blocks in no fixed order: dW, dscale and dshift
// differ run to run by f32 rounding (~1e-6 relative).
//
// Bound on an H100: 2*9*Cin*Cout (dense) or 2*9 (depthwise) operations per
// output value for dW, as many again for dx, against 2 bytes per value of
// dy, y, x and dx: far below the 295 op/byte ridge, so bytes bound it.

#include "common.cuh"

namespace {

constexpr int kDensePix = 64;

struct DownBwdParams {
  const __nv_bfloat16* x;  // (n, h, w, cin)
  const float* scale;      // (cin,) or null when act == kNone
  const float* shift;
  int act;
  const __nv_bfloat16* wt;  // dense: (9, cin, cout); depthwise: (9, cin)
  const __nv_bfloat16* dye; // (n, ho, wo, cout)
  __nv_bfloat16* dx;        // (n, h, w, cin) or null
  float* dscale;            // (cin,) or null
  float* dshift;
  float* dw;                // like wt, f32
  int n, h, w, cin, cout, ho, wo;
};

__global__ void __launch_bounds__(kThreads) down_dense_dw_kernel(
    const DownBwdParams p) {
  const int K = 9 * p.cin, N = p.cout;
  extern __shared__ float sm[];
  float* acc = sm;                 // (K, N) block sums
  float* as = acc + K * N;         // (kDensePix, K) prologue'd source values
  float* ds = as + kDensePix * K;  // (kDensePix, N) dye values
  for (int i = threadIdx.x; i < K * N; i += blockDim.x) acc[i] = 0.f;
  const long long total = (long long)p.n * p.ho * p.wo;
  for (long long base = (long long)blockIdx.x * kDensePix; base < total;
       base += (long long)gridDim.x * kDensePix) {
    __syncthreads();
    for (int e = threadIdx.x; e < kDensePix * K; e += blockDim.x) {
      const int pp = e / K, kk = e % K;
      const int tap = kk / p.cin, ci = kk % p.cin;
      const long long idx = base + pp;
      float v = 0.f;
      if (idx < total) {
        const int ox = (int)(idx % p.wo);
        const long long t = idx / p.wo;
        const int oy = (int)(t % p.ho);
        const int b = (int)(t / p.ho);
        const int iy = 2 * oy - 1 + tap / 3;
        const int ix = 2 * ox - 1 + tap % 3;
        if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w)
          v = load_act(p.x, p.scale, p.shift, p.act,
                       ((size_t)(b * p.h + iy) * p.w + ix) * p.cin + ci, ci);
      }
      as[e] = v;
    }
    for (int e = threadIdx.x; e < kDensePix * N; e += blockDim.x) {
      const long long idx = base + e / N;
      ds[e] = idx < total ? __bfloat162float(p.dye[idx * N + e % N]) : 0.f;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < K * N; o += blockDim.x) {
      const int kk = o / N, co = o % N;
      float s = 0.f;
      for (int pp = 0; pp < kDensePix; ++pp)
        s = fmaf(as[pp * K + kk], ds[pp * N + co], s);
      acc[o] += s;
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < K * N; o += blockDim.x)
    atomicAdd(&p.dw[o], acc[o]);
}

// blockDim.x and the grid stride are multiples of cin: a thread keeps one
// channel for its whole loop
__global__ void __launch_bounds__(kThreads) down_depthwise_dw_kernel(
    const DownBwdParams p) {
  extern __shared__ float sm[];  // (9, cin)
  for (int i = threadIdx.x; i < 9 * p.cin; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int c = (int)(start % p.cin);
  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.f;
  const long long total = (long long)p.n * p.ho * p.wo * p.cin;
  for (long long idx = start; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long pix = idx / p.cin;
    const int ox = (int)(pix % p.wo);
    const long long t = pix / p.wo;
    const int oy = (int)(t % p.ho);
    const int b = (int)(t / p.ho);
    const float g = __bfloat162float(p.dye[idx]);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int iy = 2 * oy - 1 + tap / 3;
      const int ix = 2 * ox - 1 + tap % 3;
      if (iy < 0 || iy >= p.h || ix < 0 || ix >= p.w) continue;
      acc[tap] = fmaf(
          load_act(p.x, p.scale, p.shift, p.act,
                   ((size_t)(b * p.h + iy) * p.w + ix) * p.cin + c, c),
          g, acc[tap]);
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) atomicAdd(&sm[k * p.cin + c], acc[k]);
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * p.cin; i += blockDim.x)
    atomicAdd(&p.dw[i], sm[i]);
}

__global__ void __launch_bounds__(kThreads) down_depthwise_dx_kernel(
    const DownBwdParams p) {
  extern __shared__ float sm[];  // (2, cin) dscale / dshift block sums
  for (int i = threadIdx.x; i < 2 * p.cin; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int c = (int)(start % p.cin);
  float wc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wc[k] = __bfloat162float(p.wt[k * p.cin + c]);
  float dsc = 0.f, dsh = 0.f;
  const long long total = (long long)p.n * p.h * p.w * p.cin;
  for (long long idx = start; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long pix = idx / p.cin;
    const int sx = (int)(pix % p.w);
    const long long t = pix / p.w;
    const int sy = (int)(t % p.h);
    const int b = (int)(t / p.h);
    float g = 0.f;
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) {
      const int ny = sy + 1 - ty;   // = 2*oy for the output row it feeds
      if (ny < 0 || (ny & 1)) continue;
      const int oy = ny >> 1;
      if (oy >= p.ho) continue;
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        const int nx = sx + 1 - tx;
        if (nx < 0 || (nx & 1)) continue;
        const int ox = nx >> 1;
        if (ox >= p.wo) continue;
        g = fmaf(__bfloat162float(
                     p.dye[((size_t)(b * p.ho + oy) * p.wo + ox) * p.cin + c]),
                 wc[ty * 3 + tx], g);
      }
    }
    if (p.act != kNone) {
      const float xi = __bfloat162float(p.x[idx]);
      const float s = p.scale[c];
      const float v = __fadd_rn(__fmul_rn(xi, s), p.shift[c]);
      const float gm = g * act_grad(v, p.act);
      g = gm * s;
      dsc += gm * xi;
      dsh += gm;
    }
    p.dx[idx] = __float2bfloat16_rn(g);
  }
  if (p.act != kNone) {
    atomicAdd(&sm[c], dsc);
    atomicAdd(&sm[p.cin + c], dsh);
    __syncthreads();
    for (int i = threadIdx.x; i < p.cin; i += blockDim.x) {
      atomicAdd(&p.dscale[i], sm[i]);
      atomicAdd(&p.dshift[i], sm[p.cin + i]);
    }
  }
}

long long grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

// Host entry (plain C interface, bound with ctypes). x, scale, shift, act,
// wt as for mmr_fused_conv_down; dy, y: (n, ho, wo, cout) bf16; dmom: (2,
// cout) f32 or null; dye: a bf16 buffer like dy (used when dmom != null);
// dbias: zeroed (cout,) f32 or null; dx: (n, h, w, cin) bf16 or null (no
// dx); dscale, dshift: zeroed (cin,) f32 (null without a prologue or dx);
// dw: zeroed f32 like wt. The dense kernel computes no dx, and the
// depthwise kernels need 256 % cin == 0. Returns a cudaError_t.
extern "C" int mmr_fused_conv_down_bwd(
    const void* x, const void* scale, const void* shift, int act,
    const void* wt, const void* dy, const void* y, const void* dmom,
    void* dye, void* dbias, void* dx, void* dscale, void* dshift, void* dw,
    int n, int h, int w, int cin, int cout, int depthwise, void* stream) {
  DownBwdParams p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.act = act;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.dscale = static_cast<float*>(dscale);
  p.dshift = static_cast<float*>(dshift);
  p.dw = static_cast<float*>(dw);
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.ho = (h + 1) / 2;
  p.wo = (w + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_out = (long long)n * p.ho * p.wo;
  cudaError_t e = launch_dy_prep(dy, y, dmom, dye, dbias, n_out * cout, cout, s);
  if (e != cudaSuccess) return (int)e;
  p.dye = static_cast<const __nv_bfloat16*>(dmom ? dye : dy);
  if (!depthwise) {
    if (dx != nullptr) return (int)cudaErrorInvalidValue;
    const int smem = (9 * cin * cout + kDensePix * (9 * cin + cout)) *
                     (int)sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    long long blocks = (n_out + kDensePix - 1) / kDensePix;
    if (blocks > 132 * 4) blocks = 132 * 4;
    down_dense_dw_kernel<<<(int)blocks, kThreads, smem, s>>>(p);
    return (int)cudaGetLastError();
  }
  if (cout != cin || kThreads % cin != 0) return (int)cudaErrorInvalidValue;
  down_depthwise_dw_kernel<<<(int)grid_for(n_out * cin), kThreads,
                             9 * cin * (int)sizeof(float), s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || dx == nullptr) return (int)e;
  down_depthwise_dx_kernel<<<(int)grid_for((long long)n * h * w * cin),
                             kThreads, 2 * cin * (int)sizeof(float), s>>>(p);
  return (int)cudaGetLastError();
}
