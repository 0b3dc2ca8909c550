// K5a / K5b: the segmentation head (3x3 conv + bias) fused with the
// DiceCE loss statistics and the argmax confusion, and its backward.
//
// Replace the TPU kernels `_head_loss_fwd_kernel` (packed_chain.py:2186,
// via `_head_loss_fwd_call` :2458, `pl.pallas_call` at :2491) and
// `_head_loss_bwd_kernel` (:2316, via `_head_loss_bwd_call` :2504,
// `pl.pallas_call` at :2540).
//
// K5a: logits = conv3x3(relu(s*x + t), W) + bias over K1's tile and
// tensor-core structure (one 16-wide output fragment, nc <= 16 classes);
// then, per pixel in the epilogue, the exact per-pixel max (first index on
// ties: torch's argmax), p = softmax, lse = log sum exp, and
//   stats[b] += [sum p, sum onehot, sum p*onehot, sum onehot*(lse - logit)]
//   conf[argmax][label] += 1          (labelled pixels; with conf != null)
//   logp = min(logit - lse, 0)        (bf16, the backward's residual)
// The NHWC logits never reach device memory: only the bf16 log-prob
// surface does, because K5b re-reads it. Per-block sums in shared memory,
// f32 atomics into stats and conf.
//
// K5b: from logp, the labels and d(stats) (B, 4, nc), d(logits) is
// synthesized while each tile is staged (HeadDy below: p = exp(logp),
// g = ds0 + ds2*onehot, dlogit = p*(g - sum p*g) + ds3*(onehot ? expm1(logp)
// : p), the CE gradient of a confident pixel kept by expm1) and never
// stored; the standard backward kernels of common.cuh then give dW and
// dbias (conv_dw_kernel) and dx, dscale, dshift (conv_dx_kernel with the
// relu prologue's backward).
//
// Bound on an H100: the head moves 32 bytes of input, 2*nc bytes of log
// probs and 4 bytes of label per pixel for 2*9*16*nc operations (K5b
// twice that): far below the 295 op/byte ridge, so bytes bound both. The
// design reads each input once per tile (halo from L2), keeps the logits
// and their gradient in registers and shared memory, and writes only the
// log-prob surface (K5a) and dx (K5b).

#include "common.cuh"

namespace {

struct HeadDy {
  const __nv_bfloat16* logp;  // (n, height, width, c) log-probs
  const int* labels;          // (n, height, width)
  const float* dstats;        // (n, 4, c)
  int c;                      // classes, <= 16

  __device__ void synth(int b, int height, int width, int yy, int xx,
                        float* out) const {
    const size_t pix = ((size_t)b * height + yy) * width + xx;
    const int lab = labels[pix];
    const float* ds = dstats + (size_t)b * 4 * c;
    float pr[16];
    float lp[16];
    float inner = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      out[k] = 0.f;
      if (k < c) {
        lp[k] = __bfloat162float(logp[pix * c + k]);
        pr[k] = expf(lp[k]);
        out[k] = ds[k] + (k == lab ? ds[2 * c + k] : 0.f);
        inner += pr[k] * out[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < c)
        out[k] = pr[k] * (out[k] - inner) +
                 ds[3 * c + k] * (k == lab ? expm1f(lp[k]) : pr[k]);
  }

  __device__ static void put16(__nv_bfloat16* dst, const float* v) {
    __align__(16) __nv_bfloat16 o[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) o[k] = __float2bfloat16_rn(v[k]);
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(o)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(o)[1];
  }

  __device__ void halo_tile(int b, int height, int width, int ty0, int tx0,
                            int /*c0*/, __nv_bfloat16* tile) const {
    for (int i = threadIdx.x; i < kTilePix; i += blockDim.x) {
      const int yy = ty0 - 1 + i / (kTW + 2);
      const int xx = tx0 - 1 + i % (kTW + 2);
      float v[16];
      if (yy >= 0 && yy < height && xx >= 0 && xx < width) {
        synth(b, height, width, yy, xx, v);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = 0.f;
      }
      put16(tile + i * kKC, v);
    }
  }

  __device__ void core_tile(int b, int height, int width, int ty0, int tx0,
                            int /*n0*/, int /*kn*/, __nv_bfloat16* dyt,
                            int ld, float* bsum) const {
    for (int i = threadIdx.x; i < kTH * kTW; i += blockDim.x) {
      const int yy = ty0 + i / kTW;
      const int xx = tx0 + i % kTW;
      float v[16];
      const bool inside = yy < height && xx < width;
      if (inside) {
        synth(b, height, width, yy, xx, v);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = 0.f;
      }
      put16(dyt + i * ld, v);
      if (bsum != nullptr && inside) {
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < c) atomicAdd(&bsum[k], v[k]);
      }
    }
  }
};

struct HeadFwdParams {
  Input in;                 // x with its (relu) prologue
  const __nv_bfloat16* wt;  // (chunks, 9, kKC, 16), zero-padded
  const float* bias;        // (nc,)
  const int* labels;        // (n, height, width)
  __nv_bfloat16* logp;      // (n, height, width, nc)
  float* stats;             // (n, 4, nc), zeroed
  float* conf;              // (nc, nc), zeroed, or null
  int n, height, width, nc;
};

constexpr int kHeadNS = 16 + 8;
constexpr int kHeadSmem = kTilePix * kKC * 2 + 9 * kKC * kHeadNS * 2 +
                          kTH * 256 * 4 + (4 * 16 + 16 * 16) * 4;

__global__ void __launch_bounds__(kThreads) head_loss_fwd_kernel(
    const HeadFwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = tile + kTilePix * kKC;
  float* stage = reinterpret_cast<float*>(wsm + 9 * kKC * kHeadNS);
  float* bst = stage + kTH * 256;  // (4, 16) block stats
  float* bconf = bst + 4 * 16;     // (16, 16) block confusion

  const int tiles_x = (p.width + kTW - 1) / kTW;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 4 * 16 + 16 * 16; i += blockDim.x)
    bst[i] = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[1];
  wmma::fill_fragment(acc[0], 0.f);
  const int nch = (p.in.c + kKC - 1) / kKC;
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();
    load_tile(p.in, b, p.height, p.width, ty0, tx0, ch * kKC, tile);
    load_weights(p.wt + (size_t)ch * 9 * kKC * 16, 16, 0, 16, wsm, kHeadNS);
    __syncthreads();
    mma_chunk<1>(tile, wsm, kHeadNS, warp, acc);
  }

  float* st = stage + warp * 256;
  wmma::store_matrix_sync(st, acc[0], 16, wmma::mem_row_major);
  __syncwarp();
  const int oy = ty0 + warp;
  const int ox = tx0 + lane;
  if (lane < 16 && oy < p.height && ox < p.width) {
    const int nc = p.nc;
    float v[16];
    float m = -INFINITY;
    int am = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < nc) {
        v[k] = st[lane * 16 + k] + p.bias[k];
        if (v[k] > m) {  // strict: the first maximal class wins a tie
          m = v[k];
          am = k;
        }
      }
    }
    float z[16];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < nc) {
        z[k] = expf(v[k] - m);
        sum += z[k];
      }
    const float lse = logf(sum) + m;
    const size_t pix = ((size_t)b * p.height + oy) * p.width + ox;
    const int lab = p.labels[pix];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < nc) {
        const float pr = z[k] / sum;
        atomicAdd(&bst[k], pr);
        if (k == lab) {
          atomicAdd(&bst[16 + k], 1.f);
          atomicAdd(&bst[32 + k], pr);
          atomicAdd(&bst[48 + k], lse - v[k]);
        }
        p.logp[pix * nc + k] = __float2bfloat16_rn(fminf(v[k] - lse, 0.f));
      }
    }
    if (p.conf != nullptr && lab >= 0 && lab < nc)
      atomicAdd(&bconf[am * 16 + lab], 1.f);
  }
  __syncthreads();
  const int nc = p.nc;
  for (int i = threadIdx.x; i < 4 * nc; i += blockDim.x)
    atomicAdd(&p.stats[((size_t)b * 4 + i / nc) * nc + i % nc],
              bst[(i / nc) * 16 + i % nc]);
  if (p.conf != nullptr)
    for (int i = threadIdx.x; i < nc * nc; i += blockDim.x)
      atomicAdd(&p.conf[i], bconf[(i / nc) * 16 + i % nc]);
}

}  // namespace

// K5a host entry (plain C interface, bound with ctypes). x: (n, h, w, cin)
// bf16 with its prologue (scale, shift, act); wt: (cin chunks, 9, 16, 16)
// bf16; bias: (nc,) f32; labels: (n, h, w) int32; outputs logp (n, h, w,
// nc) bf16, zeroed stats (n, 4, nc) and conf (nc, nc) f32 (conf may be
// null). nc <= 16. Returns a cudaError_t.
extern "C" int mmr_head_loss_fwd(const void* x, const void* scale,
                                 const void* shift, int act, int cin,
                                 const void* wt, const void* bias,
                                 const void* labels, void* logp, void* stats,
                                 void* conf, int n, int height, int width,
                                 int nc, void* stream) {
  if (nc < 1 || nc > 16) return (int)cudaErrorInvalidValue;
  HeadFwdParams p{};
  p.in = Input{static_cast<const __nv_bfloat16*>(x),
               static_cast<const float*>(scale),
               static_cast<const float*>(shift), cin, act, 0, 0};
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.bias = static_cast<const float*>(bias);
  p.labels = static_cast<const int*>(labels);
  p.logp = static_cast<__nv_bfloat16*>(logp);
  p.stats = static_cast<float*>(stats);
  p.conf = static_cast<float*>(conf);
  p.n = n;
  p.height = height;
  p.width = width;
  p.nc = nc;
  cudaError_t e = cudaFuncSetAttribute(
      head_loss_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kHeadSmem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((width + kTW - 1) / kTW) * ((height + kTH - 1) / kTH);
  head_loss_fwd_kernel<<<dim3(tiles, n), kThreads, kHeadSmem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// K5b host entry. x, scale, shift, act, cin as for K5a; wt_t: (1, 9, 16,
// np) bf16 flipped, transposed taps (np = cin padded to a multiple of
// 16*nf); logp, labels as K5a wrote/read them; dstats: (n, 4, nc) f32;
// outputs dx (n, h, w, cin) bf16, zeroed f32 dscale, dshift (cin,), dw
// (cin chunks, 9, 16, 16) and dbias (16,). Returns a cudaError_t.
extern "C" int mmr_head_loss_bwd(const void* x, const void* scale,
                                 const void* shift, int act, int cin,
                                 const void* wt_t, int nf, int np,
                                 const void* logp, const void* labels,
                                 const void* dstats, void* dx, void* dscale,
                                 void* dshift, void* dw, void* dbias, int n,
                                 int height, int width, int nc,
                                 void* stream) {
  if (nc < 1 || nc > 16 || np % (16 * nf) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HeadDy src{static_cast<const __nv_bfloat16*>(logp),
                   static_cast<const int*>(labels),
                   static_cast<const float*>(dstats), nc};
  DwParams q{};
  q.in[0] = Input{static_cast<const __nv_bfloat16*>(x),
                  static_cast<const float*>(scale),
                  static_cast<const float*>(shift), cin, act, 0, 0};
  q.n_in = 1;
  q.dw = static_cast<float*>(dw);
  q.dbias = static_cast<float*>(dbias);
  q.n = n;
  q.height = height;
  q.width = width;
  q.np = 16;
  cudaError_t e = launch_dw<1>(q, src, (cin + kKC - 1) / kKC, s);
  if (e != cudaSuccess) return (int)e;
  DxParams d{};
  d.x = q.in[0];
  d.wt = static_cast<const __nv_bfloat16*>(wt_t);
  d.dx = static_cast<__nv_bfloat16*>(dx);
  d.dscale = static_cast<float*>(dscale);
  d.dshift = static_cast<float*>(dshift);
  d.n = n;
  d.height = height;
  d.width = width;
  d.np = np;
  return (int)launch_dx_nf(nf, d, src, s);
}
