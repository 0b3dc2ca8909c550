// K5a / K5b: the segmentation head (3x3 conv + bias) fused with the
// DiceCE loss statistics and the argmax confusion, and its backward.
//
// Replace the TPU kernels `_head_loss_fwd_kernel` (packed_chain.py:2186,
// via `_head_loss_fwd_call` :2458, `pl.pallas_call` at :2491) and
// `_head_loss_bwd_kernel` (:2316, via `_head_loss_bwd_call` :2504,
// `pl.pallas_call` at :2540).
//
// K5a: logits = conv3x3(relu(s*x + t), W) + bias over common.cuh's WMMA
// tile (load_tile, mma_chunk: one 16-wide output fragment, nc <= 16);
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
// synthesized (p = exp(logp), g = ds0 + ds2*onehot, dlogit = p*(g - sum
// p*g) + ds3*(onehot ? expm1(logp) : p), the CE gradient of a confident
// pixel kept by expm1) and never stored. One kernel (head_bwd_kernel, on
// common.cuh's Hopper pieces) synthesizes each tile's d(logits) once, halo
// included, into shared memory as bf16 (the f32 values of the tile's own
// pixels summed for dbias in registers), stages the relu-prologue'd input
// tile beside it, and from those two tiles computes both
//   dx: the 3x3 conv of d(logits) over the flipped, transposed taps (wgmma
//       m64nNk16, M = a 64-pixel row segment, N = the input's 16 or 32
//       channels) with the prologue's backward in the register epilogue
//       (dx = gm*s, dscale += gm*x, dshift += gm, gm = g * relu'(s*x + t));
//   dW: per tap one wgmma m64n16k16 a 16-pixel step, M = the input's
//       channels (rows past them unused), N = the classes, both operands
//       M-/N-major from the staged tiles; in three passes of three taps
//       (24 accumulators a thread instead of 72, so that four blocks fit a
//       SM), each pass's sums added into the block's dW in shared memory.
// Blocks walk over tiles (a grid of up to four blocks a SM) and keep dW,
// dbias (reduced over each tile by warp shuffles) and dscale, dshift (in
// registers) over their tiles; each block writes its sums once, as a row
// of a (blocks, 9*N*16 + 16 + 2N) f32 buffer, and a second small kernel
// adds the rows in a fixed order: no global atomics, so these gradients are
// the same from run to run. d(logits) takes one expm1f a pixel (the
// label's).
//
// Bound on an H100: the head moves 32 bytes of input, 2*nc bytes of log
// probs and 4 bytes of label per pixel for 2*9*16*nc operations (K5b
// twice that): far below the 295 op/byte ridge, so bytes bound both. The
// design reads each input once per tile (halo from L2), keeps the logits
// and their gradient in registers and shared memory, and writes only the
// log-prob surface (K5a) and dx plus the per-block sums (K5b).

#include "common.cuh"

namespace {

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

// ------------------------------------------------------------------ K5b

namespace {

// N: the head input's channels padded to 16 (16 or 32): dx's wgmma N
template <int N>
struct HeadBwdTile {
  static constexpr int kThreads = 128;             // one warpgroup
  static constexpr int kRows = 4;                  // output rows of a tile
  static constexpr int kSlots = kSeg + 2;
  static constexpr int kPix = (kRows + 2) * kSlots;  // halo pixels
  static constexpr int kG = N / 8;                 // the input's 8-ch groups
  // shared memory: the input tile [row][group][slot] (16 B units; dW's A
  // reads 8 groups from each row, the ones past kG run into the next rows
  // and give rows of dW that are not kept), d(logits) [row][half][slot],
  // the dx taps (9, 2, N, 8), the block's dW (9, N, 16) f32, the block
  // sums (dscale, dshift, dbias per warp), d(stats) (n, 4, 16)
  static constexpr int kXBytes = kG * kPix * 16;
  static constexpr int kDBytes = 2 * kPix * 16;
  static constexpr int kBBytes = 9 * 2 * N * 16;
  static constexpr int kDw = 9 * N * 16;
  static constexpr int kRed = 2 * N + 4 * 16;
  static constexpr int kPart = kDw + 16 + 2 * N;   // a block's row of sums
  static constexpr int kXPer = (kG * kPix + kThreads - 1) / kThreads;
  static constexpr int kDPer = (kPix + kThreads - 1) / kThreads;
  static int smem(int n) {
    return kXBytes + kDBytes + kBBytes + (kDw + kRed + n * 64) * 4;
  }
  // dW's A reads reach group 7 of the last halo row: still inside the two
  // tiles
  static_assert((kRows + 1) * kG + 8 <= (kG + 2) * (kRows + 2),
                "dW's A reads stay inside shared memory");
};

struct HeadBwdParams {
  WgParams<__nv_bfloat16> e;  // dx through the prologue: out[0], oh, ow
  const __nv_bfloat16* wt;    // (1, 9, 2, N, 8) flipped, transposed taps
  const __nv_bfloat16* logp;  // (n, height, width, nc)
  const int* labels;          // (n, height, width)
  const float* dstats;        // (n, 4, nc)
  float* part;                // (gridDim.x, kPart)
  int n, height, width, nc;
};

// nc bf16 log-probs of a pixel into 8 words (two classes a word)
__device__ __forceinline__ void load_logp(const __nv_bfloat16* src, int nc,
                                          uint32_t* w) {
  if ((nc & 1) == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (2 * k < nc) w[k] = reinterpret_cast<const uint32_t*>(src)[k];
  } else {
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(w);
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < nc) e[k] = src[k];
  }
}

// d(logits) of one pixel from its bf16 log-probs, its label and its
// sample's d(stats) ds (4, 16), in f32 as ops/head_loss.py::dlogits_ref
// forms it: p = exp(logp), g = ds0 + ds2*onehot, p*(g - sum p*g) +
// ds3*(onehot ? expm1(logp) : p); zero past nc
__device__ __forceinline__ void dlogits16(const uint32_t* lw, int lab,
                                          const float* ds, int nc,
                                          float* v) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(lw);
  float pr[16];
  float inner = 0.f, lpl = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float lp = __bfloat162float(e[k]);
    pr[k] = k < nc ? expf(lp) : 0.f;
    if (k == lab) lpl = lp;
    v[k] = ds[k] + (k == lab ? ds[32 + k] : 0.f);
    inner += pr[k] * v[k];
  }
  const float em = expm1f(lpl);   // the label's only
#pragma unroll
  for (int k = 0; k < 16; ++k)
    v[k] = k < nc ? pr[k] * (v[k] - inner) + ds[48 + k] * (k == lab ? em : pr[k])
                  : 0.f;
}

template <int N>
__global__ void __launch_bounds__(128, 4) head_bwd_kernel(const HeadBwdParams p) {
  using G = HeadBwdTile<N>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xt = smem;
  unsigned char* dt = xt + G::kXBytes;
  unsigned char* wb = dt + G::kDBytes;
  float* dws = reinterpret_cast<float*>(wb + G::kBBytes);
  float* red = dws + G::kDw;
  float* dsm = red + G::kRed;
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const uint32_t sx = smem_addr(xt), sd = smem_addr(dt), sb = smem_addr(wb);
  for (int i = tid; i < 9 * 2 * N; i += G::kThreads)
    reinterpret_cast<uint4*>(wb)[i] = reinterpret_cast<const uint4*>(p.wt)[i];
  for (int i = tid; i < p.n * 64; i += G::kThreads)
    dsm[i] = (i & 15) < p.nc ? p.dstats[(i >> 4) * p.nc + (i & 15)] : 0.f;
  for (int i = tid; i < G::kDw + G::kRed; i += G::kThreads) dws[i] = 0.f;
  fence_proxy_async();  // the taps, read by the tensor cores

  const Input& in = p.e.in[0];
  const int xg = tid % G::kG;     // this thread's channel group of x
  const bool xvec =
      in.c % 8 == 0 && reinterpret_cast<uintptr_t>(in.x) % 16 == 0;
  const int tiles_x = (p.width + kSeg - 1) / kSeg;
  const int tiles_y = (p.height + G::kRows - 1) / G::kRows;
  const int total = p.n * tiles_y * tiles_x;
  float s1[N / 8][2], s2[N / 8][2];
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
    s1[nb][0] = s1[nb][1] = s2[nb][0] = s2[nb][1] = 0.f;

  for (int tt = blockIdx.x; tt < total; tt += gridDim.x) {
    const int b = tt / (tiles_y * tiles_x);
    const int rt = tt - b * (tiles_y * tiles_x);
    const int oy0 = (rt / tiles_x) * G::kRows;
    const int ox0 = (rt % tiles_x) * kSeg;
    __syncthreads();  // the previous tile's products (and the setup) done

    // the input tile: every unit's load first, then the relu prologue
    {
      uint4 raw[G::kXPer];
      unsigned live = 0;
#pragma unroll
      for (int q = 0; q < G::kXPer; ++q) {
        const int pix = (tid + q * G::kThreads) / G::kG;
        const int yy = oy0 - 1 + pix / G::kSlots;
        const int xx = ox0 - 1 + pix % G::kSlots;
        raw[q] = make_uint4(0, 0, 0, 0);
        if (pix < G::kPix && yy >= 0 && yy < p.height && xx >= 0 &&
            xx < p.width && 8 * xg < in.c) {
          live |= 1u << q;
          raw[q] = fetch8(in, b, p.height, p.width, yy, xx, 8 * xg, xvec);
        }
      }
      float sc[8], sh[8];
      prologue_vec8(in, 8 * xg, sc, sh);
#pragma unroll
      for (int q = 0; q < G::kXPer; ++q) {
        const int pix = (tid + q * G::kThreads) / G::kG;
        if (pix >= G::kPix) continue;
        if (live >> q & 1u)
          prologue8(reinterpret_cast<__nv_bfloat16*>(&raw[q]), sc, sh,
                    in.act);
        const int row = pix / G::kSlots, slot = pix % G::kSlots;
        *reinterpret_cast<uint4*>(
            xt + ((row * G::kG + xg) * G::kSlots + slot) * 16) = raw[q];
      }
    }
    // d(logits) of the halo pixels (loads first), rounded to bf16 where the
    // tile is staged; the f32 values of the tile's own pixels summed for
    // dbias, over the warp by shuffles, then once a warp and class
    {
      uint32_t lw[G::kDPer][8];
      int lab[G::kDPer];
      unsigned dlive = 0;
#pragma unroll
      for (int q = 0; q < G::kDPer; ++q) {
        const int pix = tid + q * G::kThreads;
        const int yy = oy0 - 1 + pix / G::kSlots;
        const int xx = ox0 - 1 + pix % G::kSlots;
        lab[q] = -1;
#pragma unroll
        for (int k = 0; k < 8; ++k) lw[q][k] = 0u;
        if (pix < G::kPix && yy >= 0 && yy < p.height && xx >= 0 &&
            xx < p.width) {
          dlive |= 1u << q;
          const size_t at = ((size_t)b * p.height + yy) * p.width + xx;
          lab[q] = p.labels[at];
          load_logp(p.logp + at * p.nc, p.nc, lw[q]);
        }
      }
      const float* ds = dsm + b * 64;
      float bsum[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) bsum[k] = 0.f;
#pragma unroll
      for (int q = 0; q < G::kDPer; ++q) {
        const int pix = tid + q * G::kThreads;
        if (pix >= G::kPix) continue;
        const int row = pix / G::kSlots, slot = pix % G::kSlots;
        float v[16];
        if (dlive >> q & 1u) {
          dlogits16(lw[q], lab[q], ds, p.nc, v);
          if (row >= 1 && row <= G::kRows && slot >= 1 && slot <= kSeg) {
#pragma unroll
            for (int k = 0; k < 16; ++k) bsum[k] += v[k];
          }
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) v[k] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __align__(16) __nv_bfloat16 o[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(v[8 * h + k]);
          *reinterpret_cast<uint4*>(
              dt + ((row * 2 + h) * G::kSlots + slot) * 16) =
              *reinterpret_cast<const uint4*>(o);
        }
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float v = warp_sum(bsum[k]);
        if (l == 0) red[2 * N + 16 * w + k] += v;
      }
    }
    fence_proxy_async();  // stores the tensor cores will read
    __syncthreads();

    // dx: row r, tap t reads the d(logits) tile at halo row r + t/3, from
    // slot t%3 (K = the classes: halves kSlots units apart). dW in three
    // passes, one a row of taps (ky): a 16-pixel step of output row rr has
    // B = its d(logits) (N-major: the class halves kSlots units apart), A
    // of tap (ky, kx) = the input at halo row rr + ky from slot px + kx
    // (M-major: channel groups kSlots units apart); each pass's sums are
    // added into the block's dW in shared memory by the threads holding
    // its real rows (channels < N: warps 0 .. N/16 - 1)
    float accx[G::kRows][N / 2];
#pragma unroll
    for (int r = 0; r < G::kRows; ++r)
#pragma unroll
      for (int k = 0; k < N / 2; ++k) accx[r][k] = 0.f;
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
      float accw[3][8];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int k = 0; k < 8; ++k) accw[kx][k] = 0.f;
      wgmma_fence();
      if (ky == 0) {
#pragma unroll
        for (int r = 0; r < G::kRows; ++r)
#pragma unroll
          for (int t = 0; t < 9; ++t)
            Wgmma<N>::template mma<0, 0>(
                accx[r],
                gmma_desc(sd + ((r + t / 3) * 2 * G::kSlots + t % 3) * 16,
                          G::kSlots * 16, 128),
                gmma_desc(sb + t * 2 * N * 16, N * 16, 128));
      }
#pragma unroll
      for (int rr = 0; rr < G::kRows; ++rr)
#pragma unroll
        for (int px = 0; px < kSeg; px += 16) {
          const uint64_t db = gmma_desc(
              sd + (((rr + 1) * 2) * G::kSlots + px + 1) * 16, 128,
              G::kSlots * 16);
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            Wgmma<16>::template mma<1, 1>(
                accw[kx],
                gmma_desc(sx + ((rr + ky) * G::kG * G::kSlots + px + kx) * 16,
                          128, G::kSlots * 16),
                db);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) fence_regs<8>(accw[kx]);
      if (w < N / 16) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int ci = 16 * w + (l >> 2) + 8 * ((k >> 1) & 1);
            const int co = 8 * (k >> 2) + 2 * (l & 3) + (k & 1);
            dws[((ky * 3 + kx) * N + ci) * 16 + co] += accw[kx][k];
          }
      }
      if (ky == 0) {
#pragma unroll
        for (int r = 0; r < G::kRows; ++r) fence_regs<N / 2>(accx[r]);
        wg_epilogue<N, G::kRows>(p.e, accx, oy0, ox0, b, 0, s1, s2);
      }
    }
  }

  // the block's row of sums: dW (from shared memory), dbias (the warps'
  // sums), dscale and dshift
  wg_colsums<N>(s1, s2, red);
  __syncthreads();
  float* part = p.part + (size_t)blockIdx.x * G::kPart;
  for (int i = tid; i < G::kDw; i += G::kThreads) part[i] = dws[i];
  float* tail = part + G::kDw;
  if (tid < 16)
    tail[tid] = red[2 * N + tid] + red[2 * N + 16 + tid] +
                red[2 * N + 32 + tid] + red[2 * N + 48 + tid];
  if (tid < 2 * N) tail[16 + tid] = red[tid];
}

// the rows of the blocks' sums added in block order, into dW (3, 3, cin,
// nc) HWIO, dbias (nc,), dscale and dshift (cin,)
__global__ void __launch_bounds__(128) head_bwd_reduce_kernel(
    const float* part, int blocks, int len, int np, int cin, int nc,
    float* dw, float* dbias, float* dscale, float* dshift) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float s = 0.f;
  for (int i = 0; i < blocks; ++i) s += part[(size_t)i * len + e];
  const int nw = 9 * np * 16;
  if (e < nw) {
    const int t = e / (np * 16), ci = (e / 16) % np, co = e % 16;
    if (ci < cin && co < nc) dw[((size_t)t * cin + ci) * nc + co] = s;
  } else if (e < nw + 16) {
    if (e - nw < nc) dbias[e - nw] = s;
  } else {
    const int i = e - nw - 16;
    if (i < cin) dscale[i] = s;
    else if (i >= np && i - np < cin) dshift[i - np] = s;
  }
}

template <int N>
cudaError_t launch_head_bwd(HeadBwdParams& p, int max_blocks, float* dw,
                            float* dbias, float* dscale, float* dshift,
                            int cin, cudaStream_t s) {
  using G = HeadBwdTile<N>;
  const int smem = G::smem(p.n);
  int per_sm = blocks_per_sm(head_bwd_kernel<N>, G::kThreads, smem);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int total = p.n * ((p.height + G::kRows - 1) / G::kRows) *
                    ((p.width + kSeg - 1) / kSeg);
  int blocks = per_sm * sms < max_blocks ? per_sm * sms : max_blocks;
  if (blocks > total) blocks = total;
  head_bwd_kernel<N><<<blocks, G::kThreads, smem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  head_bwd_reduce_kernel<<<(G::kPart + 127) / 128, 128, 0, s>>>(
      p.part, blocks, G::kPart, N, cin, p.nc, dw, dbias, dscale, dshift);
  return cudaGetLastError();
}

}  // namespace

// K5b host entry. x, scale, shift, act, cin as for K5a (cin <= ntile);
// wt_t: (1, 9, 2, ntile, 8) bf16, the flipped, transposed taps over the
// classes (padded to 16) and cin padded to ntile (16 or 32); logp, labels
// as K5a wrote/read them; dstats: (n, 4, nc) f32; part: f32 scratch of
// max_blocks rows of 9*ntile*16 + 16 + 2*ntile; outputs dx (n, h, w, cin)
// bf16, dw (3, 3, cin, nc), dbias (nc,), dscale, dshift (cin,) f32, all
// written whole. Returns a cudaError_t.
extern "C" int mmr_head_loss_bwd(const void* x, const void* scale,
                                 const void* shift, int act, int cin,
                                 const void* wt_t, int ntile,
                                 const void* logp, const void* labels,
                                 const void* dstats, void* dx, void* part,
                                 int max_blocks, void* dw, void* dscale,
                                 void* dshift, void* dbias, int n,
                                 int height, int width, int nc,
                                 void* stream) {
  if (nc < 1 || nc > 16 || cin < 1 || cin > ntile || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  HeadBwdParams p{};
  p.e.in[0] = Input{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const float*>(scale),
                    static_cast<const float*>(shift), cin, act, 0, 0};
  p.e.n_in = 1;
  p.e.n = n;
  p.e.oh = height;
  p.e.ow = width;
  p.e.out[0] = WgOut<__nv_bfloat16>{
      static_cast<__nv_bfloat16*>(dx), p.e.in[0].x, p.e.in[0].scale,
      p.e.in[0].shift, nullptr, nullptr, cin, act, 0};
  p.e.n_out = 1;
  p.wt = static_cast<const __nv_bfloat16*>(wt_t);
  p.logp = static_cast<const __nv_bfloat16*>(logp);
  p.labels = static_cast<const int*>(labels);
  p.dstats = static_cast<const float*>(dstats);
  p.part = static_cast<float*>(part);
  p.n = n;
  p.height = height;
  p.width = width;
  p.nc = nc;
  auto f = [](void* v) { return static_cast<float*>(v); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ntile) {
    case 16: return (int)launch_head_bwd<16>(p, max_blocks, f(dw), f(dbias),
                                             f(dscale), f(dshift), cin, s);
    case 32: return (int)launch_head_bwd<32>(p, max_blocks, f(dw), f(dbias),
                                             f(dscale), f(dshift), cin, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory in bytes at batch 8 (what = 0) or resident blocks
// per SM at the launch's attributes (what = 1) of head_bwd_kernel at ntile
// 16 or 32 (kind is ignored). Returns -1 otherwise.
extern "C" int mmr_head_loss_bwd_info(int what, int /*kind*/, int ntile) {
  switch (ntile) {
    case 16: return what ? blocks_per_sm(head_bwd_kernel<16>, 128,
                                         HeadBwdTile<16>::smem(8))
                         : HeadBwdTile<16>::smem(8);
    case 32: return what ? blocks_per_sm(head_bwd_kernel<32>, 128,
                                         HeadBwdTile<32>::smem(8))
                         : HeadBwdTile<32>::smem(8);
    default: return -1;
  }
}
