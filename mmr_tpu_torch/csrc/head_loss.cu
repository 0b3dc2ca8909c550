// K5a / K5b: the segmentation head (3x3 conv + bias) fused with the
// DiceCE loss statistics and the argmax confusion, and its backward.
//
// Replace the TPU kernels `_head_loss_fwd_kernel` (packed_chain.py:2186,
// via `_head_loss_fwd_call` :2458, `pl.pallas_call` at :2491) and
// `_head_loss_bwd_kernel` (:2316, via `_head_loss_bwd_call` :2504,
// `pl.pallas_call` at :2540).
//
// K5a: logits = conv3x3(act(s*x + t), W) + bias on narrow_tile.cuh's tile
// (narrow_head_kernel: nc <= 16 classes padded to 16, two mma.sync n
// fragments; any cin, in 32-channel chunks above 16), then, per pixel from
// the accumulator fragments, the exact per-pixel max (first index on ties:
// torch's argmax), p = softmax, lse = log sum exp, and
//   stats[b] += [sum p, sum onehot, sum p*onehot, sum onehot*(lse - logit)]
//   conf[argmax][label] += 1          (labelled pixels; with with_conf)
//   logp = min(logit - lse, 0)        (bf16, the backward's residual)
// The NHWC logits never reach device memory: only the bf16 log-prob
// surface does, because K5b re-reads it. The prologue act(s*x + t) runs
// once on each staged tile, in place in shared memory, on the pixels
// inside the image (the halo outside stays zero: the SAME padding of the
// activated input). A pixel's classes lie across the four lanes of a quad:
// its max, argmax and sum of exponentials come by quad shuffles; each lane
// keeps its classes' sums over the tile, reduced over the pixel lanes by
// shuffles and over the warps in order into the block's (n, 4, 16) row in
// shared memory; the confusion counts are integers (shared atomics, one
// per distinct key of a warp). Each block writes its row once and
// head_rows_reduce_kernel adds the rows in a fixed order: no float atomics
// and no zero fills, so a second launch gives the same bits. The labels
// are read in the type they come in (uint8, int32, int64), each by one
// lane of its quad, while the tile's products run.
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
// probs and 1-8 bytes of label per pixel for 2*9*16*nc operations (K5b
// twice that): far below the 295 op/byte ridge, so bytes bound both. The
// design reads each input once per tile (halo from L2; K5a's tiles are 12
// rows tall, the next ones in flight by TMA while a tile's products and
// epilogue run), keeps the logits and their gradient in registers and
// shared memory, and writes only the log-prob surface (K5a, by 16-byte
// stores) and dx plus the per-block sums (K5b).

#include "narrow_tile.cuh"

namespace {

template <class L>
struct HeadFwdParams {
  const __nv_bfloat16* x;      // the raw input (n, height, width, cin)
  const float* scale;          // its prologue (cin,)
  const float* shift;
  int act;
  const __nv_bfloat16* taps;   // (k16, 9, 32 lanes, 2, 4) B fragments
  const float* bias;           // (nc,)
  const L* labels;             // (n, height, width)
  __nv_bfloat16* logp;         // (n, height, width, nc)
  float* part;                 // (gridDim.x, len): the blocks' rows
  int with_conf, len;
  int cin, nc, n, height, width;
  int chunks, tiles_x, tiles_y, tiles;
  int tma, mode;               // x by TMA, else its DwStage
};

// K5a's side of the narrow tile: the prologue on each staged tile, the
// per-pixel statistics from the accumulator fragments
template <int G8, class L>
struct HeadEpi {
  using C = NarrowCfg<G8, 2>;
  static constexpr bool kPrologue = true;
  const HeadFwdParams<L>& p;
  unsigned char* taps;    // (k16, 9, 32, 2, 4) B fragments
  float* sc;              // (cpad,) prologue scale, 1 beyond cin
  float* sh;              // (cpad,) shift, 0 beyond cin
  float* bias;            // (16,), -inf beyond nc
  __nv_bfloat16* run;     // this warp's 16 x nc log-probs
  float* red;             // (8 warps, 4, 16) a tile's sums
  int* conf;              // (16, 16) the block's confusion
  float* row;             // (n, 4, 16) the block's statistics
  // the labels of the warp's 2 kMT pixels a lane: lane 4g + q loads those
  // of pixels 4k + q (pixel 2i + h: m-tile i's g + 8h), -1 outside
  static constexpr int kLab = (2 * C::kMT + 3) / 4;
  long long lab_raw[kLab];

  __device__ __forceinline__ void setup() {
    const int tid = threadIdx.x, cpad = p.chunks * 8 * G8;
    const int tbytes = p.chunks * C::kK16 * 9 * 32 * 16;
    for (int i = tid; i < tbytes / 16; i += kNarrowThreads)
      reinterpret_cast<uint4*>(taps)[i] =
          reinterpret_cast<const uint4*>(p.taps)[i];
    for (int i = tid; i < 16; i += kNarrowThreads)
      bias[i] = i < p.nc ? p.bias[i] : -INFINITY;
    for (int i = tid; i < cpad; i += kNarrowThreads) {
      sc[i] = i < p.cin ? p.scale[i] : 1.f;
      sh[i] = i < p.cin ? p.shift[i] : 0.f;
    }
    for (int i = tid; i < 256; i += kNarrowThreads) conf[i] = 0;
    for (int i = tid; i < p.n * 64; i += kNarrowThreads) row[i] = 0.f;
  }

  // act(s*x + t) in place on the staged pixels inside the image (channels
  // c0 ..); the halo outside it stays zero, the padding of the activated
  // input
  __device__ __forceinline__ void prologue(unsigned char* slot, int c0,
                                           int ty0, int tx0) {
    for (int i = threadIdx.x; i < G8 * C::kHalo; i += kNarrowThreads) {
      const int grp = i / C::kHalo, u = i - grp * C::kHalo;
      const int yy = ty0 - 1 + u / C::kSlots, xx = tx0 - 1 + u % C::kSlots;
      if (yy < 0 || yy >= p.height || xx < 0 || xx >= p.width) continue;
      uint4* at = reinterpret_cast<uint4*>(slot + 16 * (grp * C::kGS + u));
      uint4 v = *at;
      float s8[8], t8[8];
      const float4* s4 = reinterpret_cast<const float4*>(sc + c0 + 8 * grp);
      const float4* t4 = reinterpret_cast<const float4*>(sh + c0 + 8 * grp);
      *reinterpret_cast<float4*>(s8) = s4[0];
      *reinterpret_cast<float4*>(s8 + 4) = s4[1];
      *reinterpret_cast<float4*>(t8) = t4[0];
      *reinterpret_cast<float4*>(t8 + 4) = t4[1];
      prologue8(reinterpret_cast<__nv_bfloat16*>(&v), s8, t8, p.act);
      *at = v;
    }
  }

  // the tile's labels, loaded while its products run
  __device__ __forceinline__ void fetch(int b, int ty0, int tx0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int px = tx0 + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int k = 0; k < kLab; ++k) {
      const int idx = 4 * k + (lane & 3), i = idx >> 1;
      const int oy = ty0 + (warp >> 2) * C::kMT + i, ox = px + 8 * (idx & 1);
      lab_raw[k] = i < C::kMT && oy < p.height && ox < p.width
                   ? (long long)p.labels[(size_t)(b * p.height + oy) *
                                             p.width + ox]
                   : -1;
    }
  }

  // Lane 4g + q holds classes 2q, 2q + 1, 8 + 2q, 9 + 2q (j = 0..3) of
  // pixels g and g + 8 of each m-tile: a pixel's max, first argmax and sum
  // of exponentials come from the quad by shuffles; each lane keeps its
  // classes' sums over the tile, added over the pixel lanes by shuffles,
  // then over the warps in order into the block's row of the sample.
  template <int MT>
  __device__ __forceinline__ void tile(float (&acc)[MT][2][4], int b, int ty0,
                                       int tx0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int px0 = tx0 + 16 * (warp & 3);
    const int nc = p.nc;
    int cls[4], lk[kLab];
    bool on[4];
    float bj[4], s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cls[j] = 8 * (j >> 1) + 2 * q + (j & 1);
      on[j] = cls[j] < nc;
      bj[j] = bias[cls[j]];   // -inf past nc: no max, no exponent
#pragma unroll
      for (int t = 0; t < 4; ++t) s[t][j] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kLab; ++k)
      lk[k] = lab_raw[k] >= 0 && lab_raw[k] < nc ? (int)lab_raw[k] : -1;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int oy = ty0 + (warp >> 2) * MT + i;
      int npix = p.width - px0 < 16 ? p.width - px0 : 16;
      if (oy >= p.height) npix = 0;
      if (npix <= 0) continue;   // the warp's run lies outside the image
      const size_t pix0 = (size_t)(b * p.height + oy) * p.width + px0;
      int key = -1;   // lane q < 2 of the quad: pixel g + 8q's confusion entry
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = g + 8 * h;
        const bool valid = pix < npix;
        const int idx = 2 * i + h;   // its label: lane 4g + idx % 4's
        const int lab =
            __shfl_sync(kFull, lk[idx >> 2], (lane & ~3) | (idx & 3));
        float v[4], m = -INFINITY;
        int am = 16;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[i][j >> 1][2 * h + (j & 1)] + bj[j];
          if (v[j] > m) {   // classes ascend with j: first max
            m = v[j];
            am = cls[j];
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float om = __shfl_xor_sync(kFull, m, off);
          const int oa = __shfl_xor_sync(kFull, am, off);
          if (om > m || (om == m && oa < am)) {
            m = om;
            am = oa;
          }
        }
        // fast exponent, logarithm and reciprocal (a few ulp; the
        // statistics' bound is 2e-2)
        float z[4], sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          z[j] = __expf(v[j] - m);
          sum += z[j];
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        const float lse = __logf(sum) + m, inv = __fdividef(1.f, sum);
        // classes (2q, 2q + 1) and (8 + 2q, 9 + 2q): one bf16 pair each
#pragma unroll
        for (int j = 0; j < 4; j += 2)
          if (on[j])
            store2(run + pix * nc + cls[j], fminf(v[j] - lse, 0.f),
                   fminf(v[j + 1] - lse, 0.f), on[j + 1], nc % 2 == 0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!on[j] || !valid) continue;
          const float pr = z[j] * inv;
          s[0][j] += pr;
          if (cls[j] == lab) {
            s[1][j] += 1.f;
            s[2][j] += pr;
            s[3][j] += lse - v[j];
          }
        }
        if (q == h && lab >= 0) key = am * 16 + lab;
      }
      if (p.with_conf) {   // one count a distinct key of the warp
        const unsigned peers = __match_any_sync(kFull, key);
        if (key >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&conf[key], __popc(peers));
      }
      __syncwarp();
      warp_store_run(p.logp + pix0 * nc, run, npix * nc, lane);
      __syncwarp();
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = s[t][j];
        v += __shfl_xor_sync(kFull, v, 4);
        v += __shfl_xor_sync(kFull, v, 8);
        v += __shfl_xor_sync(kFull, v, 16);
        if (lane < 4) red[(warp * 4 + t) * 16 + cls[j]] = v;
      }
    __syncthreads();
    if (threadIdx.x < 64) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) t += red[w * 64 + threadIdx.x];
      row[b * 64 + threadIdx.x] += t;
    }
  }
};

// shared memory of the head kernel at `chunks` chunks and batch n
template <int G8>
int head_smem(int chunks, int n) {
  using C = NarrowCfg<G8, 2>;
  return C::kRing + chunks * C::kK16 * 9 * 32 * 16 + 16 * 4 +
         2 * chunks * 8 * G8 * 4 + 8 * 256 * 2 + 8 * 64 * 4 + 256 * 4 +
         n * 64 * 4;
}

template <int G8, class L>
__global__ void __launch_bounds__(kNarrowThreads, 2)
    narrow_head_kernel(const __grid_constant__ HeadFwdParams<L> p,
                       const __grid_constant__ CUtensorMap tx) {
  using C = NarrowCfg<G8, 2>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int tbytes = p.chunks * C::kK16 * 9 * 32 * 16;
  const int cpad = p.chunks * 8 * G8;
  unsigned char* taps = smem + C::kRing;
  float* bias = reinterpret_cast<float*>(taps + tbytes);
  float* sc = bias + 16;
  float* sh = sc + cpad;
  __nv_bfloat16* run = reinterpret_cast<__nv_bfloat16*>(sh + cpad);
  float* red = reinterpret_cast<float*>(run + 8 * 256);
  int* conf = reinterpret_cast<int*>(red + 8 * 64);
  float* row = reinterpret_cast<float*>(conf + 256);
  HeadEpi<G8, L> e{p, taps, sc, sh, bias, run + (tid >> 5) * 256, red, conf,
                   row, {}};
  narrow_walk<G8, 2, __nv_bfloat16>(p, tx, smem, taps, e);
  __syncthreads();   // the last tile's sums are in the row
  float* out = p.part + (size_t)blockIdx.x * p.len;
  for (int i = tid; i < p.n * 64; i += kNarrowThreads) out[i] = row[i];
  int* oc = reinterpret_cast<int*>(out + p.n * 64);
  for (int i = tid; i < 256; i += kNarrowThreads) oc[i] = conf[i];
}

// stats (n, 4, nc) and conf (nc, nc) from the blocks' rows (len = n * 64 +
// 256: the (n, 4, 16) f32 sums, then the (16, 16) int32 counts): column j
// of each row added over the rows in a fixed order (P = blockDim.x / 32
// row phases, each in row order, then the phases in order); the counts
// are integers, exact in any order. conf is zero without with_conf.
__global__ void __launch_bounds__(1024) head_rows_reduce_kernel(
    const float* __restrict__ part, int rows, int n, int nc, int with_conf,
    float* __restrict__ stats, float* __restrict__ conf) {
  __shared__ float fs[32][33];
  __shared__ int is[32][33];
  const int lane = threadIdx.x & 31, ph = threadIdx.x >> 5;
  const int phases = blockDim.x >> 5;
  const int len = n * 64 + 256;
  const int j = blockIdx.x * 32 + lane;
  const bool counts = j >= n * 64;
  float f = 0.f;
  int c = 0;
  if (j < len) {
    for (int i = ph; i < rows; i += phases) {
      if (counts) c += reinterpret_cast<const int*>(part)[(size_t)i * len + j];
      else f += part[(size_t)i * len + j];
    }
  }
  fs[ph][lane] = f;
  is[ph][lane] = c;
  __syncthreads();
  if (ph != 0 || j >= len) return;
  for (int k = 1; k < phases; ++k) {
    f += fs[k][lane];
    c += is[k][lane];
  }
  if (!counts) {
    if (j % 16 < nc) stats[(j / 16) * nc + j % 16] = f;
  } else {
    const int a = (j - n * 64) / 16, l = (j - n * 64) % 16;
    if (a < nc && l < nc) conf[a * nc + l] = with_conf ? (float)c : 0.f;
  }
}

template <class L>
using HeadKernel = void (*)(HeadFwdParams<L>, CUtensorMap);

// the head kernel at cin (16-channel stages up to 16, else 32-channel
// chunks); fills the chunks and tiles of p, *smem and *rows
template <class L>
HeadKernel<L> head_kernel_for(HeadFwdParams<L>* p, int* smem, int* rows) {
  const bool narrow = p->cin <= 16;
  p->chunks = narrow ? 1 : (p->cin + 31) / 32;
  *rows = narrow ? NarrowCfg<2, 2>::kRows : NarrowCfg<4, 2>::kRows;
  *smem = narrow ? head_smem<2>(p->chunks, p->n) : head_smem<4>(p->chunks, p->n);
  p->tiles_y = (p->height + *rows - 1) / *rows;
  p->tiles_x = (p->width + kNarrowCols - 1) / kNarrowCols;
  p->tiles = p->n * p->tiles_y * p->tiles_x;
  p->len = p->n * 64 + 256;
  return narrow ? narrow_head_kernel<2, L> : narrow_head_kernel<4, L>;
}

template <class L>
cudaError_t head_grid(HeadFwdParams<L>* p, HeadKernel<L>* k, NarrowGrid* g) {
  if (p->cin < 1 || p->nc < 1 || p->nc > 16 || p->n < 1 || p->height < 1 ||
      p->width < 1)
    return cudaErrorInvalidValue;
  int smem = 0, rows = 0;
  *k = head_kernel_for(p, &smem, &rows);
  return narrow_grid(*k, smem, p->tiles, rows, g);
}

// the rows' reduction: about 16 rows a thread, 1 to 32 phases
inline int head_reduce_phases(int rows) {
  int ph = 1;
  while (ph < 32 && rows > 16 * ph) ph *= 2;
  return ph;
}

template <class L>
cudaError_t head_fwd(HeadFwdParams<L>& p, int part_rows, float* stats,
                     float* conf, cudaStream_t s) {
  HeadKernel<L> k;
  NarrowGrid g{};
  cudaError_t e = head_grid(&p, &k, &g);
  if (e != cudaSuccess) return e;
  if (part_rows < g.blocks) return cudaErrorInvalidValue;
  p.mode = dw_stage_mode<__nv_bfloat16>(p.x, p.cin);
  CUtensorMap tx{};
  p.tma = nhwc_map(&tx, p.x, p.n, p.height, p.width, p.cin, kNarrowCols + 2,
                   g.rows + 2);
  k<<<g.blocks, kNarrowThreads, g.smem, s>>>(p, tx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  head_rows_reduce_kernel<<<(p.len + 31) / 32,
                            32 * head_reduce_phases(g.blocks), 0, s>>>(
      p.part, g.blocks, p.n, p.nc, p.with_conf, stats, conf);
  return cudaGetLastError();
}

template <class L>
cudaError_t head_grid_at(int n, int height, int width, int cin, int nc,
                         NarrowGrid* g) {
  HeadFwdParams<L> p{};
  p.cin = cin, p.nc = nc, p.n = n, p.height = height, p.width = width;
  HeadKernel<L> k;
  return head_grid(&p, &k, g);
}

enum LabelKind { kU8 = 0, kI32 = 1, kI64 = 2 };

template <class L>
HeadFwdParams<L> head_params(const void* x, const void* scale,
                             const void* shift, int act, int cin,
                             const void* taps, const void* bias,
                             const void* labels, void* logp, void* part,
                             int with_conf, int n, int height, int width,
                             int nc) {
  HeadFwdParams<L> p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.act = act;
  p.taps = static_cast<const __nv_bfloat16*>(taps);
  p.bias = static_cast<const float*>(bias);
  p.labels = static_cast<const L*>(labels);
  p.logp = static_cast<__nv_bfloat16*>(logp);
  p.part = static_cast<float*>(part);
  p.with_conf = with_conf;
  p.cin = cin;
  p.nc = nc;
  p.n = n;
  p.height = height;
  p.width = width;
  return p;
}

}  // namespace

// K5a host entry (plain C interface, bound with ctypes). x: (n, h, w, cin)
// bf16 with its prologue (scale, shift (cin,) f32, act); taps: (k16, 9, 32,
// 2, 4) bf16, the mma.sync B fragments over the classes padded to 16
// (ops/fused_conv.py::_narrow_frags) with k16 = 1 at cin <= 16, else 2 a
// 32-channel chunk; bias: (nc,) f32; labels: (n, h, w) of kind 0 = uint8,
// 1 = int32, 2 = int64 (ids outside [0, nc) count in no onehot and no
// confusion entry); part: f32 scratch of part_rows rows of n * 64 + 256
// (at least the blocks mmr_head_loss_fwd_grid reports); outputs logp (n,
// h, w, nc) bf16, stats (n, 4, nc) and conf (nc, nc) f32, written whole
// (conf zero without with_conf). nc <= 16. Two launches: the persistent
// grid, then the rows' reduction. Returns a cudaError_t.
extern "C" int mmr_head_loss_fwd(const void* x, const void* scale,
                                 const void* shift, int act, int cin,
                                 const void* taps, const void* bias,
                                 const void* labels, int label_kind,
                                 void* logp, void* part, int part_rows,
                                 void* stats, void* conf, int with_conf,
                                 int n, int height, int width, int nc,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  float* cf = static_cast<float*>(conf);
#define MMR_HEAD_ARGS                                                     \
  x, scale, shift, act, cin, taps, bias, labels, logp, part, with_conf, n, \
      height, width, nc
  switch (label_kind) {
    case kU8: {
      auto p = head_params<uint8_t>(MMR_HEAD_ARGS);
      return (int)head_fwd(p, part_rows, st, cf, s);
    }
    case kI32: {
      auto p = head_params<int32_t>(MMR_HEAD_ARGS);
      return (int)head_fwd(p, part_rows, st, cf, s);
    }
    case kI64: {
      auto p = head_params<int64_t>(MMR_HEAD_ARGS);
      return (int)head_fwd(p, part_rows, st, cf, s);
    }
    default: return (int)cudaErrorInvalidValue;
  }
#undef MMR_HEAD_ARGS
}

// The grid mmr_head_loss_fwd launches at these arguments (label_kind as
// there): out[0..6) = {blocks (the scratch rows it needs), blocks a SM,
// SMs, dynamic shared memory, pixel tiles, tile rows}; it sets the
// kernel's launch attributes as the launch does. Returns a cudaError_t.
extern "C" int mmr_head_loss_fwd_grid(int n, int height, int width, int cin,
                                      int nc, int label_kind, void* out) {
  NarrowGrid g{};
  cudaError_t e;
  switch (label_kind) {
    case kU8: e = head_grid_at<uint8_t>(n, height, width, cin, nc, &g); break;
    case kI32: e = head_grid_at<int32_t>(n, height, width, cin, nc, &g); break;
    case kI64: e = head_grid_at<int64_t>(n, height, width, cin, nc, &g); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  put_grid(g, out);
  return 0;
}

// Dynamic shared memory in bytes at batch 8 (what = 0) or resident blocks
// per SM at the launch's attributes (what = 1) of narrow_head_kernel with
// int64 labels at cin 16 (kind 0) or 32 (kind 1; ntile is ignored).
// Returns -1 otherwise.
extern "C" int mmr_head_loss_fwd_info(int what, int kind, int /*ntile*/) {
  if (kind < 0 || kind > 1) return -1;
  HeadFwdParams<int64_t> p{};
  p.cin = kind ? 32 : 16, p.n = 8, p.height = 64, p.width = 64;
  int smem = 0, rows = 0, dev = 0, per_sm = -1;
  const HeadKernel<int64_t> k = head_kernel_for(&p, &smem, &rows);
  if (!what) return smem;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      hopper_attrs(k, smem) != cudaSuccess ||
      resident_per_sm(k, kNarrowThreads, smem, dev, &per_sm) != cudaSuccess)
    return -1;
  return per_sm;
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
