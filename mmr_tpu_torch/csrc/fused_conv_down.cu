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
// accumulation and y stored raw in bf16. With part != null each block also
// writes its row of sums, Sum y and Sum y^2 over its tile from the f32
// values (bias included) before the rounding, and down_rows_reduce_kernel
// adds the rows in block order into the (2, cout) moments: no atomics, the
// same result on every run. The TPU kernel's phase split, Toeplitz taps and
// diagonal-expanded depthwise weights are layout artefacts, not carried
// over.
//
// A persistent grid (as many blocks as fit the card, each walking tiles
// blockIdx.x, + gridDim.x, ...) over tiles of 4 output rows
// (down_tile.cuh): a tile's 9 source rows with their halo come into shared
// memory by 16-byte cp.async, one tile ahead (two raw buffers), the
// prologue is applied once per staged value, and the products run from
// shared memory:
// - dense (the mbv3 stem, 3 -> 16; cin <= 16, cout <= 32), 64 output
//   columns: the (pixels x 9*cin, padded to 16) patch matrix times the
//   (9*cin x cout) weights as mma.sync m16n8k16, a warp per 16 output
//   pixels; the A fragments are gathered from the staged tile through a
//   table of the patch columns' offsets, the B fragments come packed by the
//   wrapper (`_stem_frags`). f32 products of bf16 values are exact, so only
//   the order of the sums differs from the plain version.
// - depthwise (b0_0 at C = 16, b1_0 at C = 72; C a multiple of 8 up to
//   96), 32 output columns (16 at stride 2 above 64 channels, so that two
//   raw tiles and the act tile fit a block): CUDA-core FMAs, a thread per
//   (output pixel, 8 channels), 16-byte loads and stores. Where c / 8 does
//   not divide 256 (C = 72, 88) the block's first 256 rounded down to a
//   multiple of c / 8 threads take the pixels, each of one channel group,
//   and its moments are added in thread order (ordered_unit_sums); at C in
//   {8, 16, 32, 64} the walk and the sums are bit for bit the old ones.
// - the same depthwise tile at stride 1 (kStride = 1: each output row reads
//   one source row, a tile 6 x 34 source pixels) is the depthwise mode of
//   K1 (`fused_conv(..., depthwise=True)`), the mbv3 b1_1 block's 3x3 at C
//   = 88. It replaces JAX's `fused_conv` call with the taps expanded
//   diagonally into a dense (88 x 88) kernel (packed_encoder.py:258-266, the
//   `pl.pallas_call` at packed_chain.py:1070): the dense mainloop would do
//   88x the MACs, so the true per-channel conv runs here instead.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): 2*9*cin*cout operations
// per output pixel against 2*(cin*4 + cout) bytes per output pixel read
// and written, far below the 295 op/byte ridge: bytes bound it, 0.011 ms
// for the stem and 0.008 ms for b0_0 at B = 8 (0.019 ms in training; 0.047
// ms for a 20-window serving batch). The depthwise conv does 2*9 operations
// per output value against 2 bytes read (stride 1) or 8 (stride 2) and 2
// written: bytes bound it too (b1_0 at B = 8, 512x640: x 23.6 MB, y 5.9
// MB, 0.0088 ms; b1_1: 7.2 + 7.2 MB, 0.0043 ms). The design reads each
// source byte from device memory once (a tile's halo rows come again
// through L2: 1/8 more at stride 2, 2/4 at stride 1), writes y once, and
// keeps the prologue's output and the moments out of device memory.

#include "down_tile.cuh"

namespace {

struct DownParams {
  const __nv_bfloat16* x;   // (n, h, w, cin), 16-byte aligned
  const float* scale;       // (cin,) or null when act == kNone
  const float* shift;
  int act;
  const __nv_bfloat16* wt;  // dense: the B fragments (ks, nt, 32, 4);
                            // depthwise: (9, cin)
  const float* bias;        // (cout,) or null
  __nv_bfloat16* y;         // (n, ho, wo, cout)
  float* part;              // (gridDim.x, 2 * cout) or null
  long long x_end;          // byte address one past x
  int n, h, w, cin, cout, ho, wo, ks, nt, tiles_y, tiles_x, tiles;
};

struct StemSmem {
  using S = SrcTile<kDenseTW>;
  // two raw tiles, act tile, prologue vectors (2, 16), patch-column
  // offsets (16 * 9), warp moments (8, 2, 32)
  __host__ __device__ static int act_off(int cin) {
    return 2 * S::raw_bytes(cin);
  }
  __host__ __device__ static int pro_off(int cin) {
    return act_off(cin) + S::act_bytes(cin);
  }
  __host__ __device__ static int koff_off(int cin) {
    return pro_off(cin) + 128;
  }
  __host__ __device__ static int red_off(int cin) {
    return koff_off(cin) + 16 * 9 * 4;
  }
  __host__ __device__ static int bytes(int cin) {
    return red_off(cin) + 8 * 2 * 32 * 4;
  }
};

// channels co (and co + 1 when two) of one pixel; a paired store when
// cout is even (then co, even, is 4-byte aligned)
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float v0,
                                           float v1, bool two, bool even) {
  if (two && even) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  dst[0] = __float2bfloat16_rn(v0);
  if (two) dst[1] = __float2bfloat16_rn(v1);
}

__global__ void __launch_bounds__(kDownThreads) down_stem_kernel(
    const DownParams p) {
  using S = SrcTile<kDenseTW>;
  using M = StemSmem;
  extern __shared__ __align__(16) char down_smem[];
  char* smem = down_smem;
  __nv_bfloat16* act =
      reinterpret_cast<__nv_bfloat16*>(smem + M::act_off(p.cin));
  float* pro = reinterpret_cast<float*>(smem + M::pro_off(p.cin));
  int* koff = reinterpret_cast<int*>(smem + M::koff_off(p.cin));
  float* red = reinterpret_cast<float*>(smem + M::red_off(p.cin));
  const int rb = S::raw_bytes(p.cin);
  int tile = blockIdx.x;
  stage_src<kDenseTW>(p.x, p.x_end,
                      down_tile(tile, p.tiles_y, p.tiles_x, kDenseTW), p.h,
                      p.w, p.cin, smem);
  cp_async_commit();
  const int as = S::act_stride(p.cin);
  // patch column k = tap * cin + ci -> its offset from a pixel's window
  for (int i = threadIdx.x; i < 16 * p.ks; i += kDownThreads) {
    const int tap = i / p.cin, ci = i - tap * p.cin;
    koff[i] = i < 9 * p.cin ? (tap / 3) * as + (tap % 3) * p.cin + ci : -1;
  }
  if (p.act != kNone && threadIdx.x < p.cin) {
    pro[threadIdx.x] = p.scale[threadIdx.x];
    pro[16 + threadIdx.x] = p.shift[threadIdx.x];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const uint2* wf = reinterpret_cast<const uint2*>(p.wt);
  float s1[4][2] = {}, s2[4][2] = {};
  constexpr int kSegs = kDenseTW / 16;
  // tiles blockIdx.x, + gridDim.x, ...: the next tile's source rows are
  // copied into the other raw buffer while this one is computed
  for (int n = 0; tile < p.tiles; tile += gridDim.x, ++n) {
    const DownTile t = down_tile(tile, p.tiles_y, p.tiles_x, kDenseTW);
    if (tile + gridDim.x < p.tiles)
      stage_src<kDenseTW>(
          p.x, p.x_end,
          down_tile(tile + gridDim.x, p.tiles_y, p.tiles_x, kDenseTW), p.h,
          p.w, p.cin, smem + ((n + 1) & 1) * rb);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    activate_src<kDenseTW>(p.x, t, p.h, p.w, p.cin, smem + (n & 1) * rb, act,
                           pro, pro + 16, p.act);
    __syncthreads();
    for (int mt = warp; mt < kDownTH * kSegs; mt += 8) {
      const int oyl = mt / kSegs, ox0 = (mt - oyl * kSegs) * 16;
      // windows of pixels g and g + 8 (+8 output columns = +16 source ones)
      const int pa = 2 * oyl * as + 2 * (ox0 + g) * p.cin;
      const int pb = pa + 16 * p.cin;
      float acc[4][4] = {};
      for (int ks = 0; ks < p.ks; ++ks) {
        const int* ko = koff + ks * 16 + 2 * q;
        const int o0 = ko[0], o1 = ko[1], o2 = ko[8], o3 = ko[9];
        uint32_t a[4];
        a[0] = pack_bf16(tap_at(act, pa, o0), tap_at(act, pa, o1));
        a[1] = pack_bf16(tap_at(act, pb, o0), tap_at(act, pb, o1));
        a[2] = pack_bf16(tap_at(act, pa, o2), tap_at(act, pa, o3));
        a[3] = pack_bf16(tap_at(act, pb, o2), tap_at(act, pb, o3));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= p.nt) break;
          const uint2 b = wf[(ks * p.nt + nt) * 32 + lane];
          mma16816(acc[nt], a, b.x, b.y);
        }
      }
      const int oy = t.r0 + oyl, oxa = t.c0 + ox0 + g;
      const bool va = oy < p.ho && oxa < p.wo, vb = oy < p.ho && oxa + 8 < p.wo;
      __nv_bfloat16* ya =
          p.y + ((size_t)(t.b * p.ho + oy) * p.wo + oxa) * p.cout;
      __nv_bfloat16* yb = ya + 8 * p.cout;
      const bool even = (p.cout & 1) == 0;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = nt * 8 + 2 * q;
        if (nt >= p.nt || co >= p.cout) continue;
        const bool two = co + 1 < p.cout;
        const float b0 = p.bias ? p.bias[co] : 0.f;
        const float b1 = p.bias && two ? p.bias[co + 1] : 0.f;
        const float v0 = acc[nt][0] + b0, v1 = acc[nt][1] + b1;
        const float v2 = acc[nt][2] + b0, v3 = acc[nt][3] + b1;
        if (va) {
          store_pair(ya + co, v0, v1, two, even);
          s1[nt][0] += v0;
          s2[nt][0] += v0 * v0;
          if (two) {
            s1[nt][1] += v1;
            s2[nt][1] += v1 * v1;
          }
        }
        if (vb) {
          store_pair(yb + co, v2, v3, two, even);
          s1[nt][0] += v2;
          s2[nt][0] += v2 * v2;
          if (two) {
            s1[nt][1] += v3;
            s2[nt][1] += v3 * v3;
          }
        }
      }
    }
  }
  if (p.part == nullptr) return;
  // the warp's sums over its 8 row groups g, then the warps in order
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[nt][e] += __shfl_xor_sync(kFull, s1[nt][e], off);
        s2[nt][e] += __shfl_xor_sync(kFull, s2[nt][e], off);
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(warp * 2) * 32 + nt * 8 + 2 * q + e] = s1[nt][e];
        red[(warp * 2 + 1) * 32 + nt * 8 + 2 * q + e] = s2[nt][e];
      }
  }
  __syncthreads();
  float* row = p.part + (size_t)blockIdx.x * 2 * p.cout;
  for (int j = threadIdx.x; j < 2 * p.cout; j += kDownThreads) {
    const int stat = j / p.cout, c = j - stat * p.cout;
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[(w * 2 + stat) * 32 + c];
    row[j] = s;
  }
}

template <int TW, int kStride>
struct DwSmem {
  using S = SrcTile<TW, kStride>;
  // two raw tiles, act tile, weights (9, c) and prologue vectors (2, c)
  // f32, the block's reduction: warp moments (8, 2, 64) or, where
  // dw_warp_sums(c) is false, ordered_unit_sums' (kDownThreads, 8)
  __host__ __device__ static int act_off(int c) { return 2 * S::raw_bytes(c); }
  __host__ __device__ static int w_off(int c) {
    return act_off(c) + S::act_bytes(c);
  }
  __host__ __device__ static int pro_off(int c) { return w_off(c) + 9 * c * 4; }
  __host__ __device__ static int red_off(int c) {
    return pro_off(c) + 2 * c * 4;
  }
  __host__ __device__ static int bytes(int c) {
    return red_off(c) + (dw_warp_sums(c) ? 8 * 2 * 64 : 8 * kDownThreads) * 4;
  }
};

// c = cin = cout, a multiple of 8 up to kDwMaxC; tiles of TW output
// columns at stride kStride (2: K2; 1: K1's depthwise mode). A thread takes
// 8 channels: group threadIdx.x % (c / 8) of the first kDownThreads
// rounded down to a multiple of c / 8 threads (all 256 where c / 8 divides
// 256: the old widths' walk), so its moments are of one group.
template <int TW, int kStride>
__global__ void __launch_bounds__(kDownThreads) down_dw_fwd_kernel(
    const DownParams p) {
  using S = SrcTile<TW, kStride>;
  using M = DwSmem<TW, kStride>;
  extern __shared__ __align__(16) char down_smem[];
  char* smem = down_smem;
  const int c = p.cin;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + M::act_off(c));
  float* wsm = reinterpret_cast<float*>(smem + M::w_off(c));
  float* pro = reinterpret_cast<float*>(smem + M::pro_off(c));
  float* red = reinterpret_cast<float*>(smem + M::red_off(c));
  const int rb = S::raw_bytes(c);
  int tile = blockIdx.x;
  stage_src<TW, kStride>(p.x, p.x_end,
                         down_tile(tile, p.tiles_y, p.tiles_x, TW), p.h, p.w,
                         c, smem);
  cp_async_commit();
  for (int i = threadIdx.x; i < 9 * c; i += kDownThreads)
    wsm[i] = __bfloat162float(p.wt[i]);
  if (p.act != kNone && threadIdx.x < c) {
    pro[threadIdx.x] = p.scale[threadIdx.x];
    pro[c + threadIdx.x] = p.shift[threadIdx.x];
  }
  const int groups = c / 8, grp = threadIdx.x % groups, c0 = grp * 8;
  const int active = kDownThreads / groups * groups;
  const int as = S::act_stride(c);
  float s1[8] = {}, s2[8] = {}, bv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) bv[k] = p.bias ? p.bias[c0 + k] : 0.f;
  for (int n = 0; tile < p.tiles; tile += gridDim.x, ++n) {
    const DownTile t = down_tile(tile, p.tiles_y, p.tiles_x, TW);
    if (tile + gridDim.x < p.tiles)
      stage_src<TW, kStride>(
          p.x, p.x_end, down_tile(tile + gridDim.x, p.tiles_y, p.tiles_x, TW),
          p.h, p.w, c, smem + ((n + 1) & 1) * rb);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    activate_src<TW, kStride>(p.x, t, p.h, p.w, c, smem + (n & 1) * rb, act,
                              pro, pro + c, p.act);
    __syncthreads();
    for (int it = threadIdx.x; threadIdx.x < active && it < kDownTH * TW * groups;
         it += active) {
      const int px = it / groups, oyl = px / TW, oxl = px - oyl * TW;
      float acc[8] = {};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        float v[8];
        load8(act + (kStride * oyl + tap / 3) * as +
                  (kStride * oxl + tap % 3) * c + c0, v);
        const float* wr = wsm + tap * c + c0;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(v[k], wr[k], acc[k]);
      }
      const int oy = t.r0 + oyl, ox = t.c0 + oxl;
      if (oy >= p.ho || ox >= p.wo) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc[k] += bv[k];
        s1[k] += acc[k];
        s2[k] += acc[k] * acc[k];
      }
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(acc[k]);
      *reinterpret_cast<uint4*>(
          p.y + ((size_t)(t.b * p.ho + oy) * p.wo + ox) * c + c0) =
          *reinterpret_cast<const uint4*>(o);
    }
  }
  if (p.part == nullptr) return;
  float* row = p.part + (size_t)blockIdx.x * 2 * c;
  if (!dw_warp_sums(c)) {
    // the threads of a group in order (threads past `active` hold zeros
    // and are not read)
    ordered_unit_sums(s1, 8, groups, red, row);
    ordered_unit_sums(s2, 8, groups, red, row + c);
    return;
  }
  // lanes of one channel group: lane mod groups; then the warps in order
#pragma unroll
  for (int k = 0; k < 8; ++k)
    for (int off = groups; off < 32; off <<= 1) {
      s1[k] += __shfl_xor_sync(kFull, s1[k], off);
      s2[k] += __shfl_xor_sync(kFull, s2[k], off);
    }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < groups) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red[(warp * 2) * 64 + c0 + k] = s1[k];
      red[(warp * 2 + 1) * 64 + c0 + k] = s2[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * c; j += kDownThreads) {
    const int stat = j / c, ch = j - stat * c;
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[(w * 2 + stat) * 64 + ch];
    row[j] = s;
  }
}

using DownKernel = void (*)(const DownParams);

// the kernel of a launch, its dynamic shared memory and its tiles' output
// columns; false outside the kernels' channels and strides (stride 1:
// depthwise only)
bool down_fwd_kernel(int cin, int cout, int depthwise, int stride,
                     DownKernel* k, int* smem, int* tw) {
  if (!down_channels_ok(cin, cout, depthwise) || (stride != 1 && stride != 2) ||
      (stride == 1 && !depthwise))
    return false;
  *tw = down_tile_cols(depthwise, cin, stride);
  if (!depthwise) {
    *k = &down_stem_kernel;
    *smem = StemSmem::bytes(cin);
  } else if (stride == 1) {
    *k = &down_dw_fwd_kernel<kDwTW, 1>;
    *smem = DwSmem<kDwTW, 1>::bytes(cin);
  } else if (*tw == kDwTW) {
    *k = &down_dw_fwd_kernel<kDwTW, 2>;
    *smem = DwSmem<kDwTW, 2>::bytes(cin);
  } else {
    *k = &down_dw_fwd_kernel<kDwWideTW, 2>;
    *smem = DwSmem<kDwWideTW, 2>::bytes(cin);
  }
  return true;
}

}  // namespace

// Host entry (plain C interface, bound with ctypes). x: (n, h, w, cin) bf16,
// 16-byte aligned; scale, shift: (cin,) f32 or null (act 0); wt: dense, the
// B fragments of `_stem_frags` (ks = ceil(9 cin / 16), nt = ceil(cout / 8),
// 32, 4) bf16 (cin <= 16, cout <= 32); depthwise, (9, cin) bf16 (cout ==
// cin, a multiple of 8 up to 96); bias: (cout,) f32 or null; stride: 2, or
// 1 for a depthwise conv (K1's depthwise mode); y: (n, ceil(h / stride),
// ceil(w / stride), cout) bf16; part: f32 scratch of part_rows rows of
// 2 * cout (one a tile is always enough) and mom the (2, cout) moments, or
// both null. One launch of a persistent grid (mmr_fused_conv_down_grid),
// then the moments' reduction. Returns a cudaError_t.
extern "C" int mmr_fused_conv_down(const void* x, const void* scale,
                                   const void* shift, int act, const void* wt,
                                   const void* bias, void* y, void* part,
                                   void* mom, int part_rows, int n, int h,
                                   int w, int cin, int cout, int depthwise,
                                   int stride, void* stream) {
  DownParams p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.act = act;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.part = static_cast<float*>(part);
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.ks = (9 * cin + 15) / 16;
  p.nt = (cout + 7) / 8;
  p.x_end = (long long)reinterpret_cast<uintptr_t>(x) +
            (long long)n * h * w * cin * 2;
  DownKernel kernel;
  int smem = 0, tw = 0;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || n < 1 || h < 1 || w < 1 ||
      !down_fwd_kernel(cin, cout, depthwise, stride, &kernel, &smem, &tw))
    return (int)cudaErrorInvalidValue;
  p.ho = (h + stride - 1) / stride;
  p.wo = (w + stride - 1) / stride;
  const DownTiles tl = down_tiles(n, h, w, tw, stride);
  p.tiles_y = tl.y;
  p.tiles_x = tl.x;
  p.tiles = tl.all;
  DownGrid g{};
  cudaError_t e = down_grid(kernel, smem, p.tiles, &g);
  if (e != cudaSuccess) return (int)e;
  if (part != nullptr && part_rows < g.blocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<g.blocks, kDownThreads, smem, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess || part == nullptr) return (int)e;
  return (int)launch_rows_reduce(p.part, g.blocks, 2 * cout,
                                 static_cast<float*>(mom), s);
}

// The grid mmr_fused_conv_down launches at these arguments: out[0..4) =
// {blocks, blocks a SM, SMs, dynamic shared memory}; it sets the kernel's
// launch attributes as the launch does. Returns a cudaError_t.
extern "C" int mmr_fused_conv_down_grid(int n, int h, int w, int cin,
                                        int cout, int depthwise, int stride,
                                        void* out) {
  DownKernel kernel;
  int smem = 0, tw = 0;
  if (n < 1 || h < 1 || w < 1 ||
      !down_fwd_kernel(cin, cout, depthwise, stride, &kernel, &smem, &tw))
    return (int)cudaErrorInvalidValue;
  return report_grid(kernel, smem, down_tiles(n, h, w, tw, stride).all,
                     static_cast<int*>(out));
}

// Dynamic shared memory in bytes (what = 0) or resident blocks per SM at
// the launch's attributes (what = 1) of the dense kernel at c -> 16
// channels (kind 0), the depthwise one at c channels, stride 2 (kind 1) or
// stride 1 (kind 2). Returns -1 otherwise.
extern "C" int mmr_fused_conv_down_info(int what, int kind, int c) {
  DownKernel kernel;
  int smem = 0, tw = 0;
  int g[4];
  if (kind < 0 || kind > 2 ||
      !down_fwd_kernel(c, kind ? c : 16, kind != 0, kind == 2 ? 1 : 2,
                       &kernel, &smem, &tw))
    return -1;
  if (!what) return smem;
  return report_grid(kernel, smem, 1 << 30, g) == 0 ? g[1] : -1;
}
