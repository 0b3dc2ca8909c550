// K4: the backward of K2 (fused 3x3 stride-2 pad-(1,1) conv).
//
// Replaces the TPU kernel `_down_bwd_kernel` (packed_chain.py:1577)
// reached through `_down_bwd_call` (packed_chain.py:1800, the
// `pl.pallas_call` at :1877).
//
// Given the forward's raw bf16 input x with its pending prologue, the
// weights, the stored output y, dy and the moments cotangent dmom, computes
//   dye   = dy + dm0 + 2*y*dm1 (f32, rounded to bf16)   dbias = sum dye (f32)
//   dW[tap][ci][co] = sum_o a(2o - 1 + tap)[ci] * dye(o)[co]     (f32)
//   dx (optional) = prologue_bwd(the stride-2 transposed conv of dye)
//   dscale, dshift = sums of gm*x and gm, gm = g * act'(s*x + t)
// with a the bf16 prologue'd input as the forward read it. The TPU
// kernel's diagonal-expanded depthwise taps and phase pairs are layout
// artefacts and are not carried over.
//
// One launch of a persistent grid (as many blocks as fit the card, each
// walking tiles blockIdx.x, + gridDim.x, ...) over tiles of 4 output rows
// (down_tile.cuh), then down_rows_reduce_kernel. A block copies the next
// tile's source rows by 16-byte cp.async into its second raw buffer while
// it works on the current tile; per tile it forms dye from dy and y as it
// stages them (the dbias sums from the same values; no dye buffer in
// device memory), applies the prologue once per staged value, and
// computes from shared memory:
// - dense (the mbv3 stem, 3 -> 16; cin <= 16, cout <= 32), 64 output
//   columns: dW as the (9*cin x pixels) x (pixels x cout) product on
//   mma.sync m16n8k16, A gathered from the staged tile through a table of
//   patch-column offsets, B from dye staged transposed; each warp keeps
//   its accumulators over all its tiles. With dx (kDx): a thread per
//   source pixel gathers the <= 4 taps whose stride-2 window covers it
//   (dye row/col parity; the tile's dye carries one halo row and column),
//   then the prologue backward.
// - depthwise (b0_0 at C = 16, b1_0 at C = 72; C a multiple of 8 up to
//   96), 32 output columns (16 at stride 2 above 64 channels; at C = 64
//   one raw buffer, copied after the tile: two do not fit): dW from bf16
//   channel pairs, a thread per (channel pair, pixel phase) with 9 x 2
//   register sums; dx a thread per (source pixel, 8 channels), 16-byte
//   loads and stores, the prologue backward on the staged raw x. Where c /
//   8 or c / 2 does not divide 256 (C = 72, 88) the first 256 rounded down
//   to a multiple of it threads do that work and the sums are added in
//   thread order (ordered_unit_sums, a tap at a time for dW).
// - the same depthwise tile at stride 1 (kStride = 1; the dye tile has a
//   halo row and column on each side, every source pixel takes its 9 taps)
//   is K3's depthwise mode, the backward of the mbv3 b1_1 block's 3x3 at C
//   = 88, replacing JAX's K3 over diagonal-expanded taps
//   (packed_encoder.py:258-266; `_bwd_call`, packed_chain.py:1207). Its dW
//   is the diagonal that JAX's dense dW reaches the parameter through.
// Each block writes one row of sums (dW, dbias, dscale, dshift: register
// sums, warp shuffles and the warps in order); the rows are added in block
// order. No atomics: every output is the same from run to run.
//
// Bound on an H100 (3.35 TB/s): 2*9*cin*cout (dense) or 2*9 (depthwise)
// operations per output value for dW, as many again for dx, against 2
// bytes per value of dy, y, x and dx: far below the 295 op/byte ridge, so
// bytes bound it: 0.033 ms for the flagship's two launches at B = 8 (the
// stem's dW reads x, dy and y: 57.7 MB; b0_0 reads x, dy, y and writes
// dx: 52.4 MB). The dense dx adds its write: at the stem's shape x 15.7
// MB, dy and y 21.0 MB each, dx 15.7 MB, 73.4 MB or 0.022 ms; at 16 -> 16
// with a prologue on b0_0's input (8, 256, 320, 16) x and dx 21.0 MB each,
// dy and y 5.2 MB each, 52.4 MB or 0.016 ms. b1_0 (C = 72, B = 8, x and
// dx at 128x160) reads x 23.6 MB, dy and y 5.9 MB each and writes dx 23.6
// MB: 59.0 MB or 0.018 ms; b1_1 (C = 88, stride 1, 64x80) x, dy, y and dx
// 7.2 MB each, 28.8 MB or 0.0086 ms. The design moves those bytes
// once (a source tile's halo row through L2) and keeps dye, the
// prologue's output and every partial sum out of device memory except one
// row a block.

#include "down_tile.cuh"

namespace {

struct DownBwdParams {
  const __nv_bfloat16* x;   // (n, h, w, cin), 16-byte aligned
  const float* scale;       // (cin,) or null when act == kNone
  const float* shift;
  int act;
  const __nv_bfloat16* wt;  // dense: (9, cin, cout); depthwise: (9, cin)
  const __nv_bfloat16* dy;  // (n, ho, wo, cout)
  const __nv_bfloat16* y;   // read with dmom
  const float* dmom;        // (2, cout) or null
  __nv_bfloat16* dx;        // (n, h, w, cin) with kDx
  float* part;              // (gridDim.x, len): dW, dbias, dscale, dshift
  long long x_end;          // byte address one past x
  int n, h, w, cin, cout, ho, wo, tiles_y, tiles_x, tiles, len;
};

// v[0 .. V) of channels from src: 8 by one 16-byte load or 1
__device__ __forceinline__ void load_n(const __nv_bfloat16* src, float* v,
                                       bool vec) {
  if (vec) load8(src, v);
  else v[0] = __bfloat162float(src[0]);
}

// the output rows (or columns) whose stride-2 window covers source offset
// s (tile-relative, owned: 0 .. 2*extent - 1) and the taps doing it:
// returns how many (1 for even s, 2 for odd)
__device__ __forceinline__ int covering(int s, int* k, int* o) {
  if (s & 1) {
    k[0] = 0; o[0] = (s + 1) >> 1;
    k[1] = 2; o[1] = (s - 1) >> 1;
    return 2;
  }
  k[0] = 1; o[0] = s >> 1;
  return 1;
}

template <int kDx>
struct StemBwdSmem {
  using S = SrcTile<kDenseTW>;
  static constexpr int kDW = kDenseTW + 2;          // dye row stride (even)
  static constexpr int kDP = (kDownTH + 1) * kDW;   // dye pixels a channel
  // two raw tiles, act tile, dye (32, kDP) bf16 transposed, weights (9, cin,
  // cout) f32 (kDx), prologue vectors (2, 16), patch-column offsets
  // (16 * 9); at the end the block's reductions overlay it all
  __host__ __device__ static int act_off(int cin) {
    return 2 * S::raw_bytes(cin);
  }
  __host__ __device__ static int dye_off(int cin) {
    return act_off(cin) + S::act_bytes(cin);
  }
  __host__ __device__ static int w_off(int cin) {
    return dye_off(cin) + 32 * kDP * 2;
  }
  __host__ __device__ static int pro_off(int cin, int cout) {
    return w_off(cin) + (kDx ? (9 * cin * cout * 4 + 15) & ~15 : 0);
  }
  __host__ __device__ static int koff_off(int cin, int cout) {
    return pro_off(cin, cout) + 128;
  }
  __host__ __device__ static int bytes(int cin, int cout) {
    const int mt = (9 * cin + 15) / 16, wm = mt < 8 ? mt : 8;
    const int red = (8 / wm) * mt * 16 * ((cout + 7) / 8 * 8) * 4;
    const int end = koff_off(cin, cout) + 16 * 9 * 4;
    const int need = red > 8 * kDownThreads * 4 ? red : 8 * kDownThreads * 4;
    return end > need ? end : need;
  }
};

// kC: the dx part's channel capacity (cin <= kC; 1 without dx)
template <int kDx, int kC>
__global__ void __launch_bounds__(kDownThreads, 2) down_stem_bwd_kernel(
    const DownBwdParams p) {
  using S = SrcTile<kDenseTW>;
  using M = StemBwdSmem<kDx>;
  constexpr int kDW = M::kDW, kDP = M::kDP, kSegs = kDenseTW / 16;
  extern __shared__ __align__(16) char down_smem[];
  char* smem = down_smem;
  const int cin = p.cin, cout = p.cout;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + M::act_off(cin));
  __nv_bfloat16* dye = reinterpret_cast<__nv_bfloat16*>(smem + M::dye_off(cin));
  float* wsm = reinterpret_cast<float*>(smem + M::w_off(cin));
  float* pro = reinterpret_cast<float*>(smem + M::pro_off(cin, cout));
  int* koff = reinterpret_cast<int*>(smem + M::koff_off(cin, cout));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int mts = (9 * cin + 15) / 16, nts = (cout + 7) / 8;
  const int as = S::act_stride(cin), rs = S::raw_stride(cin);

  for (int i = tid; i < 16 * mts; i += kDownThreads) {
    const int tap = i / cin, ci = i - tap * cin;
    koff[i] = i < 9 * cin ? (tap / 3) * as + (tap % 3) * cin + ci : -1;
  }
  for (int i = tid; i < (nts * 8 - cout) * kDP; i += kDownThreads)
    dye[cout * kDP + i] = __float2bfloat16_rn(0.f);   // padded channels
  if (kDx)
    for (int i = tid; i < 9 * cin * cout; i += kDownThreads)
      wsm[i] = __bfloat162float(p.wt[i]);
  if (p.act != kNone && tid < cin) {
    pro[tid] = p.scale[tid];
    pro[16 + tid] = p.shift[tid];
  }
  // dye staging: a thread keeps `nv` channels (unit u) over pixel phases
  const bool vec = cout % 8 == 0;
  const int nv = vec ? 8 : 1, units = cout / nv, phases = kDownThreads / units;
  const int u = tid % units, ph = tid / units;
  const bool stager = ph < phases;
  float m0[8], m1[8], db[8] = {};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool on = p.dmom != nullptr && k < nv;
    m0[k] = on ? p.dmom[u * nv + k] : 0.f;
    m1[k] = on ? p.dmom[cout + u * nv + k] : 0.f;
  }
  // dW: warps (wm, wp), m tiles wm, wm + WM of the patch columns, pixel
  // steps wp, wp + WP, ...
  const int wms = mts < 8 ? mts : 8, wps = 8 / wms;
  const int wm = warp % wms, wp = warp / wms;
  const int st0 = warp < wms * wps ? wp : kDownTH * kSegs;
  float acc[2][4][4] = {};
  float dsc[kC] = {}, dsh[kC] = {};
  constexpr int kRowsSt = kDownTH + kDx, kColsSt = kDenseTW + kDx;

  // tiles blockIdx.x, + gridDim.x, ...: the next tile's source rows are
  // copied into the other raw buffer while this one is computed
  const int rb = S::raw_bytes(cin);
  int tile = blockIdx.x;
  stage_src<kDenseTW>(p.x, p.x_end,
                      down_tile(tile, p.tiles_y, p.tiles_x, kDenseTW), p.h,
                      p.w, cin, smem);
  cp_async_commit();
  for (int it = 0; tile < p.tiles; tile += gridDim.x, ++it) {
    const DownTile t = down_tile(tile, p.tiles_y, p.tiles_x, kDenseTW);
    const char* raw = smem + (it & 1) * rb;
    if (tile + gridDim.x < p.tiles)
      stage_src<kDenseTW>(
          p.x, p.x_end,
          down_tile(tile + gridDim.x, p.tiles_y, p.tiles_x, kDenseTW), p.h,
          p.w, cin, smem + ((it + 1) & 1) * rb);
    cp_async_commit();
    for (int pi = ph; stager && pi < kRowsSt * kColsSt; pi += phases) {
      const int oyl = pi / kColsSt, oxl = pi - oyl * kColsSt;
      const int oy = t.r0 + oyl, ox = t.c0 + oxl;
      float gv[8] = {};
      if (oy < p.ho && ox < p.wo) {
        const size_t o =
            ((size_t)(t.b * p.ho + oy) * p.wo + ox) * cout + u * nv;
        load_n(p.dy + o, gv, vec);
        if (p.dmom != nullptr) {
          float yv[8];
          load_n(p.y + o, yv, vec);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            gv[k] = gv[k] + m0[k] + 2.f * yv[k] * m1[k];
        }
        if (oyl < kDownTH && oxl < kDenseTW)
#pragma unroll
          for (int k = 0; k < 8; ++k) db[k] += gv[k];
      }
      for (int k = 0; k < nv; ++k)
        dye[(u * nv + k) * kDP + oyl * kDW + oxl] = __float2bfloat16_rn(gv[k]);
    }
    cp_async_wait<1>();
    __syncthreads();
    activate_src<kDenseTW>(p.x, t, p.h, p.w, cin, raw, act, pro, pro + 16,
                           p.act);
    __syncthreads();

    for (int st = st0; st < kDownTH * kSegs; st += wps) {
      const int oyl = st / kSegs, ox0 = (st - oyl * kSegs) * 16;
      uint32_t b[4][2];
      const __nv_bfloat16* d0 = dye + g * kDP + oyl * kDW + ox0 + 2 * q;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= nts) break;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(d0 + nt * 8 * kDP);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(d0 + nt * 8 * kDP + 8);
      }
      // windows of pixels 2q, 2q + 1, 2q + 8, 2q + 9 of the step
      const int p0 = 2 * oyl * as + 2 * (ox0 + 2 * q) * cin, p1 = p0 + 2 * cin;
      const int p2 = p0 + 16 * cin, p3 = p2 + 2 * cin;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mt = wm + i * wms;
        if (mt >= mts) break;
        const int lo = koff[mt * 16 + g], hi = koff[mt * 16 + g + 8];
        uint32_t a[4];
        a[0] = pack_bf16(tap_at(act, p0, lo), tap_at(act, p1, lo));
        a[1] = pack_bf16(tap_at(act, p0, hi), tap_at(act, p1, hi));
        a[2] = pack_bf16(tap_at(act, p2, lo), tap_at(act, p3, lo));
        a[3] = pack_bf16(tap_at(act, p2, hi), tap_at(act, p3, hi));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= nts) break;
          mma16816(acc[i][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }

    if (kDx) {
      // source pixel i: row syl, column parity px, column pair m (a warp's
      // pixels share their row and parity, so their taps)
      for (int i = tid; i < 4 * kDownTH * kDenseTW; i += kDownThreads) {
        const int syl = i / (2 * kDenseTW), px = (i / kDenseTW) & 1;
        const int sxl = 2 * (i % kDenseTW) + px;
        const int sy = 2 * t.r0 + syl, sx = 2 * t.c0 + sxl;
        if (sy >= p.h || sx >= p.w) continue;
        int ky[2], oy[2], kx[2], ox[2];
        const int ny = covering(syl, ky, oy), nx = covering(sxl, kx, ox);
        float ga[kC] = {};
        for (int a = 0; a < ny; ++a)
          for (int c = 0; c < nx; ++c) {
            const float* wr = wsm + (ky[a] * 3 + kx[c]) * cin * cout;
            const __nv_bfloat16* dp = dye + oy[a] * kDW + ox[c];
#pragma unroll 4
            for (int co = 0; co < cout; ++co) {
              const float d = __bfloat162float(dp[co * kDP]);
#pragma unroll
              for (int ci = 0; ci < kC; ++ci)
                if (ci < cin) ga[ci] = fmaf(d, wr[ci * cout + co], ga[ci]);
            }
          }
        const int lead =
            (int)(src_addr(p.x, t.b, sy, 2 * t.c0 - 1, p.h, p.w, cin) & 15);
        const __nv_bfloat16* xr = reinterpret_cast<const __nv_bfloat16*>(
            raw + (syl + 1) * rs + lead) + (sxl + 1) * cin;
        __nv_bfloat16* dxp = p.dx + ((size_t)(t.b * p.h + sy) * p.w + sx) * cin;
#pragma unroll
        for (int ci = 0; ci < kC; ++ci) {
          if (ci >= cin) break;
          float gv = ga[ci];
          if (p.act != kNone) {
            const float xi = __bfloat162float(xr[ci]);
            const float v = __fadd_rn(__fmul_rn(xi, pro[ci]), pro[16 + ci]);
            const float gm = gv * act_grad(v, p.act);
            gv = gm * pro[ci];
            dsc[ci] += gm * xi;
            dsh[ci] += gm;
          }
          dxp[ci] = __float2bfloat16_rn(gv);
        }
      }
    }
    __syncthreads();
  }

  // the block's row: dW over the pixel-step warps wp in order, dbias over
  // the staging phases in order, dscale / dshift over lanes then warps
  float* red = reinterpret_cast<float*>(smem);
  const int kp = mts * 16, np = nts * 8, nw = 9 * cin * cout;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mt = wm + i * wms;
    if (mt >= mts || warp >= wms * wps) break;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= nts) break;
      float* r0 = red + (wp * kp + mt * 16 + g) * np + nt * 8 + 2 * q;
      r0[0] = acc[i][nt][0];
      r0[1] = acc[i][nt][1];
      r0[8 * np] = acc[i][nt][2];
      r0[8 * np + 1] = acc[i][nt][3];
    }
  }
  __syncthreads();
  float* row = p.part + (size_t)blockIdx.x * p.len;
  for (int j = tid; j < nw; j += kDownThreads) {
    const int kk = j / cout, co = j - kk * cout;
    float s = 0.f;
    for (int w = 0; w < wps; ++w) s += red[(w * kp + kk) * np + co];
    row[j] = s;
  }
  __syncthreads();
  ordered_unit_sums(db, nv, units, red, row + nw);
#pragma unroll
  for (int ci = 0; ci < kC; ++ci) {
    dsc[ci] = warp_sum(dsc[ci]);
    dsh[ci] = warp_sum(dsh[ci]);
  }
  if (lane == 0)
#pragma unroll
    for (int ci = 0; ci < kC; ++ci) {
      red[warp * 32 + ci] = dsc[ci];
      red[warp * 32 + 16 + ci] = dsh[ci];
    }
  __syncthreads();
  for (int j = tid; j < 2 * cin; j += kDownThreads) {
    const int stat = j / cin, c = j - stat * cin;
    float s = 0.f;
    if (kDx)
      for (int w = 0; w < 8; ++w) s += red[w * 32 + stat * 16 + c];
    row[nw + cout + j] = s;
  }
}

template <int TW, int kStride>
struct DwBwdSmem {
  using S = SrcTile<TW, kStride>;
  // dye tile: at stride 2 the tile's outputs with one halo row and column
  // after them (the outputs whose windows cover its source pixels); at
  // stride 1 one halo row and column on each side
  static constexpr int kO = kStride == 1 ? 1 : 0;   // halo before the tile
  static constexpr int kPH = kStride == 1 ? kDownTH + 2 : kDownTH + 1;
  static constexpr int kPW = kStride == 1 ? TW + 2 : TW + 1;
  // raw tiles (two where they fit, else one: C = 64 at 32 columns), act
  // tile, dye (kPH * kPW, c) bf16, weights (9, c), prologue vectors (2, c)
  // f32; at the end the block's reductions overlay it all
  __host__ __device__ static int rest(int c) {
    return S::act_bytes(c) + kPH * kPW * c * 2 + 11 * c * 4;
  }
  __host__ __device__ static int nraw(int c) {
    return 2 * S::raw_bytes(c) + rest(c) <= kDownMaxSmem ? 2 : 1;
  }
  __host__ __device__ static int act_off(int c) {
    return nraw(c) * S::raw_bytes(c);
  }
  __host__ __device__ static int dye_off(int c) {
    return act_off(c) + S::act_bytes(c);
  }
  __host__ __device__ static int w_off(int c) {
    return dye_off(c) + kPH * kPW * c * 2;
  }
  __host__ __device__ static int pro_off(int c) { return w_off(c) + 9 * c * 4; }
  __host__ __device__ static int bytes(int c) {
    const int end = pro_off(c) + 2 * c * 4;
    const int need = 8 * 9 * 64 * 4;   // >= 8 * kDownThreads * 4
    return end > need ? end : need;
  }
};

// c = cin = cout, a multiple of 8 up to kDwMaxC; tiles of TW output
// columns at stride kStride (2: K4; 1: K3's depthwise mode). The staging,
// dbias and dx threads take 8 channels: group tid % (c / 8) of the first
// kDownThreads rounded down to a multiple of c / 8 threads; the dW threads
// a channel pair cp = tid % (c / 2) and a pixel phase, of the first
// kDownThreads rounded down to a multiple of c / 2 (all 256 threads where
// those divide 256: the old widths' walk).
template <int TW, int kStride, int kDx>
__global__ void __launch_bounds__(kDownThreads) down_dw_bwd_kernel(
    const DownBwdParams p) {
  using S = SrcTile<TW, kStride>;
  using M = DwBwdSmem<TW, kStride>;
  constexpr int kPW = M::kPW, kO = M::kO;
  extern __shared__ __align__(16) char down_smem[];
  char* smem = down_smem;
  const int c = p.cin;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + M::act_off(c));
  __nv_bfloat16* dye = reinterpret_cast<__nv_bfloat16*>(smem + M::dye_off(c));
  float* wsm = reinterpret_cast<float*>(smem + M::w_off(c));
  float* pro = reinterpret_cast<float*>(smem + M::pro_off(c));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int as = S::act_stride(c), rs = S::raw_stride(c);
  // 8-channel group of the staging and dx threads
  const int groups = c / 8, c0 = (tid % groups) * 8;
  const bool on_g = tid < kDownThreads / groups * groups;
  // channel pair and pixel phase of the dW threads
  const int pairs = c / 2, cp = tid % pairs, ps = tid / pairs;
  const int splits = kDownThreads / pairs;
  const bool on_p = ps < splits;

  for (int i = tid; i < 9 * c; i += kDownThreads)
    wsm[i] = __bfloat162float(p.wt[i]);
  if (p.act != kNone && tid < c) {
    pro[tid] = p.scale[tid];
    pro[c + tid] = p.shift[tid];
  }
  float m0[8], m1[8], db[8] = {}, dsc[8] = {}, dsh[8] = {};
  float wacc[9][2] = {};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    m0[k] = p.dmom != nullptr ? p.dmom[c0 + k] : 0.f;
    m1[k] = p.dmom != nullptr ? p.dmom[c + c0 + k] : 0.f;
  }
  // the dye rows and columns staged: stride 2 the tile's (and, with dx, one
  // halo after it); stride 1 one halo on each side
  constexpr int kRowsSt = kStride == 1 ? kDownTH + 2 : kDownTH + kDx;
  constexpr int kColsSt = kStride == 1 ? TW + 2 : TW + kDx;

  // with two raw buffers the next tile's rows are copied into the other
  // one while this tile is computed; with one, after this tile is done
  const int rb = S::raw_bytes(c), two = M::nraw(c) == 2;
  int tile = blockIdx.x;
  stage_src<TW, kStride>(p.x, p.x_end,
                         down_tile(tile, p.tiles_y, p.tiles_x, TW), p.h, p.w,
                         c, smem);
  cp_async_commit();
  for (int n = 0; tile < p.tiles; tile += gridDim.x, ++n) {
    const DownTile t = down_tile(tile, p.tiles_y, p.tiles_x, TW);
    const char* raw = smem + (two ? (n & 1) * rb : 0);
    const bool next = tile + gridDim.x < p.tiles;
    if (two && next)
      stage_src<TW, kStride>(
          p.x, p.x_end, down_tile(tile + gridDim.x, p.tiles_y, p.tiles_x, TW),
          p.h, p.w, c, smem + ((n + 1) & 1) * rb);
    cp_async_commit();   // (empty with one buffer: the wait below then
                         // waits for the copy committed after the last tile)
    for (int it = tid; on_g && it < kRowsSt * kColsSt * groups;
         it += kDownThreads / groups * groups) {
      const int pi = it / groups, oyl = pi / kColsSt, oxl = pi - oyl * kColsSt;
      const int oy = t.r0 - kO + oyl, ox = t.c0 - kO + oxl;
      float gv[8] = {};
      if (oy >= 0 && ox >= 0 && oy < p.ho && ox < p.wo) {
        const size_t o = ((size_t)(t.b * p.ho + oy) * p.wo + ox) * c + c0;
        load8(p.dy + o, gv);
        if (p.dmom != nullptr) {
          float yv[8];
          load8(p.y + o, yv);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            gv[k] = gv[k] + m0[k] + 2.f * yv[k] * m1[k];
        }
        if (oyl >= kO && oyl < kO + kDownTH && oxl >= kO && oxl < kO + TW)
#pragma unroll
          for (int k = 0; k < 8; ++k) db[k] += gv[k];
      }
      __align__(16) __nv_bfloat16 o8[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) o8[k] = __float2bfloat16_rn(gv[k]);
      *reinterpret_cast<uint4*>(dye + (oyl * kPW + oxl) * c + c0) =
          *reinterpret_cast<const uint4*>(o8);
    }
    cp_async_wait<1>();
    __syncthreads();
    activate_src<TW, kStride>(p.x, t, p.h, p.w, c, raw, act, pro, pro + c,
                              p.act);
    __syncthreads();

    for (int px = ps; on_p && px < kDownTH * TW; px += splits) {
      const int oyl = px / TW, oxl = px - oyl * TW;
      const float2 d = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(
              dye + ((oyl + kO) * kPW + oxl + kO) * c + 2 * cp));
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                act + (kStride * oyl + tap / 3) * as +
                (kStride * oxl + tap % 3) * c + 2 * cp));
        wacc[tap][0] = fmaf(a.x, d.x, wacc[tap][0]);
        wacc[tap][1] = fmaf(a.y, d.y, wacc[tap][1]);
      }
    }

    if (kDx) {
      // the tile's own source pixels: kStride * kDownTH rows by kStride * TW
      constexpr int kSW = kStride * TW;
      for (int it = tid; on_g && it < kStride * kDownTH * kSW * groups;
           it += kDownThreads / groups * groups) {
        const int spx = it / groups, syl = spx / kSW;
        const int sxl = spx - syl * kSW;
        const int sy = kStride * t.r0 + syl, sx = kStride * t.c0 + sxl;
        if (sy >= p.h || sx >= p.w) continue;
        float ga[8] = {};
        if constexpr (kStride == 1) {
          // output (sy + 1 - ky, sx + 1 - kx) through tap (ky, kx): dye
          // (syl + 2 - ky, sxl + 2 - kx) of the tile with its halo
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            float dv[8];
            load8(dye + ((syl + 2 - tap / 3) * kPW + sxl + 2 - tap % 3) * c +
                      c0, dv);
            const float* wr = wsm + tap * c + c0;
#pragma unroll
            for (int k = 0; k < 8; ++k) ga[k] = fmaf(dv[k], wr[k], ga[k]);
          }
        } else {
          int ky[2], oy[2], kx[2], ox[2];
          const int ny = covering(syl, ky, oy), nx = covering(sxl, kx, ox);
          for (int a = 0; a < ny; ++a)
            for (int b = 0; b < nx; ++b) {
              float dv[8];
              load8(dye + (oy[a] * kPW + ox[b]) * c + c0, dv);
              const float* wr = wsm + (ky[a] * 3 + kx[b]) * c + c0;
#pragma unroll
              for (int k = 0; k < 8; ++k) ga[k] = fmaf(dv[k], wr[k], ga[k]);
            }
        }
        if (p.act != kNone) {
          float xv[8];
          load8(reinterpret_cast<const __nv_bfloat16*>(raw + (syl + 1) * rs) +
                    (sxl + 1) * c + c0, xv);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float s = pro[c0 + k];
            const float v = __fadd_rn(__fmul_rn(xv[k], s), pro[c + c0 + k]);
            const float gm = ga[k] * act_grad(v, p.act);
            ga[k] = gm * s;
            dsc[k] += gm * xv[k];
            dsh[k] += gm;
          }
        }
        __align__(16) __nv_bfloat16 o8[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) o8[k] = __float2bfloat16_rn(ga[k]);
        *reinterpret_cast<uint4*>(
            p.dx + ((size_t)(t.b * p.h + sy) * p.w + sx) * c + c0) =
            *reinterpret_cast<const uint4*>(o8);
      }
    }
    __syncthreads();
    if (!two && next) {
      stage_src<TW, kStride>(
          p.x, p.x_end, down_tile(tile + gridDim.x, p.tiles_y, p.tiles_x, TW),
          p.h, p.w, c, smem);
      cp_async_commit();
    }
  }

  // the block's row: dW over the pixel phases (lanes, then warps, in order;
  // or, where dw_warp_sums(c) is false, the threads of a channel pair in
  // order, a tap at a time), dbias, dscale and dshift over the threads of a
  // channel group in order
  float* red = reinterpret_cast<float*>(smem);
  float* row = p.part + (size_t)blockIdx.x * p.len;
  if (dw_warp_sums(c)) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        for (int off = pairs; off < 32; off <<= 1)
          wacc[tap][e] += __shfl_xor_sync(kFull, wacc[tap][e], off);
    if (lane < pairs)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        red[(warp * 9 + tap) * c + 2 * cp] = wacc[tap][0];
        red[(warp * 9 + tap) * c + 2 * cp + 1] = wacc[tap][1];
      }
    __syncthreads();
    for (int j = tid; j < 9 * c; j += kDownThreads) {
      float s = 0.f;
      for (int w = 0; w < 8; ++w) s += red[w * 9 * c + j];
      row[j] = s;
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float v[8] = {wacc[tap][0], wacc[tap][1]};
      ordered_unit_sums(v, 2, pairs, red, row + tap * c);
    }
  }
  ordered_unit_sums(db, 8, groups, red, row + 9 * c);
  ordered_unit_sums(dsc, 8, groups, red, row + 10 * c);
  ordered_unit_sums(dsh, 8, groups, red, row + 11 * c);
}

using DownBwdKernel = void (*)(const DownBwdParams);

// the kernel of a launch, its dynamic shared memory and its tiles' output
// columns; false outside the kernels' channels and strides (stride 1:
// depthwise only)
bool down_bwd_kernel(int cin, int cout, int depthwise, int stride, int dx,
                     DownBwdKernel* k, int* smem, int* tw) {
  if (!down_channels_ok(cin, cout, depthwise) || (stride != 1 && stride != 2) ||
      (stride == 1 && !depthwise))
    return false;
  *tw = down_tile_cols(depthwise, cin, stride);
  if (depthwise && stride == 1) {
    *k = dx ? &down_dw_bwd_kernel<kDwTW, 1, 1> : &down_dw_bwd_kernel<kDwTW, 1, 0>;
    *smem = DwBwdSmem<kDwTW, 1>::bytes(cin);
  } else if (depthwise && *tw == kDwTW) {
    *k = dx ? &down_dw_bwd_kernel<kDwTW, 2, 1> : &down_dw_bwd_kernel<kDwTW, 2, 0>;
    *smem = DwBwdSmem<kDwTW, 2>::bytes(cin);
  } else if (depthwise) {
    *k = dx ? &down_dw_bwd_kernel<kDwWideTW, 2, 1>
            : &down_dw_bwd_kernel<kDwWideTW, 2, 0>;
    *smem = DwBwdSmem<kDwWideTW, 2>::bytes(cin);
  } else if (!dx) {
    *k = &down_stem_bwd_kernel<0, 1>;
    *smem = StemBwdSmem<0>::bytes(cin, cout);
  } else {
    // the dx part's channel capacity: 4 for the stem's 3 channels
    *k = &down_stem_bwd_kernel<1, 16>;
    if (cin <= 4) *k = &down_stem_bwd_kernel<1, 4>;
    *smem = StemBwdSmem<1>::bytes(cin, cout);
  }
  return true;
}

}  // namespace

// Host entry (plain C interface, bound with ctypes). x, scale, shift, act
// as for mmr_fused_conv_down; wt: (9, cin, cout) bf16 (dense: cin <= 16,
// cout <= 32) or (9, cin) (depthwise: cout == cin, a multiple of 8 up to
// 96); stride: 2, or 1 for a depthwise conv (K3's depthwise mode); dy, y:
// (n, ceil(h / stride), ceil(w / stride), cout) bf16 (y read with dmom);
// dmom: (2, cout) f32 or null; dx: (n, h, w, cin) bf16, or null for no dx;
// part: f32 scratch of part_rows rows (one a tile is always enough) of len
// = nw + cout + 2 * cin (nw = 9 * cin * cout dense, 9 * cin depthwise);
// out: (len,) f32, written whole: dW (nw, HWIO order), dbias, dscale,
// dshift (zeros without dx or a prologue). Every pointer 16-byte aligned.
// One launch of a persistent grid (mmr_fused_conv_down_bwd_grid), then the
// reduction of its rows. Returns a cudaError_t.
extern "C" int mmr_fused_conv_down_bwd(
    const void* x, const void* scale, const void* shift, int act,
    const void* wt, const void* dy, const void* y, const void* dmom, void* dx,
    void* part, int part_rows, void* out, int n, int h, int w, int cin,
    int cout, int depthwise, int stride, void* stream) {
  DownBwdParams p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.act = act;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.dy = static_cast<const __nv_bfloat16*>(dy);
  p.y = static_cast<const __nv_bfloat16*>(y);
  p.dmom = static_cast<const float*>(dmom);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.part = static_cast<float*>(part);
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.len = (depthwise ? 9 * cin : 9 * cin * cout) + cout + 2 * cin;
  p.x_end = (long long)reinterpret_cast<uintptr_t>(x) +
            (long long)n * h * w * cin * 2;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(dy) |
                          reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(dx);
  DownBwdKernel kernel;
  int smem = 0, tw = 0;
  if (align % 16 != 0 || n < 1 || h < 1 || w < 1 ||
      (dmom != nullptr && y == nullptr) ||
      !down_bwd_kernel(cin, cout, depthwise, stride, dx != nullptr, &kernel,
                       &smem, &tw))
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
  if (part_rows < g.blocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<g.blocks, kDownThreads, smem, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)launch_rows_reduce(p.part, g.blocks, p.len,
                                 static_cast<float*>(out), s);
}

// The grid mmr_fused_conv_down_bwd launches at these arguments (dx: whether
// dx is computed): out[0..4) = {blocks, blocks a SM, SMs, dynamic shared
// memory}; it sets the kernel's launch attributes as the launch does.
// Returns a cudaError_t.
extern "C" int mmr_fused_conv_down_bwd_grid(int n, int h, int w, int cin,
                                            int cout, int depthwise, int dx,
                                            int stride, void* out) {
  DownBwdKernel kernel;
  int smem = 0, tw = 0;
  if (n < 1 || h < 1 || w < 1 ||
      !down_bwd_kernel(cin, cout, depthwise, stride, dx, &kernel, &smem, &tw))
    return (int)cudaErrorInvalidValue;
  return report_grid(kernel, smem, down_tiles(n, h, w, tw, stride).all,
                     static_cast<int*>(out));
}

// Dynamic shared memory in bytes (what = 0) or resident blocks per SM at
// the launch's attributes (what = 1) of the kernels the flagship runs: the
// dense one without dx at c -> 16 channels (kind 0), the depthwise one with
// dx at c channels, stride 2 (kind 1) or stride 1 (kind 2). Returns -1
// otherwise.
extern "C" int mmr_fused_conv_down_bwd_info(int what, int kind, int c) {
  DownBwdKernel kernel;
  int smem = 0, tw = 0;
  int g[4];
  if (kind < 0 || kind > 2 ||
      !down_bwd_kernel(c, kind ? c : 16, kind != 0, kind == 2 ? 1 : 2,
                       kind != 0, &kernel, &smem, &tw))
    return -1;
  if (!what) return smem;
  return report_grid(kernel, smem, 1 << 30, g) == 0 ? g[1] : -1;
}
