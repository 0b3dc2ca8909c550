// Device code shared by the port's conv kernels: K1 (fused_conv.cu), its
// backward K3 (fused_conv_bwd.cu), the head backward K5b (head_loss.cu),
// the stride-2 pair K2/K4 (through down_tile.cuh: the prologue, cp.async,
// launch attributes), the narrow tile of K5a and K8a (narrow_tile.cuh) and
// the standalone conv K6/K8 (conv3x3.cu): the prologue and staging
// helpers, and the Hopper mainloops ("Hopper mainloops" below: cp.async
// ring, wgmma) of K1, K3's dx and dW, K5b and K6a (K8a's convs wider than
// the narrow tile); K6b/K8b's dW kernel (conv3x3.cu) is built from their
// pieces.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int kKC = 16;                      // input channels per chunk
constexpr int kMaxIn = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Act { kNone = 0, kRelu = 1, kHswish = 2, kLinear = 3 };

// An input of a conv in storage type T (bf16, or f32 for K8 in
// conv3x3.cu): every tile is staged as bf16 either way.
template <class T>
struct InputT {
  const T* x;              // NHWC; at (height/2, width/2) when up2x
  const float* scale;      // (c,) or null when act == kNone
  const float* shift;
  int c;
  int act;
  int up2x;
  int chunk0;              // first 16-channel chunk of this input in wt
};
using Input = InputT<__nv_bfloat16>;

__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) {
  return v;
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive values from a 16-byte-aligned address, as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(e[k]);
}
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 consecutive values from a 16-byte-aligned address, rounded to bf16
__device__ __forceinline__ void load8_bf16(const __nv_bfloat16* src,
                                           __nv_bfloat16* o) {
  *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void load8_bf16(const float* src,
                                           __nv_bfloat16* o) {
  float v[8];
  load8(src, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(v[k]);
}

__device__ __forceinline__ float prologue(float v, float s, float t, int act) {
  // no FMA contraction: the plain version multiplies and adds separately
  v = __fadd_rn(__fmul_rn(v, s), t);
  if (act == kRelu) return fmaxf(v, 0.f);
  if (act == kHswish) {
    const float g = fminf(fmaxf(__fadd_rn(v, 3.f), 0.f), 6.f);
    return __fmul_rn(__fmul_rn(v, g), 1.f / 6.f);
  }
  return v;
}

// d act(v) / dv, hswish taking 0 at v <= -3 and 1 at v >= 3
// (packed_chain.py::_act_grad)
__device__ __forceinline__ float act_grad(float v, int act) {
  if (act == kRelu) return v > 0.f ? 1.f : 0.f;
  if (act == kHswish)
    return v <= -3.f ? 0.f : (v >= 3.f ? 1.f : (2.f * v + 3.f) / 6.f);
  return 1.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ======================================================== Hopper mainloops
// The stride-1 conv of K6a (forward and dx; K8a at f32 or bf16 storage) and
// K3's dx (conv_wg_kernel), K1's conv over pending inputs
// (pending_conv_kernel), the source-resolution dx of a lazily x2-upsampled
// K3 input (conv_up2_dx_kernel) and K3's weight gradient
// (conv_dw_wg_kernel), built for the H100 (sm_90a); K5b (head_loss.cu)
// builds its own tile from the same pieces:
//
// - Operands reach shared memory by cp.async (16 B a copy, zero-fill for the
//   halo, the ragged edge and channels beyond c) in a ring of 2 stages (3
//   for the conv at N = 64); an operand that must be converted on the way
//   (f32 storage, a channel count not a multiple of 8, K1's and K3's
//   prologue'd and lazily upsampled inputs) is staged through registers
//   instead (fetch8, prologue8), K1's one chunk ahead and dW's one pixel
//   tile ahead. The products on one stage run while the
//   next stages' loads are in flight: one __syncthreads per stage, after
//   cp.async.wait_group. A thread that stored through registers issues
//   fence.proxy.async after its stores (wgmma reads shared memory through
//   the async proxy; cp.async data needs no fence, as in CUTLASS's sm90
//   cp.async mainloops).
// - Products are wgmma m64nNk16 (bf16 in, f32 accumulators in registers),
//   N = 16, 32 or 64 output channels a block (grid z tiles the rest), both
//   operands read from shared memory through no-swizzle descriptors (core
//   matrix: 8 rows x 16 B; LBO = the stride between the two 8-wide halves
//   of K, SBO = the stride between 8-row groups of M or N). None of them
//   runs on mma.sync: a narrow K3 dW input (c < 64) leaves M rows zero,
//   and a narrow output is wgmma n16.
// - Staging is channel-split: 8 channels of one pixel are one 16-byte row,
//   consecutive pixels are consecutive rows, so a tap's shift is a whole
//   number of rows and each tap's A operand is the staged tile itself at an
//   offset: nothing is copied per tap.
//
// Tile of the two conv kernels: M = one 64-pixel output row segment (a row
// W = 80 wastes 37.5 % of its second segment, 160 wastes 16.7 %, the other
// main-path widths 64, 128, 256, 320, 512 and 640 none; chosen over three
// column-shifted copies of the tile, which would triple the staging).
// Block = kWgs warpgroups x kWgRows rows: 2 x 4 rows at N <= 32 (2-3 blocks
// a SM), 4 x 2 rows at N = 64 (8 rows share each staged weight slice), 2 x
// 2 source rows in the x2 kernel (its staged tile is the largest); at most
// 64 f32 accumulators a thread. Per stage, one 16-channel chunk: the halo
// tile and the chunk's taps for the block's N.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): a conv moves 2*(c_in +
// c_out) bytes per pixel for 18*c_in*c_out operations, so convs with
// c_in*c_out/(c_in + c_out) above ~33 (the 295 op/byte ridge) are bound by
// the tensor cores and the narrow ones (the flagship's 16-channel rows, K8
// at 16 -> 16) by memory; chip_smoke.py prints each launch's bound.

constexpr int kSeg = 64;          // output pixels of a row segment: wgmma M

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// wait until at most K of this thread's committed groups are in flight
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}
// make this thread's generic shared-memory stores visible to the tensor
// cores (wgmma reads through the async proxy; cp.async data needs no fence,
// as in CUTLASS's sm90 cp.async mainloops). It waits for the thread's
// outstanding memory operations, so it follows the stores, not the loop top.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator registers across an async MMA
template <int K>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// no-swizzle shared-memory matrix descriptor
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x N, f32, the warpgroup's accumulator fragment) += A (64 x 16) *
// B (16 x N), bf16 from shared memory; TA / TB: the operand is stored
// M- / N-major (1) instead of K-major (0).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int TA, int TB>
  __device__ __forceinline__ static void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  template <int TA, int TB>
  __device__ __forceinline__ static void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TA, int TB>
  __device__ __forceinline__ static void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

// d (16 x 8, f32) += a (16 x 16, bf16, row-major fragments) * b (16 x 8,
// bf16, column fragments): lane = 4 * g + q holds a rows g, g + 8 at
// columns 2q, 2q + 1 and 2q + 8, 2q + 9; b rows 2q, 2q + 1 and 2q + 8,
// 2q + 9 of column g; d rows g, g + 8 at columns 2q, 2q + 1
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------ stride-1 conv
// y = conv(a, taps) over a 16-channel-chunked tap pack (c chunks, taps, 2,
// np, 8): K6a forward (a = x, taps = W, + bias, ReLU), K6a / K8a dx (a = dy,
// flipped transposed taps), K3 dx (a = dye; the columns may be the channels
// of several inputs, each written to its own dx with its prologue backward
// gm = g * act'(s*x + t), dx = gm*s, dscale += gm*x, dshift += gm in the
// epilogue; one f32 atomic per channel per block), and with kUp2 the dx of a
// lazily x2-upsampled K3 input at source resolution: the 2x2 sum of the fine
// 3x3 transposed conv is one 4x4 stride-2 correlation over the fine dye, per
// axis the taps (Wf0, Wf0+Wf1, Wf1+Wf2, Wf2) of the flipped weights at fine
// offsets -1..2, summed in f32 by the wrapper and each split into a bf16
// pair hi + lo (taps 0..15 and 16..31 of the pack): 32 products per source
// pixel where the fine products and their 2x2 sum took 36, and no rounding
// of the summed taps (bf16-rounded sums put the flagship's dshift, a sum
// over 10^6 pixels that cancels, 1.7e-2 of its largest value from the plain
// version's, over the 1e-2 bound). The fine dye tile is staged phase-split
// into even and odd columns, so each combined tap reads a contiguous run of
// source-resolution slots.

// With kPend (K1's pending_conv_kernel) the operand is the concat of up to 8
// pending inputs (in[], each in concat order from chunk0, its channels
// padded to 16 a chunk: the K loop runs over all their chunks and the tap
// pack is over that concat), each staged through registers one chunk ahead
// with its prologue act(s*x + t) (f32, no FMA contraction, rounded to bf16)
// and its lazy x2 (fine pixel (y, x) reads source pixel (y/2, x/2)); SAME
// padding is zero after the prologue, and a lazy input's border is the fine
// tensor's. With mom != null the epilogue adds Sum y and Sum y^2 of the f32
// outputs (bias included, before the bf16 rounding) into mom, one f32
// atomic per channel and block, as dscale / dshift are added.

// 8 channels [xc, xc + 8) of pixel (yy, xx) (inside the image) of the image
// an input stands for (a lazy x2 input: its source pixel (yy/2, xx/2)), as
// bf16 (an f32 input rounded), zero beyond the input's c
template <class T>
__device__ __forceinline__ uint4 fetch8(const InputT<T>& in, int b,
                                        int height, int width, int yy,
                                        int xx, int xc, bool xvec) {
  const int hs = in.up2x ? height >> 1 : height;
  const int ws = in.up2x ? width >> 1 : width;
  const int sy = in.up2x ? yy >> 1 : yy;
  const int sx = in.up2x ? xx >> 1 : xx;
  const T* src = in.x + ((size_t)(b * hs + sy) * ws + sx) * in.c + xc;
  uint4 raw = make_uint4(0, 0, 0, 0);
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
  if (xvec) {
    load8_bf16(src, e);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (xc + k < in.c) e[k] = to_bf16(src[k]);
  }
  return raw;
}

// act(s*v + t) of 8 bf16 values in place, rounded to bf16 (identity for
// kNone), the act chosen once for the 8
__device__ __forceinline__ void prologue8(__nv_bfloat16* e, const float* s,
                                          const float* t, int act) {
  if (act == kNone) return;
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = __fadd_rn(__fmul_rn(__bfloat162float(e[k]), s[k]), t[k]);
  if (act == kRelu) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = fmaxf(v[k], 0.f);
  } else if (act == kHswish) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float g = fminf(fmaxf(__fadd_rn(v[k], 3.f), 0.f), 6.f);
      v[k] = __fmul_rn(__fmul_rn(v[k], g), 1.f / 6.f);
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16_rn(v[k]);
}

// the prologue vectors of channels [xc, xc + 8) of an input: (1, 0) beyond
// c, so that the padding stays act(0) = 0
template <class T>
__device__ __forceinline__ void prologue_vec8(const InputT<T>& in, int xc,
                                              float* s, float* t) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool on = in.act != kNone && xc + k < in.c;
    s[k] = on ? in.scale[xc + k] : 1.f;
    t[k] = on ? in.shift[xc + k] : 0.f;
  }
}

// One output of the conv: block columns [off, off + c) are its channels
// (off a multiple of 8), so one launch can write the dx of several inputs
// that convolve the same dy.
template <class T>
struct WgOut {
  T* y;                     // (n, oh, ow, c): y, or dx
  const __nv_bfloat16* x;   // the raw forward input (n, oh, ow, c) when
  const float* scale;       // act != kNone: y is dx through its prologue
  const float* shift;
  float* dscale;            // zeroed (c,) f32 when act != kNone
  float* dshift;
  int c, act, off;
  const __nv_bfloat16* acc; // K3's `thru` addend (n, oh, ow, c) added in
                            // f32 before the rounding, or null
};

template <class T>
struct WgParams {
  const T* a;               // the operand, NHWC (n, ah, aw, c); or, with
  int c, ah, aw;            // kPend, c = 16 * the inputs' chunks
  Input in[kMaxIn];         // kPend: the pending inputs (chunk0 in chunks)
  int n_in;
  const __nv_bfloat16* wt;  // (c chunks, taps, 2, np, 8) bf16
  int np;                   // columns, a multiple of the tile N
  int n, oh, ow;
  const float* bias;        // (out[0].c,) or null
  int relu;
  float* mom;               // zeroed (2, out[0].c) f32 or null
  WgOut<T> out[kMaxIn];
  int n_out;
};

template <int N, bool kUp2>
struct WgTile {
  static constexpr int kTaps = kUp2 ? 32 : 9;   // x2: 16 hi + 16 lo
  static constexpr int kWgs = (kUp2 || N < 64) ? 2 : 4;  // warpgroups
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kWgRows = (kUp2 || N >= 64) ? 2 : 4;
  static constexpr int kRows = kWgs * kWgRows;  // output rows a block
  static constexpr int kARows = kUp2 ? 2 * kRows + 2 : kRows + 2;
  static constexpr int kPlanes = kUp2 ? 2 : 1;   // x2: even, odd columns
  static constexpr int kSlots = kUp2 ? kSeg + 1 : kSeg + 2;
  static constexpr int kAUnits = kARows * kPlanes * kSlots;  // per 8 ch
  static constexpr int kABytes = 2 * kAUnits * 16;
  static constexpr int kBBytes = kTaps * 2 * N * 16;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = (kUp2 || N < 64) ? 2 : 3;  // ring slots
  static constexpr int kSmem = kStages * kStageBytes + 2 * N * 4;

  // the first staged row (16 B unit) of block row r's A operand for tap t.
  // Staged units: [8-channel half][row][plane][slot]. kUp2: row 0 = fine
  // row 2*oy0 - 1, plane 0 slot s = fine column 2*(ox0 + s), plane 1 slot
  // s = fine column 2*(ox0 + s) - 1; t = 4 * (oy + 1) + (ox + 1) for fine
  // offsets oy, ox in -1..2 (and t + 16 for its lo half).
  __device__ static int a_unit(int r, int t) {
    if (kUp2) {
      const int oy = (t & 15) / 4, ox = t % 4;
      return ((2 * r + oy) * kPlanes + ((ox & 1) ? 0 : 1)) * kSlots +
             (ox >> 1);
    }
    return (r + t / 3) * kSlots + t % 3;
  }
};

// store v0 (and v1 at dst + 1 when pair) as T
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float v0, float v1,
                                       bool pair, bool aligned) {
  if (pair && aligned) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16_rn(v0);
    if (pair) dst[1] = __float2bfloat16_rn(v1);
  }
}
__device__ __forceinline__ void store2(float* dst, float v0, float v1,
                                       bool pair, bool aligned) {
  if (pair && aligned) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    dst[0] = v0;
    if (pair) dst[1] = v1;
  }
}

// v[0] (and v[1] from src + 1 when pair) as f32: a paired load when aligned
__device__ __forceinline__ void load2(const __nv_bfloat16* src, float* v,
                                      bool pair, bool aligned) {
  if (pair && aligned) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = __bfloat162float(src[0]);
    if (pair) v[1] = __bfloat162float(src[1]);
  }
}

// K1's A operand, staged through registers one chunk ahead: load() issues
// the global loads of chunk ch of the pending inputs (thread t takes
// channel half t & 1 and every (kThr/2)-th pixel of the kPix halo pixels,
// kSlots a row, from fine pixel (y0 - 1, x0 - 1)), store() applies the
// input's prologue to the pixels inside the image (the others stay zero:
// SAME padding after the prologue) and writes them into a ring slot, its
// two halves kPix units apart, then fences them for the tensor cores.
template <int kPix, int kSlots, int kThr>
struct PendingStager {
  static constexpr int kHalf = kThr / 2;
  static constexpr int kPer = (kPix + kHalf - 1) / kHalf;
  uint4 raw[kPer];
  unsigned live;
  int j, xc;

  template <class P>
  __device__ __forceinline__ void load(const P& p, int ch, int b, int y0,
                                       int x0) {
    j = 0;
    while (j + 1 < p.n_in && ch >= p.in[j + 1].chunk0) ++j;
    const Input& in = p.in[j];
    xc = (ch - in.chunk0) * kKC + 8 * (threadIdx.x & 1);
    const bool xvec = in.c % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(in.x) % 16 == 0;
    live = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int pix = (threadIdx.x >> 1) + q * kHalf;
      const int yy = y0 - 1 + pix / kSlots;
      const int xx = x0 - 1 + pix % kSlots;
      raw[q] = make_uint4(0, 0, 0, 0);
      if (pix < kPix && yy >= 0 && yy < p.oh && xx >= 0 && xx < p.ow &&
          xc < in.c) {
        live |= 1u << q;
        raw[q] = fetch8(in, b, p.oh, p.ow, yy, xx, xc, xvec);
      }
    }
  }

  template <class P>
  __device__ __forceinline__ void store(const P& p, unsigned char* slot) {
    float sc[8], sh[8];
    prologue_vec8(p.in[j], xc, sc, sh);
    const int act = p.in[j].act;
    unsigned char* dst = slot + (threadIdx.x & 1) * kPix * 16;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int pix = (threadIdx.x >> 1) + q * kHalf;
      if (pix >= kPix) continue;
      if (live >> q & 1u)
        prologue8(reinterpret_cast<__nv_bfloat16*>(&raw[q]), sc, sh, act);
      *reinterpret_cast<uint4*>(dst + pix * 16) = raw[q];
    }
    fence_proxy_async();  // stores the tensor cores will read
  }
};

// The epilogue from registers of one warpgroup's R output rows from oy (a
// 64-pixel segment from ox0; columns n0 .. n0 + N of the block): accumulator
// j of row r holds pixel 16*w + lane/4 + 8*((j/2)%2) of the segment, column
// 8*(j/4) + 2*(lane%4) + j%2. Column group nb (8 columns) belongs to output
// oi[nb] (-1: none). An output with a prologue gets its dx through the
// prologue's backward and its (gm*x, gm) added into (s1, s2); the others
// y + bias (ReLU), with (y, y^2) added into (s1, s2) when p.mom != null.
// With kAcc, an output with an addend (acc != null: the cotangent that the
// later consumers of a K3 input summed) gets it added in f32 after all
// that, so the sums stay this output's own share, and one rounding to T
// follows. Without kAcc the addend is not read: the instances that never
// take one (K1, K5b, K6a and K3's launches without addends) keep the code
// they had without it: a runtime test of acc alone cost K6a's forward 25 %
// on an H100.
template <int N, int R, bool kAcc, class T>
__device__ __forceinline__ void wg_epilogue(const WgParams<T>& p,
                                            const float (&acc)[R][N / 2],
                                            int oy, int ox0, int b, int n0,
                                            float (&s1)[N / 8][2],
                                            float (&s2)[N / 8][2]) {
  const int w = (threadIdx.x >> 5) & 3, l = threadIdx.x & 31;
  int oi[N / 8];
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
    oi[nb] = -1;
    const int col = n0 + 8 * nb;
    for (int o = 0; o < p.n_out; ++o)
      if (col >= p.out[o].off && col < p.out[o].off + p.out[o].c) oi[nb] = o;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = ox0 + 16 * w + (l >> 2) + 8 * h;
      if (oy + r >= p.oh || ox >= p.ow) continue;
      const size_t pix = ((size_t)b * p.oh + oy + r) * p.ow + ox;
#pragma unroll
      for (int nb = 0; nb < N / 8; ++nb) {
        if (oi[nb] < 0) continue;
        const WgOut<T>& o = p.out[oi[nb]];
        const int co = n0 + 8 * nb + 2 * (l & 3) - o.off;
        if (co >= o.c) continue;
        const bool pair = co + 1 < o.c;
        float v[2] = {acc[r][4 * nb + 2 * h], acc[r][4 * nb + 2 * h + 1]};
        float add[2] = {0.f, 0.f};
        if (kAcc && o.acc != nullptr)
          load2(o.acc + pix * o.c + co, add, pair, o.c % 2 == 0);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (k == 1 && !pair) break;
          if (o.act != kNone) {
            const float xi = __bfloat162float(o.x[pix * o.c + co + k]);
            const float sc = o.scale[co + k];
            const float pre = __fadd_rn(__fmul_rn(xi, sc), o.shift[co + k]);
            const float gm = v[k] * act_grad(pre, o.act);
            v[k] = gm * sc;
            s1[nb][k] += gm * xi;
            s2[nb][k] += gm;
          } else {
            if (p.bias != nullptr) v[k] += p.bias[co + k];
            if (p.relu) v[k] = fmaxf(v[k], 0.f);
            if (p.mom != nullptr) {
              s1[nb][k] += v[k];
              s2[nb][k] += v[k] * v[k];
            }
          }
          if (kAcc && o.acc != nullptr) v[k] += add[k];
        }
        store2(o.y + pix * o.c + co, v[0], v[1], pair, o.c % 2 == 0);
      }
    }
  }
}

// the block's column sums: (s1, s2) of every thread reduced over its warp's
// pixels by shuffles, then one shared atomic per column and warp into red
// (2N, zeroed)
template <int N>
__device__ __forceinline__ void wg_colsums(const float (&s1)[N / 8][2],
                                           const float (&s2)[N / 8][2],
                                           float* red) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float a = s1[nb][k], t = s2[nb][k];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        a += __shfl_xor_sync(kFull, a, off);
        t += __shfl_xor_sync(kFull, t, off);
      }
      if (l < 4) {
        atomicAdd(&red[8 * nb + 2 * l + k], a);
        atomicAdd(&red[N + 8 * nb + 2 * l + k], t);
      }
    }
  }
}

template <int N, bool kUp2, bool kPend, bool kAcc, class T>
__device__ __forceinline__ void wg_conv(const WgParams<T>& p) {
  using G = WgTile<N, kUp2>;
  static_assert(!(kPend && kUp2), "pending inputs are staged at fine size");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tiles_x = (p.ow + kSeg - 1) / kSeg;
  const int ox0 = (blockIdx.x % tiles_x) * kSeg;
  const int oy0 = (blockIdx.x / tiles_x) * G::kRows;
  const int b = blockIdx.y;
  const int n0 = blockIdx.z * N;
  const int nch = (p.c + kKC - 1) / kKC;
  const uint32_t sbase = smem_addr(smem);
  const bool vec = sizeof(T) == 2 && p.c % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(p.a) % 16 == 0;
  float* red = reinterpret_cast<float*>(smem + G::kStages * G::kStageBytes);
  for (int i = tid; i < 2 * N; i += G::kThreads) red[i] = 0.f;

  PendingStager<G::kAUnits, G::kSlots, G::kThreads> pend;
  if (kPend && nch > 0) pend.load(p, 0, b, oy0, ox0);

  // stage chunk ch (channels [16 ch, 16 ch + 16)) into ring slot s and
  // commit; with kPend, A from the registers (which then take chunk ch + 1)
  auto stage = [&](int ch, int s) {
    const uint32_t sa = sbase + s * G::kStageBytes;
    unsigned char* pa = smem + s * G::kStageBytes;
    if constexpr (kPend) {
      pend.store(p, pa);
    } else {
      for (int i = tid; i < 2 * G::kAUnits; i += G::kThreads) {
        const int g = i / G::kAUnits;
        const int u = i - g * G::kAUnits;
        const int row = u / (G::kPlanes * G::kSlots);
        const int rem = u - row * (G::kPlanes * G::kSlots);
        const int plane = rem / G::kSlots;
        const int slot = rem - plane * G::kSlots;
        const int y = kUp2 ? 2 * oy0 - 1 + row : oy0 - 1 + row;
        const int x = kUp2 ? 2 * (ox0 + slot) - plane : ox0 - 1 + slot;
        const int cb = ch * kKC + 8 * g;
        const bool ok = y >= 0 && y < p.ah && x >= 0 && x < p.aw && cb < p.c;
        const T* src =
            p.a + (ok ? (((size_t)b * p.ah + y) * p.aw + x) * p.c + cb : 0);
        if (vec) {
          cp_async16(sa + i * 16, src, ok);
        } else {
          __align__(16) __nv_bfloat16 o[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            o[k] = (ok && cb + k < p.c) ? to_bf16(src[k])
                                        : __float2bfloat16_rn(0.f);
          *reinterpret_cast<uint4*>(pa + i * 16) =
              *reinterpret_cast<const uint4*>(o);
        }
      }
      if (!vec) fence_proxy_async();  // stores the tensor cores will read
    }
    const uint32_t sb = sa + G::kABytes;
    const __nv_bfloat16* w = p.wt + (size_t)ch * G::kTaps * 2 * p.np * 8;
    for (int i = tid; i < G::kTaps * 2 * N; i += G::kThreads) {
      const int tg = i / N;
      cp_async16(sb + i * 16, w + ((size_t)tg * p.np + n0 + i - tg * N) * 8,
                 true);
    }
    cp_async_commit();
    if (kPend && ch + 1 < nch) pend.load(p, ch + 1, b, oy0, ox0);
  };

  float acc[G::kWgRows][N / 2];
#pragma unroll
  for (int r = 0; r < G::kWgRows; ++r)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[r][j] = 0.f;

  // chunks 0 .. kStages-2 in flight; one commit group per chunk (empty
  // past the last), so waiting for all but kStages-2 groups lands chunk ch
  for (int ch = 0; ch < G::kStages - 1; ++ch) {
    if (ch < nch) stage(ch, ch);
    else cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    const int s = ch % G::kStages;
    cp_async_wait<G::kStages - 2>();
    __syncthreads();  // slot s is staged; the readers of the slot refilled
                      // below (chunk ch - 1's) are done
    const uint32_t sa = sbase + s * G::kStageBytes;
    const uint32_t sb = sa + G::kABytes;
    wgmma_fence();
#pragma unroll
    for (int r = 0; r < G::kWgRows; ++r) {
#pragma unroll
      for (int t = 0; t < G::kTaps; ++t) {
        const uint32_t ua = G::a_unit(wg * G::kWgRows + r, t);
        Wgmma<N>::template mma<0, 0>(
            acc[r], gmma_desc(sa + ua * 16, G::kAUnits * 16, 128),
            gmma_desc(sb + t * 2 * N * 16, N * 16, 128));
      }
    }
    wgmma_commit();
    const int next = ch + G::kStages - 1;
    if (next < nch) stage(next, next % G::kStages);
    else cp_async_commit();
    wgmma_wait_all();
#pragma unroll
    for (int r = 0; r < G::kWgRows; ++r) fence_regs<N / 2>(acc[r]);
  }

  // epilogue from registers; the block's column sums (dscale, dshift of the
  // outputs with a prologue; the moments) once per channel into memory
  bool sums = p.mom != nullptr;   // block-uniform
  for (int o = 0; o < p.n_out; ++o) sums = sums || p.out[o].act != kNone;
  float s1[N / 8][2], s2[N / 8][2];
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
    s1[nb][0] = s1[nb][1] = s2[nb][0] = s2[nb][1] = 0.f;
  wg_epilogue<N, G::kWgRows, kAcc>(p, acc, oy0 + wg * G::kWgRows, ox0, b, n0,
                                   s1, s2);
  if (sums) {
    wg_colsums<N>(s1, s2, red);
    __syncthreads();
    for (int i = tid; i < N; i += G::kThreads) {
      for (int o = 0; o < p.n_out; ++o) {
        const WgOut<T>& out = p.out[o];
        const int ch = n0 + i - out.off;
        if (ch < 0 || ch >= out.c) continue;
        if (out.act != kNone) {
          atomicAdd(&out.dscale[ch], red[i]);
          atomicAdd(&out.dshift[ch], red[N + i]);
        } else if (p.mom != nullptr) {
          atomicAdd(&p.mom[ch], red[i]);
          atomicAdd(&p.mom[out.c + ch], red[N + i]);
        }
      }
    }
  }
}

// kAcc: the instance that reads the outputs' addends (K3's `thru`)
template <int N, class T, bool kAcc>
__global__ void __launch_bounds__(WgTile<N, false>::kThreads)
    conv_wg_kernel(const WgParams<T> p) {
  wg_conv<N, false, false, kAcc>(p);
}

template <int N, bool kAcc>
__global__ void __launch_bounds__(WgTile<N, true>::kThreads)
    conv_up2_dx_kernel(const WgParams<__nv_bfloat16> p) {
  wg_conv<N, true, false, kAcc>(p);
}

// two blocks a SM at N <= 32 (their 256 threads at most 128 registers)
template <int N>
__global__ void __launch_bounds__(WgTile<N, false>::kThreads, N < 64 ? 2 : 1)
    pending_conv_kernel(const WgParams<__nv_bfloat16> p) {
  wg_conv<N, false, true, false>(p);
}

// a Hopper kernel's launch attributes: its dynamic shared memory, and the
// largest shared-memory carveout, so that as many blocks fit a SM as the
// registers allow
template <class K>
cudaError_t hopper_attrs(K kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// resident blocks per SM of a Hopper kernel at its launch attributes (the
// occupancy calculator on the current card), -1 on an error
template <class K>
int blocks_per_sm(K kernel, int threads, int smem) {
  int n = -1;
  if (hopper_attrs(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

// *sms: the SM count of device dev, asked once a device in a process
inline cudaError_t device_sms(int dev, int* sms) {
  static std::mutex mu;
  static int memo[64] = {};
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (memo[dev] == 0) {
    const cudaError_t e =
        cudaDeviceGetAttribute(&memo[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      memo[dev] = 0;
      return e;
    }
  }
  *sms = memo[dev];
  return cudaSuccess;
}

// Resident blocks a SM of a kernel of `threads` threads at its launch
// attributes (hopper_attrs, set just before) and dynamic shared memory on
// device dev: the occupancy calculator is asked once per (kernel, shared
// memory, device) in a process, a host cost a launch then no longer pays.
template <class K>
cudaError_t resident_per_sm(K kernel, int threads, int smem, int dev,
                            int* per_sm) {
  struct Entry {
    const void* fn;
    int smem, dev, per_sm;
  };
  static std::mutex mu;
  static Entry memo[32];
  static int n = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i)
    if (memo[i].fn == fn && memo[i].smem == smem && memo[i].dev == dev) {
      *per_sm = memo[i].per_sm;
      return cudaSuccess;
    }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, threads, smem);
  if (e == cudaSuccess && n < 32) memo[n++] = Entry{fn, smem, dev, *per_sm};
  return e;
}

template <int N, bool kUp2, class K, class T>
cudaError_t launch_wg(K kernel, const WgParams<T>& p, cudaStream_t s) {
  using G = WgTile<N, kUp2>;
  cudaError_t e = hopper_attrs(kernel, G::kSmem);
  if (e != cudaSuccess) return e;
  const int tiles = ((p.ow + kSeg - 1) / kSeg) *
                    ((p.oh + G::kRows - 1) / G::kRows);
  kernel<<<dim3(tiles, p.n, p.np / N), G::kThreads, G::kSmem, s>>>(p);
  return cudaGetLastError();
}

// whether any output of p has an addend
template <class T>
bool has_acc(const WgParams<T>& p) {
  for (int o = 0; o < p.n_out; ++o)
    if (p.out[o].acc != nullptr) return true;
  return false;
}

template <bool kAcc, class T>
cudaError_t launch_conv_wg_at(int ntile, const WgParams<T>& p,
                              cudaStream_t s) {
  switch (ntile) {
    case 16: return launch_wg<16, false>(conv_wg_kernel<16, T, kAcc>, p, s);
    case 32: return launch_wg<32, false>(conv_wg_kernel<32, T, kAcc>, p, s);
    case 64: return launch_wg<64, false>(conv_wg_kernel<64, T, kAcc>, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// the stride-1 conv at output-channel tile ntile (16, 32 or 64); the
// instance that reads addends only where an output has one (bf16: K3)
template <class T>
cudaError_t launch_conv_wg(int ntile, const WgParams<T>& p, cudaStream_t s) {
  if (p.np % ntile != 0) return cudaErrorInvalidValue;
  if (!has_acc(p)) return launch_conv_wg_at<false>(ntile, p, s);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_conv_wg_at<true>(ntile, p, s);
  return cudaErrorInvalidValue;
}

// K1's conv over pending inputs (p.in, p.n_in; p.c = 16 * their chunks;
// T = bf16)
template <class T>
cudaError_t launch_pending_conv(int ntile, const WgParams<T>& p,
                                cudaStream_t s) {
  if (p.np % ntile != 0) return cudaErrorInvalidValue;
  switch (ntile) {
    case 16: return launch_wg<16, false>(pending_conv_kernel<16>, p, s);
    case 32: return launch_wg<32, false>(pending_conv_kernel<32>, p, s);
    case 64: return launch_wg<64, false>(pending_conv_kernel<64>, p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kAcc, class T>
cudaError_t launch_up2_dx_at(int ntile, const WgParams<T>& p, cudaStream_t s) {
  switch (ntile) {
    case 16: return launch_wg<16, true>(conv_up2_dx_kernel<16, kAcc>, p, s);
    case 32: return launch_wg<32, true>(conv_up2_dx_kernel<32, kAcc>, p, s);
    case 64: return launch_wg<64, true>(conv_up2_dx_kernel<64, kAcc>, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// the source-resolution dx of a lazily x2-upsampled input (T = bf16); the
// instance that reads the addend only where there is one
template <class T>
cudaError_t launch_up2_dx(int ntile, const WgParams<T>& p, cudaStream_t s) {
  if (p.np % ntile != 0) return cudaErrorInvalidValue;
  return has_acc(p) ? launch_up2_dx_at<true>(ntile, p, s)
                    : launch_up2_dx_at<false>(ntile, p, s);
}

// ----------------------------------------------------------- weight grad
// dW[t][ci][co] = sum over the output pixels p of a(p + t - 1)[ci] *
// dy(p)[co], a the prologue'd (bf16, lazily upsampled) input as the forward
// staged it: K3's dW over all of a node's inputs (K6b and K8b, one input
// and no prologue, have conv3x3.cu's conv3x3_dw_kernel).
// The inputs' channels, each padded to a multiple of 8, are the rows of dW
// one after another; block: x = one 64-row chunk of them (wgmma M = 64 input
// channels, of one input or several narrow ones: a node's four 16-channel
// inputs fill one chunk; rows past the last input are zero), y = a tile of N
// (16 or 32) output channels, z = a share of the pixel tiles of 4 x 64
// output pixels. Three warpgroups: warpgroup ky owns taps (ky, 0..2) and
// keeps their 64 x N f32 sums in registers over the block's pixel tiles; per
// 16-pixel K step each issues 3 wgmma with both operands M- / N-major
// (channels contiguous, the staged pixels as K). The input tile is staged
// through registers (prologue, x2, bf16 rounding) into the next ring slot
// while the current slot's products run; dy by cp.async. The block's sums of
// the input's real channels reach dw by f32 atomics (order-dependent
// rounding, ~1e-6 relative).

constexpr int kDwWgThreads = 384;

template <class T>
struct DwWgParams {
  InputT<T> in[kMaxIn];     // chunk0: the input's first dW row, a multiple
  int n_in;                 // of 8 (its channels padded to 8 after it)
  const T* dy;              // (n, height, width, cout)
  int cout;
  float* dw;                // zeroed (9, cpad, np) f32, cpad = 64 * chunks
  int cpad, np, n, height, width;
};

template <int N>
struct DwTile {
  static constexpr int kRows = 4;   // output rows of a pixel tile
  static constexpr int kAUnits = (kRows + 2) * (kSeg + 2);  // per 8 ch
  static constexpr int kABytes = 8 * kAUnits * 16;
  static constexpr int kBUnits = kRows * kSeg;              // per 8 ch
  // input units (8 channels of one pixel) a thread stages per tile, at
  // most: all 8 groups' over 384 threads
  static constexpr int kPer =
      (8 * kAUnits + kDwWgThreads - 1) / kDwWgThreads;
  static constexpr int kBBytes = (N / 8) * kBUnits * 16;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = 2;  // ring slots
  static constexpr int kSmem = kStages * kStageBytes;
};

template <int N, class T>
__global__ void __launch_bounds__(kDwWgThreads)
    conv_dw_wg_kernel(const DwWgParams<T> p) {
  using G = DwTile<N>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int ky = tid >> 7;
  const int row0 = blockIdx.x * 64;   // the chunk's first dW row
  const int n0 = blockIdx.y * N;
  // 8-channel group g of the chunk holds dW rows row0 + 8g ..: channels
  // row - off of the input whose rows those are; returns how many are real
  // (0: a dead group) and that input and channel
  auto group_of = [&](int g, int& j, int& ch) {
    const int row = row0 + 8 * g;
    for (int jj = 0; jj < p.n_in; ++jj) {
      const int off = p.in[jj].chunk0;
      if (row >= off && row < off + p.in[jj].c) {
        j = jj;
        ch = row - off;
        return min(8, off + p.in[jj].c - row);
      }
    }
    return 0;
  };
  // A staging: the chunk's ng live groups share all threads: thread t owns
  // the (t % ng)-th live group (its input, prologue vectors in registers)
  // and every (384 / ng)-th unit of the tile; dead groups are zeroed in
  // both ring slots once
  unsigned livemask = 0;
  int j = 0, xc = 0;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    int jg, cg;
    if (group_of(g, jg, cg) > 0) livemask |= 1u << g;
  }
  const int ng = __popc(livemask);
  const int rank = tid % ng;
  int grp = 0;
  for (int g = 0, r = 0; g < 8; ++g)
    if (livemask >> g & 1u) {
      if (r == rank) grp = g;
      ++r;
    }
  group_of(grp, j, xc);
  const InputT<T> in = p.in[j];
  const int gstride = kDwWgThreads / ng;
  const int gl = tid / ng;
  const bool xvec =
      in.c % 8 == 0 && reinterpret_cast<uintptr_t>(in.x) % 16 == 0;
  const bool dvec = sizeof(T) == 2 && p.cout % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(p.dy) % 16 == 0;
  const uint32_t sbase = smem_addr(smem);
  const int tiles_x = (p.width + kSeg - 1) / kSeg;
  const int tiles_y = (p.height + G::kRows - 1) / G::kRows;
  const int total = p.n * tiles_y * tiles_x;
  const int per = (G::kAUnits + gstride - 1) / gstride;
  float sc[8], sh[8];
  prologue_vec8(in, xc, sc, sh);
  for (int i = tid; i < 8 * G::kAUnits; i += kDwWgThreads)
    if (!(livemask >> (i / G::kAUnits) & 1u))
      for (int s = 0; s < G::kStages; ++s)
        *reinterpret_cast<uint4*>(smem + s * G::kStageBytes + i * 16) =
            make_uint4(0, 0, 0, 0);
  fence_proxy_async();

  // The input tile through registers, one tile ahead: load_a issues the
  // loads of tile tt into raw (an f32 input would be rounded as it is
  // loaded), store_a applies the prologue and stores them into
  // ring slot s an iteration later, so their latency hides behind a whole
  // iteration. At most G::kPer units a thread.
  uint4 raw[G::kPer];
  unsigned live = 0;
  auto load_a = [&](int tt) {
    const int b = tt / (tiles_y * tiles_x);
    const int r = tt - b * (tiles_y * tiles_x);
    const int py0 = (r / tiles_x) * G::kRows;
    const int px0 = (r % tiles_x) * kSeg;
    live = 0;
#pragma unroll
    for (int q = 0; q < G::kPer; ++q) {
      const int u = gl + q * gstride;
      const int yy = py0 - 1 + u / (kSeg + 2);
      const int xx = px0 - 1 + u % (kSeg + 2);
      raw[q] = make_uint4(0, 0, 0, 0);
      if (gl < gstride && q < per && u < G::kAUnits && yy >= 0 &&
          yy < p.height && xx >= 0 && xx < p.width) {
        live |= 1u << q;
        raw[q] = fetch8(in, b, p.height, p.width, yy, xx, xc, xvec);
      }
    }
  };
  auto store_a = [&](int s) {
    if (gl >= gstride) return;
    unsigned char* pa = smem + s * G::kStageBytes;
#pragma unroll
    for (int q = 0; q < G::kPer; ++q) {
      const int u = gl + q * gstride;
      if (q >= per || u >= G::kAUnits) continue;
      if (live >> q & 1u)
        prologue8(reinterpret_cast<__nv_bfloat16*>(&raw[q]), sc, sh, in.act);
      *reinterpret_cast<uint4*>(pa + (grp * G::kAUnits + u) * 16) = raw[q];
    }
    fence_proxy_async();  // stores the tensor cores will read
  };
  // dy of tile tt into ring slot s by cp.async (through registers when
  // it needs converting)
  auto stage_b = [&](int tt, int s) {
    const int b = tt / (tiles_y * tiles_x);
    const int r = tt - b * (tiles_y * tiles_x);
    const int py0 = (r / tiles_x) * G::kRows;
    const int px0 = (r % tiles_x) * kSeg;
    const uint32_t sb = sbase + s * G::kStageBytes + G::kABytes;
    unsigned char* pb = smem + s * G::kStageBytes + G::kABytes;
    for (int i = tid; i < (N / 8) * G::kBUnits; i += kDwWgThreads) {
      const int g = i / G::kBUnits;
      const int u = i - g * G::kBUnits;
      const int yy = py0 + u / kSeg;
      const int xx = px0 + u % kSeg;
      const int cb = n0 + 8 * g;
      const bool ok = yy < p.height && xx < p.width && cb < p.cout;
      const size_t at =
          ((size_t)(b * p.height + yy) * p.width + xx) * p.cout + cb;
      const T* src = p.dy + (ok ? at : 0);
      if (dvec) {
        cp_async16(sb + i * 16, src, ok);
      } else {
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o[k] = (ok && cb + k < p.cout) ? to_bf16(src[k])
                                         : __float2bfloat16_rn(0.f);
        *reinterpret_cast<uint4*>(pb + i * 16) =
            *reinterpret_cast<const uint4*>(o);
      }
    }
    if (!dvec) fence_proxy_async();
    cp_async_commit();
  };

  float acc[3][N / 2];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int k = 0; k < N / 2; ++k) acc[t][k] = 0.f;

  const int step = gridDim.z;
  if (blockIdx.z < total) {
    load_a(blockIdx.z);
    store_a(0);
    stage_b(blockIdx.z, 0);
    if (blockIdx.z + step < total) load_a(blockIdx.z + step);
  }
  int s = 0;
  for (int tt = blockIdx.z; tt < total; tt += step, s ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // slot s holds tile tt; slot s^1's readers are done
    const uint32_t sa = sbase + s * G::kStageBytes;
    const uint32_t sb = sa + G::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < G::kRows * kSeg / 16; ++kc) {
      const int rr = kc / (kSeg / 16), px = (kc % (kSeg / 16)) * 16;
      const uint64_t db =
          gmma_desc(sb + (rr * kSeg + px) * 16, 128, G::kBUnits * 16);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const uint32_t ua = (rr + ky) * (kSeg + 2) + px + kx;
        Wgmma<N>::template mma<1, 1>(
            acc[kx], gmma_desc(sa + ua * 16, 128, G::kAUnits * 16), db);
      }
    }
    wgmma_commit();
    if (tt + step < total) {
      store_a(s ^ 1);
      stage_b(tt + step, s ^ 1);
      if (tt + 2 * step < total) load_a(tt + 2 * step);
    }
    wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < 3; ++t) fence_regs<N / 2>(acc[t]);
  }

  // accumulator k of tap (ky, kx): row 16*w + lane/4 + 8*((k/2)%2) of the
  // chunk (group 2*w + (k/2)%2), output channel 8*(k/4) + 2*(lane%4) + k%2;
  // only the real channels' rows are added
  const int w = (tid >> 5) & 3, l = tid & 31;
  int jd, cd;
  const int real[2] = {group_of(2 * w, jd, cd), group_of(2 * w + 1, jd, cd)};
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float* out =
        p.dw + ((size_t)(ky * 3 + kx) * p.cpad + row0) * p.np + n0;
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const int h = (k >> 1) & 1;
      const int ci = 16 * w + (l >> 2) + 8 * h;
      const int co = 8 * (k >> 2) + 2 * (l & 3) + (k & 1);
      if ((l >> 2) < real[h])
        atomicAdd(&out[(size_t)ci * p.np + co], acc[kx][k]);
    }
  }
}

template <int N, class T>
cudaError_t launch_dw_wg_n(const DwWgParams<T>& p, int n_chunks,
                           cudaStream_t stream) {
  constexpr int smem = DwTile<N>::kSmem;
  cudaError_t e = hopper_attrs(conv_dw_wg_kernel<N, T>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = p.n * ((p.height + DwTile<N>::kRows - 1) /
                           DwTile<N>::kRows) * ((p.width + kSeg - 1) / kSeg);
  const int xy = n_chunks * (p.np / N);
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  // about four blocks a SM, each with 4 or more pixel tiles (a block's
  // partial sums cost 9 * c * N atomics)
  int split = (4 * sms + xy - 1) / xy;
  if (split > (tiles + 3) / 4) split = (tiles + 3) / 4;
  if (split < 1) split = 1;
  conv_dw_wg_kernel<N, T><<<dim3(n_chunks, p.np / N, split), kDwWgThreads,
                            smem, stream>>>(p);
  return cudaGetLastError();
}

// the weight gradient at output-channel tile ntile (16 or 32: wider tiles
// measured slower, their accumulators crowding out the staging registers)
// over n_chunks 64-row chunks of the inputs' channels
template <class T>
cudaError_t launch_dw_wg(int ntile, const DwWgParams<T>& p, int n_chunks,
                         cudaStream_t s) {
  if (p.np % ntile != 0 || p.cpad != 64 * n_chunks)
    return cudaErrorInvalidValue;
  switch (ntile) {
    case 16: return launch_dw_wg_n<16>(p, n_chunks, s);
    case 32: return launch_dw_wg_n<32>(p, n_chunks, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- dy prep
// The moments cotangent folded into dy: dye = dy + dm0 + 2*y*dm1 (every
// pixel of a stride-1 or stride-2 output is valid), stored bf16 when
// dmom != null; dbias += sum of the f32 dye when dbias != null. A thread
// takes V consecutive channels of a pixel at a time (V = 8: 16-byte loads
// and stores, when c is a multiple of 8) with a grid stride that is a
// multiple of c / V, so it keeps the same V channels and V register sums;
// a block adds its sums in shared memory, then once per channel to dbias.

template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* src, float* v) {
  if constexpr (V == 8) load8(src, v);
  else v[0] = __bfloat162float(src[0]);
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* dst, const float* v) {
  __align__(16) __nv_bfloat16 o[V];
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = __float2bfloat16_rn(v[k]);
  if constexpr (V == 8)
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
  else dst[0] = o[0];
}

template <int V>
__global__ void __launch_bounds__(256) dy_prep_kernel(
    const __nv_bfloat16* dy, const __nv_bfloat16* y, const float* dmom,
    __nv_bfloat16* dye, float* dbias, long long units, int cv) {
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int c = cv * V;
  const int c0 = (int)(start % cv) * V;
  float m0[V], m1[V], sum[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    m0[k] = dmom != nullptr ? dmom[c0 + k] : 0.f;
    m1[k] = dmom != nullptr ? dmom[c + c0 + k] : 0.f;
    sum[k] = 0.f;
  }
  for (long long u = start; u < units; u += stride) {
    float g[V];
    load_v<V>(dy + u * V, g);
    if (dmom != nullptr) {
      float yv[V];
      load_v<V>(y + u * V, yv);
#pragma unroll
      for (int k = 0; k < V; ++k) g[k] = g[k] + m0[k] + 2.f * yv[k] * m1[k];
      store_v<V>(dye + u * V, g);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) sum[k] += g[k];
  }
  if (dbias != nullptr) {   // the block's sums in shared memory first
    extern __shared__ float red[];   // (c,)
    for (int i = threadIdx.x; i < c; i += blockDim.x) red[i] = 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < V; ++k) atomicAdd(&red[c0 + k], sum[k]);
    __syncthreads();
    for (int i = threadIdx.x; i < c; i += blockDim.x)
      atomicAdd(&dbias[i], red[i]);
  }
}

cudaError_t launch_dy_prep(const void* dy, const void* y, const void* dmom,
                           void* dye, void* dbias, long long total, int c,
                           cudaStream_t s) {
  if (dmom == nullptr && dbias == nullptr) return cudaSuccess;
  const bool vec =
      c % 8 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dye) % 16 == 0;
  const int v = vec ? 8 : 1;
  const int cv = c / v;
  const long long units = total / v;
  long long blocks = (units + 255) / 256;
  if (blocks > 2112) blocks = 2112;           // 16 a SM
  blocks = ((blocks + cv - 1) / cv) * cv;    // stride a multiple of cv
  const auto* d = static_cast<const __nv_bfloat16*>(dy);
  const auto* yy = static_cast<const __nv_bfloat16*>(y);
  const auto* m = static_cast<const float*>(dmom);
  auto* o = static_cast<__nv_bfloat16*>(dye);
  auto* b = static_cast<float*>(dbias);
  const int smem = dbias != nullptr ? c * 4 : 0;
  if (vec)
    dy_prep_kernel<8><<<(int)blocks, 256, smem, s>>>(d, yy, m, o, b, units, cv);
  else
    dy_prep_kernel<1><<<(int)blocks, 256, smem, s>>>(d, yy, m, o, b, units, cv);
  return cudaGetLastError();
}

}  // namespace
