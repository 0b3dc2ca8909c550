// The narrow-channel 3x3 conv tile shared by K5a (head_loss.cu:
// narrow_head_kernel) and K8a (conv3x3.cu: narrow_conv_kernel), and the
// staging pieces it shares with K6b/K8b's dW kernel (conv3x3.cu): mbarriers,
// TMA boxes of NHWC bf16 tensors (nhwc_map), 4-byte cp.async and the choice
// of how an operand that TMA cannot take reaches shared memory
// (dw_stage_mode, dw_stage_row).
//
// The tile: a stride-1 SAME 3x3 conv of an NHWC input with cin <= 32
// channels a ring stage (K5a: any cin, in 32-channel chunks, each a ring
// stage of its own) into N <= 32 output channels (NF = N / 8 mma.sync n
// fragments), f32 sums.
// - Persistent blocks: the grid is the card's SM count x the resident
//   blocks a SM (occupancy at the kernel's attributes, set on every launch;
//   narrow_grid), never a count of tiles. Block i walks the pixel tiles i,
//   i + grid, ... of kRows output rows x 64 pixels, so neighbouring blocks
//   take neighbouring tiles at once and share their halo rows in L2.
// - The taps of the whole shape (mma.sync B fragments, the wrapper's pack:
//   4.6 KB at 16 -> 16) are copied into shared memory once a block.
// - A ring of kStages halo tiles ((kRows + 2) x 66 pixels, channel-split:
//   one 16-byte row = 8 channels of a pixel, consecutive pixels in
//   consecutive rows, each 8-channel group in its own plane) over the
//   block's pixel tiles, not over channel chunks: the next tiles are in
//   flight while this tile's products and epilogue run. bf16 with channels
//   a multiple of 8 comes by TMA (a box a group, zero outside the tensor,
//   an mbarrier a stage counting the bytes), other even channel counts by
//   4-byte cp.async, odd ones and f32 storage through registers (rounded to
//   bf16).
// - Products: mma.sync m16n8k16, M = 16 pixels of one output row, K = 16
//   channels, A by ldmatrix at the tap's whole-row offset into the staged
//   tile (nothing is copied a tap), B from the taps in shared memory. 8
//   warps; warp w keeps the 16-pixel column segment w % 4 of kMT
//   consecutive tile rows from (w / 4) * kMT. Each A fragment it loads (a
//   halo row at a column shift kx) serves the three taps (ky, kx) of three
//   of its rows, and each B fragment kMT products: shared-memory reads,
//   not the tensor cores, bound these narrow products.
// - Epilogues (the kernels'): from the accumulator fragments (lane 4g + q
//   holds pixels g, g + 8 at channels 8f + 2q, 8f + 2q + 1), through a
//   warp's slice of shared memory, then coalesced 16-byte stores of each
//   16-pixel run (warp_store_run: the ragged ends and unaligned starts of
//   odd channel counts element by element).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace {

// ------------------------------------------------------------ staging

// mbarrier and TMA (one thread issues a whole box; the barrier counts its
// bytes)
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// wait until the barrier's phase is no longer `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// box (8 channels, cols, rows, 1 image) of an NHWC map at coordinates
// (c, x, y, b) into shared memory at dst (zero outside the tensor)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int c, int x, int y,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c), "r"(x),
      "r"(y), "r"(b)
      : "memory");
}

// 4-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// four 8 x 8 bf16 matrices: lane l gives row l % 8 of matrix l / 8 (16
// bytes at addr); r[j] holds matrix j (.trans: transposed)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// how an operand reaches shared memory where TMA cannot take it
enum DwStage { kAsync4 = 0, kRegs8 = 1, kRegs = 2 };

// Channels [c, c + 8) of the pixel at element offset `at` (its channel c)
// of src into the 16-byte shared row dst, as bf16: zero where !inside or
// beyond the `left` channels from c that exist.
template <class T>
__device__ __forceinline__ void dw_stage_row(unsigned char* dst, const T* src,
                                             size_t at, int left, bool inside,
                                             int mode) {
  const bool valid = inside && left > 0;
  if constexpr (sizeof(T) == 2) {
    if (mode == kAsync4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool ok = valid && 2 * k < left;
        cp_async4(smem_addr(dst) + 4 * k, src + (ok ? at + 2 * k : 0), ok);
      }
      return;
    }
  }
  __align__(16) __nv_bfloat16 e[8];
  if (valid && mode == kRegs8) {
    load8_bf16(src + at, e);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      e[k] = valid && k < left ? to_bf16(src[at + k])
                               : __float2bfloat16_rn(0.f);
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(e);
}

// cuTensorMapEncodeTiled, looked up through the runtime (null when the
// CUDA installation lacks it)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      f = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }();
  return fn;
}

// *m: the TMA map of NHWC bf16 (n, h, w, c) at base, boxes of 8 channels x
// cols x rows x 1 image, zero outside the tensor. False where TMA cannot
// take it (c not a multiple of 8, base not 16-byte aligned, no encoder):
// the operand is staged by cp.async instead.
bool nhwc_map(CUtensorMap* m, const void* base, int n, int h, int w, int c,
              int cols, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr || c % 8 != 0 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {2ull * c, 2ull * c * w, 2ull * c * w * h};
  const cuuint32_t box[4] = {8, (cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// how an operand at `ptr` with c channels a pixel reaches shared memory
// where TMA cannot take it
template <class T>
int dw_stage_mode(const void* ptr, int c) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  if (sizeof(T) == 2) return c % 2 == 0 && a % 4 == 0 ? kAsync4 : kRegs;
  return c % 8 == 0 && a % 16 == 0 ? kRegs8 : kRegs;
}

// ------------------------------------------------------ the narrow tile

constexpr int kNarrowCols = 64;      // output pixels of a tile row
constexpr int kNarrowThreads = 256;  // 8 warps

// G8: 8-channel groups a ring stage (2: cin <= 16, 4: <= 32 or K5a's
// 32-channel chunks); NF: n fragments (N = 8 * NF output channels, 16 or
// 32). Tiles are as tall as two blocks a SM allow (staging bounds these
// shapes and a halo row is staged again by the tile below): 12 rows at 16
// -> 16 in 3 stages, else 8 rows (the accumulators of 32 output channels;
// the 4-group stage's bytes) in 3 or 2.
template <int G8, int NF>
struct NarrowCfg {
  static constexpr int kRows = (G8 == 2 && NF == 2) ? 12 : 8;
  static constexpr int kStages = G8 == 2 ? 3 : 2;
  static constexpr int kMT = kRows / 2;       // m-tiles a warp a tile
  static constexpr int kSlots = kNarrowCols + 2;
  static constexpr int kHalo = (kRows + 2) * kSlots;   // rows a group
  static constexpr int kGS = (kHalo + 7) / 8 * 8;      // their stride
  static constexpr int kStageBytes = 16 * G8 * kGS;    // 128-B multiple
  // the ring, its mbarriers, padded to 128 bytes
  static constexpr int kRing = (kStages * kStageBytes + 8 * kStages + 127) /
                               128 * 128;
  static constexpr int kK16 = G8 / 2;         // 16-channel K steps a stage
};

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the stores of `count` consecutive elements of src (shared memory, 16-byte
// aligned) to dst (device memory) by one warp: 16-byte stores between the
// first and the last 16-byte boundary, the elements outside them one by
// one; a 16-byte aligned dst takes 16-byte loads of src too
template <class T>
__device__ __forceinline__ void warp_store_run(T* dst, const T* src,
                                               int count, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int mis = (int)(reinterpret_cast<uintptr_t>(dst) & 15) /
                  (int)sizeof(T);
  int head = mis ? V - mis : 0;
  if (head > count) head = count;
  const int body = (count - head) / V;
  const int tail = head + body * V;
  if (lane < head) dst[lane] = src[lane];
  if (tail + lane < count) dst[tail + lane] = src[tail + lane];
  for (int k = lane; k < body; k += 32) {
    uint4 v;
    if (head == 0) {
      v = reinterpret_cast<const uint4*>(src)[k];
    } else {
      __align__(16) T e[V];
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = src[head + k * V + i];
      v = *reinterpret_cast<const uint4*>(e);
    }
    *reinterpret_cast<uint4*>(dst + head + k * V) = v;
  }
}

// The block's pixel-tile walk and ring, generic over the epilogue E:
//   e.setup()             the block's copies into shared memory (taps,
//                         vectors), made while the first tiles are in flight
//   E::kPrologue          apply E::prologue to each staged tile first
//   e.prologue(slot, ch0, ty0, tx0)   (all threads; then a barrier)
//   e.fetch(b, ty0, tx0)              before the tile's last products: loads
//                                     the epilogue needs, in flight meanwhile
//   e.tile(acc, b, ty0, tx0)          the tile's epilogue (all threads)
// p: x, cin, n, height, width, chunks, tiles_x, tiles_y, tiles, tma, mode.
template <int G8, int NF, class T, class P, class E>
__device__ __forceinline__ void narrow_walk(const P& p, const CUtensorMap& tx,
                                            unsigned char* smem,
                                            const unsigned char* taps, E& e) {
  using C = NarrowCfg<G8, NF>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t sbase = smem_addr(smem);
  const uint32_t bars = sbase + C::kStages * C::kStageBytes;
  const int per_image = p.tiles_y * p.tiles_x;
  const int mine = (p.tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x * p.chunks;   // ring units: tile x chunk
  auto where = [&](int q, int& b, int& ty0, int& tx0) {
    const int t = blockIdx.x + q / p.chunks * gridDim.x;
    b = t / per_image;
    const int r = t - b * per_image;
    ty0 = r / p.tiles_x * C::kRows;
    tx0 = r % p.tiles_x * kNarrowCols;
  };
  // unit q into ring slot q % kStages, its barrier
  auto stage = [&](int q) {
    int b, ty0, tx0;
    where(q, b, ty0, tx0);
    const int c0 = q % p.chunks * 8 * G8;
    unsigned char* slot = smem + q % C::kStages * C::kStageBytes;
    const uint32_t bar = bars + 8 * (q % C::kStages);
    if (p.tma) {
      if (tid == 0) {
        mbar_expect_tx(bar, 16 * G8 * C::kHalo);
#pragma unroll
        for (int grp = 0; grp < G8; ++grp)
          tma_load(smem_addr(slot) + 16 * grp * C::kGS, tx, bar, c0 + 8 * grp,
                   tx0 - 1, ty0 - 1, b);
      }
      return;
    }
    // consecutive threads take consecutive 8-channel groups of a pixel
#pragma unroll 2
    for (int i = tid; i < G8 * C::kHalo; i += kNarrowThreads) {
      const int u = i / G8, grp = i - u * G8;
      const int yy = ty0 - 1 + u / C::kSlots, xx = tx0 - 1 + u % C::kSlots;
      const int c = c0 + 8 * grp;
      const bool in = yy >= 0 && yy < p.height && xx >= 0 && xx < p.width;
      dw_stage_row(slot + 16 * (grp * C::kGS + u), p.x,
                   ((size_t)(b * p.height + yy) * p.width + xx) * p.cin + c,
                   p.cin - c, in, p.mode);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < C::kStages; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the barriers
#pragma unroll
  for (int q = 0; q < C::kStages - 1; ++q) {
    if (q < mine) stage(q);
    cp_async_commit();
  }
  e.setup();   // read after the first landing's barrier

  const int seg = warp & 3, r0 = (warp >> 2) * C::kMT;
  float acc[C::kMT][NF][4];
  for (int q = 0; q < mine; ++q) {
    // unit q has landed (its TMA boxes: the barrier's (q / kStages)-th
    // phase; this thread's cp.async groups; then every thread's), and the
    // slot refilled below (unit q - 1's) is read no more
    if (p.tma) mbar_wait(bars + 8 * (q % C::kStages), (q / C::kStages) & 1);
    cp_async_wait<C::kStages - 2>();
    __syncthreads();
    if (q + C::kStages - 1 < mine) stage(q + C::kStages - 1);
    cp_async_commit();
    const int ch = q % p.chunks;
    int b, ty0, tx0;
    where(q, b, ty0, tx0);
    unsigned char* slot = smem + q % C::kStages * C::kStageBytes;
    if constexpr (E::kPrologue) {
      e.prologue(slot, ch * 8 * G8, ty0, tx0);
      // generic stores a later TMA copy overwrites, and the products read
      fence_proxy_async();
      __syncthreads();
    }
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < C::kMT; ++i)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][f][k] = 0.f;
    }
    if (ch == p.chunks - 1) e.fetch(b, ty0, tx0);
    const uint32_t sa = smem_addr(slot);
#pragma unroll
    for (int ks = 0; ks < C::kK16; ++ks) {
      // lane l addresses row l % 8 of matrix l / 8: pixels + 8 (l / 8 % 2),
      // channel group 2 ks + l / 16
      const uint32_t arow =
          sa + 16 * ((2 * ks + (lane >> 4)) * C::kGS + 16 * seg + (lane & 7) +
                     8 * ((lane >> 3) & 1));
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // taps (0..2, kx): lane l's fragments of every n fragment, NF * 8
        // contiguous bytes a tap
        uint32_t bf[3][NF][2];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const uint4* bsrc = reinterpret_cast<const uint4*>(
              taps + (((ch * C::kK16 + ks) * 9 + 3 * ky + kx) * 32 + lane) *
                         NF * 8);
#pragma unroll
          for (int f = 0; f < NF; f += 2) {
            const uint4 v = bsrc[f / 2];
            bf[ky][f][0] = v.x, bf[ky][f][1] = v.y, bf[ky][f + 1][0] = v.z,
            bf[ky][f + 1][1] = v.w;
          }
        }
        // halo row r0 + hr at column shift kx is tap (ky, kx)'s A of the
        // warp's tile row r0 + hr - ky: loaded once for its three taps
#pragma unroll
        for (int hr = 0; hr < C::kMT + 2; ++hr) {
          uint32_t a[4];
          ldsm_x4(a, arow + 16 * ((r0 + hr) * C::kSlots + kx));
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            if (hr - ky < 0 || hr - ky >= C::kMT) continue;
#pragma unroll
            for (int f = 0; f < NF; ++f)
              mma16816(acc[hr - ky][f], a, bf[ky][f][0], bf[ky][f][1]);
          }
        }
      }
    }
    if (ch == p.chunks - 1) e.tile(acc, b, ty0, tx0);
  }
  cp_async_wait_all();
}

// out[0..6) = {blocks, blocks a SM, SMs, dynamic shared memory, tiles,
// tile rows}
struct NarrowGrid {
  int blocks, per_sm, sms, smem, tiles, rows;
};

// Set the kernel's launch attributes (on every launch) and size its
// persistent grid on the current card: the SM count x the resident blocks
// a SM at `smem` bytes, at most one block a tile.
template <class K>
cudaError_t narrow_grid(K kernel, int smem, int tiles, int rows,
                        NarrowGrid* g) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = device_sms(dev, &g->sms);
  if (e == cudaSuccess) e = hopper_attrs(kernel, smem);
  if (e == cudaSuccess)
    e = resident_per_sm(kernel, kNarrowThreads, smem, dev, &g->per_sm);
  if (e == cudaSuccess && g->per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  g->blocks = g->per_sm * g->sms < tiles ? g->per_sm * g->sms : tiles;
  if (g->blocks < 1) g->blocks = 1;
  g->smem = smem;
  g->tiles = tiles;
  g->rows = rows;
  return cudaSuccess;
}

inline void put_grid(const NarrowGrid& g, void* out) {
  int* o = static_cast<int*>(out);
  o[0] = g.blocks;
  o[1] = g.per_sm;
  o[2] = g.sms;
  o[3] = g.smem;
  o[4] = g.tiles;
  o[5] = g.rows;
}

}  // namespace
