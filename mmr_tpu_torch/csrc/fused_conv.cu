// K1: multi-input fused 3x3 stride-1 SAME convolution, forward, with the
// optional BN moments of its output.
//
// Replaces the TPU kernel `_fused_fwd_kernel` reached through
// `mmr_tpu/ops/pallas/packed_chain.py::fused_conv` (`_fwd_call`, the
// `pl.pallas_call` at packed_chain.py:1070).
//
// Computes, for NHWC bf16 tensors,
//     y = sum_j conv3x3_SAME(pro_j(x_j) [x2-nearest if up2x_j], W_j) + bias
// with pro_j(v) = act_j(s_j * v + t_j) evaluated in f32 and rounded to bf16
// before the multiply-accumulate (where the TPU kernel rounds), f32
// accumulation, and y stored raw in bf16. The concat of the inputs, the
// activated inputs and the upsampled inputs never reach device memory: each
// block reads the raw inputs and applies prologue and upsample while it
// stages its tile in shared memory. SAME padding is zero AFTER the prologue
// (act(0*s + t) != 0), and a lazy x2 input's border is the fine tensor's.
// With mom != null the kernel also emits the BN moments of y: mom[0][c] +=
// sum y, mom[1][c] += sum y^2 over the image, taken from the f32
// accumulator (bias included) before the bf16 rounding; each block reduces
// its pixels in shared memory and adds to mom with f32 atomics.
//
// Bound on an H100: the UNet++ decoder convs move ~50-400 bytes of input and
// output per output pixel for 2*9*Cin*Cout operations, so at bf16 tensor-core
// rates most launches sit below the 295 op/byte ridge (memory-bound) and the
// 64x80 ones with Cin >= 300 above it. The design reads every input pixel
// from device memory once per block (the 1-pixel halo is re-read from L2)
// and runs the products on the tensor cores (WMMA bf16 m16n16k16, f32
// accumulators in registers): one block = 8 output rows x 16 pixels x up to
// 128 output channels, one warp per row, input channels in chunks of 16.
// Tile loads are not yet overlapped with the products (no cp.async/TMA
// pipeline, no wgmma): that is later work.

#include "common.cuh"

namespace {

struct Params {
  Input in[kMaxIn];
  int n_in;
  const __nv_bfloat16* wt;  // (chunks, 9, kKC, np), zero-padded
  const float* bias;        // (cout,) or null
  __nv_bfloat16* y;         // (n, height, width, cout)
  float* mom;               // (2, cout) or null
  int n, height, width, cout, np;
};

template <int NF>
constexpr int fwd_smem_bytes() {
  return kTilePix * kKC * 2 + 9 * kKC * (NF * 16 + 8) * 2 + kTH * 256 * 4 +
         2 * NF * 16 * 4;
}

template <int NF>
__global__ void __launch_bounds__(kThreads) fused_conv_kernel(const Params p) {
  constexpr int kN = NF * 16;
  constexpr int kNS = kN + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = tile + kTilePix * kKC;
  float* stage = reinterpret_cast<float*>(wsm + 9 * kKC * kNS);
  float* msm = stage + kTH * 256;  // (2, kN) block moments

  const int tiles_x = (p.width + kTW - 1) / kTW;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int b = blockIdx.y;
  const int n0 = blockIdx.z * kN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 2 * kN; i += blockDim.x) msm[i] = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int j = 0; j < p.n_in; ++j) {
    const Input in = p.in[j];
    const int nch = (in.c + kKC - 1) / kKC;
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();  // previous chunk's products are done with smem
      load_tile(in, b, p.height, p.width, ty0, tx0, ch * kKC, tile);
      load_weights(p.wt + (size_t)(in.chunk0 + ch) * 9 * kKC * p.np, p.np,
                   n0, kN, wsm, kNS);
      __syncthreads();
      mma_chunk<NF>(tile, wsm, kNS, warp, acc);
    }
  }

  // epilogue: per-warp 16x16 staging, + bias, round to bf16, masked store;
  // moments from the f32 values (lanes with the same channel group reduce
  // by shuffles, then one shared atomic per channel and warp)
  float* st = stage + warp * 256;
  const int oy = ty0 + warp;
  const int px = lane >> 1;
  const int cg = (lane & 1) * 8;
  const int ox = tx0 + px;
  const bool inside = oy < p.height && ox < p.width;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(st, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    const int co = n0 + f * 16 + cg;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = st[px * 16 + cg + k];
      if (p.bias != nullptr && co + k < p.cout) v[k] += p.bias[co + k];
    }
    if (inside && co < p.cout) {
      __nv_bfloat16* dst =
          p.y + ((size_t)(b * p.height + oy) * p.width + ox) * p.cout + co;
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(v[k]);
      if (co + 8 <= p.cout && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
      } else {
        for (int k = 0; k < 8 && co + k < p.cout; ++k) dst[k] = o[k];
      }
    }
    if (p.mom != nullptr) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float s1 = (inside && co + k < p.cout) ? v[k] : 0.f;
        float s2 = s1 * s1;
#pragma unroll
        for (int off = 2; off < 32; off <<= 1) {
          s1 += __shfl_xor_sync(kFull, s1, off);
          s2 += __shfl_xor_sync(kFull, s2, off);
        }
        if (lane < 2) {
          atomicAdd(&msm[f * 16 + cg + k], s1);
          atomicAdd(&msm[kN + f * 16 + cg + k], s2);
        }
      }
    }
    __syncwarp();
  }
  if (p.mom != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < kN; i += blockDim.x) {
      const int co = n0 + i;
      if (co < p.cout) {
        atomicAdd(&p.mom[co], msm[i]);
        atomicAdd(&p.mom[p.cout + co], msm[kN + i]);
      }
    }
  }
}

template <int NF>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<NF>();
  cudaError_t e = cudaFuncSetAttribute(
      fused_conv_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const int tiles = ((p.width + kTW - 1) / kTW) * ((p.height + kTH - 1) / kTH);
  const dim3 grid(tiles, p.n, p.np / (NF * 16));
  fused_conv_kernel<NF><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Host entry (plain C interface, bound with ctypes). Per-input arrays have
// n_in entries. np is cout padded to a multiple of 16*nf, nf in {1,2,4,8}
// the 16-channel output fragments per block; mom is a zeroed (2, cout) f32
// buffer or null. Returns a cudaError_t.
extern "C" int mmr_fused_conv(int n_in, const void* const* xs,
                              const void* const* scales,
                              const void* const* shifts, const int* cs,
                              const int* acts, const int* ups, const void* wt,
                              const void* bias, void* y, void* mom, int n,
                              int height, int width, int cout, int np, int nf,
                              void* stream) {
  if (n_in < 1 || n_in > kMaxIn || np % (16 * nf) != 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  int chunk = 0;
  for (int j = 0; j < n_in; ++j) {
    p.in[j].x = static_cast<const __nv_bfloat16*>(xs[j]);
    p.in[j].scale = static_cast<const float*>(scales[j]);
    p.in[j].shift = static_cast<const float*>(shifts[j]);
    p.in[j].c = cs[j];
    p.in[j].act = acts[j];
    p.in[j].up2x = ups[j];
    p.in[j].chunk0 = chunk;
    chunk += (cs[j] + kKC - 1) / kKC;
  }
  p.n_in = n_in;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.mom = static_cast<float*>(mom);
  p.n = n;
  p.height = height;
  p.width = width;
  p.cout = cout;
  p.np = np;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1: return (int)launch<1>(p, s);
    case 2: return (int)launch<2>(p, s);
    case 4: return (int)launch<4>(p, s);
    case 8: return (int)launch<8>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
