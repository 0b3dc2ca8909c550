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
// accumulator (bias included) before the bf16 rounding.
//
// Runs on common.cuh's Hopper conv mainloop (pending_conv_kernel = wg_conv
// with kPend): M = one 64-pixel output row segment, N = 16, 32 or 64 output
// channels a block (grid z tiles the rest), wgmma m64nNk16 from shared
// memory through no-swizzle descriptors, the K loop over the 16-channel
// chunks of all the node's inputs in concat order (each input's channels
// padded to 16 a chunk; the tap pack is over that concat). The A tile of
// a chunk is staged through registers one chunk ahead (prologue, lazy x2,
// bf16 rounding while it is stored into the next ring slot; the stores
// fenced with fence.proxy.async), the chunk's taps by cp.async, in a ring
// of 2 slots (3 at N = 64) so that one chunk's products run while the next
// chunk's loads are in flight. Bias and moments run in the register
// epilogue; the moments are reduced over the block by shuffles and shared
// memory and reach mom by one f32 atomic per channel and block.
//
// Bound on an H100: the UNet++ decoder convs move ~50-400 bytes of input and
// output per output pixel for 2*9*Cin*Cout operations, so at bf16 tensor-core
// rates most launches sit below the 295 op/byte ridge (memory-bound) and the
// 64x80 ones with Cin >= 300 above it. Each block reads its input tile once
// per output-channel tile (the 1-pixel halo and the lazy inputs' repeats
// come from L1/L2).

#include "common.cuh"

// Host entry (plain C interface, bound with ctypes). Per-input arrays have
// n_in entries. wt: the tap pack (chunks, 9, 2, np, 8) bf16 over the
// inputs' channels, each input's padded to a multiple of 16, in concat
// order; np is cout padded to a multiple of ntile (16, 32 or 64); bias:
// (cout,) f32 or null; mom: a zeroed (2, cout) f32 buffer or null. Returns
// a cudaError_t.
extern "C" int mmr_fused_conv(int n_in, const void* const* xs,
                              const void* const* scales,
                              const void* const* shifts, const int* cs,
                              const int* acts, const int* ups, const void* wt,
                              const void* bias, void* y, void* mom, int n,
                              int height, int width, int cout, int np,
                              int ntile, void* stream) {
  if (n_in < 1 || n_in > kMaxIn) return (int)cudaErrorInvalidValue;
  WgParams<__nv_bfloat16> p{};
  int chunk = 0;
  for (int j = 0; j < n_in; ++j) {
    p.in[j] = Input{static_cast<const __nv_bfloat16*>(xs[j]),
                    static_cast<const float*>(scales[j]),
                    static_cast<const float*>(shifts[j]), cs[j], acts[j],
                    ups[j], chunk};
    chunk += (cs[j] + kKC - 1) / kKC;
  }
  p.n_in = n_in;
  p.c = chunk * kKC;
  p.ah = height;
  p.aw = width;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.np = np;
  p.n = n;
  p.oh = height;
  p.ow = width;
  p.bias = static_cast<const float*>(bias);
  p.mom = static_cast<float*>(mom);
  p.out[0] = WgOut<__nv_bfloat16>{static_cast<__nv_bfloat16*>(y), nullptr,
                                  nullptr, nullptr, nullptr, nullptr, cout,
                                  kNone, 0};
  p.n_out = 1;
  return (int)launch_pending_conv(ntile, p,
                                  static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory in bytes (what = 0) or resident blocks per SM at
// the launch's attributes (what = 1) of pending_conv_kernel at ntile 16, 32
// or 64 (kind is ignored). Returns -1 otherwise.
extern "C" int mmr_fused_conv_info(int what, int /*kind*/, int ntile) {
  switch (ntile) {
    case 16: return what ? blocks_per_sm(pending_conv_kernel<16>,
                                         WgTile<16, false>::kThreads,
                                         WgTile<16, false>::kSmem)
                         : WgTile<16, false>::kSmem;
    case 32: return what ? blocks_per_sm(pending_conv_kernel<32>,
                                         WgTile<32, false>::kThreads,
                                         WgTile<32, false>::kSmem)
                         : WgTile<32, false>::kSmem;
    case 64: return what ? blocks_per_sm(pending_conv_kernel<64>,
                                         WgTile<64, false>::kThreads,
                                         WgTile<64, false>::kSmem)
                         : WgTile<64, false>::kSmem;
    default: return -1;
  }
}
