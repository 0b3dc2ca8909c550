// K3: the backward of K1 (multi-input fused 3x3 stride-1 SAME conv).
//
// Replaces the TPU kernel `_fused_bwd_kernel` (packed_chain.py:693)
// reached through `_bwd_call` (packed_chain.py:1090, the `pl.pallas_call`
// at :1207).
//
// Given the forward's inputs (raw bf16 x_j with their pending prologue and
// lazy-x2 flags), weights W_j, the stored output y, the output gradient dy
// and the moments cotangent dmom (2, Cout), computes
//   dye     = dy + dm0 + 2*y*dm1          (the moments' share of dy)
//   dbias   = sum dye                     (f32, when the conv has a bias)
//   dW_j    = sum_p a_j(p + tap - 1) (x) dye(p)    (f32, HWIO)
//   dx_j    = prologue_bwd(conv3x3^T(dye, W_j))    (bf16; at source
//             resolution for a lazy x2 input)
//   dscale_j, dshift_j = sums of gm*x and gm, gm = g * act'(s*x + t)
// with a_j the bf16 prologue'd input the forward staged and dye rounded to
// bf16 before both products (as the TPU kernel rounds); f32 accumulation.
// With an addend dacc_j (the `thru` dx threading of `_fused_bwd_kernel`'s
// `thru_mask`, packed_chain.py:693-725: the cotangent that the later
// consumers of input j's surface summed, bf16 of x_j's raw shape), dx_j =
// prologue_bwd(...) + dacc_j in f32 before its one rounding; dscale_j and
// dshift_j stay this consumer's own share. The dx epilogue reads it from
// device memory as it writes dx_j: 2 bytes per raw value of x_j more, and
// the separate pass that read two surfaces to write their sum is gone. Only
// a dx launch with an addend runs the dx kernels' addend-reading instance
// (kAcc); the others run the code they ran before it.
//
// Launches on the caller's stream, all on common.cuh's Hopper mainloops
// (cp.async ring of 2-3 stages, wgmma m64nNk16 from shared memory):
// - the dy prep (dy_prep_kernel, 8 channels a thread by 16-byte loads;
//   skipped without moments or bias): 4.0 % of K3's device time on the
//   flagship step before this design, below the 5 % at which folding it
//   into the staging of dx and dW would pay;
// - one dW kernel over 64-row chunks of all inputs' channels, each input's
//   padded to 8, so that narrow inputs share a chunk (conv_dw_wg_kernel:
//   M = 64 input channels, N = 16 or 32 output channels, K = 16-pixel
//   steps of 4 x 64-pixel tiles; the input tile with its
//   prologue and lazy x2 staged through registers one tile ahead, dye by
//   cp.async; f32 atomics into dW, so dW differs run to run by f32
//   rounding, ~1e-6 relative);
// - the dx: one conv_wg_kernel for all inputs that are not lazily
//   upsampled (they convolve the same dye: one read of it; M = one 64-pixel
//   row segment, N = 16/32/64 of their channels side by side, 9 taps per
//   16-channel dye chunk) and, for each lazily x2 upsampled input, one
//   conv_up2_dx_kernel at source resolution (16 combined taps of a 4x4
//   stride-2 correlation over the phase-split fine dye, each a bf16 pair
//   hi + lo: 32 MACs per source pixel instead of 4 x 9, every thread
//   writing outputs instead of one in four); the prologue backward and the
//   dscale/dshift block sums (one atomic per channel per block) run in the
//   epilogue from registers.
// No shape runs on mma.sync: a narrow input (c < 64) leaves dW's M rows
// beyond c zero, a narrow N tile is wgmma n16.
//
// Bound on an H100: twice the forward's 2*9*Cin*Cout operations per pixel
// (dx and dW) against the bytes of dy (+ y), every x_j, and dx_j, so the
// 64x80 nodes with Cin >= 300 sit above the 295 op/byte ridge and the fine
// rows below it.

#include "common.cuh"

// Host entry (plain C interface, bound with ctypes). Per-input arrays have
// n_in entries: the forward inputs (xs, scales, shifts, cs, acts, ups), the
// dx tap packs (wts[j]: (cout chunks of 16, taps, 2, nps[j], 8) bf16; when
// ups[j], 32 taps: the 16 combined taps rounded to bf16 and, after them,
// what the rounding dropped, nps[j] the input's channels padded to a
// multiple of ntiles[j] in {16, 32, 64}; else one pack shared by all such
// inputs: their 9 flipped, transposed taps side by side, each input's
// channels padded to 8 in input order, nps[j] and ntiles[j] that pack's), and
// the outputs dxs (raw-shaped bf16), dscales/dshifts (zeroed (c_j,) f32,
// null without a prologue), daccs (each null or input j's addend, shaped
// as dxs[j]). dy, y: (n, height, width, cout) bf16; dmom (2,
// cout) f32 or null; dye: a bf16 buffer like dy (used when dmom != null);
// dbias: zeroed (cout,) f32 or null; dw: zeroed (9, cpad, np) f32, the
// inputs' channels one after another as its rows, each input's padded to a
// multiple of 8, cpad = that total rounded up to a multiple of 64, and np =
// cout padded to a multiple of ntile (16 or 32). Returns a cudaError_t.
extern "C" int mmr_fused_conv_bwd(
    int n_in, const void* const* xs, const void* const* scales,
    const void* const* shifts, const int* cs, const int* acts,
    const int* ups, const void* const* wts, const int* ntiles,
    const int* nps, void* const* dxs, void* const* dscales,
    void* const* dshifts, const void* const* daccs, const void* dy,
    const void* y, const void* dmom, void* dye, void* dbias, void* dw,
    int ntile, int np, int n, int height, int width, int cout, void* stream) {
  if (n_in < 1 || n_in > kMaxIn) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * height * width * cout;
  cudaError_t e = launch_dy_prep(dy, y, dmom, dye, dbias, total, cout, s);
  if (e != cudaSuccess) return (int)e;
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(dmom ? dye : dy);

  DwWgParams<__nv_bfloat16> q{};
  int rows = 0;
  for (int j = 0; j < n_in; ++j) {
    q.in[j] = Input{static_cast<const __nv_bfloat16*>(xs[j]),
                    static_cast<const float*>(scales[j]),
                    static_cast<const float*>(shifts[j]), cs[j], acts[j],
                    ups[j], rows};
    rows += (cs[j] + 7) / 8 * 8;
  }
  const int chunk = (rows + 63) / 64;
  q.n_in = n_in;
  q.dy = g;
  q.cout = cout;
  q.dw = static_cast<float*>(dw);
  q.cpad = 64 * chunk;
  q.np = np;
  q.n = n;
  q.height = height;
  q.width = width;
  e = launch_dw_wg(ntile, q, chunk, s);
  if (e != cudaSuccess) return (int)e;

  WgParams<__nv_bfloat16> d{};
  d.a = g;
  d.c = cout;
  d.ah = height;
  d.aw = width;
  d.n = n;
  auto dx_of = [&](int j, int col) {
    return WgOut<__nv_bfloat16>{
        static_cast<__nv_bfloat16*>(dxs[j]), q.in[j].x, q.in[j].scale,
        q.in[j].shift, static_cast<float*>(dscales[j]),
        static_cast<float*>(dshifts[j]), cs[j], acts[j], col,
        static_cast<const __nv_bfloat16*>(daccs[j])};
  };
  // the inputs that are not lazily upsampled: one launch (they convolve the
  // same dye), their taps side by side in one pack, each input's columns
  // padded to 8
  WgParams<__nv_bfloat16> m = d;
  m.oh = height;
  m.ow = width;
  int tile = 0, col = 0;
  for (int j = 0; j < n_in; ++j) {
    if (ups[j]) continue;
    m.wt = static_cast<const __nv_bfloat16*>(wts[j]);
    m.np = nps[j];
    tile = ntiles[j];
    m.out[m.n_out++] = dx_of(j, col);
    col += (cs[j] + 7) / 8 * 8;
  }
  if (m.n_out > 0) {
    e = launch_conv_wg(tile, m, s);
    if (e != cudaSuccess) return (int)e;
  }
  // one source-resolution launch per lazily x2-upsampled input
  for (int j = 0; j < n_in; ++j) {
    if (!ups[j]) continue;
    WgParams<__nv_bfloat16> u = d;
    u.oh = height / 2;
    u.ow = width / 2;
    u.wt = static_cast<const __nv_bfloat16*>(wts[j]);
    u.np = nps[j];
    u.out[0] = dx_of(j, 0);
    u.n_out = 1;
    e = launch_up2_dx(ntiles[j], u, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

namespace {

template <int N>
int hopper_smem(int kind) {
  return kind == 0   ? WgTile<N, false>::kSmem
         : kind == 1 ? WgTile<N, true>::kSmem
         : N <= 32   ? DwTile<N>::kSmem
                     : -1;
}

template <int N>
int hopper_blocks(int kind) {
  if (kind == 2 && N > 32) return -1;
  using B = __nv_bfloat16;
  if (kind == 0)
    return blocks_per_sm(conv_wg_kernel<N, B, false>,
                         WgTile<N, false>::kThreads, WgTile<N, false>::kSmem);
  if (kind == 1)
    return blocks_per_sm(conv_up2_dx_kernel<N, false>,
                         WgTile<N, true>::kThreads, WgTile<N, true>::kSmem);
  return blocks_per_sm(conv_dw_wg_kernel<N <= 32 ? N : 32, B>,
                       kDwWgThreads, DwTile<N>::kSmem);
}

}  // namespace

// Dynamic shared memory in bytes (what = 0) or resident blocks per SM at
// the launch's attributes (what = 1, the occupancy calculator on the
// current card) of a Hopper kernel of common.cuh at bf16 storage: kind 0
// conv_wg_kernel, 1 conv_up2_dx_kernel (ntile 16, 32 or 64), 2
// conv_dw_wg_kernel (ntile 16 or 32). Returns -1 otherwise.
extern "C" int mmr_hopper_kernel_info(int what, int kind, int ntile) {
  if (kind < 0 || kind > 2) return -1;
  switch (ntile) {
    case 16: return what ? hopper_blocks<16>(kind) : hopper_smem<16>(kind);
    case 32: return what ? hopper_blocks<32>(kind) : hopper_smem<32>(kind);
    case 64: return what ? hopper_blocks<64>(kind) : hopper_smem<64>(kind);
    default: return -1;
  }
}
