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
//             resolution, 2x2-summed, for a lazy x2 input)
//   dscale_j, dshift_j = sums of gm*x and gm, gm = g * act'(s*x + t)
// with a_j the bf16 prologue'd input the forward staged and dye rounded to
// bf16 before both products (as the TPU kernel rounds); f32 accumulation.
//
// Three launches on the caller's stream: the dy prep (common.cuh; skipped
// without moments or bias), one dW kernel over every input's 16-channel
// chunks (conv_dw_kernel, common.cuh: per-block partial sums in registers,
// f32 atomics into dW), and one dx kernel per input (conv_dx_kernel: K1's
// tile and tensor-core structure over dye with flipped, transposed taps,
// prologue backward in the epilogue). dW's f32 atomics sum the blocks in no
// fixed order: run to run, dW differs by f32 rounding (~1e-6 relative).
//
// Bound on an H100: twice the forward's 2*9*Cin*Cout operations per pixel
// (dx and dW) against the bytes of dy (+ y), every x_j, and dx_j, so the
// 64x80 nodes with Cin >= 300 sit above the 295 op/byte ridge and the fine
// rows below it. Nothing in this first version overlaps loads with the
// products, and dye makes one round trip through device memory when the
// moments cotangent is folded in: both are later work.

#include "common.cuh"

// Host entry (plain C interface, bound with ctypes). Per-input arrays have
// n_in entries: the forward inputs (xs, scales, shifts, cs, acts, ups), the
// transposed tap packs for dx (wts[j]: (cout chunks, 9, 16, nps[j]) bf16,
// nps[j] the input's channels padded to a multiple of 16*nfs[j]), and the
// outputs dxs (raw-shaped bf16), dscales/dshifts (zeroed (c_j,) f32, null
// without a prologue). dy, y: (n, height, width, cout) bf16; dmom (2, cout)
// f32 or null; dye: a bf16 buffer like dy (used when dmom != null); dbias:
// zeroed (cout,) f32 or null; dw: zeroed (chunks, 9, 16, np) f32 with np =
// cout padded to a multiple of 16*nf. Returns a cudaError_t.
extern "C" int mmr_fused_conv_bwd(
    int n_in, const void* const* xs, const void* const* scales,
    const void* const* shifts, const int* cs, const int* acts,
    const int* ups, const void* const* wts, const int* nfs, const int* nps,
    void* const* dxs, void* const* dscales, void* const* dshifts,
    const void* dy, const void* y, const void* dmom, void* dye, void* dbias,
    void* dw, int nf, int np, int n, int height, int width, int cout,
    void* stream) {
  if (n_in < 1 || n_in > kMaxIn || np % (16 * nf) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * height * width * cout;
  cudaError_t e = launch_dy_prep(dy, y, dmom, dye, dbias, total, cout, s);
  if (e != cudaSuccess) return (int)e;
  const PlainDy src{static_cast<const __nv_bfloat16*>(dmom ? dye : dy), cout};

  DwParams q{};
  int chunk = 0;
  for (int j = 0; j < n_in; ++j) {
    q.in[j].x = static_cast<const __nv_bfloat16*>(xs[j]);
    q.in[j].scale = static_cast<const float*>(scales[j]);
    q.in[j].shift = static_cast<const float*>(shifts[j]);
    q.in[j].c = cs[j];
    q.in[j].act = acts[j];
    q.in[j].up2x = ups[j];
    q.in[j].chunk0 = chunk;
    chunk += (cs[j] + kKC - 1) / kKC;
  }
  q.n_in = n_in;
  q.dw = static_cast<float*>(dw);
  q.dbias = nullptr;
  q.n = n;
  q.height = height;
  q.width = width;
  q.np = np;
  e = launch_dw_nf(nf, q, src, chunk, s);
  if (e != cudaSuccess) return (int)e;

  for (int j = 0; j < n_in; ++j) {
    if (nps[j] % (16 * nfs[j]) != 0) return (int)cudaErrorInvalidValue;
    DxParams d{};
    d.x = q.in[j];
    d.wt = static_cast<const __nv_bfloat16*>(wts[j]);
    d.dx = static_cast<__nv_bfloat16*>(dxs[j]);
    d.dscale = static_cast<float*>(dscales[j]);
    d.dshift = static_cast<float*>(dshifts[j]);
    d.n = n;
    d.height = height;
    d.width = width;
    d.np = nps[j];
    e = launch_dx_nf(nfs[j], d, src, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
