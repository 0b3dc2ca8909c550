// K7: per-class confusion statistics (tp, fp, fn) of two class-id maps.
//
// Replaces the TPU kernel `_kernel` of
// `mmr_tpu/ops/pallas/confusion.py::confusion_stats` (the `pl.pallas_call`
// at confusion.py:81), which `metrics/evaluate.py::Evaluate.add_batch`
// runs on every batch.
//
// For pred and gt of n ids each, and classes c in [0, nc), nc <= 128:
//   tp[c] = |{i : pred_i = gt_i = c}|,  fp[c] = |{i : pred_i = c}| - tp[c],
//   fn[c] = |{i : gt_i = c}| - tp[c].
// An id outside [0, nc) counts nowhere (the TPU kernel's padding sentinels
// -1 / -2 are such ids). The maps are read in the dtypes they come in
// (uint8, int32 or int64: argmax ids are int64, masks uint8 or int64), so
// no cast pass precedes the kernel.
//
// The TPU kernel carries three (C,) f32 accumulators across its sequential
// grid. Here blocks run in no order: each block counts its share of the
// pixels in shared memory (32-bit), a warp first merging the lanes that
// hold the same key (__match_any_sync: one shared atomic per distinct key
// per warp, not one per lane, so a map of mostly one class does not
// serialize), then adds its counts into (3, nc) 64-bit device counters with
// one atomic per nonzero entry. A second one-block launch converts the
// counters to f32 tp, fp, fn. Integer sums make the result exact and the
// same from run to run.
//
// Bound on an H100: bytes. Per pixel it reads 2..16 bytes (uint8 .. int64
// ids) for a few integer operations, far under the 295 op/byte ridge: the
// least time is the two maps' bytes over 3.35 TB/s. The design reads each
// id once, with grid-stride loops over at most 8 blocks per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 128;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kU8 = 0, kI32 = 1, kI64 = 2 };

// one count for each distinct key >= 0 held by the warp's lanes
__device__ __forceinline__ void count(unsigned* cnt, int key, int lane) {
  const unsigned peers = __match_any_sync(kFull, key);
  if (key >= 0 && lane == __ffs(peers) - 1)
    atomicAdd(&cnt[key], (unsigned)__popc(peers));
}

template <class TP, class TG>
__global__ void __launch_bounds__(kThreads)
    confusion_kernel(const TP* pred, const TG* gt, long long n, int nc,
                     unsigned long long* counts) {
  __shared__ unsigned cnt[3 * kMaxClasses];  // tp, |pred = c|, |gt = c|
  for (int i = threadIdx.x; i < 3 * nc; i += blockDim.x) cnt[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // w0 is the same for every lane of a warp: all 32 lanes take each
  // iteration together, as __match_any_sync needs
  for (long long w0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       w0 < n; w0 += stride) {
    const long long i = w0 + lane;
    int p = -1, g = -1;
    if (i < n) {
      const long long pv = (long long)pred[i];
      const long long gv = (long long)gt[i];
      p = (pv >= 0 && pv < nc) ? (int)pv : -1;
      g = (gv >= 0 && gv < nc) ? (int)gv : -1;
    }
    count(cnt, (p >= 0 && p == g) ? p : -1, lane);
    count(cnt + nc, p, lane);
    count(cnt + 2 * nc, g, lane);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * nc; i += blockDim.x)
    if (cnt[i] != 0u) atomicAdd(&counts[i], (unsigned long long)cnt[i]);
}

__global__ void finalize_kernel(const unsigned long long* counts, int nc,
                                float* out) {
  const int c = threadIdx.x;
  if (c < nc) {
    const unsigned long long tp = counts[c];
    out[c] = (float)tp;
    out[nc + c] = (float)(counts[nc + c] - tp);
    out[2 * nc + c] = (float)(counts[2 * nc + c] - tp);
  }
}

template <class TP, class TG>
cudaError_t launch(const void* pred, const void* gt, long long n, int nc,
                   unsigned long long* counts, cudaStream_t s) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  if (blocks < 1) blocks = 1;
  confusion_kernel<TP, TG><<<(int)blocks, kThreads, 0, s>>>(
      static_cast<const TP*>(pred), static_cast<const TG*>(gt), n, nc, counts);
  return cudaGetLastError();
}

template <class TP>
cudaError_t launch_gt(int gt_kind, const void* pred, const void* gt,
                      long long n, int nc, unsigned long long* counts,
                      cudaStream_t s) {
  switch (gt_kind) {
    case kU8: return launch<TP, uint8_t>(pred, gt, n, nc, counts, s);
    case kI32: return launch<TP, int32_t>(pred, gt, n, nc, counts, s);
    case kI64: return launch<TP, int64_t>(pred, gt, n, nc, counts, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Host entry (plain C interface, bound with ctypes). pred, gt: n ids each,
// of kinds 0 = uint8, 1 = int32, 2 = int64; counts: a (3, nc) 64-bit
// scratch buffer (zeroed here); out: (3, nc) f32 [tp; fp; fn]. Two launches
// and a memset on the caller's stream. Returns a cudaError_t.
extern "C" int mmr_confusion(const void* pred, int pred_kind, const void* gt,
                             int gt_kind, long long n, int nc, void* counts,
                             void* out, void* stream) {
  if (nc < 1 || nc > kMaxClasses || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* c = static_cast<unsigned long long*>(counts);
  cudaError_t e = cudaMemsetAsync(c, 0, sizeof(unsigned long long) * 3 * nc, s);
  if (e != cudaSuccess) return (int)e;
  switch (pred_kind) {
    case kU8: e = launch_gt<uint8_t>(gt_kind, pred, gt, n, nc, c, s); break;
    case kI32: e = launch_gt<int32_t>(gt_kind, pred, gt, n, nc, c, s); break;
    case kI64: e = launch_gt<int64_t>(gt_kind, pred, gt, n, nc, c, s); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  finalize_kernel<<<1, kMaxClasses, 0, s>>>(c, nc, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
