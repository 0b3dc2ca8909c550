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
// Bound on an H100: bytes, and at an eval batch's size (4 x 256 x 256,
// 2.4 MB) the launch and a few trips to L2. Per pixel it reads 2..16 bytes
// for a few integer operations, far under the 295 op/byte ridge. So the
// design is one launch a call, with nothing else on the stream:
//
// - A persistent grid of at most four blocks an SM (the card's SM count,
//   common.cuh's device_sms), 256 threads each. A thread takes 8 pixels a
//   step and reads each map's 8 ids by vector loads: one 8-byte load of
//   uint8 ids, two 16-byte loads of int32, four of int64. The vectors
//   start where both maps are 16-byte aligned: the few pixels before and
//   after (a view with a storage offset, an n that is no multiple of 8)
//   are read one by one; where no pixel index aligns both maps (offsets of
//   another phase), every pixel is read one by one.
// - A thread walks its pixels keeping the current run of each of its three
//   keys (tp class, pred class, gt class) and adds a run to its warp's
//   shared-memory histogram only when the key changes: a mask of blobs
//   costs a few shared atomics a thread, not three a pixel, and warps do
//   not contend with each other.
// - Each block adds its warps' histograms in warp order and each nonzero
//   count into a 3 * nc u32 accumulator in device memory (atomics: integer
//   sums, the same in any order); then takes a ticket (__threadfence,
//   atomicAdd). The last block to arrive reads the accumulator, sets it
//   and the ticket back to 0 for the next launch, and writes f32 tp, fp,
//   fn and/or adds them into the caller's int64 (3, nc) running total.
//   No memset and no second kernel; the result is exact and the same from
//   run to run.
//
// Measured on an H100 against rows of block counts summed by the last
// block in block order (the layout of K5a's and K6b's reductions): the
// atomics took 0.0048 against 0.0053 ms at 4 x 256 x 256 and 0.0090
// against 0.0113 ms at 1080 x 1920 (PERF.md §6); 8 pixels a thread
// step beat 16 at both.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClasses = 128;
constexpr int kVec = 8;          // pixels a thread takes a step
constexpr int kBlocksPerSm = 4;  // the persistent grid: at most this many a SM

enum Kind { kU8 = 0, kI32 = 1, kI64 = 2 };

// kVec ids of one map, loaded as 16-byte vectors (one 8-byte vector where
// the ids fill less)
template <class T>
struct Ids {
  using V = typename std::conditional<kVec * sizeof(T) >= 16, uint4, uint2>::type;
  static constexpr int kLoads = kVec * sizeof(T) / sizeof(V);
  union {
    V v[kLoads];
    T x[kVec];
  };
  __device__ __forceinline__ void load(const T* p) {
    const V* q = reinterpret_cast<const V*>(p);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) v[k] = __ldg(q + k);
  }
};

// A run of equal keys; added to the histogram when the key changes.
struct Run {
  int key = -1;
  unsigned len = 0;
  __device__ __forceinline__ void see(int k, unsigned* hist) {
    if (k != key) {
      if (key >= 0) atomicAdd(&hist[key], len);
      key = k;
      len = 0;
    }
    ++len;
  }
  __device__ __forceinline__ void flush(unsigned* hist) {
    if (key >= 0) atomicAdd(&hist[key], len);
  }
};

struct Runs {
  Run tp, pred, gt;
  template <class TP, class TG>
  __device__ __forceinline__ void see(TP pv, TG gv, int nc, unsigned* h) {
    const long long a = (long long)pv, b = (long long)gv;
    const int p = (a >= 0 && a < nc) ? (int)a : -1;
    const int g = (b >= 0 && b < nc) ? (int)b : -1;
    tp.see(p >= 0 && p == g ? p : -1, h);
    pred.see(p, h + nc);
    gt.see(g, h + 2 * nc);
  }
  __device__ __forceinline__ void flush(int nc, unsigned* h) {
    tp.flush(h);
    pred.flush(h + nc);
    gt.flush(h + 2 * nc);
  }
};

// head: the first pixel where both maps are 16-byte aligned (< 16), or -1
// when there is none: then every pixel is read one by one. acc: 3 * nc
// u32 counts, then the ticket; all 0 between launches.
template <class TP, class TG>
__global__ void __launch_bounds__(kThreads)
    confusion_kernel(const TP* __restrict__ pred, const TG* __restrict__ gt,
                     long long n, int nc, long long head, unsigned* acc,
                     float* out, long long* total) {
  __shared__ unsigned hist[kWarps][3 * kMaxClasses];
  __shared__ bool last;
  const int c3 = 3 * nc;
  for (int i = threadIdx.x; i < kWarps * c3; i += kThreads)
    hist[i / c3][i % c3] = 0u;
  __syncthreads();
  unsigned* h = hist[threadIdx.x / 32];
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  Runs runs;
  if (head >= 0) {
    const long long nvec = (n - head) / kVec;
    const TP* p0 = pred + head;
    const TG* g0 = gt + head;
    for (long long v = tid; v < nvec; v += stride) {
      Ids<TP> ip;
      Ids<TG> ig;
      ip.load(p0 + v * kVec);
      ig.load(g0 + v * kVec);
#pragma unroll
      for (int j = 0; j < kVec; ++j) runs.see(ip.x[j], ig.x[j], nc, h);
    }
    // the pixels before the first vector and after the last one (< 16 + kVec)
    const long long tail0 = head + nvec * kVec;
    const long long rest = head + (n - tail0);
    if (tid < rest) {
      const long long i = tid < head ? tid : tail0 + (tid - head);
      runs.see(pred[i], gt[i], nc, h);
    }
  } else {
    for (long long i = tid; i < n; i += stride) runs.see(pred[i], gt[i], nc, h);
  }
  runs.flush(nc, h);
  __syncthreads();

  // this block's counts, its warps' histograms added in warp order, into
  // the accumulator; each adder fences before the ticket is taken
  for (int j = threadIdx.x; j < c3; j += kThreads) {
    unsigned s = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += hist[w][j];
    if (s != 0u) atomicAdd(&acc[j], s);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&acc[c3], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: the sums (read from L2, past this SM's L1), the
  // accumulator and ticket left at 0, the outputs
  unsigned* sum = &hist[0][0];
  for (int j = threadIdx.x; j < c3; j += kThreads) {
    sum[j] = __ldcg(&acc[j]);
    acc[j] = 0u;
  }
  if (threadIdx.x == 0) acc[c3] = 0u;
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    const unsigned tp = sum[c], fp = sum[nc + c] - tp, fn = sum[2 * nc + c] - tp;
    if (out != nullptr) {
      out[c] = (float)tp;
      out[nc + c] = (float)fp;
      out[2 * nc + c] = (float)fn;
    }
    if (total != nullptr) {
      total[c] += tp;
      total[nc + c] += fp;
      total[2 * nc + c] += fn;
    }
  }
}

// The first pixel index where both maps are 16-byte aligned, or -1.
long long common_head(const void* pred, int ps, const void* gt, int gs,
                      long long n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(pred);
  const uintptr_t b = reinterpret_cast<uintptr_t>(gt);
  for (long long i = 0; i < 16 && i <= n; ++i)
    if ((a + i * ps) % 16 == 0 && (b + i * gs) % 16 == 0) return i;
  return -1;
}

struct Launch {
  const void *pred, *gt;
  long long n;
  int nc;
  unsigned* acc;
  float* out;
  long long* total;
  int blocks;
  cudaStream_t s;
};

template <class TP, class TG>
cudaError_t launch(const Launch& L) {
  const long long head = common_head(L.pred, sizeof(TP), L.gt, sizeof(TG), L.n);
  confusion_kernel<TP, TG><<<L.blocks, kThreads, 0, L.s>>>(
      static_cast<const TP*>(L.pred), static_cast<const TG*>(L.gt), L.n, L.nc,
      head, L.acc, L.out, L.total);
  return cudaGetLastError();
}

template <class TP>
cudaError_t launch_gt(int gt_kind, const Launch& L) {
  switch (gt_kind) {
    case kU8: return launch<TP, uint8_t>(L);
    case kI32: return launch<TP, int32_t>(L);
    case kI64: return launch<TP, int64_t>(L);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Host entry (plain C interface, bound with ctypes). pred, gt: n ids each,
// of kinds 0 = uint8, 1 = int32, 2 = int64, n < 2^32 (the accumulator is
// u32); scratch: 3 * nc + 1 u32, 0 before the first launch (the kernel
// leaves it so), used by one launch at a time; out: (3, nc) f32 [tp; fp;
// fn] or null; total: (3, nc) int64 [tp; fp; fn] added to, or null. One
// launch on the caller's stream. Returns a cudaError_t.
extern "C" int mmr_confusion(const void* pred, int pred_kind, const void* gt,
                             int gt_kind, long long n, int nc, void* scratch,
                             void* out, void* total, void* stream) {
  if (nc < 1 || nc > kMaxClasses || n < 0 || n >= (1LL << 32))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = device_sms(dev, &sms);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (n / kVec + kThreads - 1) / kThreads;
  blocks = std::max<long long>(1, std::min<long long>(blocks, (long long)kBlocksPerSm * sms));
  const Launch L{pred, gt, n, nc, static_cast<unsigned*>(scratch),
                 static_cast<float*>(out), static_cast<long long*>(total),
                 (int)blocks, static_cast<cudaStream_t>(stream)};
  switch (pred_kind) {
    case kU8: return (int)launch_gt<uint8_t>(gt_kind, L);
    case kI32: return (int)launch_gt<int32_t>(gt_kind, L);
    case kI64: return (int)launch_gt<int64_t>(gt_kind, L);
    default: return (int)cudaErrorInvalidValue;
  }
}
