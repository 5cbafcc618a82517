// Batched slab-schedule waste evaluation for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/waste_eval.py::waste_eval_pallas
// and waste_eval_fleet_pallas. Row b of `chunks` (B, K) is a candidate
// schedule; every size of the histogram (support, freqs) goes to the
// smallest chunk that covers it, and a size no chunk covers is charged
// max(ceil(s/page), 1) whole pages minus s. out[b] = sum over sizes of
// waste * freq. waste_eval_launch scores every row against one (S,)
// histogram; waste_eval_fleet_launch scores row b against row b of
// (B, S) histograms (one launch for every pending tenant's frontier).
// Both run the same per-row loop below, the fleet entry only offsetting
// the histogram by b * S, so a row whose histogram is replicated gets
// the bits the single-histogram launch gives.
//
// The TPU grid reduces over S by `+=` into an output block that its
// sequential grid revisits. CUDA blocks run in parallel, so here one
// block owns one row and loops over S itself:
//   * the row's chunks go to shared memory and are sorted there by rank
//     (K <= 1024, checked by the wrapper), so the caller need not sort;
//   * threads stride over S and find the covering chunk by a lower-bound
//     search, which is the TPU's K-step running minimum;
//   * each thread sums waste * freq in a fixed order, and a fixed-shape
//     tree in shared memory gives the row total. No atomics.
// The sums are taken in double: waste is an integer below 2^21 and on
// the search and controller paths freqs are integer counts, so every
// partial sum is exact and the one rounding to float32 at the end is the
// only one. The result is deterministic and equal, bit for bit, to the
// plain PyTorch version (kernels/ref.py::waste_eval_ref), so a search
// driven by either takes the same path.
//
// Bound: on the main path B is 3 (controller frontier) or K*20 (a
// parallel hill-climb step) and S a few hundred, i.e. a few KB of reads
// and under 1e7 compares: launch latency bounds it, not bytes or
// operations. One launch per frontier is what the design buys. The fleet
// entry reads B*S histogram entries (3 rows per pending tenant), still
// a few hundred KB at a thousand tenants.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;

__global__ void __launch_bounds__(kThreads)
waste_eval_kernel(const int* __restrict__ chunks,
                  const int* __restrict__ support,
                  const float* __restrict__ freqs,
                  float* __restrict__ out, int k, int s, int page_size,
                  long long hist_stride) {
  __shared__ int raw[kMaxK];
  __shared__ int sorted[kMaxK];
  __shared__ double partial[kThreads];
  const int tid = threadIdx.x;
  const int* row = chunks + static_cast<long long>(blockIdx.x) * k;
  support += blockIdx.x * hist_stride;  // 0: one shared histogram
  freqs += blockIdx.x * hist_stride;

  for (int i = tid; i < k; i += kThreads) raw[i] = row[i];
  __syncthreads();
  // Rank sort: chunk i lands after every smaller chunk and after every
  // equal chunk with a lower index, so ties keep their order.
  for (int i = tid; i < k; i += kThreads) {
    const int v = raw[i];
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const int u = raw[j];
      rank += (u < v) || (u == v && j < i);
    }
    sorted[rank] = v;
  }
  __syncthreads();

  double acc = 0.0;
  for (int i = tid; i < s; i += kThreads) {
    const int size = support[i];
    int lo = 0, hi = k;  // first chunk >= size
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sorted[mid] < size) lo = mid + 1; else hi = mid;
    }
    long long waste;
    if (lo < k) {
      waste = static_cast<long long>(sorted[lo]) - size;
    } else {
      long long pages = (static_cast<long long>(size) + page_size - 1)
                        / page_size;
      if (pages < 1) pages = 1;
      waste = pages * page_size - size;
    }
    acc += static_cast<double>(waste) * static_cast<double>(freqs[i]);
  }
  partial[tid] = acc;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) partial[tid] += partial[tid + stride];
    __syncthreads();
  }
  if (tid == 0) out[blockIdx.x] = static_cast<float>(partial[0]);
}

}  // namespace

// chunks (b, k) int32, support (s,) int32, freqs (s,) float32 ->
// out (b,) float32, on `stream`. Returns cudaGetLastError().
extern "C" int waste_eval_launch(const void* chunks, const void* support,
                                 const void* freqs, void* out, int b, int k,
                                 int s, int page_size, void* stream) {
  if (b > 0) {
    waste_eval_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(chunks), static_cast<const int*>(support),
        static_cast<const float*>(freqs), static_cast<float*>(out), k, s,
        page_size, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// chunks (b, k) int32, supports (b, s) int32, freqs (b, s) float32 ->
// out (b,) float32, on `stream`. Returns cudaGetLastError().
extern "C" int waste_eval_fleet_launch(const void* chunks,
                                       const void* supports,
                                       const void* freqs, void* out, int b,
                                       int k, int s, int page_size,
                                       void* stream) {
  if (b > 0) {
    waste_eval_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(chunks), static_cast<const int*>(supports),
        static_cast<const float*>(freqs), static_cast<float*>(out), k, s,
        page_size, s);
  }
  return static_cast<int>(cudaGetLastError());
}
