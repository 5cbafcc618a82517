// Decayed size-sketch update for Hopper (sm_90a): a whole observe window
// of R batches folded into the dense (BINS,) sketch in one launch.
//
// Replaces the TPU kernel repro/kernels/sketch_update.py::
// sketch_update_pallas and its scanned form sketch_window_pallas (a
// lax.scan over per-batch launches). For each row r in order:
//   state[b] = state[b] * decay_totals[r] + sum_{i: idx_i == b} w_i
// where item i of row r (lengths[r] live items) has bucket id
// idx_i = clip(ceil(s_i / width) - 1, 0, BINS - 1) (-1 for a negative
// size, which is skipped) and weight weights[r, i] * decay^(len-1-i).
// With `prebucketed` set, the sizes are already bucket ids (ids outside
// [0, BINS) are skipped) and the weights are used as given: that is the
// per-batch sketch_update with R = 1 and decay = 1.
//
// The TPU kernel sweeps a (BLOCK_N, BLOCK_BINS) hit mask and reduces into
// an output block its sequential grid revisits. Here each block owns 256
// bins, one per thread, and walks the rows in order; per row it stages
// 256 items at a time in shared memory (bucketized and weighted in the
// kernel) and each thread adds, in item order, the items that hit its
// bin. That is the TPU's own compare/accumulate sweep, R * N * BINS
// compares, with no atomics: every bin is summed in item order, so the
// result is deterministic and a window launch gives the same bits as R
// one-row launches. A tile with no item in the block's bin range is
// skipped after one block-wide vote.
//
// Bound: at the main path's shapes (BINS = 8192, N = 512, R = 10) it
// reads ~80 KB and does ~4e7 integer compares, so launch latency and the
// serial per-thread compare loop bound it. A deterministic shared-memory
// histogram or a sort/segment reduction would cut the compares.
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 256;  // bins per block == threads per block
constexpr int kTile = 256;  // items staged per pass (one per thread)

__global__ void __launch_bounds__(kBins)
sketch_window_kernel(const float* state, float* out,
                     const int* __restrict__ sizes,
                     const float* __restrict__ weights,
                     const int* __restrict__ lengths,
                     const float* __restrict__ decay_totals, float decay,
                     int rows, int n, int bins, int bucket_width,
                     int prebucketed) {
  __shared__ int s_idx[kTile];
  __shared__ float s_w[kTile];
  const int first = blockIdx.x * kBins;
  const int last = min(first + kBins, bins);
  const int bin = first + threadIdx.x;
  const bool owns = bin < bins;
  float v = owns ? state[bin] : 0.0f;

  for (int r = 0; r < rows; ++r) {
    v *= decay_totals[r];
    const int len = min(max(lengths[r], 0), n);
    const int* srow = sizes + static_cast<long long>(r) * n;
    const float* wrow = weights + static_cast<long long>(r) * n;
    for (int base = 0; base < len; base += kTile) {
      const int i = base + threadIdx.x;
      int idx = -1;
      float w = 0.0f;
      if (i < len) {
        const int sz = srow[i];
        if (prebucketed) {
          idx = sz;
          w = wrow[i];
        } else {
          if (sz >= 0) {
            const long long q =
                (static_cast<long long>(sz) + bucket_width - 1) /
                bucket_width - 1;
            idx = static_cast<int>(q < 0 ? 0 : (q >= bins ? bins - 1 : q));
          }
          w = wrow[i] * powf(decay, static_cast<float>(len - 1 - i));
        }
        if (idx < first || idx >= last) idx = -1;  // not this block's bins
      }
      s_idx[threadIdx.x] = idx;
      s_w[threadIdx.x] = w;
      const int any = __syncthreads_or(idx >= 0);
      if (any && owns) {
        const int count = min(kTile, len - base);
        for (int j = 0; j < count; ++j) {
          if (s_idx[j] == bin) v += s_w[j];
        }
      }
      __syncthreads();
    }
  }
  if (owns) out[bin] = v;
}

}  // namespace

// state (bins,) f32 -> out (bins,) f32 (may alias state); sizes (rows, n)
// int32; weights (rows, n) f32; lengths (rows,) int32; decay_totals
// (rows,) f32; on `stream`. Returns cudaGetLastError().
extern "C" int sketch_window_launch(const void* state, void* out,
                                    const void* sizes, const void* weights,
                                    const void* lengths,
                                    const void* decay_totals, float decay,
                                    int rows, int n, int bins,
                                    int bucket_width, int prebucketed,
                                    void* stream) {
  if (bins > 0) {
    const int blocks = (bins + kBins - 1) / kBins;
    sketch_window_kernel<<<blocks, kBins, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(state), static_cast<float*>(out),
        static_cast<const int*>(sizes), static_cast<const float*>(weights),
        static_cast<const int*>(lengths),
        static_cast<const float*>(decay_totals), decay, rows, n, bins,
        bucket_width, prebucketed);
  }
  return static_cast<int>(cudaGetLastError());
}
