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
// Contract: every bin first decays by decay_totals[r], then adds row r's
// hits one at a time in item order. So one R-row launch gives the bits of
// R one-row launches, and no float atomics are used anywhere.
//
// Design: work proportional to the hits, spread over the card. There are
// G = ceil(BINS / 64) blocks (128 at BINS = 8192), and block k owns the
// 64 bins k, k + G, k + 2G, ...: a hot range of neighbouring bins (the
// paper's sizes fill ~80 bins around 500) is dealt over many blocks
// instead of landing on one. A block takes the window's flattened items
// (r, i) in chunks of whole rows (at most 32 rows and 8,192 items; a
// row longer than that is cut into pieces):
//   A. the chunk's weights are staged into shared memory with cp.async
//      while each warp loads the sizes of its 32-item groups (all its
//      loads in flight at once), bucketizes them and counts each group's
//      hits on the block's bins with one ballot;
//   B. one warp scans the group counts: each group's first slot in the
//      block's hit list (meanwhile, in a block with hits, the other warps
//      tabulate decay^e for e < N, the same powf once per e);
//   C. each warp writes its groups' hits, 8-byte (decayed weight, local
//      bin) records, at the group's slot plus the hit's rank in its
//      ballot: a stable compaction, so the list is in item order; each
//      row's first slot comes from the group masks;
//   D. the block's 64 bin threads (two warps) walk the hit list in order,
//      row by row: every thread decays by the row's total, then each
//      adds the hits of its own bin, in item order (and -0.0f for every
//      other hit: x + -0.0f is x for every float, so the walk has no
//      branch), 16 records loaded ahead of the adds.
// A block costs its own hits: D's chain is one dependent add a hit (the
// contract orders them), read from broadcast loads.
//
// Bound: at the main path's shapes (BINS = 8192, R = 10, N = 512) the
// window moves ~106 KB, nanoseconds at HBM rate. What bounds it is the
// launch, each phase's load and barrier latency and, at the fused shape,
// the walk of the block with most hits (a paper bin takes ~200 of a
// window's 5,120 items, each a dependent add).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 64;          // bins per block
// A block of T threads takes chunks of at most 8 T items (8 groups of 32
// a warp): 1,024 threads, or 512 for windows of at most 4,096 items,
// which the smaller block runs sooner. The items' order, and so every
// bit of the result, does not depend on T.
constexpr int kMaxCap = 8192;      // items per chunk of the larger block
constexpr int kSmallItems = 4096;  // windows up to this take 512 threads
constexpr int kRows = 32;          // rows of the window per chunk
constexpr int kPowTable = 2048;    // rows up to this long share a table
constexpr unsigned kNoHit = 0xff;  // local-bin marker of an item not hit
// Up to 2^20 bins, idx / G is (idx + 0.5) * (1 / G) rounded down in
// float: the quotient's fraction is at least 0.5 / G from an integer,
// the product's error below 0.2 / G.
constexpr int kFloatDiv = 1 << 20;

// Dynamic shared memory for a chunk of `cap` items: the hit list (8
// bytes a hit: weight and local bin, kPad records past the end so a walk
// reads whole batches), the staged raw weights (4 bytes) and each item's
// local bin (1 byte).
constexpr int kPad = 16;
size_t smem_bytes(int cap) {
  return static_cast<size_t>(cap + kPad) * 8 + static_cast<size_t>(cap) * 4 +
         static_cast<size_t>(cap + 15) / 16 * 16;
}

// Items of a chunk: whole rows (at most kRows and `cap` items), or a
// cap-item piece of a row longer than `cap`.
__host__ __device__ inline int chunk_items(int n, int cap) {
  return n > cap ? cap : min(cap / n, kRows) * n;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
sketch_window_kernel(const float* state, float* out,
                     const int* __restrict__ sizes,
                     const float* __restrict__ weights,
                     const int* __restrict__ lengths,
                     const float* __restrict__ decay_totals, float decay,
                     int rows, int n, int bins, int bucket_width,
                     int prebucketed, int cap) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kCap = 8 * kThreads;      // items of the window per chunk
  constexpr int kGroups = kCap / 32;      // 32-item groups of a chunk
  static_assert(kGroups <= 8 * 32, "B scans at most 8 groups a lane");
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* s_hit = reinterpret_cast<uint2*>(smem);    // (weight, local bin)
  float* s_raw = reinterpret_cast<float*>(s_hit + cap + kPad);  // staged
  uint8_t* s_item = reinterpret_cast<uint8_t*>(s_raw + cap);  // local bin
  __shared__ int s_gcnt[kGroups];        // hits per group, then its slot
  __shared__ unsigned s_gmask[kGroups];  // each group's hits, one bit each
  __shared__ int s_rstart[kRows + 1];    // each row's first slot
  __shared__ int s_len[kRows];           // and live lengths
  __shared__ float s_pow[kPowTable];     // decay^e, rows of n <= 2,048

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned lt_mask = (1u << lane) - 1u;
  const unsigned n_blk = gridDim.x;
  const float inv_blk = 1.0f / static_cast<float>(n_blk);
  const long long bin =                                  // thread < 64
      static_cast<long long>(threadIdx.x) * gridDim.x + blockIdx.x;
  const bool owns = threadIdx.x < kBins && bin < bins;
  float v = owns ? state[bin] : 0.0f;
  int next_row = 0;  // first row whose decay v has not taken yet

  const long long total = static_cast<long long>(rows) * n;
  const int step = n > 0 ? chunk_items(n, kCap) : 1;
  for (long long c0 = 0; c0 < total; c0 += step) {
    const int cnt = static_cast<int>(total - c0 < step ? total - c0 : step);
    const int r0 = static_cast<int>(c0 / n);       // the chunk's first row
    const int i0 = static_cast<int>(c0 - static_cast<long long>(r0) * n);
    const int n_rows = (i0 + cnt - 1) / n + 1;     // rows in the chunk
    const int n_groups = (cnt + 31) / 32;
    // f / n for f < kCap, n <= kCap, the same way (error below 2e-3 / n)
    const float inv_n = 1.0f / static_cast<float>(n);
    // A. stage the weights (only hits need them: the copies run under
    //    the bucketizing); each warp loads its groups' sizes at once,
    //    bucketizes them and counts each 32-item group's hits
    for (int f = threadIdx.x; f < cnt; f += kThreads) {
      cp_async4(s_raw + f, weights + c0 + f);
    }
    if (threadIdx.x < n_rows) s_len[threadIdx.x] =
        min(max(lengths[r0 + threadIdx.x], 0), n);
    const int row_len = lane < n_rows                  // lane r: row r's
        ? min(max(__ldg(lengths + r0 + lane), 0), n) : 0;
    int sz[kGroups / kWarps];
#pragma unroll
    for (int k = 0; k < kGroups / kWarps; ++k) {
      const int f = (warp + k * kWarps) * 32 + lane;
      sz[k] = f < cnt ? __ldg(sizes + c0 + f) : 0;
    }
    bool any_hit = false;
#pragma unroll
    for (int k = 0; k < kGroups / kWarps; ++k) {
      const int g = warp + k * kWarps;
      if (g >= n_groups) break;                      // warp-uniform
      const int f = g * 32 + lane;
      const int dr = n > kCap ? static_cast<int>(i0 + f >= 0LL + n)
                              : __float2int_rz((f + 0.5f) * inv_n);
      const int len = __shfl_sync(0xffffffffu, row_len, dr & 31);
      unsigned lb = kNoHit;
      if (f < cnt && i0 + f - dr * n < len) {
        int idx = -1;
        if (prebucketed) {
          idx = sz[k];
        } else if (sz[k] >= 0) {  // ceil(sz / width) - 1, clipped
          const unsigned q =
              bucket_width == 1
                  ? static_cast<unsigned>(sz[k])
                  : (static_cast<unsigned>(sz[k]) + bucket_width - 1u) /
                        static_cast<unsigned>(bucket_width);
          idx = q == 0u ? 0 : min(static_cast<int>(q - 1u), bins - 1);
        }
        const unsigned local =
            bins <= kFloatDiv ? __float2uint_rz((idx + 0.5f) * inv_blk)
                              : static_cast<unsigned>(idx) / n_blk;
        if (idx >= 0 && idx < bins &&
            static_cast<unsigned>(idx) - local * n_blk == blockIdx.x) {
          lb = local;
        }
      }
      if (f < cnt) s_item[f] = static_cast<uint8_t>(lb);
      const unsigned hits = __ballot_sync(0xffffffffu, lb != kNoHit);
      if (lane == 0) {
        s_gcnt[g] = __popc(hits);
        s_gmask[g] = hits;
      }
      any_hit |= hits != 0u;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    const bool table = __syncthreads_or(any_hit) && n <= kPowTable &&
                       !prebucketed;

    // B. each group's first slot: lane l scans groups 8l .. 8l + 7 (the
    //    other warps fill a table of the decay's powers, when the block
    //    has hits and the rows are short)
    if (warp == 0) {
      int c[8];
      int sum = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int g = lane * 8 + k;
        c[k] = g < n_groups ? s_gcnt[g] : 0;
        sum += c[k];
      }
      int incl = sum;
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      int at = incl - sum;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int g = lane * 8 + k;
        if (g < n_groups) s_gcnt[g] = at;
        at += c[k];
      }
      if (lane == 31) s_rstart[n_rows] = incl;     // the block's hits
    } else if (table) {    // meanwhile decay^e for e < n, once each
      for (int e = threadIdx.x - 32; e < n; e += kThreads - 32) {
        s_pow[e] = powf(decay, static_cast<float>(e));
      }
    }
    __syncthreads();

    // C. stable compaction of the hits, in item order, and each row's
    //    first slot (the hits before the row's first item)
    if (warp == kWarps - 1 && lane < n_rows) {   // row `lane` starts at f
      const long long lo = static_cast<long long>(lane) * n - i0;
      const int f = lo < 0 ? 0 : static_cast<int>(lo);
      s_rstart[lane] = s_gcnt[f / 32] +
                     __popc(s_gmask[f / 32] & ((1u << (f % 32)) - 1u));
    }
    for (int g = warp; g < n_groups; g += kWarps) {
      const unsigned hits = s_gmask[g];
      if (!(hits >> lane & 1u)) continue;
      const int f = g * 32 + lane;
      const int dr = n > kCap ? static_cast<int>(i0 + f >= 0LL + n)
                              : __float2int_rz((f + 0.5f) * inv_n);
      const int e = s_len[dr] - 1 - (i0 + f - dr * n);
      const int slot = s_gcnt[g] + __popc(hits & lt_mask);
      const float raw = s_raw[f];
      const float w = prebucketed ? raw
                      : raw * (table ? s_pow[e]
                                     : powf(decay, static_cast<float>(e)));
      s_hit[slot] = make_uint2(__float_as_uint(w), s_item[f]);
    }
    __syncthreads();

    // D. the bin threads walk the hit list row by row, in item order;
    //    lane r holds row r's end slot and decay
    if (warp < kBins / 32) {
      const unsigned mine = threadIdx.x;
      const int row_end = lane < n_rows ? s_rstart[lane + 1] : 0;
      const float row_dt = lane < n_rows ? __ldg(decay_totals + r0 + lane)
                                         : 1.0f;
      int h = s_rstart[0];
      for (int r = 0; r < n_rows; ++r) {
        const int end = __shfl_sync(0xffffffffu, row_end, r);
        const float dt = __shfl_sync(0xffffffffu, row_dt, r);
        if (r0 + r >= next_row) {    // a row's decay, once, before its hits
          v *= dt;
          next_row = r0 + r + 1;
        }
        for (; h < end; h += kPad) {       // the loads ahead of the adds
          uint2 hit[kPad];
#pragma unroll
          for (int k = 0; k < kPad; ++k) hit[k] = s_hit[h + k];
#pragma unroll
          for (int k = 0; k < kPad; ++k) {
            v += h + k < end && hit[k].y == mine ? __uint_as_float(hit[k].x)
                                                 : -0.0f;
          }
        }
        h = end;
      }
    }
    __syncthreads();  // the next chunk rewrites shared memory
  }
  if (owns) {
    while (next_row < rows) v *= __ldg(decay_totals + next_row++);
    out[bin] = v;
  }
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
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool attr_set[64] = {};      // per device: raise the smem cap once
  if (dev < 64 && !attr_set[dev]) {
    err = cudaFuncSetAttribute(sketch_window_kernel<1024>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxCap)));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(sketch_window_kernel<512>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem_bytes(kMaxCap / 2)));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  if (bins > 0) {
    const long long total = static_cast<long long>(rows) * n;
    const bool small = total <= kSmallItems;
    const int step = n > 0 ? chunk_items(n, small ? kMaxCap / 2 : kMaxCap)
                           : 1;
    const int cap = total > 0 ? static_cast<int>(total < step ? total : step)
                              : 1;
    const int blocks = (bins + kBins - 1) / kBins;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* st = static_cast<const float*>(state);
    float* o = static_cast<float*>(out);
    const int* sz = static_cast<const int*>(sizes);
    const float* w = static_cast<const float*>(weights);
    const int* len = static_cast<const int*>(lengths);
    const float* dt = static_cast<const float*>(decay_totals);
    if (small) {
      sketch_window_kernel<512><<<blocks, 512, smem_bytes(cap), s>>>(
          st, o, sz, w, len, dt, decay, rows, n, bins, bucket_width,
          prebucketed, cap);
    } else {
      sketch_window_kernel<1024><<<blocks, 1024, smem_bytes(cap), s>>>(
          st, o, sz, w, len, dt, decay, rows, n, bins, bucket_width,
          prebucketed, cap);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
