// In-place KV-pool scatters of the decode tick, for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/kv_scatter.py::kv_append_pallas
// and kv_chunk_copy_pallas. A pool is (T, H, D) float32, seen here as T
// rows of hd = H * D floats.
//
// kv_append: pool[rows[b]] = vals[b] for every rows[b] >= 0 (a row past
// the pool clamps to T - 1, as the reference's index map does); a
// negative row is a skipped slot and its block returns at once. Live rows
// are distinct (each sequence appends inside its own chunk), so blocks
// never race.
//
// kv_chunk_copy: M range moves of whole 128-token tiles, applied one
// after another in array order: move i copies len_i rows from s_i to
// d_i, where s_i, d_i are the starts clamped into [0, T - W] (W the
// largest move, `max_copy_tokens`) and len_i is n_i rounded up to a
// whole tile, clamped into [0, W]. A later move may read what an earlier
// one wrote or overwrite what it read (the WAR pattern of class-overflow
// reallocation), so the order matters. One thread-block cluster (8
// blocks, Hopper's hardware cluster barrier) walks the moves in order:
// each move is a contiguous copy of len_i * hd floats spread over the
// cluster's threads, followed by a cluster barrier. A move whose source
// and destination ranges overlap is staged through a (W, hd) scratch
// (copy out, barrier, copy in). Skipped moves (len 0, or s == d) cost no
// barrier. Copies bypass L1 (ld/st .cg) and each barrier follows a
// __threadfence, so a block reads what another block wrote before it.
//
// Bound: bytes. A decode tick appends one 4 KB row per sequence (H = 8,
// D = 128) and moves at most a few chunks of up to 1,024 rows: a
// non-overlapping move reads and writes each row once (the least
// traffic), an overlapping one twice. Eight SMs cannot reach the card's
// full bandwidth, which costs a tick's few moves little; the scratch is
// one move (4 MiB at the widths above), whatever M is.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;       // length granule (the reference's BLOCK_T)
constexpr int kCluster = 8;      // blocks of the chunk copy's one cluster
constexpr int kCopyThreads = 1024;
constexpr int kMaxMoves = 1024;

__global__ void __launch_bounds__(kThreads)
kv_append_kernel(float* __restrict__ pool, const int* __restrict__ rows,
                 const float* __restrict__ vals, int t, long long hd) {
  int r = rows[blockIdx.y];
  if (r < 0) return;
  if (r > t - 1) r = t - 1;
  float* dst = pool + static_cast<long long>(r) * hd;
  const float* src = vals + static_cast<long long>(blockIdx.y) * hd;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if ((hd & 3) == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (; i < hd / 4; i += stride) d4[i] = s4[i];
  } else {
    for (; i < hd; i += stride) dst[i] = src[i];
  }
}

// Copies n words from `from` to `to` (ranges disjoint) with the
// cluster's threads: thread `tid` of `nthreads` takes words tid,
// tid + nthreads, ..., four loads in flight before their stores. Loads
// and stores bypass L1 (.cg), so other blocks' earlier writes are seen.
template <typename T>
__device__ __forceinline__ void cluster_copy(const T* __restrict__ from,
                                             T* __restrict__ to,
                                             long long n, long long tid,
                                             long long nthreads) {
  long long i = tid;
  for (; i + 3 * nthreads < n; i += 4 * nthreads) {
    const T a = __ldcg(from + i);
    const T b = __ldcg(from + i + nthreads);
    const T c = __ldcg(from + i + 2 * nthreads);
    const T e = __ldcg(from + i + 3 * nthreads);
    __stcg(to + i, a);
    __stcg(to + i + nthreads, b);
    __stcg(to + i + 2 * nthreads, c);
    __stcg(to + i + 3 * nthreads, e);
  }
  for (; i < n; i += nthreads) __stcg(to + i, __ldcg(from + i));
}

// All M moves in array order by one cluster; `hd` counts T-words per
// row (floats, or float4 when the rows are 16-byte aligned).
template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kCopyThreads)
kv_chunk_copy_kernel(T* __restrict__ pool, T* __restrict__ scratch,
                     const int* __restrict__ src, const int* __restrict__ dst,
                     const int* __restrict__ ntok, int m, int t, int w,
                     long long hd) {
  __shared__ int s_src[kMaxMoves], s_dst[kMaxMoves], s_len[kMaxMoves];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int hi = t - w;
  for (int i = threadIdx.x; i < m; i += kCopyThreads) {
    s_src[i] = min(max(src[i], 0), hi);
    s_dst[i] = min(max(dst[i], 0), hi);
    const int n = ntok[i];
    const int tiled = n > 0 ? (n + kTile - 1) / kTile * kTile : 0;
    s_len[i] = min(tiled, w);
  }
  __syncthreads();
  const long long nthreads = static_cast<long long>(kCluster) * kCopyThreads;
  const long long tid =
      static_cast<long long>(cluster.block_rank()) * kCopyThreads +
      threadIdx.x;
  for (int j = 0; j < m; ++j) {      // uniform over the cluster
    const int len = s_len[j], s = s_src[j], d = s_dst[j];
    if (len == 0 || s == d) continue;
    const long long n = static_cast<long long>(len) * hd;
    const T* from = pool + static_cast<long long>(s) * hd;
    T* to = pool + static_cast<long long>(d) * hd;
    if (s < d + len && d < s + len) {  // overlapping ranges: stage
      cluster_copy(from, scratch, n, tid, nthreads);
      __threadfence();
      cluster.sync();
      cluster_copy<T>(scratch, to, n, tid, nthreads);
    } else {
      cluster_copy(from, to, n, tid, nthreads);
    }
    __threadfence();
    cluster.sync();
  }
}

}  // namespace

// pool (t, hd) f32 in place; rows (b,) int32; vals (b, hd) f32; on
// `stream`. Returns cudaGetLastError().
extern "C" int kv_append_launch(void* pool, const void* rows,
                                const void* vals, int b, int t,
                                long long hd, void* stream) {
  if (b > 0 && hd > 0) {
    const long long units = (hd & 3) == 0 ? hd / 4 : hd;
    const long long per_row = (units + kThreads - 1) / kThreads;
    dim3 grid(static_cast<unsigned>(per_row < 64 ? per_row : 64), b);
    kv_append_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(pool), static_cast<const int*>(rows),
        static_cast<const float*>(vals), t, hd);
  }
  return static_cast<int>(cudaGetLastError());
}

// pool (t, hd) f32 in place; src/dst/ntok (m,) int32 with
// m <= kMaxMoves; scratch (w, hd) f32; w <= t; on `stream`. One launch
// of one cluster. Returns cudaGetLastError().
extern "C" int kv_chunk_copy_launch(void* pool, void* scratch,
                                    const void* src, const void* dst,
                                    const void* ntok, int m, int t, int w,
                                    long long hd, void* stream) {
  if (m > 0 && w > 0 && hd > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = (hd & 3) == 0 &&
                     reinterpret_cast<unsigned long long>(pool) % 16 == 0 &&
                     reinterpret_cast<unsigned long long>(scratch) % 16 == 0;
    if (vec) {
      kv_chunk_copy_kernel<float4><<<kCluster, kCopyThreads, 0, s>>>(
          static_cast<float4*>(pool), static_cast<float4*>(scratch),
          static_cast<const int*>(src), static_cast<const int*>(dst),
          static_cast<const int*>(ntok), m, t, w, hd / 4);
    } else {
      kv_chunk_copy_kernel<float><<<kCluster, kCopyThreads, 0, s>>>(
          static_cast<float*>(pool), static_cast<float*>(scratch),
          static_cast<const int*>(src), static_cast<const int*>(dst),
          static_cast<const int*>(ntok), m, t, w, hd);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
