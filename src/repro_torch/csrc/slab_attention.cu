// Decode attention over a contiguous slab KV pool, for Hopper (sm_90a):
// split-KV flash-decoding with K/V tiles staged in shared memory.
//
// Replaces the TPU kernel repro/kernels/slab_attention.py::
// slab_decode_attention_pallas. q (B, Hq, D) attends over each
// sequence's chunk of the (T, Hkv, D) float32 pools: tokens
// starts[b] + w for w < n_b = min(lens[b], W) (rows clamped into
// [0, T - 1], as the window oracle gathers them), with GQA: query head
// hq uses kv head hq / G, G = Hq / Hkv. An empty sequence outputs 0.
//
// The TPU grid walks a sequence's tiles in order and carries the online
// softmax state (m, l, acc) in scratch from one grid step to the next.
// Here a sequence's live tokens are cut by position into splits of
// `chunk` tokens (128, or a multiple of it for windows past 8,192
// tokens: set by the wrapper from W alone, never from B or the lengths),
// and two kernels run:
//   1. split kernel, grid (workers, Hkv, B), 128 threads: a block takes
//      splits x, x + workers, ... of its (sequence, kv head) and, for
//      each, streams 32-token K and V tiles into shared memory with
//      cp.async (two stages: the next tile lands while this one is
//      used; every thread both copies and computes, so the copy groups'
//      wait_group and a block barrier serve as the ring's barrier, with
//      no mbarrier; a third stage, 2 x 32 x (D + 4) floats more, would
//      cost occupancy). Per tile: every (token, D-quarter) thread forms the G
//      partial dot products from shared memory, and one two-step
//      shuffle per head finishes the tile's G x 32 scores; one warp per
//      head takes the tile's max and sum (a fixed butterfly) and
//      rescales; threads laid across D (float4 columns, the tile's
//      tokens dealt to up to 8 groups in a fixed pattern) accumulate
//      P.V for all G heads. The groups are summed in group order and the
//      split's (m, l, acc) written to scratch.
//   2. combine kernel, grid (Hq, B): merges a sequence's splits in split
//      order and normalizes.
// Every order above depends on token positions, D and G only, so a
// sequence gets the same bits alone as in any batch (the serving
// harness's batched-vs-legacy parity and its one-replay CUDA graph rest
// on this). No atomics. Blocks past a sequence's length exit at once.
//
// Bound: bytes. Per (sequence, kv head) it reads n_b rows of K and V
// (2 * n_b * D * 4 bytes) for 4 * n_b * G * D flops, G/2 flops a byte,
// far below the card's float32 balance (~20 flops a byte): about 4 us of
// float32 FMA at G = 4 against ~39 us of bytes at the main path's shape.
// So it stays in float32 FMA on the CUDA cores: TF32 or wgmma would buy
// no time and would change bits under the serving harness's argmax.
// Splitting by position fills the card whatever the length spread
// (a 1,024-token sequence is 8 splits), and the tiles put many rows'
// loads in flight per block; the scratch round trip costs ~(D + 2) * 4
// bytes per (split, head), a few percent of the K/V bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kTile = 32;       // tokens per shared-memory tile
constexpr int kStages = 2;      // tiles in flight per block
constexpr int kMaxG = 8;        // query heads per kv head
constexpr int kMaxGroups = 8;   // token groups of the P.V layout
constexpr int kMaxD = 256;
constexpr int kMaxSplits = 64;  // splits a sequence may have

// Padded row of a tile in floats: D rounded up to float4 plus one float4,
// so the 8 rows a quarter-warp reads at once fall in distinct banks.
__host__ __device__ inline int padded(int d) { return (d + 3) / 4 * 4 + 4; }

// Dynamic shared memory (floats): K and V stages, q, the tile's scores /
// probabilities and the per-head rescale factors.
__host__ __device__ inline int smem_floats(int d, int maxg) {
  const int dp = padded(d);
  return 2 * kStages * kTile * dp + maxg * dp + maxg * kTile + maxg;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Queue the copy of `rows` K and V rows, pool rows first, first + 1, ...
// (each clamped into [0, t - 1]), into one stage, as one cp.async group.
template <bool VEC>
__device__ __forceinline__ void issue_tile(
    float* dk, float* dv, const float* kbase, const float* vbase,
    long long first, int rows, int t, long long row_stride, int d, int dp) {
  if (VEC) {
    const int cu = d / 4;
    for (int x = threadIdx.x; x < rows * cu; x += kThreads) {
      const int r = x / cu;
      const int c = x - r * cu;
      long long row = first + r;
      row = row < 0 ? 0 : (row >= t ? t - 1 : row);
      cp_async16(dk + r * dp + 4 * c, kbase + row * row_stride + 4 * c);
      cp_async16(dv + r * dp + 4 * c, vbase + row * row_stride + 4 * c);
    }
  } else {
    for (int x = threadIdx.x; x < rows * d; x += kThreads) {
      const int r = x / d;
      const int c = x - r * d;
      long long row = first + r;
      row = row < 0 ? 0 : (row >= t ? t - 1 : row);
      cp_async4(dk + r * dp + c, kbase + row * row_stride + c);
      cp_async4(dv + r * dp + c, vbase + row * row_stride + c);
    }
  }
  cp_async_commit();
}

template <int MAXG, bool VEC>
__global__ void __launch_bounds__(kThreads)
slab_decode_split_kernel(const float* __restrict__ q,
                         const float* __restrict__ k_pool,
                         const float* __restrict__ v_pool,
                         const int* __restrict__ starts,
                         const int* __restrict__ lens,
                         float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int t, int hkv,
                         int g_heads, int d, int w_max, int chunk, int nsp,
                         float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded(d);
  const int cu = (d + 3) / 4;           // float4 columns of a row
  float* s_k = smem;                    // [kStages][kTile][dp]
  float* s_v = s_k + kStages * kTile * dp;
  float* s_q = s_v + kStages * kTile * dp;   // [MAXG][dp]
  float* s_p = s_q + MAXG * dp;              // [MAXG][kTile]
  float* s_alpha = s_p + MAXG * kTile;       // [MAXG]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = min(max(lens[b], 0), w_max);
  if (static_cast<long long>(blockIdx.x) * chunk >= n) return;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hq = hkv * g_heads;
  const long long row_stride = static_cast<long long>(hkv) * d;
  const float* kbase = k_pool + static_cast<long long>(h) * d;
  const float* vbase = v_pool + static_cast<long long>(h) * d;
  const long long head0 = static_cast<long long>(b) * hq + h * g_heads;

  // q (zero past D and for heads past G); zero the stages' pad columns,
  // which the copies never write and the scalar path's float4 reads see
  for (int x = threadIdx.x; x < MAXG * dp; x += kThreads) {
    const int g = x / dp;
    const int e = x - g * dp;
    s_q[x] = (g < g_heads && e < d) ? q[(head0 + g) * d + e] : 0.0f;
  }
  const int pad = dp - d;
  for (int x = threadIdx.x; x < 2 * kStages * kTile * pad; x += kThreads) {
    const int r = x / pad;
    smem[r * dp + d + (x - r * pad)] = 0.0f;
  }

  // scores: thread = (token warp * 8 + lane % 8, D-quarter lane / 8)
  const int s_tok = warp * 8 + (lane & 7);
  const int s_sub = lane >> 3;
  // P.V: thread = (token group, float4 column)
  const int groups = min(kThreads / cu, kMaxGroups);
  const int grp = threadIdx.x / cu;
  const int col = threadIdx.x - grp * cu;
  const bool pv = grp < groups;
  const long long seq0 = static_cast<long long>(starts[b]);

  for (int split = blockIdx.x; static_cast<long long>(split) * chunk < n;
       split += gridDim.x) {
    const int lo = split * chunk;
    const int cnt = min(chunk, n - lo);
    const int ntiles = (cnt + kTile - 1) / kTile;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.0f, 0.0f};
    float acc[MAXG][4];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] = 0.0f;
    }
    __syncthreads();  // q and pads written; the last split's reads done
    issue_tile<VEC>(s_k, s_v, kbase, vbase, seq0 + lo, min(kTile, cnt), t,
                    row_stride, d, dp);
    for (int i = 0; i < ntiles; ++i) {
      if (i + 1 < ntiles) {
        const int nxt = (i + 1) % kStages;
        issue_tile<VEC>(s_k + nxt * kTile * dp, s_v + nxt * kTile * dp,
                        kbase, vbase, seq0 + lo + (i + 1) * kTile,
                        min(kTile, cnt - (i + 1) * kTile), t, row_stride, d,
                        dp);
      } else {
        cp_async_commit();  // an empty group keeps wait_group's count
      }
      cp_async_wait_one();
      __syncthreads();
      const float* tk = s_k + (i % kStages) * kTile * dp;
      const float* tv = s_v + (i % kStages) * kTile * dp;
      const int rows = min(kTile, cnt - i * kTile);

      // (a) G x 32 scores
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[g] = 0.0f;
      if (s_tok < rows) {
        for (int u = s_sub; u < cu; u += 4) {
          const float4 kk =
              *reinterpret_cast<const float4*>(tk + s_tok * dp + 4 * u);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g >= g_heads) break;
            const float4 qq =
                *reinterpret_cast<const float4*>(s_q + g * dp + 4 * u);
            part[g] = fmaf(qq.x, kk.x, part[g]);
            part[g] = fmaf(qq.y, kk.y, part[g]);
            part[g] = fmaf(qq.z, kk.z, part[g]);
            part[g] = fmaf(qq.w, kk.w, part[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], 8);
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], 16);
      }
      if (s_sub == 0) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          s_p[g * kTile + s_tok] = (s_tok < rows && g < g_heads)
                                       ? part[g] * sm_scale : -INFINITY;
        }
      }
      __syncthreads();

      // (b) one max and one sum per head and tile: warp w takes heads
      //     w and w + 4
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int g = warp + 4 * j;
        if (g < MAXG && g < g_heads) {
          const float s = s_p[g * kTile + lane];
          float mx = s;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          }
          const float m_new = fmaxf(m_run[j], mx);  // a live token is here
          const float p = s == -INFINITY ? 0.0f : expf(s - m_new);
          float sum = p;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          }
          const float alpha = expf(m_run[j] - m_new);
          l_run[j] = l_run[j] * alpha + sum;
          m_run[j] = m_new;
          s_p[g * kTile + lane] = p;
          if (lane == 0) s_alpha[g] = alpha;
        }
      }
      __syncthreads();

      // (c) P.V for every head, threads across D
      if (pv) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= g_heads) break;
          const float a = s_alpha[g];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[g][c] *= a;
        }
        for (int tt = grp; tt < rows; tt += groups) {
          const float4 vv =
              *reinterpret_cast<const float4*>(tv + tt * dp + 4 * col);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g >= g_heads) break;
            const float p = s_p[g * kTile + tt];
            acc[g][0] = fmaf(p, vv.x, acc[g][0]);
            acc[g][1] = fmaf(p, vv.y, acc[g][1]);
            acc[g][2] = fmaf(p, vv.z, acc[g][2]);
            acc[g][3] = fmaf(p, vv.w, acc[g][3]);
          }
        }
      }
      __syncthreads();  // this stage is refilled two tiles on
    }

    // the split's (m, l) and its acc, the groups summed in group order
    // (through the K stages, free now)
    const long long slot = split;
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int g = warp + 4 * j;
        if (g < MAXG && g < g_heads) {
          float* ml = part_ml + ((head0 + g) * nsp + slot) * 2;
          ml[0] = m_run[j];
          ml[1] = l_run[j];
        }
      }
    }
    float* red = s_k;  // [groups][MAXG][dp]
    if (pv) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= g_heads) break;
        *reinterpret_cast<float4*>(red + (grp * MAXG + g) * dp + 4 * col) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      }
    }
    __syncthreads();
    for (int x = threadIdx.x; x < g_heads * d; x += kThreads) {
      const int g = x / d;
      const int e = x - g * d;
      float s = red[g * dp + e];
      for (int j = 1; j < groups; ++j) s += red[(j * MAXG + g) * dp + e];
      part_acc[((head0 + g) * nsp + slot) * d + e] = s;
    }
  }
}

// One block per (query head, sequence): merge the splits in split order.
__global__ void __launch_bounds__(kThreads)
slab_decode_combine_kernel(const float* __restrict__ part_acc,
                           const float* __restrict__ part_ml,
                           const int* __restrict__ lens,
                           float* __restrict__ out, int hq, int d,
                           int w_max, int chunk, int nsp) {
  __shared__ float s_scale[kMaxSplits];
  __shared__ float s_norm;
  const int b = blockIdx.y;
  const long long head = static_cast<long long>(b) * hq + blockIdx.x;
  float* o = out + head * d;
  const int n = min(max(lens[b], 0), w_max);
  const int ns = n > 0 ? static_cast<int>((n + static_cast<long long>(chunk)
                                           - 1) / chunk) : 0;
  if (ns == 0) {
    for (int e = threadIdx.x; e < d; e += kThreads) o[e] = 0.0f;
    return;
  }
  const float* ml = part_ml + head * nsp * 2;
  const float* pa = part_acc + head * nsp * d;
  if (threadIdx.x == 0) {
    float mx = -INFINITY;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, ml[2 * s]);
    float norm = 0.0f;
    for (int s = 0; s < ns; ++s) {
      const float sc = expf(ml[2 * s] - mx);
      s_scale[s] = sc;
      norm += ml[2 * s + 1] * sc;
    }
    s_norm = norm;
  }
  __syncthreads();
  const float norm = s_norm;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float a = 0.0f;
    for (int s = 0; s < ns; ++s) a += pa[static_cast<long long>(s) * d + e]
                                      * s_scale[s];
    o[e] = norm > 0.0f ? a / norm : 0.0f;
  }
}

template <int MAXG, bool VEC>
void launch_split(dim3 grid, size_t smem, cudaStream_t stream,
                  const float* q, const float* k, const float* v,
                  const int* starts, const int* lens, float* part_acc,
                  float* part_ml, int t, int hkv, int g, int d, int w,
                  int chunk, int nsp, float scale) {
  slab_decode_split_kernel<MAXG, VEC><<<grid, kThreads, smem, stream>>>(
      q, k, v, starts, lens, part_acc, part_ml, t, hkv, g, d, w, chunk, nsp,
      scale);
}

template <int MAXG>
cudaError_t allow_smem() {
  const int bytes = smem_floats(kMaxD, MAXG) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      slab_decode_split_kernel<MAXG, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(slab_decode_split_kernel<MAXG, false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// q (b, hkv * g, d) f32, k/v pools (t, hkv, d) f32, starts/lens (b,)
// int32 -> out (b, hkv * g, d) f32, on `stream`. part_acc (b, hkv * g,
// nsp, d) and part_ml (b, hkv * g, nsp, 2) f32 are the splits' scratch;
// a split holds `chunk` tokens (a multiple of 32), nsp = ceil(w / chunk),
// and `workers` blocks share a (sequence, kv head)'s splits. Needs
// 1 <= d <= 256, 1 <= g <= 8 and w >= 0 (checked by the wrapper).
// Returns cudaGetLastError().
extern "C" int slab_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* starts, const void* lens, void* out, void* part_acc,
    void* part_ml, int b, int t, int hkv, int g, int d, int w, int chunk,
    int nsp, int workers, float sm_scale, void* stream) {
  if (b <= 0 || hkv <= 0) return static_cast<int>(cudaGetLastError());
  if (g < 1 || g > kMaxG || d < 1 || d > kMaxD ||
      nsp > kMaxSplits ||
      (nsp > 0 && (chunk <= 0 || chunk % kTile || workers < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool smem_set[64] = {};  // per device: raise the smem cap once
  if (dev < 64 && !smem_set[dev]) {
    if ((err = allow_smem<1>()) != cudaSuccess ||
        (err = allow_smem<2>()) != cudaSuccess ||
        (err = allow_smem<4>()) != cudaSuccess ||
        (err = allow_smem<8>()) != cudaSuccess) {
      return static_cast<int>(err);
    }
    smem_set[dev] = true;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pool);
  const float* vf = static_cast<const float*>(v_pool);
  const int* sp = static_cast<const int*>(starts);
  const int* lp = static_cast<const int*>(lens);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsp > 0) {
    const bool vec = d % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(k_pool) |
          reinterpret_cast<uintptr_t>(v_pool)) & 15) == 0;
    const int maxg = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : kMaxG;
    const size_t smem = static_cast<size_t>(smem_floats(d, maxg)) * 4;
    const dim3 grid(workers, hkv, b);
#define SLAB_SPLIT(G_, V_)                                                 \
  launch_split<G_, V_>(grid, smem, s, qf, kf, vf, sp, lp, pa, pm, t, hkv, \
                       g, d, w, chunk, nsp, sm_scale)
    if (vec) {
      if (maxg == 1) SLAB_SPLIT(1, true);
      else if (maxg == 2) SLAB_SPLIT(2, true);
      else if (maxg == 4) SLAB_SPLIT(4, true);
      else SLAB_SPLIT(8, true);
    } else {
      if (maxg == 1) SLAB_SPLIT(1, false);
      else if (maxg == 2) SLAB_SPLIT(2, false);
      else if (maxg == 4) SLAB_SPLIT(4, false);
      else SLAB_SPLIT(8, false);
    }
#undef SLAB_SPLIT
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  slab_decode_combine_kernel<<<dim3(hkv * g, b), kThreads, 0, s>>>(
      pa, pm, lp, static_cast<float*>(out), hkv * g, d, w,
      nsp > 0 ? chunk : 1, nsp);
  return static_cast<int>(cudaGetLastError());
}
