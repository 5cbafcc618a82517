// Decode attention over a contiguous slab KV pool, for Hopper (sm_90a).
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
// Here one block owns one (sequence, kv head) and carries that state
// itself, in float32:
//   * the G query heads of the kv head sit in registers, lane l holding
//     elements l, l + 32, ... of each (so D <= 256, and a warp's loads of
//     one K or V row are coalesced);
//   * each of the 8 warps takes tokens w, w + 8, ... (two at a time, to
//     keep two rows' loads in flight), computes the G scores with a warp
//     reduction and folds them into its own online softmax state;
//   * the 8 warp states are merged in a fixed order through shared
//     memory, and the normalized result written once.
// Only the n_b live tokens are read: tiles past the length, which the
// TPU visits masked, change nothing. Which warp handles which token
// depends on the token's position alone, never on B, so a sequence gets
// the same bits in a batch of 64 as alone (the serving harness's
// batched-vs-legacy parity rests on this). No atomics.
//
// Bound: bytes. Per (sequence, kv head) it reads n_b rows of K and V
// (2 * n_b * D * 4 bytes) for 4 * n_b * G * D flops, G/2 flops a byte,
// far below the card's float32 balance. The design keeps two rows' loads
// in flight per warp and 8 warps per block; a split-KV pass across blocks
// and TMA tiles would move more bytes at once (later work).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;

template <int VPL, int MAXG>
__global__ void __launch_bounds__(kThreads)
slab_decode_kernel(const float* __restrict__ q,
                   const float* __restrict__ k_pool,
                   const float* __restrict__ v_pool,
                   const int* __restrict__ starts,
                   const int* __restrict__ lens, float* __restrict__ out,
                   int t, int hkv, int g_heads, int d, int w_max,
                   float sm_scale) {
  __shared__ float s_m[kWarps][MAXG];
  __shared__ float s_l[kWarps][MAXG];
  __shared__ float s_acc[MAXG * VPL * 32];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hq = hkv * g_heads;
  const long long row_stride = static_cast<long long>(hkv) * d;

  float qv[MAXG][VPL];
  float acc[MAXG][VPL];
  float m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    const float* qrow =
        q + (static_cast<long long>(b) * hq + h * g_heads + g) * d;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int e = lane + 32 * v;
      qv[g][v] = (g < g_heads && e < d) ? qrow[e] : 0.0f;
      acc[g][v] = 0.0f;
    }
    m[g] = -INFINITY;
    l[g] = 0.0f;
  }

  const int n = min(max(lens[b], 0), w_max);
  const int start = starts[b];
  const float* kbase = k_pool + static_cast<long long>(h) * d;
  const float* vbase = v_pool + static_cast<long long>(h) * d;

  for (int w0 = 2 * warp; w0 < n; w0 += 2 * kWarps) {
    const int cnt = min(2, n - w0);
    float kr[2][VPL], vr[2][VPL];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = min(max(start + w0 + u, 0), t - 1);
      const float* kp = kbase + row * row_stride;
      const float* vp = vbase + row * row_stride;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int e = lane + 32 * v;
        const bool ok = u < cnt && e < d;
        kr[u][v] = ok ? kp[e] : 0.0f;
        vr[u][v] = ok ? vp[e] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u >= cnt) break;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= g_heads) break;
        float s = 0.0f;
#pragma unroll
        for (int v = 0; v < VPL; ++v) s = fmaf(qv[g][v], kr[u][v], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        s *= sm_scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
        m[g] = m_new;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          acc[g][v] = fmaf(p, vr[u][v], acc[g][v] * alpha);
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
  }
  for (int i = threadIdx.x; i < MAXG * VPL * 32; i += kThreads) {
    s_acc[i] = 0.0f;
  }
  __syncthreads();
  float scale[MAXG];
  float total[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      if (s_l[w][g] > 0.0f) sum += s_l[w][g] * expf(s_m[w][g] - mx);
    }
    total[g] = sum;
    scale[g] = l[g] > 0.0f ? expf(m[g] - mx) : 0.0f;
  }
  // Merge the warps' accumulators in warp order (fixed, deterministic).
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          float* cell = &s_acc[(g * VPL + v) * 32 + lane];
          *cell = fmaf(acc[g][v], scale[g], *cell);
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < g_heads * d; i += kThreads) {
    const int g = i / d;
    const int e = i - g * d;
    const float val = s_acc[(g * VPL + e / 32) * 32 + e % 32];
    float norm = 0.0f;
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg) {
      if (gg == g) norm = total[gg];
    }
    out[(static_cast<long long>(b) * hq + h * g_heads + g) * d + e] =
        norm > 0.0f ? val / norm : 0.0f;
  }
}

template <int VPL>
cudaError_t launch_vpl(const float* q, const float* k, const float* v,
                       const int* starts, const int* lens, float* out, int b,
                       int t, int hkv, int g, int d, int w, float scale,
                       cudaStream_t stream) {
  const dim3 grid(hkv, b);
  if (g <= 1) {
    slab_decode_kernel<VPL, 1><<<grid, kThreads, 0, stream>>>(
        q, k, v, starts, lens, out, t, hkv, g, d, w, scale);
  } else if (g <= 2) {
    slab_decode_kernel<VPL, 2><<<grid, kThreads, 0, stream>>>(
        q, k, v, starts, lens, out, t, hkv, g, d, w, scale);
  } else if (g <= 4) {
    slab_decode_kernel<VPL, 4><<<grid, kThreads, 0, stream>>>(
        q, k, v, starts, lens, out, t, hkv, g, d, w, scale);
  } else {
    slab_decode_kernel<VPL, kMaxG><<<grid, kThreads, 0, stream>>>(
        q, k, v, starts, lens, out, t, hkv, g, d, w, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q (b, hkv * g, d) f32, k/v pools (t, hkv, d) f32, starts/lens (b,)
// int32 -> out (b, hkv * g, d) f32, on `stream`; needs 1 <= d <= 256,
// 1 <= g <= 8 and w >= 0 (checked by the wrapper). Returns
// cudaGetLastError().
extern "C" int slab_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* starts, const void* lens, void* out, int b, int t, int hkv,
    int g, int d, int w, float sm_scale, void* stream) {
  if (b <= 0 || hkv <= 0) return static_cast<int>(cudaGetLastError());
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pool);
  const float* vf = static_cast<const float*>(v_pool);
  const int* sp = static_cast<const int*>(starts);
  const int* lp = static_cast<const int*>(lens);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 32) {
    err = launch_vpl<1>(qf, kf, vf, sp, lp, of, b, t, hkv, g, d, w,
                        sm_scale, s);
  } else if (d <= 64) {
    err = launch_vpl<2>(qf, kf, vf, sp, lp, of, b, t, hkv, g, d, w,
                        sm_scale, s);
  } else if (d <= 128) {
    err = launch_vpl<4>(qf, kf, vf, sp, lp, of, b, t, hkv, g, d, w,
                        sm_scale, s);
  } else {
    err = launch_vpl<8>(qf, kf, vf, sp, lp, of, b, t, hkv, g, d, w,
                        sm_scale, s);
  }
  return static_cast<int>(err);
}
