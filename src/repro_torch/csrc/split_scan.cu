// T_NS split scoring with a resumable running-best carry.
//
// Replaces the TPU kernel repro/kernels/split_scan/kernel.py:
// split_scan_block (body _split_scan_kernel). Per (tree, slot): prefix sum
// over the bin axis, Eq. 2-6 gain ratio (or the variance gain behind the
// regression flag) of every threshold of every feature of the slab, masked
// features at -inf, first-occurrence argmax over the flat index
// f*(B-1)+thr, the winner's left/right counts, folded into the carry with
// "strictly greater, or carry feature < 0" (force-accept of the first slab).
//
// What bounds it on an H100: reading the [tc, S, W, B, C] histogram slab
// once from device memory (bytes); the arithmetic per candidate (a few
// logs and divisions) is small beside the card's float32 rate.
//
// Design: one block per (tree, slot), 256 threads. For each feature of the
// slab the block stages its [B, C] histogram in shared memory, C threads
// take the prefix sum per channel left to right (the order torch.cumsum
// uses on the CPU; on integer counts every order is exact), and thread thr
// scores threshold thr. Sums over the C channels run left to right and
// every operation follows core/gain.py in the port one for one: the log is
// the reference CPU backend's polynomial (ref_logf) and the only fused
// multiply-adds are the explicit fmaf calls that the reference's compiler
// forms too; built with -fmad=false, so nvcc contracts nothing else and
// the gains are bitwise the plain PyTorch version's. Each
// thread keeps its best (gain, index); the block reduces pairs, ties going
// to the lower index. The winner's counts are summed again from the
// histogram in the same order as the prefix sum, so they are bitwise the
// cumsum's values. The carry tensors are read and written in place.
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTiny = 1e-38f;          // subnormal on purpose: matches the reference
constexpr float kSplitInfoFloor = 1e-12f;

// Natural log, bit for bit the reference CPU backend's (XLA's Cephes
// polynomial with fused multiply-adds) and the port's plain version
// (core/gain.py: _log). Constants are given as float32 bit patterns.
__device__ __forceinline__ float ref_logf(float x) {
  x = fmaxf(x, __int_as_float(0x00800000));            // smallest normal
  const int i = __float_as_int(x);
  float m = __int_as_float((i & ~0x7f800000) | 0x3f000000);
  float e = 1.0f + (float)((i >> 23) - 0x7f);
  const bool below = m < __int_as_float(0x3f3504f3);   // sqrt(1/2)
  const float m_lo = below ? m : 0.0f;
  m = m - 1.0f;
  e = e - (below ? 1.0f : 0.0f);
  m = m + m_lo;
  const float x2 = m * m;
  const float x3 = x2 * m;
  float y = fmaf(m, __int_as_float(0x3d9021bb), __int_as_float(0xbdebd1b8));
  float y1 = fmaf(m, __int_as_float(0xbdfe5d4f), __int_as_float(0x3e11e9bf));
  float y2 = fmaf(m, __int_as_float(0x3e4cceac), __int_as_float(0xbe7ffffc));
  y = fmaf(y, m, __int_as_float(0x3def251a));
  y1 = fmaf(y1, m, __int_as_float(0xbe2aae50));
  y2 = fmaf(y2, m, __int_as_float(0x3eaaaaaa));
  y = fmaf(y, x3, y1);
  y = fmaf(y, x3, y2);
  y = fmaf(y, x3, __int_as_float(0xb95e8083) * e);
  m = m - x2 * 0.5f;
  m = m + y;
  return m + __int_as_float(0x3f318000) * e;
}

__device__ __forceinline__ float xlogx(float p) {
  return p > 0.0f ? p * ref_logf(fmaxf(p, kTiny)) : 0.0f;
}

// Entropy of a count vector v[c] = a[c] (right=false) or tot[c] - a[c] (right=true).
__device__ float entropy(const float* a, const float* tot, int C, bool right) {
  float s = right ? tot[0] - a[0] : a[0];
  for (int c = 1; c < C; ++c) s = s + (right ? tot[c] - a[c] : a[c]);
  const float d = fmaxf(s, kTiny);
  float h = xlogx((right ? tot[0] - a[0] : a[0]) / d);
  for (int c = 1; c < C; ++c) h = h + xlogx((right ? tot[c] - a[c] : a[c]) / d);
  return -h;
}

__device__ __forceinline__ float sse(float h0, float h1, float h2) {
  return h2 - h1 * h1 / fmaxf(h0, kTiny);
}

__device__ __forceinline__ bool better(float g, int i, float bg, int bi) {
  return g > bg || (g == bg && i < bi);
}

__global__ void split_scan_kernel(const float* __restrict__ hist,
                                  const uint8_t* __restrict__ mask, int f_base,
                                  float* gain, int* feat, int* thr_out,
                                  float* left_out, float* right_out,
                                  int S, int W, int B, int C, int regression) {
  extern __shared__ float sh[];
  float* cum = sh;                 // [B * C]
  __shared__ float red_g[kThreads / 32];
  __shared__ int red_i[kThreads / 32];

  const int ts = blockIdx.x;       // t * S + s
  const int t = ts / S;
  const float* h = hist + (long long)ts * W * B * C;
  const int nthr = B - 1;
  float best_g = -INFINITY;
  int best_i = INT_MAX;

  for (int f = 0; f < W; ++f) {
    __syncthreads();
    const float* hf = h + (long long)f * B * C;
    for (int j = threadIdx.x; j < B * C; j += blockDim.x) cum[j] = hf[j];
    __syncthreads();
    if (threadIdx.x < C) {
      const int c = threadIdx.x;
      float acc = cum[c];
      for (int b = 1; b < B; ++b) {
        acc = acc + cum[b * C + c];
        cum[b * C + c] = acc;
      }
    }
    __syncthreads();
    const int thr = threadIdx.x;
    if (thr < nthr) {
      const float* tot = cum + (B - 1) * C;
      const float* l = cum + thr * C;
      float g;
      if (regression) {
        const float r0 = tot[0] - l[0], r1 = tot[1] - l[1], r2 = tot[2] - l[2];
        g = sse(tot[0], tot[1], tot[2]) - sse(l[0], l[1], l[2]) - sse(r0, r1, r2);
        if (!(l[0] > 0.0f && r0 > 0.0f)) g = -INFINITY;
      } else {
        float n = tot[0];
        for (int c = 1; c < C; ++c) n = n + tot[c];
        const float h_node = entropy(tot, tot, C, false);
        float n_l = l[0], n_r = tot[0] - l[0];
        for (int c = 1; c < C; ++c) {
          n_l = n_l + l[c];
          n_r = n_r + (tot[c] - l[c]);
        }
        const float n_tot = fmaxf(n, kTiny);
        // Eq. 3 with the one fused multiply-add the reference's compiler forms
        const float h_cond = fmaf(n_r / n_tot, entropy(l, tot, C, true),
                                  (n_l / n_tot) * entropy(l, tot, C, false));
        const float gn = h_node - h_cond;
        const float p_l = n_l / n_tot;
        const float p_r = n_r / n_tot;
        const float split_info = -(xlogx(p_l) + xlogx(p_r));
        g = gn / fmaxf(split_info, kSplitInfoFloor);
        if (!(n_l > 0.0f && n_r > 0.0f)) g = -INFINITY;
      }
      if (mask[(long long)t * W + f] == 0) g = -INFINITY;
      const int idx = f * nthr + thr;
      if (better(g, idx, best_g, best_i)) { best_g = g; best_i = idx; }
    }
  }

  // block argmax over (gain, index), ties to the lower index
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(0xffffffffu, best_g, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(og, oi, best_g, best_i)) { best_g = og; best_i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { red_g[warp] = best_g; red_i[warp] = best_i; }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int k = 1; k < (int)(blockDim.x / 32); ++k) {
    if (better(red_g[k], red_i[k], best_g, best_i)) { best_g = red_g[k]; best_i = red_i[k]; }
  }
  if (best_i == INT_MAX) best_i = 0;       // no candidate at all (W = 0 or B = 1)
  const int fl = best_i / nthr;
  const int th = best_i - fl * nthr;
  if (!(best_g > gain[ts] || feat[ts] < 0)) return;
  gain[ts] = best_g;
  feat[ts] = f_base + fl;
  thr_out[ts] = th;
  const float* hf = h + (long long)fl * B * C;
  for (int c = 0; c < C; ++c) {
    float acc = hf[c];
    float lc = acc;
    for (int b = 1; b < B; ++b) {
      acc = acc + hf[b * C + c];
      if (b == th) lc = acc;
    }
    left_out[(long long)ts * C + c] = lc;
    right_out[(long long)ts * C + c] = acc - lc;
  }
}

}  // namespace

extern "C" int prf_split_scan(const void* hist, const void* mask, int f_base,
                              void* gain, void* feat, void* thr, void* left,
                              void* right, int tc, int S, int W, int B, int C,
                              int regression, void* stream) {
  if (tc > 0 && S > 0 && W > 0) {
    const size_t smem = (size_t)B * C * sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(split_scan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    split_scan_kernel<<<tc * S, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)hist, (const uint8_t*)mask, f_base, (float*)gain,
        (int*)feat, (int*)thr, (float*)left, (float*)right, S, W, B, C,
        regression);
  }
  return (int)cudaGetLastError();
}
