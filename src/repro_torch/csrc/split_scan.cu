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
// What bounds it on an H100: reading the admitted features' [B, C]
// histograms once from device memory (bytes); a masked feature is never
// read (its candidates are -inf whatever it holds), and the arithmetic per
// candidate (a few logs and divisions) is small beside the card's float32
// rate.
//
// Design: one warp per (tree, slot), 8 slots to a block, no __syncthreads
// at all. The warp reads its tree's mask 32 features at a time into one
// ballot and visits the admitted features only: a masked feature's
// histogram is never read. It loads an admitted one (float4 loads when
// B * C is a multiple of 4) into its own shared-memory buffer (rows padded
// to an odd stride: no bank conflicts), and skips it after the load if
// every count is 0 (every split has an empty side: -inf; at level 0 all
// slots but one are empty). Lane l owns bins l, l + 32, ... For
// classification the prefix over bins is a warp shuffle scan per channel:
// the counts are integers below 2^24, so every order of summation gives
// the cumsum's values exactly. Regression channels (y, y^2) are summed
// left to right in float32 by one lane each, the order of the plain
// version's gain._bin_cumsum and of the reference's cumsum on the CPU, so
// their winners stay those of the plain version. Each lane then
// scores its thresholds (two at B = 64) with the node's entropy hoisted
// out of the threshold loop. Sums over the C channels run left to right
// and every operation follows core/gain.py in the port one for one: the
// log is the reference CPU backend's polynomial (ref_logf) and the only
// fused multiply-adds are the explicit fmaf calls that the reference's
// compiler forms too; built with -fmad=false, so nvcc contracts nothing
// else and the gains are bitwise the plain PyTorch version's. (gain,
// index) pairs are reduced in the warp, ties to the lower index; a best of
// -inf takes index 0, the first-occurrence argmax over a slab whose every
// candidate is -inf (which is what makes skipping sound). The carry is
// folded once per slot; the winner's counts are summed again from the
// histogram (classification by a warp reduction, exact on integer counts;
// regression left to right). The carry tensors are read and written in
// place. The first design (one block of 256 threads per (tree, slot),
// features in sequence, three __syncthreads each, every feature read) took
// 2.635 ms at the PRF main path's level-0 slab on an NVIDIA H100 80GB HBM3
// at 700 W (chip_smoke.py).
//
// A class axis too wide for a warp's [B, C | 1] buffer (classification
// only: regression has 3 channels) takes split_scan_wide_kernel: the warp
// loads the feature's classes in tiles of Ct (`class_tile`, chosen by the
// wrapper: kernels/split_scan/ops.class_tile) and passes over them twice.
// Pass one sums, for each of the lane's thresholds (at most 8: B <= 256),
// the left and right counts and the node's total, class by class in
// order; pass two reloads and rescans each tile (prefix sums of integer
// counts are exact, so the values are the same) and sums the entropies'
// x log x terms in the same order, divided by pass one's sums. The running
// sums live in registers and every sum runs over the classes left to
// right, as in the one-buffer kernel, so the gains stay bitwise the plain
// version's.
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 200 * 1024;   // dynamic shared memory a block may take
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

// Reduces (gain, index) over the warp; every lane ends with the best.
__device__ __forceinline__ void warp_best(float& g, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_xor_sync(0xffffffffu, g, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(og, oi, g, i)) { g = og; i = oi; }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// In-place prefix sum over the bins of a warp's [B, Cp]-strided buffer,
// channels [0, C): a warp shuffle scan per channel, exact on integer counts.
__device__ __forceinline__ void scan_bins(float* cum, int B, int C, int Cp, int lane) {
  for (int c = 0; c < C; ++c) {
    float carry = 0.0f;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      float incl = b < B ? cum[b * Cp + c] : 0.0f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += n;
      }
      if (b < B) cum[b * Cp + c] = carry + incl;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

// The warp's best (gain, flat index) over the slab, folded into the carry of
// slot ts: "strictly greater, or carry feature < 0"; the winner's left and
// right counts summed again from its histogram h (the slot's [W, B, C]).
__device__ void fold_winner(float best_g, int best_i, const float* h, int f_base, float* gain,
                            int* feat, int* thr_out, float* left_out, float* right_out, int ts,
                            int B, int C, int regression, int lane) {
  const int nthr = B - 1;
  const long long BC = (long long)B * C;
  // argmax over (gain, index), ties to the lower index
  warp_best(best_g, best_i);
  if (best_g == -INFINITY) best_i = 0;     // the argmax of all -inf is the first candidate
  if (!(best_g > gain[ts] || feat[ts] < 0)) return;
  const int fl = best_i / nthr;
  const int th = best_i - fl * nthr;
  if (lane == 0) {
    gain[ts] = best_g;
    feat[ts] = f_base + fl;
    thr_out[ts] = th;
  }
  const float* hf = h + (long long)fl * BC;
  if (regression) {
    if (lane < C) {
      float acc = hf[lane];
      float lc = acc;
      for (int b = 1; b < B; ++b) {
        acc = acc + hf[b * C + lane];
        if (b == th) lc = acc;
      }
      left_out[(long long)ts * C + lane] = lc;
      right_out[(long long)ts * C + lane] = acc - lc;
    }
    return;
  }
  for (int c = 0; c < C; ++c) {
    float lsum = 0.0f, tsum = 0.0f;
    for (int b = lane; b < B; b += 32) {
      const float v = hf[b * C + c];
      tsum += v;
      if (b <= th) lsum += v;
    }
    lsum = warp_sum(lsum);
    tsum = warp_sum(tsum);
    if (lane == 0) {
      left_out[(long long)ts * C + c] = lsum;
      right_out[(long long)ts * C + c] = tsum - lsum;
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
split_scan_kernel(const float* __restrict__ hist, const uint8_t* __restrict__ mask, int f_base,
                  float* gain, int* feat, int* thr_out, float* left_out, float* right_out, int TS,
                  int S, int W, int B, int C, int regression) {
  extern __shared__ float sh[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ts = blockIdx.x * (blockDim.x / 32) + warp;   // t * S + s: this warp's slot
  if (ts >= TS) return;
  const int Cp = C | 1;            // padded row stride of the warp's [B, C] buffer
  float* cum = sh + warp * B * Cp;
  const int t = ts / S;
  const int BC = B * C;
  const float* h = hist + (long long)ts * W * BC;
  const int nthr = B - 1;
  float best_g = -INFINITY;
  int best_i = INT_MAX;

  for (int f0 = 0; f0 < W; f0 += 32) {
    // the admitted features of these 32, one bit each: a masked one is never read
    unsigned todo = __ballot_sync(0xffffffffu, f0 + lane < W && mask[(long long)t * W + f0 + lane]);
    while (todo) {
      const int f = f0 + __ffs(todo) - 1;
      todo &= todo - 1;
      const float* hf = h + (long long)f * BC;
      bool nonzero = false;
      __syncwarp();                // the last feature's readers are done
      if (BC % 4 == 0) {
        for (int e = lane; e < BC / 4; e += 32) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(hf) + e);
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * e + k, b = j / C;
            cum[b * Cp + j - b * C] = vs[k];
            nonzero |= vs[k] != 0.0f;
          }
        }
      } else {
        for (int j = lane; j < BC; j += 32) {
          const float v = __ldg(hf + j);
          const int b = j / C;
          cum[b * Cp + j - b * C] = v;
          nonzero |= v != 0.0f;
        }
      }
      if (!__any_sync(0xffffffffu, nonzero)) continue;  // empty: every split has an empty side
      __syncwarp();
      if (regression) {
        if (lane < C) {
          float acc = cum[lane];
          for (int b = 1; b < B; ++b) {
            acc = acc + cum[b * Cp + lane];
            cum[b * Cp + lane] = acc;
          }
        }
      } else {
        scan_bins(cum, B, C, Cp, lane);
      }
      __syncwarp();
      const float* tot = cum + (B - 1) * Cp;
      float n = tot[0];
      for (int c = 1; c < C; ++c) n = n + tot[c];
      const float n_tot = fmaxf(n, kTiny);
      const float h_node = regression ? sse(tot[0], tot[1], tot[2]) : entropy(tot, tot, C, false);
      for (int thr = lane; thr < nthr; thr += 32) {
        const float* l = cum + thr * Cp;
        float g;
        if (regression) {
          const float r0 = tot[0] - l[0], r1 = tot[1] - l[1], r2 = tot[2] - l[2];
          g = h_node - sse(l[0], l[1], l[2]) - sse(r0, r1, r2);
          if (!(l[0] > 0.0f && r0 > 0.0f)) g = -INFINITY;
        } else {
          float n_l = l[0], n_r = tot[0] - l[0];
          for (int c = 1; c < C; ++c) {
            n_l = n_l + l[c];
            n_r = n_r + (tot[c] - l[c]);
          }
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
        const int idx = f * nthr + thr;
        if (better(g, idx, best_g, best_i)) { best_g = g; best_i = idx; }
      }
    }
  }

  fold_winner(best_g, best_i, h, f_base, gain, feat, thr_out, left_out, right_out, ts, B, C,
              regression, lane);
}

constexpr int kMaxThrPerLane = 8;        // B - 1 <= 255 thresholds over 32 lanes

// Classification with C classes in tiles of Ct (see the note at the top).
__global__ void __launch_bounds__(kMaxWarps * 32)
split_scan_wide_kernel(const float* __restrict__ hist, const uint8_t* __restrict__ mask,
                       int f_base, float* gain, int* feat, int* thr_out, float* left_out,
                       float* right_out, int TS, int S, int W, int B, int C, int Ct) {
  extern __shared__ float sh[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ts = blockIdx.x * (blockDim.x / 32) + warp;
  if (ts >= TS) return;
  const int Cp = Ct | 1;
  float* cum = sh + warp * B * Cp;
  const int t = ts / S;
  const long long BC = (long long)B * C;
  const float* h = hist + (long long)ts * W * BC;
  const int nthr = B - 1;
  float best_g = -INFINITY;
  int best_i = INT_MAX;

  // loads classes [c0, c0 + nc) of feature row hf into the buffer, prefix-summed over bins
  auto load_tile = [&](const float* hf, int c0, int nc, bool& nonzero) {
    __syncwarp();                  // the last tile's readers are done
    for (int j = lane; j < B * nc; j += 32) {
      const int b = j / nc, c = j - b * nc;
      const float v = __ldg(hf + (long long)b * C + c0 + c);
      cum[b * Cp + c] = v;
      nonzero |= v != 0.0f;
    }
    __syncwarp();
    scan_bins(cum, B, nc, Cp, lane);
    __syncwarp();
  };

  for (int f0 = 0; f0 < W; f0 += 32) {
    unsigned todo = __ballot_sync(0xffffffffu, f0 + lane < W && mask[(long long)t * W + f0 + lane]);
    while (todo) {
      const int f = f0 + __ffs(todo) - 1;
      todo &= todo - 1;
      const float* hf = h + (long long)f * BC;
      // pass one: n (node), n_l and n_r (each threshold), class by class
      float n = 0.0f, nl[kMaxThrPerLane] = {}, nr[kMaxThrPerLane] = {};
      bool nonzero = false;
      for (int c0 = 0; c0 < C; c0 += Ct) {
        const int nc = min(Ct, C - c0);
        load_tile(hf, c0, nc, nonzero);
        const float* tot = cum + (B - 1) * Cp;
        for (int c = 0; c < nc; ++c) {
          const bool first = c0 + c == 0;
          const float tv = tot[c];
          n = first ? tv : n + tv;
#pragma unroll
          for (int j = 0; j < kMaxThrPerLane; ++j) {
            const int thr = lane + 32 * j;
            if (thr < nthr) {
              const float l = cum[thr * Cp + c];
              nl[j] = first ? l : nl[j] + l;
              nr[j] = first ? tv - l : nr[j] + (tv - l);
            }
          }
        }
      }
      if (!__any_sync(0xffffffffu, nonzero)) continue;  // empty: every split has an empty side
      // pass two: the entropies' x log x terms over the same classes in the same order
      const float n_tot = fmaxf(n, kTiny);
      float hn = 0.0f, hl[kMaxThrPerLane] = {}, hr[kMaxThrPerLane] = {};
      for (int c0 = 0; c0 < C; c0 += Ct) {
        const int nc = min(Ct, C - c0);
        load_tile(hf, c0, nc, nonzero);
        const float* tot = cum + (B - 1) * Cp;
        for (int c = 0; c < nc; ++c) {
          const bool first = c0 + c == 0;
          const float tv = tot[c];
          const float xn = xlogx(tv / n_tot);
          hn = first ? xn : hn + xn;
#pragma unroll
          for (int j = 0; j < kMaxThrPerLane; ++j) {
            const int thr = lane + 32 * j;
            if (thr < nthr) {
              const float l = cum[thr * Cp + c];
              const float xl = xlogx(l / fmaxf(nl[j], kTiny));
              const float xr = xlogx((tv - l) / fmaxf(nr[j], kTiny));
              hl[j] = first ? xl : hl[j] + xl;
              hr[j] = first ? xr : hr[j] + xr;
            }
          }
        }
      }
      const float h_node = -hn;
#pragma unroll
      for (int j = 0; j < kMaxThrPerLane; ++j) {
        const int thr = lane + 32 * j;
        if (thr >= nthr) continue;
        // Eq. 3 with the one fused multiply-add the reference's compiler forms
        const float h_cond = fmaf(nr[j] / n_tot, -hr[j], (nl[j] / n_tot) * -hl[j]);
        const float gn = h_node - h_cond;
        const float p_l = nl[j] / n_tot;
        const float p_r = nr[j] / n_tot;
        const float split_info = -(xlogx(p_l) + xlogx(p_r));
        float g = gn / fmaxf(split_info, kSplitInfoFloor);
        if (!(nl[j] > 0.0f && nr[j] > 0.0f)) g = -INFINITY;
        const int idx = f * nthr + thr;
        if (better(g, idx, best_g, best_i)) { best_g = g; best_i = idx; }
      }
    }
  }
  fold_winner(best_g, best_i, h, f_base, gain, feat, thr_out, left_out, right_out, ts, B, C, 0,
              lane);
}

}  // namespace

// Warps (slots) per block for a [B, Ct] buffer: up to kMaxWarps buffers of B * (Ct | 1) floats.
static int split_scan_warps(int B, int Ct) {
  const size_t per_warp = (size_t)B * (Ct | 1) * sizeof(float);
  const size_t fit = kMaxSmem / per_warp;
  return fit < (size_t)kMaxWarps ? (int)fit : kMaxWarps;
}

// class_tile: C (one buffer holds a feature's [B, C] histogram) or the
// classes a tile of split_scan_wide_kernel holds (classification only).
extern "C" int prf_split_scan(const void* hist, const void* mask, int f_base,
                              void* gain, void* feat, void* thr, void* left,
                              void* right, int tc, int S, int W, int B, int C,
                              int regression, int class_tile, void* stream) {
  if (class_tile < 1 || class_tile > C || (regression && class_tile != C))
    return (int)cudaErrorInvalidValue;
  if (tc > 0 && S > 0 && W > 0) {
    const bool wide = class_tile < C;
    const int nw = split_scan_warps(B, class_tile);
    if (nw < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)nw * B * (class_tile | 1) * sizeof(float);
    const void* kernel = wide ? (const void*)split_scan_wide_kernel : (const void*)split_scan_kernel;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int TS = tc * S;
    if (wide) {
      split_scan_wide_kernel<<<(TS + nw - 1) / nw, nw * 32, smem, (cudaStream_t)stream>>>(
          (const float*)hist, (const uint8_t*)mask, f_base, (float*)gain,
          (int*)feat, (int*)thr, (float*)left, (float*)right, TS, S, W, B, C, class_tile);
    } else {
      split_scan_kernel<<<(TS + nw - 1) / nw, nw * 32, smem, (cudaStream_t)stream>>>(
          (const float*)hist, (const uint8_t*)mask, f_base, (float*)gain,
          (int*)feat, (int*)thr, (float*)left, (float*)right, TS, S, W, B, C,
          regression);
    }
  }
  return (int)cudaGetLastError();
}
