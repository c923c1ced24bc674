// T_GR weighted class histograms for a chunk of trees.
//
// Replaces the TPU kernel repro/kernels/gain_ratio/kernel.py:
// multi_tree_hist_pallas (bodies _hist_kernel_channels and
// _hist_kernel_packed), which builds histograms as one-hot matmuls on the
// MXU because a TPU has no fast scatter. Hopper does have one, so this
// kernel scatters directly:
//
//   hist[t, s, f, b, c] += w[t, i] * base[i, c]   for slot[t, i] = s >= 0, b = x[i, f]
//
// What bounds it on an H100: the scatter's atomics, not device memory.
// The bytes it must move (the uint8 bins, the [tc, N] weights and slots,
// the output) take ~0.2 ms at 3.35 TB/s at the main path's level-0 slab;
// near the root every sample of a tree sits in slot 0, so one global
// atomic per (sample, feature) contends on only B * C addresses per
// feature. That first design took 10.712 ms there (slab [32, 2^20, 32],
// S 256, B 64, C 4, on an NVIDIA H100 80GB HBM3 at 700 W; chip_smoke.py).
//
// Design: privatised in shared memory. The caller groups each tree's live
// samples (slot in [0, S), nonzero weight) by slot once per level
// (`order`, with segment starts `seg` [tc, S + 1]; see
// kernels/gain_ratio/ops.py:slot_order), and every feature slab shares
// that grouping. A block takes one tree, one chunk of the tree's ordered
// samples and a tile of up to 32 features; it keeps a [Wt, B, C] int
// histogram of the slot it is in, each feature row padded by one word
// against bank conflicts. Small-integer contributions (every DSI-weighted
// class count) add to it with shared int atomics, which are native; a
// shared float atomic is a compare-and-swap loop (ATOMS.CAST.SPIN), so
// any other value goes straight to the output with a global float atomic.
// A warp takes 32 samples at a time: lane j loads sample j's index,
// weight and class (coalesced), then the lanes, one feature each, take
// the 32 samples in turn through shuffles, so a warp reads one 32-byte
// sector of each sample's bin row and its shared atomics go to 32
// feature rows. At each slot boundary inside the chunk, and at its end,
// the block adds its nonzero cells to the output with one global atomic
// each (~660 K per tree at level 0 instead of ~21 M). Without `order`
// (one slot, as dimension reduction asks) the samples are taken in index
// order and parked ones are skipped.
//
// A class axis too wide for one feature's [B, C] histogram in shared
// memory is taken in tiles of Ct classes (`class_tile`, chosen by the
// wrapper: kernels/gain_ratio/ops.class_tile): each block keeps the
// [Wt, B, Ct] histogram of its tile and skips a one-channel sample whose
// class lies outside it, so every class count still adds in shared memory
// and flushes once per cell. Every shape whose histogram fits runs the
// kernel above (hist_kernel<kPacked, false>: the tiling compiled out, as
// its loop variables cost registers and occupancy).
//
// Arbitrary N and W need no padding; x may be a column slice of a wider
// matrix (row stride ld); bin ids >= B are ignored. The DSI weights are
// integers, so every entry is an exact float below 2^24 and any atomic
// order gives bitwise the plain PyTorch version's histogram; non-integer
// channels (regression) agree to rounding only.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 32;                      // features per block: one per lane
constexpr size_t kSmemTarget = 48 * 1024;         // per block, several blocks per SM
constexpr size_t kSmemMax = 227 * 1024;
constexpr long long kTargetBlocks = 4096;

// One contribution v at a cell: small integers (every DSI-weighted class
// count) go to the block's int histogram, natively atomic in shared
// memory; any other value goes straight to the output with a global float
// atomic (a float atomic in shared memory is a compare-and-swap loop).
__device__ __forceinline__ void add(int* cell, float* gcell, float v, float int_max) {
  if (v == rintf(v) && fabsf(v) <= int_max) atomicAdd(cell, (int)v);
  else atomicAdd(gcell, v);
}

// kTiled: the block holds classes [c0, c0 + nc) of C (z picks the tile);
// else every class (z is the feature tile alone).
template <bool kPacked, bool kTiled>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ x, long long ld, const float* __restrict__ base,
            const float* __restrict__ w, const int* __restrict__ slot,
            const int* __restrict__ order, const int* __restrict__ seg,
            float* __restrict__ out, int N, int W, int S, int B, int C, int chunk, int wt,
            int ct, int nct, int z0, float int_max) {
  extern __shared__ int sh[];                     // [wt][B * ct + 1]
  const int t = blockIdx.x;
  const int p0 = blockIdx.y * chunk;
  const float* wt_t = w + (long long)t * N;
  const int* ord = order ? order + (long long)t * N : nullptr;
  const int* sg = order ? seg + (long long)t * (S + 1) : nullptr;
  const int total = sg ? sg[S] : N;
  if (p0 >= total) return;
  const int p1 = min(p0 + chunk, total);
  const int z = z0 + blockIdx.z;                  // feature tile [* nct + class tile]
  const int f0 = (kTiled ? z / nct : z) * wt;
  const int c0 = kTiled ? (z % nct) * ct : 0;
  const int nc = kTiled ? min(ct, C - c0) : C;    // this tile's classes: [c0, c0 + nc)
  const int nf = min(wt, W - f0);
  const int BC = B * C;                           // a feature's cells in the output
  const int BCt = B * nc, row = BCt + 1;          // a feature's cells in shared memory

  for (int e = threadIdx.x; e < nf * row; e += kThreads) sh[e] = 0;
  int s = 0;                                      // the slot whose segment holds p0
  if (sg) {
    int lo = 0, hi = S;                           // sg[lo] <= p0 < sg[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (sg[mid] <= p0) lo = mid; else hi = mid;
    }
    s = lo;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* st = slot + (long long)t * N;
  const bool active = lane < nf;
  const int f = f0 + (active ? lane : 0);
  int* my_row = sh + lane * row;
  for (int a = p0;;) {
    const int a_end = sg ? min(p1, sg[s + 1]) : p1;
    float* og = out + (((long long)t * S + s) * W + f0) * BC;
    float* my_g = og + (long long)lane * BC;
    // 32 samples per warp step: lane j loads sample j's index, weight and
    // channel, then every lane, one feature each, takes them in turn.
    for (int pb = a + warp * 32; pb < a_end; pb += kWarps * 32) {
      const int p = pb + lane;
      int i = 0, cls = 0;         // cls: the one channel to add to; -1: every channel
      float v = 0.0f;             // w, times that channel's value when there is one
      if (p < a_end) {
        i = ord ? ord[p] : p;
        v = wt_t[i];
        if (!ord && st[i] != 0) v = 0.0f;         // index order (one slot): parked
        if (v != 0.0f) {
          const float* bi = base + (long long)i * C;
          float m = bi[0];
          if (kPacked) {
            // class = first argmax of the channel row, scale = its maximum
            for (int c = 1; c < C; ++c) {
              if (bi[c] > m) { m = bi[c]; cls = c; }
            }
          } else {
            // a row with one nonzero channel (a class count) adds at that channel alone
            int nz = -1;
            for (int c = 0; c < C; ++c) {
              if (bi[c] != 0.0f) { nz = nz == -1 ? c : -2; m = bi[c]; }
            }
            cls = nz;
            if (nz == -1) v = 0.0f;
          }
          if (cls >= 0) v *= m;
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < 32; j0 += 8) {
        int ij[8], cj[8], b[8];
        float vj[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          ij[u] = __shfl_sync(0xffffffffu, i, j0 + u);
          vj[u] = __shfl_sync(0xffffffffu, v, j0 + u);
          cj[u] = __shfl_sync(0xffffffffu, cls, j0 + u);
        }
        // the eight bin loads go out before any atomic
        // (a one-channel sample of a class outside this tile adds nothing)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          b[u] = vj[u] != 0.0f && active &&
                         (!kTiled || cj[u] < 0 || (unsigned)(cj[u] - c0) < (unsigned)nc)
                     ? x[(long long)ij[u] * ld + f] : B;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (b[u] >= B) continue;
          if (cj[u] >= 0) {
            add(my_row + b[u] * nc + cj[u] - c0, my_g + b[u] * C + cj[u], vj[u], int_max);
          } else {
            const float* bi = base + (long long)ij[u] * C;
            for (int c = c0; c < c0 + nc; ++c) {
              const float vc = vj[u] * bi[c];
              if (vc != 0.0f) add(my_row + b[u] * nc + c - c0, my_g + b[u] * C + c, vc, int_max);
            }
          }
        }
      }
    }
    __syncthreads();
    // flush this slot's cells: one global atomic per nonzero cell (per four
    // when four shared cells are four aligned output cells); shared cell r
    // of a feature is output cell r, or in a class tile bin r / nc, class c0 + r % nc
    if (!kTiled ? BC % 4 == 0 : nc % 4 == 0 && C % 4 == 0 && c0 % 4 == 0) {
      for (int e = threadIdx.x; e < nf * BCt / 4; e += kThreads) {
        const int fe = e / (BCt / 4), r = 4 * (e - fe * (BCt / 4));
        int* c = sh + fe * row + r;
        if (c[0] | c[1] | c[2] | c[3]) {
          const int o = kTiled ? (r / nc) * C + c0 + r % nc : r;
          atomicAdd(reinterpret_cast<float4*>(og + (long long)fe * BC + o),
                    make_float4((float)c[0], (float)c[1], (float)c[2], (float)c[3]));
          c[0] = c[1] = c[2] = c[3] = 0;
        }
      }
    } else {
      for (int e = threadIdx.x; e < nf * BCt; e += kThreads) {
        const int fe = e / BCt, r = e - fe * BCt;
        int& c = sh[fe * row + r];
        if (c != 0) {
          const int o = kTiled ? (r / nc) * C + c0 + r % nc : r;
          atomicAdd(og + (long long)fe * BC + o, (float)c);
          c = 0;
        }
      }
    }
    if (a_end >= p1) break;
    __syncthreads();
    a = a_end;                                    // = sg[s + 1]: the next nonempty slot
    for (++s; sg[s + 1] <= a; ++s) {}
  }
}

}  // namespace

// x [N, ld] uint8 (W columns used), base [N, C], w and slot [tc, N], out
// [tc, S, W, B, C] zeroed by the caller (or a carry to add into). order
// [tc, N] and seg [tc, S + 1] (int32) group the live samples by slot; both
// null: index order, S must be 1. ct: classes a block holds (C, or a tile
// of a class axis too wide for shared memory).
extern "C" int prf_hist(const void* x, long long ld, const void* base, const void* w,
                        const void* slot, const void* order, const void* seg, void* out, int N,
                        int W, int tc, int S, int B, int C, int packed, int ct, void* stream) {
  if (N <= 0 || W <= 0 || tc <= 0) return (int)cudaGetLastError();
  if ((order == nullptr) != (seg == nullptr) || (order == nullptr && S != 1) || ct < 1 || ct > C)
    return (int)cudaErrorInvalidValue;
  const int nct = (C + ct - 1) / ct;
  const size_t row_bytes = ((size_t)B * ct + 1) * sizeof(int);
  int wt = W < kMaxTile ? W : kMaxTile;
  if (wt * row_bytes > kSmemTarget) wt = (int)(kSmemTarget / row_bytes);
  if (wt < 1) wt = 1;
  const size_t smem = wt * row_bytes;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const bool tiled = nct > 1;
  auto kernel = packed ? (tiled ? hist_kernel<true, true> : hist_kernel<true, false>)
                       : (tiled ? hist_kernel<false, true> : hist_kernel<false, false>);
  if (smem > kSmemTarget) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long ntiles = (long long)((W + wt - 1) / wt) * nct;
  long long chunks = kTargetBlocks / ((long long)tc * ntiles);
  if (chunks < 1) chunks = 1;
  long long chunk = (N + chunks - 1) / chunks;
  if (chunk < 1024) chunk = 1024;
  if ((N + chunk - 1) / chunk > 65535) chunk = (N + 65534) / 65535;
  // a block adds at most `chunk` contributions to a cell: keep int sums below 2^31
  const float int_max = (float)(2147483647LL / chunk < 32767 ? 2147483647LL / chunk : 32767);
  // (feature tile, class tile) pairs past the grid's z extent take further launches
  for (long long z0 = 0; z0 < ntiles; z0 += 65535) {
    const long long nz = ntiles - z0 < 65535 ? ntiles - z0 : 65535;
    dim3 grid((unsigned)tc, (unsigned)((N + chunk - 1) / chunk), (unsigned)nz);
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)x, ld, (const float*)base, (const float*)w, (const int*)slot,
        (const int*)order, (const int*)seg, (float*)out, N, W, S, B, C, (int)chunk, wt, ct, nct,
        (int)z0, int_max);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
