// The backward of blocked attention (FlashAttention-2's formulas), GQA,
// causal / sliding-window / prefix masks or none, at the forward's query offset.
//
// Replaces no TPU kernel: the reference differentiates its einsum attention
// with XLA (repro/models/layers.py:attention_train) and has no backward
// Pallas kernel. The port's training forward runs the hand-written forward
// kernel (flash_attention.cu, which also writes each row's log-sum-exp), so
// its gradient needs a kernel of its own. For query i and key j, with
// s = (q_i . k_j) * scale, masked as the forward masks it:
//
//   P = exp(s - lse_i)          dV_j = sum_i P_ij dO_i
//   dP_ij = dO_i . v_j          D_i  = dO_i . O_i
//   dS = P (dP - D)             dQ_i = scale sum_j dS_ij k_j
//                               dK_j = scale sum_i dS_ij q_i
//
// Query head h reads KV head h / (H / KV); dK and dV of a KV head sum over
// its H / KV query heads, with no repeat materialised. No atomics on any
// route: dK / dV and dQ each come from blocks that own their rows, so two
// calls on the same inputs give the same bits.
//
// What bounds it on an H100: the work is 10 D flops per visible (query,
// key) pair, far above the card's ~295 bf16 flops per byte, so the tensor
// cores' operations bound it. Two routes:
//
// * bf16 at padded head dims 32, 64 and 128 (the training path; D a
//   multiple of 8, the wrapper pads others with zero columns): the tensor
//   cores, wgmma + TMA, built like the forward's flash_tc_kernel; two
//   launches. bwd_delta_tc_kernel writes, per 64-query tile of a head, the
//   tile's 64 lse values (in log2 units) then its 64 deltas D_i (zeros past
//   Lq), so a tile's row terms come in by one 512-byte bulk copy.
//   bwd_dkdv_dq_tc_kernel runs two kinds of block, one warpgroup each:
//   - dK / dV (dkdv_block): 64 keys of one KV head. TMA loads its K and V
//     tiles once, and a two-stage ring brings in the Q, dO and row-term
//     tiles of the query tiles that see some key of the tile, over its G
//     query heads. S^T = K Q^T and dP^T = V dO^T come from wgmma with both
//     operands K-major, so their accumulators are keys x queries: the
//     register-A layout of dV += P^T dO and dK += dS^T Q, which read dO and
//     Q MN-major through the transpose bit, as the forward reads V. lse and
//     delta are per column there, read from shared memory.
//   - dQ (dq_block): 64 queries of one head, over the forward's key tiles
//     with its two-stage K / V ring; S = Q K^T and dP = dO V^T from shared
//     memory, dQ += dS K with K MN-major. It recomputes S and dP (4 D of the
//     20 D tensor-core flops a pair) rather than adding into an f32 buffer
//     with atomics, which would change bits from run to run, or storing dS
//     (hi + lo: 302 MB a call at smollm's training shape), whose traffic
//     costs more than the recomputation.
//   Under a causal mask the key tiles nearest 0 and the last query tiles
//   see the most pairs, and their blocks start first: the dK / dV blocks
//   in key-tile order, then the dQ blocks from the last query tile. One
//   launch for both kinds lets dQ blocks take up the SMs that the dK / dV
//   blocks' imbalance leaves idle (on an H100 at smollm's training shape,
//   two launches took 0.314-0.320 ms a call, one 0.251-0.257 ms;
//   tools/attention_bwd_ab.py, PERF.md).
//   P and dS enter their products as two bf16 parts, hi = bf16(x) and
//   lo = bf16(x - hi), one wgmma each: the forward's remedy for one
//   rounding of P, which put its full-shape outputs outside the bf16
//   tolerance (dropping either lo part does here too:
//   tests/test_torch_attention_bwd.py). Only the tiles that cross a mask
//   edge, the end of the keys or the end of the queries are masked; a
//   query row past Lq reads zeros by TMA and would otherwise weigh
//   exp(-lse) != 0. dK, dV and dQ are rounded to bf16 once, at the end.
// * f32, and bf16 at padded head dims 192 and 256 (gemma3's 168 and 240):
//   the first form, f32 FMAs on the CUDA cores (bwd_delta_kernel,
//   bwd_dkdv_kernel, bwd_dq_kernel), tiles converted to f32 as they are
//   staged in shared memory, S and dP recomputed in both passes (14 D flops
//   a pair), one rounding to the input's dtype at the end. f32 keeps it for
//   exact f32 products, as the forward's f32 route does. At 192 / 256 the
//   tensor-core dK / dV block would hold 64 keys of dK and dV in f32, 256
//   registers a thread in one warpgroup: splitting them over two consumer
//   warpgroups is still to do, so those widths are dispatched here by
//   shape (never as a fallback after a failure). This form took 4.9 ms at
//   smollm's training shape on an H100, 1% of the bound (PERF.md).
//
// Layout is the model's: q/out/dout/dq [B, Lq, H, D], k/v/dk/dv
// [B, Lk, KV, D], lse [B, H, Lq] f32. The CUDA-core kernels take any D up
// to 256: tiles are staged with a row stride of D | 1 floats (odd: the
// column reads of a warp fall in distinct banks), and accumulators are
// sized for DMAX, the head dim rounded up to 64, 128 or 256. At DMAX 256
// the key tiles are 32 wide, which keeps dK and dV at 64 registers a
// thread and the dK/dV kernel's tiles under 227 KB of shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;      // queries per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The forward's mask: (causal and window) or key < prefix, keys past Lk never.
__device__ __forceinline__ bool visible(int kpos, int qpos, int Lk, int causal, int window,
                                        int prefix) {
  return kpos < Lk && (kpos < prefix || ((!causal || kpos <= qpos) &&
                                         (window <= 0 || kpos > qpos - window)));
}

// Rows [r0, r0 + n) of one head of a [L][heads][D] tensor (base at row 0 of
// the head, `step` elements between rows) into shared memory [n][ld] as f32;
// rows past L are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ base, long long step,
                                          int r0, int n, int L, int D, int ld) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    dst[r * ld + d] = r0 + r < L ? to_f32(base[(long long)(r0 + r) * step + d]) : 0.0f;
  }
}

// delta[b, h, i] = dout[b, i, h, :] . out[b, i, h, :], one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
                 int B, int Lq, int H, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * Lq * H) return;          // whole warps leave together
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s += to_f32(o[d]) * to_f32(g[d]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bi = row / H;
    const int i = (int)(bi % Lq), b = (int)(bi / Lq);
    delta[((long long)b * H + h) * Lq + i] = s;
  }
}

// dK, dV of BK keys of one KV head. Thread (ty, tx) owns keys 4 ty .. 4 ty + 3:
// their scores against queries tx + TX c, and their dK / dV columns tx + TX c.
template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Lq,
                int Lk, int H, int KV, int D, int causal, int window, int prefix, int off, float scale) {
  constexpr int TY = BK / 4;           // groups of 4 keys
  constexpr int TX = kThreads / TY;    // 16 (BK 64) or 32 (BK 32)
  constexpr int SC = kBQ / TX;         // queries a thread scores
  constexpr int AC = DMAX / TX;        // dK / dV columns a thread owns
  extern __shared__ float smem[];
  const int ld = D | 1;
  float* ks = smem;                    // [BK][ld]
  float* vs = ks + BK * ld;            // [BK][ld]
  float* qs = vs + BK * ld;            // [kBQ][ld]
  float* gs = qs + kBQ * ld;           // [kBQ][ld] dout
  float* ps = gs + kBQ * ld;           // [BK][kBQ + 1] P
  float* dss = ps + BK * (kBQ + 1);    // [BK][kBQ + 1] dS
  float* ls = dss + BK * (kBQ + 1);    // [kBQ] lse
  float* dls = ls + kBQ;               // [kBQ] delta

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int G = H / KV;
  const long long q_step = (long long)H * D, kv_step = (long long)KV * D;
  const long long kv_base = (long long)b * Lk * kv_step + (long long)kvh * D;
  load_tile(ks, k + kv_base, kv_step, k0, BK, Lk, D, ld);
  load_tile(vs, v + kv_base, kv_step, k0, BK, Lk, D, ld);

  // Queries that see some key of this tile: all when it holds a prefix key,
  // else from the causal diagonal to the window's far edge.
  const int k_last = min(k0 + BK, Lk) - 1;
  int q_beg = 0, q_end = Lq;
  if (k0 >= prefix) {
    if (causal) q_beg = max(0, k0 - off);
    if (window > 0) q_end = min(Lq, k_last + window - off);
  }
  q_beg = (q_beg / kBQ) * kBQ;

  float adk[4][AC], adv[4][AC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < AC; ++c) adk[r][c] = adv[r][c] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long q_base = (long long)b * Lq * q_step + (long long)h * D;
    const float* lrow = lse + ((long long)b * H + h) * Lq;
    const float* drow = delta + ((long long)b * H + h) * Lq;
    for (int q0 = q_beg; q0 < q_end; q0 += kBQ) {
      __syncthreads();                 // the last tile's readers are done
      load_tile(qs, q + q_base, q_step, q0, kBQ, Lq, D, ld);
      load_tile(gs, dout + q_base, q_step, q0, kBQ, Lq, D, ld);
      if (tid < kBQ) {
        const bool in = q0 + tid < Lq;
        ls[tid] = in ? lrow[q0 + tid] : 0.0f;
        dls[tid] = in ? drow[q0 + tid] : 0.0f;
      }
      __syncthreads();

      float s[4][SC], dp[4][SC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < SC; ++c) s[r][c] = dp[r][c] = 0.0f;
      for (int d = 0; d < D; ++d) {
        float kr[4], vr[4], qc[SC], gc[SC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          kr[r] = ks[(ty * 4 + r) * ld + d];
          vr[r] = vs[(ty * 4 + r) * ld + d];
        }
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          qc[c] = qs[(tx + TX * c) * ld + d];
          gc[c] = gs[(tx + TX * c) * ld + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < SC; ++c) {
            s[r][c] += kr[r] * qc[c];
            dp[r][c] += vr[r] * gc[c];
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          const int j = ty * 4 + r, i = tx + TX * c;
          float p = 0.0f, ds = 0.0f;
          if (q0 + i < Lq && visible(k0 + j, q0 + i + off, Lk, causal, window, prefix)) {
            p = expf(s[r][c] * scale - ls[i]);
            ds = p * (dp[r][c] - dls[i]);
          }
          ps[j * (kBQ + 1) + i] = p;
          dss[j * (kBQ + 1) + i] = ds;
        }
      __syncthreads();

      // dV += P dO, dK += dS Q (the scale at the end)
      for (int i = 0; i < kBQ; ++i) {
        float pr[4], dr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pr[r] = ps[(ty * 4 + r) * (kBQ + 1) + i];
          dr[r] = dss[(ty * 4 + r) * (kBQ + 1) + i];
        }
#pragma unroll
        for (int c = 0; c < AC; ++c) {
          const int col = tx + TX * c;
          const float gv = col < D ? gs[i * ld + col] : 0.0f;
          const float qv = col < D ? qs[i * ld + col] : 0.0f;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            adv[r][c] += pr[r] * gv;
            adk[r][c] += dr[r] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty * 4 + r;
    if (j >= Lk) continue;
    const long long at = kv_base + (long long)j * kv_step;
#pragma unroll
    for (int c = 0; c < AC; ++c) {
      const int col = tx + TX * c;
      if (col < D) {
        dk[at + col] = from_f32<T>(adk[r][c] * scale);
        dv[at + col] = from_f32<T>(adv[r][c]);
      }
    }
  }
}

// dQ of 64 queries of one head. Thread (ty, tx) owns queries 4 ty .. 4 ty + 3:
// their scores against keys tx + 16 c, and their dQ columns tx + 16 c.
template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int Lq, int Lk, int H, int KV,
              int D, int causal, int window, int prefix, int off, float scale) {
  constexpr int TX = kThreads / (kBQ / 4);   // 16
  constexpr int SC = BK / TX;                // keys a thread scores
  constexpr int AC = DMAX / TX;              // dQ columns a thread owns
  extern __shared__ float smem[];
  const int ld = D | 1;
  float* qs = smem;                    // [kBQ][ld]
  float* gs = qs + kBQ * ld;           // [kBQ][ld] dout
  float* ks = gs + kBQ * ld;           // [BK][ld]
  float* vs = ks + BK * ld;            // [BK][ld]
  float* dss = vs + BK * ld;           // [kBQ][BK + 1] dS
  float* ls = dss + kBQ * (BK + 1);    // [kBQ] lse
  float* dls = ls + kBQ;               // [kBQ] delta

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KV);
  const long long q_step = (long long)H * D, kv_step = (long long)KV * D;
  const long long q_base = (long long)b * Lq * q_step + (long long)h * D;
  const long long kv_base = (long long)b * Lk * kv_step + (long long)kvh * D;
  load_tile(qs, q + q_base, q_step, q0, kBQ, Lq, D, ld);
  load_tile(gs, dout + q_base, q_step, q0, kBQ, Lq, D, ld);
  if (tid < kBQ) {
    const bool in = q0 + tid < Lq;
    const long long at = ((long long)b * H + h) * Lq + q0 + tid;
    ls[tid] = in ? lse[at] : 0.0f;
    dls[tid] = in ? delta[at] : 0.0f;
  }

  // The forward's key tiles: the prefix's n_pre tiles, then [k_beg, k_end).
  const int q_last = min(q0 + kBQ, Lq) - 1;
  const int n_pre = prefix > 0 ? (min(prefix, Lk) + BK - 1) / BK : 0;
  int k_end = Lk, k_beg = 0;
  if (causal) k_end = min(Lk, q_last + off + 1);
  if (window > 0) k_beg = max(0, q0 + off - window + 1);
  k_beg = max((k_beg / BK) * BK, n_pre * BK);
  const int ntiles = n_pre + (k_end > k_beg ? (k_end - k_beg + BK - 1) / BK : 0);

  float acc[4][AC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < AC; ++c) acc[r][c] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it < n_pre ? it * BK : k_beg + (it - n_pre) * BK;
    __syncthreads();                   // the last tile's readers are done
    load_tile(ks, k + kv_base, kv_step, k0, BK, Lk, D, ld);
    load_tile(vs, v + kv_base, kv_step, k0, BK, Lk, D, ld);
    __syncthreads();

    float s[4][SC], dp[4][SC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < SC; ++c) s[r][c] = dp[r][c] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qr[4], gr[4], kc[SC], vc[SC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qr[r] = qs[(ty * 4 + r) * ld + d];
        gr[r] = gs[(ty * 4 + r) * ld + d];
      }
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        kc[c] = ks[(tx + TX * c) * ld + d];
        vc[c] = vs[(tx + TX * c) * ld + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          s[r][c] += qr[r] * kc[c];
          dp[r][c] += gr[r] * vc[c];
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        const int i = ty * 4 + r, j = tx + TX * c;
        float ds = 0.0f;
        if (q0 + i < Lq && visible(k0 + j, q0 + i + off, Lk, causal, window, prefix))
          ds = expf(s[r][c] * scale - ls[i]) * (dp[r][c] - dls[i]);
        dss[i * (BK + 1) + j] = ds;
      }
    __syncthreads();

    // dQ += dS K (the scale at the end)
    for (int j = 0; j < BK; ++j) {
      float dr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dr[r] = dss[(ty * 4 + r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < AC; ++c) {
        const int col = tx + TX * c;
        const float kv = col < D ? ks[j * ld + col] : 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] += dr[r] * kv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= Lq) continue;
    const long long at = q_base + (long long)i * q_step;
#pragma unroll
    for (int c = 0; c < AC; ++c) {
      const int col = tx + TX * c;
      if (col < D) dq[at + col] = from_f32<T>(acc[r][c] * scale);
    }
  }
}

template <typename T, int DMAX>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* lse,
               const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int Lq, int Lk,
               int H, int KV, int D, int causal, int window, int prefix, int off, float scale,
               cudaStream_t stream) {
  constexpr int BK = DMAX > 128 ? 32 : 64;
  const int ld = D | 1;
  const long long rows = (long long)B * Lq * H;
  bwd_delta_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
                        stream>>>((const T*)out, (const T*)dout, (float*)delta, B, Lq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_kv =
      sizeof(float) * (2 * (size_t)BK * ld + 2 * (size_t)kBQ * ld + 2 * (size_t)BK * (kBQ + 1) +
                       2 * kBQ);
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, DMAX, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_kernel<T, DMAX, BK><<<dim3((Lk + BK - 1) / BK, B * KV), kThreads, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, Lq, Lk, H, KV, D, causal, window, prefix, off, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q =
      sizeof(float) * (2 * (size_t)kBQ * ld + 2 * (size_t)BK * ld + (size_t)kBQ * (BK + 1) +
                       2 * kBQ);
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, DMAX, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  bwd_dq_kernel<T, DMAX, BK><<<dim3((Lq + kBQ - 1) / kBQ, B * H), kThreads, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dq, Lq, Lk, H, KV, D, causal, window, prefix, off, scale);
  return (int)cudaGetLastError();
}

int launch_bwd_f32(const void* q, const void* k, const void* v, const void* out, const void* lse,
                   const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int Lq,
                   int Lk, int H, int KV, int D, int causal, int window, int prefix, int off, float scale,
                   cudaStream_t s) {
#define FLASH_BWD(DMAX)                                                                             \
  launch_bwd<float, DMAX>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, Lq, Lk, H, KV, D, causal, \
                          window, prefix, off, scale, s)
  if (D <= 64) return FLASH_BWD(64);
  if (D <= 128) return FLASH_BWD(128);
  return FLASH_BWD(256);
#undef FLASH_BWD
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma + TMA
// ---------------------------------------------------------------------------

using namespace hopper;

constexpr int kBK = 64;                // keys per tile
constexpr int kTcThreads = 128;        // one warpgroup: 64 rows
constexpr float kLog2e = 1.4426950408889634f;

// DP: the padded head dim the kernels are built for (32, 64 or 128).
template <int DP>
struct BwdShape {
  static constexpr int SW = DP >= 64 ? 128 : 64;  // swizzle span: bytes of one row chunk
  static constexpr int CW = SW / 2;               // bf16 columns per chunk
  static constexpr int DC = DP / CW;              // chunks per row
  static constexpr int TILE = kBQ * SW;           // bytes of one 64-row chunk
  static constexpr int RT = 2 * kBQ * 4;          // bytes of one query tile's lse and delta
  // align, six 64-row tiles (dK / dV: K, V, 2 x (Q, dO); dQ: Q, dO, 2 x (K, V)),
  // 2 x row terms (dK / dV), barriers
  static constexpr size_t SMEM = 1024 + 6 * (size_t)DC * TILE + 2 * RT + 64;
};

// Per 64-query tile of each head, [B * H][nqt][2][64]: the tile's lse
// values times log2(e), then its deltas dO_i . O_i; zeros past Lq. One
// warp a row, rows in [B][nqt * 64][H] order (reads follow the layout).
__global__ void __launch_bounds__(kThreads)
bwd_delta_tc_kernel(const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ rows, int B, int Lq, int H,
                    int D, int nqt) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int Lp = nqt * kBQ;
  if (row >= (long long)B * Lp * H) return;          // whole warps leave together
  const int h = (int)(row % H);
  const long long bi = row / H;
  const int i = (int)(bi % Lp), b = (int)(bi / Lp);
  float s = 0.0f;
  if (i < Lq) {
    const long long at = (((long long)b * Lq + i) * H + h) * D;
    for (int d = 2 * lane; d < D; d += 64) {         // D is even
      const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + at + d));
      const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + at + d));
      s += o.x * g.x + o.y * g.y;
    }
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    const long long bh = (long long)b * H + h;
    float* t = rows + (bh * nqt + i / kBQ) * 2 * kBQ + i % kBQ;
    t[0] = i < Lq ? lse[bh * Lq + i] * kLog2e : 0.0f;
    t[kBQ] = s;
  }
}

// dK, dV of the 64 keys from k0 of one KV head (b, kvh).
template <int DP>
__device__ __forceinline__ void dkdv_block(uint8_t* smem, const CUtensorMap* tq, const CUtensorMap* tk,
                                           const CUtensorMap* tv, const CUtensorMap* tdo,
                                           const float* __restrict__ rows, __nv_bfloat16* __restrict__ dk,
                                           __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int H, int KV,
                                           int D, int causal, int window, int prefix, int off, float scale,
                                           float scale_log2, int b, int kvh, int k0) {
  using Sh = BwdShape<DP>;
  constexpr int SW = Sh::SW, CW = Sh::CW, DC = Sh::DC, TILE = Sh::TILE, NV = CW;
  uint8_t* ks = smem;                                // [DC][64 keys][SW]
  uint8_t* vs = ks + DC * TILE;                      // [DC][64 keys][SW]
  uint8_t* qs = vs + DC * TILE;                      // [2 stages][DC][64 queries][SW]
  uint8_t* gs = qs + 2 * DC * TILE;                  // [2 stages][DC][64 queries][SW] dO
  float* rts = reinterpret_cast<float*>(gs + 2 * DC * TILE);   // [2 stages][lse, delta][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(rts + 4 * kBQ);  // K/V, stage 0, 1

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KV, nqt = (Lq + kBQ - 1) / kBQ;

  // Queries that see some key of this tile: all when it holds a prefix key,
  // else from the causal diagonal to the window's far edge; G heads each.
  const int k_last = min(k0 + kBK, Lk) - 1;
  int q_beg = 0, q_end = Lq;
  if (k0 >= prefix) {
    if (causal) q_beg = max(0, k0 - off);
    if (window > 0) q_end = min(Lq, k_last + window - off);
  }
  q_beg = (q_beg / kBQ) * kBQ;
  const int nq = q_end > q_beg ? (q_end - q_beg + kBQ - 1) / kBQ : 0;
  const int n_it = G * nq;

  auto load_q = [&](int stage, int it) {
    const int h = kvh * G + it / nq, q0 = q_beg + (it % nq) * kBQ;
    uint64_t* bar = &bars[1 + stage];
    mbar_expect_tx(bar, 2 * DC * TILE + Sh::RT);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      tma_load(qs + (stage * DC + c) * TILE, tq, bar, c * CW, h, q0, b);
      tma_load(gs + (stage * DC + c) * TILE, tdo, bar, c * CW, h, q0, b);
    }
    bulk_load(rts + stage * 2 * kBQ, rows + (((long long)b * H + h) * nqt + q0 / kBQ) * 2 * kBQ,
              Sh::RT, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * DC * TILE);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      tma_load(ks + c * TILE, tk, &bars[0], c * CW, kvh, k0, b);
      tma_load(vs + c * TILE, tv, &bars[0], c * CW, kvh, k0, b);
    }
    if (n_it > 0) load_q(0, 0);
  }

  // Accumulator fragment: register 4j + 2 half + e holds row (key) r0 +
  // 8 half, column 8j + cq + e of the tile.
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float adk[DC][NV / 2], adv[DC][NV / 2];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) adk[c][i] = adv[c][i] = 0.0f;

  mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    const int q0 = q_beg + (it % nq) * kBQ;
    // The other stage was released by the barrier that ended the last tile.
    if (tid == 0 && it + 1 < n_it) load_q(stage ^ 1, it + 1);
    mbar_wait(&bars[1 + stage], (it >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T over D in steps of 16: keys x queries
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / (CW / 16), j = kk % (CW / 16);
      wgmma_ss(s, smem_desc<SW>(smem_u32(ks + c * TILE) + j * 32),
               smem_desc<SW>(smem_u32(qs + (stage * DC + c) * TILE) + j * 32), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / (CW / 16), j = kk % (CW / 16);
      wgmma_ss(dp, smem_desc<SW>(smem_u32(vs + c * TILE) + j * 32),
               smem_desc<SW>(smem_u32(gs + (stage * DC + c) * TILE) + j * 32), kk > 0);
    }
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);

    // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta), lse and delta
    // per column (query); masked only on tiles that cross an edge, query
    // rows past Lq included. Both as the A fragments of two bf16 parts.
    const float* lse_t = rts + stage * 2 * kBQ;
    const float* dl_t = lse_t + kBQ;
    const bool edge = k0 < prefix || k0 + kBK > Lk || q0 + kBQ > Lq ||
                      (causal && q0 + off < k0 + kBK - 1) ||
                      (window > 0 && k0 < q0 + kBQ + off - window);
    uint32_t p_hi[kBQ / 16][4], p_lo[kBQ / 16][4], d_hi[kBQ / 16][4], d_lo[kBQ / 16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + cq);
      const float2 dl = *reinterpret_cast<const float2*>(dl_t + 8 * j + cq);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * j + 2 * hf + e;
          const int qi = q0 + 8 * j + cq + e;
          const bool ok = !edge || (qi < Lq && visible(k0 + r0 + 8 * hf, qi + off, Lk, causal,
                                                       window, prefix));
          p[e] = ok ? exp2f(fmaf(s[r], scale_log2, -(e ? l2.y : l2.x))) : 0.0f;
          ds[e] = p[e] * (dp[r] - (e ? dl.y : dl.x));
        }
        // k16 step j / 2: registers {row r0, k 0-7}, {r0 + 8, 0-7}, {r0, 8-15}, {r0 + 8, 8-15}
        split_bf16(p[0], p[1], p_hi[j / 2][2 * (j % 2) + hf], p_lo[j / 2][2 * (j % 2) + hf]);
        split_bf16(ds[0], ds[1], d_hi[j / 2][2 * (j % 2) + hf], d_lo[j / 2][2 * (j % 2) + hf]);
      }
    }

    // dV += P^T dO, dK += dS^T Q over the tile's queries in steps of 16
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const uint64_t dg = smem_desc<SW>(smem_u32(gs + (stage * DC + c) * TILE) + kk * 16 * SW);
        const uint64_t dq = smem_desc<SW>(smem_u32(qs + (stage * DC + c) * TILE) + kk * 16 * SW);
        wgmma_rs(adv[c], p_hi[kk], dg);
        wgmma_rs(adv[c], p_lo[kk], dg);
        wgmma_rs(adk[c], d_hi[kk], dq);
        wgmma_rs(adk[c], d_lo[kk], dq);
      }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      reg_fence(adv[c]);
      reg_fence(adk[c]);
    }
    reg_keep(p_hi);
    reg_keep(p_lo);
    reg_keep(d_hi);
    reg_keep(d_lo);
    __syncthreads();                               // this stage's Q / dO / row terms are free
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + r0 + 8 * hf;
    if (key >= Lk) continue;
    const long long at = (((long long)b * Lk + key) * KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < NV / 8; ++j) {
        const int col = c * NV + 8 * j + cq;       // D is even: col < D covers col + 1
        const int r = 4 * j + 2 * hf;
        if (col < D) {
          *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
              __floats2bfloat162_rn(adk[c][r] * scale, adk[c][r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
              __floats2bfloat162_rn(adv[c][r], adv[c][r + 1]);
        }
      }
  }
}

// dQ of the 64 queries from q0 of one head (bh = b * H + h).
template <int DP>
__device__ __forceinline__ void dq_block(uint8_t* smem, const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const CUtensorMap* tdo,
                                         const float* __restrict__ rows, __nv_bfloat16* __restrict__ dq,
                                         int Lq, int Lk, int H, int KV, int D, int causal, int window,
                                         int prefix, int off, float scale, float scale_log2, int bh, int q0,
                                         int nqt) {
  using Sh = BwdShape<DP>;
  constexpr int SW = Sh::SW, CW = Sh::CW, DC = Sh::DC, TILE = Sh::TILE, NV = CW;
  uint8_t* qs = smem;                                // [DC][64 queries][SW]
  uint8_t* gs = qs + DC * TILE;                      // [DC][64 queries][SW] dO
  uint8_t* ks = gs + DC * TILE;                      // [2 stages][DC][64 keys][SW]
  uint8_t* vs = ks + 2 * DC * TILE;                  // [2 stages][DC][64 keys][SW]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * DC * TILE);   // Q / dO, stage 0, 1

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);

  // The forward's key tiles: the prefix's n_pre tiles, then [k_beg, k_end).
  const int q_last = min(q0 + kBQ, Lq) - 1;
  const int n_pre = prefix > 0 ? (min(prefix, Lk) + kBK - 1) / kBK : 0;
  const int k_end = causal ? min(Lk, q_last + off + 1) : Lk;
  const int k_beg =
      max(window > 0 ? (max(0, q0 + off - window + 1) / kBK) * kBK : 0, n_pre * kBK);
  const int ntiles = n_pre + (k_end > k_beg ? (k_end - k_beg + kBK - 1) / kBK : 0);
  auto tile_k0 = [&](int it) { return it < n_pre ? it * kBK : k_beg + (it - n_pre) * kBK; };

  auto load_kv = [&](int stage, int k0) {
    mbar_expect_tx(&bars[1 + stage], 2 * DC * TILE);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      tma_load(ks + (stage * DC + c) * TILE, tk, &bars[1 + stage], c * CW, kvh, k0, b);
      tma_load(vs + (stage * DC + c) * TILE, tv, &bars[1 + stage], c * CW, kvh, k0, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * DC * TILE);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      tma_load(qs + c * TILE, tq, &bars[0], c * CW, h, q0, b);
      tma_load(gs + c * TILE, tdo, &bars[0], c * CW, h, q0, b);
    }
    if (ntiles > 0) load_kv(0, tile_k0(0));
  }

  // Accumulator fragment: register 4j + 2 half + e holds row (query) r0 +
  // 8 half, column 8j + cq + e of the tile. This thread's rows' terms:
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int pos0 = q0 + r0 + off;
  const float* rt = rows + ((long long)bh * nqt + q0 / kBQ) * 2 * kBQ;
  const float l2[2] = {rt[r0], rt[r0 + 8]};
  const float dl[2] = {rt[kBQ + r0], rt[kBQ + r0 + 8]};
  float acc[DC][NV / 2];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) acc[c][i] = 0.0f;

  mbar_wait(&bars[0], 0);
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1;
    const int k0 = tile_k0(it);
    if (tid == 0 && it + 1 < ntiles) load_kv(stage ^ 1, tile_k0(it + 1));
    mbar_wait(&bars[1 + stage], (it >> 1) & 1);

    // S = Q K^T and dP = dO V^T over D in steps of 16
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / (CW / 16), j = kk % (CW / 16);
      wgmma_ss(s, smem_desc<SW>(smem_u32(qs + c * TILE) + j * 32),
               smem_desc<SW>(smem_u32(ks + (stage * DC + c) * TILE) + j * 32), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / (CW / 16), j = kk % (CW / 16);
      wgmma_ss(dp, smem_desc<SW>(smem_u32(gs + c * TILE) + j * 32),
               smem_desc<SW>(smem_u32(vs + (stage * DC + c) * TILE) + j * 32), kk > 0);
    }
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);

    // dS = P (dP - delta), P = exp(S scale - lse), as two bf16 parts
    const bool edge = k0 < prefix || k0 + kBK > Lk || (causal && k0 + kBK - 1 > q0 + off) ||
                      (window > 0 && k0 < q_last + off - window + 1);
    uint32_t d_hi[kBK / 16][4], d_lo[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * j + 2 * hf + e;
          const bool ok =
              !edge || visible(k0 + 8 * j + cq + e, pos0 + 8 * hf, Lk, causal, window, prefix);
          const float p = ok ? exp2f(fmaf(s[r], scale_log2, -l2[hf])) : 0.0f;
          ds[e] = p * (dp[r] - dl[hf]);
        }
        split_bf16(ds[0], ds[1], d_hi[j / 2][2 * (j % 2) + hf], d_lo[j / 2][2 * (j % 2) + hf]);
      }

    // dQ += dS K over the tile's keys in steps of 16
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const uint64_t dk = smem_desc<SW>(smem_u32(ks + (stage * DC + c) * TILE) + kk * 16 * SW);
        wgmma_rs(acc[c], d_hi[kk], dk);
        wgmma_rs(acc[c], d_lo[kk], dk);
      }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < DC; ++c) reg_fence(acc[c]);
    reg_keep(d_hi);
    reg_keep(d_lo);
    __syncthreads();                               // this stage's K / V are free
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + r0 + 8 * hf;
    if (row >= Lq) continue;
    __nv_bfloat16* dqrow = dq + (((long long)b * Lq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < NV / 8; ++j) {
        const int col = c * NV + 8 * j + cq;
        const int r = 4 * j + 2 * hf;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dqrow + col) =
              __floats2bfloat162_rn(acc[c][r] * scale, acc[c][r + 1] * scale);
      }
  }
}

// Both kinds of block in one launch (the note above): blocks [0, n_kv) own
// key tiles, every KV head's key tile 0 first; the rest own query tiles,
// every head's last query tile first.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dkdv_dq_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ rows, __nv_bfloat16* __restrict__ dq,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int Lq,
                      int Lk, int H, int KV, int D, int causal, int window, int prefix, int off, float scale,
                      float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles must start on a 1024-byte boundary.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_kv = B * KV * ((Lk + kBK - 1) / kBK);
  const int nqt = (Lq + kBQ - 1) / kBQ;
  const int i = blockIdx.x;
  if (i < n_kv) {
    const int bkv = i % (B * KV);
    dkdv_block<DP>(smem, &tq, &tk, &tv, &tdo, rows, dk, dv, Lq, Lk, H, KV, D, causal, window, prefix, off,
                   scale, scale_log2, bkv / KV, bkv % KV, (i / (B * KV)) * kBK);
  } else {
    const int j = i - n_kv;
    dq_block<DP>(smem, &tq, &tk, &tv, &tdo, rows, dq, Lq, Lk, H, KV, D, causal, window, prefix, off, scale,
                 scale_log2, j % (B * H), (nqt - 1 - j / (B * H)) * kBQ, nqt);
  }
}

template <int DP>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* out, const void* lse,
                  const void* dout, void* rows, void* dq, void* dk, void* dv, int B, int Lq, int Lk,
                  int H, int KV, int D, int causal, int window, int prefix, int off, float scale,
                  cudaStream_t stream) {
  using Sh = BwdShape<DP>;
  const int nqt = (Lq + kBQ - 1) / kBQ, nkt = (Lk + kBK - 1) / kBK;
  const long long n_rows = (long long)B * nqt * kBQ * H;
  bwd_delta_tc_kernel<<<(unsigned)((n_rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
                        stream>>>((const __nv_bfloat16*)out, (const __nv_bfloat16*)dout,
                                  (const float*)lse, (float*)rows, B, Lq, H, D, nqt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // [B][L][heads][D] as 4-D maps, boxes of one head by 64 rows by one swizzle span
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map_bf16_4d(&tq, encode, q, D, H, Lq, B, kBQ, Sh::SW) ||
      !make_map_bf16_4d(&tdo, encode, dout, D, H, Lq, B, kBQ, Sh::SW) ||
      !make_map_bf16_4d(&tk, encode, k, D, KV, Lk, B, kBK, Sh::SW) ||
      !make_map_bf16_4d(&tv, encode, v, D, KV, Lk, B, kBK, Sh::SW))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;

  err = cudaFuncSetAttribute(bwd_dkdv_dq_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks = (long long)B * KV * nkt + (long long)B * H * nqt;
  bwd_dkdv_dq_tc_kernel<DP><<<(unsigned)n_blocks, kTcThreads, Sh::SMEM, stream>>>(
      tq, tk, tv, tdo, (const float*)rows, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, B, Lq, Lk, H, KV, D, causal, window, prefix, off, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out/dout/dq [B, Lq, H, D], k/v/dk/dv [B, Lk, KV, D], lse [B, H, Lq] f32
// from the forward. bf16 != 0: the seven tensors are bf16, else f32. bf16 at
// D <= 128 runs the tensor-core kernels (D a multiple of 8, 16-byte aligned
// bases; delta: B * H * ceil(Lq / 64) * 128 f32 of scratch for the row
// terms); f32, and bf16 at D > 128, the CUDA-core kernels (delta [B, H, Lq]
// f32 scratch). D <= 256; Lq, Lk >= 1; the mask and the query offset `off`
// as the forward's (a masked call needs 0 <= off <= Lk - Lq).
extern "C" int lm_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                      const void* lse, const void* dout, void* delta, void* dq,
                                      void* dk, void* dv, int B, int Lq, int Lk, int H, int KV,
                                      int D, int causal, int window, int prefix, int off, float scale,
                                      int bf16, void* stream) {
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0 || prefix < 0 || Lq < 1 || Lk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16 && D <= 128) {
    if (D % 8 != 0) return (int)cudaErrorInvalidValue;
#define FLASH_BWD_TC(DP)                                                                        \
  launch_bwd_tc<DP>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, Lq, Lk, H, KV, D, causal, \
                    window, prefix, off, scale, s)
    if (D <= 32) return FLASH_BWD_TC(32);
    if (D <= 64) return FLASH_BWD_TC(64);
    return FLASH_BWD_TC(128);
#undef FLASH_BWD_TC
  }
  if (bf16)   // D > 128: the CUDA-core kernels (note above)
    return launch_bwd<__nv_bfloat16, 256>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, Lq, Lk, H,
                                          KV, D, causal, window, prefix, off, scale, s);
  return launch_bwd_f32(q, k, v, out, lse, dout, delta, dq, dk, dv, B, Lq, Lk, H, KV, D, causal,
                        window, prefix, off, scale, s);
}
