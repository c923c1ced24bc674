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
// * bf16 at every head dim up to 256, padded to DP = 32, 64, 128, 192 or
//   256 (D a multiple of 8, the wrapper pads others with zero columns): the
//   tensor cores, wgmma + TMA, built like the forward's flash_tc_kernel; two
//   launches. bwd_delta_tc_kernel writes, per 64-query tile of a head, the
//   tile's 64 lse values (in log2 units) then its 64 deltas D_i (zeros past
//   Lq), so a tile's row terms come in by one 512-byte bulk copy.
//   bwd_dkdv_dq_tc_kernel runs two kinds of block, one warpgroup each up
//   to DP 128 (two at 192 / 256, below):
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
//   At DP 192 / 256 (gemma3's 168 and 240) one warpgroup would hold 64 keys
//   of dK and dV in f32, 2 x 64 x DP / 128 = 192 / 256 registers a thread
//   before S^T, dP^T and the A fragments (32 each); the card allows 255. So
//   a block there has two warpgroups (256 threads), split by product: in
//   the dK / dV block (dkdv_block_wg2) warpgroup 0 computes S^T and P^T and
//   owns dV, warpgroup 1 computes dP^T, then dS^T from P^T, and owns dK; in
//   the dQ block (dq_block_wg2) warpgroup 0 computes S and P, warpgroup 1 dP
//   and dS, and each owns half of dQ's 64-column chunks (2 + 2 at 256, 2 + 1
//   at 192, where warpgroup 1 repeats its chunk's product and drops it, so
//   that no wgmma lies on a path only one warpgroup takes: ptxas serializes
//   every wgmma of a kernel that has one). A thread's accumulator fragment has the same places in both
//   warpgroups, so P (f32) and dS (its bf16 parts) pass through a 16 KB
//   exchange in shared memory, each thread's 32 words to the thread of the
//   same rank, between block barriers: two a tile in the dK / dV block,
//   three in the dQ block. Registers a thread: DP / 2 (dV or dK) + 64, or
//   32 x 2 (dQ) + 64, under 255. Shared memory: the six tiles, row terms and
//   the exchange, 165,952 bytes at 192 and 215,104 at 256 of the 232,448 a
//   block may have: one block an SM.
//   Splitting dK's and dV's columns instead, each warpgroup recomputing S^T
//   and dP^T over the full D, would need no exchange but take 8 units of
//   64 x 64 x DP products a tile for the 6 here, and the dQ block 6 for 4,
//   and compute the exponentials twice. The arithmetic is the one-warpgroup
//   blocks': the same products in the same order, P passed in f32, so the
//   roundings are the same.
// * f32: f32 FMAs on the CUDA cores (bwd_delta_kernel, bwd_dkdv_kernel,
//   bwd_dq_kernel), tiles staged in shared memory, S and dP recomputed in
//   both passes (14 D flops a pair), for exact f32 products, as the
//   forward's f32 route does. This form took 4.9 ms at smollm's training
//   shape in bf16 on an H100, 1% of the bound (PERF.md).
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

// The forward's mask: (causal and window) or key < prefix, keys past Lk never.
__device__ __forceinline__ bool visible(int kpos, int qpos, int Lk, int causal, int window,
                                        int prefix) {
  return kpos < Lk && (kpos < prefix || ((!causal || kpos <= qpos) &&
                                         (window <= 0 || kpos > qpos - window)));
}

// Rows [r0, r0 + n) of one head of a [L][heads][D] tensor (base at row 0 of
// the head, `step` elements between rows) into shared memory [n][ld]; rows past
// L are zeros.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ base, long long step,
                                          int r0, int n, int L, int D, int ld) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    dst[r * ld + d] = r0 + r < L ? base[(long long)(r0 + r) * step + d] : 0.0f;
  }
}

// delta[b, h, i] = dout[b, i, h, :] . out[b, i, h, :], one warp a row.
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const float* __restrict__ out, const float* __restrict__ dout, float* __restrict__ delta,
                 int B, int Lq, int H, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * Lq * H) return;          // whole warps leave together
  const float* o = out + row * D;
  const float* g = dout + row * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s += o[d] * g[d];
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
template <int DMAX, int BK>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int Lq,
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
        dk[at + col] = adk[r][c] * scale;
        dv[at + col] = adv[r][c];
      }
    }
  }
}

// dQ of 64 queries of one head. Thread (ty, tx) owns queries 4 ty .. 4 ty + 3:
// their scores against keys tx + 16 c, and their dQ columns tx + 16 c.
template <int DMAX, int BK>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq, int Lq, int Lk, int H, int KV,
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
      if (col < D) dq[at + col] = acc[r][c] * scale;
    }
  }
}

template <int DMAX>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* lse,
               const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int Lq, int Lk,
               int H, int KV, int D, int causal, int window, int prefix, int off, float scale,
               cudaStream_t stream) {
  constexpr int BK = DMAX > 128 ? 32 : 64;
  const int ld = D | 1;
  const long long rows = (long long)B * Lq * H;
  bwd_delta_kernel<<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
                        stream>>>((const float*)out, (const float*)dout, (float*)delta, B, Lq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_kv =
      sizeof(float) * (2 * (size_t)BK * ld + 2 * (size_t)kBQ * ld + 2 * (size_t)BK * (kBQ + 1) +
                       2 * kBQ);
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<DMAX, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_kernel<DMAX, BK><<<dim3((Lk + BK - 1) / BK, B * KV), kThreads, smem_kv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dk, (float*)dv, Lq, Lk, H, KV, D, causal, window, prefix, off, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q =
      sizeof(float) * (2 * (size_t)kBQ * ld + 2 * (size_t)BK * ld + (size_t)kBQ * (BK + 1) +
                       2 * kBQ);
  err = cudaFuncSetAttribute(bwd_dq_kernel<DMAX, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  bwd_dq_kernel<DMAX, BK><<<dim3((Lq + kBQ - 1) / kBQ, B * H), kThreads, smem_q, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dq, Lq, Lk, H, KV, D, causal, window, prefix, off, scale);
  return (int)cudaGetLastError();
}

int launch_bwd_f32(const void* q, const void* k, const void* v, const void* out, const void* lse,
                   const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int Lq,
                   int Lk, int H, int KV, int D, int causal, int window, int prefix, int off, float scale,
                   cudaStream_t s) {
#define FLASH_BWD(DMAX)                                                                             \
  launch_bwd<DMAX>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, Lq, Lk, H, KV, D, causal, \
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
constexpr int kWg = 128;               // threads of one warpgroup: 64 rows
constexpr float kLog2e = 1.4426950408889634f;

// DP: the padded head dim the kernels are built for (32, 64, 128, 192 or 256).
template <int DP>
struct BwdShape {
  static constexpr int SW = DP >= 64 ? 128 : 64;  // swizzle span: bytes of one row chunk
  static constexpr int CW = SW / 2;               // bf16 columns per chunk
  static constexpr int DC = DP / CW;              // chunks per row
  static constexpr int TILE = kBQ * SW;           // bytes of one 64-row chunk
  static constexpr int RT = 2 * kBQ * 4;          // bytes of one query tile's lse and delta
  static constexpr int NWG = DP > 128 ? 2 : 1;    // warpgroups a block (the note above)
  static constexpr int THREADS = NWG * kWg;
  // the six 64-row tiles (dK / dV: K, V, 2 x (Q, dO); dQ: Q, dO, 2 x (K, V)),
  // 2 x row terms (dK / dV), barriers; at NWG 2 then the exchange between the
  // warpgroups: 32 f32 a thread
  static constexpr size_t XCH = 6 * (size_t)DC * TILE + 2 * RT + 64;
  static constexpr size_t SMEM = 1024 + XCH + (NWG == 2 ? (size_t)kWg * 32 * 4 : 0);
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

// The dK / dV block's tiles (both forms), for the 64 keys from k0 of one KV
// head (b, kvh): K and V loaded once, then a two-stage ring of the Q, dO and
// row-term tiles of the query tiles that see some key of the tile (all when
// it holds a prefix key, else from the causal diagonal to the window's far
// edge), over the KV head's G query heads: n_it steps.
template <int DP>
struct DkdvTiles {
  using Sh = BwdShape<DP>;
  static constexpr int CW = Sh::CW, DC = Sh::DC, TILE = Sh::TILE;
  uint8_t* ks;                                       // [DC][64 keys][SW]
  uint8_t* vs;                                       // [DC][64 keys][SW]
  uint8_t* qs;                                       // [2 stages][DC][64 queries][SW]
  uint8_t* gs;                                       // [2 stages][DC][64 queries][SW] dO
  float* rts;                                        // [2 stages][lse, delta][64]
  uint64_t* bars;                                    // K/V, stage 0, 1
  const CUtensorMap* tq;
  const CUtensorMap* tdo;
  const float* rows;
  int b, kvh, H, G, nqt, q_beg, nq, n_it;

  __device__ __forceinline__ int q0(int it) const { return q_beg + (it % nq) * kBQ; }

  // Step it's Q, dO and row terms into `stage` (one thread issues it).
  __device__ __forceinline__ void load_q(int stage, int it) const {
    const int h = kvh * G + it / nq, q = q0(it);
    uint64_t* bar = &bars[1 + stage];
    mbar_expect_tx(bar, 2 * DC * TILE + Sh::RT);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      tma_load(qs + (stage * DC + c) * TILE, tq, bar, c * CW, h, q, b);
      tma_load(gs + (stage * DC + c) * TILE, tdo, bar, c * CW, h, q, b);
    }
    bulk_load(rts + stage * 2 * kBQ, rows + (((long long)b * H + h) * nqt + q / kBQ) * 2 * kBQ,
              Sh::RT, bar);
  }
};

// Lays out the dK / dV block's tiles, sets up their barriers and starts the
// K / V loads and step 0's (a block barrier: every thread calls it).
template <int DP>
__device__ __forceinline__ DkdvTiles<DP> dkdv_start(uint8_t* smem, const CUtensorMap* tq, const CUtensorMap* tk,
                                                    const CUtensorMap* tv, const CUtensorMap* tdo,
                                                    const float* rows, int Lq, int Lk, int H, int KV, int causal,
                                                    int window, int prefix, int off, int b, int kvh, int k0) {
  using Sh = BwdShape<DP>;
  constexpr int CW = Sh::CW, DC = Sh::DC, TILE = Sh::TILE;
  DkdvTiles<DP> t;
  t.ks = smem;
  t.vs = t.ks + DC * TILE;
  t.qs = t.vs + DC * TILE;
  t.gs = t.qs + 2 * DC * TILE;
  t.rts = reinterpret_cast<float*>(t.gs + 2 * DC * TILE);
  t.bars = reinterpret_cast<uint64_t*>(t.rts + 4 * kBQ);
  t.tq = tq;
  t.tdo = tdo;
  t.rows = rows;
  t.b = b;
  t.kvh = kvh;
  t.H = H;
  t.G = H / KV;
  t.nqt = (Lq + kBQ - 1) / kBQ;
  const int k_last = min(k0 + kBK, Lk) - 1;
  int q_beg = 0, q_end = Lq;
  if (k0 >= prefix) {
    if (causal) q_beg = max(0, k0 - off);
    if (window > 0) q_end = min(Lq, k_last + window - off);
  }
  t.q_beg = (q_beg / kBQ) * kBQ;
  t.nq = q_end > t.q_beg ? (q_end - t.q_beg + kBQ - 1) / kBQ : 0;
  t.n_it = t.G * t.nq;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&t.bars[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&t.bars[0], 2 * DC * TILE);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      tma_load(t.ks + c * TILE, tk, &t.bars[0], c * CW, kvh, k0, b);
      tma_load(t.vs + c * TILE, tv, &t.bars[0], c * CW, kvh, k0, b);
    }
    if (t.n_it > 0) t.load_q(0, 0);
  }
  return t;
}

// The dQ block's tiles (both forms), for the 64 queries from q0 of head h of
// batch b: Q and dO loaded once, then a two-stage ring of the forward's key
// tiles (the prefix's n_pre tiles, then [k_beg, k_end)): ntiles steps.
template <int DP>
struct DqTiles {
  using Sh = BwdShape<DP>;
  static constexpr int CW = Sh::CW, DC = Sh::DC, TILE = Sh::TILE;
  uint8_t* qs;                                       // [DC][64 queries][SW]
  uint8_t* gs;                                       // [DC][64 queries][SW] dO
  uint8_t* ks;                                       // [2 stages][DC][64 keys][SW]
  uint8_t* vs;                                       // [2 stages][DC][64 keys][SW]
  uint64_t* bars;                                    // Q / dO, stage 0, 1
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  int b, kvh, q_last, n_pre, k_beg, ntiles;

  __device__ __forceinline__ int k0(int it) const { return it < n_pre ? it * kBK : k_beg + (it - n_pre) * kBK; }

  // Step it's K and V into `stage` (one thread issues it).
  __device__ __forceinline__ void load_kv(int stage, int it) const {
    mbar_expect_tx(&bars[1 + stage], 2 * DC * TILE);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      tma_load(ks + (stage * DC + c) * TILE, tk, &bars[1 + stage], c * CW, kvh, k0(it), b);
      tma_load(vs + (stage * DC + c) * TILE, tv, &bars[1 + stage], c * CW, kvh, k0(it), b);
    }
  }
};

// Lays out the dQ block's tiles, sets up their barriers and starts the Q /
// dO loads and step 0's (a block barrier: every thread calls it).
template <int DP>
__device__ __forceinline__ DqTiles<DP> dq_start(uint8_t* smem, const CUtensorMap* tq, const CUtensorMap* tk,
                                                const CUtensorMap* tv, const CUtensorMap* tdo, int Lq, int Lk,
                                                int causal, int window, int prefix, int off, int b, int h,
                                                int kvh, int q0) {
  using Sh = BwdShape<DP>;
  constexpr int CW = Sh::CW, DC = Sh::DC, TILE = Sh::TILE;
  DqTiles<DP> t;
  t.qs = smem;
  t.gs = t.qs + DC * TILE;
  t.ks = t.gs + DC * TILE;
  t.vs = t.ks + 2 * DC * TILE;
  t.bars = reinterpret_cast<uint64_t*>(t.vs + 2 * DC * TILE);
  t.tk = tk;
  t.tv = tv;
  t.b = b;
  t.kvh = kvh;
  t.q_last = min(q0 + kBQ, Lq) - 1;
  t.n_pre = prefix > 0 ? (min(prefix, Lk) + kBK - 1) / kBK : 0;
  const int k_end = causal ? min(Lk, t.q_last + off + 1) : Lk;
  t.k_beg = max(window > 0 ? (max(0, q0 + off - window + 1) / kBK) * kBK : 0, t.n_pre * kBK);
  t.ntiles = t.n_pre + (k_end > t.k_beg ? (k_end - t.k_beg + kBK - 1) / kBK : 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&t.bars[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&t.bars[0], 2 * DC * TILE);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      tma_load(t.qs + c * TILE, tq, &t.bars[0], c * CW, h, q0, b);
      tma_load(t.gs + c * TILE, tdo, &t.bars[0], c * CW, h, q0, b);
    }
    if (t.ntiles > 0) t.load_kv(0, 0);
  }
  return t;
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
  const DkdvTiles<DP> t = dkdv_start<DP>(smem, tq, tk, tv, tdo, rows, Lq, Lk, H, KV, causal, window, prefix,
                                         off, b, kvh, k0);
  const uint8_t *ks = t.ks, *vs = t.vs, *qs = t.qs, *gs = t.gs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Accumulator fragment: register 4j + 2 half + e holds row (key) r0 +
  // 8 half, column 8j + cq + e of the tile.
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float adk[DC][NV / 2], adv[DC][NV / 2];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) adk[c][i] = adv[c][i] = 0.0f;

  mbar_wait(&t.bars[0], 0);
  for (int it = 0; it < t.n_it; ++it) {
    const int stage = it & 1;
    const int q0 = t.q0(it);
    // The other stage was released by the barrier that ended the last tile.
    if (tid == 0 && it + 1 < t.n_it) t.load_q(stage ^ 1, it + 1);
    mbar_wait(&t.bars[1 + stage], (it >> 1) & 1);

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
    const float* lse_t = t.rts + stage * 2 * kBQ;
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
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const DqTiles<DP> t = dq_start<DP>(smem, tq, tk, tv, tdo, Lq, Lk, causal, window, prefix, off, b, h, kvh, q0);
  const uint8_t *qs = t.qs, *gs = t.gs, *ks = t.ks, *vs = t.vs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

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

  mbar_wait(&t.bars[0], 0);
  for (int it = 0; it < t.ntiles; ++it) {
    const int stage = it & 1;
    const int k0 = t.k0(it);
    if (tid == 0 && it + 1 < t.ntiles) t.load_kv(stage ^ 1, it + 1);
    mbar_wait(&t.bars[1 + stage], (it >> 1) & 1);

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
                      (window > 0 && k0 < t.q_last + off - window + 1);
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

// dK, dV of the 64 keys from k0 of one KV head at DP 192 / 256, two
// warpgroups (the note above): warpgroup 0 computes S^T and P^T and owns dV,
// warpgroup 1 computes dP^T and dS^T and owns dK; P^T passes through shared
// memory, each thread's 32 values to the thread of the same rank in the other.
template <int DP>
__device__ __forceinline__ void dkdv_block_wg2(uint8_t* smem, const CUtensorMap* tq, const CUtensorMap* tk,
                                               const CUtensorMap* tv, const CUtensorMap* tdo,
                                               const float* __restrict__ rows, __nv_bfloat16* __restrict__ dk,
                                               __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int H, int KV,
                                               int D, int causal, int window, int prefix, int off, float scale,
                                               float scale_log2, int b, int kvh, int k0) {
  using Sh = BwdShape<DP>;
  constexpr int SW = Sh::SW, CW = Sh::CW, DC = Sh::DC, TILE = Sh::TILE, NV = CW;
  const DkdvTiles<DP> t = dkdv_start<DP>(smem, tq, tk, tv, tdo, rows, Lq, Lk, H, KV, causal, window, prefix,
                                         off, b, kvh, k0);
  float4* xch = reinterpret_cast<float4*>(smem + Sh::XCH);      // [8][128 threads] P^T
  const int wg = threadIdx.x / kWg, tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;

  // Accumulator fragment as dkdv_block's: register 4j + 2 half + e holds
  // row (key) r0 + 8 half, column 8j + cq + e of the tile.
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float acc[DC][NV / 2];                             // warpgroup 0: dV; 1: dK
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) acc[c][i] = 0.0f;
  const uint8_t* a1 = wg ? t.vs : t.ks;              // the first product's A: keys x D

  mbar_wait(&t.bars[0], 0);
  for (int it = 0; it < t.n_it; ++it) {
    const int stage = it & 1;
    const int q0 = t.q0(it);
    // The other stage was released by the barrier that ended the last tile.
    if (threadIdx.x == 0 && it + 1 < t.n_it) t.load_q(stage ^ 1, it + 1);
    mbar_wait(&t.bars[1 + stage], (it >> 1) & 1);
    // the first product's B (S^T: Q; dP^T: dO) and the second's (dV: dO; dK: Q), queries x D
    const uint8_t* b1 = (wg ? t.gs : t.qs) + stage * DC * TILE;
    const uint8_t* b2 = (wg ? t.qs : t.gs) + stage * DC * TILE;

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1) over D in steps of 16: keys x queries
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / (CW / 16), j = kk % (CW / 16);
      wgmma_ss(x, smem_desc<SW>(smem_u32(a1 + c * TILE) + j * 32),
               smem_desc<SW>(smem_u32(b1 + c * TILE) + j * 32), kk > 0);
    }
    wg_commit();
    wg_wait();
    reg_fence(x);

    // Warpgroup 0: P^T = exp(S^T scale - lse), masked as dkdv_block masks it,
    // into the exchange; warpgroup 1, after the barrier: dS^T = P^T (dP^T -
    // delta). Each as the A fragments of two bf16 parts.
    const float* lse_t = t.rts + stage * 2 * kBQ;
    const float* dl_t = lse_t + kBQ;
    uint32_t a_hi[kBQ / 16][4], a_lo[kBQ / 16][4];
    if (wg == 0) {
      const bool edge = k0 < prefix || k0 + kBK > Lk || q0 + kBQ > Lq ||
                        (causal && q0 + off < k0 + kBK - 1) ||
                        (window > 0 && k0 < q0 + kBQ + off - window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + cq);
        float p[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = q0 + 8 * j + cq + e;
            const bool ok = !edge || (qi < Lq && visible(k0 + r0 + 8 * hf, qi + off, Lk, causal,
                                                         window, prefix));
            p[2 * hf + e] = ok ? exp2f(fmaf(x[4 * j + 2 * hf + e], scale_log2, -(e ? l2.y : l2.x))) : 0.0f;
          }
          split_bf16(p[2 * hf], p[2 * hf + 1], a_hi[j / 2][2 * (j % 2) + hf], a_lo[j / 2][2 * (j % 2) + hf]);
        }
        xch[j * kWg + tid] = make_float4(p[0], p[1], p[2], p[3]);
      }
    }
    __syncthreads();                               // P^T is in the exchange
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(dl_t + 8 * j + cq);
        const float4 pv = xch[j * kWg + tid];
        const float p[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) ds[e] = p[2 * hf + e] * (x[4 * j + 2 * hf + e] - (e ? dl.y : dl.x));
          split_bf16(ds[0], ds[1], a_hi[j / 2][2 * (j % 2) + hf], a_lo[j / 2][2 * (j % 2) + hf]);
        }
      }
    }

    // dV += P^T dO (warpgroup 0), dK += dS^T Q (1) over the tile's queries in steps of 16
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const uint64_t db = smem_desc<SW>(smem_u32(b2 + c * TILE) + kk * 16 * SW);
        wgmma_rs(acc[c], a_hi[kk], db);
        wgmma_rs(acc[c], a_lo[kk], db);
      }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < DC; ++c) reg_fence(acc[c]);
    reg_keep(a_hi);
    reg_keep(a_lo);
    __syncthreads();                               // this stage's tiles and the exchange are free
  }

  __nv_bfloat16* grad = wg ? dk : dv;
  const float mul = wg ? scale : 1.0f;
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
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(grad + at + col) =
              __floats2bfloat162_rn(acc[c][r] * mul, acc[c][r + 1] * mul);
      }
  }
}

// dQ of the 64 queries from q0 of one head (bh = b * H + h) at DP 192 / 256,
// two warpgroups (the note above): warpgroup 0 computes S and P, warpgroup 1
// dP and dS; P goes to warpgroup 1 and dS's bf16 parts come back through
// shared memory, and dQ's column chunks are split between them: [0, HC) and
// [HC, DC); at DP 192 warpgroup 1's second product repeats chunk 2 and is
// dropped (the note above).
template <int DP>
__device__ __forceinline__ void dq_block_wg2(uint8_t* smem, const CUtensorMap* tq, const CUtensorMap* tk,
                                             const CUtensorMap* tv, const CUtensorMap* tdo,
                                             const float* __restrict__ rows, __nv_bfloat16* __restrict__ dq,
                                             int Lq, int Lk, int H, int KV, int D, int causal, int window,
                                             int prefix, int off, float scale, float scale_log2, int bh, int q0,
                                             int nqt) {
  using Sh = BwdShape<DP>;
  constexpr int SW = Sh::SW, CW = Sh::CW, DC = Sh::DC, TILE = Sh::TILE, NV = CW;
  constexpr int HC = (DC + 1) / 2;                   // dQ's column chunks of warpgroup 0
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const DqTiles<DP> t = dq_start<DP>(smem, tq, tk, tv, tdo, Lq, Lk, causal, window, prefix, off, b, h, kvh, q0);
  float4* xch = reinterpret_cast<float4*>(smem + Sh::XCH);      // [8][128 threads] P, then dS
  uint4* xch_u = reinterpret_cast<uint4*>(xch);
  const int wg = threadIdx.x / kWg, tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int c0 = wg * HC;                            // this warpgroup's first chunk of dQ

  // Accumulator fragment as dq_block's. This thread's rows' terms:
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int pos0 = q0 + r0 + off;
  const float* rt = rows + ((long long)bh * nqt + q0 / kBQ) * 2 * kBQ;
  const float l2[2] = {rt[r0], rt[r0 + 8]};
  const float dl[2] = {rt[kBQ + r0], rt[kBQ + r0 + 8]};
  float acc[HC][NV / 2];
#pragma unroll
  for (int c = 0; c < HC; ++c)
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) acc[c][i] = 0.0f;
  const uint8_t* a1 = wg ? t.gs : t.qs;              // the first product's A: queries x D

  mbar_wait(&t.bars[0], 0);
  for (int it = 0; it < t.ntiles; ++it) {
    const int stage = it & 1;
    const int k0 = t.k0(it);
    if (threadIdx.x == 0 && it + 1 < t.ntiles) t.load_kv(stage ^ 1, it + 1);
    mbar_wait(&t.bars[1 + stage], (it >> 1) & 1);
    const uint8_t* b1 = (wg ? t.vs : t.ks) + stage * DC * TILE;    // K (S) or V (dP): keys x D
    const uint8_t* kt = t.ks + stage * DC * TILE;

    // S = Q K^T (warpgroup 0) or dP = dO V^T (1) over D in steps of 16
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / (CW / 16), j = kk % (CW / 16);
      wgmma_ss(x, smem_desc<SW>(smem_u32(a1 + c * TILE) + j * 32),
               smem_desc<SW>(smem_u32(b1 + c * TILE) + j * 32), kk > 0);
    }
    wg_commit();
    wg_wait();
    reg_fence(x);

    // Warpgroup 0: P = exp(S scale - lse), masked as dq_block masks it, into
    // the exchange; warpgroup 1: dS = P (dP - delta) as two bf16 parts, kept
    // and written back over P for warpgroup 0.
    uint32_t a_hi[kBK / 16][4], a_lo[kBK / 16][4];
    if (wg == 0) {
      const bool edge = k0 < prefix || k0 + kBK > Lk || (causal && k0 + kBK - 1 > q0 + off) ||
                        (window > 0 && k0 < t.q_last + off - window + 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok =
                !edge || visible(k0 + 8 * j + cq + e, pos0 + 8 * hf, Lk, causal, window, prefix);
            p[2 * hf + e] = ok ? exp2f(fmaf(x[4 * j + 2 * hf + e], scale_log2, -l2[hf])) : 0.0f;
          }
        xch[j * kWg + tid] = make_float4(p[0], p[1], p[2], p[3]);
      }
    }
    __syncthreads();                               // P is in the exchange
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pv = xch[j * kWg + tid];
        const float p[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          split_bf16(p[2 * hf] * (x[4 * j + 2 * hf] - dl[hf]), p[2 * hf + 1] * (x[4 * j + 2 * hf + 1] - dl[hf]),
                     a_hi[j / 2][2 * (j % 2) + hf], a_lo[j / 2][2 * (j % 2) + hf]);
        xch_u[j * kWg + tid] = make_uint4(a_hi[j / 2][2 * (j % 2)], a_hi[j / 2][2 * (j % 2) + 1],
                                          a_lo[j / 2][2 * (j % 2)], a_lo[j / 2][2 * (j % 2) + 1]);
      }
    }
    __syncthreads();                               // dS is in the exchange
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint4 d = xch_u[j * kWg + tid];
        a_hi[j / 2][2 * (j % 2)] = d.x;
        a_hi[j / 2][2 * (j % 2) + 1] = d.y;
        a_lo[j / 2][2 * (j % 2)] = d.z;
        a_lo[j / 2][2 * (j % 2) + 1] = d.w;
      }
    }

    // dQ += dS K over the tile's keys in steps of 16, this warpgroup's chunks
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const uint64_t dk = smem_desc<SW>(smem_u32(kt + min(c0 + c, DC - 1) * TILE) + kk * 16 * SW);
        wgmma_rs(acc[c], a_hi[kk], dk);
        wgmma_rs(acc[c], a_lo[kk], dk);
      }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < HC; ++c) reg_fence(acc[c]);
    reg_keep(a_hi);
    reg_keep(a_lo);
    __syncthreads();                               // this stage's K / V and the exchange are free
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + r0 + 8 * hf;
    if (row >= Lq) continue;
    __nv_bfloat16* dqrow = dq + (((long long)b * Lq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < HC; ++c)
#pragma unroll
      for (int j = 0; j < NV / 8; ++j) {
        const int col = (c0 + c) * NV + 8 * j + cq;
        const int r = 4 * j + 2 * hf;
        if (c0 + c < DC && col < D)
          *reinterpret_cast<__nv_bfloat162*>(dqrow + col) =
              __floats2bfloat162_rn(acc[c][r] * scale, acc[c][r + 1] * scale);
      }
  }
}

// Both kinds of block in one launch (the note above): blocks [0, n_kv) own
// key tiles, every KV head's key tile 0 first; the rest own query tiles,
// every head's last query tile first.
template <int DP>
__global__ void __launch_bounds__(BwdShape<DP>::THREADS, 1)
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
    if constexpr (BwdShape<DP>::NWG == 2)
      dkdv_block_wg2<DP>(smem, &tq, &tk, &tv, &tdo, rows, dk, dv, Lq, Lk, H, KV, D, causal, window, prefix,
                         off, scale, scale_log2, bkv / KV, bkv % KV, (i / (B * KV)) * kBK);
    else
      dkdv_block<DP>(smem, &tq, &tk, &tv, &tdo, rows, dk, dv, Lq, Lk, H, KV, D, causal, window, prefix, off,
                     scale, scale_log2, bkv / KV, bkv % KV, (i / (B * KV)) * kBK);
  } else {
    const int j = i - n_kv;
    if constexpr (BwdShape<DP>::NWG == 2)
      dq_block_wg2<DP>(smem, &tq, &tk, &tv, &tdo, rows, dq, Lq, Lk, H, KV, D, causal, window, prefix, off,
                       scale, scale_log2, j % (B * H), (nqt - 1 - j / (B * H)) * kBQ, nqt);
    else
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
  bwd_dkdv_dq_tc_kernel<DP><<<(unsigned)n_blocks, Sh::THREADS, Sh::SMEM, stream>>>(
      tq, tk, tv, tdo, (const float*)rows, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, B, Lq, Lk, H, KV, D, causal, window, prefix, off, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out/dout/dq [B, Lq, H, D], k/v/dk/dv [B, Lk, KV, D], lse [B, H, Lq] f32
// from the forward. bf16 != 0: the seven tensors are bf16 and run the
// tensor-core kernels (D a multiple of 8, 16-byte aligned bases; delta:
// B * H * ceil(Lq / 64) * 128 f32 of scratch for the row terms), else f32
// and the CUDA-core kernels (delta [B, H, Lq] f32 scratch). D <= 256; Lq,
// Lk >= 1; the mask and the query offset `off` as the forward's (a masked
// call needs 0 <= off <= Lk - Lq).
extern "C" int lm_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                      const void* lse, const void* dout, void* delta, void* dq,
                                      void* dk, void* dv, int B, int Lq, int Lk, int H, int KV,
                                      int D, int causal, int window, int prefix, int off, float scale,
                                      int bf16, void* stream) {
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0 || prefix < 0 || Lq < 1 || Lk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (D % 8 != 0) return (int)cudaErrorInvalidValue;
#define FLASH_BWD_TC(DP)                                                                        \
  launch_bwd_tc<DP>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, Lq, Lk, H, KV, D, causal, \
                    window, prefix, off, scale, s)
    if (D <= 32) return FLASH_BWD_TC(32);
    if (D <= 64) return FLASH_BWD_TC(64);
    if (D <= 128) return FLASH_BWD_TC(128);
    if (D <= 192) return FLASH_BWD_TC(192);
    return FLASH_BWD_TC(256);
#undef FLASH_BWD_TC
  }
  return launch_bwd_f32(q, k, v, out, lse, dout, delta, dq, dk, dv, B, Lq, Lk, H, KV, D, causal,
                        window, prefix, off, scale, s);
}
