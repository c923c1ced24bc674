// The backward of blocked attention (FlashAttention-2's formulas), GQA,
// causal / sliding-window / prefix masks or none, ends aligned.
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
// its H / KV query heads, with no repeat materialised.
//
// Three kernels, no atomics, so two calls on the same inputs give the same
// bits: bwd_delta_kernel (D_i, one warp a row), bwd_dkdv_kernel (one block
// a 64- or 32-key tile of one KV head; it loops over the query heads of
// that KV head and over the query tiles that see some key of the tile,
// recomputing S and dP; dK and dV stay in registers) and bwd_dq_kernel
// (one block a 64-query tile of one head; it loops over the key tiles the
// forward visits, recomputing S and dP; dQ stays in registers).
//
// What bounds it on an H100: the work is 10 D flops per visible (query,
// key) pair, far above the card's ~295 bf16 flops per byte, so the tensor
// cores' operations bound it. This first form does every product as f32
// FMAs on the CUDA cores from f32 or bf16 inputs (converted to f32 as the
// tiles are staged in shared memory, f32 accumulators, one rounding to the
// input's dtype at the end), and recomputes S and dP in both passes (14 D
// flops a pair): right first, and exact enough that bf16 gradients sit
// within one bf16 rounding of the f32 plain version. Its time against the
// tensor cores' bound is in PERF.md; wgmma and TMA are for a redesign.
//
// Layout is the model's: q/out/dout/dq [B, Lq, H, D], k/v/dk/dv
// [B, Lk, KV, D], lse/delta [B, H, Lq] f32. Any D up to 256: tiles are
// staged with a row stride of D | 1 floats (odd: the column reads of a
// warp fall in distinct banks), and accumulators are sized for DMAX, the
// head dim rounded up to 64, 128 or 256. At DMAX 256 the key tiles are 32
// wide, which keeps dK and dV at 64 registers a thread and the dK/dV
// kernel's tiles under 227 KB of shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

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
                int Lk, int H, int KV, int D, int causal, int window, int prefix, float scale) {
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
  const int off = Lk - Lq;
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
              int D, int causal, int window, int prefix, float scale) {
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
  const int off = Lk - Lq;
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
               int H, int KV, int D, int causal, int window, int prefix, float scale,
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
      (const float*)delta, (T*)dk, (T*)dv, Lq, Lk, H, KV, D, causal, window, prefix, scale);
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
      (const float*)delta, (T*)dq, Lq, Lk, H, KV, D, causal, window, prefix, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_dt(const void* q, const void* k, const void* v, const void* out, const void* lse,
                  const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int Lq,
                  int Lk, int H, int KV, int D, int causal, int window, int prefix, float scale,
                  cudaStream_t s) {
#define FLASH_BWD(DMAX)                                                                         \
  launch_bwd<T, DMAX>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, Lq, Lk, H, KV, D, causal, \
                      window, prefix, scale, s)
  if (D <= 64) return FLASH_BWD(64);
  if (D <= 128) return FLASH_BWD(128);
  return FLASH_BWD(256);
#undef FLASH_BWD
}

}  // namespace

// q/out/dout/dq [B, Lq, H, D], k/v/dk/dv [B, Lk, KV, D], lse [B, H, Lq] f32
// from the forward, delta [B, H, Lq] f32 scratch. bf16 != 0: the seven
// tensors are bf16, else f32; f32 arithmetic either way. D <= 256; Lq,
// Lk >= 1; the mask as the forward's (a masked call needs Lq <= Lk).
extern "C" int lm_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                      const void* lse, const void* dout, void* delta, void* dq,
                                      void* dk, void* dv, int B, int Lq, int Lk, int H, int KV,
                                      int D, int causal, int window, int prefix, float scale,
                                      int bf16, void* stream) {
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0 || prefix < 0 || Lq < 1 || Lk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_bwd_dt<__nv_bfloat16>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, Lq, Lk, H,
                                        KV, D, causal, window, prefix, scale, s);
  return launch_bwd_dt<float>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, Lq, Lk, H, KV, D,
                              causal, window, prefix, scale, s);
}
