// Blocked causal / sliding-window attention with an online softmax, GQA.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// attention_pallas_call (body _attn_kernel). For query i of a [Lq] tile
// and keys j of [Lk], ends aligned (query i sits at position i + Lk - Lq):
// s = (q_i . k_j) * scale, masked (causal: j <= pos_i; window W > 0:
// j > pos_i - W) to -1e30; running max m, sum l and accumulator acc in
// f32 across key tiles; out = acc / max(l, 1e-38) in q's dtype.
//
// Layout is the model's: q/out [B, Lq, H, D], k/v [B, Lk, KV, D], so the
// caller transposes nothing. Query head h reads KV head h / (H / KV): the
// reference's jnp.repeat of the KV heads, never materialised.
//
// What bounds it on an H100: at prefill shapes (L = 2048, D = 64) the
// work is 4 * L^2 * D / 2 flops per (batch, head) against 2 * L * D
// bytes of K/V per head: far above the card's ~295 flops/byte, so
// operations bound it. This first version does its products in f32 on the
// CUDA cores (no wgmma): it cannot reach the bf16 tensor-core bound, and
// its time is recorded beside that bound (PERF.md). Design: one block of
// 256 threads per (batch * head, 64-query tile); 64-key K/V tiles staged
// in shared memory as f32; each thread owns a 4 x 4 block of the 64 x 64
// score tile and a 4 x (D/16) block of the output. Masked entries weigh
// exactly 0 (the TPU kernel's -1e30 entries are wiped the same way once a
// real logit raises the running max), and key tiles that are masked for
// every query of the tile are skipped: past the causal diagonal and before
// the window. Every query has at least one visible key (Lq <= Lk, checked
// by the wrapper), so skipping changes nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;      // queries per block
constexpr int kBK = 64;      // keys per tile
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D +
                          (size_t)kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Lq, int Lk, int H, int KV, int D, int causal,
             int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [kBQ][D]
  float* ks = qs + kBQ * D;                  // [kBK][D + 1] (padded: column reads)
  float* vs = ks + kBK * (D + 1);            // [kBK][D]
  float* ss = vs + kBK * D;                  // [kBQ][kBK + 1] scores, then weights
  float* row_m = ss + kBQ * (kBK + 1);       // running max per query
  float* row_l = row_m + kBQ;                // running sum
  float* row_a = row_l + kBQ;                // this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const long long q_step = (long long)H * D;    // elements between positions
  const long long kv_step = (long long)KV * D;
  const T* qb = q + (long long)b * Lq * q_step + (long long)h * D;
  const T* kb = k + (long long)b * Lk * kv_step + (long long)kvh * D;
  const T* vb = v + (long long)b * Lk * kv_step + (long long)kvh * D;
  T* ob = out + (long long)b * Lq * q_step + (long long)h * D;
  const int off = Lk - Lq;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[e] = q0 + r < Lq ? to_f(qb[(long long)(q0 + r) * q_step + d]) : 0.0f;
  }
  if (tid < kBQ) {
    row_m[tid] = kMasked;
    row_l[tid] = 0.0f;
  }

  // Keys visible to some query of this tile.
  const int q_last = (q0 + kBQ < Lq ? q0 + kBQ : Lq) - 1;
  int k_end = Lk, k_beg = 0;
  if (causal) k_end = min(Lk, q_last + off + 1);
  if (window > 0) k_beg = max(0, q0 + off - window + 1);
  k_beg = (k_beg / kBK) * kBK;

  const int ty = tid / 16, tx = tid % 16;    // rows ty*4 .. ty*4+3
  constexpr int kDC = DMAX / 16;             // output columns per thread: tx + 16 c
  float acc[4][kDC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[r][c] = 0.0f;

  for (int k0 = k_beg; k0 < k_end; k0 += kBK) {
    __syncthreads();                         // the last tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const bool in = k0 + r < Lk;
      const long long g = (long long)(k0 + r) * kv_step + d;
      ks[r * (D + 1) + d] = in ? to_f(kb[g]) : 0.0f;
      vs[e] = in ? to_f(vb[g]) : 0.0f;
    }
    __syncthreads();

    // scores of this thread's 4 x 4 block
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(ty * 4 + r) * D + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] += qv[r] * kv[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty * 4 + r;
      const int qpos = q0 + i + off;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const int kpos = k0 + j;
        bool ok = kpos < Lk && q0 + i < Lq;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        ss[i * (kBK + 1) + j] = ok ? s[r][c] * scale : kMasked;
      }
    }
    __syncthreads();

    // online softmax: 4 neighbouring lanes per query row
    {
      const int i = tid / 4, part = tid % 4;
      float* srow = ss + i * (kBK + 1);
      float mx = kMasked;
      for (int j = part; j < kBK; j += 4) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = part; j < kBK; j += 4) {
        const float sv = srow[j];
        const float p = sv == kMasked ? 0.0f : expf(sv - m_new);
        srow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        row_a[i] = alpha;
        row_l[i] = alpha * row_l[i] + sum;
        row_m[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = row_a[ty * 4 + r];
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[r][c] *= a;
    }
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = ss[(ty * 4 + r) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < D ? vs[j * D + d] : 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] += p[r] * vv;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    if (q0 + i >= Lq) continue;
    const float l = fmaxf(row_l[i], 1e-38f);
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) ob[(long long)(q0 + i) * q_step + d] = from_f<T>(acc[r][c] / l);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Lq, int Lk,
           int H, int KV, int D, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBQ - 1) / kBQ, B * H);
  flash_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Lq, Lk, H, KV, D, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Lq, int Lk,
             int H, int KV, int D, int causal, int window, float scale, cudaStream_t s) {
  if (D <= 64) return launch<T, 64>(q, k, v, out, B, Lq, Lk, H, KV, D, causal, window, scale, s);
  if (D <= 128) return launch<T, 128>(q, k, v, out, B, Lq, Lk, H, KV, D, causal, window, scale, s);
  return launch<T, 256>(q, k, v, out, B, Lq, Lk, H, KV, D, causal, window, scale, s);
}

}  // namespace

// q/out [B, Lq, H, D], k/v [B, Lk, KV, D]; bf16 != 0: all four are bf16, else f32.
extern "C" int lm_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                                  int Lq, int Lk, int H, int KV, int D, int causal, int window,
                                  float scale, int bf16, void* stream) {
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return dispatch<__nv_bfloat16>(q, k, v, out, B, Lq, Lk, H, KV, D, causal, window, scale, s);
  return dispatch<float>(q, k, v, out, B, Lq, Lk, H, KV, D, causal, window, scale, s);
}
