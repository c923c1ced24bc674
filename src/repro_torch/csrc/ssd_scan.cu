// Mamba-2 SSD chunked scan (state-space duality), from h = 0.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py: ssd_pallas_call
// (body _ssd_kernel). Per (batch, head), for chunks of Q steps in order,
// with lc the chunk-local cumulative sum of log a:
//   S_ij  = (c_i . b_j) * exp(lc_i - lc_j)   for j <= i, else 0
//   y_i   = sum_j S_ij x_j + (c_i * exp(lc_i)) . h_prev
//   h     = exp(lc_Q) * h_prev + sum_j (b_j * exp(lc_Q - lc_j)) x_j^T
// exp is taken only where j <= i: for j > i the exponent is positive and
// would overflow (the reference clamps it under the mask).
//
// Layout is the model's: x/y [B, L, H, P], log a [B, L, H] f32, b/c
// [B, L, N] shared over the heads (the reference's kernel wants them
// repeated per head), h_final [B, H, N, P] f32.
//
// What bounds it on an H100: per chunk 2 Q^2 N + 2 Q^2 P + 4 Q N P flops
// against (Q (P + 2N/H)) elements read, so operations, not bytes, at
// Q = 128, N = 128, P = 64. This first version does its products in f32 on
// the CUDA cores (no wgmma), so it cannot reach the bf16 tensor-core bound;
// its time is recorded beside that bound (PERF.md). Design: one block of
// 256 threads per (batch, head) walks the chunks in order, the [N, P]
// state in shared memory the whole time (it never goes to device memory
// between chunks). Within a chunk, b and c are staged 32 state columns at
// a time: each slice adds to the [Q, Q] score tile (8 x 8 per thread, in
// registers) and to the carried-state term of y (8 x 4 per thread), then
// updates its 32 rows of the state in place. The masked, decayed scores go
// to shared memory for y = S x. Shared memory: x chunk, score tile,
// b/c slices and the state, ~163 KiB at N = 128: over the 48 KiB default,
// so the launcher opts in to more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 128;      // largest chunk
constexpr int kNS = 32;      // state columns staged per slice
constexpr int kPM = 64;      // largest head dim P
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int N) {
  return sizeof(float) * ((size_t)kQ * kPM + (size_t)kQ * (kQ + 1) + 2 * (size_t)kQ * (kNS + 1) +
                          (size_t)N * kPM + 3 * kQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ loga, const T* __restrict__ bm,
           const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ h_out, int L, int H,
           int P, int N, int Q) {
  extern __shared__ float smem[];
  float* xs = smem;                          // [kQ][kPM] x chunk
  float* ss = xs + kQ * kPM;                 // [kQ][kQ + 1] masked, decayed scores
  float* cs = ss + kQ * (kQ + 1);            // [kQ][kNS + 1] c slice
  float* bs = cs + kQ * (kNS + 1);           // [kQ][kNS + 1] b slice
  float* hs = bs + kQ * (kNS + 1);           // [N][kPM] state
  float* lc = hs + N * kPM;                  // [kQ] chunk-local cumsum of log a
  float* ec = lc + kQ;                       // [kQ] exp(lc_i)
  float* we = ec + kQ;                       // [kQ] exp(lc_Q - lc_j)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long x_step = (long long)H * P;
  const T* xb = x + (long long)b * L * x_step + (long long)h * P;
  T* yb = y + (long long)b * L * x_step + (long long)h * P;
  const float* lb = loga + (long long)b * L * H + h;
  const T* bb = bm + (long long)b * L * N;
  const T* cb = cm + (long long)b * L * N;

  for (int e = tid; e < N * kPM; e += kThreads) hs[e] = 0.0f;

  const int ti = tid / 16, tj = tid % 16;    // rows ti*8 .. ti*8+7; columns tj + 16 c

  for (int c0 = 0; c0 < L; c0 += Q) {
    __syncthreads();                         // the last chunk's readers are done
    for (int e = tid; e < kQ * kPM; e += kThreads) {
      const int r = e / kPM, p = e - r * kPM;
      xs[e] = (r < Q && p < P) ? to_f(xb[(long long)(c0 + r) * x_step + p]) : 0.0f;
    }
    if (tid < 32) {                          // warp scan: lane owns steps 4 lane .. 4 lane + 3
      float run = 0.0f, part[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = tid * 4 + t;
        run += j < Q ? lb[(long long)(c0 + j) * H] : 0.0f;
        part[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += n;
      }
      const float excl = incl - run;
#pragma unroll
      for (int t = 0; t < 4; ++t) lc[tid * 4 + t] = excl + part[t];
    }
    __syncthreads();
    const float lc_end = lc[Q - 1];
    const float chunk_decay = expf(lc_end);
    for (int j = tid; j < kQ; j += kThreads) {
      ec[j] = j < Q ? expf(lc[j]) : 0.0f;
      we[j] = j < Q ? expf(lc_end - lc[j]) : 0.0f;
    }

    float sacc[8][8], yst[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) sacc[r][c] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) yst[r][c] = 0.0f;
    }

    for (int n0 = 0; n0 < N; n0 += kNS) {
      __syncthreads();                       // the last slice's readers are done
      for (int e = tid; e < kQ * kNS; e += kThreads) {
        const int r = e / kNS, nl = e - r * kNS;
        const bool in = r < Q && n0 + nl < N;
        const long long g = (long long)(c0 + r) * N + n0 + nl;
        cs[r * (kNS + 1) + nl] = in ? to_f(cb[g]) : 0.0f;
        bs[r * (kNS + 1) + nl] = in ? to_f(bb[g]) : 0.0f;
      }
      __syncthreads();
      for (int nl = 0; nl < kNS; ++nl) {
        float cv[8], bv[8], hv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = cs[(ti * 8 + r) * (kNS + 1) + nl];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = bs[(tj + 16 * c) * (kNS + 1) + nl];
        const bool n_in = n0 + nl < N;
#pragma unroll
        for (int c = 0; c < 4; ++c) hv[c] = n_in ? hs[(n0 + nl) * kPM + tj + 16 * c] : 0.0f;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) sacc[r][c] += cv[r] * bv[c];
          const float ce = cv[r] * ec[ti * 8 + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) yst[r][c] += ce * hv[c];
        }
      }
      __syncthreads();                       // every read of this slice's state rows is done
      {                                      // state rows n0 .. n0 + kNS: 8 threads per row
        const int nl = tid / 8, p0 = tid % 8;
        const int n = n0 + nl;
        if (n < N) {
#pragma unroll
          for (int c = 0; c < kPM / 8; ++c) {
            const int p = p0 + 8 * c;
            float a = 0.0f;
            for (int j = 0; j < Q; ++j) a += (bs[j * (kNS + 1) + nl] * we[j]) * xs[j * kPM + p];
            hs[n * kPM + p] = chunk_decay * hs[n * kPM + p] + a;
          }
        }
      }
    }

    // masked decay on the scores; exp only where j <= i
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ti * 8 + r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = tj + 16 * c;
        ss[i * (kQ + 1) + j] = (j <= i && i < Q) ? sacc[r][c] * expf(lc[i] - lc[j]) : 0.0f;
      }
    }
    __syncthreads();

    // y = S x + the carried-state term
    float ya[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) ya[r][c] = 0.0f;
    for (int j = 0; j < Q; ++j) {
      float xv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = xs[j * kPM + tj + 16 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float sv = ss[(ti * 8 + r) * (kQ + 1) + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) ya[r][c] += sv * xv[c];
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ti * 8 + r;
      if (i >= Q) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tj + 16 * c;
        if (p < P) yb[(long long)(c0 + i) * x_step + p] = from_f<T>(ya[r][c] + yst[r][c]);
      }
    }
  }
  __syncthreads();
  float* hb = h_out + (long long)bh * N * P;
  for (int e = tid; e < N * P; e += kThreads) {
    const int n = e / P, p = e - n * P;
    hb[e] = hs[n * kPM + p];
  }
}

template <typename T>
int launch(const void* x, const void* loga, const void* b, const void* c, void* y, void* h,
           int B, int L, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T><<<B * H, kThreads, smem, stream>>>((const T*)x, (const float*)loga, (const T*)b,
                                                   (const T*)c, (T*)y, (float*)h, L, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// x/y [B, L, H, P], loga [B, L, H] f32, b/c [B, L, N], h [B, H, N, P] f32;
// chunk Q divides L; bf16 != 0: x, b, c, y are bf16, else f32.
extern "C" int lm_ssd_scan(const void* x, const void* loga, const void* b, const void* c, void* y,
                           void* h, int B, int L, int H, int P, int N, int Q, int bf16,
                           void* stream) {
  if (Q < 1 || Q > kQ || L % Q != 0 || P < 1 || P > kPM || N < 1 || N > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return launch<__nv_bfloat16>(x, loga, b, c, y, h, B, L, H, P, N, Q, s);
  return launch<float>(x, loga, b, c, y, h, B, L, H, P, N, Q, s);
}
