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
// Each (sample, feature) pair of a live sample costs one atomicAdd into
// the [tc, S, W, B, C] output in global memory (L2 atomics); near the root
// every sample of a tree sits in slot 0, so the atomics of one feature
// contend on only B*C addresses. The bytes it must move (the uint8 bins,
// the [tc, N] weights and slots, the output) take far less time at
// 3.35 TB/s.
//
// Design: one thread per (sample, feature) element, feature fastest, so a
// warp reads consecutive bytes of a row of x (coalesced) and its atomics
// go to W different features instead of one address. Parked samples and
// zero weights are skipped before any atomic. The full frontier's
// S*B*C*4 = 256 KiB per feature does not fit in shared memory, so this
// first version uses global atomics; privatising a slot or feature tile
// in shared memory is later work. Arbitrary N and W need no padding; x may
// be a column slice of a wider matrix (row stride ld). The DSI weights are
// integers, so every entry is an exact float below 2^24 and any atomic
// order gives bitwise the plain PyTorch version's histogram; non-integer
// channels (regression) agree to rounding only.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void hist_kernel(const uint8_t* __restrict__ x, long long ld,
                            const float* __restrict__ base,
                            const float* __restrict__ w,
                            const int* __restrict__ slot,
                            float* __restrict__ out,
                            int N, int W, int S, int B, int C, int packed) {
  const int t = blockIdx.y;
  const long long total = (long long)N * W;
  const float* wt = w + (long long)t * N;
  const int* st = slot + (long long)t * N;
  float* ot = out + (long long)t * S * W * B * C;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(e / W);
    const int f = (int)(e - (long long)i * W);
    const int s = st[i];
    const float wi = wt[i];
    if (s < 0 || s >= S || wi == 0.0f) continue;
    const int b = x[(long long)i * ld + f];
    if (b >= B) continue;
    float* cell = ot + (((long long)s * W + f) * B + b) * C;
    const float* bi = base + (long long)i * C;
    if (packed) {
      // class = first argmax of the channel row, scale = its maximum
      int cls = 0;
      float m = bi[0];
      for (int c = 1; c < C; ++c) {
        if (bi[c] > m) { m = bi[c]; cls = c; }
      }
      const float v = wi * m;
      if (v != 0.0f) atomicAdd(cell + cls, v);
    } else {
      for (int c = 0; c < C; ++c) {
        const float v = wi * bi[c];
        if (v != 0.0f) atomicAdd(cell + c, v);
      }
    }
  }
}

}  // namespace

extern "C" int prf_hist(const void* x, long long ld, const void* base,
                        const void* w, const void* slot, void* out, int N, int W,
                        int tc, int S, int B, int C, int packed, void* stream) {
  if (N > 0 && W > 0 && tc > 0) {
    const int threads = 256;
    long long blocks = ((long long)N * W + threads - 1) / threads;
    if (blocks > 2048) blocks = 2048;
    dim3 grid((unsigned)blocks, (unsigned)tc);
    hist_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, ld, (const float*)base, (const float*)w,
        (const int*)slot, (float*)out, N, W, S, B, C, packed);
  }
  return (int)cudaGetLastError();
}
