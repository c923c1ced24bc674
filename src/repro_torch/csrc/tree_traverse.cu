// Fused tree traversal + weighted vote for a chunk of trees.
//
// Replaces the TPU kernel repro/kernels/tree_traverse/kernel.py:
// traverse_block (body _traverse_kernel). For every sample and every tree
// of the chunk: walk `depth` steps of node = left_child + (bin[feature] >
// threshold), stopping at a leaf (feature < 0), then add payload[t, leaf]
// (the tree weight already folded in) to the sample's [C] scores; the
// chunk's sum is added to the [N, C] carry.
//
// The TPU kernel does each node lookup as a one-hot select-reduce over the
// whole pool and reads the payload with a one-hot matmul, because a TPU
// has no fast gather. Hopper gathers directly, so this kernel loads
// feature/threshold/left_child[t, node] and x[i, f] (uint8) as plain loads.
//
// What bounds it on an H100: the dependent loads of the walk, not
// bandwidth. The bytes it must move are the [N, F] bins, the forest
// (tc * P * (3 + C) words, which stays in L2) and the [N, C] carry and
// output; the walk's depth * tc loads per sample are latency-bound chains.
//
// Design: one thread per sample, trees in order t = 0..tc-1, the chunk's
// votes summed in registers (classes in groups of kMaxC) and added to the
// carry once: out = carry + (payload_0 + payload_1 + ...), the order the
// plain PyTorch version uses. Pool padding is a leaf with zero payload.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 8;

__global__ void traverse_kernel(const uint8_t* __restrict__ x, int N, int F,
                                const int* __restrict__ feature,
                                const int* __restrict__ threshold,
                                const int* __restrict__ left_child,
                                const float* __restrict__ payload,
                                const float* __restrict__ carry,
                                float* __restrict__ out, int tc, int P, int C,
                                int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const uint8_t* xi = x + (long long)i * F;
  for (int c0 = 0; c0 < C; c0 += kMaxC) {
    const int nc = C - c0 < kMaxC ? C - c0 : kMaxC;
    float acc[kMaxC];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) acc[c] = 0.0f;
    for (int t = 0; t < tc; ++t) {
      const int* ft = feature + (long long)t * P;
      const int* tt = threshold + (long long)t * P;
      const int* lt = left_child + (long long)t * P;
      int node = 0;
      for (int d = 0; d < depth; ++d) {
        const int f = ft[node];
        if (f < 0) break;
        node = lt[node] + (xi[f] > tt[node] ? 1 : 0);
      }
      const float* pl = payload + ((long long)t * P + node) * C + c0;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < nc) acc[c] = acc[c] + pl[c];
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < nc) {
        const long long o = (long long)i * C + c0 + c;
        out[o] = carry[o] + acc[c];
      }
    }
  }
}

}  // namespace

extern "C" int prf_traverse(const void* x, int N, int F, const void* feature,
                            const void* threshold, const void* left_child,
                            const void* payload, const void* carry, void* out,
                            int tc, int P, int C, int depth, void* stream) {
  if (N > 0) {
    const int threads = 256;
    const int blocks = (N + threads - 1) / threads;
    traverse_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, N, F, (const int*)feature, (const int*)threshold,
        (const int*)left_child, (const float*)payload, (const float*)carry,
        (float*)out, tc, P, C, depth);
  }
  return (int)cudaGetLastError();
}
