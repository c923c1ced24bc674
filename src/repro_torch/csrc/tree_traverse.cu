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
// has no fast gather. Hopper gathers directly.
//
// What bounds it on an H100: the walk's dependent loads, not bandwidth.
// The bytes it must move are the [N, F] bins, the forest and the [N, C]
// carry and output (0.013 ms at N 2^18, F 128); the walk is tc * depth
// dependent steps per sample, each a node load and a bin load, at
// addresses that differ from lane to lane. So the design makes each step
// few instructions and keeps many walks in flight:
//
// * pack_nodes_kernel folds each node into one int2 {feature | (threshold
//   + 1) << 16, left_child} (the threshold clamped to [-1, 255], which
//   keeps `bin > threshold` for every uint8 bin), so a step makes one
//   8-byte load, not three. A leaf, and every pool row past P, becomes
//   a node that steps to itself (feature 0, threshold field 256, which
//   no bin reaches, left_child = its own id): the walk runs `depth`
//   steps with no branch, and the compiler interleaves the chains.
// * A block stages its tile of TN samples' bins in shared memory with
//   coalesced 16-, 4- or 1-byte loads, rows padded to an odd number of
//   words so that lanes reading one feature of different rows hit
//   different banks. The packed nodes (L2-resident: 16 KB a tree at P
//   2050) and the payload rows go through the read-only cache.
// * Each thread walks kJ = 8 trees of its sample at once: independent
//   chains, interleaved (a chain past the last tree walks the group's
//   first tree and is dropped). Neither shorter blocks for a small batch
//   nor splitting a sample's trees over several threads (leaf ids through
//   shared memory) moved the call time at N 256 (PERF.md §6), so
//   neither is done.
//
// Order of the sums: each thread sums its sample's classes over the
// trees in order t = 0..tc-1, then adds the carry once: out = carry +
// (payload_0 + payload_1 + ...), the order of the plain PyTorch version,
// so the two agree bitwise. Pool padding is a leaf with zero payload.
// The tile plan (TN) is made by the wrapper
// (kernels/tree_traverse/ops.py:traverse_plan).
//
// Wide data (F > 65536, feature ids past 16 bits): the plan picks the
// wide variant. Each node is an int4 {feature, threshold + 1,
// left_child, 0} (a leaf {0, 256, its own id, 0}), one 16-byte load a
// step, and the bins are not staged: a row of F > 65536 bytes leaves
// room for at most two rows in shared memory, so each thread reads its
// own row's bins through the read-only cache, 128 rows a block. The
// sums and their order are those of the narrow variant.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kJ = 8;         // trees walked at once by each thread
constexpr int kMaxC = 8;      // classes summed at once by each thread

// Packed node of tree t, node n (n < Pp; rows past P step to themselves).
// Narrow (int2): {feature | (threshold + 1) << 16, left_child}. Wide
// (int4): {feature, threshold + 1, left_child, 0}.
template <bool kWide>
__global__ void pack_nodes_kernel(const int* __restrict__ feature,
                                  const int* __restrict__ threshold,
                                  const int* __restrict__ left_child,
                                  void* __restrict__ packed, int tc, int P, int Pp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)tc * Pp) return;
  const int t = (int)(i / Pp), n = (int)(i % Pp);
  int f = 0, thr1 = 256, lc = n;                // a leaf steps to itself
  if (n < P) {
    const long long j = (long long)t * P + n;
    if (feature[j] >= 0) {
      int thr = threshold[j];
      thr = thr < -1 ? -1 : (thr > 255 ? 255 : thr);
      f = feature[j];
      thr1 = thr + 1;
      lc = left_child[j];
    }
  }
  if (kWide) {
    static_cast<int4*>(packed)[i] = make_int4(f, thr1, lc, 0);
  } else {
    static_cast<int2*>(packed)[i] = make_int2((int)((unsigned)f | ((unsigned)thr1 << 16)), lc);
  }
}

// One step of a walk: the next node id.
__device__ __forceinline__ int step(const int2* __restrict__ nd_p, const uint8_t* xrow) {
  const int2 nd = __ldg(nd_p);
  const unsigned w = (unsigned)nd.x;
  return nd.y + ((unsigned)xrow[w & 0xFFFFu] >= (w >> 16) ? 1 : 0);
}

__device__ __forceinline__ int step(const int4* __restrict__ nd_p, const uint8_t* xrow) {
  const int4 nd = __ldg(nd_p);
  return nd.z + ((unsigned)__ldg(xrow + (unsigned)nd.x) >= (unsigned)nd.y ? 1 : 0);
}

// Bins of rows [r0, r0 + rows) into xs (row stride Fs bytes).
__device__ __forceinline__ void load_tile(uint8_t* xs, const uint8_t* __restrict__ x,
                                          long long r0, int rows, int F, int Fs, int vec) {
  const uint8_t* src = x + r0 * F;
  const int n = rows * F;
  if (vec == 16) {
    for (int e = threadIdx.x * 16; e < n; e += blockDim.x * 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + e);
      unsigned* d = reinterpret_cast<unsigned*>(xs + (e / F) * Fs + e % F);
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
  } else if (vec == 4) {
    for (int e = threadIdx.x * 4; e < n; e += blockDim.x * 4) {
      *reinterpret_cast<unsigned*>(xs + (e / F) * Fs + e % F) =
          *reinterpret_cast<const unsigned*>(src + e);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) xs[(e / F) * Fs + e % F] = src[e];
  }
}

// Block: TN samples, one thread each. Narrow: shared memory holds the TN
// rows of bins, one barrier after them. Wide: no shared memory, each
// thread reads its own row.
template <bool kWide>
__global__ void __launch_bounds__(128) traverse_kernel(
    const uint8_t* __restrict__ x, int N, int F, int Fs, int vec,
    const void* __restrict__ nodes_v, int Pp, const float* __restrict__ payload, int P,
    const float* __restrict__ carry, float* __restrict__ out, int tc, int C, int depth,
    bool vec4) {
  using Node = typename std::conditional<kWide, int4, int2>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const Node* nodes = static_cast<const Node*>(nodes_v);

  const int TN = blockDim.x, s = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * TN;
  const int rows = (int)(N - r0 < TN ? N - r0 : TN);
  const uint8_t* xrow;
  if (kWide) {
    if (s >= rows) return;
    xrow = x + (r0 + s) * F;
  } else {
    load_tile(smem, x, r0, rows, F, Fs, vec);
    __syncthreads();
    if (s >= rows) return;
    xrow = smem + s * Fs;
  }

  for (int j0 = 0; j0 < C; j0 += kMaxC) {      // class passes (one if C <= kMaxC)
    float acc[kMaxC];
#pragma unroll
    for (int j = 0; j < kMaxC; ++j) acc[j] = 0.0f;
    for (int t0 = 0; t0 < tc; t0 += kJ) {
      // Walk the group's kJ trees, interleaved, depth steps with no
      // branch (leaves step to themselves). A chain past the last tree
      // walks the group's first one and is dropped.
      int node[kJ];
      const Node* tree[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        node[j] = 0;
        tree[j] = nodes + (long long)(t0 + (t0 + j < tc ? j : 0)) * Pp;
      }
      for (int d = 0; d < depth; ++d) {
#pragma unroll
        for (int j = 0; j < kJ; ++j) node[j] = step(tree[j] + node[j], xrow);
      }
      // The leaves' payloads, in tree order.
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (t0 + j < tc) {
          const float* pl = payload + ((long long)(t0 + j) * P + node[j]) * C + j0;
          if (vec4) {
#pragma unroll
            for (int c = 0; c < kMaxC; c += 4) {
              if (c < C) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(pl + c));
                acc[c] = acc[c] + v.x;
                acc[c + 1] = acc[c + 1] + v.y;
                acc[c + 2] = acc[c + 2] + v.z;
                acc[c + 3] = acc[c + 3] + v.w;
              }
            }
          } else {
#pragma unroll
            for (int c = 0; c < kMaxC; ++c) {
              if (j0 + c < C) acc[c] = acc[c] + __ldg(pl + c);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxC; ++j) {
      if (j0 + j < C) {
        const long long o = (r0 + s) * C + j0 + j;
        out[o] = carry[o] + acc[j];
      }
    }
  }
}

}  // namespace

// packed: [tc, Pp] int2 scratch, int4 when `wide` (Pp = P rounded up to
// even). Fs (the bins' row stride in shared memory; unused when wide),
// TN and smem_bytes come from the wrapper's plan.
extern "C" int prf_traverse(const void* x, int N, int F, const void* feature,
                            const void* threshold, const void* left_child,
                            const void* payload, const void* carry, void* out,
                            void* packed, int tc, int P, int C, int depth, int Fs,
                            int TN, int smem_bytes, int wide, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0) return (int)cudaGetLastError();
  const int Pp = P + (P & 1);
  const long long n_nodes = (long long)tc * Pp;
  if (n_nodes > 0) {
    const unsigned blocks = (unsigned)((n_nodes + 255) / 256);
    if (wide) {
      pack_nodes_kernel<true><<<blocks, 256, 0, st>>>(
          (const int*)feature, (const int*)threshold, (const int*)left_child, packed, tc, P, Pp);
    } else {
      pack_nodes_kernel<false><<<blocks, 256, 0, st>>>(
          (const int*)feature, (const int*)threshold, (const int*)left_child, packed, tc, P, Pp);
    }
  }
  // Payload rows as float4 when one pass holds all of a row's classes.
  const bool vec4 = C <= kMaxC && C % 4 == 0 && (uintptr_t)payload % 16 == 0;
  const unsigned grid = (unsigned)((N + TN - 1) / TN);
  if (wide) {
    traverse_kernel<true><<<grid, TN, 0, st>>>(
        (const uint8_t*)x, N, F, 0, 1, packed, Pp, (const float*)payload, P,
        (const float*)carry, (float*)out, tc, C, depth, vec4);
    return (int)cudaGetLastError();
  }
  const uintptr_t xa = (uintptr_t)x;
  const int vec = (F % 16 == 0 && xa % 16 == 0) ? 16 : ((F % 4 == 0 && xa % 4 == 0) ? 4 : 1);
  static int smem_set = 48 * 1024;     // the largest size allowed so far (48 KiB needs no opt-in)
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        traverse_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  traverse_kernel<false><<<grid, TN, smem_bytes, st>>>(
      (const uint8_t*)x, N, F, Fs, vec, packed, Pp, (const float*)payload, P,
      (const float*)carry, (float*)out, tc, C, depth, vec4);
  return (int)cudaGetLastError();
}
