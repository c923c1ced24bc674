// Blocked causal / sliding-window attention with an online softmax, GQA.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// attention_pallas_call (body _attn_kernel). For query i of a [Lq] tile
// and keys j of [Lk], query i sits at position i + off (off = Lk - Lq, ends
// aligned, unless the caller names another: a shard of a longer sequence):
// s = (q_i . k_j) * scale, masked (causal: j <= pos_i; window W > 0:
// j > pos_i - W; a prefix P > 0 keeps keys j < P visible to every query
// whatever the other two say: hymba's meta tokens) to -1e30; running max
// m, sum l and accumulator acc in f32 across key tiles; out = acc /
// max(l, 1e-38) in q's dtype. Given an lse buffer, both kernels also write
// each row's m + log l (natural units of the scaled logits), which the
// backward kernel (flash_attention_bwd.cu) reads; prefill passes none.
//
// Layout is the model's: q/out [B, Lq, H, D], k/v [B, Lk, KV, D], so the
// caller transposes nothing. Query head h reads KV head h / (H / KV): the
// reference's jnp.repeat of the KV heads, never materialised. Key tiles
// that are masked for every query of a query tile are skipped (past the
// causal diagonal, before the window); the prefix's tiles [0, ceil(P /
// 64)) are always visited, then the span from max(their end, the
// window's first tile) to the diagonal. Every query keeps a visible key
// (0 <= off <= Lk - Lq for a masked call, checked by the wrapper), so skipping and
// weighing masked entries exactly 0 change nothing.
//
// What bounds it on an H100: at prefill shapes (L = 2048, D = 64) the
// work is 4 * L^2 * D / 2 flops per (batch, head) against 2 * L * D bytes
// of K/V per head, far above the card's ~295 bf16 flops per byte, so the
// tensor cores' operations bound it. Two routes, chosen by dtype:
//
// * bf16 (flash_tc_kernel), the model's path: both products on the tensor
//   cores with wgmma, bf16 operands and f32 accumulators. One warpgroup of
//   128 threads owns 64 query rows; the Q tile and a two-stage ring of
//   64-key K/V tiles come in by TMA (one 4-D tensor map per operand over
//   the model's layout, [B][L][heads][D], boxes of one head by 64 rows by
//   one 128-byte (padded width 32: 64-byte) swizzle span), completion on
//   mbarriers. The swizzle puts each tile in the layout the wgmma
//   shared-memory descriptors read, and TMA fills rows past L with zeros.
//   Any head dim D that is a multiple of 8 runs (the wrapper pads others
//   with zero columns): the kernel is built for the padded width DP, D
//   rounded up to whole swizzle spans (32, 64, 128, 192 or 256), and D is
//   the map's innermost extent, so the columns of a box past D lie outside
//   the tensor and TMA fills them with zeros, never with the next head's
//   columns (which a [heads * D] row would hand it). Zero columns of Q and
//   K add nothing to Q K^T; the output's columns past D come from zero
//   columns of V and are not stored. The scale is the true D's. S = Q K^T reads Q and K from
//   shared memory (both K-major); O += P V takes P from registers: S's
//   accumulator fragment, converted to bf16, is the register-A layout of
//   the next wgmma. V is read MN-major through the transpose bit, never
//   transposed in memory. The online softmax stays in registers (row
//   reductions by quad shuffles). The reference multiplies V by f32
//   probabilities; one rounding of P to bf16 put the path's full-shape
//   outputs outside the bf16 tolerance the kernel is held to, so P goes in
//   as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi), two wgmmas on
//   the same V tile: P keeps ~16 bits, at 1.5x the tensor-core work.
// * f32 (flash_kernel): products on the CUDA cores, exact f32 products,
//   so a full-width f32 comparison with the plain version needs no TF32.
//   One block of 256 threads per (batch * head, 64-query tile); 64-key K/V
//   tiles staged in shared memory as f32; each thread owns a 4 x 4 block of
//   the score tile and a 4 x (D/16) block of the output. This was also the
//   bf16 route first: 2.520 ms at [8, 9 H / 3 KV, 2048, 2048, 64] causal
//   bf16 on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), 1.6% of the
//   tensor cores' bound.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 64;      // queries per block
constexpr int kBK = 64;      // keys per tile
constexpr float kMasked = -1e30f;

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D +
                          (size_t)kBQ * (kBK + 1) + 3 * kBQ);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int H, int KV, int D,
             int causal, int window, int prefix, int off, float scale) {
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
  const float* qb = q + (long long)b * Lq * q_step + (long long)h * D;
  const float* kb = k + (long long)b * Lk * kv_step + (long long)kvh * D;
  const float* vb = v + (long long)b * Lk * kv_step + (long long)kvh * D;
  float* ob = out + (long long)b * Lq * q_step + (long long)h * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[e] = q0 + r < Lq ? qb[(long long)(q0 + r) * q_step + d] : 0.0f;
  }
  if (tid < kBQ) {
    row_m[tid] = kMasked;
    row_l[tid] = 0.0f;
  }

  // Keys visible to some query of this tile: the prefix's tiles, then [k_beg, k_end).
  const int q_last = (q0 + kBQ < Lq ? q0 + kBQ : Lq) - 1;
  const int n_pre = prefix > 0 ? (min(prefix, Lk) + kBK - 1) / kBK : 0;
  int k_end = Lk, k_beg = 0;
  if (causal) k_end = min(Lk, q_last + off + 1);
  if (window > 0) k_beg = max(0, q0 + off - window + 1);
  k_beg = max((k_beg / kBK) * kBK, n_pre * kBK);
  const int ntiles = n_pre + (k_end > k_beg ? (k_end - k_beg + kBK - 1) / kBK : 0);

  const int ty = tid / 16, tx = tid % 16;    // rows ty*4 .. ty*4+3
  constexpr int kDC = DMAX / 16;             // output columns per thread: tx + 16 c
  float acc[4][kDC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[r][c] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it < n_pre ? it * kBK : k_beg + (it - n_pre) * kBK;
    __syncthreads();                         // the last tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const bool in = k0 + r < Lk;
      const long long g = (long long)(k0 + r) * kv_step + d;
      ks[r * (D + 1) + d] = in ? kb[g] : 0.0f;
      vs[e] = in ? vb[g] : 0.0f;
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
        const bool ok = kpos < Lk && q0 + i < Lq &&
                        (kpos < prefix || ((!causal || kpos <= qpos) &&
                                           (window <= 0 || kpos > qpos - window)));
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
      if (d < D) ob[(long long)(q0 + i) * q_step + d] = acc[r][c] / l;
    }
  }
  if (lse != nullptr && tid < kBQ && q0 + tid < Lq)
    lse[(long long)bh * Lq + q0 + tid] = row_m[tid] + logf(fmaxf(row_l[tid], 1e-38f));
}

template <int DMAX>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Lq, int Lk,
               int H, int KV, int D, int causal, int window, int prefix, int off, float scale,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBQ - 1) / kBQ, B * H);
  flash_kernel<DMAX><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, Lq, Lk, H, KV, D, causal,
      window, prefix, off, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;               // one warpgroup: 64 query rows

// DP: the padded head dim the kernel is built for, a whole number of swizzle spans.
template <int DP>
struct TcShape {
  static constexpr int SW = DP >= 64 ? 128 : 64;  // swizzle span: bytes of one row chunk
  static constexpr int CW = SW / 2;               // bf16 columns per chunk
  static constexpr int DC = DP / CW;              // chunks per row
  static constexpr int TILE = kBQ * SW;           // bytes of one 64-row chunk
  static constexpr int NV = CW;                   // n of one P V wgmma (one chunk of V)
  static constexpr size_t SMEM = 1024 + 5 * (size_t)DC * TILE + 64;  // align, Q, 2 x (K, V), barriers
};

template <int DP>
__global__ void __launch_bounds__(kTcThreads, DP <= 64 ? 3 : 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, int Lq, int Lk, int H, int KV, int D, int causal, int window,
                int prefix, int off, float scale_log2) {
  using Sh = TcShape<DP>;
  constexpr int SW = Sh::SW, CW = Sh::CW, DC = Sh::DC, TILE = Sh::TILE, NV = Sh::NV;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles must start on a 1024-byte boundary.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                              // [DC][64 rows][SW]
  uint8_t* ks = qs + DC * TILE;                    // [2 stages][DC][64 keys][SW]
  uint8_t* vs = ks + 2 * DC * TILE;                // [2 stages][DC][64 keys][SW]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * DC * TILE);   // Q, K/V stage 0, 1

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // the longest causal rows first

  // Key tiles: the prefix's n_pre tiles, then [k_beg, k_end) from where they end.
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
      tma_load(ks + (stage * DC + c) * TILE, &tk, &bars[1 + stage], c * CW, kvh, k0, b);
      tma_load(vs + (stage * DC + c) * TILE, &tv, &bars[1 + stage], c * CW, kvh, k0, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], DC * TILE);
#pragma unroll
    for (int c = 0; c < DC; ++c) tma_load(qs + c * TILE, &tq, &bars[0], c * CW, h, q0, b);
    if (ntiles > 0) load_kv(0, tile_k0(0));
  }

  // Accumulator fragment of a 64-row wgmma: register 4j + 2 half + e holds
  // row r0 + 8 half, column 8j + cq + e of the tile.
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int pos0 = q0 + r0 + off;                  // positions of this thread's two rows
  float o[DC][NV / 2];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[c][i] = 0.0f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};

  mbar_wait(&bars[0], 0);
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1;
    const int k0 = tile_k0(it);
    // The other stage was released by the barrier that ended the last tile.
    if (tid == 0 && it + 1 < ntiles) load_kv(stage ^ 1, tile_k0(it + 1));
    mbar_wait(&bars[1 + stage], (it >> 1) & 1);

    // S = Q K^T over D in steps of 16
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / (CW / 16), j = kk % (CW / 16);
      wgmma_ss(s, smem_desc<SW>(smem_u32(qs + c * TILE) + j * 32),
                   smem_desc<SW>(smem_u32(ks + (stage * DC + c) * TILE) + j * 32), kk > 0);
    }
    wg_commit();
    wg_wait();
    reg_fence(s);

    // mask (only tiles that cross an edge), scale to log2 units, row max
    const bool edge = k0 < prefix || k0 + kBK > Lk || (causal && k0 + kBK - 1 > q0 + off) ||
                      (window > 0 && k0 < q_last + off - window + 1);
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hf + e];
          x *= scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * j + cq + e, qpos = pos0 + 8 * hf;
            const bool ok = kpos < Lk &&
                            (kpos < prefix || ((!causal || kpos <= qpos) &&
                                               (window <= 0 || kpos > qpos - window)));
            if (!ok) x = kMasked;
          }
          mx[hf] = fmaxf(mx[hf], x);
        }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      alpha[hf] = exp2f(m[hf] - m_new);
      m[hf] = m_new;
      l[hf] *= alpha[hf];
    }
    // P = exp2(s - m), masked entries exactly 0, as the A fragments of two
    // bf16 parts: hi = bf16(P), lo = bf16(P - hi)
    uint32_t pa_hi[kBK / 16][4], pa_lo[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[4 * j + 2 * hf + e];
          p[e] = x == kMasked ? 0.0f : exp2f(x - m[hf]);
          l[hf] += p[e];
        }
        // k16 step j / 2: registers {row r0, cols 0-7}, {r0 + 8, 0-7}, {r0, 8-15}, {r0 + 8, 8-15}
        split_bf16(p[0], p[1], pa_hi[j / 2][2 * (j % 2) + hf], pa_lo[j / 2][2 * (j % 2) + hf]);
      }
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) o[c][i] *= alpha[(i / 2) % 2];

    // O += P V = hi V + lo V over the tile's keys in steps of 16
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const uint64_t dv = smem_desc<SW>(smem_u32(vs + (stage * DC + c) * TILE) + kk * 16 * SW);
        wgmma_rs(o[c], pa_hi[kk], dv);
        wgmma_rs(o[c], pa_lo[kk], dv);
      }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < DC; ++c) reg_fence(o[c]);
    __syncthreads();                               // this stage's K/V are free
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    l[hf] = fmaxf(l[hf], 1e-38f);
  }
  // m is in log2 units of the scaled logits: lse = m ln 2 + ln l, natural units
  if (lse != nullptr && cq == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + r0 + 8 * hf;
      if (row < Lq) lse[(long long)bh * Lq + row] = m[hf] * 0.6931471805599453f + logf(l[hf]);
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + r0 + 8 * hf;
    if (row >= Lq) continue;
    __nv_bfloat16* orow = out + (((long long)b * Lq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < NV / 8; ++j) {
        const int col = c * NV + 8 * j + cq;   // D is even: col < D covers col + 1
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[c][4 * j + 2 * hf] / l[hf], o[c][4 * j + 2 * hf + 1] / l[hf]);
      }
  }
}

// [B][L][heads][D] bf16 as a 4-D map, boxes of one head by 64 rows by one swizzle span.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B, int L, int heads,
              int D, int sw) {
  return make_map_bf16_4d(map, encode, ptr, D, heads, L, B, kBQ, sw);
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Lq, int Lk,
              int H, int KV, int D, int causal, int window, int prefix, int off, float scale,
              cudaStream_t stream) {
  using Sh = TcShape<DP>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, q, B, Lq, H, D, Sh::SW) ||
      !make_map(&tk, encode, k, B, Lk, KV, D, Sh::SW) ||
      !make_map(&tv, encode, v, B, Lk, KV, D, Sh::SW))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Lq + kBQ - 1) / kBQ);
  flash_tc_kernel<DP><<<grid, kTcThreads, Sh::SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, lse, Lq, Lk, H, KV, D, causal, window, prefix, off,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B, Lq, H, D], k/v [B, Lk, KV, D]; the first `prefix` keys are
// visible to every query; query i sits at key position i + off. bf16 != 0: all four are bf16 (tensor cores; D a
// multiple of 8, 16-byte aligned), else f32 (CUDA cores). D <= 256. lse
// [B, H, Lq] f32, or null: each row's log-sum-exp of its scaled logits
// (m + log l, natural units), which the backward kernel reads; null skips
// the write.
extern "C" int lm_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int Lq, int Lk, int H, int KV, int D, int causal,
                                  int window, int prefix, int off, float scale, int bf16, void* stream) {
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0 || prefix < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (Lk < 1 || D % 8 != 0) return (int)cudaErrorInvalidValue;
#define FLASH_TC(DP) \
  launch_tc<DP>(q, k, v, out, (float*)lse, B, Lq, Lk, H, KV, D, causal, window, prefix, off, scale, s)
    if (D <= 32) return FLASH_TC(32);
    if (D <= 64) return FLASH_TC(64);
    if (D <= 128) return FLASH_TC(128);
    if (D <= 192) return FLASH_TC(192);
    return FLASH_TC(256);
#undef FLASH_TC
  }
#define FLASH_F32(DMAX) \
  launch_f32<DMAX>(q, k, v, out, (float*)lse, B, Lq, Lk, H, KV, D, causal, window, prefix, off, scale, s)
  if (D <= 64) return FLASH_F32(64);
  if (D <= 128) return FLASH_F32(128);
  return FLASH_F32(256);
#undef FLASH_F32
}
