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
// (over the causal triangle) against Q (P + 2N/H) elements read and
// written. At mamba2-780m's prefill shape the bytes (x, y, b, c, log a and
// the f32 h_final) bound it, a little above the bf16 tensor cores'
// operations (chip_smoke.py reckons both). Two routes, chosen by dtype:
//
// * bf16 (ssd_tc_kernel), the model's path: all four products on the
//   tensor cores with wgmma, bf16 operands, f32 accumulators. One
//   warpgroup of 128 threads per (batch, head) walks the sequence in
//   chunks of 64 steps with the state on chip, whatever chunk the caller
//   names: the chunked form is the same function for every chunk length
//   (only rounding differs), and 64 rows are one wgmma tile, so the causal
//   score tile is one 64 x 64 block. A chunk-parallel design would write
//   and read back the [B, G, H, N, P] f32 chunk states (0.2 GB each way at
//   the path's shapes, beside 0.22 GB of inputs and outputs); this one
//   moves none. Per chunk:
//     S   = c b^T                     (c, b K-major from shared memory)
//     y   = exp(lc_i) * (c h_prev) + Sd x   (h_prev staged in shared
//           memory; Sd = S * exp(lc_i - lc_j), j <= i, from registers;
//           x MN-major)
//     h^T = exp(lc_Q) h^T + (w x)^T b  (w x from registers, x^T read by
//           ldmatrix.trans; b MN-major)
//   The state is kept transposed, h^T [P, N], as a register accumulator of
//   the last product, so that both operands of the update come in without
//   a transposed copy. The products go out as three wgmma groups (S and
//   c h_prev; the state update; Sd x), each next group's register operands
//   built on the CUDA cores while the last runs. ptxas serialises every
//   wgmma of the kernel if a register of the state is touched while a
//   wgmma is in flight (it inserts a wait, and a wait on a divergent path
//   serialises them all), so the state is scaled before the first group.
//   x and b come in by TMA into a two-stage ring with mbarriers, one
//   chunk ahead; c has one buffer, reloaded as soon as its two products
//   are done; y leaves through shared memory by a TMA store (stmatrix, as
//   the staged state). Rows past L read as zeros and log a as 0, and TMA
//   writes no y row past L, so any L is taken. The causal score blocks
//   past the diagonal take no exp. Four f32 quantities meet the tensor
//   cores: Sd, h_prev, w x, and the row scale exp(lc_i), which is applied
//   in f32 to the accumulator. A CPU emulation of the roundings at the
//   path's full shape (tests/test_torch_ssd_tc.py) put y past its bf16
//   tolerance with one bf16 rounding of Sd (1.85 x the allowance) or near
//   it with one of h_prev (0.98), and h_final 150 x past its f32 tolerance
//   with one of w x, so all three enter as bf16 parts hi = bf16(v) and
//   lo = bf16(v - hi), two wgmmas each (0.79 of y's allowance, 0.38 of
//   h's). Shared memory at N = 128, P = 64: 2 x (x, b) + c + h_prev hi/lo
//   + y = 106 KiB, two CTAs per SM. b and c are shared over the heads and
//   S is recomputed per head: at N = 128 it is a sixth of the tensor-core
//   work. P in {32, 64}, N in {16, 32, 64, 128}; at P = 32 the state's
//   64-row tile is half empty.
// * f32 (ssd_kernel): products on the CUDA cores, exact f32 products, so a
//   full-width f32 comparison with the plain version needs no TF32. One
//   block of 256 threads per (batch, head) walks the chunks in order, the
//   [N, P] state in shared memory the whole time. Within a chunk, b and c
//   are staged 32 state columns at a time: each slice adds to the [Q, Q]
//   score tile (8 x 8 per thread, in registers) and to the carried-state
//   term of y (8 x 4 per thread), then updates its 32 rows of the state in
//   place. The masked, decayed scores go to shared memory for y = S x.
//   Shared memory ~163 KiB at N = 128. This was also the bf16 route first:
//   4.749 ms at [8, 2048, 48, 64, N 128] on an NVIDIA H100 80GB HBM3 at
//   700 W (chip_smoke.py), 1.4% of its bound.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kQ = 128;      // largest chunk
constexpr int kNS = 32;      // state columns staged per slice
constexpr int kPM = 64;      // largest head dim P
constexpr int kThreads = 256;

size_t smem_bytes(int N) {
  return sizeof(float) * ((size_t)kQ * kPM + (size_t)kQ * (kQ + 1) + 2 * (size_t)kQ * (kNS + 1) +
                          (size_t)N * kPM + 3 * kQ);
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ loga, const float* __restrict__ bm,
           const float* __restrict__ cm, float* __restrict__ y, float* __restrict__ h_out, int L,
           int H, int P, int N, int Q) {
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
  const float* xb = x + (long long)b * L * x_step + (long long)h * P;
  float* yb = y + (long long)b * L * x_step + (long long)h * P;
  const float* lb = loga + (long long)b * L * H + h;
  const float* bb = bm + (long long)b * L * N;
  const float* cb = cm + (long long)b * L * N;

  for (int e = tid; e < N * kPM; e += kThreads) hs[e] = 0.0f;

  const int ti = tid / 16, tj = tid % 16;    // rows ti*8 .. ti*8+7; columns tj + 16 c

  for (int c0 = 0; c0 < L; c0 += Q) {
    __syncthreads();                         // the last chunk's readers are done
    for (int e = tid; e < kQ * kPM; e += kThreads) {
      const int r = e / kPM, p = e - r * kPM;
      xs[e] = (r < Q && p < P) ? xb[(long long)(c0 + r) * x_step + p] : 0.0f;
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
        cs[r * (kNS + 1) + nl] = in ? cb[g] : 0.0f;
        bs[r * (kNS + 1) + nl] = in ? bb[g] : 0.0f;
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
        if (p < P) yb[(long long)(c0 + i) * x_step + p] = ya[r][c] + yst[r][c];
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


int launch_f32(const void* x, const void* loga, const void* b, const void* c, void* y, void* h,
               int B, int L, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<<<B * H, kThreads, smem, stream>>>((const float*)x, (const float*)loga, (const float*)b,
                                                (const float*)c, (float*)y, (float*)h, L, H, P, N, Q);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;      // one warpgroup
constexpr int kC = 64;               // steps per chunk: the rows of one wgmma tile
constexpr float kLog2e = 1.4426950408889634f;

template <int P, int N>
struct SsdShape {
  static constexpr int SWP = 2 * P;                  // x row bytes: one 64- or 128-byte swizzle span
  static constexpr int SWN = N >= 64 ? 128 : 2 * N;  // b / c row-chunk bytes: 32, 64 or 128
  static constexpr int CWN = SWN / 2;                // state columns per chunk
  static constexpr int NC = N / CWN;                 // chunks per b / c row
  static constexpr int XT = kC * SWP;                // bytes of one x tile
  static constexpr int BT = NC * kC * SWN;           // bytes of one b (or c) tile
  static constexpr int HT = NC * P * SWN;            // bytes of one part of the staged state
  static constexpr size_t SMEM = 1024 + 3 * XT + 3 * BT + 2 * HT + 2 * 3 * kC * 4 + 3 * 8;
};

template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_tc_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap ty,
              const float* __restrict__ loga, float* __restrict__ h_out, int L, int H) {
  using Sh = SsdShape<P, N>;
  constexpr int SWP = Sh::SWP, SWN = Sh::SWN, CWN = Sh::CWN, NC = Sh::NC;
  constexpr int XT = Sh::XT, BT = Sh::BT, HT = Sh::HT;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on a 1024-byte boundary
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* xs = smem;                          // [2 stages][64 steps][SWP]
  uint8_t* bs = xs + 2 * XT;                   // [2 stages][NC][64 steps][SWN]
  uint8_t* cs = bs + 2 * BT;                   // [NC][64 steps][SWN]
  uint8_t* hs = cs + BT;                       // [hi, lo][NC][P][SWN]: h_prev^T, K-major
  uint8_t* ys = hs + 2 * HT;                   // [64 steps][SWP]: y of a chunk, for a TMA store
  // per chunk parity: [64] chunk-local cumsum of log a, exp(lc_i), exp(lc_end - lc_j)
  float* decays = reinterpret_cast<float*>(ys + XT);         // [2][3][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(decays + 2 * 3 * kC);   // c; x and b of stage 0, 1

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nch = (L + kC - 1) / kC;
  const float* lb = loga + (long long)b * L * H + h;
  const int r0 = warp * 16 + lane / 4;         // this thread's accumulator rows r0, r0 + 8
  const int cq = 2 * (lane % 4);               // and columns 8 j + cq + {0, 1}

  auto load_xb = [&](int stage, int g) {
    mbar_expect_tx(&bars[1 + stage], XT + BT);
    tma_load(xs + stage * XT, &tx, &bars[1 + stage], h * P, g * kC, b);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(bs + stage * BT + c * kC * SWN, &tb, &bars[1 + stage], c * CWN, g * kC, b);
  };
  auto load_c = [&](int g) {
    mbar_expect_tx(&bars[0], BT);
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_load(cs + c * kC * SWN, &tc, &bars[0], c * CWN, g * kC, b);
  };
  // warp 0 holds log a of steps 2 lane, 2 lane + 1 of the next chunk (0 past L)
  float pre[2];
  auto load_loga = [&](int g) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = g * kC + 2 * lane + e;
      pre[e] = t < L ? lb[(long long)t * H] : 0.0f;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    mbar_init_fence();
  }
  for (int e = tid; e < 2 * HT / 16; e += kTcThreads)
    reinterpret_cast<uint4*>(hs)[e] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    load_c(0);
    load_xb(0, 0);
    if (nch > 1) load_xb(1, 1);
  }
  // Warp 0 writes chunk g's decays into buffer g % 2 from the log a it
  // holds, then fetches chunk g + 1's: lc by a warp scan, exp(lc_i),
  // exp(lc_end - lc_j). Chunk g + 1's are made while chunk g's last
  // products run; a warp may still read chunk g's then, never g - 1's.
  auto make_decays = [&](int g) {
    float* lcw = decays + (g & 1) * 3 * kC;
    const float l0 = pre[0], l1 = l0 + pre[1];
    float incl = l1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += n;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    const float lc0 = excl + pre[0], lc1 = lc0 + pre[1];
    const float lc_end = __shfl_sync(0xffffffffu, lc1, 31);
    lcw[2 * lane] = lc0;
    lcw[2 * lane + 1] = lc1;
    lcw[kC + 2 * lane] = expf(lc0);
    lcw[kC + 2 * lane + 1] = expf(lc1);
    lcw[2 * kC + 2 * lane] = expf(lc_end - lc0);
    lcw[2 * kC + 2 * lane + 1] = expf(lc_end - lc1);
    if (g + 1 < nch) load_loga(g + 1);
  };
  if (warp == 0) {
    load_loga(0);
    make_decays(0);
  }

  float st[NC][CWN / 2];                       // h^T [P (64 rows), N]: the state
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < CWN / 2; ++i) st[c][i] = 0.0f;

  for (int g = 0; g < nch; ++g) {
    const int stage = g & 1;
    const float* lcs = decays + stage * 3 * kC;
    const float* ecs = lcs + kC;
    const float* wvs = ecs + kC;
    // the last chunk is done in every warp: this chunk's decays, the staged
    // state and y are in place, and the last chunk's x / b stage is free
    __syncthreads();
    if (tid == 0) {
      if (g >= 1 && g + 1 < nch) load_xb(stage ^ 1, g + 1);
      if (g >= 1) {                            // the last chunk's y, from shared memory
        tma_store(&ty, ys, h * P, (g - 1) * kC, b);
        bulk_commit();
      }
    }
    mbar_wait(&bars[0], g & 1);
    mbar_wait(&bars[1 + stage], (g >> 1) & 1);
    const uint8_t* xst = xs + stage * XT;
    const uint8_t* bst = bs + stage * BT;

    // h^T *= exp(lc_end) before any wgmma is in flight (rows past L add 0
    // to lc): touching the state's registers while one runs makes ptxas
    // wait for it
    const float decay = ecs[kC - 1];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < CWN / 2; ++i) st[c][i] *= decay;

    // Three wgmma groups, the CUDA-core work of each next one done while
    // the last runs. A: S = c b^T and y = c h_prev (hi + lo parts), over N
    // in steps of 16.
    float s[32], ya[P / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < P / 2; ++i) ya[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const int c = kk * 16 / CWN, off = (kk * 16 % CWN) * 2;
      wgmma_ss(s, smem_desc<SWN>(smem_u32(cs + c * kC * SWN) + off),
               smem_desc<SWN>(smem_u32(bst + c * kC * SWN) + off), kk > 0);
    }
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const int c = kk * 16 / CWN, off = (kk * 16 % CWN) * 2;
        wgmma_ss(ya, smem_desc<SWN>(smem_u32(cs + c * kC * SWN) + off),
                 smem_desc<SWN>(smem_u32(hs + part * HT + c * P * SWN) + off), part + kk > 0);
      }
    wg_commit();

    // B: h^T += (w x)^T b (b MN-major). (w x)^T [P rows,
    // 64 steps] as A fragments of two bf16 parts, x^T read by ldmatrix
    // .trans (lanes 8m .. 8m + 7: rows of 8 x 8 block m, p + 8 (m % 2),
    // t + 8 (m / 2)); the rows p >= P of a P = 32 state are 0
    uint32_t wx_hi[4][4], wx_lo[4][4];
    if (16 * warp < P) {
      const int m = lane / 8;
      const uint32_t col = 2 * (16 * warp + 8 * (m % 2));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t xr[4];
        ldsm_x4_trans(xr, xst + swz<SWP>((16 * kk + 8 * (m / 2) + lane % 8) * SWP + col));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 w = *reinterpret_cast<const float2*>(wvs + 16 * kk + 8 * (k / 2) + cq);
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(&xr[k]);
          split_bf16(w.x * __low2float(xv), w.y * __high2float(xv), wx_hi[kk][k], wx_lo[kk][k]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int k = 0; k < 4; ++k) wx_hi[kk][k] = wx_lo[kk][k] = 0u;
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t db = smem_desc<SWN>(smem_u32(bst + c * kC * SWN) + kk * 16 * SWN);
        wgmma_rs(st[c], wx_hi[kk], db);
        wgmma_rs(st[c], wx_lo[kk], db);
      }
    wg_commit();

    wg_wait<1>();                              // A is done
    reg_fence(s);
    reg_fence(ya);
    if (tid == 0) bulk_wait_read();            // the last chunk's y has left shared memory
    __syncthreads();                           // every read of c is done
    if (tid == 0 && g + 1 < nch) load_c(g + 1);

    // C: y's carried-state rows times exp(lc_i), then y += Sd x (x
    // MN-major), Sd = S * exp(lc_i - lc_j) for j <= i as the A fragments of
    // two bf16 parts
    const float li[2] = {lcs[r0], lcs[r0 + 8]};
    const float ei[2] = {ecs[r0], ecs[r0 + 8]};
#pragma unroll
    for (int i = 0; i < P / 2; ++i) ya[i] *= ei[(i / 2) % 2];
    // columns 8 j .. 8 j + 7 against this warp's rows 16 warp .. 16 warp +
    // 15: wholly visible, wholly masked (no exp at all), or the diagonal
    uint32_t sd_hi[4][4], sd_lo[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool none = 8 * j > 16 * warp + 15, all = 8 * j + 7 <= 16 * warp;
      const float2 lj = *reinterpret_cast<const float2*>(lcs + 8 * j + cq);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float v[2] = {0.0f, 0.0f};
        if (!none) {
          const int row = r0 + 8 * hf;
          const float d[2] = {li[hf] - lj.x, li[hf] - lj.y};
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (all || 8 * j + cq + e <= row) v[e] = s[4 * j + 2 * hf + e] * exp2f(d[e] * kLog2e);
        }
        split_bf16(v[0], v[1], sd_hi[j / 2][2 * (j % 2) + hf], sd_lo[j / 2][2 * (j % 2) + hf]);
      }
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = smem_desc<SWP>(smem_u32(xst) + kk * 16 * SWP);
      wgmma_rs(ya, sd_hi[kk], dx);
      wgmma_rs(ya, sd_lo[kk], dx);
    }
    wg_commit();
    if (warp == 0 && g + 1 < nch) make_decays(g + 1);
    wg_wait<0>();                              // B and C are done
    reg_keep(wx_hi);
    reg_keep(wx_lo);
    reg_keep(sd_hi);
    reg_keep(sd_lo);
    reg_fence(ya);
#pragma unroll
    for (int c = 0; c < NC; ++c) reg_fence(st[c]);

    // Stage the new state, hi and lo, as the K-major operand [P][N] of the
    // next chunk (group A, its only reader, is done in every warp), and y
    // in shared memory for the next chunk's first thread to store by TMA
    // (rows past L are not written); both swizzled as TMA and wgmma read
    // them. stmatrix block m of a step: rows + 8 (m % 2), columns + 8 (m / 2).
    const int m = lane / 8, mrow = r0 - lane / 4 + 8 * (m % 2) + lane % 8;
    if (P == 64 || 16 * warp < P) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < CWN / 8; j += 2) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 4 * (j + q / 2) + 2 * (q % 2);
            split_bf16(st[c][i], st[c][i + 1], hi[q], lo[q]);
          }
          const uint32_t o = c * P * SWN + swz<SWN>(mrow * SWN + 16 * (j + m / 2));
          stsm_x4(hs + o, hi);
          stsm_x4(hs + HT + o, lo);
        }
    }
#pragma unroll
    for (int j = 0; j < P / 8; j += 2) {
      uint32_t yv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * (j + q / 2) + 2 * (q % 2);
        yv[q] = bits(__floats2bfloat162_rn(ya[i], ya[i + 1]));
      }
      stsm_x4(ys + swz<SWP>(mrow * SWP + 16 * (j + m / 2)), yv);
    }
    fence_proxy_async();
  }
  __syncthreads();
  if (tid == 0) {
    tma_store(&ty, ys, h * P, (nch - 1) * kC, b);
    bulk_commit();
    bulk_wait();
  }

  float* hb = h_out + (long long)bh * N * P;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < CWN / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = r0 + 8 * hf;
          if (P == 64 || p < P) hb[(c * CWN + 8 * j + cq + e) * P + p] = st[c][4 * j + 2 * hf + e];
        }
}

template <int P, int N>
int launch_tc(const void* x, const void* loga, const void* b, const void* c, void* y, void* h,
              int B, int L, int H, cudaStream_t stream) {
  using Sh = SsdShape<P, N>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tx, tb, tc, ty;
  if (!make_map_bf16(&tx, encode, x, H * P, L, B, kC, Sh::SWP) ||
      !make_map_bf16(&ty, encode, y, H * P, L, B, kC, Sh::SWP) ||
      !make_map_bf16(&tb, encode, b, N, L, B, kC, Sh::SWN) ||
      !make_map_bf16(&tc, encode, c, N, L, B, kC, Sh::SWN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_tc_kernel<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  ssd_tc_kernel<P, N><<<B * H, kTcThreads, Sh::SMEM, stream>>>(
      tx, tb, tc, ty, (const float*)loga, (float*)h, L, H);
  return (int)cudaGetLastError();
}

template <int P>
int launch_tc_n(const void* x, const void* loga, const void* b, const void* c, void* y, void* h,
                int B, int L, int H, int N, cudaStream_t s) {
  switch (N) {
    case 16: return launch_tc<P, 16>(x, loga, b, c, y, h, B, L, H, s);
    case 32: return launch_tc<P, 32>(x, loga, b, c, y, h, B, L, H, s);
    case 64: return launch_tc<P, 64>(x, loga, b, c, y, h, B, L, H, s);
    case 128: return launch_tc<P, 128>(x, loga, b, c, y, h, B, L, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x/y [B, L, H, P], loga [B, L, H] f32, b/c [B, L, N], h [B, H, N, P] f32.
// bf16 != 0: x, b, c, y are bf16, 16-byte aligned (tensor cores; P in
// {32, 64}, N in {16, 32, 64, 128}, any L; chunk is not read); else f32
// (CUDA cores; chunk Q <= 128 divides L, P <= 64, N <= 256).
extern "C" int lm_ssd_scan(const void* x, const void* loga, const void* b, const void* c, void* y,
                           void* h, int B, int L, int H, int P, int N, int Q, int bf16,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (L < 1) return (int)cudaErrorInvalidValue;
    if (P == 32) return launch_tc_n<32>(x, loga, b, c, y, h, B, L, H, N, s);
    if (P == 64) return launch_tc_n<64>(x, loga, b, c, y, h, B, L, H, N, s);
    return (int)cudaErrorInvalidValue;
  }
  if (Q < 1 || Q > kQ || L % Q != 0 || P < 1 || P > kPM || N < 1 || N > 256)
    return (int)cudaErrorInvalidValue;
  return launch_f32(x, loga, b, c, y, h, B, L, H, P, N, Q, s);
}
