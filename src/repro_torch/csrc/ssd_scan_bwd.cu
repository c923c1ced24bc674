// Backward of the Mamba-2 SSD chunked scan (csrc/ssd_scan.cu), from h = 0.
//
// No TPU kernel is replaced: the reference differentiates its chunked
// einsum form (repro/models/mamba.py: _ssd_chunked) with XLA. These kernels
// exist because training an ssm or hybrid layer on the card runs the
// forward scan as a kernel (kernels/ssd_scan/ops.py: SSDScanFn), and the
// port takes no step back to a plain version on the card: the plain
// chunked gradient holds [B, G, Q, Q, H] f32 tensors (0.8 GB each at
// mamba2-780m's training microbatch).
//
// They compute kernels/ssd_scan/ref.py: ssd_chunked_bwd. Per (batch, head),
// in chunks of 64 steps whatever chunk the forward walked (the chunked form
// is the same function for every chunk length), with lc the chunk-local
// cumulative log decay, D_ij = exp(lc_i - lc_j) for j <= i, H_g the state
// entering chunk g and dH its gradient:
//   dH_g  = sum_i exp(lc_i) c_i dy_i^T + exp(lc_Q) dH_{g+1}    (dH_G = 0)
//   dx_j  = sum_i (c_i . b_j) D_ij dy_i + exp(lc_Q - lc_j) dH_{g+1}^T b_j
//   dS_ij = D_ij (dy_i . x_j)
//   db_j  = sum_h [sum_i dS_ij c_i + exp(lc_Q - lc_j) dH_{g+1} x_j]
//   dc_i  = sum_h [sum_j dS_ij b_j + exp(lc_i) H_g dy_i]
//   dloga_t = sum_{j < t <= i} A_ij + sum_{i >= t} exp(lc_i) dy_i . (c_i H_g)
//             + sum_{j < t} exp(lc_Q - lc_j) x_j . (b_j dH_{g+1}) + exp(lc_Q) <H_g, dH_{g+1}>
// with A_ij = (c_i . b_j) dS_ij, t, i, j in chunk g: each term goes to the
// log decays its decay factor spans, so no sum is subtracted from another.
// The shorter identity sum_{s >= t} (dy_s . y_s - dx_s . x_s) subtracts two
// sums of a larger scale: it put a_log's gradient further from its f64
// value than autograd does, this form nearer (tools/ssd_dloga_accuracy.py).
// exp is taken only where j <= i: for j > i the exponent is positive and
// would overflow, and a masked 0 * inf is NaN. No float atomics: every
// output has one writer and every sum a fixed order, so two calls give the
// same bits.
//
// Layout is the model's: x, dy, dx [B, L, H, P]; log a, d log a [B, L, H]
// f32; b, c, db, dc [B, L, N] shared over the heads.
//
// What bounds it on an H100: at mamba2's training microbatch [4, 2048, 48
// heads, P 64, N 128] the function moves 162.5 MB (x, dy, dx in bf16; b, c,
// db, dc; log a and d log a in f32), 0.0485 ms at 3.35 TB/s, and does 42.1
// GFLOP in 64-step chunks over the causal triangle (three Q^2/2 products
// over N once a (batch, chunk), as S and the sum of dS over the heads are
// shared; two over P and six Q N P products a head), 0.0426 ms on the bf16
// tensor cores (chip_smoke.ssd_bwd_work): bytes bound it, as at hymba's
// N 16 (0.048 ms). Two routes, by dtype:
//
// * bf16, the training path: the tensor cores, in two launches.
//   - ssd_bwd_state_tc_kernel, the only serial part: one warpgroup per
//     (batch, head, direction) walks the chunks, forward for H_g and in
//     reverse for dH_{g+1} (the two walks are independent, so both run at
//     once), with ssd_tc_kernel's state update on wgmma. It writes each
//     state to a scratch [2][B, H, G] of tiles as bf16 hi and lo planes
//     [N][P], swizzled as the next pass reads them (2 x 201 MB at mamba2's
//     microbatch, the bytes of f32).
//   - ssd_bwd_chunk_tc_kernel: one block of two warpgroups per (batch,
//     chunk), all chunks at once, walking the heads in order. b and c are
//     shared over the heads, so S = c b^T is made once a block, and the
//     heads' db and dc are summed on chip: their state terms as one product
//     over (head, P) in the accumulator, (we x) dH^T and (el dy) H^T, their
//     pair terms from the sum of dS over the heads, (sum dS)^T c and
//     (sum dS) b, after the last head. No per-head partials, no second
//     launch. Per head, in the orientation rows j (source step), columns i
//     (target step), so that (S D)^T and A^T are register-A fragments of the
//     products over i: G^T = x dy^T, T = b dH, C H, dx = we T + (S D)^T dy,
//     and the pair terms of d log a as Q = A^T U with U the 0 / 1 matrix
//     [i >= t] (sum_{j < t} Q[j][t] is sum_{j < t <= i} A_ij); the state
//     terms of d log a are row dot products of T and C H with x and dy, the
//     carry a dot product of the staged planes. x, dy and the two states come
//     in by TMA and bulk copies into a two-stage ring, a head ahead.
//   What bounds this design is the chunk states' traffic, not the products:
//   the passes write and read ~1 GB of them at mamba2's microbatch (0.3 ms
//   at 3.35 TB/s); the state pass runs 1.45 waves (384 blocks, two an SM at
//   84 KiB of shared memory), and the chunk pass's ring (80 KiB a head at
//   N 128) fills 222 KiB, one block an SM, which its 128 blocks on 132 SMs
//   could not use twice anyway. On an H100 80GB HBM3 at 700 W: 0.58 ms a
//   call there (state pass 0.21, chunk pass 0.36, of it 0.045 for the
//   state terms' lo x hi product), 8.3% of the bound, from 4.27 ms for the
//   f32 route below; 0.31 ms at hymba's (tools/ssd_bwd_ab.py).
//   Operands: x, dy, b and c are exact in bf16. Each f32 quantity that
//   meets the tensor cores enters as the parts hi = bf16(v) and lo =
//   bf16(v - hi), two wgmmas (three for a product of two such: hi hi, hi
//   lo, lo hi), as a CPU emulation of the roundings at both training
//   microbatches decided (tests/test_torch_ssd_bwd_tc.py, which also shows
//   each split needed): w x and el dy in the state updates, the states H_g
//   in C H and dH_{g+1} in T, (S D)^T, A^T and the sum of dS (one rounding
//   of w x, el dy, A^T or a state leaves d log a, held at f32's tolerance,
//   47-144x past its allowance; of (S D)^T dx 1.5-2.0x; of the sum of dS db
//   1.4x); and both operands of db's and dc's state terms, w x with dH and
//   el dy with H (one rounding of those operands keeps db and dc within
//   their allowance only through its relative term: up to 1.0e-2 of their
//   rms off before the outputs' own rounding, the whole of its 1e-2 rms
//   term, where the splits leave under 1e-4). Row scales (we_j on T, el_i
//   on the state terms of d log a) are applied in f32 to accumulators.
// * f32 (ssd_bwd_kernel + ssd_bwd_head_sum_kernel): f32 FMAs on the CUDA
//   cores, so a full-width f32 comparison with the plain version needs no
//   TF32, as the forward's f32 route. One block of 256 threads per (batch,
//   head) recomputes the chunk states by a forward walk into an f32 scratch
//   [B, H, G, N, P], then walks the chunks in reverse with dH in registers;
//   each block writes its head's db and dc partials to f32 [B, H, L, N] and
//   the second launch sums them over h = 0 .. H-1 in order. This was also
//   the bf16 route first: 4.29-4.31 ms at mamba2's microbatch on an H100
//   80GB HBM3 at 700 W, 1.1% of the bound (its inner loops limited by
//   shared-memory loads, one block an SM, 0.6 GB of scratch).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kQ = 64;        // steps per chunk; on the tensor cores the rows of one wgmma tile
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int P, int N>
struct BwdShape {
  static constexpr int XS = P + 1;             // row stride of x, dy (floats)
  static constexpr int BS = N + 1;             // of b, c
  static constexpr int SS = kQ + 1;            // of the score tiles
  static constexpr int HS = P + 1;             // of H, dH
  static constexpr int QP = P / 16;            // column groups of a [*, P] tile a thread owns
  static constexpr int QN = N / 16;            // of a [*, N] tile
  static constexpr size_t SMEM = sizeof(float) * (2 * kQ * XS + 2 * kQ * BS + 3 * kQ * SS + 2 * N * HS +
                                                  6 * kQ + 8);
};

// rows [0, rows) of a [kQ, cols] chunk into shared memory (row stride ld), zeros past them
__device__ void load_chunk(float* dst, int ld, const float* src, long long stride, int rows, int cols) {
  for (int e = threadIdx.x; e < kQ * cols; e += kThreads) {
    const int r = e / cols, k = e - r * cols;
    dst[r * ld + k] = r < rows ? src[r * stride + k] : 0.0f;
  }
}

// One warp: the chunk's lc (cumulative log a, 0 past the rows), exp(lc_i)
// and exp(lc_end - lc_j). Lane l owns steps 2 l, 2 l + 1.
__device__ void chunk_decays(const float* lb, int H, int rows, float* lc, float* el, float* we) {
  const int lane = threadIdx.x % 32;
  const float a0 = 2 * lane < rows ? lb[(long long)(2 * lane) * H] : 0.0f;
  const float a1 = 2 * lane + 1 < rows ? lb[(long long)(2 * lane + 1) * H] : 0.0f;
  float incl = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  const float l0 = excl + a0, l1 = l0 + a1;
  const float lend = __shfl_sync(kFull, l1, 31);
  lc[2 * lane] = l0;
  lc[2 * lane + 1] = l1;
  el[2 * lane] = expf(l0);
  el[2 * lane + 1] = expf(l1);
  we[2 * lane] = expf(lend - l0);
  we[2 * lane + 1] = expf(lend - l1);
}

// One warp: d log a of the chunk's steps t = 2 lane, 2 lane + 1 from the
// pair terms' sums over j < t <= i (r0, r1), the state terms sty, added
// into every step up to theirs (a suffix scan), and stx, into every step
// after theirs (an exclusive prefix scan), and the carry; written where t < rows.
__device__ void dloga_steps(float r0, float r1, float y0, float y1, float x0, float x1, float carry,
                            float* dlb, int H, int rows) {
  const int lane = threadIdx.x % 32;
  float ys = y0 + y1, xp = x0 + x1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_down_sync(kFull, ys, o);
    const float m = __shfl_up_sync(kFull, xp, o);
    if (lane + o < 32) ys += n;
    if (lane >= o) xp += m;
  }
  float ysx = __shfl_down_sync(kFull, ys, 1), xpx = __shfl_up_sync(kFull, xp, 1);
  if (lane == 31) ysx = 0.0f;
  if (lane == 0) xpx = 0.0f;
  const float sy1 = ysx + y1, sy0 = sy1 + y0;      // suffix sums at 2 lane + 1, 2 lane
  const float px0 = xpx, px1 = xpx + x0;           // exclusive prefix sums
  if (2 * lane < rows) dlb[(long long)(2 * lane) * H] = r0 + sy0 + px0 + carry;
  if (2 * lane + 1 < rows) dlb[(long long)(2 * lane + 1) * H] = r1 + sy1 + px1 + carry;
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ loga, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ dy, float* __restrict__ dx,
               float* __restrict__ dloga, float* __restrict__ states, float* __restrict__ db_part,
               float* __restrict__ dc_part, int L, int H) {
  using Sh = BwdShape<P, N>;
  constexpr int XS = Sh::XS, BS = Sh::BS, SS = Sh::SS, HS = Sh::HS, QP = Sh::QP, QN = Sh::QN;
  extern __shared__ float smem[];
  float* xs = smem;                  // [kQ][XS] x of the chunk
  float* dys = xs + kQ * XS;         // [kQ][XS] dy
  float* bs = dys + kQ * XS;         // [kQ][BS] b
  float* cs = bs + kQ * BS;          // [kQ][BS] c
  float* sd = cs + kQ * BS;          // [kQ][SS] S_ij D_ij, 0 for j > i
  float* ds = sd + kQ * SS;          // [kQ][SS] dS_ij
  float* aa = ds + kQ * SS;          // [kQ][SS] A_ij, then its row prefix sums sum_{j < t} A_ij
  float* hs = aa + kQ * SS;          // [N][HS] H_g
  float* dhs = hs + N * HS;          // [N][HS] dH_{g+1}
  float* lc = dhs + N * HS;          // [kQ]
  float* el = lc + kQ;               // [kQ] exp(lc_i)
  float* we = el + kQ;               // [kQ] exp(lc_end - lc_j)
  float* rect = we + kQ;             // [kQ] sum_{j < t <= i} A_ij
  float* sty = rect + kQ;            // [kQ] exp(lc_i) dy_i . (c_i H_g)
  float* stx = sty + kQ;             // [kQ] exp(lc_Q - lc_j) x_j . (b_j dH_{g+1})
  float* red = stx + kQ;             // [8] per-warp partial sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int G = (L + kQ - 1) / kQ;
  const long long xrow = (long long)H * P;
  const long long xoff = (long long)b * L * xrow + (long long)h * P;
  const float* lb = loga + (long long)b * L * H + h;
  float* dlb = dloga + (long long)b * L * H + h;
  const float* bb = bm + (long long)b * L * N;
  const float* cb = cm + (long long)b * L * N;
  float* st = states + (long long)bh * G * N * P;
  float* dbp = db_part + (long long)bh * L * N;
  float* dcp = dc_part + (long long)bh * L * N;

  // A thread's cells: of a [kQ, *] tile rows i0 .. i0 + 3 and columns
  // tj + 16 q; of the [N, P] state rows ti + 16 r and columns tj + 16 q.
  const int ti = tid / 16, tj = tid % 16, i0 = 4 * ti;

  // 1. forward: the state entering each chunk, into the scratch
  float hr[QN][QP];
#pragma unroll
  for (int r = 0; r < QN; ++r)
#pragma unroll
    for (int q = 0; q < QP; ++q) hr[r][q] = 0.0f;
  for (int g = 0; g < G; ++g) {
    const int c0 = g * kQ, rows = min(kQ, L - c0);
#pragma unroll
    for (int r = 0; r < QN; ++r)
#pragma unroll
      for (int q = 0; q < QP; ++q) st[((long long)g * N + ti + 16 * r) * P + tj + 16 * q] = hr[r][q];
    __syncthreads();                   // the last chunk's readers are done
    load_chunk(xs, XS, x + xoff + c0 * xrow, xrow, rows, P);
    load_chunk(bs, BS, bb + (long long)c0 * N, N, rows, N);
    if (warp == 0) chunk_decays(lb + (long long)c0 * H, H, rows, lc, el, we);
    __syncthreads();
    const float eq = el[kQ - 1];
    float acc[QN][QP] = {};
    for (int j = 0; j < rows; ++j) {
      float xv[QP];
#pragma unroll
      for (int q = 0; q < QP; ++q) xv[q] = xs[j * XS + tj + 16 * q];
#pragma unroll
      for (int r = 0; r < QN; ++r) {
        const float wb = we[j] * bs[j * BS + ti + 16 * r];
#pragma unroll
        for (int q = 0; q < QP; ++q) acc[r][q] += wb * xv[q];
      }
    }
#pragma unroll
    for (int r = 0; r < QN; ++r)
#pragma unroll
      for (int q = 0; q < QP; ++q) hr[r][q] = eq * hr[r][q] + acc[r][q];
  }

  // 2. reverse: the gradients, dH_{g+1} in registers
  float dh[QN][QP];
#pragma unroll
  for (int r = 0; r < QN; ++r)
#pragma unroll
    for (int q = 0; q < QP; ++q) dh[r][q] = 0.0f;
  for (int g = G - 1; g >= 0; --g) {
    const int c0 = g * kQ, rows = min(kQ, L - c0);
    __syncthreads();                   // the last chunk's readers are done
    load_chunk(xs, XS, x + xoff + c0 * xrow, xrow, rows, P);
    load_chunk(dys, XS, dy + xoff + c0 * xrow, xrow, rows, P);
    load_chunk(bs, BS, bb + (long long)c0 * N, N, rows, N);
    load_chunk(cs, BS, cb + (long long)c0 * N, N, rows, N);
#pragma unroll
    for (int r = 0; r < QN; ++r)
#pragma unroll
      for (int q = 0; q < QP; ++q) {
        const int n = ti + 16 * r, p = tj + 16 * q;
        hs[n * HS + p] = st[((long long)g * N + n) * P + p];   // this thread's own writes of step 1
        dhs[n * HS + p] = dh[r][q];
      }
    if (warp == 0) chunk_decays(lb + (long long)c0 * H, H, rows, lc, el, we);
    __syncthreads();

    // (a) the masked scores S_ij D_ij, their gradients dS_ij and A_ij, j = tj + 16 c
    {
      float s[4][4] = {}, gm[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(i0 + r) * BS + n];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = bs[(tj + 16 * k) * BS + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) s[r][k] += cv[r] * bv[k];
      }
      for (int p = 0; p < P; ++p) {
        float dv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) dv[r] = dys[(i0 + r) * XS + p];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = xs[(tj + 16 * k) * XS + p];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) gm[r][k] += dv[r] * xv[k];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + r, j = tj + 16 * k;
          float a = 0.0f, d = 0.0f;
          if (j <= i) {
            const float e = expf(lc[i] - lc[j]);
            a = s[r][k] * e;
            d = gm[r][k] * e;
          }
          sd[i * SS + j] = a;
          ds[i * SS + j] = d;
          aa[i * SS + j] = a * gm[r][k];
        }
    }
    __syncthreads();

    // (b) dx on rows i0 .. i0 + 3, columns tj + 16 q; the state terms of d log a
    {
      float ys[4][QP] = {}, xa[4][QP] = {}, xst[4][QP] = {};
      for (int i = i0; i < kQ; ++i) {                // dx_j = sum_{i >= j} S_ij D_ij dy_i
        float dv[QP];
#pragma unroll
        for (int q = 0; q < QP; ++q) dv[q] = dys[i * XS + tj + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = sd[i * SS + i0 + r];
#pragma unroll
          for (int q = 0; q < QP; ++q) xa[r][q] += a * dv[q];
        }
      }
      for (int n = 0; n < N; ++n) {                  // c_i H_g and b_j dH_{g+1}
        float hv[QP], dv[QP];
#pragma unroll
        for (int q = 0; q < QP; ++q) {
          hv[q] = hs[n * HS + tj + 16 * q];
          dv[q] = dhs[n * HS + tj + 16 * q];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cv = cs[(i0 + r) * BS + n], bv = bs[(i0 + r) * BS + n];
#pragma unroll
          for (int q = 0; q < QP; ++q) {
            ys[r][q] += cv * hv[q];
            xst[r][q] += bv * dv[q];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        float py = 0.0f, px = 0.0f;
#pragma unroll
        for (int q = 0; q < QP; ++q) {
          const int p = tj + 16 * q;
          const float g = xa[r][q] + we[i] * xst[r][q];
          py += dys[i * XS + p] * ys[r][q];
          px += xs[i * XS + p] * xst[r][q];
          if (i < rows) dx[xoff + (c0 + i) * xrow + p] = g;
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {            // over the row's 16 lanes
          py += __shfl_xor_sync(kFull, py, o);
          px += __shfl_xor_sync(kFull, px, o);
        }
        if (tj == 0) {
          sty[i] = el[i] * py;
          stx[i] = we[i] * px;
        }
      }
    }

    // (c) db and dc partials on rows i0 .. i0 + 3, columns n = tj + 16 m
    {
      float da[4][QN] = {}, dst_[4][QN] = {};
      for (int i = i0; i < kQ; ++i) {                // sum_{i >= j} dS_ij c_i
        float cv[QN];
#pragma unroll
        for (int m = 0; m < QN; ++m) cv[m] = cs[i * BS + tj + 16 * m];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float d = ds[i * SS + i0 + r];
#pragma unroll
          for (int m = 0; m < QN; ++m) da[r][m] += d * cv[m];
        }
      }
      for (int p = 0; p < P; ++p) {                  // dH_{g+1} x_j
        float xv[4], dv[QN];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = xs[(i0 + r) * XS + p];
#pragma unroll
        for (int m = 0; m < QN; ++m) dv[m] = dhs[(tj + 16 * m) * HS + p];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int m = 0; m < QN; ++m) dst_[r][m] += dv[m] * xv[r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = i0 + r;
        if (j < rows)
#pragma unroll
          for (int m = 0; m < QN; ++m)
            dbp[(long long)(c0 + j) * N + tj + 16 * m] = da[r][m] + we[j] * dst_[r][m];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int m = 0; m < QN; ++m) da[r][m] = dst_[r][m] = 0.0f;
      for (int j = 0; j <= i0 + 3; ++j) {            // sum_{j <= i} dS_ij b_j
        float bv[QN];
#pragma unroll
        for (int m = 0; m < QN; ++m) bv[m] = bs[j * BS + tj + 16 * m];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float d = ds[(i0 + r) * SS + j];
#pragma unroll
          for (int m = 0; m < QN; ++m) da[r][m] += d * bv[m];
        }
      }
      for (int p = 0; p < P; ++p) {                  // H_g dy_i
        float dv[4], hv[QN];
#pragma unroll
        for (int r = 0; r < 4; ++r) dv[r] = dys[(i0 + r) * XS + p];
#pragma unroll
        for (int m = 0; m < QN; ++m) hv[m] = hs[(tj + 16 * m) * HS + p];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int m = 0; m < QN; ++m) dst_[r][m] += hv[m] * dv[r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (i < rows)
#pragma unroll
          for (int m = 0; m < QN; ++m)
            dcp[(long long)(c0 + i) * N + tj + 16 * m] = da[r][m] + el[i] * dst_[r][m];
      }
    }
    __syncthreads();                   // A, the state terms are complete; every read of dhs is done

    // (d) d log a. The carry exp(lc_Q) <H_g, dH_{g+1}> from every thread's
    // state cells; A's row prefix sums in place (thread i owns row i), then
    // the sums down its columns (thread t owns column t)
    {
      float part = 0.0f;
#pragma unroll
      for (int r = 0; r < QN; ++r)
#pragma unroll
        for (int q = 0; q < QP; ++q) part += hs[(ti + 16 * r) * HS + tj + 16 * q] * dh[r][q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
      if (lane == 0) red[warp] = part;
      if (tid < kQ) {
        float pre = 0.0f;
        for (int t = 0; t <= tid; ++t) {
          const float a = aa[tid * SS + t];
          aa[tid * SS + t] = pre;
          pre += a;
        }
      }
      __syncthreads();
      if (tid < kQ) {
        float sum = 0.0f;
        for (int i = tid; i < kQ; ++i) sum += aa[i * SS + tid];
        rect[tid] = sum;
      }
      __syncthreads();
      if (warp == 0) {
        float carry = 0.0f;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) carry += red[w];
        const int t = 2 * lane;
        dloga_steps(rect[t], rect[t + 1], sty[t], sty[t + 1], stx[t], stx[t + 1], carry * el[kQ - 1],
                    dlb + (long long)c0 * H, H, rows);
      }
    }

    // (e) dH_g = exp(lc_Q) dH_{g+1} + sum_i exp(lc_i) c_i dy_i^T
    {
      const float eq = el[kQ - 1];
      float acc[QN][QP] = {};
      for (int i = 0; i < rows; ++i) {
        float dv[QP];
#pragma unroll
        for (int q = 0; q < QP; ++q) dv[q] = dys[i * XS + tj + 16 * q];
#pragma unroll
        for (int r = 0; r < QN; ++r) {
          const float ec = el[i] * cs[i * BS + ti + 16 * r];
#pragma unroll
          for (int q = 0; q < QP; ++q) acc[r][q] += ec * dv[q];
        }
      }
#pragma unroll
      for (int r = 0; r < QN; ++r)
#pragma unroll
        for (int q = 0; q < QP; ++q) dh[r][q] = eq * dh[r][q] + acc[r][q];
    }
  }
}

// db, dc = the per-head partials summed over h = 0 .. H-1 in order
// (blockIdx.y: 0 for db, 1 for dc)
__global__ void ssd_bwd_head_sum_kernel(const float* __restrict__ db_part,
                                        const float* __restrict__ dc_part, float* __restrict__ db,
                                        float* __restrict__ dc, int H, long long LN, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / LN, r = idx - b * LN;
  const float* part = (blockIdx.y == 0 ? db_part : dc_part) + b * H * LN + r;
  float s = 0.0f;
  for (int h = 0; h < H; ++h) s += part[h * LN];
  (blockIdx.y == 0 ? db : dc)[idx] = s;
}

template <int P, int N>
int launch_bwd(const void* x, const void* loga, const void* b, const void* c, const void* dy, void* dx,
               void* dloga, void* db, void* dc, void* states, void* db_part, void* dc_part, int B, int L,
               int H, cudaStream_t s) {
  const size_t smem = BwdShape<P, N>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_kernel<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_kernel<P, N><<<B * H, kThreads, smem, s>>>(
      (const float*)x, (const float*)loga, (const float*)b, (const float*)c, (const float*)dy, (float*)dx,
      (float*)dloga,
      (float*)states, (float*)db_part, (float*)dc_part, L, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * L * N;
  ssd_bwd_head_sum_kernel<<<dim3((unsigned)((total + 255) / 256), 2), 256, 0, s>>>(
      (const float*)db_part, (const float*)dc_part, (float*)db, (float*)dc, H, (long long)L * N, total);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 route: two passes on the tensor cores (wgmma + TMA)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;        // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int P, int N>
struct BwdTcShape {
  static constexpr int SWP = 2 * P;                  // x / dy row bytes; a state plane's row bytes
  static constexpr int SWN = N >= 64 ? 128 : 2 * N;  // b / c row-chunk bytes: 32, 64 or 128
  static constexpr int CWN = SWN / 2;                // state columns per chunk: db / dc's n-tile
  static constexpr int NC = N / CWN;                 // chunks per b / c row
  static constexpr int XT = kQ * SWP;                // bytes of an x / dy / dx tile
  static constexpr int BT = NC * kQ * SWN;           // of a b / c tile
  static constexpr int HT = N * SWP;                 // of one bf16 plane [N][P] of a state
  static constexpr int ST = 2 * HT;                  // of a stored state: its hi and lo planes
  static constexpr int RING = 2 * XT + 2 * ST;       // a chunk-pass stage: x, dy, H_g, dH_{g+1}
  static constexpr int XCH = 2 * kQ + 4 * kQ + 8;    // exchange floats: stx, sty, rect [4][64], carry [8]
  // state pass: a two-stage ring of (x or dy, b or c), the staged state, decays, 2 barriers
  static constexpr size_t SMEM_STATE = 1024 + 2 * (XT + BT) + ST + 2 * 3 * kQ * 4 + 2 * 8;
  // chunk pass: b, c; a two-stage ring; U; two dx tiles; decays; exchange; 3 barriers
  static constexpr size_t SMEM_CHUNK = 1024 + 2 * BT + 2 * RING + kQ * 128 + 2 * XT + 2 * 3 * kQ * 4 +
                                       2 * XCH * 4 + 3 * 8;
};

// Pass 1: the state entering each chunk (blockIdx.y = 0, the chunks in
// order: H_{g+1}^T = exp(lc_Q) H_g^T + (w x)^T b, w_j = exp(lc_Q - lc_j))
// or its gradient leaving each chunk (blockIdx.y = 1, in reverse:
// dH_g^T = exp(lc_Q) dH_{g+1}^T + (el dy)^T c, el_i = exp(lc_i)), one
// warpgroup per (batch, head) and direction, as ssd_tc_kernel's state
// update: the state transposed [P rows, N] in registers, (w x)^T and
// (el dy)^T as register-A fragments of hi + lo parts (x^T, dy^T by
// ldmatrix.trans), b and c MN-major. Each state (H_g for chunk g, dH_{g+1}
// for chunk g) is staged by stmatrix.trans as bf16 hi and lo planes [N][P],
// swizzled as the chunk pass reads them, and leaves by one bulk copy into
// the scratch tile ((dir B + b) H + h) G + g.
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_bwd_state_tc_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tc,
                        const float* __restrict__ loga, uint8_t* __restrict__ states, int B, int L, int H) {
  using Sh = BwdTcShape<P, N>;
  constexpr int SWP = Sh::SWP, SWN = Sh::SWN, CWN = Sh::CWN, NC = Sh::NC;
  constexpr int XT = Sh::XT, BT = Sh::BT, HT = Sh::HT, ST = Sh::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* vs = smem;                        // [2 stages][64 steps][SWP]: x, or dy in reverse
  uint8_t* ks = vs + 2 * XT;                 // [2 stages][NC][64 steps][SWN]: b, or c
  uint8_t* hs = ks + 2 * BT;                 // [hi, lo][N][SWP]: the state, for its bulk copy
  float* decays = reinterpret_cast<float*>(hs + ST);          // [2][lc, exp(lc_i), exp(lc_Q - lc_j)][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(decays + 2 * 3 * kQ);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rev = blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int G = (L + kQ - 1) / kQ;
  const float* lb = loga + (long long)b * L * H + h;
  const CUtensorMap* tv = rev ? &tdy : &tx;
  const CUtensorMap* tk = rev ? &tc : &tb;
  uint8_t* out = states + (((long long)rev * B + b) * H + h) * G * ST;
  const int cq = 2 * (lane % 4);

  auto chunk_of = [&](int k) { return rev ? G - 1 - k : k; };
  auto load = [&](int stage, int k) {
    const int g = chunk_of(k);
    mbar_expect_tx(&bars[stage], XT + BT);
    tma_load(vs + stage * XT, tv, &bars[stage], h * P, g * kQ, b);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(ks + stage * BT + c * kQ * SWN, tk, &bars[stage], c * CWN, g * kQ, b);
  };
  auto decays_of = [&](int k) {              // one warp
    const int c0 = chunk_of(k) * kQ;
    float* d = decays + (k & 1) * 3 * kQ;
    chunk_decays(lb + (long long)c0 * H, H, min(kQ, L - c0), d, d + kQ, d + 2 * kQ);
  };

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load(0, 0);
    if (G > 1) load(1, 1);
  }
  if (warp == 0) decays_of(0);

  float st[NC][CWN / 2];                     // the state, transposed [P (64 rows), N]
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < CWN / 2; ++i) st[c][i] = 0.0f;

  for (int k = 0; k < G; ++k) {
    const int stage = k & 1;
    const float* dk = decays + stage * 3 * kQ;
    const float* wv = rev ? dk + kQ : dk + 2 * kQ;       // el_i, or w_j
    // chunk k's decays are in place; chunk k - 1's stage and the staged
    // state's buffer are free in every warp
    __syncthreads();
    if (tid == 0 && k >= 1 && k + 1 < G) load(stage ^ 1, k + 1);
    // the state as bf16 hi and lo planes [N][P]: stmatrix.trans block m of
    // a step holds rows p + 8 (m % 2), columns n + 8 (m / 2); the rows p >= P
    // of a P = 32 state are not stored
    if (P == 64 || 16 * warp < P) {
      const int m = lane / 8;
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
          const int n = c * CWN + 8 * (j + m / 2) + lane % 8;
          const uint32_t o = swz<SWP>(n * SWP + 2 * (16 * warp + 8 * (m % 2)));
          stsm_x4_trans(hs + o, hi);
          stsm_x4_trans(hs + HT + o, lo);
        }
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      bulk_store(out + (long long)chunk_of(k) * ST, hs, ST);
      bulk_commit();
    }
    mbar_wait(&bars[stage], (k >> 1) & 1);
    const uint8_t* vst = vs + stage * XT;
    const uint8_t* kst = ks + stage * BT;

    const float decay = dk[2 * kQ - 1];      // exp(lc_Q): rows past L add 0 to lc
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < CWN / 2; ++i) st[c][i] *= decay;
    // (wv v)^T [P rows, 64 steps] as A fragments of two bf16 parts, v^T read
    // by ldmatrix.trans (lanes 8m .. 8m + 7: rows of 8 x 8 block m, p + 8 (m
    // % 2), t + 8 (m / 2)); the rows p >= P of a P = 32 state are 0, by a
    // select: registers that feed a wgmma, written on a divergent path,
    // make ptxas serialise the kernel's wgmmas
    uint32_t a_hi[4][4], a_lo[4][4];
    {
      const bool on = P == 64 || 16 * warp < P;
      const int m = lane / 8;
      const uint32_t col = 2 * (16 * (on ? warp : 0) + 8 * (m % 2));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t vr[4];
        ldsm_x4_trans(vr, vst + swz<SWP>((16 * kk + 8 * (m / 2) + lane % 8) * SWP + col));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 w = *reinterpret_cast<const float2*>(wv + 16 * kk + 8 * (q / 2) + cq);
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&vr[q]);
          uint32_t hi, lo;
          split_bf16(w.x * __low2float(v), w.y * __high2float(v), hi, lo);
          a_hi[kk][q] = on ? hi : 0u;
          a_lo[kk][q] = on ? lo : 0u;
        }
      }
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t dk_ = smem_desc<SWN>(smem_u32(kst + c * kQ * SWN) + kk * 16 * SWN);
        wgmma_rs(st[c], a_hi[kk], dk_);
        wgmma_rs(st[c], a_lo[kk], dk_);
      }
    wg_commit();
    if (warp == 0 && k + 1 < G) decays_of(k + 1);
    wg_wait<0>();
    reg_keep(a_hi);
    reg_keep(a_lo);
#pragma unroll
    for (int c = 0; c < NC; ++c) reg_fence(st[c]);
    if (tid == 0) bulk_wait_read();          // the staged state has left shared memory
  }
  if (tid == 0) bulk_wait();
}

// x (or dy) fragments of register-A layout for the 64 x P tile at `tile`
// (rows of SWP bytes, swizzled), k16 step kk, this warp's 16 rows: r[q] holds
// rows r0 + 8 (q % 2), columns 16 kk + 8 (q / 2) + 2 (lane % 4) + {0, 1}.
template <int SWP>
__device__ __forceinline__ void load_frag(uint32_t (&r)[4], const uint8_t* tile, int wl, int lane, int kk) {
  const int m = lane / 8;
  ldsm_x4(r, tile + swz<SWP>((16 * wl + 8 * (m % 2) + lane % 8) * SWP + 2 * (16 * kk + 8 * (m / 2))));
}

// Pass 2: per (batch, chunk g) block, two warpgroups walk the heads in order.
// Rows of every accumulator are the chunk's steps; "^T" tiles have rows j
// (the source step) and columns i (the target step), so (S D)^T and A^T
// are register-A fragments of the products over i.
//   both:  S^T = b c^T once (K-major b, c), then per head G^T = x dy^T and
//          the decays D_ji = exp(lc_i - lc_j), j <= i
//   WG 0:  T = b dH (dH MN-major, hi + lo), db_st += (we x) dH^T (we x
//          and dH K-major as hi + lo: hi hi, hi lo, then lo hi; summed
//          over the heads in the accumulator);
//          stx_j = we_j x_j . T_j; dx = we T + (S D)^T dy (hi + lo, dy
//          MN-major); dS^T = G^T D summed over the heads in f32
//   WG 1:  C H (H MN-major, hi + lo), dc_st += (el dy) H^T (as db_st);
//          sty_i = el_i dy_i . (C H)_i; Q = A^T U (A = S D G, hi + lo; U[i][t]
//          = [i >= t] in shared memory), and the pair terms of d log a,
//          sum_{j < t} Q[j][t], by column sums
//   after the heads: db = db_st + (sum dS)^T c (WG 0), dc = dc_st +
//   (sum dS) b (WG 1), both hi + lo, written once.
// The carry exp(lc_Q) <H_g, dH_{g+1}> is summed by every thread from the
// staged planes; warp 4 adds d log a's terms up a head behind. x, dy, H and
// dH come in by TMA and bulk copies into a two-stage ring, a head ahead;
// dx leaves by a TMA store from one of two staging tiles.
template <int P, int N>
__global__ void __launch_bounds__(2 * kTcThreads, 1)
ssd_bwd_chunk_tc_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                        const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                        const __grid_constant__ CUtensorMap tdx, const float* __restrict__ loga,
                        const uint8_t* __restrict__ states, float* __restrict__ dloga,
                        __nv_bfloat16* __restrict__ db, __nv_bfloat16* __restrict__ dc, int B, int L,
                        int H) {
  using Sh = BwdTcShape<P, N>;
  constexpr int SWP = Sh::SWP, SWN = Sh::SWN, CWN = Sh::CWN, NC = Sh::NC;
  constexpr int XT = Sh::XT, BT = Sh::BT, HT = Sh::HT, ST = Sh::ST, RING = Sh::RING, XCH = Sh::XCH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* bs = smem;                        // [NC][64 steps][SWN]: b
  uint8_t* cs = bs + BT;                     // c
  uint8_t* ring = cs + BT;                   // [2 stages][x, dy, H hi, H lo, dH hi, dH lo]
  uint8_t* us = ring + 2 * RING;             // [64 i][64 t] bf16, 128-byte swizzle: U[i][t] = [i >= t]
  uint8_t* dxs = us + kQ * 128;              // [2][64 steps][SWP]: dx of a head, for its TMA store
  float* decays = reinterpret_cast<float*>(dxs + 2 * XT);    // [2][lc, exp(lc_i), exp(lc_Q - lc_j)][64]
  float* xch = decays + 2 * 3 * kQ;          // [2][stx 64, sty 64, rect 4 x 64, carry 8]
  uint64_t* bars = reinterpret_cast<uint64_t*>(xch + 2 * XCH);   // ring stages 0, 1; b and c

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = __shfl_sync(kFull, tid / kTcThreads, 0);
  const int wl = warp % 4;
  const int r0 = 16 * wl + lane / 4;         // this thread's accumulator rows r0, r0 + 8
  const int cq = 2 * (lane % 4);             // and columns 8 j + cq + {0, 1}
  const int G = (L + kQ - 1) / kQ;
  const int b = blockIdx.x / G, g = blockIdx.x % G, c0 = g * kQ, rows = min(kQ, L - c0);
  const float* lb = loga + ((long long)b * L + c0) * H;
  const uint8_t* hg = states + ((long long)b * H * G + g) * ST;          // H_g of head 0
  const uint8_t* dhg = states + (((long long)B + b) * H * G + g) * ST;   // dH_{g+1} of head 0

  auto load_head = [&](int s, int hh) {
    uint8_t* xs = ring + s * RING;
    mbar_expect_tx(&bars[s], 2 * XT + 2 * ST);
    tma_load(xs, &tx, &bars[s], hh * P, c0, b);
    tma_load(xs + XT, &tdy, &bars[s], hh * P, c0, b);
    bulk_load(xs + 2 * XT, hg + (long long)hh * G * ST, ST, &bars[s]);
    bulk_load(xs + 2 * XT + ST, dhg + (long long)hh * G * ST, ST, &bars[s]);
  };
  auto decays_of = [&](int hh) {             // one warp
    float* d = decays + (hh & 1) * 3 * kQ;
    chunk_decays(lb + hh, H, rows, d, d + kQ, d + 2 * kQ);
  };
  auto assemble = [&](int hh) {              // warp 4: d log a of head hh
    const float* xc = xch + (hh & 1) * XCH;
    float carry = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) carry += xc[6 * kQ + w];
    const int t = 2 * lane;
    float rc[2] = {0.0f, 0.0f};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      rc[0] += xc[2 * kQ + w * kQ + t];
      rc[1] += xc[2 * kQ + w * kQ + t + 1];
    }
    dloga_steps(rc[0], rc[1], xc[kQ + t], xc[kQ + t + 1], xc[t], xc[t + 1],
                carry * decays[(hh & 1) * 3 * kQ + 2 * kQ - 1],
                dloga + ((long long)b * L + c0) * H + hh, H, rows);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    mbar_init_fence();
  }
  for (int e = tid; e < kQ * 8; e += 2 * kTcThreads) {     // U: 16-byte units of 8 columns t
    const int i = e / 8, t0 = 8 * (e % 8);
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = (i >= t0 + 2 * q ? 0x3F80u : 0u) | (i >= t0 + 2 * q + 1 ? 0x3F800000u : 0u);
    *reinterpret_cast<uint4*>(us + swz<128>(i * 128 + 16 * (e % 8))) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[2], 2 * BT);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(bs + c * kQ * SWN, &tb, &bars[2], c * CWN, c0, b);
      tma_load(cs + c * kQ * SWN, &tc, &bars[2], c * CWN, c0, b);
    }
    load_head(0, 0);
    if (H > 1) load_head(1, 1);
  }
  if (warp == 4) decays_of(0);
  __syncthreads();                           // head 0's decays are in place

  float acc[NC][CWN / 2];                    // WG 0: db's [64 j, N]; WG 1: dc's [64 i, N]
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < CWN / 2; ++i) acc[c][i] = 0.0f;
  float dsum[32];                            // WG 0: sum over the heads of dS^T
#pragma unroll
  for (int i = 0; i < 32; ++i) dsum[i] = 0.0f;

  // S^T = b c^T, once for all heads (c, b shared over them), in both warpgroups
  float sT[32];
  mbar_wait(&bars[2], 0);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const int c = kk * 16 / CWN, off = (kk * 16 % CWN) * 2;
    wgmma_ss(sT, smem_desc<SWN>(smem_u32(bs + c * kQ * SWN) + off),
             smem_desc<SWN>(smem_u32(cs + c * kQ * SWN) + off), kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  reg_fence(sT);

  for (int hh = 0; hh < H; ++hh) {
    const int s = hh & 1;
    const float* lcs = decays + s * 3 * kQ;
    const float* ecs = lcs + kQ;
    const float* wes = ecs + kQ;
    float* xc = xch + s * XCH;
    const uint8_t* xst = ring + s * RING;
    const uint8_t* dyst = xst + XT;
    const uint8_t* hst = dyst + XT;
    const uint8_t* dhst = hst + ST;
    mbar_wait(&bars[s], (hh >> 1) & 1);
    const float sc[2] = {wg == 0 ? wes[r0] : ecs[r0], wg == 0 ? wes[r0 + 8] : ecs[r0 + 8]};
    const float lj[2] = {lcs[r0], lcs[r0 + 8]};

    // group 1: G^T = x dy^T; WG 0: T = b dH, db_st += hi(we x) (dH_hi + dH_lo)^T;
    // WG 1: C H, dc_st += hi(el dy) (H_hi + H_lo)^T
    float gt[32], tp[P / 2];
    uint32_t av[P / 16][4];                  // hi, later lo, of we_j x_j (WG 0) or el_i dy_i (WG 1)
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      uint32_t r[4];
      load_frag<SWP>(r, wg == 0 ? xst : dyst, wl, lane, kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r[q]);
        av[kk][q] = bits(__floats2bfloat162_rn(sc[q % 2] * __low2float(v), sc[q % 2] * __high2float(v)));
      }
    }
    const uint8_t* sk = wg == 0 ? bs : cs;   // the state product's A: b (WG 0) or c (WG 1)
    const uint8_t* sv = wg == 0 ? dhst : hst;   // its B: dH (WG 0) or H (WG 1)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      wgmma_ss(gt, smem_desc<SWP>(smem_u32(xst) + 32 * kk), smem_desc<SWP>(smem_u32(dyst) + 32 * kk), kk > 0);
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const int c = kk * 16 / CWN, off = (kk * 16 % CWN) * 2;
        wgmma_ss<1>(tp, smem_desc<SWN>(smem_u32(sk + c * kQ * SWN) + off),
                    smem_desc<SWP>(smem_u32(sv + part * HT) + kk * 16 * SWP), part + kk > 0);
      }
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int part = 0; part < 2; ++part)
          wgmma_rs<0>(acc[c], av[kk], smem_desc<SWP>(smem_u32(sv + part * HT + c * CWN * SWP) + 32 * kk));
    wg_commit();

    // while it runs: warp 4 adds up d log a of the last head and makes the
    // next head's decays; every thread sums its share of <H_g, dH_{g+1}>
    if (warp == 4) {
      if (hh > 0) assemble(hh - 1);
      if (hh + 1 < H) decays_of(hh + 1);
    }
    {
      float cp = 0.0f;
      for (int u = tid; u < N * P / 8; u += 2 * kTcThreads) {
        const uint4 a0 = reinterpret_cast<const uint4*>(hst)[u];
        const uint4 a1 = reinterpret_cast<const uint4*>(hst + HT)[u];
        const uint4 d0 = reinterpret_cast<const uint4*>(dhst)[u];
        const uint4 d1 = reinterpret_cast<const uint4*>(dhst + HT)[u];
        const uint32_t ah[4] = {a0.x, a0.y, a0.z, a0.w}, al[4] = {a1.x, a1.y, a1.z, a1.w};
        const uint32_t dh[4] = {d0.x, d0.y, d0.z, d0.w}, dl[4] = {d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 hh2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ah[q]));
          const float2 hl2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&al[q]));
          const float2 dh2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dh[q]));
          const float2 dl2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dl[q]));
          cp += (hh2.x + hl2.x) * (dh2.x + dl2.x) + (hh2.y + hl2.y) * (dh2.y + dl2.y);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) cp += __shfl_xor_sync(kFull, cp, o);
      if (lane == 0) xc[6 * kQ + warp] = cp;
    }
    wg_wait<0>();
    reg_keep(av);
    reg_fence(gt);
    reg_fence(tp);
#pragma unroll
    for (int c = 0; c < NC; ++c) reg_fence(acc[c]);

    // the state term of d log a: stx_j = we_j x_j . T_j (WG 0) or
    // sty_i = el_i dy_i . (C H)_i (WG 1), x or dy read at the accumulator's places
    {
      float pr[2] = {0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t r[4];
        load_frag<SWP>(r, wg == 0 ? xst : dyst, wl, lane, kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[q]));
          const int i = 4 * (2 * kk + q / 2) + 2 * (q % 2);
          pr[q % 2] += v.x * tp[i] + v.y * tp[i + 1];
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        pr[hf] += __shfl_xor_sync(kFull, pr[hf], 1);
        pr[hf] += __shfl_xor_sync(kFull, pr[hf], 2);
        if (lane % 4 == 0) xc[wg * kQ + r0 + 8 * hf] = sc[hf] * pr[hf];
      }
    }

    // (S D)^T (WG 0) or A^T = (S D G)^T (WG 1) as hi + lo fragments over i;
    // columns 8 j .. 8 j + 7 against this warp's rows 16 wl .. 16 wl + 15:
    // wholly visible (i >= j), wholly masked (no exp at all), or the diagonal
    uint32_t f_hi[4][4], f_lo[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool none = 8 * j + 7 < 16 * wl, all = 8 * j >= 16 * wl + 15;
      const float2 li = *reinterpret_cast<const float2*>(lcs + 8 * j + cq);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float v[2] = {0.0f, 0.0f};
        if (!none) {
          const int row = r0 + 8 * hf;
          const float d[2] = {li.x - lj[hf], li.y - lj[hf]};
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (all || 8 * j + cq + e >= row) {
              const int i = 4 * j + 2 * hf + e;
              const float dd = exp2f(d[e] * kLog2e);
              const float sd = sT[i] * dd;
              if (wg == 0) {
                v[e] = sd;
                dsum[i] += gt[i] * dd;
              } else {
                v[e] = sd * gt[i];
              }
            }
        }
        split_bf16(v[0], v[1], f_hi[j / 2][2 * (j % 2) + hf], f_lo[j / 2][2 * (j % 2) + hf]);
      }
    }

    // the state term's third product, in the group below: db_st += lo(we x)
    // dH_hi^T (WG 0), dc_st += lo(el dy) H_hi^T (WG 1)
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      uint32_t r[4];
      load_frag<SWP>(r, wg == 0 ? xst : dyst, wl, lane, kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r[q]);
        uint32_t hi;
        split_bf16(sc[q % 2] * __low2float(v), sc[q % 2] * __high2float(v), hi, av[kk][q]);
      }
    }
    auto state_lo = [&] {
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wgmma_rs<0>(acc[c], av[kk], smem_desc<SWP>(smem_u32(sv + c * CWN * SWP) + 32 * kk));
    };

    if (wg == 0) {
      // dx = we T + (S D)^T dy (dy MN-major), into dxs[s] in bf16
#pragma unroll
      for (int i = 0; i < P / 2; ++i) tp[i] *= sc[(i / 2) % 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dd = smem_desc<SWP>(smem_u32(dyst) + kk * 16 * SWP);
        wgmma_rs(tp, f_hi[kk], dd);
        wgmma_rs(tp, f_lo[kk], dd);
      }
      state_lo();
      wg_commit();
      wg_wait<0>();
      reg_keep(f_hi);
      reg_keep(f_lo);
      reg_keep(av);
      reg_fence(tp);
      const int m = lane / 8, mrow = r0 - lane / 4 + 8 * (m % 2) + lane % 8;
#pragma unroll
      for (int j = 0; j < P / 8; j += 2) {
        uint32_t yv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * (j + q / 2) + 2 * (q % 2);
          yv[q] = bits(__floats2bfloat162_rn(tp[i], tp[i + 1]));
        }
        stsm_x4(dxs + s * XT + swz<SWP>(mrow * SWP + 16 * (j + m / 2)), yv);
      }
      fence_proxy_async();
    } else {
      // Q = A^T U; the pair terms sum_{j < t} Q[j][t], this warp's rows
      float qa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) qa[i] = 0.0f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t du = smem_desc<128>(smem_u32(us) + kk * 16 * 128);
        wgmma_rs(qa, f_hi[kk], du);
        wgmma_rs(qa, f_lo[kk], du);
      }
      state_lo();
      wg_commit();
      wg_wait<0>();
      reg_keep(f_hi);
      reg_keep(f_lo);
      reg_keep(av);
      reg_fence(qa);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = 8 * j + cq + e;
          float v = (r0 < t ? qa[4 * j + e] : 0.0f) + (r0 + 8 < t ? qa[4 * j + 2 + e] : 0.0f);
          v += __shfl_xor_sync(kFull, v, 4);
          v += __shfl_xor_sync(kFull, v, 8);
          v += __shfl_xor_sync(kFull, v, 16);
          if (lane < 4) xc[2 * kQ + wl * kQ + t] = v;
        }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) reg_fence(acc[c]);
    if (tid == 0) bulk_wait_read();          // the last head's dx has left dxs[s ^ 1]
    __syncthreads();                         // head hh's reads of stage s are done; its terms are in xc
    if (tid == 0) {
      tma_store(&tdx, dxs + s * XT, hh * P, c0, b);
      bulk_commit();
      if (hh + 2 < H) load_head(s, hh + 2);
    }
  }
  if (warp == 4) assemble(H - 1);

  // db += (sum_h dS_h)^T c, dc += (sum_h dS_h) b, both hi + lo; sum dS^T
  // staged in f32 [64 j][65] in the free ring for WG 1's transposed reads
  float* dsx = reinterpret_cast<float*>(ring);
  if (wg == 0)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) dsx[(r0 + 8 * hf) * 65 + 8 * j + cq + e] = dsum[4 * j + 2 * hf + e];
  __syncthreads();
  uint32_t f_hi[4][4], f_lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + 8 * (q % 2), col = 16 * kk + 8 * (q / 2) + cq;
      float v0, v1;
      if (wg == 0) {                         // (sum dS)^T: rows j, columns i
        v0 = dsx[row * 65 + col];
        v1 = dsx[row * 65 + col + 1];
      } else {                               // sum dS: rows i, columns j
        v0 = dsx[col * 65 + row];
        v1 = dsx[(col + 1) * 65 + row];
      }
      split_bf16(v0, v1, f_hi[kk][q], f_lo[kk][q]);
    }
  const uint8_t* opnd = wg == 0 ? cs : bs;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t dd = smem_desc<SWN>(smem_u32(opnd + c * kQ * SWN) + kk * 16 * SWN);
      wgmma_rs(acc[c], f_hi[kk], dd);
      wgmma_rs(acc[c], f_lo[kk], dd);
    }
  wg_commit();
  wg_wait<0>();
  reg_keep(f_hi);
  reg_keep(f_lo);
  __nv_bfloat16* outp = (wg == 0 ? db : dc) + ((long long)b * L + c0) * N;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    reg_fence(acc[c]);
#pragma unroll
    for (int j = 0; j < CWN / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 8 * hf;
        if (row < rows)
          *reinterpret_cast<__nv_bfloat162*>(outp + (long long)row * N + c * CWN + 8 * j + cq) =
              __floats2bfloat162_rn(acc[c][4 * j + 2 * hf], acc[c][4 * j + 2 * hf + 1]);
      }
  }
  if (tid == 0) bulk_wait();
}

template <int P, int N>
int launch_bwd_tc(const void* x, const void* loga, const void* b, const void* c, const void* dy, void* dx,
                  void* dloga, void* db, void* dc, void* states, int B, int L, int H, cudaStream_t s) {
  using Sh = BwdTcShape<P, N>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tx, tdy, tdx, tb, tc;
  if (!make_map_bf16(&tx, encode, x, H * P, L, B, kQ, Sh::SWP) ||
      !make_map_bf16(&tdy, encode, dy, H * P, L, B, kQ, Sh::SWP) ||
      !make_map_bf16(&tdx, encode, dx, H * P, L, B, kQ, Sh::SWP) ||
      !make_map_bf16(&tb, encode, b, N, L, B, kQ, Sh::SWN) ||
      !make_map_bf16(&tc, encode, c, N, L, B, kQ, Sh::SWN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_state_tc_kernel<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM_STATE);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_tc_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Sh::SMEM_CHUNK);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_state_tc_kernel<P, N><<<dim3(B * H, 2), kTcThreads, Sh::SMEM_STATE, s>>>(
      tx, tb, tdy, tc, (const float*)loga, (uint8_t*)states, B, L, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int G = (L + kQ - 1) / kQ;
  ssd_bwd_chunk_tc_kernel<P, N><<<B * G, 2 * kTcThreads, Sh::SMEM_CHUNK, s>>>(
      tx, tdy, tb, tc, tdx, (const float*)loga, (const uint8_t*)states, (float*)dloga, (__nv_bfloat16*)db,
      (__nv_bfloat16*)dc, B, L, H);
  return (int)cudaGetLastError();
}

template <int P>
int launch_bwd_tc_n(const void* x, const void* loga, const void* b, const void* c, const void* dy, void* dx,
                    void* dloga, void* db, void* dc, void* st, int B, int L, int H, int N, cudaStream_t s) {
  switch (N) {
    case 16: return launch_bwd_tc<P, 16>(x, loga, b, c, dy, dx, dloga, db, dc, st, B, L, H, s);
    case 32: return launch_bwd_tc<P, 32>(x, loga, b, c, dy, dx, dloga, db, dc, st, B, L, H, s);
    case 64: return launch_bwd_tc<P, 64>(x, loga, b, c, dy, dx, dloga, db, dc, st, B, L, H, s);
    case 128: return launch_bwd_tc<P, 128>(x, loga, b, c, dy, dx, dloga, db, dc, st, B, L, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_bwd_f32(const void* x, const void* loga, const void* b, const void* c, const void* dy, void* dx,
                   void* dloga, void* db, void* dc, void* states, void* db_part, void* dc_part, int B, int L,
                   int H, int P, int N, cudaStream_t s) {
  using Launch = int (*)(const void*, const void*, const void*, const void*, const void*, void*, void*, void*,
                         void*, void*, void*, void*, int, int, int, cudaStream_t);
  Launch fn = nullptr;
  const int ns[4] = {16, 32, 64, 128};
  const Launch f32[2][4] = {{launch_bwd<32, 16>, launch_bwd<32, 32>, launch_bwd<32, 64>, launch_bwd<32, 128>},
                            {launch_bwd<64, 16>, launch_bwd<64, 32>, launch_bwd<64, 64>, launch_bwd<64, 128>}};
  for (int i = 0; i < 4; ++i)
    if (N == ns[i] && (P == 32 || P == 64)) fn = f32[P == 64][i];
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(x, loga, b, c, dy, dx, dloga, db, dc, states, db_part, dc_part, B, L, H, s);
}

}  // namespace

// x, dy, dx [B, L, H, P]; loga, dloga [B, L, H] f32; b, c, db, dc [B, L, N];
// P in {32, 64}, N in {16, 32, 64, 128}, any L >= 1.
// bf16 != 0: x, b, c, dy, dx, db, dc bf16, x, dy, dx, b, c 16-byte aligned
// (the tensor cores); `states` holds 2 B H ceil(L / 64) N P f32's bytes
// (the two passes' bf16 hi and lo planes); db_part, dc_part are not read.
// Else f32 (the CUDA cores): states [B, H, ceil(L / 64), N, P] f32, db_part
// and dc_part [B, H, L, N] f32.
extern "C" int lm_ssd_scan_bwd(const void* x, const void* loga, const void* b, const void* c,
                               const void* dy, void* dx, void* dloga, void* db, void* dc, void* states,
                               void* db_part, void* dc_part, int B, int L, int H, int P, int N, int bf16,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || L < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (!bf16) return launch_bwd_f32(x, loga, b, c, dy, dx, dloga, db, dc, states, db_part, dc_part, B, L, H, P, N, s);
  if (P == 32) return launch_bwd_tc_n<32>(x, loga, b, c, dy, dx, dloga, db, dc, states, B, L, H, N, s);
  if (P == 64) return launch_bwd_tc_n<64>(x, loga, b, c, dy, dx, dloga, db, dc, states, B, L, H, N, s);
  return (int)cudaErrorInvalidValue;
}
