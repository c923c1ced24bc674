// Backward of the Mamba-2 SSD chunked scan (csrc/ssd_scan.cu), from h = 0.
//
// No TPU kernel is replaced: the reference differentiates its chunked
// einsum form (repro/models/mamba.py: _ssd_chunked) with XLA. This kernel
// exists because training an ssm or hybrid layer on the card runs the
// forward scan as a kernel (kernels/ssd_scan/ops.py: SSDScanFn), and the
// port takes no step back to a plain version on the card: the plain
// chunked gradient holds [B, G, Q, Q, H] f32 tensors (0.8 GB each at
// mamba2-780m's training microbatch).
//
// It computes kernels/ssd_scan/ref.py: ssd_chunked_bwd. Per (batch, head),
// in chunks of kQ = 64 steps whatever chunk the forward walked (the
// chunked form is the same function for every chunk length), with lc the
// chunk-local cumulative log decay, D_ij = exp(lc_i - lc_j) for j <= i,
// H_g the state entering chunk g and dH its gradient:
//   dH_g  = sum_i exp(lc_i) c_i dy_i^T + exp(lc_Q) dH_{g+1}    (dH_G = 0)
//   dx_j  = sum_i (c_i . b_j) D_ij dy_i + exp(lc_Q - lc_j) dH_{g+1}^T b_j
//   dS_ij = D_ij (dy_i . x_j)
//   db_j  = sum_h [sum_i dS_ij c_i + exp(lc_Q - lc_j) dH_{g+1} x_j]
//   dc_i  = sum_h [sum_j dS_ij b_j + exp(lc_i) H_g dy_i]
//   dloga_t = sum_{j < t <= i} A_ij + sum_{i >= t} exp(lc_i) dy_i . (c_i H_g)
//             + sum_{j < t} exp(lc_Q - lc_j) x_j . (b_j dH_{g+1}) + exp(lc_Q) <H_g, dH_{g+1}>
// with A_ij = (c_i . b_j) dS_ij, t, i, j in chunk g: each term goes to the
// log decays its decay factor spans.
// exp is taken only where j <= i: for j > i the exponent is positive and
// would overflow, and a masked 0 * inf is NaN.
//
// Layout is the model's: x, dy, dx [B, L, H, P]; log a, d log a [B, L, H]
// f32; b, c, db, dc [B, L, N] shared over the heads. x, b, c, dy and the
// gradients dx, db, dc are f32 or bf16 (one dtype); all arithmetic is f32
// on the CUDA cores, in both dtypes.
//
// Design (the simple form: one block of 256 threads per (batch, head)):
// * The state entering each chunk. dc and d log a need H_g, which a walk
//   in reverse does not have, and the forward kernels do not keep (the
//   prefill path has no use for them). So the block first walks the
//   chunks forward, recomputing H_g in registers (2 Q N P flops a chunk)
//   and writing each to an f32 scratch [B, H, G, N, P] (201 MB at mamba2's
//   [4, 2048, 48 heads, P 64, N 128]), then walks them in reverse, reading
//   each back once. Nothing is kept between the forward and the backward
//   pass of a layer, with or without remat.
// * b and c are shared over the heads, so db and dc are sums over H. No
//   float atomics: each block writes its head's partials to f32 [B, H, L,
//   N] (2 x 201 MB at that shape) and a second launch
//   (ssd_bwd_head_sum_kernel) sums them over h = 0 .. H-1 in order. The result is bitwise the same
//   on every run.
// * d log a: each pair term A_ij, state term and carry is added into the
//   steps its decay spans (the pair terms by row prefix sums of A, then
//   sums down its columns, O(Q^2) a chunk), so no sum is subtracted from
//   another. The shorter identity sum_{s >= t} (dy_s . y_s - dx_s . x_s)
//   needs y in f32 and subtracts two sums of a larger scale: it put
//   a_log's gradient further from its f64 value than autograd does, this
//   form nearer (tools/ssd_dloga_accuracy.py).
// * Per chunk, x, dy, b, c, the masked scores S_ij D_ij, their gradients
//   dS_ij and the pair terms A_ij sit in shared memory, as do H_g and
//   dH_{g+1} for the products whose thread layout differs from the
//   state's; dH itself is carried in registers (32 entries a thread at
//   N 128, P 64). Shared memory at N 128, P 64: 212 KiB, one block an SM.
//
// What bounds it on an H100: at mamba2's training microbatch the function
// moves 162.5 MB (x, dy, dx in bf16; b, c, db, dc; log a and d log a in
// f32), 0.049 ms at 3.35 TB/s, and does 51.7 GFLOP in 64-step chunks over
// the causal triangle (five Q^2/2 products over N or P, six Q N P
// products), 0.052 ms on the bf16 tensor cores (chip_smoke.ssd_bwd_work):
// operations bound it; at hymba's N 16 the bytes do (0.048 ms). This kernel
// does the products in f32 on the CUDA cores, its inner loops limited by
// shared-memory loads (8-12 loads to 16-32 FMAs), at one block of 8 warps
// an SM (168-202 registers, 212 KiB of shared memory at N 128) over 1.45
// waves of blocks, and it moves 0.6 GB of scratch besides: 4.30 ms there,
// 1.2% of the bound, and 1.65 ms at hymba's shape, 2.9% (chip_smoke.py on
// an H100 80GB HBM3 at 700 W). Its tensor-core form (wgmma on the products,
// the per-head partials summed on chip) is still to do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kQ = 64;        // steps per chunk
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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
template <typename T>
__device__ void load_chunk(float* dst, int ld, const T* src, long long stride, int rows, int cols) {
  for (int e = threadIdx.x; e < kQ * cols; e += kThreads) {
    const int r = e / cols, k = e - r * cols;
    dst[r * ld + k] = r < rows ? to_f(src[r * stride + k]) : 0.0f;
  }
}

// Warp 0: the chunk's lc (cumulative log a, 0 past the rows), exp(lc_i)
// and exp(lc_end - lc_j). Lane l owns steps 2 l, 2 l + 1.
__device__ void chunk_decays(const float* lb, int H, int rows, float* lc, float* el, float* we) {
  const int lane = threadIdx.x;
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

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ loga, const T* __restrict__ bm,
               const T* __restrict__ cm, const T* __restrict__ dy, T* __restrict__ dx,
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
  const T* bb = bm + (long long)b * L * N;
  const T* cb = cm + (long long)b * L * N;
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
          if (i < rows) put(dx + xoff + (c0 + i) * xrow + p, g);
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
        carry *= el[kQ - 1];
        // steps 2 lane, 2 lane + 1: sum_{i >= t} sty_i (a suffix scan) and
        // sum_{j < t} stx_j (an exclusive prefix scan)
        const float y0 = sty[2 * lane], y1 = sty[2 * lane + 1];
        const float x0 = stx[2 * lane], x1 = stx[2 * lane + 1];
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
        const float d0 = rect[2 * lane] + sy0 + px0 + carry;
        const float d1 = rect[2 * lane + 1] + sy1 + px1 + carry;
        if (2 * lane < rows) dlb[(long long)(c0 + 2 * lane) * H] = d0;
        if (2 * lane + 1 < rows) dlb[(long long)(c0 + 2 * lane + 1) * H] = d1;
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
template <typename T>
__global__ void ssd_bwd_head_sum_kernel(const float* __restrict__ db_part,
                                        const float* __restrict__ dc_part, T* __restrict__ db,
                                        T* __restrict__ dc, int H, long long LN, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / LN, r = idx - b * LN;
  const float* part = (blockIdx.y == 0 ? db_part : dc_part) + b * H * LN + r;
  float s = 0.0f;
  for (int h = 0; h < H; ++h) s += part[h * LN];
  put((blockIdx.y == 0 ? db : dc) + idx, s);
}

template <typename T, int P, int N>
int launch_bwd(const void* x, const void* loga, const void* b, const void* c, const void* dy, void* dx,
               void* dloga, void* db, void* dc, void* states, void* db_part, void* dc_part, int B, int L,
               int H, cudaStream_t s) {
  const size_t smem = BwdShape<P, N>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_kernel<T, P, N><<<B * H, kThreads, smem, s>>>(
      (const T*)x, (const float*)loga, (const T*)b, (const T*)c, (const T*)dy, (T*)dx, (float*)dloga,
      (float*)states, (float*)db_part, (float*)dc_part, L, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * L * N;
  ssd_bwd_head_sum_kernel<T><<<dim3((unsigned)((total + 255) / 256), 2), 256, 0, s>>>(
      (const float*)db_part, (const float*)dc_part, (T*)db, (T*)dc, H, (long long)L * N, total);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_bwd_n(const void* x, const void* loga, const void* b, const void* c, const void* dy, void* dx,
                 void* dloga, void* db, void* dc, void* st, void* dbp, void* dcp, int B, int L, int H,
                 int N, cudaStream_t s) {
  switch (N) {
    case 16: return launch_bwd<T, P, 16>(x, loga, b, c, dy, dx, dloga, db, dc, st, dbp, dcp, B, L, H, s);
    case 32: return launch_bwd<T, P, 32>(x, loga, b, c, dy, dx, dloga, db, dc, st, dbp, dcp, B, L, H, s);
    case 64: return launch_bwd<T, P, 64>(x, loga, b, c, dy, dx, dloga, db, dc, st, dbp, dcp, B, L, H, s);
    case 128: return launch_bwd<T, P, 128>(x, loga, b, c, dy, dx, dloga, db, dc, st, dbp, dcp, B, L, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_bwd_dt(const void* x, const void* loga, const void* b, const void* c, const void* dy, void* dx,
                  void* dloga, void* db, void* dc, void* st, void* dbp, void* dcp, int B, int L, int H,
                  int P, int N, cudaStream_t s) {
  if (P == 32) return launch_bwd_n<T, 32>(x, loga, b, c, dy, dx, dloga, db, dc, st, dbp, dcp, B, L, H, N, s);
  if (P == 64) return launch_bwd_n<T, 64>(x, loga, b, c, dy, dx, dloga, db, dc, st, dbp, dcp, B, L, H, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx [B, L, H, P]; loga, dloga [B, L, H] f32; b, c, db, dc [B, L, N];
// x, b, c, dy, dx, db, dc bf16 if bf16 != 0, else f32. Scratch: states
// [B, H, ceil(L / 64), N, P] f32, db_part and dc_part [B, H, L, N] f32.
// P in {32, 64}, N in {16, 32, 64, 128}, any L >= 1.
extern "C" int lm_ssd_scan_bwd(const void* x, const void* loga, const void* b, const void* c,
                               const void* dy, void* dx, void* dloga, void* db, void* dc, void* states,
                               void* db_part, void* dc_part, int B, int L, int H, int P, int N, int bf16,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || L < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_bwd_dt<__nv_bfloat16>(x, loga, b, c, dy, dx, dloga, db, dc, states, db_part, dc_part,
                                        B, L, H, P, N, s);
  return launch_bwd_dt<float>(x, loga, b, c, dy, dx, dloga, db, dc, states, db_part, dc_part, B, L, H, P,
                              N, s);
}
