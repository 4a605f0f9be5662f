// Shifted-window multi-head attention of the Swin-Unet, forward and
// backward, for Hopper (sm_90a): K3.
//
// It replaces no Pallas kernel: cmrtpu has no Swin-Unet. It is new for the
// port's Swin-Unet (cmrtpu_torch/models/swin_unet.py), where it takes the
// place of everything between a block's qkv and proj linears: the cyclic
// shift, the window partition, the per-head split, q k^T, the bias, the
// shift mask, the softmax, P v, the head merge, the window reverse and the
// shift back, with autograd's mirror of each.
//
// Contract (the plain twin is window_attention_plain in
// cmrtpu_torch/ops/window_attention.py). qkv is bf16 [N, h, w, 3C] in the
// tokens' natural order, C = heads * 32, its last axis (3, heads, 32). The
// map rolled by (-s, -s) is cut into m x m windows (T = m * m <= 64 tokens,
// in row order), so window token t of window (wr, wc) of image n reads
// pixel ((wr * m + t / m + s) mod h, (wc * m + t % m + s) mod w): the shift
// and the partition are this addressing, and nothing is copied. Per window
// and head, with q k^T from bf16 operands into a float32 sum:
//   S = scale * q k^T + B[head] + mask_s      (float32, in that order)
//   P = softmax_rows(S)                       (float32)
//   O = bf16(P) v                             (float32 sum, written bf16)
// B is the float32 bias [heads, T, T]; mask_s is exactly -100 between two
// tokens of different regions of the rolled map ([0, side - m),
// [side - m, side - s), [side - s, side) on each axis), 0 otherwise, and
// absent for s = 0. O goes to out, bf16 [N, h, w, C], at the pixel each
// token was read from; lse, float32 [heads, windows, T], keeps each row's
// max + log(sum) for the backward.
// The backward recomputes P = exp(S - lse) and, with dO = d(out):
//   dV = bf16(P)^T dO,  dP = dO v^T,  D = rowsum(P * dP),  dS = P (dP - D),
//   dQ = scale * bf16(dS) k,  dK = scale * bf16(dS)^T q,
//   dB[head] = sum of dS over every window of every image,
// and writes d(qkv) bf16 [N, h, w, 3C] in the same addressing. D is
// rowsum(dO * O) of flash attention's backward, taken from the whole row of
// P and dP that a warp holds, so O is not read. dB is deterministic: each
// block sums its windows' dS in registers into its own partial, and a
// second kernel adds the partials of a head in a fixed order; no float
// atomics.
//
// Design: one warpgroup (4 warps, 128 threads) per block; a block takes one
// head and a group of consecutive windows (the host chooses the group so
// that the grid is about four blocks per SM), and keeps B[head] on chip for
// all of them (registers in the forward, shared memory in the backward).
// Per window, the tokens' pixel offsets and region ids are computed once,
// q, k, v (and dO) come into shared memory as 16-byte loads, 64 bytes a
// token each (T rows padded to 64 with zeros), and each warp computes 16
// rows with mma.sync m16n8k16 (bf16 in, float32 sums): S and the softmax
// stay in registers, and P becomes the A operand of P v without leaving
// them. In the backward each warp takes 16 query rows for S, dP, dS and dQ,
// writes bf16 P and dS to shared memory, and after a barrier takes 16 key
// rows for dV and dK.
//
// What bounds it on an H100: bytes. At the Swin-Unet's 56^2 stage (batch
// 24, C 96, 3 heads, 1,536 windows of 49 tokens) the forward must read qkv
// (43.4 MB) and write out (14.5 MB): 17.3 us at 3.35 TB/s, against 1.4
// GFLOP of q k^T and P v, 1.4 us at 989 TFLOP/s; the backward reads qkv
// and dO and writes d(qkv), 101 MB, 30 us. The design keeps every
// intermediate (scores, probabilities, their gradients) on chip, so each
// byte of qkv, out, dO and d(qkv) crosses device memory once, and B and
// the mask cost no traffic per window. mma.sync and not wgmma: at about 13
// FLOP a byte the tensor cores are never the limit.
//
// Launches on the caller's stream, does not synchronise and allocates
// nothing (the wrapper allocates out, lse, d(qkv) and the partials).
// Returns cudaGetLastError() (0 on success).

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 32;                // head dim
constexpr int kRows = 64;             // tokens of a window, padded
constexpr int kThreads = 128;         // one warpgroup
constexpr int kLd = kD + 8;           // row stride of [token][dim] tiles
constexpr int kLdP = kRows + 8;       // row stride of [query][key] tiles
constexpr float kMaskValue = -100.0f; // swin_unet.py MASK_VALUE

struct Geo {
  int h, w, m, s;       // side, window, shift
  int heads, c;         // heads and C = heads * kD
  int per_row, per_img; // windows along a row of windows, of an image
  int windows, tokens;  // windows of the batch, m * m
  int group;            // windows of one block
  float scale;
};

__device__ __forceinline__ int region(int p, int side, int m, int s) {
  return p < side - m ? 0 : (p < side - s ? 1 : 2);
}

// token t of window win: its pixel (n * h + y) * w + x, and its region id
// in the rolled map
__device__ __forceinline__ void token_table(const Geo& g, int win, int t,
                                            int* pix, int* reg) {
  const int img = win / g.per_img, wi = win - img * g.per_img;
  const int wr = wi / g.per_row, wc = wi - wr * g.per_row;
  const int i = t / g.m, j = t - i * g.m;
  const int pr = wr * g.m + i, pc = wc * g.m + j;
  int y = pr + g.s, x = pc + g.s;
  if (y >= g.h) y -= g.h;
  if (x >= g.w) x -= g.w;
  pix[t] = (img * g.h + y) * g.w + x;
  reg[t] = g.s ? 3 * region(pr, g.h, g.m, g.s) + region(pc, g.w, g.m, g.s)
               : 0;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 of a shared tile, at off and off + step, as one register (the
// first in the low half)
template <int kStep>
__device__ __forceinline__ uint32_t pair(const uint16_t* t, int off) {
  if (kStep == 1) return *reinterpret_cast<const uint32_t*>(t + off);
  return static_cast<uint32_t>(t[off]) |
         (static_cast<uint32_t>(t[off + kStep]) << 16);
}

// A fragment (16 x 16) of an m16n8k16 product from a tile whose element
// (row m, column k) lies at t[m * kMs + k * kKs], rows from m0, columns
// from k0
template <int kMs, int kKs>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* t,
                                       int m0, int k0, int gid, int tig) {
  const int m = m0 + gid, k = k0 + 2 * tig;
  a[0] = pair<kKs>(t, m * kMs + k * kKs);
  a[1] = pair<kKs>(t, (m + 8) * kMs + k * kKs);
  a[2] = pair<kKs>(t, m * kMs + (k + 8) * kKs);
  a[3] = pair<kKs>(t, (m + 8) * kMs + (k + 8) * kKs);
}

// B fragment (16 x 8) from a tile whose element (row k, column n) lies at
// t[k * kKs + n * kNs]
template <int kKs, int kNs>
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const uint16_t* t,
                                       int k0, int n0, int gid, int tig) {
  const int k = k0 + 2 * tig, n = n0 + gid;
  b[0] = pair<kKs>(t, k * kKs + n * kNs);
  b[1] = pair<kKs>(t, (k + 8) * kKs + n * kNs);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[nt] += rows m0.. of x times y^T, x and y [token][dim] tiles: 16 rows
// by 64 columns over the 32 dims
__device__ __forceinline__ void rows_times_t(float (&acc)[8][4],
                                             const uint16_t* x,
                                             const uint16_t* y, int m0,
                                             int gid, int tig) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4];
    load_a<kLd, 1>(a, x, m0, kk * 16, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b[2];
      load_b<1, kLd>(b, y, kk * 16, nt * 8, gid, tig);
      mma(acc[nt], a, b);
    }
  }
}

// out[dt] += p y for a warp's 16 rows of p (registers, the layout of a
// product's sums, times row factors f0 and f1) and y a [token][dim] tile
__device__ __forceinline__ void probs_times(float (&out)[4][4],
                                            const float (&p)[8][4], float f0,
                                            float f1, const uint16_t* y,
                                            int gid, int tig) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack(p[2 * kk][0] * f0, p[2 * kk][1] * f0);
    a[1] = pack(p[2 * kk][2] * f1, p[2 * kk][3] * f1);
    a[2] = pack(p[2 * kk + 1][0] * f0, p[2 * kk + 1][1] * f0);
    a[3] = pack(p[2 * kk + 1][2] * f1, p[2 * kk + 1][3] * f1);
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      uint32_t b[2];
      load_b<kLd, 1>(b, y, kk * 16, dt * 8, gid, tig);
      mma(out[dt], a, b);
    }
  }
}

// zero rows tokens..63 of a [token][dim] tile (never loaded)
__device__ __forceinline__ void zero_pad(uint16_t* t, int tokens) {
  for (int i = tokens * kLd + threadIdx.x; i < kRows * kLd; i += kThreads)
    t[i] = 0;
}

// one token's 32 dims (64 bytes) of a row of src into a tile row
__device__ __forceinline__ void load_row(uint16_t* dst, const uint16_t* src,
                                         int chunk) {
  reinterpret_cast<uint4*>(dst)[chunk] =
      __ldg(reinterpret_cast<const uint4*>(src) + chunk);
}

// a warp's 16 rows x 32 dims of sums, times f, as bf16 at dst + pixel *
// stride for each row below tokens
__device__ __forceinline__ void store_rows(uint16_t* dst, size_t stride,
                                           const int* pix, int r0,
                                           int tokens, const float (&o)[4][4],
                                           float f, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= tokens) continue;
    uint16_t* row = dst + static_cast<size_t>(pix[r]) * stride + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8) =
          pack(o[dt][2 * half] * f, o[dt][2 * half + 1] * f);
  }
}

__global__ void __launch_bounds__(kThreads)
window_attention_fwd(const uint16_t* __restrict__ qkv,
                     const float* __restrict__ bias,
                     uint16_t* __restrict__ out, float* __restrict__ lse,
                     Geo g) {
  __shared__ __align__(16) uint16_t sq[kRows * kLd];
  __shared__ __align__(16) uint16_t sk[kRows * kLd];
  __shared__ __align__(16) uint16_t sv[kRows * kLd];
  __shared__ int spix[kRows], sreg[kRows];
  const int head = blockIdx.y, tid = threadIdx.x, n = g.tokens;
  const int warp = tid >> 5, gid = (tid & 31) >> 2, tig = tid & 3;
  const int r0 = warp * 16 + gid, r1 = r0 + 8;
  zero_pad(sq, n);
  zero_pad(sk, n);
  zero_pad(sv, n);
  float bs[8][4];
  const float* bh = bias + static_cast<size_t>(head) * n * n;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1, c = nt * 8 + 2 * tig + (e & 1);
      bs[nt][e] = (r < n && c < n) ? bh[r * n + c] : 0.0f;
    }
  const size_t c3 = 3 * static_cast<size_t>(g.c);
  const int first = blockIdx.x * g.group;
  const int last = min(first + g.group, g.windows);
  for (int win = first; win < last; ++win) {
    __syncthreads();  // the last window's readers of the tables are done
    if (tid < n) token_table(g, win, tid, spix, sreg);
    __syncthreads();
    for (int i = tid; i < n * 12; i += kThreads) {
      const int t = i / 12, mat = (i % 12) >> 2, chunk = i & 3;
      uint16_t* tile = mat == 0 ? sq : (mat == 1 ? sk : sv);
      load_row(tile + t * kLd,
               qkv + spix[t] * c3 + mat * g.c + head * kD, chunk);
    }
    __syncthreads();

    float acc[8][4] = {};
    rows_times_t(acc, sq, sk, warp * 16, gid, tig);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1, c = nt * 8 + 2 * tig + (e & 1);
        float v = -INFINITY;
        if (c < n) {
          v = acc[nt][e] * g.scale + bs[nt][e];
          if (g.s && r < n && sreg[r] != sreg[c]) v += kMaskValue;
        }
        acc[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int lane = 1; lane < 4; lane <<= 1)
        mx[half] = fmaxf(mx[half],
                         __shfl_xor_sync(0xffffffffu, mx[half], lane));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[nt][e] = expf(acc[nt][e] - mx[e >> 1]);
        sum[e >> 1] += acc[nt][e];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int lane = 1; lane < 4; lane <<= 1)
        sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], lane);
    if (tig == 0) {
      float* row = lse + (static_cast<size_t>(head) * g.windows + win) * n;
      if (r0 < n) row[r0] = mx[0] + logf(sum[0]);
      if (r1 < n) row[r1] = mx[1] + logf(sum[1]);
    }

    float o[4][4] = {};
    probs_times(o, acc, 1.0f / sum[0], 1.0f / sum[1], sv, gid, tig);
    store_rows(out + head * kD, g.c, spix, r0, n, o, 1.0f, tig);
  }
}

__global__ void __launch_bounds__(kThreads)
window_attention_bwd(const uint16_t* __restrict__ qkv,
                     const float* __restrict__ bias,
                     const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse,
                     uint16_t* __restrict__ dqkv, float* __restrict__ part,
                     Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sq = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sk = sq + kRows * kLd;
  uint16_t* sv = sk + kRows * kLd;
  uint16_t* sdo = sv + kRows * kLd;
  uint16_t* sp = sdo + kRows * kLd;
  uint16_t* sds = sp + kRows * kLdP;
  float* sbias = reinterpret_cast<float*>(sds + kRows * kLdP);
  __shared__ int spix[kRows], sreg[kRows];
  __shared__ float slse[kRows];
  const int head = blockIdx.y, tid = threadIdx.x, n = g.tokens;
  const int warp = tid >> 5, gid = (tid & 31) >> 2, tig = tid & 3;
  const int m0 = warp * 16, r0 = m0 + gid, r1 = r0 + 8;
  zero_pad(sq, n);
  zero_pad(sk, n);
  zero_pad(sv, n);
  zero_pad(sdo, n);
  const float* bh = bias + static_cast<size_t>(head) * n * n;
  for (int i = tid; i < n * n; i += kThreads) sbias[i] = bh[i];
  float db[8][4] = {};
  const size_t c3 = 3 * static_cast<size_t>(g.c);
  const int first = blockIdx.x * g.group;
  const int last = min(first + g.group, g.windows);
  for (int win = first; win < last; ++win) {
    __syncthreads();  // the last window's readers of every tile are done
    if (tid < n) {
      token_table(g, win, tid, spix, sreg);
      slse[tid] =
          lse[(static_cast<size_t>(head) * g.windows + win) * n + tid];
    }
    __syncthreads();
    for (int i = tid; i < n * 16; i += kThreads) {
      const int t = i >> 4, mat = (i >> 2) & 3, chunk = i & 3;
      if (mat < 3) {
        uint16_t* tile = mat == 0 ? sq : (mat == 1 ? sk : sv);
        load_row(tile + t * kLd,
                 qkv + spix[t] * c3 + mat * g.c + head * kD, chunk);
      } else {
        load_row(sdo + t * kLd,
                 dout + spix[t] * static_cast<size_t>(g.c) + head * kD,
                 chunk);
      }
    }
    __syncthreads();

    // this warp's 16 query rows: P, dP, dS and dQ
    float p[8][4] = {}, dp[8][4] = {};
    rows_times_t(p, sq, sk, m0, gid, tig);
    rows_times_t(dp, sdo, sv, m0, gid, tig);
    float d[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1, c = nt * 8 + 2 * tig + (e & 1);
        float v = 0.0f;
        if (r < n && c < n) {
          v = p[nt][e] * g.scale + sbias[r * n + c];
          if (g.s && sreg[r] != sreg[c]) v += kMaskValue;
          v = expf(v - slse[r]);
        }
        p[nt][e] = v;
        d[e >> 1] += v * dp[nt][e];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int lane = 1; lane < 4; lane <<= 1)
        d[half] += __shfl_xor_sync(0xffffffffu, d[half], lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[nt][e] = p[nt][e] * (dp[nt][e] - d[e >> 1]);
        db[nt][e] += dp[nt][e];
      }
      const int c = nt * 8 + 2 * tig;
      *reinterpret_cast<uint32_t*>(sp + r0 * kLdP + c) =
          pack(p[nt][0], p[nt][1]);
      *reinterpret_cast<uint32_t*>(sp + r1 * kLdP + c) =
          pack(p[nt][2], p[nt][3]);
      *reinterpret_cast<uint32_t*>(sds + r0 * kLdP + c) =
          pack(dp[nt][0], dp[nt][1]);
      *reinterpret_cast<uint32_t*>(sds + r1 * kLdP + c) =
          pack(dp[nt][2], dp[nt][3]);
    }
    {
      float dq[4][4] = {};
      probs_times(dq, dp, 1.0f, 1.0f, sk, gid, tig);
      store_rows(dqkv + head * kD, c3, spix, r0, n, dq, g.scale, tig);
    }
    __syncthreads();  // every row of P and dS is in shared memory

    // this warp's 16 key rows: dV = P^T dO and dK = scale dS^T q
    float dv[4][4] = {}, dk[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t ap[4], as[4];
      load_a<1, kLdP>(ap, sp, m0, kk * 16, gid, tig);
      load_a<1, kLdP>(as, sds, m0, kk * 16, gid, tig);
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        uint32_t b[2];
        load_b<kLd, 1>(b, sdo, kk * 16, dt * 8, gid, tig);
        mma(dv[dt], ap, b);
        load_b<kLd, 1>(b, sq, kk * 16, dt * 8, gid, tig);
        mma(dk[dt], as, b);
      }
    }
    store_rows(dqkv + g.c + head * kD, c3, spix, r0, n, dk, g.scale, tig);
    store_rows(dqkv + 2 * g.c + head * kD, c3, spix, r0, n, dv, 1.0f, tig);
  }

  // this block's sum of dS over its windows
  float* dst = part + (static_cast<size_t>(head) * gridDim.x + blockIdx.x) *
                          n * n;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1, c = nt * 8 + 2 * tig + (e & 1);
      if (r < n && c < n) dst[r * n + c] = db[nt][e];
    }
}

// dB[head, i] = the sum of a head's partials in block order
__global__ void window_attention_dbias(const float* __restrict__ part,
                                       float* __restrict__ dbias, int groups,
                                       int nn, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int head = i / nn;
  const float* p =
      part + static_cast<size_t>(head) * groups * nn + (i - head * nn);
  float s = 0.0f;
  for (int k = 0; k < groups; ++k) s += p[static_cast<size_t>(k) * nn];
  dbias[i] = s;
}

Geo make_geo(int batch, int h, int w, int m, int s, int heads, int group,
             float scale) {
  Geo g;
  g.h = h;
  g.w = w;
  g.m = m;
  g.s = s;
  g.heads = heads;
  g.c = heads * kD;
  g.per_row = w / m;
  g.per_img = (h / m) * g.per_row;
  g.windows = batch * g.per_img;
  g.tokens = m * m;
  g.group = group;
  g.scale = scale;
  return g;
}

size_t bwd_smem_bytes(int tokens) {
  return sizeof(uint16_t) * (4 * kRows * kLd + 2 * kRows * kLdP) +
         sizeof(float) * tokens * tokens;
}

}  // namespace

// qkv: bf16 [batch, h, w, 3 * heads * 32]; bias: float32 [heads, m*m, m*m];
// out: bf16 [batch, h, w, heads * 32]; lse: float32 [heads, windows, m*m].
// All contiguous on the current device, qkv 16-byte aligned; h and w
// multiples of m, m * m <= 64, 0 <= s < m; group windows a block. stream
// is a cudaStream_t.
extern "C" int window_attention_fwd_launch(const void* qkv, const void* bias,
                                           void* out, void* lse, int batch,
                                           int h, int w, int m, int s,
                                           int heads, int group, float scale,
                                           void* stream) {
  const Geo g = make_geo(batch, h, w, m, s, heads, group, scale);
  const dim3 grid((g.windows + group - 1) / group, heads);
  const auto st = static_cast<cudaStream_t>(stream);
  window_attention_fwd<<<grid, kThreads, 0, st>>>(
      static_cast<const uint16_t*>(qkv), static_cast<const float*>(bias),
      static_cast<uint16_t*>(out), static_cast<float*>(lse), g);
  return static_cast<int>(cudaGetLastError());
}

// dout: bf16 like out; dqkv: bf16 like qkv; part: float32 [heads, blocks,
// m*m, m*m] with blocks = ceil(windows / group); dbias: float32 like bias.
// The same conditions as the forward; two kernels, the second the
// partials' sum.
extern "C" int window_attention_bwd_launch(const void* qkv, const void* bias,
                                           const void* dout, const void* lse,
                                           void* dqkv, void* part,
                                           void* dbias, int batch, int h,
                                           int w, int m, int s, int heads,
                                           int group, float scale,
                                           void* stream) {
  const Geo g = make_geo(batch, h, w, m, s, heads, group, scale);
  const auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (g.windows + group - 1) / group;
  const size_t smem = bwd_smem_bytes(g.tokens);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_bwd<<<dim3(blocks, heads), kThreads, smem, st>>>(
      static_cast<const uint16_t*>(qkv), static_cast<const float*>(bias),
      static_cast<const uint16_t*>(dout), static_cast<const float*>(lse),
      static_cast<uint16_t*>(dqkv), static_cast<float*>(part), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nn = g.tokens * g.tokens, total = heads * nn;
  window_attention_dbias<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), blocks, nn,
      total);
  return static_cast<int>(cudaGetLastError());
}
