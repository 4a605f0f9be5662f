// Separable Gaussian blur of a stack of float32 slices, for Hopper (sm_90a).
// Replaces the TPU kernel
// cmrtpu/ops/pallas_kernels.py::gaussian_blur_2d_pallas.
//
// Contract (identical to the reference): out[n] = blur of x[n] along H, then
// along W, with the 2r+1 normalised taps of scipy's gaussian_kernel1d
// (radius int(4 sigma + 0.5)) and scipy's 'reflect' border, which is
// np.pad's 'symmetric': index i < 0 reads -i-1, i >= n reads 2n-1-i, folded
// with period 2n as often as needed, so a radius larger than the side still
// reflects like np.pad. Sums are float32, row pass first as in the Pallas
// body; the plain torch version sums the column pass first, so the two
// agree to the last bits only (atol 1e-5).
//
// Design: one block per (32 x 32 output tile, slice), grid
// (ceil(W/32), ceil(H/32), N): at the main path's [32, 224, 224] that is
// 1,568 blocks for 132 SMs, where the Pallas grid of one program per slice
// would keep 32 busy. The block reads its (32+2r) x (32+2r) window straight
// from the unpadded stack into shared memory, folding the border into the
// index, so no padded copy is written to device memory (the Pallas path
// writes one with jnp.pad before its launch). The pass along H goes into a
// shared 32 x (32+2r) scratch and the pass along W from there to the output.
// The taps travel by value in the kernel's parameter block.
//
// What bounds it on an H100: memory. At [32, 224, 224] it must read 6.42 MB
// and write 6.42 MB: 12.85 MB / 3.35 TB/s = 3.8 us. Its 4r+2 = 34 multiply-
// adds per pass and pixel (68 flop at r = 8) come to 109 MFLOP, 1.6 us at
// 67 TFLOP/s in float32. The design moves each input byte from device
// memory once (halo rows come from L2 for the neighbouring tiles) and keeps
// every intermediate in shared memory.
//
// Launches on the caller's stream, does not synchronise and allocates
// nothing. Returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // output tile is kTile x kTile
constexpr int kRows = 8;         // threads per block: kTile x kRows
constexpr int kMaxRadius = 96;   // (32+2r)^2 + 32(32+2r) floats <= 227 KB
constexpr int kMaxTaps = 2 * kMaxRadius + 1;

struct Taps {
  float v[kMaxTaps];
};

// np.pad 'symmetric' index: fold i into [0, n) with period 2n
__device__ __forceinline__ int reflect_index(int i, int n) {
  const int period = 2 * n;
  int j = i % period;
  if (j < 0) j += period;
  return j < n ? j : period - 1 - j;
}

__global__ void __launch_bounds__(kTile * kRows)
gaussian_blur_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int h, int w, int radius, Taps taps) {
  extern __shared__ float smem[];
  const int span = kTile + 2 * radius;   // window side
  float* win = smem;                     // span x span input window
  float* tmp = smem + span * span;       // kTile x span after the H pass
  const int taps_n = 2 * radius + 1;

  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * kRows;

  for (int k = tid; k < span * span; k += nthreads) {
    const int r = k / span;
    const int c = k - r * span;
    const int gy = reflect_index(y0 - radius + r, h);
    const int gx = reflect_index(x0 - radius + c, w);
    win[k] = x[base + static_cast<size_t>(gy) * w + gx];
  }
  __syncthreads();

  // pass 1, along H: tmp[i][j] = sum_t taps[t] * win[i + t][j]
  for (int k = tid; k < kTile * span; k += nthreads) {
    const int i = k / span;
    const int j = k - i * span;
    float acc = 0.0f;
    for (int t = 0; t < taps_n; ++t) {
      acc += taps.v[t] * win[(i + t) * span + j];
    }
    tmp[k] = acc;
  }
  __syncthreads();

  // pass 2, along W: out[i][j] = sum_t taps[t] * tmp[i][j + t]
  const int j = threadIdx.x;
  const int gx = x0 + j;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int gy = y0 + i;
    if (gy >= h || gx >= w) continue;
    float acc = 0.0f;
    for (int t = 0; t < taps_n; ++t) {
      acc += taps.v[t] * tmp[i * span + j + t];
    }
    out[base + static_cast<size_t>(gy) * w + gx] = acc;
  }
}

}  // namespace

// x, out: float32 [n, h, w], contiguous on the current device; taps: a HOST
// array of 2 * radius + 1 floats; stream is a cudaStream_t.
extern "C" int gaussian_blur_launch(const void* x, void* out, int n, int h,
                                    int w, const float* taps, int radius,
                                    void* stream) {
  if (radius < 0 || radius > kMaxRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps t;
  for (int i = 0; i < 2 * radius + 1; ++i) t.v[i] = taps[i];
  const long long span = kTile + 2LL * radius;
  const long long smem = (span * span + kTile * span) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gaussian_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  const dim3 block(kTile, kRows);
  gaussian_blur_kernel<<<grid, block, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), h, w, radius, t);
  return static_cast<int>(cudaGetLastError());
}
