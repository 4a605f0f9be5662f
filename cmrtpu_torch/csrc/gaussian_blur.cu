// Separable Gaussian blur of a stack of float32 slices, for Hopper (sm_90a).
// Replaces the TPU kernel
// cmrtpu/ops/pallas_kernels.py::gaussian_blur_2d_pallas.
//
// Contract (identical to the reference): out[n] = blur of x[n] along H, then
// along W, with the 2r+1 normalised taps of scipy's gaussian_kernel1d
// (radius int(4 sigma + 0.5)) and scipy's 'reflect' border, which is
// np.pad's 'symmetric': index i < 0 reads -i-1, i >= n reads 2n-1-i, folded
// with period 2n as often as needed, so a radius larger than the side still
// reflects like np.pad. Sums are float32, the pass along H first and each
// sum over the taps in order, as in the Pallas body; the plain torch version
// sums the pass along W first, so the two agree to the last bits only
// (atol 1e-5).
//
// Design: one 256-thread block per (slice, strip of S output rows, chunk of
// C output columns), grid (N, ceil(H/S), ceil(W/C)). The host picks S and C
// (cmrtpu_torch/ops/cuda_kernels.py:blur_geometry): C is the whole width
// wherever the block fits shared memory, so there is no halo along W and no
// second read of a column. Per block:
//   1. the S + 2r input rows of the strip, their H border folded once per
//      row, go to shared memory with 16-byte cp.async when W % 4 == 0 and
//      both pointers are 16-byte aligned, by scalar copies otherwise;
//   2. a table of the C + 2r source columns (the W border folded once per
//      block) is built beside them;
//   3. the pass along H: each thread takes one column and 4 rows, so one
//      shared-memory read feeds 4 multiply-adds, into a shared S x (C + 2r)
//      scratch (the layout of the Pallas body's scratch);
//   4. the pass along W: each thread takes 4 adjacent outputs of a row,
//      reads the scratch as float4 and stores the 4 outputs as one float4.
// No loop over pixels divides: offsets come from the grid and the tables.
// The radii of the configs (4, 8, 16: sigma 1, 2, 4) are template constants,
// so the tap loops unroll and the taps are operands of the multiply-adds;
// other radii run the same body with the radius read at run time, 2.3-3.3x
// slower at radii 4, 8 and 16 (cmrtpu_torch/tools/k1_sweep.py, PERF.md).
//
// What bounds it on an H100: memory. At [32, 224, 224] it must read 6.42 MB
// and write 6.42 MB: 12.85 MB / 3.35 TB/s = 3.8 us. Its 4r+2 = 34 multiply-
// adds per pixel (68 flop at r = 8) come to 109 MFLOP, 1.6 us at 67 TFLOP/s
// in float32. Full-width strips read (S + 2r) / S of the input (1.57x at
// S = 28, r = 8; the halo rows mostly from L2) where 32 x 32 tiles read
// 2.25x, and the register blocking keeps shared-memory traffic to about a
// quarter of one read per multiply-add. At S = 28 a [32, 224, 224] stack is
// 256 blocks, about two for each of the 132 SMs.
//
// Launches on the caller's stream, does not synchronise and allocates
// nothing. Returns cudaGetLastError() (0 on success).

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 64;
constexpr int kThreadsY = 4;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kMaxRadius = 108;  // cuda_kernels.py BLUR_MAX_RADIUS
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
constexpr int kMaxGridYZ = 65535;
constexpr int kSmemLimit = 232448;

struct Taps {
  float v[kMaxTaps];
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// shared-memory layout, in 4-byte words (cuda_kernels.py blur_smem_bytes)
__host__ __device__ __forceinline__ int in_stride(int chunk, int r) {
  return round4(chunk + 2 * r) + 8;
}
__host__ __device__ __forceinline__ int tmp_stride(int chunk, int r) {
  return round4(chunk + 2 * r + 4);
}
__host__ __device__ __forceinline__ long long smem_words(int strip, int chunk,
                                                         int r) {
  return static_cast<long long>(strip + 2 * r) * in_stride(chunk, r) +
         static_cast<long long>(strip) * tmp_stride(chunk, r) + chunk + 2 * r;
}

// np.pad 'symmetric' source index of i along a side of n (period 2n)
__device__ __forceinline__ int fold(int i, int n) {
  while (i < 0 || i >= n) i = i < 0 ? -i - 1 : 2 * n - 1 - i;
  return i;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// kR >= 0: the radius as a constant; kR < 0: read from `radius`
template <int kR>
__global__ void __launch_bounds__(kThreads)
gaussian_blur_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int h, int w, int radius, int strip, int chunk, int vec,
                     Taps taps) {
  const int r = kR >= 0 ? kR : radius;
  const int ntaps = 2 * r + 1;
  extern __shared__ float4 smem4[];
  float* s_in = reinterpret_cast<float*>(smem4);
  const int ins = in_stride(chunk, r);
  const int tms = tmp_stride(chunk, r);
  float* s_tmp = s_in + (strip + 2 * r) * ins;
  int* s_col = reinterpret_cast<int*>(s_tmp + strip * tms);

  const size_t base = static_cast<size_t>(blockIdx.x) * h * w;
  const int y0 = blockIdx.y * strip;
  const int x0 = blockIdx.z * chunk;
  const int rows = min(strip, h - y0);
  const int cols = min(chunk, w - x0);
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  // 1. input rows y0 - r .. into shared memory; columns [cx0, cx1) hold
  // every source column the chunk's folded window reads
  const int cx0 = max(0, x0 - r) & ~3;
  const int cx1 = min(w, x0 + cols + r);
  const int load_rows = round4(rows) + 2 * r;
  if (vec) {
    const int nv = (cx1 - cx0 + 3) >> 2;  // w % 4 == 0: stays in the row
    for (int k = threadIdx.y; k < load_rows; k += kThreadsY) {
      const float* src =
          x + base + static_cast<size_t>(fold(y0 - r + k, h)) * w + cx0;
      float* dst = s_in + k * ins;
      for (int v = threadIdx.x; v < nv; v += kThreadsX) {
        cp_async16(dst + 4 * v, src + 4 * v);
      }
    }
  } else {
    const int span = cx1 - cx0;
    for (int k = threadIdx.y; k < load_rows; k += kThreadsY) {
      const float* src =
          x + base + static_cast<size_t>(fold(y0 - r + k, h)) * w + cx0;
      float* dst = s_in + k * ins;
      for (int c = threadIdx.x; c < span; c += kThreadsX) dst[c] = src[c];
    }
  }
  // 2. shared-memory column of each of the chunk's C + 2r window columns
  const int ncols = cols + 2 * r;
  for (int c = tid; c < ncols; c += kThreads) {
    s_col[c] = fold(x0 - r + c, w) - cx0;
  }
  if (vec) cp_async_wait_all();
  __syncthreads();

  // 3. pass along H: s_tmp[i][c] = sum_t taps[t] * s_in[i + t][col(c)],
  // 4 rows a thread
  const int groups = (rows + 3) >> 2;
  const int h_reads = kR >= 0 ? 2 * kR + 4 : ntaps + 3;
  for (int g = 0; g < groups; ++g) {
    const float* src = s_in + 4 * g * ins;
    float* dst = s_tmp + 4 * g * tms;
    for (int c = tid; c < ncols; c += kThreads) {
      const float* p = src + s_col[c];
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int t = 0; t < h_reads; ++t) {
        const float v = p[t * ins];
        if (t < ntaps) a0 = fmaf(taps.v[t], v, a0);
        if (t >= 1 && t - 1 < ntaps) a1 = fmaf(taps.v[t - 1], v, a1);
        if (t >= 2 && t - 2 < ntaps) a2 = fmaf(taps.v[t - 2], v, a2);
        if (t >= 3 && t - 3 < ntaps) a3 = fmaf(taps.v[t - 3], v, a3);
      }
      dst[c] = a0;
      dst[tms + c] = a1;
      dst[2 * tms + c] = a2;
      dst[3 * tms + c] = a3;
    }
  }
  __syncthreads();

  // 4. pass along W: out[i][j] = sum_t taps[t] * s_tmp[i][j + t], 4
  // adjacent outputs a thread, float4 reads and stores
  const int quads = (cols + 3) >> 2;
  const int w_vecs = kR >= 0 ? (2 * kR + 7) >> 2 : (ntaps + 6) >> 2;
  for (int i = threadIdx.y; i < rows; i += kThreadsY) {
    const float* src = s_tmp + i * tms;
    float* dst = out + base + static_cast<size_t>(y0 + i) * w + x0;
    for (int qd = threadIdx.x; qd < quads; qd += kThreadsX) {
      const int j0 = qd << 2;
      const float4* p = reinterpret_cast<const float4*>(src + j0);
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < w_vecs; ++m) {
        const float4 v4 = p[m];
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int t = 4 * m + k - q;
            if (t >= 0 && t < ntaps) a[q] = fmaf(taps.v[t], vv[k], a[q]);
          }
        }
      }
      if (vec && j0 + 4 <= cols) {
        *reinterpret_cast<float4*>(dst + j0) = make_float4(a[0], a[1], a[2],
                                                           a[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j0 + q < cols) dst[j0 + q] = a[q];
        }
      }
    }
  }
}

using BlurKernel = void (*)(const float*, float*, int, int, int, int, int, int,
                            Taps);

const BlurKernel kKernels[] = {gaussian_blur_kernel<4>, gaussian_blur_kernel<8>,
                               gaussian_blur_kernel<16>,
                               gaussian_blur_kernel<-1>};
// per kernel, the devices (a bit each) on which it may already take the
// whole opt-in shared memory
std::atomic<uint64_t> g_opted_in[4];

int kernel_index(int radius) {
  return radius == 4 ? 0 : radius == 8 ? 1 : radius == 16 ? 2 : 3;
}

// cudaFuncSetAttribute once per kernel and device: it costs more host time
// than a launch
cudaError_t opt_in_smem(int k) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (g_opted_in[k].load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernels[k],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err == cudaSuccess) g_opted_in[k].fetch_or(bit);
  return err;
}

}  // namespace

// x, out: float32 [n, h, w], contiguous on the current device; taps: a HOST
// array of 2 * radius + 1 floats; strip (rows) and chunk (columns): the
// block's output box, each a positive multiple of 4; stream is a
// cudaStream_t.
extern "C" int gaussian_blur_launch(const void* x, void* out, int n, int h,
                                    int w, const float* taps, int radius,
                                    int strip, int chunk, void* stream) {
  if (radius < 0 || radius > kMaxRadius || strip <= 0 || strip % 4 != 0 ||
      chunk <= 0 || chunk % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = smem_words(strip, chunk, radius) * 4;
  const long long strips = (h + strip - 1) / strip;
  const long long chunks = (w + chunk - 1) / chunk;
  if (smem > kSmemLimit || strips > kMaxGridYZ || chunks > kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps t;
  for (int i = 0; i < 2 * radius + 1; ++i) t.v[i] = taps[i];
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int k = kernel_index(radius);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_smem(k);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const BlurKernel kernel = kKernels[k];
  const dim3 grid(n, static_cast<unsigned>(strips),
                  static_cast<unsigned>(chunks));
  kernel<<<grid, dim3(kThreadsX, kThreadsY), static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), h, w, radius,
      strip, chunk, vec, t);
  return static_cast<int>(cudaGetLastError());
}
