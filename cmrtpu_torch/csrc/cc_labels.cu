// 4-connected component labels of a stack of binary masks, for Hopper
// (sm_90a). Replaces the TPU kernel
// cmrtpu/ops/pallas_kernels.py::converge_labels_pallas.
//
// Contract (identical to the reference): every foreground pixel ends with the
// minimum linear index (row * W + col) of its 4-connected component, and
// background holds the sentinel 2**30. That fixed point is unique, so any
// sweep order reaches the same labels: this kernel sweeps in place
// (Gauss-Seidel), where the reference sweeps out of place (Jacobi).
//
// Design: one thread block per slice (grid = N). The slice's int32 labels
// live in dynamic shared memory for all sweeps (224 x 224 x 4 B = 200,704 B
// of the 232,448 B a block may opt into); the mask is not kept, since
// background stays at the sentinel. Threads stride over the pixels and take
// the min with the four neighbours in place. Labels only decrease and 32-bit
// shared-memory accesses are atomic, so a racing read sees an old or a new
// label of the same component, both valid. __syncthreads_or(changed) ends
// the loop: a sweep in which no thread wrote anything is a true fixed point.
// Each sweep carries every component's minimum at least one pixel further
// and no path is longer than H * W pixels, so H * W sweeps always reach the
// fixed point; that is the loop's only bound.
//
// What bounds it on an H100: one block per slice gives only N (about 10 for
// a short-axis study) of the 132 SMs per launch, and every sweep ends in a
// block-wide barrier, so the time is sweeps x (H * W / 1024 pixel visits +
// one barrier) on a few SMs. Later work: one launch for both label values
// (2N blocks), or union-find with min-root linking, which needs a few
// passes instead of one sweep per step of the longest geodesic.
//
// Launches on the caller's stream, does not synchronise and allocates
// nothing. Returns cudaGetLastError() (0 on success).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = 1 << 30;
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
cc_labels_kernel(const uint8_t* __restrict__ masks, int32_t* __restrict__ labels,
                 int h, int w) {
  extern __shared__ int32_t lab[];
  const int hw = h * w;
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;

  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    lab[i] = masks[base + i] ? i : kInf;
  }
  __syncthreads();

  for (int it = 0; it < hw; ++it) {
    int changed = 0;
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      const int32_t v = lab[i];
      if (v == kInf) continue;  // background never changes
      const int r = i / w;
      const int c = i - r * w;
      int32_t m = v;
      if (r > 0) m = min(m, lab[i - w]);
      if (r + 1 < h) m = min(m, lab[i + w]);
      if (c > 0) m = min(m, lab[i - 1]);
      if (c + 1 < w) m = min(m, lab[i + 1]);
      if (m < v) {
        lab[i] = m;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    labels[base + i] = lab[i];
  }
}

}  // namespace

// masks: uint8 [n, h, w] (nonzero = foreground); labels: int32 [n, h, w].
// Both contiguous on the current device; stream is a cudaStream_t.
extern "C" int cc_labels_launch(const void* masks, void* labels, int n, int h,
                                int w, void* stream) {
  const size_t smem = static_cast<size_t>(h) * w * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      cc_labels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_labels_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<int32_t*>(labels), h, w);
  return static_cast<int>(cudaGetLastError());
}
