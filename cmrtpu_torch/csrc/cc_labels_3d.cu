// 26-connected component labels of a stack of binary volumes, for Hopper
// (sm_90a). Replaces cmrtpu/ops/connected_components.py::label_components_3d,
// which the reference runs as an XLA while_loop of 26-neighbourhood min
// sweeps (no Pallas kernel).
//
// Contract (identical to the reference): every foreground voxel ends with the
// minimum volume-linear index (z * H * W + y * W + x) of its 26-connected
// component, and background holds the sentinel 2**30. Each volume of the
// stack is labelled on its own, with its own indices; Z * H * W < 2**30.
//
// Design: a union-find over the whole volume in device memory, in three
// launches on the caller's stream, with the int32 output as the parent array
// (no scratch):
//   1. init: one thread per voxel; a foreground voxel is its own parent,
//      background takes the sentinel;
//   2. union: one thread per foreground voxel, one union with each of its 13
//      "backward" neighbours of the 26 (the 9 of the slice before, the 3 of
//      the row above, the one to the left) that is foreground. Every
//      adjacent pair is joined once, from its later voxel;
//   3. flatten: every foreground voxel writes the root of its tree.
// Linking is by min root through atomicMin, and finds split paths
// (union_find.cuh, shared with cc_labels.cu). So the final labels are the
// components' minimum indices whatever order the atomics run in.
//
// What bounds it on an H100: memory, at 1 B read and 4 B written per voxel
// (2.51 MB for a [10, 224, 224] study: 0.75 us at 3.35 TB/s). This first
// version is simple rather than fast: every union walks parents in device
// memory (L2 holds the 2 MB of labels), and a dense volume takes up to 13
// unions per voxel, each with two finds and atomics. The time does not grow
// with the longest geodesic as the reference's sweeps do.
//
// Does not synchronise and allocates nothing. Returns cudaGetLastError()
// (0 on success).

#include <cstdint>

#include <cuda_runtime.h>

#include "union_find.cuh"

namespace {

constexpr int32_t kInf = 1 << 30;
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
cc3d_init_kernel(const uint8_t* __restrict__ masks, int32_t* __restrict__ labels,
                 int32_t vol) {
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= vol) return;
  const size_t at = static_cast<size_t>(blockIdx.y) * vol + i;
  labels[at] = masks[at] ? i : kInf;
}

__global__ void __launch_bounds__(kThreads)
cc3d_union_kernel(const uint8_t* __restrict__ masks, int32_t* labels, int d,
                  int h, int w) {
  const int32_t hw = h * w;
  const int32_t vol = d * hw;
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= vol) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * vol;
  const uint8_t* m = masks + base;
  if (!m[i]) return;
  int32_t* parent = labels + base;
  const int x = i % w;
  const int y = (i / w) % h;
  const int z = i / hw;
  // the 13 neighbours that come before i in volume-linear order
#pragma unroll
  for (int k = 0; k < 13; ++k) {
    const int dz = k < 9 ? -1 : 0;
    const int dy = k < 9 ? k / 3 - 1 : (k < 12 ? -1 : 0);
    const int dx = k < 9 ? k % 3 - 1 : (k < 12 ? k - 10 : -1);
    const int zz = z + dz, yy = y + dy, xx = x + dx;
    if (zz < 0 || yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
    const int32_t j = zz * hw + yy * w + xx;
    if (m[j]) unite(parent, i, j);
  }
}

// Runs after the unions, so roots no longer change: plain loads, which L1
// may serve with an older parent, still walk up the same tree
__global__ void __launch_bounds__(kThreads)
cc3d_flatten_kernel(int32_t* labels, int32_t vol) {
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= vol) return;
  int32_t* parent = labels + static_cast<size_t>(blockIdx.y) * vol;
  const int32_t p = parent[i];
  if (p == kInf || p == i) return;  // background, or a root
  int32_t root = p;
  for (int32_t q = parent[root]; q != root; q = parent[root]) root = q;
  if (root != p) parent[i] = root;
}

}  // namespace

// masks: uint8 [n, d, h, w] (nonzero = foreground); labels: int32
// [n, d, h, w]. Both contiguous on the current device; d * h * w < 2**30;
// stream is a cudaStream_t. Volumes go in chunks of at most 65,535 (the
// grid's y limit).
extern "C" int cc_labels_3d_launch(const void* masks, void* labels, int n,
                                   int d, int h, int w, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int32_t vol = d * h * w;
  const unsigned blocks = (vol + kThreads - 1) / kThreads;
  for (int v0 = 0; v0 < n; v0 += kMaxGridY) {
    const dim3 grid(blocks, n - v0 < kMaxGridY ? n - v0 : kMaxGridY);
    const auto* m = static_cast<const uint8_t*>(masks) +
                    static_cast<size_t>(v0) * vol;
    auto* lab = static_cast<int32_t*>(labels) + static_cast<size_t>(v0) * vol;
    cc3d_init_kernel<<<grid, kThreads, 0, s>>>(m, lab, vol);
    cc3d_union_kernel<<<grid, kThreads, 0, s>>>(m, lab, d, h, w);
    cc3d_flatten_kernel<<<grid, kThreads, 0, s>>>(lab, vol);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
