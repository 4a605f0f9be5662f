// 4-connected component labels of a stack of binary masks, for Hopper
// (sm_90a). Replaces the TPU kernel
// cmrtpu/ops/pallas_kernels.py::converge_labels_pallas.
//
// Contract (identical to the reference): every foreground pixel ends with the
// minimum slice-linear index (row * W + col) of its 4-connected component,
// and background holds the sentinel 2**30. The reference reaches that unique
// fixed point by min-label sweeps; this kernel reaches it by union-find.
//
// Design: a block union-find in three launches on the caller's stream, with
// the int32 output itself as the parent array (no scratch):
//   1. local: one 512-thread block per (32 x 32 tile, slice), grid
//      (ceil(W/32), ceil(H/32), N), whole tile rows to a warp. A ballot
//      gives each pixel the first pixel of its run in the row as parent, so
//      no union is needed along a row; then one union in shared memory per
//      overlap of a run with a run of the row above. Every pixel's tile root
//      goes out as a slice-linear index (background: the sentinel);
//   2. merge: across each tile's top row and left column, one union in
//      device memory per run of pixel pairs that are both foreground;
//   3. flatten: every foreground pixel writes the root of its tree.
// Linking is by min root through atomicMin, and the finds of the unions
// split paths (union_find.cuh); phase 3 writes roots. So the final labels
// are the components' minimum indices whatever order the atomics run in.
// Tile-local indices ly * 32 + lx order a tile's pixels as their
// slice-linear indices do, so a tile root is its component's least index
// inside the tile.
//
// What bounds it on an H100: memory, at 1 B read and 4 B written per pixel
// (5.02 MB at the serving path's stacked [20, 224, 224]: 1.5 us at 3.35
// TB/s). Every pass is one pass over the pixels, so the time does not grow
// with the longest geodesic as the reference's min-label sweeps do, and the
// labels (4 MB) stay in the 50 MB L2 between the launches. The tiles give
// 980 blocks at [20, 224, 224] for 132 SMs, where a block per slice would
// give 20, and a tile's 4 KiB of shared memory sets no limit on the slice
// size. Indexing uses shifts and masks only (the tile side is 32). On the
// sparse masks of the serving path each pass is near the floor of a launch
// of ~1,000 blocks; dense masks spend most in the tile-local unions.
//
// Does not synchronise and allocates nothing. Returns cudaGetLastError()
// (0 on success).

#include <cstdint>

#include <cuda_runtime.h>

#include "union_find.cuh"

namespace {

constexpr int32_t kInf = 1 << 30;
constexpr int kTile = 32;          // tile side; shifts below assume 32
constexpr int kRows = 16;          // thread rows per block: kTile x kRows
constexpr int kPerThread = kTile / kRows;
constexpr int kMaxGridZ = 65535;

__global__ void __launch_bounds__(kTile * kRows)
cc_local_kernel(const uint8_t* __restrict__ masks, int32_t* __restrict__ labels,
                int h, int w) {
  __shared__ int32_t tile[kTile * kTile];  // tile-local parents, -1 = bg
  __shared__ uint32_t row_bits[kTile];     // foreground lanes of each row
  const int lx = threadIdx.x;              // a warp is one tile row
  const int x = blockIdx.x * kTile + lx;
  const int y0 = blockIdx.y * kTile;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;

  // each run of a row is one tree from the start, rooted at its first pixel
  bool fg[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int ly = threadIdx.y + k * kRows;
    const int y = y0 + ly;
    fg[k] = x < w && y < h && masks[base + static_cast<size_t>(y) * w + x];
    const uint32_t bits = __ballot_sync(0xffffffffu, fg[k]);
    if (lx == 0) row_bits[ly] = bits;
    const uint32_t bg_left = ~bits & ((1u << lx) - 1u);
    const int start = bg_left ? 32 - __clz(bg_left) : 0;
    tile[(ly << 5) | lx] = fg[k] ? ((ly << 5) | start) : -1;
  }
  __syncthreads();

  // one union per overlap of a run with a run of the row above, at the
  // overlap's first pixel
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int ly = threadIdx.y + k * kRows;
    if (ly == 0) continue;
    const uint32_t both = row_bits[ly] & row_bits[ly - 1];
    const uint32_t first = both & ~(both << 1);
    const int i = (ly << 5) | lx;
    if ((first >> lx) & 1u) unite(tile, i, i - kTile);
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int ly = threadIdx.y + k * kRows;
    const int y = y0 + ly;
    if (x >= w || y >= h) continue;
    int32_t out = kInf;
    if (fg[k]) {
      const int32_t root = find_root<false>(tile, (ly << 5) | lx);
      out = (y0 + (root >> 5)) * w + blockIdx.x * kTile + (root & (kTile - 1));
    }
    labels[base + static_cast<size_t>(y) * w + x] = out;
  }
}

// warp 0: the tile's top row against the row above; warp 1: its left column
// against the column to its left. One union per run of pairs that are both
// foreground, at the run's first pair: the rest of the run is joined to it
// inside the two tiles already
__global__ void __launch_bounds__(2 * kTile)
cc_merge_kernel(const uint8_t* __restrict__ masks, int32_t* labels, int h,
                int w) {
  const int t = threadIdx.x & (kTile - 1);
  const bool top = threadIdx.x < kTile;
  const int y = blockIdx.y * kTile + (top ? 0 : t);
  const int x = blockIdx.x * kTile + (top ? t : 0);
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const int32_t i = y * w + x;
  const int32_t j = top ? i - w : i - 1;
  const bool pair = y < h && x < w && (top ? y > 0 : x > 0) &&
                    masks[base + i] && masks[base + j];
  const uint32_t both = __ballot_sync(0xffffffffu, pair);
  if ((both & ~(both << 1)) >> t & 1u) unite(labels + base, i, j);
}

// Runs after the merge, so roots no longer change: plain loads, which L1 may
// serve with an older parent, still walk up the same tree
__global__ void __launch_bounds__(kTile * kRows)
cc_flatten_kernel(int32_t* labels, int h, int w) {
  const int x = blockIdx.x * kTile + threadIdx.x;
  if (x >= w) return;
  int32_t* parent = labels + static_cast<size_t>(blockIdx.z) * h * w;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int y = blockIdx.y * kTile + threadIdx.y + k * kRows;
    if (y >= h) continue;
    const int32_t i = y * w + x;
    const int32_t p = parent[i];
    if (p == kInf || p == i) continue;  // background, or a root
    int32_t root = p;
    for (int32_t q = parent[root]; q != root; q = parent[root]) root = q;
    if (root != p) parent[i] = root;
  }
}

}  // namespace

// masks: uint8 [n, h, w] (nonzero = foreground); labels: int32 [n, h, w].
// Both contiguous on the current device; h * w < 2**30; stream is a
// cudaStream_t. Slices go in chunks of at most 65,535 (the grid's z limit).
extern "C" int cc_labels_launch(const void* masks, void* labels, int n, int h,
                                int w, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t hw = static_cast<size_t>(h) * w;
  const dim3 tiles((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, 1);
  for (int z0 = 0; z0 < n; z0 += kMaxGridZ) {
    const dim3 grid(tiles.x, tiles.y, n - z0 < kMaxGridZ ? n - z0 : kMaxGridZ);
    const auto* m = static_cast<const uint8_t*>(masks) + z0 * hw;
    auto* lab = static_cast<int32_t*>(labels) + z0 * hw;
    cc_local_kernel<<<grid, dim3(kTile, kRows), 0, s>>>(m, lab, h, w);
    cc_merge_kernel<<<grid, 2 * kTile, 0, s>>>(m, lab, h, w);
    cc_flatten_kernel<<<grid, dim3(kTile, kRows), 0, s>>>(lab, h, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
