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
// Design: K2's tiled union-find (cc_labels.cu) extended to 26-connectivity,
// in three launches on the caller's stream, with the int32 output itself as
// the parent array (no scratch). A tile is 32 columns (a warp's lanes) x 8
// rows x `depth` slices of one volume; the wrapper picks the depth
// (ops/cuda_kernels.py cc3d_geometry: at most 16, the volume's slices split
// evenly, so a study of 6-16 slices is one tile deep):
//   1. local: one 1,024-thread block per tile, grid (tiles, volumes). A
//      ballot gives each voxel the first voxel of its run in the row as
//      parent, so no union is needed along x. join_runs then names, for
//      each run, the runs it touches in its backward rows inside the tile
//      (the row above in its slice, rows y-1, y, y+1 of the slice before),
//      less the unions two others imply; the pairs of run starts go to a
//      queue in shared memory, and all the block's threads unite the queue
//      there. Tile-local indices (lz, ly, lx) order a tile's voxels as
//      their volume-linear indices do, so a tile root is its component's
//      least index inside the tile; every voxel's tile root goes out as a
//      volume-linear index;
//   2. face: per tile, the voxels of its lower faces (the top row of each
//      slice where y0 > 0, the left column of each slice where x0 > 0, the
//      front slice where z0 > 0) against their neighbours in the tiles
//      before it in (tz, ty, tx) order, which covers every adjacent pair
//      across tiles once: join_runs along the face's rows (columns for the
//      left face), plus lanes 0 and 31 of a row against the voxels at x0 - 1
//      and x0 + 32, which lie in the diagonal tiles. Unions in device
//      memory, between the two sides' current parents, one per pair of
//      parents in a warp's round; 4-warp blocks, a tile's only as many as
//      it has faces;
//   3. flatten: every foreground voxel writes the root of its tree, four
//      voxels a thread.
// join_runs: under 26-connectivity a voxel touches lanes k - 1, k and k + 1
// of a neighbour row, so one maximal run of r & dilate(p) may span two runs
// of p one background voxel apart. The rule unites at the first lane of
// every run of r & p, and at every lane whose run of r meets a run of p
// across a diagonal only; it needs each window's runs to be trees already
// (tests/test_torch_cc3d.py proves it on every pair of short windows).
// Linking is by min root through atomicMin, and the finds of the unions
// split paths (union_find.cuh, shared with cc_labels.cu); phase 3 writes
// roots. So the final labels are the components' minimum indices whatever
// order the atomics run in.
//
// What bounds it on an H100: memory, at 1 B read and 4 B written per voxel
// (2.51 MB for a [10, 224, 224] study: 0.75 us at 3.35 TB/s). Each pass is
// one pass over the voxels (the face pass over the faces and their
// neighbours), and device memory sees unions only across tile faces, where
// the one-thread-per-voxel design this replaced made up to 13 a voxel. What
// holds it back instead: on sparse masks the floor of three launches; on
// dense ones the local pass's unions, each a few shared-memory atomics
// that the threads of a tile's one large component contend for (PERF.md).
//
// Does not synchronise and allocates nothing. Returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a depth outside [1, 16].

#include <cstdint>

#include <cuda_runtime.h>

#include "union_find.cuh"

namespace {

constexpr int32_t kInf = 1 << 30;
constexpr int kLanes = 32;       // tile columns: a warp's lanes
constexpr int kRows = 8;         // tile rows; shifts assume 8
constexpr int kMaxDepth = 16;    // slices of a tile (cuda_kernels.py)
constexpr int kLocalWarps = 32;  // local pass: the tile's rows over them
constexpr int kRowsPerWarp = kMaxDepth * kRows / kLocalWarps;
// union pairs (tile-local indices a << 12 | b) a local block gathers, so
// that all its threads share the unions, not only a row's few lanes
constexpr int kQueue = 4096;
constexpr int kFaceWarps = 4;    // face pass: a block's warps
constexpr int kThreads = 256;    // flatten
constexpr int kFlatPer = 4;      // flatten: voxels a thread, loads in flight
constexpr int kMaxGridY = 65535;
static_assert(kLanes * kRows == 256, "tile-local index: lz << 8");
static_assert(kMaxDepth * kRows * kLanes <= 1 << 12, "12-bit pair halves");
static_assert(4 * kRows == kLanes, "left face: 4 slices of 8 rows a warp");
static_assert(kMaxDepth == 4 * kFaceWarps, "left face: one block");

constexpr uint32_t kAll = 0xffffffffu;
// lanes that start and end a window: a row of 32 columns; 4 columns of 8
constexpr uint32_t kRowFirst = 0x00000001u, kRowLast = 0x80000000u;
constexpr uint32_t kColFirst = 0x01010101u, kColLast = 0x80808080u;

// join_runs: the unions that join the foreground voxel at `lane` of a
// window whose foreground lanes are r with a window p of neighbours, whose
// lane k touches lanes k - 1, k and k + 1 of r; the runs of each window
// must be trees already. Bit dx + 1 of the result: unite with p's voxel at
// lane + dx. One union at the first lane of each run of r & p; where p is
// background at this lane, one with p's voxel before (after) it when that
// one is foreground and r's is not, so a run of r that meets a run of p
// across a diagonal only is joined at its end. kFirst and kLast mark the
// lanes with no neighbour before or after them in the window.
template <uint32_t kFirst, uint32_t kLast>
__device__ __forceinline__ uint32_t join_runs(uint32_t r, uint32_t p,
                                              int lane) {
  const uint32_t bit = 1u << lane;
  const uint32_t r_before = (r << 1) & ~kFirst, p_before = (p << 1) & ~kFirst;
  const uint32_t r_after = (r >> 1) & ~kLast, p_after = (p >> 1) & ~kLast;
  if (p & bit) return r_before & p_before & bit ? 0u : 2u;
  return (p_before & ~r_before & bit ? 1u : 0u) |
         (p_after & ~r_after & bit ? 4u : 0u);
}

// first lane of the run of a row's foreground lanes `bits` holding `lane`
__device__ __forceinline__ int run_start(uint32_t bits, int lane) {
  const uint32_t bg_before = ~bits & ((1u << lane) - 1u);
  return bg_before ? 32 - __clz(bg_before) : 0;
}

// lanes of the run of `bits` holding `lane`, and one more on either side
__device__ __forceinline__ uint32_t run_around(uint32_t bits, int lane) {
  const uint32_t bg_after = ~bits & ~((2u << lane) - 1u);
  const uint32_t below_end =
      bg_after ? (1u << (__ffs(bg_after) - 1)) - 1u : kAll;
  const uint32_t run = below_end & ~((1u << run_start(bits, lane)) - 1u);
  return run | run << 1 | run >> 1;
}

// Bits dx + 1 (as join_runs') of the lanes lane + dx of a neighbour row
// that touch a voxel of rows q which touches this lane's run (`around`:
// run_around). Such a union is implied by two others: the run's with that
// voxel's run, and that run's with the neighbour
__device__ __forceinline__ uint32_t implied(uint32_t around, uint32_t q,
                                            int lane) {
  const uint32_t near = q & around;
  const uint32_t reach = near | near << 1 | near >> 1;
  return (lane ? reach >> (lane - 1) : reach << 1) & 7u;
}

struct Tile {
  int x0, y0, z0, slices;  // origin and slices inside the volume
};

// tile b of a volume, tiles in (tz, ty, tx) order
__device__ __forceinline__ Tile tile_of(int b, int d, int h, int w,
                                        int depth) {
  const int tiles_x = (w + kLanes - 1) / kLanes;
  const int tiles_y = (h + kRows - 1) / kRows;
  Tile t;
  t.x0 = b % tiles_x * kLanes;
  t.y0 = b / tiles_x % tiles_y * kRows;
  t.z0 = b / tiles_x / tiles_y * depth;
  t.slices = min(depth, d - t.z0);
  return t;
}

// Tile row `row` = lz * kRows + ly holds lanes x0..x0+31 of row y0 + ly of
// slice z0 + lz; warp w takes rows w, w + 32, ...
__global__ void __launch_bounds__(kLanes * kLocalWarps, 2)
cc3d_local_kernel(const uint8_t* __restrict__ masks,
                  int32_t* __restrict__ labels, int d, int h, int w,
                  int depth) {
  // tile-local parents, index row * 32 + lx; -1 = background
  __shared__ int32_t tile[kMaxDepth * kRows * kLanes];
  __shared__ uint32_t row_bits[kMaxDepth * kRows];  // foreground lanes
  __shared__ uint32_t queue[kQueue];
  __shared__ int queued;
  const Tile t = tile_of(blockIdx.x, d, h, w, depth);
  const int lx = threadIdx.x, warp = threadIdx.y;
  if (lx == 0 && warp == 0) queued = 0;
  const int rows = t.slices * kRows;
  const int x = t.x0 + lx;
  const int32_t hw = h * w;
  const size_t base = static_cast<size_t>(blockIdx.y) * d * hw;

  // every load in flight at once, then each run of a row is one tree from
  // the start, rooted at its first voxel
  bool fg[kRowsPerWarp];
  int32_t at[kRowsPerWarp];  // the voxel's volume-linear index, -1: none
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int row = warp + k * kLocalWarps;
    const int y = t.y0 + (row & (kRows - 1));
    at[k] = row < rows && x < w && y < h
                ? (t.z0 + (row >> 3)) * hw + y * w + x : -1;
    fg[k] = at[k] >= 0 && masks[base + at[k]];
  }
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int row = warp + k * kLocalWarps;
    if (row >= rows) break;
    const uint32_t bits = __ballot_sync(kAll, fg[k]);
    if (lx == 0) row_bits[row] = bits;
    tile[row << 5 | lx] = fg[k] ? (row << 5 | run_start(bits, lx)) : -1;
  }
  __syncthreads();

  // each run with the runs it touches in the row above (n = 0) and in rows
  // y-1, y, y+1 of the slice before (n = 1, 2, 3), run start to run start,
  // but for the unions implied by others: one with row y-1 or y+1 of the
  // slice before that a voxel of its row y implies, one with the row above
  // that a voxel of rows y-1 and y of the slice before implies (each
  // implication rests on unions of an earlier slice or of a lower n, so
  // none is left out in a circle). A row's pairs go to the queue (a
  // warp's lanes in turn) and the whole block unites the queue; pairs past
  // its end are united where they are
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int row = warp + k * kLocalWarps;
    if (row >= rows) break;
    const int ly = row & (kRows - 1);
    const uint32_t r = row_bits[row];
    uint32_t targets = 0;  // bit 3 * n + dx + 1: the voxel at dx in row n
    if (fg[k]) {
      const uint32_t around = run_around(r, lx);
      if (ly > 0) {
        targets = join_runs<kRowFirst, kRowLast>(r, row_bits[row - 1], lx);
        if (row >= kRows)
          targets &= ~implied(around, row_bits[row - 9] | row_bits[row - 8],
                              lx);
      }
      if (row >= kRows) {
        const uint32_t mid = row_bits[row - 8];
        const uint32_t skip = implied(around, mid, lx);
        if (ly > 0)
          targets |= (join_runs<kRowFirst, kRowLast>(r, row_bits[row - 9],
                                                     lx) & ~skip) << 3;
        targets |= join_runs<kRowFirst, kRowLast>(r, mid, lx) << 6;
        if (ly < kRows - 1)
          targets |= (join_runs<kRowFirst, kRowLast>(r, row_bits[row - 7],
                                                     lx) & ~skip) << 9;
      }
    }
    const int count = __popc(targets);
    int upto = count;  // inclusive prefix sum over the warp's lanes
    for (int off = 1; off < kLanes; off <<= 1) {
      const int v = __shfl_up_sync(kAll, upto, off);
      if (lx >= off) upto += v;
    }
    const int total = __shfl_sync(kAll, upto, kLanes - 1);
    if (!total) continue;
    int slot = lx == kLanes - 1 ? atomicAdd(&queued, total) : 0;
    slot = __shfl_sync(kAll, slot, kLanes - 1) + upto - count;
    const uint32_t a = row << 5 | run_start(r, lx);
    while (targets) {
      const int bit = __ffs(targets) - 1;
      targets &= targets - 1;
      const int n = bit / 3;
      const int prow = row - (n ? 10 - n : 1);
      const uint32_t b =
          prow << 5 | run_start(row_bits[prow], lx + bit % 3 - 1);
      if (slot < kQueue)
        queue[slot++] = a << 12 | b;
      else
        unite(tile, a, b);
    }
  }
  __syncthreads();
  const int pairs = min(queued, kQueue);
  for (int q = warp * kLanes + lx; q < pairs; q += kLanes * kLocalWarps)
    unite(tile, queue[q] >> 12, queue[q] & 0xfff);
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    if (at[k] < 0) continue;
    int32_t label = kInf;
    if (fg[k]) {
      const int32_t root =
          find_root<false>(tile, (warp + k * kLocalWarps) << 5 | lx);
      label = (t.z0 + (root >> 8)) * hw
              + (t.y0 + (root >> 5 & (kRows - 1))) * w + t.x0
              + (root & (kLanes - 1));
    }
    labels[base + at[k]] = label;
  }
}

// A warp: unites each lane's voxel i with the voxels its `targets` name
// (bit 3 * n + d + 1: voxel j + (n - 1) * step + d * side), in device
// memory, each side through its current parent (an ancestor: the same
// tree). A lane skips a parent it has just united with, and of the lanes
// that hold the same pair of parents in a round only the first unites
__device__ __forceinline__ void unite_targets(int32_t* parent, int lane,
                                              uint32_t targets, int32_t i,
                                              int32_t j, int32_t step,
                                              int32_t side) {
  const volatile int32_t* vparent = parent;
  const int rounds = __reduce_max_sync(kAll, __popc(targets));
  const int32_t a = targets ? vparent[i] : 0;
  int32_t last = -1;
  for (int round = 0; round < rounds; ++round) {
    uint64_t key = ~0ull;  // no pair this round
    if (targets) {
      const int bit = __ffs(targets) - 1;
      targets &= targets - 1;
      const int32_t b =
          vparent[j + (bit / 3 - 1) * step + (bit % 3 - 1) * side];
      if (b != last)
        key = static_cast<uint64_t>(a) << 32 | static_cast<uint32_t>(b);
      last = b;
    }
    const uint32_t same = __match_any_sync(kAll, key);
    if (key != ~0ull && __ffs(same) - 1 == lane)
      unite(parent, a, static_cast<int32_t>(key & 0xffffffffu));
  }
}

// A warp: the row of a tile's lower face whose voxel at this lane is i
// (col: the lane's column lies in the volume) against up to three rows of
// the same 32 columns in tiles before it, whose voxels at this lane are
// j - step, j and j + step (lo, hi: whether the first and the last exist).
// join_runs inside the window, and across its sides lane 0 with the voxel
// at x0 - 1 and lane 31 with the one at x0 + 32, which lie in the tiles
// diagonal to this one
__device__ __forceinline__ void join_face_row(const uint8_t* m,
                                              int32_t* parent, int lane,
                                              bool col, int32_t i, int32_t j,
                                              int32_t step, bool lo, bool hi,
                                              int x0, int w) {
  const bool fg = col && m[i];
  const uint32_t r = __ballot_sync(kAll, fg);
  if (!r) return;
  uint32_t targets = 0;  // bit 3 * n + dx + 1: the voxel at dx in row n
  for (int n = 0; n < 3; ++n) {
    if ((n == 0 && !lo) || (n == 2 && !hi)) continue;
    const int32_t jn = j + (n - 1) * step;
    const uint32_t p = __ballot_sync(kAll, col && m[jn]);
    if (!fg) continue;
    uint32_t c = join_runs<kRowFirst, kRowLast>(r, p, lane);
    if (lane == 0 && x0 > 0 && m[jn - 1]) c |= 1u;
    if (lane == kLanes - 1 && x0 + kLanes < w && m[jn + 1]) c |= 4u;
    targets |= c << 3 * n;
  }
  unite_targets(parent, lane, targets, i, j, step, 1);
}

// Every pair of adjacent voxels in two tiles is joined here once, from the
// tile later in (tz, ty, tx) order, whose voxel lies on its front slice
// (the tile before in z), its top row (the tile before in y, same z tile)
// or its left column (the tile before in x, same y and z tiles). Rows and
// columns past a tile's faces (above the left column, beside the top row)
// are the top and front faces' lanes 0 and 31. A tile's `per_tile` blocks
// of 4 warps: first its top rows, a warp a slice; then its left columns, a
// warp per 4 slices; then, where the volume is more than one tile deep,
// its front slice, a warp a row
__global__ void __launch_bounds__(kLanes * kFaceWarps)
cc3d_face_kernel(const uint8_t* __restrict__ masks, int32_t* labels, int d,
                 int h, int w, int depth, int per_tile) {
  const Tile t = tile_of(blockIdx.x / per_tile, d, h, w, depth);
  const int lx = threadIdx.x;
  const int top_blocks = (depth + kFaceWarps - 1) / kFaceWarps;
  const int task = blockIdx.x % per_tile;
  const int32_t hw = h * w;
  const size_t base = static_cast<size_t>(blockIdx.y) * d * hw;
  const uint8_t* m = masks + base;
  int32_t* parent = labels + base;
  const int x = t.x0 + lx;
  const bool col = x < w;

  if (task < top_blocks) {
    // top row of slice lz against row y0 - 1 of slices lz-1, lz, lz+1
    const int lz = task * kFaceWarps + threadIdx.y;
    if (t.y0 == 0 || lz >= t.slices) return;
    const int32_t i = (t.z0 + lz) * hw + t.y0 * w + x;
    join_face_row(m, parent, lx, col, i, i - w, hw, lz > 0,
                  lz + 1 < t.slices, t.x0, w);
  } else if (task == top_blocks) {
    // left columns of 4 slices, 8 lanes a column (the tile's rows),
    // against column x0 - 1 of slices lz-1, lz, lz+1
    const int lz = threadIdx.y * 4 + (lx >> 3);
    if (t.x0 == 0 || threadIdx.y * 4 >= t.slices) return;
    const int yc = t.y0 + (lx & (kRows - 1));
    const bool in = lz < t.slices && yc < h;
    const int32_t i = (t.z0 + lz) * hw + yc * w + t.x0;
    const bool fg = in && m[i];
    const uint32_t r = __ballot_sync(kAll, fg);
    if (!r) return;
    uint32_t targets = 0;  // bit 3 * n + dy + 1: the voxel at dy, slice n
    for (int n = 0; n < 3; ++n) {
      const bool slice_in = in && lz + n - 1 >= 0 && lz + n - 1 < t.slices;
      const uint32_t p =
          __ballot_sync(kAll, slice_in && m[i + (n - 1) * hw - 1]);
      if (fg) targets |= join_runs<kColFirst, kColLast>(r, p, lx) << 3 * n;
    }
    unite_targets(parent, lx, targets, i, i - 1, hw, w);
  } else {
    // front slice row y against rows y-1, y, y+1 of slice z0 - 1
    const int y = t.y0 + (task - top_blocks - 1) * kFaceWarps + threadIdx.y;
    if (t.z0 == 0 || y >= h) return;
    join_face_row(m, parent, lx, col, t.z0 * hw + y * w + x,
                  (t.z0 - 1) * hw + y * w + x, w, y > 0, y + 1 < h, t.x0, w);
  }
}

// Runs after the face unions, so roots no longer change: plain loads, which
// L1 may serve with an older parent, still walk up the same tree. A thread
// takes kFlatPer voxels, a block's width apart, their loads in flight
// together
__global__ void __launch_bounds__(kThreads)
cc3d_flatten_kernel(int32_t* labels, int32_t vol) {
  int32_t* parent = labels + static_cast<size_t>(blockIdx.y) * vol;
  const int32_t i0 = blockIdx.x * kThreads * kFlatPer + threadIdx.x;
  int32_t p[kFlatPer], q[kFlatPer];
#pragma unroll
  for (int k = 0; k < kFlatPer; ++k) {
    const int32_t i = i0 + k * kThreads;
    p[k] = i < vol ? parent[i] : kInf;
  }
#pragma unroll
  for (int k = 0; k < kFlatPer; ++k)
    q[k] = p[k] == kInf || p[k] == i0 + k * kThreads ? p[k] : parent[p[k]];
#pragma unroll
  for (int k = 0; k < kFlatPer; ++k) {
    if (q[k] == p[k]) continue;  // background, a root, or a root's child
    int32_t root = q[k];
    for (int32_t n = parent[root]; n != root; n = parent[root]) root = n;
    parent[i0 + k * kThreads] = root;
  }
}

}  // namespace

// masks: uint8 [n, d, h, w] (nonzero = foreground); labels: int32
// [n, d, h, w]. Both contiguous on the current device; d * h * w < 2**30;
// depth: the slices of a tile, 1-16; stream is a cudaStream_t. Volumes go
// in chunks of at most 65,535 (the grid's y limit).
extern "C" int cc_labels_3d_launch(const void* masks, void* labels, int n,
                                   int d, int h, int w, int depth,
                                   void* stream) {
  if (depth < 1 || depth > kMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int32_t vol = d * h * w;
  const int tiles_z = (d + depth - 1) / depth;
  const unsigned tiles =
      ((w + kLanes - 1) / kLanes) * ((h + kRows - 1) / kRows) * tiles_z;
  // face blocks a tile: its top rows, its left columns, its front slice
  const int per_tile = (depth + kFaceWarps - 1) / kFaceWarps + 1 +
                       (tiles_z > 1 ? kRows / kFaceWarps : 0);
  const unsigned blocks =
      (vol + kThreads * kFlatPer - 1) / (kThreads * kFlatPer);
  for (int v0 = 0; v0 < n; v0 += kMaxGridY) {
    const int chunk = n - v0 < kMaxGridY ? n - v0 : kMaxGridY;
    const auto* m = static_cast<const uint8_t*>(masks) +
                    static_cast<size_t>(v0) * vol;
    auto* lab = static_cast<int32_t*>(labels) + static_cast<size_t>(v0) * vol;
    cc3d_local_kernel<<<dim3(tiles, chunk), dim3(kLanes, kLocalWarps), 0,
                        s>>>(m, lab, d, h, w, depth);
    cc3d_face_kernel<<<dim3(tiles * per_tile, chunk), dim3(kLanes,
                                                           kFaceWarps),
                       0, s>>>(m, lab, d, h, w, depth, per_tile);
    cc3d_flatten_kernel<<<dim3(blocks, chunk), kThreads, 0, s>>>(lab, vol);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
