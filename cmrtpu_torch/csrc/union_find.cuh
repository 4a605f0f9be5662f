// Concurrent union-find on an int32 parent array (device or shared memory),
// shared by the CC kernels (cc_labels.cu, cc_labels_3d.cu).
//
// Linking is by min root: the larger root's parent becomes the smaller root
// through atomicMin, retried from the old parent when the root had moved.
// Finds may split paths (each visited node is pointed at its grandparent by
// atomicMin). So a parent never rises and is never larger than its child,
// the root of every tree is its least index, and once every union is done
// each tree's root is its component's least index whatever order the
// atomics ran in. Reads of parents that other threads write go through
// volatile loads (no L1 copy).

#pragma once

#include <cstdint>

namespace {

// root of a's tree; a parent is never larger than its child, so the walk
// ends. kSplit: point each visited node at its grandparent on the way
// (path splitting, by atomicMin, so a parent still only decreases), which
// keeps the chains short that min-root linking builds
template <bool kSplit>
__device__ __forceinline__ int32_t find_root(int32_t* parent, int32_t a) {
  const volatile int32_t* vparent = parent;
  int32_t p = vparent[a];
  while (p != a) {
    const int32_t gp = vparent[p];
    if (kSplit && gp != p) atomicMin(parent + a, gp);
    a = p;
    p = gp;
  }
  return a;
}

// union of a's and b's trees: the larger root is linked under the smaller
__device__ __forceinline__ void unite(int32_t* parent, int32_t a, int32_t b) {
  while (true) {
    a = find_root<true>(parent, a);
    b = find_root<true>(parent, b);
    if (a == b) return;
    if (a > b) {
      const int32_t t = a;
      a = b;
      b = t;
    }
    // b is the larger root: point it at a, unless it already moved under
    // some old parent, which then has to be joined with a instead
    const int32_t old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

}  // namespace
