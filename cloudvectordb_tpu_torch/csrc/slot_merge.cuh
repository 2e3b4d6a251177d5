// Bucketed-slot merge shared by the scan kernels (tiles_resid.cu and
// tiles_scan.cu); its plain PyTorch twin is ops/band.py::_bucket_merge.
//
// Each query keeps L = l_buckets slots. Within one arena tile, slot b takes
// the best of rows base + r*L + b over r = 0..R-1 (R = tile_n / L), the
// smallest r winning ties: tile_take, called for r in increasing order.
// Across steps a strict '>' keeps the earlier step's row on ties:
// slot_merge. Slots start at (-inf, row 0): slot_init.

#pragma once

#include <cmath>

__device__ __forceinline__ void slot_init(float& v, int& i) {
  v = -INFINITY;
  i = 0;
}

// r == 0 seeds the tile's running maximum; a later r replaces it only if
// strictly greater, so the smallest r wins ties.
__device__ __forceinline__ void tile_take(float s, int r, float& mx, int& r_best) {
  if (r == 0 || s > mx) {
    mx = s;
    r_best = r;
  }
}

// The tile's best (value mx at arena row `row`) replaces the slot only if
// strictly greater: the earlier step wins ties.
__device__ __forceinline__ void slot_merge(float mx, long long row, float& v, int& i) {
  if (mx > v) {
    v = mx;
    i = static_cast<int>(row);
  }
}
