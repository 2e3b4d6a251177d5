// Bucketed-slot merge shared by the scan kernels (tiles_resid.cu,
// tiles_scan.cu and pq_scan.cu); its plain PyTorch twins are
// ops/band.py::_bucket_merge and, for top-2, ::_bucket_merge_top2.
//
// Each query keeps L = l_buckets slots. Within one arena tile, slot b takes
// the best of rows base + r*L + b over r = 0..R-1 (R = tile_n / L), the
// smallest r winning ties: tile_take, called for r in increasing order.
// Across steps a strict '>' keeps the earlier step's row on ties:
// slot_merge. Slots start at (-inf, row 0): slot_init.
//
// Top-2 (tile_take2, slot_merge2): a bucket keeps its best two distinct
// rows, slot 1 and slot 2, under the reference's rules
// (cloudvectordb_tpu/ops/pallas_pq.py:255-292).

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

// The tile's best (mx, r_best) and its runner-up (mx2, r2): the best row
// other than the winner, the smallest r on ties. Called for r in increasing
// order; r == 0 seeds both (the runner-up at (-inf, 0)).
__device__ __forceinline__ void tile_take2(float s, int r, float& mx, int& r_best, float& mx2,
                                           int& r2) {
  if (r == 0) {
    mx = s;
    r_best = 0;
    mx2 = -INFINITY;
    r2 = 0;
  } else if (s > mx) {
    mx2 = mx;
    r2 = r_best;
    mx = s;
    r_best = r;
  } else if (s > mx2) {
    mx2 = s;
    r2 = r;
  }
}

// Merge the tile's best (mx at `row`) and runner-up (mx2 at `row2`) into
// slot 1 (v1, i1) and slot 2 (v2, i2). Slot 1 takes the tile's best only if
// strictly greater. The loser of that pair races max(slot 2, runner-up) for
// slot 2 and wins only if strictly greater; a tile best that is the row
// already in slot 1 (a repeated table entry) does not race.
__device__ __forceinline__ void slot_merge2(float mx, long long row, float mx2, long long row2,
                                            float& v1, int& i1, float& v2, int& i2) {
  const int ni = static_cast<int>(row);
  const bool use_t = mx > v1;
  const bool dup = !use_t && ni == i1;
  const float lo = dup ? -INFINITY : (use_t ? v1 : mx);
  const int lo_i = use_t ? i1 : ni;
  const float c2 = fmaxf(v2, mx2);
  const int c2_i = mx2 > v2 ? static_cast<int>(row2) : i2;
  if (use_t) {
    v1 = mx;
    i1 = ni;
  }
  if (lo > c2) {
    v2 = lo;
    i2 = lo_i;
  } else {
    v2 = c2;
    i2 = c2_i;
  }
}
