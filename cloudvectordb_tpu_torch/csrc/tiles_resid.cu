// Residual-int8 tile-table scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel cloudvectordb_tpu/ops/pallas_band.py
// ::tiles_topk_resid_pallas (body _tiles_resid_kernel), in its serving
// variant: int8 queries, no row mask, inner product, one slot per bucket.
// Built by cloudvectordb_tpu_torch/ops/_cuda.py with nvcc into a shared
// library and called through ctypes; the plain PyTorch version of the same
// contract is ops/band.py::tiles_topk_resid_reference.
//
// What it computes. For query tile qt and table entry p (arena tile
// t = tile_table[qt, p]), every arena row g of tile t scores
//     C[q, local[g]] + row_scale[q] * (q8[q] . r8[g])
// where C[q, w] = bf16(q) . bf16(centroid_tiles[t, w]) with f32
// accumulation, and the int8 dot accumulates exactly in int32. Row g is
// live iff g < valid_end[t, local[g]]. Each query keeps L = l_buckets slots:
// within a tile, slot b takes the best of rows t*tile_n + r*L + b over r
// (smallest r on ties); across table entries a strict '>' keeps the earlier
// entry (csrc/slot_merge.cuh). Slots start at (-inf, row 0). The final
// top-k over the slots is done by the caller.
//
// How it maps to the card: two kernels, the score in split form.
//   - resid_centroid_kernel, a prologue: the centroid term C of every
//     (query tile, table entry) once, on the tensor cores (HMMA m16n8k16,
//     bf16 in, each 16-dim step summed from zero and added to a compensated
//     f32 sum), into a scratch of (n_qt, P, tile_q, W rounded up to 4) f32.
//     The TPU computed it inside the scan; here it would be recomputed by
//     every slot block of a query tile, or cost the scan the shared memory
//     that two blocks an SM need.
//   - resid_scan_kernel, the scan: the tensor-core body of csrc/tc_scan.cuh
//     (shared with K2, K3 and K7) with int8 queries against int8 rows, IMMA
//     m16n8k32 into int32, in its narrow block (32 queries x 128 rows, two
//     blocks an SM), with this file's epilogue (Resid): the stage that holds
//     a (step, r)'s last chunk also carries its rows' local ids, the tile's
//     valid_end, the block's row scales and the entry's centroid term, so the
//     ring's barriers order them too; a score is then two shared loads and
//     the old rounding, __fadd_rn(C, __fmul_rn(row_scale, (float)dot)). The
//     TPU needed a one-hot matmul for the centroid gather and an 8-bit radix
//     split for the validity mask; here both are shared-memory loads.
//
// What bounds it on an H100. At the serving plan (B 4096, tile_q 32, 96
// table entries of 2048-row tiles at D 768) the scan does 2 x 4096 x 96 x
// 2048 x 768 = 1.2e12 int8 operations, 0.6 ms at the int8 peak, and reads
// 6,060 distinct tiles once (9.3 GB, 2.8 ms at 3.35 TB/s): bytes bound it,
// and each tile is read by every query tile whose table holds it (12,288
// (query tile, entry) pairs, 19.3 GB if none were shared). The design does
// about it what K3's does: the queries stay in shared memory, the rows
// stream through a cp.async ring whose loads overlap the products, and
// query blocks are the fastest grid index, so blocks that read the same rows
// run together and share them in L2. The prologue reads each (query tile,
// entry)'s W centroid rows (mostly L2 hits) and writes 2 KB a pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "tc_scan.cuh"

namespace {

using C = Narrow;

// Where a stage's side data lies (bytes from the end of its rows): the
// local ids of the SB rows, from the 4-byte word that holds row0 on; the
// tile's valid_end (W ints); the block's row scales (QB floats); the
// entry's centroid term for the block's queries (QB x Wp floats, Wp = W
// rounded up to 4, so each query's row is whole 16-byte copies).
struct ResidSide {
  int loc, ve, rs, c, total;
};

__host__ __device__ inline ResidSide resid_side(int w, int wp) {
  ResidSide s;
  s.loc = 0;
  s.ve = round_up(C::SB + 4, 16);
  s.rs = s.ve + round_up(4 * w, 16);
  s.c = s.rs + 4 * C::QB;
  s.total = s.c + 4 * C::QB * wp;
  return s;
}

// K1's epilogue for the shared body (tc_scan.cuh).
struct Resid {
  const uint8_t* local;      // (N,)
  const float* cterm;        // (n_qt, P, tile_q, wp): the prologue's centroid term
  const float* row_scale;    // (Q,)
  const int32_t* table;      // (n_qt, P)
  const int32_t* valid_end;  // (n_tiles, W)
  int steps, tile_n, l_buckets, tile_q, w, wp;
  ResidSide at;
  int side;  // at.total: bytes of side data a stage carries

  // step j reads tile table[qt, j]; every slot below L is a row
  __device__ RowBlock rows(int qt, int b0, int j, int r) const {
    RowBlock x;
    const long long t = table[(size_t)qt * steps + j];
    x.row0 = t * tile_n + (long long)r * l_buckets + b0;
    x.n_rows = min(C::SB, l_buckets - b0);
    return x;
  }

  __device__ void load_side(unsigned char* side, const RowBlock& x, int qt, int q_lo,
                            int nq_blk, int j) const {
    const int tid = threadIdx.x;
    const long long wb = x.row0 & ~3LL;
    const int nw = static_cast<int>((x.row0 - wb + x.n_rows + 3) >> 2);
    for (int i = tid; i < nw; i += TC_THREADS) {
      const long long g = wb + 4 * i;
      cp_async_zfill(side + at.loc + 4 * i, local + g, 4,
                     static_cast<int>(min(4LL, x.row0 + x.n_rows - g)));
    }
    const int32_t* ve = valid_end + (size_t)table[(size_t)qt * steps + j] * w;
    for (int i = tid; i < w; i += TC_THREADS) cp_async_zfill(side + at.ve + 4 * i, ve + i, 4, 4);
    for (int i = tid; i < nq_blk; i += TC_THREADS)
      cp_async_zfill(side + at.rs + 4 * i, row_scale + q_lo + i, 4, 4);
    const float* c = cterm + (((size_t)qt * steps + j) * tile_q + (q_lo - qt * tile_q)) * wp;
    for (int i = tid; i < nq_blk * wp / 4; i += TC_THREADS)
      cp_async_zfill(side + at.c + 16 * i, c + 4 * i, 16, 16);
  }

  __device__ float score(int dot, int slot, int qi, const RowBlock& x,
                         const unsigned char* side) const {
    if (slot >= x.n_rows) return -INFINITY;
    const int li = side[at.loc + static_cast<int>(x.row0 & 3) + slot];
    if (x.row0 + slot >= reinterpret_cast<const int32_t*>(side + at.ve)[li]) return -INFINITY;
    const float c = reinterpret_cast<const float*>(side + at.c)[qi * wp + li];
    const float rs = reinterpret_cast<const float*>(side + at.rs)[qi];
    return __fadd_rn(c, __fmul_rn(rs, __int2float_rn(dot)));
  }
};

__global__ void __launch_bounds__(TC_THREADS, 2)
resid_scan_kernel(const TcScan a, const Resid epi) {
  extern __shared__ __align__(16) unsigned char smem[];
  tc_scan<P_I8, C>(a, epi, smem);
}

// The prologue: one warp per (table entry, 16 queries, 16 centroid rows),
// CT_WARPS warps a block. Fragments come straight from global memory (two
// bf16 a 4-byte load; a query tile's rows and its tiles' centroid rows are
// read by many warps and stay in L1/L2).
constexpr int CT_WARPS = 4;

__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* row, int k, int d) {
  return row != nullptr && k < d ? *reinterpret_cast<const uint32_t*>(row + k) : 0u;
}

__global__ void __launch_bounds__(CT_WARPS * 32)
resid_centroid_kernel(const __nv_bfloat16* __restrict__ q,   // (Q, D)
                      const __nv_bfloat16* __restrict__ ct,  // (n_tiles, W, D)
                      const int32_t* __restrict__ table,     // (n_qt, P)
                      float* __restrict__ cterm,             // (n_qt, P, tile_q, wp)
                      long long n_tasks, int tile_q, int steps, int d, int w, int wp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const long long task = (long long)blockIdx.x * CT_WARPS + (threadIdx.x >> 5);
  if (task >= n_tasks) return;
  const int m_tiles = (tile_q + 15) / 16, n_groups = (w + 15) / 16;
  const int ng = static_cast<int>(task % n_groups);
  const int mt = static_cast<int>(task / n_groups % m_tiles);
  const long long e = task / n_groups / m_tiles;  // the entry (qt, p), row-major
  const int qt = static_cast<int>(e / steps);
  const long long t = table[e];
  const __nv_bfloat16* qr[2];
  for (int h = 0; h < 2; ++h) {
    const int qi = mt * 16 + g + 8 * h;
    qr[h] = qi < tile_q ? q + ((size_t)qt * tile_q + qi) * d : nullptr;
  }
  const __nv_bfloat16* cr[2];
  for (int nt = 0; nt < 2; ++nt) {
    const int wi = ng * 16 + nt * 8 + g;
    cr[nt] = wi < w ? ct + ((size_t)t * w + wi) * d : nullptr;
  }
  float hi[2][4] = {}, lo[2][4] = {};
#pragma unroll 4
  for (int k0 = 0; k0 < d; k0 += 16) {
    const int ka = k0 + 2 * t4, kb = ka + 8;
    const uint32_t a[4] = {ld_bf16x2(qr[0], ka, d), ld_bf16x2(qr[1], ka, d),
                           ld_bf16x2(qr[0], kb, d), ld_bf16x2(qr[1], kb, d)};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(p, a, ld_bf16x2(cr[nt], ka, d), ld_bf16x2(cr[nt], kb, d));
#pragma unroll
      for (int i = 0; i < 4; ++i) add_comp(hi[nt][i], lo[nt][i], p[i]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = mt * 16 + g + 8 * (i >> 1);
      const int wi = ng * 16 + nt * 8 + 2 * t4 + (i & 1);
      if (qi < tile_q && wi < w) cterm[((size_t)e * tile_q + qi) * wp + wi] = hi[nt][i] + lo[nt][i];
    }
}

inline int padded_w(int w) { return round_up(w, 4); }

}  // namespace

extern "C" {

// Dynamic shared memory the scan needs for row width d and window w.
int cvdb_tiles_resid_smem_bytes(int d, int w) {
  return tc_layout<C>(P_I8, d, resid_side(w, padded_w(w)).total).total;
}

// Bytes of the scratch the centroid term takes.
long long cvdb_tiles_resid_scratch_bytes(int n_qt, int tile_q, int p_entries, int w) {
  return 4LL * n_qt * p_entries * tile_q * padded_w(w);
}

const char* cvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the prologue and the scan on `stream`; returns cudaGetLastError()
// after the launches. `cterm` is scratch of cvdb_tiles_resid_scratch_bytes.
int cvdb_tiles_resid(const void* payload, const void* local, const void* centroid_tiles,
                     const void* q_bf16, const void* q8, const void* row_scale,
                     const void* tile_table, const void* valid_end, void* cterm, void* out_v,
                     void* out_i, int n_qt, int tile_q, int p_entries, int tile_n,
                     int l_buckets, int d, int w, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wp = padded_w(w);
  const long long n_tasks =
      (long long)n_qt * p_entries * ((tile_q + 15) / 16) * ((w + 15) / 16);
  const long long ct_blocks = (n_tasks + CT_WARPS - 1) / CT_WARPS;
  if (ct_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  resid_centroid_kernel<<<static_cast<unsigned>(ct_blocks), CT_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q_bf16),
      static_cast<const __nv_bfloat16*>(centroid_tiles),
      static_cast<const int32_t*>(tile_table), static_cast<float*>(cterm), n_tasks, tile_q,
      p_entries, d, w, wp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const ResidSide at = resid_side(w, wp);
  const int smem = tc_layout<C>(P_I8, d, at.total).total;
  err = cudaFuncSetAttribute(resid_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int copy = d % 16 == 0 ? 16 : d % 8 == 0 ? 8 : 4;  // d % 4 == 0 (ops/band.py)
  const TcScan a{static_cast<const unsigned char*>(payload),
                 static_cast<const unsigned char*>(q8), static_cast<float*>(out_v),
                 static_cast<int32_t*>(out_i), tile_q, p_entries, tile_n, l_buckets, d, copy};
  const Resid epi{static_cast<const uint8_t*>(local), static_cast<const float*>(cterm),
                  static_cast<const float*>(row_scale), static_cast<const int32_t*>(tile_table),
                  static_cast<const int32_t*>(valid_end), p_entries, tile_n, l_buckets, tile_q,
                  w, wp, at, at.total};
  const dim3 grid(n_qt * ((tile_q + C::QB - 1) / C::QB), (l_buckets + C::SB - 1) / C::SB);
  resid_scan_kernel<<<grid, TC_THREADS, smem, s>>>(a, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
