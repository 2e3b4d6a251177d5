// Residual-int8 tile-table scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel cloudvectordb_tpu/ops/pallas_band.py
// ::tiles_topk_resid_pallas (body _tiles_resid_kernel) with each of its
// options: int8 or bf16 queries in the residual term (int8_q), a row mask,
// the l2 key and top-2. Built by cloudvectordb_tpu_torch/ops/_cuda.py with
// nvcc into a shared library and called through ctypes; the plain PyTorch
// version of the same contract is ops/band.py::tiles_topk_resid_reference.
//
// What it computes. For query tile qt and table entry p (arena tile
// t = tile_table[qt, p]), every arena row g of tile t scores
//     C[q, local[g]] + row_scale[q] * (q' . r8[g])  [+ bias[g]]
// where C[q, w] = bf16(q) . bf16(centroid_tiles[t, w]) with f32
// accumulation; q' is the int8 query (int8_q; the dot exact in int32) or
// the bf16 query (the dot in f32: 'precise', row_scale then the residual
// scale); bias[g] is the l2 key's -s^2 |r|^2 / 2 - s c.r - |c|^2 / 2
// (resid_bias_kernel, below). Row g is live iff g < valid_end[t, local[g]]
// and, with a row mask, mask[g] != 0. Each query keeps L = l_buckets slots
// (top-2: two a slot): within a tile, slot b takes the best of rows
// t*tile_n + r*L + b over r (smallest r on ties); across table entries a
// strict '>' keeps the earlier entry (csrc/slot_merge.cuh). Slots start at
// (-inf, row 0). The final top-k over the slots is done by the caller.
//
// How it maps to the card: the score in split form.
//   - resid_centroid_kernel, a prologue: the centroid term C of every
//     (query tile, table entry) once, on the tensor cores (HMMA m16n8k16,
//     bf16 in, each 16-dim step summed from zero and added to a compensated
//     f32 sum), into a scratch of (n_qt, P, tile_q, W rounded up to 4) f32.
//     The TPU computed it inside the scan; here it would be recomputed by
//     every slot block of a query tile, or cost the scan the shared memory
//     that two blocks an SM need.
//   - resid_scan_kernel, the scan: the tensor-core body of csrc/tc_scan.cuh
//     (shared with K2, K3 and K7) in its narrow block (32 queries x 128
//     rows), int8 queries against int8 rows on IMMA m16n8k32 into int32,
//     or bf16 queries against the rows widened to bf16 on HMMA m16n8k16
//     (the body's hybrid pair, its ring two stages deep where the int8
//     pair's is three), with this file's epilogue (Resid): the stage
//     that holds a (step, r)'s last chunk also carries its rows' local ids
//     (and mask bytes, and l2 biases), the tile's valid_end, the block's
//     row scales and the entry's centroid term, so the ring's barriers
//     order them too; a score is then a few shared loads and the old
//     rounding, __fadd_rn(C, __fmul_rn(row_scale, dot)) (+ bias). The TPU
//     needed a one-hot matmul for the centroid gather, an 8-bit radix split
//     for the validity mask and (W + 1) skinny matmuls a tile for the l2
//     bias; here the first two are shared-memory loads and the bias a
//     per-row table written once per arena state.
//   - One instantiation of the scan per (pair, mask, l2, top-2), as
//     template arguments, so the serving variant compiles as before. Top-2
//     keeps 32 more values a thread, which spill at two blocks an SM, and
//     with R > 1 its tiles' runner-ups take 64 KB of shared memory
//     (tc_scan.cuh).
//   - resid_bias_kernel: the l2 bias of every arena row, a warp a row (the
//     row's int8 residual by 4-byte loads, its bf16 centroid row by 8-byte
//     loads, three sums by shuffles); 1 + 4 bytes a row besides the row.
//
// What bounds it on an H100. At the serving plan (B 4096, tile_q 32, 96
// table entries of 2048-row tiles at D 768) the scan does 2 x 4096 x 96 x
// 2048 x 768 = 1.2e12 int8 operations, 0.6 ms at the int8 peak (1.2 ms
// for 'precise' at the bf16 peak), and reads 6,060 distinct tiles once
// (9.3 GB, 2.8 ms at 3.35 TB/s): bytes bound it, and each tile is read by
// every query tile whose table holds it (12,288 (query tile, entry) pairs,
// 19.3 GB if none were shared). The design does about it what K3's does:
// the queries stay in shared memory, the rows stream through a cp.async
// ring whose loads overlap the products, and query blocks are the fastest
// grid index, so blocks that read the same rows run together and share them
// in L2. The prologue reads each (query tile, entry)'s W centroid rows
// (mostly L2 hits) and writes 2 KB a pair. The bias kernel reads the arena
// once (9.6 GB at 12.5M x 768, 2.9 ms) per arena state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "tc_scan.cuh"

namespace {

using C = Narrow;
// The hybrid ('precise') pair's block: its bf16 queries take twice the
// shared memory, so a ring of two stages keeps two blocks an SM at the
// index's W of 36 (three: one block an SM, 21.456 against 15.614 ms on an
// H100; PERF.md).
using CH = TcCfg<8, 1, 1, 2, 128>;

// The block a pair's scan runs in; the side data's layout is the same in each.
template <int PAIR>
using CfgOf = typename std::conditional<PAIR == P_HYB, CH, C>::type;
static_assert(CH::SB == C::SB && CH::QB == C::QB, "one side-data layout and grid");

// Where a stage's side data lies (bytes from the end of its rows): the
// local ids of the SB rows, from the 4-byte word that holds row0 on; with
// a row mask its bytes, laid alike; with l2 the rows' biases (SB floats);
// the tile's valid_end (W ints); the block's row scales (QB floats); the
// entry's centroid term for the block's queries (QB x Wp floats, Wp = W
// rounded up to 4, so each query's row is whole 16-byte copies).
struct ResidSide {
  int loc, mask, bias, ve, rs, c, total;
};

__host__ __device__ inline ResidSide resid_side(int w, int wp, bool masked, bool l2) {
  ResidSide s;
  s.loc = 0;
  s.mask = round_up(C::SB + 4, 16);
  s.bias = s.mask + (masked ? round_up(C::SB + 4, 16) : 0);
  s.ve = s.bias + (l2 ? 4 * C::SB : 0);
  s.rs = s.ve + round_up(4 * w, 16);
  s.c = s.rs + 4 * C::QB;
  s.total = s.c + 4 * C::QB * wp;
  return s;
}

// K1's epilogue for the shared body (tc_scan.cuh).
template <bool MASKED, bool L2>
struct Resid {
  const uint8_t* local;      // (N,)
  const uint8_t* mask;       // (N,) allow bits (MASKED)
  const float* bias;         // (N,) l2 bias (L2)
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

  // the bytes of the n_rows rows from row0 of a byte-a-row array, from the
  // 4-byte word that holds row0 on
  __device__ void load_bytes(unsigned char* dst, const uint8_t* src, const RowBlock& x) const {
    const long long wb = x.row0 & ~3LL;
    const int nw = static_cast<int>((x.row0 - wb + x.n_rows + 3) >> 2);
    for (int i = threadIdx.x; i < nw; i += TC_THREADS) {
      const long long g = wb + 4 * i;
      cp_async_zfill(dst + 4 * i, src + g, 4, static_cast<int>(min(4LL, x.row0 + x.n_rows - g)));
    }
  }

  __device__ void load_side(unsigned char* side, const RowBlock& x, int qt, int q_lo,
                            int nq_blk, int j) const {
    const int tid = threadIdx.x;
    load_bytes(side + at.loc, local, x);
    if constexpr (MASKED) load_bytes(side + at.mask, mask, x);
    if constexpr (L2)
      for (int i = tid; i < x.n_rows; i += TC_THREADS)
        cp_async_zfill(side + at.bias + 4 * i, bias + x.row0 + i, 4, 4);
    const int32_t* ve = valid_end + (size_t)table[(size_t)qt * steps + j] * w;
    for (int i = tid; i < w; i += TC_THREADS) cp_async_zfill(side + at.ve + 4 * i, ve + i, 4, 4);
    for (int i = tid; i < nq_blk; i += TC_THREADS)
      cp_async_zfill(side + at.rs + 4 * i, row_scale + q_lo + i, 4, 4);
    const float* c = cterm + (((size_t)qt * steps + j) * tile_q + (q_lo - qt * tile_q)) * wp;
    for (int i = tid; i < nq_blk * wp / 4; i += TC_THREADS)
      cp_async_zfill(side + at.c + 16 * i, c + 4 * i, 16, 16);
  }

  // dot: the int8 pair's exact int32 sum, or the hybrid pair's f32 sum
  template <typename T>
  __device__ float score(T dot, int slot, int qi, const RowBlock& x,
                         const unsigned char* side) const {
    if (slot >= x.n_rows) return -INFINITY;
    const int li = side[at.loc + static_cast<int>(x.row0 & 3) + slot];
    if (x.row0 + slot >= reinterpret_cast<const int32_t*>(side + at.ve)[li]) return -INFINITY;
    if constexpr (MASKED)
      if (side[at.mask + static_cast<int>(x.row0 & 3) + slot] == 0) return -INFINITY;
    const float c = reinterpret_cast<const float*>(side + at.c)[qi * wp + li];
    const float rs = reinterpret_cast<const float*>(side + at.rs)[qi];
    float d;
    if constexpr (std::is_same<T, int>::value)
      d = __int2float_rn(dot);
    else
      d = dot;
    const float s = __fadd_rn(c, __fmul_rn(rs, d));
    if constexpr (L2) return __fadd_rn(s, reinterpret_cast<const float*>(side + at.bias)[slot]);
    return s;
  }
};

// Two blocks an SM for every variant: top-2's 32 more values a thread then
// spill (up to 208 bytes) but ran in 9.842 ms against 15.042 at one block an
// SM and the 171 registers it wants (on an H100; PERF.md).
template <int PAIR, bool MASKED, bool L2, bool TOP2>
__global__ void __launch_bounds__(TC_THREADS, 2)
resid_scan_kernel(const TcScan a, const Resid<MASKED, L2> epi) {
  extern __shared__ __align__(16) unsigned char smem[];
  tc_scan<PAIR, CfgOf<PAIR>, TOP2>(a, epi, smem);
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

// The l2 bias of every arena row: -s^2 |r|^2 / 2 - s (c . r) - |c|^2 / 2 with
// r the row's int8 residual and c its bf16 list centroid, in f32 (the plain
// version's expression, ops/band.py::_row_bias_tiles). One warp a row; d a
// multiple of 4: each lane takes 4 dims at a time, 4 bytes of the row and 8
// of the centroid row.
constexpr int BIAS_WARPS = 8;

__global__ void __launch_bounds__(BIAS_WARPS * 32)
resid_bias_kernel(const int8_t* __restrict__ rows,            // (N, D)
                  const uint8_t* __restrict__ local,          // (N,)
                  const __nv_bfloat16* __restrict__ ct,       // (n_tiles, W, D)
                  float* __restrict__ bias,                   // (N,)
                  long long n, int tile_n, int d, int w, float s) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * BIAS_WARPS;
  for (long long g = (long long)blockIdx.x * BIAS_WARPS + (threadIdx.x >> 5); g < n;
       g += warps) {
    const int8_t* r = rows + g * d;
    const __nv_bfloat16* c = ct + ((g / tile_n) * w + local[g]) * (long long)d;
    int rr = 0;
    float cr = 0.f, cc = 0.f;
    for (int k = 4 * lane; k < d; k += 128) {
      const char4 rv = *reinterpret_cast<const char4*>(r + k);
      const uint2 cw = *reinterpret_cast<const uint2*>(c + k);
      const float2 c01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cw.x));
      const float2 c23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cw.y));
      rr += rv.x * rv.x + rv.y * rv.y + rv.z * rv.z + rv.w * rv.w;
      cr += c01.x * rv.x + c01.y * rv.y + c23.x * rv.z + c23.y * rv.w;
      cc += c01.x * c01.x + c01.y * c01.y + c23.x * c23.x + c23.y * c23.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      rr += __shfl_xor_sync(0xffffffffu, rr, o);
      cr += __shfl_xor_sync(0xffffffffu, cr, o);
      cc += __shfl_xor_sync(0xffffffffu, cc, o);
    }
    if (lane == 0) {
      const float half_s2 = __fmul_rn(__fmul_rn(-0.5f, s), s);
      bias[g] = __fsub_rn(__fsub_rn(__fmul_rn(half_s2, __int2float_rn(rr)), __fmul_rn(s, cr)),
                          __fmul_rn(0.5f, cc));
    }
  }
}

template <int PAIR, bool MASKED, bool L2, bool TOP2>
cudaError_t launch_scan(const TcScan& a, const Resid<MASKED, L2>& epi, int smem, dim3 grid,
                        cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      resid_scan_kernel<PAIR, MASKED, L2, TOP2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  resid_scan_kernel<PAIR, MASKED, L2, TOP2><<<grid, TC_THREADS, smem, s>>>(a, epi);
  return cudaGetLastError();
}

// The scan's instantiation for the call's (top-2, pair): the template
// arguments from the flags, one branch each.
template <bool MASKED, bool L2>
cudaError_t launch_variant(bool hybrid, bool top2, const TcScan& a, const Resid<MASKED, L2>& epi,
                           int smem, dim3 grid, cudaStream_t s) {
  if (hybrid)
    return top2 ? launch_scan<P_HYB, MASKED, L2, true>(a, epi, smem, grid, s)
                : launch_scan<P_HYB, MASKED, L2, false>(a, epi, smem, grid, s);
  return top2 ? launch_scan<P_I8, MASKED, L2, true>(a, epi, smem, grid, s)
              : launch_scan<P_I8, MASKED, L2, false>(a, epi, smem, grid, s);
}

template <bool MASKED, bool L2>
Resid<MASKED, L2> resid_epi(const void* local, const void* mask, const void* bias,
                            const void* cterm, const void* row_scale, const void* tile_table,
                            const void* valid_end, int p_entries, int tile_n, int l_buckets,
                            int tile_q, int w, int wp) {
  const ResidSide at = resid_side(w, wp, MASKED, L2);
  return Resid<MASKED, L2>{static_cast<const uint8_t*>(local), static_cast<const uint8_t*>(mask),
                           static_cast<const float*>(bias), static_cast<const float*>(cterm),
                           static_cast<const float*>(row_scale),
                           static_cast<const int32_t*>(tile_table),
                           static_cast<const int32_t*>(valid_end), p_entries, tile_n, l_buckets,
                           tile_q, w, wp, at, at.total};
}

}  // namespace

extern "C" {

// Dynamic shared memory the scan needs: row width d, window w, bf16
// queries (hybrid), a row mask, the l2 bias, top-2 over r_per_tile rows a
// slot in a tile.
int cvdb_tiles_resid_smem_bytes(int d, int w, int hybrid, int masked, int l2, int top2,
                                int r_per_tile) {
  const int side = resid_side(w, padded_w(w), masked, l2).total;
  return hybrid ? tc_layout<CH>(P_HYB, d, side, tc_top2_bytes<CH>(top2, r_per_tile)).total
                : tc_layout<C>(P_I8, d, side, tc_top2_bytes<C>(top2, r_per_tile)).total;
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
// `q` is the residual term's queries: int8 (Q, D), or bf16 (Q, D) with
// `hybrid`; `mask` (N,) allow bytes or null; `bias` (N,) f32 or null;
// `out_v2`/`out_i2` slot 2's (Q, L) outputs or null (no top-2).
int cvdb_tiles_resid(const void* payload, const void* local, const void* centroid_tiles,
                     const void* q_bf16, const void* q, const void* row_scale,
                     const void* tile_table, const void* valid_end, const void* mask,
                     const void* bias, void* cterm, void* out_v, void* out_i, void* out_v2,
                     void* out_i2, int n_qt, int tile_q, int p_entries, int tile_n,
                     int l_buckets, int d, int w, int hybrid, int device, void* stream) {
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

  const bool masked = mask != nullptr, l2 = bias != nullptr, top2 = out_v2 != nullptr;
  const int smem =
      cvdb_tiles_resid_smem_bytes(d, w, hybrid, masked, l2, top2, tile_n / l_buckets);
  const int copy = d % 16 == 0 ? 16 : d % 8 == 0 ? 8 : 4;  // d % 4 == 0 (ops/band.py)
  TcScan a{static_cast<const unsigned char*>(payload), static_cast<const unsigned char*>(q),
           static_cast<float*>(out_v), static_cast<int32_t*>(out_i), tile_q, p_entries, tile_n,
           l_buckets, d, copy};
  a.out_v2 = static_cast<float*>(out_v2);
  a.out_i2 = static_cast<int32_t*>(out_i2);
  const dim3 grid(n_qt * ((tile_q + C::QB - 1) / C::QB), (l_buckets + C::SB - 1) / C::SB);
#define CVDB_RESID(M, L)                                                                   \
  launch_variant<M, L>(hybrid != 0, top2, a,                                             \
                       resid_epi<M, L>(local, mask, bias, cterm, row_scale, tile_table,  \
                                       valid_end, p_entries, tile_n, l_buckets, tile_q, w, \
                                       wp),                                              \
                       smem, grid, s)
  err = masked ? (l2 ? CVDB_RESID(true, true) : CVDB_RESID(true, false))
               : (l2 ? CVDB_RESID(false, true) : CVDB_RESID(false, false));
#undef CVDB_RESID
  return static_cast<int>(err);
}

// The l2 bias of each of the n arena rows (resid_bias_kernel) on `stream`;
// returns cudaGetLastError() after the launch.
int cvdb_resid_row_bias(const void* payload, const void* local, const void* centroid_tiles,
                        void* bias, long long n, int tile_n, int d, int w, float resid_scale,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const long long need = (n + BIAS_WARPS - 1) / BIAS_WARPS;
  const long long blocks = need < 132LL * 64 ? need : 132LL * 64;  // a grid-stride loop
  resid_bias_kernel<<<static_cast<unsigned>(blocks), BIAS_WARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(payload), static_cast<const uint8_t*>(local),
      static_cast<const __nv_bfloat16*>(centroid_tiles), static_cast<float*>(bias), n, tile_n,
      d, w, resid_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
